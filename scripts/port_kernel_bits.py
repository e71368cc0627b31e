#!/usr/bin/env python3
"""Hold the PyTorch/CUDA port's K1, K4, K6 and K7 to the bits of another build.

    python3 scripts/port_kernel_bits.py --other DIR [--kernels K1 K4 K6 K7]

DIR holds another revision's sources of the kernels compared and the headers
they include (`epic_forward.cu`, `epic_forward.cuh`, `epic_forward_kernel.cuh`
for K1; `epic_wide_forward.cu`, `epic_wide.cuh` for K4; `survival_head.cu`,
`gsdm_blocks.cuh` for K6; `gsdm_stack.cu` for K7), for example unpacked with
`git show REV:multimodal_particles_tpu_torch/ops/csrc/FILE`. The script builds
those sources of that directory and of the working tree's `ops/csrc/` with
nvcc, each into a temporary directory, and compares on one GPU, with
`torch.equal`:

  K1  the fused EPiC forward at config-berlin (B=1024, N=128) and as the
      absorbing family calls it (56-wide head, hidden output, B=512, N=109);
  K4  the wide fused EPiC forward at the scaled MBM backbone (every width
      128, 6 blocks, B=512, N=128);
  K6  the fused survival head at (B, N) = (512, 109), (7, 109), (64, 128);
  K7  the fused gsdm stack at the reference input widths 24 and 27
      (B=512, N=128; B=7, N=40).

K1's source builds in minutes; `--kernels` leaves it out when its sources did
not change. One JSON line a comparison; exit code 1 if any output differs. For
a change to a header that several kernels share and that must not move their
results.
"""

import argparse
import ctypes
import json
import shutil
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from multimodal_particles_tpu_torch.config_classes import (  # noqa: E402
    AbsorbingConfig,
    MultimodalBridgeMatchingConfig,
    TransdimensionalEpicConfig,
)
from multimodal_particles_tpu_torch.models.generative.absorbing.absorbing_flows import (  # noqa: E402
    AbsorbingFlow,
)
from multimodal_particles_tpu_torch.models.generative.init import init_parameters  # noqa: E402
from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (  # noqa: E402
    MultiModalBridgeMatching,
)
from multimodal_particles_tpu_torch.models.generative.transdimensional.transdimensional_model import (  # noqa: E402
    TransdimensionalJumpDiffusion,
)
from multimodal_particles_tpu_torch.ops import (  # noqa: E402
    _build,
    epic_cuda,
    epic_wide_cuda,
    gsdm_stack_cuda,
    survival_cuda,
)

# kernel → (its source, its C entry point)
KERNELS = {
    "K1": ("epic_forward.cu", "mmp_epic_forward"),
    "K4": ("epic_wide_forward.cu", "mmp_epic_wide_forward"),
    "K6": ("survival_head.cu", "mmp_survival_head"),
    "K7": ("gsdm_stack.cu", "mmp_gsdm_stack"),
}
HEADERS = ("epic_forward.cuh", "epic_forward_kernel.cuh", "epic_wide.cuh", "gsdm_blocks.cuh")
# the error strings' entry point lives in K1's source; without it, a stub
ERROR_STRING_STUB = """#include <cuda_runtime.h>
extern "C" const char* mmp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
"""


def build(csrc: Path, workdir: Path, kernels) -> ctypes.CDLL:
    """Build the chosen kernels' sources of `csrc` into `workdir` and bind
    their entry points. `lib.wide_hidden_arg`: whether that revision's K4
    entry point takes the hidden-output pointer."""
    src = workdir / "csrc"
    src.mkdir(parents=True)
    for name in [KERNELS[k][0] for k in kernels] + list(HEADERS):
        if (csrc / name).exists():
            shutil.copy(csrc / name, src / name)
    if "K1" not in kernels:
        (src / "error_string.cu").write_text(ERROR_STRING_STUB)
    _build.CSRC_DIR, _build.BUILD_DIR = src, workdir / "build"
    lib = ctypes.CDLL(str(_build.build_library().path))
    wide_hidden = "K4" in kernels and "void* hidden" in (src / KERNELS["K4"][0]).read_text()
    for k in kernels:
        name = KERNELS[k][1]
        argtypes = list(_build._SIGNATURES[name])
        if k == "K4" and not wide_hidden:  # before the hidden output: no such pointer
            del argtypes[6]
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.mmp_error_string.argtypes, lib.mmp_error_string.restype = [ctypes.c_int], ctypes.c_char_p
    lib.wide_hidden_arg = wide_hidden
    return lib


def inputs(B, N, device, gen):
    """t, x, k and a random non-prefix mask; the last jet is empty."""
    mask = (torch.rand((B, N, 1), generator=gen, device=device) < 0.6).float()
    mask[-1] = 0
    x = torch.randn((B, N, 3), generator=gen, device=device) * mask
    k = torch.randint(0, 8, (B, N, 1), generator=gen, device=device) * mask.long()
    return torch.rand((B, 1, 1), generator=gen, device=device), x, k, mask


def wide_forward(lib, packed, t, x, k, mask):
    """K4's MBM call through `lib`'s entry point, whichever its signature."""
    B, N = x.shape[:2]
    out = torch.empty((B, N, 11), device=x.device)
    k32 = k.to(torch.int32).contiguous()
    args = [packed.flat.data_ptr(), t.data_ptr(), x.data_ptr(), k32.data_ptr(), mask.data_ptr(),
            out.data_ptr()]
    if lib.wide_hidden_arg:
        args.append(None)
    rc = lib.mmp_epic_wide_forward(*args, B, N, packed.dims.c_array(),
                                   torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "mmp_epic_wide_forward")
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", required=True, type=Path, help="the other revision's csrc files")
    parser.add_argument("--kernels", nargs="+", choices=sorted(KERNELS), default=sorted(KERNELS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("port_kernel_bits: needs a GPU")
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)
    here = ROOT / "multimodal_particles_tpu_torch" / "ops" / "csrc"
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"other": build(args.other, Path(tmp) / "other", args.kernels),
                "here": build(here, Path(tmp) / "here", args.kernels)}

        def both(fn):
            """fn's outputs under each library, as tuples of tensors."""
            outs = []
            for lib in libs.values():
                _build.load_library = lambda lib=lib: lib
                out = fn(lib)
                outs.append(out if isinstance(out, tuple) else (out,))
            torch.cuda.synchronize()
            return outs

        same = []

        def report(name, outs, **where):
            equal = all(torch.equal(a, b) for a, b in zip(*outs))
            same.append(equal)
            print(json.dumps({"kernel": name, **where, "same_bits": equal,
                              "max_abs": max(a.abs().max().item() for a in outs[0])}), flush=True)

        if "K1" in args.kernels:
            mbm = init_parameters(MultiModalBridgeMatching(MultimodalBridgeMatchingConfig()), 0)
            packed = epic_cuda.pack_mbm_encoder_params(mbm.to(device).encoder, mbm.config)
            t, x, k, mask = inputs(1024, 128, device, gen)
            report("K1", both(lambda lib: epic_cuda.epic_forward(packed, t, x, k, mask)),
                   config="config-berlin", B=1024, N=128)

        flow = init_parameters(AbsorbingFlow(AbsorbingConfig()), 0).to(device).eval()
        trunk, head = flow.pack_for_kernel()
        if "K1" in args.kernels:
            t, x, k, mask = inputs(512, 109, device, gen)
            report("K1", both(lambda lib: epic_cuda.epic_forward(trunk, t, x, k, mask,
                                                                 output_hidden_local=True)),
                   config="absorbing", B=512, N=109)

        if "K4" in args.kernels:
            config = MultimodalBridgeMatchingConfig()
            e = config.encoder
            e.num_blocks = 6
            e.dim_hidden_local = e.dim_hidden_glob = e.dim_emb_time = 128
            e.dim_emb_features_continuous = e.dim_emb_features_discrete = 128
            scaled = init_parameters(MultiModalBridgeMatching(config), 0).to(device)
            packed = epic_wide_cuda.pack_wide_encoder_params(scaled.encoder, config)
            t, x, k, mask = inputs(512, 128, device, gen)
            report("K4", both(lambda lib: wide_forward(lib, packed, t, x, k, mask)),
                   config="scaled MBM", B=512, N=128)

        if "K6" in args.kernels:
            gen_cfg = flow.config.generator
            for B, N in ((512, 109), (7, 109), (64, 128)):
                t, _, _, mask = inputs(B, N, device, gen)
                last = torch.randn((B, N, head.dim_hidden), generator=gen, device=device)
                tp = survival_cuda.project_time_embeddings(flow.generator, t, gen_cfg.n_attn_blocks,
                                                           gen_cfg.transformer_dim)
                report("K6", both(lambda lib: survival_cuda.survival_head(
                    head, tp, last, mask.long(), n_heads=gen_cfg.n_heads)), B=B, N=N)

        if "K7" in args.kernels:
            model = init_parameters(TransdimensionalJumpDiffusion(TransdimensionalEpicConfig()), 0)
            model = model.to(device).eval()
            net = model.network
            _, rate_stack, vec_stack = model.pack_for_kernel()
            for packed, res, B, N in ((rate_stack, net.blocks()[0], 512, 128),
                                      (vec_stack, net.blocks("vec_")[0], 512, 128),
                                      (vec_stack, net.blocks("vec_")[0], 7, 40)):
                x_in = torch.randn((B, N, packed.dim_in), generator=gen, device=device)
                with torch.no_grad():
                    tp = gsdm_stack_cuda.stack_time_embeddings(
                        net.time_embedding(torch.rand((B,), generator=gen, device=device)), res)
                report("K7", both(lambda lib: gsdm_stack_cuda.gsdm_stack(
                    packed, tp, x_in, n_heads=model.config.encoder.n_heads)),
                    B=B, N=N, Din=packed.dim_in)
    return 0 if all(same) else 1


if __name__ == "__main__":
    sys.exit(main())
