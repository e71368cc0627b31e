#!/usr/bin/env python3
"""Hold the PyTorch/CUDA port's K1 and K6 to the bits of another build.

    python3 scripts/port_kernel_bits.py --other DIR

DIR holds another revision's `epic_forward.cu`, `epic_forward.cuh`,
`survival_head.cu` and `epic_wide.cuh` (and `epic_forward_kernel.cuh`,
`gsdm_blocks.cuh` where that revision has them), for example unpacked with
`git show REV:multimodal_particles_tpu_torch/ops/csrc/FILE`. The script builds
that directory and the working tree's `ops/csrc/` with nvcc, each into a
temporary directory, and compares on one GPU, with `torch.equal`:

  K1  the fused EPiC forward at config-berlin (B=1024, N=128) and as the
      absorbing family calls it (56-wide head, hidden output, B=512, N=109);
  K6  the fused survival head at (B, N) = (512, 109), (7, 109), (64, 128).

One JSON line a comparison; exit code 1 if any output differs. For a change to
a header that several kernels share and that must not move their results.
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
)
from multimodal_particles_tpu_torch.models.generative.absorbing.absorbing_flows import (  # noqa: E402
    AbsorbingFlow,
)
from multimodal_particles_tpu_torch.models.generative.init import init_parameters  # noqa: E402
from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (  # noqa: E402
    MultiModalBridgeMatching,
)
from multimodal_particles_tpu_torch.ops import _build, epic_cuda, survival_cuda  # noqa: E402

ENTRY_POINTS = ("mmp_epic_forward", "mmp_survival_head")
SOURCES = ("epic_forward.cu", "survival_head.cu")
HEADERS = ("epic_forward.cuh", "epic_forward_kernel.cuh", "epic_wide.cuh", "gsdm_blocks.cuh")


def build(csrc: Path, workdir: Path) -> ctypes.CDLL:
    """Build K1's and K6's sources of `csrc` into `workdir` and bind them."""
    src = workdir / "csrc"
    src.mkdir(parents=True)
    for name in SOURCES + HEADERS:
        if (csrc / name).exists():
            shutil.copy(csrc / name, src / name)
    _build.CSRC_DIR, _build.BUILD_DIR = src, workdir / "build"
    lib = ctypes.CDLL(str(_build.build_library().path))
    for name in ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _build._SIGNATURES[name], ctypes.c_int
    lib.mmp_error_string.argtypes, lib.mmp_error_string.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


def inputs(B, N, device, gen):
    """t, x, k and a random non-prefix mask; the last jet is empty."""
    mask = (torch.rand((B, N, 1), generator=gen, device=device) < 0.6).float()
    mask[-1] = 0
    x = torch.randn((B, N, 3), generator=gen, device=device) * mask
    k = torch.randint(0, 8, (B, N, 1), generator=gen, device=device) * mask.long()
    return torch.rand((B, 1, 1), generator=gen, device=device), x, k, mask


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", required=True, type=Path, help="the other revision's csrc files")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("port_kernel_bits: needs a GPU")
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)
    here = ROOT / "multimodal_particles_tpu_torch" / "ops" / "csrc"
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"other": build(args.other, Path(tmp) / "other"),
                "here": build(here, Path(tmp) / "here")}

        def both(fn):
            """fn's outputs under each library, as tuples of tensors."""
            outs = []
            for lib in libs.values():
                _build.load_library = lambda lib=lib: lib
                out = fn()
                outs.append(out if isinstance(out, tuple) else (out,))
            torch.cuda.synchronize()
            return outs

        same = []

        def report(name, outs, **where):
            equal = all(torch.equal(a, b) for a, b in zip(*outs))
            same.append(equal)
            print(json.dumps({"kernel": name, **where, "same_bits": equal,
                              "max_abs": max(a.abs().max().item() for a in outs[0])}), flush=True)

        mbm = init_parameters(MultiModalBridgeMatching(MultimodalBridgeMatchingConfig()), 0)
        packed = epic_cuda.pack_mbm_encoder_params(mbm.to(device).encoder, mbm.config)
        t, x, k, mask = inputs(1024, 128, device, gen)
        report("K1", both(lambda: epic_cuda.epic_forward(packed, t, x, k, mask)),
               config="config-berlin", B=1024, N=128)

        flow = init_parameters(AbsorbingFlow(AbsorbingConfig()), 0).to(device).eval()
        trunk, head = flow.pack_for_kernel()
        t, x, k, mask = inputs(512, 109, device, gen)
        report("K1", both(lambda: epic_cuda.epic_forward(trunk, t, x, k, mask,
                                                         output_hidden_local=True)),
               config="absorbing", B=512, N=109)

        gen_cfg = flow.config.generator
        for B, N in ((512, 109), (7, 109), (64, 128)):
            t, _, _, mask = inputs(B, N, device, gen)
            last = torch.randn((B, N, head.dim_hidden), generator=gen, device=device)
            tp = survival_cuda.project_time_embeddings(flow.generator, t, gen_cfg.n_attn_blocks,
                                                       gen_cfg.transformer_dim)
            report("K6", both(lambda: survival_cuda.survival_head(
                head, tp, last, mask.long(), n_heads=gen_cfg.n_heads)), B=B, N=N)
    return 0 if all(same) else 1


if __name__ == "__main__":
    sys.exit(main())
