#!/usr/bin/env python3
"""Hold the PyTorch/CUDA port's kernels to the output of another build.

    python3 scripts/port_kernel_bits.py --other DIR [--kernels K1 K2 K3 K4 K5 K6 K7 K8] [--time]

DIR holds another revision's sources of the kernels compared and the headers
they include (`epic_forward.cu`, `epic_forward_fold.cu`, `epic_forward.cuh`,
`epic_forward_kernel.cuh` and, from its tensor-core kernel on,
`narrow_tc.cuh` and `tf32x3.cuh` for K1; `sampler_step.cu` and, from its
tensor-core kernel on, `tf32x3.cuh` (and later `narrow_tc.cuh`) for K2;
`epic_backward.cu` and, from its tensor-core kernel on, K1's headers for K3; `epic_wide_forward.cu`, `epic_wide.cuh`
and, from the tensor-core K4 on, `tf32x3.cuh` for K4; `epic_wide_backward.cu`
and the same headers for K5; `survival_head.cu`, `gsdm_blocks.cuh` and, from
the tensor-core K6 on, `tf32x3.cuh` and, from the K6 of any width on,
`survival_head.cuh` and `survival_head_c{256,384,512}.cu` (and, from
K6 past 128 slots on, `survival_head_r2.cu`, `_c{256,384,512}_r2.cu`) for K6 (and,
from K4 and K5 at every width on, `epic_wide_any.cuh`,
`epic_wide_forward_any.cuh`, `epic_wide_backward.cuh`,
`epic_wide_backward_any.cuh` and `epic_wide_{forward,backward}_h*.cu`, and,
from K4 and K5 past 128 slots on, `epic_wide_{forward,backward}_h*_r2.cu`);
`gsdm_stack.cu` and the same headers (`gsdm_stack.cuh`, `gsdm_stack_c*.cu`)
for K7; `attention_core.cu`, `tf32x3.cuh` for K8), for example
unpacked with `git archive REV multimodal_particles_tpu_torch/ops/csrc`. The
script builds those sources of that directory and of the working tree's
`ops/csrc/` with nvcc, each into a temporary directory, and compares on one
GPU, with `torch.equal`:

  K2  the sampler step at config-berlin (B=1024, N=128) at t = 0.0101, 0.5
      and 1 − 1e-4 (between two builds of the same design);
  K8  the attention core at B=512, N=128 and 109, 2 heads, with a key mask
      and without.

K1's, K2's, K3's, K4's, K5's, K6's and K7's bits are not held where the two
builds run their products in another order (the tensor cores under the 3×TF32
split against the FFMA products before them). For each, the line gives the
two builds' largest difference as a share of the kernel's gate against its
plain version, the other build's output taken as the reference; a share
above 1 fails. K1: the fused EPiC forward at config-berlin (B=1024, N=128),
as the absorbing family calls it (56-wide head, hidden output, B=512,
N=109) and as the transdimensional one does (folded input, no head, hidden
output, B=512, N=128), elementwise |err| ≤ 1e-4 + 1e-4·|other| on the
outputs and the hidden state. K2: the sampler step at config-berlin (B=1024,
N=128) at t = 0.0101, 0.5 and 1 − 1e-4, x' elementwise |err| ≤ 1e-4 +
1e-4·|other|, and at most 1% of the real slots' tokens differing. K4: each
of its four instances (tokens or the folded input, times the 8-wide or the
56-wide head; the hidden output of all but MBM's) at the scaled backbone,
B=512, N=109 and 128, and MBM's at scaled-256 (every width 256, a cluster
of two blocks), per particle |err| ≤ 1e-4 + 1e-4·max|other| over the
particle's row. K3: the narrow backward at config-berlin (B=1024, N=128),
K5: the wide backward at the scaled MBM backbone (every width 128, 6 blocks,
B=512, N=128) and at scaled-256, both for a random cotangent with none on jets near a kink,
per leaf |err| ≤ 1e-4·max|other leaf| + 1e-3·|other|. K6: the
fused survival head at (B, N) = (512, 109), (7, 109), (64, 128); K7: the
fused gsdm stack at the reference input widths 24 and 27 (B=512, N=128;
B=7, N=40) and the `--scaled` ones, 136 and 139 (B=64, N=128); both
elementwise, |err| ≤ 2e-4 + 2e-4·|other|. Every line also says whether the
bits are the same.

The FFMA K1's and K3's sources (before their tensor-core kernels) build in
minutes; `--kernels` leaves them out when their sources did not change.
K1, K2 and K3 are also compared at hidden 32 (3 blocks, N=200) and 64 (4
blocks, N=256), B=512 (K1's and K2's x' per particle, K3's per leaf). With
`--time`, the kernels chosen are also timed under both builds in turns at
their main paths' shapes (`time_head_kernels`). One JSON line a comparison; exit code 1
if any output held to the bits differs or a share exceeds 1. For a change
to a header that several kernels share.
"""

import argparse
import ctypes
import dataclasses
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
    attention_cuda,
    epic_cuda,
    epic_vjp_cuda,
    epic_wide_cuda,
    epic_wide_vjp_cuda,
    gsdm_stack_cuda,
    sampler_cuda,
    survival_cuda,
)

# kernel → (its source, its C entry point)
KERNELS = {
    "K1": ("epic_forward.cu", "mmp_epic_forward"),
    "K2": ("sampler_step.cu", "mmp_sampler_step"),
    "K3": ("epic_backward.cu", "mmp_epic_backward"),
    "K4": ("epic_wide_forward.cu", "mmp_epic_wide_forward"),
    "K5": ("epic_wide_backward.cu", "mmp_epic_wide_backward"),
    "K6": ("survival_head.cu", "mmp_survival_head"),
    "K7": ("gsdm_stack.cu", "mmp_gsdm_stack"),
    "K8": ("attention_core.cu", "mmp_attention_core"),
}
HEADERS = ("epic_backward.cuh", "epic_forward.cuh", "epic_forward_kernel.cuh", "epic_wide.cuh",
           "epic_wide_any.cuh",
           "epic_wide_forward_any.cuh", "epic_wide_backward.cuh", "epic_wide_backward_any.cuh",
           "gsdm_blocks.cuh", "gsdm_stack.cuh", "narrow_tc.cuh", "survival_head.cuh",
           "tf32x3.cuh")
# K6's and K7's sources of their widths 256, 384 and 512 (their cluster
# instances) and of their jets of 129 … 256 slots (two row blocks a jet, at
# every width), and K4's and K5's of their local hidden widths 128 … 512 (the
# general kernels), where the revision has them
WIDE_SOURCES = {k: tuple(f"{stem}_c{w}.cu" for w in (256, 384, 512))
                + (f"{stem}_r2.cu",) + tuple(f"{stem}_c{w}_r2.cu" for w in (256, 384, 512))
                for k, stem in (("K6", "survival_head"), ("K7", "gsdm_stack"))}
WIDE_SOURCES.update({k: tuple(f"{stem}_h{w}{rows}.cu" for rows in ("", "_r2")
                           for w in (128, 256, 384, 512))
                     for k, stem in (("K4", "epic_wide_forward"), ("K5", "epic_wide_backward"))})
# K3's instances at hidden 32, 48 and 64 (since the instance at 48), where the revision has them
WIDE_SOURCES["K3"] = tuple(f"epic_backward_h{w}.cu" for w in (32, 48, 64))
K1_FOLD = ("epic_forward_fold.cu", "mmp_epic_forward_fold")  # K1's folded-input instantiation
K1_TOL = 1e-4  # K1's gate, elementwise (atol = rtol), at the three shapes held
K4_TOL = 1e-4  # K4's gate against its plain version, per particle (atol = rtol)
K6_TOL = K7_TOL = 2e-4  # K6's and K7's, elementwise (tests/test_ops/test_survival_pallas.py:86-88)
K2_TOL = 1e-4  # K2's, elementwise on x' (atol = rtol), beside ≤ 1% of tokens differing
K2_MAX_TOKEN_MISMATCH = 0.01
# the error strings' entry point lives in K1's source; without it, a stub
ERROR_STRING_STUB = """#include <cuda_runtime.h>
extern "C" const char* mmp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
"""


def build(csrc: Path, workdir: Path, kernels) -> ctypes.CDLL:
    """Build the chosen kernels' sources of `csrc` into `workdir` and bind
    their entry points."""
    src = workdir / "csrc"
    src.mkdir(parents=True)
    sources = [KERNELS[k][0] for k in kernels] + ([K1_FOLD[0]] if "K1" in kernels else [])
    sources += [name for k in kernels for name in WIDE_SOURCES.get(k, ())]
    for name in sources + list(HEADERS):
        if (csrc / name).exists():
            shutil.copy(csrc / name, src / name)
    if "K1" not in kernels:
        (src / "error_string.cu").write_text(ERROR_STRING_STUB)
    _build.CSRC_DIR, _build.BUILD_DIR = src, workdir / "build"
    built = _build.build_library()
    lib = ctypes.CDLL(str(built.path))
    # ptxas's registers and spills of each kernel (`-Xptxas=-v`), entry by entry
    lib.ptxas, entry = {}, None
    for line in built.log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and ("registers" in line or "spill" in line):
            lib.ptxas.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
    names = [KERNELS[k][1] for k in kernels]
    if "K1" in kernels:
        names.append(K1_FOLD[1])
    if "K3" in kernels:
        names.append("mmp_epic_backward_workspace")
    if "K5" in kernels:
        names.append("mmp_epic_wide_backward_workspace")
    # which of K2's designs the build holds (`sampler_step` reads it), and
    # each entry's source (K5's signature follows it)
    lib.text = (src / KERNELS["K2"][0]).read_text() if "K2" in kernels else ""
    # (K3's kernel lives in epic_backward.cuh since its instances moved to sources of their own)
    text = {name: "".join((src / f).read_text() for f in (KERNELS[k][0], "epic_backward.cuh")
                          if (src / f).exists())
            for k in kernels for name in [KERNELS[k][1]]}
    # K1 on the tensor cores reads the buffer it shares with K2, the FFMA K1
    # before it the packed weights (one signature); K4 before its tensor-core
    # products takes no prepared weights, nor K6 and K7 before theirs their
    # stream
    lib.k1_tensor_core = "K1" in kernels and "narrow_tc.cuh" in (src / KERNELS["K1"][0]).read_text()
    lib.k4_tensor_core = "K4" in kernels and "tcw" in (src / KERNELS["K4"][0]).read_text()
    lib.gsdm_tensor_core = (src / "gsdm_blocks.cuh").exists() and "Ring" in (
        src / "gsdm_blocks.cuh").read_text()
    # K6 and K7 at any transformer width take it after the head count
    lib.gsdm_width = (src / "gsdm_blocks.cuh").exists() and "MAX_CL" in (
        src / "gsdm_blocks.cuh").read_text()
    for name in names:
        fn = getattr(lib, name)
        argtypes = list(_build._SIGNATURES[name])
        if name == KERNELS["K4"][1] and not lib.k4_tensor_core:
            del argtypes[1:3]
        if name in (KERNELS["K6"][1], KERNELS["K7"][1]) and not lib.gsdm_width:
            del argtypes[-2]  # no transformer width
        if name in (KERNELS["K6"][1], KERNELS["K7"][1]) and not lib.gsdm_tensor_core:
            del argtypes[1]  # no stream
        if name == KERNELS["K5"][1]:
            argtypes = wide_backward_signature(text[name])
        if name == KERNELS["K3"][1]:
            argtypes = narrow_backward_signature(text[name])
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.mmp_error_string.argtypes, lib.mmp_error_string.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


def wide_forward(lib, packed, t, x, k, mask, hidden):
    """K4 through `lib`, with or without the prepared weights its entry point
    takes: (out,) or (out, hidden state)."""
    if lib.k4_tensor_core:
        out = epic_wide_cuda.epic_forward_wide(packed, t, x, k, mask, output_hidden_local=hidden)
        return out if hidden else (out,)
    B, N = x.shape[:2]
    out = torch.empty((B, N, 11), device=x.device)
    hid = torch.empty((B, N, 128), device=x.device) if hidden else None
    k_in = k if packed.dims.fold_discrete else k.to(torch.int32).contiguous()
    rc = lib.mmp_epic_wide_forward(
        packed.flat.data_ptr(), t.data_ptr(), x.data_ptr(), k_in.data_ptr(), mask.data_ptr(),
        out.data_ptr(), hid.data_ptr() if hidden else None, B, N, packed.dims.c_array(),
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "mmp_epic_wide_forward")
    return (out, hid) if hidden else (out,)


def epic_forward(lib, packed, t, x, k, mask, hidden):
    """K1 through `lib`: the tensor-core kernel reads the packing's buffer
    (`with_narrow_buffer`), the FFMA kernel before it the packed weights,
    through the same signature: (out,) or (out, hidden state)."""
    if lib.k1_tensor_core:
        out = epic_cuda.epic_forward(packed, t, x, k, mask, output_hidden_local=hidden)
        return out if hidden else (out,)
    B, N = x.shape[:2]
    out = torch.empty((B, N, 11), device=x.device)
    hid = torch.empty((B, N, packed.dims.hidden), device=x.device) if hidden else None
    k_in = k if packed.dims.fold_discrete else k.to(torch.int32).contiguous()
    entry = lib.mmp_epic_forward_fold if packed.dims.fold_discrete else lib.mmp_epic_forward
    rc = entry(packed.flat.data_ptr(), t.data_ptr(), x.data_ptr(), k_in.data_ptr(), mask.data_ptr(),
               out.data_ptr(), hid.data_ptr() if hidden else None, B, N, packed.dims.c_array(),
               torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "mmp_epic_forward")
    return (out, hid) if hidden else (out,)


def sampler_step(lib, packed, x, k, mask, u, t, dt, gamma):
    """K2 through `lib`: the tensor-core kernel reads the buffer that the
    sampler's packing carries (`pack_sampler_params`), the FFMA kernel before
    it the packed weights, through the same signature: (x', k')."""
    if "tf32x3.cuh" in lib.text:
        _build.load_library = lambda: lib
        return sampler_cuda.sampler_step(packed, x, k, mask, u, t, dt, gamma=gamma)
    B, N = x.shape[:2]
    k32 = k.to(torch.int32).contiguous()
    x_out, k_out = torch.empty_like(x), torch.empty_like(k32)
    rc = lib.mmp_sampler_step(
        packed.flat.data_ptr(), x.data_ptr(), k32.data_ptr(), mask.data_ptr(), u.data_ptr(),
        x_out.data_ptr(), k_out.data_ptr(), float(t), float(dt), float(gamma), B, N,
        packed.dims.c_array(), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "mmp_sampler_step")
    return x_out, k_out.to(k.dtype)


def narrow_backward_signature(text):
    """K3's entry point's argument types: the tensor-core kernel, whose
    rerun is K1's forward, takes its buffer before the packed weights and the
    rerun's output after the gradient, the FFMA kernel before it neither."""
    argtypes = list(_build._SIGNATURES["mmp_epic_backward"])
    if "forward_jet" not in text:
        del argtypes[0], argtypes[7]
    return argtypes


def narrow_backward(lib, packed, t, x, k, mask, g):
    """K3 through `lib` (bound by its own source's signature), either
    design: d(flat). The tensor-core kernel reads the packing's buffer
    (`with_narrow_buffer`), the FFMA kernel the packed weights."""
    epic_vjp_cuda._workspace_cache.clear()  # the two builds size their scratch apart
    _build.load_library = lambda: lib
    if len(lib.mmp_epic_backward.argtypes) == len(_build._SIGNATURES["mmp_epic_backward"]):
        return epic_vjp_cuda.epic_backward(packed, t, x, k, mask, g)
    B, N = x.shape[:2]
    grid, floats = epic_vjp_cuda._workspace(lib, B, N, packed.dims, x.device)
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
    out = torch.empty_like(packed.flat)
    k32 = k.to(torch.int32).contiguous()
    rc = lib.mmp_epic_backward(
        packed.flat.data_ptr(), t.data_ptr(), x.data_ptr(), k32.data_ptr(), mask.data_ptr(),
        g.data_ptr(), out.data_ptr(), scratch.data_ptr(), grid, B, N, packed.dims.c_array(),
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "mmp_epic_backward")
    return out


def wide_backward_signature(text):
    """K5's entry point's argument types: the tensor-core kernel takes the
    forward's prepared weights and the transposed stages after the packed
    ones, the FFMA kernel before it none."""
    argtypes = list(_build._SIGNATURES["mmp_epic_wide_backward"])
    if "tcw_t" not in text:
        del argtypes[1:4]
    return argtypes


def wide_backward(lib, packed, t, x, k, mask, g):
    """K5 through `lib` (bound by its own sources' signature): d(flat)."""
    epic_wide_vjp_cuda._workspace_cache.clear()  # the two builds size their scratch apart
    _build.load_library = lambda: lib
    if len(lib.mmp_epic_wide_backward.argtypes) == len(_build._SIGNATURES["mmp_epic_wide_backward"]):
        return epic_wide_vjp_cuda.epic_backward_wide(packed, t, x, k, mask, g)
    B, N = x.shape[:2]
    grid, floats = epic_wide_vjp_cuda._workspace(lib, B, N, packed.dims, x.device)
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
    out = torch.empty_like(packed.flat)
    k32 = k.to(torch.int32).contiguous()
    rc = lib.mmp_epic_wide_backward(
        packed.flat.data_ptr(), t.data_ptr(), x.data_ptr(), k32.data_ptr(), mask.data_ptr(),
        g.data_ptr(), out.data_ptr(), scratch.data_ptr(), grid, B, N, packed.dims.c_array(),
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "mmp_epic_wide_backward")
    return out


def survival_head(lib, head, tp, last, mask_t, n_heads):
    """K6 through `lib`: the build of any width, the tensor-core build of
    width 128 or the FFMA build before it."""
    if lib.gsdm_width:
        return survival_cuda.survival_head(head, tp, last, mask_t, n_heads=n_heads)
    B, N, dh = last.shape
    tp = gsdm_stack_cuda.stacked_time_rows(tp, head.n_blocks, B)
    mask = mask_t.to(torch.float32).contiguous()
    out = torch.empty((B, N, 1), device=last.device)
    grid, scratch = gsdm_stack_cuda.block_grid_and_scratch(B, last.device)
    stream = [head.tensor_core.data_ptr()] if lib.gsdm_tensor_core else []
    rc = lib.mmp_survival_head(
        head.flat.data_ptr(), *stream, tp.data_ptr(), last.data_ptr(), mask.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), grid, B, N, dh, head.n_blocks, n_heads,
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "mmp_survival_head")
    return out


def gsdm_stack(lib, packed, tp, x_in, n_heads):
    """K7 through `lib`: the build of any width, the tensor-core build of
    width 128 or the FFMA build before it."""
    if lib.gsdm_width:
        return gsdm_stack_cuda.gsdm_stack(packed, tp, x_in, n_heads=n_heads)
    B, N, dim_in = x_in.shape
    tp = gsdm_stack_cuda.stacked_time_rows(tp, packed.n_blocks, B)
    out = torch.empty((B, N, 128), device=x_in.device)
    grid, scratch = gsdm_stack_cuda.block_grid_and_scratch(B, x_in.device)
    stream = [packed.tensor_core.data_ptr()] if lib.gsdm_tensor_core else []
    rc = lib.mmp_gsdm_stack(
        packed.flat.data_ptr(), *stream, tp.data_ptr(), x_in.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), grid, B, N, dim_in, packed.n_blocks, n_heads,
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "mmp_gsdm_stack")
    return out


def leaf_share(packed, here, other):
    """K3's and K5's per-leaf gate (|err| ≤ 1e-4·max|other leaf| + 1e-3·|other|): the
    largest share of it, over the packed leaves."""
    others = packed.rebind(other).tensors
    return max(((a - others[name]).abs() / (1e-4 * max(others[name].abs().max().item(), 1e-6)
                                             + 1e-3 * others[name].abs())).max().item()
               for name, a in packed.rebind(here).tensors.items())


def share_of_gate(here, other, atol, rtol, per_particle=False):
    """The largest |here − other| as a share of atol + rtol·|other|,
    elementwise, or per particle: atol + rtol·max|other| over the last axis."""
    scale = other.abs().amax(dim=-1, keepdim=True) if per_particle else other.abs()
    return ((here - other).abs() / (atol + rtol * scale)).max().item()


def inputs(B, N, device, gen):
    """t, x, k and a random non-prefix mask; the last jet is empty."""
    mask = (torch.rand((B, N, 1), generator=gen, device=device) < 0.6).float()
    mask[-1] = 0
    x = torch.randn((B, N, 3), generator=gen, device=device) * mask
    k = torch.randint(0, 8, (B, N, 1), generator=gen, device=device) * mask.long()
    return torch.rand((B, 1, 1), generator=gen, device=device), x, k, mask


def scaled_config(config, blocks=6, width=128):
    """`config` with every encoder width `width` and `blocks` EPiC layers
    (the `--scaled` backbone; scaled-256 at 256)."""
    e = config.encoder
    e.num_blocks = blocks
    e.dim_hidden_local = e.dim_hidden_glob = e.dim_emb_time = width
    e.dim_emb_features_continuous = e.dim_emb_features_discrete = width
    return config


def narrow_mbm(device, hidden, blocks):
    """MBM's encoder at every width `hidden` with `blocks` EPiC layers,
    seeded, packed for the narrow kernels with K1's buffer."""
    config = MultimodalBridgeMatchingConfig()
    config.encoder.dim_hidden_local = config.encoder.dim_hidden_glob = hidden
    config.encoder.num_blocks = blocks
    mbm = init_parameters(MultiModalBridgeMatching(config), 0).to(device)
    return epic_cuda.with_narrow_buffer(epic_cuda.pack_mbm_encoder_params(mbm.encoder, config))


def scaled256_mbm(device):
    """MBM's encoder at scaled-256 (every width 256, 6 blocks; a cluster of
    2 blocks a jet), seeded, packed for the wide kernels."""
    mbm = init_parameters(MultiModalBridgeMatching(scaled_config(MultimodalBridgeMatchingConfig(),
                                                                 width=256)), 0)
    return epic_wide_cuda.pack_wide_encoder_params(mbm.to(device).encoder, mbm.config)


def k4_instances(device):
    """K4's four instances at the scaled backbone: (name, packed, hidden
    output, folded input)."""
    mbm = init_parameters(MultiModalBridgeMatching(scaled_config(MultimodalBridgeMatchingConfig())), 0)
    mbm = epic_wide_cuda.pack_wide_encoder_params(mbm.to(device).encoder, mbm.config)
    flow = init_parameters(AbsorbingFlow(scaled_config(AbsorbingConfig())), 0).to(device).eval()
    absorbing, _ = flow.pack_for_kernel()
    model = init_parameters(TransdimensionalJumpDiffusion(scaled_config(TransdimensionalEpicConfig())), 0)
    model = model.to(device).eval()
    fold, _, _ = model.pack_for_kernel()
    # the folded input under the absorbing generator's 56-wide head
    d = dataclasses.replace(fold.dims, add_discrete_head=True, head_hidden=absorbing.dims.head_hidden)
    both = epic_cuda.pack_encoder(model.network, d, "wide", head=flow.generator.discrete_head_mlp)
    return [("mbm", mbm, False), ("hidden output, 56-wide head", absorbing, True),
            ("folded input, hidden output", fold, True), ("folded input, 56-wide head", both, True)]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", required=True, type=Path, help="the other revision's csrc files")
    parser.add_argument("--kernels", nargs="+", choices=sorted(KERNELS), default=sorted(KERNELS))
    parser.add_argument("--time", action="store_true",
                        help="also time the kernels chosen under both builds")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("port_kernel_bits: needs a GPU")
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)
    here = ROOT / "multimodal_particles_tpu_torch" / "ops" / "csrc"
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"other": build(args.other, Path(tmp) / "other", args.kernels),
                "here": build(here, Path(tmp) / "here", args.kernels)}
        for name, lib in libs.items():
            print(json.dumps({"build": name, "ptxas": lib.ptxas}), flush=True)

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

        def report_share(name, outs, **where):
            """The two builds' largest difference as a share of the kernel's
            gate, taking the other build's output as the reference: K4's per
            particle, K1's, K6's and K7's elementwise."""
            tol, per_particle = {"K1": (K1_TOL, False), "K4": (K4_TOL, True),
                                 "K6": (K6_TOL, False), "K7": (K7_TOL, False)}[name]
            share = max(share_of_gate(here, other, tol, tol, per_particle)
                        for other, here in zip(*outs))
            same.append(share <= 1.0)
            print(json.dumps({"kernel": name, **where, "share_of_gate": share,
                              "same_bits": all(torch.equal(a, b) for a, b in zip(*outs)),
                              "max_abs": max(a.abs().max().item() for a in outs[0])}), flush=True)

        if "K1" in args.kernels:
            mbm = init_parameters(MultiModalBridgeMatching(MultimodalBridgeMatchingConfig()), 0)
            packed = epic_cuda.with_narrow_buffer(
                epic_cuda.pack_mbm_encoder_params(mbm.to(device).encoder, mbm.config))
            t, x, k, mask = inputs(1024, 128, device, gen)
            report_share("K1", both(lambda lib: epic_forward(lib, packed, t, x, k, mask, False)),
                         config="config-berlin", B=1024, N=128)

        # K1, K2 and K3 at the wider instances and past 128 slots (N ≤ 256: one block a jet)
        for hidden, blocks, N in ((32, 3, 200), (64, 4, 256)):
            enc = narrow_mbm(device, hidden, blocks)
            t, x, k, mask = inputs(512, N, device, gen)
            if "K1" in args.kernels:
                outs = both(lambda lib: epic_forward(lib, enc, t, x, k, mask, False))
                share = max(share_of_gate(here, other, K1_TOL, K1_TOL, True)
                            for other, here in zip(*outs))
                same.append(share <= 1.0)
                print(json.dumps({"kernel": "K1", "hidden": hidden, "num_blocks": blocks, "B": 512,
                                  "N": N, "share_of_gate_per_particle": share,
                                  "same_bits": all(torch.equal(a, b) for a, b in zip(*outs))}),
                      flush=True)
            if "K2" in args.kernels:
                sampling = epic_cuda.with_narrow_buffer(enc)
                u = torch.rand((2, 512, N), generator=gen, device=device)
                outs = both(lambda lib: sampler_step(lib, sampling, x, k.to(torch.int32), mask, u,
                                                     0.5, 0.0101, 0.125))
                share = share_of_gate(outs[1][0], outs[0][0], K2_TOL, K2_TOL, True)
                same.append(share <= 1.0)
                print(json.dumps({"kernel": "K2", "hidden": hidden, "num_blocks": blocks, "B": 512,
                                  "N": N, "t": 0.5, "share_of_gate_per_particle": share,
                                  "same_bits": all(torch.equal(a, b) for a, b in zip(*outs))}),
                      flush=True)
            if "K3" in args.kernels:
                near = epic_vjp_cuda.near_kink_jets(enc, t, x, k, mask)
                g = torch.randn((512, N, 11), generator=gen, device=device) * (~near)[:, None, None]
                outs = both(lambda lib: narrow_backward(lib, enc, t, x, k, mask, g))
                share = max(leaf_share(enc, here, other) for other, here in zip(*outs))
                same.append(share <= 1.0)
                print(json.dumps({"kernel": "K3", "hidden": hidden, "num_blocks": blocks, "B": 512,
                                  "N": N, "share_of_gate": share,
                                  "same_bits": all(torch.equal(a, b) for a, b in zip(*outs))}),
                      flush=True)

        if "K2" in args.kernels or "K3" in args.kernels:
            mbm = init_parameters(MultiModalBridgeMatching(MultimodalBridgeMatchingConfig()), 0)
            berlin = epic_cuda.with_narrow_buffer(
                epic_cuda.pack_mbm_encoder_params(mbm.to(device).encoder, mbm.config))
            t, x, k, mask = inputs(1024, 128, device, gen)
        if "K2" in args.kernels:
            sampling = sampler_cuda.pack_sampler_params(mbm.encoder, mbm.config)
            u = torch.rand((2, 1024, 128), generator=gen, device=device)
            real = mask[..., 0] > 0
            for step_t in (0.0101, 0.5, 1.0 - 1e-4):
                outs = both(lambda lib: sampler_step(lib, sampling, x, k.to(torch.int32), mask, u,
                                                     step_t, 0.0101, 0.125))
                (x_other, k_other), (x_here, k_here) = outs
                share = share_of_gate(x_here, x_other, K2_TOL, K2_TOL)
                mismatch = ((k_here != k_other)[..., 0] & real).sum().item() / real.sum().item()
                same.append(share <= 1.0 and mismatch <= K2_MAX_TOKEN_MISMATCH)
                print(json.dumps({"kernel": "K2", "config": "config-berlin", "B": 1024, "N": 128,
                                  "t": step_t, "share_of_gate": share, "token_mismatch": mismatch,
                                  "same_bits": all(torch.equal(a, b) for a, b in zip(*outs))}),
                      flush=True)
        if "K3" in args.kernels:
            near = epic_vjp_cuda.near_kink_jets(berlin, t, x, k, mask)
            g = torch.randn((1024, 128, 11), generator=gen, device=device) * (~near)[:, None, None]
            outs = both(lambda lib: narrow_backward(lib, berlin, t, x, k, mask, g))
            share = max(leaf_share(berlin, here, other) for other, here in zip(*outs))
            same.append(share <= 1.0)
            print(json.dumps({"kernel": "K3", "config": "config-berlin", "B": 1024, "N": 128,
                              "share_of_gate": share,
                              "same_bits": all(torch.equal(a, b) for a, b in zip(*outs)),
                              "max_abs": max(a.abs().max().item() for a in outs[0])}), flush=True)

        flow = init_parameters(AbsorbingFlow(AbsorbingConfig()), 0).to(device).eval()
        trunk, head = flow.pack_for_kernel()
        if "K1" in args.kernels:
            t, x, k, mask = inputs(512, 109, device, gen)
            report_share("K1", both(lambda lib: epic_forward(lib, trunk, t, x, k, mask, True)),
                         config="absorbing", B=512, N=109)
            model = init_parameters(TransdimensionalJumpDiffusion(TransdimensionalEpicConfig()), 0)
            fold, _, _ = model.to(device).eval().pack_for_kernel()
            t, x, _, mask = inputs(512, 128, device, gen)
            values = torch.randn((512, 128, 8), generator=gen, device=device) * mask
            report_share("K1", both(lambda lib: epic_forward(lib, fold, t, x, values, mask, True)),
                         config="transdim (folded input, no head)", B=512, N=128)

        if "K4" in args.kernels:
            for name, packed, hidden in k4_instances(device):
                for N in (109, 128):
                    t, x, k, mask = inputs(512, N, device, gen)
                    if packed.dims.fold_discrete:  # channel values in place of tokens
                        k = torch.randn((512, N, 8), generator=gen, device=device) * mask
                    report_share("K4", both(lambda lib: wide_forward(lib, packed, t, x, k, mask,
                                                                     hidden)),
                                 instance=name, B=512, N=N)
            wide256 = scaled256_mbm(device)
            for N in (109, 128):
                t, x, k, mask = inputs(512, N, device, gen)
                report_share("K4", both(lambda lib: wide_forward(lib, wide256, t, x, k, mask, False)),
                             instance="mbm at scaled-256 (cluster of 2)", B=512, N=N)

        if "K5" in args.kernels:
            mbm = init_parameters(MultiModalBridgeMatching(scaled_config(MultimodalBridgeMatchingConfig())), 0)
            scaled = epic_wide_cuda.pack_wide_encoder_params(mbm.to(device).encoder, mbm.config)
            for config, packed in (("scaled MBM", scaled),
                                   ("scaled-256 MBM (cluster of 2)", scaled256_mbm(device))):
                t, x, k, mask = inputs(512, 128, device, gen)
                near = epic_vjp_cuda.near_kink_jets(packed, t, x, k, mask)
                g = torch.randn((512, 128, 11), generator=gen, device=device) * (~near)[:, None, None]
                outs = both(lambda lib: wide_backward(lib, packed, t, x, k, mask, g))
                share = max(leaf_share(packed, here, other) for other, here in zip(*outs))
                same.append(share <= 1.0)
                print(json.dumps({"kernel": "K5", "config": config, "B": 512, "N": 128,
                                  "share_of_gate": share,
                                  "same_bits": all(torch.equal(a, b) for a, b in zip(*outs)),
                                  "max_abs": max(a.abs().max().item() for a in outs[0])}),
                      flush=True)

        if "K6" in args.kernels:
            gen_cfg = flow.config.generator
            for B, N in ((512, 109), (7, 109), (64, 128)):
                t, _, _, mask = inputs(B, N, device, gen)
                last = torch.randn((B, N, head.dim_hidden), generator=gen, device=device)
                tp = survival_cuda.project_time_embeddings(flow.generator, t, gen_cfg.n_attn_blocks,
                                                           gen_cfg.transformer_dim)
                report_share("K6", both(lambda lib: survival_head(
                    lib, head, tp, last, mask.long(), gen_cfg.n_heads)), B=B, N=N)

        if "K7" in args.kernels:
            cases = []
            for config, shapes in ((TransdimensionalEpicConfig(), ((512, 128), (512, 128), (7, 40))),
                                   (scaled_config(TransdimensionalEpicConfig()), ((64, 128),) * 2)):
                model = init_parameters(TransdimensionalJumpDiffusion(config), 0).to(device).eval()
                net = model.network
                _, rate_stack, vec_stack = model.pack_for_kernel()
                stacks = ((rate_stack, net.blocks()[0]), (vec_stack, net.blocks("vec_")[0]),
                          (vec_stack, net.blocks("vec_")[0]))
                cases += [(net, *stack, *shape) for stack, shape in zip(stacks, shapes)]
            for net, packed, res, B, N in cases:
                x_in = torch.randn((B, N, packed.dim_in), generator=gen, device=device)
                with torch.no_grad():
                    tp = gsdm_stack_cuda.stack_time_embeddings(
                        net.time_embedding(torch.rand((B,), generator=gen, device=device)), res)
                report_share("K7", both(lambda lib: gsdm_stack(lib, packed, tp, x_in, 2)),
                             B=B, N=N, Din=packed.dim_in)

        if "K8" in args.kernels:
            for N in (128, 109):
                q, k, v = (torch.randn((512, N, 128), generator=gen, device=device) for _ in range(3))
                mask = (torch.rand((512, N, 1), generator=gen, device=device) < 0.6).float()
                for m in (mask, None):
                    report("K8", both(lambda lib: attention_cuda.attention_core(q, k, v, m, n_heads=2)),
                           B=512, N=N, masked=m is not None)

        if args.time:
            time_head_kernels(libs, args.kernels, flow, device, gen)
    return 0 if all(same) else 1


def time_head_kernels(libs, kernels, flow, device, gen):
    """K1 to K8 (those in `kernels`) at their main paths' shapes under each
    build, in turns (other, here, here, other): K1 and K2 at config-berlin
    (B=32768, N=128), K3 there at B=8192 for a random cotangent, K4 and K5 at the scaled MBM
    backbone (every width 128, 6 blocks, B=8192, N=128; K5 for a random
    cotangent) and at scaled-256, K6 at the absorbing reference head (B=4096, N=109), K7 at the
    transdimensional creation stack (B=4096, N=128, Din=27), K8 at B=4096,
    N=128, 2 heads, with a key mask. One JSON line a kernel, with the card's
    name and power limit."""
    import chip_smoke  # its timer and card line; it imports the scripts that import this one

    card = chip_smoke.card_line()
    runs = {}
    if {"K1", "K2", "K3"} & set(kernels):
        berlin = narrow_mbm(device, 16, 2)
        sampling = sampler_cuda.pack_sampler_params(
            init_parameters(MultiModalBridgeMatching(MultimodalBridgeMatchingConfig()), 0)
            .to(device).encoder, MultimodalBridgeMatchingConfig())
        t32, x32, k32, mask32 = inputs(32768, 128, device, gen)
        u32 = torch.rand((2, 32768, 128), generator=gen, device=device)
        t8, x8, k8, mask8 = (a[:8192].contiguous() for a in (t32, x32, k32, mask32))
        g8 = torch.randn((8192, 128, 11), generator=gen, device=device)
    if "K1" in kernels:
        runs["K1"] = ({"config": "config-berlin", "B": 32768, "N": 128},
                      lambda lib: epic_forward(lib, berlin, t32, x32, k32, mask32, False))
    if "K2" in kernels:
        runs["K2"] = ({"config": "config-berlin", "B": 32768, "N": 128, "t": 0.5},
                      lambda lib: sampler_step(lib, sampling, x32, k32.to(torch.int32), mask32, u32,
                                               0.5, 0.0101, 0.125))
    if "K3" in kernels:
        runs["K3"] = ({"config": "config-berlin", "B": 8192, "N": 128},
                      lambda lib: narrow_backward(lib, berlin, t8, x8, k8, mask8, g8))
    if "K4" in kernels or "K5" in kernels:
        mbm = init_parameters(MultiModalBridgeMatching(scaled_config(MultimodalBridgeMatchingConfig())), 0)
        scaled = epic_wide_cuda.pack_wide_encoder_params(mbm.to(device).encoder, mbm.config)
        t8, x8, k8, mask8 = inputs(8192, 128, device, gen)
        g8 = torch.randn((8192, 128, 11), generator=gen, device=device)
        wide256 = scaled256_mbm(device)
    if "K4" in kernels:
        runs["K4"] = ({"config": "scaled MBM", "B": 8192, "N": 128},
                      lambda lib: wide_forward(lib, scaled, t8, x8, k8, mask8, False))
        runs["K4 scaled-256"] = ({"config": "scaled-256 MBM", "B": 8192, "N": 128},
                                 lambda lib: wide_forward(lib, wide256, t8, x8, k8, mask8, False))
    if "K5" in kernels:
        runs["K5"] = ({"config": "scaled MBM", "B": 8192, "N": 128},
                      lambda lib: wide_backward(lib, scaled, t8, x8, k8, mask8, g8))
        runs["K5 scaled-256"] = ({"config": "scaled-256 MBM", "B": 8192, "N": 128},
                                 lambda lib: wide_backward(lib, wide256, t8, x8, k8, mask8, g8))
    if "K6" in kernels:
        gen_cfg = flow.config.generator
        _, head = flow.pack_for_kernel()
        t, _, _, mask = inputs(4096, 109, device, gen)
        last = torch.randn((4096, 109, head.dim_hidden), generator=gen, device=device)
        tp = survival_cuda.project_time_embeddings(flow.generator, t, gen_cfg.n_attn_blocks,
                                                   gen_cfg.transformer_dim)
        runs["K6"] = ({"B": 4096, "N": 109}, lambda lib: survival_head(
            lib, head, tp, last, mask.long(), gen_cfg.n_heads))
    if "K7" in kernels:
        model = init_parameters(TransdimensionalJumpDiffusion(TransdimensionalEpicConfig()), 0)
        net = model.to(device).eval().network
        _, _, vec_stack = model.pack_for_kernel()
        x_in = torch.randn((4096, 128, vec_stack.dim_in), generator=gen, device=device)
        with torch.no_grad():
            tp7 = gsdm_stack_cuda.stack_time_embeddings(
                net.time_embedding(torch.rand((4096,), generator=gen, device=device)),
                net.blocks("vec_")[0])
        runs["K7"] = ({"B": 4096, "N": 128, "Din": vec_stack.dim_in},
                      lambda lib: gsdm_stack(lib, vec_stack, tp7, x_in, 2))
    if "K8" in kernels:
        q, k, v = (torch.randn((4096, 128, 128), generator=gen, device=device) for _ in range(3))
        m = (torch.rand((4096, 128, 1), generator=gen, device=device) < 0.6).float()
        runs["K8"] = ({"B": 4096, "N": 128, "n_heads": 2, "masked": True},
                      lambda lib: attention_cuda.attention_core(q, k, v, m, n_heads=2))
    for name, (where, run) in runs.items():
        times = {build: [] for build in libs}
        for build in ("other", "here", "here", "other"):
            _build.load_library = lambda lib=libs[build]: lib
            times[build].append(chip_smoke.cuda_ms(lambda: run(libs[build])))
        mean = {build: sum(ms) / len(ms) for build, ms in times.items()}
        print(json.dumps({"kernel": name, **where, "ms": times, "mean_ms": mean,
                          "here_over_other": mean["here"] / mean["other"], "card": card}),
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
