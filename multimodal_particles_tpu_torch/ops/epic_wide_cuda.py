"""Fused EPiC forward at hidden 128 as one hand-written CUDA kernel
(counterpart of multimodal_particles_tpu/ops/epic_pallas_wide.py).

The wide kernel is a chain of matrix products through shared memory
(ops/csrc/epic_wide.cuh); it streams each weight in tiles of input rows, so
`pack_wide_encoder_params` lays the effective weights (in, out) row-major, as
the JAX wide packing does (epic_pallas_wide.py:58-69; the layout itself is
`wide_weight_layout` in ops/epic_cuda.py). The named views of a wide
`PackedEncoder` are the transposes, (out, in), so the plain version is
the one `forward_from_temb` of ops/epic_cuda.py for both kernel families.
`epic_forward_wide` launches ops/csrc/epic_wide_forward.cu on CUDA tensors
and takes the plain version for CPU tensors.
"""

import torch

from multimodal_particles_tpu_torch.ops import _build
from multimodal_particles_tpu_torch.ops.epic_cuda import (
    DIM_C,
    VOCAB,
    EpicDims,
    PackedEncoder,
    check_head_width,
    check_kernel_inputs,
    effective_weights,
    epic_forward_reference,
    epic_pattern_supported,
    transposed_in_wide,
    weight_layout,
    wide_flat_views,
)

# the width and the particle slots the wide kernels are compiled for
# (ops/csrc/epic_wide.cuh)
WIDE_WIDTH = 128
WIDE_MAX_PARTICLES = 128


def pack_wide_encoder_params(encoder, config, differentiable: bool = False) -> PackedEncoder:
    """MultiModalEPiC module → flat buffer of effective weights, (in, out)
    row-major, for the wide kernels (epic_pallas_wide.py:65-69). With
    `differentiable`, `flat` is a non-leaf of the autograd graph."""
    d = EpicDims.from_config(config)
    with torch.set_grad_enabled(differentiable and torch.is_grad_enabled()):
        src = effective_weights(encoder, d)
        flat = torch.cat([
            (src[name].T if transposed_in_wide(name, shape) else src[name]).reshape(-1).float()
            for name, shape in weight_layout(d)
        ])
    return PackedEncoder(flat, wide_flat_views(flat, d), d, "wide")


def wide_supported(config) -> bool:
    """True when the encoder matches what the wide kernels are compiled for:
    the pattern of `epic_supported` with every feature width 128. The JAX gate
    (epic_pallas_wide.py:335-369) takes every multiple of 128; other
    multiples go to the module path here."""
    e = config.encoder
    widths = (e.dim_hidden_local, e.dim_hidden_glob, e.dim_emb_time,
              e.dim_emb_features_continuous, e.dim_emb_features_discrete)
    return (
        epic_pattern_supported(config)
        and all(w == WIDE_WIDTH for w in widths)
        and 1 <= config.data.max_num_particles <= WIDE_MAX_PARTICLES
    )


def check_wide_packing(packed: PackedEncoder):
    """The wide kernels take the wide layout at width 128, 16-byte aligned
    (they read it as float4)."""
    d = packed.dims
    if packed.layout != "wide":
        raise ValueError("the wide kernels read the pack_wide_encoder_params layout")
    if any(w != WIDE_WIDTH for w in (d.hidden, d.hidden_glob, d.emb_t, d.emb_x, d.emb_k)):
        raise ValueError(f"the wide kernels are compiled for width {WIDE_WIDTH} throughout, got {d}")
    check_head_width(packed, "the wide kernels")
    if packed.flat.data_ptr() % 16:
        raise ValueError("the packed weights must be 16-byte aligned")


def epic_forward_wide(packed: PackedEncoder, t, x, k, mask):
    """Fused EPiC forward at hidden 128. t (B,1,1), x (B,N,3), k (B,N,1) int,
    mask (B,N,1) → (B, N, 3 + 8) float32. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return epic_forward_reference(packed, t, x, k, mask)
    check_wide_packing(packed)
    B, N = check_kernel_inputs(packed, x, k, mask, WIDE_MAX_PARTICLES, t=t)
    if t.numel() != B:
        raise ValueError(f"t must hold one time per jet, got {tuple(t.shape)}")
    k32 = k.to(torch.int32).contiguous()
    out = torch.empty((B, N, DIM_C + VOCAB), dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mmp_epic_wide_forward(
            packed.flat.data_ptr(), t.data_ptr(), x.data_ptr(), k32.data_ptr(),
            mask.data_ptr(), out.data_ptr(), B, N, packed.dims.c_array(), stream,
        )
    _build.check(lib, rc, "mmp_epic_wide_forward")
    epic_forward_wide.launches += 1
    return out


epic_forward_wide.launches = 0
