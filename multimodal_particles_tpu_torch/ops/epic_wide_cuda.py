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
and takes the plain version for CPU tensors. The kernel's per-particle
products run on the tensor cores at fp32 accuracy (the 3×TF32 split,
ops/csrc/tf32x3.cuh); the wide packing carries the weights they read
(`PackedEncoder.tensor_core`, made once a packing by
ops/epic_cuda.py::tensor_core_weights): fc_local1's particle third and
fc_local2 of every layer as TF32 hi and lo halves in the order the tensor
cores take them, and local_0's particle two thirds folded with the
embeddings into small tables. As the JAX kernel, it serves the
three families' trunks at these widths: MBM's; the absorbing generator's,
with a discrete head of another hidden width (`head`, 56) and the trunk's
last local hidden state as a second output (`output_hidden_local`); and the
transdimensional network's bare trunk with the folded Linear-discrete input
(`pack_bare_trunk_params(..., fold_discrete=True, layout="wide")`,
epic_pallas_wide.py:72-80), which takes the (B, N, V) channel values where
MBM's takes tokens. The backward kernel (ops/epic_wide_vjp_cuda.py) takes
MBM's packing only.
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
    epic_forward_reference,
    epic_pattern_supported,
    head_width,
    pack_encoder,
)

# the width, the particle slots and the widest discrete head the wide kernels
# are compiled for (ops/csrc/epic_wide.cuh)
WIDE_WIDTH = 128
WIDE_MAX_PARTICLES = 128
MAX_WIDE_HEAD = 64


def pack_wide_encoder_params(encoder, config, differentiable: bool = False,
                             head=None) -> PackedEncoder:
    """A module with an `epic` trunk → flat buffer of effective weights,
    (in, out) row-major, for the wide kernels (epic_pallas_wide.py:65-69).
    `head` replaces the module's `fc_layer` as the discrete head (the
    absorbing generator's `discrete_head_mlp`, absorbing_flows.py:220-222);
    its hidden width enters the layout. With `differentiable`, `flat` is a
    non-leaf of the autograd graph."""
    d = EpicDims.from_config(config, head_hidden=head_width(head))
    return pack_encoder(encoder, d, "wide", differentiable, head)


def wide_supported(config, allow_linear_discrete: bool = False, head_hidden: int = VOCAB) -> bool:
    """True when the encoder matches what the wide kernels are compiled for:
    the pattern of `epic_supported` with every feature width 128 and a
    discrete head at most MAX_WIDE_HEAD wide (`head_hidden`: the absorbing
    generator's `discrete_head_hidden_dim`); with `allow_linear_discrete`
    also the Linear-discrete input. Only the forward kernel takes the
    Linear-discrete input or a head other than the vocabulary's
    (epic_pallas_wide.py:335-369). The JAX gate takes every multiple of 128
    (for the Linear-discrete input, a sum of the two embedding widths that is
    one); other widths go to the module path here."""
    e = config.encoder
    widths = (e.dim_hidden_local, e.dim_hidden_glob, e.dim_emb_time,
              e.dim_emb_features_continuous, e.dim_emb_features_discrete)
    return (
        epic_pattern_supported(config, allow_linear_discrete)
        and all(w == WIDE_WIDTH for w in widths)
        and 1 <= config.data.max_num_particles <= WIDE_MAX_PARTICLES
        and 1 <= head_hidden <= MAX_WIDE_HEAD
    )


def check_wide_packing(packed: PackedEncoder, any_head_width: bool = False):
    """The wide kernels take the wide layout at width 128, 16-byte aligned
    (they read it as float4). Only the forward kernel (`any_head_width`)
    takes a discrete head of another hidden width than the vocabulary's (up
    to MAX_WIDE_HEAD) or the folded Linear-discrete input."""
    d = packed.dims
    if packed.layout != "wide":
        raise ValueError("the wide kernels read the pack_wide_encoder_params layout")
    if any(w != WIDE_WIDTH for w in (d.hidden, d.hidden_glob, d.emb_t, d.emb_x, d.emb_k)):
        raise ValueError(f"the wide kernels are compiled for width {WIDE_WIDTH} throughout, got {d}")
    if any_head_width:
        if not 1 <= d.head_hidden <= MAX_WIDE_HEAD:
            raise ValueError(f"head width {d.head_hidden} outside [1, {MAX_WIDE_HEAD}]")
    else:
        check_head_width(packed, "the wide backward kernel")
    if packed.flat.data_ptr() % 16:
        raise ValueError("the packed weights must be 16-byte aligned")


def epic_forward_wide(packed: PackedEncoder, t, x, k, mask, output_hidden_local=False):
    """Fused EPiC forward at hidden 128. t (B,1,1), x (B,N,3), k (B,N,1) int
    (with a folded packing the (B,N,8) float channel values), mask (B,N,1) →
    (B, N, 3 + 8) float32; with `output_hidden_local` also the trunk's last
    local hidden state (B, N, 128), written by the same launch. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return epic_forward_reference(packed, t, x, k, mask, output_hidden_local)
    check_wide_packing(packed, any_head_width=True)
    B, N = check_kernel_inputs(packed, x, k, mask, WIDE_MAX_PARTICLES, t=t)
    if t.numel() != B:
        raise ValueError(f"t must hold one time per jet, got {tuple(t.shape)}")
    k_in = k if packed.dims.fold_discrete else k.to(torch.int32).contiguous()
    out = torch.empty((B, N, DIM_C + VOCAB), dtype=torch.float32, device=x.device)
    hidden = (torch.empty((B, N, WIDE_WIDTH), dtype=torch.float32, device=x.device)
              if output_hidden_local else None)
    if packed.tensor_core is None:
        raise ValueError("the wide forward kernel reads the tensor-core weights that "
                         "pack_encoder makes with the wide packing")
    stages, tables = packed.tensor_core
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mmp_epic_wide_forward(
            packed.flat.data_ptr(), stages.data_ptr(), tables.data_ptr(),
            t.data_ptr(), x.data_ptr(), k_in.data_ptr(),
            mask.data_ptr(), out.data_ptr(),
            hidden.data_ptr() if output_hidden_local else None,
            B, N, packed.dims.c_array(), stream,
        )
    _build.check(lib, rc, "mmp_epic_wide_forward")
    epic_forward_wide.launches += 1
    return (out, hidden) if output_hidden_local else out


epic_forward_wide.launches = 0
