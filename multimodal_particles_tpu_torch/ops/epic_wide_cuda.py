"""Fused EPiC forward at the wide widths as one hand-written CUDA kernel
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

Widths: the local hidden width, the global one and the time embedding's
each 128, 256, 384 or 512, mixed, and the token embeddings too (with the
folded input two widths whose sum is a multiple of 128), N ≤ 256, a
discrete head up to 512 wide. At every width 128 with a head of at most 64
and N ≤ 128 a jet is one block (ops/csrc/epic_wide.cuh); otherwise a
cluster of hidden / 128 blocks (ops/csrc/epic_wide_any.cuh), each owning 128
columns of every activation tile, the stages and tables laid out a column
block after the other; past 128 slots, at every width, a cluster of
hidden / 128 × 2 row blocks, row block r owning slots 128·r … + 127
(`epic_wide_forward_h*_r2.cu`). JAX's gate also takes widths above 512 and
any N; those go to the module path here.
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

# the widths, the particle slots (two row blocks of 128) and the widest
# discrete head the wide kernels are compiled for (ops/csrc/epic_wide.cuh,
# epic_wide_any.cuh)
WIDE_WIDTHS = (128, 256, 384, 512)
WIDE_MAX_PARTICLES = 256
MAX_WIDE_HEAD = 512


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


def embedding_widths_supported(d_x: int, d_k: int, linear_discrete: bool) -> bool:
    """The token embeddings' widths the wide kernels take: each one of
    WIDE_WIDTHS; with the folded Linear-discrete input two widths up to 512
    whose sum is a multiple of 128 (epic_pallas_wide.py:363-369), the
    discrete one a multiple of 4 so that the packed matrices after it stay
    16-byte aligned."""
    if linear_discrete:
        return (1 <= d_x <= WIDE_WIDTHS[-1] and 1 <= d_k <= WIDE_WIDTHS[-1]
                and (d_x + d_k) % 128 == 0 and d_k % 4 == 0)
    return d_x in WIDE_WIDTHS and d_k in WIDE_WIDTHS


def wide_supported(config, allow_linear_discrete: bool = False, head_hidden: int = VOCAB) -> bool:
    """True when the encoder matches what the wide kernels are compiled for:
    the pattern of `epic_supported` with the local hidden, global and time
    widths each one of WIDE_WIDTHS (mixed), the token embeddings as
    `embedding_widths_supported` takes them, at most 256 particle slots and a
    discrete head at most MAX_WIDE_HEAD wide (`head_hidden`: the absorbing
    generator's `discrete_head_hidden_dim`); with `allow_linear_discrete`
    also the Linear-discrete input. Only the forward kernel takes the
    Linear-discrete input or a head other than the vocabulary's. The JAX gate
    (epic_pallas_wide.py:335-369) takes the same at these widths, and also
    every wider multiple of 128 and any N, which go to the module path here."""
    e = config.encoder
    linear = allow_linear_discrete and e.embedding_features_discrete == "Linear"
    return (
        epic_pattern_supported(config, allow_linear_discrete)
        and all(w in WIDE_WIDTHS for w in (e.dim_hidden_local, e.dim_hidden_glob, e.dim_emb_time))
        and embedding_widths_supported(e.dim_emb_features_continuous,
                                       e.dim_emb_features_discrete, linear)
        and 1 <= config.data.max_num_particles <= WIDE_MAX_PARTICLES
        and 1 <= head_hidden <= MAX_WIDE_HEAD
    )


def check_wide_packing(packed: PackedEncoder, any_head_width: bool = False):
    """The wide kernels take the wide layout at the widths `wide_supported`
    takes, 16-byte aligned (they read it as float4). Only the forward kernel
    (`any_head_width`) takes a discrete head of another hidden width than the
    vocabulary's (up to MAX_WIDE_HEAD) or the folded Linear-discrete input."""
    d = packed.dims
    if packed.layout != "wide":
        raise ValueError("the wide kernels read the pack_wide_encoder_params layout")
    if (any(w not in WIDE_WIDTHS for w in (d.hidden, d.hidden_glob, d.emb_t))
            or not embedding_widths_supported(d.emb_x, d.emb_k, d.fold_discrete)):
        raise ValueError(f"the wide kernels are compiled for widths {WIDE_WIDTHS}, got {d}")
    if any_head_width:
        if not 1 <= d.head_hidden <= MAX_WIDE_HEAD:
            raise ValueError(f"head width {d.head_hidden} outside [1, {MAX_WIDE_HEAD}]")
    else:
        check_head_width(packed, "the wide backward kernel")
    if packed.flat.data_ptr() % 16:
        raise ValueError("the packed weights must be 16-byte aligned")


def epic_forward_wide(packed: PackedEncoder, t, x, k, mask, output_hidden_local=False):
    """Fused wide EPiC forward. t (B,1,1), x (B,N,3), k (B,N,1) int (with a
    folded packing the (B,N,8) float channel values), mask (B,N,1) →
    (B, N, 3 + 8) float32; with `output_hidden_local` also the trunk's last
    local hidden state (B, N, H), written by the same launch. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return epic_forward_reference(packed, t, x, k, mask, output_hidden_local)
    check_wide_packing(packed, any_head_width=True)
    B, N = check_kernel_inputs(packed, x, k, mask, WIDE_MAX_PARTICLES, t=t)
    if t.numel() != B:
        raise ValueError(f"t must hold one time per jet, got {tuple(t.shape)}")
    k_in = k if packed.dims.fold_discrete else k.to(torch.int32).contiguous()
    out = torch.empty((B, N, DIM_C + VOCAB), dtype=torch.float32, device=x.device)
    hidden = (torch.empty((B, N, packed.dims.hidden), dtype=torch.float32, device=x.device)
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
