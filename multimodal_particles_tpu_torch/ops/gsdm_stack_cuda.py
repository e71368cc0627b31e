"""The transdimensional family's gsdm stack as one hand-written CUDA kernel
(counterpart of multimodal_particles_tpu/ops/gsdm_stack_pallas.py).

The stack is proj_in of a (B, N, Din) input → n_blocks × (ResnetBlock,
AttnBlock) → the hidden state (B, N, C): the survival head
(ops/survival_cuda.py) without its rate projections and with an input of any
width. The two share the packing of a block (`block_layout`, `block_weights`,
`pack_flat`), the plain version of the block walk (`blocks_reference`) and, on
the card, the device code (ops/csrc/gsdm_blocks.cuh).

`pack_gsdm_stack_params` lays the stack's weights into one flat float32
buffer, matrices (in, out) row-major (gsdm_stack_pallas.py:41-60; the layout
is `stack_layout`, proj_in's weight stored with zero rows up to the next
multiple of 16), which the plain version reads, and beside it the stream of
tensor-core stages that the kernel reads its matrices from (`stack_stream`):
every matrix in the order the kernel multiplies by it, in stages of 8 input
rows as TF32 hi and lo halves in the tensor cores' core-matrix order
(`tensor_core_stream`), proj_in's padded with zero rows to a multiple of 8
(Din = 24 → 3 stages, 27 → 4; at the `--scaled` trunk 136 → 17, 139 → 18,
which the kernel takes in passes of 128 columns). The kernel reads the
vectors (biases, GroupNorm's scales) from the flat buffer.
At transformer widths 256, 384 and 512 a jet is a cluster of C / 128 blocks
on the card, each owning 128 channels (ops/csrc/gsdm_blocks.cuh): the
stream holds each block's 128 output columns of every matrix, block after
block (`tensor_core_stream`), and the flat buffer's vectors are the whole
width's. Heads of any width up to 128 channels that divides C.
`stack_time_embeddings` computes the per-block time rows from an already
projected time embedding; they depend on the (B,) times only and stay plain
PyTorch as they stay XLA in JAX (:63-70). `gsdm_stack` launches
ops/csrc/gsdm_stack.cu on CUDA tensors; `gsdm_stack_reference` is its plain
PyTorch version, which the wrapper takes for CPU tensors.
"""

import dataclasses
import math
from typing import Dict

import torch

from multimodal_particles_tpu_torch.models.architectures.gsdm import group_norm, swish
from multimodal_particles_tpu_torch.ops import _build
from multimodal_particles_tpu_torch.ops.epic_cuda import STAGE_ROWS, tensor_core_stages

# what the kernels are compiled for (ops/csrc/gsdm_blocks.cuh): channels a
# block owns, the transformer widths (a cluster of width / 128 blocks a jet),
# the widest head, the slots a block owns (a jet of more slots is a cluster of
# row blocks too), the slots of a jet
CHANNELS = 128
WIDTHS = (128, 256, 384, 512)
MAX_HEAD_WIDTH = 128
BLOCK_ROWS = 128
MAX_PARTICLES = 256
# proj_in's rows in the flat buffer: zero rows up to a multiple of this
# (ops/csrc/gsdm_stack.cu finds proj_in's bias after them)
WEIGHT_TILE_ROWS = 16
# a block's scratch: its parked residual tile and the tile of the heads that
# lie across two blocks, 128 rows each (ops/csrc/gsdm_blocks.cuh SCRATCH_FLOATS)
SCRATCH_FLOATS = 2 * BLOCK_ROWS * 132


def block_layout(i: int, C: int = CHANNELS):
    """(name, shape) of block i's packed weights at transformer width C, in
    buffer order; matrices (in, out). Must match `make_block_layout` in
    ops/csrc/gsdm_blocks.cuh."""
    return [
        (f"gn1_s_{i}", (C,)), (f"gn1_b_{i}", (C,)), (f"w_c1_{i}", (C, C)), (f"b_c1_{i}", (C,)),
        (f"gn2_s_{i}", (C,)), (f"gn2_b_{i}", (C,)), (f"w_c2_{i}", (C, C)), (f"b_c2_{i}", (C,)),
        (f"gna_s_{i}", (C,)), (f"gna_b_{i}", (C,)),
        (f"wq_{i}", (C, C)), (f"bq_{i}", (C,)), (f"wk_{i}", (C, C)), (f"bk_{i}", (C,)),
        (f"wv_{i}", (C, C)), (f"bv_{i}", (C,)), (f"wp_{i}", (C, C)), (f"bp_{i}", (C,)),
    ]


def block_weights(res, att, i: int) -> Dict[str, torch.Tensor]:
    """A (ResnetBlock, AttnBlock) pair of modules → block i's weights by
    `block_layout` name, matrices (in, out)."""
    src = {}
    for name, norm in (("gn1", res.norm1), ("gn2", res.norm2), ("gna", att.norm)):
        src[f"{name}_s_{i}"], src[f"{name}_b_{i}"] = norm.weight, norm.bias
    for name, dense in (("c1", res.conv1), ("c2", res.conv2)):
        src[f"w_{name}_{i}"], src[f"b_{name}_{i}"] = dense.weight.T, dense.bias
    for name, dense in (("q", att.q), ("k", att.k), ("v", att.v), ("p", att.proj_out)):
        src[f"w{name}_{i}"], src[f"b{name}_{i}"] = dense.weight.T, dense.bias
    return src


def pack_flat(src: Dict[str, torch.Tensor], layout):
    """Weights by name → (flat float32 buffer in `layout` order, named views
    into it). Detached. Raises when a weight has not its layout's shape."""
    for name, shape in layout:
        if tuple(src[name].shape) != shape:
            raise ValueError(f"packed weight {name}: shape {tuple(src[name].shape)} != {shape}")
    with torch.no_grad():
        flat = torch.cat([src[name].reshape(-1).float() for name, _ in layout])
    tensors, off = {}, 0
    for name, shape in layout:
        n = math.prod(shape)
        tensors[name] = flat[off:off + n].view(shape)
        off += n
    return flat, tensors


def blocks_reference(W: Dict[str, torch.Tensor], h, temb_projected, n_blocks: int, n_heads: int):
    """Plain PyTorch version of the block walk on packed weights: what the
    JAX kernels compute a block (gsdm_stack_pallas.py:84-110), GroupNorm and
    attention over all N slots. h: (B, N, C)."""
    B, N, C = h.shape
    head_dim = C // n_heads
    for i in range(n_blocks):
        r = swish(group_norm(h, W[f"gn1_s_{i}"], W[f"gn1_b_{i}"])) @ W[f"w_c1_{i}"] + W[f"b_c1_{i}"]
        r = r + temb_projected[i][:, None, :]
        r = swish(group_norm(r, W[f"gn2_s_{i}"], W[f"gn2_b_{i}"])) @ W[f"w_c2_{i}"] + W[f"b_c2_{i}"]
        h = h + r
        hn = group_norm(h, W[f"gna_s_{i}"], W[f"gna_b_{i}"])
        q = ((hn @ W[f"wq_{i}"] + W[f"bq_{i}"]) * head_dim**-0.5).reshape(B, N, n_heads, head_dim)
        k = (hn @ W[f"wk_{i}"] + W[f"bk_{i}"]).reshape(B, N, n_heads, head_dim)
        v = (hn @ W[f"wv_{i}"] + W[f"bv_{i}"]).reshape(B, N, n_heads, head_dim)
        p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, N, C)
        h = h + (o @ W[f"wp_{i}"] + W[f"bp_{i}"])
    return h


def heads_supported(C: int, n_heads: int) -> bool:
    """True when the kernels take n_heads heads at transformer width C: C
    one of WIDTHS, heads of any width up to 128 channels that divides C."""
    return C in WIDTHS and n_heads >= 1 and C % n_heads == 0 and C // n_heads <= MAX_HEAD_WIDTH


def check_heads(n_heads: int, C: int):
    if not heads_supported(C, n_heads):
        raise ValueError(f"n_heads={n_heads} at width {C}: the kernels take widths {WIDTHS} with "
                         f"heads of at most {MAX_HEAD_WIDTH} channels that divide the width")


def check_float32_on(device, **tensors):
    """Every tensor float32, contiguous and on `device`."""
    for name, tensor in tensors.items():
        if tensor.device != device:
            raise ValueError(f"{name} is on {tensor.device}, the input on {device}")
        if tensor.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {tensor.dtype}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_stream(stream, stages: int, device):
    """A packing's tensor-core stream as its kernel reads it: `stages` stages
    (over all blocks of a cluster), float32, contiguous, 16-byte aligned, on
    `device`."""
    check_float32_on(device, tensor_core=stream)
    if stream.numel() != stages * 2 * STAGE_ROWS * CHANNELS or stream.data_ptr() % 16:
        raise ValueError(f"the tensor-core stream must be {stages} stages, 16-byte aligned")


def stacked_time_rows(temb_projected, n_blocks: int, B: int, C: int = CHANNELS):
    """n_blocks tensors (B, C) → one (n_blocks, B, C) tensor as the kernels read it."""
    if len(temb_projected) != n_blocks:
        raise ValueError(f"{len(temb_projected)} time rows for {n_blocks} blocks")
    tp = torch.stack(tuple(temb_projected))
    if tuple(tp.shape) != (n_blocks, B, C):
        raise ValueError(f"time rows must be ({B}, {C}) each, got {tuple(tp.shape[1:])}")
    return tp


def block_grid_and_scratch(B: int, device, C: int = CHANNELS, N: int = BLOCK_ROWS):
    """One block an SM walks over the jets, in clusters of C / 128 channel
    blocks × ⌈N / 128⌉ row blocks a jet (the kernel launches no more clusters
    than are resident at once); each block parks its residual tile in its row
    of the scratch while it attends."""
    cl = C // CHANNELS * -(-N // BLOCK_ROWS)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    grid = min(B * cl, sms // cl * cl)
    return grid, torch.empty((grid, SCRATCH_FLOATS), dtype=torch.float32, device=device)


def tensor_core_stream(matrices):
    """(K, C) weights, (in, out), → one flat stream of their stages as the
    kernels' weight rings read them: for each block of a cluster (C / 128 of
    them) its 128 output columns of every matrix, matrix after matrix, each
    padded with zero rows to a multiple of 8, then per stage of 8 input rows
    the TF32 hi half and the lo half (w − hi), rounded to nearest, in
    core-matrix order (ops/epic_cuda.py::tensor_core_stages). At C = 128 one
    block's stream."""
    width = matrices[0].shape[1]
    with torch.no_grad():
        parts = []
        for c0 in range(0, width, CHANNELS):
            for w in matrices:
                w = w[:, c0:c0 + CHANNELS]
                pad = -w.shape[0] % STAGE_ROWS
                if pad:
                    w = torch.cat([w, w.new_zeros((pad, w.shape[1]))])
                parts.append(tensor_core_stages(w.detach().float()[None]))
        return torch.cat(parts).contiguous()


def block_stream_matrices(W: Dict[str, torch.Tensor], i: int):
    """Block i's matrices in the order the kernel multiplies by them: conv1,
    conv2, k, v, q, proj_out."""
    return [W[f"{name}_{i}"] for name in ("w_c1", "w_c2", "wk", "wv", "wq", "wp")]


# ----------------------------------------------------------------- the stack


def padded_width(dim_in: int) -> int:
    return -(-dim_in // WEIGHT_TILE_ROWS) * WEIGHT_TILE_ROWS


def stream_stages(dim_in: int, n_blocks: int, C: int = CHANNELS) -> int:
    """Stages of a stack's tensor-core stream at transformer width C, over
    its C / 128 blocks: each block's proj_in ⌈Din/8⌉, then 6 × C / 8 a
    block."""
    return C // CHANNELS * (-(-dim_in // STAGE_ROWS) + n_blocks * 6 * (C // STAGE_ROWS))


def stack_layout(dim_in: int, n_blocks: int, C: int = CHANNELS):
    """(name, shape) of every packed weight of a stack at transformer width
    C, in buffer order: proj_in's weight with zero rows up to
    `padded_width(dim_in)`, its bias, then the blocks. ops/csrc/gsdm_stack.cuh
    reads the buffer in this order."""
    entries = [("w_in", (padded_width(dim_in), C)), ("b_in", (C,))]
    for i in range(n_blocks):
        entries += block_layout(i, C)
    return entries


@dataclasses.dataclass
class PackedGsdmStack:
    flat: torch.Tensor  # (n,) float32, contiguous, in stack_layout order
    tensors: Dict[str, torch.Tensor]  # named views into `flat`, matrices (in, out)
    dim_in: int
    n_blocks: int
    tensor_core: torch.Tensor  # the kernel's stream of weight stages (`stack_stream`)
    channels: int = CHANNELS  # the transformer width


def stack_stream(W: Dict[str, torch.Tensor], dim_in: int, n_blocks: int):
    """A stack's tensor-core stream: proj_in's Din rows, then every block's
    matrices (`block_stream_matrices`)."""
    matrices = [W["w_in"][:dim_in]]
    for i in range(n_blocks):
        matrices += block_stream_matrices(W, i)
    return tensor_core_stream(matrices)


def pack_gsdm_stack_params(proj_in, res_blocks, attn_blocks) -> PackedGsdmStack:
    """(proj_in Linear, [ResnetBlock], [AttnBlock]) → the stack's weights in
    one flat buffer (gsdm_stack_pallas.py:41-60), and their tensor-core
    stream."""
    w_in = proj_in.weight.T  # (Din, C)
    (dim_in, C), n_blocks = w_in.shape, len(res_blocks)
    pad = w_in.new_zeros((padded_width(dim_in) - dim_in, C))
    src = {"w_in": torch.cat([w_in, pad]), "b_in": proj_in.bias}
    for i, (res, att) in enumerate(zip(res_blocks, attn_blocks)):
        src.update(block_weights(res, att, i))
    flat, tensors = pack_flat(src, stack_layout(dim_in, n_blocks, C))
    return PackedGsdmStack(flat, tensors, dim_in, n_blocks,
                           stack_stream(tensors, dim_in, n_blocks), C)


def stack_time_embeddings(temb, res_blocks):
    """The per-block time rows res_i.temb_proj(swish(temb)), each (B, C), from
    an already projected temb (B, C): the caller owns temb_net
    (gsdm_stack_pallas.py:63-70)."""
    stemb = swish(temb)
    return tuple(res.temb_proj(stemb) for res in res_blocks)


def gsdm_stack_supported(config) -> bool:
    """True when the transdimensional heads match what the kernel is compiled
    for (transdimensional_model.py:329-333 without the TPU-only parts): no
    tensor-parallel 'model' axis, transformer width 128, 256, 384 or 512 with
    heads of at most 128 channels that divide it (`heads_supported`), at least
    one block, at most 256 slots. The stacks' input width
    (the trunk's hidden width + V, and + 3) may be any: the kernel's first
    product runs over it in passes of 128 columns, as the JAX kernel takes any
    width (gsdm_stack_pallas.py:138, :152, :168)."""
    if getattr(getattr(config, "parallel", None), "model_axis", 1) > 1:
        return False
    e, d = config.encoder, config.data
    return (
        heads_supported(e.transformer_dim, e.n_heads)
        and e.n_attn_blocks >= 1
        and 1 <= d.max_num_particles <= MAX_PARTICLES
    )


def gsdm_stack_reference(packed: PackedGsdmStack, temb_projected, x_in, *, n_heads: int):
    """Plain PyTorch version of the kernel: what `_stack_kernel` computes
    (gsdm_stack_pallas.py:73-112) on the packed weights. (B, N, C) float32."""
    gsdm_stack_reference.calls += 1
    W = packed.tensors
    h = x_in.float() @ W["w_in"][:packed.dim_in] + W["b_in"]
    return blocks_reference(W, h, temb_projected, packed.n_blocks, n_heads)


gsdm_stack_reference.calls = 0


def gsdm_stack(packed: PackedGsdmStack, temb_projected, x_in, *, n_heads: int):
    """Fused stack. temb_projected: n_blocks tensors (B, C); x_in (B, N, Din)
    float32 → the hidden state (B, N, C) float32. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if x_in.device.type == "cpu":
        return gsdm_stack_reference(packed, temb_projected, x_in, n_heads=n_heads)
    if x_in.dim() != 3:
        raise ValueError(f"x_in must be (B, N, Din), got {tuple(x_in.shape)}")
    B, N, dim_in = x_in.shape
    if dim_in != packed.dim_in or dim_in < 1:
        raise ValueError(f"input width {dim_in}: packed for {packed.dim_in}")
    if not 1 <= N <= MAX_PARTICLES:
        raise ValueError(f"N={N} outside [1, {MAX_PARTICLES}]")
    C = packed.channels
    check_heads(n_heads, C)
    tp = stacked_time_rows(temb_projected, packed.n_blocks, B, C)
    check_float32_on(x_in.device, x_in=x_in, time_rows=tp, weights=packed.flat)
    if packed.flat.data_ptr() % 16:
        raise ValueError("the packed weights must be 16-byte aligned")
    out = torch.empty((B, N, C), dtype=torch.float32, device=x_in.device)
    if B == 0:
        return out
    lib = _build.load_library()
    # the stream is checked where the kernel reads it
    check_stream(packed.tensor_core, stream_stages(dim_in, packed.n_blocks, C), x_in.device)
    grid, scratch = block_grid_and_scratch(B, x_in.device, C, N)
    with torch.cuda.device(x_in.device):
        stream = torch.cuda.current_stream(x_in.device).cuda_stream
        rc = lib.mmp_gsdm_stack(
            packed.flat.data_ptr(), packed.tensor_core.data_ptr(), tp.data_ptr(),
            x_in.data_ptr(), out.data_ptr(), scratch.data_ptr(), grid, B, N, dim_in,
            packed.n_blocks, n_heads, C, stream,
        )
    _build.check(lib, rc, "mmp_gsdm_stack")
    gsdm_stack.launches += 1
    return out


gsdm_stack.launches = 0
