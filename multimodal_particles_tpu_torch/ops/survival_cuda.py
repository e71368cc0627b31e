"""The absorbing family's survival head as one hand-written CUDA kernel
(counterpart of multimodal_particles_tpu/ops/survival_pallas.py).

`pack_survival_head_params` lays the head's weights into one flat float32
buffer, matrices (in, out) row-major, in the order of the JAX packing
(survival_pallas.py:56-91; the layout itself is `head_layout`, mirrored by
`make_head_layout` in ops/csrc/survival_head.cu), and beside it the stream of
tensor-core stages that the kernel reads its matrices from (`head_stream`:
proj_in's Dh trunk rows, the blocks', pre_rate's; the mask's two one-hot
rows stay in the flat buffer, a per-row correction in proj_in's epilogue).
`project_time_embeddings` computes the per-block time rows, which depend on
the (B,) times only and stay plain PyTorch as they stay XLA in JAX (:336-352).
`survival_head` launches ops/csrc/survival_head.cu on CUDA tensors;
`survival_head_reference` is its plain PyTorch version, which the wrapper
takes for CPU tensors. The (ResnetBlock, AttnBlock) blocks are the gsdm
stack's: their packing, their plain version and the wrappers' common checks
come from ops/gsdm_stack_cuda.py, their device code from
ops/csrc/gsdm_blocks.cuh. The head takes the stack's transformer widths and
head counts (`heads_supported`: 128 … 512, heads of up to 128 channels) and
a trunk of any hidden width: the kernel's first product runs over it in
passes of 128 columns, as the gsdm stack's does (a `--scaled` trunk at
hidden 256 feeds a head of C = 128).
"""

import dataclasses
from typing import Dict

import torch

from multimodal_particles_tpu_torch.models.architectures.gsdm import swish
from multimodal_particles_tpu_torch.models.architectures.utils import get_timestep_embedding
from multimodal_particles_tpu_torch.ops import _build
from multimodal_particles_tpu_torch.ops.gsdm_stack_cuda import (
    CHANNELS,
    MAX_PARTICLES,
    STAGE_ROWS,
    block_grid_and_scratch,
    block_layout,
    block_stream_matrices,
    block_weights,
    blocks_reference,
    check_float32_on,
    check_heads,
    check_stream,
    heads_supported,
    pack_flat,
    stacked_time_rows,
    tensor_core_stream,
)


def head_layout(dim_hidden: int, n_blocks: int, C: int = CHANNELS):
    """(name, shape) of every packed weight at transformer width C, in buffer
    order; matrices (in, out). Must match `make_head_layout` in
    ops/csrc/survival_head.cuh."""
    entries = [("w_in_h", (dim_hidden, C)), ("w_oh0", (C,)), ("w_oh1", (C,)), ("b_in", (C,))]
    for i in range(n_blocks):
        entries += block_layout(i, C)
    entries += [("w_pre", (C, C)), ("b_pre", (C,)), ("w_post", (C,)), ("b_post", (1,))]
    return entries


@dataclasses.dataclass
class PackedSurvivalHead:
    flat: torch.Tensor  # (n,) float32, contiguous, in head_layout order
    tensors: Dict[str, torch.Tensor]  # named views into `flat`, matrices (in, out)
    dim_hidden: int
    n_blocks: int
    tensor_core: torch.Tensor  # the kernel's stream of weight stages (`head_stream`)
    channels: int = CHANNELS  # the transformer width


def head_stream(W: Dict[str, torch.Tensor], n_blocks: int):
    """The head's tensor-core stream: proj_in's trunk rows, every block's
    matrices (ops/gsdm_stack_cuda.py::block_stream_matrices), pre_rate."""
    matrices = [W["w_in_h"]]
    for i in range(n_blocks):
        matrices += block_stream_matrices(W, i)
    return tensor_core_stream(matrices + [W["w_pre"]])


def head_stages(dim_hidden: int, n_blocks: int, C: int = CHANNELS) -> int:
    """Stages of a head's tensor-core stream at transformer width C, over its
    C / 128 blocks: each block's proj_in ⌈Dh/8⌉, then 6 × C / 8 a block and
    C / 8 for pre_rate."""
    return C // CHANNELS * (-(-dim_hidden // STAGE_ROWS) + (n_blocks * 6 + 1) * (C // STAGE_ROWS))


def pack_survival_head_params(generator, n_blocks: int) -> PackedSurvivalHead:
    """AbsorbingGenerator module → the head's weights in one flat buffer
    (survival_pallas.py:56-91). proj_in's weight is split into the rows that
    multiply the trunk's hidden state and the two rows of the mask's one-hot."""
    w_in = generator.transformer_1_proj_in.weight.T  # (Dh + 2, C)
    dh, C = w_in.shape[0] - 2, w_in.shape[1]
    src = {"w_in_h": w_in[:dh], "w_oh0": w_in[dh], "w_oh1": w_in[dh + 1],
           "b_in": generator.transformer_1_proj_in.bias}
    for i in range(n_blocks):
        src.update(block_weights(getattr(generator, f"res_block_{i}"),
                                 getattr(generator, f"attn_block_{i}"), i))
    src.update(w_pre=generator.pre_rate_proj.weight.T, b_pre=generator.pre_rate_proj.bias,
               w_post=generator.post_rate_proj.weight[0], b_post=generator.post_rate_proj.bias)
    flat, tensors = pack_flat(src, head_layout(dh, n_blocks, C))
    return PackedSurvivalHead(flat, tensors, dh, n_blocks, head_stream(tensors, n_blocks), C)


@torch.no_grad()
def project_time_embeddings(generator, t, n_blocks: int, temb_dim: int):
    """The per-block time rows tp_i = res_block_i.temb_proj(swish(temb_net(
    timestep_embedding(1000·t)))), each (B, C) (survival_pallas.py:336-352)."""
    ts = t.reshape(t.shape[0]).to(torch.float32)
    stemb = swish(generator.temb_net(get_timestep_embedding(ts * 1000.0, temb_dim)))
    return tuple(getattr(generator, f"res_block_{i}").temb_proj(stemb) for i in range(n_blocks))


def survival_supported(config) -> bool:
    """True when the head matches what the kernel is compiled for
    (survival_pallas.py:355-366 without the TPU-only parts): no tensor-parallel
    'model' axis, transformer width 128, 256, 384 or 512 with heads of at
    most 128 channels that divide it (`heads_supported`), at least one block
    and at most 256 slots. The trunk's hidden width may be any, as in JAX."""
    if getattr(getattr(config, "parallel", None), "model_axis", 1) > 1:
        return False
    g = config.generator
    return (
        heads_supported(g.transformer_dim, g.n_heads)
        and g.n_attn_blocks >= 1
        and 1 <= config.data.max_num_particles <= MAX_PARTICLES
    )


# ------------------------------------------------------------ plain version


def survival_head_reference(packed: PackedSurvivalHead, temb_projected, last_layer, mask_t, *,
                            n_heads: int):
    """Plain PyTorch version of the kernel: what `_survival_kernel` computes
    (survival_pallas.py:189-241) on the packed weights, GroupNorm and
    attention over all N slots. (B, N, 1) float32 logits."""
    survival_head_reference.calls += 1
    W = packed.tensors
    B, N, _ = last_layer.shape
    m = mask_t.reshape(B, N, 1).to(torch.float32)
    h = last_layer.float() @ W["w_in_h"] + W["w_oh0"] + m * (W["w_oh1"] - W["w_oh0"]) + W["b_in"]
    h = blocks_reference(W, h, temb_projected, packed.n_blocks, n_heads)
    h = h @ W["w_pre"] + W["b_pre"]
    return (h * W["w_post"]).sum(dim=-1, keepdim=True) + W["b_post"]


survival_head_reference.calls = 0


# ------------------------------------------------------------ kernel wrapper


def survival_head(packed: PackedSurvivalHead, temb_projected, last_layer, mask_t, *, n_heads: int):
    """Fused survival head. temb_projected: n_blocks tensors (B, C);
    last_layer (B, N, Dh) float32; mask_t (B, N, 1), any 0/1 dtype → (B, N, 1)
    float32 logits. CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if last_layer.device.type == "cpu":
        return survival_head_reference(packed, temb_projected, last_layer, mask_t, n_heads=n_heads)
    if last_layer.dim() != 3:
        raise ValueError(f"last_layer must be (B, N, Dh), got {tuple(last_layer.shape)}")
    B, N, dh = last_layer.shape
    C = packed.channels
    if dh != packed.dim_hidden or dh < 1:
        raise ValueError(f"hidden width {dh}: packed for {packed.dim_hidden}")
    if not 1 <= N <= MAX_PARTICLES:
        raise ValueError(f"N={N} outside [1, {MAX_PARTICLES}]")
    check_heads(n_heads, C)
    if tuple(mask_t.shape) != (B, N, 1):
        raise ValueError(f"mask_t must be ({B}, {N}, 1), got {tuple(mask_t.shape)}")
    tp = stacked_time_rows(temb_projected, packed.n_blocks, B, C)
    mask = mask_t.to(torch.float32).contiguous()
    check_float32_on(last_layer.device, last_layer=last_layer, mask_t=mask, time_rows=tp,
                     weights=packed.flat)
    if packed.flat.data_ptr() % 16:
        raise ValueError("the packed weights must be 16-byte aligned")
    out = torch.empty((B, N, 1), dtype=torch.float32, device=last_layer.device)
    if B == 0:
        return out
    lib = _build.load_library()
    # the stream is checked where the kernel reads it
    check_stream(packed.tensor_core, head_stages(dh, packed.n_blocks, C), last_layer.device)
    grid, scratch = block_grid_and_scratch(B, last_layer.device, C, N)
    with torch.cuda.device(last_layer.device):
        stream = torch.cuda.current_stream(last_layer.device).cuda_stream
        rc = lib.mmp_survival_head(
            packed.flat.data_ptr(), packed.tensor_core.data_ptr(), tp.data_ptr(),
            last_layer.data_ptr(), mask.data_ptr(), out.data_ptr(), scratch.data_ptr(), grid, B,
            N, dh, packed.n_blocks, n_heads, C, stream,
        )
    _build.check(lib, rc, "mmp_survival_head")
    survival_head.launches += 1
    return out


survival_head.launches = 0
