"""Fused EPiC forward as one hand-written CUDA kernel
(counterpart of multimodal_particles_tpu/ops/epic_pallas.py).

`pack_mbm_encoder_params` resolves weight normalization outside the kernel and
lays every effective weight, (out, in) row-major, into one flat float32 buffer
in the order of `weight_layout` (epic_pallas.py:40-104): the layout of the
weights' gradient that the backward kernel (ops/csrc/epic_backward.cu) writes,
and the one every plain version reads.
The sampling packing is detached; the training packing
(`differentiable=True`) keeps the autograd graph, so that d(flat) chains to
v, g, the biases, the table and the head weights (epic_pallas_vjp.py:15-17).

The forward kernel (K1, ops/csrc/epic_forward.cu) and the sampler step (K2,
ops/csrc/sampler_step.cu) run their per-particle products on the tensor cores
and read another buffer, made from `flat` by `narrow_buffer` (layout
`narrow_buffer_layout`, gathers by `narrow_buffer_plan`): TF32 hi/lo mma
fragments with a permuted k order, local_0's particle part folded with the
embeddings, the per-jet weights transposed, and after them the fragments
of the backward kernel's (K3's) dz·Wᵀ products' transposed weights, which K1
and K2 do not read. Each consumer makes it where it packs and carries it as
`PackedEncoder.tensor_core` (`with_narrow_buffer`): a request's packing
once, the training forward at each step from the non-leaf `flat`, and K3
reads the one K1 read (ops/epic_vjp_cuda.py).

`epic_forward` launches K1 on CUDA tensors; `epic_forward_reference` is its
plain PyTorch version, which the wrapper takes for CPU tensors. With
`output_hidden_local` both also return the trunk's last local hidden state
(B, N, H), which the absorbing family's survival head reads
(epic_pallas.py:291-292, :428-446). The discrete head's hidden width is
a member of the layout (`EpicDims.head_hidden`): the vocabulary's 8 for MBM,
`discrete_head_hidden_dim` for the absorbing generator; only `epic_forward`
takes another width than 8, the other kernels' wrappers refuse it. So is
the Linear-discrete input of the transdimensional trunk
(`EpicDims.fold_discrete`, set by `pack_encoder_params_fold_discrete`,
epic_pallas.py:107-131): the discrete embedding is then a Dense over the
particle's V channel values, its bias has a slot after the table, and
`epic_forward` takes the (B, N, V) float values where it takes the tokens;
again only `epic_forward` takes such a packing (and of the wide kernels,
only the wide forward, ops/epic_wide_cuda.py). The port keeps the JAX
package's (B, N, C) layout: the JAX kernels' (features, B·N) lane layout is
TPU layout, not semantics.
"""

import ctypes
import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from multimodal_particles_tpu_torch.models.architectures.epic import leaky_relu
from multimodal_particles_tpu_torch.models.architectures.utils import (
    embedding_dims,
    sinusoidal_positional_encoding,
)
from multimodal_particles_tpu_torch.ops import _build

# widths the narrow kernels are compiled for (ops/csrc/epic_forward.cuh's DC, V and
# MAX_THREADS; each kernel's instances at hidden 16, 32 and 64)
DIM_C = 3
VOCAB = 8
HIDDEN_WIDTHS = (16, 32, 64)
MAX_PARTICLES = 256  # K1, K2 and K3: one warp per 16 particle slots, at most 16 warps
MAX_HEAD_HIDDEN = 256  # the discrete head widths K1 takes


@dataclasses.dataclass(frozen=True)
class EpicDims:
    hidden: int
    hidden_glob: int
    emb_t: int
    emb_x: int
    emb_k: int
    num_blocks: int
    use_skip: bool
    add_discrete_head: bool
    head_hidden: int = 8  # hidden width of the discrete head's MLP
    fold_discrete: bool = False  # the discrete input is a Dense over the V channel values

    @classmethod
    def from_config(cls, config, head_hidden: int = 8, add_discrete_head=None,
                    fold_discrete: bool = False) -> "EpicDims":
        """`add_discrete_head` None takes the config's; a bare trunk passes False."""
        cfg_e = config.encoder
        emb_t, emb_x, emb_k = embedding_dims(config)
        return cls(
            hidden=cfg_e.dim_hidden_local,
            hidden_glob=cfg_e.dim_hidden_glob,
            emb_t=emb_t,
            emb_x=emb_x,
            emb_k=emb_k,
            num_blocks=cfg_e.num_blocks,
            use_skip=bool(cfg_e.skip_connection),
            add_discrete_head=bool(cfg_e.add_discrete_head if add_discrete_head is None
                                   else add_discrete_head),
            head_hidden=head_hidden,
            fold_discrete=fold_discrete,
        )

    def c_array(self):
        return (ctypes.c_int * 10)(
            self.hidden, self.hidden_glob, self.emb_t, self.emb_x, self.emb_k,
            self.num_blocks, int(self.use_skip), int(self.add_discrete_head),
            self.head_hidden, int(self.fold_discrete),
        )


def weight_layout(d: EpicDims):
    """(name, shape) of every packed weight, in buffer order. Must match
    `make_layout` in ops/csrc/epic_forward.cuh."""
    H, Hg, Et = d.hidden, d.hidden_glob, d.emb_t
    entries = [
        ("w_x", (d.emb_x, DIM_C)), ("b_x", (d.emb_x,)), ("table", (VOCAB, d.emb_k)),
        *([("b_k", (d.emb_k,))] if d.fold_discrete else []),
        ("w_l0", (H, Et + d.emb_x + d.emb_k)), ("b_l0", (H,)),
        ("w_g0", (H, 2 * H + Et)), ("b_g0", (H,)),
        ("w_g1", (H, H)), ("b_g1", (H,)),
        ("w_g2", (Hg, H)), ("b_g2", (Hg,)),
    ]
    for i in range(d.num_blocks):
        entries += [
            (f"w_fg1_{i}", (H, 2 * H + Hg + Et)), (f"b_fg1_{i}", (H,)),
            (f"w_fg2_{i}", (Hg, H)), (f"b_fg2_{i}", (Hg,)),
            (f"w_fl1_{i}", (H, H + Hg + Et)), (f"b_fl1_{i}", (H,)),
            (f"w_fl2_{i}", (H, H)), (f"b_fl2_{i}", (H,)),
        ]
    entries += [
        ("w_out_c", (DIM_C, H)), ("b_out_c", (DIM_C,)),
        ("w_out_d", (VOCAB, H)), ("b_out_d", (VOCAB,)),
        ("w_h0", (d.head_hidden, VOCAB)), ("b_h0", (d.head_hidden,)),
        ("w_h1", (VOCAB, d.head_hidden)), ("b_h1", (VOCAB,)),
    ]
    return entries


def _walk(flat: torch.Tensor, entries):
    """(name, view of its shape) for each (name, shape), in buffer order."""
    off = 0
    for name, shape in entries:
        n = math.prod(shape)
        yield name, flat[off:off + n].view(shape)
        off += n


def flat_views(flat: torch.Tensor, d: EpicDims) -> Dict[str, torch.Tensor]:
    """Named (out, in) views into a flat buffer in weight_layout order."""
    return dict(_walk(flat, weight_layout(d)))


def transposed_in_wide(name: str, shape) -> bool:
    """Matrices flip to (in, out) in the wide layout; the token table is
    (vocab, emb) in both, a matrix that the one-hot tokens multiply from the
    left."""
    return len(shape) == 2 and name != "table"


def wide_weight_layout(d: EpicDims):
    """(name, shape) of every packed weight of the wide kernels, in buffer
    order: the names and order of `weight_layout`, matrices (in, out). Must
    match `make_layout` in ops/csrc/epic_wide.cuh."""
    return [(name, shape[::-1] if transposed_in_wide(name, shape) else shape)
            for name, shape in weight_layout(d)]


def wide_flat_views(flat: torch.Tensor, d: EpicDims) -> Dict[str, torch.Tensor]:
    """Named (out, in) views into a flat buffer in wide_weight_layout order."""
    return {name: view.T if transposed_in_wide(name, view.shape) else view
            for name, view in _walk(flat, wide_weight_layout(d))}


# layout name → (flat, dims) → named (out, in) views
LAYOUT_VIEWS = {"narrow": flat_views, "wide": wide_flat_views}


@dataclasses.dataclass
class PackedEncoder:
    flat: torch.Tensor  # (n,) float32, contiguous, in the layout's order
    tensors: Dict[str, torch.Tensor]  # named (out, in) views into `flat`
    dims: EpicDims
    layout: str = "narrow"  # a key of LAYOUT_VIEWS: which kernels read `flat`
    # a tensor-core kernel's weights, made from `flat` by the consumer that
    # reads them: the wide forward's (stages, tables) by `pack_encoder`
    # (`tensor_core_weights`), the (buffer,) of K1, K2 and K3 by
    # `with_narrow_buffer`
    tensor_core: Optional[Tuple[torch.Tensor, ...]] = dataclasses.field(
        default=None, repr=False, compare=False)

    def rebind(self, flat: torch.Tensor) -> "PackedEncoder":
        """The same weights over another buffer (a leaf copy, another dtype):
        the layout's views over `flat`, the kernel weights kept."""
        return dataclasses.replace(self, flat=flat, tensors=LAYOUT_VIEWS[self.layout](flat, self.dims))


# a stage of the wide forward's tensor-core products: 8 input rows (one
# k-step), in core matrices of 8 output rows × 4 input rows
# (ops/csrc/epic_wide.cuh, TC_STAGE)
STAGE_ROWS = 8


def tf32_round(x):
    """float32 → the nearest TF32 value (10 mantissa bits), ties away from
    zero, as the tensor cores' `cvt.rna.tf32.f32`; inf and NaN pass."""
    bits = x.contiguous().view(torch.int32)
    finite = (bits & 0x7F800000) != 0x7F800000
    return torch.where(finite, (bits + 0x1000) & ~0x1FFF, bits).view(torch.float32)


def tensor_core_stages(w_in_out):
    """(M, K, 128) weights, (in, out), → each one's K/8 stages as the wide
    forward kernel's weight ring holds them, flat, weight after weight: per
    stage the TF32 hi half, then the lo half (w − hi, rounded again), each 16
    output groups × 2 input groups × 8 × 4, input rows contiguous (K-major
    core matrices)."""
    M, K, n_out = w_in_out.shape
    blocks = (w_in_out.reshape(M, K // STAGE_ROWS, 2, 4, n_out // 8, 8)
              .permute(0, 1, 4, 2, 5, 3).reshape(M * K // STAGE_ROWS, -1))
    hi = tf32_round(blocks)
    return torch.stack([hi, tf32_round(blocks - hi)], dim=1).reshape(-1)


# the columns of a wide kernel's block: a jet at local hidden width H is a
# cluster of H / 128 blocks, each owning 128 columns of every activation tile
# (ops/csrc/epic_wide_any.cuh)
BLOCK_COLUMNS = 128


def column_blocks(w):
    """(K, H) → its H / 128 column blocks (K, 128), in order."""
    return [w[:, c0:c0 + BLOCK_COLUMNS] for c0 in range(0, w.shape[1], BLOCK_COLUMNS)]


def tensor_core_weights(flat: torch.Tensor, d: "EpicDims"):
    """The weights the wide forward kernel's tensor-core products read, made
    from a wide-layout buffer (left as it is): (stages, tables). `stages`: per
    EPiC layer the stages of fc_local1's particle third (its first H input
    rows), then fc_local2's, each as its H / 128 column blocks one after the
    other (a block of the jet's cluster streams its own). `tables`: local_0's
    particle two thirds folded with the embeddings, which are Dense layers, so
    that a particle's local_0 input term is x·T_x + (values·T_k, or a token's
    row of T_k) + c: per column block T_x (3, 128), T_k (V, 128), c (128),
    computed in float64. At H = 128 one block's of each."""
    with torch.no_grad():
        views = wide_flat_views(flat.detach(), d)
        weights = [block for i in range(d.num_blocks)
                   for w in (views[f"w_fl1_{i}"][:, :d.hidden].T, views[f"w_fl2_{i}"].T)
                   for block in column_blocks(w)]
        stages = tensor_core_stages(torch.stack(weights)) if weights else flat.new_zeros(4)
        w_l0 = views["w_l0"].double()
        w_x, w_k = w_l0[:, d.emb_t:d.emb_t + d.emb_x].T, w_l0[:, d.emb_t + d.emb_x:].T
        c = views["b_x"].double() @ w_x
        if d.fold_discrete:
            c = c + views["b_k"].double() @ w_k
        t_x = views["w_x"].double().T @ w_x
        t_k = views["table"].double() @ w_k
        tables = torch.cat([torch.cat([bx.reshape(-1), bk.reshape(-1), bc.reshape(-1)])
                            for bx, bk, bc in zip(column_blocks(t_x), column_blocks(t_k),
                                                  column_blocks(c[None]))]).float()
    return stages.contiguous(), tables.contiguous()


# ------------------------------------------- the buffer of K1, K2 and K3


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def _pad8(n: int) -> int:
    return (n + 7) // 8 * 8


def narrow_buffer_layout(d: EpicDims):
    """(name, floats) of every entry of the buffer that K1, K2 and K3 read,
    in order, each padded to a multiple of 4 floats: the per-jet weights (in,
    out), then the per-particle products' mma fragments (2·K·N floats a (K, N)
    product) and biases; the discrete head's width padded to 8-column tiles.
    K3's entries follow (K1 and K2 read the part before them): the fragments
    of the transposed per-particle weights of its dz·Wᵀ products (the output
    layer, every layer's fc_local2 and fc_local1's particle third, the head's
    two layers). Must match `make_tc_layout` and `make_tc_layout_t` in
    ops/csrc/narrow_tc.cuh."""
    H, Hg, Et, Hd = d.hidden, d.hidden_glob, d.emb_t, _pad8(d.head_hidden)
    entries = [("t0", Et * H), ("g0", (2 * H + Et) * H), ("b_g0", H), ("g1", H * H), ("b_g1", H),
               ("g2", H * Hg), ("b_g2", Hg)]
    for i in range(d.num_blocks):
        entries += [(f"fg1_{i}", (2 * H + Hg + Et) * H), (f"b_fg1_{i}", H), (f"fg2_{i}", H * Hg),
                    (f"b_fg2_{i}", Hg), (f"fl1b_{i}", (Hg + Et) * H), (f"b_fl1_{i}", H)]
    entries += [("l0f", 2 * 16 * H), ("b_l0", H)]
    for i in range(d.num_blocks):
        entries += [(f"fl1f_{i}", 2 * H * H), (f"fl2f_{i}", 2 * H * H), (f"b_fl2_{i}", H)]
    entries += [("outf", 2 * H * 16), ("b_out", 16), ("h0f", 2 * VOCAB * Hd), ("b_h0", Hd),
                ("h1f", 2 * Hd * VOCAB), ("b_h1", VOCAB), ("outT", 2 * 16 * H)]
    for i in range(d.num_blocks):
        entries += [(f"fl2T_{i}", 2 * H * H), (f"fl1T_{i}", 2 * H * H)]
    entries += [("h1T", 2 * VOCAB * Hd), ("h0T", 2 * Hd * VOCAB)]
    return [(name, _pad4(n)) for name, n in entries]


@functools.lru_cache(maxsize=None)
def narrow_buffer_size(d: EpicDims) -> int:
    """Floats of the buffer of K1, K2 and K3."""
    return sum(n for _, n in narrow_buffer_layout(d))


@functools.lru_cache(maxsize=None)
def narrow_buffer_plan(d: EpicDims):
    """Where each float of the buffer of K1, K2 and K3 comes from, once a layout: (rows_in, weights_in, index, kind), on the
    CPU. local_0's folded rows (16, H) are rows_in's (16, Ex + Ek) gather from
    [flat ‖ 0] times weights_in's (Ex + Ek, H) gather from flat. The index is
    into [flat ‖ 0 ‖ those rows]; the kind is 0 for a copy, 1 for the TF32 hi
    half of an mma fragment's value, 2 for its lo half. A (K, N) product's
    fragments (K, N multiples of 8), per k-step kk and n-tile j: lane 4g + t
    holds (hi b0, hi b1, lo b0, lo b1) with b0 = W[8kk + 2t, 8j + g] and
    b1 = W[8kk + 2t + 1, 8j + g], W (in, out): the mma's k positions t and
    t + 4 take the inputs 2t and 2t + 1, the two columns a thread holds of
    the product before (ops/csrc/narrow_tc.cuh). K3's transposed weights are
    the flat (out, in) matrices read as (in, out) ones: dz·Wᵀ."""
    n = sum(math.prod(shape) for _, shape in weight_layout(d))
    H, Et, Ex, Ek, Hd = d.hidden, d.emb_t, d.emb_x, d.emb_k, d.head_hidden
    zero = n
    W = flat_views(torch.arange(n, dtype=torch.float64), d)
    rows = (n + 1 + torch.arange(16 * H, dtype=torch.float64)).reshape(16, H)

    def padded(w, shape):
        """w in the top left of a `shape` matrix of the zero's index."""
        out = torch.full(shape, float(zero), dtype=torch.float64)
        out[:w.shape[0], :w.shape[1]] = w
        return out

    # rows_in: x's three columns of the x embedding (w_x (Ex, 3), transposed),
    # the biases through local_0 (b_x, and with the folded input b_k), four
    # zero rows, the token table (V, Ek) or the folded Dense's transpose
    rows_in = torch.full((16, Ex + Ek), float(zero), dtype=torch.float64)
    rows_in[:3, :Ex] = W["w_x"].T
    rows_in[3, :Ex] = W["b_x"]
    if d.fold_discrete:
        rows_in[3, Ex:] = W["b_k"]
    rows_in[8:, Ex:] = W["table"]
    weights_in = W["w_l0"][:, Et:].T  # (Ex + Ek, H)

    out = padded(torch.cat([W["w_out_d"].T, W["w_out_c"].T], dim=1), (H, 16))
    b_out = padded(torch.cat([W["b_out_d"], W["b_out_c"]])[None], (1, 16))[0]

    def copy(w):
        w = w.reshape(-1)
        return w, torch.zeros(w.numel(), dtype=torch.uint8)

    def fragments(w):
        K, N = w.shape
        p = w.reshape(K // 8, 4, 2, N // 8, 8).permute(0, 3, 4, 1, 2)  # [kk, j, g, t, e]
        index = torch.stack([p[..., 0], p[..., 1], p[..., 0], p[..., 1]], dim=-1).reshape(-1)
        return index, torch.tensor([1, 1, 2, 2], dtype=torch.uint8).repeat(index.numel() // 4)

    src = {"t0": copy(W["w_l0"][:, :Et].T), "g0": copy(W["w_g0"].T), "b_g0": copy(W["b_g0"]),
           "g1": copy(W["w_g1"].T), "b_g1": copy(W["b_g1"]), "g2": copy(W["w_g2"].T),
           "b_g2": copy(W["b_g2"]), "l0f": fragments(rows), "b_l0": copy(W["b_l0"]),
           "outf": fragments(out), "b_out": copy(b_out),
           "h0f": fragments(padded(W["w_h0"].T, (VOCAB, _pad8(Hd)))), "b_h0": copy(W["b_h0"]),
           "h1f": fragments(padded(W["w_h1"].T, (_pad8(Hd), VOCAB))), "b_h1": copy(W["b_h1"]),
           "outT": fragments(out.T.contiguous()),
           "h1T": fragments(padded(W["w_h1"], (VOCAB, _pad8(Hd)))),
           "h0T": fragments(padded(W["w_h0"], (_pad8(Hd), VOCAB)))}
    for i in range(d.num_blocks):
        w_fl1 = W[f"w_fl1_{i}"]
        src.update({f"fg1_{i}": copy(W[f"w_fg1_{i}"].T), f"b_fg1_{i}": copy(W[f"b_fg1_{i}"]),
                    f"fg2_{i}": copy(W[f"w_fg2_{i}"].T), f"b_fg2_{i}": copy(W[f"b_fg2_{i}"]),
                    f"fl1b_{i}": copy(w_fl1[:, H:].T), f"b_fl1_{i}": copy(W[f"b_fl1_{i}"]),
                    f"fl1f_{i}": fragments(w_fl1[:, :H].T),
                    f"fl2f_{i}": fragments(W[f"w_fl2_{i}"].T), f"b_fl2_{i}": copy(W[f"b_fl2_{i}"]),
                    f"fl2T_{i}": fragments(W[f"w_fl2_{i}"]),
                    f"fl1T_{i}": fragments(w_fl1[:, :H].contiguous())})
    index, kind = [], []
    for name, size in narrow_buffer_layout(d):
        i, k = src[name]
        index += [i, torch.full((size - i.numel(),), float(zero), dtype=torch.float64)]
        kind += [k, torch.zeros(size - k.numel(), dtype=torch.uint8)]
    return (rows_in.reshape(-1).long(), weights_in.reshape(-1).long(), torch.cat(index).long(),
            torch.cat(kind))


@functools.lru_cache(maxsize=None)
def _narrow_plan_on(d: EpicDims, device: torch.device):
    """The plan on `device`: the three gathers' indices, and the kinds as
    the two masks the buffer's last step takes."""
    rows_in, weights_in, index, kind = narrow_buffer_plan(d)
    return (rows_in.to(device), weights_in.to(device), index.to(device),
            (kind == 0).to(device), (kind == 1).to(device))


def narrow_buffer(flat: torch.Tensor, d: EpicDims) -> torch.Tensor:
    """The buffer of K1, K2 and K3 (`narrow_buffer_layout`,
    `narrow_buffer_plan`), made
    from a narrow-layout buffer (left as it is, and detached) on its device by
    three gathers and one product: a small request is bound by the host, and
    the training forward makes it at every step. local_0's particle two
    thirds are folded with the embeddings (Dense layers): the product of [x,
    1, 0, 0, 0, 0, onehot(k) or the channel values] with the 16 rows [T_x; c;
    0; T_k], computed in float64, gives them (c: the embeddings' biases
    through local_0). The output layer's 16 columns are the discrete
    pre-logits, then the three continuous outputs and five zero columns. A
    fragment's hi half is the nearest TF32 value, its lo half the rest
    rounded again."""
    with torch.no_grad():
        rows_in, weights_in, index, copied, high = _narrow_plan_on(d, flat.device)
        ext = torch.cat([flat.detach().float(), flat.new_zeros(1, dtype=torch.float32)])
        rows = ext[rows_in].view(16, -1).double() @ ext[weights_in].view(-1, d.hidden).double()
        value = torch.cat([ext, rows.float().view(-1)])[index]
        hi = tf32_round(value)
        return torch.where(copied, value, torch.where(high, hi, tf32_round(value - hi)))


def with_narrow_buffer(packed: "PackedEncoder") -> "PackedEncoder":
    """`packed` (the narrow layout) carrying the buffer of K1, K2 and K3 as
    its `tensor_core`: what `epic_forward`, the sampler step and
    `epic_backward` read on the card."""
    return dataclasses.replace(packed, tensor_core=(narrow_buffer(packed.flat, packed.dims),))


def effective_weights(encoder, d: EpicDims, head=None) -> Dict[str, torch.Tensor]:
    """A module with an `epic` trunk (EPiCWrapper) → every weight of
    `weight_layout` by name, weight normalization resolved, matrices (out, in)
    (epic_pallas.py:47-104). `head` is the discrete head's Linear-SELU-Linear
    (default: MultiModalEPiC's `fc_layer`). Without the discrete head,
    w_h0/w_h1 are identity placeholders that the kernels do not read."""
    emb = encoder.epic.embedding
    net = encoder.epic.epic
    proj = net.epic_proj
    src = {"w_x": emb.embedding_continuous.weight, "b_x": emb.embedding_continuous.bias}
    if d.fold_discrete:  # a Linear (emb_k, V): its transpose has the table's shape
        src.update(table=emb.embedding_discrete.weight.T, b_k=emb.embedding_discrete.bias)
    else:
        src["table"] = emb.embedding_discrete.weight
    for name, layer in (("l0", proj.local_0), ("g0", proj.global_0),
                        ("g1", proj.global_1), ("g2", proj.global_2)):
        src[f"w_{name}"], src[f"b_{name}"] = layer.effective_weight(), layer.bias
    for i in range(d.num_blocks):
        layer = getattr(net, f"epic_layer_{i}")
        for name in ("fg1", "fg2", "fl1", "fl2"):
            wn = getattr(layer, {"fg1": "fc_global1", "fg2": "fc_global2",
                                 "fl1": "fc_local1", "fl2": "fc_local2"}[name])
            src[f"w_{name}_{i}"], src[f"b_{name}_{i}"] = wn.effective_weight(), wn.bias
    w_out, b_out = net.output_layer.effective_weight(), net.output_layer.bias
    src.update(w_out_c=w_out[:DIM_C], b_out_c=b_out[:DIM_C],
               w_out_d=w_out[DIM_C:], b_out_d=b_out[DIM_C:])
    if d.add_discrete_head:
        head = encoder.fc_layer if head is None else head
        fc0, fc1 = head[0], head[2]
        src.update(w_h0=fc0.weight, b_h0=fc0.bias, w_h1=fc1.weight, b_h1=fc1.bias)
    else:
        eye = torch.eye(VOCAB, device=w_out.device)
        zero = torch.zeros(VOCAB, device=w_out.device)
        src.update(w_h0=eye, b_h0=zero, w_h1=eye, b_h1=zero)
    for name, shape in weight_layout(d):
        if tuple(src[name].shape) != shape:
            raise ValueError(f"packed weight {name}: shape {tuple(src[name].shape)} != {shape}")
    return src


def pack_encoder(encoder, d: EpicDims, layout: str = "narrow", differentiable: bool = False,
                 head=None) -> PackedEncoder:
    """A module with an `epic` trunk → flat buffer of effective weights in
    `layout`'s order: matrices (out, in) for the narrow kernels, (in, out)
    for the wide ones (`wide_weight_layout`), whose forward kernel also gets
    its tensor-core weights here, once a packing (a request's sampler steps
    and a train step's forward reuse them). With `differentiable`, `flat`
    is a non-leaf of the autograd graph."""
    transpose = layout == "wide"
    with torch.set_grad_enabled(differentiable and torch.is_grad_enabled()):
        src = effective_weights(encoder, d, head)
        flat = torch.cat([
            (src[name].T if transpose and transposed_in_wide(name, shape) else src[name])
            .reshape(-1).float()
            for name, shape in weight_layout(d)
        ])
    tensor_core = tensor_core_weights(flat, d) if layout == "wide" else None
    return PackedEncoder(flat, LAYOUT_VIEWS[layout](flat, d), d, layout, tensor_core)


def head_width(head) -> int:
    """The hidden width of a discrete head (Linear-SELU-Linear), or the
    vocabulary's for the module's own `fc_layer`."""
    return VOCAB if head is None else head[0].out_features


def pack_mbm_encoder_params(encoder, config, differentiable: bool = False,
                            head=None) -> PackedEncoder:
    """A module with an `epic` trunk → flat buffer of effective weights,
    (out, in) row-major, for the narrow kernels. `head` replaces the module's
    `fc_layer` as the discrete head (the absorbing generator passes its
    `discrete_head_mlp`, epic_pallas.py:90-93); its hidden width enters the
    layout. With `differentiable`, `flat` is a non-leaf of the autograd graph."""
    d = EpicDims.from_config(config, head_hidden=head_width(head))
    return pack_encoder(encoder, d, "narrow", differentiable, head)


def pack_bare_trunk_params(encoder, config, fold_discrete: bool,
                           layout: str = "narrow") -> PackedEncoder:
    """A module with a bare `epic` trunk → flat buffer for the forward kernel
    of `layout` (K1 narrow, K4 wide), detached. The trunk has no discrete
    head of its own, whatever `config.encoder.add_discrete_head` says: the
    transdimensional network reads the trunk's 11 outputs as they are
    (transdimensional_model.py:413). With `fold_discrete` the discrete
    embedding is a Linear over the V channel values (epic_pallas.py:107-131,
    epic_pallas_wide.py:72-80), else a token's table row."""
    d = EpicDims.from_config(config, add_discrete_head=False, fold_discrete=fold_discrete)
    return pack_encoder(encoder, d, layout)


def pack_encoder_params_fold_discrete(encoder, config) -> PackedEncoder:
    """`pack_bare_trunk_params` with the folded Linear-discrete input."""
    return pack_bare_trunk_params(encoder, config, fold_discrete=True)


def epic_pattern_supported(config, allow_linear_discrete: bool = False) -> bool:
    """The encoder pattern both kernel families are written for
    (epic_pallas.py:450-471): sinusoidal time embedding, Linear continuous and
    Embedding discrete inputs (with `allow_linear_discrete` also the Linear
    discrete input, which only the narrow forward kernel takes), no context,
    3 continuous features, vocab 8, and no tensor-parallel 'model' axis
    (epic_pallas.py:489-493)."""
    e, d = config.encoder, config.data
    discrete = ("Embedding", "Linear") if allow_linear_discrete else ("Embedding",)
    return (
        config.parallel.model_axis <= 1
        and e.embedding_time == "SinusoidalPositionalEncoding"
        and e.embedding_features_continuous == "Linear"
        and e.embedding_features_discrete in discrete
        and d.dim_context_continuous == 0
        and d.dim_context_discrete == 0
        and d.dim_features_discrete == 1
        and d.dim_features_continuous == DIM_C
        and d.vocab_size_features == VOCAB
    )


def epic_supported(config, allow_linear_discrete: bool = False) -> bool:
    """True when the encoder matches what the narrow kernels are compiled for
    (epic_pallas.py:474-494, without the TPU-only N % 128 condition)."""
    return (
        epic_pattern_supported(config, allow_linear_discrete)
        and config.encoder.dim_hidden_local in HIDDEN_WIDTHS
        and 1 <= config.data.max_num_particles <= MAX_PARTICLES
    )


# ------------------------------------------------------------ plain version


class _SELU(torch.autograd.Function):
    """SELU whose derivative at exactly 0 is the right-hand one, `scale`, as
    in the JAX backward kernel's `_dselu` (epic_pallas_vjp.py:72-75) and in
    ops/csrc/epic_backward.cu."""

    ALPHA = 1.6732632423543772
    SCALE = 1.0507009873554805

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.selu(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        slope = torch.where(x >= 0, 1.0, _SELU.ALPHA * torch.exp(x))
        return grad * _SELU.SCALE * slope


def forward_from_temb(packed: PackedEncoder, temb, x, k, mask, preacts=None,
                      return_hidden: bool = False):
    """The EPiC forward on packed weights in (B, N, C) layout, from the
    per-jet time embedding temb (B, E_t): the math of `_forward_acts`
    (epic_pallas.py:183-272). k is the (B, N, 1) tokens, or with a folded
    packing the (B, N, V) channel values. Returns (cont (B,N,3), logits (B,N,8)), and
    with `return_hidden` also the last block's local state h (B,N,H).
    A list `preacts` receives (name, tensor) for the input of every leaky
    and SELU: per particle (B, N, F) or per jet (B, F)."""
    W, d = packed.tensors, packed.dims

    def act(name, z, fn=leaky_relu):
        if preacts is not None:
            preacts.append((name, z.detach()))
        return fn(z)

    B, N = x.shape[0], x.shape[1]
    denom = torch.clamp(mask.sum(dim=1), min=1.0)  # (B, 1)
    ctx = temb  # per-jet context = time embedding

    x_emb = x @ W["w_x"].T + W["b_x"]
    if d.fold_discrete:
        k_emb = k.to(x.dtype) @ W["table"] + W["b_k"]
    else:
        one_hot = (k.reshape(B, N, 1).long() == torch.arange(VOCAB, device=x.device)).to(x.dtype)
        k_emb = one_hot @ W["table"]
    t_local = temb[:, None, :].expand(B, N, d.emb_t)
    feats = torch.cat([t_local, x_emb, k_emb], dim=-1) * mask

    h_act = act("z_l0", feats @ W["w_l0"].T + W["b_l0"])
    s0 = (h_act * mask).sum(dim=1)
    p0 = torch.cat([s0 / denom, s0, ctx], dim=-1)
    g = act("z_g0", p0 @ W["w_g0"].T + W["b_g0"])
    g = act("z_g1", g @ W["w_g1"].T + W["b_g1"])
    g = act("z_g2", g @ W["w_g2"].T + W["b_g2"])
    h = h_act * mask
    skip_local = h if d.use_skip else 0.0
    skip_global = g if d.use_skip else 0.0

    for i in range(d.num_blocks):
        s = (h * mask).sum(dim=1)
        p = torch.cat([s / denom, s, g, ctx], dim=-1)
        g1 = act("z_fg1", p @ W[f"w_fg1_{i}"].T + W[f"b_fg1_{i}"])
        g_new = act("z_fg2", g1 @ W[f"w_fg2_{i}"].T + W[f"b_fg2_{i}"] + g)
        hcat = torch.cat(
            [h, g_new[:, None, :].expand(B, N, d.hidden_glob),
             ctx[:, None, :].expand(B, N, d.emb_t)], dim=-1,
        )
        l1 = act("z_fl1", hcat @ W[f"w_fl1_{i}"].T + W[f"b_fl1_{i}"])
        h_new = act("z_fl2", l1 @ W[f"w_fl2_{i}"].T + W[f"b_fl2_{i}"] + h)
        h = h_new * mask + skip_local
        g = g_new + skip_global

    cont = (h @ W["w_out_c"].T + W["b_out_c"]) * mask
    disc = (h @ W["w_out_d"].T + W["b_out_d"]) * mask
    if d.add_discrete_head:
        disc = act("z_h0", disc @ W["w_h0"].T + W["b_h0"], _SELU.apply) @ W["w_h1"].T + W["b_h1"]
    if return_hidden:
        return cont, disc, h
    return cont, disc


def epic_forward_reference(packed: PackedEncoder, t, x, k, mask, output_hidden_local=False):
    """Plain PyTorch version of the kernel: (B, N, 3 + 8) head outputs
    (continuous ‖ discrete logits); with `output_hidden_local` also the
    trunk's last local hidden state (B, N, H)."""
    epic_forward_reference.calls += 1
    temb = sinusoidal_positional_encoding(t.reshape(x.shape[0]), packed.dims.emb_t)
    cont, disc, h = forward_from_temb(packed, temb, x.float(), k, mask.float(),
                                      return_hidden=True)
    out = torch.cat([cont, disc], dim=-1)
    return (out, h) if output_hidden_local else out


epic_forward_reference.calls = 0


# ------------------------------------------------------------ kernel wrapper


def check_head_width(packed: PackedEncoder, kernel: str):
    """Every kernel but the two forward kernels (K1, K4) is written for a
    discrete head as wide as the vocabulary and for tokens as the discrete
    input; another head width or the folded Linear-discrete input shifts the
    packed buffer under it."""
    if packed.dims.head_hidden != VOCAB:
        raise ValueError(
            f"{kernel} takes a discrete head of hidden width {VOCAB}, "
            f"got {packed.dims.head_hidden}"
        )
    if packed.dims.fold_discrete:
        raise ValueError(f"{kernel} takes tokens, not a packing with the folded discrete input")


def check_narrow_packing(packed: PackedEncoder, any_head_width: bool = False):
    """The narrow kernels take their own layout at the widths they are
    compiled for; only the forward kernel (`any_head_width`) takes a discrete
    head of another hidden width than the vocabulary's, or the folded
    Linear-discrete input."""
    if packed.layout != "narrow":
        raise ValueError("the narrow kernels read the pack_mbm_encoder_params layout")
    if packed.dims.hidden not in HIDDEN_WIDTHS:
        raise ValueError(f"hidden width {packed.dims.hidden} not in {HIDDEN_WIDTHS}")
    if any_head_width:
        if not 1 <= packed.dims.head_hidden <= MAX_HEAD_HIDDEN:
            raise ValueError(f"head width {packed.dims.head_hidden} outside [1, {MAX_HEAD_HIDDEN}]")
    else:
        check_head_width(packed, "this kernel")


def check_kernel_inputs(packed: PackedEncoder, x, k, mask, max_particles=MAX_PARTICLES, **others):
    """Device, dtype, shape and contiguity checks shared by every wrapper;
    each wrapper checks its own widths."""
    if x.dim() != 3 or x.shape[2] != DIM_C:
        raise ValueError(f"x must be (B, N, {DIM_C}), got {tuple(x.shape)}")
    B, N = x.shape[0], x.shape[1]
    if not 1 <= N <= max_particles:
        raise ValueError(f"N={N} outside [1, {max_particles}]")
    fold = packed.dims.fold_discrete
    k_shape = (B, N, VOCAB) if fold else (B, N, 1)
    if tuple(k.shape) != k_shape or tuple(mask.shape) != (B, N, 1):
        raise ValueError(f"k must be {k_shape} and mask (B, N, 1), got {tuple(k.shape)}, "
                         f"{tuple(mask.shape)}")
    if not fold and (k.dtype.is_floating_point or k.dtype.is_complex):
        raise TypeError(f"k must be an integer tensor, got {k.dtype}")
    tensors = dict(x=x, k=k, mask=mask, weights=packed.flat, **others)
    for name, tensor in tensors.items():
        if tensor.device != x.device:
            raise ValueError(f"{name} is on {tensor.device}, x on {x.device}")
        if (name != "k" or fold) and tensor.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {tensor.dtype}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, N


def epic_forward(packed: PackedEncoder, t, x, k, mask, output_hidden_local=False):
    """Fused EPiC forward. t (B,1,1), x (B,N,3), k (B,N,1) int (with a folded
    packing the (B,N,8) float channel values), mask (B,N,1) → (B, N, 3 + 8)
    float32; with `output_hidden_local` also the trunk's last local hidden
    state (B, N, H), written by the same launch. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise. The kernel reads the
    packing's first `tensor_core` buffer (`with_narrow_buffer`)."""
    if x.device.type == "cpu":
        return epic_forward_reference(packed, t, x, k, mask, output_hidden_local)
    check_narrow_packing(packed, any_head_width=True)
    buffers = {} if packed.tensor_core is None else {"tensor_core": packed.tensor_core[0]}
    B, N = check_kernel_inputs(packed, x, k, mask, t=t, **buffers)
    if packed.tensor_core is None:
        raise ValueError("the forward kernel reads the tensor-core buffer that "
                         "with_narrow_buffer adds to the packing")
    buffer = packed.tensor_core[0]
    if t.numel() != B:
        raise ValueError(f"t must hold one time per jet, got {tuple(t.shape)}")
    if buffer.numel() != narrow_buffer_size(packed.dims):
        raise ValueError(f"the forward kernel's buffer holds {narrow_buffer_size(packed.dims)} "
                         f"floats at {packed.dims}, got {buffer.numel()}")
    k32 = k if packed.dims.fold_discrete else k.to(torch.int32).contiguous()
    if k32.data_ptr() % 8 and packed.dims.fold_discrete:
        raise ValueError("the channel values must be 8-byte aligned")
    out = torch.empty((B, N, DIM_C + VOCAB), dtype=torch.float32, device=x.device)
    hidden = (torch.empty((B, N, packed.dims.hidden), dtype=torch.float32, device=x.device)
              if output_hidden_local else None)
    lib = _build.load_library()
    # the folded instantiation has an entry point (and a source) of its own
    entry = lib.mmp_epic_forward_fold if packed.dims.fold_discrete else lib.mmp_epic_forward
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = entry(
            buffer.data_ptr(), t.data_ptr(), x.data_ptr(), k32.data_ptr(),
            mask.data_ptr(), out.data_ptr(),
            hidden.data_ptr() if output_hidden_local else None,
            B, N, packed.dims.c_array(), stream,
        )
    _build.check(lib, rc, "mmp_epic_forward")
    epic_forward.launches += 1
    return (out, hidden) if output_hidden_local else out


epic_forward.launches = 0
