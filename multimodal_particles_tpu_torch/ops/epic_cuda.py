"""Fused EPiC forward as one hand-written CUDA kernel
(counterpart of multimodal_particles_tpu/ops/epic_pallas.py).

`pack_mbm_encoder_params` resolves weight normalization outside the kernel and
lays every effective weight, (out, in) row-major, into one flat float32 buffer
in the order that ops/csrc/epic_forward.cuh reads it (epic_pallas.py:40-104).
`epic_forward` launches ops/csrc/epic_forward.cu on CUDA tensors;
`epic_forward_reference` is its plain PyTorch version, which the wrapper takes
for CPU tensors. The port keeps the JAX package's (B, N, C) layout: the JAX
kernels' (features, B·N) lane layout is TPU layout, not semantics.
"""

import ctypes
import dataclasses
import math
from typing import Dict

import torch
import torch.nn.functional as F

from multimodal_particles_tpu_torch.models.architectures.epic import leaky_relu
from multimodal_particles_tpu_torch.models.architectures.utils import (
    embedding_dims,
    sinusoidal_positional_encoding,
)
from multimodal_particles_tpu_torch.ops import _build

# widths the kernels are compiled for (ops/csrc/epic_forward.cuh)
DIM_C = 3
VOCAB = 8
HIDDEN_WIDTHS = (16, 32, 64)
MAX_PARTICLES = 256  # one thread per particle slot, one block per jet


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

    @classmethod
    def from_config(cls, config) -> "EpicDims":
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
            add_discrete_head=bool(cfg_e.add_discrete_head),
        )

    def c_array(self):
        return (ctypes.c_int * 8)(
            self.hidden, self.hidden_glob, self.emb_t, self.emb_x, self.emb_k,
            self.num_blocks, int(self.use_skip), int(self.add_discrete_head),
        )


def weight_layout(d: EpicDims):
    """(name, shape) of every packed weight, in buffer order. Must match
    `make_layout` in ops/csrc/epic_forward.cuh."""
    H, Hg, Et = d.hidden, d.hidden_glob, d.emb_t
    entries = [
        ("w_x", (d.emb_x, DIM_C)), ("b_x", (d.emb_x,)), ("table", (VOCAB, d.emb_k)),
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
        ("w_h0", (VOCAB, VOCAB)), ("b_h0", (VOCAB,)),
        ("w_h1", (VOCAB, VOCAB)), ("b_h1", (VOCAB,)),
    ]
    return entries


@dataclasses.dataclass
class PackedEncoder:
    flat: torch.Tensor  # (n,) float32, contiguous, in weight_layout order
    tensors: Dict[str, torch.Tensor]  # named views into `flat`
    dims: EpicDims


def pack_mbm_encoder_params(encoder, config) -> PackedEncoder:
    """MultiModalEPiC module → flat buffer of effective weights
    (epic_pallas.py:47-104). Without the discrete head, w_h0/w_h1 are
    identity placeholders that the kernel does not read."""
    d = EpicDims.from_config(config)
    emb = encoder.epic.embedding
    net = encoder.epic.epic
    proj = net.epic_proj
    src = {
        "w_x": emb.embedding_continuous.weight, "b_x": emb.embedding_continuous.bias,
        "table": emb.embedding_discrete.weight,
    }
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
        fc0, fc1 = encoder.fc_layer[0], encoder.fc_layer[2]
        src.update(w_h0=fc0.weight, b_h0=fc0.bias, w_h1=fc1.weight, b_h1=fc1.bias)
    else:
        eye = torch.eye(VOCAB, device=w_out.device)
        zero = torch.zeros(VOCAB, device=w_out.device)
        src.update(w_h0=eye, b_h0=zero, w_h1=eye, b_h1=zero)

    layout = weight_layout(d)
    with torch.no_grad():
        for name, shape in layout:
            if tuple(src[name].shape) != shape:
                raise ValueError(f"packed weight {name}: shape {tuple(src[name].shape)} != {shape}")
        flat = torch.cat([src[name].detach().reshape(-1).float() for name, _ in layout])
    tensors, off = {}, 0
    for name, shape in layout:
        n = math.prod(shape)
        tensors[name] = flat[off:off + n].view(shape)
        off += n
    return PackedEncoder(flat, tensors, d)


def epic_supported(config) -> bool:
    """True when the encoder matches what the kernels are compiled for
    (epic_pallas.py:450-494, without the TPU-only N % 128 condition)."""
    e, d = config.encoder, config.data
    return (
        e.embedding_time == "SinusoidalPositionalEncoding"
        and e.embedding_features_continuous == "Linear"
        and e.embedding_features_discrete == "Embedding"
        and d.dim_context_continuous == 0
        and d.dim_context_discrete == 0
        and d.dim_features_discrete == 1
        and d.dim_features_continuous == DIM_C
        and d.vocab_size_features == VOCAB
        and e.dim_hidden_local in HIDDEN_WIDTHS
        and 1 <= d.max_num_particles <= MAX_PARTICLES
    )


# ------------------------------------------------------------ plain version


def forward_from_temb(packed: PackedEncoder, temb, x, k, mask):
    """The EPiC forward on packed weights in (B, N, C) layout, from the
    per-jet time embedding temb (B, E_t): the math of `_forward_acts`
    (epic_pallas.py:183-272). Returns (cont (B,N,3), logits (B,N,8))."""
    W, d = packed.tensors, packed.dims
    B, N = x.shape[0], x.shape[1]
    denom = torch.clamp(mask.sum(dim=1), min=1.0)  # (B, 1)
    ctx = temb  # per-jet context = time embedding

    x_emb = x @ W["w_x"].T + W["b_x"]
    one_hot = (k.reshape(B, N, 1).long() == torch.arange(VOCAB, device=x.device)).to(x.dtype)
    k_emb = one_hot @ W["table"]
    t_local = temb[:, None, :].expand(B, N, d.emb_t)
    feats = torch.cat([t_local, x_emb, k_emb], dim=-1) * mask

    h_act = leaky_relu(feats @ W["w_l0"].T + W["b_l0"])
    s0 = (h_act * mask).sum(dim=1)
    p0 = torch.cat([s0 / denom, s0, ctx], dim=-1)
    g = leaky_relu(p0 @ W["w_g0"].T + W["b_g0"])
    g = leaky_relu(g @ W["w_g1"].T + W["b_g1"])
    g = leaky_relu(g @ W["w_g2"].T + W["b_g2"])
    h = h_act * mask
    skip_local = h if d.use_skip else 0.0
    skip_global = g if d.use_skip else 0.0

    for i in range(d.num_blocks):
        s = (h * mask).sum(dim=1)
        p = torch.cat([s / denom, s, g, ctx], dim=-1)
        g1 = leaky_relu(p @ W[f"w_fg1_{i}"].T + W[f"b_fg1_{i}"])
        g_new = leaky_relu(g1 @ W[f"w_fg2_{i}"].T + W[f"b_fg2_{i}"] + g)
        hcat = torch.cat(
            [h, g_new[:, None, :].expand(B, N, d.hidden_glob),
             ctx[:, None, :].expand(B, N, d.emb_t)], dim=-1,
        )
        l1 = leaky_relu(hcat @ W[f"w_fl1_{i}"].T + W[f"b_fl1_{i}"])
        h_new = leaky_relu(l1 @ W[f"w_fl2_{i}"].T + W[f"b_fl2_{i}"] + h)
        h = h_new * mask + skip_local
        g = g_new + skip_global

    cont = (h @ W["w_out_c"].T + W["b_out_c"]) * mask
    disc = (h @ W["w_out_d"].T + W["b_out_d"]) * mask
    if d.add_discrete_head:
        disc = F.selu(disc @ W["w_h0"].T + W["b_h0"]) @ W["w_h1"].T + W["b_h1"]
    return cont, disc


def epic_forward_reference(packed: PackedEncoder, t, x, k, mask):
    """Plain PyTorch version of the kernel: (B, N, 3 + 8) head outputs
    (continuous ‖ discrete logits)."""
    epic_forward_reference.calls += 1
    temb = sinusoidal_positional_encoding(t.reshape(x.shape[0]), packed.dims.emb_t)
    cont, disc = forward_from_temb(packed, temb, x.float(), k, mask.float())
    return torch.cat([cont, disc], dim=-1)


epic_forward_reference.calls = 0


# ------------------------------------------------------------ kernel wrapper


def check_kernel_inputs(packed: PackedEncoder, x, k, mask, **others):
    """Device, dtype, shape and contiguity checks shared by both wrappers."""
    if packed.dims.hidden not in HIDDEN_WIDTHS:
        raise ValueError(f"hidden width {packed.dims.hidden} not in {HIDDEN_WIDTHS}")
    if x.dim() != 3 or x.shape[2] != DIM_C:
        raise ValueError(f"x must be (B, N, {DIM_C}), got {tuple(x.shape)}")
    B, N = x.shape[0], x.shape[1]
    if not 1 <= N <= MAX_PARTICLES:
        raise ValueError(f"N={N} outside [1, {MAX_PARTICLES}]")
    if tuple(k.shape) != (B, N, 1) or tuple(mask.shape) != (B, N, 1):
        raise ValueError(f"k and mask must be (B, N, 1), got {tuple(k.shape)}, {tuple(mask.shape)}")
    if k.dtype.is_floating_point or k.dtype.is_complex:
        raise TypeError(f"k must be an integer tensor, got {k.dtype}")
    tensors = dict(x=x, k=k, mask=mask, weights=packed.flat, **others)
    for name, tensor in tensors.items():
        if tensor.device != x.device:
            raise ValueError(f"{name} is on {tensor.device}, x on {x.device}")
        if name != "k" and tensor.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {tensor.dtype}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, N


def epic_forward(packed: PackedEncoder, t, x, k, mask):
    """Fused EPiC forward. t (B,1,1), x (B,N,3), k (B,N,1) int, mask (B,N,1)
    → (B, N, 3 + 8) float32. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if x.device.type == "cpu":
        return epic_forward_reference(packed, t, x, k, mask)
    B, N = check_kernel_inputs(packed, x, k, mask, t=t)
    if t.numel() != B:
        raise ValueError(f"t must hold one time per jet, got {tuple(t.shape)}")
    k32 = k.to(torch.int32).contiguous()
    out = torch.empty((B, N, DIM_C + VOCAB), dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mmp_epic_forward(
            packed.flat.data_ptr(), t.data_ptr(), x.data_ptr(), k32.data_ptr(),
            mask.data_ptr(), out.data_ptr(), B, N, packed.dims.c_array(), stream,
        )
    _build.check(lib, rc, "mmp_epic_forward")
    epic_forward.launches += 1
    return out


epic_forward.launches = 0
