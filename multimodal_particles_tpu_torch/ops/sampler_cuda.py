"""Fully-fused MBM sampler step as one hand-written CUDA kernel
(counterpart of multimodal_particles_tpu/ops/sampler_pallas.py).

One launch per step runs: time embedding from the scalar t → EPiC forward →
Euler update x ← (x + Δt·cont)·mask → telegraph single-jump token update
(sampler_pallas.py:54-101). The kernel runs the per-particle products on the
tensor cores (ops/csrc/sampler_step.cu) and reads only its own buffer
(`sampler_weights`), which `pack_sampler_params` makes once a packing and
the packing carries (`PackedEncoder.tensor_core`). The uniforms come in as a
(2, B, N) float32 tensor drawn from the caller's generator, so the kernel and
its plain version consume identical random numbers.
"""

import dataclasses
import functools
import math

import torch

from multimodal_particles_tpu_torch.models.architectures.utils import (
    sinusoidal_positional_encoding,
)
from multimodal_particles_tpu_torch.models.generative.bridges import (
    telegraph_fused_solver_step,
)
from multimodal_particles_tpu_torch.models.generative.states import HybridState
from multimodal_particles_tpu_torch.ops import _build
from multimodal_particles_tpu_torch.ops.epic_cuda import (
    DIM_C,
    VOCAB,
    EpicDims,
    PackedEncoder,
    check_kernel_inputs,
    check_narrow_packing,
    flat_views,
    forward_from_temb,
    pack_mbm_encoder_params,
    tf32_round,
    weight_layout,
)


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def sampler_layout(d: EpicDims):
    """(name, floats) of every entry of the sampler step kernel's buffer, in
    order, each padded to a multiple of 4 floats: the per-jet weights (in,
    out), then the per-particle products' mma fragments (2·K·N floats a (K, N)
    product) and biases. Must match `make_sampler_layout` in
    ops/csrc/sampler_step.cu."""
    H, Hg, Et = d.hidden, d.hidden_glob, d.emb_t
    entries = [("t0", Et * H), ("g0", (2 * H + Et) * H), ("b_g0", H), ("g1", H * H), ("b_g1", H),
               ("g2", H * Hg), ("b_g2", Hg)]
    for i in range(d.num_blocks):
        entries += [(f"fg1_{i}", (2 * H + Hg + Et) * H), (f"b_fg1_{i}", H), (f"fg2_{i}", H * Hg),
                    (f"b_fg2_{i}", Hg), (f"fl1b_{i}", (Hg + Et) * H), (f"b_fl1_{i}", H)]
    entries += [("l0f", 2 * 16 * H), ("b_l0", H)]
    for i in range(d.num_blocks):
        entries += [(f"fl1f_{i}", 2 * H * H), (f"fl2f_{i}", 2 * H * H), (f"b_fl2_{i}", H)]
    entries += [("outf", 2 * H * 16), ("b_out", 16), ("h0f", 2 * VOCAB * VOCAB), ("b_h0", VOCAB),
                ("h1f", 2 * VOCAB * VOCAB), ("b_h1", VOCAB)]
    return [(name, _pad4(n)) for name, n in entries]


@functools.lru_cache(maxsize=None)
def sampler_size(d: EpicDims) -> int:
    """Floats of the sampler step kernel's buffer."""
    return sum(n for _, n in sampler_layout(d))


@functools.lru_cache(maxsize=None)
def sampler_plan(d: EpicDims):
    """Where each float of the sampler step kernel's buffer comes from, once
    a layout: (index, kind), both (n,) on the CPU. The index is into
    [flat ‖ local_0's folded rows (16, H) ‖ one zero]; the kind is 0 for a
    copy, 1 for the TF32 hi half of an mma fragment's value, 2 for its lo
    half. A (K, N) product's fragments (K, N multiples of 8), per k-step kk
    and n-tile j: lane 4g + t holds (hi b0, hi b1, lo b0, lo b1) with b0 =
    W[8kk + 2t, 8j + g] and b1 = W[8kk + 2t + 1, 8j + g], W (in, out): the
    mma's k positions t and t + 4 take the inputs 2t and 2t + 1, the two
    columns a thread holds of the product before (ops/csrc/sampler_step.cu)."""
    n = sum(math.prod(shape) for _, shape in weight_layout(d))
    H, Et = d.hidden, d.emb_t
    zero = n + 16 * H
    W = flat_views(torch.arange(n, dtype=torch.float64), d)
    rows = (n + torch.arange(16 * H, dtype=torch.float64)).reshape(16, H)
    out = torch.full((H, 16), float(zero), dtype=torch.float64)
    out[:, :VOCAB], out[:, VOCAB:VOCAB + DIM_C] = W["w_out_d"].T, W["w_out_c"].T
    b_out = torch.full((16,), float(zero), dtype=torch.float64)
    b_out[:VOCAB], b_out[VOCAB:VOCAB + DIM_C] = W["b_out_d"], W["b_out_c"]

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
           "outf": fragments(out), "b_out": copy(b_out), "h0f": fragments(W["w_h0"].T),
           "b_h0": copy(W["b_h0"]), "h1f": fragments(W["w_h1"].T), "b_h1": copy(W["b_h1"])}
    for i in range(d.num_blocks):
        w_fl1 = W[f"w_fl1_{i}"]
        src.update({f"fg1_{i}": copy(W[f"w_fg1_{i}"].T), f"b_fg1_{i}": copy(W[f"b_fg1_{i}"]),
                    f"fg2_{i}": copy(W[f"w_fg2_{i}"].T), f"b_fg2_{i}": copy(W[f"b_fg2_{i}"]),
                    f"fl1b_{i}": copy(w_fl1[:, H:].T), f"b_fl1_{i}": copy(W[f"b_fl1_{i}"]),
                    f"fl1f_{i}": fragments(w_fl1[:, :H].T),
                    f"fl2f_{i}": fragments(W[f"w_fl2_{i}"].T), f"b_fl2_{i}": copy(W[f"b_fl2_{i}"])})
    index, kind = [], []
    for name, size in sampler_layout(d):
        i, k = src[name]
        index += [i, torch.full((size - i.numel(),), float(zero), dtype=torch.float64)]
        kind += [k, torch.zeros(size - k.numel(), dtype=torch.uint8)]
    return torch.cat(index).long(), torch.cat(kind)


@functools.lru_cache(maxsize=None)
def _sampler_plan_on(d: EpicDims, device: torch.device):
    return tuple(a.to(device) for a in sampler_plan(d))


def sampler_weights(flat: torch.Tensor, d: EpicDims) -> torch.Tensor:
    """The sampler step kernel's buffer (`sampler_layout`, `sampler_plan`),
    made from a narrow-layout buffer (left as it is) by one gather: a
    request packs once, and a small request is bound by the host. local_0's
    particle two thirds are folded with the embeddings (Dense layers): the
    product of [x, 1, 0, 0, 0, 0, onehot(k)] with the 16 rows [T_x; c; 0;
    T_k], computed in float64, gives them. The output layer's 16 columns are
    the discrete pre-logits, then the three continuous outputs and five zero
    columns. A fragment's hi half is the nearest TF32 value, its lo half the
    rest rounded again."""
    with torch.no_grad():
        W = flat_views(flat.detach(), d)
        Et, Ex = d.emb_t, d.emb_x
        w_l0 = W["w_l0"].double()
        w_x, w_k = w_l0[:, Et:Et + Ex].T, w_l0[:, Et + Ex:].T
        rows = torch.cat([W["w_x"].double().T @ w_x, (W["b_x"].double() @ w_x)[None],
                          w_x.new_zeros((4, d.hidden)), W["table"].double() @ w_k])
        src = torch.cat([flat.detach().float(), rows.float().reshape(-1), flat.new_zeros(1)])
        index, kind = _sampler_plan_on(d, flat.device)
        value = src[index]
        hi = tf32_round(value)
        return torch.where(kind == 0, value, torch.where(kind == 1, hi, tf32_round(value - hi)))


def pack_sampler_params(encoder, config) -> PackedEncoder:
    """The narrow packing of the MBM encoder (`pack_mbm_encoder_params`)
    carrying the sampler step kernel's buffer as its `tensor_core`: what
    `sampler_step` reads on the card, made once a request."""
    packed = pack_mbm_encoder_params(encoder, config)
    return dataclasses.replace(packed, tensor_core=(sampler_weights(packed.flat, packed.dims),))


def sampler_step_reference(packed: PackedEncoder, x, k, mask, u, t, dt, *, gamma):
    """Plain PyTorch version of the kernel (`_step_math`,
    sampler_pallas.py:54-101). Returns (x', k') with k' in k's dtype."""
    sampler_step_reference.calls += 1
    B = x.shape[0]
    t_col = torch.full((B,), float(t), dtype=torch.float32, device=x.device)
    temb = sinusoidal_positional_encoding(t_col, packed.dims.emb_t)
    cont, logits = forward_from_temb(packed, temb, x, k, mask)
    x_new = (x + dt * cont) * mask
    k_new = telegraph_fused_solver_step(t_col, k, logits, gamma, VOCAB, dt, u)
    return x_new, k_new * mask.to(k_new.dtype)


sampler_step_reference.calls = 0


def sampler_step(packed: PackedEncoder, x, k, mask, u, t, dt, *, gamma):
    """One whole sampler step. x (B,N,3), k (B,N,1) int, mask (B,N,1),
    u (2,B,N) uniforms, t and dt Python floats → (x', k'), k' in k's dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if x.device.type == "cpu":
        return sampler_step_reference(packed, x, k, mask, u, t, dt, gamma=gamma)
    check_narrow_packing(packed)
    if packed.tensor_core is None:
        raise ValueError("the sampler step kernel reads the tensor-core weights that "
                         "pack_sampler_params adds to the packing")
    (weights,) = packed.tensor_core
    B, N = check_kernel_inputs(packed, x, k, mask, u=u, tensor_core=weights)
    if tuple(u.shape) != (2, B, N):
        raise ValueError(f"u must be (2, {B}, {N}), got {tuple(u.shape)}")
    if weights.numel() != sampler_size(packed.dims):
        raise ValueError(f"the sampler step kernel's buffer holds {sampler_size(packed.dims)} "
                         f"floats at {packed.dims}, got {weights.numel()}")
    k32 = k.to(torch.int32).contiguous()
    x_out = torch.empty_like(x)
    k_out = torch.empty_like(k32)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mmp_sampler_step(
            weights.data_ptr(), x.data_ptr(), k32.data_ptr(), mask.data_ptr(), u.data_ptr(),
            x_out.data_ptr(), k_out.data_ptr(), float(t), float(dt), float(gamma), B, N,
            packed.dims.c_array(), stream,
        )
    _build.check(lib, rc, "mmp_sampler_step")
    sampler_step.launches += 1
    return x_out, k_out.to(k.dtype)


sampler_step.launches = 0


def fused_simulate_dynamics(model, state: HybridState, generator=None, uniforms=None):
    """MBM.simulate_dynamics with the whole step in one kernel
    (sampler_pallas.py:174-216): pack the weights once (`pack_sampler_params`), then one
    `sampler_step` per time in time_steps[1:]. `uniforms` (steps, 2, B, N)
    replaces the draws from `generator`."""
    cfg = model.config
    packed = pack_sampler_params(model.encoder, cfg)
    time_steps, delta_t = model.time_grid()
    B, N, _ = state.continuous.shape
    device = state.continuous.device

    x = state.continuous.to(torch.float32).contiguous()
    k = state.discrete.to(torch.int32).contiguous()
    mask = state.absorbing.to(torch.float32).contiguous()
    for i, t in enumerate(time_steps[1:]):
        if uniforms is not None:
            u = uniforms[i].to(device=device, dtype=torch.float32).contiguous()
        else:
            u = torch.rand((2, B, N), generator=generator, device=device)
        x, k = sampler_step(packed, x, k, mask, u, t, delta_t, gamma=cfg.bridge.gamma)
    return state.replace(
        continuous=x.to(state.continuous.dtype), discrete=k.to(state.discrete.dtype)
    )
