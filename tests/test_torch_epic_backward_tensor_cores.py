"""K3, the narrow EPiC backward, on the tensor cores (ops/csrc/epic_backward.cu,
its rerun K1's forward on narrow_tc.cuh), checked on the CPU, which cannot run
it:

* the buffer it reads (`with_narrow_buffer`, made by
  ops/epic_cuda.py::narrow_buffer, the one K1 and K2 read): K1's entries
  first, then the fragments of the transposed weights of K3's
  dz·Wᵀ products (the output layer's 16 rows, every layer's fc_local2 and
  fc_local1's particle third, the head's two layers), each as TF32 hi/lo mma
  fragments with the k order K1's products take, zeros where a product is
  padded (the output layer's five rows past the 11 outputs, the head's
  columns past its width), every entry padded with zeros to 4 floats;
* a float64 model of the kernel's split arithmetic
  (tests/torch_port_helpers.py::narrow_backward_model: K1's forward read from
  its buffer, dz·Wᵀ with dz truncated and Wᵀ rounded, aᵀ·dz with both
  truncated, local_0's input side through Q = Rᵀ·dz_l0) against `jax.vjp` of
  the JAX package's own kernel in interpret mode (ops/epic_pallas_vjp.py
  `make_epic_train_forward`) at K3's gate against plain autograd on the card,
  per packed leaf |err| ≤ 1e-4·max|ref leaf| + 1e-3·|ref|, no cotangent on
  the jets `near_kink_jets` flags: hidden 16 (config-berlin), 32 and 64, skip
  off, head off;
* the training step's buffers take fewer dispatched operations than K1's
  buffer alone took before K3 read it too.

One TF32 product (a_hi·w_hi alone, in every product) is measured at 64 jets
of 128 slots, not at a toy size: there the split model holds K3's gate and
one product misses it, as the `one_product` variant of scripts/k3_variants.py
does on the card at B=8192.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from multimodal_particles_tpu.ops.epic_pallas import WEIGHT_NAMES
from multimodal_particles_tpu.ops.epic_pallas import pack_mbm_encoder_params as jax_pack
from multimodal_particles_tpu.ops.epic_pallas_vjp import make_epic_train_forward
from multimodal_particles_tpu_torch.ops.epic_cuda import (
    EpicDims,
    PackedEncoder,
    flat_views,
    narrow_buffer,
    narrow_buffer_layout,
    narrow_buffer_size,
    pack_mbm_encoder_params,
    tf32_round,
    weight_layout,
    with_narrow_buffer,
)
from multimodal_particles_tpu_torch.ops.epic_vjp_cuda import near_kink_jets
from torch_port_helpers import (
    model_pair,
    narrow_backward_model,
    random_state,
    to_torch,
    unpack_mma_fragments,
)

CASES = {
    "berlin": {},
    "hidden32x3": {"dim_hidden_local": 32, "dim_hidden_glob": 32, "num_blocks": 3},
    "hidden64x4": {"dim_hidden_local": 64, "dim_hidden_glob": 64, "num_blocks": 4},
    "no_skip": {"skip_connection": False},
    "no_head": {"add_discrete_head": False},
}
# the operations a training step's buffer took before K3 read one: K1's
# buffer alone at config-berlin, as `narrow_buffer` made it then (counted by
# scripts/buffer_launches.py --other at that revision)
K1_BUFFER_ALONE_OPERATIONS = 117


def jax_gradient(jax_model, params, t, x, k, mask, g):
    """d(packed weights) by jax.vjp of the interpret-mode Pallas kernel, in
    the port's flat layout's names."""
    cfg = jax_model.config.encoder
    fused = make_epic_train_forward(
        num_blocks=cfg.num_blocks, use_skip=cfg.skip_connection,
        add_discrete_head=cfg.add_discrete_head, dim_c=3, vocab=8, hidden=cfg.dim_hidden_local,
        dim_emb_time=cfg.dim_emb_time, interpret=True)
    _, vjp = jax.vjp(lambda p: fused(p, *map(jnp.asarray, (t, x, k, mask))),
                     jax_pack(params["encoder"], cfg.num_blocks))
    (cot,) = vjp(jnp.asarray(g))
    return dict(zip(WEIGHT_NAMES, (np.asarray(c) for c in cot)))


def share_of_k3_gate(packed, ref, d_flat):
    """The worst leaf's |d_flat − ref| as a share of K3's per-leaf gate."""
    worst = 0.0
    for name, value in flat_views(d_flat, packed.dims).items():
        base, _, layer = name.rpartition("_")
        r = ref[base][int(layer)] if layer.isdigit() else ref[name]
        if name == "table":
            r = r.T  # JAX packs the table (E, V), the port (V, E)
        r = r.reshape(value.shape)
        bound = 1e-4 * max(float(np.abs(r).max()), 1e-6) + 1e-3 * np.abs(r)
        worst = max(worst, float((np.abs(value.numpy() - r) / bound).max()))
    return worst


def model_against_pallas(encoder, b, n, one_products=(False,)):
    """The split model's share of K3's gate against the JAX kernel's VJP at b
    jets of n slots, for each of `one_products`."""
    jax_model, params, torch_model, _ = model_pair(**encoder)
    with torch.no_grad():
        packed = with_narrow_buffer(pack_mbm_encoder_params(torch_model.encoder,
                                                            torch_model.config))
    t, x, k, mask = random_state(1, b, n)
    near = near_kink_jets(packed, *to_torch(t, x, k, mask)).numpy()
    g = np.random.default_rng(9).standard_normal((b, n, 11)).astype(np.float32)
    g *= ~near[:, None, None]
    ref = jax_gradient(jax_model, params, t, x, k, mask, g)
    inputs = to_torch(t, x, k, mask, g)
    return [share_of_k3_gate(packed, ref, narrow_backward_model(packed, *inputs, one_product=one))
            for one in one_products]


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_model_holds_k3_gate_against_pallas_vjp(name):
    (share,) = model_against_pallas(CASES[name], 8, 16)
    assert share <= 1.0, share


def test_split_model_at_64_jets_of_128_slots_and_one_tf32_product():
    """At 64 jets of 128 slots (config-berlin) the split model holds K3's gate
    and one TF32 product misses it."""
    split, one = model_against_pallas({}, 64, 128, one_products=(False, True))
    assert split <= 1.0, split
    assert one > 1.0, one


def packed_with_head(head_width):
    d = EpicDims(16, 19, 16, 16, 16, 2, True, True, head_hidden=head_width)
    n = sum(math.prod(s) for _, s in weight_layout(d))
    flat = torch.randn(n, generator=torch.Generator().manual_seed(head_width))
    return with_narrow_buffer(PackedEncoder(flat, flat_views(flat, d), d))


def backward_entries(packed):
    """Name → view of each entry of the buffer."""
    (buf,) = packed.tensor_core
    entries, off = {}, 0
    for name, n in narrow_buffer_layout(packed.dims):
        entries[name] = buf[off:off + n]
        off += n
    assert off == buf.numel()
    return entries


@pytest.mark.parametrize("head_width", [8, 20])
def test_transposed_fragments_hold_each_weight_at_its_place(head_width):
    """Each dz·Wᵀ product's weights, (K, N) = the packed (out, in) matrix:
    hi the nearest TF32 value, hi + lo within 2⁻²² of it, lane 4g + t of
    k-step kk and n-tile j holding rows 2t and 2t + 1 of the k-step at
    column 8j + g, zeros where the product is padded."""
    packed = packed_with_head(head_width)
    d, W = packed.dims, packed.tensors
    H, Hd = d.hidden, (head_width + 7) // 8 * 8
    E = backward_entries(packed)
    out = torch.zeros((16, H))
    out[:8], out[8:11] = W["w_out_d"], W["w_out_c"]
    h1, h0 = torch.zeros((8, Hd)), torch.zeros((Hd, 8))
    h1[:, :head_width], h0[:head_width] = W["w_h1"], W["w_h0"]
    items = [("outT", out), ("h1T", h1), ("h0T", h0)]
    for i in range(d.num_blocks):
        items += [(f"fl2T_{i}", W[f"w_fl2_{i}"]), (f"fl1T_{i}", W[f"w_fl1_{i}"][:, :H])]
    for name, w in items:
        K, n_out = w.shape
        hi, lo = unpack_mma_fragments(E[name], K, n_out)
        assert torch.equal(hi, tf32_round(w)), name
        assert ((hi.double() + lo.double() - w.double()).abs()
                <= 2.0**-22 * w.abs().double()).all(), name
        assert (hi[w == 0] == 0).all() and (lo[w == 0] == 0).all(), name
        kk, j, g, t = K // 8 - 1, n_out // 8 - 1, 6, 2
        at = ((kk * (n_out // 8) + j) * 32 + 4 * g + t) * 4
        assert E[name][at] == tf32_round(w[8 * kk + 2 * t, 8 * j + g]), name
        assert E[name][at + 1] == tf32_round(w[8 * kk + 2 * t + 1, 8 * j + g]), name
        assert (E[name][2 * K * n_out:] == 0).all(), name
    assert (out[11:] == 0).all()


def test_k3_buffer_starts_with_k1s_and_carries_both():
    """The one buffer holds K1's (and K2's) entries first, in K1's order,
    then K3's, made in one pass; `with_narrow_buffer` carries it alone, and
    the three kernels read it."""
    *_, torch_model, _ = model_pair()
    with torch.no_grad():
        packed = pack_mbm_encoder_params(torch_model.encoder, torch_model.config)
    (buf,) = with_narrow_buffer(packed).tensor_core
    names = [name for name, _ in narrow_buffer_layout(packed.dims)]
    k3 = names.index("outT")
    assert names[k3 - 2:k3] == ["h1f", "b_h1"]
    assert names[k3:] == (["outT"] + [f"{w}T_{i}" for i in range(packed.dims.num_blocks)
                                      for w in ("fl2", "fl1")] + ["h1T", "h0T"])
    assert buf.numel() == narrow_buffer_size(packed.dims)
    assert torch.equal(buf, narrow_buffer(packed.flat.clone(), packed.dims))


class CountOperations(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += 1
        return func(*args, **(kwargs or {}))


def test_training_buffers_take_fewer_operations_than_k1s_alone_did():
    """What the training forward runs at each step to make the buffer of K1
    and K3 from the non-leaf weights dispatches fewer operations than K1's
    buffer alone did before (K1_BUFFER_ALONE_OPERATIONS)."""
    *_, torch_model, _ = model_pair()
    packed = pack_mbm_encoder_params(torch_model.encoder, torch_model.config, differentiable=True)
    narrow_buffer(packed.flat, packed.dims)  # the plan, made once a layout
    with CountOperations() as counted:
        narrow_buffer(packed.flat, packed.dims)
    assert counted.count < K1_BUFFER_ALONE_OPERATIONS
