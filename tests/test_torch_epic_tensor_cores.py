"""K1, the fused narrow EPiC forward, on the tensor cores (ops/csrc/
epic_forward_kernel.cuh on the machinery of narrow_tc.cuh), checked on the
CPU, which cannot run it:

* the buffer it reads, the one K2 reads too (`PackedEncoder.tensor_core`,
  made by ops/epic_cuda.py::narrow_buffer where each consumer packs): every
  per-particle weight as TF32 hi/lo mma fragments with the k order permuted
  (the mma's k positions t, t + 4 take the inputs 2t, 2t + 1), local_0's
  particle part folded with the embeddings into 16 rows [T_x; c; 0; T_k]
  (with the folded input T_k is the Dense's table through local_0 and c
  takes its bias), the discrete head in 8-column tiles at widths 8, 20 and
  56 with zeros past the width, every entry padded with zeros to 4 floats;
* a float64 model of the kernel's arithmetic read from that buffer
  (tests/torch_port_helpers.py::epic_forward_model: each product's A operand
  split by truncation, the buffer's hi/lo weights, three products) against
  the JAX package's own kernel in interpret mode (ops/epic_pallas.py
  `epic_forward_pallas`) with its hidden output, at hidden 16, 32 and 64, at
  per-jet vectors wider than 64 (hidden_glob 96, emb_t 80), with the
  absorbing generator's 56-wide head and with the transdimensional trunk's
  folded input and no head, at K1's gate against its plain version on the
  card (chip_smoke.py phases K1, k1_hidden, k1_fold): the 11 outputs and the
  hidden state within atol = rtol = 1e-4 elementwise, per particle (the
  particle's largest output for rtol) at hidden 64;
* which packings carry the buffer: each consumer adds it (the serving
  packings of the three families), the shared narrow packing and the
  training packing none (the training forward makes its own at each step).

One TF32 product (a_hi·w_hi alone) is measured at 64 jets of 128 slots, not
at the toy size of the other tests: there it misses K1's gate at
config-berlin, as the `one_product` variant of scripts/k1_variants.py does on
the card at B=32768."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_particles_tpu.ops.epic_pallas import (
    epic_forward_pallas,
    pack_encoder_params_fold_discrete as jax_pack_fold,
    pack_mbm_encoder_params as jax_pack,
)
from multimodal_particles_tpu_torch.ops.epic_cuda import (
    EpicDims,
    PackedEncoder,
    flat_views,
    narrow_buffer,
    narrow_buffer_layout,
    pack_mbm_encoder_params,
    tf32_round,
    weight_layout,
    with_narrow_buffer,
)
from torch_port_helpers import (
    absorbing_pair,
    epic_forward_model,
    model_pair,
    narrow_buffer_entries,
    random_state,
    to_torch,
    transdim_pair,
    unpack_mma_fragments,
)

ATOL = RTOL = 1e-4  # K1's gate against its plain version (chip_smoke.py phase K1)
# (hidden, hidden_glob, emb_t) of the MBM encoder: the three hidden widths, and
# per-jet vectors wider than 64 (the kernel keeps those in shared memory)
WIDTHS = [(16, 16, 16), (32, 32, 16), (64, 64, 16), (16, 96, 80)]
CASES = ["hidden16", "hidden32", "hidden64", "hidden16_glob96_temb80", "absorbing_head56",
         "transdim_folded_no_head"]


@pytest.fixture(scope="module", params=CASES)
def case(request):
    """(name, port packing with K1's buffer, JAX function of (t, x, k, mask)
    → (out, hidden)) of one encoder with transplanted weights."""
    name = request.param
    if name == "absorbing_head56":
        jax_model, params, model, _ = absorbing_pair()
        cfg = jax_model.config
        gen = params["generator"]
        jax_packed = jax_pack({"epic": gen["epic"], "fc_layer": gen["discrete_head_mlp"]},
                              cfg.encoder.num_blocks, 3)
        packed, _ = model.pack_for_kernel()
        return name, packed, jax_forward(jax_packed, cfg.encoder, True, False)
    if name == "transdim_folded_no_head":
        jax_model, params, model, _ = transdim_pair(drawn_init=True)
        cfg = jax_model.config
        jax_packed = jax_pack_fold({"epic": params["network"]["epic"]}, cfg.encoder.num_blocks, 3)
        packed, _, _ = model.pack_for_kernel()
        return name, packed, jax_forward(jax_packed, cfg.encoder, False, True)
    h, hg, et = WIDTHS[CASES.index(name)]
    jax_model, params, model, _ = model_pair(dim_hidden_local=h, dim_hidden_glob=hg,
                                             dim_emb_time=et)
    cfg = jax_model.config
    with torch.no_grad():
        packed = with_narrow_buffer(pack_mbm_encoder_params(model.encoder, model.config))
    return name, packed, jax_forward(jax_pack(params["encoder"], cfg.encoder.num_blocks),
                                     cfg.encoder, cfg.encoder.add_discrete_head, False)


def jax_forward(jax_packed, enc, head, fold):
    def run(t, x, k, mask):
        if fold:  # the JAX kernel takes [x ‖ channel values] as one input
            x, k = np.concatenate([x, k], axis=-1), np.zeros(k.shape[:2] + (1,), np.int32)
        out, hid = epic_forward_pallas(
            jax_packed, *map(jnp.asarray, (t, x, k, mask)), num_blocks=enc.num_blocks,
            use_skip=enc.skip_connection, add_discrete_head=head, dim_c=3, vocab=8,
            hidden=enc.dim_hidden_local, dim_emb_time=enc.dim_emb_time,
            output_hidden_local=True, interpret=True, fold_discrete=fold)
        return np.asarray(out), np.asarray(hid)
    return run


def inputs(packed, b, n, seed=1):
    """t, x, k, mask as numpy (random multiplicities, jet 0 empty); with a
    folded packing k is noisy one-hot channel values."""
    t, x, k, mask = random_state(seed, b, n)
    if packed.dims.fold_discrete:
        rng = np.random.default_rng(seed + 1)
        k = ((np.eye(8, dtype=np.float32)[k[..., 0]]
              + 0.3 * rng.standard_normal((b, n, 8)).astype(np.float32)) * mask)
    return t, x, k, mask


def share_of_k1_gate(got, ref, per_particle):
    """The largest |got − ref| as a share of K1's gate: atol + rtol·|ref|
    elementwise, or per particle with the row's largest |ref|."""
    scale = np.abs(ref).max(axis=-1, keepdims=True) if per_particle else np.abs(ref)
    return float((np.abs(got - ref) / (ATOL + RTOL * scale)).max())


def model_against_pallas(case, b, n, one_product=False):
    """The worst share of K1's gate of the model's outputs and hidden state
    against the interpret-mode JAX kernel at b jets of n slots."""
    _, packed, jax_run = case
    t, x, k, mask = inputs(packed, b, n)
    out_ref, hid_ref = jax_run(t, x, k, mask)
    out, hid = epic_forward_model(packed, *to_torch(t, x, k, mask), one_product=one_product)
    per_particle = packed.dims.hidden == 64
    return max(share_of_k1_gate(out.numpy(), out_ref, per_particle),
               share_of_k1_gate(hid.numpy(), hid_ref, per_particle))


def test_split_model_holds_k1_gate_against_pallas_interpret(case):
    assert model_against_pallas(case, 8, 16) <= 1.0


def test_fragments_hold_each_weight_at_its_place(case):
    _, packed, _ = case
    d, W = packed.dims, packed.tensors
    E = narrow_buffer_entries(packed)
    H, Hd = d.hidden, (d.head_hidden + 7) // 8 * 8
    out = torch.zeros((H, 16))
    out[:, :8], out[:, 8:11] = W["w_out_d"].T, W["w_out_c"].T
    h0, h1 = torch.zeros((8, Hd)), torch.zeros((Hd, 8))
    h0[:, :d.head_hidden], h1[:d.head_hidden] = W["w_h0"].T, W["w_h1"].T
    items = [("outf", H, 16, out), ("h0f", 8, Hd, h0), ("h1f", Hd, 8, h1)]
    for i in range(d.num_blocks):
        items += [(f"fl1f_{i}", H, H, W[f"w_fl1_{i}"][:, :H].T), (f"fl2f_{i}", H, H, W[f"w_fl2_{i}"].T)]
    for name, K, n_out, w in items:
        hi, lo = unpack_mma_fragments(E[name], K, n_out)
        assert torch.equal(hi, tf32_round(w)), name
        assert ((hi.double() + lo.double() - w.double()).abs()
                <= 2.0**-22 * w.abs().double()).all(), name
        # lane 4g + t of k-step kk, n-tile j: (hi b0, hi b1, lo b0, lo b1)
        kk, j, g, t = K // 8 - 1, n_out // 8 - 1, 5, 3
        at = ((kk * (n_out // 8) + j) * 32 + 4 * g + t) * 4
        assert E[name][at] == tf32_round(w[8 * kk + 2 * t, 8 * j + g])
        assert E[name][at + 1] == tf32_round(w[8 * kk + 2 * t + 1, 8 * j + g])
    assert torch.equal(E["b_h0"][:d.head_hidden], W["b_h0"])
    assert sum(n for _, n in narrow_buffer_layout(d)) == packed.tensor_core[0].numel()


@pytest.mark.parametrize("head_width", [8, 20, 56])
def test_head_tiles_and_zero_padding_at_every_width(head_width):
    """The head's two products at a width that fills its 8-column tiles and
    one that does not: the tiles past the width and each entry's padding
    hold zeros."""
    d = EpicDims(16, 19, 16, 16, 16, 2, True, True, head_hidden=head_width)
    n = sum(math.prod(s) for _, s in weight_layout(d))
    flat = torch.randn(n, generator=torch.Generator().manual_seed(head_width))
    packed = with_narrow_buffer(PackedEncoder(flat, flat_views(flat, d), d))
    E = narrow_buffer_entries(packed)
    Hd = (head_width + 7) // 8 * 8
    W = packed.tensors
    for name, K, n_out, w in (("h0f", 8, Hd, W["w_h0"].T), ("h1f", Hd, 8, W["w_h1"].T)):
        hi, lo = unpack_mma_fragments(E[name], K, n_out)
        full = torch.zeros((K, n_out))
        full[:w.shape[0], :w.shape[1]] = w
        assert torch.equal(hi, tf32_round(full)), name
        assert (hi[full == 0] == 0).all() and (lo[full == 0] == 0).all(), name
    assert (E["b_h0"][head_width:] == 0).all() and E["b_h0"].numel() == Hd
    assert (E["b_g2"][19:] == 0).all() and E["b_g2"].numel() == 20


def test_local0_rows_give_the_particle_part_of_local0(case):
    """[x, 1, 0…, onehot(k) or the channel values]·rows = local_0's particle
    two thirds of the embedded features, the embeddings' biases included."""
    _, packed, _ = case
    W, d = packed.tensors, packed.dims
    E = narrow_buffer_entries(packed)
    hi, lo = unpack_mma_fragments(E["l0f"], 16, d.hidden)
    rows = hi.double() + lo.double()
    assert (rows[4:8] == 0).all()  # the zero inputs' rows
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.standard_normal((64, 3)))
    if d.fold_discrete:
        disc = torch.tensor(rng.standard_normal((64, 8)))
        k_emb = disc @ W["table"].double() + W["b_k"].double()
    else:
        disc = torch.nn.functional.one_hot(torch.tensor(rng.integers(0, 8, 64)), 8).double()
        k_emb = disc @ W["table"].double()
    a = torch.cat([x, torch.ones((64, 1)), torch.zeros((64, 4)), disc], dim=-1)
    et, ex = d.emb_t, d.emb_x
    ref = (torch.cat([x @ W["w_x"].double().T + W["b_x"].double(), k_emb], -1)
           @ W["w_l0"].double()[:, et:].T)
    assert ((a @ rows - ref).abs() <= 1e-6 * (1 + ref.abs())).all()


def test_model_at_64_jets_of_128_slots_and_one_tf32_product():
    """At 64 jets of 128 slots (config-berlin's encoder, hidden 16) the split
    model holds K1's gate and one TF32 product misses it."""
    jax_model, params, model, _ = model_pair()
    cfg = jax_model.config
    with torch.no_grad():
        packed = with_narrow_buffer(pack_mbm_encoder_params(model.encoder, model.config))
    case = ("hidden16", packed, jax_forward(jax_pack(params["encoder"], cfg.encoder.num_blocks),
                                            cfg.encoder, True, False))
    assert model_against_pallas(case, 64, 128) <= 1.0
    assert model_against_pallas(case, 64, 128, one_product=True) > 1.0


def test_each_consumer_packs_the_buffer_and_the_shared_packings_none(case):
    """The serving packings carry K1's buffer, the one `narrow_buffer` makes
    from their flat weights; the shared narrow packing and the training
    packing carry none (the training forward makes its own at each step)."""
    name, packed, _ = case
    (buf,) = packed.tensor_core
    assert buf.dtype == torch.float32 and buf.is_contiguous()
    assert torch.equal(buf, narrow_buffer(packed.flat.clone(), packed.dims))
    if name == "hidden16":
        *_, model, _ = model_pair()
        assert model.pack_for_kernel(wide=False).tensor_core is not None
        assert model.pack_for_kernel(wide=False, differentiable=True).tensor_core is None
        with torch.no_grad():
            assert pack_mbm_encoder_params(model.encoder, model.config).tensor_core is None
