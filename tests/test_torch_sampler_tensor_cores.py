"""K2, the fused MBM sampler step, on the tensor cores (ops/csrc/sampler_step.cu),
checked on the CPU, which cannot run it:

* the buffer it reads (`PackedEncoder.tensor_core` of the packing that
  ops/sampler_cuda.py::pack_sampler_params makes, by
  ops/epic_cuda.py::narrow_buffer, the buffer K2 shares with K1):
  every per-particle weight as TF32 hi/lo
  mma fragments with the k order permuted (the mma's k positions t, t + 4
  take the inputs 2t, 2t + 1), local_0's particle part folded with the
  embeddings into 16 rows [T_x; c; 0; T_k], the output layer's discrete then
  continuous columns and its zero columns, the per-jet weights transposed,
  every entry padded with zeros to 4 floats;
* a float64 model of the kernel's arithmetic read from that buffer
  (tests/torch_port_helpers.py::sampler_step_model, on the forward model it
  shares with K1's tests: each product's A operand
  split by truncation, the buffer's hi/lo weights, three products) against
  the JAX package's own fused step in interpret mode
  (ops/sampler_pallas.py), at hidden 16, 32 and 64 and at per-jet vectors
  wider than 64 (hidden_glob 96, emb_t 80), at K2's gate against its plain
  version on the card: x' within atol = rtol = 1e-4, tokens differing on at
  most 1% of the slots.

One TF32 product (a_hi·w_hi alone) misses that gate. At the toy size of the
other tests (8 jets of 16 slots) it holds it, since K2's outputs move x by
dt·cont with dt ≈ 0.01, which scales the products' error down; at 64 jets
of 128 slots it misses, as the `one_product` variant of scripts/k2_variants.py
misses it on the card at config-berlin's B=32768, N=128. The test measures
at the larger size and asserts the miss."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_particles_tpu.ops.epic_pallas import pack_mbm_encoder_params as jax_pack
from multimodal_particles_tpu_torch.ops.epic_cuda import (
    flat_views,
    narrow_buffer,
    narrow_buffer_layout,
    pack_mbm_encoder_params,
    tf32_round,
)
from multimodal_particles_tpu_torch.ops.sampler_cuda import pack_sampler_params
from torch_port_helpers import (
    B,
    N,
    jax_step_fn,
    model_pair,
    random_state,
    narrow_buffer_entries,
    sampler_step_model,
    to_torch,
    unpack_mma_fragments,
)

ATOL = RTOL = 1e-4  # K2's gate against its plain version (chip_smoke.py phase K2)
MAX_TOKEN_MISMATCH = 0.01
# (hidden, hidden_glob, emb_t): the three hidden widths, and per-jet vectors
# wider than 64 (the kernel keeps those in shared memory)
WIDTHS = [(16, 16, 16), (32, 32, 16), (64, 64, 16), (16, 96, 80)]


@pytest.fixture(scope="module", params=WIDTHS,
                ids=["hidden16", "hidden32", "hidden64", "hidden16_glob96_temb80"])
def pair(request):
    h, hg, et = request.param
    return model_pair(dim_hidden_local=h, dim_hidden_glob=hg, dim_emb_time=et)


def packing(pair):
    with torch.no_grad():
        return pack_sampler_params(pair[2].encoder, pair[2].config)


def products(packed):
    """(entry, K, N, the (in, out) weights it holds) of every per-particle
    product in the buffer."""
    d, W = packed.dims, packed.tensors
    H = d.hidden
    out = torch.zeros((H, 16))
    out[:, :8], out[:, 8:11] = W["w_out_d"].T, W["w_out_c"].T
    items = [("outf", H, 16, out), ("h0f", 8, 8, W["w_h0"].T), ("h1f", 8, 8, W["w_h1"].T)]
    for i in range(d.num_blocks):
        items += [(f"fl1f_{i}", H, H, W[f"w_fl1_{i}"][:, :H].T), (f"fl2f_{i}", H, H, W[f"w_fl2_{i}"].T)]
    return items


def test_fragments_hold_each_weight_at_its_place(pair):
    packed = packing(pair)
    E = narrow_buffer_entries(packed)
    for name, K, n_out, w in products(packed):
        hi, lo = unpack_mma_fragments(E[name], K, n_out)
        assert torch.equal(hi, tf32_round(w)), name
        assert ((hi.double() + lo.double() - w.double()).abs()
                <= 2.0**-22 * w.abs().double()).all(), name
        # lane 4g + t of k-step kk, n-tile j: (hi b0, hi b1, lo b0, lo b1),
        # b0 = W[8kk + 2t, 8j + g], b1 = W[8kk + 2t + 1, 8j + g]
        kk, j, g, t = K // 8 - 1, n_out // 8 - 1, 5, 3
        at = ((kk * (n_out // 8) + j) * 32 + 4 * g + t) * 4
        assert E[name][at] == tf32_round(w[8 * kk + 2 * t, 8 * j + g])
        assert E[name][at + 1] == tf32_round(w[8 * kk + 2 * t + 1, 8 * j + g])
    # the output layer's five columns past the continuous three are zero
    hi, lo = unpack_mma_fragments(E["outf"], packed.dims.hidden, 16)
    assert (hi[:, 11:] == 0).all() and (lo[:, 11:] == 0).all()
    # each entry's padding past its values is zero
    sizes = {"t0": packed.dims.emb_t * packed.dims.hidden, "b_g2": packed.dims.hidden_glob,
             "b_h0": 8}
    for name, n in sizes.items():
        assert (E[name][n:] == 0).all()
    assert sum(n for _, n in narrow_buffer_layout(packed.dims)) % 4 == 0


def test_local0_rows_give_the_particle_part_of_local0(pair):
    packed = packing(pair)
    W, d = packed.tensors, packed.dims
    E = narrow_buffer_entries(packed)
    hi, lo = unpack_mma_fragments(E["l0f"], 16, d.hidden)
    rows = hi.double() + lo.double()
    assert (rows[4:8] == 0).all()  # the zero inputs' rows
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.standard_normal((64, 3)))
    tok = torch.tensor(rng.integers(0, 8, 64))
    onehot = torch.nn.functional.one_hot(tok, 8).double()
    a = torch.cat([x, torch.ones((64, 1)), torch.zeros((64, 4)), onehot], dim=-1)
    et, ex = d.emb_t, d.emb_x
    ref = (torch.cat([x @ W["w_x"].double().T + W["b_x"].double(), onehot @ W["table"].double()], -1)
           @ W["w_l0"].double()[:, et:].T)
    assert ((a @ rows - ref).abs() <= 1e-6 * (1 + ref.abs())).all()


def test_per_jet_weights_are_the_transposes(pair):
    packed = packing(pair)
    W, d = packed.tensors, packed.dims
    E = narrow_buffer_entries(packed)
    H, Et = d.hidden, d.emb_t
    expect = {"t0": W["w_l0"][:, :Et].T, "g0": W["w_g0"].T, "b_g0": W["b_g0"], "g1": W["w_g1"].T,
              "g2": W["w_g2"].T, "b_g2": W["b_g2"], "b_l0": W["b_l0"], "b_h1": W["b_h1"]}
    for i in range(d.num_blocks):
        expect.update({f"fg1_{i}": W[f"w_fg1_{i}"].T, f"fg2_{i}": W[f"w_fg2_{i}"].T,
                       f"fl1b_{i}": W[f"w_fl1_{i}"][:, H:].T, f"b_fl1_{i}": W[f"b_fl1_{i}"],
                       f"b_fl2_{i}": W[f"b_fl2_{i}"]})
    for name, w in expect.items():
        v = w.reshape(-1)
        assert torch.equal(E[name][:v.numel()], v), name
    b_out = E["b_out"]
    assert torch.equal(b_out[:8], W["b_out_d"]) and torch.equal(b_out[8:11], W["b_out_c"])
    assert (b_out[11:] == 0).all()


def jax_step(pair, x, k, mask, u, t, dt):
    jax_model, params, _, _ = pair
    b, n = x.shape[:2]
    rows = b * n
    x_j, k_j = jax_step_fn(jax_model, b, n)(
        jax_pack(params["encoder"], jax_model.config.encoder.num_blocks),
        jnp.asarray(x.reshape(rows, 3).T), jnp.asarray(k.reshape(1, rows)),
        jnp.asarray(mask.reshape(1, rows)), jnp.asarray(u.reshape(2, rows)), t, dt,
    )
    return np.asarray(x_j).T.reshape(b, n, 3), np.asarray(k_j).reshape(b, n, 1)


def model_against_pallas(pair, t, one_product, b=B, n=N):
    """(worst |Δx| as a share of K2's gate, token mismatch) of the model
    against the JAX fused step in interpret mode, the same uniforms, at b
    jets of n slots."""
    _, x, k, mask = random_state(b=b, n=n)
    u = np.random.default_rng(3).random((2, b, n), dtype=np.float32)
    dt = 0.01
    x_ref, k_ref = jax_step(pair, x, k, mask, u, t, dt)
    packed = packing(pair)
    x_new, k_new = sampler_step_model(packed, *to_torch(x, k, mask, u), t, dt,
                                      pair[2].config.bridge.gamma, one_product=one_product)
    share = (np.abs(x_new.numpy() - x_ref) / (ATOL + RTOL * np.abs(x_ref))).max()
    real = mask[..., 0] > 0
    mismatch = (k_new.numpy()[..., 0] != k_ref[..., 0])[real].mean()
    return share, mismatch


@pytest.mark.parametrize("t", [0.0101, 0.5, 1.0 - 1e-4])
def test_split_model_holds_k2_gate_against_pallas_interpret(pair, t):
    share, mismatch = model_against_pallas(pair, t, one_product=False)
    assert share <= 1.0 and mismatch <= MAX_TOKEN_MISMATCH, (share, mismatch)


def test_one_tf32_product_misses_k2_gate(pair):
    """At 64 jets of 128 slots; the split model holds the gate there."""
    share, mismatch = model_against_pallas(pair, 0.5, one_product=True, b=64, n=128)
    assert share > 1.0 or mismatch > MAX_TOKEN_MISMATCH, (share, mismatch)
    share, mismatch = model_against_pallas(pair, 0.5, one_product=False, b=64, n=128)
    assert share <= 1.0 and mismatch <= MAX_TOKEN_MISMATCH, (share, mismatch)


def test_sampler_packing_carries_k2_buffer_and_the_shared_packing_none(pair):
    """The sampler's own packing builds K2's buffer (the one K1 reads too);
    the shared narrow packing, which K3 and the plain versions read, carries
    none: each consumer adds it where it packs."""
    torch_model = pair[2]
    packed = packing(pair)
    (buf,) = packed.tensor_core
    assert buf.dtype == torch.float32 and buf.is_contiguous()
    assert buf.numel() == sum(n for _, n in narrow_buffer_layout(packed.dims))
    assert torch.equal(buf, narrow_buffer(packed.flat.clone(), packed.dims))
    assert flat_views(packed.flat, packed.dims).keys() == packed.tensors.keys()
    with torch.no_grad():
        shared = pack_mbm_encoder_params(torch_model.encoder, torch_model.config)
    assert shared.tensor_core is None and torch.equal(shared.flat, packed.flat)
    trained = pack_mbm_encoder_params(torch_model.encoder, torch_model.config, differentiable=True)
    assert trained.tensor_core is None


def test_wrapper_refuses_a_packing_without_the_buffer(pair):
    """On `meta` tensors (not on the CPU, so the wrapper checks them as it
    checks CUDA tensors) the sampler step refuses a packing that carries no
    tensor-core buffer (the shared narrow packing), before it builds
    anything."""
    from multimodal_particles_tpu_torch.ops.sampler_cuda import sampler_step

    torch_model = pair[2]
    with torch.no_grad():
        trained = pack_mbm_encoder_params(torch_model.encoder, torch_model.config)
    trained.flat = trained.flat.to("meta")
    x = torch.empty((B, N, 3), device="meta")
    k = torch.empty((B, N, 1), dtype=torch.int32, device="meta")
    mask = torch.empty((B, N, 1), device="meta")
    u = torch.empty((2, B, N), device="meta")
    with pytest.raises(ValueError, match="tensor-core weights"):
        sampler_step(trained, x, k, mask, u, 0.5, 0.01, gamma=0.125)
