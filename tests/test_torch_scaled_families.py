"""The absorbing and transdimensional families at the `--scaled` backbone
(every width 128, `bench.py`'s `_scale_encoder`, cut to 2 blocks) against the
JAX package on the CPU: the wide EPiC kernel's plain version with the trunk's
hidden output and the absorbing generator's 56-wide discrete head, and with
the transdimensional trunk's folded Linear-discrete input, against
`epic_forward_pallas_wide(..., interpret=True)` on the JAX packings;
`AbsorbingFlow.forward_sampling` and the transdimensional `forward_kernel`
(CPU tensors: the kernels' plain versions) against JAX `forward_sampling` and
`_network_fused` in interpret mode on transplanted weights; the packings leaf
by leaf; what the wide wrappers refuse. The CUDA kernels run on the card only
(tests/test_torch_cuda.py, chip_smoke.py).

Inputs come from numpy seeds, float32 on both sides, B ≤ 8 jets of N = 16
slots and of N = 13 (not a multiple of 8). Tolerances: the trunk per particle
|err| ≤ 1e-5 + 1e-4·max|ref| over the particle's row (the 128-wide trunk's
outputs are sums of terms that cancel, tests/test_torch_wide.py); the heads
of a family's forward rtol = atol = 2e-4 relative to the head's largest value
(tests/test_ops/test_survival_pallas.py:86-88 at unit scale); the transdim
network's outputs 5e-4 likewise (tests/test_generative/test_transdimensional.py:258).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_particles_tpu.models.generative.states import AbsorbingBridgeState as JaxState
from multimodal_particles_tpu.models.generative.transdimensional import structure as jax_structure
from multimodal_particles_tpu.ops.epic_pallas import WEIGHT_NAMES
from multimodal_particles_tpu.ops.epic_pallas_wide import (
    epic_forward_pallas_wide,
    pack_wide_encoder_params as jax_pack_wide,
    pack_wide_encoder_params_fold_discrete as jax_pack_wide_fold,
)
from multimodal_particles_tpu_torch.models.generative.states import AbsorbingBridgeState
from multimodal_particles_tpu_torch.models.generative.transdimensional import structure
from multimodal_particles_tpu_torch.ops import epic_cuda, gsdm_stack_cuda, survival_cuda
from multimodal_particles_tpu_torch.ops.epic_wide_cuda import (
    MAX_WIDE_HEAD,
    check_wide_packing,
    epic_forward_wide,
)
from multimodal_particles_tpu_torch.ops.epic_wide_vjp_cuda import (
    epic_backward_wide,
    epic_train_forward_wide,
)
from torch_port_helpers import absorbing_pair, to_torch, transdim_pair

torch.backends.cuda.matmul.allow_tf32 = False
SCALED = {"num_blocks": 2, "dim_hidden_local": 128, "dim_hidden_glob": 128, "dim_emb_time": 128,
          "dim_emb_features_continuous": 128, "dim_emb_features_discrete": 128}
B = 6


def per_particle_close(got, ref, atol=1e-5, rtol=1e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    bound = atol + rtol * np.abs(ref).max(axis=-1, keepdims=True)
    assert got.shape == ref.shape
    assert (np.abs(got - ref) <= bound).all(), np.abs(got - ref).max()


def scale_close(got, ref, tol, name=""):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * max(np.abs(ref).max(), 1.0),
                               err_msg=name)


@pytest.fixture(scope="module", params=[16, 13], ids=["N16", "N13"])
def absorbing(request):
    return absorbing_pair(seed=5, n=request.param, b=B, sections={"encoder": SCALED})


@pytest.fixture(scope="module", params=[16, 13], ids=["N16", "N13"])
def transdim(request):
    return transdim_pair(seed=6, n=request.param, b=B, sections={"encoder": SCALED},
                         drawn_init=True)


def absorbing_state(batch, seed=2):
    """Random non-prefix masks, jet 0 empty, times in (0.05, 0.95)."""
    rng = np.random.default_rng(seed)
    b, n = batch.source_mask.shape[:2]
    mask = (rng.random((b, n, 1)) < 0.6).astype(np.int32)
    mask[0] = 0
    t = rng.uniform(0.05, 0.95, (b, 1, 1)).astype(np.float32)
    x = (np.asarray(batch.source_continuous) * mask).astype(np.float32)
    k = (np.asarray(batch.source_discrete) * mask).astype(np.int32)
    return t, x, k, mask


def transdim_inputs(batch, seed=1):
    """The list batch with noisy one-hot values, times and nearest atoms."""
    rng = np.random.default_rng(seed)
    n = batch[1].shape[1]
    noisy = [batch[0], batch[1], (batch[2] + 0.3 * rng.standard_normal(batch[2].shape).astype(
        np.float32)) * (batch[2].sum(-1, keepdims=True) > 0)]
    ts = rng.uniform(0.05, 1.0, B).astype(np.float32)
    nearest = np.minimum(rng.integers(0, n, B), noisy[0] - 1).astype(np.int32)
    return noisy, ts, nearest


# ------------------------------------------------------------------- K4


def test_wide_trunk_with_hidden_output_and_head_matches_pallas_interpret(absorbing):
    """K4's plain version as the scaled absorbing generator calls it (56-wide
    head, hidden output) against the interpret-mode wide kernel on the JAX
    packing of {epic, fc_layer: discrete_head_mlp} (absorbing_flows.py:220-222)."""
    jax_model, params, model, batch = absorbing
    cfg = jax_model.config
    t, x, k, mask = absorbing_state(batch)
    gen = params["generator"]
    packed_j = jax_pack_wide({"epic": gen["epic"], "fc_layer": gen["discrete_head_mlp"]},
                             cfg.encoder.num_blocks, 3)
    out_j, hid_j = epic_forward_pallas_wide(
        packed_j, jnp.asarray(t), jnp.asarray(x), jnp.asarray(k), jnp.asarray(mask, jnp.float32),
        num_blocks=2, use_skip=True, add_discrete_head=True, dim_c=3, vocab=8, hidden=128,
        dim_emb_time=128, output_hidden_local=True, interpret=True)
    trunk, _ = model.pack_for_kernel()
    assert trunk.layout == "wide" and trunk.dims.head_hidden == 56
    calls = epic_cuda.epic_forward_reference.calls
    out, hid = epic_forward_wide(trunk, *to_torch(t, x, k, mask.astype(np.float32)),
                                 output_hidden_local=True)
    assert epic_cuda.epic_forward_reference.calls == calls + 1  # CPU tensors: the plain version
    assert epic_forward_wide.launches == 0
    assert tuple(hid.shape) == (B, x.shape[1], 128)
    per_particle_close(out.numpy(), out_j)
    per_particle_close(hid.numpy(), hid_j)
    assert torch.equal(epic_forward_wide(trunk, *to_torch(t, x, k, mask.astype(np.float32))), out)


def test_wide_trunk_with_the_folded_input_matches_pallas_interpret(transdim):
    """K4's plain version as the scaled transdimensional network calls it
    (folded Linear-discrete input, no head, hidden output) against the
    interpret-mode wide kernel on `pack_wide_encoder_params_fold_discrete`,
    fed [x ‖ values] (transdimensional_model.py:360-404)."""
    jax_model, params, model, batch = transdim
    noisy, ts, _ = transdim_inputs(batch)
    state = structure.state_from_list_batch([torch.from_numpy(np.asarray(a)) for a in noisy])
    mask = state.particle_mask()[:, :, None].float()
    packed_j = jax_pack_wide_fold({"epic": params["network"]["epic"]}, 2, 3)
    x_in = np.concatenate([noisy[1], noisy[2]], axis=-1)
    n = x_in.shape[1]
    out_j, hid_j = epic_forward_pallas_wide(
        packed_j, jnp.asarray(ts).reshape(B, 1, 1), jnp.asarray(x_in),
        jnp.zeros((B, n, 1), jnp.int32), jnp.asarray(mask.numpy()), num_blocks=2, use_skip=True,
        add_discrete_head=False, dim_c=3, vocab=8, hidden=128, dim_emb_time=128,
        output_hidden_local=True, interpret=True, fold_discrete=True)
    trunk, _, _ = model.pack_for_kernel()
    assert trunk.layout == "wide" and trunk.dims.fold_discrete
    assert not trunk.dims.add_discrete_head
    out, hid = epic_forward_wide(trunk, torch.from_numpy(ts).reshape(B, 1, 1), state.continuous,
                                 state.discrete, mask, output_hidden_local=True)
    per_particle_close(out.numpy(), out_j)
    per_particle_close(hid.numpy(), hid_j)


def test_wide_packings_match_the_jax_packings_leaf_by_leaf(absorbing, transdim):
    """The absorbing trunk's wide buffer holds the JAX wide packing's arrays
    with the 56-wide head; the folded one holds the blocks of the JAX
    block-diagonal input Dense (x_emb ‖ k_emb), the table being the discrete
    Dense's (V, 128) matrix and b_k its bias."""
    _, params, model, _ = absorbing
    gen = params["generator"]
    ref = dict(zip(WEIGHT_NAMES, jax_pack_wide({"epic": gen["epic"],
                                                "fc_layer": gen["discrete_head_mlp"]}, 2)))
    trunk, _ = model.pack_for_kernel()
    for name, view in trunk.tensors.items():
        base, _, layer = name.rpartition("_")
        r = np.asarray(ref[base][int(layer)] if layer.isdigit() else ref[name])
        got = view.T if view.dim() == 2 and name != "table" else view
        np.testing.assert_allclose(got.numpy().reshape(r.shape), r, atol=1e-6, rtol=1e-6,
                                   err_msg=name)

    _, params, model, _ = transdim
    ref = dict(zip(WEIGHT_NAMES, jax_pack_wide_fold({"epic": params["network"]["epic"]}, 2)))
    trunk, _, _ = model.pack_for_kernel()
    w_fold, b_fold = np.asarray(ref["w_x"]), np.asarray(ref["b_x"]).reshape(-1)  # (3 + 8, 256)
    W = trunk.tensors
    np.testing.assert_allclose(W["w_x"].T.numpy(), w_fold[:3, :128], atol=1e-6)
    np.testing.assert_allclose(W["table"].numpy(), w_fold[3:, 128:], atol=1e-6)
    assert not w_fold[:3, 128:].any() and not w_fold[3:, :128].any()
    np.testing.assert_allclose(W["b_x"].numpy(), b_fold[:128], atol=1e-6)
    np.testing.assert_allclose(W["b_k"].numpy(), b_fold[128:], atol=1e-6)
    names = [name for name, _ in epic_cuda.wide_weight_layout(trunk.dims)]
    assert names.index("b_k") == names.index("table") + 1
    np.testing.assert_allclose(W["w_l0"].T.numpy(), np.asarray(ref["w_l0"]), atol=1e-6)


# --------------------------------------------------------- the two families


def test_scaled_absorbing_forward_sampling_matches_jax(absorbing):
    """`forward_sampling` through K4 (wide trunk, hidden output, 56-wide head)
    and K6 against the JAX one with `use_pallas=True` (interpret mode: the
    wide trunk kernel and the survival head kernel); each head within 2e-4
    of its scale, and within 2e-4 of the port's module path."""
    jax_model, params, model, batch = absorbing
    t, x, k, mask = absorbing_state(batch, seed=3)
    state_j = JaxState(jnp.asarray(t), jnp.asarray(x), jnp.asarray(k), jnp.asarray(mask))
    state = AbsorbingBridgeState(*to_torch(t, x, k, mask.astype(np.int64)))
    jax_model.config.parallel.use_pallas = model.config.parallel.use_pallas = True
    try:
        ref = jax_model.forward_sampling(params, state_j, batch)
        calls = epic_cuda.epic_forward_reference.calls, survival_cuda.survival_head_reference.calls
        got = model.forward_sampling(state)
        assert epic_cuda.epic_forward_reference.calls == calls[0] + 1
        assert survival_cuda.survival_head_reference.calls == calls[1] + 1
    finally:
        jax_model.config.parallel.use_pallas = model.config.parallel.use_pallas = "auto"
    with torch.no_grad():
        module = model.forward(state)
    for name in ("continuous", "discrete", "absorbing"):
        scale_close(getattr(got, name).numpy(), getattr(ref, name), 2e-4, name)
        scale_close(getattr(got, name).numpy(), getattr(module, name).numpy(), 2e-4, name)


def test_scaled_transdim_forward_kernel_matches_network_fused(transdim):
    """`forward_kernel` through K4 (folded input, hidden output) and K7 twice
    at stack inputs of 136 and 139 columns against `_network_fused` in
    interpret mode; 5e-4 of each output's scale."""
    jax_model, params, model, batch = transdim
    noisy, ts, nearest = transdim_inputs(batch, seed=3)
    ref = jax_model._network_fused(
        params["network"], jax_structure.state_from_list_batch([jnp.asarray(a) for a in noisy]),
        jnp.asarray(ts), jnp.asarray(nearest), False, None, interpret=True)
    state = structure.state_from_list_batch([torch.from_numpy(np.asarray(a)) for a in noisy])
    _, rate_stack, vec_stack = model.pack_for_kernel()
    assert (rate_stack.dim_in, vec_stack.dim_in) == (136, 139)
    calls = epic_cuda.epic_forward_reference.calls, gsdm_stack_cuda.gsdm_stack_reference.calls
    got = model.forward_kernel(state, torch.from_numpy(ts), torch.from_numpy(nearest).long())
    assert (epic_cuda.epic_forward_reference.calls,
            gsdm_stack_cuda.gsdm_stack_reference.calls) == (calls[0] + 1, calls[1] + 2)
    names = ["D_xt", "rate_emb", "near_atom_logits", "auto_mean", "auto_std"]
    for name, g, r in zip(names, got, ref):
        scale_close(g.numpy(), r, 5e-4, name)
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(ref[5]))


# ------------------------------------------------------------- refusals


def test_wide_wrappers_take_and_refuse_the_new_packings(absorbing, transdim):
    """On `meta` tensors (checked as CUDA tensors are): the wide forward takes
    the 56-wide head and the folded input and refuses a head wider than
    MAX_WIDE_HEAD and tokens where the values belong; the wide backward (K5)
    refuses both packings, as the JAX package's wide VJP has no such form."""
    trunk, _ = absorbing[2].pack_for_kernel()
    fold, _, _ = transdim[2].pack_for_kernel()
    check_wide_packing(trunk, any_head_width=True)
    check_wide_packing(fold, any_head_width=True)
    assert MAX_WIDE_HEAD == 512  # K4 takes heads up to 512 wide
    meta = dict(device="meta")
    t, x = torch.empty((4, 1, 1), **meta), torch.empty((4, 16, 3), **meta)
    mask, g = torch.empty((4, 16, 1), **meta), torch.empty((4, 16, 11), **meta)
    tokens = torch.empty((4, 16, 1), dtype=torch.int64, **meta)
    values = torch.empty((4, 16, 8), **meta)
    wider = dataclasses.replace(trunk, dims=dataclasses.replace(trunk.dims,
                                                                head_hidden=MAX_WIDE_HEAD + 1))
    for packed in (trunk, fold, wider):
        packed.flat = packed.flat.to("meta")
    with pytest.raises(ValueError, match="head width"):
        epic_forward_wide(wider, t, x, tokens, mask)
    with pytest.raises(ValueError, match=r"\(4, 16, 8\)"):
        epic_forward_wide(fold, t, x, tokens, mask)
    with pytest.raises(ValueError, match="hidden width 8"):
        epic_backward_wide(trunk, t, x, tokens, mask, g)
    with pytest.raises(ValueError, match="hidden width 8"):
        epic_train_forward_wide(trunk, t, x, tokens, mask)
    with pytest.raises(ValueError, match="folded"):
        epic_backward_wide(fold, t, x, values, mask, g)
    # past the checks the wrapper builds the library, which needs nvcc
    with pytest.raises(RuntimeError, match="nvcc"):
        epic_forward_wide(fold, t, x, values, mask, output_hidden_local=True)
