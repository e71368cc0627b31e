"""The absorbing family of the PyTorch/CUDA port against the JAX package on
the CPU: the config mirror, the trunk's hidden output, the plain version of
the extended EPiC kernel (56-wide discrete head, hidden output) against the
interpret-mode Pallas kernel, the absorbing bridge, `forward`,
`forward_sampling`, `loss_fn` with every gradient, a short `simulate_dynamics`,
the kernel gate, the transplant and the trainer.

Draws are made with jax.random exactly as the JAX functions make them (same
keys, same splits) and injected into the port. float32 on both sides; heads
rtol = atol = 2e-4 (tests/test_ops/test_survival_pallas.py:86-88); gradients
per leaf |err| ≤ 1e-4·max|ref leaf| + 1e-3·|ref|; masks and tokens of a
sampled trajectory may differ on at most 1% of slots, where a uniform falls
within rounding of its threshold (as tests/test_torch_sampler.py allows).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_particles_tpu.config_classes import absorbing_flows_config as jax_cfg
from multimodal_particles_tpu.models.architectures.epic import EPiCWrapper as JaxEPiCWrapper
from multimodal_particles_tpu.models.generative import bridges as jb
from multimodal_particles_tpu.models.generative.states import AbsorbingBridgeState as JaxState
from multimodal_particles_tpu.models.generative.states import OutputHeads as JaxHeads
from multimodal_particles_tpu.ops.epic_pallas import epic_forward_pallas
from multimodal_particles_tpu.ops.epic_pallas import pack_mbm_encoder_params as jax_pack
from multimodal_particles_tpu_torch import config_classes as port_cfg
from multimodal_particles_tpu_torch.data import (
    InMemoryDataModule,
    MultimodalDatabatch,
    absorbing_training_batch,
)
from multimodal_particles_tpu_torch.models.generative import bridges as tb
from multimodal_particles_tpu_torch.models.generative.absorbing.absorbing_flows import (
    AbsorbingFlow,
)
from multimodal_particles_tpu_torch.models.generative.init import init_absorbing_parameters
from multimodal_particles_tpu_torch.models.generative.states import (
    AbsorbingBridgeState,
    OutputHeads,
)
from multimodal_particles_tpu_torch.ops import epic_cuda, survival_cuda
from multimodal_particles_tpu_torch.ops.epic_vjp_cuda import epic_backward
from multimodal_particles_tpu_torch.ops.epic_wide_cuda import check_wide_packing, wide_supported
from multimodal_particles_tpu_torch.ops.sampler_cuda import sampler_step
from multimodal_particles_tpu_torch.training.trainer import Trainer
from multimodal_particles_tpu_torch.utils.transplant import params_from_flax
from torch_port_helpers import B, N, absorbing_pair, to_torch

torch.backends.cuda.matmul.allow_tf32 = False
TOL = dict(rtol=2e-4, atol=2e-4)
MAX_MISMATCH = 0.01
GAMMA = 0.125


@pytest.fixture(scope="module")
def pair():
    return absorbing_pair(seed=0)


def torch_batch(batch) -> MultimodalDatabatch:
    return MultimodalDatabatch(**{
        f.name: torch.from_numpy(np.array(getattr(batch, f.name)))
        for f in dataclasses.fields(MultimodalDatabatch) if getattr(batch, f.name, None) is not None})


def sampled_state(batch, seed=2):
    """A state as the sampler sees it: random non-prefix masks, jet 0 empty."""
    rng = np.random.default_rng(seed)
    b, n = batch.source_mask.shape[:2]
    mask = (rng.random((b, n, 1)) < 0.6).astype(np.int32)
    mask[0] = 0
    t = rng.uniform(0.05, 0.95, (b, 1, 1)).astype(np.float32)
    x = np.asarray(batch.source_continuous) * mask
    k = (np.asarray(batch.source_discrete) * mask).astype(np.int32)
    return t, x.astype(np.float32), k, mask


# ------------------------------------------------------------------- config


@pytest.mark.parametrize("ours,theirs", [
    (port_cfg.AbsorbingJetsDataConfig, jax_cfg.JetsDataConfig),
    (port_cfg.AbsorbingBridgeConfig, jax_cfg.BridgeConfig),
    (port_cfg.GeneratorsHeadConfig, jax_cfg.GeneratorsHeadConfig),
    (port_cfg.AbsorbingConfig, jax_cfg.AbsorbingConfig),
])
def test_absorbing_config_mirror_matches_jax_dataclasses(ours, theirs):
    """Same field names in the same order, and equal defaults all the way down."""
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


def test_absorbing_config_from_dict_round_trip():
    cfg = jax_cfg.AbsorbingConfig()
    cfg.bridge.death_rate_scale, cfg.generator.n_heads, cfg.data.max_num_particles = 0.5, 4, 64
    ours = port_cfg.AbsorbingConfig.from_dict({**cfg.to_dict(), "unknown_section": {"a": 1}})
    assert dataclasses.asdict(ours) == cfg.to_dict()


# -------------------------------------------------------------------- trunk


def test_epic_wrapper_hidden_output_matches_flax(pair):
    """EPiCWrapper(output_hidden_local=True) → (heads·mask, last local state);
    atol 1e-5."""
    jax_model, params, model, batch = pair
    t, x, k, mask = sampled_state(batch)
    out_j, hid_j = JaxEPiCWrapper(jax_model.config).apply(
        {"params": params["generator"]["epic"]}, jnp.asarray(t), jnp.asarray(x), jnp.asarray(k),
        jnp.asarray(mask, jnp.float32), None, None, True)
    with torch.no_grad():
        out, hid = model.generator.epic(*to_torch(t, x, k, mask.astype(np.float32)),
                                        output_hidden_local=True)
        only = model.generator.epic(*to_torch(t, x, k, mask.astype(np.float32)))
    assert tuple(hid.shape) == (B, N, 16) and torch.equal(only, out)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hid.numpy(), np.asarray(hid_j), rtol=1e-4, atol=1e-5)


def test_plain_epic_forward_with_hidden_and_wide_head_matches_pallas(pair):
    """The plain version of the extended EPiC kernel, packed as the absorbing
    family packs it (the generator's 56-wide `discrete_head_mlp` as the
    discrete head), against `epic_forward_pallas(output_hidden_local=True)` in
    interpret mode (absorbing_flows.py:220-242): the 11 outputs and the
    (B, N, 16) hidden state, atol 1e-5 / rtol 1e-4."""
    jax_model, params, model, batch = pair
    cfg = jax_model.config
    t, x, k, mask = sampled_state(batch)
    gen_params = params["generator"]
    packed_j = jax_pack({"epic": gen_params["epic"], "fc_layer": gen_params["discrete_head_mlp"]},
                        cfg.encoder.num_blocks, 3)
    out_j, hid_j = epic_forward_pallas(
        packed_j, jnp.asarray(t), jnp.asarray(x), jnp.asarray(k), jnp.asarray(mask, jnp.float32),
        num_blocks=cfg.encoder.num_blocks, use_skip=True, add_discrete_head=True, dim_c=3,
        vocab=8, hidden=16, dim_emb_time=16, output_hidden_local=True, interpret=True)
    trunk, _ = model.pack_for_kernel()
    assert trunk.dims.head_hidden == 56
    assert tuple(trunk.tensors["w_h0"].shape) == (56, 8)
    assert tuple(trunk.tensors["w_h1"].shape) == (8, 56)
    calls = epic_cuda.epic_forward_reference.calls
    out, hid = epic_cuda.epic_forward(trunk, *to_torch(t, x, k, mask.astype(np.float32)),
                                      output_hidden_local=True)
    assert epic_cuda.epic_forward_reference.calls == calls + 1  # CPU tensors: the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hid.numpy(), np.asarray(hid_j), rtol=1e-4, atol=1e-5)
    # the same function without the third output returns the first alone
    assert torch.equal(epic_cuda.epic_forward(trunk, *to_torch(t, x, k, mask.astype(np.float32))), out)


def test_c_dims_carry_the_head_width(pair):
    trunk, _ = pair[2].pack_for_kernel()
    assert list(trunk.dims.c_array()) == [16, 16, 16, 16, 16, 2, 1, 1, 56, 0]
    assert list(epic_cuda.EpicDims.from_config(pair[2].config).c_array())[-2:] == [8, 0]


def test_other_kernels_refuse_a_head_width_they_do_not_support(pair):
    """The packed layout shifts with the head's width: the sampler step, the
    backward kernel and the wide kernels are written for 8 and raise for 56
    before anything reads the buffer; only the forward kernel takes it."""
    model = pair[2]
    trunk, _ = model.pack_for_kernel()
    t, x, k, mask = (a.to("meta") for a in to_torch(*sampled_state(pair[3])))
    mask = mask.float()
    trunk.flat = trunk.flat.to("meta")
    u = torch.empty((2, B, N), device="meta")
    with pytest.raises(ValueError, match="hidden width 8"):
        sampler_step(trunk, x, k, mask, u, 0.5, 0.01, gamma=GAMMA)
    with pytest.raises(ValueError, match="hidden width 8"):
        epic_backward(trunk, t, x, k, mask, torch.empty((B, N, 11), device="meta"))
    with pytest.raises(ValueError, match="hidden width 8"):
        wide_dims = dataclasses.replace(trunk.dims, hidden=128, hidden_glob=128, emb_t=128,
                                        emb_x=128, emb_k=128)
        check_wide_packing(dataclasses.replace(trunk, layout="wide", dims=wide_dims))
    epic_cuda.check_narrow_packing(trunk, any_head_width=True)
    with pytest.raises(ValueError, match="head width"):
        epic_cuda.check_narrow_packing(
            dataclasses.replace(trunk, dims=dataclasses.replace(trunk.dims, head_hidden=0)),
            any_head_width=True)


# ------------------------------------------------------------------ bridges


def test_absorbing_closed_forms_match_jax():
    """Survival probability, birth rate and death hazard; 1e-6."""
    rng = np.random.default_rng(5)
    t = rng.random((B, 1, 1), dtype=np.float32)
    t[0], t[1] = 0.0, 1.0 - 1e-4
    logits = rng.standard_normal((B, N, 1)).astype(np.float32) * 3
    tt, lt = to_torch(t, logits)
    np.testing.assert_allclose(tb.absorbing_survival_probability(tt, GAMMA).numpy(),
                               np.asarray(jb.absorbing_survival_probability(jnp.asarray(t), GAMMA)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tb.absorbing_rate(tt, None, lt, GAMMA).numpy(),
                               np.asarray(jb.absorbing_rate(jnp.asarray(t), None, jnp.asarray(logits), GAMMA)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tb.absorbing_death_hazard(tt, GAMMA).numpy(),
                               np.asarray(jb.absorbing_death_hazard(jnp.asarray(t), GAMMA)),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("dropout", [0.0, 0.4])
def test_absorbing_sample_matches_jax_with_its_uniforms(dropout):
    """The mask at time t with JAX's own uniforms (drawn with the keys the JAX
    function uses); exact but for slots whose uniform is within rounding of
    the survival probability."""
    rng = np.random.default_rng(6)
    t = rng.random((B, 1, 1), dtype=np.float32)
    target = (rng.random((B, N, 1)) < 0.5).astype(np.int32)
    key = jax.random.PRNGKey(21)
    ref = np.asarray(jb.absorbing_sample(key, jnp.asarray(t), jnp.asarray(target), GAMMA, dropout))
    u_drop = None
    if dropout > 0:
        key, key_drop = jax.random.split(key)
        u_drop = torch.from_numpy(np.array(jax.random.uniform(key_drop, target.shape)))
    u = torch.from_numpy(np.array(jax.random.uniform(key, target.shape)))
    got = tb.absorbing_sample(*to_torch(t, target), GAMMA, u, dropout, u_drop).numpy()
    assert got.shape == ref.shape and (got != ref).mean() <= MAX_MISMATCH
    assert 0.1 < got.mean() < 0.95
    if dropout > 0:  # some target slots were dropped
        assert (got[target > 0] == 0).any()
    else:
        assert (got[target > 0] == 1).all()


@pytest.mark.parametrize("deaths", [False, True])
def test_absorbing_step_matches_jax_with_its_uniforms(deaths):
    rng = np.random.default_rng(7)
    mask = (rng.random((B, N, 1)) < 0.5).astype(np.int32)
    rates = (rng.random((B, N, 1)) * 40).astype(np.float32)
    death_rates = (rng.random((B, N, 1)) * 40).astype(np.float32) if deaths else None
    dt = 0.01
    key = jax.random.PRNGKey(22)
    ref = np.asarray(jb.absorbing_step(key, jnp.asarray(mask), jnp.asarray(rates), dt,
                                       None if death_rates is None else jnp.asarray(death_rates)))
    u_d = None
    if deaths:
        key, key_d = jax.random.split(key)
        u_d = torch.from_numpy(np.array(jax.random.uniform(key_d, mask.shape)))
    u = torch.from_numpy(np.array(jax.random.uniform(key, mask.shape)))
    got = tb.absorbing_step(*to_torch(mask, rates), dt, u,
                            None if death_rates is None else torch.from_numpy(death_rates), u_d)
    assert got.dtype == torch.int32
    assert (got.numpy() != ref).mean() <= MAX_MISMATCH
    born = (got.numpy() == 1) & (mask == 0)
    assert born.any() and (deaths or (got.numpy()[mask > 0] == 1).all())
    assert not deaths or ((got.numpy() == 0) & (mask > 0)).any()


@pytest.mark.parametrize("scale", [0.0, 0.7])
def test_absorbing_bridge_solver_step_matches_jax(scale):
    """AbsorbingBridge.solver_step with and without the death channel."""
    rng = np.random.default_rng(8)
    t = np.full((B, 1, 1), 0.6, np.float32)
    mask = (rng.random((B, N, 1)) < 0.5).astype(np.int32)
    logits = rng.standard_normal((B, N, 1)).astype(np.float32) * 2
    dt = 0.2
    key = jax.random.PRNGKey(23)
    ref = jb.AbsorbingBridge(GAMMA, 1e-4, death_rate_scale=scale).solver_step(
        key, JaxState(time=jnp.asarray(t), mask_t=jnp.asarray(mask)),
        JaxHeads(absorbing=jnp.asarray(logits)), dt)
    bridge = tb.AbsorbingBridge(GAMMA, death_rate_scale=scale)
    draws = []
    if scale > 0:
        key, key_d = jax.random.split(key)
        draws.append(torch.from_numpy(np.array(jax.random.uniform(key_d, mask.shape))))
    draws.insert(0, torch.from_numpy(np.array(jax.random.uniform(key, mask.shape))))
    assert len(draws) == bridge.step_draws
    tt, mt, lt = to_torch(t, mask, logits)
    got = bridge.solver_step(AbsorbingBridgeState(time=tt, mask_t=mt),
                             OutputHeads(absorbing=lt), dt, *draws)
    assert (got.mask_t.numpy() != np.asarray(ref.mask_t)).mean() <= MAX_MISMATCH


def test_solver_steps_take_the_states_mask_when_not_multimodal():
    """multimodal=False masks with `state.mask_t` (bridges.py:392, :470)."""
    rng = np.random.default_rng(9)
    x, drift = (rng.standard_normal((B, N, 3)).astype(np.float32) for _ in range(2))
    k = rng.integers(0, 8, (B, N, 1))
    logits = rng.standard_normal((B, N, 8)).astype(np.float32)
    mask = (rng.random((B, N, 1)) < 0.5).astype(np.int64)
    t = np.full((B, 1, 1), 0.3, np.float32)
    state = AbsorbingBridgeState(*to_torch(t, x, k, mask))
    heads = OutputHeads(*to_torch(drift, logits), absorbing=torch.zeros((B, N, 1)))
    ref = jb.LinearUniformBridge(1e-4).solver_step(
        None, JaxState(jnp.asarray(t), jnp.asarray(x), jnp.asarray(k), jnp.asarray(mask)),
        JaxHeads(jnp.asarray(drift), jnp.asarray(logits), jnp.zeros((B, N, 1))), 0.01,
        multimodal=False)
    got = tb.LinearUniformBridge(1e-4).solver_step(state, heads, 0.01, multimodal=False)
    np.testing.assert_allclose(got.continuous.numpy(), np.asarray(ref.continuous), atol=1e-6)
    u = torch.from_numpy(rng.random((2, B, N), dtype=np.float32))
    tokens = tb.TelegraphBridge(GAMMA, 8).solver_step(state, heads, 0.01, u, multimodal=False)
    assert (tokens.discrete.numpy()[mask == 0] == 0).all() and tokens.discrete.numpy().any()
    assert tb.LinearUniformBridge(1e-4).solver_step(state, heads, 0.01).continuous.abs().max() == 0


def test_absorbing_state_cat():
    a = AbsorbingBridgeState(torch.zeros(2, 1, 1), torch.ones(2, 3, 3), None, torch.ones(2, 3, 1))
    both = AbsorbingBridgeState.cat([a, a.replace(time=torch.ones(2, 1, 1))])
    assert tuple(both.time.shape) == (4, 1, 1) and both.discrete is None
    assert tuple(both.mask_t.shape) == (4, 3, 1) and both.time[2:].eq(1).all()


# ------------------------------------------------------------------ forward


@pytest.mark.parametrize("n,b", [(16, B), (109, B), (200, 2)])
def test_forward_and_forward_sampling_match_jax_head_by_head(n, b):
    """`forward` against the flax forward, and `forward_sampling` (CPU: the
    kernels' plain versions) against the JAX one with `use_pallas=True`
    (interpret mode), each head within rtol = atol = 2e-4. Past 128 slots
    (K6 as two row blocks a jet on the card) at 2 jets, the weights drawn on
    flax's parameter tree (`drawn_init`: flax's eager init compiles each
    operation anew at every new shape)."""
    jax_model, params, model, batch = absorbing_pair(seed=3, n=n, b=b, drawn_init=n > 128)
    t, x, k, mask = sampled_state(batch)
    state_j = JaxState(jnp.asarray(t), jnp.asarray(x), jnp.asarray(k), jnp.asarray(mask))
    state = AbsorbingBridgeState(*to_torch(t, x, k, mask.astype(np.int64)))
    heads_j = jax_model.forward(params, state_j, batch)
    with torch.no_grad():
        heads = model.forward(state)
    for name in ("continuous", "discrete", "absorbing"):
        np.testing.assert_allclose(getattr(heads, name).numpy(), np.asarray(getattr(heads_j, name)),
                                   err_msg=name, **TOL)
    assert tuple(heads.absorbing.shape) == (b, n, 1)

    jax_model.config.parallel.use_pallas = model.config.parallel.use_pallas = True
    calls = epic_cuda.epic_forward_reference.calls, survival_cuda.survival_head_reference.calls
    sampled_j = jax_model.forward_sampling(params, state_j, batch)
    sampled = model.forward_sampling(state)
    assert epic_cuda.epic_forward_reference.calls == calls[0] + 1
    assert survival_cuda.survival_head_reference.calls == calls[1] + 1
    for name in ("continuous", "discrete", "absorbing"):
        np.testing.assert_allclose(getattr(sampled, name).numpy(),
                                   np.asarray(getattr(sampled_j, name)), err_msg=name, **TOL)


def test_kernel_gate(pair):
    """`use_pallas` False → module path; 'auto' → off on the CPU;
    transformer_dim 96 or a model axis → off even when forced; a trunk at
    every width 128 packs for the wide kernel (K4) with the 56-wide head."""
    model = pair[2]
    cfg = model.config
    try:
        for flag, expect in ((False, False), ("auto", False), (True, True)):
            cfg.parallel.use_pallas = flag
            assert model._pallas_enabled("cpu") is expect
        cfg.parallel.use_pallas = "auto"
        assert model._pallas_enabled("cuda") and model._pallas_enabled(torch.device("cuda", 0))
        cfg.parallel.use_pallas = True
        cfg.parallel.model_axis = 2
        assert not model._pallas_enabled("cuda")
        cfg.parallel.model_axis = 1
        cfg.generator.transformer_dim = 96
        assert not model._pallas_enabled("cuda")
    finally:
        cfg.parallel.use_pallas, cfg.parallel.model_axis = "auto", 1
        cfg.generator.transformer_dim = 128

    # gate off: forward_sampling is the module forward and calls no plain kernel version
    t, x, k, mask = sampled_state(pair[3])
    state = AbsorbingBridgeState(*to_torch(t, x, k, mask.astype(np.int64)))
    calls = epic_cuda.epic_forward_reference.calls, survival_cuda.survival_head_reference.calls
    with torch.no_grad():
        assert torch.equal(model.forward_sampling(state).absorbing, model.forward(state).absorbing)
    assert (epic_cuda.epic_forward_reference.calls,
            survival_cuda.survival_head_reference.calls) == calls

    wide = port_cfg.AbsorbingConfig()
    e = wide.encoder
    e.dim_hidden_local = e.dim_hidden_glob = e.dim_emb_time = 128
    e.dim_emb_features_continuous = e.dim_emb_features_discrete = 128
    wide.parallel.use_pallas = True
    wide_model = AbsorbingFlow(wide)
    assert wide_model._pallas_enabled("cuda")
    trunk, head = wide_model.pack_for_kernel()
    assert trunk.layout == "wide" and trunk.dims.head_hidden == 56 and head.dim_hidden == 128
    check_wide_packing(trunk, any_head_width=True)
    wide.parallel.use_pallas = False
    assert not wide_model._pallas_enabled("cuda")  # the module path stays open
    # a head wider than K4 takes (512): the module trunk, then the fused head
    assert wide_supported(wide, head_hidden=512) and not wide_supported(wide, head_hidden=513)
    wide.parallel.use_pallas = True
    wide.generator.discrete_head_hidden_dim = 96  # past the 64 of K4's width-128 kernel
    trunk, head = AbsorbingFlow(wide).pack_for_kernel()
    assert trunk.layout == "wide" and trunk.dims.head_hidden == 96 and head.dim_hidden == 128
    wide.generator.discrete_head_hidden_dim = 513
    trunk, head = AbsorbingFlow(wide).pack_for_kernel()
    assert trunk is None and head.dim_hidden == 128

    # a trunk no kernel takes (hidden 65, past the narrow kernels' 64; hidden 48
    # is K1's since its instance at 48): the module trunk, then the fused head
    odd = port_cfg.AbsorbingConfig()
    odd.encoder.dim_hidden_local = 65
    odd.parallel.use_pallas = True
    trunk, head = AbsorbingFlow(odd).pack_for_kernel()
    assert trunk is None and head.dim_hidden == 65


@pytest.mark.parametrize("field,value", [("compute_dtype", "bfloat16")])
def test_unported_switches_raise(field, value):
    """bfloat16, once refused, builds and casts the module forward
    (tests/test_torch_bf16.py holds it against JAX); an unknown dtype name and
    the Schrödinger bridge, which the JAX family does not take, raise."""
    cfg = port_cfg.AbsorbingConfig()
    cfg.data.max_num_particles = N
    setattr(cfg.parallel, field, value)
    model = init_absorbing_parameters(AbsorbingFlow(cfg), 0)
    state = AbsorbingBridgeState(*to_torch(*sampled_state(absorbing_training_batch(
        B, N, 3, 8, torch.Generator().manual_seed(0)))))
    state = state.replace(mask_t=state.mask_t.long())
    with torch.no_grad():
        heads = model.forward(state)
    assert all(h.dtype == torch.float32 and torch.isfinite(h).all()
               for h in (heads.continuous, heads.discrete, heads.absorbing))
    setattr(cfg.parallel, field, "float16")
    with pytest.raises(KeyError):
        AbsorbingFlow(cfg)
    cfg = port_cfg.AbsorbingConfig()
    cfg.bridge.continuous = "SchrodingerBridge"
    with pytest.raises(NotImplementedError):
        AbsorbingFlow(cfg)


# --------------------------------------------------------------------- loss


def jax_draws(jax_model, key, batch):
    """The draws of `AbsorbingFlow.sample_bridges` (absorbing_flows.py:291-307),
    made with its keys: (t01, z, u_k, u_m[, u_drop])."""
    key_t, key_x, key_k, key_m = jax.random.split(key, 4)
    b, n = batch.target_mask.shape[:2]
    draws = [jax.random.uniform(key_t, (b,), dtype=jnp.float32),
             jax.random.normal(key_x, batch.target_continuous.shape, dtype=jnp.float32),
             jax.random.uniform(key_k, (b, n), dtype=jnp.float32)]
    if jax_model.bridge_absorbing.target_dropout > 0:
        key_m, key_drop = jax.random.split(key_m)
        draws += [jax.random.uniform(key_m, (b, n, 1)), jax.random.uniform(key_drop, (b, n, 1))]
    else:
        draws.append(jax.random.uniform(key_m, (b, n, 1)))
    return tuple(torch.from_numpy(np.array(d)) for d in draws)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_sample_bridges_matches_jax(dropout):
    jax_model, _, model, batch = absorbing_pair(seed=4, sections={"bridge": {"target_dropout": dropout}})
    key = jax.random.PRNGKey(31)
    ref = jax_model.sample_bridges(key, batch)
    got = model.sample_bridges(torch_batch(batch), draws=jax_draws(jax_model, key, batch))
    np.testing.assert_allclose(got.time.numpy(), np.asarray(ref.time), atol=1e-6)
    np.testing.assert_allclose(got.continuous.numpy(), np.asarray(ref.continuous), atol=1e-6)
    assert (got.discrete.numpy() != np.asarray(ref.discrete)).mean() <= MAX_MISMATCH
    assert (got.mask_t.numpy() != np.asarray(ref.mask_t)).mean() <= MAX_MISMATCH
    assert float(got.time.min()) >= model.min_t


@pytest.mark.parametrize("detach", [True, False])
def test_loss_fn_and_every_gradient_match_jax(detach):
    """Every loss term (1e-4 relative) and the gradient of every parameter
    against jax.grad, with `detach_last_layer` on (the trunk gets no gradient
    from the survival head) and off."""
    jax_model, params, model, batch = absorbing_pair(
        seed=5, sections={"generator": {"detach_last_layer": detach}})
    key = jax.random.PRNGKey(32)
    (loss_j, metrics_j), grads_j = jax.value_and_grad(jax_model.loss_fn, has_aux=True)(
        params, key, batch)
    loss, metrics = model.loss_fn(torch_batch(batch), draws=jax_draws(jax_model, key, batch))
    loss.backward()
    assert set(metrics) == set(metrics_j) == {"loss", "loss_continuous", "loss_discrete",
                                              "loss_absorbing"}
    for name, value in metrics.items():
        np.testing.assert_allclose(value.item(), float(metrics_j[name]), rtol=1e-4, err_msg=name)
    grads_np = jax.tree_util.tree_map(np.asarray, grads_j)
    ref = params_from_flax(grads_np, model.config, AbsorbingFlow)
    assert set(ref) == set(dict(model.named_parameters()))
    for name, p in model.named_parameters():
        r = ref[name].numpy()
        if name.endswith(".k.bias"):
            # a key bias shifts every score of a row alike, which the softmax
            # cancels: its gradient is 0, and both sides hold rounding noise
            assert np.abs(r).max() < 1e-6 and p.grad.abs().max() < 1e-6, name
            continue
        scale = max(float(np.abs(r).max()), 1e-6)
        np.testing.assert_allclose(p.grad.numpy(), r, atol=1e-4 * scale, rtol=1e-3, err_msg=name)
    assert model.loss_weights.grad.abs().min() > 0 and model.loss_weights.numel() == 3


def test_losses_are_not_masked(pair):
    """MSE and CE are sums over all N slots, dead ones included; BCE is a mean
    over B·N (absorbing_flows.py:311-341)."""
    model, batch = pair[2], torch_batch(pair[3])
    rng = np.random.default_rng(10)
    heads = OutputHeads(*to_torch(rng.standard_normal((B, N, 3)).astype(np.float32),
                                  rng.standard_normal((B, N, 8)).astype(np.float32),
                                  rng.standard_normal((B, N, 1)).astype(np.float32)))
    state = AbsorbingBridgeState(torch.full((B, 1, 1), 0.5), batch.source_continuous,
                                 batch.source_discrete, torch.zeros((B, N, 1), dtype=torch.long))
    ut = batch.target_continuous - batch.source_continuous
    expected = ((heads.continuous - ut) ** 2).sum() / (B * 3)
    np.testing.assert_allclose(model.loss_continuous(heads, state, batch).item(), expected.item(),
                               rtol=1e-5)
    ce = torch.nn.functional.cross_entropy(heads.discrete.reshape(-1, 8),
                                           batch.target_discrete.reshape(-1).long(), reduction="sum") / B
    np.testing.assert_allclose(model.loss_discrete(heads, batch).item(), ce.item(), rtol=1e-5)
    bce = torch.nn.functional.binary_cross_entropy_with_logits(
        heads.absorbing.reshape(-1), batch.target_mask.reshape(-1).float())
    np.testing.assert_allclose(model.loss_absorbing(heads, batch).item(), bce.item(), rtol=1e-5)


# ----------------------------------------------------------------- sampling


def jax_step_uniforms(key, steps, b, n, deaths):
    """The uniforms of `simulate_dynamics`' scan (absorbing_flows.py:369-383),
    by replaying its key splits: per step births, [deaths,] telegraph's two."""
    out = []
    for _ in range(steps):
        key, key_m, key_k = jax.random.split(key, 3)
        rows = []
        if deaths:
            key_m, key_d = jax.random.split(key_m)
            rows.append(jax.random.uniform(key_d, (b, n, 1))[..., 0])
        rows.insert(0, jax.random.uniform(key_m, (b, n, 1))[..., 0])
        rows += list(jax.random.uniform(key_k, (2, b, n), dtype=jnp.float32))
        out.append(np.stack([np.asarray(r) for r in rows]))
    return torch.from_numpy(np.stack(out))


@pytest.mark.parametrize("death_scale,use_pallas", [(0.0, True), (0.0, False), (0.8, True)])
def test_simulate_dynamics_matches_jax(death_scale, use_pallas):
    """8 timesteps (7 steps) from the source batch with JAX's uniforms, on the
    kernel path (plain versions here, interpret mode there) and the module
    path, with and without the death channel: masks and tokens differ on at
    most 1% of slots, kinematics within 1e-3 on the slots whose masks agree."""
    jax_model, params, model, batch = absorbing_pair(
        seed=6, sections={"bridge": {"death_rate_scale": death_scale},
                          "parallel": {"use_pallas": use_pallas}})
    key = jax.random.PRNGKey(33)
    ref = jax_model.predict(params, batch, key)
    uniforms = jax_step_uniforms(key, 7, B, N, death_scale > 0)
    assert uniforms.shape[1] == model.step_draws
    calls = survival_cuda.survival_head_reference.calls
    got = model.predict(torch_batch(batch), uniforms=uniforms)
    assert survival_cuda.survival_head_reference.calls == calls + (7 if use_pallas else 0)
    mask_ref, mask_got = np.asarray(ref.mask_t), got.mask_t.numpy()
    assert (mask_got != mask_ref).mean() <= MAX_MISMATCH
    assert (got.discrete.numpy() != np.asarray(ref.discrete)).mean() <= MAX_MISMATCH
    same = (mask_got == mask_ref)[..., 0]
    np.testing.assert_allclose(got.continuous.numpy()[same], np.asarray(ref.continuous)[same],
                               rtol=1e-3, atol=1e-3)
    source = np.asarray(batch.source_mask)
    assert (got.continuous.numpy()[mask_got[..., 0] == 0] == 0).all()
    assert (got.discrete.numpy()[mask_got == 0] == 0).all()
    if death_scale == 0:
        assert mask_got.sum() > source.sum()  # slots were born
        assert (mask_got[source > 0] == 1).all()  # birth-only: no source slot dies
    else:
        assert (mask_got[source > 0] == 0).any()


def test_predict_draws_from_the_generator(pair):
    """Without injected uniforms a step draws (step_draws, B, N) from the
    caller's generator: the same seed gives the same jets."""
    model, batch = pair[2], torch_batch(pair[3])
    a = model.predict(batch, generator=torch.Generator().manual_seed(3))
    b = model.predict(batch, generator=torch.Generator().manual_seed(3))
    c = model.predict(batch, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a.mask_t, b.mask_t) and torch.equal(a.continuous, b.continuous)
    assert not torch.equal(a.mask_t, c.mask_t)
    assert a.mask_t.dtype == torch.int64 and model.step_draws == 3
    times, dt = model.time_grid()
    assert len(times) == 8 and abs(dt - (1 - 1e-4) / 7) < 1e-7


# ------------------------------------------------- transplant, init, trainer


def test_transplant_round_trip(pair):
    """Every flax leaf lands in the port's state_dict with its shape (Dense
    kernels transposed, GroupNorm scale → weight), and a missing or an
    unknown leaf raises."""
    jax_model, params, model, _ = pair
    params_np = jax.tree_util.tree_map(np.asarray, params)
    state = params_from_flax(params_np, model.config, AbsorbingFlow)
    assert set(state) == set(model.state_dict())
    gen = params_np["generator"]
    np.testing.assert_array_equal(state["generator.res_block_1.norm2.weight"].numpy(),
                                  gen["res_block_1"]["norm2"]["scale"])
    np.testing.assert_array_equal(state["generator.attn_block_0.proj_out.weight"].numpy(),
                                  gen["attn_block_0"]["proj_out"]["kernel"].T)
    np.testing.assert_array_equal(state["generator.discrete_head_mlp.2.bias"].numpy(),
                                  gen["discrete_head_mlp"]["layers_2"]["bias"])
    assert tuple(state["generator.transformer_1_proj_in.weight"].shape) == (128, 18)
    assert tuple(state["loss_weights"].shape) == (3,)
    n_leaves = len(jax.tree_util.tree_leaves(params_np))
    assert n_leaves == len(state) == sum(1 for _ in model.parameters())
    broken = {**params_np, "generator": {k: v for k, v in gen.items() if k != "temb_net"}}
    with pytest.raises(KeyError):
        params_from_flax(broken, model.config, AbsorbingFlow)
    with pytest.raises(KeyError):
        params_from_flax({**params_np, "extra": np.zeros(3)}, model.config, AbsorbingFlow)


def test_init_absorbing_parameters_follows_flax_laws(pair):
    """Same shapes and the same laws as flax's initialiser: GroupNorm scale 1
    and bias 0, Dense bias 0, loss_weights 0, Dense kernels lecun-normal
    (std ≈ 1/√fan_in), a seed fixes the weights."""
    jax_model, _, _, batch = pair
    fresh = jax_model.init(jax.random.PRNGKey(0), batch)
    model = init_absorbing_parameters(AbsorbingFlow(pair[2].config), seed=7)
    again = init_absorbing_parameters(AbsorbingFlow(pair[2].config), seed=7)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
    g = model.generator
    assert g.res_block_0.norm1.weight.eq(1).all() and g.attn_block_1.norm.bias.eq(0).all()
    assert g.pre_rate_proj.bias.eq(0).all() and model.loss_weights.eq(0).all()
    theirs = np.asarray(fresh["generator"]["attn_block_0"]["q"]["kernel"])
    ours = g.attn_block_0.q.weight.detach().numpy()
    assert ours.shape == theirs.T.shape
    np.testing.assert_allclose(ours.std(), theirs.std(), rtol=0.05)
    np.testing.assert_allclose(ours.std(), 1 / np.sqrt(128), rtol=0.05)
    assert np.abs(ours).max() <= 2.0 / np.sqrt(128) / 0.8796 + 1e-6


def test_absorbing_training_batch_sources_hold_fewer_particles():
    gen = torch.Generator().manual_seed(0)
    batch = absorbing_training_batch(64, 109, 3, 8, gen, num_empty=2)
    src, tgt = batch.source_mask.sum(dim=1), batch.target_mask.sum(dim=1)
    assert tuple(batch.source_mask.shape) == (64, 109, 1)
    assert (src <= tgt).all() and (src < tgt).any() and (tgt[-2:] == 0).all()
    assert (batch.source_continuous * (1 - batch.source_mask)).abs().max() == 0
    assert (batch.source_discrete * (1 - batch.source_mask).long()).abs().max() == 0
    assert batch.target_discrete.max() < 8 and batch.target_continuous.isfinite().all()


def test_trainer_fits_and_predicts_an_absorbing_flow(tmp_path):
    """Trainer.fit with an AbsorbingFlow: the three loss terms are logged
    under the JAX names, the loss falls, the EMA weights serve `predict`, and
    the plain kernel versions are not part of training."""
    cfg = port_cfg.AbsorbingConfig()
    cfg.data.max_num_particles, cfg.bridge.num_timesteps, cfg.train.lr = 12, 4, 3e-3
    gen = torch.Generator().manual_seed(1)
    batches = [absorbing_training_batch(16, 12, 3, 8, gen) for _ in range(4)]
    trainer = Trainer(AbsorbingFlow(cfg), cfg, seed=0, ema_decay=0.9)
    calls = survival_cuda.survival_head_reference.calls
    history = trainer.fit(InMemoryDataModule(train=batches, valid=batches[:1]), epochs=6)
    assert survival_cuda.survival_head_reference.calls == calls
    assert {"train_loss_continuous", "train_loss_discrete", "train_loss_absorbing"} <= set(history[0])
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]) for r in history)
    assert history[-1]["train_loss"] < history[0]["train_loss"]
    assert tuple(trainer.state.params["loss_weights"].shape) == (3,)
    cfg.parallel.use_pallas = True
    out = trainer.predict(batches[:1])[0]
    assert survival_cuda.survival_head_reference.calls == calls + 3
    assert out.mask_t.sum() >= batches[0].source_mask.sum()
    assert out.continuous.isfinite().all() and ((out.discrete >= 0) & (out.discrete < 8)).all()
