"""The transdimensional family of the PyTorch/CUDA port against the JAX
package on the CPU: the config mirror, the noise schedule and rates, the
structured state, the network, the kernel path on the kernels' plain versions
against the interpret-mode Pallas path, the loss and its gradients, the
sampler with injected draws, and the trainer. float32 on both sides; inputs
come from numpy seeds; each test states its tolerance."""

import dataclasses
import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_particles_tpu.config_classes import (
    transdimensional_unconditional_config as jax_cfgs,
)
from multimodal_particles_tpu.models.generative.diffusion import noising as jax_noising
from multimodal_particles_tpu.models.generative.transdimensional import loss as jax_loss
from multimodal_particles_tpu.models.generative.transdimensional import sampler as jax_sampler
from multimodal_particles_tpu.models.generative.transdimensional import structure as jax_structure
from multimodal_particles_tpu.models.generative.transdimensional.transdimensional_model import (
    TransdimensionalJumpDiffusion as JaxTransdim,
)
from multimodal_particles_tpu.training import trainer as jax_trainer
from multimodal_particles_tpu_torch import config_classes as torch_cfgs
from multimodal_particles_tpu_torch.data import (
    InMemoryDataModule,
    multiplicity_histogram,
    transdim_training_batch,
)
from multimodal_particles_tpu_torch.models.generative.diffusion import noising
from multimodal_particles_tpu_torch.models.generative.init import (
    init_transdimensional_parameters,
)
from multimodal_particles_tpu_torch.models.generative.transdimensional import (
    loss,
    sampler,
    structure,
)
from multimodal_particles_tpu_torch.models.generative.transdimensional.transdimensional_model import (
    TransdimensionalJumpDiffusion,
    pick_nearest_atom,
    sample_gumbel,
)
from multimodal_particles_tpu_torch.ops.epic_cuda import epic_forward_reference
from multimodal_particles_tpu_torch.ops.gsdm_stack_cuda import gsdm_stack_reference
from multimodal_particles_tpu_torch.training import trainer as torch_trainer
from multimodal_particles_tpu_torch.utils.transplant import params_from_flax
from torch_port_helpers import replay_sampler_draws, to_torch, transdim_list_batch, transdim_pair

N, B = 16, 6
RATE_TOL = dict(rtol=5e-4, atol=1e-5)  # tests/test_generative/test_transdimensional.py:535


def _np(a):
    return np.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _jax_state(batch):
    return jax_structure.state_from_list_batch(batch)


def _torch_state(batch):
    return structure.state_from_list_batch([_t(b) for b in batch])


# ------------------------------------------------------------------- config


@pytest.mark.parametrize("ours,theirs", [
    ("TransdimJetsDataConfig", "JetsDataConfig"), ("LossKwargs", "LossKwargs"),
    ("OptimizerKwargs", "OptimizerKwargs"), ("StructureKwargs", "StructureKwargs"),
    ("SamplerKwargs", "SamplerKwargs"), ("GradConditionerKwargs", "GradConditionerKwargs"),
    ("TransdimEncoderConfig", "EncoderConfig"), ("AugmentKwargs", "AugmentKwargs"),
])
def test_config_mirror_matches_jax_dataclasses(ours, theirs):
    def fields(cls):
        return [(f.name, f.type, f.default,
                 f.default_factory() if f.default_factory is not dataclasses.MISSING else None)
                for f in dataclasses.fields(cls)]

    assert fields(getattr(torch_cfgs, ours)) == fields(getattr(jax_cfgs, theirs))


def test_config_tree_mirrors_jax_and_round_trips(tmp_path):
    ours, theirs = torch_cfgs.TransdimensionalEpicConfig(), jax_cfgs.TransdimensionalEpicConfig()
    assert ours.to_dict() == theirs.to_dict()
    theirs.sampler_kwargs.multi_birth, theirs.seed, theirs.encoder.dim_hidden_glob = 24, 7, 21
    again = torch_cfgs.TransdimensionalEpicConfig.from_dict(theirs.to_dict())
    assert again.to_dict() == theirs.to_dict()
    again.to_yaml(str(tmp_path / "config.yaml"))
    assert torch_cfgs.TransdimensionalEpicConfig.from_yaml(str(tmp_path / "config.yaml")) == again
    assert torch_cfgs.TransdimensionalEpicConfig.from_dict({"unknown": 1}) == ours


# ------------------------------------------------------------------ noising


@pytest.fixture(scope="module")
def times():
    return np.array([0.03, 0.1, 0.1000001, 0.37, 0.8, 1.0], np.float32)


def _schedules():
    return (noising.VP_SDE(N, 0.1, 20.0), jax_noising.VP_SDE(N, 0.1, 20.0))


@pytest.mark.parametrize("method", ["get_beta_t", "get_sigma"])
def test_vp_sde_of_times_matches_jax(method, times):
    ours, theirs = _schedules()
    np.testing.assert_allclose(getattr(ours, method)(_t(times)).numpy(),
                               _np(getattr(theirs, method)(jnp.asarray(times))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("method", ["get_p0t_stats", "predict_x0_from_xt",
                                    "predict_eps_from_x0_xt", "get_pxt2_xt1_stats"])
def test_vp_sde_of_latents_matches_jax(method, times):
    """Every statistic of the schedule on (6, 20) latents; 2e-6 relative
    (exp and sqrt of the two libraries differ in the last bit)."""
    ours, theirs = _schedules()
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal((6, 20)).astype(np.float32) for _ in range(2))
    args = {"get_p0t_stats": (a, times), "predict_x0_from_xt": (a, b, times),
            "predict_eps_from_x0_xt": (a, b, times),
            "get_pxt2_xt1_stats": (a, times * 0.5, times)}[method]
    got = getattr(ours, method)(*to_torch(*args))
    ref = getattr(theirs, method)(*map(jnp.asarray, args))
    for g, r in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple) else (ref,)):
        np.testing.assert_allclose(g.numpy(), _np(r), rtol=2e-6, atol=1e-6)


def _rates(name):
    return (noising.get_forward_rate(name, N, 0.1), jax_noising.get_forward_rate(name, N, 0.1))


@pytest.mark.parametrize("name", ["step", "const"])
def test_forward_rate_matches_jax(name, times):
    """Scalar, rate and rate integral (the step rate jumps at rate_cut_t:
    times on both sides of it), and the dims after given Poisson counts."""
    ours, theirs = _rates(name)
    assert ours.get_scalar() == theirs.get_scalar()
    assert ours.max_num_deletions == theirs.max_num_deletions == N - 1
    for method in ("get_rate_integral",):
        np.testing.assert_allclose(getattr(ours, method)(_t(times)).numpy(),
                                   _np(getattr(theirs, method)(jnp.asarray(times))), rtol=1e-6)
    np.testing.assert_allclose(ours.get_rate(None, _t(times)).numpy(),
                               _np(theirs.get_rate(None, jnp.asarray(times))), rtol=1e-6)
    start = torch.tensor([1, 5, 16, 16, 9, 2], dtype=torch.int32)
    deleted = torch.tensor([0, 2, 3, 40, 8, 1])
    got = ours.get_dims_at_t(start, _t(times), deleted=deleted)
    assert got.dtype == torch.int32 and got.tolist() == [1, 3, 13, 1, 1, 1]
    got = ours.get_dims_at_t2_starting_t1(start, _t(times * 0.5), _t(times), deleted=deleted)
    assert got.tolist() == [1, 3, 13, 1, 1, 1]


def test_forward_rate_draws_its_poisson_counts_from_the_generator(times):
    """The counts have the law's mean, Poisson(∫rate); the same seed gives
    the same dims."""
    rate, _ = _rates("step")
    ts = torch.full((20000,), 0.5)
    start = torch.full((20000,), N, dtype=torch.int32)
    dims = rate.get_dims_at_t(start, ts, generator=torch.Generator().manual_seed(0))
    again = rate.get_dims_at_t(start, ts, generator=torch.Generator().manual_seed(0))
    assert torch.equal(dims, again) and dims.min() >= 1
    lam = rate.get_rate_integral(ts[:1]).item()
    expected = np.mean(np.maximum(N - np.random.default_rng(0).poisson(lam, 200000), 1))
    assert abs(dims.float().mean().item() - expected) < 0.1


def test_factories_refuse_unknown_names():
    with pytest.raises(ValueError):
        noising.get_forward_rate("linear", N, 0.1)
    with pytest.raises(ValueError):
        noising.get_noise_schedule("ve_sde", N, 0.1, 20.0)
    assert isinstance(noising.get_noise_schedule("vp_sde", N, 0.1, 20.0), noising.VP_SDE)


def _rate_inputs(seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((8, N)).astype(np.float32) * 2.0
    dims = np.array([1, 1, 2, 5, N - 1, N, N, 9], np.int32)  # rows with dims == 1 and dims == N
    ts = np.array([0.05, 0.7, 0.3, 0.15, 0.9, 0.4, 1.0, 0.100001], np.float32)
    return logits, dims, ts


@pytest.mark.parametrize("name", ["step", "const"])
def test_rate_using_x0_pred_matches_jax(name):
    ours, theirs = _rates(name)
    logits, dims, ts = _rate_inputs()
    got = noising.get_rate_using_x0_pred(_t(logits), _t(dims), ours, _t(ts), N)
    ref = jax_noising.get_rate_using_x0_pred(jnp.asarray(logits), jnp.asarray(dims), theirs,
                                             jnp.asarray(ts), N)
    np.testing.assert_allclose(got.numpy(), _np(ref), **RATE_TOL)
    assert (got >= 0).all()


def test_analytic_x0_dim_logits_match_jax():
    """The incomplete gamma function and lgamma of the two libraries; −1e30 at
    impossible d0 on both sides."""
    ours, theirs = _rates("step")
    logits, dims, ts = _rate_inputs(1)
    prior = np.log(np.random.default_rng(2).dirichlet(np.ones(N)) + 1e-30).astype(np.float32)
    got = noising.analytic_x0_dim_logits(_t(prior), _t(dims), ours, _t(ts), N)
    ref = jax_noising.analytic_x0_dim_logits(jnp.asarray(prior), jnp.asarray(dims), theirs,
                                             jnp.asarray(ts), N)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=5e-4, atol=2e-4)


@pytest.mark.parametrize("num_offsets", [1, 4, 24])
def test_birth_rates_for_offsets_match_jax(num_offsets):
    """The rate ladder, wider than the slots left (24 > N − dims); exactly 0
    at candidates ≥ N."""
    ours, theirs = _rates("step")
    logits, dims, ts = _rate_inputs(3)
    got = noising.get_birth_rates_for_offsets(_t(logits), _t(dims), num_offsets, ours, _t(ts), N)
    ref = jax_noising.get_birth_rates_for_offsets(jnp.asarray(logits), jnp.asarray(dims),
                                                  num_offsets, theirs, jnp.asarray(ts), N)
    assert tuple(got.shape) == (8, num_offsets)
    np.testing.assert_allclose(got.numpy(), _np(ref), **RATE_TOL)
    cand = dims[:, None] + np.arange(num_offsets)[None, :]
    assert (got.numpy()[cand >= N] == 0).all()


# ---------------------------------------------------------------- structure


@pytest.fixture(scope="module")
def states():
    batch = transdim_list_batch(5, B, N)
    batch[0][2] = 0  # a jet without particles
    return _torch_state(batch), _jax_state(batch)


@pytest.mark.parametrize("method", [
    "get_flat_lats", "particle_mask", "get_mask_flat", "get_next_dim_deleted_mask",
    "get_next_dim_added_mask",
])
def test_state_views_match_jax(method, states):
    ours, theirs = states
    np.testing.assert_array_equal(getattr(ours, method)().numpy(), _np(getattr(theirs, method)()))


def test_state_shapes_and_flat_round_trip(states):
    ours, theirs = states
    assert (ours.B, ours.N, ours.Dc, ours.V, ours.flat_dim) == (B, N, 3, 8, N * 11)
    flat = np.random.default_rng(0).standard_normal((B, N * 11)).astype(np.float32)
    back, ref = ours.set_flat_lats(_t(flat)), theirs.set_flat_lats(jnp.asarray(flat))
    np.testing.assert_array_equal(back.continuous.numpy(), _np(ref.continuous))
    np.testing.assert_array_equal(back.discrete.numpy(), _np(ref.discrete))
    np.testing.assert_array_equal(back.get_flat_lats().numpy(), flat)
    assert back.dims is ours.dims


@pytest.mark.parametrize("op", ["delete_one_dim", "add_dim_where_not_max", "delete_dims"])
def test_state_dim_operations_match_jax(op, states):
    ours, theirs = states
    ours, theirs = ours.replace(dims=ours.dims.clamp(min=1)), theirs.replace(
        dims=jnp.maximum(theirs.dims, 1))
    args = ((np.array([1, 3, 16, 2, 7, 1], np.int32),) if op == "delete_dims" else ())
    got = getattr(ours, op)(*map(_t, args))
    ref = getattr(theirs, op)(*map(jnp.asarray, args))
    assert got.dims.dtype == torch.int32
    for name in ("continuous", "discrete", "dims"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), _np(getattr(ref, name)))


def test_convert_problem_dim_and_databatch_match_jax(states):
    ours, theirs = states
    rows = np.random.default_rng(1).standard_normal((B, N)).astype(np.float32)
    np.testing.assert_array_equal(ours.convert_problem_dim_to_tensor_dim(_t(rows)).numpy(),
                                  _np(theirs.convert_problem_dim_to_tensor_dim(jnp.asarray(rows))))
    for a, b in zip(ours.to_multimodal_bridge_databatch(), theirs.to_multimodal_bridge_databatch()):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), _np(b))


def test_adjust_state_matches_jax_with_a_nan_and_an_empty_jet(states):
    """A NaN is scrubbed to 0, the centre of mass is taken over the live rows,
    and the jet with dims == 0 counts every row; 1e-6."""
    ours, theirs = states
    cont = ours.continuous.clone()
    cont[3, 0, 1] = float("nan")
    got, mean = structure.adjust_state(ours.replace(continuous=cont))
    ref, ref_mean = jax_structure.adjust_state(theirs.replace(continuous=jnp.asarray(cont.numpy())))
    np.testing.assert_allclose(got.continuous.numpy(), _np(ref.continuous), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(mean.numpy(), _np(ref_mean), rtol=1e-6, atol=1e-6)
    assert torch.isfinite(got.continuous).all() and tuple(mean.shape) == (B, 1, 3)
    live = got.particle_mask()[:, :, None]
    assert (got.continuous * live).sum(dim=1)[[0, 1, 3, 4, 5]].abs().max() < 1e-5


def test_auto_target_and_nearest_atom_match_jax(states):
    ours, theirs = states
    ours, theirs = ours.replace(dims=ours.dims.clamp(min=1)), theirs.replace(
        dims=jnp.maximum(theirs.dims, 1))
    del_ours, del_theirs = ours.delete_one_dim(), theirs.delete_one_dim()
    np.testing.assert_array_equal(structure.get_nearest_atom(ours, del_ours).numpy(),
                                  _np(jax_structure.get_nearest_atom(theirs, del_theirs)))
    shift = np.random.default_rng(2).standard_normal((B, 1, 3)).astype(np.float32)
    np.testing.assert_allclose(structure.get_auto_target(ours, _t(shift)).numpy(),
                               _np(jax_structure.get_auto_target(theirs, jnp.asarray(shift))),
                               rtol=1e-6, atol=1e-6)


def test_distribution_nodes_match_jax():
    hist = {3: 5, 1: 2, 9: 1, 16: 12}
    ours, theirs = structure.DistributionNodes(hist), jax_structure.DistributionNodes(hist)
    np.testing.assert_array_equal(ours.n_nodes, theirs.n_nodes)
    np.testing.assert_array_equal(ours.probs, theirs.probs)
    query = np.array([1, 16, 3, 9, 16], np.int32)
    np.testing.assert_allclose(ours.log_prob(_t(query)).numpy(), _np(theirs.log_prob(query)),
                               rtol=1e-6)
    draws = ours.sample(torch.Generator().manual_seed(0), 4000)
    assert set(draws.tolist()) <= set(hist) and abs((draws == 16).float().mean() - 0.6) < 0.05


def test_structure_and_structured_argument_match_jax(states):
    ours, theirs = states
    dataset = SimpleNamespace(names_in_batch=list("abcd"), is_onehot=[0, 1, 0, 0])
    a = structure.Structure([1, 1, 0, 1], [0, 1, 1, 0], dataset)
    b = jax_structure.Structure([1, 1, 0, 1], [0, 1, 1, 0], dataset)
    assert a.names == b.names and a.latent_names == b.latent_names and a.is_onehot == b.is_onehot
    np.testing.assert_array_equal(a.latent, b.latent)
    for arg in (2.0, (1.0, 3.0), [5.0]):
        np.testing.assert_array_equal(structure.StructuredArgument(arg, ours).lats.numpy(),
                                      _np(jax_structure.StructuredArgument(arg, theirs).lats))


def test_graphical_structure_carries_the_prior():
    cfg = torch_cfgs.TransdimensionalEpicConfig()
    dm = SimpleNamespace(config=cfg, histogram_target={4: 1, 7: 3}, names_in_batch=["x"],
                         name_to_index={"x": 0}, with_onehot_shapes=[(3,)],
                         without_onehot_shapes=[(3,)])
    gs = structure.JetsGraphicalStructure(dm)
    assert gs.max_problem_dim == 128 and gs.nodes_dist.n_nodes.tolist() == [4, 7]
    assert gs.shapes_with_onehot() == [(3,)] and gs.adjust_st_batch is structure.adjust_state


def test_list_batch_and_histogram():
    gen = torch.Generator().manual_seed(0)
    n, x, one_hot = transdim_training_batch(64, N, 3, 8, gen)
    assert n.dtype == torch.int32 and n.min() >= 1 and n.max() <= N
    live = torch.arange(N)[None, :] < n[:, None]
    assert (x[~live] == 0).all() and (one_hot[~live] == 0).all()
    assert (one_hot[live].sum(dim=-1) == 1).all()
    hist = multiplicity_histogram(n)
    assert sum(hist.values()) == 64 and set(hist) == set(n.tolist())
    state = structure.state_from_list_batch([n, x, one_hot])
    assert state.dims.dtype == torch.int32 and state.context_continuous is None


# ------------------------------------------------------------------ network


@pytest.fixture(scope="module")
def pair():
    return transdim_pair(seed=0, n=N, b=B)


def _net_inputs(pair, seed=1):
    *_, batch = pair
    rng = np.random.default_rng(seed)
    noisy = [batch[0], batch[1], (batch[2] + 0.3 * rng.standard_normal(batch[2].shape).astype(
        np.float32)) * (batch[2].sum(-1, keepdims=True) > 0)]
    ts = rng.uniform(0.05, 1.0, B).astype(np.float32)
    nearest = np.minimum(rng.integers(0, N, B), noisy[0] - 1).astype(np.int32)
    return noisy, ts, nearest


OUTPUTS = ["D_xt", "rate_emb", "near_atom_logits", "auto_mean", "auto_std", "nearest_atom"]


def test_network_matches_flax_on_transplanted_weights(pair):
    """All six outputs of TransdimensionalEPiC; 2e-5 absolute and relative
    (a trunk, two transformer stacks and sin/cos of 1000·t)."""
    jax_model, params, model, _ = pair
    noisy, ts, nearest = _net_inputs(pair)
    ref = jax_model.network.apply({"params": params["network"]}, _jax_state(noisy),
                                  jnp.asarray(ts), jnp.asarray(nearest))
    with torch.no_grad():
        got = model.network(_torch_state(noisy), _t(ts), _t(nearest).long())
    for name, g, r in zip(OUTPUTS, got, ref):
        np.testing.assert_allclose(g.numpy(), _np(r), rtol=2e-4, atol=2e-5, err_msg=name)


def test_network_with_the_embedding_input_matches_flax():
    """The reference's discrete input, the argmax token through an Embedding."""
    emb = transdim_pair(seed=1, n=N, b=B,
                        sections={"encoder": {"embedding_features_discrete": "Embedding"}})
    jax_model, params, model, _ = emb
    noisy, ts, nearest = _net_inputs(emb)
    ref = jax_model.network.apply({"params": params["network"]}, _jax_state(noisy),
                                  jnp.asarray(ts), jnp.asarray(nearest))
    with torch.no_grad():
        got = model.network(_torch_state(noisy), _t(ts), _t(nearest).long())
    for name, g, r in zip(OUTPUTS, got, ref):
        np.testing.assert_allclose(g.numpy(), _np(r), rtol=2e-4, atol=2e-5, err_msg=name)


def test_categorical_is_argmax_of_logits_plus_gumbel():
    """What the replayed nearest-atom draw rests on: jax.random.categorical
    over axis 1 is argmax(logits + gumbel(key, logits.shape))."""
    key = jax.random.PRNGKey(3)
    logits = jax.random.normal(jax.random.PRNGKey(4), (5, N)) * 3.0
    np.testing.assert_array_equal(
        _np(jax.random.categorical(key, logits, axis=1)),
        _np(jnp.argmax(logits + jax.random.gumbel(key, logits.shape), axis=1)))


def test_sampled_nearest_atom_matches_flax(pair):
    """`sample_nearest_atom` with the Gumbel noise of JAX's key injected picks
    JAX's atom, bit for bit, and the creation head follows it: its mean within
    rtol 2e-4 and atol 2e-5 × the output's largest |value| (28 here), as
    tests/test_torch_transdim_context.py holds the network's outputs. At an
    atol of 2e-5 alone one element in 96 missed by 5e-6 on some CPUs: the
    port parts from JAX by 1.09e-4 there, JAX's own evaluations (the test's
    dispatch, jit, `disable_jit`) by up to 7.0e-5 from one another
    (scripts/transdim_network_gap.py), float32 rounding at the scale 28."""
    jax_model, params, model, _ = pair
    noisy, ts, _ = _net_inputs(pair, 2)
    key = jax.random.PRNGKey(11)
    ref = jax_model.network.apply({"params": params["network"]}, _jax_state(noisy),
                                  jnp.asarray(ts), jnp.zeros((B,), jnp.int32), True, key)
    gumbel = _t(_np(jax.random.gumbel(key, (B, N))))
    with torch.no_grad():
        got = model.network(_torch_state(noisy), _t(ts), torch.zeros(B, dtype=torch.long), True,
                            None, gumbel)
    np.testing.assert_array_equal(got[5].numpy(), _np(ref[5]))
    np.testing.assert_allclose(got[3].numpy(), _np(ref[3]), rtol=2e-4,
                               atol=2e-5 * max(1.0, float(np.abs(_np(ref[3])).max())))


def test_gumbel_draws_pick_by_softmax():
    logits = torch.tensor([[0.0, 1.0, 2.0]]).expand(30000, 3)
    gen = torch.Generator().manual_seed(0)
    noise = sample_gumbel(logits.shape, gen, "cpu")
    picks = pick_nearest_atom(logits, None, True, None, noise)
    freq = torch.bincount(picks, minlength=3).float() / 30000
    np.testing.assert_allclose(freq.numpy(), torch.softmax(logits[0], 0).numpy(), atol=0.01)
    assert torch.isfinite(noise).all()
    given = torch.tensor([2, 0])
    assert pick_nearest_atom(logits[:2], given, False, None, None) is not None
    assert pick_nearest_atom(logits[:2], given, False, None, None).tolist() == [2, 0]


def test_forward_kernel_matches_network_fused_in_interpret_mode(pair):
    """The kernel path on the kernels' plain versions (CPU tensors) against
    `_network_fused` with the Pallas kernels in interpret mode; atol 5e-4
    (tests/test_generative/test_transdimensional.py:258). One K1 call with the
    folded input and two stack calls an evaluation."""
    jax_model, params, model, _ = pair
    noisy, ts, nearest = _net_inputs(pair, 3)
    ref = jax_model._network_fused(params["network"], _jax_state(noisy), jnp.asarray(ts),
                                   jnp.asarray(nearest), False, None, interpret=True)
    k1, k7 = epic_forward_reference.calls, gsdm_stack_reference.calls
    got = model.forward_kernel(_torch_state(noisy), _t(ts), _t(nearest).long())
    assert epic_forward_reference.calls == k1 + 1 and gsdm_stack_reference.calls == k7 + 2
    for name, g, r in zip(OUTPUTS, got, ref):
        np.testing.assert_allclose(g.numpy(), _np(r), rtol=5e-4, atol=5e-4, err_msg=name)
    with torch.no_grad():
        module = model.network(_torch_state(noisy), _t(ts), _t(nearest).long())
    for name, g, r in zip(OUTPUTS, got, module):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4, atol=1e-5, err_msg=name)


def test_forward_kernel_past_128_slots_matches_network_fused_in_interpret_mode():
    """The kernel path at max_num_particles 200 (K7 as two row blocks a jet
    on the card; JAX's kernels pad 200 to 256 slots) on the plain versions
    against `_network_fused` with the Pallas kernels in interpret mode, as
    above, at B = 2 (one jet of one particle, one of 200) and one
    transformer block a stack; atol 5e-4."""
    n, b = 200, 2
    jax_model, params, model, batch = transdim_pair(
        seed=2, n=n, b=b, drawn_init=True, sections={"encoder": {"n_attn_blocks": 1}})
    rng = np.random.default_rng(4)
    live = batch[2].sum(-1, keepdims=True) > 0
    noisy = [batch[0], batch[1], (batch[2] + 0.3 * rng.standard_normal(batch[2].shape).astype(
        np.float32)) * live]
    ts = rng.uniform(0.05, 1.0, b).astype(np.float32)
    nearest = np.minimum(rng.integers(0, n, b), noisy[0] - 1).astype(np.int32)
    jax_model.config.parallel.use_pallas = model.config.parallel.use_pallas = True
    assert model._pallas_enabled("cpu") and jax_model._pallas_enabled()
    ref = jax_model._network_fused(params["network"], _jax_state(noisy), jnp.asarray(ts),
                                   jnp.asarray(nearest), False, None, interpret=True)
    k1, k7 = epic_forward_reference.calls, gsdm_stack_reference.calls
    got = model.forward_kernel(_torch_state(noisy), _t(ts), _t(nearest).long())
    assert epic_forward_reference.calls == k1 + 1 and gsdm_stack_reference.calls == k7 + 2
    for name, g, r in zip(OUTPUTS, got, ref):
        np.testing.assert_allclose(g.numpy(), _np(r), rtol=5e-4, atol=5e-4, err_msg=name)


@pytest.mark.parametrize("predict", ["eps", "x0"])
def test_net_forward_matches_jax(pair, predict):
    """Preconditioning and the reverse rate on top of the network; rates by
    the JAX tests' rtol 5e-4."""
    jax_model, params, model, _ = pair
    noisy, ts, nearest = _net_inputs(pair, 4)
    ref = jax_model.net_forward(params, _jax_state(noisy), jnp.asarray(ts),
                                nearest_atom=jnp.asarray(nearest), predict=predict)
    with torch.no_grad():
        got = model.net_forward(_torch_state(noisy), _t(ts), nearest_atom=_t(nearest).long(),
                                predict=predict)
    np.testing.assert_allclose(got[0].numpy(), _np(ref[0]), rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(got[1].numpy(), _np(ref[1]), rtol=1e-3, atol=1e-5)
    assert tuple(got[1].shape) == (B, 1)
    for g, r in zip(got[2], ref[2]):  # the heads' outputs reach 16: 2e-4 absolute
        np.testing.assert_allclose(g.numpy(), _np(r), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[3].numpy(), _np(ref[3]), rtol=2e-4, atol=2e-4)


def test_net_forward_refuses_an_unknown_prediction(pair):
    *_, model, _ = pair
    noisy, ts, _ = _net_inputs(pair)
    with pytest.raises(NotImplementedError):
        model.net_forward(_torch_state(noisy), _t(ts), predict="v")


def test_net_forward_with_the_direct_rate_head_matches_jax():
    direct = transdim_pair(seed=2, n=N, b=B, sections={"encoder": {"rate_use_x0_pred": False}})
    jax_model, params, model, _ = direct
    noisy, ts, nearest = _net_inputs(direct)
    ref = jax_model.net_forward(params, _jax_state(noisy), jnp.asarray(ts),
                                nearest_atom=jnp.asarray(nearest))
    with torch.no_grad():
        got = model.net_forward(_torch_state(noisy), _t(ts), nearest_atom=_t(nearest).long())
    np.testing.assert_allclose(got[1].numpy(), _np(ref[1]), rtol=5e-4, atol=1e-5)
    assert not got[3].any() and tuple(got[3].shape) == (B, N)


@pytest.mark.parametrize("flag,device,expected", [
    ("auto", "cpu", False), ("auto", "cuda", True), (True, "cpu", True), (False, "cuda", False),
])
def test_kernel_gate(pair, flag, device, expected):
    *_, model, _ = pair
    model.config.parallel.use_pallas = flag
    try:
        assert model._pallas_enabled(device) is expected
    finally:
        model.config.parallel.use_pallas = "auto"


def test_kernel_gate_follows_the_heads_and_a_wide_trunk_raises():
    cfg = torch_cfgs.TransdimensionalEpicConfig()
    cfg.data.max_num_particles = N
    cfg.parallel.use_pallas = True
    cfg.encoder.n_heads = 3
    assert not TransdimensionalJumpDiffusion(cfg)._pallas_enabled("cuda")
    cfg.encoder.n_heads = 2
    cfg.encoder.dim_hidden_local = 48  # no kernel is compiled for it
    assert not TransdimensionalJumpDiffusion(cfg)._pallas_enabled("cuda")
    e = cfg.encoder
    e.dim_hidden_local = e.dim_hidden_glob = e.dim_emb_time = 128
    e.dim_emb_features_continuous = e.dim_emb_features_discrete = 128
    e.transformer_dim = 128
    wide = init_transdimensional_parameters(TransdimensionalJumpDiffusion(cfg), 0)
    assert wide._pallas_enabled("cuda")  # K4 with the folded input, K7 at Din 136 and 139
    trunk, rate_stack, vec_stack = wide.pack_for_kernel()
    assert trunk.layout == "wide" and trunk.dims.fold_discrete
    assert (rate_stack.dim_in, vec_stack.dim_in) == (136, 139)
    state = structure.state_from_list_batch([_t(b) for b in transdim_list_batch(0, 2, N)])
    calls = epic_forward_reference.calls, gsdm_stack_reference.calls
    fused = wide.net_forward(state, torch.full((2,), 0.5), fused=True)  # CPU: the plain versions
    assert (epic_forward_reference.calls, gsdm_stack_reference.calls) == (calls[0] + 1, calls[1] + 2)
    module = wide.net_forward(state, torch.full((2,), 0.5))
    for got, ref in zip(fused[0::4], module[0::4]):  # the score and the nearest-atom logits
        assert torch.isfinite(ref).all()
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * ref.abs().max().item())
    # a trunk of 256 takes the wide kernel's clusters (two blocks a jet), beside K7 at 264, 267
    e.dim_hidden_local = e.dim_hidden_glob = 256
    at_256 = TransdimensionalJumpDiffusion(cfg)
    assert at_256._pallas_enabled("cuda")
    trunk, rate_stack, vec_stack = at_256.pack_for_kernel()
    assert trunk.layout == "wide" and trunk.dims.hidden == 256
    assert (rate_stack.dim_in, vec_stack.dim_in) == (264, 267)
    # a wide trunk no kernel is compiled for (640): the gate is off and the packing raises
    e.dim_hidden_local = e.dim_hidden_glob = 640
    wider = TransdimensionalJumpDiffusion(cfg)
    assert not wider._pallas_enabled("cuda")
    with pytest.raises(ValueError, match="no trunk kernel"):
        wider.pack_for_kernel()


def test_compute_dtype_other_than_float32_raises(pair):
    """The JAX model never reads `compute_dtype`: under "bfloat16" its network
    gives the float32 config's bits, and the port's does too (it computes in
    float32 whatever the config says). A context, which the port took
    later, builds and runs its forward (tests/test_torch_transdim_context.py
    holds it against JAX)."""
    jax_model, params, model, _ = pair
    noisy, ts, nearest = _net_inputs(pair, 6)
    cfg = dataclasses.replace(jax_model.config, parallel=dataclasses.replace(
        jax_model.config.parallel, compute_dtype="bfloat16"))
    refs = [m.net_forward(params, _jax_state(noisy), jnp.asarray(ts),
                          nearest_atom=jnp.asarray(nearest))
            for m in (jax_model, JaxTransdim(cfg))]
    for a, b in zip(jax.tree_util.tree_leaves(refs[0]), jax.tree_util.tree_leaves(refs[1])):
        np.testing.assert_array_equal(_np(a), _np(b))
    port_cfg = torch_cfgs.TransdimensionalEpicConfig.from_dict(cfg.to_dict())
    assert port_cfg.parallel.compute_dtype == "bfloat16"
    bf16 = TransdimensionalJumpDiffusion(port_cfg)
    bf16.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = [m.net_forward(_torch_state(noisy), _t(ts), nearest_atom=_t(nearest).long())
               for m in (model, bf16)]
    for a, b in zip(jax.tree_util.tree_leaves(got[0]), jax.tree_util.tree_leaves(got[1])):
        assert a.dtype != torch.bfloat16 and torch.equal(a, b)
    state = _torch_state(noisy)
    for field in ("dim_context_continuous", "dim_context_discrete"):
        conditional = torch_cfgs.TransdimensionalEpicConfig.from_dict(cfg.to_dict())
        setattr(conditional.data, field, 1)
        conditional.data.vocab_size_context = 5
        conditional.encoder.dim_emb_context_continuous = 4
        conditional.encoder.dim_emb_context_discrete = 4
        with_context = init_transdimensional_parameters(TransdimensionalJumpDiffusion(conditional), 0)
        context = {"context_continuous": torch.ones(B, 1)} if field == "dim_context_continuous" \
            else {"context_discrete": torch.eye(5)[torch.arange(B) % 5]}
        with torch.no_grad():
            out = with_context.net_forward(state.replace(**context), _t(ts),
                                           nearest_atom=_t(nearest).long())
        assert not with_context._pallas_enabled("cuda")
        assert all(torch.isfinite(o).all() for o in jax.tree_util.tree_leaves(out))


# --------------------------------------------------------------------- loss


def _corruption(batch, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.random(B).astype(np.float32)
    deleted = rng.integers(0, 6, B).astype(np.int32)
    noise = rng.standard_normal((B, N * 11)).astype(np.float32)
    ts = (0.001 + (1.0 - 0.001) * u).astype(np.float32)
    dims_xt = np.maximum(batch[0] - deleted, 1).astype(np.int32)
    return (u, deleted, noise), ts, dims_xt


def test_corrupt_with_matches_jax(pair):
    jax_model, _, model, batch = pair
    (_, _, noise), ts, dims_xt = _corruption(batch)
    ref = jax_loss.corrupt_with(_jax_state(batch), jax_model.noise_schedule, jnp.asarray(ts),
                                jnp.asarray(dims_xt), jnp.asarray(noise))
    got = loss.corrupt_with(_torch_state(batch), model.noise_schedule, _t(ts), _t(dims_xt), _t(noise))
    for name in ("continuous", "discrete", "dims"):
        np.testing.assert_allclose(getattr(got[0], name).numpy(), _np(getattr(ref[0], name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), _np(r), rtol=1e-5, atol=1e-6)


def test_add_noise_takes_injected_draws_or_a_generator(pair):
    _, _, model, batch = pair
    draws, ts, dims_xt = _corruption(batch)
    got = loss.add_noise(_torch_state(batch), model.noise_schedule, model.forward_rate, 0.001,
                         draws=tuple(map(_t, draws)))
    np.testing.assert_allclose(got[1].numpy(), ts, rtol=1e-6)
    np.testing.assert_array_equal(got[3].numpy(), dims_xt)
    a = loss.add_noise(_torch_state(batch), model.noise_schedule, model.forward_rate, 0.001,
                       generator=torch.Generator().manual_seed(5))
    b = loss.add_noise(_torch_state(batch), model.noise_schedule, model.forward_rate, 0.001,
                       generator=torch.Generator().manual_seed(5))
    assert torch.equal(a[0].continuous, b[0].continuous) and torch.equal(a[3], b[3])
    assert (a[1] >= 0.001).all() and (a[3] >= 1).all() and (a[3] <= a[2]).all()


@pytest.fixture(scope="module")
def loss_and_grads(pair):
    """(jax loss, jax components, jax grads as a state_dict; torch loss,
    components, named grads) on the same corruption."""
    jax_model, params, model, batch = pair
    (_, _, noise), ts, dims_xt = _corruption(batch, 1)

    def total(p):
        corrupted = jax_loss.corrupt_with(_jax_state(batch), jax_model.noise_schedule,
                                          jnp.asarray(ts), jnp.asarray(dims_xt), jnp.asarray(noise))
        return jax_model.jump_diffusion_loss.compute(jax_model, p, corrupted)

    (ref, ref_parts), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(params)
    ref_grads = params_from_flax(jax.tree_util.tree_map(_np, grads), model.config,
                                 TransdimensionalJumpDiffusion)
    model.zero_grad()
    corrupted = loss.corrupt_with(_torch_state(batch), model.noise_schedule, _t(ts), _t(dims_xt),
                                  _t(noise))
    got, parts = model.jump_diffusion_loss.compute(model, corrupted)
    got.backward()
    named = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).clone()
             for k, p in model.named_parameters()}
    model.zero_grad()
    return ref, ref_parts, ref_grads, got.detach(), parts, named


def test_loss_total_matches_jax(loss_and_grads):
    ref, _, _, got, _, _ = loss_and_grads
    np.testing.assert_allclose(got.item(), float(ref), rtol=2e-4)


@pytest.mark.parametrize("name", ["score_loss", "rate_loss", "auto_loss", "ce_loss",
                                  "nearest_atom_loss", "max_rate_xt", "min_rate_delxt",
                                  "min_auto_std", "max_auto_L2", "num_valid"])
def test_loss_component_matches_jax(loss_and_grads, name):
    """rtol 1e-3: the rate terms pass through the truncated logsumexp."""
    _, ref_parts, _, _, parts, _ = loss_and_grads
    np.testing.assert_allclose(parts[name].item(), float(ref_parts[name]), rtol=1e-3, atol=1e-5)


def test_loss_gradients_match_jax_grad(loss_and_grads):
    """Every parameter's gradient of the total against jax.grad through the
    transplant: within 1e-3 of the leaf's largest entry. An attention block's
    key bias has gradient 0 (a softmax cancels a shift of a row's scores):
    rounding noise on both sides, held against 0."""
    _, _, ref_grads, _, _, named = loss_and_grads
    assert set(named) == set(ref_grads)
    scale_all = max(g.abs().max().item() for g in ref_grads.values())
    for key, grad in named.items():
        ref = ref_grads[key]
        scale = ref.abs().max().item()
        if key.endswith(".k.bias"):
            assert grad.abs().max().item() <= 1e-5 * scale_all and scale <= 1e-5 * scale_all, key
            continue
        assert (grad - ref).abs().max().item() <= 1e-3 * scale + 1e-9, key
    # detach_last_layer: the stacks give the trunk no gradient, the score does
    assert named["network.epic.epic.output_layer.v"].abs().max() > 0


@pytest.mark.parametrize("normalization", ["dims", "live"])
@pytest.mark.parametrize("loss_type", ["eps", "x0", "edm"])
def test_loss_variants_match_jax(normalization, loss_type):
    variant = transdim_pair(seed=3, n=N, b=B, sections={"loss_kwargs": {
        "score_loss_normalization": normalization, "loss_type": loss_type}})
    jax_model, params, model, batch = variant
    (_, _, noise), ts, dims_xt = _corruption(batch, 2)
    ref, _ = jax_model.jump_diffusion_loss.compute(jax_model, params, jax_loss.corrupt_with(
        _jax_state(batch), jax_model.noise_schedule, jnp.asarray(ts), jnp.asarray(dims_xt),
        jnp.asarray(noise)))
    with torch.no_grad():
        got, _ = model.jump_diffusion_loss.compute(model, loss.corrupt_with(
            _torch_state(batch), model.noise_schedule, _t(ts), _t(dims_xt), _t(noise)))
    np.testing.assert_allclose(got.item(), float(ref), rtol=3e-4)


def test_loss_options_raise_on_unknown_values(pair):
    *_, model, batch = pair
    (_, _, noise), ts, dims_xt = _corruption(batch)
    corrupted = loss.corrupt_with(_torch_state(batch), model.noise_schedule, _t(ts), _t(dims_xt),
                                  _t(noise))
    for field, value in (("score_loss_normalization", "rows"), ("mean_or_sum_over_dim", "max")):
        bad = dataclasses.replace(model.jump_diffusion_loss, **{field: value})
        with pytest.raises(ValueError), torch.no_grad():
            bad.compute(model, corrupted)
    summed = dataclasses.replace(model.jump_diffusion_loss, mean_or_sum_over_dim="sum")
    with torch.no_grad():
        a, _ = summed.compute(model, corrupted)
        b, _ = model.jump_diffusion_loss.compute(model, corrupted)
    np.testing.assert_allclose(a.item(), b.item() * N * 11, rtol=1e-5)


def test_loss_fn_is_trainer_compatible(pair):
    *_, model, batch = pair
    draws = tuple(map(_t, _corruption(batch)[0]))
    total, metrics = model.loss_fn([_t(b) for b in batch], draws=draws)
    again, _ = model.loss_fn(_torch_state(batch), draws=draws)
    assert total.requires_grad and torch.equal(total.detach(), again.detach())
    assert set(metrics) >= {"loss", "score_loss", "rate_loss", "auto_loss", "ce_loss",
                            "nearest_atom_loss", "num_valid"}
    assert not any(v.requires_grad for v in metrics.values())


# ------------------------------------------------------------------ sampler


def test_sample_birth_chain_matches_jax():
    """The same uniforms through both chains: scalar and per-jet intervals, a
    zero rate stops the chain."""
    rng = np.random.default_rng(0)
    u = rng.random((64, 5)).astype(np.float32).clip(1e-6)
    rates = rng.gamma(2.0, 2.0, (64, 5)).astype(np.float32)
    rates[::7, 2] = 0.0
    dt_rows = rng.random(64).astype(np.float32)

    def reference(dt):
        dtau = np.where(rates > 0, -np.log(u) / np.clip(rates, 1e-20, None), np.inf)
        return (np.cumsum(dtau, axis=1) < (dt[:, None] if np.ndim(dt) else dt)).sum(axis=1)

    for dt in (0.3, dt_rows):
        got = sampler.sample_birth_chain(_t(u), _t(rates), _t(dt) if np.ndim(dt) else dt)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), reference(dt))
    assert (sampler.sample_birth_chain(_t(u), _t(rates), 0.3)[::7] <= 2).all()


@pytest.mark.parametrize("schedule", ["uniform", "C"])
@pytest.mark.parametrize("corrector_steps", [0, 2])
def test_time_grid_and_segments_match_jax(schedule, corrector_steps):
    cfg = torch_cfgs.SamplerKwargs(dt=0.05, dt_schedule=schedule, dt_schedule_h=0.1,
                                   dt_schedule_l=0.02, dt_schedule_tc=0.5,
                                   corrector_steps=corrector_steps, corrector_start_time=0.6,
                                   corrector_finish_time=0.2)
    ours, theirs = sampler._build_time_grid(cfg), jax_sampler._build_time_grid(cfg)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert sampler._segments(ours[3]) == jax_sampler._segments(theirs[3])
    assert len(sampler._segments(ours[3])) == (3 if corrector_steps else 1)


def test_time_grid_refuses_an_unknown_schedule():
    with pytest.raises(NotImplementedError):
        sampler._build_time_grid(torch_cfgs.SamplerKwargs(dt=0.1, dt_schedule="cosine"))


def _attach_prior(jax_model, model, batch):
    hist = {int(v): int(c) for v, c in zip(*np.unique(batch[0], return_counts=True))}
    jax_model.graphical_structure = SimpleNamespace(nodes_dist=jax_structure.DistributionNodes(hist))
    model.graphical_structure = SimpleNamespace(nodes_dist=structure.DistributionNodes(hist))


def _compare_samples(got, ref, min_equal_dims):
    """Final dims equal on at least `min_equal_dims` of the jets (a float32
    rounding can flip a birth on `cumsum(dtau) < dt`, after which a jet's
    trajectory differs); on those the flat latents within 1e-3 of the jet's
    largest entry, at least 1: the untrained flow expands a jet's kinematics
    to 1e3, and its small entries carry the large ones' rounding."""
    same = got.dims.numpy() == _np(ref.dims)
    assert same.mean() >= min_equal_dims, (got.dims, ref.dims)
    ours, theirs = got.get_flat_lats().numpy()[same], _np(ref.get_flat_lats())[same]
    scale = np.maximum(np.abs(theirs).max(axis=1, keepdims=True), 1.0)
    assert (np.abs(ours - theirs) <= 1e-3 * scale).all(), (np.abs(ours - theirs) / scale).max()
    return same


def test_single_birth_sampler_matches_jax_with_the_same_draws():
    """multi_birth = 1, 8 steps: JAX takes `test_draws` and its own key for
    the nearest atom; the port takes the same arrays and the replayed Gumbel
    noise. Every jet's dims and latents agree."""
    single = transdim_pair(seed=4, n=N, b=B, sections={"sampler_kwargs": {
        "dt": 1 / 8, "multi_birth": 1}})
    jax_model, params, model, batch = single
    key = jax.random.PRNGKey(21)
    draws = replay_sampler_draws(key, jax_model.config.sampler_kwargs, B, N, N * 11)
    rng = np.random.default_rng(0)
    draws["u_jump"] = (rng.random(draws["u_jump"].shape) * 0.5).astype(np.float32)  # births happen
    ref, ref_nfe = jax_model.sampler.sample(
        jax_model, params, _jax_state(batch), key,
        test_draws={k: draws[k] for k in ("init", "em_noise", "u_jump", "birth_noise")})
    got, nfe = model.sample(_torch_state(batch), draws=draws)
    assert nfe == ref_nfe == 8
    same = _compare_samples(got, ref, 1.0)
    assert same.all() and got.dims.max() > 1


def test_multi_birth_sampler_matches_jax_with_replayed_draws():
    """multi_birth = 4 over 8 steps with the exact rate integral and the
    analytic posterior from an attached prior: the port takes the draws that
    JAX makes from its key. dims equal on ≥ 95% of 40 jets, the latents of
    those within 1e-3."""
    b = 40
    multi = transdim_pair(seed=5, n=N, b=b, sections={"sampler_kwargs": {
        "dt": 1 / 8, "multi_birth": 4}})
    jax_model, params, model, batch = multi
    _attach_prior(jax_model, model, batch)
    sk = jax_model.config.sampler_kwargs
    assert sk.exact_rate_integral and sk.analytic_dim1_posterior and sk.analytic_posterior_all_dims
    key = jax.random.PRNGKey(22)
    ref, ref_nfe = jax_model.sample(params, key, _jax_state(batch))
    got, nfe = model.sample(_torch_state(batch), draws=replay_sampler_draws(key, sk, b, N, N * 11))
    assert nfe == ref_nfe == 8
    _compare_samples(got, ref, 0.95)
    assert got.dims.float().mean() > 2  # births happened
    rows = torch.arange(N)[None, :] >= got.dims[:, None]
    assert (got.continuous[rows] == 0).all() and (got.discrete[rows] == 0).all()


def test_multi_birth_sampler_with_the_classifier_logits_matches_jax():
    """Without a prior the rate ladder climbs on the network's own logits
    (the warning says so), and only the dims == 1 rows take the analytic
    posterior when `analytic_posterior_all_dims` is off."""
    b = 40
    multi = transdim_pair(seed=6, n=N, b=b, sections={"sampler_kwargs": {
        "dt": 1 / 6, "multi_birth": 3, "analytic_posterior_all_dims": False,
        "sample_near_atom": False, "clip_lats": 50.0, "no_noise_final_step": True}})
    jax_model, params, model, batch = multi
    _attach_prior(jax_model, model, batch)
    key = jax.random.PRNGKey(23)
    ref, _ = jax_model.sample(params, key, _jax_state(batch))
    draws = replay_sampler_draws(key, jax_model.config.sampler_kwargs, b, N, N * 11)
    got, _ = model.sample(_torch_state(batch), draws=draws)
    _compare_samples(got, ref, 0.95)


def test_sampler_from_a_generator_is_reproducible_and_well_formed(pair):
    *_, model, batch = pair
    cfg = model.config.sampler_kwargs
    old = cfg.dt, cfg.multi_birth
    cfg.dt, cfg.multi_birth = 1 / 6, 4
    try:
        model.graphical_structure = SimpleNamespace(nodes_dist=structure.DistributionNodes(
            multiplicity_histogram(batch[0])))
        a, nfe, diag = model.sample(_torch_state(batch), torch.Generator().manual_seed(3),
                                    collect_diagnostics=True)
        b = model.predict([_t(x) for x in batch], torch.Generator().manual_seed(3))
    finally:
        cfg.dt, cfg.multi_birth = old
        model.graphical_structure = None
    assert nfe == 6 and torch.equal(a.get_flat_lats(), b.get_flat_lats())
    assert torch.equal(a.dims, b.dims) and a.dims.min() >= 1 and a.dims.max() <= N
    assert set(diag) == {"ts", "max_abs_x", "mean_dims", "birth_frac", "rate_mean"}
    assert all(tuple(v.shape) == (6,) for v in diag.values())
    assert (diag["mean_dims"][1:] >= diag["mean_dims"][:-1]).all()  # births only
    live = a.particle_mask()[:, :, None]  # centred, to the rounding of the jet's scale
    assert ((a.continuous * live).sum(dim=1).abs().max()
            <= 1e-5 * N * a.continuous.abs().max().clamp(min=1.0))


def test_corrector_segment_counts_its_evaluations(pair):
    """One corrector segment inside the grid (port only): finite, and NFE is
    a step plus `corrector_steps` inside the window (sampler.py:629-631)."""
    *_, model, batch = pair
    cfg = model.config.sampler_kwargs
    saved = dataclasses.replace(cfg)
    cfg.dt, cfg.multi_birth, cfg.corrector_steps = 0.1, 1, 2
    cfg.corrector_start_time, cfg.corrector_finish_time, cfg.do_jump_corrector = 0.65, 0.25, True
    try:
        calls = []
        forward = model.network.forward
        model.network.forward = lambda *a, **k: (calls.append(1), forward(*a, **k))[1]
        out, nfe = model.sample(_torch_state(batch), torch.Generator().manual_seed(0))
    finally:
        del model.network.forward
        for f in dataclasses.fields(cfg):
            setattr(cfg, f.name, getattr(saved, f.name))
    in_window = sum(0.25 < t < 0.65 for t in sampler._build_time_grid(
        dataclasses.replace(saved, dt=0.1, corrector_steps=2, corrector_start_time=0.65,
                            corrector_finish_time=0.25))[0])
    assert in_window == 4 and nfe == 10 + 2 * in_window == len(calls)
    assert torch.isfinite(out.get_flat_lats()).all() and out.dims.min() >= 1


def test_conditioning_is_not_ported(pair):
    """Guidance is ported now (tests/test_torch_conditioning.py holds it
    against JAX); a half-set request raises as in JAX (sampler.py:193-204):
    do_conditioning without a Condition, a Condition without do_conditioning."""
    *_, model, batch = pair
    cfg = model.config.sampler_kwargs
    cfg.do_conditioning = True
    try:
        with pytest.raises(ValueError):
            model.sample(_torch_state(batch), torch.Generator().manual_seed(0))
    finally:
        cfg.do_conditioning = False
    condition = sampler.Condition(torch.zeros(B, N * 11), torch.zeros(B, N * 11),
                                  torch.ones(B, dtype=torch.int32))
    with pytest.raises(ValueError):
        model.sample(_torch_state(batch), torch.Generator().manual_seed(0), condition=condition)


@pytest.mark.parametrize("sigma", [0.0, 2.0])
def test_dims_prior_log_probs_match_jax(pair, sigma):
    jax_model, _, model, batch = pair
    _attach_prior(jax_model, model, batch)
    for cfg in (jax_model.config, model.config):
        cfg.sampler_kwargs.analytic_prior_smoothing_sigma = sigma
    try:
        got, ref = model._dims_prior_log_probs(N), jax_model._dims_prior_log_probs(N)
    finally:
        for cfg in (jax_model.config, model.config):
            cfg.sampler_kwargs.analytic_prior_smoothing_sigma = 0.0
        jax_model.graphical_structure = model.graphical_structure = None
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-6)


def test_dims_prior_sources_and_warning(pair):
    """The config's histogram stands in for an attached prior; with neither,
    a warning and None; with the feature off, None without a warning."""
    *_, model, batch = pair
    hist = multiplicity_histogram(batch[0])
    model.config.data.target_info = {"hist_num_particles": {str(k): v for k, v in hist.items()}}
    try:
        from_config = model._dims_prior_log_probs(N)
    finally:
        model.config.data.target_info = {"stats": None, "hist_num_particles": None}
    model.graphical_structure = SimpleNamespace(nodes_dist=structure.DistributionNodes(hist))
    attached = model._dims_prior_log_probs(N)
    model.graphical_structure = None
    assert torch.equal(from_config, attached)
    with pytest.warns(UserWarning, match="analytic_dim1_posterior"):
        assert model._dims_prior_log_probs(N) is None
    model.config.sampler_kwargs.analytic_dim1_posterior = False
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert model._dims_prior_log_probs(N) is None
    finally:
        model.config.sampler_kwargs.analytic_dim1_posterior = True


# ------------------------------------------------------------------ trainer


def test_resolve_train_config_matches_jax():
    ours = torch_trainer.resolve_train_config(torch_cfgs.TransdimensionalEpicConfig())
    theirs = jax_trainer.resolve_train_config(jax_cfgs.TransdimensionalEpicConfig())
    for field in ("epochs", "optimizer_name", "lr", "betas", "eps", "weight_decay",
                  "gradient_clip_val", "scheduler_name", "scheduler_params"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert (ours.optimizer_name, ours.lr, ours.gradient_clip_val) == ("Adam", 3e-5, 1.0)
    mbm = torch_cfgs.MultimodalBridgeMatchingConfig()
    assert torch_trainer.resolve_train_config(mbm) is mbm.train


def test_ema_decay_from_the_half_life():
    cfg = torch_cfgs.TransdimensionalEpicConfig()
    cfg.batch_size, cfg.ema_halflife_kimg = 1024, 10
    jax_cfg = jax_cfgs.TransdimensionalEpicConfig.from_dict(cfg.to_dict())
    model = TransdimensionalJumpDiffusion(torch_cfgs.TransdimensionalEpicConfig())
    theirs = jax_trainer.Trainer(SimpleNamespace(), jax_cfg).ema_decay
    assert torch_trainer.Trainer(model, cfg).ema_decay == theirs == 0.5 ** (1024 / 10000.0)
    assert torch_trainer.Trainer(model, cfg, ema_decay=0.9).ema_decay == 0.9
    assert torch_trainer.ema_decay_from_halflife(torch_cfgs.MultimodalBridgeMatchingConfig()) is None


def test_three_trainer_steps_match_optax(pair):
    """Adam with optax's global-norm clip at 1.0 from transplanted weights and
    injected corruption draws, at lr 1e-3 so that three steps move a
    parameter by thirty times the tolerance, and at eps 1e-4: with the
    config's 1e-8 Adam moves an element whose gradient is rounding noise by a
    full ±lr, by the noise's sign, which the two packages do not share. Every
    parameter within 1e-4·max|leaf| + 1e-6 of the JAX step's."""
    jax_model, params, model, batch = pair
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    for cfg in (model.config, jax_model.config):
        cfg.optimizer_kwargs.lr, cfg.optimizer_kwargs.eps = 1e-3, 1e-4
    tx = jax_trainer.build_optimizer(jax_trainer.resolve_train_config(jax_model.config), 1)
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(p, opt_state, ts, dims_xt, noise):
        def total(p):
            corrupted = jax_loss.corrupt_with(_jax_state(batch), jax_model.noise_schedule, ts,
                                              dims_xt, noise)
            return jax_model.jump_diffusion_loss.compute(jax_model, p, corrupted)[0]

        value, grads = jax.value_and_grad(total)(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, value

    trainer = torch_trainer.Trainer(model, model.config, seed=0, ema_decay=0.5)
    trainer.setup()
    model.load_state_dict(saved)  # setup initialised the weights: back to the transplant
    trainer.state.ema_params = {k: p.detach().clone() for k, p in trainer.state.params.items()}
    try:
        for step in range(3):
            draws, ts, dims_xt = _corruption(batch, 10 + step)
            params, opt_state, ref_loss = jax_step(params, opt_state, jnp.asarray(ts),
                                                   jnp.asarray(dims_xt), jnp.asarray(draws[2]))
            metrics = trainer.train_step([_t(b) for b in batch], draws=tuple(map(_t, draws)))
            np.testing.assert_allclose(metrics["loss"].item(), float(ref_loss), rtol=5e-4)
        ref = params_from_flax(jax.tree_util.tree_map(_np, params), model.config,
                               TransdimensionalJumpDiffusion)
        moved = 0.0
        for key, p in model.named_parameters():
            scale = ref[key].abs().max().item()
            assert (p.detach() - ref[key]).abs().max().item() <= 1e-4 * scale + 1e-6, key
            moved = max(moved, (p.detach() - saved[key]).abs().max().item())
        assert moved > 2e-3 and trainer.state.step == 3
    finally:
        model.load_state_dict(saved)
        for cfg in (model.config, jax_model.config):
            cfg.optimizer_kwargs.lr, cfg.optimizer_kwargs.eps = 3e-5, 1e-8


def test_trainer_fits_and_predicts_list_batches(tmp_path):
    """Trainer.fit on 'list' batches from the seeded initialiser: finite
    losses, the EMA decay of the config, then Trainer.predict through the
    sampler."""
    cfg = torch_cfgs.TransdimensionalEpicConfig()
    cfg.data.max_num_particles, cfg.sampler_kwargs.dt, cfg.sampler_kwargs.multi_birth = N, 0.25, 4
    cfg.optimizer_kwargs.lr, cfg.batch_size, cfg.ema_halflife_kimg = 1e-3, 8, 1
    gen = torch.Generator().manual_seed(0)
    batches = [transdim_training_batch(8, N, 3, 8, gen) for _ in range(3)]
    model = TransdimensionalJumpDiffusion(cfg)
    model.graphical_structure = SimpleNamespace(nodes_dist=structure.DistributionNodes(
        multiplicity_histogram(torch.cat([b[0] for b in batches]))))
    trainer = torch_trainer.Trainer(model, cfg, seed=0)
    history = trainer.fit(InMemoryDataModule(train=batches[:2], valid=batches[2:]), epochs=2)
    assert len(history) == 2 and all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"])
                                     for r in history)
    assert trainer.state.step == 4 and trainer.state.ema_params is not None
    assert {"train_score_loss", "train_ce_loss", "train_num_valid"} <= set(history[0])
    out = trainer.predict(batches[2:])[0]
    assert torch.isfinite(out.get_flat_lats()).all() and out.dims.min() >= 1


# ---------------------------------------------------------- init, transplant


def test_init_is_seeded_and_mirrors_flax_shapes(pair):
    jax_model, params, model, _ = pair
    fresh = init_transdimensional_parameters(TransdimensionalJumpDiffusion(model.config), 0)
    again = init_transdimensional_parameters(TransdimensionalJumpDiffusion(model.config), 0)
    other = init_transdimensional_parameters(TransdimensionalJumpDiffusion(model.config), 1)
    for (name, p), q, r in zip(fresh.state_dict().items(), again.state_dict().values(),
                               other.state_dict().values()):
        assert torch.equal(p, q), name
        assert p.dim() < 2 or not torch.equal(p, r), name
    net = fresh.network
    assert not net.temb_net.bias.any() and (net.res_0.norm1.weight == 1).all()
    w = net.pre_rate_proj.weight  # fan_in 128, a truncated normal
    assert abs(w.std().item() - 128 ** -0.5) < 0.1 * 128 ** -0.5
    assert w.abs().max().item() <= 2 * 128 ** -0.5 / 0.87962566103423978 + 1e-6
    assert isinstance(net.epic.embedding.embedding_discrete, torch.nn.Linear)
    assert {k: tuple(v.shape) for k, v in fresh.state_dict().items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}


def test_transplant_round_trip_and_strictness(pair):
    """Every flax leaf lands on one port key with its values (a Dense kernel
    transposed); a missing or an extra leaf raises."""
    _, params, model, _ = pair
    tree = jax.tree_util.tree_map(_np, params)
    state = params_from_flax(tree, model.config, TransdimensionalJumpDiffusion)
    leaves = jax.tree_util.tree_leaves(tree)
    assert len(state) == len(leaves) == len(model.state_dict())
    np.testing.assert_array_equal(state["network.epic.embedding.embedding_discrete.weight"].numpy(),
                                  tree["network"]["epic"]["embedding"]["embedding_discrete"]["kernel"].T)
    np.testing.assert_array_equal(state["network.vec_res_1.norm2.weight"].numpy(),
                                  tree["network"]["vec_res_1"]["norm2"]["scale"])
    np.testing.assert_array_equal(state["network.post_auto_proj.bias"].numpy(),
                                  tree["network"]["post_auto_proj"]["bias"])
    missing = {"network": {k: v for k, v in tree["network"].items() if k != "near_atom_proj"}}
    with pytest.raises(KeyError):
        params_from_flax(missing, model.config, TransdimensionalJumpDiffusion)
    extra = {"network": {**tree["network"], "extra_proj": {"bias": np.zeros(3, np.float32)}}}
    with pytest.raises(KeyError):
        params_from_flax(extra, model.config, TransdimensionalJumpDiffusion)
    wrong = {"network": {**tree["network"], "near_atom_proj": {
        "kernel": np.zeros((64, 1), np.float32), "bias": np.zeros(1, np.float32)}}}
    with pytest.raises(ValueError):
        params_from_flax(wrong, model.config, TransdimensionalJumpDiffusion)
