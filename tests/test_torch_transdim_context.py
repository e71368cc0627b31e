"""The transdimensional model with a context, the port against the JAX package
on the CPU (transdimensional_model.py:130-138: the contexts go into the EPiC
trunk's global context).

One transplanted pair at N = 16, B = 8 with both contexts (2 continuous
values embedded 16 wide, one token of a vocabulary of 10 that the 'list'
batch carries as its one-hot, each entry embedded 16 wide), built once; a
pair with each context alone for the forward. The network is cut to one EPiC
block and one 32-wide gsdm block with one head, so that JAX's programs
compile in seconds. The weights are drawn by numpy
from flax's laws on flax's shapes (`drawn_params`) and transplanted.
Tolerances: the network's outputs rtol 1e-4 and atol 1e-5 × the output's
largest |value| (the module path's, at the scale of the two 128-channel
stacks' outputs, up to ~20 here), the loss rtol
2e-4 (test_torch_transdim.py's). The trajectories: every jet's dims equal,
and each jet's flat latents within its own bound of JAX's compiled sampler,
as a share of the jet's largest |x| (at least 1; the measure of
test_torch_transdim.py::_compare_samples): max(1e-3, 4 × the share by which
JAX's own two evaluations part on that jet, its compiled sampler and the same
sampler under `jax.disable_jit()`). The floor 1e-3 is the fixed bound this
file held before; the factor 4 covers the flow's amplification of float32
rounding, which parts JAX's two evaluations by up to 2.0e-3 on a guided jet
(scripts/transdim_trajectory_gap.py --pair context --steps 24 --guided) and
the port from them by up to 4.3e-3 there; a 1e-3 nudge of one transplanted
weight (the EPiC output layer's gain) fails the check
(`test_trajectory_check_catches_a_nudged_weight`). The trajectories take 24
steps: at 4 (dt = 0.25) β(t)·dt > 1 at every step, so √(1 − β·dt) is NaN,
`adjust_state` scrubs every latent to 0 after each Euler-Maruyama move, in
JAX and in the port alike, only the last step's births reach the final
state, and guidance, which acts through the score, changed nothing. A
context turns every kernel off, as in JAX, and the final state carries the
template's contexts bit for bit.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_particles_tpu.data.particle_clouds import jets_dataloader as jax_loader
from multimodal_particles_tpu.models.generative.transdimensional import loss as jax_loss_module
from multimodal_particles_tpu.models.generative.transdimensional import sampler as jax_sampler
from multimodal_particles_tpu.models.generative.transdimensional import (
    structure as jax_structure,
)
from multimodal_particles_tpu_torch.data.particle_clouds.jets_dataloader import (
    MultimodalBridgeDataset,
)
from multimodal_particles_tpu_torch.models.generative.transdimensional import sampler, structure
from multimodal_particles_tpu_torch.ops.epic_cuda import epic_forward_reference
from multimodal_particles_tpu_torch.ops.gsdm_stack_cuda import gsdm_stack_reference
from multimodal_particles_tpu_torch.training.transdimensional_experiment import (
    TransdimensionalExperiment,
)
from torch_port_helpers import (
    assert_batch_equals,
    jet_pair,
    replay_sampler_draws,
    transdim_contexts,
    transdim_pair,
)

N, B, STEPS, OBSERVED = 16, 8, 24, 3
GENERATE_STEPS = 4  # the experiment's generate(): what it checks is the contexts
TRAJECTORY_FLOOR, SPREAD_FACTOR = 1e-3, 4.0  # the trajectories' bound (docstring)
CONTINUOUS = {"data": {"dim_context_continuous": 2},
              "encoder": {"dim_emb_context_continuous": 16}}
DISCRETE = {"data": {"dim_context_discrete": 1, "vocab_size_context": 10},
            "encoder": {"dim_emb_context_discrete": 16}}
# the network cut as the family distribution checks cut it (one EPiC block, one
# 32-wide gsdm block with one head): the JAX programs compile in a few seconds
SMALL = {"num_blocks": 1, "n_attn_blocks": 1, "transformer_dim": 32, "n_heads": 1}
BOTH = {"data": {**CONTINUOUS["data"], **DISCRETE["data"]},
        "encoder": {**CONTINUOUS["encoder"], **DISCRETE["encoder"]}}


def _sections(contexts, **extra):
    return {"data": contexts["data"], "encoder": {**contexts["encoder"], **SMALL}, **extra}
SAMPLER = {"dt": 1 / STEPS, "multi_birth": 1, "guidance_weight": 2.0}


def _states(batch, config):
    """(JAX state, port state) of a list batch, the contexts by the config."""
    cont, disc = transdim_contexts(batch, config)
    jax_state = jax_structure.StructuredState(
        continuous=jnp.asarray(batch[1]), discrete=jnp.asarray(batch[2]),
        dims=jnp.asarray(batch[0]),
        context_continuous=None if cont is None else jnp.asarray(cont),
        context_discrete=None if disc is None else jnp.asarray(disc))
    port_state = structure.StructuredState(
        continuous=torch.from_numpy(batch[1]), discrete=torch.from_numpy(batch[2]),
        dims=torch.from_numpy(batch[0]),
        context_continuous=None if cont is None else torch.from_numpy(cont),
        context_discrete=None if disc is None else torch.from_numpy(disc))
    return jax_state, port_state


@pytest.fixture(scope="module")
def pair():
    return transdim_pair(seed=11, n=N, b=B, sections=_sections(BOTH, sampler_kwargs=SAMPLER),
                         drawn_init=True)


def _net_inputs(seed=1):
    rng = np.random.default_rng(seed)
    ts = rng.uniform(0.05, 1.0, B).astype(np.float32)
    return ts, rng.integers(0, N, B)


@pytest.mark.parametrize("contexts", ["both", "continuous", "discrete"])
def test_network_with_a_context_matches_flax(pair, contexts):
    """All six outputs of TransdimensionalEPiC with the contexts fed to the
    trunk; a context changes them (the trunk reads it)."""
    sections = {"both": BOTH, "continuous": CONTINUOUS, "discrete": DISCRETE}[contexts]
    jax_model, params, model, batch = pair if contexts == "both" else transdim_pair(
        seed=12, n=N, b=B, sections=_sections(sections), drawn_init=True)
    jax_state, port_state = _states(batch, jax_model.config)
    ts, nearest = _net_inputs()
    nearest = np.minimum(nearest, batch[0] - 1).astype(np.int32)
    ref = jax.jit(jax_model.network.apply)({"params": params["network"]}, jax_state,
                                           jnp.asarray(ts), jnp.asarray(nearest))
    with torch.no_grad():
        got = model.network(port_state, torch.from_numpy(ts), torch.from_numpy(nearest).long())
        other = port_state.replace(**{
            name: torch.roll(value, 1, dims=0) for name in ("context_continuous",
                                                             "context_discrete")
            if (value := getattr(port_state, name)) is not None})
        moved = model.network(other, torch.from_numpy(ts), torch.from_numpy(nearest).long())
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(r).max())))
    assert not torch.equal(got[0], moved[0])


def test_loss_fn_with_a_context_matches_jax_under_the_same_draws(pair):
    """The port's `loss_fn` with injected draws (the times' uniforms, the
    Poisson deletions, the normals) against JAX's loss on the corruption
    that those draws make (`corrupt_with`, then `compute`: what JAX's
    `loss_fn` runs after it draws them from its key)."""
    jax_model, params, model, batch = pair
    jax_state, _ = _states(batch, jax_model.config)
    rng = np.random.default_rng(3)
    u = rng.random(B).astype(np.float32)
    deleted = rng.integers(0, 6, B).astype(np.int32)
    noise = rng.standard_normal((B, N * 11)).astype(np.float32)
    min_t = jax_model.jump_diffusion_loss.min_t
    ts = (min_t + (1.0 - min_t) * u).astype(np.float32)
    dims_xt = np.maximum(batch[0] - deleted, 1).astype(np.int32)

    def jax_loss(p):
        corrupted = jax_loss_module.corrupt_with(jax_state, jax_model.noise_schedule,
                                                 jnp.asarray(ts), jnp.asarray(dims_xt),
                                                 jnp.asarray(noise))
        return jax_model.jump_diffusion_loss.compute(jax_model, p, corrupted)

    ref, ref_parts = jax.jit(jax_loss)(params)
    got, parts = model.loss_fn([torch.from_numpy(a) for a in batch],
                               draws=tuple(map(torch.from_numpy, (u, deleted, noise))))
    assert got.requires_grad and np.isfinite(float(ref))
    np.testing.assert_allclose(got.item(), float(ref), rtol=2e-4)
    for name in ("score_loss", "rate_loss", "auto_loss", "ce_loss", "nearest_atom_loss"):
        np.testing.assert_allclose(parts[name].item(), float(ref_parts[name]), rtol=1e-3,
                                   atol=1e-5, err_msg=name)


def _draws(jax_model):
    """The draws JAX makes from its key 41, the birth uniforms halved so that
    births happen."""
    draws = replay_sampler_draws(jax.random.PRNGKey(41), jax_model.config.sampler_kwargs, B, N,
                                 N * 11)
    draws["u_jump"] = (np.random.default_rng(2).random(draws["u_jump"].shape)
                       * 0.5).astype(np.float32)
    return draws


def _jax_trajectories(pair, guided):
    """JAX's single-birth trajectory from its key's draws, guided or not (the
    first OBSERVED rows observed): (compiled, operation by operation)."""
    jax_model, params, _, batch = pair
    jax_state, _ = _states(batch, jax_model.config)
    draws = _draws(jax_model)
    jax_cond = None
    if guided:
        dims = jnp.full((B,), OBSERVED, jnp.int32)
        observed, _ = jax_structure.adjust_state(jax_state.delete_dims(dims))
        mask = jax_state.get_mask_flat(dims)
        jax_cond = jax_sampler.Condition(lats=observed.get_flat_lats() * mask, mask=mask,
                                         dims=dims)
    cfg = jax_model.config.sampler_kwargs
    cfg.do_conditioning = guided
    try:
        def run():
            final, nfe = jax_model.sampler.sample(
                jax_model, params, jax_state, jax.random.PRNGKey(41), condition=jax_cond,
                test_draws={k: draws[k] for k in ("init", "em_noise", "u_jump", "birth_noise")})
            assert nfe == STEPS
            return final
        compiled = run()
        with jax.disable_jit():
            eager = run()
    finally:
        cfg.do_conditioning = False
    return compiled, eager


@pytest.fixture(scope="module")
def jax_runs(pair):
    """guided → JAX's (compiled, operation by operation) trajectories."""
    return {guided: _jax_trajectories(pair, guided) for guided in (False, True)}


def _port_trajectory(pair, guided, model=None):
    """The port's trajectory from the same draws: (final state, template)."""
    jax_model, _, port_model, batch = pair
    model = model or port_model
    _, port_state = _states(batch, jax_model.config)
    cond = sampler.Condition.observe(port_state, torch.full((B,), OBSERVED)) if guided else None
    cfg = model.config.sampler_kwargs
    cfg.do_conditioning = guided
    try:
        epic_forward_reference.calls = gsdm_stack_reference.calls = 0
        got, nfe = model.sample(port_state, draws=_draws(jax_model), condition=cond)
    finally:
        cfg.do_conditioning = False
    assert nfe == STEPS
    assert epic_forward_reference.calls == gsdm_stack_reference.calls == 0  # the modules ran
    return got, port_state


def _shares_of_bound(got, compiled, eager):
    """Each jet's largest |Δ flat latents| from JAX's compiled sampler, as a
    share of the jet's bound: max(TRAJECTORY_FLOOR, SPREAD_FACTOR × the share
    of the jet's scale by which JAX's two evaluations part), the scale the
    jet's largest |x|, at least 1."""
    ref = np.asarray(compiled.get_flat_lats())
    scale = np.maximum(np.abs(ref).max(axis=1), 1.0)
    spread = np.abs(np.asarray(eager.get_flat_lats()) - ref).max(axis=1) / scale
    gap = np.abs(got.get_flat_lats().numpy() - ref).max(axis=1) / scale
    return gap / np.maximum(TRAJECTORY_FLOOR, SPREAD_FACTOR * spread)


@pytest.mark.parametrize("guided", [False, True], ids=["unguided", "guided"])
def test_trajectory_with_a_context_matches_jax(pair, jax_runs, guided):
    """The 24-step single-birth trajectory of both packages from the draws
    that JAX makes from its key, guided or not: dims equal, every jet within
    its bound (the module docstring), the contexts carried bit for bit; under
    guidance JAX's own trajectory is not its unguided one."""
    compiled, eager = jax_runs[guided]
    got, template = _port_trajectory(pair, guided)
    np.testing.assert_array_equal(got.dims.numpy(), np.asarray(compiled.dims))
    np.testing.assert_array_equal(np.asarray(eager.dims), np.asarray(compiled.dims))
    assert got.dims.max() > 1  # births happened
    assert np.isfinite(got.get_flat_lats().numpy()).all()
    shares = _shares_of_bound(got, compiled, eager)
    assert (shares <= 1.0).all(), shares
    if guided:
        unguided = jax_runs[False][0]
        assert not np.array_equal(np.asarray(compiled.get_flat_lats()),
                                  np.asarray(unguided.get_flat_lats()))
    for name in ("context_continuous", "context_discrete"):  # bit for bit
        assert torch.equal(getattr(got, name), getattr(template, name)), name
        np.testing.assert_array_equal(np.asarray(getattr(compiled, name)),
                                      getattr(template, name).numpy())


def test_trajectory_check_catches_a_nudged_weight(pair, jax_runs):
    """The negative control of the trajectories' bound: the port with one
    transplanted weight moved by 1e-3 of itself (the EPiC trunk's output
    layer gain) parts from JAX beyond it on some jet."""
    model = copy.deepcopy(pair[2])
    with torch.no_grad():
        model.network.epic.epic.output_layer.g.mul_(1.0 + 1e-3)
    got, _ = _port_trajectory(pair, False, model)
    assert (_shares_of_bound(got, *jax_runs[False]) > 1.0).any()


def test_kernel_gate_is_off_with_a_context_as_in_jax(pair):
    """JAX's `_pallas_enabled` is False with a context (`epic_pattern_supported`
    reads both context widths), whatever `use_pallas` says; the port's too,
    on a CUDA device string, and its kernel entry points refuse the config.
    Without the context (and at the kernels' 128 channels, which the gate
    reads from the config alone) the same gates hold."""
    jax_model, _, model, batch = pair
    jax_par, par = jax_model.config.parallel, model.config.parallel
    saved = model.config.data.dim_context_continuous, model.config.data.dim_context_discrete
    try:
        for flag in ("auto", True):
            jax_par.use_pallas = par.use_pallas = flag
            assert not model._pallas_enabled("cuda") and not model._pallas_enabled("cpu")
        assert not jax_model._pallas_enabled()
        for c in (model.config, jax_model.config):
            c.data.dim_context_continuous = c.data.dim_context_discrete = 0
            c.encoder.transformer_dim = 128
        assert model._pallas_enabled("cuda") and jax_model._pallas_enabled()
    finally:
        jax_par.use_pallas = par.use_pallas = "auto"
        for c in (model.config, jax_model.config):
            c.data.dim_context_continuous, c.data.dim_context_discrete = saved
            c.encoder.transformer_dim = SMALL["transformer_dim"]
    assert "context" in model.kernel_refusal()
    with pytest.raises(ValueError, match="context"):
        model.pack_for_kernel()
    _, port_state = _states(batch, jax_model.config)
    with pytest.raises(ValueError, match="context"):
        model.forward_kernel(port_state, torch.full((B,), 0.5), torch.zeros(B, dtype=torch.long))


def test_list_loader_carries_the_contexts_with_the_first_token_one_hot(tmp_path):
    """The 'list' loader of each package on the bundled shard with contexts
    attached: the same batches, the discrete context as the one-hot of its
    first token (jets_dataloader.py:94-95); then the port's experiment trains
    a step on those batches and generates, its final states carrying the
    batches' contexts."""
    jax_cfg, cfg, ref_jets, got_jets = jet_pair("transdim", max_num_particles=32,
                                                **BOTH["data"])
    for c in (jax_cfg, cfg):
        for name, value in _sections(BOTH)["encoder"].items():
            setattr(c.encoder, name, value)
    rng = np.random.default_rng(0)
    n_jets = len(got_jets.target)
    contexts = {"context_continuous": rng.standard_normal((n_jets, 2)).astype(np.float32),
                "context_discrete": rng.integers(0, 10, (n_jets, 2))}  # two tokens: one is read
    for jets in (ref_jets, got_jets):
        for name, value in contexts.items():
            setattr(jets, name, value)
    ref = jax_loader.MultimodalBridgeDataset(ref_jets, "list")
    got = MultimodalBridgeDataset(got_jets, "list", device="cpu")
    idx = np.array([3, 0, 7, 5])
    assert_batch_equals(got.gather(idx), ref.gather(idx))
    np.testing.assert_array_equal(got.gather(idx)[4].numpy(),
                                  np.eye(10)[contexts["context_discrete"][idx, 0]])

    cfg.data.batch_size = 64
    cfg.sampler_kwargs.dt = 1 / GENERATE_STEPS
    with pytest.raises(ValueError, match="no context"):
        TransdimensionalExperiment(cfg, str(tmp_path / "none"), device="cpu")
    contexts["context_discrete"] = contexts["context_discrete"][:, :1]
    experiment = TransdimensionalExperiment(cfg, str(tmp_path / "run"), device="cpu",
                                            contexts=contexts)
    history = experiment.train(1)
    assert np.isfinite(history[-1]["train_loss"])
    batches = list(experiment.datamodule.valid)
    states = experiment.generate()
    for batch, state in zip(batches, states):
        assert torch.equal(state.context_continuous, batch[3])
        assert torch.equal(state.context_discrete, batch[4])
        assert state.dims.min() >= 1 and state.dims.max() <= cfg.data.max_num_particles
