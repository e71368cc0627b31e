"""Reconstruction guidance in the port's transdimensional sampler against the
JAX package's on the CPU (transdimensional/sampler.py:238-303).

The two models carry the same transplanted weights (N = 16, an 8-step grid,
the reference's single birth, no corrector); the port replays the draws the
JAX sampler makes from its key (`replay_sampler_draws`), so both take the
same noise. The guided score differentiates through the network in both
packages (JAX: `jax.value_and_grad`; the port: `torch.autograd.grad` on the
module path). Tolerances: the guidance value and gradient within rtol 1e-4
(atol 1e-4 of the gradient's largest entry); the sampled jets' dims equal on
every jet and their flat latents within rtol 1e-4 and atol 1e-3 × the jet's
largest |x|. The atol is the one the unguided sampler's test takes
(test_torch_transdim.py::_compare_samples): the seeded flow grows a jet to
|x| ≈ 1e2 in 8 steps and its O(1) entries carry the large ones' rounding
through the network; on this pair one jet's guided run parts from JAX's by
5.5e-4 of its scale and its unguided run by 7e-5, while 1-ulp nudges of the
port's own draws move it by 3e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_particles_tpu.models.generative.transdimensional import sampler as jax_sampler
from multimodal_particles_tpu.models.generative.transdimensional import (
    structure as jax_structure,
)
from multimodal_particles_tpu_torch.models.generative.transdimensional import sampler, structure
from multimodal_particles_tpu_torch.ops.epic_cuda import epic_forward_reference
from multimodal_particles_tpu_torch.ops.gsdm_stack_cuda import gsdm_stack_reference
from torch_port_helpers import replay_sampler_draws, transdim_pair

N, B, STEPS, OBSERVED = 16, 6, 8, 3
RTOL = 1e-4


@pytest.fixture(scope="module")
def guided_pair():
    """The transplanted pair with guidance on (weight 2.0) and the reference's
    single birth, and the JAX 'list' batch."""
    return transdim_pair(seed=7, n=N, b=B, sections={"sampler_kwargs": {
        "dt": 1 / STEPS, "multi_birth": 1, "do_conditioning": True,
        "guidance_weight": 2.0}})


def _states(batch):
    jax_state = jax_structure.state_from_list_batch(batch)
    port_state = structure.state_from_list_batch([torch.from_numpy(np.array(a)) for a in batch])
    return jax_state, port_state


def _conditions(jax_state, port_state):
    """JAX's condition built as its demo builds it
    (examples/conditional_generation_demo.py:76-84), the port's by
    `Condition.observe`."""
    dims = jnp.full((B,), OBSERVED, jnp.int32)
    observed, _ = jax_structure.adjust_state(jax_state.delete_dims(dims))
    mask = jax_state.get_mask_flat(dims)
    jax_cond = jax_sampler.Condition(lats=observed.get_flat_lats() * mask, mask=mask, dims=dims)
    return jax_cond, sampler.Condition.observe(port_state, torch.full((B,), OBSERVED))


def test_condition_observe_matches_the_jax_demo(guided_pair):
    *_, batch = guided_pair
    jax_cond, cond = _conditions(*_states(batch))
    for name in ("lats", "mask", "dims"):
        np.testing.assert_allclose(getattr(cond, name).numpy(), np.asarray(getattr(jax_cond, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_guidance_gradient_matches_jax_value_and_grad(guided_pair):
    """One evaluation's guidance term at t = 0.6 on the data state, the nearest
    atom drawn from one Gumbel draw on both sides: JAX's `weighted_l2`
    (sampler.py:257-286) under `jax.value_and_grad` against the port's
    `guidance`."""
    jax_model, params, model, batch = guided_pair
    jax_state, port_state = _states(batch)
    jax_cond, cond = _conditions(jax_state, port_state)
    weight = jax_model.config.sampler_kwargs.guidance_weight
    t = jnp.full((B,), 0.6)
    key = jax.random.PRNGKey(5)
    schedule = jax_model.noise_schedule

    def weighted_l2(x_flat):
        D_eps, *_ = jax_model.net_forward(params, jax_state.set_flat_lats(x_flat), t,
                                          sample_nearest_atom=True, key=key, predict="eps")
        x0_pred = schedule.predict_x0_from_xt(x_flat, D_eps, t)
        observed, _ = jax_structure.adjust_state(
            jax_state.set_flat_lats(jax_cond.mask * x0_pred).delete_dims(jax_cond.dims))
        l2 = jnp.sum(jax_cond.mask * (observed.get_flat_lats() - jax_cond.lats) ** 2, axis=1)
        alpha_t = schedule.get_p0t_stats(jnp.ones_like(x_flat), t)[0][:, 0]
        return jnp.sum(-0.5 * weight * alpha_t * l2)

    ref_value, ref_grad = jax.value_and_grad(weighted_l2)(jax_state.get_flat_lats())
    gumbel = torch.from_numpy(np.array(jax.random.gumbel(key, (B, N))))
    value, grad, *_ = sampler.guidance(model, port_state, torch.full((B,), 0.6), cond, weight,
                                       sample_nearest_atom=True, gumbel=gumbel)
    ref_grad = np.asarray(ref_grad)
    assert float(value) != 0.0 and np.abs(ref_grad).max() > 0
    np.testing.assert_allclose(float(value), float(ref_value), rtol=RTOL)
    np.testing.assert_allclose(grad.numpy(), ref_grad, rtol=RTOL,
                               atol=RTOL * np.abs(ref_grad).max())


def test_guided_sampler_matches_jax_with_replayed_draws(guided_pair):
    """8 guided steps, the reference's single birth with the birth uniforms
    halved so that births happen: JAX takes `test_draws` and its key (for the
    nearest atom); the port the same arrays and the replayed Gumbel noise.
    Every jet's dims equal, the latents within the stated tolerance, and no
    kernel's plain version called (the guided score runs the modules)."""
    jax_model, params, model, batch = guided_pair
    jax_state, port_state = _states(batch)
    jax_cond, cond = _conditions(jax_state, port_state)
    key = jax.random.PRNGKey(31)
    draws = replay_sampler_draws(key, jax_model.config.sampler_kwargs, B, N, N * 11)
    rng = np.random.default_rng(1)
    draws["u_jump"] = (rng.random(draws["u_jump"].shape) * 0.5).astype(np.float32)
    ref, ref_nfe = jax_model.sampler.sample(
        jax_model, params, jax_state, key, condition=jax_cond,
        test_draws={k: draws[k] for k in ("init", "em_noise", "u_jump", "birth_noise")})
    epic_forward_reference.calls = gsdm_stack_reference.calls = 0
    got, nfe = model.sample(port_state, draws=draws, condition=cond)
    assert epic_forward_reference.calls == gsdm_stack_reference.calls == 0
    assert nfe == ref_nfe == STEPS
    np.testing.assert_array_equal(got.dims.numpy(), np.asarray(ref.dims))
    assert got.dims.max() > 1  # births happened
    ours, theirs = got.get_flat_lats().numpy(), np.asarray(ref.get_flat_lats())
    scale = np.abs(theirs).max(axis=1, keepdims=True)
    assert np.isfinite(ours).all()
    assert (np.abs(ours - theirs) <= RTOL * np.abs(theirs) + 1e-3 * scale).all(), (
        (np.abs(ours - theirs) / scale).max())


def test_guidance_changes_the_trajectory(guided_pair):
    """From the same draws, the guided run differs from the unguided one and
    its observed rows sit closer to the observation."""
    jax_model, params, model, batch = guided_pair
    _, port_state = _states(batch)
    cond = sampler.Condition.observe(port_state, torch.full((B,), OBSERVED))
    draws = replay_sampler_draws(jax.random.PRNGKey(32), jax_model.config.sampler_kwargs, B, N,
                                 N * 11)
    guided, _ = model.sample(port_state, draws=draws, condition=cond)
    model.config.sampler_kwargs.do_conditioning = False
    try:
        plain, _ = model.sample(port_state, draws=draws)
    finally:
        model.config.sampler_kwargs.do_conditioning = True
    assert not torch.equal(guided.get_flat_lats(), plain.get_flat_lats())

    def miss(state):
        observed, _ = structure.adjust_state(state.delete_dims(cond.dims))
        return (cond.mask * (observed.get_flat_lats() - cond.lats)).abs().sum()

    assert miss(guided) < miss(plain)


def test_conditioning_errors(guided_pair):
    """JAX's two ValueErrors (sampler.py:193-204): guidance on without a
    Condition, a Condition with guidance off."""
    *_, model, batch = guided_pair
    _, port_state = _states(batch)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="requires a Condition"):
        model.sample(port_state, gen)
    cond = sampler.Condition.observe(port_state, torch.full((B,), OBSERVED))
    model.config.sampler_kwargs.do_conditioning = False
    try:
        with pytest.raises(ValueError, match="do_conditioning is False"):
            model.sample(port_state, gen, condition=cond)
    finally:
        model.config.sampler_kwargs.do_conditioning = True
