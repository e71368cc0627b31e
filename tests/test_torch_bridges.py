"""The bridge functions and methods of
multimodal_particles_tpu/models/generative/bridges.py that the samplers do
not call, on the port, against the JAX package on the CPU:
`tau_leaping_step` (the single-jump closed form) bit for bit on JAX's
uniforms replayed from its key; the reference's Poisson tau-leaping
(`tau_leaping_step_poisson`) against the closed form in distribution, with
the statistics of tests/test_generative/test_bridges.py:160-190 (stay
probability and per-state occupancy within 0.01 over 20 × 64 × 64 draws);
`TelegraphBridge.rate` / `transition_probability` /
`conditional_probability` and `LinearUniformBridge.diffusion` against JAX's
at float32 rounding (rtol 1e-5, atol 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_particles_tpu.config_classes import MultimodalBridgeMatchingConfig
from multimodal_particles_tpu.models.generative import bridges as jax_bridges
from multimodal_particles_tpu_torch import config_classes as port_cfgs
from multimodal_particles_tpu_torch.models.generative import bridges

VOCAB, GAMMA = 8, 0.125
TOL = dict(rtol=1e-5, atol=1e-6)


def rates_of(b, n, seed, t=0.6):
    """(k0 (b, n, 1) int32, rates (b, n, VOCAB)) from the telegraph reverse
    rate at time t on seeded logits, as numpy."""
    rng = np.random.default_rng(seed)
    k0 = rng.integers(0, VOCAB, (b, n, 1)).astype(np.int32)
    logits = (rng.standard_normal((b, n, VOCAB)) * 2.0).astype(np.float32)
    rates = jax_bridges.telegraph_rate(jnp.full((b, 1, 1), t), jnp.asarray(k0),
                                       jnp.asarray(logits), GAMMA, VOCAB)
    return k0, np.array(rates)


@pytest.mark.parametrize("dt", [0.02, 0.1])
def test_tau_leaping_step_matches_jax_bit_for_bit(dt):
    """JAX draws u_jump and u_target from split(key); the port takes them as
    tensors."""
    b, n = 16, 32
    k0, rates = rates_of(b, n, 1)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jax_bridges.tau_leaping_step(key, jnp.asarray(k0), jnp.asarray(rates), dt,
                                                  VOCAB))
    key_jump, key_target = jax.random.split(key)
    u_jump, u_target = (torch.from_numpy(np.array(jax.random.uniform(k, (b, n))))
                        for k in (key_jump, key_target))
    got = bridges.tau_leaping_step(torch.from_numpy(k0), torch.from_numpy(rates), dt, VOCAB,
                                   u_jump, u_target)
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, n, 1)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref != k0).mean() > 0.01  # some tokens jumped


def test_tau_leaping_poisson_matches_the_closed_form_in_distribution():
    """The literal reference update (S Poisson counts, kept when their total
    is at most 1) against the closed form, each from its own draws."""
    b, n = 64, 64
    k0_np, rates_np = rates_of(b, n, 0)
    k0, rates = torch.from_numpy(k0_np), torch.from_numpy(rates_np)
    gen = torch.Generator().manual_seed(0)
    fast_counts = np.zeros(VOCAB)
    ref_counts = np.zeros(VOCAB)
    stay_fast = stay_ref = 0
    for _ in range(20):
        u = torch.rand((2, b, n), generator=gen)
        kf = bridges.tau_leaping_step(k0, rates, 0.02, VOCAB, u[0], u[1]).numpy()
        kr = bridges.tau_leaping_step_poisson(k0, rates, 0.02, VOCAB, generator=gen).numpy()
        fast_counts += np.bincount(kf.ravel(), minlength=VOCAB)
        ref_counts += np.bincount(kr.ravel(), minlength=VOCAB)
        stay_fast += int((kf == k0_np).sum())
        stay_ref += int((kr == k0_np).sum())
    total = fast_counts.sum()
    assert abs(stay_fast - stay_ref) / total < 0.01
    np.testing.assert_allclose(fast_counts / total, ref_counts / total, atol=0.01)
    assert stay_ref < total  # the Poisson path did jump


def test_tau_leaping_poisson_keeps_single_jumps_only():
    """With huge rates every particle draws several counts and none moves; a
    zero rate never moves."""
    k0 = torch.randint(0, VOCAB, (4, 8, 1), generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    big = torch.full((4, 8, VOCAB), 1e3)
    assert torch.equal(bridges.tau_leaping_step_poisson(k0, big, 1.0, VOCAB, gen), k0)
    assert torch.equal(bridges.tau_leaping_step_poisson(k0, torch.zeros_like(big), 1.0, VOCAB,
                                                        gen), k0)


@pytest.fixture(scope="module")
def bridge_pair():
    cfg = MultimodalBridgeMatchingConfig()
    port = port_cfgs.MultimodalBridgeMatchingConfig.from_dict(cfg.to_dict())
    return (jax_bridges.TelegraphBridge.from_config(cfg), bridges.TelegraphBridge.from_config(port),
            jax_bridges.LinearUniformBridge.from_config(cfg),
            bridges.LinearUniformBridge.from_config(port))


def test_telegraph_bridge_methods_match_jax(bridge_pair):
    tel_j, tel, _, _ = bridge_pair
    b, n = 6, 10
    rng = np.random.default_rng(4)
    t = rng.random((b, 1, 1)).astype(np.float32)
    k0 = rng.integers(0, VOCAB, (b, n, 1)).astype(np.int32)
    k1 = rng.integers(0, VOCAB, (b, n, 1)).astype(np.int32)
    logits = rng.standard_normal((b, n, VOCAB)).astype(np.float32)
    tt, k0t, k1t, lt = (torch.from_numpy(a) for a in (t, k0, k1, logits))
    pairs = [
        (tel.rate(tt, k0t, lt), tel_j.rate(jnp.asarray(t), jnp.asarray(k0), jnp.asarray(logits))),
        (tel.transition_probability(tt, k0t, k1t),
         tel_j.transition_probability(jnp.asarray(t), jnp.asarray(k0), jnp.asarray(k1))),
        (tel.conditional_probability(tt * 0.5, tt, k0t, k1t),
         tel_j.conditional_probability(jnp.asarray(t) * 0.5, jnp.asarray(t), jnp.asarray(k0),
                                       jnp.asarray(k1))),
    ]
    for got, ref in pairs:
        assert tuple(got.shape) == tuple(ref.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    probs = pairs[1][0]
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("t", [0.3, np.array([[[0.1]], [[0.9]]], np.float32)])
def test_linear_uniform_bridge_diffusion_is_zero_as_in_jax(bridge_pair, t):
    _, _, lin_j, lin = bridge_pair
    got, ref = lin.diffusion(torch.as_tensor(t)), lin_j.diffusion(jnp.asarray(t))
    assert tuple(got.shape) == tuple(ref.shape) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
