"""The port's sampler step: its plain version against the JAX fused step in
interpret mode with the same uniforms, the bridge pieces against the JAX
bridges, and the CPU behaviour of the kernel wrappers and the build.

Tolerances: x atol 1e-5 / rtol 1e-4 (float32 both sides, sums in other
orders); tokens may differ on at most 1% of slots, where a uniform falls
within rounding of a CDF boundary (as tests/test_ops/test_sampler_pallas.py
allows)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_particles_tpu.models.generative import bridges as jax_bridges
from multimodal_particles_tpu.ops.epic_pallas import pack_mbm_encoder_params as jax_pack
from multimodal_particles_tpu_torch.models.generative import bridges
from multimodal_particles_tpu_torch.models.generative.states import (
    HybridState,
    MultiHeadOutput,
)
from multimodal_particles_tpu_torch.ops import _build
from multimodal_particles_tpu_torch.ops.epic_cuda import (
    epic_forward,
    epic_forward_reference,
    pack_mbm_encoder_params,
)
from multimodal_particles_tpu_torch.ops.sampler_cuda import (
    sampler_step,
    sampler_step_reference,
)
from torch_port_helpers import B, N, jax_step_fn, model_pair, random_state, to_torch

torch.backends.cuda.matmul.allow_tf32 = False
ATOL, RTOL = 1e-5, 1e-4
MAX_TOKEN_MISMATCH = 0.01


@pytest.fixture(scope="module")
def pair():
    return model_pair()


@pytest.mark.parametrize("t", [0.45, 1.0 - 1e-4])
def test_sampler_step_reference_matches_pallas_interpret(pair, t):
    jax_model, params, torch_model, _ = pair
    _, x, k, mask = random_state()
    u = np.random.default_rng(3).random((2, B, N), dtype=np.float32)
    dt = 0.01
    rows = B * N
    x_j, k_j = jax_step_fn(jax_model)(
        jax_pack(params["encoder"], jax_model.config.encoder.num_blocks),
        jnp.asarray(x.reshape(rows, 3).T), jnp.asarray(k.reshape(1, rows)),
        jnp.asarray(mask.reshape(1, rows)), jnp.asarray(u.reshape(2, rows)), t, dt,
    )
    x_ref = np.asarray(x_j).T.reshape(B, N, 3)
    k_ref = np.asarray(k_j).reshape(B, N, 1)

    with torch.no_grad():
        packed = pack_mbm_encoder_params(torch_model.encoder, torch_model.config)
        x_new, k_new = sampler_step_reference(
            packed, *to_torch(x, k, mask, u), t, dt, gamma=torch_model.config.bridge.gamma)
    assert k_new.dtype == torch.int32
    np.testing.assert_allclose(x_new.numpy(), x_ref, atol=ATOL, rtol=RTOL)
    assert (k_new.numpy() != k_ref).mean() <= MAX_TOKEN_MISMATCH
    assert (k_new.numpy()[mask == 0] == 0).all()


def test_telegraph_rate_matches_jax():
    rng = np.random.default_rng(4)
    t = rng.random((B, 1, 1), dtype=np.float32)
    k = rng.integers(0, 8, (B, N, 1))
    logits = rng.standard_normal((B, N, 8)).astype(np.float32)
    ref = jax_bridges.telegraph_rate(jnp.asarray(t), jnp.asarray(k), jnp.asarray(logits), 0.125, 8)
    got = bridges.telegraph_rate(*to_torch(t, k, logits), 0.125, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_telegraph_solver_step_follows_the_single_jump_law():
    """The token update equals the closed form computed in numpy from the
    JAX rates, with the same uniforms (bridges.py:205-244)."""
    rng = np.random.default_rng(5)
    t = np.full((B, 1, 1), 0.3, np.float32)
    k = rng.integers(0, 8, (B, N, 1))
    logits = rng.standard_normal((B, N, 8)).astype(np.float32)
    mask = (rng.random((B, N, 1)) < 0.7).astype(np.float32)
    u = rng.random((2, B, N), dtype=np.float32)
    dt = 0.05
    lam = np.asarray(jax_bridges.telegraph_rate(
        jnp.asarray(t), jnp.asarray(k), jnp.asarray(logits), 0.125, 8)) * dt
    lam_tot = lam.sum(-1)
    jump = u[0] < lam_tot * np.exp(-lam_tot)
    target = (u[1][..., None] * lam_tot[..., None] >= np.cumsum(lam, -1)).sum(-1).clip(0, 7)
    expected = (np.where(jump, target, k[..., 0]) * mask[..., 0]).astype(np.int64)

    bridge = bridges.TelegraphBridge(gamma=0.125, vocab_size=8)
    t_t, k_t, logits_t, mask_t, u_t = to_torch(t, k, logits, mask, u)
    state = HybridState(time=t_t, discrete=k_t)
    heads = MultiHeadOutput(discrete=logits_t, absorbing=mask_t)
    got = bridge.solver_step(state, heads, dt, u_t).discrete
    assert got.dtype == k_t.dtype
    assert (got.numpy()[..., 0] != expected).mean() <= MAX_TOKEN_MISMATCH
    assert 0.05 < jump.mean() < 0.95  # the draw exercises both branches


def test_linear_uniform_solver_step_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, N, 3)).astype(np.float32)
    drift = rng.standard_normal((B, N, 3)).astype(np.float32)
    mask = (rng.random((B, N, 1)) < 0.7).astype(np.float32)
    from multimodal_particles_tpu.models.generative.states import HybridState as JaxState
    from multimodal_particles_tpu.models.generative.states import MultiHeadOutput as JaxHeads

    ref = jax_bridges.LinearUniformBridge(sigma=1e-4).solver_step(
        None, JaxState(continuous=jnp.asarray(x)),
        JaxHeads(continuous=jnp.asarray(drift), absorbing=jnp.asarray(mask)), 0.01)
    x_t, drift_t, mask_t = to_torch(x, drift, mask)
    got = bridges.LinearUniformBridge(sigma=1e-4).solver_step(
        HybridState(continuous=x_t), MultiHeadOutput(continuous=drift_t, absorbing=mask_t), 0.01)
    np.testing.assert_allclose(got.continuous.numpy(), np.asarray(ref.continuous), atol=ATOL, rtol=RTOL)


def test_wrappers_take_plain_version_on_cpu(pair):
    torch_model = pair[2]
    t, x, k, mask = to_torch(*random_state())
    u = torch.rand((2, B, N), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        packed = pack_mbm_encoder_params(torch_model.encoder, torch_model.config)
        calls = epic_forward_reference.calls, sampler_step_reference.calls
        launches = epic_forward.launches, sampler_step.launches
        out = epic_forward(packed, t, x, k, mask)
        x_new, k_new = sampler_step(packed, x, k, mask, u, 0.5, 0.01, gamma=0.125)
        assert torch.equal(out, epic_forward_reference(packed, t, x, k, mask))
        x_ref, k_ref = sampler_step_reference(packed, x, k, mask, u, 0.5, 0.01, gamma=0.125)
    assert torch.equal(x_new, x_ref) and torch.equal(k_new, k_ref)
    assert epic_forward_reference.calls == calls[0] + 2
    assert sampler_step_reference.calls == calls[1] + 2
    assert (epic_forward.launches, sampler_step.launches) == launches


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library()
    assert not (tmp_path / "build").exists()
