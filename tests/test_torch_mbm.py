"""The port's MBM sampler slice against the JAX package on the CPU: the
8-timestep slice with injected uniforms against a loop of JAX's
interpret-mode fused step, `predict` against JAX `model.predict` in
distribution, the kernel gate, and the port's freedom from JAX.

Tolerances: x atol 1e-5 / rtol 1e-4, tokens mismatching on at most 1% of
slots (float32 both sides, rare CDF-boundary flips); in distribution, mean
within 0.1 and std within 10% (tests/test_ops/test_sampler_pallas.py:119-140).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_particles_tpu.ops.epic_pallas import pack_mbm_encoder_params as jax_pack
from multimodal_particles_tpu_torch.data import MultimodalDatabatch
from multimodal_particles_tpu_torch.models.generative.states import HybridState
from multimodal_particles_tpu_torch.ops.sampler_cuda import sampler_step
from torch_port_helpers import B, N, jax_step_fn, model_pair, random_state, to_torch

torch.backends.cuda.matmul.allow_tf32 = False
ATOL, RTOL = 1e-5, 1e-4
MAX_TOKEN_MISMATCH = 0.01
STEPS = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    return model_pair(num_timesteps=STEPS)


def source_batch():
    _, x, k, mask = random_state(seed=7)
    return x, k, mask


@pytest.mark.parametrize("use_pallas", [False, True])
def test_slice_matches_jax_interpret_loop(pair, use_pallas):
    """8 timesteps = 7 steps at time_steps[1:], same uniforms on both sides;
    use_pallas=True sends the port through fused_simulate_dynamics (the
    kernel wrapper, which takes its plain version on the CPU), False through
    the module loop."""
    jax_model, params, torch_model, _ = pair
    x, k, mask = source_batch()
    u = np.random.default_rng(8).random((STEPS - 1, 2, B, N), dtype=np.float32)

    cfg_b = jax_model.config.bridge
    time_steps = jnp.linspace(0.0, 1.0 - cfg_b.time_eps, cfg_b.num_timesteps)
    delta_t = (time_steps[-1] - time_steps[0]) / (cfg_b.num_timesteps - 1)
    step = jax_step_fn(jax_model)
    packed = jax_pack(params["encoder"], jax_model.config.encoder.num_blocks)
    rows = B * N
    xT, kT = jnp.asarray(x.reshape(rows, 3).T), jnp.asarray(k.reshape(1, rows))
    maskT = jnp.asarray(mask.reshape(1, rows))
    for i, t in enumerate(time_steps[1:]):
        xT, kT = step(packed, xT, kT, maskT, jnp.asarray(u[i].reshape(2, rows)), t, delta_t)
    x_ref = np.asarray(xT).T.reshape(B, N, 3)
    k_ref = np.asarray(kT).reshape(B, N, 1)

    torch_model.config.parallel.use_pallas = use_pallas
    try:
        batch = MultimodalDatabatch(*to_torch(x, k, mask))
        out = torch_model.predict(batch, uniforms=torch.from_numpy(u))
    finally:
        torch_model.config.parallel.use_pallas = "auto"
    assert out.discrete.dtype == torch.int32
    np.testing.assert_allclose(out.continuous.numpy(), x_ref, atol=ATOL, rtol=RTOL)
    assert (out.discrete.numpy() != k_ref).mean() <= MAX_TOKEN_MISMATCH
    assert (k_ref != k).mean() > 0.1  # the tokens did move


def test_step_count_and_times(pair, monkeypatch):
    """The fused path runs num_timesteps - 1 steps at time_steps[1:]."""
    torch_model = pair[2]
    seen = []

    def spy(packed, x, k, mask, u, t, dt, *, gamma):
        seen.append((t, dt))
        return sampler_step(packed, x, k, mask, u, t, dt, gamma=gamma)

    from multimodal_particles_tpu_torch.ops import sampler_cuda

    monkeypatch.setattr(sampler_cuda, "sampler_step", spy)
    monkeypatch.setattr(torch_model.config.parallel, "use_pallas", True)
    x, k, mask = source_batch()
    torch_model.predict(MultimodalDatabatch(*to_torch(x, k, mask)),
                        generator=torch.Generator().manual_seed(0))
    ts = np.linspace(0.0, 1.0 - 1e-4, STEPS, dtype=np.float32)
    assert len(seen) == STEPS - 1
    np.testing.assert_allclose([t for t, _ in seen], ts[1:], rtol=1e-6)
    np.testing.assert_allclose(seen[0][1], (ts[-1] - ts[0]) / (STEPS - 1), rtol=1e-6)


def test_predict_matches_jax_in_distribution(pair):
    jax_model, params, torch_model, batch = pair
    final_jax = jax_model.predict(params, batch, jax.random.PRNGKey(5))
    torch_batch = MultimodalDatabatch(*to_torch(
        np.asarray(batch.source_continuous), np.asarray(batch.source_discrete),
        np.asarray(batch.source_mask)))
    final = torch_model.predict(torch_batch, generator=torch.Generator().manual_seed(5))
    a = np.asarray(final_jax.continuous)
    b = final.continuous.numpy()
    assert np.isfinite(b).all()
    np.testing.assert_allclose(a.mean(), b.mean(), atol=0.1)
    np.testing.assert_allclose(a.std(), b.std(), rtol=0.1)
    tokens = final.discrete.numpy()
    assert ((tokens >= 0) & (tokens < 8)).all()
    assert (tokens[np.asarray(batch.source_mask) == 0] == 0).all()


def test_kernel_gate(pair):
    torch_model = pair[2]
    par = torch_model.config.parallel
    try:
        assert not torch_model.kernel_enabled("cpu")  # 'auto' on the CPU
        assert torch_model.kernel_enabled("cuda")
        par.use_pallas = True
        assert torch_model.kernel_enabled("cpu")
        par.use_pallas = False
        assert not torch_model.kernel_enabled("cuda")
        par.use_pallas = "auto"
        torch_model.config.encoder.dim_hidden_local = 24  # no kernel instance
        assert not torch_model.kernel_enabled("cuda")
    finally:
        par.use_pallas = "auto"
        torch_model.config.encoder.dim_hidden_local = 16


def test_forward_kernel_matches_module_forward(pair):
    torch_model = pair[2]
    state = HybridState(*to_torch(*random_state()))
    with torch.no_grad():
        ref = torch_model.forward(state)
        got = torch_model.forward_kernel(state)
    torch.testing.assert_close(got.continuous, ref.continuous, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(got.discrete, ref.discrete, atol=ATOL, rtol=RTOL)


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py's imports, load neither
    JAX, flax, optax nor the JAX package: the card's machine has none of them."""
    code = (
        "import pkgutil, sys\n"
        "import multimodal_particles_tpu_torch as port\n"
        "names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.')]\n"
        "for name in names:\n"
        "    __import__(name)\n"
        "import chip_smoke\n"
        "need = {'ops.attention_cuda', 'ops.gsdm_stack_cuda', 'ops.survival_cuda',\n"
        "        'models.generative.absorbing.absorbing_flows', 'config_classes',\n"
        "        'models.generative.transdimensional.transdimensional_model',\n"
        "        'models.generative.transdimensional.sampler', 'training.trainer'}\n"
        "missing = {n for n in need if port.__name__ + '.' + n not in names}\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'multimodal_particles_tpu')]\n"
        "print(len(names), sorted(missing), bad)\n"
        "sys.exit(1 if bad or missing or len(names) < 30 else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
