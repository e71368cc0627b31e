"""Shared set-up for the port's CPU tests (tests/test_torch_*.py): one JAX
model (MBM, or the absorbing family's `absorbing_pair`) and its port twin with
the same transplanted weights, and inputs made from a seed with numpy. Both
sides run in float32 on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from multimodal_particles_tpu import test_resources_dir
from multimodal_particles_tpu.config_classes import (
    AbsorbingConfig,
    MultimodalBridgeMatchingConfig,
)
from multimodal_particles_tpu.data.particle_clouds.jets_dataloader import (
    JetsDataloaderModule,
)
from multimodal_particles_tpu.models.generative.absorbing.absorbing_flows import (
    AbsorbingFlow,
)
from multimodal_particles_tpu.models.generative.multimodal_bridge_matching import (
    MultiModalBridgeMatching,
)
from multimodal_particles_tpu.ops.sampler_pallas import make_fused_sampler_step
from multimodal_particles_tpu_torch.config_classes import (
    AbsorbingConfig as TorchAbsorbingConfig,
)
from multimodal_particles_tpu_torch.config_classes import (
    MultimodalBridgeMatchingConfig as TorchConfig,
)
from multimodal_particles_tpu_torch.models.generative.absorbing.absorbing_flows import (
    AbsorbingFlow as TorchAbsorbingFlow,
)
from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (
    MultiModalBridgeMatching as TorchMBM,
)
from multimodal_particles_tpu_torch.utils.transplant import params_from_flax

CONFIG_PATH = os.path.join(test_resources_dir, "configs_files", "config-mbm-test.yaml")
B, N = 8, 16


def jax_config(num_timesteps=8, **encoder):
    """The test config at B, N; `encoder` overrides encoder fields."""
    cfg = MultimodalBridgeMatchingConfig.from_yaml(CONFIG_PATH)
    cfg.data.batch_size = B
    cfg.data.max_num_particles = N
    cfg.bridge.num_timesteps = num_timesteps
    for name, value in encoder.items():
        setattr(cfg.encoder, name, value)
    return cfg


def model_pair(seed=0, num_timesteps=8, **encoder):
    """(jax_model, jax_params, torch_model, jax_batch): flax-initialised
    weights plus seeded noise (so that biases are not zero), transplanted.
    `encoder` overrides encoder fields of the test config."""
    cfg = jax_config(num_timesteps, **encoder)
    batch = jax.tree_util.tree_map(jnp.asarray, JetsDataloaderModule.random_databatch(cfg))
    jax_model = MultiModalBridgeMatching(cfg)
    params = jax_model.init(jax.random.PRNGKey(seed), batch)
    rng = np.random.default_rng(seed)
    params_np = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        params,
    )
    torch_cfg = TorchConfig.from_dict(cfg.to_dict())
    torch_model = TorchMBM(torch_cfg)
    torch_model.load_state_dict(params_from_flax(params_np, torch_cfg))
    jax_params = jax.tree_util.tree_map(jnp.asarray, params_np)
    return jax_model, jax_params, torch_model, batch


def noisy_params(params, seed):
    """flax-initialised params plus seeded noise as numpy leaves, so that
    biases and GroupNorm offsets are not zero."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        params,
    )


def absorbing_pair(seed=0, n=N, b=B, num_timesteps=8, sections=None):
    """(jax_model, jax_params, torch_model, jax_batch) of the absorbing family
    at its default config with `n` slots and `b` jets: flax-initialised
    weights plus seeded noise, transplanted. `sections` maps a config section
    to field overrides, e.g. {"generator": {"detach_last_layer": False}}."""
    cfg = AbsorbingConfig()
    cfg.data.batch_size, cfg.data.max_num_particles = b, n
    cfg.bridge.num_timesteps = num_timesteps
    for section, fields in (sections or {}).items():
        for name, value in fields.items():
            setattr(getattr(cfg, section), name, value)
    batch = jax.tree_util.tree_map(jnp.asarray, JetsDataloaderModule.random_databatch(cfg))
    jax_model = AbsorbingFlow(cfg)
    params_np = noisy_params(jax_model.init(jax.random.PRNGKey(seed), batch), seed)
    torch_cfg = TorchAbsorbingConfig.from_dict(cfg.to_dict())
    torch_model = TorchAbsorbingFlow(torch_cfg)
    torch_model.load_state_dict(params_from_flax(params_np, torch_cfg, TorchAbsorbingFlow))
    return jax_model, jax.tree_util.tree_map(jnp.asarray, params_np), torch_model, batch


def random_state(seed=1):
    """t (B,1,1), x (B,N,3), k (B,N,1) int32, mask (B,N,1) as numpy: random
    multiplicities, jet 0 empty."""
    rng = np.random.default_rng(seed)
    t = rng.random((B, 1, 1), dtype=np.float32)
    mult = rng.integers(1, N + 1, (B, 1))
    mult[0] = 0
    mask = (np.arange(N)[None, :] < mult).astype(np.float32)[..., None]
    x = rng.standard_normal((B, N, 3)).astype(np.float32) * mask
    k = (rng.integers(0, 8, (B, N, 1)) * mask).astype(np.int32)
    return t, x, k, mask


def to_torch(*arrays):
    return tuple(torch.from_numpy(np.array(a, order="C")) for a in arrays)


def jax_step_fn(jax_model):
    """The JAX fused sampler step (ops/sampler_pallas.py) in interpret mode,
    jitted once, for (B, N) state in lane layout."""
    cfg = jax_model.config
    make_for = make_fused_sampler_step(
        num_blocks=cfg.encoder.num_blocks, use_skip=cfg.encoder.skip_connection,
        add_discrete_head=cfg.encoder.add_discrete_head, dim_c=3, vocab=8,
        gamma=cfg.bridge.gamma, dim_emb_time=cfg.encoder.dim_emb_time, interpret=True,
    )
    return jax.jit(make_for(N, B))
