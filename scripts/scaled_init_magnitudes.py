#!/usr/bin/env python3
"""What the untrained scaled MBM backbone does in the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python scripts/scaled_init_magnitudes.py [--jets 64] [--steps 8]

`bench.py --scaled` (every encoder width 128, 6 EPiC blocks) with flax's
default initialisers, float32, plain XLA (use_pallas off). On a batch of
Gaussian source jets with multiplicities uniform in [1, 128] and a synthetic
target (kinematics normal with mean (1, 0, -0.5) and std 0.5, tokens
floor(8·u²)) it prints, one JSON line each:

  heads    the largest |drift| and |logit| of one forward at t = 0.5
  predict  the share of finite generated kinematics after the 99-step sampler
  train    the loss of each of `--steps` AdamW steps, with the optimizer that
           the Trainer builds from the config (build_optimizer)

The PyTorch port's initialiser draws from the same laws, so this is the
reference's answer to whether an untrained scaled model can be served or
trained from its seed alone. Nothing here is a device measurement.
"""

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from multimodal_particles_tpu.config_classes import MultimodalBridgeMatchingConfig  # noqa: E402
from multimodal_particles_tpu.data.particle_clouds.jets_dataloader import (  # noqa: E402
    MultimodalDatabatch,
)
from multimodal_particles_tpu.models.generative.multimodal_bridge_matching import (  # noqa: E402
    MultiModalBridgeMatching,
)
from multimodal_particles_tpu.models.generative.states import HybridState  # noqa: E402
from multimodal_particles_tpu.training.trainer import build_optimizer  # noqa: E402

N, VOCAB = 128, 8
TARGET_MEAN, TARGET_STD = (1.0, 0.0, -0.5), 0.5


def scaled_config(num_jets):
    config = MultimodalBridgeMatchingConfig()
    e = config.encoder
    e.num_blocks = 6
    e.dim_hidden_local = e.dim_hidden_glob = e.dim_emb_time = 128
    e.dim_emb_features_continuous = e.dim_emb_features_discrete = 128
    config.data.batch_size = num_jets
    config.data.max_num_particles = N
    config.bridge.num_timesteps = 100
    config.parallel.use_pallas = False
    return config


def synthetic_batch(rng, num_jets):
    mult = rng.integers(1, N + 1, (num_jets, 1))
    mask = (np.arange(N)[None, :] < mult).astype(np.float32)[..., None]
    imask = mask.astype(np.int64)
    x0 = rng.standard_normal((num_jets, N, 3)).astype(np.float32)
    x1 = (np.asarray(TARGET_MEAN) + TARGET_STD * rng.standard_normal((num_jets, N, 3))).astype(np.float32)
    u = rng.random((num_jets, N, 1))
    k1 = np.minimum((VOCAB * u * u).astype(np.int64), VOCAB - 1)
    return MultimodalDatabatch(
        source_continuous=x0 * mask, source_discrete=rng.integers(0, VOCAB, (num_jets, N, 1)) * imask,
        source_mask=mask, target_continuous=x1 * mask, target_discrete=k1 * imask, target_mask=mask,
    )


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--jets", type=int, default=64)
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    config = scaled_config(args.jets)
    model = MultiModalBridgeMatching(config)
    rng = np.random.default_rng(args.seed)
    batch = jax.tree_util.tree_map(jnp.asarray, synthetic_batch(rng, args.jets))
    params = model.init(jax.random.PRNGKey(args.seed), batch)
    count = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(params))

    state = HybridState(jnp.full((args.jets, 1, 1), 0.5), batch.source_continuous,
                        batch.source_discrete, batch.source_mask)
    heads = jax.jit(model.forward)(params, state, batch)
    print(json.dumps({"phase": "heads", "jets": args.jets, "parameters": count,
                      "max_abs_drift": float(jnp.abs(heads.continuous).max()),
                      "max_abs_logit": float(jnp.abs(heads.discrete).max())}), flush=True)

    out = jax.jit(model.predict)(params, batch, jax.random.PRNGKey(args.seed + 1))
    real = np.asarray(batch.source_mask[..., 0]) > 0
    x = np.asarray(out.continuous)[real]
    finite = np.isfinite(x)
    print(json.dumps({"phase": "predict", "steps": 99, "finite_share": float(finite.mean()),
                      "max_abs_finite_x": float(np.abs(x[finite]).max()) if finite.any() else None}),
          flush=True)

    tx = build_optimizer(config.train, steps_per_epoch=args.steps)
    opt_state = tx.init(params)

    @jax.jit
    def train_step(params, opt_state, key, batch):
        (loss, _), grads = jax.value_and_grad(model.loss_fn, has_aux=True)(params, key, batch)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for key in jax.random.split(jax.random.PRNGKey(args.seed + 2), args.steps):
        step_batch = jax.tree_util.tree_map(jnp.asarray, synthetic_batch(rng, args.jets))
        params, opt_state, loss = train_step(params, opt_state, key, step_batch)
        losses.append(float(loss))
    print(json.dumps({"phase": "train", "jets": args.jets, "lr": config.train.lr,
                      "optimizer": config.train.optimizer_name,
                      "clip": config.train.gradient_clip_val, "step_losses": losses}), flush=True)


if __name__ == "__main__":
    main()
