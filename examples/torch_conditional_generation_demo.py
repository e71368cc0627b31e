"""Reconstruction-guidance conditioning with the PyTorch/CUDA port (the
counterpart of examples/conditional_generation_demo.py): complete a jet
whose first k particles are observed.

Trains TransdimensionalJumpDiffusion briefly on the bundled AspenOpenJets
shard, then samples with `do_conditioning=True`: at every reverse step the
x0 prediction's error on the observed entries is differentiated through the
network's module path (`torch.autograd.grad`) and moves the score
(multimodal_particles_tpu_torch/models/generative/transdimensional/sampler.py,
`guidance`).

  python examples/torch_conditional_generation_demo.py --epochs 100
  python examples/torch_conditional_generation_demo.py --epochs 2 --sampler-steps 20 --device cpu

Runs on the GPU unless --device names another device.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--sampler-steps", type=int, default=100)
    ap.add_argument("--observed-particles", type=int, default=4)
    ap.add_argument("--guidance-weight", type=float, default=2.0)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="run directory (default: a temporary one)")
    args = ap.parse_args()

    from multimodal_particles_tpu_torch.config_classes import TransdimensionalEpicConfig
    from multimodal_particles_tpu_torch.models.generative.transdimensional.sampler import (
        Condition,
    )
    from multimodal_particles_tpu_torch.models.generative.transdimensional.structure import (
        adjust_state,
    )
    from multimodal_particles_tpu_torch.training import TransdimensionalExperiment

    config = TransdimensionalEpicConfig()
    config.data.num_jets = 100
    sk = config.sampler_kwargs
    sk.dt = 1.0 / args.sampler_steps
    sk.do_conditioning = True
    sk.guidance_weight = args.guidance_weight
    # the guidance gradient can push a briefly trained model off the data's
    # manifold; the clamp keeps the tails bounded (the data is O(1))
    sk.clip_lats = 10.0
    config.optimizer_kwargs.lr = 1e-3
    config.ema_halflife_kimg = 10

    with tempfile.TemporaryDirectory() as tmp:
        experiment = TransdimensionalExperiment(config, args.out or tmp, seed=args.seed,
                                                device=args.device)
        trainer = experiment.trainer
        trainer.files = None  # no checkpoints
        trainer.fit(experiment.datamodule, epochs=args.epochs)
    model = experiment.model
    if trainer.state.ema_params is not None:  # sample with the EMA weights
        with torch.no_grad():
            for name, p in trainer.state.params.items():
                p.copy_(trainer.state.ema_params[name])

    state = model._as_state(next(iter(experiment.datamodule.train)))
    B, k = state.B, args.observed_particles
    # the first k (highest-pT) particles of each data jet observed, in the
    # geometry the guidance compares in
    condition = Condition.observe(state, torch.full((B,), k))
    generator = torch.Generator(device=experiment.device).manual_seed(args.seed + 1)
    final, nfe = model.sample(state, generator, condition=condition)

    # scored in the same geometry: the generated jets' first k particles, centred
    generated, _ = adjust_state(final.delete_dims(condition.dims))
    observed, _ = adjust_state(state.delete_dims(condition.dims))
    err = (generated.continuous[:, :k] - observed.continuous[:, :k]).abs().mean().item()
    print(f"conditioned sampling: {B} jets, NFE={nfe}, mean dims "
          f"{final.dims.float().mean().item():.1f} (data {state.dims.float().mean().item():.1f})")
    print(f"mean |generated - observed| over the {k} conditioned particles (centred): "
          f"{err:.3f} standardized units (unconditioned jets differ by O(1))")


if __name__ == "__main__":
    main()
