"""Transdimensional jump-diffusion walkthrough with the PyTorch/CUDA port:
train and sample jets whose particle count is generated by birth jumps from
dims = 1, the counterpart of examples/transdimensional_demo.py.

  python examples/torch_transdimensional_demo.py --epochs 20
  python examples/torch_transdimensional_demo.py --epochs 1 --sampler-steps 5 --device cpu

Runs on the GPU unless --device names another device; there each network
evaluation launches the fused EPiC forward (K1) once and the gsdm stack (K7)
twice. Without --out the run directory is a temporary one, removed at the end.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402


def run(args, run_dir):
    from multimodal_particles_tpu_torch.config_classes import TransdimensionalEpicConfig
    from multimodal_particles_tpu_torch.training import TransdimensionalExperiment

    config = TransdimensionalEpicConfig()
    config.data.num_jets = 100
    config.sampler_kwargs.dt = 1.0 / args.sampler_steps

    experiment = TransdimensionalExperiment(config, run_dir, seed=args.seed, device=args.device)
    history = experiment.trainer.fit(experiment.datamodule, epochs=args.epochs)
    print(f"final train loss: {history[-1]['train_loss']:.4f}")

    outs = experiment.generate()
    dims_gen = torch.cat([o.dims for o in outs]).float()
    dims_data = torch.as_tensor(
        experiment.datamodule.dataset.arrays["target_mask"][..., 0].sum(1)).float()
    print(f"multiplicity: generated mean {dims_gen.mean():.1f} ± {dims_gen.std():.1f}"
          f" (from dims=1 via birth jumps) | data mean {dims_data.mean():.1f}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--sampler-steps", type=int, default=100)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="run directory (default: a temporary one)")
    args = ap.parse_args()
    if args.out:
        return run(args, args.out)
    with tempfile.TemporaryDirectory() as tmp:
        return run(args, tmp)


if __name__ == "__main__":
    main()
