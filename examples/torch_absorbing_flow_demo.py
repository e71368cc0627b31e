"""AbsorbingFlow walkthrough with the PyTorch/CUDA port: train the
mask-generating model and look at its multiplicities, the counterpart of
examples/absorbing_flow_demo.py.

  python examples/torch_absorbing_flow_demo.py --epochs 20
  python examples/torch_absorbing_flow_demo.py --epochs 1 --sampler-steps 5 --device cpu

Runs on the GPU unless --device names another device; there each sampler step
launches the fused EPiC forward (K1) and the survival head (K6). Without --out
the run directory is a temporary one, removed at the end.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402


def run(args, run_dir):
    from multimodal_particles_tpu_torch import test_resources_dir
    from multimodal_particles_tpu_torch.config_classes import AbsorbingConfig
    from multimodal_particles_tpu_torch.training import AbsorbingExperiment

    config = AbsorbingConfig.from_yaml(
        os.path.join(test_resources_dir, "configs_files", "config-absorbing-test.yaml"))
    config.train.epochs = args.epochs
    config.bridge.num_timesteps = args.sampler_steps
    config.data.num_jets = 100

    experiment = AbsorbingExperiment(config, run_dir, seed=args.seed, device=args.device)
    history = experiment.train()
    print(f"final val_loss: {history[-1]['val_loss']:.4f}")

    # the generated masks: the model decides the particle multiplicity
    outs = experiment.generate()
    mult_gen = torch.cat([o.mask_t[..., 0].sum(1) for o in outs]).float()
    mult_data = torch.as_tensor(
        experiment.datamodule.dataset.arrays["target_mask"][..., 0].sum(1)).float()
    print(f"multiplicity: generated mean {mult_gen.mean():.1f} ± {mult_gen.std():.1f}"
          f" | data mean {mult_data.mean():.1f} ± {mult_data.std():.1f}")


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
