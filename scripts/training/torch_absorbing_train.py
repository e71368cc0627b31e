"""Train the absorbing flow with the PyTorch/CUDA port
(counterpart of scripts/training/absorbing_train.py):

    python scripts/training/torch_absorbing_train.py CONFIG.yaml [--device cpu]

Runs on the GPU unless --device names another device; the run directory
(params.yaml, checkpoints, logs) is --experiment-dir, else the config's `experiment_dir`, else
results/<timestamp>.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from multimodal_particles_tpu_torch.config_classes import AbsorbingConfig  # noqa: E402
from multimodal_particles_tpu_torch.training.absorbing_experiment import (  # noqa: E402
    train_absorbing,
)

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("config", help="path to an absorbing yaml config")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--experiment-dir", default=None,
                    help="run directory (default: the config's, else results/<timestamp>)")
    args = ap.parse_args()
    experiment = train_absorbing(AbsorbingConfig.from_yaml(args.config),
                                 device=args.device, seed=args.seed,
                                 experiment_dir=args.experiment_dir)
    print(experiment.experiment_files.experiment_dir)
