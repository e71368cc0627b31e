"""Train the transdimensional jump-diffusion model with the PyTorch/CUDA port
(counterpart of scripts/training/transdimensional_train.py):

    python scripts/training/torch_transdimensional_train.py CONFIG.yaml [--device cpu]

Runs on the GPU unless --device names another device; the run directory
(params.yaml, checkpoints, logs) is --experiment-dir, else
results/<timestamp>. A config with a context (data.dim_context_continuous,
data.dim_context_discrete) takes the contexts from --contexts, an .npz with
the arrays `context_continuous` (num_jets, Dcc) and `context_discrete`
(num_jets, Dcd) tokens, one row a jet: the jet readers give no context.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from multimodal_particles_tpu_torch.config_classes import (  # noqa: E402
    TransdimensionalEpicConfig,
)
from multimodal_particles_tpu_torch.training.transdimensional_experiment import (  # noqa: E402
    train_transdimensional,
)

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("config", help="path to a transdimensional yaml config")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--experiment-dir", default=None,
                    help="run directory (default: the config's, else results/<timestamp>)")
    ap.add_argument("--contexts", default=None,
                    help="an .npz of the contexts, for a config with a context")
    args = ap.parse_args()
    contexts = None
    if args.contexts:
        with np.load(args.contexts) as f:
            contexts = {name: f[name] for name in f.files}
    experiment = train_transdimensional(TransdimensionalEpicConfig.from_yaml(args.config),
                                        device=args.device, seed=args.seed,
                                        experiment_dir=args.experiment_dir, contexts=contexts)
    print(experiment.experiment_files.experiment_dir)
