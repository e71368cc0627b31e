"""Physics-fidelity evaluation with the PyTorch/CUDA port, the counterpart of
scripts/evaluate.py:14-70: generate jets with a trained MBM experiment and
score KL / Wasserstein-1D against the data on the reference's observables
{pt, m, eta, phi, multiplicity, jet charge, tau21, tau32, d2}
(data/particle_clouds/jets.py).

    python scripts/torch_evaluate.py EXPERIMENT_DIR [--out metrics.json] [--device cpu] [--seed 0]

The run in EXPERIMENT_DIR (its params.yaml and 'best' checkpoint, as the
port's experiments write them) is reloaded on --device, the GPU unless it
names another device, with --seed, the seed of its data noise (the source
clouds) and of its sampler's draws; `experiment.generate()` samples the test batches, else
the validation ones, and the states are stitched with `torch.cat`,
post-processed with the run's stats and scored against its target jets.
A feature with no value to compare (an empty substructure selection of a
poor model) scores None.
"""

import argparse
import copy
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FEATURES = ["pt", "m", "eta", "phi", "multiplicity", "Q_total", "Q_jet"]
SUBSTRUCTURE = ["tau21", "tau32", "d2"]


def stitch(states):
    """The generated batches' states as one state of the same class."""
    fields = {name: torch.cat([getattr(s, name) for s in states])
              for name, value in vars(states[0]).items() if isinstance(value, torch.Tensor)}
    return type(states[0])(**fields)


def evaluate_experiment(experiment_dir=None, experiment=None, features=None, out_json=None,
                        device=None, seed=0):
    from multimodal_particles_tpu_torch.data.particle_clouds.jets import (
        JetClassHighLevelFeatures,
    )
    from multimodal_particles_tpu_torch.data.particle_clouds.particles import ParticleClouds

    if experiment is None:
        from multimodal_particles_tpu_torch.training import MultimodalBridgeMatchingExperiment

        experiment = MultimodalBridgeMatchingExperiment(experiment_dir=experiment_dir,
                                                        seed=seed, device=device)

    cfg = experiment.config
    gen = ParticleClouds(stitch(experiment.generate()))
    gen.stats = cfg.data.target_preprocess_stats
    gen.postprocess()

    # the target jets in physics space
    ref = copy.deepcopy(experiment.datamodule.dataclass.target)
    ref.postprocess(input_continuous=cfg.data.target_preprocess_continuous,
                    input_discrete=cfg.data.target_preprocess_discrete,
                    stats=cfg.data.target_preprocess_stats)

    hl_gen = JetClassHighLevelFeatures(gen)
    hl_ref = JetClassHighLevelFeatures(ref)

    metrics = {}
    for feat in (features or FEATURES) + SUBSTRUCTURE:
        try:
            metrics[f"KL_{feat}"] = float(hl_gen.KLmetric1D(feat, hl_ref))
            metrics[f"W1_{feat}"] = float(hl_gen.Wassertein1D(feat, hl_ref))
        except (ValueError, IndexError):  # an empty substructure selection
            metrics[f"KL_{feat}"] = None
            metrics[f"W1_{feat}"] = None

    if out_json:
        with open(out_json, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("experiment_dir")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the run's seed (its data noise and its sampler's draws)")
    args = ap.parse_args()
    metrics = evaluate_experiment(args.experiment_dir, out_json=args.out, device=args.device,
                                  seed=args.seed)
    print(json.dumps(metrics, indent=2))
