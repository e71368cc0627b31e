"""The bulk generation sweep with the PyTorch/CUDA port (the counterpart of
examples/bulk_generation_sweep.py): MBM jets in chunks of --batch-size
through `bulk_sample`, sources drawn on the device.

  python examples/torch_bulk_generation_sweep.py --num-jets 1000000 --no-collect
  python examples/torch_bulk_generation_sweep.py --num-jets 4096 --batch-size 1024 \
      --steps 10 --device cpu --substructure

Runs on the GPU unless --device names another device. Without --checkpoint
the model is config-berlin with seeded weights; with it, the run in that
experiment directory. --substructure scores the collected jets with the C++
substructure library (post-processed to physics space when the config
carries the preprocessing stats) and prints its jets/s.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def score_substructure(result, config):
    """τ1, τ2, τ3 and D2 of the collected jets through the C++ library: which
    path ran, how many jets it scored, its rate and the mean τ21 and D2."""
    from multimodal_particles_tpu_torch.data.particle_clouds.particles import ParticleClouds
    from multimodal_particles_tpu_torch.data.particle_clouds.substructure import (
        substructure_observables,
    )

    cloud = ParticleClouds(np.concatenate(
        [result["continuous"], result["discrete"], result["mask"]], axis=-1))
    stats = config.data.target_preprocess_stats
    if stats is not None:
        cloud.postprocess(config.data.target_preprocess_continuous,
                          config.data.target_preprocess_discrete, stats=stats)
    start = time.perf_counter()
    obs = substructure_observables(cloud.pt, cloud.eta_rel, cloud.phi_rel, cloud.mask[..., 0])
    seconds = time.perf_counter() - start
    return {"native": obs["native"], "physics_space": stats is not None, "jets": len(cloud),
            "jets_scored": int(obs["selection"].sum()), "seconds": seconds,
            "jets_per_sec": len(cloud) / seconds,
            "mean_tau21": float(np.nanmean(obs["tau21"])), "mean_d2": float(np.nanmean(obs["d2"]))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-jets", type=int, default=100_000)
    ap.add_argument("--batch-size", type=int, default=32768)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--no-collect", action="store_true")
    ap.add_argument("--checkpoint", default=None, help="experiment dir to load")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--substructure", action="store_true",
                    help="score the collected jets with the C++ substructure library")
    args = ap.parse_args()
    if args.substructure and args.no_collect:
        ap.error("--substructure scores the collected jets: drop --no-collect")

    from multimodal_particles_tpu_torch.config_classes import MultimodalBridgeMatchingConfig
    from multimodal_particles_tpu_torch.models.generative.init import init_mbm_parameters
    from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (
        MultiModalBridgeMatching,
    )
    from multimodal_particles_tpu_torch.parallel.bulk_sampling import bulk_sample
    from multimodal_particles_tpu_torch.training.basic_experiments import resolve_device

    device = resolve_device(args.device)
    if args.checkpoint:
        from multimodal_particles_tpu_torch.training.multimodal_experiment import (
            MultimodalBridgeMatchingExperiment,
        )

        experiment = MultimodalBridgeMatchingExperiment(experiment_dir=args.checkpoint,
                                                        device=device)
        model, config = experiment.model.eval(), experiment.config
    else:
        config = MultimodalBridgeMatchingConfig()
        config.data.batch_size = args.batch_size
        config.bridge.num_timesteps = args.steps
        model = init_mbm_parameters(MultiModalBridgeMatching(config), args.seed)
        model = model.to(device).eval()

    result, stats = bulk_sample(model, config, num_jets=args.num_jets,
                                batch_size=args.batch_size, seed=args.seed,
                                collect=not args.no_collect)
    stats["device"] = (torch.cuda.get_device_name(device) if device.type == "cuda"
                       else str(device))
    if args.substructure:
        stats["substructure"] = score_substructure(result, config)
    print(json.dumps(stats, indent=2))


if __name__ == "__main__":
    main()
