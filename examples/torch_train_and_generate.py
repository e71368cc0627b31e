"""End-to-end MBM walkthrough with the PyTorch/CUDA port: train → generate →
evaluate (→ plot), the counterpart of examples/train_and_generate.py.

Loads the bundled AspenOpenJets jets, trains the hybrid bridge through the
port's experiment, runs the 100-step sampler, undoes the preprocessing and
scores W1 against the data; with --plot, side-by-side histograms (needs
matplotlib).

  python examples/torch_train_and_generate.py [--epochs 30] [--out DIR] [--plot]
  python examples/torch_train_and_generate.py --epochs 1 --device cpu

Runs on the GPU unless --device names another device. Without --out the run
directory is a temporary one, removed at the end.
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402


def run(args, run_dir):
    from multimodal_particles_tpu_torch import test_resources_dir
    from multimodal_particles_tpu_torch.config_classes import MultimodalBridgeMatchingConfig
    from multimodal_particles_tpu_torch.data.particle_clouds.jets import (
        JetClassHighLevelFeatures,
        JetDataclass,
    )
    from multimodal_particles_tpu_torch.data.particle_clouds.particles import ParticleClouds
    from multimodal_particles_tpu_torch.models.generative.states import HybridState
    from multimodal_particles_tpu_torch.training import MultimodalBridgeMatchingExperiment

    config_path = args.config or os.path.join(test_resources_dir, "configs_files",
                                              "config-mbm-test.yaml")
    config = MultimodalBridgeMatchingConfig.from_yaml(config_path)
    config.train.epochs = args.epochs
    if args.sampler_steps:
        config.bridge.num_timesteps = args.sampler_steps

    # ---- train
    experiment = MultimodalBridgeMatchingExperiment(config, run_dir, seed=args.seed,
                                                    device=args.device)
    history = experiment.train()
    print(f"trained {len(history)} epochs; final val_loss={history[-1]['val_loss']:.4f}")

    # ---- generate, the batches stitched into one state
    outs = experiment.generate()
    gen = ParticleClouds(HybridState(**{
        name: torch.cat([getattr(o, name) for o in outs])
        for name in ("continuous", "discrete", "absorbing")}))
    gen.stats = experiment.config.data.target_preprocess_stats
    gen.postprocess()

    # ---- the data in physics space
    ref = JetDataclass(MultimodalBridgeMatchingConfig.from_yaml(config_path), seed=args.seed).target
    ref.preprocess(output_continuous=None, output_discrete="tokens")
    ref.postprocess(input_continuous=None, input_discrete="tokens")

    hl_gen = JetClassHighLevelFeatures(gen)
    hl_ref = JetClassHighLevelFeatures(ref)
    metrics = {f"W1_{feat}": float(hl_gen.Wassertein1D(feat, hl_ref))
               for feat in ("pt", "m", "multiplicity")}
    print(json.dumps(metrics, indent=2))

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 3, figsize=(12, 3.2))
        for ax, feat in zip(axes, ["pt", "m", "multiplicity"]):
            hl_ref.histplot(feat, ax=ax, bins=40, density=True, label="AOJ data")
            hl_gen.histplot(feat, ax=ax, bins=40, density=True, label="generated")
            ax.legend(fontsize=8)
        fig.tight_layout()
        out_png = os.path.join(experiment.experiment_files.sample_dir, "observables.png")
        fig.savefig(out_png, dpi=120)
        print("wrote", out_png)
    return metrics


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--sampler-steps", type=int, default=None,
                    help="override the config's sampler step count")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="run directory (default: a temporary one)")
    ap.add_argument("--plot", action="store_true", help="write observables.png (matplotlib)")
    args = ap.parse_args()
    if args.out:
        return run(args, args.out)
    with tempfile.TemporaryDirectory() as tmp:
        return run(args, tmp)


if __name__ == "__main__":
    main()
