"""MBM's head-to-head quality gate on the PyTorch/CUDA port, the counterpart
of scripts/quality_parity.py:37-322.

The port's MultiModalBridgeMatching is trained on the preprocessed AOJ-mini
split of config-mbm-test for `--train-steps` steps (the epochs that cover
them, the cosine schedule annealed over exactly those epochs), generates
`--gen-jets` jets from fresh noise clouds at the config's 100 sampler steps,
and is scored gen-vs-data with the KL/W1 observables of
`JetClassHighLevelFeatures`. The JAX script's other side trained the
upstream reference in-process; here the other side is the JAX package's
readings, read from `--jax-readings` (a JSON in the JAX script's output
format, e.g. benchmarks/quality_parity_mbm.json, whose `rebuilt` side is the
JAX package): they fill `reference`, and `ratio_rebuilt_over_reference` is
the port's reading over JAX's. They are quality numbers taken with their own
protocol and platform, which the output names beside them.

The JSON keys are the JAX script's; `platform` is the torch device's type,
and `device` (its name), `launches` (the hand-written kernels' launch
counts in training and in generation) and the first epoch's mean loss
(`rebuilt.train_loss_first`) are added.

  python scripts/torch_quality_parity.py --train-steps 6000 --gen-jets 4096 \\
      --jax-readings benchmarks/quality_parity_mbm.json --out results/quality_parity_mbm.json

Runs on the GPU unless --device names another device (`--device cpu`).
"""

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _path in (REPO_ROOT, os.path.dirname(os.path.abspath(__file__))):
    if _path not in sys.path:
        sys.path.insert(0, _path)

import torch_harness as harness  # noqa: E402
from torch_quality_families import (  # noqa: E402
    chunks_of,
    data_cloud_of,
    device_name,
    make_gen_databatch,
    noise_source,
    score,
    state_to_cloud,
    synchronize,
)

from multimodal_particles_tpu_torch import test_resources_dir  # noqa: E402
from multimodal_particles_tpu_torch.config_classes import (  # noqa: E402
    MultimodalBridgeMatchingConfig,
)
from multimodal_particles_tpu_torch.data.particle_clouds.jets import (  # noqa: E402
    JetClassHighLevelFeatures,
    JetDataclass,
)
from multimodal_particles_tpu_torch.data.particle_clouds.jets_dataloader import (  # noqa: E402
    JetsDataloaderModule,
)
from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (  # noqa: E402
    MultiModalBridgeMatching,
)
from multimodal_particles_tpu_torch.training.basic_experiments import (  # noqa: E402
    resolve_device,
)
from multimodal_particles_tpu_torch.training.trainer import Trainer  # noqa: E402

CONFIG_PATH = os.path.join(test_resources_dir, "configs_files", "config-mbm-test.yaml")
FEATURES = ["pt", "m", "eta", "phi", "multiplicity", "Q_total", "Q_jet", "tau21", "tau32",
            "d2"]


def ratios(ours, theirs):
    """ours / theirs of each reading both have (JAX's rounding: 3 digits)."""
    if not theirs:
        return None
    return {k: round(ours[k] / max(theirs[k], 1e-9), 3)
            for k in ours if ours[k] is not None and theirs.get(k)}


def train_mbm(config, dm, epochs, seed, device):
    """Trainer.fit for `epochs`, no checkpoints: (trainer, history, seconds)."""
    trainer = Trainer(MultiModalBridgeMatching(config).to(device), config, seed=seed)
    synchronize(device)
    t0 = time.perf_counter()
    history = trainer.fit(dm, epochs=epochs)
    synchronize(device)
    return trainer, history, time.perf_counter() - t0


def generate_mbm(model, src, chunks, seed, device, mask="absorbing"):
    """model.predict over the source's chunks from one generator seeded
    `seed`: (continuous, discrete, the state's `mask` field) as numpy, and
    the seconds."""
    generator = torch.Generator(device=device).manual_seed(seed)
    outs = []
    synchronize(device)
    t0 = time.perf_counter()
    for chunk in chunks:
        outs.append(model.predict(make_gen_databatch(src, chunk, device), generator=generator))
    synchronize(device)
    seconds = time.perf_counter() - t0

    def cat(name):
        return torch.cat([getattr(o, name) for o in outs]).cpu().numpy()

    return cat("continuous"), cat("discrete"), cat(mask).astype(np.int64), seconds


def run(args):
    device = resolve_device(args.device)
    torch.manual_seed(args.seed)
    config = MultimodalBridgeMatchingConfig.from_yaml(CONFIG_PATH)

    # ---------------------------------------------------------------- data
    jets = JetDataclass(config, seed=args.seed)  # the seed gives the data's noise source
    jets.preprocess()
    dm = JetsDataloaderModule(config, jets, device=device)
    config = dm.update_config(config)
    steps_per_epoch = max(len(dm.train), 1)
    epochs = max(1, math.ceil(args.train_steps / steps_per_epoch))
    config.train.epochs = epochs
    # anneal to eta_min exactly at the end of the run, as the JAX script does
    config.train.scheduler_params["T_max"] = epochs
    print(f"data: {len(dm.dataset)} jets, {steps_per_epoch} steps/epoch, "
          f"{epochs} epochs (~{epochs * steps_per_epoch} steps)")

    # --------------------------------------------------------------- train
    harness.reset_launches()
    trainer, history, train_s = train_mbm(config, dm, epochs, args.seed, device)
    train_launches = harness.launches()
    final = history[-1]
    print(f"[port] trained {epochs} epochs in {train_s:.1f}s: "
          f"train_loss={final['train_loss']:.4f} val_loss={final['val_loss']:.4f}")

    # ---------------------------------------------------------- generation
    gen_src = noise_source(config, args.gen_jets, jets.target.multiplicity, args.seed + 1)
    harness.reset_launches()
    trainer.model.eval()  # the live parameters, as the JAX script samples its params
    cont, disc, mask, gen_s = generate_mbm(trainer.model, gen_src,
                                           chunks_of(args.gen_jets, args.gen_chunk),
                                           args.seed + 2, device)
    gen_launches = harness.launches()
    print(f"[port] generated {args.gen_jets} jets in {gen_s:.1f}s")

    # ------------------------------------------------------------- scoring
    gen_cloud = state_to_cloud(cont, disc, mask, config.data.target_preprocess_stats)
    hl_data = JetClassHighLevelFeatures(data_cloud_of(jets.target, config))
    rebuilt = score(JetClassHighLevelFeatures(gen_cloud), hl_data, FEATURES)

    jax_readings = None if args.skip_reference else harness.load_jax_readings(args.jax_readings)
    reference = None
    if jax_readings is not None:
        side = jax_readings["rebuilt"]
        reference = {k: side.get(k) for k in ("final_train_loss", "final_val_loss",
                                              "train_wall_s", "gen_wall_s", "metrics")}

    return {
        "protocol": (
            "the port's MBM trained on the preprocessed AOJ-mini split (config-mbm-test) "
            "for the epochs that cover --train-steps, the cosine schedule annealed over "
            "them; generation from fresh noise sources at the config's sampler steps; "
            "gen-vs-data KL/W1 with the reference's metric machinery. `reference` = the "
            "JAX package's readings from --jax-readings (their `rebuilt` side), taken "
            "with the protocol and on the platform that `jax_readings` names"
        ),
        "config": "config-mbm-test (AOJ mini, 100 jets)",
        "train_steps": epochs * steps_per_epoch,
        "sampler_steps": config.bridge.num_timesteps,
        "gen_jets": args.gen_jets,
        "platform": harness.platform_of(device),
        "device": device_name(device),
        "rebuilt": {
            "train_loss_first": round(history[0]["train_loss"], 4),
            "final_train_loss": round(final["train_loss"], 4),
            "final_val_loss": round(final["val_loss"], 4),
            "train_wall_s": round(train_s, 1),
            "gen_wall_s": round(gen_s, 1),
            "metrics": rebuilt,
        },
        "reference": reference,
        "ratio_rebuilt_over_reference": ratios(rebuilt, reference and reference["metrics"]),
        "jax_readings": None if jax_readings is None else {
            **harness.jax_readings_summary(args.jax_readings, jax_readings),
            **{k: jax_readings.get(k) for k in ("train_steps", "sampler_steps", "gen_jets")}},
        "launches": {"train": train_launches, "generate": gen_launches},
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train-steps", type=int, default=6000)
    ap.add_argument("--gen-jets", type=int, default=4096)
    ap.add_argument("--gen-chunk", type=int, default=1024)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--jax-readings", default=None,
                    help="the JAX script's output JSON, printed beside the port's")
    ap.add_argument("--skip-reference", action="store_true",
                    help="leave the JAX readings out even when --jax-readings is given")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the JSON here too")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    result = run(args)
    if args.out:
        harness.write_json(args.out, result)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
