"""The absorbing family's death-channel operating-point sweep on the
PyTorch/CUDA port, the counterpart of scripts/death_channel_sweep.py:55-318.

`BridgeConfig.death_rate_scale` (models/generative/bridges.py
`AbsorbingBridge.solver_step`) switches on a sampling-time death channel
beside the reference's birth-only mask solver, so that an init of too high a
multiplicity can be corrected. It changes sampling only, so one trained
model per seed (`--target-dropout`, default 0.1, the source-consistent
bridge) serves the whole `--scales` sweep; training, the cache and the
stress sources are scripts/torch_quality_parity_absorbing.py's. Per seed and
scale:
  - nominal generation (source masks from the data's multiplicity
    histogram): the KL/W1 table, the channel's cost on the nominal protocol;
  - the uniform (over-multiplicity) stress: KL_mult init -> final, the
    failure the channel is for;
  - the halved (under-multiplicity) stress: KL_mult init -> final, the
    birth side's correction that deaths must not break.

The JAX script merges its block into a benchmarks/ artifact; this one writes
the block to `--out`, and into the JSON of `--artifact` as its
`death_channel` key only when given one. The block's keys are the JAX
script's, with `device` and the kernels' `launches` added.

  python scripts/torch_death_channel_sweep.py --seeds 0 1 2 --scales 0.0 0.5 1.0 \\
      --params-cache .cache/torch_absorbing_params --out results/death_channel.json

Runs on the GPU unless --device names another device (`--device cpu`).
"""

import argparse
import copy
import json
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
    noise_source,
    score,
    state_to_cloud,
    synchronize,
)
from torch_quality_parity_absorbing import (  # noqa: E402
    FEATURES,
    absorbing_config,
    absorbing_data,
    generate,
    model_with,
    multiplicity_record,
    stress_chunks_of,
    stress_histograms,
    train_or_load,
)

from multimodal_particles_tpu_torch.data.particle_clouds.jets import (  # noqa: E402
    JetClassHighLevelFeatures,
)
from multimodal_particles_tpu_torch.training.basic_experiments import (  # noqa: E402
    resolve_device,
)


def run_seed(args, seed, device):
    torch.manual_seed(seed)
    config = absorbing_config(args, seed)
    jets, dm, config = absorbing_data(config, seed, device)
    weights, final_loss, train_s, train_launches = train_or_load(args, seed, config, dm, device)

    target = dm.dataclass.target
    mult_data = np.asarray(target.multiplicity).reshape(-1)
    N = config.data.max_num_particles
    chunks = chunks_of(args.gen_jets, args.gen_chunk)
    stress_chunks = stress_chunks_of(chunks, args.stress_jets)
    hl_data = JetClassHighLevelFeatures(data_cloud_of(target, config))
    sources = {"nominal": noise_source(config, args.gen_jets, mult_data, seed + 1),
               **{name: noise_source(config, args.gen_jets, mult, seed + 11)
                  for name, mult in stress_histograms(mult_data, N, seed).items()}}

    out = {"seed": seed, "final_train_loss": None if final_loss is None else round(final_loss, 4),
           "train_wall_s": round(train_s, 1), "scales": {},
           "launches": {"train": train_launches}}
    for scale in args.scales:
        config_s = copy.deepcopy(config)
        config_s.bridge.death_rate_scale = scale
        model = model_with(config_s, weights, device)
        entry = {}
        harness.reset_launches()
        synchronize(device)
        t0 = time.perf_counter()
        for name, src in sources.items():
            nominal = name == "nominal"
            cont, disc, mask = generate(model, src, chunks if nominal else stress_chunks,
                                        seed + 2, device)
            n_gen = args.gen_jets if nominal else args.stress_jets
            mult_init = np.asarray(src.mask[..., 0].sum(1))[:n_gen]
            rec = multiplicity_record(mult_init, mask[..., 0].sum(1), mult_data, N)
            if nominal:
                cloud = state_to_cloud(cont, disc, mask, config.data.target_preprocess_stats)
                rec["metrics"] = score(JetClassHighLevelFeatures(cloud), hl_data, FEATURES)
            entry[name] = rec
            print(f"[seed {seed}][scale {scale}][{name}] KL {rec['KL_mult_init']} -> "
                  f"{rec['KL_mult_final']} (mean {rec['mult_mean_init']} -> "
                  f"{rec['mult_mean_final']}, data {rec['mult_mean_data']})")
        synchronize(device)
        entry["gen_wall_s"] = round(time.perf_counter() - t0, 1)
        entry["launches"] = harness.launches()
        out["scales"][str(scale)] = entry
    return out


def per_scale_summary(block, scales):
    def col(name, field, scale):
        return [sd["scales"][str(scale)][name][field] for sd in block["seeds"]]

    return {str(scale): {
        "uniform_KL_final": col("uniform", "KL_mult_final", scale),
        "uniform_corrects": col("uniform", "dynamics_correct_init", scale),
        "halved_KL_final": col("halved", "KL_mult_final", scale),
        "halved_corrects": col("halved", "dynamics_correct_init", scale),
        "nominal_W1_multiplicity": [sd["scales"][str(scale)]["nominal"]["metrics"]
                                    ["W1_multiplicity"] for sd in block["seeds"]],
    } for scale in scales}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=2000)
    ap.add_argument("--gen-jets", type=int, default=1024)
    ap.add_argument("--gen-chunk", type=int, default=1024)
    ap.add_argument("--sampler-steps", type=int, default=250)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--scales", type=float, nargs="+", default=[0.0, 0.5, 1.0])
    ap.add_argument("--stress-jets", type=int, default=512)
    ap.add_argument("--target-dropout", type=float, default=0.1)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--params-cache", default=None,
                    help="directory to cache and reuse trained params (shared with "
                         "torch_quality_parity_absorbing.py)")
    ap.add_argument("--reuse-params", default=None,
                    help="a trained_params.pt to sweep without training, for every seed")
    ap.add_argument("--artifact", default=None,
                    help="a JSON to merge the block into as its `death_channel` key")
    ap.add_argument("--out", default=None, help="write the block here (after every seed)")
    args = ap.parse_args(argv)
    args.stress_jets = min(args.stress_jets, args.gen_jets)
    args.death_rate_scale = 0.0  # the config's; each scale sets its own
    return args


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    block = {
        "protocol": (
            f"config-absorbing-test, {args.epochs} epochs, {args.sampler_steps} sampler "
            f"steps, nominal {args.gen_jets} jets / stresses {args.stress_jets} on the "
            "port; death_rate_scale is sampling-time only, so each seed's trained params "
            "(target_dropout as given) are shared across the whole scale sweep"
        ),
        "target_dropout": args.target_dropout,
        "scales": args.scales,
        "platform": harness.platform_of(device),
        "device": device_name(device),
        "seeds": [],
    }

    def persist():
        if args.artifact:
            artifact = {}
            if os.path.exists(args.artifact):
                with open(args.artifact) as f:
                    artifact = json.load(f)
            artifact["death_channel"] = block
            harness.write_json(args.artifact, artifact)
        if args.out:
            harness.write_json(args.out, block)

    for seed in args.seeds:
        block["seeds"].append(run_seed(args, seed, device))
        persist()  # per seed
    block["per_scale_summary"] = per_scale_summary(block, args.scales)
    persist()
    print(json.dumps(block["per_scale_summary"], indent=2))
    return block


if __name__ == "__main__":
    main()
