"""The absorbing family's head-to-head quality gate and mask-dynamics stress
on the PyTorch/CUDA port, the counterpart of
scripts/quality_parity_absorbing.py:54-462.

Per seed, the port's AbsorbingFlow is trained on the AOJ-mini shard of
config-absorbing-test (`--epochs`, the cosine schedule annealed over them),
generates `--gen-jets` jets at `--sampler-steps` from fresh noise clouds
whose source masks follow the data's multiplicity histogram, and is scored
gen-vs-data with the KL/W1 observables. Then the mask-dynamics stress:
generation from deliberately wrong source histograms, the data's
multiplicity halved and a uniform one, reporting whether the learned
absorbing dynamics move the multiplicity KL toward the data (KL_mult from the
source's, init, to the generated jets', final). The solver is creation-only
at `--death-rate-scale 0` (dead slots revive, live ones never die), so the
halved init is the one it can correct.

The JAX script's other side trained the upstream reference; here it is the
JAX package's readings from `--jax-readings` (the JAX script's own output,
e.g. benchmarks/quality_parity_absorbing.json): each seed's `reference` is
that file's entry of the same seed (its `rebuilt` side, and its stress
readings), with the file's protocol and platform in `jax_readings`.

`--reuse-params FILE` generates from saved weights (a trained_params.pt of
scripts/torch_quality_families.py --family absorbing) without training.
`--params-cache DIR` keeps each trained model under a key of every setting
that changes the trained weights (the whole config but the sampling-only
`death_rate_scale`, the epochs and the seed), so that another death-rate
scale or another stress size reuses it (scripts/torch_death_channel_sweep.py
shares the cache). The JSON keys are the JAX script's, with `device` and the
kernels' `launches` added; `--out` is rewritten after every seed.

  python scripts/torch_quality_parity_absorbing.py --epochs 400 --gen-jets 2048 \\
      --seeds 0 1 --jax-readings benchmarks/quality_parity_absorbing.json \\
      --out results/quality_parity_absorbing.json

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
    _hist_kl,
    chunks_of,
    data_cloud_of,
    device_name,
    load_weights,
    make_gen_databatch,
    noise_source,
    sampled_weights,
    score,
    state_to_cloud,
    synchronize,
)
from torch_quality_parity import ratios  # noqa: E402

from multimodal_particles_tpu_torch import test_resources_dir  # noqa: E402
from multimodal_particles_tpu_torch.config_classes import AbsorbingConfig  # noqa: E402
from multimodal_particles_tpu_torch.data.particle_clouds.jets import (  # noqa: E402
    JetClassHighLevelFeatures,
    JetDataclass,
)
from multimodal_particles_tpu_torch.data.particle_clouds.jets_dataloader import (  # noqa: E402
    JetsDataloaderModule,
)
from multimodal_particles_tpu_torch.models.generative.absorbing.absorbing_flows import (  # noqa: E402
    AbsorbingFlow,
)
from multimodal_particles_tpu_torch.training.basic_experiments import (  # noqa: E402
    resolve_device,
)
from multimodal_particles_tpu_torch.training.trainer import Trainer  # noqa: E402

CONFIG_PATH = os.path.join(test_resources_dir, "configs_files", "config-absorbing-test.yaml")
FEATURES = ["pt", "m", "eta", "phi", "multiplicity", "Q_total", "Q_jet", "tau21", "tau32",
            "d2"]


def absorbing_config(args, seed):
    """config-absorbing-test on the 100-jet shard with the run's settings."""
    config = AbsorbingConfig.from_yaml(CONFIG_PATH)
    config.data.num_jets = 100
    config.bridge.num_timesteps = args.sampler_steps
    # the rebuild's source-consistent mask bridge; 0.0 = the reference's semantics
    config.bridge.target_dropout = args.target_dropout
    # sampling-time only: never changes what is trained
    config.bridge.death_rate_scale = args.death_rate_scale
    config.train.epochs = args.epochs
    config.train.scheduler_params["T_max"] = args.epochs
    return config


def absorbing_data(config, seed, device):
    """(jets, datamodule, config with the data's stats and histograms)."""
    jets = JetDataclass(config, seed=seed)
    jets.preprocess()
    dm = JetsDataloaderModule(config, jets, device=device)
    return jets, dm, dm.update_config(config)


def cache_path(args, seed, config):
    """The trained model's file in --params-cache, keyed on every setting
    that changes the trained weights; None without a cache."""
    if not args.params_cache:
        return None
    trained = copy.deepcopy(config)
    trained.bridge.death_rate_scale = 0.0  # sampling-only
    key = harness.config_key(trained, seed=seed, epochs=args.epochs)
    return os.path.join(args.params_cache, f"absorbing_s{seed}_{key}.pt")


def train_or_load(args, seed, config, dm, device):
    """The sampled-from weights (EMA where kept) of a model trained on `dm`,
    or of the cached one: (weights, final train loss, train seconds,
    launches)."""
    if args.reuse_params:
        weights = torch.load(args.reuse_params, map_location=device, weights_only=True)
        print(f"[seed {seed}] reusing params from {args.reuse_params}")
        return weights, None, 0.0, {}
    path = cache_path(args, seed, config)
    if path and os.path.exists(path):
        cached = torch.load(path, map_location=device, weights_only=True)
        print(f"[seed {seed}] loaded cached params from {path}")
        return cached["params"], cached["final_train_loss"], 0.0, {}
    trainer = Trainer(AbsorbingFlow(config).to(device), config, seed=seed)
    harness.reset_launches()
    synchronize(device)
    t0 = time.perf_counter()
    history = trainer.fit(dm, epochs=args.epochs)
    synchronize(device)
    train_s = time.perf_counter() - t0
    launches = harness.launches()
    weights = sampled_weights(trainer)
    final_loss = history[-1]["train_loss"]
    print(f"[seed {seed}] trained in {train_s:.1f}s: train={final_loss:.4f}")
    if path:
        os.makedirs(args.params_cache, exist_ok=True)
        torch.save({"params": {k: v.cpu() for k, v in weights.items()},
                    "final_train_loss": final_loss}, path)
        print(f"[seed {seed}] cached params to {path}")
    return weights, final_loss, train_s, launches


def model_with(config, weights, device):
    model = AbsorbingFlow(config).to(device)
    load_weights(model, weights)
    return model.eval()


def generate(model, src, chunks, seed, device):
    """model.predict over the source's chunks from a generator seeded `seed`
    (each generation from the same seed, as the JAX script reuses its key):
    (continuous, discrete, mask) as numpy."""
    generator = torch.Generator(device=device).manual_seed(seed)
    outs = [model.predict(make_gen_databatch(src, chunk, device), generator=generator)
            for chunk in chunks]

    def cat(name):
        return torch.cat([getattr(o, name) for o in outs]).cpu().numpy()

    return cat("continuous"), cat("discrete"), cat("mask_t").astype(np.int64)


def stress_histograms(mult_data, n_slots, seed):
    """The wrong source-multiplicity histograms of the stress
    (quality_parity_absorbing.py:327-331): the data's halved, and uniform in
    [1, N] from numpy's generator seeded seed + 7."""
    rng = np.random.default_rng(seed + 7)
    return {"halved": np.clip(mult_data // 2, 1, n_slots),
            "uniform": rng.integers(1, n_slots + 1, size=mult_data.shape)}


def multiplicity_record(mult_init, mult_final, mult_data, n_slots):
    """The stress's readings of one generation."""
    rec = {
        "mult_mean_init": round(float(mult_init.mean()), 3),
        "mult_mean_final": round(float(mult_final.mean()), 3),
        "mult_mean_data": round(float(mult_data.mean()), 3),
        "KL_mult_init": round(_hist_kl(mult_init, mult_data, 0, n_slots), 4),
        "KL_mult_final": round(_hist_kl(mult_final, mult_data, 0, n_slots), 4),
    }
    rec["dynamics_correct_init"] = bool(rec["KL_mult_final"] < rec["KL_mult_init"])
    return rec


def stress_chunks_of(chunks, stress_jets):
    return [c[c < stress_jets] for c in chunks if (c < stress_jets).any()]


def jax_seed_entry(jax_readings, seed):
    if jax_readings is None:
        return None
    return next((s for s in jax_readings.get("seeds", []) if s.get("seed") == seed), None)


def run_seed(args, seed, device, jax_readings=None):
    torch.manual_seed(seed)
    config = absorbing_config(args, seed)
    jets, dm, config = absorbing_data(config, seed, device)
    steps_per_epoch = max(len(dm.train), 1)
    print(f"[seed {seed}] data: {len(dm.dataset)} jets, {steps_per_epoch} steps/epoch, "
          f"{args.epochs} epochs")
    weights, final_loss, train_s, train_launches = train_or_load(args, seed, config, dm, device)
    model = model_with(config, weights, device)

    target = dm.dataclass.target
    mult_data = np.asarray(target.multiplicity).reshape(-1)
    N = config.data.max_num_particles
    chunks = chunks_of(args.gen_jets, args.gen_chunk)
    hl_data = JetClassHighLevelFeatures(data_cloud_of(target, config))

    harness.reset_launches()
    synchronize(device)
    t0 = time.perf_counter()
    cont, disc, mask = generate(model, noise_source(config, args.gen_jets, mult_data, seed + 1),
                                chunks, seed + 2, device)
    synchronize(device)
    gen_s = time.perf_counter() - t0
    gen_launches = harness.launches()
    cloud = state_to_cloud(cont, disc, mask, config.data.target_preprocess_stats)
    metrics = score(JetClassHighLevelFeatures(cloud), hl_data, FEATURES)
    print(f"[seed {seed}] generated {args.gen_jets} jets in {gen_s:.1f}s")

    jax_seed = jax_seed_entry(jax_readings, seed)
    reference = None if jax_seed is None else jax_seed.get("rebuilt")

    stress = {}
    harness.reset_launches()
    for name, mult in stress_histograms(mult_data, N, seed).items():
        src = noise_source(config, args.gen_jets, mult, seed + 11)
        mult_init = np.asarray(src.mask[..., 0].sum(1))[: args.stress_jets]
        mask_final = generate(model, src, stress_chunks_of(chunks, args.stress_jets), seed + 2,
                              device)[2]
        entry = {"rebuilt": multiplicity_record(mult_init, mask_final[..., 0].sum(1), mult_data,
                                                N)}
        if jax_seed is not None:
            entry["reference"] = jax_seed["mask_dynamics_stress"][name]["rebuilt"]
        stress[name] = entry
        print(f"[seed {seed}][stress {name}] init KL {entry['rebuilt']['KL_mult_init']} -> "
              f"final KL {entry['rebuilt']['KL_mult_final']}")

    return {
        "seed": seed,
        "train_steps": args.epochs * steps_per_epoch,
        "rebuilt": {
            "final_train_loss": None if final_loss is None else round(final_loss, 4),
            "train_wall_s": round(train_s, 1),
            "gen_wall_s": round(gen_s, 1),
            "metrics": metrics,
        },
        "reference": reference,
        "ratio_rebuilt_over_reference": ratios(metrics, reference and reference["metrics"]),
        "mask_dynamics_stress": stress,
        "launches": {"train": train_launches, "generate": gen_launches,
                     "stress": harness.launches()},
    }


def median_ratios(runs):
    keyed = [r["ratio_rebuilt_over_reference"] for r in runs if r["ratio_rebuilt_over_reference"]]
    if not keyed:
        return None
    common = set(keyed[0]).intersection(*keyed[1:])
    return {k: round(float(np.median([r[k] for r in keyed])), 3) for k in sorted(common)}


def document(args, runs, device, jax_readings):
    return {
        "protocol": (
            "the port's AbsorbingFlow trained on the preprocessed AOJ-mini split "
            "(config-absorbing-test); generation from fresh noise sources with source "
            "masks from the data multiplicity histogram at --sampler-steps; gen-vs-data "
            "KL/W1 with the reference's metric machinery, plus wrong-histogram "
            "mask-dynamics stress tests. `reference` = the JAX package's readings of the "
            "same seed from --jax-readings (protocol and platform in `jax_readings`)"
        ),
        "config": "config-absorbing-test (AOJ mini, 100 jets)",
        "epochs": args.epochs,
        "sampler_steps": args.sampler_steps,
        "gen_jets": args.gen_jets,
        "stress_jets": args.stress_jets,
        "target_dropout": args.target_dropout,
        "death_rate_scale": args.death_rate_scale,
        "platform": harness.platform_of(device),
        "device": device_name(device),
        "seeds_done": [r["seed"] for r in runs],
        "seeds": runs,
        "median_ratio_rebuilt_over_reference": median_ratios(runs),
        "jax_readings": None if jax_readings is None else {
            **harness.jax_readings_summary(args.jax_readings, jax_readings),
            **{k: jax_readings.get(k) for k in ("epochs", "sampler_steps", "gen_jets",
                                                "target_dropout", "death_rate_scale")}},
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=400)
    ap.add_argument("--gen-jets", type=int, default=2048)
    ap.add_argument("--gen-chunk", type=int, default=1024)
    ap.add_argument("--sampler-steps", type=int, default=500)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--out", default=None, help="write the JSON here (after every seed)")
    ap.add_argument("--stress-jets", type=int, default=512,
                    help="stress generation size (two extra generations a seed)")
    ap.add_argument("--jax-readings", default=None,
                    help="the JAX script's output JSON, printed beside the port's")
    ap.add_argument("--death-rate-scale", type=float, default=0.0,
                    help="the sampling-time death channel (BridgeConfig.death_rate_scale); "
                         "0.0 = the reference's birth-only solver")
    ap.add_argument("--params-cache", default=None,
                    help="directory to cache and reuse trained params (keyed on every "
                         "setting that changes them; the death scale is sampling-only)")
    ap.add_argument("--reuse-params", default=None,
                    help="a trained_params.pt (scripts/torch_quality_families.py) to "
                         "generate from without training, for every seed")
    ap.add_argument("--target-dropout", type=float, default=0.0,
                    help="the source-consistent mask-bridge augmentation "
                         "(BridgeConfig.target_dropout); 0.0 = the reference's semantics")
    args = ap.parse_args(argv)
    args.stress_jets = min(args.stress_jets, args.gen_jets)
    return args


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    jax_readings = harness.load_jax_readings(args.jax_readings)
    runs = []
    for seed in args.seeds:
        runs.append(run_seed(args, seed, device, jax_readings))
        result = document(args, runs, device, jax_readings)
        if args.out:
            harness.write_json(args.out, result)  # per seed
    print(json.dumps({"median_ratios": result["median_ratio_rebuilt_over_reference"]}, indent=2))
    return result


if __name__ == "__main__":
    main()
