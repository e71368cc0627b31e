"""Family quality at a data scale where the metrics discriminate, on the
PyTorch/CUDA port: the counterpart of scripts/quality_scaled_data.py:58-622.

At the bundled 100-jet shard a perfect model floors at KL_pt ~ 1.6 (the
metric cannot fail a model there). This harness trains any of the three
families on the synthetic 20k-jet, 64-slot JetClass-schema shard of
scripts/torch_make_jetclass_synth.py (the physics is synthetic, a 3-class
prong mixture; the schema, featurization, preprocessing, training, sampling
and scoring are the production paths), measures the metric floors at this
scale with scripts/torch_metric_floors.py's bootstrap, generates
`--gen-jets` jets and reports gen-vs-data KL/W1 beside the floors.

What this port does not carry over of the JAX script: the epochs (and the
cosine schedule's T_max) come from the real loader's steps per epoch, never
from an estimate; the train checkpoint that `--reuse-params` resumes from is
keyed on the family, the whole config, the steps, the batch size and the
seed, not on the seed alone. MBM and the absorbing family take the widened
encoder (`--hidden`, `--blocks`: `_widen_encoder`), the transdimensional
family the tuned block of the JAX script.

The JSON keys are the JAX script's, with `device`, the kernels' `launches`
(training and generation) and, with `--jax-readings` (the JAX script's output
of the same family, e.g. benchmarks/quality_mbm_scaled_data.json), that
file's readings and floors beside the port's. Without `--out` nothing is
written; the JAX script's default went under benchmarks/.

  python scripts/torch_quality_scaled_data.py --family mbm --train-steps 10000 \\
      --batch-size 2048 --gen-jets 10000 \\
      --jax-readings benchmarks/quality_mbm_scaled_data.json --out results/mbm_scaled.json

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
from torch_make_jetclass_synth import write_synthetic_jetclass_npz  # noqa: E402
from torch_metric_floors import bootstrap_floors  # noqa: E402
from torch_quality_families import (  # noqa: E402
    _hist_kl,
    chunks_of,
    data_cloud_of,
    device_name,
    load_weights,
    noise_source,
    sampled_weights,
    score,
    state_to_cloud,
    synchronize,
)
from torch_quality_parity import generate_mbm  # noqa: E402

from multimodal_particles_tpu_torch import test_resources_dir  # noqa: E402
from multimodal_particles_tpu_torch.config_classes import (  # noqa: E402
    AbsorbingConfig,
    MultimodalBridgeMatchingConfig,
    TransdimensionalEpicConfig,
)
from multimodal_particles_tpu_torch.data.particle_clouds.jets import (  # noqa: E402
    JetClassHighLevelFeatures,
)
from multimodal_particles_tpu_torch.training import (  # noqa: E402
    AbsorbingExperiment,
    MultimodalBridgeMatchingExperiment,
    TransdimensionalExperiment,
)
from multimodal_particles_tpu_torch.training.basic_experiments import (  # noqa: E402
    resolve_device,
)

FEATURES = ["pt", "m", "eta", "phi", "multiplicity", "Q_total", "Q_jet", "tau21", "tau32",
            "d2"]
CONFIGS = os.path.join(test_resources_dir, "configs_files")


def _ensure_shard(args):
    """The shard of --shard, else the synthetic one in .cache (written on
    first use)."""
    shard = args.shard or os.path.join(REPO_ROOT, ".cache", f"jetclass_synth_{args.n_data}.npz")
    if not os.path.exists(shard):
        os.makedirs(os.path.dirname(os.path.abspath(shard)), exist_ok=True)
        t0 = time.time()
        write_synthetic_jetclass_npz(shard, args.n_data, args.max_particles, args.data_seed)
        print(f"[data] generated {shard} in {time.time() - t0:.1f}s")
    return shard


def _point_data_at_shard(config, args, shard):
    config.data.target_name = "JetClass"
    config.data.target_path = [shard]
    config.data.num_jets = args.n_data
    config.data.max_num_particles = args.max_particles
    config.data.batch_size = args.batch_size
    config.data.seed = args.seed


def _widen_encoder(enc, hidden, blocks):
    """The test configs' width (16) underfits the 20k-jet mixture: widen to
    a production-representative encoder (the narrow kernels take hidden up
    to 64)."""
    enc.num_blocks = blocks
    enc.dim_hidden_local = enc.dim_hidden_glob = hidden
    enc.dim_emb_time = hidden
    enc.dim_emb_features_continuous = hidden
    enc.dim_emb_features_discrete = hidden


def _epochs_for(args, steps_per_epoch):
    return max(1, math.ceil(args.train_steps / max(steps_per_epoch, 1)))


def _train_ckpt_path(args, family, config):
    """The train checkpoint of this family, config, step count, batch size
    and seed."""
    key = harness.config_key(config, family=family, train_steps=args.train_steps,
                             batch_size=args.batch_size, seed=args.seed)
    return os.path.join(args.workdir, f"train_ckpt_{family}_s{args.seed}_{key}.pt")


def _fit_or_resume(args, family, experiment, config, epochs, steps_per_epoch):
    """Train `experiment` for `epochs` (no per-epoch checkpoints), or with
    --reuse-params resume from this setting's train checkpoint: (sampled-from
    weights, train_info, training's launches)."""
    path = _train_ckpt_path(args, family, config)
    if args.reuse_params and os.path.exists(path):
        ckpt = torch.load(path, map_location=experiment.device, weights_only=True)
        print(f"[train] reusing checkpoint {path} (train_info={ckpt['train_info']})")
        return ckpt["params"], ckpt["train_info"], {}
    experiment.trainer.files = None
    harness.reset_launches()
    synchronize(experiment.device)
    t0 = time.perf_counter()
    history = experiment.trainer.fit(experiment.datamodule, epochs=epochs)
    synchronize(experiment.device)
    train_s = time.perf_counter() - t0
    launches = harness.launches()
    final = history[-1]
    print(f"[train] {epochs} epochs in {train_s:.1f}s: train={final['train_loss']}")
    train_info = {
        "train_steps": epochs * steps_per_epoch,
        "final_train_loss": None if final["train_loss"] is None else round(final["train_loss"], 4),
        "train_wall_s": round(train_s, 1),
    }
    if final.get("val_loss") is not None:
        train_info["final_val_loss"] = round(final["val_loss"], 4)
    weights = sampled_weights(experiment.trainer)
    os.makedirs(args.workdir, exist_ok=True)
    torch.save({"params": {k: v.cpu() for k, v in weights.items()}, "train_info": train_info},
               path)
    return weights, train_info, launches


def _experiment(args, family, experiment_class, config):
    """The experiment on the shard, its epochs set from its real loader
    before it trains (the cosine schedule's T_max with them):
    (experiment, epochs, steps per epoch)."""
    experiment = experiment_class(config, experiment_dir=os.path.join(args.workdir, "run"),
                                  seed=args.seed, device=args.device)
    steps_per_epoch = max(len(experiment.datamodule.train), 1)
    epochs = _epochs_for(args, steps_per_epoch)
    train = getattr(experiment.config, "train", None)
    if train is not None:
        train.epochs = epochs
        train.scheduler_params["T_max"] = epochs
    print(f"[data] {len(experiment.datamodule.dataset)} jets, {steps_per_epoch} steps/epoch, "
          f"{epochs} epochs (~{epochs * steps_per_epoch} steps)")
    return experiment, epochs, steps_per_epoch


def _generate_bridge(args, experiment, weights, mask="absorbing"):
    """MBM and the absorbing family: fresh noise with data-histogram source
    masks, the sampled-from weights, `--gen-chunk` jets a request."""
    config, device = experiment.config, experiment.device
    target = experiment.datamodule.dataclass.target
    model = experiment.model
    load_weights(model, weights)
    model.eval()
    gen_src = noise_source(config, args.gen_jets, target.multiplicity, args.seed + 1)
    harness.reset_launches()
    cont, disc, mask, gen_s = generate_mbm(model, gen_src, chunks_of(args.gen_jets, args.gen_chunk),
                                           args.seed + 2, device, mask)
    print(f"[gen] {args.gen_jets} jets in {gen_s:.1f}s")
    return gen_src, cont, disc, mask, gen_s, harness.launches()


# --------------------------------------------------------------------- MBM
def run_mbm(args, shard):
    config = MultimodalBridgeMatchingConfig.from_yaml(os.path.join(CONFIGS, "config-mbm-test.yaml"))
    _point_data_at_shard(config, args, shard)
    if args.sampler_steps:
        config.bridge.num_timesteps = args.sampler_steps
    _widen_encoder(config.encoder, args.hidden, args.blocks)
    experiment, epochs, spe = _experiment(args, "mbm", MultimodalBridgeMatchingExperiment, config)
    weights, train_info, train_launches = _fit_or_resume(args, "mbm", experiment, config, epochs,
                                                         spe)
    _, cont, disc, mask, gen_s, gen_launches = _generate_bridge(args, experiment, weights)
    config = experiment.config
    gen_cloud = state_to_cloud(cont, disc, mask, config.data.target_preprocess_stats)
    info = {
        "protocol": ("MBM trained on the full shard; generation from fresh noise with "
                     "data-histogram source masks; gen-vs-data KL/W1 with the reference's "
                     "metric machinery"),
        **train_info,
        "sampler_steps": config.bridge.num_timesteps,
        "gen_wall_s": round(gen_s, 1),
    }
    launches = {"train": train_launches, "generate": gen_launches}
    return config, experiment.datamodule.dataclass.target, gen_cloud, info, {}, launches


# --------------------------------------------------------------- absorbing
def run_absorbing(args, shard):
    config = AbsorbingConfig.from_yaml(os.path.join(CONFIGS, "config-absorbing-test.yaml"))
    _point_data_at_shard(config, args, shard)
    if args.sampler_steps:
        config.bridge.num_timesteps = args.sampler_steps
    _widen_encoder(config.encoder, args.hidden, args.blocks)
    experiment, epochs, spe = _experiment(args, "absorbing", AbsorbingExperiment, config)
    weights, train_info, train_launches = _fit_or_resume(args, "absorbing", experiment, config,
                                                         epochs, spe)
    gen_src, cont, disc, mask, gen_s, gen_launches = _generate_bridge(args, experiment, weights,
                                                                      "mask_t")
    config = experiment.config
    gen_cloud = state_to_cloud(cont, disc, mask, config.data.target_preprocess_stats)
    mult_gen = mask[..., 0].sum(1)
    mult_init = np.asarray(gen_src.mask[..., 0].sum(1))
    extra = {"mask_dynamics": {
        "mult_mean_gen": round(float(mult_gen.mean()), 3),
        "mult_mean_source_init": round(float(mult_init.mean()), 3),
        "mask_changed_fraction": round(float((mult_gen != mult_init).mean()), 4),
    }}
    info = {
        "protocol": ("AbsorbingFlow trained on the full shard; generation starts from fresh "
                     "noise clouds with source masks drawn from the data multiplicity "
                     "histogram (reference predict_step protocol) and the absorbing bridge "
                     "evolves the mask"),
        **train_info,
        "sampler_steps": config.bridge.num_timesteps,
        "gen_wall_s": round(gen_s, 1),
    }
    launches = {"train": train_launches, "generate": gen_launches}
    return config, experiment.datamodule.dataclass.target, gen_cloud, info, extra, launches


# ---------------------------------------------------------------- transdim
def run_transdim(args, shard):
    config = TransdimensionalEpicConfig()
    _point_data_at_shard(config, args, shard)
    # the quality-tuned block (torch_quality_families.tuned_transdim_config),
    # the EMA half-life scaled to ~1/10 of the run's kimg
    config.loss_kwargs.x0_logit_ce_loss_weight = 200.0
    config.loss_kwargs.rate_loss_weight = 100.0
    config.optimizer_kwargs.lr = 1e-3
    config.ema_halflife_kimg = max(10.0, args.train_steps * args.batch_size / 1000.0 / 10.0)
    steps = args.sampler_steps or 96
    config.sampler_kwargs.dt = 1.0 / steps
    if args.multi_birth:
        config.sampler_kwargs.multi_birth = args.multi_birth
    experiment, epochs, spe = _experiment(args, "transdim", TransdimensionalExperiment, config)
    print(f"[data] ema_halflife_kimg={config.ema_halflife_kimg:.0f}")
    weights, train_info, train_launches = _fit_or_resume(args, "transdim", experiment, config,
                                                         epochs, spe)
    model, device = experiment.model, experiment.device
    load_weights(model, weights)
    model.eval()
    # the sampler takes only shapes from the template (trajectories start at
    # dims = 1, x ~ N(0, I)): the first loader batch tiled to gen_chunk
    template = next(iter(experiment.datamodule.train))
    reps = max(1, -(-args.gen_chunk // len(template[0])))
    template = [x.repeat_interleave(reps, dim=0)[: args.gen_chunk] for x in template]
    generator = torch.Generator(device=device).manual_seed(args.seed + 2)
    dims_l, cont_l, tok_l = [], [], []
    harness.reset_launches()
    synchronize(device)
    t0 = time.perf_counter()
    n = 0
    while n < args.gen_jets:
        out = model.predict(template, generator=generator)
        take = min(out.dims.shape[0], args.gen_jets - n)
        dims_l.append(out.dims[:take].cpu().numpy())
        cont_l.append(out.continuous[:take].cpu().numpy())
        tok_l.append(torch.argmax(out.discrete[:take], dim=-1).cpu().numpy())
        n += take
    synchronize(device)
    gen_s = time.perf_counter() - t0
    gen_launches = harness.launches()
    print(f"[gen] {args.gen_jets} jets in {gen_s:.1f}s ({steps} steps, "
          f"multi_birth={config.sampler_kwargs.multi_birth})")

    dims_gen = np.concatenate(dims_l).astype(np.int64)
    cont = np.concatenate(cont_l)
    tokens = np.concatenate(tok_l)[..., None]
    N = config.data.max_num_particles
    alive = np.arange(N)[None, :] < dims_gen[:, None]
    # diverged jets left out, so that one exploded trajectory cannot dominate the table
    jet_ok = np.abs(cont[..., 0] * alive).max(axis=1) < 50.0
    gen_cloud = state_to_cloud(cont[jet_ok], tokens[jet_ok],
                               alive[jet_ok][..., None].astype(np.int64),
                               experiment.config.data.target_preprocess_stats)
    target = experiment.datamodule.dataclass.target
    mult_data = np.asarray(target.multiplicity).reshape(-1)
    extra = {"multiplicity_dynamics": {
        "mult_mean_gen": round(float(dims_gen.mean()), 3),
        "mult_std_gen": round(float(dims_gen.std()), 3),
        "mult_mean_data": round(float(mult_data.mean()), 3),
        "mult_std_data": round(float(mult_data.std()), 3),
        "scored_jet_fraction": round(float(jet_ok.mean()), 5),
    }}
    info = {
        "protocol": ("TransdimensionalJumpDiffusion trained on the full shard "
                     "(quality-tuned loss weights + run-scaled lr/EMA); sampling starts at "
                     "dims=1, x~N(0,I) and births particles via the learned jump rate "
                     "(tau-leaped multi-birth solver, analytic all-dims posterior)"),
        **train_info,
        "sampler_steps": steps,
        "multi_birth": int(config.sampler_kwargs.multi_birth),
        "gen_wall_s": round(gen_s, 1),
    }
    launches = {"train": train_launches, "generate": gen_launches}
    return experiment.config, target, gen_cloud, info, extra, launches


RUNNERS = {"mbm": run_mbm, "absorbing": run_absorbing, "transdim": run_transdim}


def run(args):
    """The family's run and scoring: the JSON document."""
    shard = _ensure_shard(args)
    config, target, gen_cloud, info, extra, launches = RUNNERS[args.family](args, shard)

    data_cloud = data_cloud_of(target, config)
    hl_data = JetClassHighLevelFeatures(data_cloud)
    N = config.data.max_num_particles
    mult_data = np.asarray(data_cloud.multiplicity).reshape(-1)
    mult_gen = np.asarray(gen_cloud.multiplicity).reshape(-1)
    metrics = score(JetClassHighLevelFeatures(gen_cloud), hl_data, FEATURES)
    metrics["KL_mult_hist"] = round(_hist_kl(mult_gen, mult_data, 0, N), 4)

    t0 = time.time()
    floors = bootstrap_floors(data_cloud, hl_data, FEATURES, args.gen_jets, args.boots, args.seed)
    print(f"[floors] {args.boots} boots at gen_jets={args.gen_jets}: {time.time() - t0:.1f}s")
    ratio_to_floor = {k: round(v / max(floors[k]["median"], 1e-9), 2)
                      for k, v in metrics.items()
                      if v is not None and floors.get(k) and floors[k]["median"]}

    protocol = info.pop("protocol")
    top = {k: info.pop(k) for k in ("train_steps", "sampler_steps", "multi_birth") if k in info}
    device = resolve_device(args.device)
    jax_readings = harness.load_jax_readings(args.jax_readings)
    return {
        "family": args.family,
        "protocol": (
            "SYNTHETIC JetClass-schema data (3-class prong mixture, "
            "torch_make_jetclass_synth.py: the physics is synthetic; schema, featurization, "
            "preprocessing, training, sampling and scoring are the production paths) on the "
            "port; " + protocol + "; floors = plug-in bootstrap at the same generation size "
            "(torch_metric_floors.py)"
        ),
        "data": {"shard": os.path.basename(shard), "n_jets": args.n_data,
                 "max_particles": args.max_particles, "data_seed": args.data_seed},
        **top,
        "batch_size": args.batch_size,
        "gen_jets": args.gen_jets,
        "platform": harness.platform_of(device),
        "device": device_name(device),
        "seed": args.seed,
        "rebuilt": {**info, "metrics": metrics},
        **extra,
        "floors_at_this_scale": floors,
        "ratio_to_floor_median": ratio_to_floor,
        "launches": launches,
        "jax_readings": None if jax_readings is None else {
            **harness.jax_readings_summary(args.jax_readings, jax_readings,
                                           keys=("family", "protocol", "platform",
                                                 "train_steps", "batch_size", "gen_jets")),
            "metrics": jax_readings["rebuilt"]["metrics"],
            "floors_at_this_scale": jax_readings.get("floors_at_this_scale"),
            "ratio_to_floor_median": jax_readings.get("ratio_to_floor_median")},
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", default="mbm", choices=sorted(RUNNERS))
    ap.add_argument("--n-data", type=int, default=20000)
    ap.add_argument("--max-particles", type=int, default=64)
    ap.add_argument("--data-seed", type=int, default=20260819)
    ap.add_argument("--train-steps", type=int, default=6000)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--hidden", type=int, default=64,
                    help="encoder width of MBM and the absorbing family (the narrow kernels "
                         "take up to 64)")
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--gen-jets", type=int, default=10000)
    ap.add_argument("--gen-chunk", type=int, default=2048)
    ap.add_argument("--sampler-steps", type=int, default=0,
                    help="0 = keep the config value (96 for transdim)")
    ap.add_argument("--multi-birth", type=int, default=0,
                    help="transdim only; 0 = keep the config value")
    ap.add_argument("--boots", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--shard", default=None,
                    help="an existing shard (default: generate into .cache)")
    ap.add_argument("--reuse-params", action="store_true",
                    help="skip training when the workdir holds this setting's train checkpoint")
    ap.add_argument("--jax-readings", default=None,
                    help="the JAX script's output JSON of the same family, printed beside")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default=None, help="write the JSON here")
    args = ap.parse_args(argv)
    if args.workdir is None:
        args.workdir = os.path.join(REPO_ROOT, ".cache", f"torch_scaled_{args.family}")
    return args


def main(argv=None):
    args = parse_args(argv)
    result = run(args)
    if args.out:
        harness.write_json(args.out, result)
        print(f"[out] wrote {args.out}")
    print(json.dumps({"metrics": result["rebuilt"]["metrics"],
                      "ratio_to_floor": result["ratio_to_floor_median"]}, indent=2))
    return result


if __name__ == "__main__":
    main()
