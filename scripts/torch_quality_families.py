"""Quality harness of the absorbing and transdimensional families on the
PyTorch/CUDA port, the counterpart of scripts/quality_families.py:49-460.

Each family is trained on the bundled 100-jet AspenOpenJets shard through
the port's experiment, generates at the config's sampler fidelity, and is
scored on the physics marginals through `JetClassHighLevelFeatures`: the
absorbing family also on its mask and multiplicity dynamics, the
transdimensional family on the multiplicity its birth jumps produce, against
the data and against the `DistributionNodes` prior. The JSON keys are the JAX
harness's (benchmarks/quality_absorbing.json, quality_transdim.json), with
`device` (the torch device's name), `train_loss_first` and `predict_calls`
beside them.

  python scripts/torch_quality_families.py --family absorbing --epochs 400
  python scripts/torch_quality_families.py --family transdimensional \
      --epochs 3000 --skip-ref-mode --out results/torch_quality_transdim.json

Runs on the GPU unless --device names another device (`--device cpu`).
`--epochs 0` scores the seeded weights untrained. The sampled-from weights
(the EMA copy where the config keeps one) are written to
WORKDIR/trained_params.pt; without --workdir the run directory is a temporary
one, removed at the end. `--reuse-params FILE` (transdimensional) scores such
a file without training.
"""

import argparse
import copy
import json
import os
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from multimodal_particles_tpu_torch import test_resources_dir  # noqa: E402
from multimodal_particles_tpu_torch.config_classes import (  # noqa: E402
    AbsorbingConfig,
    TransdimensionalEpicConfig,
)
from multimodal_particles_tpu_torch.data import MultimodalDatabatch  # noqa: E402
from multimodal_particles_tpu_torch.data.particle_clouds.jets import (  # noqa: E402
    JetClassHighLevelFeatures,
)
from multimodal_particles_tpu_torch.data.particle_clouds.particles import (  # noqa: E402
    ParticleClouds,
)
from multimodal_particles_tpu_torch.models.generative.transdimensional.structure import (  # noqa: E402
    DistributionNodes,
)
from multimodal_particles_tpu_torch.models.generative.transdimensional.transdimensional_model import (  # noqa: E402
    TransdimensionalJumpDiffusion,
)
from multimodal_particles_tpu_torch.training import (  # noqa: E402
    AbsorbingExperiment,
    TransdimensionalExperiment,
)

ABSORBING_YAML = os.path.join(test_resources_dir, "configs_files", "config-absorbing-test.yaml")
PARAMS_FILE = "trained_params.pt"


def _hist_kl(gen_counts, ref_counts, lo, hi):
    """Integer-histogram KL(gen || ref) over the bins lo..hi with add-eps
    smoothing (for multiplicity distributions)."""
    bins = np.arange(lo, hi + 2) - 0.5
    p, _ = np.histogram(gen_counts, bins=bins, density=True)
    q, _ = np.histogram(ref_counts, bins=bins, density=True)
    p = p + 1e-8
    q = q + 1e-8
    p /= p.sum()
    q /= q.sum()
    return float(np.sum(p * np.log(p / q)))


def _w1(a, b):
    """1-Wasserstein distance between two empirical samples by quantile
    integration."""
    qs = np.linspace(0.0, 1.0, 1001)
    return float(np.mean(np.abs(np.quantile(a, qs) - np.quantile(b, qs))))


def score(hl_gen, hl_data, features):
    """KL_<f> and W1_<f> of each feature, rounded to 4 digits; None where a
    feature has no value to compare (an empty substructure selection)."""
    out = {}
    for feat in features:
        try:
            out[f"KL_{feat}"] = round(float(hl_gen.KLmetric1D(feat, hl_data)), 4)
            out[f"W1_{feat}"] = round(float(hl_gen.Wassertein1D(feat, hl_data)), 4)
        except (ValueError, IndexError):
            out[f"KL_{feat}"] = None
            out[f"W1_{feat}"] = None
    return out


def state_to_cloud(continuous, discrete, mask, stats):
    """Final sampler state as numpy arrays → post-processed physics-space cloud."""
    state = SimpleNamespace(
        continuous=np.asarray(continuous, np.float32),
        discrete=np.asarray(discrete, np.int64),
        absorbing=np.asarray(mask, np.int64),
    )
    cloud = ParticleClouds(state)
    cloud.stats = stats
    cloud.postprocess()
    return cloud


def noise_source(config, n_jets, target_multiplicity, seed):
    """Fresh noise clouds of the config's source, preprocessed, with source
    masks drawn from `target_multiplicity` (the reference's generation
    protocol)."""
    src_kwargs = dict(config.data.__dict__)
    src_kwargs.update(num_jets=n_jets, target_multiplicity=target_multiplicity, seed=seed)
    src = ParticleClouds(dataset=config.data.source_name, **src_kwargs)
    src.preprocess(output_continuous=config.data.source_preprocess_continuous,
                   output_discrete=config.data.source_preprocess_discrete,
                   stats=config.data.source_preprocess_stats)
    return src


def chunks_of(n_jets, chunk):
    """Row indices of `n_jets` jets in requests of at most `chunk`."""
    return [np.arange(i, min(i + chunk, n_jets)) for i in range(0, n_jets, chunk)]


def data_cloud_of(target, config):
    """The data's physics-space cloud that generated jets are scored against."""
    cloud = copy.deepcopy(target)
    cloud.postprocess(input_continuous=config.data.target_preprocess_continuous,
                      input_discrete=config.data.target_preprocess_discrete,
                      stats=config.data.target_preprocess_stats)
    return cloud


def make_gen_databatch(src, chunk, device):
    """Generation batch on `device`: the source half from the noise cloud
    (what the samplers read)."""
    def tensor(a, dtype):
        return torch.as_tensor(np.asarray(a[chunk]), dtype=dtype).to(device)

    return MultimodalDatabatch(
        source_continuous=tensor(src.continuous, torch.float32),
        source_discrete=tensor(src.discrete, torch.int64),
        source_mask=tensor(src.mask, torch.int64),
    )


def device_name(device):
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def sampled_weights(trainer):
    """The weights the harness samples from: the EMA copy where the trainer
    keeps one, else the parameters; by name, detached."""
    state = trainer.state
    source = state.ema_params if state.ema_params is not None else state.params
    return {name: value.detach().clone() for name, value in source.items()}


def load_weights(model, weights):
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name].to(p.device))


def _save_params(weights, workdir):
    os.makedirs(workdir, exist_ok=True)
    torch.save({k: v.cpu() for k, v in weights.items()}, os.path.join(workdir, PARAMS_FILE))


def _fit(experiment, epochs, device):
    """Trainer.fit for `epochs` (0: the seeded weights) without checkpoints;
    (history, seconds)."""
    experiment.trainer.files = None  # the harness scores in-process
    synchronize(device)
    t0 = time.perf_counter()
    history = experiment.trainer.fit(experiment.datamodule, epochs=epochs)
    synchronize(device)
    return history, time.perf_counter() - t0


def _losses(history, key):
    if not history or history[-1][key] is None:
        return None, None
    return round(history[0][key], 4), round(history[-1][key], 4)


def run_absorbing(args):
    config = AbsorbingConfig.from_yaml(ABSORBING_YAML)
    config.data.num_jets = 100  # the bundled AOJ-mini shard
    config.train.epochs = args.epochs
    config.train.scheduler_params["T_max"] = max(args.epochs, 1)
    if args.sampler_steps:
        config.bridge.num_timesteps = args.sampler_steps

    experiment = AbsorbingExperiment(config, experiment_dir=args.workdir, seed=args.seed,
                                     device=args.device)
    device = experiment.device
    history, train_s = _fit(experiment, args.epochs, device)
    first_loss, final_loss = _losses(history, "train_loss")
    _, final_val = _losses(history, "val_loss")
    print(f"[absorbing] trained {args.epochs} epochs in {train_s:.1f}s: "
          f"train={final_loss} val={final_val}")

    config = experiment.config  # stats filled in by preprocessing
    target = experiment.datamodule.dataclass.target

    # generation sources: fresh noise, multiplicities from the data histogram
    # (the reference predict_step protocol); the absorbing bridge then
    # evolves the mask along the trajectory
    gen_src = noise_source(config, args.gen_jets, target.multiplicity, args.seed + 1)

    trainer = experiment.trainer
    _save_params(sampled_weights(trainer), args.workdir)
    chunks = chunks_of(args.gen_jets, args.gen_chunk)
    batches = [make_gen_databatch(gen_src, chunk, device) for chunk in chunks]
    generator = torch.Generator(device=device).manual_seed(args.seed + 2)
    synchronize(device)
    t0 = time.perf_counter()
    outs = trainer.predict(batches, generator=generator)  # the EMA weights where kept
    mask_gen = torch.cat([o.mask_t for o in outs]).cpu().numpy().astype(np.int64)
    gen_s = time.perf_counter() - t0
    print(f"[absorbing] generated {args.gen_jets} jets in {gen_s:.1f}s")

    gen_cloud = state_to_cloud(torch.cat([o.continuous for o in outs]).cpu().numpy(),
                               torch.cat([o.discrete for o in outs]).cpu().numpy(),
                               mask_gen, config.data.target_preprocess_stats)
    hl_data = JetClassHighLevelFeatures(data_cloud_of(target, config))
    features = ["pt", "m", "eta", "phi", "multiplicity", "Q_total", "Q_jet"]
    metrics = score(JetClassHighLevelFeatures(gen_cloud), hl_data, features)

    # the absorbing family's own observables: the mask and multiplicity dynamics
    mult_gen = mask_gen[..., 0].sum(1)
    mult_data = np.asarray(target.multiplicity).reshape(-1)
    mult_init = np.asarray(gen_src.mask[..., 0].sum(1))
    N = config.data.max_num_particles
    slot_gen = mask_gen[..., 0].mean(0)  # P(slot alive) over the pt-sorted slots
    slot_data = np.asarray(target.mask[..., 0]).mean(0)
    mask_metrics = {
        "mult_mean_gen": round(float(mult_gen.mean()), 3),
        "mult_std_gen": round(float(mult_gen.std()), 3),
        "mult_mean_data": round(float(mult_data.mean()), 3),
        "mult_std_data": round(float(mult_data.std()), 3),
        "mult_mean_source_init": round(float(mult_init.mean()), 3),
        "KL_mult_hist": round(_hist_kl(mult_gen, mult_data, 0, N), 4),
        "KL_mult_hist_init": round(_hist_kl(mult_init, mult_data, 0, N), 4),
        "slot_survival_L1": round(float(np.abs(slot_gen - slot_data).mean()), 4),
        "mask_changed_fraction": round(float((mult_gen != mult_init).mean()), 4),
    }

    return {
        "family": "absorbing",
        "protocol": (
            "AbsorbingFlow trained on the AOJ-mini shard (config-absorbing-test) "
            "through the PyTorch/CUDA port; generation starts from fresh noise clouds "
            "with source masks drawn from the data multiplicity histogram (reference "
            "predict_step protocol) and the absorbing bridge evolves the mask; "
            "gen-vs-data KL/W1 plus mask/multiplicity dynamics observables"
        ),
        "config": "config-absorbing-test (AOJ mini, 100 jets)",
        "device": device_name(device),
        "epochs": args.epochs,
        "sampler_steps": config.bridge.num_timesteps,
        "gen_jets": args.gen_jets,
        "predict_calls": len(chunks),
        "train_loss_first": first_loss,
        "final_train_loss": final_loss,
        "final_val_loss": final_val,
        "train_wall_s": round(train_s, 1),
        "gen_wall_s": round(gen_s, 1),
        "metrics": metrics,
        "mask_dynamics": mask_metrics,
    }


def tuned_transdim_config(headline_steps):
    """TransdimensionalEpicConfig with the JAX harness's tuned block
    (quality_families.py:237-252): the headline sampler of `headline_steps`
    steps, the CE and rate weights that give every head an O(1) share of the
    loss, and the learning rate and EMA half-life scaled to a run of a few
    thousand steps on the 100-jet shard."""
    config = TransdimensionalEpicConfig()
    config.data.num_jets = 100
    config.sampler_kwargs.dt = 1.0 / headline_steps
    config.loss_kwargs.x0_logit_ce_loss_weight = 200.0
    config.loss_kwargs.rate_loss_weight = 100.0
    config.optimizer_kwargs.lr = 1e-3
    config.ema_halflife_kimg = 10
    return config


def run_transdimensional(args):
    headline_steps = args.sampler_steps or 96
    config = tuned_transdim_config(headline_steps)
    experiment = TransdimensionalExperiment(config, experiment_dir=args.workdir, seed=args.seed,
                                            device=args.device)
    device = experiment.device
    trainer = experiment.trainer
    if args.reuse_params:
        # re-score saved weights without retraining
        weights = torch.load(args.reuse_params, map_location=device, weights_only=True)
        train_s, first_loss, final_loss = 0.0, None, None
        print(f"[transdim] reusing params from {args.reuse_params}")
    else:
        history, train_s = _fit(experiment, args.epochs, device)
        first_loss, final_loss = _losses(history, "train_loss")
        print(f"[transdim] trained {args.epochs} epochs in {train_s:.1f}s: train={final_loss}")
        weights = sampled_weights(trainer)
        _save_params(weights, args.workdir)

    dm = experiment.datamodule
    # the sampler takes only SHAPES from the template (trajectories start at
    # dims = 1, x ~ N(0, I)): the first loader batch tiled up to gen_chunk
    template = next(iter(dm.train))
    reps = max(1, -(-args.gen_chunk // len(template[0])))
    template = [x.repeat_interleave(reps, dim=0) for x in template]

    N = config.data.max_num_particles
    mult_data = dm.dataset.arrays["target_mask"][..., 0].sum(1).astype(np.int64)
    hist = {int(k): int(v) for k, v in zip(*np.unique(mult_data, return_counts=True))}
    prior = DistributionNodes(hist)
    dims_prior = prior.sample(torch.Generator().manual_seed(args.seed + 3), args.gen_jets).numpy()
    x_data = np.asarray(dm.dataset.arrays["target_continuous"])
    m_data = np.asarray(dm.dataset.arrays["target_mask"][..., 0]) > 0
    pt_data = x_data[..., 0][m_data]

    hl_data = JetClassHighLevelFeatures(data_cloud_of(dm.dataclass.target, config))
    features = ["pt", "m", "eta", "phi", "multiplicity", "Q_total", "Q_jet",
                "tau21", "tau32", "d2"]
    calls = {}

    def generate(steps, multi_birth):
        """gen_jets jets at the given solver setting: (dims (G,), continuous
        (G, N, 3) standardized, tokens (G, N, 1), wall seconds)."""
        cfg2 = copy.deepcopy(config)
        cfg2.sampler_kwargs.dt = 1.0 / steps
        cfg2.sampler_kwargs.multi_birth = multi_birth
        model2 = TransdimensionalJumpDiffusion(cfg2, dm).to(device)
        load_weights(model2, weights)
        model2.eval()
        generator = torch.Generator(device=device).manual_seed(args.seed + 2)
        dims_l, cont_l, tok_l = [], [], []
        synchronize(device)
        t0 = time.perf_counter()
        n = r = 0
        while n < args.gen_jets:
            out = model2.predict(template, generator=generator)
            r += 1
            # truncate each chunk to the remaining quota so that every metric
            # scores the same first gen_jets jets
            take = min(out.dims.shape[0], args.gen_jets - n)
            dims_l.append(out.dims[:take].cpu().numpy())
            cont_l.append(out.continuous[:take].cpu().numpy())
            tok_l.append(torch.argmax(out.discrete[:take], dim=-1).cpu().numpy())
            n += take
        gen_s = time.perf_counter() - t0
        calls[steps] = r
        print(f"[transdim] generated {args.gen_jets} jets in {gen_s:.1f}s "
              f"({steps} steps, multi_birth={multi_birth})")
        return (np.concatenate(dims_l).astype(np.int64), np.concatenate(cont_l),
                np.concatenate(tok_l)[..., None], gen_s)

    def score_setting(dims_gen, cont, tokens, gen_s, steps, multi_birth):
        metrics = {
            "mult_mean_gen": round(float(dims_gen.mean()), 3),
            "mult_std_gen": round(float(dims_gen.std()), 3),
            "mult_mean_data": round(float(mult_data.mean()), 3),
            "mult_std_data": round(float(mult_data.std()), 3),
            "KL_mult_gen_vs_data": round(_hist_kl(dims_gen, mult_data, 0, N), 4),
            "KL_mult_gen_vs_prior": round(_hist_kl(dims_gen, dims_prior, 0, N), 4),
            # mean prior log-likelihood of the generated dims against that of
            # the data's own multiplicities
            "prior_logp_gen": round(
                float(prior.log_prob(torch.from_numpy(np.clip(dims_gen, 1, N))).mean()), 4),
            "prior_logp_data": round(float(prior.log_prob(torch.from_numpy(mult_data)).mean()), 4),
            "W1_mult_gen_vs_data": round(_w1(dims_gen, mult_data), 4),
        }
        # the constituent-pt marginal in standardized space; trajectories
        # that diverged (|pt| ≥ 50 where the data is O(1)) are counted, left
        # out of that marginal, and their jets left out of the physics cloud
        alive = np.arange(N)[None, :] < dims_gen[:, None]
        pt_gen = cont[..., 0][alive]
        finite = np.abs(pt_gen) < 50.0
        metrics["diverged_constituent_frac"] = round(float(1.0 - finite.mean()), 5)
        metrics["pt_median_gen"] = round(float(np.median(pt_gen)), 4)
        metrics["pt_median_data"] = round(float(np.median(pt_data)), 4)
        if finite.any():
            metrics["W1_pt_standardized"] = round(_w1(pt_gen[finite], pt_data), 4)
        metrics["pt_mean_data"] = round(float(pt_data.mean()), 4)

        jet_ok = np.abs(cont[..., 0] * alive).max(axis=1) < 50.0
        gen_cloud = state_to_cloud(cont[jet_ok], tokens[jet_ok],
                                   alive[jet_ok][..., None].astype(np.int64),
                                   config.data.target_preprocess_stats)
        physics = score(JetClassHighLevelFeatures(gen_cloud), hl_data, features)
        physics["scored_jet_fraction"] = round(float(jet_ok.mean()), 5)
        return {"sampler_steps": steps, "multi_birth": multi_birth,
                "gen_wall_s": round(gen_s, 1), "metrics": metrics, "physics_metrics": physics}

    headline_mb = args.multi_birth or config.sampler_kwargs.multi_birth
    headline = score_setting(*generate(headline_steps, headline_mb), headline_steps, headline_mb)
    # the reference-mode anchor: the ≤ 1-birth-a-step solver at 1000 steps
    ref_mode = None if args.skip_ref_mode else score_setting(*generate(1000, 1), 1000, 1)

    return {
        "family": "transdimensional",
        "protocol": (
            "TransdimensionalJumpDiffusion trained on the AOJ-mini shard through the "
            "PyTorch/CUDA port (Linear-discrete trunk, per-live score normalization, "
            "O(1)-balanced CE/rate weights, run-length-scaled lr/EMA); sampling starts "
            "at dims=1, x~N(0,I) and births particles via the jump rate. Headline = "
            "tau-leaped multi-birth solver; reference_mode = single-birth at 1000 steps. "
            "Scored on multiplicity (data + DistributionNodes prior), standardized "
            "constituent pt, and the physical-unit KL/W1 observable suite"
        ),
        "config": ("TransdimensionalEpicConfig + ce_w=200 rate_w=100 lr=1e-3 "
                   "ema_halflife_kimg=10 (AOJ mini, 100 jets)"),
        "device": device_name(device),
        "epochs": None if args.reuse_params else args.epochs,
        "params_source": args.reuse_params or "trained in-run",
        "params_provenance": (args.params_provenance if args.reuse_params
                              else f"trained in-run: {args.epochs} epochs, seed {args.seed}"),
        "sampler_steps": headline["sampler_steps"],
        "multi_birth": headline["multi_birth"],
        "gen_jets": args.gen_jets,
        "predict_calls": calls[headline_steps],
        "template_jets": len(template[0]),
        "train_loss_first": first_loss,
        "final_train_loss": final_loss,
        "train_wall_s": round(train_s, 1),
        "gen_wall_s": headline["gen_wall_s"],
        "metrics": headline["metrics"],
        "physics_metrics": headline["physics_metrics"],
        "reference_mode_1000step_single_birth": ref_mode,
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", required=True, choices=["absorbing", "transdimensional"])
    ap.add_argument("--epochs", type=int, default=400, help="0 scores the seeded weights")
    ap.add_argument("--gen-jets", type=int, default=4096)
    ap.add_argument("--gen-chunk", type=int, default=1024)
    ap.add_argument("--sampler-steps", type=int, default=None,
                    help="override the config's sampler step count")
    ap.add_argument("--multi-birth", type=int, default=None,
                    help="override the config's max births a step (transdimensional)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reuse-params", default=None,
                    help="a trained_params.pt to score without training (transdimensional)")
    ap.add_argument("--params-provenance", default="a saved run of this harness",
                    help="training provenance of --reuse-params, recorded in the output")
    ap.add_argument("--skip-ref-mode", action="store_true",
                    help="skip the 1000-step single-birth reference-mode anchor")
    ap.add_argument("--workdir", default=None,
                    help="run directory (default: a temporary one, removed at the end)")
    ap.add_argument("--out", default=None, help="write the JSON here too")
    return ap.parse_args(argv)


def run(args):
    """The family's harness in args.workdir, else in a temporary directory."""
    runner = run_absorbing if args.family == "absorbing" else run_transdimensional
    if args.workdir is not None:
        return runner(args)
    with tempfile.TemporaryDirectory() as tmp:
        return runner(argparse.Namespace(**{**vars(args), "workdir": tmp}))


def main(argv=None):
    args = parse_args(argv)
    result = run(args)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
