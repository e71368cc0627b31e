"""Diagnosis of a trained transdimensional model's sampling trajectories on
the PyTorch/CUDA port, the counterpart of scripts/diagnose_transdim.py:24-146.

Runs the jump sampler with `collect_diagnostics=True` on the weights that
scripts/torch_quality_families.py saved (WORKDIR/trained_params.pt) and
prints a per-step table: max |x|, mean dims, the analytic forward marginal of
the dims that a calibrated reverse chain tracks (`fwd_marg`), the births a
jet and the mean learned rate; then where max |x| first crosses 10, 100,
1e4 and 1e8, the final state's divergence and the realized births against
Σ rate·dt. It localises divergence and multiplicity miscalibration in time
without retraining. `--no-fused` runs the network's modules
(`parallel.use_pallas = False`); `--sampler-steps` and `--multi-birth` set
the solver (`--multi-birth 1`: the reference's single birth). `--out` writes
the table and the summary as JSON, with `device` and the kernels' launches.

  python scripts/torch_diagnose_transdim.py --workdir RUN_DIR [--device cpu]

Runs on the GPU unless --device names another device (`--device cpu`).
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _path in (REPO_ROOT, os.path.dirname(os.path.abspath(__file__))):
    if _path not in sys.path:
        sys.path.insert(0, _path)

import torch_harness as harness  # noqa: E402
from torch_quality_families import PARAMS_FILE, device_name, load_weights  # noqa: E402

from multimodal_particles_tpu_torch.config_classes import TransdimensionalEpicConfig  # noqa: E402
from multimodal_particles_tpu_torch.training import TransdimensionalExperiment  # noqa: E402

THRESHOLDS = (10.0, 100.0, 1e4, 1e8)


def forward_marginal(forward_rate, d0, t):
    """E[dims_t] = E_d0[E[clip(d0 − Poisson(Λ(t)), 1)]] over the data's dims
    `d0`: the forward marginal of the dims at time t."""
    from scipy.stats import poisson

    lam = float(forward_rate.get_rate_integral(torch.tensor(t, dtype=torch.float32)))
    kmax = int(lam + 10 * np.sqrt(lam) + d0.max() + 10)
    k = np.arange(kmax + 1)
    surv = np.clip(d0[:, None] - k[None, :], 1, None)
    return float((surv * poisson.pmf(k, lam)[None, :]).sum(axis=1).mean())


def step_lengths(ts):
    """Each step's dt from the grid of its start times."""
    return -np.diff(np.concatenate([ts, [0.0]]))


def diagnostics_rows(diag, fwd_marg, print_every):
    """The printed table's rows: every `print_every`-th step and the last;
    `fwd_marg(t)` at the time after the step. `births` is the mean births a
    jet that step (the birth fraction, ≤ 1, with the single birth)."""
    ts = diag["ts"]
    dts = step_lengths(ts)
    rows = []
    for i in list(range(0, len(ts), print_every)) + [len(ts) - 1]:
        rows.append({"step": i, "t": float(ts[i]), "max_abs_x": float(diag["max_abs_x"][i]),
                     "mean_dims": float(diag["mean_dims"][i]),
                     "fwd_marg": fwd_marg(max(float(ts[i] - dts[i]), 0.0)),
                     "births": float(diag["birth_frac"][i]),
                     "rate_mean": float(diag["rate_mean"][i])})
    return rows


def first_crossings(diag):
    """{threshold: (step, t, mean dims) where max |x| first exceeds it, or None}."""
    out = {}
    for thresh in THRESHOLDS:
        idx = int(np.argmax(diag["max_abs_x"] > thresh))
        out[f"{thresh:g}"] = ({"step": idx, "t": float(diag["ts"][idx]),
                               "mean_dims": float(diag["mean_dims"][idx])}
                              if diag["max_abs_x"][idx] > thresh else None)
    return out


def final_summary(x, dims, diag):
    alive = np.arange(x.shape[1])[None, :] < dims[:, None]
    vals = np.abs(x[..., 0][alive])
    return {
        "mean_dims": float(dims.mean()),
        "constituent_frac_pt_std_above_50": float((vals > 50).mean()),
        "jet_diverged_frac": float((np.abs(x[..., 0] * alive).max(1) > 50).mean()),
        "realized_births_per_jet": float(diag["birth_frac"].sum()),
        "sum_rate_dt": float(np.sum(diag["rate_mean"] * step_lengths(diag["ts"]))),
    }


def run(args):
    config = TransdimensionalEpicConfig()
    config.data.num_jets = 100
    if args.no_fused:
        config.parallel.use_pallas = False
    if args.sampler_steps:
        config.sampler_kwargs.dt = 1.0 / args.sampler_steps
    if args.multi_birth is not None:
        config.sampler_kwargs.multi_birth = args.multi_birth

    with tempfile.TemporaryDirectory() as run_dir:
        experiment = TransdimensionalExperiment(config, experiment_dir=run_dir, seed=args.seed,
                                                device=args.device)
    model, device = experiment.model, experiment.device
    load_weights(model, torch.load(os.path.join(args.workdir, PARAMS_FILE), map_location=device,
                                   weights_only=True))
    model.eval()

    template = next(iter(experiment.datamodule.train))
    reps = max(1, -(-args.gen_jets // len(template[0])))
    template = [x.repeat_interleave(reps, dim=0) for x in template]
    state = model._as_state(template)
    harness.reset_launches()
    final, nfe, diag = model.sample(state, torch.Generator(device=device).manual_seed(args.seed),
                                    collect_diagnostics=True)
    launches = harness.launches()
    diag = {k: v.cpu().numpy() for k, v in diag.items()}
    d0 = template[0].cpu().numpy().astype(np.int64)
    rows = diagnostics_rows(diag, lambda t: forward_marginal(model.forward_rate, d0, t),
                            args.print_every)
    return {
        "device": device_name(device),
        "jets": int(state.B),
        "nfe": nfe,
        "sampler_steps": int(diag["ts"].shape[0]),
        "multi_birth": int(config.sampler_kwargs.multi_birth),
        "fused": model._pallas_enabled(device),
        "rows": rows,
        "first_crossings": first_crossings(diag),
        "final": final_summary(final.continuous.cpu().numpy(), final.dims.cpu().numpy(), diag),
        "launches": launches,
    }


def print_report(result):
    print(f"{'step':>5} {'t':>8} {'max|x|':>12} {'mean_dims':>10} {'fwd_marg':>9} "
          f"{'births':>10} {'rate_mean':>10}")
    for r in result["rows"]:
        print(f"{r['step']:>5} {r['t']:>8.4f} {r['max_abs_x']:>12.4g} {r['mean_dims']:>10.2f} "
              f"{r['fwd_marg']:>9.2f} {r['births']:>10.4f} {r['rate_mean']:>10.4f}")
    for thresh, hit in result["first_crossings"].items():
        print(f"max|x| never exceeds {thresh}" if hit is None else
              f"max|x| first > {thresh} at step {hit['step']} (t={hit['t']:.4f}, "
              f"mean_dims={hit['mean_dims']:.1f})")
    f = result["final"]
    print(f"final: mean_dims={f['mean_dims']:.2f}  frac |pt_std|>50 = "
          f"{f['constituent_frac_pt_std_above_50']:.5f}  per-jet diverged frac = "
          f"{f['jet_diverged_frac']:.5f}")
    print(f"realized births/jet = {f['realized_births_per_jet']:.2f}; sum(rate*dt) = "
          f"{f['sum_rate_dt']:.2f}; final mean_dims = {f['mean_dims']:.2f}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", required=True, help=f"the run directory holding {PARAMS_FILE}")
    ap.add_argument("--gen-jets", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--print-every", type=int, default=50)
    ap.add_argument("--no-fused", action="store_true",
                    help="run the network's modules (parallel.use_pallas = False)")
    ap.add_argument("--sampler-steps", type=int, default=None,
                    help="override the config's 1/dt step count")
    ap.add_argument("--multi-birth", type=int, default=None,
                    help="override sampler_kwargs.multi_birth (1 = the reference's single birth)")
    ap.add_argument("--out", default=None, help="write the table and summary as JSON")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    result = run(args)
    print_report(result)
    if args.out:
        harness.write_json(args.out, result)
    return result


if __name__ == "__main__":
    main()
