"""The transdimensional solver's operating-point sweep (sampler steps ×
multi_birth) on the PyTorch/CUDA port, the counterpart of
scripts/transdim_operating_points.py:39-136.

Sampler cost is about linear in the step count, so a lower step count that
holds quality is a faster operating point. The sweep re-scores trained
weights (`--reuse-params`, a trained_params.pt of
scripts/torch_quality_families.py --family transdimensional) at each point of
`--points` (sampling only, no training) through that harness's transdim
scoring: the same shard, metrics and analytic all-dims posterior. Each point
runs in this process, one after the other; a point that fails stops the
sweep with its error.

Gate for promoting a faster point (the JAX artifact's, against the 96 × 16
anchor): KL_mult ≤ 2× the anchor's, and W1_mult and the continuous W1s within
~15% of it.

The JSON keys are the JAX script's (`subprocess_wall_s` is each point's wall
time, the key kept from the JAX script, whose points ran in subprocesses),
with `device` and each point's kernel `launches` added.

  python scripts/torch_transdim_operating_points.py --reuse-params RUN/trained_params.pt \\
      --out results/transdim_operating_points.json

Runs on the GPU unless --device names another device (`--device cpu`).
"""

import argparse
import json
import os
import sys
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _path in (REPO_ROOT, os.path.dirname(os.path.abspath(__file__))):
    if _path not in sys.path:
        sys.path.insert(0, _path)

import torch_harness as harness  # noqa: E402
import torch_quality_families as quality  # noqa: E402

PHYSICS_W1 = ("W1_pt", "W1_m", "W1_eta", "W1_phi", "W1_tau21", "W1_tau32", "W1_d2")


def parse_points(text):
    """"96x16,64x24" → [(96, 16), (64, 24)]."""
    grid = []
    for tok in text.split(","):
        steps, multi_birth = tok.strip().split("x")
        grid.append((int(steps), int(multi_birth)))
    return grid


def point_row(h, steps, multi_birth, wall):
    """A point's row from the harness's document `h` (the JAX script's row,
    transdim_operating_points.py:67-84)."""
    return {
        "sampler_steps": steps,
        "multi_birth": multi_birth,
        "subprocess_wall_s": round(wall, 1),
        "gen_wall_s": h["gen_wall_s"],
        "KL_mult": h["metrics"]["KL_mult_gen_vs_data"],
        "W1_mult": h["metrics"]["W1_mult_gen_vs_data"],
        "mult_mean_gen": h["metrics"]["mult_mean_gen"],
        "mult_mean_data": h["metrics"]["mult_mean_data"],
        "diverged_constituent_frac": h["metrics"]["diverged_constituent_frac"],
        "physics_W1": {k: h["physics_metrics"][k] for k in PHYSICS_W1},
        "scored_jet_fraction": h["physics_metrics"]["scored_jet_fraction"],
    }


def run_point(steps, multi_birth, args):
    """One point through the families' harness, in this process."""
    argv = ["--family", "transdimensional", "--reuse-params", args.reuse_params,
            "--skip-ref-mode", "--sampler-steps", str(steps), "--multi-birth", str(multi_birth),
            "--gen-jets", str(args.gen_jets), "--gen-chunk", str(args.gen_chunk),
            "--seed", str(args.seed), "--params-provenance", args.params_provenance]
    if args.device:
        argv += ["--device", args.device]
    harness.reset_launches()
    t0 = time.perf_counter()
    h = quality.run(quality.parse_args(argv))
    row = point_row(h, steps, multi_birth, time.perf_counter() - t0)
    row["launches"] = harness.launches()
    row["predict_calls"] = h["predict_calls"]
    print(f"[{steps}x{multi_birth}] KL_mult {row['KL_mult']} W1_mult {row['W1_mult']} "
          f"mean {row['mult_mean_gen']} (data {row['mult_mean_data']}) gen {row['gen_wall_s']}s")
    return row, h["device"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", default="96x16,64x16,64x24,48x24,48x32",
                    help="comma-separated stepsxmulti_birth grid; 96x16 is the anchor")
    ap.add_argument("--gen-jets", type=int, default=4096)
    ap.add_argument("--gen-chunk", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--reuse-params", required=True,
                    help="trained weights: a trained_params.pt of torch_quality_families.py")
    ap.add_argument("--params-provenance", default="a saved run of torch_quality_families.py",
                    help="how the weights were trained, recorded in the output")
    ap.add_argument("--out", default=None, help="write the JSON here (after every point)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    doc = {
        "protocol": (
            f"sampling-only re-score of trained params ({args.params_provenance}; "
            f"{os.path.basename(args.reuse_params)}) through torch_quality_families.py "
            f"--skip-ref-mode at each (sampler_steps, multi_birth), in one process; "
            f"{args.gen_jets} jets, AOJ-mini 100-jet shard, analytic all-dims posterior "
            "on; subprocess_wall_s is each point's wall time"
        ),
        "gate": ("promote a faster point only if KL_mult <= 2x the 96x16 anchor AND W1_mult "
                 "+ continuous W1s within ~15% of it"),
        "rows": [],
    }
    for steps, multi_birth in parse_points(args.points):
        row, device = run_point(steps, multi_birth, args)
        doc["device"] = device
        doc["rows"].append(row)
        if args.out:
            harness.write_json(args.out, doc)
    print(json.dumps(doc["rows"], indent=2))
    return doc


if __name__ == "__main__":
    main()
