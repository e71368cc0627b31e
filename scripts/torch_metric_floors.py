"""Sampling-noise floors of the physics KL/W1 quality metrics with the
PyTorch/CUDA port's metric code, the counterpart of scripts/metric_floors.py:44-150.

The quality harnesses score generated jets against the bundled 100-jet
AspenOpenJets shard. At that data scale the metrics have a floor above 0:
even a model that reproduces the shard's empirical distribution exactly
scores KL/W1 > 0, since both the generated sample and the 100-jet reference
histogram carry sampling noise. Each bootstrap round draws `--gen-jets` jets
with replacement from the data's physics-space cloud (the plug-in "perfect
model") and scores them against the whole cloud through the harnesses'
scoring path (`torch_quality_families.score` for the features' KL/W1,
`_hist_kl` for the multiplicity histogram). Per feature: the median, min and
max over the rounds. Host-side numpy and scipy; no device.

  python scripts/torch_metric_floors.py --out results/torch_metric_floors.json
"""

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_quality_families import _hist_kl, _w1, score  # noqa: E402

from multimodal_particles_tpu_torch.data.particle_clouds.jets import (  # noqa: E402
    JetClassHighLevelFeatures,
)
from multimodal_particles_tpu_torch.data.particle_clouds.particles import (  # noqa: E402
    ParticleClouds,
)


def subsample_cloud(cloud, idx):
    """Physics-space jet subsample (rows of the padded cloud arrays)."""
    state = SimpleNamespace(
        continuous=cloud.continuous[idx],
        discrete=cloud.discrete[idx] if hasattr(cloud, "discrete") else None,
        absorbing=cloud.mask[idx],
    )
    return ParticleClouds(state)


def bootstrap_floors(cloud, hl_data, features, gen_jets, boots, seed,
                     compute_substructure=True):
    rng = np.random.default_rng(seed)
    n_data = cloud.mask.shape[0]
    n_slots = cloud.mask.shape[1]
    mult_data = np.sum(cloud.mask[..., 0] > 0, axis=-1)

    rows = []
    for _ in range(boots):
        idx = rng.integers(0, n_data, size=gen_jets)
        hl_gen = JetClassHighLevelFeatures(subsample_cloud(cloud, idx),
                                           compute_substructure=compute_substructure)
        row = score(hl_gen, hl_data, features)
        mult_gen = mult_data[idx]
        row["KL_mult_hist"] = round(_hist_kl(mult_gen, mult_data, 0, n_slots), 4)
        row["W1_mult_particles"] = round(_w1(mult_gen, mult_data), 4)
        rows.append(row)

    floors = {}
    for key in rows[0]:
        vals = [r[key] for r in rows if r[key] is not None]
        if not vals:
            floors[key] = None
            continue
        floors[key] = {
            "median": round(float(np.median(vals)), 4),
            "min": round(float(np.min(vals)), 4),
            "max": round(float(np.max(vals)), 4),
        }
    return floors


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-jets", type=int, default=100,
                    help="AspenOpenJets shard size that every quality harness uses")
    ap.add_argument("--gen-jets", type=int, nargs="+", default=[4096],
                    help="generation sample size(s) to measure the floor at")
    ap.add_argument("--boots", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-substructure", action="store_true")
    ap.add_argument("--out", default=None, help="write the JSON here too")
    args = ap.parse_args(argv)

    cloud = ParticleClouds("AspenOpenJets", num_jets=args.data_jets)
    hl_data = JetClassHighLevelFeatures(cloud)

    features = ["pt", "m", "eta", "phi", "multiplicity", "Q_total", "Q_jet"]
    if not args.no_substructure:
        features += ["tau21", "tau32", "d2"]

    out = {
        "data_jets": int(cloud.mask.shape[0]),
        "boots": args.boots,
        "seed": args.seed,
        "protocol": (
            "plug-in bootstrap: gen_jets draws WITH replacement from the data shard, "
            "scored vs the full shard with the harnesses' exact scoring path; the floor "
            "a perfect model of the shard would hit"
        ),
        "floors": {},
    }
    for gen_jets in args.gen_jets:
        t0 = time.time()
        out["floors"][str(gen_jets)] = bootstrap_floors(
            cloud, hl_data, features, gen_jets, args.boots, args.seed,
            compute_substructure=not args.no_substructure,
        )
        print(f"[floors] gen_jets={gen_jets}: {time.time() - t0:.1f}s")

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
        print(f"[floors] wrote {args.out}")
    print(json.dumps(out["floors"], indent=2))
    return out


if __name__ == "__main__":
    main()
