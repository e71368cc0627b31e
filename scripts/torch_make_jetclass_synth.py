"""Synthetic JetClass-schema shard at quality-evaluation scale, written as the
`.npz` that the PyTorch/CUDA port reads with numpy alone: the counterpart of
scripts/make_jetclass_synth.py:51-150, which writes the same arrays to a `.h5`
through h5py (a machine without h5py cannot run it).

The arrays are that script's, bit for bit: the same seed, the same numpy draws
in the same order, the same names, dtypes and shapes. The file follows the
converted-JetClass layout of the port's reader
(multimodal_particles_tpu_torch/data/particle_clouds/utils.py): every dataset
under its name and every attribute of the `.h5` as an `attr.<name>` entry, as
scripts/shards_to_npz.py writes the bundled shards.

The content is a three-class prong mixture mimicking the JetClass regimes
(QCD-like 1 prong, W-like 2 prongs, top-like 3 prongs), so that multiplicity,
jet mass, tau21, tau32 and d2 are multimodal.

  python scripts/torch_make_jetclass_synth.py --n-jets 20000 \
      --out .cache/jetclass_synth_20k.npz
"""

import argparse
import os

import numpy as np

FLAG_NAMES = (
    "part_isPhoton",
    "part_isNeutralHadron",
    "part_isChargedHadron",
    "part_isElectron",
    "part_isMuon",
)

# (class fraction, n prongs, multiplicity (mean, dispersion),
#  jet pt (lognorm mean, sigma), prong spread, particle spread)
_CLASSES = (
    (0.5, 1, (22.0, 6.0), (6.2, 0.35), 0.00, 0.12),
    (0.3, 2, (32.0, 7.0), (6.4, 0.25), 0.22, 0.07),
    (0.2, 3, (45.0, 8.0), (6.5, 0.20), 0.28, 0.06),
)
ATTR_PREFIX = "attr."


def synthetic_jetclass_arrays(n_jets=20000, max_particles=64, seed=20260819):
    """The shard's datasets and attributes: ({name: array}, {name: value})."""
    rng = np.random.default_rng(seed)
    L = max_particles

    fracs = np.array([c[0] for c in _CLASSES])
    cls = rng.choice(len(_CLASSES), n_jets, p=fracs / fracs.sum())

    counts = np.empty(n_jets, np.int64)
    jet_pt = np.empty(n_jets)
    pt = np.zeros((n_jets, L))
    eta = np.zeros((n_jets, L))
    phi = np.zeros((n_jets, L))

    slot = np.arange(L)[None, :]
    for ci, (_, n_prong, (m_mu, m_sd), (pt_mu, pt_sd), p_spread,
             x_spread) in enumerate(_CLASSES):
        sel = np.nonzero(cls == ci)[0]
        n = len(sel)
        if n == 0:
            continue
        counts[sel] = np.clip(rng.normal(m_mu, m_sd, n).round().astype(np.int64), 5, L)
        jet_pt[sel] = np.exp(rng.normal(pt_mu, pt_sd, n))

        # prong directions around the jet axis; prong 0 carries the core
        p_eta = rng.normal(0.0, p_spread, (n, n_prong))
        p_phi = rng.normal(0.0, p_spread, (n, n_prong))
        p_share = rng.dirichlet(np.full(n_prong, 6.0), n)  # (n, n_prong)

        # each particle joins a prong with probability its momentum share
        u = rng.random((n, L, 1))
        prong = (u > np.cumsum(p_share, -1)[:, None, :]).sum(-1)
        prong = np.minimum(prong, n_prong - 1)

        # momentum fractions within the jet, weighted toward the particle's
        # prong share so that prongs carry their momentum
        z = rng.gamma(0.6, 1.0, (n, L))
        z *= np.take_along_axis(p_share, prong, axis=1)
        alive = slot < counts[sel][:, None]
        z *= alive
        z /= z.sum(1, keepdims=True)
        pt[sel] = z * jet_pt[sel][:, None]
        eta[sel] = (np.take_along_axis(p_eta, prong, 1) + rng.normal(0, x_spread, (n, L))) * alive
        phi[sel] = (np.take_along_axis(p_phi, prong, 1) + rng.normal(0, x_spread, (n, L))) * alive

    mask = (slot < counts[:, None]).astype(np.uint8)
    # jets placed across the detector
    jet_eta = rng.normal(0.0, 1.0, n_jets)[:, None]
    jet_phi = rng.uniform(-np.pi, np.pi, n_jets)[:, None]
    eta = (eta + jet_eta) * mask
    phi = ((phi + jet_phi + np.pi) % (2 * np.pi) - np.pi) * mask

    px = pt * np.cos(phi)
    py = pt * np.sin(phi)
    pz = pt * np.sinh(eta)
    m_h = rng.uniform(0.0, 0.14, (n_jets, L))
    energy = np.sqrt(px**2 + py**2 + pz**2 + m_h**2) * mask

    # exclusive flavour flags
    flavor = rng.choice(5, (n_jets, L), p=[0.25, 0.2, 0.45, 0.06, 0.04])
    flags = {name: ((flavor == i) & (mask > 0)).astype(np.uint8)
             for i, name in enumerate(FLAG_NAMES)}
    charged = (flavor >= 2) & (mask > 0)
    charge = np.where(charged, rng.choice([-1, 1], (n_jets, L)), 0).astype(np.int8)

    arrays = {name: (arr * mask).astype(np.float32)
              for name, arr in (("part_px", px), ("part_py", py), ("part_pz", pz),
                                ("part_energy", energy))}
    arrays.update(flags)
    arrays["part_charge"] = charge * mask
    arrays["mask"] = mask
    attrs = {
        "format_version": 1,
        "tree": "tree",
        "source": f"synthetic 3-class prong mixture (make_jetclass_synth.py, seed {seed})",
    }
    return arrays, attrs


def write_synthetic_jetclass_npz(path, n_jets=20000, max_particles=64, seed=20260819):
    """Write the synthetic converted-JetClass shard as `.npz`; returns (n_jets, L)."""
    arrays, attrs = synthetic_jetclass_arrays(n_jets, max_particles, seed)
    entries = dict(arrays)
    entries.update({ATTR_PREFIX + k: np.asarray(v) for k, v in attrs.items()})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **entries)
    return n_jets, max_particles


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-jets", type=int, default=20000)
    ap.add_argument("--max-particles", type=int, default=64)
    ap.add_argument("--seed", type=int, default=20260819)
    ap.add_argument(
        "--out",
        default=os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             ".cache", "jetclass_synth_20k.npz"),
    )
    args = ap.parse_args(argv)
    if not args.out.endswith(".npz"):
        raise SystemExit(f"{args.out}: the port's reader takes this shard as .npz")
    n, L = write_synthetic_jetclass_npz(args.out, args.n_jets, args.max_particles, args.seed)
    print(f"wrote {args.out}: {n} jets, max {L} particles")


if __name__ == "__main__":
    main()
