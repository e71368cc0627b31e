"""Raw readers, featurisation, noise sources and the token codec of the jet
datasets (multimodal_particles_tpu/data/particle_clouds/utils.py:1-523).

Host-side numpy, as in the JAX package; the arithmetic is the JAX file's,
line for line, so that both packages give the same arrays bit for bit.

A shard is read from a `.npz` (numpy alone) or from a `.h5` (through `h5py`,
imported inside the reader: the GPU machine has no h5py), chosen by the
path's suffix. A `.npz` holds the `.h5`'s datasets under the same names,
dtypes and shapes, and its attributes as `attr.<name>` entries
(`scripts/shards_to_npz.py` writes them). The ROOT readers wait
(ROADMAP Queue 1).

AOJ PFCands layout (tests/resources/data/2016H_job0_mini.{h5,npz}):
  columns [px, py, pz, energy, d0, d0Err, dz, dzErr, charge, pid, PUPPI].
"""

import numpy as np

ATTR_PREFIX = "attr."
CONVERTER = "scripts/shards_to_npz.py"


def read_shard(filepath, names=None):
    """The datasets `names` (all when None) of one shard and its attributes:
    (arrays dict, attrs dict). `.npz` through numpy, `.h5`/`.hdf5` through
    h5py; any other suffix raises."""
    path = str(filepath)
    if path.endswith(".npz"):
        with np.load(path) as f:
            keys = [k for k in f.files if not k.startswith(ATTR_PREFIX)]
            attrs = {k[len(ATTR_PREFIX):]: f[k][()] for k in f.files if k.startswith(ATTR_PREFIX)}
            missing = [k for k in (names or ()) if k not in keys]
            if missing:
                raise ValueError(f"{path}: missing datasets {missing}")
            arrays = {k: f[k] for k in (names if names is not None else keys)}
        return arrays, attrs
    if path.endswith((".h5", ".hdf5")):
        try:
            import h5py
        except ImportError as e:
            raise ImportError(
                f"{path}: reading a .h5 shard needs h5py, which is not installed here. "
                f"Convert it to .npz with {CONVERTER} where h5py is installed and read "
                "the .npz instead."
            ) from e
        with h5py.File(path, "r") as f:
            missing = [k for k in (names or ()) if k not in f]
            if missing:
                raise ValueError(f"{path}: missing datasets {missing}")
            arrays = {k: f[k][:] for k in (names if names is not None else list(f))}
            attrs = dict(f.attrs)
        return arrays, attrs
    raise ValueError(f"{path}: expected a .npz or a .h5 shard")


def _wrap_phi(dphi):
    """Wrap azimuthal differences into (-pi, pi]."""
    return -((-dphi + np.pi) % (2.0 * np.pi) - np.pi)


def read_aoj_file(filepath):
    """One AOJ shard → per-particle feature arrays plus 'mask' (utils.py:23-81):
    PFCands of an unknown species zeroed, pid → the 5-way flavour one-hot
    (electron, muon, photon, neutralHadron, chargedHadron), kinematics
    relative to the jet's summed momentum."""
    arrays, _ = read_shard(filepath, ["PFCands"])
    pf = arrays["PFCands"][:].astype(np.float64)

    known = (11, 13, 22, 130, 211)
    bad = ~np.isin(np.abs(pf[:, :, -2]), known)
    pf[bad] = 0.0

    pid = np.abs(pf[:, :, -2])
    code = np.zeros_like(pid)
    for raw, tok in ((11, 0), (13, 1), (22, 2), (130, 3), (211, 4)):
        code[pid == raw] = tok
    one_hot = (code[..., None] == np.arange(5)[None, None, :]).astype(np.float64)

    px, py, pz, energy = pf[:, :, 0], pf[:, :, 1], pf[:, :, 2], pf[:, :, 3]
    charge = pf[:, :, 8]
    mask = energy > 0

    with np.errstate(divide="ignore", invalid="ignore"):
        pt = np.hypot(px, py)
        eta = np.arcsinh(np.where(pt > 0, pz / np.maximum(pt, 1e-30), 0.0))
        phi = np.arctan2(py, px)

        jet_px = (px * mask).sum(1)
        jet_py = (py * mask).sum(1)
        jet_pz = (pz * mask).sum(1)
        jet_pt = np.hypot(jet_px, jet_py)
        jet_eta = np.arcsinh(jet_pz / np.maximum(jet_pt, 1e-30))
        jet_phi = np.arctan2(jet_py, jet_px)

    etarel = np.nan_to_num(eta - jet_eta[:, None]) * mask
    phirel = _wrap_phi(phi - jet_phi[:, None]) * mask

    return {
        "part_pt": pt * mask,
        "part_etarel": etarel,
        "part_phirel": phirel,
        "part_isPhoton": one_hot[..., 2] * mask,
        "part_isNeutralHadron": one_hot[..., 3] * mask,
        "part_isChargedHadron": one_hot[..., 4] * mask,
        "part_isElectron": one_hot[..., 0] * mask,
        "part_isMuon": one_hot[..., 1] * mask,
        "part_charge": charge * mask,
        "mask": mask.astype(np.float64),
    }


def _compact_pad(features, mask, min_num, max_num):
    """Valid particles to the front of each row, padded or clipped to
    max_num; jets with fewer than `min_num` valid particles dropped
    (utils.py:84-109)."""
    num_valid = mask.sum(1).astype(np.int64)
    keep = num_valid >= min_num
    features = features[keep]
    mask = mask[keep]
    num_valid = num_valid[keep]

    B, L, F = features.shape
    order = np.argsort(~mask.astype(bool), axis=1, kind="stable")  # (B, L)
    compacted = np.take_along_axis(features, order[:, :, None], axis=1)

    out = np.zeros((B, max_num, F), dtype=features.dtype)
    n = min(L, max_num)
    out[:, :n] = compacted[:, :n]
    valid = np.arange(max_num)[None, :] < np.minimum(num_valid, max_num)[:, None]
    out *= valid[:, :, None]
    return out, valid.astype(features.dtype)


FEATURE_ORDER = [
    "part_pt",
    "part_etarel",
    "part_phirel",
    "part_isPhoton",
    "part_isNeutralHadron",
    "part_isChargedHadron",
    "part_isElectron",
    "part_isMuon",
    "part_charge",
]


def _features_to_arrays(per_shard, min_num_particles, max_num_particles, num_jets):
    """Per-shard feature dicts → (continuous, discrete, mask), pT-descending
    within each jet (utils.py:142-157 and :405-421)."""
    all_feats, all_masks = [], []
    for d in per_shard:
        feats = np.stack([d[k] for k in FEATURE_ORDER], axis=-1)  # (B, L, 9)
        feats, valid = _compact_pad(feats, d["mask"] > 0, min_num_particles, max_num_particles)
        all_feats.append(feats)
        all_masks.append(valid)
    feats = np.concatenate(all_feats, axis=0)
    masks = np.concatenate(all_masks, axis=0)

    data = np.concatenate([feats, masks[:, :, None]], axis=-1)  # (B, N, 10)
    idx = np.argsort(-data[..., 0], axis=1, kind="stable")
    data = np.take_along_axis(data, idx[:, :, None], axis=1)
    data = data[:num_jets].astype(np.float32)

    continuous = data[..., :3]
    discrete = data[..., 3:-1].astype(np.int64)
    mask = data[..., -1:].astype(np.int64)
    return continuous, discrete, mask


def extract_aoj_features(dataset, **args):
    """AOJ shard(s) → (continuous (B, N, 3) [pt, etarel, phirel],
    discrete (B, N, 6) [flavour one-hot, charge], mask (B, N, 1))
    (utils.py:125-157)."""
    if isinstance(dataset, str):
        dataset = [dataset]
    return _features_to_arrays(
        [read_aoj_file(path) for path in dataset],
        args.get("min_num_particles", 0), args.get("max_num_particles", 150),
        args.get("num_jets", 100_000),
    )


# --------------------------------------------------------------- JetClass
#
# The converted JetClass layout (utils.py:160-189): one shard holds
#   part_px, part_py, part_pz, part_energy    (B, L) float32
#   part_isPhoton ... part_isMuon             (B, L) uint8, exclusive flags
#   part_charge                               (B, L) integer in {-1, 0, 1}
#   mask                                      (B, L) uint8, 1 = real
#   attribute format_version = 1
JETCLASS_KINEMATIC_BRANCHES = ("part_px", "part_py", "part_pz", "part_energy")
JETCLASS_FLAG_BRANCHES = (
    "part_isPhoton",
    "part_isNeutralHadron",
    "part_isChargedHadron",
    "part_isElectron",
    "part_isMuon",
)
JETCLASS_H5_FORMAT_VERSION = 1


def _jetclass_features_from_raw(px, py, pz, flags, charge, mask):
    """Padded raw JetClass arrays → the FEATURE_ORDER dict, relative
    kinematics against the summed jet momentum (utils.py:201-226)."""
    mask = mask.astype(bool)
    px = px * mask
    py = py * mask
    pz = pz * mask
    with np.errstate(divide="ignore", invalid="ignore"):
        pt = np.hypot(px, py)
        eta = np.arcsinh(np.where(pt > 0, pz / np.maximum(pt, 1e-30), 0.0))
        phi = np.arctan2(py, px)
        jet_px, jet_py, jet_pz = px.sum(1), py.sum(1), pz.sum(1)
        jet_pt = np.hypot(jet_px, jet_py)
        jet_eta = np.arcsinh(jet_pz / np.maximum(jet_pt, 1e-30))
        jet_phi = np.arctan2(jet_py, jet_px)

    out = {
        "part_pt": pt * mask,
        "part_etarel": np.nan_to_num(eta - jet_eta[:, None]) * mask,
        "part_phirel": _wrap_phi(phi - jet_phi[:, None]) * mask,
        "part_charge": charge * mask,
        "mask": mask.astype(np.float64),
    }
    for i, name in enumerate(JETCLASS_FLAG_BRANCHES):
        out[name] = flags[..., i] * mask
    return out


def _load_and_validate_jetclass(filepath):
    """Read every schema dataset once and validate the contract on the
    arrays (utils.py:229-260). Returns (arrays dict, (num_jets, max_len))."""
    required = JETCLASS_KINEMATIC_BRANCHES + JETCLASS_FLAG_BRANCHES + ("part_charge", "mask")
    present, attrs = read_shard(filepath)
    version = attrs.get("format_version")
    if version != JETCLASS_H5_FORMAT_VERSION:
        raise ValueError(f"{filepath}: format_version {version!r} != {JETCLASS_H5_FORMAT_VERSION}")
    missing = [k for k in required if k not in present]
    if missing:
        raise ValueError(f"{filepath}: missing datasets {missing}")
    shape = present["part_px"].shape
    if len(shape) != 2:
        raise ValueError(f"{filepath}: part_px must be (B, L), got {shape}")
    for k in required:
        if present[k].shape != shape:
            raise ValueError(f"{filepath}: {k} shape {present[k].shape} != {shape}")
    arrays = {k: present[k] for k in required}
    flags = np.stack([arrays[k] for k in JETCLASS_FLAG_BRANCHES], axis=-1)
    mask = arrays["mask"].astype(bool)
    if not np.all(flags.sum(-1)[mask] == 1):
        raise ValueError(f"{filepath}: flavor flags not exclusive one-hot")
    if not np.isin(arrays["part_charge"][mask], (-1, 0, 1)).all():
        raise ValueError(f"{filepath}: part_charge outside {{-1,0,1}}")
    return arrays, shape


def validate_jetclass_shard(filepath):
    """Check a converted JetClass shard (.npz or .h5) against the schema;
    returns (num_jets, max_len), raises ValueError on a breach."""
    _, shape = _load_and_validate_jetclass(filepath)
    return shape


def read_jetclass_shard(filepath):
    """One converted JetClass shard → the feature dict read_aoj_file gives
    (utils.py:272-285)."""
    arrays, _ = _load_and_validate_jetclass(filepath)
    px = arrays["part_px"].astype(np.float64)
    py = arrays["part_py"].astype(np.float64)
    pz = arrays["part_pz"].astype(np.float64)
    flags = np.stack([arrays[k].astype(np.float64) for k in JETCLASS_FLAG_BRANCHES], axis=-1)
    charge = arrays["part_charge"].astype(np.float64)
    mask = arrays["mask"].astype(bool)
    return _jetclass_features_from_raw(px, py, pz, flags, charge, mask)


def extract_jetclass_features(dataset, **args):
    """Converted JetClass shard(s) (.npz or .h5) → (continuous, discrete,
    mask) as extract_aoj_features (utils.py:379-421). A `.root` shard needs
    the ROOT reader, which the port does not have yet."""
    if isinstance(dataset, str):
        dataset = [dataset]
    per_shard = []
    for path in dataset:
        if str(path).endswith(".root"):
            raise NotImplementedError(
                f"{path}: the port reads converted JetClass shards (.npz or .h5); "
                "convert the .root shard with the JAX package's scripts/convert_jetclass.py"
            )
        per_shard.append(read_jetclass_shard(path))
    return _features_to_arrays(
        per_shard, args.get("min_num_particles", 0), args.get("max_num_particles", 128),
        args.get("num_jets", 100_000),
    )


def sample_noise(rng, noise="GaussNoise", **args):
    """Source noise clouds: Gauss or Beta continuous features, categorical
    flavour and charge (utils.py:422-454). `rng` is a numpy Generator.
    Returns continuous (num_jets, N, 3) float32, discrete (num_jets, N, 6)
    int64."""
    max_num_particles = args.get("max_num_particles", 128)
    num_jets = args.get("num_jets", 100_000)
    scale = args.get("scale", 1.0)
    cat_probs = args.get("cat_probs", [0.2, 0.2, 0.2, 0.2, 0.2])

    if "BetaNoise" in str(noise):
        concentration = args.get("concentration", [0.1, 10])
        a, b = concentration
        pt = rng.beta(a, b, size=(num_jets, max_num_particles, 1))
        eta_phi = rng.standard_normal((num_jets, max_num_particles, 2)) * scale
        continuous = np.concatenate([pt, eta_phi], axis=2)
    elif "GaussNoise" in str(noise):
        continuous = rng.standard_normal((num_jets, max_num_particles, 3)) * scale
    else:
        raise ValueError('Noise type not recognized. Choose between "GaussNoise" and "BetaNoise".')

    flavor = rng.choice(5, size=(num_jets, max_num_particles), p=cat_probs)
    charge = rng.choice([-1, 1], size=(num_jets, max_num_particles))
    charge[(flavor == 0) | (flavor == 1)] = 0
    flavor_oh = (flavor[..., None] == np.arange(5)[None, None, :]).astype(np.int64)
    discrete = np.concatenate([flavor_oh, charge[..., None]], axis=-1)
    return continuous.astype(np.float32), discrete.astype(np.int64)


def sample_masks(rng, **args):
    """Existence masks drawn from an empirical multiplicity histogram
    (utils.py:457-477)."""
    hist = args.get("target_multiplicity", None)
    min_num_particles = args.get("min_num_particles", 128)
    max_num_particles = args.get("max_num_particles", 128)
    num_jets = args.get("num_jets", 100_000)

    if hist is None or min_num_particles == max_num_particles:
        return np.ones((num_jets, max_num_particles, 1), dtype=np.int64)

    hist = np.asarray(hist).reshape(-1)
    hist_values, _ = np.histogram(hist, bins=np.arange(0, max_num_particles + 2), density=True)
    probs = hist_values / hist_values.sum()
    multiplicity = rng.choice(len(probs), size=num_jets, p=probs)
    masks = (np.arange(max_num_particles)[None, :] < multiplicity[:, None]).astype(np.int64)
    return masks[:, :, None]


def physics_to_onehot(flavor, charge):
    """(5-wide flavour one-hot, charge in {-1, 0, 1}) → the 8-token one-hot:
    photon, neutral hadron, h-, h+, e-, e+, mu-, mu+ (utils.py:480-497)."""
    flavor = np.asarray(flavor)
    charge = np.asarray(charge)
    neutrals = flavor[..., :2].astype(np.int64)
    signed = flavor[..., 2:].astype(np.int64) * charge[..., None].astype(np.int64)
    neg = (signed == -1).astype(np.int64)
    pos = (signed == 1).astype(np.int64)
    charged = np.stack(
        [neg[..., 0], pos[..., 0], neg[..., 1], pos[..., 1], neg[..., 2], pos[..., 2]],
        axis=-1,
    )
    return np.concatenate([neutrals, charged], axis=-1)


TOKEN_TO_FLAVOR = np.array([0, 1, 2, 2, 3, 3, 4, 4])
TOKEN_TO_CHARGE = np.array([0, 0, -1, 1, -1, 1, -1, 1])


def tokens_to_physics(states):
    """8-token vocabulary (…, 1) → (flavour one-hot (…, 5), charge (…, 1)),
    the inverse codec (utils.py:504-515)."""
    states = np.asarray(states).astype(np.int64)
    squeeze_last = states.ndim >= 1 and states.shape[-1] == 1
    tokens = states[..., 0] if squeeze_last else states
    flavor_idx = TOKEN_TO_FLAVOR[tokens]
    charge = TOKEN_TO_CHARGE[tokens]
    flavor = (flavor_idx[..., None] == np.arange(5)).astype(np.int64)
    if squeeze_last:
        charge = charge[..., None]
    return flavor, charge.astype(np.int64)


def sizes_to_histograms(sizes):
    """{multiplicity: count} of a vector of per-jet sizes (utils.py:518-523)."""
    sizes = np.asarray(sizes).reshape(-1).astype(np.int64)
    unique, counts = np.unique(sizes, return_counts=True)
    return dict(zip(unique.tolist(), counts.tolist()))
