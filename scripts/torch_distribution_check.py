"""Distributional check of the PyTorch port's MBM sampler against the JAX
package's, on the CPU (both packages; needs JAX and h5py).

    JAX_PLATFORMS=cpu python scripts/torch_distribution_check.py \
        [--num-jets 20000] [--n 128] [--shard .cache/jetclass_synth_20k.h5]

The JAX MBM at config-berlin widths (the encoder of
tests/resources/configs_files/config-mbm-test.yaml: 2 blocks, hidden 16) is
trained a few epochs on the jets, and its weights are transplanted into the
port. From one source batch, built by both packages' data code from one seed
(the arrays are asserted equal), the JAX sampler draws under two keys and the
port's sampler under its own generator. Each set is post-processed and scored
through `JetClassHighLevelFeatures`: KL and W1 on the jets' pt, η, φ and mass,
and the L1 distance of the token fractions. The floor is the mean distance
of FLOOR_PAIRS further JAX samples (keys 101, 102, ...) to the first (key
100): what two samples of one model differ by. The port passes when each of
its distances to the first JAX sample lies within MULTIPLE × floor + the
feature's absolute term (ABS). The negative controls, the port with its pt
drift's output bias shifted by each of CONTROL_SHIFTS (in standardised
units), must each land above the bound on some distance.

With no --shard, the script writes scripts/make_jetclass_synth.py's 20k-jet
JetClass-schema shard under .cache/ first. With --bundled it runs the check
of tests/test_torch_distribution.py: the bundled 100-jet AspenOpenJets shard
(batch 64), 2,000 jets at N = 32:

    JAX_PLATFORMS=cpu python scripts/torch_distribution_check.py --bundled \
        --num-jets 2000 --n 32
"""

import argparse
import json
import os
import sys

import jax
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from multimodal_particles_tpu.config_classes import MultimodalBridgeMatchingConfig  # noqa: E402
from multimodal_particles_tpu.data.particle_clouds import jets as jax_jets  # noqa: E402
from multimodal_particles_tpu.data.particle_clouds import particles as jax_particles  # noqa: E402
from multimodal_particles_tpu.data.particle_clouds.jets_dataloader import (  # noqa: E402
    JetsDataloaderModule,
    MultimodalDatabatch as JaxDatabatch,
)
from multimodal_particles_tpu.models.generative.multimodal_bridge_matching import (  # noqa: E402
    MultiModalBridgeMatching,
)
from multimodal_particles_tpu.training.trainer import Trainer  # noqa: E402
from multimodal_particles_tpu_torch.config_classes import (  # noqa: E402
    MultimodalBridgeMatchingConfig as TorchConfig,
)
from multimodal_particles_tpu_torch.data import MultimodalDatabatch  # noqa: E402
from multimodal_particles_tpu_torch.data.particle_clouds import jets, particles  # noqa: E402
from multimodal_particles_tpu_torch.data.particle_clouds.utils import physics_to_onehot  # noqa: E402
from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (  # noqa: E402
    MultiModalBridgeMatching as TorchMBM,
)
from multimodal_particles_tpu_torch.utils.transplant import params_from_flax  # noqa: E402

CONFIG = os.path.join(ROOT, "tests", "resources", "configs_files", "config-mbm-test.yaml")
FEATURES = ("pt", "eta", "phi", "m")
MULTIPLE = 3.0
FLOOR_PAIRS = 3
# absolute terms: the bound's slack where the floor is near 0 (KL of
# quantile histograms, W1 in the feature's GeV or radians, L1 of fractions),
# each set between the port's largest reading and the smallest control's
# (the readings are in PERF.md)
ABS = {"KL": 0.02, "W1_pt": 5.0, "W1_eta": 0.002, "W1_phi": 0.002, "W1_m": 2.0,
       "tokens": 0.005}
CONTROL_SHIFTS = (1.0, 0.1, 0.03)  # the negative controls' shifts of the pt drift's output bias


def make_config(n, batch_size=64, epochs=3, target_name="AspenOpenJets", target_path=None,
                train_jets=100):
    """The test config at N = n, training on `train_jets` jets of the target."""
    cfg = MultimodalBridgeMatchingConfig.from_yaml(CONFIG)
    cfg.data.max_num_particles, cfg.data.batch_size = n, batch_size
    cfg.data.target_name, cfg.data.target_path = target_name, target_path
    cfg.data.num_jets = train_jets
    cfg.train.epochs = epochs
    return cfg


def train_jax(cfg, seed):
    """The JAX MBM trained for the config's epochs on its jets (the data's
    noise from `seed`); returns (model, params as numpy, target stats,
    target multiplicities)."""
    cfg.data.seed = seed
    data = jax_jets.JetDataclass(cfg)
    data.preprocess()
    dm = JetsDataloaderModule(cfg, data)
    cfg = dm.update_config(cfg)
    model = MultiModalBridgeMatching(cfg)
    trainer = Trainer(model, cfg, seed=seed)
    history = trainer.fit(dm)
    params = jax.tree_util.tree_map(np.asarray, trainer.state.params)
    return model, params, history, data.target.multiplicity


def source_batches(cfg, num_jets, multiplicity, seed):
    """The same Gaussian-noise source from both packages' data code, with
    masks from the target's multiplicities, preprocessed with the training
    source's stats: (JAX namedtuple of arrays, port MultimodalDatabatch)."""
    kwargs = dict(cfg.data.__dict__, num_jets=num_jets, seed=seed,
                  target_multiplicity=multiplicity)
    ref = jax_particles.ParticleClouds(cfg.data.source_name, **kwargs)
    got = particles.ParticleClouds(cfg.data.source_name, **kwargs)
    for cloud in (ref, got):
        cloud.preprocess(cfg.data.source_preprocess_continuous,
                         cfg.data.source_preprocess_discrete,
                         stats=cfg.data.source_preprocess_stats)
    for name in ("continuous", "discrete", "mask"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    x = ref.continuous.astype(np.float32)
    k = ref.discrete.astype(np.int32)
    m = ref.mask.astype(np.float32)
    jax_batch = JaxDatabatch(x, k, m, x, k, m)
    port_batch = MultimodalDatabatch(torch.from_numpy(got.continuous.astype(np.float32)),
                                     torch.from_numpy(got.discrete),
                                     torch.from_numpy(got.mask.astype(np.float32)))
    return jax_batch, port_batch


def port_model(cfg, params, shift=0.0):
    torch_cfg = TorchConfig.from_dict(cfg.to_dict())
    model = TorchMBM(torch_cfg)
    model.load_state_dict(params_from_flax(params, torch_cfg))
    with torch.no_grad():
        model.encoder.epic.epic.output_layer.bias[0] += shift
    return model


def features(state, cfg):
    """A generated state in physics space: (JetClassHighLevelFeatures
    without substructure, token fractions over the live particles)."""
    cloud = particles.ParticleClouds(state)
    cloud.postprocess(cfg.data.target_preprocess_continuous, cfg.data.target_preprocess_discrete,
                      stats=cfg.data.target_preprocess_stats)
    live = cloud.mask[..., 0] > 0
    tokens = np.argmax(physics_to_onehot(cloud.flavor, cloud.charge), axis=-1)[live]
    fractions = np.bincount(tokens, minlength=8) / max(len(tokens), 1)
    return jets.JetClassHighLevelFeatures(cloud, compute_substructure=False), fractions


def distances(a, b):
    (hl_a, frac_a), (hl_b, frac_b) = a, b
    out = {}
    for f in FEATURES:
        out[f"KL_{f}"] = float(hl_a.KLmetric1D(f, hl_b))
        out[f"W1_{f}"] = float(hl_a.Wassertein1D(f, hl_b))
    out["tokens"] = float(np.abs(frac_a - frac_b).sum())
    return out


def bound(name, floor):
    return MULTIPLE * floor + ABS["KL" if name.startswith("KL") else name]


def run_check(cfg, num_jets, seed=0):
    """Train, sample and score; returns a dict with the floor, the port's and
    the negative controls' distances, their bounds and the verdicts."""
    jax_model, params, history, multiplicity = train_jax(cfg, seed)
    jax_batch, port_batch = source_batches(cfg, num_jets, multiplicity, seed + 1)
    predict = jax.jit(jax_model.predict)
    jax_params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    ref = [jax.tree_util.tree_map(np.asarray, predict(jax_params, jax_batch,
                                                      jax.random.PRNGKey(100 + i)))
           for i in range(1 + FLOOR_PAIRS)]
    ref = [features(jax_state_as_numpy(s), cfg) for s in ref]

    def port_distances(shift=0.0):
        gen = torch.Generator().manual_seed(seed + 2)
        model = port_model(cfg, params, shift)
        return distances(features(model.predict(port_batch, generator=gen), cfg), ref[0])

    floors = [distances(r, ref[0]) for r in ref[1:]]
    floor = {k: float(np.mean([f[k] for f in floors])) for k in floors[0]}
    got = port_distances()
    controls = {shift: port_distances(shift) for shift in CONTROL_SHIFTS}
    bounds = {k: bound(k, v) for k, v in floor.items()}
    return {
        "num_jets": num_jets, "n": cfg.data.max_num_particles,
        "train_loss": [r["train_loss"] for r in history],
        "floors": floors, "floor": floor, "port": got, "bound": bounds,
        "controls": {str(shift): neg for shift, neg in controls.items()},
        "port_passes": all(got[k] <= bounds[k] for k in got),
        "controls_fail": {str(shift): any(neg[k] > bounds[k] for k in neg)
                          for shift, neg in controls.items()},
    }


def jax_state_as_numpy(state):
    """The JAX HybridState's arrays as the port's ParticleClouds takes them."""
    from types import SimpleNamespace

    return SimpleNamespace(continuous=np.asarray(state.continuous),
                           discrete=np.asarray(state.discrete),
                           absorbing=np.asarray(state.absorbing))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-jets", type=int, default=20000)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--shard", default=None,
                    help="a JetClass-schema .h5 (default: the 20k synthetic shard)")
    ap.add_argument("--bundled", action="store_true",
                    help="the test's check: the bundled AspenOpenJets shard, batch 64")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.bundled:
        cfg = make_config(args.n, epochs=args.epochs)
    else:
        shard = args.shard
        if shard is None:
            sys.path.insert(0, os.path.join(ROOT, "scripts"))
            from make_jetclass_synth import write_synthetic_jetclass_shard

            shard = os.path.join(ROOT, ".cache", "jetclass_synth_20k.h5")
            if not os.path.exists(shard):
                os.makedirs(os.path.dirname(shard), exist_ok=True)
                write_synthetic_jetclass_shard(shard, n_jets=20000)
        cfg = make_config(args.n, args.batch_size, args.epochs, "JetClass", [shard],
                          args.num_jets)
    result = run_check(cfg, args.num_jets, args.seed)
    print(json.dumps(result))
    return 0 if result["port_passes"] and all(result["controls_fail"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
