"""Distributional check of the PyTorch port's AbsorbingFlow and
transdimensional samplers against the JAX package's, on the CPU (both
packages; needs JAX). The counterpart of scripts/torch_distribution_check.py
(MBM) for the two families that generate the multiplicity:

    JAX_PLATFORMS=cpu python scripts/torch_family_distribution_check.py \
        [--family absorbing|transdimensional] [--num-jets 1000] [--n 32]

Each family's JAX model is trained briefly on the bundled 100-jet
AspenOpenJets shard, and its weights are transplanted into the port. One
source batch is built from one seed through both packages' data code (the
arrays are asserted equal): the absorbing family's Gaussian-noise clouds with
masks from the data's multiplicities, the transdimensional family's 'list'
template (whose sampler starts at dims = 1) with the multiplicity prior of
each package's datamodule (asserted equal). The JAX sampler draws under four
keys (100 + i) and the port's sampler under its own torch generator: the
absorbing births from Philox uniforms, the transdimensional nearest atom from
Gumbel noise and its births from the port's birth chain.

The distances are those of scripts/quality_families.py: KL and W1 on the
jets' pt, η, φ and mass and the L1 distance of the token fractions; for
AbsorbingFlow also the KL of the generated mask's multiplicity histogram
(`_hist_kl`); for the transdimensional model the KL of the dims histogram
against the first JAX sample's and against the prior's draws. The floor of a
distance is its mean over FLOOR_PAIRS further JAX samples (to the first, or to
the prior); the port passes when each of its distances lies within
MULTIPLE × floor + the distance's absolute term (ABS). Each negative control
must land above the bound on some distance.

The transdimensional model samples at the headline's operating point: the
tau-leaped multi-birth chain with the analytic x0-dimension posterior at every
state. There the births follow the prior through that posterior, and no
weight of the network moves them (a shift of the rate head's output bias
leaves every dims count as it was). Jets whose trajectory diverged (a live
particle beyond twice the data's largest standardized |x| of a feature; the
quality harness cuts at |pt| ≥ 50) are left out of the physics cloud, and the
share of them is a distance of its own.

Negative controls: AbsorbingFlow with its pt drift's output bias shifted, and
with the death channel open (`death_rate_scale`); the transdimensional
sampler with the birth chain's left-endpoint rate in place of the exact rate
integral (`exact_rate_integral` off), and with its prior smoothed
(`analytic_prior_smoothing_sigma`). After the brief training that the CPU
budget allows, the transdimensional flow's physics distances have wide floors
(its kinematics reach |x| of tens), so its controls act on the births.
"""

import argparse
import json
import os
import sys
from types import SimpleNamespace

import jax
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch_distribution_check as mbm_check  # noqa: E402
from torch_quality_families import _hist_kl  # noqa: E402

from multimodal_particles_tpu.config_classes import AbsorbingConfig  # noqa: E402
from multimodal_particles_tpu.config_classes.transdimensional_unconditional_config import (  # noqa: E402
    TransdimensionalEpicConfig,
)
from multimodal_particles_tpu.data.particle_clouds import jets as jax_jets  # noqa: E402
from multimodal_particles_tpu.data.particle_clouds.jets_dataloader import (  # noqa: E402
    JetsDataloaderModule,
)
from multimodal_particles_tpu.models.generative.absorbing.absorbing_flows import (  # noqa: E402
    AbsorbingFlow,
)
from multimodal_particles_tpu.models.generative.transdimensional import (  # noqa: E402
    TransdimensionalJumpDiffusion,
)
from multimodal_particles_tpu.training.trainer import Trainer  # noqa: E402
from multimodal_particles_tpu_torch import config_classes as torch_cfgs  # noqa: E402
from multimodal_particles_tpu_torch.data.particle_clouds.jets import (  # noqa: E402
    JetDataclass as TorchJetDataclass,
)
from multimodal_particles_tpu_torch.data.particle_clouds.jets_dataloader import (  # noqa: E402
    JetsDataloaderModule as TorchDataloader,
)
from multimodal_particles_tpu_torch.models.generative.absorbing.absorbing_flows import (  # noqa: E402
    AbsorbingFlow as TorchAbsorbingFlow,
)
from multimodal_particles_tpu_torch.models.generative.transdimensional.transdimensional_model import (  # noqa: E402
    TransdimensionalJumpDiffusion as TorchTransdim,
)
from multimodal_particles_tpu_torch.utils.transplant import params_from_flax  # noqa: E402

ABSORBING_YAML = os.path.join(ROOT, "tests", "resources", "configs_files",
                              "config-absorbing-test.yaml")
MULTIPLE = mbm_check.MULTIPLE
FLOOR_PAIRS = mbm_check.FLOOR_PAIRS
# absolute terms: the bound's slack where a floor is near 0, set between the
# port's largest reading and the smallest control's (PERF.md has the readings)
ABS = {
    "absorbing": {"KL": 0.02, "W1_pt": 5.0, "W1_eta": 0.002, "W1_phi": 0.002, "W1_m": 2.0,
                  "tokens": 0.005, "mult": 0.005},
    "transdimensional": {"KL": 0.02, "W1_pt": 5.0, "W1_eta": 0.002, "W1_phi": 0.002,
                         "W1_m": 2.0, "tokens": 0.005, "dims": 0.02, "dims_prior": 0.02,
                         "diverged": 0.01},
}
# the negative controls: (name, size)
CONTROLS = {
    "absorbing": (("pt_drift_bias", 0.1), ("death_rate_scale", 1.0)),
    "transdimensional": (("rate_integral_left_endpoint", 1), ("prior_smoothing_sigma", 2.5)),
}
# the EPiC trunk's blocks, the survival and gsdm heads' width, heads and
# blocks, the batch (5 steps an epoch on the 100 jets), and the training
# epochs and sampler steps that keep both checks within 90 s on the CPU: the
# JAX train step's first compile is most of a check's time
EPIC_BLOCKS = 1
HEADS = {"transformer_dim": 32, "n_heads": 1, "n_attn_blocks": 1}
BATCH_SIZE = 20
FAMILY_EPOCHS = {"absorbing": 20, "transdimensional": 200}
FAMILY_STEPS = {"absorbing": 20, "transdimensional": 16}
DIVERGED = 2.0  # a transdimensional jet is scored within this multiple of the data's range


def make_config(family, n=32, epochs=None, steps=None):
    """The family's JAX config at N = n on the bundled 100-jet shard, all of
    it for training (no validation split) in batches of BATCH_SIZE, with an
    EPiC trunk of EPIC_BLOCKS blocks, its survival or gsdm heads cut to HEADS
    and `steps` sampler steps; `epochs`
    sets the absorbing family's cosine schedule (run_check trains for as
    many)."""
    steps = steps or FAMILY_STEPS[family]
    if family == "absorbing":
        cfg = AbsorbingConfig.from_yaml(ABSORBING_YAML)
        cfg.train.scheduler_params["T_max"] = epochs or FAMILY_EPOCHS[family]
        cfg.bridge.num_timesteps = steps
        heads = cfg.generator
    else:
        cfg = TransdimensionalEpicConfig()
        cfg.data.return_type = "list"
        # the tuned block of the quality harness (quality_families.py:237-252)
        cfg.loss_kwargs.x0_logit_ce_loss_weight = 200.0
        cfg.loss_kwargs.rate_loss_weight = 100.0
        cfg.optimizer_kwargs.lr = 1e-3
        cfg.ema_halflife_kimg = 10
        cfg.sampler_kwargs.dt = 1.0 / steps
        heads = cfg.encoder
    cfg.data.max_num_particles, cfg.data.batch_size, cfg.data.num_jets = n, BATCH_SIZE, 100
    cfg.data.data_split_frac = [1.0, 0.0, 0.0]
    cfg.encoder.num_blocks = EPIC_BLOCKS
    for name, value in HEADS.items():
        setattr(heads, name, value)
    return cfg


def port_config(family, cfg):
    cls = torch_cfgs.AbsorbingConfig if family == "absorbing" else torch_cfgs.TransdimensionalEpicConfig
    return cls.from_dict(cfg.to_dict())


def train_jax(family, cfg, epochs, seed):
    """The JAX model trained for `epochs` on its jets (the data's
    noise from `seed`): (model, params as numpy, history, datamodule)."""
    cfg.data.seed = seed
    data = jax_jets.JetDataclass(cfg)
    data.preprocess()
    dm = JetsDataloaderModule(cfg, data)
    if family == "absorbing":
        cfg = dm.update_config(cfg)
        model = AbsorbingFlow(cfg)
    else:
        model = TransdimensionalJumpDiffusion(cfg, dm)
    # one compiled program for the initial weights, where flax's eager init
    # compiles each of its hundreds of operations alone
    model.init = jax.jit(model.init)
    trainer = Trainer(model, cfg, seed=seed)
    history = trainer.fit(dm, epochs)
    # the weights the quality harness samples from: the EMA copy where kept
    state = trainer.state
    params = state.ema_params if state.ema_params is not None else state.params
    params = jax.tree_util.tree_map(np.asarray, params)
    return model, params, history, dm


def port_datamodule(cfg, seed):
    """The port's datamodule of the same config and data seed."""
    torch_cfg = port_config("transdimensional", cfg)
    jets = TorchJetDataclass(torch_cfg, seed=seed)
    jets.preprocess()
    return TorchDataloader(torch_cfg, jets, device="cpu")


def port_model(family, cfg, params, control=None, datamodule=None):
    """The port's model with the JAX weights, under a negative control
    (name, size) or none."""
    name, size = control or (None, 0.0)
    torch_cfg = port_config(family, cfg)
    if name == "death_rate_scale":
        torch_cfg.bridge.death_rate_scale = size
    elif name == "rate_integral_left_endpoint":
        torch_cfg.sampler_kwargs.exact_rate_integral = False
    elif name == "prior_smoothing_sigma":
        torch_cfg.sampler_kwargs.analytic_prior_smoothing_sigma = size
    if family == "absorbing":
        model = TorchAbsorbingFlow(torch_cfg)
        model.load_state_dict(params_from_flax(params, torch_cfg, TorchAbsorbingFlow))
        trunk = model.generator
    else:
        model = TorchTransdim(torch_cfg, datamodule)
        model.load_state_dict(params_from_flax(params, torch_cfg, TorchTransdim))
        trunk = model.network
    with torch.no_grad():
        if name == "pt_drift_bias":
            trunk.epic.epic.output_layer.bias[0] += size
    return model


def transdim_template(dm, num_jets):
    """The 'list' template of `num_jets` jets (the dataset's jets repeated) as
    numpy: the sampler reads only its shapes."""
    ds = dm.dataset
    idx = np.arange(num_jets) % len(ds)
    mask = np.asarray(ds.target_mask)[idx]
    x = np.asarray(ds.target_continuous, np.float32)[idx]
    one_hot = np.eye(dm.config.data.vocab_size_features, dtype=np.float32)[
        np.asarray(ds.target_discrete)[idx][..., 0]] * mask
    return [mask[..., 0].sum(1).astype(np.int32), x, one_hot]


def state_features(family, state, cfg, limit=None):
    """A generated state (numpy arrays) in physics space: (high-level
    features, token fractions, multiplicities, share of diverged jets). A
    transdimensional jet whose trajectory diverged, a live particle with a
    standardized feature beyond `limit` (per feature), is left out of the
    physics cloud and counted, as the quality harness does at |pt| ≥ 50: the
    brief training leaves such particles' η and masses far outside physics,
    and their tails would make every physics distance noise."""
    continuous = np.asarray(state.continuous)
    if family == "absorbing":
        mask = np.asarray(state.mask_t)
        tokens = np.asarray(state.discrete)
        mult = mask[..., 0].sum(1)
        scored = np.ones(len(mask), bool)
    else:
        mult = np.asarray(state.dims)
        mask = (np.arange(cfg.data.max_num_particles)[None, :] < mult[:, None])[..., None]
        tokens = np.argmax(np.asarray(state.discrete), axis=-1)[..., None]
        scored = ((np.abs(continuous) * mask) <= limit).all(axis=(1, 2))
    cloud = SimpleNamespace(continuous=continuous[scored], discrete=tokens[scored],
                            absorbing=mask[scored].astype(np.int64))
    return (*mbm_check.features(cloud, cfg), mult, 1.0 - scored.mean())


def distances(a, b, n):
    (hl_a, frac_a, mult_a, _), (hl_b, frac_b, mult_b, _) = a, b
    out = mbm_check.distances((hl_a, frac_a), (hl_b, frac_b))
    out["mult"] = _hist_kl(mult_a, mult_b, 0, n)
    return out


def bound(family, name, floor):
    return MULTIPLE * floor + ABS[family]["KL" if name.startswith("KL") else name]


def run_check(family, cfg, num_jets, epochs=None, seed=0):
    """Train (`epochs`, the family's FAMILY_EPOCHS by default), sample and
    score; returns a dict with the floors, the port's
    and the negative controls' distances, their bounds and the verdicts."""
    n = cfg.data.max_num_particles
    epochs = epochs or FAMILY_EPOCHS[family]
    jax_model, params, history, dm = train_jax(family, cfg, epochs, seed)
    jax_params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    predict = jax.jit(jax_model.predict)
    if family == "absorbing":
        jax_batch, port_batch = mbm_check.source_batches(
            cfg, num_jets, dm.dataclass.target.multiplicity, seed + 1)
        port_dm = None
    else:
        template = transdim_template(dm, num_jets)
        jax_batch = [jax.numpy.asarray(a) for a in template]
        port_batch = [torch.from_numpy(a) for a in template]
        port_dm = port_datamodule(cfg, seed)
        if port_dm.histogram_target != dm.histogram_target:
            raise ValueError("the packages' datamodules give different multiplicity priors")
    ref = [jax.tree_util.tree_map(np.asarray, predict(jax_params, jax_batch,
                                                      jax.random.PRNGKey(100 + i)))
           for i in range(1 + FLOOR_PAIRS)]
    limit = None
    if family == "transdimensional":
        # DIVERGED times the data's largest standardized |x| of each feature
        live = np.asarray(dm.dataset.target_mask)[..., 0] > 0
        limit = DIVERGED * np.abs(np.asarray(dm.dataset.target_continuous)[live]).max(axis=0)
    ref = [state_features(family, s, cfg, limit) for s in ref]
    prior = None
    if family == "transdimensional":
        nodes = port_dm.graphical_structure.nodes_dist
        prior = nodes.sample(torch.Generator().manual_seed(seed + 3), num_jets).numpy()

    def against(got):
        out = distances(got, ref[0], n)
        if family == "transdimensional":
            out["dims"] = out.pop("mult")
            out["dims_prior"] = _hist_kl(got[2], prior, 0, n)
            out["diverged"] = abs(got[3] - ref[0][3])
        return out

    def port_distances(control=None):
        gen = torch.Generator().manual_seed(seed + 2)
        model = port_model(family, cfg, params, control, port_dm)
        got = state_features(family, model.predict(port_batch, generator=gen), cfg, limit)
        return against(got), float(np.mean(got[2]))

    floors = [against(r) for r in ref[1:]]
    floor = {k: float(np.mean([f[k] for f in floors])) for k in floors[0]}
    if family == "transdimensional":
        # the prior's floor: how far JAX's own samples lie from the prior
        floor["dims_prior"] = float(np.mean([_hist_kl(r[2], prior, 0, n) for r in ref[1:]]))
    got, port_mult = port_distances()
    controls = {f"{name}={size}": port_distances((name, size))[0]
                for name, size in CONTROLS[family]}
    bounds = {k: bound(family, k, v) for k, v in floor.items()}
    return {
        "family": family, "num_jets": num_jets, "n": n,
        "sampler_steps": (cfg.bridge.num_timesteps if family == "absorbing"
                          else round(1.0 / cfg.sampler_kwargs.dt)),
        "train_loss": [r["train_loss"] for r in history],
        "floors": floors, "floor": floor, "port": got, "bound": bounds,
        "controls": controls,
        "port_passes": all(got[k] <= bounds[k] for k in got),
        "controls_fail": {name: any(neg[k] > bounds[k] for k in neg)
                          for name, neg in controls.items()},
        "mean_multiplicity": {"jax": float(np.mean(ref[0][2])), "port": port_mult},
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", choices=["absorbing", "transdimensional"], default=None,
                    help="one family (default: both)")
    ap.add_argument("--num-jets", type=int, default=1000)
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=None, help="default: FAMILY_EPOCHS")
    ap.add_argument("--steps", type=int, default=None, help="default: FAMILY_STEPS")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the results here too (JSON lines)")
    args = ap.parse_args()
    ok = True
    lines = []
    for family in [args.family] if args.family else ["absorbing", "transdimensional"]:
        cfg = make_config(family, args.n, epochs=args.epochs, steps=args.steps)
        result = run_check(family, cfg, args.num_jets, args.epochs, args.seed)
        lines.append(json.dumps(result))
        print(lines[-1])
        ok &= result["port_passes"] and all(result["controls_fail"].values())
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
