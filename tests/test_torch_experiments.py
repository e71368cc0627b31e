"""The port's experiments and their config files against the JAX package on
the CPU: params.yaml round-trips between the packages for the three
families; each family's experiment, at the sizes of the JAX package's
integration tests (tests/test_generative/test_trainer_integration.py,
test_multimodal.py), trains two epochs with a falling loss, generates, and
reloads from its run directory to the same bits; MBM from transplanted
weights gives JAX's first-batch loss (relative 1e-5) with the same injected
bridge draws; the experiments and the training scripts run on the GPU unless
asked for the CPU, and raise without one.

The loss is held on one validation batch with fixed bridge draws before and
after the two epochs (a per-epoch mean moves with the draws of its steps).
The transdimensional family trains at lr 1e-3, the rate of the JAX
package's quality runs (its default 3e-5 barely moves in two epochs).
"""

import os
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from multimodal_particles_tpu.config_classes import AbsorbingConfig as JaxAbsorbingConfig
from multimodal_particles_tpu.config_classes import MultimodalBridgeMatchingConfig as JaxConfig
from multimodal_particles_tpu.config_classes.transdimensional_unconditional_config import (
    TransdimensionalEpicConfig as JaxTransdimConfig,
)
from multimodal_particles_tpu.data.particle_clouds.jets_dataloader import (
    JetsDataloaderModule as JaxDataloader,
)
from multimodal_particles_tpu.models.generative.multimodal_bridge_matching import (
    MultiModalBridgeMatching as JaxMBM,
)
from multimodal_particles_tpu.parallel.mesh import pad_to_multiple, shard_batch
from multimodal_particles_tpu.training.trainer import Trainer as JaxTrainer
from multimodal_particles_tpu_torch.config_classes import (
    AbsorbingConfig,
    MultimodalBridgeMatchingConfig,
    TransdimensionalEpicConfig,
)
from multimodal_particles_tpu_torch.training import (
    AbsorbingExperiment,
    MultimodalBridgeMatchingExperiment,
    TransdimensionalExperiment,
)
from multimodal_particles_tpu_torch.utils.transplant import params_from_flax
from torch_port_helpers import assert_batch_equals, jax_bridge_draws, jet_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "tests", "resources", "configs_files")
MBM_YAML = os.path.join(CONFIGS, "config-mbm-test.yaml")
ABSORBING_YAML = os.path.join(CONFIGS, "config-absorbing-test.yaml")
LOSS_RTOL = 1e-5

EXPERIMENTS = {
    "mbm": MultimodalBridgeMatchingExperiment,
    "absorbing": AbsorbingExperiment,
    "transdim": TransdimensionalExperiment,
}
SCRIPTS = {
    "mbm": "torch_multimodal_train.py",
    "absorbing": "torch_absorbing_train.py",
    "transdim": "torch_transdimensional_train.py",
}


def small_config(family):
    """The port's config of a family at the JAX integration tests' sizes."""
    if family == "mbm":
        cfg = MultimodalBridgeMatchingConfig.from_yaml(MBM_YAML)
        cfg.data.batch_size, cfg.data.max_num_particles = 16, 32
        cfg.bridge.num_timesteps = 10
    elif family == "absorbing":
        cfg = AbsorbingConfig.from_yaml(ABSORBING_YAML)
        cfg.data.num_jets, cfg.data.max_num_particles, cfg.data.batch_size = 100, 16, 16
        cfg.bridge.num_timesteps = 4
        cfg.generator.transformer_dim, cfg.generator.n_attn_blocks = 32, 1
    else:
        cfg = TransdimensionalEpicConfig()
        cfg.data.num_jets, cfg.data.max_num_particles, cfg.data.batch_size = 100, 16, 16
        cfg.encoder.transformer_dim, cfg.encoder.n_attn_blocks = 32, 1
        cfg.sampler_kwargs.dt = 0.25
        cfg.optimizer_kwargs.lr = 1e-3
    return cfg


def fixed_loss(experiment, batch):
    with torch.no_grad():
        loss, _ = experiment.model.loss_fn(batch, torch.Generator().manual_seed(123))
    return loss.item()


def outputs(states):
    """The tensors of a list of final states, by field."""
    return [{k: v for k, v in vars(s).items() if isinstance(v, torch.Tensor)} for s in states]


# ------------------------------------------------------------------ configs


@pytest.mark.parametrize("family", ["mbm", "absorbing", "transdim"])
def test_params_yaml_round_trips_between_the_packages(family, tmp_path):
    """A params.yaml written by either package, after preprocessing has put
    the stats and the multiplicity histograms into the config, loads in the
    other with equal fields."""
    jax_cfg, cfg, jax_jets, jets = jet_pair(family)
    jax_jets.preprocess()
    jets.preprocess()
    if family != "transdim":
        JaxDataloader(jax_cfg, jax_jets).update_config(jax_cfg)
        from multimodal_particles_tpu_torch.data.particle_clouds.jets_dataloader import (
            JetsDataloaderModule,
        )

        JetsDataloaderModule(cfg, jets, device="cpu").update_config(cfg)
    del jax_cfg.data.seed  # the JetDataclass's attribute, not a config field
    jax_cls = {"mbm": JaxConfig, "absorbing": JaxAbsorbingConfig,
               "transdim": JaxTransdimConfig}[family]
    port_cls = type(cfg)
    assert cfg.to_dict() == jax_cfg.to_dict()
    jax_cfg.to_yaml(str(tmp_path / "jax.yaml"))
    cfg.to_yaml(str(tmp_path / "port.yaml"))
    assert port_cls.from_yaml(str(tmp_path / "jax.yaml")).to_dict() == jax_cfg.to_dict()
    assert jax_cls.from_yaml(str(tmp_path / "port.yaml")).to_dict() == cfg.to_dict()
    if family != "transdim":  # the same YAML text
        assert (tmp_path / "jax.yaml").read_text() == (tmp_path / "port.yaml").read_text()


# -------------------------------------------------------------- experiments


@pytest.mark.parametrize("family", ["mbm", "absorbing", "transdim"])
def test_experiment_trains_generates_and_reloads_to_the_same_bits(family, tmp_path):
    run = str(tmp_path / "run")
    experiment = EXPERIMENTS[family](small_config(family), run, seed=3, device="cpu")
    assert os.path.isfile(os.path.join(run, "params.yaml"))
    batch = next(iter(experiment.datamodule.valid))
    experiment.trainer.setup(len(experiment.datamodule.train))  # the seeded weights
    before = fixed_loss(experiment, batch)
    history = experiment.train(2)
    assert len(history) == 2 and all(np.isfinite(r["train_loss"]) for r in history)
    after = fixed_loss(experiment, batch)
    assert after < before, (before, after)

    experiment.trainer.load_checkpoint("best")
    generated = experiment.generate()
    assert len(generated) == len(experiment.datamodule.valid)
    for state in outputs(generated):
        for value in state.values():
            assert torch.isfinite(value.float()).all()

    again = EXPERIMENTS[family](experiment_dir=run, seed=3, device="cpu")
    assert again.config.to_dict() == experiment.config.to_dict()
    for got, ref in zip(outputs(again.generate()), outputs(generated)):
        assert got.keys() == ref.keys()
        for name in ref:
            assert torch.equal(got[name], ref[name]), name


def test_mbm_first_batch_loss_matches_jax_from_transplanted_weights(tmp_path):
    """The JAX datamodule and Trainer from the same config and data seed,
    the port's experiment with the JAX Trainer's initial weights: the first
    training batch is the same, and the port's `Trainer.train_step` on it
    with the JAX step's bridge draws gives JAX's loss and per-head losses."""
    seed = 3
    cfg = small_config("mbm")
    experiment = MultimodalBridgeMatchingExperiment(cfg, str(tmp_path / "run"), seed=seed,
                                                    device="cpu")
    jax_cfg, _, jax_jets, _ = jet_pair("mbm", seed=seed, batch_size=16, max_num_particles=32)
    jax_cfg.bridge.num_timesteps = 10
    jax_jets.preprocess()
    dm = JaxDataloader(jax_cfg, jax_jets)
    jax_cfg = dm.update_config(jax_cfg)
    jax_trainer = JaxTrainer(JaxMBM(jax_cfg), jax_cfg, seed=seed)
    jax_batch = next(iter(dm.train))
    jax_trainer.setup(jax_batch, len(dm.train))

    trainer = experiment.trainer
    trainer.setup(len(experiment.datamodule.train))
    params = jax.tree_util.tree_map(np.asarray, jax_trainer.state.params)
    experiment.model.load_state_dict(params_from_flax(params, experiment.config))
    batch = next(iter(experiment.datamodule.train))
    assert_batch_equals(batch, jax_batch)

    key = jax.random.fold_in(jax_trainer.root_key, 1)  # as Trainer.fit makes it
    sharded = shard_batch(pad_to_multiple(jax_batch, jax_trainer.data_parallel)[0],
                          jax_trainer.mesh)
    draws = jax_bridge_draws(jax.random.fold_in(key, 0), sharded)
    _, ref = jax_trainer._train_step(jax_trainer.state, key, sharded)
    got = trainer.train_step(batch, draws=draws)
    for name in ("loss", "loss_continuous", "loss_discrete"):
        np.testing.assert_allclose(got[name].item(), float(ref[name]), rtol=LOSS_RTOL,
                                   err_msg=name)


# -------------------------------------------------------------- entry points


@pytest.mark.parametrize("family", ["mbm", "absorbing", "transdim"])
def test_experiments_need_a_gpu_unless_asked_for_the_cpu(family, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = tmp_path / "run"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EXPERIMENTS[family](small_config(family), str(run))
    assert not run.exists()


@pytest.mark.parametrize("family", ["mbm", "absorbing", "transdim"])
def test_training_scripts_take_the_device(family, tmp_path, monkeypatch):
    """The CLI trains a config on `--device cpu` into `--experiment-dir`;
    without `--device` on a machine with no GPU it raises. Run in this
    process (runpy) to spare an interpreter start a script."""
    cfg = small_config(family)
    if family != "transdim":
        cfg.train.epochs = 1
    config = tmp_path / "config.yaml"
    cfg.to_yaml(str(config))
    script = os.path.join(ROOT, "scripts", "training", SCRIPTS[family])
    run = tmp_path / "run"
    monkeypatch.setattr(sys, "argv", [script, str(config), "--device", "cpu",
                                      "--experiment-dir", str(run)])
    runpy.run_path(script, run_name="__main__")
    assert (run / "params.yaml").is_file() and (run / "checkpoints" / "last").is_dir()
    assert (run / "logs" / "metrics.jsonl").read_text().count("\n") == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [script, str(config), "--experiment-dir",
                                      str(tmp_path / "run_gpu")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runpy.run_path(script, run_name="__main__")
