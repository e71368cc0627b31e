"""The port's quality scripts against the JAX system's on the CPU: the
synthetic JetClass shard (scripts/torch_make_jetclass_synth.py against
make_jetclass_synth.py, its `.h5` read through h5py), the evaluation
(torch_evaluate.py against evaluate.py on the same generated state of
transplanted MBM weights), the metric floors (torch_metric_floors.py against
metric_floors.py on the same cloud and bootstrap indices), the families'
harness's histogram KL and W1 (torch_quality_families.py against
quality_families.py) and a run of each family that writes every key of the
JAX harness's output. About 25 s in one process.
"""

import os
import sys
from types import SimpleNamespace

import h5py
import jax
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import evaluate as jax_evaluate  # noqa: E402
import make_jetclass_synth as jax_synth  # noqa: E402
import metric_floors as jax_floors  # noqa: E402
import quality_families as jax_quality  # noqa: E402
import torch_evaluate  # noqa: E402
import torch_make_jetclass_synth as synth  # noqa: E402
import torch_metric_floors as floors  # noqa: E402
import torch_quality_families as quality  # noqa: E402

from multimodal_particles_tpu.data.particle_clouds import jets as jax_jets  # noqa: E402
from multimodal_particles_tpu.data.particle_clouds import particles as jax_particles  # noqa: E402
from multimodal_particles_tpu.data.particle_clouds.jets_dataloader import (  # noqa: E402
    JetsDataloaderModule as JaxDataloader,
)
from multimodal_particles_tpu.models.generative.multimodal_bridge_matching import (  # noqa: E402
    MultiModalBridgeMatching as JaxMBM,
)
from multimodal_particles_tpu.models.generative.states import HybridState as JaxHybridState  # noqa: E402
from multimodal_particles_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from multimodal_particles_tpu_torch.data.particle_clouds import jets, particles  # noqa: E402
from multimodal_particles_tpu_torch.data.particle_clouds.utils import (  # noqa: E402
    read_shard,
    validate_jetclass_shard,
)
from multimodal_particles_tpu_torch.training import MultimodalBridgeMatchingExperiment  # noqa: E402
from multimodal_particles_tpu_torch.utils.transplant import params_from_flax  # noqa: E402
from torch_port_helpers import jet_pair  # noqa: E402

EVAL_RTOL = 1e-6

# the keys that scripts/quality_families.py writes (run_absorbing :185-200,
# run_transdimensional :326-344 and :414-460)
ABSORBING_KEYS = {"family", "protocol", "config", "epochs", "sampler_steps", "gen_jets",
                  "final_train_loss", "final_val_loss", "train_wall_s", "gen_wall_s", "metrics",
                  "mask_dynamics"}
ABSORBING_FEATURES = ("pt", "m", "eta", "phi", "multiplicity", "Q_total", "Q_jet")
MASK_KEYS = {"mult_mean_gen", "mult_std_gen", "mult_mean_data", "mult_std_data",
             "mult_mean_source_init", "KL_mult_hist", "KL_mult_hist_init", "slot_survival_L1",
             "mask_changed_fraction"}
TRANSDIM_KEYS = {"family", "protocol", "config", "epochs", "params_source", "params_provenance",
                 "sampler_steps", "multi_birth", "gen_jets", "final_train_loss", "train_wall_s",
                 "gen_wall_s", "metrics", "physics_metrics",
                 "reference_mode_1000step_single_birth"}
TRANSDIM_METRICS = {"mult_mean_gen", "mult_std_gen", "mult_mean_data", "mult_std_data",
                    "KL_mult_gen_vs_data", "KL_mult_gen_vs_prior", "prior_logp_gen",
                    "prior_logp_data", "W1_mult_gen_vs_data", "diverged_constituent_frac",
                    "pt_median_gen", "pt_median_data", "W1_pt_standardized", "pt_mean_data"}
TRANSDIM_FEATURES = ABSORBING_FEATURES + ("tau21", "tau32", "d2")


def feature_keys(features):
    return {f"{kind}_{f}" for f in features for kind in ("KL", "W1")}


# ------------------------------------------------------------ the shard


def test_synthetic_shard_equals_the_jax_scripts(tmp_path):
    """Both scripts from one seed: every dataset and attribute of the `.npz`
    equals the `.h5`'s (h5py), name, dtype, shape and value; the port's
    reader validates the `.npz` and gives the `.h5`'s arrays."""
    h5_path, npz_path = str(tmp_path / "synth.h5"), str(tmp_path / "synth.npz")
    args = dict(n_jets=300, max_particles=40, seed=11)
    assert jax_synth.write_synthetic_jetclass_shard(h5_path, **args) == (300, 40)
    assert synth.write_synthetic_jetclass_npz(npz_path, **args) == (300, 40)
    with h5py.File(h5_path, "r") as f:
        ref = {name: f[name][()] for name in f}
        ref_attrs = dict(f.attrs)
    with np.load(npz_path) as f:
        got = {k: f[k] for k in f.files if not k.startswith(synth.ATTR_PREFIX)}
        got_attrs = {k[len(synth.ATTR_PREFIX):]: f[k][()] for k in f.files
                     if k.startswith(synth.ATTR_PREFIX)}
    assert got.keys() == ref.keys() and len(ref) == 11
    for name, value in ref.items():
        assert got[name].dtype == value.dtype and got[name].shape == value.shape, name
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    assert got_attrs.keys() == ref_attrs.keys()
    for name, value in ref_attrs.items():
        assert got_attrs[name] == value, name
    assert validate_jetclass_shard(npz_path) == (300, 40)
    arrays, _ = read_shard(npz_path)
    for name, value in ref.items():
        np.testing.assert_array_equal(arrays[name], value, err_msg=name)


# --------------------------------------------------------- the evaluation


@pytest.fixture(scope="module")
def mbm_generated(tmp_path_factory):
    """The port's MBM experiment (config-mbm-test at N = 32, 10 timesteps)
    with the JAX Trainer's initial weights, its generated states, and the
    JAX config and jets of the same data seed."""
    seed = 3
    jax_cfg, cfg, jax_data, _ = jet_pair("mbm", seed=seed, batch_size=16, max_num_particles=32)
    jax_cfg.bridge.num_timesteps = cfg.bridge.num_timesteps = 10
    jax_data.preprocess()
    dm = JaxDataloader(jax_cfg, jax_data)
    jax_cfg = dm.update_config(jax_cfg)
    jax_model = JaxMBM(jax_cfg)
    jax_model.init = jax.jit(jax_model.init)  # one compile, where flax's eager init makes many
    jax_trainer = JaxTrainer(jax_model, jax_cfg, seed=seed)
    jax_trainer.setup(next(iter(dm.train)), len(dm.train))
    params = jax.tree_util.tree_map(np.asarray, jax_trainer.state.params)

    experiment = MultimodalBridgeMatchingExperiment(cfg, str(tmp_path_factory.mktemp("mbm")),
                                                    seed=seed, device="cpu")
    experiment.trainer.setup(len(experiment.datamodule.train))
    experiment.model.load_state_dict(params_from_flax(params, experiment.config))
    experiment.trainer.state.ema_params = None  # generate from the transplanted weights
    states = experiment.generate()
    return experiment, jax_cfg, jax_data, states


def test_evaluate_matches_jax_on_the_same_generated_state(mbm_generated):
    experiment, jax_cfg, jax_data, states = mbm_generated
    np.testing.assert_array_equal(experiment.datamodule.dataclass.target.continuous,
                                  jax_data.target.continuous)
    got = torch_evaluate.evaluate_experiment(experiment=experiment)
    jax_states = [JaxHybridState(time=s.time.numpy(), continuous=s.continuous.numpy(),
                                 discrete=s.discrete.numpy(), absorbing=s.absorbing.numpy())
                  for s in states]
    jax_experiment = SimpleNamespace(config=jax_cfg, generate=lambda: jax_states,
                                     datamodule=SimpleNamespace(dataclass=jax_data))
    ref = jax_evaluate.evaluate_experiment(experiment=jax_experiment)
    assert got.keys() == ref.keys() and len(ref) == 20
    for name, value in ref.items():
        if value is None:
            assert got[name] is None, name
        else:
            np.testing.assert_allclose(got[name], value, rtol=EVAL_RTOL, atol=0, err_msg=name)


def test_evaluate_reloads_a_run_directory_on_the_device_asked(mbm_generated, tmp_path):
    """From a run directory, as the CLI calls it: the experiment saved and
    reloaded on `device='cpu'` generates the same bits, so it scores what the
    experiment in memory scores."""
    experiment, _, _, _ = mbm_generated
    experiment.trainer.files = experiment.experiment_files
    experiment.trainer.save_checkpoint("best")
    out = tmp_path / "metrics.json"
    metrics = torch_evaluate.evaluate_experiment(
        experiment.experiment_files.experiment_dir, out_json=str(out), device="cpu", seed=3)
    assert out.is_file()
    assert metrics == torch_evaluate.evaluate_experiment(experiment=experiment)


# ------------------------------------------------------- the metric floors


def test_metric_floors_match_jax_on_the_same_cloud_and_indices():
    features = ["pt", "m", "eta", "phi", "multiplicity", "Q_total", "Q_jet", "tau21", "d2"]
    ref_cloud = jax_particles.ParticleClouds("AspenOpenJets", num_jets=100)
    cloud = particles.ParticleClouds("AspenOpenJets", num_jets=100)
    np.testing.assert_array_equal(cloud.continuous, ref_cloud.continuous)
    ref = jax_floors.bootstrap_floors(ref_cloud, jax_jets.JetClassHighLevelFeatures(ref_cloud),
                                      features, 256, 2, seed=5)
    got = floors.bootstrap_floors(cloud, jets.JetClassHighLevelFeatures(cloud), features, 256,
                                  2, seed=5)
    assert got == ref


# ------------------------------------------------------ the families' harness


def test_histogram_kl_and_w1_match_jax():
    rng = np.random.default_rng(0)
    a, b = rng.integers(1, 60, 500), rng.integers(5, 64, 300)
    assert quality._hist_kl(a, b, 0, 64) == jax_quality._hist_kl(a, b, 0, 64)
    x, y = rng.standard_normal(400), rng.standard_normal(250) + 0.3
    assert quality._w1(x, y) == jax_quality._w1(x, y)


@pytest.mark.parametrize("family", ["absorbing", "transdimensional"])
def test_family_harness_writes_every_key(family, tmp_path):
    out = tmp_path / "quality.json"
    argv = ["--family", family, "--epochs", "1", "--gen-jets", "24", "--gen-chunk", "16",
            "--sampler-steps", "3", "--device", "cpu", "--out", str(out)]
    if family == "transdimensional":
        argv.append("--skip-ref-mode")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny tensors; the suite's workers share the cores
    try:
        result = quality.main(argv)
    finally:
        torch.set_num_threads(threads)
    assert out.is_file()
    if family == "absorbing":
        assert ABSORBING_KEYS <= result.keys()
        assert result["metrics"].keys() == feature_keys(ABSORBING_FEATURES)
        assert result["mask_dynamics"].keys() == MASK_KEYS
        assert result["predict_calls"] == 2  # 24 jets in chunks of 16
    else:
        assert TRANSDIM_KEYS <= result.keys()
        assert result["metrics"].keys() == TRANSDIM_METRICS
        assert result["physics_metrics"].keys() == (feature_keys(TRANSDIM_FEATURES)
                                                    | {"scored_jet_fraction"})
        assert result["predict_calls"] == 1  # the template, a batch of 28 jets, covers 24
    assert result["gen_jets"] == 24 and result["device"] == "cpu"
    assert result["final_train_loss"] is not None
