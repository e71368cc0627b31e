"""The port's jet data pipeline against the JAX package's on the CPU: the
`.npz` shards against their `.h5`, the readers, `ParticleClouds` (every
source, the bridge-state branch), `JetDataclass.preprocess()` /
`postprocess()` and the stats, the loaders' batches in order for both return
types, and `JetClassHighLevelFeatures`' observables, `KLmetric1D` and
`Wassertein1D`.

Both packages compute in numpy: arrays and stats must be equal exactly; the
port's batch tensors equal JAX's numpy batches cast to their dtype (float32,
as JAX puts them on the device); observables and metrics within rtol 1e-6
(the JAX package computes substructure with its C++ library, which its own
tests hold to the numpy version at rtol 1e-6; the port has the numpy
version), plus 1e-12 absolute for observables that are 0 to rounding.
"""

import os
import sys

import h5py
import numpy as np
import pytest
import torch

from multimodal_particles_tpu.data.particle_clouds import jets as jax_jets
from multimodal_particles_tpu.data.particle_clouds import jets_dataloader as jax_loader
from multimodal_particles_tpu.data.particle_clouds import particles as jax_particles
from multimodal_particles_tpu.data.particle_clouds import utils as jax_utils
from multimodal_particles_tpu.models.generative.states import (
    AbsorbingBridgeState as JaxAbsorbingState,
)
from multimodal_particles_tpu.models.generative.states import HybridState as JaxHybridState
from multimodal_particles_tpu_torch.data import MultimodalDatabatch
from multimodal_particles_tpu_torch.data.particle_clouds import jets, particles, utils
from multimodal_particles_tpu_torch.data.particle_clouds.jets_dataloader import (
    JetsDataloaderModule,
)
from multimodal_particles_tpu_torch.models.generative.states import (
    AbsorbingBridgeState,
    HybridState,
)
from torch_port_helpers import assert_batch_equals, jet_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "resources", "data")
AOJ_H5 = os.path.join(DATA, "2016H_job0_mini.h5")
JETCLASS_H5 = os.path.join(DATA, "jetclass_mini.h5")
RTOL = 1e-6
ATOL = 1e-12  # τ3 of a jet of three particles is 0 in C++ and 2e-16 in numpy
FEATURES = ("pt", "eta", "phi", "m", "multiplicity", "Q_total", "Q_jet",
            "tau1", "tau2", "tau3", "tau21", "tau32", "d2")


def assert_same_arrays(got, ref, name):
    assert got.dtype == ref.dtype, (name, got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref, err_msg=name)


def assert_same_clouds(got, ref):
    for name in ("continuous", "discrete", "mask", "multiplicity", "pt", "eta_rel", "phi_rel"):
        assert hasattr(got, name) == hasattr(ref, name), name
        if hasattr(ref, name):
            assert_same_arrays(getattr(got, name), getattr(ref, name), name)


# ------------------------------------------------------------------ shards


@pytest.mark.parametrize("h5_path", [AOJ_H5, JETCLASS_H5], ids=["aoj", "jetclass"])
def test_npz_shard_equals_its_h5(h5_path):
    """Each committed .npz holds its .h5's datasets unchanged, name by name,
    and the .h5's attributes as attr.<name> entries."""
    with np.load(h5_path[:-3] + ".npz") as npz, h5py.File(h5_path, "r") as h5:
        datasets = [k for k in npz.files if not k.startswith(utils.ATTR_PREFIX)]
        assert sorted(datasets) == sorted(h5)
        for name in datasets:
            assert_same_arrays(npz[name], h5[name][()], name)
        attrs = {k[len(utils.ATTR_PREFIX):]: npz[k][()] for k in npz.files
                 if k.startswith(utils.ATTR_PREFIX)}
        assert attrs.keys() == set(h5.attrs)
        for name, value in h5.attrs.items():
            assert attrs[name] == value, name


def test_h5_reader_names_the_converter_without_h5py(monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="shards_to_npz.py"):
        utils.read_shard(AOJ_H5)
    with pytest.raises(ValueError, match="expected a .npz or a .h5"):
        utils.read_shard(AOJ_H5[:-3] + ".root")


@pytest.mark.parametrize("suffix", [".npz", ".h5"])
def test_readers_match_jax(suffix):
    ref = jax_utils.read_aoj_file(AOJ_H5)
    got = utils.read_aoj_file(AOJ_H5[:-3] + suffix)
    assert got.keys() == ref.keys()
    for name in ref:
        assert_same_arrays(got[name], ref[name], name)
    ref = jax_utils.read_jetclass_h5(JETCLASS_H5)
    got = utils.read_jetclass_shard(JETCLASS_H5[:-3] + suffix)
    for name in ref:
        assert_same_arrays(got[name], ref[name], name)
    assert utils.validate_jetclass_shard(JETCLASS_H5[:-3] + suffix) == \
        jax_utils.validate_jetclass_h5(JETCLASS_H5)


def test_codec_and_histograms_match_jax():
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 8, (7, 9, 1))
    flavor, charge = utils.tokens_to_physics(tokens)
    ref_flavor, ref_charge = jax_utils.tokens_to_physics(tokens)
    assert_same_arrays(flavor, ref_flavor, "flavor")
    assert_same_arrays(charge, ref_charge, "charge")
    assert_same_arrays(utils.physics_to_onehot(flavor, charge[..., 0]),
                       jax_utils.physics_to_onehot(ref_flavor, ref_charge[..., 0]), "onehot")
    sizes = rng.integers(0, 40, 300)
    assert utils.sizes_to_histograms(sizes) == jax_utils.sizes_to_histograms(sizes)


# ---------------------------------------------------------- ParticleClouds


SOURCES = {
    "aoj": dict(dataset="AspenOpenJets", max_num_particles=128, fill_target_with_noise=True),
    "aoj_clipped": dict(dataset="AspenOpenJets", max_num_particles=30, min_num_particles=5,
                        num_jets=70),
    "jetclass": dict(dataset="JetClass", data_paths=[JETCLASS_H5], max_num_particles=32,
                     fill_target_with_noise=True),
    "gauss": dict(dataset="GaussNoise", num_jets=50, max_num_particles=24, min_num_particles=0,
                  target_multiplicity=np.arange(1, 25)),
    "beta": dict(dataset="BetaNoise", num_jets=20, max_num_particles=12, min_num_particles=12),
}


@pytest.mark.parametrize("source", list(SOURCES))
def test_particle_clouds_preprocess_postprocess_and_stats_match_jax(source):
    kwargs = dict(SOURCES[source], seed=11)
    port_kwargs = dict(kwargs)
    if source == "jetclass":
        port_kwargs["data_paths"] = [JETCLASS_H5[:-3] + ".npz"]
    ref = jax_particles.ParticleClouds(**kwargs)
    got = particles.ParticleClouds(**port_kwargs)
    assert_same_clouds(got, ref)
    assert got.summary_stats() == ref.summary_stats()
    for output_discrete in ("tokens", "onehot_dequantize"):
        ref = jax_particles.ParticleClouds(**kwargs)
        got = particles.ParticleClouds(**port_kwargs)
        ref.preprocess(output_discrete=output_discrete)
        got.preprocess(output_discrete=output_discrete)
        assert got.stats == ref.stats
        assert_same_clouds(got, ref)
        if output_discrete == "tokens":
            ref.postprocess(input_discrete=output_discrete)
            got.postprocess(input_discrete=output_discrete)
            assert_same_clouds(got, ref)


def test_default_aoj_shard_is_the_npz():
    assert particles.AOJ_DEFAULT_PATH.endswith("2016H_job0_mini.npz")
    assert_same_clouds(particles.ParticleClouds("AspenOpenJets"),
                       jax_particles.ParticleClouds("AspenOpenJets"))


def test_bridge_state_branch_takes_the_port_states():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 7, 3)).astype(np.float32)
    k = rng.integers(0, 8, (5, 7, 1))
    m = (rng.random((5, 7, 1)) < 0.7).astype(np.float32)
    stats = {"mean": [1.0, 0.5, -0.5], "std": [2.0, 1.0, 0.5]}
    pairs = [
        (HybridState(None, torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(m)),
         JaxHybridState(None, x, k, m)),
        (AbsorbingBridgeState(None, torch.from_numpy(x), torch.from_numpy(k),
                              torch.from_numpy(m).long()),
         JaxAbsorbingState(None, x, k, m.astype(np.int64))),
    ]
    for state, jax_state in pairs:
        got, ref = particles.ParticleClouds(state), jax_particles.ParticleClouds(jax_state)
        assert_same_clouds(got, ref)
        got.postprocess(stats=stats)
        ref.postprocess(stats=stats)
        assert_same_clouds(got, ref)
    got = particles.ParticleClouds(torch.from_numpy(np.concatenate([x, m], -1)))
    assert_same_clouds(got, jax_particles.ParticleClouds(np.concatenate([x, m], -1)))


# ------------------------------------------------------------ JetDataclass


@pytest.mark.parametrize("target", ["AspenOpenJets", "JetClass"])
def test_jet_dataclass_preprocess_postprocess_match_jax(target):
    data = {} if target == "AspenOpenJets" else dict(
        target_name="JetClass", target_path=[JETCLASS_H5], max_num_particles=40)
    jax_cfg, cfg, ref, got = jet_pair("mbm", **data)
    if target == "JetClass":  # the port reads the same arrays from the .npz
        cfg.data.target_path = [JETCLASS_H5[:-3] + ".npz"]
        got = jets.JetDataclass(cfg, seed=4)
    for side in ("source", "target"):
        assert_same_clouds(getattr(got, side), getattr(ref, side))
    ref.preprocess()
    got.preprocess()
    assert cfg.data.source_preprocess_stats == jax_cfg.data.source_preprocess_stats
    assert cfg.data.target_preprocess_stats == jax_cfg.data.target_preprocess_stats
    for side in ("source", "target"):
        assert_same_clouds(getattr(got, side), getattr(ref, side))
    ref.postprocess()
    got.postprocess()
    for side in ("source", "target"):
        assert_same_clouds(getattr(got, side), getattr(ref, side))


# ----------------------------------------------------------------- loaders


@pytest.mark.parametrize("family", ["mbm", "absorbing", "transdim"])
def test_loaders_yield_jax_batches_in_jax_order(family):
    data = dict(batch_size=16) if family == "absorbing" else {}
    jax_cfg, cfg, ref_jets, got_jets = jet_pair(family, **data)
    ref_jets.preprocess()
    got_jets.preprocess()
    ref = jax_loader.JetsDataloaderModule(jax_cfg, ref_jets)
    got = JetsDataloaderModule(cfg, got_jets, device="cpu")
    assert got.histogram_target == ref.histogram_target
    assert len(got.train) == len(ref.train) and len(got.valid) == len(ref.valid)
    assert got.test is None and ref.test is None
    for _ in range(2):  # the training order reshuffles each epoch, as JAX's does
        batches = 0
        for g, r in zip(got.train, ref.train):
            assert_batch_equals(g, r)
            batches += 1
        assert batches == len(ref.train)
    for g, r in zip(got.valid, ref.valid):
        assert_batch_equals(g, r)
    assert_batch_equals(got.dataset[3], ref.dataset[3])
    assert got.dataset.get_available_keys() == ref.dataset.get_available_keys()
    if family == "transdim":
        assert got.names_in_batch == ref.names_in_batch
        assert got.with_onehot_shapes == ref.with_onehot_shapes
        assert got.without_onehot_shapes == ref.without_onehot_shapes
        for name in ("observed", "is_onehot", "exist"):
            np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
        nodes, ref_nodes = got.graphical_structure.nodes_dist, ref.graphical_structure.nodes_dist
        np.testing.assert_array_equal(nodes.n_nodes, ref_nodes.n_nodes)
        np.testing.assert_allclose(nodes.probs, ref_nodes.probs, rtol=1e-7)
    else:
        assert got.histogram_source == ref.histogram_source
        got.update_config(cfg)
        ref.update_config(jax_cfg)
        assert cfg.data.target_info == jax_cfg.data.target_info
        assert cfg.data.source_info == jax_cfg.data.source_info


def test_loader_gathers_on_the_device_without_copying_the_dataset():
    """The dataset's tensors are made once; a batch is a gather from them."""
    _, cfg, _, got_jets = jet_pair("mbm")
    got_jets.preprocess()
    dm = JetsDataloaderModule(cfg, got_jets, device="cpu")
    ptrs = {k: t.data_ptr() for k, t in dm.dataset.tensors.items()}
    assert all(t.shape[0] == 100 for t in dm.dataset.tensors.values())
    for _ in range(2):
        for batch in dm.train:
            assert batch.source_continuous.dtype == torch.float32
            assert batch.target_discrete.dtype == torch.int64
    assert {k: t.data_ptr() for k, t in dm.dataset.tensors.items()} == ptrs
    with pytest.raises(TypeError):
        JetsDataloaderModule(cfg, got_jets)  # the device is explicit


# ------------------------------------------------------------- observables


@pytest.mark.parametrize("source", ["aoj", "jetclass", "gauss"])
def test_high_level_features_and_metrics_match_jax(source):
    kwargs = dict(SOURCES[source], seed=3)
    port_kwargs = dict(kwargs)
    if source == "jetclass":
        port_kwargs["data_paths"] = [JETCLASS_H5[:-3] + ".npz"]
    ref = jax_jets.JetClassHighLevelFeatures(jax_particles.ParticleClouds(**kwargs))
    got = jets.JetClassHighLevelFeatures(particles.ParticleClouds(**port_kwargs))
    for name in FEATURES:
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(got.substructure_selection, ref.substructure_selection)
    # the metrics against another sample of the same source
    other = dict(kwargs, seed=4)
    ref_other = jax_jets.JetClassHighLevelFeatures(jax_particles.ParticleClouds(**other))
    port_other = dict(port_kwargs, seed=4)
    got_other = jets.JetClassHighLevelFeatures(particles.ParticleClouds(**port_other))
    for name in ("pt", "m", "eta", "multiplicity", "tau21", "d2"):
        for metric in ("KLmetric1D", "Wassertein1D"):
            np.testing.assert_allclose(getattr(got, metric)(name, got_other),
                                       getattr(ref, metric)(name, ref_other), rtol=RTOL,
                                       atol=0, err_msg=f"{metric} {name}")
