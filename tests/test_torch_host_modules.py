"""The port's host-side modules against the JAX package's on the CPU:
`utils/tensor_operations.py`, `utils/experiment_configs.py`,
`utils/callbacks.py` with the Trainer's MLflow branch,
`data/transdimensional_base.py`, and the plots of `ParticleClouds` and
`JetClassHighLevelFeatures` under matplotlib's Agg backend.

The deterministic helpers must equal JAX's to float32 rounding (rtol 1e-6,
atol 1e-6); the samplers, which draw from a generator where JAX takes a key,
by what they must keep (masked entries 0, the centre of mass 0 to 1e-5).
Configs, JSONL lines, grids and the plots' drawn data must be equal.
"""

import json
import sys
import types

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch
import yaml

from multimodal_particles_tpu.data import transdimensional_base as jax_base
from multimodal_particles_tpu.data.particle_clouds import jets as jax_jets
from multimodal_particles_tpu.data.particle_clouds import particles as jax_particles
from multimodal_particles_tpu.utils import callbacks as jax_callbacks
from multimodal_particles_tpu.utils import experiment_configs as jax_configs
from multimodal_particles_tpu.utils import tensor_operations as jax_ops
from multimodal_particles_tpu_torch.data import transdimensional_base as base
from multimodal_particles_tpu_torch.data.particle_clouds import jets, particles
from multimodal_particles_tpu_torch.training.trainer import Trainer
from multimodal_particles_tpu_torch.utils import callbacks, experiment_configs
from multimodal_particles_tpu_torch.utils import tensor_operations as ops

matplotlib.use("Agg")

B, N, F = 5, 7, 3


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, F)).astype(np.float32)
    dims = rng.integers(0, N + 1, B).astype(np.int32)
    dims[0] = 0
    node_mask = (np.arange(N)[None, :, None] < dims[:, None, None]).astype(np.float32)
    return x, dims, node_mask


# ------------------------------------------------------- tensor_operations


@pytest.mark.parametrize("name", ["remove_mean", "remove_mean_with_mask",
                                  "create_and_apply_mask_3", "create_and_apply_mask_2"])
def test_deterministic_helpers_match_jax(name):
    x, dims, node_mask = _inputs()
    args = {
        "remove_mean": (x,),
        "remove_mean_with_mask": (x * node_mask, node_mask),
        "create_and_apply_mask_3": (x, dims),
        "create_and_apply_mask_2": (x[..., 0], dims),
    }[name]
    got = getattr(ops, name)(*(torch.from_numpy(a) for a in args))
    ref = getattr(jax_ops, name)(*(jnp.asarray(a) for a in args))
    got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


def test_masked_samplers_take_a_generator():
    _, _, node_mask = _inputs()
    mask = torch.from_numpy(node_mask)
    a = ops.sample_gaussian_with_mask(torch.Generator().manual_seed(1), (B, N, F), mask)
    b = ops.sample_gaussian_with_mask(torch.Generator().manual_seed(1), (B, N, F), mask)
    assert torch.equal(a, b) and (a[mask.expand_as(a) == 0] == 0).all() and a.abs().max() > 0
    c = ops.sample_center_gravity_zero_gaussian_with_mask(torch.Generator().manual_seed(2),
                                                          (B, N, F), mask)
    ops.assert_mean_zero_with_mask(c, mask)
    assert (c.sum(dim=1).abs() <= 1e-5).all()
    ref = jax_ops.sample_center_gravity_zero_gaussian_with_mask(jax.random.PRNGKey(0), (B, N, F),
                                                               jnp.asarray(node_mask))
    jax_ops.assert_mean_zero_with_mask(ref, node_mask)  # both keep the same invariants
    with pytest.raises(ValueError):
        ops.sample_center_gravity_zero_gaussian_with_mask(None, (B, N), mask[..., 0])


def test_mask_assertions():
    x, _, node_mask = _inputs()
    masked = torch.from_numpy(x * node_mask)
    ops.check_mask_correct([masked, torch.zeros(0)], torch.from_numpy(node_mask))
    with pytest.raises(AssertionError, match="not masked"):
        ops.assert_correctly_masked(torch.from_numpy(x), torch.from_numpy(node_mask))
    with pytest.raises(AssertionError, match="Mean is not zero"):
        ops.assert_mean_zero_with_mask(masked + torch.from_numpy(node_mask),
                                       torch.from_numpy(node_mask))


# ------------------------------------------------------ experiment_configs


NESTED = {
    "experiment": {"type": "mbm", "experiment_name": None},
    "data": {"target": {"name": "AspenOpenJets", "path": ["a.npz"]}, "max_num_particles": 128},
    "encoder": {"name": "EPiC", "dims": [16, 16], "options": {"skip": True}},
    "train": {"epochs": 3, "lr": 1e-3},
}


def test_nested_configs_match_jax(tmp_path):
    path = tmp_path / "nested.yaml"
    path.write_text(yaml.safe_dump(NESTED))
    got, ref = experiment_configs.Configs(str(path)), jax_configs.Configs(str(path))
    assert got.experiment.experiment_name == ref.experiment.experiment_name == "mbm_AspenOpenJets"
    got.experiment.experiment_indentifier = ref.experiment.experiment_indentifier = "run"
    assert got.to_dict() == ref.to_dict()
    assert got.encoder.options.skip is True and got.data.target.path == ["a.npz"]
    got.save(tmp_path / "saved.yaml")
    assert experiment_configs.load_config(tmp_path / "saved.yaml").to_dict() == got.to_dict()
    ns = experiment_configs.yaml_to_namespace(NESTED)
    assert experiment_configs.namespace_to_dict(ns) == jax_configs.namespace_to_dict(
        jax_configs.yaml_to_namespace(NESTED)) == NESTED

    class Logger:
        def log_params(self, flat):
            self.flat = flat

    logger = Logger()
    assert got.log_config(logger) == ref.log_config(Logger()) == logger.flat
    assert logger.flat["encoder.options.skip"] is True
    with pytest.raises(ValueError):
        experiment_configs.Configs(["not", "a", "dict"])


# --------------------------------------------------------------- callbacks


def test_jsonl_callback_writes_jax_lines(tmp_path):
    records = [{"epoch": 0, "train_loss": 1.5, "val_loss": None}, {"step": 3, "lr": 1e-3}]
    got, ref = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    for r in records:
        callbacks.JSONLMetricsCallback(str(got)).log(r)
        jax_callbacks.JSONLMetricsCallback(str(ref)).log(r)
    assert got.read_text() == ref.read_text()
    assert [json.loads(line) for line in got.read_text().splitlines()] == records


class FakeMlflow(types.ModuleType):
    """An mlflow stand-in that records what it is given."""

    def __init__(self, active=True):
        super().__init__("mlflow")
        self.active, self.metrics, self.artifacts, self.uri = active, [], [], None

    def active_run(self):
        return object() if self.active else None

    def log_metrics(self, metrics, step):
        self.metrics.append((metrics, step))

    def log_artifacts(self, path, artifact_path):
        self.artifacts.append((path, artifact_path))

    def set_tracking_uri(self, uri):
        self.uri = uri


def _trainer_stub(files):
    stub = Trainer.__new__(Trainer)
    stub.files = files
    return stub


def test_mlflow_paths(tmp_path, monkeypatch):
    """Without mlflow both callbacks return None and the Trainer logs its
    JSONL only; with a run active the Trainer sends a record's numbers and the
    callback the best checkpoint directory."""
    files = types.SimpleNamespace(metrics_file=str(tmp_path / "metrics.jsonl"),
                                  checkpoint_path=lambda tag: str(tmp_path / tag))
    (tmp_path / "best").mkdir()
    monkeypatch.setitem(sys.modules, "mlflow", None)  # import raises ImportError
    trainer = _trainer_stub(files)
    assert callbacks.MLflowCallback().on_train_end(trainer) is None
    assert jax_callbacks.MLflowCallback().on_train_end(trainer) is None
    record = {"epoch": 1, "step": 8, "train_loss": 0.5, "note": "text", "val_loss": None}
    trainer._log_metrics(record)
    assert json.loads((tmp_path / "metrics.jsonl").read_text()) == record

    fake = FakeMlflow()
    monkeypatch.setitem(sys.modules, "mlflow", fake)
    trainer._log_metrics(record)
    assert fake.metrics == [({"epoch": 1, "step": 8, "train_loss": 0.5}, 8)]
    assert callbacks.MLflowCallback("file:/runs").on_train_end(trainer) == str(tmp_path / "best")
    assert fake.artifacts == [(str(tmp_path / "best"), "checkpoints/best")]
    assert fake.uri == "file:/runs"
    fake.active = False
    trainer._log_metrics(record)
    assert len(fake.metrics) == 1
    assert callbacks.MLflowCallback().on_train_end(_trainer_stub(None)) is None


# --------------------------------------------------- transdimensional_base


def test_transdimensional_bases_and_gridify_match_jax():
    for cls in (base.StructuredDatasetBase, base.GraphicalStructureBase):
        assert [n for n in vars(cls) if not n.startswith("__")] == [
            n for n in vars(getattr(jax_base, cls.__name__)) if not n.startswith("__")]
    with pytest.raises(NotImplementedError):
        base.StructuredDatasetBase().get_data_dim()
    base.StructuredDatasetBase().log_batch(None)  # no wandb: nothing happens
    structure = base.GraphicalStructureBase()
    assert structure.adjust_st_batch(None) is None
    with pytest.raises(NotImplementedError):
        structure.shapes_with_onehot()
    images = [np.full((2, 3, 4), i, np.float32) for i in range(7)]
    np.testing.assert_array_equal(base.gridify_images(images), jax_base.gridify_images(images))


# -------------------------------------------------------------------- plots


SHARD = dict(dataset="AspenOpenJets", max_num_particles=30, num_jets=40)


def _drawn(ax):
    """What an Axes drew: each patch's path vertices and each collection's
    offsets and sizes."""
    patches = [p.get_path().vertices.copy() for p in ax.patches]
    points = [(c.get_offsets().copy(), np.asarray(c.get_sizes()).copy()) for c in ax.collections]
    return patches, points


def _assert_same_drawing(got, ref):
    (gp, gc), (rp, rc) = _drawn(got), _drawn(ref)
    assert len(gp) == len(rp) and len(gc) == len(rc) and (gp or gc)
    for a, b in zip(gp, rp):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    for (ao, asz), (bo, bsz) in zip(gc, rc):
        np.testing.assert_allclose(ao, bo, rtol=1e-6)
        np.testing.assert_allclose(asz, bsz, rtol=1e-6)
    assert got.get_xlabel() == ref.get_xlabel()


@pytest.mark.parametrize("plot", ["histplot", "histplot_idx", "display_cloud"])
def test_particle_cloud_plots_match_jax(plot):
    import matplotlib.pyplot as plt

    got, ref = particles.ParticleClouds(**SHARD), jax_particles.ParticleClouds(**SHARD)
    call = {"histplot": lambda c: c.histplot("eta_rel", bins=20),
            "histplot_idx": lambda c: c.histplot("pt", idx=0, bins=10, xlabel="leading pt"),
            "display_cloud": lambda c: c.display_cloud(3, scale_marker=0.5)}[plot]
    try:
        _assert_same_drawing(call(got), call(ref))
    finally:
        plt.close("all")


@pytest.mark.parametrize("plot", ["multiplicities", "multiplicities_of_states", "flavor_fractions",
                                  "histplot"])
def test_jet_plots_match_jax(plot):
    import matplotlib.pyplot as plt

    got = jets.JetClassHighLevelFeatures(particles.ParticleClouds(**SHARD),
                                         compute_substructure=False)
    ref = jax_jets.JetClassHighLevelFeatures(jax_particles.ParticleClouds(**SHARD),
                                             compute_substructure=False)
    call = {"multiplicities": lambda j: j.histplot_multiplicities(xlabel="n"),
            "multiplicities_of_states": lambda j: j.histplot_multiplicities(state=[0, 1]),
            "flavor_fractions": lambda j: j.flavor_fractions(),
            "histplot": lambda j: j.histplot("m", bins=15)}[plot]
    try:
        _assert_same_drawing(call(got), call(ref))
    finally:
        plt.close("all")
