"""The port's mesh helpers and Megatron rules in one process, against the JAX
package's (multimodal_particles_tpu/parallel/mesh.py, tp.py) on the CPU:

  * `pad_to_multiple` gives JAX's arrays exactly, on tensors and on numpy,
    on the cases of tests/test_parallel/test_trainer.py:41-66;
  * `shard_batch` gives each data rank its block of rows;
  * without a process group the mesh has one rank;
  * `tp_param_specs` splits the same leaves along the same dimension as JAX's
    for the three families, matched through the transplant's name map and
    compared in JAX's (in, out) layout;
  * 'shard_map' with tensor parallelism raises JAX's ValueError;
  * a one-rank gloo process group gives the plain trainer's bits.
"""

import dataclasses
import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from multimodal_particles_tpu.config_classes import AbsorbingConfig as JaxAbsorbingConfig
from multimodal_particles_tpu.config_classes.transdimensional_unconditional_config import (
    TransdimensionalEpicConfig as JaxTransdimConfig,
)
from multimodal_particles_tpu.data.particle_clouds.jets_dataloader import JetsDataloaderModule
from multimodal_particles_tpu.models.generative.absorbing.absorbing_flows import (
    AbsorbingFlow as JaxAbsorbingFlow,
)
from multimodal_particles_tpu.models.generative.multimodal_bridge_matching import (
    MultiModalBridgeMatching as JaxMBM,
)
from multimodal_particles_tpu.models.generative.transdimensional.structure import (
    StructuredState as JaxStructuredState,
)
from multimodal_particles_tpu.models.generative.transdimensional.transdimensional_model import (
    TransdimensionalJumpDiffusion as JaxTransdim,
)
from multimodal_particles_tpu.parallel import mesh as jax_mesh_module
from multimodal_particles_tpu.parallel.tp import tp_param_specs as jax_tp_param_specs
from multimodal_particles_tpu_torch.config_classes import (
    AbsorbingConfig,
    MultimodalBridgeMatchingConfig,
    TransdimensionalEpicConfig,
)
from multimodal_particles_tpu_torch.data import synthetic_training_batch
from multimodal_particles_tpu_torch.models.generative.absorbing.absorbing_flows import (
    AbsorbingFlow,
)
from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (
    MultiModalBridgeMatching,
)
from multimodal_particles_tpu_torch.models.generative.transdimensional.transdimensional_model import (
    TransdimensionalJumpDiffusion,
)
from multimodal_particles_tpu_torch.parallel import (
    batch_sharding,
    make_device_mesh,
    pad_to_multiple,
    replicated_sharding,
    shard_batch,
)
from multimodal_particles_tpu_torch.parallel.mesh import LocalMesh, init_from_env, mesh_shape
from multimodal_particles_tpu_torch.parallel.tp import _shard_dim, tp_param_specs
from multimodal_particles_tpu_torch.training.trainer import Trainer
from multimodal_particles_tpu_torch.utils.transplant import _flatten, _target_key
from torch_port_helpers import jax_config, port_batch, transdim_list_batch


@dataclasses.dataclass
class FakeMesh:
    """A (data, model) mesh without a process group: this rank's coordinate."""

    data: int
    model: int
    data_index: int = 0
    mesh_dim_names: tuple = ("data", "model")

    def size(self, mesh_dim=None):
        return (self.data, self.model)[mesh_dim]

    def get_local_rank(self, mesh_dim=None):
        return self.data_index if mesh_dim == "data" else 0

    def get_group(self, mesh_dim=None):
        return None


def _jax_batch(rows=16):
    cfg = jax_config()
    cfg.data.batch_size = 16
    batch = JetsDataloaderModule.random_databatch(cfg)
    return type(batch)(*[None if v is None else np.asarray(v)[:rows] for v in batch])


def _as(kind, batch):
    """A JAX batch as the port's batch of tensors, or as a dict of numpy."""
    if kind == "tensor":
        return port_batch(batch)
    return {k: v for k, v in batch._asdict().items() if v is not None}


def _fields(batch):
    if isinstance(batch, dict):
        return batch
    return {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)
            if getattr(batch, f.name) is not None}


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
@pytest.mark.parametrize("rows", [16, 13])
def test_pad_to_multiple_matches_jax(kind, rows):
    batch = _jax_batch(rows)
    ref, ref_size = jax_mesh_module.pad_to_multiple(batch, 8)
    got, size = pad_to_multiple(_as(kind, batch), 8)
    assert size == ref_size == rows
    for name, value in _fields(got).items():
        assert isinstance(value, torch.Tensor if kind == "tensor" else np.ndarray)
        np.testing.assert_array_equal(np.asarray(value), np.asarray(getattr(ref, name)))
        assert value.shape[0] == 16


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_pad_to_multiple_ragged_context_matches_jax(kind):
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((13, 4)), "y": rng.standard_normal((13,)),
             "global_context": rng.standard_normal((1, 8)), "scale": np.float32(2.0)}
    ref, ref_size = jax_mesh_module.pad_to_multiple(batch, 8)
    ours = {k: torch.from_numpy(v) if kind == "tensor" and np.ndim(v) else v
            for k, v in batch.items()}
    got, size = pad_to_multiple(ours, 8)
    assert size == ref_size == 13
    for name in batch:
        np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(ref[name]))
    assert got["global_context"].shape == (1, 8) and np.shape(got["scale"]) == ()


@pytest.mark.parametrize("data_index", [0, 1])
def test_shard_batch_gives_each_rank_its_rows(data_index):
    """The padded 13-jet batch over 2 data ranks: rank r holds rows
    [8r, 8r + 8), numpy leaves become tensors, a context of another leading
    size passes whole; the transdim 'list' batch likewise."""
    mesh = FakeMesh(data=2, model=1, data_index=data_index)
    batch, _ = pad_to_multiple(_as("numpy", _jax_batch(13)), 8)
    batch["context"] = np.ones((1, 3), np.float32)
    rows = shard_batch(batch, mesh)
    for name, value in batch.items():
        want = value if name == "context" else value[8 * data_index:8 * data_index + 8]
        assert isinstance(rows[name], torch.Tensor)
        np.testing.assert_array_equal(rows[name].numpy(), want)
    listed, _ = pad_to_multiple([torch.from_numpy(a) for a in transdim_list_batch(0, 13, 16)], 2)
    for got, whole in zip(shard_batch(listed, mesh), listed):
        assert torch.equal(got, whole[7 * data_index:7 * data_index + 7])
    with pytest.raises(ValueError, match="pad it first"):
        shard_batch(_as("numpy", _jax_batch(13)), mesh)


def test_one_rank_mesh_without_a_process_group():
    assert not dist.is_initialized() and not init_from_env()
    mesh = make_device_mesh()
    assert isinstance(mesh, LocalMesh) and mesh_shape(mesh) == {"data": 1, "model": 1}
    assert batch_sharding(mesh) == (Shard(0),) and replicated_sharding(mesh) == (Replicate(),)
    with pytest.raises(ValueError, match="process group"):
        make_device_mesh(data_axis=2)


def _family(family):
    """(JAX model, its example input, the port's twin) at N = 16 slots."""
    if family == "mbm":
        cfg = jax_config()
        batch = jax.tree_util.tree_map(jnp.asarray, JetsDataloaderModule.random_databatch(cfg))
        return JaxMBM(cfg), batch, MultiModalBridgeMatching(
            MultimodalBridgeMatchingConfig.from_dict(cfg.to_dict()))
    if family == "absorbing":
        cfg = JaxAbsorbingConfig()
        cfg.data.batch_size, cfg.data.max_num_particles = 8, 16
        batch = jax.tree_util.tree_map(jnp.asarray, JetsDataloaderModule.random_databatch(cfg))
        return JaxAbsorbingFlow(cfg), batch, AbsorbingFlow(AbsorbingConfig.from_dict(cfg.to_dict()))
    cfg = JaxTransdimConfig()
    cfg.data.batch_size, cfg.data.max_num_particles = 8, 16
    dims, x, one_hot = transdim_list_batch(0, 8, 16)
    state = JaxStructuredState(continuous=jnp.asarray(x), discrete=jnp.asarray(one_hot),
                               dims=jnp.asarray(dims))
    return JaxTransdim(cfg), state, TransdimensionalJumpDiffusion(
        TransdimensionalEpicConfig.from_dict(cfg.to_dict()))


def _jax_dim(spec):
    split = [i for i, axis in enumerate(spec) if axis == "model"]
    return split[0] if split else None


@pytest.mark.parametrize("family", ["mbm", "absorbing", "transdimensional"])
def test_tp_param_specs_match_jax(family):
    jax_model, example, model = _family(family)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), example)
    jax_specs = jax_tp_param_specs(shapes, jax_mesh_module.make_device_mesh(model_axis=2))
    flat = {jax.tree_util.keystr(p).replace("']['", ".").strip("[]'"): s
            for p, s in jax.tree_util.tree_flatten_with_path(
                jax_specs, is_leaf=lambda s: isinstance(s, P))[0]}
    specs = tp_param_specs(model, FakeMesh(data=1, model=2))
    assert len(flat) == len(specs)
    split = 0
    for path, spec in flat.items():
        name, transposed = _target_key(path)
        placement = specs[name][0]
        dim = placement.dim if isinstance(placement, Shard) else None
        if dim is not None and transposed and model.get_parameter(name).dim() == 2:
            dim = 1 - dim  # the port's (out, in) read in flax's (in, out)
        assert dim == _jax_dim(spec), (path, spec, placement)
        split += dim is not None
    assert split >= {"mbm": 16, "absorbing": 16, "transdimensional": 64}[family]
    assert set(_flatten(jax.tree_util.tree_map(lambda s: np.zeros(s.shape), shapes))) == set(flat)


def test_tp_indivisible_dims_stay_replicated():
    assert _shard_dim("a.fc_local1.v", (3, 8), 2) is None
    assert _shard_dim("a.fc_local2.v", (8, 3), 2) is None
    assert _shard_dim("a.fc_local1.v", (8, 3), 2) == 0
    assert _shard_dim("a.fc_local2.g", (8,), 2) is None
    assert _shard_dim("network.res_block_0.conv1.weight", (8, 8), 2) is None


def test_tp_rejects_shard_map_mode():
    config = MultimodalBridgeMatchingConfig.from_dict(jax_config().to_dict())
    config.parallel.model_axis, config.parallel.spmd_mode = 2, "shard_map"
    trainer = Trainer(MultiModalBridgeMatching(config), config, mesh=FakeMesh(data=1, model=2))
    with pytest.raises(ValueError, match="shard_map"):
        trainer.setup()


def _three_steps(mesh):
    config = MultimodalBridgeMatchingConfig.from_dict(jax_config().to_dict())
    config.train.gradient_clip_val = 1.0
    trainer = Trainer(MultiModalBridgeMatching(config), config, seed=0, mesh=mesh)
    trainer.setup()
    batch = synthetic_training_batch(8, 16, 3, 8, torch.Generator().manual_seed(1))
    losses = [trainer.train_step(trainer.shard(batch)[0])["loss"] for _ in range(3)]
    return losses, {k: p.detach().clone() for k, p in trainer.state.params.items()}


def test_one_rank_gloo_trainer_gives_the_plain_bits(tmp_path):
    plain = _three_steps(None)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=30))
    try:
        mesh = make_device_mesh(device_type="cpu")
        assert not isinstance(mesh, LocalMesh) and mesh_shape(mesh) == {"data": 1, "model": 1}
        gloo = _three_steps(mesh)
    finally:
        dist.destroy_process_group()
    assert all(torch.equal(a, b) for a, b in zip(plain[0], gloo[0]))
    assert all(torch.equal(p, gloo[1][k]) for k, p in plain[1].items())
