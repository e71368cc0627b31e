"""The ('data', 'model') device mesh and the batch helpers
(multimodal_particles_tpu/parallel/mesh.py:29-110) on torch.distributed.

The ranks of the initialised process group form a
`torch.distributed.device_mesh.DeviceMesh` of shape (data, model), in JAX's
order: rank = data_index · model + model_index. Training and bulk sampling
split the batch axis over 'data'; the parameters are replicated at
`model_axis=1`, and at `model_axis > 1` the trainer puts the Megatron pairs in
tensor-parallel form (parallel/tp.py).

Where JAX holds one global array whose rows live on the devices of the
'data' axis, each rank here holds its own rows (`shard_batch`), as each
process of a multi-host JAX job feeds its local rows
(`jax.make_array_from_process_local_data`). Every rank reads the same global
batch and keeps its rows.

`init_from_env` starts the process group from the variables `torchrun` sets
(RANK, WORLD_SIZE, MASTER_ADDR/PORT, LOCAL_RANK): NCCL with one card a rank,
gloo on the CPU. Nothing starts a process group without them.
"""

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

MESH_AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """The one-rank mesh when no process group is initialised: shape
    {"data": 1, "model": 1}, no groups. It answers the DeviceMesh calls the
    port makes (`mesh_dim_names`, `size`, `get_group`, `get_local_rank`)."""

    device_type: str = "cpu"
    mesh_dim_names: tuple = MESH_AXES

    def size(self, mesh_dim=None) -> int:
        return 1

    def get_group(self, mesh_dim=None):
        return None

    def get_local_rank(self, mesh_dim=None) -> int:
        return 0


def init_from_env(device_type: Optional[str] = None) -> bool:
    """Initialise the default process group from torchrun's environment
    (RANK and WORLD_SIZE set, none initialised yet): NCCL for 'cuda', with
    the card LOCAL_RANK made current, gloo for 'cpu'. `device_type` None takes
    'cuda' when a card is present. Returns whether a process group is
    initialised afterwards."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    return True


def make_device_mesh(data_axis: int = -1, model_axis: int = 1, device_type: Optional[str] = None):
    """A ('data', 'model') mesh over the process group's ranks
    (mesh.py:29-48). data_axis == -1 means "all ranks / model_axis". With no
    process group (and none in the environment, `init_from_env`), the
    one-rank `LocalMesh`. `device_type` None takes the default group's
    device: 'cuda' under NCCL, else 'cpu' (gloo on the card passes 'cuda')."""
    if not init_from_env(device_type):
        if data_axis not in (-1, 1) or model_axis != 1:
            raise ValueError(f"a {data_axis}x{model_axis} mesh needs a process group")
        return LocalMesh(device_type or "cpu")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    n = dist.get_world_size()
    if data_axis == -1:
        assert n % model_axis == 0, f"{n} ranks not divisible by model={model_axis}"
        data_axis = n // model_axis
    assert data_axis * model_axis <= n, f"mesh {data_axis}x{model_axis} needs more than {n} ranks"
    from torch.distributed.device_mesh import DeviceMesh

    grid = torch.arange(data_axis * model_axis).reshape(data_axis, model_axis)
    return DeviceMesh(device_type, grid, mesh_dim_names=MESH_AXES)


def mesh_shape(mesh) -> dict:
    """{"data": D, "model": M}, as JAX's `mesh.shape`."""
    return {name: mesh.size(i) for i, name in enumerate(MESH_AXES)}


def batch_sharding(mesh):
    """The batch dimension's placement: rows split over 'data'."""
    from torch.distributed.tensor import Shard

    return (Shard(0),)


def replicated_sharding(mesh):
    from torch.distributed.tensor import Replicate

    return (Replicate(),)


def tree_map(fn, tree):
    """`fn` over the leaves of a batch or a state: tensors, numpy arrays and
    scalars, through lists, tuples (named ones too), dicts and dataclasses;
    None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    return fn(tree)


def tree_leaves(tree) -> list:
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


def _ndim(x) -> int:
    return x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)


def batch_size(batch) -> int:
    """The batch size: the modal leading dimension of the batch's arrays,
    ties broken toward the larger (context fields are the small ones); 0
    when no leaf has a dimension."""
    sizes = [int(x.shape[0]) for x in tree_leaves(batch) if _ndim(x) > 0]
    return max(set(sizes), key=lambda s: (sizes.count(s), s)) if sizes else 0


def pad_to_multiple(batch, multiple: int):
    """Pad the leading axis of every per-sample leaf up to a multiple of
    `multiple` by repeating the last sample (mesh.py:80-110); returns
    (padded batch, original size). The batch size is the modal leading
    dimension, ties broken toward the larger; other leaves (contexts of
    another leading size, 0-d values) pass through. Tensors stay tensors,
    numpy stays numpy."""
    b = batch_size(batch)
    if not b:
        return batch, 0
    target = ((b + multiple - 1) // multiple) * multiple
    if target == b:
        return batch, b

    def pad(x):
        if _ndim(x) == 0 or x.shape[0] != b:
            return x
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x[-1:].expand(target - b, *x.shape[1:])])
        x = np.asarray(x)
        return np.pad(x, [(0, target - b)] + [(0, 0)] * (x.ndim - 1), mode="edge")

    return tree_map(pad, batch), b


def data_rows(size: int, mesh) -> slice:
    """This rank's rows of a global batch of `size` rows: the data_index-th
    of `data` equal blocks (`size` a multiple of the data axis)."""
    shape = mesh_shape(mesh)
    r, d = mesh.get_local_rank("data"), shape["data"]
    if size % d:
        raise ValueError(f"a batch of {size} rows does not split over {d} data ranks; "
                         "pad it first (pad_to_multiple)")
    return slice(r * size // d, (r + 1) * size // d)


def shard_batch(batch, mesh, device=None):
    """This rank's rows of a global batch, on `device` (mesh.py:60-77): the
    counterpart of `jax.make_array_from_process_local_data`. Every per-sample
    leaf (leading dimension the batch size) is cut to `data_rows`; other
    leaves pass through whole. numpy leaves become tensors. On the one-rank
    mesh the leaves are only moved to `device`."""
    b = batch_size(batch)
    rows = data_rows(b, mesh) if mesh_shape(mesh)["data"] > 1 else slice(None)

    def put(x):
        if not isinstance(x, torch.Tensor):
            if _ndim(x) == 0:
                return x
            x = torch.from_numpy(np.asarray(x))
        if x.dim() > 0 and x.shape[0] == b:
            x = x[rows]
        return x if device is None else x.to(device)

    return tree_map(put, batch)
