"""Mixed precision (multimodal_particles_tpu/utils/dtype.py:1-41): float32
master parameters with a bfloat16 compute dtype inside the network forward.
The optimizer state and the bridges' solver steps stay float32; the models
cast their parameters and inputs at the top of `forward` and their heads
back to float32 at its end."""

import dataclasses

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "f32": torch.float32,
    "bf16": torch.bfloat16,
}


def resolve_dtype(name) -> torch.dtype:
    """A dtype name of the config ('float32', 'f32', 'bfloat16', 'bf16'), None
    (float32) or a torch dtype; an unknown name raises KeyError, as the JAX
    package's table lookup does."""
    if name is None:
        return torch.float32
    if isinstance(name, str):
        return _DTYPES[name]
    return name


def cast_floating(tree, dtype):
    """Floating tensors of a nested tuple / list / dict / dataclass cast to
    `dtype`; integer and bool tensors, None and everything else as given."""
    dtype = resolve_dtype(dtype)
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: cast_floating(getattr(tree, f.name), dtype)
            for f in dataclasses.fields(tree) if f.init})
    return tree


def compute_dtype_of(config) -> torch.dtype:
    """The config's `parallel.compute_dtype`, float32 without a parallel section."""
    par = getattr(config, "parallel", None)
    return resolve_dtype(getattr(par, "compute_dtype", "float32") if par else "float32")
