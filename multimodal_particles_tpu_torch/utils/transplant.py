"""flax → torch parameter transplant for MBM.

`params_from_flax` turns the JAX package's MBM parameter pytree (the dict that
`MultiModalBridgeMatching.init` returns, multimodal_bridge_matching.py:90-110,
with numpy leaves) into the port's `state_dict`. At config-berlin it has 47
leaves:

  encoder.epic.embedding.embedding_continuous.{kernel,bias}
  encoder.epic.embedding.embedding_discrete.embedding
  encoder.epic.epic.{epic_proj.{local_0,global_0..2},
                     epic_layer_i.{fc_global1,fc_global2,fc_local1,fc_local2},
                     output_layer}.{v,g,bias}
  encoder.fc_layer.layers_{0,2}.{kernel,bias}
  loss_weights

A Dense `kernel (in, out)` becomes `Linear.weight (out, in)`, a weight-normed
`v (in, out)` becomes `v (out, in)`, `Embed.embedding` becomes
`Embedding.weight`. Every source leaf must be consumed and every target key
filled with the right shape, or it raises.
"""

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "."))
        else:
            flat[path] = np.asarray(value)
    return flat


def _target_key(path: str):
    """Port key for one flax leaf path, and whether to transpose it."""
    parts = path.split(".")
    parts = [p[len("layers_"):] if p.startswith("layers_") else p for p in parts]
    leaf = parts[-1]
    if leaf == "kernel":
        return ".".join(parts[:-1] + ["weight"]), True
    if leaf == "embedding":
        return ".".join(parts[:-1] + ["weight"]), False
    if leaf == "v":
        return ".".join(parts), True
    return ".".join(parts), False


def params_from_flax(params_np: Mapping, config) -> Dict[str, torch.Tensor]:
    """flax MBM params (numpy leaves) → state_dict of the port's
    MultiModalBridgeMatching(config)."""
    from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (
        MultiModalBridgeMatching,
    )

    expected = {k: tuple(v.shape) for k, v in MultiModalBridgeMatching(config).state_dict().items()}
    state_dict = {}
    for path, value in _flatten(params_np).items():
        key, transpose = _target_key(path)
        if key not in expected:
            raise KeyError(f"flax leaf {path!r} maps to {key!r}, which the port does not have")
        if key in state_dict:
            raise KeyError(f"two flax leaves map to {key!r}")
        array = value.T if transpose else value
        if tuple(array.shape) != expected[key]:
            raise ValueError(f"{path!r}: shape {tuple(array.shape)} != {expected[key]} of {key!r}")
        state_dict[key] = torch.from_numpy(np.array(array, dtype=np.float32, order="C"))
    missing = sorted(set(expected) - set(state_dict))
    if missing:
        raise KeyError(f"flax params lack leaves for {missing}")
    return state_dict
