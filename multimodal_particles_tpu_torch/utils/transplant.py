"""flax → torch parameter transplant for MBM, the absorbing family and the
transdimensional family.

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

The flax `AbsorbingFlow` tree (`{"generator": …, "loss_weights": (3,)}`,
absorbing/absorbing_flows.py:155-163) maps onto `AbsorbingFlow`'s state_dict
the same way: `generator.epic…` as the encoder above,
`generator.discrete_head_mlp.layers_{0,2}`, the Dense layers `temb_net`,
`transformer_1_proj_in`, `res_block_i.{conv1,temb_proj,conv2}`,
`attn_block_i.{q,k,v,proj_out}`, `pre_rate_proj`, `post_rate_proj`, and the
GroupNorms `res_block_i.{norm1,norm2}`, `attn_block_i.norm`.

The flax `TransdimensionalJumpDiffusion` tree (`{"network": …}`,
transdimensional/transdimensional_model.py:284-293) maps onto the port's
model likewise: `network.epic…` as the encoder above, except that
`embedding.embedding_discrete` is a Dense (`kernel`, `bias`) with the
Linear-discrete input; the Dense layers `temb_net`, `transformer_1_proj_in`,
`vec_transformer_in_proj`, `pre_rate_proj`, `post_rate_proj`, `near_atom_proj`,
`vec_weighting_proj`, `pre_auto_proj`, `post_auto_proj`, and the blocks `res_i`,
`attn_i`, `vec_res_i`, `vec_attn_i` with the survival head's leaves.

A Dense `kernel (in, out)` becomes `Linear.weight (out, in)`, a weight-normed
`v (in, out)` becomes `v (out, in)`, `Embed.embedding` becomes
`Embedding.weight`, a GroupNorm's `scale` its `weight`. Every source leaf must be consumed and every target key
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
    if leaf in ("embedding", "scale"):
        return ".".join(parts[:-1] + ["weight"]), False
    if leaf == "v":
        return ".".join(parts), True
    return ".".join(parts), False


def params_from_flax(params_np: Mapping, config, model_cls=None) -> Dict[str, torch.Tensor]:
    """flax params of a model family (numpy leaves) → state_dict of the
    port's `model_cls(config)`; MultiModalBridgeMatching by default."""
    if model_cls is None:
        from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (
            MultiModalBridgeMatching as model_cls,
        )

    expected = {k: tuple(v.shape) for k, v in model_cls(config).state_dict().items()}
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
