"""The port's own parameter initialiser, mirroring flax's defaults for the
modules MBM (multimodal_particles_tpu/models/generative/multimodal_bridge_matching.py:90-110),
the absorbing family (absorbing/absorbing_flows.py:155-163) and the
transdimensional family (transdimensional/transdimensional_model.py:284-293) use:

  WeightNormDense  v lecun-normal, g = ‖v‖ per output unit, bias 0
                   (models/architectures/utils.py:65-85)
  Dense            kernel lecun-normal, bias 0
  Embed            normal with std 1/√features (flax `default_embed_init`)
  GroupNorm        scale 1, bias 0
  loss_weights     zeros (2 for MBM, 3 for the absorbing family, none for the
                   transdimensional family)

lecun-normal is flax's truncated normal: a standard normal cut at ±2,
scaled to std √(1/fan_in) / 0.8796 so that the truncated law has variance
1/fan_in. The draws come from numpy's `default_rng(seed)`, whose streams do
not change between library versions, so a seed gives the same weights on
every machine (torch's CPU generator gave other weights under another torch
release). They cannot equal JAX's threefry draws, only their law.
"""

import math

import numpy as np
import torch
from torch import nn

from multimodal_particles_tpu_torch.models.architectures.gsdm import GroupNorm
from multimodal_particles_tpu_torch.models.architectures.utils import WeightNormLinear

# std of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _truncated_normal(rng: np.random.Generator, shape, std: float) -> torch.Tensor:
    out = rng.standard_normal(shape)
    bad = np.abs(out) > 2.0
    while bad.any():
        out[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(out) > 2.0
    return torch.from_numpy((out * std).astype(np.float32))


def _lecun_normal(rng: np.random.Generator, weight: torch.Tensor) -> torch.Tensor:
    fan_in = weight.shape[1]  # torch layout (out, in)
    return _truncated_normal(rng, tuple(weight.shape), math.sqrt(1.0 / fan_in) / _TRUNC_STD)


@torch.no_grad()
def init_parameters(model: nn.Module, seed: int) -> nn.Module:
    """Initialize every parameter of a model of the port in place; returns it.
    Modules are visited in registration order, so the seed fixes the weights."""
    rng = np.random.default_rng(seed)
    for module in model.modules():
        if isinstance(module, WeightNormLinear):
            module.v.copy_(_lecun_normal(rng, module.v))
            module.g.copy_(torch.linalg.vector_norm(module.v, dim=1))
            module.bias.zero_()
        elif isinstance(module, nn.Linear):
            module.weight.copy_(_lecun_normal(rng, module.weight))
            module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            std = math.sqrt(1.0 / module.embedding_dim)
            table = rng.standard_normal(tuple(module.weight.shape)) * std
            module.weight.copy_(torch.from_numpy(table.astype(np.float32)))
        elif isinstance(module, GroupNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    if hasattr(model, "loss_weights"):
        model.loss_weights.zero_()
    return model


# the families' entry points, one law for all
init_mbm_parameters = init_parameters
init_absorbing_parameters = init_parameters
init_transdimensional_parameters = init_parameters
