"""State containers for the hybrid bridges
(multimodal_particles_tpu/models/generative/states.py:18-54).

Plain dataclasses of tensors; `replace` returns a new container, as the flax
struct dataclasses do.
"""

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class HybridState:
    """Time-dependent hybrid bridge state (t, x, k, mask).

    Shapes:
      time:       (B, 1, 1)
      continuous: (B, N, dim_continuous)
      discrete:   (B, N, 1) integer tokens
      absorbing:  (B, N, 1) float mask (fixed during MBM dynamics)
    """

    time: Optional[torch.Tensor] = None
    continuous: Optional[torch.Tensor] = None
    discrete: Optional[torch.Tensor] = None
    absorbing: Optional[torch.Tensor] = None

    def replace(self, **changes) -> "HybridState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class MultiHeadOutput:
    """Network head outputs (drift prediction, token logits, mask)."""

    continuous: Optional[torch.Tensor] = None
    discrete: Optional[torch.Tensor] = None
    absorbing: Optional[torch.Tensor] = None
