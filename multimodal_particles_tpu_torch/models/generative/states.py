"""State containers for the hybrid bridges
(multimodal_particles_tpu/models/generative/states.py:18-81).

Plain dataclasses of tensors; `replace` returns a new container, as the flax
struct dataclasses do.
"""

import dataclasses
from typing import List, Optional

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


OutputHeads = MultiHeadOutput


@dataclasses.dataclass
class AbsorbingBridgeState:
    """State of the absorbing-flow dynamics: the mask itself is generated
    (slots are born, and with the death channel killed), so it carries a
    time-dependent `mask_t` (B, N, 1) of 0/1 integers instead of a fixed mask."""

    time: Optional[torch.Tensor] = None
    continuous: Optional[torch.Tensor] = None
    discrete: Optional[torch.Tensor] = None
    mask_t: Optional[torch.Tensor] = None

    def replace(self, **changes) -> "AbsorbingBridgeState":
        return dataclasses.replace(self, **changes)

    @staticmethod
    def cat(states: List["AbsorbingBridgeState"], dim: int = 0) -> "AbsorbingBridgeState":
        """Concatenate states along `dim`; a field that no state has stays None."""

        def cat_attr(name):
            attrs = [getattr(s, name) for s in states if getattr(s, name) is not None]
            return torch.cat(attrs, dim=dim) if attrs else None

        return AbsorbingBridgeState(*(cat_attr(f.name)
                                      for f in dataclasses.fields(AbsorbingBridgeState)))
