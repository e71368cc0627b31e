"""Multi-task loss combination (multimodal_particles_tpu/utils/losses.py:15-39).

The learnable variant is uncertainty weighting Σ_i exp(-w_i)·L_i + w_i with
trainable log-variances w, which the model owns as its `loss_weights`
parameter.
"""

from typing import List, Sequence, Tuple

import torch

from multimodal_particles_tpu_torch.parallel import spmd


def multihead_loss(
    losses: Sequence[torch.Tensor], weights: torch.Tensor, mode: str = "learnable"
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Combine per-head scalar losses. weights: (num_losses,) learnable
    log-variances, or fixed weights. 'learnable' → Σ exp(-w_i)·L_i + w_i;
    'fixed' → Σ w_i·L_i."""
    losses = list(losses)
    if mode == "learnable":
        # under spmd.global_batch each rank's losses are its shares; + w_i counts once
        combined = sum(torch.exp(-weights[i]) * losses[i] + spmd.once(weights[i])
                       for i in range(len(losses)))
    elif mode == "fixed":
        combined = sum(weights[i] * losses[i] for i in range(len(losses)))
    else:
        raise ValueError(f"unknown multihead loss mode {mode!r}")
    return combined, losses


def multihead_weights(weights: torch.Tensor, mode: str = "learnable") -> torch.Tensor:
    """Effective per-head weights (exp(-w) in learnable mode)."""
    if mode == "learnable":
        return torch.exp(-weights)
    return weights
