"""Stochastic bridges, the sampler half
(multimodal_particles_tpu/models/generative/bridges.py).

  LinearUniformBridge.solver_step   Euler ODE step           (bridges.py:382-395)
  telegraph_rate                    reverse-time jump rates  (bridges.py:139-159)
  telegraph_fused_solver_step       rate + single-jump update (bridges.py:205-244)
  TelegraphBridge.solver_step       masked token update      (bridges.py:460-473)

Randomness is an input: the telegraph update takes a (2, B, N) tensor of
uniforms, `u[0]` for the jump test and `u[1]` for the inverse-CDF draw, as
ops/sampler_pallas.py:87-99 uses them. The training half (bridge sampling,
drift targets, the Schrödinger bridge) is not ported yet.
"""

from dataclasses import dataclass

import torch

from multimodal_particles_tpu_torch.models.generative.states import MultiHeadOutput


def telegraph_rate(t, k, logits, gamma, vocab_size):
    """rate(k→j) = 1 + B·q_j + C·q_k with B = wS/(1−w), C = w,
    w = exp(−Sγ(1−t)).

    Args:
      t:      (B, 1, 1) or (B, 1) time
      k:      (B, N, 1) current tokens
      logits: (B, N, S)
    Returns:
      (B, N, S) nonnegative rates.
    """
    S = vocab_size
    qx = torch.softmax(logits, dim=-1)
    qy = torch.gather(qx, -1, k.long())
    t_ = t.reshape(t.shape[0], 1, 1)
    w = torch.exp(-S * gamma * (1.0 - t_))
    return 1.0 + (w * S) / (1.0 - w) * qx + w * qy


def telegraph_fused_solver_step(t, k, logits, gamma, vocab_size, delta_t, u):
    """Reverse rate + closed-form single-jump update with explicit uniforms.

    A particle jumps iff u[0] < Λe^{−Λ} (Λ = Σ_j λ_j Δt); the target j is
    drawn by inverse CDF of λ_j/Λ with u[1], clipped to [0, S−1].

    Args:
      t:      (B, 1, 1) or broadcastable time
      k:      (B, N, 1) current tokens
      logits: (B, N, S)
      u:      (2, B, N) uniforms in [0, 1)
    Returns:
      (B, N, 1) updated tokens, dtype of k.
    """
    S = vocab_size
    k_sq = k[..., 0].long()
    one_hot = (k_sq[..., None] == torch.arange(S, device=k.device)).to(logits.dtype)
    qx = torch.softmax(logits, dim=-1)
    qy = torch.sum(qx * one_hot, dim=-1, keepdim=True)
    t_ = torch.as_tensor(t, dtype=logits.dtype, device=logits.device).reshape(-1, 1, 1)
    w = torch.exp(-S * gamma * (1.0 - t_))
    rates = 1.0 + (w * S) / (1.0 - w) * qx + w * qy

    lam = rates * delta_t
    lam_total = torch.sum(lam, dim=-1)
    do_jump = u[0] < lam_total * torch.exp(-lam_total)

    cdf = torch.cumsum(lam, dim=-1)
    u2 = u[1] * lam_total
    target = torch.sum((u2[..., None] >= cdf).long(), dim=-1)
    target = torch.clamp(target, 0, S - 1)

    k_new = torch.where(do_jump, target, k_sq)
    return k_new[..., None].to(k.dtype)


@dataclass(frozen=True)
class LinearUniformBridge:
    """Conditional OT flow matching for continuous states (bridges.py:363-395)."""

    sigma: float

    @classmethod
    def from_config(cls, config):
        return cls(sigma=config.bridge.sigma)

    def solver_step(self, state, heads: MultiHeadOutput, delta_t):
        """Euler ODE step, masked to existing particles."""
        new_continuous = (state.continuous + delta_t * heads.continuous) * heads.absorbing
        return state.replace(continuous=new_continuous)


@dataclass(frozen=True)
class TelegraphBridge:
    """Multivariate telegraph CTMC bridge on a vocab of S tokens
    (bridges.py:428-473)."""

    gamma: float
    vocab_size: int

    @classmethod
    def from_config(cls, config):
        return cls(gamma=config.bridge.gamma, vocab_size=config.data.vocab_size_features)

    def solver_step(self, state, heads: MultiHeadOutput, delta_t, u):
        new_discrete = telegraph_fused_solver_step(
            state.time, state.discrete, heads.discrete, self.gamma,
            self.vocab_size, delta_t, u,
        )
        new_discrete = new_discrete * heads.absorbing.to(new_discrete.dtype)
        return state.replace(discrete=new_discrete)
