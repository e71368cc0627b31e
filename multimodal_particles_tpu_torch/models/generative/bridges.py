"""Stochastic bridges (multimodal_particles_tpu/models/generative/bridges.py).

Training half (bridge states at a time t, drift targets):
  linear_uniform_sample / _drift     x_t = t x1 + (1-t) x0 + σ z, target x1 - x0
                                                                  (bridges.py:49-59)
  schrodinger_sample / _drift        Brownian bridge, std σ√(t(1-t)) (bridges.py:62-77)
  telegraph_conditional_probability  P(x_t_out | x_t_in)          (bridges.py:85-91)
  telegraph_transition_probability   posterior P(x_t | x0, x1), the golden
                                                                  (bridges.py:94-108)
  telegraph_sample                   fused posterior draw         (bridges.py:111-136)
Sampler half:
  LinearUniformBridge.solver_step   Euler ODE step           (bridges.py:382-395)
  SchrodingerBridge.solver_step     Euler–Maruyama step      (bridges.py:416-425)
  telegraph_rate                    reverse-time jump rates  (bridges.py:139-159)
  tau_leaping_step                  single-jump update on explicit uniforms
                                                                  (bridges.py:162-202)
  tau_leaping_step_poisson          the reference's Poisson tau-leaping, the
                                    golden law of the test only (bridges.py:247-263)
  telegraph_fused_solver_step       rate + single-jump update (bridges.py:205-244)
  TelegraphBridge.solver_step       masked token update      (bridges.py:460-473)
Absorbing (survival) bridge on the existence mask (bridges.py:266-355, :475-523):
  absorbing_survival_probability    e^{-γt}(1 − e^{γ(t−1)})/(1 − e^{-γ})
  absorbing_sample                  training mask at time t, with target_dropout
  absorbing_rate / _death_hazard    birth rate SP(t)·σ(logit); γ/(1 − e^{γ(t−1)})
  absorbing_step                    Bernoulli births, optional deaths
  AbsorbingBridge.solver_step       one mask step of the sampler

Randomness is an input: bridge sampling takes its normals `z` (shape of x)
and uniforms `u` (B, N) as tensors, the Euler–Maruyama step its normals `dw`,
and the telegraph update a (2, B, N) tensor of uniforms, `u[0]` for the jump
test and `u[1]` for the inverse-CDF draw, as ops/sampler_pallas.py:87-99
uses them. The absorbing bridge takes (B, N, 1) uniforms: a Bernoulli(p) draw
is `u < p`, which is how `jax.random.bernoulli` makes it.

The solver steps take `multimodal`: True (MBM) masks with the heads' fixed
mask, False (the absorbing family) with the state's generated `mask_t`.
"""

import math
from dataclasses import dataclass

import torch

from multimodal_particles_tpu_torch.models.generative.states import (
    AbsorbingBridgeState,
    MultiHeadOutput,
)

def time_grid(bridge_config):
    """The sampler's times as Python floats (float32 values) and the float32
    step: linspace(0, 1 − time_eps, num_timesteps); the samplers evaluate
    their steps at time_steps[1:], 99 steps for 100 timesteps."""
    ts = torch.linspace(0.0, 1.0 - bridge_config.time_eps, bridge_config.num_timesteps,
                        dtype=torch.float32)
    delta_t = (ts[-1] - ts[0]) / (bridge_config.num_timesteps - 1)
    return ts.tolist(), delta_t.item()


# ---------------------------------------------------------------- continuous


def linear_uniform_sample(t, x0, x1, sigma, z):
    """x_t = t·x1 + (1-t)·x0 + σ·z with constant σ."""
    return t * x1 + (1.0 - t) * x0 + sigma * z


def linear_uniform_drift(t, x, x0, x1):
    """Conditional-OT drift target: x1 - x0 (state-independent)."""
    del t, x
    return x1 - x0


def schrodinger_sample(t, x0, x1, sigma, z):
    """Brownian-bridge marginal: mean t·x1+(1-t)·x0, std σ√(t(1-t))."""
    x = t * x1 + (1.0 - t) * x0
    return x + sigma * torch.sqrt(t * (1.0 - t)) * z


def schrodinger_drift(t, x, x0, x1):
    # clamp away from the endpoints: MBM draws t ~ U[0,1) with no epsilon
    # floor, and t = 0 would make the target infinite
    t = torch.clamp(t, 1e-6, 1.0 - 1e-6)
    denom = t * (1.0 - t)
    A = (1.0 - 2.0 * t) / denom
    B = t**2 / denom
    C = -((1.0 - t) ** 2) / denom
    return A * x + B * x1 + C * x0


# ---------------------------------------------------------------- telegraph


def telegraph_conditional_probability(t_in, t_out, k_in, k_out, gamma, vocab_size):
    """P(x(t_out)=k_out | x(t_in)=k_in) = 1/S + w·(δ_{k_out,k_in} - 1/S),
    w = exp(-S γ (t_out - t_in)). Broadcasts over leading dims."""
    S = vocab_size
    w = torch.exp(torch.as_tensor(-S * gamma * (t_out - t_in), dtype=torch.float32))
    kronecker = (k_out == k_in).to(w.dtype)
    return 1.0 / S + w * (kronecker - 1.0 / S)


def telegraph_transition_probability(t, k0, k1, gamma, vocab_size):
    """Posterior bridge P(x_t = k | x_0=k0, x_1=k1) over all k: t (B,1,1),
    k0 and k1 (B,N,1) → (B, N, S) normalized probabilities."""
    k = torch.arange(vocab_size, device=k0.device)[None, None, :]
    p_k_to_k1 = telegraph_conditional_probability(t, 1.0, k, k1, gamma, vocab_size)
    p_k0_to_k = telegraph_conditional_probability(0.0, t, k0, k, gamma, vocab_size)
    p_k0_to_k1 = telegraph_conditional_probability(0.0, 1.0, k0, k1, gamma, vocab_size)
    return (p_k_to_k1 * p_k0_to_k) / p_k0_to_k1


def telegraph_sample(t, k0, k1, gamma, vocab_size, u):
    """Draw k_t ~ P(·| k0, k1) from the closed-form posterior bridge by
    inverse CDF on the uniforms u (B, N).

    The unnormalized posterior factorizes over the two Kronecker deltas,
    P(k) ∝ (1/S + w_a(δ_{k,k1} − 1/S)) · (1/S + w_b(δ_{k0,k} − 1/S)) with
    w_a = e^{−Sγ(1−t)}, w_b = e^{−Sγt}; the normalization cancels.

    The states lie on the leading axis, (S, B, N): PyTorch's CUDA scan over
    an innermost axis of 8 took 6 ms on an H100 at B=8192, N=128; over a
    leading axis each thread sums one column in turn, in the same order."""
    S = vocab_size
    t_ = torch.as_tensor(t).reshape(-1, 1)
    w_a = torch.exp(-S * gamma * (1.0 - t_))
    w_b = torch.exp(-S * gamma * t_)
    iota = torch.arange(S, device=k0.device)[:, None, None]
    fac_a = torch.where(iota == k1[..., 0], 1.0 / S + w_a * (1.0 - 1.0 / S), (1.0 - w_a) / S)
    fac_b = torch.where(iota == k0[..., 0], 1.0 / S + w_b * (1.0 - 1.0 / S), (1.0 - w_b) / S)
    cdf = torch.cumsum(fac_a * fac_b, dim=0)
    u_ = u.to(cdf.dtype) * cdf[-1]
    k_t = torch.sum((u_ >= cdf).long(), dim=0)
    k_t = torch.clamp(k_t, 0, S - 1)
    return k_t[..., None].to(k0.dtype)


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


def tau_leaping_step(k, rates, delta_t, vocab_size, u_jump, u_target):
    """Tau-leaping update of the tokens in its single-jump closed form
    (bridges.py:162-202), on explicit uniforms: a particle jumps iff u_jump <
    ΛΔt·e^{−ΛΔt} (Λ = Σ_j λ_j), to the state j drawn by inverse CDF of λ_j/Λ
    with u_target, clipped to [0, S−1]. This is the law of the reference's S
    Poisson draws kept only when their total is at most 1
    (`tau_leaping_step_poisson`).

    Args:
      k:        (B, N, 1) current tokens
      rates:    (B, N, S) nonnegative jump rates
      u_jump, u_target: (B, N) uniforms in [0, 1)
    Returns:
      (B, N, 1) updated tokens, dtype of k.
    """
    k_sq = k[..., 0].long()
    lam = rates * delta_t
    lam_total = torch.sum(lam, dim=-1)
    do_jump = u_jump < lam_total * torch.exp(-lam_total)
    cdf = torch.cumsum(lam, dim=-1)
    u2 = u_target * lam_total
    target = torch.sum((u2[..., None] >= cdf).long(), dim=-1)
    target = torch.clamp(target, 0, vocab_size - 1)
    k_new = torch.where(do_jump, target, k_sq)
    return k_new[..., None].to(k.dtype)


def tau_leaping_step_poisson(k, rates, delta_t, vocab_size, generator=None):
    """The reference's tau-leaping (bridges.py:247-263): S Poisson counts a
    particle, the net jump kept when their total is at most 1. The golden law
    that `tau_leaping_step` is held to in distribution; no sampler calls it."""
    k_sq = k[..., 0].long()
    all_jumps = torch.poisson(rates * delta_t, generator=generator).long()
    jump_mask = (torch.sum(all_jumps, dim=-1) <= 1).long()
    diff = torch.arange(vocab_size, device=k.device)[None, None, :] - k_sq[:, :, None]
    net_jumps = torch.sum(all_jumps * diff, dim=-1)
    k_new = torch.clamp(k_sq + net_jumps * jump_mask, 0, vocab_size - 1)
    return k_new[..., None].to(k.dtype)


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

    # the states on the leading axis for the scan, as in telegraph_sample:
    # PyTorch's CUDA scan over an innermost axis of 8 took 0.65 ms a step at
    # B=1024, N=109 on an H100, an eighth of an absorbing request
    cdf = torch.cumsum(lam.movedim(-1, 0).contiguous(), dim=0)
    u2 = u[1] * lam_total
    target = torch.sum((u2 >= cdf).long(), dim=0)
    target = torch.clamp(target, 0, S - 1)

    k_new = torch.where(do_jump, target, k_sq)
    return k_new[..., None].to(k.dtype)


# ---------------------------------------------------------------- absorbing


def absorbing_survival_probability(t, gamma):
    """P(killing after time t) = e^{-γt} (1 - e^{γ(t-1)}) / (1 - e^{-γ})."""
    return torch.exp(-gamma * t) * (1.0 - torch.exp(gamma * (t - 1.0))) / (1.0 - math.exp(-gamma))


def absorbing_sample(t, target_mask, gamma, u, target_dropout=0.0, u_drop=None):
    """The alive/dead mask at time t: slots of the target are alive, the rest
    survive while u < SP(t). With target_dropout > 0 each target slot is dead
    while u_drop < dropout·SP(t) (alive with probability 1 at t = 1,
    1 − dropout at t = 0), so that the head sees dead slots whose label is
    alive.

    Args:
      t:           (B, 1, 1)
      target_mask: (B, N, 1)
      u, u_drop:   (B, N, 1) uniforms
    Returns:
      (B, N, 1) int64 mask.
    """
    survival = absorbing_survival_probability(t, gamma)
    target = target_mask > 0
    out = torch.where(target, 1, (u < survival).long())
    if target_dropout > 0.0:
        out = torch.where(target & (u_drop < target_dropout * survival), 0, out)
    return out


def absorbing_rate(t, mask_t, logits, gamma):
    """Birth rate = survival(t) · sigmoid(logits). logits: (B, N, 1)."""
    del mask_t
    return absorbing_survival_probability(t, gamma) * torch.sigmoid(logits)


def absorbing_death_hazard(t, gamma):
    """Conditional death hazard of a non-target alive slot at time t,
    h(t) = −d/dt log SP(t) = γ / (1 − e^{γ(t−1)}); it diverges at t → 1 and
    the solver clips dt·h to 1."""
    return gamma / torch.clamp(1.0 - torch.exp(gamma * (t - 1.0)), min=1e-12)


def absorbing_step(mask_t, rates, delta_t, u, death_rates=None, u_death=None):
    """Bernoulli-thinning mask step: a dead slot is born while
    u < clip(Δt·rate, 0, 1); an alive slot stays, or with `death_rates` dies
    while u_death < clip(Δt·death_rate, 0, 1). All (B, N, 1)."""
    births = (u < torch.clamp(delta_t * rates, 0.0, 1.0)).to(mask_t.dtype)
    if death_rates is None:
        return torch.where(mask_t > 0, 1, births)
    survives = 1 - (u_death < torch.clamp(delta_t * death_rates, 0.0, 1.0)).to(mask_t.dtype)
    return torch.where(mask_t > 0, survives, births)


def _solver_mask(state, heads, multimodal: bool):
    return heads.absorbing if multimodal else state.mask_t


@dataclass(frozen=True)
class LinearUniformBridge:
    """Conditional OT flow matching for continuous states (bridges.py:363-395)."""

    sigma: float

    @classmethod
    def from_config(cls, config):
        return cls(sigma=config.bridge.sigma)

    def sample(self, t, x0, x1, z):
        return linear_uniform_sample(t, x0, x1, self.sigma, z)

    def drift(self, t, x, x0, x1):
        return linear_uniform_drift(t, x, x0, x1)

    def diffusion(self, t):
        """No diffusion: zeros of t's shape (bridges.py:379-380)."""
        return torch.zeros_like(torch.as_tensor(t, dtype=torch.float32))

    def solver_step(self, state, heads: MultiHeadOutput, delta_t, multimodal: bool = True):
        """Euler ODE step, masked to existing particles."""
        mask = _solver_mask(state, heads, multimodal)
        new_continuous = (state.continuous + delta_t * heads.continuous) * mask
        return state.replace(continuous=new_continuous)


@dataclass(frozen=True)
class SchrodingerBridge:
    """Brownian (Schrödinger) bridge for continuous states (bridges.py:397-425)."""

    sigma: float

    @classmethod
    def from_config(cls, config):
        return cls(sigma=config.bridge.sigma)

    def sample(self, t, x0, x1, z):
        return schrodinger_sample(t, x0, x1, self.sigma, z)

    def drift(self, t, x, x0, x1):
        return schrodinger_drift(t, x, x0, x1)

    def diffusion(self, t):
        t = torch.as_tensor(t, dtype=torch.float32)
        return self.sigma * torch.sqrt(t * (1.0 - t))

    def solver_step(self, state, heads: MultiHeadOutput, delta_t, dw, multimodal: bool = True):
        """Euler–Maruyama step with normals dw (shape of x), masked. It
        integrates the drift head: the reference integrated the raw state and
        masked the tokens (bridges.py:27-30 of the JAX package)."""
        diffusion = self.diffusion(delta_t)
        new_continuous = (
            state.continuous + delta_t * heads.continuous + diffusion * dw
        ) * _solver_mask(state, heads, multimodal)
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

    def sample(self, t, k0, k1, u):
        return telegraph_sample(t, k0, k1, self.gamma, self.vocab_size, u)

    def rate(self, t, k, logits):
        return telegraph_rate(t, k, logits, self.gamma, self.vocab_size)

    def transition_probability(self, t, k0, k1):
        return telegraph_transition_probability(t, k0, k1, self.gamma, self.vocab_size)

    def conditional_probability(self, t_in, t_out, k_in, k_out):
        return telegraph_conditional_probability(t_in, t_out, k_in, k_out, self.gamma,
                                                 self.vocab_size)

    def solver_step(self, state, heads: MultiHeadOutput, delta_t, u, multimodal: bool = True):
        new_discrete = telegraph_fused_solver_step(
            state.time, state.discrete, heads.discrete, self.gamma,
            self.vocab_size, delta_t, u,
        )
        mask = _solver_mask(state, heads, multimodal)
        return state.replace(discrete=new_discrete * mask.to(new_discrete.dtype))


@dataclass(frozen=True)
class AbsorbingBridge:
    """Survival bridge for the existence mask (bridges.py:475-523)."""

    gamma_absorb: float
    target_dropout: float = 0.0
    death_rate_scale: float = 0.0

    @classmethod
    def from_config(cls, config):
        return cls(
            gamma_absorb=config.bridge.gamma_absorb,
            target_dropout=getattr(config.bridge, "target_dropout", 0.0),
            death_rate_scale=getattr(config.bridge, "death_rate_scale", 0.0),
        )

    @property
    def sample_draws(self) -> int:
        """How many (B, N, 1) uniform tensors `sample` reads."""
        return 2 if self.target_dropout > 0.0 else 1

    @property
    def step_draws(self) -> int:
        """How many (B, N, 1) uniform tensors `solver_step` reads."""
        return 2 if self.death_rate_scale > 0.0 else 1

    def survival_probability(self, t):
        return absorbing_survival_probability(t, self.gamma_absorb)

    def sample(self, time, target_mask, u, u_drop=None):
        return absorbing_sample(time, target_mask, self.gamma_absorb, u,
                                self.target_dropout, u_drop)

    def rate(self, t, k, logits):
        return absorbing_rate(t, k, logits, self.gamma_absorb)

    def solver_step(self, state: AbsorbingBridgeState, heads, delta_t, u, u_death=None):
        """One mask step. With `death_rate_scale` > 0 an alive slot, a target
        slot with posterior p = σ(logit), dies at scale·(1 − p)·h(t)."""
        rates = self.rate(state.time, state.mask_t, heads.absorbing)
        death_rates = None
        if self.death_rate_scale > 0.0:
            death_rates = (
                self.death_rate_scale
                * (1.0 - torch.sigmoid(heads.absorbing))
                * absorbing_death_hazard(state.time, self.gamma_absorb)
            )
        new_mask = absorbing_step(state.mask_t, rates, delta_t, u, death_rates, u_death)
        return state.replace(mask_t=new_mask)
