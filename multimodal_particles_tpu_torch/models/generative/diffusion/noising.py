"""VP-SDE noise schedule, forward dimension-deletion rates, and the reverse
birth rate from an x0-dimension prediction
(multimodal_particles_tpu/models/generative/diffusion/noising.py:30-348).

The schedule and the rates are frozen dataclasses of Python floats whose
methods take and return tensors. Randomness is an input: `get_dims_at_t`
draws its Poisson counts from a caller's generator or takes them as given.
"""

import math
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class VP_SDE:
    """Continuous-time DDPM (VP) statistics, alpha_bar through
    log α(t) = −t²(β_max − β_min)/4 − t β_min/2 (noising.py:30-76)."""

    max_dim: int
    beta_min: float
    beta_max: float

    def _log_alpha(self, ts):
        return -0.25 * ts**2 * (self.beta_max - self.beta_min) - 0.5 * ts * self.beta_min

    def get_beta_t(self, ts):
        """(B,) → (B, max_dim) linear beta schedule."""
        beta = ts * self.beta_max + (1.0 - ts) * self.beta_min
        return beta[:, None].expand(ts.shape[0], self.max_dim)

    def get_sigma(self, times):
        """sqrt(1 − alpha_bar_t)."""
        return torch.sqrt(1.0 - torch.exp(2.0 * self._log_alpha(times)))

    def get_p0t_stats(self, flat_lats, times):
        """p(x_t | x_0) mean and std for flat latents (B, D), times (B,)."""
        log_term = self._log_alpha(times).reshape(flat_lats.shape[0], 1)
        mean = torch.exp(log_term) * flat_lats
        std = torch.sqrt(1.0 - torch.exp(2.0 * log_term)).expand(flat_lats.shape)
        return mean, std

    def predict_x0_from_xt(self, xt, eps, t):
        log_term = self._log_alpha(t).reshape(xt.shape[0], 1)
        std = torch.sqrt(1.0 - torch.exp(2.0 * log_term))
        return (xt - std * eps) / torch.exp(log_term)

    def predict_eps_from_x0_xt(self, xt, x0, t):
        log_term = self._log_alpha(t).reshape(xt.shape[0], 1)
        std = torch.sqrt(1.0 - torch.exp(2.0 * log_term))
        return (xt - torch.exp(log_term) * x0) / std

    def get_pxt2_xt1_stats(self, xt1_flat, t1, t2):
        """p(x_t2 | x_t1) Gaussian mean and std."""
        alpha_t1 = torch.exp(2.0 * self._log_alpha(t1)).reshape(-1, 1)
        alpha_t2 = torch.exp(2.0 * self._log_alpha(t2)).reshape(-1, 1)
        mean = torch.sqrt(alpha_t2 / alpha_t1) * xt1_flat
        std = torch.sqrt(1.0 - alpha_t2 / alpha_t1).expand(xt1_flat.shape)
        return mean, std


def _deleted(integral, generator, deleted):
    """Poisson(integral) counts from `generator`, or `deleted` as given."""
    if deleted is not None:
        return deleted.to(integral.device)
    return torch.poisson(integral.to(torch.float32), generator=generator)


@dataclass(frozen=True)
class StateIndependentForwardRate:
    """Poisson dimension deletion with a closed-form rate integral
    (noising.py:84-112). The scaling puts the mean number of deletions
    std_mult standard deviations above max_num_deletions."""

    max_dim: int
    std_mult: float = 0.7
    offset: float = 0.1

    @property
    def max_num_deletions(self):
        return self.max_dim - 1

    def get_rate(self, dims, ts):
        raise NotImplementedError

    def get_rate_integral(self, ts):
        raise NotImplementedError

    def get_dims_at_t(self, start_dims, ts, generator=None, deleted=None):
        """Dims at time t: start_dims − Poisson(∫rate), at least 1. The counts
        come from `generator`, or are the (B,) tensor `deleted`."""
        deleted = _deleted(self.get_rate_integral(ts), generator, deleted)
        return torch.clamp(start_dims - deleted.to(start_dims.dtype), min=1).to(torch.int32)

    def get_dims_at_t2_starting_t1(self, dims_t1, t1, t2, generator=None, deleted=None):
        integral = self.get_rate_integral(t2) - self.get_rate_integral(t1)
        deleted = _deleted(integral, generator, deleted)
        return torch.clamp(dims_t1 - deleted.to(dims_t1.dtype), min=1).to(torch.int32)


@dataclass(frozen=True)
class StepForwardRate(StateIndependentForwardRate):
    """Step rate: the offset before rate_cut_t, a calibrated constant on top
    of it after (noising.py:115-142)."""

    rate_cut_t: float = 0.5

    def get_scalar(self):
        T = self.rate_cut_t
        c = self.max_num_deletions
        return (
            2 * (1 - T) * c
            + self.std_mult**2 * (1 - T)
            + math.sqrt(
                (-2 * (1 - T) * c - self.std_mult**2 * (1 - T)) ** 2
                - 4 * (1 - T) ** 2 * c**2
            )
        ) / (2 * (1 - T) ** 2)

    def get_rate(self, dims, ts):
        del dims
        return self.get_scalar() * (ts > self.rate_cut_t) + self.offset

    def get_rate_integral(self, ts):
        T = self.rate_cut_t
        return (ts - T) * self.get_scalar() * (ts > T) + self.offset * ts


@dataclass(frozen=True)
class ConstForwardRate(StateIndependentForwardRate):
    """Constant rate, variance-calibrated when `scalar` is None
    (noising.py:145-167)."""

    scalar: Optional[float] = None

    def get_scalar(self):
        if self.scalar is not None:
            return self.scalar
        c = self.max_num_deletions
        return (
            2 * c
            + self.std_mult**2
            + math.sqrt((self.std_mult**2 + 2 * c) ** 2 - 4 * c**2)
        ) / 2

    def get_rate(self, dims, ts):
        del dims
        return self.get_scalar() * torch.ones_like(ts)

    def get_rate_integral(self, ts):
        return self.get_scalar() * ts


def get_forward_rate(rate_function_name, max_problem_dim, rate_cut_t):
    if rate_function_name == "step":
        return StepForwardRate(max_dim=max_problem_dim, rate_cut_t=rate_cut_t)
    if rate_function_name == "const":
        return ConstForwardRate(max_dim=max_problem_dim)
    raise ValueError(rate_function_name)


def get_noise_schedule(noise_schedule_name, max_problem_dim, vp_sde_beta_min, vp_sde_beta_max):
    if noise_schedule_name == "vp_sde":
        return VP_SDE(max_problem_dim, vp_sde_beta_min, vp_sde_beta_max)
    raise ValueError(noise_schedule_name)


# ------------------------------- reverse birth rate from x0-dimension prediction


def _poisson_logpmf(k, lam):
    """log Poisson(k; λ), broadcastable."""
    return k * torch.log(lam) - lam - torch.lgamma(k + 1.0)


def get_rate_using_x0_pred(x0_dim_logits, xt_dims, forward_rate, ts, max_dim):
    """Reverse birth rate rev = f(t) Σ_{d0} [p(d+1|d0)/p(d|d0)] p(d0|x)
    (noising.py:196-249): a masked softmax over the admissible d0 ≥ d_x, the
    Poisson pmf ratio (d0 − d)/λ at d_x > 1, and at the clamped boundary
    d_x = 1 the ratio of pmf(d0 − 2) to the survival P(K ≥ d0 − 1), a
    logsumexp truncated at 2·max_dim terms.

    x0_dim_logits (B, max_dim) over d0 = 1..max_dim; xt_dims, ts (B,) → (B,)."""
    device = x0_dim_logits.device
    dx0range = torch.arange(1, max_dim + 1, device=device)
    xt_dims = xt_dims.to(torch.int32)

    allowed = dx0range[None, :] >= xt_dims[:, None]  # (B, D)
    masked_logits = torch.where(allowed, x0_dim_logits, -torch.inf)
    x0_dim_probs = torch.softmax(masked_logits, dim=1)
    x0_dim_probs = torch.where(allowed, x0_dim_probs, 0.0)

    lam = forward_rate.get_rate_integral(ts)  # (B,)

    ratios_gt1 = torch.clamp(dx0range[None, :] - xt_dims[:, None], min=0) / lam[:, None]

    truncation = max_dim * 2
    # (D, truncation): the row of d0 covers k = d0−1 .. d0−1+truncation−1
    k_surv = (
        torch.arange(truncation, device=device)[None, :]
        + torch.arange(max_dim, device=device)[:, None]
    ).to(torch.float32)
    logpmf_surv = _poisson_logpmf(k_surv[None, :, :], lam[:, None, None])  # (B, D, truncation)
    dim1_logprobs = torch.logsumexp(logpmf_surv, dim=2)  # (B, D)

    k2 = torch.clamp(torch.arange(-1, max_dim - 1, device=device), min=0).to(torch.float32)
    dim2_logprobs = _poisson_logpmf(k2[None, :], lam[:, None]).clone()  # (B, D)
    dim2_logprobs[:, 0] = -1000.0  # p(d_x = 2 | d0 = 1) is impossible

    ratios_eq1 = torch.exp(dim2_logprobs - dim1_logprobs)
    ratios_eq1 = torch.where(allowed, ratios_eq1, 0.0)

    ratios = torch.where((xt_dims > 1)[:, None], ratios_gt1, ratios_eq1)
    return forward_rate.get_rate(None, ts) * torch.sum(ratios * x0_dim_probs, dim=1)


def analytic_x0_dim_logits(prior_log_probs, dims, forward_rate, ts, max_dim):
    """The exact count-conditional posterior log p(d0 | dims_t, t) of the
    forward death chain, log prior(d0) + log P(dims_t | d0, t)
    (noising.py:252-293): at dims_t = d > 1 the Poisson pmf of d0 − d
    deletions, at the clamped dims_t = 1 the survival P(K ≥ d0 − 1), a
    regularized incomplete gamma function.

    prior_log_probs (max_dim,); dims, ts (B,) → (B, max_dim), −1e30 at an
    impossible d0."""
    d0r = torch.arange(1, max_dim + 1, dtype=torch.float32, device=ts.device)
    lam = torch.clamp(forward_rate.get_rate_integral(ts), min=1e-30)[:, None]
    k = d0r[None, :] - dims[:, None].to(torch.float32)  # (B, D) deletions
    logpmf = torch.where(k >= 0.0, _poisson_logpmf(torch.clamp(k, min=0.0), lam), -1e30)
    surv = torch.where(
        d0r[None, :] > 1.0,
        torch.log(torch.special.gammainc(torch.clamp(d0r[None, :] - 1.0, min=1.0), lam) + 1e-30),
        0.0,
    )
    lik = torch.where((dims == 1)[:, None], surv, logpmf)
    return prior_log_probs.to(lik.device)[None, :] + lik


def get_birth_rates_for_offsets(x0_dim_logits, base_dims, num_offsets, forward_rate, ts, max_dim):
    """Reverse birth rates at the candidate dims base_dims + j for
    j = 0..num_offsets−1 with the x0-dimension logits frozen: the rate ladder
    that a multi-birth step climbs within one solver interval
    (noising.py:296-348). Column 0 is `get_rate_using_x0_pred`; the columns
    j ≥ 1 have d ≥ 2, where the rate is f/λ · Σ_{d0 ≥ d} (d0 − d) p(d0|x) /
    Σ_{d0 ≥ d} p(d0|x), two suffix sums gathered at each candidate.

    → (B, K), exactly 0 at candidates d ≥ max_dim."""
    B, D = x0_dim_logits.shape
    base_dims = base_dims.to(torch.int32)
    rate0 = get_rate_using_x0_pred(x0_dim_logits, base_dims, forward_rate, ts, max_dim)
    if num_offsets == 1:
        return rate0[:, None]

    device = x0_dim_logits.device
    dx0range = torch.arange(1, D + 1, dtype=x0_dim_logits.dtype, device=device)
    e = torch.exp(x0_dim_logits - torch.max(x0_dim_logits, dim=1, keepdim=True).values)
    s1 = torch.flip(torch.cumsum(torch.flip(e, [1]), dim=1), [1])  # Σ_{d0 ≥ d} e
    s2 = torch.flip(torch.cumsum(torch.flip(e * dx0range[None, :], [1]), dim=1), [1])

    cand = base_dims[:, None] + torch.arange(1, num_offsets, device=device)[None, :]  # (B, K−1)
    idx = torch.clamp(cand - 1, 0, D - 1).long()
    s1_at = torch.gather(s1, 1, idx)
    s2_at = torch.gather(s2, 1, idx)
    expect = torch.clamp(s2_at - cand.to(s2_at.dtype) * s1_at, min=0.0)
    expect = expect / torch.clamp(s1_at, min=1e-30)

    lam = forward_rate.get_rate_integral(ts)
    f_rate = forward_rate.get_rate(None, ts)
    rates = (f_rate / torch.clamp(lam, min=1e-30))[:, None] * expect
    rates = torch.where(cand < max_dim, rates, 0.0)
    return torch.cat([rate0[:, None], rates], dim=1)
