"""Reverse-time jump-diffusion sampler
(multimodal_particles_tpu/models/generative/transdimensional/sampler.py:76-642).

The time grid is computed on the host from the dt schedule ('uniform' or the
two-level 'C' schedule) and split into contiguous corrector-on / corrector-off
segments; a Python loop walks it (the JAX package scans it). A step is one
network evaluation, an Euler-Maruyama move of the live latents and a birth
move, after which new rows are written at row `dims`: no tensor changes its
shape. NFE counts network evaluations: one a step plus `corrector_steps` a
step inside the corrector window.

The birth move is the reference's single birth (`multi_birth = 1`: at most one
particle a step, with probability rate·dt) or the multi-birth chain: with the
step's x0-dimension logits frozen, the rates at dims, dims+1, … are computed
up front and the pure-birth chain's exponential waiting times are sampled
exactly (`sample_birth_chain`); `exact_rate_integral` replaces dt by the exact
time integral of f/Λ over the step, and `analytic_dim1_posterior` /
`analytic_posterior_all_dims` replace the classifier's logits by the exact
count-conditional posterior from a multiplicity prior. The JAX module's
docstring derives each.

Randomness is an input: every draw comes from `generator`, or from `draws`, a
dict over the T-step grid: "init" (B, D), "em_noise" (T, B, D), "birth_noise"
(T, B, D), "u_jump" (T, B) for the single birth or "u_chain" (T, B, K) for the
chain, and with `sample_near_atom` "gumbel" (T, B, N), the noise added to the
nearest-atom logits before the argmax. The corrector's draws always come from
`generator`.

A context (the template state's `context_continuous`, `context_discrete`) is
observed, not sampled: every state of the walk is the template's with other
latents and dims, so the network sees the context at every evaluation (the
corrector's and the guidance's too) and the final state carries it unchanged.

Reconstruction guidance (`do_conditioning` with a `Condition`, JAX
:238-303): at every network evaluation the x0 prediction's error on the
observed entries, projected into the observed state's geometry, is
differentiated through the network's module path with respect to the
latents (`guidance`), and the score is formed from the x0 prediction moved
by that gradient and held at the observed values. Like JAX's conditioned
branch, which differentiates through flax, it launches no kernel: the
kernels are forward-only.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_particles_tpu_torch.models.generative.diffusion.noising import (
    analytic_x0_dim_logits,
    get_birth_rates_for_offsets,
)
from multimodal_particles_tpu_torch.models.generative.transdimensional.structure import (
    StructuredState,
    adjust_state,
)

TINY = float(torch.finfo(torch.float32).tiny)


def sample_birth_chain(u, rates, dt):
    """The exact pure-birth chain over one interval with frozen per-level
    rates (sampler.py:76-97): level j waits Exp(rates[:, j]), and the number
    of births is how many cumulative waiting times fit inside dt. A zero rate
    at level j stops the chain there.

    u: (B, K) uniforms in (0, 1]; rates: (B, K) nonnegative; dt: a scalar or
    (B,) interval lengths → (B,) int32 birth counts in [0, K]."""
    dtau = torch.where(rates > 0.0, -torch.log(u) / torch.clamp(rates, min=1e-20), torch.inf)
    dt = torch.as_tensor(dt, device=rates.device)
    if dt.dim() == 1:
        dt = dt[:, None]
    return (torch.cumsum(dtau, dim=1) < dt).sum(dim=1).to(torch.int32)


def _build_time_grid(cfg):
    """The executed times with each step's dt, will-finish flag and
    corrector flag, and the finishing time (sampler.py:100-136)."""

    def get_dt(ts):
        if cfg.dt_schedule == "uniform":
            return cfg.dt
        if cfg.dt_schedule == "C":
            return cfg.dt_schedule_h if ts > cfg.dt_schedule_tc else cfg.dt_schedule_l
        raise NotImplementedError(cfg.dt_schedule)

    finish_at = cfg.dt / 2
    ts_list, dt_list, will_finish_list, corrector_on_list = [], [], [], []
    ts = 1.0
    while True:
        dt = get_dt(ts)
        ts_list.append(ts)
        dt_list.append(dt)
        will_finish_list.append(max(ts - dt, finish_at / 2) < finish_at)
        corrector_on_list.append(cfg.corrector_steps > 0 and ts < cfg.corrector_start_time
                                 and ts > cfg.corrector_finish_time)
        ts = max(ts - dt, finish_at / 2)
        if ts < finish_at:
            break
    return (np.asarray(ts_list, np.float32), np.asarray(dt_list, np.float32),
            np.asarray(will_finish_list, np.float32), np.asarray(corrector_on_list, bool),
            finish_at)


def _segments(flags):
    """Contiguous runs of a boolean array → [(start, end, value)]."""
    runs, start = [], 0
    for i in range(1, len(flags) + 1):
        if i == len(flags) or flags[i] != flags[start]:
            runs.append((start, i, bool(flags[start])))
            start = i
    return runs


@dataclass(frozen=True)
class Condition:
    """Observed-context conditioning data for reconstruction guidance: flat
    latents `lats` (B, D) holding the observed values, `mask` (B, D) 1.0 on
    the conditioned entries, `dims` (B,) of the conditioned state."""

    lats: torch.Tensor
    mask: torch.Tensor
    dims: torch.Tensor

    @classmethod
    def observe(cls, state: StructuredState, dims) -> "Condition":
        """The first `dims` (B,) rows of each jet of `state` observed, in the
        geometry the guidance compares in: the rows kept, the centre of mass
        taken over them (examples/conditional_generation_demo.py:76-84)."""
        dims = torch.as_tensor(dims, dtype=torch.int32, device=state.continuous.device)
        observed, _ = adjust_state(state.delete_dims(dims))
        mask = state.get_mask_flat(dims)
        return cls(lats=observed.get_flat_lats() * mask, mask=mask, dims=dims)


def guidance(model, state: StructuredState, t_b, condition: Condition, guidance_weight,
             sample_nearest_atom=False, generator=None, gumbel=None, with_rate=True):
    """The reconstruction-guidance term of one network evaluation
    (sampler.py:257-286): the network's module path under autograd, its x0
    prediction's observed entries projected into the condition's geometry
    (`set_flat_lats(mask · x0).delete_dims(condition.dims)`, centred), and
    w = Σ_b −½ · guidance_weight · α_t · Σ mask · (x0_c − lats)².

    Returns (w, dw/d(flat latents) (B, D), x0_pred, rate, (mean, std_raw),
    x0_dim_logits), all detached."""
    noise_schedule = model.noise_schedule
    with torch.enable_grad():
        x_flat = state.get_flat_lats().detach().requires_grad_(True)
        D_eps, rate, (mean, std_raw), x0_logits, _, _ = model.net_forward(
            state.set_flat_lats(x_flat), t_b, nearest_atom=None,
            sample_nearest_atom=sample_nearest_atom, generator=generator, gumbel=gumbel,
            predict="eps", with_rate=with_rate)
        x0_pred = noise_schedule.predict_x0_from_xt(x_flat, D_eps, t_b)
        observed, _ = adjust_state(
            state.set_flat_lats(condition.mask * x0_pred).delete_dims(condition.dims))
        l2 = (condition.mask * (observed.get_flat_lats() - condition.lats) ** 2).sum(dim=1)
        alpha_t = noise_schedule.get_p0t_stats(torch.ones_like(x_flat), t_b)[0][:, 0]
        weighted = (-0.5 * guidance_weight * alpha_t * l2).sum()
        (grad,) = torch.autograd.grad(weighted, x_flat)
    return (weighted.detach(), grad, x0_pred.detach(), None if rate is None else rate.detach(),
            (mean.detach(), std_raw.detach()), x0_logits.detach())


def _rows_broadcast(state: StructuredState, flat):
    """A flat array that is zero outside one row → that row's values on
    every row (the creation head emits one mean/std a jet, masked to the next
    row)."""
    B, N, Dc, V = state.B, state.N, state.Dc, state.V
    c = flat[:, : N * Dc].reshape(B, N, Dc).sum(dim=1)
    d = flat[:, N * Dc:].reshape(B, N, V).sum(dim=1)
    return torch.cat([c[:, None, :].expand(B, N, Dc).reshape(B, -1),
                      d[:, None, :].expand(B, N, V).reshape(B, -1)], dim=1)


@dataclass(frozen=True)
class JumpSampler:
    config: object  # SamplerKwargs

    @torch.no_grad()
    def sample(self, model, template_state: StructuredState, generator=None, draws=None,
               condition: Optional[Condition] = None, collect_diagnostics: bool = False,
               dims_prior_log_probs=None):
        """Sample from dims = 1, x ~ N(0, I). Returns (final_state, nfe), or
        (final_state, nfe, diag) with `collect_diagnostics`, where diag holds
        per-step scalars stacked over the time grid (ts, max_abs_x, mean_dims,
        birth_frac, rate_mean). `template_state` gives the shapes and the
        device. With `do_conditioning` in the config, `condition` (a
        `Condition`) steers every network evaluation by reconstruction
        guidance; either without the other raises ValueError."""
        cfg = self.config
        if cfg.do_conditioning and condition is None:
            raise ValueError(
                "do_conditioning=True requires a Condition (observed lats/mask/dims), "
                "e.g. Condition.observe(state, dims)"
            )
        if not cfg.do_conditioning and condition is not None:
            raise ValueError(
                "a Condition was supplied but config.sampler_kwargs.do_conditioning is False: "
                "the guidance would be skipped; set do_conditioning=True"
            )
        ts_arr, dt_arr, will_finish_arr, corrector_on_arr, finish_at = _build_time_grid(cfg)
        B, N = template_state.B, template_state.N
        D, device = template_state.flat_dim, template_state.continuous.device
        noise_schedule, forward_rate = model.noise_schedule, model.forward_rate
        K = max(int(getattr(cfg, "multi_birth", 1)), 1)
        x0_pred = bool(getattr(model.config.encoder, "rate_use_x0_pred", False))
        sample_near = bool(cfg.sample_near_atom)
        # the x0-prediction ladder of a multi-birth step replaces the network's own rate
        need_rate = K == 1 or not x0_pred or collect_diagnostics or cfg.corrector_steps > 0
        if dims_prior_log_probs is not None:
            dims_prior_log_probs = dims_prior_log_probs.to(device)
        # the weights do not change under the loop, so they are packed once; the
        # guided score runs the module path
        packed = (model.pack_for_kernel()
                  if condition is None and model._pallas_enabled(device) else None)

        def draw(name, step, shape, normal=True):
            if draws is not None:
                value = draws[name] if step is None else draws[name][step]
                return torch.as_tensor(value, dtype=torch.float32, device=device)
            make = torch.randn if normal else torch.rand
            return make(shape, generator=generator, device=device)

        def centred(noise, dims):
            noise_state, _ = adjust_state(template_state.set_flat_lats(noise).delete_dims(dims))
            return noise_state.get_flat_lats()

        def get_score(state, t_b, gumbel):
            """(score, rate, (mean, std_raw), x0_dim_logits): plain, or
            reconstruction-guided (sampler.py:238-303)."""
            xt = state.get_flat_lats()
            _, std_p0t = noise_schedule.get_p0t_stats(xt, t_b)
            if condition is None:
                eps_pred, rate_xt, mean_std, x0_logits, _, _ = model.net_forward(
                    state, t_b, nearest_atom=None, sample_nearest_atom=sample_near,
                    generator=generator, gumbel=gumbel, predict="eps", fused=True,
                    packed=packed, with_rate=need_rate)
            else:
                _, grad, x0, rate_xt, mean_std, x0_logits = guidance(
                    model, state, t_b, condition, cfg.guidance_weight, sample_near, generator,
                    gumbel, need_rate)
                x0_adjusted = condition.mask * condition.lats + (1.0 - condition.mask) * (
                    x0 + grad)
                adjusted, _ = adjust_state(
                    state.set_flat_lats(x0_adjusted).delete_dims(state.dims))
                eps_pred = noise_schedule.predict_eps_from_x0_xt(
                    xt, adjusted.get_flat_lats(), t_b)
            return -(1.0 / torch.clamp(std_p0t, min=0.001)) * eps_pred, rate_xt, mean_std, x0_logits

        def diffusion_and_jump(state, step, t_b, dt, will_finish, no_noise_gate):
            """One Euler-Maruyama + birth move; (new state, diagnostics)."""
            beta = state.convert_problem_dim_to_tensor_dim(noise_schedule.get_beta_t(t_b))
            gumbel = draw("gumbel", step, (B, N), normal=False) if (
                sample_near and draws is not None) else None
            score, rate_xt, (mean, std_raw), x0_logits = get_score(state, t_b, gumbel)

            mask = state.get_mask_flat()
            xt = state.get_flat_lats()
            xt = (2.0 - torch.sqrt(1.0 - beta * dt)) * xt + mask * beta * dt * score
            noise = centred(draw("em_noise", step, (B, D)), state.dims)
            noise_scale = 1.0 - no_noise_gate * will_finish  # no_noise_final_step
            xt = xt + noise_scale * mask * torch.sqrt(beta * dt) * noise
            state, _ = adjust_state(state.set_flat_lats(xt))

            if K > 1:
                if x0_pred:
                    if getattr(cfg, "analytic_dim1_posterior", False) and (
                            dims_prior_log_probs is not None):
                        analytic = analytic_x0_dim_logits(dims_prior_log_probs, state.dims,
                                                          forward_rate, t_b, N)
                        if getattr(cfg, "analytic_posterior_all_dims", True):
                            x0_logits = analytic
                        else:  # only the no-evidence dims == 1 rows
                            x0_logits = torch.where((state.dims == 1)[:, None], analytic, x0_logits)
                    rates = get_birth_rates_for_offsets(x0_logits, state.dims, K, forward_rate,
                                                        t_b, N)
                else:
                    cand = state.dims[:, None] + torch.arange(K, device=device)[None, :]
                    rates = torch.where(cand < N, rate_xt.expand(B, K), 0.0)
                chain_dt = dt
                if getattr(cfg, "exact_rate_integral", True):
                    # the exact time integral of the birth intensity over the
                    # step, the state-dependent factor frozen at its left end,
                    # as an effective dt: ∫ f/Λ = ln Λ(t) − ln Λ(t') with the
                    # x0 prediction, ∫ f = Λ(t) − Λ(t') with the direct head
                    t_next = torch.clamp(t_b - dt, min=finish_at / 2)
                    lam_t = forward_rate.get_rate_integral(t_b)
                    lam_next = forward_rate.get_rate_integral(t_next)
                    f_t = torch.clamp(forward_rate.get_rate(None, t_b), min=1e-20)
                    if x0_pred:
                        chain_dt = ((torch.log(lam_t) - torch.log(lam_next)) * lam_t / f_t).reshape(B)
                    else:
                        chain_dt = ((lam_t - lam_next) / f_t).reshape(B)
                u = draw("u_chain", step, (B, K), normal=False).clamp_min(TINY)
                births = sample_birth_chain(u, rates, chain_dt)
                new_dims = torch.clamp(state.dims + births, max=N)
                added_mask = state.get_mask_flat(new_dims) - mask
                # each new particle i.i.d. from N(mean, softplus(std_raw))
                mean_b = _rows_broadcast(state, mean)
                std_b = F.softplus(_rows_broadcast(state, std_raw))
                new_values = added_mask * (mean_b + draw("birth_noise", step, (B, D)) * std_b)
                xt = state.get_flat_lats() * (1.0 - added_mask) + new_values
                birth_stat = births.float().mean()
            else:
                u = draw("u_jump", step, (B,), normal=False)
                increase = (u < rate_xt[:, 0] * dt) & (state.dims < N)
                next_mask = state.get_next_dim_added_mask()
                new_values = next_mask * (mean + draw("birth_noise", step, (B, D))
                                          * F.softplus(std_raw))
                xt = state.get_flat_lats()
                xt = torch.where(increase[:, None], xt * (1.0 - next_mask) + new_values, xt)
                new_dims = state.dims + increase.to(torch.int32)
                birth_stat = increase.float().mean()

            if cfg.clip_lats is not None:
                xt = torch.clamp(xt, -cfg.clip_lats, cfg.clip_lats)
            state, _ = adjust_state(state.set_flat_lats(xt).delete_dims(new_dims))
            diag = {"birth_frac": birth_stat, "rate_mean": rate_xt[:, 0].mean()} if (
                collect_diagnostics) else None
            return state, diag

        def corrector_move(state, t_b, dt, will_finish):
            """Langevin corrector and the optional jump corrector, a birth
            and a death (sampler.py:495-558)."""
            beta = state.convert_problem_dim_to_tensor_dim(noise_schedule.get_beta_t(t_b))
            score, rate_xt, (mean, std_raw), _ = get_score(state, t_b, None)
            mask = state.get_mask_flat()
            xt = state.get_flat_lats()
            noise = centred(torch.randn((B, D), generator=generator, device=device), state.dims)
            grad_norm = torch.linalg.vector_norm(score, dim=-1).mean()
            noise_norm = torch.linalg.vector_norm(noise, dim=-1).mean()
            alpha = 1.0 - dt * beta
            step_size = (cfg.corrector_snr * noise_norm / torch.clamp(grad_norm, min=1e-12)) ** 2 \
                * 2 * alpha
            noise_gate = 1.0 - (1.0 if cfg.no_noise_final_step else 0.0) * will_finish
            xt = xt + mask * (step_size * score + noise_gate * torch.sqrt(2.0 * step_size) * noise)
            state, _ = adjust_state(state.set_flat_lats(xt))

            if cfg.do_jump_corrector:
                u_b = torch.rand((B,), generator=generator, device=device)
                increase = (u_b < rate_xt[:, 0] * dt) & (state.dims < N)
                next_mask = state.get_next_dim_added_mask()
                birth = torch.randn((B, D), generator=generator, device=device)
                new_values = next_mask * (mean + birth * F.softplus(std_raw))
                xt = state.get_flat_lats()
                xt = torch.where(increase[:, None], xt * (1.0 - next_mask) + new_values, xt)
                state = state.set_flat_lats(xt).replace(dims=state.dims + increase.to(torch.int32))

                u_d = torch.rand((B,), generator=generator, device=device)
                decrease = (u_d < forward_rate.get_rate(None, t_b) * dt) & (state.dims > 1)
                state, _ = adjust_state(state.delete_dims(state.dims - decrease.to(torch.int32)))
            return state

        # --- init: x_T ~ N(0, I) flat, dims = 1, centred
        num_dims = torch.ones((B,), dtype=torch.int32, device=device)
        state, _ = adjust_state(
            template_state.set_flat_lats(draw("init", None, (B, D))).delete_dims(num_dims))

        no_noise_gate = 1.0 if cfg.no_noise_final_step and cfg.corrector_steps == 0 else 0.0
        nfe, diags = 0, []
        for seg_start, seg_end, has_corrector in _segments(corrector_on_arr):
            for step in range(seg_start, seg_end):
                t, dt, will_finish = (float(ts_arr[step]), float(dt_arr[step]),
                                      float(will_finish_arr[step]))
                t_b = torch.full((B,), t, dtype=torch.float32, device=device)
                state, diag = diffusion_and_jump(state, step, t_b, dt, will_finish, no_noise_gate)
                if has_corrector:
                    for _ in range(cfg.corrector_steps):
                        state = corrector_move(state, t_b - dt, dt, will_finish)
                if collect_diagnostics:
                    live = state.get_flat_lats() * state.get_mask_flat()
                    diags.append({"max_abs_x": live.abs().max(),
                                  "mean_dims": state.dims.float().mean(), **diag})
            nfe += (seg_end - seg_start) * (1 + (cfg.corrector_steps if has_corrector else 0))

        if collect_diagnostics:
            diag = {name: torch.stack([d[name] for d in diags]) for name in diags[0]}
            diag["ts"] = torch.from_numpy(ts_arr)
            return state, nfe, diag
        return state, nfe
