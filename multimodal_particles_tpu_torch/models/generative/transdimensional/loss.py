"""Jump-diffusion training loss, `JumpLossFinalDim`
(multimodal_particles_tpu/models/generative/transdimensional/loss.py:31-218).

Forward-rate Poisson dimension deletion and VP noising (`add_noise`), two
network passes (x_t and the delete-one-dim batch), and the weighted sum of
score matching, the birth-rate loss rate(x_t) − f·log rate(del x_t), the
creation Gaussian NLL on the deleted particle, the x0-dimension cross-entropy
and the nearest-atom cross-entropy. Rows with a non-finite term get weight 0
and the mean runs over the valid rows. The batch's contexts ride on every
corrupted state (they are not latents), so both network passes see them.
"""

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from multimodal_particles_tpu_torch.parallel import spmd
from multimodal_particles_tpu_torch.models.generative.transdimensional.structure import (
    StructuredState,
    adjust_state,
    get_auto_target,
    get_nearest_atom,
)


def corrupt_with(state: StructuredState, noise_schedule, ts, dims_xt, noise_raw):
    """The corruption given its draws: delete dims down to dims_xt, centre,
    then VP-noise the survivors with noise_raw (loss.py:31-52).

    Returns (noised_state, ts, x0_dims, dims_xt, noise_flat, x_flat, std)."""
    x0_dims = state.dims
    state, _ = adjust_state(state.delete_dims(dims_xt))
    x = state.get_flat_lats()
    mean, std = noise_schedule.get_p0t_stats(x, ts)

    noise_state, _ = adjust_state(state.set_flat_lats(noise_raw).delete_dims(dims_xt))
    noise = noise_state.get_flat_lats()

    state, _ = adjust_state(state.set_flat_lats(mean + std * noise).delete_dims(dims_xt))
    return state, ts, x0_dims, dims_xt, noise, x, std


def add_noise(state: StructuredState, noise_schedule, forward_rate, min_t, generator=None,
              draws=None):
    """Forward corruption (loss.py:55-66): t = min_t + (1 − min_t)·u, dims by
    Poisson deletion, then `corrupt_with`. `draws` = (u (B,), deleted (B,)
    Poisson counts, noise_raw (B, D)) replaces the draws from `generator`.
    Under spmd.global_batch the draws are the global batch's, this rank's
    rows kept."""
    B, device = state.B, state.continuous.device
    if draws is None:
        u = torch.rand((spmd.rows(B),), generator=generator, device=device)
        deleted = None
        noise_raw = torch.randn((spmd.rows(B), state.flat_dim), generator=generator,
                                device=device)
        if spmd.active():
            # the global batch's deletion counts from its times, this rank's rows kept
            ts = min_t + (1.0 - min_t) * u.to(torch.float32)
            deleted = spmd.local(torch.poisson(
                forward_rate.get_rate_integral(ts).to(torch.float32), generator=generator))
            u, noise_raw = spmd.local(u), spmd.local(noise_raw)
    else:
        u, deleted, noise_raw = (d.to(device) for d in draws)
    ts = min_t + (1.0 - min_t) * u.to(torch.float32)
    dims_xt = forward_rate.get_dims_at_t(state.dims, ts, generator=generator, deleted=deleted)
    return corrupt_with(state, noise_schedule, ts, dims_xt, noise_raw.to(torch.float32))


@dataclass(frozen=True)
class JumpLossFinalDim:
    forward_rate: object
    noise_schedule: object
    min_t: float
    loss_type: str
    x0_logit_ce_loss_weight: float
    rate_loss_weight: float
    score_loss_weight: float
    auto_loss_weight: float
    mean_or_sum_over_dim: str
    nearest_atom_pred: bool
    nearest_atom_loss_weight: float
    # "dims" divides the score error by the full flat dimension; "live" by
    # each jet's live-entry count, so that jets of few particles keep their
    # gradient weight
    score_loss_normalization: str = "dims"

    def __call__(self, model, st_state: StructuredState, generator=None, draws=None):
        return self.compute(model, add_noise(st_state, self.noise_schedule, self.forward_rate,
                                             self.min_t, generator, draws))

    def compute(self, model, corrupted):
        """The loss given the `corrupt_with`/`add_noise` output: both network
        passes and every term (loss.py:96-218) → (loss, components)."""
        st_state, ts, x0_dims, dims_xt, noise, x, std_p0t = corrupted
        B, max_dim = st_state.B, st_state.N
        to_predict = {"eps": "eps", "x0": "x0", "edm": "x0"}[self.loss_type]

        # --- first network pass, on x_t
        D_xt, rate_xt, _, x0_dim_logits, _, _ = model.net_forward(st_state, ts, predict=to_predict)
        log_probs = F.log_softmax(x0_dim_logits, dim=1)
        ce_loss = -torch.gather(log_probs, 1, (x0_dims - 1)[:, None].long())[:, 0]  # dims are 1-based

        D_mask = st_state.get_mask_flat()
        D_xt = D_xt * D_mask

        # --- second network pass, on the delete-one-dim batch
        delxt_state = st_state.delete_one_dim()
        nearest_atom = get_nearest_atom(st_state, delxt_state)
        delxt_state, adjust_val = adjust_state(delxt_state)
        _, rate_delxt, mean_std, _, near_atom_logits, _ = model.net_forward(
            delxt_state, ts, nearest_atom=nearest_atom, predict=to_predict)

        # --- score matching
        target = {"eps": noise, "x0": x}[to_predict]
        score_loss = 0.5 * D_mask * (D_xt - target) ** 2  # (B, D)
        if self.loss_type == "edm":
            ve_sigma = std_p0t / torch.sqrt(1.0 - std_p0t**2)
            score_loss = score_loss * (ve_sigma**2 + 1.0) / ve_sigma**2
        if self.score_loss_normalization == "live":
            live = torch.clamp(D_mask.sum(dim=1, keepdim=True), min=1.0)
            score_loss = score_loss * (D_mask.shape[1] / live)
        elif self.score_loss_normalization != "dims":
            raise ValueError(self.score_loss_normalization)

        # --- rate loss
        f_rate_vs_t = self.forward_rate.get_rate(dims_xt, ts)  # (B,)
        rate_loss = (dims_xt < max_dim) * rate_xt[:, 0] - (
            dims_xt > 1
        ) * f_rate_vs_t * torch.log(rate_delxt[:, 0] + 1e-12)

        # --- creation (auto) loss on the deleted particle
        final_dim_mask = st_state.get_next_dim_deleted_mask()
        mean, std = mean_std[0], F.softplus(mean_std[1])
        auto_target = get_auto_target(st_state, adjust_val)
        gauss_ll = final_dim_mask * (
            -torch.log(std + 1e-20) - 0.5 * (auto_target - mean) ** 2 / (std**2 + 1e-20)
        )
        auto_loss = -f_rate_vs_t * (dims_xt > 1) * gauss_ll.sum(dim=1)

        # --- nearest-atom cross-entropy
        if self.nearest_atom_pred:
            na_log_probs = F.log_softmax(near_atom_logits, dim=1)
            na_ce = -torch.gather(na_log_probs, 1, nearest_atom[:, None].long())[:, 0]
            nearest_atom_loss = (dims_xt > 1) * na_ce
        else:
            nearest_atom_loss = torch.zeros_like(rate_loss)

        def row_finite(t):
            return torch.isfinite(t.reshape(B, -1)).all(dim=1)

        valid = (row_finite(rate_delxt) & row_finite(mean) & row_finite(mean_std[1])
                 & row_finite(near_atom_logits) & row_finite(score_loss))
        valid_f = valid.to(score_loss.dtype)

        D = x.shape[1]
        per_elem = (
            self.score_loss_weight * score_loss
            + (self.rate_loss_weight / D) * rate_loss[:, None]
            + (self.auto_loss_weight / D) * auto_loss[:, None]
            + (self.x0_logit_ce_loss_weight / D) * ce_loss[:, None]
            + (self.nearest_atom_loss_weight / D) * nearest_atom_loss[:, None]
        )  # (B, D)
        if self.mean_or_sum_over_dim == "mean":
            per_sample = per_elem.sum(dim=1) / D
        elif self.mean_or_sum_over_dim == "sum":
            per_sample = per_elem.sum(dim=1)
        else:
            raise ValueError(self.mean_or_sum_over_dim)

        denom = torch.clamp(spmd.total(valid_f.sum()), min=1.0)

        def valid_mean(rows):
            return (rows * valid_f).sum() / denom

        loss = valid_mean(per_sample)
        components = {
            "score_loss": valid_mean(score_loss.sum(dim=1)),
            "rate_loss": valid_mean(rate_loss),
            "auto_loss": valid_mean(auto_loss),
            "ce_loss": valid_mean(ce_loss),
            "nearest_atom_loss": valid_mean(nearest_atom_loss),
            "max_rate_xt": rate_xt.max(),
            "min_rate_delxt": rate_delxt.min(),
            "min_auto_std": std.min(),
            "max_auto_L2": ((auto_target - mean) ** 2).max(),
            "num_valid": valid_f.sum(),
        }
        return loss, components
