"""Transdimensional jump diffusion: a VP-SDE score diffusion over a latent
whose dimensionality itself jumps, particles deleted forward in time and
created in reverse
(multimodal_particles_tpu/models/generative/transdimensional/transdimensional_model.py:40-705).

`TransdimensionalEPiC` is the network over the fixed-shape `StructuredState`:
an EPiC trunk, then two transformer stacks over the trunk's hidden state, one
for the birth rate (x0-dimension logits) and the nearest-atom logits, one for
the new particle's mean and std. `TransdimensionalJumpDiffusion` adds the
eps/x0 preconditioning and the reverse rate (`net_forward`), the training loss
(`loss_fn`) and the sampler (`sample`, `predict`).

Training runs the modules under autograd, as the JAX package's `loss_fn` runs
flax: it has no hand-written kernel on this path. Sampling, with the kernel
gate on, is three launches a network evaluation: the fused EPiC trunk with the
Linear-discrete input and its hidden output (ops/epic_cuda.py; at every width
128 the wide one of ops/epic_wide_cuda.py) and the fused gsdm stack twice
(ops/gsdm_stack_cuda.py); the small head projections between
and after them stay plain PyTorch, as they stay XLA in JAX. Randomness is an
input throughout: every draw comes from a caller's generator or is injected
as tensors.

A context (`data.dim_context_continuous`, `data.dim_context_discrete`) is
observed, not latent: the state carries it beside the latents, every network
evaluation feeds it to the EPiC trunk's global context (JAX
transdimensional_model.py:130-138), and the sampler and the loss pass it on
unchanged. The discrete context is read as the 'list' loader delivers it,
the one-hot of the first token (B, vocab_size_context), each entry embedded
as a token, as JAX's flax module does with the loader's batches
(jets_dataloader.py:94-95). No trunk kernel takes a context, so with one the
kernel gate is off for the gsdm stacks too, as JAX's `_pallas_enabled` is.
"""

import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from multimodal_particles_tpu_torch.models.architectures.epic import EPiCWrapper
from multimodal_particles_tpu_torch.models.architectures.gsdm import AttnBlock, ResnetBlock
from multimodal_particles_tpu_torch.models.architectures.utils import get_timestep_embedding
from multimodal_particles_tpu_torch.models.generative.diffusion.noising import (
    get_forward_rate,
    get_noise_schedule,
    get_rate_using_x0_pred,
)
from multimodal_particles_tpu_torch.models.generative.transdimensional.loss import (
    JumpLossFinalDim,
    add_noise,
)
from multimodal_particles_tpu_torch.models.generative.transdimensional.sampler import JumpSampler
from multimodal_particles_tpu_torch.models.generative.transdimensional.structure import (
    DistributionNodes,
    StructuredState,
    state_from_list_batch,
)
from multimodal_particles_tpu_torch.ops.epic_cuda import (
    epic_forward,
    epic_supported,
    pack_bare_trunk_params,
    with_narrow_buffer,
)
from multimodal_particles_tpu_torch.ops.epic_wide_cuda import epic_forward_wide, wide_supported
from multimodal_particles_tpu_torch.ops.gsdm_stack_cuda import (
    gsdm_stack,
    gsdm_stack_supported,
    pack_gsdm_stack_params,
    stack_time_embeddings,
)

LOSS_KWARGS = (
    "min_t", "loss_type", "x0_logit_ce_loss_weight", "rate_loss_weight", "score_loss_weight",
    "auto_loss_weight", "mean_or_sum_over_dim", "nearest_atom_pred", "nearest_atom_loss_weight",
    "score_loss_normalization",
)


def sample_gumbel(shape, generator, device):
    """Standard Gumbel noise −log(−log u): argmax(logits + it) is a draw from
    softmax(logits)."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(tiny, 1.0 - 2.0**-24)))


class TransdimensionalEPiC(nn.Module):
    """EPiC trunk + D_xt / rate / nearest-atom / creation heads
    (transdimensional_model.py:40-227). Submodules carry the flax names."""

    def __init__(self, config):
        super().__init__()
        cfg_d, enc = config.data, config.encoder
        self.config = config
        self.Dc, self.V = cfg_d.dim_features_continuous, cfg_d.vocab_size_features
        self.linear_discrete = enc.embedding_features_discrete == "Linear"
        # the 'list' batches carry the discrete context as the one-hot of its
        # first token: vocab_size_context tokens of 0 or 1 a jet
        context_tokens = cfg_d.vocab_size_context if cfg_d.dim_context_discrete else 0
        self.epic = EPiCWrapper(config, discrete_channel_values=True,
                                context_tokens=context_tokens)

        C = self.transformer_dim = self.temb_dim = enc.transformer_dim
        self.n_attn_blocks = enc.n_attn_blocks
        rdim = cfg_d.max_num_particles if enc.rate_use_x0_pred else 1
        stack_in = enc.dim_hidden_local + self.V

        self.temb_net = nn.Linear(C, C)
        self.transformer_1_proj_in = nn.Linear(stack_in, C)
        self.vec_transformer_in_proj = nn.Linear(stack_in + 1 + 2, C)
        for prefix in ("", "vec_"):
            for i in range(enc.n_attn_blocks):
                self.add_module(f"{prefix}attn_{i}", AttnBlock(C, n_heads=enc.n_heads))
                self.add_module(f"{prefix}res_{i}", ResnetBlock(C, dropout=0.0, temb_channels=C))
        self.pre_rate_proj = nn.Linear(C, C)
        self.post_rate_proj = nn.Linear(C, rdim)
        self.near_atom_proj = nn.Linear(C, 1)
        self.vec_weighting_proj = nn.Linear(C, 1)
        self.pre_auto_proj = nn.Linear(C, C)
        self.post_auto_proj = nn.Linear(C, 2 * self.V + 1)

    def blocks(self, prefix: str = ""):
        """([ResnetBlock], [AttnBlock]) of the rate stack ('') or the creation
        stack ('vec_')."""
        return ([getattr(self, f"{prefix}res_{i}") for i in range(self.n_attn_blocks)],
                [getattr(self, f"{prefix}attn_{i}") for i in range(self.n_attn_blocks)])

    # Each piece below is used by `forward` (the module path) and by
    # `TransdimensionalJumpDiffusion.forward_kernel` (the kernel path).

    def trunk_input(self, state: StructuredState):
        """The trunk's discrete input: the noisy one-hot channel values the
        network must denoise (Linear), or the argmax token (Embedding)."""
        if self.linear_discrete:
            return state.discrete
        return torch.argmax(state.discrete, dim=-1)[..., None]

    def flat_score(self, net_out):
        """(B, N, Dc+V) trunk output → flat [continuous | discrete]."""
        B = net_out.shape[0]
        return torch.cat([net_out[:, :, : self.Dc].reshape(B, -1),
                          net_out[:, :, self.Dc:].reshape(B, -1)], dim=1)

    def time_embedding(self, ts):
        return self.temb_net(get_timestep_embedding(ts * 1000.0, self.temb_dim))  # (B, C)

    def rate_outputs(self, h):
        """The rate stack's hidden state (B, N, C) → (rate_emb (B, rdim),
        near_atom_logits (B, N))."""
        rate_emb = self.post_rate_proj(self.pre_rate_proj(h).mean(dim=1))
        return rate_emb, self.near_atom_proj(h)[:, :, 0]

    def creation_input(self, state, net_last_layer, nearest_atom, node_mask):
        """[hidden ‖ values ‖ distance to the nearest atom ‖ one-hot(is it)]
        masked, (B, N, H+V+3), and the nearest atom's position (B, Dc)."""
        x = state.continuous
        batch_idx = torch.arange(state.B, device=x.device)
        nearest_pos = x[batch_idx, nearest_atom, :]
        distances = torch.sqrt(((nearest_pos[:, None, :] - x) ** 2).sum(dim=-1, keepdim=True))
        # a comparison, not F.one_hot, which reads its argument's range back to the host
        slots = torch.arange(state.N, device=x.device)
        is_nearest = (slots[None, :] == nearest_atom[:, None]).to(x.dtype)[:, :, None]
        vec_in = torch.cat([net_last_layer, state.discrete, distances, is_nearest,
                            1.0 - is_nearest], dim=-1)
        return vec_in * node_mask, nearest_pos

    def creation_outputs(self, state, h_vec, nearest_pos, node_mask):
        """The creation stack's hidden state → (auto_mean, auto_std) flat,
        one per jet broadcast over the rows and masked to the next row."""
        B, N, V, x = state.B, state.N, self.V, state.continuous
        vec_weights = self.vec_weighting_proj(h_vec)  # (B, N, 1)
        vectors = (nearest_pos[:, None, :] - x) * node_mask
        vectors = vectors / (torch.sqrt((vectors**2).sum(dim=-1, keepdim=True)) + 1e-3)
        auto_pos_mean = nearest_pos + (vec_weights * vectors).sum(dim=1)  # (B, Dc)

        post_auto_h = self.post_auto_proj(self.pre_auto_proj(h_vec).mean(dim=1))  # (B, 2V+1)
        pos_std = post_auto_h[:, 0:1].expand(B, self.Dc)
        atom_type_mean = post_auto_h[:, 1: 1 + V]
        atom_type_std = post_auto_h[:, 1 + V: 1 + 2 * V]

        def rows(cont, disc):
            return torch.cat([cont[:, None, :].expand(B, N, self.Dc).reshape(B, -1),
                              disc[:, None, :].expand(B, N, V).reshape(B, -1)], dim=1)

        auto_mask = state.get_next_dim_added_mask()
        return (auto_mask * rows(auto_pos_mean, atom_type_mean),
                auto_mask * rows(pos_std, atom_type_std))

    def forward(self, state: StructuredState, ts, nearest_atom, sample_nearest_atom=False,
                generator=None, gumbel=None):
        """Returns (D_xt, rate_emb, near_atom_logits, auto_mean, auto_std,
        nearest_atom_used). `rate_emb` is the x0-dimension logits (B, N) with
        rate_use_x0_pred, else a raw scalar (B, 1). With `sample_nearest_atom`
        the nearest atom is argmax(logits + Gumbel noise), the noise `gumbel`
        (B, N) or drawn from `generator`."""
        node_mask = state.particle_mask()[:, :, None]
        net_out, net_last_layer = self.epic(ts.reshape(state.B, 1, 1), state.continuous,
                                            self.trunk_input(state), node_mask,
                                            state.context_continuous, state.context_discrete,
                                            output_hidden_local=True)
        if self.config.encoder.detach_last_layer:
            net_last_layer = net_last_layer.detach()
        temb = self.time_embedding(ts)

        h = self.transformer_1_proj_in(torch.cat([net_last_layer, state.discrete], dim=-1))
        for res, att in zip(*self.blocks()):
            h = att(res(h, temb))
        rate_emb, near_atom_logits = self.rate_outputs(h)
        nearest_atom = pick_nearest_atom(near_atom_logits, nearest_atom, sample_nearest_atom,
                                         generator, gumbel)

        vec_in, nearest_pos = self.creation_input(state, net_last_layer, nearest_atom, node_mask)
        h_vec = self.vec_transformer_in_proj(vec_in)
        for res, att in zip(*self.blocks("vec_")):
            h_vec = att(res(h_vec, temb))
        auto_mean, auto_std = self.creation_outputs(state, h_vec, nearest_pos, node_mask)
        return (self.flat_score(net_out), rate_emb, near_atom_logits, auto_mean, auto_std,
                nearest_atom)


def pick_nearest_atom(near_atom_logits, nearest_atom, sample: bool, generator, gumbel):
    """The given nearest atom, or a draw from softmax(logits) over all N
    slots as argmax(logits + Gumbel noise)."""
    if sample:
        if gumbel is None:
            gumbel = sample_gumbel(near_atom_logits.shape, generator, near_atom_logits.device)
        nearest_atom = torch.argmax(near_atom_logits + gumbel.to(near_atom_logits.device), dim=1)
    return nearest_atom.long()


class TransdimensionalJumpDiffusion(nn.Module):
    """Jump-diffusion model over particle clouds of variable multiplicity
    (transdimensional_model.py:230-705)."""

    # the loss's metrics that are extremes over the batch: a data-parallel
    # trainer reduces them so, and sums the others (parallel/spmd.py)
    metric_reductions = {"max_rate_xt": "max", "min_rate_delxt": "min",
                         "min_auto_std": "min", "max_auto_L2": "max"}

    def __init__(self, config, datamodule=None):
        super().__init__()
        # the JAX model never reads `parallel.compute_dtype`: it computes in
        # float32 whatever the config says, and so does this one
        self.config = config
        self.network = TransdimensionalEPiC(config)
        lk = config.loss_kwargs
        N = config.data.max_num_particles
        self.forward_rate = get_forward_rate(lk.rate_function_name, N, lk.rate_cut_t)
        self.noise_schedule = get_noise_schedule(lk.noise_schedule_name, N, lk.vp_sde_beta_min,
                                                 lk.vp_sde_beta_max)
        # an object with `nodes_dist` (a DistributionNodes): the multiplicity
        # prior of the sampler's analytic posterior
        self.graphical_structure = getattr(datamodule, "graphical_structure", None)
        self.jump_diffusion_loss = JumpLossFinalDim(
            forward_rate=self.forward_rate, noise_schedule=self.noise_schedule,
            **{k: getattr(lk, k) for k in LOSS_KWARGS},
        )
        self.sampler = JumpSampler(config.sampler_kwargs)

    @staticmethod
    def _as_state(batch) -> StructuredState:
        return batch if isinstance(batch, StructuredState) else state_from_list_batch(batch)

    # ---------------------------------------------------------------- forward

    def _pallas_enabled(self, device) -> bool:
        """The sampling path's kernel gate (transdimensional_model.py:302-337):
        `parallel.use_pallas` False → off; 'auto' → on for CUDA devices when
        the heads match the gsdm stack kernel and the trunk's embedding
        pattern is one the EPiC kernels cover; True → on when they match. On a
        CPU device the kernel wrappers run their plain versions."""
        flag = self.config.parallel.use_pallas
        if flag is False:
            return False
        supported = gsdm_stack_supported(self.config) and self.kernel_refusal() is None
        if flag == "auto":
            return supported and torch.device(device).type == "cuda"
        return bool(flag) and supported

    def kernel_refusal(self):
        """Why no trunk kernel takes this config, or None when one does. A
        context turns off JAX's trunk pattern (`epic_pattern_supported`), and
        with it the whole fused path."""
        d = self.config.data
        if d.dim_context_continuous or d.dim_context_discrete:
            return ("a context: no trunk kernel takes one (JAX's epic_pattern_supported is "
                    "False), so the network runs its modules, the gsdm stacks too")
        if self._trunk_layout() is None:
            return "no trunk kernel takes this encoder (see `_pallas_enabled`)"
        return None

    def _trunk_layout(self):
        """The trunk's kernel (transdimensional_model.py:325-337): "wide" at
        the widths 128 to 512 and jets of up to 256 slots of
        `wide_supported`, "narrow" at any hidden
        width up to 64 (zero-padded to one of K1's instances,
        `epic_supported`), None when neither takes it."""
        if wide_supported(self.config, allow_linear_discrete=True):
            return "wide"
        if epic_supported(self.config, allow_linear_discrete=True):
            return "narrow"
        return None

    def pack_for_kernel(self):
        """(packed trunk, packed rate stack, packed creation stack) of the
        current weights, detached: what `forward_kernel` reads."""
        refusal = self.kernel_refusal()
        if refusal is not None:
            raise ValueError(refusal)
        layout = self._trunk_layout()
        net = self.network
        trunk = pack_bare_trunk_params(net, self.config, fold_discrete=net.linear_discrete,
                                       layout=layout)
        if layout == "narrow":  # the forward kernel's tensor-core buffer
            trunk = with_narrow_buffer(trunk)
        return (trunk,
                pack_gsdm_stack_params(net.transformer_1_proj_in, *net.blocks()),
                pack_gsdm_stack_params(net.vec_transformer_in_proj, *net.blocks("vec_")))

    @torch.no_grad()
    def forward_kernel(self, state: StructuredState, ts, nearest_atom, sample_nearest_atom=False,
                       generator=None, gumbel=None, packed=None):
        """The network through its kernels, the counterpart of
        `_network_fused` (transdimensional_model.py:339-524): the fused EPiC
        trunk, then the two fused gsdm stacks; what `TransdimensionalEPiC.
        forward` returns. Sampling only: no gradient. `packed` is a packing
        of the current weights to reuse (`pack_for_kernel`)."""
        net, enc = self.network, self.config.encoder
        refusal = self.kernel_refusal()
        if refusal is not None:
            raise ValueError(refusal)
        trunk, rate_stack, vec_stack = packed if packed is not None else self.pack_for_kernel()
        node_mask = state.particle_mask()[:, :, None]
        trunk_fn = epic_forward_wide if trunk.layout == "wide" else epic_forward
        net_out, net_last_layer = trunk_fn(
            trunk, ts.reshape(state.B, 1, 1).contiguous(), state.continuous.contiguous(),
            net.trunk_input(state).contiguous(), node_mask, output_hidden_local=True)
        temb = net.time_embedding(ts)

        h = gsdm_stack(rate_stack, stack_time_embeddings(temb, net.blocks()[0]),
                       torch.cat([net_last_layer, state.discrete], dim=-1), n_heads=enc.n_heads)
        rate_emb, near_atom_logits = net.rate_outputs(h)
        nearest_atom = pick_nearest_atom(near_atom_logits, nearest_atom, sample_nearest_atom,
                                         generator, gumbel)

        vec_in, nearest_pos = net.creation_input(state, net_last_layer, nearest_atom, node_mask)
        h_vec = gsdm_stack(vec_stack, stack_time_embeddings(temb, net.blocks("vec_")[0]),
                           vec_in.contiguous(), n_heads=enc.n_heads)
        auto_mean, auto_std = net.creation_outputs(state, h_vec, nearest_pos, node_mask)
        return (net.flat_score(net_out), rate_emb, near_atom_logits, auto_mean, auto_std,
                nearest_atom)

    def net_forward(self, state: StructuredState, ts, nearest_atom=None,
                    sample_nearest_atom=False, generator=None, gumbel=None, predict="eps",
                    fused=False, packed=None, with_rate=True):
        """Network + eps/x0 preconditioning + the reverse rate
        (transdimensional_model.py:526-601).

        Returns (D, rate (B,1), (auto_mean, auto_std_raw), x0_dim_logits,
        near_atom_logits, nearest_atom_used). `fused` takes the kernel path
        when the gate is on for the state's device: forward only, so the
        sampler asks for it and the loss never does. Without `with_rate` the
        rate is None: the multi-birth sampler computes its own rate ladder and
        reads this one only for its diagnostics (under jit the JAX package
        drops the unused computation; eager PyTorch has to be told)."""
        B = state.B
        if nearest_atom is None:
            nearest_atom = torch.zeros((B,), dtype=torch.long, device=state.continuous.device)
        forward = (self.forward_kernel if fused and self._pallas_enabled(state.continuous.device)
                   else self.network)
        extra = {"packed": packed} if forward is not self.network else {}
        D_eps, rate_emb, near_atom_logits, auto_mean, auto_std, nearest_used = forward(
            state, ts, nearest_atom, sample_nearest_atom, generator, gumbel, **extra)

        max_dim = self.config.data.max_num_particles
        if self.config.encoder.rate_use_x0_pred:
            x0_dim_logits = rate_emb
            rate_out = get_rate_using_x0_pred(
                x0_dim_logits=x0_dim_logits, xt_dims=state.dims, forward_rate=self.forward_rate,
                ts=ts, max_dim=max_dim,
            ).reshape(-1, 1) if with_rate else None
        else:
            x0_dim_logits = torch.zeros((B, max_dim), device=rate_emb.device)
            rate_out = F.softplus(rate_emb) * self.forward_rate.get_rate(None, ts).reshape(B, 1)

        if predict == "eps":
            D = D_eps
        elif predict == "x0":
            D = self.noise_schedule.predict_x0_from_xt(state.get_flat_lats(), D_eps, ts)
        else:
            raise NotImplementedError(f"predict {predict!r}")
        return D, rate_out, (auto_mean, auto_std), x0_dim_logits, near_atom_logits, nearest_used

    # ------------------------------------------------------------------ loss

    def loss_fn(self, batch, generator=None, draws=None):
        """Trainer-compatible loss over a 'list' databatch → (loss, metrics),
        the metrics detached. `draws` = (t01 (B,) uniforms behind the times,
        deleted (B,) Poisson deletion counts, noise_raw (B, D) normals)
        replaces the draws from `generator`."""
        state = self._as_state(batch)
        with record_function("transdim.add_noise"):
            corrupted = add_noise(state, self.noise_schedule, self.forward_rate,
                                  self.jump_diffusion_loss.min_t, generator, draws)
        with record_function("transdim.loss"):
            loss, components = self.jump_diffusion_loss.compute(self, corrupted)
        return loss, {"loss": loss.detach(), **{k: v.detach() for k, v in components.items()}}

    # -------------------------------------------------------------- sampling

    @torch.no_grad()
    def sample(self, template_state: StructuredState, generator=None, draws=None, condition=None,
               collect_diagnostics=False):
        """Reverse-time jump-diffusion sampling from dims = 1, x ~ N(0, I):
        (final_state, nfe), with `collect_diagnostics` also the per-step
        trajectory scalars; `condition` with `sampler_kwargs.do_conditioning`
        for reconstruction guidance (see JumpSampler.sample)."""
        return self.sampler.sample(
            self, template_state, generator=generator, draws=draws, condition=condition,
            collect_diagnostics=collect_diagnostics,
            dims_prior_log_probs=self._dims_prior_log_probs(template_state.N),
        )

    def _dims_prior_log_probs(self, max_dim: int):
        """The log multiplicity prior on the grid 1..max_dim for the sampler's
        analytic posterior (SamplerKwargs.analytic_dim1_posterior); None when
        the feature is off or there is no prior source
        (transdimensional_model.py:630-699).

        The prior comes from (1) `graphical_structure.nodes_dist` when one is
        attached, else (2) the config's training multiplicity histogram,
        data.target_info["hist_num_particles"]; with neither, a UserWarning
        says that the trained x0-dimension classifier is used instead.
        `analytic_prior_smoothing_sigma` > 0 smooths the histogram with a
        Gaussian kernel of that many particles."""
        sk = self.config.sampler_kwargs
        if not getattr(sk, "analytic_dim1_posterior", False):
            return None
        nd = getattr(self.graphical_structure, "nodes_dist", None)
        if nd is None:
            hist = (getattr(self.config.data, "target_info", None) or {}).get("hist_num_particles")
            if hist:
                nd = DistributionNodes({int(k): float(v) for k, v in dict(hist).items()})
        if nd is None:
            warnings.warn(
                "sampler_kwargs.analytic_dim1_posterior=True but the model has neither a "
                "graphical_structure.nodes_dist nor data.target_info['hist_num_particles'] in "
                "its config: falling back to the trained x0-dim classifier at dims=1, which is "
                "biased low. Attach a multiplicity prior before sampling.",
                UserWarning, stacklevel=2,
            )
            return None
        probs = np.zeros(max_dim, dtype=np.float64)
        idx = np.clip(np.asarray(nd.n_nodes, np.int64) - 1, 0, max_dim - 1)
        np.add.at(probs, idx, np.asarray(nd.probs, np.float64))
        sigma = float(getattr(sk, "analytic_prior_smoothing_sigma", 0.0))
        if sigma > 0.0:
            half = max(int(np.ceil(3.0 * sigma)), 1)
            k = np.arange(-half, half + 1, dtype=np.float64)
            kern = np.exp(-0.5 * (k / sigma) ** 2)
            probs = np.convolve(probs, kern / kern.sum(), mode="same")
        probs /= probs.sum()
        return torch.from_numpy(np.log(probs + 1e-30).astype(np.float32))

    @torch.no_grad()
    def predict(self, batch, generator=None, draws=None) -> StructuredState:
        """Trainer-compatible sampling entry: the template's shapes and device
        come from the batch."""
        final_state, _nfe = self.sample(self._as_state(batch), generator, draws)
        return final_state
