"""AbsorbingFlow: MBM plus a third, absorbing bridge on the existence mask, so
that a jet's multiplicity is generated too
(multimodal_particles_tpu/models/generative/absorbing/absorbing_flows.py:37-396).

The generator is an EPiC trunk with a continuous head, a discrete head
(Dense → SELU → Dense) and the survival head, a small transformer over the
trunk's local hidden state that gives one logit a slot. Training (`loss_fn`)
runs the modules under autograd, as the JAX package's `loss_fn` runs flax: it
has no hand-written kernel on this path. Sampling (`predict`) interleaves
absorbing → continuous → discrete solver steps; with the kernel gate on, each
step's forward is two launches, the fused EPiC trunk with its hidden output
(ops/epic_cuda.py; at the wide widths 128 to 512, the wide one of
ops/epic_wide_cuda.py) and the fused survival head (ops/survival_cuda.py),
and the solver steps stay plain PyTorch (the JAX package has no fused
absorbing step). A config that no trunk kernel takes (another encoder
switch, a context) samples through the module trunk and the fused survival
head. `parallel.compute_dtype: "bfloat16"` casts the module forward
(training, and sampling with the gate off); the sampling path with the gate
on stays float32, as in JAX.
Randomness is an input throughout: every draw comes from a caller's generator
or is injected as tensors.
"""

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.profiler import record_function

from multimodal_particles_tpu_torch.models.architectures.epic import EPiCWrapper
from multimodal_particles_tpu_torch.models.architectures.gsdm import AttnBlock, ResnetBlock
from multimodal_particles_tpu_torch.models.architectures.utils import (
    SELU,
    Dense,
    get_timestep_embedding,
)
from multimodal_particles_tpu_torch.models.generative.bridges import (
    AbsorbingBridge,
    LinearUniformBridge,
    TelegraphBridge,
    time_grid,
)
from multimodal_particles_tpu_torch.models.generative.states import (
    AbsorbingBridgeState,
    OutputHeads,
)
from multimodal_particles_tpu_torch.ops.epic_cuda import (
    epic_forward,
    epic_supported,
    head_width,
    pack_mbm_encoder_params,
    with_narrow_buffer,
)
from multimodal_particles_tpu_torch.ops.epic_wide_cuda import (
    epic_forward_wide,
    pack_wide_encoder_params,
    wide_supported,
)
from multimodal_particles_tpu_torch.ops.survival_cuda import (
    pack_survival_head_params,
    project_time_embeddings,
    survival_head,
    survival_supported,
)
from multimodal_particles_tpu_torch.parallel import spmd
from multimodal_particles_tpu_torch.utils.dtype import cast_floating, compute_dtype_of
from multimodal_particles_tpu_torch.utils.losses import multihead_loss


class AbsorbingGenerator(nn.Module):
    """EPiC trunk + continuous, discrete and absorbing heads
    (absorbing_flows.py:37-135). Submodules carry the flax names."""

    def __init__(self, config):
        super().__init__()
        cfg_d, gen = config.data, config.generator
        self.config = config
        self.dim_features_continuous = cfg_d.dim_features_continuous
        dim_discrete_out = cfg_d.dim_features_discrete * cfg_d.vocab_size_features
        self.epic = EPiCWrapper(config)
        if config.encoder.add_discrete_head:
            self.discrete_head_mlp = nn.Sequential(
                Dense(dim_discrete_out, gen.discrete_head_hidden_dim),
                SELU(),
                Dense(gen.discrete_head_hidden_dim, dim_discrete_out),
            )
        # the time embedding is as wide as the transformer, whatever the
        # config's `temb_dim` says (absorbing_flows.py:62)
        C = self.temb_dim = gen.transformer_dim
        self.n_attn_blocks = gen.n_attn_blocks
        self.temb_net = Dense(C, C)
        self.transformer_1_proj_in = Dense(config.encoder.dim_hidden_local + 2, C)
        for i in range(gen.n_attn_blocks):
            self.add_module(f"res_block_{i}", ResnetBlock(C, dropout=0.0, temb_channels=C))
            self.add_module(f"attn_block_{i}", AttnBlock(C, n_heads=gen.n_heads, attn_dim_reduce=1))
        self.pre_rate_proj = Dense(C, C)
        self.post_rate_proj = Dense(C, 1)

    def absorbing_head(self, state: AbsorbingBridgeState, net_last_layer):
        """Survival-logit head: one-hot(mask_t) ‖ trunk hidden → projection →
        n × (ResnetBlock, AttnBlock) with the time embedding → a logit a slot,
        (B, N, 1). The attention runs over all N slots, without a mask."""
        B = state.mask_t.shape[0]
        # float32 whatever the compute dtype, as jax.nn.one_hot gives it
        mask_one_hot = F.one_hot(state.mask_t[..., 0].long(), 2).to(torch.float32)
        if self.config.generator.detach_last_layer:
            net_last_layer = net_last_layer.detach()
        temb = self.temb_net(get_timestep_embedding(state.time.reshape(B) * 1000.0, self.temb_dim))
        h = self.transformer_1_proj_in(torch.cat([net_last_layer, mask_one_hot], dim=-1))
        for i in range(self.n_attn_blocks):
            h = getattr(self, f"res_block_{i}")(h, temb)
            h = getattr(self, f"attn_block_{i}")(h)
        return self.post_rate_proj(self.pre_rate_proj(h))

    def trunk_and_heads(self, state: AbsorbingBridgeState, batch=None):
        """EPiC trunk + continuous and discrete heads, and the trunk's local
        hidden state for the survival head; the trunk reads the batch's
        context where the config has one (absorbing_flows.py:111-129)."""
        net_out, net_last_layer = self.epic(
            state.time, state.continuous, state.discrete,
            state.mask_t.to(state.continuous.dtype),
            getattr(batch, "context_continuous", None),
            getattr(batch, "context_discrete", None),
            output_hidden_local=True,
        )
        continuous_head = net_out[..., : self.dim_features_continuous]
        discrete_head = net_out[..., self.dim_features_continuous:]
        if self.config.encoder.add_discrete_head:
            discrete_head = self.discrete_head_mlp(discrete_head)
        return continuous_head, discrete_head, net_last_layer

    def forward(self, state: AbsorbingBridgeState, batch=None) -> OutputHeads:
        continuous_head, discrete_head, net_last_layer = self.trunk_and_heads(state, batch)
        return OutputHeads(continuous_head, discrete_head,
                           self.absorbing_head(state, net_last_layer))


class AbsorbingFlow(nn.Module):
    """Mask-generating hybrid bridge model (absorbing_flows.py:138-396)."""

    num_heads = 3  # continuous + discrete + absorbing

    def __init__(self, config):
        super().__init__()
        compute_dtype_of(config)  # an unknown dtype name raises KeyError here
        if config.bridge.continuous != "LinearUniformBridge":
            raise NotImplementedError(f"continuous bridge {config.bridge.continuous!r}")
        if config.bridge.discrete != "TelegraphBridge":
            raise NotImplementedError(f"discrete bridge {config.bridge.discrete!r}")
        self.config = config
        self.vocab_size = config.data.vocab_size_features
        self.generator = AbsorbingGenerator(config)
        self.loss_weights = nn.Parameter(torch.zeros(self.num_heads))
        self.bridge_continuous = LinearUniformBridge.from_config(config)
        self.bridge_discrete = TelegraphBridge.from_config(config)
        self.bridge_absorbing = AbsorbingBridge.from_config(config)
        self.min_t = config.bridge.time_eps

    # ---------------------------------------------------------------- forward

    def _pallas_enabled(self, device) -> bool:
        """The sampling path's kernel gate (absorbing_flows.py:165-176 with
        ops/survival_pallas.py:355-366): `parallel.use_pallas` False → off;
        'auto' → on for CUDA devices when the survival head matches its
        kernel; True → on when it matches. On a CPU device the kernel
        wrappers run their plain versions."""
        flag = self.config.parallel.use_pallas
        if flag is False:
            return False
        supported = survival_supported(self.config)
        if flag == "auto":
            return supported and torch.device(device).type == "cuda"
        return bool(flag) and supported

    def forward(self, state: AbsorbingBridgeState, batch=None) -> OutputHeads:
        """Eager module forward (absorbing_flows.py:269-287), with the batch's
        context where the config has one. Under another compute dtype than
        float32 the generator runs on copies of its parameters in that dtype
        (`torch.func.functional_call`; the gradients reach the float32
        parameters through the cast) with the state's time and kinematics
        cast (the context is not, as in JAX); the three heads come back in
        float32."""
        dtype = compute_dtype_of(self.config)
        if dtype == torch.float32:
            return self.generator(state, batch)
        params = cast_floating(dict(self.generator.named_parameters()), dtype)
        cast = state.replace(time=state.time.to(dtype), continuous=state.continuous.to(dtype))
        heads = functional_call(self.generator, params, (cast, batch))
        return OutputHeads(*(h.float() for h in (heads.continuous, heads.discrete,
                                                  heads.absorbing)))

    def pack_for_kernel(self):
        """(packed trunk or None, packed survival head) of the current
        weights, detached: what `forward_sampling` reads. The trunk tier
        follows absorbing_flows.py:204-245: the wide kernel where
        `wide_supported` takes the trunk, its discrete head and its jets (up
        to 256 slots), the narrow one
        at any hidden width up to 64 (zero-padded to one of its instances,
        `epic_supported`), the module trunk (None) otherwise."""
        gen = self.generator
        head = gen.discrete_head_mlp if self.config.encoder.add_discrete_head else None
        trunk = None
        if wide_supported(self.config, head_hidden=head_width(head)):
            trunk = pack_wide_encoder_params(gen, self.config, head=head)
        elif epic_supported(self.config):
            trunk = with_narrow_buffer(pack_mbm_encoder_params(gen, self.config, head=head))
        return trunk, pack_survival_head_params(gen, self.config.generator.n_attn_blocks)

    @torch.no_grad()
    def forward_sampling(self, state: AbsorbingBridgeState, packed=None,
                         batch=None) -> OutputHeads:
        """Sampling-path forward (absorbing_flows.py:178-267): with the gate
        on, the fused EPiC trunk (narrow or wide) with its hidden output, or
        where no trunk kernel takes the encoder (another switch, a context)
        the module trunk, uncast, then the fused survival head, all in
        float32 whatever the compute dtype; else the module forward. `packed`
        is a packing of the current weights to reuse (`pack_for_kernel`)."""
        if not self._pallas_enabled(state.continuous.device):
            return self.forward(state, batch)
        trunk, head = packed if packed is not None else self.pack_for_kernel()
        gen, cfg_g = self.generator, self.config.generator
        if trunk is not None:
            trunk_fn = epic_forward_wide if trunk.layout == "wide" else epic_forward
            out, last = trunk_fn(
                trunk, state.time, state.continuous, state.discrete,
                state.mask_t.to(state.continuous.dtype), output_hidden_local=True,
            )
            dc = self.config.data.dim_features_continuous
            continuous_head, discrete_head = out[..., :dc], out[..., dc:]
        else:
            continuous_head, discrete_head, last = gen.trunk_and_heads(state, batch)
        temb_proj = project_time_embeddings(gen, state.time, cfg_g.n_attn_blocks,
                                            cfg_g.transformer_dim)
        absorbing_head = survival_head(head, temb_proj, last.contiguous(), state.mask_t,
                                       n_heads=cfg_g.n_heads)
        return OutputHeads(continuous_head, discrete_head, absorbing_head)

    # ---------------------------------------------------------------- bridges

    def sample_bridges(self, batch, generator=None, draws=None) -> AbsorbingBridgeState:
        """t ~ U(min_t, 1) and the bridge states at t, the absorbing mask
        included (absorbing_flows.py:291-307). `draws` = (t01 (B,), z (B,N,C),
        u_k (B,N), u_m (B,N,1)[, u_drop (B,N,1)]) replaces the draws from
        `generator`: t01 the uniforms behind the times, z the continuous
        bridge's normals, u_k the telegraph draw's uniforms, u_m the mask's,
        and with `target_dropout` u_drop the dropped target slots'."""
        x1 = batch.target_continuous
        B, N = x1.shape[0], x1.shape[1]
        if draws is None:
            # drawn for the global batch under spmd.global_batch, this rank's rows kept
            kw = dict(generator=generator, device=x1.device)
            Bg = spmd.rows(B)
            draws = tuple(spmd.local(d) for d in (
                torch.rand((Bg,), **kw), torch.randn((Bg, *x1.shape[1:]), **kw),
                torch.rand((Bg, N), **kw),
                *(torch.rand((Bg, N, 1), **kw)
                  for _ in range(self.bridge_absorbing.sample_draws))))
        t01, z, u_k, *u_m = (d.to(device=x1.device, dtype=x1.dtype) for d in draws)
        time = (self.min_t + (1.0 - self.min_t) * t01).reshape(B, 1, 1)
        continuous = self.bridge_continuous.sample(time, batch.source_continuous, x1, z)
        discrete = self.bridge_discrete.sample(
            time, batch.source_discrete, batch.target_discrete, u_k
        )
        mask_t = self.bridge_absorbing.sample(time, batch.target_mask, *u_m)
        return AbsorbingBridgeState(time, continuous, discrete, mask_t)

    # ----------------------------------------------------------------- losses

    def loss_continuous(self, heads, state, batch):
        """MSE against the drift, summed over the N slots (dead ones too),
        meaned over batch and features (absorbing_flows.py:311-321)."""
        ut = self.bridge_continuous.drift(
            state.time, state.continuous, batch.source_continuous, batch.target_continuous
        )
        return spmd.mean(((heads.continuous - ut) ** 2).sum(dim=1))

    def loss_discrete(self, heads, batch):
        """Token cross-entropy, summed over the N slots, meaned over the
        batch (absorbing_flows.py:323-331)."""
        B, N = heads.discrete.shape[:2]
        log_probs = F.log_softmax(heads.discrete.reshape(-1, self.vocab_size), dim=-1)
        targets = batch.target_discrete.reshape(-1).long()
        ce = -torch.gather(log_probs, 1, targets[:, None])[:, 0]
        return spmd.mean(ce.reshape(B, N).sum(dim=1))

    def loss_absorbing(self, heads, batch):
        """BCE-with-logits of the survival head against the target mask, a
        mean over B·N (absorbing_flows.py:333-341)."""
        logits = heads.absorbing.reshape(-1)
        targets = batch.target_mask.reshape(-1).to(logits.dtype)
        bce = torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
        return spmd.mean(bce)

    def loss_fn(self, batch, generator=None, draws=None):
        """Bridge sampling + module forward + multi-head combine
        (absorbing_flows.py:343-357) → (loss, metrics), the metrics detached
        under the JAX names."""
        with record_function("absorbing.sample_bridges"):
            state = self.sample_bridges(batch, generator, draws)
        with record_function("absorbing.forward"):
            heads = self.forward(state, batch)
        with record_function("absorbing.loss"):
            loss_c = self.loss_continuous(heads, state, batch)
            loss_d = self.loss_discrete(heads, batch)
            loss_a = self.loss_absorbing(heads, batch)
            loss, per_head = multihead_loss([loss_c, loss_d, loss_a], self.loss_weights)
        metrics = {
            "loss": loss.detach(),
            "loss_continuous": per_head[0].detach(),
            "loss_discrete": per_head[1].detach(),
            "loss_absorbing": per_head[2].detach(),
        }
        return loss, metrics

    # --------------------------------------------------------------- sampling

    def time_grid(self):
        """Times as Python floats and the float32 step (bridges.time_grid)."""
        return time_grid(self.config.bridge)

    @property
    def step_draws(self) -> int:
        """Uniform (B, N) tensors a sampler step reads: births, deaths when
        the death channel is on, and the telegraph update's two."""
        return self.bridge_absorbing.step_draws + 2

    @torch.no_grad()
    def simulate_dynamics(self, state: AbsorbingBridgeState, generator=None,
                          uniforms=None, batch=None) -> AbsorbingBridgeState:
        """Absorbing → continuous → discrete solver steps at time_steps[1:]
        (absorbing_flows.py:361-386). The three steps share one forward, taken
        with the mask before the step; the continuous and discrete steps
        multiply by the mask after it. The batch's context, where it has one,
        is the same at every step.

        Each step draws (step_draws, B, N) uniforms from `generator` on the
        state's device; `uniforms` of shape (steps, step_draws, B, N) replaces
        the draws: births, [deaths,] and the telegraph update's two."""
        time_steps, delta_t = self.time_grid()
        B, N = state.continuous.shape[0], state.continuous.shape[1]
        device = state.continuous.device
        # the weights do not change under the loop, so they are packed once
        packed = self.pack_for_kernel() if self._pallas_enabled(device) else None
        n_mask = self.bridge_absorbing.step_draws
        for i, t in enumerate(time_steps[1:]):
            if uniforms is not None:
                u = uniforms[i].to(device=device, dtype=torch.float32)
            else:
                u = torch.rand((self.step_draws, B, N), generator=generator, device=device)
            state = state.replace(
                time=torch.full((B, 1, 1), t, dtype=state.continuous.dtype, device=device)
            )
            heads = self.forward_sampling(state, packed, batch)
            state = self.bridge_absorbing.solver_step(
                state, heads, delta_t, *(u[j][..., None] for j in range(n_mask))
            )
            state = self.bridge_continuous.solver_step(state, heads, delta_t, multimodal=False)
            state = self.bridge_discrete.solver_step(state, heads, delta_t, u[n_mask:],
                                                     multimodal=False)
        return state

    @torch.no_grad()
    def predict(self, batch, generator=None, uniforms=None) -> AbsorbingBridgeState:
        """Source batch → generated target, multiplicity included
        (absorbing_flows.py:388-395)."""
        x = batch.source_continuous
        initial_state = AbsorbingBridgeState(
            time=torch.zeros((x.shape[0], 1, 1), dtype=x.dtype, device=x.device),
            continuous=x,
            discrete=batch.source_discrete,
            mask_t=batch.source_mask.long(),
        )
        return self.simulate_dynamics(initial_state, generator, uniforms, batch)
