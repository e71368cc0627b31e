"""MultiModalBridgeMatching (MBM): hybrid continuous flow-matching bridge +
discrete telegraph (CTMC) bridge over fixed-mask particle clouds
(multimodal_particles_tpu/models/generative/multimodal_bridge_matching.py:41-366).

The model is an `nn.Module` that owns its parameters (the encoder and the
multi-head loss log-variances `loss_weights`). Training: `loss_fn` draws the
bridge states (`sample_bridges`), runs `forward_train` and combines the
masked MSE and cross-entropy heads; with the kernel gate on, the encoder's
forward and backward are the hand-written CUDA kernels (ops/epic_vjp_cuda.py,
and ops/epic_wide_vjp_cuda.py at hidden 128).
Sampling: `predict` takes the source batch and an explicit `torch.Generator`;
with the narrow gate on, each sampler step is one launch of the fused CUDA
kernel (ops/sampler_cuda.py); with the wide gate on, each step is one launch
of the wide forward kernel followed by the bridges' plain solver steps.
Every encoder switch and both contexts of the JAX package are taken; the
kernel gates are off for each, so such a config trains and serves on the
module path, as in JAX. `parallel.compute_dtype: "bfloat16"` casts the module
forward (`forward`); the kernels, whose gates do not read the dtype, stay
float32. Randomness is an input throughout: every draw comes
from a caller's generator or is injected as tensors.
"""

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.profiler import record_function

from multimodal_particles_tpu_torch.models.architectures.epic import EPiCWrapper
from multimodal_particles_tpu_torch.models.architectures.utils import SELU, Dense
from multimodal_particles_tpu_torch.models.generative.bridges import (
    LinearUniformBridge,
    SchrodingerBridge,
    TelegraphBridge,
    time_grid,
)
from multimodal_particles_tpu_torch.models.generative.states import (
    HybridState,
    MultiHeadOutput,
)
from multimodal_particles_tpu_torch.ops.epic_cuda import (
    epic_forward,
    epic_supported,
    pack_mbm_encoder_params,
    with_narrow_buffer,
)
from multimodal_particles_tpu_torch.ops.epic_vjp_cuda import epic_train_forward
from multimodal_particles_tpu_torch.ops.epic_wide_cuda import (
    epic_forward_wide,
    pack_wide_encoder_params,
    wide_supported,
)
from multimodal_particles_tpu_torch.ops.epic_wide_vjp_cuda import epic_train_forward_wide
from multimodal_particles_tpu_torch.ops.sampler_cuda import fused_simulate_dynamics
from multimodal_particles_tpu_torch.parallel import spmd
from multimodal_particles_tpu_torch.utils.dtype import cast_floating, compute_dtype_of
from multimodal_particles_tpu_torch.utils.losses import multihead_loss

CONTINUOUS_BRIDGES = {
    "LinearUniformBridge": LinearUniformBridge,
    "SchrodingerBridge": SchrodingerBridge,
}


class MultiModalEPiC(nn.Module):
    """EPiC trunk + per-modality output heads (multimodal_bridge_matching.py:41-72).
    The absorbing head passes the input mask through unchanged."""

    def __init__(self, config):
        super().__init__()
        cfg_d = config.data
        self.add_discrete_head = config.encoder.add_discrete_head
        self.dim_features_continuous = cfg_d.dim_features_continuous
        dim_discrete_out = cfg_d.dim_features_discrete * cfg_d.vocab_size_features
        self.epic = EPiCWrapper(config)
        if self.add_discrete_head:
            self.fc_layer = nn.Sequential(
                Dense(dim_discrete_out, dim_discrete_out),
                SELU(),
                Dense(dim_discrete_out, dim_discrete_out),
            )

    def forward(self, t, x, k, mask, context_continuous=None, context_discrete=None):
        h = self.epic(t, x, k, mask, context_continuous, context_discrete)
        continuous_head = h[..., : self.dim_features_continuous]
        discrete_head = h[..., self.dim_features_continuous:]
        if self.add_discrete_head:
            discrete_head = self.fc_layer(discrete_head)
        return continuous_head, discrete_head, mask


class MultiModalBridgeMatching(nn.Module):
    """Hybrid bridge-matching model for fixed-cardinality particle clouds
    (multimodal_bridge_matching.py:75-366)."""

    num_heads = 2  # continuous + discrete

    def __init__(self, config):
        super().__init__()
        compute_dtype_of(config)  # an unknown dtype name raises KeyError here
        if config.bridge.continuous not in CONTINUOUS_BRIDGES:
            raise NotImplementedError(
                f"continuous bridge {config.bridge.continuous!r} is not ported"
            )
        if config.bridge.discrete != "TelegraphBridge":
            raise NotImplementedError(f"discrete bridge {config.bridge.discrete!r}")
        self.config = config
        self.vocab_size = config.data.vocab_size_features
        self.encoder = MultiModalEPiC(config)
        self.loss_weights = nn.Parameter(torch.zeros(self.num_heads))
        self.bridge_continuous = CONTINUOUS_BRIDGES[config.bridge.continuous].from_config(config)
        self.bridge_discrete = TelegraphBridge.from_config(config)

    # ---------------------------------------------------------------- forward

    def _gate(self, supported: bool, device) -> bool:
        """`parallel.use_pallas` False → off; 'auto' → on for CUDA devices
        when the encoder matches the kernels; True → on when it matches. On a
        CPU device the kernel wrappers run their plain versions."""
        flag = self.config.parallel.use_pallas
        if flag is False:
            return False
        if flag == "auto":
            return supported and torch.device(device).type == "cuda"
        return bool(flag) and supported

    def kernel_enabled(self, device) -> bool:
        """Narrow kernel gate (multimodal_bridge_matching.py:114-125 with
        ops/epic_pallas.py:474-494): hidden ≤ 64, the fused forward, its
        backward and the whole-step sampler kernel."""
        return self._gate(epic_supported(self.config), device)

    def wide_kernel_enabled(self, device) -> bool:
        """Wide kernel gate (multimodal_bridge_matching.py:127-141 with
        ops/epic_pallas_wide.py:335-369): the widths 128 to 512 and the jets
        of up to 256 slots of `wide_supported`, the wide forward and its
        backward."""
        return self._gate(wide_supported(self.config), device)

    def forward(self, state: HybridState, batch=None) -> MultiHeadOutput:
        """Eager module forward (multimodal_bridge_matching.py:234-253), with
        the batch's `context_continuous` / `context_discrete` where it has
        them. Under another compute dtype than float32 the encoder runs on
        copies of its parameters in that dtype (`torch.func.functional_call`;
        the gradients reach the float32 parameters through the cast) with t,
        x, the mask and the continuous context cast; both heads come back in
        float32 and the absorbing head is the state's own mask."""
        ctx_c = getattr(batch, "context_continuous", None)
        ctx_d = getattr(batch, "context_discrete", None)
        dtype = compute_dtype_of(self.config)
        if dtype == torch.float32:
            continuous, discrete, absorbing = self.encoder(
                state.time, state.continuous, state.discrete, state.absorbing, ctx_c, ctx_d
            )
            return MultiHeadOutput(continuous, discrete, absorbing)
        t, x, mask, ctx_c = cast_floating(
            (state.time, state.continuous, state.absorbing, ctx_c), dtype)
        params = cast_floating(dict(self.encoder.named_parameters()), dtype)
        continuous, discrete, _ = functional_call(
            self.encoder, params, (t, x, state.discrete, mask, ctx_c, ctx_d))
        return MultiHeadOutput(continuous.float(), discrete.float(), state.absorbing)

    def forward_kernel(self, state: HybridState, packed=None) -> MultiHeadOutput:
        """Fused-kernel forward, one launch for the whole encoder
        (forward_pallas, multimodal_bridge_matching.py:196-232): the wide
        kernel when the wide gate is on, else the narrow one. `packed` is a
        packing of the current weights to reuse (`pack_for_kernel`)."""
        wide = self.wide_kernel_enabled(state.continuous.device)
        if packed is None:
            packed = self.pack_for_kernel(wide)
        out = (epic_forward_wide if wide else epic_forward)(
            packed, state.time, state.continuous, state.discrete, state.absorbing
        )
        dc = self.config.data.dim_features_continuous
        return MultiHeadOutput(out[..., :dc], out[..., dc:], state.absorbing)

    def pack_for_kernel(self, wide: bool, differentiable: bool = False):
        """The encoder's effective weights in the layout of the wide or the
        narrow kernels. The narrow serving packing carries the forward
        kernel's tensor-core buffer (`with_narrow_buffer`); the training
        forward makes its own from the differentiable packing at each step
        (ops/epic_vjp_cuda.py)."""
        if wide:
            return pack_wide_encoder_params(self.encoder, self.config, differentiable=differentiable)
        packed = pack_mbm_encoder_params(self.encoder, self.config, differentiable=differentiable)
        return packed if differentiable else with_narrow_buffer(packed)

    def forward_train(self, state: HybridState, batch=None) -> MultiHeadOutput:
        """Training-path forward (multimodal_bridge_matching.py:171-194):
        with a kernel gate on, the forward kernel with its backward kernel
        behind it (narrow or wide), on the differentiable packing, in float32
        whatever the compute dtype (the gates do not read it); else the
        module."""
        device = state.continuous.device
        wide = self.wide_kernel_enabled(device)
        if not (wide or self.kernel_enabled(device)):
            return self.forward(state, batch)
        packed = self.pack_for_kernel(wide, differentiable=True)
        out = (epic_train_forward_wide if wide else epic_train_forward)(
            packed, state.time, state.continuous, state.discrete, state.absorbing
        )
        dc = self.config.data.dim_features_continuous
        return MultiHeadOutput(out[..., :dc], out[..., dc:], state.absorbing)

    # ---------------------------------------------------------------- bridges

    def sample_bridges(self, batch, generator=None, draws=None) -> HybridState:
        """Draw t ~ U(0,1) and the bridge states at t
        (multimodal_bridge_matching.py:257-271). `draws` = (t (B,), z (B,N,C),
        u (B,N)) replaces the draws from `generator`: t the times, z the
        continuous bridge's normals, u the telegraph draw's uniforms."""
        x1 = batch.target_continuous
        B, N = x1.shape[0], x1.shape[1]
        if draws is None:
            # drawn for the global batch under spmd.global_batch, this rank's rows kept
            kw = dict(generator=generator, device=x1.device)
            Bg = spmd.rows(B)
            draws = tuple(spmd.local(d) for d in (
                torch.rand((Bg,), **kw), torch.randn((Bg, *x1.shape[1:]), **kw),
                torch.rand((Bg, N), **kw)))
        t, z, u = (d.to(device=x1.device, dtype=x1.dtype) for d in draws)
        time = t.reshape(B, 1, 1)
        continuous = self.bridge_continuous.sample(time, batch.source_continuous, x1, z)
        discrete = self.bridge_discrete.sample(
            time, batch.source_discrete, batch.target_discrete, u
        )
        absorbing = batch.target_mask.to(continuous.dtype)
        return HybridState(time, continuous, discrete, absorbing)

    # ----------------------------------------------------------------- losses

    def loss_continuous(self, heads: MultiHeadOutput, state: HybridState, batch):
        """Masked MSE against the conditional drift, summed over features and
        divided by max(Σmask, 1) (multimodal_bridge_matching.py:275-286); the
        global batch's Σmask under spmd.global_batch."""
        targets = self.bridge_continuous.drift(
            state.time, state.continuous, batch.source_continuous, batch.target_continuous
        )
        mask = state.absorbing
        mse = (heads.continuous - targets) ** 2 * mask
        return torch.sum(mse) / torch.clamp(spmd.total(torch.sum(mask)), min=1.0)

    def loss_discrete(self, heads: MultiHeadOutput, state: HybridState, batch):
        """Masked cross-entropy on the target tokens
        (multimodal_bridge_matching.py:288-296)."""
        logits = heads.discrete.reshape(-1, self.vocab_size)
        targets = batch.target_discrete.reshape(-1).long()
        mask = state.absorbing.reshape(-1)
        log_probs = F.log_softmax(logits, dim=-1)
        ce = -torch.gather(log_probs, 1, targets[:, None])[:, 0]
        return torch.sum(ce * mask) / torch.clamp(spmd.total(torch.sum(mask)), min=1.0)

    def loss_fn(self, batch, generator=None, draws=None):
        """Bridge sampling + forward + multi-head combine
        (multimodal_bridge_matching.py:298-310) → (loss, metrics), the
        metrics detached under the JAX names."""
        with record_function("mbm.sample_bridges"):
            state = self.sample_bridges(batch, generator, draws)
        with record_function("mbm.forward_train"):
            heads = self.forward_train(state, batch)
        with record_function("mbm.loss"):
            loss_0 = self.loss_continuous(heads, state, batch)
            loss_1 = self.loss_discrete(heads, state, batch)
            loss, per_head = multihead_loss([loss_0, loss_1], self.loss_weights)
        metrics = {
            "loss": loss.detach(),
            "loss_continuous": per_head[0].detach(),
            "loss_discrete": per_head[1].detach(),
        }
        return loss, metrics

    # --------------------------------------------------------------- sampling

    def time_grid(self):
        """Times as Python floats (float32 values) and the float32 step:
        linspace(0, 1 − time_eps, num_timesteps); the sampler evaluates the
        steps at time_steps[1:], 99 steps for 100 timesteps
        (multimodal_bridge_matching.py:334-355)."""
        return time_grid(self.config.bridge)

    @torch.no_grad()
    def simulate_dynamics(self, state: HybridState, generator=None, uniforms=None,
                          batch=None) -> HybridState:
        """Generate target data from the source state: Euler + single-jump
        telegraph steps at time_steps[1:] (multimodal_bridge_matching.py:314-356).
        The batch's context, where it has one, is the same at every step; a
        batch with a context reaches only the module path (every kernel gate
        is off for a config with a context).

        Each step draws (2, B, N) uniforms from `generator` on the state's
        device; `uniforms` of shape (steps, 2, B, N) replaces the draws. The
        Schrödinger bridge's Euler–Maruyama step also draws its normals from
        `generator`."""
        linear = isinstance(self.bridge_continuous, LinearUniformBridge)
        if linear and self.kernel_enabled(state.continuous.device):
            return fused_simulate_dynamics(self, state, generator, uniforms)
        time_steps, delta_t = self.time_grid()
        B, N = state.continuous.shape[0], state.continuous.shape[1]
        device = state.continuous.device
        # the wide regime has no fused step: the wide forward kernel, then
        # the bridges' solver steps (multimodal_bridge_matching.py:338-352);
        # the weights do not change under the loop, so they are packed once
        forward = lambda st: self.forward(st, batch)
        if self.wide_kernel_enabled(device):
            packed = self.pack_for_kernel(wide=True)
            forward = lambda st: self.forward_kernel(st, packed)
        for i, t in enumerate(time_steps[1:]):
            if uniforms is not None:
                u = uniforms[i].to(device=device, dtype=torch.float32)
            else:
                u = torch.rand((2, B, N), generator=generator, device=device)
            state = state.replace(
                time=torch.full((B, 1, 1), t, dtype=state.continuous.dtype, device=device)
            )
            heads = forward(state)
            if linear:
                state = self.bridge_continuous.solver_step(state, heads, delta_t)
            else:
                dw = torch.randn(tuple(state.continuous.shape), generator=generator, device=device)
                state = self.bridge_continuous.solver_step(state, heads, delta_t, dw)
            state = self.bridge_discrete.solver_step(state, heads, delta_t, u)
        return state

    @torch.no_grad()
    def predict(self, batch, generator=None, uniforms=None) -> HybridState:
        """Source batch → generated target (multimodal_bridge_matching.py:358-366),
        conditioned on the batch's context where the config has one."""
        x = batch.source_continuous
        initial_state = HybridState(
            time=torch.zeros((x.shape[0], 1, 1), dtype=x.dtype, device=x.device),
            continuous=x,
            discrete=batch.source_discrete,
            absorbing=batch.source_mask.to(x.dtype),
        )
        return self.simulate_dynamics(initial_state, generator, uniforms, batch)
