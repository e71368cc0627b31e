"""MultiModalBridgeMatching (MBM): hybrid continuous flow-matching bridge +
discrete telegraph (CTMC) bridge over fixed-mask particle clouds
(multimodal_particles_tpu/models/generative/multimodal_bridge_matching.py:41-366).

The sampling half is ported: `forward`, `simulate_dynamics` and `predict`.
The model is an `nn.Module` that owns its parameters (the encoder and the
multi-head loss log-variances `loss_weights`); `predict` takes the source
batch and an explicit `torch.Generator`. When the kernel gate is on, each
sampler step is one launch of the fused CUDA kernel (ops/sampler_cuda.py).
"""

import torch
from torch import nn

from multimodal_particles_tpu_torch.models.architectures.epic import EPiCWrapper
from multimodal_particles_tpu_torch.models.generative.bridges import (
    LinearUniformBridge,
    TelegraphBridge,
)
from multimodal_particles_tpu_torch.models.generative.states import (
    HybridState,
    MultiHeadOutput,
)
from multimodal_particles_tpu_torch.ops.epic_cuda import (
    epic_forward,
    epic_supported,
    pack_mbm_encoder_params,
)
from multimodal_particles_tpu_torch.ops.sampler_cuda import fused_simulate_dynamics


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
                nn.Linear(dim_discrete_out, dim_discrete_out),
                nn.SELU(),
                nn.Linear(dim_discrete_out, dim_discrete_out),
            )

    def forward(self, t, x, k, mask):
        h = self.epic(t, x, k, mask)
        continuous_head = h[..., : self.dim_features_continuous]
        discrete_head = h[..., self.dim_features_continuous:]
        if self.add_discrete_head:
            discrete_head = self.fc_layer(discrete_head)
        return continuous_head, discrete_head, mask


class MultiModalBridgeMatching(nn.Module):
    """Hybrid bridge-matching model for fixed-cardinality particle clouds
    (multimodal_bridge_matching.py:75-366), sampling half."""

    num_heads = 2  # continuous + discrete

    def __init__(self, config):
        super().__init__()
        self.config = config
        self.encoder = MultiModalEPiC(config)
        self.loss_weights = nn.Parameter(torch.zeros(self.num_heads))
        if config.bridge.continuous != "LinearUniformBridge":
            raise NotImplementedError(
                f"continuous bridge {config.bridge.continuous!r} is not ported"
            )
        if config.bridge.discrete != "TelegraphBridge":
            raise NotImplementedError(f"discrete bridge {config.bridge.discrete!r}")
        self.bridge_continuous = LinearUniformBridge.from_config(config)
        self.bridge_discrete = TelegraphBridge.from_config(config)

    # ---------------------------------------------------------------- forward

    def kernel_enabled(self, device) -> bool:
        """Kernel gate (multimodal_bridge_matching.py:114-125 with
        ops/epic_pallas.py:474-494): `parallel.use_pallas` False → off;
        'auto' → on for CUDA devices when the encoder matches the kernels;
        True → on when it matches. On a CPU device the kernel wrappers run
        their plain versions."""
        flag = self.config.parallel.use_pallas
        if flag is False:
            return False
        supported = epic_supported(self.config)
        if flag == "auto":
            return supported and torch.device(device).type == "cuda"
        return bool(flag) and supported

    def forward(self, state: HybridState) -> MultiHeadOutput:
        """Eager module forward (multimodal_bridge_matching.py:234-253)."""
        continuous, discrete, absorbing = self.encoder(
            state.time, state.continuous, state.discrete, state.absorbing
        )
        return MultiHeadOutput(continuous, discrete, absorbing)

    def forward_kernel(self, state: HybridState) -> MultiHeadOutput:
        """Fused-kernel forward, one launch for the whole encoder
        (forward_pallas, multimodal_bridge_matching.py:196-232)."""
        packed = pack_mbm_encoder_params(self.encoder, self.config)
        out = epic_forward(
            packed, state.time, state.continuous, state.discrete, state.absorbing
        )
        dc = self.config.data.dim_features_continuous
        return MultiHeadOutput(out[..., :dc], out[..., dc:], state.absorbing)

    # --------------------------------------------------------------- sampling

    def time_grid(self):
        """Times as Python floats (float32 values) and the float32 step:
        linspace(0, 1 − time_eps, num_timesteps); the sampler evaluates the
        steps at time_steps[1:], 99 steps for 100 timesteps
        (multimodal_bridge_matching.py:334-355)."""
        cfg_b = self.config.bridge
        ts = torch.linspace(0.0, 1.0 - cfg_b.time_eps, cfg_b.num_timesteps, dtype=torch.float32)
        delta_t = (ts[-1] - ts[0]) / (cfg_b.num_timesteps - 1)
        return ts.tolist(), delta_t.item()

    @torch.no_grad()
    def simulate_dynamics(self, state: HybridState, generator=None, uniforms=None) -> HybridState:
        """Generate target data from the source state: Euler + single-jump
        telegraph steps at time_steps[1:] (multimodal_bridge_matching.py:314-356).

        Each step draws (2, B, N) uniforms from `generator` on the state's
        device; `uniforms` of shape (steps, 2, B, N) replaces the draws."""
        if self.kernel_enabled(state.continuous.device):
            return fused_simulate_dynamics(self, state, generator, uniforms)
        time_steps, delta_t = self.time_grid()
        B, N = state.continuous.shape[0], state.continuous.shape[1]
        device = state.continuous.device
        for i, t in enumerate(time_steps[1:]):
            if uniforms is not None:
                u = uniforms[i].to(device=device, dtype=torch.float32)
            else:
                u = torch.rand((2, B, N), generator=generator, device=device)
            state = state.replace(
                time=torch.full((B, 1, 1), t, dtype=state.continuous.dtype, device=device)
            )
            heads = self.forward(state)
            state = self.bridge_continuous.solver_step(state, heads, delta_t)
            state = self.bridge_discrete.solver_step(state, heads, delta_t, u)
        return state

    @torch.no_grad()
    def predict(self, batch, generator=None, uniforms=None) -> HybridState:
        """Source batch → generated target (multimodal_bridge_matching.py:358-366)."""
        x = batch.source_continuous
        initial_state = HybridState(
            time=torch.zeros((x.shape[0], 1, 1), dtype=x.dtype, device=x.device),
            continuous=x,
            discrete=batch.source_discrete,
            absorbing=batch.source_mask.to(x.dtype),
        )
        return self.simulate_dynamics(initial_state, generator, uniforms)
