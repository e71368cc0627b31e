"""Fully-fused MBM sampler step as one hand-written CUDA kernel
(counterpart of multimodal_particles_tpu/ops/sampler_pallas.py).

One launch per step runs: time embedding from the scalar t → EPiC forward →
Euler update x ← (x + Δt·cont)·mask → telegraph single-jump token update
(sampler_pallas.py:54-101). The kernel runs the per-particle products on the
tensor cores (ops/csrc/sampler_step.cu) and reads only the buffer it shares
with the forward kernel K1 (ops/epic_cuda.py::narrow_buffer), which
`pack_sampler_params` makes once a packing and the packing carries
(`PackedEncoder.tensor_core`). The uniforms come in as a
(2, B, N) float32 tensor drawn from the caller's generator, so the kernel and
its plain version consume identical random numbers.
"""

import torch

from multimodal_particles_tpu_torch.models.architectures.utils import (
    sinusoidal_positional_encoding,
)
from multimodal_particles_tpu_torch.models.generative.bridges import (
    telegraph_fused_solver_step,
)
from multimodal_particles_tpu_torch.models.generative.states import HybridState
from multimodal_particles_tpu_torch.ops import _build
from multimodal_particles_tpu_torch.ops.epic_cuda import (
    VOCAB,
    PackedEncoder,
    check_kernel_inputs,
    check_narrow_packing,
    forward_from_temb,
    narrow_buffer_size,
    pack_mbm_encoder_params,
    with_narrow_buffer,
)


def pack_sampler_params(encoder, config) -> PackedEncoder:
    """The narrow packing of the MBM encoder (`pack_mbm_encoder_params`)
    carrying the tensor-core buffer that K1 and K2 read as its `tensor_core`
    (`with_narrow_buffer`): what `sampler_step` reads on the card, made once
    a request."""
    return with_narrow_buffer(pack_mbm_encoder_params(encoder, config))


def sampler_step_reference(packed: PackedEncoder, x, k, mask, u, t, dt, *, gamma):
    """Plain PyTorch version of the kernel (`_step_math`,
    sampler_pallas.py:54-101). Returns (x', k') with k' in k's dtype."""
    sampler_step_reference.calls += 1
    B = x.shape[0]
    t_col = torch.full((B,), float(t), dtype=torch.float32, device=x.device)
    temb = sinusoidal_positional_encoding(t_col, packed.dims.emb_t)
    cont, logits = forward_from_temb(packed, temb, x, k, mask)
    x_new = (x + dt * cont) * mask
    k_new = telegraph_fused_solver_step(t_col, k, logits, gamma, VOCAB, dt, u)
    return x_new, k_new * mask.to(k_new.dtype)


sampler_step_reference.calls = 0


def sampler_step(packed: PackedEncoder, x, k, mask, u, t, dt, *, gamma):
    """One whole sampler step. x (B,N,3), k (B,N,1) int, mask (B,N,1),
    u (2,B,N) uniforms, t and dt Python floats → (x', k'), k' in k's dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if x.device.type == "cpu":
        return sampler_step_reference(packed, x, k, mask, u, t, dt, gamma=gamma)
    check_narrow_packing(packed)
    if packed.tensor_core is None:
        raise ValueError("the sampler step kernel reads the tensor-core weights that "
                         "pack_sampler_params adds to the packing")
    (weights,) = packed.tensor_core
    B, N = check_kernel_inputs(packed, x, k, mask, u=u, tensor_core=weights)
    if tuple(u.shape) != (2, B, N):
        raise ValueError(f"u must be (2, {B}, {N}), got {tuple(u.shape)}")
    if weights.numel() != narrow_buffer_size(packed.dims):
        raise ValueError(f"the sampler step kernel's buffer holds {narrow_buffer_size(packed.dims)} "
                         f"floats at {packed.dims}, got {weights.numel()}")
    k32 = k.to(torch.int32).contiguous()
    x_out = torch.empty_like(x)
    k_out = torch.empty_like(k32)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mmp_sampler_step(
            weights.data_ptr(), x.data_ptr(), k32.data_ptr(), mask.data_ptr(), u.data_ptr(),
            x_out.data_ptr(), k_out.data_ptr(), float(t), float(dt), float(gamma), B, N,
            packed.dims.c_array(), stream,
        )
    _build.check(lib, rc, "mmp_sampler_step")
    sampler_step.launches += 1
    return x_out, k_out.to(k.dtype)


sampler_step.launches = 0


def fused_simulate_dynamics(model, state: HybridState, generator=None, uniforms=None):
    """MBM.simulate_dynamics with the whole step in one kernel
    (sampler_pallas.py:174-216): pack the weights once (`pack_sampler_params`), then one
    `sampler_step` per time in time_steps[1:]. `uniforms` (steps, 2, B, N)
    replaces the draws from `generator`."""
    cfg = model.config
    packed = pack_sampler_params(model.encoder, cfg)
    time_steps, delta_t = model.time_grid()
    B, N, _ = state.continuous.shape
    device = state.continuous.device

    x = state.continuous.to(torch.float32).contiguous()
    k = state.discrete.to(torch.int32).contiguous()
    mask = state.absorbing.to(torch.float32).contiguous()
    for i, t in enumerate(time_steps[1:]):
        if uniforms is not None:
            u = uniforms[i].to(device=device, dtype=torch.float32).contiguous()
        else:
            u = torch.rand((2, B, N), generator=generator, device=device)
        x, k = sampler_step(packed, x, k, mask, u, t, delta_t, gamma=cfg.bridge.gamma)
    return state.replace(
        continuous=x.to(state.continuous.dtype), discrete=k.to(state.discrete.dtype)
    )
