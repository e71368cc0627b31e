"""EPiC forward with a hand-written backward kernel for training
(counterpart of multimodal_particles_tpu/ops/epic_pallas_vjp.py).

`EpicTrainForward` is a `torch.autograd.Function` whose boundary sits at the
packed effective weights, as the JAX custom VJP's does: weight normalization
and the module → buffer mapping run in plain PyTorch outside it
(`pack_mbm_encoder_params(..., differentiable=True)`), so autograd chains
d(flat) to v, g and the rest.

  forward   the K1 kernel (ops/csrc/epic_forward.cu): the JAX `_fwd_kernel`
            runs the same `_forward_acts` as `epic_forward_pallas`. K1 reads
            its tensor-core buffer, made at each step from `flat` on the
            device (`narrow_buffer`, detached), kept for the backward
  backward  ops/csrc/epic_backward.cu: reruns K1's forward on the same
            buffer, so the gradient is taken where the loss was, and returns
            d(flat) for a cotangent g (B, N, 3 + 8); t, x, k and mask get no
            gradient (epic_pallas_vjp.py:362-369)

`epic_train_forward` dispatches: CUDA tensors go to the kernels or raise, CPU
tensors to `epic_train_forward_reference`, autograd through the plain
`forward_from_temb`. `epic_backward` and `epic_backward_reference` expose the
backward alone, for checks against each other.
"""

import ctypes

import torch

from multimodal_particles_tpu_torch.models.architectures.utils import (
    sinusoidal_positional_encoding,
)
from multimodal_particles_tpu_torch.ops import _build
from multimodal_particles_tpu_torch.ops.epic_cuda import (
    DIM_C,
    VOCAB,
    PackedEncoder,
    check_kernel_inputs,
    check_narrow_packing,
    epic_forward,
    forward_from_temb,
    narrow_buffer,
    narrow_buffer_size,
)

_workspace_cache = {}


# ------------------------------------------------------------ plain versions


def epic_train_forward_reference(packed: PackedEncoder, t, x, k, mask):
    """Plain version: the forward on the packed weights, differentiable
    through `packed.flat` by autograd. (B, N, 3 + 8) float32."""
    epic_train_forward_reference.calls += 1
    temb = sinusoidal_positional_encoding(t.reshape(x.shape[0]), packed.dims.emb_t)
    cont, disc = forward_from_temb(packed, temb, x.float(), k, mask.float())
    return torch.cat([cont, disc], dim=-1)


epic_train_forward_reference.calls = 0


def epic_backward_reference(packed: PackedEncoder, t, x, k, mask, g):
    """Plain version of the backward kernel: d(flat) of Σ out·g by autograd
    through `forward_from_temb`, on a fresh leaf copy of the weights."""
    epic_backward_reference.calls += 1
    with torch.enable_grad():
        flat = packed.flat.detach().clone().requires_grad_(True)
        leaf = packed.rebind(flat)
        temb = sinusoidal_positional_encoding(t.reshape(x.shape[0]), packed.dims.emb_t)
        cont, disc = forward_from_temb(leaf, temb, x.float(), k, mask.float())
        (d_flat,) = torch.autograd.grad(torch.cat([cont, disc], dim=-1), flat, g)
    return d_flat


epic_backward_reference.calls = 0


def near_kink_jets(packed: PackedEncoder, t, x, k, mask, margin: float = 8.0):
    """(B,) bool: jets where some input z of a leaky or SELU lies within
    `margin` times the jet's float32 rounding error of 0 (but is not exactly
    0). There two float32 evaluations of the forward that sum in other orders
    may take different branches of the derivative (leaky 1 / 0.01, SELU 1.05
    / 1.76), which changes the whole jet's gradient through the pooled sums;
    a comparison of two backward implementations leaves such jets out.

    The rounding error is measured, per jet and activation: the largest
    |z_float32 − z_float64| over the jet's inputs of that activation, from
    the plain forward run in both precisions on the same weights. Per-particle
    trunk inputs count on unmasked slots only (a masked slot's cotangent is
    0); the SELU head's on every slot, since the heads see masked rows."""
    temb = sinusoidal_positional_encoding(t.reshape(x.shape[0]), packed.dims.emb_t)

    def preacts(dtype):
        flat = packed.flat.detach().to(dtype)
        out = []
        forward_from_temb(packed.rebind(flat), temb.to(dtype), x.to(dtype), k, mask.to(dtype), out)
        return out

    with torch.no_grad():
        lo, hi = preacts(torch.float32), preacts(torch.float64)
    real = mask[..., 0] > 0
    near = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for (name, z), (_, z64) in zip(lo, hi):
        live = torch.ones_like(z, dtype=torch.bool)
        if z.dim() == 3 and name != "z_h0":
            live &= real[..., None]
        err = torch.where(live, (z.double() - z64).abs(), 0.0).flatten(1).amax(dim=1)
        window = margin * err.view((-1,) + (1,) * (z.dim() - 1))
        close = (z64.abs() < window) & (z != 0) & live
        near |= close.flatten(1).any(dim=1)
    return near


# ------------------------------------------------------------ kernel wrappers


def _workspace(lib, B, N, dims, device):
    """(grid, scratch floats) of the backward launch, cached per shape."""
    key = (B, N, tuple(dims.c_array()), device)
    if key not in _workspace_cache:
        grid, floats = ctypes.c_int(0), ctypes.c_longlong(0)
        with torch.cuda.device(device):
            rc = lib.mmp_epic_backward_workspace(
                B, N, dims.c_array(), ctypes.byref(grid), ctypes.byref(floats))
        _build.check(lib, rc, "mmp_epic_backward_workspace")
        _workspace_cache[key] = (grid.value, floats.value)
    return _workspace_cache[key]


def epic_backward(packed: PackedEncoder, t, x, k, mask, g, rerun_out=None):
    """d(flat) (n,) float32 for the cotangent g (B, N, 3 + 8) of the EPiC
    forward at (t, x, k, mask). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise. The kernel reads the packing's
    tensor-core buffer (`with_narrow_buffer`) and the packed weights. `rerun_out`, a (B, N, 3 + 8) float32 tensor,
    receives the outputs of the kernel's rerun of the forward."""
    if x.device.type == "cpu":
        return epic_backward_reference(packed, t, x, k, mask, g)
    check_narrow_packing(packed)
    if packed.tensor_core is None:
        raise ValueError("the backward kernel reads the tensor-core buffer that "
                         "with_narrow_buffer adds to the packing")
    (buffer,) = packed.tensor_core
    B, N = check_kernel_inputs(packed, x, k, mask, t=t, g=g, tensor_core=buffer)
    if t.numel() != B:
        raise ValueError(f"t must hold one time per jet, got {tuple(t.shape)}")
    if tuple(g.shape) != (B, N, DIM_C + VOCAB):
        raise ValueError(f"g must be ({B}, {N}, {DIM_C + VOCAB}), got {tuple(g.shape)}")
    size = narrow_buffer_size(packed.dims)
    if buffer.numel() != size:
        raise ValueError(f"the backward kernel's buffer holds {size} floats at {packed.dims}, "
                         f"got {buffer.numel()}")
    if rerun_out is not None and (tuple(rerun_out.shape) != (B, N, DIM_C + VOCAB)
                                  or rerun_out.dtype != torch.float32
                                  or rerun_out.device != x.device
                                  or not rerun_out.is_contiguous()):
        raise ValueError(f"rerun_out must be a contiguous float32 ({B}, {N}, {DIM_C + VOCAB}) "
                         f"tensor on {x.device}")
    out = torch.empty_like(packed.flat)
    if B == 0:
        return out.zero_()
    lib = _build.load_library()
    grid, floats = _workspace(lib, B, N, packed.dims, x.device)
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
    k32 = k.to(torch.int32).contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mmp_epic_backward(
            buffer.data_ptr(), packed.flat.data_ptr(), t.data_ptr(), x.data_ptr(),
            k32.data_ptr(), mask.data_ptr(), g.data_ptr(), out.data_ptr(),
            None if rerun_out is None else rerun_out.data_ptr(), scratch.data_ptr(),
            grid, B, N, packed.dims.c_array(), stream,
        )
    _build.check(lib, rc, "mmp_epic_backward")
    epic_backward.launches += 1
    return out


epic_backward.launches = 0


class EpicTrainForward(torch.autograd.Function):
    """Forward by the K1 kernel, backward by the K3 backward kernel; only
    the flat weights get a gradient, from the backward's rerun of K1 on the
    buffer K1 read."""

    @staticmethod
    def forward(ctx, flat, dims, t, x, k, mask):
        buffer = narrow_buffer(flat, dims)
        out = epic_forward(PackedEncoder(flat, {}, dims, tensor_core=(buffer,)), t, x, k, mask)
        ctx.save_for_backward(flat, buffer, t, x, k, mask)
        ctx.dims = dims
        return out

    @staticmethod
    def backward(ctx, g):
        flat, buffer, t, x, k, mask = ctx.saved_tensors
        d_flat = epic_backward(PackedEncoder(flat, {}, ctx.dims, tensor_core=(buffer,)), t, x, k,
                               mask, g.float().contiguous())
        return d_flat, None, None, None, None, None


def epic_train_forward(packed: PackedEncoder, t, x, k, mask):
    """Differentiable EPiC forward (make_epic_train_forward's function):
    (B, N, 3 + 8), with d/d(packed.flat) by the backward kernel on CUDA and
    by autograd through the plain version on the CPU."""
    if x.device.type == "cpu":
        return epic_train_forward_reference(packed, t, x, k, mask)
    return EpicTrainForward.apply(packed.flat, packed.dims, t, x, k, mask)
