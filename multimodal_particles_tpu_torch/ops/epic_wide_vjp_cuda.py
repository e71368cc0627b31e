"""Wide EPiC forward with a hand-written backward kernel for training
(counterpart of multimodal_particles_tpu/ops/epic_pallas_wide_vjp.py).

`EpicWideTrainForward` is a `torch.autograd.Function` whose boundary sits at
the packed effective weights in the wide layout, as the JAX custom VJP's
does: weight normalization and the module → buffer mapping run in plain
PyTorch outside it (`pack_wide_encoder_params(..., differentiable=True)`), so
autograd chains d(flat) to v, g and the rest.

  forward   the K4 kernel (ops/csrc/epic_wide_forward.cu): the JAX
            `_fwd_kernel` runs the same `_forward_acts_wide`
  backward  ops/csrc/epic_wide_backward.cu: recomputes the forward
            activations as K4 computes them and returns d(flat) for a
            cotangent g (B, N, 3 + 8); t, x, k and mask get no gradient
            (epic_pallas_wide_vjp.py:362-369). Its products run on the tensor
            cores: it reads K4's stages and tables, which the wide packing
            carries, and the transposed stages of its dz·Wᵀ products, which
            its wrapper makes (`tensor_core_transposed_stages`)

At every width 128 and N ≤ 128 the backward is one block a jet; at the other
widths `wide_supported` takes (MBM's token input and 8-wide head) a cluster
of hidden / 128 blocks (ops/csrc/epic_wide_backward_any.cuh), its transposed
stages a 128-column block after the other; on jets of 129 to 256 slots, at
every width, a cluster of hidden / 128 × 2 row blocks
(`epic_wide_backward_h*_r2.cu`), its persistent grid as many clusters as
the card holds at once.

`epic_train_forward_wide` dispatches: CUDA tensors go to the kernels or
raise, CPU tensors to `epic_train_forward_reference`, autograd through the
plain `forward_from_temb`. `epic_backward_wide` exposes the backward alone;
its plain version is `epic_backward_reference`, which follows the packing's
layout.
"""

import ctypes

import torch

from multimodal_particles_tpu_torch.ops import _build
from multimodal_particles_tpu_torch.ops.epic_cuda import (
    DIM_C,
    VOCAB,
    EpicDims,
    PackedEncoder,
    check_kernel_inputs,
    column_blocks,
    tensor_core_stages,
    wide_flat_views,
)
from multimodal_particles_tpu_torch.ops.epic_vjp_cuda import (
    epic_backward_reference,
    epic_train_forward_reference,
)
from multimodal_particles_tpu_torch.ops.epic_wide_cuda import (
    WIDE_MAX_PARTICLES,
    check_wide_packing,
    epic_forward_wide,
)

_workspace_cache = {}


def tensor_core_transposed_stages(flat: torch.Tensor, d: EpicDims):
    """The wide backward kernel's dz·Wᵀ weights, made from a wide-layout
    buffer: per EPiC layer the stages of fc_local2 transposed, then of
    fc_local1's particle third transposed, each as its column blocks, laid
    out as `tensor_core_weights` lays out the forward's (the transposes are
    the (in, out) matrices of the backward's products: their input is the
    forward's output)."""
    with torch.no_grad():
        views = wide_flat_views(flat.detach(), d)
        weights = [block for i in range(d.num_blocks)
                   for w in (views[f"w_fl2_{i}"], views[f"w_fl1_{i}"][:, :d.hidden])
                   for block in column_blocks(w)]
        stages = tensor_core_stages(torch.stack(weights)) if weights else flat.new_zeros(4)
    return stages.contiguous()


def _workspace(lib, B, N, dims, device):
    """(grid, scratch floats) of the backward launch, cached per shape."""
    key = (B, N, tuple(dims.c_array()), device)
    if key not in _workspace_cache:
        grid, floats = ctypes.c_int(0), ctypes.c_longlong(0)
        with torch.cuda.device(device):
            rc = lib.mmp_epic_wide_backward_workspace(
                B, N, dims.c_array(), ctypes.byref(grid), ctypes.byref(floats))
        _build.check(lib, rc, "mmp_epic_wide_backward_workspace")
        _workspace_cache[key] = (grid.value, floats.value)
    return _workspace_cache[key]


def epic_backward_wide(packed: PackedEncoder, t, x, k, mask, g):
    """d(flat) (n,) float32, in the wide layout, for the cotangent g
    (B, N, 3 + 8) of the wide EPiC forward at (t, x, k, mask). CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return epic_backward_reference(packed, t, x, k, mask, g)
    check_wide_packing(packed)
    B, N = check_kernel_inputs(packed, x, k, mask, WIDE_MAX_PARTICLES, t=t, g=g)
    if t.numel() != B:
        raise ValueError(f"t must hold one time per jet, got {tuple(t.shape)}")
    if tuple(g.shape) != (B, N, DIM_C + VOCAB):
        raise ValueError(f"g must be ({B}, {N}, {DIM_C + VOCAB}), got {tuple(g.shape)}")
    out = torch.empty_like(packed.flat)
    if B == 0:
        return out.zero_()
    if packed.tensor_core is None:
        raise ValueError("the wide backward kernel reads the tensor-core stages and tables "
                         "that pack_encoder makes with the wide packing")
    stages, tables = packed.tensor_core
    transposed = tensor_core_transposed_stages(packed.flat, packed.dims)
    lib = _build.load_library()
    grid, floats = _workspace(lib, B, N, packed.dims, x.device)
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
    k32 = k.to(torch.int32).contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mmp_epic_wide_backward(
            packed.flat.data_ptr(), stages.data_ptr(), tables.data_ptr(),
            transposed.data_ptr(), t.data_ptr(), x.data_ptr(), k32.data_ptr(),
            mask.data_ptr(), g.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            grid, B, N, packed.dims.c_array(), stream,
        )
    _build.check(lib, rc, "mmp_epic_wide_backward")
    epic_backward_wide.launches += 1
    return out


epic_backward_wide.launches = 0


class EpicWideTrainForward(torch.autograd.Function):
    """Forward by the K4 kernel, backward by the K5 backward kernel; only
    the flat weights get a gradient."""

    @staticmethod
    def forward(ctx, flat, dims, tensor_core, t, x, k, mask):
        out = epic_forward_wide(PackedEncoder(flat, {}, dims, "wide", tensor_core), t, x, k, mask)
        ctx.save_for_backward(flat, t, x, k, mask)
        ctx.dims, ctx.tensor_core = dims, tensor_core
        return out

    @staticmethod
    def backward(ctx, g):
        flat, t, x, k, mask = ctx.saved_tensors
        packed = PackedEncoder(flat, {}, ctx.dims, "wide", ctx.tensor_core)
        d_flat = epic_backward_wide(packed, t, x, k, mask, g.float().contiguous())
        return d_flat, None, None, None, None, None, None


def epic_train_forward_wide(packed: PackedEncoder, t, x, k, mask):
    """Differentiable wide EPiC forward (make_epic_train_forward_wide's
    function): (B, N, 3 + 8), with d/d(packed.flat) by the backward kernel on
    CUDA and by autograd through the plain version on the CPU."""
    if x.device.type == "cpu":
        return epic_train_forward_reference(packed, t, x, k, mask)
    check_wide_packing(packed)
    return EpicWideTrainForward.apply(packed.flat, packed.dims, packed.tensor_core, t, x, k, mask)
