"""The masked multi-head attention core of an AttnBlock as one hand-written
CUDA kernel (counterpart of multimodal_particles_tpu/ops/attention_pallas.py).

Per jet and head: softmax over the keys of q·kᵀ/√d plus an additive key bias
(−1e9 on the keys whose (B, N, 1) mask is 0, none without a mask), times v;
q, k, v and the output are (B, N, C), before proj_out and the residual.
`attention_core` launches ops/csrc/attention_core.cu on CUDA tensors, a
block a (jet, head) pair, its products on the tensor cores at fp32 accuracy
(the 3×TF32 split of ops/csrc/tf32x3.cuh);
`attention_core_reference` is its plain PyTorch version, the einsum of
`_core_jnp` (:77-87), which the wrapper takes for CPU tensors.
`AttentionCore` is the differentiable form, as `attention_core_pallas` is in
JAX: its forward is the kernel, its backward autograd of the einsum
(`_attention_core_bwd`, :123-128); the JAX package has no backward kernel, so
the port writes none.
"""

import torch

from multimodal_particles_tpu_torch.ops import _build

# what the kernel takes (ops/csrc/attention_core.cu): the transformer widths
# of the head kernels (ops/gsdm_stack_cuda.py, which imports this module
# through gsdm.py), heads of at most 128 channels, N ≤ 256 (past SPLIT_ROWS
# a block takes half of a (jet, head) pair's query rows)
WIDTHS = (128, 256, 384, 512)
MAX_HEAD_WIDTH = 128
MAX_PARTICLES = 256
SPLIT_ROWS = 128
MASKED_KEY_BIAS = -1e9  # attention_pallas.py:149


def key_bias(mask, B: int, N: int, like):
    """(B, 1, N) additive key bias: 0 on valid keys, −1e9 on masked ones;
    zeros without a mask (attention_pallas.py:148-151)."""
    if mask is None:
        return torch.zeros((B, 1, N), dtype=like.dtype, device=like.device)
    return torch.where(mask[..., 0] > 0, 0.0, MASKED_KEY_BIAS).to(like.dtype)[:, None, :]


def _core(q, k, v, bias, n_heads: int):
    """The einsum core on a (B, 1, N) bias (`_core_jnp`)."""
    B, N, C = q.shape
    hd = C // n_heads
    q4, k4, v4 = (a.reshape(B, N, n_heads, hd) for a in (q, k, v))
    w = torch.einsum("bkhd,bqhd->bhqk", k4, q4) * hd**-0.5
    w = torch.softmax(w + bias[:, None, :, :], dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v4).reshape(B, N, C)


def attention_core_reference(q, k, v, mask=None, *, n_heads: int):
    """Plain PyTorch version of the kernel: softmax(q·kᵀ/√d + bias)·v per jet
    and head, (B, N, C)."""
    attention_core_reference.calls += 1
    return _core(q, k, v, key_bias(mask, q.shape[0], q.shape[1], q), n_heads)


attention_core_reference.calls = 0


def attention_core_supported(shape, n_heads: int) -> bool:
    """True when the kernel takes q of `shape` (B, N, C) with `n_heads`
    heads: C one of 128, 256, 384, 512, 1 ≤ N ≤ 256, heads of at most 128
    channels that divide C (a width that is not a multiple of 8 is
    zero-padded inside the kernel)."""
    if len(shape) != 3:
        return False
    _, N, C = shape
    return (C in WIDTHS and 1 <= N <= MAX_PARTICLES and n_heads >= 1 and C % n_heads == 0
            and C // n_heads <= MAX_HEAD_WIDTH)


def attention_core(q, k, v, mask=None, *, n_heads: int):
    """Fused attention core. q, k, v (B, N, C) float32, mask (B, N, 1) or
    None → (B, N, C) float32. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if q.device.type == "cpu":
        return attention_core_reference(q, k, v, mask, n_heads=n_heads)
    if not attention_core_supported(q.shape, n_heads):
        raise ValueError(f"the attention kernel takes (B, N ≤ {MAX_PARTICLES}, C in {WIDTHS}) "
                         f"with heads of at most {MAX_HEAD_WIDTH} channels, got "
                         f"{tuple(q.shape)} and {n_heads} heads")
    B, N, C = q.shape
    tensors = {"q": q, "k": k, "v": v}
    if mask is not None:
        if tuple(mask.shape) != (B, N, 1):
            raise ValueError(f"mask must be ({B}, {N}, 1), got {tuple(mask.shape)}")
        tensors["mask"] = mask = mask.to(torch.float32).contiguous()
    for name, tensor in tensors.items():
        if name != "mask" and tuple(tensor.shape) != (B, N, C):
            raise ValueError(f"{name} must be ({B}, {N}, {C}), got {tuple(tensor.shape)}")
        if tensor.device != q.device:
            raise ValueError(f"{name} is on {tensor.device}, q on {q.device}")
        if tensor.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {tensor.dtype}")
        if not tensor.is_contiguous() or tensor.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty((B, N, C), dtype=torch.float32, device=q.device)
    if B == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mmp_attention_core(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask.data_ptr() if mask is not None else None, out.data_ptr(),
            B * n_heads * (2 if N > SPLIT_ROWS else 1), B, N, C, n_heads, stream,
        )
    _build.check(lib, rc, "mmp_attention_core")
    attention_core.launches += 1
    return out


attention_core.launches = 0


class AttentionCore(torch.autograd.Function):
    """Forward by the kernel (the plain version for CPU tensors), backward by
    autograd of the einsum; the mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, n_heads):
        ctx.save_for_backward(q, k, v, mask)
        ctx.n_heads = n_heads
        return attention_core(q, k, v, mask, n_heads=n_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_(True) for a in (q, k, v)]
            out = _core(*leaves, key_bias(mask, q.shape[0], q.shape[1], q), ctx.n_heads)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None)
