"""Transformer pieces of the survival-rate head
(multimodal_particles_tpu/models/architectures/gsdm.py:23-105), in (B, N, C)
layout: a kernel-size-1 Conv1d is a Linear over the channel axis.

GroupNorm has 32 groups of neighbouring channels; a group's statistics run
over its channels and over all N slots of a jet, dead ones included, with the
biased variance and eps 1e-6, as flax's `nn.GroupNorm` on (B, N, C) and
torch's on (B, C, N) compute them. These modules are the plain form of what
ops/survival_cuda.py fuses into one kernel.
"""

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_particles_tpu_torch.models.architectures.utils import Dense, promoted, sigmoid
from multimodal_particles_tpu_torch.ops.attention_cuda import (
    AttentionCore,
    attention_core_supported,
)

GN_GROUPS = 32
GN_EPS = 1e-6


def swish(x):
    return x * sigmoid(x)


def group_norm(x, weight, bias, groups: int = GN_GROUPS, eps: float = GN_EPS):
    """GroupNorm of (B, N, C) over (N, C/groups) per jet and group, in the
    promoted dtype of x and the parameters."""
    x, weight, bias = promoted(x, weight, bias)
    return F.group_norm(x.transpose(1, 2), groups, weight, bias, eps).transpose(1, 2)


class GroupNorm(nn.Module):
    """flax `nn.GroupNorm(num_groups=32, epsilon=1e-6)` on (B, N, C)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return group_norm(x, self.weight, self.bias)


class ResnetBlock(nn.Module):
    """norm → swish → dense → +time-emb → norm → swish → dropout → dense → +x
    (gsdm.py:27-46)."""

    def __init__(self, channels: int, dropout: float = 0.0, temb_channels: int = 512):
        super().__init__()
        self.norm1 = GroupNorm(channels)
        self.conv1 = Dense(channels, channels)
        self.temb_proj = Dense(temb_channels, channels)
        self.norm2 = GroupNorm(channels)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = Dense(channels, channels)

    def forward(self, x, temb):
        """x: (B, N, C); temb: (B, temb_channels)."""
        h = self.conv1(swish(self.norm1(x)))
        h = h + self.temb_proj(swish(temb))[:, None, :]
        h = self.conv2(self.dropout(swish(self.norm2(h))))
        return x + h


class AttnBlock(nn.Module):
    """Multi-head self-attention over the particle axis with residual
    (gsdm.py:49-105): heads are contiguous channel ranges, the scores are
    scaled by head_dim^-0.5, and without `mask` every slot attends over all N
    slots.

    `use_pallas` picks the attention core as the JAX module's does
    (gsdm.py:62-72): False, the einsum path; True, the fused core
    (ops/attention_cuda.py: the kernel on CUDA tensors, its plain version on
    CPU ones; backward by autograd of the einsum); "auto", the kernel on CUDA
    tensors of a shape it takes, the einsum path otherwise. With
    `attn_dim_reduce` other than 1 it is always the einsum path. No model
    turns it on: the JAX package measured the einsum ~9× faster on v5e."""

    def __init__(self, in_channels: int, n_heads: int = 1, attn_dim_reduce: int = 1,
                 use_pallas=False):
        super().__init__()
        c = in_channels // attn_dim_reduce
        self.n_heads = n_heads
        self.attn_dim_reduce = attn_dim_reduce
        self.use_pallas = use_pallas
        self.norm = GroupNorm(in_channels)
        self.q = Dense(in_channels, c)
        self.k = Dense(in_channels, c)
        self.v = Dense(in_channels, c)
        self.proj_out = Dense(c, in_channels)

    def _core_on(self, q) -> bool:
        """Whether the fused core computes the attention (`_pallas_on`)."""
        if not self.use_pallas or self.attn_dim_reduce != 1:
            return False
        if self.use_pallas == "auto":
            return q.device.type == "cuda" and attention_core_supported(q.shape, self.n_heads)
        return True

    def forward(self, x, mask=None):
        """x: (B, N, C); mask: optional (B, N, 1) validity mask of the keys."""
        B, N, _ = x.shape
        h = self.norm(x)
        q, k, v = self.q(h), self.k(h), self.v(h)
        if self._core_on(q):
            return x + self.proj_out(AttentionCore.apply(q, k, v, mask, self.n_heads))
        c = q.shape[-1]
        heads, head_dim = self.n_heads, c // self.n_heads
        q = q.reshape(B, N, heads, head_dim)
        k = k.reshape(B, N, heads, head_dim)
        v = v.reshape(B, N, heads, head_dim)
        w = torch.einsum("bkhd,bqhd->bhqk", k, q) * head_dim**-0.5
        if mask is not None:
            w = w + torch.where(mask[:, None, None, :, 0] > 0, 0.0, -1e9)
        w = torch.softmax(w, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, N, c)
        return x + self.proj_out(out)
