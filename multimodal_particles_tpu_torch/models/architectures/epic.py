"""EPiC (Equivariant Point Cloud) backbone
(multimodal_particles_tpu/models/architectures/epic.py:32-161).

Permutation-equivariant deep-sets stack with masked mean+sum pooling and
local/global cross-updates, in eager PyTorch. This module stack is the oracle
that the hand-written kernels (ops/epic_cuda.py, ops/sampler_cuda.py) are held
to, after it is held to the flax stack.
"""

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_particles_tpu_torch.models.architectures.utils import (
    InputEmbeddings,
    WeightNormLinear,
    constant_as,
)


class _LeakyReLU(torch.autograd.Function):
    """leaky_relu with slope 0.01 whose derivative at exactly 0 is 1, as
    flax's `jnp.where(x >= 0, x, 0.01 x)` differentiates and as the JAX
    backward kernel's `_dleaky` (ops/epic_pallas_vjp.py:68-69) has it;
    F.leaky_relu's own backward gives 0.01 there. In a dtype narrower than
    float32 the slope is 0.01 as that dtype holds it, as in jnp."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.leaky_relu(x, negative_slope=constant_as(x, 0.01))

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, grad, constant_as(x, 0.01) * grad)


def leaky_relu(x):
    return _LeakyReLU.apply(x)


def meansum_pool(mask, x_local, *x_global):
    """Masked mean+sum pooling over particles, concatenated with globals
    (epic.py:32-41). The denominator is clamped at 1 so that empty jets give
    zeros, not NaN."""
    x_sum = torch.sum(x_local * mask, dim=1)
    denom = torch.clamp(torch.sum(mask, dim=1), min=1.0)
    return torch.cat([x_sum / denom, x_sum, *x_global], dim=1)


class EPiCProjection(nn.Module):
    """Input projection: local lift + pooled global init (epic.py:44-58)."""

    def __init__(self, dim_in, dim_context, dim_hidden_local, dim_hidden_global):
        super().__init__()
        H = dim_hidden_local
        self.local_0 = WeightNormLinear(dim_in, H)
        self.global_0 = WeightNormLinear(2 * H + dim_context, H)
        self.global_1 = WeightNormLinear(H, H)
        self.global_2 = WeightNormLinear(H, dim_hidden_global)

    def forward(self, x_local, x_global, mask):
        x_local = leaky_relu(self.local_0(x_local))
        pooled = meansum_pool(mask, x_local, x_global)
        h = leaky_relu(self.global_0(pooled))
        h = leaky_relu(self.global_1(h))
        x_global = leaky_relu(self.global_2(h))
        return x_local * mask, x_global


class EPiCLayer(nn.Module):
    """One local/global cross-update block with residuals (epic.py:61-88)."""

    def __init__(self, dim_local, dim_global, dim_hidden, dim_context):
        super().__init__()
        self.fc_global1 = WeightNormLinear(2 * dim_local + dim_global + dim_context, dim_hidden)
        self.fc_global2 = WeightNormLinear(dim_hidden, dim_global)
        self.fc_local1 = WeightNormLinear(dim_local + dim_global + dim_context, dim_hidden)
        self.fc_local2 = WeightNormLinear(dim_hidden, dim_local)

    def forward(self, x_local, x_global, context, mask):
        B, N = x_local.shape[0], x_local.shape[1]
        pooled = meansum_pool(mask, x_local, x_global, context)
        g1 = leaky_relu(self.fc_global1(pooled))
        x_global = leaky_relu(self.fc_global2(g1) + x_global)

        g2l = x_global[:, None, :].expand(B, N, x_global.shape[-1])
        c2l = context[:, None, :].expand(B, N, context.shape[-1])
        h = torch.cat([x_local, g2l, c2l], dim=-1)
        l1 = leaky_relu(self.fc_local1(h))
        x_local = leaky_relu(self.fc_local2(l1) + x_local)
        return x_local * mask, x_global


class EPiCNetwork(nn.Module):
    """Projection + num_blocks EPiC layers + weight-normed output
    (epic.py:91-125). Layers are named `epic_layer_{i}` as in flax."""

    def __init__(self, dim_in, dim_context, dim_output, num_blocks,
                 dim_hidden_local, dim_hidden_global, use_skip_connection):
        super().__init__()
        self.num_blocks = num_blocks
        self.use_skip_connection = use_skip_connection
        self.epic_proj = EPiCProjection(dim_in, dim_context, dim_hidden_local, dim_hidden_global)
        for i in range(num_blocks):
            self.add_module(
                f"epic_layer_{i}",
                EPiCLayer(dim_hidden_local, dim_hidden_global, dim_hidden_local, dim_context),
            )
        self.output_layer = WeightNormLinear(dim_hidden_local, dim_output)

    def forward(self, x_local, context, mask, output_hidden_local=False):
        x_local, x_global = self.epic_proj(x_local, context, mask)
        x_local_skip = x_local if self.use_skip_connection else 0.0
        x_global_skip = x_global if self.use_skip_connection else 0.0
        for i in range(self.num_blocks):
            layer = getattr(self, f"epic_layer_{i}")
            x_local, x_global = layer(x_local, x_global, context, mask)
            x_local = x_local + x_local_skip
            x_global = x_global + x_global_skip
        h = self.output_layer(x_local) * mask
        if output_hidden_local:
            return h, x_local
        return h


class EPiCWrapper(nn.Module):
    """Embeds (t, x, k, context) then runs the EPiC network (epic.py:128-161).
    The network's context is as wide as the embedding's: the time embedding
    and the context embeddings. With `discrete_channel_values` the caller may
    feed the (B, N, V) channel values as k (the Linear discrete embedding);
    `context_tokens` as in `InputEmbeddings`."""

    def __init__(self, config, discrete_channel_values: bool = False, context_tokens=None):
        super().__init__()
        cfg_d, cfg_e = config.data, config.encoder
        self.embedding = InputEmbeddings(config, discrete_channel_values, context_tokens)
        self.epic = EPiCNetwork(
            dim_in=self.embedding.dim_local,
            dim_context=self.embedding.dim_context,
            dim_output=cfg_d.dim_features_continuous
            + cfg_d.dim_features_discrete * cfg_d.vocab_size_features,
            num_blocks=cfg_e.num_blocks,
            dim_hidden_local=cfg_e.dim_hidden_local,
            dim_hidden_global=cfg_e.dim_hidden_glob,
            use_skip_connection=cfg_e.skip_connection,
        )

    def forward(self, t, x, k, mask, context_continuous=None, context_discrete=None,
                output_hidden_local=False):
        """With `output_hidden_local`, also the last block's local hidden
        state (B, N, H), which the survival head reads (epic.py:122-125)."""
        x_local_emb, context_emb = self.embedding(t, x, k, mask, context_continuous,
                                                  context_discrete)
        return self.epic(x_local_emb, context_emb, mask, output_hidden_local)
