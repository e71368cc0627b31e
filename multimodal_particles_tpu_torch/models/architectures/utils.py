"""Embedding layer and weight-normed linear layer for the EPiC backbone
(multimodal_particles_tpu/models/architectures/utils.py:15-177)."""

import math

import torch
import torch.nn.functional as F
from torch import nn


def sinusoidal_positional_encoding(timesteps, dim, max_period=10000.0):
    """Log-spaced frequency time encoding (utils.py:15-34).

    Args:
      timesteps: (B,) or (B, 1) float times.
    Returns:
      (B, dim) embedding, [cos | sin] (cos first), computed in float32 and
      returned in the caller's floating dtype; a zero column is appended when
      dim is odd.
    """
    t = timesteps.reshape(timesteps.shape[0]).to(torch.float32)
    half = dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(-math.log(max_period) * idx / half)
    args = t[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb.to(timesteps.dtype) if timesteps.is_floating_point() else emb


def get_timestep_embedding(timesteps, embedding_dim, max_timesteps=10000.0):
    """DDPM-style sinusoidal embedding (utils.py:37-49): [sin | cos] (sin
    first), frequencies exp(-log(max_timesteps)·i/(half − 1)); a zero column
    is appended when the width is odd. The survival head feeds it 1000·t. Not
    `sinusoidal_positional_encoding`, whose halves and denominator differ.

    Args:
      timesteps: (B,) float times.
    Returns:
      (B, embedding_dim), computed in float32 and returned in the caller's
      floating dtype.
    """
    half = embedding_dim // 2
    scale = math.log(max_timesteps) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=timesteps.device) * -scale)
    args = timesteps.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    if embedding_dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=1)
    return emb.to(timesteps.dtype) if timesteps.is_floating_point() else emb


# jax.nn.selu's constants
SELU_ALPHA = 1.6732632423543772
SELU_SCALE = 1.0507009873554805


def narrow(x) -> bool:
    """Whether x's dtype is narrower than float32 (the bfloat16 compute
    dtype). On the CPU XLA rounds every elementwise operation of such an
    array to its dtype, and a Python constant too, where PyTorch's fused
    activations compute in float32 and round once: the activations below
    take XLA's steps in a narrow dtype and PyTorch's own op otherwise."""
    return x.dtype.itemsize < 4


def constant_as(x, c: float) -> float:
    """The Python constant c as x's dtype holds it (jnp rounds a weak-typed
    constant to the array's dtype: bfloat16's 0.01 is 0.010009765625); c
    itself for float32 and wider."""
    return float(torch.tensor(c, dtype=x.dtype)) if narrow(x) else c


class _NarrowSigmoid(torch.autograd.Function):
    """1 / (1 + exp(−x)), each step rounded, with lax.logistic's derivative
    y·(1 − y): autograd of the steps gives 0·inf where exp(−x) overflows."""

    @staticmethod
    def forward(ctx, x):
        one = torch.ones((), dtype=x.dtype, device=x.device)
        y = one / (one + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        (y,) = ctx.saved_tensors
        return grad * (y * (1 - y))


def sigmoid(x):
    """jax.nn.sigmoid: 1 / (1 + exp(−x)), each step rounded in a narrow dtype."""
    return _NarrowSigmoid.apply(x) if narrow(x) else torch.sigmoid(x)


class SELU(nn.Module):
    """jax.nn.selu: scale · where(x > 0, x, alpha · expm1(min(x, 0))), each step
    rounded in a narrow dtype (the expm1 of the clipped input, as jax.nn.elu
    takes it, keeps the unused branch's gradient finite); F.selu otherwise."""

    def forward(self, x):
        if not narrow(x):
            return F.selu(x)
        alpha, scale = constant_as(x, SELU_ALPHA), constant_as(x, SELU_SCALE)
        safe = torch.where(x > 0, torch.zeros_like(x), x)
        return scale * torch.where(x > 0, x, alpha * torch.expm1(safe))


def promoted(x, *params):
    """x and the parameters cast to their common floating dtype (bfloat16
    with float32 gives float32, as jnp promotes): a flax layer with parameters
    of another dtype than its input computes in that dtype. In float32 every
    tensor is returned as it is."""
    dtype = x.dtype
    for p in params:
        if p is not None:
            dtype = torch.promote_types(dtype, p.dtype)
    return tuple(t if t is None or t.dtype == dtype else t.to(dtype) for t in (x, *params))


def linear(x, weight, bias):
    """x·Wᵀ + b in the promoted dtype of x and the parameters: one F.linear in
    float32; in a narrower dtype the product and the bias sum each rounded to
    it, as flax's Dense computes them (two operations)."""
    x, weight, bias = promoted(x, weight, bias)
    if not narrow(x):
        return F.linear(x, weight, bias)
    return F.linear(x, weight) + bias


class Dense(nn.Linear):
    """flax `nn.Dense` (dtype None): nn.Linear in the promoted dtype of its
    input and parameters (`linear`)."""

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class WeightNormLinear(nn.Module):
    """Linear layer with weight normalization W = g · v / ‖v‖, the norm taken
    per output unit and clamped at 1e-12 (utils.py:52-86, flax
    `WeightNormDense`). `v` is stored (out, in), the torch Linear layout."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.v = nn.Parameter(torch.empty(out_features, in_features))
        self.g = nn.Parameter(torch.empty(out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def effective_weight(self) -> torch.Tensor:
        v = self.v
        if narrow(v):
            # as jnp.linalg.norm computes it: the squares and their sum in
            # float32, the sum rounded to v's dtype before the root
            sum_sq = torch.sum(torch.square(v.float()), dim=1, keepdim=True).to(v.dtype)
        else:
            sum_sq = torch.sum(v * v, dim=1, keepdim=True)
        norm = torch.sqrt(sum_sq)
        return (self.g[:, None] / torch.clamp(norm, min=1e-12)) * self.v

    def forward(self, x):
        return linear(x, self.effective_weight(), self.bias)


def embedding_dims(config):
    """(time, continuous, discrete) embedding widths (utils.py:104-108)."""
    cfg_d, cfg_e = config.data, config.encoder
    return (
        cfg_e.dim_emb_time,
        cfg_e.dim_emb_features_continuous or cfg_d.dim_features_continuous,
        cfg_e.dim_emb_features_discrete,
    )


class InputEmbeddings(nn.Module):
    """Per-particle features [t_emb, x_emb, k_emb] (masked) and the global
    context [t_emb, ctx_cont_emb, ctx_disc_emb] (utils.py:89-177), with every
    switch of the JAX module:

      embedding_time                 "SinusoidalPositionalEncoding", or "Linear"
                                     (a Dense over t)
      embedding_features_continuous  "Linear", or None (x itself)
      embedding_features_discrete    "Embedding" (a token's table row), or
                                     "Linear": a Dense over the float token
                                     ids (B, N, dim_features_discrete), or
                                     with `discrete_channel_values` over the
                                     (B, N, V) channel values that the
                                     transdimensional trunk feeds
      dim_context_continuous > 0     a Dense over the (B, Dcc) context
      dim_context_discrete > 0       an Embedding of each of the (B, Dcd)
                                     context tokens, flattened to
                                     (B, Dcd · dim_emb_context_discrete)

    flax infers the widths from the arrays; here they follow from the config
    at construction (`dim_local`, `dim_context`). `context_tokens` is how
    many discrete context tokens a jet carries when that is not the config's
    `dim_context_discrete`: the transdimensional family's 'list' batches
    carry the one-hot of the first token, `vocab_size_context` entries of 0
    or 1, and JAX embeds each entry as a token."""

    def __init__(self, config, discrete_channel_values: bool = False, context_tokens=None):
        super().__init__()
        cfg_d, cfg_e = config.data, config.encoder
        if cfg_e.embedding_time not in ("SinusoidalPositionalEncoding", "Linear"):
            raise NotImplementedError(f"Time embedding {cfg_e.embedding_time!r} not implemented")
        if cfg_e.embedding_features_continuous not in ("Linear", None):
            raise NotImplementedError(
                f"Continuous embedding {cfg_e.embedding_features_continuous!r}")
        if cfg_d.dim_features_discrete and cfg_e.embedding_features_discrete not in (
                "Embedding", "Linear"):
            raise NotImplementedError(
                f"Discrete embedding {cfg_e.embedding_features_discrete!r}")
        self.dim_emb_time, dim_emb_cont, dim_emb_disc = embedding_dims(config)
        self.dim_local = self.dim_context = self.dim_emb_time
        if cfg_e.embedding_time == "Linear":
            self.embedding_time = Dense(1, self.dim_emb_time)
        self.continuous_input = bool(dim_emb_cont)
        if self.continuous_input:
            if cfg_e.embedding_features_continuous == "Linear":
                self.embedding_continuous = Dense(cfg_d.dim_features_continuous, dim_emb_cont)
            else:
                dim_emb_cont = cfg_d.dim_features_continuous
            self.dim_local += dim_emb_cont
        self.linear_discrete = False
        if cfg_d.dim_features_discrete:
            self.linear_discrete = cfg_e.embedding_features_discrete == "Linear"
            if self.linear_discrete:
                width_in = (cfg_d.vocab_size_features if discrete_channel_values
                            else cfg_d.dim_features_discrete)
                self.embedding_discrete = Dense(width_in, dim_emb_disc)
            else:
                self.embedding_discrete = nn.Embedding(cfg_d.vocab_size_features, dim_emb_disc)
            self.dim_local += dim_emb_disc
        self.dim_context_continuous = cfg_d.dim_context_continuous
        if self.dim_context_continuous:
            width = cfg_e.dim_emb_context_continuous or cfg_d.dim_context_continuous
            self.embedding_continuous_context = Dense(cfg_d.dim_context_continuous, width)
            self.dim_context += width
        self.dim_context_discrete = cfg_d.dim_context_discrete
        if self.dim_context_discrete:
            self.embedding_context_discrete = nn.Embedding(
                cfg_d.vocab_size_context, cfg_e.dim_emb_context_discrete)
            if context_tokens is None:
                context_tokens = cfg_d.dim_context_discrete
            self.dim_context += context_tokens * cfg_e.dim_emb_context_discrete

    def forward(self, t, x, k, mask, context_continuous=None, context_discrete=None):
        """k: (B, N, 1) tokens, or with the Linear discrete input over channel
        values the (B, N, V) values; context_continuous (B, Dcc) float,
        context_discrete (B, Dcd) tokens, each read when the config has it."""
        B, N = x.shape[0], x.shape[1]
        t_flat = t.reshape(B, -1)[:, :1]
        if hasattr(self, "embedding_time"):
            t_emb = self.embedding_time(t_flat)
        else:
            t_emb = sinusoidal_positional_encoding(t_flat, self.dim_emb_time)
        features = [t_emb[:, None, :].expand(B, N, t_emb.shape[-1])]
        context = [t_emb]
        if self.continuous_input:
            features.append(self.embedding_continuous(x)
                            if hasattr(self, "embedding_continuous") else x)
        if hasattr(self, "embedding_discrete"):
            if self.linear_discrete:
                features.append(self.embedding_discrete(k.to(torch.float32)))
            else:
                features.append(self.embedding_discrete(k.reshape(B, N).long()))
        if self.dim_context_continuous:
            if context_continuous is None:
                raise ValueError("the config has a continuous context; the batch carries none")
            context.append(self.embedding_continuous_context(context_continuous))
        if self.dim_context_discrete:
            if context_discrete is None:
                raise ValueError("the config has a discrete context; the batch carries none")
            tokens = context_discrete.reshape(B, -1).long()
            context.append(self.embedding_context_discrete(tokens).reshape(B, -1))
        features = torch.cat(features, dim=-1)
        if mask is not None:
            features = features * mask
        return features, torch.cat(context, dim=-1)
