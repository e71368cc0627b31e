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
      (B, dim) float32 embedding, [cos | sin] (cos first); a zero column is
      appended when dim is odd.
    """
    t = timesteps.reshape(timesteps.shape[0]).to(torch.float32)
    half = dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(-math.log(max_period) * idx / half)
    args = t[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def get_timestep_embedding(timesteps, embedding_dim):
    """DDPM-style sinusoidal embedding (utils.py:37-49): [sin | cos] (sin
    first), frequencies exp(-log(1e4)·i/(half − 1)); a zero column is appended
    when the width is odd. The survival head feeds it 1000·t. Not
    `sinusoidal_positional_encoding`, whose halves and denominator differ.

    Args:
      timesteps: (B,) float times.
    Returns:
      (B, embedding_dim) float32.
    """
    half = embedding_dim // 2
    scale = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=timesteps.device) * -scale)
    args = timesteps.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    if embedding_dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=1)
    return emb


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
        norm = torch.sqrt(torch.sum(self.v * self.v, dim=1, keepdim=True))
        return (self.g[:, None] / torch.clamp(norm, min=1e-12)) * self.v

    def forward(self, x):
        return F.linear(x, self.effective_weight(), self.bias)


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
    context t_emb (utils.py:89-177).

    Ported: Sinusoidal time, Linear continuous, no context, and the discrete
    input either as an Embedding of one token (config-berlin) or as a Linear
    over the V noisy one-hot channel values (the transdimensional trunk's
    default: `discrete_channel_values`, which a model that feeds the (B, N, V)
    values sets; a Dense over a token id is not ported). Other switches raise
    NotImplementedError (ROADMAP lists them)."""

    def __init__(self, config, discrete_channel_values: bool = False):
        super().__init__()
        cfg_d, cfg_e = config.data, config.encoder
        if cfg_e.embedding_time != "SinusoidalPositionalEncoding":
            raise NotImplementedError(
                f"Time embedding {cfg_e.embedding_time!r} not implemented"
            )
        if cfg_e.embedding_features_continuous != "Linear":
            raise NotImplementedError(
                f"Continuous embedding {cfg_e.embedding_features_continuous!r}"
            )
        self.linear_discrete = cfg_e.embedding_features_discrete == "Linear"
        allowed = ("Embedding", "Linear") if discrete_channel_values else ("Embedding",)
        if cfg_e.embedding_features_discrete not in allowed or cfg_d.dim_features_discrete != 1:
            raise NotImplementedError(
                f"Discrete embedding {cfg_e.embedding_features_discrete!r} with "
                f"dim_features_discrete={cfg_d.dim_features_discrete}"
            )
        if cfg_d.dim_context_continuous or cfg_d.dim_context_discrete:
            raise NotImplementedError("context embeddings are not ported")
        self.dim_emb_time, dim_emb_cont, dim_emb_disc = embedding_dims(config)
        self.embedding_continuous = nn.Linear(cfg_d.dim_features_continuous, dim_emb_cont)
        if self.linear_discrete:
            self.embedding_discrete = nn.Linear(cfg_d.vocab_size_features, dim_emb_disc)
        else:
            self.embedding_discrete = nn.Embedding(cfg_d.vocab_size_features, dim_emb_disc)

    @property
    def dim_local(self) -> int:
        return (
            self.dim_emb_time
            + self.embedding_continuous.out_features
            + self.embedding_discrete.weight.shape[0 if self.linear_discrete else 1]
        )

    def forward(self, t, x, k, mask):
        """k: (B, N, 1) tokens, or with the Linear discrete input the
        (B, N, V) channel values."""
        B, N = x.shape[0], x.shape[1]
        t_emb = sinusoidal_positional_encoding(t.reshape(B, -1)[:, :1], self.dim_emb_time)
        t_local = t_emb[:, None, :].expand(B, N, self.dim_emb_time)
        x_emb = self.embedding_continuous(x)
        if self.linear_discrete:
            k_emb = self.embedding_discrete(k.to(x.dtype))
        else:
            k_emb = self.embedding_discrete(k.reshape(B, N).long())
        features = torch.cat([t_local, x_emb, k_emb], dim=-1) * mask
        return features, t_emb
