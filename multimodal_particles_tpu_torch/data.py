"""Request batches for the sampler.

`MultimodalDatabatch` holds the source half of the JAX batch container
(multimodal_particles_tpu/data/particle_clouds/jets_dataloader.py:19-29),
which is what `predict` reads;
`gauss_noise_source_batch` builds the Gaussian-noise source that MBM samples
from (source_name "GaussNoise"), on any device, from an explicit generator.
"""

import dataclasses

import torch


@dataclasses.dataclass
class MultimodalDatabatch:
    source_continuous: torch.Tensor  # (B, N, dim_c) float
    source_discrete: torch.Tensor  # (B, N, 1) integer tokens
    source_mask: torch.Tensor  # (B, N, 1) 0/1


def gauss_noise_source_batch(
    num_jets: int,
    max_num_particles: int,
    dim_continuous: int,
    vocab_size: int,
    generator: torch.Generator,
    device=None,
    num_empty: int = 0,
) -> MultimodalDatabatch:
    """Gaussian kinematics, uniform tokens, multiplicities uniform in
    [1, max_num_particles]; the last `num_empty` jets have no particles.
    Slots beyond a jet's multiplicity carry mask 0 and zeroed features."""
    B, N = num_jets, max_num_particles
    kw = dict(generator=generator, device=device)
    x = torch.randn((B, N, dim_continuous), **kw)
    k = torch.randint(0, vocab_size, (B, N, 1), **kw)
    mult = torch.randint(1, N + 1, (B, 1), **kw)
    if num_empty:
        mult[B - num_empty:] = 0
    slots = torch.arange(N, device=device)[None, :]
    mask = (slots < mult).to(torch.float32)[..., None]
    return MultimodalDatabatch(
        source_continuous=x * mask,
        source_discrete=k * mask.to(k.dtype),
        source_mask=mask,
    )
