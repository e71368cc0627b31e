"""Batches for the sampler and the trainer.

`MultimodalDatabatch` is the JAX batch container
(multimodal_particles_tpu/data/particle_clouds/jets_dataloader.py:19-29): the
source half, which is what `predict` reads, and the target half, which the
training loss reads. `gauss_noise_source_batch` builds the Gaussian-noise
source that MBM samples from (source_name "GaussNoise");
`synthetic_training_batch` adds a synthetic target with the source's masks
(source_masks_from_target_masks), the counterpart of
`JetsDataloaderModule.random_databatch` (:218-235) for training runs that do
not read jets from disk. `absorbing_training_batch` is the absorbing family's:
its source holds fewer particles than its target (the data option
`source_masks_from_target_masks` off), since that family generates the
multiplicity. `transdim_training_batch` is the transdimensional family's
'list' batch [multiplicities, kinematics, one-hot tokens], with
`multiplicity_histogram` for its sampler's prior. All build on any device from
an explicit generator. `InMemoryDataModule` holds ready batches for
`Trainer.fit`.
"""

import dataclasses
from typing import Optional, Sequence

import torch

# synthetic target law: per-feature normal kinematics, tokens skewed to low ids
TARGET_MEAN = (1.0, 0.0, -0.5)
TARGET_STD = 0.5


@dataclasses.dataclass
class MultimodalDatabatch:
    source_continuous: torch.Tensor  # (B, N, dim_c) float
    source_discrete: torch.Tensor  # (B, N, 1) integer tokens
    source_mask: torch.Tensor  # (B, N, 1) 0/1

    target_continuous: Optional[torch.Tensor] = None  # (B, N, dim_c) float
    target_discrete: Optional[torch.Tensor] = None  # (B, N, 1) integer tokens
    target_mask: Optional[torch.Tensor] = None  # (B, N, 1) 0/1

    context_continuous: Optional[torch.Tensor] = None
    context_discrete: Optional[torch.Tensor] = None


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


def synthetic_training_batch(
    num_jets: int,
    max_num_particles: int,
    dim_continuous: int,
    vocab_size: int,
    generator: torch.Generator,
    device=None,
    num_empty: int = 0,
) -> MultimodalDatabatch:
    """A Gaussian-noise source and a synthetic target on the same masks:
    target kinematics normal with mean TARGET_MEAN (cycled over features)
    and std TARGET_STD, target tokens floor(S·u²) for uniform u."""
    batch = gauss_noise_source_batch(
        num_jets, max_num_particles, dim_continuous, vocab_size, generator,
        device=device, num_empty=num_empty,
    )
    mask = batch.source_mask
    shape = tuple(batch.source_continuous.shape)
    mean = torch.tensor(
        [TARGET_MEAN[i % len(TARGET_MEAN)] for i in range(dim_continuous)], device=device
    )
    x1 = mean + TARGET_STD * torch.randn(shape, generator=generator, device=device)
    u = torch.rand(shape[:2] + (1,), generator=generator, device=device)
    k1 = torch.clamp((vocab_size * u * u).long(), max=vocab_size - 1)
    return dataclasses.replace(
        batch,
        target_continuous=x1 * mask,
        target_discrete=k1 * mask.long(),
        target_mask=mask.clone(),
    )


def absorbing_training_batch(
    num_jets: int,
    max_num_particles: int,
    dim_continuous: int,
    vocab_size: int,
    generator: torch.Generator,
    device=None,
    num_empty: int = 0,
) -> MultimodalDatabatch:
    """`synthetic_training_batch` with a source mask of its own: a jet's
    source multiplicity is uniform in [0, its target multiplicity], so the
    source never holds more particles than the target and the sampler's
    births have to make up the difference. Source slots beyond the source
    multiplicity are zeroed."""
    batch = synthetic_training_batch(
        num_jets, max_num_particles, dim_continuous, vocab_size, generator,
        device=device, num_empty=num_empty,
    )
    target_mult = batch.target_mask.sum(dim=1)  # (B, 1)
    u = torch.rand(tuple(target_mult.shape), generator=generator, device=device)
    source_mult = torch.floor(u * (target_mult + 1.0))
    slots = torch.arange(max_num_particles, device=device)[None, :]
    mask = (slots < source_mult).to(torch.float32)[..., None]
    return dataclasses.replace(
        batch,
        source_continuous=batch.source_continuous * mask,
        source_discrete=batch.source_discrete * mask.to(batch.source_discrete.dtype),
        source_mask=mask,
    )


def transdim_training_batch(
    num_jets: int,
    max_num_particles: int,
    dim_continuous: int,
    vocab_size: int,
    generator: torch.Generator,
    device=None,
):
    """The transdimensional family's 'list' databatch [n_particles (B,) int32,
    continuous (B, N, dim_c), one-hot tokens (B, N, vocab)]: multiplicities
    uniform in [1, max_num_particles], standard-normal kinematics, uniform
    tokens; rows from a jet's multiplicity on are zero."""
    B, N = num_jets, max_num_particles
    kw = dict(generator=generator, device=device)
    n_particles = torch.randint(1, N + 1, (B,), **kw).to(torch.int32)
    live = (torch.arange(N, device=device)[None, :] < n_particles[:, None]).float()[..., None]
    x = torch.randn((B, N, dim_continuous), **kw) * live
    tokens = torch.randint(0, vocab_size, (B, N), **kw)
    one_hot = torch.nn.functional.one_hot(tokens, vocab_size).to(torch.float32) * live
    return [n_particles, x, one_hot]


def multiplicity_histogram(n_particles) -> dict:
    """{multiplicity: count} of a batch's multiplicities, the input of
    `DistributionNodes`."""
    values, counts = torch.unique(torch.as_tensor(n_particles).cpu(), return_counts=True)
    return {int(v): int(c) for v, c in zip(values.tolist(), counts.tolist())}


@dataclasses.dataclass
class InMemoryDataModule:
    """Ready batches for `Trainer.fit`: `train` and `valid` are sequences of
    batches (`valid` may be None), as JetsDataloaderModule's loaders are."""

    train: Sequence[MultimodalDatabatch]
    valid: Optional[Sequence[MultimodalDatabatch]] = None
    test: Optional[Sequence[MultimodalDatabatch]] = None
