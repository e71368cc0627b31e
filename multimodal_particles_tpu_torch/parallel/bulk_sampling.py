"""The bulk generation sweep: `num_jets` jets from a model in chunks of
`batch_size`, the counterpart of
multimodal_particles_tpu/parallel/bulk_sampling.py:28-216 (BASELINE.md
workload 5, the 1M-jet sweep).

Generation is independent across jets, so a chunk is one `predict` request
on the model's device. Its source is drawn there too (Gaussian kinematics,
tokens from the flavour⊗charge law, prefix masks from a multiplicity
histogram), from a `torch.Generator` on that device: the host loop only
seeds the generator, launches and, once a chunk, reads a 4-byte checksum or
the chunk's arrays back. A chunk reads nothing back before that: the
categorical draws are inverse-CDF lookups (`torch.searchsorted` on a uniform),
and nothing checks a range on the host (`F.one_hot` would).

The transdimensional family draws its own start (x ~ N(0, I) at dims = 1)
and its multiplicity by birth jumps, so its source is a template of shapes
only, and a histogram for it is refused. On a CUDA device the sweep runs
the model's kernel path or raises: there is no fallback to the module path.
"""

import math
import time

import numpy as np
import torch

from multimodal_particles_tpu_torch.data.batches import MultimodalDatabatch
from multimodal_particles_tpu_torch.data.particle_clouds.utils import sizes_to_histograms
from multimodal_particles_tpu_torch.models.generative.bridges import LinearUniformBridge


def token_probs_from_cat_probs(cat_probs):
    """The 8 token probabilities of the reference noise source: flavour over
    5 species by `cat_probs`, the three charged species split ± with
    probability 1/2 (bulk_sampling.py:25-33)."""
    p = np.asarray(cat_probs, dtype=np.float64)
    return np.array([p[0], p[1], p[2] / 2, p[2] / 2, p[3] / 2, p[3] / 2, p[4] / 2, p[4] / 2])


def _cdf(probs, device):
    """float32 CDF of `probs` (float64, nonnegative) on `device`, 1 from the
    last positive entry on, so that a uniform in [0, 1) never lands on a
    trailing entry of probability 0."""
    cdf = np.cumsum(probs / probs.sum())
    cdf[np.flatnonzero(probs > 0)[-1]:] = 1.0
    return torch.tensor(cdf, dtype=torch.float32, device=device)


def _draw(cdf, u):
    """Index i with cdf[i-1] <= u < cdf[i]: a draw from the law behind `cdf`."""
    return torch.searchsorted(cdf, u, right=True).clamp_(max=cdf.numel() - 1)


def make_device_source_sampler(config, batch_size, multiplicity_hist=None, scale=1.0,
                               cat_probs=(0.2, 0.2, 0.2, 0.2, 0.2), device="cuda"):
    """A function generator → MultimodalDatabatch of `batch_size` jets on
    `device` (bulk_sampling.py:35-72): kinematics N(0, 1)·`scale`, tokens
    from `token_probs_from_cat_probs(cat_probs)`, multiplicities from
    `multiplicity_hist` ({multiplicity: count}, entries above N counted at
    N; None: every slot alive), prefix masks; masked entries zero. The
    target half holds zeros and the source masks. The generator must be
    on `device`."""
    device = torch.device(device)
    N = config.data.max_num_particles
    dim_c = config.data.dim_features_continuous
    token_cdf = _cdf(token_probs_from_cat_probs(cat_probs), device)
    mult_cdf = None
    if multiplicity_hist is not None:
        counts = np.zeros(N + 1)
        for n, c in multiplicity_hist.items():
            counts[min(int(n), N)] += c
        if not counts.sum() > 0:
            raise ValueError(f"the multiplicity histogram holds no jets: {multiplicity_hist}")
        mult_cdf = _cdf(counts, device)
    slots = torch.arange(N, device=device)

    def sample(generator):
        kw = dict(generator=generator, device=device)
        continuous = torch.randn((batch_size, N, dim_c), **kw) * scale
        tokens = _draw(token_cdf, torch.rand((batch_size, N), **kw))[..., None]
        if mult_cdf is not None:
            mult = _draw(mult_cdf, torch.rand((batch_size,), **kw))
            mask = (slots[None, :] < mult[:, None])[..., None].to(torch.int64)
        else:
            mask = torch.ones((batch_size, N, 1), dtype=torch.int64, device=device)
        return MultimodalDatabatch(
            source_continuous=continuous * mask,
            source_discrete=tokens * mask,
            source_mask=mask,
            target_continuous=torch.zeros_like(continuous),
            target_discrete=torch.zeros_like(tokens),
            target_mask=mask,
        )

    return sample


def is_transdimensional(model) -> bool:
    """The transdimensional family, told apart as the JAX package does (its
    jump-diffusion loss)."""
    return hasattr(model, "jump_diffusion_loss")


def runs_kernels(model, device) -> bool:
    """Whether `predict` on `device` takes the model's kernel path: MBM's
    fused sampler step (linear bridge, narrow encoder) or its wide forward;
    the other families' sampling gate."""
    if hasattr(model, "kernel_enabled"):
        linear = isinstance(model.bridge_continuous, LinearUniformBridge)
        return (linear and model.kernel_enabled(device)) or model.wide_kernel_enabled(device)
    return model._pallas_enabled(device)


def chunk_seeds(seed, n_chunks):
    """One generator seed a chunk, from `seed`: chunk i's draws do not depend
    on how many chunks run."""
    return [int(s) for s in np.random.SeedSequence(seed).generate_state(n_chunks, np.uint64)]


def model_device(model) -> torch.device:
    return next(model.parameters()).device


def bulk_sample(model, config, num_jets, batch_size=8192, seed=0, target_multiplicity=None,
                multiplicity_hist=None, collect=True):
    """Generate `num_jets` particle clouds with `model` on its device
    (bulk_sampling.py:75-216).

    Chunk i draws its source and its sampler noise from one generator seeded
    with `chunk_seeds(seed, n_chunks)[i]`; the last chunk is trimmed. Chunk 0
    runs once outside the timer (the allocator's first requests), then every
    chunk runs timed. MBM and the absorbing family take the multiplicity
    histogram of `target_multiplicity` (per-jet sizes), else
    `multiplicity_hist`, else the config's `target_info["hist_num_particles"]`.

    Returns (dict of numpy arrays "continuous" (num_jets, N, Dc), "discrete"
    (num_jets, N, 1) tokens and "mask" (num_jets, N, 1), or None without
    `collect`; stats with the JAX package's keys). With `collect=False` a
    chunk syncs on a 4-byte checksum."""
    device = model_device(model)
    if device.type == "cuda" and not runs_kernels(model, device):
        raise RuntimeError("bulk_sample on a CUDA device runs the model's kernel path; "
                           "this model's kernel gate is off (parallel.use_pallas or its widths)")
    transdim = is_transdimensional(model)
    N = config.data.max_num_particles

    if not transdim:
        if multiplicity_hist is None and target_multiplicity is not None:
            multiplicity_hist = sizes_to_histograms(target_multiplicity)
        if multiplicity_hist is None:
            multiplicity_hist = (config.data.target_info or {}).get("hist_num_particles")
        source_sampler = make_device_source_sampler(config, batch_size, multiplicity_hist,
                                                    device=device)
    else:
        if multiplicity_hist is not None or target_multiplicity is not None:
            raise ValueError(
                "the transdimensional family generates its own multiplicity by birth jumps: "
                "target_multiplicity / multiplicity_hist would be ignored"
            )
        Dc, V = config.data.dim_features_continuous, config.data.vocab_size_features

        def source_sampler(generator):
            # shapes only: the jump sampler starts from dims = 1, x ~ N(0, I)
            return [torch.ones((batch_size,), dtype=torch.int32, device=device),
                    torch.zeros((batch_size, N, Dc), device=device),
                    torch.zeros((batch_size, N, V), device=device)]

    generator = torch.Generator(device=device)

    def chunk(chunk_seed):
        generator.manual_seed(chunk_seed)
        out = model.predict(source_sampler(generator), generator=generator)
        if transdim:
            checksum = out.continuous[0, 0].sum() + out.dims[0]
            # tokens and the mask converted on the device, before the read-back
            out = {"continuous": out.continuous,
                   "discrete": torch.argmax(out.discrete, dim=-1)[..., None],
                   "mask": out.particle_mask().to(torch.int32)[..., None]}
        else:
            checksum = out.continuous[0, 0].sum() + out.discrete[0, 0].sum()
            mask = out.absorbing if getattr(out, "absorbing", None) is not None else out.mask_t
            out = {"continuous": out.continuous, "discrete": out.discrete, "mask": mask}
        return out, checksum

    n_chunks = max(math.ceil(num_jets / batch_size), 1)
    seeds = chunk_seeds(seed, n_chunks)
    _, warm = chunk(seeds[0])
    warm.item()
    chunks, done = [], 0
    start = time.perf_counter()
    for i in range(n_chunks):
        out, checksum = chunk(seeds[i])
        take = min(batch_size, num_jets - done)
        if collect:
            chunks.append({k: v[:take].cpu().numpy() for k, v in out.items()})
        else:
            checksum.item()  # a 4-byte sync a chunk
        done += take
    seconds = time.perf_counter() - start

    stats = {
        "num_jets": done,
        "wall_time_s": seconds,
        "jets_per_sec": done / seconds,
        "jets_per_sec_per_chip": done / seconds,  # one device
        "devices": 1,
        "mesh": {"data": 1},
    }
    if collect:
        return {k: np.concatenate([c[k] for c in chunks], axis=0) for k in chunks[0]}, stats
    return None, stats
