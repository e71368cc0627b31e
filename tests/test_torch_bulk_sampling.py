"""The port's bulk generation sweep (multimodal_particles_tpu_torch/parallel/
bulk_sampling.py) against the JAX package's on the CPU.

The two packages' random streams differ, so the sweep is held by what it
must keep: the token law equal to JAX's; the device source sampler's
statistics at the JAX test's tolerances
(tests/test_parallel/test_device_sources.py:19-44: multiplicity shares within
0.03, token shares within 0.01, the kinematics' std within 0.02, masked
entries 0); counts, shapes, the trimmed last chunk and the mask each family
carries; each collected chunk equal to `predict` of that chunk's source under
the same generator; the transdimensional dims → mask and one-hot → token
conversion equal to JAX's on the same final states; the same bits from the
same seed.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_particles_tpu.models.generative.transdimensional import (
    structure as jax_structure,
)
from multimodal_particles_tpu.parallel.bulk_sampling import (
    token_probs_from_cat_probs as jax_token_probs,
)
from multimodal_particles_tpu_torch.config_classes import (
    AbsorbingConfig,
    MultimodalBridgeMatchingConfig,
    TransdimensionalEpicConfig,
)
from multimodal_particles_tpu_torch.models.generative.absorbing.absorbing_flows import (
    AbsorbingFlow,
)
from multimodal_particles_tpu_torch.models.generative.init import init_parameters
from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (
    MultiModalBridgeMatching,
)
from multimodal_particles_tpu_torch.models.generative.transdimensional.transdimensional_model import (
    TransdimensionalJumpDiffusion,
)
from multimodal_particles_tpu_torch.parallel import bulk_sampling
from multimodal_particles_tpu_torch.parallel.bulk_sampling import (
    bulk_sample,
    chunk_seeds,
    make_device_source_sampler,
    token_probs_from_cat_probs,
)
from torch_port_helpers import CONFIG_PATH

N, NUM_JETS, BATCH = 16, 40, 16
HIST = {3: 2, 9: 5, 16: 3, 40: 1}  # 40 > N: counted at N


def _mbm():
    cfg = MultimodalBridgeMatchingConfig.from_yaml(CONFIG_PATH)
    cfg.data.max_num_particles = N
    cfg.bridge.num_timesteps = 5
    return init_parameters(MultiModalBridgeMatching(cfg), 0).eval(), cfg


def _absorbing():
    cfg = AbsorbingConfig()
    cfg.data.max_num_particles = N
    cfg.bridge.num_timesteps = 4
    return init_parameters(AbsorbingFlow(cfg), 1).eval(), cfg


def _transdim():
    cfg = TransdimensionalEpicConfig()
    cfg.data.max_num_particles = N
    cfg.sampler_kwargs.dt = 0.2  # 5 steps
    cfg.sampler_kwargs.multi_birth = 4
    cfg.data.target_info["hist_num_particles"] = {n: 1 for n in range(1, N + 1)}  # the prior
    return init_parameters(TransdimensionalJumpDiffusion(cfg), 2).eval(), cfg


FAMILIES = {"mbm": _mbm, "absorbing": _absorbing, "transdim": _transdim}


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    model, cfg = FAMILIES[request.param]()
    hist = None if request.param == "transdim" else HIST
    result, stats = bulk_sample(model, cfg, NUM_JETS, batch_size=BATCH, seed=3,
                                multiplicity_hist=hist)
    return request.param, model, cfg, hist, result, stats


@pytest.mark.parametrize("cat_probs", [(0.2,) * 5, (0.5, 0.1, 0.1, 0.2, 0.1), (1, 0, 0, 0, 0)])
def test_token_probs_match_jax(cat_probs):
    np.testing.assert_array_equal(token_probs_from_cat_probs(cat_probs),
                                  jax_token_probs(cat_probs))


def test_device_source_statistics():
    cfg = MultimodalBridgeMatchingConfig()
    cfg.data.max_num_particles = 32
    sampler = make_device_source_sampler(cfg, 4096, {8: 10, 16: 30, 24: 60}, device="cpu")
    batch = sampler(torch.Generator().manual_seed(0))
    mult = batch.source_mask[..., 0].sum(1).numpy()
    vals, counts = np.unique(mult, return_counts=True)
    assert set(vals) == {8, 16, 24}
    freqs = dict(zip(vals, counts / counts.sum()))
    assert abs(freqs[24] - 0.6) < 0.03 and abs(freqs[16] - 0.3) < 0.03
    valid = batch.source_mask[..., 0].numpy() > 0
    tokens = batch.source_discrete[..., 0].numpy()[valid]
    np.testing.assert_allclose(np.bincount(tokens, minlength=8) / len(tokens),
                               [0.2, 0.2, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1], atol=0.01)
    x = batch.source_continuous.numpy()
    assert abs(x[valid].std() - 1.0) < 0.02
    assert (x[~valid] == 0).all() and (batch.source_discrete.numpy()[~valid] == 0).all()
    assert torch.equal(batch.target_mask, batch.source_mask)


def test_source_sampler_never_draws_an_empty_law_entry():
    """Entries of probability 0 at the end of either law (multiplicities 0
    and above the histogram's; tokens of a species with probability 0) are
    never drawn, also for uniforms next to 1."""
    cfg = MultimodalBridgeMatchingConfig()
    cfg.data.max_num_particles = 8
    sampler = make_device_source_sampler(cfg, 20000, {2: 1, 5: 1}, device="cpu",
                                         cat_probs=(0.5, 0.5, 0, 0, 0))
    batch = sampler(torch.Generator().manual_seed(1))
    assert set(batch.source_mask[..., 0].sum(1).tolist()) == {2, 5}
    valid = batch.source_mask[..., 0] > 0
    assert set(batch.source_discrete[..., 0][valid].tolist()) == {0, 1}
    with pytest.raises(ValueError, match="no jets"):
        make_device_source_sampler(cfg, 4, {3: 0}, device="cpu")
    cdf = bulk_sampling._cdf(np.array([0.5, 0.5, 0.0]), "cpu")
    u = torch.tensor([0.0, 0.4999, 0.5, 1.0 - 2.0 ** -24])
    assert bulk_sampling._draw(cdf, u).tolist() == [0, 0, 1, 1]


def test_counts_shapes_trimming_and_stats(family):
    name, model, cfg, _, result, stats = family
    assert stats["num_jets"] == NUM_JETS and stats["jets_per_sec"] > 0
    assert set(stats) == {"num_jets", "wall_time_s", "jets_per_sec", "jets_per_sec_per_chip",
                          "devices", "mesh"}
    assert stats["devices"] == 1 and stats["mesh"] == {"data": 1}
    assert result["continuous"].shape == (NUM_JETS, N, 3)
    assert result["discrete"].shape == result["mask"].shape == (NUM_JETS, N, 1)
    assert np.isfinite(result["continuous"]).all()
    mask = result["mask"][..., 0] > 0
    assert set(np.unique(result["mask"])) <= {0, 1}
    assert (result["continuous"][~mask] == 0).all() and (result["discrete"][~mask] == 0).all()
    assert ((result["discrete"] >= 0) & (result["discrete"] < 8)).all()
    mult = mask.sum(1)
    assert mult.min() >= 1
    if name != "absorbing":  # prefix masks; the absorbing family births at any slot
        assert (mask == (np.arange(N)[None] < mult[:, None])).all()


def _chunk_states(model, cfg, hist, i, transdim):
    """Chunk i's source and final state, rebuilt as bulk_sample makes them."""
    gen = torch.Generator().manual_seed(chunk_seeds(3, math.ceil(NUM_JETS / BATCH))[i])
    if transdim:
        source = [torch.ones(BATCH, dtype=torch.int32), torch.zeros(BATCH, N, 3),
                  torch.zeros(BATCH, N, 8)]
    else:
        source = make_device_source_sampler(cfg, BATCH, hist, device="cpu")(gen)
    return source, model.predict(source, generator=gen)


def test_each_chunk_is_predict_of_its_source(family):
    """Chunks 1 and 2 (the last one trimmed to 8 jets) against `predict` of
    the chunk's source under a generator seeded as bulk_sample seeds it; the
    mask is the state's own: MBM's source mask, the absorbing family's
    generated mask_t, transdim's dims."""
    name, model, cfg, hist, result, _ = family
    for i in (1, 2):
        source, out = _chunk_states(model, cfg, hist, i, name == "transdim")
        rows = slice(i * BATCH, min((i + 1) * BATCH, NUM_JETS))
        take = rows.stop - rows.start
        np.testing.assert_array_equal(result["continuous"][rows], out.continuous[:take].numpy())
        if name == "transdim":
            continue  # the conversion: test_transdim_conversion_matches_jax
        np.testing.assert_array_equal(result["discrete"][rows], out.discrete[:take].numpy())
        mask = out.absorbing if name == "mbm" else out.mask_t
        np.testing.assert_array_equal(result["mask"][rows], mask[:take].numpy())
        if name == "mbm":
            np.testing.assert_array_equal(result["mask"][rows],
                                          source.source_mask[:take].float().numpy())
        else:  # birth only: every source slot stays alive
            assert (result["mask"][rows][source.source_mask[:take].numpy() > 0] == 1).all()


@pytest.mark.parametrize("family", ["transdim"], indirect=True)
def test_transdim_conversion_matches_jax(family):
    name, model, cfg, hist, result, _ = family
    _, out = _chunk_states(model, cfg, hist, 0, True)
    jax_state = jax_structure.StructuredState(
        continuous=jnp.asarray(out.continuous.numpy()), discrete=jnp.asarray(out.discrete.numpy()),
        dims=jnp.asarray(out.dims.numpy()))
    np.testing.assert_array_equal(result["discrete"][:BATCH],
                                  np.asarray(jnp.argmax(jax_state.discrete, axis=-1)[..., None]))
    np.testing.assert_array_equal(
        result["mask"][:BATCH], np.asarray(jax_state.particle_mask().astype(jnp.int32)[..., None]))
    assert out.dims.float().std() > 0  # the multiplicities differ between jets


def test_same_seed_same_bits_and_no_collect(family):
    name, model, cfg, hist, result, _ = family
    again, _ = bulk_sample(model, cfg, NUM_JETS, batch_size=BATCH, seed=3, multiplicity_hist=hist)
    for key in result:
        np.testing.assert_array_equal(again[key], result[key], err_msg=key)
    other, _ = bulk_sample(model, cfg, BATCH, batch_size=BATCH, seed=4, multiplicity_hist=hist)
    assert not np.array_equal(other["continuous"], result["continuous"][:BATCH])
    none, stats = bulk_sample(model, cfg, NUM_JETS, batch_size=BATCH, seed=3,
                              multiplicity_hist=hist, collect=False)
    assert none is None and stats["num_jets"] == NUM_JETS


def test_histogram_sources(monkeypatch):
    """MBM's multiplicities from `target_multiplicity` (via its histogram),
    else the config's hist_num_particles; transdim refuses both."""
    model, cfg = _mbm()
    sizes = np.array([4, 4, 7])
    result, _ = bulk_sample(model, cfg, 32, batch_size=32, target_multiplicity=sizes)
    assert set(result["mask"][..., 0].sum(1).astype(int)) == {4, 7}
    cfg.data.target_info["hist_num_particles"] = {5: 3}
    result, _ = bulk_sample(model, cfg, 8, batch_size=8)
    assert (result["mask"][..., 0].sum(1) == 5).all()
    td_model, td_cfg = _transdim()
    for kwargs in ({"multiplicity_hist": {3: 1}}, {"target_multiplicity": sizes}):
        with pytest.raises(ValueError, match="its own multiplicity"):
            bulk_sample(td_model, td_cfg, 8, batch_size=8, **kwargs)


def test_cuda_model_without_its_kernel_path_raises(monkeypatch):
    """On a CUDA device the sweep runs the kernels or raises (checked before
    any draw, so a CPU model stands in with its device faked)."""
    model, cfg = _mbm()
    cuda = torch.device("cuda")
    assert bulk_sampling.runs_kernels(model, cuda)  # use_pallas 'auto', config-berlin widths
    cfg.parallel.use_pallas = False
    assert not bulk_sampling.runs_kernels(model, cuda)
    monkeypatch.setattr(bulk_sampling, "model_device", lambda m: cuda)
    with pytest.raises(RuntimeError, match="kernel path"):
        bulk_sample(model, cfg, 8, batch_size=8)
    td_model, _ = _transdim()
    assert bulk_sampling.runs_kernels(td_model, cuda)
    td_model.config.parallel.use_pallas = False
    assert not bulk_sampling.runs_kernels(td_model, cuda)
