"""The survival head of the PyTorch/CUDA port against the JAX package on the
CPU: the timestep embedding, the transformer blocks, the head's packing and
time rows, and the plain version of the fused kernel (ops/survival_cuda.py)
against the interpret-mode Pallas kernel and the flax head. float32 on both
sides; each test states its tolerance. The CUDA kernel itself is held against
the plain version on a card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from multimodal_particles_tpu.models.architectures import gsdm as jax_gsdm
from multimodal_particles_tpu.models.architectures.utils import (
    get_timestep_embedding as jax_timestep_embedding,
)
from multimodal_particles_tpu.models.generative.absorbing.absorbing_flows import (
    AbsorbingGenerator,
)
from multimodal_particles_tpu.models.generative.states import AbsorbingBridgeState
from multimodal_particles_tpu.ops import survival_pallas
from multimodal_particles_tpu_torch.models.architectures import gsdm
from multimodal_particles_tpu_torch.models.architectures.utils import get_timestep_embedding
from multimodal_particles_tpu_torch.ops import survival_cuda
from torch_port_helpers import absorbing_pair, noisy_params, to_torch

TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_ops/test_survival_pallas.py:86-88


@pytest.mark.parametrize("dim", [128, 32, 33])
def test_timestep_embedding_matches_jax(dim):
    """[sin | cos], denominator half − 1, a zero column at odd widths; 1e-5
    relative to the arguments' size (1000·t reaches 1e3, where float32 sin
    and cos of the two libraries differ in the last bits)."""
    t = np.random.default_rng(0).random(16).astype(np.float32) * 1000.0
    ours = get_timestep_embedding(torch.from_numpy(t), dim).numpy()
    theirs = np.asarray(jax_timestep_embedding(jnp.asarray(t), dim))
    assert ours.shape == theirs.shape == (16, dim)
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=2e-4)


def _transplant_block(module, params):
    """flax block params (numpy) into a port gsdm block."""
    state = {}
    for layer, leaves in params.items():
        for leaf, value in leaves.items():
            name = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
            state[f"{layer}.{name}"] = torch.from_numpy(
                np.array(value.T if leaf == "kernel" else value, order="C"))
    module.load_state_dict(state)
    return module


def test_resnet_block_matches_flax():
    """GroupNorm(32 groups, eps 1e-6) → swish → Dense → + time row → … → + x
    at N = 11 (not a multiple of anything), 1e-5."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 11, 64)).astype(np.float32) * 2.0 + 0.5
    temb = rng.standard_normal((4, 64)).astype(np.float32)
    block = jax_gsdm.ResnetBlock(channels=64, temb_channels=64)
    params = noisy_params(block.init(jax.random.PRNGKey(0), x, temb)["params"], 1)
    theirs = np.asarray(block.apply({"params": params}, jnp.asarray(x), jnp.asarray(temb)))
    ours = _transplant_block(gsdm.ResnetBlock(64, temb_channels=64), params)(*to_torch(x, temb))
    np.testing.assert_allclose(ours.detach().numpy(), theirs, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_attn_block_matches_flax(masked):
    """Heads over contiguous channel ranges, softmax over the keys, scale
    head_dim^-0.5; with `mask` the dead keys get a −1e9 bias; 1e-5."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 11, 64)).astype(np.float32)
    mask = (rng.random((4, 11, 1)) < 0.6).astype(np.float32) if masked else None
    block = jax_gsdm.AttnBlock(64, n_heads=2)
    params = noisy_params(block.init(jax.random.PRNGKey(0), x)["params"], 2)
    theirs = np.asarray(block.apply({"params": params}, jnp.asarray(x),
                                    None if mask is None else jnp.asarray(mask)))
    module = _transplant_block(gsdm.AttnBlock(64, n_heads=2), params)
    ours = module(*to_torch(x), mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(ours.detach().numpy(), theirs, rtol=1e-5, atol=1e-5)


def test_attn_block_refuses_the_fused_core():
    """The fused core is refused where the JAX module refuses it (gsdm.py:67-72):
    with `attn_dim_reduce` other than 1, and under "auto" on CPU tensors; with
    use_pallas=True it runs (on CPU tensors, its plain version)."""
    from multimodal_particles_tpu_torch.ops import attention_cuda

    x = torch.randn((2, 9, 64), generator=torch.Generator().manual_seed(0))
    for kwargs, core in (({"use_pallas": True, "attn_dim_reduce": 2}, False),
                         ({"use_pallas": "auto"}, False), ({"use_pallas": False}, False),
                         ({"use_pallas": True}, True)):
        block = gsdm.AttnBlock(64, n_heads=2, **kwargs)
        calls = attention_cuda.attention_core_reference.calls
        assert torch.isfinite(block(x)).all()
        assert attention_cuda.attention_core_reference.calls == calls + int(core), kwargs


def test_swish_matches_flax():
    x = np.linspace(-20, 20, 101, dtype=np.float32)
    np.testing.assert_allclose(gsdm.swish(torch.from_numpy(x)).numpy(),
                               np.asarray(x * nn.sigmoid(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def pair():
    return absorbing_pair(seed=0, n=16, b=8)


def test_pack_survival_head_params_leaf_by_leaf(pair):
    """The port's packed leaves are the JAX packing's, in its order (vectors
    there are (1, C) rows), bit for bit, and `flat` is their concatenation."""
    _, params, model, _ = pair
    theirs = survival_pallas.pack_survival_head_params(params["generator"], 2)
    ours = survival_cuda.pack_survival_head_params(model.generator, 2)
    layout = survival_cuda.head_layout(16, 2)
    assert len(theirs) == len(layout) == len(ours.tensors)
    for (name, shape), leaf in zip(layout, theirs):
        np.testing.assert_array_equal(ours.tensors[name].numpy(),
                                      np.asarray(leaf).reshape(shape), err_msg=name)
    assert ours.flat.numel() == sum(int(np.prod(s)) for _, s in layout)
    assert (ours.dim_hidden, ours.n_blocks) == (16, 2)


def test_project_time_embeddings_matches_jax(pair):
    """The per-block time rows, 1e-4 (they pass through sin and cos of 1000·t)."""
    _, params, model, _ = pair
    t = np.random.default_rng(3).random((8, 1, 1)).astype(np.float32)
    theirs = survival_pallas.project_time_embeddings(params["generator"], jnp.asarray(t), 2, 128)
    ours = survival_cuda.project_time_embeddings(model.generator, torch.from_numpy(t), 2, 128)
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,b", [(109, 8), (128, 8), (109, 7), (256, 2)])
def test_survival_head_reference_matches_pallas_and_flax(n, b):
    """The plain version of the fused head against the interpret-mode Pallas
    kernel on the same packed inputs and against the flax head, at the
    reference N = 109, at N = 128, at a batch that is no tile multiple, and
    at N = 256 (two row blocks a jet on the card; there the weights are drawn
    on flax's parameter tree, `drawn_init`, which spares flax's eager init at
    the new shapes; N = 200 is held through the absorbing family's
    `forward_sampling`, tests/test_torch_absorbing.py); random non-prefix
    masks. rtol = atol = 2e-4."""
    jax_model, params, model, batch = absorbing_pair(seed=1, n=n, b=b, drawn_init=n > 128)
    gen_params = params["generator"]
    rng = np.random.default_rng(3)
    t = rng.uniform(0.05, 0.95, (b, 1, 1)).astype(np.float32)
    state = AbsorbingBridgeState(
        time=jnp.asarray(t), continuous=batch.source_continuous,
        discrete=batch.source_discrete, mask_t=batch.source_mask.astype(jnp.int32))
    # jitted: flax's op-by-op apply compiles each operation anew at every shape
    flax_logits, last = jax.jit(lambda p: (
        jax_model.generator.apply({"params": p}, state, batch).absorbing,
        jax_model.generator.apply({"params": p}, state, batch,
                                  method=AbsorbingGenerator.trunk_and_heads)[2]))(gen_params)
    pallas_logits = survival_pallas.survival_head_pallas(
        survival_pallas.pack_survival_head_params(gen_params, 2),
        survival_pallas.project_time_embeddings(gen_params, state.time, 2, 128),
        last, state.mask_t, n_blocks=2, n_heads=2, transformer_dim=128, interpret=True)

    calls = survival_cuda.survival_head_reference.calls
    ours = survival_cuda.survival_head(  # CPU tensors: the plain version
        survival_cuda.pack_survival_head_params(model.generator, 2),
        survival_cuda.project_time_embeddings(model.generator, torch.from_numpy(t), 2, 128),
        *to_torch(np.asarray(last), np.asarray(state.mask_t)), n_heads=2)
    assert survival_cuda.survival_head_reference.calls == calls + 1
    assert tuple(ours.shape) == (b, n, 1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas_logits), **TOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(flax_logits), **TOL)


def test_survival_gate_matches_jax():
    """transformer_dim 96 → off; a tensor-parallel model axis → off, as
    survival_pallas_supported; 8 heads, width 256 and a trunk hidden width
    of 24 → on, as in JAX; and what only the CUDA kernel rules out: N past
    256, a head wider than 128 channels."""
    from multimodal_particles_tpu.config_classes import AbsorbingConfig
    from multimodal_particles_tpu_torch.config_classes import AbsorbingConfig as TorchConfig

    for section, name, value, on in ((None, None, None, True),
                                     ("generator", "transformer_dim", 96, False),
                                     ("parallel", "model_axis", 2, False),
                                     ("generator", "n_attn_blocks", 0, False),
                                     ("generator", "n_heads", 8, True),
                                     ("encoder", "dim_hidden_local", 24, True),
                                     ("generator", "transformer_dim", 256, True)):
        cfg = AbsorbingConfig()
        if section:
            setattr(getattr(cfg, section), name, value)
        ours = TorchConfig.from_dict(cfg.to_dict())
        assert survival_cuda.survival_supported(ours) == survival_pallas.survival_pallas_supported(cfg)
        assert survival_cuda.survival_supported(ours) == on
    for sections in ({"data": {"max_num_particles": 257}},
                     {"generator": {"transformer_dim": 256, "n_heads": 1}}):
        ours = TorchConfig()
        for section, fields in sections.items():
            for name, value in fields.items():
                setattr(getattr(ours, section), name, value)
        assert not survival_cuda.survival_supported(ours)


def _meta_inputs(pair, b=4, n=16, dh=16, dtype=torch.float32):
    _, _, model, _ = pair
    packed = survival_cuda.pack_survival_head_params(model.generator, 2)
    packed.flat = packed.flat.to("meta")
    tp = tuple(torch.empty((b, 128), device="meta") for _ in range(2))
    last = torch.empty((b, n, dh), device="meta", dtype=dtype)
    mask = torch.empty((b, n, 1), device="meta", dtype=torch.int64)
    return packed, tp, last, mask


def test_survival_wrapper_raises_off_the_cpu(pair, monkeypatch, tmp_path):
    """On tensors that are not on the CPU the wrapper checks its inputs and
    then builds and launches the kernel: wrong shapes, types and devices
    raise, and with no CUDA toolkit the build raises; nothing gives way to the
    plain version. (Tensors on the `meta` device stand in for a card.)"""
    from multimodal_particles_tpu_torch.ops import _build

    calls = survival_cuda.survival_head_reference.calls
    packed, tp, last, mask = _meta_inputs(pair)
    with pytest.raises(ValueError, match="hidden width"):
        survival_cuda.survival_head(packed, tp, last[..., :8], mask, n_heads=2)
    with pytest.raises(ValueError, match="mask_t"):
        survival_cuda.survival_head(packed, tp, last, mask[:, :8], n_heads=2)
    with pytest.raises(ValueError, match="n_heads"):
        survival_cuda.survival_head(packed, tp, last, mask, n_heads=3)
    with pytest.raises(ValueError, match="time rows"):
        survival_cuda.survival_head(packed, tp[:1], last, mask, n_heads=2)
    with pytest.raises(TypeError, match="float32"):
        survival_cuda.survival_head(packed, tp, last.double(), mask, n_heads=2)
    with pytest.raises(ValueError, match="outside"):
        big = torch.empty((4, 257, 16), device="meta")
        survival_cuda.survival_head(packed, tp, big, torch.empty((4, 257, 1), device="meta"),
                                    n_heads=2)
    cpu_packed = survival_cuda.pack_survival_head_params(pair[2].generator, 2)
    with pytest.raises(ValueError, match="is on cpu"):
        survival_cuda.survival_head(cpu_packed, tp, last, mask, n_heads=2)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    _build.load_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        survival_cuda.survival_head(packed, tp, last, mask, n_heads=2)
    _build.load_library.cache_clear()
    assert survival_cuda.survival_head_reference.calls == calls
    assert survival_cuda.survival_head.launches == 0
