"""The port's embeddings, EPiC modules, weight transplant, initialiser and the
EPiC kernel's plain version (with tokens, and with the folded Linear-discrete
input of the transdimensional trunk), held against the JAX package on the CPU.
Tolerance: atol 1e-5 / rtol 1e-4 (float32 on both sides; sums run in other
orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_particles_tpu.config_classes import multimodal_bridge_matching_config as jax_cfgs
from multimodal_particles_tpu.models.architectures import epic as jax_epic
from multimodal_particles_tpu.models.architectures import utils as jax_utils
from multimodal_particles_tpu.models.generative.states import HybridState as JaxState
from multimodal_particles_tpu.ops.epic_pallas import (
    epic_forward_pallas,
    pack_encoder_params_fold_discrete as jax_pack_fold,
    pack_mbm_encoder_params as jax_pack,
)
from multimodal_particles_tpu_torch import config_classes as torch_cfgs
from multimodal_particles_tpu_torch.models.architectures import utils as torch_utils
from multimodal_particles_tpu_torch.models.generative.init import init_mbm_parameters
from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (
    MultiModalBridgeMatching as TorchMBM,
)
from multimodal_particles_tpu_torch.models.generative.states import HybridState
from multimodal_particles_tpu_torch.ops import epic_cuda
from multimodal_particles_tpu_torch.ops.epic_cuda import (
    epic_forward_reference,
    pack_mbm_encoder_params,
)
from multimodal_particles_tpu_torch.ops.epic_vjp_cuda import epic_backward
from multimodal_particles_tpu_torch.ops.epic_wide_cuda import check_wide_packing
from multimodal_particles_tpu_torch.ops.sampler_cuda import sampler_step
from multimodal_particles_tpu_torch.utils.transplant import params_from_flax
from torch_port_helpers import model_pair, random_state, to_torch, transdim_pair

torch.backends.cuda.matmul.allow_tf32 = False
ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def pair():
    return model_pair()


def _np(a):
    return np.asarray(a)


def _flax_params_np(pair):
    return jax.tree_util.tree_map(np.asarray, pair[1])


def test_transplant_consumes_all_47_leaves(pair):
    params_np = _flax_params_np(pair)
    assert len(jax.tree_util.tree_leaves(params_np)) == 47
    torch_model = pair[2]
    state_dict = params_from_flax(params_np, torch_model.config)
    assert set(state_dict) == set(torch_model.state_dict())
    assert len(state_dict) == 47
    # a Dense kernel (in, out) lands transposed in Linear.weight (out, in)
    kernel = params_np["encoder"]["epic"]["embedding"]["embedding_continuous"]["kernel"]
    np.testing.assert_array_equal(
        state_dict["encoder.epic.embedding.embedding_continuous.weight"].numpy(), kernel.T
    )


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_transplant_rejects_bad_trees(pair, fault):
    params_np = _flax_params_np(pair)
    proj = params_np["encoder"]["epic"]["epic"]["epic_proj"]
    if fault == "missing":
        del proj["global_1"]["g"]
    elif fault == "extra":
        proj["global_3"] = {"v": np.zeros((16, 16), np.float32)}
    else:
        proj["local_0"]["bias"] = np.zeros(17, np.float32)
    with pytest.raises((KeyError, ValueError)):
        params_from_flax(params_np, pair[2].config)


@pytest.mark.parametrize("dim", [16, 15])
def test_sinusoidal_positional_encoding_matches_flax(dim):
    t = np.random.default_rng(0).random((8, 1), dtype=np.float32)
    ref = _np(jax_utils.sinusoidal_positional_encoding(jnp.asarray(t), dim))
    got = torch_utils.sinusoidal_positional_encoding(torch.from_numpy(t), dim).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_input_embeddings_matches_flax(pair):
    jax_model, params, torch_model, _ = pair
    t, x, k, mask = random_state()
    emb_params = params["encoder"]["epic"]["embedding"]
    ref_f, ref_c = jax_utils.InputEmbeddings(jax_model.config).apply(
        {"params": emb_params}, jnp.asarray(t), jnp.asarray(x), jnp.asarray(k), jnp.asarray(mask)
    )
    with torch.no_grad():
        got_f, got_c = torch_model.encoder.epic.embedding(*to_torch(t, x, k, mask))
    np.testing.assert_allclose(got_f.numpy(), _np(ref_f), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_c.numpy(), _np(ref_c), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("module", ["projection", "layer", "network", "wrapper"])
def test_epic_modules_match_flax(pair, module):
    jax_model, params, torch_model, _ = pair
    cfg_e = jax_model.config.encoder
    t, x, k, mask = random_state()
    rng = np.random.default_rng(2)
    H = cfg_e.dim_hidden_local
    x_local = rng.standard_normal((8, 16, 48)).astype(np.float32) * mask
    h_local = rng.standard_normal((8, 16, H)).astype(np.float32) * mask
    g = rng.standard_normal((8, cfg_e.dim_hidden_glob)).astype(np.float32)
    ctx = rng.standard_normal((8, cfg_e.dim_emb_time)).astype(np.float32)
    enc = params["encoder"]["epic"]
    tm = torch_model.encoder.epic
    with torch.no_grad():
        if module == "projection":
            ref = jax_epic.EPiCProjection(H, cfg_e.dim_hidden_glob).apply(
                {"params": enc["epic"]["epic_proj"]}, x_local, ctx, mask)
            got = tm.epic.epic_proj(*to_torch(x_local, ctx, mask))
        elif module == "layer":
            ref = jax_epic.EPiCLayer(H, cfg_e.dim_hidden_glob, H).apply(
                {"params": enc["epic"]["epic_layer_1"]}, h_local, g, ctx, mask)
            got = tm.epic.epic_layer_1(*to_torch(h_local, g, ctx, mask))
        elif module == "network":
            net = jax_epic.EPiCNetwork(
                dim_output=11, num_blocks=cfg_e.num_blocks, dim_hidden_local=H,
                dim_hidden_global=cfg_e.dim_hidden_glob,
                use_skip_connection=cfg_e.skip_connection)
            ref = net.apply({"params": enc["epic"]}, x_local, ctx, mask)
            got = tm.epic(*to_torch(x_local, ctx, mask))
        else:
            ref = jax_epic.EPiCWrapper(jax_model.config).apply({"params": enc}, t, x, k, mask)
            got = tm(*to_torch(t, x, k, mask))
    for r, o in zip(jax.tree_util.tree_leaves(ref), (got if isinstance(got, tuple) else (got,))):
        np.testing.assert_allclose(o.numpy(), _np(r), atol=ATOL, rtol=RTOL)


def test_multimodal_epic_forward_matches_flax(pair):
    jax_model, params, torch_model, batch = pair
    t, x, k, mask = random_state()
    ref = jax_model.forward(params, JaxState(*map(jnp.asarray, (t, x, k, mask))), batch)
    with torch.no_grad():
        got = torch_model.forward(HybridState(*to_torch(t, x, k, mask)))
    np.testing.assert_allclose(got.continuous.numpy(), _np(ref.continuous), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.discrete.numpy(), _np(ref.discrete), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got.absorbing.numpy(), mask)


def test_epic_forward_reference_matches_pallas_interpret(pair):
    jax_model, params, torch_model, _ = pair
    cfg = jax_model.config
    t, x, k, mask = random_state()
    ref = epic_forward_pallas(
        jax_pack(params["encoder"], cfg.encoder.num_blocks), *map(jnp.asarray, (t, x, k, mask)),
        num_blocks=cfg.encoder.num_blocks, use_skip=cfg.encoder.skip_connection,
        add_discrete_head=cfg.encoder.add_discrete_head, dim_c=3, vocab=8,
        hidden=cfg.encoder.dim_hidden_local, dim_emb_time=cfg.encoder.dim_emb_time,
        interpret=True,
    )
    with torch.no_grad():
        packed = pack_mbm_encoder_params(torch_model.encoder, torch_model.config)
        got = epic_forward_reference(packed, *to_torch(t, x, k, mask))
    assert packed.flat.is_contiguous() and packed.flat.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=ATOL, rtol=RTOL)
    assert np.isfinite(got.numpy()).all()  # jet 0 is empty


@pytest.mark.parametrize(
    "name", ["TrainingConfig", "JetsDataConfig", "BridgeConfig", "EncoderConfig", "ParallelConfig"]
)
def test_config_mirror_matches_jax_dataclasses(name):
    def fields(cls):
        return [(f.name, f.type, f.default,
                 f.default_factory() if f.default_factory is not dataclasses.MISSING else None)
                for f in dataclasses.fields(cls)]

    assert fields(getattr(torch_cfgs, name)) == fields(getattr(jax_cfgs, name))


def test_init_mirrors_flax_defaults(pair):
    cfg = torch_cfgs.MultimodalBridgeMatchingConfig()
    model = init_mbm_parameters(TorchMBM(cfg), 0)
    again = init_mbm_parameters(TorchMBM(cfg), 0)
    for (name, p), q in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(p, q), name
    layer = model.encoder.epic.epic.epic_layer_0.fc_global1  # fan_in 64
    torch.testing.assert_close(layer.g, torch.linalg.vector_norm(layer.v, dim=1))
    assert torch.all(layer.bias == 0) and torch.all(model.loss_weights == 0)
    assert abs(layer.v.std().item() - 64 ** -0.5) < 0.2 * 64 ** -0.5
    assert layer.v.abs().max().item() <= 2 * 64 ** -0.5 / 0.87962566103423978 + 1e-6
    table = model.encoder.epic.embedding.embedding_discrete.weight
    assert abs(table.std().item() - 16 ** -0.5) < 0.3 * 16 ** -0.5
    # a flax-initialised tree transplants onto exactly these keys and shapes
    flax_sd = params_from_flax(_flax_params_np(pair), cfg)
    assert {k: tuple(v.shape) for k, v in flax_sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("field,value", [
    ("embedding_time", "Linear"),
    ("embedding_features_continuous", None),
    ("embedding_features_discrete", "Linear"),
])
def test_unported_embedding_switch_raises(field, value):
    """Each switch, once refused, now builds (tests/test_torch_embedding_switches.py
    holds it against JAX), turns every kernel gate off and runs the module
    forward; a name the JAX module does not know still raises."""
    cfg = torch_cfgs.MultimodalBridgeMatchingConfig()
    setattr(cfg.encoder, field, value)
    cfg.parallel.use_pallas = True
    model = init_mbm_parameters(TorchMBM(cfg), 0)
    assert not model.kernel_enabled("cuda") and not model.wide_kernel_enabled("cuda")
    assert not epic_cuda.epic_supported(cfg)
    with torch.no_grad():
        heads = model.forward_train(HybridState(*to_torch(*random_state())))
    assert torch.isfinite(heads.continuous).all() and tuple(heads.discrete.shape) == (8, 16, 8)
    setattr(cfg.encoder, field, "Fourier")
    with pytest.raises(NotImplementedError):
        TorchMBM(cfg)


# ------------------------------- K1's folded Linear-discrete input (plain version)


@pytest.fixture(scope="module")
def fold_pair():
    """The transdimensional family at hidden 16 / global 19: its trunk is a
    bare EPiCWrapper whose discrete embedding is a Dense over the V values."""
    return transdim_pair(seed=0, n=16, b=8)


def _fold_inputs(seed=1):
    """t, x, noisy one-hot values (B, N, 8), prefix masks with a jet at
    dims = 1 and an empty one."""
    rng = np.random.default_rng(seed)
    t = rng.random((8, 1, 1), dtype=np.float32)
    dims = rng.integers(1, 17, 8)
    dims[0], dims[1] = 1, 0
    mask = (np.arange(16)[None, :] < dims[:, None]).astype(np.float32)[..., None]
    x = rng.standard_normal((8, 16, 3)).astype(np.float32) * mask
    values = (np.eye(8, dtype=np.float32)[rng.integers(0, 8, (8, 16))]
              + 0.3 * rng.standard_normal((8, 16, 8)).astype(np.float32)) * mask
    return t, x, values, mask


def test_fold_packing_layout(fold_pair):
    """The folded layout: the Dense's kernel in the table's slot, its bias in
    a slot of its own after it, no discrete head, the fold in the C dims; the
    token layout keeps its offsets."""
    *_, model, _ = fold_pair
    packed = epic_cuda.pack_encoder_params_fold_discrete(model.network, model.config)
    assert model.config.encoder.add_discrete_head  # the config says so; the bare trunk has none
    assert packed.dims.fold_discrete and not packed.dims.add_discrete_head
    assert list(packed.dims.c_array()) == [16, 19, 16, 16, 16, 2, 1, 0, 8, 1]
    names = [name for name, _ in epic_cuda.weight_layout(packed.dims)]
    assert names[:5] == ["w_x", "b_x", "table", "b_k", "w_l0"]
    emb = model.network.epic.embedding.embedding_discrete
    assert torch.equal(packed.tensors["table"], emb.weight.detach().T)
    assert torch.equal(packed.tensors["b_k"], emb.bias.detach())
    tokens = dataclasses.replace(packed.dims, fold_discrete=False)
    assert "b_k" not in [name for name, _ in epic_cuda.weight_layout(tokens)]
    assert packed.flat.numel() == sum(
        int(np.prod(s)) for _, s in epic_cuda.weight_layout(tokens)) + 16
    assert not packed.flat.requires_grad


@pytest.mark.parametrize("hidden_out", [True, False])
def test_plain_epic_forward_with_the_fold_matches_pallas_and_flax(fold_pair, hidden_out):
    """`pack_encoder_params_fold_discrete` + `epic_forward` on CPU tensors (its
    plain version) against `epic_forward_pallas(fold_discrete=True)` in
    interpret mode, which takes [x ‖ values] as one input, and against the flax
    EPiCWrapper, at hidden 16 / global 19; atol 1e-4."""
    jax_model, params, model, _ = fold_pair
    enc = jax_model.config.encoder
    t, x, values, mask = _fold_inputs()
    epic_params = params["network"]["epic"]
    ref = epic_forward_pallas(
        jax_pack_fold({"epic": epic_params}, enc.num_blocks, 3), jnp.asarray(t),
        jnp.concatenate([jnp.asarray(x), jnp.asarray(values)], axis=-1),
        jnp.zeros((8, 16, 1), jnp.int32), jnp.asarray(mask), num_blocks=enc.num_blocks,
        use_skip=enc.skip_connection, add_discrete_head=False, dim_c=3, vocab=8,
        hidden=enc.dim_hidden_local, dim_emb_time=enc.dim_emb_time,
        output_hidden_local=hidden_out, interpret=True, fold_discrete=True)
    flax_out = jax_epic.EPiCWrapper(jax_model.config).apply(
        {"params": epic_params}, jnp.asarray(t), jnp.asarray(x), jnp.asarray(values),
        jnp.asarray(mask), None, None, output_hidden_local=hidden_out)
    packed = epic_cuda.pack_encoder_params_fold_discrete(model.network, model.config)
    calls = epic_forward_reference.calls
    got = epic_cuda.epic_forward(packed, *to_torch(t, x, values, mask),
                                 output_hidden_local=hidden_out)
    assert epic_forward_reference.calls == calls + 1  # CPU tensors: the plain version
    pairs = zip(got, ref, flax_out) if hidden_out else [(got, ref, flax_out)]
    for g, r, f in pairs:
        np.testing.assert_allclose(g.numpy(), _np(r), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g.numpy(), _np(f), rtol=1e-4, atol=1e-4)
    if hidden_out:
        assert tuple(got[1].shape) == (8, 16, 16)
    assert np.isfinite(np.asarray(got[0] if hidden_out else got)).all()  # jet 1 is empty


def test_linear_discrete_embedding_matches_flax(fold_pair):
    """InputEmbeddings with the Dense over the channel values, 1e-5."""
    jax_model, params, model, _ = fold_pair
    t, x, values, mask = _fold_inputs(2)
    ref, ref_ctx = jax_utils.InputEmbeddings(jax_model.config).apply(
        {"params": params["network"]["epic"]["embedding"]}, *map(jnp.asarray, (t, x, values, mask)))
    with torch.no_grad():
        got, ctx = model.network.epic.embedding(*to_torch(t, x, values, mask))
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ctx.numpy(), _np(ref_ctx), rtol=RTOL, atol=ATOL)
    assert model.network.epic.embedding.dim_local == 48


def test_other_kernels_refuse_a_folded_packing(fold_pair):
    """Only the forward kernel reads the folded layout: the sampler step, the
    backward kernel and the wide kernels raise before anything reads the
    buffer, and the forward wrapper wants the (B, N, 8) float values."""
    *_, model, _ = fold_pair
    packed = epic_cuda.pack_encoder_params_fold_discrete(model.network, model.config)
    packed.flat = packed.flat.to("meta")
    t, x, values, mask = (a.to("meta") for a in to_torch(*_fold_inputs()))
    tokens = torch.empty((8, 16, 1), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="folded"):
        sampler_step(packed, x, tokens, mask, torch.empty((2, 8, 16), device="meta"), 0.5, 0.01,
                     gamma=0.125)
    with pytest.raises(ValueError, match="folded"):
        epic_backward(packed, t, x, tokens, mask, torch.empty((8, 16, 11), device="meta"))
    with pytest.raises(ValueError, match="folded"):
        wide = dataclasses.replace(packed.dims, hidden=128, hidden_glob=128, emb_t=128, emb_x=128,
                                   emb_k=128)
        check_wide_packing(dataclasses.replace(packed, layout="wide", dims=wide))
    epic_cuda.check_narrow_packing(packed, any_head_width=True)
    with pytest.raises(ValueError, match=r"\(8, 16, 8\)"):
        epic_cuda.epic_forward(packed, t, x, tokens, mask)
    with pytest.raises(TypeError):
        epic_cuda.epic_forward(packed, t, x, values.double(), mask)


@pytest.mark.parametrize("allow,discrete,expected", [
    (False, "Embedding", True), (False, "Linear", False), (True, "Linear", True),
    (True, "Embedding", True), (True, "OneHot", False),
])
def test_epic_supported_with_the_linear_discrete_input(allow, discrete, expected):
    cfg = torch_cfgs.TransdimensionalEpicConfig()
    cfg.encoder.embedding_features_discrete = discrete
    assert epic_cuda.epic_supported(cfg, allow_linear_discrete=allow) is expected
    assert epic_cuda.epic_pattern_supported(cfg, allow) is expected
