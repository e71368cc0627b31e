"""The port's embeddings, EPiC modules, weight transplant, initialiser and the
EPiC kernel's plain version, held against the JAX package on the CPU.
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
    pack_mbm_encoder_params as jax_pack,
)
from multimodal_particles_tpu_torch import config_classes as torch_cfgs
from multimodal_particles_tpu_torch.models.architectures import utils as torch_utils
from multimodal_particles_tpu_torch.models.generative.init import init_mbm_parameters
from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (
    MultiModalBridgeMatching as TorchMBM,
)
from multimodal_particles_tpu_torch.models.generative.states import HybridState
from multimodal_particles_tpu_torch.ops.epic_cuda import (
    epic_forward_reference,
    pack_mbm_encoder_params,
)
from multimodal_particles_tpu_torch.utils.transplant import params_from_flax
from torch_port_helpers import model_pair, random_state, to_torch

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
    cfg = torch_cfgs.MultimodalBridgeMatchingConfig()
    setattr(cfg.encoder, field, value)
    with pytest.raises(NotImplementedError):
        TorchMBM(cfg)
