"""Every encoder switch of the JAX package's `InputEmbeddings` and both
contexts on the port, held against the JAX package on the CPU (N = 16, B = 8,
hidden 16, 2 blocks, transplanted flax weights, numpy-seeded inputs):

  time_linear         embedding_time "Linear" (a Dense over t)
  continuous_none     embedding_features_continuous None (x itself)
  discrete_linear     embedding_features_discrete "Linear" (a Dense over the
                      float token id)
  context_continuous  a Dense over a (B, 2) continuous context
  context_discrete    an Embedding of one context token of vocab 10
  both_contexts       the two contexts together

Each switch: the embedding, the EPiC wrapper and MBM's `forward` against
flax, and every kernel gate off. The conditional MBM (both contexts): its
`loss_fn` with every gradient against `jax.value_and_grad`, and an 8-step
`predict` with JAX's draws replayed. The conditional AbsorbingFlow: `forward`,
`loss_fn` with every gradient, and `forward_sampling` with the gate on (the
module trunk, then K6's plain version) against JAX's with `use_pallas=True`
(interpret mode). Tolerance: the module path's, atol 1e-5 / rtol 1e-4
(tests/test_torch_epic.py); gradients as tests/test_torch_train.py holds them
(atol 1e-4 · the leaf's largest entry, rtol 1e-3); sampled tokens and masks
mismatching on at most 1% of slots (CDF-boundary flips).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_particles_tpu.config_classes import AbsorbingConfig as JaxAbsorbingConfig
from multimodal_particles_tpu.models.architectures import epic as jax_epic
from multimodal_particles_tpu.models.architectures import utils as jax_utils
from multimodal_particles_tpu.models.generative.states import (
    AbsorbingBridgeState as JaxAbsorbingState,
)
from multimodal_particles_tpu.models.generative.states import HybridState as JaxState
from multimodal_particles_tpu.ops.epic_pallas import (
    epic_pattern_supported as jax_pattern_supported,
)
from multimodal_particles_tpu.ops.epic_pallas_wide import (
    wide_pallas_supported as jax_wide_supported,
)
from multimodal_particles_tpu_torch import config_classes as port_cfgs
from multimodal_particles_tpu_torch.models.generative.absorbing.absorbing_flows import (
    AbsorbingFlow,
)
from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (
    MultiModalBridgeMatching,
)
from multimodal_particles_tpu_torch.models.generative.states import (
    AbsorbingBridgeState,
    HybridState,
)
from multimodal_particles_tpu_torch.ops import epic_cuda, survival_cuda
from multimodal_particles_tpu_torch.ops.epic_cuda import epic_pattern_supported, epic_supported
from multimodal_particles_tpu_torch.ops.epic_wide_cuda import wide_supported
from multimodal_particles_tpu_torch.utils.transplant import params_from_flax
from torch_port_helpers import (
    B,
    CONTEXT_DATA,
    CONTEXT_ENCODER,
    N,
    context_pair,
    jax_bridge_draws,
    jax_config,
    port_batch,
    random_state,
    replay_absorbing_uniforms,
    replay_mbm_uniforms,
    switch_pair,
    to_torch,
)

torch.backends.cuda.matmul.allow_tf32 = False
ATOL, RTOL = 1e-5, 1e-4
MAX_MISMATCH = 0.01
STEPS = 8

CONTINUOUS_CONTEXT = ({"dim_context_continuous": 2},
                      {"dim_emb_context_continuous": CONTEXT_ENCODER["dim_emb_context_continuous"]})
DISCRETE_CONTEXT = ({"dim_context_discrete": 1, "vocab_size_context": 10},
                    {"dim_emb_context_discrete": CONTEXT_ENCODER["dim_emb_context_discrete"]})
SWITCHES = {
    "time_linear": {"encoder": {"embedding_time": "Linear"}},
    "continuous_none": {"encoder": {"embedding_features_continuous": None}},
    "discrete_linear": {"encoder": {"embedding_features_discrete": "Linear"}},
    "context_continuous": {"data": CONTINUOUS_CONTEXT[0], "encoder": CONTINUOUS_CONTEXT[1]},
    "context_discrete": {"data": DISCRETE_CONTEXT[0], "encoder": DISCRETE_CONTEXT[1]},
    "both_contexts": {"data": CONTEXT_DATA, "encoder": CONTEXT_ENCODER},
}
BOTH = SWITCHES["both_contexts"]


def close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               **(tol or dict(atol=ATOL, rtol=RTOL)))


def grads_close(model, grads, model_cls):
    """Every parameter's gradient against the transplanted JAX gradient."""
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, grads), model.config, model_cls)
    assert set(ref) == set(dict(model.named_parameters()))
    for name, p in model.named_parameters():
        r = ref[name].numpy()
        if name.endswith(".k.bias"):  # softmax cancels a key bias: 0 up to rounding
            assert np.abs(r).max() < 1e-6 and p.grad.abs().max() < 1e-6, name
            continue
        scale = max(float(np.abs(r).max()), 1e-6)
        np.testing.assert_allclose(p.grad.numpy(), r, atol=1e-4 * scale, rtol=1e-3, err_msg=name)


@pytest.fixture(scope="module", params=list(SWITCHES))
def switched(request):
    if request.param == "both_contexts":
        return request.param, context_pair("mbm")
    return request.param, switch_pair("mbm", seed=1, sections=SWITCHES[request.param])


@pytest.fixture(scope="module")
def conditional_mbm():
    return context_pair("mbm")


@pytest.fixture(scope="module")
def conditional_absorbing():
    return context_pair("absorbing")


def state_inputs(batch):
    t, x, k, mask = random_state()
    ctx = (batch.context_continuous, batch.context_discrete)
    return (t, x, k, mask), ctx


# ------------------------------------------------------ one switch at a time


def test_input_embeddings_match_flax(switched):
    """Features and context of the embedding, and the width the port works
    out at construction for each (flax infers them from the arrays)."""
    name, (jax_model, params, model, batch) = switched
    (t, x, k, mask), (ctx_c, ctx_d) = state_inputs(batch)
    ref_f, ref_c = jax_utils.InputEmbeddings(jax_model.config).apply(
        {"params": params["encoder"]["epic"]["embedding"]},
        *map(jnp.asarray, (t, x, k, mask)), ctx_c, ctx_d)
    embedding = model.encoder.epic.embedding
    with torch.no_grad():
        got_f, got_c = embedding(*to_torch(t, x, k, mask), *port_ctx(ctx_c, ctx_d))
    assert (embedding.dim_local, embedding.dim_context) == (ref_f.shape[-1], ref_c.shape[-1])
    close(got_f, ref_f)
    close(got_c, ref_c)


def port_ctx(ctx_c, ctx_d):
    return tuple(None if c is None else torch.from_numpy(np.array(c)) for c in (ctx_c, ctx_d))


def test_epic_wrapper_and_mbm_forward_match_flax(switched):
    """EPiCWrapper (with the hidden output) and MBM's `forward` with the
    batch's contexts; the absorbing head is the mask."""
    name, (jax_model, params, model, batch) = switched
    (t, x, k, mask), (ctx_c, ctx_d) = state_inputs(batch)
    out_j, hid_j = jax_epic.EPiCWrapper(jax_model.config).apply(
        {"params": params["encoder"]["epic"]}, *map(jnp.asarray, (t, x, k, mask)), ctx_c, ctx_d,
        True)
    heads_j = jax_model.forward(params, JaxState(*map(jnp.asarray, (t, x, k, mask))), batch)
    with torch.no_grad():
        out, hid = model.encoder.epic(*to_torch(t, x, k, mask), *port_ctx(ctx_c, ctx_d),
                                      output_hidden_local=True)
        heads = model.forward(HybridState(*to_torch(t, x, k, mask)), port_batch(batch))
    close(out, out_j)
    close(hid, hid_j)
    close(heads.continuous, heads_j.continuous)
    close(heads.discrete, heads_j.discrete)
    np.testing.assert_array_equal(heads.absorbing.numpy(), mask)


def test_every_kernel_gate_is_off(switched):
    """epic_pattern_supported, epic_supported and wide_supported refuse the
    switch as JAX's gates do, also at every width 128 (with
    `allow_linear_discrete`, which only the transdimensional trunk asks for,
    both take the Linear discrete input); MBM's gates are off even when
    forced, and the absorbing family packs no trunk kernel (its module trunk,
    then K6)."""
    name, (jax_model, _, model, _) = switched
    cfg, jax_cfg = model.config, jax_model.config
    wide = port_cfgs.MultimodalBridgeMatchingConfig.from_dict(cfg.to_dict())
    jax_wide = type(jax_cfg).from_dict(jax_cfg.to_dict())
    for c in (wide.encoder, jax_wide.encoder):
        c.dim_hidden_local = c.dim_hidden_glob = c.dim_emb_time = 128
        c.dim_emb_features_continuous = c.dim_emb_features_discrete = 128
    for allow in (False, True):
        expect = jax_pattern_supported(jax_cfg, allow)
        assert expect == (allow and name == "discrete_linear")
        assert epic_pattern_supported(cfg, allow) == epic_supported(cfg, allow) == expect
        assert wide_supported(wide, allow) == jax_wide_supported(jax_wide, allow) == expect
    try:
        cfg.parallel.use_pallas = True
        assert not model.kernel_enabled("cuda") and not model.wide_kernel_enabled("cuda")
    finally:
        cfg.parallel.use_pallas = "auto"
    absorbing = port_cfgs.AbsorbingConfig()
    for section, fields in SWITCHES[name].items():
        for field, value in fields.items():
            setattr(getattr(absorbing, section), field, value)
    absorbing.parallel.use_pallas = True
    model = AbsorbingFlow(absorbing)
    trunk, head = model.pack_for_kernel()
    assert trunk is None and model._pallas_enabled("cuda") and head.dim_hidden == 16


# -------------------------------------------------------- the conditional MBM


def test_conditional_mbm_loss_and_every_gradient_match_jax(conditional_mbm):
    """`loss_fn` on a batch with both contexts (the module path: the gates are
    off) against jax.value_and_grad of JAX's, with JAX's bridge draws."""
    jax_model, params, model, batch = conditional_mbm
    key = jax.random.PRNGKey(41)
    (_, metrics_j), grads = jax.jit(jax.value_and_grad(jax_model.loss_fn, has_aux=True))(
        params, key, batch)
    model.zero_grad()
    loss, metrics = model.loss_fn(port_batch(batch), draws=jax_bridge_draws(key, batch))
    loss.backward()
    assert set(metrics) == set(metrics_j)
    for name, value in metrics.items():
        np.testing.assert_allclose(value.item(), float(metrics_j[name]), rtol=1e-5, err_msg=name)
    grads_close(model, grads, MultiModalBridgeMatching)
    emb = model.encoder.epic.embedding
    assert emb.embedding_continuous_context.weight.grad.abs().max() > 0
    assert emb.embedding_context_discrete.weight.grad.abs().max() > 0


def test_conditional_mbm_predict_matches_jax(conditional_mbm):
    """An 8-step `predict` (7 steps) from the same source, the context fixed
    over the steps, with the uniforms JAX's module-path sampler draws from its
    key; another context moves the jets."""
    jax_model, params, model, batch = conditional_mbm
    key = jax.random.PRNGKey(42)
    final_j = jax_model.predict(params, batch, key)
    uniforms = replay_mbm_uniforms(key, STEPS - 1, B, N)
    torch_batch = port_batch(batch)
    final = model.predict(torch_batch, uniforms=uniforms)
    close(final.continuous, final_j.continuous)
    mismatch = (final.discrete.numpy() != np.asarray(final_j.discrete)).mean()
    assert mismatch <= MAX_MISMATCH
    torch_batch.context_continuous = torch_batch.context_continuous + 1.0
    other = model.predict(torch_batch, uniforms=uniforms)
    assert not torch.equal(other.continuous, final.continuous)


# -------------------------------------------------- the conditional absorbing


def absorbing_state(batch, seed=5):
    rng = np.random.default_rng(seed)
    mask = (rng.random((B, N, 1)) < 0.6).astype(np.int32)
    mask[0] = 0
    t = rng.uniform(0.05, 0.95, (B, 1, 1)).astype(np.float32)
    x = (np.asarray(batch.source_continuous) * mask).astype(np.float32)
    k = (np.asarray(batch.source_discrete) * mask).astype(np.int32)
    return t, x, k, mask


def test_conditional_absorbing_forward_and_sampling_match_jax(conditional_absorbing):
    """`forward` against flax, and `forward_sampling` with the gate on against
    JAX's with use_pallas=True: no trunk kernel takes a context, so both run
    the module trunk, then the survival head (K6's plain version here, the
    interpret-mode Pallas kernel in JAX)."""
    jax_model, params, model, batch = conditional_absorbing
    t, x, k, mask = absorbing_state(batch)
    state_j = JaxAbsorbingState(*map(jnp.asarray, (t, x, k, mask)))
    state = AbsorbingBridgeState(*to_torch(t, x, k, mask.astype(np.int64)))
    torch_batch = port_batch(batch)
    heads_j = jax_model.forward(params, state_j, batch)
    with torch.no_grad():
        heads = model.forward(state, torch_batch)
    for name in ("continuous", "discrete", "absorbing"):
        close(getattr(heads, name), getattr(heads_j, name))

    jax_model.config.parallel.use_pallas = model.config.parallel.use_pallas = True
    try:
        calls = epic_cuda.epic_forward_reference.calls, survival_cuda.survival_head_reference.calls
        sampled_j = jax_model.forward_sampling(params, state_j, batch)
        sampled = model.forward_sampling(state, batch=torch_batch)
        assert (epic_cuda.epic_forward_reference.calls,
                survival_cuda.survival_head_reference.calls) == (calls[0], calls[1] + 1)
    finally:
        jax_model.config.parallel.use_pallas = model.config.parallel.use_pallas = "auto"
    for name in ("continuous", "discrete", "absorbing"):
        close(getattr(sampled, name), getattr(sampled_j, name))


def test_conditional_absorbing_loss_and_every_gradient_match_jax(conditional_absorbing):
    jax_model, params, model, batch = conditional_absorbing
    key = jax.random.PRNGKey(43)
    (_, metrics_j), grads = jax.jit(jax.value_and_grad(jax_model.loss_fn, has_aux=True))(
        params, key, batch)
    key_t, key_x, key_k, key_m = jax.random.split(key, 4)
    x1 = batch.target_continuous
    draws = (jax.random.uniform(key_t, (B,), dtype=jnp.float32),
             jax.random.normal(key_x, x1.shape, dtype=jnp.float32),
             jax.random.uniform(key_k, (B, N), dtype=jnp.float32),
             jax.random.uniform(key_m, (B, N, 1)))
    model.zero_grad()
    loss, metrics = model.loss_fn(port_batch(batch),
                                  draws=tuple(torch.from_numpy(np.array(d)) for d in draws))
    loss.backward()
    for name, value in metrics.items():
        np.testing.assert_allclose(value.item(), float(metrics_j[name]), rtol=1e-4, err_msg=name)
    grads_close(model, grads, AbsorbingFlow)


def test_conditional_absorbing_predict_matches_jax(conditional_absorbing):
    """An 8-step `predict` on the module path with JAX's draws replayed: the
    masks and tokens within 1% of slots, the kinematics of the slots alive
    in both within the module-path tolerance."""
    jax_model, params, model, batch = conditional_absorbing
    key = jax.random.PRNGKey(44)
    final_j = jax_model.predict(params, batch, key)
    final = model.predict(port_batch(batch), uniforms=replay_absorbing_uniforms(
        key, STEPS - 1, B, N))
    mask_j = np.asarray(final_j.mask_t)
    assert (final.mask_t.numpy() != mask_j).mean() <= MAX_MISMATCH
    assert (final.discrete.numpy() != np.asarray(final_j.discrete)).mean() <= MAX_MISMATCH
    both = ((final.mask_t.numpy() > 0) & (mask_j > 0))[..., 0]
    np.testing.assert_allclose(final.continuous.numpy()[both],
                               np.asarray(final_j.continuous)[both], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("family", ["mbm", "absorbing"])
def test_context_and_dtype_fields_round_trip_through_yaml(family, tmp_path):
    """Every switch, both contexts and the bf16 compute dtype: the port's
    config writes the YAML text JAX's writes, and each reads the other's."""
    jax_cfg = jax_config() if family == "mbm" else JaxAbsorbingConfig()
    for section, fields in {**BOTH, "parallel": {"compute_dtype": "bfloat16"}}.items():
        for name, value in fields.items():
            setattr(getattr(jax_cfg, section), name, value)
    jax_cfg.encoder.embedding_time = "Linear"
    jax_cfg.encoder.embedding_features_continuous = None
    port_cls = (port_cfgs.MultimodalBridgeMatchingConfig if family == "mbm"
                else port_cfgs.AbsorbingConfig)
    cfg = port_cls.from_dict(jax_cfg.to_dict())
    jax_cfg.to_yaml(str(tmp_path / "jax.yaml"))
    cfg.to_yaml(str(tmp_path / "port.yaml"))
    assert (tmp_path / "jax.yaml").read_text() == (tmp_path / "port.yaml").read_text()
    again = port_cls.from_yaml(str(tmp_path / "jax.yaml"))
    assert again.to_dict() == jax_cfg.to_dict()
    assert type(jax_cfg).from_yaml(str(tmp_path / "port.yaml")).to_dict() == cfg.to_dict()
    assert (again.parallel.compute_dtype, again.data.vocab_size_context,
            again.encoder.embedding_features_continuous) == ("bfloat16", 10, None)


def test_new_layers_follow_flax_init_laws():
    """The port's initialiser draws the new layers by flax's laws: a Dense's
    kernel lecun-normal with a zero bias (time, continuous context, the token
    id), an Embed's table normal with std 1/√features (the context tokens)."""
    from multimodal_particles_tpu_torch.models.generative.init import init_mbm_parameters

    cfg = port_cfgs.MultimodalBridgeMatchingConfig()
    cfg.encoder.embedding_time = cfg.encoder.embedding_features_discrete = "Linear"
    cfg.data.dim_context_continuous, cfg.data.dim_context_discrete = 24, 1
    cfg.data.vocab_size_context = 4000
    cfg.encoder.dim_emb_context_continuous = cfg.encoder.dim_emb_context_discrete = 16
    emb = init_mbm_parameters(MultiModalBridgeMatching(cfg), 0).encoder.epic.embedding
    ctx = emb.embedding_continuous_context
    assert abs(ctx.weight.std().item() - 24 ** -0.5) < 0.15 * 24 ** -0.5
    assert ctx.weight.abs().max().item() <= 2 * 24 ** -0.5 / 0.87962566103423978 + 1e-6
    for dense in (emb.embedding_time, ctx, emb.embedding_discrete):
        assert torch.all(dense.bias == 0)
    table = emb.embedding_context_discrete.weight
    assert tuple(table.shape) == (4000, 16)
    assert abs(table.std().item() - 16 ** -0.5) < 0.05 * 16 ** -0.5
    assert table.abs().max().item() > 2.5 * 16 ** -0.5  # not truncated
