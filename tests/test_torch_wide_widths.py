"""K4, K5 and K6 at the widths the JAX wide gate takes up to 512, the port
against the JAX package on the CPU.

The wide kernels take the local hidden width, the global width and the time
embedding's each 128, 256, 384 or 512, mixed (on the card a jet is a cluster
of hidden / 128 blocks), the folded Linear-discrete input, and a discrete
head up to 512 wide; K6 takes a trunk wider than its transformer width. On
the CPU the wrappers take their plain versions, so these tests hold the
port's packing and its plain versions against the interpret-mode Pallas
kernels on transplanted weights (drawn by numpy on flax's shapes,
`drawn_params`, plus seeded noise):

    case                 widths (hidden, global, time, x, k)   blocks
    all256               256 everywhere                          2
    local256-glob128     256, 128, 256, 256, 256                 2
    all384               384 everywhere                          1
    all512               512 everywhere                          1
    fold256              the transdim trunk at 256, folded       1
    head128              the absorbing trunk at 256, head 128    1

and K6 at trunk hidden width 256 with C = 128. Each case checks the packing
leaf by leaf, the plain forward against `epic_forward_pallas_wide(...,
interpret=True)` and (the MBM cases) the plain backward against
`make_epic_train_forward_wide`'s gradients. B = 4, N = 12 (no multiple of 8).
Tolerances as tests/test_torch_wide.py (forward atol 1e-5 / rtol 1e-4;
gradients per leaf |err| ≤ 1e-4·max|ref leaf| + 1e-3·|ref|) and
tests/test_torch_scaled_families.py (the families' trunks per particle
1e-5 + 1e-4·max|ref|); K6 rtol = atol = 2e-4. Last, the gates:
`wide_supported` equals `wide_pallas_supported` over every combination of
widths 128 … 512 (and the fold), `survival_supported` equals
`survival_pallas_supported` at every width the port takes.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_particles_tpu.config_classes import AbsorbingConfig
from multimodal_particles_tpu.ops import survival_pallas
from multimodal_particles_tpu.ops.epic_pallas import WEIGHT_NAMES
from multimodal_particles_tpu.ops.epic_pallas_wide import (
    epic_forward_pallas_wide,
    pack_wide_encoder_params as jax_pack_wide,
    pack_wide_encoder_params_fold_discrete as jax_pack_wide_fold,
    wide_pallas_supported,
)
from multimodal_particles_tpu.ops.epic_pallas_wide_vjp import make_epic_train_forward_wide
from multimodal_particles_tpu_torch.config_classes import AbsorbingConfig as TorchAbsorbingConfig
from multimodal_particles_tpu_torch.config_classes import (
    MultimodalBridgeMatchingConfig as TorchConfig,
)
from multimodal_particles_tpu_torch.models.generative.transdimensional import structure
from multimodal_particles_tpu_torch.ops import epic_cuda, survival_cuda
from multimodal_particles_tpu_torch.ops.epic_vjp_cuda import epic_backward_reference
from multimodal_particles_tpu_torch.ops.epic_wide_cuda import (
    MAX_WIDE_HEAD,
    WIDE_WIDTHS,
    check_wide_packing,
    epic_forward_wide,
    pack_wide_encoder_params,
    wide_supported,
)
from multimodal_particles_tpu_torch.ops.epic_wide_vjp_cuda import (
    epic_backward_wide,
    epic_train_forward_wide,
    tensor_core_transposed_stages,
)
from torch_port_helpers import absorbing_pair, jax_config, model_pair, to_torch, transdim_pair

torch.backends.cuda.matmul.allow_tf32 = False
ATOL, RTOL = 1e-5, 1e-4
B, N = 4, 12


def widths(hidden, glob=None, time=None, x=None, k=None, blocks=1):
    return {"dim_hidden_local": hidden, "dim_hidden_glob": glob or hidden,
            "dim_emb_time": time or hidden, "dim_emb_features_continuous": x or hidden,
            "dim_emb_features_discrete": k or hidden, "num_blocks": blocks}


MBM_CASES = {
    "all256": widths(256, blocks=2),
    "local256-glob128": widths(256, glob=128, blocks=2),
    "all384": widths(384),
    "all512": widths(512),
}


@pytest.fixture(scope="module")
def mbm_pairs():
    pairs = {}

    def get(case):
        if case not in pairs:
            pairs[case] = model_pair(seed=3, drawn_init=True, **MBM_CASES[case])
        return pairs[case]
    return get


def static_kwargs(cfg):
    return dict(num_blocks=cfg.encoder.num_blocks, use_skip=cfg.encoder.skip_connection,
                add_discrete_head=cfg.encoder.add_discrete_head, dim_c=3, vocab=8,
                hidden=cfg.encoder.dim_hidden_local, dim_emb_time=cfg.encoder.dim_emb_time,
                interpret=True)


def random_state(seed, b=B, n=N):
    """t, x, k, mask as numpy: random non-prefix masks, jet 0 empty."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((b, n, 1)) < 0.7).astype(np.float32)
    mask[0] = 0.0
    x = (rng.standard_normal((b, n, 3)) * mask).astype(np.float32)
    k = (rng.integers(0, 8, (b, n, 1)) * mask).astype(np.int32)
    t = rng.uniform(0.05, 0.95, (b, 1, 1)).astype(np.float32)
    return t, x, k, mask


def per_particle_close(got, ref, atol=1e-5, rtol=1e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    bound = atol + rtol * np.abs(ref).max(axis=-1, keepdims=True)
    assert got.shape == ref.shape
    assert (np.abs(got - ref) <= bound).all(), np.abs(got - ref).max()


def leaves_match(packed, ref):
    """The port's wide buffer holds the JAX packing's arrays, leaf by leaf."""
    for name, view in packed.tensors.items():
        base, _, layer = name.rpartition("_")
        r = np.asarray(ref[base][int(layer)] if layer.isdigit() else ref[name])
        got = view.T if view.dim() == 2 and name != "table" else view
        np.testing.assert_allclose(got.numpy().reshape(r.shape), r, atol=1e-6, rtol=1e-6,
                                   err_msg=name)


# ------------------------------------------------------------- MBM's trunk


@pytest.mark.parametrize("case", list(MBM_CASES))
def test_wide_packing_matches_jax_packing(mbm_pairs, case):
    """The buffer, leaf by leaf; and the tensor-core stages and tables the
    card's kernels read, laid out a 128-column block after the other."""
    jax_model, params, model, _ = mbm_pairs(case)
    cfg = jax_model.config
    with torch.no_grad():
        packed = pack_wide_encoder_params(model.encoder, model.config)
    check_wide_packing(packed)
    leaves_match(packed, dict(zip(WEIGHT_NAMES, jax_pack_wide(params["encoder"],
                                                               cfg.encoder.num_blocks))))
    d = packed.dims
    stages, tables = packed.tensor_core
    per_layer = 2 * d.hidden * d.hidden * 2  # two (H, H) products, hi and lo halves
    assert stages.numel() == d.num_blocks * per_layer
    assert tables.numel() == (d.hidden // 128) * (3 + 8 + 1) * 128
    assert tensor_core_transposed_stages(packed.flat, d).numel() == stages.numel()
    # column block j of the first layer's fc_local1 stages: its columns 128·j … + 127
    w = packed.tensors["w_fl1_0"][:, :d.hidden].T
    blocks = stages[:d.hidden * d.hidden * 2].view(d.hidden // 128, -1)
    for j in range(d.hidden // 128):
        torch.testing.assert_close(blocks[j], epic_cuda.tensor_core_stages(
            w[:, 128 * j:128 * (j + 1)][None]), rtol=0, atol=0)


@pytest.mark.parametrize("case", list(MBM_CASES))
def test_plain_forward_matches_wide_pallas_interpret(mbm_pairs, case):
    jax_model, params, model, _ = mbm_pairs(case)
    cfg = jax_model.config
    t, x, k, mask = random_state(11)
    ref = epic_forward_pallas_wide(jax_pack_wide(params["encoder"], cfg.encoder.num_blocks),
                                   *map(jnp.asarray, (t, x, k, mask)), **static_kwargs(cfg))
    with torch.no_grad():
        packed = pack_wide_encoder_params(model.encoder, model.config)
        calls = epic_cuda.epic_forward_reference.calls
        got = epic_forward_wide(packed, *to_torch(t, x, k, mask))  # CPU: the plain version
    assert epic_cuda.epic_forward_reference.calls == calls + 1
    assert epic_forward_wide.launches == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", list(MBM_CASES))
def test_plain_backward_matches_wide_pallas_vjp(mbm_pairs, case):
    jax_model, params, model, _ = mbm_pairs(case)
    cfg = jax_model.config
    fused = make_epic_train_forward_wide(**static_kwargs(cfg))
    t, x, k, mask = random_state(12)
    g = np.random.default_rng(13).standard_normal((B, N, 11)).astype(np.float32)
    packed_jax = jax_pack_wide(params["encoder"], cfg.encoder.num_blocks)
    out_ref, vjp = jax.vjp(lambda p: fused(p, *map(jnp.asarray, (t, x, k, mask))), packed_jax)
    ref = dict(zip(WEIGHT_NAMES, (np.asarray(c) for c in vjp(jnp.asarray(g))[0])))
    packed = pack_wide_encoder_params(model.encoder, model.config)
    tt, tx, tk, tm = to_torch(t, x, k, mask)
    out = epic_train_forward_wide(packed, tt, tx, tk, tm)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref), atol=ATOL, rtol=RTOL)
    calls = epic_backward_reference.calls
    d_flat = epic_backward_wide(packed, tt, tx, tk, tm, torch.from_numpy(g))  # CPU: plain
    assert epic_backward_reference.calls == calls + 1
    assert torch.isfinite(d_flat).all()
    for name, value in epic_cuda.wide_flat_views(d_flat, packed.dims).items():
        base, _, layer = name.rpartition("_")
        r = ref[base][int(layer)] if layer.isdigit() else ref[name]
        got = value.T if value.dim() == 2 and name != "table" else value  # back to (in, out)
        scale = max(float(np.abs(r).max()), 1e-6)
        np.testing.assert_allclose(got.numpy().reshape(r.shape), r, atol=1e-4 * scale, rtol=1e-3,
                                   err_msg=name)


# ------------------------------------------- the families' trunks at 256


@pytest.fixture(scope="module")
def transdim256():
    return transdim_pair(seed=6, n=N, b=B, sections={"encoder": widths(256)}, drawn_init=True)


@pytest.fixture(scope="module")
def absorbing256():
    return absorbing_pair(seed=5, n=N, b=B, drawn_init=True, sections={
        "encoder": widths(256), "generator": {"discrete_head_hidden_dim": 128}})


def test_folded_trunk_at_256_matches_pallas_interpret(transdim256):
    """The transdimensional trunk at 256 (folded Linear-discrete input, no
    head, hidden output (B, N, 256)) against the interpret-mode wide kernel on
    `pack_wide_encoder_params_fold_discrete`, fed [x ‖ values]; the packing
    holds the blocks of JAX's block-diagonal input Dense."""
    jax_model, params, model, batch = transdim256
    rng = np.random.default_rng(1)
    noisy = [batch[0], batch[1], (batch[2] + 0.3 * rng.standard_normal(batch[2].shape).astype(
        np.float32)) * (batch[2].sum(-1, keepdims=True) > 0)]
    ts = rng.uniform(0.05, 1.0, B).astype(np.float32)
    state = structure.state_from_list_batch([torch.from_numpy(np.asarray(a)) for a in noisy])
    mask = state.particle_mask()[:, :, None].float()
    packed_j = jax_pack_wide_fold({"epic": params["network"]["epic"]}, 1, 3)
    out_j, hid_j = epic_forward_pallas_wide(
        packed_j, jnp.asarray(ts).reshape(B, 1, 1),
        jnp.asarray(np.concatenate([noisy[1], noisy[2]], axis=-1)),
        jnp.zeros((B, N, 1), jnp.int32), jnp.asarray(mask.numpy()), num_blocks=1, use_skip=True,
        add_discrete_head=False, dim_c=3, vocab=8, hidden=256, dim_emb_time=256,
        output_hidden_local=True, interpret=True, fold_discrete=True)
    trunk, rate_stack, vec_stack = model.pack_for_kernel()
    assert trunk.layout == "wide" and trunk.dims.fold_discrete and trunk.dims.hidden == 256
    assert (rate_stack.dim_in, vec_stack.dim_in) == (264, 267)
    check_wide_packing(trunk, any_head_width=True)
    W = trunk.tensors
    w_fold = np.asarray(dict(zip(WEIGHT_NAMES, packed_j))["w_x"])  # (3 + 8, 512)
    np.testing.assert_allclose(W["w_x"].T.numpy(), w_fold[:3, :256], atol=1e-6)
    np.testing.assert_allclose(W["table"].numpy(), w_fold[3:, 256:], atol=1e-6)
    out, hid = epic_forward_wide(trunk, torch.from_numpy(ts).reshape(B, 1, 1), state.continuous,
                                 state.discrete, mask, output_hidden_local=True)
    assert tuple(hid.shape) == (B, N, 256)
    per_particle_close(out.numpy(), out_j)
    per_particle_close(hid.numpy(), hid_j)


def test_absorbing_head_of_128_at_256_matches_pallas_interpret(absorbing256):
    """The absorbing trunk at 256 with a discrete head 128 wide (K4's head
    past the 64 it was built for) and the hidden output against the
    interpret-mode wide kernel on the JAX packing of {epic, fc_layer:
    discrete_head_mlp}; the packing leaf by leaf."""
    jax_model, params, model, _ = absorbing256
    t, x, k, mask = random_state(14)
    gen = params["generator"]
    packed_j = jax_pack_wide({"epic": gen["epic"], "fc_layer": gen["discrete_head_mlp"]}, 1, 3)
    out_j, hid_j = epic_forward_pallas_wide(
        packed_j, *map(jnp.asarray, (t, x, k, mask)), num_blocks=1, use_skip=True,
        add_discrete_head=True, dim_c=3, vocab=8, hidden=256, dim_emb_time=256,
        output_hidden_local=True, interpret=True)
    assert model._pallas_enabled("cuda") or not survival_cuda.survival_supported(model.config)
    trunk, head = model.pack_for_kernel()
    assert trunk.layout == "wide" and trunk.dims.head_hidden == 128 <= MAX_WIDE_HEAD
    assert head.dim_hidden == 256 and head.channels == 128
    leaves_match(trunk, dict(zip(WEIGHT_NAMES, packed_j)))
    out, hid = epic_forward_wide(trunk, *to_torch(t, x, k, mask), output_hidden_local=True)
    per_particle_close(out.numpy(), out_j)
    per_particle_close(hid.numpy(), hid_j)


def test_survival_head_on_a_trunk_of_256_matches_pallas_interpret(absorbing256):
    """K6's plain version at trunk hidden width 256 > C = 128 against
    `survival_head_pallas(..., interpret=True)` on the JAX packing."""
    _, params, model, _ = absorbing256
    gen_params, n_blocks = params["generator"], model.config.generator.n_attn_blocks
    rng = np.random.default_rng(15)
    t = rng.uniform(0.05, 0.95, (B, 1, 1)).astype(np.float32)
    last = rng.standard_normal((B, N, 256)).astype(np.float32)
    mask = (rng.random((B, N, 1)) < 0.6).astype(np.int32)
    mask[0] = 0
    pallas = survival_pallas.survival_head_pallas(
        survival_pallas.pack_survival_head_params(gen_params, n_blocks),
        survival_pallas.project_time_embeddings(gen_params, jnp.asarray(t), n_blocks, 128),
        jnp.asarray(last), jnp.asarray(mask), n_blocks=n_blocks, n_heads=2, transformer_dim=128,
        interpret=True)
    packed = survival_cuda.pack_survival_head_params(model.generator, n_blocks)
    assert packed.dim_hidden == 256 and packed.channels == 128
    assert packed.tensor_core.numel() == survival_cuda.head_stages(256, n_blocks) * 2 * 8 * 128
    tp = survival_cuda.project_time_embeddings(model.generator, torch.from_numpy(t), n_blocks, 128)
    got = survival_cuda.survival_head(packed, tp, torch.from_numpy(last),
                                      torch.from_numpy(mask).long(), n_heads=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=2e-4, atol=2e-4)


# -------------------------------------------------------------------- gates


def test_wide_gate_equals_jax_at_every_width_up_to_512():
    """`wide_supported` says what `wide_pallas_supported` says for every
    combination of the five widths in 128 … 512, with tokens and with the
    folded Linear-discrete input; above 512 and past 256 slots the port
    refuses where JAX takes its kernel."""
    cfg = jax_config(num_blocks=1)
    port = TorchConfig.from_dict(cfg.to_dict())
    names = ("dim_hidden_local", "dim_hidden_glob", "dim_emb_time",
             "dim_emb_features_continuous", "dim_emb_features_discrete")
    taken = 0
    for combo in itertools.product(WIDE_WIDTHS, repeat=len(names)):
        for linear in (False, True):
            for c in (cfg, port):
                for name, value in zip(names, combo):
                    setattr(c.encoder, name, value)
                c.encoder.embedding_features_discrete = "Linear" if linear else "Embedding"
            jax_on = wide_pallas_supported(cfg, allow_linear_discrete=linear)
            assert wide_supported(port, allow_linear_discrete=linear) == jax_on, (combo, linear)
            taken += jax_on
    assert taken == 2 * len(WIDE_WIDTHS) ** len(names)
    for name, value in zip(names, (640, 128, 128, 128, 128)):
        setattr(cfg.encoder, name, value)
        setattr(port.encoder, name, value)
    cfg.encoder.embedding_features_discrete = port.encoder.embedding_features_discrete = "Embedding"
    assert wide_pallas_supported(cfg) and not wide_supported(port)
    port.encoder.dim_hidden_local = 128
    port.data.max_num_particles = 257
    assert not wide_supported(port)
    port.data.max_num_particles = 128
    assert wide_supported(port, head_hidden=MAX_WIDE_HEAD)
    assert not wide_supported(port, head_hidden=MAX_WIDE_HEAD + 1)


def test_survival_gate_equals_jax_at_every_trunk_width():
    """`survival_supported` says what `survival_pallas_supported` says at
    transformer widths 128 … 512 and trunk hidden widths on both sides of
    them: the trunk may be wider than the head."""
    for C, hidden in itertools.product((128, 256, 384, 512), (16, 128, 256, 300, 512, 640)):
        cfg = AbsorbingConfig()
        cfg.generator.transformer_dim, cfg.encoder.dim_hidden_local = C, hidden
        cfg.generator.n_heads = C // 64  # heads of 64 channels
        ours = TorchAbsorbingConfig.from_dict(cfg.to_dict())
        assert survival_pallas.survival_pallas_supported(cfg)
        assert survival_cuda.survival_supported(ours), (C, hidden)
