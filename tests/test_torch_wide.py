"""The port's wide slice (every width 128, the `--scaled` regime) against the
JAX package on the CPU, at 2 blocks, B=8, N=16 so that interpret mode stays
cheap: the plain forward on the wide packing against
`epic_forward_pallas_wide`, the plain backward against the wide custom VJP,
the two kernel gates against the JAX gates, `loss_fn` and every parameter
gradient, the 8-timestep slice, the path the wide sampler takes, and the
transplant at 6 blocks. The wide CUDA kernels themselves run only on the
card (tests/test_torch_cuda.py).

Inputs come from numpy seeds, float32 on both sides. Tolerances: forward
atol 1e-5 / rtol 1e-4 (sums in other orders); gradients per leaf
|err| ≤ 1e-4·max|ref leaf| + 1e-3·|ref|
(tests/test_ops/test_epic_pallas_wide.py); tokens mismatching on at most 1%
of slots.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_particles_tpu.models.generative import bridges as jax_bridges
from multimodal_particles_tpu.models.generative.states import HybridState as JaxState
from multimodal_particles_tpu.ops.epic_pallas import WEIGHT_NAMES, mbm_pallas_supported
from multimodal_particles_tpu.ops.epic_pallas_wide import (
    epic_forward_pallas_wide,
    pack_wide_encoder_params as jax_pack_wide,
    wide_pallas_supported,
)
from multimodal_particles_tpu.ops.epic_pallas_wide_vjp import make_epic_train_forward_wide
from multimodal_particles_tpu_torch.config_classes import (
    MultimodalBridgeMatchingConfig as TorchConfig,
)
from multimodal_particles_tpu_torch.data import MultimodalDatabatch
from multimodal_particles_tpu_torch.models.generative import multimodal_bridge_matching as port_mbm
from multimodal_particles_tpu_torch.models.generative.states import HybridState
from multimodal_particles_tpu_torch.ops.epic_cuda import (
    epic_forward,
    epic_forward_reference,
    epic_supported,
    flat_views,
    pack_mbm_encoder_params,
    wide_flat_views,
    wide_weight_layout,
)
from multimodal_particles_tpu_torch.ops.epic_vjp_cuda import (
    epic_backward_reference,
    epic_train_forward_reference,
)
from multimodal_particles_tpu_torch.ops.epic_wide_cuda import (
    epic_forward_wide,
    pack_wide_encoder_params,
    wide_supported,
)
from multimodal_particles_tpu_torch.ops.epic_wide_vjp_cuda import (
    epic_backward_wide,
    epic_train_forward_wide,
)
from multimodal_particles_tpu_torch.utils.transplant import params_from_flax
from torch_port_helpers import B, N, jax_config, model_pair, random_state, to_torch

torch.backends.cuda.matmul.allow_tf32 = False
ATOL, RTOL = 1e-5, 1e-4
MAX_TOKEN_MISMATCH = 0.01
STEPS = 8
WIDE = dict(dim_hidden_local=128, dim_hidden_glob=128, dim_emb_time=128,
            dim_emb_features_continuous=128, dim_emb_features_discrete=128, num_blocks=2)


def static_kwargs(cfg):
    return dict(num_blocks=cfg.encoder.num_blocks, use_skip=cfg.encoder.skip_connection,
                add_discrete_head=cfg.encoder.add_discrete_head, dim_c=3, vocab=8,
                hidden=cfg.encoder.dim_hidden_local, dim_emb_time=cfg.encoder.dim_emb_time,
                interpret=True)


def grads_close(got: np.ndarray, ref: np.ndarray, name: str):
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got, ref, atol=1e-4 * scale, rtol=1e-3, err_msg=name)


@pytest.fixture(scope="module")
def pair():
    return model_pair(num_timesteps=STEPS, **WIDE)


# ------------------------------------------------------------------ packing


def test_wide_packing_is_the_narrow_packing_transposed(pair):
    torch_model = pair[2]
    with torch.no_grad():
        narrow = pack_mbm_encoder_params(torch_model.encoder, torch_model.config)
        wide = pack_wide_encoder_params(torch_model.encoder, torch_model.config)
    assert wide.flat.numel() == narrow.flat.numel()
    assert list(wide.tensors) == list(narrow.tensors)
    for name, value in narrow.tensors.items():
        assert torch.equal(wide.tensors[name], value), name
    # matrices lie (in, out) in the buffer, the token table (vocab, emb)
    shapes = dict(wide_weight_layout(wide.dims))
    assert shapes["w_fl1_0"] == (384, 128) and shapes["w_fg1_1"] == (512, 128)
    assert shapes["w_x"] == (3, 128) and shapes["table"] == (8, 128)
    off = dict(zip(shapes, np.cumsum([0] + [int(np.prod(s)) for s in shapes.values()])))
    w = wide.flat[off["w_fl1_0"]:off["w_fl1_0"] + 384 * 128].view(384, 128)
    assert torch.equal(w, narrow.tensors["w_fl1_0"].T)


def test_wide_packing_matches_jax_packing(pair):
    """The buffer holds the JAX wide packing's arrays, leaf by leaf."""
    jax_model, params, torch_model, _ = pair
    ref = dict(zip(WEIGHT_NAMES, jax_pack_wide(params["encoder"], WIDE["num_blocks"])))
    with torch.no_grad():
        wide = pack_wide_encoder_params(torch_model.encoder, torch_model.config)
    for name, view in wide.tensors.items():
        base, _, layer = name.rpartition("_")
        r = np.asarray(ref[base][int(layer)] if layer.isdigit() else ref[name])
        got = view.T if view.dim() == 2 and name != "table" else view
        # JAX packs (in, out) matrices and biases as (1, d) rows
        np.testing.assert_allclose(got.numpy().reshape(r.shape), r, atol=1e-6, rtol=1e-6,
                                   err_msg=name)


def test_differentiable_wide_packing_reaches_every_encoder_leaf(pair):
    torch_model = pair[2]
    t, x, k, mask = to_torch(*random_state())
    torch_model.zero_grad()
    packed = pack_wide_encoder_params(torch_model.encoder, torch_model.config, differentiable=True)
    assert packed.flat.requires_grad
    epic_train_forward_wide(packed, t, x, k, mask).square().sum().backward()
    for name, p in torch_model.encoder.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert p.grad.abs().max() > 0, name
    torch_model.zero_grad()


# ------------------------------------------------------- forward and backward


def test_plain_forward_matches_wide_pallas_interpret(pair):
    jax_model, params, torch_model, _ = pair
    cfg = jax_model.config
    t, x, k, mask = random_state()
    ref = epic_forward_pallas_wide(
        jax_pack_wide(params["encoder"], cfg.encoder.num_blocks),
        *map(jnp.asarray, (t, x, k, mask)), **static_kwargs(cfg))
    with torch.no_grad():
        packed = pack_wide_encoder_params(torch_model.encoder, torch_model.config)
        calls, launches = epic_forward_reference.calls, epic_forward_wide.launches
        got = epic_forward_wide(packed, *to_torch(t, x, k, mask))  # CPU: the plain version
    assert epic_forward_reference.calls == calls + 1
    assert epic_forward_wide.launches == launches
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    assert (got.numpy()[0, :, :3] == 0).all()  # the empty jet's masked continuous head


@pytest.mark.parametrize("encoder", [
    {}, {"skip_connection": False}, {"add_discrete_head": False},
    {"skip_connection": False, "add_discrete_head": False},
], ids=["skip_head", "no_skip", "no_head", "no_skip_no_head"])
def test_plain_backward_matches_wide_pallas_vjp(encoder):
    jax_model, params, torch_model, _ = model_pair(**{**WIDE, **encoder})
    cfg = jax_model.config
    fused = make_epic_train_forward_wide(**static_kwargs(cfg))
    t, x, k, mask = random_state()  # jet 0 is empty
    g = np.random.default_rng(9).standard_normal((B, N, 11)).astype(np.float32)
    packed_jax = jax_pack_wide(params["encoder"], cfg.encoder.num_blocks)
    out_ref, vjp = jax.vjp(lambda p: fused(p, *map(jnp.asarray, (t, x, k, mask))), packed_jax)
    (cot,) = vjp(jnp.asarray(g))
    ref = dict(zip(WEIGHT_NAMES, (np.asarray(c) for c in cot)))

    packed = pack_wide_encoder_params(torch_model.encoder, torch_model.config)
    tt, tx, tk, tm = to_torch(t, x, k, mask)
    out = epic_train_forward_wide(packed, tt, tx, tk, tm)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref), atol=ATOL, rtol=RTOL)
    calls = epic_backward_reference.calls
    d_flat = epic_backward_wide(packed, tt, tx, tk, tm, torch.from_numpy(g))  # CPU: plain
    assert epic_backward_reference.calls == calls + 1
    assert epic_backward_wide.launches == 0
    assert torch.isfinite(d_flat).all()
    for name, value in wide_flat_views(d_flat, packed.dims).items():
        base, _, layer = name.rpartition("_")
        r = ref[base][int(layer)] if layer.isdigit() else ref[name]
        got = value.T if value.dim() == 2 and name != "table" else value  # back to (in, out)
        grads_close(got.numpy().reshape(r.shape), r, name)
    if not cfg.encoder.add_discrete_head:
        for name in ("w_h0", "b_h0", "w_h1", "b_h1"):
            assert not wide_flat_views(d_flat, packed.dims)[name].any()


def test_backward_reference_follows_the_packing_layout(pair):
    """The same cotangent through both packings gives the same gradient per
    named weight: `epic_backward_reference` rebinds the views of the layout it
    was given."""
    torch_model = pair[2]
    t, x, k, mask = to_torch(*random_state())
    g = torch.randn((B, N, 11), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        narrow = pack_mbm_encoder_params(torch_model.encoder, torch_model.config)
        wide = pack_wide_encoder_params(torch_model.encoder, torch_model.config)
    d_narrow = flat_views(epic_backward_reference(narrow, t, x, k, mask, g), narrow.dims)
    d_wide = wide_flat_views(epic_backward_reference(wide, t, x, k, mask, g), wide.dims)
    for name, value in d_narrow.items():
        # transposed operands take other product routines: sums in other orders
        grads_close(d_wide[name].numpy(), value.numpy(), name)


def test_wrappers_refuse_the_other_layout(pair):
    """A kernel reads one layout: the checks that run before a launch raise
    on the other packing (on the CPU both wrappers take the plain version, so
    the checks are called directly)."""
    from multimodal_particles_tpu_torch.ops.epic_cuda import check_narrow_packing
    from multimodal_particles_tpu_torch.ops.epic_wide_cuda import check_wide_packing

    torch_model = pair[2]
    with torch.no_grad():
        narrow = pack_mbm_encoder_params(torch_model.encoder, torch_model.config)
        wide = pack_wide_encoder_params(torch_model.encoder, torch_model.config)
    check_wide_packing(wide)
    with pytest.raises(ValueError):
        check_wide_packing(narrow)
    with pytest.raises(ValueError):
        check_narrow_packing(wide)
    with pytest.raises(ValueError):
        check_narrow_packing(narrow)  # the right layout at a width with no narrow kernel


# -------------------------------------------------------------------- gates


def _gate_case(model_axis=1, use_pallas="auto", max_num_particles=N, **encoder):
    cfg = jax_config(**encoder)
    cfg.parallel.model_axis = model_axis
    cfg.parallel.use_pallas = use_pallas
    cfg.data.max_num_particles = max_num_particles
    return cfg


GATE_CASES = {
    # name: (config overrides, narrow gate as the port has it, wide gate as the port has it)
    "berlin": ({}, True, False),
    "hidden64": ({"dim_hidden_local": 64, "dim_hidden_glob": 64}, True, False),
    "scaled": (WIDE, False, True),
    "scaled_6_blocks": ({**WIDE, "num_blocks": 6}, False, True),
    "berlin_model_axis_2": ({"model_axis": 2}, False, False),
    "scaled_model_axis_2": ({**WIDE, "model_axis": 2}, False, False),
    "scaled_learned_time": ({**WIDE, "embedding_time": "Linear"}, False, False),
    "hidden128_emb16": ({"dim_hidden_local": 128, "dim_hidden_glob": 128}, False, False),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_gates_match_the_jax_gates(case):
    overrides, narrow, wide = GATE_CASES[case]
    cfg = _gate_case(**overrides)
    port_cfg = TorchConfig.from_dict(cfg.to_dict())
    assert epic_supported(port_cfg) == narrow
    assert wide_supported(port_cfg) == wide
    assert not (narrow and wide)
    assert wide_supported(port_cfg) == wide_pallas_supported(cfg)
    # the JAX narrow gate also asks for N % 128 == 0, a TPU lane condition
    cfg.data.max_num_particles = 128
    assert mbm_pallas_supported(cfg) == narrow


def test_widths_the_port_has_no_kernel_for_take_the_module_path():
    """JAX sends every multiple of 128 to its wide kernel, at any N; the
    port's take 128 to 512 (256 is the wide gate's) and N ≤ 256, so 640 and
    N = 257 go to neither gate."""
    w256 = {name: 256 for name in WIDE if name != "num_blocks"}
    port_cfg = TorchConfig.from_dict(_gate_case(**w256).to_dict())
    assert wide_supported(port_cfg) and not epic_supported(port_cfg)
    w640 = {name: 640 for name in WIDE if name != "num_blocks"}
    cfg = _gate_case(**w640)
    assert wide_pallas_supported(cfg)
    port_cfg = TorchConfig.from_dict(cfg.to_dict())
    assert not wide_supported(port_cfg) and not epic_supported(port_cfg)
    cfg = _gate_case(**WIDE, max_num_particles=257)
    assert wide_pallas_supported(cfg)
    port_cfg = TorchConfig.from_dict(cfg.to_dict())
    assert not wide_supported(port_cfg)  # 256 particle slots a jet


def test_wide_kernel_gate_flag(pair):
    torch_model = pair[2]
    par = torch_model.config.parallel
    try:
        assert not torch_model.wide_kernel_enabled("cpu")  # 'auto' on the CPU
        assert torch_model.wide_kernel_enabled("cuda")
        assert not torch_model.kernel_enabled("cuda")
        par.use_pallas = True
        assert torch_model.wide_kernel_enabled("cpu")
        par.use_pallas = False
        assert not torch_model.wide_kernel_enabled("cuda")
    finally:
        par.use_pallas = "auto"


# ------------------------------------------------------------- model and loss


def jax_draws(key, batch):
    """The draws that JAX sample_bridges makes from `key`."""
    key_t, key_x, key_k = jax.random.split(key, 3)
    x1 = batch.target_continuous
    t = jax.random.uniform(key_t, (x1.shape[0],), dtype=x1.dtype)
    z = jax.random.normal(key_x, x1.shape, dtype=x1.dtype)
    u = jax.random.uniform(key_k, x1.shape[:2], dtype=jnp.float32)
    return tuple(torch.tensor(np.asarray(a)) for a in (t, z, u))


def torch_batch(batch):
    return MultimodalDatabatch(*to_torch(*(np.asarray(getattr(batch, f)) for f in (
        "source_continuous", "source_discrete", "source_mask",
        "target_continuous", "target_discrete", "target_mask"))))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_loss_fn_value_and_every_gradient_match_jax_at_wide_widths(pair, use_pallas):
    """jax.value_and_grad of the JAX loss_fn (the flax path on the CPU)
    against the port's loss_fn with the same draws; use_pallas=True takes the
    port through the wide differentiable packing and the K5 plain version."""
    jax_model, params, torch_model, batch = pair
    key = jax.random.PRNGKey(22)
    (_, metrics_ref), grads = jax.value_and_grad(jax_model.loss_fn, has_aux=True)(
        params, key, batch)
    torch_model.config.parallel.use_pallas = use_pallas
    calls = epic_train_forward_reference.calls
    try:
        torch_model.zero_grad()
        loss, metrics = torch_model.loss_fn(torch_batch(batch), draws=jax_draws(key, batch))
        loss.backward()
    finally:
        torch_model.config.parallel.use_pallas = "auto"
    assert epic_train_forward_reference.calls == calls + int(use_pallas)
    for name in metrics_ref:
        np.testing.assert_allclose(metrics[name].item(), float(metrics_ref[name]), rtol=1e-5,
                                   err_msg=name)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, grads), torch_model.config)
    seen = 0
    for name, p in torch_model.named_parameters():
        grads_close(p.grad.numpy(), ref[name].numpy(), name)
        seen += 1
    assert seen == 47
    torch_model.zero_grad()


def test_forward_kernel_takes_the_wide_wrapper(pair, monkeypatch):
    torch_model = pair[2]
    monkeypatch.setattr(torch_model.config.parallel, "use_pallas", True)
    state = HybridState(*to_torch(*random_state()))
    launches = epic_forward.launches
    calls = epic_forward_reference.calls
    with torch.no_grad():
        ref = torch_model.forward(state)
        got = torch_model.forward_kernel(state)
    assert epic_forward_reference.calls == calls + 1 and epic_forward.launches == launches
    torch.testing.assert_close(got.continuous, ref.continuous, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(got.discrete, ref.discrete, atol=ATOL, rtol=RTOL)


# -------------------------------------------------------------------- slice


def source_batch():
    _, x, k, mask = random_state(seed=7)
    return x, k, mask


@pytest.mark.parametrize("use_pallas", [False, True])
def test_wide_slice_matches_jax_forward_pallas_loop(pair, use_pallas):
    """8 timesteps = 7 steps at time_steps[1:]: JAX `forward_pallas` (the wide
    kernel, interpret mode), the Euler step and the telegraph single-jump law
    with the same uniforms, against the port's `predict`; use_pallas=True
    sends the port through the wide forward wrapper at every step."""
    jax_model, params, torch_model, _ = pair
    x, k, mask = source_batch()
    u = np.random.default_rng(8).random((STEPS - 1, 2, B, N), dtype=np.float32)

    jax_wide = copy.copy(jax_model)
    jax_wide.config = copy.deepcopy(jax_model.config)
    jax_wide.config.parallel.use_pallas = True
    assert jax_wide._wide_pallas_enabled() and not jax_wide._pallas_enabled()
    cfg_b = jax_wide.config.bridge
    time_steps = jnp.linspace(0.0, 1.0 - cfg_b.time_eps, cfg_b.num_timesteps)
    delta_t = (time_steps[-1] - time_steps[0]) / (cfg_b.num_timesteps - 1)
    forward = jax.jit(lambda p, st: jax_wide.forward_pallas(p, st, None))
    state = JaxState(time=jnp.zeros((B, 1, 1)), continuous=jnp.asarray(x),
                     discrete=jnp.asarray(k), absorbing=jnp.asarray(mask))
    for i, t in enumerate(time_steps[1:]):
        state = state.replace(time=jnp.full((B, 1, 1), t, dtype=jnp.float32))
        heads = forward(params, state)
        stepped = jax_wide.bridge_continuous.solver_step(None, state, heads, delta_t)
        lam = np.asarray(jax_bridges.telegraph_rate(
            state.time, state.discrete, heads.discrete, cfg_b.gamma, 8)) * float(delta_t)
        lam_tot = lam.sum(-1)
        jump = u[i, 0] < lam_tot * np.exp(-lam_tot)
        target = (u[i, 1][..., None] * lam_tot[..., None] >= np.cumsum(lam, -1)).sum(-1).clip(0, 7)
        k_now = np.asarray(state.discrete)[..., 0]
        k_new = (np.where(jump, target, k_now) * mask[..., 0]).astype(np.int32)
        state = stepped.replace(discrete=jnp.asarray(k_new[..., None]))
    x_ref, k_ref = np.asarray(state.continuous), np.asarray(state.discrete)

    torch_model.config.parallel.use_pallas = use_pallas
    try:
        out = torch_model.predict(MultimodalDatabatch(*to_torch(x, k, mask)),
                                  uniforms=torch.from_numpy(u))
    finally:
        torch_model.config.parallel.use_pallas = "auto"
    np.testing.assert_allclose(out.continuous.numpy(), x_ref, atol=ATOL, rtol=RTOL)
    assert (out.discrete.numpy() != k_ref).mean() <= MAX_TOKEN_MISMATCH
    assert (k_ref != k).mean() > 0.1  # the tokens did move
    assert (out.continuous.numpy()[mask[..., 0] == 0] == 0).all()


def test_wide_sampler_calls_the_wide_forward_once_a_step(pair, monkeypatch):
    """8 timesteps: 7 calls of `epic_forward_wide` at time_steps[1:] on one
    packing, and never the fused narrow sampler."""
    torch_model = pair[2]
    seen = []

    def spy(packed, t, x, k, mask):
        seen.append((id(packed), float(t[0, 0, 0])))
        return epic_forward_wide(packed, t, x, k, mask)

    def never(*args, **kwargs):
        raise AssertionError("the wide regime has no fused sampler step")

    monkeypatch.setattr(port_mbm, "epic_forward_wide", spy)
    monkeypatch.setattr(port_mbm, "fused_simulate_dynamics", never)
    monkeypatch.setattr(port_mbm, "epic_forward", never)
    monkeypatch.setattr(torch_model.config.parallel, "use_pallas", True)
    x, k, mask = source_batch()
    out = torch_model.predict(MultimodalDatabatch(*to_torch(x, k, mask)),
                              generator=torch.Generator().manual_seed(0))
    ts = np.linspace(0.0, 1.0 - 1e-4, STEPS, dtype=np.float32)
    assert len(seen) == STEPS - 1
    assert len({ident for ident, _ in seen}) == 1  # packed once, outside the loop
    np.testing.assert_allclose([t for _, t in seen], ts[1:], rtol=1e-6)
    assert torch.isfinite(out.continuous).all()


# ---------------------------------------------------------------- transplant


def test_transplant_at_six_blocks_consumes_every_leaf():
    """The scaled backbone has 6 EPiC blocks: 47 + 4·12 = 95 leaves, each
    consumed, and the module forward still matches the flax stack."""
    jax_model, params, torch_model, batch = model_pair(num_blocks=6)
    leaves = jax.tree_util.tree_leaves(params)
    state_dict = params_from_flax(jax.tree_util.tree_map(np.asarray, params), torch_model.config)
    assert len(leaves) == len(state_dict) == len(torch_model.state_dict()) == 95
    t, x, k, mask = random_state()
    ref = jax_model.forward(params, JaxState(*map(jnp.asarray, (t, x, k, mask))), batch)
    with torch.no_grad():
        got = torch_model.forward(HybridState(*to_torch(t, x, k, mask)))
    np.testing.assert_allclose(got.continuous.numpy(), np.asarray(ref.continuous),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.discrete.numpy(), np.asarray(ref.discrete),
                               atol=ATOL, rtol=RTOL)
    broken = jax.tree_util.tree_map(np.asarray, params)
    del broken["encoder"]["epic"]["epic"]["epic_layer_5"]
    with pytest.raises(KeyError):
        params_from_flax(broken, torch_model.config)
