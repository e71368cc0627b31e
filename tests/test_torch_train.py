"""The port's training half against the JAX package on the CPU: the bridges'
sampling and drift, `loss_fn` and every parameter gradient, the plain
version of the K3 backward against the interpret-mode Pallas VJP, and the
optimizer against optax.

Draws are made with jax.random exactly as the JAX functions make them and
injected into the port. Tolerances: bridges 1e-6 absolute, tokens exact;
gradients per leaf |err| ≤ 1e-4·max|ref leaf| + 1e-3·|ref|
(tests/test_ops/test_epic_pallas_vjp.py:115-123); optimizer 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_particles_tpu.models.generative import bridges as jb
from multimodal_particles_tpu.models.generative.states import HybridState as JaxState
from multimodal_particles_tpu.models.generative.states import MultiHeadOutput as JaxHeads
from multimodal_particles_tpu.ops.epic_pallas import WEIGHT_NAMES
from multimodal_particles_tpu.ops.epic_pallas import pack_mbm_encoder_params as jax_pack
from multimodal_particles_tpu.ops.epic_pallas_vjp import make_epic_train_forward
from multimodal_particles_tpu.training.trainer import (
    build_optimizer as jax_build_optimizer,
    cosine_annealing_schedule as jax_schedule,
)
from multimodal_particles_tpu_torch.config_classes import TrainingConfig
from multimodal_particles_tpu_torch.data import MultimodalDatabatch
from multimodal_particles_tpu_torch.models.architectures.epic import leaky_relu
from multimodal_particles_tpu_torch.models.architectures.utils import (
    sinusoidal_positional_encoding,
)
from multimodal_particles_tpu_torch.models.generative import bridges as tb
from multimodal_particles_tpu_torch.models.generative.states import HybridState, MultiHeadOutput
from multimodal_particles_tpu_torch.ops.epic_cuda import (
    _SELU,
    flat_views,
    forward_from_temb,
    pack_mbm_encoder_params,
)
from multimodal_particles_tpu_torch.ops.epic_vjp_cuda import (
    epic_backward,
    epic_backward_reference,
    epic_train_forward,
    epic_train_forward_reference,
    near_kink_jets,
)
from multimodal_particles_tpu_torch.training.trainer import (
    ClippedOptimizer,
    cosine_annealing_schedule,
)
from multimodal_particles_tpu_torch.utils.losses import multihead_loss, multihead_weights
from multimodal_particles_tpu_torch.utils.transplant import params_from_flax
from torch_port_helpers import B, N, model_pair, random_state, to_torch
from torch_port_helpers import jax_bridge_draws as jax_draws

torch.backends.cuda.matmul.allow_tf32 = False
BRIDGE_ATOL = 1e-6
GAMMA = 0.125


def grads_close(got: np.ndarray, ref: np.ndarray, name: str):
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got, ref, atol=1e-4 * scale, rtol=1e-3, err_msg=name)


@pytest.fixture(scope="module")
def pair():
    return model_pair()


def bridge_inputs(seed=3):
    rng = np.random.default_rng(seed)
    t = rng.random((B, 1, 1), dtype=np.float32)
    t[0] = 0.0  # the drift's clamp at the endpoint
    x0 = rng.standard_normal((B, N, 3)).astype(np.float32)
    x1 = rng.standard_normal((B, N, 3)).astype(np.float32)
    x = rng.standard_normal((B, N, 3)).astype(np.float32)
    k0 = rng.integers(0, 8, (B, N, 1)).astype(np.int32)
    k1 = rng.integers(0, 8, (B, N, 1)).astype(np.int32)
    return t, x0, x1, x, k0, k1


# ------------------------------------------------------------------ bridges


@pytest.mark.parametrize("kind", ["linear", "schrodinger"])
def test_continuous_bridge_sample_and_drift_match_jax(kind):
    t, x0, x1, x, _, _ = bridge_inputs()
    key = jax.random.PRNGKey(11)
    z = np.asarray(jax.random.normal(key, x0.shape, dtype=jnp.float32))
    jax_sample = {"linear": jb.linear_uniform_sample, "schrodinger": jb.schrodinger_sample}[kind]
    jax_drift = {"linear": jb.linear_uniform_drift, "schrodinger": jb.schrodinger_drift}[kind]
    port_sample = {"linear": tb.linear_uniform_sample, "schrodinger": tb.schrodinger_sample}[kind]
    port_drift = {"linear": tb.linear_uniform_drift, "schrodinger": tb.schrodinger_drift}[kind]
    sigma = 0.3
    ref = np.asarray(jax_sample(key, *map(jnp.asarray, (t, x0, x1)), sigma))
    got = port_sample(*to_torch(t, x0, x1), sigma, torch.tensor(z)).numpy()
    np.testing.assert_allclose(got, ref, atol=BRIDGE_ATOL, rtol=0)
    ref = np.asarray(jax_drift(*map(jnp.asarray, (t, x, x0, x1))))
    got = port_drift(*to_torch(t, x, x0, x1)).numpy()
    assert np.isfinite(got).all()
    # the Schrödinger drift reaches 1e6 at the clamped endpoint: relative there
    np.testing.assert_allclose(got, ref, atol=BRIDGE_ATOL, rtol=1e-6)


def test_schrodinger_solver_step_matches_jax():
    t, x0, _, _, _, _ = bridge_inputs()
    _, drift, _, mask = random_state(seed=4)
    key = jax.random.PRNGKey(12)
    dw = np.asarray(jax.random.normal(key, x0.shape, dtype=jnp.float32))
    sigma, dt = 0.2, 0.01
    ref = jb.SchrodingerBridge(sigma).solver_step(
        key, JaxState(time=jnp.asarray(t), continuous=jnp.asarray(x0)),
        JaxHeads(continuous=jnp.asarray(drift), absorbing=jnp.asarray(mask)), dt)
    got = tb.SchrodingerBridge(sigma).solver_step(
        HybridState(*to_torch(t, x0)),
        MultiHeadOutput(continuous=torch.from_numpy(drift), absorbing=torch.from_numpy(mask)),
        dt, torch.tensor(dw))
    np.testing.assert_allclose(got.continuous.numpy(), np.asarray(ref.continuous),
                               atol=BRIDGE_ATOL, rtol=0)


def test_telegraph_sample_matches_jax():
    t, _, _, _, k0, k1 = bridge_inputs()
    key = jax.random.PRNGKey(13)
    u = np.asarray(jax.random.uniform(key, (B, N), dtype=jnp.float32))
    ref = np.asarray(jb.telegraph_sample(key, jnp.asarray(t), jnp.asarray(k0), jnp.asarray(k1),
                                         GAMMA, 8))
    got = tb.telegraph_sample(*to_torch(t, k0, k1), GAMMA, 8, torch.tensor(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref != k0).mean() > 0.05 and (ref != k1).mean() > 0.05  # draws both ways


def test_telegraph_probabilities_match_jax():
    t, _, _, _, k0, k1 = bridge_inputs()
    ref = np.asarray(jb.telegraph_transition_probability(
        jnp.asarray(t), jnp.asarray(k0), jnp.asarray(k1), GAMMA, 8))
    got = tb.telegraph_transition_probability(*to_torch(t, k0, k1), GAMMA, 8).numpy()
    np.testing.assert_allclose(got, ref, atol=BRIDGE_ATOL, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    ref = np.asarray(jb.telegraph_conditional_probability(0.2, jnp.asarray(t), jnp.asarray(k0),
                                                          jnp.asarray(k1), GAMMA, 8))
    got = tb.telegraph_conditional_probability(0.2, *to_torch(t, k0, k1), GAMMA, 8).numpy()
    np.testing.assert_allclose(got, ref, atol=BRIDGE_ATOL, rtol=0)


def test_telegraph_sample_follows_the_golden_posterior():
    """The fused draw's law is the normalized posterior bridge."""
    S, n = 8, 200_000
    t = torch.full((n, 1, 1), 0.4)
    k0 = torch.full((n, 1, 1), 2, dtype=torch.int32)
    k1 = torch.full((n, 1, 1), 5, dtype=torch.int32)
    u = torch.rand((n, 1), generator=torch.Generator().manual_seed(0))
    draws = tb.telegraph_sample(t, k0, k1, GAMMA, S, u)[:, 0, 0]
    freq = torch.bincount(draws.long(), minlength=S).double() / n
    golden = tb.telegraph_transition_probability(t[:1], k0[:1], k1[:1], GAMMA, S)[0, 0].double()
    torch.testing.assert_close(freq, golden, atol=4e-3, rtol=0)


# ------------------------------------------------------------ model and loss


def torch_batch(batch):
    return MultimodalDatabatch(*to_torch(*(np.asarray(getattr(batch, f)) for f in (
        "source_continuous", "source_discrete", "source_mask",
        "target_continuous", "target_discrete", "target_mask"))))


def test_sample_bridges_matches_jax(pair):
    jax_model, _, torch_model, batch = pair
    key = jax.random.PRNGKey(21)
    ref = jax_model.sample_bridges(key, batch)
    got = torch_model.sample_bridges(torch_batch(batch), draws=jax_draws(key, batch))
    np.testing.assert_allclose(got.time.numpy(), np.asarray(ref.time), atol=BRIDGE_ATOL, rtol=0)
    np.testing.assert_allclose(got.continuous.numpy(), np.asarray(ref.continuous),
                               atol=BRIDGE_ATOL, rtol=0)
    np.testing.assert_array_equal(got.discrete.numpy(), np.asarray(ref.discrete))
    np.testing.assert_array_equal(got.absorbing.numpy(), np.asarray(ref.absorbing))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_loss_fn_value_and_every_gradient_match_jax(pair, use_pallas):
    """jax.value_and_grad of the JAX loss_fn (the flax path on the CPU)
    against the port's loss_fn with the same draws and .backward();
    use_pallas=True takes the port through forward_train's differentiable
    packing and the K3 plain version."""
    jax_model, params, torch_model, batch = pair
    key = jax.random.PRNGKey(22)
    (loss_ref, metrics_ref), grads = jax.value_and_grad(jax_model.loss_fn, has_aux=True)(
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
    assert set(metrics) == set(metrics_ref)
    for name in metrics:
        np.testing.assert_allclose(metrics[name].item(), float(metrics_ref[name]), rtol=1e-5,
                                   err_msg=name)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, grads), torch_model.config)
    seen = 0
    for name, p in torch_model.named_parameters():
        grads_close(p.grad.numpy(), ref[name].numpy(), name)
        seen += 1
    assert seen == 47


def test_losses_mask_and_denominator(pair):
    """Continuous MSE is summed over features and divided by max(Σmask, 1),
    not 3·Σmask; an all-masked batch gives 0, not NaN."""
    torch_model = pair[2]
    mask = torch.zeros((2, 4, 1))
    mask[0, :3] = 1.0
    state = HybridState(time=torch.full((2, 1, 1), 0.5), continuous=torch.zeros((2, 4, 3)),
                        discrete=torch.zeros((2, 4, 1), dtype=torch.long), absorbing=mask)
    batch = MultimodalDatabatch(torch.zeros((2, 4, 3)), None, None, torch.ones((2, 4, 3)),
                                torch.zeros((2, 4, 1), dtype=torch.long), mask)
    heads = MultiHeadOutput(torch.zeros((2, 4, 3)), torch.zeros((2, 4, 8)), mask)
    assert torch_model.loss_continuous(heads, state, batch).item() == pytest.approx(3.0)
    assert torch_model.loss_discrete(heads, state, batch).item() == pytest.approx(np.log(8))
    empty = state.replace(absorbing=torch.zeros_like(mask))
    assert torch_model.loss_continuous(heads, empty, batch).item() == 0.0


def test_multihead_loss_and_weights():
    w = torch.tensor([0.3, -0.2])
    losses = [torch.tensor(2.0), torch.tensor(5.0)]
    combined, per_head = multihead_loss(losses, w)
    expect = np.exp(-0.3) * 2 + 0.3 + np.exp(0.2) * 5 - 0.2
    assert combined.item() == pytest.approx(expect, rel=1e-6)
    assert per_head == losses
    assert multihead_loss(losses, w, mode="fixed")[0].item() == pytest.approx(0.6 - 1.0)
    torch.testing.assert_close(multihead_weights(w), torch.exp(-w))
    with pytest.raises(ValueError):
        multihead_loss(losses, w, mode="other")


# ----------------------------------------------- K3 plain version vs Pallas


@pytest.mark.parametrize("encoder", [
    {},  # config-berlin widths
    {"dim_hidden_local": 32, "dim_hidden_glob": 32, "num_blocks": 3},
    {"skip_connection": False},
    {"add_discrete_head": False},
], ids=["berlin", "hidden32x3", "no_skip", "no_head"])
def test_backward_plain_version_matches_pallas_vjp(encoder):
    jax_model, params, torch_model, _ = model_pair(**encoder)
    cfg = jax_model.config
    fused = make_epic_train_forward(
        num_blocks=cfg.encoder.num_blocks, use_skip=cfg.encoder.skip_connection,
        add_discrete_head=cfg.encoder.add_discrete_head, dim_c=3, vocab=8,
        hidden=cfg.encoder.dim_hidden_local, dim_emb_time=cfg.encoder.dim_emb_time,
        interpret=True,
    )
    t, x, k, mask = random_state()  # jet 0 is empty
    g = np.random.default_rng(9).standard_normal((B, N, 11)).astype(np.float32)
    packed_jax = jax_pack(params["encoder"], cfg.encoder.num_blocks)
    out_ref, vjp = jax.vjp(lambda p: fused(p, *map(jnp.asarray, (t, x, k, mask))), packed_jax)
    (cot,) = vjp(jnp.asarray(g))
    ref = dict(zip(WEIGHT_NAMES, (np.asarray(c) for c in cot)))

    packed = pack_mbm_encoder_params(torch_model.encoder, torch_model.config)
    tt, tx, tk, tm = to_torch(t, x, k, mask)
    out = epic_train_forward_reference(packed, tt, tx, tk, tm)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref), atol=1e-5, rtol=1e-4)
    d_flat = epic_backward(packed, tt, tx, tk, tm, torch.from_numpy(g))  # CPU: plain version
    got = flat_views(d_flat, packed.dims)
    assert torch.isfinite(d_flat).all()
    for name, value in got.items():
        base, _, layer = name.rpartition("_")
        if layer.isdigit():  # w_fg1_0 ↔ the stacked w_fg1[0]
            r = ref[base][int(layer)]
        else:
            r = ref[name]
        if name == "table":
            r = r.T  # JAX packs the table (E, V), the port (V, E)
        grads_close(value.numpy(), r.reshape(value.shape), name)


def test_backward_reference_matches_autograd_of_train_forward(pair):
    """epic_backward's plain version is the VJP of epic_train_forward's."""
    torch_model = pair[2]
    t, x, k, mask = to_torch(*random_state())
    g = torch.randn((B, N, 11), generator=torch.Generator().manual_seed(3))
    packed = pack_mbm_encoder_params(torch_model.encoder, torch_model.config, differentiable=True)
    flat = packed.flat
    flat.retain_grad()
    (epic_train_forward(packed, t, x, k, mask) * g).sum().backward()
    calls = epic_backward_reference.calls
    d_flat = epic_backward(packed, t, x, k, mask, g)
    assert epic_backward_reference.calls == calls + 1
    torch.testing.assert_close(d_flat, flat.grad, atol=1e-6, rtol=1e-5)
    torch_model.zero_grad()


def test_gradients_flow_through_weight_norm(pair):
    """d(loss)/d(v, g, bias, table, heads) through the differentiable packing
    is finite and nonzero for every encoder leaf."""
    torch_model = pair[2]
    t, x, k, mask = to_torch(*random_state())
    torch_model.zero_grad()
    packed = pack_mbm_encoder_params(torch_model.encoder, torch_model.config, differentiable=True)
    (epic_train_forward(packed, t, x, k, mask) ** 2).sum().backward()
    for name, p in torch_model.encoder.named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name
        assert p.grad.abs().sum() > 0, name
    torch_model.zero_grad()


def test_near_kink_jets_flags_an_input_at_a_kink(pair):
    """A SELU input moved to within rounding of 0 flags its jet; a batch
    without such inputs flags none."""
    torch_model = pair[2]
    t, x, k, mask = to_torch(*random_state())
    packed = pack_mbm_encoder_params(torch_model.encoder, torch_model.config)
    assert near_kink_jets(packed, t, x, k, mask).tolist() == [False] * B
    preacts = []
    forward_from_temb(packed, sinusoidal_positional_encoding(t.reshape(B), 16), x, k, mask,
                      preacts)
    z_h0 = dict(preacts)["z_h0"]
    with torch.no_grad():  # particle (3, 2)'s head input 0 lands 1e-7 above 0
        packed.tensors["b_h0"][0] -= z_h0[3, 2, 0] - 1e-7
    near = near_kink_jets(packed, t, x, k, mask)
    assert near[3]


def test_near_kink_window_is_each_jets_own(pair):
    """The window comes from each jet's own rounding, not from the batch: a
    jet with inputs a million times larger changes no other jet's flag."""
    torch_model = pair[2]
    t, x, k, mask = to_torch(*random_state())
    packed = pack_mbm_encoder_params(torch_model.encoder, torch_model.config)
    near = near_kink_jets(packed, t, x, k, mask)
    loud = x.clone()
    loud[-1] *= 1e6  # jet 0 is empty; the last is not
    assert mask[-1].sum() > 0
    assert near_kink_jets(packed, t, loud, k, mask)[:-1].tolist() == near[:-1].tolist()


def test_sampling_packing_stays_detached(pair):
    torch_model = pair[2]
    packed = pack_mbm_encoder_params(torch_model.encoder, torch_model.config)
    assert not packed.flat.requires_grad and packed.flat.grad_fn is None


def test_leaky_and_selu_derivatives_at_zero_follow_jax():
    z = torch.tensor([-1.0, 0.0, 1.0], requires_grad=True)
    leaky_relu(z).sum().backward()
    torch.testing.assert_close(z.grad, torch.tensor([0.01, 1.0, 1.0]))
    z.grad = None
    _SELU.apply(z).sum().backward()
    scale, alpha = _SELU.SCALE, _SELU.ALPHA
    expect = torch.tensor([scale * alpha * np.exp(-1.0), scale, scale], dtype=torch.float32)
    torch.testing.assert_close(z.grad, expect)


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("step", [0, 10 * 50, 10 * 100, 10 * 150])
def test_cosine_schedule_matches_jax(step):
    ours = cosine_annealing_schedule(lr=1e-3, eta_min=1e-5, t_max=100, steps_per_epoch=10)
    ref = jax_schedule(lr=1e-3, eta_min=1e-5, t_max=100, steps_per_epoch=10)
    assert ours(step) == pytest.approx(float(ref(step)), abs=1e-9)


@pytest.mark.parametrize("grad_scale", [10.0, 0.01], ids=["clipped", "unclipped"])
def test_optimizer_steps_match_optax(grad_scale):
    """Two updates of clip_by_global_norm + AdamW(schedule) from the same
    params and gradients, with the schedule moving between them."""
    train = TrainingConfig()
    train.scheduler_params = {"T_max": 3, "eta_min": 5e-5}
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 3), "b": (4,), "loss_weights": (2,)}
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: (grad_scale * rng.standard_normal(s)).astype(np.float32)
              for n, s in shapes.items()} for _ in range(2)]

    tx = jax_build_optimizer(train, steps_per_epoch=1)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {n: torch.nn.Parameter(torch.from_numpy(v.copy())) for n, v in params.items()}
    opt = ClippedOptimizer(train, 1, tp.values())
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for n, p in tp.items():
            p.grad = torch.from_numpy(g[n].copy())
        opt.step()
    assert opt.count == 2
    for n in params:
        np.testing.assert_allclose(tp[n].detach().numpy(), np.asarray(jp[n]), atol=1e-6, rtol=0,
                                   err_msg=n)
    norm = np.sqrt(sum((v ** 2).sum() for v in grads[0].values()))
    assert (norm > train.gradient_clip_val) == (grad_scale > 1)
