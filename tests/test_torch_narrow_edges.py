"""K1, K2 and K3 at every narrow hidden width up to 64 and on jets of up to
512 slots, the port against the JAX package on the CPU.

The narrow kernels are instances at hidden 16, 32, 48 and 64; the packings
zero-pad any other width up to 64 to the next (`epic_cuda.pad_hidden`), and
on the card a jet of 257 to 512 slots is a cluster of two row blocks
(ops/csrc/narrow_tc.cuh). On the CPU the wrappers take their plain versions
on the padded packing, so these tests hold the gates, the padding and the
plain versions, and the three families' kernel paths built on them, against
the JAX package, whose narrow kernels take any hidden width up to 64 and any
N, in interpret mode:

  * the port's gates against JAX's (`mbm_pallas_supported`, the absorbing
    and transdimensional trunk tiers) over hidden {1, 8, 20, 24, 48, 64, 65,
    72} × N {109, 128, 256, 257, 384, 512, 513}: equal up to 512 slots (the
    port also takes N that is not a multiple of 128), and past 512 the port
    refuses what JAX's trunk tiers take;
  * the plain K1, K2 and K3 on the padded packing against the forward and
    the VJP of `make_epic_train_forward` and the fused sampler step at hidden
    20 and 48 (N = 128) and at hidden 16 and 24 with N = 384;
  * MBM's loss and every parameter's gradient with `use_pallas=True` against
    `jax.value_and_grad` at hidden 24 and N = 384;
  * the absorbing `forward_sampling` and the transdimensional
    `forward_kernel` on the narrow trunk at hidden 24, the hidden output at
    its real width.

2 EPiC blocks, 2 jets (3 for the families), inputs from a numpy seed, TF32 off. Tolerances as
tests/test_torch_sampler.py and tests/test_torch_train.py (forward atol 1e-5
/ rtol 1e-4; tokens differing on at most 1% of the slots; gradients per leaf
|err| ≤ 1e-4·max|ref leaf| + 1e-3·|ref|) and tests/test_torch_wide_long.py
(the families' outputs 2e-4 and 5e-4 of their scale). The forward outputs
are held per particle, |err| ≤ 1e-5 + 1e-4·max|ref| over the particle's
row, as chip_smoke.py holds K1 at hidden 64: at widths 48 and 64 the
outputs reach ~20 and a small one is the difference of such terms, which two
float32 sums in other orders part by ~1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_particles_tpu.config_classes import MultimodalBridgeMatchingConfig
from multimodal_particles_tpu.data.particle_clouds.jets_dataloader import JetsDataloaderModule
from multimodal_particles_tpu.models.generative.multimodal_bridge_matching import (
    MultiModalBridgeMatching,
)
from multimodal_particles_tpu.models.generative.states import AbsorbingBridgeState as JaxState
from multimodal_particles_tpu.models.generative.transdimensional import structure as jax_structure
from multimodal_particles_tpu.ops.epic_pallas import (
    WEIGHT_NAMES,
    epic_pattern_supported,
    mbm_pallas_supported,
    pack_mbm_encoder_params as jax_pack,
)
from multimodal_particles_tpu.ops.epic_pallas_vjp import make_epic_train_forward
from multimodal_particles_tpu.ops.sampler_pallas import make_fused_sampler_step
from multimodal_particles_tpu_torch.config_classes import (
    MultimodalBridgeMatchingConfig as TorchConfig,
)
from multimodal_particles_tpu_torch.data import MultimodalDatabatch
from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (
    MultiModalBridgeMatching as TorchMBM,
)
from multimodal_particles_tpu_torch.models.generative.states import AbsorbingBridgeState
from multimodal_particles_tpu_torch.models.generative.transdimensional import structure
from multimodal_particles_tpu_torch.ops import epic_cuda, gsdm_stack_cuda, survival_cuda
from multimodal_particles_tpu_torch.ops.epic_cuda import (
    HIDDEN_WIDTHS,
    MAX_PARTICLES,
    epic_forward,
    epic_supported,
    flat_views,
    hidden_pad_index,
    pack_mbm_encoder_params,
    padded_dims,
)
from multimodal_particles_tpu_torch.ops.epic_vjp_cuda import (
    epic_backward,
    epic_backward_reference,
    epic_train_forward_reference,
)
from multimodal_particles_tpu_torch.ops.sampler_cuda import sampler_step
from multimodal_particles_tpu_torch.utils.transplant import params_from_flax
from torch_port_helpers import (
    CONFIG_PATH,
    absorbing_pair,
    drawn_params,
    jax_config,
    noisy_params,
    to_torch,
    transdim_pair,
)

torch.backends.cuda.matmul.allow_tf32 = False
ATOL, RTOL = 1e-5, 1e-4
MAX_TOKEN_MISMATCH = 0.01
B = 2
GATE_HIDDEN = (1, 8, 20, 24, 48, 64, 65, 72)
GATE_N = (109, 128, 256, 257, 384, 512, 513)


def grads_close(got: np.ndarray, ref: np.ndarray, name: str):
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got, ref, atol=1e-4 * scale, rtol=1e-3, err_msg=name)


def rows_close(got, ref, name=""):
    """|err| ≤ ATOL + RTOL·max|ref| over each particle's last axis."""
    got, ref = np.asarray(got), np.asarray(ref)
    bound = ATOL + RTOL * np.abs(ref).max(axis=-1, keepdims=True)
    worst = (np.abs(got - ref) / bound).max()
    assert worst <= 1.0, (name, worst)


def scale_close(got, ref, tol, name=""):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * max(np.abs(ref).max(), 1.0),
                               err_msg=name)


def edge_state(seed, n, b=B):
    """t, x, k, mask as numpy: random non-prefix masks (60% of the slots
    alive); at n > 256 jet 0 has one live particle, at slot n − 3 (in the
    second row block), and jet 1's live slots all lie past slot 256."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((b, n, 1)) < 0.6).astype(np.float32)
    if n > 256:
        mask[0] = 0.0
        mask[0, n - 3] = 1.0
        mask[1, :256] = 0.0
    x = (rng.standard_normal((b, n, 3)) * mask).astype(np.float32)
    k = (rng.integers(0, 8, (b, n, 1)) * mask).astype(np.int32)
    t = rng.uniform(0.05, 0.95, (b, 1, 1)).astype(np.float32)
    return t, x, k, mask


def mbm_pair(hidden, n, seed=3):
    """(jax_model, jax_params, torch_model, jax_batch) of MBM at the test
    config with local hidden width `hidden`, B jets of n slots:
    `drawn_params` plus seeded noise, transplanted."""
    cfg = jax_config(dim_hidden_local=hidden)
    cfg.data.batch_size, cfg.data.max_num_particles = B, n
    batch = jax.tree_util.tree_map(jnp.asarray, JetsDataloaderModule.random_databatch(cfg))
    jax_model = MultiModalBridgeMatching(cfg)
    params = noisy_params(drawn_params(jax_model.init, jax.random.PRNGKey(seed), batch, seed=seed),
                          seed)
    torch_cfg = TorchConfig.from_dict(cfg.to_dict())
    model = TorchMBM(torch_cfg)
    model.load_state_dict(params_from_flax(params, torch_cfg))
    return jax_model, jax.tree_util.tree_map(jnp.asarray, params), model, batch


@pytest.fixture(scope="module", params=[(20, 128), (48, 128), (16, 384), (24, 384)],
                ids=lambda p: f"hidden{p[0]}-n{p[1]}")
def edge(request):
    return (*mbm_pair(*request.param), request.param[1])


# -------------------------------------------------------------------- gates


@pytest.mark.parametrize("hidden", GATE_HIDDEN)
def test_narrow_gates_equal_jax(hidden):
    """Over N in GATE_N: MBM's gate (`epic_supported`, which `kernel_enabled`
    asks) says what `mbm_pallas_supported` says wherever N is a multiple of
    128 up to 512, and takes every other N up to 512 at hidden ≤ 64; the
    absorbing trunk tier (`epic_supported`, the Embedding input) and the
    transdimensional one (`allow_linear_discrete`, the Linear input) say what
    JAX's narrow trunk tiers say up to 512 slots, and refuse N = 513, which
    JAX takes."""
    cfg = MultimodalBridgeMatchingConfig.from_yaml(CONFIG_PATH)
    cfg.encoder.dim_hidden_local = hidden
    for n in GATE_N:
        cfg.data.max_num_particles = n
        port = TorchConfig.from_dict(cfg.to_dict())
        narrow = 1 <= hidden <= 64
        ours = epic_supported(port)
        assert mbm_pallas_supported(cfg) == (narrow and n % 128 == 0), n
        assert ours == (narrow and n <= MAX_PARTICLES), n
        if n % 128 == 0 and n <= MAX_PARTICLES:
            assert ours == mbm_pallas_supported(cfg), n
        assert TorchMBM(port).kernel_enabled("cuda") == ours
        for linear in (False, True):
            cfg.encoder.embedding_features_discrete = port.encoder.embedding_features_discrete = (
                "Linear" if linear else "Embedding")
            # absorbing_flows.py:208-212 and transdimensional_model.py:324-328
            jax_trunk = epic_pattern_supported(cfg, allow_linear_discrete=linear) and hidden <= 64
            trunk = epic_supported(port, allow_linear_discrete=linear)
            assert trunk == (jax_trunk and n <= MAX_PARTICLES), (n, linear)
        cfg.encoder.embedding_features_discrete = "Embedding"


def test_padding_is_a_gather_of_the_model_weights():
    """At hidden 20 the packing is the hidden-32 layout: every float is a
    float of the unpadded packing or a zero, each float of the unpadded
    packing appears once, and the pads sit where the 32-wide layers' units
    20-31 are."""
    jax_model, _, model, _ = mbm_pair(20, 16)
    packed = pack_mbm_encoder_params(model.encoder, model.config)
    d = packed.dims
    assert (d.hidden, d.model_hidden, d.hidden_local) == (32, 20, 20)
    assert d == padded_dims(epic_cuda.EpicDims.from_config(model.config))
    index = hidden_pad_index(epic_cuda.EpicDims.from_config(model.config))
    n = int(index.max())  # the zero's slot
    real = index[index < n]
    assert torch.equal(real.sort().values, torch.arange(n))
    views = flat_views(packed.flat, d)
    assert (views["w_g0"][20:] == 0).all() and (views["w_g0"][:, 20:32] == 0).all()
    assert (views["w_g0"][:, 52:64] == 0).all() and (views["b_l0"][20:] == 0).all()
    assert (views["w_out_d"][:, 20:] == 0).all() and (views["w_fl1_1"][:, 20:32] == 0).all()
    assert packed.flat.numel() == index.numel()
    assert HIDDEN_WIDTHS == (16, 32, 48, 64)


# ------------------------------------------------- the plain K1, K2 and K3


def static_kwargs(cfg, hidden):
    return dict(num_blocks=cfg.encoder.num_blocks, use_skip=cfg.encoder.skip_connection,
                add_discrete_head=cfg.encoder.add_discrete_head, dim_c=3, vocab=8,
                hidden=hidden, dim_emb_time=cfg.encoder.dim_emb_time, interpret=True)


def unpadded(d_flat, d):
    """A gradient in the padded layout → the model's layout (the backward of
    the padding's gather), and its largest |value| on the pads."""
    d_real = epic_cuda.EpicDims(**{**d.__dict__, "hidden": d.hidden_local, "model_hidden": 0})
    if d.model_hidden == 0:
        return d_flat, d_real, 0.0
    index = hidden_pad_index(d_real)
    n = int(index.max())
    out = torch.zeros(n + 1).index_add_(0, index, d_flat)
    return out[:n], d_real, float(d_flat[index == n].abs().max())


def test_plain_kernels_match_pallas(edge):
    """On the padded packing, the plain K1 (its hidden output at the
    model's width), K2 at three times and K3 against the forward and the VJP
    of `make_epic_train_forward` (whose forward kernel runs K1's
    `_forward_acts`) and the fused sampler step, all in interpret mode; the
    wrappers take the plain versions and launch nothing; K3's gradient on the
    pads is 0."""
    jax_model, params, model, _, n = edge
    cfg, hidden = jax_model.config, model.config.encoder.dim_hidden_local
    t, x, k, mask = edge_state(11 + n, n)
    packed_jax = jax.jit(jax_pack, static_argnums=1)(params["encoder"], cfg.encoder.num_blocks)
    inputs_j = tuple(map(jnp.asarray, (t, x, k, mask)))
    fused = make_epic_train_forward(**static_kwargs(cfg, hidden))
    rows, times = B * n, (0.0101, 0.5, 1.0 - 1e-4)
    step = make_fused_sampler_step(
        num_blocks=cfg.encoder.num_blocks, use_skip=cfg.encoder.skip_connection,
        add_discrete_head=cfg.encoder.add_discrete_head, dim_c=3, vocab=8,
        gamma=cfg.bridge.gamma, dim_emb_time=cfg.encoder.dim_emb_time, interpret=True)(n, B)
    g = np.random.default_rng(n + 1).standard_normal((B, n, 11)).astype(np.float32)
    u = np.random.default_rng(n).random((2, B, n), dtype=np.float32)

    @jax.jit  # one program: its interpret-mode kernels compile once
    def kernels(p, cot, ts):
        out, vjp = jax.vjp(lambda q: fused(q, *inputs_j), p)
        lane = (inputs_j[1].reshape(rows, 3).T, inputs_j[2].reshape(1, rows),
                inputs_j[3].reshape(1, rows), jnp.asarray(u.reshape(2, rows)))
        return out, vjp(cot)[0], jax.lax.map(lambda st: step(p, *lane, st, 0.01), ts)

    # the forward kernel of the JAX training op runs K1's `_forward_acts`
    out_ref, cot, (x_steps, k_steps) = kernels(packed_jax, jnp.asarray(g),
                                                jnp.asarray(times, jnp.float32))
    packed = epic_cuda.with_narrow_buffer(pack_mbm_encoder_params(model.encoder, model.config))
    assert packed.dims.hidden in HIDDEN_WIDTHS and packed.dims.hidden_local == hidden
    tt, tx, tk, tm = to_torch(t, x, k, mask)
    launches = epic_forward.launches, sampler_step.launches, epic_backward.launches
    with torch.no_grad():
        out, hid = epic_forward(packed, tt, tx, tk, tm, output_hidden_local=True)
    assert hid.shape == (B, n, hidden) and hid.is_contiguous()
    rows_close(out.numpy(), out_ref, "out")

    for step_t, x_j, k_j in zip(times, x_steps, k_steps):
        with torch.no_grad():
            x_new, k_new = sampler_step(packed, tx, tk, tm, torch.from_numpy(u), step_t, 0.01,
                                        gamma=model.config.bridge.gamma)
        rows_close(x_new.numpy(), np.asarray(x_j).T.reshape(B, n, 3), f"x' at t={step_t}")
        real = mask[..., 0] > 0
        mismatch = (k_new.numpy()[..., 0] != np.asarray(k_j).reshape(B, n))[real].mean()
        assert mismatch <= MAX_TOKEN_MISMATCH, step_t

    ref = dict(zip(WEIGHT_NAMES, (np.asarray(c) for c in cot)))
    calls = epic_backward_reference.calls
    rows_close(epic_train_forward_reference(packed, tt, tx, tk, tm).detach().numpy(), out_ref,
               "train forward")
    d_flat = epic_backward(packed, tt, tx, tk, tm, torch.from_numpy(g))  # CPU: plain
    assert epic_backward_reference.calls == calls + 1
    assert (epic_forward.launches, sampler_step.launches, epic_backward.launches) == launches
    assert torch.isfinite(d_flat).all()
    d_real, dims, on_pads = unpadded(d_flat, packed.dims)
    assert on_pads == 0.0
    for name, value in flat_views(d_real, dims).items():
        base, _, layer = name.rpartition("_")
        r = ref[base][int(layer)] if layer.isdigit() else ref[name]
        if name == "table":
            r = r.T  # JAX packs the table (E, V), the port (V, E)
        grads_close(value.numpy(), r.reshape(value.shape), name)


# ------------------------------------------------------------------- MBM


def jax_draws(key, batch):
    """The draws that JAX sample_bridges makes from `key`."""
    key_t, key_x, key_k = jax.random.split(key, 3)
    x1 = batch.target_continuous
    t = jax.random.uniform(key_t, (x1.shape[0],), dtype=x1.dtype)
    z = jax.random.normal(key_x, x1.shape, dtype=x1.dtype)
    u = jax.random.uniform(key_k, x1.shape[:2], dtype=jnp.float32)
    return tuple(torch.tensor(np.asarray(a)) for a in (t, z, u))


def test_mbm_loss_and_every_gradient_with_the_kernel_path_match_jax():
    """MBM's narrow gate takes hidden 24 at N = 384 (JAX's too: N % 128 = 0,
    hidden ≤ 64); `loss_fn` with `use_pallas=True` goes through the
    differentiable packing, zero-padded to 32, and K3's plain version (CPU),
    and its value and every parameter's gradient match `jax.value_and_grad`
    of the JAX loss with the same draws."""
    jax_model, params, model, batch = mbm_pair(24, 384, seed=5)
    assert mbm_pallas_supported(jax_model.config) and model.kernel_enabled("cuda")
    key = jax.random.PRNGKey(22)
    (_, metrics_ref), grads = jax.jit(jax.value_and_grad(jax_model.loss_fn, has_aux=True))(
        params, key, batch)
    port_batch = MultimodalDatabatch(*to_torch(*(np.asarray(getattr(batch, f)) for f in (
        "source_continuous", "source_discrete", "source_mask",
        "target_continuous", "target_discrete", "target_mask"))))
    model.config.parallel.use_pallas = True
    calls = epic_train_forward_reference.calls
    try:
        model.zero_grad()
        loss, metrics = model.loss_fn(port_batch, draws=jax_draws(key, batch))
        loss.backward()
    finally:
        model.config.parallel.use_pallas = "auto"
    assert epic_train_forward_reference.calls == calls + 1
    for name in metrics_ref:
        np.testing.assert_allclose(metrics[name].item(), float(metrics_ref[name]), rtol=1e-5,
                                   err_msg=name)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, grads), model.config)
    seen = 0
    for name, p in model.named_parameters():
        grads_close(p.grad.numpy(), ref[name].numpy(), name)
        seen += 1
    assert seen == 47
    model.zero_grad()


# ------------------------------------------------------- the other families


def test_absorbing_forward_sampling_takes_the_narrow_trunk_at_hidden_24():
    """At hidden 24 the absorbing trunk packs for K1, zero-padded to 32 (the
    module trunk before); `forward_sampling` (K1 with the hidden output at
    its real width and the 56-wide head, then K6, their plain versions on the
    CPU) against JAX's with `use_pallas=True` in interpret mode, each head
    within 2e-4 of its scale."""
    n = 40
    jax_model, params, model, batch = absorbing_pair(
        seed=5, n=n, b=3, drawn_init=True,
        sections={"encoder": {"dim_hidden_local": 24}, "generator": {"n_attn_blocks": 1}})
    t, x, k, mask = edge_state(3, n, 3)
    x = (np.asarray(batch.source_continuous) * mask).astype(np.float32)
    mask = mask.astype(np.int32)
    trunk, head = model.pack_for_kernel()
    assert trunk is not None and trunk.layout == "narrow"
    assert (trunk.dims.hidden, trunk.dims.hidden_local, trunk.dims.head_hidden) == (32, 24, 56)
    assert head.dim_hidden == 24
    state_j = JaxState(jnp.asarray(t), jnp.asarray(x), jnp.asarray(k), jnp.asarray(mask))
    state = AbsorbingBridgeState(*to_torch(t, x, k, mask.astype(np.int64)))
    jax_model.config.parallel.use_pallas = model.config.parallel.use_pallas = True
    ref = jax.jit(jax_model.forward_sampling)(params, state_j, batch)
    with torch.no_grad():
        _, last = epic_forward(trunk, state.time, state.continuous, state.discrete,
                               state.mask_t.float(), output_hidden_local=True)
        last_ref = model.generator.trunk_and_heads(state)[2]
    assert last.shape == last_ref.shape == (3, n, 24)
    rows_close(last.numpy(), last_ref.numpy(), "hidden output")
    calls = epic_cuda.epic_forward_reference.calls, survival_cuda.survival_head_reference.calls
    got = model.forward_sampling(state)
    assert epic_cuda.epic_forward_reference.calls == calls[0] + 1
    assert survival_cuda.survival_head_reference.calls == calls[1] + 1
    assert epic_forward.launches == survival_cuda.survival_head.launches == 0
    for name in ("continuous", "discrete", "absorbing"):
        scale_close(getattr(got, name).numpy(), getattr(ref, name), 2e-4, name)


def test_transdim_forward_kernel_takes_the_narrow_trunk_at_hidden_24():
    """At hidden 24 the transdimensional trunk takes K1 with the folded
    input, zero-padded to 32 (`kernel_refusal` refused the fused path
    before); `forward_kernel` (K1 with the hidden output at its real width,
    K7 twice, their plain versions on the CPU) against `_network_fused` in
    interpret mode, 5e-4 of each output's scale."""
    n = 16
    jax_model, params, model, batch = transdim_pair(
        seed=6, n=n, b=3, drawn_init=True,
        sections={"encoder": {"dim_hidden_local": 24, "n_attn_blocks": 1}})
    assert model.kernel_refusal() is None and model._trunk_layout() == "narrow"
    rng = np.random.default_rng(1)
    live = (np.arange(n)[None, :] < batch[0][:, None])[..., None]
    noisy = [batch[0], batch[1] * live, (batch[2] + 0.3 * rng.standard_normal(
        batch[2].shape).astype(np.float32)) * live]
    ts = rng.uniform(0.05, 1.0, 3).astype(np.float32)
    nearest = np.minimum(rng.integers(0, n, 3), np.maximum(noisy[0] - 1, 0)).astype(np.int32)
    jax_model.config.parallel.use_pallas = model.config.parallel.use_pallas = True
    ref = jax.jit(lambda p, st, t, near: jax_model._network_fused(
        p, st, t, near, False, None, interpret=True))(
        params["network"], jax_structure.state_from_list_batch([jnp.asarray(a) for a in noisy]),
        jnp.asarray(ts), jnp.asarray(nearest))
    state = structure.state_from_list_batch([torch.from_numpy(np.asarray(a)) for a in noisy])
    trunk, rate_stack, vec_stack = model.pack_for_kernel()
    assert trunk.layout == "narrow" and trunk.dims.fold_discrete
    assert (trunk.dims.hidden, trunk.dims.hidden_local) == (32, 24)
    assert (rate_stack.dim_in, vec_stack.dim_in) == (32, 35)
    calls = epic_cuda.epic_forward_reference.calls, gsdm_stack_cuda.gsdm_stack_reference.calls
    got = model.forward_kernel(state, torch.from_numpy(ts), torch.from_numpy(nearest).long())
    assert (epic_cuda.epic_forward_reference.calls,
            gsdm_stack_cuda.gsdm_stack_reference.calls) == (calls[0] + 1, calls[1] + 2)
    assert epic_forward.launches == gsdm_stack_cuda.gsdm_stack.launches == 0
    names = ["D_xt", "rate_emb", "near_atom_logits", "auto_mean", "auto_std"]
    for name, g, r in zip(names, got, ref):
        scale_close(g.numpy(), r, 5e-4, name)
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(ref[5]))
