"""K4 and K5 on jets of 129 to 256 particle slots, the port against the JAX
package on the CPU.

On the card the wide kernels take such a jet as a cluster of hidden / 128
column blocks × 2 row blocks (ops/csrc/epic_wide_any.cuh, the
`epic_wide_{forward,backward}_h*_r2.cu` instances); on the CPU the wrappers
take their plain versions, so these tests hold the gate and the plain
versions, and the three families' kernel paths built on them, against the
JAX package, whose wide kernels take any N, in interpret mode:

  * `wide_supported` equals `wide_pallas_supported` at N = 129, 200, 256 at
    every width combination of tests/test_torch_wide_widths.py, and refuses
    N = 257 where JAX takes it;
  * the plain wide forward and backward against `epic_forward_pallas_wide`
    and `make_epic_train_forward_wide` at N = 136 and 256, with a jet whose
    only live particle lies past slot 128 and one whose live slots all lie
    past it;
  * MBM's `loss_fn` with `use_pallas=True` (the differentiable wide packing
    and K5's plain version) against `jax.value_and_grad`, N = 136;
  * the transdimensional `forward_kernel` (K4 with the folded input, K7
    twice) against `_network_fused` in interpret mode, N = 136;
  * `AbsorbingFlow.forward_sampling` (K4 with the hidden output and the
    56-wide head, K6) against JAX's with `use_pallas=True`, N = 136.

Every width 128, 2 EPiC blocks (the families' gsdm and survival stacks one
block), B = 4, weights drawn by numpy on flax's shapes (`drawn_params`) plus
seeded noise. Tolerances as tests/test_torch_wide.py (forward atol 1e-5 /
rtol 1e-4, gradients per leaf |err| ≤ 1e-4·max|ref leaf| + 1e-3·|ref|) and
tests/test_torch_scaled_families.py (the families' outputs 2e-4 and 5e-4 of
their scale).
"""

import itertools

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
from multimodal_particles_tpu.ops.epic_pallas import WEIGHT_NAMES
from multimodal_particles_tpu.ops.epic_pallas_wide import (
    epic_forward_pallas_wide,
    pack_wide_encoder_params as jax_pack_wide,
    wide_pallas_supported,
)
from multimodal_particles_tpu.ops.epic_pallas_wide_vjp import make_epic_train_forward_wide
from multimodal_particles_tpu_torch.config_classes import (
    MultimodalBridgeMatchingConfig as TorchConfig,
)
from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (
    MultiModalBridgeMatching as TorchMBM,
)
from multimodal_particles_tpu_torch.models.generative.states import AbsorbingBridgeState
from multimodal_particles_tpu_torch.models.generative.transdimensional import structure
from multimodal_particles_tpu_torch.ops import epic_cuda, gsdm_stack_cuda, survival_cuda
from multimodal_particles_tpu_torch.ops.epic_vjp_cuda import (
    epic_backward_reference,
    epic_train_forward_reference,
)
from multimodal_particles_tpu_torch.ops.epic_wide_cuda import (
    WIDE_MAX_PARTICLES,
    WIDE_WIDTHS,
    epic_forward_wide,
    pack_wide_encoder_params,
    wide_supported,
)
from multimodal_particles_tpu_torch.ops.epic_wide_vjp_cuda import (
    epic_backward_wide,
    epic_train_forward_wide,
)
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
B = 4
N_LONG = 136  # past one row block, a multiple of 8 (JAX's wide kernel pads N to 8)
SCALED = {"num_blocks": 2, "dim_hidden_local": 128, "dim_hidden_glob": 128, "dim_emb_time": 128,
          "dim_emb_features_continuous": 128, "dim_emb_features_discrete": 128}
ONE_STACK_BLOCK = {"n_attn_blocks": 1}


def grads_close(got: np.ndarray, ref: np.ndarray, name: str):
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got, ref, atol=1e-4 * scale, rtol=1e-3, err_msg=name)


def scale_close(got, ref, tol, name=""):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * max(np.abs(ref).max(), 1.0),
                               err_msg=name)


def long_state(seed, n):
    """t, x, k, mask as numpy at n > 128 slots: jet 0 has one live particle,
    at slot n − 3 (past the first row block); jet 1's live slots all lie past
    slot 128; jets 2 and 3 random non-prefix masks."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((B, n, 1)) < 0.6).astype(np.float32)
    mask[0] = 0.0
    mask[0, n - 3] = 1.0
    mask[1, :128] = 0.0
    x = (rng.standard_normal((B, n, 3)) * mask).astype(np.float32)
    k = (rng.integers(0, 8, (B, n, 1)) * mask).astype(np.int32)
    t = rng.uniform(0.05, 0.95, (B, 1, 1)).astype(np.float32)
    return t, x, k, mask


def mbm_pair(n, seed=3):
    """(jax_model, jax_params, torch_model, jax_batch) of MBM at every width
    128, 2 blocks, B jets of n slots: `drawn_params` plus seeded noise,
    transplanted."""
    cfg = jax_config(**SCALED)
    cfg.data.batch_size, cfg.data.max_num_particles = B, n
    batch = jax.tree_util.tree_map(jnp.asarray, JetsDataloaderModule.random_databatch(cfg))
    jax_model = MultiModalBridgeMatching(cfg)
    params = noisy_params(drawn_params(jax_model.init, jax.random.PRNGKey(seed), batch, seed=seed),
                          seed)
    torch_cfg = TorchConfig.from_dict(cfg.to_dict())
    model = TorchMBM(torch_cfg)
    model.load_state_dict(params_from_flax(params, torch_cfg))
    return jax_model, jax.tree_util.tree_map(jnp.asarray, params), model, batch


@pytest.fixture(scope="module")
def mbm():
    return mbm_pair(N_LONG)


# -------------------------------------------------------------------- gates


@pytest.mark.parametrize("n", [129, 200, 256, 257])
def test_wide_gate_equals_jax_past_128_slots(n):
    """Over every combination of the five widths in 128 … 512, with tokens
    and with the folded input, the port's gate says what JAX's says up to 256
    slots; at 257 it refuses every one of them, where JAX takes them all."""
    cfg = MultimodalBridgeMatchingConfig.from_yaml(CONFIG_PATH)
    cfg.encoder.num_blocks = 1
    cfg.data.max_num_particles = n
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
            assert jax_on
            ours = wide_supported(port, allow_linear_discrete=linear)
            assert ours == (jax_on and n <= WIDE_MAX_PARTICLES), (combo, linear)
            taken += ours
    assert taken == (2 * len(WIDE_WIDTHS) ** len(names) if n <= 256 else 0)


# ------------------------------------------------- the plain forward and backward


def static_kwargs(cfg):
    return dict(num_blocks=cfg.encoder.num_blocks, use_skip=cfg.encoder.skip_connection,
                add_discrete_head=cfg.encoder.add_discrete_head, dim_c=3, vocab=8,
                hidden=cfg.encoder.dim_hidden_local, dim_emb_time=cfg.encoder.dim_emb_time,
                interpret=True)


@pytest.mark.parametrize("n", [N_LONG, 256])
def test_plain_forward_and_backward_match_wide_pallas_past_128_slots(mbm, n):
    """The plain forward against `epic_forward_pallas_wide`, and the plain
    forward and backward of the training op against the VJP of
    `make_epic_train_forward_wide`, both in interpret mode on the JAX
    packing; the wrappers take the plain versions and launch nothing."""
    jax_model, params, model, _ = mbm
    cfg = jax_model.config
    t, x, k, mask = long_state(11 + n, n)
    g = np.random.default_rng(n).standard_normal((B, n, 11)).astype(np.float32)
    packed_jax = jax_pack_wide(params["encoder"], cfg.encoder.num_blocks)
    inputs_j = tuple(map(jnp.asarray, (t, x, k, mask)))
    fwd_ref = epic_forward_pallas_wide(packed_jax, *inputs_j, **static_kwargs(cfg))
    fused = make_epic_train_forward_wide(**static_kwargs(cfg))

    @jax.jit  # one program: its interpret-mode kernels compile once
    def forward_and_vjp(p, cot):
        out, vjp = jax.vjp(lambda q: fused(q, *inputs_j), p)
        return out, vjp(cot)[0]

    out_ref, cot = forward_and_vjp(packed_jax, jnp.asarray(g))
    ref = dict(zip(WEIGHT_NAMES, (np.asarray(c) for c in cot)))

    tt, tx, tk, tm = to_torch(t, x, k, mask)
    packed = pack_wide_encoder_params(model.encoder, model.config)
    calls = epic_cuda.epic_forward_reference.calls, epic_backward_reference.calls
    launches = epic_forward_wide.launches, epic_backward_wide.launches
    with torch.no_grad():
        got = epic_forward_wide(packed, tt, tx, tk, tm)  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(fwd_ref), atol=ATOL, rtol=RTOL)
    assert (got.numpy()[1, :128, :3] == 0).all()  # no live slot in the first row block
    out = epic_train_forward_wide(packed, tt, tx, tk, tm)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref), atol=ATOL, rtol=RTOL)
    d_flat = epic_backward_wide(packed, tt, tx, tk, tm, torch.from_numpy(g))  # CPU: plain
    assert epic_cuda.epic_forward_reference.calls == calls[0] + 1
    assert epic_backward_reference.calls == calls[1] + 1
    assert (epic_forward_wide.launches, epic_backward_wide.launches) == launches == (0, 0)
    assert torch.isfinite(d_flat).all()
    for name, value in epic_cuda.wide_flat_views(d_flat, packed.dims).items():
        base, _, layer = name.rpartition("_")
        r = ref[base][int(layer)] if layer.isdigit() else ref[name]
        got_leaf = value.T if value.dim() == 2 and name != "table" else value  # to (in, out)
        grads_close(got_leaf.numpy().reshape(r.shape), r, name)


# ------------------------------------------------------------------- MBM


def jax_draws(key, batch):
    """The draws that JAX sample_bridges makes from `key`."""
    key_t, key_x, key_k = jax.random.split(key, 3)
    x1 = batch.target_continuous
    t = jax.random.uniform(key_t, (x1.shape[0],), dtype=x1.dtype)
    z = jax.random.normal(key_x, x1.shape, dtype=x1.dtype)
    u = jax.random.uniform(key_k, x1.shape[:2], dtype=jnp.float32)
    return tuple(torch.tensor(np.asarray(a)) for a in (t, z, u))


def test_mbm_loss_and_every_gradient_with_the_kernel_path_match_jax(mbm):
    """MBM's wide gate takes N = 136; `loss_fn` with `use_pallas=True` goes
    through the differentiable wide packing and K5's plain version (CPU), and
    its value and every parameter's gradient match `jax.value_and_grad` of
    the JAX loss with the same draws."""
    from multimodal_particles_tpu_torch.data import MultimodalDatabatch

    jax_model, params, model, batch = mbm
    assert wide_supported(model.config) and model.wide_kernel_enabled("cuda")
    key = jax.random.PRNGKey(22)
    (_, metrics_ref), grads = jax.jit(jax.value_and_grad(jax_model.loss_fn, has_aux=True))(
        params, key, batch)
    port_batch = MultimodalDatabatch(*to_torch(*(np.asarray(getattr(batch, f)) for f in (
        "source_continuous", "source_discrete", "source_mask",
        "target_continuous", "target_discrete", "target_mask"))))
    model.config.parallel.use_pallas = True
    calls, launches = epic_train_forward_reference.calls, epic_backward_wide.launches
    try:
        model.zero_grad()
        loss, metrics = model.loss_fn(port_batch, draws=jax_draws(key, batch))
        loss.backward()
    finally:
        model.config.parallel.use_pallas = "auto"
    assert epic_train_forward_reference.calls == calls + 1
    assert epic_backward_wide.launches == launches == 0
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


def test_transdim_forward_kernel_takes_the_wide_trunk_past_128_slots():
    """At N = 136 the transdimensional trunk takes the wide kernel (it took
    none before: `kernel_refusal` refused the fused path); `forward_kernel`
    (K4 with the folded input and the hidden output, K7 twice, their plain
    versions on the CPU) against `_network_fused` in interpret mode, 5e-4 of
    each output's scale; jet 0 holds one particle."""
    jax_model, params, model, batch = transdim_pair(
        seed=6, n=N_LONG, b=B, drawn_init=True,
        sections={"encoder": {**SCALED, **ONE_STACK_BLOCK}})
    assert model.kernel_refusal() is None and model._trunk_layout() == "wide"
    rng = np.random.default_rng(1)
    batch[0][0] = 1
    live = (np.arange(N_LONG)[None, :] < batch[0][:, None])[..., None]
    noisy = [batch[0], batch[1] * live, (batch[2] + 0.3 * rng.standard_normal(
        batch[2].shape).astype(np.float32)) * live]
    ts = rng.uniform(0.05, 1.0, B).astype(np.float32)
    nearest = np.minimum(rng.integers(0, N_LONG, B), noisy[0] - 1).astype(np.int32)
    jax_model.config.parallel.use_pallas = model.config.parallel.use_pallas = True
    ref = jax.jit(lambda p, st, t, near: jax_model._network_fused(
        p, st, t, near, False, None, interpret=True))(
        params["network"], jax_structure.state_from_list_batch([jnp.asarray(a) for a in noisy]),
        jnp.asarray(ts), jnp.asarray(nearest))
    state = structure.state_from_list_batch([torch.from_numpy(np.asarray(a)) for a in noisy])
    trunk, rate_stack, vec_stack = model.pack_for_kernel()
    assert trunk.layout == "wide" and trunk.dims.fold_discrete
    assert (rate_stack.dim_in, vec_stack.dim_in) == (136, 139)
    calls = epic_cuda.epic_forward_reference.calls, gsdm_stack_cuda.gsdm_stack_reference.calls
    got = model.forward_kernel(state, torch.from_numpy(ts), torch.from_numpy(nearest).long())
    assert (epic_cuda.epic_forward_reference.calls,
            gsdm_stack_cuda.gsdm_stack_reference.calls) == (calls[0] + 1, calls[1] + 2)
    assert epic_forward_wide.launches == gsdm_stack_cuda.gsdm_stack.launches == 0
    names = ["D_xt", "rate_emb", "near_atom_logits", "auto_mean", "auto_std"]
    for name, g, r in zip(names, got, ref):
        scale_close(g.numpy(), r, 5e-4, name)
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(ref[5]))


def test_absorbing_forward_sampling_takes_the_wide_trunk_past_128_slots():
    """At N = 136 the absorbing trunk packs for the wide kernel (the module
    trunk before); `forward_sampling` (K4 with the hidden output and the
    56-wide head, then K6, their plain versions on the CPU) against JAX's
    with `use_pallas=True` in interpret mode, each head within 2e-4 of its
    scale; jet 0's one live particle lies past slot 128."""
    jax_model, params, model, batch = absorbing_pair(
        seed=5, n=N_LONG, b=B, drawn_init=True,
        sections={"encoder": SCALED, "generator": {"n_attn_blocks": 1}})
    t, x, k, mask = long_state(3, N_LONG)
    x = (np.asarray(batch.source_continuous) * mask).astype(np.float32)
    mask = mask.astype(np.int32)
    trunk, _ = model.pack_for_kernel()
    assert trunk is not None and trunk.layout == "wide" and trunk.dims.head_hidden == 56
    state_j = JaxState(jnp.asarray(t), jnp.asarray(x), jnp.asarray(k), jnp.asarray(mask))
    state = AbsorbingBridgeState(*to_torch(t, x, k, mask.astype(np.int64)))
    jax_model.config.parallel.use_pallas = model.config.parallel.use_pallas = True
    ref = jax.jit(jax_model.forward_sampling)(params, state_j, batch)
    calls = epic_cuda.epic_forward_reference.calls, survival_cuda.survival_head_reference.calls
    got = model.forward_sampling(state)
    assert epic_cuda.epic_forward_reference.calls == calls[0] + 1
    assert survival_cuda.survival_head_reference.calls == calls[1] + 1
    assert epic_forward_wide.launches == survival_cuda.survival_head.launches == 0
    for name in ("continuous", "discrete", "absorbing"):
        scale_close(getattr(got, name).numpy(), getattr(ref, name), 2e-4, name)
