"""`parallel.compute_dtype: "bfloat16"` on the port, held against the JAX
package on the CPU (N = 16, B = 8, transplanted flax weights, numpy-seeded
inputs).

JAX's models cast their parameters and inputs to bfloat16 in `forward` and
the heads back to float32 (multimodal_bridge_matching.py:234-253,
absorbing_flows.py:269-287); its kernel gates never read the dtype, and the
transdimensional model never reads it at all. The reference is JAX's
`forward` and `loss_fn` called op by op, as the JAX package's own tests call
them: XLA on the CPU then rounds every operation's result to bfloat16 (under
`jax.jit` it keeps float32 between fused operations, a choice of the
compiler that moves the heads by up to 2.7 on the survival logits). The
port takes the same steps (models/architectures/utils.py: `linear`,
`sigmoid`, `SELU`, the weight norm, the leaky slope), so its bf16 forward
gives JAX's bf16 heads to float32 rounding of the parts that promote to
float32 (the survival head's transformer, a Dense over float token ids).

Tolerance, measured first on 6 × 6 weight and input seeds: the port's bf16
heads equal JAX's bits except where an f32 accumulation of another order
lands on the other side of a bfloat16 rounding, a single element of a head
(≤ 0.4% of a head's elements; one such flip moved a discrete logit by 0.21
of JAX's own float32-vs-bf16 gap); parts that promote to float32 differ by
float32 rounding (≤ 3e-4 of the scale). So per head the mean |port − JAX
bf16| must lie within 2% of the mean |JAX float32 − JAX bf16| (the control,
which fails if the cast were skipped; measured ≤ 0.36%), and the largest
within half the largest control (measured ≤ 0.21); a loss term within 2% of
its own control gap.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_particles_tpu.models.generative.states import (
    AbsorbingBridgeState as JaxAbsorbingState,
)
from multimodal_particles_tpu.models.generative.states import HybridState as JaxState
from multimodal_particles_tpu.utils import dtype as jax_dtype
from multimodal_particles_tpu_torch import config_classes as port_cfgs
from multimodal_particles_tpu_torch.data import (
    absorbing_training_batch,
    synthetic_training_batch,
)
from multimodal_particles_tpu_torch.models.generative.absorbing.absorbing_flows import (
    AbsorbingFlow,
)
from multimodal_particles_tpu_torch.models.generative.init import init_parameters
from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (
    MultiModalBridgeMatching,
)
from multimodal_particles_tpu_torch.models.generative.states import (
    AbsorbingBridgeState,
    HybridState,
)
from multimodal_particles_tpu_torch.models.generative.transdimensional import structure
from multimodal_particles_tpu_torch.models.generative.transdimensional.transdimensional_model import (
    TransdimensionalJumpDiffusion,
)
from multimodal_particles_tpu_torch.training.trainer import Trainer
from multimodal_particles_tpu_torch.utils.dtype import (
    cast_floating,
    compute_dtype_of,
    resolve_dtype,
)
from torch_port_helpers import (
    B,
    N,
    context_pair,
    jax_bridge_draws,
    port_batch,
    random_state,
    to_torch,
    transdim_list_batch,
)

torch.backends.cuda.matmul.allow_tf32 = False
MEAN_SHARE, MAX_SHARE = 0.02, 0.5  # of the float32-vs-bf16 control gap
HEADS = ("continuous", "discrete", "absorbing")


def hold_gap(got, ref_bf16, ref_f32, name):
    """The port's float32 head against JAX's bf16 one, measured against JAX's
    own float32-vs-bf16 gap (module docstring)."""
    got = got.detach().numpy()
    ref_bf16, ref_f32 = np.asarray(ref_bf16), np.asarray(ref_f32)
    assert got.dtype == np.float32, name
    gap, control = np.abs(got - ref_bf16), np.abs(ref_f32 - ref_bf16)
    assert control.mean() > 0, name
    assert gap.mean() <= MEAN_SHARE * control.mean(), (name, gap.mean(), control.mean())
    assert gap.max() <= MAX_SHARE * control.max(), (name, gap.max(), control.max())


def set_dtype(models, name):
    for model in models:
        model.config.parallel.compute_dtype = name


# ------------------------------------------------------------------ helpers


@pytest.mark.parametrize("name", ["float32", "f32", "bfloat16", "bf16", None])
def test_resolve_dtype_follows_jax(name):
    got = resolve_dtype(name)
    assert str(got).removeprefix("torch.") == jnp.dtype(jax_dtype.resolve_dtype(name)).name
    assert resolve_dtype(got) is got


def test_unknown_dtype_name_raises_as_in_jax():
    with pytest.raises(KeyError):
        jax_dtype.resolve_dtype("float16")
    with pytest.raises(KeyError):
        resolve_dtype("float16")


def test_cast_floating_leaves_integers_alone():
    state = HybridState(torch.zeros(2, 1, 1), torch.ones(2, 3, 3),
                        torch.ones(2, 3, 1, dtype=torch.int32), None)
    tree = {"state": state, "pair": (torch.ones(2), torch.ones(2, dtype=torch.bool)),
            "list": [torch.ones(1, dtype=torch.float64)], "name": "x", "none": None}
    out = cast_floating(tree, "bf16")
    assert out["state"].time.dtype == out["state"].continuous.dtype == torch.bfloat16
    assert out["state"].discrete.dtype == torch.int32 and out["state"].absorbing is None
    assert out["pair"][0].dtype == torch.bfloat16 and out["pair"][1].dtype == torch.bool
    assert isinstance(out["list"], list) and out["list"][0].dtype == torch.bfloat16
    assert out["name"] == "x" and out["none"] is None
    assert state.continuous.dtype == torch.float32  # the input is not changed
    ref = jax_dtype.cast_floating({"f": jnp.ones(2), "i": jnp.ones(2, jnp.int32)}, "bf16")
    assert (ref["f"].dtype, ref["i"].dtype) == (jnp.bfloat16, jnp.int32)


def test_compute_dtype_of_a_config():
    cfg = port_cfgs.MultimodalBridgeMatchingConfig()
    assert compute_dtype_of(cfg) == torch.float32
    cfg.parallel.compute_dtype = "bf16"
    assert compute_dtype_of(cfg) == torch.bfloat16
    assert compute_dtype_of(object()) == torch.float32  # no parallel section


# --------------------------------------------------------------- vs JAX bf16


@pytest.mark.parametrize("name", ["sigmoid", "selu", "leaky_relu"])
def test_bf16_activations_and_their_gradients_match_jax(name):
    """The activations' narrow-dtype steps give jax.nn's bf16 values and
    gradients bit for bit, finite where exp overflows (|x| up to 200)."""
    import flax.linen as fnn

    from multimodal_particles_tpu_torch.models.architectures.epic import leaky_relu
    from multimodal_particles_tpu_torch.models.architectures.utils import SELU, sigmoid

    jax_fn, port_fn = {"sigmoid": (jax.nn.sigmoid, sigmoid), "selu": (jax.nn.selu, SELU()),
                       "leaky_relu": (fnn.leaky_relu, leaky_relu)}[name]
    x = np.concatenate([np.random.default_rng(0).standard_normal(512).astype(np.float32) * 4,
                        np.array([-200, -90, -5, 0, 5, 90, 200], np.float32)])
    x_j = jnp.asarray(x).astype(jnp.bfloat16)
    ref = jax_fn(x_j)
    ref_grad = jax.grad(lambda a: jnp.sum(jax_fn(a).astype(jnp.float32)))(x_j)
    x_t = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    got = port_fn(x_t)
    got.backward(torch.ones_like(got))
    assert got.dtype == x_t.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(ref, np.float32))
    np.testing.assert_array_equal(x_t.grad.float().numpy(), np.asarray(ref_grad, np.float32))
    assert torch.isfinite(x_t.grad).all()


@pytest.fixture(params=["mbm", "absorbing"])
def bf16_pair(request):
    """The conditional model of a family (both contexts: every part of the
    unconditional forward and the context embeddings) under bf16, both
    packages' configs set back to float32 afterwards."""
    pair = context_pair(request.param)
    set_dtype([pair[0], pair[2]], "bfloat16")
    yield request.param, pair
    set_dtype([pair[0], pair[2]], "float32")


def family_states(family, batch):
    t, x, k, mask = random_state(seed=9)
    if family == "mbm":
        return (JaxState(*map(jnp.asarray, (t, x, k, mask))),
                HybridState(*to_torch(t, x, k, mask)))
    mask = mask.astype(np.int32)
    return (JaxAbsorbingState(*map(jnp.asarray, (t, x, k, mask))),
            AbsorbingBridgeState(*to_torch(t, x, k, mask.astype(np.int64))))


def test_bf16_forward_matches_jax(bf16_pair):
    """Each head against JAX's bf16 forward, with JAX's float32 forward as the
    control; MBM hands back the state's own float32 mask."""
    family, (jax_model, params, model, batch) = bf16_pair
    state_j, state = family_states(family, batch)
    ref_bf16 = jax_model.forward(params, state_j, batch)
    with torch.no_grad():
        heads = model.forward(state, port_batch(batch))
    set_dtype([jax_model], "float32")
    try:
        ref_f32 = jax_model.forward(params, state_j, batch)
    finally:
        set_dtype([jax_model], "bfloat16")
    for name in HEADS:
        if family == "mbm" and name == "absorbing":
            assert heads.absorbing is state.absorbing
            continue
        hold_gap(getattr(heads, name), getattr(ref_bf16, name), getattr(ref_f32, name), name)


def absorbing_draws(key, batch):
    """The draws of the absorbing `sample_bridges` from `key`
    (absorbing_flows.py:291-307)."""
    key_t, key_x, key_k, key_m = jax.random.split(key, 4)
    draws = (jax.random.uniform(key_t, (B,), dtype=jnp.float32),
             jax.random.normal(key_x, batch.target_continuous.shape, dtype=jnp.float32),
             jax.random.uniform(key_k, (B, N), dtype=jnp.float32),
             jax.random.uniform(key_m, (B, N, 1)))
    return tuple(torch.from_numpy(np.array(d)) for d in draws)


def test_bf16_loss_matches_jax(bf16_pair):
    """Every loss term of `loss_fn` (the module forward under bf16, the gates
    being off on the CPU) against JAX's, op by op as its forward runs, with
    JAX's float32 loss as the control."""
    family, (jax_model, params, model, batch) = bf16_pair
    key = jax.random.PRNGKey(61)
    draws = (jax_bridge_draws if family == "mbm" else absorbing_draws)(key, batch)
    _, ref_bf16 = jax_model.loss_fn(params, key, batch)
    set_dtype([jax_model], "float32")
    try:
        _, ref_f32 = jax_model.loss_fn(params, key, batch)
    finally:
        set_dtype([jax_model], "bfloat16")
    with torch.no_grad():
        _, metrics = model.loss_fn(port_batch(batch), draws=draws)
    for name, value in metrics.items():
        got, bf, f32 = value.item(), float(ref_bf16[name]), float(ref_f32[name])
        assert abs(got - bf) <= MEAN_SHARE * abs(f32 - bf), (name, got, bf, f32)


# ------------------------------------------------------------- the port alone


def tiny(cls, **sections):
    cfg = cls()
    cfg.data.max_num_particles, cfg.bridge.num_timesteps = N, 8
    cfg.parallel.compute_dtype = "bfloat16"
    for section, fields in sections.items():
        for name, value in fields.items():
            setattr(getattr(cfg, section), name, value)
    return cfg


@pytest.mark.parametrize("family", ["mbm", "absorbing"])
def test_an_adamw_step_keeps_float32_parameters(family):
    """A Trainer step under bf16: the loss is finite, every parameter gets a
    finite gradient through the cast, and parameters, gradients and the
    optimizer's moments stay float32."""
    gen = torch.Generator().manual_seed(0)
    if family == "mbm":
        model = MultiModalBridgeMatching(tiny(port_cfgs.MultimodalBridgeMatchingConfig))
        batch = synthetic_training_batch(B, N, 3, 8, gen)
    else:
        model = AbsorbingFlow(tiny(port_cfgs.AbsorbingConfig))
        batch = absorbing_training_batch(B, N, 3, 8, gen)
    trainer = Trainer(model, model.config)
    trainer.setup()
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    metrics = trainer.train_step(batch)
    assert all(np.isfinite(v.item()) for v in metrics.values())
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name
        assert not torch.equal(p.detach(), before[name]), name
    moments = [t for s in trainer.state.opt_state.inner.state.values()
               for t in s.values() if torch.is_tensor(t) and t.is_floating_point()]
    assert moments and all(t.dtype == torch.float32 for t in moments)


def twin(model_cls, cfg):
    """Two models of a config with the same seeded weights: float32 and bf16."""
    f32 = init_parameters(model_cls(dataclasses.replace(
        cfg, parallel=dataclasses.replace(cfg.parallel, compute_dtype="float32"))), 3)
    bf16 = model_cls(cfg)
    bf16.load_state_dict(f32.state_dict())
    return f32, bf16


def test_gate_on_bf16_mbm_takes_the_float32_kernel_path():
    """With the kernel gate on (CPU: the kernels' plain versions) a bf16
    config-berlin model serves and trains in float32, as JAX's kernels do:
    the same bits as the float32 config from the same draws."""
    cfg = tiny(port_cfgs.MultimodalBridgeMatchingConfig, parallel={"use_pallas": True})
    f32, bf16 = twin(MultiModalBridgeMatching, cfg)
    gen = torch.Generator().manual_seed(4)
    batch = synthetic_training_batch(B, N, 3, 8, gen)
    uniforms = torch.rand((7, 2, B, N), generator=gen)
    outs = [m.predict(batch, uniforms=uniforms) for m in (f32, bf16)]
    assert torch.equal(outs[0].continuous, outs[1].continuous)
    assert torch.equal(outs[0].discrete, outs[1].discrete)
    draws = (torch.rand(B, generator=gen), torch.randn((B, N, 3), generator=gen),
             torch.rand((B, N), generator=gen))
    losses = []
    for model in (f32, bf16):
        loss, _ = model.loss_fn(batch, draws=draws)
        loss.backward()
        losses.append(loss.detach())
    assert torch.equal(*losses)
    for (name, p), q in zip(f32.named_parameters(), bf16.parameters()):
        assert torch.equal(p.grad, q.grad), name
    # and the gate off: the module forward, which casts
    cfg.parallel.use_pallas = False
    assert not torch.equal(bf16.predict(batch, uniforms=uniforms).continuous, outs[0].continuous)


def test_gate_on_bf16_absorbing_samples_in_float32():
    """The absorbing sampling path with the gate on (the trunk kernel and K6,
    plain versions here) ignores the dtype, as JAX's forward_sampling does."""
    cfg = tiny(port_cfgs.AbsorbingConfig, parallel={"use_pallas": True})
    f32, bf16 = twin(AbsorbingFlow, cfg)
    gen = torch.Generator().manual_seed(5)
    batch = absorbing_training_batch(B, N, 3, 8, gen)
    uniforms = torch.rand((7, 3, B, N), generator=gen)
    outs = [m.predict(batch, uniforms=uniforms) for m in (f32, bf16)]
    for name in ("continuous", "discrete", "mask_t"):
        assert torch.equal(getattr(outs[0], name), getattr(outs[1], name)), name


def test_transdim_computes_in_float32_under_bf16():
    """The JAX transdimensional model never reads `compute_dtype`
    (tests/test_torch_transdim.py holds that JAX's network under "bfloat16"
    gives its float32 bits): the port's network and loss under "bfloat16"
    give the float32 config's bits."""
    cfg = port_cfgs.TransdimensionalEpicConfig()
    cfg.data.max_num_particles = N
    f32 = init_parameters(TransdimensionalJumpDiffusion(cfg), 2)
    cfg_bf16 = dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, compute_dtype="bfloat16"))
    bf16 = TransdimensionalJumpDiffusion(cfg_bf16)
    bf16.load_state_dict(f32.state_dict())
    batch = [torch.from_numpy(a) for a in transdim_list_batch(7, B, N)]
    state = structure.state_from_list_batch(batch)
    ts, nearest = torch.linspace(0.1, 0.9, B), torch.zeros(B, dtype=torch.long)
    with torch.no_grad():
        got = [m.net_forward(state, ts, nearest_atom=nearest) for m in (f32, bf16)]
        losses = [m.loss_fn(batch, generator=torch.Generator().manual_seed(1))[0]
                  for m in (f32, bf16)]
    for a, b in zip(jax.tree_util.tree_leaves(got[0]), jax.tree_util.tree_leaves(got[1])):
        assert a.dtype != torch.bfloat16 and torch.equal(a, b)
    assert torch.equal(*losses)
