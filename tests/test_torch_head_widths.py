"""K6, K7 and K8 at every head count and at transformer widths 128–512, the
port against the JAX package on the CPU.

The head kernels take transformer widths C of 128, 256, 384 and 512 (a jet
is a cluster of C / 128 blocks on the card) and any head count whose heads
are at most 128 channels wide, widths that are no multiple of 8 included.
On the CPU the wrappers take their plain versions, so these tests hold the
port's packing (the flat buffer and the tensor-core stream cut into the
blocks' 128-column slices) and its plain versions against the interpret-mode
Pallas kernels, at the (C, heads) pairs of the table below, at N = 109 and,
at the pairs of at most 16 heads, N = 16 (the interpret-mode kernels compile
a loop over the heads: 2.5 s a shape at 128 heads), small batches:

    C    heads   why
    128    8
    256    8
    256   64     heads 4 wide
    384    4     heads 96 wide straddle the blocks; so do GroupNorm groups
    384    6     GroupNorm groups straddle the blocks
    384  128     heads 3 wide, one straddling
    512   16

Weights are drawn by numpy from flax's laws on flax's shapes
(`drawn_params`), biases and GroupNorm parameters plus seeded noise; the
matrices keep flax's law (std 1/√fan-in) at every width, so that the
outputs stay at the scale the tolerances were set for at width 128. The stacks are cut to one (ResnetBlock, AttnBlock) block, and the
models to one EPiC block, so that the interpret-mode kernels compile in
seconds. Tolerances: K6 and K7 rtol = atol = 2e-4
(tests/test_torch_survival.py, tests/test_torch_gsdm_stack.py); K8 atol
2e-5 (tests/test_torch_attention.py); the models' kernel paths as
tests/test_torch_absorbing.py (2e-4) and tests/test_torch_transdim.py (5e-4)
hold them at width 128. Last, the gates: inside the scope above (and N ≤
128, any trunk hidden width for K6) the port's gates say what JAX's say;
outside it they say False.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from multimodal_particles_tpu.config_classes import AbsorbingConfig
from multimodal_particles_tpu.config_classes.transdimensional_unconditional_config import (
    TransdimensionalEpicConfig,
)
from multimodal_particles_tpu.models.architectures import gsdm as jax_gsdm
from multimodal_particles_tpu.models.generative.transdimensional.transdimensional_model import (
    TransdimensionalJumpDiffusion as JaxTransdim,
)
from multimodal_particles_tpu.models.generative.states import AbsorbingBridgeState as JaxState
from multimodal_particles_tpu.models.generative.transdimensional import (
    structure as jax_structure,
)
from multimodal_particles_tpu.ops import gsdm_stack_pallas as jax_stack
from multimodal_particles_tpu.ops import survival_pallas
from multimodal_particles_tpu.ops.attention_pallas import attention_core_pallas
from multimodal_particles_tpu_torch.config_classes import AbsorbingConfig as TorchAbsorbingConfig
from multimodal_particles_tpu_torch.config_classes import (
    TransdimensionalEpicConfig as TorchTransdimConfig,
)
from multimodal_particles_tpu_torch.models.architectures import gsdm
from multimodal_particles_tpu_torch.models.generative.states import AbsorbingBridgeState
from multimodal_particles_tpu_torch.models.generative.transdimensional import structure
from multimodal_particles_tpu_torch.ops import (
    attention_cuda,
    epic_cuda,
    gsdm_stack_cuda,
    survival_cuda,
)
from torch_port_helpers import absorbing_pair, drawn_params, noisy_params, transdim_pair

PAIRS = [(128, 8), (256, 8), (256, 64), (384, 4), (384, 6), (384, 128), (512, 16)]
# (C, heads, N): N = 109 at every pair, N = 16 at those of at most 16 heads
CASES = [(c, h, n) for c, h in PAIRS for n in (16, 109) if n == 109 or h <= 16]
IDS = [f"C{c}-heads{h}-N{n}" for c, h, n in CASES]
TOL = dict(rtol=2e-4, atol=2e-4)
CORE_ATOL = 2e-5
N_BLOCKS = 1
CUT = {"num_blocks": 1}  # the EPiC trunk cut to one block


def _mask(rng, b, n):
    """A random non-prefix mask (B, N, 1), each slot alive with probability
    0.6, jet 0 empty."""
    mask = (rng.random((b, n, 1)) < 0.6).astype(np.int32)
    mask[0] = 0
    return mask


# ------------------------------------------------------------ the packings


@pytest.mark.parametrize("C", [256, 384, 512])
def test_stream_holds_each_blocks_column_slice(C):
    """The tensor-core stream at width C is the C / 128 blocks' streams one
    after the other, block j's the stages of every matrix's columns 128·j …
    + 127, matrix after matrix, each (K, 128) slice padded to 8 rows; and its
    length is `stream_stages` over the cluster."""
    rng = np.random.default_rng(C)
    matrices = [torch.from_numpy(rng.standard_normal((k, C)).astype(np.float32))
                for k in (27, C, C)]
    stream = gsdm_stack_cuda.tensor_core_stream(matrices)
    parts = stream.view(C // 128, -1)
    for j in range(C // 128):
        torch.testing.assert_close(parts[j], gsdm_stack_cuda.tensor_core_stream(
            [w[:, 128 * j:128 * (j + 1)] for w in matrices]), rtol=0, atol=0)
    assert stream.numel() == (C // 128) * (4 + 2 * C // 8) * 2 * 8 * 128
    stages = gsdm_stack_cuda.stream_stages(27, 1, C) - (C // 128) * 6 * C // 8
    assert stages == (C // 128) * 4  # proj_in's ⌈27/8⌉ in each block's stream


# ------------------------------------------------------------------- K6


@pytest.fixture(scope="module")
def absorbing_heads():
    """(C, heads) → an absorbing pair whose survival head is C wide with
    `heads` heads and one block, its trunk one EPiC block."""
    pairs = {}

    def get(C, heads):
        if (C, heads) not in pairs:
            pairs[(C, heads)] = absorbing_pair(
                seed=5, n=16, b=3, drawn_init=True, vector_noise=True, sections={
                    "generator": {"transformer_dim": C, "n_heads": heads,
                                  "n_attn_blocks": N_BLOCKS},
                    "encoder": CUT})
        return pairs[(C, heads)]
    return get


@pytest.mark.parametrize("C,heads,n", CASES, ids=IDS)
def test_survival_head_matches_pallas_interpret(absorbing_heads, C, heads, n):
    """K6's path (the port's packing of the generator and the plain version)
    against `survival_head_pallas(..., interpret=True)` on the JAX packing of
    the same weights, random non-prefix masks, times in (0.05, 0.95)."""
    _, params, model, _ = absorbing_heads(C, heads)
    gen_params, dh = params["generator"], model.config.encoder.dim_hidden_local
    rng = np.random.default_rng(C + heads + n)
    b = 3
    t = rng.uniform(0.05, 0.95, (b, 1, 1)).astype(np.float32)
    last = rng.standard_normal((b, n, dh)).astype(np.float32)
    mask = _mask(rng, b, n)
    pallas = survival_pallas.survival_head_pallas(
        survival_pallas.pack_survival_head_params(gen_params, N_BLOCKS),
        survival_pallas.project_time_embeddings(gen_params, jnp.asarray(t), N_BLOCKS, C),
        jnp.asarray(last), jnp.asarray(mask), n_blocks=N_BLOCKS, n_heads=heads,
        transformer_dim=C, interpret=True)
    packed = survival_cuda.pack_survival_head_params(model.generator, N_BLOCKS)
    assert packed.channels == C
    assert packed.tensor_core.numel() == survival_cuda.head_stages(dh, N_BLOCKS, C) * 2 * 8 * 128
    tp = survival_cuda.project_time_embeddings(model.generator, torch.from_numpy(t), N_BLOCKS, C)
    calls = survival_cuda.survival_head_reference.calls
    got = survival_cuda.survival_head(packed, tp, torch.from_numpy(last),
                                      torch.from_numpy(mask).long(), n_heads=heads)
    assert survival_cuda.survival_head_reference.calls == calls + 1  # CPU: the plain version
    assert tuple(got.shape) == (b, n, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


# ------------------------------------------------------------------- K7


class _FlaxStack(nn.Module):
    """proj_in → one (ResnetBlock, AttnBlock) block at width C."""

    C: int
    heads: int

    @nn.compact
    def __call__(self, x_in, temb):
        h = nn.Dense(self.C, name="proj_in")(x_in)
        h = jax_gsdm.ResnetBlock(channels=self.C, dropout=0.0, temb_channels=self.C,
                                 name="res_0")(h, temb)
        return jax_gsdm.AttnBlock(self.C, self.heads, name="attn_0")(h)


def _stack_pair(C, heads, dim_in, seed=0):
    """(JAX params, port proj_in, port blocks) of one stack, the weights
    drawn by numpy on flax's shapes plus noise, transplanted."""
    x = jnp.zeros((1, 4, dim_in), jnp.float32)
    temb = jnp.zeros((1, C), jnp.float32)
    params = noisy_params(drawn_params(_FlaxStack(C, heads).init, jax.random.PRNGKey(seed), x,
                                       temb, seed=seed)["params"], seed, vectors_only=True)
    proj_in = torch.nn.Linear(dim_in, C)
    res = gsdm.ResnetBlock(C, dropout=0.0, temb_channels=C)
    att = gsdm.AttnBlock(C, n_heads=heads)
    for module, name in ((proj_in, "proj_in"), (res, "res_0"), (att, "attn_0")):
        state = {}
        for path, value in jax.tree_util.tree_flatten_with_path(params[name])[0]:
            keys = [p.key for p in path]
            leaf = {"kernel": "weight", "scale": "weight"}.get(keys[-1], keys[-1])
            value = np.asarray(value)
            state[".".join(keys[:-1] + [leaf])] = torch.from_numpy(
                np.array(value.T if keys[-1] == "kernel" else value, order="C"))
        module.load_state_dict(state)
    return params, proj_in, ([res], [att])


@pytest.mark.parametrize("C,heads,n", CASES, ids=IDS)
def test_gsdm_stack_matches_pallas_interpret(C, heads, n):
    """K7's path (the port's packing of the modules and the plain version)
    against `gsdm_stack_pallas(..., interpret=True)` on the JAX packing of the
    same weights, at the transdimensional creation head's input width 27."""
    dim_in, b = 27, 3
    params, proj_in, blocks = _stack_pair(C, heads, dim_in)
    rng = np.random.default_rng(C + heads + n)
    x_in = rng.standard_normal((b, n, dim_in)).astype(np.float32)
    temb = rng.standard_normal((b, C)).astype(np.float32)
    res_p, attn_p = [params["res_0"]], [params["attn_0"]]
    pallas = jax_stack.gsdm_stack_pallas(
        jax_stack.pack_gsdm_stack_params(params["proj_in"], res_p, attn_p),
        jax_stack.stack_time_embeddings(jnp.asarray(temb), res_p), jnp.asarray(x_in),
        n_blocks=N_BLOCKS, n_heads=heads, transformer_dim=C, interpret=True)
    with torch.no_grad():
        packed = gsdm_stack_cuda.pack_gsdm_stack_params(proj_in, *blocks)
        tp = gsdm_stack_cuda.stack_time_embeddings(torch.from_numpy(temb), blocks[0])
        calls = gsdm_stack_cuda.gsdm_stack_reference.calls
        got = gsdm_stack_cuda.gsdm_stack(packed, tp, torch.from_numpy(x_in), n_heads=heads)
    assert gsdm_stack_cuda.gsdm_stack_reference.calls == calls + 1
    assert packed.channels == C and tuple(got.shape) == (b, n, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


# ------------------------------------------------------------------- K8


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("C,heads", [(256, 8), (384, 4), (512, 16)],
                         ids=["C256-heads8", "C384-heads4", "C512-heads16"])
def test_attention_core_matches_pallas_interpret(C, heads, masked):
    """K8's plain version against the interpret-mode kernel at three widths,
    heads 32, 96 and 32 wide (the plain version is the einsum at any head
    width; the kernel's zero-padding of a head of 3 channels is held on the
    card); the masked case has a jet with every key masked."""
    rng = np.random.default_rng(C + heads)
    B, N = 3, 109
    q, k, v = (rng.standard_normal((B, N, C)).astype(np.float32) for _ in range(3))
    mask = _mask(rng, B, N).astype(np.float32) if masked else None
    pallas = attention_core_pallas(*map(jnp.asarray, (q, k, v)),
                                   None if mask is None else jnp.asarray(mask), n_heads=heads,
                                   interpret=True)
    assert attention_cuda.attention_core_supported((B, N, C), heads)
    got = attention_cuda.attention_core(*map(torch.from_numpy, (q, k, v)),
                                        None if mask is None else torch.from_numpy(mask),
                                        n_heads=heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=CORE_ATOL, rtol=0)


# ------------------------------------------------------- the models at 256 × 8

WIDE_HEADS = {"transformer_dim": 256, "n_heads": 8, "n_attn_blocks": 1}


def test_absorbing_forward_sampling_at_width_256_matches_jax():
    """AbsorbingFlow with its survival head 256 wide with 8 heads and one
    block (the trunk one EPiC block): the port's gate is on, and `forward_sampling` (CPU: K1's
    and K6's plain versions) matches JAX's with `use_pallas=True`
    (interpret mode), head by head, rtol = atol = 2e-4."""
    n = 16
    jax_model, params, model, batch = absorbing_pair(
        seed=3, n=n, b=4, drawn_init=True, vector_noise=True,
        sections={"generator": WIDE_HEADS, "encoder": CUT})
    rng = np.random.default_rng(2)
    mask = _mask(rng, 4, n)
    t = rng.uniform(0.05, 0.95, (4, 1, 1)).astype(np.float32)
    x = (np.asarray(batch.source_continuous) * mask).astype(np.float32)
    k = (np.asarray(batch.source_discrete) * mask).astype(np.int32)
    jax_model.config.parallel.use_pallas = model.config.parallel.use_pallas = True
    assert model._pallas_enabled("cuda") and survival_pallas.survival_pallas_supported(
        jax_model.config)
    calls = epic_cuda.epic_forward_reference.calls, survival_cuda.survival_head_reference.calls
    ref = jax_model.forward_sampling(params, JaxState(*map(jnp.asarray, (t, x, k, mask))), batch)
    got = model.forward_sampling(AbsorbingBridgeState(
        *map(torch.from_numpy, (t, x, k.astype(np.int64), mask.astype(np.int64)))))
    assert epic_cuda.epic_forward_reference.calls == calls[0] + 1
    assert survival_cuda.survival_head_reference.calls == calls[1] + 1
    for name in ("continuous", "discrete", "absorbing"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   err_msg=name, **TOL)


def test_transdim_forward_kernel_at_width_256_matches_jax():
    """The transdimensional network with its gsdm stacks 256 wide with 8
    heads and one block (the trunk one EPiC block): the port's gate is on, and
    `forward_kernel` (CPU: K1's and K7's plain versions, one K1 and two K7
    calls) matches `_network_fused` in interpret mode; atol = rtol = 5e-4."""
    n, b = 16, 4
    jax_model, params, model, batch = transdim_pair(
        seed=2, n=n, b=b, drawn_init=True, vector_noise=True,
        sections={"encoder": {**WIDE_HEADS, **CUT}})
    rng = np.random.default_rng(1)
    noisy = [batch[0], batch[1], (batch[2] + 0.3 * rng.standard_normal(batch[2].shape).astype(
        np.float32)) * (batch[2].sum(-1, keepdims=True) > 0)]
    ts = rng.uniform(0.05, 1.0, b).astype(np.float32)
    nearest = np.minimum(rng.integers(0, n, b), noisy[0] - 1).astype(np.int32)
    jax_model.config.parallel.use_pallas = model.config.parallel.use_pallas = True
    assert model._pallas_enabled("cuda") and jax_model._pallas_enabled()
    ref = jax_model._network_fused(params["network"], jax_structure.state_from_list_batch(noisy),
                                   jnp.asarray(ts), jnp.asarray(nearest), False, None,
                                   interpret=True)
    calls = epic_cuda.epic_forward_reference.calls, gsdm_stack_cuda.gsdm_stack_reference.calls
    got = model.forward_kernel(structure.state_from_list_batch(list(map(torch.from_numpy, noisy))),
                               torch.from_numpy(ts), torch.from_numpy(nearest).long())
    assert epic_cuda.epic_forward_reference.calls == calls[0] + 1
    assert gsdm_stack_cuda.gsdm_stack_reference.calls == calls[1] + 2
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=5e-4, atol=5e-4)


# ------------------------------------------------------------------ gates

GRID_C = (96, 128, 256, 384, 512, 640)
GRID_HEADS = (1, 2, 3, 4, 6, 8, 16, 32, 64, 128, 256)


def _in_scope(C, heads):
    return C in (128, 256, 384, 512) and C % heads == 0 and C // heads <= 128


@pytest.mark.parametrize("n", [109, 128, 129, 200, 256, 257])
def test_gates_equal_jax_inside_the_scope_and_refuse_outside(n):
    """On a grid of (C, heads, N, K6's trunk hidden width): inside the scope
    (C of 128 … 512, heads of at most 128 channels that divide C, N ≤ 256,
    any trunk hidden width) the port's K6, K7 and K8 gates say what JAX's
    say, which is True; outside it the port's say False, wherever JAX's may
    stand."""
    inside = 0
    for C in GRID_C:
        for heads in GRID_HEADS:
            scope = _in_scope(C, heads) and n <= 256
            for hidden in (16, 24, 300):
                jax_abs = AbsorbingConfig()
                jax_abs.generator.transformer_dim, jax_abs.generator.n_heads = C, heads
                jax_abs.data.max_num_particles, jax_abs.encoder.dim_hidden_local = n, hidden
                ours = TorchAbsorbingConfig.from_dict(jax_abs.to_dict())
                jax_on = survival_pallas.survival_pallas_supported(jax_abs)
                k6_scope = scope  # any trunk hidden width
                assert not k6_scope or jax_on, (C, heads, hidden)
                assert survival_cuda.survival_supported(ours) == (jax_on and k6_scope), (
                    C, heads, hidden)
                inside += k6_scope
            jax_td = TransdimensionalEpicConfig()
            jax_td.encoder.transformer_dim, jax_td.encoder.n_heads = C, heads
            jax_td.data.max_num_particles = n
            jax_td.parallel.use_pallas = True
            ours = TorchTransdimConfig.from_dict(jax_td.to_dict())
            jax_on = JaxTransdim(jax_td)._pallas_enabled()
            assert not scope or jax_on, (C, heads)
            assert gsdm_stack_cuda.gsdm_stack_supported(ours) == (jax_on and scope), (C, heads)
            # JAX's attention core takes every shape (attention_pallas.py:135-151)
            assert attention_cuda.attention_core_supported((2, n, C), heads) == scope
    assert (inside > 0) == (n <= 256)
