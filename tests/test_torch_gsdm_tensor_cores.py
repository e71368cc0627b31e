"""K6 (the survival head) and K7 (the gsdm stack) on the tensor cores, on the
CPU: the weights their kernels read, and their arithmetic.

The kernels (multimodal_particles_tpu_torch/ops/csrc/gsdm_blocks.cuh) read
every matrix from one stream of tensor-core stages a packing carries beside
its flat buffer (`tensor_core`): 8 input rows a stage, as TF32 hi and lo
halves rounded to nearest, in the core-matrix order of K4's stages
(ops/epic_cuda.py::tensor_core_stages); proj_in's rows padded with zeros to a
multiple of 8; a block's matrices in the order the kernel multiplies by them
(conv1, conv2, k, v, q, proj_out); K6's two one-hot rows are not in the
stream (the flat buffer's, a per-row correction).

The arithmetic cannot run here, so a float64 model of it
(tests/torch_port_helpers.py: `survival_head_model`, `gsdm_stack_model`:
each product's float32 activations and weights split by rounding, as the
kernels split them, both attention operands by truncation)
is held against the JAX package's own K6 and K7 in interpret mode, as its
tests run them, at the kernels' gate atol = rtol = 2e-4
(tests/test_ops/test_survival_pallas.py:86-88,
tests/test_ops/test_gsdm_stack_pallas.py:72): at the reference shapes
(K6: trunk hidden 16, N = 109; K7: Din 24 and 27, N = 128) and the `--scaled`
ones (K6: hidden 128; K7: Din 136 and 139). One TF32 product in place of
three misses that gate at each of them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_particles_tpu.ops import gsdm_stack_pallas as jax_stack
from multimodal_particles_tpu.ops import survival_pallas
from multimodal_particles_tpu_torch.ops import gsdm_stack_cuda, survival_cuda
from test_torch_gsdm_stack import N_BLOCKS, N_HEADS, _case, _jax_blocks
from torch_port_helpers import (
    absorbing_pair,
    gsdm_stack_model,
    survival_head_model,
    tf32_round,
    to_torch,
)

TOL = 2e-4
C = 128


def unstage(stream):
    """A stream of stages → (hi, lo), each (rows, 128) in the stream's row
    order: stage s, input group j, output group i, output row r, input row c
    is row 8s + 4j + c, column 8i + r."""
    s = stream.reshape(-1, 2, 16, 2, 8, 4)
    return tuple(s[:, h].permute(0, 2, 4, 1, 3).reshape(-1, C) for h in (0, 1))


def stream_matrices(stream, rows):
    """The stream cut into its matrices of `rows` input rows each, as (hi, lo)."""
    hi, lo = unstage(stream)
    assert hi.shape[0] == sum(rows)
    return list(zip(hi.split(rows), lo.split(rows)))


def assert_holds(hi, lo, w):
    """hi = tf32(w) and lo = tf32(w − hi), both TF32, for a weight (in, out)."""
    assert torch.equal(hi, tf32_round(w))
    assert torch.equal(lo, tf32_round(w - hi))
    for half in (hi, lo):
        assert ((half.view(torch.int32) & 0x1FFF) == 0).all()


def block_matrices(W, i):
    return [W[f"{name}_{i}"] for name in ("w_c1", "w_c2", "wk", "wv", "wq", "wp")]


@pytest.mark.parametrize("dim_in", [24, 27, 136, 139])
def test_k7_stream_holds_each_weight_in_core_matrix_order(dim_in):
    _, _, module, _, _ = _case(8, 2, dim_in)
    packed = gsdm_stack_cuda.pack_gsdm_stack_params(module.proj_in, *module.blocks())
    stream, W = packed.tensor_core, packed.tensors
    assert stream.dtype == torch.float32 and stream.is_contiguous()
    padded = -(-dim_in // 8) * 8
    assert stream.numel() == gsdm_stack_cuda.stream_stages(dim_in, N_BLOCKS) * 2 * 8 * C
    parts = stream_matrices(stream, [padded] + [C] * 6 * N_BLOCKS)
    (hi, lo), *blocks = parts
    # proj_in: its Din rows, then zero rows to a multiple of 8 (27 → 32, 139 → 144)
    assert_holds(hi[:dim_in], lo[:dim_in], W["w_in"][:dim_in])
    assert not hi[dim_in:].any() and not lo[dim_in:].any()
    # one element by its place in the stage: stage 2, input group 1, output group 5, rows 6, 2
    s, j, i, r, c = 2, 1, 5, 6, 2
    assert stream.reshape(-1, 2, 16, 2, 8, 4)[s, 0, i, j, r, c] == tf32_round(
        W["w_in"][8 * s + 4 * j + c, 8 * i + r])
    for b in range(N_BLOCKS):
        for (hi, lo), w in zip(blocks[6 * b:6 * b + 6], block_matrices(W, b)):
            assert_holds(hi, lo, w)


@pytest.mark.parametrize("dim_hidden", [16, 128])
def test_k6_stream_holds_each_weight_and_not_the_one_hot_rows(dim_hidden):
    """K6's stream: proj_in's Dh trunk rows (Dh / 8 stages, no padding), the
    blocks', pre_rate's; the one-hot rows w_oh0, w_oh1 stay in the flat
    buffer, which the kernel's first epilogue reads."""
    sections = {"encoder": {"dim_hidden_local": dim_hidden}} if dim_hidden != 16 else None
    _, _, model, _ = absorbing_pair(seed=2, n=8, b=2, sections=sections)
    packed = survival_cuda.pack_survival_head_params(model.generator, 2)
    stream, W = packed.tensor_core, packed.tensors
    assert packed.dim_hidden == dim_hidden
    assert stream.numel() == survival_cuda.head_stages(dim_hidden, 2) * 2 * 8 * C
    (hi, lo), *blocks, pre = stream_matrices(stream, [dim_hidden] + [C] * 13)
    assert_holds(hi, lo, W["w_in_h"])
    w_in = model.generator.transformer_1_proj_in.weight.T.detach()
    assert torch.equal(w_in[:dim_hidden], W["w_in_h"])
    assert torch.equal(w_in[dim_hidden], W["w_oh0"])
    assert torch.equal(w_in[dim_hidden + 1], W["w_oh1"])
    for b in range(2):
        for (hi, lo), w in zip(blocks[6 * b:6 * b + 6], block_matrices(W, b)):
            assert_holds(hi, lo, w)
    assert_holds(*pre, W["w_pre"])


# ---- the arithmetic: the float64 model of the kernels against the JAX kernels


@pytest.fixture(scope="module", params=[24, 27, 136, 139], ids=lambda d: f"Din{d}")
def k7_case(request):
    """(packed, time rows, input, the interpret-mode Pallas stack's output) at
    N = 128 (the reference stacks' N), B = 2."""
    dim_in = request.param
    _, params, module, x_in, temb = _case(128, 2, dim_in, seed=3)
    res_p, attn_p = _jax_blocks(params)
    pallas = jax_stack.gsdm_stack_pallas(
        jax_stack.pack_gsdm_stack_params(params["proj_in"], res_p, attn_p),
        jax_stack.stack_time_embeddings(jnp.asarray(temb), res_p), jnp.asarray(x_in),
        n_blocks=N_BLOCKS, n_heads=N_HEADS, transformer_dim=C, interpret=True)
    x_t, temb_t = to_torch(x_in, temb)
    with torch.no_grad():
        packed = gsdm_stack_cuda.pack_gsdm_stack_params(module.proj_in, *module.blocks())
        tp = gsdm_stack_cuda.stack_time_embeddings(temb_t, module.blocks()[0])
    return packed, tp, x_t, torch.from_numpy(np.array(pallas)).double()


@pytest.fixture(scope="module", params=[16, 128], ids=lambda d: f"Dh{d}")
def k6_case(request):
    """(packed, time rows, trunk hidden state, mask, the interpret-mode
    Pallas head's logits) at the reference N = 109, B = 2, a random mask."""
    dim_hidden = request.param
    sections = {"encoder": {"dim_hidden_local": dim_hidden}} if dim_hidden != 16 else None
    _, params, model, _ = absorbing_pair(seed=4, n=109, b=2, sections=sections)
    gen_params = params["generator"]
    rng = np.random.default_rng(5)
    t = rng.uniform(0.05, 0.95, (2, 1, 1)).astype(np.float32)
    last = rng.standard_normal((2, 109, dim_hidden)).astype(np.float32)
    mask = (rng.random((2, 109, 1)) < 0.6).astype(np.int32)
    pallas = survival_pallas.survival_head_pallas(
        survival_pallas.pack_survival_head_params(gen_params, 2),
        survival_pallas.project_time_embeddings(gen_params, jnp.asarray(t), 2, C),
        jnp.asarray(last), jnp.asarray(mask), n_blocks=2, n_heads=2, transformer_dim=C,
        interpret=True)
    with torch.no_grad():
        packed = survival_cuda.pack_survival_head_params(model.generator, 2)
        tp = survival_cuda.project_time_embeddings(model.generator, torch.from_numpy(t), 2, C)
    return (packed, tp, torch.from_numpy(last), torch.from_numpy(mask).float(),
            torch.from_numpy(np.array(pallas)).double())


def share_of_gate(got, ref):
    return ((got - ref).abs() / (TOL + TOL * ref.abs())).max().item()


def test_split_holds_k7_gate(k7_case):
    packed, tp, x_in, pallas = k7_case
    with torch.no_grad():
        got = gsdm_stack_model(packed, tp, x_in, N_HEADS)
    assert share_of_gate(got, pallas) <= 1.0


def test_one_tf32_product_misses_k7_gate(k7_case):
    packed, tp, x_in, pallas = k7_case
    with torch.no_grad():
        got = gsdm_stack_model(packed, tp, x_in, N_HEADS, one_product=True)
    assert share_of_gate(got, pallas) > 1.0


def test_split_holds_k6_gate(k6_case):
    packed, tp, last, mask, pallas = k6_case
    with torch.no_grad():
        got = survival_head_model(packed, tp, last, mask, 2)
    assert share_of_gate(got, pallas) <= 1.0


def test_one_tf32_product_misses_k6_gate(k6_case):
    packed, tp, last, mask, pallas = k6_case
    with torch.no_grad():
        got = survival_head_model(packed, tp, last, mask, 2, one_product=True)
    assert share_of_gate(got, pallas) > 1.0
