"""K5, the wide EPiC backward, on the tensor cores
(ops/csrc/epic_wide_backward.cu), checked on the CPU, which cannot run it:

* the transposed stages it reads for dz·Wᵀ, which its wrapper makes
  (ops/epic_wide_vjp_cuda.py::tensor_core_transposed_stages): per layer fc_local2 and
  fc_local1's particle third transposed, each as TF32 hi/lo K-major core
  matrices in the order of the forward's stages;
* a float64 model of the kernel's arithmetic (tests/torch_port_helpers.py::
  wide_backward_model: the port's plain forward with fc_local1's particle
  third and fc_local2 taken as the kernel takes them, the rerun as K4's
  wgmma, dz·Wᵀ with dz split by truncation and the transposed weights
  rounded, aᵀ·dz with both operands truncated, differentiated by autograd)
  against the JAX package's own K5 in interpret mode
  (ops/epic_pallas_wide_vjp.py, jax.vjp), at the scaled backbone (6 blocks)
  and at 2 blocks, B=8, N=16, under K5's per-leaf gate
  |err| ≤ 1e-4·max|ref leaf| + 1e-3·|ref|.

One TF32 product (a_hi·w_hi alone, in every product) misses that gate: the
weight gradients sum 128 particles' products of cotangents that cancel. The
test measures and asserts it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_particles_tpu.ops.epic_pallas import WEIGHT_NAMES
from multimodal_particles_tpu.ops.epic_pallas_wide import pack_wide_encoder_params as jax_pack_wide
from multimodal_particles_tpu.ops.epic_pallas_wide_vjp import make_epic_train_forward_wide
from multimodal_particles_tpu_torch.ops.epic_cuda import tf32_round, wide_flat_views
from multimodal_particles_tpu_torch.ops.epic_wide_cuda import pack_wide_encoder_params
from multimodal_particles_tpu_torch.ops.epic_wide_vjp_cuda import tensor_core_transposed_stages
from torch_port_helpers import B, N, model_pair, random_state, to_torch, wide_backward_model

WIDE = dict(dim_hidden_local=128, dim_hidden_glob=128, dim_emb_time=128,
            dim_emb_features_continuous=128, dim_emb_features_discrete=128)


@pytest.fixture(scope="module", params=[6, 2], ids=["scaled_6_blocks", "2_blocks"])
def case(request):
    """(the port's wide packing, the JAX K5 gradient by leaf name (in, out),
    inputs, cotangent) at `request.param` EPiC blocks."""
    jax_model, params, torch_model, _ = model_pair(num_blocks=request.param, **WIDE)
    cfg = jax_model.config
    fused = make_epic_train_forward_wide(
        num_blocks=cfg.encoder.num_blocks, use_skip=cfg.encoder.skip_connection,
        add_discrete_head=cfg.encoder.add_discrete_head, dim_c=3, vocab=8,
        hidden=cfg.encoder.dim_hidden_local, dim_emb_time=cfg.encoder.dim_emb_time,
        interpret=True)
    t, x, k, mask = random_state()
    g = np.random.default_rng(9).standard_normal((B, N, 11)).astype(np.float32)
    _, vjp = jax.vjp(lambda p: fused(p, *map(jnp.asarray, (t, x, k, mask))),
                     jax_pack_wide(params["encoder"], cfg.encoder.num_blocks))
    (cot,) = vjp(jnp.asarray(g))
    ref = dict(zip(WEIGHT_NAMES, (np.asarray(c) for c in cot)))
    with torch.no_grad():
        packed = pack_wide_encoder_params(torch_model.encoder, torch_model.config)
    return packed, ref, to_torch(t, x, k, mask, g)


def worst_share(packed, ref, d_flat):
    """The worst leaf error of d_flat against the JAX gradient as a share of
    K5's per-leaf gate."""
    worst = 0.0
    for name, value in wide_flat_views(d_flat, packed.dims).items():
        base, _, layer = name.rpartition("_")
        r = ref[base][int(layer)] if layer.isdigit() else ref[name]
        got = (value.T if value.dim() == 2 and name != "table" else value).numpy().reshape(r.shape)
        bound = 1e-4 * max(float(np.abs(r).max()), 1e-6) + 1e-3 * np.abs(r)
        worst = max(worst, float((np.abs(got - r) / bound).max()))
    return worst


def test_split_model_holds_k5_gate_against_pallas_vjp(case):
    packed, ref, inputs = case
    assert worst_share(packed, ref, wide_backward_model(packed, *inputs)) <= 1.0


def test_one_tf32_product_misses_k5_gate(case):
    packed, ref, inputs = case
    assert worst_share(packed, ref, wide_backward_model(packed, *inputs, one_product=True)) > 1.0


def test_transposed_stages_hold_each_weight_in_core_matrix_order(case):
    packed, _, _ = case
    stages = tensor_core_transposed_stages(packed.flat, packed.dims)
    nb = packed.dims.num_blocks
    assert stages.dtype == torch.float32 and stages.is_contiguous()
    assert stages.numel() == nb * 2 * 16 * 2048
    assert torch.equal(stages, tensor_core_transposed_stages(packed.flat.clone(), packed.dims))
    # (matrix, stage, hi/lo, output group, input group, output row, input row)
    per_matrix = stages.reshape(-1, 16, 2, 16, 2, 8, 4)
    views = packed.tensors  # (out, in): the backward product's (in, out)
    for mtx, w in enumerate([v for i in range(nb)
                             for v in (views[f"w_fl2_{i}"], views[f"w_fl1_{i}"][:, :128])]):
        hi, lo = per_matrix[mtx, :, 0], per_matrix[mtx, :, 1]
        # element (stage s, n-group i, k-group j, row r, column c) is w[8s + 4j + c, 8i + r]
        s, i, j, r, c = 7, 2, 1, 5, 3
        assert hi[s, i, j, r, c] == tf32_round(w[8 * s + 4 * j + c, 8 * i + r])
        back = (hi.double() + lo.double()).permute(0, 2, 4, 1, 3).reshape(128, 128)
        assert ((back - w.double()).abs() <= 2.0**-22 * w.abs().double()).all()
        assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()


def test_backward_wrapper_refuses_a_packing_without_k4_weights(case):
    """On `meta` tensors the wide backward refuses a packing without K4's
    tensor-core stages and tables, which its rerun reads (a bare
    PackedEncoder over the buffer), before it builds anything."""
    from multimodal_particles_tpu_torch.ops.epic_cuda import PackedEncoder
    from multimodal_particles_tpu_torch.ops.epic_wide_vjp_cuda import epic_backward_wide

    packed, _, _ = case
    bare = PackedEncoder(packed.flat.to("meta"), {}, packed.dims, "wide")
    t = torch.empty((B, 1, 1), device="meta")
    x = torch.empty((B, N, 3), device="meta")
    k = torch.empty((B, N, 1), dtype=torch.int32, device="meta")
    mask = torch.empty((B, N, 1), device="meta")
    g = torch.empty((B, N, 11), device="meta")
    with pytest.raises(ValueError, match="tensor-core stages and tables"):
        epic_backward_wide(bare, t, x, k, mask, g)
