"""The arithmetic of the tensor-core kernels K8 (attention core) and K4 (wide
EPiC forward) on the CPU: their products run as the 3×TF32 split
(multimodal_particles_tpu_torch/ops/csrc/tf32x3.cuh), which the CPU cannot
execute, so a plain model of it (tests/torch_port_helpers.py: rounding to
10 mantissa bits, the hi/lo split, three products accumulated in float32) is
held against a float64 product at each kernel's shapes and gate:

* K8: seeded q, k, v at B=8, N=128, C=128, head widths 32, 64 and 128, with
  and without the −1e9 key bias of a masked key; gate atol 2e-5 (the JAX
  kernel's test's, tests/test_ops/test_attention_pallas.py:26). One TF32
  product does not hold that gate: the reason for the split.
  Both operands are split by `cvt.rna` rounding.
* K4: the per-particle products on the tensor cores (the particle third of
  fc_local1, fc_local2) on the activations and weights of the port's plain
  wide forward of a seeded scaled model (every width 128, 2 blocks, B=4,
  N=128); the activations split by truncation, as the kernel splits them,
  the weights by rounding, as the packing lays them out; gate per particle
  |err| ≤ 1e-4 + 1e-4·max|ref| over the particle's row, as K4's against its
  plain version. One TF32 product misses it too.

Last, what the wide packing carries for K4 (`PackedEncoder.tensor_core`,
ops/epic_cuda.py::tensor_core_weights): the weights as TF32 hi and lo halves
in the tensor cores' order, and local_0's particle two thirds folded with
the embeddings into tables, which K4 reads in fp32 off the tensor cores.
"""

import numpy as np
import pytest
import torch

from multimodal_particles_tpu_torch.config_classes import MultimodalBridgeMatchingConfig
from multimodal_particles_tpu_torch.models.generative.init import init_mbm_parameters
from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (
    MultiModalBridgeMatching,
)
from multimodal_particles_tpu_torch.ops.attention_cuda import key_bias
from multimodal_particles_tpu_torch.ops.epic_cuda import epic_forward_reference
from multimodal_particles_tpu_torch.ops.epic_wide_cuda import pack_wide_encoder_params
from tests.torch_port_helpers import (
    attention_core_model,
    tf32_matmul,
    tf32_round,
    tf32_split,
    tf32_split_truncated,
    tf32x3_matmul,
)

K8_ATOL = 2e-5
K4_ATOL = K4_RTOL = 1e-4


@pytest.mark.parametrize("split", ["rounded", "truncated"])
def test_tf32_split_keeps_ten_mantissa_bits_a_half(split):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal(10_000) * 10.0 ** rng.integers(-8, 8, 10_000),
                     dtype=torch.float32)
    hi, lo = (tf32_split if split == "rounded" else tf32_split_truncated)(x)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    if split == "rounded":
        assert ((x - hi).abs() <= 2.0**-11 * x.abs()).all()  # half a TF32 ulp
        # hi + lo holds x to 2⁻²² of it or better
        assert ((x.double() - hi.double() - lo.double()).abs()
                <= 2.0**-22 * x.abs().double()).all()
        # ties go away from zero
        one_and_half_ulp = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11)])
        assert tf32_round(one_and_half_ulp).tolist() == [1.0 + 2.0**-10, -(1.0 + 2.0**-10)]
    else:
        assert ((x - hi).abs() < 2.0**-10 * x.abs()).all()  # under one TF32 ulp
        assert (hi.abs() <= x.abs()).all() and (hi * x >= 0).all()  # toward zero
        # hi + lo holds x to 2⁻²⁰ of it or better
        assert ((x.double() - hi.double() - lo.double()).abs()
                <= 2.0**-20 * x.abs().double()).all()


def attention_inputs(n_heads, masked, B=8, N=128, C=128, seed=0):
    rng = np.random.default_rng(seed + n_heads)
    q, k, v = (torch.tensor(rng.standard_normal((B, N, C)), dtype=torch.float32) for _ in range(3))
    mask = None
    if masked:
        mask = torch.tensor(rng.random((B, N, 1)) < 0.6, dtype=torch.float32)
        mask[0] = 0.0  # a wholly masked jet
    bias = key_bias(mask, B, N, q)
    ref = attention_core_model(q.double(), k.double(), v.double(), bias.double(), n_heads,
                               torch.matmul)
    return q, k, v, bias, ref


@pytest.mark.parametrize("n_heads", [4, 2, 1], ids=["hd32", "hd64", "hd128"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_split_holds_k8_gate(n_heads, masked):
    q, k, v, bias, ref = attention_inputs(n_heads, masked)
    got = attention_core_model(q, k, v, bias, n_heads, tf32x3_matmul)
    assert (got.double() - ref).abs().max().item() <= K8_ATOL


@pytest.mark.parametrize("n_heads", [4, 2, 1], ids=["hd32", "hd64", "hd128"])
def test_one_tf32_product_misses_k8_gate(n_heads):
    q, k, v, bias, ref = attention_inputs(n_heads, masked=True)
    got = attention_core_model(q, k, v, bias, n_heads, tf32_matmul)
    assert (got.double() - ref).abs().max().item() > K8_ATOL


def wide_products():
    """(name, A, W) of every per-particle product K4 runs on the tensor cores,
    recorded from the plain wide forward of a seeded scaled model (2 blocks):
    A (B·N, K) the particle rows, W (K, 128)."""
    config = MultimodalBridgeMatchingConfig()
    e = config.encoder
    e.num_blocks = 2
    e.dim_hidden_local = e.dim_hidden_glob = e.dim_emb_time = 128
    e.dim_emb_features_continuous = e.dim_emb_features_discrete = 128
    model = init_mbm_parameters(MultiModalBridgeMatching(config), 3).eval()
    packed = pack_wide_encoder_params(model.encoder, config)
    rng = np.random.default_rng(4)
    B, N = 4, 128
    mask = torch.tensor(rng.random((B, N, 1)) < 0.8, dtype=torch.float32)
    t = torch.tensor(rng.random((B, 1, 1)), dtype=torch.float32)
    x = torch.tensor(rng.standard_normal((B, N, 3)), dtype=torch.float32) * mask
    k = torch.tensor(rng.integers(0, 8, (B, N, 1))) * mask.long()

    calls = []

    class Record(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if getattr(func, "__name__", "") in ("matmul", "__matmul__") and args[0].dim() == 3 \
                    and args[1].shape[-1] == 128 and args[0].shape[-1] in (128, 384):
                calls.append((args[0].detach().reshape(-1, args[0].shape[-1]), args[1].detach()))
            return out

    with torch.no_grad(), Record():
        epic_forward_reference(packed, t, x, k, mask)
    _, *blocks = calls  # local_0: through the tables, off the tensor cores
    products = []
    for i in range(e.num_blocks):
        (hcat, w_fl1), (l1, w_fl2) = blocks[2 * i], blocks[2 * i + 1]
        products += [(f"fc_local1_{i}", hcat[:, :128], w_fl1[:128]), (f"fc_local2_{i}", l1, w_fl2)]
    return products


WIDE_PRODUCTS = ["fc_local1_0", "fc_local2_0", "fc_local1_1", "fc_local2_1"]


@pytest.fixture(scope="module")
def recorded_wide_products():
    products = {name: (a, w) for name, a, w in wide_products()}
    assert list(products) == WIDE_PRODUCTS
    return products


@pytest.mark.parametrize("name", WIDE_PRODUCTS)
def test_one_tf32_product_misses_k4_gate(recorded_wide_products, name):
    a, w = recorded_wide_products[name]
    ref = a.double() @ w.double()
    err = (tf32_matmul(a, w).double() - ref).abs()
    bound = K4_ATOL + K4_RTOL * ref.abs().amax(dim=-1, keepdim=True)
    assert (err > bound).any()


@pytest.mark.parametrize("name", WIDE_PRODUCTS)
def test_split_holds_k4_gate(recorded_wide_products, name):
    a, w = recorded_wide_products[name]
    assert a.shape[1] == w.shape[0] and w.shape[1] == 128
    ref = a.double() @ w.double()
    err = (tf32x3_matmul(a, w, split_a=tf32_split_truncated).double() - ref).abs()
    bound = K4_ATOL + K4_RTOL * ref.abs().amax(dim=-1, keepdim=True)
    assert (err <= bound).all(), (err / bound).max().item()


# ---- the weights K4 reads (ops/epic_cuda.py::tensor_core_weights), made
# where the wide packing is built


def scaled_packing(kind):
    """A seeded scaled packing, 2 blocks: MBM's (tokens) or the transdim
    trunk's (the folded Linear-discrete input)."""
    from multimodal_particles_tpu_torch.config_classes import TransdimensionalEpicConfig
    from multimodal_particles_tpu_torch.models.generative.init import (
        init_transdimensional_parameters,
    )
    from multimodal_particles_tpu_torch.models.generative.transdimensional.transdimensional_model import (
        TransdimensionalJumpDiffusion,
    )

    config = MultimodalBridgeMatchingConfig() if kind == "tokens" else TransdimensionalEpicConfig()
    e = config.encoder
    e.num_blocks = 2
    e.dim_hidden_local = e.dim_hidden_glob = e.dim_emb_time = 128
    e.dim_emb_features_continuous = e.dim_emb_features_discrete = 128
    if kind == "tokens":
        model = init_mbm_parameters(MultiModalBridgeMatching(config), 5)
        return pack_wide_encoder_params(model.encoder, config)
    model = init_transdimensional_parameters(TransdimensionalJumpDiffusion(config), 5)
    trunk, _, _ = model.pack_for_kernel()
    return trunk


@pytest.mark.parametrize("kind", ["tokens", "fold"])
def test_tensor_core_stages_hold_each_weight_in_core_matrix_order(kind):
    packed = scaled_packing(kind)
    stages, _ = packed.tensor_core
    views = packed.tensors
    # per layer fc_local1's particle third, then fc_local2: 16 stages of 2048 floats each
    assert stages.numel() == packed.dims.num_blocks * 2 * 16 * 2048
    # (matrix, stage, hi/lo, output group, input group, output row, input row)
    per_matrix = stages.reshape(-1, 16, 2, 16, 2, 8, 4)
    for m, w in enumerate([views[f"w_{name}_{i}"] for i in range(packed.dims.num_blocks)
                           for name in ("fl1", "fl2")]):
        w_in_out = w[:, :128].T  # (in, out)
        hi, lo = per_matrix[m, :, 0], per_matrix[m, :, 1]
        # element (stage s, n-group i, k-group j, row r, column c) is w[8s + 4j + c, 8i + r]
        s, i, j, r, c = 3, 5, 1, 6, 2
        assert hi[s, i, j, r, c] == tf32_round(w_in_out[8 * s + 4 * j + c, 8 * i + r])
        back = (hi.double() + lo.double()).permute(0, 2, 4, 1, 3).reshape(128, 128)
        assert ((back - w_in_out.double()).abs() <= 2.0**-22 * w_in_out.abs().double()).all()
        assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()


@pytest.mark.parametrize("kind", ["tokens", "fold"])
def test_local0_tables_give_the_particle_two_thirds_of_local0(kind):
    packed = scaled_packing(kind)
    W = packed.tensors
    _, tables = packed.tensor_core
    t_x, t_k, c = tables[:384].reshape(3, 128), tables[384:1408].reshape(8, 128), tables[1408:]
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.standard_normal((64, 3)), dtype=torch.float64)
    if kind == "fold":
        k_in = torch.tensor(rng.standard_normal((64, 8)), dtype=torch.float64)
        k_emb = k_in @ W["table"].double() + W["b_k"].double()
    else:
        k_in = torch.nn.functional.one_hot(torch.tensor(rng.integers(0, 8, 64)), 8).double()
        k_emb = k_in @ W["table"].double()
    x_emb = x @ W["w_x"].double().T + W["b_x"].double()
    ref = torch.cat([x_emb, k_emb], dim=-1) @ W["w_l0"].double()[:, 128:].T
    got = x @ t_x.double() + k_in @ t_k.double() + c.double()
    bound = K4_ATOL + K4_RTOL * ref.abs().amax(dim=-1, keepdim=True)
    assert ((got - ref).abs() <= bound).all()


@pytest.mark.parametrize("kind", ["tokens", "fold"])
def test_wide_packing_carries_k4_weights_and_only_it(kind):
    """The wide packing, however built (the packer, the model's
    `pack_for_kernel`), carries K4's weights made from its buffer: per layer
    2 × 16 stages of 2048 floats, then the tables (3 + 8 + 1 rows of 128);
    `rebind`, the same weights over another buffer, keeps them. A narrow
    packing carries none."""
    from multimodal_particles_tpu_torch.ops.epic_cuda import (
        pack_mbm_encoder_params,
        tensor_core_weights,
    )

    packed = scaled_packing(kind)
    stages, tables = packed.tensor_core
    nb = packed.dims.num_blocks
    assert stages.shape == (nb * 2 * 16 * 2048,) and tables.shape == ((3 + 8 + 1) * 128,)
    assert all(a.dtype == torch.float32 and a.is_contiguous() for a in (stages, tables))
    made = tensor_core_weights(packed.flat.clone(), packed.dims)
    assert all(torch.equal(a, b) for a, b in zip(packed.tensor_core, made))
    leaf = packed.rebind(packed.flat.clone().requires_grad_(True))
    assert leaf.tensor_core is packed.tensor_core and leaf.layout == "wide"
    if kind == "tokens":
        config = MultimodalBridgeMatchingConfig()
        model = init_mbm_parameters(MultiModalBridgeMatching(config), 5)
        assert pack_mbm_encoder_params(model.encoder, config).tensor_core is None
