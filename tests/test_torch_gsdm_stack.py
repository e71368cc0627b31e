"""The gsdm stack of the PyTorch/CUDA port against the JAX package on the CPU:
the stack's packing and time rows, and the plain version of the fused kernel
(ops/gsdm_stack_cuda.py) against the interpret-mode Pallas kernel and the flax
stack. float32 on both sides; each test states its tolerance. The CUDA kernel
itself is held against the plain version on a card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_particles_tpu.models.architectures import gsdm as jax_gsdm
from multimodal_particles_tpu.ops import gsdm_stack_pallas as jax_stack
from multimodal_particles_tpu_torch.config_classes import TransdimensionalEpicConfig
from multimodal_particles_tpu_torch.models.architectures import gsdm
from multimodal_particles_tpu_torch.ops import gsdm_stack_cuda, survival_cuda
from torch_port_helpers import noisy_params, to_torch

C, N_BLOCKS, N_HEADS = 128, 2, 2
TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_ops/test_gsdm_stack_pallas.py:72


class _FlaxStack(nn.Module):
    """proj_in → n × (ResnetBlock, AttnBlock), the transdimensional heads'
    pattern (tests/test_ops/test_gsdm_stack_pallas.py:25-37)."""

    @nn.compact
    def __call__(self, x_in, temb):
        h = nn.Dense(C, name="proj_in")(x_in)
        for i in range(N_BLOCKS):
            h = jax_gsdm.ResnetBlock(channels=C, dropout=0.0, temb_channels=C,
                                     name=f"res_{i}")(h, temb)
            h = jax_gsdm.AttnBlock(C, N_HEADS, name=f"attn_{i}")(h)
        return h


class _Stack(torch.nn.Module):
    def __init__(self, dim_in):
        super().__init__()
        self.proj_in = torch.nn.Linear(dim_in, C)
        for i in range(N_BLOCKS):
            self.add_module(f"res_{i}", gsdm.ResnetBlock(C, dropout=0.0, temb_channels=C))
            self.add_module(f"attn_{i}", gsdm.AttnBlock(C, n_heads=N_HEADS))

    def blocks(self):
        return ([getattr(self, f"res_{i}") for i in range(N_BLOCKS)],
                [getattr(self, f"attn_{i}") for i in range(N_BLOCKS)])


def _transplant(module, params):
    state = {}
    for path, value in jax.tree_util.tree_flatten_with_path(params)[0]:
        *parents, leaf = [p.key for p in path]
        name = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
        value = np.asarray(value)
        state[".".join(parents + [name])] = torch.from_numpy(
            np.array(value.T if leaf == "kernel" else value, order="C"))
    module.load_state_dict(state)
    return module


def _case(n, b, dim_in, seed=0):
    rng = np.random.default_rng(seed)
    x_in = rng.standard_normal((b, n, dim_in)).astype(np.float32)
    temb = rng.standard_normal((b, C)).astype(np.float32)
    flax_stack = _FlaxStack()
    params = noisy_params(flax_stack.init(jax.random.PRNGKey(seed), x_in, temb)["params"], seed)
    return flax_stack, params, _transplant(_Stack(dim_in), params), x_in, temb


def _jax_blocks(params):
    return ([params[f"res_{i}"] for i in range(N_BLOCKS)],
            [params[f"attn_{i}"] for i in range(N_BLOCKS)])


@pytest.mark.parametrize("dim_in", [27, 24])
@pytest.mark.parametrize("n,b", [(128, 4), (40, 4), (40, 7)])
def test_plain_stack_matches_pallas_interpret_and_flax(n, b, dim_in):
    """`gsdm_stack` on CPU tensors (its plain version) against the
    interpret-mode Pallas kernel and the flax stack, at the reference N and a
    ragged one, an odd batch, both stack input widths; atol = rtol = 2e-4,
    the JAX kernel's own test's tolerance."""
    _check_plain_stack(n, b, dim_in)


@pytest.mark.parametrize("n,dim_in", [(256, 27)])
def test_plain_stack_past_128_slots_matches_pallas_interpret_and_flax(n, dim_in):
    """The same at N = 256 (two row blocks a jet on the card), two jets;
    N = 200 (which the Pallas kernel pads to 256 slots) is held through the
    transdimensional network's kernel path at both stack input widths
    (tests/test_torch_transdim.py)."""
    _check_plain_stack(n, 2, dim_in)


def _check_plain_stack(n, b, dim_in):
    flax_stack, params, module, x_in, temb = _case(n, b, dim_in)
    res_p, attn_p = _jax_blocks(params)
    pallas = jax_stack.gsdm_stack_pallas(
        jax_stack.pack_gsdm_stack_params(params["proj_in"], res_p, attn_p),
        jax_stack.stack_time_embeddings(jnp.asarray(temb), res_p), jnp.asarray(x_in),
        n_blocks=N_BLOCKS, n_heads=N_HEADS, transformer_dim=C, interpret=True)
    flax_out = flax_stack.apply({"params": params}, jnp.asarray(x_in), jnp.asarray(temb))
    x_t, temb_t = to_torch(x_in, temb)
    before = gsdm_stack_cuda.gsdm_stack_reference.calls
    with torch.no_grad():
        packed = gsdm_stack_cuda.pack_gsdm_stack_params(module.proj_in, *module.blocks())
        tp = gsdm_stack_cuda.stack_time_embeddings(temb_t, module.blocks()[0])
        got = gsdm_stack_cuda.gsdm_stack(packed, tp, x_t, n_heads=N_HEADS).numpy()
    assert gsdm_stack_cuda.gsdm_stack_reference.calls == before + 1  # CPU tensors: the plain version
    assert got.shape == (b, n, C) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(flax_out), **TOL)


@pytest.mark.parametrize("dim_in", [136, 139, 200])
def test_plain_stack_at_wide_inputs_matches_pallas_interpret(dim_in):
    """The stacks of the `--scaled` transdimensional network read inputs wider
    than the kernel's 128-column tile (trunk hidden 128 ‖ V = 136, ‖ 3 more =
    139; 200 for two full passes and a ragged one): the plain version against
    the interpret-mode Pallas kernel, which takes any width, at N = 13, B = 3;
    the packing pads proj_in's weight to 144 (208) rows; atol = rtol = 2e-4."""
    flax_stack, params, module, x_in, temb = _case(13, 3, dim_in, seed=2)
    res_p, attn_p = _jax_blocks(params)
    pallas = jax_stack.gsdm_stack_pallas(
        jax_stack.pack_gsdm_stack_params(params["proj_in"], res_p, attn_p),
        jax_stack.stack_time_embeddings(jnp.asarray(temb), res_p), jnp.asarray(x_in),
        n_blocks=N_BLOCKS, n_heads=N_HEADS, transformer_dim=C, interpret=True)
    x_t, temb_t = to_torch(x_in, temb)
    with torch.no_grad():
        packed = gsdm_stack_cuda.pack_gsdm_stack_params(module.proj_in, *module.blocks())
        tp = gsdm_stack_cuda.stack_time_embeddings(temb_t, module.blocks()[0])
        got = gsdm_stack_cuda.gsdm_stack(packed, tp, x_t, n_heads=N_HEADS).numpy()
    assert tuple(packed.tensors["w_in"].shape) == (-(-dim_in // 16) * 16, C)
    assert not packed.tensors["w_in"][dim_in:].any()
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


def test_pack_gsdm_stack_params_leaf_by_leaf():
    """The port's packed leaves are the JAX packing's, in its order (vectors
    there are (1, C) rows), bit for bit; proj_in's weight carries zero rows up
    to a multiple of 16; `flat` is the leaves' concatenation."""
    _, params, module, _, _ = _case(16, 2, 27)
    theirs = jax_stack.pack_gsdm_stack_params(params["proj_in"], *_jax_blocks(params))
    ours = gsdm_stack_cuda.pack_gsdm_stack_params(module.proj_in, *module.blocks())
    layout = gsdm_stack_cuda.stack_layout(27, N_BLOCKS)
    assert len(theirs) == len(layout) == len(ours.tensors)
    assert layout[0] == ("w_in", (32, C)) and gsdm_stack_cuda.padded_width(24) == 32
    assert gsdm_stack_cuda.padded_width(16) == 16 and gsdm_stack_cuda.padded_width(128) == 128
    np.testing.assert_array_equal(ours.tensors["w_in"][:27].numpy(), np.asarray(theirs[0]))
    assert not ours.tensors["w_in"][27:].any()
    for (name, shape), leaf in list(zip(layout, theirs))[1:]:
        np.testing.assert_array_equal(ours.tensors[name].numpy(),
                                      np.asarray(leaf).reshape(shape), err_msg=name)
    assert ours.flat.numel() == sum(int(np.prod(s)) for _, s in layout)
    assert ours.flat.is_contiguous() and ours.flat.dtype == torch.float32
    assert (ours.dim_in, ours.n_blocks) == (27, N_BLOCKS)


def test_stack_time_embeddings_match_jax():
    """res_i.temb_proj(swish(temb)) from an already projected temb, 1e-5."""
    _, params, module, _, temb = _case(16, 3, 24, seed=1)
    theirs = jax_stack.stack_time_embeddings(jnp.asarray(temb), _jax_blocks(params)[0])
    with torch.no_grad():
        ours = gsdm_stack_cuda.stack_time_embeddings(torch.from_numpy(temb), module.blocks()[0])
    assert len(ours) == len(theirs) == N_BLOCKS
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_survival_head_and_stack_share_the_block_packing():
    """One layout and one packing of a (ResnetBlock, AttnBlock) pair for both
    kernels: the survival head's block entries are the stack's."""
    stack = [name for name, _ in gsdm_stack_cuda.stack_layout(24, 2)][2:]
    head = [name for name, _ in survival_cuda.head_layout(16, 2)][4:-4]
    assert stack == head == [n for i in range(2) for n, _ in gsdm_stack_cuda.block_layout(i)]
    assert survival_cuda.block_weights is gsdm_stack_cuda.block_weights
    assert survival_cuda.CHANNELS == gsdm_stack_cuda.CHANNELS == 128


def _config(**encoder):
    config = TransdimensionalEpicConfig()
    for name, value in encoder.items():
        setattr(config.encoder, name, value)
    return config


@pytest.mark.parametrize("encoder,n,expected", [
    ({}, 128, True),
    ({"n_heads": 4}, 128, True),
    ({"transformer_dim": 256}, 128, True),  # a cluster of two blocks a jet
    ({"n_heads": 3}, 128, False),
    ({"n_heads": 8}, 128, True),  # heads of 16 channels
    ({"n_attn_blocks": 0}, 128, False),
    ({}, 129, True),  # two row blocks a jet
    ({}, 256, True),
    ({}, 257, False),
    ({"dim_hidden_local": 64}, 128, True),
    ({"dim_hidden_local": 128}, 128, True),  # stack inputs of 136 and 139 columns
])
def test_gsdm_stack_supported(encoder, n, expected):
    config = _config(**encoder)
    config.data.max_num_particles = n
    assert gsdm_stack_cuda.gsdm_stack_supported(config) is expected


def test_gsdm_stack_supported_refuses_a_model_axis():
    config = _config()
    config.parallel.model_axis = 2
    assert not gsdm_stack_cuda.gsdm_stack_supported(config)


def _meta_case(n=16, b=2, dim_in=24):
    _, _, module, x_in, temb = _case(n, b, dim_in)
    with torch.no_grad():
        packed = gsdm_stack_cuda.pack_gsdm_stack_params(module.proj_in, *module.blocks())
        tp = gsdm_stack_cuda.stack_time_embeddings(torch.from_numpy(temb), module.blocks()[0])
    return packed, tp, torch.from_numpy(x_in)


@pytest.mark.parametrize("break_it,error", [
    (lambda p, tp, x: (p, tp, x[..., :20]), ValueError),           # not the packed width
    (lambda p, tp, x: (p, tp, x[0]), ValueError),                  # not (B, N, Din)
    (lambda p, tp, x: (p, tp[:1], x), ValueError),                 # a time row short
    (lambda p, tp, x: (p, tp, x.double()), TypeError),             # not float32
    (lambda p, tp, x: (p, tp, x.transpose(0, 1).contiguous().transpose(0, 1)), ValueError),
    (lambda p, tp, x: (p, (tp[0][:1], tp[1][:1]), x), ValueError),  # time rows of another batch
    (lambda p, tp, x: (p, tp, x.new_zeros((2, 257, 24))), ValueError),  # past 256 slots
])
def test_gsdm_stack_wrapper_refuses(break_it, error):
    """What the wrapper checks before it builds or launches anything, on
    `meta` tensors, which are not on the CPU and so do not take the plain
    version."""
    packed, tp, x = break_it(*_meta_case())
    packed.flat = packed.flat.to("meta")
    with pytest.raises(error):
        gsdm_stack_cuda.gsdm_stack(packed, tuple(t.to("meta") for t in tp), x.to("meta"),
                                   n_heads=N_HEADS)


@pytest.mark.parametrize("n_heads", [3, 5, 0])
def test_gsdm_stack_wrapper_refuses_heads(n_heads):
    packed, tp, x = _meta_case()
    packed.flat = packed.flat.to("meta")
    with pytest.raises(ValueError):
        gsdm_stack_cuda.gsdm_stack(packed, tuple(t.to("meta") for t in tp), x.to("meta"),
                                   n_heads=n_heads)


def test_gsdm_stack_without_a_compiler_raises_and_does_not_fall_back():
    """A tensor that is not on the CPU never reaches the plain version: valid
    `meta` inputs get as far as the build, which raises here (no nvcc)."""
    packed, tp, x = _meta_case()
    packed.flat = packed.flat.to("meta")
    before = gsdm_stack_cuda.gsdm_stack_reference.calls
    with pytest.raises(Exception) as info:
        gsdm_stack_cuda.gsdm_stack(packed, tuple(t.to("meta") for t in tp), x.to("meta"),
                                   n_heads=N_HEADS)
    assert not isinstance(info.value, (ValueError, TypeError))
    assert gsdm_stack_cuda.gsdm_stack_reference.calls == before
    assert gsdm_stack_cuda.gsdm_stack.launches == 0
