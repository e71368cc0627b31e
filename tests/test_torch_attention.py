"""The attention core of the PyTorch/CUDA port (ops/attention_cuda.py, the
counterpart of multimodal_particles_tpu/ops/attention_pallas.py) against the
JAX package on the CPU: the plain version against the interpret-mode Pallas
kernel and the einsum oracle `_core_jnp` at the JAX test's shapes
(tests/test_ops/test_attention_pallas.py:15), with a key mask, without one and
with a jet whose every key is masked; the gradients of the differentiable core
against `jax.vjp` of `_core_jnp`; `AttnBlock(use_pallas=True)` against the
flax block, forward and every parameter's gradient; the wrapper's refusals.
The CUDA kernel itself is held against the plain version on a card
(tests/test_torch_cuda.py, chip_smoke.py).

Inputs come from numpy seeds, float32 on both sides. Tolerances: the core
atol 2e-5 (the JAX test's); gradients atol 5e-4, rtol 1e-3 (the JAX test's);
the block atol = rtol = 1e-5, its gradients per leaf |err| ≤ 1e-4·max|ref
leaf| + 1e-3·|ref|, the key bias's against 0 (a shift of a row's scores does
not move the softmax, so both packages hold rounding noise there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_particles_tpu.models.architectures import gsdm as jax_gsdm
from multimodal_particles_tpu.ops.attention_pallas import _core_jnp, attention_core_pallas
from multimodal_particles_tpu_torch.models.architectures import gsdm
from multimodal_particles_tpu_torch.ops import attention_cuda
from torch_port_helpers import noisy_params, to_torch

torch.backends.cuda.matmul.allow_tf32 = False
CORE_ATOL = 2e-5  # tests/test_ops/test_attention_pallas.py:26


def qkv_mask(B, N, C, seed=0, masked=True):
    """q, k, v standard normal; a random key mask with jet 0 wholly masked."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, N, C)).astype(np.float32) for _ in range(3))
    if not masked:
        return q, k, v, None
    mask = (rng.random((B, N, 1)) < 0.5).astype(np.float32)
    mask[0] = 0.0
    return q, k, v, mask


def jax_bias(mask, B, N):
    if mask is None:
        return jnp.zeros((B, 1, N), jnp.float32)
    return jnp.where(jnp.asarray(mask)[..., 0] > 0, 0.0, -1e9)[:, None, :]


@pytest.mark.parametrize("B,N,C,heads", [(8, 128, 128, 2), (4, 109, 128, 2), (8, 64, 128, 1)])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_plain_core_matches_pallas_interpret_and_the_einsum(B, N, C, heads, masked):
    """`attention_core` on CPU tensors (its plain version) against the
    interpret-mode kernel and `_core_jnp`; the masked case has a jet with
    every key masked, whose output is the mean of its values."""
    _check_plain_core(B, N, C, heads, masked)


@pytest.mark.parametrize("N,heads,masked", [(200, 2, False), (256, 1, True)])
def test_plain_core_past_128_slots_matches_pallas_interpret_and_the_einsum(N, heads, masked):
    """The same at N = 200 and 256 (on the card a block a query half, the
    keys in two blocks of 128), two jets, the second case with a wholly
    masked jet."""
    _check_plain_core(2, N, 128, heads, masked)


def _check_plain_core(B, N, C, heads, masked):
    q, k, v, mask = qkv_mask(B, N, C, masked=masked)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = attention_core_pallas(jq, jk, jv, None if mask is None else jnp.asarray(mask),
                                   n_heads=heads, interpret=True)
    oracle = _core_jnp(jq, jk, jv, jax_bias(mask, B, N), heads)
    calls, launches = attention_cuda.attention_core_reference.calls, attention_cuda.attention_core.launches
    got = attention_cuda.attention_core(*to_torch(q, k, v), None if mask is None else torch.from_numpy(mask),
                                        n_heads=heads)
    assert attention_cuda.attention_core_reference.calls == calls + 1
    assert attention_cuda.attention_core.launches == launches
    assert got.shape == (B, N, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=CORE_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=CORE_ATOL, rtol=0)
    if masked:
        np.testing.assert_allclose(got.numpy()[0], np.broadcast_to(v[0].mean(0), (N, C)),
                                   atol=CORE_ATOL, rtol=0)


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_core_gradients_match_jax_vjp(masked):
    """`AttentionCore` (forward: the wrapper; backward: autograd of the
    einsum) against `jax.vjp` of `_core_jnp`, at (4, 32, 128), 2 heads."""
    B, N, C, heads = 4, 32, 128, 2
    q, k, v, mask = qkv_mask(B, N, C, seed=1, masked=masked)
    g = np.random.default_rng(2).standard_normal((B, N, C)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: _core_jnp(a, b, c, jax_bias(mask, B, N), heads),
                     *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(g))
    leaves = [t.requires_grad_(True) for t in to_torch(q, k, v)]
    out = attention_cuda.AttentionCore.apply(*leaves, None if mask is None else torch.from_numpy(mask),
                                             heads)
    out.backward(torch.from_numpy(g))
    for name, leaf, r in zip("qkv", leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), atol=5e-4, rtol=1e-3,
                                   err_msg=name)


def _transplant_block(module, params):
    state = {}
    for layer, leaves in params.items():
        for leaf, value in leaves.items():
            name = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
            state[f"{layer}.{name}"] = torch.from_numpy(
                np.array(value.T if leaf == "kernel" else value, order="C"))
    module.load_state_dict(state)
    return module


@pytest.mark.parametrize("N", [64, 13])
def test_attn_block_with_the_fused_core_matches_flax(N):
    """`AttnBlock(128, 2, use_pallas=True)` (the core's plain version on the
    CPU, its backward autograd of the einsum) against the flax block's
    einsum path on transplanted weights, with a key mask and a wholly masked
    jet: the output and every parameter's gradient."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, N, 128)).astype(np.float32)
    mask = (rng.random((4, N, 1)) < 0.5).astype(np.float32)
    mask[1] = 0.0
    g = rng.standard_normal((4, N, 128)).astype(np.float32)
    block = jax_gsdm.AttnBlock(128, n_heads=2, use_pallas=False)
    params = noisy_params(block.init(jax.random.PRNGKey(4), x, mask)["params"], 4)
    out_j, vjp = jax.vjp(lambda p: block.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask)),
                         params)
    (grads_j,) = vjp(jnp.asarray(g))

    module = _transplant_block(gsdm.AttnBlock(128, n_heads=2, use_pallas=True), params)
    calls = attention_cuda.attention_core_reference.calls
    out = module(torch.from_numpy(x), torch.from_numpy(mask))
    assert attention_cuda.attention_core_reference.calls == calls + 1
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-5, rtol=1e-5)
    out.backward(torch.from_numpy(g))
    for layer, leaves in grads_j.items():
        for leaf, ref in leaves.items():
            name = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
            got = getattr(getattr(module, layer), name).grad.numpy()
            ref = np.asarray(ref).T if leaf == "kernel" else np.asarray(ref)
            if (layer, leaf) == ("k", "bias"):  # zero in exact arithmetic
                scale = np.abs(np.asarray(grads_j["k"]["kernel"])).max()
                assert np.abs(got).max() <= 1e-4 * scale and np.abs(ref).max() <= 1e-4 * scale
                continue
            scale = max(float(np.abs(ref).max()), 1e-6)
            np.testing.assert_allclose(got, ref, atol=1e-4 * scale, rtol=1e-3,
                                       err_msg=f"{layer}.{name}")


def test_core_on_cpu_and_auto_follow_the_jax_switch():
    """use_pallas: False and "auto" on CPU tensors take the einsum path, True
    the core; the two agree; with attn_dim_reduce 2 the core is off."""
    x = torch.randn((3, 20, 128), generator=torch.Generator().manual_seed(5))
    blocks = {flag: gsdm.AttnBlock(128, n_heads=4, use_pallas=flag) for flag in (False, True, "auto")}
    for flag in (True, "auto"):
        blocks[flag].load_state_dict(blocks[False].state_dict())
    calls = attention_cuda.attention_core_reference.calls
    with torch.no_grad():
        outs = {flag: block(x) for flag, block in blocks.items()}
    assert attention_cuda.attention_core_reference.calls == calls + 1
    torch.testing.assert_close(outs[True], outs[False], atol=1e-5, rtol=1e-5)
    assert torch.equal(outs["auto"], outs[False])
    reduced = gsdm.AttnBlock(128, n_heads=2, attn_dim_reduce=2, use_pallas=True)
    assert not reduced._core_on(torch.empty((2, 4, 64)))


@pytest.mark.parametrize("shape,heads,ok", [
    ((4, 128, 128), 2, True), ((4, 109, 128), 4, True), ((4, 1, 128), 1, True),
    ((4, 129, 128), 2, True), ((4, 256, 128), 1, True), ((4, 257, 128), 2, False),
    ((4, 16, 64), 2, False), ((4, 16, 128), 3, False),
    ((4, 16, 128), 8, True), ((16, 128), 2, False),
])
def test_attention_core_supported(shape, heads, ok):
    """C of 128 … 512, N ≤ 256, heads of at most 128 channels that divide C."""
    assert attention_cuda.attention_core_supported(shape, heads) is ok


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """On `meta` tensors (not on the CPU, so the wrapper checks them as it
    checks CUDA tensors) every shape, type and head count the kernel does not
    take raises before anything is built."""
    meta = dict(device="meta")
    q = torch.empty((4, 16, 128), **meta)
    with pytest.raises(ValueError, match="attention kernel takes"):
        attention_cuda.attention_core(torch.empty((4, 257, 128), **meta), q, q, n_heads=2)
    with pytest.raises(ValueError, match="attention kernel takes"):
        attention_cuda.attention_core(q, q, q, n_heads=3)
    with pytest.raises(ValueError, match="k must be"):
        attention_cuda.attention_core(q, q[:, :8], q, n_heads=2)
    with pytest.raises(ValueError, match="mask must be"):
        attention_cuda.attention_core(q, q, q, torch.empty((4, 16), **meta), n_heads=2)
    with pytest.raises(TypeError, match="float32"):
        attention_cuda.attention_core(q, q.double(), q, n_heads=2)
    with pytest.raises(ValueError, match="contiguous"):
        attention_cuda.attention_core(q, q, q.transpose(0, 1).contiguous().transpose(0, 1),
                                      n_heads=2)
