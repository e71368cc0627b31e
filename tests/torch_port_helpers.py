"""Shared set-up for the port's CPU tests (tests/test_torch_*.py): one JAX
model (MBM, the absorbing family's `absorbing_pair`, or the transdimensional
family's `transdim_pair`) and its port twin with the same transplanted
weights, and inputs made from a seed with numpy; `replay_sampler_draws`
replays the JAX jump sampler's key schedule so that both samplers take the
same draws. Both sides run in float32 on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from multimodal_particles_tpu import test_resources_dir
from multimodal_particles_tpu.config_classes import (
    AbsorbingConfig,
    MultimodalBridgeMatchingConfig,
)
from multimodal_particles_tpu.config_classes.transdimensional_unconditional_config import (
    TransdimensionalEpicConfig,
)
from multimodal_particles_tpu.data.particle_clouds.jets_dataloader import (
    JetsDataloaderModule,
)
from multimodal_particles_tpu.models.generative.absorbing.absorbing_flows import (
    AbsorbingFlow,
)
from multimodal_particles_tpu.models.generative.multimodal_bridge_matching import (
    MultiModalBridgeMatching,
)
from multimodal_particles_tpu.models.generative.transdimensional.sampler import (
    _build_time_grid,
)
from multimodal_particles_tpu.models.generative.transdimensional.transdimensional_model import (
    TransdimensionalJumpDiffusion,
)
from multimodal_particles_tpu.ops.sampler_pallas import make_fused_sampler_step
from multimodal_particles_tpu_torch.config_classes import (
    AbsorbingConfig as TorchAbsorbingConfig,
)
from multimodal_particles_tpu_torch.config_classes import (
    MultimodalBridgeMatchingConfig as TorchConfig,
)
from multimodal_particles_tpu_torch.config_classes import (
    TransdimensionalEpicConfig as TorchTransdimConfig,
)
from multimodal_particles_tpu_torch.models.generative.absorbing.absorbing_flows import (
    AbsorbingFlow as TorchAbsorbingFlow,
)
from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (
    MultiModalBridgeMatching as TorchMBM,
)
from multimodal_particles_tpu_torch.models.generative.transdimensional.transdimensional_model import (
    TransdimensionalJumpDiffusion as TorchTransdim,
)
from multimodal_particles_tpu_torch.utils.transplant import params_from_flax

CONFIG_PATH = os.path.join(test_resources_dir, "configs_files", "config-mbm-test.yaml")
B, N = 8, 16


def jax_config(num_timesteps=8, **encoder):
    """The test config at B, N; `encoder` overrides encoder fields."""
    cfg = MultimodalBridgeMatchingConfig.from_yaml(CONFIG_PATH)
    cfg.data.batch_size = B
    cfg.data.max_num_particles = N
    cfg.bridge.num_timesteps = num_timesteps
    for name, value in encoder.items():
        setattr(cfg.encoder, name, value)
    return cfg


def model_pair(seed=0, num_timesteps=8, **encoder):
    """(jax_model, jax_params, torch_model, jax_batch): flax-initialised
    weights plus seeded noise (so that biases are not zero), transplanted.
    `encoder` overrides encoder fields of the test config."""
    cfg = jax_config(num_timesteps, **encoder)
    batch = jax.tree_util.tree_map(jnp.asarray, JetsDataloaderModule.random_databatch(cfg))
    jax_model = MultiModalBridgeMatching(cfg)
    params = jax_model.init(jax.random.PRNGKey(seed), batch)
    rng = np.random.default_rng(seed)
    params_np = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        params,
    )
    torch_cfg = TorchConfig.from_dict(cfg.to_dict())
    torch_model = TorchMBM(torch_cfg)
    torch_model.load_state_dict(params_from_flax(params_np, torch_cfg))
    jax_params = jax.tree_util.tree_map(jnp.asarray, params_np)
    return jax_model, jax_params, torch_model, batch


def noisy_params(params, seed):
    """flax-initialised params plus seeded noise as numpy leaves, so that
    biases and GroupNorm offsets are not zero."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        params,
    )


def absorbing_pair(seed=0, n=N, b=B, num_timesteps=8, sections=None):
    """(jax_model, jax_params, torch_model, jax_batch) of the absorbing family
    at its default config with `n` slots and `b` jets: flax-initialised
    weights plus seeded noise, transplanted. `sections` maps a config section
    to field overrides, e.g. {"generator": {"detach_last_layer": False}}."""
    cfg = AbsorbingConfig()
    cfg.data.batch_size, cfg.data.max_num_particles = b, n
    cfg.bridge.num_timesteps = num_timesteps
    for section, fields in (sections or {}).items():
        for name, value in fields.items():
            setattr(getattr(cfg, section), name, value)
    batch = jax.tree_util.tree_map(jnp.asarray, JetsDataloaderModule.random_databatch(cfg))
    jax_model = AbsorbingFlow(cfg)
    params_np = noisy_params(jax_model.init(jax.random.PRNGKey(seed), batch), seed)
    torch_cfg = TorchAbsorbingConfig.from_dict(cfg.to_dict())
    torch_model = TorchAbsorbingFlow(torch_cfg)
    torch_model.load_state_dict(params_from_flax(params_np, torch_cfg, TorchAbsorbingFlow))
    return jax_model, jax.tree_util.tree_map(jnp.asarray, params_np), torch_model, batch


def transdim_list_batch(seed, b, n):
    """The 'list' databatch [n_particles, continuous, one-hot] as numpy:
    multiplicities in [1, n] with jet 0 at 1 and jet 1 at n, rows past a jet's
    multiplicity zero."""
    rng = np.random.default_rng(seed)
    dims = rng.integers(1, n + 1, b).astype(np.int32)
    dims[0], dims[1] = 1, n
    live = (np.arange(n)[None, :] < dims[:, None]).astype(np.float32)[..., None]
    x = rng.standard_normal((b, n, 3)).astype(np.float32) * live
    one_hot = np.eye(8, dtype=np.float32)[rng.integers(0, 8, (b, n))] * live
    return [dims, x, one_hot]


def transdim_pair(seed=0, n=16, b=6, sections=None):
    """(jax_model, jax_params, torch_model, numpy 'list' batch) of the
    transdimensional family at its default config with `n` slots and `b` jets:
    flax-initialised weights plus seeded noise, transplanted. `sections` maps
    a config section to field overrides, e.g. {"sampler_kwargs": {"dt": 0.25}}."""
    cfg = TransdimensionalEpicConfig()
    cfg.data.batch_size, cfg.data.max_num_particles = b, n
    for section, fields in (sections or {}).items():
        for name, value in fields.items():
            setattr(getattr(cfg, section), name, value)
    batch = transdim_list_batch(seed + 100, b, n)
    jax_model = TransdimensionalJumpDiffusion(cfg)
    params_np = noisy_params(jax_model.init(jax.random.PRNGKey(seed), batch), seed)
    torch_cfg = TorchTransdimConfig.from_dict(cfg.to_dict())
    torch_model = TorchTransdim(torch_cfg)
    torch_model.load_state_dict(params_from_flax(params_np, torch_cfg, TorchTransdim))
    return jax_model, jax.tree_util.tree_map(jnp.asarray, params_np), torch_model, batch


def replay_sampler_draws(key, cfg_sampler, b, n, flat_dim):
    """The draws the JAX jump sampler makes from `key` on a grid without
    corrector steps, by its key schedule (sampler.py:224, :584, :312):
    split(key) → key_init; a step: split(key) → key_d, split(key_d, 4) →
    key_net, key_noise, key_jump, key_new. `gumbel` is the noise behind
    `jax.random.categorical(key_net, logits, axis=1)`. Numpy arrays over the
    T-step grid, as the port's `draws`."""
    steps = len(_build_time_grid(cfg_sampler)[0])
    k = max(int(cfg_sampler.multi_birth), 1)
    tiny = jnp.finfo(jnp.float32).tiny
    key, key_init = jax.random.split(key)
    draws = {"init": np.array(jax.random.normal(key_init, (b, flat_dim)))}
    per_step = {name: [] for name in ("gumbel", "em_noise", "u_jump", "u_chain", "birth_noise")}
    for _ in range(steps):
        key, key_d = jax.random.split(key)
        key_net, key_noise, key_jump, key_new = jax.random.split(key_d, 4)
        per_step["gumbel"].append(jax.random.gumbel(key_net, (b, n)))
        per_step["em_noise"].append(jax.random.normal(key_noise, (b, flat_dim)))
        per_step["u_jump"].append(jax.random.uniform(key_jump, (b,)))
        per_step["u_chain"].append(jax.random.uniform(key_jump, (b, k), minval=tiny))
        per_step["birth_noise"].append(jax.random.normal(key_new, (b, flat_dim)))
    draws.update({name: np.stack([np.asarray(v) for v in values])
                  for name, values in per_step.items()})
    return draws


def random_state(seed=1):
    """t (B,1,1), x (B,N,3), k (B,N,1) int32, mask (B,N,1) as numpy: random
    multiplicities, jet 0 empty."""
    rng = np.random.default_rng(seed)
    t = rng.random((B, 1, 1), dtype=np.float32)
    mult = rng.integers(1, N + 1, (B, 1))
    mult[0] = 0
    mask = (np.arange(N)[None, :] < mult).astype(np.float32)[..., None]
    x = rng.standard_normal((B, N, 3)).astype(np.float32) * mask
    k = (rng.integers(0, 8, (B, N, 1)) * mask).astype(np.int32)
    return t, x, k, mask


def to_torch(*arrays):
    return tuple(torch.from_numpy(np.array(a, order="C")) for a in arrays)


def jax_step_fn(jax_model):
    """The JAX fused sampler step (ops/sampler_pallas.py) in interpret mode,
    jitted once, for (B, N) state in lane layout."""
    cfg = jax_model.config
    make_for = make_fused_sampler_step(
        num_blocks=cfg.encoder.num_blocks, use_skip=cfg.encoder.skip_connection,
        add_discrete_head=cfg.encoder.add_discrete_head, dim_c=3, vocab=8,
        gamma=cfg.bridge.gamma, dim_emb_time=cfg.encoder.dim_emb_time, interpret=True,
    )
    return jax.jit(make_for(N, B))


# ---- a plain model of the 3×TF32 product of the tensor-core kernels (K4, K8;
# multimodal_particles_tpu_torch/ops/csrc/tf32x3.cuh)


def tf32_round(x):
    """float32 → the nearest TF32 value (10 mantissa bits), ties away from
    zero, as `cvt.rna.tf32.f32`; inf and NaN pass."""
    bits = x.float().contiguous().view(torch.int32)
    finite = (bits & 0x7F800000) != 0x7F800000
    return torch.where(finite, (bits + 0x1000) & ~0x1FFF, bits).view(torch.float32)


def tf32_split(x):
    """x = hi + lo, both TF32: hi = tf32(x), lo = tf32(x − hi), both rounded
    to nearest (tf32x3.cuh `split`: K8's operands, K4's weights)."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def tf32_truncate(x):
    """float32 → its top 19 bits (10 mantissa bits), the TF32 value the
    tensor cores read from a float32 bit pattern."""
    return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_split_truncated(x):
    """x = hi + lo with both truncated (tf32x3.cuh `split_fast`: K4's A
    operand): hi = x truncated, lo = x − hi exact in float32 and read by the
    tensor cores truncated."""
    hi = tf32_truncate(x)
    return hi, tf32_truncate(x.float() - hi)


def tf32x3_matmul(a, b, split_a=tf32_split):
    """a @ b as the kernels compute it: a_lo·b_hi + a_hi·b_lo + a_hi·b_hi,
    products of TF32 values (exact in float32) accumulated in float32; a
    split by `split_a`, b by `tf32_split`."""
    a_hi, a_lo = split_a(a)
    b_hi, b_lo = tf32_split(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def tf32_matmul(a, b):
    """a @ b as one TF32 tensor-core product."""
    return tf32_round(a) @ tf32_round(b)


def attention_core_model(q, k, v, bias, n_heads, matmul):
    """K8's function with both of its products (q·kᵀ and P·v) taken by
    `matmul`: softmax(q·kᵀ/√d + bias)·v per head, bias (B, 1, N). The bias
    is added to the float32 score, as the kernel and its plain version add
    it, whatever `matmul`'s precision: −1e9 then absorbs the score, and a
    wholly masked jet gives the mean of its values."""
    B, N, C = q.shape
    hd = C // n_heads
    q4, k4, v4 = (a.reshape(B, N, n_heads, hd).transpose(1, 2) for a in (q, k, v))
    s = matmul(q4, k4.transpose(-1, -2)) * hd**-0.5
    s = (s.float() + bias.float()[:, None]).to(s.dtype)
    return matmul(torch.softmax(s, dim=-1), v4).transpose(1, 2).reshape(B, N, C)


# ---- a plain model of K6's and K7's arithmetic (the survival head and the
# gsdm stack on the tensor cores, multimodal_particles_tpu_torch/ops/csrc/
# gsdm_blocks.cuh), in float64 apart from the split of each product's
# float32 operands


def gsdm_product_model(a, w, one_product=False):
    """A product as K6's and K7's wgmma products take it: a (float32
    activations) split by truncation, w (the weights) rounded to nearest,
    the three TF32 products (or a_hi·w_hi alone) summed in float64."""
    a_hi, a_lo = tf32_split_truncated(a.float())
    w_hi, w_lo = tf32_split(w.float())
    a_hi, a_lo, w_hi, w_lo = (x.double() for x in (a_hi, a_lo, w_hi, w_lo))
    return a_hi @ w_hi if one_product else a_lo @ w_hi + a_hi @ w_lo + a_hi @ w_hi


def gsdm_attention_product_model(a, b, one_product=False):
    """A product of the attention (q·kᵀ, P·v) as the kernels' mma.sync takes
    it: both operands split by truncation."""
    a_hi, a_lo = tf32_split_truncated(a.float())
    b_hi, b_lo = tf32_split_truncated(b.float())
    a_hi, a_lo, b_hi, b_lo = (x.double() for x in (a_hi, a_lo, b_hi, b_lo))
    return a_hi @ b_hi if one_product else a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def gsdm_blocks_model(W, h, temb_projected, n_blocks, n_heads, one_product=False):
    """The block walk of ops/gsdm_stack_cuda.py::blocks_reference with every
    product taken as the kernels take it (`gsdm_product_model`,
    `gsdm_attention_product_model`) and the rest in float64."""
    from multimodal_particles_tpu_torch.models.architectures.gsdm import group_norm, swish

    def mm(a, w):
        return gsdm_product_model(a, w, one_product)

    def vec(name):
        return W[name].double()

    B, N, C = h.shape
    hd = C // n_heads
    for i in range(n_blocks):
        r = mm(swish(group_norm(h, vec(f"gn1_s_{i}"), vec(f"gn1_b_{i}"))), W[f"w_c1_{i}"])
        r = r + vec(f"b_c1_{i}") + temb_projected[i].double()[:, None, :]
        r = mm(swish(group_norm(r, vec(f"gn2_s_{i}"), vec(f"gn2_b_{i}"))), W[f"w_c2_{i}"])
        h = h + (r + vec(f"b_c2_{i}"))
        hn = group_norm(h, vec(f"gna_s_{i}"), vec(f"gna_b_{i}"))
        q, k, v = ((mm(hn, W[f"w{x}_{i}"]) + vec(f"b{x}_{i}")).reshape(B, N, n_heads, hd)
                   .transpose(1, 2) for x in "qkv")
        s = gsdm_attention_product_model(q * hd**-0.5, k.transpose(-1, -2), one_product)
        o = gsdm_attention_product_model(torch.softmax(s, dim=-1), v, one_product)
        h = h + (mm(o.transpose(1, 2).reshape(B, N, C), W[f"wp_{i}"]) + vec(f"bp_{i}"))
    return h


def survival_head_model(packed, temb_projected, last_layer, mask_t, n_heads, one_product=False):
    """K6's function (ops/survival_cuda.py::survival_head_reference) with its
    products as the kernel takes them: (B, N, 1) float64."""
    W = packed.tensors
    m = mask_t.double()
    h = (gsdm_product_model(last_layer, W["w_in_h"], one_product) + W["w_oh0"].double()
         + m * (W["w_oh1"].double() - W["w_oh0"].double()) + W["b_in"].double())
    h = gsdm_blocks_model(W, h, temb_projected, packed.n_blocks, n_heads, one_product)
    h = gsdm_product_model(h, W["w_pre"], one_product) + W["b_pre"].double()
    return (h * W["w_post"].double()).sum(dim=-1, keepdim=True) + W["b_post"].double()


def gsdm_stack_model(packed, temb_projected, x_in, n_heads, one_product=False):
    """K7's function (ops/gsdm_stack_cuda.py::gsdm_stack_reference) with its
    products as the kernel takes them: (B, N, C) float64."""
    W = packed.tensors
    h = gsdm_product_model(x_in, W["w_in"][:packed.dim_in], one_product) + W["b_in"].double()
    return gsdm_blocks_model(W, h, temb_projected, packed.n_blocks, n_heads, one_product)
