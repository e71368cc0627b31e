"""Shared set-up for the port's CPU tests (tests/test_torch_*.py): one JAX
model (MBM, the absorbing family's `absorbing_pair`, or the transdimensional
family's `transdim_pair`) and its port twin with the same transplanted
weights, and inputs made from a seed with numpy; `replay_sampler_draws`
replays the JAX jump sampler's key schedule so that both samplers take the
same draws; `jet_pair` builds both packages' JetDataclass from one config
and data seed. Both sides run in float32 on the CPU."""

import functools
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
from multimodal_particles_tpu.data.particle_clouds.jets import JetDataclass
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
from multimodal_particles_tpu.models.generative.transdimensional.structure import (
    StructuredState as JaxStructuredState,
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
from multimodal_particles_tpu_torch.data import MultimodalDatabatch
from multimodal_particles_tpu_torch.data.particle_clouds.jets import (
    JetDataclass as TorchJetDataclass,
)
from multimodal_particles_tpu_torch.utils.transplant import params_from_flax

CONFIG_PATH = os.path.join(test_resources_dir, "configs_files", "config-mbm-test.yaml")
ABSORBING_CONFIG_PATH = os.path.join(test_resources_dir, "configs_files",
                                     "config-absorbing-test.yaml")
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


def transdim_list_batch(seed, b, n, context_continuous=0, vocab_size_context=0):
    """The 'list' databatch [n_particles, continuous, one-hot, contexts...] as
    numpy: multiplicities in [1, n] with jet 0 at 1 and jet 1 at n, rows past
    a jet's multiplicity zero; with `context_continuous` > 0 a (b, that)
    normal context, with `vocab_size_context` > 0 the one-hot of a uniform
    token (b, vocab_size_context), after it, as the loader appends them."""
    rng = np.random.default_rng(seed)
    dims = rng.integers(1, n + 1, b).astype(np.int32)
    dims[0], dims[1] = 1, n
    live = (np.arange(n)[None, :] < dims[:, None]).astype(np.float32)[..., None]
    x = rng.standard_normal((b, n, 3)).astype(np.float32) * live
    one_hot = np.eye(8, dtype=np.float32)[rng.integers(0, 8, (b, n))] * live
    batch = [dims, x, one_hot]
    if context_continuous:
        batch.append(rng.standard_normal((b, context_continuous)).astype(np.float32))
    if vocab_size_context:
        batch.append(np.eye(vocab_size_context, dtype=np.float32)[
            rng.integers(0, vocab_size_context, b)])
    return batch


def transdim_contexts(batch, config):
    """(context_continuous, context_discrete) of a `transdim_list_batch` by
    the config (None where it has none), not by list position: with only a
    discrete context the loader puts it at index 3, where
    `state_from_list_batch` reads a continuous one."""
    d, rest = config.data, list(batch[3:])
    cont = rest.pop(0) if d.dim_context_continuous else None
    disc = rest.pop(0) if d.dim_context_discrete else None
    return cont, disc


def drawn_params(init, key, *args, seed=0):
    """A parameter tree of flax's shapes with leaves drawn by numpy from
    flax's default laws (kernels, weight-norm directions and embeddings
    normal with std 1/√fan-in, scales and weight-norm gains 1, biases 0):
    `jax.eval_shape` traces the init without compiling it, where flax's eager
    init compiles each operation alone (~20 s for the transdimensional
    network)."""
    rng = np.random.default_rng(seed)

    def leaf(path, shape):
        name = path[-1].key
        if name in ("kernel", "v", "embedding"):
            fan_in = shape.shape[-1] if name == "embedding" else int(np.prod(shape.shape[:-1]))
            return (rng.standard_normal(shape.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "g"):
            return np.ones(shape.shape, np.float32)
        return np.zeros(shape.shape, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init, key, *args))


def transdim_pair(seed=0, n=16, b=6, sections=None, drawn_init=False):
    """(jax_model, jax_params, torch_model, numpy 'list' batch) of the
    transdimensional family at its default config with `n` slots and `b` jets:
    flax-initialised weights plus seeded noise, transplanted. `sections` maps
    a config section to field overrides, e.g. {"sampler_kwargs": {"dt": 0.25}};
    a context in the data section gives the batch that context
    (`transdim_list_batch`). With `drawn_init` the weights before the noise
    come from `drawn_params`, not from flax's init."""
    cfg = TransdimensionalEpicConfig()
    cfg.data.batch_size, cfg.data.max_num_particles = b, n
    for section, fields in (sections or {}).items():
        for name, value in fields.items():
            setattr(getattr(cfg, section), name, value)
    d = cfg.data
    batch = transdim_list_batch(seed + 100, b, n, d.dim_context_continuous,
                                d.vocab_size_context if d.dim_context_discrete else 0)
    jax_model = TransdimensionalJumpDiffusion(cfg)
    cont, disc = transdim_contexts(batch, cfg)
    init_state = JaxStructuredState(
        continuous=jnp.asarray(batch[1]), discrete=jnp.asarray(batch[2]),
        dims=jnp.asarray(batch[0]),
        context_continuous=None if cont is None else jnp.asarray(cont),
        context_discrete=None if disc is None else jnp.asarray(disc))
    key = jax.random.PRNGKey(seed)
    params = (drawn_params(jax_model.init, key, init_state, seed=seed) if drawn_init
              else jax_model.init(key, init_state))
    params_np = noisy_params(params, seed)
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


def random_state(seed=1, b=B, n=N):
    """t (b,1,1), x (b,n,3), k (b,n,1) int32, mask (b,n,1) as numpy: random
    multiplicities, jet 0 empty."""
    rng = np.random.default_rng(seed)
    t = rng.random((b, 1, 1), dtype=np.float32)
    mult = rng.integers(1, n + 1, (b, 1))
    mult[0] = 0
    mask = (np.arange(n)[None, :] < mult).astype(np.float32)[..., None]
    x = rng.standard_normal((b, n, 3)).astype(np.float32) * mask
    k = (rng.integers(0, 8, (b, n, 1)) * mask).astype(np.int32)
    return t, x, k, mask


def to_torch(*arrays):
    return tuple(torch.from_numpy(np.array(a, order="C")) for a in arrays)


def jax_step_fn(jax_model, b=B, n=N):
    """The JAX fused sampler step (ops/sampler_pallas.py) in interpret mode,
    jitted once, for (b, n) state in lane layout."""
    cfg = jax_model.config
    make_for = make_fused_sampler_step(
        num_blocks=cfg.encoder.num_blocks, use_skip=cfg.encoder.skip_connection,
        add_discrete_head=cfg.encoder.add_discrete_head, dim_c=3, vocab=8,
        gamma=cfg.bridge.gamma, dim_emb_time=cfg.encoder.dim_emb_time, interpret=True,
    )
    return jax.jit(make_for(n, b))


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
    activations) and w (the weights) split with both halves rounded to
    nearest, the three TF32 products (or a_hi·w_hi alone) summed in float64."""
    a_hi, a_lo = tf32_split(a.float())
    w_hi, w_lo = tf32_split(w.float())
    a_hi, a_lo, w_hi, w_lo = (x.double() for x in (a_hi, a_lo, w_hi, w_lo))
    return a_hi @ w_hi if one_product else a_lo @ w_hi + a_hi @ w_lo + a_hi @ w_hi


def gsdm_attention_product_model(a, b, one_product=False, split_a=tf32_split_truncated):
    """A product of the attention (q·kᵀ, P·v) as the kernels' mma.sync takes
    it: b split by truncation, a by `split_a` (q truncated, P rounded to
    nearest)."""
    a_hi, a_lo = split_a(a.float())
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
        o = gsdm_attention_product_model(torch.softmax(s, dim=-1), v, one_product, tf32_split)
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


# ---- a plain model of the arithmetic of K1 and K2 (the narrow forward and
# the sampler step on the tensor cores, multimodal_particles_tpu_torch/ops/
# csrc/narrow_tc.cuh), read from the kernels' own buffer, in float64 apart
# from the split of each product's operands


def narrow_buffer_entries(packed):
    """Name → view of each entry of the buffer of K1 and K2
    (`PackedEncoder.tensor_core`), by ops/epic_cuda.py::narrow_buffer_layout."""
    from multimodal_particles_tpu_torch.ops.epic_cuda import narrow_buffer_layout

    (buf,) = packed.tensor_core
    entries, off = {}, 0
    for name, n in narrow_buffer_layout(packed.dims):
        entries[name] = buf[off:off + n]
        off += n
    assert off == buf.numel()
    return entries


def unpack_mma_fragments(frag, K, N):
    """The (K, N) weights' TF32 (hi, lo) halves back from mma fragments
    [kk][j][lane 4g + t][hi b0, hi b1, lo b0, lo b1], b0 = W[8kk + 2t, 8j + g],
    b1 = W[8kk + 2t + 1, 8j + g]."""
    f = frag[:2 * K * N].reshape(K // 8, N // 8, 8, 4, 4)  # kk, j, g, t, slot
    halves = []
    for s in (0, 2):
        e = torch.stack([f[..., s], f[..., s + 1]], dim=-1)  # kk, j, g, t, e
        halves.append(e.permute(0, 3, 4, 1, 2).reshape(K, N))  # (kk, t, e) × (j, g)
    return tuple(halves)


def narrow_forward_model(packed, temb, x, k, mask, one_product=False):
    """The forward of K1 and K2 read from their buffer as the kernels read it:
    every per-particle product with its A operand split by truncation and the
    buffer's hi/lo weights (or a_hi·w_hi alone), the rest in float64. temb
    (B, E_t) the jets' time embeddings; k the (B, N, 1) tokens or, with a
    folded packing, the (B, N, 8) channel values. Returns (cont (B, N, 3),
    logits (B, N, 8), h (B, N, H)) in float64."""
    from multimodal_particles_tpu_torch.models.architectures.epic import leaky_relu

    d = packed.dims
    E = narrow_buffer_entries(packed)
    H, Hg, Et, Hd = d.hidden, d.hidden_glob, d.emb_t, (d.head_hidden + 7) // 8 * 8
    B, N = x.shape[:2]

    def mat(name, rows, cols):
        return E[name][:rows * cols].reshape(rows, cols).double()

    def vec(name, n):
        return E[name][:n].double()

    def mm(a, name, K, n_out):
        w_hi, w_lo = (h.double() for h in unpack_mma_fragments(E[name], K, n_out))
        a_hi, a_lo = (h.double() for h in tf32_split_truncated(a.float()))
        return a_hi @ w_hi if one_product else a_lo @ w_hi + a_hi @ w_lo + a_hi @ w_hi

    m = mask.double()
    temb = temb.double()
    ct = temb @ mat("t0", Et, H)
    if d.fold_discrete:
        discrete = k.double()
    else:
        discrete = (k.reshape(B, N, 1).long() == torch.arange(8)).double()
    a0 = torch.cat([x.double(), torch.ones((B, N, 1), dtype=torch.float64),
                    torch.zeros((B, N, 4), dtype=torch.float64), discrete], dim=-1)
    h = leaky_relu((mm(a0, "l0f", 16, H) + ct[:, None]) * m + vec("b_l0", H)) * m
    h0 = h if d.use_skip else torch.zeros_like(h)
    denom = m.sum(dim=1).clamp_min(1.0)
    s = h.sum(dim=1)
    g = leaky_relu(torch.cat([s / denom, s, temb], -1) @ mat("g0", 2 * H + Et, H) + vec("b_g0", H))
    g = leaky_relu(g @ mat("g1", H, H) + vec("b_g1", H))
    g = leaky_relu(g @ mat("g2", H, Hg) + vec("b_g2", Hg))
    gskip = g if d.use_skip else torch.zeros_like(g)
    for i in range(d.num_blocks):
        s = h.sum(dim=1)
        fa = leaky_relu(torch.cat([s / denom, s, g, temb], -1) @ mat(f"fg1_{i}", 2 * H + Hg + Et, H)
                        + vec(f"b_fg1_{i}", H))
        gnew = leaky_relu(fa @ mat(f"fg2_{i}", H, Hg) + vec(f"b_fg2_{i}", Hg) + g)
        cl1 = torch.cat([gnew, temb], -1) @ mat(f"fl1b_{i}", Hg + Et, H) + vec(f"b_fl1_{i}", H)
        g = gnew + gskip
        l1 = leaky_relu(cl1[:, None] + mm(h, f"fl1f_{i}", H, H))
        h = leaky_relu(h + vec(f"b_fl2_{i}", H) + mm(l1, f"fl2f_{i}", H, H)) * m + h0
    o = (vec("b_out", 16) + mm(h, "outf", H, 16)) * m
    logits, cont = o[..., :8], o[..., 8:11]
    if d.add_discrete_head:
        a = torch.nn.functional.selu(vec("b_h0", Hd) + mm(logits, "h0f", 8, Hd))
        logits = vec("b_h1", 8) + mm(a, "h1f", Hd, 8)
    return cont, logits, h


def epic_forward_model(packed, t, x, k, mask, one_product=False):
    """K1's function as the kernel computes it (`narrow_forward_model`, each
    jet's own time): ((B, N, 3 + 8) outputs, (B, N, H) hidden state), float64."""
    from multimodal_particles_tpu_torch.models.architectures.utils import (
        sinusoidal_positional_encoding,
    )

    temb = sinusoidal_positional_encoding(t.reshape(-1), packed.dims.emb_t)
    cont, logits, h = narrow_forward_model(packed, temb, x, k, mask, one_product)
    return torch.cat([cont, logits], dim=-1), h


def sampler_step_model(packed, x, k, mask, u, t, dt, gamma, one_product=False):
    """K2's function read from its buffer as the kernel reads it
    (`narrow_forward_model` at the step's one time), the token update by the
    port's plain telegraph step. Returns (x', k')."""
    from multimodal_particles_tpu_torch.models.architectures.utils import (
        sinusoidal_positional_encoding,
    )
    from multimodal_particles_tpu_torch.models.generative.bridges import (
        telegraph_fused_solver_step,
    )

    B = x.shape[0]
    temb = sinusoidal_positional_encoding(torch.full((B,), float(t)), packed.dims.emb_t)
    cont, logits, _ = narrow_forward_model(packed, temb, x, k, mask, one_product)
    m = mask.double()
    x_new = ((x.double() + dt * cont) * m).float()
    t_col = torch.full((B,), float(t))
    k_new = telegraph_fused_solver_step(t_col, k, logits.float(), gamma, 8, dt, u)
    return x_new, k_new * mask.to(k_new.dtype)


# ---- a plain model of K5's arithmetic (the wide backward on the tensor
# cores, multimodal_particles_tpu_torch/ops/csrc/epic_wide_backward.cu): the
# port's plain forward in float64 with the per-particle products taken as the
# kernels take them, differentiated by autograd


def split_product(x, y, split_x, split_y, one_product=False):
    """x·y of float32 operands as the tensor cores take them under the 3×TF32
    split, each operand split by its function, the TF32 products summed in
    float64 (or x_hi·y_hi alone)."""
    x_hi, x_lo = (h.double() for h in split_x(x.float()))
    y_hi, y_lo = (h.double() for h in split_y(y.float()))
    return x_hi @ y_hi if one_product else x_lo @ y_hi + x_hi @ y_lo + x_hi @ y_hi


class SplitProduct(torch.autograd.Function):
    """a·w (w (in, out)) as K5 computes it: forward as K4's rerun (a
    truncated, w rounded), d a = dz·wᵀ (dz truncated, wᵀ rounded: the
    transposed stages), d w = aᵀ·dz (both truncated: mma.sync)."""

    @staticmethod
    def forward(ctx, a, w, one_product):
        ctx.save_for_backward(a, w)
        ctx.one_product = one_product
        return split_product(a, w, tf32_split_truncated, tf32_split, one_product)

    @staticmethod
    def backward(ctx, dz):
        a, w = ctx.saved_tensors
        one = ctx.one_product
        da = split_product(dz, w.T, tf32_split_truncated, tf32_split, one)
        k, n = w.shape
        dw = split_product(a.reshape(-1, k).T, dz.reshape(-1, n), tf32_split_truncated,
                           tf32_split_truncated, one)
        return da, dw, None


def wide_backward_model(packed, t, x, k, mask, g, one_product=False):
    """d(flat) of the wide forward (the port's `forward_from_temb`) for the
    cotangent g, in float64 by autograd, with fc_local1's particle third and
    fc_local2 of every layer taken as `SplitProduct`: the products K5 runs on
    the tensor cores (its rerun's, dz·Wᵀ and aᵀ·dz). The rest (the per-jet
    MLP, local_0 through the embeddings, the heads) in float64, as the
    kernel's FFMA parts of them are within float32 rounding."""
    from multimodal_particles_tpu_torch.models.architectures.epic import leaky_relu
    from multimodal_particles_tpu_torch.models.architectures.utils import (
        sinusoidal_positional_encoding,
    )
    from multimodal_particles_tpu_torch.ops.epic_cuda import _SELU, LAYOUT_VIEWS, VOCAB

    d = packed.dims
    flat = packed.flat.detach().double().requires_grad_(True)
    W = LAYOUT_VIEWS[packed.layout](flat, d)
    B, N = x.shape[:2]
    H = d.hidden
    m = mask.double()
    temb = sinusoidal_positional_encoding(t.reshape(B), d.emb_t).double()
    denom = torch.clamp(m.sum(dim=1), min=1.0)
    x_emb = x.double() @ W["w_x"].T + W["b_x"]
    onehot = (k.reshape(B, N, 1).long() == torch.arange(VOCAB)).double()
    feats = torch.cat([temb[:, None].expand(B, N, d.emb_t), x_emb, onehot @ W["table"]], -1) * m
    h = leaky_relu(feats @ W["w_l0"].T + W["b_l0"])
    s0 = (h * m).sum(dim=1)
    g_ = leaky_relu(torch.cat([s0 / denom, s0, temb], -1) @ W["w_g0"].T + W["b_g0"])
    g_ = leaky_relu(g_ @ W["w_g1"].T + W["b_g1"])
    g_ = leaky_relu(g_ @ W["w_g2"].T + W["b_g2"])
    h = h * m
    skip_l = h if d.use_skip else 0.0
    skip_g = g_ if d.use_skip else 0.0
    for i in range(d.num_blocks):
        s = (h * m).sum(dim=1)
        g1 = leaky_relu(torch.cat([s / denom, s, g_, temb], -1) @ W[f"w_fg1_{i}"].T + W[f"b_fg1_{i}"])
        g_new = leaky_relu(g1 @ W[f"w_fg2_{i}"].T + W[f"b_fg2_{i}"] + g_)
        w_fl1 = W[f"w_fl1_{i}"]
        broadcast = torch.cat([g_new, temb], -1) @ w_fl1[:, H:].T + W[f"b_fl1_{i}"]
        l1 = leaky_relu(SplitProduct.apply(h, w_fl1[:, :H].T, one_product) + broadcast[:, None])
        z2 = SplitProduct.apply(l1, W[f"w_fl2_{i}"].T, one_product) + W[f"b_fl2_{i}"] + h
        h = leaky_relu(z2) * m + skip_l
        g_ = g_new + skip_g
    cont = (h @ W["w_out_c"].T + W["b_out_c"]) * m
    disc = (h @ W["w_out_d"].T + W["b_out_d"]) * m
    if d.add_discrete_head:
        disc = _SELU.apply(disc @ W["w_h0"].T + W["b_h0"]) @ W["w_h1"].T + W["b_h1"]
    out = torch.cat([cont, disc], -1)
    (grad,) = torch.autograd.grad(out, flat, g.double())
    return grad


# ---- a plain model of K3's arithmetic (the narrow backward on the tensor
# cores, multimodal_particles_tpu_torch/ops/csrc/epic_backward.cu): the
# port's plain forward in float64 with every per-particle product taken as
# the kernels take it, differentiated by autograd


class FoldedLocal0(torch.autograd.Function):
    """local_0's particle part as K1 computes it and K3 differentiates it:
    forward a0·rows, a0 = [x, 1, 0, 0, 0, 0, onehot(k)] truncated and the
    buffer's folded rows (hi, lo); backward Q = a0ᵀ·dP over the particles
    (both truncated, as K3's R·dz_l0 on the tensor cores), and from Q the
    gradients of local_0's x and token columns, w_x, b_x and the table."""

    @staticmethod
    def forward(ctx, a0, rows_hi, rows_lo, w_l0, w_x, b_x, table, d, one_product):
        ctx.save_for_backward(a0, w_l0, w_x, b_x, table)
        ctx.d, ctx.one_product = d, one_product
        a_hi, a_lo = (h.double() for h in tf32_split_truncated(a0.float()))
        out = a_hi @ rows_hi
        return out if one_product else out + a_lo @ rows_hi + a_hi @ rows_lo

    @staticmethod
    def backward(ctx, dp):
        a0, w_l0, w_x, b_x, table = ctx.saved_tensors
        d = ctx.d
        Et, Ex = d.emb_t, d.emb_x
        Q = split_product(a0.reshape(-1, 16).T, dp.reshape(-1, dp.shape[-1]),
                          tf32_split_truncated, tf32_split_truncated, ctx.one_product)
        d_w_l0 = torch.zeros_like(w_l0)
        d_w_l0[:, Et:Et + Ex] = (w_x @ Q[:3] + b_x[:, None] * Q[3]).T
        d_w_l0[:, Et + Ex:] = (table.T @ Q[8:]).T
        wx_cols = w_l0[:, Et:Et + Ex]  # (H, Ex)
        d_w_x = (Q[:3] @ wx_cols).T
        d_b_x = Q[3] @ wx_cols
        d_table = Q[8:] @ w_l0[:, Et + Ex:]
        return None, None, None, d_w_l0, d_w_x, d_b_x, d_table, None, None


def narrow_backward_model(packed, t, x, k, mask, g, one_product=False):
    """d(flat) of the narrow forward for the cotangent g, as K3 computes it,
    in float64 by autograd: the forward is K1's (`narrow_forward_model`'s
    products read from the buffer of `with_narrow_buffer`), every other
    per-particle product (fc_local1's particle third and fc_local2 of every
    layer, the output layer, the head's two layers) a `SplitProduct` (the
    rerun a truncated and W rounded, dz·Wᵀ dz truncated and Wᵀ rounded, aᵀ·dz
    both truncated) and local_0's particle part a `FoldedLocal0`; the per-jet
    MLP in float64, as the kernel's FFMA parts of it are within float32
    rounding. `one_product` takes a_hi·w_hi alone in every product."""
    from multimodal_particles_tpu_torch.models.architectures.epic import leaky_relu
    from multimodal_particles_tpu_torch.models.architectures.utils import (
        sinusoidal_positional_encoding,
    )
    from multimodal_particles_tpu_torch.ops.epic_cuda import _SELU, VOCAB, flat_views

    d = packed.dims
    flat = packed.flat.detach().double().requires_grad_(True)
    W = flat_views(flat, d)
    E = narrow_buffer_entries(packed)
    rows_hi, rows_lo = (h.double() for h in unpack_mma_fragments(E["l0f"], 16, d.hidden))
    B, N = x.shape[:2]
    H, Et = d.hidden, d.emb_t
    m = mask.double()
    temb = sinusoidal_positional_encoding(t.reshape(B), Et).double()
    denom = torch.clamp(m.sum(dim=1), min=1.0)
    onehot = (k.reshape(B, N, 1).long() == torch.arange(VOCAB)).double()
    a0 = torch.cat([x.double(), torch.ones((B, N, 1), dtype=torch.float64),
                    torch.zeros((B, N, 4), dtype=torch.float64), onehot], -1)

    def mm(a, w):  # a·wᵀ for a packed (out, in) w, as the kernels take it
        return SplitProduct.apply(a, w.T, one_product)

    particle = FoldedLocal0.apply(a0, rows_hi, rows_lo, W["w_l0"], W["w_x"], W["b_x"],
                                  W["table"], d, one_product)
    ct = temb @ W["w_l0"][:, :Et].T
    h = leaky_relu((particle + ct[:, None]) * m + W["b_l0"]) * m
    s0 = h.sum(dim=1)
    g_ = leaky_relu(torch.cat([s0 / denom, s0, temb], -1) @ W["w_g0"].T + W["b_g0"])
    g_ = leaky_relu(g_ @ W["w_g1"].T + W["b_g1"])
    g_ = leaky_relu(g_ @ W["w_g2"].T + W["b_g2"])
    skip_l = h if d.use_skip else 0.0
    skip_g = g_ if d.use_skip else 0.0
    for i in range(d.num_blocks):
        s = h.sum(dim=1)
        g1 = leaky_relu(torch.cat([s / denom, s, g_, temb], -1) @ W[f"w_fg1_{i}"].T + W[f"b_fg1_{i}"])
        g_new = leaky_relu(g1 @ W[f"w_fg2_{i}"].T + W[f"b_fg2_{i}"] + g_)
        w_fl1 = W[f"w_fl1_{i}"]
        broadcast = torch.cat([g_new, temb], -1) @ w_fl1[:, H:].T + W[f"b_fl1_{i}"]
        l1 = leaky_relu(mm(h, w_fl1[:, :H]) + broadcast[:, None])
        z2 = mm(l1, W[f"w_fl2_{i}"]) + W[f"b_fl2_{i}"] + h
        h = leaky_relu(z2) * m + skip_l
        g_ = g_new + skip_g
    cont = (mm(h, W["w_out_c"]) + W["b_out_c"]) * m
    disc = (mm(h, W["w_out_d"]) + W["b_out_d"]) * m
    if d.add_discrete_head:
        disc = mm(_SELU.apply(mm(disc, W["w_h0"]) + W["b_h0"]), W["w_h1"]) + W["b_h1"]
    (grad,) = torch.autograd.grad(torch.cat([cont, disc], -1), flat, g.double())
    return grad


# ---------------------------------------------------------------- jet data


def config_pair(family, **data):
    """(JAX config, port config) of a family with data overrides; the JAX
    data section gets the `seed` attribute its JetDataclass reads."""
    if family == "mbm":
        jax_cfg, cfg = (MultimodalBridgeMatchingConfig.from_yaml(CONFIG_PATH),
                        TorchConfig.from_yaml(CONFIG_PATH))
    elif family == "absorbing":
        jax_cfg, cfg = (AbsorbingConfig.from_yaml(ABSORBING_CONFIG_PATH),
                        TorchAbsorbingConfig.from_yaml(ABSORBING_CONFIG_PATH))
    else:
        jax_cfg, cfg = TransdimensionalEpicConfig(), TorchTransdimConfig()
        jax_cfg.data.return_type = cfg.data.return_type = "list"
    for name, value in data.items():
        setattr(jax_cfg.data, name, value)
        setattr(cfg.data, name, value)
    return jax_cfg, cfg


def jet_pair(family, seed=4, **data):
    """(JAX config, port config, JAX JetDataclass, port JetDataclass) of a
    family from the same data seed."""
    jax_cfg, cfg = config_pair(family, **data)
    jax_cfg.data.seed = seed
    return jax_cfg, cfg, JetDataclass(jax_cfg), TorchJetDataclass(cfg, seed=seed)


def assert_batch_equals(got, ref):
    """A port batch (MultimodalDatabatch or 'list' of CPU tensors) equals a
    JAX numpy batch cast to the port's dtypes (JAX puts float64 arrays on
    its device as float32)."""
    if isinstance(got, MultimodalDatabatch):
        assert set(ref._fields) <= {f for f in vars(got) if getattr(got, f) is not None}
        pairs = [(getattr(got, f), np.asarray(getattr(ref, f))) for f in ref._fields]
    else:
        assert len(got) == len(ref)
        pairs = [(g, np.asarray(r)) for g, r in zip(got, ref)]
    for g, r in pairs:
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        g = g.numpy()
        assert g.shape == r.shape
        np.testing.assert_array_equal(g, r.astype(g.dtype))


def jax_bridge_draws(key, batch):
    """The draws that the JAX MBM sample_bridges makes from `key`
    (multimodal_bridge_matching.py:260-269), as tensors for the port's."""
    key_t, key_x, key_k = jax.random.split(key, 3)
    x1 = batch.target_continuous
    b, n = x1.shape[0], x1.shape[1]
    t = jax.random.uniform(key_t, (b,), dtype=x1.dtype)
    z = jax.random.normal(key_x, x1.shape, dtype=x1.dtype)
    u = jax.random.uniform(key_k, (b, n), dtype=jnp.float32)
    return tuple(torch.tensor(np.asarray(a)) for a in (t, z, u))



# ------------------------------------------- encoder switches and contexts

CONTEXT_DATA = {"dim_context_continuous": 2, "dim_context_discrete": 1, "vocab_size_context": 10}
CONTEXT_ENCODER = {"dim_emb_context_continuous": 16, "dim_emb_context_discrete": 16}


def with_context(batch, cfg, seed):
    """The JAX batch with the contexts its config asks for, from a numpy seed:
    (B, dim_context_continuous) normals and (B, dim_context_discrete) tokens."""
    rng = np.random.default_rng(seed + 200)
    b, d = batch.source_continuous.shape[0], cfg.data
    ctx_c = ctx_d = None
    if d.dim_context_continuous:
        ctx_c = jnp.asarray(rng.standard_normal((b, d.dim_context_continuous)).astype(np.float32))
    if d.dim_context_discrete:
        ctx_d = jnp.asarray(rng.integers(0, d.vocab_size_context, (b, d.dim_context_discrete))
                            .astype(np.int32))
    return batch._replace(context_continuous=ctx_c, context_discrete=ctx_d)


def switch_pair(family="mbm", seed=0, n=N, b=B, num_timesteps=8, sections=None):
    """(jax_model, jax_params, torch_model, jax_batch) of MBM (the test
    config) or the absorbing family (its defaults) at `n` slots and `b` jets,
    with `sections` mapping a config section to field overrides (encoder
    switches, context widths, the compute dtype); the batch carries the
    contexts the config asks for. Flax-initialised weights plus seeded noise,
    transplanted."""
    if family == "mbm":
        cfg = jax_config(num_timesteps)
        jax_cls, port_cfg_cls, port_cls = MultiModalBridgeMatching, TorchConfig, TorchMBM
    else:
        cfg = AbsorbingConfig()
        cfg.bridge.num_timesteps = num_timesteps
        jax_cls, port_cfg_cls, port_cls = AbsorbingFlow, TorchAbsorbingConfig, TorchAbsorbingFlow
    cfg.data.batch_size, cfg.data.max_num_particles = b, n
    for section, fields in (sections or {}).items():
        for name, value in fields.items():
            setattr(getattr(cfg, section), name, value)
    batch = jax.tree_util.tree_map(jnp.asarray, JetsDataloaderModule.random_databatch(cfg))
    batch = with_context(batch, cfg, seed)
    jax_model = jax_cls(cfg)
    params_np = noisy_params(jax_model.init(jax.random.PRNGKey(seed), batch), seed)
    torch_cfg = port_cfg_cls.from_dict(cfg.to_dict())
    torch_model = port_cls(torch_cfg)
    torch_model.load_state_dict(params_from_flax(params_np, torch_cfg, port_cls))
    return jax_model, jax.tree_util.tree_map(jnp.asarray, params_np), torch_model, batch


@functools.lru_cache(maxsize=None)
def context_pair(family):
    """`switch_pair` of a family with both contexts (seed 2, 8 timesteps),
    built once a process and shared by the test files; a test that changes
    its configs or gradients sets them back."""
    return switch_pair(family, seed=2, num_timesteps=8,
                       sections={"data": CONTEXT_DATA, "encoder": CONTEXT_ENCODER})


def port_batch(batch) -> MultimodalDatabatch:
    """A JAX MultimodalDatabatch as the port's, its contexts included."""
    return MultimodalDatabatch(**{
        name: torch.from_numpy(np.array(value)) for name, value in batch._asdict().items()
        if value is not None})


def replay_mbm_uniforms(key, steps, b, n):
    """The (steps, 2, B, N) uniforms that the JAX MBM module-path sampler
    draws from `key` (multimodal_bridge_matching.py:344-352 with
    bridges.py:205-244): a step splits (key, key_cont, key_disc) and the
    telegraph update draws (2, B, N) uniforms from key_disc."""
    out = []
    for _ in range(steps):
        key, _, key_disc = jax.random.split(key, 3)
        out.append(np.asarray(jax.random.uniform(key_disc, (2, b, n), dtype=jnp.float32)))
    return torch.from_numpy(np.stack(out))


def replay_absorbing_uniforms(key, steps, b, n):
    """The (steps, 3, B, N) uniforms that the JAX absorbing sampler draws from
    `key` (absorbing_flows.py:369-384, bridges.py:325-355 and :205-244): a
    step splits (key, key_m, key_k); the birth-only mask step draws
    bernoulli(key_m) = uniform(key_m) < p, the telegraph update (2, B, N)
    uniforms from key_k."""
    out = []
    for _ in range(steps):
        key, key_m, key_k = jax.random.split(key, 3)
        births = np.asarray(jax.random.uniform(key_m, (b, n, 1), dtype=jnp.float32))[None, ..., 0]
        telegraph = np.asarray(jax.random.uniform(key_k, (2, b, n), dtype=jnp.float32))
        out.append(np.concatenate([births, telegraph]))
    return torch.from_numpy(np.stack(out))
