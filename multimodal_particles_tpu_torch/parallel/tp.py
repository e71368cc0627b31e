"""Tensor parallelism over the mesh's 'model' axis: the Megatron pairing of
multimodal_particles_tpu/parallel/tp.py:62-110, in layers.

JAX places the parameters with `NamedSharding`s and lets XLA derive the
collectives, the step functions untouched. Here the layers carry the
parallelism and the step functions stay untouched too: `shard_params_tp`
swaps each Megatron pair of a model for its tensor-parallel form, which holds
this rank's shards of the parameters under the same names.

Pairs (port names; `v` and `weight` are stored (out, in), flax's (in, out)
transposed, so JAX's P(None, "model") on a kernel is the port's dimension 0):

  fc_local1 / fc_global1        column-parallel  v, g, bias: rows (out/M)
  fc_local2 / fc_global2        row-parallel     v: columns (in/M); g, bias whole
  attn_i.q / .k / .v            column-parallel  weight (c/M, C), bias (c/M)
  attn_i.proj_out               row-parallel     weight (C, c/M); bias whole
  res_i.conv1 / .temb_proj      column-parallel
  res_i.conv2                   row-parallel

(`vec_attn_i`, `vec_res_i` likewise.) A column-parallel layer takes its input
through Megatron's f (identity forward, gradient all-reduced over 'model'); a
row-parallel layer multiplies its shard, all-reduces the product through
Megatron's g (all-reduce forward, identity backward) and adds its bias once.
The weight norm of a column-parallel layer is shard-local (whole output
rows); a row-parallel one all-reduces the per-row partial sums of squares
(the "(out,)-sized psum" of tp.py:45-49). Every rank of a 'model' group then
computes the same loss, and every parameter's gradient is whole on its rank.

ResnetBlock's norm2 sees C/M of the channels: with 32 groups and M dividing
32, the shard holds 32/M whole groups, so it normalises over them with its
slice of the (replicated) scale and offset, which reach the whole gradient
through f. AttnBlock runs its heads/M local heads when M divides the head
count; otherwise the block stays replicated. The blocks take dropout 0.0 in
every model, as in JAX, so no mask has to agree across a pair; a block with
dropout is refused. Everything else is replicated. Under model_axis > 1 the
kernel gates are off (ops/epic_cuda.py, survival_cuda.py, gsdm_stack_cuda.py,
as JAX's), so the tensor-parallel model runs the module path.
"""

import re

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from multimodal_particles_tpu_torch.models.architectures.gsdm import (
    GN_GROUPS,
    AttnBlock,
    GroupNorm,
    ResnetBlock,
    group_norm,
)
from multimodal_particles_tpu_torch.models.architectures.utils import (
    Dense,
    WeightNormLinear,
    linear,
)
from multimodal_particles_tpu_torch.parallel.collectives import (
    copy_to_model,
    psum_model_grad,
    reduce_from_model,
)
from multimodal_particles_tpu_torch.parallel.mesh import mesh_shape

# JAX's two rules (tp.py:62-75) on the port's dotted names
_COL_RE = re.compile(
    r"fc_(local|global)1"
    r"|(^|\.)(vec_)?attn_\d+\.[qkv]\."
    r"|(^|\.)(vec_)?res_\d+\.(conv1|temb_proj)\."
)
_ROW_RE = re.compile(
    r"fc_(local|global)2"
    r"|(^|\.)(vec_)?attn_\d+\.proj_out\."
    r"|(^|\.)(vec_)?res_\d+\.conv2\."
)


def _shard_dim(name: str, shape, model_size: int):
    """The dimension (port layout) along which a parameter is split, or None
    for a replicated one: JAX's `_spec_for` (tp.py:78-90) with (in, out)
    read as (out, in)."""
    if _COL_RE.search(name):
        if len(shape) in (1, 2) and shape[0] % model_size == 0:
            return 0  # v / weight: output rows; g / bias follow them
    elif _ROW_RE.search(name):
        if len(shape) == 2 and shape[1] % model_size == 0:
            return 1  # v / weight: input columns; g / bias span the output
    return None


def tp_param_specs(model, mesh) -> dict:
    """{parameter name: placements} of the model's whole parameters: (Shard(d),)
    for a split one, (Replicate(),) else (tp.py:93-100; pure, no placement)."""
    from torch.distributed.tensor import Replicate, Shard

    m = mesh_shape(mesh)["model"]
    specs = {}
    for name, p in model.named_parameters():
        d = _shard_dim(name, tuple(p.shape), m)
        specs[name] = (Replicate(),) if d is None else (Shard(d),)
    return specs


def _block(n: int, index: int, size: int) -> slice:
    return slice(index * n // size, (index + 1) * n // size)


def _whole(t):
    return nn.Parameter(t.detach().clone())


class ColumnParallelWeightNormLinear(WeightNormLinear):
    """This rank's output rows of a WeightNormLinear (v, g and bias), its input
    through f."""

    sharded = {"v": 0, "g": 0, "bias": 0}

    def __init__(self, layer: WeightNormLinear, group, index: int, size: int):
        nn.Module.__init__(self)
        rows = _block(layer.v.shape[0], index, size)
        self.v, self.g, self.bias = (_whole(t[rows]) for t in (layer.v, layer.g, layer.bias))
        self.group = group

    def forward(self, x):
        return super().forward(copy_to_model(x, self.group))


class RowParallelWeightNormLinear(WeightNormLinear):
    """This rank's input columns of a WeightNormLinear's v, the gain and bias
    whole: ‖v‖ over the split input from all-reduced partial squares, the
    product all-reduced through g, the bias added once."""

    sharded = {"v": 1}

    def __init__(self, layer: WeightNormLinear, group, index: int, size: int):
        nn.Module.__init__(self)
        self.v = _whole(layer.v[:, _block(layer.v.shape[1], index, size)])
        self.g, self.bias = _whole(layer.g), _whole(layer.bias)
        self.group = group

    def effective_weight(self):
        sum_sq = psum_model_grad(torch.sum(self.v * self.v, dim=1, keepdim=True), self.group)
        g = copy_to_model(self.g, self.group)
        return (g[:, None] / torch.clamp(torch.sqrt(sum_sq), min=1e-12)) * self.v

    def forward(self, x):
        return reduce_from_model(F.linear(x, self.effective_weight()), self.group) + self.bias


class ColumnParallelDense(Dense):
    """This rank's output rows of a Dense (weight and bias), its input through f."""

    sharded = {"weight": 0, "bias": 0}

    def __init__(self, layer: nn.Linear, group, index: int, size: int):
        nn.Module.__init__(self)
        rows = _block(layer.out_features, index, size)
        self.in_features, self.out_features = layer.in_features, rows.stop - rows.start
        self.weight, self.bias = _whole(layer.weight[rows]), _whole(layer.bias[rows])
        self.group = group

    def forward(self, x):
        return linear(copy_to_model(x, self.group), self.weight, self.bias)


class RowParallelDense(Dense):
    """This rank's input columns of a Dense's weight, the bias whole: the
    product all-reduced through g, the bias added once."""

    sharded = {"weight": 1}

    def __init__(self, layer: nn.Linear, group, index: int, size: int):
        nn.Module.__init__(self)
        cols = _block(layer.in_features, index, size)
        self.in_features, self.out_features = cols.stop - cols.start, layer.out_features
        self.weight, self.bias = _whole(layer.weight[:, cols]), _whole(layer.bias)
        self.group = group

    def forward(self, x):
        return reduce_from_model(F.linear(x, self.weight), self.group) + self.bias


class ShardedGroupNorm(GroupNorm):
    """GroupNorm over this rank's channels [lo, hi), whole groups of them: the
    scale and offset stay whole (replicated) and reach their gradient
    through f."""

    sharded = {}

    def __init__(self, norm: GroupNorm, channels: slice, groups: int, group):
        nn.Module.__init__(self)
        self.weight, self.bias = norm.weight, norm.bias
        self.channels, self.groups, self.group = channels, groups, group

    def forward(self, x):
        w = copy_to_model(self.weight, self.group)[self.channels]
        b = copy_to_model(self.bias, self.group)[self.channels]
        return group_norm(x, w, b, groups=self.groups)


def shard_params_tp(model, mesh) -> dict:
    """Put the model's Megatron pairs in tensor-parallel form for this rank of
    the mesh's 'model' axis, in place (tp.py:103-110): a pair whose shared
    dimension divides by the model size, an AttnBlock whose heads do too, a
    ResnetBlock whose 32 GroupNorm groups do too. The parameters keep their
    names; the optimizer must be built after. Returns {name: dimension} of
    the split parameters."""
    m = mesh_shape(mesh)["model"]
    if m == 1:
        return {}
    group, index = mesh.get_group("model"), mesh.get_local_rank("model")
    dims = {name: _shard_dim(name, tuple(p.shape), m) for name, p in model.named_parameters()}
    for name, module in list(model.named_modules()):
        prefix = f"{name}." if name else ""
        if isinstance(module, ResnetBlock) and dims.get(f"{prefix}conv1.weight") == 0:
            if module.dropout.p:
                raise NotImplementedError("a tensor-parallel ResnetBlock with dropout")
            if GN_GROUPS % m:
                continue
            C = module.conv1.out_features
            module.conv1 = ColumnParallelDense(module.conv1, group, index, m)
            module.temb_proj = ColumnParallelDense(module.temb_proj, group, index, m)
            module.conv2 = RowParallelDense(module.conv2, group, index, m)
            module.norm2 = ShardedGroupNorm(module.norm2, _block(C, index, m), GN_GROUPS // m, group)
        elif isinstance(module, AttnBlock) and dims.get(f"{prefix}q.weight") == 0:
            if module.n_heads % m:
                continue
            for attr in ("q", "k", "v"):
                setattr(module, attr, ColumnParallelDense(getattr(module, attr), group, index, m))
            module.proj_out = RowParallelDense(module.proj_out, group, index, m)
            module.n_heads //= m
            module.use_pallas = False
        elif isinstance(module, WeightNormLinear) and dims.get(f"{prefix}v") is not None:
            parallel = (ColumnParallelWeightNormLinear if dims[f"{prefix}v"] == 0
                        else RowParallelWeightNormLinear)
            parent_name, _, attr = name.rpartition(".")
            parent = model.get_submodule(parent_name)
            setattr(parent, attr, parallel(module, group, index, m))
    return {f"{name}.{p}" if name else p: d for name, module in model.named_modules()
            for p, d in getattr(module, "sharded", {}).items()}


def gather_full(t, dim: int, group, size: int):
    """The whole tensor of which `t` is this rank's block along `dim`."""
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def local_block(t, dim: int, index: int, size: int):
    """This rank's block of a whole tensor along `dim`."""
    n = t.shape[dim] // size
    return t.narrow(dim, index * n, n).contiguous()
