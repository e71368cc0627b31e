"""Collectives over the mesh's named axes
(multimodal_particles_tpu/parallel/collectives.py:19-54) on torch.distributed.

The data-parallel axis is 'data', the tensor-parallel axis 'model'; each helper
acts over the process group of this rank's row or column of the mesh
(`mesh.get_group(axis)`). On the one-rank mesh they return their input.

Two kinds of gradient-carrying collectives:

  * `psum_data_grad` / `all_gather_data_grad`: each rank's loss is its own,
    the gradients of all ranks' losses add up;
  * Megatron's pair over 'model', where every rank of a tensor-parallel group
    computes the same (replicated) loss: `copy_to_model` (f: identity forward,
    all-reduce of the gradient backward) in front of a column-parallel layer,
    `reduce_from_model` (g: all-reduce forward, identity backward) behind a
    row-parallel one, and `psum_model_grad` (all-reduce both ways) for a sum
    whose users are shard-local, such as a row-parallel weight norm.

`all_reduce_coalesced` sums a list of tensors in a few flat buckets: the
trainer's gradient reduction.
"""

import torch
import torch.distributed as dist

DATA_AXIS = "data"
BUCKET_ELEMENTS = 1 << 23  # 32 MiB of float32 a bucket


def _group(mesh, axis):
    return mesh.get_group(axis) if mesh.size(mesh.mesh_dim_names.index(axis)) > 1 else None


def axis_size(mesh, axis) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def psum_data(x, mesh):
    """Sum over the data axis (no gradient)."""
    group = _group(mesh, DATA_AXIS)
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x


def pmean_data(x, mesh):
    """Mean over the data axis (no gradient)."""
    return psum_data(x, mesh) / axis_size(mesh, DATA_AXIS)


def all_gather_data(x, mesh, dim=0):
    """The data ranks' tensors (same shape), concatenated along `dim` in rank
    order (no gradient)."""
    group = _group(mesh, DATA_AXIS)
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, DATA_AXIS))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def ppermute_data(x, mesh, perm):
    """Send x along the pairs (source, destination) of data indices in
    `perm`; a rank that receives nothing gets zeros (jax.lax.ppermute)."""
    group = _group(mesh, DATA_AXIS)
    if group is None:
        return x if (0, 0) in perm else torch.zeros_like(x)
    me = axis_index_data(mesh)
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me:
            ops.append(dist.P2POp(dist.isend, x.contiguous(), dist.get_global_rank(group, dst),
                                  group))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group))
    for work in dist.batch_isend_irecv(ops) if ops else []:
        work.wait()
    return out


def axis_index_data(mesh) -> int:
    return mesh.get_local_rank(DATA_AXIS)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group whose gradient is the group's sum of gradients: each
    rank's users of the sum are its own."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _AllGather(torch.autograd.Function):
    """The group's tensors concatenated along `dim`; each rank's part gets
    the group's sum of the gradients of that part."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        ctx.index = dist.get_group_rank(group, dist.get_rank())
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None


def psum_data_grad(x, mesh):
    """Sum over the data axis whose gradient is the sum of the ranks'
    gradients (each rank's loss its own)."""
    group = _group(mesh, DATA_AXIS)
    return x if group is None else _AllReduceSum.apply(x, group)


def all_gather_data_grad(x, mesh, dim=0):
    """`all_gather_data` with a gradient back to each rank's own part."""
    group = _group(mesh, DATA_AXIS)
    return x if group is None else _AllGather.apply(x, group, dim)


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, gradient all-reduced over 'model'."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce forward over 'model', identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x, group):
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    return x if group is None else _ReduceFromModel.apply(x, group)


def psum_model_grad(x, group):
    """All-reduce over 'model' forward and backward: a sum of shard-local
    partials whose users are shard-local too (a row-parallel weight norm's
    squares)."""
    return x if group is None else _AllReduceSum.apply(x, group)


def all_reduce_coalesced(tensors, group, op=dist.ReduceOp.SUM, bucket=BUCKET_ELEMENTS):
    """All-reduce a list of same-dtype tensors in place, flattened into
    buckets of at most `bucket` elements (one collective a bucket)."""
    if group is None or not tensors:
        return
    start = 0
    while start < len(tensors):
        stop, size = start, 0
        while stop < len(tensors) and (stop == start or size + tensors[stop].numel() <= bucket):
            size += tensors[stop].numel()
            stop += 1
        part = tensors[start:stop]
        flat = torch.cat([t.reshape(-1) for t in part])
        dist.all_reduce(flat, op=op, group=group)
        offset = 0
        for t in part:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
        start = stop
