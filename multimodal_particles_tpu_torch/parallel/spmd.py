"""The loss of the global batch on ranks that hold its rows: the semantics of
the JAX trainer's default `spmd_mode="jit"` (training/trainer.py:200-260),
where XLA computes one program over the whole batch.

Under `global_batch(...)` the families' losses compute, on each data rank,
their share of the global batch's loss, so that the shares sum to it:

  * every draw of a step is made for the whole global batch from a generator
    seeded alike on every rank, and the rank keeps its rows (`rows`,
    `local`): the bridge times and noise, the transdimensional deletions;
  * a normaliser that depends on the batch's content (a mask sum, a count of
    valid rows, a batch mean's size) is the global one (`total`, `mean`);
  * a term that does not scale with the batch, the learnable `+ w_i` of the
    multi-head loss, is counted on data rank 0 only (`once`).

The trainer then sums the ranks' gradients and metrics over 'data'; metrics
that are maxima or minima over the batch are named in the model's
`metric_reductions`. Outside `global_batch` every helper returns its input
(`rows` the local size), so a one-process run computes what it computed
before.
"""

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class GlobalBatch:
    """This rank's `rows` of a global batch of `size` rows; `group` is the
    'data' process group and `first` whether this is data rank 0."""

    rows: slice
    size: int
    group: object
    first: bool

    @property
    def local_size(self) -> int:
        return self.rows.stop - self.rows.start


_current: Optional[GlobalBatch] = None


@contextlib.contextmanager
def global_batch(spec: Optional[GlobalBatch]):
    """The losses computed inside take `spec`'s global-batch semantics (None:
    the local batch's)."""
    global _current
    saved, _current = _current, spec
    try:
        yield
    finally:
        _current = saved


def active() -> bool:
    return _current is not None


def rows(n: int) -> int:
    """How many rows to draw for a local batch of `n` rows: the global
    batch's."""
    return n if _current is None else _current.size


def local(x):
    """This rank's rows of a draw made for the global batch."""
    return x if _current is None else x[_current.rows]


def total(x):
    """The global batch's value of a count (a sum over rows), with no
    gradient."""
    if _current is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=_current.group)
    return x


def mean(x):
    """x.mean() over the global batch, as this rank's share: the local sum
    divided by the global element count (x's leading dimension the rows)."""
    if _current is None:
        return x.mean()
    return x.sum() / (x.numel() // _current.local_size * _current.size)


def once(x):
    """x on data rank 0, 0 on the others: a term of the loss that does not
    scale with the batch."""
    return x if _current is None or _current.first else torch.zeros_like(x)
