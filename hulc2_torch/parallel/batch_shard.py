"""A data-parallel rank's rows of the global batch, for the train step's draws
and its batch-coupled losses.

A data-parallel step on W ranks must equal one process's step on the global
batch. Rank r trains on the fused rows [vis_r; lang_r]; the global batch is
[vis_0; ...; vis_{W-1}; lang_0; ...; lang_{W-1}], each modality's rows in
rank order. Inside ``active(shard)``:

- ``draw_rows`` makes a draw whose leading axis runs over rows at the
  global batch's shape from the step's generator, which every rank seeds
  alike, and keeps this rank's rows: the transform's crop offsets (one row
  per frame), the dropout masks and the plan's Gumbel or normal noise are
  then those of the one-process step;
- ``gather_rows`` stacks every rank's rows of a tensor, carrying gradients
  back to the rank that owns each row. It is an all-reduce of a zero-filled
  global buffer, which is exact and runs on every backend (gloo moves CUDA
  tensors only for broadcast and all-reduce);
- ``masked_mean`` divides by the mask's global count, ``roll_rows`` rolls
  over the global rows.

Each rank's loss is then W times its share of the global loss (a mean over
rows of equal count per rank already is; a masked mean or a loss over the
gathered rows is made so), and DDP's average of the ranks' gradients is the
one-process gradient. The collectives run over the default process group,
whose ranks are the data-parallel ones. Outside ``active`` every helper is the plain
one-process op.

Which rows a draw runs over is read from its leading size: the fused rows,
the lang rows alone, or the fused rows times the window's frames. A draw
over the vis rows alone would be taken for one over the lang rows when both
counts are equal; the model makes none.
"""
from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class BatchShard:
    rank: int
    world: int
    n_vis: int  # this rank's vis rows
    n_lang: int  # this rank's lang rows

    @property
    def fused(self) -> int:
        return self.n_vis + self.n_lang

    def fused_rows(self, device) -> torch.Tensor:
        """This rank's fused rows' indices in the global fused batch."""
        r, nv, nl = self.rank, self.n_vis, self.n_lang
        return torch.cat([torch.arange(r * nv, (r + 1) * nv, device=device),
                          self.world * nv + torch.arange(r * nl, (r + 1) * nl, device=device)])

    def rows(self, n: int, device) -> Tuple[int, torch.Tensor]:
        """(global size, this rank's indices) of a leading axis of ``n`` local rows."""
        if n == self.fused:
            return self.world * n, self.fused_rows(device)
        if n == self.n_lang:
            return self.world * n, torch.arange(self.rank * n, (self.rank + 1) * n, device=device)
        if self.fused and n % self.fused == 0:  # frames: rows x the window's length
            s = n // self.fused
            frames = self.fused_rows(device)[:, None] * s + torch.arange(s, device=device)
            return self.world * n, frames.reshape(-1)
        raise ValueError(f"a draw over {n} rows matches none of this rank's row counts "
                         f"({self.n_vis} vis + {self.n_lang} lang)")

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, without gradient."""
        x = x.detach().clone()
        dist.all_reduce(x)
        return x


# the step's forward pass reads it; gradients flow back through the shard
# each gather stored, so the autograd engine's threads need not see it
_ACTIVE: ContextVar[Optional[BatchShard]] = ContextVar("batch_shard", default=None)


@contextmanager
def active(shard: Optional[BatchShard]) -> Iterator[None]:
    """Draws and batch-coupled losses inside run over the global batch of
    ``shard`` (nothing changes for None)."""
    token = _ACTIVE.set(shard)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def draw_rows(fn: Callable[[tuple], torch.Tensor], shape: tuple, device) -> torch.Tensor:
    """``fn(shape)``, a draw whose leading axis runs over rows; in a shard,
    drawn at the global shape and cut to this rank's rows."""
    shard = _ACTIVE.get()
    if shard is None:
        return fn(tuple(shape))
    n, index = shard.rows(shape[0], device)
    return fn((n, *shape[1:]))[index]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, shard: BatchShard) -> torch.Tensor:
        n = x.shape[0]
        ctx.shard, ctx.n = shard, n
        out = x.new_zeros((shard.world * n, *x.shape[1:]))
        out[shard.rank * n:(shard.rank + 1) * n] = x
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        shard, n = ctx.shard, ctx.n
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad[shard.rank * n:(shard.rank + 1) * n], None


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x`` in rank order (``x`` itself outside a
    shard); gradients flow back to each row's rank, summed over the ranks."""
    shard = _ACTIVE.get()
    return x if shard is None else _GatherRows.apply(x, shard)


def roll_rows(x: torch.Tensor, shift: int) -> torch.Tensor:
    """``torch.roll(x, shift, 0)`` over the global rows, this rank's rows of it."""
    shard = _ACTIVE.get()
    if shard is None:
        return torch.roll(x, shift, dims=0)
    n = x.shape[0]
    return torch.roll(gather_rows(x), shift, dims=0)[shard.rank * n:(shard.rank + 1) * n]


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum(values * mask) / max(sum(mask), 1) over the global batch: in a
    shard, W times this rank's share, its denominator summed over the ranks."""
    local = (values * mask).sum()
    shard = _ACTIVE.get()
    if shard is None:
        return local / mask.sum().clamp(min=1.0)
    return shard.world * local / shard.sum(mask.sum()).clamp(min=1.0)
