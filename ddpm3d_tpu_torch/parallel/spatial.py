"""The collectives of one spatial group: the ranks that share one patch,
each holding an equal slice of its H axis.

Rank s of a group of n holds H rows ``[s * H / n, (s + 1) * H / n)`` of
every activation ``[B, D, H, W, C]``. The model (``ConvSites.set_spatial``)
hands a :class:`SpatialGroup` to its 3x3x3 convs, GroupNorms, fused
ResBlocks, attention blocks and int8 sites, which call:

* :meth:`SpatialGroup.halo` around every 3x3x3 conv: one H plane from each
  neighbour that exists (``batch_isend_irecv``), so that the conv, run by
  the unchanged kernel with its own SAME padding, computes the local rows
  exactly; the caller crops the rows the halo adds;
* :meth:`SpatialGroup.all_reduce_sum` of the GroupNorm sums ``[B, 2, C]``
  and :meth:`SpatialGroup.all_reduce_max` of the int8 sites' per-sample
  abs-max (order-free, so a site's scale equals the unsharded one);
* :meth:`SpatialGroup.all_gather_h`, the shards concatenated along H in
  rank order (the attention's keys and values).

This is the counterpart of what XLA's SPMD partitioner inserts for the JAX
package's ``spatial`` mesh axis. It runs over the default process group's
backend: NCCL on the card, gloo on the CPU. A group of one rank launches
nothing: every operation returns its input.

The transport is three methods (:meth:`SpatialGroup._exchange`,
:meth:`SpatialGroup._reduce`, :meth:`SpatialGroup._gather`); the halo,
crop and concatenation logic above them does not depend on it. Each
operation run counts as ``spatial.<op>`` in :mod:`..utils.tracing`; a halo
and a reduction open the spans ``ddpm.spatial.halo`` and
``ddpm.spatial.reduce``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils import tracing

H_DIM = 2  # the H axis of [B, D, H, W, C]


class SpatialGroup:
    """The spatial group of this rank: ``ranks`` (global ranks, in spatial
    order), this rank's ``index`` among them and the ``torch.distributed``
    ``group`` they form (None: the default group)."""

    def __init__(self, ranks: Sequence[int], index: int, group=None):
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.index = index
        self.group = group
        if not 0 <= index < self.size:
            raise ValueError(f"index {index} outside a group of {self.size}")

    # ------------------------------------------------------------ transport

    def _exchange(self, sends: Dict[int, torch.Tensor]
                  ) -> Dict[int, torch.Tensor]:
        """Send ``sends[p]`` to group member p and receive from p a tensor
        of the same shape, for every p at once; {p: received}."""
        recvs = {p: torch.empty_like(t) for p, t in sends.items()}
        ops = []
        for p, t in sends.items():
            ops.append(dist.P2POp(dist.isend, t, self.ranks[p], self.group))
            ops.append(dist.P2POp(dist.irecv, recvs[p], self.ranks[p],
                                  self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recvs

    def _reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``t`` (a new tensor) reduced over the group by "sum" or "max"."""
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=self.group)
        return out

    def _gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every member's ``t`` (one shape on all), in group order."""
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return parts

    # ----------------------------------------------------------- operations

    def halo(self, x: torch.Tensor, dim: int = H_DIM
             ) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """``x`` with one plane of ``dim`` from each neighbour that exists
        (the previous rank's last before, the next rank's first after) and
        ``(lo, hi)``, the planes added on each side (0 or 1). A conv of the
        result with SAME padding, cropped by :func:`crop`, equals the
        unsharded conv's rows of this rank: the group's outer edges keep the
        zero padding."""
        if self.size == 1:
            return x, (0, 0)
        tracing.count("spatial.halo")
        with tracing.span("ddpm.spatial.halo"):
            lo, hi = int(self.index > 0), int(self.index < self.size - 1)
            sends = {}
            if lo:
                sends[self.index - 1] = x.narrow(dim, 0, 1).contiguous()
            if hi:
                sends[self.index + 1] = x.narrow(dim, x.shape[dim] - 1,
                                                 1).contiguous()
            got = self._exchange(sends)
            parts = ([got[self.index - 1]] if lo else []) + [x] + (
                [got[self.index + 1]] if hi else [])
            return torch.cat(parts, dim), (lo, hi)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every member's ``t``, as a new tensor (``t`` is left
        as it is: the fused path keeps local sums for later folds)."""
        if self.size == 1:
            return t
        tracing.count("spatial.all_reduce_sum")
        with tracing.span("ddpm.spatial.reduce"):
            return self._reduce(t.contiguous(), "sum")

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of every member's ``t``, as a new tensor."""
        if self.size == 1:
            return t
        tracing.count("spatial.all_reduce_max")
        with tracing.span("ddpm.spatial.reduce"):
            return self._reduce(t.contiguous(), "max")

    def all_gather_h(self, x: torch.Tensor, dim: int = H_DIM) -> torch.Tensor:
        """The members' shards of ``x`` concatenated along ``dim`` in rank
        order: the whole tensor, on every member."""
        if self.size == 1:
            return x
        tracing.count("spatial.all_gather_h")
        return torch.cat(self._gather(x.contiguous()), dim)


def crop(y: torch.Tensor, lo: int, hi: int, dim: int = H_DIM) -> torch.Tensor:
    """``y`` without ``lo`` leading and ``hi`` trailing planes of ``dim``
    (the rows a :meth:`SpatialGroup.halo` added), contiguous."""
    if lo == hi == 0:
        return y
    return y.narrow(dim, lo, y.shape[dim] - lo - hi).contiguous()
