"""The collectives of the parallel layer, on `torch.distributed`, and the
differentiable regions of Megatron-style tensor parallelism.

Every collective goes through this module, which counts it by kind and mesh
axis with its payload bytes (`COUNTS`, read by `tools/scaling_analysis.py`):
what GSPMD inserts for the JAX package and its HLO walk counted there.

Transport.  NCCL takes CUDA tensors for everything.  Gloo is a host library:
it takes CUDA tensors for all-reduce, broadcast and all-gather, but its
point-to-point sends read host memory only.  Under gloo, and only there, the
operations of `GLOO_HOST_ONLY` stage a CUDA tensor through host memory
(`STAGED` names those that did).  The choice is made from the backend's
name before the call; no failed call is retried another way.

Autograd.  `copy_to` is Megatron's f (identity forward, all-reduce of the
gradient), `reduce_from` its g (all-reduce forward, identity backward),
`scatter_to` takes this rank's part of a replicated tensor (backward: the
parts' gradients all-gathered), `gather_from` the reverse.  A region between
f (or a scatter) and g computes a disjoint share on every rank, so a
replicated parameter outside the region ends with its whole gradient on
every rank.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

# (kind, axis) -> {"count", "bytes"}: collectives since the last reset
COUNTS: Dict[Tuple[str, str], Dict[str, int]] = collections.defaultdict(
    lambda: {"count": 0, "bytes": 0})
STAGED: set = set()  # the operations that went through host memory under gloo
GLOO_HOST_ONLY = frozenset({"send_recv"})


def reset_counts() -> None:
    COUNTS.clear()


def counts() -> List[Dict]:
    return [{"kind": k, "axis": a, **v} for (k, a), v in sorted(COUNTS.items())]


def _count(kind: str, axis: str, x: torch.Tensor) -> None:
    rec = COUNTS[(kind, axis)]
    rec["count"] += 1
    rec["bytes"] += x.numel() * x.element_size()


def _staged(kind: str, group, x: torch.Tensor) -> bool:
    if x.device.type != "cuda" or kind not in GLOO_HOST_ONLY:
        return False
    if dist.get_backend(group) != "gloo":
        return False
    STAGED.add(kind)
    return True


def all_reduce(x: torch.Tensor, mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """The sum (or max) of `x` over the axis, in place; returned."""
    group = mesh.group(axis)
    if group is None:
        return x
    _count("all_reduce" if op == "sum" else f"all_reduce_{op}", axis, x)
    dist.all_reduce(x, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX, group=group)
    return x


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The axis ranks' `x` concatenated along `dim`, in rank order."""
    group = mesh.group(axis)
    if group is None:
        return x
    _count("all_gather", axis, x)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def broadcast(x: torch.Tensor, mesh, axis: str, src_index: int) -> torch.Tensor:
    """`x` of the axis rank at `src_index`, on every rank of the axis (in place)."""
    group = mesh.group(axis)
    if group is None:
        return x
    _count("broadcast", axis, x)
    dist.broadcast(x, src=mesh.ranks[axis][src_index], group=group)
    return x


def broadcast_world(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """`x` of global rank `src` on every rank of the world (in place)."""
    _count("broadcast", "world", x)
    dist.broadcast(x, src=src)
    return x


def exchange(sends: Sequence[Tuple[torch.Tensor, int]], recvs: Sequence[Tuple[torch.Tensor, int]],
             mesh, axis: str) -> None:
    """Point-to-point sends and receives along the axis in one batch
    (`batch_isend_irecv`); peers are axis indices.  Receive buffers are
    filled in place."""
    group = mesh.group(axis)
    if not sends and not recvs:
        return
    peers = mesh.ranks[axis]
    staged = any(_staged("send_recv", group, t) for t, _ in (*sends, *recvs))
    ops, landing = [], []
    for t, peer in sends:
        _count("send_recv", axis, t)
        ops.append(dist.P2POp(dist.isend, t.cpu() if staged else t.contiguous(), peers[peer],
                              group))
    for t, peer in recvs:
        buf = torch.empty(t.shape, dtype=t.dtype) if staged else t
        landing.append((t, buf))
        ops.append(dist.P2POp(dist.irecv, buf, peers[peer], group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for t, buf in landing:
        if buf is not t:
            t.copy_(buf)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x.contiguous().clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _part(x, mesh, axis, dim):
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    per = x.shape[dim] // n
    return x.narrow(dim, i * per, per)


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _part(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _part(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(), None, None, None


def copy_to(x, mesh, axis: str = "tp"):
    """f: identity forward, the gradient all-reduced over the axis."""
    return x if mesh.group(axis) is None else _CopyTo.apply(x, mesh, axis)


def reduce_from(x, mesh, axis: str = "tp"):
    """g: the partial results all-reduced, identity backward."""
    return x if mesh.group(axis) is None else _ReduceFrom.apply(x, mesh, axis)


def scatter_to(x, mesh, axis: str = "tp", dim: int = -1):
    """This rank's equal part of `x` along `dim` (backward: all-gather)."""
    dim = dim % x.dim()
    return x if mesh.group(axis) is None else _ScatterTo.apply(x, mesh, axis, dim)


def gather_from(x, mesh, axis: str = "tp", dim: int = -1):
    """The ranks' parts concatenated along `dim` (backward: this rank's part)."""
    dim = dim % x.dim()
    return x if mesh.group(axis) is None else _GatherFrom.apply(x, mesh, axis, dim)
