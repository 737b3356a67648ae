"""Sequence-parallel hooks (port of `bevformer_tensorrt_tpu/parallel/ops.py`).

The JAX package annotates the BEV-query axis with a sharding constraint
under an ambient mesh (`jax.set_mesh`) and GSPMD splits the encoder's
per-query work over tp.  Here the ambient mesh is `set_mesh`, and the
encoder asks `sequence_rows` for its rank's rows, runs each layer on them
and all-gathers the layer's output (`gather_bev_queries`).  With no mesh
set every hook is the identity.  As in the JAX function a dim that does not
divide the axis leaves the tensor whole: that is the reference's rule, on
every device.
"""
from __future__ import annotations

import contextlib
from typing import Optional

from . import comm

_AMBIENT = []  # the meshes of the open `set_mesh` blocks, innermost last


@contextlib.contextmanager
def set_mesh(mesh):
    """Run the block under `mesh` (the JAX `with jax.set_mesh(mesh)`)."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def ambient_mesh():
    return _AMBIENT[-1] if _AMBIENT else None


def maybe_shard(x, *spec):
    """This rank's part of `x` under the ambient mesh along every dim whose
    spec names an axis of it, if every such dim divides; otherwise `x`
    whole.  Differentiable (the gradient's parts are all-gathered)."""
    mesh = ambient_mesh()
    if mesh is None:
        return x
    for dim, ax in zip(x.shape, spec):
        if ax is None:
            continue
        if ax not in mesh.axis_names or dim % mesh.axis_size(ax):
            return x
    for d, ax in enumerate(spec):
        if ax is not None:
            x = comm.scatter_to(x, mesh, ax, d)
    return x


def sequence_rows(nq: int, axis: str = "tp") -> slice:
    """This tp rank's rows of an nq-row BEV grid under the ambient mesh; the
    whole grid with no mesh, one rank on the axis, or nq not divisible."""
    mesh = ambient_mesh()
    if mesh is None or mesh.axis_size(axis) == 1 or nq % mesh.axis_size(axis):
        return slice(0, nq)
    per = nq // mesh.axis_size(axis)
    i = mesh.axis_index(axis)
    return slice(i * per, (i + 1) * per)


def shard_bev_queries(x):
    """[..., nq, C] BEV-query tensors: shard nq over tp."""
    if x.dim() == 3:
        return maybe_shard(x, None, "tp", None)
    return x


def gather_bev_queries(x, nq: int, axis: str = "tp"):
    """The tp ranks' `sequence_rows` of a [b, nq / tp, C] tensor,
    all-gathered into the nq-row grid; `x` itself where it is the grid."""
    if x.shape[1] == nq:
        return x
    return comm.gather_from(x, ambient_mesh(), axis, 1)
