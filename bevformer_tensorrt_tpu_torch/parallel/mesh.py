"""Process meshes and axis conventions (port of `bevformer_tensorrt_tpu/parallel/mesh.py`).

The JAX package lays its devices out as one `jax.sharding.Mesh` and lets
GSPMD insert the collectives.  The port runs one process per card (torchrun's
layout) and gives every mesh axis its own process groups, on which the
parallel code calls its collectives explicitly (`parallel/comm.py`):

  dp - data parallel: one frame (or a share of the batch) per group.
  tp - tensor parallel: attention heads and FFN hidden units inside one
       frame, and under `parallel.ops.set_mesh` the BEV-query rows.
  pp - pipeline stages (`parallel/pipeline.py`), when the mesh has the axis.

Ranks sit on the mesh in row-major order over its axes, dp first: rank
d * tp + t is at (d, t), as `np.asarray(devs).reshape(dp, tp)`.  Every axis
has one group for each slice along it; a rank keeps the group of its own
slice.  A mesh of one process needs no process group at all.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def pick_dp_tp(n_devices: int, max_tp: int = 4) -> tuple[int, int]:
    """Factor n = dp * tp with tp the largest power of two <= max_tp dividing n."""
    tp = 1
    while tp * 2 <= max_tp and n_devices % (tp * 2) == 0:
        tp *= 2
    return n_devices // tp, tp


@dataclasses.dataclass(eq=False)
class Mesh:
    """A rank's view of the process mesh: the axis sizes, its coordinates,
    and the process group of its slice along each axis (None where the axis
    has size 1, or the world is one process)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    rank: int
    coords: Dict[str, int]
    groups: Dict[str, Optional[object]]
    ranks: Dict[str, Tuple[int, ...]]  # the global ranks of this rank's slice, per axis
    backend: Optional[str]

    @property
    def size(self) -> int:
        return int(np.prod([self.shape[a] for a in self.axis_names]))

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)

    def describe(self) -> str:
        return "x".join(f"{a}{self.shape[a]}" for a in self.axis_names)


def make_mesh(dp: Optional[int] = None, tp: Optional[int] = None, pp: Optional[int] = None,
              world_size: Optional[int] = None, rank: Optional[int] = None) -> Mesh:
    """The mesh over the world of the default process group (one process
    when none is initialised): dp x tp, or dp x tp x pp with `pp`.  With
    neither dp nor tp given, `pick_dp_tp` factors what pp leaves (tensor
    parallelism first, as in the JAX package).  Every rank must call it
    with the same arguments: it creates the axis groups collectively."""
    if world_size is None:
        world_size = dist.get_world_size() if dist.is_initialized() else 1
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    n = world_size // (pp or 1)
    if tp is None and dp is None:
        dp, tp = pick_dp_tp(n)
    elif tp is None:
        tp = n // dp
    elif dp is None:
        dp = n // tp
    names = ("dp", "tp") + (("pp",) if pp is not None else ())
    sizes = (dp, tp) + ((pp,) if pp is not None else ())
    if int(np.prod(sizes)) != world_size:
        raise ValueError(f"mesh {dict(zip(names, sizes))} does not cover {world_size} processes")
    grid = np.arange(world_size).reshape(sizes)
    coords = dict(zip(names, (int(c) for c in np.unravel_index(rank, sizes))))
    groups: Dict[str, Optional[object]] = {}
    ranks: Dict[str, Tuple[int, ...]] = {}
    for ax, name in enumerate(names):
        slices = np.moveaxis(grid, ax, -1).reshape(-1, sizes[ax])
        for members in slices:  # every rank creates every group, in one order
            members = tuple(int(r) for r in members)
            group = (dist.new_group(list(members)) if dist.is_initialized() and sizes[ax] > 1
                     else None)
            if rank in members:
                groups[name], ranks[name] = group, members
    backend = dist.get_backend() if dist.is_initialized() else None
    return Mesh(names, dict(zip(names, sizes)), rank, coords, groups, ranks, backend)


def init_distributed(device=None, backend: Optional[str] = None) -> Tuple[torch.device, int, int]:
    """Join the job torchrun describes (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
    `MASTER_ADDR`, `MASTER_PORT`).  A CUDA device is `cuda:LOCAL_RANK` with
    NCCL, the CPU takes gloo.  `backend` is for library callers that run
    gloo ranks on one card; no command line chooses it.  Returns (device,
    rank, world size)."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    kind = torch.device(device).type if device is not None else "cuda"
    dev = torch.device("cuda", local) if kind == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_initialized():
        # no device_id: NCCL then makes its communicator at the first NCCL
        # collective, so ranks that only meet at a gloo barrier can share a card
        dist.init_process_group(
            backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
            rank=rank, world_size=world)
    return dev, rank, world


def in_torchrun() -> bool:
    """Whether torchrun's variables describe a job to join."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))


def replicated(mesh: Mesh, x):
    """A replicated value is the whole value on every rank."""
    return x


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's dp slice of a leading batch axis of `n` (the JAX
    `P("dp", ...)`): every tp (and pp) rank of a dp group takes the same
    rows."""
    dp = mesh.axis_size("dp")
    if n % dp:
        raise ValueError(f"batch {n} does not divide over dp {dp}")
    per = n // dp
    d = mesh.axis_index("dp")
    return slice(d * per, (d + 1) * per)
