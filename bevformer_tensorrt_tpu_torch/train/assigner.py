"""Hungarian assignment on the host (port of `bevformer_tensorrt_tpu/train/assigner.py`).

The JAX package solves the assignment inside XLA with a while-loop because
host callbacks do not compose with pjit over a mesh.  On one card the host
is the idiomatic place, as the reference's HungarianAssigner3D does it:
scipy's `linear_sum_assignment`.  `assign_levels` brings every cost matrix
of a training step to the host in one copy and the assignment back in one.

Padding convention (the JAX package's): rows of padded ground truth carry a
constant cost, so they do not move the optimum of the real rows.  Here they
are left out of the solve and take the lowest free columns in order, which
is what the JAX solver gives them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def hungarian_assign(cost: np.ndarray, valid: Optional[np.ndarray] = None) -> np.ndarray:
    """Minimum-cost row -> column assignment.

    Args:
      cost: [R, C] cost matrix, R <= C (rows = GT boxes, cols = queries).
      valid: [R] bool, the rows to solve (default all); the others are
        padding and take the lowest columns the solved rows leave free.
    Returns:
      [R] int64, row2col[i] = the column of row i, all distinct.
    """
    cost = np.asarray(cost)
    R, C = cost.shape
    if R > C:
        raise ValueError(f"hungarian_assign: {R} rows > {C} columns")
    rows = np.arange(R) if valid is None else np.flatnonzero(np.asarray(valid, bool))
    row2col = np.full(R, -1, np.int64)
    if len(rows):
        # imported here: scipy.optimize takes ~2 s to import, which every
        # process importing the training package (the 2D CLIs too) would pay
        from scipy.optimize import linear_sum_assignment

        r, c = linear_sum_assignment(cost[rows])
        row2col[rows[r]] = c
    pad = np.flatnonzero(row2col < 0)
    free = np.setdiff1d(np.arange(C), row2col[row2col >= 0])  # sorted
    row2col[pad] = free[:len(pad)]
    return row2col


def assign_levels(costs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The assignment of every matrix of a step: costs [N, L, R, C] (N
    samples, L decoder levels, on any device) and valid [N, R] bool ->
    row2col [N, L, R] int64 on the costs' device.  The costs and the valid
    mask travel to the host as one tensor (the mask as a last column)."""
    N, L, R, C = costs.shape
    packed = torch.cat([costs.detach().float(),
                        valid[:, None, :, None].expand(N, L, R, 1).float()], dim=-1)
    host = packed.cpu().numpy()
    out = np.stack([[hungarian_assign(host[n, l, :, :C], host[n, l, :, C] > 0)
                     for l in range(L)] for n in range(N)])
    return torch.from_numpy(out.reshape(N, L, R)).to(costs.device)
