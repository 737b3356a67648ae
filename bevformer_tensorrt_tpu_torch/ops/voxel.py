"""Voxelization and points-in-boxes with static shapes (port of
`bevformer_tensorrt_tpu/ops/voxel.py`).

The reference's lidar CUDA extensions (third_party/bev_mmdet3d/ops/voxel,
the hard voxelizer, and ops/roiaware_pool3d; built but unused on the camera
path), as the JAX package writes them: every output has a static shape,
points are padded with nan, at most `max_voxels` voxels are kept, and the
scatters drop what falls past the end (JAX's `mode="drop"`: here one
overflow row, sliced off).
"""
from __future__ import annotations

from typing import Tuple

import torch


def voxelize(points: torch.Tensor, point_range: Tuple[float, ...],
             voxel_size: Tuple[float, float, float], grid_size: Tuple[int, int, int],
             max_voxels: int = 16000, max_points_per_voxel: int = 32):
    """Hard voxelization of points [N, F >= 3] (x, y, z, ...; nan rows are
    padding) over `point_range` (x0, y0, z0, x1, y1, z1).  Returns (voxels
    [V, P, F], coords [V, 3] int32 zyx (-1 where empty), num_points [V]
    int32, valid [V] bool), voxels numbered in order of their flat index and
    points kept first come first."""
    N, F = points.shape
    dev = points.device
    gx, gy, gz = grid_size
    total = gx * gy * gz
    lower = torch.tensor(point_range[:3], dtype=torch.float32, device=dev)
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    xyz = points[:, :3]
    finite = torch.isfinite(xyz).all(-1)
    c = torch.floor((torch.where(finite[:, None], xyz, lower) - lower) / vs).to(torch.int32)
    inb = (finite & (c[:, 0] >= 0) & (c[:, 0] < gx) & (c[:, 1] >= 0) & (c[:, 1] < gy)
           & (c[:, 2] >= 0) & (c[:, 2] < gz))
    flat = torch.where(inb, (c[:, 2] * gy + c[:, 1]) * gx + c[:, 0],
                       torch.full_like(c[:, 0], total))

    # voxel slots: the distinct flat indices, in order, by a stable sort
    order = torch.argsort(flat, stable=True)
    sf = flat[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), sf[1:] != sf[:-1]])
    first = first & (sf < total)
    voxel_rank = torch.cumsum(first, 0) - 1  # per sorted point: its voxel
    arange = torch.arange(N, device=dev)
    starts = torch.cummax(torch.where(first, arange, torch.full_like(arange, -1)), 0).values
    in_voxel_rank = arange - starts.clamp_min(0)
    keep = (voxel_rank < max_voxels) & (in_voxel_rank < max_points_per_voxel) & (sf < total)

    vr = torch.where(keep, voxel_rank, torch.full_like(voxel_rank, max_voxels))
    pr = torch.where(keep, in_voxel_rank, torch.zeros_like(in_voxel_rank))
    voxels = torch.zeros((max_voxels + 1, max_points_per_voxel, F), dtype=points.dtype,
                         device=dev)
    voxels[vr, pr] = points[order]

    head = first & (voxel_rank < max_voxels)
    vflat = torch.where(head, sf, torch.zeros_like(sf))
    czyx = torch.stack([vflat // (gx * gy), (vflat // gx) % gy, vflat % gx], -1).to(torch.int32)
    coords = torch.full((max_voxels + 1, 3), -1, dtype=torch.int32, device=dev)
    coords[torch.where(head, voxel_rank, torch.full_like(voxel_rank, max_voxels))] = czyx

    num_points = torch.zeros(max_voxels + 1, dtype=torch.int32, device=dev)
    num_points.index_add_(0, vr, keep.to(torch.int32))
    num_points = num_points[:max_voxels]
    return voxels[:max_voxels], coords[:max_voxels], num_points, num_points > 0


def points_in_rotated_boxes(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """points [N, 3] x boxes [B, 7] (cx, cy, cz, w, l, h, yaw; the z of the
    gravity centre) -> [N, B] bool (roiaware_pool3d's points_in_boxes)."""
    p = points[:, None, :]
    b = boxes[None]
    d = p[..., :2] - b[..., :2]
    c, s = torch.cos(-b[..., 6]), torch.sin(-b[..., 6])
    lx = d[..., 0] * c - d[..., 1] * s
    ly = d[..., 0] * s + d[..., 1] * c
    in_xy = (torch.abs(lx) <= b[..., 3] / 2) & (torch.abs(ly) <= b[..., 4] / 2)
    in_z = torch.abs(p[..., 2] - b[..., 2]) <= b[..., 5] / 2
    return in_xy & in_z


def roiaware_pool3d(rois: torch.Tensor, points: torch.Tensor, feats: torch.Tensor,
                    out_size: Tuple[int, int, int] = (4, 4, 4), mode: str = "max") -> torch.Tensor:
    """RoI-aware 3D pooling (third_party/bev_mmdet3d/ops/roiaware_pool3d/
    roiaware_pool3d.py:25-40): each rotated roi [B, 7] (x, y, z of the
    bottom centre, dx, dy, dz, yaw) cut into an `out_size` grid, the
    features [P, C] of the points [P, 3] in each cell max- or avg-pooled ->
    [B, nx, ny, nz, C]; empty cells 0, an occupied cell its true max."""
    if mode not in ("max", "avg"):
        raise ValueError(f"mode {mode!r}: expected 'max' or 'avg'")
    nx, ny, nz = out_size
    ncell = nx * ny * nz
    B, C = rois.shape[0], feats.shape[-1]
    d = points[None, :, :2] - rois[:, None, :2]  # [B, P, 2]
    c = torch.cos(-rois[:, None, 6])
    s = torch.sin(-rois[:, None, 6])
    lx = d[..., 0] * c - d[..., 1] * s + rois[:, None, 3] / 2
    ly = d[..., 0] * s + d[..., 1] * c + rois[:, None, 4] / 2
    lz = points[None, :, 2] - rois[:, None, 2]  # from the bottom centre
    cell = torch.stack([torch.floor(lx / rois[:, None, 3] * nx),
                        torch.floor(ly / rois[:, None, 4] * ny),
                        torch.floor(lz / rois[:, None, 5] * nz)], -1)
    finite = torch.isfinite(points).all(-1)[None] & torch.isfinite(cell).all(-1)
    cell = torch.where(finite[..., None], cell, torch.full_like(cell, -1)).to(torch.int32)
    inside = ((cell >= 0).all(-1) & (cell[..., 0] < nx) & (cell[..., 1] < ny)
              & (cell[..., 2] < nz) & finite)
    idx = torch.where(inside, (cell[..., 0] * ny + cell[..., 1]) * nz + cell[..., 2],
                      torch.full_like(cell[..., 0], ncell)).long()  # [B, P]; outside -> dropped
    idx = idx[..., None].expand(B, idx.shape[1], C)
    f = feats.float()[None].expand(B, -1, -1)
    if mode == "max":
        src = torch.where(inside[..., None], f, torch.full_like(f, -torch.inf))
        out = torch.full((B, ncell + 1, C), -torch.inf, device=feats.device)
        out = out.scatter_reduce(1, idx, src, "amax", include_self=True)[:, :ncell]
        out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    else:
        tot = torch.zeros((B, ncell + 1, C), device=feats.device).scatter_add(
            1, idx, torch.where(inside[..., None], f, torch.zeros_like(f)))[:, :ncell]
        cnt = torch.zeros((B, ncell + 1), device=feats.device).scatter_add(
            1, idx[..., 0], inside.float())[:, :ncell]
        out = tot / torch.clamp_min(cnt, 1.0)[..., None]
    return out.reshape(B, nx, ny, nz, C).to(feats.dtype)
