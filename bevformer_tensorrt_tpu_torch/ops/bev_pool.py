"""BEV Pool v2, BEVDet's LSS splat as a segment sum (port of
`bevformer_tensorrt_tpu/ops/bev_pool.py`).

The reference's BEVPoolV2TRT plugin (TensorRT/plugin/bev_pool_v2/
bevPoolKernel.cu:20-150) sums `depth[ranks_depth[i]] * feat[ranks_feat[i]]`
into `out[ranks_bev[i]]` for every point of a precomputed BEV-cell interval.
The JAX package computes it in XLA with no Pallas kernel, so the port
carries it on stock torch ops, in the JAX package's two formulations:

  scatter   one `index_add_` of the P contributions, pads into a dropped
            bucket; accumulates in the promoted input dtype.  On CUDA the
            adds to a cell with many points are not ordered, so its sums
            are not bit-reproducible from run to run.
  interval  a float32 prefix sum over the sorted contributions, each
            interval's sum as the difference of the prefix at its two ends,
            and one scatter of unique cells (the evaluator's default).  The
            prefix runs along the contiguous axis of a [C, P] copy: along
            the outer axis of [P, C], CUDA's scan gives each of the C
            columns one thread (146.7 ms against 2.1 ms for `scatter` at
            R50's 400000 points on an H100).

Pads carry rank -1.  They are masked to index 0 before every gather (a -1
index would read the last element) and their contributions zeroed.

The gathers are `index_select`s, whose backward is an `index_add_`: the
backward of advanced indexing (`x[idx]`) is a sorted, duplicate-serialising
`index_put_`, which took 245 of a 322 ms BEVDet-R50 training backward on an
H100, each feature pixel being gathered once per depth bin.
"""
from __future__ import annotations

import torch


def bev_pool_v2(depth, feat, ranks_depth, ranks_feat, ranks_bev, interval_starts=None,
                interval_lengths=None, out_height: int = 128, out_width: int = 128,
                impl: str = "scatter"):
    """LSS splat.

    Args:
      depth: [N, D, H, W] per-camera depth distributions.
      feat:  [N, H, W, C] per-camera image features.
      ranks_depth / ranks_feat: [P] integer flat indices into depth / feat.
      ranks_bev: [P] flat BEV cell in [0, out_height * out_width), -1 = pad,
        sorted ascending over the valid prefix (`voxel_pooling_prepare`).
      interval_starts / interval_lengths: [I] segment boundaries over the
        sorted ranks (pad intervals have length 0); needed by 'interval'.
      impl: 'scatter' or 'interval'.
    Returns:
      [1, out_height, out_width, C] in feat's dtype.
    """
    if impl not in ("scatter", "interval"):
        raise ValueError(f"bev_pool_v2 impl {impl!r}: expected 'scatter' or 'interval'")
    C = feat.shape[-1]
    cdtype = torch.float32 if impl == "interval" else torch.promote_types(depth.dtype,
                                                                          feat.dtype)
    d_flat = depth.to(cdtype).reshape(-1)
    f_flat = feat.to(cdtype).reshape(-1, C)
    valid = ranks_bev >= 0
    zero = torch.zeros((), dtype=ranks_bev.dtype, device=ranks_bev.device)
    rd = torch.where(valid, ranks_depth, zero).long()
    rf = torch.where(valid, ranks_feat, zero).long()
    nil = torch.zeros((), dtype=cdtype, device=feat.device)
    contrib = torch.where(valid[:, None],
                          d_flat.index_select(0, rd)[:, None] * f_flat.index_select(0, rf), nil)
    cells = out_height * out_width
    out = torch.zeros((cells + 1, C), dtype=cdtype, device=feat.device)

    if impl == "interval":
        if interval_starts is None or interval_lengths is None:
            raise ValueError("bev_pool_v2 impl 'interval' needs interval_starts and "
                             "interval_lengths")
        P = ranks_bev.shape[0]
        csum = torch.cumsum(contrib.T.contiguous(), dim=1)  # [C, P]
        starts = interval_starts.long()
        lens = interval_lengths.long()
        live = lens > 0
        hi = csum.index_select(1, (starts + lens - 1).clamp(0, P - 1))
        lo = torch.where(starts > 0, csum.index_select(1, (starts - 1).clamp(0, P - 1)), nil)
        seg = torch.where(live, hi - lo, nil).T  # [I, C]
        # live cells are unique; pad intervals share the dropped bucket
        cell = torch.where(live, ranks_bev[starts.clamp(0, P - 1)].long(),
                           torch.full_like(starts, cells))
        out.index_add_(0, cell, seg)
    else:
        rb = torch.where(valid, ranks_bev.long(), torch.full_like(rd, cells))
        out.index_add_(0, rb, contrib)
    return out[:-1].reshape(1, out_height, out_width, C).to(feat.dtype)
