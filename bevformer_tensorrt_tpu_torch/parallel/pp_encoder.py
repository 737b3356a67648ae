"""Pipeline-parallel BEVFormer encoder: the encoder layers as GPipe stages,
microbatching the BEV-query axis (port of
`bevformer_tensorrt_tpu/parallel/pp_encoder.py`).

Given the frame's constants (the image value tables, the prev_bev history,
the per-query geometry) every BEV query flows through a layer on its own:
temporal self-attention samples prev_bev (a constant grid), spatial
cross-attention samples the image features, and the FFN and norms are per
query.  So chunks of queries are microbatches and groups of layers are
stages.  On a scene's first frame (use_prev_bev = 0) the history is the
current query grid, which couples the queries within a layer: that frame
runs the sequential encoder.  The steady temporal frame pipelines exactly.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..models.modules.encoder import encoder_geometry, get_reference_points_3d
from .pipeline import pipeline_apply


def stage_layers(encoder, mesh, axis: str = "pp") -> List[torch.nn.Module]:
    """This rank's stage of a `BEVFormerEncoder`: layers [s * per, (s + 1) * per)."""
    S, s = mesh.axis_size(axis), mesh.axis_index(axis)
    per = encoder.cfg.encoder_layers // S
    return [getattr(encoder, f"layer{s * per + j}") for j in range(per)]


def encoder_pp_forward(
    cfg,
    layers,             # this rank's stage: encoder_layers / pp BEVFormerLayer modules
    bev_query,          # [1, nq, C]
    value,              # [cams, keys, C] (image value features)
    bev_pos,            # [1, nq, C]
    lidar2img,          # [1, cams, 4, 4]
    prev_bev,           # [1, nq, C] (already rotated/aligned)
    shift,              # [2]
    spatial_shapes: Tuple[Tuple[int, int], ...],
    mesh,
    axis: str = "pp",
    microbatches: int = 0,   # 0 -> 2 * pp size (the classic GPipe bubble ratio)
):
    """The temporal-frame (use_prev_bev = 1) encoder over the pp axis: equal
    to `BEVFormerEncoder.forward` at use_prev_bev = 1 and cam_budget = 1.0
    (the compaction's top-K crosses query chunks)."""
    nq = cfg.bev_h * cfg.bev_w
    S = mesh.axis_size(axis)
    assert cfg.encoder_layers % S == 0, (
        f"encoder_layers {cfg.encoder_layers} must divide into pp={S} stages"
    )
    per_stage = cfg.encoder_layers // S
    assert len(layers) == per_stage, f"a stage holds {per_stage} layers, got {len(layers)}"
    M = microbatches or 2 * S
    assert nq % M == 0, f"nq {nq} must split into {M} microbatches"
    chunk = nq // M

    use_prev = torch.ones((), dtype=torch.float32, device=bev_query.device)
    ref_3d = torch.from_numpy(get_reference_points_3d(
        cfg.bev_h, cfg.bev_w, cfg.num_points_in_pillar)).to(bev_query.device)
    hybrid_ref_2d, reference_points_cam, bev_mask, compaction = encoder_geometry(
        cfg, ref_3d, lidar2img, shift, use_prev)
    assert compaction is None, (
        "encoder_pp_forward requires cam_budget=1.0 "
        "(the compaction's top-K gather crosses query-chunk boundaries)"
    )
    # at use_prev_bev = 1 the per-layer history mux resolves to the constant
    # [prev_bev, bev_query] stack: sampled anywhere, so it stays whole (a
    # closure constant), never chunked
    prev_queue = torch.cat([prev_bev, bev_query], dim=0).to(bev_query.dtype)  # [2, nq, C]

    def fn(stage, x, c):
        # x: [1, chunk, C]; c: this microbatch's geometry rows
        for layer in stage:
            x = layer(x, value, c["bev_pos"], c["hybrid_ref_2d"], c["ref_cam"], c["mask"],
                      spatial_shapes, prev_queue, False, prev_q=c["prev_q"])
        return x

    def chunks(a, qaxis):
        # the query axis split into M leading microbatches, the other axes in order
        before, after = a.shape[:qaxis], a.shape[qaxis + 1:]
        am = a.movedim(qaxis, 0).reshape(M, chunk, *before, *after)
        return am.movedim(1, qaxis + 1)

    consts = {
        "bev_pos": chunks(bev_pos, 1),                 # [M, 1, chunk, C]
        "hybrid_ref_2d": chunks(hybrid_ref_2d, 1),     # [M, 2, chunk, 1, 2]
        "ref_cam": chunks(reference_points_cam, 1),    # [M, cams, chunk, P2]
        "mask": chunks(bev_mask, 1),                   # [M, cams, chunk, 1]
        "prev_q": chunks(prev_queue, 1),               # [M, 2, chunk, C]
    }
    x = chunks(bev_query, 1)                            # [M, 1, chunk, C]
    out = pipeline_apply(fn, list(layers), x, mesh, axis=axis, consts=consts)
    # [M, 1, chunk, C] -> [1, nq, C]
    return out.permute(1, 0, 2, 3).reshape(1, nq, bev_query.shape[-1])
