"""Pipeline-parallel BEVFormer decoder: layer stages, FRAMES as microbatches
(port of `bevformer_tensorrt_tpu/parallel/pp_decoder.py`).

The decoder's self-attention couples all object queries inside every layer,
so its query axis cannot be microbatched as the encoder's is.  It is a pure
consumer of the encoder's bev_embed (the temporal recurrence feeds the next
frame's encoder, never the decoder), so consecutive frames are independent
decoder workloads: frame f occupies stage s while frame f + 1 occupies
stage s - 1.  Each stage runs its layers with their reg branches (the
iterative box refinement).

The carry is a tuple (query, reference points, the per-layer states and
references so far); `pipeline_apply` hops each tensor.  A stage appends its
layers' outputs by rolling the per-layer stacks and writing the last slot,
so no stage needs its global layer index: after all L layers slot i holds
layer i's output, as the JAX module's packed carry does.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..models.layers import inverse_sigmoid
from .pipeline import pipeline_apply


def stage_modules(decoder, head, mesh, axis: str = "pp") -> Tuple[List, List]:
    """This rank's stage: (its decoder layers, their reg branches)."""
    S, s = mesh.axis_size(axis), mesh.axis_index(axis)
    per = decoder.cfg.decoder_layers // S
    ids = range(s * per, (s + 1) * per)
    return ([getattr(decoder, f"layer{i}") for i in ids],
            [getattr(head, f"reg_branch{i}") for i in ids])


def decoder_pp_forward(
    cfg,
    layers,           # this rank's stage: decoder_layers / pp DecoderLayer modules
    regs,             # their RegBranch modules (iterative refinement)
    query,            # [1, nq, C] initial object queries (the same every frame)
    query_pos,        # [1, nq, C]
    values,           # [F, 1, bev_h*bev_w, C] one bev_embed per frame
    reference_points,  # [1, nq, 3] sigmoid space (the same every frame)
    mesh,
    axis: str = "pp",
):
    """Returns (inter_states [F, L, 1, nq, C], inter_refs [F, L, 1, nq, 3])."""
    C = cfg.embed_dims
    L = cfg.decoder_layers
    S = mesh.axis_size(axis)
    assert L % S == 0, f"decoder_layers {L} must divide into pp={S} stages"
    per_stage = L // S
    assert len(layers) == per_stage and len(regs) == per_stage, (
        f"a stage holds {per_stage} layers and reg branches")
    F = values.shape[0]
    nq = query.shape[1]
    ss = ((cfg.bev_h, cfg.bev_w),)
    dt = getattr(torch, cfg.dtype)

    def fn(stage, x, c):
        q, ref, states, refs = x
        for layer, reg in zip(*stage):
            ref_2d = ref[..., :2].reshape(1, -1, 1, 2)
            q = layer(q.to(dt), c["query_pos"].to(dt), c["value"].to(dt), ref_2d, ss).float()
            tmp = reg(q).float()
            ref = torch.sigmoid(torch.cat([
                tmp[..., 0:2] + inverse_sigmoid(ref[..., 0:2]),
                tmp[..., 4:5] + inverse_sigmoid(ref[..., 2:3]),
            ], dim=-1))
            # append: roll out slot 0, write this layer at the end
            states = torch.cat([states[1:], q[None]])
            refs = torch.cat([refs[1:], ref[None]])
        return (q, ref, states, refs)

    dev = query.device
    x = (query.float().expand(F, *query.shape).contiguous(),
         reference_points.float().expand(F, *reference_points.shape).contiguous(),
         torch.zeros((F, L, 1, nq, C), dtype=torch.float32, device=dev),
         torch.zeros((F, L, 1, nq, 3), dtype=torch.float32, device=dev))
    consts = {
        "value": values,                                             # [F, 1, nk, C]
        "query_pos": query_pos.expand(F, *query_pos.shape).contiguous(),
    }
    _, _, states, refs = pipeline_apply(fn, (list(layers), list(regs)), x, mesh, axis=axis,
                                        consts=consts)
    return states.to(dt), refs
