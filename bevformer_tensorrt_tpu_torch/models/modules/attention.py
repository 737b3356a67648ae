"""BEVFormer attention modules (port of `bevformer_tensorrt_tpu/models/modules/attention.py`,
the q-major branches).

All are batch-first, single-sample (bs = 1), with the camera / BEV-queue
axes folded into the op batch.  The three deformable callers (temporal
self-attention, spatial cross-attention, decoder cross-attention) go through
`ops.msda.multi_scale_deformable_attn`, and the decoder self-attention
through `ops.attention.flash_attention`; both launch their CUDA kernel for
CUDA tensors.

Every projection takes the model's `quant` mode.  Under "int8" a deformable
module reads its value table as int8 (`multi_scale_deformable_attn_int8`)
unless the policy excludes its pseudo-site `<module>/msda_tables`, and the
decoder self-attention runs the int8 flash kernel unless `<module>/flash` is
excluded or the head width is not 32 or 64; otherwise, under quant, its q, k
and v pass the QDQ sites `qdq_q/k/v` ahead of the floating-point kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from ...ops import attention as attn_ops
from ...ops import msda as msda_ops
from ...quant.policy import effective_quant
from ...quant.qdq import QDQ
from ..layers import QDense

Shapes = Tuple[Tuple[int, int], ...]


def compaction_size(nq: int, cam_budget: float) -> int:
    """Per-camera query budget K: nq * cam_budget rounded up to 128."""
    return min(nq, max(128, -(-int(nq * cam_budget) // 128) * 128))


def camera_compaction(bev_mask, reference_points_cam, K: int):
    """Per-camera top-K of the BEV queries by visibility weight.

    A stable descending sort keeps the lower index on ties, as
    `jax.lax.top_k` does.  Invisible picks (weight 0) are pinned outside
    the image (2.0) so their bilinear weights are exactly 0.
    Returns (topi [cams, K], topv [cams, K], ref_c [cams, K, 1, ppg*2])."""
    cams, nq = reference_points_cam.shape[:2]
    vals, order = torch.sort(bev_mask.reshape(cams, nq), dim=1, descending=True, stable=True)
    topv, topi = vals[:, :K], order[:, :K]
    ref_c = torch.gather(
        reference_points_cam, 1, topi[..., None].expand(-1, -1, reference_points_cam.shape[-1])
    ).reshape(cams, K, 1, -1)
    ref_c = torch.where((topv > 0).reshape(cams, K, 1, 1), ref_c, torch.full_like(ref_c, 2.0))
    return topi, topv, ref_c


class _DeformableAttention(nn.Module):
    """The value-table choice shared by the three deformable modules: int8
    tables when the module's `quant` is "int8" and the policy does not
    exclude `<module>/msda_tables`."""

    def __init__(self, quant=False):
        super().__init__()
        self.quant = quant
        self.int8_tables = quant == "int8"

    def resolve_quant(self, path, exclude) -> None:
        self.int8_tables = effective_quant(
            self.quant, tuple(path) + ("msda_tables",), exclude) == "int8"

    def msda(self, value, reference_points, sampling_offsets, attention_weights,
             spatial_shapes):
        op = (msda_ops.multi_scale_deformable_attn_int8 if self.int8_tables
              else msda_ops.multi_scale_deformable_attn)
        return op(value, reference_points, sampling_offsets, attention_weights, spatial_shapes)


class TemporalSelfAttention(_DeformableAttention):
    """Deformable self-attention over the 2-frame BEV queue: offsets and
    weights come from concat(prev_bev, query), MSDA runs with the queue folded
    into the batch, and the two queue entries are averaged."""

    def __init__(self, embed_dims=256, num_heads=8, num_levels=1, num_points=4,
                 num_bev_queue=2, quant=False):
        super().__init__(quant)
        C, H, L, P, Q = embed_dims, num_heads, num_levels, num_points, num_bev_queue
        self.dims = (C, H, L, P, Q)
        self.value_proj = QDense(C, C, quant=quant)
        self.sampling_offsets = QDense(2 * C, Q * H * L * P * 2, quant=quant)
        self.attention_weights = QDense(2 * C, Q * H * L * P, quant=quant)
        self.output_proj = QDense(C, C, quant=quant)

    def forward(self, query, value, identity, query_pos, reference_points, spatial_shapes: Shapes):
        """query [1, nq, C]; value [2, nq, C] (prev_bev, current);
        reference_points [2, nq, 1, 2]."""
        C, H, L, P, Q = self.dims
        nq = query.shape[1]
        if query_pos is not None:
            query = query + query_pos
        qcat = torch.cat([value[0:1], query], dim=-1)  # [1, nq, 2C]
        v = self.value_proj(value).reshape(Q, value.shape[1], H, C // H)
        # feature order (H, Q, L*P*2): the queue folds into the batch
        off = self.sampling_offsets(qcat).reshape(nq, H, Q, L * P * 2).permute(2, 0, 1, 3)
        attn = self.attention_weights(qcat).reshape(nq, H, Q, L * P).permute(2, 0, 1, 3)
        out = self.msda(
            v, reference_points.reshape(Q, nq, 1, 2).contiguous(), off.contiguous(),
            attn.contiguous(), spatial_shapes,
        )  # [Q, nq, C]
        out = out.mean(dim=0, keepdim=True)  # average history and current
        out = self.output_proj(out)
        return out + (query if identity is None else identity)


class MSDeformableAttention3D(_DeformableAttention):
    """Per-camera deformable attention over the image features.  Offsets and
    weights are computed once from the BEV query; with K < nq each camera
    gathers only its top-K visible queries, and a weighted index-add writes
    them back (on CUDA an atomic add, so the order of the at most `cams`
    adds per query varies from run to run)."""

    def __init__(self, embed_dims=256, num_heads=8, num_levels=4, num_points=8,
                 cam_budget=0.5, quant=False):
        super().__init__(quant)
        C, H = embed_dims, num_heads
        self.dims = (C, H, num_levels, num_points)
        self.cam_budget = cam_budget
        self.value_proj = QDense(C, C, quant=quant)
        self.sampling_offsets = QDense(C, H * num_levels * num_points * 2, quant=quant)
        self.attention_weights = QDense(C, H * num_levels * num_points, quant=quant)

    def forward(self, query, value, reference_points_cam, bev_mask, spatial_shapes: Shapes,
                compaction=None):
        """query [1, nq, C]; value [cams, keys, C];
        reference_points_cam [cams, nq, ppg*2]; bev_mask [cams, nq, 1]."""
        C, H, L, P = self.dims
        cams, nq = reference_points_cam.shape[:2]
        K = compaction_size(nq, self.cam_budget)
        v = self.value_proj(value).reshape(cams, -1, H, C // H)
        off = self.sampling_offsets(query).reshape(nq, H, L * P * 2)
        attn = self.attention_weights(query).reshape(nq, H, L * P)
        if K < nq:
            if compaction is None:
                compaction = camera_compaction(bev_mask, reference_points_cam, K)
            topi, topv, ref_c = compaction
            out_k = self.msda(
                v, ref_c.contiguous(), off[topi], attn[topi], spatial_shapes)  # [cams, K, C]
            weighted = (out_k * topv[..., None]).to(out_k.dtype)
            slots = out_k.new_zeros((nq, C)).index_add_(
                0, topi.reshape(-1), weighted.reshape(-1, C))
            return slots[None]
        ref = reference_points_cam.reshape(cams, nq, 1, -1).contiguous()
        out = self.msda(
            v, ref, off[None].expand(cams, -1, -1, -1).contiguous(),
            attn[None].expand(cams, -1, -1, -1).contiguous(), spatial_shapes)
        return (out * bev_mask).sum(dim=0, keepdim=True)


class SpatialCrossAttention(nn.Module):
    """Camera-folded spatial cross-attention: per-camera MSDA3D combined with
    the normalized bev_mask weights, then output projection + residual."""

    def __init__(self, embed_dims=256, num_cams=6, num_heads=8, num_levels=4, num_points=8,
                 cam_budget=0.5, quant=False):
        super().__init__()
        self.deformable_attention = MSDeformableAttention3D(
            embed_dims, num_heads, num_levels, num_points, cam_budget, quant=quant)
        self.output_proj = QDense(embed_dims, embed_dims, quant=quant)

    def forward(self, query, value, identity, query_pos, reference_points_cam, bev_mask,
                spatial_shapes: Shapes, compaction=None):
        inp_residual = query if identity is None else identity
        if query_pos is not None:
            query = query + query_pos
        slots = self.deformable_attention(query, value, reference_points_cam, bev_mask,
                                          spatial_shapes, compaction)
        return self.output_proj(slots) + inp_residual


class CustomMSDeformableAttention(_DeformableAttention):
    """Decoder cross-attention: object queries sample the BEV plane."""

    def __init__(self, embed_dims=256, num_heads=8, num_levels=1, num_points=4, quant=False):
        super().__init__(quant)
        C, H = embed_dims, num_heads
        self.dims = (C, H, num_levels, num_points)
        self.value_proj = QDense(C, C, quant=quant)
        self.sampling_offsets = QDense(C, H * num_levels * num_points * 2, quant=quant)
        self.attention_weights = QDense(C, H * num_levels * num_points, quant=quant)
        self.output_proj = QDense(C, C, quant=quant)

    def forward(self, query, value, identity, query_pos, reference_points,
                spatial_shapes: Shapes):
        """query [1, nq, C]; value [1, keys, C]; reference_points [1, nq, 1, 2]."""
        inp_residual = query if identity is None else identity
        if query_pos is not None:
            query = query + query_pos
        C, H, L, P = self.dims
        nq = query.shape[1]
        v = self.value_proj(value).reshape(1, -1, H, C // H)
        off = self.sampling_offsets(query).reshape(1, nq, H, L * P * 2)
        attn = self.attention_weights(query).reshape(1, nq, H, L * P)
        out = self.msda(
            v, reference_points.reshape(1, nq, 1, 2).contiguous(), off, attn, spatial_shapes)
        return self.output_proj(out) + inp_residual


class MultiheadAttention(nn.Module):
    """Decoder self-attention over the object queries through the fused
    flash-attention op."""

    def __init__(self, embed_dims=256, num_heads=8, quant=False):
        super().__init__()
        C = embed_dims
        self.num_heads = num_heads
        self.quant = quant
        self.q_proj = QDense(C, C, quant=quant)
        self.k_proj = QDense(C, C, quant=quant)
        self.v_proj = QDense(C, C, quant=quant)
        self.out_proj = QDense(C, C, quant=quant)
        if quant:
            self.qdq_q, self.qdq_k, self.qdq_v = QDQ(), QDQ(), QDQ()
        self.resolve_quant((), ())

    def resolve_quant(self, path, exclude) -> None:
        """int8 flash when the policy leaves `<module>/flash` on int8 and the
        head width fits; it quantizes q, k, v itself, so their QDQ sites are
        then switched off (a fake-quant pass ahead of it would round twice)."""
        head_dim = self.q_proj.out_features // self.num_heads
        self.int8_flash = (
            effective_quant(self.quant, tuple(path) + ("flash",), exclude) == "int8"
            and head_dim in attn_ops.INT8_FLASH_HEAD_DIMS)
        if self.quant:
            for site in (self.qdq_q, self.qdq_k, self.qdq_v):
                site.mode = "off" if self.int8_flash else "quant"

    def forward(self, query, key, value, identity, query_pos, key_pos):
        inp_residual = query if identity is None else identity
        if query_pos is not None:
            query = query + query_pos
        if key_pos is not None:
            key = key + key_pos
        q, k, v = self.q_proj(query), self.k_proj(key), self.v_proj(value)
        if self.quant and not self.int8_flash:
            q, k, v = self.qdq_q(q)[0], self.qdq_k(k)[0], self.qdq_v(v)[0]
        out = attn_ops.multi_head_attention(q, k, v, num_heads=self.num_heads,
                                            int8=self.int8_flash)
        return self.out_proj(out) + inp_residual
