"""The yardstick of the per-layer shares: published peaks of one NVIDIA H100
SXM and the work a frame must do in MSDA and in the DCN, from the
configuration's shapes.

A bound is the least time the card could take for the work: the larger of
its bytes over the memory rate and its operations over the peak rate of its
type.  Bytes count each input read once and each output written once (an
MSDA value table counts only the rows its queries can reach, where those
are fewer); operations are 2 a multiply-add.  The formulas are those of the
program's kernel bench (`tools/kernel_cases.py`: `msda_work`, `dcn_op_work`,
`bound`), copied so that no later change to the program moves them.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
ESIZE = {"float32": 4, "bfloat16": 2}


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def msda_work(queries: Sequence[int], keys: int, heads: int, ch: int, levels: int, points: int,
              ppg: int, esz: int) -> Tuple[int, int]:
    """(bytes, flops) of one MSDA launch over a batch whose entry b has
    `queries[b]` queries on a value table of `keys` rows: the rows the
    queries can gather (4 corners a tap) where fewer than the table, the
    offsets, logits, float32 reference points and the output; 8 flops a
    (query, head, tap, channel)."""
    taps = heads * levels * points
    nbytes = flops = 0
    for q in queries:
        gathered = min(keys * heads * ch, q * taps * 4 * ch)
        nbytes += (gathered + q * taps * 3 + q * heads * ch) * esz + q * 2 * ppg * 4
        flops += q * taps * 4 * ch * 2
    return nbytes, flops


def dcn_op_work(n: int, cin: int, h: int, w: int, cout: int, stride: int, esz: int,
                taps: int = 9) -> Tuple[int, int]:
    """(bytes, flops) of one 3x3 modulated deformable convolution (one
    deform group, one group): the map, offsets, mask and weight read once,
    the output written once; 2 flops a multiply-add of the product."""
    s = ((h - 1) // stride + 1) * ((w - 1) // stride + 1)
    nbytes = (n * cin * h * w + n * 3 * taps * s + cout * taps * cin + n * cout * s) * esz
    return nbytes, 2 * n * cout * taps * cin * s


def halve(n: int) -> int:
    return -(-n // 2)


def level_shapes(m: dict) -> List[Tuple[int, int]]:
    """The FPN levels' (h, w): stage i of the ResNet at stride 2^(i + 2),
    every stride-2 layer rounding up, extra levels halving the last."""
    h, w = m["img_h"], m["img_w"]
    stages = []
    h, w = halve(halve(h)), halve(halve(w))  # stem and max-pool
    for stage in range(4):
        if stage:
            h, w = halve(h), halve(w)
        stages.append((h, w))
    shapes = [stages[i] for i in m["backbone_out_indices"]]
    while len(shapes) < m["num_levels"]:
        shapes.append((halve(shapes[-1][0]), halve(shapes[-1][1])))
    return shapes


def msda_frame_s(m: dict, visible: Sequence[int], dtype: str) -> float:
    """Least seconds of a frame's MSDA launches: per encoder layer the
    temporal self-attention (the queue of 2 over the BEV) and the spatial
    cross-attention (each camera over the BEV queries it sees, `visible`),
    per decoder layer the cross-attention of the object queries."""
    esz = ESIZE[dtype]
    H, C = m["num_heads"], m["embed_dims"]
    nq = m["bev_h"] * m["bev_w"]
    shapes = level_shapes(m)
    keys = sum(h * w for h, w in shapes)
    tsa = msda_work([nq, nq], nq, H, C // H, 1, m["num_points_self"], 1, esz)
    sca = msda_work(list(visible), keys, H, C // H, len(shapes), m["num_points_cross"],
                    m["num_points_in_pillar"], esz)
    dec = msda_work([m["num_query"]], nq, H, C // H, 1, m["num_points_decoder"], 1, esz)
    return (m["encoder_layers"] * (bound_s(*tsa, dtype) + bound_s(*sca, dtype))
            + m["decoder_layers"] * bound_s(*dec, dtype))


def dcn_frame_s(m: dict, dtype: str) -> float:
    """Least seconds of a frame's DCN launches: every block of a DCN stage
    (its 3x3 at stride 1 in the caffe style, which puts the stride on the
    first 1x1, and at the stage's stride in the first block otherwise)."""
    esz = ESIZE[dtype]
    blocks = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[m["backbone_depth"]]
    caffe = m["backbone_depth"] == 101
    h, w = halve(halve(m["img_h"])), halve(halve(m["img_w"]))
    total = 0.0
    for stage, n in enumerate(blocks):
        planes = 64 * 2 ** stage
        out_h, out_w = (halve(h), halve(w)) if stage else (h, w)
        if m["dcn_stages"][stage]:
            for b in range(n):
                first_stride = 2 if (stage and b == 0 and not caffe) else 1
                in_h, in_w = (h, w) if first_stride == 2 else (out_h, out_w)
                work = dcn_op_work(m["num_cams"], planes, in_h, in_w, planes, first_stride, esz)
                total += bound_s(*work, dtype)
        h, w = out_h, out_w
    return total
