"""The benchmark's weights: every tensor of a BEVFormer checkpoint under its
upstream key (mmdet / mmcv names), drawn from the seed on the device.

The rule is the program's seeded initialisation in kind: LeCun-normal dense
and convolution kernels (std 1 / sqrt(fan-in)), zero biases except the
classification output's prior -4.595, unit norms and BatchNorm statistics of
mean 0 and variance 1, unit-normal embedding tables (BEV and object queries,
camera and level embeddings) and uniform [0, 1) positional tables.  The DCN
offset convolutions are scaled by `offset_conv_scale` (the configuration
file's `assumed`): LeCun-drawn ones give offsets of tens of pixels deep in
the backbone, where a seeded R101-DCN turns chaotic, while upstream starts
them at zero and trained ones move a few pixels.

All normal draws are one `torch.randn` call and all uniform draws one
`torch.rand` call on the generator's device, sliced into the tensors.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
CLS_PRIOR = -4.595

# kinds: ("lecun", fan_in) normal / sqrt(fan_in); "normal" unit normal; "uniform";
# "zeros"; "ones"; ("const", value)
Spec = Tuple[str, Tuple[int, ...], object]


def _conv(key: str, cin: int, cout: int, k: int, bias: bool) -> Iterator[Spec]:
    yield f"{key}.weight", (cout, cin, k, k), ("lecun", cin * k * k)
    if bias:
        yield f"{key}.bias", (cout,), "zeros"


def _bn(key: str, c: int) -> Iterator[Spec]:
    yield f"{key}.weight", (c,), "ones"
    yield f"{key}.bias", (c,), "zeros"
    yield f"{key}.running_mean", (c,), "zeros"
    yield f"{key}.running_var", (c,), "ones"


def _linear(key: str, cin: int, cout: int, bias_kind="zeros") -> Iterator[Spec]:
    yield f"{key}.weight", (cout, cin), ("lecun", cin)
    yield f"{key}.bias", (cout,), bias_kind


def _ln(key: str, c: int) -> Iterator[Spec]:
    yield f"{key}.weight", (c,), "ones"
    yield f"{key}.bias", (c,), "zeros"


def checkpoint_specs(m: dict) -> List[Spec]:
    """(upstream key, shape, kind) of every tensor of the checkpoint of the
    configuration's "model" section `m`."""
    C, H = m["embed_dims"], m["num_heads"]
    out: List[Spec] = []
    add = out.extend
    k = "img_backbone"
    add(_conv(f"{k}.conv1", 3, 64, 7, False))
    add(_bn(f"{k}.bn1", 64))
    inplanes = 64
    for stage, blocks in enumerate(STAGE_BLOCKS[m["backbone_depth"]]):
        planes = 64 * 2 ** stage
        for b in range(blocks):
            s = f"{k}.layer{stage + 1}.{b}"
            add(_conv(f"{s}.conv1", inplanes, planes, 1, False))
            add(_bn(f"{s}.bn1", planes))
            add(_conv(f"{s}.conv2", planes, planes, 3, False))
            if m["dcn_stages"][stage]:
                add(_conv(f"{s}.conv2.conv_offset", planes, 27, 3, True))
            add(_bn(f"{s}.bn2", planes))
            add(_conv(f"{s}.conv3", planes, planes * 4, 1, False))
            add(_bn(f"{s}.bn3", planes * 4))
            if b == 0:
                add(_conv(f"{s}.downsample.0", inplanes, planes * 4, 1, False))
                add(_bn(f"{s}.downsample.1", planes * 4))
            inplanes = planes * 4
    for i, idx in enumerate(m["backbone_out_indices"]):
        add(_conv(f"img_neck.lateral_convs.{i}.conv", 256 * 2 ** idx, C, 1, True))
    for i in range(m["num_levels"]):
        add(_conv(f"img_neck.fpn_convs.{i}.conv", C, C, 3, True))

    h = "pts_bbox_head"
    nq = m["bev_h"] * m["bev_w"]
    out.append((f"{h}.bev_embedding.weight", (nq, C), "normal"))
    out.append((f"{h}.query_embedding.weight", (m["num_query"], 2 * C), "normal"))
    out.append((f"{h}.positional_encoding.row_embed.weight", (m["bev_h"], C // 2), "uniform"))
    out.append((f"{h}.positional_encoding.col_embed.weight", (m["bev_w"], C // 2), "uniform"))
    for i in range(m["decoder_layers"]):
        c = f"{h}.cls_branches.{i}"
        add(_linear(f"{c}.0", C, C))
        add(_ln(f"{c}.1", C))
        add(_linear(f"{c}.3", C, C))
        add(_ln(f"{c}.4", C))
        add(_linear(f"{c}.6", C, m["num_classes"], ("const", CLS_PRIOR)))
        r = f"{h}.reg_branches.{i}"
        add(_linear(f"{r}.0", C, C))
        add(_linear(f"{r}.2", C, C))
        add(_linear(f"{r}.4", C, m["code_size"]))

    t = f"{h}.transformer"
    out.append((f"{t}.cams_embeds", (m["num_cams"], C), "normal"))
    out.append((f"{t}.level_embeds", (m["num_levels"], C), "normal"))
    add(_linear(f"{t}.reference_points", C, 3))
    add(_linear(f"{t}.can_bus_mlp.0", m["can_bus_dims"], C // 2))
    add(_linear(f"{t}.can_bus_mlp.2", C // 2, C))
    add(_ln(f"{t}.can_bus_mlp.norm", C))

    def ffn_norms(s):
        add(_linear(f"{s}.ffns.0.layers.0.0", C, m["ffn_dims"]))
        add(_linear(f"{s}.ffns.0.layers.1", m["ffn_dims"], C))
        for n in range(3):
            add(_ln(f"{s}.norms.{n}", C))

    for i in range(m["encoder_layers"]):
        s = f"{t}.encoder.layers.{i}"
        a = f"{s}.attentions.0"  # temporal self-attention over the queue of 2
        P = m["num_points_self"]
        add(_linear(f"{a}.sampling_offsets", 2 * C, 2 * H * P * 2))
        add(_linear(f"{a}.attention_weights", 2 * C, 2 * H * P))
        add(_linear(f"{a}.value_proj", C, C))
        add(_linear(f"{a}.output_proj", C, C))
        d = f"{s}.attentions.1.deformable_attention"
        LP = m["num_levels"] * m["num_points_cross"]
        add(_linear(f"{d}.sampling_offsets", C, H * LP * 2))
        add(_linear(f"{d}.attention_weights", C, H * LP))
        add(_linear(f"{d}.value_proj", C, C))
        add(_linear(f"{s}.attentions.1.output_proj", C, C))
        ffn_norms(s)
    for i in range(m["decoder_layers"]):
        s = f"{t}.decoder.layers.{i}"
        a = f"{s}.attentions.0.attn"
        out.append((f"{a}.in_proj_weight", (3 * C, C), ("lecun", C)))
        out.append((f"{a}.in_proj_bias", (3 * C,), "zeros"))
        add(_linear(f"{a}.out_proj", C, C))
        x = f"{s}.attentions.1"
        P = m["num_points_decoder"]
        add(_linear(f"{x}.sampling_offsets", C, H * P * 2))
        add(_linear(f"{x}.attention_weights", C, H * P))
        add(_linear(f"{x}.value_proj", C, C))
        add(_linear(f"{x}.output_proj", C, C))
        ffn_norms(s)
    return out


@torch.no_grad()
def seeded_checkpoint(m: dict, seed: int, device, offset_conv_scale: float
                      ) -> Dict[str, torch.Tensor]:
    """The upstream-layout checkpoint of `m` drawn from `seed` on `device`,
    float32."""
    specs = checkpoint_specs(m)
    gen = torch.Generator(device=device).manual_seed(seed)
    numel = lambda shape: math.prod(shape)  # noqa: E731
    n_normal = sum(numel(s) for _, s, kind in specs
                   if kind == "normal" or (isinstance(kind, tuple) and kind[0] == "lecun"))
    n_uniform = sum(numel(s) for _, s, kind in specs if kind == "uniform")
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    sd: Dict[str, torch.Tensor] = {}
    at_n = at_u = 0
    for key, shape, kind in specs:
        n = numel(shape)
        if kind == "uniform":
            t = uniform[at_u:at_u + n]
            at_u += n
        elif kind == "normal" or kind[0] == "lecun":
            t = normal[at_n:at_n + n]
            at_n += n
            if kind != "normal":
                t = t * (1.0 / math.sqrt(kind[1]))
                if ".conv_offset." in key:
                    t = t * offset_conv_scale
        elif kind == "zeros":
            t = torch.zeros(n, device=device)
        elif kind == "ones":
            t = torch.ones(n, device=device)
        else:
            t = torch.full((n,), float(kind[1]), device=device)
        sd[key] = t.reshape(shape)
    return sd
