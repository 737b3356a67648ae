"""Load upstream (mmdet / mmcv) BEVFormer, BEVDet, YOLOX and CenterNet
checkpoints into the port (port of
`bevformer_tensorrt_tpu/runtime/torch_import.py`).

The upstream state_dict names its tensors `img_backbone.layer*.*`,
`img_neck.{lateral_convs,fpn_convs}.*`,
`pts_bbox_head.{transformer,cls_branches,reg_branches,...}`; the port names
every submodule as the flax module of the same role.  The port's layers keep
torch's layouts, so where the JAX importer transposes (Linear to
[in, out], conv OIHW to HWIO, the deformable conv's own weight) this loader
only renames:

  Linear / Conv weight, bias        -> the same tensors under the port's name
  BatchNorm weight, bias            -> FrozenBN weight, bias
  BatchNorm running_mean / _var     -> FrozenBN buffers mean / var (eps 1e-5
                                       on both sides)
  nn.MultiheadAttention in_proj     -> split into q_proj / k_proj / v_proj
  nn.Embedding `.weight` tables     -> the port's bare parameters

`load_bevformer_checkpoint` is strict in both directions: a key the model
needs and the checkpoint lacks, or a key of the checkpoint that no tensor of
the model takes, raises `KeyError` with the key's name.  Only BatchNorm's
`num_batches_tracked` counters and the head's `code_weights` (a loss weight)
are passed over: upstream checkpoints carry them and inference has no use
for them.  `load_bevdet_checkpoint` is the same for BEVDet's keys
(`bevdet_key_map`), and `load_yolox_checkpoint` / `load_centernet_checkpoint`
for the 2D family (`yolox_key_map`, `centernet_key_map`).  `upstream_layout`,
`bevdet_upstream_layout`, `yolox_upstream_layout` and
`centernet_upstream_layout` invert the renaming, for seeded checkpoints in
the upstream layout.  CenterNet's transposed convs keep torch's
[in, out, 4, 4] weight: the port's layer is torch's own, so nothing is
flipped (the JAX importer flips it for flax).
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from ..configs.bevdet import BEVDetConfig
from ..configs.bevformer import BEVFormerConfig
from ..configs.centernet import CenterNetConfig
from ..configs.yolox import YOLOXConfig
from ..models.backbones.csp_darknet import STAGES
from ..models.backbones.resnet import STAGE_BLOCKS
from ..models.heads.centernet_head import BRANCHES
from ..models.heads.centerpoint_head import HEADS

# (port key, upstream key, third): `third` is None, or 0 / 1 / 2 for the q / k /
# v rows of an nn.MultiheadAttention in_proj tensor
Entry = Tuple[str, str, Optional[int]]

IGNORED_SUFFIXES = (".num_batches_tracked",)
IGNORED_KEYS = ("pts_bbox_head.code_weights",)


def _wb(dst: str, src: str, bias: bool = True) -> Iterator[Entry]:
    yield f"{dst}.weight", f"{src}.weight", None
    if bias:
        yield f"{dst}.bias", f"{src}.bias", None


def _bn(dst: str, src: str) -> Iterator[Entry]:
    yield from _wb(dst, src)
    yield f"{dst}.mean", f"{src}.running_mean", None
    yield f"{dst}.var", f"{src}.running_var", None


def _resnet(depth: int, dcn_stages, dst: str, src: str) -> Iterator[Entry]:
    yield from _wb(f"{dst}.stem_conv", f"{src}.conv1", bias=False)
    yield from _bn(f"{dst}.stem_bn", f"{src}.bn1")
    for stage, blocks in enumerate(STAGE_BLOCKS[depth]):
        for b in range(blocks):
            d, s = f"{dst}.stage{stage}_block{b}", f"{src}.layer{stage + 1}.{b}"
            for n in (1, 2, 3):
                yield from _wb(f"{d}.conv{n}", f"{s}.conv{n}", bias=False)
                yield from _bn(f"{d}.bn{n}", f"{s}.bn{n}")
            if dcn_stages[stage]:  # mmcv DCN: conv2.weight beside conv2.conv_offset
                yield from _wb(f"{d}.conv2.conv_offset", f"{s}.conv2.conv_offset")
            if b == 0:
                yield from _wb(f"{d}.downsample_conv", f"{s}.downsample.0", bias=False)
                yield from _bn(f"{d}.downsample_bn", f"{s}.downsample.1")


def _attention_layers(dst: str, src: str, names) -> Iterator[Entry]:
    for name in names:
        yield from _wb(f"{dst}.{name}", f"{src}.{name}")


def _ffn_and_norms(dst: str, src: str) -> Iterator[Entry]:
    yield from _wb(f"{dst}.ffn.fc1", f"{src}.ffns.0.layers.0.0")
    yield from _wb(f"{dst}.ffn.fc2", f"{src}.ffns.0.layers.1")
    for n in range(3):
        yield from _wb(f"{dst}.norm{n + 1}", f"{src}.norms.{n}")


def bevformer_key_map(cfg: BEVFormerConfig) -> Iterator[Entry]:
    """Every tensor of `BEVFormer(cfg)`'s floating-point state_dict with the
    upstream key that holds it."""
    yield from _resnet(cfg.backbone_depth, cfg.dcn_stages, "img_backbone", "img_backbone")
    for i in range(len(cfg.backbone_out_indices)):
        yield from _wb(f"img_neck.lateral{i}", f"img_neck.lateral_convs.{i}.conv")
    for i in range(cfg.num_levels):
        yield from _wb(f"img_neck.fpn{i}", f"img_neck.fpn_convs.{i}.conv")

    h = "pts_bbox_head"
    yield f"{h}.bev_embedding", f"{h}.bev_embedding.weight", None
    yield f"{h}.query_embedding", f"{h}.query_embedding.weight", None
    for table in ("row_embed", "col_embed"):
        yield f"{h}.positional_encoding.{table}", f"{h}.positional_encoding.{table}.weight", None
    for i in range(cfg.decoder_layers):
        # cls branch: Linear(0) LayerNorm(1) ReLU Linear(3) LayerNorm(4) ReLU Linear(6)
        for name, n in (("fc1", 0), ("ln1", 1), ("fc2", 3), ("ln2", 4), ("out", 6)):
            yield from _wb(f"{h}.cls_branch{i}.{name}", f"{h}.cls_branches.{i}.{n}")
        # reg branch: Linear(0) ReLU Linear(2) ReLU Linear(4)
        for name, n in (("fc1", 0), ("fc2", 2), ("out", 4)):
            yield from _wb(f"{h}.reg_branch{i}.{name}", f"{h}.reg_branches.{i}.{n}")

    t = f"{h}.transformer"
    yield f"{t}.cams_embeds", f"{t}.cams_embeds", None
    yield f"{t}.level_embeds", f"{t}.level_embeds", None
    yield from _wb(f"{t}.reference_points", f"{t}.reference_points")
    yield from _wb(f"{t}.can_bus_fc1", f"{t}.can_bus_mlp.0")
    yield from _wb(f"{t}.can_bus_fc2", f"{t}.can_bus_mlp.2")
    yield from _wb(f"{t}.can_bus_norm", f"{t}.can_bus_mlp.norm")

    msda = ("sampling_offsets", "attention_weights", "value_proj")
    for i in range(cfg.encoder_layers):
        d, s = f"{t}.encoder.layer{i}", f"{t}.encoder.layers.{i}"
        yield from _attention_layers(f"{d}.self_attn", f"{s}.attentions.0",
                                     msda + ("output_proj",))
        yield from _attention_layers(f"{d}.cross_attn.deformable_attention",
                                     f"{s}.attentions.1.deformable_attention", msda)
        yield from _wb(f"{d}.cross_attn.output_proj", f"{s}.attentions.1.output_proj")
        yield from _ffn_and_norms(d, s)
    for i in range(cfg.decoder_layers):
        d, s = f"{t}.decoder.layer{i}", f"{t}.decoder.layers.{i}"
        mha = f"{s}.attentions.0.attn"
        for third, name in enumerate(("q_proj", "k_proj", "v_proj")):
            yield f"{d}.self_attn.{name}.weight", f"{mha}.in_proj_weight", third
            yield f"{d}.self_attn.{name}.bias", f"{mha}.in_proj_bias", third
        yield from _wb(f"{d}.self_attn.out_proj", f"{mha}.out_proj")
        yield from _attention_layers(f"{d}.cross_attn", f"{s}.attentions.1",
                                     msda + ("output_proj",))
        yield from _ffn_and_norms(d, s)


def bevdet_key_map(cfg: BEVDetConfig) -> Iterator[Entry]:
    """Every tensor of `BEVDet(cfg)`'s floating-point state_dict with the
    upstream key that holds it (bevdet-r50-cbgs naming):

      img_backbone.{conv1,bn1,layer*}          -> img_backbone (mmcv ResNet)
      img_neck.lateral_convs.{i}.conv          -> img_neck.lateral{i}
      img_neck.fpn_convs.0.conv                -> img_neck.fpn0
      img_view_transformer.depth_net           -> the same (a bare conv)
      img_bev_encoder_backbone.layers.{s}.{b}  -> stage{s}_block{b} (BasicBlocks;
                                                  downsample a bare 3x3 conv with bias)
      img_bev_encoder_neck.conv.{0,1,3,4}      -> conv1 / bn1 / conv2 / bn2
      img_bev_encoder_neck.up2.{1,2,4}         -> up_conv / up_bn / out_conv
      pts_bbox_head.shared_conv.{conv,bn}      -> shared_conv / shared_bn
      pts_bbox_head.task_heads.0.{h}.{0,1}     -> {h}.{conv1 + bn1, conv2}
    """
    yield from _resnet(cfg.backbone_depth, (False,) * 4, "img_backbone", "img_backbone")
    for i in range(len(cfg.backbone_out_indices)):
        yield from _wb(f"img_neck.lateral{i}", f"img_neck.lateral_convs.{i}.conv")
    yield from _wb("img_neck.fpn0", "img_neck.fpn_convs.0.conv")
    yield from _wb("img_view_transformer.depth_net", "img_view_transformer.depth_net")
    for s in range(len(cfg.bev_channels)):
        for b in range(2):
            d = f"img_bev_encoder_backbone.stage{s}_block{b}"
            src = f"img_bev_encoder_backbone.layers.{s}.{b}"
            for n in (1, 2):
                yield from _wb(f"{d}.conv{n}", f"{src}.conv{n}", bias=False)
                yield from _bn(f"{d}.bn{n}", f"{src}.bn{n}")
            if b == 0:  # every stage starts with stride 2
                yield from _wb(f"{d}.downsample_conv", f"{src}.downsample")
    n = "img_bev_encoder_neck"
    for dst, src, norm in (("conv1", "conv.0", False), ("bn1", "conv.1", True),
                           ("conv2", "conv.3", False), ("bn2", "conv.4", True),
                           ("up_conv", "up2.1", False), ("up_bn", "up2.2", True)):
        yield from (_bn(f"{n}.{dst}", f"{n}.{src}") if norm
                    else _wb(f"{n}.{dst}", f"{n}.{src}", bias=False))
    yield from _wb(f"{n}.out_conv", f"{n}.up2.4")
    h = "pts_bbox_head"
    yield from _wb(f"{h}.shared_conv", f"{h}.shared_conv.conv", bias=False)
    yield from _bn(f"{h}.shared_bn", f"{h}.shared_conv.bn")
    for name in [n for n, _ in HEADS] + ["heatmap"]:
        src = f"{h}.task_heads.0.{name}"
        yield from _wb(f"{h}.{name}.conv1", f"{src}.0.conv", bias=False)
        yield from _bn(f"{h}.{name}.bn1", f"{src}.0.bn")
        yield from _wb(f"{h}.{name}.conv2", f"{src}.1")


def _conv_module(dst: str, src: str) -> Iterator[Entry]:
    """mmcv ConvModule: conv (no bias) + BN."""
    yield from _wb(f"{dst}.conv", f"{src}.conv", bias=False)
    yield from _bn(f"{dst}.bn", f"{src}.bn")


def _csp_layer(dst: str, src: str, blocks: int) -> Iterator[Entry]:
    for name in ("main_conv", "short_conv"):
        yield from _conv_module(f"{dst}.{name}", f"{src}.{name}")
    for k in range(blocks):
        for n in ("conv1", "conv2"):
            yield from _conv_module(f"{dst}.block{k}.{n}", f"{src}.blocks.{k}.{n}")
    yield from _conv_module(f"{dst}.final_conv", f"{src}.final_conv")


def yolox_key_map(cfg: YOLOXConfig) -> Iterator[Entry]:
    """Every tensor of `YOLOX(cfg)`'s floating-point state_dict with the
    upstream key that holds it (mmdet naming):

      backbone.stem.conv                       -> backbone.stem.conv (Focus)
      backbone.stage{i}.0 / .1 (SPP) / .1|.2   -> stage{i}_down / _spp / _csp
      neck.{reduce_layers,top_down_blocks,downsamples,bottom_up_blocks,out_convs}.{k}
                                               -> neck.{reduce,td_csp,down,bu_csp,out}{k}
      bbox_head.multi_level_{cls,reg}_convs.{l}.{i} -> bbox_head.l{l}_{cls,reg}{i}
      bbox_head.multi_level_conv_{cls,reg,obj}.{l}  -> bbox_head.l{l}_{cls,reg,obj}_out
    """
    yield from _conv_module("backbone.stem.conv", "backbone.stem.conv")
    for i, (_, n, spp) in enumerate(STAGES, start=1):
        src = f"backbone.stage{i}"
        yield from _conv_module(f"backbone.stage{i}_down", f"{src}.0")
        if spp:
            for name in ("conv1", "conv2"):
                yield from _conv_module(f"backbone.stage{i}_spp.{name}", f"{src}.1.{name}")
        yield from _csp_layer(f"backbone.stage{i}_csp", f"{src}.{2 if spp else 1}",
                              max(round(n * cfg.deepen_factor), 1))
    levels = 3
    for k in range(levels - 1):
        yield from _conv_module(f"neck.reduce{k}", f"neck.reduce_layers.{k}")
        yield from _csp_layer(f"neck.td_csp{k}", f"neck.top_down_blocks.{k}", cfg.num_csp_blocks)
    for k in range(levels - 1):
        yield from _conv_module(f"neck.down{k}", f"neck.downsamples.{k}")
        yield from _csp_layer(f"neck.bu_csp{k}", f"neck.bottom_up_blocks.{k}", cfg.num_csp_blocks)
    for k in range(levels):
        yield from _conv_module(f"neck.out{k}", f"neck.out_convs.{k}")
    h = "bbox_head"
    for lvl in range(levels):
        for i in range(2):
            yield from _conv_module(f"{h}.l{lvl}_cls{i}", f"{h}.multi_level_cls_convs.{lvl}.{i}")
            yield from _conv_module(f"{h}.l{lvl}_reg{i}", f"{h}.multi_level_reg_convs.{lvl}.{i}")
        for name in ("cls", "reg", "obj"):
            yield from _wb(f"{h}.l{lvl}_{name}_out", f"{h}.multi_level_conv_{name}.{lvl}")


def centernet_key_map(cfg: CenterNetConfig) -> Iterator[Entry]:
    """Every tensor of `CenterNet(cfg)`'s floating-point state_dict with the
    upstream key that holds it (mmdet naming):

      backbone.{conv1,bn1,layer*}              -> backbone (mmcv ResNet, basic blocks)
      neck.deconv_layers.{2m}.conv (+ .conv_offset with DCN), .bn
                                               -> neck.dcn{m} (conv{m} without), dcn_bn{m}
      neck.deconv_layers.{2m+1}.conv, .bn      -> neck.deconv{m}, deconv_bn{m}
      bbox_head.{heatmap,wh,offset}_head.{0,2} -> bbox_head.{name}_conv / {name}_out
    """
    yield from _wb("backbone.stem_conv", "backbone.conv1", bias=False)
    yield from _bn("backbone.stem_bn", "backbone.bn1")
    for stage, blocks in enumerate(STAGE_BLOCKS[cfg.backbone_depth]):
        for b in range(blocks):
            d, s = f"backbone.stage{stage}_block{b}", f"backbone.layer{stage + 1}.{b}"
            for n in (1, 2):
                yield from _wb(f"{d}.conv{n}", f"{s}.conv{n}", bias=False)
                yield from _bn(f"{d}.bn{n}", f"{s}.bn{n}")
            if b == 0 and stage > 0:
                yield from _wb(f"{d}.downsample_conv", f"{s}.downsample.0", bias=False)
                yield from _bn(f"{d}.downsample_bn", f"{s}.downsample.1")
    for m in range(len(cfg.deconv_filters)):
        src = f"neck.deconv_layers.{2 * m}"
        if cfg.use_dcn:
            yield from _wb(f"neck.dcn{m}", f"{src}.conv", bias=False)
            yield from _wb(f"neck.dcn{m}.conv_offset", f"{src}.conv.conv_offset")
        else:
            yield from _wb(f"neck.conv{m}", f"{src}.conv", bias=False)
        yield from _bn(f"neck.dcn_bn{m}", f"{src}.bn")
        up = f"neck.deconv_layers.{2 * m + 1}"
        yield from _wb(f"neck.deconv{m}", f"{up}.conv", bias=False)
        yield from _bn(f"neck.deconv_bn{m}", f"{up}.bn")
    for name in BRANCHES:
        yield from _wb(f"bbox_head.{name}_conv", f"bbox_head.{name}_head.0")
        yield from _wb(f"bbox_head.{name}_out", f"bbox_head.{name}_head.2")


def _config_of(model_or_cfg, kind, what: str):
    cfg = getattr(model_or_cfg, "cfg", model_or_cfg)
    if not isinstance(cfg, kind):
        raise TypeError(f"{what}: expected a model or its {kind.__name__}, got "
                        f"{type(model_or_cfg).__name__}")
    return cfg


def _load(entries, state_dict: Mapping, what: str, family: str) -> Dict[str, torch.Tensor]:
    sd = {k.replace("module.", ""): v for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {}
    used = set()
    for dst, src, third in entries:
        if src not in sd:
            raise KeyError(f"{what}: the checkpoint has no key '{src}' (needed for '{dst}' of "
                           f"{family})")
        t = torch.as_tensor(np.asarray(sd[src]) if not torch.is_tensor(sd[src]) else sd[src])
        if third is not None:
            if t.shape[0] % 3:
                raise KeyError(f"{what}: '{src}' {tuple(t.shape)} does not split into q, k "
                               "and v")
            c = t.shape[0] // 3
            t = t[third * c:(third + 1) * c]
        out[dst] = t.detach().to("cpu", torch.float32).clone()
        used.add(src)
    unknown = sorted(k for k in sd if k not in used and k not in IGNORED_KEYS
                     and not k.endswith(IGNORED_SUFFIXES))
    if unknown:
        raise KeyError(f"{what}: {family} takes no key '{unknown[0]}'"
                       + (f" (and {len(unknown) - 1} more)" if len(unknown) > 1 else ""))
    return out


def _upstream(entries, port_state_dict: Mapping) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    thirds: Dict[str, list] = {}
    for dst, src, third in entries:
        if third is None:
            out[src] = port_state_dict[dst].detach().clone()
        else:
            thirds.setdefault(src, []).append(port_state_dict[dst].detach())
    for src, parts in thirds.items():
        out[src] = torch.cat(parts, dim=0)
    return out


def load_bevformer_checkpoint(model_or_cfg, state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """An upstream-layout BEVFormer `state_dict` (tensors or numpy arrays;
    a DataParallel `module.` prefix is dropped) -> the port's state_dict for
    `BEVFormer(cfg)`, float32, which `BEVFormerEngine(cfg, state_dict=...)`
    and `load_state_dict(strict=True)` take.  Given a model, its `cfg` is
    used; the model itself is not touched.  Raises `KeyError` naming a
    missing or an unknown key.  Scales of the quantized tiers are not part of
    an upstream checkpoint: calibrate after loading."""
    cfg = _config_of(model_or_cfg, BEVFormerConfig, "load_bevformer_checkpoint")
    return _load(bevformer_key_map(cfg), state_dict, "load_bevformer_checkpoint",
                 f"BEVFormer-{cfg.name}")


def upstream_layout(cfg: BEVFormerConfig, port_state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """The inverse renaming, for tests and smoke runs that need a seeded
    checkpoint in the upstream layout: the floating-point tensors of a
    port-layout state_dict under their upstream keys (q / k / v joined into
    in_proj).  Buffers of the quantized tiers (scales, folds) are left out."""
    return _upstream(bevformer_key_map(cfg), port_state_dict)


def load_bevdet_checkpoint(model_or_cfg, state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """An upstream-layout BEVDet `state_dict` -> the port's state_dict for
    `BEVDet(cfg)`, as `load_bevformer_checkpoint` is for BEVFormer (strict
    both ways, float32, scales calibrated after loading)."""
    cfg = _config_of(model_or_cfg, BEVDetConfig, "load_bevdet_checkpoint")
    return _load(bevdet_key_map(cfg), state_dict, "load_bevdet_checkpoint", cfg.name)


def bevdet_upstream_layout(cfg: BEVDetConfig, port_state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """`load_bevdet_checkpoint`'s inverse: a port-layout BEVDet state_dict's
    floating-point tensors under their upstream keys."""
    return _upstream(bevdet_key_map(cfg), port_state_dict)


def load_yolox_checkpoint(model_or_cfg, state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """An upstream-layout YOLOX `state_dict` -> the port's state_dict for
    `YOLOX(cfg)`, as `load_bevformer_checkpoint` is for BEVFormer (strict
    both ways, float32, scales calibrated after loading)."""
    cfg = _config_of(model_or_cfg, YOLOXConfig, "load_yolox_checkpoint")
    return _load(yolox_key_map(cfg), state_dict, "load_yolox_checkpoint", cfg.name)


def yolox_upstream_layout(cfg: YOLOXConfig, port_state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """`load_yolox_checkpoint`'s inverse."""
    return _upstream(yolox_key_map(cfg), port_state_dict)


def load_centernet_checkpoint(model_or_cfg, state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """An upstream-layout CenterNet `state_dict` -> the port's state_dict
    for `CenterNet(cfg)` (strict both ways, float32)."""
    cfg = _config_of(model_or_cfg, CenterNetConfig, "load_centernet_checkpoint")
    return _load(centernet_key_map(cfg), state_dict, "load_centernet_checkpoint", cfg.name)


def centernet_upstream_layout(cfg: CenterNetConfig,
                              port_state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """`load_centernet_checkpoint`'s inverse."""
    return _upstream(centernet_key_map(cfg), port_state_dict)


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The flat state_dict of a `.pth` file, on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return dict(ckpt.get("state_dict", ckpt))
