"""Parameters and FLOPs of a model a frame (port of `tools/flops_params.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.flops_params [tiny|small|base|micro|bevdet|
        yolox|centernet|<registered name> ...] [--device cpu] [--out FILE]

Parameters: every trainable parameter of the port's module, built through
`registry.build_model` on the meta device, which equals the JAX tool's count
of the flax `params` collection (BatchNorm statistics and the quantization
buffers are buffers, not parameters).

FLOPs: the JAX tool reads XLA's cost analysis of the compiled forward, which
the port does not have.  The port runs one forward of the seeded model on
the device (a frame: one image set; YOLOX and CenterNet one image) and
counts 2 x multiply-adds of every convolution (`nn.Conv2d`,
`nn.ConvTranspose2d`, whatever route an int8 layer takes) and dense layer
(`nn.Linear`) by forward hooks, and the kernels' work by the formulas that
PERF.md section 6 bounds them with: the DCN 2·N·Cout·9·Cin/groups·Ho·Wo; MSDA
8·ch a (query, head, tap) (four corners, a multiply and an add each); flash
4·B·Lq·Lk·d (QKᵀ and P·V).  Elementwise work, norms and softmaxes outside the
kernels are not counted.  (`torch.utils.flop_counter` is not used: it cannot
see the `bevformer_port` operators, and its dispatch mode imports
`torch._dynamo`.)  Runs on CUDA unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import contextlib
import json
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn

from ..models.backbones.resnet import DeformConv2d
from ..models.modules.attention import _DeformableAttention
from ..ops import attention as attn_ops
from ..registry import MODELS, build_model, count_params
from ..runtime.engine import resolve_device

ALIASES = {"tiny": "bevformer_tiny", "small": "bevformer_small", "base": "bevformer_base",
           "micro": "bevformer_micro", "bevdet": "bevdet_r50", "yolox": "yolox_x",
           "centernet": "centernet_r18"}


def model_inputs(name: str, cfg, device) -> tuple:
    """One frame's positional inputs of a registered model: a seeded image
    set on a synthetic rig (BEVDet's ranks from its rig, padded to the
    frustum's points rounded up to 8192, with their intervals)."""
    from ..models.necks.view_transformer import get_lidar_coor, voxel_pooling_prepare
    from ..runtime.synthetic import bevdet_rig, synthetic_frames

    rng = np.random.default_rng(0)
    t = lambda x, dtype=torch.float32: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
    if name.startswith("bevformer"):
        f = synthetic_frames(cfg, rng, ("scene",))[0]
        nq = cfg.bev_h * cfg.bev_w
        return (t(f["image"]), torch.zeros((nq, 1, cfg.embed_dims), device=device),
                t(1.0), t(f["can_bus"]), t(f["lidar2img"]))
    if name.startswith("bevdet"):
        s2e, intr = bevdet_rig(cfg.num_cams, cfg.input_h, cfg.input_w, rng)
        coor = get_lidar_coor(cfg, s2e, intr)
        gz = int(round((cfg.grid_zbound[1] - cfg.grid_zbound[0]) / cfg.grid_zbound[2]))
        tight = -(-int(np.prod(coor.shape[:-1])) // 8192) * 8192
        r = voxel_pooling_prepare(cfg, coor, pad_to=tight,
                                  pad_intervals_to=cfg.bev_h * cfg.bev_w * gz)
        image = rng.standard_normal((1, cfg.num_cams, 3, cfg.input_h, cfg.input_w))
        return (t(image), *(t(a, torch.int64) for a in (
            r.ranks_depth, r.ranks_feat, r.ranks_bev, r.interval_starts, r.interval_lengths)))
    return (t(rng.standard_normal((1, 3, cfg.img_size, cfg.img_size))),)


@contextlib.contextmanager
def counting(model: nn.Module):
    """Yield a dict of FLOPs by kind, filled by the forwards run inside."""
    flops = {"conv": 0, "dense": 0, "dcn": 0, "msda": 0, "flash": 0}

    def conv_hook(mod, inputs, out):
        k = mod.weight.shape[1] * mod.weight.shape[2] * mod.weight.shape[3]
        if isinstance(mod, nn.ConvTranspose2d):  # every input pixel meets every tap
            flops["conv"] += 2 * inputs[0].numel() * mod.weight.shape[1] * k // inputs[0].shape[1]
        else:
            flops["conv"] += 2 * out.numel() * k

    def dense_hook(mod, inputs, out):
        flops["dense"] += 2 * out.numel() * mod.in_features

    def dcn_hook(mod, inputs, out):
        flops["dcn"] += 2 * out.numel() * mod.weight[0].numel()

    hooks = []
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            hooks.append(m.register_forward_hook(conv_hook))
        elif isinstance(m, nn.Linear):
            hooks.append(m.register_forward_hook(dense_hook))
        elif isinstance(m, DeformConv2d):
            hooks.append(m.register_forward_hook(dcn_hook))

    # the attention modules' calls are wrapped where the modules make them
    # (the kernels' wrappers keep their launch counters)
    msda_method, flash_fn = _DeformableAttention.msda, attn_ops.multi_head_attention

    def msda_counted(self, value, ref, off, attn, shapes):
        bs, _, heads, ch = value.shape
        flops["msda"] += 8 * ch * bs * ref.shape[1] * heads * attn.shape[-1]
        return msda_method(self, value, ref, off, attn, shapes)

    def flash_counted(q, k, v, num_heads, int8=False):
        flops["flash"] += 4 * q.shape[0] * q.shape[1] * k.shape[1] * q.shape[2]
        return flash_fn(q, k, v, num_heads, int8)

    _DeformableAttention.msda = msda_counted
    attn_ops.multi_head_attention = flash_counted
    try:
        yield flops
    finally:
        _DeformableAttention.msda = msda_method
        attn_ops.multi_head_attention = flash_fn
        for h in hooks:
            h.remove()


def measure(name: str, device=None) -> dict:
    name = ALIASES.get(name, name)
    meta, _ = build_model(name, device="meta")
    n_params = count_params(meta)
    dev = resolve_device(device)
    model, cfg = build_model(name, device=dev)
    with torch.inference_mode(), counting(model) as flops:
        model(*model_inputs(name, cfg, dev))
    total = sum(flops.values())
    rec = {"model": name, "params": n_params, "flops": total,
           "flops_by_kind": dict(flops)}
    print(f"model: {name}")
    print(f"params: {n_params / 1e6:.2f} M")
    print(f"flops:  {total / 1e9:.2f} GFLOPs/frame")
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("models", nargs="*", default=["tiny"],
                    help=f"{', '.join(ALIASES)} or a registered name: {', '.join(MODELS)}")
    ap.add_argument("--device", default=None, help="default: cuda (raises without one)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for m in args.models:
        if ALIASES.get(m, m) not in MODELS:
            ap.error(f"unknown model {m}")
    rec = {"models": [measure(m, args.device) for m in args.models]}
    if args.out:
        Path(args.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
