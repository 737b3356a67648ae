"""Per-component latency of a BEVFormer frame (port of `tools/component_bench.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.component_bench [base|small|tiny|micro]
        [--dtype bfloat16] [--iters 10] [--device cpu]

Runs one frame of the seeded model on the nuScenes-like rig
(`runtime/synthetic.py::nuscenes_like_rig`, so the encoder's camera
compaction behaves as deployed), records each stage's inputs with forward
pre-hooks, then times each stage alone on them: the backbone with its DCN
stages and, for the DCN tiers, the same ResNet without DCN; the FPN; the
encoder; one temporal self-attention layer; one spatial cross-attention
layer; the decoder.  Prints one line a stage and a final JSON with the JAX
tool's keys (`backbone_ms`, `fpn_ms`, `encoder_ms`, `encoder_self_1l_ms`,
`encoder_cross_1l_ms`, `decoder_ms`, the gather rates in M taps/s) plus
`backbone_no_dcn_ms` and `device` (the card's name and power limit).

Timing: CUDA events around back-to-back calls queued behind a device sleep,
the median over repeats (`kernel_cases.device_ms`); the JAX tool took the
minimum host-clock time with a readback.  On the CPU the times are the host
clock (a rehearsal).  Runs on CUDA unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models.backbones.resnet import ResNet
from ..models.modules.attention import compaction_size
from ..registry import build_model
from ..runtime.engine import resolve_device
from ..runtime.synthetic import camera_rig, nuscenes_like_rig
from ..weights import init_weights
from .accuracy_cycle import device_name
from .kernel_cases import call_ms


def frame_inputs(cfg, device):
    """A seeded frame: image [1, cams, 3, H, W], zero prev_bev, use_prev 1,
    a zero can_bus and the nuScenes-like rig (evenly spaced cameras where
    the tier has other than six)."""
    rng = np.random.default_rng(0)
    image = rng.standard_normal((1, cfg.num_cams, 3, cfg.img_h, cfg.img_w)).astype(np.float32)
    l2i = (nuscenes_like_rig(cfg.img_w, cfg.img_h).reshape(1, 6, 4, 4) if cfg.num_cams == 6
           else camera_rig(cfg.num_cams, cfg.img_h, cfg.img_w, rng))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    nq = cfg.bev_h * cfg.bev_w
    return (t(image), torch.zeros((nq, 1, cfg.embed_dims), device=device), t(1.0),
            t(np.zeros(cfg.can_bus_dims)), t(l2i))


def recorded_calls(model, inputs, modules: dict) -> dict:
    """Run one frame and return each named module's (args, kwargs) of its
    first call."""
    calls, hooks = {}, []
    for name, mod in modules.items():
        def pre(m, args, kwargs, name=name):
            calls.setdefault(name, (args, kwargs))
        hooks.append(mod.register_forward_pre_hook(pre, with_kwargs=True))
    try:
        model(*inputs)
    finally:
        for h in hooks:
            h.remove()
    return calls


def bench(name: str, dtype: str, device, iters: int) -> dict:
    model, cfg = build_model(f"bevformer_{name}", device=device, dtype=dtype)
    transformer = model.pts_bbox_head.transformer
    layer = transformer.encoder.layer0
    stages = {"backbone": model.img_backbone, "fpn": model.img_neck,
              "encoder": transformer.encoder, "encoder_self_1l": layer.self_attn,
              "encoder_cross_1l": layer.cross_attn, "decoder": transformer.decoder}
    with torch.inference_mode():
        calls = recorded_calls(model, frame_inputs(cfg, device), stages)
        rec = {"model": name, "dtype": dtype, "msda_impl": "cuda" if device.type == "cuda"
               else "plain"}
        for stage, mod in stages.items():
            args, kwargs = calls[stage]
            rec[f"{stage}_ms"] = call_ms(lambda: mod(*args, **kwargs), device, n=iters)
            print(f"{stage}: {rec[f'{stage}_ms']:.3f} ms", flush=True)
        if any(cfg.dcn_stages):
            style = "caffe" if cfg.backbone_depth == 101 else "pytorch"
            plain = ResNet(cfg.backbone_depth, cfg.backbone_out_indices, (False,) * 4, style)
            init_weights(plain, torch.Generator().manual_seed(0))
            plain = plain.to(device).eval()
            args, kwargs = calls["backbone"]
            rec["backbone_no_dcn_ms"] = call_ms(lambda: plain(*args, **kwargs), device, n=iters)
        else:
            rec["backbone_no_dcn_ms"] = rec["backbone_ms"]
        print(f"backbone (no DCN): {rec['backbone_no_dcn_ms']:.3f} ms", flush=True)
    nq = cfg.bev_h * cfg.bev_w
    K = compaction_size(nq, cfg.cam_budget)
    taps_cross = cfg.num_cams * K * cfg.num_heads * cfg.num_levels * cfg.num_points_cross
    taps_self = 2 * nq * cfg.num_heads * cfg.num_points_self
    rec["cross_gather_mtaps_per_s"] = taps_cross / (rec["encoder_cross_1l_ms"] / 1e3) / 1e6
    rec["self_gather_mtaps_per_s"] = taps_self / (rec["encoder_self_1l_ms"] / 1e3) / 1e6
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", nargs="?", default="base", choices=("base", "small", "tiny", "micro"))
    ap.add_argument("--dtype", default="bfloat16", choices=("float32", "bfloat16"))
    ap.add_argument("--iters", type=int, default=10, help="calls a timed batch")
    ap.add_argument("--device", default=None, help="default: cuda (raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rec = bench(args.model, args.dtype, dev, args.iters)
    rec["device"] = device_name(dev)
    print(rec["device"])
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
