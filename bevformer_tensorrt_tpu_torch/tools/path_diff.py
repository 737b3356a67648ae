"""Which kernel moves a BEVFormer frame away from the plain path, and by how much.

    python -m bevformer_tensorrt_tpu_torch.tools.path_diff [--model base]
        [--dtype float32] [--frames 2] [--quant none] [--exclude PATTERN ...]
        [--infos <infos.pkl> [--data-root DIR]] [--offset-scale 1.0] [--out FILE]

Runs the same synthetic frames (one scene, so the later frames are temporal)
through `BEVFormerEngine` on the card several times: with every kernel
wrapper swapped for its plain PyTorch version (the reference), the same
again (what the atomic adds of the camera scatter change from run to run),
the same with every pixel scaled by (1 + 1e-7 * a standard normal) (how
far the frames' own conditioning lets the outputs move), with exactly one
op on its CUDA kernel, and with all on their kernels.  With `--infos` the
frames are the first of a nuScenes-layout set, read by the loader with the
model's image norm, at `--cam-budget 1.0` as `tools/evaluate.py` runs them;
`--offset-scale` multiplies the seeded DCN offset convs' weights (the
random R101-DCN is chaotic on caffe-style images with the offset convs as
drawn).
With `--quant int8` the model is calibrated first (`max`, over the same
frames) and the int8 kernels are on the path: the product, the MSDA value
tables, flash attention and, on a DCN backbone, the DCN op's int8 table
(unless `--exclude` names `dcn_tables`).
Prints, for each run, the worst relative error against the reference over
the frames: "max" = max |a - b| / max |b| and "rms" = ||a - b|| / ||b||, for
the BEV embedding and for the class scores and box coordinates of each
decoder layer.  TF32 is off, as in chip_smoke.py.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess

import numpy as np
import torch

from ..configs import bevformer as configs
from ..data.nuscenes import NuScenesFrames
from ..models.backbones.resnet import DeformConv2d
from ..ops import attention as attn_ops
from ..ops import dcn as dcn_ops
from ..ops import int8_matmul as int8_ops
from ..ops import msda as msda_ops
from ..runtime.engine import BEVFormerEngine
from ..runtime.synthetic import synthetic_frames
from .evaluate import image_norm

IMAGE_NOISE = 1e-7  # relative, per pixel


def dcn_float_plain(x, offset, mask, weight, bias=None, stride=1, padding=1, dilation=1,
                    groups=1, deform_groups=1, layout="NCHW", quant=False, wmat=None):
    """What stands in for `modulated_deform_conv2d` when "dcn" runs plain:
    the plain op on the floating-point map, while an eligible int8 table
    still goes through `modulated_deform_conv2d_int8`, on its kernel or
    plain as "dcn_int8" is swapped."""
    Cin = x.shape[3 if layout == "NHWC" else 1]
    if quant == "int8" and dcn_ops.int8_table_eligible(Cin, groups, deform_groups):
        return dcn_ops.modulated_deform_conv2d_int8(x, offset, mask, weight, bias, stride,
                                                    padding, dilation, groups, deform_groups,
                                                    layout)
    return dcn_ops.modulated_deform_conv2d_plain(x, offset, mask, weight, bias, stride, padding,
                                                 dilation, groups, deform_groups, layout)


# op: (module, the function that launches its kernel, its plain version)
WRAPPERS = {
    "msda": (msda_ops, "multi_scale_deformable_attn", msda_ops.multi_scale_deformable_attn_plain),
    "flash": (attn_ops, "flash_attention", attn_ops.qkv_plain),
    "dcn": (dcn_ops, "modulated_deform_conv2d", dcn_float_plain),
    "int8_gemm": (int8_ops, "int8_matmul", int8_ops.int8_matmul_plain),
    "msda_int8": (msda_ops, "multi_scale_deformable_attn_int8",
                  msda_ops.multi_scale_deformable_attn_int8_plain),
    "flash_int8": (attn_ops, "flash_attention_int8", attn_ops.flash_attention_int8_plain),
    "dcn_int8": (dcn_ops, "modulated_deform_conv2d_int8",
                 dcn_ops.modulated_deform_conv2d_int8_plain),
}
QUANT = {"none": False, "qdq": True, "int8": "int8"}


def quant_overrides(quant: str, exclude) -> dict:
    """Config overrides for a tool's `--quant` / `--exclude` arguments."""
    over = {"quant": QUANT[quant]}
    if exclude is not None:
        over["quant_exclude"] = tuple(exclude)
    return over


@contextlib.contextmanager
def plain_versions(names=tuple(WRAPPERS)):
    """Inside the block the named ops run their plain versions on any device.
    A measuring aid: the port itself never sends a CUDA tensor to them."""
    saved = {n: getattr(WRAPPERS[n][0], WRAPPERS[n][1]) for n in names}
    for n in names:
        mod, wrapper, plain = WRAPPERS[n]
        setattr(mod, wrapper, plain)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(WRAPPERS[n][0], WRAPPERS[n][1], fn)


def run_frames(engine, frames):
    """[(bev_embed, classes, coords)] of the frames, from a fresh state."""
    engine.reset()
    outs = []
    for f in frames:
        classes, coords = engine.infer_frame(**f)
        outs.append((engine.state.prev_bev.clone(), classes, coords))
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return outs


def rel_errors(a, b):
    d, b = (a - b).float(), b.float()
    return {"max": float(d.abs().max() / b.abs().max().clamp_min(1e-12)),
            "rms": float(d.norm() / b.norm().clamp_min(1e-12))}


def compare(got, want):
    """Worst errors over the frames: {"bev_embed": {max, rms}, "classes":
    [per decoder layer], "coords": [per decoder layer]}."""
    def worst(pairs):
        errs = [rel_errors(a, b) for a, b in pairs]
        return {k: max(e[k] for e in errs) for k in ("max", "rms")}

    layers = got[0][1].shape[0]
    return {
        "bev_embed": worst([(g[0], w[0]) for g, w in zip(got, want)]),
        "classes": [worst([(g[1][i], w[1][i]) for g, w in zip(got, want)]) for i in range(layers)],
        "coords": [worst([(g[2][i], w[2][i]) for g, w in zip(got, want)]) for i in range(layers)],
    }


def loader_frames(cfg, model, infos, data_root, n):
    frames = NuScenesFrames(infos, data_root, img_norm=image_norm(model),
                            target_hw=(cfg.img_h, cfg.img_w))
    return [dict(image=f.image, can_bus=f.can_bus, lidar2img=f.lidar2img,
                 scene_token=f.scene_token) for f in map(frames.frame, range(n))]


def nudged(frames, seed=1):
    """The frames with every pixel scaled by (1 + IMAGE_NOISE * a standard normal)."""
    rng = np.random.default_rng(seed)
    return [dict(f, image=(f["image"] * (1 + IMAGE_NOISE * rng.standard_normal(
        f["image"].shape))).astype(np.float32)) for f in frames]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="base", choices=("tiny", "small", "base"))
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--quant", default="none", choices=tuple(QUANT))
    ap.add_argument("--exclude", nargs="*", default=None,
                    help="quant policy patterns; default: the config's")
    ap.add_argument("--infos", default=None, help="loader frames from this set")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--offset-scale", type=float, default=1.0,
                    help="multiplies the DCN offset convs' seeded weights")
    ap.add_argument("--out", help="also write the errors as JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("path_diff: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    over = dict(cam_budget=1.0) if args.infos else {}
    cfg = getattr(configs, f"bevformer_{args.model}")(
        dtype=args.dtype, **quant_overrides(args.quant, args.exclude), **over)
    engine = BEVFormerEngine(cfg, seed=0)
    with torch.no_grad():
        for m in engine.model.modules():
            if isinstance(m, DeformConv2d):
                m.conv_offset.weight.mul_(args.offset_scale)
    frames = (loader_frames(cfg, args.model, args.infos, args.data_root, args.frames)
              if args.infos else
              synthetic_frames(cfg, np.random.default_rng(0), ["scene"] * args.frames))
    if cfg.quant:
        engine.calibrate(frames, method="max")
    with plain_versions():
        reference = run_frames(engine, frames)
    runs = {}
    with plain_versions():
        runs["all plain, again"] = compare(run_frames(engine, frames), reference)
        runs[f"all plain, images x (1 + {IMAGE_NOISE:g} noise)"] = compare(
            run_frames(engine, nudged(frames)), reference)
    # the int8 kernels are on the path only under quant="int8"
    for op in [n for n in WRAPPERS if cfg.quant == "int8" or "int8" not in n]:
        with plain_versions([n for n in WRAPPERS if n != op]):
            runs[f"only {op} on its kernel"] = compare(run_frames(engine, frames), reference)
    runs["all kernels"] = compare(run_frames(engine, frames), reference)

    print(f"{card}: {args.model} {args.dtype} quant={args.quant}, {args.frames} "
          f"{'loader' if args.infos else 'synthetic'} frames, offset convs x "
          f"{args.offset_scale:g}, worst relative error against the all-plain run")
    for what, err in runs.items():
        print(f"{what}:")
        print(f"  bev_embed max {err['bev_embed']['max']:.3e} rms {err['bev_embed']['rms']:.3e}")
        for key in ("classes", "coords"):
            print(f"  {key:9s} max by decoder layer "
                  + " ".join(f"{e['max']:.2e}" for e in err[key])
                  + "  rms " + " ".join(f"{e['rms']:.2e}" for e in err[key]))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(card=card, model=args.model, dtype=args.dtype, quant=args.quant,
                           frames=args.frames, infos=args.infos,
                           offset_scale=args.offset_scale, runs=runs), fh, indent=1)


if __name__ == "__main__":
    main()
