"""Capture the model's own MSDA operands and replay them into the kernels
(port of `tools/msda_capture_repro.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.msda_capture_repro capture --dir DIR
        [--model base] [--exclude PATTERN ...] [--prev-bev F.npy] [--save-bev0 F.npy] [--run-only]
    python -m bevformer_tensorrt_tpu_torch.tools.msda_capture_repro capture_crash --dir DIR
    python -m bevformer_tensorrt_tpu_torch.tools.msda_capture_repro replay --dir DIR
        [--layer tsa0|sca3|chain] [--packed all|int8|bf16|f32]

Random operands at the deploy shapes (`tools/device_op_check.py`,
`chip_smoke.py`) do not represent the model's: its offsets cluster, its
queries are compacted per camera, its value tables carry its activations.

  capture        BEVFormer-`--model` in bfloat16 under int8 with `--exclude`
                 (default `self_attn/msda_tables`: the operands are the same
                 whatever the tables' policy, which acts after them), scales
                 from one frame (`max`); run 0 from a zero prev_bev, then the
                 capture run with run 0's BEV (or `--prev-bev`) fed back.
                 Each encoder layer's MSDA calls record their operands
                 (value, reference points, offsets, logits, the level shapes,
                 the table kind) and output, saved to `tsa<i>.npz` and
                 `sca<i>.npz` (the JAX tool's flax `sow` has no counterpart:
                 the port wraps each attention module's `msda` call).
                 `--run-only` skips the recording (a plain second run).
  capture_crash  every MSDA call of both runs of the whole int8 model (no
                 exclusion) saved as `r<run>_call<k>.npz` before its kernel
                 launches: after a fault the files name the call.
  replay         one saved set (or `chain`: every set back to back) through
                 the float32, bfloat16 and int8 kernels (`--packed` picks
                 one), each held against its plain version on the same
                 operands (relative to the plain output's largest magnitude:
                 1e-5, 0.02, 0.05, `device_op_check.TOLS`).

Prints one JSON line.  Runs on CUDA unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..models.modules.attention import _DeformableAttention
from ..ops import msda as msda_ops
from ..runtime.engine import resolve_device
from .device_op_check import TOLS, model_inputs

TIERS = {"f32": ("float32", torch.float32, False), "bf16": ("bfloat16", torch.bfloat16, False),
         "int8": ("int8", torch.bfloat16, True)}


def int8_model(model: str, exclude, device, dtype="bfloat16"):
    """(model, cfg, inputs): BEVFormer-`model` under int8 with the policy
    `exclude`, `max` scales from one frame (prev_bev zero), and the frame's
    positional inputs but prev_bev: (image, use_prev 1, can_bus, lidar2img)."""
    from ..quant.calibrate import calibrate
    from ..quant.fold import attach_quant_scales
    from ..registry import build_model

    net, cfg = build_model(f"bevformer_{model}", device=device, dtype=dtype, quant="int8",
                           quant_exclude=tuple(exclude))
    qdq, _ = build_model(f"bevformer_{model}", device=device, dtype=dtype, quant=True,
                         quant_exclude=tuple(exclude))
    image, can_bus, l2i = model_inputs(cfg)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    inputs = (t(image), t(1.0), t(can_bus), t(l2i))
    pb0 = torch.zeros((cfg.bev_h * cfg.bev_w, 1, cfg.embed_dims), device=device)
    with torch.inference_mode():
        scales = calibrate(lambda _: qdq(inputs[0], pb0, *inputs[1:]), qdq, [0],
                           method="max").scales
    del qdq
    attach_quant_scales(net, scales)
    return net, cfg, inputs


def encoder_attention(net):
    """[(name, module)] of the encoder's MSDA modules: tsa<i> (temporal
    self-attention), sca<i> (the cameras' deformable attention)."""
    enc = net.pts_bbox_head.transformer.encoder
    out = []
    for i in range(net.cfg.encoder_layers):
        layer = getattr(enc, f"layer{i}")
        out += [(f"tsa{i}", layer.self_attn), (f"sca{i}", layer.cross_attn.deformable_attention)]
    return out


def save_set(path: Path, value, ref, off, attn, shapes, int8: bool, out=None):
    arrays = dict(v=value.float().cpu().numpy(), ref=ref.float().cpu().numpy(),
                  off=off.float().cpu().numpy(), attn=attn.float().cpu().numpy(),
                  shapes=np.asarray(shapes, np.int64), int8=np.asarray(int8),
                  dtype=np.asarray(str(value.dtype).split(".")[-1]))
    if out is not None:
        arrays["out"] = out.float().cpu().numpy()
    np.savez(path, **arrays)


def capture(out_dir: Path, model: str = "base", exclude=("self_attn/msda_tables",),
            prev_bev_file=None, save_bev0=None, run_only: bool = False, device=None) -> dict:
    dev = resolve_device(device)
    net, cfg, (image, use_prev, can_bus, l2i) = int8_model(model, exclude, dev)
    nq = cfg.bev_h * cfg.bev_w
    out_dir.mkdir(parents=True, exist_ok=True)
    with torch.inference_mode():
        t0 = time.perf_counter()
        bev0 = net(image, torch.zeros((nq, 1, cfg.embed_dims), device=dev), use_prev, can_bus,
                   l2i)[0]
        print(f"run0 OK in {time.perf_counter() - t0:.1f}s", file=sys.stderr, flush=True)
        if save_bev0:
            np.save(save_bev0, bev0.float().cpu().numpy())
        pb1 = (torch.as_tensor(np.load(prev_bev_file), dtype=torch.float32, device=dev)
               if prev_bev_file else bev0)
        saved = []
        if not run_only:
            for name, mod in encoder_attention(net):
                def recording(value, ref, off, attn, shapes, mod=mod, name=name):
                    out = type(mod).msda(mod, value, ref, off, attn, shapes)
                    save_set(out_dir / f"{name}.npz", value, ref, off, attn, shapes,
                             mod.int8_tables, out)
                    saved.append(name)
                    return out
                mod.msda = recording
        t0 = time.perf_counter()
        classes = net(image, pb1, use_prev, can_bus, l2i)[1]
        finite = bool(torch.isfinite(classes).all())
        print(f"run1 OK in {time.perf_counter() - t0:.1f}s", file=sys.stderr, flush=True)
        for _, mod in encoder_attention(net):
            mod.__dict__.pop("msda", None)
    return {"saved": saved, "finite": finite, "exclude": list(exclude), "model": model}


def capture_crash(out_dir: Path, model: str = "base", device=None) -> dict:
    """Both runs of the whole int8 model, every MSDA call's operands saved
    before its launch."""
    dev = resolve_device(device)
    net, cfg, (image, use_prev, can_bus, l2i) = int8_model(model, (), dev)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag, calls = ["r0"], [0]
    method = _DeformableAttention.msda  # every MSDA call of the model goes through it

    def saving(self, value, ref, off, attn, shapes):
        save_set(out_dir / f"{tag[0]}_call{calls[0]:02d}.npz", value, ref, off, attn, shapes,
                 self.int8_tables)
        calls[0] += 1
        return method(self, value, ref, off, attn, shapes)

    _DeformableAttention.msda = saving
    try:
        with torch.inference_mode():
            bev0 = net(image, torch.zeros((cfg.bev_h * cfg.bev_w, 1, cfg.embed_dims), device=dev),
                       use_prev, can_bus, l2i)[0]
            if dev.type == "cuda":  # run 0's files are whole before run 1 starts
                torch.cuda.synchronize(dev)
            tag[0], calls[0] = "r1", 0
            classes = net(image, bev0, use_prev, can_bus, l2i)[1]
            finite = bool(torch.isfinite(classes).all())
    finally:
        _DeformableAttention.msda = method
    return {"calls_per_run": calls[0], "finite": finite, "model": model}


def load_set(path: Path, device):
    d = np.load(path)
    t = lambda k: torch.as_tensor(d[k], device=device)  # noqa: E731
    shapes = tuple(tuple(int(x) for x in hw) for hw in d["shapes"])
    return t("v"), t("ref"), t("off"), t("attn"), shapes, d


def replay_as_captured(path: Path, device=None):
    """The saved call on its own table kind and dtype: the output the module
    computed, where `device` (CUDA unless the caller names another) runs
    what the capture ran."""
    value, ref, off, attn, shapes, d = load_set(path, resolve_device(device))
    dt = getattr(torch, str(d["dtype"]))
    fn = (msda_ops.multi_scale_deformable_attn_int8 if bool(d["int8"])
          else msda_ops.multi_scale_deformable_attn)
    with torch.inference_mode():
        return fn(value.to(dt), ref, off.to(dt), attn.to(dt), shapes)


def replay_tier(value, ref, off, attn, shapes, tier: str) -> dict:
    """One saved set through a tier's kernel and its plain version."""
    label, dt, int8 = TIERS[tier]
    args = (value.to(dt), ref, off.to(dt), attn.to(dt), shapes)
    kernel = msda_ops.multi_scale_deformable_attn_int8 if int8 else \
        msda_ops.multi_scale_deformable_attn
    plain = msda_ops.multi_scale_deformable_attn_int8_plain if int8 else \
        msda_ops.multi_scale_deformable_attn_plain
    with torch.inference_mode():
        got = kernel(*args).float()
        want = plain(*args).float()
    err = float((got - want).abs().max() / max(float(want.abs().max()), 1e-6))
    return {"tier": tier, "rel_err": err, "finite": bool(torch.isfinite(got).all()),
            "ok": err <= TOLS[label] and bool(torch.isfinite(got).all())}


def replay(out_dir: Path, layer: str, packed: str = "all", device=None) -> dict:
    dev = resolve_device(device)
    tiers = list(TIERS) if packed == "all" else [packed]
    names = (sorted(p.stem for p in out_dir.glob("tsa*.npz")) +
             sorted(p.stem for p in out_dir.glob("sca*.npz"))) if layer == "chain" else [layer]
    rows = []
    for name in names:
        value, ref, off, attn, shapes, _ = load_set(out_dir / f"{name}.npz", dev)
        for tier in tiers:
            t0 = time.perf_counter()
            row = {"layer": name, **replay_tier(value, ref, off, attn, shapes, tier)}
            print(f"REPLAY_{'OK' if row['ok'] else 'BAD'} {name} packed={tier} in "
                  f"{time.perf_counter() - t0:.1f}s rel_err={row['rel_err']:.3g} "
                  f"finite={row['finite']}", flush=True)
            rows.append(row)
    return {"rows": rows, "ok": all(r["ok"] for r in rows)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phase", choices=["capture", "capture_crash", "replay"])
    ap.add_argument("--dir", required=True)
    ap.add_argument("--model", default="base", choices=("micro", "tiny", "small", "base"))
    ap.add_argument("--layer", default="tsa0")
    ap.add_argument("--packed", default="all", choices=["all", *TIERS])
    ap.add_argument("--exclude", action="append", default=None,
                    help="capture: quant_exclude patterns (default self_attn/msda_tables)")
    ap.add_argument("--prev-bev", default=None, help="a prev_bev .npy for the second run")
    ap.add_argument("--save-bev0", default=None, help="save run 0's BEV here")
    ap.add_argument("--run-only", action="store_true", help="a plain second run, no capture")
    ap.add_argument("--device", default=None, help="default: cuda (raises without one)")
    args = ap.parse_args(argv)
    out_dir = Path(args.dir)
    if args.phase == "capture":
        exclude = ("self_attn/msda_tables",) if args.exclude is None else tuple(args.exclude)
        rec = capture(out_dir, args.model, exclude, args.prev_bev, args.save_bev0, args.run_only,
                      args.device)
    elif args.phase == "capture_crash":
        rec = capture_crash(out_dir, args.model, args.device)
    else:
        rec = replay(out_dir, args.layer, args.packed, args.device)
    print(json.dumps(rec))
    if args.phase == "replay" and not rec["ok"] and __name__ == "__main__":
        sys.exit(1)
    return rec


if __name__ == "__main__":
    main()
