"""Which kernel moves a BEVFormer frame away from the plain path, and by how much.

    python -m bevformer_tensorrt_tpu_torch.tools.path_diff [--model base]
        [--dtype float32] [--frames 2] [--quant none] [--exclude PATTERN ...]
        [--out FILE]

Runs the same synthetic frames (one scene, so the later frames are temporal)
through `BEVFormerEngine` on the card several times: with every kernel
wrapper swapped for its plain PyTorch version (the reference), the same
again (what the atomic adds of the camera scatter change from run to run),
with exactly one op on its CUDA kernel, and with all on their kernels.
With `--quant int8` the model is calibrated first (`max`, over the same
frames) and the three int8 kernels are on the path; DCN backbones then need
`--exclude self_attn/msda_tables dcn_tables`.
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
from ..ops import attention as attn_ops
from ..ops import dcn as dcn_ops
from ..ops import int8_matmul as int8_ops
from ..ops import msda as msda_ops
from ..runtime.engine import BEVFormerEngine
from ..runtime.synthetic import synthetic_frames

WRAPPERS = {  # op: (module, wrapper, its plain version)
    "msda": (msda_ops, "multi_scale_deformable_attn", "multi_scale_deformable_attn_plain"),
    "flash": (attn_ops, "flash_attention", "qkv_plain"),
    "dcn": (dcn_ops, "modulated_deform_conv2d", "modulated_deform_conv2d_plain"),
    "int8_gemm": (int8_ops, "int8_matmul", "int8_matmul_plain"),
    "msda_int8": (msda_ops, "multi_scale_deformable_attn_int8",
                  "multi_scale_deformable_attn_int8_plain"),
    "flash_int8": (attn_ops, "flash_attention_int8", "flash_attention_int8_plain"),
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
        setattr(mod, wrapper, getattr(mod, plain))
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="base", choices=("tiny", "small", "base"))
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--quant", default="none", choices=tuple(QUANT))
    ap.add_argument("--exclude", nargs="*", default=None,
                    help="quant policy patterns; default: the config's")
    ap.add_argument("--out", help="also write the errors as JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("path_diff: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    cfg = getattr(configs, f"bevformer_{args.model}")(
        dtype=args.dtype, **quant_overrides(args.quant, args.exclude))
    engine = BEVFormerEngine(cfg, seed=0)
    frames = synthetic_frames(cfg, np.random.default_rng(0), ["scene"] * args.frames)
    if cfg.quant:
        engine.calibrate(frames, method="max")
    with plain_versions():
        reference = run_frames(engine, frames)
    runs = {}
    with plain_versions():
        runs["all plain, again"] = compare(run_frames(engine, frames), reference)
    # the int8 kernels are on the path only under quant="int8"
    for op in [n for n in WRAPPERS if cfg.quant == "int8" or "int8" not in n]:
        with plain_versions([n for n in WRAPPERS if n != op]):
            runs[f"only {op} on its kernel"] = compare(run_frames(engine, frames), reference)
    runs["all kernels"] = compare(run_frames(engine, frames), reference)

    print(f"{card}: {args.model} {args.dtype} quant={args.quant}, {args.frames} frames, "
          f"worst relative error against the all-plain run")
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
                           frames=args.frames, runs=runs), fh, indent=1)


if __name__ == "__main__":
    main()
