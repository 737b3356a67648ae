"""Export a deployable YOLOX or CenterNet artifact, the ".trt engine build"
step (port of `tools/2d/export.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.det2d.export yolox_x --out DIR
        [--batch 32] [--checkpoint upstream.pth]
        [--quant-scales scales.npz [--quant int8|qdq]] [--dtype float32] [--aot]
        [--device cuda]

Exports the detector's forward at a fixed batch (the reference builds
batch-32 engines, configs/yolox/yolox_x_8x8_300e_coco_trt.py:32-44): the
images [batch, 3, S, S] in, the head maps out (YOLOX: per level {cls, reg,
obj}; CenterNet: its heatmap, wh and offset maps); the decode and the NMS
stay with the caller (`runtime/det2d_engine.py`).  CenterNet's transposed
convolutions ask cuDNN for deterministic algorithms, which `meta.json`
records for `load_program` to set.  Writes `model.pt2` and `meta.json`
(model, dtype, quant, image, device) into `--out`.  The other arguments are
those of `tools/export.py`.  The last line of stdout is one JSON object
{out, artifacts, artifact_mb}.
"""
from __future__ import annotations

import argparse
import json

import torch

from ...runtime.det2d_engine import MODELS, Det2DEngine, load_checkpoint_state_dict, make_config
from ...runtime.engine import resolve_device
from ...runtime.export import artifact_summary, export_program
from ...runtime.torch_import import load_torch_checkpoint
from ..export import attach_scales, build_kernels, quant_args, quant_config


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", choices=MODELS)
    ap.add_argument("--batch", type=int, default=32, help="the program's fixed batch")
    quant_args(ap, "float32")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    build_kernels(args, device)
    quant, exclude = quant_config(args)
    cfg = make_config(args.model, dtype=args.dtype, quant=quant, quant_exclude=exclude)
    state_dict = (load_checkpoint_state_dict(cfg, load_torch_checkpoint(args.checkpoint))
                  if args.checkpoint else None)
    engine = Det2DEngine(cfg, state_dict=state_dict, device=device)
    attach_scales(engine.model, args)
    images = torch.zeros((args.batch, 3, cfg.img_size, cfg.img_size), device=device)
    export_program(engine.model, (images,), args.out, {
        "model": args.model, "dtype": args.dtype,
        "quant": args.quant if args.quant_scales else "none", "image": list(images.shape)})
    line = artifact_summary(args.out)
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
