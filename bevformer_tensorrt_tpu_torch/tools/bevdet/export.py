"""Export a deployable BEVDet artifact, the ".trt engine build" step (port
of `tools/bevdet/export.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.bevdet.export --infos <infos.pkl> --out DIR
        [--model r50|micro] [--checkpoint upstream.pth]
        [--quant-scales scales.npz [--quant int8|qdq]] [--dtype float32]
        [--ranks-pad 400000] [--pool-impl interval|scatter] [--aot] [--device cuda]

The first frame of `--infos` gives the camera rig whose pooling ranks
(`runtime/bevdet_engine.py::rig_ranks`, padded to `--ranks-pad` points) are
baked into the program as buffers, as the reference bakes one sample's rank
tensors into its engine (tools/bevdet/pth2onnx.py:60-97): the program's only
input is the image [1, cams, 3, H, W], its output the CenterHead maps.
Writes `model.pt2` and `meta.json` (model, dtype, quant, pool_impl, image,
ranks_pad, rig_infos, device) into `--out`.  The other arguments are those
of `tools/export.py`.  The last line of stdout is one JSON object {out,
artifacts, artifact_mb}.
"""
from __future__ import annotations

import argparse
import json

import torch

from ...runtime.bevdet_engine import POOL_IMPLS, BEVDetEngine, RigModel, rig_ranks
from ...runtime.engine import resolve_device
from ...runtime.export import artifact_summary, export_program
from ..export import attach_scales, build_kernels, quant_args, quant_config
from .evaluate import MODELS, checkpoint_state_dict, frames_of, make_config


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="r50", choices=MODELS)
    ap.add_argument("--infos", required=True,
                    help="nuScenes infos pkl: its first frame's rig gives the baked ranks")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--ranks-pad", type=int, default=400000)
    ap.add_argument("--pool-impl", default="interval", choices=POOL_IMPLS,
                    help="the BEV splat's formulation baked into the program (ops/bev_pool.py)")
    quant_args(ap, "float32")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    build_kernels(args, device)
    quant, exclude = quant_config(args)
    cfg = make_config(args.model, dtype=args.dtype, quant=quant, quant_exclude=exclude)
    frames = frames_of(cfg, args.infos, args.data_root)
    ranks = rig_ranks(cfg, frames.infos[0], args.ranks_pad,
                      intervals=args.pool_impl == "interval")
    state_dict = checkpoint_state_dict(cfg, args.checkpoint) if args.checkpoint else None
    engine = BEVDetEngine(cfg, ranks, state_dict=state_dict, device=device,
                          pool_impl=args.pool_impl)
    attach_scales(engine.model, args)
    image = torch.zeros((1, cfg.num_cams, 3, cfg.input_h, cfg.input_w), device=device)
    export_program(RigModel(engine.model, engine.rank_args), (image,), args.out, {
        "model": f"bevdet_{args.model}", "dtype": args.dtype,
        "quant": args.quant if args.quant_scales else "none", "pool_impl": args.pool_impl,
        "image": list(image.shape), "ranks_pad": args.ranks_pad, "rig_infos": str(args.infos)})
    line = artifact_summary(args.out)
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
