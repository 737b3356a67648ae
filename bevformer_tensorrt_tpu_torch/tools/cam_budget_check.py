"""Per-camera visible-query counts on a realistic nuScenes rig (port of
`tools/cam_budget_check.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.cam_budget_check [--model base]
        [--device cpu]

The spatial cross-attention compacts each camera's work to a static top-K of
the bev_mask (K = ceil(cam_budget * nq) rounded up to 128,
`models/modules/attention.py::compaction_size`); the compaction is exact iff
every camera sees at most K queries.  The reference rebatches dynamically to
the measured maximum, so it never drops a visible query.  This tool builds a
6-camera nuScenes rig (published 1600x900 intrinsics, yaws FRONT / ±55 / 180
/ ±110), projects the tier's BEV pillars through the port's
`models/modules/encoder.py::get_reference_points_3d` and `point_sampling`
on the device, and prints each camera's visible count against K.  Exits 1
if a camera is over budget.  Runs on CUDA unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..configs import bevformer as configs
from ..models.modules.attention import compaction_size
from ..models.modules.encoder import get_reference_points_3d, point_sampling
from ..runtime.engine import resolve_device

NAMES = ("FRONT", "FRONT_RIGHT", "FRONT_LEFT", "BACK", "BACK_LEFT", "BACK_RIGHT")


def nuscenes_rig(img_w: int = 1600, img_h: int = 900) -> np.ndarray:
    """Approximate nuScenes v1.0 camera rig as lidar2img [6, 4, 4] float32:
    fx ~ 1266 for the five 70-degree cameras, ~809 for the 120-degree
    CAM_BACK, roof mounts ~1.5 m up, scaled by img_w / 1600 (the JAX tool's
    rig)."""
    sx, sy = img_w / 1600.0, img_h / 900.0
    cams = [  # (yaw degrees, fx, tx, ty)
        (0.0, 1266.4, 1.70, 0.0), (-55.0, 1260.8, 1.56, -0.49), (55.0, 1272.6, 1.58, 0.50),
        (180.0, 809.2, 0.05, 0.0), (110.0, 1256.7, 1.04, 0.48), (-110.0, 1259.5, 1.06, -0.47),
    ]
    out = []
    for yaw_deg, fx, tx, ty in cams:
        th = np.deg2rad(yaw_deg)
        fwd = np.array([np.cos(th), np.sin(th), 0.0])
        right = np.array([np.sin(th), -np.cos(th), 0.0])
        down = np.array([0.0, 0.0, -1.0])
        R = np.stack([right, down, fwd])  # rows: the camera's axes in the lidar frame
        t = np.array([tx, ty, 1.51])
        l2c = np.eye(4)
        l2c[:3, :3] = R
        l2c[:3, 3] = -R @ t
        K = np.eye(4)
        K[0, 0], K[1, 1] = fx * sx, fx * sy
        K[0, 2], K[1, 2] = (img_w - 1) / 2.0, (img_h - 1) / 2.0
        out.append(K @ l2c)
    return np.stack(out).astype(np.float32)


def visible_counts(cfg, device=None) -> np.ndarray:
    """Per-camera count of BEV queries with a nonzero bev_mask for `cfg`."""
    dev = resolve_device(device)
    l2i = torch.as_tensor(nuscenes_rig(cfg.img_w, cfg.img_h), device=dev)
    ref_3d = torch.as_tensor(
        get_reference_points_3d(cfg.bev_h, cfg.bev_w, cfg.num_points_in_pillar), device=dev)
    _, mask = point_sampling(ref_3d, cfg.pc_range, l2i[None], (cfg.img_h, cfg.img_w),
                             cfg.num_cams)
    return (mask[:, :, 0] > 0).sum(dim=1).cpu().numpy()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="base", choices=["tiny", "small", "base"])
    ap.add_argument("--device", default=None, help="default: cuda (raises without one)")
    args = ap.parse_args(argv)
    cfg = getattr(configs, f"bevformer_{args.model}")()
    nq = cfg.bev_h * cfg.bev_w
    K = compaction_size(nq, cfg.cam_budget)
    counts = visible_counts(cfg, args.device)
    for n, c in zip(NAMES, counts):
        flag = "" if c <= K else "  <-- OVER BUDGET (visible queries dropped)"
        print(f"{n:12s} {c:6d} / K={K}{flag}")
    mx = int(counts.max())
    print(f"max {mx} ({mx / nq:.3f} of nq={nq}); cam_budget={cfg.cam_budget} -> K={K}; "
          f"headroom {(K - mx) / nq:+.3f}")
    rec = {"model": args.model, "nq": nq, "K": K, "cam_budget": cfg.cam_budget,
           "visible": dict(zip(NAMES, map(int, counts))), "max": mx, "over_budget": mx > K}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    sys.exit(1 if main()["over_budget"] else 0)
