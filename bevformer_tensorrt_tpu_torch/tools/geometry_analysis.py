"""Camera geometry of the spatial cross-attention on a nuScenes-like rig
(port of `tools/geometry_analysis.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.geometry_analysis [--device cpu] [--out FILE]

Answers the JAX tool's two questions at base scale (200x200 grid, 4
z-anchors, 1600x900 images, `runtime/synthetic.py::nuscenes_like_rig`: focal
1266 front and sides, 809 back, cameras 1.5 m up):

1. cam_budget validity: each camera's visible BEV-query count against the
   compaction budget K = cam_budget * nq rounded up to 128.
2. panel span after binning: with the taps split by z-anchor and the queries
   sorted by that anchor's image position (y * W + x), how many 128-key
   panels a row of 128 taps spans at each FPN level, for three query orders
   and three offset jitters.  The panels are the TPU kernel's lane-gather
   unit; the port's MSDA gathers rows where they lie and has none, but the
   numbers are host geometry and the port computes the same ones.

The pillars are projected on the device in float64 (the JAX tool's numpy
arithmetic); the binning that follows is the JAX tool's numpy code, with
its seeded jitter.  Prints the JAX tool's lines, then one JSON line with
every number.  Runs on CUDA unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..configs.bevformer import bevformer_base
from ..models.modules.encoder import get_reference_points_3d
from ..runtime.engine import resolve_device
from ..runtime.synthetic import nuscenes_like_rig

SIGMA_MODES = ("per-z", "shared-zmid", "bev-order")
JITTERS = (0.0, 2.0, 8.0)  # sampling-offset jitter in level-0 pixels


def project(cfg, device):
    """(u, v, vis) [Z, cams, nq] of the pillars' projections: normalized
    image coordinates and visibility, the projection in float64 on `device`."""
    Z = cfg.num_points_in_pillar
    ref = get_reference_points_3d(cfg.bev_h, cfg.bev_w, Z)[0]  # [Z, nq, 3]
    span = np.array([cfg.pc_range[3] - cfg.pc_range[0], cfg.pc_range[4] - cfg.pc_range[1],
                     cfg.pc_range[5] - cfg.pc_range[2]])
    pts = ref * span + np.array(cfg.pc_range[:3])
    pts_h = np.concatenate([pts, np.ones_like(pts[..., :1])], -1)
    l2i = torch.as_tensor(nuscenes_like_rig(cfg.img_w, cfg.img_h), device=device)
    cam = torch.einsum("zqd,ced->zcqe", torch.as_tensor(pts_h, device=device), l2i)
    eps = 1e-5
    z = cam[..., 2]
    xy = cam[..., :2] / torch.clamp(z[..., None], min=eps)
    u, v = xy[..., 0] / cfg.img_w, xy[..., 1] / cfg.img_h
    vis = (z > eps) & (u > 0) & (u < 1) & (v > 0) & (v < 1)
    return u.cpu().numpy(), v.cpu().numpy(), vis.cpu().numpy()


def panel_spans(u, v, vis, K: int, levels, sigma_mode: str, off_px: float):
    """Per level, the panel spans of every live 128-tap row (the JAX tool's
    binning, its jitter seeded 0 per (order, jitter))."""
    Z = u.shape[0]
    spans_by_level = {li: [] for li in range(len(levels))}
    rng = np.random.default_rng(0)
    mask = vis.any(axis=0)
    H0, W0 = levels[0]
    for c in range(vis.shape[1]):
        topi = np.sort(np.argsort(~mask[c], kind="stable")[:K])  # visible first

        def key_of(zi):
            ok = vis[zi, c, topi]
            return (np.where(ok, np.clip(v[zi, c, topi], 0, 1) * H0, 1e9).astype(np.int64) * W0
                    + np.where(ok, np.clip(u[zi, c, topi], 0, 1) * W0, 0).astype(np.int64))

        shared = np.argsort(key_of(Z // 2), kind="stable") if sigma_mode == "shared-zmid" else None
        for zi in range(Z):
            if sigma_mode == "per-z":
                order = np.argsort(key_of(zi), kind="stable")
            elif sigma_mode == "shared-zmid":
                order = shared
            else:
                order = np.arange(K)
            uo, vo, oko = u[zi, c, topi][order], v[zi, c, topi][order], vis[zi, c, topi][order]
            for li, (H, W) in enumerate(levels):
                P2 = 2  # 2 points per (query, anchor): jitter around the reference point
                x = np.repeat(np.clip(uo, 0, 1) * W, P2) + rng.normal(0, off_px * W / W0, K * P2)
                y = np.repeat(np.clip(vo, 0, 1) * H, P2) + rng.normal(0, off_px * H / H0, K * P2)
                keyf = np.clip(y.astype(int), 0, H - 1) * W + np.clip(x.astype(int), 0, W - 1)
                okr = np.repeat(oko, P2)
                keyf = np.where(okr, keyf, 0)
                n = (len(keyf) // 128) * 128
                rows, okrows = keyf[:n].reshape(-1, 128), okr[:n].reshape(-1, 128)
                live = okrows.any(axis=1)
                pmin = np.where(okrows, rows // 128, 10 ** 9).min(axis=1)
                pmax = np.where(okrows, rows // 128, -1).max(axis=1)
                spans_by_level[li].append((pmax - pmin + 1)[live])
    return [np.concatenate(spans_by_level[li]) for li in range(len(levels))]


def analyse(device=None) -> dict:
    dev = resolve_device(device)
    cfg = bevformer_base()
    nq = cfg.bev_h * cfg.bev_w
    u, v, vis = project(cfg, dev)
    per_cam = vis.any(axis=0).sum(axis=1)
    K = min(nq, -(-int(nq * cfg.cam_budget) // 128) * 128)
    print(f"nq={nq} budget K={K} (cam_budget={cfg.cam_budget})")
    for c, n in enumerate(per_cam):
        flag = "  OVER BUDGET!" if n > K else ""
        print(f"  cam{c}: visible queries {n} ({100 * n / nq:.1f}%){flag}")
    print(f"  max/budget = {per_cam.max()}/{K} = {per_cam.max() / K:.2f}")
    levels = [[int(np.ceil(cfg.img_h / s)), int(np.ceil(cfg.img_w / s))] for s in (8, 16, 32, 64)]
    print(f"levels: {levels}")
    spans = {}
    for mode in SIGMA_MODES:
        for off_px in JITTERS:
            print(f"sigma={mode} offset jitter sigma={off_px}px (level-0 scale):")
            rows = []
            for li, s in enumerate(panel_spans(u, v, vis, K, levels, mode, off_px)):
                st = dict(mean=float(s.mean()), p50=float(np.percentile(s, 50)),
                          p90=float(np.percentile(s, 90)), p99=float(np.percentile(s, 99)),
                          max=int(s.max()))
                rows.append(st)
                print(f"  level{li} {levels[li]}: span mean={st['mean']:.2f} p50={st['p50']:.0f} "
                      f"p90={st['p90']:.0f} p99={st['p99']:.0f} max={st['max']}")
            spans[f"{mode}/{off_px}"] = rows
    return {"nq": nq, "K": K, "cam_budget": cfg.cam_budget,
            "visible": [int(n) for n in per_cam], "max_over_budget": float(per_cam.max() / K),
            "levels": levels, "spans": spans}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: cuda (raises without one)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    rec = analyse(args.device)
    if args.out:
        Path(args.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
