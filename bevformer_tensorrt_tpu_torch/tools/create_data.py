"""nuScenes infos from the raw tables, without the devkit (port of
`tools/create_data.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.create_data --root data/nuscenes \
        [--version v1.0-trainval] [--out data/nuscenes]

Parses the raw JSON tables of a nuScenes release (`<version>/{scene,
sample, sample_data, calibrated_sensor, sensor, ego_pose, sample_annotation,
instance, category}.json`) and writes the mmdet3d
`nuscenes_infos_temporal_{val,mini}.pkl` layout that
`data/nuscenes.py::NuScenesDataset` reads: per keyframe, per camera its
`data_path`, sensor2lidar rotation and translation and intrinsics, the
lidar and ego poses, and the GT boxes in the lidar frame with velocities.
Numpy only, so it has no device: the JAX tool's code (`quat_to_rot`,
`quat_yaw`, `load_tables`, `sensor2top`, `build_infos`), copied.
"""
from __future__ import annotations

import argparse
import json
import pickle
from pathlib import Path

import numpy as np

CAMERAS = (
    "CAM_FRONT",
    "CAM_FRONT_RIGHT",
    "CAM_FRONT_LEFT",
    "CAM_BACK",
    "CAM_BACK_LEFT",
    "CAM_BACK_RIGHT",
)

# nuScenes category -> detection class (devkit category_to_detection_name)
CATEGORY_MAP = {
    "vehicle.car": "car",
    "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.trailer": "trailer",
    "movable_object.barrier": "barrier",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
}


def quat_to_rot(q) -> np.ndarray:
    """(w, x, y, z) -> 3x3 rotation matrix."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def quat_yaw(q) -> float:
    r = quat_to_rot(q)
    return float(np.arctan2(r[1, 0], r[0, 0]))


def load_tables(root: Path, version: str):
    names = [
        "scene", "sample", "sample_data", "calibrated_sensor",
        "sensor", "ego_pose", "sample_annotation", "instance", "category",
    ]
    t = {}
    for n in names:
        with open(root / version / f"{n}.json") as f:
            rows = json.load(f)
        t[n] = {r["token"]: r for r in rows}
    return t


def sensor2top(cs_rec, pose_rec, l2e_r, l2e_t, e2g_r, e2g_t):
    """Sensor->lidar-top transform across timestamps (mmdet3d
    obtain_sensor2top formula)."""
    s2e_r = quat_to_rot(cs_rec["rotation"])
    s2e_t = np.asarray(cs_rec["translation"])
    seg_r = quat_to_rot(pose_rec["rotation"])
    seg_t = np.asarray(pose_rec["translation"])
    # R = (s2e @ e2g_s) @ (inv(e2g_l) @ inv(l2e))
    R = (s2e_r.T @ seg_r.T) @ np.linalg.inv(e2g_r).T @ np.linalg.inv(l2e_r).T
    T = (s2e_t @ seg_r.T + seg_t) @ np.linalg.inv(e2g_r).T @ np.linalg.inv(l2e_r).T
    T -= (
        e2g_t @ np.linalg.inv(e2g_r).T @ np.linalg.inv(l2e_r).T
        + l2e_t @ np.linalg.inv(l2e_r).T
    )
    return R.T, T  # sensor2lidar rotation (matrix), translation


def build_infos(root: Path, version: str, scene_filter=None):
    t = load_tables(root, version)
    # index: keyframe sample_data by (sample_token, channel)
    by_sample_channel = {}
    for sd in t["sample_data"].values():
        if not sd["is_key_frame"]:
            continue
        cs = t["calibrated_sensor"][sd["calibrated_sensor_token"]]
        channel = t["sensor"][cs["sensor_token"]]["channel"]
        by_sample_channel[(sd["sample_token"], channel)] = sd
    anns_by_sample = {}
    for a in t["sample_annotation"].values():
        anns_by_sample.setdefault(a["sample_token"], []).append(a)

    infos = []
    for sample in t["sample"].values():
        scene = t["scene"][sample["scene_token"]]
        if scene_filter and scene["name"] not in scene_filter:
            continue
        lidar_sd = by_sample_channel.get((sample["token"], "LIDAR_TOP"))
        if lidar_sd is None:
            continue
        lidar_cs = t["calibrated_sensor"][lidar_sd["calibrated_sensor_token"]]
        lidar_pose = t["ego_pose"][lidar_sd["ego_pose_token"]]
        l2e_r = quat_to_rot(lidar_cs["rotation"])
        l2e_t = np.asarray(lidar_cs["translation"])
        e2g_r = quat_to_rot(lidar_pose["rotation"])
        e2g_t = np.asarray(lidar_pose["translation"])

        cams = {}
        for ch in CAMERAS:
            sd = by_sample_channel.get((sample["token"], ch))
            if sd is None:
                continue
            cs = t["calibrated_sensor"][sd["calibrated_sensor_token"]]
            pose = t["ego_pose"][sd["ego_pose_token"]]
            R, T = sensor2top(cs, pose, l2e_r, l2e_t, e2g_r, e2g_t)
            cams[ch] = dict(
                data_path=sd["filename"],
                type=ch,
                sample_data_token=sd["token"],
                sensor2lidar_rotation=R,
                sensor2lidar_translation=T,
                cam_intrinsic=np.asarray(cs["camera_intrinsic"]),
                timestamp=sd["timestamp"],
            )

        gt_boxes, names, velocities, valid = [], [], [], []
        for a in anns_by_sample.get(sample["token"], []):
            cat = t["category"][t["instance"][a["instance_token"]]["category_token"]]["name"]
            det = CATEGORY_MAP.get(cat)
            if det is None:
                continue
            # global -> lidar frame
            c = np.asarray(a["translation"])
            c = (c - e2g_t) @ e2g_r  # into ego
            c = (c - l2e_t) @ l2e_r  # into lidar
            yaw = quat_yaw(a["rotation"]) - quat_yaw(lidar_pose["rotation"]) - quat_yaw(
                lidar_cs["rotation"]
            )
            w, l, h = a["size"]
            gt_boxes.append([c[0], c[1], c[2], w, l, h, yaw])
            names.append(det)
            # velocity from prev/next annotation positions (global frame)
            vel = np.zeros(2)
            prev, nxt = a.get("prev", ""), a.get("next", "")
            pa = t["sample_annotation"].get(prev)
            na = t["sample_annotation"].get(nxt)
            if pa or na:
                a0 = pa or a
                a1 = na or a
                t0 = t["sample"][a0["sample_token"]]["timestamp"]
                t1 = t["sample"][a1["sample_token"]]["timestamp"]
                if t1 > t0:
                    v3 = (np.asarray(a1["translation"]) - np.asarray(a0["translation"])) / (
                        (t1 - t0) / 1e6
                    )
                    v3 = v3 @ e2g_r @ l2e_r  # rotate into lidar frame
                    vel = v3[:2]
            velocities.append(vel)
            valid.append(a.get("num_lidar_pts", 1) + a.get("num_radar_pts", 0) > 0)

        infos.append(
            dict(
                token=sample["token"],
                scene_token=sample["scene_token"],
                timestamp=sample["timestamp"],
                lidar_path=lidar_sd["filename"],
                cams=cams,
                lidar2ego_translation=lidar_cs["translation"],
                lidar2ego_rotation=lidar_cs["rotation"],
                ego2global_translation=lidar_pose["translation"],
                ego2global_rotation=lidar_pose["rotation"],
                can_bus=np.zeros(18),
                gt_boxes=np.asarray(gt_boxes, np.float32).reshape(-1, 7),
                gt_names=names,
                gt_velocity=np.asarray(velocities, np.float32).reshape(-1, 2),
                valid_flag=np.asarray(valid, bool),
            )
        )
    infos.sort(key=lambda e: e["timestamp"])
    return infos


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root)
    out = Path(args.out or args.root)
    infos = build_infos(root, args.version)
    suffix = "val" if "mini" not in args.version else "mini"
    path = out / f"nuscenes_infos_temporal_{suffix}.pkl"
    with open(path, "wb") as f:
        pickle.dump({"infos": infos, "metadata": {"version": args.version}}, f)
    print(f"wrote {len(infos)} samples -> {path}")
    return path


if __name__ == "__main__":
    main()
