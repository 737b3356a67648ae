"""The cameras of the benchmark's traffic: six lidar2img matrices in the
nuScenes layout (front, front-left, front-right with focal 1266, back with
the wider 809, back-left, back-right), each 1.5 m above the lidar origin."""
from __future__ import annotations

import numpy as np

CAMERAS = ((0.0, 1266.0), (55.0, 1266.0), (-55.0, 1266.0), (180.0, 809.0), (110.0, 1266.0),
           (-110.0, 1266.0))  # (yaw in degrees, focal in pixels)


def nuscenes_like_rig(img_w: int, img_h: int) -> np.ndarray:
    """[6, 4, 4] float32 lidar2img for images of img_h x img_w."""
    rigs = []
    for yaw_deg, f in CAMERAS:
        yaw = np.deg2rad(yaw_deg)
        # lidar: x forward, y left, z up; camera: z forward, x right, y down
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
        down = np.array([0.0, 0.0, -1.0])
        R = np.stack([right, down, fwd])
        K = np.array([[f, 0, img_w / 2, 0], [0, f, img_h / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
        Rt = np.eye(4)
        Rt[:3, :3] = R
        Rt[:3, 3] = -R @ np.array([0.0, 0.0, 1.5])
        rigs.append(K @ Rt)
    return np.stack(rigs).astype(np.float32)
