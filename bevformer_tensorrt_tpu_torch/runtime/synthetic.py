"""Synthetic frames for driving the port without a dataset: a plausible
surround-camera rig and seeded random images with ego motion."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def camera_rig(num_cams: int, img_h: int, img_w: int, rng) -> np.ndarray:
    """Cameras at evenly spaced yaws around the ego car, looking outward,
    focal 0.8 * img_w, so every camera sees part of the BEV grid.
    Returns lidar2img [1, cams, 4, 4] float32."""
    l2i = []
    for c in range(num_cams):
        yaw = 2 * np.pi * c / num_cams
        rot = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0],
                        [0, 0, 1]]) @ np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]])
        ext = np.eye(4)
        ext[:3, :3] = rot.T
        ext[:3, 3] = rng.normal(0, 0.2, 3)
        K = np.eye(4)
        K[0, 0] = K[1, 1] = img_w * 0.8
        K[0, 2], K[1, 2] = img_w / 2, img_h / 2
        l2i.append(K @ ext)
    return np.stack(l2i).astype(np.float32).reshape(1, num_cams, 4, 4)


def synthetic_frames(cfg, rng, scene_tokens: Sequence[str]) -> List[dict]:
    """One `infer_frame` keyword set per scene token: standard-normal images,
    one fixed rig, and a can_bus whose position and yaw drift each frame."""
    l2i = camera_rig(cfg.num_cams, cfg.img_h, cfg.img_w, rng)
    can_bus = np.zeros(cfg.can_bus_dims, np.float32)
    frames = []
    for token in scene_tokens:
        can_bus = can_bus.copy()
        can_bus[:3] += rng.normal(0, 1.5, 3).astype(np.float32)
        can_bus[-2:] += np.float32(rng.normal(0, 0.05))
        image = rng.standard_normal((1, cfg.num_cams, 3, cfg.img_h, cfg.img_w)).astype(np.float32)
        frames.append(dict(image=image, can_bus=can_bus, lidar2img=l2i, scene_token=token))
    return frames


def bevdet_rig(num_cams: int, img_h: int, img_w: int, rng, focal: float = 0.5):
    """A BEVDet rig of the same kind: cameras at evenly spaced yaws around
    the ego car, looking outward, focal `focal` * img_w, as the loader's
    infos give it.  Returns (sensor2ego [cams, 4, 4], intrinsics
    [cams, 3, 3]), float32."""
    s2e, intr = [], []
    for c in range(num_cams):
        yaw = 2 * np.pi * c / num_cams
        rot = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0],
                        [0, 0, 1]]) @ np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]])
        ext = np.eye(4)
        ext[:3, :3] = rot
        ext[:3, 3] = rng.normal(0, 0.2, 3)
        s2e.append(ext)
        intr.append(np.array([[img_w * focal, 0, img_w / 2], [0, img_w * focal, img_h / 2],
                              [0, 0, 1]]))
    return np.stack(s2e).astype(np.float32), np.stack(intr).astype(np.float32)
