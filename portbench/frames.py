"""The one traffic generator: camera frames of vehicles driving scenes,
drawn from the seed, for every traffic mix's data file.

A vehicle drives scenes of `frames_per_scene` frames one after another.
Frame f of scene k of vehicle v carries:
- an image set [1, cams, 3, H, W] of standard-normal float32 values, as a
  host numpy array: one of `image_pool` sets made once from the seed, picked
  by the scene's generator (a pool, because a fresh 0.1 GB set a frame would
  cost the host more than the card);
- can_bus [18]: position and yaw of the scene's start, drifting each frame
  (position by N(0, 1.5) m an axis, the two yaw entries by N(0, 0.05));
- the rig's lidar2img [1, cams, 4, 4];
- the scene token "v-k", which changes at every scene boundary.
The frame's numbers depend only on (seed, v, k, f), never on timing, so the
reference can make any frame again.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .reference.rig import nuscenes_like_rig


def rig(m: dict) -> np.ndarray:
    """The configuration's cameras of the nuScenes layout, [cams, 4, 4]."""
    return nuscenes_like_rig(m["img_w"], m["img_h"])[:m["num_cams"]]


class Traffic:
    def __init__(self, m: dict, params: dict, seed: int, device):
        self.m, self.seed = m, seed
        self.frames_per_scene = int(params["frames_per_scene"])
        cams, h, w = m["num_cams"], m["img_h"], m["img_w"]
        gen = torch.Generator(device=device).manual_seed(seed)
        pool = torch.randn((int(params["image_pool"]), 1, cams, 3, h, w), generator=gen,
                           device=device)
        self.images = list(pool.cpu().numpy())
        del pool
        self.lidar2img = rig(m).reshape(1, cams, 4, 4)
        self._scenes: Dict[tuple, List[dict]] = {}

    def scene(self, vehicle: int, k: int) -> List[dict]:
        """The frames of scene k of `vehicle`: dicts of image, can_bus,
        lidar2img, scene_token and image_index."""
        key = (vehicle, k)
        if key not in self._scenes:
            rng = np.random.default_rng([self.seed, vehicle, k])
            picks = rng.integers(0, len(self.images), self.frames_per_scene)
            can_bus = np.zeros(self.m["can_bus_dims"], np.float32)
            can_bus[:3] = rng.uniform(-500.0, 500.0, 3)
            can_bus[-2] = rng.uniform(-np.pi, np.pi)
            can_bus[-1] = can_bus[-2] / np.pi * 180.0
            frames = []
            for f in range(self.frames_per_scene):
                can_bus = can_bus.copy()
                can_bus[:3] += rng.normal(0, 1.5, 3).astype(np.float32)
                can_bus[-2:] += np.float32(rng.normal(0, 0.05))
                frames.append(dict(image=self.images[picks[f]], image_index=int(picks[f]),
                                   can_bus=can_bus, lidar2img=self.lidar2img,
                                   scene_token=f"{vehicle}-{k}"))
            self._scenes[key] = frames
        return self._scenes[key]

    def frame(self, vehicle: int, k: int, f: int) -> dict:
        return self.scene(vehicle, k)[f]
