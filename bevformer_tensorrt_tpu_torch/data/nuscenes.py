"""nuScenes dataset: infos-pkl loading, the multi-view image pipeline, GT
(port of `bevformer_tensorrt_tpu/data/nuscenes.py`, numpy and PIL only).

Reads the standard mmdet3d `nuscenes_infos_temporal_*.pkl`, computes each
camera's lidar2img from its calibration (upstream
bevformer_dataset.py:123-138), folds the ego pose and yaw into can_bus
(bevformer_dataset.py:155-165), and runs the eval pipeline: load the views,
normalize, pad to a multiple of 32, then pad or crop to the model's input
size.  Like the reference this repo follows, the eval pipeline does not
resize: a 900x1600 view fed to a 480x800 model is cropped to its top-left
corner.

Frames are numpy arrays on the host; `runtime/engine.py` moves them to the
device.  The training temporal queue (queue_length=4, union2one relative
can_bus deltas, bevformer_dataset.py:31-84) is `TemporalClipSampler`.
"""
from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..native import normalize_pad_chw_native

CLASSES = (
    "car",
    "truck",
    "construction_vehicle",
    "bus",
    "trailer",
    "barrier",
    "motorcycle",
    "bicycle",
    "pedestrian",
    "traffic_cone",
)
# name -> training label id (reference class_names order,
# configs/bevformer/bevformer_base.py:19-31)
CLASS_TO_LABEL = {n: i for i, n in enumerate(CLASSES)}


@dataclasses.dataclass
class ImgNorm:
    mean: Tuple[float, float, float]
    std: Tuple[float, float, float]
    to_rgb: bool


# caffe-style (R101 base/small: configs/bevformer/bevformer_base.py:11)
IMG_NORM_CAFFE = ImgNorm((103.530, 116.280, 123.675), (1.0, 1.0, 1.0), False)
# pytorch-style (R50 tiny: configs/bevformer/bevformer_tiny.py:19-21)
IMG_NORM_PYTORCH = ImgNorm((123.675, 116.28, 103.53), (58.395, 57.12, 57.375), True)


def quaternion_yaw(q: Sequence[float]) -> float:
    """Yaw from a (w, x, y, z) quaternion — heading of the x-axis projected
    to the ground plane (devkit quaternion_yaw equivalent)."""
    w, x, y, z = q
    # rotate unit x-vector, take atan2 of the result's xy
    vx = 1 - 2 * (y * y + z * z)
    vy = 2 * (x * y + z * w)
    return float(np.arctan2(vy, vx))


def lidar2img_from_cam_info(cam_info: dict) -> np.ndarray:
    """Per-camera 4x4 lidar->image projection
    (bevformer_dataset.py:128-138 exactly)."""
    r = np.asarray(cam_info["sensor2lidar_rotation"], np.float64)
    t = np.asarray(cam_info["sensor2lidar_translation"], np.float64)
    lidar2cam_r = np.linalg.inv(r)
    lidar2cam_t = t @ lidar2cam_r.T
    lidar2cam_rt = np.eye(4)
    lidar2cam_rt[:3, :3] = lidar2cam_r.T
    lidar2cam_rt[3, :3] = -lidar2cam_t
    intrinsic = np.asarray(cam_info["cam_intrinsic"], np.float64)
    viewpad = np.eye(4)
    viewpad[: intrinsic.shape[0], : intrinsic.shape[1]] = intrinsic
    return (viewpad @ lidar2cam_rt.T).astype(np.float32)


def process_can_bus(info: dict) -> np.ndarray:
    """Ego pose + yaw folded into can_bus (bevformer_dataset.py:155-165)."""
    can_bus = np.array(info.get("can_bus", np.zeros(18)), np.float32, copy=True)
    rotation = np.asarray(info["ego2global_rotation"], np.float64)  # (w,x,y,z)
    translation = np.asarray(info["ego2global_translation"], np.float64)
    can_bus[:3] = translation
    can_bus[3:7] = rotation
    patch_angle = quaternion_yaw(rotation) / np.pi * 180.0
    if patch_angle < 0:
        patch_angle += 360.0
    can_bus[-2] = patch_angle / 180.0 * np.pi
    can_bus[-1] = patch_angle
    return can_bus


def normalize_image(img: np.ndarray, norm: ImgNorm) -> np.ndarray:
    """img: [H, W, 3] BGR uint8 (cv2/mmcv convention) -> normalized float32."""
    img = img.astype(np.float32)
    if norm.to_rgb:
        img = img[..., ::-1]
    return (img - np.asarray(norm.mean, np.float32)) / np.asarray(norm.std, np.float32)


def pad_to_divisor(img: np.ndarray, divisor: int = 32) -> np.ndarray:
    """Bottom/right zero-pad (mmcv PadMultiViewImage, size_divisor=32)."""
    h, w = img.shape[:2]
    ph = (h + divisor - 1) // divisor * divisor
    pw = (w + divisor - 1) // divisor * divisor
    if (ph, pw) == (h, w):
        return img
    out = np.zeros((ph, pw) + img.shape[2:], img.dtype)
    out[:h, :w] = img
    return out


def load_image(path: str) -> np.ndarray:
    """Load an image file to [H, W, 3] BGR uint8 (mmcv convention)."""
    from PIL import Image

    with Image.open(path) as im:
        rgb = np.asarray(im.convert("RGB"))
    return rgb[..., ::-1]


def extract_gt(info: dict) -> Tuple[np.ndarray, np.ndarray]:
    """GT boxes [N, 9] (cx, cy, cz, w, l, h, yaw, vx, vy) + labels [N].

    mmdet3d infos store gt_boxes [N, 7] (x, y, z, w, l, h, yaw — gravity
    center convention per create_data) and gt_velocity [N, 2]; classes not
    in CLASSES get label -1 (ignored), mirroring the reference's
    valid_flag/CLASSES filtering (nuscenes_dataset.py get_ann_info)."""
    boxes7 = np.asarray(info.get("gt_boxes", np.zeros((0, 7))), np.float32).reshape(-1, 7)
    names = list(info.get("gt_names", []))
    vel = np.asarray(info.get("gt_velocity", np.zeros((len(boxes7), 2))), np.float32)
    vel = np.nan_to_num(vel).reshape(-1, 2)
    valid = np.asarray(info.get("valid_flag", np.ones(len(boxes7), bool)), bool)
    labels = np.array([CLASS_TO_LABEL.get(n, -1) for n in names], np.int32)
    keep = valid & (labels >= 0)
    boxes = np.concatenate([boxes7[keep], vel[keep]], axis=-1)
    return boxes, labels[keep]


@dataclasses.dataclass
class Frame:
    sample_token: str
    scene_token: str
    image: np.ndarray       # [1, cams, 3, H, W] float32, normalized+padded
    can_bus: np.ndarray     # [18]
    lidar2img: np.ndarray   # [1, cams, 4, 4]
    timestamp: float = 0.0
    gt_boxes: Optional[np.ndarray] = None   # [N, 9]
    gt_labels: Optional[np.ndarray] = None  # [N]
    ego2global_translation: Optional[np.ndarray] = None
    ego2global_rotation: Optional[np.ndarray] = None


class NuScenesFrames:
    """Frame iterator over a nuScenes infos pkl, timestamp-sorted
    (the eval order the recurrent prev_bev state machine depends on)."""

    def __init__(
        self,
        infos_path: str | Path,
        data_root: Optional[str | Path] = None,
        img_norm: ImgNorm = IMG_NORM_CAFFE,
        target_hw: Optional[Tuple[int, int]] = None,
        with_gt: bool = True,
        augment=None,  # MultiViewTrainAugment (data/transforms.py) or None
    ):
        with open(infos_path, "rb") as f:
            data = pickle.load(f)
        infos = data["infos"] if isinstance(data, dict) else data
        self.infos: List[dict] = sorted(infos, key=lambda e: e["timestamp"])
        self.metadata = data.get("metadata", {}) if isinstance(data, dict) else {}
        self.data_root = Path(data_root) if data_root else None
        self.img_norm = img_norm
        self.target_hw = target_hw
        self.with_gt = with_gt
        self.augment = augment

    def __len__(self) -> int:
        return len(self.infos)

    def _resolve(self, p: str) -> str:
        if self.data_root is None:
            return p
        q = Path(p)
        if q.is_absolute() and q.exists():
            return str(q)
        return str(self.data_root / p)

    def frame(self, idx: int) -> Frame:
        info = self.infos[idx]
        cams = list(info["cams"].values())
        raw = [load_image(self._resolve(cam["data_path"])) for cam in cams]  # u8 BGR
        l2i_s = np.stack([lidar2img_from_cam_info(c) for c in cams]).astype(np.float32)
        if self.augment is not None:
            # train-pipeline augmentation (photometric / random scale) runs
            # on raw float32 BGR, BEFORE normalize+pad — matching the
            # reference pipeline order (bevformer_base.py:211-225).
            raw = [r.astype(np.float32) for r in raw]
            raw, l2i_s = self.augment(raw, l2i_s)
        elif self.target_hw is not None and len({r.shape for r in raw}) == 1:
            # eval fast path: normalize, pad or crop and CHW in one
            # multi-threaded native pass (csrc/image_pipeline.cpp) in place
            # of the numpy chain below (upstream keeps this in mmcv's C
            # loops, NormalizeMultiviewImage / PadMultiViewImage)
            th, tw = self.target_hw
            image = normalize_pad_chw_native(
                np.stack(raw), th, tw,
                self.img_norm.mean, self.img_norm.std, self.img_norm.to_rgb,
            )[None]
            gt_boxes, gt_labels = extract_gt(info) if self.with_gt else (None, None)
            return Frame(
                sample_token=info["token"],
                scene_token=info.get("scene_token", ""),
                image=image,
                can_bus=process_can_bus(info),
                lidar2img=l2i_s[None],
                timestamp=info["timestamp"] / 1e6,
                gt_boxes=gt_boxes,
                gt_labels=gt_labels,
                ego2global_translation=np.asarray(info["ego2global_translation"], np.float64),
                ego2global_rotation=np.asarray(info["ego2global_rotation"], np.float64),
            )
        imgs = []
        for img in raw:
            img = normalize_image(img, self.img_norm)
            img = pad_to_divisor(img)
            if self.target_hw is not None:
                th, tw = self.target_hw
                if img.shape[0] < th or img.shape[1] < tw:
                    # augmentation downscale: zero-pad back up to the static
                    # model input (bottom/right, like PadMultiViewImage)
                    grown = np.zeros(
                        (max(th, img.shape[0]), max(tw, img.shape[1]), img.shape[2]),
                        img.dtype,
                    )
                    grown[: img.shape[0], : img.shape[1]] = img
                    img = grown
                img = img[:th, :tw]
            imgs.append(img.transpose(2, 0, 1))  # HWC -> CHW
        image = np.stack(imgs)[None]  # [1, cams, 3, H, W]
        l2i = l2i_s[None]
        gt_boxes, gt_labels = extract_gt(info) if self.with_gt else (None, None)
        return Frame(
            sample_token=info["token"],
            scene_token=info.get("scene_token", ""),
            image=image,
            can_bus=process_can_bus(info),
            lidar2img=l2i,
            timestamp=info["timestamp"] / 1e6,
            gt_boxes=gt_boxes,
            gt_labels=gt_labels,
            ego2global_translation=np.asarray(info["ego2global_translation"], np.float64),
            ego2global_rotation=np.asarray(info["ego2global_rotation"], np.float64),
        )

    def __iter__(self) -> Iterator[Frame]:
        for i in range(len(self)):
            yield self.frame(i)


class TemporalClipSampler:
    """Training clips: queue_length consecutive same-scene frames, the
    reference's queue=4 sampling with union2one relative can_bus deltas
    (bevformer_dataset.py:31-84)."""

    def __init__(self, frames: NuScenesFrames, queue_length: int = 4):
        self.frames = frames
        self.queue_length = queue_length
        self.clips: List[List[int]] = []
        by_scene: Dict[str, List[int]] = {}
        for i, info in enumerate(frames.infos):
            by_scene.setdefault(info.get("scene_token", ""), []).append(i)
        for idxs in by_scene.values():
            for j in range(len(idxs) - queue_length + 1):
                self.clips.append(idxs[j : j + queue_length])

    def __len__(self) -> int:
        return len(self.clips)

    def clip(self, k: int) -> List[Frame]:
        fr = [self.frames.frame(i) for i in self.clips[k]]
        # relative can_bus: each frame's position/yaw becomes a delta vs the
        # previous frame; first frame zeroed (union2one, :66-84)
        prev_pos, prev_angle = None, None
        for f in fr:
            cur_pos = f.can_bus[:3].copy()
            cur_angle = float(f.can_bus[-1])
            if prev_pos is None:
                f.can_bus[:3] = 0
                f.can_bus[-1] = 0
            else:
                f.can_bus[:3] -= prev_pos
                f.can_bus[-1] -= prev_angle
            prev_pos, prev_angle = cur_pos, cur_angle
        return fr
