"""The 2D family's inference engine: YOLOX or CenterNet on its device, a
batch of images in, the decode on the device, the host post-processing and
calibration (the engine part of `tools/2d/evaluate.py` and
`tools/2d/calibrate.py` of the JAX package).

YOLOX's decode gives every point's boxes and class scores and the
class-aware NMS runs on the host (`core/nms2d.py`, native); CenterNet's
gives its top k and the host keeps the scores above 0.01.  Boxes are
returned in the original image's pixels (divided by the letterbox scale).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..configs import centernet as centernet_configs
from ..configs import yolox as yolox_configs
from ..models.detectors.centernet import CenterNet
from ..models.detectors.yolox import YOLOX
from ..models.heads.centernet_head import centernet_decode
from ..models.heads.yolox_head import yolox_decode, yolox_post_process
from ..quant.calibrate import calibrate as calibrate_sites
from ..quant.fold import attach_quant_scales
from ..quant.observers import CalibrationResult
from .torch_import import load_centernet_checkpoint, load_yolox_checkpoint
from ..weights import init_weights
from .engine import Readback, readback, resolve_device

MODELS = ("yolox_x", "yolox_s", "yolox_micro", "centernet_r18", "centernet_micro")
# CenterNet's input norm (RGB mean / std of tools/2d/evaluate.py:103-106);
# YOLOX takes raw BGR pixels
CENTERNET_NORM = dict(mean=(123.675, 116.28, 103.53), std=(58.395, 57.12, 57.375), to_rgb=True)
CENTERNET_SCORE_THR = 0.01


def is_yolox(model: str) -> bool:
    return model.startswith("yolox")


def make_config(model: str, **over):
    if model not in MODELS:
        raise ValueError(f"model {model!r}: expected one of {MODELS}")
    return getattr(yolox_configs if is_yolox(model) else centernet_configs, model)(**over)


def image_norm(model: str) -> Dict:
    """CocoDataset's keyword arguments of the model's input norm."""
    return {} if is_yolox(model) else dict(CENTERNET_NORM)


def load_checkpoint_state_dict(cfg, state_dict):
    """The port's state_dict from an upstream-layout YOLOX or CenterNet one."""
    load = (load_yolox_checkpoint if isinstance(cfg, yolox_configs.YOLOXConfig)
            else load_centernet_checkpoint)
    return load(cfg, state_dict)


class Det2DEngine:
    """Batched 2D inference.  `model` defaults to the config's detector with
    seeded weights; `state_dict` (from `load_checkpoint_state_dict`, or
    `weights.params_from_jax`) is loaded strictly when given."""

    def __init__(self, cfg, model=None, state_dict=None, device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.yolox = isinstance(cfg, yolox_configs.YOLOXConfig)
        if model is None:
            model = (YOLOX if self.yolox else CenterNet)(cfg)
            if state_dict is None:
                init_weights(model, torch.Generator().manual_seed(seed))
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()

    @torch.inference_mode()
    def heads(self, images):
        """The head maps of a batch `images` [N, 3, S, S]."""
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        return self.model(images)

    @torch.inference_mode()
    def infer(self, images) -> Tuple[torch.Tensor, ...]:
        """One batch through the model and the decode, on the device:
        YOLOX (boxes [N, P, 4], scores [N, P, C]), CenterNet (boxes
        [N, k, 4], scores [N, k], labels [N, k])."""
        heads = self.heads(images)
        if self.yolox:
            return yolox_decode(heads)
        return centernet_decode(heads, k=self.cfg.topk, kernel=self.cfg.local_max_kernel)

    def readback(self, *tensors: torch.Tensor) -> Readback:
        return readback(self.device, *tensors)

    def post(self, decoded: Sequence[np.ndarray], i: int, scale: float):
        """Image `i` of a batch's host decode: (boxes [k, 4] in the original
        image's pixels, scores [k], labels [k])."""
        if self.yolox:
            boxes, scores = decoded
            b, s, lab = yolox_post_process(boxes[i], scores[i], self.cfg.score_thr,
                                           self.cfg.nms_iou, self.cfg.max_per_img)
            return b / scale, s, lab
        boxes, scores, labels = decoded
        keep = scores[i] > CENTERNET_SCORE_THR
        return boxes[i][keep] / scale, scores[i][keep], labels[i][keep]

    def calibrate(self, batches: Sequence[np.ndarray], method: str = "percentile",
                  percentile: float = 99.99) -> CalibrationResult:
        """Two-pass calibration of the model's QDQ sites over the image
        batches; the chosen scales are attached (and, for int8 layers, the
        weights folded) and returned."""
        result = calibrate_sites(self.heads, self.model, batches, method=method,
                                 percentile=percentile)
        attach_quant_scales(self.model, result.scales)
        return result
