"""Model registry: name -> (config factory, model class) (port of
`bevformer_tensorrt_tpu/registry.py`).

The same eleven names as the JAX package's `MODELS`.  `build_model` returns
the port's `nn.Module` with seeded weights on the card unless the caller
names another device; `device="meta"` builds the module without storage
(parameter counts of the full-width tiers cost no memory or time).
"""
from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, Tuple

import torch

from .configs import bevformer as _bevformer
from .configs.bevdet import bevdet_micro, bevdet_r50
from .configs.centernet import centernet_micro, centernet_r18
from .configs.yolox import yolox_micro, yolox_s, yolox_x


def _lazy(module_path: str, cls: str) -> Callable[[], Any]:
    def get():
        return getattr(importlib.import_module(module_path, __package__), cls)

    return get


_BEVFORMER = _lazy(".models.detectors.bevformer", "BEVFormer")
MODELS: Dict[str, Tuple[Callable, Callable[[], Any]]] = {
    "bevformer_tiny": (_bevformer.bevformer_tiny, _BEVFORMER),
    "bevformer_small": (_bevformer.bevformer_small, _BEVFORMER),
    "bevformer_base": (_bevformer.bevformer_base, _BEVFORMER),
    "bevformer_micro": (_bevformer.bevformer_micro, _BEVFORMER),
    "bevdet_r50": (bevdet_r50, _lazy(".models.detectors.bevdet", "BEVDet")),
    "bevdet_micro": (bevdet_micro, _lazy(".models.detectors.bevdet", "BEVDet")),
    "yolox_x": (yolox_x, _lazy(".models.detectors.yolox", "YOLOX")),
    "yolox_s": (yolox_s, _lazy(".models.detectors.yolox", "YOLOX")),
    "yolox_micro": (yolox_micro, _lazy(".models.detectors.yolox", "YOLOX")),
    "centernet_r18": (centernet_r18, _lazy(".models.detectors.centernet", "CenterNet")),
    "centernet_micro": (centernet_micro, _lazy(".models.detectors.centernet", "CenterNet")),
}


def build_model(name: str, device=None, seed: int = 0, **overrides):
    """Returns (model, cfg) for a registered name: the model in eval mode on
    `device` (CUDA unless named; raises without a card), its weights from
    `weights.init_weights` with `seed`.  On the meta device nothing is
    drawn.  `overrides` go to the config factory."""
    from .runtime.engine import resolve_device
    from .weights import init_weights

    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; registered: {sorted(MODELS)}")
    cfg_fn, cls_fn = MODELS[name]
    cfg = cfg_fn(**overrides)
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    if dev.type == "meta":
        with torch.device("meta"):
            return cls_fn()(cfg).eval(), cfg
    model = cls_fn()(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval(), cfg


def count_params(model: torch.nn.Module) -> int:
    """Trainable parameters: what the JAX package counts in its `params`
    collection (BatchNorm statistics and the quantization buffers are
    buffers here, as they are other collections there)."""
    return sum(p.numel() for p in model.parameters())
