"""Host-side native code of the port (port of
`bevformer_tensorrt_tpu/native.py`: the image pass, the rotated NMS and the
axis-aligned 2D NMS):
`csrc/image_pipeline.cpp` and `csrc/nms_rotated.cpp`, each built with g++ at
first use and bound with ctypes.

A library is built into `csrc/build/host/` under a name that carries a hash
of its source and flags, so an edited source is rebuilt.  A failed build
raises: there is no numpy fallback (the JAX wrapper falls back to
`core/nms.py` and `core/nms2d.py`; the port keeps their numpy loops as the
tests' oracles only).
Nothing is built at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import numpy as np

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = CSRC / "build" / "host"
CXX = "g++"
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    text = (CSRC / f"{name}.cpp").read_bytes() + " ".join(CXX_FLAGS).encode()
    return BUILD / f"lib{name}-{hashlib.sha256(text).hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cpp` unless its library exists; raises if the
    compiler is missing or fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"cannot run {CXX} to build {name}.cpp: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"{CXX} failed for {name}.cpp:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _image_lib() -> ctypes.CDLL:
    lib = _libs.get("image_pipeline")
    if lib is None:
        lib = ctypes.CDLL(str(build("image_pipeline")))
        lib.normalize_pad_chw.restype = None
        lib.normalize_pad_chw.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        _libs["image_pipeline"] = lib
    return lib


def normalize_pad_chw_native(images: np.ndarray, out_h: int, out_w: int,
                             mean: Sequence[float], std: Sequence[float],
                             to_rgb: bool) -> np.ndarray:
    """[n, h, w, 3] uint8 BGR -> [n, 3, out_h, out_w] float32: optional
    BGR->RGB, (x - mean) / std per channel (mean and std in the output's
    channel order), zero-padded or cropped at the bottom and right."""
    images = np.ascontiguousarray(images, np.uint8)
    if images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(f"expected [n, h, w, 3] uint8 images, got {images.shape}")
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"output size {out_h}x{out_w}")
    n, h, w, _ = images.shape
    mean_arr = np.ascontiguousarray(mean, np.float32).reshape(3)
    std_arr = np.ascontiguousarray(std, np.float32).reshape(3)
    out = np.empty((n, 3, out_h, out_w), np.float32)
    _image_lib().normalize_pad_chw(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, h, w, out_h, out_w,
        mean_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(to_rgb),
    )
    return out


def _nms_lib() -> ctypes.CDLL:
    lib = _libs.get("nms_rotated")
    if lib is None:
        lib = ctypes.CDLL(str(build("nms_rotated")))
        lib.nms_rotated.restype = ctypes.c_int64
        lib.nms_rotated.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int64)]
        lib.rotated_iou_matrix.restype = None
        lib.rotated_iou_matrix.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
        lib.nms_2d.restype = ctypes.c_int64
        lib.nms_2d.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int64)]
        _libs["nms_rotated"] = lib
    return lib


def _boxes5(boxes5) -> np.ndarray:
    b = np.ascontiguousarray(boxes5, np.float32)
    if b.ndim != 2 or b.shape[1] != 5:
        raise ValueError(f"expected [n, 5] boxes (cx, cy, w, l, yaw), got {b.shape}")
    return b


def nms_rotated_native(boxes5: np.ndarray, scores: np.ndarray,
                       iou_threshold: float) -> np.ndarray:
    """Greedy rotated NMS over [n, 5] (cx, cy, w, l, yaw) boxes in order of
    descending score; returns the kept indices (into the input), highest
    score first."""
    order = np.argsort(-np.asarray(scores))
    b = np.ascontiguousarray(_boxes5(boxes5)[order])
    keep = np.empty(len(b), np.int64)
    n = _nms_lib().nms_rotated(
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(b), ctypes.c_float(iou_threshold),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return order[keep[:n]]


def rotated_iou_matrix_native(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise rotated BEV IoU of [n, 5] and [m, 5] boxes: [n, m] float32."""
    a, b = _boxes5(a), _boxes5(b)
    out = np.empty((len(a), len(b)), np.float32)
    _nms_lib().rotated_iou_matrix(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(a),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(b),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def nms_2d_native(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Greedy axis-aligned NMS over [n, 4] xyxy boxes in order of descending
    score (`csrc/nms_rotated.cpp::nms_2d`); returns the kept indices (into
    the input), highest score first."""
    b = np.asarray(boxes, np.float32)
    if b.ndim != 2 or b.shape[1] != 4:
        raise ValueError(f"expected [n, 4] xyxy boxes, got {b.shape}")
    order = np.argsort(-np.asarray(scores))
    b = np.ascontiguousarray(b[order])
    keep = np.empty(len(b), np.int64)
    n = _nms_lib().nms_2d(
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(b), ctypes.c_float(iou_threshold),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return order[keep[:n]]
