"""Calibration observers: max, histogram + percentile, entropy (KL)
(port of `bevformer_tensorrt_tpu/quant/observers.py`).

Calibration is two passes over activation statistics collected at the QDQ
sites (quant/calibrate.py):
  pass 1: running abs-max per site (`update_amax`);
  pass 2: a fixed-bin histogram of |x| over [0, pass-1 amax]
          (`update_histogram`).
Both run on the model's device.  Scale selection then runs offline in numpy
(`compute_scale`): 'max' uses the amax, 'percentile' integrates the
histogram, 'entropy' runs the TensorRT-style KL-divergence threshold search.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

NUM_BINS = 2048
QUANT_LEVELS = 128  # int8 positive range


def update_amax(old_amax: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Running per-tensor abs-max (pass 1); scalar state."""
    return torch.maximum(old_amax, x.detach().abs().max().to(old_amax.dtype))


def update_histogram(hist: torch.Tensor, x: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """Accumulate |x| into a NUM_BINS histogram over [0, amax] (pass 2)."""
    ax = x.detach().abs().reshape(-1).float()
    width = amax.float().clamp_min(1e-12) / NUM_BINS
    idx = (ax / width).to(torch.int64).clamp(0, NUM_BINS - 1)
    return hist + torch.bincount(idx, minlength=NUM_BINS).to(hist.dtype)


def _kl_divergence(p: np.ndarray, q: np.ndarray) -> float:
    p = p / max(p.sum(), 1e-12)
    q = q / max(q.sum(), 1e-12)
    mask = p > 0
    qm = np.where(q > 0, q, 1e-12)
    return float(np.sum(p[mask] * np.log(p[mask] / qm[mask])))


def entropy_threshold(hist: np.ndarray, stride: int = 1) -> int:
    """TensorRT-style KL threshold search: the clip bin i (>= 128) whose
    128-level quantization of hist[:i] (outliers folded into the last bin)
    minimizes KL(P || Q).  Returns the chosen bin count i.

    The stride stays 1: the KL curve has deep, narrow minima where the clip
    boundary meets the gap between bulk and outliers, and a coarser scan
    steps over them."""
    hist = hist.astype(np.float64)
    best_i, best_kl = NUM_BINS, np.inf
    if hist.sum() == 0:
        return NUM_BINS
    tail = np.concatenate([np.cumsum(hist[::-1])[::-1], [0.0]])  # tail[i] = hist[i:].sum()
    nz_all = hist > 0
    for i in range(QUANT_LEVELS, NUM_BINS + 1, stride):
        raw = hist[:i]
        p = raw.copy()
        p[-1] += tail[i]  # fold clipped outliers into P's last bin
        # quantize the unfolded distribution into QUANT_LEVELS groups, then
        # expand back over raw's nonzero support
        group = i / QUANT_LEVELS
        starts = (np.arange(QUANT_LEVELS) * group).round().astype(int)
        nz = nz_all[:i]
        gsum = np.add.reduceat(raw, starts)
        gcnt = np.add.reduceat(nz.astype(np.float64), starts)
        gavg = np.where(gcnt > 0, gsum / np.maximum(gcnt, 1.0), 0.0)
        lens = np.diff(np.append(starts, i))
        q = np.repeat(gavg, lens) * nz
        kl = _kl_divergence(p, q)
        if kl < best_kl:
            best_kl, best_i = kl, i
    return best_i


def compute_scale(amax: float, hist: np.ndarray | None, method: str = "entropy",
                  percentile: float = 99.99) -> float:
    """Collected stats -> an int8 scale (x_int8 = round(x / scale)).
    method: 'max' | 'percentile' | 'entropy'."""
    amax = float(amax)
    if amax <= 0:
        return 1.0
    if method == "max" or hist is None:
        return amax / 127.0
    hist = np.asarray(hist, np.float64)
    width = amax / NUM_BINS
    if method == "percentile":
        total = hist.sum()
        if total == 0:
            return amax / 127.0
        cdf = np.cumsum(hist) / total
        bin_idx = int(np.searchsorted(cdf, percentile / 100.0))
        return max((bin_idx + 1) * width, 1e-12) / 127.0
    if method == "entropy":
        i = entropy_threshold(hist)
        return max((i + 0.5) * width / 127.0, 1e-12)
    raise ValueError(f"unknown calibration method {method!r}")


@dataclasses.dataclass
class CalibrationResult:
    """Site path -> scale, with the method that chose them.  The `.npz`
    layout is the JAX package's: one float32 per site plus `method`."""

    scales: Dict[str, float]
    method: str

    def save(self, path: str):
        np.savez(path, method=self.method, **{k: np.float32(v) for k, v in self.scales.items()})

    @staticmethod
    def load(path: str) -> "CalibrationResult":
        data = np.load(path, allow_pickle=False)
        method = str(data["method"])
        scales = {k: float(data[k]) for k in data.files if k != "method"}
        return CalibrationResult(scales=scales, method=method)
