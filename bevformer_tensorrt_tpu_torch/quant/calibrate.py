"""Post-training calibration (port of `bevformer_tensorrt_tpu/quant/calibrate.py`).

  1. pass 1 over the calibration batches with every live QDQ site in mode
     "amax",
  2. pass 2 in mode "hist" (histograms binned to the pass-1 amax),
  3. offline scale selection per site (max / percentile / entropy).

The stats passes do not depend on the method, so `collect_stats` runs once
and `scales_from_stats` derives any number of variants from it.  Nothing
here knows the model: the functions take it for its QDQ sites, and a
callable that runs one batch through it.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch.nn as nn

from .observers import CalibrationResult, compute_scale
from .qdq import QDQ


def qdq_sites(model: nn.Module) -> Dict[str, QDQ]:
    """'/'-joined path -> site, for the sites that are not switched off."""
    return {"/".join(name.split(".")): m for name, m in model.named_modules()
            if isinstance(m, QDQ) and m.mode != "off"}


def collect_stats(run_batch: Callable, model: nn.Module, batches: Iterable,
                  with_hist: bool = True, before_pass: Callable = None
                  ) -> Tuple[Dict[str, float], Dict[str, np.ndarray]]:
    """Run the two stats passes; returns (amax, hist) by site path.
    `before_pass()` runs ahead of each pass (e.g. to reset recurrent state,
    so both passes see the same activations)."""
    batches = list(batches)
    sites = qdq_sites(model)
    amax: Dict[str, float] = {}
    hist: Dict[str, np.ndarray] = {}
    try:
        for mode in ("amax", "hist") if with_hist else ("amax",):
            for site in sites.values():
                site.set_mode(mode)
            if before_pass is not None:
                before_pass()
            for batch in batches:
                run_batch(batch)
        amax = {name: float(site.amax) for name, site in sites.items()}
        if with_hist:
            hist = {name: site.hist.cpu().numpy().copy() for name, site in sites.items()}
    finally:
        for site in sites.values():
            site.set_mode("quant")
    return amax, hist


def scales_from_stats(amax: Dict[str, float], hist: Dict[str, np.ndarray],
                      method: str = "entropy", percentile: float = 99.99) -> CalibrationResult:
    """Offline scale selection from collected stats (numpy; no device)."""
    scales = {name: compute_scale(a, hist.get(name) if hist else None, method=method,
                                  percentile=percentile)
              for name, a in amax.items()}
    return CalibrationResult(scales=scales, method=method)


def calibrate(run_batch: Callable, model: nn.Module, batches: Iterable,
              method: str = "entropy", percentile: float = 99.99,
              before_pass: Callable = None) -> CalibrationResult:
    """Two-pass calibration; returns the site -> scale result.  Attach it
    with `quant.fold.attach_quant_scales`.

    Args:
      run_batch: fn(batch) that runs one batch through `model`.
      batches: calibration batches (iterated once per pass).
      method: 'max' | 'percentile' | 'entropy'.
    """
    amax, hist = collect_stats(run_batch, model, batches, with_hist=method != "max",
                               before_pass=before_pass)
    return scales_from_stats(amax, hist, method=method, percentile=percentile)
