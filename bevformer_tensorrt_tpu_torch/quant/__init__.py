"""Quantization of the port: fake-quant primitives, observers, the policy,
QDQ sites, calibration and int8 weight folding."""
from .calibrate import calibrate, collect_stats, scales_from_stats
from .fake_quant import dequantize, fake_quant, per_channel_scale, quantize
from .fold import attach_quant_scales, fold_int8_weights
from .observers import (
    CalibrationResult,
    compute_scale,
    entropy_threshold,
    update_amax,
    update_histogram,
)
from .policy import (
    effective_quant,
    load_policy,
    quant_excluded,
    save_policy,
    set_quant_exclude,
)
from .qdq import QDQ

__all__ = [
    "QDQ", "CalibrationResult", "attach_quant_scales", "calibrate", "collect_stats",
    "compute_scale", "dequantize", "effective_quant", "entropy_threshold", "fake_quant",
    "fold_int8_weights", "load_policy", "per_channel_scale", "quant_excluded", "quantize",
    "save_policy", "scales_from_stats", "set_quant_exclude", "update_amax",
    "update_histogram",
]
