"""QDQ site module (port of `bevformer_tensorrt_tpu/quant/qdq.py`).

A `QDQ` marks a quantization site.  Where the flax module reads its
behaviour from the variable collections the caller makes mutable, this one
has an explicit `mode`:

  * "amax"  -> calibration pass 1: running abs-max; the input passes through.
  * "hist"  -> calibration pass 2: |x| histogram binned to the pass-1 amax.
  * "quant" -> fake-quant with the site's `scale` when it has one (the
    straight-through gradient applies), the identity when it has none.
  * "off"   -> the identity, for good: set for sites that the policy
    excludes or their module switches off; they collect nothing.

`scale` is a buffer that does not exist until calibration attaches it or a
state_dict carries it, as the flax "quant" collection may be absent.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .fake_quant import fake_quant
from .observers import NUM_BINS, update_amax, update_histogram
from .policy import quant_excluded

MODES = ("off", "amax", "hist", "quant")


class OptionalBuffers(nn.Module):
    """Buffers named in `OPTIONAL` start as None (absent from the
    state_dict) and come into being when a state_dict that holds them is
    loaded, so one module loads checkpoints with and without them strictly."""

    OPTIONAL: tuple = ()

    def _load_from_state_dict(self, state_dict, prefix, *args):
        own = [*self.parameters(recurse=False),
               *(b for b in self.buffers(recurse=False) if b is not None)]
        device = own[0].device if own else "cpu"
        for name in self.OPTIONAL:
            t = state_dict.get(prefix + name)
            if t is not None and getattr(self, name) is None:
                setattr(self, name, torch.empty_like(t, device=device))
        super()._load_from_state_dict(state_dict, prefix, *args)


class QDQ(OptionalBuffers):
    OPTIONAL = ("scale",)

    def __init__(self):
        super().__init__()
        self.path: tuple = ()
        self.mode = "quant"
        self.register_buffer("scale", None)
        self.register_buffer("amax", torch.zeros(()), persistent=False)
        self.register_buffer("hist", torch.zeros(NUM_BINS), persistent=False)

    def resolve_quant(self, path, exclude) -> None:
        self.path = tuple(path)
        if quant_excluded(path, exclude):
            self.mode = "off"

    def set_mode(self, mode: str) -> None:
        """Switch a live site between the calibration passes and "quant";
        entering a pass clears that pass's statistic.  Sites that are off
        stay off."""
        if mode not in MODES:
            raise ValueError(f"QDQ mode {mode!r}: expected one of {MODES}")
        if self.mode == "off":
            return
        self.mode = mode
        if mode == "amax":
            self.amax.zero_()
        elif mode == "hist":
            self.hist.zero_()

    @property
    def calibrating(self) -> bool:
        return self.mode in ("amax", "hist")

    def forward(self, x):
        """Returns (y, scale or None)."""
        if self.mode == "amax":
            self.amax.copy_(update_amax(self.amax, x))
        elif self.mode == "hist":
            self.hist.copy_(update_histogram(self.hist, x, self.amax))
        elif self.mode == "quant" and self.scale is not None:
            return fake_quant(x, self.scale), self.scale
        return x, None
