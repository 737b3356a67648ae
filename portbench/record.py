"""What a window leaves for the metrics and the check."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class Frame:
    key: Tuple[int, int, int]   # (vehicle, scene, frame)
    start: float                # handed over (stream) or ready (fleet), host clock s
    done: float                 # detections on the host
    enqueue_s: float = 0.0      # the entry's call until it returned (stream)
    queue_s: float = 0.0        # ready until the step that took it began (fleet)


@dataclasses.dataclass
class Run:
    frames: List[Frame] = dataclasses.field(default_factory=list)
    kept: Dict[tuple, tuple] = dataclasses.field(default_factory=dict)
    steps: List[Tuple[float, float, int]] = dataclasses.field(default_factory=list)  # fleet
    attempted: int = 0
    failed: int = 0


# returns (states [layers, 1, nq, C], refs [layers, 1, nq, 3]): each layer's
# output and the reference points it hands to the next
DECODER = "pts_bbox_head.transformer.decoder"


class Capture:
    """The decoder's (states, refs) of each forward call while the block
    runs, in call order, as [layers, nq, ...] (a forward hook; the tensors
    as the program made them)."""

    def __init__(self, model):
        self.decoder = model.get_submodule(DECODER)
        self.outputs: List = []

    def __enter__(self):
        self.outputs = []
        self._hook = self.decoder.register_forward_hook(
            lambda mod, args, out: self.outputs.append((out[0][:, 0], out[1][:, 0])))
        return self

    def __exit__(self, *exc):
        self._hook.remove()


def detections(outputs) -> tuple:
    """(classes, coords) of every decoder layer as float32 numpy
    [layers, num_query, ...] from the program's [layers, 1, num_query, ...]."""
    return tuple(np.asarray(t[:, 0], np.float32) for t in outputs)
