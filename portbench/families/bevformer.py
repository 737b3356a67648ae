"""The BEVFormer family: its weights, and what decides `correct`: the
frames of the window checked against the plain reference
(`reference/model.py`), at the timed sizes.

A configuration file names its family module under "family_module"; the
harness (`run.py`) calls `program_weights`, `sample`, `compare` and
`metric_context` of that module and reads `NUMBERS`.

The weights are drawn from the seed on the card in the upstream checkpoint's
layout (`reference/weights.py`) and handed to the program through
`runtime/torch_import.py::load_bevformer_checkpoint`, as a user's `.pth`
would be.

The sample is drawn from the seed before the window (the entry keeps the
program's outputs of those frames as it produces them): frames 0 and 1 of
scene `check_first_scene` of every vehicle (so every lane of the fleet's
first steps), and for `check_vehicles` vehicles drawn from the seed two
more frames of that scene drawn from [2, check_depth), and frames 0 and 1
of the next scene.  A frame 0 follows a scene change, a frame 1 carries the
BEV of its scene's frame 0, the deeper ones the BEV over the scene so far;
in the fleet the next scene's frames run in a slot another scene held
before.  The reference replays each checked scene from its first frame with
its own copy of the temporal state (the can_bus deltas and the scene reset),
on the same weights (drawn again from the seed) and the same frames, and
compares only the frames that the window finished.

The decoder is compared layer by layer.  Layer 0 follows from the
reference's own BEV and the query embedding alone.  Layer i > 0 takes the
program's own layer i - 1 output and the reference points it handed on (the
entry keeps the decoder's states and points of the checked frames), so each
layer is held to its own rounding; the refinement between layers is
checked by itself, the reference refining the program's points by the
regression branch over the program's states.  (From the query embedding
alone the seeded decoder multiplies a difference ~3.5x a layer; and the
reference points pick where a layer samples a 200x200 BEV of seeded
features, where bfloat16's rounding of a branch moves them by a fraction of
a cell: fed its own points, a later layer reads differences of a column's
spread.)

Numbers (each the worst over the checked frames), each held to a limit of
the cell's `limits/<workload>.json`:
- bev_rel: ||bev - bev_ref|| / ||bev_ref - mean(bev_ref)||, the BEV embedding
  that the frame carries to the next (backbone, neck and encoder);
- classes_max, coords_max: the largest |x - x_ref| of any decoder layer's
  class logits, or of its box coordinates and the reference points it
  hands on, over the reference's standard deviation of that layer's column
  across the object queries.
"""
from __future__ import annotations

from typing import Dict, Iterable, Set, Tuple

import numpy as np
import torch

from ..frames import rig
from ..reference.model import Reference, exact_float32
from ..reference.weights import seeded_checkpoint

NUMBERS = ("bev_rel", "classes_max", "coords_max")


def program_weights(config: dict, cfg, seed: int, device) -> dict:
    """The program's state dict: the seeded upstream checkpoint through the
    port's checkpoint loader."""
    from bevformer_tensorrt_tpu_torch.runtime.torch_import import load_bevformer_checkpoint
    weights = seeded_checkpoint(config["model"], seed, device,
                                config["assumed"]["offset_conv_scale"])
    return load_bevformer_checkpoint(cfg, weights)


def metric_context(config: dict) -> dict:
    """What the per-layer readers take from the family: `visible`, the BEV
    queries each camera of the rig sees (any pillar point in view)."""
    m = config["model"]
    ref = Reference({}, m)
    _, mask = ref.point_sampling(ref.reference_points_3d("cpu"), torch.as_tensor(rig(m)))
    return {"visible": [int(c) for c in (mask[..., 0] > 0).sum(dim=1)]}


def sample(seed: int, params: dict) -> Set[Tuple[int, int, int]]:
    rng = np.random.default_rng([seed, 0x5EED])
    n = int(params["vehicles"])
    first, depth = int(params["check_first_scene"]), int(params["check_depth"])
    keys = {(v, first, f) for v in range(n) for f in (0, 1)}
    for v in rng.choice(n, size=int(params["check_vehicles"]), replace=False):
        deep = rng.choice(np.arange(2, depth), size=2, replace=False)
        keys |= {(int(v), first, int(f)) for f in deep}
        keys |= {(int(v), first + 1, 0), (int(v), first + 1, 1)}
    return keys


class TemporalState:
    """The can_bus deltas and the scene reset of a camera stream: position
    and angle as deltas to the previous frame of the same scene, zero on a
    scene's first frame."""

    def __init__(self):
        self.pos = np.zeros(3, np.float32)
        self.angle = np.float32(0.0)
        self.token = None

    def step(self, can_bus, token) -> Tuple[np.ndarray, float]:
        can_bus = np.array(can_bus, np.float32, copy=True)
        pos, angle = can_bus[:3].copy(), np.float32(can_bus[-1])
        use_prev = 1.0 if token == self.token else 0.0
        if use_prev:
            can_bus[:3] -= self.pos
            can_bus[-1] -= self.angle
        else:
            can_bus[:3] = 0.0
            can_bus[-1] = 0.0
        self.pos, self.angle, self.token = pos, angle, token
        return can_bus, use_prev


def worse(a: float, b: float) -> float:
    """The larger, where a NaN is the worst of all."""
    return float("nan") if (a != a or b != b) else max(a, b)


def column_max(x: np.ndarray, ref: np.ndarray) -> float:
    std = ref.std(axis=0)
    return float((np.abs(x - ref) / np.maximum(std, 1e-12)).max())


def bev_rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float(torch.linalg.norm(x.float() - ref) / torch.linalg.norm(ref - ref.mean()))


@torch.no_grad()
def compare(config: dict, seed: int, traffic, kept: Dict[tuple, tuple], done: Iterable[tuple],
            device) -> Tuple[Dict[str, float], int]:
    """(the numbers, frames compared) for the kept frames among `done`.  A
    kept frame is (bev [nq, C], classes [layers, num_query, classes],
    coords [layers, num_query, code_size], (decoder states [layers,
    num_query, C], reference points [layers, num_query, 3]))."""
    done = set(done)
    todo = {key: kept[key] for key in kept if key in done}
    w = seeded_checkpoint(config["model"], seed, device, config["assumed"]["offset_conv_scale"])
    ref = Reference(w, config["model"])
    numbers = {name: 0.0 for name in NUMBERS}
    scenes = sorted({key[:2] for key in todo})
    with exact_float32():
        for v, k in scenes:
            last = max(f for (vv, kk, f) in todo if (vv, kk) == (v, k))
            state, prev = TemporalState(), None
            for f in range(last + 1):
                fr = traffic.frame(v, k, f)
                can_bus, use_prev = state.step(fr["can_bus"], fr["scene_token"])
                got = todo.get((v, k, f))
                image = torch.as_tensor(fr["image"][0], device=device)
                given = None if got is None else tuple(
                    t.to(device, torch.float32) for t in got[3])
                bev, classes, coords, refined = ref.frame(
                    image, prev, use_prev, torch.as_tensor(can_bus, device=device),
                    torch.as_tensor(fr["lidar2img"][0], device=device), given=given,
                    decode=got is not None)
                prev = bev
                if got is None:
                    continue
                numbers["bev_rel"] = worse(numbers["bev_rel"], bev_rel(got[0], bev))
                ours_refs = given[1].cpu().numpy()
                for name, pairs in (("classes_max", ((got[1], classes),)),
                                    ("coords_max", ((got[2], coords), (ours_refs, refined)))):
                    for ours, theirs in pairs:
                        theirs = theirs.cpu().numpy()
                        for layer in range(len(theirs)):
                            numbers[name] = worse(numbers[name],
                                                  column_max(ours[layer], theirs[layer]))
    return numbers, len(todo)
