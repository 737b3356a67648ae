"""Export-time kernel-knob autotuning, persisted with the deploy artifact
(counterpart of `bevformer_tensorrt_tpu/runtime/autotune.py`).

The reference times every cuBLAS algorithm when it builds its engine and
serializes the winner into the plan (TensorRT's tactic search).  The port's
kernels pick their launch geometry by rules whose constants were set by hand
on one H100 (`ops/knobs.py`); `autotune` sweeps a grid of those knobs at a
model's deploy shapes on the card in hand, and `save_knobs` writes the
winner and the whole table beside the exported program as `knobs.json`.

The knobs are read at every launch, not at a trace, so nothing of them is
baked into a program: `runtime/export.py::load_program` reads `knobs.json`
and runs the program under it, and a tool that builds its model from a
config applies `load_knobs(dir)` first (`tools/evaluate.py --knobs`).
"""
from __future__ import annotations

import itertools
import json
import pathlib
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..ops import knobs as _store

KNOBS = tuple(_store.DEFAULTS)
KNOBS_FILE = "knobs.json"

# the rule's defaults first, then MSDA taps a block x blocks an SM x the DCN's
# wide tile; the int8 product's and flash's knobs stay at their rules unless a
# caller widens the grid
_SWEPT = ("MSDA_TAPS_PER_BLOCK", "MSDA_BLOCKS_PER_SM", "DCN_WIDE_TILE")
_RULES = {k: _store.DEFAULTS[k] for k in _SWEPT}
DEFAULT_GRID: List[Dict[str, Any]] = [_RULES] + [
    knobs for knobs in (dict(zip(_SWEPT, values)) for values in itertools.product(
        (512, 1024, 2048), (2, 4, 8), (True, False)))
    if knobs != _RULES]

apply_knobs = _store.apply  # None restores every default
knob_set = _store.using     # a context manager: the knobs for a block, then the earlier ones


def autotune(bench_once: Callable[[Dict[str, Any]], float],
             grid: Sequence[Dict[str, Any]] = DEFAULT_GRID) -> Dict:
    """Sweep `grid`, timing `bench_once(knobs)` (seconds a frame; the
    callable applies the knobs around its calls, `knob_set`).  A set that
    raises loses, with its error in the table; no set falls back to
    another path.  Returns {"knobs": winner, "seconds", "table"}; raises
    when every set fails."""
    table = []
    best, best_t = None, float("inf")
    for knobs in grid:
        try:
            t = float(bench_once(dict(knobs)))
        except Exception as e:  # a geometry the kernel or the card refuses loses
            table.append({**knobs, "error": f"{type(e).__name__}: {str(e)[:120]}"})
            continue
        table.append({**knobs, "seconds": round(t, 5)})
        if t < best_t:
            best, best_t = dict(knobs), t
    if best is None:
        raise RuntimeError("autotune: every knob combination failed")
    return {"knobs": best, "seconds": round(best_t, 5), "table": table}


def save_knobs(artifact_dir, result: Dict) -> None:
    p = pathlib.Path(artifact_dir) / KNOBS_FILE
    p.write_text(json.dumps(result, indent=1))


def load_knobs(artifact_dir) -> Optional[Dict[str, Any]]:
    """The tuned knobs of an export directory (None where it has no
    `knobs.json`: the defaults apply).  A knob the port does not know, or a
    value its rule cannot take, raises."""
    p = pathlib.Path(artifact_dir) / KNOBS_FILE
    if not p.exists():
        return None
    knobs = json.loads(p.read_text()).get("knobs")
    _store.complete(knobs)
    return knobs
