"""The kernels' launch knobs: the constants of the rules that pick each
kernel's geometry, in one store that the rules read at every launch.

The defaults are the rules as they were set by hand on an H100; an
export-time sweep (`runtime/autotune.py`) may replace them with the set
that times fastest at a model's deploy shapes.  Nothing is read at import
or baked into a traced program: a launch reads the store when it runs, so
one process can run two programs under two knob sets, each applying its
own around its call (`using`).

  MSDA_TAPS_PER_BLOCK  (query, head, tap) triples an MSDA block takes at
                       most (`ops/msda.py::msda_launch_geometry`; both
                       tables, floating point and int8)
  MSDA_BLOCKS_PER_SM   blocks an MSDA launch is spread over, per SM of the
                       card, where it has the queries
  DCN_WIDE_TILE        the fused DCN's bfloat16 kernel takes its 256-row
                       tile where a group has more than 128 outputs
                       (`ops/dcn.py::dcn_config`)
  GEMM_SMALL_OUTPUTS   the int8 product takes 64x64 tiles below this many
  GEMM_SMALL_K         outputs and below this K (`ops/int8_matmul.py::gemm_config`)
  FLASH_ROW_GROUPS     row groups a flash block (both flash kernels): 0 the
                       rule (`ops/attention.py::flash_launch_geometry`),
                       else one of its choices, 4, 2 or 1
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Mapping, Optional

DEFAULTS: Dict[str, Any] = {
    "MSDA_TAPS_PER_BLOCK": 1024,
    "MSDA_BLOCKS_PER_SM": 4,
    "DCN_WIDE_TILE": True,
    "GEMM_SMALL_OUTPUTS": 132 * 128 * 128,  # one 128x128 tile per SM of an H100 SXM
    "GEMM_SMALL_K": 1024,
    "FLASH_ROW_GROUPS": 0,
}
FLASH_ROW_GROUP_CHOICES = (0, 4, 2, 1)

_values: Dict[str, Any] = dict(DEFAULTS)


def _checked(name: str, value) -> Any:
    if name not in DEFAULTS:
        raise KeyError(f"unknown kernel knob {name!r}; the knobs are {sorted(DEFAULTS)}")
    if name == "DCN_WIDE_TILE":
        if not isinstance(value, bool):
            raise ValueError(f"knob {name} takes true or false, got {value!r}")
        return value
    if isinstance(value, bool) or not isinstance(value, int):
        raise ValueError(f"knob {name} takes an integer, got {value!r}")
    if name == "FLASH_ROW_GROUPS" and value not in FLASH_ROW_GROUP_CHOICES:
        raise ValueError(f"knob {name} takes one of {FLASH_ROW_GROUP_CHOICES}, got {value}")
    if value < (0 if name.startswith("GEMM_") else 1):
        raise ValueError(f"knob {name} out of range: {value}")
    return value


def get(name: str) -> Any:
    """The value a rule launches with now."""
    return _values[name]


def current() -> Dict[str, Any]:
    """Every knob's value now."""
    return dict(_values)


def complete(knobs: Optional[Mapping[str, Any]]) -> Dict[str, Any]:
    """`knobs` with every knob it does not name at its default (None: the
    defaults).  A name the port does not know, or a value its rule cannot
    take, raises."""
    new = dict(DEFAULTS)
    for name, value in (knobs or {}).items():
        new[name] = _checked(name, value)
    return new


def apply(knobs: Optional[Mapping[str, Any]]) -> None:
    """Set the store to `complete(knobs)`; where that raises, the store
    stays as it was."""
    new = complete(knobs)
    _values.clear()
    _values.update(new)


@contextlib.contextmanager
def using(knobs: Optional[Mapping[str, Any]]) -> Iterator[Dict[str, Any]]:
    """`apply(knobs)` for the block, then the knobs that were set before."""
    saved = current()
    apply(knobs)
    try:
        yield current()
    finally:
        _values.clear()
        _values.update(saved)
