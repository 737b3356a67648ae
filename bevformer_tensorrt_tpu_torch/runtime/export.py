"""The deployable artifact: a `torch.export` program that carries its
weights, the ".trt engine" analogue (counterpart of
`bevformer_tensorrt_tpu/runtime/export.py`).

The reference deploys a serialized TensorRT plan.  Here `export_program`
traces a module's forward at example inputs with `torch.export` (non-strict,
under no_grad) and saves `model.pt2` beside a `meta.json`; every CUDA launch
of the port is a registered operator (`ops/plain_vjp.py`), so each kernel is
one node of the program, and `load_program` reloads it in any process that
can import the port.  The JAX module's `aot_compile` (a loaded executable for
this chip, with the compilation cache between processes) has no direct
counterpart: the program runs the kernels' libraries, which
`ops._cuda.build()` compiles for the card into `csrc/build/` (the export
CLIs' `--aot`).

A program holds the device of its example inputs in its traced constants,
so it is exported on the device it will run on; `load_program` refuses
another.  A module holding a transposed convolution that needs cuDNN's
deterministic algorithms (`cudnn_deterministic` on the module, CenterNet's
neck) asks for them through a backend flag, which no graph carries:
`meta.json` records it and the loaded program sets it around every call.
The kernels' launch knobs are read at launch, not traced either: where the
directory holds a `knobs.json` (`tools/export.py --autotune`), the loaded
program runs under its knobs, else under the defaults
(`runtime/autotune.py`).
"""
from __future__ import annotations

import contextlib
import json
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import torch

from .autotune import knob_set, load_knobs
from .engine import resolve_device

ARTIFACT = "model.pt2"
META = "meta.json"


def _cudnn_deterministic(module: torch.nn.Module) -> bool:
    return any(getattr(m, "cudnn_deterministic", False) for m in module.modules())


def _device_of(args: Sequence[Any]) -> torch.device:
    devices = {a.device for a in args if torch.is_tensor(a)}
    if len(devices) != 1:
        raise ValueError(f"export: the example inputs must share one device, got {devices}")
    return devices.pop()


def export_program(module: torch.nn.Module, args: Sequence[Any], path,
                   meta: Optional[Dict[str, Any]] = None) -> torch.export.ExportedProgram:
    """Export `module.forward(*args)` into the directory `path`: `model.pt2`
    (the program and its weights) and `meta.json` (`meta` with the device,
    torch's version and the cuDNN flag).  The module runs once eagerly
    first, so the matrices it keeps from its weights (`QDense` / `QConv`
    `wmat`, `DeformConv2d`'s) exist before the trace, which takes them as
    they are.  Returns the exported program."""
    module = module.eval()
    args = tuple(args)
    device = _device_of(args)
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    with torch.no_grad():
        module(*args)
        program = torch.export.export(module, args, strict=False)
    torch.export.save(program, str(path / ARTIFACT))
    meta = dict(meta or {}, device=device.type, torch=torch.__version__,
                cudnn_deterministic=_cudnn_deterministic(module))
    (path / META).write_text(json.dumps(meta, indent=1))
    return program


class Program:
    """A reloaded artifact: calling it runs the program's module under
    no_grad and under its kernel knobs (`knobs`; None: the defaults), with
    cuDNN's deterministic algorithms where `meta.json` asks for them; the
    knobs set before the call are restored after it."""

    def __init__(self, program: torch.export.ExportedProgram, meta: Dict[str, Any],
                 knobs: Optional[Dict[str, Any]] = None):
        self.program = program
        self.meta = meta
        self.knobs = knobs
        self.module = program.module()

    def __call__(self, *args):
        flags = contextlib.nullcontext()
        if self.meta.get("cudnn_deterministic"):
            cudnn = torch.backends.cudnn
            flags = cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                                benchmark_limit=cudnn.benchmark_limit, deterministic=True,
                                allow_tf32=cudnn.allow_tf32)
        with torch.no_grad(), flags, knob_set(self.knobs):
            return self.module(*args)


def load_program(path, device=None) -> Program:
    """Reload the artifact directory `path` on `device` (CUDA unless the
    caller names another; raises where it differs from the device the
    program was exported on), with the knobs of its `knobs.json` where it
    has one.  Imports the port's ops first, which registers the operators
    the program calls."""
    from .. import ops  # noqa: F401  (registers the bevformer_port operators)

    path = Path(path)
    meta = json.loads((path / META).read_text())
    device = resolve_device(device)
    if meta.get("device") != device.type:
        raise ValueError(f"{path}: exported on {meta.get('device')}, asked to run on "
                         f"{device.type}; export again on that device")
    return Program(torch.export.load(str(path / ARTIFACT)), meta, load_knobs(path))


def artifact_summary(path) -> Dict[str, Any]:
    """The export CLIs' last line: {out, artifacts (bytes of each file),
    artifact_mb (their sum, in 1e6 bytes)}."""
    sizes = {p.name: p.stat().st_size for p in sorted(Path(path).iterdir()) if p.is_file()}
    return {"out": str(path), "artifacts": sizes, "artifact_mb": sum(sizes.values()) / 1e6}
