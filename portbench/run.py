"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell is found by name in `BENCHMARK.json`;
its configuration (`portbench/configs/<config>.json`), traffic mix
(`portbench/traffic/<traffic>.json`), limits (`portbench/limits/<name>.json`)
and per-layer metrics (`portbench/metrics/<metric>.py`) by theirs; the
configuration names the program's config factory ("program") and its
family's module ("family_module", such as `portbench/families/bevformer.py`:
the weights, the check's sample and the comparison with the plain
reference).  A run: makes the weights and the traffic from the seed on the
card, builds the program's entry (`portbench/entries/<entry>.py`, named by
the traffic file), warms it up on the window's shapes, drives it for
`--seconds` of wall clock, then checks the window's outputs against the
plain reference and prints one JSON line last on standard output.
`--trace 1` reports the cell's per-layer metrics in place of its end-to-end
ones: the host-clock ones from that window, run as with `--trace 0`, the
device ones from a second window of at most TRACED_SECONDS that goes on
where the first stopped, under `torch.profiler`.

It runs on CUDA only: without a card, or with fewer than the cell asks for,
it exits 2 and prints no result.  It exits 3, with no result, where the
process holds `jax`, `jaxlib`, `flax` or the JAX package once the window has
closed.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench_cache"
# the program's and the libraries' build caches, at fixed paths in the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
# one process with few threads: the host's thread pools stay at one thread,
# so the run's host work does not contend with itself for the machine's cores
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import trace  # noqa: E402
from portbench.frames import Traffic  # noqa: E402

torch.set_num_threads(1)

FORBIDDEN = ("jax", "jaxlib", "flax", "bevformer_tensorrt_tpu")
WARM_FRAMES = 3  # a scene's first frame and two carrying the BEV
TRACED_SECONDS = 20.0  # the traced window's length at most


def since_start() -> float:
    """Seconds since this process started (the kernel's start time of the
    process against the boot clock), else since this module was loaded."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _LOADED


_LOADED = time.perf_counter()


def load_json(path: Path, what: str, root: Path = ROOT) -> dict:
    if not path.is_file():
        raise SystemExit(f"portbench: no {what} file {path.relative_to(root)}")
    return json.loads(path.read_text())


def load_cell(name: str, root: Path = ROOT) -> types.SimpleNamespace:
    """The cell `name` of `BENCHMARK.json` with its configuration, traffic,
    limits and per-layer metric entries; exits naming what is missing."""
    bench = load_json(root / "BENCHMARK.json", "benchmark", root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no workload {name!r}; BENCHMARK.json has "
                         f"{', '.join(sorted(cells))}")
    cell = cells[name]
    here = root / "portbench"
    config = load_json(here / "configs" / f"{cell['config']}.json", "configuration", root)
    traffic = load_json(here / "traffic" / f"{cell['traffic']}.json", "traffic", root)
    limits_path = here / "limits" / f"{name}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.is_file() else None
    reported = {m["name"] for m in bench["end_to_end"]
                if "workloads" not in m or name in m["workloads"]}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    for m in per_layer:
        if not (here / "metrics" / f"{m['name']}.py").is_file():
            raise SystemExit(f"portbench: no reader portbench/metrics/{m['name']}.py")
    return types.SimpleNamespace(name=name, chips=cell["chips"], config=config, params=traffic,
                                 limits=limits, end_to_end=bench["end_to_end"],
                                 per_layer=per_layer, root=root)


def reader(root: Path, metric: str):
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def entry_class(params: dict):
    name = params["entry"]
    if not (ROOT / "portbench" / "entries" / f"{name}.py").is_file():
        raise SystemExit(f"portbench: no entry portbench/entries/{name}.py")
    return importlib.import_module(f"portbench.entries.{name}").Entry


def program_config(config: dict, overrides: dict):
    """The program's config from the factory that the configuration names."""
    prog = config["program"]
    factory = getattr(importlib.import_module(prog["module"]), prog["factory"])
    return factory(**{**prog["overrides"], **overrides})


def family(config: dict):
    """The configuration's family module (weights, sample, comparison)."""
    name = config["family_module"]
    if not name.startswith("portbench.families."):
        raise SystemExit(f"portbench: family module {name!r} is not under portbench/families/")
    return importlib.import_module(name)


def finite(x: float):
    """x, or None for a NaN (JSON has no NaN)."""
    return None if x != x else x


def end_to_end(window_frames, seconds: float, setup_s: float) -> dict:
    """The end-to-end metrics of a window: frames whose detections reached
    the host in it over its seconds, and the set-up's seconds."""
    return {"setup_s": setup_s, "fps": len(window_frames) / seconds}


def run_cell(cell, seed: int, seconds: float, traced: bool, device, clock=since_start,
             overrides: dict = None, calibrate: str = None) -> dict:
    """One run of `cell`: the result's dict, `correct` decided.  `overrides`
    and `calibrate` (a method) serve the control, the program's int8 path."""
    cuda = device.type == "cuda"
    config, params = cell.config, cell.params
    fam = family(config)
    phases = {"imports": clock()}

    def phase(name):
        if cuda:
            torch.cuda.synchronize()
        phases[name] = clock() - sum(phases.values())

    cfg = program_config(config, overrides or {})
    if cuda:
        from bevformer_tensorrt_tpu_torch.ops import _cuda
        _cuda.build()  # every kernel source at once; a later run finds them built
    phase("kernels")
    state_dict = fam.program_weights(config, cfg, seed, device)
    phase("weights")
    traffic = Traffic(config["model"], params, seed, device)
    phase("traffic")
    entry = entry_class(params)(cfg, state_dict, traffic, params, device)
    del state_dict
    phase("engine")
    if cuda:  # the weights are on the card: the window's peak counts from here
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    warm = traffic.scene(int(params["vehicles"]), 0)[:WARM_FRAMES]
    if calibrate:
        entry.calibrate(warm, calibrate)
    entry.warm_up(warm)
    # what set-up made stays out of the collector's later passes
    gc.collect()
    gc.freeze()
    phase("warm_up")
    keep = fam.sample(seed, params)

    setup_s = clock()
    t_end = time.perf_counter() + seconds
    run = entry.run(t_end, keep, lambda name: contextlib.nullcontext())
    if cuda:
        torch.cuda.synchronize()
    kept, done = dict(run.kept), [f.key for f in run.frames if f.done <= t_end]
    attempted, failed, traced_frames = run.attempted, run.failed, 0
    t_done = time.perf_counter()
    if traced:
        with trace.module_ranges(entry.model), trace.profiler() as prof:
            with trace.span("window"):
                t_traced = time.perf_counter() + min(seconds, TRACED_SECONDS)
                more = entry.run(t_traced, keep, trace.span)
                if cuda:
                    torch.cuda.synchronize()
        kept.update(more.kept)
        done += [f.key for f in more.frames]
        attempted, failed = attempted + more.attempted, failed + more.failed
        traced_frames = len(more.frames)
        t_done = time.perf_counter()
    summary = trace.summarize(prof) if traced else {}
    t_summary = time.perf_counter()
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    memory_peak = max(setup_peak, window_peak) if cuda else 0
    del entry
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    window_frames = [f for f in run.frames if f.done <= t_end]
    numbers, compared = fam.compare(config, seed, traffic, kept, done, device)
    after = {"trace_summary": t_summary - t_done, "check": time.perf_counter() - t_summary}
    limits = cell.limits or {}
    correct = (compared > 0 and failed == 0 and bool(limits)
               and all(numbers[k] <= limits[k] for k in fam.NUMBERS))
    checks = {k: {"value": finite(numbers[k]), "limit": limits.get(k)} for k in fam.NUMBERS}

    if traced:
        ctx = types.SimpleNamespace(
            run=run, window_frames=window_frames, traced_frames=traced_frames,
            seconds=seconds, trace=summary, config=config, model=config["model"],
            params=params, window_peak_bytes=window_peak, **fam.metric_context(config))
        metrics = {}
        for spec in cell.per_layer:
            value = reader(cell.root, spec["name"])(ctx)
            if value is not None:
                metrics[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    else:
        values = end_to_end(window_frames, seconds, setup_s)
        metrics = {spec["name"]: {"value": float(values[spec["name"]]), "unit": spec["unit"]}
                   for spec in cell.end_to_end
                   if "workloads" not in spec or cell.name in spec["workloads"]}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": int(memory_peak)}}
    if traced and summary:
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = summary["breakdown"]
        result["trace_attribution"] = {k: summary[k] for k in ("device_s", "unlinked_s")}
    lat = [f.done - f.start for f in window_frames]
    if lat:
        result["latency_ms"] = {f"p{q}": 1e3 * float(np.percentile(lat, q))
                                for q in (50, 90, 95, 99, 100)}
    result["phases_s"] = {**phases, **after}
    result["frames_checked"] = compared
    result["checks"] = checks
    return result


def loaded_forbidden() -> list:
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"))
    found = loaded_forbidden()
    if found:
        print(f"portbench: the process holds {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"frames checked: {result['frames_checked']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
