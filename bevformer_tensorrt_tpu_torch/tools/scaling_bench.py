"""Scaling benchmark: the dp x tp train step's throughput over world sizes
(port of `tools/scaling_bench.py`).

    python -m bevformer_tensorrt_tpu_torch.tools.scaling_bench [--worlds 1 2 4 8]
        [--steps 3] [--model micro] [--device cuda|cpu] [--out FILE]

For each world size n the tool starts n processes on one free local port;
each joins the job (`parallel.init_distributed`), lays out
`parallel.make_mesh()` (dp x tp, tensor parallelism first), shards the
transformer, takes one warm-up step and times `--steps` steps of
`train/step.py::train_step` on its dp share of a seeded batch of dp frames.
Rank 0 reports the JAX tool's fields: `sec_per_step`, `frames_per_sec`,
`mesh`, and `efficiency_vs_1`.

Where the machine has at least n cards, rank r takes `cuda:r` with NCCL.
Where it has fewer, the ranks share the cards over gloo (`shared_card`
true beside the number): the ranks then take turns on one device and the
number says nothing about scaling.  On `--device cpu` the ranks are gloo
processes on the host.  World sizes the machine cannot hold as processes
are still run: the tool reports what it measured, and what it ran on.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(module: str, n: int, argv, timeout: float = 1800.0) -> None:
    """Run `python -m module argv` as ranks 0..n-1 of one job on a free
    local port (torchrun's variables); raise if a rank fails."""
    port = free_port()
    root = str(Path(__file__).resolve().parents[2])  # the package's parent directory
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *argv],
        env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), PYTHONPATH=path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"{module} rank {r} of {n} exited {p.returncode}:\n{out[-3000:]}")


def join(device: str, dp=None, tp=None):
    """(device, mesh, shared): this rank's device and its mesh
    (`make_mesh(dp, tp)`); the ranks share cards over gloo where the world
    outnumbers them, and host ranks split the cores."""
    from ..parallel import init_distributed, make_mesh

    n = int(os.environ["WORLD_SIZE"])
    shared = device == "cuda" and n > torch.cuda.device_count()
    if shared:
        os.environ["LOCAL_RANK"] = str(int(os.environ["RANK"]) % torch.cuda.device_count())
    if device == "cpu":  # OMP_NUM_THREADS, where set, wins
        torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", 0))
                              or max(1, (os.cpu_count() or 1) // n))
    dev, _, _ = init_distributed(device, backend="gloo" if shared else None)
    return dev, make_mesh(dp=dp, tp=tp), shared


def train_setup(model: str, dev, mesh, seed: int = 0):
    """The sharded model, its optimizer and this rank's share of a seeded
    batch of dp frames with GT."""
    from ..configs import bevformer as configs
    from ..models.detectors.bevformer import BEVFormer
    from ..parallel import shard_parameters
    from ..parallel.mesh import batch_sharding
    from ..runtime.synthetic import camera_rig
    from ..train import Optimizer
    from ..weights import init_weights

    cfg = getattr(configs, f"bevformer_{model}")()
    net = init_weights(BEVFormer(cfg), torch.Generator().manual_seed(seed)).to(dev).train()
    specs = shard_parameters(net, mesh)
    opt = Optimizer(net, mesh=mesh, specs=specs, total_steps=None)
    dp, G = mesh.axis_size("dp"), 8
    rng = np.random.default_rng(seed)
    boxes = np.zeros((dp, G, 9), np.float32)
    boxes[..., :2] = rng.uniform(-20, 20, (dp, G, 2))
    boxes[..., 3:6] = rng.uniform(1, 4, (dp, G, 3))
    labels = rng.integers(0, cfg.num_classes, (dp, G))
    labels[:, G // 2:] = -1
    rig = camera_rig(cfg.num_cams, cfg.img_h, cfg.img_w, rng)
    batch = {"image": rng.standard_normal((dp, cfg.num_cams, 3, cfg.img_h, cfg.img_w)),
             "can_bus": np.zeros((dp, cfg.can_bus_dims)), "lidar2img": np.stack([rig] * dp),
             "gt_boxes": boxes, "gt_labels": labels}
    mine = batch_sharding(mesh, dp)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[mine])).to(
        dev, torch.int64 if k == "gt_labels" else torch.float32) for k, v in batch.items()}
    return net, opt, batch


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rank_main(args) -> None:
    import torch.distributed as dist

    from ..train import train_step

    dev, mesh, shared = join(args.device)
    net, opt, batch = train_setup(args.model, dev, mesh)
    train_step(net, opt, batch, mesh)  # warm-up: kernels loaded, buffers made
    _sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        m = train_step(net, opt, batch, mesh)
    float(m["loss"])
    _sync(dev)
    dt = (time.perf_counter() - t0) / args.steps
    dp = mesh.axis_size("dp")
    if mesh.rank == 0:
        Path(args.result).write_text(json.dumps({
            "sec_per_step": dt, "frames_per_sec": dp / dt, "mesh": mesh.describe(),
            "backend": mesh.backend, "device": str(dev), "shared_card": shared,
            "loss": float(m["loss"])}))
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worlds", type=int, nargs="*", default=[1, 2, 4, 8])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--model", default="micro", choices=("micro", "tiny", "small", "base"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--result", default=None, help=argparse.SUPPRESS)  # a rank's result file
    args = ap.parse_args(argv)
    if args.result:
        return rank_main(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("scaling_bench: no CUDA device (use --device cpu)")
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for n in args.worlds:
            res = Path(tmp) / f"world{n}.json"
            spawn("bevformer_tensorrt_tpu_torch.tools.scaling_bench", n,
                  ["--steps", str(args.steps), "--model", args.model, "--device", args.device,
                   "--result", str(res)])
            r = results[n] = json.loads(res.read_text())
            note = " (ranks share the card: not a scaling figure)" if r["shared_card"] else ""
            print(f"n={n} ({r['mesh']}, {r['backend']} on {r['device']}): "
                  f"{r['sec_per_step'] * 1e3:.1f} ms/step, {r['frames_per_sec']:.2f} frames/s"
                  + note, file=sys.stderr)
    base = min(results)
    for n, r in results.items():
        r["efficiency_vs_1"] = (r["frames_per_sec"] / results[base]["frames_per_sec"]) * (base / n)
    line = json.dumps(results)
    if args.out:
        Path(args.out).write_text(line)
    print(line)
    return results


if __name__ == "__main__":
    main()
