"""The port's train and evaluate CLIs under `--distributed` on the CPU: two
gloo ranks against one process, on a generated micro set (4 frames in 2
scenes).  Train: 2 ranks make dp1 x tp2 (`parallel.make_mesh`), whose steps
are the one-process steps, so the saved upstream-layout weights agree.
Evaluate: a scene a rank, the partials merged by rank 0 into the one-process
metrics."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from torch_parallel_workers import REPO, free_port, rel_l2
from torch_port_helpers import SYNTH_INFOS, make_synthetic_set

STEPS = 2


def _comparable(key, t):
    """The upstream tensor without the key projection's bias (the middle
    third of `in_proj_bias`): the softmax ignores it, its gradient is 0 and
    its Adam updates follow float noise (tests/test_torch_train_step.py)."""
    if key.endswith("attn.in_proj_bias"):
        c = t.shape[0] // 3
        return torch.cat([t[:c], t[2 * c:]])
    return t


def _cli(tool, args, rank=None, world=None, port=None):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    if rank is not None:
        env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        args = [*args, "--distributed"]
    return subprocess.Popen([sys.executable, "-m", f"bevformer_tensorrt_tpu_torch.tools.{tool}",
                             "micro", *args, "--device", "cpu"], env=env, cwd=str(REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_cli")
    root = make_synthetic_set(tmp / "set")
    data = ["--infos", str(root / SYNTH_INFOS), "--data-root", str(root)]
    train = [*data, "--steps", str(STEPS), "--log-every", "1", "--no-augment"]
    tport, eport = free_port(), free_port()
    procs = {
        "train_1": _cli("train", [*train, "--out", str(tmp / "one.pth")]),
        **{f"train_2_{r}": _cli("train", [*train, "--out", str(tmp / "two.pth")], r, 2, tport)
           for r in range(2)},
        "eval_1": _cli("evaluate", data),
        **{f"eval_2_{r}": _cli("evaluate", [*data, "--partial-dir", str(tmp / "parts")], r, 2,
                               eport) for r in range(2)},
    }
    outs = {}
    try:
        for name, p in procs.items():
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"{name}: {err[-3000:]}"
            outs[name] = (out, err)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return tmp, outs, eport


def _losses(err):
    return [line.split()[3] for line in err.splitlines() if line.startswith("step ")]


def test_train_two_ranks_log_the_one_process_losses(runs):
    _, outs, _ = runs
    one, two = _losses(outs["train_1"][1]), _losses(outs["train_2_0"][1])
    assert len(one) == STEPS and one == two
    assert _losses(outs["train_2_1"][1]) == []  # rank 0 prints the metrics
    assert "mesh: dp1xtp2 over 2 process(es), gloo" in outs["train_2_0"][1]


def test_train_two_ranks_save_the_one_process_weights(runs):
    """Rank 0 writes the gathered upstream-layout weights: every tensor
    within 1e-5 relative L2 of the one-process run's after the steps."""
    tmp, _, _ = runs
    one, two = torch.load(tmp / "one.pth"), torch.load(tmp / "two.pth")
    assert set(one) == set(two)
    errs = {k: rel_l2(_comparable(k, two[k]), _comparable(k, one[k])) for k in one}
    bad = {k: e for k, e in errs.items() if not e < 1e-5}
    assert not bad, bad


def test_evaluate_two_ranks_merge_the_one_process_metrics(runs):
    """A scene a rank, each rank's partial written under partials_<addr>_<port>,
    rank 0's merged metrics equal to the one-process run's (fps and latency
    aside); rank 1 prints no metrics."""
    tmp, outs, port = runs
    one = json.loads(outs["eval_1"][0].strip().splitlines()[-1])
    two = json.loads(outs["eval_2_0"][0].strip().splitlines()[-1])
    timing = ("fps", "latency_ms")
    assert {k: v for k, v in two.items() if k not in timing} == {
        k: v for k, v in one.items() if k not in timing}
    assert "NDS" in two and "mAP" in two
    assert not any(line.startswith("{") for line in outs["eval_2_1"][0].splitlines())
    pdir = tmp / "parts" / f"partials_127.0.0.1_{port}"
    assert sorted(p.name for p in pdir.iterdir()) == ["eval_partial_0.pkl", "eval_partial_1.pkl"]
