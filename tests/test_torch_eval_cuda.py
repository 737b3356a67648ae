"""The evaluator's card paths: the pinned readback and one micro evaluation
through the loader on the card.

Marked `cuda`: each test skips without a CUDA device.  On a machine with a
card (which need not have JAX) run them with

    python -m pytest tests/test_torch_eval_cuda.py -m cuda --noconftest -q
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu_torch import ops
from bevformer_tensorrt_tpu_torch.configs.bevformer import bevformer_micro
from bevformer_tensorrt_tpu_torch.runtime.engine import BEVFormerEngine
from bevformer_tensorrt_tpu_torch.runtime.synthetic import synthetic_frames
from bevformer_tensorrt_tpu_torch.tools import evaluate

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_pinned_readback_equals_cpu_copy(cuda):
    engine = BEVFormerEngine(bevformer_micro(), device=cuda)
    frames = synthetic_frames(engine.cfg, np.random.default_rng(0), ["a", "a"])
    for f in frames:
        classes, coords = engine.infer_frame(**f)
        readback = engine.readback(classes, coords)
        host = readback.result()
        assert all(t.device.type == "cpu" and t.is_pinned() for t in host)
        for got, want in zip(host, (classes, coords)):
            assert got.dtype == want.dtype and torch.equal(got, want.cpu())
    ints = torch.arange(1000, device=cuda, dtype=torch.int32)
    assert torch.equal(engine.readback(ints).result()[0], ints.cpu())


def test_micro_evaluation_on_the_card(cuda, tmp_path):
    root = tmp_path / "set"
    subprocess.run([sys.executable, str(REPO / "tools/make_synthetic_nuscenes.py"), str(root),
                    "--frames", "4", "--cams", "2", "--width", "160", "--height", "96"],
                   check=True, capture_output=True, timeout=120)
    ops.reset_launch_counts()
    res = evaluate.main(["micro", "--infos", str(root / "nuscenes_infos_synthetic.pkl"),
                         "--data-root", str(root)])
    assert res.engine.device.type == "cuda"
    # per frame: TSA and SCA in each of 2 encoder layers, 2 decoder layers
    assert ops.multi_scale_deformable_attn.launches == 4 * 6
    assert ops.flash_attention.launches == 4 * 2
    assert all(np.isfinite(v) for v in res.metrics.values())
    serial = evaluate.eval_loop(res.engine, res.frames, res.indices, pipelined=False)
    for got, want in zip(res.run.detections, serial.detections):
        for k in got:
            assert np.array_equal(got[k], want[k]), k
