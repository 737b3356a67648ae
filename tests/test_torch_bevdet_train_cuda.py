"""BEVDet training on the card: the micro train step's loss and gradients
(the train CLI's `loss_fn`) on the card against the CPU's from the same
weights and batch, and the splats' gradients on the card against the
CPU's.

Marked `cuda`: each such test skips without a CUDA device.  On a machine
with a card (which need not have JAX) run them with

    python -m pytest tests/test_torch_bevdet_train_cuda.py -m cuda --noconftest -q

The step is held with every ReLU on the CPU's branch (`relu_calls`): the
seeded micro step has one input of a ReLU within float32 rounding of zero
(the CenterHead's shared layer, `models/heads/centerpoint_head.py:53`:
1.5e-8 against an rms of 0.11, the next smallest 4.4e-5) beside a GT
centre, where the code-weighted L1's gradient (a sign, whatever the input's
size) is concentrated.  Which side of the kink that input falls on depends
on the summation order (the CPU's thread count, cuDNN's algorithm, a 1e-7
change of the image), and the side decides 3.8% of the gradient in the
relative L2 norm.  `test_relu_replay_on_the_cpu` runs the same mechanism on
the CPU.
"""
import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bevformer_tensorrt_tpu_torch.configs.bevdet import bevdet_micro
from bevformer_tensorrt_tpu_torch.models.detectors.bevdet import BEVDet
from bevformer_tensorrt_tpu_torch.models.necks.view_transformer import (
    get_lidar_coor,
    voxel_pooling_prepare,
)
from bevformer_tensorrt_tpu_torch.ops.bev_pool import bev_pool_v2
from bevformer_tensorrt_tpu_torch.runtime.synthetic import bevdet_rig
from bevformer_tensorrt_tpu_torch.tools.bevdet import train
from bevformer_tensorrt_tpu_torch.weights import init_weights

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(cfg):
    rng = np.random.default_rng(0)
    s2e, intr = bevdet_rig(cfg.num_cams, cfg.input_h, cfg.input_w, rng)
    r = voxel_pooling_prepare(cfg, get_lidar_coor(cfg, s2e, intr), pad_to=600,
                              pad_intervals_to=cfg.bev_h * cfg.bev_w)
    ranks = (r.ranks_depth, r.ranks_feat, r.ranks_bev, r.interval_starts, r.interval_lengths)
    boxes = np.zeros((64, 9), np.float32)
    boxes[:5, :2] = rng.uniform(-7, 7, (5, 2))
    boxes[:5, 3:6] = rng.uniform(0.5, 3, (5, 3))
    labels = np.full(64, -1, np.int64)
    labels[:5] = rng.integers(0, 10, 5)
    image = rng.standard_normal((1, cfg.num_cams, 3, cfg.input_h, cfg.input_w)).astype(np.float32)
    return ranks, {"image": image, "gt_boxes": boxes, "gt_labels": labels}


def _loss_and_grads(model, ranks, batch, device):
    model = model.to(device).train()
    rank_args = tuple(torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)
                      for a in ranks)
    b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    model.zero_grad(set_to_none=True)
    m = train.loss_fn(model, rank_args, b)
    m["loss"].backward()
    return float(m["loss"].detach()), {n: p.grad.detach().cpu() for n, p in
                                       model.named_parameters()}


def _rel_l2(a, b):
    num = sum(float((a[k] - b[k]).norm() ** 2) for k in b)
    return (num / sum(float(b[k].norm() ** 2) for k in b)) ** 0.5


@contextlib.contextmanager
def relu_calls(replay=None):
    """Patch `torch.nn.functional.relu`, through which every ReLU of BEVDet
    runs, for the span of the block; yields the list of each call's input
    (detached, on the CPU), in call order.  With `replay` (such a list from
    another run), call i takes the branch that input i of `replay` took: its
    output is x * (replay[i] > 0), whose gradient is that mask."""
    seen, relu = [], F.relu

    def patched(x, inplace=False):
        seen.append(x.detach().cpu())
        if replay is None:
            return relu(x, inplace=inplace)
        return x * (replay[len(seen) - 1] > 0).to(x.device, x.dtype)

    F.relu = patched
    try:
        yield seen
    finally:
        F.relu = relu


# A ReLU input may fall on the other side of zero between two runs only where
# it lies within this fraction of its call's largest magnitude (float32
# rounding through the micro network moves its maps by ~2e-6 relative).
NEAR_KINK = 1e-5


def kink_flips(got, want):
    """The ReLU inputs on another side of zero in `got` (a `relu_calls`
    list) than in `want`: (call, index, want's input, got's input, want's
    largest input in that call) each."""
    assert len(got) == len(want)
    flips = []
    for call, (g, w) in enumerate(zip(got, want)):
        for idx in torch.nonzero((g > 0) != (w > 0)).tolist():
            flips.append((call, idx, float(w[tuple(idx)]), float(g[tuple(idx)]),
                          float(w.abs().max())))
    return flips


def _assert_near_kinks(got, want):
    for flip in kink_flips(got, want):
        assert abs(flip[2]) <= NEAR_KINK * flip[4], flip


def step_on_the_card(device):
    """The micro step from the same seeded weights and batch on the CPU, on
    `device` free-running, and on `device` with every ReLU on the CPU's
    branch: the losses, the relative L2 distance of the free and of the
    replayed gradients from the CPU's, and both runs' `relu_calls`."""
    cfg = bevdet_micro()
    ranks, batch = _case(cfg)
    model = init_weights(BEVDet(cfg), torch.Generator().manual_seed(0))
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with relu_calls() as cpu_relu:
        cpu_loss, cpu = _loss_and_grads(model, ranks, batch, "cpu")
    with relu_calls() as card_relu:
        card_loss, free = _loss_and_grads(model, ranks, batch, device)
    model.load_state_dict(start)
    with relu_calls(replay=cpu_relu):
        _, replayed = _loss_and_grads(model, ranks, batch, device)
    return dict(cpu_loss=cpu_loss, card_loss=card_loss, free=_rel_l2(free, cpu),
                replayed=_rel_l2(replayed, cpu), cpu_relu=cpu_relu, card_relu=card_relu)


@pytest.mark.cuda
def test_bevdet_step_on_the_card_matches_the_cpu(cuda):
    """The micro step on the card against the CPU's from the same seeded
    weights and batch: the loss within 1e-5 relative; every ReLU input that
    falls on another side of zero within NEAR_KINK of it; and, with every
    ReLU on the CPU's branch, the gradients within 1e-4 in the relative L2
    norm over all parameters (the float32 bar of the step's other tests)."""
    r = step_on_the_card(cuda)
    _assert_near_kinks(r["card_relu"], r["cpu_relu"])
    assert abs(r["card_loss"] - r["cpu_loss"]) <= 1e-5 * abs(r["cpu_loss"])
    assert r["replayed"] <= 1e-4


def test_relu_replay_on_the_cpu():
    """The mechanism of the card test on the CPU: a 1e-7 relative change of
    the image moves ReLU inputs across zero only within NEAR_KINK of it, and
    with the clean step's ReLU branches replayed the changed step's
    gradients are the clean step's within 1e-4 in the relative L2 norm
    (free-running, on an 8-thread CPU, the one input of the CenterHead's
    shared layer flips and they part by 3.8%)."""
    cfg = bevdet_micro()
    ranks, batch = _case(cfg)
    model = init_weights(BEVDet(cfg), torch.Generator().manual_seed(0))
    noisy = dict(batch)
    noise = np.random.default_rng(1).standard_normal(batch["image"].shape)
    noisy["image"] = (batch["image"] * (1 + 1e-7 * noise)).astype(np.float32)
    with relu_calls() as clean_relu:
        _, clean = _loss_and_grads(model, ranks, batch, "cpu")
    with relu_calls() as noisy_relu:
        _loss_and_grads(model, ranks, noisy, "cpu")
    _assert_near_kinks(noisy_relu, clean_relu)
    with relu_calls(replay=clean_relu):
        _, replayed = _loss_and_grads(model, ranks, noisy, "cpu")
    assert _rel_l2(replayed, clean) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["interval", "scatter"])
def test_splat_gradients_on_the_card(impl, cuda):
    """Both splats' gradients to depth and features on the card against the
    CPU's, within 1e-5 of their largest magnitude."""
    cfg = bevdet_micro()
    ranks, _ = _case(cfg)
    ranks = ranks if impl == "interval" else ranks[:3]
    rng = np.random.default_rng(1)
    depth = rng.random((cfg.num_cams, cfg.depth_bins, cfg.feat_h, cfg.feat_w)).astype(np.float32)
    feat = rng.standard_normal((cfg.num_cams, cfg.feat_h, cfg.feat_w, 8)).astype(np.float32)
    cot = rng.standard_normal((1, cfg.bev_h, cfg.bev_w, 8)).astype(np.float32)
    grads = []
    for dev in ("cpu", cuda):
        d, f = (torch.from_numpy(a).to(dev).requires_grad_() for a in (depth, feat))
        out = bev_pool_v2(d, f, *(torch.from_numpy(np.asarray(a)).to(dev) for a in ranks),
                          out_height=cfg.bev_h, out_width=cfg.bev_w, impl=impl)
        out.backward(torch.from_numpy(cot).to(dev))
        grads.append((d.grad.cpu(), f.grad.cpu()))
    for a, b in zip(grads[1], grads[0]):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


if __name__ == "__main__":
    # The card against the CPU at the CPU's default thread count and at one
    # thread: one JSON line each, with the card's name and power limit.
    #   PYTHONPATH=. python tests/test_torch_bevdet_train_cuda.py
    import json
    import subprocess

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    for threads in (torch.get_num_threads(), 1):
        torch.set_num_threads(threads)
        r = step_on_the_card(torch.device("cuda"))
        print(json.dumps(dict(card=card, cpu_threads=threads, cpu_loss=r["cpu_loss"],
                              card_loss=r["card_loss"], free_rel_l2=r["free"],
                              replayed_rel_l2=r["replayed"], relu_calls=len(r["cpu_relu"]),
                              flips=kink_flips(r["card_relu"], r["cpu_relu"]))))
