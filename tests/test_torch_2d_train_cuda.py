"""2D training on the card: the micro step of each family (the train CLI's
`loss_fn`; CenterNet micro with its DCNv2 neck, so the DCN's im2col kernel
runs forward and the plain version's VJP backward) on the card against the
CPU's from the same weights and batch, and SimOTA's tie rules on the card.

Marked `cuda`: each such test skips without a CUDA device.  On a machine
with a card (which need not have JAX) run them with

    python -m pytest tests/test_torch_2d_train_cuda.py -m cuda --noconftest -q

YOLOX's assignment on the card must be the CPU's.  It may differ only where
a GT's dynamic k (its top-10 candidate IoUs summed, then truncated) lies
within float32 rounding of an integer: then the card's step is held with the
CPU's assignment replayed (`loss_fn(..., assigned=...)`), the difference
recorded, and the bars stay as they are.
"""
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu_torch.configs.centernet import centernet_micro
from bevformer_tensorrt_tpu_torch.configs.yolox import yolox_micro
from bevformer_tensorrt_tpu_torch.models.detectors.centernet import CenterNet
from bevformer_tensorrt_tpu_torch.models.detectors.yolox import YOLOX
from bevformer_tensorrt_tpu_torch.ops import reset_launch_counts
from bevformer_tensorrt_tpu_torch.ops.dcn import deform_im2col
from bevformer_tensorrt_tpu_torch.tools.det2d import train
from bevformer_tensorrt_tpu_torch.weights import init_weights

FAMILIES = {"yolox": (YOLOX, yolox_micro), "centernet": (CenterNet,
                                                         lambda: centernet_micro(use_dcn=True))}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _batch(size, rng):
    """Four images and their GT padded to the CLI's 64 rows."""
    image = rng.standard_normal((4, 3, size, size)).astype(np.float32)
    gbs, gls = [], []
    for _ in range(4):
        xy = rng.uniform(0, size - 24, (6, 2))
        boxes = np.concatenate([xy, np.minimum(xy + rng.uniform(8, 40, (6, 2)), size)], -1)
        gb, gl = train.pad_gt(boxes.astype(np.float32), rng.integers(0, 80, 6))
        gbs.append(gb)
        gls.append(gl)
    return {"image": image, "gt_boxes": np.stack(gbs), "gt_labels": np.stack(gls)}


def _step(model, batch, device, assigned=None):
    """(metrics on the CPU, gradients on the CPU, assignment on the CPU)."""
    model = model.to(device).train()
    b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    if assigned is not None:
        assigned = [tuple(t.to(device) for t in a) for a in assigned]
    model.zero_grad(set_to_none=True)
    m = train.loss_fn(model, b, assigned)
    m["loss"].backward()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None}
    assign = [tuple(t.cpu() for t in a) for a in m.pop("assigned", [])]
    return {k: float(v.detach()) for k, v in m.items()}, grads, assign


def _rel_l2(a, b):
    num = sum(float((a[k] - b[k]).norm() ** 2) for k in b)
    return (num / sum(float(b[k].norm() ** 2) for k in b)) ** 0.5


def step_on_the_card(fam, device):
    """The micro step on the CPU and on `device` from one seed: both
    metrics, whether the assignment agreed, and the gradients' relative L2
    distance (with the CPU's assignment replayed on the card where it did
    not agree), and the im2col launches of the card's step."""
    cls, cfg_fn = FAMILIES[fam]
    cfg = cfg_fn()
    batch = _batch(cfg.img_size, np.random.default_rng(4))
    model = init_weights(cls(cfg), torch.Generator().manual_seed(0))
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    cpu_m, cpu_g, cpu_a = _step(model, batch, "cpu")
    model.load_state_dict(start)
    reset_launch_counts()
    card_m, card_g, card_a = _step(model, batch, device)
    launches = deform_im2col.launches
    same = all(torch.equal(x, y) for a, b in zip(card_a, cpu_a) for x, y in zip(a, b))
    if not same:
        model.load_state_dict(start)
        card_m, card_g, _ = _step(model, batch, device, assigned=cpu_a)
    return dict(cpu_metrics=cpu_m, card_metrics=card_m, same_assignment=same,
                grad_rel_l2=_rel_l2(card_g, cpu_g), im2col_launches=launches, grads=len(cpu_g))


@pytest.mark.cuda
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_micro_step_on_the_card_matches_the_cpu(fam, cuda):
    """Each loss term within 1e-5 relative of the CPU's, num_pos equal, the
    gradients within 1e-4 in the relative L2 norm over all parameters;
    CenterNet's three DCN blocks launch the im2col kernel once each."""
    r = step_on_the_card(fam, cuda)
    for k, v in r["cpu_metrics"].items():
        assert abs(r["card_metrics"][k] - v) <= 1e-5 * abs(v), (k, r["card_metrics"][k], v)
    assert r["grad_rel_l2"] <= 1e-4, r["grad_rel_l2"]
    assert r["im2col_launches"] == (3 if fam == "centernet" else 0)


@pytest.mark.cuda
def test_simota_tie_rules_on_the_card(cuda):
    """What SimOTA relies on, on the card: a stable argsort keeps equal
    costs (the 1e8 plateau) in prior order, its inverse permutation by
    scatter is the CPU's, and argmin keeps the first of equal values."""
    rng = np.random.default_rng(0)
    cost = torch.from_numpy(np.float32(1e8)
                            + 8 * rng.integers(0, 3, (8400, 64)).astype(np.float32))
    for dev in ("cpu", cuda):
        order = torch.argsort(cost.to(dev), dim=0, stable=True).cpu()
        for g in range(64):
            col = cost[:, g]
            assert torch.equal(order[:, g], torch.from_numpy(
                np.argsort(col.numpy(), kind="stable")))
        ranks = torch.arange(8400)[:, None].expand(8400, 64)
        rank = torch.empty_like(order).scatter_(0, order, ranks)
        assert torch.equal(torch.gather(rank, 0, order), ranks)
        first = torch.argmin(cost.to(dev), dim=1).cpu()
        assert torch.equal(first, torch.from_numpy(np.argmin(cost.numpy(), axis=1)))


if __name__ == "__main__":
    # One JSON line per family with the card's name and power limit.
    #   PYTHONPATH=. python tests/test_torch_2d_train_cuda.py
    import json
    import subprocess

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    for fam in FAMILIES:
        r = step_on_the_card(fam, torch.device("cuda"))
        print(json.dumps(dict(card=card, family=fam, **r)))
