"""Data- and tensor-parallel training and data-parallel serving of the port
on the CPU, in one world of four gloo processes (`torch_parallel_workers.py`,
dp2 x tp2): the micro train step (the JAX dryrun's dp x tp step) against the
one-process step on the global batch, the QDQ tier's forward under tensor
parallelism (the row-parallel layers' weight scales reduced over tp), and the
serving engine's lanes split over dp against the one-process engine."""
import pytest

from torch_parallel_workers import run_world

WORLD = 4
GRAD_REL_L2 = 1e-4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(["train_step_tp", "serving_dp"], WORLD, tmp_path_factory.mktemp("train"))


def test_train_step_loss(world):
    """The dp x tp step's loss within 1e-5 of the one-process step's, with
    the positive count summed over dp; every rank reports the global loss."""
    res = world["train_step_tp"]
    assert res[0]["loss"] < 1e-5, res[0]["loss"]
    assert res[0]["num_pos"][0] == res[0]["num_pos"][1] == 7 * 2  # 4 + 3 GT x 2 levels
    assert len({r["loss_here"] for r in res}) == 1
    assert all(r["n_sharded"] == 2 * 9 + 2 * 13 for r in res)


@pytest.mark.parametrize("part", ["img_backbone.", "img_neck.", "pts_bbox_head.transformer.",
                                  "pts_bbox_head.cls_branch", "pts_bbox_head.reg_branch"])
def test_train_step_gradients(world, part):
    """Every parameter's clipped gradient (the tp shards all-gathered)
    within 1e-4 relative L2 of the one-process gradient: the dp sum,
    Megatron's f and g, the heads taken from the whole offsets, and the
    global norm over the shards all hold."""
    res = world["train_step_tp"][0]
    errs = {n: e for n, e in res["grad_rel_l2"].items() if n.startswith(part)}
    assert errs
    bad = {n: e for n, e in errs.items() if not e < GRAD_REL_L2}
    assert not bad, bad
    assert len(res["grad_rel_l2"]) + len(res["zero_grad"]) == 313
    assert res["zero_grad"] and max(res["zero_grad"].values()) < 1e-5
    assert res["params_moved"] < 1e-5


@pytest.mark.parametrize("name", ["bev", "classes", "coords"])
def test_qdq_forward_under_tp(world, name):
    """quant=True (weights fake-quantized per output channel from the live
    weight; a row-parallel slice takes the row's amax over tp) at tp 2
    against one process."""
    res = world["train_step_tp"][0]
    assert res["qdq"][name] < 1e-4, res["qdq"][name]


def test_serving_dp_matches_one_process(world):
    """Every step of the dp engine returns what the one-process engine
    returns, and the pools agree: each rank ran half the lanes."""
    res = world["serving_dp"]
    assert res[0]["steps"] == [2, 2] and all(r["steps"] == [2] for r in res[1:])
    assert res[0]["max_err"] < 1e-5 and res[0]["pool"] < 1e-5, res[0]
    assert [r["lanes"] for r in res] == [(0, 2), (0, 2), (2, 4), (2, 4)]
