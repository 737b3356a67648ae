"""The port's scaling tools on the CPU: `tools/scaling_analysis.py` counts
the collectives of one dp2 x tp2 micro train step exactly (they follow from
the model's structure), and `tools/scaling_bench.py` times the step at world
sizes 1 and 2 and reports the JAX tool's fields."""
import pytest
import torch

from bevformer_tensorrt_tpu_torch.configs.bevformer import bevformer_micro
from bevformer_tensorrt_tpu_torch.models.detectors.bevformer import BEVFormer
from bevformer_tensorrt_tpu_torch.parallel import make_mesh, shard_parameters
from bevformer_tensorrt_tpu_torch.tools import scaling_analysis, scaling_bench


@pytest.fixture(scope="module")
def analysis():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # the ranks share the test machine's cores
        return scaling_analysis.main(["--dp", "2", "--tp", "2"])


def test_collective_counts_follow_the_model(analysis):
    """Per step at micro (2 + 2 layers): one g a tensor-parallel block in the
    forward (3 a layer), one f a whole input that gets a gradient in the
    backward (3 an encoder layer, 6 a decoder layer: q, k, v, the value
    projection, the reference points, fc1), and the norm's sum over tp; over
    dp the positive count, the metrics and one all-reduce of this rank's
    gradients (its shards and the replicated parameters); over tp the
    all-gathers of the offset and weight gradients the heads were taken
    from (2 a deformable module: 2 in each encoder layer, 1 a decoder
    layer)."""
    by = {(c["kind"], c["axis"]): c for c in analysis["collectives"]}
    assert by[("all_reduce", "tp")]["count"] == 4 * 3 + 2 * 3 + 2 * 6 + 1
    model = BEVFormer(bevformer_micro())
    shard_parameters(model, make_mesh(dp=2, tp=2, world_size=4, rank=0))
    n_local = sum(p.numel() for p in model.parameters())
    assert by[("all_reduce", "dp")]["count"] == 3
    assert by[("all_reduce", "dp")]["bytes"] == 4 * n_local + 4 + 2 * 4
    assert by[("all_gather", "tp")]["count"] == 2 * 2 * 3
    assert analysis["mesh"] == "dp2xtp2"
    ring = analysis["ring_model"]
    assert ring["t_dp_s"] > 0 and ring["t_tp_s"] > 0
    assert ring["assumptions"]["tp_bw_Bps"] == scaling_analysis.TP_BW


def test_ring_model():
    assert scaling_analysis.ring_time("all_reduce", 100.0, 4, 10.0) == 2 * 100 * 3 / 4 / 10
    assert scaling_analysis.ring_time("all_gather", 100.0, 4, 10.0) == 100 * 3 / 4 / 10
    assert scaling_analysis.ring_time("all_reduce", 100.0, 1, 10.0) == 0.0


def test_scaling_bench_fields(monkeypatch):
    """One world size (the tp path is scaling_analysis's above): the JAX
    tool's fields."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = scaling_bench.main(["--worlds", "1", "--steps", "1", "--device", "cpu"])
    assert set(res) == {1} and res[1]["mesh"] == "dp1xtp1" and res[1]["backend"] == "gloo"
    r = res[1]
    assert r["sec_per_step"] > 0 and r["frames_per_sec"] > 0 and not r["shared_card"]
    assert torch.isfinite(torch.tensor(r["loss"]))
    assert r["efficiency_vs_1"] == 1.0
