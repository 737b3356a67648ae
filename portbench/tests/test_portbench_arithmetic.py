"""The yardstick's arithmetic on hand-made numbers: the end-to-end metrics of
a window and the stream's frame tail, the busy union of device intervals, and the roofline bounds."""
from __future__ import annotations

import json
import types
from pathlib import Path

import pytest

from portbench import roofline, run, trace
from portbench.record import Frame

ROOT = Path(__file__).resolve().parents[2]
frame_p95_ms = run.reader(ROOT, "engine.frame_p95_ms")


def p95(window_frames):
    return frame_p95_ms(types.SimpleNamespace(window_frames=window_frames))


def frames(latencies_ms, period_s=0.1):
    return [Frame((0, 0, i), i * period_s, i * period_s + ms / 1e3)
            for i, ms in enumerate(latencies_ms)]


def test_fps_and_p95_over_a_window():
    window = frames([50.0] * 100)
    assert run.end_to_end(window, 10.0, 3.5) == {"setup_s": 3.5, "fps": 10.0}
    assert p95(window) == pytest.approx(50.0)
    assert p95([]) is None


def test_one_stalled_frame_moves_both():
    """A closed loop of 50 ms frames over a 1.4 s window: one frame stalled
    by 0.5 s delays every later frame, so fewer frames reach the host in the
    window, and with fewer than 20 frames the stall lies in the top 5%."""
    def loop(stall_at):
        out, t = [], 0.0
        for i in range(40):
            ms = 500.0 if i == stall_at else 50.0
            out.append(Frame((0, 0, i), t, t + ms / 1e3))
            t += ms / 1e3
        return [f for f in out if f.done <= 1.4 + 1e-9]
    a = run.end_to_end(loop(None), 1.4, 1.0)
    b = run.end_to_end(loop(5), 1.4, 1.0)
    assert a["fps"] == pytest.approx(28 / 1.4) and b["fps"] == pytest.approx(19 / 1.4)
    assert p95(loop(None)) == pytest.approx(50.0)
    assert p95(loop(5)) == pytest.approx(50.0 + 0.1 * 450.0)


def test_p95_is_over_all_frames():
    lat = [10.0] * 95 + [100.0] * 5
    assert p95(frames(lat)) == pytest.approx(10.0 + 0.05 * 90.0)


@pytest.mark.parametrize("intervals, busy, gaps", [
    ([(0, 10), (5, 20), (30, 40)], 30, [(20, 30)]),
    ([(0, 10), (2, 3), (10, 12)], 12, []),
    ([(0, 5), (6, 7), (8, 9)], 7, [(5, 6), (7, 8)]),
])
def test_busy_union_and_gaps(intervals, busy, gaps):
    covered, got = trace._union(sorted(intervals))
    assert covered == busy and got == gaps
    window = 40
    assert 100.0 * (1 - covered / window) == pytest.approx(100.0 * (window - busy) / window)


def base_model():
    return json.loads((ROOT / "portbench/configs/bevformer_base-bf16.json").read_text())["model"]


def test_msda_bound_matches_the_kernel_table():
    """PERF.md's base MSDA bound, 1.34 ms a float32 frame, from the
    configuration's shapes with the compaction's 14080 queries a camera."""
    assert roofline.msda_frame_s(base_model(), [14080] * 6, "float32") * 1e3 == pytest.approx(
        1.342, abs=5e-4)


def test_dcn_bound_matches_the_kernel_table():
    """PERF.md's base DCN bound, 1.08 ms a bfloat16 frame (23 + 3 launches,
    each bound by its operations: 41.5 us)."""
    m = base_model()
    assert roofline.dcn_frame_s(m, "bfloat16") * 1e3 == pytest.approx(1.079, abs=5e-4)
    one = roofline.bound_s(*roofline.dcn_op_work(6, 256, 58, 100, 256, 1, 2), "bfloat16")
    assert one * 1e6 == pytest.approx(41.5, abs=0.05)


def test_level_shapes():
    assert roofline.level_shapes(base_model()) == [(116, 200), (58, 100), (29, 50), (15, 25)]
    one_level = dict(base_model(), img_h=736, img_w=1280, num_levels=1, backbone_out_indices=[3])
    assert roofline.level_shapes(one_level) == [(23, 40)]  # BEVFormer-small's
