"""The port's host-side tools against the JAX package's: `create_data`
(the infos, exactly), `cam_budget_check` (the visible counts, exactly),
`geometry_analysis` (its numbers within 1e-6), and `samples/` (every script
names a port CLI and only flags its parser accepts; not run)."""
import importlib
import io
import json
import re
import shlex
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

torch.set_num_threads(2)


def same(a, b) -> bool:
    """Deep equality of infos: dicts, lists, numpy arrays (dtype too) and scalars."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(same, a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def test_create_data_infos_equal_jax_and_the_loader_reads_them(tmp_path):
    from PIL import Image

    import create_data as jax_create_data
    from bevformer_tensorrt_tpu.data.nuscenes import extract_gt as jax_extract_gt
    from bevformer_tensorrt_tpu_torch.data.nuscenes import NuScenesFrames, extract_gt
    from bevformer_tensorrt_tpu_torch.tools import create_data
    from test_create_data import make_raw

    make_raw(tmp_path)
    want = jax_create_data.build_infos(tmp_path, "v1.0-mini")
    got = create_data.build_infos(tmp_path, "v1.0-mini")
    assert len(got) == 1 and same(got, want)
    path = create_data.main(["--root", str(tmp_path), "--version", "v1.0-mini"])
    assert path.name == "nuscenes_infos_temporal_mini.pkl"
    Image.fromarray(np.zeros((900, 1600, 3), np.uint8)).save(tmp_path / "cam.jpg")
    frames = NuScenesFrames(path, tmp_path, target_hw=(96, 160))
    f = frames.frame(0)
    boxes, labels = extract_gt(frames.infos[0])
    jboxes, jlabels = jax_extract_gt(want[0])
    np.testing.assert_array_equal(boxes, jboxes)
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_array_equal(f.gt_boxes, boxes)
    assert f.image.shape == (1, 1, 3, 96, 160) and f.lidar2img.shape == (1, 1, 4, 4)


@pytest.mark.parametrize("model", ["tiny", "base"])
def test_cam_budget_counts_equal_jax(model, capsys):
    from cam_budget_check import visible_counts as jax_visible_counts

    from bevformer_tensorrt_tpu.configs import bevformer as jax_cfgs
    from bevformer_tensorrt_tpu_torch.tools import cam_budget_check

    want = jax_visible_counts(getattr(jax_cfgs, f"bevformer_{model}")())
    rec = cam_budget_check.main(["--model", model, "--device", "cpu"])
    assert list(rec["visible"].values()) == [int(c) for c in want]
    assert rec["max"] == int(want.max()) and not rec["over_budget"]


class _Recording:
    """numpy for the JAX tool's module, recording each array whose
    percentiles it prints (the spans of one level)."""

    def __init__(self):
        self.spans = []

    def __getattr__(self, name):
        return getattr(np, name)

    def percentile(self, a, q, *args, **kw):
        if not self.spans or self.spans[-1] is not a:
            self.spans.append(a)
        return np.percentile(a, q, *args, **kw)


def test_geometry_analysis_equals_jax():
    import geometry_analysis as jax_geometry

    from bevformer_tensorrt_tpu_torch.tools import geometry_analysis

    rec_np = _Recording()
    jax_geometry.np = rec_np
    out = io.StringIO()
    try:
        with redirect_stdout(out):
            jax_geometry.main()
    finally:
        jax_geometry.np = np
    text = out.getvalue()
    with redirect_stdout(io.StringIO()):
        rec = geometry_analysis.analyse("cpu")
    assert rec["visible"] == [int(n) for n in re.findall(r"visible queries (\d+)", text)]
    assert f"budget K={rec['K']}" in text
    spans = [row for mode in geometry_analysis.SIGMA_MODES for off in geometry_analysis.JITTERS
             for row in rec["spans"][f"{mode}/{off}"]]
    assert len(spans) == len(rec_np.spans) == 3 * 3 * 4
    for got, s in zip(spans, rec_np.spans):
        want = dict(mean=s.mean(), p50=np.percentile(s, 50), p90=np.percentile(s, 90),
                    p99=np.percentile(s, 99), max=s.max())
        for k, v in want.items():
            assert abs(got[k] - float(v)) <= 1e-6, (k, got[k], v)
    assert json.loads(json.dumps(rec)) == rec


SAMPLES = REPO / "bevformer_tensorrt_tpu_torch" / "samples"


def sample_calls(path: Path):
    """(module, flags) of every `python -m` call in a script."""
    text = path.read_text().replace("\\\n", " ")
    calls = []
    for line in text.splitlines():
        if "python -m" not in line:
            continue
        words = shlex.split(line.split("python -m", 1)[1], comments=True)
        calls.append((words[0], [w for w in words[1:] if w.startswith("--")]))
    return calls


def test_samples_mirror_the_jax_tree():
    want = {p.relative_to(REPO / "samples") for p in (REPO / "samples").rglob("*")
            if p.is_file()} - {Path("dump_hlo.sh")}
    got = {p.relative_to(SAMPLES) for p in SAMPLES.rglob("*") if p.is_file()}
    assert got == want
    assert "dump_hlo.sh" in (SAMPLES / "README.md").read_text()


@pytest.mark.parametrize("script", sorted(str(p.relative_to(SAMPLES))
                                          for p in SAMPLES.rglob("*.sh")))
def test_sample_calls_a_port_cli_with_its_flags(script, capsys):
    calls = sample_calls(SAMPLES / script)
    assert calls, script
    for module, flags in calls:
        if module == "pytest":
            continue
        assert module.startswith("bevformer_tensorrt_tpu_torch.tools."), module
        main = importlib.import_module(module).main
        with pytest.raises(SystemExit):
            main(["--help"])
        ported = capsys.readouterr().out.split("Not ported")[0]
        accepted = set(re.findall(r"(--[a-z0-9-]+)", ported))
        assert set(flags) <= accepted, (script, sorted(set(flags) - accepted))
