"""The benchmark is driven by data: every cell's files are found by name,
an unknown name fails clearly, and the configuration files hold the sizes
the program's factories give."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(workload):
    cell = run.load_cell(workload)
    assert cell.config["model"]["embed_dims"] > 0
    assert (ROOT / "portbench" / "entries" / f"{cell.params['entry']}.py").is_file()
    assert set(cell.limits) == {"bev_rel", "classes_max", "coords_max"}
    assert cell.per_layer, "every cell reports a per-layer metric"
    for spec in cell.per_layer:
        assert callable(run.reader(ROOT, spec["name"]))


def test_family_module_outside_the_benchmark_is_refused():
    with pytest.raises(SystemExit, match="not under portbench/families/"):
        run.family({"family_module": "os"})


def test_unknown_workload_fails_clearly():
    with pytest.raises(SystemExit, match="no workload 'nope'"):
        run.load_cell("nope")


def test_missing_file_is_named(tmp_path):
    bench = dict(BENCH, workloads=[dict(BENCH["workloads"][0], traffic="absent")])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    config = BENCH["workloads"][0]["config"]
    (tmp_path / "portbench" / "configs" / f"{config}.json").write_text(
        (ROOT / "portbench" / "configs" / f"{config}.json").read_text())
    with pytest.raises(SystemExit, match="no traffic file portbench/traffic/absent.json"):
        run.load_cell(bench["workloads"][0]["name"], root=tmp_path)


@pytest.mark.parametrize("config", sorted(p.stem for p in (ROOT / "portbench" / "configs").glob(
    "*.json")))
def test_config_file_holds_the_program_sizes(config):
    """The reference reads the sizes of the file's "model" section; the
    program is built by the file's factory: they must describe one model.
    A configuration in `BENCHMARK.json` names its file and what was cut."""
    doc = json.loads((ROOT / "portbench" / "configs" / f"{config}.json").read_text())
    cfg = dataclasses.asdict(run.program_config(doc, {}))
    for key, value in doc["model"].items():
        got = cfg[key]
        assert (list(got) if isinstance(got, tuple) else got) == value, key
    for entry in (c for c in BENCH["configs"] if c["name"] == config):
        assert entry["file"] == f"portbench/configs/{config}.json"
        assert entry["reduced"] == doc["reduced"] == []


def test_benchmark_names_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= cells
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
