"""What a run loads: no module whose top-level name is `jax`, `jaxlib`,
`flax` or the JAX package (`bevformer_tensorrt_tpu`, compared whole: the
port's name begins with it), and a reference that imports nothing of the
program."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "bevformer_tensorrt_tpu"}


def loaded_top_names(code: str) -> set:
    """Top-level names of every module in sys.modules after `code`, in a
    fresh interpreter at the checkout's root."""
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = loaded_top_names(
        "import json\n"
        "from portbench import run\n"
        "import portbench.entries.engine, portbench.entries.serving\n"
        "for w in json.loads(open('BENCHMARK.json').read())['workloads']:\n"
        "    cell = run.load_cell(w['name'])\n"
        "    [run.reader(run.ROOT, m['name']) for m in cell.per_layer]\n"
        "    run.program_config(cell.config, {})\n"
        "    run.family(cell.config)\n")
    assert "bevformer_tensorrt_tpu_torch" in names  # the program is loaded ...
    assert not names & FORBIDDEN  # ... and nothing of JAX


def test_the_reference_imports_nothing_of_the_program():
    names = loaded_top_names("import portbench.reference.model, portbench.reference.weights, "
                             "portbench.reference.rig")
    assert not names & (FORBIDDEN | {"bevformer_tensorrt_tpu_torch"})
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]} if node.level == 0 else set()
            else:
                continue
            assert not tops & (FORBIDDEN | {"bevformer_tensorrt_tpu_torch", "portbench"}), path
