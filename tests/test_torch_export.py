"""The deployable artifact of the port (`runtime/export.py`, the three export
CLIs) on the CPU: BEVFormer here, BEVDet and the 2D detectors in
tests/test_torch_export_det.py (the two files share these helpers).

Each program is exported with `--device cpu`, saved, loaded again and run:
its outputs equal the eager model's bit for bit, and its graph calls the
port's registered operators (`bevformer_port::*`) exactly as often as the
eager forward does, with none of the plain versions' own ops (their gathers,
softmaxes, float64 products) in their place.  One artifact is reloaded in a
fresh interpreter that imports the port alone.  The operators' launch
counters count kernel launches, so they are checked on the card only
(`chip_smoke.py`, phase `export`); on the CPU the operators run their plain
versions.
"""
import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bevformer_tensorrt_tpu_torch.configs.bevformer import bevformer_micro
from bevformer_tensorrt_tpu_torch.models.layers import QConv, QDense
from bevformer_tensorrt_tpu_torch.runtime.det2d_engine import Det2DEngine, make_config
from bevformer_tensorrt_tpu_torch.runtime.engine import BEVFormerEngine
from bevformer_tensorrt_tpu_torch.runtime.export import export_program, load_program
from bevformer_tensorrt_tpu_torch.runtime.synthetic import synthetic_frames
from bevformer_tensorrt_tpu_torch.tools import export as export_cli

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _import_dynamo():
    """`torch.export` imports `torch._dynamo`, whose `cProfile` import needs
    the standard library's `profile`.  A test that puts the repo's tools/
    first on sys.path (tests/test_create_data.py, for one) would hand it
    tools/profile.py: import it here with tools/ off the path, and leave
    sys.path and any `profile` module as they were."""
    tools = os.path.join(REPO, "tools")
    path, shadow = list(sys.path), sys.modules.pop("profile", None)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != tools]
    try:
        import torch._dynamo  # noqa: F401
    finally:
        sys.path[:] = path
        if shadow is not None:
            sys.modules["profile"] = shadow


_import_dynamo()
# ops that only the plain versions of the registered operators call in these
# graphs: MSDA's and the DCN's gathers, the attention softmaxes, the float64
# sums of the int8 product and of the int8 attention
PLAIN_ONLY = ("aten.gather.default", "aten._softmax.default", "aten.softmax.int")


class OpCounter(TorchDispatchMode):
    """Counts the calls of the port's registered operators under it."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        ns, _, name = func.name().partition("::")
        if ns == "bevformer_port":
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def eager(module, args):
    """(outputs, registered-operator calls) of one eager forward."""
    with torch.no_grad(), OpCounter() as counter:
        out = module(*args)
    return out, dict(counter.counts)


def flat(out):
    return [t for t in torch.utils._pytree.tree_leaves(out) if torch.is_tensor(t)]


def assert_same(got, want):
    got, want = flat(got), flat(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def registered_ops(program):
    """How often the graph calls each operator of the port's namespace."""
    return dict(collections.Counter(
        str(n.target).split(".")[1] for n in program.graph_module.graph.nodes
        if n.op == "call_function" and str(n.target).startswith("bevformer_port.")))


def check_graph(program, calls, want_ops):
    """The graph calls each registered operator as the eager forward did,
    names the ones expected, and (where it calls any) holds no
    plain-version op."""
    ops = registered_ops(program)
    assert ops == calls and set(ops) == set(want_ops), (ops, calls)
    for node in program.graph_module.graph.nodes:
        if node.op != "call_function" or not want_ops:
            continue
        assert str(node.target) not in PLAIN_ONLY, node.format_node()
        assert torch.float64 not in node.args, node.format_node()


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bevformer_cli_artifact_stands_alone(tmp_path, capsys):
    """`tools/export.py micro` in float32, reloaded in an interpreter that
    imports the port alone; the next frame's inputs run through the
    program there and through the eager engine here."""
    out = tmp_path / "micro"
    export_cli.main(["micro", "--dtype", "float32", "--device", "cpu", "--out", str(out)])
    line = last_json(capsys)
    assert line["out"] == str(out) and set(line["artifacts"]) == {"model.pt2", "meta.json"}
    assert line["artifact_mb"] == sum(line["artifacts"].values()) / 1e6
    meta = json.loads((out / "meta.json").read_text())
    cfg = bevformer_micro()
    nq = cfg.bev_h * cfg.bev_w
    assert meta["model"] == "micro" and meta["dtype"] == "float32" and meta["quant"] == "none"
    assert meta["device"] == "cpu" and not meta["cudnn_deterministic"]
    assert meta["image"] == [1, cfg.num_cams, 3, cfg.img_h, cfg.img_w]
    assert meta["prev_bev"] == [nq, 1, cfg.embed_dims]
    assert meta["lidar2img"] == [1, cfg.num_cams, 4, 4]

    engine = BEVFormerEngine(bevformer_micro(dtype="float32"), device="cpu", seed=0)
    frames = synthetic_frames(cfg, np.random.default_rng(3), ("a", "a"))
    engine.infer_frame(**frames[0])
    args = engine.frame_inputs(**frames[1])  # a temporal frame: prev_bev, use_prev_bev 1
    want, calls = eager(engine.model, args)
    torch.save(args, tmp_path / "args.pt")
    code = (
        "import sys, torch\n"
        "from bevformer_tensorrt_tpu_torch.runtime.export import load_program\n"
        f"program = load_program({str(out)!r}, 'cpu')\n"
        f"torch.save(program(*torch.load({str(tmp_path / 'args.pt')!r})), "
        f"{str(tmp_path / 'got.pt')!r})\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'bevformer_tensorrt_tpu')]\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert_same(torch.load(tmp_path / "got.pt"), want)
    check_graph(load_program(out, "cpu").program, calls, ("msda", "flash_attention"))


def test_bevformer_int8_program(tmp_path):
    """Micro under int8 (max calibration on one frame): the program runs
    the folded weights through the kept int8 matrices, so no int8 layer's
    float weight feeds any node, and the product is the registered
    operator."""
    cfg = bevformer_micro(quant="int8", encoder_layers=1, decoder_layers=1)
    engine = BEVFormerEngine(cfg, device="cpu", seed=1)
    frames = synthetic_frames(cfg, np.random.default_rng(4), ("a",))
    engine.calibrate(frames, method="max")
    args = engine.frame_inputs(**frames[0])
    want, calls = eager(engine.model, args)
    export_program(engine.model, args, tmp_path)
    program = load_program(tmp_path, "cpu")
    assert_same(program(*args), want)
    check_graph(program.program, calls, ("msda", "flash_attention", "int8_matmul"))
    sig = program.program.graph_signature.inputs_to_parameters
    users = {node.name: len(node.users) for node in program.program.graph_module.graph.nodes
             if node.op == "placeholder"}
    int8_weights = {f"{name}.weight" for name, m in engine.model.named_modules()
                    if isinstance(m, (QDense, QConv)) and m.mode == "int8"}
    fed = [p for node, p in sig.items() if p in int8_weights and users[node]]
    assert len(int8_weights) > 50 and not fed, fed


def test_load_refuses_another_device(tmp_path):
    cfg = make_config("centernet_micro")
    engine = Det2DEngine(cfg, device="cpu", seed=0)
    export_program(engine.model, (torch.zeros(1, 3, cfg.img_size, cfg.img_size),), tmp_path)
    meta = json.loads((tmp_path / "meta.json").read_text())
    (tmp_path / "meta.json").write_text(json.dumps(dict(meta, device="cuda")))
    with pytest.raises(ValueError, match="exported on cuda"):
        load_program(tmp_path, "cpu")
