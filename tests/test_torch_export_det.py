"""The deployable artifacts of BEVDet, YOLOX and CenterNet on the CPU
(`tools/bevdet/export.py`, `tools/det2d/export.py`), held as
tests/test_torch_export.py holds BEVFormer's: bit for bit the eager model,
the registered operators called as the eager forward calls them."""
import json

import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu_torch.configs.centernet import centernet_micro
from bevformer_tensorrt_tpu_torch.runtime.bevdet_engine import BEVDetEngine, RigModel, rig_ranks
from bevformer_tensorrt_tpu_torch.runtime.det2d_engine import Det2DEngine, make_config
from bevformer_tensorrt_tpu_torch.runtime.export import export_program, load_program
from bevformer_tensorrt_tpu_torch.tools.bevdet import export as bevdet_export_cli
from bevformer_tensorrt_tpu_torch.tools.bevdet.evaluate import frames_of
from bevformer_tensorrt_tpu_torch.tools.bevdet.evaluate import make_config as bevdet_config
from bevformer_tensorrt_tpu_torch.tools.det2d import export as det2d_export_cli
from test_torch_export import assert_same, check_graph, eager, last_json
from torch_port_helpers import make_synthetic_set

torch.set_num_threads(2)


def test_bevdet_cli_bakes_the_rig(tmp_path, capsys):
    """`tools/bevdet/export.py --model micro`: the program's only input is
    the image; its head maps are the engine's on the same rig's ranks."""
    root = make_synthetic_set(tmp_path / "set", frames=2)
    infos = str(root / "nuscenes_infos_synthetic.pkl")
    out = tmp_path / "bevdet"
    bevdet_export_cli.main(["--model", "micro", "--infos", infos, "--ranks-pad", "8192",
                            "--device", "cpu", "--out", str(out)])
    assert last_json(capsys)["out"] == str(out)
    meta = json.loads((out / "meta.json").read_text())
    assert meta["model"] == "bevdet_micro" and meta["pool_impl"] == "interval"
    assert meta["ranks_pad"] == 8192 and meta["rig_infos"] == infos
    cfg = bevdet_config("micro")
    engine = BEVDetEngine(cfg, rig_ranks(cfg, frames_of(cfg, infos).infos[0], 8192), seed=0,
                          device="cpu")
    image = torch.from_numpy(np.random.default_rng(5).standard_normal(
        meta["image"]).astype(np.float32))
    want, calls = eager(RigModel(engine.model, engine.rank_args), (image,))
    program = load_program(out, "cpu")
    assert_same(program(image), want)
    assert [n.name for n in program.program.graph_module.graph.nodes
            if n.op == "placeholder" and n.name not in
            program.program.graph_signature.inputs_to_parameters
            and n.name not in program.program.graph_signature.inputs_to_buffers] == ["image"]
    check_graph(program.program, calls, ())


@pytest.mark.parametrize("model", ["yolox_micro", "centernet_micro"])
def test_det2d_cli(model, tmp_path, capsys):
    out = tmp_path / model
    det2d_export_cli.main([model, "--batch", "2", "--device", "cpu", "--out", str(out)])
    assert last_json(capsys)["out"] == str(out)
    meta = json.loads((out / "meta.json").read_text())
    cfg = make_config(model)
    assert meta["image"] == [2, 3, cfg.img_size, cfg.img_size] and meta["model"] == model
    assert meta["cudnn_deterministic"] == model.startswith("centernet")
    engine = Det2DEngine(cfg, device="cpu", seed=0)
    images = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 255, meta["image"]).astype(np.float32))
    want, calls = eager(engine.model, (images,))
    program = load_program(out, "cpu")
    assert_same(program(images), want)
    check_graph(program.program, calls, ())


@pytest.mark.parametrize("quant", [False, "int8"])
def test_centernet_dcn_program(quant, tmp_path):
    """CenterNet micro with its DCNv2 neck: the deformable convolution is
    the registered operator (from the int8 table under int8)."""
    cfg = centernet_micro(use_dcn=True, quant=quant)
    engine = Det2DEngine(cfg, device="cpu", seed=2)
    images = torch.from_numpy(np.random.default_rng(7).uniform(
        0, 255, (2, 3, cfg.img_size, cfg.img_size)).astype(np.float32))
    if quant:
        engine.calibrate([images.numpy()], method="max")
    want, calls = eager(engine.model, (images,))
    export_program(engine.model, (images,), tmp_path)
    program = load_program(tmp_path, "cpu")
    assert_same(program(images), want)
    assert calls["modulated_deform_conv2d"] == 3
    check_graph(program.program, calls,
                ("modulated_deform_conv2d",) + (("int8_matmul",) if quant else ()))
