"""The port's card-side tools on the CPU: `device_op_check` (each case's
inputs bit for bit the JAX tool's; a case that fails in its subprocess is
reported by name and the others run), `bevpool_ab` (every float32 variant
within 1e-5 of the JAX `bev_pool_v2`), `msda_capture_repro` (a micro
capture replayed on the plain path gives each layer's MSDA output bit for
bit), and `opbench`, `component_bench`, `msda_breakdown` and
`benchmark_all` run at toy or micro size with `--device cpu` and print
their records' keys."""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu_torch.tools import device_op_check as doc

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
sys.path.insert(0, str(REPO))

torch.set_num_threads(2)

MSDA_CASES = {  # the JAX tool's CASES, its keyword arguments
    "msda_tsa_bf16": dict(B=2, nq=40000, L=1, P=4, ppg=1, ss=doc.SS_BEV),
    "msda_sca_bf16": dict(B=6, nq=doc.K_SCA, L=4, P=8, ppg=4, ss=doc.SS_IMG),
    "msda_dec_int8": dict(B=1, nq=900, L=1, P=4, ppg=1, ss=doc.SS_BEV),
}


class Caught(Exception):
    pass


def catch(monkeypatch, module, name):
    """Replace `module.name` by a call that raises `Caught` with its
    arguments: the JAX tool runs up to its first kernel call."""
    def record(*args, **kwargs):
        raise Caught(args, kwargs)
    monkeypatch.setattr(module, name, record)


def as_f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def bf16(a):
    return torch.as_tensor(a).to(torch.bfloat16).float().numpy()


def test_cases_and_modes_are_the_jax_tools():
    import device_op_check as jax_doc

    assert list(doc.CASES) == list(jax_doc.CASES) and doc.MODES == jax_doc.MODES
    assert (doc.SS_IMG, doc.SS_BEV, doc.K_SCA) == (jax_doc.SS_IMG, jax_doc.SS_BEV, jax_doc.K_SCA)


@pytest.mark.parametrize("case", list(MSDA_CASES))
@pytest.mark.parametrize("mode", doc.MODES)
def test_msda_inputs_are_the_jax_tools(case, mode):
    import device_op_check as jax_doc

    kw = MSDA_CASES[case]
    got = doc.msda_inputs(mode, **kw)
    want = jax_doc._msda_inputs(mode, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w, equal_nan=True)


@pytest.mark.parametrize("mode", doc.MODES)
def test_dcn_and_flash_inputs_are_the_jax_tools(mode, monkeypatch):
    """What the JAX tool hands its DCN and flash kernels (bfloat16 maps and
    weights, float32 offsets and masks) from the port's draws."""
    import device_op_check as jax_doc

    import bevformer_tensorrt_tpu.ops.dcn as jax_dcn
    import bevformer_tensorrt_tpu.ops.pallas.flash_attn as jax_flash

    catch(monkeypatch, jax_dcn, "modulated_deform_conv2d")
    catch(monkeypatch, jax_flash, "flash_attention")
    with pytest.raises(Caught) as e:
        jax_doc._run_dcn(True, mode)
    (x, offset, mask, wgt), _ = e.value.args
    px, poff, pmask, pw = doc.dcn_inputs(mode)
    assert np.array_equal(as_f32(x), bf16(px), equal_nan=True)
    assert np.array_equal(as_f32(wgt), bf16(pw))
    assert np.array_equal(np.asarray(offset), poff, equal_nan=True)
    assert np.array_equal(np.asarray(mask), pmask)
    with pytest.raises(Caught) as e:
        jax_doc._run_flash(True, mode)
    for g, w in zip(doc.flash_inputs(mode), e.value.args[0]):
        assert np.array_equal(bf16(g), as_f32(w), equal_nan=True)


def test_model_case_inputs_are_the_jax_tools(monkeypatch):
    import jax

    import device_op_check as jax_doc

    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    monkeypatch.setattr(jax, "jit", lambda fn, **kw: lambda *a: (_ for _ in ()).throw(Caught(a)))
    with pytest.raises(Caught) as e:
        jax_doc._run_model("feedback")
    _, image, _, _, can_bus, l2i = e.value.args[0]
    from bevformer_tensorrt_tpu_torch.configs.bevformer import bevformer_base

    got = doc.model_inputs(bevformer_base())
    for g, w in zip(got, (image, can_bus, l2i)):
        assert np.array_equal(g, np.asarray(w))


def test_a_failing_case_is_reported_and_the_others_run(monkeypatch):
    def command(name, mode, device, exclude=()):
        if name == "boom":
            code = "raise RuntimeError('deliberate failure')"
        else:
            code = f"print('CASE_OK {{\"tier\": \"{mode}\"}}')"
        return [sys.executable, "-c", code]

    monkeypatch.setattr(doc, "case_command", command)
    rec = doc.main(["--cases", "msda_dec_int8", "boom", "flash_int8", "--data", "normal", "wild",
                    "--device", "cpu", "--jobs", "2"])
    assert rec["ok"] == 4 and rec["bad"] == 2
    for mode in ("normal", "wild"):
        bad = rec["results"][f"boom/{mode}"]
        assert bad["status"] == "fail" and "deliberate failure" in bad["tail"][-1]
        assert rec["results"][f"flash_int8/{mode}"] == {"status": "ok", "s": pytest.approx(
            rec["results"][f"flash_int8/{mode}"]["s"]), "tier": mode}


def test_bevpool_variants_agree_with_jax():
    from bevformer_tensorrt_tpu.configs.bevdet import bevdet_micro as jax_micro
    from bevformer_tensorrt_tpu.ops.bev_pool import bev_pool_v2 as jax_pool
    from bevformer_tensorrt_tpu_torch.configs.bevdet import bevdet_micro
    from bevformer_tensorrt_tpu_torch.tools import bevpool_ab

    cfg, jcfg = bevdet_micro(), jax_micro()
    depth, feat = bevpool_ab.inputs(cfg, "cpu")
    seen = 0
    with torch.inference_mode():
        for name, call in bevpool_ab.variants(cfg, "cpu"):
            impl, pad, dt = name.split("/")
            if dt != "f32":
                continue
            ranks, _ = bevpool_ab.rig_ranks(cfg, pad)
            want = jax_pool(depth.numpy(), feat.numpy(), ranks.ranks_depth, ranks.ranks_feat,
                            ranks.ranks_bev, ranks.interval_starts, ranks.interval_lengths,
                            out_height=jcfg.bev_h, out_width=jcfg.bev_w, impl=impl)
            np.testing.assert_allclose(call().numpy(), np.asarray(want), rtol=0, atol=1e-5,
                                       err_msg=name)
            seen += 1
    assert seen == 4


def test_msda_capture_replays_bit_for_bit(tmp_path):
    from bevformer_tensorrt_tpu_torch.tools import msda_capture_repro as mcr

    rec = mcr.main(["capture", "--dir", str(tmp_path), "--model", "micro", "--device", "cpu"])
    assert rec["saved"] == ["tsa0", "sca0", "tsa1", "sca1"] and rec["finite"]
    for name in rec["saved"]:
        saved = np.load(tmp_path / f"{name}.npz")
        assert bool(saved["int8"]) == name.startswith("sca")  # TSA's tables excluded
        got = mcr.replay_as_captured(tmp_path / f"{name}.npz", device="cpu").float().numpy()
        assert np.array_equal(got, saved["out"]), name
    rep = mcr.main(["replay", "--dir", str(tmp_path), "--layer", "chain", "--device", "cpu"])
    assert rep["ok"] and len(rep["rows"]) == 4 * 3


@pytest.mark.parametrize("tool,argv,keys", [
    ("opbench", ["--toy", "--iters", "1"], ("device", "rows")),
    ("component_bench", ["micro", "--iters", "1"],
     ("backbone_ms", "fpn_ms", "encoder_ms", "encoder_self_1l_ms", "encoder_cross_1l_ms",
      "decoder_ms", "cross_gather_mtaps_per_s", "self_gather_mtaps_per_s",
      "backbone_no_dcn_ms", "device")),
    ("msda_breakdown", ["cross", "--toy", "--int8", "--iters", "1"],
     ("table_ms", "geometry_ms", "launch_ms", "op_ms", "op_overhead_ms", "mtaps_per_s",
      "launch_host_us", "op_host_us")),
    ("benchmark_all", ["--models", "micro", "yolox_micro", "--iters", "1", "--batch", "2"],
     ("dispatch_floor_ms", "micro", "yolox_micro", "device")),
])
def test_tool_runs_on_the_cpu(tool, argv, keys, monkeypatch):
    import importlib

    main = importlib.import_module(f"bevformer_tensorrt_tpu_torch.tools.{tool}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
    rec = main(argv + ["--device", "cpu"])
    assert all(k in rec for k in keys), sorted(rec)
    if tool == "opbench":
        assert [(r["family"], r["tier"]) for r in rec["rows"]] == [
            (f, t) for f in ("msda (cross)", "dcn_v2 (c4)") for t in ("float32", "bfloat16", "int8")
        ] + [("bev_pool_v2 (r50)", t) for t in ("float32", "bfloat16")] + [
            ("flash_mha (decoder)", t) for t in ("float32", "bfloat16", "int8")]
    if tool == "benchmark_all":
        assert set(rec["micro"]) >= {"fps", "fps_net", "batch", "vs_baseline", "vs_baseline_net"}
