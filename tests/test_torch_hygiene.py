"""Hygiene of the PyTorch port: weight conversion consumes every flax leaf,
the package imports neither JAX nor the JAX package, entry points refuse to
fall back to the CPU, and the decode matches the JAX package's."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu.configs.bevformer import bevformer_micro as jax_micro
from bevformer_tensorrt_tpu.core.nms_free_coder import NMSFreeCoder as JaxCoder
from bevformer_tensorrt_tpu.models.detectors.bevformer import BEVFormer as JaxBEVFormer
from bevformer_tensorrt_tpu_torch.configs.bevformer import bevformer_micro, bevformer_tiny
from bevformer_tensorrt_tpu_torch.core.nms_free_coder import NMSFreeCoder
from bevformer_tensorrt_tpu_torch.models.detectors.bevformer import BEVFormer
from bevformer_tensorrt_tpu_torch.ops import dcn as ops_dcn
from bevformer_tensorrt_tpu_torch.runtime.engine import BEVFormerEngine
from bevformer_tensorrt_tpu_torch.weights import init_weights, params_from_jax
from torch_port_helpers import rel

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def micro_variables():
    cfg = jax_micro(msda_impl="jnp")
    nq = cfg.bev_h * cfg.bev_w
    args = (np.zeros((1, cfg.num_cams, 3, cfg.img_h, cfg.img_w), np.float32),
            np.zeros((nq, 1, cfg.embed_dims), np.float32), np.float32(0.0),
            np.zeros(18, np.float32), np.tile(np.eye(4, dtype=np.float32), (1, cfg.num_cams, 1, 1)))
    shapes = jax.eval_shape(lambda *a: JaxBEVFormer(cfg).init(jax.random.PRNGKey(0), *a), *args)
    return jax.tree_util.tree_map(lambda s: np.ones(s.shape, np.float32), dict(shapes))


def test_every_flax_leaf_is_consumed(micro_variables):
    n_leaves = len(jax.tree_util.tree_leaves(micro_variables))
    sd = params_from_jax(micro_variables)
    assert len(sd) == n_leaves
    model = BEVFormer(bevformer_micro())
    model.load_state_dict(sd, strict=True)
    assert len(model.state_dict()) == n_leaves


def test_unknown_leaf_or_collection_raises(micro_variables):
    extra = {**micro_variables, "params": {**micro_variables["params"],
                                           "stray": {"kernel_scale": np.ones(3)}}}
    with pytest.raises(KeyError, match="stray"):
        params_from_jax(extra)
    with pytest.raises(KeyError, match="cache"):
        params_from_jax({**micro_variables, "cache": {}})


def test_port_imports_no_jax():
    """Import every module of the port in a fresh interpreter: neither jax
    nor the JAX package may appear in sys.modules."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import bevformer_tensorrt_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'bevformer_tensorrt_tpu'))\n"
        "assert not bad, bad\n"
        "assert not [k for k in sys.modules if k.startswith(p.__name__ + '.samples')]\n"
        "print('modules', sum(k.startswith('bevformer_tensorrt_tpu_torch') for k in sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 127
    for module in ("quant.qdq", "quant.calibrate", "quant.fold", "ops.int8_matmul",
                   "tools.calibrate", "ops.gather_probe", "runtime.torch_import",
                   "tools.kernel_bench", "tools.kernel_cases", "data.nuscenes",
                   "data.transforms", "data.sampler", "native", "evalsuite.nds",
                   "evalsuite.format", "tools.evaluate", "ops.plain_vjp", "train.losses",
                   "train.assigner", "train.step", "tools.train", "configs.bevdet", "core.nms",
                   "models.necks.view_transformer", "ops.bev_pool",
                   "models.backbones.bev_resnet", "models.heads.centerpoint_head",
                   "models.detectors.bevdet", "runtime.bevdet_engine", "tools.bevdet.evaluate",
                   "tools.bevdet.calibrate", "tools.accuracy_cycle", "train.losses_bevdet",
                   "tools.bevdet.train", "tools.accuracy_cycle_family", "configs.yolox",
                   "configs.centernet", "models.backbones.csp_darknet", "models.necks.pafpn",
                   "models.necks.ct_resnet_neck", "models.heads.yolox_head",
                   "models.heads.centernet_head", "models.detectors.yolox",
                   "models.detectors.centernet", "core.nms2d", "data.coco", "evalsuite.coco_map",
                   "runtime.det2d_engine", "tools.det2d.evaluate", "tools.det2d.calibrate",
                   "runtime.serving", "runtime.export", "tools.serving_bench", "tools.export",
                   "tools.bevdet.export", "tools.det2d.export", "data.transforms2d",
                   "train.losses2d", "tools.det2d.train", "ops.grid_sample", "ops.inverse",
                   "ops.voxel", "registry", "tools.quant_ablation", "tools.device_op_check",
                   "tools.msda_capture_repro", "tools.opbench", "tools.component_bench",
                   "tools.msda_breakdown", "tools.benchmark_all", "tools.bevpool_ab",
                   "tools.flops_params", "tools.create_data", "tools.cam_budget_check",
                   "tools.geometry_analysis"):
        assert os.path.exists(os.path.join(REPO, "bevformer_tensorrt_tpu_torch",
                                           *module.split(".")) + ".py"), module


def test_engine_refuses_cpu_fallback(monkeypatch):
    """Without CUDA an entry point raises unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BEVFormerEngine(bevformer_micro())
    assert BEVFormerEngine(bevformer_micro(), device="cpu").device.type == "cpu"


def test_new_modules_take_the_plain_path_on_the_cpu(rng):
    """The loader, the gather probes and the kernel bench tool on CPU inputs
    launch nothing and build nothing: the probes' wrappers run their plain
    versions, the loader only renames tensors, and the tool asks for the CPU
    by name (without it, and without a card, it raises)."""
    from bevformer_tensorrt_tpu_torch import ops
    from bevformer_tensorrt_tpu_torch.ops import _cuda, gather_probe
    from bevformer_tensorrt_tpu_torch.runtime.torch_import import (
        load_bevformer_checkpoint,
        upstream_layout,
    )
    from bevformer_tensorrt_tpu_torch.tools import kernel_bench

    assert len(_cuda.KERNELS) == 7 and len(ops.KERNEL_WRAPPERS) == 12
    ops.reset_launch_counts()
    table = torch.from_numpy(rng.standard_normal((2, 30, 32)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 30, (2, 6, 4, 4)).astype(np.int32))
    w = torch.ones(2, 6, 4, 4)
    assert torch.equal(ops.gather_rows(table, idx.reshape(2, -1)),
                       gather_probe.gather_rows_plain(table, idx.reshape(2, -1)))
    assert torch.equal(ops.gather_blend(table, idx, w), gather_probe.gather_blend_plain(table, idx, w))
    cfg = bevformer_micro()
    model = BEVFormer(cfg)
    sd = load_bevformer_checkpoint(cfg, upstream_layout(cfg, model.state_dict()))
    assert all(t.device.type == "cpu" for t in sd.values())
    assert kernel_bench.main(["--device", "cpu", "--parts", "split"]) == 0
    assert [fn.launches for fn in ops.KERNEL_WRAPPERS] == [0] * 12
    assert not _cuda._libs and not list(_cuda.BUILD.glob("*.so"))


def test_int8_refusals():
    """What the quantized tiers still refuse: an "int8" forward without
    calibrated scales, and an unknown `quant`.  A DCN backbone under "int8"
    is no longer refused: it builds under the default policy with the int8
    gather table on every DCN block, and `dcn_tables` in the policy selects
    the floating-point table."""
    from bevformer_tensorrt_tpu_torch.models.backbones.resnet import DeformConv2d

    dcn = dict(dcn_stages=(False, False, True, True))

    def tables(model):
        return {m.int8_table for m in model.modules() if isinstance(m, DeformConv2d)}

    assert tables(BEVFormer(bevformer_micro(quant="int8", **dcn))) == {True}
    assert tables(BEVFormer(bevformer_micro(quant="int8", quant_exclude=("dcn_tables",),
                                            **dcn))) == {False}
    assert tables(BEVFormer(bevformer_micro(quant=True, **dcn))) == {False}
    with pytest.raises(ValueError, match="quant"):
        ops_dcn.modulated_deform_conv2d(torch.zeros(1, 32, 4, 4), torch.zeros(1, 18, 4, 4),
                                        torch.zeros(1, 9, 4, 4), torch.zeros(8, 32, 3, 3),
                                        quant="int4")
    assert bevformer_tiny(quant="int8").quant_exclude == ("self_attn/msda_tables",)
    engine = BEVFormerEngine(bevformer_micro(quant="int8"), device="cpu")
    cfg = engine.cfg
    with pytest.raises(ValueError, match="calibrated activation scales"):
        engine.infer_frame(np.zeros((1, cfg.num_cams, 3, cfg.img_h, cfg.img_w), np.float32),
                           np.zeros(18, np.float32),
                           np.tile(np.eye(4, dtype=np.float32), (1, cfg.num_cams, 1, 1)), "s")
    with pytest.raises(ValueError, match="quant"):
        BEVFormer(bevformer_micro(quant="int4"))


def shape_variables(jcfg):
    """Flax variables of BEVFormer(jcfg), every leaf filled with ones."""
    nq = jcfg.bev_h * jcfg.bev_w
    args = (np.zeros((1, jcfg.num_cams, 3, jcfg.img_h, jcfg.img_w), np.float32),
            np.zeros((nq, 1, jcfg.embed_dims), np.float32), np.float32(0.0),
            np.zeros(18, np.float32), np.tile(np.eye(4, dtype=np.float32), (1, jcfg.num_cams, 1, 1)))
    shapes = jax.eval_shape(lambda *a: JaxBEVFormer(jcfg).init(jax.random.PRNGKey(0), *a), *args)
    return jax.tree_util.tree_map(lambda s: np.ones(s.shape, np.float32), dict(shapes))


def test_every_flax_leaf_of_a_dcn_model_is_consumed():
    """conv2 of a DCN block is a kernel of its own plus conv_offset's kernel
    and bias: all three reach the port under the flax names."""
    over = dict(dcn_stages=(False, False, True, True))
    variables = shape_variables(jax_micro(msda_impl="jnp", **over))
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    sd = params_from_jax(variables)
    assert len(sd) == n_leaves
    block = "img_backbone.stage2_block0.conv2"
    assert tuple(sd[f"{block}.weight"].shape) == (256, 256, 3, 3)
    assert tuple(sd[f"{block}.conv_offset.weight"].shape) == (27, 256, 3, 3)
    assert tuple(sd[f"{block}.conv_offset.bias"].shape) == (27,)
    model = BEVFormer(bevformer_micro(**over))
    model.load_state_dict(sd, strict=True)
    assert len(model.state_dict()) == n_leaves


def test_small_and_base_build():
    """Both configs construct at full width (R101 caffe style, DCN on stages
    3-4), load the JAX package's variables strictly at reduced depth and
    size, and build under "int8" with the default policy, which leaves the
    int8 table on all 26 DCN blocks."""
    from bevformer_tensorrt_tpu.configs import bevformer as jax_configs
    from bevformer_tensorrt_tpu_torch.configs import bevformer as configs
    from bevformer_tensorrt_tpu_torch.models.backbones.resnet import DeformConv2d

    reduced = dict(encoder_layers=1, decoder_layers=1, img_h=64, img_w=96, bev_h=10, bev_w=10,
                   num_query=20)
    for fn, levels, convs in (("bevformer_small", 1, 2), ("bevformer_base", 4, 7)):
        model = BEVFormer(getattr(configs, fn)())
        assert sum(isinstance(m, DeformConv2d) for m in model.modules()) == 26
        assert model.img_backbone.stage1_block0.conv1.stride == (2, 2)  # caffe
        assert model.pts_bbox_head.transformer.level_embeds.shape == (levels, 256)
        assert len(list(model.img_neck.children())) == convs
        del model
        variables = shape_variables(getattr(jax_configs, fn)(msda_impl="jnp", **reduced))
        sd = params_from_jax(variables)
        small = BEVFormer(getattr(configs, fn)(**reduced))
        small.load_state_dict(sd, strict=True)
        assert len(sd) == len(jax.tree_util.tree_leaves(variables))
        int8 = BEVFormer(getattr(configs, fn)(quant="int8"))
        assert [m.int8_table for m in int8.modules() if isinstance(m, DeformConv2d)] == [True] * 26
        del int8


def test_seeded_init_fills_deform_conv():
    """DeformConv2d's own weight gets the LeCun-normal draw (it is created
    uninitialised), deterministically, and the R50 draws do not depend on it."""
    over = dict(dcn_stages=(False, False, True, True))
    a = init_weights(BEVFormer(bevformer_micro(**over)), torch.Generator().manual_seed(5))
    b = init_weights(BEVFormer(bevformer_micro(**over)), torch.Generator().manual_seed(5))
    w = a.img_backbone.stage3_block2.conv2.weight
    assert torch.equal(w, b.img_backbone.stage3_block2.conv2.weight)
    assert torch.isfinite(w).all()
    assert abs(float(w.detach().std()) * (512 * 9) ** 0.5 - 1.0) < 0.05
    plain = init_weights(BEVFormer(bevformer_micro()), torch.Generator().manual_seed(5))
    assert torch.equal(a.img_backbone.stem_conv.weight, plain.img_backbone.stem_conv.weight)


def test_seeded_init_is_deterministic():
    a = init_weights(BEVFormer(bevformer_micro()), torch.Generator().manual_seed(5))
    b = init_weights(BEVFormer(bevformer_micro()), torch.Generator().manual_seed(5))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    out = a.pts_bbox_head.cls_branch0.out.bias
    assert torch.allclose(out, torch.full_like(out, -4.595))


@pytest.mark.parametrize("name,fam", [
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize32x32x8_stage3_warpsize1x2x1_ffma", "matmul"),
    ("nvjet_tst_64x40_64x16_2x4_h_bz_bias_TNT", "matmul"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_64x64_8x5_tn_align1>", "matmul"),
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize64x32x8", "convolution"),
    ("void implicit_convolve_sgemm<float, float, 1024, 5, 5, 3, 3, 3, 1, false, false, true>",
     "convolution"),
    ("sm80_xmma_gemm_cf32cf32_f32f32_cf32_tn_n_tilesize32x64x8_stage3", "convolution"),
    ("void DSE::vector_fft<0, 1, 128, 8, 8, 1, float, float, float2>", "convolution"),
    ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_optimized_bf16>",
     "convolution"),
    ("void (anonymous namespace)::msda_kernel<float, 1>(float const*)", "msda kernel"),
    ("void (anonymous namespace)::dcn_im2col_kernel<float, float>(float const*, float const*)",
     "dcn im2col kernel"),
    ("void (anonymous namespace)::dcn_im2col_kernel<signed char, __nv_bfloat16>(signed char const*)",
     "dcn im2col int8 kernel"),
    ("void (anonymous namespace)::dcn_wgmma_kernel<2, 2, __nv_bfloat16>(CUtensorMap_st, "
     "__nv_bfloat16 const*, float const*)", "dcn kernel"),
    ("void (anonymous namespace)::dcn_ffma_kernel<2, float>(CUtensorMap_st, float const*)",
     "dcn kernel"),
    ("void (anonymous namespace)::dcn_wgmma_kernel<1, 2, signed char>(CUtensorMap_st, "
     "signed char const*, float const*)", "dcn int8 kernel"),
    ("void (anonymous namespace)::dcn_ffma_kernel<2, signed char>(CUtensorMap_st, signed char "
     "const*, float const*)", "dcn int8 kernel"),
    ("void (anonymous namespace)::dcn_table_kernel<float, signed char>(float const*, float "
     "const*, signed char*, int, int, int, int)", "dcn table kernel"),
    ("void (anonymous namespace)::dcn_amax_kernel<__nv_bfloat16>(__nv_bfloat16 const*, float*, "
     "int, int, int)", "dcn table kernel"),
    ("void (anonymous namespace)::dcn_ffma_kernel<signed char, 128, 0>(CUtensorMap_st, "
     "signed char const*, float const*)", "dcn int8 kernel"),
    ("void (anonymous namespace)::dcn_wgmma_kernel<2, __nv_bfloat16, 0>(CUtensorMap_st, "
     "__nv_bfloat16 const*, float const*)", "dcn kernel"),
    ("void (anonymous namespace)::int8_gemm_kernel<float>(signed char const*)",
     "int8 gemm kernel"),
    ("void (anonymous namespace)::msda_kernel<signed char, float, 1>(signed char const*)",
     "msda int8 kernel"),
    ("void (anonymous namespace)::flash_int8_kernel<float, 32>(signed char const*)",
     "flash int8 kernel"),
    ("void (anonymous namespace)::flash_int8_amax<float>(float const*, float const*)",
     "flash int8 quantize kernel"),
    ("void (anonymous namespace)::flash_int8_quantize<__nv_bfloat16>(__nv_bfloat16 const*)",
     "flash int8 quantize kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "memcpy"),
])
def test_profile_kernel_families(name, fam):
    """cuBLAS GEMMs count as matmul and cuDNN's kernels as convolution."""
    from bevformer_tensorrt_tpu_torch.tools.profile_frame import family

    assert family(name) == fam


def test_nms_free_decode_matches_jax(rng):
    cls = rng.standard_normal((2, 1, 40, 10)).astype(np.float32)
    cls[..., 3, 2] = cls[..., 5, 2] = 9.0  # a tie at the top
    box = (rng.standard_normal((2, 1, 40, 10)) * 20).astype(np.float32)
    want = JaxCoder(max_num=50).decode(cls, box)
    got = NMSFreeCoder(max_num=50).decode(torch.from_numpy(cls), torch.from_numpy(box))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["labels_3d"], w["labels_3d"])
        assert rel(g["scores_3d"], w["scores_3d"]) < 1e-6
        assert rel(g["boxes_3d"], w["boxes_3d"]) < 1e-6


def test_plain_versions_swap_and_restore():
    """The measuring aid of tools/path_diff.py swaps the named wrappers for
    their plain versions inside the block only, also when the block raises."""
    from bevformer_tensorrt_tpu_torch import ops
    from bevformer_tensorrt_tpu_torch.ops import _cuda, attention, dcn, int8_matmul, msda
    from bevformer_tensorrt_tpu_torch.tools.path_diff import WRAPPERS, compare, plain_versions

    wrappers = (msda.multi_scale_deformable_attn, attention.flash_attention,
                dcn.modulated_deform_conv2d)
    six = [getattr(mod, name) for mod, name, _ in WRAPPERS.values()]
    # every counted wrapper of the models can be swapped (the DCN op's gather
    # table with the op that makes it); the next two
    # counted wrappers are the probes of the kernel bench tool and the last
    # two the im2col kernels of the DCN op's old route, which no model calls
    counted = list(ops.KERNEL_WRAPPERS[:7])
    assert counted[2] is dcn.modulated_deform_conv2d
    assert counted[6] is dcn.modulated_deform_conv2d_int8
    assert ops.KERNEL_WRAPPERS[7] is dcn.dcn_gather_table
    assert six == counted and len(ops.KERNEL_WRAPPERS) == 12
    assert ops.KERNEL_WRAPPERS[8:] == (ops.gather_rows, ops.gather_blend, dcn.deform_im2col,
                                       dcn.deform_im2col_int8)
    assert _cuda.KERNELS == ("msda", "flash_attn", "dcn", "int8_gemm", "flash_attn_int8",
                             "gather_probe", "dcn_fused")
    assert all((_cuda.CSRC / f"{name}.cu").exists() for name in _cuda.KERNELS)
    with plain_versions():
        assert dcn.modulated_deform_conv2d_int8 is dcn.modulated_deform_conv2d_int8_plain
        assert int8_matmul.int8_matmul is int8_matmul.int8_matmul_plain
        assert msda.multi_scale_deformable_attn_int8 is msda.multi_scale_deformable_attn_int8_plain
        assert attention.flash_attention_int8 is attention.flash_attention_int8_plain
    assert [getattr(mod, name) for mod, name, _ in WRAPPERS.values()] == six
    with plain_versions(["dcn"]):
        assert dcn.modulated_deform_conv2d is not wrappers[2]
        assert dcn.modulated_deform_conv2d_int8 is not dcn.modulated_deform_conv2d_int8_plain
        assert msda.multi_scale_deformable_attn is wrappers[0]
    with pytest.raises(RuntimeError):
        with plain_versions():
            assert attention.flash_attention is attention.qkv_plain
            raise RuntimeError("inside")
    assert (msda.multi_scale_deformable_attn, attention.flash_attention,
            dcn.modulated_deform_conv2d) == wrappers
    frame = (torch.ones(4, 1, 8), torch.ones(2, 1, 5, 10), torch.ones(2, 1, 5, 10))
    other = (frame[0] * 1.5, frame[1], frame[2] * torch.tensor([1.0, 3.0]).reshape(2, 1, 1, 1))
    err = compare([other], [frame])
    assert err["bev_embed"]["max"] == pytest.approx(0.5)
    assert [e["max"] for e in err["classes"]] == [0.0, 0.0]
    assert [e["max"] for e in err["coords"]] == pytest.approx([0.0, 2.0])


def test_path_diff_nudges_only_the_pixels():
    """tools/path_diff.py's conditioning run: every pixel scaled by
    (1 + 1e-7 * a standard normal), the rest of the frame as it was."""
    from bevformer_tensorrt_tpu_torch.tools.path_diff import IMAGE_NOISE, nudged

    image = np.random.default_rng(0).uniform(-150, 150, (2, 3, 8, 8)).astype(np.float32)
    frame = dict(image=image, can_bus=np.arange(18.0), scene_token="s")
    (got,) = nudged([frame])
    assert got["image"].dtype == np.float32 and got["image"].shape == image.shape
    change = np.abs(got["image"] / image - 1)
    assert 0 < change.max() < 10 * IMAGE_NOISE and (change > 0).mean() > 0.5
    assert got["can_bus"] is frame["can_bus"] and got["scene_token"] == "s"
    assert np.array_equal(nudged([frame])[0]["image"], got["image"])  # seeded


def test_library_name_hashes_the_sources_it_includes(tmp_path, monkeypatch):
    """A source that includes another source (the bench's `dcn_fused_split.cu`
    includes `dcn_fused.cu`) is rebuilt when either changes; the shared
    headers count for every source.  Nothing is built."""
    from bevformer_tensorrt_tpu_torch.ops import _cuda

    (tmp_path / "base.cu").write_text("int f() { return 1; }\n")
    (tmp_path / "probe.cu").write_text('#define PROBE 1\n#include "base.cu"\n')
    (tmp_path / "other.cu").write_text("int g() { return 2; }\n")
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    monkeypatch.setattr(_cuda, "BUILD", tmp_path / "build")
    before = {name: _cuda.library_path(name) for name in ("probe", "other")}
    (tmp_path / "base.cu").write_text("int f() { return 3; }\n")
    assert _cuda.library_path("probe") != before["probe"]
    assert _cuda.library_path("other") == before["other"]
    (tmp_path / "shared.cuh").write_text("#pragma once\n")
    assert _cuda.library_path("other") != before["other"]
    assert not (tmp_path / "build").exists()
    real = Path(_cuda.__file__).resolve().parent.parent / "csrc"
    assert '#include "dcn_fused.cu"' in (real / "dcn_fused_split.cu").read_text()
    assert "dcn_fused_split" not in _cuda.KERNELS  # built on demand by the bench alone


@pytest.mark.parametrize("tool", ["bevdet.evaluate", "bevdet.calibrate", "accuracy_cycle",
                                  "bevdet.train", "accuracy_cycle_family", "det2d.evaluate",
                                  "det2d.calibrate", "det2d.train"])
def test_new_clis_default_to_cuda(tool, tmp_path, monkeypatch):
    """The BEVDet and 2D CLIs and the accuracy cycles run on CUDA unless
    `--device cpu` is given: without a card they raise before any work."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(f"bevformer_tensorrt_tpu_torch.tools.{tool}").main
    cycle = tool.startswith("accuracy_cycle")
    if tool.startswith("det2d"):
        argv = ["yolox_micro", "--ann", str(tmp_path / "none.json"), "--img-root", str(tmp_path)]
    else:
        argv = [] if cycle else ["--infos", str(tmp_path / "none.pkl")]
    argv += ["--out", str(tmp_path / "x.npz")] if tool.endswith("calibrate") else []
    argv += ["--workdir", str(tmp_path / "w")] if cycle else []
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
    assert not (tmp_path / "w").exists()


def test_bevdet_engine_refuses_cpu_fallback(monkeypatch):
    from bevformer_tensorrt_tpu_torch.configs.bevdet import bevdet_micro
    from bevformer_tensorrt_tpu_torch.models.necks.view_transformer import PoolingRanks
    from bevformer_tensorrt_tpu_torch.runtime.bevdet_engine import BEVDetEngine

    ranks = PoolingRanks(*(np.zeros(4, np.int32) for _ in range(5)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BEVDetEngine(bevdet_micro(), ranks)
    assert BEVDetEngine(bevdet_micro(), ranks, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="pool_impl"):
        BEVDetEngine(bevdet_micro(), ranks, device="cpu", pool_impl="sorted")


def test_native_nms_has_no_fallback(tmp_path, monkeypatch):
    """A native NMS that cannot be built raises: no numpy NMS stands behind
    it (the JAX wrapper falls back to core/nms.py)."""
    from bevformer_tensorrt_tpu_torch import native

    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "_libs", {})
    boxes = np.array([[0, 0, 2, 4, 0.0], [0.1, 0, 2, 4, 0.0]], np.float32)
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.nms_rotated_native(boxes, np.array([0.9, 0.8]), 0.2)
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "nms_rotated.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(native, "CXX", "g++")
    with pytest.raises(RuntimeError, match="failed for nms_rotated.cpp"):
        native.rotated_iou_matrix_native(boxes, boxes)
    with pytest.raises(RuntimeError, match="failed for nms_rotated.cpp"):
        native.nms_2d_native(boxes[:, :4], np.array([0.9, 0.8]), 0.5)


@pytest.mark.parametrize("tool,left_out,kept", [
    ("train", "--msda-impl", "--distributed"), ("evaluate", "--knobs", "--distributed"),
    ("opbench", "--k", "--iters"), ("bevpool_ab", "--k, scatter_sorted", "--iters"),
    ("benchmark_all", "--family-timeout", "--partial-out")])
def test_left_out_flags_are_named(tool, left_out, kept, capsys):
    """The CLIs accept the JAX CLI's flags they port (the BEVFormer train and
    evaluate CLIs its `--distributed`) and name the flags they still leave
    out, and only those, in their help."""
    import importlib

    main = importlib.import_module(f"bevformer_tensorrt_tpu_torch.tools.{tool}").main
    with pytest.raises(SystemExit):
        main(["--help"])
    out = " ".join(capsys.readouterr().out.split())
    assert kept in out.split("Not ported")[0]
    assert f"Not ported from the JAX CLI: {left_out}." in out


@pytest.mark.parametrize("tool", ["serving_bench", "export", "bevdet.export", "det2d.export"])
def test_serving_and_export_clis_default_to_cuda(tool, tmp_path, monkeypatch):
    """The serving bench and the three export CLIs run on CUDA unless
    `--device cpu` is given: without a card they raise before any work."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(f"bevformer_tensorrt_tpu_torch.tools.{tool}").main
    argv = {"serving_bench": ["--model", "micro"], "export": ["micro"],
            "bevdet.export": ["--infos", str(tmp_path / "none.pkl")],
            "det2d.export": ["yolox_micro"]}[tool]
    argv += [] if tool == "serving_bench" else ["--out", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
    assert not (tmp_path / "out").exists()


def test_serving_engine_and_loader_refuse_cpu_fallback(tmp_path, monkeypatch):
    from bevformer_tensorrt_tpu_torch.runtime.export import load_program
    from bevformer_tensorrt_tpu_torch.runtime.serving import ContinuousBatchingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingEngine(bevformer_micro())
    assert ContinuousBatchingEngine(bevformer_micro(), device="cpu").pool.device.type == "cpu"
    (tmp_path / "meta.json").write_text('{"device": "cpu"}')
    with pytest.raises(RuntimeError, match="CUDA"):
        load_program(tmp_path)


def test_export_cli_names_the_left_out_autotune(capsys):
    """The BEVFormer export CLI names the JAX CLI's Mosaic autotune flags,
    which it leaves out, in its help."""
    from bevformer_tensorrt_tpu_torch.tools import export

    with pytest.raises(SystemExit):
        export.main(["--help"])
    assert ("Not ported from the JAX CLI: --autotune, --autotune-iters"
            in " ".join(capsys.readouterr().out.split()))


def test_deform_conv_weight_starts_defined():
    """A built DeformConv2d's weight is zeros until init or a load fills it:
    it was `torch.empty`, whose NaNs, where the allocator handed back used
    memory, made a built model's state_dict differ from itself."""
    from bevformer_tensorrt_tpu_torch.models.backbones.resnet import DeformConv2d

    torch.full((64, 64, 3, 3), float("nan"))  # leave NaNs in freed memory
    assert torch.equal(DeformConv2d(64, 64).weight, torch.zeros(64, 64, 3, 3))
