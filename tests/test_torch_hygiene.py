"""Hygiene of the PyTorch port: weight conversion consumes every flax leaf,
the package imports neither JAX nor the JAX package, entry points refuse to
fall back to the CPU, and the decode matches the JAX package's."""
import os
import subprocess
import sys

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
        "print('modules', sum(k.startswith('bevformer_tensorrt_tpu_torch') for k in sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 30
    for module in ("quant.qdq", "quant.calibrate", "quant.fold", "ops.int8_matmul",
                   "tools.calibrate"):
        assert os.path.exists(os.path.join(REPO, "bevformer_tensorrt_tpu_torch",
                                           *module.split(".")) + ".py"), module


def test_engine_refuses_cpu_fallback(monkeypatch):
    """Without CUDA an entry point raises unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BEVFormerEngine(bevformer_micro())
    assert BEVFormerEngine(bevformer_micro(), device="cpu").device.type == "cpu"


def test_int8_refusals():
    """What the quantized tiers still refuse: the int8 DCN gather table
    (a DCN backbone under "int8" unless `dcn_tables` is excluded), an "int8"
    forward without calibrated scales, and an unknown `quant`."""
    dcn = dict(dcn_stages=(False, False, True, True))
    with pytest.raises(NotImplementedError, match="int8 gather table of the DCN"):
        BEVFormer(bevformer_micro(quant="int8", **dcn))
    BEVFormer(bevformer_micro(quant="int8", quant_exclude=("dcn_tables",), **dcn))
    BEVFormer(bevformer_micro(quant=True, **dcn))
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
    size, and refuse "int8" under the default policy, which leaves the int8
    DCN table on."""
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
        with pytest.raises(NotImplementedError, match="int8 gather table of the DCN"):
            BEVFormer(getattr(configs, fn)(quant="int8"))


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
    ("void (anonymous namespace)::dcn_im2col_kernel<float>(float const*, float const*)",
     "dcn kernel"),
    ("void (anonymous namespace)::int8_gemm_kernel<float>(signed char const*)",
     "int8 gemm kernel"),
    ("void (anonymous namespace)::msda_kernel<signed char, float, 1>(signed char const*)",
     "msda int8 kernel"),
    ("void (anonymous namespace)::flash_int8_kernel<float, 32>(signed char const*)",
     "flash int8 kernel"),
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
    from bevformer_tensorrt_tpu_torch.ops import attention, dcn, int8_matmul, msda
    from bevformer_tensorrt_tpu_torch.tools.path_diff import WRAPPERS, compare, plain_versions

    wrappers = (msda.multi_scale_deformable_attn, attention.flash_attention,
                dcn.modulated_deform_conv2d)
    six = [getattr(mod, name) for mod, name, _ in WRAPPERS.values()]
    assert six == list(ops.KERNEL_WRAPPERS)  # every counted wrapper can be swapped
    with plain_versions():
        assert int8_matmul.int8_matmul is int8_matmul.int8_matmul_plain
        assert msda.multi_scale_deformable_attn_int8 is msda.multi_scale_deformable_attn_int8_plain
        assert attention.flash_attention_int8 is attention.flash_attention_int8_plain
    assert [getattr(mod, name) for mod, name, _ in WRAPPERS.values()] == six
    with plain_versions(["dcn"]):
        assert dcn.modulated_deform_conv2d is dcn.modulated_deform_conv2d_plain
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
