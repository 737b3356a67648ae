"""The 2D family's parts in the port against the JAX package on the CPU:
CSPDarknet, the PAFPN, the YOLOX head, the CTResNetNeck (DCNv2 at narrow
widths) and the CenterNet head at 1e-5, both decodes, the 2D NMS (native,
against the numpy loop and the JAX package's), the COCO mAP and the COCO
loader (bit for bit).  The whole micro detectors and the CLIs are in
tests/test_torch_2d_model.py."""
import json

import numpy as np
import pytest
import torch
from PIL import Image

from bevformer_tensorrt_tpu.core import nms2d as jax_nms2d
from bevformer_tensorrt_tpu.data.coco import CocoDataset as JaxCocoDataset
from bevformer_tensorrt_tpu.evalsuite import coco_map as jax_coco_map
from bevformer_tensorrt_tpu.models.backbones.csp_darknet import CSPDarknet as JaxCSPDarknet
from bevformer_tensorrt_tpu.models.backbones.resnet import ResNet as JaxResNet
from bevformer_tensorrt_tpu.models.heads import centernet_head as jax_ct_head
from bevformer_tensorrt_tpu.models.heads import yolox_head as jax_yolox_head
from bevformer_tensorrt_tpu.models.necks.ct_resnet_neck import CTResNetNeck as JaxCTNeck
from bevformer_tensorrt_tpu.models.necks.pafpn import YOLOXPAFPN as JaxPAFPN
from bevformer_tensorrt_tpu_torch.core import nms2d
from bevformer_tensorrt_tpu_torch.data.coco import CocoDataset
from bevformer_tensorrt_tpu_torch.evalsuite import coco_map
from bevformer_tensorrt_tpu_torch.models.backbones.csp_darknet import CSPDarknet
from bevformer_tensorrt_tpu_torch.models.backbones.resnet import ResNet
from bevformer_tensorrt_tpu_torch.models.heads.centernet_head import (
    CenterNetHead,
    centernet_decode,
)
from bevformer_tensorrt_tpu_torch.models.heads.yolox_head import YOLOXHead, yolox_decode
from bevformer_tensorrt_tpu_torch.models.necks.ct_resnet_neck import CTResNetNeck
from bevformer_tensorrt_tpu_torch.models.necks.pafpn import YOLOXPAFPN
from bevformer_tensorrt_tpu_torch.native import nms_2d_native
from torch_port_helpers import load_port, random_variables, rel, run_pair_nchw

torch.set_num_threads(2)

TOL = 1e-5


def _nhwc(x):
    return np.ascontiguousarray(x.transpose(0, 2, 3, 1))


def _pair_list(jax_module, port_module, rng, maps):
    """A flax module and its port that take a list of maps: the same seeded
    weights, the maps given NCHW; returns (JAX outputs, port outputs)."""
    nhwc = [_nhwc(m) for m in maps]
    variables = random_variables(jax_module, rng, nhwc)
    want = jax_module.apply(variables, nhwc)
    load_port(port_module, variables)
    with torch.no_grad():
        got = port_module([torch.from_numpy(m) for m in maps])
    return want, got


def test_csp_darknet_matches_jax(rng):
    """YOLOX-micro's backbone (deepen 0.33, widen 0.125): its three
    outputs at 64 px."""
    x = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
    want, got = run_pair_nchw(JaxCSPDarknet(0.33, 0.125), CSPDarknet(0.33, 0.125), rng, x)
    assert [g.shape for g in got] == [(2, 32, 8, 8), (2, 64, 4, 4), (2, 128, 2, 2)]
    for g, w in zip(got, want):
        assert rel(g, w) < TOL


def test_pafpn_and_yolox_head_match_jax(rng):
    """The PAFPN (micro's plan: in 32 / 64 / 128, out 32, one CSP block)
    and the YOLOX head on its three levels."""
    maps = [rng.standard_normal((2, c, s, s)).astype(np.float32)
            for c, s in ((32, 8), (64, 4), (128, 2))]
    want, got = _pair_list(JaxPAFPN(out_channels=32, num_csp_blocks=1),
                           YOLOXPAFPN([32, 64, 128], 32, 1), rng, maps)
    for g, w in zip(got, want):
        assert rel(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2)) < TOL
    feats = [rng.standard_normal((2, 32, s, s)).astype(np.float32) for s in (8, 4, 2)]
    want, got = _pair_list(jax_yolox_head.YOLOXHead(num_classes=80, feat_channels=32),
                           YOLOXHead(32, 80, 32), rng, feats)
    for lvl in range(3):
        for k in ("cls", "reg", "obj"):
            w = np.asarray(want[lvl][k]).transpose(0, 3, 1, 2)
            assert got[lvl][k].shape == w.shape and rel(got[lvl][k].numpy(), w) < TOL, (lvl, k)


def test_resnet18_matches_jax(rng):
    """CenterNet's backbone: ResNet-18 of basic blocks, the last stage."""
    x = rng.standard_normal((1, 3, 64, 64)).astype(np.float32)
    want, got = run_pair_nchw(JaxResNet(depth=18, out_indices=(3,)),
                              ResNet(18, out_indices=(3,)), rng, x)
    assert got[0].shape == (1, 512, 2, 2) and rel(got[0], want[0]) < TOL


@pytest.mark.parametrize("use_dcn", [True, False])
def test_ct_resnet_neck_and_head_match_jax(use_dcn, rng):
    """The CTResNetNeck at narrow widths (64 in, 16 / 8 / 8) with DCNv2 or
    plain convs, whose transposed convs load the flax kernel flipped, and
    the CenterNet head on its output.  The seeded offset convs are scaled by
    0.02: bilinear sampling at offsets of whole pixels is chaotic (a 1e-5
    upstream change flips corner cells), as tests/test_import_2d.py notes."""
    x = rng.standard_normal((1, 64, 4, 4)).astype(np.float32)
    jneck = JaxCTNeck(num_deconv_filters=(16, 8, 8), use_dcn=use_dcn)
    variables = random_variables(jneck, rng, _nhwc(x))
    for m in range(3):
        if use_dcn:
            off = variables["params"][f"dcn{m}"]["conv_offset"]
            off["kernel"] = off["kernel"] * np.float32(0.02)
            off["bias"] = off["bias"] * np.float32(0.02)
    want = jneck.apply(variables, _nhwc(x))
    neck = load_port(CTResNetNeck(64, (16, 8, 8), use_dcn), variables)
    with torch.no_grad():
        got = neck(torch.from_numpy(x))
    assert got.shape == (1, 8, 32, 32)
    assert rel(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2)) < TOL
    feat = got.numpy()
    jhead = jax_ct_head.CenterNetHead(num_classes=80, feat_channels=8)
    hv = random_variables(jhead, rng, _nhwc(feat))
    want = jhead.apply(hv, _nhwc(feat))
    head = load_port(CenterNetHead(8, 80, 8), hv)
    with torch.no_grad():
        got = head(torch.from_numpy(feat))
    for name in ("heatmap", "wh", "offset"):
        assert rel(got[name].numpy(), np.asarray(want[name]).transpose(0, 3, 1, 2)) < TOL, name


def test_yolox_decode_matches_jax(rng):
    """The batched decode: every point's boxes and scores, in the JAX
    order."""
    outs = [{k: rng.standard_normal((2, s, s, c)).astype(np.float32)
             for k, c in (("cls", 80), ("reg", 4), ("obj", 1))} for s in (8, 4, 2)]
    wb, ws = jax_yolox_head.yolox_decode(outs)
    port = [{k: torch.from_numpy(v.transpose(0, 3, 1, 2).copy()) for k, v in o.items()}
            for o in outs]
    gb, gs = yolox_decode(port)
    assert gb.shape == (2, 84, 4) and gs.shape == (2, 84, 80)
    assert rel(gb.numpy(), np.asarray(wb)) < 1e-6 and rel(gs.numpy(), np.asarray(ws)) < 1e-6


def test_centernet_decode_matches_jax(rng):
    """The local-maximum suppression and the class-major top k: the same
    scores, labels and boxes; the heatmap's logits are drawn from a few
    values, so many scores tie, and the stable sort keeps the lower index
    first as `jax.lax.top_k` does."""
    heads = {"heatmap": rng.integers(-3, 2, (2, 16, 16, 80)).astype(np.float32) * 0.5,
             "wh": rng.random((2, 16, 16, 2)).astype(np.float32) * 8,
             "offset": rng.random((2, 16, 16, 2)).astype(np.float32)}
    wb, ws, wl = jax_ct_head.centernet_decode(heads, k=100, kernel=3)
    gb, gs, gl = centernet_decode({k: torch.from_numpy(v.transpose(0, 3, 1, 2).copy())
                                   for k, v in heads.items()}, k=100, kernel=3)
    assert len(np.unique(np.asarray(ws))) < 10  # ties everywhere
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=0, atol=1e-5)


def _boxes(rng, n):
    xy = rng.uniform(0, 60, (n, 2))
    wh = rng.uniform(2, 20, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_nms_2d_native_matches_numpy_and_jax(rng):
    """The native greedy loop keeps the numpy loop's indices, and
    `multiclass_nms` gives the JAX package's boxes, scores and labels."""
    for n in (0, 1, 50, 400):
        boxes = _boxes(rng, n)
        scores = rng.random(n).astype(np.float32)
        keep = nms_2d_native(boxes, scores, 0.5)
        np.testing.assert_array_equal(keep, nms2d.nms(boxes, scores, 0.5))
        np.testing.assert_array_equal(keep, jax_nms2d.nms(boxes, scores, 0.5))
    boxes = _boxes(rng, 300)
    scores = rng.random((300, 5)).astype(np.float32) ** 3
    got = nms2d.multiclass_nms(boxes, scores, 0.05, 0.65, 100, nms_pre=40)
    want = jax_nms2d.multiclass_nms(boxes, scores, 0.05, 0.65, 100, nms_pre=40)
    assert 0 < len(got[0]) <= 100
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="xyxy"):
        nms_2d_native(boxes[:, :3], scores[:, 0], 0.5)


def test_coco_map_matches_jax(rng):
    """`evaluate_coco_map` and `box_iou` on random GT and predictions (some
    near the GT, some noise, one image without GT) give the JAX package's
    numbers exactly."""
    gt, pred = [], []
    for img in range(6):
        for _ in range(int(rng.integers(0 if img == 5 else 1, 5))):
            b = _boxes(rng, 1)[0]
            c = int(rng.integers(0, 3))
            gt.append({"image_id": str(img), "category_id": c, "bbox": b.tolist()})
            for _ in range(2):
                jitter = b + rng.normal(0, 2, 4).astype(np.float32)
                pred.append({"image_id": str(img), "category_id": c, "bbox": jitter.tolist(),
                             "score": float(rng.random())})
        for b in _boxes(rng, 3):
            pred.append({"image_id": str(img), "category_id": int(rng.integers(0, 3)),
                         "bbox": b.tolist(), "score": float(rng.random())})
    want = jax_coco_map.evaluate_coco_map(gt, pred, 4)
    got = coco_map.evaluate_coco_map(gt, pred, 4)
    assert got == want and 0 < got["mAP"] < 1
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    np.testing.assert_array_equal(coco_map.box_iou(a, b), jax_coco_map.box_iou(a, b))


@pytest.fixture(scope="module")
def coco_set(tmp_path_factory):
    """A small COCO-format set: images of odd sizes (one wider than tall,
    one taller), a crowd annotation that must be dropped, sparse ids."""
    root = tmp_path_factory.mktemp("coco")
    (root / "images").mkdir()
    rng = np.random.default_rng(4)
    images, anns = [], []
    for i, (h, w) in enumerate(((70, 95), (96, 41), (64, 64))):
        Image.fromarray(rng.integers(0, 255, (h, w, 3)).astype(np.uint8)).save(
            root / "images" / f"{i}.png")
        images.append({"id": 10 + i, "file_name": f"{i}.png", "width": w, "height": h})
        for k in range(3):
            anns.append({"id": len(anns) + 1, "image_id": 10 + i, "category_id": (5, 9, 17)[k],
                         "bbox": [3.0 * k, 2.0, 10.5, 7.25], "iscrowd": int(k == 2 and i == 0)})
    ann = root / "instances.json"
    ann.write_text(json.dumps({"images": images, "annotations": anns, "categories": [
        {"id": c, "name": str(c)} for c in (17, 5, 9)]}))
    return ann, root / "images"


@pytest.mark.parametrize("norm", [{}, dict(mean=(123.675, 116.28, 103.53),
                                           std=(58.395, 57.12, 57.375), to_rgb=True)])
def test_coco_loader_matches_jax_bit_for_bit(norm, coco_set):
    """`CocoDataset.sample` and `raw` against the JAX loader: the same
    letterboxed, normalized image bit for bit, scale, size and GT (YOLOX's
    raw pixels and CenterNet's RGB norm)."""
    ann, img_root = coco_set
    ours, theirs = CocoDataset(ann, img_root, 64, **norm), JaxCocoDataset(ann, img_root, 64, **norm)
    assert len(ours) == len(theirs) == 3 and ours.cat_to_label == theirs.cat_to_label
    for i in range(len(ours)):
        a, b = ours.sample(i), theirs.sample(i)
        assert a.image.dtype == b.image.dtype == np.float32 and a.image.shape == (3, 64, 64)
        assert np.array_equal(a.image, b.image)
        assert (a.image_id, a.scale, a.orig_hw, a.gt) == (b.image_id, b.scale, b.orig_hw, b.gt)
        for x, y in zip(ours.raw(i), theirs.raw(i)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    assert len(ours.sample(0).gt) == 2  # the crowd box is dropped


def test_det2d_engine_refuses_cpu_fallback(monkeypatch):
    """Without CUDA the 2D engine raises unless the caller asks for the CPU."""
    from bevformer_tensorrt_tpu_torch.configs.yolox import yolox_micro
    from bevformer_tensorrt_tpu_torch.runtime.det2d_engine import Det2DEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Det2DEngine(yolox_micro())
    assert Det2DEngine(yolox_micro(), device="cpu").device.type == "cpu"


def test_transposed_conv_asks_cudnn_for_a_deterministic_algorithm(monkeypatch):
    """CenterNet's transposed conv runs under cuDNN's deterministic flag (on
    the card cuDNN computes it as a backward-data pass, some of whose
    algorithms accumulate with atomics: the same batch then gave other
    detections, the evaluator's pipelined loop against its serial loop),
    and leaves the flag as it found it."""
    from bevformer_tensorrt_tpu_torch.models.necks import ct_resnet_neck

    seen = []
    real = ct_resnet_neck.F.conv_transpose2d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.deterministic)
        return real(*args, **kwargs)

    monkeypatch.setattr(ct_resnet_neck.F, "conv_transpose2d", spy)
    before = torch.backends.cudnn.deterministic
    out = ct_resnet_neck.Deconv(4)(torch.ones(1, 4, 3, 3))
    assert seen == [True] and torch.backends.cudnn.deterministic == before
    assert out.shape == (1, 4, 6, 6)
