"""The port's YOLOX train augmentation and COCO training view against the
JAX package's on the CPU, bit for bit: each transform of
`data/transforms2d.py` from generators of one seed (the outputs and the
generators' states after), `YoloxTrainAugment` end to end over several
calls (mosaic and mixup on, then off, as CenterNet runs it), and
`CocoDataset.train_sample` on a 4-image generated set."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bevformer_tensorrt_tpu.data import coco as jax_coco
from bevformer_tensorrt_tpu.data import transforms2d as jax_t
from bevformer_tensorrt_tpu_torch.data import coco
from bevformer_tensorrt_tpu_torch.data import transforms2d as t


@pytest.fixture(scope="module")
def coco_set(tmp_path_factory):
    """4 generated images of at most 96 px: (annotations, image root)."""
    root = tmp_path_factory.mktemp("coco4")
    repo = Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, str(repo / "tools/make_synthetic_coco.py"), str(root),
                    "--images", "4", "--size", "96"], check=True, capture_output=True, timeout=120)
    return str(root / "instances_synthetic.json"), str(root / "images")


@pytest.fixture(scope="module")
def samples(coco_set):
    return [coco.CocoDataset(*coco_set, img_size=64).raw(i) for i in range(4)]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


def _rngs(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


def test_raw_matches_jax(coco_set, samples):
    ds = jax_coco.CocoDataset(*coco_set, img_size=64)
    for i, s in enumerate(samples):
        _same(s, ds.raw(i))
    assert sum(len(s[1]) for s in samples) > 4


def test_each_transform_matches_jax(samples):
    """Mosaic, RandomAffine (with the YOLOX border), MixUp, HSV and the
    helpers, each from one seed, over several seeds."""
    for seed in range(4):
        r1, r2 = _rngs(seed)
        mos = t.Mosaic(64)(samples, r1)
        _same(mos, jax_t.Mosaic(64)(samples, r2))
        aff = t.RandomAffine(border=(-32, -32))(*mos, r1)
        _same(aff, jax_t.RandomAffine(border=(-32, -32))(*mos, r2))
        mix = t.MixUp(64)(*samples[seed], samples[(seed + 1) % 4], r1)
        _same(mix, jax_t.MixUp(64)(*samples[seed], samples[(seed + 1) % 4], r2))
        _same([t.HSVRandomAug()(mix[0], r1)], [jax_t.HSVRandomAug()(mix[0], r2)])
        assert r1.random() == r2.random()
    img, boxes, labels = samples[0]
    mat = np.array([[1.1, 0.1, -3.0], [-0.05, 0.9, 4.0], [0.0, 0.0, 1.0]])
    _same([t._affine_warp(img, mat, 50, 70, 114.0)], [jax_t._affine_warp(img, mat, 50, 70, 114.0)])
    _same([t._transform_boxes(boxes, mat)], [jax_t._transform_boxes(boxes, mat)])
    _same(t._filter_boxes(boxes * 1.5 - 10, labels, 64, 40),
          jax_t._filter_boxes(boxes * 1.5 - 10, labels, 64, 40))


@pytest.mark.parametrize("mosaic_mixup", [True, False])
def test_yolox_train_augment_matches_jax(samples, mosaic_mixup):
    """Eight calls of one augmenter each (its generator running on), the
    image, boxes and labels equal to the JAX package's every time."""
    kw = dict(img_scale=64, enable_mosaic=mosaic_mixup, enable_mixup=mosaic_mixup)
    got_aug, want_aug = t.YoloxTrainAugment(**kw), jax_t.YoloxTrainAugment(**kw)
    kept = 0
    for call in range(8):
        got = got_aug(call % 4, 4, lambda j: samples[j])
        _same(got, want_aug(call % 4, 4, lambda j: samples[j]))
        kept += len(got[1])
    assert kept > 0


@pytest.mark.parametrize("augment", [False, True])
def test_train_sample_matches_jax(coco_set, augment):
    """`train_sample` with and without the augmentation, each image of the
    set in turn (CenterNet's norm and RGB order in the second case): the
    normalized image, the boxes in input pixels and the labels."""
    norm = dict(mean=(123.675, 116.28, 103.53), std=(58.395, 57.12, 57.375), to_rgb=True)
    kw = norm if augment else {}
    got_ds = coco.CocoDataset(*coco_set, img_size=64, **kw)
    want_ds = jax_coco.CocoDataset(*coco_set, img_size=64, **kw)
    got_aug = t.YoloxTrainAugment(img_scale=64) if augment else None
    want_aug = jax_t.YoloxTrainAugment(img_scale=64) if augment else None
    for i in range(4):
        got = got_ds.train_sample(i, got_aug)
        _same(got, want_ds.train_sample(i, want_aug))
        assert got[0].shape == (3, 64, 64) and (got[1] <= 64).all()
