"""The PyTorch port's data modules against the JAX package's (CPU).

Both packages read one generated nuScenes-layout set (the repo's
`tools/make_synthetic_nuscenes.py` at micro size: 4 frames in 2 scenes, 2
cameras of 96x160).  The loaders, the augmentation, the temporal clips and
the samplers are numpy on both sides, so the port must give the same arrays
bit for bit.  The fused native pass (`csrc/image_pipeline.cpp`, built by
each package from its own copy with the same flags) is held to the same bar,
at a target that needs no padding, one that pads and one that crops.
"""
import pickle
import shutil

import numpy as np
import pytest
from PIL import Image

from bevformer_tensorrt_tpu.data import nuscenes as jax_nuscenes
from bevformer_tensorrt_tpu.data import sampler as jax_sampler
from bevformer_tensorrt_tpu.data import transforms as jax_transforms
from bevformer_tensorrt_tpu_torch import native
from bevformer_tensorrt_tpu_torch.data import nuscenes, sampler, transforms
from torch_port_helpers import SYNTH_INFOS, make_synthetic_set

INFOS = SYNTH_INFOS
# (96, 160): the images' own size (nothing padded); (100, 192): padded in
# both dimensions; (64, 128): cropped in both dimensions
TARGETS = [(96, 160), (100, 192), (64, 128)]
NORMS = ["IMG_NORM_CAFFE", "IMG_NORM_PYTORCH"]


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return make_synthetic_set(tmp_path_factory.mktemp("synth") / "set")


@pytest.fixture(scope="module")
def mixed(synth, tmp_path_factory):
    """The same set with every second camera's images shrunk to 80x144, so
    a frame's views differ in size and the loader takes the numpy chain."""
    out = tmp_path_factory.mktemp("mixed") / "set"
    shutil.copytree(synth, out)
    with open(out / INFOS, "rb") as f:
        infos = pickle.load(f)["infos"]
    for info in infos:
        cam = list(info["cams"].values())[1]
        path = out / cam["data_path"]
        with Image.open(path) as im:
            im.resize((144, 80)).save(path, quality=90)
    return out


def loaders(root, norm="IMG_NORM_CAFFE", jax_kw=None, port_kw=None, **kw):
    """(JAX loader, port loader) over the same set with the same options."""
    want = jax_nuscenes.NuScenesFrames(root / INFOS, root, img_norm=getattr(jax_nuscenes, norm),
                                       **(jax_kw or {}), **kw)
    got = nuscenes.NuScenesFrames(root / INFOS, root, img_norm=getattr(nuscenes, norm),
                                  **(port_kw or {}), **kw)
    return want, got


def assert_same_frame(got, want):
    for field in ("sample_token", "scene_token", "timestamp"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("image", "can_bus", "lidar2img", "gt_boxes", "gt_labels",
                  "ego2global_translation", "ego2global_rotation"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype and g.shape == w.shape, field
        assert np.array_equal(g, w), field


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("target", TARGETS)
def test_frames_match_jax_bit_for_bit(synth, target, norm):
    want, got = loaders(synth, target_hw=target, norm=norm)
    assert [e["token"] for e in got.infos] == [e["token"] for e in want.infos]
    assert len(got) == len(want) == 4
    for i in range(len(got)):
        g = got.frame(i)
        assert g.image.shape == (1, 2, 3) + target
        assert_same_frame(g, want.frame(i))


@pytest.mark.parametrize("target", [(96, 160), (64, 128)])
def test_numpy_chain_with_mixed_sizes_matches_jax(mixed, target):
    want, got = loaders(mixed, target_hw=target, norm="IMG_NORM_PYTORCH")
    for i in range(len(got)):
        assert_same_frame(got.frame(i), want.frame(i))


def port_numpy_chain(frames, idx, target):
    """The port's own per-camera numpy chain for one frame: normalize, pad to
    a multiple of 32, grow or crop to the target, CHW."""
    th, tw = target
    imgs = []
    for cam in frames.infos[idx]["cams"].values():
        img = nuscenes.load_image(frames._resolve(cam["data_path"]))
        img = nuscenes.pad_to_divisor(nuscenes.normalize_image(img, frames.img_norm))
        grown = np.zeros((max(th, img.shape[0]), max(tw, img.shape[1]), 3), np.float32)
        grown[: img.shape[0], : img.shape[1]] = img
        imgs.append(grown[:th, :tw].transpose(2, 0, 1))
    return np.stack(imgs)[None]


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("target", TARGETS)
def test_native_pass_matches_the_numpy_chain(synth, target, norm):
    """Caffe-style (std 1) bit for bit; pytorch-style within one float32
    rounding (values under 2.7 in magnitude: 2.4e-7), because the native
    pass multiplies by a rounded 1 / std where the chain divides by std."""
    frames = nuscenes.NuScenesFrames(synth / INFOS, synth, img_norm=getattr(nuscenes, norm),
                                     target_hw=target)
    for i in range(len(frames)):
        got, want = frames.frame(i).image, port_numpy_chain(frames, i, target)
        assert got.shape == want.shape
        if norm == "IMG_NORM_CAFFE":
            assert np.array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)


def test_augment_matches_jax(synth):
    want, got = loaders(
        synth, target_hw=(96, 160),
        jax_kw=dict(augment=jax_transforms.MultiViewTrainAugment(
            scale=jax_transforms.RandomScaleImage(scales=[0.5, 1.0]), seed=3)),
        port_kw=dict(augment=transforms.MultiViewTrainAugment(
            scale=transforms.RandomScaleImage(scales=[0.5, 1.0]), seed=3)))
    for i in range(len(got)):
        assert_same_frame(got.frame(i), want.frame(i))


def test_temporal_clips_match_jax(synth):
    want, got = loaders(synth, target_hw=(96, 160))
    jclips = jax_nuscenes.TemporalClipSampler(want, queue_length=2)
    clips = nuscenes.TemporalClipSampler(got, queue_length=2)
    assert clips.clips == jclips.clips == [[0, 1], [2, 3]]
    for k in range(len(clips)):
        clip, jclip = clips.clip(k), jclips.clip(k)
        assert np.array_equal(clip[0].can_bus[:3], np.zeros(3, np.float32))
        assert clip[1].can_bus[0] == 5.0  # the ego moves 5 m a frame in x
        for g, w in zip(clip, jclip):
            assert_same_frame(g, w)


@pytest.mark.parametrize("n,shards", [(10, 3), (7, 7), (3, 4), (100, 8)])
def test_even_split_matches_jax(n, shards):
    for s in range(shards):
        got = sampler.even_split_indices(n, s, shards)
        assert np.array_equal(got, jax_sampler.even_split_indices(n, s, shards))


def test_scene_group_shards_match_jax(rng):
    tokens = [f"scene{k}" for k in rng.integers(0, 9, 60)]
    for shards in (1, 2, 3, 5):
        assert sampler.scene_group_shards(tokens, shards) == \
            jax_sampler.scene_group_shards(tokens, shards)


def test_shuffled_batches_match_jax():
    got = iter(sampler.ShuffledBatchSampler(23, 4, shard=1, num_shards=2, seed=5))
    want = iter(jax_sampler.ShuffledBatchSampler(23, 4, shard=1, num_shards=2, seed=5))
    for _ in range(9):  # past the end of an epoch
        assert np.array_equal(next(got), next(want))


def test_cbgs_matches_jax(rng):
    labels = [rng.integers(0, 10, rng.integers(0, 6)).tolist() for _ in range(40)]
    got = sampler.cbgs_indices(labels, 10, seed=2)
    assert len(got) > 0 and np.array_equal(got, jax_sampler.cbgs_indices(labels, 10, seed=2))
    assert np.array_equal(sampler.cbgs_indices([[], []], 10), np.arange(2))


@pytest.mark.parametrize("compiler", ["/nonexistent/g++", "false"])
def test_failed_native_build_raises(synth, tmp_path, monkeypatch, compiler):
    """A compiler that is missing or fails raises; nothing falls back to numpy."""
    monkeypatch.setattr(native, "CXX", compiler)
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    frames = nuscenes.NuScenesFrames(synth / INFOS, synth, target_hw=(96, 160))
    with pytest.raises(RuntimeError, match="image_pipeline.cpp"):
        frames.frame(0)
    assert not list((tmp_path / "build").glob("*.so"))
