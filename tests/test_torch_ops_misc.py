"""The port's remaining ops against the JAX package's on the CPU: grid
sampling in 2D and 3D over every mode, padding and `align_corners` (1e-5),
the batched and the closed-form 4x4 inverse (1e-5 relative), voxelization,
points in rotated boxes and RoI-aware pooling (integer outputs exact, floats
within 1e-6)."""
import importlib
import itertools
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevformer_tensorrt_tpu.ops import grid_sample as jax_gs
from bevformer_tensorrt_tpu.ops import voxel as jax_voxel
from bevformer_tensorrt_tpu_torch import ops
from torch_port_helpers import rel

torch.set_num_threads(2)

# the package exports the function under its module's name
jax_inv = importlib.import_module("bevformer_tensorrt_tpu.ops.inverse")


def _grid(rng, shape):
    """Coordinates past [-1, 1] on every side, so each padding mode acts."""
    return rng.uniform(-1.3, 1.3, shape).astype(np.float32)


@pytest.mark.parametrize("mode,padding,align", itertools.product(
    ("bilinear", "nearest", "bicubic"), ("zeros", "border", "reflection"), (False, True)))
def test_grid_sample_2d_matches_jax(mode, padding, align):
    rng = np.random.default_rng(zlib.crc32(f"{mode} {padding} {align}".encode()))
    inp = rng.standard_normal((2, 3, 7, 9)).astype(np.float32)
    grid = _grid(rng, (2, 5, 6, 2))
    want = np.asarray(jax_gs.grid_sample_2d(jnp.asarray(inp), jnp.asarray(grid), mode, padding,
                                            align))
    got = ops.grid_sample_2d(torch.from_numpy(inp), torch.from_numpy(grid), mode, padding, align)
    assert got.shape == want.shape and rel(got.numpy(), want) < 1e-5
    # the reference's channel-first form, its grid pre-scaled by 10
    cf = torch.from_numpy(grid).permute(0, 3, 1, 2) * 10
    assert rel(ops.grid_sampler(torch.from_numpy(inp), cf, mode, padding, align,
                                scale=10.0).numpy(), want) < 1e-5


@pytest.mark.parametrize("mode,padding,align", itertools.product(
    ("bilinear", "nearest"), ("zeros", "border", "reflection"), (False, True)))
def test_grid_sample_3d_matches_jax(mode, padding, align):
    rng = np.random.default_rng(zlib.crc32(f"3d {mode} {padding} {align}".encode()))
    inp = rng.standard_normal((2, 3, 4, 5, 6)).astype(np.float32)
    grid = _grid(rng, (2, 3, 4, 5, 3))
    want = np.asarray(jax_gs.grid_sample_3d(jnp.asarray(inp), jnp.asarray(grid), mode, padding,
                                            align))
    got = ops.grid_sample_3d(torch.from_numpy(inp), torch.from_numpy(grid), mode, padding, align)
    assert got.shape == want.shape and rel(got.numpy(), want) < 1e-5
    want_cf = np.asarray(jax_gs.grid_sampler(jnp.asarray(inp),
                                             jnp.moveaxis(jnp.asarray(grid), -1, 1), mode,
                                             padding, align))
    got_cf = ops.grid_sampler(torch.from_numpy(inp), torch.from_numpy(grid).movedim(-1, 1), mode,
                              padding, align)
    assert rel(got_cf.numpy(), want_cf) < 1e-5


def test_inverse_matches_jax(rng):
    """Batches of 4x4 and 5x5 matrices (normal entries plus a multiple of
    the identity, so well conditioned): both inverses within 1e-5 relative
    of the JAX package's, the 4x4 one an inverse; float64 stays float64."""
    m4 = rng.standard_normal((3, 6, 4, 4)).astype(np.float32) + 3 * np.eye(4, dtype=np.float32)
    m5 = rng.standard_normal((7, 5, 5)).astype(np.float32) + 4 * np.eye(5, dtype=np.float32)
    for x in (m4, m5):
        want = np.asarray(jax_inv.inverse(jnp.asarray(x)))
        got = ops.inverse(torch.from_numpy(x))
        assert got.dtype == torch.float32 and rel(got.numpy(), want) < 1e-5
    want = np.asarray(jax_inv.inverse_4x4(jnp.asarray(m4)))
    got = ops.inverse_4x4(torch.from_numpy(m4))
    assert rel(got.numpy(), want) < 1e-5
    eye = torch.from_numpy(m4) @ got
    assert float((eye - torch.eye(4)).abs().max()) < 1e-4
    assert ops.inverse(torch.from_numpy(m4).double()).dtype == torch.float64


def _points(rng, n=300):
    """Points inside and outside the range, 30 in one voxel, nan rows."""
    pts = np.concatenate([rng.uniform(-1, 11, (n, 3)), rng.standard_normal((n, 2))], 1)
    pts[:30, :3] = 5.5 + 0.1 * rng.random((30, 3))
    pts[-20:] = np.nan
    return pts.astype(np.float32)


@pytest.mark.parametrize("max_voxels,max_points", [(400, 6), (40, 3)])
def test_voxelize_matches_jax(rng, max_voxels, max_points):
    """Every output equal to the JAX package's, with voxels and points
    dropped past `max_voxels` and `max_points_per_voxel`."""
    pts = _points(rng)
    args = ((0.0, 0.0, 0.0, 10.0, 10.0, 10.0), (1.0, 1.0, 2.0), (10, 10, 5))
    want = jax_voxel.voxelize(jnp.asarray(pts), *args, max_voxels=max_voxels,
                              max_points_per_voxel=max_points)
    got = ops.voxelize(torch.from_numpy(pts), *args, max_voxels=max_voxels,
                       max_points_per_voxel=max_points)
    names = ("voxels", "coords", "num_points", "valid")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        if name == "voxels":
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6)
        else:
            assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w), name
    assert int(got[2].max()) == max_points
    assert (int(got[3].sum()) == max_voxels) == (max_voxels == 40)


def _rois(rng, b=5):
    rois = np.concatenate([rng.uniform(2, 8, (b, 3)), rng.uniform(1.5, 4, (b, 3)),
                           rng.uniform(-np.pi, np.pi, (b, 1))], 1)
    return rois.astype(np.float32)


def test_points_in_rotated_boxes_matches_jax(rng):
    pts = _points(rng)[:, :3]
    boxes = _rois(rng)
    want = np.asarray(jax_voxel.points_in_rotated_boxes(jnp.asarray(pts), jnp.asarray(boxes)))
    got = ops.points_in_rotated_boxes(torch.from_numpy(pts), torch.from_numpy(boxes)).numpy()
    assert want.any() and np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["max", "avg"])
def test_roiaware_pool3d_matches_jax(rng, mode):
    pts = _points(rng, 600)
    feats = rng.standard_normal((600, 4)).astype(np.float32)
    rois = _rois(rng)
    want = np.asarray(jax_voxel.roiaware_pool3d(jnp.asarray(rois), jnp.asarray(pts[:, :3]),
                                                jnp.asarray(feats), (3, 4, 2), mode))
    got = ops.roiaware_pool3d(torch.from_numpy(rois), torch.from_numpy(pts[:, :3]),
                              torch.from_numpy(feats), (3, 4, 2), mode).numpy()
    assert got.shape == want.shape and (want != 0).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
