"""Port ops (geometry, resize) against the JAX package's, on the same
seeded NumPy inputs, in f32.  Tolerance: atol 1e-6 (the same arithmetic,
summed in the same order up to the frameworks' own kernels)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pifuhd_tpu.ops import geometry as jgeom
from rgbd_pifuhd_tpu.ops import resize as jresize
from rgbd_pifuhd_tpu_torch.ops import geometry as tgeom
from rgbd_pifuhd_tpu_torch.ops import resize as tresize

ATOL = 1e-6


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


@pytest.mark.parametrize("hw", [(13, 17), (1, 9), (8, 1), (32, 32)])
def test_grid_sample_bilinear(rng, hw):
    H, W = hw
    feat = rng.standard_normal((2, H, W, 5)).astype(np.float32)
    uv = np.concatenate([
        rng.uniform(-1.3, 1.3, (2, 200, 2)),
        np.broadcast_to(np.array([[-1.0, -1.0], [1.0, 1.0], [-1.0, 1.0],
                                  [0.0, 0.0]]), (2, 4, 2)),
    ], axis=1).astype(np.float32)
    ref = jgeom.grid_sample_bilinear(jnp.asarray(feat), jnp.asarray(uv))
    got = tgeom.grid_sample_bilinear(torch.from_numpy(feat),
                                     torch.from_numpy(uv))
    _close(got, ref)


def test_grid_sample_matches_torch_grid_sample(rng):
    """Same semantics as F.grid_sample(zeros, align_corners=True)."""
    feat = rng.standard_normal((1, 9, 11, 3)).astype(np.float32)
    uv = rng.uniform(-1.2, 1.2, (1, 50, 2)).astype(np.float32)
    got = tgeom.grid_sample_bilinear(torch.from_numpy(feat),
                                     torch.from_numpy(uv))
    ref = torch.nn.functional.grid_sample(
        torch.from_numpy(feat).permute(0, 3, 1, 2),
        torch.from_numpy(uv)[:, :, None, :], mode="bilinear",
        padding_mode="zeros", align_corners=True)[..., 0].permute(0, 2, 1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("mode", ["orthogonal", "perspective"])
@pytest.mark.parametrize("rows", [3, 4])
def test_projections(rng, mode, rows):
    pts = rng.uniform(-1, 1, (2, 64, 3)).astype(np.float32)
    pts[..., 2] += 3.0
    calib = rng.standard_normal((2, rows, 4)).astype(np.float32)
    calib[:, 2, 2] += 4.0
    ref = jgeom.PROJECTIONS[mode](jnp.asarray(pts), jnp.asarray(calib))
    got = tgeom.PROJECTIONS[mode](torch.from_numpy(pts),
                                  torch.from_numpy(calib))
    _close(got, ref, atol=1e-5)


@pytest.mark.parametrize("dims", [2, 3])
def test_mask_and_depth_feature(rng, dims):
    xyz = rng.uniform(-1.5, 1.5, (3, 100, 3)).astype(np.float32)
    xyz[0, :4] = [[1, 1, 1], [-1, -1, -1], [1.0000001, 0, 0], [0, 0, 1.5]]
    _close(tgeom.in_bounds_mask(torch.from_numpy(xyz), dims),
           jgeom.in_bounds_mask(jnp.asarray(xyz), dims))
    _close(tgeom.depth_normalize(torch.from_numpy(xyz), 1024, 200.0),
           jgeom.depth_normalize(jnp.asarray(xyz), 1024, 200.0))


@pytest.mark.parametrize("out_hw", [(16, 16), (7, 5), (12, 30)])
def test_resize_bilinear(rng, out_hw):
    x = rng.standard_normal((2, 8, 10, 3)).astype(np.float32)
    _close(tresize.resize_bilinear_align_corners(torch.from_numpy(x), out_hw),
           jresize.resize_bilinear_align_corners(jnp.asarray(x), out_hw))


@pytest.mark.parametrize("shape", [(1, 4, 4, 2), (2, 5, 7, 3)])
def test_upsample2x_bicubic(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    _close(tresize.upsample2x_bicubic(torch.from_numpy(x)),
           jresize.upsample2x_bicubic(jnp.asarray(x)))


def test_bicubic_matches_torch_interpolate(rng):
    x = rng.standard_normal((1, 6, 5, 2)).astype(np.float32)
    got = tresize.upsample2x_bicubic(torch.from_numpy(x))
    ref = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2,
        mode="bicubic", align_corners=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("args", [(2, 2, 0, True), (3, 2, 1, False),
                                  (3, 2, 1, True)])
def test_avg_pool2d(rng, args):
    window, stride, pad, cip = args
    x = rng.standard_normal((2, 9, 8, 3)).astype(np.float32)
    _close(tresize.avg_pool2d(torch.from_numpy(x), window, stride, pad, cip),
           jresize.avg_pool2d(jnp.asarray(x), window, stride, pad, cip))
