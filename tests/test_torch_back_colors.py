"""Back-face colour inpainting (``recon/pipeline.py::estimate_back_colors``):
the result of a vertex depends on the mesh's vertices as a set, not on the
order the marcher emitted them in; and where no two boundary vertices tie,
it is the JAX package's result.

Marching-cubes vertices lie on grid lines, so many boundary vertices share
a y and sit at equal y-distances from a back vertex; the k nearest among
equal distances must then be chosen by coordinates, not by position in the
vertex array.  The JAX package's function breaks those ties by vertex
order and stays as it is, so parity is held on continuous coordinates,
where no ties occur.
"""

import numpy as np
import pytest

from rgbd_pifuhd_tpu.recon.pipeline import estimate_back_colors as j_back
from rgbd_pifuhd_tpu_torch.recon.pipeline import estimate_back_colors


def _grid_mesh(rng, n=24):
    """Vertices on a coarse grid (heavy ties in y and in y-distance): a
    third on the boundary band, the rest back-facing, random colours."""
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    x = ii.ravel() / n - 0.5
    y = (jj.ravel() // 3) / n - 0.5         # three vertices to a y value
    z = np.where(rng.random(n * n) < 0.35, 5e-4, -0.3)
    xyz = np.stack([x, y, z], 1).astype(np.float32)
    return xyz, rng.random((n * n, 3)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vertex_order_does_not_change_colours(seed):
    rng = np.random.default_rng(seed)
    xyz, c = _grid_mesh(rng)
    base = estimate_back_colors(c, xyz)
    assert not np.array_equal(base, c)          # back vertices were painted
    for _ in range(3):
        perm = rng.permutation(len(xyz))
        got = estimate_back_colors(c[perm], xyz[perm])
        np.testing.assert_array_equal(got, base[perm])


@pytest.mark.parametrize("seed", [0, 1])
def test_tie_free_matches_jax(seed):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, (6000, 3))
    xyz[::4, 2] = rng.uniform(0, 1e-3, len(xyz[::4]))
    c = rng.random((6000, 3))
    bnd = (xyz[:, 2] >= 0) & (xyz[:, 2] < 1e-3)
    assert len(np.unique(xyz[bnd, 1])) == bnd.sum()     # no ties in y
    np.testing.assert_array_equal(estimate_back_colors(c, xyz),
                                  j_back(c, xyz))
