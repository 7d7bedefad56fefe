"""``normal_mode`` ``mesh`` and ``grad``: the port's vertex colours against
the JAX package's on the ``tests/test_torch_recon.py`` setup (tiny untrained
two-level models at res 32, random images, identity calib, f32, the same
weights), norm-free and with GroupNorm MLPs.

- ``mesh``: geometric vertex normals on the host, no device colour pass.
  ``compute_vertex_normals`` within 1e-6 of the JAX function on the same
  mesh; ``gen_mesh`` gives the JAX package's vertex set (1e-5) and colours
  within 1/255 after uint8 quantisation, and makes no colour query.
- ``grad``: the negative gradient of the fine field at each vertex, through
  a ``torch.autograd.Function`` at ``models.coarse.query_mlp``.  Colours of
  the JAX mesh's vertices within 2/255 of ``jax.grad``'s; ``gen_mesh`` end
  to end: the same vertex set (1e-5) and colours within 2/255; with the
  GroupNorm MLPs, all but at most 1 in 1000 vertices.  The gradient of a
  leaky-relu network is a discontinuous function of its inputs: the two
  packages' forward values differ by f32 rounding (``phi`` by up to 1.4e-5),
  and at a few vertices that moves the gradient by up to 12 %.  Measured:
  3 to 13 of 16,536 vertices beyond 2/255; fed the JAX package's ``phi``,
  the port's fine-level gradient is the JAX one within 1.8e-5 everywhere.

Colours are compared with a chunk that divides the vertex count, as
``tests/test_torch_recon.py`` does: a chunk that is mostly padding leaves
GroupNorm's ``E[x^2] - E[x]^2`` ill-conditioned in either package.  Chunks
must hold the same vertices on both sides (GroupNorm pools over a chunk):
the same vertex order, or one chunk of the whole mesh.
"""

import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pifuhd_tpu.models import MultiResPIFu as JMultiResPIFu
from rgbd_pifuhd_tpu.recon.mesh import load_obj
from rgbd_pifuhd_tpu.recon.pipeline import Reconstructor as JReconstructor
from rgbd_pifuhd_tpu.utils.options import Options as JOptions
from rgbd_pifuhd_tpu_torch.models import MultiResPIFu
from rgbd_pifuhd_tpu_torch.recon.pipeline import Reconstructor
from rgbd_pifuhd_tpu_torch.utils.checkpoint import load_params
from rgbd_pifuhd_tpu_torch.utils.options import Options
from tests.test_torch_models import configs

RES = 32
SHARPEN = 100.0


def _canon(path):
    v, f, c = load_obj(path)
    o = np.lexsort(v.T)
    t = v[f].reshape(-1, 9)
    return v[o], c[o], t[np.lexsort(t.T)]


def _u8(c):
    return np.round(np.clip(c, 0.0, 1.0) * 255.0).astype(np.int64)


def _within_2(ct, cj):
    """Colours within 2/255 but for at most 1 in 1000 vertices (see the
    module docstring)."""
    d = np.abs(_u8(ct) - _u8(np.asarray(cj))).max(axis=1)
    assert (d > 2).mean() <= 1e-3, (int((d > 2).sum()), int(d.max()))


@functools.lru_cache(maxsize=None)
def _pair(variant):
    rng = np.random.default_rng(0)
    (jl, jg), (tl, tg) = configs(variant)
    img_l = rng.standard_normal((1, 32, 32, 6)).astype(np.float32)
    img_g = rng.standard_normal((1, 64, 64, 6)).astype(np.float32)
    calib = np.eye(4, dtype=np.float32)
    jm = JMultiResPIFu(cfg=jl, cfg_global=jg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(img_l)[None],
                     jnp.asarray(img_g), jnp.zeros((1, 1, 8, 3)),
                     jnp.asarray(calib)[None, None], jnp.asarray(calib)[None],
                     jnp.zeros((1, 1, 8, 1)))
    tm = MultiResPIFu(tl, tg, device="cpu")
    load_params(tm, jax.tree.map(np.asarray, params))
    data = {"img": img_l, "img_512": img_g, "calib": calib}
    return variant, jm, params, tm, data


@pytest.fixture
def pair(request):
    """The tiny model pair of ``request.param`` (built once a module)."""
    return _pair(request.param)


def _gen_both(pair, tmp, mode, chunk=None):
    _, jm, params, tm, data = pair
    jr = JReconstructor(jm, params, JOptions(resolution=RES,
                                              normal_mode=mode))
    tr = Reconstructor(tm, Options(resolution=RES, normal_mode=mode),
                       device="cpu")
    if chunk:
        jr._COLOR_CHUNK = tr._COLOR_CHUNK = chunk
    jout = jr.gen_mesh({k: jnp.asarray(v) for k, v in data.items()},
                       os.path.join(tmp, f"jax_{mode}.obj"), resolution=RES)
    tout = tr.gen_mesh(data, os.path.join(tmp, f"port_{mode}.obj"),
                       resolution=RES)
    return jout, tout


def test_compute_vertex_normals_matches_jax():
    """On a marched sphere (port's dense marcher) and on a permuted copy of
    its faces, against the JAX function."""
    from rgbd_pifuhd_tpu.recon.mesh import compute_vertex_normals as jcvn
    from rgbd_pifuhd_tpu_torch.recon.marching import marching_tetrahedra
    from rgbd_pifuhd_tpu_torch.recon.mesh import compute_vertex_normals

    g = np.linspace(-1.0, 1.0, 40, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    vol = 0.5 + 0.5 * (0.6 - np.sqrt(x * x + 1.3 * y * y + z * z))
    v, f = marching_tetrahedra(vol.astype(np.float32), algorithm="mc")
    assert len(f) > 1000
    for faces in (f, f[np.random.default_rng(0).permutation(len(f))]):
        got = compute_vertex_normals(v, faces)
        assert got.dtype == np.float32 and got.shape == v.shape
        np.testing.assert_allclose(got, jcvn(v, faces), rtol=0, atol=1e-6)
    assert np.allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("pair", ["none"], indirect=True)
def test_mesh_mode_colours_match_jax(pair, tmp_path):
    jout, tout = _gen_both(pair, tmp_path, "mesh")
    assert len(tout["verts"]) == len(jout["verts"]) > 100
    vj, cj, tj = _canon(str(tmp_path / "jax_mesh.obj"))
    vt, ct, tt = _canon(str(tmp_path / "port_mesh.obj"))
    np.testing.assert_allclose(vt, vj, atol=1e-5)
    np.testing.assert_allclose(tt, tj, atol=1e-5)
    d = np.abs(_u8(ct) - _u8(cj)).max()
    assert d <= 1, d
    # geometric normals: no device colour pass, so no colour query
    assert "color" not in tout["points_queried"]


@pytest.mark.parametrize("pair", ["none", "group"], indirect=True)
def test_grad_mode_colours_match_jax(pair, tmp_path):
    """Colours of the JAX mesh's vertices under the sharpened field (the
    fine MLP's last layer scaled by ``SHARPEN``), through each package's
    grad colouring, on a chunk that divides the vertex count."""
    _, jm, params, tm, data = pair
    jout = JReconstructor(jm, params, JOptions(resolution=RES)).gen_mesh(
        {k: jnp.asarray(v) for k, v in data.items()},
        str(tmp_path / "ref.obj"), resolution=RES)
    verts = np.asarray(jout["verts"], np.float32)
    V = len(verts)
    chunk = next(V // d for d in (4, 3, 2, 1) if V % d == 0)
    sharp = jax.tree.map(np.array, params)
    n = len(jm.cfg.mlp_dim) - 2
    last = sharp["params"]["mlp"][f"dense{n}"]
    last["kernel"] *= SHARPEN
    last["bias"] *= SHARPEN
    jr = JReconstructor(jm, jax.tree.map(jnp.asarray, sharp),
                        JOptions(resolution=RES, normal_mode="grad"))
    tr = Reconstructor(copy.deepcopy(tm),
                       Options(resolution=RES, normal_mode="grad"),
                       device="cpu")
    jr._COLOR_CHUNK = tr._COLOR_CHUNK = chunk
    jf = jr.encode(jnp.asarray(data["img"]), jnp.asarray(data["img_512"]))
    cj = jr.color_by_normals(verts, jf, jnp.asarray(data["calib"]))
    load_params(tr.model, sharp)
    with torch.no_grad():
        tf = tr.encode(torch.from_numpy(data["img"]),
                       torch.from_numpy(data["img_512"]))
    ct = tr.color_by_normals_start(verts, tf,
                                   torch.from_numpy(data["calib"]))()
    assert ct.shape == cj.shape == (V, 3)
    assert (np.ptp(cj, axis=0) > 0.5).sum() >= 2     # real normals
    _within_2(ct, cj)


@pytest.mark.parametrize("pair", ["group"], indirect=True)
def test_grad_mode_gen_mesh_matches_jax(pair, tmp_path):
    """``gen_mesh`` with ``normal_mode='grad'`` end to end (the streamed
    path): the JAX package's vertex set and colours.  The colour chunk is
    the whole mesh: GroupNorm mixes the vertices of a chunk into each
    other's gradients, and which vertices share a chunk follows the native
    marcher's vertex order, which changes from run to run in either
    package; one chunk of every vertex is the same set in both."""
    _, _, _, tm, data = pair
    V = len(Reconstructor(tm, Options(resolution=RES), device="cpu")
            .gen_mesh(data, str(tmp_path / "probe.obj"),
                      resolution=RES)["verts"])
    jout, tout = _gen_both(pair, tmp_path, "grad", V)
    assert len(tout["verts"]) == len(jout["verts"]) == V
    vj, cj, tj = _canon(str(tmp_path / "jax_grad.obj"))
    vt, ct, tt = _canon(str(tmp_path / "port_grad.obj"))
    np.testing.assert_allclose(vt, vj, atol=1e-5)
    np.testing.assert_allclose(tt, tj, atol=1e-5)
    _within_2(ct, cj)
    assert tout["points_queried"]["color"] == V
