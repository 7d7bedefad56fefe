"""Flagship-lite (42.6 M params, bf16 compute, GroupNorm MLPs) in both
packages on the CPU: the capsule subject encoded at 512^2 and one field
query chunk of 8192 points, the port's plain path against the JAX main
path.  Slow (two full-width encodes on the CPU), so not in tier 1.

bf16 tolerance: the two frameworks round bf16 convolutions and matmuls in
other orders, so features differ by bf16 ulps from the first conv on; the
occupancy of this chunk is compared at atol 0.1 with 99% of points within
0.01 (measured on the CPU: max 0.049, p99 0.0034)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_pifuhd_tpu.models import MultiResPIFu as JMultiResPIFu
from rgbd_pifuhd_tpu.utils.checkpoint import load_checkpoint as jload
from rgbd_pifuhd_tpu.utils.options import Options as JOptions
from rgbd_pifuhd_tpu_torch.data.synthetic import capsule_subject
from rgbd_pifuhd_tpu_torch.models import MultiResPIFu
from rgbd_pifuhd_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                     load_params)
from rgbd_pifuhd_tpu_torch.utils.options import Options

CKPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "bench_flagship_lite", "ckpt")


@pytest.mark.slow
def test_flagship_lite_query_chunk_bf16():
    rgbd, calib, verts, _ = capsule_subject(512)
    rng = np.random.default_rng(0)
    lo, hi = verts.min(0) - 10, verts.max(0) + 10
    pts = rng.uniform(lo, hi, (1, 1, 8192, 3)).astype(np.float32)
    img = rgbd[None]

    state = jload(CKPT)
    jopt = JOptions.from_dict(state["opt"])
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                          state["params"])
    jm = JMultiResPIFu(cfg=jopt.netMR, cfg_global=jopt.netG)
    gf = jm.apply(params, jnp.asarray(img), last_only=True,
                  method=JMultiResPIFu.filter_global)
    lf = jm.apply(params, jnp.asarray(img)[None], gf, last_only=True,
                  method=JMultiResPIFu.filter_local)
    c = jnp.asarray(calib)
    ref = np.asarray(jm.apply(params, lf, gf, jnp.asarray(pts),
                              c[None, None], c[None],
                              method=JMultiResPIFu.query).preds)

    tstate = load_checkpoint(CKPT, device="cpu")
    opt = Options.from_dict(tstate["opt"])
    tm = MultiResPIFu(opt.netMR, opt.netG, device="cpu")
    load_params(tm, tstate["params"])
    tc = torch.from_numpy(calib)
    with torch.no_grad():
        tgf = tm.filter_global(torch.from_numpy(img), last_only=True)
        tlf = tm.filter_local(torch.from_numpy(img)[None], tgf,
                              last_only=True)
        got = tm.query(tlf, tgf, torch.from_numpy(pts), tc[None, None],
                       tc[None]).preds.numpy()
    d = np.abs(got - ref)
    print(f"flagship-lite bf16 chunk: max |d| {d.max():.4g}, "
          f"p99 {np.quantile(d, 0.99):.4g}")
    assert d.max() < 0.1 and np.quantile(d, 0.99) < 0.01
