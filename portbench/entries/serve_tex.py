"""The resident server with PIFu's texture network (``--use_color 3``),
driven as ``entries/serve.py`` drives it, which this module runs by import.

What it adds around that run:

- the program reads the configuration's checkpoint with netC added, drawn
  from the seed (``weights_tex.tex_loader``, inside ``serve``'s own
  widening of the normal nets);
- benchmark spans: ``pb.color`` around the texture map's encoding
  (``Reconstructor.encode_texture``) and each colour dispatch
  (``_chunk_dispatch``: in this cell every one is the texture field's),
  ``pb.color_query`` around each colour query (``netC.query``);
- the program's ``color_points`` / ``color_calls`` of each mesh in the
  window, and the counts the readers take: the colour chain's frozen
  per-point FLOPs, a call's bytes (``flops_tex``), netC's encoder FLOPs by
  ``FlopCounterMode`` on the reference;
- the correctness check ``reference/check_tex.py`` in place of
  ``serve``'s, on the same captures of the program's octree calls.
"""

from __future__ import annotations

import os
import time

from portbench import flops_tex as FT
from portbench import weights_tex as WT
from portbench.entries import serve as S


def run(ctx) -> dict:
    from rgbd_pifuhd_tpu_torch.cli import common
    from rgbd_pifuhd_tpu_torch.recon.pipeline import Reconstructor

    if not hasattr(Reconstructor, "encode_texture"):
        # a program without the texture network would serve --use_color 3
        # as image colours: end at once, not after a window of other work
        raise SystemExit("the program has no texture network "
                         "(--use_color 3): this cell cannot run")
    cfg, tracer = ctx["config"], ctx["tracer"]
    tex_cfg = cfg["netC"]
    meshes: list = []       # (finish time, color_points, color_calls)
    orig = (Reconstructor.gen_mesh, Reconstructor.gen_mesh_many,
            Reconstructor.__init__)

    def keep(rs):
        t = time.perf_counter()
        meshes.extend((t, r.get("color_points"), r.get("color_calls"))
                      for r in rs)

    def gen_mesh(self, *a, **kw):
        r = orig[0](self, *a, **kw)
        keep([r])
        return r

    def gen_mesh_many(self, *a, **kw):
        rs = orig[1](self, *a, **kw)
        keep(rs)
        return rs

    def init(self, *a, **kw):
        orig[2](self, *a, **kw)
        if tracer.on and self.netC is not None:
            _spans(self, tracer)

    (Reconstructor.gen_mesh, Reconstructor.gen_mesh_many,
     Reconstructor.__init__) = gen_mesh, gen_mesh_many, init
    orig_check = S._check
    S._check = _check
    try:
        with WT.tex_loader(common.ckpt, tex_cfg, ctx["seed"]):
            out = S.run(ctx)
    finally:
        (Reconstructor.gen_mesh, Reconstructor.gen_mesh_many,
         Reconstructor.__init__) = orig
        S._check = orig_check
    t0 = tracer.t0
    window = [m for m in meshes if t0 is not None and m[0] > t0]
    n_pts = sum(m[1] or 0 for m in window)
    out["data"].update(
        color_points=n_pts, color_calls=sum(m[2] or 0 for m in window),
        color_flops_per_point=FT.color_flops_per_point(tex_cfg),
        color_call_bytes=FT.color_call_bytes(tex_cfg, cfg["netG"]),
        color_point_bytes=FT.COLOR_POINT_BYTES,
        tex_encode_flops=FT.encode_flops(tex_cfg)
        if tracer.on else None)
    return out


def _spans(recon, tracer) -> None:
    """The benchmark's spans on one reconstructor's texture pass."""
    recon.encode_texture = tracer.wrap(recon.encode_texture, "pb.color")
    recon._chunk_dispatch = tracer.wrap(recon._chunk_dispatch, "pb.color")
    recon.netC.query = tracer.wrap(recon.netC.query, "pb.color_query")


def _check(ctx, cfg, pixels, copies, captures, res, device) -> dict:
    """``serve._check`` with ``check_tex.judge``: the worst of each number
    over the checked meshes.  Float32, TF32 off."""
    from portbench.reference.model import no_tf32

    with no_tf32():
        return _judge_all(ctx, cfg, pixels, copies, captures, res, device)


def _reference_tex(ctx, cfg, device):
    from portbench.reference import checkpoint as CK
    from portbench.reference import texpifu as T

    c, g = cfg["netC"], cfg["netG"]
    tex = T.TexPIFu(c["mlp_dim_color"], c["ngf_color"], c["n_blocks_color"],
                    g["load_size"], g["z_size"])
    tex.load_state_dict(CK.state_dict_from_flax(
        WT.draw_netC(c, ctx["seed"])), strict=True)
    return tex.to(device).eval().requires_grad_(False)


def _judge_all(ctx, cfg, pixels, copies, captures, res, device) -> dict:
    from portbench.reference import check_tex as CT

    _, net = S._reference(ctx, cfg, device)
    tex = _reference_tex(ctx, cfg, device)
    worst: dict = {"missing_meshes": 0}
    for key, path in sorted(copies.items()):
        if key not in captures or not os.path.exists(path):
            worst["missing_meshes"] += 1
            continue
        _, rgb, dep = pixels[key[1]]
        got = CT.judge(net, tex, rgb, dep, path, res, device,
                       captures.pop(key), control=ctx.get("control", False))
        os.remove(path)
        for k, v in got.items():
            # the colours' spread: the least over the checked meshes
            pick = min if k == "tex_color_std" else max
            worst[k] = pick(worst.get(k, v), v)
    worst["checked"] = len(copies) - worst["missing_meshes"]
    return worst
