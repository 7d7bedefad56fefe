"""Judges a served texture-coloured mesh (a coloured OBJ of ``--use_color
3``) against the plain references: the two-level field of ``model`` and
PIFu's texture network of ``texpifu``, in float32.

The geometry is held as ``check_mesh`` holds the fd-coloured cell's, with
the same numbers: the octree's first phase and every third-phase band
recomputed at the program's own points (``p1_level_share2``,
``p3_level_share2``, ``active_miss``), the mesh against the program's own
refined levels (``vertex_off``, ``edge_missing``), the file
(``bad_faces``).

The colours: the reference recomputes netG's last stack, the texture
filter and the attached map from the subject's pixels, and the colour of
every vertex of the program's OBJ, in the groups the program colours them
(4 x 65,536 vertices in file order, each group quantised to uint16 on its
own box, as ``check_mesh.vertex_field``), quantised to uint8 as the program
quantises them (``round(255 (pred / 2 + 1 / 2))``).  Per vertex channel the
level difference to the OBJ's:

- ``tex_level_share8``: share of channels eight or more levels off (the
  compared colour number);
- reported only: ``tex_level_share2`` (two or more levels off: the sound
  bf16 runs read 0.019-0.291, too near the faults' 0.43 for a limit
  between them; the program's own colour chain at float32 compute reads
  0.0002-0.0006 at the published widths, so that is the bf16 layers'
  rounding carried through the seeded netC's steep colours),
  ``tex_level_worst`` (the largest), ``tex_color_std`` (the spread of the
  OBJ's colours in [0, 1]: the seeded weights must colour, not paint one
  grey) and ``tex_saturated_share`` (channels at 0 or 255).

The control (``control=True``) computes the field and the colours one
precision below the configuration's (``model.precision`` and
``texpifu.precision``: float8 e4m3 operands for the bfloat16 layers) in the
program's place, at the program's vertices.
"""

from __future__ import annotations

import numpy as np
import torch

from . import check_mesh as CM
from . import model as M
from . import texpifu as T


def vertex_levels(tex: T.TexPIFu, feat, calib, verts: np.ndarray):
    """uint8 colour levels ``[V, 3]`` of ``verts``, group by group as the
    program colours them."""
    dev = calib.device
    out = []
    for r0, rows, k in CM._chunks(len(verts)):
        q = torch.from_numpy(CM._quantized(verts[r0:r0 + rows],
                                           k * CM.CHUNK)).to(dev)
        for j in range(-(-rows // CM.CHUNK)):
            n = min(CM.CHUNK, rows - j * CM.CHUNK)
            out.append(T.levels(tex.query(feat, q[j * CM.CHUNK:
                                                  j * CM.CHUNK + n], calib)))
    return torch.cat(out) if out else torch.zeros((0, 3), device=dev)


def judge(net, tex, rgb, depth, obj_path: str, res: int, device,
          capture: dict, control: bool = False) -> dict:
    """The numbers of one mesh; ``capture`` holds the program's octree
    calls (``p1``, ``bands``), as ``check_mesh.judge`` takes them."""
    img, img_g, calib = CM.reader_tensors(rgb, depth, device)
    verts, cols, faces = CM.read_obj(obj_path)
    out = {"verts": len(verts), "faces": len(faces)}
    bad = int(((faces < 0) | (faces >= len(verts))).any(1).sum())
    used = np.zeros(len(verts), bool)
    used[faces[(faces >= 0) & (faces < len(verts))]] = True
    out["bad_faces"] = bad + int((~used).sum())
    corner_q, top8 = capture["p1"]
    bands = capture["bands"]
    with torch.inference_mode():
        feats = net.encode(img, img_g)
        corners = CM.corner_field(net, feats, calib, res)
        n1 = res // 8 + 1
        st = torch.stack([corners[a:a + n1 - 1, b:b + n1 - 1, d:d + n1 - 1]
                          for a in (0, 1) for b in (0, 1) for d in (0, 1)])
        act = (st.amax(0) - st.amin(0)).reshape(-1) > 0.1
        refined = torch.zeros_like(act)
        refined[top8.to(device).long()] = True
        out["active_miss"] = float((act & ~refined).sum()) / max(
            int(act.sum()), 1)
        r1 = CM.band_levels(corners)
        feat = tex.attach(tex.filter(img_g[..., :3]), feats[1])
        ref = vertex_levels(tex, feat, calib[0], verts)
        if control:
            with M.precision("control"), T.precision("control"):
                feats_c = net.encode(img, img_g)
                q1 = CM.band_levels(CM.corner_field(net, feats_c, calib,
                                                    res))
                p3 = [CM.band_field(net, feats_c, calib, b.to(device), res)
                      for b, _ in bands]
                feat_c = tex.attach(tex.filter(img_g[..., :3]), feats_c[1])
                got = vertex_levels(tex, feat_c, calib[0], verts)
        else:
            q1 = corner_q.to(device).float().reshape(r1.shape)
            p3 = [CM._unpack4(p.to(device)).float() for _, p in bands]
            got = torch.from_numpy(np.rint(cols * 255.0)).to(device).float()
        out["p1_level_share2"] = float(((q1 - r1).abs() >= 2).float().mean())
        n2 = tot = 0
        for (b, _), lv in zip(bands, p3):
            want = CM.band_field(net, feats, calib, b.to(device), res)
            n2 += int(((lv - want).abs() >= 2).sum())
            tot += want.numel()
        out["p3_level_share2"] = n2 / max(tot, 1)
        diff = (got - ref).abs()
        n = max(diff.numel(), 1)
        out["tex_level_share2"] = float((diff >= 2).sum()) / n
        out["tex_level_share8"] = float((diff >= 8).sum()) / n
        out["tex_level_worst"] = float(diff.max()) if diff.numel() else 0.0
        out["tex_color_std"] = float(np.std(cols)) if len(cols) else 0.0
        out["tex_saturated_share"] = float(
            ((got == 0) | (got == 255)).float().mean()) if len(cols) else 0.0
        vol = CM.refined_volume(bands, res, device)
        off, missing, judged = CM.mesh_vs_levels(verts, vol, res)
    out["vertex_off"] = off
    out["edge_missing"] = missing
    out["judged_share"] = judged / max(len(verts), 1)
    return out
