"""Judges a served mesh (a coloured OBJ) against the plain reference.

The reference works the subject's tensors out again from its pixels, and
the encoders and the two-level field from the checkpoint, in float32.  The
field is a GroupNorm MLP: its statistics are taken over each call's points,
so a point's value depends on the call it is in.  The reference therefore
judges the program's field call by call, at the calls' own points: the
octree's first phase (the 65^3 stride-8 corners in one call, padded to a
multiple of 1,024 by repeating the last: the same points whatever the
field, so the reference works them out itself) and every band of its third
phase (4,096 sub-cells x 64 points a call; which sub-cells, the program's
own choice, is read from the program's call, as a served model's tokens
are read from its reply).  The numbers:

- ``p1_level_share2`` / ``p3_level_share2``: share of the corners / band
  points whose 4-bit band level (``round(15 clamp((f - 0.5) 4 + 0.5))``,
  the program's quantisation) differs from the reference's by 2 or more;
- ``active_miss``: share of the stride-8 cells that the reference's corners
  mark as active by a margin (max - min > 0.1) that the program did not
  refine;
- ``vertex_off``: mesh vertices on no unit edge of the lattice, and those
  on an edge whose two ends the program refined that do not sit where the
  program's own levels cross 0.5 (to 0.05 voxel) or sit on an edge that
  does not cross;
- ``edge_missing``: edges between refined points whose levels cross 0.5
  that hold no vertex;
- ``nml_cell_deg``: over the vertices where the reference's field changes
  by more than ``STEEP`` across the fd taps, the mean angle between the
  OBJ's colour normals and the reference's fd normals (quantised as the
  program quantises them) summed over each stride-8 cell.  The colour pass
  is grouped as the program groups it (4 x 65,536 vertices in file order,
  each group quantised to uint16 on its own box, the last padded with rows
  at the box's low corner), so each chunk's taps are one call here too;
- ``bad_faces``: faces that index no vertex, plus vertices no face uses.

The control (``control=True``) is the reference computed one precision
below the configuration's (``reference.model.precision``) in the program's
place, in the same calls: its levels and its normals are judged as the
program's are; the mesh checks judge the program's marcher and writer and
read nothing of the control.
"""

from __future__ import annotations

import numpy as np
import torch

from . import model as M

CHUNK = 65536
DELTA = 1e-3


def read_obj(path: str):
    """``(verts [V, 3] f64, colours [V, 3] f64, faces [F, 3] int64)`` of an
    OBJ made of ``v x y z r g b`` and ``f a b c`` lines."""
    with open(path, "rb") as f:
        data = f.read()
    cut = data.find(b"\nf ")
    vtxt, ftxt = (data, b"") if cut < 0 else (data[:cut + 1], data[cut + 1:])
    v = np.fromstring(vtxt.replace(b"v", b" ").decode(), np.float64,
                      sep=" ").reshape(-1, 6)
    f = np.fromstring(ftxt.replace(b"f", b" ").decode(), np.int64,
                      sep=" ").reshape(-1, 3)
    return v[:, :3], v[:, 3:], f - 1


def half_size_u8(a: np.ndarray) -> np.ndarray:
    """OpenCV's bilinear resize to exactly half size: the mean of each 2x2
    block, halves rounded up."""
    s = a.astype(np.int32)
    s = s[0::2, 0::2] + s[1::2, 0::2] + s[0::2, 1::2] + s[1::2, 1::2]
    return ((s + 2) >> 2).astype(np.uint8)


def reader_tensors(rgb: np.ndarray, depth: np.ndarray, device):
    """The subject's tensors as the inference reader defines them, for a
    whole-frame rect at the load size: ``img [1, H, W, 6]``, ``img_512
    [1, 512, 512, 6]`` in [-1, 1] and the y-flip calib."""
    if rgb.shape[0] != 1024 or rgb.shape[1] != 1024:
        raise ValueError("the reference reader takes 1024^2 subjects")

    def stack(r, d):
        x = np.concatenate([r, d], -1).astype(np.float32) / 255.0 * 2 - 1
        return torch.from_numpy(x)[None].to(device)

    calib = torch.diag(torch.tensor([1.0, -1.0, 1.0, 1.0]))[None].to(device)
    return (stack(rgb, depth), stack(half_size_u8(rgb), half_size_u8(depth)),
            calib)


def load_model(payload: dict, device) -> M.MultiRes:
    from .checkpoint import state_dict_from_flax

    opt = payload["opt"]
    net = M.MultiRes(opt["netMR"], opt["netG"])
    net.load_state_dict(state_dict_from_flax(payload["params"]), strict=True)
    return net.to(device).eval().requires_grad_(False)


def _corners(res: int, device):
    n1 = res // 8 + 1
    i = torch.arange(n1, device=device) * 8
    g = torch.stack(torch.meshgrid(i, i, i, indexing="ij"), -1).reshape(-1, 3)
    g = torch.clamp(g, max=res - 1)
    pad = -(-len(g) // 1024) * 1024
    g = torch.cat([g, g[-1:].expand(pad - len(g), 3)])
    ndc = g.float() * (2.0 / res) - 1.0
    return ndc * torch.tensor([1.0, -1.0, 1.0], device=device), n1


def corner_field(net, feats, calib, res: int):
    """``[n1, n1, n1]`` field on the stride-8 corner lattice (one call)."""
    pts, n1 = _corners(res, calib.device)
    pred, mask = net.fine(feats[0], feats[1], pts[None], calib)
    return (pred * mask)[0, :n1 ** 3].reshape(n1, n1, n1)


def _chunks(V: int):
    """``(row0, rows, padded chunks)`` of the program's colour groups."""
    g = 4 * CHUNK
    out = []
    for r0 in range(0, V, g):
        rows = min(g, V - r0)
        out.append((r0, rows, 4 if rows == g else -(-rows // CHUNK)))
    return out


def _quantized(v: np.ndarray, rows_padded: int) -> np.ndarray:
    """uint16 fixed point on the group's box, dequantised; padding rows at
    the box's low corner."""
    v = v.astype(np.float32)
    lo, hi = v.min(0), v.max(0)
    scale = np.maximum((hi - lo) / np.float32(65535.0), np.float32(1e-12))
    q = np.clip(np.floor((v - lo) * (np.float32(1.0) / scale)
                         + np.float32(0.5)), 0, 65535)
    out = np.zeros((rows_padded, 3), np.float32)
    out[:len(v)] = q.astype(np.float32) * scale
    return out + lo


def vertex_field(net, feats, calib, verts: np.ndarray):
    """fd normals ``[V, 3]`` and where the field is steep across the taps
    ``[V]``, chunk by chunk as the program's colour pass groups them."""
    dev = calib.device
    off = torch.cat([torch.zeros(1, 3), torch.eye(3) * DELTA]).to(dev)
    nmls, steep = [], []
    for r0, rows, k in _chunks(len(verts)):
        q = torch.from_numpy(_quantized(verts[r0:r0 + rows],
                                        k * CHUNK)).to(dev)
        for j in range(k):
            p = q[j * CHUNK:(j + 1) * CHUNK]
            taps = (p[:, None, :] + off).reshape(1, -1, 3)
            pred, _ = net.fine(feats[0], feats[1], taps, calib)
            pred = pred.reshape(-1, 4)
            nml = -(pred[:, 1:] - pred[:, :1])
            norm = torch.linalg.norm(nml, dim=-1, keepdim=True)
            nmls.append(nml / torch.clamp(norm, min=1e-8))
            steep.append(norm[:, 0] > STEEP)
        # only the group's own rows
        n_pad = k * CHUNK - rows
        if n_pad:
            for x in (nmls, steep):
                x[-1] = x[-1][:CHUNK - n_pad]
    return torch.cat(nmls), torch.cat(steep)


def levels(nml: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(nml * 0.5 + 0.5, 0, 1) * 255.0)


STEEP = 0.05


def _lut(q: torch.Tensor) -> torch.Tensor:
    return (q.float() / 15.0 - 0.5) / 4.0 + 0.5


def band_levels(occ: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp((occ - 0.5) * 4.0 + 0.5, 0, 1) * 15.0)


def _unpack4(p: torch.Tensor) -> torch.Tensor:
    """``[B, 32]`` packed bytes -> ``[B, 64]`` levels (low nibble first)."""
    p = p.to(torch.int32)
    return torch.stack([p & 15, p >> 4], -1).reshape(p.shape[0], 64)



def _offsets(dev):
    i = torch.arange(4, device=dev)
    return torch.stack(torch.meshgrid(i, i, i, indexing="ij"),
                       -1).reshape(64, 3)


def _world(idx: torch.Tensor, res: int) -> torch.Tensor:
    ndc = idx.float() * (2.0 / res) - 1.0
    return ndc * torch.tensor([1.0, -1.0, 1.0], device=idx.device)


def band_field(net, feats, calib, bases, res):
    """The reference's band levels ``[B, 64]`` at a band's points."""
    pts = (bases[:, None, :] + _offsets(bases.device)[None]).reshape(-1, 3)
    pred, mask = net.fine(feats[0], feats[1], _world(pts, res)[None], calib)
    return band_levels((pred * mask)[0]).reshape(len(bases), 64)


def refined_volume(bands, res, dev):
    """Dense ``[res^3]`` levels of the program's refined points (255 where
    the program refined nothing)."""
    vol = torch.full((res ** 3,), 255, dtype=torch.uint8, device=dev)
    off = _offsets(dev)
    for bases, packed in bands:
        idx = (bases[:, None, :].to(dev) + off[None]).reshape(-1, 3).long()
        lin = (idx[:, 0] * res + idx[:, 1]) * res + idx[:, 2]
        vol[lin] = _unpack4(packed.to(dev)).reshape(-1).to(torch.uint8)
    return vol


def mesh_vs_levels(verts: np.ndarray, vol: torch.Tensor, res: int):
    """``(vertex_off, edge_missing, judged)`` of the mesh against the
    program's own refined levels."""
    dev = vol.device
    c = torch.from_numpy((verts * np.array([1.0, -1.0, 1.0]) + 1.0)
                         * res / 2).to(dev)
    near = (c - torch.round(c)).abs() < 0.02
    axis_ok = (~near).sum(1) == 1
    axis = torch.argmax((~near).int(), 1)
    p0 = torch.where(near, torch.round(c), torch.floor(c)).long()
    inb = ((p0 >= 0) & (p0 < res)).all(1)
    e = torch.nn.functional.one_hot(axis, 3)
    p1 = p0 + e
    inb &= (p1 < res).all(1)
    ok = axis_ok & inb
    p0c, p1c = p0.clamp(0, res - 1), p1.clamp(0, res - 1)
    lin = lambda p: (p[:, 0] * res + p[:, 1]) * res + p[:, 2]  # noqa: E731
    l0, l1 = vol[lin(p0c)].int(), vol[lin(p1c)].int()
    judged = ok & (l0 != 255) & (l1 != 255)
    cross = (l0 >= 8) != (l1 >= 8)
    v0, v1 = _lut(l0), _lut(l1)
    t_exp = (0.5 - v0) / torch.where(v1 != v0, v1 - v0, torch.ones_like(v0))
    t = (c - p0.double()).gather(1, axis[:, None])[:, 0].float()
    off = judged & (~cross | ((t - t_exp).abs() > 0.05))
    # a marched vertex lies on a unit edge: two fractional coordinates is
    # one that no marcher put there
    off |= (~near).sum(1) >= 2
    keys = torch.unique(lin(p0c)[judged] * 3 + axis[judged])
    missing = 0
    v3 = vol.reshape(res, res, res).int()
    for a in range(3):
        sl0 = [slice(None)] * 3
        sl1 = [slice(None)] * 3
        sl0[a], sl1[a] = slice(0, res - 1), slice(1, res)
        x0, x1 = v3[tuple(sl0)], v3[tuple(sl1)]
        m = (x0 != 255) & (x1 != 255) & ((x0 >= 8) != (x1 >= 8))
        idx = torch.nonzero(m)
        k = ((idx[:, 0] * res + idx[:, 1]) * res + idx[:, 2]) * 3 + a
        missing += int((~torch.isin(k, keys)).sum())
    return int(off.sum()), missing, int(judged.sum())


def cell_normal_deg(verts: np.ndarray, lv: torch.Tensor, lv_ref: torch.Tensor,
                    sel: torch.Tensor, res: int, min_count: int = 16):
    """Mean angle (degrees) between the summed colour normals of the
    program and of the reference over each stride-8 cell holding at least
    ``min_count`` selected vertices: the rounding noise of
    single normals averages out, a rotated or wrong field does not."""
    dev = lv.device
    n = res // 8
    c = np.clip(np.floor((verts * np.array([1.0, -1.0, 1.0]) + 1.0)
                         * res / 16), 0, n - 1).astype(np.int64)
    cell = torch.from_numpy(c[:, 0] * n * n + c[:, 1] * n + c[:, 2]).to(dev)
    cell = cell[sel]
    sums = []
    for x in (lv, lv_ref):
        v = x[sel].double() / 255.0 * 2 - 1
        sums.append(torch.zeros(n ** 3, 3, dtype=torch.float64,
                                device=dev).index_add_(0, cell, v))
    cnt = torch.bincount(cell, minlength=n ** 3)
    keep = cnt >= min_count
    if not bool(keep.any()):
        return 0.0
    a, b = (torch.nn.functional.normalize(s[keep], dim=-1) for s in sums)
    cos = (a * b).sum(-1).clamp(-1.0, 1.0)
    return float(torch.rad2deg(torch.acos(cos)).mean())


def judge(net, rgb, depth, obj_path: str, res: int, device, capture: dict,
          control: bool = False) -> dict:
    """The numbers of one mesh: the program's, or with ``control`` the
    control's field in the program's place.  ``capture`` holds the
    program's calls: ``p1`` (corner levels, refined cell ids) and ``bands``
    (``[(bases, packed levels)]``)."""
    img, img_g, calib = reader_tensors(rgb, depth, device)
    verts, cols, faces = read_obj(obj_path)
    out = {"verts": len(verts), "faces": len(faces)}
    bad = int(((faces < 0) | (faces >= len(verts))).any(1).sum())
    used = np.zeros(len(verts), bool)
    used[faces[(faces >= 0) & (faces < len(verts))]] = True
    out["bad_faces"] = bad + int((~used).sum())
    # reported, not compared: the share of the mesh on walls at the
    # volume's faces (within a voxel of the grid's first or last index)
    c = (verts * np.array([1.0, -1.0, 1.0]) + 1.0) * res / 2
    wall = ((c <= 1.0) | (c >= res - 2.0)).any(1)
    whole = faces[((faces >= 0) & (faces < len(verts))).all(1)]
    out["wall_vert_share"] = float(wall.mean()) if len(verts) else 0.0
    out["wall_face_share"] = (float(wall[whole].all(1).mean())
                              if len(whole) else 0.0)
    corner_q, top8 = capture["p1"]
    with torch.inference_mode():
        feats = net.encode(img, img_g)
        corners = corner_field(net, feats, calib, res)
        nml_ref, steep = vertex_field(net, feats, calib, verts)
        n1 = res // 8 + 1
        st = torch.stack([corners[a:a + n1 - 1, b:b + n1 - 1, d:d + n1 - 1]
                          for a in (0, 1) for b in (0, 1) for d in (0, 1)])
        act = (st.amax(0) - st.amin(0)).reshape(-1) > 0.1
        refined = torch.zeros_like(act)
        refined[top8.to(device).long()] = True
        out["active_miss"] = float((act & ~refined).sum()) / max(
            int(act.sum()), 1)
        bands = capture["bands"]
        r1 = band_levels(corners)
        if control:
            with M.precision("control"):
                feats_c = net.encode(img, img_g)
                q1 = band_levels(corner_field(net, feats_c, calib, res))
                nml_p, _ = vertex_field(net, feats_c, calib, verts)
                lv = levels(nml_p)
                p3 = [band_field(net, feats_c, calib, b.to(device), res)
                      for b, _ in bands]
        else:
            q1 = corner_q.to(device).float().reshape(r1.shape)
            lv = torch.from_numpy(np.rint(cols * 255.0)).to(device)
            p3 = [_unpack4(p.to(device)).float() for _, p in bands]
        out["p1_level_share2"] = float(((q1 - r1).abs() >= 2).float().mean())
        n2 = tot = 0
        for (b, _), got in zip(bands, p3):
            ref = band_field(net, feats, calib, b.to(device), res)
            n2 += int(((got - ref).abs() >= 2).sum())
            tot += ref.numel()
        out["p3_level_share2"] = n2 / max(tot, 1)
        out["nml_cell_deg"] = cell_normal_deg(verts, lv, levels(nml_ref),
                                              steep, res)
        vol = refined_volume(bands, res, device)
        off, missing, judged = mesh_vs_levels(verts, vol, res)
    out["vertex_off"] = off
    out["edge_missing"] = missing
    out["judged_share"] = judged / max(len(verts), 1)
    return out
