"""Judges the program's first training steps against the plain reference.

From the same initial weights (drawn by the benchmark) the reference works
out again each kept batch's tensors from the tree's pixels (the item is
found by its image), the labels of the program's sample points from the
subject's mesh (generalised winding number), the coarse objective, its
gradient and RMSprop's update (optax's arithmetic: ``nu = 0.99 nu +
0.01 g^2`` from 0, ``p -= lr g / sqrt(nu + 1e-8)``), in float32 with TF32
off, and compares:

- ``loss_gap_1`` / ``loss_gap``: the relative gap of the first step's
  loss / the largest over the steps;
- ``grad_gap_med`` / ``grad_gap``: over the leaves, the median / the
  largest gap between the norm of the program's first gradient (from its
  optimiser's state) and the reference's, over the larger of the leaf's
  reference norm and the median leaf's;
- ``change_gap_med`` / ``change_gap``: the same for the norm of each
  leaf's change over the steps;
- ``label_miss``: share of the program's labels that differ from the
  reference's, leaving out the points within 1e-3 of the surface
  (``label_near`` counts them), whose label float32 storage does not keep;
- ``reader_gap`` / ``calib_gap``: the largest gap of the batch's images /
  calibration against the reference's.

Leaves whose reference gradient is under a thousandth of the median leaf's
(the normal nets, which get none) are left out of both gaps.  With
``control`` the numbers are the control's (the reference one precision
below the configuration's) in the program's place.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import model as M
from .check_mesh import half_size_u8


def winding_inside(points: torch.Tensor, verts: torch.Tensor,
                   faces: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """Points inside a closed triangle mesh: |generalised winding number|
    above 0.5 (float64)."""
    tri = verts[faces]                                   # [F, 3, 3]
    out = []
    for s in range(0, len(points), block):
        p = points[s:s + block, None, None, :]           # [B, 1, 1, 3]
        d = tri[None] - p                                # [B, F, 3, 3]
        a, b, c = d[..., 0, :], d[..., 1, :], d[..., 2, :]
        la, lb, lc = (x.norm(dim=-1) for x in (a, b, c))
        num = (a * torch.cross(b, c, dim=-1)).sum(-1)
        den = (la * lb * lc + (a * b).sum(-1) * lc + (a * c).sum(-1) * lb
               + (b * c).sum(-1) * la)
        w = 2.0 * torch.atan2(num, den)
        out.append(w.sum(-1).abs() / (4 * math.pi) > 0.5)
    return torch.cat(out)


def near_surface(points: torch.Tensor, verts, faces, eps: float = 1e-3):
    """Points within ``eps`` of the surface along an axis (their label
    changes under a step of ``eps``): the program labels its samples before
    storing them in float32, so there no label is kept by the data."""
    inside = winding_inside(points, verts, faces)
    near = torch.zeros_like(inside)
    for a in range(3):
        for sgn in (-1.0, 1.0):
            d = torch.zeros(3, dtype=points.dtype, device=points.device)
            d[a] = sgn * eps
            near |= winding_inside(points + d, verts, faces) != inside
    return inside, near


def _items(pixels: dict):
    """Every tree item: its reference ``img_512 [512, 512, 6]`` in
    [-1, 1], calib and subject kind."""
    from portbench.gen.subjects import calib_of

    out = []
    for name, (kind, yaw, imgs, dep3) in pixels.items():
        d = half_size_u8(dep3)
        calib = torch.from_numpy(calib_of(1024, yaw)).float()
        for comp in imgs:
            x = np.concatenate([half_size_u8(comp), d], -1).astype(
                np.float32) / 255.0 * 2 - 1
            out.append((torch.from_numpy(x), calib, kind))
    return out


def _run(net, batches, lr, gamma, count_flops=False):
    """The reference's steps: ``(losses, first-gradient norms, flops of a
    step)``."""
    from portbench.flops import counted_flops

    nu = {n: torch.zeros_like(p) for n, p in net.named_parameters()}
    losses, gnorm, flops = [], None, None
    for i, b in enumerate(batches):
        net.zero_grad(set_to_none=True)

        def fwd_bwd():
            loss = net.loss(*b, gamma)
            loss.backward()
            return loss

        if i == 0 and count_flops:
            flops = counted_flops(fwd_bwd)
            net.zero_grad(set_to_none=True)
        loss = fwd_bwd()
        losses.append(float(loss.detach()))
        if i == 0:
            gnorm = {n: float(p.grad.norm()) if p.grad is not None else 0.0
                     for n, p in net.named_parameters()}
        with torch.no_grad():
            for n, p in net.named_parameters():
                if p.grad is None:
                    continue
                nu[n].mul_(0.99).add_(0.01 * p.grad * p.grad)
                p.sub_(lr * p.grad / torch.sqrt(nu[n] + 1e-8))
    return losses, gnorm, flops


def _leaf_gaps(prog: dict, ref: dict, counted) -> list:
    med = float(np.median([ref[n] for n in counted]))
    return [abs(prog[n] - ref[n]) / max(ref[n], med) for n in counted]


def check(*args, **kw):
    """``(numbers, FLOPs of one step)``, in float32 with TF32 off."""
    with M.no_tf32():
        return _check(*args, **kw)


def _check(cfg, p0, names, kept, losses, grad_norms, change_norms,
           pixels, gamma, dev, control=False, count_flops=False):
    from portbench.gen.subjects import body_mesh

    items = _items(pixels)
    meshes = {}
    batches = []
    out = {"reader_gap": 0.0, "calib_gap": 0.0, "label_miss": 0.0}
    n_lab = 0
    for b in kept:
        img = b["images"][0]
        gaps = [float((img - x[0]).abs().max()) for x in items]
        j = int(np.argmin(gaps))
        ref_img, calib, kind = items[j]
        out["reader_gap"] = max(out["reader_gap"], gaps[j])
        got_calib = b["calibs"][0]
        out["calib_gap"] = max(out["calib_gap"],
                               float((got_calib - calib).abs().max()))
        if kind not in meshes:
            v, f = body_mesh(kind)
            meshes[kind] = (torch.from_numpy(v).to(dev),
                            torch.from_numpy(f).to(dev))
        pts = b["points"].reshape(-1, 3).to(dev)
        inside, near = near_surface(pts.double(), *meshes[kind])
        lab = inside.float()[:, None]
        miss = (lab.cpu() != b["labels"].reshape(-1, 1))[:, 0] & ~near.cpu()
        out["label_miss"] += float(miss.sum())
        out["label_near"] = out.get("label_near", 0) + int(near.sum())
        n_lab += len(lab)
        batches.append((ref_img[None].to(dev), pts[None].float(),
                        calib[None].to(dev), lab[None]))
    out["label_miss"] /= max(n_lab, 1)

    def fresh():
        net = M.Coarse(cfg["netG"]).to(dev)
        net.load_state_dict({n: p0[n] for n in names}, strict=True)
        return net

    lr = cfg["learning_rate"]
    net = fresh()
    r_loss, r_grad, flops = _run(net, batches, lr, gamma, count_flops)
    r_change = {n: float((p.detach().cpu() - p0[n]).norm())
                for n, p in net.named_parameters()}
    del net
    if control:
        net = fresh()
        with M.precision("control"):
            losses, grad_norms, _ = _run(net, batches, lr, gamma)
        change_norms = {n: float((p.detach().cpu() - p0[n]).norm())
                        for n, p in net.named_parameters()}
        del net
    med = float(np.median([g for g in r_grad.values() if g > 0]))
    counted = [n for n in names if r_grad[n] >= 1e-3 * med]
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, r_loss)]
    out["loss_gap"] = max(gaps)
    out["loss_gap_1"] = gaps[0]
    g = _leaf_gaps(grad_norms, r_grad, counted)
    c = _leaf_gaps(change_norms, r_change, counted)
    out["grad_gap"], out["grad_gap_med"] = max(g), float(np.median(g))
    out["change_gap"], out["change_gap_med"] = max(c), float(np.median(c))
    out["leaves_counted"] = len(counted)
    out["steps"] = len(r_loss)
    return out, flops
