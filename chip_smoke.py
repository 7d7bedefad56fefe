#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rgbd_pifuhd_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, one
line each; any failure exits non-zero:

1. environment: card, torch/CUDA versions, TF32 settings (both off);
2. build: the CUDA kernel (nvcc, sm_90a) and the native host libraries
   (g++), started together, from the sources in the checkout;
3. kernel against its plain PyTorch version on the card, at the main
   path's shapes, both GroupNorm scopes, f32 and bf16, plus a ragged N and
   a narrow norm-free chain;
4. main path: flagship-lite ``gen_mesh`` at 512^3 on the capsule subject,
   three times (warm-up + two timed), every field query through the
   kernel (launch count checked), OBJ checked;
5. times (CUDA events) of the kernel and its plain version at the main
   path's shapes, beside the card's bound for the same work.

The last three lines are the card's name and power limit (nvidia-smi), the
``kernels`` JSON line, and ``{"ok": true, "device": {...}}``.
``--profile`` adds one gen_mesh under ``torch.profiler`` and prints
device time by kernel and the device's busy share.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(HERE, "assets", "bench_flagship_lite", "ckpt")
OUT_DIR = os.path.join(HERE, "smoke_out")    # listed in .gitignore
PEAK_BF16 = 989e12      # H100 SXM dense bf16 FLOP/s
HBM_BPS = 3.35e12       # H100 SXM HBM3 bytes/s
TOL_F32 = 1e-4
# bf16: the kernel and the plain version sum in different orders, so a
# pre-rounding value can land on the other side of a bf16 rounding edge and
# move one bf16 ulp (2^-8 relative) at a layer's output; that step carries
# through the remaining layers.  Tolerances set from the spread measured on
# the H100 (PERF.md, "Kernel against plain version").
TOL_BF16_PRED = 2e-2
TOL_BF16_PHI = 1.5e-1


def fail(msg: str) -> None:
    print(f"[FAIL] {msg}", flush=True)
    sys.exit(1)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not os.path.isdir(os.path.join(HERE, "rgbd_pifuhd_tpu_torch")):
        fail("run from a checkout of the repository (package not found)")
    sys.path.insert(0, HERE)

    # ---- 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout else \
        "nvidia-smi unavailable"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda")
    phase("env", f"{smi_line} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | devices {torch.cuda.device_count()} | "
          f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32} | cudnn deterministic="
          f"{torch.backends.cudnn.deterministic}")

    # ---- 2. build (nvcc and g++ together)
    from rgbd_pifuhd_tpu_torch import native
    from rgbd_pifuhd_tpu_torch.ops import fused_query as fq

    t0 = time.time()
    errs: list = []
    logs: dict = {}

    def run(name, fn):
        try:
            logs[name] = fn()
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append((name, e))

    threads = [threading.Thread(target=run, args=("nvcc", fq.build)),
               threading.Thread(target=run, args=("g++", native.build_all))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        fail(f"build failed: {errs[0][0]}: {errs[0][1]}")
    ptxas = [ln.strip() for ln in (logs.get("nvcc") or "").splitlines()
             if "registers" in ln or "spill" in ln]
    phase("build", f"fused_query.cu + marching.cc + meshio.cc built in "
          f"{time.time() - t0:.1f} s; ptxas: {' || '.join(ptxas)}")

    # ---- model (weights for phases 3-5)
    from rgbd_pifuhd_tpu_torch.models import MultiResPIFu
    from rgbd_pifuhd_tpu_torch.models.mlp import PointMLP
    from rgbd_pifuhd_tpu_torch.utils.checkpoint import (
        load_checkpoint, load_params, restore_options)
    from rgbd_pifuhd_tpu_torch.utils.options import Options

    t0 = time.time()
    ckpt = load_checkpoint(CKPT, device=dev)
    opt, _ = restore_options(Options(), ckpt)
    model = MultiResPIFu(opt.netMR, opt.netG, device=dev)
    load_params(model, ckpt["params"])
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    phase("model", f"flagship-lite loaded in {time.time() - t0:.1f} s: "
          f"{n_params} params, compute {opt.netG.compute_dtype}, mlp_norm "
          f"{opt.netG.mlp_norm}")

    # ---- 3. kernel against plain version
    kres = kernel_checks(torch, fq, model, PointMLP, dev)

    # ---- 4. main path
    launches = main_path(torch, fq, model, opt, dev)

    if "--profile" in sys.argv[1:]:
        profile_gen_mesh(torch, model, opt, dev)

    # ---- 5. times
    timing = time_kernel(torch, fq, model, dev)
    kern = {"name": "fused_gather_mlp", "route": "cuda",
            "source": "rgbd_pifuhd_tpu_torch/csrc/fused_query.cu",
            "replaces": "rgbd_pifuhd_tpu/ops/pallas_query.py:286",
            "launches": launches, "max_abs_err": kres["main_err"],
            "tolerance": kres["main_tol"], **timing}
    print(smi_line)
    print(json.dumps({"kernels": [kern]}))
    print(json.dumps({"ok": True, "device": device_info(torch)}))


def device_info(torch) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def _level_inputs(torch, which: str, N: int, dev, gen):
    """Seeded feature map, uv and extra at a level's main-path shapes."""
    if which == "coarse":
        H = W = 128
        C, E = 256, 1
    else:
        H = W = 256
        C, E = 16, 256
    feat = torch.randn((H, W, C), generator=gen, device=dev)
    uv = torch.rand((N, 2), generator=gen, device=dev) * 2.2 - 1.1
    extra = torch.randn((N, E), generator=gen, device=dev)
    return feat, uv, extra


def _mlps(model, PointMLP, dev):
    """(level name, bf16 MLP of the checkpoint, f32 copy, merge layer)."""
    out = []
    for name, m in (("coarse", model.netG.mlp), ("fine", model.mlp)):
        m32 = PointMLP(m.filter_channels, m.merge, m.res_layers, m.norm,
                       dtype=None, device=dev)
        m32.load_state_dict(m.state_dict())
        merge = m.merge if name == "coarse" else -1
        out.append((name, m, m32, merge))
    return out


def kernel_checks(torch, fq, model, PointMLP, dev) -> dict:
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    main_err = 0.0
    N = 262144
    for name, m16, m32, merge in _mlps(model, PointMLP, dev):
        feat, uv, extra = _level_inputs(torch, name, N, dev, gen)
        for cd, m in ((torch.float32, m32), (torch.bfloat16, m16)):
            packed = m.packed()
            for scope in (None, 512):
                kw = dict(res_layers=m.res_layers, merge_layer=merge,
                          gn_scope=scope)
                f = feat.to(cd).contiguous()
                got = fq.fused_gather_mlp(f, uv, extra, packed, **kw)
                ref = fq.fused_gather_mlp_ref(f, uv, extra, packed, **kw)
                again = fq.fused_gather_mlp(f, uv, extra, packed, **kw)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], again[0]) and (
                        got[1] is None or torch.equal(got[1], again[1]))):
                    _BAD.append(f"{name} {cd} scope={scope}: two launches "
                                f"on the same inputs differ")
                errs = _compare(torch, got, ref, cd, f"{name} {cd} "
                                f"scope={scope}")
                if cd == torch.bfloat16 and scope is None:
                    main_err = max(main_err, errs[0])
    # ragged N and a narrow chain without norm (widths not multiples of 32)
    name, m16, m32, merge = _mlps(model, PointMLP, dev)[0]
    feat, uv, extra = _level_inputs(torch, "coarse", 1000, dev, gen)
    for cd, m in ((torch.float32, m32), (torch.bfloat16, m16)):
        f = feat.to(cd).contiguous()
        kw = dict(res_layers=m.res_layers, merge_layer=merge)
        _compare(torch, fq.fused_gather_mlp(f, uv, extra, m.packed(), **kw),
                 fq.fused_gather_mlp_ref(f, uv, extra, m.packed(), **kw), cd,
                 f"ragged N=1000 {cd}")
    torch.manual_seed(1)
    for cd in (torch.float32, torch.bfloat16):
        narrow = PointMLP((37 + 3, 72, 40, 1), 1, (1, 2), "none",
                          dtype=None if cd == torch.float32 else cd,
                          device=dev)
        feat = torch.randn((19, 23, 37), generator=gen, device=dev)
        uv = torch.rand((5000, 2), generator=gen, device=dev) * 2.2 - 1.1
        extra = torch.randn((5000, 3), generator=gen, device=dev)
        f = feat.to(cd).contiguous()
        kw = dict(res_layers=(1, 2), merge_layer=1)
        _compare(torch, fq.fused_gather_mlp(f, uv, extra, narrow.packed(),
                                            **kw),
                 fq.fused_gather_mlp_ref(f, uv, extra, narrow.packed(), **kw),
                 cd, f"narrow 40-72-40-1 no norm {cd}")
    if _BAD:
        fail(f"kernel disagrees with its plain version: {_BAD}")
    tol = TOL_BF16_PRED
    phase("kernels", json.dumps({
        "kernel": "fused_gather_mlp",
        "replaces": "rgbd_pifuhd_tpu/ops/pallas_query.py:286",
        "max_abs_err_pred_bf16_main": main_err, "tolerance": tol,
        "launches_in_checks": fq.fused_gather_mlp.launches}))
    return {"main_err": main_err, "main_tol": tol}


def _compare(torch, got, ref, cd, label):
    (p, phi), (p_ref, phi_ref) = got, ref
    if p.shape != p_ref.shape or not torch.isfinite(p).all():
        fail(f"{label}: pred shape/finiteness {tuple(p.shape)}")
    ep = float((p - p_ref).abs().max())
    ephi = 0.0
    if phi_ref is not None:
        if phi is None or phi.shape != phi_ref.shape \
                or not torch.isfinite(phi).all():
            fail(f"{label}: phi missing or malformed")
        ephi = float((phi - phi_ref).abs().max())
    tp, tphi = ((TOL_F32, TOL_F32) if cd == torch.float32
                else (TOL_BF16_PRED, TOL_BF16_PHI))
    ok = ep <= tp and ephi <= tphi
    mag = 0.0 if phi_ref is None else float(phi_ref.abs().max())
    phase("check", f"{label}: max|d pred| {ep:.3e} (tol {tp:g}), "
          f"max|d phi| {ephi:.3e} (tol {tphi:g}, max|phi| {mag:.3g}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        _BAD.append(label)
    return ep, ephi


_BAD: list = []


def main_path(torch, fq, model, opt, dev) -> int:
    import numpy as np

    from rgbd_pifuhd_tpu_torch.data.synthetic import capsule_subject
    from rgbd_pifuhd_tpu_torch.recon.pipeline import Reconstructor

    rgbd, calib, cv, _ = capsule_subject(512)
    data = {"img": rgbd[None], "img_512": rgbd[None], "calib": calib}
    recon = Reconstructor(model, opt, device=dev)
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "capsule_512.obj")
    launches = 0
    secs, counts, meshes = [], [], []
    for run in range(3):
        fq.fused_gather_mlp.launches = 0
        torch.cuda.synchronize()
        out = recon.gen_mesh(data, path, resolution=512)
        torch.cuda.synchronize()
        launches = fq.fused_gather_mlp.launches
        if launches == 0 or launches != 2 * out["query_calls"]:
            fail(f"run {run}: {launches} kernel launches for "
                 f"{out['query_calls']} field queries (want 2 each)")
        v, f = out["verts"], out["faces"]
        if not (len(v) and len(f) and np.isfinite(v).all()
                and f.min() >= 0 and f.max() < len(v)):
            fail(f"run {run}: malformed mesh ({len(v)} verts, {len(f)} "
                 f"faces)")
        n_v = n_f = 0
        with open(path, "rb") as fh:
            for line in fh:
                n_v += line.startswith(b"v ")
                n_f += line.startswith(b"f ")
        if n_v != len(v) or n_f != len(f):
            fail(f"run {run}: OBJ holds {n_v} v / {n_f} f lines, mesh "
                 f"{len(v)} / {len(f)}")
        counts.append(len(v))
        if run:
            secs.append(out["secs"])
            o = np.lexsort(v.T)
            meshes.append(v[o])
        lo, hi = v.min(0), v.max(0)
        centre = (cv.min(0) + cv.max(0)) / 2
        if not ((lo <= centre) & (centre <= hi)).all():
            fail(f"run {run}: the mesh bbox {lo}..{hi} misses the subject "
                 f"centre {centre}")
        phase("gen_mesh", json.dumps({
            "run": run, "timed": bool(run), "secs": round(out["secs"], 4),
            "phases": out["phases"], "verts": len(v), "faces": len(f),
            "grid_diag": out["grid_diag"],
            "points_queried": out["points_queried"],
            "query_calls": out["query_calls"], "kernel_launches": launches,
            "host_secs": out["host_secs"],
            "bbox_lo": lo.round(2).tolist(), "bbox_hi": hi.round(2).tolist(),
            "subject_lo": cv.min(0).round(2).tolist(),
            "subject_hi": cv.max(0).round(2).tolist()}))
    same = meshes[0].shape == meshes[1].shape and bool(
        (meshes[0] == meshes[1]).all())
    phase("repeat", f"vertex counts of the three runs: {counts}; the two "
          f"timed runs give the same mesh: {same}")
    phase("main", f"gen_mesh 512^3 timed runs: {[round(s, 4) for s in secs]}"
          f" s; OBJ {path} ({os.path.getsize(path)} bytes, removed)")
    os.remove(path)
    return launches


def profile_gen_mesh(torch, model, opt, dev) -> None:
    """One more gen_mesh under torch.profiler: device time by kernel name
    and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from rgbd_pifuhd_tpu_torch.data.synthetic import capsule_subject
    from rgbd_pifuhd_tpu_torch.recon.pipeline import Reconstructor

    rgbd, calib, _, _ = capsule_subject(512)
    data = {"img": rgbd[None], "img_512": rgbd[None], "calib": calib}
    recon = Reconstructor(model, opt, device=dev)
    path = os.path.join(OUT_DIR, "profile.obj")
    recon.gen_mesh(data, path, resolution=512)      # escalation + warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = recon.gen_mesh(data, path, resolution=512)
        torch.cuda.synchronize()
    wall = time.time() - t0
    os.remove(path)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    phase("profile", json.dumps({
        "wall_ms_with_profiler": round(wall * 1e3, 1),
        "device_busy_ms": round(busy, 1),
        "device_busy_share_of_gen_mesh": round(
            busy / (out["secs"] * 1e3), 3) if rows else None,
        "secs": round(out["secs"], 4), "host_secs": out["host_secs"],
        "top_kernels_ms": [(k[:60], round(ms, 2), n)
                           for k, ms, n in rows[:12]]}))


def _event_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def time_kernel(torch, fq, model, dev) -> dict:
    """One field query at the phase-3 band size (N = 262144): the coarse
    call then the fine call, bf16, GroupNorm over the whole call."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    N = 262144
    levels = []
    flop = byts = 0
    for name, m, merge in (("coarse", model.netG.mlp, model.netG.mlp.merge),
                           ("fine", model.mlp, -1)):
        feat, uv, extra = _level_inputs(torch, name, N, dev, gen)
        feat = feat.to(torch.bfloat16).contiguous()
        packed = m.packed()
        kw = dict(res_layers=m.res_layers, merge_layer=merge)
        levels.append((feat, uv, extra, packed, kw))
        macs = sum(int(L.weight.numel()) for L in packed.layers)
        flop += 2 * N * macs
        w_bytes = sum(L.weight.numel() * 2 + L.bias.numel() * 4
                      + (0 if L.gn_scale is None else 8 * L.gn_scale.numel())
                      for L in packed.layers)
        out_cols = packed.widths[-1] + (packed.widths[merge]
                                        if merge >= 0 else 0)
        byts += (feat.numel() * 2 + uv.numel() * 4 + extra.numel() * 4
                 + w_bytes + N * out_cols * 4)

    def kernel():
        for f, u, e, p, kw in levels:
            fq.fused_gather_mlp(f, u, e, p, **kw)

    def plain():
        for f, u, e, p, kw in levels:
            fq.fused_gather_mlp_ref(f, u, e, p, **kw)

    ms = _event_ms(torch, kernel, 10)
    plain_ms = _event_ms(torch, plain, 3)
    ms2 = _event_ms(torch, kernel, 10)
    bound_ops = flop / PEAK_BF16 * 1e3
    bound_bytes = byts / HBM_BPS * 1e3
    res = {"ms": round(min(ms, ms2), 4), "plain_ms": round(plain_ms, 4),
           "bound_ms": round(max(bound_ops, bound_bytes), 4),
           "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
           "library_ms": None}
    phase("time", json.dumps({
        "work": "coarse + fine fused_gather_mlp, N=262144, bf16",
        "flop": flop, "bytes": byts, "kernel_ms_runs": [round(ms, 4),
                                                        round(ms2, 4)],
        "tflops": round(flop / (min(ms, ms2) * 1e-3) / 1e12, 2),
        "bound_ops_ms": round(bound_ops, 4),
        "bound_bytes_ms": round(bound_bytes, 4), **res,
        "library": "none: no single PyTorch call computes this function"}))
    return res


if __name__ == "__main__":
    main()
