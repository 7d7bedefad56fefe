"""The resident server, driven in the benchmark's process:
``cli.common.load_reconstructor`` then ``cli.serve._serve_loop``, with the
request lines coming from here and ``emit`` recording each reply.

Closed loop, one client: request after request from the window's start
until ``seconds`` have passed, the request in flight finished.  A request is
one subject (``<dir>::<stem>``, traffic ``"request": "subject"``) or the
directory of all of them (``"directory"``: the multi-subject branch, the
two-slot ``gen_mesh_many``).  The subjects are written at set-up from the
seed; every mesh path is a FIFO that ``portbench/drain.py`` empties, and the
meshes the correctness check reads are copied to files.
"""

from __future__ import annotations

import contextlib
import gc
import os
import subprocess
import sys
import threading
import time

import numpy as np

from portbench import flops as F
from portbench import weights as W
from portbench.gen import subjects as S

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pool(traffic, rng):
    """Subject kinds in request order: ``pool`` is ``[[kind, count], ...]``,
    interleaved (a, b, a, b, ...)."""
    kinds = []
    for kind, n in traffic["pool"]:
        kinds.append([kind] * n)
    return [k for grp in zip(*kinds) for k in grp]


def _model_bytes(model) -> int:
    return sum(p.numel() * 2 for n, p in model.named_parameters()
               if "mlp" in n)


def _feat_bytes(l_feats, g_feats) -> int:
    return sum(t.numel() * t.element_size()
               for t in (l_feats.im_feats, g_feats.im_feats))


def run(ctx) -> dict:
    procs: list = []
    try:
        return _run(ctx, procs)
    finally:
        for p in procs:         # never leave the drainer behind
            if p.poll() is None:
                p.kill()
                p.wait()


def _run(ctx, procs) -> dict:
    import torch

    from rgbd_pifuhd_tpu_torch.cli import common
    from rgbd_pifuhd_tpu_torch.cli.common import mesh_path
    from rgbd_pifuhd_tpu_torch.cli.serve import _serve_loop
    from rgbd_pifuhd_tpu_torch.utils.options import parse_options

    cfg, traffic, tracer = ctx["config"], ctx["traffic"], ctx["tracer"]
    dev = ctx["device"]
    work = ctx["workdir"]
    rng = np.random.default_rng(ctx["seed"])
    size = traffic["size"]

    # ---- traffic: the subjects, written from the seed
    kinds = _pool(traffic, rng)
    subj_dir = os.path.join(work, "subjects")
    pixels = {}
    for i, kind in enumerate(kinds):
        stem = f"s{i}_{kind}"
        rgb, dep = S.subject_pixels(kind, size, rng)
        S.write_subject(subj_dir, stem, rgb, dep)
        pixels[stem] = (kind, rgb, dep)
    stems = sorted(pixels)
    by_kind = {k: [s for s in stems if pixels[s][0] == k] for k in set(kinds)}
    order = [stems[i] for i in rng.permutation(len(stems))]
    # alternate the kinds so that every window holds the same mix
    order = [s for grp in zip(*[[s for s in order if pixels[s][0] == k]
                                for k in sorted(by_kind)]) for s in grp]
    directory = traffic["request"] == "directory"
    if directory:
        seq = [(subj_dir, stems)]
    else:
        seq = [(f"{subj_dir}::{s}", [s]) for s in order]
    # the meshes the check reads: one of each kind, drawn from the seed,
    # in the first request (directory) or among the first four (every run
    # of the cell's length completes them)
    checked = set()
    for k in sorted(by_kind):
        if directory:
            checked.add((0, by_kind[k][rng.integers(len(by_kind[k]))]))
        else:
            pos = [j for j, (_, ss) in enumerate(seq[:4])
                   if pixels[ss[0]][0] == k]
            j = int(pos[rng.integers(len(pos))])
            checked.add((j, seq[j][1][0]))

    # ---- the program: checkpoint, reconstructor, output FIFOs
    args = list(traffic["server_args"]) + [
        "--load_netMR_checkpoint_path",
        os.path.join(ctx["root"], cfg["checkpoint"]),
        "--results_path", os.path.join(work, "results")]
    if dev != "cuda":
        args += ["--device", dev]
    opt, device = parse_options(args, with_device=True)
    with W.widened_loader(common.ckpt, cfg["netG"]["nml_ngf"]):
        recon, _, _ = common.load_reconstructor(opt, device)
    device = recon.device
    out_dir = os.path.join(opt.results_path, opt.name, "serve")
    os.makedirs(out_dir, exist_ok=True)
    warm_dir = os.path.join(work, "warm")
    warm = []
    for k in traffic["warmup"]:
        s = by_kind[k][0]
        stem = f"w_{s}"
        S.write_subject(warm_dir, stem, pixels[s][1], pixels[s][2])
        warm.append(stem)
    fifo = {}
    for s in stems + warm:
        p = mesh_path(out_dir, {"name": s}, opt)
        os.mkfifo(p)
        fifo[s] = p
    drain = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "drain.py")],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    procs.append(drain)
    drained: list = []
    def read_answers():
        for line in drain.stdout:
            drained.append(line)

    reader = threading.Thread(target=read_answers, daemon=True)
    reader.start()
    copies = {}     # (request, stem) -> the copy of its mesh
    n_cmd = [0]

    def to_drain(names, k):
        for s in names:
            copy = "-"
            if (k, s) in checked:
                copy = copies[(k, s)] = os.path.join(work, f"check_{k}_{s}.obj")
            drain.stdin.write(f"{fifo[s]}\t{copy}\n")
            n_cmd[0] += 1
        drain.stdin.flush()

    def close_drain():
        """Ends the drainer; a mesh that was never written (a failed
        request) leaves it waiting on its FIFO, which an empty writer
        releases."""
        t0 = time.perf_counter()
        while len(drained) < n_cmd[0] and time.perf_counter() - t0 < 60:
            for p in fifo.values():
                try:
                    os.close(os.open(p, os.O_WRONLY | os.O_NONBLOCK))
                except OSError:
                    pass
            time.sleep(0.05)
        drain.stdin.write("quit\n")
        drain.stdin.close()
        drain.wait(timeout=60)
        reader.join(timeout=10)

    # ---- benchmark-side spans and counters around the program's calls
    records = []
    least_s = [0.0]
    model = recon.model
    per_point = F.two_level_query_flops_per_point(cfg["netMR"], cfg["netG"])
    w_bytes = _model_bytes(model)

    def counted(fn, name, taps):
        def inner(l_feats, g_feats, points, *a, **kw):
            n = points.shape[2] * taps
            flop = per_point * n
            byts = (_feat_bytes(l_feats, g_feats) + w_bytes
                    + points.numel() * 4 + n * 4)
            least_s[0] += max(flop / F.PEAK_BF16, byts / F.PEAK_BYTES)
            with tracer.span(name):
                return fn(l_feats, g_feats, points, *a, **kw)
        return inner

    if tracer.on:
        model.query = counted(model.query, "pb.query", 1)
        model.field_last = counted(model.field_last, "pb.query", 1)
        model.calc_normal = counted(model.calc_normal, "pb.query", 4)
        recon.encode = tracer.wrap(recon.encode, "pb.encode")
        orig_timed = recon.timed

        @contextlib.contextmanager
        def timed(name, sink=None):
            with tracer.span("host." + name), orig_timed(name, sink):
                yield

        recon.timed = timed

    # the checked meshes' octree calls, kept for the reference: the first
    # phase's levels and refined cells, and every third-phase band (its
    # sub-cells and packed levels); an escalation's re-run replaces them
    from rgbd_pifuhd_tpu_torch.recon import grid as grid_mod

    cap = {"names": [], "cur": None, "k": None}
    captures = {}
    p1_orig, p3_orig = grid_mod._three_phase_p1, grid_mod.three_phase_p3_band

    def p1_w(*a, **kw):
        out = p1_orig(*a, **kw)
        if cap["cur"] is not None:
            cap["cur"].update(p1=(out[0], out[1]), bands=[])
        return out

    def p3_w(*a, **kw):
        out = p3_orig(*a, **kw)
        if cap["cur"] is not None:
            cap["cur"]["bands"].append((a[5], out))
        return out

    grid_mod._three_phase_p1, grid_mod.three_phase_p3_band = p1_w, p3_w
    encode_inner = recon.encode

    def encode_w(*a, **kw):
        name = cap["names"].pop(0) if cap["names"] else None
        cap["cur"] = None
        if (cap["k"], name) in checked:
            cap["cur"] = captures[(cap["k"], name)] = {}
        return encode_inner(*a, **kw)

    recon.encode = encode_w

    def keep(r):
        records.append({k: r.get(k) for k in ("host_secs", "points_queried",
                                              "query_calls")})

    gen_mesh, gen_many = recon.gen_mesh, recon.gen_mesh_many

    def gen_mesh_w(*a, **kw):
        with tracer.span("pb.mesh"):
            r = gen_mesh(*a, **kw)
        keep(r)
        return r

    def gen_many_w(*a, **kw):
        with tracer.span("pb.mesh"):
            rs = gen_many(*a, **kw)
        for r in rs:
            keep(r)
        return rs

    recon.gen_mesh, recon.gen_mesh_many = gen_mesh_w, gen_many_w
    replies = []

    def emit(obj):
        replies.append((time.perf_counter(), obj))

    # ---- warm-up: the cell's own shapes (its request kind, both bodies)
    if directory:
        to_drain(warm, -1)
        _serve_loop(recon, opt, out_dir, [warm_dir], emit)
    else:
        for s in warm:
            to_drain([s], -1)
        _serve_loop(recon, opt, out_dir, [f"{warm_dir}::{s}" for s in warm],
                    emit)
    n_warm = len(replies)
    warm_errors = [r for _, r in replies if "error" in r]
    if device.type == "cuda":
        torch.cuda.synchronize()
    del replies[:]
    del records[:]
    sent = []

    # ---- the window
    tracer.start()
    t_w = tracer.t0

    def requests():
        k = 0
        while time.perf_counter() - t_w < ctx["seconds"]:
            line, names = seq[k % len(seq)]
            to_drain(names, k)
            cap["k"], cap["names"] = k, list(names)
            sent.append(names)
            k += 1
            yield line

    with tracer.span("pb.window"):
        _serve_loop(recon, opt, out_dir, requests(), emit)
    trace = tracer.stop()
    grid_mod._three_phase_p1, grid_mod.three_phase_p3_band = p1_orig, p3_orig
    t_last = replies[-1][0] if replies else time.perf_counter()
    meshes = [r for _, r in replies if "mesh" in r]
    errors = [r for _, r in replies if "error" in r] + warm_errors
    close_drain()
    attempted = sum(len(n) for n in sent)
    empty = sum(1 for x in drained if int(x.split()[0]) == 0)
    missing = (n_warm + attempted) - len(drained)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0

    # ---- free the program's state, then the reference
    n_q = sum(sum(r["points_queried"].values()) for r in records)
    recon.gen_mesh = recon.gen_mesh_many = None
    del recon, model, gen_mesh, gen_many
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = _check(ctx, cfg, pixels, copies, captures, opt.resolution,
                     device)
    numbers["missing_meshes"] += len(checked) - len(copies)

    out = {
        "t_window": t_w, "attempted": attempted,
        "failed": len(errors) + empty + max(missing, 0),
        "e2e": {"mesh_s": (t_last - t_w) / max(len(meshes), 1)},
        "numbers": numbers, "memory_peak_bytes": peak,
        "trace": trace, "window_s": t_last - t_w,
        "data": {"records": records, "replies": meshes,
                 "units": len(meshes), "least_query_s": least_s[0],
                 "per_point_flops": per_point, "points_queried": n_q,
                 "encode_flops": _encode_flops(ctx, cfg, device)
                 if tracer.on else None},
    }
    return out


def _reference(ctx, cfg, device):
    from portbench.reference import check_mesh as CM
    from portbench.reference import checkpoint as CK

    payload = W.widen_normal_nets(
        CK.load_flax(os.path.join(ctx["root"], cfg["checkpoint"])),
        cfg["netG"]["nml_ngf"])
    return CM, CM.load_model(payload, device)


def _check(ctx, cfg, pixels, copies, captures, res, device) -> dict:
    """The worst of each number over the checked meshes; a checked mesh
    that never came counts in ``missing_meshes``.  Float32, TF32 off."""
    from portbench.reference.model import no_tf32

    with no_tf32():
        return _judge_all(ctx, cfg, pixels, copies, captures, res, device)


def _judge_all(ctx, cfg, pixels, copies, captures, res, device) -> dict:
    CM, net = _reference(ctx, cfg, device)
    worst: dict = {"missing_meshes": 0}
    for key, path in sorted(copies.items()):
        if key not in captures or not os.path.exists(path):
            worst["missing_meshes"] += 1
            continue
        _, rgb, dep = pixels[key[1]]
        got = CM.judge(net, rgb, dep, path, res, device, captures.pop(key),
                       control=ctx.get("control", False))
        os.remove(path)
        for k, v in got.items():
            worst[k] = max(worst.get(k, v), v)
    worst["checked"] = len(copies) - worst["missing_meshes"]
    return worst


def _encode_flops(ctx, cfg, device) -> float:
    """FLOPs of one mesh's encoders (both normal nets and hourglasses) by
    ``FlopCounterMode`` on the reference at the cell's shapes."""
    import torch

    from portbench.reference import model as M

    with torch.device("meta"):
        net = M.MultiRes(cfg["netMR"], cfg["netG"])
        s = ctx["traffic"]["size"]
        img = torch.zeros(1, s, s, 6)
        img_g = torch.zeros(1, 512, 512, 6)
    with torch.inference_mode():
        return F.counted_flops(lambda: net.encode(img, img_g))
