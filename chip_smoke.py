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
5. the other inference paths, flagship-lite at full width and 512^3, warm
   (the main path's escalated budgets): ``[grad]`` (``normal_mode='grad'``,
   and the colour pass alone in both modes on one mesh, with the median
   cosine between their normals), ``[mesh_normals]`` (geometric normals, no
   colour query), ``[two_level]`` (``octree_levels=2``), ``[dense]``
   (``use_octree=False``: field, pull and march seconds) and
   ``[coarse_only]`` (``CoarseReconstructor`` on flagship-lite's ``netG``),
   each with the kernel launches it caused (counts set to 0 just before);
6. the served path: request directories written as PNG files, then the
   resident server ``cli/serve`` as a subprocess twice — (a) flagship-lite
   at full width, 512^3: a bad request, one subject twice (cold, warm), a
   two-subject directory (``gen_mesh_many``); (b) ``bench_tiny`` (norm-free,
   so its fine level runs ``fused_point_mlp``) with image colours, cleanup
   and PLY — one ``cli/run_recon`` batch call on (b)'s directory, and
   ``[serve_jpeg]``: a flagship-lite server answering the committed JPEG
   subject (``tests/data/jpeg_subject``); the launch counts each process
   reports are checked against its field queries, the mesh files against
   the replies;
6c. the rest of training on ``[train]``'s tree: ``[train_normals]``
   (``cli.run_train --stage normals`` at the paper's widths, 1024^2),
   ``[train_gan]`` (one GAN step card against CPU at tiny widths, then 5
   steps at the paper's widths), ``[train_alternating]`` (one cycle of
   the curriculum in-process, one epoch a stage), ``[train_eval]``
   (``cli.run_train --stage eval`` in-process over ``[train]``'s fine
   checkpoints, with the kernel launches it caused), and
   ``[jpeg_progressive]`` (the committed progressive subject decoded
   against its committed expected pixels, then served by ``cli.serve``);
7. times (CUDA events) of both kernels and their plain versions at the
   full-width shapes, beside the card's bound for the same work, and of
   every launch of the coarse and the fine chain alone (``[time_layers]``)
   beside its bounds and one ``torch.matmul`` of the same product.

``fused_point_mlp`` is held against its plain version in phase 3 as well
(f32 and bf16, both full-width norm-free chains and ``bench_tiny``'s; in
bf16 also at N that end in a ragged tile and below one tile), and timed in
phase 6 beside the per-layer route of ``fused_gather_mlp`` on the same
chain.

The last three lines are the card's name and power limit (nvidia-smi), the
``kernels`` JSON line, and ``{"ok": true, "device": {...}}``.
``--profile`` adds one gen_mesh under ``torch.profiler`` and prints
device time by kernel and the device's busy share.  ``--kernels-only``
stops after the kernel checks and times (no ok line, exit code 1).
"""

from __future__ import annotations

import json
import os
import shutil
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
# fused_point_mlp, bf16, without the sigmoid: the same one-ulp steps, on a
# head whose values are not squashed into [0, 1]; held relative to the
# largest |value| of the plain version's output (set from the spread
# measured on the H100: at most 0.0055 of it, PERF.md section 6).
TOL_BF16_RAW_REL = 4e-2
CKPT_TINY = os.path.join(HERE, "assets", "bench_tiny", "ckpt")
FULL_SHAPES = (("coarse", (257, 1024, 512, 256, 128, 1), (2, 3, 4)),
               ("fine", (272, 512, 256, 128, 1), (1, 2)))


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
    from rgbd_pifuhd_tpu_torch.ops import fused_mlp as fm
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
               threading.Thread(target=run, args=("nvcc_mlp", fm.build)),
               threading.Thread(target=run, args=("g++", native.build_all))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        fail(f"build failed: {errs[0][0]}: {errs[0][1]}")
    ptxas = [ln.strip() for k in ("nvcc", "nvcc_mlp")
             for ln in (logs.get(k) or "").splitlines()
             if any(w in ln for w in ("registers", "spill", "arning",
                                      "Compiling entry"))]
    phase("build", f"fused_query.cu (+ hopper.cuh) + fused_mlp.cu + "
          f"marching.cc + "
          f"meshio.cc built in {time.time() - t0:.1f} s; ptxas: "
          f"{' || '.join(ptxas)}")

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
    mres = mlp_kernel_checks(torch, fq, fm, PointMLP, dev)

    # ---- 4. main path
    kernels_only = "--kernels-only" in sys.argv[1:]
    launches, esc = (0, {}) if kernels_only else main_path(torch, fq, model,
                                                           opt, dev)
    # ---- 5. the other inference paths
    paths = {} if kernels_only else other_paths(torch, fq, fm, model, opt,
                                                dev, esc)

    served = {} if kernels_only else served_path()
    mlp_launches = served.get("b", {}).get("fused_point_mlp", 0)
    # ---- 6b. training: the port's own tree, card against CPU, the CLI;
    # then the rest of training on the same tree, and progressive JPEG
    if not kernels_only:
        root, base, ck = train_phase(torch, dev, smi_line)
        paths["eval"] = train_rest(torch, fq, fm, dev, smi_line, root, base,
                                   ck)
        shutil.rmtree(base, ignore_errors=True)
        served["jpeg_progressive"] = jpeg_progressive(smi_line)
    if "--profile" in sys.argv[1:]:
        profile_gen_mesh(torch, model, opt, dev)

    # ---- 5. times
    timing = time_kernel(torch, fq, model, dev)
    time_layers(torch, fq, model, dev)
    mtiming = time_mlp_kernel(torch, fq, fm, PointMLP, dev)
    kern = {"name": "fused_gather_mlp", "route": "cuda",
            "source": "rgbd_pifuhd_tpu_torch/csrc/fused_query.cu",
            "replaces": "rgbd_pifuhd_tpu/ops/pallas_query.py:286",
            "launches": launches, "max_abs_err": kres["main_err"],
            "tolerance": kres["main_tol"], **timing}
    kern2 = {"name": "fused_point_mlp", "route": "cuda",
             "source": "rgbd_pifuhd_tpu_torch/csrc/fused_mlp.cu",
             "replaces": "rgbd_pifuhd_tpu/ops/pallas_mlp.py:51",
             "launches": mlp_launches, "max_abs_err": mres["main_err"],
             "tolerance": mres["main_tol"], **mtiming,
             "launches_by_process": {k: v["fused_point_mlp"]
                                     for k, v in served.items()}}
    kern["launches_by_process"] = {
        "in_memory_gen_mesh": launches,
        **{k: v["fused_gather_mlp"] for k, v in served.items()}}
    kern["launches_by_path"] = {k: v["fused_gather_mlp"]
                                for k, v in paths.items()}
    kern2["launches_by_path"] = {k: v["fused_point_mlp"]
                                 for k, v in paths.items()}
    print(smi_line)
    print(json.dumps({"kernels": [kern, kern2]}))
    if kernels_only:
        sys.exit("--kernels-only: the main path and the served path were "
                 "not driven, so no ok line")
    print(json.dumps({"ok": True, "device": device_info(torch)}))


# ------------------------------------------------------------- training
TRAIN_SUBJECTS = ("sphere", "capsule", "bumpy")
TRAIN_STEPS_EPOCHS = 10          # 3 items x 10 epochs = 30 steps a stage
# the gradient tolerance of tests/test_torch_train_step.py: 16 times the
# leaf's own one-ulp spread (the CPU gradient's change when the input
# images move by one float32 ulp) + 1e-6 of the tree's largest |gradient|
GRAD_ULPS, GRAD_FLOOR = 16.0, 1e-6


def _train_grads(torch, model, fn, batch):
    """Loss and ``{name: gradient}`` of one training forward on ``batch``
    (no optimiser step), batch-norm buffers restored afterwards."""
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    model.zero_grad(set_to_none=True)
    loss = fn(model, batch)
    loss.backward()
    # copies: on the CPU .cpu() would alias what load_state_dict restores
    grads = {n: p.grad.detach().float().cpu().clone() for n, p in
             model.named_parameters() if p.grad is not None}
    stats = {k: v.detach().cpu().clone() for k, v in
             model.state_dict().items() if k.endswith((".mean", ".var"))}
    model.load_state_dict(saved)
    return float(loss.detach()), grads, stats


def _card_against_cpu(torch, dev, root) -> dict:
    """One fine and one coarse training forward + backward at tiny widths,
    f32, on the card and on the CPU from the same parameters and batch:
    loss within 1e-5 relative, gradients within the CPU test's tolerance
    (16 x the CPU gradient's one-ulp spread + 1e-6 of its largest
    value), running statistics within 1e-5."""
    import dataclasses

    import numpy as np

    from rgbd_pifuhd_tpu_torch.data.datasets import TrainDataset
    from rgbd_pifuhd_tpu_torch.models import CoarsePIFu, MultiResPIFu
    from rgbd_pifuhd_tpu_torch.models.blocks import init_flax
    from rgbd_pifuhd_tpu_torch.train.loop import collate_coarse, collate_fine
    from rgbd_pifuhd_tpu_torch.utils.options import Options, PIFuLevelConfig

    g = PIFuLevelConfig(num_stack=2, hg_depth=1, hg_dim=8,
                        mlp_dim=(9, 64, 32, 32, 1), mlp_res_layers=(1,),
                        mlp_norm="group", merge_layer=2, nml_ngf=8,
                        nml_n_downsampling=2, nml_n_blocks=1)
    loc = PIFuLevelConfig(num_stack=1, hg_depth=1, hg_dim=4,
                          hg_down="no_down", mlp_dim=(36, 32, 32, 1),
                          mlp_res_layers=(1,), mlp_norm="group",
                          merge_layer=-1)
    opt = Options(dataroot=root, load_size=1024, load_size_big=128,
                  load_size_local=64, num_sample_inout=256, sigma=8.0)
    d = TrainDataset(opt, seed=2)
    items = [d[0], d[1]]
    fb, cb = collate_fine(items), collate_coarse(items)

    def fine(m, b):
        return m(b["images_local"], b["images_global"], b["points"],
                 b["calib_local"], b["calib_global"], b["labels"])[0][
                     "occ_fine"]

    def coarse(m, b):
        return m(b["images"], b["points"], b["calibs"], b["labels"], 0.1)[0]

    out = {}
    for name, make, fn, batch, keys in (
            ("fine_group", lambda: MultiResPIFu(loc, g, device="cpu"), fine,
             fb, ("images_local", "images_global")),
            ("coarse_batch", lambda: CoarsePIFu(dataclasses.replace(
                g, norm="batch", mlp_norm="batch"), device="cpu"), coarse,
             cb, ("images",))):
        cpu = make()
        init_flax(cpu, torch.Generator().manual_seed(3))
        card = make().to(dev)
        card.load_state_dict(cpu.state_dict())
        lc, gc, sc = _train_grads(torch, cpu, fn, batch)
        lg, gg, sg = _train_grads(torch, card, fn, {
            k: v.to(dev) for k, v in batch.items()})
        rng = np.random.default_rng(0)
        spread = {k: torch.zeros_like(v) for k, v in gc.items()}
        for _ in range(2):
            pb = dict(batch)
            for k in keys:
                sign = torch.from_numpy(rng.choice([-1.0, 1.0], tuple(
                    pb[k].shape)).astype(np.float32))
                pb[k] = pb[k] * (1 + sign * 2.0 ** -23)
            _, gp, _ = _train_grads(torch, cpu, fn, pb)
            spread = {k: torch.maximum(spread[k], (gp[k] - gc[k]).abs())
                      for k in gc}
        if abs(lg - lc) > 1e-5 * abs(lc) or not np.isfinite(lg):
            fail(f"[train] {name}: card loss {lg!r} vs CPU {lc!r}")
        if set(gg) != set(gc):
            fail(f"[train] {name}: gradients of other parameters "
                 f"{sorted(set(gg) ^ set(gc))[:4]}")
        top = max(float(v.abs().max()) for v in gc.values())
        worst = 0.0
        for k in gc:
            err = float((gg[k] - gc[k]).abs().max())
            sp = float(spread[k].max())
            if err > GRAD_ULPS * sp + GRAD_FLOOR * top:
                fail(f"[train] {name}: gradient of {k} off by {err:.3e} "
                     f"(CPU one-ulp spread {sp:.3e}, top {top:.3e})")
            if GRAD_ULPS * sp > GRAD_FLOOR * top:
                worst = max(worst, err / sp)
        init = cpu.state_dict()
        if sc and all(torch.equal(sc[k], init[k]) for k in sc):
            fail(f"[train] {name}: the step updated no running statistic")
        stat_err = max([float((sg[k] - sc[k]).abs().max()) for k in sc]
                       + [0.0])
        if stat_err > 1e-5:
            fail(f"[train] {name}: running statistics off by {stat_err}")
        out[name] = {"loss_card": lg, "loss_cpu": lc,
                     "loss_rel_err": abs(lg - lc) / abs(lc),
                     "grad_err_over_spread": round(worst, 3),
                     "stats_max_abs_err": stat_err, "n_grads": len(gc)}
    return out


def _run_cli(args, cwd, log_path):
    """One ``cli.run_train`` process on the card; its stdout lines."""
    with open(log_path, "w") as log:
        r = subprocess.run(
            [sys.executable, "-m", "rgbd_pifuhd_tpu_torch.cli.run_train"]
            + args, cwd=cwd, stdout=subprocess.PIPE, stderr=log, text=True,
            timeout=900, env={**os.environ, "PYTHONPATH": HERE})
    if r.returncode != 0:
        fail(f"run_train {args[:2]} exit {r.returncode}: "
             f"{open(log_path).read()[-3000:]}")
    return r.stdout.splitlines()


def _run_train(args, cwd, log_path) -> dict:
    """One ``cli.run_train`` process on the card: its per-step losses,
    step and data milliseconds, peak memory and seconds."""
    t0 = time.time()
    lines = _run_cli(args, cwd, log_path)
    secs = time.time() - t0
    losses, step_ms, data_ms, peak = [], [], [], None
    for ln in lines:
        if ln.startswith("Name: "):
            losses.append(float(ln.split("Err: ")[1].split()[0]))
            data_ms.append(float(ln.split("stepD: ")[1].split("ms")[0]))
            step_ms.append(float(ln.split("stepN: ")[1].split("ms")[0]))
        elif ln.startswith("peak device memory: "):
            peak = int(ln.split(": ")[1].split()[0])
    import numpy as np

    if not losses or not np.isfinite(losses).all() or peak is None:
        fail(f"run_train {args[:2]}: losses {losses[:5]}..., peak {peak}")
    warm = step_ms[3:] or step_ms
    return {"steps": len(losses), "first_loss": losses[0],
            "last_loss": losses[-1], "median_step_ms": float(
                np.median(warm)), "median_data_ms": float(np.median(
                    data_ms[3:] or data_ms)), "peak_mem_bytes": peak,
            "process_s": round(secs, 2)}


def train_phase(torch, dev, smi_line):
    """``[train]``: the port writes a training tree, one training step is
    held card against CPU, ``cli.run_train`` pretrains the coarse model
    and trains the fine one at the paper's widths (bf16), netG stays
    bit-equal through the fine stage, and the fine checkpoint meshes.
    Returns the tree, the phase's directory and its checkpoints'."""
    import dataclasses

    import numpy as np

    from rgbd_pifuhd_tpu_torch.cli.common import load_reconstructor
    from rgbd_pifuhd_tpu_torch.data.datasets import TrainDataset
    from rgbd_pifuhd_tpu_torch.data.synthetic import (
        generate_synthetic_dataset)
    from rgbd_pifuhd_tpu_torch.utils import checkpoint as ckpt
    from rgbd_pifuhd_tpu_torch.utils.options import Options

    torch.cuda.empty_cache()
    base = os.path.join(OUT_DIR, "train")
    shutil.rmtree(base, ignore_errors=True)
    root = os.path.join(OUT_DIR, "traindata")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.time()
    generate_synthetic_dataset(root, TRAIN_SUBJECTS, size=512,
                               load_size=1024)
    tree_s = time.time() - t0
    parity = _card_against_cpu(torch, dev, root)
    phase("train", json.dumps({"tree": f"{len(TRAIN_SUBJECTS)} subjects, "
                               "size 512, load_size 1024",
                               "tree_s": round(tree_s, 2),
                               "card_vs_cpu": parity}))
    ck = os.path.join(base, "ck")
    os.makedirs(ck)
    common = ["--dataroot", root, "--name", "smoke", "--checkpoints_path",
              ck, "--compute_dtype", "bfloat16", "--num_sample_inout",
              "4096", "--sigma", "8", "--batch_size", "1", "--num_epoch",
              str(TRAIN_STEPS_EPOCHS), "--freq_save", "1000"]
    stages = {}
    stages["coarse"] = _run_train(["--stage", "coarse"] + common, base,
                                  os.path.join(base, "coarse.log"))
    g_path = ckpt.latest_path(ck, "smoke_netG")
    stages["fine"] = _run_train(
        ["--stage", "fine", "--load_netG_checkpoint_path", g_path] + common,
        base, os.path.join(base, "fine.log"))
    for k, v in stages.items():
        phase(f"train_{k}", json.dumps({**v, "card": smi_line,
                                        "widths": "paper defaults, bf16"}))
    # netG bit-equal through the fine stage; netMR moved after epoch 0
    g = ckpt.load_checkpoint(g_path, device="cpu")["params"]["params"]
    fine_path = ckpt.latest_path(ck, "smoke")
    fine = ckpt.load_checkpoint(fine_path, device="cpu")["params"]["params"]
    e0 = ckpt.load_checkpoint(ckpt.epoch_path(ck, "smoke", 0),
                              device="cpu")["params"]["params"]

    def leaves(t, pre=()):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], pre + (k,))
        else:
            yield pre, t

    n_g = 0
    for path, t in leaves(g):
        node = fine["netG"]
        for k in path:
            node = node[k]
        if not torch.equal(node, t):
            fail(f"[train] netG changed in the fine stage at {path}")
        n_g += 1
    moved = [p for (p, a), (_, b) in zip(leaves(fine["mlp"]),
                                         leaves(e0["mlp"]))
             if not torch.equal(a, b)]
    if not moved:
        fail("[train] the fine MLP did not change after epoch 0")
    del g, fine, e0
    # round trip: the fine checkpoint meshes at 256^3
    opt = Options(load_netMR_checkpoint_path=fine_path, results_path=base,
                  resolution=256)
    recon, opt_model, _ = load_reconstructor(opt, "cuda")
    item = dict(TrainDataset(dataclasses.replace(opt_model, dataroot=root),
                             load_mesh=False)[2])
    item["img_512"] = item["img_512"][None]
    t0 = time.time()
    try:
        out = recon.gen_mesh(item, os.path.join(base, "bumpy.obj"), 256)
        n_v = len(out["verts"])
        if not np.isfinite(out["verts"]).all():
            fail("[train] the trained model's mesh is not finite")
    except RuntimeError as e:
        if "empty mesh" not in str(e):
            raise
        n_v = 0
    phase("train_mesh", json.dumps({
        "netG_leaves_equal": n_g, "fine_mlp_leaves_moved": len(moved),
        "gen_mesh_256_s": round(time.time() - t0, 2), "verts": n_v}))
    del recon
    torch.cuda.empty_cache()
    return root, base, ck


def _gan_grads(torch, gen, disc, batch, lr=1e-3):
    """One GAN step (``make_gan_normal_train_step``) from the modules'
    current parameters: the losses, ``{name: gradient}`` of both nets
    (the generator's from its loss, the discriminator's from its own), and
    the parameters after Adam, all on the CPU."""
    from rgbd_pifuhd_tpu_torch.train.trainers import (
        make_gan_normal_train_step, make_optimizer)

    step = make_gan_normal_train_step(
        gen, lambda i, x: disc(torch.cat([i, x], -1)),
        make_optimizer("adam", lr, gen.parameters()),
        make_optimizer("adam", lr, disc.parameters()))
    m = step(batch)
    grads = {f"{k}.{n}": p.grad.detach().float().cpu().clone()
             for k, net in (("G", gen), ("D", disc))
             for n, p in net.named_parameters()}
    after = {f"{k}.{n}": p.detach().float().cpu().clone()
             for k, net in (("G", gen), ("D", disc))
             for n, p in net.named_parameters()}
    return ({k: float(v) for k, v in m.items()}, grads, after)


def _gan_card_against_cpu(torch, dev) -> dict:
    """One GAN step at tiny widths (ngf 8, two downsamplings, one block;
    ndf 8, two layers, two scales; 64^2, batch 2), f32, TF32 off, on the
    card and on the CPU from the same parameters and batch: both losses
    within 1e-6 relative, every gradient within 16 x the CPU gradient's
    one-ulp spread (the input images moved by one float32 ulp, two draws)
    + 1e-6 of its largest value."""
    import numpy as np

    from rgbd_pifuhd_tpu_torch.models.blocks import init_flax
    from rgbd_pifuhd_tpu_torch.models.pix2pix import (
        GlobalGenerator, MultiscaleDiscriminator)

    g0 = GlobalGenerator(6, 3, 8, 2, 1, device="cpu")
    d0 = MultiscaleDiscriminator(9, 8, 2, 2, device="cpu")
    init_flax(g0, torch.Generator().manual_seed(5))
    init_flax(d0, torch.Generator().manual_seed(6))
    rng = np.random.default_rng(7)
    batch = {"images": torch.from_numpy(rng.standard_normal(
                 (2, 64, 64, 6)).astype(np.float32)),
             "target": torch.from_numpy(np.tanh(rng.standard_normal(
                 (2, 64, 64, 3))).astype(np.float32))}

    def run(device, b):
        g = GlobalGenerator(6, 3, 8, 2, 1, device=device)
        d = MultiscaleDiscriminator(9, 8, 2, 2, device=device)
        g.load_state_dict(g0.state_dict())
        d.load_state_dict(d0.state_dict())
        return _gan_grads(torch, g, d, {k: v.to(device)
                                        for k, v in b.items()})

    mc, gc, _ = run("cpu", batch)
    mg, gg, _ = run(dev, batch)
    spread = {k: torch.zeros_like(v) for k, v in gc.items()}
    for _ in range(2):
        sign = torch.from_numpy(rng.choice([-1.0, 1.0], tuple(
            batch["images"].shape)).astype(np.float32))
        pb = {**batch, "images": batch["images"] * (1 + sign * 2.0 ** -23)}
        _, gp, _ = run("cpu", pb)
        spread = {k: torch.maximum(spread[k], (gp[k] - gc[k]).abs())
                  for k in gc}
    for k in ("g_loss", "d_loss"):
        if abs(mg[k] - mc[k]) > 1e-6 * abs(mc[k]) or not np.isfinite(mg[k]):
            fail(f"[train_gan] {k}: card {mg[k]!r} vs CPU {mc[k]!r}")
    worst = 0.0
    for net in ("G", "D"):
        top = max(float(v.abs().max()) for k, v in gc.items()
                  if k.startswith(net))
        for k in (k for k in gc if k.startswith(net)):
            err = float((gg[k] - gc[k]).abs().max())
            sp = float(spread[k].max())
            if err > GRAD_ULPS * sp + GRAD_FLOOR * top:
                fail(f"[train_gan] gradient of {k} off by {err:.3e} (CPU "
                     f"one-ulp spread {sp:.3e}, top {top:.3e})")
            if GRAD_ULPS * sp > GRAD_FLOOR * top:
                worst = max(worst, err / sp)
    return {"losses_card": mg, "losses_cpu": mc,
            "loss_rel_err": max(abs(mg[k] - mc[k]) / abs(mc[k]) for k in mc),
            "grad_err_over_spread": round(worst, 3), "n_grads": len(gc)}


def train_rest(torch, fq, fm, dev, smi_line, root, base, ck) -> dict:
    """The rest of training on ``[train]``'s tree (3 subjects, 512^2
    renders, load size 1024): ``[train_normals]``, ``[train_gan]``,
    ``[train_alternating]``, ``[train_eval]``.  Returns the kernel
    launches of the evaluation."""
    import contextlib
    import io

    import numpy as np

    from rgbd_pifuhd_tpu_torch.cli import run_train
    from rgbd_pifuhd_tpu_torch.data.datasets import TrainDataset
    from rgbd_pifuhd_tpu_torch.models import MultiResPIFu
    from rgbd_pifuhd_tpu_torch.models.blocks import init_flax
    from rgbd_pifuhd_tpu_torch.models.pix2pix import (
        GlobalGenerator, MultiscaleDiscriminator)
    from rgbd_pifuhd_tpu_torch.train import loop
    from rgbd_pifuhd_tpu_torch.train.loop import make_collate_normals
    from rgbd_pifuhd_tpu_torch.train.trainers import (
        make_gan_normal_train_step, make_optimizer)
    from rgbd_pifuhd_tpu_torch.utils import checkpoint as ckpt
    from rgbd_pifuhd_tpu_torch.utils.options import parse_options

    card = {"card": smi_line}
    # ---- [train_normals]: the CLI at the paper's widths, f32, 2 epochs
    t0 = time.time()
    lines = _run_cli(["--stage", "normals", "--dataroot", root, "--name",
                      "nml", "--checkpoints_path", ck, "--num_epoch", "2",
                      "--freq_save", "1", "--batch_size", "1"], base,
                     os.path.join(base, "normals.log"))
    secs = time.time() - t0
    nets, label, peak = {}, None, None
    for ln in lines:
        if ln.startswith("Name: "):
            net = ln.split("Name: ")[1].split()[0]
            d = nets.setdefault(net, {"loss": [], "step": [], "data": []})
            d["loss"].append(float(ln.split("Err: ")[1].split()[0]))
            d["data"].append(float(ln.split("stepD: ")[1].split("ms")[0]))
            d["step"].append(float(ln.split("stepN: ")[1].split("ms")[0]))
        elif ln.startswith("[pretrain_normals] perceptual loss: "):
            label = ln.split(": ")[1]
        elif ln.startswith("peak device memory: "):
            peak = int(ln.split(": ")[1].split()[0])
    res = {}
    for net in ("netF", "netB"):
        d = nets.get(f"nml_{net}")
        if not d or len(d["loss"]) != 2 * len(TRAIN_SUBJECTS) or \
                not np.isfinite(d["loss"]).all():
            fail(f"[train_normals] {net}: {d}")
        pngs = [os.path.exists(os.path.join(
            base, "train_result", f"nml_{net}", f"sample_epoch_{e}.png"))
            for e in (0, 1)]
        if not all(pngs):
            fail(f"[train_normals] {net}: montage PNGs {pngs}")
        res[net] = {"steps": len(d["loss"]), "first_loss": d["loss"][0],
                    "last_loss": d["loss"][-1],
                    "median_step_ms": float(np.median(d["step"][1:])),
                    "median_data_ms": float(np.median(d["data"][1:])),
                    "montage_pngs": pngs}
    if peak is None or label is None:
        fail(f"[train_normals] peak {peak}, perceptual {label}")
    if os.path.exists(ckpt.latest_path(ck, "nml_netG")):
        fail("[train_normals] --stage normals wrote a checkpoint")
    phase("train_normals", json.dumps({
        **card, "widths": "netF/netB GlobalGenerator(64, 4, 9), 1024^2 x 6,"
        " f32 (cuDNN's default TF32 convolutions), batch 1",
        "perceptual": label, "peak_mem_bytes": peak,
        "process_s": round(secs, 2), **res}))

    # ---- [train_gan]: tiny card against CPU, then the paper's widths
    parity = _gan_card_against_cpu(torch, dev)
    opt = parse_options(["--dataroot", root])
    items = TrainDataset(opt, load_mesh=False, seed=0)
    collate = make_collate_normals("imF", "Fstyle")
    gen = GlobalGenerator(6, 3, 64, 4, 9, device="cpu")
    disc = MultiscaleDiscriminator(9, 64, 3, 3, device="cpu")
    init_flax(gen, torch.Generator().manual_seed(0))
    init_flax(disc, torch.Generator().manual_seed(1))
    gen, disc = gen.to(dev), disc.to(dev)
    before = {"G": gen.head.weight.detach().clone(),
              "D": disc.scale2.conv0.weight.detach().clone()}
    step = make_gan_normal_train_step(
        gen, lambda i, x: disc(torch.cat([i, x], -1)),
        make_optimizer("adam", opt.learning_rate, gen.parameters()),
        make_optimizer("adam", opt.learning_rate, disc.parameters()))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ms, losses = [], []
    for i in range(6):          # the first a warm-up, then 5 timed
        b = {k: v.to(dev) for k, v in collate(
            [items[i % len(TRAIN_SUBJECTS)]]).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(b)
        losses.append({k: float(v) for k, v in m.items()})
        ms.append((time.perf_counter() - t0) * 1e3)
    moved = {k: not torch.equal(v, w) for k, v, w in (
        ("G", before["G"], gen.head.weight),
        ("D", before["D"], disc.scale2.conv0.weight))}
    if not all(np.isfinite(list(v.values())).all() for v in losses) or \
            not all(moved.values()):
        fail(f"[train_gan] losses {losses}, moved {moved}")
    phase("train_gan", json.dumps({
        **card, "card_vs_cpu": parity,
        "widths": "GlobalGenerator(64, 4, 9) + MultiscaleDiscriminator(64,"
        " 3 layers, 3 scales) on concat(images, map), 1024^2, f32, TF32 "
        "off, batch 1, no perceptual term",
        "steps": len(ms), "median_step_ms": float(np.median(ms[1:])),
        "first_step_ms": ms[0],
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
        "first_losses": losses[0], "last_losses": losses[-1],
        "moved": moved}))
    del gen, disc, step, before
    torch.cuda.empty_cache()

    # ---- [train_alternating]: one cycle in-process, coarse / fine bf16
    alt_ck = os.path.join(base, "alt")
    opt = parse_options(["--dataroot", root, "--name", "alt",
                         "--checkpoints_path", alt_ck, "--compute_dtype",
                         "bfloat16", "--num_sample_inout", "4096",
                         "--sigma", "8", "--freq_save", "1000"])
    stage_s: list = []
    real = {n: getattr(loop, n) for n in ("pretrain_coarse",
                                           "pretrain_normals", "train_fine")}

    def timed(name):
        def fn(*a, **kw):
            t = time.time()
            out = real[name](*a, **kw)
            torch.cuda.synchronize()
            stage_s.append((name, round(time.time() - t, 2)))
            return out
        return fn

    cwd = os.getcwd()
    os.chdir(base)
    try:
        for n in real:
            setattr(loop, n, timed(n))
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            tree = loop.train_alternating(opt, cycles=1, nml_epochs=1,
                                          coarse_epochs=1, fine_epochs=1,
                                          device=dev)
        total = time.time() - t0
    finally:
        for n, f in real.items():
            setattr(loop, n, f)
        os.chdir(cwd)
    if "netF" not in tree["params"]["netG"]:
        fail("[train_alternating] netF is not in the returned tree's netG")
    fine = ckpt.load_checkpoint(ckpt.latest_path(alt_ck, "alt"), "cpu")
    m = MultiResPIFu(opt.netMR, opt.netG, device="cpu")
    ckpt.load_params(m, fine["params"])
    same = all(np.array_equal(a, ckpt.params_to_flax(m)["params"]["netG"][
        "netF"]["head"][k]) for k, a in tree["params"]["netG"]["netF"][
            "head"].items())
    if not same:
        fail("[train_alternating] the fine checkpoint's netF differs from "
             "the returned tree's")
    del tree, fine, m
    phase("train_alternating", json.dumps({
        **card, "widths": "paper defaults, coarse and fine bf16, netF/netB "
        "f32; one cycle, one epoch (3 steps) a stage",
        "stage_s": stage_s, "total_s": round(total, 2)}))
    shutil.rmtree(alt_ck, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- [train_eval]: --stage eval over [train]'s fine checkpoints
    args = ["--stage", "eval", "--dataroot", root, "--name", "smoke",
            "--checkpoints_path", ck, "--compute_dtype", "bfloat16",
            "--num_sample_inout", "4096", "--sigma", "8", "--freq_save",
            "1000"]
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        _, n = _counts(torch, fq, fm, lambda: run_train.main(args))
    secs = time.time() - t0
    errs = [float(ln.split("= ")[1]) for ln in out.getvalue().splitlines()
            if ln.startswith("epoch ")]
    npy = os.path.join(ck, "smoke_eval_epoch_0.npy")
    if len(errs) != 1 or not np.isfinite(errs).all() or \
            not os.path.exists(npy) or n["fused_gather_mlp"] == 0:
        fail(f"[train_eval] Err(occ:fine) {errs}, npy "
             f"{os.path.exists(npy)}, launches {n}")
    phase("train_eval", json.dumps({
        **card, "epochs": len(errs), "err_occ_fine": errs,
        "batch_losses": np.load(npy).tolist(), "secs": round(secs, 2),
        "launches": n}))
    return n


def jpeg_progressive(smi_line) -> dict:
    """``[jpeg_progressive]``: the committed progressive subject decoded by
    ``utils/jpeg.py`` against its committed expected pixels (what
    ``cv2.imread`` gives, written as PNG; the card's host has no cv2),
    then served by a flagship-lite ``cli.serve`` (512^3); returns the
    process's launch counts."""
    import numpy as np

    from rgbd_pifuhd_tpu_torch.utils import jpeg, png

    src = os.path.join(HERE, "tests", "data", "jpeg_progressive")
    t0 = time.time()
    got = jpeg.read_rgb8(os.path.join(src, "capsule.jpg"))
    decode_s = time.time() - t0
    want = png.read_rgb8(os.path.join(HERE, "tests", "data",
                                      "jpeg_progressive_expected.png"))
    if got.shape != want.shape:
        fail(f"[jpeg_progressive] shape {got.shape} vs {want.shape}")
    diff = int(np.abs(got.astype(int) - want.astype(int)).max())
    if diff:
        fail(f"[jpeg_progressive] max |diff| {diff} against the expected "
             "pixels")
    results = os.path.join(OUT_DIR, "serve_progressive")
    shutil.rmtree(results, ignore_errors=True)
    t0 = time.time()
    srv = _Server(["--load_netMR_checkpoint_path", CKPT, "--results_path",
                   results, "--name", "prog", "--resolution", "512",
                   "--loadSize", "1024"],
                  os.path.join(OUT_DIR, "serve_progressive.log"))
    try:
        (ready,) = srv.read(1)
        if ready.get("ready") is not True:
            fail(f"[jpeg_progressive] no ready line: {ready}")
        t_ready = time.time() - t0
        (reply,), s_req = srv.ask(f"{src}::capsule")
        n = srv.quit()
    finally:
        srv.kill()
    if "mesh" not in reply:
        fail(f"[jpeg_progressive] reply {reply}")
    pos, n_f = _obj_positions(reply["mesh"], reply["verts"])
    if len(pos) == 0 or n_f == 0:
        fail("[jpeg_progressive] empty mesh")
    _check_bbox("[jpeg_progressive] capsule", pos, _subject_box(512))
    if not (n["query_calls"] > 0
            and n["fused_gather_mlp"] == 2 * n["query_calls"]):
        fail(f"[jpeg_progressive] launch counts {n}")
    shutil.rmtree(results, ignore_errors=True)
    phase("jpeg_progressive", json.dumps({
        "card": smi_line,
        "subject": "tests/data/jpeg_progressive/capsule.jpg (512^2, q90, "
        "4:2:0, progressive)", "max_abs_diff": diff,
        "decode_s": round(decode_s, 3), "ready_s": round(t_ready, 2),
        "cold_request_s": round(s_req, 3), "server_secs": reply["secs"],
        "read_secs": reply["read_secs"], "verts": len(pos), "faces": n_f,
        "launches": n}))
    return n


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
        # a last layer wider than one column, phi from the last layer
        wide = PointMLP((37 + 3, 64, 3), 1, (1,), "group",
                        dtype=None if cd == torch.float32 else cd,
                        device=dev)
        for kw in (dict(res_layers=(1,), merge_layer=1, last_op=None),
                   dict(res_layers=(1,), merge_layer=0)):
            _compare(torch, fq.fused_gather_mlp(f, uv, extra, wide.packed(),
                                                **kw),
                     fq.fused_gather_mlp_ref(f, uv, extra, wide.packed(),
                                             **kw),
                     cd, f"40-64-3 GroupNorm merge {kw['merge_layer']} {cd}")
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
    return launches, recon._esc_budgets


# ------------------------------------------------ the other inference paths
def _counts(torch, fq, fm, fn):
    """``fn()`` with every kernel's launch count set to 0 just before it;
    returns ``(fn's result, the counts just after)``."""
    for k in (fq.fused_gather_mlp, fq.gather_concat, fm.fused_point_mlp):
        k.launches = 0
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    return out, {"fused_gather_mlp": fq.fused_gather_mlp.launches,
                 "gather_concat": fq.gather_concat.launches,
                 "fused_point_mlp": fm.fused_point_mlp.launches}


def _check_mesh(label, out, cv) -> None:
    """Non-empty, finite, valid faces, and the bbox holds the subject's
    centre."""
    import numpy as np

    v, f = out["verts"], out["faces"]
    if not (len(v) and len(f) and np.isfinite(v).all() and f.min() >= 0
            and f.max() < len(v)):
        fail(f"{label}: malformed mesh ({len(v)} verts, {len(f)} faces)")
    lo, hi = v.min(0), v.max(0)
    centre = (cv.min(0) + cv.max(0)) / 2
    if not ((lo <= centre) & (centre <= hi)).all():
        fail(f"{label}: the mesh bbox {lo}..{hi} misses the subject centre "
             f"{centre}")


def _cos(a, b):
    import numpy as np

    return (a * b).sum(1) / np.maximum(
        np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1), 1e-12)


def _plain_grad_normals(torch, model, feats, pts, calib):
    """Unit negative gradient of ``MultiResPIFu.field_last``'s chunk sum
    at ``pts [M, 3]`` by plain autograd through the port's modules
    (``geom.index`` and ``PointMLP.forward``), no kernel."""
    from rgbd_pifuhd_tpu_torch.models.coarse import _level_plain
    from rgbd_pifuhd_tpu_torch.ops import geometry as geom

    l_feats, g_feats = feats
    cg = model.netG.cfg
    with torch.enable_grad():
        p = pts.clone().requires_grad_()
        xyz = geom.PROJECTIONS[cg.projection_mode](p[None], calib[None])[0]
        sp = geom.depth_normalize(xyz, cg.load_size, cg.z_size)
        _, phi = _level_plain(model.netG.mlp, g_feats.im_feats[-1][0].to(
            model.netG.mlp.packed().compute_dtype), xyz[:, :2], sp)
        xyz_l = geom.PROJECTIONS[model.cfg.projection_mode](p[None],
                                                            calib[None])[0]
        pred, _ = _level_plain(model.mlp, l_feats.im_feats[-1][0].to(
            model.mlp.packed().compute_dtype), xyz_l[:, :2], phi)
        (g,) = torch.autograd.grad(pred.sum(), p)
    return -g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True),
                            min=1e-8)


def other_paths(torch, fq, fm, model, opt, dev, esc) -> dict:
    """Phase 5: grad and mesh normals, the two-level octree, the dense
    lattice and the coarse model alone, on the capsule at 512^3.  Returns
    each path's launch counts."""
    import copy
    import dataclasses

    import numpy as np

    from rgbd_pifuhd_tpu_torch.data.synthetic import capsule_subject
    from rgbd_pifuhd_tpu_torch.recon import CoarseReconstructor, Reconstructor

    rgbd, calib, cv, _ = capsule_subject(512)
    data = {"img": rgbd[None], "img_512": rgbd[None], "calib": calib}
    path = os.path.join(OUT_DIR, "path.obj")
    counts = {}

    def recon_for(cls=Reconstructor, m=model, **kw):
        r = cls(m, dataclasses.replace(opt, **kw), device=dev)
        r._esc_budgets = copy.deepcopy(esc)
        return r

    def run(r, label, levels=2):
        out, n = _counts(torch, fq, fm, lambda: r.gen_mesh(
            data, path, resolution=512))
        _check_mesh(label, out, cv)
        if n["fused_gather_mlp"] != levels * out["query_calls"] or \
                n["fused_point_mlp"]:
            fail(f"{label}: launches {n} for {out['query_calls']} field "
                 f"queries (want {levels} fused_gather_mlp each)")
        return out, n

    def summary(out, n):
        return {"secs": round(out["secs"], 4), "verts": len(out["verts"]),
                "faces": len(out["faces"]), "query_calls": out["query_calls"],
                "points_queried": out["points_queried"],
                "host_secs": out["host_secs"], "launches": n,
                "bbox": [out["verts"].min(0).round(3).tolist(),
                         out["verts"].max(0).round(3).tolist()]}

    # ---- grad normals: gen_mesh, then the colour pass alone on its mesh in
    # both modes (the same vertices, the same chunks)
    r_grad = recon_for(normal_mode="grad")
    first = run(r_grad, "grad run 0")[0]["secs"]   # the backward's first use
    out, n = run(r_grad, "grad run 1")
    r_fd = recon_for()
    with torch.no_grad():
        feats = r_grad.encode(r_grad._tensor(data["img"]),
                              r_grad._tensor(data["img_512"]))
        calib_t = r_grad._tensor(calib)
        colour_s, cols = {}, {}
        for mode, r in (("fd", r_fd), ("grad", r_grad)):
            torch.cuda.synchronize()
            t0 = time.time()
            cols[mode] = r.color_by_normals_start(out["verts"], feats,
                                                  calib_t)()
            colour_s[mode] = round(time.time() - t0, 4)
    cos = _cos(cols["grad"] * 2 - 1, cols["fd"] * 2 - 1)
    if not np.isfinite(cols["grad"]).all():
        fail("grad: colours not finite")
    # the gradient itself, on one 65,536-vertex chunk with f32 copies of
    # the MLPs: the pipeline's (the kernels forward, the autograd
    # function's backward) against plain autograd through the port's
    # modules (no kernel)
    m32 = copy.deepcopy(model)
    for m in (m32.mlp, m32.netG.mlp):
        m.dtype = None
        m._packed.clear()
    r32 = recon_for(m=m32, normal_mode="grad")
    pts = torch.from_numpy(out["verts"][:65536]).to(dev)
    got = r32._grad_normals(pts, feats, calib_t)
    ref = _plain_grad_normals(torch, m32, feats, pts, calib_t)
    cos_k = _cos(got.cpu().numpy(), ref.cpu().numpy())
    if not float(np.median(cos_k)) > 0.999:
        fail(f"grad: the pipeline's gradient against plain autograd: "
             f"median cosine {np.median(cos_k)}")
    phase("grad", json.dumps({
        **summary(out, n), "secs_runs": [round(first, 4),
                                         round(out["secs"], 4)],
        "colour_pass_secs_same_mesh": colour_s,
        "median_cos_grad_vs_fd": round(float(np.median(cos)), 4),
        "p10_p90_cos_grad_vs_fd": [round(float(np.percentile(cos, q)), 4)
                                   for q in (10, 90)],
        "f32_chunk_vs_plain_autograd_cos_median_p1_min": [
            round(float(np.median(cos_k)), 6),
            round(float(np.percentile(cos_k, 1)), 6),
            round(float(cos_k.min()), 6)]}))
    counts["grad"] = n

    # ---- geometric normals: no device colour pass
    out, n = run(recon_for(normal_mode="mesh"), "mesh_normals")
    if "color" in out["points_queried"]:
        fail(f"mesh_normals: colour queries {out['points_queried']}")
    phase("mesh_normals", json.dumps({
        **summary(out, n), "colour_launches": 0,
        "field_queries_only": list(out["points_queried"]) == ["field"]}))
    counts["mesh_normals"] = n

    # ---- two-level octree: twice (the first may right-size its budget)
    r2 = recon_for(octree_levels=2)
    outs = [run(r2, f"two_level run {k}") for k in range(2)]
    out, n = outs[-1]
    phase("two_level", json.dumps({
        **summary(out, n), "secs_runs": [round(o["secs"], 4)
                                         for o, _ in outs],
        "grid_diag": out["grid_diag"]}))
    counts["two_level"] = n

    # ---- dense lattice: res^2 points a query call
    out, n = run(recon_for(use_octree=False), "dense")
    if out["query_calls"] < 512:
        fail(f"dense: {out['query_calls']} query calls, want 512 + colours")
    hs = out["host_secs"]
    phase("dense", json.dumps({
        **summary(out, n), "field_s": hs.get("field"),
        "pull_s": hs.get("pull"), "march_s": hs.get("march")}))
    counts["dense"] = n

    # ---- the coarse model alone: twice (its own budgets)
    rc = recon_for(CoarseReconstructor, model.netG)
    rc._esc_budgets = {}
    outs = [run(rc, f"coarse_only run {k}", levels=1) for k in range(2)]
    out, n = outs[-1]
    phase("coarse_only", json.dumps({
        **summary(out, n), "secs_runs": [round(o["secs"], 4)
                                         for o, _ in outs],
        "grid_diag": out["grid_diag"]}))
    counts["coarse_only"] = n
    os.remove(path)
    os.remove(path[:-4] + ".png")
    return counts


# ------------------------------------------------------------ served path
def _write_subject(root: str, stem: str, size: int, **shape) -> dict:
    """One request subject as PNG files: ``<stem>.png``,
    ``depth/depth_<stem>.png`` (8-bit) and ``<stem>_rect.txt`` (the whole
    frame).  Returns the subject's bbox in the server's coordinates: the
    reader's calib is a y flip, so the mesh comes out in NDC, y up."""
    import numpy as np

    from rgbd_pifuhd_tpu_torch.data.synthetic import capsule_subject
    from rgbd_pifuhd_tpu_torch.utils.png import write_png

    rgbd, calib, cv, _ = capsule_subject(size, **shape)
    u8 = np.clip(np.rint((rgbd * 0.5 + 0.5) * 255.0), 0, 255).astype(np.uint8)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    write_png(os.path.join(root, f"{stem}.png"), u8[:, :, :3])
    write_png(os.path.join(root, "depth", f"depth_{stem}.png"), u8[:, :, 3:])
    with open(os.path.join(root, f"{stem}_rect.txt"), "w") as f:
        f.write(f"0 0 {size} {size}\n")
    ndc = cv @ calib[:3, :3].T.astype(np.float64) + calib[:3, 3]
    ndc[:, 1] *= -1.0
    return {"lo": ndc.min(0), "hi": ndc.max(0)}


class _Server:
    """``cli/serve`` of the checkout at ``root`` as a subprocess, driven
    line by line."""

    def __init__(self, args, log_path, root=HERE):
        self.log = open(log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "rgbd_pifuhd_tpu_torch.cli.serve"]
            + args, cwd=root, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self.log, text=True, bufsize=1)
        self.log_path = log_path

    def read(self, n: int = 1, timeout: float = 300.0) -> list:
        """The next ``n`` JSON lines of the server's stdout."""
        box: list = []

        def pump():
            while len(box) < n:
                line = self.proc.stdout.readline()
                if not line:
                    return
                if line.startswith("{"):
                    box.append(json.loads(line))

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        t.join(timeout)
        out = list(box)
        if len(out) < n:
            self.kill()
            tail = open(self.log_path).read()[-2000:]
            fail(f"server gave {len(out)} of {n} replies within {timeout} s"
                 f" (exit {self.proc.poll()}); stderr: {tail}")
        return out

    def ask(self, request: str, n: int = 1):
        """Send one request; returns its ``n`` replies and the seconds
        until the last one arrived."""
        t0 = time.time()
        self.proc.stdin.write(request + "\n")
        self.proc.stdin.flush()
        replies = self.read(n)
        return replies, time.time() - t0

    def quit(self) -> dict:
        (last,), _ = self.ask("quit")
        rc = self.proc.wait(timeout=60)
        self.log.close()
        if rc != 0 or not last.get("quit"):
            fail(f"server exit code {rc}, last line {last}")
        return last["launches"]

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if not self.log.closed:
            self.log.close()


def _obj_positions(path: str, n_verts: int):
    """Vertex positions and the face count of an OBJ whose vertex lines
    come first (as the port writes them)."""
    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    n_v = data.count(b"\nv ") + data.startswith(b"v ")
    n_f = data.count(b"\nf ")
    if n_v != n_verts:
        fail(f"{path}: {n_v} vertex lines, the reply said {n_verts}")
    pos = np.loadtxt(path, dtype=np.float32, usecols=(1, 2, 3),
                     max_rows=n_v, comments=None)
    return pos, n_f


def _check_bbox(label, verts, box, tight: bool = False) -> None:
    """The mesh holds the subject: its bbox covers the subject's centre
    and, with ``tight`` (a model trained on this very subject), is the
    subject's within a tenth of its height."""
    import numpy as np

    lo, hi = verts.min(0), verts.max(0)
    centre = (box["lo"] + box["hi"]) / 2
    slack = 0.1 * float(box["hi"][1] - box["lo"][1])
    ok = np.isfinite(verts).all() and ((lo <= centre) & (centre <= hi)).all()
    if tight:
        ok = (ok and (np.abs(lo - box["lo"]) <= slack).all()
              and (np.abs(hi - box["hi"]) <= slack).all())
    if not ok:
        fail(f"{label}: mesh bbox {lo}..{hi} does not hold the subject "
             f"{box['lo']}..{box['hi']}")


def served_path() -> dict:
    """Phase 5.  Returns each process's launch counts: ``a`` (flagship-lite
    server), ``b`` (bench_tiny server), ``run_recon``."""
    import numpy as np

    from rgbd_pifuhd_tpu_torch.recon.mesh import load_ply

    t0 = time.time()
    dir_a = os.path.join(OUT_DIR, "req_flagship")
    dir_b = os.path.join(OUT_DIR, "req_tiny")
    box_a = {"capsule": _write_subject(dir_a, "capsule", 1024),
             "stout": _write_subject(dir_a, "stout", 1024, height=1.1,
                                     radius=0.6)}
    box_b = {"capsule": _write_subject(dir_b, "capsule", 128)}
    phase("requests", f"3 subjects written as PNG in "
          f"{time.time() - t0:.2f} s: {dir_a} (1024^2: capsule, stout), "
          f"{dir_b} (128^2: capsule)")
    results = os.path.join(OUT_DIR, "served")
    counts = {}

    # ---- (a) flagship-lite, full width, 512^3, fd colours, OBJ
    t0 = time.time()
    srv = _Server(["--load_netMR_checkpoint_path", CKPT, "--results_path",
                   results, "--name", "a", "--resolution", "512",
                   "--loadSize", "1024"],
                  os.path.join(OUT_DIR, "serve_a.log"))
    try:
        (ready,) = srv.read(1)
        if ready.get("ready") is not True or ready.get("device") != "cuda":
            fail(f"(a) no ready line on cuda: {ready}")
        t_ready = time.time() - t0
        (bad,), _ = srv.ask(os.path.join(OUT_DIR, "no_such_dir"))
        if "error" not in bad or "no_such_dir" not in bad["request"]:
            fail(f"(a) a bad request was answered with {bad}")
        (cold,), s_cold = srv.ask(f"{dir_a}::capsule")
        pos_cold, _ = _obj_positions(cold["mesh"], cold["verts"])
        (warm,), s_warm = srv.ask(f"{dir_a}::capsule")
        pair, s_pair = srv.ask(dir_a, n=2)
        counts["a"] = srv.quit()
    finally:
        srv.kill()
    if [m.get("name") for m in pair] != ["capsule", "stout"]:
        fail(f"(a) the directory request answered {pair}")
    single, n_f = _obj_positions(warm["mesh"], warm["verts"])
    _check_bbox("(a) capsule", single, box_a["capsule"])
    o = np.lexsort(single.T)
    oc = np.lexsort(pos_cold.T)
    same_cold = single.shape == pos_cold.shape and bool(
        (single[o] == pos_cold[oc]).all())
    # the pair's file for "capsule" replaced the single request's
    again, n_f2 = _obj_positions(pair[0]["mesh"], pair[0]["verts"])
    o2 = np.lexsort(again.T)
    if not (again.shape == single.shape and (again[o2] == single[o]).all()
            and n_f2 == n_f and same_cold):
        fail(f"(a) the two-subject request's capsule ({len(again)} verts, "
             f"{n_f2} faces) is not the single request's ({len(single)}, "
             f"{n_f}); cold == warm: {same_cold}")
    stout, n_f3 = _obj_positions(pair[1]["mesh"], pair[1]["verts"])
    _check_bbox("(a) stout", stout, box_a["stout"])
    n = counts["a"]
    if not (n["query_calls"] > 0 and n["fused_point_mlp"] == 0
            and n["gather_concat"] == 0
            and n["fused_gather_mlp"] == 2 * n["query_calls"]):
        fail(f"(a) launch counts {n}: want 2 fused_gather_mlp per field "
             f"query and no fused_point_mlp (GroupNorm model)")
    phase("serve_a", json.dumps({
        "model": "flagship-lite, bf16, mlp_norm group, 512^3, OBJ",
        "ready_s": round(t_ready, 2),
        "single_cold_s": round(s_cold, 3), "single_warm_s": round(s_warm, 3),
        "single_warm_server_secs": warm["secs"],
        "single_warm_read_secs": warm["read_secs"],
        "bbox": [single.min(0).round(3).tolist(),
                 single.max(0).round(3).tolist()],
        "subject": [box_a["capsule"]["lo"].round(3).tolist(),
                    box_a["capsule"]["hi"].round(3).tolist()],
        "pair_s": round(s_pair, 3), "pair_per_mesh_s": round(s_pair / 2, 3),
        "pair_server_secs": [m["secs"] for m in pair],
        "verts": {"capsule": len(single), "stout": len(stout)},
        "faces": {"capsule": n_f, "stout": n_f3},
        "pair_capsule_equals_single": True, "launches": n}))

    # ---- (b) bench_tiny (norm-free), image colours + cleanup, PLY
    t0 = time.time()
    srv = _Server(["--load_netMR_checkpoint_path", CKPT_TINY,
                   "--results_path", results, "--name", "b", "--resolution",
                   "512", "--loadSize", "128", "--use_color", "2",
                   "--mesh_format", "ply"],
                  os.path.join(OUT_DIR, "serve_b.log"))
    try:
        (ready,) = srv.read(1)
        if ready.get("ready") is not True or ready.get("device") != "cuda":
            fail(f"(b) no ready line on cuda: {ready}")
        (cold,), s_cold = srv.ask(f"{dir_b}::capsule")
        (warm,), s_warm = srv.ask(f"{dir_b}::capsule")
        counts["b"] = srv.quit()
    finally:
        srv.kill()
    if "mesh" not in warm or not warm["mesh"].endswith(".ply"):
        fail(f"(b) reply {warm}")
    v, f, c = load_ply(warm["mesh"])
    if not (len(v) == warm["verts"] > 0 and len(f) > 0 and c is not None
            and c.shape == v.shape and f.min() >= 0 and f.max() < len(v)):
        fail(f"(b) PLY holds {len(v)} verts / {len(f)} faces, reply {warm}")
    _check_bbox("(b) capsule", v, box_b["capsule"], tight=True)
    ext = v.max(0) - v.min(0)
    if not 2.0 < ext[1] / ext[0] < 3.0:
        fail(f"(b) extents {ext}: not the capsule (height / width 2.45)")
    n = counts["b"]
    if not (n["fused_point_mlp"] == n["query_calls"] > 0
            and n["gather_concat"] == n["query_calls"]
            and n["fused_gather_mlp"] == n["query_calls"]):
        fail(f"(b) launch counts {n}: want one fused_point_mlp (fine level) "
             f"and one fused_gather_mlp (coarse level) per field query")
    phase("serve_b", json.dumps({
        "model": "bench_tiny, f32, mlp_norm none, 512^3, image colours + "
                 "cleanup, PLY", "ready_s": round(time.time() - t0, 2),
        "single_cold_s": round(s_cold, 3), "single_warm_s": round(s_warm, 3),
        "single_warm_server_secs": warm["secs"],
        "single_warm_read_secs": warm["read_secs"], "verts": len(v),
        "faces": len(f), "extent": ext.round(3).tolist(),
        "mean_colour": c.mean(0).round(3).tolist(), "launches": n,
        "launches_per_mesh": n["fused_point_mlp"] // 2}))

    # ---- run_recon on (b)'s directory, fd colours, OBJ
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "rgbd_pifuhd_tpu_torch.cli.run_recon",
         "--dataroot", dir_b, "--load_netMR_checkpoint_path", CKPT_TINY,
         "--results_path", results, "--name", "batch", "--resolution", "512",
         "--loadSize", "128", "--use_color", "0"],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        fail(f"run_recon exit {r.returncode}: {r.stderr[-2000:]}")
    last = r.stdout.strip().splitlines()[-1]
    if not last.startswith("launches "):
        fail(f"run_recon's last line: {last}")
    counts["run_recon"] = n = json.loads(last.split(" ", 1)[1])
    obj = os.path.join(results, "batch", "recon", "result_capsule_512.obj")
    pos, n_f = _obj_positions(obj, int(r.stdout.split("verts=")[1].split()[0]))
    # fd-colour meshes stay in the reader's frame (NDC), as gen_mesh's do
    _check_bbox("run_recon capsule", pos, box_b["capsule"], tight=True)
    if not (n["fused_point_mlp"] == n["query_calls"] > 0):
        fail(f"run_recon launch counts {n}")
    phase("run_recon", json.dumps({
        "model": "bench_tiny, 512^3, fd colours, OBJ",
        "process_s": round(time.time() - t0, 2), "verts": len(pos),
        "faces": n_f, "launches": n}))
    # ---- [serve_jpeg]: flagship-lite answers the committed JPEG subject
    counts["jpeg"] = served_jpeg(results)
    for d in (dir_a, dir_b, results):
        shutil.rmtree(d)
    return counts


def _subject_box(size: int) -> dict:
    """The capsule subject's bbox in the server's coordinates (NDC, y
    up), as ``_write_subject`` returns it."""
    import numpy as np

    from rgbd_pifuhd_tpu_torch.data.synthetic import capsule_subject

    _, calib, cv, _ = capsule_subject(size)
    ndc = cv @ calib[:3, :3].T.astype(np.float64) + calib[:3, 3]
    ndc[:, 1] *= -1.0
    return {"lo": ndc.min(0), "hi": ndc.max(0)}


def served_jpeg(results: str) -> dict:
    """A flagship-lite server (512^3, fd colours, OBJ) answers the capsule
    as a JPEG file (``tests/data/jpeg_subject``: 512^2, quality 90, 4:2:0,
    decoded by ``utils/jpeg.py``); returns the process's launch counts."""
    src = os.path.join(HERE, "tests", "data", "jpeg_subject")
    t0 = time.time()
    srv = _Server(["--load_netMR_checkpoint_path", CKPT, "--results_path",
                   results, "--name", "jpeg", "--resolution", "512",
                   "--loadSize", "1024"],
                  os.path.join(OUT_DIR, "serve_jpeg.log"))
    try:
        (ready,) = srv.read(1)
        if ready.get("ready") is not True:
            fail(f"(jpeg) no ready line: {ready}")
        t_ready = time.time() - t0
        (reply,), s_req = srv.ask(f"{src}::capsule")
        n = srv.quit()
    finally:
        srv.kill()
    if "mesh" not in reply:
        fail(f"(jpeg) reply {reply}")
    pos, n_f = _obj_positions(reply["mesh"], reply["verts"])
    _check_bbox("(jpeg) capsule", pos, _subject_box(512))
    if not (n["query_calls"] > 0
            and n["fused_gather_mlp"] == 2 * n["query_calls"]):
        fail(f"(jpeg) launch counts {n}")
    phase("serve_jpeg", json.dumps({
        "model": "flagship-lite, bf16, 512^3, fd colours, OBJ",
        "subject": "tests/data/jpeg_subject/capsule.jpg (512^2, q90, 4:2:0)",
        "ready_s": round(t_ready, 2), "cold_request_s": round(s_req, 3),
        "server_secs": reply["secs"], "read_secs": reply["read_secs"],
        "verts": len(pos), "faces": n_f, "launches": n}))
    return n


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


def time_layers(torch, fq, model, dev) -> None:
    """Every launch of the coarse and the fine chain alone, at N = 262144,
    bf16 (CUDA events around ``Chain.run_one`` after one whole run has
    filled the buffers): milliseconds beside the operations bound, the bytes
    bound (each activation read once and written once) and, as
    ``library_ms``, one ``torch.matmul`` of the same [N, K] x [K, M] bf16
    product (timed here only: the port never calls it)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    N = 262144
    out = {}
    for name, m, merge in (("coarse", model.netG.mlp, model.netG.mlp.merge),
                           ("fine", model.mlp, -1)):
        feat, uv, extra = _level_inputs(torch, name, N, dev, gen)
        feat = feat.to(torch.bfloat16).contiguous()
        packed = m.packed()
        c = fq.Chain(feat, uv, extra, packed, merge, 32, "sigmoid", None)
        c.run()
        torch.cuda.synchronize()
        g_bytes = uv.numel() * 4 + extra.numel() * 4 + N * c.plan.k0p * 2
        rows = [{"launch": "gather", "ms": round(_event_ms(
            torch, lambda: c.run_one(0), 20), 4), "bound_ops_ms": 0.0,
            "bound_bytes_ms": round(g_bytes / HBM_BPS * 1e3, 4),
            "library_ms": None}]
        for i, (lp, L) in enumerate(zip(c.plan.layers, packed.layers)):
            d = lp.ints
            K, M = int(L.weight.shape[1]), d["M"]
            byts = N * (d["lda1"] + d.get("lda2", 0)) * 2 + L.weight.numel() \
                * 2 + N * (M * 4 if d["last"] else d["ldo"] * 2) \
                + (N * d["K1"] * 4 if lp.phi == "phi_out" else 0)
            a = torch.randn((N, K), generator=gen, device=dev).to(
                torch.bfloat16)
            wt = L.weight.t().contiguous()
            rows.append({
                "launch": f"L{i} {K}->{M}" + (" +phi" if lp.phi else ""),
                "kind": ("f32", "wgmma", "head")[d["kind"]],
                "ms": round(_event_ms(torch, lambda: c.run_one(i + 1), 20),
                            4),
                "bound_ops_ms": round(2 * N * K * M / PEAK_BF16 * 1e3, 4),
                "bound_bytes_ms": round(byts / HBM_BPS * 1e3, 4),
                "library_ms": round(_event_ms(
                    torch, lambda: torch.matmul(a, wt), 20), 4)})
            del a
        whole = _event_ms(torch, c.run, 20)
        out[name] = {"launches": rows,
                     "sum_ms": round(sum(r["ms"] for r in rows), 4),
                     "floor_ms": round(sum(max(r["bound_ops_ms"],
                                               r["bound_bytes_ms"])
                                           for r in rows), 4),
                     "chain_ms": round(whole, 4)}
    phase("time_layers", json.dumps({
        "work": "each launch of one chain alone, N=262144, bf16", **out}))


def _norm_free_mlp(torch, PointMLP, chans, res, cd, dev, seed):
    """Seeded norm-free PointMLP whose activations stay O(1) through the
    chain (std 1.4 / sqrt(fan_in) weights, 0.1 biases)."""
    m = PointMLP(chans, 2, res, "none",
                 dtype=None if cd == torch.float32 else cd, device=dev)
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    with torch.no_grad():
        for i in range(m.n_layers):
            lin = getattr(m, f"dense{i}")
            w = torch.randn(lin.weight.shape, generator=g) * (
                1.4 / lin.weight.shape[1] ** 0.5)
            lin.weight.copy_(w.to(dev))
            lin.bias.copy_((torch.randn(lin.bias.shape, generator=g)
                            * 0.1).to(dev))
    m._packed.clear()
    return m


def _tiny_fine_mlps(torch, PointMLP, dev):
    """bench_tiny's fine MLP (48-64-32-1, res (1)) with its trained
    weights, as f32 and as bf16."""
    from rgbd_pifuhd_tpu_torch.models import MultiResPIFu
    from rgbd_pifuhd_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                        load_params)
    from rgbd_pifuhd_tpu_torch.utils.options import Options

    ckpt = load_checkpoint(CKPT_TINY, device=dev)
    opt = Options.from_dict(ckpt["opt"])
    model = MultiResPIFu(opt.netMR, opt.netG, device=dev)
    load_params(model, ckpt["params"])
    m32 = model.mlp
    m16 = PointMLP(m32.filter_channels, m32.merge, m32.res_layers, "none",
                   dtype=torch.bfloat16, device=dev)
    m16.load_state_dict(m32.state_dict())
    return m32, m16


def mlp_kernel_checks(torch, fq, fm, PointMLP, dev) -> dict:
    """fused_point_mlp against its plain version on the card."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    bad = []
    main_err = 0.0
    spread = {}

    def check(label, m, x, cd, main=False):
        nonlocal main_err
        packed = m.packed()
        for last_op in ("sigmoid", None):
            kw = dict(res_layers=m.res_layers, last_op=last_op)
            got = fm.fused_point_mlp(x, packed, **kw)
            again = fm.fused_point_mlp(x, packed, **kw)
            ref = fm.fused_point_mlp_ref(x, packed, res_layers=m.res_layers,
                                         last_op=last_op)
            torch.cuda.synchronize()
            if got.shape != ref.shape or not torch.isfinite(got).all():
                fail(f"{label}: output shape/finiteness {tuple(got.shape)}")
            if not torch.equal(got, again):
                bad.append(f"{label} {last_op}: two launches differ")
            err = float((got - ref).abs().max())
            mag = float(ref.abs().max())
            if cd == torch.float32:
                tol = TOL_F32 * max(1.0, mag)
            elif last_op == "sigmoid":
                tol = TOL_BF16_PRED
            else:
                tol = TOL_BF16_RAW_REL * mag
            ok = err <= tol
            phase("check", f"fused_point_mlp {label} last_op={last_op}: "
                  f"max|d| {err:.3e} (tol {tol:.3g}, max|ref| {mag:.3g}, "
                  f"tile {fm.fused_point_mlp.last_block}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"{label} {last_op}")
            if cd == torch.bfloat16:
                key = "sigmoid" if last_op else "raw_rel"
                spread[key] = max(spread.get(key, 0.0),
                                  err if last_op else err / max(mag, 1e-9))
                if main and last_op == "sigmoid":
                    main_err = max(main_err, err)

    for name, chans, res in FULL_SHAPES:
        for cd in (torch.float32, torch.bfloat16):
            m = _norm_free_mlp(torch, PointMLP, chans, res, cd, dev, seed=5)
            for N in (262144, 1000):
                x = (torch.randn((N, chans[0]), generator=gen, device=dev)
                     * 0.7).to(cd)
                check(f"{name} {'-'.join(map(str, chans))} {cd} N={N}", m, x,
                      cd, main=N == 262144)
        # bf16 ragged edges: a ragged last tile (an odd and an even number
        # of tiles), and N below one tile
        m = _norm_free_mlp(torch, PointMLP, chans, res, torch.bfloat16, dev,
                           seed=5)
        bm = fm.plan_wgmma(m.packed()).bm
        for N in (bm * 9 + 1, bm * 6 + 1, 50):
            x = (torch.randn((N, chans[0]), generator=gen, device=dev)
                 * 0.7).to(torch.bfloat16)
            check(f"{name} {'-'.join(map(str, chans))} bf16 ragged N={N}", m,
                  x, torch.bfloat16)
    m32, m16 = _tiny_fine_mlps(torch, PointMLP, dev)
    for cd, m in ((torch.float32, m32), (torch.bfloat16, m16)):
        for N in (262144, 1000):
            x = (torch.randn((N, 48), generator=gen, device=dev) * 0.7).to(cd)
            check(f"bench_tiny fine 48-64-32-1 {cd} N={N}", m, x, cd)
    # the padded rows gather_concat hands over (C0 = 257 -> 264 columns)
    name, chans, res = FULL_SHAPES[0]
    m = _norm_free_mlp(torch, PointMLP, chans, res, torch.bfloat16, dev, 5)
    feat, uv, extra = _level_inputs(torch, "coarse", 5000, dev, gen)
    x0 = fq.gather_concat(feat.to(torch.bfloat16).contiguous(), uv, extra)
    if x0.shape != (5000, 264) or float(x0[:, 257:].abs().max()) != 0.0:
        fail(f"gather_concat: shape {tuple(x0.shape)} or non-zero padding")
    x0_ref = torch.cat([fq.gather_ref(feat.to(torch.bfloat16), uv), extra],
                       dim=-1).to(torch.bfloat16)
    if not torch.equal(x0[:, :257], x0_ref):
        bad.append("gather_concat differs from gather_ref")
    check("coarse chain on gather_concat rows (ld 264)", m, x0,
          torch.bfloat16)
    with_gn = PointMLP((40, 64, 1), 1, (), "group", device=dev)
    try:
        fm.fused_point_mlp(torch.zeros((8, 40), device=dev),
                           with_gn.packed(), res_layers=())
        bad.append("a GroupNorm chain did not raise")
    except ValueError:
        pass
    if bad:
        fail(f"fused_point_mlp disagrees with its plain version: {bad}")
    phase("kernels", json.dumps({
        "kernel": "fused_point_mlp",
        "replaces": "rgbd_pifuhd_tpu/ops/pallas_mlp.py:51",
        "max_abs_err_bf16_sigmoid_main": main_err,
        "tolerance": TOL_BF16_PRED, "bf16_spread": spread,
        "launches_in_checks": fm.fused_point_mlp.launches}))
    return {"main_err": main_err, "main_tol": TOL_BF16_PRED}


def time_mlp_kernel(torch, fq, fm, PointMLP, dev) -> dict:
    """Both full-width norm-free chains at N = 262144, bf16: the chain alone
    through fused_point_mlp (and its plain version), and the level's whole
    query by the two routes: gather + fused_point_mlp against
    fused_gather_mlp (one launch per layer)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    N = 262144
    rows = {}
    for name, chans, res in FULL_SHAPES:
        m = _norm_free_mlp(torch, PointMLP, chans, res, torch.bfloat16, dev,
                           seed=5)
        packed = m.packed()
        feat, uv, extra = _level_inputs(torch, name, N, dev, gen)
        feat = feat.to(torch.bfloat16).contiguous()
        x0 = fq.gather_concat(feat, uv, extra)
        kw = dict(res_layers=res)
        # the two routes compute one function: hold them to each other
        d = float((fm.fused_point_mlp(x0, packed, **kw)
                   - fq.fused_gather_mlp(feat, uv, extra, packed,
                                         merge_layer=-1, **kw)[0])
                  .abs().max())
        if not d <= TOL_BF16_PRED:
            fail(f"{name}: the whole-chain route and the per-layer route "
                 f"differ by {d:.3e} (tol {TOL_BF16_PRED:g})")
        macs = sum(int(L.weight.numel()) for L in packed.layers)
        flop = 2 * N * macs
        w_bytes = sum(L.weight.numel() * 2 + L.bias.numel() * 4
                      for L in packed.layers)
        byts = N * chans[0] * 2 + w_bytes + N * chans[-1] * 4
        r = {"macs_per_point": macs, "flop": flop, "bytes": byts,
             "max_abs_diff_between_routes": d}
        r["chain_ms"] = round(_event_ms(
            torch, lambda: fm.fused_point_mlp(x0, packed, **kw), 10), 4)
        r["chain_tile"] = fm.fused_point_mlp.last_block
        r["chain_plain_ms"] = round(_event_ms(
            torch, lambda: fm.fused_point_mlp_ref(x0, packed, **kw), 3), 4)
        r["gather_plus_chain_ms"] = round(_event_ms(
            torch, lambda: fm.fused_point_mlp(
                fq.gather_concat(feat, uv, extra), packed, **kw), 10), 4)
        r["per_layer_route_ms"] = round(_event_ms(
            torch, lambda: fq.fused_gather_mlp(
                feat, uv, extra, packed, merge_layer=-1, **kw), 10), 4)
        r["chain_ms_again"] = round(_event_ms(
            torch, lambda: fm.fused_point_mlp(x0, packed, **kw), 10), 4)
        ops_ms = flop / PEAK_BF16 * 1e3
        bytes_ms = byts / HBM_BPS * 1e3
        r.update(bound_ops_ms=round(ops_ms, 4),
                 bound_bytes_ms=round(bytes_ms, 4),
                 tflops=round(flop / (min(r["chain_ms"], r["chain_ms_again"])
                                      * 1e-3) / 1e12, 2),
                 per_layer_route_tflops=round(
                     flop / (r["per_layer_route_ms"] * 1e-3) / 1e12, 2))
        rows[name] = r
    phase("time", json.dumps({
        "work": "norm-free chains, N=262144, bf16, seeded weights",
        **rows, "library": "none: no single PyTorch call computes the "
        "chain; chain_plain_ms is the plain per-layer chain"}))
    f = rows["fine"]
    return {"ms": min(f["chain_ms"], f["chain_ms_again"]),
            "plain_ms": f["chain_plain_ms"],
            "bound_ms": max(f["bound_ops_ms"], f["bound_bytes_ms"]),
            "bound_by": "operations" if f["bound_ops_ms"]
            >= f["bound_bytes_ms"] else "bytes",
            "library_ms": None,
            "shape": "fine 272-512-256-128-1, N=262144, bf16",
            "tile": f["chain_tile"],
            "per_layer_route_ms": f["per_layer_route_ms"],
            "coarse_shape_ms": min(rows["coarse"]["chain_ms"],
                                   rows["coarse"]["chain_ms_again"]),
            "coarse_shape_bound_ms": rows["coarse"]["bound_ops_ms"],
            "coarse_shape_plain_ms": rows["coarse"]["chain_plain_ms"],
            "coarse_shape_per_layer_route_ms":
                rows["coarse"]["per_layer_route_ms"]}


if __name__ == "__main__":
    main()
