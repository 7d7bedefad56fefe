#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rgbd_pifuhd_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, one
line each; any failure exits non-zero:

1. environment: card, torch/CUDA versions, TF32 settings (both off);
2. build: the CUDA kernel (nvcc, sm_90a) and the native host libraries
   (g++), started together, from the sources in the checkout;
3. kernel against its plain PyTorch version on the card, at the main
   path's shapes, both GroupNorm scopes, f32 and bf16, plus a ragged N, a
   narrow norm-free chain and the texture field's colour chain at its
   published widths (513-1024-512-256-128-3, norm-free, the three-column
   tanh head, a ragged N; the plan's last layer checked);
4. main path: flagship-lite ``gen_mesh`` at 512^3 on the capsule subject,
   three times (warm-up + two timed), every field query through the
   kernel (launch count checked), OBJ checked; then ``[texture]``: two
   ``--use_color 3`` meshes of it (``gen_mesh(use_color=3)``, a seeded
   netC at the published widths), the colour chain's ``color_query``
   launches checked against the mesh's ``color_calls``, the OBJ's colours
   against their range and spread;
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
4b. ``[turntable]``: the main path's OBJ turned into a 6-frame 512^2
   Motion-JPEG ``.avi`` (``recon.turntable``), read back and decoded;
5b. ``[segment]``: GrabCut (``native/grabcut.cc``) on the served 1024^2
   capsule, IoU against its exact mask, and ``crop_people``;
6c. the rest of training on ``[train]``'s tree: ``[train_normals]``
   (``cli.run_train --stage normals`` at the paper's widths, 1024^2),
   ``[train_gan]`` (one GAN step card against CPU at tiny widths, then 5
   steps at the paper's widths), ``[train_alternating]`` (one cycle of
   the curriculum in-process, one epoch a stage), ``[train_eval]``
   (``cli.run_train --stage eval`` in-process over ``[train]``'s fine
   checkpoints, with the kernel launches it caused), and
   ``[jpeg_progressive]`` (the committed progressive subject decoded
   against its committed expected pixels, then served by ``cli.serve``);
6d. offline data generation: ``[gen_data]`` (``cli.gen_data --obj_dir
   --use_prt --yaw_step 4`` on two OBJ subjects, one textured at 81,920
   faces: 90 views each at 512 / 1024, with PRT, rasterising and encoding
   seconds), ``[gen_data_train]`` (``cli.run_train --stage coarse`` on the
   generated tree, paper widths, bf16), ``[gen_data_eval]`` (``--stage
   eval`` over ``[train]``'s fine checkpoints on the generated tree, with
   its kernel launches) and ``[debug_vis]``;
5c. multi-device paths on the one card (a shared-card check): a two-shard
   mesh with the card listed twice — ``[shard_query]`` (flagship-lite's
   sharded field query at N = 262,144, bf16, bit-equal to its two halves'
   calls; ``bench_tiny``'s norm-free query equal to the unsharded call)
   and ``[shard_mesh]`` (flagship-lite ``gen_mesh`` at 512^3 on the mesh:
   active cells within 1 % of the unsharded run, launches twice the query
   calls); then, as spawned ranks on ``[train]``'s tree, ``[dist_nccl]``
   (``shard_train_step`` on one NCCL rank equal bit for bit to the
   unwrapped paper-width f32 step), ``[dist_train]`` (two gloo ranks, 3
   fine steps at the paper's widths, f32, global batch 2: losses within
   rtol 1e-4 of one process, rank 1 writes nothing) and ``[dist_eval]``
   (``evaluate_checkpoints`` over two gloo ranks against one process,
   1e-5, each rank's launches);
6f. the checkpoint recipes: ``[flagship_train]`` (``tools.
   train_bench_flagship``, the full 384.6 M-parameter flagship, bf16, on
   its own 1024^2 tree, as a subprocess SIGKILLed right after it saves
   ``stage2_coarse``, then rerun: it must resume past stage 2; ms a step,
   peak memory, stage files' MB and write seconds, ambiguous cells),
   ``[flagship_mesh]`` (``cli.run_recon`` on that checkpoint at 512^3 on
   the recipe's 1024^2 capsule, twice, the same mesh inside its box;
   its load, encode seconds beside flagship-lite's, encode FLOPs) and
   ``[tiny_train]`` (``tools.train_bench_tiny`` at 400 steps, then
   ``cli.run_recon`` through both kernels, and its field against the
   committed ``bench_tiny``'s: IoU on a dense 128^3 lattice);
7. times (CUDA events) of both kernels and their plain versions at the
   full-width shapes, beside the card's bound for the same work (and the
   query's FLOP/s as ``utils/flops`` counts it, with its share of the
   card's peak), and of
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
import statistics
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
    tex_launches = 0 if kernels_only else texture_path(torch, fq, model,
                                                       opt, dev)
    if not kernels_only:
        turntable(smi_line)
    # ---- 5. the other inference paths
    paths = {} if kernels_only else other_paths(torch, fq, fm, model, opt,
                                                dev, esc)
    # ---- 5b. the same paths sharded over a two-shard mesh on the card
    if not kernels_only:
        paths.update(shard_paths(torch, fq, fm, model, opt, dev, esc))

    served = {} if kernels_only else served_path()
    mlp_launches = served.get("b", {}).get("fused_point_mlp", 0)
    # ---- 6b. training: the port's own tree, card against CPU, the CLI;
    # then the rest of training on the same tree, and progressive JPEG
    if not kernels_only:
        root, base, ck = train_phase(torch, dev, smi_line)
        paths["eval"] = train_rest(torch, fq, fm, dev, smi_line, root, base,
                                   ck)
        # ---- 6d. offline data generation: OBJ subjects -> a tree that
        # trains and evaluates on the card ([train]'s checkpoints)
        paths["gen_data_eval"] = gen_data_phase(torch, fq, fm, smi_line,
                                                base, ck)
        # ---- 6e. several processes: NCCL bit for bit, data-parallel
        # training and evaluation over two gloo ranks on the card
        paths.update(dist_phases(torch, fq, fm, dev, smi_line, root, ck))
        shutil.rmtree(base, ignore_errors=True)
        paths.update(recipe_phases(torch, fq, fm, model, smi_line))
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
            "tolerance": kres["main_tol"], **timing,
            "color_query_launches": tex_launches}
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


# ------------------------------------------------ offline data generation
GEN_TEXTURE = 1024          # the textured subject's map_Kd, pixels a side


def _write_gen_subjects(objs: str) -> dict:
    """Two OBJ subjects, 180 units tall at the training box's centre:
    ``textured_100k.obj`` (the bumpy sphere at subdivision 6, 81,920 faces,
    spherical ``vt``, an ``.mtl`` with ``Kd`` and a 1024^2 JPEG ``map_Kd``
    written by ``utils/jpeg``) and ``capsule.obj`` (``Kd`` only).  Returns
    each one's face count."""
    import numpy as np

    from rgbd_pifuhd_tpu_torch.data.synthetic import (
        SUBJECT_CENTER, make_bumpy_sphere, make_capsule,
        normalize_mesh_height)
    from rgbd_pifuhd_tpu_torch.utils.jpeg import write_jpeg

    os.makedirs(objs)
    v, f = make_bumpy_sphere(subdiv=6)
    d = v / np.linalg.norm(v, axis=1, keepdims=True)
    uv = np.stack([np.arctan2(d[:, 0], d[:, 2]) / (2 * np.pi) + 0.5,
                   np.arccos(np.clip(d[:, 1], -1, 1)) / np.pi], 1)
    v = normalize_mesh_height(v) + SUBJECT_CENTER
    yy, xx = np.mgrid[:GEN_TEXTURE, :GEN_TEXTURE]
    tex = np.stack([128 + 100 * np.sin(xx / 23.0),
                    128 + 100 * np.cos(yy / 17.0),
                    128 + 60 * np.sin((xx + yy) / 41.0)], -1).astype(np.uint8)
    write_jpeg(os.path.join(objs, "skin texture.jpg"), tex)
    with open(os.path.join(objs, "textured.mtl"), "w") as fh:
        fh.write("newmtl skin\nKd 0.8 0.7 0.6\nmap_Kd skin texture.jpg\n")
    with open(os.path.join(objs, "textured_100k.obj"), "w") as fh:
        fh.write("mtllib textured.mtl\nusemtl skin\n")
        fh.writelines(f"v {p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n" for p in v)
        fh.writelines(f"vt {t[0]:.6f} {t[1]:.6f}\n" for t in uv)
        fh.writelines(f"f {a}/{a} {b}/{b} {c}/{c}\n" for a, b, c in f + 1)
    faces = {"textured": len(f)}
    v, f = make_capsule(1.6, 0.55, 4)
    v = normalize_mesh_height(v) + SUBJECT_CENTER
    with open(os.path.join(objs, "capsule.mtl"), "w") as fh:
        fh.write("newmtl body\nKd 0.3 0.5 0.8\n")
    with open(os.path.join(objs, "capsule.obj"), "w") as fh:
        fh.write("mtllib capsule.mtl\nusemtl body\n")
        fh.writelines(f"v {p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n" for p in v)
        fh.writelines(f"f {a} {b} {c}\n" for a, b, c in f + 1)
    faces["capsule"] = len(f)
    return faces


def gen_data_phase(torch, fq, fm, smi_line, base, ck) -> dict:
    """``[gen_data]``: two OBJ subjects rendered by ``cli.gen_data
    --use_prt --yaw_step 4`` at 512 / 1024 (90 views each), every mask
    non-empty, every PARAM's calib taking the bbox centre to the NDC
    origin; ``[gen_data_train]``: ``cli.run_train --stage coarse`` on the
    tree at the paper's widths in bf16 (2 epochs of its 2 images);
    ``[gen_data_eval]``: ``--stage eval`` over ``[train]``'s fine
    checkpoints on the tree, in-process, with the kernel launches it
    caused (returned); ``[debug_vis]``: ``cli.debug_vis`` on the tree."""
    import ast
    import contextlib
    import io

    import numpy as np

    from rgbd_pifuhd_tpu_torch.cli import run_train
    from rgbd_pifuhd_tpu_torch.data.datasets import _calib_from_param
    from rgbd_pifuhd_tpu_torch.utils import png

    card = {"card": smi_line}
    objs = os.path.join(OUT_DIR, "gen_objs")
    tree = os.path.join(OUT_DIR, "gen_tree")
    for d in (objs, tree):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.time()
    faces = _write_gen_subjects(objs)
    write_s = time.time() - t0
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "rgbd_pifuhd_tpu_torch.cli.gen_data", "--out",
         tree, "--obj_dir", objs, "--use_prt", "--yaw_step", "4"],
        cwd=HERE, capture_output=True, text=True, timeout=900,
        env={**os.environ, "PYTHONPATH": HERE})
    secs = time.time() - t0
    if r.returncode != 0:
        fail(f"[gen_data] exit {r.returncode}: {r.stderr[-3000:]}")
    lines = r.stdout.splitlines()
    views = ast.literal_eval(lines[0].split("rendered ")[1].split(" into")[0])
    seconds = json.loads(lines[1])["seconds"]
    if views != {"textured": 90, "capsule": 90}:
        fail(f"[gen_data] views {views}")
    worst = 0.0
    for subj in views:
        for yaw in range(0, 360, 4):
            tag = f"{yaw}_0_00"
            m = png.read_png(os.path.join(tree, "MASK", subj, f"{tag}.png"))
            if not (m > 127).any():
                fail(f"[gen_data] {subj} {tag}: empty mask")
            param = np.load(os.path.join(tree, "PARAM", subj, f"{tag}.npy"),
                            allow_pickle=True).item()
            calib, _ = _calib_from_param(param, 1024)
            c = calib @ np.append(param["center"], 1.0)
            worst = max(worst, float(np.abs(c[:3]).max()))
    if worst > 1e-6:
        fail(f"[gen_data] a calib takes the bbox centre to {worst} in NDC")
    n_views = sum(views.values())
    phase("gen_data", json.dumps({
        **card, "subjects": {"textured": f"{faces['textured']} faces, "
                             f"{GEN_TEXTURE}^2 JPEG map_Kd",
                             "capsule": f"{faces['capsule']} faces, Kd"},
        "size": 512, "load_size": 1024, "use_prt": True, "yaw_step": 4,
        "views": views, "obj_write_s": round(write_s, 2),
        "process_s": round(secs, 2), "seconds": seconds,
        "raster_s_per_view": seconds["raster"] / n_views,
        "encode_s_per_view": seconds["encode"] / n_views,
        "max_abs_ndc_of_bbox_centre": worst}))

    # ---- [gen_data_train]: the coarse stage on the generated tree
    gck = os.path.join(base, "gen_ck")
    os.makedirs(gck)
    res = _run_train(["--stage", "coarse", "--dataroot", tree, "--name",
                      "gen", "--checkpoints_path", gck, "--compute_dtype",
                      "bfloat16", "--num_sample_inout", "4096", "--sigma",
                      "8", "--batch_size", "1", "--num_epoch", "2",
                      "--freq_save", "1000"], base,
                     os.path.join(base, "gen_coarse.log"))
    phase("gen_data_train", json.dumps({
        **res, **card, "widths": "paper defaults, bf16", "tree": tree}))
    shutil.rmtree(gck, ignore_errors=True)

    # ---- [gen_data_eval]: [train]'s fine checkpoints on the new tree
    args = ["--stage", "eval", "--dataroot", tree, "--name", "smoke",
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
    if len(errs) != 1 or not np.isfinite(errs).all() or \
            n["fused_gather_mlp"] == 0:
        fail(f"[gen_data_eval] Err(occ:fine) {errs}, launches {n}")
    phase("gen_data_eval", json.dumps({
        **card, "checkpoint": "[train]'s smoke_train_epoch_0",
        "err_occ_fine": errs, "secs": round(secs, 2), "launches": n}))

    # ---- [debug_vis]
    ply = os.path.join(OUT_DIR, "debug_vis.ply")
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "rgbd_pifuhd_tpu_torch.cli.debug_vis",
         "--dataroot", tree, "--ply", ply, "--out",
         os.path.join(OUT_DIR, "debug_vis.png")],
        cwd=HERE, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": HERE})
    if r.returncode != 0:
        fail(f"[debug_vis] exit {r.returncode}: {r.stderr[-3000:]}")
    summary = r.stdout.splitlines()[0]
    with open(ply) as fh:
        body = fh.read().split("end_header\n")
    n_pts = len(body[1].splitlines())
    if not summary.startswith("subject=capsule samples=300 ") or \
            "element vertex 300\n" not in body[0] or n_pts != 300:
        fail(f"[debug_vis] {summary!r}, PLY {n_pts} points")
    phase("debug_vis", json.dumps({
        "summary": summary, "ply_points": n_pts,
        "plot": r.stdout.splitlines()[-1], "secs": round(time.time() - t0,
                                                         2)}))
    for path in (objs, tree, ply):
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)
    return n


def segment(dir_a: str) -> None:
    """``[segment]``: GrabCut on the served 1024^2 capsule (the rect its
    exact mask's box + 10 % a side), IoU against that mask >= 0.95; then
    ``crop_people`` on the same file."""
    import numpy as np

    from rgbd_pifuhd_tpu_torch.data.segmentation import (
        crop_people, segment_person_grabcut)
    from rgbd_pifuhd_tpu_torch.data.synthetic import (
        SUBJECT_CENTER, capsule_calib, make_capsule, normalize_mesh_height,
        rasterize_ortho)
    from rgbd_pifuhd_tpu_torch.utils import png

    path = os.path.join(dir_a, "capsule.png")
    img = png.read_rgb8(path)[:, :, ::-1]
    v, f = make_capsule(1.6, 0.55, 3)
    v = normalize_mesh_height(v, 180.0) + SUBJECT_CENTER
    gt = rasterize_ortho(v, f, 1024, capsule_calib(1024, 1024))["mask"]
    ys, xs = np.nonzero(gt)
    x0, x1, y0, y1 = int(xs.min()), int(xs.max()), int(ys.min()), int(
        ys.max())
    mx, my = int(0.1 * (x1 - x0)) + 1, int(0.1 * (y1 - y0)) + 1
    H, W = gt.shape
    rect = (max(x0 - mx, 0), max(y0 - my, 0),
            min(x1 + mx, W - 1) - max(x0 - mx, 0),
            min(y1 + my, H - 1) - max(y0 - my, 0))
    t0 = time.time()
    mask = segment_person_grabcut(img, rect)
    gc_s = time.time() - t0
    iou = float((mask & gt).sum() / max((mask | gt).sum(), 1))
    if iou < 0.95:
        fail(f"[segment] GrabCut IoU {iou} against the exact mask")
    t0 = time.time()
    crop = crop_people(path, rect)
    crop_s = time.time() - t0
    if crop.shape != img.shape or not (crop[~gt & ~mask] == 255).all():
        fail(f"[segment] crop_people gave {crop.shape}")
    phase("segment", json.dumps({
        "image": "served capsule, 1024^2 PNG", "rect": list(rect),
        "grabcut_s": round(gc_s, 3), "iou_vs_exact_mask": iou,
        "crop_people_s": round(crop_s, 3)}))


TURNTABLE_FRAMES = 6       # was 36: cut to make room for the recipes' phases


def turntable(smi_line) -> None:
    """``[turntable]``: ``generate_video_from_obj`` on ``[main]``'s OBJ,
    ``TURNTABLE_FRAMES`` frames at 512^2 into an ``.avi``, read back with
    ``utils/avi`` and every frame decoded; then the OBJ and the video are
    removed."""
    from rgbd_pifuhd_tpu_torch.recon.turntable import generate_video_from_obj
    from rgbd_pifuhd_tpu_torch.utils import avi, jpeg

    obj = os.path.join(OUT_DIR, "capsule_512.obj")
    video = os.path.join(OUT_DIR, "turntable.avi")
    t0 = time.time()
    generate_video_from_obj(obj, video, 512, TURNTABLE_FRAMES)
    secs = time.time() - t0
    info = avi.read_avi(video)
    t0 = time.time()
    shapes = {jpeg.decode(b).shape for b in info["frames"]}
    if len(info["frames"]) != TURNTABLE_FRAMES or \
            shapes != {(512, 512, 3)} or \
            info["fps"] != 12:
        fail(f"[turntable] {len(info['frames'])} frames, shapes {shapes}, "
             f"fps {info['fps']}")
    phase("turntable", json.dumps({
        "card": smi_line, "obj_bytes": os.path.getsize(obj),
        "video_s": round(secs, 2),
        "bytes": os.path.getsize(video), "frames": len(info["frames"]),
        "decode_s": round(time.time() - t0, 2)}))
    os.remove(video)
    os.remove(obj)


# ------------------------------------------------------ checkpoint recipes
# [flagship_train]'s step counts (normal nets each, coarse, fine): the JAX
# bench trained 200 / 800 / 800; fewer here, enough for a field that gives
# a surface in the subject's box ([flagship_mesh] checks it)
FLAGSHIP_STEPS = (40, 250, 400)
FLAGSHIP_PARAMS_M = 384.6
# [flagship_mesh]: the capsule's own surface is in the mesh: the median of
# its vertices' distances to the mesh (NDC) within 0.05 (13 voxels at
# 512^3, 14 % of its radius), the 95th percentile within 0.1 -- a check
# that the subject is there (a missing or misplaced one lies 0.1-0.5
# away), not of the short recipe's precision, which is printed beside
# flagship-lite's and moves from run to run (0.008-0.018 median)
SUBJECT_P50_MAX, SUBJECT_P95_MAX = 0.05, 0.1
TINY_IOU_MIN = 0.90       # [tiny_train]'s field against bench_tiny's


def _recipe_cmd(module: str, args: list) -> list:
    return [sys.executable, "-u", "-m",
            f"rgbd_pifuhd_tpu_torch.tools.{module}"] + args


def _run_until(cmd, log_path: str, stop: str | None, timeout: float):
    """Run ``cmd`` (its own process group) and collect its stdout lines;
    with ``stop``, SIGKILL the group as soon as a line starts with it.
    Returns ``(lines, exit code, seconds)``."""
    import signal

    t0 = time.time()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE,
                                stderr=log, text=True,
                                start_new_session=True,
                                env={**os.environ, "PYTHONPATH": HERE})
        timer = threading.Timer(timeout, lambda: os.killpg(
            proc.pid, signal.SIGKILL))
        timer.start()
        lines = []
        try:
            for line in proc.stdout:
                lines.append(line.rstrip("\n"))
                if stop is not None and line.startswith(stop):
                    os.killpg(proc.pid, signal.SIGKILL)
                    break
        finally:
            rc = proc.wait()
            timer.cancel()
    if time.time() - t0 >= timeout:
        fail(f"{cmd[4]} ran past {timeout} s: {open(log_path).read()[-2000:]}")
    return lines, rc, time.time() - t0


def flagship_train(smi_line):
    """``[flagship_train]``: ``tools/train_bench_flagship`` (the full
    flagship, bf16) on its own tree as a subprocess, SIGKILLed as soon as
    it says that ``stage2_coarse`` is saved, then run again: the second
    run must resume past stage 2 and write the checkpoint.  Returns the
    checkpoint's path and the trainer's launch counts (its ambiguity
    lattice, the one query of training that runs the kernel)."""
    base = os.path.join(OUT_DIR, "flagship")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    out = os.path.join(base, "out")
    nml, coarse, fine = FLAGSHIP_STEPS
    cmd = _recipe_cmd("train_bench_flagship", [
        "--steps-nml", str(nml), "--steps-coarse", str(coarse),
        "--steps-fine", str(fine), "--out", out, "--dataroot",
        os.path.join(base, "data"), "--log-every", "50"])
    l1, rc1, s1 = _run_until(cmd, os.path.join(base, "run1.log"),
                             "[stage] saved stage2_coarse", 600)
    if not l1 or not l1[-1].startswith("[stage] saved stage2_coarse"):
        fail(f"[flagship_train] run 1 ended (exit {rc1}) before stage 2 "
             f"was saved: {l1[-5:]}")
    if os.path.exists(os.path.join(out, "ckpt")):
        fail("[flagship_train] run 1 wrote a checkpoint before its kill")
    l2, rc2, s2 = _run_until(cmd, os.path.join(base, "run2.log"), None, 600)
    if rc2 != 0:
        fail(f"[flagship_train] run 2 exit {rc2}: "
             f"{open(os.path.join(base, 'run2.log')).read()[-3000:]}")
    if "[stage] resuming past stage 2 (coarse resume point found)" not in l2:
        fail(f"[flagship_train] run 2 did not resume past stage 2: {l2[:6]}")
    if any(ln.startswith(("[netF", "[netB", "[coarse")) for ln in l2):
        fail("[flagship_train] run 2 retrained a finished stage")
    stages, files = {}, {}
    amb = final = None
    for ln in l1 + l2:
        if ln.startswith("[stage_summary] "):
            d = json.loads(ln.split(" ", 1)[1])
            stages[d.pop("stage")] = d
        elif ln.startswith("[stage] saved "):
            name, rest = ln[len("[stage] saved "):].split(" ", 1)
            files[name] = json.loads(rest)
        elif ln.startswith("[sharpen] ambiguous cells"):
            amb = ln
        elif ln.startswith("saved ") and "/ckpt (" in ln:
            final = json.loads(ln[ln.index(") {") + 2:])
    if set(stages) != {"netF", "netB", "coarse", "fine"} or final is None \
            or amb is None or len(files) != 3:
        fail(f"[flagship_train] missing stage lines: {sorted(stages)}, "
             f"{sorted(files)}, final {final}, ambiguity {amb}")
    n_amb = int(amb.split("steps: ")[1].split()[0])
    amb_launches = int(amb.split("launches ")[1].rstrip(")"))
    if round(final["params"] / 1e6, 1) != FLAGSHIP_PARAMS_M:
        fail(f"[flagship_train] {final['params']} parameters, not "
             f"{FLAGSHIP_PARAMS_M} M")
    if amb_launches != 5:
        fail(f"[flagship_train] the ambiguity lattice launched "
             f"fused_gather_mlp {amb_launches} times (want 5: 65^3 points "
             "in chunks of 65,536, the last stack)")
    phase("flagship_train", json.dumps({
        "card": smi_line, "steps": {"netF": nml, "netB": nml,
                                    "coarse": coarse, "fine": fine},
        "params": final["params"], "stages": stages,
        "stage_files": files, "final_ckpt": final,
        "ambiguous_cells": n_amb, "ambiguity_fused_gather_mlp": amb_launches,
        "run1_s": round(s1, 2), "run2_s": round(s2, 2),
        "resumed_past_stage2": True}))
    return os.path.join(out, "ckpt"), {"fused_gather_mlp": amb_launches,
                                       "fused_point_mlp": 0}


def recipe_phases(torch, fq, fm, lite_model, smi_line) -> dict:
    """The checkpoint recipes on the card: ``[flagship_train]``,
    ``[flagship_mesh]``, ``[tiny_train]``; their launch counts by path."""
    torch.cuda.empty_cache()
    ckpt, train_counts = flagship_train(smi_line)
    paths = {"flagship_train": train_counts,
             "flagship_mesh": flagship_mesh(
                 torch, lite_model, ckpt,
                 os.path.join(OUT_DIR, "flagship", "data"), smi_line)}
    shutil.rmtree(os.path.join(OUT_DIR, "flagship"), ignore_errors=True)
    tiny = tiny_train(torch, fq, fm, smi_line)
    paths["tiny_train"] = tiny["run_recon"]
    paths["tiny_train_lattice"] = {
        k: tiny["trained"][k] + tiny["committed"][k]
        for k in ("fused_gather_mlp", "fused_point_mlp")}
    return paths


def _surface_fit(verts, subject, box, slack) -> dict:
    """How the mesh holds the subject: the distance from each vertex of
    the subject's own mesh to the nearest mesh vertex (median and 95th
    percentile, NDC), the share of mesh vertices inside the subject's box
    (``slack`` around it), and the mesh's bbox."""
    import numpy as np
    from scipy.spatial import cKDTree

    d, _ = cKDTree(verts).query(subject)
    inside = ((verts >= box["lo"] - slack)
              & (verts <= box["hi"] + slack)).all(1)
    return {"subject_p50": round(float(np.median(d)), 5),
            "subject_p95": round(float(np.percentile(d, 95)), 5),
            "verts_in_box_share": round(float(inside.mean()), 4),
            "verts_total": len(verts),
            "bbox": [verts.min(0).round(3).tolist(),
                     verts.max(0).round(3).tolist()]}


def _encode_s(torch, model, img, img_g, reps: int = 3) -> float:
    """Warm seconds of one encode (normal nets and both hourglasses), the
    median of ``reps``."""
    import numpy as np

    secs = []
    with torch.inference_mode():
        for i in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = model.filter_global(img_g, last_only=True)
            model.filter_local(img[None], g, last_only=True)
            torch.cuda.synchronize()
            if i:
                secs.append(time.perf_counter() - t0)
    return float(np.median(secs))


def _tree_subject(tree: str, name: str, root: str, stem: str) -> None:
    """The recipe tree's training image of ``name`` as a request subject:
    ``gen/<name>_<i>.png``, its front depth map, the whole frame as the
    rect (the reader's calib then maps the mesh to NDC, y up, as
    ``_write_subject``'s)."""
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    img = next(f for f in sorted(os.listdir(os.path.join(tree, "gen")))
               if f.rsplit("_", 1)[0] == name)
    shutil.copyfile(os.path.join(tree, "gen", img),
                    os.path.join(root, f"{stem}.png"))
    shutil.copyfile(os.path.join(tree, "DEPTH", name, "0_0_00.png"),
                    os.path.join(root, "depth", f"depth_{stem}.png"))
    with open(os.path.join(root, f"{stem}_rect.txt"), "w") as f:
        f.write("0 0 1024 1024\n")


def flagship_mesh(torch, lite_model, ckpt, tree, smi_line) -> dict:
    """``[flagship_mesh]``: ``cli/run_recon`` on the port-trained flagship
    at 512^3 (marching cubes, fd colours, OBJ) on the recipe's capsule
    (its 1024^2 training image), given twice: both meshes non-empty,
    finite and equal as sorted vertex sets, the capsule's own surface in
    the mesh (``_surface_fit``: median and 95th percentile at most
    ``SUBJECT_P50_MAX`` / ``SUBJECT_P95_MAX``); ``fused_gather_mlp``
    twice a field query.  The
    recipe's field also has surfaces outside the subject (its fine stage
    never sees the image columns outside the 512^2 crop window): their
    share is printed beside flagship-lite's on the same image.  In this
    process: the checkpoint's load (``ready_s``), the encode's warm
    seconds beside flagship-lite's, and its FLOPs (``FlopCounterMode``)
    against the card's peak.  Returns run_recon's launch counts."""
    import numpy as np
    from torch.utils.flop_counter import FlopCounterMode

    from rgbd_pifuhd_tpu_torch.cli.common import load_item, load_reconstructor
    from rgbd_pifuhd_tpu_torch.data.readdata import InferenceDataset
    from rgbd_pifuhd_tpu_torch.utils.flops import device_peak_flops
    from rgbd_pifuhd_tpu_torch.utils.options import Options

    req = os.path.join(OUT_DIR, "req_full")
    for stem in ("capsule", "capsule_b"):
        _tree_subject(tree, "capsule", req, stem)
    box = _subject_box(1024)        # the same capsule, mesh and calib
    results = os.path.join(OUT_DIR, "full_recon")
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "rgbd_pifuhd_tpu_torch.cli.run_recon",
         "--dataroot", req, "--load_netMR_checkpoint_path", ckpt,
         "--results_path", results, "--name", "full", "--resolution",
         "512", "--loadSize", "1024", "--use_color", "0"],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    process_s = time.time() - t0
    if r.returncode != 0:
        fail(f"[flagship_mesh] run_recon exit {r.returncode}: "
             f"{r.stderr[-2000:]}")
    lines = r.stdout.strip().splitlines()
    n = json.loads(lines[-1].split(" ", 1)[1])
    if not (n["query_calls"] > 0 and n["fused_point_mlp"] == 0
            and n["fused_gather_mlp"] == 2 * n["query_calls"]):
        fail(f"[flagship_mesh] launch counts {n}")
    subject = _subject_ndc(1024)
    slack = 0.1 * float(box["hi"][1] - box["lo"][1])
    meshes, secs = [], []
    for stem in ("capsule", "capsule_b"):
        ln = next(x for x in lines if f"result_{stem}_512.obj:" in x)
        path = ln.split(":")[0]
        pos, n_f = _obj_positions(path, int(ln.split("verts=")[1].split()[0]))
        secs.append(float(ln.split("secs=")[1]))
        if not (len(pos) and n_f and np.isfinite(pos).all()):
            fail(f"[flagship_mesh] {stem}: {len(pos)} verts, {n_f} faces")
        meshes.append((pos[np.lexsort(pos.T)], n_f))
    (a, fa), (b, fb) = meshes
    if a.shape != b.shape or fa != fb or not (a == b).all():
        fail(f"[flagship_mesh] the two runs differ: {len(a)} / {len(b)} "
             f"verts, {fa} / {fb} faces")
    fit = _surface_fit(a, subject, box, slack)
    if fit["subject_p50"] > SUBJECT_P50_MAX or \
            fit["subject_p95"] > SUBJECT_P95_MAX:
        fail(f"[flagship_mesh] the capsule's surface is not in the mesh: "
             f"{fit}")
    # in this process: load, encode seconds (and flagship-lite's), FLOPs
    torch.cuda.synchronize()
    t0 = time.time()
    recon, opt_model, _ = load_reconstructor(
        Options(load_netMR_checkpoint_path=ckpt, load_size=1024), "cuda")
    torch.cuda.synchronize()
    ready_s = time.time() - t0
    item = load_item(InferenceDataset(req, 1024), 0)
    img = torch.from_numpy(np.asarray(item["img"], np.float32)).cuda()
    img_g = torch.from_numpy(np.asarray(item["img_512"], np.float32)).cuda()
    enc_full = _encode_s(torch, recon.model, img, img_g)
    enc_lite = _encode_s(torch, lite_model, img, img_g)
    lite, _, _ = load_reconstructor(
        Options(load_netMR_checkpoint_path=CKPT, load_size=1024), "cuda")
    out = lite.gen_mesh(item, os.path.join(results, "lite.obj"), 512)
    fit_lite = _surface_fit(out["verts"], subject, box, slack)
    del lite, out
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        g = recon.model.filter_global(img_g, last_only=True)
        recon.model.filter_local(img[None], g, last_only=True)
    flops = fc.get_total_flops()
    peak = device_peak_flops(torch.device("cuda"))
    n_params = sum(p.numel() for p in recon.model.parameters())
    del recon
    torch.cuda.empty_cache()
    phase("flagship_mesh", json.dumps({
        "card": smi_line, "model": f"port-trained flagship ({n_params} "
        "params), bf16, 512^3, mc, fd colours, OBJ",
        "launches": n, "secs_per_mesh": secs, "warm_secs": secs[1],
        "process_s": round(process_s, 2), "verts": len(a), "faces": fa,
        **fit, "subject": [box["lo"].round(3).tolist(),
                           box["hi"].round(3).tolist()],
        "subject_bounds": [SUBJECT_P50_MAX, SUBJECT_P95_MAX],
        "flagship_lite_same_image": fit_lite,
        "same_on_two_runs": True, "ready_s": round(ready_s, 3),
        "ckpt_mb": round(os.path.getsize(ckpt) / 1e6, 1),
        "encode_s": round(enc_full, 5), "encode_s_flagship_lite":
        round(enc_lite, 5), "encode_flop": flops,
        "encode_tflops": round(flops / enc_full / 1e12, 2),
        "encode_peak_share": round(flops / enc_full / peak, 4)
        if peak else None}))
    shutil.rmtree(req)
    shutil.rmtree(results)
    return n


def tiny_train(torch, fq, fm, smi_line) -> dict:
    """``[tiny_train]``: ``tools/train_bench_tiny`` at its default 400
    steps a stage on the card, then ``cli/run_recon`` on the result (the
    coarse level through ``fused_gather_mlp``, the norm-free fine level
    through ``gather_concat`` + ``fused_point_mlp``; the capsule in the
    mesh, ``_surface_fit``, as in ``[flagship_mesh]``), and its field
    beside the committed ``bench_tiny``'s on the capsule's dense 128^3
    lattice: the IoU of the two occupied sets at 0.5 at least
    ``TINY_IOU_MIN``.
    Returns the launch counts of run_recon and of the lattices."""
    import numpy as np

    from rgbd_pifuhd_tpu_torch.cli.common import load_reconstructor
    from rgbd_pifuhd_tpu_torch.data.synthetic import capsule_subject
    from rgbd_pifuhd_tpu_torch.utils.options import Options

    base = os.path.join(OUT_DIR, "tiny")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    lines, rc, train_s = _run_until(_recipe_cmd("train_bench_tiny", [
        "--out", os.path.join(base, "out"), "--dataroot",
        os.path.join(base, "data")]), os.path.join(base, "train.log"),
        None, 600)
    ckpt = os.path.join(base, "out", "ckpt")
    if rc != 0 or not os.path.exists(ckpt):
        fail(f"[tiny_train] exit {rc}: "
             f"{open(os.path.join(base, 'train.log')).read()[-2000:]}")
    losses = {ln.split("]")[0][1:]: float(ln.split("loss=")[1])
              for ln in lines if "] loss=" in ln}
    req = os.path.join(base, "req")
    box = _write_subject(req, "capsule", 128)
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "rgbd_pifuhd_tpu_torch.cli.run_recon",
         "--dataroot", req, "--load_netMR_checkpoint_path", ckpt,
         "--results_path", base, "--name", "tiny", "--resolution", "512",
         "--loadSize", "128", "--use_color", "0"],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        fail(f"[tiny_train] run_recon exit {r.returncode}: "
             f"{r.stderr[-2000:]}")
    recon_s = time.time() - t0
    n = json.loads(r.stdout.strip().splitlines()[-1].split(" ", 1)[1])
    if not (n["fused_point_mlp"] == n["gather_concat"]
            == n["fused_gather_mlp"] == n["query_calls"] > 0):
        fail(f"[tiny_train] run_recon launch counts {n}: want one of each "
             "kernel per field query")
    obj = os.path.join(base, "tiny", "recon", "result_capsule_512.obj")
    pos, n_f = _obj_positions(obj, int(r.stdout.split("verts=")[1].split()[0]))
    fit = _surface_fit(pos, _subject_ndc(128), box,
                       0.1 * float(box["hi"][1] - box["lo"][1]))
    if not (len(pos) and n_f and np.isfinite(pos).all()
            and fit["subject_p50"] <= SUBJECT_P50_MAX
            and fit["subject_p95"] <= SUBJECT_P95_MAX):
        fail(f"[tiny_train] the capsule is not in the mesh: {fit}")
    # the field on the capsule's dense lattice, both checkpoints
    rgbd, calib, _, _ = capsule_subject(128)
    img = torch.from_numpy(rgbd).cuda()[None]
    cal = torch.from_numpy(calib).cuda()
    vols, counts = [], {}
    for name, path in (("trained", ckpt), ("committed", CKPT_TINY)):
        recon, _, _ = load_reconstructor(
            Options(load_netMR_checkpoint_path=path, load_size=128), "cuda")
        for k in (fq.fused_gather_mlp, fq.gather_concat, fm.fused_point_mlp):
            k.launches = 0
        with torch.inference_mode():
            l_f, g_f = recon.encode(img, img)
            vol, _ = recon.occupancy_volume(l_f, g_f, cal, 128,
                                            use_octree=False)
        counts[name] = {"fused_gather_mlp": fq.fused_gather_mlp.launches,
                        "gather_concat": fq.gather_concat.launches,
                        "fused_point_mlp": fm.fused_point_mlp.launches}
        vols.append(np.array(vol) > 0.5)
        del recon
    inter = int((vols[0] & vols[1]).sum())
    union = int((vols[0] | vols[1]).sum())
    iou = inter / max(union, 1)
    disagree = float((vols[0] != vols[1]).mean())
    if not (union and iou >= TINY_IOU_MIN):
        fail(f"[tiny_train] field IoU {iou:.4f} against bench_tiny's "
             f"(bound {TINY_IOU_MIN})")
    if any(c["fused_point_mlp"] == 0 or c["fused_gather_mlp"] == 0
           for c in counts.values()):
        fail(f"[tiny_train] lattice launches {counts}")
    phase("tiny_train", json.dumps({
        "card": smi_line, "steps": 400, "train_s": round(train_s, 2),
        "losses": losses, "recon_process_s": round(recon_s, 2),
        "launches": n, "verts": len(pos), "faces": n_f, **fit,
        "lattice": "capsule 128^2, dense 128^3", "iou": round(iou, 5),
        "iou_bound": TINY_IOU_MIN, "disagree_share": round(disagree, 6),
        "occupied": [int(v.sum()) for v in vols],
        "lattice_launches": counts}))
    shutil.rmtree(base)
    return {"run_recon": n, **counts}


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
    # the texture field's colour chain at the published widths: a 512-
    # channel gather, the 513-wide residual input, norm-free layers and the
    # three-column tanh head (bf16: the per-row head kernel), N ragged
    dims, res_layers = (513, 1024, 512, 256, 128, 3), (1, 2, 3, 4)
    N = 65536 + 77
    feat = torch.randn((128, 128, 512), generator=gen, device=dev)
    uv = torch.rand((N, 2), generator=gen, device=dev) * 2.2 - 1.1
    z = torch.randn((N, 1), generator=gen, device=dev)
    for cd in (torch.float32, torch.bfloat16):
        colour = PointMLP(dims, -1, res_layers, "none", "tanh",
                          dtype=None if cd == torch.float32 else cd,
                          device=dev)
        _draw_colour(torch, colour, 2)
        packed = colour.packed()
        kw = dict(res_layers=res_layers, merge_layer=-1, last_op="tanh")
        f = feat.to(cd).contiguous()
        ref = fq.fused_gather_mlp_ref(f, uv, z, packed, **kw)
        label = f"colour 513-1024-512-256-128-3 tanh N={N} {cd}"
        _compare(torch, fq.fused_gather_mlp(f, uv, z, packed, **kw), ref,
                 cd, label)
        head = fq.plan_chain(packed, N, 512, 1, -1, 32, "tanh",
                             None).layers[-1].ints
        want = fq.KIND_HEAD if cd == torch.bfloat16 else fq.KIND_F32
        spread = float(ref[0].std())
        phase("check", f"{label}: last layer kind {head['kind']} (want "
              f"{want}), tanh {head['tanh']}, colour spread {spread:.3f}")
        if head["kind"] != want or head["tanh"] != 1 or spread < 0.1:
            _BAD.append(f"{label}: plan or spread")
    if _BAD:
        fail(f"kernel disagrees with its plain version: {_BAD}")
    tol = TOL_BF16_PRED
    phase("kernels", json.dumps({
        "kernel": "fused_gather_mlp",
        "replaces": "rgbd_pifuhd_tpu/ops/pallas_query.py:286",
        "max_abs_err_pred_bf16_main": main_err, "tolerance": tol,
        "launches_in_checks": fq.fused_gather_mlp.launches}))
    return {"main_err": main_err, "main_tol": tol}


def _draw_colour(torch, net, seed: int) -> None:
    """Weights that colour (the rule of ``tests/test_torch_texpifu.draw``):
    matrices and kernels N(0, 1 / fan_in), the last Dense N(0, 1 / (4
    fan_in)), biases N(0, 0.05^2), norms' scales 1 and biases 0."""
    g = torch.Generator().manual_seed(seed)
    last = [n for n, p in net.named_parameters() if p.dim() == 2][-1]
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.dim() > 1:
                var = (0.25 if name == last else 1.0) / p[0].numel()
                w = torch.randn(p.shape, generator=g) * var ** 0.5
            elif "norm" in name:
                w = torch.full(p.shape, 1.0 if name.endswith("weight")
                               else 0.0)
            else:
                w = torch.randn(p.shape, generator=g) * 0.05
            p.copy_(w.to(p.device))


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
          f" s; OBJ {path} ({os.path.getsize(path)} bytes, kept for "
          "[turntable])")
    return launches, recon._esc_budgets


def texture_path(torch, fq, model, opt, dev) -> int:
    """Two ``--use_color 3`` meshes of the capsule at 512^3 through
    ``Reconstructor.gen_mesh``, coloured by a seeded netC at the published
    widths (bf16): the colour chain's launches (``color_query``) must be
    the mesh's ``color_calls``, one a 65,536-vertex chunk, and the OBJ's
    colours must spread.  Returns the second mesh's colour launches."""
    from rgbd_pifuhd_tpu_torch.data.synthetic import capsule_subject
    from rgbd_pifuhd_tpu_torch.models.texture import TexPIFu, color_query
    from rgbd_pifuhd_tpu_torch.recon.pipeline import Reconstructor
    from rgbd_pifuhd_tpu_torch.utils.options import ColorConfig

    netC = TexPIFu(ColorConfig(compute_dtype="bfloat16"), opt.netG,
                   device=dev)
    _draw_colour(torch, netC, 3)
    rgbd, calib, _, _ = capsule_subject(512)
    data = {"img": rgbd[None], "img_512": rgbd[None], "calib": calib}
    recon = Reconstructor(model, opt, device=dev, netC=netC)
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "capsule_512_tex.obj")
    for run in range(2):
        color_query.launches = fq.fused_gather_mlp.launches = 0
        torch.cuda.synchronize()
        out = recon.gen_mesh(data, path, resolution=512, use_color=3)
        torch.cuda.synchronize()
        n_col, n_all = color_query.launches, fq.fused_gather_mlp.launches
        V = len(out["verts"])
        if not (n_col == out["color_calls"] >= -(-V // 65536)
                and out["color_points"] == V
                and n_all == 2 * out["query_calls"] + n_col):
            fail(f"texture run {run}: {n_col} colour launches, "
                 f"{out['color_calls']} colour calls, {V} verts, "
                 f"{out['color_points']} coloured, {n_all} query kernel "
                 f"launches for {out['query_calls']} field queries")
        cols = []
        with open(path, "rb") as fh:
            for line in fh:
                if line.startswith(b"v "):
                    cols.append(line)
        if len(cols) != V:
            fail(f"texture run {run}: OBJ holds {len(cols)} v lines, mesh "
                 f"{V}")
        rgb = [[float(x) for x in ln.split()[4:7]] for ln in cols[::97]]
        lo = min(min(c) for c in rgb)
        hi = max(max(c) for c in rgb)
        spread = float(statistics.pstdev(x for c in rgb for x in c))
        if not (0.0 <= lo and hi <= 1.0 and spread > 0.05):
            fail(f"texture run {run}: colours {lo}..{hi}, spread {spread}")
        phase("texture", json.dumps({
            "run": run, "secs": round(out["secs"], 4), "verts": V,
            "color_points": out["color_points"],
            "color_calls": out["color_calls"],
            "color_query_launches": n_col,
            "fused_gather_mlp_launches": n_all,
            "query_calls": out["query_calls"],
            "colour_spread": round(spread, 4),
            "host_secs": out["host_secs"]}))
    return n_col


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


# ------------------------------------------------------ multi-device paths
def shard_paths(torch, fq, fm, model, opt, dev, esc) -> dict:
    """``[shard_query]`` and ``[shard_mesh]``: a two-shard mesh with the
    card listed twice.  Returns each path's launch counts."""
    import copy

    from rgbd_pifuhd_tpu_torch.data.synthetic import capsule_subject
    from rgbd_pifuhd_tpu_torch.models import MultiResPIFu
    from rgbd_pifuhd_tpu_torch.parallel import make_device_mesh
    from rgbd_pifuhd_tpu_torch.recon import Reconstructor
    from rgbd_pifuhd_tpu_torch.utils.checkpoint import (
        load_checkpoint, load_params, restore_options)
    from rgbd_pifuhd_tpu_torch.utils.options import Options

    mesh = make_device_mesh(devices=[dev, dev])
    if mesh.size != 2 or len(set(mesh.local_devices)) != 1:
        fail(f"[shard_query] mesh {mesh}")
    counts = {}
    N = 262144
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)

    def query_pair(m, o, size):
        """(sharded, cat of the two halves' plain calls, counts of the
        sharded call) of one field query at N points inside the capsule's
        box."""
        rgbd, calib, cv, _ = capsule_subject(size)
        one = Reconstructor(m, o, device=dev)
        two = Reconstructor(m, o, device=dev, mesh=mesh)
        lo = torch.tensor(cv.min(0), dtype=torch.float32, device=dev)
        hi = torch.tensor(cv.max(0), dtype=torch.float32, device=dev)
        pts = lo + (hi - lo) * torch.rand(N, 3, device=dev, generator=gen)
        with torch.inference_mode():
            l_f, g_f = one.encode(one._tensor(rgbd[None]),
                                  one._tensor(rgbd[None]))
            cal = one._tensor(calib)
            got, n = _counts(torch, fq, fm,
                             lambda: two._query(pts, l_f, g_f, cal))
            halves = torch.cat([one._query(p, l_f, g_f, cal)
                                for p in pts.split(N // 2)])
            whole = one._query(pts, l_f, g_f, cal)
        if two.query_calls != 2:
            fail(f"[shard_query] {two.query_calls} query calls for 2 shards")
        return got, halves, whole, n

    # flagship-lite (bf16, GroupNorm): each shard its own statistics
    got, halves, whole, n = query_pair(model, opt, 512)
    if not torch.equal(got, halves) or n["fused_gather_mlp"] != 4:
        fail(f"[shard_query] flagship-lite: sharded vs the halves' calls "
             f"max |diff| {float((got - halves).abs().max())}, launches {n}")
    lite = {"bit_equal_to_halves": True, "launches": n,
            "max_abs_diff_to_unsharded": float((got - whole).abs().max())}
    # bench_tiny (f32, norm-free): the sharded query is the unsharded one
    ck = load_checkpoint(CKPT_TINY, device=dev)
    opt_t, _ = restore_options(Options(), ck)
    tiny = MultiResPIFu(opt_t.netMR, opt_t.netG, device=dev)
    load_params(tiny, ck["params"])
    got, halves, whole, n = query_pair(tiny.eval(), opt_t, 128)
    diff = float((got - whole).abs().max())
    if diff > TOL_F32 or n["fused_point_mlp"] != 2 or \
            n["fused_gather_mlp"] != 2:
        fail(f"[shard_query] bench_tiny: sharded vs unsharded max |diff| "
             f"{diff}, launches {n}")
    phase("shard_query", json.dumps({
        "mesh": repr(mesh), "points": N, "flagship_lite_bf16": lite,
        "bench_tiny_f32": {"bit_equal_to_unsharded": bool(torch.equal(
            got, whole)), "max_abs_diff_to_unsharded": diff,
            "bit_equal_to_halves": bool(torch.equal(got, halves)),
            "launches": n}}))
    counts["shard_query"] = {k: lite["launches"][k] + n[k] for k in n}
    del tiny, ck

    # ---- [shard_mesh]: flagship-lite gen_mesh at 512^3 on the mesh
    rgbd, calib, cv, _ = capsule_subject(512)
    data = {"img": rgbd[None], "img_512": rgbd[None], "calib": calib}
    path = os.path.join(OUT_DIR, "shard.obj")
    runs = {}
    for label, m in (("one", None), ("two", mesh)):
        r = Reconstructor(model, opt, device=dev, mesh=m)
        r._esc_budgets = copy.deepcopy(esc)
        for k in range(1 if m is None else 2):
            out, n = _counts(torch, fq, fm, lambda: r.gen_mesh(
                data, path, resolution=512))
            _check_mesh(f"[shard_mesh] {label} run {k}", out, cv)
            if n["fused_gather_mlp"] != 2 * out["query_calls"]:
                fail(f"[shard_mesh] {label}: launches {n} for "
                     f"{out['query_calls']} query calls (want 2 each)")
            runs.setdefault(label, []).append((out, n))
    one, (two, n) = runs["one"][0][0], runs["two"][-1]
    a1, a2 = one["grid_diag"]["n_active"], two["grid_diag"]["n_active"]
    # flagship-lite's surface reaches past the capsule (the main path's
    # bbox): the sharded mesh is held to the unsharded mesh's box, plus 1 %
    # of its extent (per-shard statistics move a few cells)
    lo, hi = two["verts"].min(0), two["verts"].max(0)
    lo1, hi1 = one["verts"].min(0), one["verts"].max(0)
    pad = 0.01 * (hi1 - lo1)
    if abs(a2 - a1) > 0.01 * a1 or (lo < lo1 - pad).any() or \
            (hi > hi1 + pad).any():
        fail(f"[shard_mesh] active cells {a2} vs {a1} unsharded; bbox "
             f"{lo}..{hi} vs the unsharded {lo1}..{hi1}")
    phase("shard_mesh", json.dumps({
        "secs_runs": [round(o["secs"], 4) for o, _ in runs["two"]],
        "unsharded_secs": round(one["secs"], 4),
        "active_cells": {"sharded": a2, "unsharded": a1},
        "verts": {"sharded": len(two["verts"]),
                  "unsharded": len(one["verts"])},
        "bbox": {"sharded": [lo.round(3).tolist(), hi.round(3).tolist()],
                 "unsharded": [lo1.round(3).tolist(), hi1.round(3).tolist()],
                 "subject": [cv.min(0).round(3).tolist(),
                             cv.max(0).round(3).tolist()]},
        "query_calls": two["query_calls"], "launches": n,
        "points_queried": two["points_queried"],
        "host_secs": two["host_secs"]}))
    counts["shard_mesh"] = n
    os.remove(path)
    os.remove(path[:-4] + ".png")
    return counts


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _dist_child(kind: str, rank: int, world: int, port: int, out_path: str,
                args: dict) -> None:
    """One rank of ``[dist_nccl]`` / ``[dist_train]`` / ``[dist_eval]``, a
    process of its own (spawned): it joins the group, runs its part
    through the port's API, writes its result as JSON and leaves the
    group."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist

    from rgbd_pifuhd_tpu_torch.ops import fused_query as fq
    from rgbd_pifuhd_tpu_torch.parallel import (
        initialize_distributed, make_device_mesh, process_device)
    from rgbd_pifuhd_tpu_torch.train import loop
    from rgbd_pifuhd_tpu_torch.utils.options import parse_options

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    if kind == "nccl":      # one rank: world size 1 over NCCL
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=1, rank=0)
    elif not initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                    backend="gloo", device="cuda"):
        raise RuntimeError("no process group")
    try:
        dev = process_device("cuda")
        mesh = make_device_mesh(devices=[dev])
        if kind == "nccl":
            res = _nccl_step_check(torch, dev, mesh, args)
        elif kind == "train":
            os.chdir(args["cwd"][rank])
            opt = parse_options(args["argv"] + ["--checkpoints_path",
                                                args["ck"][rank]])
            loop.train_fine(opt, max_steps=3, device=dev, mesh=mesh)
            res = {}
        else:
            fq.fused_gather_mlp.launches = 0
            err = loop.evaluate_checkpoints(parse_options(args["argv"]),
                                            device=dev, mesh=mesh)
            res = {"err": err, "launches": fq.fused_gather_mlp.launches}
        res["backend"] = dist.get_backend()
        res["world"] = dist.get_world_size()
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as fh:
        json.dump(res, fh)


def _nccl_step_check(torch, dev, mesh, args) -> dict:
    """A paper-width fine step (f32, TF32 off, deterministic algorithms)
    unwrapped, through ``shard_train_step`` on the one-rank NCCL mesh, and
    unwrapped again, from the same parameters and batch: the loss and
    every parameter after the step, bit for bit."""
    from rgbd_pifuhd_tpu_torch.data.datasets import TrainDataset
    from rgbd_pifuhd_tpu_torch.train import loop
    from rgbd_pifuhd_tpu_torch.train.trainers import (
        make_fine_train_step, make_optimizer, shard_train_step)
    from rgbd_pifuhd_tpu_torch.utils.options import parse_options

    torch.use_deterministic_algorithms(True, warn_only=True)
    opt = parse_options(args["argv"])
    batch = loop._to_device(loop.collate_fine(
        [TrainDataset(opt, seed=opt.seed)[0]]), dev)
    model = loop.build_multires(opt, dev)
    loop.init_multires_params(opt, model)
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    runs = []
    for wrapped in (False, True, False):
        model.load_state_dict(state0)
        step = make_fine_train_step(model, make_optimizer(
            opt.optimizer, opt.learning_rate, model.parameters()))
        if wrapped:
            step = shard_train_step(step, mesh)
        t0 = time.time()
        loss = float(step(batch)["loss"])     # waits for the step
        runs.append((loss, torch.cat([p.detach().reshape(-1)
                                      for p in model.parameters()]),
                     time.time() - t0))

    def same(a, b):
        return a[0] == b[0] and bool(torch.equal(a[1], b[1]))

    a, b, c = runs
    return {"loss": a[0], "bit_equal": same(a, b),
            "deterministic": same(a, c),
            "max_abs_param_diff": float((a[1] - b[1]).abs().max()),
            "params": int(a[1].numel()),
            "step_s": [round(r[2], 4) for r in runs]}


def _run_ranks(kind: str, world: int, args: dict, timeout: float = 300):
    """``world`` spawned ranks of ``_dist_child``; their JSON results.
    Every rank is stopped before this returns; any failure fails."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    d = os.path.join(OUT_DIR, "dist")
    os.makedirs(d, exist_ok=True)
    outs = [os.path.join(d, f"{kind}_{r}.json") for r in range(world)]
    for o in outs:
        if os.path.exists(o):
            os.remove(o)
    procs = [ctx.Process(target=_dist_child,
                         args=(kind, r, world, port, outs[r], args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout
    for p in procs:
        p.join(max(deadline - time.time(), 1))
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(30)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        fail(f"[dist_{kind}] rank exit codes {codes}")
    res = []
    for o in outs:
        with open(o) as fh:
            res.append(json.load(fh))
    return res


def dist_phases(torch, fq, fm, dev, smi_line, root, ck) -> dict:
    """``[dist_nccl]``, ``[dist_train]`` and ``[dist_eval]`` on ``[train]``'s
    tree and checkpoints.  Returns the evaluation's launches per rank."""
    import numpy as np

    from rgbd_pifuhd_tpu_torch.parallel import make_device_mesh
    from rgbd_pifuhd_tpu_torch.train import loop
    from rgbd_pifuhd_tpu_torch.utils.logging import load_error_history
    from rgbd_pifuhd_tpu_torch.utils.options import parse_options

    torch.cuda.empty_cache()
    base = os.path.join(OUT_DIR, "dist")
    shutil.rmtree(base, ignore_errors=True)
    card = {"card": smi_line}
    fine = ["--dataroot", root, "--num_sample_inout", "4096", "--sigma", "8",
            "--freq_save", "1000"]
    # the step's paper widths; the normal nets (frozen inputs of the fine
    # stage, 360 M parameters to draw, broadcast and write) stay off
    no_nml = ["--no_front_normal", "--no_back_normal"]

    # ---- [dist_nccl]: shard_train_step on one NCCL rank, bit for bit
    t0 = time.time()
    (r,) = _run_ranks("nccl", 1, {"argv": fine + no_nml + ["--name",
                                                            "nccl"]})
    if not (r["bit_equal"] and r["deterministic"]) or r["backend"] != "nccl":
        fail(f"[dist_nccl] {r}")
    phase("dist_nccl", json.dumps({**card, **r,
                                   "widths": "paper, f32, no normal nets",
                                   "secs": round(time.time() - t0, 2)}))

    # ---- [dist_train]: two gloo ranks on the card against one process
    argv = fine + no_nml + ["--name", "dist", "--batch_size", "2",
                            "--num_epoch", "3"]
    cwd = [os.path.join(base, f"rank{k}") for k in range(2)]
    cks = [os.path.join(base, f"ck{k}") for k in range(2)]
    for c in cwd + cks:
        os.makedirs(c)
    t0 = time.time()
    _run_ranks("train", 2, {"argv": argv, "cwd": cwd, "ck": cks})
    two_s = time.time() - t0
    ref = os.path.join(base, "one")
    os.makedirs(ref)
    here = os.getcwd()
    os.chdir(ref)
    t0 = time.time()
    try:
        loop.train_fine(parse_options(argv + ["--checkpoints_path", ref]),
                        max_steps=3, device=dev,
                        mesh=make_device_mesh(devices=[dev]))
    finally:
        os.chdir(here)
    one_s = time.time() - t0
    torch.cuda.empty_cache()
    two = np.asarray(load_error_history(os.path.join(
        cwd[0], "train_result"), "dist_netMR")[-1], np.float64)
    one = np.asarray(load_error_history(os.path.join(
        ref, "train_result"), "dist_netMR")[-1], np.float64)
    rank1 = [os.path.join(p, f) for top in (cwd[1], cks[1])
             for p, _, fs in os.walk(top) for f in fs]
    written = sorted(os.listdir(cks[0]))
    if len(two) != 3 or len(one) != 3 or not np.allclose(
            two, one, rtol=1e-4, atol=0) or rank1 or not written:
        fail(f"[dist_train] losses {list(two)} vs one process {list(one)}; "
             f"rank 1 wrote {rank1}; rank 0 wrote {written}")
    phase("dist_train", json.dumps({
        **card, "ranks": 2, "backend": "gloo", "device": "cuda:0 (both)",
        "widths": "paper, f32, no normal nets", "global_batch": 2,
        "losses": two.tolist(), "one_process_losses": one.tolist(),
        "max_rel_diff": float(np.max(np.abs(two - one) / np.abs(one))),
        "rank0_wrote": written, "rank1_wrote": rank1,
        "two_rank_s": round(two_s, 2), "one_process_s": round(one_s, 2)}))
    shutil.rmtree(base, ignore_errors=True)

    # ---- [dist_eval]: evaluate_checkpoints over two gloo ranks
    argv = fine + ["--name", "smoke", "--checkpoints_path", ck,
                   "--compute_dtype", "bfloat16"]
    t0 = time.time()
    ranks = _run_ranks("eval", 2, {"argv": argv})
    two_s = time.time() - t0
    t0 = time.time()
    one, n1 = _counts(torch, fq, fm, lambda: loop.evaluate_checkpoints(
        parse_options(argv), device=dev, mesh=make_device_mesh(
            devices=[dev])))
    one_s = time.time() - t0
    errs = [float(r["err"]["0"]) for r in ranks]
    if abs(errs[0] - one[0]) > 1e-5 or errs[0] != errs[1] or \
            min(r["launches"] for r in ranks) == 0:
        fail(f"[dist_eval] Err(occ:fine) {errs} vs one process {one[0]}, "
             f"launches {[r['launches'] for r in ranks]}")
    phase("dist_eval", json.dumps({
        **card, "ranks": 2, "backend": "gloo", "err_occ_fine": errs[0],
        "one_process_err": one[0], "abs_diff": abs(errs[0] - one[0]),
        "launches_per_rank": [r["launches"] for r in ranks],
        "one_process_launches": n1["fused_gather_mlp"],
        "two_rank_s": round(two_s, 2), "one_process_s": round(one_s, 2)}))
    return {f"dist_eval_rank{k}": {"fused_gather_mlp": r["launches"],
                                   "fused_point_mlp": 0, "gather_concat": 0}
            for k, r in enumerate(ranks)}


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
    # ---- [segment]: GrabCut on the 1024^2 served capsule
    segment(dir_a)
    for d in (dir_a, dir_b, results):
        shutil.rmtree(d)
    return counts


def _subject_ndc(size: int):
    """The capsule subject's mesh vertices in the server's coordinates
    (NDC, y up)."""
    import numpy as np

    from rgbd_pifuhd_tpu_torch.data.synthetic import capsule_subject

    _, calib, cv, _ = capsule_subject(size)
    ndc = cv @ calib[:3, :3].T.astype(np.float64) + calib[:3, 3]
    ndc[:, 1] *= -1.0
    return ndc


def _subject_box(size: int) -> dict:
    """The capsule subject's bbox in the server's coordinates (NDC, y
    up), as ``_write_subject`` returns it."""
    ndc = _subject_ndc(size)
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
    from rgbd_pifuhd_tpu_torch.utils.flops import (
        device_peak_flops, two_level_query_flops_per_point)

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
    # the query's work as utils/flops counts it (the MLPs' products), and
    # its share of the card's published dense bf16 peak
    q_flop = two_level_query_flops_per_point(model.cfg, model.netG.cfg) * N
    q_rate = q_flop / (min(ms, ms2) * 1e-3)
    peak = device_peak_flops(dev)
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
        "utils_flops": q_flop, "achieved_flop_per_s": q_rate,
        "peak_flop_per_s": peak,
        "share_of_peak": None if peak is None else round(q_rate / peak, 4),
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
