"""Train the flagship model on the card (port of
``scripts/train_bench_flagship.py``): the full 384.6 M-parameter
configuration (4-stack 256-channel coarse encoder, the full-resolution fine
encoder, both pix2pixHD normal nets at ngf 64), or with ``--lite`` the
42.6 M-parameter flagship-lite (normal nets at ngf 16, everything else
equal), on the port's own synthetic tree, with the three-stage recipe:

1. netF, then netB, on the ground-truth normal maps (L1 alone, Adam 2e-4);
2. the coarse level with the trained normal nets frozen;
3. the fine level on 512^2 crops of the 1024^2 renders, the coarse level
   frozen (its parameters get no optimiser state).

    python3 -m rgbd_pifuhd_tpu_torch.tools.train_bench_flagship \\
        [--steps-nml 300] [--steps-coarse 1200] [--steps-fine 1200] \\
        [--lite] [--out DIR] [--dataroot DIR] [--supervised] \\
        [--device cuda|cpu]

The checkpoint (f16; ~770 MB for the flagship, ~85 MB for flagship-lite)
goes to ``<out>/ckpt``: by default ``~/.cache/rgbd_pifuhd_tpu_torch/
flagship`` (``flagship_lite`` with ``--lite``), never the repo's
``assets/``.  The tree (sphere and capsule, 1024^2) is written under the
temporary directory when missing.

Each finished stage leaves an f16 resume point beside the checkpoint
(``stage1_nml_netF``, ``stage1_nml_netB``, ``stage2_coarse``) with a tag
file of the recipe, written last.  A rerun with the same recipe skips the
stages whose resume point it finds; the resume points are deleted once the
checkpoint is written.  The stage files are the JAX package's format and
load in either package.  Unlike the JAX script, a run that was not
interrupted also continues from the f16 values it saved, so a run killed
after a stage and resumed trains on the same numbers and writes a
checkpoint bit-equal to one that was not interrupted (each stage has its
own sample stream, as in the JAX script).  ``--supervised`` re-runs the
command under ``utils.watchdog.run_watchdog``, which kills a silent or
overdue attempt and retries it; the retry resumes from the stage files.

The initial parameters follow flax's distributions, drawn from a
``torch.Generator`` seeded by ``seed`` (netF, netB, the coarse level) and
``seed + 1`` (the fine level), so they are not the JAX script's numbers;
``init_vars`` gives both packages the same.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

# the recipe's tree, shared by the trainer and the inference on its subject
FLAG_DATA_KW = dict(subjects=("sphere", "capsule"), size=1024,
                    load_size=1024, seed=0)
_CACHE = os.path.join("~", ".cache", "rgbd_pifuhd_tpu_torch")
DEFAULT_OUT = os.path.expanduser(os.path.join(_CACHE, "flagship"))
DEFAULT_LITE_OUT = os.path.expanduser(os.path.join(_CACHE, "flagship_lite"))
# flagship-lite: the normal nets width-scaled ngf 64 -> 16 (same topology:
# 4 downsamplings, 9 resblocks; 11.4 M parameters each against 182.5 M)
LITE_NML_NGF = 16


def flagship_configs():
    """``(coarse, fine)`` level configs of the flagship (a copy of the JAX
    package's ``__graft_entry__._configs(tiny=False)``)."""
    from ..utils.options import PIFuLevelConfig

    g = PIFuLevelConfig(
        num_stack=4, hg_depth=2, hg_dim=256, norm="group",
        hg_down="ave_pool", mlp_dim=(257, 1024, 512, 256, 128, 1),
        mlp_res_layers=(2, 3, 4), merge_layer=2,
        use_front_normal=True, use_back_normal=True, load_size=1024)
    l = PIFuLevelConfig(
        num_stack=1, hg_depth=2, hg_dim=16, norm="group",
        hg_down="no_down", mlp_dim=(272, 512, 256, 128, 1),
        mlp_res_layers=(1, 2), merge_layer=-1,
        use_front_normal=False, use_back_normal=False, load_size=1024)
    return g, l


def flagship_options(dataroot: str, lite: bool = False):
    """The recipe's Options: the flagship configs in bf16 over 1024^2
    renders, 512^2 coarse input, 4096 sample points; ``lite`` narrows the
    normal nets only."""
    import dataclasses

    from ..utils.options import Options

    cfg_g, cfg_l = flagship_configs()
    cfg_g = dataclasses.replace(cfg_g, compute_dtype="bfloat16")
    cfg_l = dataclasses.replace(cfg_l, compute_dtype="bfloat16")
    if lite:
        cfg_g = dataclasses.replace(cfg_g, nml_ngf=LITE_NML_NGF)
    return Options(dataroot=dataroot, load_size=1024, load_size_big=1024,
                   load_size_local=512, num_sample_inout=4096, sigma=8.0,
                   netG=cfg_g, netMR=cfg_l)


def ensure_flagship_dataset(root: str) -> str:
    from ..data.synthetic import generate_synthetic_dataset

    if not os.path.isdir(os.path.join(
            root, "RENDER", FLAG_DATA_KW["subjects"][-1])):
        generate_synthetic_dataset(root, **FLAG_DATA_KW)
    return root


_IMREAD_CACHE: dict = {}


def _memoize_imread():
    """A reader that caches ``utils.imageio.imread_rgb8`` by path for this
    process (the trainer reads the same few renders at every item); it is
    handed to ``TrainDataset``, nothing is patched."""
    from ..utils.imageio import imread_rgb8

    def imread(path):
        if path not in _IMREAD_CACHE:
            _IMREAD_CACHE[path] = imread_rgb8(path)
        v = _IMREAD_CACHE[path]
        return None if v is None else v.copy()

    return imread


# ---- stage-level resume -------------------------------------------------
def _stage_paths(out_dir: str):
    return (os.path.join(out_dir, "stage1_nml"),
            os.path.join(out_dir, "stage2_coarse"))


def recipe_tag(steps_nml: int, steps_coarse: int, steps_fine: int,
               opt_name: str, lr: float, far_boost: float, seed: int,
               lite: bool, sharpen_target: int,
               sharpen_max_steps: int) -> str:
    """The resume points' tag: the JAX script's JSON, keys sorted."""
    return json.dumps(
        dict(steps_nml=steps_nml, steps_coarse=steps_coarse,
             steps_fine=steps_fine, opt=opt_name, lr=lr,
             far_boost=far_boost, seed=seed, lite=lite,
             sharpen=[sharpen_target, sharpen_max_steps]), sort_keys=True)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _pull_f16(tree):
    """A flax tree of numpy leaves (``params_to_flax``) with its f32
    leaves cast to f16."""
    return _map(tree, lambda x: x.astype(np.float16)
                if getattr(x, "dtype", None) == np.float32 else x)


def _push_f32(tree, device):
    """An f16 tree back to f32 tensors on ``device``; other leaves as
    they are."""
    import torch

    return _map(tree, lambda x: torch.from_numpy(x.astype(np.float32)).to(
        device) if getattr(x, "dtype", None) == np.float16 else x)


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return int(getattr(tree, "nbytes", 0))


def _save_stage(path: str, tree, opt, tag: str):
    """Write the f16 ``tree`` as a resume point (the tag file last: a
    kill mid-write leaves an untagged, hence ignored, stage file);
    returns the tree."""
    from ..utils import checkpoint as ckpt

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    name = os.path.basename(path)
    # heartbeats around the write, for a supervising watchdog's silence
    # rule (a flagship stage is ~365 MB)
    print(f"[stage] saving {name} (~{_nbytes(tree) / 1e6:.0f} MB f16)",
          flush=True)
    t0 = time.time()
    if os.path.exists(path + ".tag"):
        os.remove(path + ".tag")
    ckpt.save_checkpoint(path, tree, opt)
    with open(path + ".tag", "w") as f:
        f.write(tag)
    print(f"[stage] saved {name} " + json.dumps(
        {"mb": round(os.path.getsize(path) / 1e6, 1),
         "write_s": round(time.time() - t0, 3)}), flush=True)
    return tree


def _load_stage(path: str, tag: str, device):
    """The stage's tree (f32 tensors on ``device``) when the file exists
    and was written by the same recipe; None otherwise.  An unreadable
    file means "retrain the stage", never a crash."""
    from ..utils import checkpoint as ckpt

    try:
        if os.path.exists(path) and os.path.exists(path + ".tag"):
            with open(path + ".tag") as f:
                if f.read() == tag:
                    print(f"[stage] loading resume point "
                          f"{os.path.basename(path)} "
                          f"({os.path.getsize(path) / 1e6:.0f} MB)",
                          flush=True)
                    with open(path, "rb") as f:
                        payload = ckpt.msgpack_restore(f.read())
                    out = _push_f32(payload["params"], device)
                    print(f"[stage] loaded {os.path.basename(path)}",
                          flush=True)
                    return out
    except Exception as e:  # noqa: BLE001 — e.g. killed mid-write
        print(f"[stage] ignoring unreadable resume point {path}: {e}",
              flush=True)
    return None


def _lattice_spread(coarse, img, calib_np) -> np.ndarray:
    """The corner spread (max - min of the coarse field) of every cell of
    the 65^3 lattice of NDC [-1, 1]^3 mapped through ``inv(calib)``: the
    corner lattice of a 512^3 reconstruction's first octree level.  The
    queries run with ``train=False`` (on the card: ``fused_gather_mlp``),
    in chunks of 65,536 points, the last zero-padded, as the JAX
    script's."""
    import torch

    dev = next(coarse.parameters()).device
    n = 65
    inv = np.linalg.inv(np.asarray(calib_np, np.float64))
    idx = np.stack(np.meshgrid(*([np.arange(n, dtype=np.float64)] * 3),
                               indexing="ij"), -1).reshape(-1, 3)
    world = ((idx * (2.0 / (n - 1)) - 1.0) @ inv[:3, :3].T
             + inv[:3, 3]).astype(np.float32)
    chunk = 65536
    pad = -(-len(world) // chunk) * chunk
    wp = torch.from_numpy(np.pad(world, ((0, pad - len(world)), (0, 0))))
    calib = torch.as_tensor(np.asarray(calib_np, np.float32),
                            device=dev)[None]
    parts = []
    with torch.inference_mode():
        feats = coarse.filter(img, last_only=True)
        for i in range(0, pad, chunk):
            out = coarse.query(feats, wp[i:i + chunk].to(dev)[None], calib)
            parts.append(out.preds[-1, 0, :, 0].float().cpu())
    occ = torch.cat(parts).numpy()[:len(world)].reshape(n, n, n)
    corners = np.stack([occ[dx:dx + n - 1, dy:dy + n - 1, dz:dz + n - 1]
                        for dx in (0, 1) for dy in (0, 1)
                        for dz in (0, 1)])
    return corners.max(axis=0) - corners.min(axis=0)


def _coarse_ambiguity(coarse, img, calib_np) -> int:
    """Level-1 octree cells whose corner spread exceeds the reference's
    0.05 skip threshold (mesh_util.py:179): every such cell is one the
    evaluator must refine, so this count, not the loss, is the recipe's
    field-quality measure."""
    return int((_lattice_spread(coarse, img, calib_np) > 0.05).sum())


class RecipeData:
    """The recipe's per-step data, as the JAX script draws it: the items'
    images and calibs read once, then per step fresh occupancy samples
    (``sample_batch``: the reader's balanced sampler plus ``far_boost``
    times ``num_sample_inout`` uniform box points with exact labels) and,
    for the fine stage, a 512^2 window of the 1024^2 render
    (``crop_batch``: rect ``[256, U(10, 512), 512, 512]``, its NDC
    transform folded into ``calib_local``)."""

    def __init__(self, ds, items, opt, far_boost: float):
        from ..data.datasets import _calib_from_param

        self.ds, self.opt = ds, opt
        self.geom = []  # (verts, faces, tester, calib, intr_local, extr)
        for it in items:
            v, fc = ds.meshes[it["name"]]
            param = np.load(os.path.join(
                opt.dataroot, "PARAM", it["name"], "0_0_00.npy"),
                allow_pickle=True).item()
            calib_np, extrinsic = _calib_from_param(param, opt.load_size)
            intr_local = calib_np @ np.linalg.inv(extrinsic)
            self.geom.append((v, fc, ds.testers[it["name"]], calib_np,
                              intr_local, extrinsic))
        self.box_len = np.asarray(ds.b_max, np.float64) - np.asarray(
            ds.b_min, np.float64)
        self.n_far = int(round(far_boost * opt.num_sample_inout))

    def sample_batch(self, k: int, rng, far_mult: int = 1):
        """``(samples [N, 3], labels [N, 1])`` f32 numpy of item ``k``."""
        from ..data.sampling import sample_occupancy_points

        v, fc, tester, *_ = self.geom[k]
        o, ds = self.opt, self.ds
        s, lbl = sample_occupancy_points(
            v, fc, o.num_sample_inout, ds.b_min, ds.b_max, rng,
            sigma=o.sigma, tester=tester)
        if self.n_far:
            u = (rng.uniform(size=(self.n_far * far_mult, 3)) * self.box_len
                 + ds.b_min).astype(np.float32)
            ul = tester.contains(u)[:, None].astype(np.float32)
            s = np.concatenate([s, u])
            lbl = np.concatenate([lbl, ul])
        return s, lbl

    def crop_batch(self, k: int, rng, img_big, img_g, calib_g) -> dict:
        """The fine-stage batch of item ``k``: ``img_big`` its ``[1, 1024,
        1024, 6]`` stack, ``img_g`` / ``calib_g`` its coarse input, on the
        device they are given on."""
        from ..data.preprocessing import rect_to_ndc_transform

        dev = img_big.device
        y = int(rng.integers(10, 512))
        trans = rect_to_ndc_transform([256, y, 512, 512], 1024, 1024,
                                      flip_y=True)
        _, _, _, _, intr_local, extrinsic = self.geom[k]
        calib_local = (trans @ intr_local @ extrinsic).astype(np.float32)
        s, lbl = self.sample_batch(k, rng)
        return {"images_local": img_big[:, y:y + 512, 256:768][None],
                "images_global": img_g,
                "points": _upload(s, dev)[None, None],
                "calib_local": _upload(calib_local, dev)[None, None],
                "calib_global": calib_g,
                "labels": _upload(lbl, dev)[None, None]}


def _upload(a: np.ndarray, dev):
    """A host array onto ``dev``; to a card from pinned memory without a
    wait, so the host draws the next batch while the card steps."""
    import torch

    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _trainable(model, frozen: tuple):
    return [p for n, p in model.named_parameters()
            if not n.startswith(frozen)]


def train_flagship(dataroot: str, out_dir: str, steps_nml: int = 300,
                   steps_coarse: int = 1200, steps_fine: int = 1200,
                   log_every: int = 50, seed: int = 0,
                   opt_name: str = "adam", lr: float = 3e-3,
                   far_boost: float = 2.0, lite: bool = False,
                   sharpen_target: int = 10000,
                   sharpen_max_steps: int = 0,
                   fine_anneal_steps: int = 0, device=None,
                   init_vars: dict | None = None,
                   on_step=None) -> str:
    """The three stages; returns the checkpoint's path.

    ``opt_name`` / ``lr`` drive the occupancy stages (Adam 3e-3: the
    reference's RMSprop 1e-3 converges the loss but leaves the field fuzzy
    at this step budget).  ``far_boost`` appends that many times
    ``num_sample_inout`` uniform box samples to every occupancy step.
    After stage 2 the capsule's ``_coarse_ambiguity`` is printed;
    ``sharpen_max_steps > 0`` then adds 400-step slabs at lr / 10 with
    fresh moments and 3x far samples until it is at most
    ``sharpen_target``; ``fine_anneal_steps`` adds a tail at lr / 10 to
    stage 3.  Losses are read back every ``log_every`` steps (and at
    every step for ``on_step(stage, i, loss)``).  ``init_vars``: flax
    trees ``{"netF", "netB", "coarse", "fine"}`` (any subset) replacing
    the initial draws.  Each stage prints one ``[stage_summary]`` JSON
    line (ms a step, peak device memory)."""
    import torch

    from ..data.datasets import TrainDataset
    from ..models.blocks import init_flax
    from ..models.coarse import CoarsePIFu
    from ..models.multires import MultiResPIFu
    from ..models.pix2pix import GlobalGenerator
    from ..ops.fused_query import fused_gather_mlp
    from ..train.trainers import (make_coarse_train_step,
                                  make_fine_train_step,
                                  make_normal_train_step, make_optimizer)
    from ..utils import checkpoint as ckpt
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    init_vars = init_vars or {}
    t_start = time.time()

    opt = flagship_options(ensure_flagship_dataset(dataroot), lite=lite)
    cfg_g = opt.netG
    ds = TrainDataset(opt, seed=seed, imread=_memoize_imread())
    n_items = len(ds)
    assert n_items >= 1, f"empty dataset at {dataroot}"

    def log(stage, i, total, loss):
        print(f"[{stage} {i}/{total}] loss={loss:.4f} "
              f"(t+{time.time() - t_start:.0f}s)", flush=True)

    def run(stage, steps, step_fn, batch_fn):
        """``steps`` steps; the time from the first step's end to the
        last's over ``steps - 1`` is the stage's ms a step."""
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t_first = t_last = None
        m = None
        for i in range(steps):
            m = step_fn(batch_fn(i))
            last = i + 1 == steps
            if on_step is not None or i % log_every == 0 or last:
                loss = float(m["loss"])     # waits for the step
                if on_step is not None:
                    on_step(stage, i, loss)
                if i % log_every == 0 or last:
                    log(stage, i, steps, loss)
            if i == 0:
                t_first = time.perf_counter()
            if last:
                t_last = time.perf_counter()
        print("[stage_summary] " + json.dumps({
            "stage": stage, "steps": steps,
            "ms_per_step": (round((t_last - t_first) * 1e3 / (steps - 1), 3)
                            if steps > 1 else None),
            "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                               if cuda else None)}), flush=True)
        return m

    def free():
        if cuda:
            torch.cuda.empty_cache()

    stage1_path, stage2_path = _stage_paths(out_dir)
    tag = recipe_tag(steps_nml, steps_coarse, steps_fine, opt_name, lr,
                     far_boost, seed, lite, sharpen_target,
                     sharpen_max_steps)
    g_tree = _load_stage(stage2_path, tag, dev)

    # ---- stage 1: the normal nets on the ground-truth maps (L1 alone)
    items = [ds[i] for i in range(n_items)]  # images fixed; points not
    nml = None if g_tree is not None else _load_stage(stage1_path, tag,
                                                      dev)
    if g_tree is not None:
        print("[stage] resuming past stage 2 (coarse resume point found)",
              flush=True)
    elif nml is not None:
        print("[stage] resuming past stage 1 (normal-net resume point "
              "found)", flush=True)
    if g_tree is None and nml is None:
        nml = {}
        for net_name, target_key in (("netF", "imF"), ("netB", "imB")):
            # a resume point per net: a kill between netF and netB must
            # not retrain netF
            net_path = f"{stage1_path}_{net_name}"
            prev = _load_stage(net_path, tag, dev)
            if prev is not None:
                print(f"[stage] resuming {net_name} from its resume "
                      "point", flush=True)
                nml[net_name] = prev
                continue
            batches = [
                {"images": torch.from_numpy(np.asarray(
                    it["img"][0], np.float32))[None].to(dev),
                 "target": torch.from_numpy(np.asarray(
                     it[target_key], np.float32))[None].to(dev)}
                for it in items]
            gen = GlobalGenerator(batches[0]["images"].shape[-1], 3,
                                  cfg_g.nml_ngf, cfg_g.nml_n_downsampling,
                                  cfg_g.nml_n_blocks, device=dev)
            if net_name in init_vars:
                ckpt.load_params(gen, init_vars[net_name])
            else:
                init_flax(gen, torch.Generator().manual_seed(seed))
            tx = make_optimizer("adam", 2e-4, gen.parameters())
            step = make_normal_train_step(gen, tx, perceptual_fn=None)
            run(net_name, steps_nml, step,
                lambda i, b=batches: b[i % n_items])
            nml[net_name] = _push_f32(_save_stage(
                net_path, _pull_f16(ckpt.params_to_flax(gen)["params"]),
                opt, tag), dev)
            del gen, tx, step, batches
            free()

    # images stay on the device; each step uploads fresh points only
    img_g = [torch.from_numpy(np.asarray(it["img_512"], np.float32))[
        None].to(dev) for it in items]                          # 512^2
    img_big = [torch.from_numpy(np.asarray(it["img"], np.float32)).to(dev)
               for it in items]                          # [1, 1024^2, 6]
    calib_g = [torch.from_numpy(np.asarray(it["calib"], np.float32))[
        None].to(dev) for it in items]
    data = RecipeData(ds, items, opt, far_boost)
    # one sample stream per stage: stage 3 draws the same data whether
    # stage 2 ran in this process or came from its resume point
    rng_coarse = np.random.default_rng(seed)
    rng_fine = np.random.default_rng(seed + 101)

    def coarse_batch(k, rng, far_mult=1):
        s, lbl = data.sample_batch(k, rng, far_mult)
        return {"images": img_g[k], "points": _upload(s, dev)[None],
                "calibs": calib_g[k], "labels": _upload(lbl, dev)[None]}

    # ---- stage 2: the coarse level, the trained normal nets frozen
    if g_tree is None:
        coarse = CoarsePIFu(cfg_g, device=dev)
        data.sample_batch(0, rng_coarse)    # the JAX script's init draw
        if "coarse" in init_vars:
            ckpt.load_params(coarse, init_vars["coarse"])
        else:
            init_flax(coarse, torch.Generator().manual_seed(seed))
        for net_name in ("netF", "netB"):
            ckpt.load_params(getattr(coarse, net_name),
                             {"params": nml[net_name]})
        del nml
        frozen = ("netF.", "netB.")
        tx = make_optimizer(opt_name, lr, _trainable(coarse, frozen))
        step = make_coarse_train_step(coarse, tx, gamma=0.5)
        m = run("coarse", steps_coarse, step,
                lambda i: coarse_batch(i % n_items, rng_coarse))

        # the field-quality diagnostic on the capsule; optional extension
        # slabs (lr / 10, fresh moments, 3x far samples) until it fits
        k_cap = next((i for i, it in enumerate(items)
                      if "capsule" in it["name"]), 0)
        cap_calib = np.asarray(items[k_cap]["calib"], np.float32)
        launched = fused_gather_mlp.launches
        n_amb = _coarse_ambiguity(coarse, img_g[k_cap], cap_calib)
        extra = 0
        print(f"[sharpen] ambiguous cells after {steps_coarse} steps: "
              f"{n_amb} (target <= {sharpen_target}; fused_gather_mlp "
              f"launches {fused_gather_mlp.launches - launched})",
              flush=True)
        if n_amb > sharpen_target and sharpen_max_steps > 0:
            tx = make_optimizer(opt_name, lr * 0.1,
                                _trainable(coarse, frozen))
            step = make_coarse_train_step(coarse, tx, gamma=0.5)
        while n_amb > sharpen_target and extra < sharpen_max_steps:
            for j in range(400):
                m = step(coarse_batch((steps_coarse + extra + j) % n_items,
                                      rng_coarse, far_mult=3))
            extra += 400
            n_amb = _coarse_ambiguity(coarse, img_g[k_cap], cap_calib)
            print(f"[sharpen] +{extra} steps (lr/10, far x3): "
                  f"loss={float(m['loss']):.4f} "
                  f"ambiguous cells={n_amb}", flush=True)
        del tx, step
        g_tree = _push_f32(_save_stage(
            stage2_path, _pull_f16(ckpt.params_to_flax(coarse)), opt, tag),
            dev)
        del coarse
        free()

    # ---- stage 3: the fine level on 512^2 crops, the coarse one frozen
    model = MultiResPIFu(opt.netMR, cfg_g, train_full_pifu=False,
                         device=dev)

    def fine_batch(i):
        k = i % n_items
        return data.crop_batch(k, rng_fine, img_big[k], img_g[k],
                               calib_g[k])

    fine_batch(0)                           # the JAX script's init draw
    if "fine" in init_vars:
        ckpt.load_params(model, init_vars["fine"])
    else:
        init_flax(model, torch.Generator().manual_seed(seed + 1))
    ckpt.load_params(model.netG, g_tree)
    del g_tree
    # netG is frozen: it gets no optimiser state (with Adam ~3 GB for the
    # flagship's 384 M parameters)
    tx_f = make_optimizer(opt_name, lr, _trainable(model, ("netG.",)))
    m = run("fine", steps_fine, make_fine_train_step(model, tx_f),
            fine_batch)
    if fine_anneal_steps > 0:
        tx_f = make_optimizer(opt_name, lr * 0.1,
                              _trainable(model, ("netG.",)))
        m = run("fine-anneal", fine_anneal_steps,
                make_fine_train_step(model, tx_f), fine_batch)
    del tx_f

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "ckpt")
    t0 = time.time()
    ckpt.save_checkpoint(path, _pull_f16(ckpt.params_to_flax(model)), opt,
                         epoch=steps_nml + steps_coarse + steps_fine)
    write_s = time.time() - t0
    for p in (stage1_path, f"{stage1_path}_netF", f"{stage1_path}_netB",
              stage2_path):     # the resume points served their purpose
        for q in (p, p + ".tag"):
            if os.path.exists(q):
                os.remove(q)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"saved {path} ({n_params / 1e6:.1f}M params, "
          f"final fine loss {float(m['loss']):.4f}, "
          f"total {time.time() - t_start:.0f}s) " + json.dumps(
              {"params": n_params,
               "mb": round(os.path.getsize(path) / 1e6, 1),
               "write_s": round(write_s, 3)}), flush=True)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps-nml", type=int, default=300)
    ap.add_argument("--steps-coarse", type=int, default=1200)
    ap.add_argument("--steps-fine", type=int, default=1200)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--dataroot", default=os.path.join(
        tempfile.gettempdir(), "rgbd_flagship_data"))
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--optimizer", default="adam",
                    help="occupancy-stage optimizer (adam | rmsprop; "
                         "rmsprop 1e-3 = the reference recipe)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--far-boost", type=float, default=2.0,
                    help="extra pure-uniform labeled samples per step, as "
                         "a multiple of num_sample_inout (0 = reference "
                         "sampler only)")
    ap.add_argument("--lite", action="store_true",
                    help="train flagship-lite (normal nets ngf 64 -> 16, "
                         "encoders and MLPs as the flagship's; 42.6 M "
                         "parameters, ~85 MB f16). Default --out becomes "
                         f"{DEFAULT_LITE_OUT}")
    ap.add_argument("--supervised", action="store_true",
                    help="re-run this training under utils.watchdog: "
                         "probe the card before each attempt, kill on "
                         "output silence or an overdue deadline, retry "
                         "with stage-level resume")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.lite and args.out == DEFAULT_OUT:
        args.out = DEFAULT_LITE_OUT
    if args.supervised:
        from ..utils.watchdog import run_watchdog

        # silence-kill after 600 s without output (the longest quiet
        # stretch is a stage file's write), 4200 s an attempt
        os.environ.setdefault("BENCH_DEADLINE_S", "4200")
        os.environ.setdefault("BENCH_SILENCE_S", "600")
        os.environ.setdefault("BENCH_PROBE_WAIT_S", "1800")
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        os.environ["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in [os.environ.get("PYTHONPATH")] if p])
        # the child's argv from the PARSED arguments: a prefix such as
        # --super must not reach the child and nest another watchdog
        cmd = [sys.executable, "-m", __spec__.name if __spec__ else
               "rgbd_pifuhd_tpu_torch.tools.train_bench_flagship",
               "--steps-nml", str(args.steps_nml),
               "--steps-coarse", str(args.steps_coarse),
               "--steps-fine", str(args.steps_fine),
               "--out", args.out,
               "--dataroot", args.dataroot,
               "--log-every", str(args.log_every),
               "--optimizer", args.optimizer,
               "--lr", str(args.lr),
               "--far-boost", str(args.far_boost)]
        if args.lite:
            cmd.append("--lite")
        if args.device:
            cmd += ["--device", args.device]
        # the probe asks the card: a CPU run has none to ask
        run_watchdog(cmd=cmd, retry_sleep=60.0,
                     probe=args.device != "cpu")  # raises SystemExit
    train_flagship(args.dataroot, args.out, args.steps_nml,
                   args.steps_coarse, args.steps_fine, args.log_every,
                   opt_name=args.optimizer, lr=args.lr,
                   far_boost=args.far_boost, lite=args.lite,
                   device=args.device)


if __name__ == "__main__":
    main()
