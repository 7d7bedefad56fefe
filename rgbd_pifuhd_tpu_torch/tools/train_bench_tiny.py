"""Train the tiny two-level model on the capsule (port of
``scripts/train_bench_tiny.py``, the recipe of the committed
``assets/bench_tiny/ckpt``): the coarse level, then the fine level on the
frozen coarse, Adam 3e-3 (b1 0.9), a fresh ``ds[0]`` occupancy sampling at
every step, saved as an f16 checkpoint.

    python3 -m rgbd_pifuhd_tpu_torch.tools.train_bench_tiny \\
        [--steps 400] [--out DIR] [--dataroot DIR] [--device cuda|cpu]

``--out`` defaults to ``~/.cache/rgbd_pifuhd_tpu_torch/tiny`` (never the
repo's ``assets/``); the checkpoint is ``<out>/ckpt``.  The capsule tree
(128^2) is written under the temporary directory when missing.  The
fine level is norm-free, so on the card it runs ``gather_concat`` +
``fused_point_mlp``, the coarse level ``fused_gather_mlp``.  The initial
parameters follow flax's distributions from ``torch.Generator`` seeds 0
(coarse) and 1 (fine), not the JAX script's numbers; ``init_vars``
gives both packages the same.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

# one place owns the tiny configs and the tree, for training and inference
TINY_DATA_KW = dict(subjects=("capsule",), size=128, load_size=128, seed=0)
DEFAULT_OUT = os.path.expanduser(os.path.join(
    "~", ".cache", "rgbd_pifuhd_tpu_torch", "tiny"))


def tiny_coarse_cfg():
    from ..utils.options import PIFuLevelConfig
    return PIFuLevelConfig(
        num_stack=2, hg_depth=2, hg_dim=16, norm="group", hg_down="ave_pool",
        mlp_dim=(17, 128, 64, 32, 1), mlp_res_layers=(1, 2), mlp_norm="none",
        merge_layer=2, use_depth=True,
        use_front_normal=False, use_back_normal=False,
        load_size=128, z_size=64.0)


def tiny_fine_cfg():
    # fine MLP input = local hg_dim (16) + coarse phi at merge_layer 2 (32)
    from ..utils.options import PIFuLevelConfig
    return PIFuLevelConfig(
        num_stack=1, hg_depth=2, hg_dim=16, norm="group", hg_down="no_down",
        mlp_dim=(48, 64, 32, 1), mlp_res_layers=(1,), mlp_norm="none",
        merge_layer=-1, use_depth=True,
        use_front_normal=False, use_back_normal=False,
        load_size=128, z_size=64.0)


def tiny_options(dataroot: str):
    from ..utils.options import Options
    return Options(dataroot=dataroot, load_size=128, load_size_big=128,
                   load_size_local=128, num_sample_inout=512, sigma=8.0,
                   netG=tiny_coarse_cfg(), netMR=tiny_fine_cfg())


def ensure_tiny_dataset(root: str) -> str:
    """Write (once) the capsule tree the tiny model trains on."""
    from ..data.synthetic import generate_synthetic_dataset

    if not os.path.isdir(os.path.join(root, "RENDER", "capsule")):
        generate_synthetic_dataset(root, **TINY_DATA_KW)
    return root


def train_tiny(dataroot: str, out_dir: str, steps: int = 400, device=None,
               init_vars: dict | None = None, on_step=None) -> str:
    """Both stages; returns the checkpoint's path.  ``init_vars``: flax
    trees ``{"coarse", "fine"}`` replacing the initial draws;
    ``on_step(stage, i, loss)`` is called at every step."""
    import torch

    from ..data.datasets import TrainDataset
    from ..models.blocks import init_flax
    from ..models.coarse import CoarsePIFu
    from ..models.multires import MultiResPIFu
    from ..train.trainers import (make_coarse_train_step,
                                  make_fine_train_step, make_optimizer)
    from ..utils import checkpoint as ckpt
    from ..utils.device import resolve_device
    from .train_bench_flagship import _memoize_imread, _pull_f16, _upload

    dev = resolve_device(device)
    init_vars = init_vars or {}
    opt = tiny_options(ensure_tiny_dataset(dataroot))
    # the renders read once (the JAX script reads them at every item)
    ds = TrainDataset(opt, seed=0, imread=_memoize_imread())
    item = ds[0]
    img = torch.from_numpy(np.asarray(item["img_512"], np.float32))[
        None].to(dev)
    calib = torch.from_numpy(np.asarray(item["calib"], np.float32))[
        None].to(dev)

    def points(it):
        return (_upload(np.asarray(it["samples"], np.float32), dev),
                _upload(np.asarray(it["labels"], np.float32), dev))

    def run(stage, step_fn, batch_fn):
        m = None
        for i in range(steps):
            m = step_fn(batch_fn(ds[0]))   # fresh sampling every step
            if on_step is not None:
                on_step(stage, i, float(m["loss"]))
            if i % 100 == 0:
                print(f"[{stage} {i}] loss={float(m['loss']):.4f}",
                      flush=True)
        return m

    # ---- stage 1: pretrain the coarse level
    coarse = CoarsePIFu(opt.netG, device=dev)
    if "coarse" in init_vars:
        ckpt.load_params(coarse, init_vars["coarse"])
    else:
        init_flax(coarse, torch.Generator().manual_seed(0))
    tx = make_optimizer("adam", 3e-3, coarse.parameters(), b1=0.9)

    def coarse_batch(it):
        s, lbl = points(it)
        return {"images": img, "points": s[None], "calibs": calib,
                "labels": lbl[None]}

    run("coarse", make_coarse_train_step(coarse, tx, gamma=0.5),
        coarse_batch)

    # ---- stage 2: the fine MLP on the frozen coarse
    model = MultiResPIFu(opt.netMR, opt.netG, train_full_pifu=False,
                         device=dev)
    if "fine" in init_vars:
        ckpt.load_params(model, init_vars["fine"])
    else:
        init_flax(model, torch.Generator().manual_seed(1))
    model.netG.load_state_dict(coarse.state_dict())
    del coarse, tx
    tx_f = make_optimizer("adam", 3e-3, model.parameters(), b1=0.9)

    def fine_batch(it):
        s, lbl = points(it)
        return {"images_local": img[None], "images_global": img,
                "points": s[None, None], "calib_local": calib[None],
                "calib_global": calib, "labels": lbl[None, None]}

    m = run("fine", make_fine_train_step(model, tx_f), fine_batch)

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "ckpt")
    # float16 halves the file; inference casts back to float32
    ckpt.save_checkpoint(path, _pull_f16(ckpt.params_to_flax(model)), opt,
                         epoch=steps)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"saved {path} ({n_params / 1e6:.2f}M params, "
          f"final fine loss {float(m['loss']):.4f})", flush=True)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--dataroot", default=os.path.join(
        tempfile.gettempdir(), "rgbd_bench_tiny_data"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    train_tiny(args.dataroot, args.out, args.steps, device=args.device)


if __name__ == "__main__":
    main()
