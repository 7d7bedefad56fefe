"""Calibration / sampling check of a training tree (port of
``cli/debug_vis.py``), host code:

    python3 -m rgbd_pifuhd_tpu_torch.cli.debug_vis --dataroot <tree> \\
        [--index 0] [--ply samples.ply] [--out debug_vis.png]

Loads one ``TrainDataset`` item (300 samples, sigma 5), projects its
sampled points with its calibration, prints one summary line (subject,
sample count, inside share, the NDC range), optionally writes the samples
as a PLY (red inside, green outside) and, where matplotlib is installed,
plots them over the input image; otherwise it says it skipped the plot.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataroot", required=True)
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--out", default="./debug_vis.png")
    p.add_argument("--ply", default=None)
    args = p.parse_args(argv)

    import torch

    from ..data.datasets import TrainDataset
    from ..ops import geometry as G
    from ..utils.options import Options

    opt = Options(dataroot=args.dataroot, num_sample_inout=300, sigma=5.0)
    ds = TrainDataset(opt)
    item = ds[args.index]

    pts = torch.as_tensor(item["samples"], dtype=torch.float32)[None]
    calib = torch.as_tensor(item["calib"], dtype=torch.float32)[None]
    ndc = G.orthogonal(pts, calib)[0].numpy()
    labels = item["labels"][:, 0]
    print(f"subject={item['name']} samples={len(labels)} "
          f"inside={labels.mean():.2f} "
          f"ndc range x[{ndc[:,0].min():.2f},{ndc[:,0].max():.2f}] "
          f"y[{ndc[:,1].min():.2f},{ndc[:,1].max():.2f}]")

    if args.ply:
        from ..recon.mesh import save_occupancy_samples_ply
        save_occupancy_samples_ply(args.ply, item["samples"], labels)
        print("wrote", args.ply)

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        img = item["img_512"][..., :3] * 0.5 + 0.5
        h, w = img.shape[:2]
        px = (ndc[:, 0] + 1) * 0.5 * (w - 1)
        py = (ndc[:, 1] + 1) * 0.5 * (h - 1)
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.imshow(img)
        ax.scatter(px[labels > 0.5], py[labels > 0.5], s=2, c="r",
                   label="inside")
        ax.scatter(px[labels <= 0.5], py[labels <= 0.5], s=2, c="g",
                   label="outside")
        ax.legend()
        fig.savefig(args.out, dpi=110)
        print("wrote", args.out)
    except ImportError:
        print("matplotlib unavailable; skipped plot")


if __name__ == "__main__":
    main()
