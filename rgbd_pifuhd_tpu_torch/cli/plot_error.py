"""Loss-history summary and plot (port of ``cli/plot_error.py``).

    python3 -m rgbd_pifuhd_tpu_torch.cli.plot_error --name <name> \\
        [--out_dir ./train_result] [--save <png>]

Reads the per-epoch error arrays that the trainers write
(``<out_dir>/<name>_{netG,netMR,netF,netB}/error_epoch_<N>.npy``), prints
one line per run (iterations, first losses, the last of 50 group means,
the minimum) and, where matplotlib is installed, plots the group means.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..utils.logging import load_error_history


def group_average(arr: np.ndarray, groups: int = 50) -> np.ndarray:
    if len(arr) < groups:
        return arr
    n = len(arr) // groups * groups
    return arr[:n].reshape(groups, -1).mean(axis=1)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out_dir", default="./train_result")
    p.add_argument("--name", default="pifuhd")
    p.add_argument("--save", default=None, help="png output path")
    args = p.parse_args(argv)

    curves = {}
    for suffix in ("netG", "netMR", "netF", "netB"):
        hist = load_error_history(args.out_dir, f"{args.name}_{suffix}")
        if hist:
            curves[suffix] = np.concatenate(hist)

    if not curves:
        print("no error histories found")
        return

    for k, v in curves.items():
        g = group_average(v)
        print(f"{k}: {len(v)} iters | first {v[:3].round(4).tolist()} | "
              f"last avg {g[-1]:.5f} | min {v.min():.5f}")

    try:
        import matplotlib
    except ImportError:
        print("matplotlib unavailable; text summary only")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    for k, v in curves.items():
        ax.plot(group_average(v), label=k)
    ax.set_xlabel("progress (grouped)")
    ax.set_ylabel("loss")
    ax.legend()
    out = args.save or f"{args.out_dir}/{args.name}_loss.png"
    fig.savefig(out, dpi=120)
    print("saved plot:", out)


if __name__ == "__main__":
    main()
