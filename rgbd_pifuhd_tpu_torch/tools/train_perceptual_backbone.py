"""Train the repo's own perceptual backbone (port of
``scripts/train_perceptual_backbone.py``): ``models.perceptual.
CompactFeatures`` with the denoising pretext, on crops of the port's own
synthetic renders, composites and normal maps, written as the ``.npz``
that both packages' ``load_backbone`` read.

    python3 -m rgbd_pifuhd_tpu_torch.tools.train_perceptual_backbone \\
        [--steps 600] [--out assets/perceptual/backbone.npz] \\
        [--dataroot <tree>] [--device cuda|cpu]

``--out`` defaults to the committed backbone, which ``select_perceptual(
"native")`` finds; ``--dataroot`` to a tree under the temporary directory,
written first when it is missing (sphere, capsule, bumpy at 128^2).
``--device`` defaults to ``cuda``.  The batches and the noise come from a
``torch.Generator`` (``train_backbone``), so the weights are not the JAX
script's; the corpus is its array.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

SUBJECTS = ("sphere", "capsule", "bumpy")


def build_corpus(root: str, crop: int = 64, n_crops: int = 96,
                 seed: int = 0) -> np.ndarray:
    """``[n_crops, crop, crop, 3]`` crops in [-1, 1] of the tree's front
    and back renders, normal maps and composites, drawn as the JAX
    script draws them (``default_rng(seed)``, images in turn)."""
    from ..data.synthetic import generate_synthetic_dataset
    from ..utils.imageio import imread_rgb8

    if not os.path.isdir(os.path.join(root, "RENDER", "bumpy")):
        generate_synthetic_dataset(root, subjects=SUBJECTS, size=128,
                                   load_size=128, seed=seed)
    paths = []
    for sub in SUBJECTS:
        for d, names in (("RENDER", ("0_0_00.jpg", "180_0_00.jpg")),
                         ("NORM", ("0_0_00.png", "180_0_00.png"))):
            paths += [os.path.join(root, d, sub, n) for n in names]
    gen_dir = os.path.join(root, "gen")
    paths += [os.path.join(gen_dir, f) for f in sorted(os.listdir(gen_dir))]
    imgs = []
    for p in paths:
        im = imread_rgb8(p) if os.path.exists(p) else None
        if im is not None:
            imgs.append(im.astype(np.float32) / 127.5 - 1.0)
    rng = np.random.default_rng(seed)
    crops = []
    for k in range(n_crops):
        im = imgs[k % len(imgs)]
        y = int(rng.integers(0, im.shape[0] - crop + 1))
        x = int(rng.integers(0, im.shape[1] - crop + 1))
        crops.append(im[y:y + crop, x:x + crop])
    return np.stack(crops)


def main(argv=None) -> None:
    from ..models.perceptual import (DEFAULT_BACKBONE, save_backbone,
                                     train_backbone)

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--out", default=DEFAULT_BACKBONE)
    ap.add_argument("--dataroot", default=os.path.join(
        tempfile.gettempdir(), "rgbd_backbone_data"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    corpus = build_corpus(args.dataroot)
    print(f"corpus: {corpus.shape}", flush=True)
    params, loss = train_backbone(corpus, steps=args.steps,
                                  device=args.device)
    save_backbone(args.out, params)
    n = sum(int(np.prod(leaf.shape)) for layer in params["params"].values()
            for leaf in layer.values())
    print(f"saved {args.out} ({n / 1e3:.0f}k params, final denoise mse "
          f"{loss:.4f})", flush=True)


if __name__ == "__main__":
    main()
