"""Reconstruction CLI (port of ``cli/run_recon.py``).

    python3 -m rgbd_pifuhd_tpu_torch.cli.run_recon --dataroot <dir> \\
        --load_netMR_checkpoint_path <ckpt> --results_path <dir> [--device cpu]

The checkpoint is the JAX package's msgpack file or a reference ``.pth``
(its 3-channel netF / netB stems widened to the 6-channel input).  Its
embedded options override the command line except dataroot / resolution /
results_path / loadSize, the export preferences (``--normal_mode fd|grad|
mesh``, ``--mesh_format``) and the field evaluation (``--octree_levels
2|3``, ``--no_octree``).  Subjects are PNG or baseline JPEG files.
``--start_id`` / ``--end_id`` select a range of the directory's subjects;
more than one subject goes through the two-slot ``gen_mesh_many`` (which
evaluates the octree field, as in the JAX package), unless
``--no_octree``.

``--demo-trained`` is the hermetic demo with a real field: it loads the
committed trained-tiny two-level checkpoint (``assets/bench_tiny``),
regenerates its synthetic capsule subject and reconstructs it.
``--demo-sphere`` is the smoke demo: it writes a one-subject training tree
(a sphere at 256^2, ``<results_path>/_demo_data``), reads it with
``TrainDataset`` and reconstructs it with a freshly initialised model of
the command line's widths (seed 0).

use_color: 0 = fd-normal colours (``gen_mesh``), 1 = image colours, 2 =
image colours + largest-component cleanup + back inpainting.

The last line printed is ``launches {...}``: the process's kernel launch
counts.  On a host with several GPUs and ``--device cuda`` every field
query and colour pass is sharded over all of them
(``cli.common.local_mesh``).
"""

from __future__ import annotations

import json
import os
import sys

from ..data.readdata import InferenceDataset
from .common import (launch_counts, load_item, load_reconstructor,
                     local_mesh, mesh_path)

_ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "assets")


class _CapsuleDemo:
    """The one subject of ``--demo-trained``: the capsule rendered at the
    checkpoint's load size, with the world -> NDC calib it was trained
    under."""

    def __init__(self, size: int):
        self.size = size

    def __len__(self) -> int:
        return 1

    def __getitem__(self, i: int) -> dict:
        from ..data.synthetic import capsule_subject

        rgbd, calib, _, _ = capsule_subject(self.size)
        return {"name": "capsule", "img": rgbd[None], "img_512": rgbd[None],
                "calib": calib}


def _demo_sphere(opt, device):
    """``(Reconstructor, dataset)`` of ``--demo-sphere``."""
    import dataclasses

    import torch

    from ..data.datasets import TrainDataset
    from ..data.synthetic import generate_synthetic_dataset
    from ..models.blocks import init_flax
    from ..models.multires import MultiResPIFu
    from ..recon.pipeline import Reconstructor
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    root = os.path.join(opt.results_path, "_demo_data")
    if not os.path.isdir(os.path.join(root, "gen")):
        generate_synthetic_dataset(root, subjects=("sphere",), size=256,
                                   load_size=opt.load_size)
    dopt = dataclasses.replace(opt, dataroot=root, load_size_big=256,
                               load_size_local=256)
    dataset = TrainDataset(dopt, load_mesh=False)
    model = MultiResPIFu(opt.netMR, opt.netG, device=dev)
    init_flax(model, torch.Generator().manual_seed(0))
    return Reconstructor(model, opt, device=dev, mesh=local_mesh(dev)), \
        dataset


def main(argv=None):
    from ..utils.options import parse_options

    argv = list(sys.argv[1:] if argv is None else argv)
    demo_sphere = "--demo-sphere" in argv
    if demo_sphere:
        argv.remove("--demo-sphere")
    demo_trained = "--demo-trained" in argv
    if demo_trained:
        argv.remove("--demo-trained")
    opt, device = parse_options(argv, with_device=True)
    if opt.use_color not in (0, 1, 2):
        raise SystemExit(f"unknown use_color {opt.use_color}")

    if demo_sphere:
        recon, dataset = _demo_sphere(opt, device)
    elif demo_trained:
        if not opt.load_netMR_checkpoint_path:
            opt.load_netMR_checkpoint_path = os.path.join(
                _ASSETS, "bench_tiny", "ckpt")
        recon, opt_model, _ = load_reconstructor(opt, device, full_opts=True)
        dataset = _CapsuleDemo(opt_model.load_size)
    else:
        recon, opt_model, _ = load_reconstructor(opt, device)
        dataset = InferenceDataset(opt.dataroot, opt.load_size)
    out_dir = os.path.join(opt.results_path, opt.name, "recon")
    os.makedirs(out_dir, exist_ok=True)

    start = 0 if opt.start_id < 0 else opt.start_id
    end = min(len(dataset) if opt.end_id < 0 else opt.end_id, len(dataset))

    if opt.use_octree and end - start > 1:
        # two-slot pipeline; subjects are loaded lazily, so the host holds
        # the two in flight, not the whole directory
        paths: list[str] = []

        def path_for_and_log(data):
            p = mesh_path(out_dir, data, opt)
            print(p)
            paths.append(p)
            return p

        results = recon.gen_mesh_many(
            (load_item(dataset, i) for i in range(start, end)),
            path_for_and_log, use_color=opt.use_color,
            resolution=opt.resolution)
        for p, r in zip(paths, results):
            print(f"{p}: verts={len(r['verts'])} secs={r['secs']:.2f}")
    else:
        for i in range(start, end):
            data = load_item(dataset, i)
            save_path = mesh_path(out_dir, data, opt)
            print(save_path)
            if opt.use_color == 0:
                r = recon.gen_mesh(data, save_path, opt.resolution)
            else:
                r = recon.gen_mesh_img_color(data, save_path, opt.resolution,
                                             cleanup=opt.use_color == 2)
            print(f"  verts={len(r['verts'])} secs={r['secs']:.2f}")
    print("launches " + json.dumps(launch_counts(recon)), flush=True)


if __name__ == "__main__":
    main()
