"""Resident serving entry point (port of ``cli/serve.py``): the weights load
once, the kernels build once, and every request pays only evaluation time.

    python3 -m rgbd_pifuhd_tpu_torch.cli.serve \\
        --load_netMR_checkpoint_path <ckpt> --results_path <dir> [--device cpu]

Protocol — one request per stdin line:

    <dataroot>              reconstruct every subject in the directory
    <dataroot>::<stem>      only the subject named <stem>
    quit                    exit cleanly

Requests use the ``InferenceDataset`` conventions (``<stem>.png``,
``.jpg`` or ``.jpeg`` + ``<stem>_rect.txt`` + ``depth/depth_<stem>.png``).
The checkpoint may be a reference ``.pth``.  One JSON line per produced
mesh on stdout:

    {"name": ..., "mesh": "<path>", "verts": N, "secs": S}

(each reply also carries ``read_secs``, the seconds spent decoding and
resizing the subject's images: part of ``secs`` for a single subject; in a
directory request the next subject's read runs while the previous one's
host tail is on the worker)

a ``{"ready": true}`` line once the model is loaded, per failed request an
``{"error": ..., "request": ...}`` line (the server keeps running), and a
last ``{"quit": true, "launches": {...}}`` line with the process's kernel
launch counts.  ``--use_color``, ``--mesh_format``, ``--normal_mode``,
``--octree_levels`` and ``--no_octree`` hold for the whole process.
``--use_color``: 0 fd-normal colours, 1 image colours, 2 image colours with
cleanup, 3 PIFu's texture network (``models.texture``): the checkpoint must
hold a ``netC`` (and its sizes, ``opt_netC``), else the server refuses to
start.  No trained netC is in the repository yet: the benchmark's is drawn
from a seed, so its colours are not a person's.  On a
host with several GPUs and ``--device cuda`` every field query and colour
pass is sharded over all of them (``cli.common.local_mesh``).
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

from ..data.readdata import InferenceDataset
from .common import (check_use_color, launch_counts, load_item,
                     load_reconstructor, mesh_path)


def _serve_loop(recon, opt, out_dir: str, requests, emit):
    """Request loop, separated from the process wiring for the tests."""
    for line in requests:
        req = line.strip()
        if not req:
            continue
        if req == "quit":
            break
        root, _, stem = req.partition("::")
        try:
            dataset = InferenceDataset(root, opt.load_size)
            idxs = [i for i, (_, _, name) in enumerate(dataset.items)
                    if not stem or name == stem]
            if not idxs:
                raise FileNotFoundError(
                    f"no subject{' ' + stem if stem else 's'} under {root}")
            if len(idxs) > 1:
                # multi-subject request: the two-slot pipeline, as the
                # batch CLI's
                named: list[tuple[str, str, float]] = []
                t_reads: list[float] = []

                def read(i):
                    t0 = time.time()
                    data = load_item(dataset, i)
                    t_reads.append(time.time() - t0)
                    return data

                def path_for_and_log(data):
                    p = mesh_path(out_dir, data, opt)
                    named.append((data["name"], p, t_reads[-1]))
                    return p

                results = recon.gen_mesh_many(
                    (read(i) for i in idxs), path_for_and_log,
                    use_color=opt.use_color, resolution=opt.resolution)
                for (name, p, t_read), r in zip(named, results):
                    emit({"name": name, "mesh": p,
                          "verts": int(len(r["verts"])),
                          "secs": round(r["secs"], 3),
                          "read_secs": round(t_read, 3)})
            else:
                t0 = time.time()
                data = load_item(dataset, idxs[0])
                t_read = time.time() - t0
                save_path = mesh_path(out_dir, data, opt)
                r = recon.gen_mesh(data, save_path, opt.resolution,
                                   use_color=opt.use_color)
                emit({"name": data["name"], "mesh": save_path,
                      "verts": int(len(r["verts"])),
                      "secs": round(time.time() - t0, 3),
                      "read_secs": round(t_read, 3)})
        except Exception as e:  # noqa: BLE001 — a request must not kill
            traceback.print_exc(file=sys.stderr)
            emit({"error": f"{type(e).__name__}: {e}", "request": req})


def main(argv=None):
    from ..utils.options import parse_options

    opt, device = parse_options(
        list(sys.argv[1:] if argv is None else argv), with_device=True)
    recon, opt_model, path = load_reconstructor(opt, device)
    check_use_color(recon, opt, path)
    out_dir = os.path.join(opt.results_path, opt.name, "serve")
    os.makedirs(out_dir, exist_ok=True)

    def emit(obj):
        print(json.dumps(obj), flush=True)

    emit({"ready": True, "checkpoint": path, "out_dir": out_dir,
          "device": str(recon.device)})
    _serve_loop(recon, opt, out_dir, sys.stdin, emit)
    emit({"quit": True, "launches": launch_counts(recon)})


if __name__ == "__main__":
    main()
