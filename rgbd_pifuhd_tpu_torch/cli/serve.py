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

(a single-subject reply also carries ``read_secs``, the part of ``secs``
spent decoding and resizing the subject's images)

a ``{"ready": true}`` line once the model is loaded, per failed request an
``{"error": ..., "request": ...}`` line (the server keeps running), and a
last ``{"quit": true, "launches": {...}}`` line with the process's kernel
launch counts.  ``--use_color``, ``--mesh_format``, ``--normal_mode``,
``--octree_levels`` and ``--no_octree`` hold for the whole process.  On a
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
from .common import launch_counts, load_item, load_reconstructor, mesh_path


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
                named: list[tuple[str, str]] = []

                def path_for_and_log(data):
                    p = mesh_path(out_dir, data, opt)
                    named.append((data["name"], p))
                    return p

                results = recon.gen_mesh_many(
                    (load_item(dataset, i) for i in idxs), path_for_and_log,
                    use_color=opt.use_color, resolution=opt.resolution)
                for (name, p), r in zip(named, results):
                    emit({"name": name, "mesh": p,
                          "verts": int(len(r["verts"])),
                          "secs": round(r["secs"], 3)})
            else:
                t0 = time.time()
                data = load_item(dataset, idxs[0])
                t_read = time.time() - t0
                save_path = mesh_path(out_dir, data, opt)
                if opt.use_color == 0:
                    r = recon.gen_mesh(data, save_path, opt.resolution)
                else:
                    r = recon.gen_mesh_img_color(
                        data, save_path, opt.resolution,
                        cleanup=opt.use_color == 2)
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
    if opt.use_color not in (0, 1, 2):
        raise SystemExit(f"unknown use_color {opt.use_color}")
    recon, opt_model, path = load_reconstructor(opt, device)
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
