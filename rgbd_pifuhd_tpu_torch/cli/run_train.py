"""Training CLI (port of ``cli/run_train.py``).

    python3 -m rgbd_pifuhd_tpu_torch.cli.run_train --stage coarse \\
        --dataroot <tree> --name exp --checkpoints_path <dir>
    python3 -m rgbd_pifuhd_tpu_torch.cli.run_train --stage fine \\
        --dataroot <tree> --name exp --checkpoints_path <dir> \\
        --load_netG_checkpoint_path <dir>/exp_netG_train_latest
    python3 -m rgbd_pifuhd_tpu_torch.cli.run_train --stage normals ...
    python3 -m rgbd_pifuhd_tpu_torch.cli.run_train --stage alternating ...
    python3 -m rgbd_pifuhd_tpu_torch.cli.run_train --stage eval ...

``--stage fine`` (the default) trains the two-level model with netG frozen,
``--stage coarse`` pretrains netG; ``--use_crop`` turns on the random crop
of the fine stage.  ``--stage normals`` pretrains netF and netB (loss
curves and montages only: no checkpoint, as in the JAX package);
``--stage alternating`` runs the curriculum {normals -> coarse -> fine}
with the JAX package's defaults (10 cycles of 5 / 5 / 10 epochs);
``--stage eval`` prints ``Err(occ:fine)`` of every epoch checkpoint
``<name>_train_epoch_<N>`` (N = 0, freq_save, ...).  Every option of
``utils.options`` applies (widths, ``--compute_dtype``,
``--num_sample_inout``, ``--sigma``, the optimiser and its schedule,
``--num_epoch``, ``--freq_save``, ``--continue_train``, ``--resume_epoch``,
``--remat``, ``--use_aug`` and ``--aug_*``).  Checkpoints go to
``<checkpoints_path>/<name>_train_latest`` (and ``_epoch_<N>``; the coarse
stage's under ``<name>_netG``), the per-epoch losses to
``train_result/<name>_netMR`` (``_netG``, ``_netF``, ``_netB``) under the
working directory.  ``--device`` is ``cuda`` unless ``cpu`` is asked for;
on ``cuda`` the last line is the process's peak device memory.

Several processes (one device each; ``parallel.distributed``): start one
per device with ``--coordinator_address host:port --num_processes N
--process_id K`` (or ``RGBD_COORDINATOR`` / ``RGBD_NUM_PROCESSES`` /
``RGBD_PROCESS_ID``); rank K computes on ``cuda:(K mod device count)`` or
the CPU (NCCL, or gloo on the CPU), ``--batch_size`` stays the global
batch, and only rank 0 writes.  On a host with several GPUs and none of these flags the command starts one rank per
GPU itself (the JAX package's run trains on every local device).
``--stage eval`` shards its batches over the ranks as well.
"""

from __future__ import annotations

import os
import sys


_DIST_FLAGS = (("--coordinator_address", "coordinator_address", str),
               ("--num_processes", "num_processes", int),
               ("--process_id", "process_id", int))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, argv: list, n: int, port: int) -> None:
    main(argv + ["--coordinator_address", f"127.0.0.1:{port}",
                 "--num_processes", str(n), "--process_id", str(rank)])


def spawn_ranks(argv: list, n: int) -> None:
    """``n`` ranks of this command on this host, one per GPU, meeting on a
    free local port; returns when all have ended (raises if one failed)."""
    import torch.multiprocessing as mp

    mp.start_processes(_rank_main, args=(argv, n, _free_port()), nprocs=n,
                       start_method="spawn")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    full_argv = list(argv)
    stage = "fine"
    use_crop = False
    if "--stage" in argv:
        i = argv.index("--stage")
        stage = argv[i + 1]
        del argv[i:i + 2]
    if "--use_crop" in argv:
        use_crop = True
        argv.remove("--use_crop")
    dist_kw = {}
    for flag, key, cast in _DIST_FLAGS:
        if flag in argv:
            i = argv.index(flag)
            dist_kw[key] = cast(argv[i + 1])
            del argv[i:i + 2]
    if stage not in ("fine", "coarse", "normals", "alternating", "eval"):
        raise SystemExit(f"unknown --stage {stage!r}")

    import torch

    from ..parallel import (initialize_distributed, is_primary,
                            make_device_mesh, process_device)
    from ..parallel.distributed import _ENV_NPROC, process_count
    from ..train import loop
    from ..utils.device import resolve_device
    from ..utils.options import parse_options, print_options

    opt, device = parse_options(argv, with_device=True)
    dev = resolve_device(device)
    multi = dist_kw.get("num_processes") or os.environ.get(_ENV_NPROC)
    if dev.type == "cuda" and not multi and torch.cuda.device_count() > 1:
        return spawn_ranks(full_argv, torch.cuda.device_count())
    if initialize_distributed(device=dev, **dist_kw):
        dev = process_device(dev.type)
    mesh = make_device_mesh(devices=[dev]) if process_count() > 1 else None
    try:
        if is_primary():
            print_options(opt)
        if stage == "fine":
            loop.train_fine(opt, use_crop=use_crop, device=dev, mesh=mesh)
        elif stage == "coarse":
            loop.pretrain_coarse(opt, device=dev, mesh=mesh)
        elif stage == "normals":
            loop.pretrain_normals(opt, device=dev, mesh=mesh)
        elif stage == "alternating":
            loop.train_alternating(opt, device=dev)
        else:
            res = loop.evaluate_checkpoints(opt, device=dev, mesh=mesh)
            if is_primary():
                for epoch, err in res.items():
                    print(f"epoch {epoch}: Err(occ:fine) = {err:.6f}",
                          flush=True)
        if dev.type == "cuda":
            print(f"peak device memory: "
                  f"{torch.cuda.max_memory_allocated(dev)} bytes", flush=True)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
