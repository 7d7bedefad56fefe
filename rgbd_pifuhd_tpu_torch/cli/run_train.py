"""Training CLI (port of ``cli/run_train.py``).

    python3 -m rgbd_pifuhd_tpu_torch.cli.run_train --stage coarse \\
        --dataroot <tree> --name exp --checkpoints_path <dir>
    python3 -m rgbd_pifuhd_tpu_torch.cli.run_train --stage fine \\
        --dataroot <tree> --name exp --checkpoints_path <dir> \\
        --load_netG_checkpoint_path <dir>/exp_netG_train_latest

``--stage fine`` (the default) trains the two-level model with netG frozen,
``--stage coarse`` pretrains netG; ``--use_crop`` turns on the random crop
of the fine stage.  Every option of ``utils.options`` applies (widths,
``--compute_dtype``, ``--num_sample_inout``, ``--sigma``, the optimiser and
its schedule, ``--num_epoch``, ``--freq_save``, ``--continue_train``,
``--resume_epoch``, ``--remat``, ``--use_aug`` and ``--aug_*``).
Checkpoints go to ``<checkpoints_path>/<name>_train_latest`` (and
``_epoch_<N>``; the coarse stage's under ``<name>_netG``), the per-epoch
losses to ``train_result/<name>_netMR`` (``_netG``) under the working
directory.  ``--device`` is ``cuda`` unless ``cpu`` is asked for; on
``cuda`` the last line is the process's peak device memory.
"""

from __future__ import annotations

import sys

_LATER = {
    "normals": "normal-net pretraining",
    "alternating": "the alternating curriculum",
    "eval": "checkpoint evaluation",
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    stage = "fine"
    use_crop = False
    if "--stage" in argv:
        i = argv.index("--stage")
        stage = argv[i + 1]
        del argv[i:i + 2]
    if "--use_crop" in argv:
        use_crop = True
        argv.remove("--use_crop")
    for flag in ("--coordinator_address", "--num_processes", "--process_id"):
        if flag in argv:
            raise SystemExit(
                f"{flag}: multi-process training is not ported yet (the "
                "multi-GPU slice, slice 9 of the port); run one process")
    if stage in _LATER:
        raise SystemExit(
            f"--stage {stage} ({_LATER[stage]}) is not ported yet: it comes "
            "with the next training slice (normal-net pretraining, GAN, "
            "train_alternating, evaluate_checkpoints)")
    if stage not in ("fine", "coarse"):
        raise SystemExit(f"unknown --stage {stage!r}")

    from ..train.loop import pretrain_coarse, train_fine
    from ..utils.device import resolve_device
    from ..utils.options import parse_options, print_options

    opt, device = parse_options(argv, with_device=True)
    dev = resolve_device(device)
    print_options(opt)
    if stage == "fine":
        train_fine(opt, use_crop=use_crop, device=dev)
    else:
        pretrain_coarse(opt, device=dev)
    if dev.type == "cuda":
        import torch

        print(f"peak device memory: {torch.cuda.max_memory_allocated(dev)} "
              "bytes", flush=True)


if __name__ == "__main__":
    main()
