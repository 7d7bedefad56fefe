"""Where the host and the card spend a flagship-lite ``gen_mesh`` with fd
and with grad colours.

    python3 -m rgbd_pifuhd_tpu_torch.tools.profile_grad

Run from the root of a checkout on a machine with a CUDA card.  For each
normal mode: two warm-up meshes (the first escalates the budgets and
builds the kernels), then one under ``torch.profiler`` (CPU + CUDA).
Prints each run's seconds and host seconds, the 25 operations with the
most host time (with their count and device time), and the calls that can
make the host wait (synchronisations, allocations, copies).
"""

from __future__ import annotations

import dataclasses
import os
import sys


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..data.synthetic import capsule_subject
    from ..models import MultiResPIFu
    from ..recon import Reconstructor
    from ..utils.checkpoint import (load_checkpoint, load_params,
                                    restore_options)
    from ..utils.options import Options

    if not torch.cuda.is_available():
        sys.exit("profile_grad needs a CUDA card")
    dev = torch.device("cuda")
    ckpt = load_checkpoint(os.path.join("assets", "bench_flagship_lite",
                                        "ckpt"), device=dev)
    opt, _ = restore_options(Options(), ckpt)
    model = MultiResPIFu(opt.netMR, opt.netG, device=dev)
    load_params(model, ckpt["params"])
    rgbd, calib, _, _ = capsule_subject(512)
    data = {"img": rgbd[None], "img_512": rgbd[None], "calib": calib}
    os.makedirs("smoke_out", exist_ok=True)
    path = os.path.join("smoke_out", "profile_grad.obj")
    waits = ("Synchronize", "Malloc", "HostAlloc", "Memcpy", "FreeHost")
    for mode in ("fd", "grad"):
        r = Reconstructor(model, dataclasses.replace(opt, normal_mode=mode),
                          device=dev)
        for k in range(2):
            out = r.gen_mesh(data, path, resolution=512)
            torch.cuda.synchronize()
            print(mode, k, round(out["secs"], 3), out["host_secs"],
                  flush=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = r.gen_mesh(data, path, resolution=512)
            torch.cuda.synchronize()
        print(mode, "profiled", round(out["secs"], 3), out["host_secs"],
              flush=True)
        rows = sorted(prof.key_averages(),
                      key=lambda e: -e.self_cpu_time_total)[:25]
        for e in rows:
            print(f"  {e.key[:70]:70s} n={e.count:6d} self_cpu_ms="
                  f"{e.self_cpu_time_total / 1e3:9.1f} dev_ms="
                  f"{e.self_device_time_total / 1e3:8.1f}")
        for e in prof.key_averages():
            if any(w in e.key for w in waits):
                print(f"  * {e.key[:70]:70s} n={e.count:6d} self_cpu_ms="
                      f"{e.self_cpu_time_total / 1e3:9.1f}")
    os.remove(path)
    os.remove(path[:-4] + ".png")


if __name__ == "__main__":
    main()
