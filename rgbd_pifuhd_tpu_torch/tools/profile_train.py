"""Where a paper-width training step spends its time on the card.

    python3 -m rgbd_pifuhd_tpu_torch.tools.profile_train

Run from the root of a checkout on a machine with a CUDA card.  Writes the
smoke run's training tree (sphere, capsule, bumpy; 512^2 renders, load
size 1024) under ``smoke_out/``, reads three items at the paper's widths
in bf16 with 4096 samples (the seconds an item takes on the host), then
for the coarse and the fine stage: ``init_flax`` seconds, three warm-up
steps, six timed steps (host clock, each ended by reading the loss), and
three steps under ``torch.profiler`` — the kernels' device milliseconds a
step, the kernel launches a step, and the ten kernels with the most device
time.  After the coarse stage: the seconds to gather its checkpoint tree
from the card, to write it and to read it back.  Prints one JSON line per
measurement.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def _steps(torch, step, batches) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        float(step(batches[i % 3])["loss"])
    ms = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step(batches[i % 3])["loss"])
        ms.append(round((time.perf_counter() - t0) * 1e3, 2))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            float(step(batches[i % 3])["loss"])
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {"step_ms": ms,
            "kernel_ms_per_step": round(sum(
                e.self_device_time_total for e in kernels) / 3e3, 2),
            "launches_per_step": sum(e.count for e in kernels) // 3,
            "top_kernels_ms": [(e.key[:70], round(
                e.self_device_time_total / 3e3, 2)) for e in top]}


def main() -> None:
    import torch

    from ..data.datasets import TrainDataset
    from ..data.synthetic import generate_synthetic_dataset
    from ..models import CoarsePIFu, MultiResPIFu
    from ..models.blocks import init_flax
    from ..train import loop, trainers
    from ..utils import checkpoint as ckpt
    from ..utils.options import parse_options

    if not torch.cuda.is_available():
        sys.exit("profile_train needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)
    root = os.path.join("smoke_out", "traindata")
    generate_synthetic_dataset(root, ("sphere", "capsule", "bumpy"),
                               size=512, load_size=1024)
    opt = parse_options(["--dataroot", root, "--compute_dtype", "bfloat16",
                         "--num_sample_inout", "4096", "--sigma", "8"])
    data = TrainDataset(opt, seed=0)
    t0 = time.perf_counter()
    items = [data[i] for i in range(3)]
    print(json.dumps({"item_s": round((time.perf_counter() - t0) / 3, 3)}),
          flush=True)
    gen = torch.Generator().manual_seed(0)
    for stage in ("coarse", "fine"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if stage == "coarse":
            model = CoarsePIFu(opt.netG, device=dev)
        else:
            model = MultiResPIFu(opt.netMR, opt.netG, device=dev)
        init_flax(model, gen)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        tx = trainers.make_optimizer("rmsprop", 1e-3, model.parameters())
        if stage == "coarse":
            step = trainers.make_coarse_train_step(model, tx, 0.1)
            batches = [loop._to_device(loop.collate_coarse([it]), dev)
                       for it in items]
        else:
            step = trainers.make_fine_train_step(model, tx)
            batches = [loop._to_device(loop.collate_fine([it]), dev)
                       for it in items]
        out = {"stage": stage, "params": sum(p.numel() for p in
                                             model.parameters()),
               "init_s": round(init_s, 2), **_steps(torch, step, batches),
               "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        print(json.dumps(out), flush=True)
        if stage == "coarse":
            path = os.path.join("smoke_out", "profile_train_ckpt")
            t0 = time.perf_counter()
            tree = ckpt.params_to_flax(model)
            t1 = time.perf_counter()
            ckpt.save_checkpoint(path, tree, opt)
            t2 = time.perf_counter()
            ckpt.load_checkpoint(path, device=dev)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            print(json.dumps({"checkpoint_bytes": os.path.getsize(path),
                              "gather_s": round(t1 - t0, 2),
                              "write_s": round(t2 - t1, 2),
                              "read_s": round(t3 - t2, 2)}), flush=True)
            os.remove(path)
        del model, tx, step, batches


if __name__ == "__main__":
    main()
