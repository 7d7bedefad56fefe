"""Training steps of the program, driven as its epoch loop drives them
(``train.loop._run``): batches from ``TrainDataset`` through the program's
prefetching batcher and collate, each moved to the card and stepped, the
loss read back (which synchronises, as the loop's logging does).  The step
is ``pretrain_coarse``'s (``CoarsePIFu``, ``make_coarse_train_step``,
``collate_coarse``), the dataset reading through the recipes' image
cache.

Set-up builds one step object (the program's model, ``make_optimizer`` and
``make_coarse_train_step``) with weights drawn on the card from the seed, and
drives it through its first ``check_steps`` steps; those steps' batches,
losses, the first gradient (read from the optimiser's state) and the
parameters' change are kept, and the same object runs on in the window.
After the window the plain reference follows those steps from the same
initial weights.
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np

from portbench.gen import subjects as S


def _opts(cfg, traffic, root, seed):
    from rgbd_pifuhd_tpu_torch.utils.options import Options, PIFuLevelConfig

    def level(d):
        return PIFuLevelConfig(**{k: tuple(v) if isinstance(v, list) else v
                                  for k, v in d.items()})

    return Options(dataroot=root, load_size=cfg["load_size"],
                   load_size_big=cfg["load_size"],
                   load_size_local=cfg["load_size_local"],
                   num_sample_inout=cfg["num_sample_inout"],
                   sigma=cfg["sigma"], batch_size=cfg["batch_size"],
                   optimizer=cfg["optimizer"],
                   learning_rate=cfg["learning_rate"], seed=seed,
                   netG=level(cfg["netG"]), netMR=level(cfg["netMR"]))


def seeded_weights(model, seed: int, device) -> None:
    """Every conv, transposed-conv and dense weight N(0, 0.02) from one
    draw of a card generator seeded by ``seed``; biases 0, norm scales 1
    (as the constructors leave them)."""
    import torch

    ws = [p for n, p in model.named_parameters()
          if n.endswith("weight") and p.ndim >= 2]
    g = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    flat = torch.empty(sum(w.numel() for w in ws), device=device)
    flat.normal_(0.0, 0.02, generator=g)
    with torch.no_grad():
        off = 0
        for w in ws:
            w.copy_(flat[off:off + w.numel()].view_as(w))
            off += w.numel()


def run(ctx) -> dict:
    import torch

    from rgbd_pifuhd_tpu_torch.data.datasets import TrainDataset
    from rgbd_pifuhd_tpu_torch.models.coarse import CoarsePIFu
    from rgbd_pifuhd_tpu_torch.tools.train_bench_flagship import \
        _memoize_imread
    from rgbd_pifuhd_tpu_torch.train import loop as L
    from rgbd_pifuhd_tpu_torch.train.trainers import (make_coarse_train_step,
                                                      make_optimizer)

    cfg, traffic, tracer = ctx["config"], ctx["traffic"], ctx["tracer"]
    seed = ctx["seed"]
    dev = torch.device(ctx["device"])
    rng = np.random.default_rng(seed)
    tree = os.path.join(ctx["workdir"], "tree")
    tspec = traffic["tree"]
    subjects = []
    for kind, n in tspec["subjects"]:
        for i in range(n):
            subjects.append((f"{kind}_{i}", kind,
                             float(rng.choice(tspec["yaws"]))))
    pixels = S.write_tree(tree, subjects, tspec["size"],
                          tspec["images_per_subject"], rng)

    # ---- the program: dataset, model, optimiser, step
    opt = _opts(cfg, traffic, tree, seed)
    # the recipes' reader, every image decoded once, here at set-up (on an
    # H100 the decoding reader's steps spread 17-22 % from run to run)
    imread = _memoize_imread()
    for d, _, files in sorted(os.walk(tree)):
        for f in sorted(files):
            if f.endswith(".png"):
                imread(os.path.join(d, f))
    dataset = TrainDataset(opt, seed=opt.seed, imread=imread)
    model = CoarsePIFu(opt.netG, device=dev)
    dataset[0]          # the loop's init item, drawn before the first batch
    seeded_weights(model, seed, dev)
    gamma = opt.gamma if opt.gamma < 1 else 0.5
    tx = make_optimizer(opt.optimizer, opt.learning_rate, model.parameters())
    step_fn = make_coarse_train_step(model, tx, gamma=gamma)
    collate = L.collate_coarse

    def batches():
        epoch = 0
        while True:
            yield from L._batches(dataset, opt.batch_size, collate,
                                  opt.seed + epoch)
            epoch += 1

    feed = batches()
    waits: list = []

    def step():
        t0 = time.perf_counter()
        with tracer.span("pb.data"):
            batch = next(feed)
        waits.append(time.perf_counter() - t0)
        with tracer.span("pb.step"):
            m = step_fn(L._to_device(batch, dev))
            loss = float(m["loss"])
        return batch, loss

    # ---- the first steps: warm-up and the check's readings
    names = [n for n, _ in model.named_parameters()]
    p0 = {n: p.detach().to("cpu", copy=True)
          for n, p in model.named_parameters()}
    kept, losses = [], []
    grad_norms = change_norms = None
    for i in range(traffic["check_steps"]):
        batch, loss = step()
        kept.append({k: v.clone() for k, v in batch.items()})
        losses.append(loss)
        if i == 0:
            grad_norms = _grad_norms_from_state(tx, model)
    with torch.no_grad():
        change_norms = {n: float((p.detach().cpu() - p0[n]).norm())
                        for n, p in model.named_parameters()}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    del waits[:]

    # ---- the window
    tracer.start()
    t_w = tracer.t0
    n = 0
    with tracer.span("pb.window"):
        while time.perf_counter() - t_w < ctx["seconds"]:
            step()
            n += 1
    trace = tracer.stop()
    t_end = tracer.t1
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    del step_fn, tx, model, feed
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    from portbench.reference import check_train as CT

    numbers, step_flops = CT.check(
        cfg, p0, names, kept, losses, grad_norms,
        change_norms, pixels, gamma, dev, control=ctx.get("control", False),
        count_flops=tracer.on)
    return {"t_window": t_w, "attempted": n, "failed": 0,
            "e2e": {"train_step_ms": 1e3 * (t_end - t_w) / max(n, 1)},
            "numbers": numbers, "memory_peak_bytes": peak, "trace": trace,
            "window_s": t_end - t_w,
            "data": {"data_wait_s": list(waits), "units": n,
                     "step_flops": step_flops}}


def _grad_norms_from_state(tx, model) -> dict:
    """Per-leaf norm of the first gradient as the optimiser got it: after
    one RMSprop step from zero, ``nu = (1 - decay) g^2``."""
    out = {}
    for g in tx.param_groups:
        decay = g["decay"]
        for p in g["params"]:
            st = tx.state.get(p, {})
            if "nu" in st:
                out[id(p)] = float((st["nu"].sum() / (1.0 - decay)).sqrt())
    return {n: out.get(id(p), 0.0) for n, p in model.named_parameters()}
