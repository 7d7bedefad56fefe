"""The coarse train step replayed as a CUDA graph against the same step run
eagerly, on the card (marked ``card``; each test skips without one):

    python -m pytest tests/test_torch_train_graph.py -m card -s

- Graphed against eager from the same weights on the same batches: six
  steps at tiny widths (bf16, the normal nets on, a norm-free MLP) with a
  schedule that drops the rate tenfold at the fifth step, three steps at
  the flagship's widths (bf16 hourglasses and GroupNorm MLP, 4,096
  points, 512^2 images).  The card's training is not bit-deterministic
  (atomic adds in the gathers' and convolutions' backward), so the
  tolerance is measured in the test: ``EAGER_RUNS`` eager runs from the
  same weights give the gaps that non-determinism alone makes, the
  largest between any two of them (over the steps for the loss, over the
  leaves for the parameters' change, and the median leaf's), and the
  graphed run may differ from the first eager one by at most
  ``SPREAD_TIMES`` that, plus ``FLOOR`` (float32 rounding) of the value.
  Each leaf's gap is taken against the larger of its own change and the
  median leaf's, as the benchmark's check takes it.  (One eager pair and
  four times its gap failed once in three card runs at the flagship's
  widths: a ratio of two such draws has a long tail.  Over four eager
  runs the graphed gaps read at most 1.26 times the widest pair's.)
- ``graph_stats``: two eager steps, one capture, the rest replays; the
  optimiser's ``count`` once a batch; the rate follows the schedule.
- A batch of another point count between replays runs eagerly, and the
  replays after it stay equal to the eager steps.
- 50 replays allocate nothing that stays.
- Adam, and a model on the CPU, run every step eagerly.
"""

import dataclasses
import gc

import pytest
import torch

from rgbd_pifuhd_tpu_torch.models.coarse import CoarsePIFu
from rgbd_pifuhd_tpu_torch.tools.train_bench_flagship import flagship_configs
from rgbd_pifuhd_tpu_torch.tools.train_bench_tiny import tiny_coarse_cfg
from rgbd_pifuhd_tpu_torch.train import trainers as ttr

pytestmark = pytest.mark.card

EAGER_RUNS = 6
SPREAD_TIMES = 2.0
FLOOR = 1e-6


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step is captured on the card")
    return torch.device("cuda")


def _cfg(widths):
    if widths == "flagship":
        return dataclasses.replace(flagship_configs()[0],
                                   compute_dtype="bfloat16")
    return dataclasses.replace(
        tiny_coarse_cfg(), use_front_normal=True, use_back_normal=True,
        nml_ngf=8, nml_n_downsampling=2, nml_n_blocks=1,
        compute_dtype="bfloat16")


def _batches(cfg, n, points, size, dev, seed=0):
    """Random RGB-D images, points in the box, a sphere's labels."""
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for _ in range(n):
        pts = torch.rand(1, points, 3, device=dev, generator=g) * 2 - 1
        img = torch.rand(1, size, size, cfg.normal_input_channels,
                         device=dev, generator=g) * 2 - 1
        out.append({"images": img, "points": pts,
                    "calibs": torch.eye(4, device=dev)[None],
                    "labels": (pts.norm(dim=-1, keepdim=True)
                               < 0.6).float()})
    return out


class _Model:
    """One model on the card and its initial parameters, reset per run."""

    def __init__(self, cfg, dev):
        self.m = CoarsePIFu(cfg, device=dev)
        self.p0 = [p.detach().clone() for p in self.m.parameters()]

    def run(self, batches, sched, graphed):
        """Losses, final parameters, the step object's stats and the
        optimiser."""
        with torch.no_grad():
            for p, q in zip(self.m.parameters(), self.p0):
                p.copy_(q)
        opt = ttr.make_optimizer("rmsprop", sched, self.m.parameters())
        step = ttr.make_coarse_train_step(self.m, opt, gamma=0.5)
        fn = step if graphed else step.eager
        losses = [float(fn(b)["loss"]) for b in batches]
        params = [p.detach().clone() for p in self.m.parameters()]
        stats = dict(step.graph_stats)
        del step, fn
        gc.collect()
        torch.cuda.empty_cache()
        return losses, params, stats, opt


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def _gaps(run, ref, p0):
    """Per-step loss gaps and per-leaf parameter gaps of ``run`` from
    ``ref`` (each against the larger of the leaf's and the median leaf's
    change in ``ref``)."""
    changes = [float((r - q).norm()) for r, q in zip(ref[1], p0)]
    med = _median(changes)
    loss = [abs(a - b) for a, b in zip(run[0], ref[0])]
    leaf = [float((a - r).norm()) / max(c, med, 1e-30)
            for a, r, c in zip(run[1], ref[1], changes)]
    return loss, leaf


def _check_close(graphed, eagers, p0, label):
    pairs = [_gaps(b, a, p0) for i, a in enumerate(eagers)
             for b in eagers[i + 1:]]
    e_loss = max(max(loss) for loss, _ in pairs)
    e_leaf = max(max(leaf) for _, leaf in pairs)
    e_med = max(_median(leaf) for _, leaf in pairs)
    loss_g, leaf_g = _gaps(graphed, eagers[0], p0)
    print(f"[{label}] eager pairs: loss gaps by step "
          f"{[[f'{g:.2e}' for g in loss] for loss, _ in pairs]}, worst "
          f"leaf {e_leaf:.3g}, median leaf {e_med:.3g}; graphed: loss gaps "
          f"{[f'{g:.2e}' for g in loss_g]}, worst leaf {max(leaf_g):.3g}, "
          f"median leaf {_median(leaf_g):.3g}")
    for k, (g, ref) in enumerate(zip(loss_g, eagers[0][0])):
        assert g <= SPREAD_TIMES * e_loss + FLOOR * abs(ref), (label, k, g)
    assert max(leaf_g) <= SPREAD_TIMES * e_leaf + FLOOR, (label, e_leaf)
    assert _median(leaf_g) <= SPREAD_TIMES * e_med + FLOOR, (label, e_med)


@pytest.mark.parametrize("widths,steps,points,size", [
    ("tiny", 6, 512, 128), ("flagship", 3, 4096, 512)])
def test_graphed_step_matches_eager(card, widths, steps, points, size):
    cfg = _cfg(widths)
    model = _Model(cfg, card)
    batches = _batches(cfg, steps, points, size, card)
    # tenfold lower from the fifth step on (after the capture, at tiny
    # widths: the replays must read the new rate)
    sched = ttr.make_lr_schedule(1e-3, (2,), 0.1, 2)
    eagers = [model.run(batches, sched, graphed=False)
              for _ in range(EAGER_RUNS)]
    graphed = model.run(batches, sched, graphed=True)
    assert graphed[2] == {"eager": 2, "captures": 1, "replays": steps - 2}
    opt = graphed[3]
    assert opt.count == steps
    assert float(opt.neg_rate) == -sched(steps - 1)
    _check_close(graphed, eagers, model.p0, widths)
    frozen = [p.grad is None for n, p in model.m.named_parameters()
              if n.startswith(("netF.", "netB."))]
    assert frozen and all(frozen)


def test_other_point_count_runs_eagerly_between_replays(card):
    cfg = _cfg("tiny")
    model = _Model(cfg, card)
    full = _batches(cfg, 6, 512, 128, card)
    short = _batches(cfg, 1, 256, 128, card, seed=1)[0]
    batches = full[:4] + [short] + full[4:]
    sched = ttr.make_lr_schedule(1e-3, (), 0.1, 2)
    eagers = [model.run(batches, sched, graphed=False)
              for _ in range(EAGER_RUNS)]
    graphed = model.run(batches, sched, graphed=True)
    assert graphed[2] == {"eager": 3, "captures": 1, "replays": 4}
    assert graphed[3].count == 7
    _check_close(graphed, eagers, model.p0, "other shape")


def test_replays_allocate_nothing_that_stays(card):
    cfg = _cfg("tiny")
    m = CoarsePIFu(cfg, device=card)
    opt = ttr.make_optimizer("rmsprop", 1e-4, m.parameters())
    step = ttr.make_coarse_train_step(m, opt, gamma=0.5)
    b = _batches(cfg, 1, 512, 128, card)[0]
    for _ in range(4):
        step(b)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(card)
    reserved = torch.cuda.memory_reserved(card)
    for _ in range(50):
        loss = step(b)["loss"]
        del loss
    torch.cuda.synchronize()
    assert step.graph_stats == {"eager": 2, "captures": 1, "replays": 52}
    assert torch.cuda.memory_allocated(card) == base
    assert torch.cuda.memory_reserved(card) == reserved


@pytest.mark.parametrize("where", ["adam", "cpu"])
def test_adam_and_cpu_models_run_eagerly(card, where):
    cfg = _cfg("tiny")
    dev = torch.device("cpu") if where == "cpu" else card
    m = CoarsePIFu(cfg, device=dev)
    opt = ttr.make_optimizer("adam" if where == "adam" else "rmsprop", 1e-4,
                             m.parameters())
    step = ttr.make_coarse_train_step(m, opt, gamma=0.5)
    for b in _batches(cfg, 4, 256, 64, card):
        step({k: v.to(dev) for k, v in b.items()})
    assert step.graph_stats == {"eager": 4, "captures": 0, "replays": 0}
    assert opt.count == 4
