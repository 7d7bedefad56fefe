"""The port's train steps against the JAX package's, on the CPU, f32, from
the same JAX-initialised parameters and the same batch (items of a tree the
JAX package wrote).

- One fine step (``MultiResPIFu``) and one coarse step (``CoarsePIFu``), in
  two variants: GroupNorm everywhere with the normal nets on, and batch
  norm in the encoders and the MLPs.  Loss within 1e-5 relative.  The
  gradients: a tolerance per leaf derived from the data — four times the
  largest change of the JAX package's own gradient of that leaf when the
  input images move by one float32 ulp (the two packages round the same
  sums in other orders, and these gradients amplify rounding: some leaves
  move by several percent of their largest value under that one-ulp
  change) — 16 times it (measured: at most 12.2 times in the fine step,
  2.8 in the coarse step) — plus 1e-6 of the largest |gradient| of the
  whole tree (float32 rounding of sums of that size, for leaves whose spread
  is below it).  The frozen parameters (netG in the fine step, the
  normal nets) get no gradient (exactly zero in the JAX package).  The
  running statistics within 1e-5.
- The optimisers alone, fed identical gradients for three steps across two
  schedule boundaries: parameters within 1e-6 of optax's, ``rmsprop``
  (optax arithmetic, eps inside the root) and ``adam``
  (``torch.optim.Adam``).
- ``init_flax`` against flax's initialisers: the same tree of shapes;
  weights N(0, 0.02) (per-leaf mean and std within six standard errors of
  flax's), biases 0, scales 1, statistics 0 / 1.
- Checkpoints both ways: the JAX package's ``load_checkpoint`` reads what
  the port's ``save_checkpoint`` writes (the same bytes as its own writer
  for the same tree and options) and the port reads the JAX package's,
  with equal trees; ``reconcile_input_channels`` as the JAX package's.
- ``remat`` changes no gradient and updates the batch statistics once.
- ``filter_local`` with crop ``rects`` (windows cut out of the normal maps
  resized to the load size, starts clamped): features within 1e-4 of the
  JAX package's (deep conv stacks summed in other orders).
- The coarse step object on the CPU: every step eager (``graph_stats``),
  losses and parameters over three steps across a schedule boundary equal
  bit for bit to the plain forward, backward and optimiser step;
  ``shard_train_step`` takes its eager form; its routing, with the card's
  parts stubbed: two warm-ups, a capture, replays, and a batch of another
  point count eager in between (the card's own run of it:
  ``test_torch_train_graph.py``).
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rgbd_pifuhd_tpu.data.datasets import TrainDataset as JTrainDataset
from rgbd_pifuhd_tpu.data.synthetic import generate_synthetic_dataset
from rgbd_pifuhd_tpu.models import CoarsePIFu as JCoarse
from rgbd_pifuhd_tpu.models import MultiResPIFu as JMulti
from rgbd_pifuhd_tpu.train import trainers as jtr
from rgbd_pifuhd_tpu.train.loop import collate_coarse as jcollate_coarse
from rgbd_pifuhd_tpu.train.loop import collate_fine as jcollate_fine
from rgbd_pifuhd_tpu.utils import checkpoint as jckpt
from rgbd_pifuhd_tpu.utils import torch_import as jti
from rgbd_pifuhd_tpu.utils.options import Options as JOptions
from rgbd_pifuhd_tpu_torch.models import CoarsePIFu, MultiResPIFu
from rgbd_pifuhd_tpu_torch.models.blocks import init_flax
from rgbd_pifuhd_tpu_torch.train import trainers as ttr
from rgbd_pifuhd_tpu_torch.train.loop import collate_coarse, collate_fine
from rgbd_pifuhd_tpu_torch.utils import checkpoint as tckpt
from rgbd_pifuhd_tpu_torch.utils import torch_import as tti
from rgbd_pifuhd_tpu_torch.utils.options import Options as TOptions
from rgbd_pifuhd_tpu_torch.utils.options import PIFuLevelConfig
from tests.test_models_pifu import tiny_global, tiny_local

GRAD_ULPS = 16.0
GRAD_FLOOR = 1e-6


def _variant(kind):
    """(global, local) JAX configs of the variant."""
    if kind == "group":
        g = dataclasses.replace(tiny_global(use_normals=True),
                                mlp_dim=(9, 64, 32, 32, 1), mlp_norm="group",
                                load_size=128)
        loc = dataclasses.replace(tiny_local(), mlp_dim=(36, 32, 32, 1),
                                  mlp_norm="group", use_front_normal=True,
                                  use_back_normal=True, load_size=128)
    else:
        g = dataclasses.replace(tiny_global(), norm="batch",
                                mlp_norm="batch", load_size=128)
        loc = dataclasses.replace(tiny_local(), norm="batch",
                                  mlp_norm="batch", load_size=128)
    return g, loc


def _port_cfg(c):
    return PIFuLevelConfig(**dataclasses.asdict(c))


@pytest.fixture(scope="module")
def items(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree"))
    generate_synthetic_dataset(root, ("sphere", "capsule"), size=128,
                               load_size=128, seed=1)
    opt = JOptions(dataroot=root, load_size=128, load_size_big=128,
                   load_size_local=64, num_sample_inout=256, sigma=3.0)
    d = JTrainDataset(opt, seed=2)
    return [d[0], d[1]]


@pytest.fixture(scope="module")
def jax_vars():
    """JAX-initialised variables of each variant's two-level model (the
    coarse model's are its ``netG`` subtree), numpy leaves."""
    out = {}
    for kind in ("group", "batch"):
        g, loc = _variant(kind)
        jm = JMulti(cfg=loc, cfg_global=g)
        x = jnp.zeros((1, 1, 32, 32, 6))
        v = jax.jit(jm.init)(jax.random.PRNGKey(0), x, x[:, 0],
                             jnp.zeros((1, 1, 8, 3)), jnp.eye(4)[None, None],
                             jnp.eye(4)[None], jnp.zeros((1, 1, 8, 1)))
        out[kind] = jax.tree.map(np.asarray, v)
    return out


def _netG_vars(v):
    return {k: t["netG"] for k, t in v.items()}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _port_grads(model):
    """flax-layout tree of the gradients (None -> absent)."""
    saved = {n: p.detach().clone() for n, p in model.named_parameters()}
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(p.grad if p.grad is not None else torch.full_like(
                p, float("nan")))
    tree = tckpt.params_to_flax(model)["params"]
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(saved[n])
    return tree


def _ulp_noise(grad_fn, params, batch, keys, seed=0):
    """JAX's own gradient spread for these data: the largest change of each
    leaf's gradient when the input images move by one float32 ulp (two
    random +-2^-23 relative draws).  Numpy tree."""
    rng = np.random.default_rng(seed)
    g0 = jax.tree.map(np.asarray, grad_fn(params, batch))
    noise = jax.tree.map(np.zeros_like, g0)
    for _ in range(2):
        b = dict(batch)
        for k in keys:
            x = np.asarray(b[k])
            b[k] = jnp.asarray((x * (1 + rng.choice([-1.0, 1.0], x.shape)
                                     * 2.0 ** -23)).astype(np.float32))
        g1 = jax.tree.map(np.asarray, grad_fn(params, b))
        noise = jax.tree.map(lambda n, a, c: np.maximum(n, np.abs(a - c)),
                             noise, g1, g0)
    return noise


def _check_grads(tg, jg, noise, frozen):
    """Every leaf within ``GRAD_ULPS`` times JAX's own one-ulp spread of it
    (``_ulp_noise``), plus ``GRAD_FLOOR`` times the largest |gradient| of
    the whole tree (float32 rounding of sums of that size); frozen
    subtrees have no gradient in the port and an exact zero in the JAX
    package.  Returns the worst error / spread ratio."""
    tl, jl, nl = list(_leaves(tg)), list(_leaves(jg)), list(_leaves(noise))
    assert [p for p, _ in tl] == [p for p, _ in jl]
    top = max(float(np.abs(j).max()) for _, j in jl)
    worst = 0.0
    for (path, t), (_, j), (_, n) in zip(tl, jl, nl):
        if path[0] in frozen or (len(path) > 1 and path[1] in frozen):
            assert np.isnan(t).all() and not np.abs(j).any(), path
            continue
        err = float(np.abs(t - j).max())
        spread = float(n.max())
        tol = GRAD_ULPS * spread + GRAD_FLOOR * top
        if GRAD_ULPS * spread > GRAD_FLOOR * top:
            worst = max(worst, err / spread)
        assert err <= tol, (path, err, spread)
    print(f"worst gradient error / one-ulp spread: {worst:.3g}")
    return worst


def _check_stats(model, new_vars):
    if "batch_stats" not in new_vars:
        return
    got = tckpt.params_to_flax(model)["batch_stats"]
    want = jax.tree.map(np.asarray, new_vars["batch_stats"])
    for (path, t), (_, j) in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-5, err_msg=str(path))


@pytest.mark.parametrize("kind", ["group", "batch"])
def test_fine_step_matches_jax(items, jax_vars, kind):
    g, loc = _variant(kind)
    jm = JMulti(cfg=loc, cfg_global=g)
    jb = jcollate_fine(items)
    v = jax_vars[kind]
    has_bs = "batch_stats" in v

    def loss_fn(p, b):
        out = jm.apply({**v, "params": p}, b["images_local"],
                       b["images_global"], b["points"], b["calib_local"],
                       b["calib_global"], b["labels"], train=True,
                       mutable=["batch_stats"] if has_bs else False)
        (err, _), mut = out if has_bs else (out, {})
        return err["occ_fine"], mut

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (jloss, mut), jgrad = vg(v["params"], jb)
    noise = _ulp_noise(lambda p, b: vg(p, b)[1], v["params"], jb,
                       ("images_local", "images_global"))
    tm = MultiResPIFu(_port_cfg(loc), _port_cfg(g), device="cpu")
    tckpt.load_params(tm, v)
    tb = collate_fine(items)
    err, _ = tm(tb["images_local"], tb["images_global"], tb["points"],
                tb["calib_local"], tb["calib_global"], tb["labels"])
    err["occ_fine"].backward()
    loss = float(err["occ_fine"].detach())
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    _check_grads(_port_grads(tm), jax.tree.map(np.asarray, jgrad), noise,
                 frozen={"netG"})
    _check_stats(tm, {**v, **mut})


@pytest.mark.parametrize("kind", ["group", "batch"])
def test_coarse_step_matches_jax(items, jax_vars, kind):
    g, _ = _variant(kind)
    jm = JCoarse(g)
    jb = jcollate_coarse(items)
    v = _netG_vars(jax_vars[kind])
    has_bs = "batch_stats" in v

    def loss_fn(p, b):
        out = jm.apply({**v, "params": p}, b["images"], b["points"],
                       b["calibs"], b["labels"], 0.1, train=True,
                       mutable=["batch_stats"] if has_bs else False)
        (err, _), mut = out if has_bs else (out, {})
        return err, mut

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (jloss, mut), jgrad = vg(v["params"], jb)
    noise = _ulp_noise(lambda p, b: vg(p, b)[1], v["params"], jb,
                       ("images",))
    tm = CoarsePIFu(_port_cfg(g), device="cpu")
    tckpt.load_params(tm, v)
    tb = collate_coarse(items)
    err, _ = tm(tb["images"], tb["points"], tb["calibs"], tb["labels"], 0.1)
    err.backward()
    loss = float(err.detach())
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    _check_grads(_port_grads(tm), jax.tree.map(np.asarray, jgrad), noise,
                 frozen={"netF", "netB"})
    _check_stats(tm, {**v, **mut})


@pytest.mark.parametrize("kind", ["rmsprop", "adam"])
def test_optimizer_matches_optax(kind, rng):
    shapes = {"a": (5, 3), "b": (7,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** -e).astype(np.float32)
              for k, s in shapes.items()} for e in (1, 3, 2)]
    sched = jtr.make_lr_schedule(1e-2, (1, 2), 0.1, 1)
    tx = jtr.make_optimizer(kind, sched)
    jp = {k: jnp.asarray(x) for k, x in p0.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(x.copy()))
          for k, x in p0.items()}
    opt = ttr.make_optimizer(kind, ttr.make_lr_schedule(1e-2, (1, 2), 0.1,
                                                        1), tp.values())
    for step, gr in enumerate(grads):
        up, st = tx.update({k: jnp.asarray(x) for k, x in gr.items()}, st,
                           jp)
        jp = optax.apply_updates(jp, up)
        for k, p in tp.items():
            p.grad = torch.from_numpy(gr[k].copy())
        opt.step()
        assert ttr.make_lr_schedule(1e-2, (1, 2), 0.1, 1)(step) == float(
            sched(step))
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["group", "batch"])
def test_init_follows_flax_initialisers(jax_vars, kind):
    g, loc = _variant(kind)
    tm = MultiResPIFu(_port_cfg(loc), _port_cfg(g), device="cpu")
    init_flax(tm, torch.Generator().manual_seed(0))
    got = tckpt.params_to_flax(tm)
    jl = list(_leaves(jax_vars[kind]))
    tl = list(_leaves(got))
    assert [(p, a.shape) for p, a in jl] == [(p, a.shape) for p, a in tl]
    for (path, j), (_, t) in zip(jl, tl):
        if path[-1] == "kernel":
            se = 0.02 / np.sqrt(j.size)
            assert abs(t.mean()) <= 6 * se and abs(j.mean()) <= 6 * se, path
            if j.size >= 64:
                assert abs(t.std() - j.std()) <= 6 * se * 2, path
        else:
            assert np.array_equal(t, j), path   # biases 0, scales 1, stats


def test_checkpoints_cross_both_ways(tmp_path, jax_vars):
    g, loc = _variant("batch")
    tm = MultiResPIFu(_port_cfg(loc), _port_cfg(g), device="cpu")
    init_flax(tm, torch.Generator().manual_seed(4))
    tree = tckpt.params_to_flax(tm)
    opt = TOptions(netG=_port_cfg(g), netMR=_port_cfg(loc), name="x")
    jopt = JOptions(netG=g, netMR=loc, name="x")
    p_port, p_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    tckpt.save_checkpoint(p_port, tree, opt, epoch=3)
    jckpt.save_checkpoint(p_jax, tree, jopt, epoch=3)
    assert open(p_port, "rb").read() == open(p_jax, "rb").read()
    back = jckpt.load_checkpoint(p_port)
    assert back["epoch"] == 3 and back["opt"] == jopt.to_dict() | {
        "netG": back["opt"]["netG"], "netMR": back["opt"]["netMR"],
        "schedule": back["opt"]["schedule"],
        "mesh_shape": back["opt"]["mesh_shape"]}
    for (pa, a), (pb, b) in zip(_leaves(back["params"]), _leaves(tree)):
        assert pa == pb and np.array_equal(a, b)
    # the JAX package's checkpoint of JAX-initialised variables, read back
    v = jax_vars["batch"]
    jckpt.save_checkpoint(p_jax, v, jopt)
    t2 = MultiResPIFu(_port_cfg(loc), _port_cfg(g), device="cpu")
    tckpt.load_params(t2, tckpt.load_checkpoint(p_jax, "cpu")["params"])
    for (pa, a), (pb, b) in zip(_leaves(tckpt.params_to_flax(t2)),
                                _leaves(v)):
        assert pa == pb and np.array_equal(a, b)
    assert tckpt.latest_path("c", "n") == jckpt.latest_path("c", "n")
    assert tckpt.epoch_path("c", "n", 2) == jckpt.epoch_path("c", "n", 2)


def test_reconcile_input_channels_matches_jax(rng):
    tmpl = {"netF": {"stem": {"kernel": np.zeros((7, 7, 6, 8)),
                              "bias": np.zeros(8)}},
            "mlp": {"dense0": {"kernel": np.zeros((4, 2))}}}
    var = {"netF": {"stem": {"kernel": rng.standard_normal((7, 7, 3, 8)),
                             "bias": rng.standard_normal(8)}},
           "mlp": {"dense0": {"kernel": rng.standard_normal((4, 2))}}}
    a = jti.reconcile_input_channels(var, tmpl)
    b = tti.reconcile_input_channels(var, tmpl)
    for (pa, x), (pb, y) in zip(_leaves(a), _leaves(b)):
        assert pa == pb and np.array_equal(x, y)
    bad = {"mlp": {"dense0": {"kernel": np.zeros((5, 2))}}}
    with pytest.raises(ValueError, match="shape mismatch"):
        tti.reconcile_input_channels(bad, tmpl)


def test_remat_changes_no_gradient(items):
    g, _ = _variant("batch")
    tb = collate_coarse(items)
    grads, stats = [], []
    for remat in (False, True):
        m = CoarsePIFu(_port_cfg(dataclasses.replace(g, remat=remat)),
                       device="cpu")
        init_flax(m, torch.Generator().manual_seed(7))
        err, _ = m(tb["images"], tb["points"], tb["calibs"], tb["labels"],
                   0.1)
        err.backward()
        grads.append([p.grad.clone() for p in m.parameters()
                      if p.grad is not None])
        stats.append([b.clone() for b in m.buffers()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(*stats):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_filter_local_rects_matches_jax(jax_vars, rng):
    g, loc = _variant("group")
    v = jax_vars["group"]
    jm = JMulti(cfg=loc, cfg_global=g)
    img_g = rng.standard_normal((1, 64, 64, 6)).astype(np.float32)
    img_l = rng.standard_normal((1, 2, 32, 32, 6)).astype(np.float32)
    # the second window starts past the edge: clamped to 128 - 32
    rects = np.array([[[10, 40, 42, 72], [120, 100, 152, 132]]], np.int32)

    def run(variables, gi, li, r):
        gf = jm.apply(variables, gi, method=jm.filter_global)
        return jm.apply(variables, li, gf, r, method=jm.filter_local)

    jout = jax.jit(run)(v, img_g, img_l, rects)
    tm = MultiResPIFu(_port_cfg(loc), _port_cfg(g), device="cpu")
    tckpt.load_params(tm, v)
    with torch.no_grad():
        gf = tm.filter_global(torch.from_numpy(img_g))
        tout = tm.filter_local(torch.from_numpy(img_l), gf,
                               torch.from_numpy(rects))
    assert tout.im_feats.shape == jout.im_feats.shape
    np.testing.assert_allclose(tout.im_feats.numpy(),
                               np.asarray(jout.im_feats), rtol=0, atol=1e-4)


def _coarse_port(jax_vars, opt_kind):
    g, _ = _variant("group")
    m = CoarsePIFu(_port_cfg(g), device="cpu")
    tckpt.load_params(m, _netG_vars(jax_vars["group"]))
    # the rate drops tenfold from the third step on
    sched = ttr.make_lr_schedule(1e-3, (1,), 0.1, 2)
    return m, ttr.make_optimizer(opt_kind, sched, m.parameters())


@pytest.mark.parametrize("opt_kind", ["rmsprop", "adam"])
def test_coarse_step_on_cpu_is_the_plain_step(items, jax_vars, opt_kind):
    batches = [collate_coarse([items[i % 2]]) for i in range(3)]
    m, opt = _coarse_port(jax_vars, opt_kind)
    step = ttr.make_coarse_train_step(m, opt, gamma=0.1)
    assert step.model is m and step.optimizer is opt
    losses = [step(b)["loss"] for b in batches]
    assert step.graph_stats == {"eager": 3, "captures": 0, "replays": 0}
    assert opt.count == 3
    rm, ropt = _coarse_port(jax_vars, opt_kind)
    for b, loss in zip(batches, losses):
        ropt.zero_grad(set_to_none=True)
        err, _ = rm(b["images"], b["points"], b["calibs"], b["labels"], 0.1,
                    train=True)
        err.backward()
        ropt.step()
        assert torch.equal(loss, err.detach())
    for (n, p), (_, q) in zip(m.named_parameters(), rm.named_parameters()):
        assert torch.equal(p, q), n
        assert (p.grad is None) == (q.grad is None), n
        if n.startswith(("netF.", "netB.")):     # frozen: no gradient
            assert p.grad is None, n


def test_shard_train_step_takes_the_eager_step(items, jax_vars, monkeypatch):
    from rgbd_pifuhd_tpu_torch.parallel import distributed as D

    reduced = []

    def all_reduce_sum_(t, group=None):
        reduced.append(t.numel())
        return t

    monkeypatch.setattr(D, "broadcast_", lambda t, src=0, group=None: t)
    monkeypatch.setattr(D, "all_reduce_sum_", all_reduce_sum_)
    mesh = SimpleNamespace(local_devices=[torch.device("cpu")],
                           group=object(), world=1)
    m, opt = _coarse_port(jax_vars, "rmsprop")
    step = ttr.make_coarse_train_step(m, opt, gamma=0.1)
    out = ttr.shard_train_step(step, mesh)(collate_coarse([items[0]]))
    assert set(out) == {"loss"} and opt.count == 1
    # the graphed entry never ran; the hook averaged every gradient
    assert step.graph_stats == {"eager": 0, "captures": 0, "replays": 0}
    n_grad = sum(p.numel() for p in m.parameters() if p.grad is not None)
    assert reduced == [n_grad, 1]


def test_coarse_step_routes_other_point_counts_eagerly(items, jax_vars,
                                                       monkeypatch):
    m, opt = _coarse_port(jax_vars, "rmsprop")
    step = ttr.make_coarse_train_step(m, opt, gamma=0.1)
    routes = []

    def side(batch, dev):
        routes.append("warm")
        return step.eager(batch)

    def capture(batch):
        routes.append("capture")
        step._graph = "graph"
        step.graph_stats["captures"] += 1

    def replay(batch):
        routes.append("replay")
        step.graph_stats["replays"] += 1
        return step.eager(batch)

    monkeypatch.setattr(step, "_graphable", lambda dev, batch: True)
    monkeypatch.setattr(step, "_on_side_stream", side)
    monkeypatch.setattr(step, "_capture", capture)
    monkeypatch.setattr(step, "_replay", replay)
    full = collate_coarse([items[0]])
    half = {k: v[:, :128] if k in ("points", "labels") else v
            for k, v in full.items()}
    for b in (full, half, full, full, full, half, full):
        step(b)
    # a new signature before the capture restarts the warm-up
    assert routes == ["warm", "warm", "warm", "warm", "capture", "replay",
                      "replay"]
    assert step.graph_stats == {"eager": 5, "captures": 1, "replays": 2}
    assert opt.count == 7
