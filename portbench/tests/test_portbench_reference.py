"""The plain reference against the program on the CPU at tiny widths: the
same weights give the same encoders, field, objective and gradients; the
frozen checkpoint reader gives the program's parameters; the training
labels and the reader's tensors are worked out again exactly."""

import os

import numpy as np
import pytest
import torch

from portbench.gen import subjects as S
from portbench.reference import check_mesh as CM
from portbench.reference import checkpoint as CK
from portbench.reference import model as M

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

G = dict(num_stack=2, hg_depth=1, hg_dim=32, norm="group",
         hg_down="ave_pool", mlp_dim=[33, 64, 32, 1], mlp_res_layers=[1],
         mlp_norm="group", merge_layer=1, use_rgb=True, use_depth=True,
         use_front_normal=True, use_back_normal=True, nml_ngf=4,
         nml_n_downsampling=2, nml_n_blocks=1, load_size=1024, z_size=200.0,
         projection_mode="orthogonal", compute_dtype="float32")
L = dict(G, num_stack=1, hg_dim=8, mlp_dim=[40, 64, 32, 1], merge_layer=-1,
         use_front_normal=False, use_back_normal=False)


def _level(d):
    from rgbd_pifuhd_tpu_torch.utils.options import PIFuLevelConfig

    return PIFuLevelConfig(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in d.items()})


@pytest.fixture(scope="module")
def pair():
    from rgbd_pifuhd_tpu_torch.models.blocks import init_flax
    from rgbd_pifuhd_tpu_torch.models.multires import MultiResPIFu

    torch.manual_seed(0)
    prog = MultiResPIFu(_level(L), _level(G), device="cpu")
    init_flax(prog, torch.Generator().manual_seed(3))
    with torch.no_grad():       # non-trivial norms and biases
        for n, p in prog.named_parameters():
            if p.ndim == 1:
                p.add_(torch.randn(p.shape) * 0.1)
    ref = M.MultiRes(L, G)
    ref.load_state_dict(prog.state_dict(), strict=True)
    return prog.eval(), ref.eval()


def _inputs(size=256, seed=0):
    g = torch.Generator().manual_seed(seed)
    img = torch.rand(1, size, size, 6, generator=g) * 2 - 1
    img_g = torch.rand(1, size // 2, size // 2, 6, generator=g) * 2 - 1
    pts = (torch.rand(1, 2048, 3, generator=g) * 2 - 1) * 0.9
    calib = torch.diag(torch.tensor([1.0, -1.0, 1.0, 1.0]))[None]
    return img, img_g, pts, calib


def test_encoders_and_field(pair):
    from rgbd_pifuhd_tpu_torch.models.coarse import query_plain

    prog, ref = pair
    img, img_g, pts, calib = _inputs()
    with torch.no_grad():
        g = prog.filter_global(img_g, last_only=True)
        lf = prog.filter_local(img[None], g, last_only=True)
        rl, rg = ref.encode(img, img_g)
        assert torch.allclose(g.im_feats[-1], rg, atol=2e-4)
        assert torch.allclose(lf.im_feats[-1], rl, atol=2e-4)
        # the program's torch modules (the kernels' plain route)
        xyz = pts @ calib[0, :3, :3].T
        z = xyz[..., 2:3] * 512 / 200.0
        cp, phi = query_plain(prog.netG.mlp, g.im_feats[-1], xyz[..., :2], z)
        fp, _ = query_plain(prog.mlp, lf.im_feats[-1], xyz[..., :2], phi)
        fr, mask = ref.fine(rl, rg, pts, calib)
    assert torch.allclose(fp[..., 0], fr, atol=1e-4)


def test_coarse_objective_and_gradients(pair):
    from rgbd_pifuhd_tpu_torch.models.coarse import CoarsePIFu

    _, ref = pair
    prog = CoarsePIFu(_level(G), device="cpu")
    prog.load_state_dict(ref.netG.state_dict(), strict=True)
    img, img_g, pts, calib = _inputs(seed=1)
    labels = (torch.rand(1, 2048, 1, generator=torch.Generator()
                         .manual_seed(2)) > 0.5).float()
    with torch.backends.mkldnn.flags(enabled=False):
        err, _ = prog(img_g, pts, calib, labels, 0.1, train=True)
        err.backward()
        loss = ref.netG.loss(img_g, pts, calib, labels, 0.1)
        loss.backward()
    assert abs(float(err.detach()) - float(loss.detach())) < 1e-5 * abs(float(loss))
    rp = dict(ref.netG.named_parameters())
    med = float(np.median([float(p.grad.norm()) for p in rp.values()
                           if p.grad is not None]))
    for n, p in prog.named_parameters():
        if p.grad is None:
            assert rp[n].grad is None, n
            continue
        if float(rp[n].grad.norm()) < 1e-3 * med:
            continue    # nought to rounding: a bias before a GroupNorm
        # float32 rounding through the whole depth (the stem's gradient
        # crosses every GroupNorm of both formulas): 1e-3 of the norm
        a, b = float(p.grad.norm()), float(rp[n].grad.norm())
        assert abs(a - b) <= 1e-3 * b + 1e-12, n
        assert float((p.grad - rp[n].grad).norm()) <= 1e-2 * b + 1e-12, n
    ref.netG.zero_grad(set_to_none=True)


def test_checkpoint_reader():
    from rgbd_pifuhd_tpu_torch.utils import checkpoint as P

    path = os.path.join(ROOT, "assets", "bench_flagship_lite", "ckpt")
    mine = CK.state_dict_from_flax(CK.load_flax(path)["params"])
    theirs = P.params_from_flax(P.load_checkpoint(path, "cpu")["params"])
    assert set(mine) == set(theirs)
    for k, v in theirs.items():
        assert torch.equal(mine[k], v), k


def test_reader_tensors():
    from rgbd_pifuhd_tpu_torch.data.readdata import InferenceDataset

    import tempfile
    rgb, dep = S.subject_pixels("capsule", 1024, np.random.default_rng(5))
    with tempfile.TemporaryDirectory() as d:
        S.write_subject(d, "c", rgb, dep)
        item = InferenceDataset(d, 1024)[0]
    img, img_g, calib = CM.reader_tensors(rgb, dep, "cpu")
    assert torch.equal(torch.from_numpy(item["img"]), img)
    assert torch.equal(torch.from_numpy(item["img_512"]), img_g)
    assert torch.equal(torch.from_numpy(item["calib"]), calib[0])


def test_labels_against_the_program():
    from portbench.reference.check_train import winding_inside
    from rgbd_pifuhd_tpu_torch.data.containment import MeshContainmentTester

    rng = np.random.default_rng(7)
    for kind in ("sphere", "capsule"):
        v, f = S.body_mesh(kind)
        pts = S.SUBJECT_CENTER + rng.normal(0, 60, (3000, 3))
        want = np.asarray(MeshContainmentTester(v, f).contains(pts)).reshape(-1)
        got = winding_inside(torch.from_numpy(pts), torch.from_numpy(v),
                             torch.from_numpy(f)).numpy()
        assert (got == want.astype(bool)).all()


def test_control_is_lower_precision(pair):
    _, ref = pair
    img, img_g, pts, calib = _inputs(seed=4)
    with torch.no_grad():
        a = ref.fine(*ref.encode(img, img_g), pts, calib)[0]
        with M.precision("control"):
            b = ref.fine(*ref.encode(img, img_g), pts, calib)[0]
    gap = float((a - b).abs().max())
    assert 1e-4 < gap < 0.5


def test_widened_normal_nets_keep_the_normals(tmp_path):
    """A checkpoint's normal nets embedded at twice their ngf give the same
    normals, in the program (through its own reader, widened) and in the
    reference (through the frozen reader, widened)."""
    from portbench import weights as W
    from portbench.tests import tiny
    from rgbd_pifuhd_tpu_torch.cli import common
    from rgbd_pifuhd_tpu_torch.models.multires import MultiResPIFu
    from rgbd_pifuhd_tpu_torch.utils import checkpoint as P

    path = str(tmp_path / "ckpt")
    tiny.checkpoint(path, seed=2)
    narrow = P.load_checkpoint(path, "cpu")
    ngf = 2 * narrow["opt"]["netG"]["nml_ngf"]
    with W.widened_loader(common.ckpt, ngf):
        wide = common.ckpt.load_checkpoint(path, "cpu")
    assert P.load_checkpoint is common.ckpt.load_checkpoint
    img = _inputs(size=64, seed=6)[0]

    def normals(payload):
        o = payload["opt"]
        m = MultiResPIFu(_level(o["netMR"]), _level(o["netG"]), device="cpu")
        m.load_state_dict(P.params_from_flax(payload["params"]), strict=True)
        with torch.no_grad():
            return [getattr(m.netG, k)(img) for k in W.NORMAL_NETS]

    a, b = normals(narrow), normals(wide)
    assert wide["opt"]["netG"]["nml_ngf"] == ngf
    for x, y in zip(a, b):
        assert float((x - y).abs().max()) < 1e-5

    ref = CM.load_model(W.widen_normal_nets(CK.load_flax(path), ngf), "cpu")
    assert ref.netG.netF.stem.weight.shape[0] == ngf
    with torch.no_grad():
        c = [getattr(ref.netG, k)(img) for k in W.NORMAL_NETS]
    for x, y in zip(a, c):
        assert float((x - y).abs().max()) < 1e-4
