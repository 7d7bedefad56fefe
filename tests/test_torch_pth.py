"""Reference ``.pth`` checkpoints in the port (``utils/torch_import.py``),
against the JAX package's import of the same file.

The mirrors below register their submodules under the reference's module
names (``add_module('m{}')``, ``bn_end{}``, flat hourglass levels
``b1_{L}``, ``filters`` / ``norms`` ModuleLists, one ``model`` Sequential
for the normal nets), so their ``state_dict()`` keys are those a reference
training run saves.  A checkpoint is written with ``torch.save`` in the
test, read by both packages, and must give the same options and the same
query output (atol 1e-5, f32); ``cli.run_recon --device cpu`` meshes it.
"""

import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from rgbd_pifuhd_tpu.models import MultiResPIFu as JMultiResPIFu
from rgbd_pifuhd_tpu.utils import checkpoint as jck
from rgbd_pifuhd_tpu.utils import torch_import as jti
from rgbd_pifuhd_tpu.utils.options import Options as JOptions
from rgbd_pifuhd_tpu.utils.options import PIFuLevelConfig as JCfg
from rgbd_pifuhd_tpu_torch.models import MultiResPIFu
from rgbd_pifuhd_tpu_torch.utils import checkpoint as tck
from rgbd_pifuhd_tpu_torch.utils import torch_import as tti
from rgbd_pifuhd_tpu_torch.utils.options import Options, PIFuLevelConfig


# ------------------------------------------------- reference-named mirrors
def _norm2d(norm, ch):
    return tnn.GroupNorm(32, ch) if norm == "group" else tnn.BatchNorm2d(ch)


class RefConvBlock(tnn.Module):
    def __init__(self, cin, cout, norm="group"):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, cout // 2, 3, padding=1, bias=False)
        self.conv2 = tnn.Conv2d(cout // 2, cout // 4, 3, padding=1,
                                bias=False)
        self.conv3 = tnn.Conv2d(cout // 4, cout // 4, 3, padding=1,
                                bias=False)
        self.bn1 = _norm2d(norm, cin)
        self.bn2 = _norm2d(norm, cout // 2)
        self.bn3 = _norm2d(norm, cout // 4)
        if cin != cout:
            self.bn4 = _norm2d(norm, cin)
            self.downsample = tnn.Sequential(
                self.bn4, tnn.ReLU(True), tnn.Conv2d(cin, cout, 1,
                                                     bias=False))


class RefHourGlass(tnn.Module):
    def __init__(self, depth, feats, norm="group"):
        super().__init__()
        self._gen(depth, feats, norm)

    def _gen(self, level, feats, norm):
        self.add_module(f"b1_{level}", RefConvBlock(feats, feats, norm))
        self.add_module(f"b2_{level}", RefConvBlock(feats, feats, norm))
        if level > 1:
            self._gen(level - 1, feats, norm)
        else:
            self.add_module(f"b2_plus_{level}",
                            RefConvBlock(feats, feats, norm))
        self.add_module(f"b3_{level}", RefConvBlock(feats, feats, norm))


class RefFilter(tnn.Module):
    def __init__(self, n_stack, depth, cin, last_ch, norm="group"):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, 64, 7, stride=2, padding=3)
        self.bn1 = _norm2d(norm, 64)
        self.conv2 = RefConvBlock(64, 128, norm)
        self.conv3 = RefConvBlock(128, 128, norm)
        self.conv4 = RefConvBlock(128, 256, norm)
        for i in range(n_stack):
            self.add_module(f"m{i}", RefHourGlass(depth, 256, norm))
            self.add_module(f"top_m_{i}", RefConvBlock(256, 256, norm))
            self.add_module(f"conv_last{i}", tnn.Conv2d(256, 256, 1))
            self.add_module(f"bn_end{i}", _norm2d(norm, 256))
            self.add_module(f"l{i}", tnn.Conv2d(256, last_ch, 1))
            if i < n_stack - 1:
                self.add_module(f"bl{i}", tnn.Conv2d(256, 256, 1))
                self.add_module(f"al{i}", tnn.Conv2d(last_ch, 256, 1))


class RefMLP(tnn.Module):
    def __init__(self, chans, res_layers, norm="group"):
        super().__init__()
        self.filters = tnn.ModuleList()
        self.norms = tnn.ModuleList()
        for i in range(len(chans) - 1):
            cin = chans[i] + (chans[0] if i in res_layers else 0)
            self.filters.append(tnn.Conv1d(cin, chans[i + 1], 1))
            if i != len(chans) - 2 and norm != "none":
                self.norms.append(tnn.GroupNorm(32, chans[i + 1])
                                  if norm == "group"
                                  else tnn.BatchNorm1d(chans[i + 1]))


def ref_global_generator(cin, cout, ngf, nd, nb):
    """The pix2pixHD ``model`` Sequential (instance norm: no parameters)."""
    def resblock(dim):
        m = tnn.Module()
        m.conv_block = tnn.Sequential(
            tnn.ReflectionPad2d(1), tnn.Conv2d(dim, dim, 3),
            tnn.InstanceNorm2d(dim), tnn.ReLU(True),
            tnn.ReflectionPad2d(1), tnn.Conv2d(dim, dim, 3),
            tnn.InstanceNorm2d(dim))
        return m

    layers = [tnn.ReflectionPad2d(3), tnn.Conv2d(cin, ngf, 7),
              tnn.InstanceNorm2d(ngf), tnn.ReLU(True)]
    for i in range(nd):
        mult = 2 ** i
        layers += [tnn.Conv2d(ngf * mult, ngf * mult * 2, 3, stride=2,
                              padding=1),
                   tnn.InstanceNorm2d(ngf * mult * 2), tnn.ReLU(True)]
    layers += [resblock(ngf * 2 ** nd) for _ in range(nb)]
    for i in range(nd):
        mult = 2 ** (nd - i)
        layers += [tnn.ConvTranspose2d(ngf * mult, ngf * mult // 2, 3,
                                       stride=2, padding=1,
                                       output_padding=1),
                   tnn.InstanceNorm2d(ngf * mult // 2), tnn.ReLU(True)]
    layers += [tnn.ReflectionPad2d(3), tnn.Conv2d(ngf, cout, 7), tnn.Tanh()]
    m = tnn.Module()
    m.model = tnn.Sequential(*layers)
    return m


def _state(norm, normals, seed=11):
    """A netMR state dict in the reference's names: fine level over a
    2-stack coarse level, torch's seeded default init, non-trivial batch
    statistics, last biases zeroed (a field that straddles 0.5)."""
    torch.manual_seed(seed)
    mods = {"image_filter": RefFilter(1, 1, 6, 4, norm),
            "mlp": RefMLP([36, 32, 32, 1], [1], norm),
            "netG.image_filter": RefFilter(2, 1, 6 + 6 * normals, 8, norm),
            "netG.mlp": RefMLP([9, 64, 32, 32, 1], [1], norm)}
    if normals:
        mods["netG.netF"] = ref_global_generator(3, 3, 8, 2, 1)
        mods["netG.netB"] = ref_global_generator(3, 3, 8, 2, 1)
    sd = {}
    g = torch.Generator().manual_seed(seed)
    for pre, mod in mods.items():
        with torch.no_grad():
            for name, buf in mod.named_buffers():
                if name.endswith("running_mean"):
                    buf.copy_(torch.randn(buf.shape, generator=g) * 0.3)
                elif name.endswith("running_var"):
                    buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
            if pre.endswith("mlp"):
                mod.filters[-1].bias.zero_()
        sd.update({f"{pre}.{k}": v for k, v in mod.state_dict().items()
                   if not k.endswith("num_batches_tracked")})
    return sd


def _write_pth(path, norm, normals=False):
    common = dict(hg_depth=1, norm=norm, hg_down="ave_pool", mlp_norm=norm,
                  loadSize=64, z_size=200.0, use_front_normal=normals,
                  use_back_normal=normals, name="torchexp")
    opt_l = argparse.Namespace(num_stack=1, hg_dim=4,
                               mlp_dim=[36, 32, 32, 1], mlp_res_layers=[1],
                               merge_layer=1, **common)
    opt_g = argparse.Namespace(num_stack=2, hg_dim=8,
                               mlp_dim=[9, 64, 32, 32, 1],
                               mlp_res_layers=[1], merge_layer=2, **common)
    torch.save({"opt": opt_l, "opt_netG": opt_g,
                "model_state_dict": _state(norm, normals)}, path)


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_pth_loads_to_jax_options_and_field(norm, tmp_path, rng):
    path = str(tmp_path / "netMR_latest")
    _write_pth(path, norm)
    jstate = jck.load_checkpoint(path)
    tstate = tck.load_checkpoint(path, device="cpu")
    assert tstate["torch_import"] and tstate["opt"] == jstate["opt"]
    assert tstate["opt_netG"] == jstate["opt_netG"]
    jopt = JOptions.from_dict(jstate["opt"])
    topt = Options.from_dict(tstate["opt"])
    assert topt.netMR.mlp_norm == topt.netG.norm == norm
    jm = JMultiResPIFu(cfg=jopt.netMR, cfg_global=jopt.netG)
    jvars = jti.reconcile_with_model(jstate["params"], jm)
    tm = MultiResPIFu(topt.netMR, topt.netG, device="cpu")
    tm.load_state_dict(tti.reconcile_with_model(
        tck.params_from_flax(tstate["params"]), tm))

    img_l = rng.standard_normal((1, 1, 64, 64, 6)).astype(np.float32)
    img_g = rng.standard_normal((1, 64, 64, 6)).astype(np.float32)
    pts = rng.uniform(-0.9, 0.9, (1, 1, 400, 3)).astype(np.float32)
    c = np.eye(4, dtype=np.float32)
    gf = jm.apply(jvars, jnp.asarray(img_g), last_only=True,
                  method=JMultiResPIFu.filter_global)
    lf = jm.apply(jvars, jnp.asarray(img_l), gf, last_only=True,
                  method=JMultiResPIFu.filter_local)
    ref = jm.apply(jvars, lf, gf, jnp.asarray(pts),
                   jnp.asarray(c)[None, None], jnp.asarray(c)[None],
                   method=JMultiResPIFu.query)
    tc = torch.from_numpy(c)
    with torch.no_grad():
        tgf = tm.filter_global(torch.from_numpy(img_g), last_only=True)
        tlf = tm.filter_local(torch.from_numpy(img_l), tgf, last_only=True)
        got = tm.query(tlf, tgf, torch.from_numpy(pts), tc[None, None],
                       tc[None])
    assert float(np.ptp(np.asarray(ref.preds))) > 1e-3   # not a flat field
    np.testing.assert_allclose(got.preds.numpy(), np.asarray(ref.preds),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.preds_low.numpy(),
                               np.asarray(ref.preds_low), rtol=0, atol=1e-5)


def test_pth_normal_nets_widen_to_six_channels(tmp_path, rng):
    """The reference's 3-channel netF / netB stems: zero-padded to the
    6-channel RGB-D input in both packages, the same normal maps and
    query output."""
    path = str(tmp_path / "netMR_latest")
    _write_pth(path, "group", normals=True)
    lvl = dict(hg_depth=1, norm="group", hg_down="ave_pool",
               mlp_norm="group", load_size=64, z_size=200.0, nml_ngf=8,
               nml_n_downsampling=2, nml_n_blocks=1)
    l = dict(lvl, num_stack=1, hg_dim=4, mlp_dim=(36, 32, 32, 1),
             mlp_res_layers=(1,), merge_layer=1, use_front_normal=False,
             use_back_normal=False)
    g = dict(lvl, num_stack=2, hg_dim=8, mlp_dim=(9, 64, 32, 32, 1),
             mlp_res_layers=(1,), merge_layer=2)
    jm = JMultiResPIFu(cfg=JCfg(**l), cfg_global=JCfg(**g))
    jvars = jti.reconcile_with_model(jck.load_checkpoint(path)["params"],
                                     jm)
    tm = MultiResPIFu(PIFuLevelConfig(**l), PIFuLevelConfig(**g),
                      device="cpu")
    sd = tck.params_from_flax(tck.load_checkpoint(path, "cpu")["params"])
    assert sd["netG.netF.stem.weight"].shape[1] == 3
    sd = tti.reconcile_with_model(sd, tm)
    assert sd["netG.netF.stem.weight"].shape[1] == 6
    assert not sd["netG.netF.stem.weight"][:, 3:].any()
    tm.load_state_dict(sd)
    img_g = rng.standard_normal((1, 64, 64, 6)).astype(np.float32)
    pts = rng.uniform(-0.9, 0.9, (1, 300, 3)).astype(np.float32)
    c = np.eye(4, dtype=np.float32)[None]
    from rgbd_pifuhd_tpu.models import CoarsePIFu as JCoarse

    gf = jm.apply(jvars, jnp.asarray(img_g), last_only=True,
                  method=JMultiResPIFu.filter_global)
    ref = JCoarse(jm.cfg_global).apply(
        {"params": jvars["params"]["netG"]}, gf, jnp.asarray(pts),
        jnp.asarray(c), method=JCoarse.query)
    with torch.no_grad():
        tgf = tm.filter_global(torch.from_numpy(img_g), last_only=True)
        got = tm.netG.query(tgf, torch.from_numpy(pts), torch.from_numpy(c))
    np.testing.assert_allclose(tgf.nml_front.numpy(),
                               np.asarray(gf.nml_front), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.preds.numpy(), np.asarray(ref.preds),
                               rtol=0, atol=1e-5)


def test_reconcile_rejects_other_mismatch():
    tm = MultiResPIFu(PIFuLevelConfig(
        num_stack=1, hg_depth=1, hg_dim=4, hg_down="no_down",
        mlp_dim=(36, 16, 1), mlp_res_layers=(), merge_layer=-1,
        use_front_normal=False, use_back_normal=False),
        PIFuLevelConfig(num_stack=1, hg_depth=1, hg_dim=8,
                        mlp_dim=(9, 64, 32, 1), mlp_res_layers=(),
                        merge_layer=1, use_front_normal=False,
                        use_back_normal=False), device="cpu")
    sd = dict(tm.state_dict())
    sd["mlp.dense0.weight"] = torch.zeros((16, 30))
    with pytest.raises(ValueError, match="shape mismatch"):
        tti.reconcile_with_model(sd, tm)


def test_is_torch_checkpoint(tmp_path):
    p = str(tmp_path / "x")
    with open(p, "wb") as f:
        f.write(b"\x84\xa6params")              # a msgpack map
    assert not tti.is_torch_checkpoint(p)
    torch.save({"a": torch.zeros(1)}, p)
    assert tti.is_torch_checkpoint(p)
    assert not tti.is_torch_checkpoint(str(tmp_path))


def test_run_recon_meshes_a_pth(tmp_path):
    """``cli.run_recon --device cpu`` on a ``.pth`` and a PNG subject."""
    from rgbd_pifuhd_tpu_torch.cli import run_recon
    from rgbd_pifuhd_tpu_torch.data.synthetic import capsule_subject
    from rgbd_pifuhd_tpu_torch.recon.mesh import load_obj
    from rgbd_pifuhd_tpu_torch.utils.png import write_png

    path = str(tmp_path / "netMR_latest")
    _write_pth(path, "group")
    root = tmp_path / "subjects"
    (root / "depth").mkdir(parents=True)
    rgbd, _, _, _ = capsule_subject(64)
    u8 = np.clip(np.rint((rgbd * 0.5 + 0.5) * 255), 0, 255).astype(np.uint8)
    write_png(str(root / "s.png"), u8[:, :, :3])
    write_png(str(root / "depth" / "depth_s.png"), u8[:, :, 3:])
    (root / "s_rect.txt").write_text("0 0 64 64\n")
    run_recon.main(["--dataroot", str(root), "--load_netMR_checkpoint_path",
                    path, "--results_path", str(tmp_path / "out"),
                    "--resolution", "32", "--loadSize", "64", "--device",
                    "cpu", "--name", "torchexp"])
    v, f, c = load_obj(str(tmp_path / "out" / "torchexp" / "recon" /
                           "result_s_32.obj"))
    assert len(v) > 0 and len(f) > 0 and np.isfinite(c).all()
