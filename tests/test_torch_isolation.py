"""The PyTorch port stands alone: it imports neither JAX, flax, optax,
msgpack, cv2 nor PIL, nor any module of the JAX package, and its entry
points never carry on quietly on the CPU.

Later port slices extend this file with their modules and entry points.
"""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "rgbd_pifuhd_tpu_torch")
BANNED = ("jax", "jaxlib", "flax", "optax", "msgpack", "cv2", "PIL",
          "rgbd_pifuhd_tpu", "bench", "__graft_entry__")
SERVING_MODULES = ("cli.common", "cli.run_recon", "cli.serve", "data.readdata",
           "data.preprocessing", "utils.png", "ops.fused_mlp")
# the rest of inference: JPEG subjects, reference .pth checkpoints, the
# two-level / dense evaluators and marchers, CoarseReconstructor
INFERENCE_MODULES = ("utils.jpeg", "utils.torch_import", "recon.grid",
                     "recon.marching", "recon.mesh", "recon.pipeline")
# training and its data: readers, the synthetic tree, losses, the loop
TRAINING_MODULES = ("train.trainers", "train.loop", "cli.run_train",
                    "data.datasets", "data.sampling", "data.containment",
                    "data.prefetch", "data.synthetic", "ops.losses",
                    "utils.imgproc", "utils.logging", "utils.checkpoint")
# the rest of training: the normal nets' zoo, perceptual losses, metrics
NORMALS_MODULES = ("models.pix2pix", "models.vgg", "models.perceptual",
                   "utils.metrics", "cli.plot_error")
# offline data generation: PRT rendering, compositing, GrabCut, the
# turntable video and their command lines
GEN_DATA_MODULES = ("data.render", "data.render_dataset", "data.composite",
                    "data.segmentation", "recon.turntable", "utils.avi",
                    "utils.imageio", "cli.gen_data", "cli.encode_objs",
                    "cli.debug_vis")
# multi-device runs and the last support modules: meshes, the sharded
# evaluator, the process group, flop counts, the backbone trainer
MULTI_DEVICE_MODULES = ("parallel", "parallel.mesh", "parallel.evaluator",
                        "parallel.distributed", "utils.flops",
                        "tools.train_perceptual_backbone")
# the checkpoint recipes and their supervision
RECIPE_MODULES = ("tools.train_bench_flagship", "tools.train_bench_tiny",
                  "utils.watchdog", "utils.retry")


def _banned(name: str) -> bool:
    # the port's own name starts with "rgbd_pifuhd_tpu": compare whole
    # dotted components, never a bare prefix
    return name.split(".")[0] in BANNED


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_nothing_banned(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            assert not _banned(n), f"{path} imports {n}"


def test_import_every_module_without_jax():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        for m in {BANNED!r}:
            sys.modules[m] = None
        sys.path.insert(0, {REPO!r})
        import rgbd_pifuhd_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for n in names:
            importlib.import_module(n)
        bad = [m for m in sys.modules
               if (m == "rgbd_pifuhd_tpu" or m.startswith("rgbd_pifuhd_tpu.")
                   or m.split(".")[0] in ("jax", "flax", "optax",
                                          "msgpack", "cv2", "PIL"))
               and sys.modules[m] is not None]
        assert not bad, bad
        assert len(names) >= 35, names
        for n in {SERVING_MODULES + INFERENCE_MODULES + TRAINING_MODULES
                  + NORMALS_MODULES + GEN_DATA_MODULES
                  + MULTI_DEVICE_MODULES + RECIPE_MODULES!r}:
            assert pkg.__name__ + "." + n in names, n
        print(len(names))
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=30)
    assert r.returncode == 0, r.stderr


def _tiny_cfgs():
    from rgbd_pifuhd_tpu_torch.utils.options import PIFuLevelConfig

    g = PIFuLevelConfig(num_stack=1, hg_depth=1, hg_dim=8, mlp_dim=(9, 32, 1),
                        mlp_res_layers=(), mlp_norm="none", merge_layer=1,
                        use_front_normal=False, use_back_normal=False)
    l = PIFuLevelConfig(num_stack=1, hg_depth=1, hg_dim=4,
                        hg_down="no_down", mlp_dim=(36, 16, 1),
                        mlp_res_layers=(), mlp_norm="none", merge_layer=-1,
                        use_front_normal=False, use_back_normal=False)
    return l, g


def test_entry_points_refuse_silent_cpu():
    """Without CUDA and without an explicit device='cpu', the model
    constructors, the checkpoint reader and the Reconstructor raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    from rgbd_pifuhd_tpu_torch.models import CoarsePIFu, MultiResPIFu
    from rgbd_pifuhd_tpu_torch.recon.pipeline import Reconstructor
    from rgbd_pifuhd_tpu_torch.utils.checkpoint import load_checkpoint
    from rgbd_pifuhd_tpu_torch.utils.options import Options

    l, g = _tiny_cfgs()
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiResPIFu(l, g)
    with pytest.raises(RuntimeError, match="CUDA"):
        CoarsePIFu(g)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_checkpoint(os.path.join(REPO, "assets", "bench_tiny", "ckpt"))
    model = MultiResPIFu(l, g, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Reconstructor(model, Options())
    with pytest.raises(RuntimeError, match="CUDA"):
        Reconstructor(model, Options(), device="cuda")
    Reconstructor(model, Options(), device="cpu")


def test_kernel_wrapper_has_no_cpu_fallback_for_cuda_tensors():
    """A CUDA tensor launches the kernel or raises; the plain version is
    taken only for CPU tensors (the launch counter stays 0 here)."""
    from rgbd_pifuhd_tpu_torch.ops import fused_query as fq

    src = open(fq.__file__).read()
    tree = ast.parse(src)
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "fused_gather_mlp")
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
    assert fq.fused_gather_mlp.launches == 0


@pytest.mark.parametrize("module,name", [("fused_mlp", "fused_point_mlp"),
                                         ("fused_query", "gather_concat")])
def test_serving_path_wrappers_have_no_cpu_fallback(module, name):
    """The whole-chain kernel's wrapper and the gather entry: no ``try``,
    the plain version only behind the ``device.type == "cpu"`` test, and
    the wrapper never calls the other kernel's wrapper."""
    import importlib

    mod = importlib.import_module(f"rgbd_pifuhd_tpu_torch.ops.{module}")
    tree = ast.parse(open(mod.__file__).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == name)
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
    called = {n.func.id for n in ast.walk(fn)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    assert "fused_gather_mlp" not in called
    assert "fused_gather_mlp_ref" not in called
    tests = [ast.unparse(n.test) for n in ast.walk(fn)
             if isinstance(n, ast.If)]
    assert any("device.type == 'cpu'" in t for t in tests), tests
    assert getattr(mod, name).launches == 0


def test_cli_entry_points_refuse_silent_cpu(tmp_path):
    """``cli.serve`` and ``cli.run_recon`` default to ``cuda`` and raise
    without a card; ``--device cpu`` is the only way onto the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    from rgbd_pifuhd_tpu_torch.cli import run_recon, serve

    ckpt = os.path.join(REPO, "assets", "bench_tiny", "ckpt")
    args = ["--load_netMR_checkpoint_path", ckpt, "--results_path",
            str(tmp_path), "--dataroot", str(tmp_path)]
    for main in (serve.main, run_recon.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(list(args))
        with pytest.raises(RuntimeError, match="CUDA"):
            main(args + ["--device", "cuda"])
    run_recon.main(args + ["--device", "cpu"])      # empty directory: no-op
    with pytest.raises(SystemExit, match="checkpoint not found"):
        serve.main(["--checkpoints_path", str(tmp_path), "--device", "cpu"])


def test_inference_paths_run_without_jax():
    """With JAX, flax, msgpack, cv2, PIL and the JAX package blocked: the
    grad and mesh normal modes, the two-level and dense evaluators and
    ``CoarseReconstructor`` mesh a tiny random model on the CPU, a JPEG
    subject is read, and a reference ``.pth`` is recognised."""
    code = textwrap.dedent(f"""
        import sys, tempfile, os
        for m in {BANNED!r}:
            sys.modules[m] = None
        sys.path.insert(0, {REPO!r})
        import dataclasses
        import numpy as np
        import torch
        from rgbd_pifuhd_tpu_torch.data.readdata import InferenceDataset
        from rgbd_pifuhd_tpu_torch.models import CoarsePIFu, MultiResPIFu
        from rgbd_pifuhd_tpu_torch.recon import (CoarseReconstructor,
                                                 Reconstructor)
        from rgbd_pifuhd_tpu_torch.utils.options import (Options,
                                                         PIFuLevelConfig)
        from rgbd_pifuhd_tpu_torch.utils.torch_import import (
            is_torch_checkpoint)
        torch.manual_seed(0)
        g = PIFuLevelConfig(num_stack=1, hg_depth=1, hg_dim=8,
                            mlp_dim=(9, 32, 32, 1), mlp_res_layers=(),
                            mlp_norm="none", merge_layer=1,
                            use_front_normal=False, use_back_normal=False,
                            load_size=64)
        l = PIFuLevelConfig(num_stack=1, hg_depth=1, hg_dim=4,
                            hg_down="no_down", mlp_dim=(36, 16, 1),
                            mlp_res_layers=(), mlp_norm="none",
                            merge_layer=-1, use_front_normal=False,
                            use_back_normal=False, load_size=64)
        data = InferenceDataset(os.path.join({REPO!r}, "tests", "data",
                                             "jpeg_subject"), 64)[0]
        assert data["img"].shape == (1, 64, 64, 6)
        tmp = tempfile.mkdtemp()
        m = MultiResPIFu(l, g, device="cpu")
        for kw in (dict(normal_mode="grad"), dict(normal_mode="mesh"),
                   dict(octree_levels=2), dict(use_octree=False)):
            r = Reconstructor(m, Options(resolution=16, **kw), device="cpu")
            try:
                r.gen_mesh(data, os.path.join(tmp, "m.obj"), resolution=16)
            except RuntimeError as e:        # a random field may be empty
                assert "empty mesh" in str(e), e
        r = CoarseReconstructor(CoarsePIFu(g, device="cpu"),
                                Options(resolution=16), device="cpu")
        try:
            r.gen_mesh(data, os.path.join(tmp, "c.obj"), resolution=16)
        except RuntimeError as e:
            assert "empty mesh" in str(e), e
        p = os.path.join(tmp, "x.pth")
        torch.save({{"model_state_dict": {{}}}}, p)
        assert is_torch_checkpoint(p)
        bad = [k for k in sys.modules
               if (k == "rgbd_pifuhd_tpu" or k.startswith("rgbd_pifuhd_tpu."))
               and sys.modules[k] is not None]
        assert not bad, bad
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr


def test_training_runs_without_jax(tmp_path):
    """With JAX, flax, optax, msgpack, cv2, PIL and the JAX package
    blocked: the port writes a training tree (JPEG encoder, raster.cc),
    reads it with the colour jitter and the crop on, takes two coarse
    steps and one fine step on the CPU, and writes and reads back a
    checkpoint."""
    code = textwrap.dedent(f"""
        import sys, os
        for m in {BANNED!r}:
            sys.modules[m] = None
        sys.path.insert(0, {REPO!r})
        os.chdir({str(tmp_path)!r})
        from rgbd_pifuhd_tpu_torch.data.synthetic import (
            generate_synthetic_dataset)
        from rgbd_pifuhd_tpu_torch.data.datasets import TrainDataset
        from rgbd_pifuhd_tpu_torch.train.loop import (pretrain_coarse,
                                                      train_fine)
        from rgbd_pifuhd_tpu_torch.utils import checkpoint as ck
        from rgbd_pifuhd_tpu_torch.utils.options import (Options,
                                                         PIFuLevelConfig)
        generate_synthetic_dataset("tree", ("sphere", "bumpy"), size=64,
                                   load_size=64)
        g = PIFuLevelConfig(num_stack=1, hg_depth=1, hg_dim=8,
                            mlp_dim=(9, 32, 16, 1), mlp_res_layers=(),
                            mlp_norm="none", merge_layer=1,
                            use_front_normal=False, use_back_normal=False,
                            load_size=64)
        l = PIFuLevelConfig(num_stack=1, hg_depth=1, hg_dim=4,
                            hg_down="no_down", mlp_dim=(20, 16, 1),
                            mlp_res_layers=(), mlp_norm="none",
                            merge_layer=-1, use_front_normal=False,
                            use_back_normal=False, load_size=64)
        opt = Options(dataroot="tree", load_size=64, load_size_big=64,
                      load_size_local=32, num_sample_inout=64, sigma=3.0,
                      netG=g, netMR=l, checkpoints_path="ck", name="x",
                      use_aug=True, aug_blur=1.0)
        item = TrainDataset(opt, use_crop=True)[1]
        assert item["img"].shape == (1, 512, 512, 6)
        pretrain_coarse(opt, max_steps=2, device="cpu")
        opt.load_netG_checkpoint_path = ck.latest_path("ck", "x_netG")
        train_fine(opt, max_steps=1, device="cpu")
        got = ck.load_checkpoint(ck.latest_path("ck", "x"), device="cpu")
        assert "netG" in got["params"]["params"]
        bad = [k for k in sys.modules
               if (k == "rgbd_pifuhd_tpu" or k.startswith("rgbd_pifuhd_tpu."))
               and sys.modules[k] is not None]
        assert not bad, bad
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr


def test_training_entry_points_refuse_silent_cpu():
    """The drivers default to ``cuda`` and raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    from rgbd_pifuhd_tpu_torch.train.loop import pretrain_coarse, train_fine
    from rgbd_pifuhd_tpu_torch.utils.options import Options

    for fn in (pretrain_coarse, train_fine):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(Options(dataroot=os.path.join(REPO, "nonexistent")))


def test_rest_of_training_runs_without_jax(tmp_path):
    """With JAX, flax, optax, msgpack, cv2, PIL and the JAX package
    blocked: normal-net pretraining with the committed perceptual
    backbone (montages written as PNG), one GAN step, checkpoint
    evaluation, the metrics, ``plot_error``'s text summary and the
    committed progressive JPEG, on the CPU."""
    code = textwrap.dedent(f"""
        import sys, os
        for m in {BANNED!r} + ("matplotlib",):
            sys.modules[m] = None
        sys.path.insert(0, {REPO!r})
        os.chdir({str(tmp_path)!r})
        import torch
        from rgbd_pifuhd_tpu_torch.cli import plot_error
        from rgbd_pifuhd_tpu_torch.data.synthetic import (
            generate_synthetic_dataset)
        from rgbd_pifuhd_tpu_torch.models.pix2pix import (
            GlobalGenerator, MultiscaleDiscriminator)
        from rgbd_pifuhd_tpu_torch.train import loop, trainers
        from rgbd_pifuhd_tpu_torch.utils import checkpoint as ck, jpeg
        from rgbd_pifuhd_tpu_torch.utils.metrics import (
            chamfer_l2, compute_acc)
        from rgbd_pifuhd_tpu_torch.utils.options import (Options,
                                                         PIFuLevelConfig)
        generate_synthetic_dataset("tree", ("sphere", "bumpy"), size=64,
                                   load_size=64)
        g = PIFuLevelConfig(num_stack=1, hg_depth=1, hg_dim=8,
                            mlp_dim=(9, 32, 16, 1), mlp_res_layers=(),
                            mlp_norm="none", merge_layer=1, nml_ngf=4,
                            nml_n_downsampling=1, nml_n_blocks=1,
                            load_size=64)
        l = PIFuLevelConfig(num_stack=1, hg_depth=1, hg_dim=4,
                            hg_down="no_down", mlp_dim=(20, 16, 1),
                            mlp_res_layers=(), mlp_norm="none",
                            merge_layer=-1, use_front_normal=False,
                            use_back_normal=False, load_size=64)
        opt = Options(dataroot="tree", load_size=64, load_size_big=32,
                      load_size_local=32, num_sample_inout=64, sigma=3.0,
                      netG=g, netMR=l, checkpoints_path="ck", name="x",
                      freq_save=1)
        out = loop.pretrain_normals(opt, max_steps=1, use_vgg="native",
                                    device="cpu")
        assert sorted(out) == ["netB", "netF"]
        assert os.path.exists("train_result/x_netF/sample_epoch_0.png")
        gen = GlobalGenerator(6, 3, 4, 1, 1, device="cpu")
        disc = MultiscaleDiscriminator(9, 4, 2, 2, device="cpu")
        step = trainers.make_gan_normal_train_step(
            gen, lambda i, x: disc(torch.cat([i, x], -1)),
            trainers.make_optimizer("adam", 1e-3, gen.parameters()),
            trainers.make_optimizer("adam", 1e-3, disc.parameters()))
        m = step({{"images": torch.randn(1, 32, 32, 6),
                  "target": torch.randn(1, 32, 32, 3)}})
        assert all(torch.isfinite(v) for v in m.values())
        model = loop.build_multires(opt, "cpu")
        ck.save_checkpoint(ck.epoch_path("ck", "x", 0),
                           ck.params_to_flax(model), opt)
        res = loop.evaluate_checkpoints(opt, device="cpu")
        assert list(res) == [0] and os.path.exists("ck/x_eval_epoch_0.npy")
        iou, _, _ = compute_acc(torch.tensor([0.9, 0.1]),
                                torch.tensor([1.0, 0.0]))
        assert float(iou) == 1.0
        assert float(chamfer_l2(torch.zeros(4, 3), torch.zeros(2, 3))) == 0
        plot_error.main(["--name", "x"])
        img = jpeg.read_rgb8(os.path.join({REPO!r}, "tests", "data",
                                          "jpeg_progressive", "capsule.jpg"))
        assert img.shape == (512, 512, 3)
        bad = [k for k in sys.modules
               if (k == "rgbd_pifuhd_tpu" or k.startswith("rgbd_pifuhd_tpu."))
               and sys.modules[k] is not None]
        assert not bad, bad
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr
    assert "matplotlib unavailable; text summary only" in r.stdout


@pytest.mark.parametrize("name", ["pretrain_normals", "train_alternating",
                                  "evaluate_checkpoints"])
def test_rest_of_training_refuses_silent_cpu(name):
    """The new drivers default to ``cuda`` and raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    from rgbd_pifuhd_tpu_torch.train import loop
    from rgbd_pifuhd_tpu_torch.utils.options import Options

    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(loop, name)(Options(dataroot=os.path.join(REPO,
                                                          "nonexistent")))


def test_data_generation_runs_without_jax(tmp_path):
    """With JAX, flax, optax, msgpack, cv2, PIL, matplotlib and the JAX
    package blocked: ``cli.gen_data`` renders a textured OBJ subject with
    PRT into a tree and composites it, ``cli.debug_vis`` reads it (and
    skips the plot), GrabCut and ``crop_people`` segment its composite,
    the turntable ``.avi`` is written and read back, and
    ``cli.encode_objs`` runs, on the CPU."""
    code = textwrap.dedent(f"""
        import sys, os
        for m in {BANNED!r} + ("matplotlib",):
            sys.modules[m] = None
        sys.path.insert(0, {REPO!r})
        os.chdir({str(tmp_path)!r})
        import numpy as np
        from rgbd_pifuhd_tpu_torch.cli import debug_vis, encode_objs, gen_data
        from rgbd_pifuhd_tpu_torch.data.segmentation import (
            crop_people, segment_person_grabcut)
        from rgbd_pifuhd_tpu_torch.data.synthetic import (
            SUBJECT_CENTER, make_icosphere, normalize_mesh_height)
        from rgbd_pifuhd_tpu_torch.recon.turntable import (
            generate_video_from_obj)
        from rgbd_pifuhd_tpu_torch.utils import avi, jpeg, png
        os.makedirs("objs")
        v, f = make_icosphere(2)
        v = normalize_mesh_height(v) + SUBJECT_CENTER
        png.write_png("objs/t.png", np.full((8, 8, 3), 150, np.uint8))
        open("objs/s.mtl", "w").write("newmtl m\\nKd 1 0 0\\nmap_Kd t.png\\n")
        with open("objs/s_100k.obj", "w") as fh:
            fh.write("mtllib s.mtl\\nusemtl m\\nvt 0.5 0.5\\n")
            fh.writelines(f"v {{p[0]}} {{p[1]}} {{p[2]}}\\n" for p in v)
            fh.writelines(f"f {{a}}/1 {{b}}/1 {{c}}/1\\n" for a, b, c in f + 1)
        gen_data.main(["--out", "tree", "--obj_dir", "objs", "--use_prt",
                       "--size", "64", "--load_size", "64"])
        assert os.path.exists("tree/gen/s_0.png")
        assert os.path.exists("tree/OBJ/s_100k.obj")
        debug_vis.main(["--dataroot", "tree", "--ply", "s.ply"])
        img = png.read_rgb8("tree/gen/s_0.png")[:, :, ::-1]
        m = png.read_png("tree/MASK/s/0_0_00.png") > 127
        ys, xs = np.nonzero(m)
        rect = (xs.min() - 3, ys.min() - 3, xs.max() - xs.min() + 7,
                ys.max() - ys.min() + 7)
        seg = segment_person_grabcut(img, rect)
        assert (seg & m).sum() > 0.9 * m.sum()
        assert crop_people("tree/gen/s_0.png", rect).shape == img.shape
        generate_video_from_obj("tree/OBJ/s_100k.obj", "t.avi", 48, 3)
        frames = avi.read_avi("t.avi")["frames"]
        assert [jpeg.decode(b).shape for b in frames] == [(48, 48, 3)] * 3
        encode_objs.main(["objs"])
        bad = [k for k in sys.modules
               if (k == "rgbd_pifuhd_tpu" or k.startswith("rgbd_pifuhd_tpu."))
               and sys.modules[k] is not None]
        assert not bad, bad
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=30)
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr
    assert "matplotlib unavailable; skipped plot" in r.stdout
    assert "rendered {'s': 2} into tree" in r.stdout


def test_training_on_generated_tree_refuses_silent_cpu(tmp_path):
    """``cli.run_train`` (how a generated tree is trained and evaluated)
    defaults to ``cuda`` and raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    from rgbd_pifuhd_tpu_torch.cli import run_train

    for stage in ("coarse", "eval"):
        with pytest.raises(RuntimeError, match="CUDA"):
            run_train.main(["--stage", stage, "--dataroot", str(tmp_path)])


def test_recipes_run_without_jax(tmp_path):
    """With JAX, flax, optax, msgpack, cv2, PIL, ``bench``,
    ``__graft_entry__`` and the JAX package blocked: the recipes' options,
    the flagship recipe's tag and stage files, and the watchdog running a
    child (the recipes train in ``test_torch_bench_*.py``)."""
    code = textwrap.dedent(f"""
        import sys, os
        for m in {BANNED!r}:
            sys.modules[m] = None
        sys.path.insert(0, {REPO!r})
        os.chdir({str(tmp_path)!r})
        import numpy as np
        from rgbd_pifuhd_tpu_torch.tools import train_bench_flagship as tbf
        from rgbd_pifuhd_tpu_torch.tools import train_bench_tiny as tbt
        from rgbd_pifuhd_tpu_torch.utils import retry, watchdog
        assert tbt.tiny_options("tree").netMR.mlp_norm == "none"
        opt = tbf.flagship_options("tree", lite=True)
        assert opt.netG.nml_ngf == 16 and opt.netG.compute_dtype == "bfloat16"
        tag = tbf.recipe_tag(1, 2, 3, "adam", 3e-3, 2.0, 0, True, 10000, 0)
        tree = {{"w": np.ones((2, 3), np.float16)}}
        tbf._save_stage("st/stage2_coarse", tree, opt, tag)
        got = tbf._load_stage("st/stage2_coarse", tag, "cpu")
        assert got["w"].dtype.is_floating_point and float(got["w"].sum()) == 6
        assert not retry.is_transient(ValueError("x"))
        try:
            watchdog.run_watchdog(["sh", "-c", "exit 0"])
        except SystemExit as e:
            assert e.code == 0
        bad = [k for k in sys.modules
               if (k == "rgbd_pifuhd_tpu" or k.startswith("rgbd_pifuhd_tpu.")
                   or k.split(".")[0] in ("jax", "bench", "__graft_entry__"))
               and sys.modules[k] is not None]
        assert not bad, bad
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=30)
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr


@pytest.mark.parametrize("module", ["train_bench_flagship",
                                    "train_bench_tiny"])
def test_recipes_refuse_silent_cpu(module, tmp_path):
    """The recipes default to ``cuda`` and raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    import importlib

    mod = importlib.import_module(f"rgbd_pifuhd_tpu_torch.tools.{module}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(["--out", str(tmp_path / "out"), "--dataroot",
                  str(tmp_path / "tree")])
