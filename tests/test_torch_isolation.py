"""The PyTorch port stands alone: it imports neither JAX, flax, msgpack nor
cv2, nor any module of the JAX package, and its entry points never carry
on quietly on the CPU.

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
BANNED = ("jax", "jaxlib", "flax", "optax", "msgpack", "cv2",
          "rgbd_pifuhd_tpu")


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
                   or m.split(".")[0] in ("jax", "flax", "msgpack", "cv2"))
               and sys.modules[m] is not None]
        assert not bad, bad
        assert len(names) >= 16, names
        print(len(names))
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=240)
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
