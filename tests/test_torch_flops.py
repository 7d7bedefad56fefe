"""``utils/flops.py`` of the port against the JAX package's: both counters
on flagship-lite's configs (read from its committed checkpoint), the
paper's defaults and the tiny test configs, equal; the analytic count
equals ``torch.utils.flop_counter``'s count of the port's ``PointMLP``;
``device_peak_flops`` on named and unknown cards."""

import dataclasses
import os

import pytest
import torch

from rgbd_pifuhd_tpu.utils import flops as jflops
from rgbd_pifuhd_tpu.utils.options import PIFuLevelConfig as JCfg
from rgbd_pifuhd_tpu_torch.models.mlp import PointMLP
from rgbd_pifuhd_tpu_torch.utils import flops
from rgbd_pifuhd_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                   restore_options)
from rgbd_pifuhd_tpu_torch.utils.options import Options
from tests.test_models_pifu import tiny_global, tiny_local

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pairs():
    lite, _ = restore_options(Options(), load_checkpoint(os.path.join(
        REPO, "assets", "bench_flagship_lite", "ckpt"), device="cpu"))
    paper = Options()
    return {"flagship_lite": (lite.netMR, lite.netG),
            "paper": (paper.netMR, paper.netG),
            "tiny": (tiny_local(), tiny_global())}


def test_counters_match_jax():
    pairs = _pairs()
    for name, (fine, coarse) in pairs.items():
        jf, jc = (JCfg(**{k: v for k, v in dataclasses.asdict(c).items()
                          if k in JCfg.__dataclass_fields__})
                  for c in (fine, coarse))
        for port_c, jax_c in ((fine, jf), (coarse, jc)):
            assert flops.mlp_flops_per_point(port_c) == \
                jflops.mlp_flops_per_point(jax_c), name
        assert flops.two_level_query_flops_per_point(fine, coarse) == \
            jflops.two_level_query_flops_per_point(jf, jc), name
    # PERF.md's count of one flagship-lite query of 262,144 points
    fine, coarse = pairs["flagship_lite"]
    assert flops.two_level_query_flops_per_point(fine, coarse) * 262144 \
        == pytest.approx(7.644e11, rel=1e-3)


@pytest.mark.parametrize("dims,res", [((17, 64, 32, 1), (1, 2)),
                                      ((36, 32, 16, 1), (1,))])
def test_mlp_count_equals_flop_counter(dims, res):
    """The analytic count is the matrix products' flops of a forward
    (``FlopCounterMode`` counts those alone)."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = JCfg(mlp_dim=dims, mlp_res_layers=res, mlp_norm="none")
    mlp = PointMLP(dims, res_layers=res, norm="none", device="cpu")
    n = 256
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        mlp(torch.ones(1, n, dims[0]))
    assert counter.get_total_flops() == flops.mlp_flops_per_point(cfg) * n


def test_device_peak_flops():
    assert flops.device_peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert flops.device_peak_flops("NVIDIA H100 PCIe") == 756.0e12
    assert flops.device_peak_flops("NVIDIA A100-SXM4-80GB") is None
    assert flops.device_peak_flops("TPU v5 lite") is None
    assert flops.device_peak_flops("cpu") is None
    assert flops.device_peak_flops(torch.device("cpu")) is None
