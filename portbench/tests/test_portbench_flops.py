"""The frozen FLOP count of one two-level field query against the
program's own arithmetic and PERF.md's 7.64e11 at N = 262,144."""

import json
import os

from portbench import flops as F

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _cfg(name):
    with open(os.path.join(ROOT, "portbench", "configs", name)) as f:
        return json.load(f)


def test_query_flops_at_262144():
    c = _cfg("pifuhd-flagship-lite.json")
    n = F.two_level_query_flops_per_point(c["netMR"], c["netG"]) * 262144
    assert abs(n - 7.64e11) / 7.64e11 < 1e-3


def test_matches_the_program():
    from rgbd_pifuhd_tpu_torch.tools.train_bench_flagship import \
        flagship_configs
    from rgbd_pifuhd_tpu_torch.utils import flops as P

    g, l = flagship_configs()
    c = _cfg("pifuhd-flagship.json")
    assert F.two_level_query_flops_per_point(c["netMR"], c["netG"]) == \
        P.two_level_query_flops_per_point(l, g)
    assert F.PEAK_BF16 == P.device_peak_flops("NVIDIA H100 80GB HBM3")
