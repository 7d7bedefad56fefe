"""Operation and byte counts, and the card's peaks.

``mlp_flops_per_point`` and ``two_level_query_flops_per_point`` are frozen
copies of ``rgbd_pifuhd_tpu_torch/utils/flops.py`` (2 x the multiply-adds
of one ``PointMLP`` forward for one point, Dense layers with the residual
input concats; norms and activations left out).  ``PEAK_BF16`` is the
NVIDIA H100 SXM5 data sheet's dense bf16 tensor-core rate at 700 W and
``PEAK_BYTES`` its HBM3 bandwidth.  ``counted_flops`` counts a PyTorch
computation with ``torch.utils.flop_counter.FlopCounterMode``.
"""

from __future__ import annotations

PEAK_BF16 = 989.4e12
PEAK_BYTES = 3.35e12


def mlp_flops_per_point(dims, res_layers) -> float:
    dims = list(dims)
    res = set(res_layers or ())
    flops = 0.0
    for i in range(len(dims) - 1):
        fan_in = dims[i] + (dims[0] if i in res else 0)
        flops += 2.0 * fan_in * dims[i + 1]
    return flops


def two_level_query_flops_per_point(cfg_fine: dict, cfg_coarse: dict) -> float:
    return (mlp_flops_per_point(cfg_fine["mlp_dim"], cfg_fine["mlp_res_layers"])
            + mlp_flops_per_point(cfg_coarse["mlp_dim"],
                                  cfg_coarse["mlp_res_layers"]))


def counted_flops(fn) -> float:
    """FLOPs of ``fn()`` as ``FlopCounterMode`` counts them."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())
