"""Flop accounting (port of ``utils/flops.py``): what a field query
computes, and the card's peak to hold it against.

- ``mlp_flops_per_point``: 2 x the multiply-adds of one ``PointMLP``
  forward for one point (Dense layers, with the residual input concats;
  norms and activations are O(width) and left out);
- ``two_level_query_flops_per_point``: one two-level field query runs the
  coarse MLP (for ``phi``) and the fine MLP;
- ``device_peak_flops``: the published dense bf16 peak of the card, by
  its ``torch.cuda.get_device_name``.

The JAX package's ``lowered_flops`` / ``jaxpr_flops`` count a traced JAX
computation (the encoders' convolutions); the port has no trace to count,
and ``torch.utils.flop_counter.FlopCounterMode`` is that need's
counterpart for a PyTorch forward.
"""

from __future__ import annotations


def mlp_flops_per_point(cfg) -> float:
    """2 x multiply-adds of one ``PointMLP`` forward for ONE point: layer
    ``i`` maps ``mlp_dim[i]`` (plus ``mlp_dim[0]`` at a residual layer) to
    ``mlp_dim[i + 1]``."""
    dims = list(cfg.mlp_dim)
    res = set(cfg.mlp_res_layers or ())
    flops = 0.0
    for i in range(len(dims) - 1):
        fan_in = dims[i] + (dims[0] if i in res else 0)
        flops += 2.0 * fan_in * dims[i + 1]
    return flops


def two_level_query_flops_per_point(cfg_fine, cfg_global) -> float:
    """Per-point MLP flops of one two-level field query (coarse + fine)."""
    return mlp_flops_per_point(cfg_fine) + mlp_flops_per_point(cfg_global)


# NVIDIA H100 datasheet, dense bf16 tensor-core peak (without sparsity,
# which doubles the datasheet's figures), FLOP/s, at the form's full power
# limit: SXM5 (700 W, named "NVIDIA H100 80GB HBM3") and PCIe (350 W).
_PEAK_BF16 = {
    "H100 80GB HBM3": 989.4e12,
    "H100 SXM": 989.4e12,
    "H100 PCIe": 756.0e12,
}


def device_peak_flops(device) -> float | None:
    """Dense bf16 peak FLOP/s of a card: ``device`` is a CUDA device (its
    ``torch.cuda.get_device_name``) or the name itself; the longest
    matching entry wins; None for unknown cards and for the CPU."""
    import torch

    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        name = device
    else:
        dev = torch.device(device)
        if dev.type != "cuda":
            return None
        name = torch.cuda.get_device_name(dev)
    best = None
    for key, peak in _PEAK_BF16.items():
        if key in name and (best is None or len(key) > best[0]):
            best = (len(key), peak)
    return best[1] if best else None
