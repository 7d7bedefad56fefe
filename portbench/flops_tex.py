"""Operation and byte counts of PIFu's texture network (netC), frozen
here as ``flops.py`` freezes the field's.

``color_flops_per_point``: 2 x the multiply-adds of one point through the
colour chain (Dense layers with the residual input concats; activations and
tanh left out): 1,675,011 multiply-adds, 3.35 MFLOP, at the published
513-1024-512-256-128-3.  ``color_call_bytes``: what one colour query reads
once whatever its points: the attached ``[128, 128, C_g + 4 ngf]`` bf16
map and the chain's bf16 weights and f32 biases.  ``COLOR_POINT_BYTES``:
a point's own: uv (8) and z (4) in, the f32 colour (12) out.
``encode_flops``: netC's filter at 512^2 by ``FlopCounterMode`` on the
reference (the attach is a concatenation).
"""

from __future__ import annotations

from portbench.flops import counted_flops, mlp_flops_per_point

COLOR_POINT_BYTES = 8 + 4 + 12
MAP_SIDE = 512 // 4      # the global image's side over the filters' stride


def color_flops_per_point(cfg: dict) -> float:
    dims = list(cfg["mlp_dim_color"])
    return mlp_flops_per_point(dims, range(1, len(dims) - 1))


def color_call_bytes(cfg: dict, cfg_global: dict) -> int:
    dims = list(cfg["mlp_dim_color"])
    weights = sum((dims[i] + (dims[0] if i else 0)) * dims[i + 1] * 2
                  + dims[i + 1] * 4 for i in range(len(dims) - 1))
    channels = cfg_global["hg_dim"] + 4 * cfg["ngf_color"]
    return MAP_SIDE * MAP_SIDE * channels * 2 + weights


def encode_flops(cfg: dict) -> float:
    """FLOPs of netC's filter on one 512^2 RGB image."""
    import torch

    from portbench.reference import texpifu as T

    with torch.device("meta"):
        f = T.ResnetFilter(cfg["ngf_color"], cfg["n_blocks_color"],
                           cfg["input_nc"])
        img = torch.zeros(1, 512, 512, cfg["input_nc"])
    with torch.inference_mode():
        return counted_flops(lambda: f(img))
