"""Per-point occupancy MLP (port of ``models/mlp.py``).

``forward`` is the plain reference chain over ``[B, N, C]`` — the flax
``PointMLP`` step by step, used on the CPU and by the tests.  The model's
query path evaluates the same function through ``ops.fused_query`` with the
layers packed once by ``packed()``.

Rounding of a ``dtype`` (bf16) layer, as flax ``Dense(dtype=bf16)``: the
product is rounded to bf16, then the bias is added in bf16.  GroupNorm
(f32 params) promotes to f32; leaky runs in that dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_query import PackedMLP, pack_layers
from .blocks import GroupNorm


class PointMLP(nn.Module):
    def __init__(self, filter_channels: Sequence[int], merge_layer: int = 0,
                 res_layers: Sequence[int] = (), norm: str = "group",
                 last_op: str | None = "sigmoid",
                 dtype: torch.dtype | None = None, device=None):
        super().__init__()
        if norm not in ("group", "none"):
            raise ValueError(f"mlp norm {norm!r} is not ported yet")
        fc = list(filter_channels)
        self.filter_channels = fc
        self.n_layers = len(fc) - 1
        self.merge = merge_layer if merge_layer > 0 else len(fc) // 2
        self.res_layers = tuple(int(r) for r in res_layers)
        self.norm, self.last_op, self.dtype = norm, last_op, dtype
        for i in range(self.n_layers):
            cin = (fc[0] if i == 0 else fc[i]) + (
                fc[0] if i in self.res_layers else 0)
            lin = nn.Linear(cin, fc[i + 1], device=device)
            nn.init.normal_(lin.weight, 0.0, 0.02)
            nn.init.zeros_(lin.bias)
            setattr(self, f"dense{i}", lin)
            if norm == "group" and i != self.n_layers - 1:
                setattr(self, f"norm{i}", GroupNorm(fc[i + 1], 32,
                                                    device=device))
        self._packed: dict = {}
        self.register_load_state_dict_post_hook(
            lambda m, _keys: m._packed.clear())

    def _dense(self, i: int, x: torch.Tensor) -> torch.Tensor:
        lin = getattr(self, f"dense{i}")
        if self.dtype is None:
            return F.linear(x.float(), lin.weight, lin.bias)
        y = F.linear(x.to(self.dtype), lin.weight.to(self.dtype))
        return y + lin.bias.to(self.dtype)

    def forward(self, feature: torch.Tensor):
        y = feature
        phi = None
        for i in range(self.n_layers):
            inp = torch.cat([y, feature], dim=-1) \
                if i in self.res_layers else y
            y = self._dense(i, inp)
            if i != self.n_layers - 1:
                if self.norm == "group":
                    y = getattr(self, f"norm{i}")(y)
                y = F.leaky_relu(y, 0.01)
            if i == self.merge:
                phi = y
        if self.last_op == "sigmoid":
            y = torch.sigmoid(y.float())
        return y, phi

    def packed(self) -> PackedMLP:
        """Layers packed for ``fused_gather_mlp`` (cached; cleared when a
        state dict is loaded)."""
        cd = self.dtype or torch.float32
        if cd not in self._packed:
            lin = [(getattr(self, f"dense{i}").weight,
                    getattr(self, f"dense{i}").bias)
                   for i in range(self.n_layers)]
            nrm = [(getattr(self, f"norm{i}").weight,
                    getattr(self, f"norm{i}").bias)
                   if hasattr(self, f"norm{i}") else None
                   for i in range(self.n_layers)]
            self._packed[cd] = pack_layers(lin, nrm, cd, self.res_layers)
        return self._packed[cd]
