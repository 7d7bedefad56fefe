"""Per-point occupancy MLP (port of ``models/mlp.py``), and with a tanh
head the texture field's colour MLP (``models.texture``).

``forward`` is the plain reference chain over ``[B, N, C]`` — the flax
``PointMLP`` step by step, used on the CPU and by the tests.  The model's
query path evaluates the same function through ``ops.fused_query`` with the
layers packed once by ``packed()``.

Rounding of a ``dtype`` (bf16) layer, as flax ``Dense(dtype=bf16)``: the
product is rounded to bf16, then the bias is added in bf16.  GroupNorm and
BatchNorm (f32 params) promote to f32; leaky runs in the dtype it is given,
with the slope 0.01 rounded to that dtype (bf16 for a norm-free bf16
chain).

With running statistics (inference), batch norm is a per-channel affine:
``packed()`` folds it into the preceding Dense layer's weight and bias, so
the kernels see a norm-free chain; ``forward`` applies it as flax does, and
with ``train=True`` normalises with the batch's statistics and updates the
running ones (training runs ``forward``, never the kernels).
In bf16 the folded chain rounds in other places (the folded weights, and
leaky in bf16 where flax's runs in f32 after the norm).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_query import PackedMLP, pack_layers
from .blocks import make_norm


class PointMLP(nn.Module):
    def __init__(self, filter_channels: Sequence[int], merge_layer: int = 0,
                 res_layers: Sequence[int] = (), norm: str = "group",
                 last_op: str | None = "sigmoid",
                 dtype: torch.dtype | None = None, device=None):
        super().__init__()
        if norm not in ("group", "batch", "none"):
            raise ValueError(f"unknown mlp norm {norm!r}")
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
            if norm != "none" and i != self.n_layers - 1:
                setattr(self, f"norm{i}", make_norm(norm, fc[i + 1],
                                                    device))
        self._packed: dict = {}
        self.register_load_state_dict_post_hook(
            lambda m, _keys: m._packed.clear())

    def _apply(self, fn, *args, **kwargs):
        self._packed.clear()        # the packed copies follow the weights
        return super()._apply(fn, *args, **kwargs)

    def _dense(self, i: int, x: torch.Tensor) -> torch.Tensor:
        lin = getattr(self, f"dense{i}")
        if self.dtype is None:
            return F.linear(x.float(), lin.weight, lin.bias)
        y = F.linear(x.to(self.dtype), lin.weight.to(self.dtype))
        return y + lin.bias.to(self.dtype)

    @staticmethod
    def _leaky(y: torch.Tensor) -> torch.Tensor:
        """leaky_relu(0.01) in ``y``'s dtype as JAX computes it: the slope
        is rounded to that dtype first (torch's own multiplies in f32)."""
        if y.dtype == torch.float32:
            return F.leaky_relu(y, 0.01)
        slope = float(torch.tensor(0.01, dtype=y.dtype))  # no host copy
        return torch.where(y >= 0, y, (slope * y.float()).to(y.dtype))

    def forward(self, feature: torch.Tensor, train: bool = False):
        if train:               # the weights are about to change
            self._packed.clear()
        y = feature
        phi = None
        for i in range(self.n_layers):
            inp = torch.cat([y, feature], dim=-1) \
                if i in self.res_layers else y
            y = self._dense(i, inp)
            if i != self.n_layers - 1:
                if self.norm != "none":
                    y = getattr(self, f"norm{i}")(y, train)
                y = self._leaky(y)
            if i == self.merge:
                phi = y
        if self.last_op == "sigmoid":
            y = torch.sigmoid(y.float())
        elif self.last_op == "tanh":
            y = torch.tanh(y.float())
        return y, phi

    def _folded(self, i: int):
        """Dense layer ``i`` with its batch norm folded in: ``(weight,
        bias)`` f32, ``norm(x W^T + b) = x (mul W)^T + (b mul + add)``."""
        lin = getattr(self, f"dense{i}")
        if self.norm != "batch" or i == self.n_layers - 1:
            return lin.weight, lin.bias
        mul, add = getattr(self, f"norm{i}").affine()
        return ((lin.weight.double() * mul[:, None]).float(),
                (lin.bias.double() * mul + add).float())

    def packed(self) -> PackedMLP:
        """Layers packed for the kernels (cached; cleared when a state dict
        is loaded): GroupNorm as the kernels' norm, batch norm folded into
        the Dense before it."""
        cd = self.dtype or torch.float32
        if cd not in self._packed:
            lin = [self._folded(i) for i in range(self.n_layers)]
            nrm = [(getattr(self, f"norm{i}").weight,
                    getattr(self, f"norm{i}").bias)
                   if self.norm == "group" and hasattr(self, f"norm{i}")
                   else None for i in range(self.n_layers)]
            self._packed[cd] = pack_layers(lin, nrm, cd, self.res_layers)
        return self._packed[cd]
