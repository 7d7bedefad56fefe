"""PIFu's texture network (netC) drawn from the run's seed and added to the
flagship-lite checkpoint's payload, which the program (through its own
reader) and the reference each read.

No trained colour checkpoint is in the repository, so the weights are a
seeded draw, as a flax tree of numpy arrays in the program's layout
(``models.texture.TexPIFu``: ``image_filter.stem``, ``norm0``,
``down0``, ``norm1``, ``down1``, ``norm2``, ``block<i>.conv1`` / ``norm1`` /
``conv2`` / ``norm2``; ``mlp.dense<i>``).  The draw: convolutions and Dense
layers from N(0, 1 / fan_in), each Dense unit's weights then centred (they
sum to zero over its inputs, so what every vertex's features share does
not set its colour), biases N(0, 0.05^2), GroupNorm scales 1 and biases 0.
PIFu's own initialisation, N(0, 0.02), gives colours so close to one grey
that no check could tell them from a wrong answer.  On the H100, at the
served meshes' own vertices over 16 seeds, the colours' spread read
0.146-0.380 with the centring and 0.107-0.377 without it.  The check
reports the spread (``tex_color_std``) and the share at 0 or 255
(``tex_saturated_share``).
"""

from __future__ import annotations

import contextlib

import numpy as np

# the configuration file's netC group -> the program's option names
_OPT_KEYS = ("mlp_dim_color", "norm_color", "ngf_color", "n_blocks_color",
             "compute_dtype")


def _conv(rng, k, cin, cout):
    return {"kernel": (rng.standard_normal((k, k, cin, cout))
                       / np.sqrt(k * k * cin)).astype(np.float32)}


def _norm(c):
    return {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)}


def draw_netC(cfg: dict, seed: int) -> dict:
    """The flax variables tree ``{"params": {...}}`` of netC at ``cfg``
    (the configuration's ``netC`` group) from ``seed``."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                 0x7E7])
    ngf, nb = cfg["ngf_color"], cfg["n_blocks_color"]
    f = {"stem": _conv(rng, 7, cfg["input_nc"], ngf), "norm0": _norm(ngf)}
    for i in range(2):
        m = 2 ** i
        f[f"down{i}"] = _conv(rng, 3, ngf * m, ngf * m * 2)
        f[f"norm{i + 1}"] = _norm(ngf * m * 2)
    d = 4 * ngf
    for i in range(nb):
        b = {"conv1": _conv(rng, 3, d, d), "norm1": _norm(d),
             "conv2": _conv(rng, 3, d, d)}
        if i != nb - 1:
            b["norm2"] = _norm(d)
        f[f"block{i}"] = b
    dims = list(cfg["mlp_dim_color"])
    mlp = {}
    for i in range(len(dims) - 1):
        cin = dims[i] + (dims[0] if i else 0)
        k = rng.standard_normal((cin, dims[i + 1])) / np.sqrt(cin)
        mlp[f"dense{i}"] = {
            "kernel": (k - k.mean(0, keepdims=True)).astype(np.float32),
            "bias": (rng.standard_normal(dims[i + 1]) * 0.05)
            .astype(np.float32)}
    return {"params": {"image_filter": f, "mlp": mlp}}


def opt_netC(cfg: dict) -> dict:
    """The ``opt_netC`` entry of the payload (the program's names)."""
    return {k: list(cfg[k]) if isinstance(cfg[k], (list, tuple)) else cfg[k]
            for k in _OPT_KEYS}


def with_netC(payload: dict, cfg: dict, seed: int) -> dict:
    """``payload`` with ``netC`` and ``opt_netC`` added."""
    payload["netC"] = draw_netC(cfg, seed)
    payload["opt_netC"] = opt_netC(cfg)
    return payload


@contextlib.contextmanager
def tex_loader(module, cfg: dict, seed: int):
    """``module.load_checkpoint`` (the program's reader) returns payloads
    with the seeded netC while the block runs."""
    orig = module.load_checkpoint

    def load(*a, **kw):
        return with_netC(orig(*a, **kw), cfg, seed)

    module.load_checkpoint = load
    try:
        yield
    finally:
        module.load_checkpoint = orig
