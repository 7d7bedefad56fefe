"""Reference PyTorch checkpoints (``.pth``) read into this port (its own
copy of the JAX package's ``utils/torch_import.py``).

The reference's training scripts save ``torch.save({'opt', 'opt_netG',
'model_state_dict'})`` (and raw ``state_dict()`` files).  Their module
names are mapped onto the flax parameter tree the JAX package uses (a
``{'params', 'batch_stats'}`` variables dict of NumPy arrays), which
``utils.checkpoint.params_from_flax`` maps onto this port's modules:

- ``Filter``: ``conv1/bn1/conv2..4/m{i}/top_m_{i}/conv_last{i}/bn_end{i}/
  l{i}/bl{i}/al{i}[/down_conv2]`` -> HGFilter's names, norms at
  ``_NormReLU_{k}.n`` (stem k=0, stack i at k=i+1);
- ``ConvBlock``: ``bn{1..3}+conv{1..3}`` -> ``_NormReLU_{0..2}.n`` +
  ``conv{1..3}``; the shortcut ``downsample.2`` (bn4) -> ``_NormReLU_3.n``
  + ``down_conv``;
- ``HourGlass``: the flat ``b1_{L}..b3_{L}``, ``b2_plus_1`` -> the nested
  ``inner`` levels (level L of the flat names at nesting depth L);
- ``MLP``: ``filters.{i}`` (1x1 Conv1d) -> ``dense{i}``, ``norms.{i}`` ->
  ``norm{i}``;
- ``GlobalGenerator``: the ``model`` Sequential's indices recomputed from
  the state dict; ConvTranspose2d weights spatially flipped into flax's
  layout (``params_from_flax`` flips them back);
- GroupNorm affine -> ``{scale, bias}``; BatchNorm also ``batch_stats``
  ``{mean, var}``.

``reconcile_with_model`` zero-pads first-conv input channels against the
port model (the reference's 3-channel netF / netB stems against the
6-channel RGB-D stack the port's normal nets take).  Loading needs torch
only: no JAX, no flax.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch

SD = dict  # str -> np.ndarray


# --------------------------------------------------------------- file layer
def is_torch_checkpoint(path: str) -> bool:
    """Detect torch.save output by magic: zip ("PK") or legacy pickle
    (0x80 + protocol).  msgpack and Orbax never start with either."""
    try:
        with open(path, "rb") as f:
            head = f.read(2)
    except (OSError, IsADirectoryError):
        return False
    return head[:2] == b"PK" or (len(head) == 2 and head[0] == 0x80)


def load_torch_file(path: str) -> tuple[SD, dict]:
    """Load a reference checkpoint file -> (numpy state dict, meta).

    meta holds 'opt' / 'opt_netG' as plain dicts when embedded (the
    reference pickles argparse Namespaces alongside the weights).
    """
    try:  # plain tensor-only saves load under the safe default
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:  # Namespace-bearing saves need full unpickling
        payload = torch.load(path, map_location="cpu", weights_only=False)

    meta: dict = {}
    if isinstance(payload, dict) and "model_state_dict" in payload:
        for k in ("opt", "opt_netG"):
            if k in payload:
                v = payload[k]
                meta[k] = dict(vars(v)) if hasattr(v, "__dict__") else (
                    dict(v) if isinstance(v, dict) else None)
        payload = payload["model_state_dict"]
    if not isinstance(payload, dict):
        raise ValueError(f"unrecognized torch checkpoint structure: {path}")
    sd = {k: np.asarray(t.detach().cpu().numpy())
          for k, t in payload.items() if hasattr(t, "detach")}
    return sd, meta


# ---------------------------------------------------------- leaf converters
def _conv2d_kernel(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))  # OIHW -> HWIO


def _deconv2d_kernel(w: np.ndarray) -> np.ndarray:
    # torch ConvTranspose2d [in,out,kh,kw] computes the conv adjoint
    # (spatially flipped cross-correlation); flax ConvTranspose cross-
    # correlates the kernel as given -> flip H,W then lay out HWIO.
    return np.ascontiguousarray(w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1))


def _conv(sd: SD, key: str, bias: bool = True) -> dict:
    p = {"kernel": _conv2d_kernel(sd[f"{key}.weight"])}
    if bias and f"{key}.bias" in sd:
        p["bias"] = sd[f"{key}.bias"]
    return p


def _norm(sd: SD, key: str) -> tuple[dict, dict | None]:
    """GroupNorm/BatchNorm affine -> ({scale, bias}, stats-or-None)."""
    affine = {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}
    if f"{key}.running_mean" in sd:
        return affine, {"mean": sd[f"{key}.running_mean"],
                        "var": sd[f"{key}.running_var"]}
    return affine, None


def _put(tree: dict, stats: dict, name: str, key_norm: tuple) -> None:
    affine, st = key_norm
    tree[name] = {"n": affine}
    if st is not None:
        stats[name] = {"n": st}


# --------------------------------------------------------- block converters
def convblock_from_sd(sd: SD, p: str) -> tuple[dict, dict]:
    params: dict = {}
    stats: dict = {}
    for i, (bn, cv) in enumerate(
            (("bn1", "conv1"), ("bn2", "conv2"), ("bn3", "conv3"))):
        _put(params, stats, f"_NormReLU_{i}", _norm(sd, f"{p}.{bn}"))
        params[cv] = {"kernel": _conv2d_kernel(sd[f"{p}.{cv}.weight"])}
    if f"{p}.downsample.2.weight" in sd:
        _put(params, stats, "_NormReLU_3", _norm(sd, f"{p}.bn4"))
        params["down_conv"] = {
            "kernel": _conv2d_kernel(sd[f"{p}.downsample.2.weight"])}
    return params, stats


def hourglass_from_sd(sd: SD, p: str, level: int | None = None
                      ) -> tuple[dict, dict]:
    if level is None:  # top call: depth = highest registered level
        level = max(int(m.group(1)) for k in sd
                    if (m := re.match(re.escape(p) + r"\.b1_(\d+)\.", k)))
    params: dict = {}
    stats: dict = {}
    for ours, theirs in (("b1", f"b1_{level}"), ("b2", f"b2_{level}"),
                         ("b3", f"b3_{level}")):
        cp, cs = convblock_from_sd(sd, f"{p}.{theirs}")
        params[ours] = cp
        if cs:
            stats[ours] = cs
    if level > 1:
        ip, is_ = hourglass_from_sd(sd, p, level - 1)
        params["inner"] = ip
        if is_:
            stats["inner"] = is_
    else:
        bp, bs = convblock_from_sd(sd, f"{p}.b2_plus_1")
        params["b2_plus"] = bp
        if bs:
            stats["b2_plus"] = bs
    return params, stats


def hgfilter_from_sd(sd: SD, p: str) -> tuple[dict, dict]:
    params: dict = {}
    stats: dict = {}
    params["conv1"] = _conv(sd, f"{p}.conv1")
    _put(params, stats, "_NormReLU_0", _norm(sd, f"{p}.bn1"))
    for cv in ("conv2", "conv3", "conv4"):
        cp, cs = convblock_from_sd(sd, f"{p}.{cv}")
        params[cv] = cp
        if cs:
            stats[cv] = cs
    if f"{p}.down_conv2.weight" in sd:  # conv64/conv128 down types
        params["down_conv2"] = _conv(sd, f"{p}.down_conv2")
    n_stack = sum(1 for k in sd
                  if re.match(re.escape(p) + r"\.conv_last(\d+)\.weight$", k))
    for i in range(n_stack):
        hp, hs = hourglass_from_sd(sd, f"{p}.m{i}")
        params[f"m{i}"] = hp
        if hs:
            stats[f"m{i}"] = hs
        tp, ts = convblock_from_sd(sd, f"{p}.top_m_{i}")
        params[f"top_m_{i}"] = tp
        if ts:
            stats[f"top_m_{i}"] = ts
        params[f"conv_last{i}"] = _conv(sd, f"{p}.conv_last{i}")
        _put(params, stats, f"_NormReLU_{i + 1}", _norm(sd, f"{p}.bn_end{i}"))
        params[f"l{i}"] = _conv(sd, f"{p}.l{i}")
        if f"{p}.bl{i}.weight" in sd:
            params[f"bl{i}"] = _conv(sd, f"{p}.bl{i}")
            params[f"al{i}"] = _conv(sd, f"{p}.al{i}")
    return params, stats


def pointmlp_from_sd(sd: SD, p: str) -> tuple[dict, dict]:
    params: dict = {}
    stats: dict = {}
    n = sum(1 for k in sd
            if re.match(re.escape(p) + r"\.filters\.(\d+)\.weight$", k))
    for i in range(n):
        w = sd[f"{p}.filters.{i}.weight"]  # Conv1d [out, in, 1]
        params[f"dense{i}"] = {
            "kernel": np.ascontiguousarray(w[:, :, 0].T),
            "bias": sd[f"{p}.filters.{i}.bias"],
        }
        if f"{p}.norms.{i}.weight" in sd:
            affine, st = _norm(sd, f"{p}.norms.{i}")
            params[f"norm{i}"] = affine
            if st is not None:
                stats[f"norm{i}"] = st
    return params, stats


def global_generator_from_sd(sd: SD, p: str) -> dict:
    """pix2pixHD GlobalGenerator Sequential -> flax named tree.

    Layout (networks.py:140-160, norm='instance' so norms are param-free):
    [pad, conv, norm, relu] + nd*[conv, norm, relu] + nb*[ResnetBlock]
    + nd*[deconv, norm, relu] + [pad, conv] (+ tanh).
    """
    p = f"{p}." if p else ""
    if f"{p}model.2.weight" in sd:
        raise ValueError(
            "GlobalGenerator checkpoint uses an affine/batch norm layer; "
            "only norm='instance' (the reference's define_G default for "
            "netF/netB, PIFuNetwNML.py:65-67) is importable")
    idx_down0 = 4
    nd = 0
    while f"{p}model.{idx_down0 + 3 * nd}.weight" in sd:
        # downs are Conv2d [out,in,3,3]; the first resblock key differs
        if f"{p}model.{idx_down0 + 3 * nd}.conv_block.1.weight" in sd:
            break
        nd += 1
    r0 = idx_down0 + 3 * nd
    nb = 0
    while f"{p}model.{r0 + nb}.conv_block.1.weight" in sd:
        nb += 1
    params: dict = {"stem": _conv(sd, f"{p}model.1")}
    for i in range(nd):
        params[f"down{i}"] = _conv(sd, f"{p}model.{idx_down0 + 3 * i}")
    for i in range(nb):
        blk = f"{p}model.{r0 + i}.conv_block"
        params[f"res{i}"] = {"conv1": _conv(sd, f"{blk}.1"),
                             "conv2": _conv(sd, f"{blk}.5")}
    u0 = r0 + nb
    for i in range(nd):
        key = f"{p}model.{u0 + 3 * i}"
        params[f"up{i}"] = {
            "kernel": _deconv2d_kernel(sd[f"{key}.weight"]),
            "bias": sd[f"{key}.bias"],
        }
    params["head"] = _conv(sd, f"{p}model.{u0 + 3 * nd + 1}")
    return params


# ----------------------------------------------------------- net converters
def coarse_variables_from_sd(sd: SD, prefix: str = "") -> dict:
    """PIFuNetwNML state dict -> CoarsePIFu variables
    ({'params': ..., ['batch_stats': ...]})."""
    p = prefix[:-1] if prefix.endswith(".") else prefix

    def sub(name: str) -> str:
        return f"{p}.{name}" if p else name

    params: dict = {}
    stats: dict = {}
    fp, fs = hgfilter_from_sd(sd, sub("image_filter"))
    params["image_filter"] = fp
    if fs:
        stats["image_filter"] = fs
    mp, ms = pointmlp_from_sd(sd, sub("mlp"))
    params["mlp"] = mp
    if ms:
        stats["mlp"] = ms
    for net in ("netF", "netB"):
        if f"{sub(net)}.model.1.weight" in sd:
            params[net] = global_generator_from_sd(sd, sub(net))
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def multires_variables_from_sd(sd: SD) -> dict:
    """PIFuMRNet state dict -> MultiResPIFu variables (nested netG)."""
    out = coarse_variables_from_sd(sd)  # fine level: image_filter + mlp
    inner = coarse_variables_from_sd(sd, prefix="netG")
    out["params"]["netG"] = inner["params"]
    if "batch_stats" in inner:
        out.setdefault("batch_stats", {})["netG"] = inner["batch_stats"]
    return out


def looks_like_multires(sd: SD) -> bool:
    return any(k.startswith("netG.") for k in sd)


# ------------------------------------------------------- channel reconcile
def reconcile_input_channels(variables: dict, template: dict) -> dict:
    """Zero-pad conv kernels (flax HWIO) of a flax tree along the
    input-channel axis to the shapes of ``template`` (a tree of arrays of
    the model's own shapes, e.g. ``params_to_flax(model)["params"]``): the
    reference's 3-channel netF / netB stems and any narrower filter conv1.
    Any other shape mismatch raises with the path."""
    def walk(v: Any, t: Any, path: str) -> Any:
        if isinstance(v, dict):
            if not isinstance(t, dict):
                raise ValueError(f"tree mismatch at {path}")
            return {k: walk(v[k], t[k], f"{path}/{k}") if k in t else v[k]
                    for k in v}
        v = np.asarray(v)
        ts = tuple(np.shape(t))
        if tuple(v.shape) == ts:
            return v
        if (v.ndim == 4 and len(ts) == 4 and path.endswith("kernel")
                and v.shape[:2] == ts[:2] and v.shape[3] == ts[3]
                and v.shape[2] < ts[2]):
            pad = np.zeros((v.shape[0], v.shape[1], ts[2] - v.shape[2],
                            v.shape[3]), v.dtype)
            return np.concatenate([v, pad], axis=2)
        raise ValueError(
            f"shape mismatch at {path}: checkpoint {tuple(v.shape)} vs "
            f"model {ts} (only input-channel widening is implicit)")

    return walk(variables, template, "")


def reconcile_with_model(state_dict: dict, model) -> dict:
    """Zero-pad conv weights of ``state_dict`` (``params_from_flax``'s
    output) along the input-channel axis to the shapes of ``model``'s own
    (OIHW: axis 1), so the reference's RGB weights carry over and the extra
    channels start at exactly zero contribution.  Any other shape mismatch
    raises with the name."""
    own = model.state_dict()
    out = {}
    for k, v in state_dict.items():
        want = tuple(own[k].shape) if k in own else tuple(v.shape)
        if tuple(v.shape) == want:
            out[k] = v
        elif (v.ndim == 4 and len(want) == 4 and v.shape[0] == want[0]
              and v.shape[2:] == want[2:] and v.shape[1] < want[1]):
            pad = torch.zeros((v.shape[0], want[1] - v.shape[1]) +
                              tuple(v.shape[2:]), dtype=v.dtype,
                              device=v.device)
            out[k] = torch.cat([v, pad], dim=1)
        else:
            raise ValueError(
                f"shape mismatch at {k}: checkpoint {tuple(v.shape)} vs "
                f"model {want} (only input-channel widening is implicit)")
    return out


# -------------------------------------------------------------- opt mapping
_LEVEL_FIELDS = ("num_stack", "hg_depth", "hg_dim", "norm", "hg_down",
                 "mlp_dim", "mlp_res_layers", "mlp_norm", "merge_layer",
                 "z_size", "projection_mode")


def _level_from_ns(ns: dict, base) -> Any:
    """Build a PIFuLevelConfig from a reference Namespace dict.

    The reference mutates the generic fields (num_stack, hg_dim, mlp_dim,
    ...) to the level-specific values before constructing each net
    (train.py:101-119), so the embedded opt/opt_netG already carry the
    right per-level values under the generic names.
    """
    import dataclasses

    kw = {}
    for f in _LEVEL_FIELDS:
        if f in ns and ns[f] is not None:
            v = ns[f]
            kw[f] = tuple(v) if isinstance(v, list) else v
    for f in ("use_front_normal", "use_back_normal"):
        if f in ns:
            kw[f] = bool(ns[f])
    if "loadSize" in ns:
        kw["load_size"] = int(ns["loadSize"])
    return dataclasses.replace(base, **kw)


def options_from_torch_meta(meta: dict) -> dict | None:
    """Map embedded reference Namespaces -> our Options dict (to_dict form).

    The netMR save embeds 'opt' (local-mutated) and 'opt_netG'
    (global-mutated); a netG save embeds only 'opt'.
    """
    from .options import Options

    ns = meta.get("opt")
    if not ns:
        return None
    opt = Options()
    for f in opt.to_dict():
        if f in ("netG", "netMR"):
            continue
        if f in ns and ns[f] is not None:
            v = ns[f]
            setattr(opt, f, tuple(v) if isinstance(v, list) else v)
    ns_g = meta.get("opt_netG") or ns
    opt.netG = _level_from_ns(ns_g, opt.netG)
    opt.netMR = _level_from_ns(ns, opt.netMR)
    return opt.to_dict()


# ------------------------------------------------------------ entry point
def load_reference_checkpoint(path: str) -> dict:
    """torch checkpoint file -> the load_checkpoint payload contract:
    {'params': variables, 'opt': dict|None, 'opt_netG': dict|None,
    'epoch': 0, 'torch_import': True}."""
    sd, meta = load_torch_file(path)
    if looks_like_multires(sd):
        variables = multires_variables_from_sd(sd)
    elif any(k.startswith("image_filter.") for k in sd):
        variables = coarse_variables_from_sd(sd)
    elif any(k.startswith("model.") for k in sd):  # bare netF/netB save
        variables = {"params": global_generator_from_sd(sd, "")}
    else:
        raise ValueError(
            f"unrecognized reference state dict in {path}: "
            f"{sorted(sd)[:4]}...")
    opt_dict = options_from_torch_meta(meta)
    opt_netg = options_from_torch_meta({"opt": meta.get("opt_netG")}) \
        if meta.get("opt_netG") else opt_dict
    return {"params": variables, "opt": opt_dict, "opt_netG": opt_netg,
            "epoch": 0, "torch_import": True}
