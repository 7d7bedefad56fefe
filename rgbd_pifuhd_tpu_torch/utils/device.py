"""Device selection shared by every entry point of the port.

Entry points default to ``cuda``.  They run on the CPU only when the caller
asks for it (``device='cpu'``), as the tests do; with no CUDA device and no
explicit request they raise instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a CUDA device); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the "
                "CPU explicitly")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Option string ('float32' | 'bfloat16') -> torch dtype."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]
