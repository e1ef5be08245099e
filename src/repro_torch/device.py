"""Device resolution: every entry point runs on the card unless told not to.

``resolve(None)`` is ``cuda``.  Asking for ``cuda`` on a machine without a
card raises; nothing in the port carries on quietly on the CPU.  Passing
``"cpu"`` explicitly runs the plain PyTorch versions of the kernels, which
is what the CPU tests do.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run the plain PyTorch path"
        )
    return dev
