"""Device selection for the port's entry points.

Every entry point takes an explicit `device`. Left as None it means the
card: a machine without CUDA raises instead of quietly running the cycle
on the CPU. Tests pass `device="cpu"`, which selects the plain-torch
versions of every kernel.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port's plain "
                "torch path explicitly"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
