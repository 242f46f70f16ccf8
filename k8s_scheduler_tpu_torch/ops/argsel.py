"""Selection primitives with the reference's tie order
(`k8s_scheduler_tpu/ops/argsel.py`): the FIRST index of the maximum.
Claim ranking depends on it — the rounds engine breaks score ties by
lowest node index after the hash tie-break."""

from __future__ import annotations

import torch


def argmax_first(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the FIRST maximum along `dim` (i32): a max, then a min over
    the indices holding it — two order-free reduces."""
    dim = dim % x.ndim
    n = x.shape[dim]
    m = torch.amax(x, dim=dim, keepdim=True)
    shape = [1] * x.ndim
    shape[dim] = n
    idx = torch.arange(n, dtype=torch.int32, device=x.device).view(shape)
    big = torch.full((), n, dtype=torch.int32, device=x.device)
    return torch.amin(torch.where(x == m, idx, big), dim=dim)


def index_dtype(n: int) -> torch.dtype:
    """Minimal index dtype addressing `n` values."""
    return torch.int16 if n <= 2**15 - 1 else torch.int32
