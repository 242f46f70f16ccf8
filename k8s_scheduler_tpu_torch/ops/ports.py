"""NodePorts filter (`k8s_scheduler_tpu/ops/ports.py`): a pod requesting
hostPorts is infeasible on nodes where any requested (port, protocol) is
already used by an EXISTING pod. Ports are encoded as port*4+protocol
ints, so the check is set-disjointness of small padded int lists."""

from __future__ import annotations

import torch


def ports_conflict_mask(
    pod_ports: torch.Tensor,  # i32 [P, MPp] (-1 pad)
    node_used_ports: torch.Tensor,  # i32 [N, MUP] (-1 pad)
) -> torch.Tensor:  # bool [P, N] — True = conflict (infeasible)
    """One [P, N] comparison per (pod slot, node slot) pair, so the
    intermediate never grows past [P, N]."""
    P, N = pod_ports.shape[0], node_used_ports.shape[0]
    out = torch.zeros((P, N), dtype=torch.bool, device=pod_ports.device)
    for j in range(pod_ports.shape[1]):
        pj = pod_ports[:, j, None]
        for k in range(node_used_ports.shape[1]):
            uk = node_used_ports[None, :, k]
            out |= (pj == uk) & (pj >= 0) & (uk >= 0)
    return out
