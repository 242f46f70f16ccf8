"""ImageLocality score (`k8s_scheduler_tpu/ops/images.py`): nodes already
holding a pod's images score higher, scaled by image size (ramp between
23MB and 1GB) and by how widely each image is spread across nodes."""

from __future__ import annotations

import numpy as np
import torch

from . import labels as labels_ops

_MIN_IMG = 23.0 * 2**20  # images below this don't move the score
_MAX_IMG = 1.0 * 2**30  # per upstream maxContainerThreshold
# the ramp's `/ (max - min) * 100` as the reference's compiled program folds
# it: one multiply by the f32 constant 100 / (max - min)
_RAMP = float(np.float32(100.0) / np.float32(_MAX_IMG - _MIN_IMG))


def image_table(snap) -> torch.Tensor:  # f32 [Is, N]
    """Score of every deduplicated image set on every node."""
    node_imgs = snap.node_images.to(torch.float32)  # [N, I]
    valid = snap.node_valid.to(torch.float32)
    n_real = torch.clamp(valid.sum(), min=1.0)
    spread = (node_imgs * valid[:, None]).sum(dim=0) / n_real  # [I]
    weighted = snap.imgset_sizes * spread[None, :]  # [Is, I]
    have = node_imgs @ weighted.T  # [N, Is]
    clipped = torch.clamp(have, _MIN_IMG, _MAX_IMG)
    return ((clipped - _MIN_IMG) * _RAMP).T.contiguous()


def image_locality_score(snap) -> torch.Tensor:  # f32 [P, N] in [0, 100]
    return labels_ops.take_rows(image_table(snap), snap.pod_imageset, 0.0)
