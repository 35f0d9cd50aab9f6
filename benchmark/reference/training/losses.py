"""SOLVER.LOSS dispatch with torch's default reductions (counterpart of
``bihome_tpu/training/losses.py:24-48``).

Tensor losses (MSELoss / L1Loss / SmoothL1Loss, 'mean' over all elements)
apply to the head's (ground_truth, network_output); 'CosineDistance' is
sum(1 - cos_sim) over the channel axis (last for NHWC feature maps, 1
otherwise); the self-computed losses pass the head's scalar through.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

TENSOR_LOSSES = ('MSELoss', 'L1Loss', 'SmoothL1Loss', 'CosineDistance')
SELF_LOSSES = ('TripletLoss', 'iHomE', 'biHomE')


def compute_loss(loss_name: str, head_out: Dict[str, Any]) -> torch.Tensor:
    if loss_name in SELF_LOSSES:
        return head_out['loss']
    gt = head_out.get('ground_truth')
    out = head_out.get('network_output')
    if loss_name == 'MSELoss':
        return torch.mean((gt - out) ** 2)
    if loss_name == 'L1Loss':
        return torch.mean(torch.abs(gt - out))
    if loss_name == 'SmoothL1Loss':
        diff = gt - out
        adiff = diff.abs()
        return torch.mean(torch.where(adiff < 1.0, 0.5 * diff * diff,
                                      adiff - 0.5))
    if loss_name == 'CosineDistance':
        dim = -1 if gt.dim() == 4 else 1
        num = (gt * out).sum(dim)
        den = (torch.linalg.vector_norm(gt, dim=dim)
               * torch.linalg.vector_norm(out, dim=dim)).clamp_min(1e-8)
        return torch.sum(1.0 - num / den)
    raise ValueError(f'Do not know the loss: {loss_name}')
