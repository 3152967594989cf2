"""Loss primitives (PyTorch port of ``egtr_tpu/ops/losses.py``).

Equivalents of the reference's ``model/util.py`` loss helpers, elementwise
and mask-friendly so batched, padded targets go through one step.
"""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    """Elementwise binary cross-entropy on logits (stable), written out as
    the JAX package writes it: max(x,0) - x*z + log(1+exp(-|x|))."""
    return (logits.clamp(min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal_loss_elementwise(logits: torch.Tensor,
                                   targets: torch.Tensor,
                                   alpha: float = 0.25, gamma: float = 2.0
                                   ) -> torch.Tensor:
    """Elementwise focal loss. Reference: model/util.py:28-60 (pre-reduction)."""
    prob = torch.sigmoid(logits)
    ce = bce_with_logits(logits, targets)
    p_t = prob * targets + (1.0 - prob) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
        loss = alpha_t * loss
    return loss


def sigmoid_focal_loss(logits, targets, num_boxes, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Reference reduction ``loss.mean(1).sum() / num_boxes``
    (model/util.py:59); callers scale by Q where the reference does."""
    loss = sigmoid_focal_loss_elementwise(logits, targets, alpha, gamma)
    return loss.mean(dim=1).sum() / num_boxes


def dice_loss(logits, targets, num_boxes) -> torch.Tensor:
    """Reference: model/util.py:9-25."""
    inputs = torch.sigmoid(logits)
    inputs = inputs.reshape(inputs.shape[0], -1)
    targets = targets.reshape(targets.shape[0], -1)
    numerator = 2 * (inputs * targets).sum(dim=1)
    denominator = inputs.sum(dim=-1) + targets.sum(dim=-1)
    loss = 1 - (numerator + 1) / (denominator + 1)
    return loss.sum() / num_boxes
