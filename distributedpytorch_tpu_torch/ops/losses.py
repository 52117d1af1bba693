"""Segmentation loss: BCE − log(soft Dice), and the hard Dice metric.

Counterpart of ``distributedpytorch_tpu/ops/losses.py``, formula for
formula::

    loss = BCE(outputs, t_b) - log(2 sum(outputs t_b)
                                   / (sum(outputs) + sum(t_b) + eps))

with ``eps = 1e-15`` and ``t_b = [targets == 1]``. BCE follows
``torch.nn.BCELoss``: mean reduction, logs clamped at -100. Everything
computes in float32 (``LOSS_DTYPE``) whatever the inputs.
"""

from __future__ import annotations

import torch

from distributedpytorch_tpu_torch.ops.precision import LOSS_DTYPE

EPS = 1e-15
_LOG_CLAMP = -100.0
# Below this, x counts as saturated: the value clamps to -100 and the
# gradient is 0. The float32 minimum normal, the smallest x whose 1/x is
# still finite.
_LOG_SAFE_MIN = 1.1754944e-38


def _clamped_log(x: torch.Tensor) -> torch.Tensor:
    """log(x) clamped at -100, grad-safely.

    ``max(log x, -100)`` has the right value but a NaN gradient at
    x == 0 (0 · inf), and one saturated pixel (p exactly 0 or 1) would
    then NaN the whole gradient. The where on both sides keeps every
    intermediate finite: saturated pixels take the clamped value and an
    exactly zero gradient."""
    safe = torch.clamp(x, min=_LOG_SAFE_MIN)
    return torch.where(x >= _LOG_SAFE_MIN, torch.log(safe), _LOG_CLAMP)


def binary_cross_entropy(outputs: torch.Tensor,
                         targets: torch.Tensor) -> torch.Tensor:
    """``torch.nn.BCELoss()`` semantics: mean over all elements, clamped
    logs."""
    outputs = outputs.to(LOSS_DTYPE)
    targets = targets.to(LOSS_DTYPE)
    per_elem = -(targets * _clamped_log(outputs)
                 + (1.0 - targets) * _clamped_log(1.0 - outputs))
    return per_elem.mean()


def soft_dice(outputs: torch.Tensor, targets: torch.Tensor,
              eps: float = EPS) -> torch.Tensor:
    """2·|o∩t| / (|o| + |t| + eps) over the whole batch."""
    outputs = outputs.to(LOSS_DTYPE)
    targets = targets.to(LOSS_DTYPE)
    intersection = (outputs * targets).sum()
    union = outputs.sum() + targets.sum()
    return 2.0 * intersection / (union + eps)


def bce_dice_loss(outputs: torch.Tensor, targets: torch.Tensor,
                  dice_weight: float = 1.0) -> torch.Tensor:
    """BCE − dice_weight · log(soft Dice), targets binarized by ``== 1``."""
    targets_bin = (targets == 1).to(LOSS_DTYPE)
    bce = binary_cross_entropy(outputs, targets_bin)
    dice = soft_dice(outputs, targets_bin)
    return bce - dice_weight * _clamped_log(dice)


def bce_dice_stats(outputs: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    """Sufficient statistics of the loss over a slice of the batch,
    ``[bce_sum, count, intersection, output_sum + target_sum]``. They add
    up over chunks, so gradient accumulation sums them and calls
    ``loss_from_stats`` once: the log-Dice term is a ratio of
    whole-batch sums."""
    outputs = outputs.to(LOSS_DTYPE)
    targets_bin = (targets == 1).to(LOSS_DTYPE)
    per_elem = -(targets_bin * _clamped_log(outputs)
                 + (1.0 - targets_bin) * _clamped_log(1.0 - outputs))
    count = torch.full((), outputs.numel(), dtype=LOSS_DTYPE,
                       device=outputs.device)
    return torch.stack([
        per_elem.sum(),
        count,
        (outputs * targets_bin).sum(),
        outputs.sum() + targets_bin.sum(),
    ])


def loss_from_stats(stats: torch.Tensor, dice_weight: float = 1.0,
                    eps: float = EPS) -> torch.Tensor:
    """Combine (accumulated) ``bce_dice_stats`` into the scalar loss."""
    bce = stats[0] / stats[1]
    dice = 2.0 * stats[2] / (stats[3] + eps)
    return bce - dice_weight * _clamped_log(dice)


def dice_coefficient(outputs: torch.Tensor, targets: torch.Tensor,
                     threshold: float = 0.5, eps: float = 1e-7
                     ) -> torch.Tensor:
    """Hard Dice of the thresholded predictions, the val metric."""
    preds = (outputs.to(LOSS_DTYPE) >= threshold).to(LOSS_DTYPE)
    targets_bin = (targets == 1).to(LOSS_DTYPE)
    intersection = (preds * targets_bin).sum()
    union = preds.sum() + targets_bin.sum()
    return (2.0 * intersection + eps) / (union + eps)
