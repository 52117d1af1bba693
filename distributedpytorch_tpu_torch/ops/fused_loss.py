"""The training loss through K1 forward and K1-bwd backward.

Counterpart of ``distributedpytorch_tpu/ops/fused_loss.py`` (its
``jax.custom_vjp`` ``bce_dice_stats_fused`` and ``fused_bce_dice_loss``).
The four sufficient statistics come from the statistics kernel in one
pass; their gradient with respect to each output element is closed-form,
and the backward kernel computes it in one elementwise pass. What lies
downstream of the four sums (``loss_from_stats``, gradient accumulation's
global cotangent) is ordinary autograd.

The per-shard form for data-parallel training
(``make_sharded_fused_loss``) comes with the DDP slice.
"""

from __future__ import annotations

import torch

from distributedpytorch_tpu_torch.ops.loss_kernels import (
    bce_dice_stats_kernel,
    stats_bwd,
)
from distributedpytorch_tpu_torch.ops.losses import loss_from_stats


class BCEDiceStatsFused(torch.autograd.Function):
    """``losses.bce_dice_stats``'s four sums with an analytic backward.
    On the card the forward is K1 and the backward K1-bwd; on the CPU
    both take their plain versions."""

    @staticmethod
    def forward(ctx, outputs: torch.Tensor, targets: torch.Tensor
                ) -> torch.Tensor:
        ctx.save_for_backward(outputs, targets)
        return bce_dice_stats_kernel(outputs, targets)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        outputs, targets = ctx.saved_tensors
        grad = stats_bwd(outputs, targets, ct.contiguous())
        return grad.to(outputs.dtype), None


def fused_bce_dice_loss(outputs: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    """BCE − log(soft Dice) through the fused statistics."""
    return loss_from_stats(BCEDiceStatsFused.apply(outputs, targets))
