"""The training loss through K1 forward and K1-bwd backward.

Counterpart of ``distributedpytorch_tpu/ops/fused_loss.py`` (its
``jax.custom_vjp`` ``bce_dice_stats_fused`` and ``fused_bce_dice_loss``).
The four sufficient statistics come from the statistics kernel in one
pass; their gradient with respect to each output element is closed-form,
and the backward kernel computes it in one elementwise pass. What lies
downstream of the four sums (``loss_from_stats``, gradient accumulation's
global cotangent, DDP's sum over ranks) is ordinary autograd.

``make_sharded_loss`` is the data-parallel form, the counterpart of
``make_sharded_fused_loss`` (fused_loss.py:91-117): the statistics of
each rank's shard, summed over ranks, then ``loss_from_stats``.

``make_row_sharded_loss`` is the loss of row shards on several devices
of one process (``-t SP``, and each rank of ``-t DDP_SP``,
``parallel/spatial.py``): K1 per shard, the sums added in shard order on
the first device (``make_row_sharded_stats``, and over the ranks under
DDP_SP), the loss once, and K1-bwd per shard on the cotangent copied
back.

``stats_function`` and ``loss_and_cotangent`` serve the paths that sum
the statistics of several slices of the batch before one loss: gradient
accumulation's chunks and the pipeline's microbatches (under ``-t
DDP_MP`` summed over the data ranks too, ``parallel/pipeline.py``, so K1
and K1-bwd run per microbatch inside that sum). Where a slice's
backward runs apart from the loss (accumulation's second pass, 1f1b's
backward ticks) it is fed the global loss's cotangent with respect to the
four sums.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from distributedpytorch_tpu_torch.dist.collectives import all_reduce_sum
from distributedpytorch_tpu_torch.ops.loss_kernels import (
    bce_dice_stats_kernel,
    stats_bwd,
)
from distributedpytorch_tpu_torch.ops.losses import (
    bce_dice_stats,
    loss_from_stats,
)
from distributedpytorch_tpu_torch.utils.device import copy_all_to


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


def stats_function(fused: bool) -> Callable:
    """``stats(outputs, targets)``, the four sums of one slice of the
    batch: ``BCEDiceStatsFused`` when ``fused`` (K1 forward, K1-bwd
    backward on the card), else the plain ``bce_dice_stats``."""
    return BCEDiceStatsFused.apply if fused else bce_dice_stats


def loss_and_cotangent(stats: torch.Tensor, scale: float = 1.0):
    """``(loss, ct)`` of summed statistics: the loss of the whole batch
    (detached) and ``ct = ∇(scale · loss_from_stats)`` at ``stats``, the
    4-vector every slice's backward is fed."""
    stats = stats.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = loss_from_stats(stats)
        (ct,) = torch.autograd.grad(loss * scale if scale != 1.0 else loss,
                                    stats)
    return loss.detach(), ct


def make_sharded_loss(fused: bool) -> Callable:
    """``loss(outputs, targets)`` of a data-parallel rank: one loss over
    the global batch, the same on every rank. The shard's four statistics
    come from ``BCEDiceStatsFused`` when ``fused`` (K1 forward and K1-bwd
    backward on the card, per shard) and from the plain
    ``bce_dice_stats`` otherwise; ``all_reduce_sum`` adds them over the
    ranks before ``loss_from_stats``, since log-Dice does not add up over
    shards. Its backward sums the cotangent over ranks, so each rank's
    gradient comes out ``world ×`` its share, which DDP's averaging
    undoes (``dist/collectives.py``)."""
    stats_fn = stats_function(fused)

    def loss(outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        return loss_from_stats(all_reduce_sum(stats_fn(outputs, targets)))

    return loss


def shard_targets(shards: Sequence[torch.Tensor],
                  targets: torch.Tensor) -> List[torch.Tensor]:
    """``targets`` (B, H, W, 1) cut into the shards' rows, each contiguous
    on its shard's device."""
    return [t.contiguous().to(p.device, non_blocking=True)
            for p, t in zip(shards, targets.chunk(len(shards), dim=1))]


def sum_on_first(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``parts`` copied to the first one's device and added in order, one
    node a copy (``copy_all_to``), so the sum is the same whatever order
    the devices finish in."""
    parts = copy_all_to(list(parts), parts[0].device)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def make_row_sharded_stats(fused: bool) -> Callable:
    """``stats(shards, targets)``, the four sums of row shards
    (``parallel/spatial.py``): ``shards`` the NHWC predictions, shard by
    shard, each on its device, ``targets`` the whole batch's on the
    first. Each shard's four statistics come from ``BCEDiceStatsFused``
    when ``fused`` (K1 forward and K1-bwd backward on each shard's card)
    and from the plain ``bce_dice_stats`` otherwise; they add in shard
    order on the first device, and autograd copies their cotangent back
    to every shard. Gradient accumulation's chunks take them as they are
    (``train/steps.make_accum_train_step``)."""
    stats_fn = stats_function(fused)

    def stats(shards: Sequence[torch.Tensor],
              targets: torch.Tensor) -> torch.Tensor:
        return sum_on_first([stats_fn(p, t) for p, t in
                             zip(shards, shard_targets(shards, targets))])

    return stats


def make_row_sharded_loss(fused: bool, over_ranks: bool = False
                          ) -> Callable:
    """``loss(shards, targets)`` of row shards: their four statistics
    (``make_row_sharded_stats``), with ``over_ranks`` (``-t DDP_SP``)
    summed over the ranks (``all_reduce_sum``), then one
    ``loss_from_stats``. Under ``over_ranks`` each rank's gradient comes
    out ``world ×`` its share, as ``make_sharded_loss``'s does, and the
    strategy's mean of the gradients over the ranks takes the factor
    out."""
    stats_fn = make_row_sharded_stats(fused)

    def loss(shards: Sequence[torch.Tensor],
             targets: torch.Tensor) -> torch.Tensor:
        stats = stats_fn(shards, targets)
        if over_ranks:
            stats = all_reduce_sum(stats)
        return loss_from_stats(stats)

    return loss
