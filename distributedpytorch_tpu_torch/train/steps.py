"""The train and eval steps of the single-device trainer.

Counterpart of ``distributedpytorch_tpu/train/steps.py``
(``make_train_step``, ``make_accum_train_step``, ``make_eval_step``):

* forward → BCE − log(soft Dice) on the sigmoid probabilities; the
  backward runs on ``batch_size × loss`` while the returned loss is the
  unscaled one (the reference's ``(batch_size * loss).backward()``,
  behind ``faithful_loss_scaling``);
* masks arrive as integer ``(B, H, W)`` and become a ``(B, H, W, 1)``
  float32 target;
* under a kernel policy with ``train_loss_fused`` the loss runs through
  the statistics kernel and its backward (``ops/fused_loss.py``), and
  with ``eval_stats_fused`` the eval step's loss and Dice come from one
  statistics-kernel pass;
* the train step runs the model in train mode and the eval step in eval
  mode, so a stateful model (milesial's BatchNorm) trains on batch
  statistics, moving its running averages, and evaluates with the
  running averages, as the JAX package's stateful steps do.

A step takes a batch already on the model's device and returns the loss
as a 0-d tensor there: nothing in a step waits for the card.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from distributedpytorch_tpu_torch.ops.fused_loss import (
    BCEDiceStatsFused,
    fused_bce_dice_loss,
)
from distributedpytorch_tpu_torch.ops.loss_kernels import eval_metrics
from distributedpytorch_tpu_torch.ops.losses import (
    bce_dice_loss,
    bce_dice_stats,
    dice_coefficient,
    loss_from_stats,
)
from distributedpytorch_tpu_torch.ops.precision import LOSS_DTYPE

Batch = Dict[str, torch.Tensor]


def prep_mask(mask: torch.Tensor) -> torch.Tensor:
    """``(B, H, W)`` integer mask → ``(B, H, W, 1)`` float32 target (the
    reference's ``unsqueeze(1)`` + ``float``, channel-last here)."""
    return mask.unsqueeze(-1).to(LOSS_DTYPE)


def is_stateful_model(model: torch.nn.Module) -> bool:
    """Models with running statistics (milesial's BatchNorm) declare
    ``is_stateful = True``."""
    return bool(getattr(model, "is_stateful", False))


def make_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    batch_size: int,
    faithful_loss_scaling: bool = True,
    train_loss_fused: bool = False,
) -> Callable[[Batch], torch.Tensor]:
    """``step(batch) -> unscaled loss``: forward, loss, backward, Adam."""
    grad_scale = float(batch_size) if faithful_loss_scaling else 1.0
    loss_impl = fused_bce_dice_loss if train_loss_fused else bce_dice_loss

    def train_step(batch: Batch) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        preds = model(batch["image"])
        loss = loss_impl(preds, prep_mask(batch["mask"]))
        (loss * grad_scale if grad_scale != 1.0 else loss).backward()
        optimizer.step()
        return loss.detach()

    return train_step


def make_accum_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    batch_size: int,
    chunks: int,
    faithful_loss_scaling: bool = True,
    train_loss_fused: bool = False,
) -> Callable[[List[Batch]], torch.Tensor]:
    """One optimizer step over ``chunks`` batches with one batch's
    activations alive at a time, exact for the log-Dice loss, which does
    not add up over chunks:

    * pass 1 sums the four loss statistics over the chunks, forward only;
    * the loss and its cotangent ``ct = ∇loss_from_stats(Σ stats)`` follow
      from the sum, a 4-vector known only after every chunk;
    * pass 2 runs each chunk's forward again and back-propagates ``ct``
      from its statistics, so each chunk's backward sees the global
      cotangent; the gradients add up in the float32 ``.grad``.

    Under ``train_loss_fused`` the statistics come from
    ``BCEDiceStatsFused``, so pass 2 drives the backward kernel with a
    cotangent that no single chunk produced. The faithful scale is the
    effective batch, ``batch_size × chunks``. Stateful models (BatchNorm)
    are refused, as in the JAX package."""
    if is_stateful_model(model):
        raise ValueError(
            "gradient accumulation supports stateless models only "
            "(BatchNorm statistics are not chunk-decomposable); use a "
            "data-parallel strategy for large effective batches"
        )
    grad_scale = (float(batch_size * chunks) if faithful_loss_scaling
                  else 1.0)
    stats_fn = BCEDiceStatsFused.apply if train_loss_fused else bce_dice_stats
    params = [p for p in model.parameters() if p.requires_grad]

    def chunk_stats(chunk: Batch) -> torch.Tensor:
        model.train()
        return stats_fn(model(chunk["image"]), prep_mask(chunk["mask"]))

    def accum_step(stack: List[Batch]) -> torch.Tensor:
        if len(stack) != chunks:
            raise ValueError(
                f"stack carries {len(stack)} chunks but this step was built "
                f"for grad_accum={chunks}"
            )
        with torch.no_grad():
            stats = torch.zeros(4, dtype=LOSS_DTYPE,
                                device=stack[0]["image"].device)
            for chunk in stack:
                stats = stats + chunk_stats(chunk)
        stats.requires_grad_(True)
        loss = loss_from_stats(stats)
        (ct,) = torch.autograd.grad(loss, stats)
        optimizer.zero_grad(set_to_none=True)
        for chunk in stack:
            chunk_stats(chunk).backward(ct)
        if grad_scale != 1.0:
            torch._foreach_mul_(
                [p.grad for p in params if p.grad is not None], grad_scale
            )
        optimizer.step()
        return loss.detach()

    return accum_step


def make_eval_step(model: torch.nn.Module, eval_stats_fused: bool = False
                   ) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """``step(batch) -> {'loss', 'dice'}`` as 0-d tensors on the device:
    the per-batch BCE − log(soft Dice) and the hard Dice at 0.5."""

    @torch.no_grad()
    def eval_step(batch: Batch) -> Dict[str, torch.Tensor]:
        model.eval()
        preds = model(batch["image"])
        target = prep_mask(batch["mask"])
        if eval_stats_fused:
            return eval_metrics(preds, target)
        return {"loss": bce_dice_loss(preds, target),
                "dice": dice_coefficient(preds, target)}

    return eval_step
