"""Validation pass: the mean of per-batch loss and hard Dice.

Counterpart of ``distributedpytorch_tpu/evaluate.py`` (``evaluate``). The
per-batch metrics stay 0-d tensors on the device and come to the host in
chunks: one copy per metric per batch would wait on the card every batch,
and none at all would let the host run the whole val set ahead of it.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

#: Val batches per device-to-host pull.
CHUNK = 8


def evaluate(eval_step: Callable, loader, place_batch: Callable
             ) -> Tuple[float, float]:
    """``(mean val loss, mean val dice)`` over ``loader``'s batches, each
    placed with ``place_batch``; NaN for an empty loader."""
    pulled, pending = [], []
    for batch in loader.epoch_batches():
        metrics = eval_step(place_batch(batch))
        pending.append(torch.stack([metrics["loss"], metrics["dice"]]))
        if len(pending) == CHUNK:
            pulled.append(torch.stack(pending).cpu().numpy())
            pending = []
    if pending:
        pulled.append(torch.stack(pending).cpu().numpy())
    if not pulled:
        return float("nan"), float("nan")
    metrics = np.concatenate(pulled)
    return float(np.mean(metrics[:, 0])), float(np.mean(metrics[:, 1]))
