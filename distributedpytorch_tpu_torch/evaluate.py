"""Validation pass: the mean of per-batch loss and hard Dice.

Counterpart of ``distributedpytorch_tpu/evaluate.py`` (``evaluate``,
``evaluate_sharded``). The per-batch metrics stay 0-d tensors on the device and come to the host in
chunks: one copy per metric per batch would wait on the card every batch,
and none at all would let the host run the whole val set ahead of it.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from distributedpytorch_tpu_torch.data.loader import ShardSpec

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


def evaluate_sharded(eval_step: Callable, loader, place_batch: Callable,
                     shard: ShardSpec) -> Tuple[float, float]:
    """Data-parallel evaluation (evaluate.py:67-139): each rank computes
    1/world of the val set and every rank returns the same ``(mean
    loss, mean dice)``, equal to ``evaluate``'s over the same weights.

    The batches are ``evaluate``'s (consecutive slices of the val order).
    Rank p runs whole batches p, p + world, ... through its local
    ``eval_step``; one all-gather of the per-batch metric rows puts them
    back in batch order on every rank, so the plateau scheduler steps in
    lockstep. The tail of fewer than ``world`` batches runs on every rank,
    so no rank waits in a collective another skips. ``shard.world == 1``
    is ``evaluate``."""
    from distributedpytorch_tpu_torch.dist.collectives import all_gather_rows

    w, rank = shard.world, shard.rank
    if w == 1:
        return evaluate(eval_step, loader, place_batch)
    b = loader.batch_size
    slices = loader.batch_slices()
    full = [s for s in slices if len(s) == b]
    groups = len(full) // w
    tail = full[groups * w:] + slices[len(full):]

    def metrics_of(idx) -> torch.Tensor:
        m = eval_step(place_batch(loader.load_slice(idx)))
        return torch.stack([m["loss"], m["dice"]])

    rows = []
    if groups:
        mine = torch.stack([metrics_of(full[g * w + rank])
                            for g in range(groups)])
        # (world, groups, 2) -> batch order: group-major, then rank
        rows.append(all_gather_rows(mine).transpose(0, 1).reshape(-1, 2)
                    .cpu().numpy())
    if tail:
        rows.append(torch.stack([metrics_of(idx) for idx in tail])
                    .cpu().numpy())
    if not rows:
        return float("nan"), float("nan")
    metrics = np.concatenate(rows)
    return float(np.mean(metrics[:, 0])), float(np.mean(metrics[:, 1]))
