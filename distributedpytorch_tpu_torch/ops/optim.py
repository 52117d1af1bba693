"""Adam with the reference's settings and a learning rate the plateau
scheduler changes between epochs.

Counterpart of ``distributedpytorch_tpu/ops/optim.py``. The reference
optimizes with ``optim.Adam(params, lr, weight_decay=1e-8)``: L2 folded
into the gradient before the moment updates, which is what the JAX
package's ``adam_l2`` chain (``add_decayed_weights`` → ``scale_by_adam``
→ ``-lr``) reproduces and ``torch.optim.Adam`` is.
"""

from __future__ import annotations

from typing import Iterable

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   learning_rate: float,
                   weight_decay: float = 1e-8) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])
