"""Strategies: what differs between ``-t singleGPU`` and ``-t DDP``.

Counterpart of ``Strategy``, ``SingleDevice``, ``MultiProcessMixin``
(strategy.py:558-693), ``DistributedDataParallel`` (:696-716) and
``build_strategy`` (:1046) of ``distributedpytorch_tpu/parallel/strategy.py``.
A strategy answers: which device a process computes on, which samples it
loads, the global batch, the lr, which process writes, how the model is
wrapped and how the training loss is formed.

Each process of the port drives one device, so the JAX mixin's row-based
replica assignment (``_compute_batch_replica_shard``, for meshes whose
data rows span processes) collapses to ``ShardSpec(rank, world)``. DP, MP
and the mesh specs are not ported (ROADMAP.md, Queue A).

Under ``--kernels cuda`` each DDP rank's forward is local to its card, so
the kernels stay engaged as on one device: K1 and K1-bwd per shard inside
the all-reduce of the loss statistics, K1 in eval, and milesial's K2, K3
and K5 fed the global BatchNorm statistics. The JAX DDP keeps eval
metrics and milesial's BatchNorm on XLA instead (strategy.py:472-493,
kernels.py:258-278), because ``pallas_call`` has no GSPMD partition
rule; the two compute the same function.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from distributedpytorch_tpu_torch.data.loader import ShardSpec
from distributedpytorch_tpu_torch.dist import runtime
from distributedpytorch_tpu_torch.dist.collectives import sum_over_ranks_
from distributedpytorch_tpu_torch.ops.fused_loss import (
    fused_bce_dice_loss,
    make_sharded_loss,
)
from distributedpytorch_tpu_torch.ops.losses import bce_dice_loss
from distributedpytorch_tpu_torch.utils.device import resolve_device


class Strategy:
    """One process, one device: the single-device point."""

    name = "base"

    def __init__(self, config, info: Optional[runtime.RuntimeInfo] = None):
        self.config = config
        self.info = info or runtime.RuntimeInfo(
            0, 1, device=resolve_device(config.device))

    @property
    def device(self) -> torch.device:
        return self.info.device

    @property
    def rank(self) -> int:
        return self.info.process_id

    @property
    def world(self) -> int:
        return self.info.num_processes

    @property
    def is_main(self) -> bool:
        """The process that writes checkpoints, loss tables and the .pth."""
        return self.info.is_main

    def data_shard(self) -> ShardSpec:
        """The train loader's shard of each epoch (DistributedSampler)."""
        return ShardSpec(0, 1)

    def eval_shard(self) -> ShardSpec:
        """Whole val batches p, p + world, ... belong to rank p."""
        return ShardSpec(0, 1)

    @property
    def global_batch_size(self) -> int:
        """``config.batch_size`` is per process (torchrun's convention)."""
        return self.config.batch_size

    @property
    def drop_last_train(self) -> bool:
        return False

    def lr_for(self, base_lr: float) -> float:
        return base_lr

    def topology(self) -> dict:
        """What the checkpoint manifest records of the saving run."""
        return {"strategy": self.name, "world": self.world}

    def wrap_model(self, model: torch.nn.Module) -> torch.nn.Module:
        """The module the train step drives (the model itself here)."""
        return model

    def train_loss(self, fused: bool) -> Callable:
        """``loss(preds, target)``: through K1 / K1-bwd when ``fused``."""
        return fused_bce_dice_loss if fused else bce_dice_loss

    #: gradient accumulation's in-place sum over ranks (None: one rank)
    sum_over_ranks: Optional[Callable] = None


class SingleDevice(Strategy):
    """Reference ``-t singleGPU``: the whole model and batch on one
    device."""

    name = "singleGPU"


class MultiProcessMixin:
    """The torchrun contract of the data-parallel strategies: each process
    loads ``ShardSpec(rank, world)``, ``config.batch_size`` is per process
    (global = b × world), and the lr is multiplied by the world size under
    ``ddp_lr_world_size_scaling`` (reference quirk 2,
    train_utils.py:199)."""

    def data_shard(self) -> ShardSpec:
        return ShardSpec(self.rank, self.world)

    def eval_shard(self) -> ShardSpec:
        return ShardSpec(self.rank, self.world)

    @property
    def global_batch_size(self) -> int:
        return self.config.batch_size * self.world

    def lr_for(self, base_lr: float) -> float:
        if self.config.ddp_lr_world_size_scaling:
            return base_lr * self.world
        return base_lr


class DistributedDataParallel(MultiProcessMixin, Strategy):
    """Reference ``-t DDP`` (train_utils.py:170-248): one process per
    device, joined by ``dist.runtime`` (made from torchrun's env when no
    group exists yet). The train loader drops the ragged batch; the loss
    is one loss over the global batch, its four statistics summed over
    ranks before ``loss_from_stats``; ``torch.nn.parallel.
    DistributedDataParallel`` averages the gradients, which with the
    statistics' all-reduce gives the global loss's gradient
    (``dist/collectives.py``); milesial's BatchNorm computes its moments
    over the global batch. Gradient accumulation sums its statistics and
    gradients over the ranks itself. Rank 0 writes."""

    name = "DDP"

    def __init__(self, config, info: Optional[runtime.RuntimeInfo] = None):
        super().__init__(config,
                         info or runtime.initialize_from_env(config.device))

    @property
    def drop_last_train(self) -> bool:
        return True

    def wrap_model(self, model: torch.nn.Module) -> torch.nn.Module:
        from torch.nn.parallel import DistributedDataParallel as DDP

        from distributedpytorch_tpu_torch.models.milesial import BatchNormAct

        for module in model.modules():
            if isinstance(module, BatchNormAct):
                module.global_stats = True
        # the running statistics are computed from global moments, so
        # they are equal on every rank already: nothing to broadcast
        return DDP(model, broadcast_buffers=False,
                   device_ids=([self.device.index]
                               if self.device.type == "cuda" else None))

    def train_loss(self, fused: bool) -> Callable:
        return make_sharded_loss(fused)

    sum_over_ranks = staticmethod(sum_over_ranks_)


STRATEGIES = {cls.name: cls for cls in (SingleDevice,
                                        DistributedDataParallel)}


def build_strategy(config, info: Optional[runtime.RuntimeInfo] = None
                   ) -> Strategy:
    """``config.train_method`` → its strategy. DP, MP and the mesh specs
    raise with the ROADMAP pointer."""
    cls = STRATEGIES.get(config.train_method)
    if cls is None:
        raise ValueError(unported_method_message(config.train_method))
    return cls(config, info)


def unported_method_message(method: str) -> str:
    return (
        f"-t {method} is not ported yet: the PyTorch port trains "
        f"{' and '.join(sorted(STRATEGIES))}; DP, MP and the mesh specs "
        f"are still to port (ROADMAP.md, Queue A)"
    )
