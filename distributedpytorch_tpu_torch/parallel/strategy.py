"""Strategies: what differs between ``-t singleGPU``, ``DP``, ``DDP``,
``MP``, ``DDP_MP``, ``SP`` and ``DDP_SP``.

Counterpart of ``Strategy``, ``SingleDevice``, ``DataParallel``
(strategy.py:542-555), ``MultiProcessMixin`` (:558-693),
``DistributedDataParallel`` (:696-716), ``Pipeline`` (:719-736),
``HybridDataPipeline`` (:739-780), ``SpatialParallel`` (:783-808),
``HybridDataSpatial`` (:811-843) and ``build_strategy`` (:1046) of
``distributedpytorch_tpu/parallel/strategy.py``.
A strategy answers: which devices a process computes on, which samples it
loads, the global batch, the lr, which process writes, where the model's
layers live, and the train and eval steps.

Each process of the port drives one device under DDP and one data row
(its S stages) under DDP_MP, so the JAX mixin's row-based replica
assignment (``_compute_batch_replica_shard``, for meshes whose data rows
span processes) collapses to ``ShardSpec(rank, world)``. DP and MP are
one process over a list of devices (``devices``, which may repeat one:
the CPU tests run ``[cpu, cpu]``, a one-card check ``[cuda:0,
cuda:0]``); so is each DDP_MP rank, and SP over its shards' devices,
and each DDP_SP rank. The mesh specs, TP and FSDP are not ported
(ROADMAP.md, Queue A).

Under ``--kernels cuda`` each DDP rank's forward is local to its card, so
the kernels stay engaged as on one device: K1 and K1-bwd per shard inside
the all-reduce of the loss statistics, K1 in eval, and milesial's K2, K3
and K5 fed the global BatchNorm statistics. The JAX DDP keeps eval
metrics and milesial's BatchNorm on XLA instead (strategy.py:472-493,
kernels.py:258-278), because ``pallas_call`` has no GSPMD partition
rule; the two compute the same function. The port's DP and MP run the
kernels the same way: under MP K1 and K1-bwd per microbatch on the last
stage and K2, K3, K5 inside the stages, as the JAX MP does; under DP each
replica's forward is local to its device (the JAX DP keeps XLA BatchNorm
and XLA eval metrics there). Under DDP_MP each rank's pipeline runs them
as MP does, K1 and K1-bwd per microbatch inside the data ranks' sum of
the statistics, and K2 and K3 fed each microbatch's local moments. Under
SP and DDP_SP each row shard runs K1 and K1-bwd on its card, inside the
shards' (and the ranks') sum of the statistics, K1 in eval, and
milesial's K2, K3 and K5 fed the whole batch's moments (the JAX SP keeps
XLA eval metrics and XLA BatchNorm there).

The run control (``check_run_control``): ``--remat`` recomputes the
forward of the step (singleGPU, DDP, ``--grad-accum``), of each stage
(MP, DDP_MP, both schedules), of each DP replica or of each SP row shard
in its backward; a replica's or shard's recompute normalizes with the
BatchNorm moments the replicas met on in its forward and a shard's convs
take the halo rows they kept: neither meets again. ``--steps-per-dispatch
K > 1`` (one CUDA graph of K steps, ``build_multi_train_step``, from the
trainer's own train step) runs under every strategy, DP's replica and
SP's shard threads included, and is refused under a gloo group on a
card. ``--grad-accum`` runs outside the pipelines for the stateless
UNet; under SP and DDP_SP each chunk's statistics are the shards' sums
(``accum_stats``). What stays refused, with the JAX package's words:
``--grad-accum`` of milesial and together with ``--steps-per-dispatch
K > 1``. ``--dtype bf16_params`` runs under
every strategy; under DDP the gradients are averaged over the ranks in
``REDUCE_DTYPE`` and rounded to bf16 once (``_allreduce_master_grads``),
which is where the compiled JAX DDP step sums them too (its gradient
all-reduce is float32 on the CPU mesh), and DDP_MP's stage gradients are
reduced as the f32 master gradients. Where one backward adds several uses
of a parameter (gpipe's microbatches, DP's replicas, SP's shards) each
use computes
with its own cast of the f32 master (``ops/precision.PerUseCasts``), so
the uses add in f32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from distributedpytorch_tpu_torch.data.loader import ShardSpec
from distributedpytorch_tpu_torch.dist import runtime
from distributedpytorch_tpu_torch.dist.collectives import sum_over_ranks_
from distributedpytorch_tpu_torch.models import rematerialized
from distributedpytorch_tpu_torch.ops.fused_loss import (
    fused_bce_dice_loss,
    make_row_sharded_loss,
    make_row_sharded_stats,
    make_sharded_loss,
)
from distributedpytorch_tpu_torch.ops.losses import bce_dice_loss
from distributedpytorch_tpu_torch.ops.precision import (
    REDUCE_DTYPE,
    get_policy,
    has_master_weights,
    optimizer_grads,
    per_use_casts,
)
from distributedpytorch_tpu_torch.parallel.pipeline import (
    PIPELINE_SCHEDULES,
    build_stages,
    make_pipeline_eval_step,
    make_pipeline_train_step,
)
from distributedpytorch_tpu_torch.parallel.replicas import Replicated
from distributedpytorch_tpu_torch.parallel.spatial import RowSharded
from distributedpytorch_tpu_torch.train.steps import (
    STACKS_CONFLICT,
    STATEFUL_ACCUM,
    make_accum_train_step,
    make_eval_step,
    make_multi_train_step,
    make_train_step,
)
from distributedpytorch_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def local_devices(device) -> List[torch.device]:
    """The devices one process may use: every visible card for ``cuda``
    (or the one named, ``cuda:N``), the one CPU for ``cpu``."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _shrunk_data_degree(name: str, batch_size: int, n_devices: int) -> int:
    """Largest data degree <= n_devices dividing the batch, warning when
    devices are left idle (JAX strategy.py:89-108)."""
    n = n_devices
    while batch_size % n:
        n -= 1
    if n != n_devices:
        logger.warning(
            "%s: batch size %d does not divide the %d available devices "
            "— data mesh shrunk to %d device(s); %d idle. torch "
            "DataParallel would scatter unevenly instead; here the "
            "batch must divide the mesh. Use a batch size divisible by "
            "the device count to engage every device.",
            name, batch_size, n_devices, n, n_devices - n,
        )
    return n


class Strategy:
    """One process, one device: the single-device point."""

    name = "base"

    def __init__(self, config, info: Optional[runtime.RuntimeInfo] = None,
                 devices: Optional[Sequence[torch.device]] = None):
        self.config = config
        self.info = info or runtime.RuntimeInfo(
            0, 1, device=(torch.device(devices[0]) if devices
                          else resolve_device(config.device)))

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

    def mesh_shape(self) -> dict:
        """The JAX strategy's mesh axes for this run (``data``, ``stage``),
        as the manifest's ``topology.mesh`` records them; none for one
        device."""
        return {}

    def wrap_model(self, model: torch.nn.Module,
                   optimizer=None) -> torch.nn.Module:
        """The module the train step of ``optimizer`` drives: the model
        itself, recomputed in the backward under ``--remat``."""
        return rematerialized(model, self.config.remat)

    def train_loss(self, fused: bool) -> Callable:
        """``loss(preds, target)``: through K1 / K1-bwd when ``fused``."""
        return fused_bce_dice_loss if fused else bce_dice_loss

    #: gradient accumulation's in-place sum over ranks (None: one rank)
    sum_over_ranks: Optional[Callable] = None

    def place_model(self, model: torch.nn.Module) -> torch.nn.Module:
        """The model with its layers on their devices."""
        return model.to(self.device)

    def build_train_step(self, model, optimizer, kernels) -> Callable:
        """``step(batch) -> loss`` of one optimizer step (train/steps.py);
        the faithful scale is the per-process ``batch_size``
        (strategy.py:303-314)."""
        return make_train_step(
            self.wrap_model(model, optimizer), optimizer,
            self.config.batch_size,
            self.config.faithful_loss_scaling,
            loss_impl=self.train_loss(kernels.train_loss_fused))

    def build_accum_train_step(self, model, optimizer, kernels) -> Callable:
        """One optimizer step over ``config.grad_accum`` batches of
        ``accum_module``'s chunks, each chunk's statistics from
        ``accum_stats``."""
        module, remat = self.accum_module(model, optimizer)
        return make_accum_train_step(
            module, optimizer, self.config.batch_size,
            self.config.grad_accum, self.config.faithful_loss_scaling,
            kernels.train_loss_fused, sum_over_ranks=self.sum_over_ranks,
            remat=remat,
            stats_impl=self.accum_stats(kernels.train_loss_fused))

    def accum_stats(self, fused: bool) -> Optional[Callable]:
        """Gradient accumulation's four statistics of a chunk's predictions
        (None: one device's, through K1 / K1-bwd when ``fused``)."""
        return None

    def accum_module(self, model: torch.nn.Module, optimizer
                     ) -> Tuple[torch.nn.Module, bool]:
        """The module gradient accumulation runs each chunk through, and
        whether the step recomputes that chunk's forward in its backward:
        the model itself under ``--remat`` (its ranks' sum is
        ``sum_over_ranks``)."""
        return model, self.config.remat

    #: eager steps ``MultiStep`` runs before it captures K steps
    capture_warmup_steps = 1
    #: a stream per device that ``MultiStep`` must warm up and capture
    #: on, where the strategy built state on it (DDP)
    capture_streams: dict = {}

    @property
    def step_devices(self) -> List[torch.device]:
        """The devices one train step computes on, the batch's first."""
        return list(getattr(self, "devices", [self.device]))

    @property
    def backend(self) -> Optional[str]:
        """The process group's backend where the steps talk over one."""
        return None

    def build_multi_train_step(self, train_step: Callable) -> Callable:
        """``multi(stacked) -> (K,) losses``: ``steps_per_dispatch`` calls
        of ``train_step`` per call, one CUDA graph of them on the card
        (``train/steps.MultiStep``). ``train_step`` is the one the
        trainer holds and runs the epoch's tail with, so both drive one
        DDP wrapper and one pipeline step (``check_run_control`` keeps
        gloo on a card out)."""
        return make_multi_train_step(
            train_step, self.config.steps_per_dispatch, self.step_devices,
            warmup_steps=self.capture_warmup_steps,
            streams=self.capture_streams)

    def build_eval_step(self, model, kernels) -> Callable:
        """``step(batch) -> {'loss', 'dice'}`` on this process's device."""
        return make_eval_step(model, kernels.eval_stats_fused)


class SingleDevice(Strategy):
    """Reference ``-t singleGPU``: the whole model and batch on one
    device."""

    name = "singleGPU"


class DataParallel(Strategy):
    """Reference ``-t DP`` (``torch.nn.DataParallel``, train_utils.py:98):
    one process, the batch split over the local devices
    (``parallel/replicas.py``). ``config.batch_size`` is the global batch,
    the lr is not scaled, the train loader drops the ragged batch, and
    the device count shrinks until it divides the batch, with the JAX
    package's warning (``_shrunk_data_degree``). The loss is one loss over
    the global batch on the first device (K1 and K1-bwd there under
    ``--kernels cuda``); each replica's forward runs its own epilogue
    kernels, and milesial's BatchNorm normalizes with the moments of the
    whole batch, as GSPMD computes them for the JAX DP. ``--remat``
    recomputes each replica's forward, and ``--steps-per-dispatch K``
    captures K steps, the replica threads' launches on every card
    included, with the defaults of ``MultiStep``: one eager stack before
    the capture builds Adam's moments, K1's workspace and the cuDNN
    handles the replica threads take from the pool, and the replicas
    run on the multi-step's streams, which the caller makes current."""

    name = "DP"

    def __init__(self, config, info: Optional[runtime.RuntimeInfo] = None,
                 devices: Optional[Sequence[torch.device]] = None):
        devs = ([torch.device(d) for d in devices] if devices is not None
                else local_devices(config.device))
        n = _shrunk_data_degree(self.name, config.batch_size, len(devs))
        self.devices = devs[:n]
        # one process: its device is the first of the list
        super().__init__(config, None, self.devices)

    @property
    def drop_last_train(self) -> bool:
        return True

    def topology(self) -> dict:
        return {"strategy": self.name, "world": self.world,
                "devices": len(self.devices)}

    def mesh_shape(self) -> dict:
        return {"data": len(self.devices)}

    def wrap_model(self, model: torch.nn.Module,
                   optimizer=None) -> torch.nn.Module:
        """The replicas, each recomputed in the backward under
        ``--remat``; under master weights each computes with its own cast
        of ``optimizer``'s f32 masters."""
        return Replicated(model, self.devices,
                          per_use_casts(optimizer, model),
                          remat=self.config.remat)

    def accum_module(self, model, optimizer):
        """The replicas, which recompute themselves under ``--remat``."""
        return self.wrap_model(model, optimizer), False

    def build_eval_step(self, model, kernels) -> Callable:
        return make_eval_step(self.wrap_model(model),
                              kernels.eval_stats_fused)


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

    @property
    def backend(self) -> Optional[str]:
        return dist.get_backend() if dist.is_initialized() else None


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
    # DDP's reducer times its first 10 iterations with CUDA events read
    # on the host, which a capture cannot hold (PyTorch's notes on CUDA
    # graphs with DDP ask for 11 eager iterations)
    capture_warmup_steps = 11

    def __init__(self, config, info: Optional[runtime.RuntimeInfo] = None,
                 devices: Optional[Sequence[torch.device]] = None):
        super().__init__(config, info or runtime.initialize_from_env(
            devices[0] if devices else config.device))

    @property
    def drop_last_train(self) -> bool:
        return True

    def mesh_shape(self) -> dict:
        return {"data": self.world}

    def wrap_model(self, model: torch.nn.Module,
                   optimizer=None) -> torch.nn.Module:
        """The DDP-wrapped model; under master weights its gradients are
        reduced through ``optimizer``'s f32 master gradients."""
        from torch.nn.parallel import DistributedDataParallel as DDP

        from distributedpytorch_tpu_torch.models.milesial import BatchNormAct

        for module in model.modules():
            if isinstance(module, BatchNormAct):
                module.global_stats = True
        graphed = (int(self.config.steps_per_dispatch) > 1
                   and self.device.type == "cuda")
        stream = contextlib.nullcontext()
        if graphed:
            # the reducer keeps each parameter's gradient accumulator,
            # whose stream is the one current when DDP is built: built on
            # the default stream, the accumulators would make it wait on
            # the capture, which CUDA refuses (PyTorch's notes on CUDA
            # graphs with DDP: build DDP on the capture's side stream)
            self.capture_streams = {self.device:
                                    torch.cuda.Stream(self.device)}
            stream = torch.cuda.stream(self.capture_streams[self.device])
        # the running statistics are computed from global moments, so
        # they are equal on every rank already: nothing to broadcast
        with stream:
            ddp = DDP(rematerialized(model, self.config.remat),
                      broadcast_buffers=False,
                      device_ids=([self.device.index]
                                  if self.device.type == "cuda" else None))
        if graphed:
            # past its first 10 iterations the reducer times one in 100
            # by default; a capture may fall on one
            ddp._set_ddp_runtime_logging_sample_rate(2**31 - 1)
        if get_policy(self.config).master_weights:
            if not has_master_weights(optimizer):
                raise ValueError(
                    f"-t DDP --dtype {self.config.dtype}: wrap_model needs "
                    f"the master-weights optimizer the step drives")
            ddp.register_comm_hook(optimizer, _allreduce_master_grads)
        return ddp

    def train_loss(self, fused: bool) -> Callable:
        return make_sharded_loss(fused)

    sum_over_ranks = staticmethod(sum_over_ranks_)


def _allreduce_master_grads(optimizer, bucket):
    """DDP's communication hook under master weights. Autograd's hook has
    moved each bf16 gradient into its f32 master gradient already
    (``MasterWeights``), so the bucket DDP filled from the parameters
    holds zeros: the masters' gradients of its parameters are averaged
    over the ranks instead, in ``REDUCE_DTYPE``, and rounded to the
    parameters' dtype once, as the JAX DDP step all-reduces its bf16
    gradient in float32 (DDP's own hook would sum a bf16 bucket in bf16).
    DDP writes the zero bucket back as the parameters' gradients, which
    the master's step adds in: nothing. The all-reduce and the rounding
    run here, on the stream of the backward that calls the hook (NCCL
    orders its stream after it and it after NCCL's), not in a callback
    on another stream: a CUDA graph of K steps captures them as they
    run eagerly."""
    buffer = bucket.buffer()
    grads = optimizer.master_grads(bucket.parameters())
    flat = torch.cat([g.reshape(-1) for g in grads])
    flat.div_(dist.get_world_size())
    dist.all_reduce(flat)
    mean = flat.to(buffer.dtype).to(REDUCE_DTYPE)
    for g, t in zip(grads, mean.split([g.numel() for g in grads])):
        g.copy_(t.view_as(g))
    fut = torch.futures.Future(
        devices=[buffer.device] if buffer.is_cuda else None)
    fut.set_result(buffer)
    return fut


class Pipeline(Strategy):
    """Reference ``-t MP`` (unet_model.py:14-53): an S-stage microbatched
    pipeline in one process (``parallel/pipeline.py``). Stage s runs on
    ``devices[s]``, by default the first S visible cards, and holds its
    segments' layers there; ``--pipeline-schedule`` picks ``gpipe`` or
    ``1f1b``. On the CPU every stage runs on the CPU. ``config.batch_size``
    is the whole batch, split into ``num_microbatches``; the lr is not
    scaled; the faithful scale uses the whole batch."""

    name = "MP"

    def __init__(self, config, info: Optional[runtime.RuntimeInfo] = None,
                 devices: Optional[Sequence[torch.device]] = None):
        _check_schedule(config)
        stages = config.num_stages
        if devices is not None:
            devs = [torch.device(d) for d in devices]
        else:
            devs = local_devices(config.device)
            if devs[0].type == "cpu":
                devs = devs * stages
        if len(devs) < stages:
            raise ValueError(
                f"Requires at least {stages} devices, got {len(devs)}")
        self.devices = devs[:stages]
        self.stages = None
        # one process: its device is the first of the list
        super().__init__(config, None, self.devices)

    def topology(self) -> dict:
        cfg = self.config
        return {"strategy": self.name, "world": self.world,
                "stages": cfg.num_stages,
                "microbatches": cfg.num_microbatches,
                "schedule": cfg.pipeline_schedule}

    def mesh_shape(self) -> dict:
        # DDP_MP's ranks are its data axis
        return ({"data": self.world} if self.data_parallel else {}) | {
            "stage": self.config.num_stages}

    def place_model(self, model: torch.nn.Module) -> torch.nn.Module:
        """Each stage's layers on its device."""
        model.to(self.devices[0])
        self.stages = build_stages(model, self.devices,
                                   self.config.pipeline_cuts)
        return model

    #: whether the ranks are data replicas of the pipeline (DDP_MP)
    data_parallel = False

    def build_train_step(self, model, optimizer, kernels) -> Callable:
        cfg = self.config
        return make_pipeline_train_step(
            model, self.stages, optimizer, cfg.batch_size,
            cfg.num_microbatches, cfg.pipeline_schedule,
            cfg.faithful_loss_scaling, kernels.train_loss_fused,
            data_parallel=self.data_parallel, remat=cfg.remat)

    def build_accum_train_step(self, model, optimizer, kernels) -> Callable:
        raise ValueError(
            "pipeline strategies already microbatch inside the "
            "schedule — raise --microbatches instead of --grad-accum"
        )

    def build_eval_step(self, model, kernels) -> Callable:
        return make_pipeline_eval_step(model, self.stages,
                                       self.config.num_microbatches,
                                       kernels.eval_stats_fused)


def _check_schedule(config) -> None:
    if config.pipeline_schedule not in PIPELINE_SCHEDULES:
        raise ValueError(
            f"pipeline_schedule must be one of {PIPELINE_SCHEDULES}, "
            f"got {config.pipeline_schedule!r}"
        )


def _check_data_degree(batch_size: int, num_microbatches: int,
                       world: int) -> None:
    """The JAX ``HybridDataPipeline._mesh_layout`` rule (strategy.py:
    753-776) over ``world`` processes of S devices each: the data degree
    ``min(world, b // M)``, shrunk until ``b`` divides ``dp · M``, with
    the JAX errors for ``b % M`` and for dp < 2. Each port process is one
    data row, so a dp other than ``world`` raises too."""
    if batch_size % num_microbatches:
        raise ValueError(
            f"batch_size {batch_size} must be a multiple of "
            f"num_microbatches {num_microbatches}")
    dp = min(world, batch_size // num_microbatches)
    while dp > 1 and batch_size % (dp * num_microbatches):
        dp -= 1
    if dp < 2:
        raise ValueError(
            f"DDP_MP degenerates to plain MP: batch_size {batch_size} with "
            f"{num_microbatches} microbatches leaves no room for a data "
            f"axis ≥ 2 — use -t MP or raise the batch size")
    if dp != world:
        raise ValueError(
            f"DDP_MP: batch_size {batch_size} with {num_microbatches} "
            f"microbatches gives a data degree of {dp}, not the {world} "
            f"processes launched — use a batch size that is a multiple of "
            f"{world * num_microbatches}, or launch {dp} processes")


class HybridDataPipeline(MultiProcessMixin, Pipeline):
    """``-t DDP_MP`` (strategy.py:739-780): one process per data replica,
    each an S-stage pipeline (``parallel/pipeline.py``) on S devices of its
    own, ``cuda:(LOCAL_RANK·S + s)`` by default (``runtime.stage_devices``;
    every stage on the CPU with ``--device cpu``), joined by
    ``dist.runtime``. The torchrun contract of DDP (``MultiProcessMixin``):
    ``-b`` per process, the lr times the world size, the ragged batch
    dropped. The loss is one loss over the global batch: each microbatch's
    statistics summed on the last stage, then over the ranks; the stage
    gradients are summed over the ranks before Adam. milesial's BatchNorm
    normalizes each microbatch with its own shard's moments, as inside the
    JAX ``shard_map`` (not DDP's global moments), and the running
    averages' deltas are averaged over the ranks after the step. The data
    degree is the world size, and the JAX errors hold
    (``_check_data_degree``): without a launcher (world 1) it degenerates
    to plain MP and raises."""

    name = "DDP_MP"
    data_parallel = True

    def __init__(self, config, info: Optional[runtime.RuntimeInfo] = None,
                 devices: Optional[Sequence[torch.device]] = None):
        _check_schedule(config)
        stages = config.num_stages
        _check_data_degree(config.batch_size, config.num_microbatches,
                           info.num_processes if info is not None
                           else runtime.planned_world())
        if info is None:
            info = runtime.initialize_from_env(
                devices[0] if devices else config.device, stages)
        if devices is not None:
            devs = [torch.device(d) for d in devices]
            if len(devs) < stages:
                raise ValueError(
                    f"Requires at least {stages} devices, got {len(devs)}")
        else:
            devs = runtime.stage_devices(config.device, info.local_rank,
                                         stages)
        self.devices = devs[:stages]
        self.stages = None
        Strategy.__init__(self, config, dataclasses.replace(
            info, device=self.devices[0]))

    @property
    def drop_last_train(self) -> bool:
        return True


#: the row shards a process puts on one device that is not the list of
#: every visible card (the CPU, or a card named by its index)
REPEATED_SHARDS = 2


def _shard_devices(device) -> List[torch.device]:
    """The devices ``-t SP`` shards over by default: every visible card
    for ``cuda``, else ``REPEATED_SHARDS`` shards of the one device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return local_devices(dev)
    return [dev] * REPEATED_SHARDS


def _spatial_degree(deep_rows: int, n: int) -> int:
    """The JAX ``SpatialParallel._mesh_layout`` rule (strategy.py:
    797-808): n shrinks until it divides the deepest level's rows."""
    while n > 1 and deep_rows % n:
        n -= 1
    return n


def _deep_rows(config) -> int:
    """The rows at the model's deepest level, ``H / 2^model_levels``
    (``image_size`` is (W, H))."""
    return config.image_size[1] // 2 ** config.model_levels


class SpatialParallel(Strategy):
    """``-t SP`` (JAX strategy.py:783-808): one process, each image's rows
    split over ``devices`` (``parallel/spatial.RowSharded``), by default
    every visible card, or two shards of the CPU (``REPEATED_SHARDS``).
    The shard count shrinks, as the JAX mesh does, until it divides the
    deepest level's rows, ``H / 2^model_levels``. The parameters are
    replicated; ``config.batch_size`` is the whole batch, the lr is not
    scaled and the ragged batch is kept. The loss runs per shard, K1 and
    K1-bwd on each shard's card under ``--kernels cuda``, the statistics
    added on the first device (``make_row_sharded_loss``); eval runs the
    sharded forward with K1 per shard; milesial's BatchNorm normalizes
    with the whole batch's moments. The run control runs as the module
    docstring of ``parallel/spatial.py`` says: ``--steps-per-dispatch K``
    as one CUDA graph over the shards' threads, ``--remat`` per shard
    with kept halos and moments, and the UNet's ``--grad-accum`` on the
    shards' statistics."""

    name = "SP"
    #: whether the BatchNorm moments and the loss statistics are summed
    #: over the ranks too (DDP_SP)
    over_ranks = False

    def __init__(self, config, info: Optional[runtime.RuntimeInfo] = None,
                 devices: Optional[Sequence[torch.device]] = None):
        devs = ([torch.device(d) for d in devices] if devices is not None
                else _shard_devices(config.device))
        self.devices = devs[:_spatial_degree(_deep_rows(config), len(devs))]
        # one process: its device is the first of the list
        super().__init__(config, None, self.devices)

    def topology(self) -> dict:
        return {"strategy": self.name, "world": self.world,
                "devices": len(self.devices)}

    def mesh_shape(self) -> dict:
        """The JAX mesh: its ``spatial`` axis, left out at one shard as
        JAX drops an axis of size 1."""
        n = len(self.devices)
        return {"spatial": n} if n > 1 else {}

    def wrap_model(self, model: torch.nn.Module,
                   optimizer=None) -> torch.nn.Module:
        """The row shards, each recomputed in the backward under
        ``--remat``; under master weights each computes with its own cast
        of ``optimizer``'s f32 masters."""
        return RowSharded(model, self.devices,
                          per_use_casts(optimizer, model),
                          over_ranks=self.over_ranks,
                          remat=self.config.remat)

    def train_loss(self, fused: bool) -> Callable:
        return make_row_sharded_loss(fused, self.over_ranks)

    def accum_module(self, model, optimizer):
        """The row shards, which recompute themselves under ``--remat``."""
        return self.wrap_model(model, optimizer), False

    def accum_stats(self, fused: bool) -> Callable:
        """The shards' statistics added on the first device, not over the
        ranks: accumulation sums pass 1's statistics and the gradients
        over them itself (``sum_over_ranks``)."""
        return make_row_sharded_stats(fused)

    def reduce_grads(self, model, optimizer) -> Optional[Callable]:
        """What runs between the backward and Adam: nothing in one
        process."""
        return None

    def build_train_step(self, model, optimizer, kernels) -> Callable:
        return make_train_step(
            self.wrap_model(model, optimizer), optimizer,
            self.config.batch_size, self.config.faithful_loss_scaling,
            loss_impl=self.train_loss(kernels.train_loss_fused),
            reduce_grads=self.reduce_grads(model, optimizer))

    def build_eval_step(self, model, kernels) -> Callable:
        return make_eval_step(self.wrap_model(model),
                              kernels.eval_stats_fused, sharded=True)


def rank_shards(device) -> int:
    """The devices each ``-t DDP_SP`` process shards over: the visible
    cards split evenly over the node's processes (torchrun's
    ``LOCAL_WORLD_SIZE``) for ``cuda``, else ``REPEATED_SHARDS``."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return REPEATED_SHARDS
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return max(1, torch.cuda.device_count() // max(1, local_world))


def check_spatial_data_degree(config, world: int, per_process: int) -> int:
    """The JAX ``HybridDataSpatial._mesh_layout`` rule (strategy.py:
    823-843) over ``world`` processes of ``per_process`` devices each:
    the largest spatial degree that divides the deepest rows and leaves a
    data axis >= 2 dividing the batch, with the JAX error where there is
    none (world 1 has none: each port process is one data row). A data
    degree other than ``world`` raises too. Returns the spatial degree."""
    total = world * per_process
    best = None
    if world > 1:
        for sp in range(total, 0, -1):
            if _deep_rows(config) % sp:
                continue
            dp = total // sp
            while dp > 1 and config.batch_size % dp:
                dp -= 1
            if dp >= 2:
                best = (dp, sp)
                break
    if best is None:
        raise ValueError(
            f"DDP_SP degenerates to plain SP: batch_size "
            f"{config.batch_size} leaves no data axis ≥ 2 over "
            f"{total} devices — use -t SP or raise the batch size")
    dp, sp = best
    if dp != world:
        raise ValueError(
            f"DDP_SP: batch_size {config.batch_size} over {world} processes "
            f"of {per_process} devices gives a data degree of {dp}, not "
            f"the {world} processes launched — launch {dp} processes, or "
            f"use a batch size and image height that leave {world}")
    return sp


class HybridDataSpatial(MultiProcessMixin, SpatialParallel):
    """``-t DDP_SP`` (JAX strategy.py:811-843): data × spatial, one process
    per data row, each row-sharding its batch over devices of its own,
    ``cuda:(LOCAL_RANK·n + s)`` by default (``runtime.stage_devices``;
    ``REPEATED_SHARDS`` shards of the CPU with ``--device cpu``), joined
    by ``dist.runtime``. The torchrun contract of DDP
    (``MultiProcessMixin``): ``-b`` per process, the lr times the world
    size, the ragged batch dropped. The spatial degree is the JAX rule's
    over world × n devices, and its data degree must be the world size
    (``check_spatial_data_degree``): without a launcher (world 1) it
    degenerates to plain SP and raises, before joining any group.

    The loss statistics and milesial's BatchNorm moments are summed over
    the shards, then over the ranks (``over_ranks``). Each rank's
    gradient then comes out ``world ×`` its share (the all-reduce's
    backward sums the cotangent over the ranks, DDP difference 4 of the
    ROADMAP), and the ranks' mean of the gradients, after the shards'
    sum, takes the factor out: the global loss's gradient, on every rank
    (``reduce_grads``; under master weights the f32 master gradients, in
    ``REDUCE_DTYPE``). Gradient accumulation sums its statistics and then
    its gradients over the ranks (``sum_over_ranks``), as DDP's does.
    Under NCCL a CUDA graph of K steps holds the statistics' and the
    moments' all-reduces and ``reduce_grads``; its one eager stack
    before the capture (``capture_warmup_steps``) makes NCCL's
    communicators."""

    name = "DDP_SP"
    over_ranks = True
    sum_over_ranks = staticmethod(sum_over_ranks_)

    def __init__(self, config, info: Optional[runtime.RuntimeInfo] = None,
                 devices: Optional[Sequence[torch.device]] = None):
        per_process = (len(devices) if devices is not None
                       else rank_shards(config.device))
        sp = check_spatial_data_degree(
            config, info.num_processes if info is not None
            else runtime.planned_world(), per_process)
        if info is None:
            info = runtime.initialize_from_env(
                devices[0] if devices else config.device, per_process)
        devs = ([torch.device(d) for d in devices] if devices is not None
                else runtime.stage_devices(config.device, info.local_rank,
                                           per_process))
        self.devices = devs[:sp]
        Strategy.__init__(self, config, dataclasses.replace(
            info, device=self.devices[0]))

    @property
    def drop_last_train(self) -> bool:
        return True

    def mesh_shape(self) -> dict:
        return {"data": self.world} | super().mesh_shape()

    def reduce_grads(self, model, optimizer) -> Callable:
        params = [p for p in model.parameters() if p.requires_grad]

        def reduce() -> None:
            sum_over_ranks_(optimizer_grads(optimizer, params), mean=True)

        return reduce


def check_run_control(config, device: Optional[torch.device] = None,
                      backend: Optional[str] = None) -> None:
    """The run control's limits of the port: ``--grad-accum`` together
    with ``--steps-per-dispatch K > 1`` and ``--grad-accum`` of milesial,
    whose BatchNorm statistics do not add up over chunks, each refused
    with the JAX package's words; once the strategy knows its ``device``
    and its group's ``backend``, ``--steps-per-dispatch K > 1`` under
    gloo on a card."""
    method = config.train_method
    k = int(config.steps_per_dispatch)
    grad_accum = int(config.grad_accum)
    if k > 1 and grad_accum > 1:
        raise ValueError(STACKS_CONFLICT)
    if grad_accum > 1 and getattr(config, "model_arch", "unet") == "milesial":
        raise ValueError(STATEFUL_ACCUM)
    if (k > 1 and backend == "gloo" and device is not None
            and torch.device(device).type == "cuda"):
        raise ValueError(
            f"--steps-per-dispatch {k} under -t {method} over a gloo "
            f"group on {device}: gloo moves CUDA tensors through the "
            f"host, which a CUDA graph of K steps cannot capture — use "
            f"the NCCL group torchrun makes on cards (ROADMAP.md, "
            f"Queue A)")


STRATEGIES = {cls.name: cls for cls in (
    SingleDevice, DataParallel, DistributedDataParallel, Pipeline,
    HybridDataPipeline, SpatialParallel, HybridDataSpatial)}


def build_strategy(config, info: Optional[runtime.RuntimeInfo] = None,
                   devices: Optional[Sequence[torch.device]] = None
                   ) -> Strategy:
    """``config.train_method`` → its strategy, on ``devices`` where one is
    given (DP, MP, SP and each DDP_MP and DDP_SP rank; every method takes
    its first as its device). The mesh specs, TP and FSDP raise with the
    ROADMAP pointer, and so do the limits of ``check_run_control``."""
    cls = STRATEGIES.get(config.train_method)
    if cls is None:
        raise ValueError(unported_method_message(config.train_method))
    check_run_control(config)
    strategy = cls(config, info, devices)
    check_run_control(config, strategy.device, strategy.backend)
    return strategy


def unported_method_message(method: str) -> str:
    return (
        f"-t {method} is not ported yet: the PyTorch port trains "
        f"{', '.join(sorted(STRATEGIES))}; the mesh specs, TP and FSDP "
        f"are still to port (ROADMAP.md, Queue A)"
    )
