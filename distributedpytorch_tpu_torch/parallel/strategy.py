"""Strategies: what differs between ``-t singleGPU``, ``DP``, ``DDP``,
``MP``, ``DDP_MP``, ``SP``, ``DDP_SP``, ``TP``, ``FSDP`` and the mesh
specs ``DxMxS[@tp|sp|fsdp]``.

Counterpart of ``Strategy``, ``SingleDevice``, ``DataParallel``
(strategy.py:542-555), ``MultiProcessMixin`` (:558-693),
``DistributedDataParallel`` (:696-716), ``Pipeline`` (:719-736),
``HybridDataPipeline`` (:739-780), ``SpatialParallel`` (:783-808),
``HybridDataSpatial`` (:811-843), ``TensorParallel`` (:885-909),
``FullyShardedDataParallel`` (:912-952), ``GenericMesh`` (:955-1029) and
``build_strategy`` (:1046) of ``distributedpytorch_tpu/parallel/strategy.py``.
A strategy answers: which devices a process computes on, which samples it
loads, the global batch, the lr, which process writes, where the model's
layers live, and the train and eval steps.

Each process of the port drives one device under DDP and one data row
(its S stages) under DDP_MP, so the JAX mixin's row-based replica
assignment (``_compute_batch_replica_shard``, for meshes whose data rows
span processes) collapses to ``ShardSpec(rank, world)``. DP and MP are
one process over a list of devices (``devices``, which may repeat one:
the CPU tests run ``[cpu, cpu]``, a one-card check ``[cuda:0,
cuda:0]``); so is each DDP_MP rank, SP over its shards' devices, each
DDP_SP rank and TP over its channel slices' devices. FSDP is DDP's
torchrun contract with the parameters and Adam's state sharded over the
ranks. A mesh spec ``-t DxMxS`` runs as the composition of these that it
is (``GenericMesh``), data × channel (``DataTensorParallel``), ZeRO ×
channel (``ZeroTensorParallel``), ZeRO over row shards (``ZeroSpatial``)
and sharding inside a pipeline stage (``InStagePipeline``,
``InStageHybridPipeline``) included.

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
XLA eval metrics and XLA BatchNorm there). Under TP K1 and K1-bwd run
once per step on the whole predictions on the first device, K1 in eval,
and milesial's K2, K3 and K5 per channel slice on its device; under FSDP
each rank runs them as a DDP rank does. The JAX TP and FSDP keep XLA
BatchNorm and XLA eval metrics (no GSPMD rule for ``pallas_call``).
Under in-stage sharding each stage computes on whole parameters on its
compute device, so every kernel launches as under the ``Dx1xS`` twin;
under ZeRO over row shards each shard does, as under its ``DxMx1@sp``
twin.

The run control (``check_run_control``): ``--remat`` recomputes the
forward of the step (singleGPU, DDP, ``--grad-accum``), of each stage
(MP, DDP_MP, both schedules), of each DP replica or SP row shard, of
each segment of TP's channel-sharded model, or of each FSDP block
inside ``fully_shard``'s hooks, in its backward; a replica's or shard's
recompute normalizes with the BatchNorm moments the replicas met on in
its forward, a DDP or FSDP rank's with the global moments it kept, and
a shard's convs take the halo rows they kept: none meets again; a ZeRO
model (``DxMx1@fsdp``, ``DxMx1@sp+fsdp``) gathers once and recomputes
on its leaves (``parallel/zero.py``), and under in-stage sharding each
stage recomputes on the leaves the pipeline gathered once.
``--steps-per-dispatch K > 1``
(one CUDA graph of K steps, ``build_multi_train_step``, from the
trainer's own train step) runs
under every strategy, DP's replica and SP's shard threads, TP's slices
and FSDP's all-gathers and reduce-scatters and in-stage sharding's
over every place included, and is refused under a gloo group on a
card. ``--grad-accum`` runs outside the pipelines (in-stage sharding
too) for the stateless UNet; under SP and DDP_SP each chunk's
statistics are the shards' sums (``accum_stats``), under FSDP each
rank's own (``backward_averages_over``), under ZeRO one gather and
one reduce-scatter of the ranks' sum. What stays refused, with the
JAX package's words: ``--grad-accum`` of milesial and together with
``--steps-per-dispatch K > 1``. ``--dtype bf16_params`` runs under
every strategy; under DDP the gradients are averaged over the ranks in
``REDUCE_DTYPE`` and rounded to bf16 once (``_allreduce_master_grads``),
which is where the compiled JAX DDP step sums them too (its gradient
all-reduce is float32 on the CPU mesh), and DDP_MP's stage gradients are
reduced as the f32 master gradients; under FSDP each block's bf16
gradients are reduce-scattered in ``REDUCE_DTYPE`` and rounded to bf16
once, and each master is a shard; under ZeRO (``parallel/zero.py``)
float32 leaves are reduce-scattered into the masters' gradients, with no
rounding after, under in-stage sharding too. Where one backward adds
several uses
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
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
from distributedpytorch_tpu_torch.ops.optim import load_optimizer_state
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
from distributedpytorch_tpu_torch.parallel.channels import ChannelSharded
from distributedpytorch_tpu_torch.parallel.in_stage import (
    in_stage_config,
    shard_stages,
)
from distributedpytorch_tpu_torch.parallel.mesh import (
    MeshConfig,
    axis_layout,
    canonical_spec,
    is_mesh_spec,
    parse_mesh_spec,
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


def _global_batchnorm(model: torch.nn.Module) -> None:
    """milesial's BatchNorm on the global batch's moments (DDP, FSDP and
    the data × channel meshes)."""
    from distributedpytorch_tpu_torch.models.milesial import BatchNormAct

    for module in model.modules():
        if isinstance(module, BatchNormAct):
            module.global_stats = True


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

    def reduce_grads(self, model, optimizer) -> Optional[Callable]:
        """What runs between the backward and Adam (None: nothing; the
        model's own backward reduces where it must)."""
        return None

    def build_train_step(self, model, optimizer, kernels) -> Callable:
        """``step(batch) -> loss`` of one optimizer step (train/steps.py);
        the faithful scale is the per-process ``batch_size``
        (strategy.py:303-314)."""
        return make_train_step(
            self.wrap_model(model, optimizer), optimizer,
            self.config.batch_size,
            self.config.faithful_loss_scaling,
            loss_impl=self.train_loss(kernels.train_loss_fused),
            reduce_grads=self.reduce_grads(model, optimizer))

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
            stats_impl=self.accum_stats(kernels.train_loss_fused),
            grads_averaged_over=self.backward_averages_over,
            **self.accum_hooks(model))

    #: the ranks the model's own backward averages each gradient over
    #: (FSDP's reduce-scatter); None where the steps reduce them
    backward_averages_over: Optional[int] = None

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

    def accum_hooks(self, model: torch.nn.Module) -> Dict[str, Callable]:
        """What gradient accumulation runs at the top of its step
        (``open_step``) and after its pass 2 (``close_step``, which then
        sums the gradients over the ranks): nothing here."""
        return {}

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

    # -- the state a checkpoint holds: whole tensors, singleGPU's layout ----
    #: whether reading the whole state is a collective that every rank
    #: enters (FSDP); otherwise the main process reads it alone
    gathers_state = False

    def model_state(self, model: torch.nn.Module) -> dict:
        """The singleGPU model's state dict of the placed ``model``."""
        return model.state_dict()

    def load_model_state(self, model: torch.nn.Module, state) -> None:
        """``model_state``'s inverse: a singleGPU state dict into
        ``model``."""
        model.load_state_dict(state)

    def optimizer_state(self, model: torch.nn.Module, optimizer) -> dict:
        """The singleGPU optimizer's state dict of ``optimizer``."""
        return optimizer.state_dict()

    def load_optimizer_state(self, model: torch.nn.Module, optimizer,
                             state: dict) -> None:
        """``optimizer_state``'s inverse, with this run's param groups
        (``ops/optim.load_optimizer_state``)."""
        load_optimizer_state(optimizer, state)

    def param_names(self, model: torch.nn.Module) -> List[str]:
        """The singleGPU model's parameter names, in its order: the order
        of a saved optimizer state's parameters and masters."""
        return [name for name, _ in model.named_parameters()]

    def param_values(self, model: torch.nn.Module,
                     values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Values of the whole parameters (``param_names`` order) → one per
        tensor of ``model.parameters()``, as a master reseed reads
        them."""
        return list(values)


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

        _global_batchnorm(model)
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


#: the JAX package's refusal of ``--grad-accum`` under a pipeline
PIPELINE_ACCUM = ("pipeline strategies already microbatch inside the "
                  "schedule — raise --microbatches instead of --grad-accum")


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
        raise ValueError(PIPELINE_ACCUM)

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
        self.check_data_degree(config, info.num_processes if info is not None
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

    @staticmethod
    def check_data_degree(config, world: int) -> None:
        """The JAX rule of the data degree over ``world`` processes
        (``_check_data_degree``), before any group is joined."""
        _check_data_degree(config.batch_size, config.num_microbatches, world)


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
        sp = self.spatial_degree(
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

    #: the spatial degree over ``world`` processes of ``per_process``
    #: devices, checked before any group is joined
    spatial_degree = staticmethod(check_spatial_data_degree)

    def reduce_grads(self, model, optimizer) -> Callable:
        return _mean_over_ranks(model, optimizer)


def _mean_over_ranks(model, optimizer) -> Callable[[], None]:
    """The gradients of ``model``'s parameters (under master weights the
    f32 master gradients, in ``REDUCE_DTYPE``) replaced by their mean
    over the ranks, one all-reduce per device."""
    params = [p for p in model.parameters() if p.requires_grad]

    def reduce() -> None:
        sum_over_ranks_(optimizer_grads(optimizer, params), mean=True)

    return reduce


class ShardedState:
    """The state of a model whose parameters lie in pieces
    (``ChannelSharded``, ``zero.ZeroSharded``): a checkpoint holds the
    whole tensors under the reference names, and a resume cuts them
    again."""

    def model_state(self, model) -> dict:
        return model.whole_state()

    def load_model_state(self, model, state) -> None:
        model.load_whole_state(state)

    def optimizer_state(self, model, optimizer) -> dict:
        return model.whole_optimizer_state(optimizer.state_dict())

    def load_optimizer_state(self, model, optimizer, state: dict) -> None:
        load_optimizer_state(optimizer, model.sharded_optimizer_state(state))

    def param_names(self, model) -> List[str]:
        return model.whole_param_names()

    def param_values(self, model, values) -> list:
        return model.slice_values(values)


class TensorParallel(ShardedState, Strategy):
    """``-t TP`` (JAX strategy.py:885-909, ``MeshConfig(model=n,
    params="channel")``): one process, every conv's out-channels split
    over ``devices`` (``parallel/channels.ChannelSharded``), by default
    every visible card, or two slices of the CPU or of a card named by
    its index (``REPEATED_SHARDS``, as SP). A layer whose out-channels do
    not divide the devices stays whole on the first; where none divides,
    the JAX warning says so. The batch is replicated: ``config.batch_size``
    is the whole batch, on the first device, the lr is not scaled and the
    ragged batch is kept, exactly as singleGPU. The loss runs once on the
    whole predictions on the first device (K1 and K1-bwd there under
    ``--kernels cuda``), and Adam keeps each slice's state on its device
    (``ops/optim.device_runs``). A checkpoint holds the whole tensors
    under the reference names (``model_state``, ``optimizer_state``).

    The run control is the generic one over the sharded model (the
    module docstring of ``parallel/channels.py``): ``--remat`` recomputes
    it segment by segment (``Strategy.wrap_model``), ``--steps-per-dispatch
    K`` captures K steps over ``devices`` (``step_devices``; on
    ``[cuda:0, cuda:0]`` one card) with Adam capturable on each card, and
    the UNet's ``--grad-accum`` runs its chunks through the sharded model
    (``accum_module``), K1 on the whole predictions on the first device.
    The JAX TP runs the plain loss there (its accumulation fuses the loss
    off the mesh only); the port runs K1 and K1-bwd under ``--kernels
    cuda``, the same function."""

    name = "TP"

    def __init__(self, config, info: Optional[runtime.RuntimeInfo] = None,
                 devices: Optional[Sequence[torch.device]] = None):
        self.devices = ([torch.device(d) for d in devices]
                        if devices is not None
                        else _shard_devices(config.device))
        # one process: its device is the first of the list
        super().__init__(config, None, self.devices)

    def topology(self) -> dict:
        return {"strategy": self.name, "world": self.world,
                "devices": len(self.devices)}

    def mesh_shape(self) -> dict:
        """The JAX mesh: its ``model`` axis, left out at one device as JAX
        drops an axis of size 1."""
        n = len(self.devices)
        return {"model": n} if n > 1 else {}

    def place_model(self, model: torch.nn.Module) -> ChannelSharded:
        return ChannelSharded(model, self.devices)


def gathered(value):
    """``value`` with every ``DTensor`` in it gathered whole, a collective
    every rank enters in the same order. A dim-0 shard over the ranks, as
    ``fully_shard`` places every parameter and Adam's moments, is gathered
    by one ``all_gather_into_tensor`` of the shards padded to torch.chunk's
    size, the c10d collective FSDP itself runs: ``DTensor.full_tensor``
    goes through the functional collectives, whose wait crashed both
    processes of a gloo group on one H100 (torch 2.11.0+cu128). Any other
    placement takes ``full_tensor``."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(value, DTensor):
        if tuple(value.placements) != (Shard(0),):
            return value.full_tensor()
        local = value.to_local()
        group = value.device_mesh.get_group()
        rows = value.shape[0]
        chunk = -(-rows // dist.get_world_size(group))
        padded = local.new_zeros((chunk, *value.shape[1:]))
        padded[:local.shape[0]] = local
        out = local.new_empty((dist.get_world_size(group) * chunk,
                               *value.shape[1:]))
        dist.all_gather_into_tensor(out, padded, group=group)
        # the ranks short of a whole chunk are the last ones
        return out[:rows]
    if isinstance(value, dict):
        return {k: gathered(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(gathered(v) for v in value)
    return value


def _local_shard(whole: torch.Tensor, like,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """This rank's shard of ``whole`` as ``like``'s (a ``DTensor``)
    placements cut it, on ``like``'s device, in ``dtype`` (by default
    ``like``'s), with no communication."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(whole.to(like.device, dtype or like.dtype),
                             like.device_mesh, like.placements,
                             src_data_rank=None)


class FullyShardedDataParallel(MultiProcessMixin, Strategy):
    """``-t FSDP`` (JAX strategy.py:912-952, ``MeshConfig(data=world,
    params="fsdp")``): DDP's torchrun contract (``MultiProcessMixin``: one
    process per card joined by ``dist.runtime``, world 1 without a
    launcher, ``-b`` per process, ``ShardSpec(rank, world)``, the ragged
    batch dropped, rank 0 writes) with the parameters and Adam's state
    sharded over the ranks: ``place_model`` calls
    ``torch.distributed.fsdp.fully_shard`` on each block (a segment's
    layers) and then on the model, before the trainer builds Adam, which
    then steps each rank's shards (dim 0 of each tensor, where the JAX
    FSDP cuts a leaf's largest axis that divides). Each forward and
    backward all-gathers a block's parameters and the backward
    reduce-scatters its gradients, averaged over the ranks. The loss is
    one loss over the global batch (``make_sharded_loss``), whose
    statistics' all-reduce makes each rank's gradient ``world ×`` its
    share, which the averaging takes out, as under DDP; milesial's
    BatchNorm normalizes with the global batch's moments
    (``global_stats``). The lr is not scaled: FSDP is a memory layout,
    not the reference's DDP recipe (JAX docstring). Eval runs whole val
    batches round robin and its tail on every rank
    (``evaluate_sharded``), so every rank runs the same number of
    forwards and enters each block's all-gather alike. A checkpoint
    gathers every shard whole on every rank (``gathers_state``), and
    rank 0 writes it; a resume cuts each rank's shard from the whole
    tensors.

    The run control:

    * ``--remat`` wraps each block's own forward in a checkpoint before
      ``fully_shard`` hooks it (``models.recompute_in_backward``), as
      FSDP2 is meant to be used with activation checkpointing: the hooks
      stay outside the recomputed region, so the backward all-gathers a
      block's parameters, recomputes its forward with them and
      reshards after, and no whole parameter stays alive between the
      forward and the backward. ``models.Rematerialized`` around the
      sharded model would call the segments past the root's own forward
      hooks (FSDP2's lazy init makes the first module to run the root).
      milesial's recompute normalizes with the global moments its
      forward kept and enters no all-reduce;
    * ``--steps-per-dispatch K`` captures K steps on the rank's card
      (``train/steps.MultiStep``): FSDP2 forks its all-gather and
      reduce-scatter streams from the current one and joins them back
      with events, and the one eager stack before the capture makes its
      streams, NCCL's communicator and Adam's moments over the shards;
    * ``--grad-accum``: pass 1 sums the chunks' statistics over the
      ranks (``sum_over_ranks``); pass 2 back-propagates each rank's own
      statistics with the cotangent times the world size, so the
      reduce-scatter's average after every chunk is the sum over the
      ranks (``backward_averages_over``). Reduce-scattering after every
      chunk keeps only each rank's shard of the gradients between the
      chunks; syncing only after the last would keep the whole unsharded
      gradients alive, what FSDP is there to avoid;
    * ``--dtype bf16_params``: the parameters are cast to bf16 after
      ``fully_shard`` (the trainer's ``cast_params_``, which FSDP2 takes
      in at its lazy init), the f32 masters and Adam's moments are
      shards of their own, each gradient is reduce-scattered in
      ``REDUCE_DTYPE`` (``MixedPrecisionPolicy(reduce_dtype=...)``) and
      rounded to bf16 once, as DDP's ``_allreduce_master_grads`` does,
      and ``MasterWeights``' hook, which FSDP2 runs on the sharded
      parameter after the reduce-scatter, widens it into its master's
      gradient."""

    name = "FSDP"
    gathers_state = True
    sum_over_ranks = staticmethod(sum_over_ranks_)

    def __init__(self, config, info: Optional[runtime.RuntimeInfo] = None,
                 devices: Optional[Sequence[torch.device]] = None):
        super().__init__(config, info or runtime.initialize_from_env(
            devices[0] if devices else config.device))

    @property
    def drop_last_train(self) -> bool:
        return True

    def lr_for(self, base_lr: float) -> float:
        return base_lr

    def mesh_shape(self) -> dict:
        return {"data": self.world}

    @property
    def backward_averages_over(self) -> int:
        return self.world

    def place_model(self, model: torch.nn.Module) -> torch.nn.Module:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard

        from distributedpytorch_tpu_torch.models import recompute_in_backward

        _global_batchnorm(model)
        model.to(self.device)
        mesh = init_device_mesh(self.device.type, (self.world,))
        policy = MixedPrecisionPolicy(reduce_dtype=REDUCE_DTYPE)
        for seg in range(model.num_segments):
            for block in model.segment_modules(seg):
                if self.config.remat:
                    recompute_in_backward(block)
                fully_shard(block, mesh=mesh, mp_policy=policy)
        fully_shard(model, mesh=mesh, mp_policy=policy)
        return model

    def wrap_model(self, model: torch.nn.Module,
                   optimizer=None) -> torch.nn.Module:
        """The sharded model itself: its blocks recompute themselves under
        ``--remat`` (``place_model``)."""
        return model

    def accum_module(self, model, optimizer):
        return model, False

    def train_loss(self, fused: bool) -> Callable:
        return make_sharded_loss(fused)

    def model_state(self, model: torch.nn.Module) -> dict:
        return {k: gathered(v).detach() for k, v in model.state_dict().items()}

    @torch.no_grad()
    def load_model_state(self, model: torch.nn.Module, state) -> None:
        own = model.state_dict()
        if set(own) != set(state):
            raise RuntimeError(
                f"-t FSDP state dict: missing {sorted(set(own) - set(state))}"
                f", unexpected {sorted(set(state) - set(own))}")
        for name, value in own.items():
            if hasattr(value, "device_mesh"):
                value.to_local().copy_(
                    _local_shard(state[name], value).to_local())
            else:
                value.copy_(state[name])

    def optimizer_state(self, model: torch.nn.Module, optimizer) -> dict:
        return gathered(optimizer.state_dict())

    def load_optimizer_state(self, model: torch.nn.Module, optimizer,
                             state: dict) -> None:
        """Each rank's shard of every whole tensor of ``state``: Adam's
        moments cut as the tensors Adam steps (the parameters, or under
        master weights the f32 masters), the masters as themselves."""
        if has_master_weights(optimizer):
            masters = optimizer.master
            state = {"master": [_local_shard(v, m) for v, m in
                                zip(state["master"], masters)],
                     "inner": _sharded_moments(state["inner"], masters)}
        else:
            state = _sharded_moments(state, list(model.parameters()))
        load_optimizer_state(optimizer, state)

    def param_values(self, model: torch.nn.Module, values) -> list:
        """This rank's shard of each whole value, in its own dtype, as the
        masters' reseed reads them."""
        return [_local_shard(v, p, v.dtype)
                for v, p in zip(values, model.parameters())]


def _sharded_moments(state: dict, tensors) -> dict:
    """A torch optimizer's state dict of whole tensors → each rank's shard
    of every moment, cut as ``tensors`` (one per state index) are."""
    slots = {}
    for i, entry in state["state"].items():
        slots[i] = {key: (_local_shard(v, tensors[int(i)])
                          if isinstance(v, torch.Tensor) and v.dim() > 0
                          else v)
                    for key, v in entry.items()}
    return {**state, "state": slots}


# -- the mesh specs -------------------------------------------------------------


class GenericMesh:
    """``-t DxMxS[@tp|sp|fsdp]`` (JAX strategy.py:955-1029, the grammar of
    ``parallel/mesh.py``): a point of the mesh, run as the composition of
    the port's strategies that it is (``plan_mesh``):

    * ``1x1x1``: ``SingleDevice``;
    * ``Dx1x1``: ``DistributedDataParallel``; ``Dx1x1@fsdp``:
      ``FullyShardedDataParallel`` (``1x1x1@fsdp`` at world 1);
    * ``1xMx1`` (and ``1xMx1@fsdp``: ZeRO over one rank is nothing):
      ``TensorParallel`` over exactly M slices; ``1xMx1@sp``:
      ``SpatialParallel`` over exactly M row shards;
    * ``DxMx1@sp``: ``HybridDataSpatial``, exactly D × M;
      ``DxMx1@sp+fsdp`` (D > 1): ``ZeroSpatial`` (ZeRO over row shards);
    * ``DxMx1``: ``DataTensorParallel`` (data × channel); ``DxMx1@fsdp``:
      ``ZeroTensorParallel`` (ZeRO × channel);
    * ``1x1xS``: ``Pipeline`` with S stages; ``Dx1xS``:
      ``HybridDataPipeline``;
    * ``1xMxS`` (M > 1): ``InStagePipeline``; ``DxMxS`` (M > 1) and
      ``Dx1xS@fsdp`` / ``DxMxS@fsdp`` (D > 1): ``InStageHybridPipeline``
      (``parallel/in_stage.py``).

    This class puts the specs' semantics (JAX docstring :955-972) over
    the one the spec runs as, whose code runs unchanged: ``-b`` is per
    process, the lr is never scaled (``lr_for``), ``name`` is the
    canonical spec, ``mesh_shape`` the mesh's axes of size > 1
    (``axis_layout``), and an infeasible geometry fails loudly, with the
    JAX words, before any group is joined; no axis is ever shrunk. Each
    data row is one process: D must be the launched world, and each
    process computes on M·S devices of its own
    (``runtime.stage_devices``: on the CPU, and on a card named by its
    index, M·S repeats of it). The run control is that of the class the
    spec runs as: under ``DxMx1`` the run control of ``-t TP`` on each
    rank with DDP_SP's mean over the ranks, under ``DxMx1@fsdp`` and
    ``DxMx1@sp+fsdp`` ``zero.ZeroSharded``'s (its module docstring),
    and under in-stage sharding the pipeline's on the leaves its
    ``open_step`` gathered (``InStage``)."""

    @property
    def mesh_config(self) -> MeshConfig:
        return parse_mesh_spec(self.config.train_method)

    @property
    def name(self) -> str:
        return canonical_spec(self.mesh_config)

    def mesh_shape(self) -> dict:
        return dict(axis_layout(self.mesh_config))

    def lr_for(self, base_lr: float) -> float:
        return base_lr

    def spatial_degree(self, config, world: int, per_process: int) -> int:
        """DDP_SP's spatial degree: the model axis (``plan_mesh`` checked
        the rows)."""
        return parse_mesh_spec(config.train_method).model

    def check_data_degree(self, config, world: int) -> None:
        """DDP_MP's data degree: the data axis (``plan_mesh`` checked the
        batch)."""


class DataTensorParallel(GenericMesh, MultiProcessMixin, TensorParallel):
    """``-t DxMx1`` with D, M > 1, data × channel (JAX ``2x2x1``,
    ``MeshConfig(data=D, model=M, params="channel")``): one process per
    data row, joined by ``dist.runtime``, each a ``ChannelSharded`` model
    (``-t TP``) over M devices of its own, ``cuda:(LOCAL_RANK·M + i)`` by
    default. The torchrun contract of DDP without its lr quirk: ``-b``
    per process, ``ShardSpec(rank, world)``, the ragged batch dropped.

    The loss is one loss over the global batch, its statistics summed
    over the ranks on each rank's first device (``make_sharded_loss``);
    milesial's BatchNorm normalizes each channel slice with its global
    moments, all-reduced on the slice's device, where they meet the same
    slice of every rank (``global_stats``). After the backward the
    gradients are averaged over the ranks, one all-reduce per device
    (``_mean_over_ranks``, as ``-t DDP_SP``), which takes out the
    ``world ×`` of the statistics' all-reduce. Eval runs whole val
    batches round robin and the tail on every rank; a checkpoint holds
    the whole tensors (``-t TP``'s), which rank 0 writes.

    The run control is ``-t TP``'s on each rank: ``--remat`` recomputes
    the channel-sharded model segment by segment, milesial's BatchNorm on
    the global moments its forward kept, so no all-reduce of a recompute
    meets the other ranks; ``--steps-per-dispatch K`` captures K steps
    over the rank's ``devices``, the all-reduces of the moments, of the
    statistics and of ``_mean_over_ranks`` inside; the UNet's
    ``--grad-accum`` runs its chunks through the sharded model, K1 on the
    whole predictions on the first device, sums pass 1's statistics over
    the ranks and back-propagates each rank's own, then sums the
    gradients over the ranks once (``sum_over_ranks``); under
    ``--dtype bf16_params`` ``_mean_over_ranks`` averages the f32 master
    gradients."""

    sum_over_ranks = staticmethod(sum_over_ranks_)

    def __init__(self, config, info: Optional[runtime.RuntimeInfo] = None,
                 devices: Optional[Sequence[torch.device]] = None):
        n = parse_mesh_spec(config.train_method).model
        if info is None:
            info = runtime.initialize_from_env(
                devices[0] if devices else config.device, n)
        devs = ([torch.device(d) for d in devices] if devices is not None
                else runtime.stage_devices(config.device, info.local_rank, n))
        self.devices = devs[:n]
        Strategy.__init__(self, config, dataclasses.replace(
            info, device=self.devices[0]))

    @property
    def drop_last_train(self) -> bool:
        return True

    def place_model(self, model: torch.nn.Module) -> torch.nn.Module:
        _global_batchnorm(model)
        return super().place_model(model)

    def train_loss(self, fused: bool) -> Callable:
        return make_sharded_loss(fused)

    def reduce_grads(self, model, optimizer) -> Callable:
        return _mean_over_ranks(model, optimizer)


class ZeroSteps:
    """The train steps over a ZeRO point's placed ``parallel/zero.ZeroSharded``
    (``DxMx1@fsdp``, ``DxMx1@sp+fsdp``): the model itself, trained with
    the optimizer (``train_with``, which under master weights makes a
    step's leaves float32); ``reduce_grads_`` between the backward and
    Adam; an accumulation step opened by one held gather and closed by one
    reduce-scatter of the ranks' sum (``accum_hooks``). A checkpoint
    gathers the whole tensors on every rank (``gathers_state``)."""

    gathers_state = True

    def wrap_model(self, model: torch.nn.Module,
                   optimizer=None) -> torch.nn.Module:
        """The placed model itself, trained with ``optimizer``: it
        gathers, then recomputes under ``--remat`` (``place_model``)."""
        if optimizer is not None:
            model.train_with(optimizer)
        return model

    def accum_module(self, model, optimizer):
        return self.wrap_model(model, optimizer), False

    def accum_hooks(self, model) -> Dict[str, Callable]:
        return {"open_step": lambda: model.gather_(hold=True),
                "close_step": lambda: model.reduce_grads_(mean=False)}

    def reduce_grads(self, model, optimizer) -> Callable:
        return model.reduce_grads_


class ZeroTensorParallel(ZeroSteps, DataTensorParallel):
    """``-t DxMx1@fsdp`` with D, M > 1, ZeRO × channel (JAX ``2x2x1@fsdp``,
    the ``fsdp+channel`` rule): ``DataTensorParallel`` with each channel
    slice's parameters and Adam's state cut again over the ranks
    (``parallel/zero.ZeroSharded``). The top of each forward puts every
    slice together on its card (one ``all_gather_into_tensor`` per
    tensor), the gradients are reduce-scattered back to each rank's
    piece, averaged over the ranks (``reduce_grads``), and Adam steps
    the pieces. A checkpoint gathers the whole tensors on every rank
    (``gathers_state``), which rank 0 writes; a resume cuts each rank's
    piece. The run control is ``ZeroSharded``'s (``parallel/zero.py``):
    under ``--remat`` one gather, then the channel-sharded model
    recomputed segment by segment on its leaves; the accumulation's one
    gather and one reduce-scatter of the ranks' sum; under ``--dtype
    bf16_params`` float32 leaves, reduce-scattered into the masters'
    gradients."""

    def place_model(self, model: torch.nn.Module) -> torch.nn.Module:
        from distributedpytorch_tpu_torch.parallel.zero import ZeroSharded

        return ZeroSharded(super().place_model(model),
                           remat=self.config.remat)


class ZeroSpatial(ZeroSteps, GenericMesh, ShardedState, HybridDataSpatial):
    """``-t DxMx1@sp+fsdp`` with D, M > 1, ZeRO over row shards (JAX
    ``2x2x1@sp+fsdp``: ``MeshConfig(data=D, model=M,
    model_role="spatial", params="fsdp")``): ``HybridDataSpatial`` (one
    process per data row, each row-sharding its batch over M devices of
    its own; the shards' loss, the BatchNorm moments over the shards and
    the ranks, eval over the shards, the ragged batch dropped) with each
    parameter and Adam's state over it cut over the ranks
    (``parallel/zero.ZeroSharded`` over the rank's ``RowSharded``): a
    parameter whose dim 0 divides the world keeps this rank's dim-0 piece
    on the rank's first device, the 1-channel head's whole on every
    rank. The JAX package keeps a piece on every (data, spatial) device
    and cuts a leaf's largest divisible HWIO axis (``state_leaf_spec``);
    the function is the same.

    The top of each forward gathers every cut parameter whole on the
    first device (one ``all_gather_into_tensor`` per tensor, the same
    order on every rank), the shards then compute as under DDP_SP, each
    past the first with its own copy of the gathered leaves
    (``replicas.read_params``), and after the backward each gradient is
    reduce-scattered back to the rank's piece, averaged over the ranks
    (``reduce_grads``: the statistics' all-reduce makes each rank's
    gradient ``world ×`` its share, as under DDP_SP), and the leaves are
    dropped; eval gathers and drops around its forward. A checkpoint
    gathers the whole tensors under the reference names on every rank
    (``gathers_state``), which rank 0 writes; a resume cuts each rank's
    piece. The run control is ``ZeroSharded``'s (``parallel/zero.py``):
    under ``--remat`` one gather, then each shard recomputed with the
    halo rows and moments it kept, as under DDP_SP; the accumulation's
    one gather and one reduce-scatter of the ranks' sum, each chunk's
    statistics the shards' (``accum_stats``); under ``--dtype
    bf16_params`` float32 leaves, each shard computing with its own cast
    of them, reduce-scattered into the masters' gradients."""

    def place_model(self, model: torch.nn.Module) -> torch.nn.Module:
        from distributedpytorch_tpu_torch.parallel.zero import (
            PlainState,
            ZeroSharded,
        )

        model = super().place_model(model)
        return ZeroSharded(RowSharded(model, self.devices,
                                      over_ranks=self.over_ranks,
                                      remat=self.config.remat),
                           state=PlainState(model))


class InStage(ShardedState):
    """Sharding inside each pipeline stage (``parallel/in_stage.py``, JAX
    ``HYBRID_SPECS``): the pipeline of S stages it runs over (``Pipeline``
    at D = 1, ``HybridDataPipeline``'s data ranks at D > 1) with each
    stage's parameters cut over its M devices and, under ``@fsdp`` with
    D > 1, again over the ranks. The process's M·S devices (``places``)
    are ordered as the JAX mesh orders its axes, data, model, stage, with
    stage fastest: stage s computes on ``places[s]``, as its ``Dx1xS``
    twin does, and its channel slices lie on ``places[i·S + s]``, i < M
    (``cuda:(LOCAL_RANK·M·S + i·S + s)`` by default; on the CPU and on a
    card named by its index every place is that device). The manifest's
    ``topology.mesh`` lists the axes in that order. A checkpoint holds
    the whole tensors under the reference names (``ShardedState``),
    gathered on every rank under ``@fsdp`` (``gathers_state``), and rank 0
    writes it; a resume cuts each place's pieces again.

    The run control is the pipeline's, on the leaves its ``open_step``
    gathered (``parallel/pipeline.py``): ``--remat`` recomputes each
    stage on them, with no gather and no collective in the backward;
    ``--dtype bf16_params`` makes them float32, gpipe's microbatches each
    computing with casts of their own, and sends their gradients to the
    masters of the pieces; ``--steps-per-dispatch K`` captures K steps
    over every place (``step_devices``), the gathers and reductions
    inside. ``--grad-accum`` is refused, in the JAX pipeline's words
    (``check_run_control``)."""

    def __init__(self, config, info: Optional[runtime.RuntimeInfo] = None,
                 devices: Optional[Sequence[torch.device]] = None):
        # devices: plan_mesh's M·S, which build_strategy always passes
        super().__init__(config, info, devices)
        cfg = self.mesh_config
        self.places = [torch.device(d)
                       for d in devices][:cfg.model * cfg.stage]

    @property
    def gathers_state(self) -> bool:
        cfg = self.mesh_config
        return cfg.data > 1 and "fsdp" in cfg.params

    @property
    def step_devices(self) -> List[torch.device]:
        """Every place, the stage devices first: a K-step graph streams
        and pools each card a piece lies on."""
        return list(self.places)

    def place_model(self, model: torch.nn.Module) -> torch.nn.Module:
        """The stages on their devices, then each stage's parameters cut
        over its places (and the ranks)."""
        model = super().place_model(model)
        return shard_stages(model, self.stages, self.places,
                            self.mesh_config)


class InStagePipeline(GenericMesh, InStage, Pipeline):
    """``-t 1xMxS`` (and ``1xMxS@fsdp``, the same at one rank) with M > 1:
    one process, ``InStage`` over ``Pipeline``."""


class InStageHybridPipeline(GenericMesh, InStage, HybridDataPipeline):
    """``-t DxMxS`` with D, M > 1, and ``Dx1xS@fsdp`` / ``DxMxS@fsdp`` with
    D > 1: one process per data row, ``InStage`` over
    ``HybridDataPipeline``'s data ranks (their statistics, gradient and
    BatchNorm seams, over the data ranks only: the model axis computes
    once)."""


#: the class each spec runs as, with the specs' semantics over it
_MESH_TWINS = {
    cls: type(f"Mesh{cls.__name__}", (GenericMesh, cls), {})
    for cls in (SingleDevice, DistributedDataParallel,
                FullyShardedDataParallel, TensorParallel, SpatialParallel,
                HybridDataSpatial, Pipeline, HybridDataPipeline)}


def _mesh_class(cfg: MeshConfig) -> type:
    fsdp = "fsdp" in cfg.params
    if in_stage_config(cfg) is not None:
        return InStageHybridPipeline if cfg.data > 1 else InStagePipeline
    if cfg.stage > 1:
        legacy = HybridDataPipeline if cfg.data > 1 else Pipeline
    elif cfg.model > 1 and cfg.model_role == "spatial":
        if cfg.data > 1 and fsdp:
            return ZeroSpatial
        legacy = HybridDataSpatial if cfg.data > 1 else SpatialParallel
    elif cfg.model > 1:
        if cfg.data > 1:
            return ZeroTensorParallel if fsdp else DataTensorParallel
        legacy = TensorParallel
    else:
        legacy = (FullyShardedDataParallel if fsdp
                  else DistributedDataParallel if cfg.data > 1
                  else SingleDevice)
    return _MESH_TWINS[legacy]


def check_train_method(method: str) -> None:
    """What ``-t`` refuses from its name alone, before any group is
    joined: a name that is neither a method nor a mesh spec (the JAX
    words), a malformed spec (``parse_mesh_spec``'s) and a spatial model
    axis inside a pipeline stage (JAX's own refusal, :983-992): every
    spec the JAX package trains, the port trains."""
    if method in STRATEGIES:
        return
    if not is_mesh_spec(method):
        raise ValueError(
            f"Unknown train method {method!r}; "
            f"expected one of {sorted(STRATEGIES)} or a mesh spec "
            f"DxMxS[@fsdp|sp] (docs/DISTRIBUTED.md 'The mesh engine')")
    cfg = parse_mesh_spec(method)
    name = canonical_spec(cfg)
    if cfg.stage > 1 and cfg.model > 1 and cfg.model_role == "spatial":
        raise ValueError(
            f"mesh {name}: a 'spatial' model role inside a "
            f"pipeline stage is not executable — spatial sharding "
            f"halo-exchanges inside every schedule tick, which the "
            f"stage-gated lax.cond program cannot carry; use the "
            f"channel role on the model axis "
            f"('{cfg.data}x{cfg.model}x{cfg.stage}') or keep spatial "
            f"sharding on a flat mesh "
            f"('{cfg.data}x{cfg.model}x1@sp') (ROADMAP.md, Queue A: the "
            f"JAX package refuses it too)")


def plan_mesh(config, world: int,
              info: Optional[runtime.RuntimeInfo] = None,
              devices: Optional[Sequence[torch.device]] = None
              ) -> Tuple[type, object, List[torch.device]]:
    """``(class, config, devices)`` of the mesh spec ``config.train_method``
    over ``world`` processes: the class it runs as (``GenericMesh``), the
    config with ``num_stages`` the stage axis, and this process's M·S
    devices (``devices`` where given). Raises the JAX package's loud
    failures of an infeasible geometry first (JAX strategy.py:973-1029),
    in the port's terms: a data axis other than the launched world, too
    few devices, a batch the microbatches do not divide, rows the
    spatial axis does not divide."""
    check_train_method(config.train_method)
    cfg = parse_mesh_spec(config.train_method)
    name = canonical_spec(cfg)
    per = cfg.model * cfg.stage
    if devices is not None:
        have = len(devices)
    else:
        dev = resolve_device(config.device)
        have = per
        if dev.type == "cuda" and dev.index is None:
            local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
            have = torch.cuda.device_count() // max(1, local_world)
    if cfg.data > world or per > have:
        raise ValueError(f"mesh {name} needs {cfg.size} devices, "
                         f"got {world * min(per, have)}")
    if cfg.data < world:
        raise ValueError(
            f"mesh {name}: {world} processes launched for a data axis of "
            f"{cfg.data} (one process per data row) — explicit mesh specs "
            f"never shrink silently; launch {cfg.data}")
    # the port's data axis is its processes: the global batch b × D
    # always divides D, and a stage axis needs b % microbatches
    global_batch = config.batch_size * world
    if cfg.stage > 1:
        _check_schedule(config)
        mb = config.num_microbatches
        if global_batch % (cfg.data * mb):
            raise ValueError(
                f"mesh {name}: global batch {global_batch} "
                f"(batch_size {config.batch_size} x "
                f"{world} processes) must be a "
                f"multiple of data x microbatches = {cfg.data} x {mb}")
        config = dataclasses.replace(config, num_stages=cfg.stage)
    if cfg.model > 1 and cfg.model_role == "spatial":
        h = config.image_size[1]
        deep = 2 ** config.model_levels
        if (h // deep) % cfg.model:
            raise ValueError(
                f"mesh {name}: the deepest level's {h // deep} "
                f"image rows must divide the spatial axis "
                f"({cfg.model})")
    if devices is None:
        local_rank = (info.local_rank if info is not None else
                      (runtime.torchrun_env()
                       or runtime.RuntimeInfo(0, 1)).local_rank)
        devices = runtime.stage_devices(config.device, local_rank, per)
    return (_mesh_class(cfg), config,
            [torch.device(d) for d in devices][:per])


def joins_group(cls: type) -> bool:
    """Whether a process of strategy ``cls`` joins the process group (the
    torchrun contract: DDP, FSDP, DDP_MP, DDP_SP and their specs)."""
    return issubclass(cls, MultiProcessMixin)


def check_run_control(config, device: Optional[torch.device] = None,
                      backend: Optional[str] = None) -> None:
    """The run control's limits of the port, the same under every method:
    ``--grad-accum`` together with ``--steps-per-dispatch K > 1`` and
    ``--grad-accum`` of milesial, whose BatchNorm statistics do not add up
    over chunks, each refused with the JAX package's words; under
    in-stage sharding (``in_stage.in_stage_config``) ``--grad-accum``, in
    the JAX pipeline's words (``PIPELINE_ACCUM``); once the strategy
    knows its ``device`` and its group's ``backend``,
    ``--steps-per-dispatch K > 1`` under gloo on a card. All but the last
    raise before any group is joined."""
    method = config.train_method
    k = int(config.steps_per_dispatch)
    grad_accum = int(config.grad_accum)
    if k > 1 and grad_accum > 1:
        raise ValueError(STACKS_CONFLICT)
    if grad_accum > 1 and getattr(config, "model_arch", "unet") == "milesial":
        raise ValueError(STATEFUL_ACCUM)
    mesh = parse_mesh_spec(method) if is_mesh_spec(method) else None
    if (grad_accum > 1 and mesh is not None
            and in_stage_config(mesh) is not None):
        raise ValueError(PIPELINE_ACCUM)
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
    HybridDataPipeline, SpatialParallel, HybridDataSpatial, TensorParallel,
    FullyShardedDataParallel)}


def build_strategy(config, info: Optional[runtime.RuntimeInfo] = None,
                   devices: Optional[Sequence[torch.device]] = None
                   ) -> Strategy:
    """``config.train_method`` → its strategy, on ``devices`` where one is
    given (DP, MP, SP, TP, each DDP_MP and DDP_SP rank, and a mesh spec's
    M·S devices of this process; every method takes its first as its
    device). A mesh spec runs as ``GenericMesh`` says (``plan_mesh``,
    which also raises for a name that is neither). What ``-t`` refuses
    (``check_train_method``), an infeasible mesh and the limits of
    ``check_run_control`` raise before any group is joined."""
    check_run_control(config)
    cls = STRATEGIES.get(config.train_method)
    if cls is None:
        cls, config, devices = plan_mesh(
            config, info.num_processes if info is not None
            else runtime.planned_world(), info, devices)
    strategy = cls(config, info, devices)
    check_run_control(config, strategy.device, strategy.backend)
    return strategy

