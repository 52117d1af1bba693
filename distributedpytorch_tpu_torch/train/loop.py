"""The trainer: epoch loop, eval, scheduler, checkpoints and run control.

Counterpart of ``distributedpytorch_tpu/train/loop.py`` (``Trainer``,
``fit``) for ``-t singleGPU`` / ``DP`` / ``DDP`` / ``MP`` / ``DDP_MP`` /
``SP`` / ``DDP_SP``. A
strategy (``parallel/strategy.py``) says what differs between them, and
builds the train and eval steps:

* per step: forward, backward and Adam with the batch-size loss-scaling
  quirk; the unscaled loss is recorded and stays on the card until its
  metrics row is read;
* per epoch: eval → val row → ``scheduler.step(val_loss)`` → the new lr
  on the optimizer; ``--save-best`` writes ``<method>_best.pt`` on a
  higher val Dice; a native checkpoint every ``checkpoint_every_epochs``;
  ``--early-stop N`` ends the run after N epochs without a better val
  loss, with a save (loop.py:1224-1254);
* at the end: the final checkpoint, the loss tables and
  ``<checkpoint_dir>/<method>.pth`` in reference format (upstream
  milesial names for ``--model milesial``), which the serve CLI loads as
  it is; ``train()`` returns once every async checkpoint write is on
  disk, and raises a write's error (loop.py:504-561);
* under DDP: each rank trains on its shard of every epoch
  (``ShardSpec(rank, world)``, the ragged batch dropped) with the lr
  times the world size, every step's loss is the global batch's and the
  same on every rank, the val batches are split over the ranks and every
  rank reads all their metrics, so the plateau scheduler moves in
  lockstep (loop.py:223-230, :1183-1202), and rank 0 alone writes the
  checkpoint, the loss tables and the ``.pth`` (loop.py:500, :541,
  :1226, :1293). Every rank restores from the same file, at any world
  size: the parameters are replicated;
* under DP and MP: one process; the model's layers sit on the strategy's
  devices (every stage's on its card under MP), its state dict gathers
  them under the singleGPU keys, so a checkpoint of any method resumes
  under any other and at any stage count;
* under DDP_MP: DDP's contract with MP's layout, one pipeline per rank:
  each rank places its batch on its stage 0's device, and rank 0 writes,
  its state dict gathering every stage's parameters;
* under SP: one process, the batch placed on the first shard's device,
  the model there, the rows split over the shards in each step; under
  DDP_SP DDP's contract with one SP per rank.

A stateful model's running statistics (milesial's BatchNorm) are buffers
of its state dict, so the native checkpoint saves and restores them; the
steps switch the model between train and eval mode.

Host and card overlap: batches decode on the loader's threads, and a
placement worker copies them from pinned memory to the card on a copy
stream ``prefetch_batches`` ahead of the step loop (a ``--grad-accum`` or
``--steps-per-dispatch`` group as one stacked payload); the step loop
makes the compute stream wait for each copy's event. Nothing in the loop
waits for the card except a metrics row falling due (for the previous
row), the per-epoch eval and the ``skip`` policy. Each of these phases is
a span of the step timeline (``utils/trace.py``, ``--trace-timeline``):
``decode``, ``stack``, ``h2d``, ``dispatch`` (the host's enqueue of a
step) and ``readback``.

``--steps-per-dispatch K`` groups K full batches into one call of the
strategy's multi-step (one CUDA graph of K steps on the card, over every
card of a pipeline, K plain steps on the CPU); its ``(K,)`` losses, on
the card of the step's loss (a pipeline's last stage), are read once per
row. The ragged tail of an epoch runs as single steps of the same train
step, on the same parameters and optimizer state (loop.py:991-1020):
under DDP through the one DDP wrapper the graph drives.

A non-finite train loss (``nonfinite_policy``, loop.py:609-670, :926,
:961-990, :1256-1272): ``abort`` raises ``NonFiniteLossError`` when its
row is read; ``rollback`` catches it in the epoch loop, reloads the newest
intact checkpoint in place and redoes its epoch, up to
``rollback_retries`` times, in a single process only; ``skip`` reads
every step's loss and, where it is non-finite, puts back the state from
before the step (parameters, optimizer state, BatchNorm buffers, step
count) from a copy on the device. Under DDP every rank decides alike: the
loss is the global batch's. The split is the JAX package's
(``seeded_split`` with seed 0, one split for every strategy), and the
train order per epoch comes from ``(seed, epoch)``, so a port run and a
JAX run from the same weights see the same batches.

The preemption stop (loop.py:753-837): SIGTERM and SIGINT set a flag
while ``train()`` runs (off the main thread the handler cannot be
installed and the feature is off, as in JAX). A single process stops
before its next dispatch, so the dispatch in flight (a K-step graph's
replay included) finishes; several processes decide at each epoch's end,
by one all-gather of ``[flag, step]`` over the world group, and stop
together when any rank saw a signal, or with the JAX "desynced at step
agreement" error when their steps differ. The stop saves the full state
at the interrupted epoch's index (a resume redoes it), writes the loss
tables and the ``.pth``, and returns once the checkpoint is on disk.

The profiler window (loop.py:706-727, :910-918): ``profile_steps (N,
M)`` wraps the dispatches that touch steps [N, M) in one
``torch.profiler.profile`` (CPU and CUDA activities) on the main rank,
rounded out to whole dispatches; ``profile_dir`` alone captures the
whole run. It writes torch's chrome trace,
``<dir>/<method>.rank0.steps<a>-<b>.pt.trace.json`` with the steps it
covered, not the JAX XPlane, and stops in ``train()``'s ``finally``. It
raises, rather than nest, where another profiler is running.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import logging
import os
import signal
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distributedpytorch_tpu_torch.checkpoint import (
    JAX_EXT,
    NATIVE_EXT,
    TRAIN_EXTS,
    host_snapshot,
    jax_topology,
    load_jax_ckpt,
    load_native,
    load_pth,
    resolve_checkpoint,
    retained_checkpoints,
    save_native_async,
    save_pth,
    write_payload,
)
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.data.dataset import (
    SampleCache,
    SyntheticSegmentationDataset,
    build_dataset,
)
from distributedpytorch_tpu_torch.data.loader import DataLoader, seeded_split
from distributedpytorch_tpu_torch.evaluate import evaluate_sharded
from distributedpytorch_tpu_torch.models import create_model
from distributedpytorch_tpu_torch.ops.kernels import (
    config_priors,
    get_kernel_policy,
)
from distributedpytorch_tpu_torch.ops.optim import (
    get_learning_rate,
    load_optimizer_state,
    make_optimizer,
    set_learning_rate,
)
from distributedpytorch_tpu_torch.ops.precision import (
    POLICIES,
    cast_params_,
    convert_checkpoint_state,
    get_policy,
    has_master_weights,
)
from distributedpytorch_tpu_torch.ops.schedule import ReduceLROnPlateau
from distributedpytorch_tpu_torch.parallel.strategy import (
    Strategy,
    build_strategy,
    check_run_control,
)
from distributedpytorch_tpu_torch.train.steps import STACKS_CONFLICT
from distributedpytorch_tpu_torch.utils.metrics import LossRecords
from distributedpytorch_tpu_torch.utils.prefetch import (
    SINGLE,
    pipelined_placement,
    stacked_work,
)
from distributedpytorch_tpu_torch.utils.trace import StepTimeline, rank_path

logger = logging.getLogger(__name__)

NONFINITE_POLICIES = ("abort", "rollback", "skip")


class NonFiniteLossError(RuntimeError):
    """A train loss read back NaN or infinite."""


@dataclasses.dataclass
class Placed:
    """A batch on the card; ``ready`` marks the end of its copy (None on
    the CPU)."""

    tensors: Dict[str, torch.Tensor]
    ready: Optional["torch.cuda.Event"] = None


def check_config(config: TrainConfig) -> None:
    """The JAX trainer's refusals, word for word (loop.py:246-265), and
    the policy's name."""
    if config.nonfinite_policy not in NONFINITE_POLICIES:
        raise ValueError(
            f"nonfinite_policy must be abort|rollback|skip, got "
            f"{config.nonfinite_policy!r}"
        )
    if config.early_stop_patience < 0:
        raise ValueError(
            f"early_stop_patience must be >= 0 (0 = off), got "
            f"{config.early_stop_patience}"
        )
    k_dispatch = max(1, int(config.steps_per_dispatch))
    grad_accum = max(1, int(config.grad_accum))
    if k_dispatch > 1 and grad_accum > 1:
        raise ValueError(STACKS_CONFLICT)
    if config.nonfinite_policy == "skip" and (k_dispatch > 1
                                              or grad_accum > 1):
        raise ValueError(
            "--nonfinite-policy skip discards one STEP's update, which "
            "a fused dispatch / accumulated step cannot isolate — use "
            "rollback or abort with --steps-per-dispatch/--grad-accum"
        )


#: profiler sessions ``warm_profiler`` tries before one that records no
#: device activity for work that surely ran on the card counts as a fault
PROFILER_TRIES = 3
_profiler_warm = False


def warm_profiler(device: torch.device) -> int:
    """Start the profiler's device tracing (CUPTI) once in this process,
    before a session whose trace is kept: a process's first session on the
    card can come back without any device activity. Profiles a small
    kernel on ``device`` until the trace holds it and returns the
    sessions that took (0 once the process is warm); raises after
    ``PROFILER_TRIES``."""
    global _profiler_warm
    from torch.profiler import ProfilerActivity, profile

    if _profiler_warm:
        return 0
    x = torch.ones(1024, device=device)
    for tries in range(1, PROFILER_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            x.mul_(1.0)
            torch.cuda.synchronize(device)
        if any(evt.device_type == torch.autograd.DeviceType.CUDA
               for evt in prof.events()):
            _profiler_warm = True
            return tries
    raise RuntimeError(f"the profiler saw no kernel on {device} in "
                       f"{PROFILER_TRIES} sessions")


class ProfileWindow:
    """One ``torch.profiler.profile`` over the dispatches that touch the
    steps ``[lo, hi)`` (``steps`` None: every dispatch of the run), CPU
    and CUDA activities, written as a chrome trace into ``out_dir`` when
    it stops. ``tick(step, size)`` comes before each dispatch of ``size``
    steps after ``step`` completed ones; ``stop(step)`` ends a window
    still open (at the end of the run). On the card the process's
    profiler is warmed up first (``warm_profiler``), so the window's
    trace holds the card's kernels in a fresh process too."""

    def __init__(self, steps: Optional[Tuple[int, int]], out_dir: str,
                 method: str, device: torch.device):
        self.steps = steps
        self.out_dir = out_dir
        self.method = method
        self.device = device
        self.prof = None
        self.first: Optional[int] = None
        self.done = False
        self.path: Optional[str] = None

    def tick(self, step: int, size: int) -> None:
        if self.prof is None:
            if self.done:
                return
            if self.steps is None or (step < self.steps[1]
                                      and step + size > self.steps[0]):
                self._start(step)
        elif self.steps is not None and step >= self.steps[1]:
            self.stop(step)

    def _start(self, step: int) -> None:
        from torch.profiler import ProfilerActivity, profile

        if torch.autograd._profiler_enabled():
            raise RuntimeError(
                "profiler window: another torch.profiler is running — one "
                "profiler at a time; the window does not nest")
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            warm_profiler(self.device)
            activities.append(ProfilerActivity.CUDA)
        logger.info("profiler: capturing a trace from step %d%s → %s", step,
                    "" if self.steps is None
                    else f" (steps [{self.steps[0]}, {self.steps[1]}) asked)",
                    self.out_dir)
        self.prof = profile(activities=activities)
        self.prof.start()
        self.first = step

    def stop(self, step: int) -> None:
        """End the capture after ``step`` completed steps and write it."""
        if self.prof is None:
            return
        prof, self.prof = self.prof, None
        self.done = True
        if self.device.type == "cuda":
            # every card of the step: the window's kernels end inside it
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)
        prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        self.path = os.path.join(
            self.out_dir,
            f"{self.method}.rank0.steps{self.first}-{step}.pt.trace.json")
        prof.export_chrome_trace(self.path)
        logger.info("profiler: steps [%d, %d) captured → %s", self.first,
                    step, self.path)


class _Snapshot:
    """A copy on the device of everything a step changes (policy
    ``skip``): the model's parameters and buffers, and the optimizer's
    state dict, the master weights with it. ``put_back`` restores it:
    the model in place, the optimizer through its ``load_state_dict``,
    which drops the state the step created."""

    def __init__(self, model: torch.nn.Module, optimizer):
        self.optimizer = optimizer
        self.tensors = [*model.parameters(), *model.buffers()]
        self.saved = [t.detach().clone() for t in self.tensors]
        self.opt = copy.deepcopy(optimizer.state_dict())

    @torch.no_grad()
    def put_back(self) -> None:
        for t, v in zip(self.tensors, self.saved):
            t.copy_(v)
        self.optimizer.load_state_dict(self.opt)


class Trainer:
    """``Trainer(config).train()`` runs ``config.epochs`` epochs.

    ``initial_state`` is a model state dict to start from in place of the
    seeded init (tests start from JAX weights through
    ``checkpoint.params_from_jax``); ``strategy`` one already built (by
    default ``build_strategy(config, devices=devices)``, which joins the
    process group under DDP; ``devices`` is the device list of DP and MP,
    which may repeat a device)."""

    def __init__(self, config: TrainConfig, dataset=None,
                 initial_state: Optional[Dict[str, torch.Tensor]] = None,
                 strategy: Optional[Strategy] = None,
                 devices: Optional[Sequence[torch.device]] = None):
        check_config(config)
        self.config = config
        self.strategy = strategy or build_strategy(config, devices=devices)
        # a strategy built elsewhere: the run control's limits, with its
        # device and group
        check_run_control(config, self.strategy.device,
                          self.strategy.backend)
        self.device = self.strategy.device
        # the probe priors' rejections disengage their kernels here, before
        # the model and the steps are built
        self.kernels = get_kernel_policy(config.kernels, self.device,
                                         priors=config_priors(config) or {})
        self.policy = get_policy(config)
        self.dataset = dataset if dataset is not None else self._build_dataset()
        # the step timeline: rank R of a multi-process run writes
        # <path>.rankR; no path, no spans
        rank = self.strategy.rank
        self.tracer = StepTimeline(rank_path(config.timeline_path, rank),
                                   rank=rank)
        # one decoded-sample cache for the train and val loaders
        cache = (SampleCache(int(config.host_cache_mb) * 2**20)
                 if config.host_cache_mb > 0 else None)

        # float32 parameters first: under master weights the master is
        # seeded from them before they are rounded to the policy's dtype,
        # as the JAX create_train_state does
        model = create_model(
            config, generator=torch.Generator().manual_seed(config.seed),
            cast_params=False)
        if initial_state is not None:
            model.load_state_dict(initial_state)
        self.model = self.strategy.place_model(model)
        self.k_dispatch = max(1, int(config.steps_per_dispatch))
        self.grad_accum = max(1, int(config.grad_accum))
        lr0 = self.strategy.lr_for(config.learning_rate)
        # a CUDA graph of K steps reads Adam's lr and step from the card,
        # from each card the step computes on
        self.optimizer = make_optimizer(
            self.model.parameters(), lr0, config.weight_decay,
            policy=self.policy,
            capturable=self.k_dispatch > 1 and all(
                d.type == "cuda" for d in self.strategy.step_devices))
        cast_params_(self.model, self.policy)
        self.scheduler = ReduceLROnPlateau(lr=lr0,
                                           patience=config.plateau_patience,
                                           factor=config.plateau_factor)
        self.records = self._new_records()
        self.step = 0
        self.start_epoch = 0
        self._last_saved_epoch: Optional[int] = None
        # the trainer's small state that a checkpoint carries (train_meta)
        self._best_dice = float("-inf")
        self._best_loss = float("inf")
        self._stale_epochs = 0
        # counts down over the run, not per epoch: a run that keeps going
        # non-finite aborts in the end
        self._rollback_budget = int(config.rollback_retries)
        self._skipped_steps = 0
        # futures of async checkpoint writes, drained before train()
        # returns
        self._ckpt_futures: List = []
        self._stop_requested = False
        self._prev_handlers: Dict = {}
        self.profile_window: Optional[ProfileWindow] = None
        if self.strategy.is_main and (config.profile_steps is not None
                                      or config.profile_dir):
            self.profile_window = ProfileWindow(
                config.profile_steps,
                config.profile_dir or os.path.join(config.log_dir, "profile"),
                config.train_method, self.device)
        self.multi_step = None
        if config.checkpoint_name:
            self._restore(config.checkpoint_name)

        train_idx, val_idx = seeded_split(len(self.dataset),
                                          config.val_fraction, seed=0)
        if len(val_idx) < config.batch_size and self.strategy.is_main:
            logger.warning(
                "validation split has %d samples < batch size %d — every "
                "val batch is dropped and val loss/Dice will be NaN; raise "
                "-v/--validation or lower -b", len(val_idx),
                config.batch_size,
            )
        self.train_loader = DataLoader(
            self.dataset, indices=train_idx, batch_size=config.batch_size,
            shuffle=True, drop_last=self.strategy.drop_last_train,
            seed=config.seed, shard=self.strategy.data_shard(),
            num_workers=config.num_workers, cache=cache, tracer=self.tracer,
        )
        self.val_loader = DataLoader(
            self.dataset, indices=val_idx, batch_size=config.batch_size,
            shuffle=False, drop_last=True, num_workers=config.num_workers,
            cache=cache,
        )
        # the strategy's steps: the DDP-wrapped model's under DDP, the
        # replicas' under DP, the schedule's under MP; self.model stays
        # the bare model, which saves and serves
        self.train_step = self.strategy.build_train_step(
            self.model, self.optimizer, self.kernels)
        self.accum_step = (
            self.strategy.build_accum_train_step(
                self.model, self.optimizer, self.kernels)
            if self.grad_accum > 1 else None
        )
        if self.k_dispatch > 1:
            # the same step: one DDP wrapper, one pipeline, for the
            # graph and the epoch's tail
            self.multi_step = self.strategy.build_multi_train_step(
                self.train_step)
        self.eval_step = self.strategy.build_eval_step(self.model,
                                                       self.kernels)
        self.copy_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)

    # -- set-up ---------------------------------------------------------------
    def _build_dataset(self):
        cfg = self.config
        if cfg.synthetic_samples > 0:
            return SyntheticSegmentationDataset(
                length=cfg.synthetic_samples, newsize=cfg.image_size,
                seed=cfg.seed,
            )
        return build_dataset(os.path.join(cfg.data_dir, cfg.images_subdir),
                             os.path.join(cfg.data_dir, cfg.masks_subdir),
                             cfg.image_size)

    def _new_records(self) -> LossRecords:
        cfg = self.config
        return LossRecords(cfg.train_method, cfg.loss_dir,
                           every=cfg.metric_every_steps,
                           nonfinite_hook=self._on_nonfinite_loss,
                           tracer=self.tracer)

    def _ckpt_path(self, tag: Optional[str] = None) -> str:
        tag = tag or self.config.train_method
        return os.path.join(self.config.checkpoint_dir, f"{tag}{NATIVE_EXT}")

    @property
    def checkpoint_path(self) -> str:
        return self._ckpt_path()

    @property
    def best_checkpoint_path(self) -> str:
        return self._ckpt_path(f"{self.config.train_method}_best")

    @property
    def weights_path(self) -> str:
        return os.path.join(self.config.checkpoint_dir,
                            f"{self.config.train_method}.pth")

    def topology(self) -> dict:
        """The JAX manifest's ``topology`` of this run (JAX
        checkpoint.save_topology and strategy.topology)."""
        return jax_topology(self.strategy.name, self.strategy.mesh_shape(),
                            self.policy.name)

    def _manifest(self) -> dict:
        return {
            "dtype": self.config.dtype,
            "model_arch": self.config.model_arch,
            "kernels": self.kernels.name,
            "train_method": self.config.train_method,
            **self.strategy.topology(),
            "topology": self.topology(),
            "device": (torch.cuda.get_device_name(self.device)
                       if self.device.type == "cuda" else "cpu"),
        }

    def _param_names(self) -> List[str]:
        return [name for name, _ in self.model.named_parameters()]

    def _restore(self, name: str) -> None:
        """``-c``: resume the full state from a native checkpoint or a JAX
        ``.ckpt`` (the newest intact file of its chain), converted from
        the policy it was saved under to this run's; or load the weights
        alone from a reference ``.pth`` (under master weights the master
        is seeded from them, or the fresh init's master would win at the
        first update). A checkpoint saved under another topology logs
        the JAX "mesh-resharding restore" warning (loop.py:418-440): its
        tensors are whole and load under any layout."""
        path = resolve_checkpoint(name, self.config.checkpoint_dir,
                                  exts=TRAIN_EXTS)
        if path.endswith(".pth"):
            weights = load_pth(path)
            self.model.load_state_dict(weights)
            if has_master_weights(self.optimizer):
                self.optimizer.reseed_(
                    [weights[n] for n in self._param_names()])
            logger.info("Loaded reference .pth weights from %s", path)
            return
        payload = (load_jax_ckpt(path, self.config.weight_decay)
                   if path.endswith(JAX_EXT) else load_native(path))
        saved = payload["manifest"]
        arch = saved.get("model_arch", "unet")
        if arch != self.config.model_arch:
            raise ValueError(
                f"{path} holds a {arch!r} model; this run builds "
                f"{self.config.model_arch!r} (--model)")
        saved_policy = POLICIES.get(saved.get("dtype") or "bf16")
        if saved_policy is None:
            raise ValueError(f"{path} was saved under an unknown precision "
                             f"policy {saved.get('dtype')!r}")
        model_state, opt_state = convert_checkpoint_state(
            saved_policy, self.policy, payload["model"],
            payload["optimizer"], self._param_names(),
            where=f"restore {path}")
        self.model.load_state_dict(model_state)
        if opt_state is not None:
            load_optimizer_state(self.optimizer, opt_state)
        elif has_master_weights(self.optimizer):
            # weights only: the master is the restored weights
            logger.warning("restore %s: checkpoint carries no optimizer "
                           "state — re-seeding the %r master weights from "
                           "the restored params", path, self.policy.name)
            self.optimizer.reseed_(
                [payload["model"][n] for n in self._param_names()])
        self.scheduler.load_state_dict(payload["scheduler"])
        set_learning_rate(self.optimizer, self.scheduler.lr)
        self.step = int(payload["step"])
        self.start_epoch = int(payload["epoch"])
        if payload.get("records"):
            self.records.load_state_dict(payload["records"])
        else:  # nothing to resume: drop what this run recorded
            self.records = self._new_records()
        meta = payload.get("train_meta") or {}
        self._best_dice = float(meta.get("best_dice", float("-inf")))
        self._best_loss = float(meta.get("best_loss", float("inf")))
        self._stale_epochs = int(meta.get("stale_epochs", 0))
        if self.multi_step is not None:
            # the optimizer's state tensors were replaced: capture again
            self.multi_step.reset()
        logger.info("Resumed from %s at epoch %d (step %d)", path,
                    self.start_epoch, self.step)
        saved_topo = saved.get("topology")
        if saved_topo is not None:
            current = self.topology()
            # a --dtype change is a precision conversion, logged above
            current.pop("precision")
            if {k: saved_topo.get(k) for k in current} != current:
                logger.warning(
                    "mesh-resharding restore: checkpoint saved under %s, "
                    "restoring onto %s — gathered host arrays re-placed "
                    "under the current mesh", saved_topo, current)

    # -- placement --------------------------------------------------------------
    def _place(self, batch) -> Placed:
        """A host batch (or a stacked group of them) → the card: pinned
        memory, copied on the copy stream, an event at its end. On the CPU
        the arrays are shared."""
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
        if self.copy_stream is None:
            return Placed(host)
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self.copy_stream):
            tensors = {k: v.pin_memory().to(self.device, non_blocking=True)
                       for k, v in host.items()}
            ready = torch.cuda.Event()
            ready.record(self.copy_stream)
        return Placed(tensors, ready)

    def _claim(self, placed: Placed) -> Dict[str, torch.Tensor]:
        """The placed tensors, usable on the current stream: it waits for
        the copy, and the copy stream's memory is kept until it is done."""
        if placed.ready is None:
            return placed.tensors
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(placed.ready)
        for t in placed.tensors.values():
            t.record_stream(stream)
        return placed.tensors

    def place_batch(self, batch) -> Dict[str, torch.Tensor]:
        """A host batch → tensors ready on the current stream."""
        return self._claim(self._place(batch))

    # -- failure policy -----------------------------------------------------------
    def _on_nonfinite_loss(self, step: int, value: float) -> None:
        """LossRecords' hook for a non-finite loss read back. ``skip``
        checks every step in the loop, so reaching here under it means an
        unguarded path: log and go on. ``abort`` and ``rollback`` raise;
        the epoch loop catches it for ``rollback``."""
        if self.config.nonfinite_policy == "skip":
            logger.warning(
                "non-finite loss %s at step %d reached the metrics drain "
                "under policy 'skip' (unguarded path) — continuing",
                value, step)
            return
        raise NonFiniteLossError(
            f"non-finite train loss {value} at step {step} "
            f"(policy={self.config.nonfinite_policy})")

    def _try_rollback(self, exc: Exception) -> bool:
        """``rollback``: reload the newest intact checkpoint in place and
        let the epoch loop redo its epoch. False (the caller re-raises)
        for another policy, a multi-process run, a spent budget or no
        checkpoint."""
        cfg = self.config
        if cfg.nonfinite_policy != "rollback":
            return False
        if self.strategy.world > 1:
            # ranks would race rank 0's write and could restore different
            # epochs: the launcher's restart owns multi-process recovery
            logger.error(
                "rollback policy is single-process; multi-process runs "
                "abort and rely on the launcher's restart loop")
            return False
        if self._rollback_budget <= 0:
            logger.error(
                "rollback budget exhausted (%d rollbacks used) — aborting",
                cfg.rollback_retries)
            return False
        # the checkpoint may still be queued on the writer
        self._drain_checkpoint_futures(raise_errors=False)
        path = self.checkpoint_path
        if not retained_checkpoints(path):
            logger.error("rollback requested but no checkpoint at %s", path)
            return False
        self._rollback_budget -= 1
        logger.warning("%s — rolling back to %s (%d retries left)", exc,
                       path, self._rollback_budget)
        self._restore(cfg.train_method)
        self._last_saved_epoch = None
        return True

    # -- checkpoints ---------------------------------------------------------------
    def _train_meta(self) -> dict:
        return {"best_dice": self._best_dice, "best_loss": self._best_loss,
                "stale_epochs": self._stale_epochs}

    def save(self, epoch: int) -> None:
        """The native checkpoint at the end of ``epoch`` (once per epoch),
        written by the main process; the decision depends on the epoch
        alone, so every rank reaches it in lockstep."""
        if epoch == self._last_saved_epoch:
            return
        self._last_saved_epoch = epoch
        if not self.strategy.is_main:
            return
        self._save_tagged(self.checkpoint_path, epoch)

    def _save_tagged(self, path: str, epoch: int) -> None:
        """One save of the main process: the host snapshot here, the write
        on the background writer (``async_checkpoint``) or here, keeping
        the newest ``keep_checkpoints`` files of ``path``. An earlier async
        write's error is raised now, and more than two writes in flight
        wait for the oldest (loop.py:504-561)."""
        cfg = self.config
        if cfg.async_checkpoint:
            for fut in [f for f in self._ckpt_futures if f.done()]:
                self._ckpt_futures.remove(fut)
                fut.result()
            while len(self._ckpt_futures) > 2:
                self._ckpt_futures.pop(0).result()
        payload = host_snapshot(
            self.model, self.optimizer, self.scheduler.state_dict(),
            self.step, epoch, self.records.state_dict(), self._manifest(),
            self._train_meta())
        if cfg.async_checkpoint:
            self._ckpt_futures.append(
                save_native_async(path, payload, cfg.keep_checkpoints))
        else:
            write_payload(path, payload, cfg.keep_checkpoints)

    def _drain_checkpoint_futures(self, raise_errors: bool) -> None:
        """Wait for every queued write; the first error raises when asked
        (a clean exit) and is logged otherwise (another error is already
        unwinding)."""
        futures, self._ckpt_futures = self._ckpt_futures, []
        first = None
        for fut in futures:
            try:
                fut.result()
            except Exception as exc:  # noqa: BLE001 — raised below
                logger.exception("async checkpoint write failed")
                first = first or exc
        if first is not None and raise_errors:
            raise first

    # -- the loop ------------------------------------------------------------------
    def _run_one(self, batch, placed: Placed) -> None:
        tensors = self._claim(placed)
        snapshot = (_Snapshot(self.model, self.optimizer)
                    if self.config.nonfinite_policy == "skip" else None)
        with self.tracer.span("dispatch", step=self.step + 1):
            loss = self.train_step(tensors)
        if snapshot is not None and not np.isfinite(float(loss)):
            # the one host sync per step this policy costs
            self._skipped_steps += 1
            logger.warning("non-finite loss at step %d: update discarded "
                           "(%d skipped so far)", self.step + 1,
                           self._skipped_steps)
            snapshot.put_back()
            return
        self.step += 1
        # the images of the global batch, as the JAX loop counts
        self.records.record_train(
            self.step, loss, batch["image"].shape[0] * self.strategy.world)

    def _run_stack(self, batches, placed: Placed) -> None:
        stacked = self._claim(placed)
        with self.tracer.span("dispatch", step=self.step + 1,
                              k=len(batches)):
            losses = self.multi_step(stacked)
        # views into one (K,) tensor: a row reads them in one copy
        for i, b in enumerate(batches):
            self.step += 1
            self.records.record_train(
                self.step, losses[i],
                b["image"].shape[0] * self.strategy.world)

    def _run_accum(self, batches, placed: Placed) -> None:
        stacked = self._claim(placed)
        chunks = [{k: v[i] for k, v in stacked.items()}
                  for i in range(len(batches))]
        with self.tracer.span("dispatch", step=self.step + 1,
                              k=len(batches)):
            loss = self.accum_step(chunks)
        self.step += 1
        self.records.record_train(
            self.step, loss,
            sum(b["image"].shape[0] for b in batches) * self.strategy.world)

    def _train_epoch(self, epoch: int) -> None:
        cfg = self.config
        stack_size = (self.k_dispatch if self.multi_step is not None
                      else self.grad_accum)
        run_stack = (self._run_stack if self.multi_step is not None
                     else self._run_accum)
        source = pipelined_placement(
            stacked_work(self.train_loader.epoch_batches(epoch), stack_size,
                         cfg.batch_size),
            # a STACK arrives stacked by pipelined_placement: (K, B, ...)
            lambda _kind, payload: self._place(payload),
            depth=cfg.prefetch_batches,
            name="dpt-train-place", tracer=self.tracer,
        )
        single_process = self.strategy.world == 1
        with contextlib.closing(source):
            for (kind, payload), placed in source:
                # a single process stops before its next dispatch; several
                # agree at the epoch's end (_stop_agreed)
                if self._stop_requested and single_process:
                    break
                if self.profile_window is not None:
                    self.profile_window.tick(
                        self.step, len(payload) if kind != SINGLE
                        and self.multi_step is not None else 1)
                if kind == SINGLE:
                    self._run_one(payload, placed)
                else:
                    run_stack(payload, placed)

    def _end_epoch(self, epoch: int) -> bool:
        """Eval, the val row, the scheduler, ``--save-best``, the epoch's
        checkpoint and ``--early-stop``; True when the run stops early."""
        cfg = self.config
        val_loss, val_dice = evaluate_sharded(
            self.eval_step, self.val_loader, self.place_batch,
            self.strategy.eval_shard())
        self.val_loss, self.val_dice = val_loss, val_dice
        self.records.record_val(self.step, val_loss, val_dice)
        new_lr = self.scheduler.step(val_loss)
        if not np.isclose(new_lr, get_learning_rate(self.optimizer),
                          rtol=1e-6):
            logger.info("Epoch %d: plateau → lr %.3e", epoch + 1, new_lr)
            set_learning_rate(self.optimizer, new_lr)
        logger.info(
            "Epoch %d/%d: val loss %.4f, val dice %.4f (%.1f imgs/s)",
            epoch + 1, cfg.epochs, val_loss, val_dice,
            self.records.images_per_second(),
        )
        self.tracer.flush()
        # val_dice is the same on every rank: all take this branch
        if cfg.save_best and val_dice > self._best_dice:
            self._best_dice = val_dice
            if self.strategy.is_main:
                self._save_tagged(self.best_checkpoint_path, epoch + 1)
            logger.info("New best val Dice %.4f at epoch %d → %s", val_dice,
                        epoch + 1, self.best_checkpoint_path)
        if cfg.checkpoint_every_epochs and (
                (epoch + 1) % cfg.checkpoint_every_epochs == 0):
            self.save(epoch + 1)
        if cfg.early_stop_patience:
            # a NaN val loss (empty split) never counts as better
            if val_loss < self._best_loss:
                self._best_loss = val_loss
                self._stale_epochs = 0
            else:
                self._stale_epochs += 1
                if self._stale_epochs >= cfg.early_stop_patience:
                    logger.info(
                        "Early stop at epoch %d: val loss has not improved "
                        "for %d epochs (best %.4f)", epoch + 1,
                        self._stale_epochs, self._best_loss)
                    self.save(epoch + 1)
                    return True
        return False

    def _run(self) -> dict:
        cfg = self.config
        logger.info(
            "Training %s on %s (rank %d of %d): %d epochs, batch %d per "
            "process (%d global), lr %.2e, %d train batches, kernels %s, "
            "dtype %s", cfg.train_method, self.device, self.strategy.rank,
            self.strategy.world, cfg.epochs, cfg.batch_size,
            self.strategy.global_batch_size,
            get_learning_rate(self.optimizer), len(self.train_loader),
            self.kernels.name, cfg.dtype,
        )
        self.val_loss = self.val_dice = float("nan")
        stopped_early = stopped_by_signal = False
        # while, not for: a rollback rewinds the epoch
        epoch = self.start_epoch
        while epoch < cfg.epochs:
            try:
                self._train_epoch(epoch)
                if self._stop_agreed():
                    # the state at the interrupted epoch's index: a resume
                    # redoes that epoch (the dedup guard is cleared, the
                    # state is newer than the save of the same index)
                    self._last_saved_epoch = None
                    self.save(epoch)
                    logger.info("Stopped by signal at epoch %d step %d; "
                                "checkpoint saved", epoch + 1, self.step)
                    stopped_by_signal = True
                    break
                if self._end_epoch(epoch):
                    stopped_early = True
                    break
            except NonFiniteLossError as exc:
                if not self._try_rollback(exc):
                    raise
                epoch = self.start_epoch  # the restore rewound it
                continue
            epoch += 1
        if not (stopped_early or stopped_by_signal):
            self.save(cfg.epochs)
        if (cfg.save_best and self.strategy.is_main
                and self._best_dice == float("-inf")):
            logger.warning(
                "--save-best: no epoch produced a finite val Dice "
                "(empty/missing validation split?) — %s was never written",
                self.best_checkpoint_path)
        if self.strategy.is_main:
            self.records.save()
            save_pth(self.model.state_dict(), self.weights_path)
        return {
            "val_loss": self.val_loss,
            "val_dice": self.val_dice,
            "steps": self.step,
            "images_per_second": self.records.images_per_second(),
            "n_train": self.train_loader.num_samples(),
            # updates discarded by 'skip' and rollbacks used
            "skipped_steps": self._skipped_steps,
            "rollbacks": cfg.rollback_retries - self._rollback_budget,
        }

    # -- preemption ----------------------------------------------------------------
    def _install_signal_handler(self) -> None:
        """SIGTERM and SIGINT set the stop flag for the rest of
        ``train()``. Off the main thread ``signal.signal`` raises, and the
        feature is off (the signals keep their default action)."""
        self._stop_requested = False
        self._prev_handlers = {}

        def request_stop(signum, frame):
            self._stop_requested = True
            logger.info("Signal %d: will checkpoint and stop at the next "
                        "step", signum)

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev_handlers[sig] = signal.signal(sig, request_stop)
            except ValueError:  # not the main thread
                pass

    def _restore_signal_handler(self) -> None:
        for sig, handler in self._prev_handlers.items():
            signal.signal(sig, handler)
        self._prev_handlers = {}

    def _stop_agreed(self) -> bool:
        """Whether to stop at this epoch's end: the flag of a single
        process (or of a strategy with no process group); across
        processes one all-gather of ``[flag, step]`` over the world group (on the rank's card under NCCL, the CPU under
        gloo), True when any rank saw a signal, or when the ranks' steps
        differ, with the JAX desync error (loop.py:793-837)."""
        import torch.distributed as dist

        if self.strategy.world == 1 or not dist.is_initialized():
            return self._stop_requested
        device = (self.device if self.strategy.backend == "nccl"
                  else torch.device("cpu"))
        mine = torch.tensor([int(self._stop_requested), self.step],
                            dtype=torch.int64, device=device)
        rows = [torch.empty_like(mine) for _ in range(self.strategy.world)]
        dist.all_gather(rows, mine)
        flags = torch.stack(rows).cpu()
        steps = [int(s) for s in flags[:, 1]]
        if len(set(steps)) > 1:
            logger.error("rank %d: desynced at step agreement — per-rank "
                         "steps %s", self.strategy.rank, steps)
            return True
        return bool(flags[:, 0].any())

    def train(self) -> dict:
        """Run the epochs; returns once every checkpoint write is on disk
        (a write's error raises here on a clean run). The signal handlers
        and the profiler window live for the call, also when it raises."""
        self._install_signal_handler()
        ok = False
        try:
            result = self._run()
            ok = True
            return result
        finally:
            self._restore_signal_handler()
            try:
                if self.profile_window is not None:
                    # the run ended inside the window, or a whole-run one
                    self.profile_window.stop(self.step)
            finally:
                self.tracer.flush()
                self._drain_checkpoint_futures(raise_errors=ok)


def fit(config: TrainConfig, dataset=None) -> dict:
    """Build a Trainer and run it."""
    return Trainer(config, dataset=dataset).train()
