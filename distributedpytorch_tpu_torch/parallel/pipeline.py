"""Microbatched pipeline schedules over S stages: ``-t MP`` and, one per
data rank, ``-t DDP_MP``; with sharding inside each stage, ``-t DxMxS``
(M > 1) and ``DxMxS@fsdp`` (``parallel/in_stage.py``).

Counterpart of ``distributedpytorch_tpu/parallel/pipeline.py``. The
reference's ``-t MP`` is a hand-written two-stage pipeline over
``cuda:0``/``cuda:1`` with two microbatches
(reference model/unet_model.py:14-53): while ``cuda:1`` decodes
microbatch i, ``cuda:0`` encodes microbatch i+1, because CUDA launches
are asynchronous. The port keeps that mechanism and generalises it as the
JAX package does:

* **Segments and cuts.** A model exposes its linear block order as 2L+1
  segments (``UNet.apply_segment``, ``MilesialUNet.apply_segment``); a
  stage is a contiguous run of them and ``cuts`` picks the boundaries.
  S = 2 is the reference's cut (encoder + mid | decoder + head); other S
  split evenly (``default_cuts``, the JAX rule and errors).
* **Stages.** ``Stage`` holds its segments' layers on its own device, the
  reference's layout: each stage's parameters live on its card (the JAX
  package replicates them over the stage axis; the function is the same).
  The carry ``(x, skips)`` moves to the next stage's device on the
  current stream (``utils/device.copy_to``, whose backward a CUDA graph
  captures). A device may
  repeat: the CPU tests put every stage on the CPU and a one-card run
  every stage on ``cuda:0``.
* **gpipe.** Fill-drain: microbatch m runs at stage s on tick s+m, issued
  in tick order so the stages' launches overlap across cards. The loss is
  not microbatch-additive (the log of a ratio of whole-batch sums), so
  each microbatch's four statistics are summed on the last stage's card
  and ``loss_from_stats`` forms one loss; autograd gives the pipelined
  backward. Every microbatch's stage activations stay alive until that
  backward, so memory grows with M.
* **1f1b.** PipeDream-flush, as the JAX package builds it. Phase A is a
  forward-only statistics pass (``no_grad``), which gives the global
  statistics and their cotangent ``ct``; phase B runs 2(M+S−1) ticks, the
  forward of (s, m) on tick s+2m and its backward on tick 2S−1−s+2m. A
  stage keeps only its input carry between the two; its backward tick
  runs its segments again with grad from that carry, against the incoming
  cotangent (``ct`` at the last stage). At most ≈S−s carries are held at
  stage s whatever M is, at the price of one more forward per microbatch
  (two at the stages before the last). Weight gradients accumulate in
  the float32 ``.grad`` of the stage's parameters.
* **BatchNorm (milesial).** GPipe's treatment: statistics per microbatch,
  the running averages moved once per microbatch in microbatch order.
  Under 1f1b phase A moves them, and phase B's forwards run under
  ``frozen_running_stats`` (JAX ``fwd_stage``).
* **Eval.** The fill-drain forward in eval mode (running averages), the
  predictions gathered on the last stage's card.
* **Data ranks (DDP_MP).** With ``data_parallel`` every rank of the
  default group runs this pipeline on its own shard, and three seams
  close the step as the JAX psums over ('stage', 'data') do: the
  statistics summed over the ranks before the loss (pipeline.py:590,
  :770), each stage's gradients summed over the ranks after the schedule,
  before Adam (``_reduce_grads``, :870), and the running averages' deltas
  averaged over the ranks (``_combine_bn``, :372-384). BatchNorm
  normalizes each microbatch with its own shard's moments. The gradient
  factor differs per schedule: gpipe's statistics go through
  ``all_reduce_sum``, whose backward sums the cotangent over the ranks,
  so each rank's gradient is ``world ×`` its share and the ranks' mean is
  the global loss's; 1f1b feeds every rank the global cotangent from
  phase A, so each rank holds its share once and the ranks' sum is.

* **Run control.** ``remat`` recomputes each stage's forward in its
  backward (``models.Rematerialized``, JAX ``_build_stage_fns``
  pipeline.py:230-276), under both schedules: gpipe keeps each stage's
  input carries only, and 1f1b's backward units run their stage once more
  inside autograd's backward. The seeds (gpipe's loss, 1f1b's
  cotangent) carry the policy's ``backward_scale``: under master weights
  (``bf16_params``) each unit's bf16 gradients add up in the f32 master
  gradients, the data ranks sum those, and the master's step scales
  them, the JAX policy's order. gpipe's one backward runs every
  microbatch, so each microbatch's stages compute with their own cast
  of the f32 masters (``PerUse``), and the microbatches' gradients add
  at the f32 leaf, as the JAX gpipe differentiates an f32 view
  (pipeline.py:699-707).

``LiveCarries`` counts what each stage holds for its backward, per tick:
the input carries under 1f1b, the microbatches whose graph autograd keeps
under gpipe.

* **In-stage sharding.** Where ``model`` is a ``parallel/zero.
  ZeroSharded`` (``in_stage.shard_stages``) its stages' parameters lie in
  pieces: the step's top puts every cut one whole on its stage's device
  before any tick, and its end cuts each gradient back to its pieces and
  reduces them over the data ranks (the mean or the sum above) before
  Adam steps the pieces; eval gathers at its top and drops at its end.
  The run control runs on those leaves: ``remat`` recomputes each stage
  on them, so no recompute gathers or meets the ranks (1f1b's phase A
  and every phase-B unit read the same leaves); under master weights
  they are float32 (``ZeroSharded.train_with``), gpipe's microbatches
  each compute with casts of their own (``ZeroSharded.casts_of``, built
  anew by each step) and 1f1b's units add at the leaves in float32, and
  their gradients go to the masters of the pieces; a K-step graph
  captures the gathers, reductions and drops with the steps.

* **A CUDA graph of K steps** (``train/steps.MultiStep``) captures either
  schedule, on one card or across cards: the copies between cards run on
  the current streams of both cards, which the capture has joined, and
  the zero gradients of ``optimizer_grads``, ``_reduce_grads`` and
  ``_combine_bn`` allocate and reduce on the card without reading
  anything back. The Python tick loop and 1f1b's ``saved`` carries run
  at the warm-up and at the capture only.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from distributedpytorch_tpu_torch.dist.collectives import (
    all_reduce_sum,
    sum_over_ranks_,
)
from distributedpytorch_tpu_torch.models import rematerialized
from distributedpytorch_tpu_torch.models.milesial import (
    BatchNormAct,
    frozen_running_stats,
)
from distributedpytorch_tpu_torch.ops.fused_loss import (
    loss_and_cotangent,
    stats_function,
)
from distributedpytorch_tpu_torch.ops.losses import loss_from_stats
from distributedpytorch_tpu_torch.ops.precision import (
    PerUseCasts,
    backward_scale,
    optimizer_grads,
    per_use_casts,
)
from distributedpytorch_tpu_torch.parallel.zero import ZeroSharded
from distributedpytorch_tpu_torch.train.steps import (
    Batch,
    batch_metrics,
    prep_mask,
    scaled,
)
from distributedpytorch_tpu_torch.utils.device import copy_to

PIPELINE_SCHEDULES = ("gpipe", "1f1b")

Carry = Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]


def default_cuts(num_segments: int, num_stages: int) -> Tuple[int, ...]:
    """Stage boundaries (the segment index each stage s ≥ 1 starts at).

    S = 2 is the reference's cut, encoder + mid | decoder + head, the
    boundary after segment L of 2L+1. Other S split the segments as
    evenly as possible, the remainder on the last stages: the shallow
    encoder levels carry most of the operations."""
    if num_stages == 2:
        return ((num_segments - 1) // 2 + 1,)
    base, rem = divmod(num_segments, num_stages)
    sizes = [base + (1 if i >= num_stages - rem else 0)
             for i in range(num_stages)]
    cuts, acc = [], 0
    for size in sizes[:-1]:
        acc += size
        cuts.append(acc)
    return tuple(cuts)


def _stage_ranges(num_segments: int, num_stages: int,
                  cuts: Optional[Sequence[int]]) -> List[range]:
    """The segments of each stage; the JAX package's errors for a bad
    stage count or bad cuts."""
    if num_stages < 1 or num_stages > num_segments:
        raise ValueError(
            f"num_stages {num_stages} out of range for a "
            f"{num_segments}-segment model"
        )
    cuts = (tuple(cuts) if cuts is not None
            else default_cuts(num_segments, num_stages))
    if len(cuts) != num_stages - 1 or list(cuts) != sorted(set(cuts)) or any(
        not 0 < c < num_segments for c in cuts
    ):
        raise ValueError(
            f"cuts {cuts} must be {num_stages - 1} strictly increasing "
            f"segment indices in (0, {num_segments})"
        )
    bounds = (0,) + cuts + (num_segments,)
    return [range(bounds[s], bounds[s + 1]) for s in range(num_stages)]


def _microbatch_size(batch_size: int, num_microbatches: int) -> int:
    if batch_size < num_microbatches or batch_size % num_microbatches:
        raise ValueError(
            f"per-shard batch {batch_size} must be a positive "
            f"multiple of num_microbatches={num_microbatches}"
        )
    return batch_size // num_microbatches


def _carry_to(carry: Carry, device: torch.device) -> Carry:
    x, skips = carry
    return copy_to(x, device), tuple(copy_to(t, device) for t in skips)


class Stage(nn.Module):
    """Stage s: the segments ``segments`` of ``model``, whose layers it
    holds and moves to ``device``. Called on a carry on that device, it
    returns the carry its last segment leaves."""

    def __init__(self, model: nn.Module, segments: range,
                 device: torch.device):
        super().__init__()
        self.segments = segments
        self.device = torch.device(device)
        self.layers = nn.ModuleList(
            layer for seg in segments for layer in model.segment_modules(seg))
        self.layers.to(self.device)
        self._run_segment = model.apply_segment

    def forward(self, carry: Carry) -> Carry:
        x, skips = carry
        for seg in self.segments:
            x, skips = self._run_segment(x, skips, seg)
        return x, skips


class PerUse(nn.Module):
    """``stage`` run with its parameters as ``casts`` gives them for one
    use (``ops/precision.PerUseCasts``), so that the microbatches of one
    gpipe backward add their gradients in f32 under master weights."""

    def __init__(self, stage: Stage, casts: PerUseCasts):
        super().__init__()
        self.module = stage
        self.device = stage.device
        self._casts = casts

    def forward(self, carry: Carry) -> Carry:
        return torch.func.functional_call(
            self.module, self._casts.named_casts(), (carry,))


def build_stages(model: nn.Module, devices: Sequence[torch.device],
                 cuts: Optional[Sequence[int]] = None) -> List[Stage]:
    """One stage per device, ``len(devices)`` of them, each on its
    device with its layers."""
    ranges = _stage_ranges(model.num_segments, len(devices), cuts)
    return [Stage(model, rng, dev) for rng, dev in zip(ranges, devices)]


class LiveCarries:
    """What each stage holds for its backward: ``now[s]`` and the most it
    held at once, ``peak[s]``. It counts on the host, as the schedule's
    Python runs: eager steps, and a K-step graph's warm-up and capture,
    not its replays."""

    def __init__(self, num_stages: int):
        self.now = [0] * num_stages
        self.peak = [0] * num_stages

    def hold(self, stage: int) -> None:
        self.now[stage] += 1
        self.peak[stage] = max(self.peak[stage], self.now[stage])

    def release(self, stage: int) -> None:
        self.now[stage] -= 1

    def release_all(self) -> None:
        self.now = [0] * len(self.now)


def fill_drain(stages: Sequence[Stage], inputs: Sequence[Carry],
               finish: Callable[[int, torch.Tensor], torch.Tensor],
               live: Optional[LiveCarries] = None) -> list:
    """The fill-drain forward: microbatch m at stage s on tick s+m, the
    stages issued in order within a tick. Returns ``finish(m, y)`` of each
    microbatch's output ``y`` in microbatch order, on the last stage's
    device; ``live`` counts every stage forward as held."""
    num_stages, num_mb = len(stages), len(inputs)
    # a stage, or a wrapper of it (Rematerialized, PerUse)
    devices = [getattr(st, "module", st).device for st in stages]
    edge: List[Optional[Carry]] = [None] * (num_stages - 1)
    outs = []
    for tick in range(num_mb + num_stages - 1):
        sent: List[Optional[Carry]] = [None] * (num_stages - 1)
        for s, stage in enumerate(stages):
            m = tick - s
            if not 0 <= m < num_mb:
                continue
            carry = inputs[m] if s == 0 else edge[s - 1]
            if live is not None:
                live.hold(s)
            out = stage(carry)
            if s < num_stages - 1:
                sent[s] = _carry_to(out, devices[s + 1])
            else:
                outs.append(finish(m, out[0]))
        edge = sent
    return outs


def _grad_or_zeros(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(t) if t.grad is None else t.grad


def _backward_unit(stage: Stage, carry: Carry, input_grads: bool,
                   cotangent, finish: Optional[Callable] = None
                   ) -> Optional[Carry]:
    """1f1b's backward of one stage and microbatch: the stage's segments
    run again with grad from the saved input ``carry`` and back-propagate
    ``cotangent`` (a carry's, or with ``finish`` the statistics' ``ct``
    through ``finish(y)``). Returns the cotangent of the input carry when
    ``input_grads``."""
    x, skips = carry
    if input_grads:
        x = x.detach().requires_grad_(True)
        skips = tuple(t.detach().requires_grad_(True) for t in skips)
    with torch.enable_grad():
        y, out_skips = stage((x, skips))
        if finish is not None:
            torch.autograd.backward(finish(y), cotangent)
        else:
            ct_x, ct_skips = cotangent
            pairs = [(t, g) for t, g in zip((y, *out_skips),
                                            (ct_x, *ct_skips))
                     if t.requires_grad]
            torch.autograd.backward([t for t, _ in pairs],
                                    [g for _, g in pairs])
    if not input_grads:
        return None
    return _grad_or_zeros(x), tuple(_grad_or_zeros(t) for t in skips)


def _split(batch: Batch, num_mb: int, last: torch.device):
    """The batch's microbatch carries (on its device), its target on the
    last stage's device, and ``rows(m)``, microbatch m's slice."""
    images = batch["image"]
    mb = _microbatch_size(images.shape[0], num_mb)
    target = prep_mask(batch["mask"]).to(last, non_blocking=True)

    def rows(m: int) -> slice:
        return slice(m * mb, (m + 1) * mb)

    return [(images[rows(m)], ()) for m in range(num_mb)], target, rows


def _summed(per_mb: Sequence[torch.Tensor]) -> torch.Tensor:
    stats = per_mb[0]
    for more in per_mb[1:]:
        stats = stats + more
    return stats


def _reduce_grads(grads: Sequence[torch.Tensor], mean: bool) -> None:
    """The step's gradients (``optimizer_grads``: one per parameter, zeros
    where there is none, so every rank reduces the same tensors) summed
    (``mean``: averaged) over the data ranks, one flat all-reduce per
    stage device (JAX ``_reduce_grads``)."""
    sum_over_ranks_(list(grads), mean=mean)


def _running_stats(model: nn.Module) -> List[torch.Tensor]:
    return [t for m in model.modules() if isinstance(m, BatchNormAct)
            for t in (m.running_mean, m.running_var)]


def _combine_bn(running: Sequence[torch.Tensor],
                before: Sequence[torch.Tensor]) -> None:
    """Each running average set to ``before`` plus the data ranks' mean
    of how far it moved this step (JAX ``_combine_bn``)."""
    deltas = [r - b for r, b in zip(running, before)]
    sum_over_ranks_(deltas, mean=True)
    with torch.no_grad():
        for r, b, d in zip(running, before, deltas):
            r.copy_(b + d)


def make_pipeline_train_step(
    model: nn.Module,
    stages: Sequence[Stage],
    optimizer: torch.optim.Optimizer,
    batch_size: int,
    num_microbatches: int = 2,
    schedule: str = "gpipe",
    faithful_loss_scaling: bool = True,
    train_loss_fused: bool = False,
    data_parallel: bool = False,
    remat: bool = False,
) -> Callable[[Batch], torch.Tensor]:
    """``step(batch) -> unscaled loss`` (on the last stage's device) of
    the ``schedule`` over ``stages``, then Adam. Each microbatch's
    statistics come from ``stats_function(train_loss_fused)``: K1 forward
    and K1-bwd backward on the card. The faithful scale is
    ``batch_size``, the whole batch's (per process under
    ``data_parallel``), as in the JAX package (strategy.py:331-336).
    ``data_parallel`` makes the ranks of the default group data replicas
    of this pipeline (the module docstring's three seams): the loss is
    the global batch's, the same on every rank. ``step.live`` is the
    schedule's ``LiveCarries``. ``remat`` recomputes each stage in its
    backward. A ``ZeroSharded`` ``model`` is gathered at the top of each
    step and its gradients cut back to its pieces at the end (in-stage
    sharding)."""
    if schedule not in PIPELINE_SCHEDULES:
        raise ValueError(
            f"pipeline schedule must be one of {PIPELINE_SCHEDULES}, "
            f"got {schedule!r}"
        )
    num_mb = int(num_microbatches)
    num_stages = len(stages)
    scale = float(batch_size) if faithful_loss_scaling else 1.0
    stats_fn = stats_function(train_loss_fused)
    last = stages[-1].device
    live = LiveCarries(num_stages)
    params = list(model.parameters())
    running = _running_stats(model) if data_parallel else []
    sharded = model if isinstance(model, ZeroSharded) else None
    if sharded is not None:
        # under master weights a step's leaves are float32
        sharded.train_with(optimizer)
    runs = [rematerialized(stage, remat) for stage in stages]
    # under master weights, a stage's casts of its f32 sources: the
    # masters, or a ZeroSharded model's leaves of the step
    casts_of = (sharded.casts_of if sharded is not None
                else lambda stage: per_use_casts(optimizer, stage))

    def open_step() -> List[torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        if sharded is not None:
            # every stage's leaves whole on its device, before any tick
            # and outside any recomputed region (JAX _gather_params)
            sharded.gather_(train=True)
        return [r.clone() for r in running]

    def close_step(before: List[torch.Tensor], mean: bool) -> None:
        if sharded is not None:
            # the leaves' gradients back to their pieces, reduced over the
            # data ranks (JAX _slice_to_shard after the closing psum)
            sharded.reduce_grads_(mean)
        elif data_parallel:
            _reduce_grads(optimizer_grads(optimizer, params), mean)
        if running:
            _combine_bn(running, before)
        optimizer.step()

    def gpipe_step(batch: Batch) -> torch.Tensor:
        before = open_step()
        inputs, target, rows = _split(batch, num_mb, last)
        # one backward over every microbatch: under master weights each
        # microbatch's stage computes with its own casts of the sources
        gpipe_runs = [
            rematerialized(st if casts is None else PerUse(st, casts),
                           remat)
            for st, casts in ((st, casts_of(st)) for st in stages)]
        per_mb = fill_drain(gpipe_runs, inputs,
                            lambda m, y: stats_fn(y, target[rows(m)]), live)
        stats = _summed(per_mb)
        loss = loss_from_stats(all_reduce_sum(stats) if data_parallel
                               else stats)
        scaled(loss, backward_scale(optimizer, scale)).backward()
        live.release_all()
        # the statistics' all-reduce summed the cotangent over the ranks
        close_step(before, mean=True)
        return loss.detach()

    def one_f_one_b_step(batch: Batch) -> torch.Tensor:
        before = open_step()
        inputs, target, rows = _split(batch, num_mb, last)

        def stats(m: int, y: torch.Tensor) -> torch.Tensor:
            return stats_fn(y, target[rows(m)])

        # phase A: the global statistics, forward only; moves BatchNorm's
        # running averages once per microbatch
        with torch.no_grad():
            per_mb = fill_drain(stages, inputs, stats)
            summed = _summed(per_mb)
            if data_parallel:
                summed = all_reduce_sum(summed)
        loss, ct = loss_and_cotangent(summed,
                                      backward_scale(optimizer, scale))
        # phase B: forward of (s, m) on tick s+2m, backward on tick
        # 2S-1-s+2m; one stage's two tick sets have opposite parities
        saved: Dict[Tuple[int, int], Carry] = {}
        fwd: List[Optional[Carry]] = [None] * (num_stages - 1)
        bwd: List[Optional[Carry]] = [None] * (num_stages - 1)
        with frozen_running_stats(model):
            for tick in range(2 * (num_mb + num_stages - 1)):
                sent_fwd: List[Optional[Carry]] = [None] * (num_stages - 1)
                sent_bwd: List[Optional[Carry]] = [None] * (num_stages - 1)
                for s, stage in enumerate(stages):
                    m, odd = divmod(tick - s, 2)
                    if not odd and 0 <= m < num_mb:
                        carry = inputs[m] if s == 0 else fwd[s - 1]
                        saved[(s, m)] = carry
                        live.hold(s)
                        # the last stage only banks its carry: its
                        # compute happens in its backward tick
                        if s < num_stages - 1:
                            with torch.no_grad():
                                sent_fwd[s] = _carry_to(
                                    stage(carry), stages[s + 1].device)
                    m, odd = divmod(tick - (2 * num_stages - 1 - s), 2)
                    if not odd and 0 <= m < num_mb:
                        carry = saved.pop((s, m))
                        live.release(s)
                        if s == num_stages - 1:
                            grads = _backward_unit(
                                runs[s], carry, s > 0, ct,
                                finish=lambda y, m=m: stats(m, y))
                        else:
                            grads = _backward_unit(runs[s], carry, s > 0,
                                                   bwd[s])
                        if s > 0:
                            sent_bwd[s - 1] = _carry_to(
                                grads, stages[s - 1].device)
                fwd, bwd = sent_fwd, sent_bwd
        # every rank fed the global cotangent: each holds its share once
        close_step(before, mean=False)
        return loss

    step = gpipe_step if schedule == "gpipe" else one_f_one_b_step
    step.live = live
    return step


def make_pipeline_eval_step(
    model: nn.Module,
    stages: Sequence[Stage],
    num_microbatches: int = 2,
    eval_stats_fused: bool = False,
) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """``step(batch) -> {'loss', 'dice'}``: the fill-drain forward in eval
    mode (running averages), the predictions gathered on the last stage's
    device and measured there (one K1 launch per batch when
    ``eval_stats_fused``). Counterpart of ``make_pipeline_forward_fn``
    (JAX :942-1032) with the eval metrics; a ``ZeroSharded`` ``model``
    is gathered at its top and dropped at its end (JAX :949-1030)."""
    num_mb = int(num_microbatches)
    last = stages[-1].device
    whole = (model.whole if isinstance(model, ZeroSharded)
             else contextlib.nullcontext)

    @torch.no_grad()
    def eval_step(batch: Batch) -> Dict[str, torch.Tensor]:
        model.eval()
        inputs, target, _ = _split(batch, num_mb, last)
        with whole():
            preds = torch.cat(fill_drain(stages, inputs, lambda m, y: y))
        return batch_metrics(preds, target, eval_stats_fused)

    return eval_step
