"""The train and eval steps of the trainer.

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
  running averages, as the JAX package's stateful steps do;
* under ``-t DDP`` the strategy supplies the loss, one loss over the
  global batch, and the DDP-wrapped model; gradient accumulation sums
  its statistics and gradients over the ranks (strategy.py:296-314);
* ``remat`` recomputes the forward in the backward
  (``models.Rematerialized``); the loss stays outside the recomputed
  region, so K1 and K1-bwd launch once per step as without it;
* the precision policy's gradient contract (JAX steps.py:191-205) is
  ``ops/precision``'s: the backward's seed carries the factor
  ``backward_scale`` gives (``batch_size`` with float32 parameters, 1
  under master weights, whose step widens and then scales), and
  ``optimizer_grads`` are what the step reads;
* under ``-t SP`` and ``-t DDP_SP`` the strategy's module returns the
  predictions as row shards, one per device (``parallel/spatial.py``):
  the loss, gradient accumulation's statistics and the eval metrics run
  per shard (``shard_metrics``), and under DDP_SP the gradients are
  averaged over the ranks between the backward and Adam
  (``reduce_grads``);
* ``make_multi_train_step`` runs K whole steps per call: on the card one
  CUDA graph of them, over every card the strategy's step computes on
  (TP's channel slices' cards; FSDP's side streams for its all-gathers
  and reduce-scatters join the capture through their events), on the
  CPU K plain steps.

A step takes a batch already on the model's device and returns the loss
as a 0-d tensor there: nothing in a step waits for the card.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

import torch

from distributedpytorch_tpu_torch.models import rematerialized
from distributedpytorch_tpu_torch.ops.fused_loss import (
    fused_bce_dice_loss,
    loss_and_cotangent,
    shard_targets,
    stats_function,
    sum_on_first,
)
from distributedpytorch_tpu_torch.ops.loss_kernels import (
    eval_metrics,
    eval_stats,
    metrics_from_stats,
)
from distributedpytorch_tpu_torch.ops.losses import (
    bce_dice_loss,
    dice_coefficient,
)
from distributedpytorch_tpu_torch.ops.precision import (
    LOSS_DTYPE,
    backward_scale,
    optimizer_grads,
)
from distributedpytorch_tpu_torch.parallel.spatial import gather_rows

Batch = Dict[str, torch.Tensor]

#: the JAX package's refusals of the run control, word for word: K steps
#: per dispatch with accumulation (JAX train/loop.py:253), accumulation of
#: a stateful model (JAX train/steps.py:264)
STACKS_CONFLICT = ("--steps-per-dispatch and --grad-accum both stack "
                   "loader batches with conflicting step semantics — "
                   "choose one")
STATEFUL_ACCUM = ("gradient accumulation supports stateless models only "
                  "(BatchNorm statistics are not chunk-decomposable); use "
                  "a data-parallel strategy for large effective batches")


def prep_mask(mask: torch.Tensor) -> torch.Tensor:
    """``(B, H, W)`` integer mask → ``(B, H, W, 1)`` float32 target (the
    reference's ``unsqueeze(1)`` + ``float``, channel-last here)."""
    return mask.unsqueeze(-1).to(LOSS_DTYPE)


def is_stateful_model(model: torch.nn.Module) -> bool:
    """Models with running statistics (milesial's BatchNorm) declare
    ``is_stateful = True``."""
    return bool(getattr(model, "is_stateful", False))


def scaled(t: torch.Tensor, scale: float) -> torch.Tensor:
    return t * scale if scale != 1.0 else t


def make_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    batch_size: int,
    faithful_loss_scaling: bool = True,
    train_loss_fused: bool = False,
    loss_impl: Optional[Callable] = None,
    remat: bool = False,
    reduce_grads: Optional[Callable[[], None]] = None,
) -> Callable[[Batch], torch.Tensor]:
    """``step(batch) -> unscaled loss``: forward, loss, backward, Adam.

    ``loss_impl(preds, target)`` is the strategy's loss (``None``: the
    single-device loss, fused under ``train_loss_fused``). Under DDP it
    is one loss over the global batch, the same on every rank, and
    ``model`` is the DDP-wrapped module, whose backward all-reduces the
    gradients (the strategy wraps the rematerialized model there); the
    faithful scale stays the per-process ``batch_size``
    (strategy.py:303-314). ``reduce_grads()`` runs between the backward
    and Adam (``-t DDP_SP``'s mean over the ranks)."""
    grad_scale = float(batch_size) if faithful_loss_scaling else 1.0
    if loss_impl is None:
        loss_impl = fused_bce_dice_loss if train_loss_fused else bce_dice_loss
    forward = rematerialized(model, remat)

    def train_step(batch: Batch) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        preds = forward(batch["image"])
        loss = loss_impl(preds, prep_mask(batch["mask"]))
        scaled(loss, backward_scale(optimizer, grad_scale)).backward()
        if reduce_grads is not None:
            reduce_grads()
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
    sum_over_ranks: Optional[Callable[[List[torch.Tensor]], None]] = None,
    remat: bool = False,
    stats_impl: Optional[Callable] = None,
    grads_averaged_over: Optional[int] = None,
    open_step: Optional[Callable[[], None]] = None,
    close_step: Optional[Callable[[], None]] = None,
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
    are refused, as in the JAX package.

    Under DDP ``sum_over_ranks`` (the strategy's, in place) adds the
    statistics of pass 1 over the ranks, so ``ct`` is the global batch's,
    and after pass 2 the gradients, which then are the global loss's;
    ``model`` is the bare model and the faithful scale stays per process.
    ``remat`` recomputes each chunk's forward in its backward. Under
    master weights the chunks' bf16 gradients add up in the f32 master
    gradients (``MasterWeights``, JAX steps.py:287).

    ``stats_impl(preds, target)`` is the strategy's statistics of one
    chunk (``None``: ``stats_function(train_loss_fused)``). Under SP and
    DDP_SP ``model`` returns row shards and it is the shards' sums on the
    first device (``make_row_sharded_stats``), never summed over the
    ranks: pass 2 back-propagates the rank's own statistics, and
    ``sum_over_ranks`` adds the gradients once. Through an all-reduced
    statistic each rank's cotangent would add up over the ranks and the
    gradients come out ``world ×`` too large.

    ``grads_averaged_over`` (not None) says that the model's own backward
    averages every gradient over that many ranks (FSDP's reduce-scatter,
    after each chunk): pass 2 then back-propagates the cotangent times
    that count, the world factor the plain step's all-reduced statistics
    give its gradients, so that the average comes out the sum over the
    ranks, and ``sum_over_ranks`` adds pass 1's statistics alone.

    ``open_step()`` runs at the top of the step and ``close_step()``
    after pass 2, before the optimizer reads the gradients: the
    strategy's (ZeRO's one gather, whose leaves both passes run on, and
    its one reduce-scatter of the ranks' sum, ``parallel/zero.py``).
    Where ``close_step`` is given, it sums the gradients over the ranks
    and ``sum_over_ranks`` adds pass 1's statistics alone.
    """
    if is_stateful_model(model):
        raise ValueError(STATEFUL_ACCUM)
    grad_scale = (float(batch_size * chunks) if faithful_loss_scaling
                  else 1.0)
    stats_fn = stats_impl or stats_function(train_loss_fused)
    params = [p for p in model.parameters() if p.requires_grad]
    forward = rematerialized(model, remat)

    def chunk_stats(chunk: Batch) -> torch.Tensor:
        model.train()
        return stats_fn(forward(chunk["image"]), prep_mask(chunk["mask"]))

    def accum_step(stack: List[Batch]) -> torch.Tensor:
        if len(stack) != chunks:
            raise ValueError(
                f"stack carries {len(stack)} chunks but this step was built "
                f"for grad_accum={chunks}"
            )
        if open_step is not None:
            open_step()
        with torch.no_grad():
            stats = torch.zeros(4, dtype=LOSS_DTYPE,
                                device=stack[0]["image"].device)
            for chunk in stack:
                stats = stats + chunk_stats(chunk)
            if sum_over_ranks is not None:
                sum_over_ranks([stats])
        loss, ct = loss_and_cotangent(stats)
        if grads_averaged_over is not None and grads_averaged_over > 1:
            ct = ct * grads_averaged_over
        optimizer.zero_grad(set_to_none=True)
        for chunk in stack:
            chunk_stats(chunk).backward(ct)
        if close_step is not None:
            close_step()
        grads = optimizer_grads(optimizer, params)
        if (sum_over_ranks is not None and grads_averaged_over is None
                and close_step is None):
            sum_over_ranks(grads)
        if grad_scale != 1.0:
            torch._foreach_mul_(grads, grad_scale)
        optimizer.step()
        return loss

    return accum_step


def _row(stacked: Batch, i: int) -> Batch:
    return {k: v[i] for k, v in stacked.items()}


class MultiStep:
    """``multi(stacked) -> losses``: ``steps`` whole train steps of
    ``step`` over a ``(K, B, ...)`` stack, the ``(K,)`` unscaled losses
    out (JAX ``make_multi_train_step``, steps.py:338-356). The same
    function as K calls of ``step`` on the rows, in order. ``step`` is
    the trainer's own train step, which also runs the epoch's tail as
    single steps: one DDP wrapper, one pipeline, one optimizer.

    On the card it is one CUDA graph of the K steps: forward, loss (K1),
    backward (K1-bwd), the strategy's collectives and copies between
    cards, and Adam, which must be capturable (``make_optimizer(...,
    capturable=True)``). ``devices`` are the cards the step computes on,
    the first holding the stack (a pipeline's stage 0) and the losses on
    whichever card the step leaves them (its last stage). Each card gets
    a stream of the graph's own, or the one of ``streams`` the strategy
    built state on (DDP's gradient accumulators). The first calls run
    ``warmup_steps`` eager steps (whole stacks) on those streams, which
    makes every lazily built state before the capture: Adam's moments, cuDNN's and cuBLAS's
    handles, K1's per-stream workspace, NCCL's communicators, and DDP's
    rebuilt buckets and its timed first iterations (at least 11 steps
    under DDP). The next call captures, reading static input buffers on
    the first card; every call from then on copies its stack into them on
    the current stream and replays the graph there, ordered after each
    card's current stream and before its next work. Threads the step
    starts (DP's replicas) launch on these streams, which the step hands
    them. The first card's allocations during the capture go to the
    graph's private pool (``torch.cuda.graph``, which routes one card
    only, by the allocating stream's capture: a replica thread's on the
    capturing stream go there too); every other
    card's go to a ``torch.cuda.MemPool`` of its own for the capture,
    from any thread (a DP replica's), and the pool lives as long as the
    graph. Otherwise blocks the capture freed there would go back to the
    card's cache, eager work (the tail's steps, eval) would take them,
    and the next replay would write into them. The warm-up and the
    capture run the backward on their own thread (``torch.autograd``'s
    ``set_multithreading_enabled(False)``), where autograd would run
    each card's part on a thread of that card: a thread that issued an
    NCCL collective into the capture while another launched work into it
    crashed the capture or hung it against the other ranks (milesial's
    BatchNorm meetings across two cards a rank, ROADMAP.md Trap 14), and
    the warm-up makes this thread's cuBLAS and cuDNN handles of every
    card, which a capture cannot make; the steps outside the graph keep
    a thread per card. A capture that fails raises: nothing falls back
    to eager steps. The kernel wrappers count what they launch
    (``ops.kernels.LAUNCHES``): the warm-up's kernels, and the
    capture's, which go into the graph once; a replay runs the graph's
    kernels without a wrapper, and counts nothing (``chip_smoke.py``
    counts them by name in the profiler's trace of a replay).
    ``reset()`` drops the graph and its pools (a restore replaced the
    optimizer's state tensors); the next call warms up one stack and
    captures again.

    On the CPU it is K plain steps; the losses still come back as one
    ``(K,)`` tensor, so a metrics row reads them in one copy."""

    def __init__(self, step: Callable[[Batch], torch.Tensor], steps: int,
                 devices, warmup_steps: int = 1,
                 streams: Optional[Dict[torch.device, "torch.cuda.Stream"]]
                 = None):
        self.step = step
        self.steps = int(steps)
        if isinstance(devices, (str, torch.device)):
            devices = [devices]
        # distinct, in order: a pipeline may put several stages on a card
        self.devices = list(dict.fromkeys(_indexed(d) for d in devices))
        self.device = self.devices[0]
        self.warmup_steps = max(1, int(warmup_steps))
        self._given = {_indexed(d): s for d, s in (streams or {}).items()}
        self._streams: Optional[Dict[torch.device, torch.cuda.Stream]] = None
        self.reset()

    def reset(self) -> None:
        self._graph = None
        self._pools: Dict[torch.device, "torch.cuda.MemPool"] = {}
        self._static: Optional[Batch] = None
        self._losses: Optional[torch.Tensor] = None
        # eager steps before the next capture: the strategy's warm-up
        # before the first, one stack after a restore
        self._eager_left = (self.warmup_steps if self._streams is None
                            else self.steps)

    def _run(self, stacked: Batch) -> torch.Tensor:
        return torch.stack([self.step(_row(stacked, i))
                            for i in range(self.steps)])

    def _own_streams(self, stack: contextlib.ExitStack) -> None:
        """The graph's stream of every card current, the first card's
        last, so that the first card is the current device."""
        for d in reversed(self.devices):
            stack.enter_context(torch.cuda.stream(self._streams[d]))

    def _warm_up(self, stacked: Batch) -> torch.Tensor:
        current = {d: torch.cuda.current_stream(d) for d in self.devices}
        for d, s in self._streams.items():
            s.wait_stream(current[d])
        with contextlib.ExitStack() as stack:
            self._own_streams(stack)
            # the capture's thread, which makes its handles here
            stack.enter_context(torch.autograd.set_multithreading_enabled(
                False))
            losses = self._run(stacked)
        for d, s in self._streams.items():
            current[d].wait_stream(s)
        losses.record_stream(torch.cuda.current_stream(losses.device))
        return losses

    def _capture(self, stacked: Batch) -> None:
        self._static = {k: torch.empty_like(v) for k, v in stacked.items()}
        graph = torch.cuda.CUDAGraph()
        others = self.devices[1:]
        pools = {}
        for d in others:
            with torch.cuda.device(d):
                pools[d] = torch.cuda.MemPool()
        for d, s in self._streams.items():
            s.wait_stream(torch.cuda.current_stream(d))
        capturing = self._streams[self.device]
        with contextlib.ExitStack() as stack:
            self._own_streams(stack)
            # the backward on this thread (module docstring of MultiStep)
            stack.enter_context(torch.autograd.set_multithreading_enabled(
                False))
            stack.enter_context(torch.cuda.graph(
                graph, stream=capturing, capture_error_mode="thread_local"))
            for d in others:
                stack.enter_context(_allocating_to(pools[d], d))
                # an event of the capturing stream joins d's stream to
                # the capture
                self._streams[d].wait_stream(capturing)
            self._losses = self._run(self._static)
            # every joined stream back in before the capture ends
            for d in others:
                capturing.wait_stream(self._streams[d])
        self._graph, self._pools = graph, pools

    def __call__(self, stacked: Batch) -> torch.Tensor:
        k = stacked["image"].shape[0]
        if k != self.steps:
            raise ValueError(f"stack carries {k} batches but this step was "
                             f"built for steps_per_dispatch={self.steps}")
        if self.device.type != "cuda":
            return self._run(stacked)
        if self._streams is None:
            self._streams = {d: self._given.get(d) or torch.cuda.Stream(d)
                             for d in self.devices}
        if self._eager_left > 0:
            self._eager_left -= self.steps
            return self._warm_up(stacked)
        if self._graph is None:
            self._capture(stacked)
        for key, v in stacked.items():
            self._static[key].copy_(v)
        first = torch.cuda.current_stream(self.device)
        for d in self.devices[1:]:
            first.wait_stream(torch.cuda.current_stream(d))
        self._graph.replay()
        for d in self.devices[1:]:
            torch.cuda.current_stream(d).wait_stream(first)
        return self._losses.clone()


def _indexed(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current card, as the
    tensors placed on it report their device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@contextlib.contextmanager
def _allocating_to(pool: "torch.cuda.MemPool", device: torch.device):
    """Every allocation on ``device``, from any thread, from ``pool``
    (``torch.cuda.use_mem_pool`` routes the calling thread's only, and
    DP's replicas run on threads of their own)."""
    index = torch.device(device).index
    torch._C._cuda_beginAllocateToPool(index, pool.id)
    try:
        yield
    finally:
        torch._C._cuda_endAllocateToPool(index, pool.id)
        torch._C._cuda_releasePool(index, pool.id)


def make_multi_train_step(step: Callable[[Batch], torch.Tensor], steps: int,
                          devices, warmup_steps: int = 1,
                          streams=None) -> MultiStep:
    """K = ``steps`` train steps of ``step`` per call on ``devices`` (one
    device or the list a pipeline computes on), captured after
    ``warmup_steps`` eager steps, on ``streams`` where given (a device's
    stream the strategy built state on; ``MultiStep``)."""
    return MultiStep(step, steps, devices, warmup_steps, streams)


def batch_metrics(preds: torch.Tensor, target: torch.Tensor,
                  eval_stats_fused: bool = False) -> Dict[str, torch.Tensor]:
    """``{'loss', 'dice'}`` of one eval batch as 0-d tensors on its
    device: the BCE − log(soft Dice) and the hard Dice at 0.5, from one
    statistics-kernel pass when ``eval_stats_fused``."""
    if eval_stats_fused:
        return eval_metrics(preds, target)
    return {"loss": bce_dice_loss(preds, target),
            "dice": dice_coefficient(preds, target)}


def shard_metrics(shards: List[torch.Tensor], target: torch.Tensor,
                  eval_stats_fused: bool = False
                  ) -> Dict[str, torch.Tensor]:
    """``batch_metrics`` of row shards' predictions (``parallel/spatial``)
    against the whole batch's ``target``, on the first shard's device:
    with ``eval_stats_fused`` K1 per shard on its card, its six sums (the
    hard Dice counts among them) added in shard order, then the metrics
    once; otherwise the plain metrics of the predictions put together."""
    if eval_stats_fused:
        stats = sum_on_first([eval_stats(p, t) for p, t in
                              zip(shards, shard_targets(shards, target))])
        return metrics_from_stats(stats)
    return batch_metrics(gather_rows(shards, shards[0].device), target,
                         False)


def make_eval_step(model: torch.nn.Module, eval_stats_fused: bool = False,
                   sharded: bool = False
                   ) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """``step(batch) -> batch_metrics`` of the model in eval mode; with
    ``sharded`` ``model`` returns row shards, and ``shard_metrics`` reads
    them."""
    metrics = shard_metrics if sharded else batch_metrics

    @torch.no_grad()
    def eval_step(batch: Batch) -> Dict[str, torch.Tensor]:
        model.eval()
        preds = model(batch["image"])
        return metrics(preds, prep_mask(batch["mask"]), eval_stats_fused)

    return eval_step
