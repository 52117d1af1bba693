"""One process, a batch split over the local devices: ``-t DP``.

Counterpart of the JAX package's ``DataParallel`` (strategy.py:542-555),
whose GSPMD step shards the global batch over a data mesh and computes
milesial's BatchNorm moments over the whole batch. The port does not use
``torch.nn.DataParallel``: its ``replicate`` needs CUDA, and its
BatchNorm is per replica, with only replica 0's running averages kept.
Instead, ``Replicated`` runs, per forward:

* replica 0 is the model itself on the first device (under master
  weights a copy of its modules that computes with its own cast of each
  f32 master and keeps the model's buffers); replica i > 0 is a copy of
  its modules on device i whose buffers are copies and whose parameters
  are views of one autograd-visible copy of all the parameters (of their
  masters, cast, so the sum is in f32): one ``torch.cat`` on the first
  device and one copy per device. Every replica's gradient sums back
  into the one parameter set: the copies' gradients add in replica order
  in one node (``_Uses``), whatever order the cards' autograd threads
  finish in, so a step across cards is repeatable bit for bit;
* the batch is split in equal slices, replica i computes slice i on its
  device in a thread of its own (replica 0 in the caller's), on the
  caller's current stream of every card, and the predictions are
  gathered on the first device;
* in training each ``BatchNormAct`` is a meeting point (``Meeting``): the
  replicas' threads hand in their slice's ``E[x]`` and ``E[x²]``, which
  are gathered on the first device, averaged into the moments of the
  whole batch by one autograd node (``_MeanOverReplicas``), and handed
  back, one copy per replica. Its backward needs no meeting of its own:
  autograd runs a node once the gradients of all its outputs are in,
  which is the synchronised BatchNorm of DataParallel. Every replica
  then moves its running averages by the same global moments; only
  replica 0's, the model's own, are kept. Each replica's BatchNorm also
  keeps the moments it got, so that a recompute under ``--remat``
  (``remat``: each replica ``models.Rematerialized``) normalizes with
  them and never meets again: autograd recomputes the replicas of one
  card one after another on one thread.

Every copy between cards is ``utils/device.copy_all_to``, whose
backward runs on the forward's streams, so one CUDA graph captures K
whole steps (``train/steps.MultiStep``). Each node's outputs lie on one
device. The weights move in one copy per device and dtype, and the
predictions in one node: a step makes few copies between cards and few
Python calls in autograd's threads, which take the interpreter lock.
The devices may repeat (``[cpu, cpu]`` in the CPU tests, ``[cuda:0,
cuda:0]`` on one card).
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

from distributedpytorch_tpu_torch.dist.collectives import all_reduce_sum
from distributedpytorch_tpu_torch.models import rematerialized
from distributedpytorch_tpu_torch.models.milesial import BatchNormAct
from distributedpytorch_tpu_torch.ops.precision import PerUseCasts
from distributedpytorch_tpu_torch.utils.device import (
    copy_all_to,
    copy_to,
    current_streams,
    on_streams,
)


class _Uses(torch.autograd.Function):
    """``n`` uses of ``x``, each a view of it, in one node; the backward
    adds the uses' gradients in use order. Autograd would add them in the
    order they arrive, which across cards is the order the cards' threads
    finish in."""

    @staticmethod
    def forward(ctx, n: int, x: torch.Tensor):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        return None, _sum_in_order(grads)


def _sum_in_order(tensors) -> Optional[torch.Tensor]:
    total = None
    for t in tensors:
        if t is not None:
            total = t if total is None else total + t
    return total


class _MeanOverReplicas(torch.autograd.Function):
    """The mean of the replicas' (2, C) moments, gathered on the first
    device, one copy per replica there; the backward sends each replica
    the mean of the copies' gradients, added in replica order."""

    @staticmethod
    def forward(ctx, *moments):
        mean = _sum_in_order(moments) / len(moments)
        return (mean,) + tuple(mean.clone() for _ in moments[1:])

    @staticmethod
    def backward(ctx, *grads):
        g = _sum_in_order(grads) / len(grads)
        return (g,) * len(grads)


class Meeting:
    """Where the replicas' threads meet at each BatchNorm of one forward,
    in the order the layers run (the same in every replica). With
    ``over_ranks`` (``-t DDP_SP``, ``parallel/spatial.py``) the replicas'
    mean is then summed over the process group's ranks, through the
    all-reduce that DDP's BatchNorm runs, divided by the world size:
    the moments of the global batch, on every rank alike."""

    def __init__(self, devices: Sequence[torch.device],
                 over_ranks: bool = False):
        self.devices = list(devices)
        self.over_ranks = over_ranks
        self._barrier = threading.Barrier(len(self.devices))
        self._local = threading.local()
        self._handed: List = [None] * len(self.devices)
        self._results: List = []
        self._closed = False

    def run(self, index: int, fn, *args):
        """``fn(*args)`` as replica ``index``; a failure breaks the
        meeting, so no other replica waits for this one for ever."""
        self._local.index = index
        try:
            return fn(*args)
        except BaseException:
            self._barrier.abort()
            raise

    def meet(self, value, combine):
        """This replica's share of ``combine(values)``, where ``values``
        are what every replica handed in, in replica order. Replica 0
        combines, after every replica has enqueued its value on its
        card's stream, which the copies then follow; ``combine`` returns
        one result per replica. Once the forward is over (``close``) a
        meeting raises: a recompute runs the replicas of a card one after
        another on one thread, where it would wait for ever."""
        if self._closed:
            raise RuntimeError(
                "a replica met the others after the forward: a recompute "
                "under --remat must reuse what its first forward kept")
        i = self._local.index
        self._handed[i] = value
        self._barrier.wait()
        if i == 0:
            self._results = combine(list(self._handed))
        self._barrier.wait()
        return self._results[i]

    def close(self) -> None:
        """The forward is over: every later ``meet`` raises."""
        self._closed = True

    def mean(self, moments: torch.Tensor) -> torch.Tensor:
        """This replica's copy of the replicas' mean of ``moments``."""
        return self.meet(moments, self._mean_of)

    def _mean_of(self, moments: list) -> list:
        means = _MeanOverReplicas.apply(
            *copy_all_to(moments, self.devices[0]))
        if self.over_ranks:
            total = all_reduce_sum(means[0]) / dist.get_world_size()
            means = _Uses.apply(len(means), total)
        return [copy_to(m, d) for m, d in zip(means, self.devices)]


def _replica_uses(sources: Sequence[torch.Tensor],
                  dtypes: Sequence[torch.dtype],
                  devices: Sequence[torch.device]) -> List[list]:
    """``uses[i][k]``: ``sources[k]`` cast to ``dtypes[k]`` on
    ``devices[i]``. The sources of one dtype move as one flat tensor: one
    ``torch.cat``, a use of it per device (``_Uses``), cast and copied
    there in one copy (``utils/device.copy_to``); each use of a source is
    a view of its device's copy."""
    uses: List[list] = [[None] * len(sources) for _ in devices]
    for dtype in dict.fromkeys(dtypes):
        ks = [k for k, d in enumerate(dtypes) if d == dtype]
        flat = torch.cat([sources[k].reshape(-1) for k in ks])
        sizes = [sources[k].numel() for k in ks]
        for i, (use, device) in enumerate(
                zip(_Uses.apply(len(devices), flat), devices)):
            copy = copy_to(use.to(dtype), device)
            for k, piece in zip(ks, copy.split(sizes)):
                uses[i][k] = piece.view(sources[k].shape)
    return uses


def replicate(module: nn.Module, devices: Sequence[torch.device],
              casts: Optional[PerUseCasts] = None) -> List[nn.Module]:
    """``module``'s replicas on ``devices``, as the module docstring says:
    replica 0 is ``module`` itself, or under master weights (``casts``) a
    copy with its own cast of each master and ``module``'s buffers;
    replica i > 0 a copy on ``devices[i]`` whose parameters are views of
    one copy of the parameters (of their masters, cast) and whose buffers
    are copies."""
    params = list(module.parameters())
    if casts is None:
        uses = [params]
        sources = params
    else:
        uses = [[casts.of(p) for p in params]]
        sources = [casts.master(p) for p in params]
    if len(devices) > 1:
        uses += _replica_uses(sources, [p.dtype for p in params],
                              devices[1:])
    index = {p: k for k, p in enumerate(params)}
    replicas: List[nn.Module] = []
    for i, device in enumerate(devices):
        if i == 0 and casts is None:
            replicas.append(module)
            continue
        copies = {m: m._replicate_for_data_parallel()
                  for m in module.modules()}
        for m, r in copies.items():
            for key, child in m._modules.items():
                r._modules[key] = None if child is None else copies[child]
            for key, p in m._parameters.items():
                if p is None:
                    r._parameters[key] = None
                else:
                    setattr(r, key, uses[i][index[p]])
            for key, b in m._buffers.items():
                r._buffers[key] = (b if i == 0 or b is None
                                   else b.to(device, copy=True))
        replicas.append(copies[module])
    return replicas


class Replicated(nn.Module):
    """``module`` run data-parallel over ``devices`` (the first holds the
    module, takes the batch and gets the predictions back). Under master
    weights (``casts``) every replica, the first too, computes with its
    own cast of the f32 masters, so autograd adds the replicas' gradients
    in f32, where the GSPMD DP step of the JAX package sums them. Under
    ``remat`` each replica recomputes its forward segment by segment in
    its backward (``models.Rematerialized``)."""

    #: the name of each replica's thread past the first, and its index
    thread_name = "dpt-dp-replica"

    def __init__(self, module: nn.Module, devices: Sequence[torch.device],
                 casts: Optional[PerUseCasts] = None, remat: bool = False):
        super().__init__()
        self.module = module
        self.devices = [torch.device(d) for d in devices]
        self.is_stateful = bool(getattr(module, "is_stateful", False))
        self.remat = remat
        self._casts = casts

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        n = len(self.devices)
        if images.shape[0] % n:
            raise ValueError(f"DP: a batch of {images.shape[0]} does not "
                             f"split over {n} replicas")
        meeting = Meeting(self.devices)
        # the replicas copy the meeting point with the modules
        bns = ([m for m in self.module.modules()
                if isinstance(m, BatchNormAct)]
               if self.training and n > 1 else [])
        for bn in bns:
            bn.replicas = meeting
        try:
            replicas = [rematerialized(r, self.remat) for r in
                        replicate(self.module, self.devices, self._casts)]
            if n == 1:
                return replicas[0](images)
            slices = [x.to(d, non_blocking=True)
                      for x, d in zip(images.chunk(n), self.devices)]
            outs = self._run(replicas, slices, meeting)
        finally:
            for bn in bns:
                bn.replicas = None
        return torch.cat(copy_all_to(outs, self.devices[0]))

    def _run(self, replicas, slices, meeting: Meeting) -> list:
        """Replica i on slice i, each in a thread of its own (replica 0 in
        this one), under the caller's grad mode, the caller's current
        stream of every card (a thread starts on each card's default
        stream, which is outside a CUDA graph's capture and unordered
        with the caller's work) and its device's guard."""
        n = len(replicas)
        outs: List = [None] * n
        errors: List = [None] * n
        grad_mode = torch.is_grad_enabled()
        streams = current_streams(self.devices)

        def work(i: int) -> None:
            dev = self.devices[i]
            guard = (torch.cuda.device(dev) if dev.type == "cuda"
                     else contextlib.nullcontext())
            try:
                with on_streams(streams), guard, \
                        torch.set_grad_enabled(grad_mode):
                    outs[i] = meeting.run(i, replicas[i], slices[i])
            except BaseException as exc:  # re-raised below, in the caller
                errors[i] = exc

        threads = [threading.Thread(target=work, args=(i,),
                                    name=f"{self.thread_name}-{i}")
                   for i in range(1, n)]
        for t in threads:
            t.start()
        try:
            work(0)
        finally:
            for t in threads:
                t.join()
            meeting.close()
        raised = [e for e in errors if e is not None]
        if raised:
            # the failure itself, not the broken meeting it left behind
            first = [e for e in raised
                     if not isinstance(e, threading.BrokenBarrierError)]
            raise (first or raised)[0]
        return outs
