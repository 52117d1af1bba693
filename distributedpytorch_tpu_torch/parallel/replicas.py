"""One process, a batch split over the local devices: ``-t DP``.

Counterpart of the JAX package's ``DataParallel`` (strategy.py:542-555),
whose GSPMD step shards the global batch over a data mesh and computes
milesial's BatchNorm moments over the whole batch. The port does not use
``torch.nn.DataParallel``: its ``replicate`` needs CUDA, and its
BatchNorm is per replica, with only replica 0's running averages kept.
Instead, ``Replicated`` runs, per forward:

* replica 0 is the model itself on the first device; replica i > 0 is a
  copy of its modules on device i whose parameters are ``p.to(device)``,
  autograd-visible, so every replica's gradient sums back into the one
  parameter set, and whose buffers are copies; under master weights
  every replica computes with its own cast of the f32 masters
  (``ops/precision.PerUseCasts``), so the sum is in f32;
* the batch is split in equal slices, replica i computes slice i on its
  device in a thread of its own (replica 0 in the caller's), and the
  predictions are gathered on the first device;
* in training each ``BatchNormAct`` is a meeting point (``Meeting``): the
  replicas' threads hand in their slice's ``E[x]`` and ``E[x²]``, one
  autograd node (``_MeanOverReplicas``) averages them into the moments of
  the whole batch and hands each replica its copy. Its backward needs no
  meeting of its own: autograd runs a node once the gradients of all its
  outputs are in, which is the synchronised BatchNorm of DataParallel.
  Every replica then moves its running averages by the same global
  moments; only replica 0's, the model's own, are kept.

The devices may repeat (``[cpu, cpu]`` in the CPU tests).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from distributedpytorch_tpu_torch.models.milesial import BatchNormAct
from distributedpytorch_tpu_torch.ops.precision import PerUseCasts


class _MeanOverReplicas(torch.autograd.Function):
    """The mean of the replicas' (2, C) moments, one copy per replica on
    its device; the backward sends each replica the mean of the
    outputs' gradients."""

    @staticmethod
    def forward(ctx, *moments):
        ctx.devices = [m.device for m in moments]
        home = moments[0].device
        total = moments[0]
        for m in moments[1:]:
            total = total + m.to(home)
        mean = total / len(moments)
        return (mean,) + tuple(mean.to(d, copy=True) for d in ctx.devices[1:])

    @staticmethod
    def backward(ctx, *grads):
        home = ctx.devices[0]
        total = None
        for g in grads:
            if g is not None:
                total = g.to(home) if total is None else total + g.to(home)
        g = total / len(grads)
        return tuple(g.to(d) for d in ctx.devices)


class Meeting:
    """Where the replicas' threads meet at each BatchNorm of one forward,
    in the order the layers run (the same in every replica)."""

    def __init__(self, n: int):
        self._barrier = threading.Barrier(n)
        self._local = threading.local()
        self._moments: List = [None] * n
        self._means = ()

    def run(self, index: int, fn, *args):
        """``fn(*args)`` as replica ``index``; a failure breaks the
        meeting, so no other replica waits for this one for ever."""
        self._local.index = index
        try:
            return fn(*args)
        except BaseException:
            self._barrier.abort()
            raise

    def mean(self, moments: torch.Tensor) -> torch.Tensor:
        """This replica's copy of the replicas' mean of ``moments``."""
        i = self._local.index
        self._moments[i] = moments
        self._barrier.wait()
        if i == 0:
            self._means = _MeanOverReplicas.apply(*self._moments)
        self._barrier.wait()
        return self._means[i]


def replicate(module: nn.Module, device: torch.device,
              casts: Optional[PerUseCasts] = None) -> nn.Module:
    """A copy of ``module``'s module tree on ``device``: parameters
    ``p.to(device)`` (the parameter itself on its own device, else a copy
    autograd sends the gradient back through), or under master weights
    this replica's cast of each f32 master (``casts``); buffers copied."""
    copies: Dict[nn.Module, nn.Module] = {
        m: m._replicate_for_data_parallel() for m in module.modules()}
    for m, r in copies.items():
        for key, child in m._modules.items():
            r._modules[key] = None if child is None else copies[child]
        for key, p in m._parameters.items():
            if p is None:
                r._parameters[key] = None
            else:
                setattr(r, key, p.to(device) if casts is None
                        else casts.of(p, device))
        for key, b in m._buffers.items():
            r._buffers[key] = None if b is None else b.to(device, copy=True)
    return copies[module]


class Replicated(nn.Module):
    """``module`` run data-parallel over ``devices`` (the first holds the
    module, takes the batch and gets the predictions back). Under master
    weights (``casts``) every replica, the first too, computes with its
    own cast of the f32 masters, so autograd adds the replicas' gradients
    in f32, where the GSPMD DP step of the JAX package sums them."""

    def __init__(self, module: nn.Module, devices: Sequence[torch.device],
                 casts: Optional[PerUseCasts] = None):
        super().__init__()
        self.module = module
        self.devices = [torch.device(d) for d in devices]
        self.is_stateful = bool(getattr(module, "is_stateful", False))
        self._casts = casts

    def _first(self, images: torch.Tensor) -> torch.Tensor:
        """Replica 0: the module itself, its own buffers kept."""
        if self._casts is None:
            return self.module(images)
        return torch.func.functional_call(
            self.module, self._casts.named_casts(), (images,))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        n = len(self.devices)
        if n == 1:
            return self._first(images)
        if images.shape[0] % n:
            raise ValueError(f"DP: a batch of {images.shape[0]} does not "
                             f"split over {n} replicas")
        meeting = Meeting(n)
        # the replicas copy the meeting point with the modules
        bns = [m for m in self.module.modules()
               if isinstance(m, BatchNormAct)] if self.training else []
        for bn in bns:
            bn.replicas = meeting
        try:
            replicas = [self._first] + [
                replicate(self.module, d, self._casts)
                for d in self.devices[1:]]
            slices = [x.to(d, non_blocking=True)
                      for x, d in zip(images.chunk(n), self.devices)]
            outs = self._run(replicas, slices, meeting)
        finally:
            for bn in bns:
                bn.replicas = None
        return torch.cat([y.to(self.devices[0]) for y in outs])

    def _run(self, replicas, slices, meeting: Meeting) -> list:
        """Replica i on slice i, each in a thread of its own (replica 0 in
        this one), under the caller's grad mode and its device's guard."""
        n = len(replicas)
        outs: List = [None] * n
        errors: List = [None] * n
        grad_mode = torch.is_grad_enabled()

        def work(i: int) -> None:
            dev = self.devices[i]
            guard = (torch.cuda.device(dev) if dev.type == "cuda"
                     else contextlib.nullcontext())
            try:
                with guard, torch.set_grad_enabled(grad_mode):
                    outs[i] = meeting.run(i, replicas[i], slices[i])
            except BaseException as exc:  # re-raised below, in the caller
                errors[i] = exc

        threads = [threading.Thread(target=work, args=(i,),
                                    name=f"dpt-dp-replica-{i}")
                   for i in range(1, n)]
        for t in threads:
            t.start()
        try:
            work(0)
        finally:
            for t in threads:
                t.join()
        raised = [e for e in errors if e is not None]
        if raised:
            # the failure itself, not the broken meeting it left behind
            first = [e for e in raised
                     if not isinstance(e, threading.BrokenBarrierError)]
            raise (first or raised)[0]
        return outs
