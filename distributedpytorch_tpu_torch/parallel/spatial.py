"""One process, each image's rows split over the local devices: ``-t SP``
(and each rank of ``-t DDP_SP``).

Counterpart of the JAX package's ``SpatialParallel`` and
``HybridDataSpatial`` (strategy.py:783-843), whose GSPMD step shards the
image's H axis (NHWC axis 1) over a ``spatial`` mesh axis, keeps the
parameters replicated and lets XLA insert a collective-permute of the
boundary rows at each 3×3 SAME conv. The port builds the same function
from DP's parts (``parallel/replicas.py``). Per forward ``RowSharded``:

* splits the batch's rows into n equal slices; shard i computes slice i
  on device i in a thread of its own (shard 0 in the caller's), on the
  caller's current stream of every card, as DP's replicas do, with the
  same replicas of the model (``replicas.replicate``: parameter views
  whose gradients add in shard order, under master weights each shard's
  own cast of the f32 masters);
* at each 3×3 conv (``models/unet.Conv2d`` and ``TapsConv2d`` with their
  ``halo`` set) the shards meet (``ShardMeeting.with_halo``): each hands
  in its activation, and one autograd node (``_Halos``), added in shard
  order, gives each shard its rows with its neighbours' edge rows above
  and below, zero rows at the image's top and bottom. The conv then runs
  VALID in H and SAME in W: the whole image's SAME conv, row for row. Its
  backward sends each halo row's gradient back to the shard it came
  from, where it adds into that shard's boundary row; autograd runs the
  node once the gradients of all its outputs are in, so the backward
  needs no meeting of its own;
* the 2×2 pools, the stride-2 transposed convs and the 1×1 heads are
  local to a shard, since every shard's rows stay divisible by 2 at
  every level (checked, and the skip crops asserted to be no-ops,
  ``models/unet.crop_skip``);
* milesial's BatchNorm meets as under DP (``Meeting.mean``): equal shards
  make the mean of the shards' moments the whole batch's, and under
  ``-t DDP_SP`` (``over_ranks``) that mean is summed over the ranks;
* the forward returns the NHWC predictions shard by shard, each on its
  device: the loss runs per shard (``ops/fused_loss.make_row_sharded_loss``)
  and eval per shard (``train/steps.shard_metrics``); ``gather_rows``
  puts them together where a caller needs them whole.

A failing shard breaks the meeting, so no thread waits for ever, and the
failure is raised in the caller. The devices may repeat (``[cpu, cpu]``,
``[cuda:0, cuda:0]``).

The run control (``parallel/strategy.check_run_control``):

* ``--steps-per-dispatch K > 1``: the shards' threads launch on the
  caller's current streams, which ``train/steps.MultiStep`` makes the
  graph's, and every copy between cards backs up on the forward's
  streams (``_Halos``, ``utils/device.copy_all_to``), so one CUDA graph
  captures K whole steps, as DP's replicas;
* ``--remat``: each shard is ``models.Rematerialized``, recomputed
  segment by segment in its backward. Autograd recomputes the shards of
  one card one after another on one thread, so a recompute must never
  meet: each 3×3 conv keeps the two halo rows its first forward took
  (``ShardMeeting.keep``, ``KeptHalo``) and its recompute puts them
  around the recomputed rows, the same values without a meeting, and
  milesial's BatchNorm reuses the moments it kept (under DDP_SP no
  all-reduce either). The halo rows' gradients still flow through the
  first forward's ``_Halos`` node, which the non-reentrant checkpoint
  keeps. A meeting after the forward raises (``Meeting.meet``);
* ``--grad-accum``: each chunk's four loss statistics are the shards'
  sums added in shard order on the first device
  (``ops/fused_loss.make_row_sharded_stats``), without the ranks'
  all-reduce, which accumulation runs itself (``sum_over_ranks``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from distributedpytorch_tpu_torch.models import rematerialized
from distributedpytorch_tpu_torch.models.milesial import BatchNormAct
from distributedpytorch_tpu_torch.ops.precision import PerUseCasts
from distributedpytorch_tpu_torch.parallel.replicas import (
    Meeting,
    Replicated,
    replicate,
)
from distributedpytorch_tpu_torch.utils.device import (
    copy_all_to,
    current_streams,
    on_streams,
)


def _halo_buffer(x: torch.Tensor, above: Optional[torch.Tensor],
                 below: Optional[torch.Tensor]) -> torch.Tensor:
    """The NCHW ``x`` (B, C, h, W) as (B, C, h + 2, W) in channels_last
    memory: the row ``above`` on top, ``below`` at the bottom, each a
    (B, C, 1, W) row (from another card: the copy follows the current
    streams) or, where None, zeros."""
    b, c, h, w = x.shape
    out = torch.empty((b, c, h + 2, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    out[:, :, 1:h + 1].copy_(x)
    for rows, row in ((slice(0, 1), above), (slice(h + 1, h + 2), below)):
        if row is None:
            out[:, :, rows].zero_()
        else:
            out[:, :, rows].copy_(row, non_blocking=True)
    return out


class _Halos(torch.autograd.Function):
    """Each shard's NCHW ``x_i`` (B, C, h, W) on its device → (B, C, h + 2,
    W): shard i − 1's last row, ``x_i``, shard i + 1's first row, zero
    rows at the image's edges. The backward gives each ``x_i`` its own
    rows' gradient plus the gradients of the halo rows its neighbours took
    from it, added in a fixed order (its upper neighbour's first), on the
    forward's streams."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.devices = [x.device for x in xs]
        ctx.streams = current_streams(ctx.devices)
        n = len(xs)
        return tuple(_halo_buffer(x, xs[i - 1][:, :, -1:] if i else None,
                                  xs[i + 1][:, :, :1] if i < n - 1 else None)
                     for i, x in enumerate(xs))

    @staticmethod
    def backward(ctx, *grads):
        n = len(grads)
        dxs = []
        with on_streams(ctx.streams):
            for i, g in enumerate(grads):
                dev = ctx.devices[i]
                dx = g[:, :, 1:-1].clone(memory_format=torch.channels_last)
                if i:
                    dx[:, :, :1] += grads[i - 1][:, :, -1:].to(
                        dev, non_blocking=True)
                if i < n - 1:
                    dx[:, :, -1:] += grads[i + 1][:, :, :1].to(
                        dev, non_blocking=True)
                dxs.append(dx)
        return tuple(dxs)


class _AroundKept(torch.autograd.Function):
    """``x`` between two kept halo rows (``KeptHalo``), as ``_Halos`` gave
    it in the first forward; saves nothing, so a recompute saves for
    backward what that forward saved."""

    @staticmethod
    def forward(ctx, x, rows):
        return _halo_buffer(x, rows[:, :, :1], rows[:, :, 1:])

    @staticmethod
    def backward(ctx, grad):
        return grad[:, :, 1:-1], None


class KeptHalo:
    """The two halo rows a shard's 3×3 conv took in its first forward,
    (B, C, 2, W), copied out of its halo'd input (which the recompute
    does not keep alive). ``around(x)`` is the recompute's halo'd input:
    the same values as the first forward's, and no meeting."""

    def __init__(self, halo_input: torch.Tensor):
        with torch.no_grad():
            self.rows = torch.cat([halo_input[:, :, :1],
                                   halo_input[:, :, -1:]], dim=2)

    def around(self, x: torch.Tensor) -> torch.Tensor:
        return _AroundKept.apply(x, self.rows)


class ShardMeeting(Meeting):
    """DP's meeting (the BatchNorm moments, ``Meeting.mean``) with the row
    shards' halo exchange; with ``keep_halos`` (``--remat``) each conv
    keeps the halo rows it took (``keep``)."""

    def __init__(self, devices: Sequence[torch.device],
                 over_ranks: bool = False, keep_halos: bool = False):
        super().__init__(devices, over_ranks)
        self.keep_halos = keep_halos

    def with_halo(self, x: torch.Tensor) -> torch.Tensor:
        """This shard's NCHW ``x`` with one neighbour row above and below
        (``_Halos``), for a conv that is VALID in H."""
        return self.meet(x, lambda xs: list(_Halos.apply(*xs)))

    def keep(self, halo_input: torch.Tensor) -> Optional[KeptHalo]:
        """What a conv keeps of its halo'd input for its recompute: its
        halo rows under ``keep_halos`` in a forward that autograd records,
        else nothing."""
        if self.keep_halos and torch.is_grad_enabled():
            return KeptHalo(halo_input)
        return None


def halo_convs(module: nn.Module) -> List[nn.Conv2d]:
    """The convs of ``module`` that need their neighbours' rows: every
    3×3, stride-1, padding-1 conv that takes a halo (``halo``). 1×1 convs
    are local; any other conv raises, since a row shard cannot run it."""
    convs = []
    for m in module.modules():
        if not isinstance(m, nn.Conv2d):
            continue
        if (m.kernel_size, m.stride, m.padding) == ((1, 1), (1, 1), (0, 0)):
            continue
        if ((m.kernel_size, m.stride, m.padding, m.dilation)
                == ((3, 3), (1, 1), (1, 1), (1, 1)) and hasattr(m, "halo")):
            convs.append(m)
            continue
        raise ValueError(f"row shards cannot run {m}: only 3x3 SAME convs "
                         f"that take a halo and 1x1 convs")
    return convs


def gather_rows(shards: Sequence[torch.Tensor], device: torch.device
                ) -> torch.Tensor:
    """The NHWC shards put back together along H on ``device``."""
    return torch.cat(copy_all_to(list(shards), device), dim=1)


class RowSharded(Replicated):
    """``module`` (the UNet or milesial) run over ``devices`` with each
    image's rows split into ``len(devices)`` equal shards, as the module
    docstring says; ``forward`` returns the shards' NHWC predictions, in
    shard order, each on its device. The first device holds the module
    and takes the batch. ``over_ranks`` (``-t DDP_SP``) sums the
    BatchNorm moments over the process group's ranks too, one shard or
    several. Under ``remat`` each shard recomputes its forward in its
    backward with the halo rows and moments it kept."""

    thread_name = "dpt-sp-shard"

    def __init__(self, module: nn.Module, devices: Sequence[torch.device],
                 casts: Optional[PerUseCasts] = None,
                 over_ranks: bool = False, remat: bool = False):
        super().__init__(module, devices, casts, remat)
        self.over_ranks = over_ranks
        # the pools of the model: its segments are L levels down, the
        # middle and L levels up
        self.levels = (module.num_segments - 1) // 2
        self.convs = halo_convs(module)

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        n = len(self.devices)
        rows = images.shape[1]
        if rows % (n * 2 ** self.levels):
            raise ValueError(
                f"SP: {rows} rows do not split over {n} shards of whole "
                f"2x2 pools at each of {self.levels} levels (rows must be "
                f"a multiple of {n * 2 ** self.levels})")
        meeting = ShardMeeting(self.devices, self.over_ranks,
                               keep_halos=self.remat)
        # the replicas copy the meeting point with the modules
        convs = self.convs if n > 1 else []
        bns = ([m for m in self.module.modules()
                if isinstance(m, BatchNormAct)]
               if self.training and (n > 1 or self.over_ranks) else [])
        for conv in convs:
            conv.halo = meeting
        for bn in bns:
            bn.replicas = meeting
        try:
            replicas = [rematerialized(r, self.remat) for r in
                        replicate(self.module, self.devices, self._casts)]
            slices = [x.to(d, non_blocking=True)
                      for x, d in zip(images.chunk(n, dim=1), self.devices)]
            return self._run(replicas, slices, meeting)
        finally:
            for conv in convs:
                conv.halo = None
            for bn in bns:
                bn.replicas = None
