"""The collectives of data-parallel training, over the default group.

* ``all_reduce_sum`` — a sum over ranks that autograd sees. It carries
  the loss statistics (``ops/fused_loss.make_sharded_loss``) and
  milesial's BatchNorm moments (``models/milesial.BatchNormAct``).
* ``all_gather_rows`` — every rank's rows, rank by rank (the sharded
  eval's per-batch metrics, ``evaluate.evaluate_sharded``).
* ``sum_over_ranks_`` — tensors summed (or averaged) over ranks in
  place, outside autograd, one flat all-reduce per device (gradient
  accumulation's statistics and gradients,
  ``train/steps.make_accum_train_step``; ``-t DDP_MP``'s stage gradients
  and BatchNorm deltas, ``parallel/pipeline.py``).
* ``all_gather_dim0`` and ``reduced_dim0_piece`` — the ranks' dim-0
  pieces of a tensor put together, and a rank's piece of the sum (or the
  mean) over ranks, outside autograd (the ZeRO shards of
  ``parallel/zero.py``).

**How the gradient comes out right.** Every rank computes the same
global loss from the summed statistics, so every rank back-propagates
the same cotangent into ``all_reduce_sum``. Its backward sums the
cotangent over ranks, as the adjoint of a sum whose output each rank
holds a copy of: each rank's cotangent is then ``world ×`` the true
``∂L/∂(its statistics)``, and everything upstream, the weight gradients
included, is ``world ×`` the rank's true contribution. BatchNorm's
all-reduce keeps that factor: the cotangents it sums over ranks are
already scaled. ``torch.nn.parallel.DistributedDataParallel`` then
averages the gradients over the ranks: ``(1/world) Σ_r world·g_r =
Σ_r g_r``, the gradient of the global loss. An all-reduce whose backward
were the identity would, with that averaging, give ``1/world`` of it
(``tests/test_torch_ddp.py`` holds every gradient of one step, before
Adam, against the JAX DDP's).

No call here reads a tensor back to the host: under NCCL the all-reduces
order NCCL's stream after the current one and the current one after it,
so a CUDA graph of K steps (``train/steps.MultiStep``) captures them. A
gloo group moves CUDA tensors through the host, and K > 1 is refused
there (``parallel/strategy.check_run_control``).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    """Forward: the sum of ``x`` over ranks. Backward: the sum of the
    cotangent over ranks."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    @staticmethod
    def backward(ctx, ct: torch.Tensor) -> torch.Tensor:
        out = ct.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``Σ_ranks x``, differentiable as the module docstring says."""
    return _AllReduceSum.apply(x)


def all_gather_rows(rows: torch.Tensor) -> torch.Tensor:
    """``(world, *rows.shape)``: each rank's ``rows`` (equal shapes on
    every rank), in rank order, on every rank."""
    parts = [torch.empty_like(rows) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, rows.contiguous())
    return torch.stack(parts)


def sum_over_ranks_(tensors: List[torch.Tensor], mean: bool = False) -> None:
    """Each of ``tensors`` replaced by its sum over ranks (its mean with
    ``mean``), through one all-reduce of the concatenation of the tensors
    on each device, the devices in the order their first tensor comes;
    autograd does not see it. Tensors on different cards (a pipeline's
    stages) cannot be concatenated, and NCCL keeps one communicator per
    device, so every rank must list its devices in the same order."""
    by_device: Dict[torch.device, List[torch.Tensor]] = {}
    for t in tensors:
        by_device.setdefault(t.device, []).append(t)
    for group in by_device.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        if mean:
            flat /= dist.get_world_size()
        offset = 0
        with torch.no_grad():
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view(t.shape))
                offset += t.numel()


def all_gather_dim0(piece: torch.Tensor) -> torch.Tensor:
    """The ranks' equal dim-0 pieces, rank by rank, as one tensor: one
    ``all_gather_into_tensor`` on the piece's device."""
    world = dist.get_world_size()
    out = piece.new_empty((world * piece.shape[0], *piece.shape[1:]))
    dist.all_gather_into_tensor(out, piece.detach().contiguous())
    return out


def reduced_dim0_piece(whole: torch.Tensor, mean: bool = True
                       ) -> torch.Tensor:
    """This rank's piece of dim 0 (torch.chunk's, equal pieces) of the
    sum over ranks of ``whole`` (its mean with ``mean``): one
    ``reduce_scatter_tensor`` under NCCL; under gloo, which moves CUDA
    tensors through the host and has no reduce-scatter of them, one
    all-reduce of ``whole`` (in place) and the slice. The mean divides
    the sum by the world size afterwards, as ``sum_over_ranks_`` does,
    under either."""
    world, rank = dist.get_world_size(), dist.get_rank()
    whole = whole.detach().contiguous()
    if dist.get_backend() == "nccl":
        piece = whole.new_empty((whole.shape[0] // world, *whole.shape[1:]))
        dist.reduce_scatter_tensor(piece, whole, op=dist.ReduceOp.SUM)
    else:
        dist.all_reduce(whole, op=dist.ReduceOp.SUM)
        piece = whole.chunk(world)[rank].clone()
    if mean:
        piece /= world
    return piece
