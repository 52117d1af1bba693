"""ZeRO over the data ranks, by hand: ``-t DxMx1@fsdp`` (the
``fsdp+channel`` rule of ``parallel/mesh.py``).

Counterpart of the JAX mesh engine's ``fsdp+channel`` point
(``mesh.state_leaf_spec``: the out-channels over ``model``, the slice
again over ``data``) and of the gather-at-use at the top of a step that
its pipeline stages run (``pipeline._gather_params``). ``fully_shard``
cannot take a model whose rank computes on M cards (FSDP2 assumes one
device per rank), so ``ZeroSharded`` cuts the parameters of any model
itself, one tensor at a time on the tensor's own card:

* each parameter whose dim 0 divides the world is kept as this rank's
  piece of dim 0 (``torch.chunk``'s), a parameter of ``ZeroSharded`` on
  that card; a parameter whose dim 0 does not divide (the 1-channel
  head) stays whole on every rank. ``ZeroSharded.parameters()`` are the
  pieces and the whole ones, in the wrapped model's order, so Adam keeps
  its state with them and steps the pieces only;
* the wrapped model's parameters become plain attributes of their
  modules. ``gather_`` sets each cut one to a new leaf that holds the
  whole tensor (one ``all_gather_into_tensor`` per tensor on its card),
  at the top of every forward; the train step's ``reduce_grads_`` after
  the backward reduce-scatters each leaf's gradient to the rank's piece,
  all-reduces a whole one's, both as the mean over the ranks
  (``dist/collectives``), and drops the leaves; an eval forward drops
  them at its end. Between steps a card holds the pieces, Adam's state
  over them and the whole ones;
* the whole state (``whole_state``, ``whole_optimizer_state``) is
  gathered on every rank, a collective each rank enters in the same
  order, in the wrapped model's own layout (``ChannelSharded``: whole
  tensors under the reference names); ``load_whole_state`` and
  ``sharded_optimizer_state`` cut it again.

Every rank issues its collectives in the same order, tensor by tensor,
so under NCCL each card meets the card in the same place on the other
ranks (``dist/collectives.sum_over_ranks_``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Mapping, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

from distributedpytorch_tpu_torch.dist.collectives import (
    all_gather_dim0,
    mean_dim0_piece,
    sum_over_ranks_,
)

def is_cut(shape: Sequence[int], world: int) -> bool:
    """Whether a tensor of ``shape`` is cut over ``world`` ranks: dim 0
    divides (``mesh.state_leaf_spec``'s ``fsdp+channel`` rule on a
    channel slice)."""
    return len(shape) > 0 and shape[0] >= world and shape[0] % world == 0


class ZeroSharded(nn.Module):
    """``inner`` with its parameters cut over the ranks of the default
    group, as the module docstring says. ``inner`` (here a
    ``ChannelSharded``) must expose ``whole_state``, ``load_whole_state``,
    ``whole_optimizer_state``, ``sharded_optimizer_state``,
    ``whole_param_names``, ``slice_values`` and ``whole_values``, each over
    its parameters in ``named_parameters`` order; ``paths`` keeps those
    names."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.world, self.rank = dist.get_world_size(), dist.get_rank()
        self.inner = inner
        #: (module, attribute, whole shape, cut) of each parameter, in
        #: ``inner``'s order
        self._owners = []
        #: ``inner``'s parameter names, one per piece
        self.paths: List[str] = []
        self.pieces = nn.ParameterList()
        modules = dict(inner.named_modules())
        for path, p in list(inner.named_parameters()):
            parent, _, attr = path.rpartition(".")
            module = modules[parent]
            cut = is_cut(p.shape, self.world)
            with torch.no_grad():
                piece = (p.chunk(self.world)[self.rank].clone() if cut
                         else p)
            shard = (nn.Parameter(piece, requires_grad=p.requires_grad)
                     if cut else p)
            del module._parameters[attr]
            # a whole one is the piece itself, read where it lies
            object.__setattr__(module, attr, None if cut else shard)
            self._owners.append((module, attr, tuple(p.shape), cut))
            self.paths.append(path)
            self.pieces.append(shard)
        self._leaves: List = []

    # -- the whole parameters, around a step --------------------------------
    def gather_(self) -> None:
        """Every cut parameter whole on its card, as a new leaf its module
        reads."""
        leaves = []
        for (module, attr, _shape, cut), piece in zip(self._owners,
                                                       self.pieces):
            if not cut:
                continue
            leaf = all_gather_dim0(piece).requires_grad_(
                piece.requires_grad)
            object.__setattr__(module, attr, leaf)
            leaves.append(leaf)
        self._leaves = leaves

    def drop_(self) -> None:
        """The whole leaves let go: the modules read None until the next
        ``gather_``."""
        for module, attr, _shape, cut in self._owners:
            if cut:
                object.__setattr__(module, attr, None)
        self._leaves = []

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        self.gather_()
        if self.training and torch.is_grad_enabled():
            # the leaves stay for reduce_grads_ to read their gradients
            return self.inner(images)
        try:
            return self.inner(images)
        finally:
            self.drop_()

    @torch.no_grad()
    def reduce_grads_(self) -> None:
        """After the backward: each piece's gradient the mean over the
        ranks of its rows of its leaf's, each whole parameter's the mean
        of its own; then the leaves are dropped."""
        leaves = iter(self._leaves)
        whole = []
        for (_m, _a, _s, cut), piece in zip(self._owners, self.pieces):
            if not cut:
                if piece.grad is not None:
                    whole.append(piece.grad)
                continue
            leaf = next(leaves)
            if leaf.grad is not None:
                piece.grad = mean_dim0_piece(leaf.grad)
        if whole:
            sum_over_ranks_(whole, mean=True)
        self.drop_()

    @contextlib.contextmanager
    def _whole(self):
        """Within the block the modules hold the whole parameters."""
        self.gather_()
        try:
            yield
        finally:
            self.drop_()

    # -- the whole state ------------------------------------------------------
    def whole_state(self) -> Dict[str, torch.Tensor]:
        with self._whole():
            return self.inner.whole_state()

    @torch.no_grad()
    def load_whole_state(self, state: Mapping[str, torch.Tensor]) -> None:
        with self._whole():
            self.inner.load_whole_state(state)
            leaves = iter(self._leaves)
            for (_m, _a, _s, cut), piece in zip(self._owners, self.pieces):
                if cut:
                    piece.copy_(next(leaves).chunk(self.world)[self.rank])

    def whole_param_names(self) -> List[str]:
        return self.inner.whole_param_names()

    def _pieces_of(self, values: Sequence[torch.Tensor]) -> list:
        """Values of ``inner``'s parameters → this rank's piece of each."""
        return [v.chunk(self.world)[self.rank] if cut else v
                for (_m, _a, _s, cut), v in zip(self._owners, values)]

    def slice_values(self, whole: Sequence[torch.Tensor]) -> list:
        """Values of the whole parameters (reference order) → one per
        parameter of this module."""
        return self._pieces_of(self.inner.slice_values(whole))

    def whole_values(self, values: Sequence[torch.Tensor]) -> list:
        """The inverse of ``slice_values``: each cut value gathered from
        the ranks (every rank enters, in order), then the wrapped model's
        ``whole_values``."""
        return self.inner.whole_values([
            all_gather_dim0(v) if cut else v
            for (_m, _a, _s, cut), v in zip(self._owners, values)])

    def whole_optimizer_state(self, state: Mapping) -> dict:
        """An optimizer state dict over the pieces → the wrapped model's
        ``whole_optimizer_state`` of the whole tensors, each moment of a
        cut parameter gathered (every rank enters, in index order)."""
        slots = {}
        for i in sorted(state["state"], key=int):
            cut = self._owners[int(i)][3]
            slots[i] = {key: (all_gather_dim0(v)
                              if cut and isinstance(v, torch.Tensor)
                              and v.dim() > 0 else v)
                        for key, v in sorted(state["state"][i].items())}
        return self.inner.whole_optimizer_state(
            {"state": slots, "param_groups": state["param_groups"]})

    def sharded_optimizer_state(self, state: Mapping) -> dict:
        """The inverse of ``whole_optimizer_state``: this rank's piece of
        each moment, one param group over this module's parameters."""
        inner = self.inner.sharded_optimizer_state(state)
        slots = {}
        for i, entry in inner["state"].items():
            cut = self._owners[int(i)][3]
            slots[i] = {key: (v.chunk(self.world)[self.rank].clone()
                              if cut and isinstance(v, torch.Tensor)
                              and v.dim() > 0 else v)
                        for key, v in entry.items()}
        return {**inner, "state": slots}
