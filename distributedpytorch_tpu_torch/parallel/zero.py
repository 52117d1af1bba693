"""Parameters cut into pieces and put together whole at the top of a
step, by hand: ZeRO over the data ranks (``-t DxMx1@fsdp``, the
``fsdp+channel`` rule of ``parallel/mesh.py``, and ``-t DxMx1@sp+fsdp``
over a rank's ``spatial.RowSharded``, whose replicas copy the gathered
leaves) and sharding inside a pipeline stage (``-t DxMxS`` with M > 1,
``Dx1xS@fsdp`` and ``DxMxS@fsdp``, ``parallel/in_stage.py``).

Counterpart of the JAX mesh engine's ``fsdp+channel`` point
(``mesh.state_leaf_spec``: the out-channels over ``model``, the slice
again over ``data``) and of the gather-at-use at the top of a step that
its pipeline stages run (``pipeline._gather_params``,
``_slice_to_shard``). ``fully_shard`` cannot take a model whose rank
computes on several cards (FSDP2 assumes one device per rank), so
``ZeroSharded`` cuts the parameters of any model itself, one tensor at a
time, as each tensor's ``Cut`` says:

* a cut parameter is kept as this rank's pieces, parameters of
  ``ZeroSharded``: its out-channel dim cut into ``len(places)`` channel
  slices (one place: not cut over channels), slice i on ``places[i]``,
  and each slice's dim 0 cut again over the ranks (``torch.chunk``'s
  pieces) where ``over_ranks``. By default (``-t DxMx1@fsdp``, whose
  ``ChannelSharded`` has cut the channels already) each parameter whose
  dim 0 divides the world is cut over the ranks on its own card; a
  parameter with no cut (the 1-channel head) stays whole on every rank.
  ``ZeroSharded.parameters()`` are the pieces and the whole ones, in the
  wrapped model's order, so Adam keeps its state with them and steps
  them where they lie;
* the wrapped model's parameters become plain attributes of their
  modules. ``gather_`` sets each cut one to a new leaf that holds the
  whole tensor on its ``home`` device: one copy per piece there, then,
  where it is cut over the ranks, one ``all_gather_into_tensor`` of the
  tensor's pieces. The train step runs it at the top of every forward
  (``forward``, or the pipeline's ``open_step``); ``reduce_grads_``
  after the backward cuts each leaf's gradient back to its pieces on
  their places, reduce-scatters it over the ranks where they cut it,
  all-reduces every other gradient (``dist/collectives``; the mean, or
  under 1f1b the sum, that the caller asks for) and drops the leaves; an
  eval forward drops them at its end. Between steps a device holds its
  pieces, Adam's state over them and the whole ones;
* the whole state (``whole_state``, ``whole_optimizer_state``) is
  gathered on every rank, a collective each rank enters in the same
  order, in the wrapped model's own layout (``ChannelSharded``'s, or a
  plain model's state dict: whole tensors under the reference names);
  ``load_whole_state`` and ``sharded_optimizer_state`` cut it again.

Every rank issues its collectives in the same order, tensor by tensor,
so under NCCL each card meets the card in the same place on the other
ranks (``dist/collectives.sum_over_ranks_``).

The run control of a train step over ``ZeroSharded`` (``-t DxMx1@fsdp``
and ``-t DxMx1@sp+fsdp``; under in-stage sharding the pipeline's
``open_step`` gathers and its ``close_step`` reduces, as
``parallel/pipeline.py`` says):

* ``--remat`` (``remat``): the forward gathers once, outside any
  recomputed region, and then recomputes the wrapped model segment by
  segment on those leaves (``models.Rematerialized``; a
  ``spatial.RowSharded`` recomputes its shards itself; a pipeline
  recomputes each stage on the leaves its ``open_step`` gathered). A
  region around the whole forward would gather again in the backward, a
  collective there, and its new leaves would take gradients
  ``reduce_grads_`` never reads;
* ``--grad-accum``: ``gather_(hold=True)`` at the top of the
  accumulation step; both passes' forwards run on those leaves, so the
  chunks' gradients add up in the leaves' ``.grad``, and one
  ``reduce_grads_(mean=False)`` after the last chunk cuts them back, the
  ranks' sum (each rank back-propagates its own statistics with the
  global cotangent);
* ``--dtype bf16_params`` (``train_with`` a ``precision.MasterWeights``
  over the pieces): a train step's leaves are float32, the gathered bf16
  pieces widened, and a module reads its cast to bf16, so each leaf's
  gradient is the widening of the bf16 one; a wrapper's replicas (the
  row shards) each compute with their own cast (``Replicated``'s
  forward takes the step's ``precision.PerUseCasts``), and so do
  gpipe's microbatches of a pipeline stage (``casts_of``),
  so their uses add in float32, as ``precision.PerUseCasts`` adds them
  at the masters. ``reduce_grads_`` reduce-scatters that float32
  gradient and gives it to the piece's master gradient, with no rounding
  after it (a parameter kept whole reduces its master's gradient): no
  sum over ranks runs in bf16;
* ``--steps-per-dispatch K``: every gather, reduce-scatter and drop runs
  inside the step, so one CUDA graph captures K of them under NCCL, and
  no leaf outlives a replay.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from distributedpytorch_tpu_torch.dist.collectives import (
    all_gather_dim0,
    reduced_dim0_piece,
    sum_over_ranks_,
)
from distributedpytorch_tpu_torch.models import rematerialized
from distributedpytorch_tpu_torch.ops.precision import (
    WGRAD_DTYPE,
    PerUseCasts,
    has_master_weights,
)
from distributedpytorch_tpu_torch.parallel.replicas import (
    HELD_PARAMS,
    Replicated,
)


def is_cut(shape: Sequence[int], world: int) -> bool:
    """Whether a tensor of ``shape`` is cut over ``world`` ranks: dim 0
    divides (``mesh.state_leaf_spec``'s ``fsdp+channel`` rule on a
    channel slice)."""
    return len(shape) > 0 and shape[0] >= world and shape[0] % world == 0


@dataclasses.dataclass(frozen=True)
class Cut:
    """How ``ZeroSharded`` holds one parameter: ``out_dim`` cut into one
    channel slice per place (slice i on ``places[i]``), each slice's
    dim 0 cut again over the ranks where ``over_ranks``; the whole tensor
    is put together on ``home``."""

    home: torch.device
    places: Tuple[torch.device, ...]
    out_dim: int = 0
    over_ranks: bool = False


def _split(value: torch.Tensor, cut: Cut, world: int, rank: int
           ) -> List[torch.Tensor]:
    """This rank's pieces of the whole ``value``, each a view (on
    ``value``'s device)."""
    parts = value.chunk(len(cut.places), cut.out_dim)
    if cut.over_ranks:
        parts = [p.chunk(world)[rank] for p in parts]
    return list(parts)


def _placed(parts: Sequence[torch.Tensor], cut: Cut) -> List[torch.Tensor]:
    """``parts`` copied onto their places, contiguous."""
    return [p.to(place, copy=True, memory_format=torch.contiguous_format)
            for p, place in zip(parts, cut.places)]


def _join(pieces: Sequence[torch.Tensor], cut: Cut, world: int
          ) -> torch.Tensor:
    """The whole tensor on ``cut.home`` from this rank's pieces, outside
    autograd; where they are cut over the ranks every rank enters one
    ``all_gather_into_tensor``, of its slices' pieces stacked."""
    parts = [p.detach().to(cut.home) for p in pieces]
    if cut.over_ranks:
        if len(parts) == 1:
            parts = [all_gather_dim0(parts[0])]
        else:
            shape = parts[0].shape
            ranks = all_gather_dim0(torch.stack(parts)).view(
                world, len(parts), *shape)
            parts = [ranks[:, i].reshape(world * shape[0], *shape[1:])
                     for i in range(len(parts))]
    return parts[0] if len(parts) == 1 else torch.cat(parts, cut.out_dim)


class _Owner(NamedTuple):
    """One parameter of the wrapped model: where its module reads it, its
    whole shape, its ``Cut`` (None: held whole) and the indices of its
    pieces among ``ZeroSharded.pieces``."""

    module: nn.Module
    attr: str
    shape: Tuple[int, ...]
    cut: Optional[Cut]
    pieces: range


class PlainState:
    """``ChannelSharded``'s state protocol for a model that holds its
    tensors whole (a pipeline's stages): its state dict under its own
    names, read where its modules hold each tensor."""

    def __init__(self, model: nn.Module):
        self.model = model
        self._names = list(model.state_dict())
        self._param_names = [n for n, _ in model.named_parameters()]

    def _tensor(self, name: str) -> torch.Tensor:
        parent, _, attr = name.rpartition(".")
        return getattr(self.model.get_submodule(parent), attr)

    def whole_state(self) -> Dict[str, torch.Tensor]:
        """The state dict, each tensor copied to the host."""
        return {n: self._tensor(n).detach().to("cpu", copy=True)
                for n in self._names}

    @torch.no_grad()
    def load_whole_state(self, state: Mapping[str, torch.Tensor]) -> None:
        missing = [n for n in self._names if n not in state]
        unexpected = [n for n in state if n not in self._names]
        if missing or unexpected:
            raise RuntimeError(f"state dict: missing {missing}, "
                               f"unexpected {unexpected}")
        for name in self._names:
            self._tensor(name).copy_(state[name])

    def whole_param_names(self) -> List[str]:
        return list(self._param_names)

    @staticmethod
    def slice_values(whole: Sequence[torch.Tensor]) -> list:
        return list(whole)

    @staticmethod
    def whole_values(values: Sequence[torch.Tensor]) -> list:
        return list(values)

    @staticmethod
    def whole_optimizer_state(state: Mapping) -> dict:
        return dict(state)

    @staticmethod
    def sharded_optimizer_state(state: Mapping) -> dict:
        return dict(state)


def _one_group(state: Mapping, count: int) -> list:
    """``state``'s first param group's settings over ``count`` tensors."""
    settings = {k: v for k, v in state["param_groups"][0].items()
                if k != "params"}
    return [{**settings, "params": list(range(count))}]


class ZeroSharded(nn.Module):
    """``inner`` with its parameters cut as ``cuts`` says (one ``Cut`` or
    None per parameter, in ``named_parameters`` order; by default each
    one whose dim 0 divides the world over the ranks of the default
    group, on its own card), as the module docstring says. ``inner`` (a
    ``ChannelSharded``) exposes ``whole_state``, ``load_whole_state``,
    ``whole_optimizer_state``, ``sharded_optimizer_state``,
    ``whole_param_names``, ``slice_values`` and ``whole_values``, each
    over its parameters in ``named_parameters`` order; any other model is
    read as ``PlainState`` reads it, or as ``state`` (a ``PlainState`` of
    the model a wrapper such as ``spatial.RowSharded`` holds: the
    reference names, without the wrapper's prefix). Each module whose
    parameters it takes lists them under ``replicas.HELD_PARAMS``, so
    replicas copy the whole leaves. Without a process group the world is
    one rank. ``paths`` keeps ``inner``'s parameter name of each
    piece. ``remat`` recomputes ``inner`` in the backward of a train
    forward, on the leaves that forward gathered (the module
    docstring)."""

    def __init__(self, inner: nn.Module,
                 cuts: Optional[Sequence[Optional[Cut]]] = None,
                 state: Optional[PlainState] = None, remat: bool = False):
        super().__init__()
        self.remat = remat
        # the MasterWeights of the train steps (train_with), and the one
        # the leaves alive were gathered for
        self._masters = None
        self._step_masters = None
        self._held = False
        # a wrapper's replicas (row shards) compute each with its own
        # casts of a step's float32 leaves, which its forward takes
        self._takes_casts = isinstance(inner, Replicated)
        self._casts: Optional[PerUseCasts] = None
        # under master weights, each tensor a train step's modules read →
        # its float32 source (a leaf, or a whole parameter's master)
        self._sources: Optional[Dict[torch.Tensor, torch.Tensor]] = None
        self.world, self.rank = ((dist.get_world_size(), dist.get_rank())
                                 if dist.is_initialized() else (1, 0))
        self.inner = inner
        self._state = state or (inner if hasattr(inner, "whole_state")
                                else PlainState(inner))
        named = list(inner.named_parameters())
        if cuts is None:
            cuts = [Cut(p.device, (p.device,), 0, True)
                    if is_cut(p.shape, self.world) else None
                    for _, p in named]
        self._owners: List[_Owner] = []
        self.paths: List[str] = []
        self.pieces = nn.ParameterList()
        modules = dict(inner.named_modules())
        for (path, p), cut in zip(named, cuts):
            parent, _, attr = path.rpartition(".")
            module = modules[parent]
            if cut is None:
                shards = [p]
            else:
                with torch.no_grad():
                    shards = [nn.Parameter(t, requires_grad=p.requires_grad)
                              for t in _placed(_split(p.detach(), cut,
                                                      self.world, self.rank),
                                               cut)]
            del module._parameters[attr]
            # a whole one is read where it lies
            object.__setattr__(module, attr, None if cut else p)
            object.__setattr__(module, HELD_PARAMS,
                               getattr(module, HELD_PARAMS, ()) + (attr,))
            start = len(self.pieces)
            for shard in shards:
                self.pieces.append(shard)
                self.paths.append(path)
            self._owners.append(_Owner(module, attr, tuple(p.shape), cut,
                                       range(start, len(self.pieces))))
        self._leaves: List = []

    def _pieces_of(self, owner: _Owner) -> List[torch.Tensor]:
        return [self.pieces[i] for i in owner.pieces]

    def train_with(self, optimizer) -> None:
        """The optimizer the train steps drive: under master weights
        (``precision.MasterWeights``) a train step's leaves are float32
        and their gradients go to the masters (the module docstring)."""
        self._masters = optimizer if has_master_weights(optimizer) else None

    # -- the whole parameters, around a step --------------------------------
    def gather_(self, train: bool = False, hold: bool = False) -> None:
        """Every cut parameter whole on its home device, as a new leaf its
        module reads: a train step's (``train``), under master weights
        float32, each module reading its cast. With ``hold`` (a train
        step's) every forward until ``reduce_grads_`` or ``drop_`` runs on
        these leaves and gathers none."""
        masters = self._masters if train or hold else None
        leaves, sources = [], {}
        for owner in self._owners:
            pieces = self._pieces_of(owner)
            if owner.cut is None:
                if masters is not None:
                    sources[pieces[0]] = masters.leaf(pieces[0])
                continue
            whole = _join(pieces, owner.cut, self.world)
            if masters is None:
                leaf = read = whole.requires_grad_(pieces[0].requires_grad)
            else:
                leaf = whole.to(WGRAD_DTYPE).requires_grad_(
                    pieces[0].requires_grad)
                read = leaf.to(whole.dtype)
                sources[read] = leaf
            object.__setattr__(owner.module, owner.attr, read)
            leaves.append(leaf)
        self._leaves = leaves
        self._step_masters = masters
        self._held = hold
        self._sources = sources if masters is not None else None
        self._casts = (PerUseCasts(sources)
                       if masters is not None and self._takes_casts
                       else None)

    def drop_(self) -> None:
        """The whole leaves let go: the modules read None until the next
        ``gather_``."""
        for owner in self._owners:
            if owner.cut is not None:
                object.__setattr__(owner.module, owner.attr, None)
        self._leaves = []
        self._step_masters = None
        self._held = False
        self._sources = None
        self._casts = None

    def casts_of(self, module: nn.Module) -> Optional[PerUseCasts]:
        """Under master weights, in a train step: ``PerUseCasts`` of what
        ``module`` (a part of the wrapped model, a pipeline stage) reads,
        by its names in ``module``, each the cast of its float32 source
        (a cut parameter's leaf, a whole one's master). Each use of
        ``module`` through ``torch.func.functional_call`` then computes
        with casts of its own, so the uses' gradients add in float32 at
        the sources (gpipe's microbatches). None otherwise."""
        if self._sources is None:
            return None
        names = {m: name for name, m in module.named_modules()}
        named = [((names[o.module] + "." if names[o.module] else "")
                  + o.attr, getattr(o.module, o.attr))
                 for o in self._owners if o.module in names]
        return PerUseCasts(self._sources, named)

    @contextlib.contextmanager
    def whole(self):
        """Within the block the modules hold the whole parameters."""
        self.gather_()
        try:
            yield
        finally:
            self.drop_()

    def _train_forward(self, images: torch.Tensor) -> torch.Tensor:
        if self._casts is not None:
            return self.inner(images, casts=self._casts)
        return rematerialized(self.inner, self.remat)(images)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if self._held:
            return self._train_forward(images)
        if self.training and torch.is_grad_enabled():
            # the leaves stay for reduce_grads_ to read their gradients
            self.gather_(train=True)
            return self._train_forward(images)
        with self.whole():
            return self.inner(images)

    @torch.no_grad()
    def reduce_grads_(self, mean: bool = True) -> None:
        """After the backward: each cut parameter's pieces take their rows
        of its leaf's gradient on their places, reduce-scattered over the
        ranks where the pieces are cut over them; every other gradient (a
        whole parameter's, a channel slice's kept on every rank) is
        all-reduced, one flat all-reduce per device, where there are
        several ranks. Each is the ranks' mean with ``mean``, else their
        sum; zeros stand where there is no gradient, so every rank reduces
        the same tensors. Under master weights the gradients reduced are
        float32 and land in the masters' (the module docstring). Then the
        leaves are dropped."""
        masters = self._step_masters
        leaves = iter(self._leaves)
        rest = []
        for owner in self._owners:
            pieces = self._pieces_of(owner)
            if owner.cut is None:
                p = pieces[0]
                if masters is not None:
                    rest += masters.master_grads([p])
                    continue
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                rest.append(p.grad)
                continue
            leaf = next(leaves)
            grad = (leaf.grad if leaf.grad is not None
                    else torch.zeros_like(leaf))
            cut = owner.cut
            parts = grad.chunk(len(cut.places), cut.out_dim)
            if cut.over_ranks:
                parts = [reduced_dim0_piece(p, mean) for p in parts]
            for piece, g in zip(pieces, _placed(parts, cut)):
                if masters is None:
                    piece.grad = g
                else:
                    masters.add_master_grad(piece, g)
                    g = masters.master_grads([piece])[0]
                if not cut.over_ranks:
                    rest.append(g)
        if rest and self.world > 1:
            sum_over_ranks_(rest, mean=mean)
        self.drop_()

    # -- the whole state ------------------------------------------------------
    def whole_state(self) -> Dict[str, torch.Tensor]:
        with self.whole():
            return self._state.whole_state()

    @torch.no_grad()
    def load_whole_state(self, state: Mapping[str, torch.Tensor]) -> None:
        with self.whole():
            self._state.load_whole_state(state)
            leaves = iter(self._leaves)
            for owner in self._owners:
                if owner.cut is None:
                    continue
                parts = _split(next(leaves), owner.cut, self.world,
                               self.rank)
                for piece, part in zip(self._pieces_of(owner), parts):
                    piece.copy_(part)

    def whole_param_names(self) -> List[str]:
        return self._state.whole_param_names()

    def slice_values(self, whole: Sequence[torch.Tensor]) -> list:
        """Values of the whole parameters (reference order) → one per
        parameter of this module, each on its place."""
        out = []
        for owner, v in zip(self._owners, self._state.slice_values(whole)):
            out += ([v] if owner.cut is None else _placed(
                _split(v, owner.cut, self.world, self.rank), owner.cut))
        return out

    def whole_values(self, values: Sequence[torch.Tensor]) -> list:
        """The inverse of ``slice_values``: each cut parameter's values put
        together (every rank enters, in order, where they are cut over the
        ranks), then the wrapped model's ``whole_values``."""
        return self._state.whole_values([
            values[o.pieces.start] if o.cut is None
            else _join([values[i] for i in o.pieces], o.cut, self.world)
            for o in self._owners])

    def whole_optimizer_state(self, state: Mapping) -> dict:
        """An optimizer state dict over the pieces → the wrapped model's
        ``whole_optimizer_state`` of the whole tensors, each moment of a
        cut parameter put together (every rank enters, in index order);
        under master weights the f32 masters too, whole."""
        if "master" in state:
            return {"master": self.whole_values(state["master"]),
                    "inner": self.whole_optimizer_state(state["inner"])}
        slots = {int(k): v for k, v in state["state"].items()}
        out = {}
        for j, owner in enumerate(self._owners):
            if not all(i in slots for i in owner.pieces):
                continue
            first = slots[owner.pieces.start]
            out[j] = {key: (_join([slots[i][key] for i in owner.pieces],
                                  owner.cut, self.world)
                            if owner.cut is not None
                            and isinstance(v, torch.Tensor) and v.dim() > 0
                            else v)
                      for key, v in sorted(first.items())}
        return self._state.whole_optimizer_state(
            {"state": out,
             "param_groups": _one_group(state, len(self._owners))})

    def sharded_optimizer_state(self, state: Mapping) -> dict:
        """The inverse of ``whole_optimizer_state``: this rank's pieces of
        each moment, one param group over this module's parameters, and
        under master weights of each f32 master."""
        if "master" in state:
            return {"master": self.slice_values(state["master"]),
                    "inner": self.sharded_optimizer_state(state["inner"])}
        inner = self._state.sharded_optimizer_state(state)
        slots = {int(k): v for k, v in inner["state"].items()}
        out = {}
        for j, owner in enumerate(self._owners):
            if j not in slots:
                continue
            entry = slots[j]
            split = {key: _placed(_split(v, owner.cut, self.world,
                                         self.rank), owner.cut)
                     for key, v in entry.items()
                     if owner.cut is not None
                     and isinstance(v, torch.Tensor) and v.dim() > 0}
            for k, i in enumerate(owner.pieces):
                out[i] = {key: split[key][k] if key in split else v
                          for key, v in entry.items()}
        return {**inner, "state": out,
                "param_groups": _one_group(inner, len(self.pieces))}
