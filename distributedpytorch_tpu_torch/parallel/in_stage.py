"""Sharding inside a pipeline stage: ``-t DxMxS`` with S > 1 and M > 1,
and ``-t Dx1xS@fsdp`` / ``DxMxS@fsdp`` with D > 1.

Counterpart of ``_in_stage_config``, ``_param_spec_tree``,
``_gather_params`` and ``_slice_to_shard`` of the JAX package's
``parallel/pipeline.py`` (:407-487, docstring :89-110). The stages are
built first (``pipeline.build_stages``: stage s's layers on its compute
device); then each stage's parameters are cut by ``mesh.state_leaf_spec``
on the port's tensors and held by ``parallel/zero.ZeroSharded``:

* **Devices.** A process computes on M·S devices of its own, ordered as
  the JAX mesh orders its axes (data, model, stage), stage fastest:
  stage s computes on device s, the device its ``Dx1xS`` twin computes
  on, and its M channel slices lie on devices s, S + s, …, (M − 1)·S + s.
  On the CPU, and on a card named by its index, every entry is that one
  device.
* **The cut.** A parameter's out-channels (dim 0; dim 1 of a transposed
  conv's weight) over its stage's M devices, where they divide; under
  ``@fsdp`` with D > 1 dim 0 of that slice again over the ranks, where
  its rows divide the world. A leaf that does not divide stays whole on
  the compute device (the 1-channel head). The JAX ``fsdp`` rule cuts a
  leaf's largest remaining axis, in uneven pieces where it must; the
  port cuts dim 0 in equal pieces or not at all, under ``Dx1xS@fsdp``
  too (``fsdp+channel``'s rule at M = 1).
* **The step.** The pipeline's ``open_step`` puts every cut leaf whole on
  its stage's compute device (``ZeroSharded.gather_``: one copy per piece,
  one ``all_gather_into_tensor`` per tensor over the ranks under
  ``@fsdp``), before any tick, as the JAX body gathers before its first
  ``lax.cond``. Each stage then runs once, on its compute device, on
  whole parameters: the JAX replicas along the model axis compute
  identically, so the port computes that function once. ``close_step``
  cuts each leaf's gradient back to its pieces on their devices
  (``ZeroSharded.reduce_grads_``); a piece cut over the ranks is
  reduce-scattered, every other gradient all-reduced over the data ranks,
  each as the ranks' mean under gpipe and their sum under 1f1b (the
  pipeline's gradient factor per schedule). Eval gathers at its top and
  drops at its end.
* **The run control** (JAX ``_build_stage_fns(..., remat)``,
  ``build_multi_train_step`` and ``policy.cast_grads`` around
  ``_pipeline_raw_step``) runs on the leaves the step's top gathered,
  as ``parallel/pipeline.py`` says: ``--remat`` recomputes each stage on
  them, with no gather and no collective in the backward; under
  ``--dtype bf16_params`` they are float32, each gpipe microbatch
  computing with casts of its own, and their gradients go to the masters
  of the pieces; ``--steps-per-dispatch K`` captures K steps over every
  place (``strategy.InStage.step_devices``), each gather, reduction and
  drop inside. ``--grad-accum`` is refused, as every pipeline refuses it
  ("raise --microbatches").
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from distributedpytorch_tpu_torch.parallel.mesh import (
    MeshConfig,
    state_leaf_spec,
)
from distributedpytorch_tpu_torch.parallel.zero import Cut, ZeroSharded


def in_stage_config(cfg: MeshConfig) -> Optional[MeshConfig]:
    """``cfg`` where its params rule cuts a pipeline stage's leaves over an
    axis the mesh has (the channels over a model axis M > 1, ZeRO over a
    data axis D > 1 under ``@fsdp``), else None: the flat pipeline
    (JAX ``_in_stage_config``). A spatial model axis inside a stage is
    not one: ``strategy.check_train_method`` refuses it."""
    if cfg.stage < 2 or (cfg.model > 1 and cfg.model_role == "spatial"):
        return None
    zero = cfg.data > 1 and "fsdp" in cfg.params
    return cfg if (cfg.model > 1 or zero) else None


def place_devices(devices: Sequence[torch.device], num_stages: int,
                  model: int, stage: int) -> List[torch.device]:
    """Stage ``stage``'s ``model`` channel-slice devices among a process's
    M·S ``devices`` (stage fastest)."""
    return [torch.device(devices[i * num_stages + stage])
            for i in range(model)]


def leaf_cut(cfg: MeshConfig, shape: Sequence[int], out_dim: int,
             places: Sequence[torch.device]) -> Optional[Cut]:
    """The ``Cut`` of one leaf of ``shape`` whose out-channels lie on
    ``out_dim``, its channel slices on ``places`` (the first its stage's
    compute device): ``state_leaf_spec``'s ``fsdp+channel`` rule under
    ``@fsdp``, its ``channel`` rule otherwise; None where nothing is cut
    (JAX ``_param_spec_tree`` for one leaf)."""
    rule = (dataclasses.replace(cfg, params="fsdp+channel")
            if "fsdp" in cfg.params else cfg)
    spec = state_leaf_spec(rule, shape, out_dim)
    channel = cfg.model_axis_name in spec[out_dim] if spec else False
    over_ranks = "data" in spec[0] if spec else False
    if not (channel or over_ranks):
        return None
    home = torch.device(places[0])
    return Cut(home, tuple(places) if channel else (home,), out_dim,
               over_ranks)


def shard_stages(model: nn.Module, stages: Sequence[nn.Module],
                 devices: Sequence[torch.device], cfg: MeshConfig
                 ) -> ZeroSharded:
    """``model``, whose ``stages`` (``pipeline.build_stages``) hold its
    layers on ``devices[:S]``, with each stage's parameters cut over its M
    devices among ``devices`` and, under ``@fsdp``, the ranks (the module
    docstring). ``stage_of`` gives the stage of each parameter of
    ``model``, in its order."""
    num_stages = len(stages)
    stage_of = {}
    for s, stage in enumerate(stages):
        for p in stage.parameters():
            stage_of[p] = s
    transposed = {m.weight for m in model.modules()
                  if isinstance(m, nn.ConvTranspose2d)}
    cuts, stages_of = [], []
    for p in model.parameters():
        s = stage_of[p]
        places = place_devices(devices, num_stages, cfg.model, s)
        cuts.append(leaf_cut(cfg, p.shape, 1 if p in transposed else 0,
                             places))
        stages_of.append(s)
    sharded = ZeroSharded(model, cuts)
    sharded.stage_of = stages_of
    return sharded
