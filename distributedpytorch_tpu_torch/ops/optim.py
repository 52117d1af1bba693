"""Adam with the reference's settings and a learning rate the plateau
scheduler changes between epochs.

Counterpart of ``distributedpytorch_tpu/ops/optim.py``. The reference
optimizes with ``optim.Adam(params, lr, weight_decay=1e-8)``: L2 folded
into the gradient before the moment updates, which is what the JAX
package's ``adam_l2`` chain (``add_decayed_weights`` → ``scale_by_adam``
→ ``-lr``) reproduces and ``torch.optim.Adam`` is.

The optimizer is built through the precision policy: under
``bf16_params`` Adam runs over the f32 master weights
(``ops/precision.MasterWeights``). With ``capturable`` (the CUDA graph of
K steps, ``train/steps.make_multi_train_step``) Adam keeps its step count
and its learning rate in tensors on the card, as the JAX lr lives in the
optimizer state: a graph reads the lr tensor at every replay, so
``set_learning_rate`` writes into it rather than replacing it. Adam holds
one param group per card (``device_runs``: a pipeline's stages), each
with its own lr, which a capturable step reads on that card.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch

from distributedpytorch_tpu_torch.ops.precision import (
    MasterWeights,
    PrecisionPolicy,
    has_master_weights,
)


def device_runs(params: Iterable[torch.Tensor]) -> List[List[torch.Tensor]]:
    """``params`` cut where the device changes, in order: one run per
    device for a model whose stages hold contiguous layers. Joined again,
    the runs are ``params``, so Adam's state indices mean the same
    parameters whatever the runs are."""
    runs: List[List[torch.Tensor]] = []
    for p in params:
        if runs and runs[-1][-1].device == p.device:
            runs[-1].append(p)
        else:
            runs.append([p])
    return runs


def _adam(params, learning_rate: float, weight_decay: float,
          capturable: bool) -> torch.optim.Adam:
    """One param group per ``device_runs`` run, each with its lr: a
    tensor on its own card when capturable, since Adam's arithmetic reads
    it there (a pipeline's stages sit on several cards)."""
    groups = [{"params": run,
               "lr": (torch.tensor(float(learning_rate), dtype=torch.float32,
                                   device=run[0].device)
                      if capturable else learning_rate)}
              for run in device_runs(params)]
    return torch.optim.Adam(groups, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay,
                            capturable=capturable)


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   learning_rate: float,
                   weight_decay: float = 1e-8,
                   policy: Optional[PrecisionPolicy] = None,
                   capturable: bool = False):
    """``torch.optim.Adam`` over ``params``, or under a master-weight
    ``policy`` over their f32 master copy."""
    if policy is not None and policy.master_weights:
        return MasterWeights(params, lambda master: _adam(
            master, learning_rate, weight_decay, capturable))
    return _adam(params, learning_rate, weight_decay, capturable)


def set_learning_rate(optimizer, lr: float) -> None:
    """The lr of every param group. A capturable group's lr is a tensor on
    its parameters' device, written in place (a tensor from elsewhere, as
    ``load_state_dict`` leaves a checkpoint's, is replaced by one)."""
    for group in optimizer.param_groups:
        if not group.get("capturable"):
            group["lr"] = float(lr)
            continue
        device = group["params"][0].device
        current = group["lr"]
        if isinstance(current, torch.Tensor) and current.device == device:
            current.fill_(float(lr))
        else:
            group["lr"] = torch.tensor(float(lr), dtype=torch.float32,
                                       device=device)


def _regrouped(state: dict, optimizer) -> dict:
    """``state`` (a torch optimizer's state dict) with its param groups
    cut as ``optimizer``'s are. A checkpoint of another device list has
    other runs (``device_runs``); the state's indices count the
    parameters in order either way, and every group carries the same
    settings, so the saved first group's settings go to every group."""
    saved = state["param_groups"]
    sizes = [len(g["params"]) for g in optimizer.param_groups]
    if [len(g["params"]) for g in saved] == sizes:
        return state
    order = [i for g in saved for i in g["params"]]
    if len(order) != sum(sizes):
        raise ValueError(
            f"optimizer state over {len(order)} parameters, this optimizer "
            f"holds {sum(sizes)}")
    settings = {k: v for k, v in saved[0].items() if k != "params"}
    groups, at = [], 0
    for n in sizes:
        groups.append({**settings, "params": order[at:at + n]})
        at += n
    return {**state, "param_groups": groups}


def load_optimizer_state(optimizer, state: dict) -> None:
    """``optimizer.load_state_dict(state)`` with this run's param groups
    and ``capturable`` kept. torch takes each param group whole from the
    state, so a checkpoint of another ``--steps-per-dispatch`` or device
    would leave a K-step graph a non-capturable Adam, or a run on the CPU
    a capturable one, and one of another device list would not load.
    The groups are cut as this optimizer's (``_regrouped``), and the lr
    and Adam's step counts go where this run's arithmetic reads them: on
    each group's device when capturable, a float and on the CPU
    otherwise."""
    capturable = [bool(g.get("capturable")) for g in optimizer.param_groups]
    if has_master_weights(optimizer):
        state = {**state, "inner": _regrouped(state["inner"],
                                              optimizer.inner)}
    else:
        state = _regrouped(state, optimizer)
    optimizer.load_state_dict(state)
    for group, cap in zip(optimizer.param_groups, capturable):
        device = group["params"][0].device if cap else torch.device("cpu")
        lr = float(group["lr"])
        group["capturable"] = cap
        group["lr"] = (torch.tensor(lr, dtype=torch.float32, device=device)
                       if cap else lr)
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if isinstance(st.get("step"), torch.Tensor):
                st["step"] = st["step"].to(device=device,
                                           dtype=torch.float32)


def get_learning_rate(optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])
