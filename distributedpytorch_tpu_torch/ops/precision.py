"""The precision contracts, the policies, and the f32 master weights of
``bf16_params``.

Counterpart of ``distributedpytorch_tpu/ops/precision.py``: its contract
constants, the ``f32`` / ``bf16`` / ``bf16_params`` policies,
``with_master_weights`` (here ``MasterWeights``) and
``convert_checkpoint_state``. Convolutions and activations compute in the
policy's dtype; parameters are float32 except under ``bf16_params``, which
stores them in bf16 on the device and keeps an f32 master copy in the
optimizer; the sigmoid, losses and reductions stay float32 under every
policy.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

logger = logging.getLogger(__name__)

# -- the stated f32 contracts -------------------------------------------------
LOSS_DTYPE = torch.float32    # sigmoid output, loss + Dice/BCE statistics
WGRAD_DTYPE = torch.float32   # weight-grad accumulation
REDUCE_DTYPE = torch.float32  # cross-device grad/stats reductions
NORM_DTYPE = torch.float32    # BatchNorm statistics + normalization math


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """One policy: the dtype convs and activations compute in, the dtype
    parameters are stored in on the device, and whether an f32 master
    copy lives in the optimizer."""

    name: str
    compute_dtype: torch.dtype
    param_dtype: torch.dtype = torch.float32
    master_weights: bool = False


POLICIES = {
    "f32": PrecisionPolicy("f32", torch.float32),
    "bf16": PrecisionPolicy("bf16", torch.bfloat16),
    "bf16_params": PrecisionPolicy("bf16_params", torch.bfloat16,
                                   torch.bfloat16, True),
}


def get_policy(config_or_name=None) -> PrecisionPolicy:
    """A policy by name, from a config's ``dtype`` field, or the ``bf16``
    default for ``None``."""
    if config_or_name is None:
        name = "bf16"
    elif isinstance(config_or_name, str):
        name = config_or_name
    else:
        name = getattr(config_or_name, "dtype", None) or "bf16"
    try:
        return POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown precision policy {name!r} (expected one of "
            f"{sorted(POLICIES)})"
        ) from None


def cast_params_(module: torch.nn.Module, policy: PrecisionPolicy) -> None:
    """Every floating parameter of ``module`` stored in the policy's
    parameter dtype, in place; buffers (BatchNorm's running statistics)
    stay as they are, as the JAX policy casts ``params`` only."""
    for p in module.parameters():
        if p.is_floating_point() and p.dtype != policy.param_dtype:
            p.data = p.data.to(policy.param_dtype)


class MasterWeights:
    """An optimizer over an f32 master copy of low-precision parameters:
    the counterpart of ``with_master_weights`` (JAX precision.py:195-256),
    and the one owner of its gradient contract.

    ``make_inner(master)`` builds the wrapped optimizer over the master
    tensors, so Adam's moments are f32 too. A hook on each parameter
    moves its (bf16) gradient into its master's ``.grad`` as
    ``WGRAD_DTYPE`` as soon as autograd has accumulated it, adding to
    what is there: the gradients of several backward passes (the
    accumulation's chunks, 1f1b's units) add up in f32 with no call from
    the steps (JAX ``cast_grads``, :133-140). ``step`` widens what a hook
    did not see, scales the f32 gradients by the factor the step's
    backward left out (``backward_scale``), steps the master and sets
    each parameter to its master rounded to the parameter's dtype, one
    rounding and no other. ``param_groups`` are the wrapped optimizer's,
    so the learning rate is set as for any optimizer
    (``ops/optim.set_learning_rate``)."""

    #: what ``has_master_weights`` reads; a wrapper of this optimizer
    #: forwards it
    master_weights = True

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 make_inner: Callable[[List[torch.Tensor]],
                                      torch.optim.Optimizer]):
        self.params = list(params)
        self.master = [p.detach().to(WGRAD_DTYPE, copy=True)
                       for p in self.params]
        self.inner = make_inner(self.master)
        self._master_of = dict(zip(self.params, self.master))
        self._scale = 1.0
        # the newest MasterWeights over a parameter owns its gradient
        for p in self.params:
            old = getattr(p, "_master_weights_hook", None)
            if old is not None:
                old.remove()
            p._master_weights_hook = p.register_post_accumulate_grad_hook(
                self._widen)

    def leaf(self, p: torch.nn.Parameter) -> torch.Tensor:
        """``p``'s f32 master as an autograd leaf: a use that computes with
        ``leaf(p)`` cast to ``p``'s dtype sends its gradient to the
        master's ``.grad``, widened before it meets another use's
        (``PerUseCasts``). The optimizer's step runs without grad, so the
        flag changes nothing else."""
        return self._master_of[p].requires_grad_(True)

    def _widen(self, p: torch.Tensor) -> None:
        m = self._master_of[p]
        g = p.grad.to(WGRAD_DTYPE)
        m.grad = g if m.grad is None else m.grad.add_(g)
        p.grad = None

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        for t in self.params + self.master:
            if set_to_none:
                t.grad = None
            elif t.grad is not None:
                t.grad.zero_()

    def scale_next_step(self, scale: float) -> None:
        """The next ``step`` multiplies the f32 gradients by ``scale``."""
        self._scale = float(scale)

    def master_grads(self, params: Iterable[torch.Tensor]
                     ) -> List[torch.Tensor]:
        """The f32 gradients of ``params``' masters, zeros where there is
        none yet: what the next step reads, less its scale."""
        out = []
        for p in params:
            m = self._master_of[p]
            if m.grad is None:
                m.grad = torch.zeros_like(m)
            out.append(m.grad)
        return out

    def _widen_left(self) -> None:
        """Any gradient left on a parameter, where no hook saw it (set by
        hand, or DDP's reducer writing after the backward), widened in."""
        for p in self.params:
            if p.grad is not None:
                self._widen(p)

    def grads(self) -> List[torch.Tensor]:
        """Every master's gradient (``master_grads``), what is left on the
        parameters widened in first."""
        self._widen_left()
        return self.master_grads(self.params)

    @torch.no_grad()
    def step(self) -> None:
        self._widen_left()
        if self._scale != 1.0:
            torch._foreach_mul_([m.grad for m in self.master
                                 if m.grad is not None], self._scale)
            self._scale = 1.0
        self.inner.step()
        for p, m in zip(self.params, self.master):
            p.copy_(m)

    def register_step_pre_hook(self, hook):
        """``hook(optimizer, args, kwargs)`` before each step of the
        wrapped optimizer, whose gradients then are the master's scaled
        f32 ones."""
        return self.inner.register_step_pre_hook(hook)

    @torch.no_grad()
    def reseed_(self, values: Sequence[torch.Tensor]) -> None:
        """The master set to ``values`` (one per parameter, any float
        dtype), exactly where they are f32."""
        for m, v in zip(self.master, values):
            m.copy_(v.to(device=m.device, dtype=WGRAD_DTYPE))

    def state_dict(self) -> dict:
        return {"master": list(self.master),
                "inner": self.inner.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.reseed_(state["master"])
        self.inner.load_state_dict(state["inner"])


class PerUseCasts:
    """The parameters of ``module`` for one use, under master weights: each
    its f32 master (``MasterWeights.leaf``) cast to the parameter's dtype,
    on the use's device. A parameter that several uses share in one
    backward (gpipe's microbatches, DP's replicas) would otherwise collect
    their bf16 gradients in bf16 before the master's hook widens the sum;
    through its own cast each use's gradient becomes f32 first, and
    autograd adds the uses at the f32 leaf. That is the JAX steps'
    design, which differentiate an f32 view of the parameters and let the
    model cast it (parallel/pipeline.py:699-707). The cast of the master
    is the parameter's value: the master's step sets each parameter to
    its master rounded."""

    def __init__(self, optimizer, module: torch.nn.Module):
        self.named = [(name, p, optimizer.leaf(p))
                      for name, p in module.named_parameters()]
        self._leaf = {p: m for _, p, m in self.named}

    def master(self, p: torch.nn.Parameter) -> torch.Tensor:
        """``p``'s f32 master, the leaf its uses' gradients add at."""
        return self._leaf[p]

    def of(self, p: torch.nn.Parameter) -> torch.Tensor:
        """``p``'s cast for one use, on ``p``'s device."""
        return self._leaf[p].to(device=p.device, dtype=p.dtype)

    def named_casts(self) -> Dict[str, torch.Tensor]:
        """``{name: cast}`` of every parameter, each on its own device:
        what ``torch.func.functional_call`` runs one use of the module
        with."""
        return {name: self.of(p) for name, p, _ in self.named}


def per_use_casts(optimizer, module: torch.nn.Module
                  ) -> Optional[PerUseCasts]:
    """``PerUseCasts`` of ``module`` under master weights; None otherwise,
    where the parameters are f32 and their uses add in f32 already."""
    if not has_master_weights(optimizer):
        return None
    return PerUseCasts(optimizer, module)


def has_master_weights(optimizer) -> bool:
    """Whether ``optimizer`` steps an f32 master copy (``MasterWeights``,
    or a wrapper that forwards its ``master_weights``)."""
    return bool(getattr(optimizer, "master_weights", False))


def backward_scale(optimizer, scale: float) -> float:
    """The factor a step's backward seed carries so that the optimizer's
    next step reads its gradients times ``scale`` (the faithful batch
    size), in the policy's order (JAX steps.py:191-205): with float32
    parameters ``scale`` itself, the reference's ``(batch_size × loss)
    .backward()``, the same function; under master weights 1, and the
    master's step scales the widened f32 gradients instead, so no
    scaling rounds in bf16."""
    if has_master_weights(optimizer):
        optimizer.scale_next_step(scale)
        return 1.0
    return scale


def optimizer_grads(optimizer, params: Sequence[torch.nn.Parameter]
                    ) -> List[torch.Tensor]:
    """The gradients the optimizer's next step reads, in ``WGRAD_DTYPE``,
    one per parameter, zeros where there is none: under master weights
    the masters' (``MasterWeights.grads``), otherwise each parameter's
    ``.grad``."""
    if has_master_weights(optimizer):
        return optimizer.grads()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return [p.grad for p in params]


def convert_checkpoint_state(
    saved: PrecisionPolicy,
    current: PrecisionPolicy,
    model_state: Dict[str, torch.Tensor],
    opt_state: Optional[dict],
    param_names: Sequence[str],
    where: str = "restore",
) -> Tuple[Dict[str, torch.Tensor], Optional[dict]]:
    """A restored (model state dict, optimizer state dict) pair converted
    from the ``saved`` policy to the ``current`` one (JAX
    precision.py:297-346), exactly where exactness is possible:

    * master → no master: the f32 master becomes the parameters (cast to
      the current dtype, a no-op for f32) and the wrapped optimizer's
      state the optimizer state;
    * no master → master: the saved f32 parameters seed the master bit
      for bit and the saved optimizer state becomes the wrapped one;
    * otherwise the parameters are cast to the current dtype.

    ``param_names`` are the model's parameter names in
    ``named_parameters`` order, the order of the master list.
    ``opt_state`` may be None and stays None."""
    out = dict(model_state)

    def cast(values):
        for name, v in zip(param_names, values):
            out[name] = v.to(current.param_dtype)

    if saved.master_weights == current.master_weights or opt_state is None:
        cast([model_state[n] for n in param_names])
        return out, opt_state
    if saved.master_weights:
        logger.warning(
            "%s: checkpoint saved under %r, restoring under %r — the f32 "
            "master weights become the parameters (exact) and the "
            "optimizer state is unwrapped", where, saved.name, current.name)
        cast(opt_state["master"])
        return out, opt_state["inner"]
    logger.warning(
        "%s: checkpoint saved under %r, restoring under %r — the f32 "
        "master is seeded from the saved parameters (exact) and the "
        "optimizer state is wrapped", where, saved.name, current.name)
    master = [model_state[n].to(WGRAD_DTYPE, copy=True) for n in param_names]
    cast([model_state[n] for n in param_names])
    return out, {"master": master, "inner": opt_state}
