"""The precision contracts and the compute dtype of each policy.

Counterpart of ``distributedpytorch_tpu/ops/precision.py`` (its contract
constants and the ``f32`` / ``bf16`` policies). Convolutions and
activations compute in the policy's dtype; parameters stay float32; the
sigmoid, losses and reductions stay float32 under every policy.
"""

from __future__ import annotations

import dataclasses

import torch

# -- the stated f32 contracts -------------------------------------------------
LOSS_DTYPE = torch.float32    # sigmoid output, loss + Dice/BCE statistics
WGRAD_DTYPE = torch.float32   # weight-grad accumulation
REDUCE_DTYPE = torch.float32  # cross-device grad/stats reductions
NORM_DTYPE = torch.float32    # BatchNorm statistics + normalization math


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """One policy: the dtype convs/activations compute in. Parameters
    are stored float32 under both policies of this port."""

    name: str
    compute_dtype: torch.dtype


POLICIES = {
    "f32": PrecisionPolicy("f32", torch.float32),
    "bf16": PrecisionPolicy("bf16", torch.bfloat16),
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
