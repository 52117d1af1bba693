"""Run configuration of the port.

Counterpart of ``distributedpytorch_tpu/config.py``: ``ServeConfig`` with
the field names and defaults of the serving slice, and the model-geometry
subset of ``TrainConfig`` that ``models.create_model`` reads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class TrainConfig:
    """Model geometry only; the trainer is not ported yet."""

    # "unet" = the reference course model (7,760,097 params)
    model_arch: str = "unet"
    # None = the architecture's documented channel plan
    model_widths: Optional[Tuple[int, ...]] = None
    # accepted for checkpoint/CLI parity; the port always runs the pixel
    # path (space-to-depth is a TPU layout rewrite of the same function)
    s2d_levels: int = -1
    # precision policy (ops/precision.py): "bf16" or "f32" compute
    dtype: str = "bf16"


@dataclasses.dataclass
class ServeConfig:
    """The serving knobs — what ``python -m distributedpytorch_tpu_torch
    serve`` parses into."""

    # -- model / checkpoint (must match training) ---------------------------
    checkpoint: str = ""
    checkpoint_dir: str = "./checkpoints"
    image_size: Tuple[int, int] = (960, 640)  # (W, H), CLI flag order
    model_arch: str = "unet"
    model_widths: Optional[Tuple[int, ...]] = None
    s2d_levels: int = -1
    threshold: float = 0.5
    # Kernel policy (ops/kernels.py): "cuda" ends every bucket forward in
    # the serve-mask kernel (uint8 masks come back from the card);
    # "torch" returns probabilities and thresholds on the host. None =
    # "cuda" on a CUDA device, "torch" on the CPU.
    kernels: Optional[str] = None
    # "cuda" (every visible card, one replica each) or "cpu"; None =
    # "cuda", which raises on a machine without a card.
    device: Optional[str] = None

    # -- batching -----------------------------------------------------------
    # The padded bucket ladder: every dispatch rides one of exactly these
    # batch shapes, each warmed per replica at startup.
    bucket_sizes: Tuple[int, ...] = (1, 2, 4, 8)
    # Latency SLO for the batching wait.
    slo_ms: float = 50.0
    # Work-conserving dispatch: with an idle replica, flush immediately.
    eager_when_idle: bool = True
    # Pending-image admission cap (None = 4x the largest bucket).
    queue_cap_images: Optional[int] = None

    # -- execution ----------------------------------------------------------
    # Data-parallel replicas, one per card (clamped to the cards present).
    replicas: int = 1
    # Buckets stacked + copied to the card ahead of dispatch; 0 = inline.
    placement_depth: int = 2
    # Dispatched-but-undrained buckets allowed per replica.
    inflight_per_replica: int = 2
    # None = one drain thread per in-flight slot.
    completion_workers: Optional[int] = None
    # SampleCache budget (MiB) for path-keyed request decode; 0 = off.
    host_cache_mb: int = 256

    # -- self-healing -------------------------------------------------------
    # In-process dispatch-core relaunch budget and base backoff.
    restart_limit: int = 3
    restart_backoff_s: float = 0.25

    # -- transport ----------------------------------------------------------
    host: str = "127.0.0.1"
    port: int = 8008
