"""Run configuration of the port.

Counterpart of ``distributedpytorch_tpu/config.py``: ``TrainConfig`` with
the single-device trainer's fields and ``ServeConfig`` with the serving
slice's, under the JAX package's names and defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class TrainConfig:
    """The single-device trainer's knobs: what ``python -m
    distributedpytorch_tpu_torch`` parses into. Names and defaults are the
    JAX package's (reference train.py:18-24 for the optimization ones)."""

    # -- strategy -----------------------------------------------------------
    # only "singleGPU" is ported; DP/DDP/MP and the mesh specs are not yet
    train_method: str = "singleGPU"

    # -- optimization -------------------------------------------------------
    epochs: int = 10
    learning_rate: float = 1e-4
    batch_size: int = 4
    val_percent: float = 10.0  # percent, divided by 100
    seed: int = 42
    weight_decay: float = 1e-8  # Adam's L2, folded into the gradient
    # the reference's `(batch_size * loss).backward()` while recording the
    # unscaled loss
    faithful_loss_scaling: bool = True
    # ReduceLROnPlateau(mode='min') on the val loss
    plateau_patience: int = 2
    plateau_factor: float = 0.1

    # -- data ---------------------------------------------------------------
    data_dir: str = "./data"
    images_subdir: str = "train_hq"
    masks_subdir: str = "train_masks"
    image_size: Tuple[int, int] = (960, 640)  # (W, H), CLI flag order
    num_workers: int = 0  # host decode threads (0 = synchronous)
    # batches copied to the card ahead of the step (0 = inline)
    prefetch_batches: int = 2
    # decoded-sample cache (MiB of host RAM) shared by the train and val
    # loaders; 0 disables
    host_cache_mb: int = 1024
    synthetic_samples: int = 0  # >0: an in-memory procedural dataset

    # -- artifacts (reference layout) ---------------------------------------
    checkpoint_dir: str = "./checkpoints"
    log_dir: str = "./logs"
    loss_dir: str = "./loss"
    # -c: a native checkpoint to resume from, or a .pth to load weights from
    checkpoint_name: Optional[str] = None
    checkpoint_every_epochs: int = 1  # 0 = final save only
    metric_every_steps: int = 10  # a train loss row every N steps
    # one optimizer step per K loader batches, exact for the log-Dice loss
    grad_accum: int = 1

    # -- model --------------------------------------------------------------
    # "unet" = the reference course model (7,760,097 params); "milesial" =
    # milesial/Pytorch-UNet with BatchNorm (31,037,633 params at one class)
    model_arch: str = "unet"
    # None = the architecture's documented channel plan
    model_widths: Optional[Tuple[int, ...]] = None
    # every 3x3 conv's weight gradient as nine tap contractions
    # (ops/conv_backward.py); DPT_WGRAD_BACKEND=pallas lets the kernel
    # policy's K5 take the convs with both channel counts >= 128
    wgrad_taps: bool = False
    # accepted for checkpoint/CLI parity; the port always runs the pixel
    # path (space-to-depth is a TPU layout rewrite of the same function)
    s2d_levels: int = -1

    # -- execution ----------------------------------------------------------
    # precision policy (ops/precision.py): "bf16" or "f32" compute
    dtype: str = "bf16"
    # kernel policy (ops/kernels.py): "cuda" trains through the loss
    # statistics kernel and its backward, evaluates through the statistics
    # kernel, runs milesial's BatchNorm + ReLU through the epilogue kernels
    # and lets the taps conv use the 9-tap kernel; "torch" runs plain
    # PyTorch. None = "cuda" on a CUDA device, "torch" on the CPU.
    kernels: Optional[str] = None
    # "cuda" or "cpu"; None = "cuda", which raises without a card
    device: Optional[str] = None

    @property
    def val_fraction(self) -> float:
        return self.val_percent / 100.0


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
