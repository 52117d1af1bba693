"""Run configuration of the port.

Counterpart of ``distributedpytorch_tpu/config.py``: ``TrainConfig`` with
the fields of the strategies the port trains and of the trainer's run
control (checkpoint retention and async writes, ``--save-best``, early
stop, the non-finite policies, remat, K steps per dispatch, the step
timeline), and ``ServeConfig`` with the serving slice's, under the JAX
package's names and defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class TrainConfig:
    """The trainer's knobs: what ``python -m
    distributedpytorch_tpu_torch`` parses into. Names and defaults are the
    JAX package's (reference train.py:18-24 for the optimization ones)."""

    # -- strategy -----------------------------------------------------------
    # "singleGPU", "DP", "DDP", "MP" or "DDP_MP" (parallel/strategy.py);
    # the mesh specs, SP, DDP_SP, TP and FSDP are not ported yet
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
    # reference quirk 2: DDP (and DDP_MP) multiplies the lr by the world size
    # (train_utils.py:199)
    ddp_lr_world_size_scaling: bool = True
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

    # -- pipeline (MP, and each rank of DDP_MP) -------------------------------
    num_microbatches: int = 2  # reference hardcodes 2 (unet_model.py:25)
    # Stages of the pipeline. 2 = the reference's encoder|decoder cut
    # (unet_model.py:16-20); any S up to the model's 2L+1 segments works —
    # the bubble is (S−1)/(M+S−1), so raise num_microbatches with S.
    num_stages: int = 2
    # Where stages begin, as model-segment indices (see UNet.apply_segment:
    # L encoder levels, mid, L decoder levels+head). None = the faithful
    # 2-stage cut for S=2, an even split otherwise.
    pipeline_cuts: Optional[Tuple[int, ...]] = None
    # Pipeline schedule (parallel/pipeline.py): "gpipe" (fill-drain;
    # every microbatch's stage activations stay alive until the backward,
    # so peak memory grows with num_microbatches) or "1f1b"
    # (PipeDream-flush: at most ~S−s input carries held at stage s,
    # whatever M is; one extra forward per microbatch)
    pipeline_schedule: str = "gpipe"

    # -- artifacts (reference layout) ---------------------------------------
    checkpoint_dir: str = "./checkpoints"
    log_dir: str = "./logs"
    loss_dir: str = "./loss"
    # -c: a native checkpoint to resume from, or a .pth to load weights from
    checkpoint_name: Optional[str] = None
    checkpoint_every_epochs: int = 1  # 0 = final save only
    # keep a separate <method>_best.pt at the highest val Dice seen
    save_best: bool = False
    # the file write on a background thread (the host snapshot is taken
    # in the step loop's thread); train() drains the writes before it
    # returns. False = synchronous saves (--sync-checkpoint)
    async_checkpoint: bool = True
    # stop when the val loss has not improved for N epochs (0 = off)
    early_stop_patience: int = 0
    # the newest N files per checkpoint path (<tag>.pt, <tag>.pt.1, ...);
    # a restore verifies each file's content hash and falls back to the
    # newest intact one. 1 = overwrite in place
    keep_checkpoints: int = 2
    metric_every_steps: int = 10  # a train loss row every N steps
    # one optimizer step per K loader batches, exact for the log-Dice loss
    grad_accum: int = 1

    # -- resilience -----------------------------------------------------------
    # on a non-finite train loss: "abort" raises when its row is read;
    # "rollback" reloads the newest intact checkpoint in place and redoes
    # its epoch, up to rollback_retries times (single process only);
    # "skip" reads every step's loss and puts back the state from before
    # a non-finite step (one host sync per step)
    nonfinite_policy: str = "abort"
    rollback_retries: int = 2

    # -- memory and dispatch --------------------------------------------------
    # recompute the forward in the backward (torch.utils.checkpoint):
    # activation memory for about one more forward per step
    remat: bool = False
    # K optimizer steps per dispatch: on the card one CUDA graph of K
    # whole steps, on the CPU K plain steps with one loss readback
    steps_per_dispatch: int = 1

    # -- observability --------------------------------------------------------
    # the step timeline (utils/trace.py): per-phase host spans appended to
    # this JSONL path; rank R of a multi-process run writes <path>.rankR.
    # None = off
    timeline_path: Optional[str] = None

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
    # precision policy (ops/precision.py): "bf16" (bf16 compute, f32
    # parameters), "f32", or "bf16_params" (bf16 parameters on the device,
    # f32 master weights in the optimizer)
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
