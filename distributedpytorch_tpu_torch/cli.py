"""Train the UNet on images and target masks — ``python -m
distributedpytorch_tpu_torch [-t singleGPU|DP|DDP|MP|DDP_MP] ...``.

Counterpart of ``distributedpytorch_tpu/cli.py`` for the flags the port
implements: the reference's ``-t -v -l -e --lr -b -c -s`` and
``--data-dir --synthetic --image-size --microbatches --stages
--pipeline-cuts --pipeline-schedule --model --model-widths --wgrad-taps
--dtype --kernels --device --grad-accum --num-workers --prefetch-batches
--host-cache-mb --checkpoint-dir`` and the run control's ``--remat
--steps-per-dispatch --nonfinite-policy --rollback-retries --save-best
--early-stop --keep-checkpoints --sync-checkpoint --trace-timeline
--export-pth``.
``--s2d-levels`` is accepted and has no effect (the port runs the pixel
path), and so is ``--export-pth``: the port writes ``<method>.pth`` at the
end of every run. A flag the port does not implement is not defined, so
argparse rejects it. The run writes ``./logs/<method>.log`` (message-only),
``./loss/<method>/``, ``<checkpoint-dir>/<method>.pt`` (resume with
``-c <method>``) and ``<checkpoint-dir>/<method>.pth`` (serve with
``python -m distributedpytorch_tpu_torch serve -c <method>``).

``-t DDP`` runs one process per card under torchrun (NCCL; gloo with
``--device cpu``), ``-b`` per process; without a launcher it runs as one
process. Every rank appends to the log file; only rank 0 mirrors it to
stderr and writes the checkpoints, loss tables and ``.pth``. ``-t DP``
splits the global batch ``-b`` over every visible card in one process;
``-t MP`` pipelines it over the first ``--stages`` cards in
``--microbatches`` microbatches (``--pipeline-schedule gpipe|1f1b``).
``-t DDP_MP`` runs one process per data replica under torchrun, each the
``--stages`` pipeline on cards ``LOCAL_RANK·S`` … ``LOCAL_RANK·S + S − 1``
of its node, ``-b`` per process. With ``--device cpu`` all of them run on
the CPU, every stage there (DDP and DDP_MP under gloo).

It runs on the card unless ``--device cpu`` asks for the CPU:
    python -m distributedpytorch_tpu_torch -t singleGPU --synthetic 40
    python -m distributedpytorch_tpu_torch -t MP --stages 2 \\
        --microbatches 2 --pipeline-schedule 1f1b --synthetic 40
    torchrun --standalone --nproc_per_node 4 \
        -m distributedpytorch_tpu_torch -t DDP --synthetic 40
    torchrun --standalone --nproc_per_node 2 \
        -m distributedpytorch_tpu_torch -t DDP_MP --stages 2 \
        --microbatches 2 --pipeline-schedule 1f1b --synthetic 40
    DPT_WGRAD_BACKEND=pallas python -m distributedpytorch_tpu_torch \
        --model milesial --wgrad-taps --kernels cuda --synthetic 40
    python -m distributedpytorch_tpu_torch --synthetic 16 \\
        --image-size 48 32 --model-widths 8 16 -e 1 -b 2 --device cpu
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import List


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m distributedpytorch_tpu_torch",
        description="Train UNet on images and target masks",
    )
    parser.add_argument("--train-method", "-t", type=str, default="singleGPU",
                        help="Training method: singleGPU, DP, DDP, MP or "
                             "DDP_MP (mesh specs, SP, DDP_SP, TP, FSDP: "
                             "ROADMAP.md)")
    parser.add_argument("--validation", "-v", dest="val", type=float,
                        default=10.0,
                        help="Percentage of data used as validation")
    parser.add_argument("--load", "-l", type=str, default=None,
                        help="Load a checkpoint (alias of -c)")
    parser.add_argument("--epochs", "-e", type=int, default=10,
                        help="Number of epochs")
    parser.add_argument("--learning-rate", "--lr", type=float, default=1e-4,
                        dest="lr", help="Learning rate")
    parser.add_argument("--batch-size", "-b", type=int, default=4,
                        help="Batch size (per process under DDP and "
                             "DDP_MP, global under DP and MP)")
    parser.add_argument("--checkpoint", "-c", type=str, default=None,
                        help="Resume from a native checkpoint (<name>.pt), "
                             "or load weights from a reference .pth")
    parser.add_argument("--seed", "-s", type=int, default=42,
                        help="Set seed for reproducibility")
    parser.add_argument("--data-dir", type=str, default="./data",
                        help="Root containing train_hq/ and train_masks/")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="Use N in-memory synthetic samples instead of "
                             "disk data")
    parser.add_argument("--image-size", type=int, nargs=2,
                        default=(960, 640), metavar=("W", "H"),
                        help="Resize target (W H)")
    parser.add_argument("--microbatches", type=int, default=2,
                        help="Pipeline microbatches (MP); reference "
                             "hardcodes 2")
    parser.add_argument("--stages", type=int, default=2,
                        help="Pipeline stages (MP); 2 = the reference's "
                             "encoder|decoder cut; bubble is "
                             "(S-1)/(M+S-1), so raise --microbatches with S")
    parser.add_argument("--pipeline-cuts", type=int, nargs="+", default=None,
                        help="Explicit stage boundaries as model-segment "
                             "indices (L encoder levels, mid, L decoder "
                             "levels+head); default: faithful 2-stage cut, "
                             "even split otherwise")
    parser.add_argument("--pipeline-schedule", type=str, default="gpipe",
                        choices=["gpipe", "1f1b"],
                        help="MP schedule: gpipe (fill-drain; activation "
                             "memory grows with --microbatches) or 1f1b "
                             "(PipeDream-flush; in-flight memory bounded by "
                             "--stages, grad-equivalent)")
    parser.add_argument("--model", dest="model_arch", type=str,
                        default="unet", choices=["unet", "milesial"],
                        help="Model family: unet = the reference course "
                             "model (7.76M params), milesial = "
                             "milesial/Pytorch-UNet (31M params, BatchNorm)")
    parser.add_argument("--model-widths", type=int, nargs="+", default=None,
                        help="Channel widths (default: unet 32 64 128 256, "
                             "milesial 64 128 256 512 1024)")
    parser.add_argument("--wgrad-taps", action="store_true",
                        help="3x3 conv weight gradients as nine tap "
                             "contractions; with DPT_WGRAD_BACKEND=pallas "
                             "and --kernels cuda the convs with both "
                             "channel counts >= 128 take the 9-tap kernel")
    parser.add_argument("--dtype", type=str, default="bf16",
                        choices=["f32", "bf16", "bf16_params"],
                        help="Precision policy: bf16 conv compute with f32 "
                             "params and loss (default), f32, or "
                             "bf16_params (bf16 params on the device, f32 "
                             "master weights in the optimizer)")
    parser.add_argument("--s2d-levels", type=int, default=-1,
                        help="Accepted for parity; the port always runs the "
                             "(equivalent) pixel path")
    parser.add_argument("--kernels", type=str, default=None,
                        choices=["torch", "cuda"],
                        help="Kernel policy: cuda trains and evaluates "
                             "through the loss-statistics kernels and runs "
                             "milesial's BatchNorm + ReLU through the "
                             "epilogue kernels; torch runs plain PyTorch. "
                             "Default: cuda on a card, torch on the CPU")
    parser.add_argument("--device", type=str, default=None,
                        choices=["cuda", "cpu"],
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--grad-accum", type=int, default=1,
                        help="Accumulate K batches into one optimizer step "
                             "(exact for the log-Dice loss)")
    parser.add_argument("--num-workers", type=int, default=4,
                        help="Host-side decode threads")
    parser.add_argument("--prefetch-batches", type=int, default=2,
                        help="Batches copied to the card ahead of the step "
                             "(0 = inline)")
    parser.add_argument("--host-cache-mb", type=int, default=1024,
                        help="Host RAM budget (MiB) of the decoded-sample "
                             "cache shared by the train and val loaders "
                             "(0 = off)")
    parser.add_argument("--checkpoint-dir", type=str,
                        default="./checkpoints",
                        help="Where checkpoints and final weights go")
    # run control
    parser.add_argument("--remat", action="store_true",
                        help="Recompute the forward in the backward "
                             "(activation memory for about one more "
                             "forward per step)")
    parser.add_argument("--steps-per-dispatch", type=int, default=1,
                        help="Optimizer steps per dispatch: one CUDA graph "
                             "of K steps on the card, across every card of "
                             "the step, under every -t (DDP and DDP_MP over "
                             "NCCL); K plain steps on the CPU; refused under "
                             "gloo on a card")
    parser.add_argument("--nonfinite-policy", type=str, default="abort",
                        choices=["abort", "rollback", "skip"],
                        help="On a non-finite train loss: abort (raise), "
                             "rollback (reload the newest intact "
                             "checkpoint, bounded by --rollback-retries), "
                             "or skip (discard that step's update; reads "
                             "every step's loss)")
    parser.add_argument("--rollback-retries", type=int, default=2,
                        help="Rollback budget of --nonfinite-policy "
                             "rollback before aborting")
    parser.add_argument("--save-best", action="store_true",
                        help="Keep a separate <method>_best.pt at the "
                             "highest validation Dice")
    parser.add_argument("--early-stop", type=int, default=0, metavar="N",
                        help="Stop when val loss has not improved for N "
                             "consecutive epochs (0 = off)")
    parser.add_argument("--keep-checkpoints", type=int, default=2,
                        help="Retain the newest N checkpoint files per "
                             "path; restore hash-verifies and falls back "
                             "to the newest intact one")
    parser.add_argument("--sync-checkpoint", action="store_true",
                        help="Write checkpoints synchronously instead of on "
                             "the background writer thread")
    parser.add_argument("--trace-timeline", type=str, default=None,
                        metavar="PATH",
                        help="Append per-phase step-timeline spans "
                             "(decode/stack/h2d/dispatch/readback) to this "
                             "JSONL file (rank R of a multi-process run "
                             "writes PATH.rankR); read it with "
                             "utils.trace.summarize_timeline")
    parser.add_argument("--export-pth", action="store_true",
                        help="Accepted for parity: the port writes "
                             "<method>.pth at the end of every run")
    return parser.parse_args(argv)


def to_config(args):
    """argparse namespace → :class:`TrainConfig`."""
    from distributedpytorch_tpu_torch.config import TrainConfig

    return TrainConfig(
        train_method=args.train_method,
        epochs=args.epochs,
        learning_rate=args.lr,
        batch_size=args.batch_size,
        val_percent=args.val,
        seed=args.seed,
        data_dir=args.data_dir,
        image_size=tuple(args.image_size),
        num_workers=args.num_workers,
        prefetch_batches=args.prefetch_batches,
        grad_accum=args.grad_accum,
        num_microbatches=args.microbatches,
        num_stages=args.stages,
        pipeline_cuts=(tuple(args.pipeline_cuts) if args.pipeline_cuts
                       else None),
        pipeline_schedule=args.pipeline_schedule,
        model_arch=args.model_arch,
        model_widths=tuple(args.model_widths) if args.model_widths else None,
        wgrad_taps=args.wgrad_taps,
        s2d_levels=args.s2d_levels,
        dtype=args.dtype,
        kernels=args.kernels,
        device=args.device,
        checkpoint_name=args.checkpoint or args.load or None,
        synthetic_samples=args.synthetic,
        checkpoint_dir=args.checkpoint_dir,
        host_cache_mb=args.host_cache_mb,
        remat=args.remat,
        steps_per_dispatch=args.steps_per_dispatch,
        nonfinite_policy=args.nonfinite_policy,
        rollback_retries=args.rollback_retries,
        save_best=args.save_best,
        early_stop_patience=args.early_stop,
        keep_checkpoints=args.keep_checkpoints,
        async_checkpoint=not args.sync_checkpoint,
        timeline_path=args.trace_timeline,
    )


def start_runtime(args):
    """This process's place in the run, before anything else (reference
    train.py:58): ``-t DDP`` and ``-t DDP_MP`` join the process group from
    torchrun's env (world 1 without one; a DDP_MP rank on the first of its
    ``--stages`` cards); every other method is one process (DP and MP over
    the devices their strategy lists)."""
    from distributedpytorch_tpu_torch.dist import runtime
    from distributedpytorch_tpu_torch.utils.device import resolve_device

    if args.train_method == "DDP":
        return runtime.initialize_from_env(args.device)
    if args.train_method == "DDP_MP":
        return runtime.initialize_from_env(args.device, args.stages)
    return runtime.RuntimeInfo(0, 1, device=resolve_device(args.device))


def build_trainer(args, info=None, devices=None):
    """args → a :class:`Trainer` ready to ``train()``; ``info`` is
    ``start_runtime``'s, ``devices`` the device list of ``-t DP``/``MP``
    or of this ``DDP_MP`` rank (default: the visible cards, a DDP_MP
    rank's own S)."""
    from distributedpytorch_tpu_torch.parallel.strategy import build_strategy
    from distributedpytorch_tpu_torch.train.loop import Trainer

    config = to_config(args)
    return Trainer(config, strategy=build_strategy(config, info, devices))


def configure_logging(config, to_stderr: bool = True
                      ) -> List[logging.Handler]:
    """The reference's logfile, ``<log_dir>/<method>.log`` appended
    message-only, plus stderr when ``to_stderr`` (rank 0 under DDP and
    DDP_MP);
    returns the handlers it added to the root logger."""
    os.makedirs(config.log_dir, exist_ok=True)
    handlers: List[logging.Handler] = [
        logging.FileHandler(
            os.path.join(config.log_dir, f"{config.train_method}.log"),
            mode="a"),
    ]
    if to_stderr:
        handlers.append(logging.StreamHandler(sys.stderr))
    root = logging.getLogger()
    for handler in handlers:
        handler.setFormatter(logging.Formatter("%(message)s"))
        root.addHandler(handler)
    root.setLevel(logging.INFO)
    return handlers


def main(argv=None) -> int:
    from distributedpytorch_tpu_torch.dist.runtime import shutdown
    from distributedpytorch_tpu_torch.parallel.strategy import (
        STRATEGIES,
        check_run_control,
        unported_method_message,
    )
    from distributedpytorch_tpu_torch.train.loop import check_config

    args = get_args(argv)
    if args.train_method not in STRATEGIES:
        raise SystemExit(unported_method_message(args.train_method))
    try:
        # the refusals, before any process group is joined
        check_config(to_config(args))
        check_run_control(to_config(args))
    except ValueError as exc:
        raise SystemExit(str(exc)) from None
    try:
        info = start_runtime(args)
    except RuntimeError as exc:
        raise SystemExit(str(exc)) from None
    try:
        configure_logging(to_config(args), to_stderr=info.is_main)
        logging.info("UNet for Carvana Image Masking (Segmentation)")
        result = build_trainer(args, info).train()
        logging.info("Done: %s", result)
    finally:
        shutdown()
    return 0
