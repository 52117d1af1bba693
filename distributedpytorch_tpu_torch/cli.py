"""Train the UNet on images and target masks — ``python -m
distributedpytorch_tpu_torch [-t singleGPU] ...``.

Counterpart of ``distributedpytorch_tpu/cli.py`` for the flags the port
implements: the reference's ``-t -v -l -e --lr -b -c -s`` and
``--data-dir --synthetic --image-size --model-widths --dtype --kernels
--device --grad-accum --num-workers --prefetch-batches --checkpoint-dir``.
``--s2d-levels`` is accepted and has no effect (the port runs the pixel
path). A flag the port does not implement is not defined, so argparse
rejects it. The run writes ``./logs/<method>.log`` (message-only),
``./loss/<method>/``, ``<checkpoint-dir>/<method>.pt`` (resume with
``-c <method>``) and ``<checkpoint-dir>/<method>.pth`` (serve with
``python -m distributedpytorch_tpu_torch serve -c <method>``).

It runs on the card unless ``--device cpu`` asks for the CPU:
    python -m distributedpytorch_tpu_torch -t singleGPU --synthetic 40
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
                        help="Training method; the port runs singleGPU "
                             "(DP, DDP, MP: ROADMAP.md)")
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
                        help="Batch size")
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
    parser.add_argument("--model-widths", type=int, nargs="+", default=None,
                        help="Encoder channel widths (default 32 64 128 256)")
    parser.add_argument("--dtype", type=str, default="bf16",
                        choices=["f32", "bf16"],
                        help="Precision policy: bf16 conv compute with f32 "
                             "params and loss (default), or f32")
    parser.add_argument("--s2d-levels", type=int, default=-1,
                        help="Accepted for parity; the port always runs the "
                             "(equivalent) pixel path")
    parser.add_argument("--kernels", type=str, default=None,
                        choices=["torch", "cuda"],
                        help="Kernel policy: cuda trains and evaluates "
                             "through the loss-statistics kernels; torch "
                             "runs plain PyTorch. Default: cuda on a card, "
                             "torch on the CPU")
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
    parser.add_argument("--checkpoint-dir", type=str,
                        default="./checkpoints",
                        help="Where checkpoints and final weights go")
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
        model_widths=tuple(args.model_widths) if args.model_widths else None,
        s2d_levels=args.s2d_levels,
        dtype=args.dtype,
        kernels=args.kernels,
        device=args.device,
        checkpoint_name=args.checkpoint or args.load or None,
        synthetic_samples=args.synthetic,
        checkpoint_dir=args.checkpoint_dir,
    )


def build_trainer(args):
    """args → a :class:`Trainer` ready to ``train()``."""
    from distributedpytorch_tpu_torch.train.loop import Trainer

    return Trainer(to_config(args))


def configure_logging(config) -> List[logging.Handler]:
    """The reference's logfile, ``<log_dir>/<method>.log`` appended
    message-only, plus stderr; returns the handlers it added to the root
    logger."""
    os.makedirs(config.log_dir, exist_ok=True)
    handlers: List[logging.Handler] = [
        logging.FileHandler(
            os.path.join(config.log_dir, f"{config.train_method}.log"),
            mode="a"),
        logging.StreamHandler(sys.stderr),
    ]
    root = logging.getLogger()
    for handler in handlers:
        handler.setFormatter(logging.Formatter("%(message)s"))
        root.addHandler(handler)
    root.setLevel(logging.INFO)
    return handlers


def main(argv=None) -> int:
    from distributedpytorch_tpu_torch.train.loop import (
        PORTED_METHODS,
        unported_method_message,
    )
    from distributedpytorch_tpu_torch.utils.device import resolve_device

    args = get_args(argv)
    if args.train_method not in PORTED_METHODS:
        raise SystemExit(unported_method_message(args.train_method))
    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(str(exc)) from None
    configure_logging(to_config(args))
    logging.info("UNet for Carvana Image Masking (Segmentation)")
    result = build_trainer(args).train()
    logging.info("Done: %s", result)
    return 0
