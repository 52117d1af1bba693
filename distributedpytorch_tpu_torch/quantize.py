"""Convert a trained checkpoint to weights-only int8 for serving.

Counterpart of ``tools/quantize.py`` (ops/quant.py has the scheme:
per-output-channel symmetric scales, convolution weights only; biases and
BatchNorm statistics stay float32). Quantizing once here instead of at
every server start saves the conversion and records provenance: the
output's manifest holds the source checkpoint's path and SHA-256. The
file ends in the checkpoints' SHA-256 footer, so a torn copy is refused
at load. The quantization runs on the card unless ``--device cpu`` asks
for the CPU; the result is the same bit for bit.

    python -m distributedpytorch_tpu_torch quantize -c singleGPU \\
        -o checkpoints/singleGPU.int8.pt
    python -m distributedpytorch_tpu_torch serve \\
        -c checkpoints/singleGPU.int8.pt --quantize int8

The model-identity flags must match the trained checkpoint, as predict's
and serve's do: all three load through ``serve/infer.py``.
"""

from __future__ import annotations

import argparse
import logging
import os

logger = logging.getLogger(__name__)


def get_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m distributedpytorch_tpu_torch quantize",
        description="Quantize a checkpoint to weights-only int8 "
                    "(per-out-channel symmetric) for serving")
    ap.add_argument("--checkpoint", "-c", required=True,
                    help="Source checkpoint name (e.g. singleGPU) or path "
                         "(.pth/.pt)")
    ap.add_argument("--checkpoint-dir", default="./checkpoints")
    ap.add_argument("--out", "-o", default=None,
                    help="Output path (default: <source>.int8.pt)")
    ap.add_argument("--image-size", type=int, nargs=2, default=(960, 640),
                    metavar=("W", "H"),
                    help="Geometry of the model (must match training, like "
                         "predict's)")
    ap.add_argument("--model", dest="model_arch", default="unet",
                    choices=["unet", "milesial"])
    ap.add_argument("--model-widths", type=int, nargs="+", default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def default_output(src: str) -> str:
    """``x.pt`` → ``x.int8.pt``; another source → ``<source>.int8.pt``."""
    if src.endswith(".pt"):
        return src[: -len(".pt")] + ".int8.pt"
    return src + ".int8.pt"


def main(argv=None) -> int:
    from distributedpytorch_tpu_torch.checkpoint import resolve_checkpoint
    from distributedpytorch_tpu_torch.ops import quant
    from distributedpytorch_tpu_torch.serve.infer import (
        INFERENCE_EXTS,
        load_inference_bundle,
    )
    from distributedpytorch_tpu_torch.utils.device import resolve_device

    args = get_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    device = resolve_device(args.device)
    src = resolve_checkpoint(args.checkpoint, args.checkpoint_dir,
                             exts=INFERENCE_EXTS)
    if quant.peek_quantized(src) is not None:
        logger.error("%s is already an int8 weights file", src)
        return 2
    w, h = args.image_size
    bundle = load_inference_bundle(
        src, image_size=(w, h), model_arch=args.model_arch,
        model_widths=args.model_widths, s2d_levels=0,
    )
    model = bundle.model.to(device)
    qmodel = quant.quantize_model(model)
    err = quant.quantization_error(model, qmodel)
    out = args.out or default_output(src)
    manifest = {
        "source": os.path.abspath(src),
        "source_sha256": quant.file_sha256(src),
        "model_arch": args.model_arch,
        "model_widths": list(args.model_widths) if args.model_widths
        else None,
        "image_size": [int(w), int(h)],
    }
    quant.save_quantized(out, qmodel.cpu(), manifest)
    f32_bytes = quant.weight_bytes(model)
    int8_bytes = quant.weight_bytes(qmodel)
    logger.info(
        "wrote %s: %d -> %d weight bytes (%.2fx), max rounding error "
        "%.3f scale units (bound 0.5), source sha256 %.12s…",
        out, f32_bytes, int8_bytes, f32_bytes / max(1, int8_bytes), err,
        manifest["source_sha256"],
    )
    return 0
