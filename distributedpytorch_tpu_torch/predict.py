"""Offline inference: masks for a directory of images from a trained
checkpoint.

Counterpart of ``distributedpytorch_tpu/predict.py`` (``dpt-predict``).
Images stream batch by batch (memory stays O(batch), the last batch may
be ragged), through the forward the serve engine runs
(``serve/infer.make_forward``) at its dtype, and each mask is thresholded
on the host (``postprocess_mask``) and written as a ``{0, 255}`` PNG.
The checkpoint loads through ``serve/infer.load_inference_bundle``, so an
int8 weights file (ops/quant.py) is detected and predicted from as it is.
The forward runs on the card unless ``--device cpu`` asks for the CPU.

    python -m distributedpytorch_tpu_torch predict -c singleGPU \\
        -i ./data/test_hq -o ./predictions
"""

from __future__ import annotations

import argparse
import collections
import logging
import os
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distributedpytorch_tpu_torch.serve.infer import (
    load_inference_bundle,
    make_forward,
    postprocess_mask,
    preprocess_image,
)
from distributedpytorch_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".gif")


def predict_batches(
    model: torch.nn.Module,
    images: Iterable[np.ndarray],
    batch_size: int = 4,
    device=None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Stream ``(probs (b, H, W), inputs (b, H, W, 3))`` over an iterable
    of ``(H, W, 3)`` float32 rows, ``batch_size`` rows at a time and a
    ragged last batch; ``model`` is in eval mode on ``device``."""
    device = resolve_device(device)
    forward = make_forward(model)
    buf: List[np.ndarray] = []

    def flush(rows):
        batch = np.stack(rows)
        probs = forward(torch.from_numpy(batch).to(device))
        return probs.cpu().numpy(), batch

    for arr in images:
        buf.append(arr)
        if len(buf) == batch_size:
            yield flush(buf)
            buf = []
    if buf:
        yield flush(buf)


def list_images(input_dir: str) -> List[str]:
    """The image files of ``input_dir``, sorted; raises when there are
    none."""
    files = sorted(
        f for f in os.listdir(input_dir)
        if not f.startswith(".")
        and os.path.splitext(f)[1].lower() in IMAGE_EXTS
    )
    if not files:
        raise RuntimeError(f"No input images found in {input_dir}")
    return files


def output_stems(files: Sequence[str]) -> List[str]:
    """The output stem of each input: its stem, or for inputs that differ
    only by extension (``car1.jpg`` and ``car1.png``) the stem and the
    extension, so their masks do not overwrite each other."""
    stems = [os.path.splitext(f)[0] for f in files]
    counts = collections.Counter(stems)
    return [
        stem if counts[stem] == 1
        else f"{stem}_{os.path.splitext(f)[1].lstrip('.')}"
        for f, stem in zip(files, stems)
    ]


def run_prediction(
    checkpoint: str,
    input_dir: str,
    output_dir: str,
    image_size: Sequence[int] = (960, 640),
    batch_size: int = 4,
    threshold: float = 0.5,
    save_viz: bool = False,
    checkpoint_dir: str = "./checkpoints",
    model_widths: Optional[Sequence[int]] = None,
    model_arch: str = "unet",
    s2d_levels: int = -1,
    device=None,
) -> List[str]:
    """Predict a mask for every image in ``input_dir``; returns the
    written paths. ``model_arch`` and ``model_widths`` must match the
    checkpoint. The forward computes in the serve engine's bf16."""
    from distributedpytorch_tpu_torch.data.dataset import BasicDataset

    device = resolve_device(device)
    bundle = load_inference_bundle(
        checkpoint, checkpoint_dir=checkpoint_dir, image_size=image_size,
        model_arch=model_arch, model_widths=model_widths,
        s2d_levels=s2d_levels, dtype="bf16",
    )
    w, h = int(image_size[0]), int(image_size[1])
    files = list_images(input_dir)
    stems = output_stems(files)
    os.makedirs(output_dir, exist_ok=True)

    def load_stream() -> Iterator[np.ndarray]:
        for f in files:
            yield preprocess_image(
                BasicDataset.load(os.path.join(input_dir, f)), (w, h))

    from PIL import Image

    model = bundle.model.to(device)
    written: List[str] = []
    for probs, inputs in predict_batches(model, load_stream(), batch_size,
                                         device=device):
        for prob, inp in zip(probs, inputs):
            stem = stems[len(written)]
            mask = postprocess_mask(prob, threshold)
            out_path = os.path.join(output_dir, f"{stem}_mask.png")
            Image.fromarray(mask).save(out_path)
            written.append(out_path)
            if save_viz:
                from distributedpytorch_tpu_torch.utils.plotting import (
                    plot_img_and_mask,
                )

                plot_img_and_mask(
                    inp, mask,
                    out_path=os.path.join(output_dir, f"{stem}_viz.png"))
    logger.info("Wrote %d masks to %s", len(written), output_dir)
    return written


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m distributedpytorch_tpu_torch predict",
        description="Predict masks from input images")
    parser.add_argument("--checkpoint", "-c", required=True,
                        help="Checkpoint name (e.g. singleGPU) or path: a "
                             ".pth, the port's .pt or an int8 weights file")
    parser.add_argument("--input", "-i", required=True,
                        help="Directory of images")
    parser.add_argument("--output", "-o", default="./predictions",
                        help="Output directory for predicted masks")
    parser.add_argument("--image-size", type=int, nargs=2,
                        default=(960, 640), metavar=("W", "H"))
    parser.add_argument("--batch-size", "-b", type=int, default=4)
    parser.add_argument("--threshold", "-t", type=float, default=0.5)
    parser.add_argument("--viz", action="store_true",
                        help="Also save image+mask side-by-side panels "
                             "(needs matplotlib)")
    parser.add_argument("--checkpoint-dir", default="./checkpoints")
    parser.add_argument("--model-widths", type=int, nargs="+", default=None,
                        help="Encoder widths if the checkpoint was trained "
                             "with non-default TrainConfig.model_widths")
    parser.add_argument("--model", dest="model_arch", type=str,
                        default="unet", choices=["unet", "milesial"],
                        help="Model family the checkpoint was trained with")
    parser.add_argument("--s2d-levels", type=int, default=-1,
                        help="Accepted for parity; the port always runs the "
                             "(equivalent) pixel path")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    run_prediction(
        args.checkpoint, args.input, args.output,
        image_size=args.image_size, batch_size=args.batch_size,
        threshold=args.threshold, save_viz=args.viz,
        checkpoint_dir=args.checkpoint_dir, model_widths=args.model_widths,
        model_arch=args.model_arch, s2d_levels=args.s2d_levels,
        device=args.device,
    )
    return 0
