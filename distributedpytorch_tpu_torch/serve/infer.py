"""Shared inference pieces: preprocess → forward → postprocess.

Counterpart of ``distributedpytorch_tpu/serve/infer.py`` for float
weights. Module scope imports numpy and torch only; PIL loads inside the
functions that decode.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)


def preprocess_image(pil_img, size_wh: Sequence[int]) -> np.ndarray:
    """One decoded PIL image → the model's input row: forced RGB, BICUBIC
    resize to ``(W, H)``, /255, NHWC float32 — the training-side
    preprocess exactly."""
    from distributedpytorch_tpu_torch.data.dataset import BasicDataset

    return BasicDataset.preprocess(pil_img.convert("RGB"), size_wh,
                                   is_mask=False)


def load_image(path: str, size_wh: Sequence[int]) -> np.ndarray:
    """Decode + preprocess one image file."""
    from distributedpytorch_tpu_torch.data.dataset import BasicDataset

    return preprocess_image(BasicDataset.load(path), size_wh)


def make_forward(model: torch.nn.Module,
                 mask_threshold: Optional[float] = None) -> Callable:
    """The eval forward ``fwd(x) -> out`` on ``x (B, H, W, 3) float32``
    (on the model's device): ``(B, H, W)`` float32 sigmoid probabilities,
    or with ``mask_threshold`` the served ``{0, 255} uint8`` masks from
    the serve-mask kernel (ops/kernels.py) — bit-identical to
    ``postprocess_mask`` of the probabilities at that threshold. Runs
    under ``torch.inference_mode()``, which is per thread, so it is set
    here and not by the caller."""

    def fwd(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            probs = model(x)[..., 0].contiguous()
            if mask_threshold is not None:
                from distributedpytorch_tpu_torch.ops.kernels import (
                    sigmoid_threshold_mask,
                )

                return sigmoid_threshold_mask(probs, mask_threshold)
            return probs

    return fwd


def postprocess_mask(probs: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """Probabilities → ``{0, 255} uint8`` masks, same shape. A ``uint8``
    input is the mask already (thresholded on the card) and passes
    through untouched."""
    arr = np.asarray(probs)
    if arr.dtype == np.uint8:
        return arr
    return (arr >= threshold).astype(np.uint8) * 255


@dataclasses.dataclass
class InferenceBundle:
    """What one checkpoint needs to serve: the model (float32 weights on
    the CPU), the config that sized it, and the input geometry."""

    model: torch.nn.Module
    config: object
    input_hw: Tuple[int, int]  # (H, W) — note: CLI flags order (W, H)


def load_inference_bundle(
    checkpoint: str,
    checkpoint_dir: str = "./checkpoints",
    image_size: Sequence[int] = (960, 640),
    model_arch: str = "unet",
    model_widths: Optional[Sequence[int]] = None,
    s2d_levels: int = -1,
    dtype: str = "bf16",
) -> InferenceBundle:
    """Resolve a checkpoint name/path and build the model with its weights
    for inference (float weights, reference-format ``.pth``)."""
    from distributedpytorch_tpu_torch.checkpoint import (
        load_pth,
        resolve_checkpoint,
    )
    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.models import create_model

    path = resolve_checkpoint(checkpoint, checkpoint_dir)
    w, h = int(image_size[0]), int(image_size[1])
    cfg = TrainConfig(
        model_arch=model_arch,
        model_widths=tuple(model_widths) if model_widths else None,
        s2d_levels=s2d_levels,
        dtype=dtype,
    )
    model = create_model(cfg)
    model.load_state_dict(load_pth(path))
    return InferenceBundle(model=model.eval(), config=cfg, input_hw=(h, w))
