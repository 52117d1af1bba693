"""Shared inference pieces: preprocess → forward → postprocess.

Counterpart of ``distributedpytorch_tpu/serve/infer.py``, shared by the
serve engine and the offline ``predict``. Module scope imports numpy and
torch only; PIL loads inside the functions that decode.
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
    the CPU, or its int8 twin with ``quantized``: ops/quant.py), the
    config that sized it, and the input geometry."""

    model: torch.nn.Module
    config: object
    input_hw: Tuple[int, int]  # (H, W) — note: CLI flags order (W, H)
    quantized: bool = False


#: What a bare checkpoint name resolves to for inference, in order: a JAX
#: ``.ckpt`` (its weights, ``checkpoint.payload_from_jax``), a reference
#: ``.pth``, the port's own ``.pt``.
INFERENCE_EXTS = (".ckpt", ".pth", ".pt")


def load_inference_bundle(
    checkpoint: str,
    checkpoint_dir: str = "./checkpoints",
    image_size: Sequence[int] = (960, 640),
    model_arch: str = "unet",
    model_widths: Optional[Sequence[int]] = None,
    s2d_levels: int = -1,
    dtype: str = "bf16",
    quantize: Optional[str] = None,
) -> InferenceBundle:
    """Resolve a checkpoint name/path and build the model with its weights
    for inference, on the CPU: a reference-format ``.pth``, the port's
    native ``.pt`` (its ``model`` state dict), a JAX ``.ckpt`` (its
    params and running statistics), or an int8 weights file, the port's
    or the JAX package's (ops/quant.py), which one read of the file tells
    apart.

    ``quantize="int8"`` serves weights-only int8: an int8 file loads as
    it is, a float checkpoint is quantized on load. An int8 file is also
    detected when ``quantize`` is unset, with a warning, since the
    serving numerics change."""
    from distributedpytorch_tpu_torch.checkpoint import (
        read_payload,
        resolve_checkpoint,
    )
    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.models import create_model
    from distributedpytorch_tpu_torch.ops import quant

    if quantize not in (None, "int8"):
        raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
    path = resolve_checkpoint(checkpoint, checkpoint_dir,
                              exts=INFERENCE_EXTS)
    w, h = int(image_size[0]), int(image_size[1])
    cfg = TrainConfig(
        model_arch=model_arch,
        model_widths=tuple(model_widths) if model_widths else None,
        s2d_levels=s2d_levels,
        dtype=dtype,
    )
    # one read of the file decides its kind and feeds the loader
    payload = None
    if not path.endswith(".pth"):
        payload = read_payload(path)
    if isinstance(payload, dict) and payload.get("kind") == quant.QUANT_KIND:
        if quantize is None:
            logger.warning(
                "%s is an int8 weights file — serving quantized (pass "
                "--quantize int8 to make this explicit)", path,
            )
        params, model_state, manifest = quant.load_quantized(
            path, payload=payload)
        _check_quantized_identity(manifest, model_arch, model_widths, path)
        model = quant.load_quantized_model(create_model(cfg), params,
                                           model_state)
        return InferenceBundle(model=model.eval(), config=cfg,
                               input_hw=(h, w), quantized=True)
    model = create_model(cfg)
    model.load_state_dict(_float_weights(path, payload))
    if quantize == "int8":
        logger.info(
            "quantizing %s to int8 weights on load (per-out-channel "
            "symmetric); persist with `python -m "
            "distributedpytorch_tpu_torch quantize` to skip this at every "
            "startup", path,
        )
        model = quant.quantize_model(model)
    return InferenceBundle(model=model.eval(), config=cfg, input_hw=(h, w),
                           quantized=quantize == "int8")


def _float_weights(path: str, payload) -> dict:
    """The float state dict of a ``.pth`` (``payload`` None), of a JAX
    ``.ckpt``'s payload or of a native checkpoint's, floating tensors
    promoted to float32 with a warning where they are not (a checkpoint
    trained under ``--dtype bf16_params`` stores bf16 weights), as the
    JAX ``ensure_restored_dtypes`` does for inference."""
    from distributedpytorch_tpu_torch.checkpoint import (
        NATIVE_FORMAT,
        is_jax_payload,
        load_pth,
        payload_from_jax,
        strip_module_prefix,
    )

    if payload is None:
        state = load_pth(path)
    elif is_jax_payload(payload):
        state = payload_from_jax(payload, where=path)["model"]
    else:
        fmt = (payload.get("manifest") or {}).get("format") \
            if isinstance(payload, dict) else None
        if fmt != NATIVE_FORMAT:
            raise ValueError(
                f"{path} is neither a native checkpoint of the port nor an "
                f"int8 weights file (format {fmt!r})")
        state = strip_module_prefix(payload["model"])
    drifted = sorted({str(v.dtype) for v in state.values()
                      if v.is_floating_point() and v.dtype != torch.float32})
    if drifted:
        logger.warning(
            "inference %s: restored float tensors with dtype(s) %s — "
            "re-cast to float32 for serving (a checkpoint saved under a "
            "different --dtype)", path, drifted,
        )
        state = {k: (v.to(torch.float32) if v.is_floating_point() else v)
                 for k, v in state.items()}
    return state


def _check_quantized_identity(manifest, model_arch, model_widths, path):
    """An int8 file's manifest records the model identity its ints were
    produced for; a mismatched ``--model`` or ``--model-widths`` raises
    here with the JAX package's message, not as a shape error later."""
    saved_arch = manifest.get("model_arch")
    if saved_arch is not None and saved_arch != model_arch:
        raise ValueError(
            f"{path} was quantized from a {saved_arch!r} checkpoint but "
            f"--model is {model_arch!r} — pass the architecture the "
            f"manifest records"
        )
    saved_widths = manifest.get("model_widths")
    got_widths = list(model_widths) if model_widths else None
    if saved_widths is not None and list(saved_widths or []) != (
        got_widths or []
    ):
        raise ValueError(
            f"{path} was quantized for model_widths={saved_widths} but "
            f"--model-widths is {got_widths} — pass the widths the "
            f"manifest records"
        )
