"""Weights-only int8 quantization for serving.

Counterpart of ``distributedpytorch_tpu/ops/quant.py``. Convolution
weights are stored as int8 with per-OUTPUT-CHANNEL symmetric scales and
dequantized inside the forward, so a replica's resident weights are one
byte per element while every convolution still computes in the model's
compute dtype:

    scale[c] = max(|W[c]|) / 127            (scale 1 for an all-zero c)
    Q[c]     = clip(rint(W[c] / scale[c]), -127, 127), int8
    W'[c]    = (Q[c] · scale[c]) in float32, then cast to the compute dtype

The out-channel axis is 0 for a ``Conv2d`` weight ``(O, I, kh, kw)`` and
1 for a ``ConvTranspose2d`` weight ``(I, O, kh, kw)``; flax keeps
out-features last for both, and a rule by ``ndim`` alone would give the
transposed convs per-input-channel scales. Biases, BatchNorm affine and
running statistics stay float32.

:func:`quantize_model` turns a float model into its quantized twin, in
which every convolution of ``models/unet.py`` (``Conv2d``, ``TapsConv2d``,
``ConvTranspose2d``, used by both models) is a :class:`QuantizedConv`
holding an int8 ``q`` and a float32 ``scale`` buffer and no float weight.

File format (``python -m distributedpytorch_tpu_torch quantize`` writes,
:func:`load_quantized` reads): one ``torch.save`` payload through
``checkpoint.write_payload``, with its SHA-256 footer, carrying ``kind`` =
:data:`QUANT_KIND`, a ``manifest`` (``scheme`` and what the converter
records: the source checkpoint's path and SHA-256 and the model's
identity), ``params`` under reference names (each quantized weight as
``{"q", "scale"}``, biases and BatchNorm affine as float32) and
``model_state`` (milesial's running statistics; None for the UNet). Only
tensors, dicts, lists and strings, so ``torch.load(weights_only=True)``
reads it. A JAX ``.int8.ckpt`` (the same kind and manifest, flax msgpack
behind the JAX footer, flax trees) loads too: the checkpoints' reader
decodes it and ``checkpoint.quant_from_jax`` renames and transposes its
``q`` and ``scale``.
"""

from __future__ import annotations

import copy
import hashlib
import logging
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

logger = logging.getLogger(__name__)

QUANT_KIND = "int8-weights-v1"
SCHEME = "symmetric-per-out-channel"

# the hyperparameters a conv's forward reads besides its weight and bias
_CONV_ATTRS = ("in_channels", "out_channels", "kernel_size", "stride",
               "padding", "dilation", "groups", "output_padding",
               "padding_mode", "transposed", "wgrad_cuda", "halo")


def out_channel_axis(conv: nn.Module) -> int:
    """The axis of ``conv.weight`` that indexes output channels."""
    return 1 if isinstance(conv, nn.ConvTranspose2d) else 0


def quantize_weight(w: torch.Tensor, axis: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One float weight → ``(q int8, scale float32)``, the scale keeping
    every dimension (size 1 but on ``axis``), so ``q * scale``
    broadcasts. The same bits on the CPU and on a card."""
    w = w.detach().to(torch.float32)
    dims = tuple(d for d in range(w.ndim) if d != axis)
    amax = w.abs().amax(dim=dims, keepdim=True)
    # a divisor on the card, not a host scalar: CUDA multiplies by the
    # reciprocal of a host scalar, which is not the correctly rounded
    # quotient that numpy and the CPU give
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


class QuantizedConv(nn.Module):
    """A convolution of ``models/unet.py`` with its weight as int8 ``q``
    and a float32 per-out-channel ``scale`` (buffers) and a float32
    ``bias``. It runs the float module's own forward, whose
    ``self.weight.to(x.dtype)`` reads :attr:`weight`: the float32
    dequantization, then the cast, as the JAX ``dequantize_tree`` feeds
    flax's ``Conv(dtype=...)``."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.kind = type(conv)
        for name in _CONV_ATTRS:
            if hasattr(conv, name):
                setattr(self, name, getattr(conv, name))
        q, scale = quantize_weight(conv.weight, out_channel_axis(conv))
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.bias = (None if conv.bias is None else nn.Parameter(
            conv.bias.detach().to(torch.float32).clone(),
            requires_grad=False))

    @property
    def weight(self) -> torch.Tensor:
        return self.q.to(torch.float32) * self.scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.kind.forward(self, x)


def quantize_model(model: nn.Module) -> nn.Module:
    """The quantized twin of ``model``, on ``model``'s device: a copy in
    which every ``nn.Conv2d`` and ``nn.ConvTranspose2d`` is a
    :class:`QuantizedConv`. ``model`` is left as it is."""
    twin = copy.deepcopy(model)
    for parent in list(twin.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, (nn.Conv2d, nn.ConvTranspose2d)):
                setattr(parent, name, QuantizedConv(child))
    return twin


def is_quantized_model(model: nn.Module) -> bool:
    return any(isinstance(m, QuantizedConv) for m in model.modules())


def quantization_error(model: nn.Module, qmodel: nn.Module) -> float:
    """max |W − W'| over the quantized convs, in units of each channel's
    scale (≤ 0.5 by construction)."""
    floats = dict(model.named_modules())
    errs = [
        float(((floats[name].weight.detach().float() - m.weight).abs()
               / m.scale).max())
        for name, m in qmodel.named_modules() if isinstance(m, QuantizedConv)
    ]
    return max(errs, default=0.0)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def module_bytes(module: nn.Module) -> int:
    """Bytes of ``module``'s parameters and buffers."""
    return _nbytes(module.parameters()) + _nbytes(module.buffers())


def weight_bytes(module: nn.Module) -> int:
    """Bytes of the weights proper: parameters and a quantized conv's
    ``q`` and ``scale``, running statistics excluded."""
    return _nbytes(module.parameters()) + sum(
        _nbytes((m.q, m.scale)) for m in module.modules()
        if isinstance(m, QuantizedConv))


# ---------------------------------------------------------------------------
# File format
# ---------------------------------------------------------------------------


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def quantized_state(qmodel: nn.Module
                    ) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]]]:
    """``(params, model_state)`` of a quantized twin on the host, under
    reference names: ``<conv>.weight`` → ``{"q", "scale"}``, the other
    parameters as float32, the buffers other than ``q`` and ``scale``
    (running statistics) as ``model_state``, None when there are none."""
    params: Dict[str, Any] = {}
    skip = set()
    for name, m in qmodel.named_modules():
        if isinstance(m, QuantizedConv):
            params[f"{name}.weight"] = {"q": m.q.detach().cpu(),
                                        "scale": m.scale.detach().cpu()}
            skip.update({f"{name}.q", f"{name}.scale"})
    for name, p in qmodel.named_parameters():
        params[name] = p.detach().cpu().to(torch.float32)
    state = {name: b.detach().cpu() for name, b in qmodel.named_buffers()
             if name not in skip}
    return params, (state or None)


def save_quantized(path: str, qmodel: nn.Module,
                   manifest: Dict[str, Any]) -> str:
    """Write a quantized-weights file (atomic, with the checkpoints'
    SHA-256 footer). ``manifest`` should carry ``source`` and
    ``source_sha256``."""
    from distributedpytorch_tpu_torch.checkpoint import write_payload

    params, model_state = quantized_state(qmodel)
    return write_payload(path, {
        "kind": QUANT_KIND,
        "manifest": {"scheme": SCHEME, **manifest},
        "params": params,
        "model_state": model_state,
    })


def peek_quantized(path: str) -> Optional[Dict[str, Any]]:
    """The manifest iff ``path`` is a quantized-weights file, else None
    (a file that does not load included: the caller is probing)."""
    if not os.path.isfile(path):
        return None
    from distributedpytorch_tpu_torch.checkpoint import _read_verified

    try:
        payload = _read_verified(path)
    except Exception:  # noqa: BLE001 — a probe, not a load
        return None
    if not isinstance(payload, dict) or payload.get("kind") != QUANT_KIND:
        return None
    return dict(payload.get("manifest") or {})


def load_quantized(path: str, payload: Optional[Dict[str, Any]] = None
                   ) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]],
                              Dict[str, Any]]:
    """A quantized-weights file → ``(params, model_state, manifest)``,
    its footer verified; raises ValueError on a file of another kind.
    ``payload`` is the file's content when the caller has read it
    already."""
    if payload is None:
        from distributedpytorch_tpu_torch.checkpoint import _read_verified

        payload = _read_verified(path)
    if not isinstance(payload, dict) or payload.get("kind") != QUANT_KIND:
        kind = payload.get("kind") if isinstance(payload, dict) else None
        raise ValueError(
            f"{path} is not an int8 weights file (kind={kind!r}); quantize "
            f"it first with `python -m distributedpytorch_tpu_torch "
            f"quantize` or drop --quantize"
        )
    manifest = dict(payload.get("manifest") or {})
    logger.info(
        "loaded int8 weights %s (source %s, sha256 %.12s…)",
        path, manifest.get("source"), manifest.get("source_sha256", ""),
    )
    params, model_state = payload["params"], payload.get("model_state")
    if not any("." in name for name in params):
        # the JAX package's file: flax trees, flax layouts
        from distributedpytorch_tpu_torch.checkpoint import quant_from_jax

        params, model_state = quant_from_jax(params, model_state)
    return params, model_state, manifest


def load_quantized_model(model: nn.Module, params: Dict[str, Any],
                         model_state: Optional[Dict[str, Any]]
                         ) -> nn.Module:
    """The quantized twin of the float ``model``'s architecture holding
    ``params`` and ``model_state`` as :func:`quantized_state` gives
    them (strict: every name must match)."""
    twin = quantize_model(model)
    state: Dict[str, torch.Tensor] = {}
    for name, value in params.items():
        if isinstance(value, dict):
            stem = name[: -len(".weight")]
            state[f"{stem}.q"] = value["q"]
            state[f"{stem}.scale"] = value["scale"]
        else:
            state[name] = value
    state.update(model_state or {})
    twin.load_state_dict(state)
    return twin
