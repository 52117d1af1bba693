"""Hand-written kernels of the port, with their plain PyTorch versions, and
the kernel policy that engages them.

Each wrapper takes the plain version for a tensor on the CPU (the tests
run there) and launches its CUDA kernel for a tensor on the card — it
never falls back from one to the other. ``LAUNCHES`` counts kernel
launches by name, so a run can show its main path went through them.

Counterpart of ``distributedpytorch_tpu/ops/kernels.py``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct
from typing import Dict, Optional

import torch

from distributedpytorch_tpu_torch.ops.precision import LOSS_DTYPE

#: Kernel launches by kernel name since the last reset. Only launches of
#: the CUDA kernel count — a CPU tensor's plain-version call does not.
LAUNCHES: Dict[str, int] = {"serve_mask": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# The policy object
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """Which hand-written kernels the serve path engages.

    ``torch`` is the counterpart of the JAX package's ``xla``: the engine
    returns float32 probabilities and thresholds them on the host.
    ``cuda`` is the counterpart of ``pallas``: the serve forward ends in
    the serve-mask kernel and returns uint8 masks."""

    name: str
    serve_mask: bool


KERNEL_POLICIES: Dict[str, KernelPolicy] = {
    "torch": KernelPolicy("torch", serve_mask=False),
    "cuda": KernelPolicy("cuda", serve_mask=True),
}


def get_kernel_policy(name=None, device: Optional[torch.device] = None
                      ) -> KernelPolicy:
    """A policy by name, or an already-resolved one. ``None`` resolves to
    ``cuda`` on a CUDA device and to ``torch`` elsewhere."""
    if isinstance(name, KernelPolicy):
        return name
    if name is None:
        cuda = device is not None and torch.device(device).type == "cuda"
        name = "cuda" if cuda else "torch"
    try:
        return KERNEL_POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown kernel policy {name!r} (expected one of "
            f"{sorted(KERNEL_POLICIES)})"
        ) from None


# ---------------------------------------------------------------------------
# Serve mask: probabilities (or logits) -> {0, 255} uint8
# ---------------------------------------------------------------------------


def sigmoid_threshold_mask_reference(
    x: torch.Tensor, threshold: float, from_logits: bool = False
) -> torch.Tensor:
    """The plain version: ``255`` where ``x >= threshold`` (after a
    float32 sigmoid with ``from_logits``), else ``0``, as uint8 of the
    same shape. The comparison is float32 against the float32-rounded
    threshold, as in the JAX package's kernel."""
    v = x.to(LOSS_DTYPE)
    if from_logits:
        v = torch.sigmoid(v)
    return torch.where(v >= float(threshold), 255, 0).to(torch.uint8)


def _serve_mask_lib():
    from distributedpytorch_tpu_torch.ops import _build

    lib = _build.load("serve_mask")
    fn = lib.dpt_serve_mask
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _float_bits(value: float) -> int:
    """The float32 rounding of ``value`` as a signed 32-bit int."""
    return struct.unpack("<i", struct.pack("<f", value))[0]


def sigmoid_threshold_mask(
    x: torch.Tensor, threshold: float, from_logits: bool = False
) -> torch.Tensor:
    """Probabilities (or logits) -> the served ``{0, 255}`` uint8 mask in
    one pass, same shape out.

    On a CUDA tensor this launches the kernel of ``csrc/serve_mask.cu``
    (built at first use) on the current stream; ``x`` must be a
    contiguous float32 tensor. On a CPU tensor it returns the plain
    version. Masks of probabilities are bit-identical between the two;
    with ``from_logits`` the kernel's ``__expf`` sigmoid may differ from
    ``torch.sigmoid`` by a few ulp, which moves a mask pixel only where
    the sigmoid lies within ~1e-6 of the threshold."""
    if x.device.type == "cpu":
        return sigmoid_threshold_mask_reference(x, threshold, from_logits)
    if x.device.type != "cuda":
        raise ValueError(f"serve mask: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"serve mask: expected float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("serve mask: input must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("serve mask: input must be 16-byte aligned")
    n = x.numel()
    if n >= 2**31:
        raise ValueError(f"serve mask: {n} elements exceed the int32 range")
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    fn = _serve_mask_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), n, _float_bits(threshold),
                 int(bool(from_logits)), stream)
    if err != 0:
        raise RuntimeError(f"serve mask kernel launch failed: CUDA error {err}")
    LAUNCHES["serve_mask"] += 1
    return out
