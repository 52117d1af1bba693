"""The 3×3 conv weight gradient as nine tap contractions (K5), with its
plain PyTorch version.

Counterpart of ``distributedpytorch_tpu/ops/wgrad_pallas.py``
(``wgrad_9tap_pallas``, the Pallas ``_wgrad_kernel``). For a SAME,
stride-1 3×3 conv with NHWC input ``x`` (B, H, W, Cin) and output
gradient ``dy`` (B, H, W, Cout)::

    dW[ky, kx, ci, co] = Σ_{b,y,x} Xpad[b, y+ky, x+kx, ci] · dY[b, y, x, co]

in float32, shape (3, 3, Cin, Cout). The kernel lives in
``csrc/wgrad_9tap.cu`` and builds at first use. ``ops/conv_backward.py``
decides where it engages.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from distributedpytorch_tpu_torch.ops.kernels import LAUNCHES
from distributedpytorch_tpu_torch.ops.precision import WGRAD_DTYPE


def wgrad_9tap_reference(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The plain version: nine shifted-view contractions of the padded
    input against ``dy`` (``conv_backward._wgrad_einsum`` of the JAX
    package), in ``WGRAD_DTYPE``. A bfloat16 product is exact in float32,
    so upcasting first is the JAX einsum's ``preferred_element_type``.

    The views are shifts of one flat array: with Xpad (one zero pixel
    around each image) flattened over (b, y, x) and dY placed at the
    top-left of the same (H+2, W+2) grid, zero elsewhere, tap (ky, kx) is
    ``Xflat[p + ky·(W+2) + kx]ᵀ · dYflat[p]`` summed over p — one matrix
    product over a contiguous slice, no copy of a window."""
    b, h, w, cin = x.shape
    cout = dy.shape[-1]
    wp = w + 2
    n = b * (h + 2) * wp
    # the largest shift, 2 (W+2) + 2, reads that many rows past the grid
    xp = torch.zeros(n + 2 * wp + 2, cin, dtype=WGRAD_DTYPE, device=x.device)
    xp[:n].view(b, h + 2, wp, cin)[:, 1:h + 1, 1:w + 1] = x
    dp = F.pad(dy.to(WGRAD_DTYPE), (0, 0, 0, 2, 0, 2)).reshape(n, cout)
    taps = [xp[ky * wp + kx:ky * wp + kx + n].t() @ dp
            for ky in range(3) for kx in range(3)]
    return torch.stack(taps).reshape(3, 3, cin, cout)


def _library():
    """``(splits fn, wgrad fn)`` of ``csrc/wgrad_9tap.cu``."""
    from distributedpytorch_tpu_torch.ops import _build

    lib = _build.load("wgrad_9tap")
    splits, fn = lib.dpt_wgrad_9tap_splits, lib.dpt_wgrad_9tap
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        splits.argtypes = [i32] * 6
        splits.restype = i32
        fn.argtypes = [ptr, ptr] + [i32] * 7 + [ptr, ptr, ptr]
        fn.restype = i32
    return splits, fn


def _check(t: torch.Tensor, what: str, like: torch.Tensor) -> None:
    if t.device != like.device:
        raise ValueError(f"{what}: on {t.device}, expected {like.device}")
    if t.dtype != like.dtype:
        raise ValueError(f"{what}: {t.dtype}, expected {like.dtype} like x")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous (B, H, W, C)")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: must be 16-byte aligned")


def wgrad_9tap(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dW (3, 3, Cin, Cout) in float32 for ``x`` (B, H, W, Cin) and ``dy``
    (B, H, W, Cout), both bfloat16 or both float32 and contiguous in that
    NHWC order. On the card this launches K5 on the current stream
    (bfloat16 on the tensor cores with float32 sums; float32 on the CUDA
    cores), the sum over B·H·W split across blocks and the partials added
    in a fixed order, so two calls agree bit for bit. With bfloat16, Cin
    and Cout must be multiples of 16. On the CPU it is the plain
    version."""
    if x.device.type == "cpu":
        return wgrad_9tap_reference(x, dy)
    if x.device.type != "cuda":
        raise ValueError(f"wgrad_9tap: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"wgrad_9tap: expected bfloat16 or float32, got "
                         f"{x.dtype}")
    if x.dim() != 4 or dy.dim() != 4 or x.shape[:3] != dy.shape[:3]:
        raise ValueError(f"wgrad_9tap: x {tuple(x.shape)} and dy "
                         f"{tuple(dy.shape)} must share (B, H, W)")
    _check(x, "wgrad_9tap x", x)
    _check(dy, "wgrad_9tap dy", x)
    b, h, w, cin = x.shape
    cout = dy.shape[-1]
    bf16 = x.dtype == torch.bfloat16
    if bf16 and (cin % 16 or cout % 16):
        raise ValueError(f"wgrad_9tap: bfloat16 needs Cin and Cout in "
                         f"multiples of 16, got {cin} and {cout}")
    splits_fn, fn = _library()
    splits = int(splits_fn(b, h, w, cin, cout, int(bf16)))
    out = torch.empty(3, 3, cin, cout, dtype=WGRAD_DTYPE, device=x.device)
    partial = (torch.empty(splits, 3, 3, cin, cout, dtype=WGRAD_DTYPE,
                           device=x.device) if splits > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dy.data_ptr(), int(bf16), b, h, w, cin, cout,
                 splits, None if partial is None else partial.data_ptr(),
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"wgrad_9tap kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["wgrad_9tap"] += 1
    return out
