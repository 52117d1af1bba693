"""A 3×3 conv whose weight gradient runs as nine tap contractions.

Counterpart of ``distributedpytorch_tpu/ops/conv_backward.py``
(``conv3x3_same_taps`` and its ``jax.custom_vjp``). The forward and the
input gradient stay ordinary convolutions (cuDNN here, XLA there): the
input gradient is a SAME conv of dY with the kernel rotated by 180° and
its in/out channels swapped. The weight gradient,

    dW[ky, kx, ci, co] = Σ_{b,y,x} Xpad[b, y+ky, x+kx, ci] · dY[b, y, x, co],

has two backends: K5 (``ops/wgrad_kernels.wgrad_9tap``), and the nine
shifted-view einsums of its plain version. K5 engages when the kernel
policy allows it (``wgrad_cuda``), ``DPT_WGRAD_BACKEND=pallas`` selects
it (the JAX package's variable and name, so one environment drives both
packages), both channel counts are at least 128 and the tensors are on
the card; every other case takes the einsums. Sums are float32 and the
result is cast to the weight's dtype.

Tensors are NCHW here (the port's layout, in channels_last memory); the
tap functions take the NHWC views.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from distributedpytorch_tpu_torch.ops.wgrad_kernels import (
    wgrad_9tap,
    wgrad_9tap_reference,
)

# Both channel counts must reach this for K5, as for the Pallas kernel
# (``_PALLAS_MIN_CHANNELS``): narrower convs stay on the einsums.
_CUDA_MIN_CHANNELS = 128


def _wgrad_backend() -> str:
    return os.environ.get("DPT_WGRAD_BACKEND", "einsum")


def _taps_min_hw() -> int:
    """``DPT_WGRAD_TAPS_MIN_HW=N`` scopes the taps backward to convs whose
    H·W plane holds at least N pixels (default 0: every conv). A value
    that is not an integer raises: falling back to 0 would run every conv
    through the taps under a label that says otherwise."""
    raw = os.environ.get("DPT_WGRAD_TAPS_MIN_HW", "0")
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"DPT_WGRAD_TAPS_MIN_HW={raw!r}: expected an integer pixel "
            "count") from None


def wgrad_uses_kernel(cin: int, cout: int, device: torch.device,
                      wgrad_cuda: bool) -> bool:
    """Whether the weight gradient of a ``cin`` → ``cout`` conv on
    ``device`` runs through K5: all four conditions must hold."""
    return (
        wgrad_cuda
        and _wgrad_backend() == "pallas"
        and min(cin, cout) >= _CUDA_MIN_CHANNELS
        and torch.device(device).type == "cuda"
    )


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """NCHW → the (B, H, W, C) view, contiguous (an explicit channels_last
    copy where the memory is laid out otherwise)."""
    return t.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


class Conv3x3SameTaps(torch.autograd.Function):
    """``F.conv2d(x, weight, padding=1)`` for an NCHW ``x`` and an OIHW
    3×3 ``weight``, with the backward described in the module docstring.

    With ``halo`` ``x`` is a row shard's rows with one neighbour row above
    and below (B, C, h + 2, W) and the conv is VALID in H, SAME in W
    (``padding=(0, 1)``), h rows out. Its input gradient is that conv's
    own, h + 2 rows (the halo rows' part flows back to the neighbours
    through the halo's node). The weight gradient needs no other kernel:
    ``dy`` padded by one zero row at the top and the bottom (B, h + 2, W,
    Co) makes the taps' one-pixel zero pad give
    Σ_y x_halo[y + ky] · dy[y], the shard's exact share of dW, from K5 or
    the einsums alike.

    ``out_channels`` (default ``weight``'s) is the count that decides K5's
    engagement: a channel slice's whole conv's under ``-t TP``."""

    @staticmethod
    def forward(ctx, x, weight, wgrad_cuda, halo=False, out_channels=None):
        ctx.save_for_backward(x, weight)
        ctx.wgrad_cuda = bool(wgrad_cuda)
        ctx.halo = bool(halo)
        ctx.out_channels = int(out_channels or weight.shape[0])
        return F.conv2d(x, weight, padding=(0 if halo else 1, 1))

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            # kt[ci, co, ky, kx] = k[co, ci, 2 − ky, 2 − kx]; a VALID-in-H
            # forward has a FULL-in-H input gradient
            kt = weight.flip(2, 3).transpose(0, 1)
            dx = F.conv2d(dy, kt, padding=(2 if ctx.halo else 1, 1)
                          ).to(x.dtype)
        dw = None
        if ctx.needs_input_grad[1]:
            tap_fn = (wgrad_9tap
                      if wgrad_uses_kernel(x.shape[1], ctx.out_channels,
                                           x.device, ctx.wgrad_cuda)
                      else wgrad_9tap_reference)
            dy_taps = _nhwc(dy)
            if ctx.halo:
                # (B, h, W, Co) -> (B, h + 2, W, Co), zero first and last row
                dy_taps = F.pad(dy_taps, (0, 0, 0, 0, 1, 1))
            taps = tap_fn(_nhwc(x), dy_taps)  # (3, 3, Cin, Cout)
            # HWIO → OIHW: a permute, no flip
            dw = taps.permute(3, 2, 0, 1).to(weight.dtype)
        return dx, dw, None, None, None


def conv3x3_same_taps(x: torch.Tensor, weight: torch.Tensor,
                      wgrad_cuda: bool = False,
                      halo: bool = False,
                      out_channels=None) -> torch.Tensor:
    """The public taps conv: every model call site comes here, so the
    ``DPT_WGRAD_TAPS_MIN_HW`` gate applies uniformly (to a row shard's
    own plane with ``halo``, whose ``x`` carries two halo rows). Below the
    gate the conv is the plain one, forward and backward."""
    rows = x.shape[2] - (2 if halo else 0)
    if rows * x.shape[3] >= _taps_min_hw():
        return Conv3x3SameTaps.apply(x, weight, wgrad_cuda, halo,
                                     out_channels)
    return F.conv2d(x, weight, padding=(0 if halo else 1, 1))
