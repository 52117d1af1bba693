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
from dataclasses import dataclass

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


#: Streaming multiprocessors of an H100 SXM; the wrapper passes the card's
#: own count.
H100_SMS = 132
#: The most float32 partial memory a call may take for its split sums.
MAX_PARTIAL_BYTES = 64 << 20
# The kernels' geometry (``csrc/wgrad_9tap.cu``, which refuses any other):
# (pixels of one row segment, ci tile, co tile). The bf16 kernel runs one
# block per SM (200 KiB of shared memory each); the f32 kernel aims at four
# blocks per SM.
_BF16_GEOMETRY = (64, 64, 128)
_F32_GEOMETRY = (32, 16, 16)
_F32_BLOCKS_PER_SM = 4


@dataclass(frozen=True)
class WgradPlan:
    """How one K5 call cuts its work: the sum over B·H·W runs over
    ``n_segs`` row segments of ``seg`` pixels (``segs_w`` per image row,
    the last one ragged), split into ``splits`` contiguous ranges; each
    range is ``tiles`` blocks (three kernel rows × ci tiles × co tiles)."""

    h: int
    cin: int
    cout: int
    seg: int
    tile_ci: int
    tile_co: int
    segs_w: int
    n_segs: int
    tiles: int
    splits: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    @property
    def partial_bytes(self) -> int:
        """Float32 partials the call allocates (none with one split)."""
        if self.splits == 1:
            return 0
        return self.splits * 9 * self.cin * self.cout * 4

    def seg_range(self, split: int) -> tuple:
        """Segments ``[begin, end)`` of ``split``, as the kernel cuts them."""
        return (self.n_segs * split // self.splits,
                self.n_segs * (split + 1) // self.splits)

    def segment(self, seg: int) -> tuple:
        """``(b, y, x0)`` of segment ``seg``: pixels x0 .. x0 + seg − 1 of
        row y of image b, as the kernel maps it."""
        b, rem = divmod(seg, self.h * self.segs_w)
        y, xs = divmod(rem, self.segs_w)
        return b, y, xs * self.seg


def _wave_fill(blocks: int, per_wave: int) -> float:
    return blocks / (-(-blocks // per_wave) * per_wave)


def wgrad_plan(b: int, h: int, w: int, cin: int, cout: int, bf16: bool,
               sms: int = H100_SMS) -> WgradPlan:
    """The launch plan of K5 for x (b, h, w, cin) and dy (b, h, w, cout).

    The split count is bounded by the segments (each range holds at least
    one) and by ``MAX_PARTIAL_BYTES`` of partials. bf16: among those, the
    one whose blocks fill the last wave of ``sms`` blocks best, the
    smallest on a tie — so the tiles × splits blocks come out in whole
    waves wherever a split count allows it. f32: enough blocks for four
    per SM, as the CUDA-core kernel has always taken."""
    seg, tile_ci, tile_co = _BF16_GEOMETRY if bf16 else _F32_GEOMETRY
    segs_w = -(-w // seg)
    n_segs = b * h * segs_w
    tiles = 3 * -(-cin // tile_ci) * -(-cout // tile_co)
    by_memory = MAX_PARTIAL_BYTES // (9 * cin * cout * 4) if cin * cout else 1
    most = max(1, min(n_segs, by_memory))
    if not tiles:  # no channels: the kernel writes nothing but zeros
        splits = 1
    elif bf16:
        splits = max(range(1, most + 1),
                     key=lambda s: (_wave_fill(tiles * s, sms), -s))
    else:
        target = sms * _F32_BLOCKS_PER_SM
        splits = max(1, min(-(-target // tiles), most))
    return WgradPlan(h=h, cin=cin, cout=cout, seg=seg, tile_ci=tile_ci,
                     tile_co=tile_co, segs_w=segs_w, n_segs=n_segs,
                     tiles=tiles, splits=splits)


def _library():
    """The wgrad entry point of ``csrc/wgrad_9tap.cu``."""
    from distributedpytorch_tpu_torch.ops import _build

    fn = _build.load("wgrad_9tap").dpt_wgrad_9tap
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr] + [i32] * 10 + [ptr, ptr, ptr]
        fn.restype = i32
    return fn


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
    in a fixed order (``wgrad_plan``), so two calls agree bit for bit.
    With bfloat16, Cin and Cout must be multiples of 16. On the CPU it is
    the plain version."""
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
    fn = _library()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = wgrad_plan(b, h, w, cin, cout, bf16, sms)
    out = torch.empty(3, 3, cin, cout, dtype=WGRAD_DTYPE, device=x.device)
    partial = (torch.empty(plan.splits, 3, 3, cin, cout, dtype=WGRAD_DTYPE,
                           device=x.device) if plan.splits > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dy.data_ptr(), int(bf16), b, h, w, cin, cout,
                 plan.seg, plan.tile_ci, plan.tile_co, plan.splits,
                 None if partial is None else partial.data_ptr(),
                 out.data_ptr(), stream)
    if err != 0:
        # a negative code is the driver's CUresult of the tensor-map encode
        raise RuntimeError(f"wgrad_9tap kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["wgrad_9tap"] += 1
    return out
