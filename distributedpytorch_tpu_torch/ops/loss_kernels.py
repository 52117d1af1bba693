"""The loss/Dice statistics kernel (K1) and the fused loss's backward
(K1-bwd), with their plain PyTorch versions.

Counterpart of ``distributedpytorch_tpu/ops/pallas_kernels.py`` (K1: the
Pallas ``_stats_kernel``, its ``eval_stats_pallas`` /
``bce_dice_stats_pallas`` / ``eval_metrics_pallas`` wrappers) and of the
analytic backward ``_stats_bwd`` in ``ops/fused_loss.py``. Both kernels
live in ``csrc/loss_stats.cu`` and build at first use.

Each wrapper takes the plain version for tensors on the CPU (the tests
run there) and launches its CUDA kernel for tensors on the card, where
they must be contiguous, 16-byte-aligned float32, or the wrapper raises.
It never falls back from one to the other. ``kernels.LAUNCHES`` counts
one per wrapper call that launched its kernel.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from distributedpytorch_tpu_torch.ops.kernels import LAUNCHES
from distributedpytorch_tpu_torch.ops.losses import (
    _LOG_SAFE_MIN,
    loss_from_stats,
)
from distributedpytorch_tpu_torch.ops.precision import LOSS_DTYPE

_LOG_CLAMP = -100.0  # torch BCELoss log clamp, as the Pallas kernel has it
# hard-Dice eps of the eval metric (losses.dice_coefficient)
DICE_EPS = 1e-7

_lib_lock = threading.Lock()
_lib: Dict[str, object] = {}
# device index -> (SMs, K1's resident blocks per SM)
_geometry: Dict[int, Tuple[int, int]] = {}
# (device index, stream) -> K1's workspace: ticket counter and partials
_workspaces: Dict[Tuple[int, int], torch.Tensor] = {}

# K1's block geometry (``csrc/loss_stats.cu``: kStatsThreads, kUnroll):
# threads per block, and float4 loads of each input one thread has in
# flight before it computes
THREADS = 256
UNROLL = 2


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def eval_stats_reference(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``[bce_sum, count, soft_inter, soft_union, hard_inter, hard_union]``
    as float32, from the kernel's formulas: ``t_b = [t == 1]``, the BCE
    logs clamped by ``max(log x, -100)`` (the Pallas kernel's clamp, not
    the grad-safe ``losses._clamped_log``), hard predictions ``p >= 0.5``.
    The count is written on ``p``'s device."""
    p = p.to(LOSS_DTYPE).reshape(-1)
    t = t.to(LOSS_DTYPE).reshape(-1)
    tb = (t == 1.0).to(LOSS_DTYPE)
    pb = (p >= 0.5).to(LOSS_DTYPE)
    log_p = torch.clamp(torch.log(p), min=_LOG_CLAMP)
    log_1p = torch.clamp(torch.log(1.0 - p), min=_LOG_CLAMP)
    per_elem = -(tb * log_p + (1.0 - tb) * log_1p)
    count = torch.full((), p.numel(), dtype=LOSS_DTYPE, device=p.device)
    return torch.stack([
        per_elem.sum(),
        count,
        (p * tb).sum(),
        p.sum() + tb.sum(),
        (pb * tb).sum(),
        pb.sum() + tb.sum(),
    ])


def stats_bwd_reference(o: torch.Tensor, t: torch.Tensor,
                        ct: torch.Tensor) -> torch.Tensor:
    """The cotangent of the four ``bce_dice_stats`` sums with respect to
    each output element: ``ct0 dbce + ct2 t_b + ct3`` (the count's ``ct1``
    adds nothing), with ``dbce = -(t_b [o >= m] / o - (1 - t_b) [1 - o >= m]
    / (1 - o))`` and ``m = _LOG_SAFE_MIN``. A saturated pixel gets an
    exactly zero BCE gradient, never ``inf * 0``. Float32, ``o``'s shape."""
    o = o.to(LOSS_DTYPE)
    tb = (t == 1).to(LOSS_DTYPE)
    m = _LOG_SAFE_MIN
    inv_o = torch.where(o >= m, 1.0 / torch.clamp(o, min=m), 0.0)
    q = 1.0 - o
    inv_1mo = torch.where(q >= m, 1.0 / torch.clamp(q, min=m), 0.0)
    dbce = -(tb * inv_o - (1.0 - tb) * inv_1mo)
    return ct[0] * dbce + ct[2] * tb + ct[3]


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LossStatsPlan:
    """How one K1 call over ``n`` elements cuts them: ``blocks`` blocks,
    each one contiguous run of ``chunk`` elements (a multiple of 4, so
    float4-aligned) of the first ``4 (n // 4)``; the last block's run is
    short, and that block also takes the ``n mod 4`` tail."""

    n: int
    blocks: int
    chunk: int

    def block_range(self, block: int) -> Tuple[int, int]:
        """Elements ``[begin, end)`` that ``block`` streams as float4s."""
        body = self.n - self.n % 4
        begin = min(block * self.chunk, body)
        return begin, min(begin + self.chunk, body)

    @property
    def tail(self) -> Tuple[int, int]:
        """Elements ``[begin, end)`` the last block adds one per thread."""
        return self.n - self.n % 4, self.n


def loss_stats_plan(n: int, sms: int, blocks_per_sm: int) -> LossStatsPlan:
    """K1's launch plan: at most one whole wave of ``sms x blocks_per_sm``
    resident blocks, each streaming an equal float4-aligned chunk (the
    last one shorter) of at least one float4 per thread, so a small input
    takes few blocks. With fewer than four elements, one block takes the
    tail alone. ``csrc/loss_stats.cu`` refuses any other plan."""
    n4 = n // 4
    chunk4 = max(THREADS, -(-n4 // (sms * blocks_per_sm)))
    blocks = max(1, -(-n4 // chunk4))
    return LossStatsPlan(n=n, blocks=blocks, chunk=4 * chunk4)


def _library():
    """The entry points of ``csrc/loss_stats.cu``: ``{stats, bwd,
    blocks_per_sm, workspace_words}``."""
    with _lib_lock:
        if not _lib:
            from distributedpytorch_tpu_torch.ops import _build

            lib = _build.load("loss_stats")
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            stats = lib.dpt_loss_stats
            stats.argtypes = [ptr, ptr, i32, i32, i32, ptr, i32, ptr, ptr]
            stats.restype = i32
            bwd = lib.dpt_loss_stats_bwd
            bwd.argtypes = [ptr, ptr, ptr, i32, ptr, ptr]
            bwd.restype = i32
            per_sm = lib.dpt_loss_stats_blocks_per_sm
            per_sm.argtypes = []
            per_sm.restype = i32
            words = lib.dpt_loss_stats_workspace_words
            words.argtypes = [i32]
            words.restype = i32
            _lib.update(stats=stats, bwd=bwd, blocks_per_sm=per_sm,
                        workspace_words=words)
        return _lib


def card_geometry(device: torch.device) -> Tuple[int, int]:
    """``(SMs, K1's resident blocks per SM)`` of ``device``, read once."""
    index = device.index
    with _lib_lock:
        found = _geometry.get(index)
    if found is None:
        lib = _library()
        with torch.cuda.device(index):
            per_sm = int(lib["blocks_per_sm"]())
        if per_sm < 1:
            raise RuntimeError("loss stats kernel: the occupancy query failed")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        found = (sms, per_sm)
        with _lib_lock:
            _geometry[index] = found
    return found


def _workspace(device: torch.device, stream: int, most: int) -> torch.Tensor:
    """K1's workspace for ``stream`` on ``device``: made and zeroed once,
    left zeroed by every call. One per stream, so calls on two streams
    never share a ticket counter."""
    key = (device.index, stream)
    with _lib_lock:
        ws = _workspaces.get(key)
    if ws is None:
        words = int(_library()["workspace_words"](most))
        ws = torch.zeros(words, dtype=torch.int32, device=device)
        with _lib_lock:
            ws = _workspaces.setdefault(key, ws)
    return ws


def _check_operand(x: torch.Tensor, what: str, like: torch.Tensor) -> None:
    if x.device != like.device:
        raise ValueError(f"{what}: on {x.device}, expected {like.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{what}: expected float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: input must be 16-byte aligned")


def _check_pair(p: torch.Tensor, t: torch.Tensor, name: str) -> int:
    if p.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {p.device}")
    _check_operand(p, f"{name} p", p)
    _check_operand(t, f"{name} t", p)
    if t.numel() != p.numel():
        raise ValueError(f"{name}: {p.numel()} predictions but "
                         f"{t.numel()} targets")
    n = p.numel()
    if n >= 2**31:
        raise ValueError(f"{name}: {n} elements exceed the int32 range")
    return n


def eval_stats(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The six K1 sums of ``p`` against ``t`` (any shapes with equal
    element counts) as a float32 ``(6,)`` tensor on their device. On the
    card: one launch on the current stream (``loss_stats_plan``; the last
    block to finish adds the partials), with no host sync; the sums are
    bitwise repeatable and the count and hard sums exact."""
    if p.device.type == "cpu":
        return eval_stats_reference(p, t)
    n = _check_pair(p, t, "loss stats")
    sms, per_sm = card_geometry(p.device)
    return _launch_stats(p, t, loss_stats_plan(n, sms, per_sm))


def _launch_stats(p: torch.Tensor, t: torch.Tensor,
                  plan: LossStatsPlan) -> torch.Tensor:
    """K1 on checked operands under ``plan``, which the entry point checks
    against its own."""
    lib = _library()
    sms, per_sm = card_geometry(p.device)
    out = torch.empty(6, dtype=LOSS_DTYPE, device=p.device)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        ws = _workspace(p.device, stream, sms * per_sm)
        err = lib["stats"](p.data_ptr(), t.data_ptr(), plan.n, plan.blocks,
                           plan.chunk, ws.data_ptr(), ws.numel(),
                           out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"loss stats kernel launch failed: CUDA error {err}")
    LAUNCHES["loss_stats"] += 1
    return out


def stats_bwd(o: torch.Tensor, t: torch.Tensor,
              ct: torch.Tensor) -> torch.Tensor:
    """K1-bwd: ``stats_bwd_reference``'s gradient in one elementwise pass,
    same shape as ``o``. ``ct`` is the four-element float32 cotangent on
    the card; the kernel reads it there, so nothing waits on the host."""
    if o.device.type == "cpu":
        return stats_bwd_reference(o, t, ct)
    n = _check_pair(o, t, "loss stats backward")
    _check_operand(ct, "loss stats backward ct", o)
    if ct.numel() != 4:
        raise ValueError(f"loss stats backward: ct has {ct.numel()} "
                         f"elements, expected 4")
    bwd_fn = _library()["bwd"]
    grad = torch.empty(o.shape, dtype=LOSS_DTYPE, device=o.device)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        err = bwd_fn(o.data_ptr(), t.data_ptr(), ct.data_ptr(), n,
                     grad.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"loss stats backward kernel launch failed: CUDA error {err}")
    LAUNCHES["loss_stats_bwd"] += 1
    return grad


def bce_dice_stats_kernel(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``losses.bce_dice_stats``'s four sums through K1."""
    return eval_stats(p, t)[:4]


def eval_metrics(p: torch.Tensor, t: torch.Tensor,
                 dice_eps: float = DICE_EPS) -> Dict[str, torch.Tensor]:
    """``{'loss', 'dice'}`` of the eval step from one K1 pass: BCE −
    log(soft Dice) and the hard Dice at threshold 0.5. Both stay 0-d
    tensors on the device."""
    stats = eval_stats(p, t)
    dice = (2.0 * stats[4] + dice_eps) / (stats[5] + dice_eps)
    return {"loss": loss_from_stats(stats[:4]), "dice": dice}
