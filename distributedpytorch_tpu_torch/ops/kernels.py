"""Hand-written kernels of the port, with their plain PyTorch versions, and
the kernel policy that engages them.

Each wrapper takes the plain version for a tensor on the CPU (the tests
run there) and launches its CUDA kernel for a tensor on the card — it
never falls back from one to the other. ``LAUNCHES`` counts kernel
launches by name, so a run can show its main path went through them.

The per-card priors file (``python -m distributedpytorch_tpu_torch
probe``, ``ops/probes.py``) records which kernels built, launched and
agreed with their plain versions on a card; ``apply_priors`` disengages
every kernel it marks rejected before a run starts, one warning per
verdict, so a rejected kernel's plain version is the policy's choice,
never a fallback from a CUDA tensor. ``--kernel-priors`` (a config's
``kernel_priors``) or ``$DPT_KERNEL_PRIORS`` names the file; a missing,
corrupt or stale one is ignored with a note.

Counterpart of ``distributedpytorch_tpu/ops/kernels.py``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import logging
import os
import struct
from typing import Dict, Mapping, Optional, Tuple

import torch

from distributedpytorch_tpu_torch.ops.precision import (
    LOSS_DTYPE,
    NORM_DTYPE,
    WGRAD_DTYPE,
)

logger = logging.getLogger(__name__)

#: Kernel launches by kernel name since the last reset. Only launches of
#: the CUDA kernel count — a CPU tensor's plain-version call does not.
LAUNCHES: Dict[str, int] = {
    "serve_mask": 0,
    "loss_stats": 0,      # ops/loss_kernels.eval_stats (K1)
    "loss_stats_bwd": 0,  # ops/loss_kernels.stats_bwd (K1-bwd)
    "bn_act": 0,          # bn_act (K2)
    "bn_act_bwd": 0,      # bn_act_bwd (K3)
    "wgrad_9tap": 0,      # ops/wgrad_kernels.wgrad_9tap (K5)
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# The policy object
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """Which hand-written kernels the trainer and the serve path engage.

    ``torch`` is the counterpart of the JAX package's ``xla``: plain
    PyTorch everywhere; the serve engine returns float32 probabilities
    and thresholds them on the host. ``cuda`` is the counterpart of
    ``pallas``: the training loss runs through the statistics kernel and
    its backward (``ops/fused_loss.py``), the eval step through the
    statistics kernel (``ops/loss_kernels.eval_metrics``), the serve
    forward ends in the serve-mask kernel and returns uint8 masks,
    milesial's BatchNorm + ReLU runs through the epilogue kernels
    (``fused_bn_act``), and the taps conv's weight gradient may take the
    9-tap kernel (``ops/conv_backward.py``)."""

    name: str
    serve_mask: bool
    train_loss_fused: bool
    eval_stats_fused: bool
    conv_epilogue: bool  # fused_bn_act in milesial's DoubleConv
    wgrad_cuda: bool     # ops/wgrad_kernels.py allowed on the taps path


KERNEL_POLICIES: Dict[str, KernelPolicy] = {
    "torch": KernelPolicy("torch", serve_mask=False, train_loss_fused=False,
                          eval_stats_fused=False, conv_epilogue=False,
                          wgrad_cuda=False),
    "cuda": KernelPolicy("cuda", serve_mask=True, train_loss_fused=True,
                         eval_stats_fused=True, conv_epilogue=True,
                         wgrad_cuda=True),
}


#: Probe name (the JAX registry's) → the policy field(s) it gates: a
#: priors file marking a kernel rejected turns exactly these off.
KERNEL_GATES: Dict[str, Tuple[str, ...]] = {
    "fused_loss": ("train_loss_fused",),
    "eval_stats": ("eval_stats_fused",),
    "conv_epilogue": ("conv_epilogue",),
    "serve_mask": ("serve_mask",),
    "wgrad_9tap": ("wgrad_cuda",),
}


def get_kernel_policy(name=None, device: Optional[torch.device] = None,
                      priors: Optional[Mapping] = None) -> KernelPolicy:
    """A policy by name, or an already-resolved one (passed through as it
    is). ``None`` resolves to ``cuda`` on a CUDA device and to ``torch``
    elsewhere. The priors' rejections apply to a policy resolved by name:
    ``priors``, else ``$DPT_KERNEL_PRIORS``'s file."""
    if isinstance(name, KernelPolicy):
        return name
    if name is None:
        cuda = device is not None and torch.device(device).type == "cuda"
        name = "cuda" if cuda else "torch"
    try:
        policy = KERNEL_POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown kernel policy {name!r} (expected one of "
            f"{sorted(KERNEL_POLICIES)})"
        ) from None
    if priors is None:
        priors = _env_priors()
    return apply_priors(policy, priors) if priors else policy


def config_priors(config) -> Optional[dict]:
    """The priors a config names (``kernel_priors``), else
    ``$DPT_KERNEL_PRIORS``'s; None when neither loads."""
    path = getattr(config, "kernel_priors", None)
    return load_priors(path) if path else _env_priors()


def config_kernel_policy(config) -> KernelPolicy:
    """The policy a config resolves to: its ``kernels`` field, with
    ``None`` resolved against its ``device`` (``None`` meaning the card),
    and its priors applied."""
    device = getattr(config, "device", None) or "cuda"
    return get_kernel_policy(getattr(config, "kernels", None),
                             torch.device(device),
                             priors=config_priors(config) or {})


def _env_priors() -> Optional[dict]:
    path = os.environ.get("DPT_KERNEL_PRIORS")
    return load_priors(path) if path else None


#: (policy, kernel, field) verdicts already warned about: the policy
#: resolves in several layers (trainer, model factory, serve engine), and
#: one rejection should read as one line
_WARNED_REJECTIONS: set = set()


def apply_priors(policy: KernelPolicy, priors: Mapping) -> KernelPolicy:
    """``policy`` with every kernel the priors mark rejected disengaged,
    one warning per verdict. A kernel absent from the file stays as the
    policy says (unprobed is not rejected)."""
    kernels = priors.get("kernels") if isinstance(priors, Mapping) else None
    if not isinstance(kernels, Mapping):
        return policy
    changes: Dict[str, bool] = {}
    for kernel, row in kernels.items():
        if not isinstance(row, Mapping) or row.get("accepted", True):
            continue
        for field in KERNEL_GATES.get(kernel, ()):
            if getattr(policy, field, False):
                changes[field] = False
                mark = (policy.name, kernel, field)
                if mark not in _WARNED_REJECTIONS:
                    _WARNED_REJECTIONS.add(mark)
                    logger.warning(
                        "kernel policy %r: the probe rejected %s on this "
                        "card (%s) — %s disengaged, the plain PyTorch "
                        "version kept", policy.name, kernel,
                        row.get("reason", "no reason recorded"), field)
    if not changes:
        return policy
    return dataclasses.replace(policy, **changes)


# ---------------------------------------------------------------------------
# The priors file
# ---------------------------------------------------------------------------

PRIORS_KIND = "dpt_kernel_priors"
#: Any other version is ignored with a note: a stale file must never flip
#: a kernel silently.
PRIORS_VERSION = 1


def save_priors(payload: dict, path: str) -> None:
    """Write the priors file atomically (a temporary file renamed)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2)
    os.replace(tmp, path)


#: path → (mtime, payload): each layer resolving the policy reads the file
#: once; a rewritten file has another mtime
_PRIORS_CACHE: Dict[str, Tuple[float, Optional[dict]]] = {}


def load_priors(path: str) -> Optional[dict]:
    """The priors payload, or None — with a logged note — for a missing,
    unreadable, corrupt or stale file."""
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        logger.info("kernel priors %s not found — ignored; kernels stay "
                    "unprobed", path)
        return None
    cached = _PRIORS_CACHE.get(path)
    if cached is not None and cached[0] == mtime:
        return cached[1]
    payload = _read_priors(path)
    _PRIORS_CACHE[path] = (mtime, payload)
    return payload


def _read_priors(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError) as exc:
        logger.warning("kernel priors %s unreadable (%s) — ignored; kernels "
                       "stay unprobed", path, exc)
        return None
    if (not isinstance(payload, dict)
            or payload.get("kind") != PRIORS_KIND
            or payload.get("version") != PRIORS_VERSION
            or not isinstance(payload.get("kernels"), dict)):
        logger.warning("kernel priors %s stale or malformed (want kind=%r "
                       "version=%d) — ignored; kernels stay unprobed", path,
                       PRIORS_KIND, PRIORS_VERSION)
        return None
    return payload


def conv_epilogue_engaged(config) -> bool:
    """Whether the model factory builds milesial's DoubleConv with the
    fused BatchNorm + ReLU epilogue. The JAX package also requires a
    device-local forward; the port trains single-device only, so the
    policy alone decides."""
    return config_kernel_policy(config).conv_epilogue


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


# ---------------------------------------------------------------------------
# milesial's DoubleConv epilogue: BatchNorm-normalize + ReLU (K2, K3)
# ---------------------------------------------------------------------------
#
# With the affine folded, a = rsqrt(var + eps)·scale and b = bias − mean·a,
# the epilogue is y = relu(x·a + b): one multiply-add and a max per element
# (K2, csrc/bn_act.cu). Its backward needs dz = g·[z > 0] elementwise and
# two channel sums, s1 = Σdz and s2 = Σdz·(x − mean), which one pass gives
# together with dx = dz·a (K3); the closed forms
#
#     dbias = s1     dscale = inv·s2     dmean = −a·s1
#     dvar  = −½·scale·inv³·s2
#
# are (C,)-sized torch ops. The batch statistics themselves stay torch ops
# on x, so autograd carries dmean and dvar back to x, as XLA does for the
# JAX kernel.
#
# Activations are NCHW tensors in channels_last memory: physically
# (B·H·W, C) rows, the view both kernels read.


def _per_channel(t: torch.Tensor) -> torch.Tensor:
    return t.view(1, -1, 1, 1)


def fold_bn(mean: torch.Tensor, var: torch.Tensor, scale: torch.Tensor,
            bias: torch.Tensor, epsilon: float = 1e-5):
    """``(inv, a, b)`` in ``NORM_DTYPE``: ``inv = rsqrt(var + eps)``,
    ``a = inv·scale`` and ``b = bias − mean·a``."""
    inv = torch.rsqrt(var.to(NORM_DTYPE) + epsilon)
    a = inv * scale.to(NORM_DTYPE)
    b = bias.to(NORM_DTYPE) - mean.to(NORM_DTYPE) * a
    return inv, a, b


def bn_act_reference(x: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """The plain version of K2: ``relu(x·a + b)`` in float32 for an NCHW
    ``x`` and (C,) ``a``, ``b``, rounded after the product and after the
    sum as the kernel rounds."""
    z = x.to(NORM_DTYPE) * _per_channel(a) + _per_channel(b)
    return torch.where(z > 0, z, 0.0)


def bn_act_bwd_reference(x: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
                         b: torch.Tensor, mean: torch.Tensor):
    """The plain version of K3: ``(dx, sums)`` with ``dz = g·[x·a + b > 0]``,
    ``dx = dz·a`` in ``x``'s dtype and ``sums`` the (2, C) float32 rows
    ``Σdz`` and ``Σdz·(x − mean)`` over batch and space."""
    xf = x.to(NORM_DTYPE)
    z = xf * _per_channel(a) + _per_channel(b)
    dz = torch.where(z > 0, g.to(WGRAD_DTYPE), 0.0)
    dx = (dz * _per_channel(a)).to(x.dtype)
    s1 = dz.sum(dim=(0, 2, 3))
    s2 = (dz * (xf - _per_channel(mean))).sum(dim=(0, 2, 3))
    return dx, torch.stack([s1, s2])


def fused_bn_act_reference(x: torch.Tensor, mean: torch.Tensor,
                           var: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor,
                           epsilon: float = 1e-5) -> torch.Tensor:
    """The plain version of :func:`fused_bn_act`, differentiable by
    autograd: ``relu(x·a + b)`` with the folded affine."""
    _inv, a, b = fold_bn(mean, var, scale, bias, epsilon)
    return bn_act_reference(x, a, b)


def _bn_act_lib():
    """``(fwd, bwd, bwd_blocks)`` of ``csrc/bn_act.cu``."""
    from distributedpytorch_tpu_torch.ops import _build

    lib = _build.load("bn_act")
    fwd, bwd, blocks = lib.dpt_bn_act, lib.dpt_bn_act_bwd, \
        lib.dpt_bn_act_bwd_blocks
    if fwd.argtypes is None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fwd.argtypes = [ptr, i32, ptr, i64, i32, ptr, ptr]
        fwd.restype = i32
        bwd.argtypes = [ptr, i32, ptr, ptr, i64, i32, ptr, ptr, ptr, ptr]
        bwd.restype = i32
        blocks.argtypes = [i64, i32]
        blocks.restype = i32
    return fwd, bwd, blocks


def _channels_last(x: torch.Tensor, what: str) -> torch.Tensor:
    """``x`` as NCHW in channels_last memory — an explicit copy where its
    layout differs — checked for what the kernels read."""
    if x.dim() != 4:
        raise ValueError(f"{what}: expected an NCHW tensor, got {x.dim()}-D")
    if not x.is_contiguous(memory_format=torch.channels_last):
        x = x.contiguous(memory_format=torch.channels_last)
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: input must be 16-byte aligned")
    return x


def _channel_rows(what: str, like: torch.Tensor, *vecs: torch.Tensor
                  ) -> torch.Tensor:
    """The (C,) float32 channel operands packed into one row-major tensor
    on ``like``'s device."""
    c = like.shape[1]
    for v in vecs:
        if v.shape != (c,):
            raise ValueError(f"{what}: channel operand of shape "
                             f"{tuple(v.shape)}, expected ({c},)")
    return torch.cat([v.to(device=like.device, dtype=NORM_DTYPE)
                      for v in vecs]).contiguous()


def _check_kernel_input(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: expected bfloat16 or float32, got "
                         f"{x.dtype}")


def bn_act(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """K2: ``relu(x·a + b)`` as float32, ``x``'s NCHW shape in
    channels_last memory. ``x`` is bfloat16 or float32, ``a`` and ``b``
    (C,). On the card it launches ``csrc/bn_act.cu`` on the current stream
    and equals the plain version bit for bit; on the CPU it is the plain
    version."""
    if x.device.type == "cpu":
        return bn_act_reference(x, a, b)
    _check_kernel_input(x, "bn_act")
    x = _channels_last(x, "bn_act")
    ab = _channel_rows("bn_act", x, a, b)
    y = torch.empty(x.shape, dtype=NORM_DTYPE, device=x.device,
                    memory_format=torch.channels_last)
    rows, c = x.numel() // x.shape[1], x.shape[1]
    fwd, _, _ = _bn_act_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fwd(x.data_ptr(), int(x.dtype == torch.bfloat16), ab.data_ptr(),
                  rows, c, y.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bn_act kernel launch failed: CUDA error {err}")
    LAUNCHES["bn_act"] += 1
    return y


def bn_act_bwd(x: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, mean: torch.Tensor):
    """K3: ``bn_act_bwd_reference``'s ``(dx, sums)`` in one pass over
    ``x`` and ``g`` plus a pass over per-block partials. ``dx`` equals the
    plain version bit for bit; the channel sums are added in a fixed order
    (bitwise repeatable), another order than ``torch.sum``'s."""
    if x.device.type == "cpu":
        return bn_act_bwd_reference(x, g, a, b, mean)
    _check_kernel_input(x, "bn_act_bwd")
    if g.shape != x.shape:
        raise ValueError(f"bn_act_bwd: cotangent of shape {tuple(g.shape)} "
                         f"for x of shape {tuple(x.shape)}")
    x = _channels_last(x, "bn_act_bwd x")
    g = _channels_last(g.to(WGRAD_DTYPE), "bn_act_bwd g")
    abm = _channel_rows("bn_act_bwd", x, a, b, mean)
    rows, c = x.numel() // x.shape[1], x.shape[1]
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device,
                     memory_format=torch.channels_last)
    sums = torch.zeros(2, c, dtype=WGRAD_DTYPE, device=x.device)
    if rows == 0:
        return dx, sums
    _, bwd, blocks = _bn_act_lib()
    partial = torch.empty(int(blocks(rows, c)) * 2 * c, dtype=WGRAD_DTYPE,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = bwd(x.data_ptr(), int(x.dtype == torch.bfloat16), g.data_ptr(),
                  abm.data_ptr(), rows, c, dx.data_ptr(), partial.data_ptr(),
                  sums.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"bn_act backward kernel launch failed: CUDA error {err}")
    LAUNCHES["bn_act_bwd"] += 1
    return dx, sums


class FusedBNAct(torch.autograd.Function):
    """``relu((x − mean)·rsqrt(var + eps)·scale + bias)`` with the folded
    affine: forward K2, backward K3 and the closed forms. Counterpart of
    the JAX package's ``jax.custom_vjp`` around ``fused_bn_act``."""

    @staticmethod
    def forward(ctx, x, mean, var, scale, bias, epsilon):
        inv, a, b = fold_bn(mean, var, scale, bias, epsilon)
        ctx.save_for_backward(x, mean, inv, scale, a, b)
        return bn_act(x, a, b)

    @staticmethod
    def backward(ctx, g):
        x, mean, inv, scale, a, b = ctx.saved_tensors
        dx, sums = bn_act_bwd(x, g, a, b, mean.to(NORM_DTYPE))
        s1, s2 = sums[0], sums[1]
        dmean = -a * s1
        dvar = -0.5 * scale.to(NORM_DTYPE) * inv ** 3 * s2
        return dx, dmean, dvar, inv * s2, s1, None


def fused_bn_act(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                 scale: torch.Tensor, bias: torch.Tensor,
                 epsilon: float = 1e-5) -> torch.Tensor:
    """BatchNorm-normalize + ReLU of an NCHW ``x`` (bfloat16 or float32)
    with (C,) channel operands, returned in ``NORM_DTYPE`` (float32) like
    the plain BatchNorm it replaces; callers cast back to the compute
    dtype. Differentiable in all five operands. The folded affine
    associates ``x·(inv·scale)`` where the plain module computes
    ``((x − mean)·inv)·scale``: equal to float rounding, not bitwise."""
    return FusedBNAct.apply(x, mean, var, scale, bias, float(epsilon))
