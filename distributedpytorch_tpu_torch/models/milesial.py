"""The milesial/Pytorch-UNet architecture, as PyTorch modules.

Counterpart of the pixel path of ``distributedpytorch_tpu/models/milesial.py``
(``DoubleConv``, ``Down``, ``Up``, ``MilesialUNet``): inc → Down×4 →
Up×4 → OutConv, [Conv3×3 (no bias) → BatchNorm → ReLU] × 2 per level,
transposed-conv upsampling, widths 64 → 1024; 31,037,698 parameters at
``n_classes=2``, 31,037,633 at the segmentation task's ``n_classes=1``.

* The public boundary keeps the JAX layout, as ``models/unet.py`` does:
  ``(B, H, W, 3)`` in, ``(B, H, W, n_classes)`` float32 out (sigmoid
  probabilities for one class, logits otherwise). Inside, activations are
  NCHW tensors in ``channels_last`` memory.
* ``state_dict()`` keys are upstream milesial's (``inc.double_conv.{0,1,3,4}``,
  ``down{i}.maxpool_conv.1.double_conv.*``, ``up{i}.up``,
  ``up{i}.conv.double_conv.*``, ``outc.conv``), so an upstream ``.pth``
  loads with a strict ``load_state_dict``.
* BatchNorm has ``nn.BatchNorm2d``'s parameter and buffer names and
  flax's semantics (``BatchNormAct``). Under the kernel policy's
  ``conv_epilogue`` its normalize + ReLU runs through the epilogue kernels
  (``ops/kernels.fused_bn_act``).
* The bilinear decoder and the space-to-depth levels of the JAX model are
  not ported (ROADMAP.md); the JAX factory's training path builds neither
  off the TPU.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from distributedpytorch_tpu_torch.dist.collectives import all_reduce_sum

from distributedpytorch_tpu_torch.models.unet import (
    Conv2d,
    ConvTranspose2d,
    conv3x3,
    crop_skip,
    init_convs_,
)
from distributedpytorch_tpu_torch.ops.kernels import fused_bn_act
from distributedpytorch_tpu_torch.ops.precision import LOSS_DTYPE, NORM_DTYPE

MILESIAL_WIDTHS = (64, 128, 256, 512, 1024)


class BatchNormAct(nn.Module):
    """BatchNorm over the channels of an NCHW ``x``, then ReLU, returned in
    ``x``'s dtype.

    Names are ``nn.BatchNorm2d``'s (``weight``, ``bias``,
    ``running_mean``, ``running_var``, ``num_batches_tracked``); the
    semantics are flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` on a
    float32 input, which is what the JAX model runs:

    * training: the batch statistics are float32 with the fast, biased
      variance ``max(0, E[x²] − E[x]²)``, and the running averages move by
      ``0.9·old + 0.1·batch``. ``F.batch_norm`` would store the unbiased
      variance (×n/(n−1)) instead, so it is not used;
    * with ``global_stats`` (set by the DDP strategy; DDP_MP leaves it
      off: each microbatch normalizes with its own shard's moments, as
      inside the JAX ``shard_map``, and the pipeline averages the running
      averages' deltas over the ranks after the step) ``E[x]`` and
      ``E[x²]`` are averaged over the ranks through an all-reduce that
      autograd sees before ``var`` is formed: the moments of the global
      batch, as GSPMD computes them for the JAX DDP, valid because every
      rank holds an equal batch (the train loader drops the ragged one).
      The running averages then move identically on every rank.
      ``torch.nn.SyncBatchNorm`` is not used: it too stores the unbiased
      variance;
    * with ``replicas`` (set by the DP strategy for the forward of one
      step, ``parallel/replicas.py``) the replicas' threads meet here and
      every replica normalizes with the moments of the whole batch, which
      it keeps (``kept_moments``); a recompute under ``recomputing``
      (``--remat``) normalizes with the kept moments and does not meet
      again. They are what a second meeting would return, bit for bit:
      the recompute sees the same x;
    * ``update_running_stats`` False (``frozen_running_stats``) leaves the
      running averages where they are: 1f1b's phase B re-runs forwards
      whose statistics phase A already recorded;
    * eval: the running averages normalize;
    * normalize as flax does, ``(x − mean)·(inv·scale) + bias`` with
      ``inv = rsqrt(var + eps)``, or, with ``epilogue``, through
      ``fused_bn_act`` (K2 forward, K3 backward on the card).
    """

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, epilogue: bool = False):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.epilogue = epilogue
        self.global_stats = False
        self.replicas = None
        self.update_running_stats = True
        self.reuse_kept_moments = False
        self.kept_moments: Optional[torch.Tensor] = None
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def batch_stats(self, xf: torch.Tensor):
        """The batch's float32 ``(mean, var)`` over (B, H, W) of the
        float32 ``xf`` (over the ranks' global batch with
        ``global_stats``), and the running averages moved by them."""
        mean = xf.mean(dim=(0, 2, 3))
        mean2 = xf.square().mean(dim=(0, 2, 3))
        if self.global_stats:
            moments = all_reduce_sum(torch.stack([mean, mean2]))
            mean, mean2 = moments / dist.get_world_size()
        if not self.reuse_kept_moments:
            self.kept_moments = None
            if self.replicas is not None:
                moments = self.replicas.mean(torch.stack([mean, mean2]))
                self.kept_moments = moments.detach()
                mean, mean2 = moments
        elif self.kept_moments is not None:
            # a leaf that requires grad, as the meeting's moments do, so
            # that the recompute saves for backward what the forward saved
            mean, mean2 = self.kept_moments.detach().requires_grad_()
        var = torch.clamp_min(mean2 - mean.square(), 0.0)
        if self.update_running_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1.0 - m) * var)
                self.num_batches_tracked += 1
        return mean, var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # in training the epilogue reads the float32 widening of x, as the
        # JAX kernel does: its dx is then float32 and meets the statistics'
        # gradient in float32, rounding to x's dtype once. In eval there
        # is no backward, and the kernel reads x as it is (the widening is
        # exact)
        if self.training:
            src = x.to(NORM_DTYPE)
            mean, var = self.batch_stats(src)
        else:
            src = x
            mean, var = self.running_mean, self.running_var
        if self.epilogue:
            y = fused_bn_act(src, mean, var, self.weight, self.bias,
                             self.epsilon)
        else:
            mul = torch.rsqrt(var + self.epsilon) * self.weight

            def per_channel(t):
                return t.view(1, -1, 1, 1)

            y = F.relu((src.to(NORM_DTYPE) - per_channel(mean))
                       * per_channel(mul) + per_channel(self.bias))
        return y.to(x.dtype)


@contextlib.contextmanager
def _attributes_set(modules: List[nn.Module], **flags) -> Iterator[None]:
    """Within the block every module of ``modules`` has ``flags`` as its
    attributes."""
    saved = [{k: getattr(m, k) for k in flags} for m in modules]
    for m in modules:
        for key, value in flags.items():
            setattr(m, key, value)
    try:
        yield
    finally:
        for m, old in zip(modules, saved):
            for key, value in old.items():
                setattr(m, key, value)


def _batchnorms(model: nn.Module) -> List[nn.Module]:
    return [m for m in model.modules() if isinstance(m, BatchNormAct)]


def frozen_running_stats(model: nn.Module):
    """Within the block no ``BatchNormAct`` of ``model`` moves its running
    averages; training-mode forwards still normalize with the batch's
    moments."""
    return _attributes_set(_batchnorms(model), update_running_stats=False)


@contextlib.contextmanager
def recomputing(model: nn.Module) -> Iterator[None]:
    """The recompute of a forward (``models.Rematerialized``): the running
    averages frozen, as the first forward moved them, each
    ``BatchNormAct`` that kept the replicas' moments in that forward
    normalizes with them, and each 3×3 conv of a row shard puts the halo
    rows it kept around its rows (``models/unet.take_halo``)."""
    convs = [m for m in model.modules() if isinstance(m, Conv2d)]
    with _attributes_set(_batchnorms(model), update_running_stats=False,
                         reuse_kept_moments=True), \
            _attributes_set(convs, reuse_kept_halo=True):
        yield


class DoubleConv(nn.Module):
    """[Conv3×3 (no bias) → BatchNorm → ReLU] × 2, at upstream's
    ``double_conv.{0,1,3,4}``; each ReLU is folded into the
    ``BatchNormAct`` before it, and the upstream ReLU slots 2 and 5 hold no
    parameters."""

    def __init__(self, in_features: int, features: int,
                 wgrad_taps: bool = False, wgrad_cuda: bool = False,
                 epilogue: bool = False):
        super().__init__()
        taps = dict(bias=False, wgrad_taps=wgrad_taps, wgrad_cuda=wgrad_cuda)
        self.double_conv = nn.Sequential(
            conv3x3(in_features, features, **taps),
            BatchNormAct(features, epilogue=epilogue),
            nn.Identity(),
            conv3x3(features, features, **taps),
            BatchNormAct(features, epilogue=epilogue),
            nn.Identity(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.double_conv(x)


class Down(nn.Module):
    """MaxPool(2) → DoubleConv, at upstream's ``maxpool_conv.{0,1}``."""

    def __init__(self, in_features: int, features: int, **kwargs):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            nn.MaxPool2d(2), DoubleConv(in_features, features, **kwargs))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.maxpool_conv(x)


class Up(nn.Module):
    """ConvTranspose(k=2, s=2) halving the channels → center-crop the skip
    to its size → concat ``[skip, up]`` → DoubleConv."""

    def __init__(self, in_features: int, skip_features: int, features: int,
                 **kwargs):
        super().__init__()
        self.up = ConvTranspose2d(in_features, in_features // 2, 2, stride=2)
        self.conv = DoubleConv(skip_features + in_features // 2, features,
                               **kwargs)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = self.up(x)
        skip = crop_skip(skip, x, self.conv.double_conv[0].halo is not None)
        return self.conv(torch.cat([skip, x], dim=1))


class OutConv(nn.Module):
    """The 1×1 head, at upstream's ``outc.conv``."""

    def __init__(self, in_features: int, n_classes: int):
        super().__init__()
        self.conv = Conv2d(in_features, n_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class MilesialUNet(nn.Module):
    """inc → Down × L → Up × L → OutConv, L = ``len(widths) − 1``.

    Parameters are float32 (bf16 under ``bf16_params``, cast by
    ``models.create_model``); convs compute in ``dtype``; BatchNorm
    statistics and normalization are float32, a bf16 scale and bias
    widened there. ``generator`` seeds flax's
    init (lecun-normal kernels, zero biases; BatchNorm scale 1, bias 0).
    ``wgrad_taps`` builds every 3×3 conv as a ``TapsConv2d`` with
    ``wgrad_cuda`` its leave for K5; ``conv_epilogue`` runs every
    BatchNorm + ReLU through ``fused_bn_act``."""

    #: the trainer keys off this: BatchNorm carries running statistics, so
    #: a train step runs in train mode and an eval step in eval mode
    is_stateful = True

    def __init__(
        self,
        n_classes: int = 1,
        widths: Sequence[int] = MILESIAL_WIDTHS,
        dtype: torch.dtype = torch.bfloat16,
        generator: Optional[torch.Generator] = None,
        wgrad_taps: bool = False,
        wgrad_cuda: bool = False,
        conv_epilogue: bool = False,
    ):
        super().__init__()
        w = tuple(widths)
        if len(w) < 2:
            raise ValueError("milesial needs at least inc + one Down level")
        self.dtype = dtype
        self.widths = w
        self.n_classes = n_classes
        kw = dict(wgrad_taps=wgrad_taps, wgrad_cuda=wgrad_cuda,
                  epilogue=conv_epilogue)
        levels = len(w) - 1
        self.inc = DoubleConv(3, w[0], **kw)
        for i in range(1, levels + 1):
            self.add_module(f"down{i}", Down(w[i - 1], w[i], **kw))
        for i in range(1, levels + 1):
            self.add_module(f"up{i}", Up(w[levels - i + 1], w[levels - i],
                                         w[levels - i], **kw))
        self.outc = OutConv(w[0], n_classes)
        init_convs_(self, generator)

    def set_conv_epilogue(self, engaged: bool) -> None:
        """Route every BatchNorm + ReLU through ``fused_bn_act`` (True) or
        the plain normalize (False); the serve engine sets it from its
        kernel policy."""
        for module in self.modules():
            if isinstance(module, BatchNormAct):
                module.epilogue = engaged

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips: Tuple[torch.Tensor, ...] = ()
        for seg in range(self.num_segments):
            x, skips = self.apply_segment(x, skips, seg)
        return x

    # -- pipeline segments (parallel/pipeline.py) ---------------------------
    # inc, L Down levels, then L Up levels with the 1×1 outc head folded
    # into the last: 2L+1 segments under the UNet's carry convention
    # (models/unet.py), inc's output being its own skip and the deepest
    # Down the bottleneck, which pushes none.
    @property
    def num_segments(self) -> int:
        return 2 * (len(self.widths) - 1) + 1

    def apply_segment(self, x: torch.Tensor, skips: Tuple[torch.Tensor, ...],
                      seg: int) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """Segment ``seg`` on the carry ``(x, skips)``: NHWC in at segment
        0, NHWC float32 out of the last."""
        levels = len(self.widths) - 1
        skips = tuple(skips)
        if seg == 0:
            x = self.inc(x.permute(0, 3, 1, 2).to(self.dtype))
            return x, skips + (x,)
        if seg <= levels:
            x = getattr(self, f"down{seg}")(x)
            return x, (skips + (x,) if seg < levels else skips)
        x = getattr(self, f"up{seg - levels}")(x, skips[-1])
        if seg == 2 * levels:
            x = self.outc(x).to(LOSS_DTYPE)
            if self.n_classes == 1:
                x = torch.sigmoid(x)
            x = x.permute(0, 2, 3, 1)
        return x, skips[:-1]

    def segment_modules(self, seg: int) -> List[nn.Module]:
        """The layers segment ``seg`` runs (a pipeline stage holds them)."""
        levels = len(self.widths) - 1
        if seg == 0:
            return [self.inc]
        if seg <= levels:
            return [getattr(self, f"down{seg}")]
        up = [getattr(self, f"up{seg - levels}")]
        return up + ([self.outc] if seg == 2 * levels else [])
