"""UNet for binary segmentation, as PyTorch modules.

Counterpart of ``distributedpytorch_tpu/models/unet.py``: a 4-down/4-up
UNet with channel widths 3→32→64→128→256, a 256→512 mid block, a
symmetric decoder with skip concatenation, a 1×1 segmentation head and a
float32 sigmoid. 7,760,097 parameters at the reference widths.

* The public boundary keeps the JAX layout: ``forward`` takes
  ``(B, H, W, C)`` and returns ``(B, H, W, n_classes)``. Inside, the
  permuted input is an NCHW tensor in ``channels_last`` memory, which is
  the layout cuDNN's tensor-core convolutions prefer.
* Attribute names make ``state_dict()`` keys the reference's own
  (``encoder.conv{i}.conv_block.{0,2}``, ``mid.conv_block.{0,2}``,
  ``decoder.deconv{i}``, ``decoder.conv{i}.conv_block.{0,2}``,
  ``segmap``), so a reference ``.pth`` loads with ``load_state_dict``.
* Parameters are float32, or bf16 under the ``bf16_params`` policy
  (``models.create_model`` casts them); convolutions compute in ``dtype``
  (bf16 by default) with the weights cast at the call, as flax does for
  ``nn.Conv(dtype=...)``. ``models.Rematerialized`` recomputes the
  forward in the backward under ``--remat``. Convs, max-pool and the transposed conv go to
  cuDNN through ``torch.nn.functional``.
* The space-to-depth execution mode of the JAX package is a TPU layout
  rewrite of the same function; the port runs the pixel path only.
* ``wgrad_taps`` routes each 3×3 conv through ``TapsConv2d``, whose weight
  gradient runs as nine tap contractions (``ops/conv_backward.py``), as
  the JAX package's ``_TapsPixelConv`` does.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from distributedpytorch_tpu_torch.ops.conv_backward import conv3x3_same_taps
from distributedpytorch_tpu_torch.ops.precision import LOSS_DTYPE

# Channel plan of the reference model (the mid block doubles the last).
ENCODER_WIDTHS = (32, 64, 128, 256)


def center_crop(x: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
    """Center crop of an NCHW tensor to ``(H, W) = target_hw`` (a slice)."""
    h, w = x.shape[2], x.shape[3]
    th, tw = target_hw
    dh, dw = (h - th) // 2, (w - tw) // 2
    return x[:, :, dh : dh + th, dw : dw + tw]


def crop_skip(skip: torch.Tensor, x: torch.Tensor,
              row_shard: bool) -> torch.Tensor:
    """``skip`` center-cropped to ``x``'s (H, W). On a row shard
    (``row_shard``: the block after it takes a halo) the crop must be a
    no-op, since a crop would take each shard's rows apart: equal shards
    of whole 2×2 pools give the skip and the upsampled ``x`` equal rows,
    and anything else raises."""
    if row_shard and skip.shape[2:] != x.shape[2:]:
        raise ValueError(
            f"row shard: a skip of {tuple(skip.shape[2:])} against "
            f"{tuple(x.shape[2:])} upsampled would be cropped per shard")
    return center_crop(skip, (x.shape[2], x.shape[3]))


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> None:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled so the variance is ``1 / fan_in``."""
    # 0.8796… is the std of a unit normal truncated to [-2, 2]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def init_convs_(model: nn.Module,
                generator: Optional[torch.Generator]) -> None:
    """flax's init of every conv in ``model``: lecun-normal kernels, zero
    biases, drawn in module order from ``generator``."""
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
            kh, kw = module.kernel_size
            # flax counts fan-in over (kh, kw, in_features) for both conv
            # kinds; torch stores ConvTranspose as (I, O, kh, kw)
            in_feats = (module.in_channels
                        if isinstance(module, nn.ConvTranspose2d)
                        else module.weight.shape[1])
            lecun_normal_(module.weight, kh * kw * in_feats, generator)
            if module.bias is not None:
                nn.init.zeros_(module.bias)


def take_halo(conv: nn.Module, x: torch.Tensor
              ) -> Tuple[torch.Tensor, bool]:
    """``(x, whether it carries halo rows)`` as ``conv`` runs it. In a
    forward with ``conv.halo`` set (a row shard, ``parallel/spatial.py``)
    the shard's rows with one neighbour row above and below
    (``halo.with_halo``), and what the meeting keeps of them for a
    recompute (``kept_halo``, under ``--remat``). In that recompute
    (``reuse_kept_halo``, set by ``models.recomputing``) the kept rows
    around the recomputed ``x``, without a meeting and whether or not
    ``halo`` is still set; a recompute with nothing kept and ``halo`` set
    meets, and the closed meeting raises. Otherwise ``x`` itself."""
    if getattr(conv, "reuse_kept_halo", False):
        kept = getattr(conv, "kept_halo", None)
        if kept is not None:
            return kept.around(x), True
    elif getattr(conv, "kept_halo", None) is not None:
        conv.kept_halo = None
    if conv.halo is None:
        return x, False
    x = conv.halo.with_halo(x)
    conv.kept_halo = conv.halo.keep(x)
    return x, True


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose float32 weights are cast to the input's dtype.

    ``halo`` is set on a 3×3 conv for the forward of a row shard
    (``parallel/spatial.py``): the shard's rows then come with one
    neighbour row above and below (``take_halo``), and the conv runs
    VALID in H and SAME in W, the whole image's conv on this shard's
    rows. Unset (None) nothing changes."""

    halo = None
    kept_halo = None
    reuse_kept_halo = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        padding = self.padding
        x, halo = take_halo(self, x)
        if halo:
            padding = (0, self.padding[1])
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        padding, self.dilation, self.groups)


class TapsConv2d(Conv2d):
    """A 3×3, padding-1 ``Conv2d`` with the same parameters whose weight
    gradient runs through the 9-tap backward (``conv3x3_same_taps``); the
    forward is the same convolution, on a row shard's halo'd rows with
    ``halo`` set. ``wgrad_cuda`` is the kernel policy's leave for K5
    there."""

    def __init__(self, *args, wgrad_cuda: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        if self.kernel_size != (3, 3) or self.padding != (1, 1):
            raise ValueError("TapsConv2d is a 3x3 conv with padding 1")
        self.wgrad_cuda = wgrad_cuda

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, halo = take_halo(self, x)
        y = conv3x3_same_taps(x, self.weight.to(x.dtype), self.wgrad_cuda,
                              halo=halo)
        if self.bias is None:
            return y
        return y + self.bias.to(y.dtype).view(1, -1, 1, 1)


def conv3x3(in_features: int, features: int, bias: bool = True,
            wgrad_taps: bool = False, wgrad_cuda: bool = False) -> Conv2d:
    """A 3×3, padding-1 conv: ``TapsConv2d`` under ``wgrad_taps``."""
    if wgrad_taps:
        return TapsConv2d(in_features, features, 3, padding=1, bias=bias,
                          wgrad_cuda=wgrad_cuda)
    return Conv2d(in_features, features, 3, padding=1, bias=bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` whose float32 weights are cast to the input's
    dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class ConvBlock(nn.Module):
    """[Conv3×3(pad=1) → ReLU] × 2; parameters at ``conv_block.{0,2}``."""

    def __init__(self, in_features: int, features: int, **taps):
        super().__init__()
        self.conv_block = nn.Sequential(
            conv3x3(in_features, features, **taps),
            nn.ReLU(),
            conv3x3(features, features, **taps),
            nn.ReLU(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_block(x)


class Encoder(nn.Module):
    """Conv blocks with a 2×2 max-pool after each, run level by level
    (``level``) by ``UNet.apply_segment``."""

    def __init__(self, widths: Sequence[int] = ENCODER_WIDTHS, **taps):
        super().__init__()
        in_feats = 3  # RGB
        for i, w in enumerate(widths):
            self.add_module(f"conv{i + 1}", ConvBlock(in_feats, w, **taps))
            in_feats = w

    def level(self, x: torch.Tensor, i: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Encoder level ``i``: conv block + pool → (pooled, skip)."""
        skip = getattr(self, f"conv{i + 1}")(x)
        return F.max_pool2d(skip, 2, 2), skip


class Decoder(nn.Module):
    """Per level (``level``): ConvTranspose(k=2, s=2) → center-crop skip →
    concat ``[skip, up]`` → conv block. ``widths`` run deep to shallow;
    the input is the mid block's ``2 * widths[0]`` channels."""

    def __init__(self, widths: Sequence[int] = tuple(reversed(ENCODER_WIDTHS)),
                 **taps):
        super().__init__()
        logical_in = 2 * widths[0]
        for i, w in enumerate(widths):
            self.add_module(f"deconv{i + 1}",
                            ConvTranspose2d(logical_in, w, 2, stride=2))
            self.add_module(f"conv{i + 1}", ConvBlock(2 * w, w, **taps))
            logical_in = w

    def level(self, x: torch.Tensor, skip: torch.Tensor, i: int
              ) -> torch.Tensor:
        x = getattr(self, f"deconv{i + 1}")(x)
        block = getattr(self, f"conv{i + 1}")
        skip = crop_skip(skip, x, block.conv_block[0].halo is not None)
        return block(torch.cat([skip, x], dim=1))


class UNet(nn.Module):
    """Encoder → mid ConvBlock → Decoder → 1×1 head → float32 sigmoid.

    Input ``(B, H, W, 3)`` float, output ``(B, H, W, n_classes)``
    float32 probabilities. ``generator`` seeds the flax-style init
    (lecun-normal kernels, zero biases). ``wgrad_taps`` builds every 3×3
    conv as a ``TapsConv2d``, with ``wgrad_cuda`` its leave for K5."""

    def __init__(
        self,
        n_classes: int = 1,
        dtype: torch.dtype = torch.bfloat16,
        widths: Sequence[int] = ENCODER_WIDTHS,
        generator: Optional[torch.Generator] = None,
        wgrad_taps: bool = False,
        wgrad_cuda: bool = False,
    ):
        super().__init__()
        self.dtype = dtype
        self.widths = tuple(widths)
        taps = dict(wgrad_taps=wgrad_taps, wgrad_cuda=wgrad_cuda)
        self.encoder = Encoder(self.widths, **taps)
        self.mid = ConvBlock(self.widths[-1], 2 * self.widths[-1], **taps)
        self.decoder = Decoder(tuple(reversed(self.widths)), **taps)
        self.segmap = Conv2d(self.widths[0], n_classes, 1)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        init_convs_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips: Tuple[torch.Tensor, ...] = ()
        for seg in range(self.num_segments):
            x, skips = self.apply_segment(x, skips, seg)
        return x

    # -- pipeline segments (parallel/pipeline.py) ---------------------------
    # The model's linear block order: L encoder levels, the mid block, then
    # L decoder levels with the 1×1 head folded into the last. A pipeline
    # stage is any contiguous run of these 2L+1 segments; the reference's
    # 2-stage cut (unet_model.py:16-20) is the boundary after segment L.
    @property
    def num_segments(self) -> int:
        return 2 * len(self.widths) + 1

    def apply_segment(self, x: torch.Tensor, skips: Tuple[torch.Tensor, ...],
                      seg: int) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """Segment ``seg`` of the linear block order on the carry
        ``(x, skips)``: encoder segments push their skip, decoder segments
        pop the deepest. Segment 0 takes the NHWC input; the last returns
        the NHWC float32 probabilities."""
        n_levels = len(self.widths)
        if seg == 0:
            x = x.permute(0, 3, 1, 2).to(self.dtype)
        if seg < n_levels:
            x, skip = self.encoder.level(x, seg)
            return x, tuple(skips) + (skip,)
        if seg == n_levels:
            return self.mid(x), tuple(skips)
        x = self.decoder.level(x, skips[-1], seg - n_levels - 1)
        if seg == 2 * n_levels:
            x = self._head(x)
        return x, tuple(skips)[:-1]

    def segment_modules(self, seg: int) -> List[nn.Module]:
        """The layers segment ``seg`` runs (a pipeline stage holds them)."""
        n_levels = len(self.widths)
        if seg < n_levels:
            return [getattr(self.encoder, f"conv{seg + 1}")]
        if seg == n_levels:
            return [self.mid]
        i = seg - n_levels
        layers = [getattr(self.decoder, f"deconv{i}"),
                  getattr(self.decoder, f"conv{i}")]
        return layers + ([self.segmap] if seg == 2 * n_levels else [])

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """1×1 head + sigmoid in ``LOSS_DTYPE`` (bf16 resolution near 0/1
        would poison a log-based loss), NHWC out."""
        x = self.segmap(x)
        return torch.sigmoid(x.to(LOSS_DTYPE)).permute(0, 2, 3, 1)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
