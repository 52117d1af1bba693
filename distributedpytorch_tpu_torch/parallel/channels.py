"""Conv out-channels sharded over devices: ``-t TP``.

Counterpart of the JAX package's ``TensorParallel`` (strategy.py:
885-909), the ``1xNx1`` point of its mesh engine with the ``channel``
rule (``mesh.state_leaf_spec``, mesh.py:176-200): every conv kernel and
bias whose out-channel axis divides the mesh is split over the ``model``
axis, and GSPMD inserts the collectives where a layer needs every
channel. The port runs that plan by hand in one process, with
``ChannelSharded``:

* each conv and transposed conv whose out-channel count divides n keeps
  n slices of its weight and bias (``ChannelShards``), slice i on
  ``devices[i]``; milesial's BatchNorm keeps the matching slices of its
  scale, bias and running statistics. A layer whose out-channels do not
  divide n (the 1-channel head) stays whole on the first device, and so
  does its BatchNorm. Adam's state then lies with each slice, on its
  device. ``torch.nn.ConvTranspose2d`` stores its weight as (Cin, Cout,
  kh, kw), so its slices are cut on dim 1, where flax keeps out-channels
  last for every kernel;
* between contractions an activation stays a list of channel blocks, in
  channel order, each on its device: ReLU, BatchNorm (K2 and K3 per
  block under ``--kernels cuda``), the 2×2 pools and the skips' center
  crop act on each block where it lies;
* a conv or transposed conv contracts over all its input channels, so
  one autograd node (``_Gather``) first puts the whole activation on
  each device that holds one of its slices. Its backward adds the n
  partial input-gradients of a block in device order on the block's
  device, as ``parallel/replicas._Uses`` adds the replicas' uses, so two
  runs across cards agree bit for bit. The decoder's skip concatenation
  joins the skip's blocks and the upsampled blocks in that one gather;
* every contraction ends in a gather, so one thread issues each layer's
  slices in turn: no thread has to meet another. The launches are
  asynchronous, so slices on several cards overlap. The devices may
  repeat (``[cpu, cpu]`` in the CPU tests, ``[cuda:0, cuda:0]`` on one
  card).

Under ``--wgrad-taps`` a sliced 3×3 conv keeps the whole conv's
out-channel count (``TapsConv2d.whole_out_channels``), so K5 engages at
the convs where it engages on one device, on the shard's whole input and
its slice of dy. A slice that K5 cannot take (bfloat16 with an
out-channel count not a multiple of 16) raises when the model is
sharded; it does not fall back to the plain contraction.

The run control (``parallel/strategy.check_run_control``):

* ``--remat``: ``ChannelSharded`` exposes the model's segments
  (``num_segments``, ``apply_segment``, ``segment_modules``), so
  ``models.Rematerialized`` recomputes it segment by segment, each
  segment re-issuing its slices and gathers in the backward. A slice's
  BatchNorm moments are per channel over the whole (replicated) batch,
  its own: the recompute takes them again from its recomputed input,
  with no meeting, and under ``models.recomputing`` the running
  statistics move once per step;
* ``--steps-per-dispatch K > 1``: one thread issues every slice on the
  caller's current streams, which ``train/steps.MultiStep`` makes the
  graph's, and the gathers' backward copies run on the forward's
  streams, so one CUDA graph captures K whole steps over the slices'
  cards;
* ``--grad-accum``: each chunk runs through the sharded model, and its
  statistics are K1's on the whole predictions on the first device.

``whole_state`` and ``load_whole_state`` concatenate and split the
slices under the reference names, and ``whole_optimizer_state`` and
``sharded_optimizer_state`` do the same for Adam's state (and the f32
masters under ``bf16_params``), so a TP checkpoint is byte for byte the
layout of a singleGPU one, and each loads under the other.
"""

from __future__ import annotations

import copy
import logging
from typing import Dict, List, Mapping, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from distributedpytorch_tpu_torch.models.milesial import (
    BatchNormAct,
    DoubleConv,
    Down,
    MilesialUNet,
    OutConv,
)
from distributedpytorch_tpu_torch.models.unet import (
    ConvBlock,
    TapsConv2d,
    UNet,
    center_crop,
)
from distributedpytorch_tpu_torch.ops.conv_backward import wgrad_uses_kernel
from distributedpytorch_tpu_torch.ops.precision import LOSS_DTYPE
from distributedpytorch_tpu_torch.utils.device import (
    current_streams,
    on_streams,
)

logger = logging.getLogger(__name__)

#: K5's bfloat16 channel multiple (``ops/wgrad_kernels.wgrad_9tap``)
WGRAD_BF16_MULTIPLE = 16


class _Gather(torch.autograd.Function):
    """The channel concatenation of ``parts`` (in order) on each of
    ``devices``, one output per device; the backward adds each part's
    gradient slices of the outputs in device order, on the part's
    device, on the streams the forward ran on (``utils/device.on_streams``:
    autograd runs it on one card's thread, where another card's current
    stream is its default one, outside a CUDA graph's capture)."""

    @staticmethod
    def forward(ctx, devices, *parts):
        ctx.sources = [p.device for p in parts]
        ctx.sizes = [p.shape[1] for p in parts]
        ctx.streams = current_streams(ctx.sources + list(devices))
        return tuple(torch.cat([p.to(d, non_blocking=True) for p in parts],
                               dim=1) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        sums: List = [None] * len(ctx.sources)
        with on_streams(ctx.streams):
            for g in grads:
                if g is None:
                    continue
                for k, piece in enumerate(g.split(ctx.sizes, dim=1)):
                    piece = piece.to(ctx.sources[k], non_blocking=True)
                    sums[k] = piece if sums[k] is None else sums[k] + piece
        return (None, *sums)


def gather(parts: Sequence[torch.Tensor], devices: Sequence[torch.device]
           ) -> List[torch.Tensor]:
    """The whole activation whose channel blocks are ``parts`` on each of
    ``devices``: ``parts[0]`` itself where it is the only block and
    already lies on the only device."""
    if len(parts) == 1 and len(devices) == 1 and parts[0].device == devices[0]:
        return [parts[0]]
    return list(_Gather.apply(list(devices), *parts))


def _out_dim(layer: nn.Module) -> int:
    """The axis of ``layer.weight`` that holds its out-channels."""
    return 1 if isinstance(layer, nn.ConvTranspose2d) else 0


def out_channels(layer: nn.Module) -> int:
    return layer.weight.shape[_out_dim(layer)]


def _slice(layer: nn.Module, i: int, pieces: int) -> nn.Module:
    """Slice ``i`` of ``pieces`` of ``layer``'s out-channels: a copy of the
    layer whose weight, bias (and BatchNorm running statistics) are that
    slice."""
    dim = _out_dim(layer)
    part = copy.deepcopy(layer)
    if pieces == 1:
        return part
    with torch.no_grad():
        for name, p in layer.named_parameters(recurse=False):
            axis = dim if name == "weight" else 0
            setattr(part, name, nn.Parameter(
                p.chunk(pieces, axis)[i].clone(),
                requires_grad=p.requires_grad))
        for name in ("running_mean", "running_var"):
            b = getattr(layer, name, None)
            if b is not None:
                setattr(part, name, b.chunk(pieces)[i].clone())
    if isinstance(part, (nn.Conv2d, nn.ConvTranspose2d)):
        part.out_channels = out_channels(layer) // pieces
    if isinstance(part, TapsConv2d):
        part.whole_out_channels = out_channels(layer)
    return part


def check_wgrad_slice(layer: nn.Module, pieces: int, device: torch.device,
                      dtype: torch.dtype) -> None:
    """Raise where ``layer``'s weight gradient runs through K5 on
    ``device`` and a slice of ``pieces`` is one K5 cannot take."""
    if not isinstance(layer, TapsConv2d) or pieces == 1:
        return
    cout = out_channels(layer)
    if not wgrad_uses_kernel(layer.in_channels, cout, device,
                             layer.wgrad_cuda):
        return
    if dtype == torch.bfloat16 and (cout // pieces) % WGRAD_BF16_MULTIPLE:
        raise ValueError(
            f"-t TP: a {layer.in_channels} → {cout} conv over {pieces} "
            f"devices leaves {cout // pieces} out-channels a slice, and K5 "
            f"(--wgrad-taps, DPT_WGRAD_BACKEND=pallas) takes bfloat16 "
            f"slices in multiples of {WGRAD_BF16_MULTIPLE} — use a device "
            f"count that leaves such slices, or another wgrad backend")


class ChannelShards(nn.Module):
    """One layer of a ``ChannelSharded`` model: its out-channel slices,
    slice i on ``devices[i]`` (``shards``), or the layer whole on the
    first device where its out-channels do not divide the devices. A conv
    gathers its input (``gather``) onto the devices of its slices; a
    BatchNorm normalizes each block where it lies."""

    def __init__(self, layer: nn.Module, devices: Sequence[torch.device],
                 dtype: torch.dtype):
        super().__init__()
        n = len(devices)
        c = out_channels(layer)
        pieces = n if n > 1 and c % n == 0 else 1
        self.devices = list(devices[:pieces])
        self.contracts = not isinstance(layer, BatchNormAct)
        check_wgrad_slice(layer, pieces, self.devices[0], dtype)
        self.shards = nn.ModuleList(
            _slice(layer, i, pieces).to(d) for i, d in enumerate(self.devices))
        self.dims = {name: (_out_dim(layer) if name == "weight" else 0)
                     for name, _ in layer.named_parameters(recurse=False)}

    @property
    def sharded(self) -> bool:
        return len(self.shards) > 1

    def forward(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.contracts:
            parts = gather(parts, self.devices)
        elif len(parts) != len(self.shards):
            raise ValueError(
                f"a BatchNorm of {len(self.shards)} slices got "
                f"{len(parts)} channel blocks")
        return [shard(p) for shard, p in zip(self.shards, parts)]

    # -- the whole layer's tensors ------------------------------------------
    def whole_tensors(self) -> Dict[str, Tuple[List[torch.Tensor], int]]:
        """``{name: (slices, axis)}`` of every parameter and buffer of the
        layer, under its own names, in ``state_dict`` order."""
        out = {}
        first = self.shards[0]
        # by attribute, not named_parameters: under ZeRO
        # (``parallel/zero.py``) the slices' parameters are attributes
        for name, axis in self.dims.items():
            out[name] = ([getattr(s, name) for s in self.shards], axis)
        for name, _ in first.named_buffers(recurse=False):
            out[name] = ([getattr(s, name) for s in self.shards], 0)
        return out


def _run(module: nn.Module, parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """``module``'s forward on an activation held as channel blocks."""
    if isinstance(module, ChannelShards):
        return module(parts)
    if isinstance(module, nn.Sequential):
        for child in module:
            parts = _run(child, parts)
        return parts
    if isinstance(module, ConvBlock):
        return _run(module.conv_block, parts)
    if isinstance(module, DoubleConv):
        return _run(module.double_conv, parts)
    if isinstance(module, Down):
        return _run(module.maxpool_conv, parts)
    if isinstance(module, OutConv):
        return _run(module.conv, parts)
    if isinstance(module, (nn.ReLU, nn.Identity, nn.MaxPool2d)):
        return [module(p) for p in parts]
    raise TypeError(f"-t TP: no channel-block forward for "
                    f"{type(module).__name__}")


def _crop(skip: List[torch.Tensor], like: torch.Tensor) -> List[torch.Tensor]:
    return [center_crop(s, (like.shape[2], like.shape[3])) for s in skip]


def _whole_on_first(parts: List[torch.Tensor], device: torch.device
                    ) -> torch.Tensor:
    return gather(parts, [device])[0]


def _unet_segment(model: UNet, x, skips: tuple, seg: int,
                  device: torch.device):
    """``UNet.apply_segment`` on channel blocks: the carry's ``x`` is the
    NHWC batch into segment 0, the NHWC float32 predictions on ``device``
    out of the last and a list of channel blocks in between; each skip
    is one too."""
    levels = len(model.widths)
    if seg == 0:
        x = [x.permute(0, 3, 1, 2).to(model.dtype)]
    if seg < levels:
        skip = _run(getattr(model.encoder, f"conv{seg + 1}"), x)
        return [F.max_pool2d(p, 2, 2) for p in skip], skips + (skip,)
    if seg == levels:
        return _run(model.mid, x), skips
    i = seg - levels
    up = _run(getattr(model.decoder, f"deconv{i}"), x)
    x = _run(getattr(model.decoder, f"conv{i}"), _crop(skips[-1], up[0]) + up)
    if seg == 2 * levels:
        y = _whole_on_first(_run(model.segmap, x), device)
        x = torch.sigmoid(y.to(LOSS_DTYPE)).permute(0, 2, 3, 1)
    return x, skips[:-1]


def _milesial_segment(model: MilesialUNet, x, skips: tuple, seg: int,
                      device: torch.device):
    """``MilesialUNet.apply_segment`` on channel blocks, with
    ``_unet_segment``'s carry."""
    levels = len(model.widths) - 1
    if seg == 0:
        x = _run(model.inc, [x.permute(0, 3, 1, 2).to(model.dtype)])
        return x, skips + (x,)
    if seg <= levels:
        x = _run(getattr(model, f"down{seg}"), x)
        return x, (skips + (x,) if seg < levels else skips)
    up = getattr(model, f"up{seg - levels}")
    upsampled = _run(up.up, x)
    x = _run(up.conv, _crop(skips[-1], upsampled[0]) + upsampled)
    if seg == 2 * levels:
        y = _whole_on_first(_run(model.outc, x), device).to(LOSS_DTYPE)
        if model.n_classes == 1:
            y = torch.sigmoid(y)
        x = y.permute(0, 2, 3, 1)
    return x, skips[:-1]


def _sharded_layers(model: nn.Module) -> List[Tuple[nn.Module, str, nn.Module]]:
    """``(parent, name, layer)`` of every conv, transposed conv and
    BatchNorm of ``model``, in module order."""
    kinds = (nn.Conv2d, nn.ConvTranspose2d, BatchNormAct)
    return [(parent, name, child)
            for parent in model.modules()
            for name, child in parent.named_children()
            if isinstance(child, kinds)]


class ChannelSharded(nn.Module):
    """``model`` (the UNet or milesial) with its layers' out-channels split
    over ``devices``, as the module docstring says. It takes the NHWC
    batch on the first device and returns the whole NHWC predictions
    there."""

    def __init__(self, model: nn.Module, devices: Sequence[torch.device]):
        super().__init__()
        if not isinstance(model, (UNet, MilesialUNet)):
            raise TypeError(f"-t TP shards the UNet or milesial, not "
                            f"{type(model).__name__}")
        self.devices = [torch.device(d) for d in devices]
        self.is_stateful = bool(getattr(model, "is_stateful", False))
        self._names = list(model.state_dict())
        self._param_names = [n for n, _ in model.named_parameters()]
        dtype = model.dtype
        layers = _sharded_layers(model)
        # the reference name of each layer, before it is replaced
        path = {id(m): name for name, m in model.named_modules()}
        self._layer_names = []
        model.to(self.devices[0])
        for parent, name, layer in layers:
            shards = ChannelShards(layer, self.devices, dtype)
            self._layer_names.append(path[id(layer)])
            parent._modules[name] = shards
        self.model = model
        self._slices = self._find_param_slices()
        self._num_slices = sum(1 for _ in self.parameters())
        if not any(s.sharded for _, s in self.layers()):
            logger.warning(
                "TP: no parameter axis divides the %d-device mesh — state "
                "is fully replicated and every device computes the whole "
                "model (no parallel speedup or memory saving). Use a "
                "device count that divides the channel widths.",
                len(self.devices))

    def layers(self) -> List[Tuple[str, ChannelShards]]:
        """``(reference name, layer)`` of every sharded layer."""
        return [(name, self.model.get_submodule(name))
                for name in self._layer_names]

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x, skips = images, ()
        for seg in range(self.num_segments):
            x, skips = self.apply_segment(x, skips, seg)
        return x

    # -- the model's segments, on channel blocks -------------------------------
    # ``models.Rematerialized`` recomputes them one at a time under
    # --remat, each re-issuing its slices and gathers
    @property
    def num_segments(self) -> int:
        return self.model.num_segments

    def apply_segment(self, x, skips, seg: int):
        """The model's segment ``seg`` on the carry ``(x, skips)``
        (``_unet_segment``)."""
        fn = (_unet_segment if isinstance(self.model, UNet)
              else _milesial_segment)
        return fn(self.model, x, tuple(skips), seg, self.devices[0])

    def segment_modules(self, seg: int) -> List[nn.Module]:
        return self.model.segment_modules(seg)

    # -- whole tensors under the reference names ------------------------------
    def _layout(self) -> Dict[str, Tuple[List[torch.Tensor], int]]:
        """``{reference name: (slices, axis)}`` of every tensor of the
        model's state dict."""
        out = {}
        for prefix, layer in self.layers():
            for name, entry in layer.whole_tensors().items():
                out[f"{prefix}.{name}"] = entry
        return out

    def whole_state(self) -> Dict[str, torch.Tensor]:
        """The singleGPU model's state dict: each slice set concatenated on
        the host under the reference name, in the reference order."""
        layout = self._layout()
        out = {}
        for name in self._names:
            slices, axis = layout[name]
            if slices[0].dim() == 0:  # num_batches_tracked: equal
                out[name] = slices[0].detach().cpu()
            else:
                out[name] = torch.cat([s.detach().cpu() for s in slices],
                                      axis)
        return out

    @torch.no_grad()
    def load_whole_state(self, state: Mapping[str, torch.Tensor]) -> None:
        """The inverse of ``whole_state``: every reference tensor split into
        its slices, each copied onto its device."""
        layout = self._layout()
        missing = [n for n in self._names if n not in state]
        unexpected = [n for n in state if n not in layout]
        if missing or unexpected:
            raise RuntimeError(f"-t TP state dict: missing {missing}, "
                               f"unexpected {unexpected}")
        for name in self._names:
            slices, axis = layout[name]
            whole = state[name]
            pieces = ([whole] * len(slices) if whole.dim() == 0
                      else whole.chunk(len(slices), axis))
            for s, piece in zip(slices, pieces):
                s.copy_(piece)

    def whole_param_names(self) -> List[str]:
        """The singleGPU model's parameter names, in its order."""
        return list(self._param_names)

    def _find_param_slices(self) -> List[Tuple[List[int], int]]:
        """For each whole parameter, in the singleGPU order: the indices of
        its slices among ``self.parameters()`` and their axis. Kept as
        built (``_slices``): ZeRO takes the slices out of the modules."""
        index = {p: j for j, p in enumerate(self.parameters())}
        layout = self._layout()
        return [([index[s] for s in layout[name][0]], layout[name][1])
                for name in self._param_names]

    def slice_values(self, whole: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
        """Values of the whole parameters (in the singleGPU order) → one per
        slice, in ``self.parameters()`` order."""
        out: List = [None] * self._num_slices
        for (js, axis), value in zip(self._slices, whole):
            for j, piece in zip(js, value.chunk(len(js), axis)):
                out[j] = piece
        return out

    def whole_values(self, sliced: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
        """The inverse of ``slice_values``: host tensors."""
        return [torch.cat([sliced[j].detach().cpu() for j in js], axis)
                for js, axis in self._slices]

    def whole_optimizer_state(self, state: Mapping) -> dict:
        """An optimizer state dict over the slices (Adam's, or under
        ``bf16_params`` the master weights' ``{"master", "inner"}``) as
        the singleGPU optimizer's: one param group, each moment whole on
        the host."""
        if "master" in state:
            return {"master": self.whole_values(state["master"]),
                    "inner": self.whole_optimizer_state(state["inner"])}
        slots = state["state"]
        out = {}
        for k, (js, axis) in enumerate(self._slices):
            if not all(j in slots for j in js):
                continue
            entry = dict(slots[js[0]])
            for key, value in slots[js[0]].items():
                if isinstance(value, torch.Tensor) and value.dim() > 0:
                    entry[key] = torch.cat(
                        [slots[j][key].detach().cpu() for j in js], axis)
            out[k] = entry
        settings = {k: v for k, v in state["param_groups"][0].items()
                    if k != "params"}
        return {"state": out, "param_groups": [
            {**settings, "params": list(range(len(self._param_names)))}]}

    def sharded_optimizer_state(self, state: Mapping) -> dict:
        """The inverse of ``whole_optimizer_state``: one param group over
        the slices in ``self.parameters()`` order, which
        ``ops/optim.load_optimizer_state`` cuts as the optimizer's
        groups."""
        if "master" in state:
            return {"master": self.slice_values(state["master"]),
                    "inner": self.sharded_optimizer_state(state["inner"])}
        slots = state["state"]
        out = {}
        for k, (js, axis) in enumerate(self._slices):
            if k not in slots:
                continue
            for i, j in enumerate(js):
                entry = dict(slots[k])
                for key, value in slots[k].items():
                    if isinstance(value, torch.Tensor) and value.dim() > 0:
                        entry[key] = value.chunk(len(js), axis)[i]
                out[j] = entry
        settings = {k: v for k, v in state["param_groups"][0].items()
                    if k != "params"}
        return {"state": out, "param_groups": [
            {**settings,
             "params": list(range(self._num_slices))}]}
