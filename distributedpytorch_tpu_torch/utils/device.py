"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. A CUDA device on a machine without one
    raises — the port never falls back to the CPU unasked; pass
    ``device="cpu"`` for a CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available — the port runs on the card by "
            "default; pass device='cpu' (CLI: --device cpu) for a CPU run"
        )
    return dev


def current_streams(devices: Sequence[torch.device]) -> list:
    """The current stream of each distinct card among ``devices``."""
    return [torch.cuda.current_stream(d)
            for d in dict.fromkeys(torch.device(d) for d in devices)
            if d.type == "cuda"]


@contextlib.contextmanager
def on_streams(streams: Sequence) -> Iterator[None]:
    """``streams`` (one per card) current within the block. Autograd runs
    a node's backward on the thread of its gradients' card, where another
    card's current stream is its default one: a copy between cards there
    would order itself after that stream, outside a CUDA graph's capture,
    which CUDA refuses. A backward that copies between cards runs under
    the streams its forward ran on."""
    with contextlib.ExitStack() as stack:
        for stream in streams:
            stack.enter_context(torch.cuda.stream(stream))
        yield


class _CopyTo(torch.autograd.Function):
    """``x.to(device)`` of each ``x`` across cards, one autograd node,
    whose backward copies each gradient back on the forward's streams
    (``on_streams``)."""

    @staticmethod
    def forward(ctx, device: torch.device, *xs: torch.Tensor):
        ctx.sources = [x.device for x in xs]
        ctx.streams = current_streams(ctx.sources)
        return tuple(x.to(device, non_blocking=True) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        with on_streams(ctx.streams):
            return (None, *[None if g is None
                            else g.to(source, non_blocking=True)
                            for g, source in zip(grads, ctx.sources)])


def copy_all_to(xs: Sequence[torch.Tensor], device: torch.device
                ) -> List[torch.Tensor]:
    """Each of ``xs`` on ``device`` (itself where it lies there already),
    those that move through one copy node whose backward a CUDA graph can
    capture (``_CopyTo``): the pipeline's carries between stages and DP's
    predictions. Its backward runs once the gradients of all its outputs
    are in."""
    device = torch.device(device)
    out = list(xs)
    moving = [i for i, x in enumerate(xs) if x.device != device]
    if moving:
        for i, y in zip(moving, _CopyTo.apply(device,
                                              *[xs[i] for i in moving])):
            out[i] = y
    return out


def copy_to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``copy_all_to`` of one tensor."""
    return copy_all_to([x], device)[0]
