import contextlib
import logging
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from distributedpytorch_tpu_torch.models.milesial import (  # noqa: F401
    MilesialUNet,
    recomputing,
)
from distributedpytorch_tpu_torch.models.unet import (  # noqa: F401
    ConvBlock,
    Decoder,
    Encoder,
    UNet,
)

logger = logging.getLogger(__name__)


class Rematerialized(torch.nn.Module):
    """``module`` whose forward is recomputed in the backward instead of
    keeping its activations (``torch.utils.checkpoint``, non-reentrant):
    the counterpart of the JAX steps' ``jax.checkpoint`` (steps.py:189,
    :287) and of the pipeline's per-stage remat (pipeline.py:230-276).

    A model that exposes its segments (``num_segments``,
    ``apply_segment``: the UNet's and milesial's levels) is recomputed
    segment by segment: only the carries between segments stay alive, and
    the backward rebuilds one segment's activations at a time. One region
    around the whole forward would rebuild every activation at once at the
    start of the backward, and the step's peak memory would not move. A
    pipeline ``Stage`` is recomputed as one region, as the JAX stage
    functions are. The recompute runs under ``recomputing``, so a
    BatchNorm's running averages move once per step, in the first
    forward, as the functional JAX forward moves them, a DP replica's or
    row shard's BatchNorm normalizes with the moments the replicas met on
    in the first forward instead of meeting again, and a row shard's 3×3
    conv puts the halo rows it kept around its rows (``parallel/spatial``).
    Without grad (eval) it is ``module`` itself. The forward draws no
    random numbers, so no RNG state is saved."""

    def __init__(self, module: torch.nn.Module):
        super().__init__()
        self.module = module

    def _contexts(self):
        return contextlib.nullcontext(), recomputing(self.module)

    def _checkpoint(self, fn, *args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=self._contexts)

    def forward(self, *args):
        if not torch.is_grad_enabled():
            return self.module(*args)
        segments = getattr(self.module, "num_segments", None)
        if segments is None:
            return self._checkpoint(self.module, *args)
        (x,) = args
        skips = ()
        for seg in range(segments):
            x, skips = self._checkpoint(self.module.apply_segment, x, skips,
                                        seg)
        return x


def rematerialized(module: torch.nn.Module, remat: bool) -> torch.nn.Module:
    """``Rematerialized(module)`` under ``remat``, else ``module``."""
    return Rematerialized(module) if remat else module


def create_model(config, generator: Optional[torch.Generator] = None,
                 cast_params: bool = True):
    """Model factory: ``config.model_arch`` → an ``nn.Module`` on the CPU
    with its parameters in the policy's parameter dtype (float32, bf16
    under ``bf16_params``: drawn in float32 and rounded, as the JAX
    policy casts its init; ``cast_params=False`` leaves them float32, for
    a caller that seeds f32 master weights from them first, as the JAX
    ``create_train_state`` does), computing in the policy's compute dtype.

    ``wgrad_taps`` routes every 3×3 conv's weight gradient through the
    9-tap backward, with the kernel policy's ``wgrad_cuda`` as K5's leave;
    milesial's BatchNorm + ReLU takes the epilogue kernels where
    ``ops.kernels.conv_epilogue_engaged`` says so, as in the JAX factory.
    ``s2d_levels`` resolves to 0 whatever it asks for: space-to-depth is a
    TPU layout rewrite of the same function, and the port runs the pixel
    path."""
    from distributedpytorch_tpu_torch.models.milesial import MILESIAL_WIDTHS
    from distributedpytorch_tpu_torch.ops.kernels import (
        config_kernel_policy,
        conv_epilogue_engaged,
    )
    from distributedpytorch_tpu_torch.ops.precision import (
        cast_params_,
        get_policy,
    )

    arch = getattr(config, "model_arch", "unet")
    if arch not in ("unet", "milesial"):
        raise ValueError(
            f"unknown model_arch {arch!r} (expected 'unet' or 'milesial')")
    if getattr(config, "s2d_levels", -1) != 0:
        logger.info(
            "s2d_levels=%d: space-to-depth is a TPU layout rewrite of the "
            "same function — running the (equivalent) pixel path",
            config.s2d_levels,
        )
    widths = getattr(config, "model_widths", None)
    policy = get_policy(config)
    common = dict(
        dtype=policy.compute_dtype,
        generator=generator,
        wgrad_taps=bool(getattr(config, "wgrad_taps", False)),
        wgrad_cuda=config_kernel_policy(config).wgrad_cuda,
    )
    if arch == "milesial":
        model = MilesialUNet(
            widths=tuple(widths) if widths else MILESIAL_WIDTHS,
            conv_epilogue=conv_epilogue_engaged(config), **common)
    else:
        kwargs = {"widths": tuple(widths)} if widths else {}
        model = UNet(**kwargs, **common)
    if cast_params:
        cast_params_(model, policy)
    return model
