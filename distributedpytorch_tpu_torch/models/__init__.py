import logging
from typing import Optional

import torch

from distributedpytorch_tpu_torch.models.unet import (  # noqa: F401
    ConvBlock,
    Decoder,
    Encoder,
    UNet,
)

logger = logging.getLogger(__name__)


def create_model(config, generator: Optional[torch.Generator] = None):
    """Model factory: ``config.model_arch`` → an ``nn.Module`` on the CPU
    with float32 parameters, computing in the config's precision policy.

    ``s2d_levels`` resolves to 0 whatever it asks for: space-to-depth is a
    TPU layout rewrite of the same function, and the port runs the pixel
    path."""
    from distributedpytorch_tpu_torch.ops.precision import get_policy

    arch = getattr(config, "model_arch", "unet")
    if arch == "milesial":
        raise NotImplementedError(
            "model_arch='milesial' is not ported yet (ROADMAP.md)"
        )
    if arch != "unet":
        raise ValueError(f"unknown model_arch {arch!r} (expected 'unet')")
    if getattr(config, "s2d_levels", -1) != 0:
        logger.info(
            "s2d_levels=%d: space-to-depth is a TPU layout rewrite of the "
            "same function — running the (equivalent) pixel path",
            config.s2d_levels,
        )
    widths = getattr(config, "model_widths", None)
    kwargs = {"widths": tuple(widths)} if widths else {}
    return UNet(dtype=get_policy(config).compute_dtype, generator=generator,
                **kwargs)
