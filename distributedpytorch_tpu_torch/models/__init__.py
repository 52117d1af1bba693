import logging
from typing import Optional

import torch

from distributedpytorch_tpu_torch.models.milesial import MilesialUNet  # noqa: F401
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
    from distributedpytorch_tpu_torch.ops.precision import get_policy

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
    common = dict(
        dtype=get_policy(config).compute_dtype,
        generator=generator,
        wgrad_taps=bool(getattr(config, "wgrad_taps", False)),
        wgrad_cuda=config_kernel_policy(config).wgrad_cuda,
    )
    if arch == "milesial":
        return MilesialUNet(
            widths=tuple(widths) if widths else MILESIAL_WIDTHS,
            conv_epilogue=conv_epilogue_engaged(config), **common)
    kwargs = {"widths": tuple(widths)} if widths else {}
    return UNet(**kwargs, **common)
