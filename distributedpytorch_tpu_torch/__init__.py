"""PyTorch/CUDA port of ``distributedpytorch_tpu``, for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference. It
imports torch and never jax or the JAX package. It trains the UNet on
one device or data-parallel under torchrun (``python -m
distributedpytorch_tpu_torch [-t DDP]``, cli.py) and serves it (``python -m distributedpytorch_tpu_torch serve``), with the
Pallas kernels on those paths written in CUDA C++ (``csrc/``); entry
points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.2.0"
