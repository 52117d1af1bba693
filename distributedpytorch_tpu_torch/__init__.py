"""PyTorch/CUDA port of ``distributedpytorch_tpu``, for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference. It
imports torch and never jax or the JAX package. This slice serves the
UNet (``python -m distributedpytorch_tpu_torch serve``) with the
serve-mask kernel written in CUDA C++ (``csrc/serve_mask.cu``); entry
points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
