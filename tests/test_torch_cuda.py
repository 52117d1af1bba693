"""The port on the card: the serve-mask kernel against its plain version,
the wrapper's refusals, and a small engine's streams and masks. Every
test carries the ``cuda`` marker and skips without a card; this file
imports nothing of JAX, so the card's machine runs it as it is:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from distributedpytorch_tpu_torch.ops import kernels
from distributedpytorch_tpu_torch.ops.kernels import (
    sigmoid_threshold_mask,
    sigmoid_threshold_mask_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", [(8, 640, 960), (3, 17, 29), (5,)])
def test_kernel_matches_plain_version(cuda_device, shape):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    p = torch.rand(shape, generator=gen, device=cuda_device)
    p.view(-1)[::7] = 0.5
    before = kernels.LAUNCHES["serve_mask"]
    got = sigmoid_threshold_mask(p, 0.5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["serve_mask"] == before + 1
    assert torch.equal(got, sigmoid_threshold_mask_reference(p, 0.5))
    z = torch.randn(shape, generator=gen, device=cuda_device) * 4
    flips = (sigmoid_threshold_mask(z, 0.5, from_logits=True)
             != sigmoid_threshold_mask_reference(z, 0.5, from_logits=True))
    # __expf vs torch.sigmoid: a few ulp, only at the threshold
    assert not (flips & ((torch.sigmoid(z) - 0.5).abs() >= 1e-6)).any()


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    x = torch.rand(4, 8, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        sigmoid_threshold_mask(x.half(), 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        sigmoid_threshold_mask(x.t(), 0.5)
    with pytest.raises(ValueError, match="aligned"):
        sigmoid_threshold_mask(x.view(-1)[1:], 0.5)


def test_engine_masks_on_the_card(cuda_device):
    """A small bf16 engine under both policies: the cuda policy's uint8
    masks equal the torch policy's host threshold away from 0.5, and a
    row padded into a larger bucket keeps its probabilities within 1e-3
    (cuDNN may pick another algorithm per bucket shape)."""
    from distributedpytorch_tpu_torch.models.unet import UNet
    from distributedpytorch_tpu_torch.serve.engine import ServeEngine

    model = UNet(widths=(8, 16), generator=torch.Generator().manual_seed(0))
    common = dict(input_hw=(64, 96), bucket_sizes=(1, 4), device="cuda")
    masked = ServeEngine(model, kernels="cuda", **common)
    plain = ServeEngine(model, kernels="torch", **common)
    batch = np.random.default_rng(0).random((3, 64, 96, 3), np.float32)
    kernels.reset_launches()
    got = masked.infer(batch)
    assert kernels.LAUNCHES["serve_mask"] == 1
    probs = plain.infer(batch)
    assert got.dtype == np.uint8 and probs.dtype == np.float32
    diff = got != plain.postprocess(probs)
    assert not (diff & (np.abs(probs - 0.5) >= 1e-3)).any()
    solo = plain.infer(batch[:1])
    np.testing.assert_allclose(probs[0], solo[0], rtol=0, atol=1e-3)
