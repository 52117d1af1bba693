"""The port on the card: the serve-mask kernel and the loss statistics
kernels against their plain versions, the wrappers' refusals, a small
engine's streams and masks, and a train step under both kernel
policies. Every
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


# -- the loss statistics kernel (K1) and its backward (K1-bwd) -----------------


def _loss_inputs(shape, device, seed=0):
    """p with exact 0.0 / 1.0 pixels, pixels at 0.5 and just below it and
    subnormal ones; t in {0, 1, 255} (255 binarizes to 0)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    p = torch.rand(shape, generator=gen, device=device)
    flat = p.view(-1)
    for start, value in ((0, 0.0), (1, 1.0), (2, 0.5), (3, 0.49999997),
                         (4, 1e-40), (5, 1e-45)):
        flat[start::11] = value
    t = torch.randint(0, 3, shape, generator=gen, device=device).float()
    t[t == 2] = 255.0
    # at least one saturated pixel at any size: p = 0 where t = 1
    t.view(-1)[0] = 1.0
    return p, t


@pytest.mark.parametrize("shape", [(4, 640, 960, 1), (3, 17, 29, 1), (5,)])
def test_loss_stats_kernel_matches_plain_version(cuda_device, shape):
    from distributedpytorch_tpu_torch.ops import loss_kernels as lk

    p, t = _loss_inputs(shape, cuda_device)
    before = kernels.LAUNCHES["loss_stats"]
    got = lk.eval_stats(p, t)
    again = lk.eval_stats(p, t)
    want = lk.eval_stats_reference(p, t)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["loss_stats"] == before + 2
    # float sums in other orders: rel 1e-5; count and hard sums exact
    torch.testing.assert_close(got[[0, 2, 3]], want[[0, 2, 3]], rtol=1e-5,
                               atol=0)
    assert torch.equal(got[[1, 4, 5]], want[[1, 4, 5]])
    assert torch.equal(got, again)  # no atomics: bitwise repeatable


@pytest.mark.parametrize("shape", [(4, 640, 960, 1), (3, 17, 29, 1), (5,)])
def test_loss_stats_backward_kernel_matches_plain_version(cuda_device, shape):
    from distributedpytorch_tpu_torch.ops import loss_kernels as lk

    p, t = _loss_inputs(shape, cuda_device, seed=1)
    ct = torch.randn(4, generator=torch.Generator(device=cuda_device)
                     .manual_seed(2), device=cuda_device)
    before = kernels.LAUNCHES["loss_stats_bwd"]
    got = lk.stats_bwd(p, t, ct)
    want = lk.stats_bwd_reference(p, t, ct)
    bce = lk.stats_bwd(p, t, torch.tensor([1.0, 0.0, 0.0, 0.0],
                                          device=cuda_device))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["loss_stats_bwd"] == before + 2
    assert torch.isfinite(got).all()
    # rounded where the plain version rounds (no fma contraction): rel
    # 1e-6 of the largest gradient is slack
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * float(want.abs().max()))
    tb = t == 1
    saturated = (tb & (p < 1.1754944e-38)) | (~tb & (1.0 - p < 1.1754944e-38))
    assert saturated.any() and not bce[saturated].any()


def test_loss_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    from distributedpytorch_tpu_torch.ops import loss_kernels as lk

    p = torch.rand(4, 8, device=cuda_device)
    t = torch.ones(4, 8, device=cuda_device)
    ct = torch.ones(4, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        lk.eval_stats(p.half(), t)
    with pytest.raises(ValueError, match="contiguous"):
        lk.eval_stats(p.t(), t)
    with pytest.raises(ValueError, match="aligned"):
        lk.eval_stats(p.view(-1)[1:], t.view(-1)[1:])
    with pytest.raises(ValueError, match="float32"):
        lk.stats_bwd(p, t.half(), ct)
    with pytest.raises(ValueError, match="contiguous"):
        lk.stats_bwd(p.t(), t, ct)
    with pytest.raises(ValueError, match="4"):
        lk.stats_bwd(p, t, torch.ones(3, device=cuda_device))
    with pytest.raises(ValueError, match="targets"):
        lk.eval_stats(p, t[:2])


def test_fused_loss_on_the_card_launches_both_kernels(cuda_device):
    from distributedpytorch_tpu_torch.ops.fused_loss import (
        fused_bce_dice_loss,
    )
    from distributedpytorch_tpu_torch.ops.losses import bce_dice_loss

    p, t = _loss_inputs((2, 64, 96, 1), cuda_device, seed=3)
    t[t == 255] = 0.0
    # K1 clamps by max(log p, -100) (the Pallas kernel's rule) and the plain
    # loss by losses._clamped_log, which also sends subnormal p to -100:
    # the two agree everywhere else, exact 0 and 1 included
    p[(p > 0) & (p < 1.1754944e-38)] = 0.0
    kernels.reset_launches()
    pk = p.clone().requires_grad_(True)
    loss = fused_bce_dice_loss(pk, t)
    loss.backward()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["loss_stats"] == 1
    assert kernels.LAUNCHES["loss_stats_bwd"] == 1
    pp = p.clone().requires_grad_(True)
    want = bce_dice_loss(pp, t)
    want.backward()
    torch.testing.assert_close(loss.detach(), want.detach(), rtol=2e-5,
                               atol=0)
    torch.testing.assert_close(pk.grad, pp.grad, rtol=1e-5, atol=1e-7)


def test_train_step_cuda_policy_equals_torch_policy(cuda_device):
    """One float32 step of a small UNet on the card under both kernel
    policies from the same weights and batch: the loss within rel 1e-5
    and the gradients within rel 1e-4 of each tensor's largest."""
    from distributedpytorch_tpu_torch.models.unet import UNet
    from distributedpytorch_tpu_torch.train.steps import make_train_step

    rng = np.random.default_rng(0)
    batch = {
        "image": torch.from_numpy(rng.random((2, 64, 96, 3), np.float32)),
        "mask": torch.from_numpy((rng.random((2, 64, 96)) > 0.6)
                                 .astype(np.int32)),
    }
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    init = UNet(dtype=torch.float32, widths=(8, 16),
                generator=torch.Generator().manual_seed(0)).state_dict()
    grads, losses = {}, {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # float32 convs in float32
    try:
        for fused in (False, True):
            model = UNet(dtype=torch.float32, widths=(8, 16))
            model.load_state_dict(init)
            model.to(cuda_device)
            opt = torch.optim.SGD(model.parameters(), lr=0.0)
            losses[fused] = float(make_train_step(
                model, opt, 2, train_loss_fused=fused)(batch))
            grads[fused] = [p.grad.clone() for p in model.parameters()]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-5)
    for g, h in zip(grads[True], grads[False]):
        torch.testing.assert_close(g, h, rtol=1e-4,
                                   atol=1e-4 * float(h.abs().max()))
