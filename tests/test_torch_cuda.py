"""The port on the card: the serve-mask kernel, the loss statistics
kernels, the BatchNorm epilogue kernels and the 9-tap weight-gradient
kernel against their plain versions, the wrappers' refusals, a small
engine's streams and masks, and UNet and milesial train steps under both
kernel policies. Every
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


# -- milesial's BatchNorm epilogue (K2, K3) and the 9-tap wgrad (K5) ---------


def _bn_case(shape, device, seed=0):
    """NCHW bf16 x in channels_last memory with z = x·a + b exactly 0 at
    some pixels (a = b = 0 on channel 0; b = 0 and x = 0 on channel 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b, c, h, w = shape
    x = torch.randn((b, h, w, c), generator=gen, device=device).to(
        torch.bfloat16).permute(0, 3, 1, 2)
    x[:, 1].reshape(-1)[::3] = 0.0
    a = torch.rand(c, generator=gen, device=device) + 0.5
    bias = 0.1 * torch.randn(c, generator=gen, device=device)
    mean = 0.1 * torch.randn(c, generator=gen, device=device)
    a[0] = bias[0] = bias[1] = 0.0
    g = torch.randn(shape, generator=gen, device=device).contiguous(
        memory_format=torch.channels_last)
    return x, a, bias, mean, g


@pytest.mark.parametrize("shape", [(4, 64, 640, 960), (3, 1024, 17, 29),
                                   (2, 6, 5, 7)])
def test_bn_act_kernels_match_plain_versions(cuda_device, shape):
    """K2's y and K3's dx equal the plain versions bit for bit (rounded at
    the same places); K3's channel sums within 1e-5 of each row's largest
    (float32 sums in other orders) and two calls bitwise equal. 6
    channels take the kernels' scalar path."""
    x, a, b, mean, g = _bn_case(shape, cuda_device)
    before = dict(kernels.LAUNCHES)
    y = kernels.bn_act(x, a, b)
    dx, sums = kernels.bn_act_bwd(x, g, a, b, mean)
    dx2, sums2 = kernels.bn_act_bwd(x, g, a, b, mean)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bn_act"] == before["bn_act"] + 1
    assert kernels.LAUNCHES["bn_act_bwd"] == before["bn_act_bwd"] + 2
    assert torch.equal(y, kernels.bn_act_reference(x, a, b))
    dx_want, sums_want = kernels.bn_act_bwd_reference(x, g, a, b, mean)
    assert dx.dtype == torch.bfloat16 and torch.equal(dx, dx_want)
    scale = sums_want.abs().amax(dim=1, keepdim=True)
    assert float(((sums - sums_want).abs() / scale).max()) <= 1e-5
    assert torch.equal(dx, dx2) and torch.equal(sums, sums2)


def test_bn_act_takes_other_layouts_by_an_explicit_copy(cuda_device):
    x, a, b, _mean, _g = _bn_case((2, 16, 5, 7), cuda_device)
    nchw = x.contiguous()  # a plain NCHW layout
    assert not nchw.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(kernels.bn_act(nchw, a, b), kernels.bn_act(x, a, b))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        kernels.bn_act(x.half(), a, b)


@pytest.mark.parametrize("b,h,w,cin,cout,dtype", [
    (4, 40, 60, 128, 128, torch.bfloat16),
    (2, 9, 37, 144, 128, torch.bfloat16),   # ragged plane and a partial tile
    (1, 6, 35, 24, 40, torch.float32),
])
def test_wgrad_kernel_matches_plain_version_and_cudnn(cuda_device, b, h, w,
                                                      cin, cout, dtype):
    """K5 within 1e-4 of the plain version's largest (float32 sums of
    exact products in other orders), within 1e-2 of cuDNN's (which rounds
    its result to the input dtype), and bitwise repeatable."""
    from distributedpytorch_tpu_torch.ops import wgrad_kernels as wk

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((b, h, w, cin), generator=gen, device=cuda_device).to(
        dtype)
    dy = torch.randn((b, h, w, cout), generator=gen, device=cuda_device).to(
        dtype)
    before = kernels.LAUNCHES["wgrad_9tap"]
    got = wk.wgrad_9tap(x, dy)
    again = wk.wgrad_9tap(x, dy)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wgrad_9tap"] == before + 2
    assert torch.equal(got, again)
    want = wk.wgrad_9tap_reference(x, dy)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        lib = torch.nn.grad.conv2d_weight(
            x.permute(0, 3, 1, 2), (cout, cin, 3, 3), dy.permute(0, 3, 1, 2),
            padding=1).float().permute(2, 3, 1, 0)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert float((got - lib).abs().max()) <= 1e-2 * scale


def _milesial_step(cuda_device, policy, batch, init, base):
    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.models import create_model
    from distributedpytorch_tpu_torch.train.steps import make_train_step

    model = create_model(TrainConfig(kernels=policy, **base))
    model.load_state_dict(init)
    model.to(cuda_device)
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    kernels.reset_launches()
    loss = float(make_train_step(model, opt, 2,
                                 train_loss_fused=policy == "cuda")(batch))
    return (loss, dict(kernels.LAUNCHES),
            [p.grad.clone() for p in model.parameters()],
            [b.clone() for n, b in model.named_buffers() if "running" in n])


@pytest.fixture
def milesial_case(cuda_device, monkeypatch):
    """A small float32 milesial with --wgrad-taps (widths 16-128-128, so
    five of its convs reach K5), its initial weights and one batch, with
    DPT_WGRAD_BACKEND=pallas and float32 convs in float32."""
    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.models import create_model

    monkeypatch.setenv("DPT_WGRAD_BACKEND", "pallas")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    rng = np.random.default_rng(0)
    batch = {
        "image": torch.from_numpy(rng.random((2, 32, 48, 3), np.float32)),
        "mask": torch.from_numpy((rng.random((2, 32, 48)) > 0.6)
                                 .astype(np.int32)),
    }
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    base = dict(model_arch="milesial", model_widths=(16, 128, 128),
                wgrad_taps=True, dtype="f32", device="cuda")
    init = create_model(TrainConfig(**base), generator=torch.Generator()
                        .manual_seed(0)).state_dict()
    return batch, init, base


def _rel_l2(got, want):
    return max(float((g - h).norm() / h.norm()) for g, h in zip(got, want))


def test_milesial_step_cuda_policy_equals_torch_policy(cuda_device,
                                                       milesial_case):
    """One float32 step under both kernel policies (K2, K3 and, for five
    convs, K5, against plain BatchNorm and the einsums): the loss within
    rel 1e-5, each gradient within 2e-2 relative L2 and the running
    statistics within 1e-5 of their largest. The policies normalize with
    other associations, so a pixel with z within rounding of 0 may take
    the other side of a ReLU, and a BatchNorm backward spreads that over
    its channel: the gradient bound is that of the full-width comparison
    in chip_smoke.py."""
    batch, init, base = milesial_case
    loss_c, launches, grads_c, stats_c = _milesial_step(
        cuda_device, "cuda", batch, init, base)
    loss_t, _, grads_t, stats_t = _milesial_step(
        cuda_device, "torch", batch, init, base)
    # 10 BatchNorms; K5 takes down1's 128->128, down2's two and up1's
    # 192->128 and 128->128
    assert launches["bn_act"] == 10 and launches["bn_act_bwd"] == 10
    assert launches["wgrad_9tap"] == 5
    np.testing.assert_allclose(loss_c, loss_t, rtol=1e-5)
    assert _rel_l2(grads_c, grads_t) <= 2e-2
    for s, t in zip(stats_c, stats_t):
        torch.testing.assert_close(s, t, rtol=0,
                                   atol=1e-5 * float(t.abs().max()))


def test_milesial_kernels_equal_their_plain_versions_in_place(
        cuda_device, milesial_case, monkeypatch):
    """The same kernels-cuda step twice, the second with every kernel's
    wrapper swapped for its plain version: K2 equals its plain version bit
    for bit, so the forward, the loss's inputs and the running statistics
    are identical; only K1's, K3's and K5's sums run in other orders, so
    the loss agrees within rel 1e-6 and each gradient within 1e-4
    relative L2."""
    from distributedpytorch_tpu_torch.ops import conv_backward, fused_loss
    from distributedpytorch_tpu_torch.ops import loss_kernels as lk
    from distributedpytorch_tpu_torch.ops import wgrad_kernels as wk

    batch, init, base = milesial_case
    loss_k, launches, grads_k, stats_k = _milesial_step(
        cuda_device, "cuda", batch, init, base)
    assert launches["bn_act"] == 10 and launches["wgrad_9tap"] == 5
    monkeypatch.setattr(kernels, "bn_act", kernels.bn_act_reference)
    monkeypatch.setattr(kernels, "bn_act_bwd", kernels.bn_act_bwd_reference)
    monkeypatch.setattr(conv_backward, "wgrad_9tap",
                        wk.wgrad_9tap_reference)
    monkeypatch.setattr(fused_loss, "bce_dice_stats_kernel",
                        lambda p, t: lk.eval_stats_reference(p, t)[:4])
    monkeypatch.setattr(fused_loss, "stats_bwd", lk.stats_bwd_reference)
    loss_p, launches, grads_p, stats_p = _milesial_step(
        cuda_device, "cuda", batch, init, base)
    assert not any(launches.values())
    np.testing.assert_allclose(loss_k, loss_p, rtol=1e-6)
    for s, t in zip(stats_k, stats_p):
        assert torch.equal(s, t)
    assert _rel_l2(grads_k, grads_p) <= 1e-4
