"""The port's loss, its statistics kernel's plain version and the fused
loss's autograd against the JAX package, on the CPU: the same numpy
inputs through ``distributedpytorch_tpu.ops.losses`` /
``pallas_kernels`` (interpret mode) / ``fused_loss`` and their
counterparts in ``distributedpytorch_tpu_torch``.

Tolerances: values of two float32 reductions that sum in different
orders agree to ~1e-6 relative (``RTOL``); gradients are elementwise
formulas on the same float32 inputs and agree to float rounding of the
few operations around them (``GRAD_RTOL``, with ``GRAD_ATOL`` for the
elements that cancel to ~0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.ops import losses as jl
from distributedpytorch_tpu.ops.fused_loss import (
    fused_bce_dice_loss as jax_fused_loss,
)
from distributedpytorch_tpu.ops.pallas_kernels import eval_stats_pallas
from distributedpytorch_tpu_torch.ops import kernels, losses
from distributedpytorch_tpu_torch.ops.fused_loss import (
    BCEDiceStatsFused,
    fused_bce_dice_loss,
)
from distributedpytorch_tpu_torch.ops.loss_kernels import (
    bce_dice_stats_kernel,
    eval_metrics,
    eval_stats,
    eval_stats_reference,
    stats_bwd,
    stats_bwd_reference,
)

RTOL = 1e-5
GRAD_RTOL = 1e-5
GRAD_ATOL = 1e-7


def _case(shape, seed=0, saturate=True, levels=2):
    """p in [0, 1) with exact 0.0 and 1.0 pixels (the saturated case that
    once NaN'd a real run's gradient) and pixels at 0.5; t in
    ``range(levels)``, so levels > 2 brings values that binarize to 0."""
    rng = np.random.default_rng(seed)
    p = rng.random(shape, dtype=np.float32)
    if saturate:
        flat = p.reshape(-1)
        flat[::7] = 0.0
        flat[3::11] = 1.0
        flat[5::13] = 0.5
    t = rng.integers(0, levels, shape).astype(np.float32)
    return p, t


def _t(x):
    return torch.from_numpy(np.array(x))


# -- ops/losses.py --------------------------------------------------------------


@pytest.mark.parametrize("fn", ["binary_cross_entropy", "soft_dice",
                                "bce_dice_loss", "dice_coefficient"])
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_values_match_jax(fn, seed):
    p, t = _case((2, 8, 12, 1), seed)
    if fn in ("binary_cross_entropy", "soft_dice"):
        t = (t == 1).astype(np.float32)
    want = float(getattr(jl, fn)(jnp.asarray(p), jnp.asarray(t)))
    got = float(getattr(losses, fn)(_t(p), _t(t)))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loss_gradient_matches_jax_grad_with_saturated_pixels(seed):
    """Saturated pixels (p exactly 0 or 1) keep the gradient finite and
    equal to jax.grad's: the grad-safe clamped log in both packages."""
    p, t = _case((2, 8, 12, 1), seed)
    want = np.asarray(jax.grad(jl.bce_dice_loss)(jnp.asarray(p),
                                                 jnp.asarray(t)))
    pt = _t(p).requires_grad_(True)
    losses.bce_dice_loss(pt, _t(t)).backward()
    got = pt.grad.numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_stats_and_loss_from_stats_match_jax():
    p, t = _case((3, 9, 10, 1), 3, levels=3)
    want = np.asarray(jl.bce_dice_stats(jnp.asarray(p), jnp.asarray(t)))
    got = losses.bce_dice_stats(_t(p), _t(t))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    np.testing.assert_allclose(
        float(losses.loss_from_stats(got)),
        float(jl.loss_from_stats(jnp.asarray(want))), rtol=RTOL)
    # the cotangent of the four sums, as grad accumulation takes it
    stats = got.clone().requires_grad_(True)
    losses.loss_from_stats(stats).backward()
    ct = np.asarray(jax.grad(jl.loss_from_stats)(jnp.asarray(want)))
    np.testing.assert_allclose(stats.grad.numpy(), ct, rtol=GRAD_RTOL)


def test_clamped_log_is_grad_safe_and_clamps():
    x = torch.tensor([0.0, 1e-45, 1.1754944e-38, 0.5, 1.0],
                     requires_grad=True)
    y = losses._clamped_log(x)
    want = np.asarray(jl._clamped_log(jnp.asarray(x.detach().numpy())))
    np.testing.assert_array_equal(y.detach().numpy(), want)
    y.sum().backward()
    assert torch.isfinite(x.grad).all()
    assert x.grad[0] == 0 and x.grad[1] == 0


# -- the statistics kernel's plain version (K1) -------------------------------


@pytest.mark.parametrize("shape", [
    (4, 64, 96, 1),   # one partial Pallas tile
    (2, 33, 47, 1),   # ragged
    (1, 1, 5, 1),     # tiny
    (4, 320, 240, 1),  # five Pallas grid blocks
])
def test_eval_stats_reference_matches_pallas_interpret(shape):
    p, t = _case(shape, seed=4, levels=3)
    want = np.asarray(eval_stats_pallas(jnp.asarray(p), jnp.asarray(t),
                                        interpret=True))
    got = eval_stats_reference(_t(p), _t(t)).numpy()
    # the float sums in other orders; count and hard sums are integers
    np.testing.assert_allclose(got[[0, 2, 3]], want[[0, 2, 3]], rtol=RTOL)
    np.testing.assert_array_equal(got[[1, 4, 5]], want[[1, 4, 5]])


def test_wrappers_take_the_plain_version_on_the_cpu():
    p, t = _case((2, 16, 24, 1), seed=5, levels=3)
    ct = torch.tensor([0.5, 3.0, -2.0, 0.25])
    kernels.reset_launches()
    stats = eval_stats(_t(p), _t(t))
    assert torch.equal(stats, eval_stats_reference(_t(p), _t(t)))
    assert torch.equal(bce_dice_stats_kernel(_t(p), _t(t)), stats[:4])
    assert torch.equal(stats_bwd(_t(p), _t(t), ct),
                       stats_bwd_reference(_t(p), _t(t), ct))
    # the plain version is no launch of the kernel
    assert kernels.LAUNCHES["loss_stats"] == 0
    assert kernels.LAUNCHES["loss_stats_bwd"] == 0


def test_eval_metrics_match_jax_loss_and_dice():
    p, t = _case((4, 32, 48, 1), seed=6, saturate=False)
    got = eval_metrics(_t(p), _t(t))
    np.testing.assert_allclose(
        float(got["loss"]),
        float(jl.bce_dice_loss(jnp.asarray(p), jnp.asarray(t))), rtol=RTOL)
    np.testing.assert_allclose(
        float(got["dice"]),
        float(jl.dice_coefficient(jnp.asarray(p), jnp.asarray(t))),
        rtol=RTOL)


# -- the fused loss's autograd (K1 forward, K1-bwd backward) --------------------


@pytest.mark.parametrize("target", ["fused", "plain"])
@pytest.mark.parametrize("case", ["random", "saturated", "empty_target"])
def test_fused_loss_value_and_grad_match_jax(target, case):
    """BCEDiceStatsFused on the CPU against jax.grad of the JAX package's
    fused loss (Pallas in interpret mode, analytic VJP) and of its plain
    loss, as tests/test_pallas.py holds the two JAX ones together."""
    p, t = _case((2, 32, 128, 1), seed=7, saturate=case == "saturated")
    if case == "empty_target":
        t = np.zeros_like(t)
    jax_fn = jax_fused_loss if target == "fused" else jl.bce_dice_loss
    want_loss, want_grad = jax.value_and_grad(jax_fn)(jnp.asarray(p),
                                                      jnp.asarray(t))
    pt = _t(p).requires_grad_(True)
    loss = fused_bce_dice_loss(pt, _t(t))
    loss.backward()
    value = float(loss.detach())
    assert np.isfinite(value)
    np.testing.assert_allclose(value, float(want_loss), rtol=2e-5)
    assert np.isfinite(pt.grad.numpy()).all()
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(want_grad),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_fused_stats_backward_is_the_analytic_vjp():
    """Any cotangent of the four sums, a global one as grad accumulation
    passes, goes through stats_bwd; the count's entry adds nothing."""
    p, t = _case((2, 16, 24, 1), seed=8, levels=3)
    pt = _t(p).requires_grad_(True)
    stats = BCEDiceStatsFused.apply(pt, _t(t))
    ct = torch.tensor([0.3, 7.0, -1.5, 0.125])
    stats.backward(ct)
    want = stats_bwd_reference(_t(p), _t(t), ct * torch.tensor([1, 0, 1, 1]))
    torch.testing.assert_close(pt.grad, want, rtol=0, atol=0)
