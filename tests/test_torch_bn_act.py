"""The port's BatchNorm + ReLU epilogue (``ops/kernels.fused_bn_act``, K2
and K3's plain versions on the CPU) against the JAX package's
``fused_bn_act`` run in interpret mode, and against the port's own plain
twin under autograd.

Inputs are numpy arrays made from seeds; the JAX side takes them NHWC,
the port NCHW in channels_last memory. Each tolerance is stated where it
is used."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.ops.kernels import fused_bn_act as jax_fused_bn_act
from distributedpytorch_tpu_torch.ops import kernels


def _case(shape, seed=0):
    """NHWC x with a channel whose affine is exactly zero (scale 0, bias
    0) and one whose mean and bias are 0 with x = 0 at some pixels: both
    put z = x·a + b at exactly 0, the ReLU's boundary."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    mean = (0.1 * rng.standard_normal(c)).astype(np.float32)
    var = rng.uniform(0.5, 2.0, c).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    scale[0] = 0.0
    bias[0] = 0.0
    mean[1] = 0.0
    bias[1] = 0.0
    x[..., 1].reshape(-1)[::3] = 0.0
    return x, mean, var, scale, bias


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


# R = B·H·W: 108 and 6,240 rows, neither a multiple of the Pallas kernel's
# 512-row block
SHAPES = [(2, 6, 9, 16), (3, 40, 52, 24)]


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_the_jax_kernel(shape):
    """Within 1e-6 relative: the two fold the affine the same way, but
    XLA's and torch's rsqrt may differ in the last bit."""
    x, mean, var, scale, bias = _case(shape)
    want = np.asarray(jax_fused_bn_act(x, mean, var, scale, bias,
                                       interpret=True))
    tx = _nchw(x)
    assert tx.is_contiguous(memory_format=torch.channels_last)
    before = dict(kernels.LAUNCHES)
    got = kernels.fused_bn_act(tx, *map(torch.from_numpy,
                                        (mean, var, scale, bias)))
    assert kernels.LAUNCHES == before  # the CPU takes the plain version
    assert got.dtype == torch.float32
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    assert (got[..., 0] == 0).all()  # z = 0 exactly: relu gives 0


@pytest.mark.parametrize("shape", SHAPES)
def test_all_five_cotangents_match_jax_grad(shape):
    """dx, dmean, dvar, dscale and dbias against ``jax.grad`` of the JAX
    kernel's custom VJP, each within 1e-5 of its tensor's largest
    (float32 channel sums over up to 6,240 rows, added in other orders).
    At z = 0 both give a zero gradient."""
    x, mean, var, scale, bias = _case(shape, seed=1)
    w = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    want = jax.grad(
        lambda *a: jnp.sum(jax_fused_bn_act(*a, interpret=True) * w),
        argnums=(0, 1, 2, 3, 4),
    )(x, mean, var, scale, bias)
    args = [_nchw(x)] + [torch.from_numpy(v) for v in (mean, var, scale,
                                                        bias)]
    args = [a.clone().requires_grad_(True) for a in args]
    y = kernels.fused_bn_act(*args)
    (y * _nchw(w)).sum().backward()
    for arg, ref, name in zip(args, want, ("x", "mean", "var", "scale",
                                           "bias")):
        got = arg.grad
        if name == "x":
            got = got.permute(0, 2, 3, 1)
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=f"cotangent of {name}")


def test_autograd_function_equals_its_plain_twin():
    """FusedBNAct's closed-form backward against autograd through
    ``fused_bn_act_reference``, with mean and var computed from x so the
    statistics' own gradient reaches x: within 1e-5 of each tensor's
    largest (the twin differentiates the fold; the closed forms sum the
    same terms in another order)."""
    rng = np.random.default_rng(4)
    x = _nchw(rng.standard_normal((2, 5, 7, 12)).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 12).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(12).astype(np.float32))
    w = _nchw(rng.standard_normal((2, 5, 7, 12)).astype(np.float32))
    grads = []
    for fn in (kernels.fused_bn_act, kernels.fused_bn_act_reference):
        leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
        xx, s, b = leaves
        mean = xx.mean(dim=(0, 2, 3))
        var = (xx.square().mean(dim=(0, 2, 3)) - mean.square()).clamp_min(0)
        (fn(xx, mean, var, s, b) * w).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))


def test_plain_backward_pieces():
    """``bn_act_bwd_reference`` by its definition on a small case: dx in
    x's dtype (bf16 here), the two channel sums in float32."""
    rng = np.random.default_rng(5)
    x = _nchw(rng.standard_normal((1, 3, 4, 8)).astype(np.float32)).to(
        torch.bfloat16)
    g = _nchw(rng.standard_normal((1, 3, 4, 8)).astype(np.float32))
    a = torch.from_numpy(rng.uniform(0.5, 1.5, 8).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    mean = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    dx, sums = kernels.bn_act_bwd(x, g, a, b, mean)
    xf = x.float()
    live = (xf * a.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)) > 0
    dz = torch.where(live, g, 0.0)
    assert dx.dtype == torch.bfloat16
    assert torch.equal(dx, (dz * a.view(1, -1, 1, 1)).to(torch.bfloat16))
    assert torch.equal(sums[0], dz.sum(dim=(0, 2, 3)))
    torch.testing.assert_close(
        sums[1], (dz * (xf - mean.view(1, -1, 1, 1))).sum(dim=(0, 2, 3)))
    y = kernels.bn_act(x, a, b)
    assert y.dtype == torch.float32
    assert torch.equal(y > 0, live)
