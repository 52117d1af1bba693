"""The port's 9-tap conv backward (``ops/conv_backward.py``,
``ops/wgrad_kernels.py``) against the JAX package's: the plain tap
contraction against the Pallas kernel in interpret mode and against
PyTorch's own conv weight gradient, the taps conv's forward and both
gradients against ``jax.grad`` of JAX ``conv3x3_same_taps``, the
``DPT_WGRAD_TAPS_MIN_HW`` gate, and which backend the weight gradient
takes. Inputs are numpy arrays made from seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.ops.conv_backward import (
    conv3x3_same_taps as jax_taps_conv,
)
from distributedpytorch_tpu.ops.wgrad_pallas import wgrad_9tap_pallas
from distributedpytorch_tpu_torch.ops import conv_backward
from distributedpytorch_tpu_torch.ops.wgrad_kernels import (
    wgrad_9tap,
    wgrad_9tap_reference,
)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("b,h,w,cin,cout", [
    (2, 4, 6, 8, 16),     # skinny channels
    (1, 3, 5, 16, 8),     # odd plane, cout < cin
    (2, 5, 8, 128, 128),  # the width K5 engages at
])
def test_plain_wgrad_matches_the_pallas_kernel_and_torch(b, h, w, cin, cout):
    """Against the Pallas kernel (interpret mode) within 1e-5 relative,
    and against ``torch.nn.grad.conv2d_weight`` (float32 on the CPU)
    within 1e-5 of the largest: float32 sums of at most 80 terms per tap
    in three orders."""
    x, dy = _rand((b, h, w, cin), 0), _rand((b, h, w, cout), 1)
    got = wgrad_9tap(torch.from_numpy(x), torch.from_numpy(dy))
    assert got.shape == (3, 3, cin, cout) and got.dtype == torch.float32
    want = np.asarray(wgrad_9tap_pallas(x, dy, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    torch_w = torch.nn.grad.conv2d_weight(
        torch.from_numpy(x).permute(0, 3, 1, 2), (cout, cin, 3, 3),
        torch.from_numpy(dy).permute(0, 3, 1, 2), padding=1)
    np.testing.assert_allclose(
        got.permute(3, 2, 0, 1).numpy(), torch_w.numpy(), rtol=0,
        atol=1e-5 * float(torch_w.abs().max()))


def test_bf16_inputs_sum_in_float32():
    """bf16 x and dy: products exact in float32, so the plain version
    equals its float32 run on the widened inputs bit for bit."""
    x = torch.from_numpy(_rand((1, 4, 5, 16), 2)).to(torch.bfloat16)
    dy = torch.from_numpy(_rand((1, 4, 5, 16), 3)).to(torch.bfloat16)
    got = wgrad_9tap_reference(x, dy)
    assert got.dtype == torch.float32
    assert torch.equal(got, wgrad_9tap_reference(x.float(), dy.float()))


@pytest.mark.parametrize("cin,cout", [(8, 16), (128, 128)])
def test_taps_conv_forward_and_gradients_match_jax(cin, cout, monkeypatch):
    """Forward within 1e-5 of the largest output, dx and dW within 1e-5 of
    their largest (float32 convs summed in other orders). With
    DPT_WGRAD_BACKEND=pallas the JAX side takes its Pallas kernel at 128
    channels (interpret mode) and the port its plain version (CPU)."""
    monkeypatch.setenv("DPT_WGRAD_BACKEND", "pallas")
    b, h, w = 2, 5, 7
    x, k = _rand((b, h, w, cin), 4), 0.1 * _rand((3, 3, cin, cout), 5)
    g = _rand((b, h, w, cout), 6)

    def jax_loss(xx, kk):
        return jnp.sum(jax_taps_conv(xx, kk) * g)

    want_y = np.asarray(jax_taps_conv(x, k))
    want_dx, want_dk = jax.grad(jax_loss, argnums=(0, 1))(x, k)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    tk = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))
                          ).requires_grad_(True)
    y = conv_backward.conv3x3_same_taps(tx, tk, wgrad_cuda=True)
    assert type(y.grad_fn).__name__ == "Conv3x3SameTapsBackward"
    (y * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    for got, ref in (
        (y.detach().permute(0, 2, 3, 1), want_y),
        (tx.grad.permute(0, 2, 3, 1), want_dx),
        (tk.grad.permute(2, 3, 1, 0), want_dk),
    ):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_min_hw_gate_and_its_loud_failure(monkeypatch):
    x = torch.zeros(1, 4, 3, 5, requires_grad=True)  # a 15-pixel plane
    k = torch.zeros(4, 4, 3, 3, requires_grad=True)
    monkeypatch.setenv("DPT_WGRAD_TAPS_MIN_HW", "16")
    plain = conv_backward.conv3x3_same_taps(x, k)
    assert type(plain.grad_fn).__name__ != "Conv3x3SameTapsBackward"
    monkeypatch.setenv("DPT_WGRAD_TAPS_MIN_HW", "15")
    taps = conv_backward.conv3x3_same_taps(x, k)
    assert type(taps.grad_fn).__name__ == "Conv3x3SameTapsBackward"
    monkeypatch.setenv("DPT_WGRAD_TAPS_MIN_HW", "16k")
    with pytest.raises(ValueError, match="DPT_WGRAD_TAPS_MIN_HW"):
        conv_backward.conv3x3_same_taps(x, k)


@pytest.mark.parametrize("backend,cin,cout,device,wgrad_cuda,want", [
    ("pallas", 128, 128, "cuda", True, True),
    ("pallas", 128, 256, "cuda", True, True),
    ("pallas", 64, 128, "cuda", True, False),    # a side under 128
    ("pallas", 128, 64, "cuda", True, False),
    ("einsum", 128, 128, "cuda", True, False),   # the variable's default
    (None, 128, 128, "cuda", True, False),
    ("pallas", 128, 128, "cuda", False, False),  # the policy says no
    ("pallas", 128, 128, "cpu", True, False),    # not on the card
])
def test_backend_takes_the_kernel_only_when_all_four_hold(
        monkeypatch, backend, cin, cout, device, wgrad_cuda, want):
    if backend is None:
        monkeypatch.delenv("DPT_WGRAD_BACKEND", raising=False)
    else:
        monkeypatch.setenv("DPT_WGRAD_BACKEND", backend)
    assert conv_backward.wgrad_uses_kernel(
        cin, cout, torch.device(device), wgrad_cuda) is want


def test_cpu_backward_takes_the_plain_version(monkeypatch):
    """On the CPU the kernel's wrapper is never reached, whatever the
    policy and the variable say."""
    monkeypatch.setenv("DPT_WGRAD_BACKEND", "pallas")
    calls = []
    real = conv_backward.wgrad_9tap_reference

    def spy(x, dy):
        calls.append(tuple(x.shape))
        return real(x, dy)

    monkeypatch.setattr(conv_backward, "wgrad_9tap_reference", spy)
    monkeypatch.setattr(conv_backward, "wgrad_9tap", None)
    x = torch.randn(1, 128, 3, 4, requires_grad=True)
    k = torch.randn(128, 128, 3, 3, requires_grad=True)
    conv_backward.conv3x3_same_taps(x, k, wgrad_cuda=True).sum().backward()
    assert calls == [(1, 3, 4, 128)]
    assert k.grad.shape == (128, 128, 3, 3)
