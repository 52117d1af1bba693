"""The port's serve-mask kernel: its plain version against the JAX
package's Pallas kernel (run in interpret mode on the CPU), the wrapper's
device dispatch, and the build's command line. The kernel itself is held
against its plain version on the card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.ops.kernels import (
    sigmoid_threshold_mask as jax_sigmoid_threshold_mask,
)
from distributedpytorch_tpu_torch.ops import _build, kernels
from distributedpytorch_tpu_torch.ops.kernels import (
    get_kernel_policy,
    sigmoid_threshold_mask,
    sigmoid_threshold_mask_reference,
)

SHAPES = [
    (1, 32, 48),   # one bucket row
    (4, 32, 48),   # a full bucket
    (2, 33, 47),   # ragged plane
    (3, 17, 29),   # not a multiple of 4 elements
]


def _probs(shape, seed):
    probs = np.random.default_rng(seed).random(shape).astype(np.float32)
    probs.flat[:: max(1, probs.size // 17)] = 0.5  # exact-threshold pixels
    return probs


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_plain_mask_bit_identical_to_jax(shape, threshold):
    probs = _probs(shape, 7)
    probs.flat[::13] = threshold
    want = np.asarray(jax_sigmoid_threshold_mask(
        jnp.asarray(probs), threshold, interpret=True))
    got = sigmoid_threshold_mask(torch.from_numpy(probs), threshold).numpy()
    assert got.dtype == np.uint8 and got.shape == shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_plain_from_logits_bit_identical_to_jax(shape):
    z = (np.random.default_rng(8).standard_normal(shape) * 4).astype(np.float32)
    z.flat[::11] = 0.0  # sigmoid(0) is exactly the threshold
    want = np.asarray(jax_sigmoid_threshold_mask(
        jnp.asarray(z), 0.5, from_logits=True, interpret=True))
    got = sigmoid_threshold_mask(torch.from_numpy(z), 0.5,
                                 from_logits=True).numpy()
    np.testing.assert_array_equal(got, want)


def test_cpu_tensor_takes_the_plain_version_and_counts_nothing():
    kernels.reset_launches()
    x = torch.from_numpy(_probs((2, 8, 8), 1))
    got = sigmoid_threshold_mask(x, 0.5)
    assert torch.equal(got, sigmoid_threshold_mask_reference(x, 0.5))
    assert kernels.LAUNCHES["serve_mask"] == 0


def test_non_float32_input_promotes_on_cpu():
    x = torch.tensor([0.25, 0.5, 0.75], dtype=torch.float64)
    assert sigmoid_threshold_mask(x, 0.5).tolist() == [0, 255, 255]


def test_kernel_policy_resolution():
    assert get_kernel_policy(None, torch.device("cpu")).name == "torch"
    assert get_kernel_policy(None, torch.device("cuda")).name == "cuda"
    cuda, plain = get_kernel_policy("cuda"), get_kernel_policy("torch")
    assert cuda.serve_mask and cuda.train_loss_fused and cuda.eval_stats_fused
    assert not (plain.serve_mask or plain.train_loss_fused
                or plain.eval_stats_fused)
    policy = get_kernel_policy("torch")
    assert get_kernel_policy(policy) is policy
    with pytest.raises(ValueError, match="unknown kernel policy"):
        get_kernel_policy("pallas")


def test_nvcc_command_targets_hopper(monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "fake-nvcc")
    out = _build.library_path("serve_mask")
    cmd = _build.nvcc_command("serve_mask", out)
    assert cmd[0] == "fake-nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and cmd[-1].endswith("csrc/serve_mask.cu")
    assert out.parent == _build.BUILD_DIR
    assert out.name.startswith("libserve_mask-") and out.suffix == ".so"


def test_every_source_exists_and_names_its_tpu_kernel():
    import re

    assert set(_build.SOURCES) == {"serve_mask", "loss_stats"}
    for name in _build.SOURCES:
        text = _build.source_path(name).read_text()
        # the JAX kernel it replaces, by file and line
        assert re.search(r"distributedpytorch_tpu/ops/\w+\.py:\d+", text)
        assert 'extern "C"' in text


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
