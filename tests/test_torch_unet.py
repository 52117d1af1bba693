"""The PyTorch port's UNet and checkpoint layer against the JAX package:
the same seeded inputs and the same weights (carried across with
``params_from_jax``) through both forwards, in float32 on the CPU."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.checkpoint import (
    export_reference_pth,
    export_reference_state_dict,
)
from distributedpytorch_tpu.models.unet import UNet as JaxUNet
from distributedpytorch_tpu.models.unet import init_unet_params
from distributedpytorch_tpu_torch.checkpoint import (
    load_pth,
    params_from_jax,
    resolve_checkpoint,
    save_pth,
)
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.models import create_model
from distributedpytorch_tpu_torch.models.unet import UNet, center_crop, param_count

# probabilities of two float32 forwards that sum in different orders
ATOL = 1e-5


def _pair(widths, hw, seed=0):
    """A JAX float32 pixel-path UNet with seeded params, and the port's
    UNet carrying the same weights."""
    jax_model = JaxUNet(dtype=jnp.float32, widths=widths, s2d_levels=0)
    params = init_unet_params(jax_model, jax.random.key(seed), input_hw=hw)
    model = UNet(dtype=torch.float32, widths=widths)
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    return jax_model, params, model.eval()


@pytest.mark.parametrize("widths,hw,batch", [
    ((8, 16), (32, 48), 2),
    # full widths: four ConvTranspose levels, the layout flip matters
    ((32, 64, 128, 256), (64, 96), 1),
])
def test_forward_matches_jax(widths, hw, batch):
    jax_model, params, model = _pair(widths, hw)
    x = np.random.default_rng(1).random((batch, *hw, 3), np.float32)
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (batch, *hw, 1)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_stage_split_equals_full_forward():
    """The reference's 2-stage cut, encoder + mid | decoder + head, as
    runs of segments: the carry after segment L feeds the decoder
    segments, and the two halves equal the full forward bit for bit."""
    _jax_model, _params, model = _pair((8, 16), (32, 48))
    x = torch.from_numpy(np.random.default_rng(2).random((1, 32, 48, 3),
                                                         np.float32))
    levels = len(model.widths)
    with torch.no_grad():
        carry = (x, ())
        for seg in range(levels + 1):  # encoder + mid
            carry = model.apply_segment(*carry, seg)
        mid, skips = carry
        assert len(skips) == levels
        for seg in range(levels + 1, model.num_segments):  # decoder + head
            mid, skips = model.apply_segment(mid, skips, seg)
        assert skips == () and torch.equal(mid, model(x))


def test_unflipped_transpose_kernel_breaks_parity():
    """The ConvTranspose flip is load-bearing: without it the port's
    forward drifts far from the JAX one."""
    jax_model, params, model = _pair((8, 16), (32, 48))
    sd = model.state_dict()
    for name in sd:
        if ".deconv" in name and name.endswith("weight"):
            sd[name] = sd[name].flip(-1, -2)
    model.load_state_dict(sd)
    x = np.random.default_rng(3).random((1, 32, 48, 3), np.float32)
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() > 100 * ATOL


def test_full_width_param_count_and_names():
    model = UNet(generator=torch.Generator().manual_seed(0))
    assert param_count(model) == 7_760_097
    jax_names = set(export_reference_state_dict(
        init_unet_params(JaxUNet(dtype=jnp.float32, s2d_levels=0),
                         jax.random.key(0), input_hw=(32, 32))
    ))
    assert set(model.state_dict()) == jax_names


def test_params_from_jax_equals_jax_export():
    _jax_model, params, _model = _pair((8, 16), (32, 48))
    want = export_reference_state_dict(params)
    nested = jax.device_get(params)
    flat = {("encoder", "block1"): nested["encoder"]["block1"],
            **{k: v for k, v in nested.items() if k != "encoder"},
            **{("encoder", k): v for k, v in nested["encoder"].items()
               if k != "block1"}}
    for got in (params_from_jax(nested), params_from_jax(flat)):
        assert set(got) == set(want)
        for name, arr in want.items():
            np.testing.assert_array_equal(got[name].numpy(), arr)


def test_init_is_seeded_lecun_normal():
    a = UNet(widths=(8, 16), generator=torch.Generator().manual_seed(5))
    b = UNet(widths=(8, 16), generator=torch.Generator().manual_seed(5))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    w = UNet(generator=torch.Generator().manual_seed(0)).state_dict()[
        "mid.conv_block.2.weight"]
    # fan-in 3·3·512: std 1/sqrt(4608), truncated at two std
    std = (1.0 / 4608) ** 0.5
    assert abs(float(w.std()) - std) < 0.02 * std
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert not a.state_dict()["segmap.bias"].any()


def test_bf16_policy_computes_bf16_and_returns_f32():
    _jax_model, _params, model32 = _pair((8, 16), (32, 48))
    model = create_model(TrainConfig(model_widths=(8, 16), s2d_levels=0))
    assert model.dtype == torch.bfloat16
    model.load_state_dict(model32.state_dict())
    x = torch.from_numpy(np.random.default_rng(4).random((1, 32, 48, 3),
                                                         np.float32))
    with torch.no_grad():
        got, want = model(x), model32(x)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) < 1e-2


def test_create_model_resolves_s2d_to_pixel_path(caplog):
    with caplog.at_level(logging.INFO):
        model = create_model(TrainConfig(model_widths=(8, 16), s2d_levels=2,
                                         dtype="f32"))
    assert model.dtype == torch.float32
    assert "pixel path" in caplog.text


def test_unknown_model_arch_is_refused():
    with pytest.raises(ValueError, match="unknown model_arch"):
        create_model(TrainConfig(model_arch="resnet"))


def test_center_crop_is_a_centered_slice():
    x = torch.arange(2 * 3 * 6 * 7, dtype=torch.float32).reshape(2, 3, 6, 7)
    out = center_crop(x, (4, 5))
    assert torch.equal(out, x[:, :, 1:5, 1:6])


def test_jax_exported_pth_loads_and_module_prefix_strips(tmp_path):
    _jax_model, params, model = _pair((8, 16), (32, 48))
    path = str(tmp_path / "DDP.pth")
    export_reference_pth(params, path)
    loaded = load_pth(path)
    for name, value in model.state_dict().items():
        torch.testing.assert_close(loaded[name], value, rtol=0, atol=0)
    prefixed = str(tmp_path / "prefixed.pth")
    save_pth({f"module.{k}": v for k, v in loaded.items()}, prefixed)
    assert set(load_pth(prefixed)) == set(loaded)


def test_resolve_checkpoint_rules(tmp_path):
    save_pth({}, str(tmp_path / "DP.pth"))
    assert resolve_checkpoint("DP", str(tmp_path)) == str(tmp_path / "DP.pth")
    assert resolve_checkpoint("DP.pth", str(tmp_path)).endswith("DP.pth")
    with pytest.raises(FileNotFoundError, match="DP.ckpt"):
        resolve_checkpoint("DP.ckpt", str(tmp_path))
    (tmp_path / "MP.ckpt").write_bytes(b"\x00")
    # a native .ckpt resolves first, and loading it names the way out
    path = resolve_checkpoint("MP", str(tmp_path))
    assert path.endswith("MP.ckpt")
    with pytest.raises(ValueError, match="export_reference_pth"):
        load_pth(path)
