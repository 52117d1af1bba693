"""The port's weights-only int8 serving (``ops/quant.py``, the
``quantize`` converter, ``serve --quantize int8``) on the CPU against the
JAX package's (``ops/quant.py``, ``serve.engine.ServeEngine(quantized=
True)``): the same seeded weights give the same int8 values and scales
bit for bit, every transposed conv included, and the same probabilities
through both int8 engines; then the scheme, the resident bytes, the file
format, its auto-detection and the converter on their own."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.checkpoint import (
    export_milesial_pth,
    export_reference_pth,
)
from distributedpytorch_tpu.models.milesial import MilesialUNet as JaxMilesial
from distributedpytorch_tpu.models.milesial import init_milesial
from distributedpytorch_tpu.models.unet import UNet as JaxUNet
from distributedpytorch_tpu.models.unet import init_unet_params
from distributedpytorch_tpu.ops import quant as jquant
from distributedpytorch_tpu.serve.engine import ServeEngine as JaxServeEngine
from distributedpytorch_tpu_torch import quantize as converter
from distributedpytorch_tpu_torch.checkpoint import params_from_jax
from distributedpytorch_tpu_torch.models.milesial import MilesialUNet
from distributedpytorch_tpu_torch.models.unet import UNet
from distributedpytorch_tpu_torch.ops import quant
from distributedpytorch_tpu_torch.serve.engine import engine_from_checkpoint
from distributedpytorch_tpu_torch.serve.infer import load_inference_bundle

SIZE_WH = (48, 32)
HW = (32, 48)
WIDTHS = (8, 16)
BUCKETS = (1, 2, 4)
# two float32 forwards summing in different orders
PROB_ATOL = 1e-5
# masks may differ only where the probability is this close to 0.5
MASK_BAND = 1e-4
ARCHS = ("unet", "milesial")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Per architecture: seeded JAX params (and milesial's statistics)
    exported as a ``.pth`` into one directory, and the JAX model."""
    tmp = tmp_path_factory.mktemp("torch_quant")
    out = {"dir": tmp}
    unet = JaxUNet(dtype=jnp.float32, widths=WIDTHS, s2d_levels=0)
    params = jax.device_get(init_unet_params(unet, jax.random.key(4),
                                             input_hw=HW))
    export_reference_pth(params, str(tmp / "unet.pth"))
    out["unet"] = (unet, params, None)
    mil = JaxMilesial(widths=WIDTHS, dtype=jnp.float32, s2d_levels=0)
    params, stats = jax.device_get(init_milesial(mil, jax.random.key(5),
                                                 input_hw=HW))
    # running statistics away from their init, so the int8 forward is
    # held with statistics that matter
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.5 + rng.random(a.shape) if path[-1].key == "var"
                         else rng.normal(0, 0.1, a.shape)).astype(np.float32),
        stats)
    export_milesial_pth(params, stats, str(tmp / "milesial.pth"))
    out["milesial"] = (mil, params, stats)
    return out


def _port_model(arch, params, stats):
    cls = UNet if arch == "unet" else MilesialUNet
    model = cls(widths=WIDTHS, dtype=torch.float32)
    model.load_state_dict(params_from_jax(params, stats))
    return model.eval()


def _pick(tree, key):
    """A JAX int8 tree with each ``{"q", "scale"}`` leaf replaced by its
    ``key`` (as float32), other leaves as they are."""
    if isinstance(tree, dict) and set(tree) == {"q", "scale"}:
        return np.asarray(tree[key], np.float32)
    if isinstance(tree, dict):
        return {k: _pick(v, key) for k, v in tree.items()}
    return tree


def _engine(models, arch, **kwargs):
    kwargs.setdefault("kernels", "torch")
    return engine_from_checkpoint(
        arch, checkpoint_dir=str(models["dir"]), image_size=SIZE_WH,
        model_arch=arch, model_widths=WIDTHS, s2d_levels=0, dtype="f32",
        bucket_sizes=BUCKETS, device="cpu", **kwargs)


def _rows(n, seed):
    return np.random.default_rng(seed).random((n, *HW, 3), np.float32)


def _quantize_file(models, arch, out):
    return converter.main([
        "-c", str(models["dir"] / f"{arch}.pth"), "--model", arch,
        "--image-size", *map(str, SIZE_WH),
        "--model-widths", *map(str, WIDTHS), "-o", str(out),
        "--device", "cpu",
    ])


@pytest.mark.parametrize("arch", ARCHS)
def test_quantization_equals_jax_bitwise(models, arch):
    """q and scales of every conv equal the JAX ``quantize_tree``'s, laid
    out as torch lays the weight; each ``ConvTranspose2d`` has one scale
    per output channel, its axis 1."""
    _, params, stats = models[arch]
    qtree = jquant.quantize_tree(params)
    # the torch layout of the JAX q and scale: the kernel's own transform
    want_q = params_from_jax(_pick(qtree, "q"), stats)
    want_scale = params_from_jax(_pick(qtree, "scale"), stats)
    twin = quant.quantize_model(_port_model(arch, params, stats))
    convs = {n: m for n, m in twin.named_modules()
             if isinstance(m, quant.QuantizedConv)}
    transposed = [n for n, m in convs.items()
                  if issubclass(m.kind, torch.nn.ConvTranspose2d)]
    assert len(transposed) == len(WIDTHS) - (arch == "milesial")
    assert len(convs) == sum(1 for k in want_q if k.endswith(".weight")
                             and want_q[k].ndim == 4)
    for name, m in convs.items():
        assert m.q.dtype == torch.int8 and m.scale.dtype == torch.float32
        assert torch.equal(m.q, want_q[f"{name}.weight"].to(torch.int8)), name
        assert torch.equal(m.scale, want_scale[f"{name}.weight"]), name
        axis = 1 if name in transposed else 0
        assert m.scale.numel() == m.q.shape[axis] == m.out_channels, name
        assert m.scale.shape[axis] == m.scale.numel()


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_weight_equals_jax_dequantize_bitwise(models, arch):
    """Each quantized conv's weight in bf16, as its forward casts it,
    equals the JAX ``dequantize_tree(..., dtype=bfloat16)`` kernel bit
    for bit: ``q · scale`` in float32 first, then the cast. Dequantizing
    straight in bf16 rounds otherwise, and this model shows it."""
    _, params, stats = models[arch]
    deq = jquant.dequantize_tree(jquant.quantize_tree(params),
                                 dtype=jnp.bfloat16)
    want = params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32)), deq),
        stats)
    twin = quant.quantize_model(_port_model(arch, params, stats))
    straight_differs = False
    for name, m in twin.named_modules():
        if not isinstance(m, quant.QuantizedConv):
            continue
        got = m.weight.to(torch.bfloat16)
        assert torch.equal(got.float(), want[f"{name}.weight"]), name
        straight = m.q.to(torch.bfloat16) * m.scale.to(torch.bfloat16)
        straight_differs |= not torch.equal(straight, got)
    assert straight_differs


def test_rounding_bound_zero_channel_and_floats_left_float():
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(16, 8, 3, 3)).astype(np.float32))
    w[3] = 0.0  # an all-zero output channel
    q, scale = quant.quantize_weight(w, 0)
    assert q.dtype == torch.int8 and scale.shape == (16, 1, 1, 1)
    assert float(((w - q.float() * scale).abs() / scale).max()) <= 0.5
    assert scale[3].item() == 1.0 and not q[3].any()
    assert int(q.abs().max()) == 127
    # per out-channel: a 1e6 spread between two channels uses both ranges
    t = torch.zeros(4, 2, 2, 2)  # ConvTranspose (I, O, kh, kw)
    t[:, 0] = 1000.0
    t[:, 1] = 0.001
    q, scale = quant.quantize_weight(t, 1)
    assert scale.shape == (1, 2, 1, 1)
    assert int(q[:, 0].abs().max()) == int(q[:, 1].abs().max()) == 127
    model = MilesialUNet(widths=WIDTHS, dtype=torch.float32,
                         generator=torch.Generator().manual_seed(0)).eval()
    twin = quant.quantize_model(model)
    assert quant.quantization_error(model, twin) <= 0.5
    floats = model.state_dict()
    for name, value in twin.state_dict().items():
        if name.endswith((".q", ".scale")):
            assert name[: -len(name.rsplit(".", 1)[1])] + "weight" in floats
            continue
        # biases, BatchNorm affine and running statistics stay as they are
        assert value.dtype == floats[name].dtype
        assert torch.equal(value, floats[name]), name
    assert not any(n.endswith("conv_block.0.weight")
                   or n.endswith("double_conv.0.weight")
                   for n in twin.state_dict())


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_engine_matches_the_jax_int8_engine(models, arch):
    jmodel, params, stats = models[arch]
    jax_engine = JaxServeEngine(jmodel, jquant.quantize_tree(params), stats,
                                input_hw=HW, bucket_sizes=BUCKETS,
                                quantized=True)
    engine = _engine(models, arch, quantize="int8")
    assert engine.quantized
    for n in (1, 3, 4):
        batch = _rows(n, 10 + n)
        want = np.asarray(jax_engine.infer(batch))
        got = engine.infer(batch)
        assert got.shape == want.shape == (n, *HW)
        np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)
        diff = engine.postprocess(got) != jax_engine.postprocess(want)
        assert not (diff & (np.abs(want - 0.5) >= MASK_BAND)).any()


@pytest.mark.parametrize("arch", ARCHS)
def test_replica_holds_int8_bytes_and_no_float_weight(models, arch):
    float_engine = _engine(models, arch)
    int8_engine = _engine(models, arch, quantize="int8")
    fmodel = float_engine.replicas[0].model
    qmodel = int8_engine.replicas[0].model
    ratio = quant.module_bytes(qmodel) / quant.module_bytes(fmodel)
    assert ratio < 0.3, ratio
    assert not any(isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))
                   for m in qmodel.modules())
    assert not any(name.endswith("weight") and t.ndim == 4
                   for name, t in qmodel.state_dict().items())
    assert int8_engine.aot_cache_stats == {
        "enabled": False, "dir": None, "hit": 0, "miss": 0, "skew": 0,
        "compiles": 0}


def test_file_round_trip_peek_and_kind(models, tmp_path):
    src = models["dir"] / "milesial.pth"
    twin = quant.quantize_model(_port_model("milesial",
                                            *models["milesial"][1:]))
    path = str(tmp_path / "w.int8.pt")
    quant.save_quantized(path, twin, {
        "source": str(src), "source_sha256": quant.file_sha256(str(src))})
    params, model_state, manifest = quant.load_quantized(path)
    assert manifest["scheme"] == quant.SCHEME
    assert manifest["source_sha256"] == quant.file_sha256(str(src))
    q = params["inc.double_conv.0.weight"]
    assert q["q"].dtype == torch.int8
    assert torch.equal(q["q"], twin.inc.double_conv[0].q)
    assert torch.equal(q["scale"], twin.inc.double_conv[0].scale)
    assert "inc.double_conv.1.running_var" in model_state
    loaded = quant.load_quantized_model(
        MilesialUNet(widths=WIDTHS, dtype=torch.float32), params,
        model_state)
    for (name, a), (_, b) in zip(loaded.state_dict().items(),
                                 twin.state_dict().items()):
        assert torch.equal(a, b), name
    assert quant.peek_quantized(path) == manifest
    # a float .pth is not an int8 file; garbage and a missing path neither
    assert quant.peek_quantized(str(src)) is None
    with pytest.raises(ValueError, match="not an int8 weights file"):
        quant.load_quantized(str(src))
    garbage = tmp_path / "g.bin"
    garbage.write_bytes(b"not a payload at all")
    assert quant.peek_quantized(str(garbage)) is None
    assert quant.peek_quantized(str(tmp_path / "nope")) is None


def test_converter_file_is_detected_and_equals_quantize_on_load(
        models, tmp_path, caplog):
    out = tmp_path / "unet.int8.pt"
    with caplog.at_level(logging.INFO):
        assert _quantize_file(models, "unet", out) == 0
    assert any("max rounding error" in r.getMessage() for r in caplog.records)
    common = dict(image_size=SIZE_WH, model_widths=WIDTHS, dtype="f32")
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        detected = load_inference_bundle(str(out), **common)
    assert detected.quantized
    assert any("int8 weights file" in r.getMessage() for r in caplog.records)
    explicit = load_inference_bundle(str(out), quantize="int8", **common)
    on_load = load_inference_bundle(str(models["dir"] / "unet.pth"),
                                    quantize="int8", **common)
    assert on_load.quantized
    for a, b in zip(on_load.model.state_dict().values(),
                    explicit.model.state_dict().values()):
        assert torch.equal(a, b)
    engine_file = _engine(models, "unet", quantize="int8")
    rows = _rows(4, 3)
    from distributedpytorch_tpu_torch.serve.engine import ServeEngine

    persisted = ServeEngine.from_bundle(explicit, bucket_sizes=BUCKETS,
                                        device="cpu", kernels="torch")
    np.testing.assert_array_equal(
        engine_file.postprocess(engine_file.infer(rows)),
        persisted.postprocess(persisted.infer(rows)))


def test_mismatched_identity_and_int8_source_raise(models, tmp_path):
    out = tmp_path / "milesial.int8.pt"
    assert _quantize_file(models, "milesial", out) == 0
    with pytest.raises(ValueError, match="model_widths"):
        load_inference_bundle(str(out), image_size=SIZE_WH,
                              model_arch="milesial", model_widths=(4,))
    with pytest.raises(ValueError, match="--model"):
        load_inference_bundle(str(out), image_size=SIZE_WH,
                              model_arch="unet", model_widths=WIDTHS)
    # the converter refuses a source that is int8 already
    assert converter.main([
        "-c", str(out), "--model", "milesial",
        "--image-size", *map(str, SIZE_WH),
        "--model-widths", *map(str, WIDTHS), "--device", "cpu",
    ]) == 2
    assert converter.default_output("ck/singleGPU.pth") \
        == "ck/singleGPU.pth.int8.pt"
    assert converter.default_output("ck/singleGPU.pt") \
        == "ck/singleGPU.int8.pt"
