"""The port's offline inference (``predict.py``) on the CPU against the
JAX package's ``run_prediction`` on the same exported ``.pth`` and the
same image files; then against the port's own server (one 4-file request
against ``predict -b 4``), on an int8 file, and the bundle loader's
native ``.pt``, its bf16 weights and ``--quantize`` in ``ServeConfig``."""

import dataclasses
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import distributedpytorch_tpu.predict as jax_predict
from distributedpytorch_tpu.checkpoint import export_reference_pth
from distributedpytorch_tpu.models import create_model as jax_create_model
from distributedpytorch_tpu.models.unet import UNet as JaxUNet
from distributedpytorch_tpu.models.unet import init_unet_params
from distributedpytorch_tpu.serve.engine import ServeEngine as JaxServeEngine
from distributedpytorch_tpu_torch import predict
from distributedpytorch_tpu_torch import quantize as converter
from distributedpytorch_tpu_torch.checkpoint import (
    NATIVE_FORMAT,
    load_pth,
    write_payload,
)
from distributedpytorch_tpu_torch.serve import cli as serve_cli
from distributedpytorch_tpu_torch.serve.engine import engine_from_checkpoint
from distributedpytorch_tpu_torch.serve.infer import (
    load_image,
    load_inference_bundle,
)
from distributedpytorch_tpu_torch.serve.server import Server

SIZE_WH = (48, 32)
HW = (32, 48)
WIDTHS = (8, 16)
# masks may differ only where the probability is this close to 0.5
MASK_BAND = 1e-4
# inputs that differ only by extension keep it in their output name
FILES = ("car0.png", "car1.jpg", "car1.png", "car2.png", "car3.jpeg")
OUT_STEMS = ("car0", "car1_jpg", "car1_png", "car2", "car3")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A seeded JAX UNet exported as ``unet.pth``, five image files of
    another size (predict resizes them) and four of them in a directory
    of their own."""
    tmp = tmp_path_factory.mktemp("torch_predict")
    model = JaxUNet(dtype=jnp.float32, widths=WIDTHS, s2d_levels=0)
    params = jax.device_get(init_unet_params(model, jax.random.key(6),
                                             input_hw=HW))
    export_reference_pth(params, str(tmp / "unet.pth"))
    images, four = tmp / "images", tmp / "four"
    images.mkdir()
    four.mkdir()
    rng = np.random.default_rng(0)
    for i, name in enumerate(FILES):
        img = Image.fromarray((rng.random((40, 60, 3)) * 255).astype(np.uint8))
        img.save(images / name)
        if i < 4:
            img.save(four / name)
    return {"dir": tmp, "images": images, "four": four, "model": model,
            "params": params}


def _common(setup):
    return dict(checkpoint_dir=str(setup["dir"]), image_size=SIZE_WH,
                model_widths=WIDTHS)


def _masks(paths):
    return [np.asarray(Image.open(p)) for p in paths]


def test_run_prediction_matches_the_jax_run_prediction(setup, tmp_path,
                                                       monkeypatch):
    """Batch 2 over five files (two full batches and a ragged one), both
    in float32: each ``run_prediction`` computes in its policy's bf16, so
    the JAX bundle's model is rebuilt with ``compute_dtype="float32"``
    (the JAX TrainConfig's own override) and the port's bundle is loaded
    with ``dtype="f32"``, for a float32 comparison."""
    original = jax_predict.load_inference_bundle

    def f32_bundle(*args, **kwargs):
        bundle = original(*args, **kwargs)
        cfg = dataclasses.replace(bundle.config, compute_dtype="float32")
        return dataclasses.replace(bundle, model=jax_create_model(cfg)[0])

    def port_f32_bundle(*args, **kwargs):
        return load_inference_bundle(*args, **{**kwargs, "dtype": "f32"})

    monkeypatch.setattr(jax_predict, "load_inference_bundle", f32_bundle)
    monkeypatch.setattr(predict, "load_inference_bundle", port_f32_bundle)
    want = jax_predict.run_prediction(
        "unet", str(setup["images"]), str(tmp_path / "jax"), batch_size=2,
        **_common(setup))
    got = predict.run_prediction(
        "unet", str(setup["images"]), str(tmp_path / "port"), batch_size=2,
        device="cpu", **_common(setup))
    assert [os.path.basename(p) for p in got] \
        == [os.path.basename(p) for p in want] \
        == [f"{stem}_mask.png" for stem in OUT_STEMS]
    rows = np.stack([load_image(str(setup["images"] / f), SIZE_WH)
                     for f in FILES])
    jax_engine = JaxServeEngine(setup["model"], setup["params"], None,
                                input_hw=HW, bucket_sizes=(8,))
    probs = np.asarray(jax_engine.infer(rows))
    for prob, a, b in zip(probs, _masks(got), _masks(want)):
        assert a.shape == HW and a.dtype == np.uint8
        assert set(np.unique(a)) <= {0, 255}
        diff = a != b
        assert not (diff & (np.abs(prob - 0.5) >= MASK_BAND)).any()


def test_output_stems_keep_colliding_extensions():
    assert predict.output_stems(FILES) == list(OUT_STEMS)
    assert predict.output_stems(["a.png", "b.png"]) == ["a", "b"]


def test_viz_panels(setup, tmp_path):
    pytest.importorskip("matplotlib")
    predict.run_prediction("unet", str(setup["four"]), str(tmp_path),
                           save_viz=True, device="cpu", **_common(setup))
    vizzes = sorted(f for f in os.listdir(tmp_path) if f.endswith("_viz.png"))
    assert vizzes == [f"{s}_viz.png" for s in OUT_STEMS[:4]]


def test_missing_checkpoint_and_empty_directory_raise(setup, tmp_path):
    with pytest.raises(FileNotFoundError):
        predict.run_prediction("nope", str(setup["four"]), str(tmp_path),
                               device="cpu", **_common(setup))
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "notes.txt").write_text("not an image")
    with pytest.raises(RuntimeError, match="No input images"):
        predict.run_prediction("unet", str(empty), str(tmp_path / "o"),
                               device="cpu", **_common(setup))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            predict.run_prediction("unet", str(setup["four"]),
                                   str(tmp_path / "o"), **_common(setup))


def test_a_four_file_request_equals_predict_b4(setup, tmp_path):
    """The server answers one request of the four files with the masks
    ``predict -b 4`` writes for them, bit for bit: one batch shape, one
    dtype (the serve engine's bf16), the same forward."""
    out = tmp_path / "pred"
    assert predict.main([
        "-c", "unet", "-i", str(setup["four"]), "-o", str(out), "-b", "4",
        "--checkpoint-dir", str(setup["dir"]),
        "--image-size", *map(str, SIZE_WH),
        "--model-widths", *map(str, WIDTHS), "--device", "cpu",
    ]) == 0
    engine = engine_from_checkpoint("unet", device="cpu", **_common(setup))
    server = Server(engine).start()
    try:
        resp = server.submit(
            [str(setup["four"] / f) for f in FILES[:4]]).result(60)
    finally:
        server.stop()
    assert resp.ok, resp.reason
    for stem, served in zip(OUT_STEMS, resp.masks):
        np.testing.assert_array_equal(
            np.asarray(Image.open(out / f"{stem}_mask.png")), served)


def test_an_int8_file_through_predict(setup, tmp_path):
    int8 = tmp_path / "unet.int8.pt"
    assert converter.main([
        "-c", str(setup["dir"] / "unet.pth"),
        "--image-size", *map(str, SIZE_WH),
        "--model-widths", *map(str, WIDTHS), "-o", str(int8),
        "--device", "cpu",
    ]) == 0
    written = predict.run_prediction(
        str(int8), str(setup["four"]), str(tmp_path / "out"), batch_size=4,
        device="cpu", **_common(setup))
    engine = engine_from_checkpoint(str(int8), device="cpu",
                                    bucket_sizes=(4,), **_common(setup))
    assert engine.quantized
    rows = np.stack([engine.preprocess(str(setup["four"] / f))
                     for f in FILES[:4]])
    want = engine.postprocess(engine.infer(rows))
    for got, mask in zip(_masks(written), want):
        np.testing.assert_array_equal(got, mask)


def test_quantize_flag_maps_into_serve_config(setup):
    argv = ["-c", "unet", "--checkpoint-dir", str(setup["dir"]),
            "--image-size", *map(str, SIZE_WH),
            "--model-widths", *map(str, WIDTHS), "--device", "cpu",
            "--buckets", "1", "2"]
    assert serve_cli.to_config(serve_cli.get_args(argv)).quantize is None
    args = serve_cli.get_args(argv + ["--quantize", "int8"])
    cfg = serve_cli.to_config(args)
    assert cfg.quantize == "int8"
    server = serve_cli.build_server(args)
    assert server.engine.quantized
    assert server.stats()["aot_cache"]["compiles"] == 0
    with pytest.raises(SystemExit):
        serve_cli.get_args(argv + ["--quantize", "int4"])


def test_native_pt_with_bf16_weights_loads_promoted(setup, tmp_path, caplog):
    """The port's native ``.pt`` serves from its ``model`` state dict (a
    DDP ``module.`` prefix stripped); weights stored in bf16, as under
    ``--dtype bf16_params``, are promoted to float32 with a warning."""
    state = {f"module.{k}": v.to(torch.bfloat16)
             for k, v in load_pth(str(setup["dir"] / "unet.pth")).items()}
    write_payload(str(tmp_path / "run.pt"), {
        "model": state, "manifest": {"format": NATIVE_FORMAT}})
    with caplog.at_level(logging.WARNING):
        bundle = load_inference_bundle("run.pt", checkpoint_dir=str(tmp_path),
                                       image_size=SIZE_WH,
                                       model_widths=WIDTHS)
    assert any("bfloat16" in r.getMessage() for r in caplog.records)
    for name, value in bundle.model.state_dict().items():
        assert value.dtype == torch.float32
        assert torch.equal(value, state[f"module.{name}"].float()), name
    write_payload(str(tmp_path / "other.pt"), {"model": state})
    with pytest.raises(ValueError, match="neither a native checkpoint"):
        load_inference_bundle(str(tmp_path / "other.pt"), image_size=SIZE_WH,
                              model_widths=WIDTHS)
