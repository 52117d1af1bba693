"""The JAX ``.ckpt`` in the port and the port's ``.ckpt`` in the JAX
package, on the CPU at a small size (widths (8, 16), 32 × 48 images):
``checkpoint.load_jax_ckpt`` / ``save_jax_ckpt`` against the JAX
``Trainer``'s own files and restore, the topology manifest, serving a
JAX ``.ckpt`` and a JAX ``.int8.ckpt``.

A resumed state is held bit for bit (the same numbers in another
layout). One more step on each side runs in float32 from the resumed
state (the bf16 and bf16_params files converted to f32 as the policies
convert them) and is held within PERF.md §2's bounds for one step: the
loss within 1e-5 relative, the running statistics within 1e-5 of their
tensor's largest, every weight after Adam within 1e-5 relative with an
absolute floor of 1e-3 × lr, as ``torch_parallel_parity.
assert_step_matches`` holds them (an Adam update of a gradient element
near zero moves by a visible part of lr for a float32 rounding of g)."""

import dataclasses
import logging
import os

import jax
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.checkpoint import (
    export_milesial_pth,
    export_reference_pth,
    peek_topology,
    read_payload as jax_read_payload,
)
from distributedpytorch_tpu.config import TrainConfig as JaxTrainConfig
from distributedpytorch_tpu.ops import quant as jquant
from distributedpytorch_tpu.ops.precision import unwrap_opt_state
from distributedpytorch_tpu.train import Trainer as JaxTrainer
from distributedpytorch_tpu_torch import checkpoint
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.ops import quant
from distributedpytorch_tpu_torch.serve.engine import engine_from_checkpoint
from distributedpytorch_tpu_torch.serve.infer import load_inference_bundle
from distributedpytorch_tpu_torch.train.loop import Trainer

H, W = 32, 48
WIDTHS = (8, 16)
CPU = torch.device("cpu")
ARCHS = ["unet", "milesial"]
DTYPES = ["bf16", "bf16_params"]
LR = 1e-4
# PERF.md §2, one float32 step against the JAX package
LOSS_RTOL = 1e-5
STATE_RTOL = 1e-5


def _common(arch, dtype, **kw):
    """--synthetic 6 -v 34 -b 2: 4 train samples (2 steps), 2 val."""
    return {**dict(epochs=1, batch_size=2, val_percent=34.0, seed=42,
                   image_size=(W, H), model_widths=WIDTHS,
                   synthetic_samples=6, metric_every_steps=1, num_workers=0,
                   s2d_levels=0, dtype=dtype, model_arch=arch), **kw}


def _jax_config(root, arch, dtype, **kw):
    return JaxTrainConfig(
        kernels="xla", async_checkpoint=False,
        checkpoint_dir=os.path.join(root, "checkpoints"),
        log_dir=os.path.join(root, "logs"), loss_dir=os.path.join(root, "loss"),
        **_common(arch, dtype, **kw))


def _port_config(root, arch, dtype, **kw):
    return TrainConfig(
        kernels="torch", device="cpu", async_checkpoint=False,
        checkpoint_dir=os.path.join(root, "checkpoints"),
        log_dir=os.path.join(root, "logs"), loss_dir=os.path.join(root, "loss"),
        **_common(arch, dtype, **kw))


def _batch():
    rng = np.random.default_rng(3)
    return {"image": rng.random((2, H, W, 3), np.float32),
            "mask": (rng.random((2, H, W)) > 0.6).astype(np.int32)}


def _port_step(trainer):
    loss = trainer.train_step({k: torch.from_numpy(v)
                               for k, v in _batch().items()})
    return float(loss), trainer.model.state_dict()


def _jax_step(trainer):
    state, loss = trainer.train_step(trainer.state,
                                     trainer.strategy.place_batch(_batch()))
    stats = (None if state.model_state is None
             else jax.device_get(state.model_state))
    return float(loss), checkpoint.params_from_jax(
        jax.device_get(state.params), stats)


def _assert_one_step_agrees(port, jax_side):
    (ploss, pstate), (jloss, jstate) = port, jax_side
    np.testing.assert_allclose(ploss, jloss, rtol=LOSS_RTOL)
    for name, want in jstate.items():
        if name.endswith("num_batches_tracked"):
            continue
        got = pstate[name].float().numpy()
        want = want.float().numpy()
        if "running" in name:
            scale = float(np.abs(want).max()) or 1.0
            assert np.abs(got - want).max() <= STATE_RTOL * scale, name
        else:
            np.testing.assert_allclose(got, want, rtol=STATE_RTOL,
                                       atol=1e-3 * LR, err_msg=name)


def _named(tree, stats):
    """A JAX params-shaped tree (and milesial's statistics) → port names
    (float32)."""
    return checkpoint.params_from_jax(jax.device_get(tree), stats)


def _assert_state_is_the_jax_state(trainer, jtrainer):
    """The port's resumed model and Adam state hold the JAX trainer's
    final state bit for bit, in the port's layout."""
    jstate = jtrainer.state
    stats = (None if jstate.model_state is None
             else jax.device_get(jstate.model_state))
    want = _named(jstate.params, stats)
    got = trainer.model.state_dict()
    for name, value in want.items():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(got[name].float(), value), name
    opt = trainer.optimizer
    jopt = jstate.opt_state
    names = [n for n, _ in trainer.model.named_parameters()]
    if hasattr(jopt, "master"):
        masters = _named(jopt.master, stats)
        for name, m in zip(names, opt.master):
            assert m.dtype == torch.float32 and torch.equal(m, masters[name])
    adam = unwrap_opt_state(jopt).inner_state[1]
    mu, nu = _named(adam.mu, stats), _named(adam.nu, stats)
    params = [p for _, p in trainer.model.named_parameters()]
    for name, p in zip(names, opt.master if hasattr(opt, "master")
                       else params):
        st = opt.state[p]
        assert torch.equal(st["exp_avg"], mu[name]), name
        assert torch.equal(st["exp_avg_sq"], nu[name]), name
        assert float(st["step"]) == int(adam.count)
    assert trainer.step == int(jstate.step) == 2
    assert trainer.start_epoch == 1
    assert trainer.scheduler.state_dict() == jtrainer.scheduler.state_dict()


def _same_tree(a, b, path=""):
    """Two decoded JAX payloads (flax numpy) hold the same values."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (path,
                                                          set(a) ^ set(b))
        for k in b:
            _same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, (np.ndarray, np.generic)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b or (a != a and b != b), (path, a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_a_jax_ckpt_resumes_in_the_port_and_back(tmp_path, arch, dtype):
    """The JAX trainer trains two steps and saves ``singleGPU.ckpt``. The
    port's ``-c`` resumes it under the same policy with the JAX state bit
    for bit, and its ``save_jax_ckpt`` of that state writes a file whose
    payload is the JAX file's, value for value. Then one more step:
    the port from the JAX file against the JAX trainer from the port's
    file, both converted to f32."""
    jcfg = _jax_config(str(tmp_path / "jax"), arch, dtype)
    jtrainer = JaxTrainer(jcfg)
    jtrainer.train()
    jfile = os.path.join(jcfg.checkpoint_dir, "singleGPU.ckpt")

    pcfg = _port_config(str(tmp_path / "port"), arch, dtype, epochs=2)
    os.makedirs(pcfg.checkpoint_dir)
    os.replace(jfile, os.path.join(pcfg.checkpoint_dir, "singleGPU.ckpt"))
    # -c <name>: no .pt, so the .ckpt
    resumed = Trainer(dataclasses.replace(pcfg, checkpoint_name="singleGPU"))
    _assert_state_is_the_jax_state(resumed, jtrainer)

    back = str(tmp_path / "back" / "singleGPU.ckpt")
    resumed.save(1)
    checkpoint.save_jax_ckpt(checkpoint.load_native(resumed.checkpoint_path),
                             back)
    theirs = jax_read_payload(os.path.join(pcfg.checkpoint_dir,
                                           "singleGPU.ckpt"))
    ours = jax_read_payload(back)
    for key in ("params", "opt_state", "model_state", "scheduler", "step",
                "epoch", "version"):
        _same_tree(ours[key], theirs[key], key)
    # the topology is the saving run's: the port's
    assert ours["topology"] == resumed.topology()
    # the records' elapsed time went on while the port held them
    theirs["records"].pop("elapsed")
    ours["records"].pop("elapsed")
    _same_tree(ours["records"], theirs["records"], "records")

    port = Trainer(dataclasses.replace(pcfg, dtype="f32",
                                       checkpoint_name="singleGPU"))
    jax_side = JaxTrainer(dataclasses.replace(
        jcfg, dtype="f32", epochs=2, checkpoint_name=back))
    _assert_one_step_agrees(_port_step(port), _jax_step(jax_side))


@pytest.mark.parametrize("arch,dtype", [("unet", "bf16"),
                                        ("milesial", "bf16_params")])
def test_a_port_trained_ckpt_resumes_in_the_jax_trainer(tmp_path, caplog,
                                                        arch, dtype):
    """The port trains two steps under ``-t DP`` on two CPU devices and
    writes its checkpoint as a ``.ckpt``: the JAX ``peek_topology`` reads
    the port's topology, both sides resume it under singleGPU with the
    reshard warning, and one more f32 step agrees."""
    pcfg = _port_config(str(tmp_path / "port"), arch, dtype,
                        train_method="DP")
    trainer = Trainer(pcfg, devices=[CPU, CPU])
    trainer.train()
    payload = checkpoint.load_native(trainer.checkpoint_path)
    topology = payload["manifest"]["topology"]
    assert topology == {"process_count": 1, "device_count": 2,
                        "strategy": "DP", "mesh": {"data": 2},
                        "mesh_spec": "2x1x1", "precision": dtype}
    ckpt = str(tmp_path / "port" / "checkpoints" / "DP.ckpt")
    checkpoint.save_jax_ckpt(payload, ckpt)
    assert peek_topology(ckpt) == topology

    single = dataclasses.replace(pcfg, train_method="singleGPU", dtype="f32",
                                 epochs=2)
    with caplog.at_level(logging.WARNING):
        port = Trainer(dataclasses.replace(single, checkpoint_name="DP.pt"))
        jax_side = JaxTrainer(dataclasses.replace(
            _jax_config(str(tmp_path / "jax"), arch, "f32", epochs=2),
            checkpoint_name=ckpt))
    warned = [r for r in caplog.records
              if "mesh-resharding restore" in r.getMessage()]
    assert {r.name.split(".")[0] for r in warned} == {
        "distributedpytorch_tpu", "distributedpytorch_tpu_torch"}
    assert port.step == int(jax_side.state.step) == 2
    _assert_one_step_agrees(_port_step(port), _jax_step(jax_side))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_port_ckpt_port_round_trip_is_bitwise(tmp_path, arch, dtype):
    """port → ``.ckpt`` → port: the model (milesial's ``num_batches_tracked``
    included), the optimizer's state and master weights, the scheduler,
    step, epoch, records and trainer state, bit for bit."""
    trainer = Trainer(_port_config(str(tmp_path), arch, dtype))
    trainer.train()
    saved = checkpoint.load_native(trainer.checkpoint_path)
    path = str(tmp_path / "x.ckpt")
    checkpoint.save_jax_ckpt(saved, path)
    loaded = checkpoint.load_jax_ckpt(path)
    assert list(loaded["model"]) == list(saved["model"])
    for name, value in saved["model"].items():
        assert loaded["model"][name].dtype == value.dtype, name
        assert torch.equal(loaded["model"][name], value), name
    opt, back = saved["optimizer"], loaded["optimizer"]
    if dtype == "bf16_params":
        assert all(torch.equal(a, b) for a, b in zip(opt["master"],
                                                     back["master"]))
        opt, back = opt["inner"], back["inner"]
    assert set(opt["state"]) == set(back["state"])
    for i, st in opt["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert back["state"][i][key].dtype == st[key].dtype
            assert torch.equal(back["state"][i][key], st[key]), (i, key)
    assert back["param_groups"][0]["lr"] == opt["param_groups"][0]["lr"]
    for key in ("scheduler", "step", "epoch", "records", "train_meta"):
        assert loaded[key] == saved[key], key
    assert loaded["manifest"]["topology"] == saved["manifest"]["topology"]
    # the chain: a torn newest file falls back to the previous one
    checkpoint.save_jax_ckpt(saved, path, keep=2)
    with open(path, "r+b") as f:
        f.seek(100)
        f.write(b"\xff\xff\xff")
    assert checkpoint.load_jax_ckpt(path)["step"] == saved["step"]


def _images(n=3):
    return np.random.default_rng(5).random((n, H, W, 3), np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_jax_ckpt_and_its_int8_file_serve(tmp_path, arch):
    """The port's server from a JAX ``.ckpt`` gives the masks it gives from
    the JAX export of the same weights (``export_reference_pth`` /
    ``export_milesial_pth``), bit for bit; the JAX ``.int8.ckpt`` of those
    weights loads with the port's own int8 values and scales and serves
    what the port's quantize-on-load serves, bit for bit."""
    jcfg = _jax_config(str(tmp_path), arch, "bf16")
    jtrainer = JaxTrainer(jcfg)
    jtrainer.train()
    ckpt = os.path.join(jcfg.checkpoint_dir, "singleGPU.ckpt")
    params = jax.device_get(jtrainer.state.params)
    stats = (None if jtrainer.state.model_state is None
             else jax.device_get(jtrainer.state.model_state))
    pth = str(tmp_path / "exported.pth")
    if arch == "milesial":
        export_milesial_pth(params, stats, pth)
    else:
        export_reference_pth(params, pth)
    kw = dict(image_size=(W, H), model_arch=arch, model_widths=WIDTHS,
              dtype="f32", bucket_sizes=(4,), device="cpu", kernels="torch")
    images = _images()
    from_ckpt = engine_from_checkpoint(ckpt, **kw).infer(images)
    np.testing.assert_array_equal(
        from_ckpt, engine_from_checkpoint(pth, **kw).infer(images))

    int8 = str(tmp_path / "singleGPU.int8.ckpt")
    jquant.save_quantized(int8, jquant.quantize_tree(params),
                          {"source": ckpt, "model_arch": arch,
                           "model_widths": list(WIDTHS)},
                          model_state=stats)
    assert quant.peek_quantized(int8)["model_arch"] == arch
    bundle = load_inference_bundle(int8, image_size=(W, H), model_arch=arch,
                                   model_widths=WIDTHS, dtype="f32")
    assert bundle.quantized
    float_bundle = load_inference_bundle(pth, image_size=(W, H),
                                         model_arch=arch,
                                         model_widths=WIDTHS, dtype="f32")
    mine = quant.quantize_model(float_bundle.model)
    want = dict(mine.named_buffers())
    for name, value in bundle.model.named_buffers():
        assert torch.equal(value, want[name]), name
    np.testing.assert_array_equal(
        engine_from_checkpoint(int8, **kw).infer(images),
        engine_from_checkpoint(pth, quantize="int8", **kw).infer(images))


def test_the_trainer_resolves_pt_then_ckpt_then_pth(tmp_path):
    for ext in (".pth", ".ckpt", ".pt"):
        (tmp_path / f"run{ext}").write_bytes(b"")
        assert checkpoint.resolve_checkpoint(
            "run", str(tmp_path), exts=checkpoint.TRAIN_EXTS).endswith(ext)


def test_a_jax_ckpt_resumes_with_the_runs_weight_decay(tmp_path):
    """optax keeps no weight decay in its state, so a JAX ``.ckpt``
    resumed by the port's trainer takes the resuming run's
    ``TrainConfig.weight_decay`` (``checkpoint.payload_from_jax``), which
    no CLI flag carries: resumed under 0.5 every param group of Adam holds
    0.5, under the default 1e-8. The port's own checkpoint of that state
    carries its 0.5 (torch's optimizer state keeps the param groups), so a
    native resume under the default config steps bit for bit as the JAX
    file's resume under 0.5, and the default's step differs."""
    jcfg = _jax_config(str(tmp_path / "jax"), "unet", "f32")
    JaxTrainer(jcfg).train()
    pcfg = _port_config(str(tmp_path / "port"), "unet", "f32", epochs=2)
    os.makedirs(pcfg.checkpoint_dir)
    os.replace(os.path.join(jcfg.checkpoint_dir, "singleGPU.ckpt"),
               os.path.join(pcfg.checkpoint_dir, "singleGPU.ckpt"))
    default = Trainer(dataclasses.replace(pcfg, checkpoint_name="singleGPU"))
    assert {g["weight_decay"] for g in default.optimizer.param_groups} == {
        1e-8}
    decayed = Trainer(dataclasses.replace(pcfg, checkpoint_name="singleGPU",
                                          weight_decay=0.5))
    assert {g["weight_decay"] for g in decayed.optimizer.param_groups} == {
        0.5}
    decayed.save(1)
    native = Trainer(dataclasses.replace(
        pcfg, checkpoint_name=decayed.checkpoint_path))
    assert {g["weight_decay"] for g in native.optimizer.param_groups} == {
        0.5}
    _, got = _port_step(decayed)
    _, want = _port_step(native)
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    _, plain = _port_step(default)
    assert not all(torch.equal(plain[n], v) for n, v in want.items())


def test_a_jax_ckpt_written_under_a_non_default_weight_decay_resumes_with_it(
        tmp_path):
    """A JAX ``.ckpt`` of two steps under ``weight_decay`` 0.5 (optax keeps
    no weight decay in its state): the port's ``-c`` of it under the same
    run setting holds 0.5 in every param group of Adam, and its next step
    agrees with the JAX trainer's own resume of the file within PERF.md
    §2's one-step bounds; resumed under the default config the port takes
    that run's 1e-8 (``checkpoint.load_jax_ckpt(path, weight_decay)``),
    and its step leaves those bounds."""
    jcfg = _jax_config(str(tmp_path / "jax"), "unet", "f32",
                       weight_decay=0.5)
    JaxTrainer(jcfg).train()
    jfile = os.path.join(jcfg.checkpoint_dir, "singleGPU.ckpt")
    want = _jax_step(JaxTrainer(dataclasses.replace(
        jcfg, epochs=2, checkpoint_name=jfile)))
    pcfg = _port_config(str(tmp_path / "port"), "unet", "f32", epochs=2,
                        checkpoint_name=jfile, weight_decay=0.5)
    port = Trainer(pcfg)
    assert {g["weight_decay"] for g in port.optimizer.param_groups} == {0.5}
    assert port.step == 2
    _assert_one_step_agrees(_port_step(port), want)
    default = Trainer(dataclasses.replace(pcfg, weight_decay=1e-8))
    assert {g["weight_decay"] for g in default.optimizer.param_groups} == {
        1e-8}
    with pytest.raises(AssertionError):
        _assert_one_step_agrees(_port_step(default), want)
