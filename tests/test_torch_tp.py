"""The port's ``-t TP`` against the JAX package's, on the CPU at a small
size (widths (8, 16): a 2-level UNet and a 1-level milesial, 32 × 16
images, batch 4, float32).

The port's channel slices run on an explicit device list that repeats
the CPU (``[cpu] * n``), one thread issuing each layer's slices in turn,
the whole activation gathered before every conv; the JAX reference is its
TP strategy on an n-device CPU mesh (``jax.devices()[:n]``), whose GSPMD
step shards every kernel's out-channels over a ``model`` axis. Weights
cross with ``checkpoint.params_from_jax``; inputs are numpy arrays made
from seeds. PERF.md §2's bounds hold one step: the loss within 1e-5, each
gradient before Adam within 1e-4 of its tensor's largest, the running
statistics and the weights after Adam within 1e-5
(``torch_parallel_parity.assert_step_matches``)."""

import dataclasses
import functools
import logging
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.config import TrainConfig as JaxTrainConfig
from distributedpytorch_tpu.models import create_model as jax_create_model
from distributedpytorch_tpu.ops.optim import adam_l2
from distributedpytorch_tpu.parallel import mesh as jax_mesh
from distributedpytorch_tpu.parallel import strategy as jax_strategy
from distributedpytorch_tpu.train import Trainer as JaxTrainer
from distributedpytorch_tpu.train.steps import TrainState
from distributedpytorch_tpu_torch import checkpoint, cli
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.models import create_model
from distributedpytorch_tpu_torch.models.unet import TapsConv2d
from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
from distributedpytorch_tpu_torch.ops.optim import make_optimizer
from distributedpytorch_tpu_torch.parallel import channels
from distributedpytorch_tpu_torch.parallel.channels import (
    ChannelSharded,
    check_wgrad_slice,
)
from distributedpytorch_tpu_torch.parallel.strategy import (
    build_strategy,
    check_run_control,
)
from distributedpytorch_tpu_torch.train.loop import Trainer
from distributedpytorch_tpu_torch.train.steps import (
    STACKS_CONFLICT,
    STATEFUL_ACCUM,
)
from torch_parallel_parity import (
    assert_step_matches,
    capture_then,
    run_cli,
    to_port,
    torch_batch,
)

H, W = 32, 16
WIDTHS = (8, 16)
B = 4
LR = 1e-4
CPU = torch.device("cpu")
ARCHS = ["unet", "milesial"]
SLICES = [2, 4]
CLI = ["--synthetic", "16", "--image-size", str(W), str(H),
       "--model-widths", "8", "16", "-b", str(B), "-v", "25", "--device",
       "cpu", "--num-workers", "0", "--s2d-levels", "0", "--dtype", "f32"]


def _batch(seed=1, b=B):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((b, H, W, 3), np.float32),
            "mask": (rng.random((b, H, W)) > 0.6).astype(np.int32)}


def _jax_config(arch, **kw):
    return JaxTrainConfig(**{**dict(
        dtype="f32", kernels="xla", model_arch=arch, model_widths=WIDTHS,
        image_size=(W, H), s2d_levels=0, learning_rate=LR, batch_size=B,
        train_method="TP"), **kw})


def _port_config(arch, **kw):
    return TrainConfig(**{**dict(
        dtype="f32", kernels="torch", model_arch=arch, model_widths=WIDTHS,
        image_size=(W, H), device="cpu", learning_rate=LR, batch_size=B,
        train_method="TP"), **kw})


@functools.cache
def _jax_init(arch):
    """The JAX model and its seeded weights (the init under ``jit``)."""
    model, init_fn = jax_create_model(_jax_config(arch))
    params, model_state = jax.jit(lambda key: init_fn(key, (H, W)))(
        jax.random.key(0))
    return model, params, model_state


@functools.cache
def _jax_tp_step(arch, n):
    """The JAX TP strategy on ``n`` devices from the seeded weights: the
    eval metrics of those weights on ``_batch(4)``, then one Adam step on
    ``_batch()``: the loss, the gradients as Adam received them and the
    state after the step, under port names."""
    strategy = jax_strategy.build_strategy(_jax_config(arch),
                                           devices=jax.devices()[:n])
    assert dict(strategy.mesh.shape) == {"model": n}
    model, params, model_state = _jax_init(arch)
    tx = capture_then(adam_l2(LR))
    state = strategy.place_state(TrainState(
        params=params, opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32), model_state=model_state))
    variables = (state.params if model_state is None else
                 {"params": state.params, "batch_stats": state.model_state})
    metrics = strategy.build_eval_step(model)(
        variables, strategy.place_batch(_batch(seed=4)))
    new, loss = strategy.build_train_step(model, tx)(
        state, strategy.place_batch(_batch()))
    return {"initial": to_port(params, model_state), "loss": float(loss),
            "grads": to_port(new.opt_state[0], model_state),
            "final": to_port(new.params, new.model_state),
            "eval": {k: float(v) for k, v in metrics.items()}}


class _WholeGrads:
    """An optimizer around ``inner`` over a ``ChannelSharded`` model's
    slices that keeps the whole gradients of its first step (as Adam
    receives them) under the reference names."""

    def __init__(self, inner, model):
        self.inner = inner
        self.model = model
        self.grads = None

    def zero_grad(self, set_to_none=True):
        self.inner.zero_grad(set_to_none=set_to_none)

    def step(self):
        if self.grads is None:
            whole = self.model.whole_values(
                [p.grad for p in self.model.parameters()])
            self.grads = dict(zip(self.model.whole_param_names(), whole))
        self.inner.step()


class _Whole:
    """``model`` seen as the singleGPU model: its state dict whole."""

    def __init__(self, model):
        self.model = model

    def state_dict(self):
        return self.model.whole_state()


def _port_tp_step(cfg, initial, n):
    """The port's model from ``initial`` placed by TP over ``[cpu] * n``,
    its optimizer (``_WholeGrads`` around Adam) and its train step."""
    strategy = build_strategy(cfg, devices=[CPU] * n)
    assert strategy.devices == [CPU] * n
    model = create_model(cfg)
    model.load_state_dict(initial)
    model = strategy.place_model(model)
    opt = _WholeGrads(make_optimizer(model.parameters(), LR,
                                     cfg.weight_decay), model)
    step = strategy.build_train_step(model, opt,
                                     get_kernel_policy(cfg.kernels))
    return strategy, model, opt, step


# -- the strategy ------------------------------------------------------------------


@pytest.mark.parametrize("n", SLICES)
def test_tp_strategy_contract_matches_the_jax_tp(n):
    """The batch replicated (``batch_size`` the whole batch), the lr not
    scaled, the ragged batch kept, one process; the mesh ``{model: n}``
    and the manifest's ``1xNx1``, JAX's ``canonical_spec``; two slices of
    the CPU by default."""
    jtp = jax_strategy.build_strategy(_jax_config("unet"),
                                      devices=jax.devices()[:n])
    tp = build_strategy(_port_config("unet"), devices=[CPU] * n)
    assert tp.name == jtp.name == "TP"
    assert tp.lr_for(LR) == jtp.lr_for(LR) == LR
    assert tp.drop_last_train is jtp.drop_last_train is False
    assert tp.global_batch_size == B
    assert (tp.rank, tp.world, tp.is_main) == (0, 1, True)
    assert tp.mesh_shape() == dict(jtp.mesh.shape) == {"model": n}
    topology = checkpoint.jax_topology(tp.name, tp.mesh_shape(), "f32")
    assert topology["mesh_spec"] == jax_mesh.canonical_spec(
        jtp.mesh_config) == f"1x{n}x1"
    assert build_strategy(_port_config("unet")).devices == [CPU, CPU]


def test_each_layer_is_cut_on_its_out_channel_axis():
    """A conv's slices cut dim 0 of its (Cout, Cin, kh, kw) weight, a
    transposed conv's dim 1 of its (Cin, Cout, kh, kw) weight, milesial's
    BatchNorm its scale, bias and running statistics; the 1-channel head
    stays whole on the first device; the slices concatenate back to the
    model's tensors bitwise."""
    for arch in ARCHS:
        model = create_model(_port_config(arch),
                             generator=torch.Generator().manual_seed(0))
        want = {k: v.clone() for k, v in model.state_dict().items()}
        tp = ChannelSharded(model, [CPU] * 4)
        for name, layer in tp.layers():
            whole = want[f"{name}.weight"]
            if isinstance(layer.shards[0], torch.nn.ConvTranspose2d):
                assert layer.shards[0].weight.shape[1] == whole.shape[1] // 4
                assert layer.shards[0].weight.shape[0] == whole.shape[0]
            elif layer.sharded:
                assert layer.shards[0].weight.shape[0] == whole.shape[0] // 4
            else:
                assert whole.shape[0] == 1 and len(layer.shards) == 1
        got = tp.whole_state()
        assert list(got) == list(want)
        for key, value in want.items():
            assert torch.equal(got[key], value), key


def test_tp_warns_when_nothing_shards(caplog):
    """Widths that four devices divide nowhere: every layer stays whole on
    the first device, with the JAX warning."""
    cfg = _port_config("unet", model_widths=(3, 5))
    with caplog.at_level(logging.WARNING):
        tp = ChannelSharded(create_model(cfg), [CPU] * 4)
    assert not any(layer.sharded for _, layer in tp.layers())
    assert any("fully replicated" in r.message and "no parameter axis "
               "divides the 4-device mesh" in r.message
               for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        ChannelSharded(create_model(cfg), [CPU] * 2)  # the mid block's 10
    assert not any("fully replicated" in r.message for r in caplog.records)


def test_a_slice_that_k5_cannot_take_raises(monkeypatch):
    """Under ``DPT_WGRAD_BACKEND=pallas`` a sliced taps conv whose whole
    conv engages K5 keeps K5 on its slice; a bfloat16 slice of 72
    out-channels (144 over two cards) is one K5 cannot take, and the
    sharding raises instead of running the plain contraction. The CPU,
    float32, a conv below K5's widths and a slice of 32 raise nothing."""
    monkeypatch.setenv("DPT_WGRAD_BACKEND", "pallas")
    card = torch.device("cuda", 0)
    conv = TapsConv2d(128, 144, 3, padding=1, wgrad_cuda=True)
    with pytest.raises(ValueError, match="72 out-channels a slice"):
        check_wgrad_slice(conv, 2, card, torch.bfloat16)
    check_wgrad_slice(conv, 2, card, torch.float32)
    check_wgrad_slice(conv, 2, CPU, torch.bfloat16)
    check_wgrad_slice(TapsConv2d(128, 128, 3, padding=1, wgrad_cuda=True),
                      4, card, torch.bfloat16)
    check_wgrad_slice(TapsConv2d(64, 72, 3, padding=1, wgrad_cuda=True),
                      2, card, torch.bfloat16)
    sliced = channels._slice(conv, 1, 2)
    assert sliced.whole_out_channels == 144
    assert sliced.weight.shape == (72, 128, 3, 3)


def test_the_gather_adds_the_gradients_in_device_order():
    """The gather's backward sends each block the sum of its slices of the
    n outputs' gradients, added in device order: bitwise the sum written
    out in that order."""
    torch.manual_seed(0)
    parts = [torch.randn(2, c, 3, 5, requires_grad=True) for c in (2, 3, 1)]
    outs = channels.gather(parts, [CPU] * 3)
    grads = [torch.randn(2, 6, 3, 5) for _ in outs]
    torch.autograd.backward(outs, grads)
    for o in outs:
        assert torch.equal(o, torch.cat([p.detach() for p in parts], 1))
    at = 0
    for p in parts:
        c = p.shape[1]
        pieces = [g[:, at:at + c] for g in grads]
        assert torch.equal(p.grad, (pieces[0] + pieces[1]) + pieces[2])
        at += c


# -- one step and one eval against the JAX TP step ---------------------------------


@pytest.mark.parametrize("policy", ["torch", "cuda"])
@pytest.mark.parametrize("n", SLICES)
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_matches_the_jax_tp_step(arch, n, policy):
    """One Adam step over ``[cpu] * n`` against the JAX TP step on n
    devices (its XLA kernel policy), within PERF.md §2's bounds, and the
    eval metrics of the initial weights within 1e-5. Under ``--kernels
    cuda`` the loss and the eval run through the fused statistics, whose
    plain versions run on the CPU; milesial's running statistics move
    once, per slice."""
    want = _jax_tp_step(arch, n)
    cfg = _port_config(arch, kernels=policy)
    strategy, model, opt, step = _port_tp_step(cfg, want["initial"], n)
    metrics = strategy.build_eval_step(model, get_kernel_policy(policy))(
        torch_batch(_batch(seed=4)))
    for key in ("loss", "dice"):
        np.testing.assert_allclose(float(metrics[key]), want["eval"][key],
                                   rtol=1e-5, err_msg=key)
    loss = step(torch_batch(_batch()))
    assert_step_matches(_Whole(model), opt, loss, want, weights_tol=1e-5)
    for key, value in model.whole_state().items():
        if key.endswith("num_batches_tracked"):
            assert int(value) == 1, key


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_matches_the_singlegpu_step(arch):
    """The port's TP step over four slices against its singleGPU step from
    the same weights: the same function, within PERF.md §2's bounds."""
    initial = _jax_tp_step(arch, 4)["initial"]
    single = build_strategy(_port_config(arch, train_method="singleGPU"))
    model = create_model(_port_config(arch))
    model.load_state_dict(initial)
    model = single.place_model(model)
    named = list(model.named_parameters())
    inner = make_optimizer(model.parameters(), LR, 1e-8)
    grads = {}

    class Keep:
        def zero_grad(self, set_to_none=True):
            inner.zero_grad(set_to_none=set_to_none)

        def step(self):
            grads.update({n: p.grad.clone() for n, p in named})
            inner.step()

    step = single.build_train_step(model, Keep(), get_kernel_policy("torch"))
    want = {"loss": float(step(torch_batch(_batch()))), "grads": grads,
            "final": {k: v.clone() for k, v in model.state_dict().items()}}
    _s, tp, opt, tp_step = _port_tp_step(_port_config(arch), initial, 4)
    loss = tp_step(torch_batch(_batch()))
    assert_step_matches(_Whole(tp), opt, loss, want, weights_tol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_slot_holds_its_share_of_the_state(arch):
    """After one step over four slices, the bytes of parameters and Adam's
    state that each slice index holds (the first also the whole 1-channel
    head) are at most the total / 4 × 1.5, as the JAX test asserts of its
    TP (tests/test_strategies.py:396-440)."""
    initial = _jax_tp_step(arch, 4)["initial"]
    _s, model, opt, step = _port_tp_step(_port_config(arch), initial, 4)
    step(torch_batch(_batch()))
    state = opt.inner.state

    def nbytes(p):
        extra = sum(t.numel() * t.element_size()
                    for t in state[p].values() if t.dim() > 0)
        return p.numel() * p.element_size() + extra

    slots = [0] * 4
    for _name, layer in model.layers():
        for i, shard in enumerate(layer.shards):
            slots[i] += sum(nbytes(p) for p in shard.parameters())
    total = sum(nbytes(p) for p in model.parameters())
    assert sum(slots) == total
    assert max(slots) <= total / 4 * 1.5, (slots, total)
    assert min(slots) > 0


# -- the trainer, the CLI and the checkpoints --------------------------------------


def test_one_epoch_through_the_trainer_matches_the_jax_tp_trainer(tmp_path):
    """``Trainer`` under ``-t TP`` on ``[cpu, cpu]`` against the JAX
    trainer's TP (its CPU devices, eight slices of these widths) from the
    same weights: --synthetic 24 -v 25 -b 4, 5 steps (the ragged batch
    kept) and 1 val batch. The losses and the val metrics within 1e-4, as
    tests/test_torch_train.py holds singleGPU."""
    common = dict(epochs=1, batch_size=B, val_percent=25.0, seed=42,
                  image_size=(W, H), model_widths=WIDTHS,
                  synthetic_samples=24, metric_every_steps=1, num_workers=0,
                  s2d_levels=0, train_method="TP", dtype="f32")
    jcfg = JaxTrainConfig(
        async_checkpoint=False, kernels="xla", **common,
        checkpoint_dir=str(tmp_path / "jax" / "checkpoints"),
        log_dir=str(tmp_path / "jax" / "logs"),
        loss_dir=str(tmp_path / "jax" / "loss"))
    jtrainer = JaxTrainer(jcfg)
    assert dict(jtrainer.strategy.mesh.shape) == {"model": 8}
    initial = checkpoint.params_from_jax(
        jax.device_get(jtrainer.state.params))
    jresult = jtrainer.train()
    pcfg = TrainConfig(
        device="cpu", kernels="cuda", **common,
        checkpoint_dir=str(tmp_path / "port" / "checkpoints"),
        log_dir=str(tmp_path / "port" / "logs"),
        loss_dir=str(tmp_path / "port" / "loss"))
    trainer = Trainer(pcfg, initial_state=initial, devices=[CPU, CPU])
    result = trainer.train()
    assert result["steps"] == jresult["steps"] == 5
    np.testing.assert_allclose([r[2] for r in trainer.records.train_rows],
                               [r[2] for r in jtrainer.records.train_rows],
                               rtol=1e-4)
    for key in ("val_loss", "val_dice"):
        np.testing.assert_allclose(result[key], jresult[key], rtol=1e-4)


def test_cli_trains_tp_and_resumes_across_methods(tmp_path, monkeypatch):
    """``-t TP --device cpu`` (two slices of the CPU) trains, evaluates
    and writes the TP artifacts; its ``.pt`` and ``.pth`` hold whole
    tensors under the reference names, the keys, shapes and dtypes of a
    singleGPU file's, Adam's state over the whole parameters in one
    group; the manifest names ``1x2x1``. ``-c TP`` resumes under
    singleGPU and a singleGPU checkpoint under TP, each with the
    reshard log line; the resumed TP weights are the singleGPU file's,
    bitwise."""
    monkeypatch.chdir(tmp_path)
    assert run_cli(["-t", "TP", "-e", "1", *CLI]) == 0
    for path in ("logs/TP.log", "checkpoints/TP.pt", "checkpoints/TP.pth",
                 "loss/TP/train_loss.pkl", "loss/TP/val_loss.pkl",
                 "loss/TP/val_dice.pkl"):
        assert (tmp_path / path).exists(), path
    tp = checkpoint.load_native(str(tmp_path / "checkpoints" / "TP.pt"))
    assert tp["manifest"]["strategy"] == "TP"
    assert tp["manifest"]["topology"] == {
        "process_count": 1, "device_count": 2, "strategy": "TP",
        "mesh": {"model": 2}, "mesh_spec": "1x2x1", "precision": "f32"}
    assert run_cli(["-t", "singleGPU", "-c", "TP", "-e", "2", *CLI]) == 0
    single = checkpoint.load_native(
        str(tmp_path / "checkpoints" / "singleGPU.pt"))
    assert single["epoch"] == 2
    for key, value in tp["model"].items():
        assert single["model"][key].shape == value.shape, key
        assert single["model"][key].dtype == value.dtype, key
    assert list(single["model"]) == list(tp["model"])
    assert len(tp["optimizer"]["param_groups"]) == 1
    assert set(tp["optimizer"]["state"]) == set(single["optimizer"]["state"])
    for i, st in tp["optimizer"]["state"].items():
        assert st["exp_avg"].shape == single["optimizer"]["state"][i][
            "exp_avg"].shape
    pth = checkpoint.load_pth(str(tmp_path / "checkpoints" / "TP.pth"))
    assert list(pth) == list(tp["model"])
    assert run_cli(["-t", "TP", "-c", "singleGPU", "-e", "2", *CLI]) == 0
    log = (tmp_path / "logs" / "TP.log").read_text()
    assert "Resumed from" in log and "mesh-resharding restore" in log
    resumed = Trainer(dataclasses.replace(
        _port_config("unet"), epochs=2, synthetic_samples=16,
        checkpoint_name=str(tmp_path / "checkpoints" / "singleGPU.pt"),
        checkpoint_dir=str(tmp_path / "x")))
    for key, value in resumed.model.whole_state().items():
        assert torch.equal(value, single["model"][key]), key
    opt = resumed.strategy.optimizer_state(resumed.model, resumed.optimizer)
    for i, st in single["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt["state"][i][key], st[key]), (i, key)


def test_a_jax_tp_ckpt_resumes_in_the_port(tmp_path):
    """A ``.ckpt`` the JAX trainer wrote under TP on two devices resumes in
    the port's TP (``-c``): the port's whole weights and Adam moments are
    the JAX file's, bitwise, the manifest's topology is JAX's ``1x2x1``,
    and the port trains on from it."""
    common = dict(batch_size=B, val_percent=25.0, seed=42,
                  image_size=(W, H), model_widths=WIDTHS,
                  synthetic_samples=16, num_workers=0, s2d_levels=0,
                  train_method="TP", dtype="f32")
    jcfg = JaxTrainConfig(
        epochs=1, async_checkpoint=False, kernels="xla", **common,
        checkpoint_dir=str(tmp_path / "checkpoints"),
        log_dir=str(tmp_path / "jax" / "logs"),
        loss_dir=str(tmp_path / "jax" / "loss"))
    JaxTrainer(jcfg, strategy=jax_strategy.build_strategy(
        jcfg, devices=jax.devices()[:2])).train()
    path = str(tmp_path / "checkpoints" / "TP.ckpt")
    assert os.path.exists(path)
    saved = checkpoint.load_jax_ckpt(path)
    assert saved["manifest"]["topology"]["mesh_spec"] == "1x2x1"
    pcfg = TrainConfig(device="cpu", kernels="torch", epochs=2,
                       checkpoint_name=path,
                       checkpoint_dir=str(tmp_path / "port" / "checkpoints"),
                       log_dir=str(tmp_path / "port" / "logs"),
                       loss_dir=str(tmp_path / "port" / "loss"), **common)
    trainer = Trainer(pcfg, devices=[CPU, CPU])
    for key, value in trainer.model.whole_state().items():
        assert torch.equal(value, saved["model"][key]), key
    opt = trainer.strategy.optimizer_state(trainer.model, trainer.optimizer)
    for i, st in saved["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt["state"][i][key], st[key]), (i, key)
    assert trainer.start_epoch == 1
    assert np.isfinite(trainer.train()["val_loss"])


# -- what TP and FSDP refuse ---------------------------------------------------------


GLOO_ON_A_CARD = "gloo moves CUDA tensors through the host"


@pytest.mark.parametrize("method,arch,flag,kw,message", [
    ("TP", "unet", ["--grad-accum", "2", "--steps-per-dispatch", "2"],
     dict(grad_accum=2, steps_per_dispatch=2), STACKS_CONFLICT),
    ("FSDP", "unet", ["--grad-accum", "2", "--steps-per-dispatch", "2"],
     dict(grad_accum=2, steps_per_dispatch=2), STACKS_CONFLICT),
    ("TP", "milesial", ["--grad-accum", "2"], dict(grad_accum=2),
     STATEFUL_ACCUM),
    ("FSDP", "milesial", ["--grad-accum", "2"], dict(grad_accum=2),
     STATEFUL_ACCUM),
    ("TP", "milesial", ["--grad-accum", "2", "--remat"],
     dict(grad_accum=2, remat=True), STATEFUL_ACCUM),
    ("FSDP", "milesial", ["--grad-accum", "2", "--dtype", "bf16_params"],
     dict(grad_accum=2, dtype="bf16_params"), STATEFUL_ACCUM),
    ("TP", "unet", ["--steps-per-dispatch", "2"],
     dict(steps_per_dispatch=2), GLOO_ON_A_CARD),
    ("FSDP", "unet", ["--steps-per-dispatch", "2"],
     dict(steps_per_dispatch=2), GLOO_ON_A_CARD)])
def test_the_run_control_under_tp_and_fsdp_is_refused(method, arch, flag,
                                                      kw, message):
    """What TP and FSDP still refuse is what every method refuses, with
    the JAX package's words: ``--grad-accum`` with ``--steps-per-dispatch
    K > 1`` and milesial's ``--grad-accum``, in the strategy and at the
    CLI, before any group is joined; and K > 1 over a gloo group on a
    card, which ``check_run_control`` refuses once the strategy knows its
    device and backend (a pure call: no card needed), while the same
    flags on the CPU build. ``--steps-per-dispatch``, ``--remat``,
    ``--grad-accum`` and ``--dtype bf16_params`` alone build under
    both."""
    cfg = _port_config(arch, train_method=method, **kw)
    if message == GLOO_ON_A_CARD:
        with pytest.raises(ValueError, match=re.escape(message)):
            check_run_control(cfg, device=torch.device("cuda", 0),
                              backend="gloo")
        check_run_control(cfg, device=CPU, backend="gloo")
        check_run_control(cfg, device=torch.device("cuda", 0),
                          backend="nccl")
    else:
        with pytest.raises(ValueError, match=re.escape(message)):
            build_strategy(cfg, devices=[CPU, CPU])
        with pytest.raises(SystemExit, match=re.escape(message)):
            cli.main(["-t", method, *CLI, "--model", arch, *flag])
    assert not torch.distributed.is_initialized()
    if method == "TP":
        for alone in (dict(steps_per_dispatch=2), dict(remat=True),
                      dict(grad_accum=2), dict(dtype="bf16_params")):
            build_strategy(_port_config("unet", **alone), devices=[CPU, CPU])
