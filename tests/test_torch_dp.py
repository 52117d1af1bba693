"""The port's ``-t DP`` against the JAX package's, on the CPU at a small
size (widths (8, 16), 16 × 24 images, batch 8, float32).

The port's replicas run on an explicit device list that repeats the CPU,
each in a thread of its own; the JAX reference is its DP strategy on a
2-device CPU mesh, which computes milesial's BatchNorm moments over the
whole batch, as the port's replicas do by meeting at every BatchNorm.
Weights cross with ``checkpoint.params_from_jax``; inputs are numpy
arrays made from seeds. Tolerances are relative unless marked
otherwise."""

import logging
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.config import TrainConfig as JaxTrainConfig
from distributedpytorch_tpu.ops.optim import adam_l2
from distributedpytorch_tpu.parallel import strategy as jax_strategy
from distributedpytorch_tpu.train import Trainer as JaxTrainer
from distributedpytorch_tpu.train.steps import TrainState
from distributedpytorch_tpu_torch.checkpoint import params_from_jax
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.models import create_model
from distributedpytorch_tpu_torch.models.milesial import BatchNormAct
from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
from distributedpytorch_tpu_torch.parallel.replicas import Replicated
from distributedpytorch_tpu_torch.parallel.strategy import build_strategy
from distributedpytorch_tpu_torch.train.loop import Trainer
from torch_parallel_parity import (
    assert_step_matches,
    make_batch,
    capture_then,
    jax_config,
    jax_init,
    run_cli,
    max_err_rel_to_max,
    port_config,
    port_step,
    to_port,
    torch_batch,
    B,
    CLI,
    CPU,
    H,
    LR,
    W,
    WIDTHS,
)

ARCHS = ["unet", "milesial"]


@pytest.fixture(scope="module")
def jax_dp():
    """``jax_dp(arch, remat=False)``: the JAX DP strategy's Adam step on 2
    devices from the seeded weights on ``make_batch()`` (memoized), as
    ``jax_mp`` gives the MP step's."""
    cache = {}

    def run(arch, remat=False):
        if (arch, remat) not in cache:
            cfg = jax_config(arch, train_method="DP", remat=remat)
            strategy = jax_strategy.build_strategy(
                cfg, devices=jax.devices()[:2])
            assert strategy.mesh.shape["data"] == 2
            model, params, model_state = jax_init(arch)
            tx = capture_then(adam_l2(LR))
            state = strategy.place_state(TrainState(
                params=params, opt_state=tx.init(params),
                step=jnp.zeros((), jnp.int32), model_state=model_state))
            new, loss = strategy.build_train_step(model, tx)(
                state, strategy.place_batch(make_batch()))
            cache[arch, remat] = {
                "initial": to_port(params, model_state),
                "loss": float(loss),
                "grads": to_port(new.opt_state[0], model_state),
                "final": to_port(new.params, new.model_state),
            }
        return cache[arch, remat]

    return run


@pytest.mark.parametrize("policy", ["torch", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dp_step_matches_the_jax_dp_step(jax_dp, arch, policy):
    """One Adam step on ``[cpu, cpu]`` against the JAX DP step on two
    devices: loss within 1e-5, gradients within 1e-4 of each tensor's
    largest, milesial's running statistics (global moments) within 1e-5
    of their largest, the weights after Adam within 1e-5. Under
    ``--kernels cuda`` the loss runs through the fused statistics, whose
    plain versions run on the CPU."""
    want = jax_dp(arch)
    cfg = port_config(arch, train_method="DP", kernels=policy)
    strategy, model, opt, step = port_step(cfg, want["initial"],
                                            devices=[CPU, CPU])
    assert len(strategy.devices) == 2
    loss = step(torch_batch(make_batch()))
    assert_step_matches(model, opt, loss, want, weights_tol=1e-5)
    for key, value in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            assert int(value) == 1, key  # moved once, by replica 0


def test_dp_strategy_contract_matches_the_jax_dp(caplog):
    """The batch is global and not scaled; the lr is not scaled; the
    ragged train batch is dropped; the device count shrinks, with the
    JAX package's warning, until it divides the batch (b = 3 on 2
    devices runs on 1)."""
    cfg = port_config("unet", train_method="DP")
    dp = build_strategy(cfg, devices=[CPU, CPU])
    jdp = jax_strategy.build_strategy(jax_config("unet", train_method="DP"),
                                      devices=jax.devices()[:2])
    assert dp.name == jdp.name == "DP"
    assert dp.global_batch_size == jdp.global_batch_size == B
    assert dp.lr_for(LR) == jdp.lr_for(LR) == LR
    assert dp.drop_last_train is jdp.drop_last_train is True
    assert dp.topology() == {"strategy": "DP", "world": 1, "devices": 2}
    for batch, devices in ((3, 2), (4, 3), (6, 4), (8, 8)):
        with caplog.at_level(logging.WARNING):
            caplog.clear()
            got = build_strategy(
                port_config("unet", train_method="DP", batch_size=batch),
                devices=[CPU] * devices)
        want = jax_strategy._shrunk_data_degree("DP", batch, devices)
        assert len(got.devices) == want, (batch, devices)
        assert ("data mesh shrunk" in caplog.text) == (want != devices)
    assert len(build_strategy(port_config("unet", train_method="DP")
                              ).devices) == 1  # the CPU: one device


@pytest.mark.parametrize("arch", ARCHS)
def test_eight_replicas_equal_the_singlegpu_step_and_eval(arch):
    """DP over eight replicas of one sample each, the threads switched as
    often as the interpreter allows, against the single-device step on
    the whole batch: loss within 1e-5, gradients within 1e-4 of each
    tensor's largest, running statistics within 1e-5, and the eval
    metrics within 1e-5. BatchNorm's moments are the whole batch's in
    both, so a lost or doubled replica's moments would show."""
    initial = create_model(port_config(arch), generator=torch.Generator(
        ).manual_seed(0)).state_dict()
    single = port_step(port_config(arch), initial)
    dp = port_step(port_config(arch, train_method="DP"), initial,
                    devices=[CPU] * 8)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        losses = [float(run[3](torch_batch(make_batch()))) for run in (single,
                                                                    dp)]
        policy = get_kernel_policy("torch")
        metrics = [run[0].build_eval_step(run[1], policy)(
            torch_batch(make_batch(seed=4))) for run in (single, dp)]
    finally:
        sys.setswitchinterval(switch)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    for name, g in single[2].grads.items():
        assert max_err_rel_to_max(dp[2].grads[name].numpy(),
                                   g.numpy()) <= 1e-4, name
    want = single[1].state_dict()
    for key, value in dp[1].state_dict().items():
        if "running" in key:
            assert max_err_rel_to_max(value.numpy(),
                                       want[key].numpy()) <= 1e-5, key
    for key in ("loss", "dice"):
        np.testing.assert_allclose(float(metrics[1][key]),
                                   float(metrics[0][key]), rtol=1e-5)


class _FailsInReplica(torch.nn.Module):
    """A BatchNorm that one replica's thread never reaches."""

    def __init__(self):
        super().__init__()
        self.bn = BatchNormAct(3)

    def forward(self, x):
        if threading.current_thread().name.endswith("-2"):
            raise RuntimeError("replica 2 failed")
        return self.bn(x.permute(0, 3, 1, 2))


def test_a_failing_replica_raises_and_leaves_no_replica_waiting():
    """A replica that fails before a BatchNorm breaks the meeting: the
    forward raises that replica's error and every thread ends."""
    model = Replicated(_FailsInReplica(), [CPU] * 3).train()
    done = {}

    def run():
        try:
            model(torch.rand(3, 4, 4, 3))
        except RuntimeError as exc:
            done["error"] = str(exc)

    thread = threading.Thread(target=run)
    thread.start()
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert done == {"error": "replica 2 failed"}
    assert model.module.bn.replicas is None
    assert not [t for t in threading.enumerate()
                if t.name.startswith("dpt-dp-replica")]


# -- --remat under DP ------------------------------------------------------------


def _within(seconds, fn):
    """``fn()`` on a thread of its own, joined with a timeout: a replica
    waiting on a meeting that never completes fails the test instead of
    hanging it."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as exc:  # re-raised in the test
            out["error"] = exc

    thread = threading.Thread(target=run, name="dp-step-under-test")
    thread.start()
    thread.join(timeout=seconds)
    assert not thread.is_alive(), f"the step did not end in {seconds} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


def _counting_batchnorms(model):
    """``counts["calls"]``: forwards of ``model``'s BatchNorms, the
    replicas' copies included (they share the hooks), and
    ``counts["meetings"]``, how many of those met the other replicas."""
    counts = {"calls": 0, "meetings": 0}

    def hook(bn, _args):
        counts["calls"] += 1
        counts["meetings"] += (bn.replicas is not None
                               and not bn.reuse_kept_moments)

    for m in model.modules():
        if isinstance(m, BatchNormAct):
            m.register_forward_pre_hook(hook)
    return counts


@pytest.mark.parametrize("policy", ["torch", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dp_remat_step_is_bitwise_the_plain_dp_step(arch, policy):
    """One Adam step on ``[cpu, cpu]`` with and without ``--remat``, each
    on a thread joined within 60 s: the loss, every gradient and the state
    after the step (running statistics moved once) bitwise equal. Under
    remat every replica's BatchNorm runs once more, in the recompute, on
    the moments it kept, and meets the other replica only in the first
    forward: autograd recomputes both replicas on one thread, where a
    second meeting would wait for ever."""
    initial = create_model(port_config(arch), generator=torch.Generator(
        ).manual_seed(0)).state_dict()
    runs = {}
    for remat in (False, True):
        cfg = port_config(arch, train_method="DP", kernels=policy,
                          remat=remat)
        _s, model, opt, step = port_step(cfg, initial, devices=[CPU, CPU])
        counts = _counting_batchnorms(model)
        loss = _within(60, lambda: step(torch_batch(make_batch())))
        runs[remat] = (float(loss), opt.grads, model.state_dict(), counts)
    (l0, g0, s0, c0), (l1, g1, s1, c1) = runs[False], runs[True]
    assert l1 == l0
    for name, g in g0.items():
        assert torch.equal(g1[name], g), name
    for key, value in s0.items():
        assert torch.equal(s1[key], value), key
    assert c1["meetings"] == c0["meetings"] == c0["calls"]
    assert c1["calls"] == 2 * c0["calls"]
    # each BatchNorm once per replica: 6 in milesial at widths (8, 16)
    assert c0["calls"] == (2 * 6 if arch == "milesial" else 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_dp_remat_step_matches_the_jax_dp_remat_step(jax_dp, arch):
    """One ``--remat`` Adam step on ``[cpu, cpu]`` against the JAX DP step
    with ``remat=True`` on two devices, within PERF.md §2's bounds: loss
    1e-5, gradients 1e-4 of each tensor's largest, running statistics
    1e-5 (``assert_step_matches``, weights after Adam within 1e-5)."""
    want = jax_dp(arch, remat=True)
    cfg = port_config(arch, train_method="DP", remat=True)
    _s, model, opt, step = port_step(cfg, want["initial"],
                                     devices=[CPU, CPU])
    loss = _within(60, lambda: step(torch_batch(make_batch())))
    assert_step_matches(model, opt, loss, want, weights_tol=1e-5)


def test_one_epoch_through_the_trainer_matches_the_jax_dp_trainer(tmp_path):
    """``Trainer`` under ``-t DP`` on ``[cpu, cpu]`` against the JAX
    trainer's DP (its 8 CPU devices) from the same weights:
    --synthetic 40 -v 20 -b 8, 4 steps and 1 val batch. The loss over the
    global batch is the same function at any replica count; losses and
    the val metrics within 1e-4, as tests/test_torch_train.py holds
    singleGPU."""
    common = dict(epochs=1, batch_size=B, val_percent=20.0, seed=42,
                  image_size=(W, H), model_widths=WIDTHS,
                  synthetic_samples=40, metric_every_steps=1, num_workers=0,
                  s2d_levels=0, train_method="DP", dtype="f32")
    jcfg = JaxTrainConfig(
        async_checkpoint=False, kernels="xla", **common,
        checkpoint_dir=str(tmp_path / "jax" / "checkpoints"),
        log_dir=str(tmp_path / "jax" / "logs"),
        loss_dir=str(tmp_path / "jax" / "loss"))
    jtrainer = JaxTrainer(jcfg)
    initial = params_from_jax(jax.device_get(jtrainer.state.params))
    jresult = jtrainer.train()
    pcfg = TrainConfig(
        device="cpu", kernels="torch", **common,
        checkpoint_dir=str(tmp_path / "port" / "checkpoints"),
        log_dir=str(tmp_path / "port" / "logs"),
        loss_dir=str(tmp_path / "port" / "loss"))
    trainer = Trainer(pcfg, initial_state=initial, devices=[CPU, CPU])
    result = trainer.train()
    assert result["steps"] == jresult["steps"] == 4
    np.testing.assert_allclose([r[2] for r in trainer.records.train_rows],
                               [r[2] for r in jtrainer.records.train_rows],
                               rtol=1e-4)
    for key in ("val_loss", "val_dice"):
        np.testing.assert_allclose(result[key], jresult[key], rtol=1e-4)


def test_cli_trains_dp_on_the_cpu(tmp_path, monkeypatch):
    """``-t DP --device cpu`` writes the DP artifacts; the manifest
    records the replica count (the CPU: one), and ``-c DP`` resumes."""
    monkeypatch.chdir(tmp_path)
    assert run_cli(["-t", "DP", "-e", "1", *CLI]) == 0
    for path in ("logs/DP.log", "checkpoints/DP.pt", "checkpoints/DP.pth",
                 "loss/DP/train_loss.pkl", "loss/DP/val_loss.pkl"):
        assert (tmp_path / path).exists(), path
    payload = torch.load(tmp_path / "checkpoints" / "DP.pt",
                         weights_only=True)
    assert payload["manifest"]["strategy"] == "DP"
    assert payload["manifest"]["devices"] == 1
    assert run_cli(["-t", "DP", "-c", "DP", "-e", "2", *CLI]) == 0
    assert torch.load(tmp_path / "checkpoints" / "DP.pt",
                      weights_only=True)["epoch"] == 2
