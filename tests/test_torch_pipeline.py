"""The port's ``-t MP`` pipeline against the JAX package's, on the CPU at a
small size (widths (8, 16), 16 × 24 images, batch 8, float32).

Every stage of the port runs on the CPU (an explicit device list that
repeats the CPU); the JAX reference is ``build_strategy(MP)`` on the
first S devices of the 8-device CPU mesh. Weights cross with
``checkpoint.params_from_jax``; inputs are numpy arrays made from seeds.
The JAX results are computed once per module (``jax_mp``). Tolerances
are relative unless marked otherwise, each stated where it is used."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.config import TrainConfig as JaxTrainConfig
from distributedpytorch_tpu.models import create_model as jax_create_model
from distributedpytorch_tpu.ops.optim import adam_l2
from distributedpytorch_tpu.parallel import pipeline as jax_pipeline
from distributedpytorch_tpu.parallel.strategy import (
    build_strategy as jax_build_strategy,
)
from distributedpytorch_tpu.train import Trainer as JaxTrainer
from distributedpytorch_tpu.train.steps import TrainState
from distributedpytorch_tpu_torch import cli
from distributedpytorch_tpu_torch.checkpoint import params_from_jax
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.models import create_model
from distributedpytorch_tpu_torch.ops import fused_loss
from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
from distributedpytorch_tpu_torch.ops.optim import make_optimizer
from distributedpytorch_tpu_torch.parallel import pipeline
from distributedpytorch_tpu_torch.parallel.strategy import build_strategy
from distributedpytorch_tpu_torch.train.loop import Trainer
from distributedpytorch_tpu_torch.train.steps import make_train_step
from torch_parallel_parity import (
    B,
    CLI,
    CPU,
    H,
    LR,
    W,
    WIDTHS,
    FirstGrads,
    assert_step_matches,
    make_batch,
    capture_then,
    jax_config,
    jax_init,
    run_cli,
    max_err_rel_to_max,
    port_config,
    port_mp,
    to_port,
    torch_batch,
)


@pytest.fixture(scope="module")
def jax_mp():
    """``jax_mp(arch, schedule, S, M)``: the JAX MP strategy's step from
    the seeded weights on ``make_batch()``, memoized: its loss, the gradients
    Adam received and the state after Adam, all under port names, and the
    initial state."""
    cache = {}

    def run(arch, schedule, stages, microbatches):
        key = (arch, schedule, stages, microbatches)
        if key not in cache:
            cfg = jax_config(arch, train_method="MP", num_stages=stages,
                              num_microbatches=microbatches,
                              pipeline_schedule=schedule)
            strategy = jax_build_strategy(cfg,
                                          devices=jax.devices()[:stages])
            model, params, model_state = jax_init(arch)
            tx = capture_then(adam_l2(LR))
            state = strategy.place_state(TrainState(
                params=params, opt_state=tx.init(params),
                step=jnp.zeros((), jnp.int32), model_state=model_state))
            new, loss = strategy.build_train_step(model, tx)(
                state, strategy.place_batch(make_batch()))
            cache[key] = {
                "initial": to_port(params, model_state),
                "loss": float(loss),
                "grads": to_port(new.opt_state[0], model_state),
                "final": to_port(new.params, new.model_state),
            }
        return cache[key]

    return run


# -- cuts and segments -----------------------------------------------------------


@pytest.mark.parametrize("num_segments", [3, 5, 7, 9])
def test_cuts_and_stage_ranges_equal_the_jax_ones(num_segments):
    for stages in range(1, num_segments + 1):
        assert (pipeline.default_cuts(num_segments, stages)
                == jax_pipeline.default_cuts(num_segments, stages))
        assert (pipeline._stage_ranges(num_segments, stages, None)
                == jax_pipeline._stage_ranges(num_segments, stages, None))
    assert (pipeline._stage_ranges(num_segments, 2, (1,))
            == jax_pipeline._stage_ranges(num_segments, 2, (1,)))
    bad = [(0, None), (num_segments + 1, None), (2, (0,)),
           (2, (num_segments,)), (3, (2, 1)), (3, (1, 1)), (2, (1, 2))]
    for stages, cuts in bad:
        with pytest.raises(ValueError) as want:
            jax_pipeline._stage_ranges(num_segments, stages, cuts)
        with pytest.raises(ValueError) as got:
            pipeline._stage_ranges(num_segments, stages, cuts)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch", ["unet", "milesial"])
def test_segments_chained_over_stages_equal_forward_bitwise(arch):
    """Both models: as many segments as the JAX model, every parameter in
    exactly one segment, and the stages of every S (on the CPU) chained
    equal to ``forward`` bit for bit, in train and in eval mode."""
    jmodel, _init = jax_create_model(jax_config(arch))
    cfg = port_config(arch)
    model = create_model(cfg, generator=torch.Generator().manual_seed(0))
    assert model.num_segments == jmodel.num_segments
    owned = [id(p) for seg in range(model.num_segments)
             for layer in model.segment_modules(seg)
             for p in layer.parameters()]
    assert sorted(owned) == sorted(id(p) for p in model.parameters())
    x = torch.from_numpy(make_batch(2)["image"])
    for train in (False, True):
        model.train(train)
        with torch.no_grad():
            want = model(x)
            for stages in range(1, model.num_segments + 1):
                carry = (x, ())
                for stage in pipeline.build_stages(model, [CPU] * stages):
                    carry = stage(carry)
                assert carry[1] == ()
                assert torch.equal(carry[0], want), (train, stages)


# -- MP steps against the JAX MP step ------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 2, 4])
@pytest.mark.parametrize("stages", [2, 3, 4])
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_mp_step_matches_the_jax_mp_step(jax_mp, schedule, stages,
                                         microbatches):
    """The UNet through ``-t MP`` on S stages and M microbatches, one Adam
    step, against the JAX MP step of the same S and schedule: loss,
    gradients and the weights after Adam within 1e-5. For a model without
    BatchNorm the JAX step computes the same function at every M (its own
    tests/test_pipeline_1f1b.py holds M = 2, 4, 8 against the plain step),
    so the JAX side runs at M = 2 only: six JAX compiles instead of
    eighteen keep this file within its time."""
    want = jax_mp("unet", schedule, stages, 2)
    _s, model, opt, step = port_mp("unet", schedule, stages, microbatches,
                                    want["initial"])
    loss = step(torch_batch(make_batch()))
    assert loss.shape == () and not loss.requires_grad
    assert_step_matches(model, opt, loss, want, weights_tol=1e-5)


def test_1f1b_equals_gpipe_directly(jax_mp):
    """The two schedules of the port from the same weights and batch, at
    S = 3 and M = 4: the same loss within 1e-6 and gradients within 1e-5
    of each tensor's largest (the same operations on the same
    microbatches; the backward of 1f1b runs stage by stage against the
    statistics' cotangent, gpipe's through one autograd pass)."""
    initial = jax_mp("unet", "gpipe", 2, 2)["initial"]
    results = {}
    for schedule in ("gpipe", "1f1b"):
        _s, _m, opt, step = port_mp("unet", schedule, 3, 4, initial)
        results[schedule] = (float(step(torch_batch(make_batch()))), opt.grads)
    np.testing.assert_allclose(results["1f1b"][0], results["gpipe"][0],
                               rtol=1e-6)
    for name, g in results["gpipe"][1].items():
        err = max_err_rel_to_max(results["1f1b"][1][name].numpy(),
                                  g.numpy())
        assert err <= 1e-5, (name, err)


# -- milesial --------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_milesial_mp_at_one_microbatch_equals_the_singlegpu_step(jax_mp,
                                                                 schedule):
    """M = 1: the microbatch is the batch, so BatchNorm normalizes over
    what the single-device step normalizes over. Loss within 1e-5,
    gradients within 1e-4 of each tensor's largest, and every running
    statistic within 1e-5 of the plain port step's."""
    initial = jax_mp("milesial", "gpipe", 2, 2)["initial"]
    _s, model, opt, step = port_mp("milesial", schedule, 2, 1, initial)
    loss = float(step(torch_batch(make_batch())))
    ref = create_model(port_config("milesial"))
    ref.load_state_dict(initial)
    ref_opt = FirstGrads(make_optimizer(ref.parameters(), LR),
                          ref.named_parameters())
    ref_loss = float(make_train_step(ref, ref_opt, B)(torch_batch(make_batch())))
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    for name, g in ref_opt.grads.items():
        assert max_err_rel_to_max(opt.grads[name].numpy(),
                                   g.numpy()) <= 1e-4, name
    ref_state = ref.state_dict()
    for key, value in model.state_dict().items():
        if "running" in key:
            assert max_err_rel_to_max(value.numpy(),
                                       ref_state[key].numpy()) <= 1e-5, key
        if key.endswith("num_batches_tracked"):
            assert int(value) == 1, key


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_milesial_mp_at_two_microbatches_matches_the_jax_mp_step(jax_mp,
                                                                 schedule):
    """M = 2: statistics per microbatch, the running averages moved twice
    in microbatch order; against the JAX MP step of the same schedule:
    loss, gradients, running statistics within 1e-5 of their largest and
    the weights after Adam."""
    want = jax_mp("milesial", schedule, 2, 2)
    _s, model, opt, step = port_mp("milesial", schedule, 2, 2,
                                    want["initial"])
    loss = step(torch_batch(make_batch()))
    assert_step_matches(model, opt, loss, want, weights_tol=1e-5)
    for key, value in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            assert int(value) == 2, key


def test_1f1b_phase_b_leaves_the_running_statistics_where_phase_a_put_them(
        jax_mp):
    """A 1f1b step moves the running averages exactly as its phase A, the
    forward-only fill-drain pass, does alone: bit for bit, and once per
    microbatch (phase B's forward ticks and recomputations run frozen)."""
    initial = jax_mp("milesial", "gpipe", 2, 2)["initial"]
    _s, model, _opt, step = port_mp("milesial", "1f1b", 2, 2, initial)
    step(torch_batch(make_batch()))
    after_step = {k: v.clone() for k, v in model.named_buffers()}

    phase_a = create_model(port_config("milesial"))
    phase_a.load_state_dict(initial)
    stages = pipeline.build_stages(phase_a, [CPU, CPU])
    images = torch.from_numpy(make_batch()["image"])
    phase_a.train()
    with torch.no_grad():
        pipeline.fill_drain(stages, [(images[:4], ()), (images[4:], ())],
                            lambda m, y: y)
    for key, value in phase_a.named_buffers():
        assert torch.equal(after_step[key], value), key
        if key.endswith("num_batches_tracked"):
            assert int(value) == 2


# -- memory bound -------------------------------------------------------------------


@pytest.mark.parametrize("stages", [2, 3, 4])
def test_1f1b_holds_at_most_s_minus_s_carries_whatever_m_is(jax_mp, stages):
    """The live input carries per stage over one step: 1f1b's peak at
    stage s is min(S − s, M), so at most S − s and the same at M = 4 and
    M = 8 (both ≥ S); gpipe keeps every microbatch's graph until its
    backward, so its peak is M at every stage."""
    initial = jax_mp("unet", "gpipe", 2, 2)["initial"]
    peaks = {}
    for schedule in ("gpipe", "1f1b"):
        for microbatches in (2, 4, 8):
            _s, _m, _o, step = port_mp("unet", schedule, stages,
                                        microbatches, initial)
            step(torch_batch(make_batch()))
            assert step.live.now == [0] * stages
            peaks[(schedule, microbatches)] = step.live.peak
    for microbatches in (2, 4, 8):
        assert peaks[("1f1b", microbatches)] == [
            min(stages - s, microbatches) for s in range(stages)]
        assert peaks[("gpipe", microbatches)] == [microbatches] * stages
    assert peaks[("1f1b", 4)] == peaks[("1f1b", 8)] == list(
        range(stages, 0, -1))


# -- eval -------------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["unet", "milesial"])
def test_pipelined_eval_matches_the_jax_mp_eval_step(arch):
    """The pipelined forward in eval mode (milesial on its running
    averages) gathered on the last stage: loss and Dice within 1e-5 of
    the JAX MP ``build_eval_step``'s, at S = 3 and M = 2."""
    cfg = jax_config(arch, train_method="MP", num_stages=3,
                      num_microbatches=2)
    strategy = jax_build_strategy(cfg, devices=jax.devices()[:3])
    model, params, model_state = jax_init(arch)
    variables = (params if model_state is None
                 else {"params": params, "batch_stats": model_state})
    want = strategy.build_eval_step(model)(
        variables, strategy.place_batch(make_batch(seed=5)))
    port = build_strategy(port_config(arch, train_method="MP", num_stages=3),
                          devices=[CPU] * 3)
    pmodel = create_model(port_config(arch))
    pmodel.load_state_dict(to_port(params, model_state))
    pmodel = port.place_model(pmodel)
    got = port.build_eval_step(pmodel, get_kernel_policy("torch"))(
        torch_batch(make_batch(seed=5)))
    for key in ("loss", "dice"):
        assert got[key].shape == ()
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5)


# -- the kernel policy on the CPU ---------------------------------------------------


@pytest.mark.parametrize("schedule,stats_calls", [("gpipe", 2),
                                                   ("1f1b", 4)])
def test_cuda_policy_picks_the_fused_statistics(jax_mp, monkeypatch,
                                                schedule, stats_calls):
    """Under ``--kernels cuda`` each microbatch's statistics go through
    ``BCEDiceStatsFused``, whose plain versions run on the CPU: M calls of
    the statistics (2M under 1f1b: phase A, then the recomputation) and M
    of their backward per step, as K1 and K1-bwd launch on the card. The
    loss equals the plain statistics' within 1e-6."""
    initial = jax_mp("unet", "gpipe", 2, 2)["initial"]
    calls = {"stats": 0, "bwd": 0}
    real_stats, real_bwd = fused_loss.bce_dice_stats_kernel, \
        fused_loss.stats_bwd

    def stats(p, t):
        calls["stats"] += 1
        return real_stats(p, t)

    def bwd(o, t, ct):
        calls["bwd"] += 1
        return real_bwd(o, t, ct)

    monkeypatch.setattr(fused_loss, "bce_dice_stats_kernel", stats)
    monkeypatch.setattr(fused_loss, "stats_bwd", bwd)
    _s, _m, _o, step = port_mp("unet", schedule, 2, 2, initial,
                                kernels="cuda")
    fused = float(step(torch_batch(make_batch())))
    assert calls == {"stats": stats_calls, "bwd": 2}
    _s, _m, _o, plain_step = port_mp("unet", schedule, 2, 2, initial)
    np.testing.assert_allclose(fused, float(plain_step(
        torch_batch(make_batch()))), rtol=1e-6)


# -- the trainer and the CLI ------------------------------------------------------------


def test_one_epoch_through_the_trainer_matches_the_jax_mp_trainer(tmp_path):
    """``Trainer`` under ``-t MP`` (gpipe, S = 2, M = 2) against the JAX
    trainer's MP from the same weights: --synthetic 40 -v 20 -b 8, 4 steps
    and 1 val batch. Losses and the val metrics within 1e-4 (as
    tests/test_torch_train.py holds singleGPU); the manifest records the
    pipeline."""
    common = dict(epochs=1, batch_size=B, val_percent=20.0, seed=42,
                  image_size=(W, H), model_widths=WIDTHS,
                  synthetic_samples=40, metric_every_steps=1, num_workers=0,
                  s2d_levels=0, train_method="MP", num_stages=2,
                  num_microbatches=2, dtype="f32", kernels=None)
    jcfg = JaxTrainConfig(
        async_checkpoint=False, **dict(common, kernels="xla"),
        checkpoint_dir=str(tmp_path / "jax" / "checkpoints"),
        log_dir=str(tmp_path / "jax" / "logs"),
        loss_dir=str(tmp_path / "jax" / "loss"))
    jtrainer = JaxTrainer(jcfg)
    initial = params_from_jax(jax.device_get(jtrainer.state.params))
    jresult = jtrainer.train()
    pcfg = TrainConfig(
        device="cpu", **dict(common, kernels="torch"),
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
    manifest = torch.load(trainer.checkpoint_path,
                          weights_only=True)["manifest"]
    assert {k: manifest[k] for k in ("strategy", "stages", "microbatches",
                                     "schedule")} == {
        "strategy": "MP", "stages": 2, "microbatches": 2,
        "schedule": "gpipe"}


@pytest.mark.parametrize("arch", ["unet", "milesial"])
def test_cli_trains_mp_and_resumes_across_methods(tmp_path, monkeypatch,
                                                  arch):
    """``-t MP --device cpu`` (1f1b, S = 3) writes the MP artifacts; ``-c
    MP`` resumes them under ``-t singleGPU`` for a second epoch, and that
    checkpoint resumes under ``-t MP`` at S = 2: the state dict has the
    singleGPU keys under every method."""
    monkeypatch.chdir(tmp_path)
    model = ["--model", arch]
    assert run_cli(["-t", "MP", "--stages", "3", "--pipeline-schedule",
                  "1f1b", "-e", "1", *model, *CLI]) == 0
    for path in ("logs/MP.log", "checkpoints/MP.pt", "checkpoints/MP.pth",
                 "loss/MP/train_loss.pkl"):
        assert os.path.exists(path), path
    mp_state = torch.load("checkpoints/MP.pt", weights_only=True)
    assert mp_state["manifest"]["stages"] == 3
    assert run_cli(["-t", "singleGPU", "-c", "MP", "-e", "2", *model,
                  *CLI]) == 0
    single = torch.load("checkpoints/singleGPU.pt", weights_only=True)
    assert single["epoch"] == 2 and single["step"] == 2 * mp_state["step"]
    assert set(single["model"]) == set(mp_state["model"])
    assert run_cli(["-t", "MP", "-c", "singleGPU", "-e", "3", *model,
                  *CLI]) == 0
    again = torch.load("checkpoints/MP.pt", weights_only=True)
    assert again["epoch"] == 3 and again["manifest"]["stages"] == 2
    assert "Resumed from" in open("logs/MP.log").read()


def test_mp_refuses_too_few_devices_and_grad_accum(tmp_path, monkeypatch):
    """Without a device list ``-t MP`` takes the first S cards and raises
    the JAX package's error when fewer are visible (a one-card machine
    stood in for by the CPU build); ``--grad-accum`` raises with the JAX
    message, and an unknown schedule is refused."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="Requires at least 2 devices, "
                                         "got 1"):
        build_strategy(TrainConfig(train_method="MP"))
    with pytest.raises(ValueError, match="Requires at least 3 devices"):
        run_cli(["-t", "MP", "--stages", "3", "--synthetic", "4"])
    monkeypatch.undo()
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="raise --microbatches instead of "
                                         "--grad-accum"):
        run_cli(["-t", "MP", "--grad-accum", "2", "-e", "1", *CLI])
    with pytest.raises(ValueError, match="pipeline_schedule"):
        build_strategy(TrainConfig(train_method="MP", device="cpu",
                                   pipeline_schedule="zb"))
    with pytest.raises(SystemExit):
        cli.get_args(["--pipeline-schedule", "zb"])
    assert dataclasses.asdict(cli.to_config(cli.get_args(
        ["--stages", "3", "--microbatches", "4", "--pipeline-cuts", "2", "4",
         "--pipeline-schedule", "1f1b"])))["pipeline_cuts"] == (2, 4)
