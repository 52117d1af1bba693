"""The port's run control against the JAX trainer's, on the CPU at a small
size (widths (8, 16), 32 × 48 images, float32): ``--remat``, K steps per
dispatch, the non-finite policies, checkpoint retention, the hash
fallback, async writes, ``--save-best``, ``--early-stop`` and the CLI's
flags.

Weights cross with ``checkpoint.params_from_jax``; inputs are numpy
arrays made from seeds. Each tolerance is stated where it is used."""

import dataclasses
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.config import TrainConfig as JaxTrainConfig
from distributedpytorch_tpu.ops.optim import adam_l2
from distributedpytorch_tpu.parallel.strategy import (
    build_strategy as jax_build_strategy,
)
from distributedpytorch_tpu.train import Trainer as JaxTrainer
from distributedpytorch_tpu.train import steps as jsteps
from distributedpytorch_tpu.utils import faults as jax_faults
from distributedpytorch_tpu.utils.faults import (
    NonFiniteLossError as JaxNonFiniteLossError,
)
from distributedpytorch_tpu_torch import checkpoint, cli
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.dist.runtime import RuntimeInfo
from distributedpytorch_tpu_torch.models import create_model
from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
from distributedpytorch_tpu_torch.ops.optim import make_optimizer
from distributedpytorch_tpu_torch.parallel.strategy import (
    SingleDevice,
    build_strategy,
    check_run_control,
)
from distributedpytorch_tpu_torch.train import steps
from distributedpytorch_tpu_torch.train.loop import (
    NonFiniteLossError,
    Placed,
    Trainer,
)
from distributedpytorch_tpu_torch.utils.trace import load_events
from torch_parallel_parity import (
    FirstGrads,
    assert_step_matches,
    capture_then,
    jax_config,
    jax_init,
    make_batch,
    port_mp,
    run_cli,
    to_port,
    torch_batch,
)

H, W = 32, 48
WIDTHS = (8, 16)
LR = 1e-4
ARCHS = ["unet", "milesial"]
CPU = torch.device("cpu")


def _batch(b=2, seed=1):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((b, H, W, 3), np.float32),
            "mask": (rng.random((b, H, W)) > 0.6).astype(np.int32)}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _configs(tmp_path, **kw):
    """The JAX and the port config of one small run, in their own
    directories: --synthetic 16 -v 25 -b 2 (12 train, 4 val samples),
    float32, plain kernels."""
    common = dict(
        epochs=1, batch_size=2, val_percent=25.0, seed=42,
        image_size=(W, H), model_widths=WIDTHS, synthetic_samples=16,
        metric_every_steps=1, num_workers=0, s2d_levels=0, dtype="f32",
    )
    common.update(kw)
    jcfg = JaxTrainConfig(
        kernels="xla", checkpoint_dir=str(tmp_path / "jax" / "checkpoints"),
        log_dir=str(tmp_path / "jax" / "logs"),
        loss_dir=str(tmp_path / "jax" / "loss"),
        **{"async_checkpoint": False, **common})
    pcfg = TrainConfig(
        kernels="torch", device="cpu",
        checkpoint_dir=str(tmp_path / "port" / "checkpoints"),
        log_dir=str(tmp_path / "port" / "logs"),
        loss_dir=str(tmp_path / "port" / "loss"), **common)
    return jcfg, pcfg


def _port_config(tmp_path, **kw):
    return _configs(tmp_path, **kw)[1]


def _jax_then_port(jcfg, pcfg, nan_at=None):
    """Both trainers from the JAX trainer's initial weights; their results
    and train losses (or the exception each raised). ``nan_at = (epoch,
    step)`` makes that global step's loss read NaN once on both sides
    (``_nan_once``)."""
    # a fresh injector: re-installing the same spec list keeps its counts
    jax_faults.install(())
    if nan_at is not None:
        jcfg = dataclasses.replace(
            jcfg, inject_faults=(f"nan_loss:{nan_at[0]}:{nan_at[1]}",))
    jtrainer = JaxTrainer(jcfg)
    initial = to_port(jtrainer.state.params, jtrainer.state.model_state)
    trainer = Trainer(pcfg, initial_state=initial)
    if nan_at is not None:
        _nan_once(trainer, nan_at[1])
    out = {}
    for side, run in (("jax", jtrainer), ("port", trainer)):
        try:
            result = run.train()
        except (NonFiniteLossError, JaxNonFiniteLossError) as exc:
            out[side] = exc
            continue
        out[side] = (result, [float(r[2]) for r in run.records.train_rows])
    return out


def _nan_once(trainer, at_step):
    """The port's counterpart of the JAX ``nan_loss`` fault site
    (utils/faults.py): global step ``at_step`` runs, and its loss reads
    NaN, once. A batch of NaN pixels would not do: the loss clamps its
    logs, so NaN predictions give a finite loss (200, and NaN weights) on
    both sides."""
    real = trainer.train_step
    fired = []

    def step(batch):
        loss = real(batch)
        if trainer.step + 1 == at_step and not fired:
            fired.append(at_step)
            return loss * float("nan")
        return loss

    trainer.train_step = step


def _assert_runs_match(out, rtol=1e-4):
    """Losses, val loss and val Dice within ``rtol``: float32 forwards
    summed in other orders and Adam's first steps (test_torch_train.py's
    epoch bound)."""
    (jres, jlosses), (res, losses) = out["jax"], out["port"]
    assert res["steps"] == jres["steps"]
    np.testing.assert_allclose(losses, jlosses, rtol=rtol)
    for key in ("val_loss", "val_dice"):
        np.testing.assert_allclose(res[key], jres[key], rtol=rtol)


# -- remat --------------------------------------------------------------------------


def _port_step(arch, initial, remat, fused=False, dtype="f32"):
    cfg = TrainConfig(model_arch=arch, model_widths=WIDTHS, dtype=dtype,
                      device="cpu", kernels="cuda" if fused else "torch",
                      wgrad_taps=arch == "milesial")
    model = create_model(cfg)
    model.load_state_dict(initial)
    opt = FirstGrads(make_optimizer(model.parameters(), LR),
                     model.named_parameters())
    step = steps.make_train_step(model, opt, 2, train_loss_fused=fused,
                                 remat=remat)
    return model, opt, step


def _seeded_initial(arch):
    cfg = TrainConfig(model_arch=arch, model_widths=WIDTHS, dtype="f32",
                      device="cpu")
    return create_model(cfg, generator=torch.Generator().manual_seed(0)
                        ).state_dict()


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_step_is_bitwise_the_plain_step(arch, fused):
    """Two steps with ``remat`` and two without, from the same weights
    (milesial with ``--wgrad-taps``; ``fused`` runs the kernels' plain
    versions): the losses, the first step's gradients and the state after
    them bitwise equal — the recompute runs the same operations — and
    milesial's running statistics moved once per step
    (``num_batches_tracked`` 2), not twice."""
    initial = _seeded_initial(arch)
    runs = []
    for remat in (False, True):
        model, opt, step = _port_step(arch, initial, remat, fused)
        losses = [step(_tb(_batch(2, seed))) for seed in (1, 2)]
        runs.append((losses, opt.grads, model.state_dict()))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert [float(x) for x in l0] == [float(x) for x in l1]
    for name, g in g0.items():
        assert torch.equal(g, g1[name]), name
    for key, value in s0.items():
        assert torch.equal(value, s1[key]), key
        if key.endswith("num_batches_tracked"):
            assert int(value) == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_step_matches_jax_remat(arch):
    """One step under ``remat`` against the JAX ``make_train_step(remat=
    True)`` from the same weights: the loss within 1e-5 and every
    gradient within 1e-4 of its tensor's largest, the bounds of the plain
    step's test (test_torch_train.py), milesial's running statistics
    within 1e-5 of their largest."""
    from distributedpytorch_tpu.models import create_model as jax_create

    jcfg = JaxTrainConfig(model_arch=arch, model_widths=WIDTHS, dtype="f32",
                          image_size=(W, H), s2d_levels=0,
                          wgrad_taps=arch == "milesial")
    jmodel, init_fn = jax_create(jcfg)
    params, model_state = init_fn(jax.random.key(0), (H, W))
    tx = capture_then(adam_l2(LR))
    state = jsteps.TrainState(params=params, opt_state=tx.init(params),
                              step=jnp.zeros((), jnp.int32),
                              model_state=model_state)
    jstep = jax.jit(jsteps.make_train_step(jmodel, tx, 2, remat=True))
    batch = _batch()
    new, jloss = jstep(state, batch)
    model, opt, step = _port_step(arch, to_port(params, model_state), True)
    loss = step(_tb(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = to_port(new.opt_state[0], model_state)
    for name, g in opt.grads.items():
        ref = want[name].numpy()
        err = np.abs(g.numpy() - ref).max() / np.abs(ref).max()
        assert err <= 1e-4, (name, err)
    final = to_port(new.params, new.model_state)
    for key, value in model.state_dict().items():
        if "running" in key:
            ref = final[key].numpy()
            err = np.abs(value.numpy() - ref).max() / np.abs(ref).max()
            assert err <= 1e-5, (key, err)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_mp_remat_matches_the_jax_mp_remat(schedule):
    """``-t MP --remat`` at S = 2, M = 2 against the JAX MP step with
    ``remat=True`` (the UNet, 16 × 24, batch 8): loss, gradients and the
    weights after Adam within the MP tests' bounds
    (``assert_step_matches``, 1e-5 for the weights)."""
    cfg = jax_config("unet", train_method="MP", num_stages=2,
                     num_microbatches=2, pipeline_schedule=schedule,
                     remat=True)
    strategy = jax_build_strategy(cfg, devices=jax.devices()[:2])
    model, params, model_state = jax_init("unet")
    tx = capture_then(adam_l2(LR))
    state = strategy.place_state(jsteps.TrainState(
        params=params, opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32), model_state=model_state))
    new, jloss = strategy.build_train_step(model, tx)(
        state, strategy.place_batch(make_batch()))
    want = {"loss": float(jloss),
            "grads": to_port(new.opt_state[0], model_state),
            "final": to_port(new.params, new.model_state)}
    _s, pmodel, opt, step = port_mp("unet", schedule, 2, 2,
                                    to_port(params, model_state),
                                    remat=True)
    loss = step(torch_batch(make_batch()))
    assert_step_matches(pmodel, opt, loss, want, weights_tol=1e-5)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_milesial_mp_remat_is_bitwise_the_plain_mp_step(schedule):
    """milesial under ``-t MP`` at S = 2, M = 2 with and without
    ``--remat``: the loss, the gradients and the state after the step
    (running statistics moved once per microbatch) bitwise equal."""
    initial = to_port(*jax_init("milesial")[1:])
    runs = []
    for remat in (False, True):
        _s, model, opt, step = port_mp("milesial", schedule, 2, 2, initial,
                                       remat=remat)
        loss = step(torch_batch(make_batch()))
        runs.append((float(loss), opt.grads, model.state_dict()))
    assert runs[0][0] == runs[1][0]
    for name, g in runs[0][1].items():
        assert torch.equal(g, runs[1][1][name]), name
    for key, value in runs[0][2].items():
        assert torch.equal(value, runs[1][2][key]), key


def _dp_cli(tmp_path, monkeypatch, *flags):
    """The training CLI under ``-t DP`` with ``flags`` on the CPU, one
    epoch of --synthetic 16 -b 4 (3 steps), in ``tmp_path``."""
    monkeypatch.chdir(tmp_path)
    return run_cli(["-t", "DP", *flags, "--synthetic", "16", "--image-size",
                    str(W), str(H), "--model-widths", "8", "16", "-b", "4",
                    "-v", "25", "-e", "1", "--device", "cpu",
                    "--num-workers", "0", "--dtype", "f32"])


def test_remat_under_dp_raises(tmp_path, monkeypatch):
    """``-t DP --remat``, refused before the replicas' recompute kept the
    meeting's moments, now builds through ``build_strategy`` on ``[cpu,
    cpu]`` and steps (a finite loss, every BatchNorm's running averages
    moved once), and the CLI trains its epoch with it."""
    cfg = _port_config(tmp_path, train_method="DP", remat=True,
                       model_arch="milesial", batch_size=4)
    strategy = build_strategy(cfg, devices=[CPU, CPU])
    model = strategy.place_model(create_model(cfg))
    step = strategy.build_train_step(model, make_optimizer(
        model.parameters(), LR), get_kernel_policy("torch"))
    assert np.isfinite(float(step(_tb(_batch(b=4)))))
    tracked = [v for k, v in model.state_dict().items()
               if k.endswith("num_batches_tracked")]
    assert tracked and all(int(v) == 1 for v in tracked)
    assert _dp_cli(tmp_path, monkeypatch, "--remat") == 0
    assert (tmp_path / "checkpoints" / "DP.pt").exists()


# -- K steps per dispatch --------------------------------------------------------


def test_k_steps_equal_single_steps_with_one_readback_per_row(tmp_path):
    """``--steps-per-dispatch 3`` and 1 on the same data and weights: the
    same losses bit for bit and the same weights; with a row every 3
    steps, every row is one ``readback`` span of the timeline, and each
    dispatch span of the K run carries K = 3."""
    results = {}
    for k in (1, 3):
        cfg = _port_config(tmp_path / f"k{k}", steps_per_dispatch=k,
                           metric_every_steps=3, epochs=2,
                           timeline_path=str(tmp_path / f"k{k}.jsonl"))
        trainer = Trainer(cfg)
        result = trainer.train()
        results[k] = (trainer, result, load_events(cfg.timeline_path))
    (t1, r1, _e1), (t3, r3, e3) = results[1], results[3]
    assert r1["steps"] == r3["steps"] == 12
    assert ([float(x) for x in t1.records.losses]
            == [float(x) for x in t3.records.losses])
    for a, b in zip(t1.model.state_dict().values(),
                    t3.model.state_dict().values()):
        assert torch.equal(a, b)
    readbacks = [e for e in e3 if e["phase"] == "readback"]
    assert sum(e["rows"] for e in readbacks) == len(t3.records.train_rows)
    assert len(readbacks) == len(t3.records.train_rows) == 4
    assert {e["k"] for e in e3 if e["phase"] == "dispatch"} == {3}


def test_k_step_epoch_matches_the_jax_trainer_with_a_ragged_tail(tmp_path):
    """``--synthetic 14 -v 25 -b 2 --steps-per-dispatch 3``: 11 train
    samples, one K-stack of 3 steps, then two buffered full batches and
    the ragged one as single steps; the epoch against the JAX trainer
    with ``steps_per_dispatch=3`` within the epoch bound (1e-4)."""
    jcfg, pcfg = _configs(tmp_path, synthetic_samples=14,
                          steps_per_dispatch=3)
    out = _jax_then_port(jcfg, pcfg)
    assert out["port"][0]["steps"] == 6
    _assert_runs_match(out)


@pytest.mark.parametrize("kw,message", [
    (dict(steps_per_dispatch=2, grad_accum=2),
     "--steps-per-dispatch and --grad-accum both stack"),
    (dict(nonfinite_policy="skip", steps_per_dispatch=2),
     "--nonfinite-policy skip discards one STEP"),
    (dict(nonfinite_policy="skip", grad_accum=2),
     "--nonfinite-policy skip discards one STEP"),
    (dict(early_stop_patience=-1), "early_stop_patience must be >= 0"),
])
def test_the_jax_refusals_carry_over_word_for_word(tmp_path, kw, message):
    jcfg, pcfg = _configs(tmp_path, **kw)
    with pytest.raises(ValueError, match=message) as jax_err:
        JaxTrainer(jcfg)
    with pytest.raises(ValueError, match=message) as port_err:
        Trainer(pcfg)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("method", ["DDP", "DP", "DDP_MP"])
def test_k_steps_outside_single_gpu_raise(tmp_path, monkeypatch, method):
    """What stays refused of K > 1 outside singleGPU, with the ROADMAP
    pointer: a gloo group on a card under the multi-process methods,
    through the check with the strategy's device and backend (gloo moves
    CUDA tensors through the host). Gloo on the CPU and NCCL on a card
    pass the check. ``-t DP``, refused before its replica threads ran on
    the caller's streams, builds through ``build_strategy`` and its
    multi-step, passes the check on a card, and the CLI trains its epoch
    at K = 2 (a stack of two steps and a tail of one)."""
    cfg = _port_config(tmp_path, train_method=method, steps_per_dispatch=2)
    if method == "DP":
        strategy = build_strategy(cfg, devices=[CPU, CPU])
        assert strategy.build_multi_train_step(lambda batch: None).steps == 2
        check_run_control(cfg, torch.device("cuda", 0), None)
        assert _dp_cli(tmp_path, monkeypatch, "--steps-per-dispatch",
                       "2") == 0
        assert (tmp_path / "checkpoints" / "DP.pt").exists()
        return
    with pytest.raises(ValueError,
                       match=f"under -t {method} over a gloo group on "
                             "cuda:0: gloo moves CUDA tensors through the "
                             "host.*ROADMAP"):
        check_run_control(cfg, torch.device("cuda", 0), "gloo")
    check_run_control(cfg, CPU, "gloo")
    check_run_control(cfg, torch.device("cuda", 0), "nccl")
    check_run_control(dataclasses.replace(cfg, steps_per_dispatch=1),
                      torch.device("cuda", 0), "gloo")


# -- the non-finite policies -----------------------------------------------------


def test_skip_matches_the_jax_trainer(tmp_path):
    """Step 2's loss reads NaN under ``skip``: both trainers put back the
    state from before it (``skipped_steps`` 1, one step fewer) and the
    epoch agrees within the epoch bound (1e-4)."""
    jcfg, pcfg = _configs(tmp_path, nonfinite_policy="skip")
    out = _jax_then_port(jcfg, pcfg, nan_at=(0, 2))
    assert out["port"][0]["skipped_steps"] == out["jax"][0][
        "skipped_steps"] == 1
    assert out["port"][0]["steps"] == 5
    _assert_runs_match(out)


def test_skip_puts_back_the_whole_state(tmp_path):
    """The state after a skipped step equals the state before it, bit for
    bit: parameters, BatchNorm buffers, Adam's moments and step count,
    and the trainer's step count."""
    cfg = _port_config(tmp_path, model_arch="milesial",
                       nonfinite_policy="skip")
    trainer = Trainer(cfg)
    trainer.train_step(_tb(_batch()))  # Adam's state exists
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    opt_before = {id(p): {k: v.clone() for k, v in s.items()}
                  for p, s in trainer.optimizer.state.items()}
    _nan_once(trainer, 1)
    batch = _batch(seed=3)
    trainer._run_one(batch, Placed(_tb(batch)))
    assert trainer._skipped_steps == 1 and trainer.step == 0
    for key, value in trainer.model.state_dict().items():
        assert torch.equal(value, before[key]), key
    for p, s in trainer.optimizer.state.items():
        for k, v in s.items():
            assert torch.equal(v, opt_before[id(p)][k]), k


def test_rollback_matches_the_jax_trainer(tmp_path):
    """Step 8's loss (epoch 1 of 2) reads NaN under ``rollback``: both
    trainers reload epoch 0's checkpoint, redo epoch 1 (clean the second
    time) and report ``rollbacks`` 1; the run agrees within the epoch
    bound."""
    jcfg, pcfg = _configs(tmp_path, nonfinite_policy="rollback", epochs=2)
    out = _jax_then_port(jcfg, pcfg, nan_at=(1, 8))
    assert out["port"][0]["rollbacks"] == out["jax"][0]["rollbacks"] == 1
    assert out["port"][0]["steps"] == 12
    _assert_runs_match(out)


def test_an_exhausted_rollback_budget_aborts_like_the_jax_trainer(tmp_path):
    """``--rollback-retries 0``: both trainers raise their
    NonFiniteLossError for the same step."""
    jcfg, pcfg = _configs(tmp_path, nonfinite_policy="rollback", epochs=2,
                          rollback_retries=0)
    out = _jax_then_port(jcfg, pcfg, nan_at=(1, 8))
    assert isinstance(out["jax"], JaxNonFiniteLossError)
    assert isinstance(out["port"], NonFiniteLossError)
    assert str(out["port"]) == str(out["jax"])


def test_rollback_in_a_multi_process_run_aborts(tmp_path, caplog):
    """A strategy of world 2 (rank 0) in this one process: the rollback
    policy aborts instead of reloading, as in JAX."""
    cfg = _port_config(tmp_path, nonfinite_policy="rollback", epochs=2)
    strategy = SingleDevice(cfg, RuntimeInfo(0, 2, device=CPU))
    trainer = Trainer(cfg, strategy=strategy)
    _nan_once(trainer, 8)
    with caplog.at_level(logging.ERROR), pytest.raises(NonFiniteLossError):
        trainer.train()
    assert "rollback policy is single-process" in caplog.text
    assert trainer._rollback_budget == cfg.rollback_retries


# -- checkpoints -----------------------------------------------------------------


def test_retention_keeps_the_newest_two(tmp_path):
    cfg = _port_config(tmp_path, epochs=3, keep_checkpoints=2)
    Trainer(cfg).train()
    path = os.path.join(cfg.checkpoint_dir, "singleGPU.pt")
    assert checkpoint.retained_checkpoints(path) == [path, path + ".1"]
    assert not os.path.exists(path + ".2")
    assert [checkpoint.load_native(p)["epoch"] for p in (path,)] == [3]
    assert checkpoint._read_verified(path + ".1")["epoch"] == 2


def test_a_corrupt_newest_file_falls_back_with_a_warning(tmp_path, caplog):
    cfg = _port_config(tmp_path, epochs=2)
    Trainer(cfg).train()
    path = os.path.join(cfg.checkpoint_dir, "singleGPU.pt")
    with open(path, "r+b") as f:
        f.seek(200)
        f.write(b"\0" * 64)
    with caplog.at_level(logging.WARNING):
        resumed = Trainer(dataclasses.replace(cfg, epochs=3,
                                              checkpoint_name="singleGPU"))
    assert resumed.start_epoch == 1
    assert "content hash mismatch" in caplog.text
    assert "restored the newest intact retained file" in caplog.text
    os.remove(path + ".1")
    with pytest.raises(checkpoint.CheckpointCorruptError):
        checkpoint.load_native(path)


def test_an_async_write_error_is_raised(tmp_path, monkeypatch):
    def fail(*_a, **_k):
        raise OSError("disk full")

    cfg = _port_config(tmp_path, async_checkpoint=True)
    trainer = Trainer(cfg)
    monkeypatch.setattr(checkpoint, "write_payload", fail)
    with pytest.raises(OSError, match="disk full"):
        trainer.train()


def test_save_best_writes_on_a_higher_dice(tmp_path):
    cfg = _port_config(tmp_path, epochs=3, save_best=True)
    trainer = Trainer(cfg)
    trainer.train()
    dices = [r[2] for r in trainer.records.dice_rows]
    best = checkpoint.load_native(trainer.best_checkpoint_path)
    assert best["epoch"] == 1 + int(np.argmax(dices))
    assert best["train_meta"]["best_dice"] == max(dices)


def test_early_stop_stops_with_a_final_save(tmp_path):
    """lr 0 leaves the val loss where it is: ``--early-stop 1`` stops at
    the second epoch and saves it."""
    cfg = _port_config(tmp_path, epochs=5, early_stop_patience=1,
                       learning_rate=0.0)
    trainer = Trainer(cfg)
    result = trainer.train()
    assert result["steps"] == 2 * 6
    assert trainer._stale_epochs == 1
    assert checkpoint.load_native(trainer.checkpoint_path)["epoch"] == 2


def test_best_and_stale_state_survive_a_resume(tmp_path):
    """The trainer's small state rides in the checkpoint and comes back
    on ``-c``. As in the JAX trainer, an epoch's checkpoint is written
    before that epoch's early-stop count moves (loop.py:1224-1254), so
    the third epoch's file holds the count after the second."""
    cfg = _port_config(tmp_path, epochs=3, early_stop_patience=3,
                       save_best=True, learning_rate=0.0)
    first = Trainer(cfg)
    first.train()
    saved = checkpoint.load_native(first.checkpoint_path)["train_meta"]
    assert saved["stale_epochs"] == 1 and first._stale_epochs == 2
    resumed = Trainer(dataclasses.replace(cfg, epochs=4,
                                          checkpoint_name="singleGPU"))
    assert resumed._stale_epochs == 1
    assert resumed._best_dice == saved["best_dice"] == first._best_dice
    assert resumed._best_loss == saved["best_loss"] == first._best_loss


def test_a_graphed_runs_optimizer_state_resumes_on_the_cpu():
    """An Adam state saved capturable (a K-step graph's: the lr a tensor)
    loads into this run's plain Adam as this run's
    (``load_optimizer_state``): not capturable, a float lr, the step
    counts on the CPU; the next step runs and equals the step from the
    same state saved plain. torch's own ``load_state_dict`` would take
    the capturable group whole, and a capturable Adam refuses CPU
    tensors."""
    import copy

    from distributedpytorch_tpu_torch.ops.optim import load_optimizer_state

    def fresh():
        p = torch.nn.Parameter(torch.linspace(-1.0, 1.0, 8))
        return p, make_optimizer([p], 1e-3)

    p, opt = fresh()
    p.grad = torch.linspace(0.5, -0.25, 8)
    opt.step()
    plain = copy.deepcopy(opt.state_dict())
    graphed = copy.deepcopy(plain)
    graphed["param_groups"][0].update(capturable=True,
                                      lr=torch.tensor(1e-3))
    after = []
    for state in (plain, graphed):
        q, o = fresh()
        with torch.no_grad():
            q.copy_(p)
        load_optimizer_state(o, state)
        group = o.param_groups[0]
        assert group["capturable"] is False
        assert isinstance(group["lr"], float)
        assert o.state[q]["step"].device.type == "cpu"
        q.grad = torch.linspace(-0.125, 0.75, 8)
        o.step()
        after.append(q.detach().clone())
    assert torch.equal(after[0], after[1])


def test_skip_puts_back_the_master_weights(tmp_path):
    """Under ``bf16_params`` a skipped step puts back the f32 master and
    Adam's state over it, bit for bit, and the bf16 parameters stay the
    master rounded."""
    cfg = _port_config(tmp_path, dtype="bf16_params",
                       nonfinite_policy="skip")
    trainer = Trainer(cfg)
    trainer.train_step(_tb(_batch()))  # Adam's state exists
    opt = trainer.optimizer
    master = [m.clone() for m in opt.master]
    moments = [v.clone() for s in opt.state.values() for v in s.values()]
    _nan_once(trainer, 1)
    batch = _batch(seed=3)
    trainer._run_one(batch, Placed(_tb(batch)))
    assert trainer._skipped_steps == 1
    assert all(torch.equal(a, b) for a, b in zip(opt.master, master))
    assert all(torch.equal(a, b) for a, b in zip(
        [v for s in opt.state.values() for v in s.values()], moments))
    assert all(torch.equal(p, m.to(torch.bfloat16))
               for p, m in zip(trainer.model.parameters(), opt.master))


# -- the CLI ---------------------------------------------------------------------


@pytest.mark.parametrize("argv,field,value", [
    (["--remat"], "remat", True),
    (["--steps-per-dispatch", "4"], "steps_per_dispatch", 4),
    (["--nonfinite-policy", "rollback"], "nonfinite_policy", "rollback"),
    (["--rollback-retries", "5"], "rollback_retries", 5),
    (["--save-best"], "save_best", True),
    (["--early-stop", "3"], "early_stop_patience", 3),
    (["--keep-checkpoints", "4"], "keep_checkpoints", 4),
    (["--sync-checkpoint"], "async_checkpoint", False),
    (["--trace-timeline", "tl.jsonl"], "timeline_path", "tl.jsonl"),
    (["--host-cache-mb", "64"], "host_cache_mb", 64),
    (["--dtype", "bf16_params"], "dtype", "bf16_params"),
])
def test_each_new_flag_parses_to_the_jax_config_field(argv, field, value):
    """The flag sets the port's field of the JAX config's name, whose
    default is the JAX config's."""
    assert getattr(cli.to_config(cli.get_args(argv)), field) == value
    assert (getattr(cli.to_config(cli.get_args([])), field)
            == getattr(JaxTrainConfig(), field))


def test_export_pth_is_accepted_and_changes_nothing():
    with_flag = cli.to_config(cli.get_args(["--export-pth"]))
    assert with_flag == cli.to_config(cli.get_args([]))
