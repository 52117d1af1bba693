"""The port's preemption stop (``train/loop.py``) on the CPU at a small
size (widths (8, 16), 32 × 48 images, float32): SIGTERM raised by a
wrapped step through ``signal.raise_signal`` stops a single process
after the dispatch in flight (K = 1 and a K = 2 stack), saves, and
``-c`` resumes it to the end, as the JAX trainer's ``sigterm`` fault site
does; three gloo ranks stop together at one epoch boundary when one of
them is signalled, and with the JAX desync error when their steps
differ; the handlers are put back after ``train()``, also when it
raises, and off the main thread the feature is off."""

import dataclasses
import os
import signal
import threading

import numpy as np
import pytest

from distributedpytorch_tpu.config import TrainConfig as JaxTrainConfig
from distributedpytorch_tpu.train import Trainer as JaxTrainer
from distributedpytorch_tpu.utils import faults as jax_faults
from distributedpytorch_tpu_torch import checkpoint
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.train.loop import Trainer
from torch_ddp_worker import launch
from torch_parallel_parity import to_port

H, W = 32, 48
WIDTHS = (8, 16)
# one epoch's val loss against the JAX trainer's (test_torch_train.py's
# epoch bound: float32 forwards summed in other orders)
EPOCH_RTOL = 1e-4


def _common(**kw):
    """--synthetic 16 -v 25 -b 2: 12 train samples (6 steps), 4 val."""
    return {**dict(epochs=2, batch_size=2, val_percent=25.0, seed=42,
                   image_size=(W, H), model_widths=WIDTHS,
                   synthetic_samples=16, metric_every_steps=1, num_workers=0,
                   s2d_levels=0, dtype="f32"), **kw}


def _port_config(root, **kw):
    return TrainConfig(kernels="torch", device="cpu",
                       checkpoint_dir=os.path.join(root, "checkpoints"),
                       log_dir=os.path.join(root, "logs"),
                       loss_dir=os.path.join(root, "loss"), **_common(**kw))


def _sigterm_after(trainer, at_step, attr="train_step"):
    """``trainer``'s ``attr`` (its step, or its K-step dispatch) raises
    SIGTERM once the dispatch that completes global step ``at_step`` has
    run: the counterpart of the JAX ``sigterm`` fault site."""
    real = getattr(trainer, attr)
    k = trainer.k_dispatch if attr == "multi_step" else 1

    class Signalling:
        def __call__(self, batch):
            out = real(batch)
            if trainer.step + k == at_step:
                signal.raise_signal(signal.SIGTERM)
            return out

        def __getattr__(self, name):
            return getattr(real, name)

    setattr(trainer, attr, Signalling())


def _resume(cfg):
    return Trainer(dataclasses.replace(cfg, checkpoint_name="singleGPU"))


def test_sigterm_stops_saves_and_resumes_like_the_jax_trainer(tmp_path):
    """The JAX trainer with ``sigterm:0:3`` and the port with a step that
    raises SIGTERM after step 3, from the same weights: both stop before
    step 4, save epoch index 0 at step 3, and the resume redoes epoch 1
    and runs epoch 2: the same steps, val loss within 1e-4."""
    jax_faults.install(())
    jcfg = JaxTrainConfig(
        kernels="xla", async_checkpoint=False,
        checkpoint_dir=str(tmp_path / "jax" / "checkpoints"),
        log_dir=str(tmp_path / "jax" / "logs"),
        loss_dir=str(tmp_path / "jax" / "loss"), **_common(
            inject_faults=("sigterm:0:3",)))
    jtrainer = JaxTrainer(jcfg)
    initial = to_port(jtrainer.state.params, jtrainer.state.model_state)
    jstopped = jtrainer.train()
    jax_faults.install(())
    jresult = JaxTrainer(dataclasses.replace(
        jcfg, inject_faults=(), checkpoint_name="singleGPU")).train()

    cfg = _port_config(str(tmp_path / "port"))
    trainer = Trainer(cfg, initial_state=initial)
    _sigterm_after(trainer, 3)
    stopped = trainer.train()
    assert stopped["steps"] == jstopped["steps"] == 3
    saved = checkpoint.load_native(trainer.checkpoint_path)
    assert (saved["epoch"], saved["step"]) == (0, 3)
    assert os.path.exists(os.path.join(cfg.checkpoint_dir, "singleGPU.pth"))
    resumed = _resume(cfg)
    assert (resumed.start_epoch, resumed.step) == (0, 3)
    result = resumed.train()
    assert result["steps"] == jresult["steps"] == 15
    np.testing.assert_allclose(result["val_loss"], jresult["val_loss"],
                               rtol=EPOCH_RTOL)


def test_a_k2_stack_finishes_before_the_stop(tmp_path):
    """K = 2: the signal comes inside the dispatch of steps 3 and 4; the
    stack finishes (a graph's replay is one dispatch) and the run stops
    at step 4, saves it, and resumes to the end."""
    cfg = _port_config(str(tmp_path), steps_per_dispatch=2)
    trainer = Trainer(cfg)
    _sigterm_after(trainer, 4, attr="multi_step")
    assert trainer.train()["steps"] == 4
    saved = checkpoint.load_native(trainer.checkpoint_path)
    assert (saved["epoch"], saved["step"]) == (0, 4)
    assert _resume(cfg).train()["steps"] == 4 + 12


def test_the_handlers_are_put_back_also_after_a_raise(tmp_path):
    seen = []

    def mine(signum, frame):
        seen.append(signum)

    before = {sig: signal.signal(sig, mine)
              for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        trainer = Trainer(_port_config(str(tmp_path), epochs=1))
        trainer.train()
        assert signal.getsignal(signal.SIGTERM) is mine
        assert signal.getsignal(signal.SIGINT) is mine

        def boom(batch):
            assert signal.getsignal(signal.SIGTERM) is not mine
            raise RuntimeError("step failed")

        failing = Trainer(_port_config(str(tmp_path / "b"), epochs=1))
        failing.train_step = boom
        with pytest.raises(RuntimeError, match="step failed"):
            failing.train()
        assert signal.getsignal(signal.SIGTERM) is mine
        assert signal.getsignal(signal.SIGINT) is mine
        assert seen == []
    finally:
        for sig, handler in before.items():
            signal.signal(sig, handler)


def test_sigint_stops_too_and_off_the_main_thread_the_feature_is_off(
        tmp_path):
    cfg = _port_config(str(tmp_path / "a"), epochs=1)
    trainer = Trainer(cfg)
    real = trainer.train_step

    def interrupt(batch):
        loss = real(batch)
        if trainer.step + 1 == 2:
            signal.raise_signal(signal.SIGINT)
        return loss

    trainer.train_step = interrupt
    assert trainer.train()["steps"] == 2
    # on a thread: signal.signal refuses, the run installs nothing
    other = Trainer(_port_config(str(tmp_path / "b"), epochs=1))
    out = {}
    thread = threading.Thread(target=lambda: out.update(other.train()))
    thread.start()
    thread.join(timeout=120)
    assert not thread.is_alive() and out["steps"] == 6
    assert other._prev_handlers == {}


WORLD = 3
DDP_CONFIG = dict(epochs=3, batch_size=2, val_percent=25.0, seed=42,
                  image_size=(W, H), model_widths=WIDTHS,
                  synthetic_samples=24, metric_every_steps=1, num_workers=0,
                  s2d_levels=0, dtype="f32", kernels="torch")


def test_three_gloo_ranks_stop_together_and_resume(tmp_path):
    """--synthetic 24 -v 25 -b 2 over 3 ranks: 3 steps per epoch. SIGTERM
    on rank 1 alone after step 4 (mid-epoch 2): every rank finishes the
    epoch, they agree at its end, rank 0 saves epoch index 1 at step 6
    and nothing after it; ``-c`` resumes on the three ranks to the end.
    Then rank 2's step count runs one ahead from step 2: every rank logs
    the desync error at the first epoch's end and they stop together.
    Every rank's join has a timeout (``launch``)."""
    ckpt = str(tmp_path / "stop" / "checkpoints" / "DDP.pt")
    jobs = {
        "stop": {"kind": "preempt", "dir": str(tmp_path / "stop"),
                 "config": DDP_CONFIG, "signal": {1: 4}},
        "resume": {"kind": "trainer", "dir": str(tmp_path / "resume"),
                   "initial": None,
                   "config": {**DDP_CONFIG, "checkpoint_name": ckpt}},
        "desync": {"kind": "preempt", "dir": str(tmp_path / "desync"),
                   "config": DDP_CONFIG, "skew": {2: 2}},
    }
    ranks = launch(str(tmp_path / "job"), jobs, world=WORLD)
    stop = [r["stop"] for r in ranks]
    assert [r["result"]["steps"] for r in stop] == [6, 6, 6]
    assert all(r["handler_restored"] for r in stop)
    assert stop[0]["saved"]["epoch"] == 1 and stop[0]["saved"]["step"] == 6
    assert stop[0]["saved"]["files"] == ["DDP.pt", "DDP.pt.1", "DDP.pth"]
    resumed = [r["resume"] for r in ranks]
    assert all(r["resumed_from"]["epoch"] == 1 for r in resumed)
    assert [r["result"]["steps"] for r in resumed] == [12, 12, 12]
    desync = [r["desync"] for r in ranks]
    assert [r["result"]["steps"] for r in desync] == [3, 3, 4]
    for r in desync:
        assert any("desynced at step agreement — per-rank steps [3, 3, 4]"
                   in e for e in r["errors"]), r["errors"]
    assert desync[0]["saved"]["epoch"] == 0
