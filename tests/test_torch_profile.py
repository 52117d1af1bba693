"""The port's profiler window (``--profile-steps N:M``, ``--profile-dir``)
on the CPU at a small size, as the JAX package's ``TestProfileSteps``
(tests/test_obs.py) holds its own: the parse cases, a trace written, the
profiler closed when the run ends inside the window, and the whole-run
capture; beside them what the port does its own way: a torch chrome
trace named by the steps it covered, K steps per dispatch rounding the
window out to whole dispatches, a refusal to nest inside another
profiler, and losses bitwise those of the run without the window."""

import json
import os

import pytest
import torch

from distributedpytorch_tpu_torch import cli
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.train.loop import Trainer
from torch_parallel_parity import run_cli


def _config(tmp_path, **kw):
    """--synthetic 16 -v 25 -b 2 -e 1: 6 steps."""
    return TrainConfig(
        epochs=1, batch_size=2, val_percent=25.0, image_size=(48, 32),
        model_widths=(8, 16), synthetic_samples=16, metric_every_steps=1,
        num_workers=0, s2d_levels=0, dtype="f32", kernels="torch",
        device="cpu", checkpoint_dir=str(tmp_path / "checkpoints"),
        log_dir=str(tmp_path / "logs"), loss_dir=str(tmp_path / "loss"), **kw)


def _trace(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert events, path
    return events


def test_cli_parse():
    assert cli.parse_profile_steps(None) is None
    assert cli.parse_profile_steps("2:5") == (2, 5)
    for bad in ("5:2", "x:y", "3:3", "-1:2"):
        with pytest.raises(ValueError):
            cli.parse_profile_steps(bad)
    args = cli.get_args(["--profile-steps", "2:4", "--profile-dir", "p"])
    assert cli.to_config(args).profile_steps == (2, 4)
    assert cli.to_config(args).profile_dir == "p"
    with pytest.raises(SystemExit, match="0 <= N < M"):
        cli.main(["--profile-steps", "4:2", "--device", "cpu"])


def test_step_range_capture_writes_a_chrome_trace(tmp_path):
    """Steps [1, 2): the trace of the dispatch of step 2, written when
    the next dispatch starts; the losses are bitwise those of the same
    run without the window."""
    prof = tmp_path / "prof"
    trainer = Trainer(_config(tmp_path / "a", profile_steps=(1, 2),
                              profile_dir=str(prof)))
    trainer.train()
    assert trainer.profile_window.prof is None  # stopped, not leaked
    assert not torch.autograd._profiler_enabled()
    assert os.listdir(prof) == ["singleGPU.rank0.steps1-2.pt.trace.json"]
    names = {e.get("name") for e in _trace(trainer.profile_window.path)}
    assert "aten::convolution" in names
    plain = Trainer(_config(tmp_path / "b"))
    plain.train()
    assert plain.profile_window is None
    assert trainer.records.losses and [float(x) for x in
                                       trainer.records.losses] == [
        float(x) for x in plain.records.losses]


def test_a_run_ending_inside_the_window_closes_it(tmp_path):
    trainer = Trainer(_config(tmp_path, profile_steps=(4, 100),
                              profile_dir=str(tmp_path / "prof")))
    trainer.train()
    assert not torch.autograd._profiler_enabled()
    assert trainer.profile_window.path.endswith(
        "singleGPU.rank0.steps4-6.pt.trace.json")
    _trace(trainer.profile_window.path)


def test_profile_dir_alone_captures_the_whole_run(tmp_path):
    trainer = Trainer(_config(tmp_path, profile_dir=str(tmp_path / "all")))
    trainer.train()
    assert os.listdir(tmp_path / "all") == [
        "singleGPU.rank0.steps0-6.pt.trace.json"]


def test_k_steps_round_the_window_out_to_whole_dispatches(tmp_path):
    """K = 2, steps [3, 5): the dispatches of steps 3–4 and 5–6 touch it,
    so the trace covers [2, 6); the default directory is
    ``<log-dir>/profile``."""
    trainer = Trainer(_config(tmp_path, profile_steps=(3, 5),
                              steps_per_dispatch=2))
    trainer.train()
    assert os.listdir(tmp_path / "logs" / "profile") == [
        "singleGPU.rank0.steps2-6.pt.trace.json"]


def test_the_window_does_not_nest(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    trainer = Trainer(_config(tmp_path, profile_steps=(0, 2)))
    outer = profile(activities=[ProfilerActivity.CPU])
    outer.start()
    try:
        with pytest.raises(RuntimeError, match="does not nest"):
            trainer.train()
    finally:
        outer.stop()
    assert not torch.autograd._profiler_enabled()


def test_the_cli_writes_the_window(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert run_cli(["--synthetic", "16", "--image-size", "48", "32",
                    "--model-widths", "8", "16", "-e", "1", "-b", "2",
                    "-v", "25", "--device", "cpu", "--num-workers", "0",
                    "--profile-steps", "1:3"]) == 0
    assert os.listdir(tmp_path / "logs" / "profile") == [
        "singleGPU.rank0.steps1-3.pt.trace.json"]


def test_a_card_window_whose_trace_holds_no_device_kernel_raises(
        tmp_path, monkeypatch):
    """A window on the card whose trace holds no device kernel of the
    work (here a CPU run's window taken for a card's at its stop: its
    trace has no device activity at all) raises at ``stop`` and writes
    nothing, rather than a trace with no kernels and an exit of 0; a
    trace's primer kernels (``PRIMER_KERNEL``) do not count as the
    work's."""
    from distributedpytorch_tpu_torch.train import loop

    window = loop.ProfileWindow((0, 1), str(tmp_path / "prof"), "singleGPU",
                                torch.device("cpu"))
    window.tick(0, 1)
    torch.ones(4).mul_(2.0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    window.device = torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="holds no device activity"):
        window.stop(1)
    assert not (tmp_path / "prof").exists()
    assert not torch.autograd._profiler_enabled()

    class Event:
        def __init__(self, name):
            self.name = name
            self.device_type = torch.autograd.DeviceType.CUDA

    class Prof:
        def __init__(self, names):
            self.names = names

        def events(self):
            return [Event(n) for n in self.names]

    assert loop.device_kernels(Prof([loop.PRIMER_KERNEL])) == []
    assert loop.device_kernels(Prof([loop.PRIMER_KERNEL, "stats_kernel"])
                               ) == ["stats_kernel"]


def test_the_primer_launches_more_kernels_the_older_the_process(
        monkeypatch):
    """The primer (``prime_profiler``) launches at least
    ``PRIMER_KERNELS`` spin kernels plus ``PRIMER_KERNELS_PER_S`` for
    each second of the process's age on each of its cards, in rounds of
    a ``_PRIMER_ROUNDS``-th of them that wait for every card, until it
    has run for at least ``PRIMER_S``; the process's age grows with the clock."""
    import contextlib
    import time

    from distributedpytorch_tpu_torch.train import loop

    launched, waited, entered = [], [], []

    @contextlib.contextmanager
    def on(card):
        entered.append(card)
        yield

    monkeypatch.setattr(torch.cuda, "_sleep", launched.append)
    monkeypatch.setattr(torch.cuda, "synchronize", waited.append)
    monkeypatch.setattr(torch.cuda, "device", on)
    monkeypatch.setattr(loop, "PRIMER_S", 0.0)
    rounds = loop._PRIMER_ROUNDS
    for age in (0.0, 100.0, 1000.0, 3600.0):
        monkeypatch.setattr(loop, "process_age_s", lambda age=age: age)
        n = loop.PRIMER_KERNELS + int(loop.PRIMER_KERNELS_PER_S * age)
        per_round = -(-n // rounds)
        ran = -(-n // per_round)
        launched.clear()
        waited.clear()
        assert loop.prime_profiler(torch.device("cuda", 0)) == len(launched)
        assert len(launched) == ran * per_round >= n
        assert len(launched) < n + per_round <= n + n // rounds + 1
        assert len(waited) == ran <= rounds
    cards = [torch.device("cuda", i) for i in (0, 1, 0)]
    entered.clear()
    waited.clear()
    launched.clear()
    assert loop.prime_profiler(cards) == 2 * ran * per_round == len(
        launched)
    assert entered == waited == cards[:2] * ran
    monkeypatch.setattr(loop, "PRIMER_S", 0.1)
    began = time.monotonic()
    loop.prime_profiler(torch.device("cuda", 0))
    assert time.monotonic() - began >= 0.1
    monkeypatch.undo()
    first = loop.process_age_s()
    time.sleep(0.05)
    assert 0.0 < first < loop.process_age_s() < first + 60.0


def test_a_session_on_the_card_stays_open_after_its_work(monkeypatch):
    """``settle_profiler`` waits for the cards it is given (every visible
    card by default), then ``PROFILER_TAIL_S`` more, so a device record
    the profiler stamps late still falls inside the session."""
    import time

    from distributedpytorch_tpu_torch.train import loop

    waited = []
    monkeypatch.setattr(torch.cuda, "synchronize", waited.append)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    began = time.monotonic()
    loop.settle_profiler()
    assert time.monotonic() - began >= loop.PROFILER_TAIL_S
    assert waited == [0, 1]
    waited.clear()
    loop.settle_profiler(torch.device("cuda", 1))
    assert waited == [torch.device("cuda", 1)]
