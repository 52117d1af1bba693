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
