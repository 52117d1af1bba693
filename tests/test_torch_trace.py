"""The port's step timeline against the JAX package's readers, on the CPU
at a small size (widths (8, 16), 32 × 48 images, float32): the file a
port run writes, read by the JAX ``load_events`` and
``summarize_events``; the five phases of a one-epoch run; the rank
suffix; and the no-path no-op."""

import json

import pytest
import torch

from distributedpytorch_tpu.utils import trace as jax_trace
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.dist.runtime import RuntimeInfo
from distributedpytorch_tpu_torch.parallel.strategy import SingleDevice
from distributedpytorch_tpu_torch.train.loop import Trainer
from distributedpytorch_tpu_torch.utils import trace

H, W = 32, 48


def _config(tmp_path, **kw):
    """--synthetic 16 -v 25 -b 2 --grad-accum 2 for one epoch (three
    accumulated steps of 2 batches: every phase, ``stack`` included), a
    row every step."""
    return TrainConfig(**{**dict(
        epochs=1, batch_size=2, val_percent=25.0, seed=42,
        image_size=(W, H), model_widths=(8, 16), synthetic_samples=16,
        metric_every_steps=1, num_workers=0, s2d_levels=0, dtype="f32",
        device="cpu", grad_accum=2,
        checkpoint_dir=str(tmp_path / "checkpoints"),
        log_dir=str(tmp_path / "logs"), loss_dir=str(tmp_path / "loss")),
        **kw})


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trace")
    cfg = _config(tmp, timeline_path=str(tmp / "tl.jsonl"))
    trainer = Trainer(cfg)
    trainer.train()
    return cfg, trainer


def test_the_jax_readers_read_the_ports_file(traced_run):
    """The JAX ``load_events`` reads every line and ``summarize_events``
    gives the port's summary of the file, key for key; the port's
    in-memory summary has the same counts, and totals within the file's
    rounding (t0 and t1 are written to the microsecond)."""
    cfg, trainer = traced_run
    events = jax_trace.load_events(cfg.timeline_path)
    with open(cfg.timeline_path) as f:
        assert len(events) == sum(1 for line in f if line.strip())
    assert events == trace.load_events(cfg.timeline_path)
    want = jax_trace.summarize_events(events)
    assert trace.summarize_timeline(cfg.timeline_path) == want
    live = trainer.tracer.summary()
    for phase in trace.PHASES:
        assert live[phase]["count"] == want[phase]["count"], phase
        assert live[phase]["total_ms"] == pytest.approx(
            want[phase]["total_ms"], abs=2e-3 * want[phase]["count"])
    for e in events:
        assert {"phase", "t0", "t1", "wall", "rank"} <= set(e)
        assert e["rank"] == 0 and e["t1"] >= e["t0"]


def test_all_five_phases_appear_in_a_one_epoch_run(traced_run):
    _cfg, trainer = traced_run
    summary = trainer.tracer.summary()
    assert trace.PHASES == jax_trace.PHASES
    assert all(summary[p] is not None for p in trace.PHASES), summary
    # 3 accumulated steps of 2 batches; one readback per row
    assert summary["dispatch"]["count"] == 3
    assert summary["stack"]["count"] == 3
    assert summary["decode"]["count"] == 6
    assert summary["readback"]["count"] == len(trainer.records.train_rows)


def test_rank_r_writes_its_own_suffixed_file(tmp_path):
    """``<path>`` for rank 0 and ``<path>.rankR`` for rank R (the JAX
    trainer's rule, loop.py:120-126); a rank-1 trainer writes only its own
    file, with its rank on every span."""
    assert trace.rank_path("tl.jsonl", 0) == "tl.jsonl"
    assert trace.rank_path("tl.jsonl", 3) == "tl.jsonl.rank3"
    assert trace.rank_path(None, 3) is None
    path = tmp_path / "tl.jsonl"
    cfg = _config(tmp_path, timeline_path=str(path), grad_accum=1)
    strategy = SingleDevice(cfg, RuntimeInfo(1, 2, device=torch.device(
        "cpu")))
    Trainer(cfg, strategy=strategy).train()
    assert not path.exists()
    ranked = tmp_path / "tl.jsonl.rank1"
    events = [json.loads(line) for line in ranked.read_text().splitlines()]
    assert events and {e["rank"] for e in events} == {1}


def test_without_a_path_nothing_is_recorded_or_written(tmp_path):
    timeline = trace.StepTimeline(None)
    assert not timeline.enabled
    with timeline.span("dispatch", step=1):
        pass
    timeline.record("decode", 0.0, 1.0)
    timeline.flush()
    assert timeline.events() == []
    assert all(v is None for v in timeline.summary().values())
    Trainer(_config(tmp_path, grad_accum=1)).train()
    assert not any(p.suffix == ".jsonl" or ".rank" in p.name
                   for p in tmp_path.rglob("*"))
