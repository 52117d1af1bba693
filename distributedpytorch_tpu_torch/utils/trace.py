"""Step timeline: per-phase host spans of the trainer's overlapped loop.

Counterpart of ``distributedpytorch_tpu/utils/trace.py`` (``StepTimeline``,
``load_events``, ``summarize_events``, ``summarize_timeline``) without the
flight recorder. The step loop runs five host-observable phases per
batch:

    decode    sample decode and batch assembly (data/loader.py)
    stack     np.stack of K batches into one payload (utils/prefetch.py)
    h2d       the copy to the card, on the placement worker
              (utils/prefetch.py)
    dispatch  the host's step call: enqueue on the card, not execution
              (train/loop.py)
    readback  the copy of loss values to the host (utils/metrics.py)

Each span is ``(phase, t0, t1)`` on one ``time.perf_counter`` clock shared
by every thread, written as one JSON line with a ``wall`` anchor and the
``rank`` tag, in the JAX package's field names, so its readers read the
port's files. Rank R of a multi-process run writes ``<path>.rankR``
(``rank_path``). Without a path the timeline records nothing: the spans
cost one attribute read.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Dict, Iterable, List, Optional

PHASES = ("decode", "stack", "h2d", "dispatch", "readback")


def rank_path(path: Optional[str], rank: int) -> Optional[str]:
    """Where rank ``rank`` writes: ``path`` for rank 0, ``<path>.rankR``
    otherwise (None stays None)."""
    if path and rank != 0:
        return f"{path}.rank{rank}"
    return path


class StepTimeline:
    """Collects per-phase spans, thread-safe; ``flush`` appends them to
    ``path`` as JSONL. ``path=None`` records nothing."""

    def __init__(self, path: Optional[str] = None, *, rank: int = 0):
        self.path = path
        self.enabled = path is not None
        self.rank = int(rank)
        self._events: List[dict] = []
        self._lock = threading.Lock()
        # per-phase [count, total_s], kept across flushes: the summary
        # covers the whole run
        self._totals: Dict[str, List[float]] = {}

    def record(self, phase: str, t0: float, t1: float,
               wall: Optional[float] = None, **tags) -> None:
        """One span; ``wall`` (the wall clock at its end) defaults to
        now."""
        if not self.enabled:
            return
        event = {"phase": phase, "t0": round(t0, 6), "t1": round(t1, 6),
                 "wall": round(wall if wall is not None else time.time(), 6),
                 "rank": self.rank, **tags}
        with self._lock:
            self._events.append(event)
            acc = self._totals.setdefault(phase, [0, 0.0])
            acc[0] += 1
            acc[1] += t1 - t0

    @contextlib.contextmanager
    def span(self, phase: str, **tags):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(phase, t0, time.perf_counter(), **tags)

    def events(self, phase: Optional[str] = None) -> List[dict]:
        """The spans not flushed yet (of one phase), in record order."""
        with self._lock:
            evs = list(self._events)
        return [e for e in evs if phase is None or e["phase"] == phase]

    def flush(self) -> None:
        """Append the collected spans to ``path`` and clear them; the
        totals stay."""
        with self._lock:
            evs, self._events = self._events, []
        if not evs:
            return
        with open(self.path, "a") as f:
            for e in evs:
                f.write(json.dumps(e) + "\n")

    def summary(self) -> Dict[str, Optional[dict]]:
        """Per phase ``{count, total_ms, mean_ms}`` over the run; None for
        a phase never seen."""
        with self._lock:
            totals = {k: list(v) for k, v in self._totals.items()}
        return _format_totals(totals)


def _format_totals(totals: Dict[str, List[float]]
                   ) -> Dict[str, Optional[dict]]:
    out: Dict[str, Optional[dict]] = {}
    for phase in PHASES:
        if phase not in totals:
            out[phase] = None
            continue
        count, total = totals[phase]
        out[phase] = {
            "count": int(count),
            "total_ms": round(1e3 * total, 3),
            "mean_ms": round(1e3 * total / count, 3) if count else 0.0,
        }
    return out


#: The timeline of call sites whose owner passed none.
NULL_TIMELINE = StepTimeline(None)


def load_events(path: str) -> List[dict]:
    """The spans of a timeline file; torn or blank lines (a file read
    while it is appended to) are skipped."""
    events = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            try:
                d = json.loads(line)
            except ValueError:
                continue
            if isinstance(d, dict) and "phase" in d:
                events.append(d)
    return events


def summarize_events(events: Iterable[dict]) -> Dict[str, Optional[dict]]:
    """``StepTimeline.summary``'s shape, from spans read back."""
    totals: Dict[str, List[float]] = {}
    for e in events:
        try:
            dt = float(e["t1"]) - float(e["t0"])
        except (KeyError, TypeError, ValueError):
            continue
        acc = totals.setdefault(e["phase"], [0, 0.0])
        acc[0] += 1
        acc[1] += dt
    return _format_totals(totals)


def summarize_timeline(path: str) -> Dict[str, Optional[dict]]:
    """The per-phase summary of a timeline file:
    ``summarize_timeline("tl.jsonl")["dispatch"]["total_ms"]``."""
    return summarize_events(load_events(path))
