"""Per-request serving metrics, recorded off the dispatch loop.

Counterpart of ``distributedpytorch_tpu/serve/metrics.py`` without the
process-wide registry export. Completion workers — which already block
on the device result to build the response — stamp timestamps and append
a small record under a lock; nothing in the dispatch path reads, syncs
or aggregates. Aggregation happens in ``snapshot()`` (``/stats``, tests),
with the same keys as the JAX package's snapshot.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Deque, Dict, List, Optional


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); NaN on empty."""
    if not values:
        return float("nan")
    ordered = sorted(values)
    rank = max(0, min(len(ordered) - 1,
                      round(q / 100.0 * (len(ordered) - 1))))
    return ordered[int(rank)]


class ServeMetrics:
    """Thread-safe accumulator of per-request serving records.

    Counters are exact for the server's lifetime; the latency samples
    feeding the percentiles keep the most recent ``window`` requests, so
    memory and ``snapshot()`` cost stay bounded."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 window: int = 8192):
        self.clock = clock
        self._lock = threading.Lock()
        self._latencies_s: Deque[float] = collections.deque(maxlen=window)
        self._queue_s: Deque[float] = collections.deque(maxlen=window)
        self._images_ok = 0
        self._requests_ok = 0
        self._requests_failed = 0
        self._requests_cached = 0
        self._rejections: Dict[str, int] = {}
        self._bucket_dispatches: Dict[int, int] = {}
        self._pad_rows = 0
        self._real_rows = 0
        self._started_t = clock()

    # -- recording (completion workers + submit path) ------------------------
    def record_request(self, n_images: int, enqueue_t: float,
                       dispatch_t: float, done_t: float) -> None:
        with self._lock:
            self._latencies_s.append(done_t - enqueue_t)
            self._queue_s.append(dispatch_t - enqueue_t)
            self._images_ok += n_images
            self._requests_ok += 1

    def record_failure(self) -> None:
        with self._lock:
            self._requests_failed += 1

    def record_rejection(self, reason: str) -> None:
        with self._lock:
            self._rejections[reason] = self._rejections.get(reason, 0) + 1

    def record_dispatch(self, bucket: int, real_rows: int) -> None:
        with self._lock:
            self._bucket_dispatches[bucket] = (
                self._bucket_dispatches.get(bucket, 0) + 1
            )
            self._real_rows += real_rows
            self._pad_rows += bucket - real_rows

    # -- aggregation (pull-based; never on the dispatch path) ----------------
    def snapshot(self, elapsed_s: Optional[float] = None) -> dict:
        with self._lock:
            lat = list(self._latencies_s)
            qs = list(self._queue_s)
            elapsed = (
                float(elapsed_s) if elapsed_s is not None
                else max(1e-9, self.clock() - self._started_t)
            )
            dispatched = self._real_rows + self._pad_rows
            return {
                "requests_ok": self._requests_ok,
                "requests_failed": self._requests_failed,
                # the prediction cache is not ported: always 0
                "requests_cached": self._requests_cached,
                "rejected": dict(self._rejections),
                "rejected_total": sum(self._rejections.values()),
                "images_ok": self._images_ok,
                "elapsed_s": round(elapsed, 4),
                "imgs_per_s": round(self._images_ok / elapsed, 3),
                "p50_ms": round(percentile(lat, 50) * 1e3, 3) if lat else None,
                "p99_ms": round(percentile(lat, 99) * 1e3, 3) if lat else None,
                "queue_p50_ms": (
                    round(percentile(qs, 50) * 1e3, 3) if qs else None
                ),
                "bucket_dispatches": {
                    str(k): v
                    for k, v in sorted(self._bucket_dispatches.items())
                },
                "pad_ratio": (
                    round(self._pad_rows / dispatched, 4) if dispatched else 0.0
                ),
            }
