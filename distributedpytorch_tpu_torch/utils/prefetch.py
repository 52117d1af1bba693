"""Bounded prefetch for the serve path's placement worker.

Counterpart of ``bounded_prefetch`` / ``pipelined_placement`` in
``distributedpytorch_tpu/utils/prefetch.py``: flushed request buckets are
the work items, and ``place_fn`` stacks, pads and copies each bucket to
its claimed replica's card ``depth`` buckets ahead of the dispatch loop.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Callable, Iterable, Iterator, Tuple, TypeVar

T = TypeVar("T")
R = TypeVar("R")

#: Work-item kind of a plain per-dispatch payload.
SINGLE = "single"

_DONE = object()


def bounded_prefetch(
    items: Iterable[T], fn: Callable[[T], R], depth: int = 2,
    name: str = "dpt-prefetch",
) -> Iterator[Tuple[T, R]]:
    """Yield ``(item, fn(item))`` with ``fn`` running up to ``depth`` items
    ahead on a daemon thread.

    A semaphore permit is taken BEFORE ``fn`` runs and returned when the
    consumer pops the result, so at most ``depth`` worker-held results
    (+ the one the consumer is using) are alive at once. Worker
    exceptions re-raise at the consumption point; closing the generator
    stops the worker within its poll interval."""
    in_flight = threading.Semaphore(max(1, depth))
    q: queue_mod.Queue = queue_mod.Queue()  # unbounded; the semaphore bounds
    stop = threading.Event()

    def worker():
        try:
            for item in items:
                while not in_flight.acquire(timeout=0.1):
                    if stop.is_set():
                        return
                if stop.is_set():
                    return
                q.put((item, fn(item)))
        except BaseException as exc:  # re-raised at the consumption point
            q.put(exc)
            return
        q.put(_DONE)

    threading.Thread(target=worker, daemon=True, name=name).start()
    try:
        while True:
            payload = q.get()
            if payload is _DONE:
                return
            if isinstance(payload, BaseException):
                raise payload
            in_flight.release()  # the consumer owns this result now
            yield payload
    finally:
        stop.set()


def pipelined_placement(
    work: Iterable[Tuple[str, object]],
    place_fn: Callable[[str, object], object],
    depth: int = 2,
    name: str = "dpt-prefetch",
) -> Iterator[Tuple[Tuple[str, object], object]]:
    """Yield ``(work_item, placed)`` with ``place_fn(kind, payload)``
    running up to ``depth`` items ahead on the prefetch worker;
    ``depth <= 0`` places inline on the consumer thread."""

    def place(item):
        kind, payload = item
        return place_fn(kind, payload)

    if depth <= 0:
        return ((item, place(item)) for item in work)
    return bounded_prefetch(work, place, depth=depth, name=name)
