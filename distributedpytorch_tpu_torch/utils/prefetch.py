"""Bounded prefetch for the placement workers of the serve path and the
trainer.

Counterpart of ``bounded_prefetch`` / ``pipelined_placement`` /
``stacked_work`` in ``distributedpytorch_tpu/utils/prefetch.py``. For the
server the work items are flushed request buckets, which ``place_fn``
stacks, pads and copies to the claimed replica's card; for the trainer
they are an epoch's batches (``stacked_work``), which it copies to the
card ``depth`` items ahead of the step loop: a ``STACK`` item's K batches
are stacked into one ``(K, B, ...)`` payload there first. The stacking and
the placement are the timeline's ``stack`` and ``h2d`` spans
(``utils/trace.py``).
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Callable, Iterable, Iterator, Tuple, TypeVar

import numpy as np

from distributedpytorch_tpu_torch.utils.trace import NULL_TIMELINE

T = TypeVar("T")
R = TypeVar("R")

#: Work-item kind of a plain per-dispatch payload.
SINGLE = "single"
#: Work-item kind of K loader batches that one accumulated step consumes.
STACK = "stack"

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
    tracer=None,
) -> Iterator[Tuple[Tuple[str, object], object]]:
    """Yield ``(work_item, placed)`` with ``place_fn(kind, payload)``
    running up to ``depth`` items ahead on the prefetch worker;
    ``depth <= 0`` places inline on the consumer thread. A ``STACK``
    item's batches reach ``place_fn`` as one dict of ``np.stack``-ed
    arrays (the ``stack`` span), and the call is the ``h2d`` span of
    ``tracer``."""
    tracer = tracer or NULL_TIMELINE
    counter = {"n": 0}

    def place(item):
        kind, payload = item
        seq = counter["n"]
        counter["n"] += 1
        if kind == STACK:
            with tracer.span("stack", seq=seq):
                payload = {key: np.stack([b[key] for b in payload])
                           for key in payload[0]}
        with tracer.span("h2d", seq=seq, kind=kind):
            return place_fn(kind, payload)

    if depth <= 0:
        return ((item, place(item)) for item in work)
    return bounded_prefetch(work, place, depth=depth, name=name)


def stacked_work(batches: Iterable[dict], stack_size: int, batch_size: int
                 ) -> Iterator[Tuple[str, object]]:
    """Group an epoch's batch stream into work items: ``(STACK, [K
    batches])`` for K full batches in a row, ``(SINGLE, batch)``
    otherwise. A ragged batch flushes the partial group (each buffered
    batch as a single, then the ragged one), and the epoch's trailing
    partial group drains the same way. ``stack_size <= 1`` gives all
    singles."""
    if stack_size <= 1:
        for b in batches:
            yield (SINGLE, b)
        return
    buffer: list = []
    for b in batches:
        if b["image"].shape[0] == batch_size:
            buffer.append(b)
            if len(buffer) == stack_size:
                yield (STACK, buffer)
                buffer = []
        else:
            for q in buffer:
                yield (SINGLE, q)
            buffer = []
            yield (SINGLE, b)
    for q in buffer:
        yield (SINGLE, q)
