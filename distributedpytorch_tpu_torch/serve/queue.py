"""The continuous-batching queue: coalesce concurrent requests into
padded bucket shapes under a latency SLO.

Counterpart of ``distributedpytorch_tpu/serve/queue.py``, with the same
policy (serve/policy.py):

* **full flush** — the FIFO head fills the largest bucket → dispatch
  immediately at full batch.
* **deadline flush** — the oldest request's SLO deadline arrives first
  → flush whatever is pending into the smallest covering bucket.
* **eager flush** — the dispatcher reports an idle replica and the
  queue is non-empty → dispatch immediately (work-conserving).
* **overload shedding** — with more than one full bucket backed up
  behind the head group, flushes drop to the largest bucket they can
  completely fill; admission is capped at ``hard_cap_images`` pending
  rows, beyond which ``submit`` returns :data:`REJECT_OVERLOAD`.

Requests are whole units: a k-image request rides one bucket and is
never split. One larger than the biggest bucket is rejected at
admission with :data:`REJECT_TOO_LARGE`.

All policy lives in ``serve/policy.py`` as pure functions driven by an
injectable ``clock``, so the unit tests step a fake clock and never
touch threads. ``wait_for_work`` is the blocking wrapper the server's
dispatch thread uses (a condition variable woken by ``submit``, by
:meth:`kick`, and by the next SLO deadline).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Deque, List, Optional

import numpy as np

from distributedpytorch_tpu_torch.serve import policy
from distributedpytorch_tpu_torch.serve.bucketing import BucketPlanner
from distributedpytorch_tpu_torch.serve.policy import (  # noqa: F401 — re-exports
    REJECT_OVERLOAD,
    REJECT_SHUTDOWN,
    REJECT_TOO_LARGE,
)


@dataclasses.dataclass
class ServeRequest:
    """One admitted unit of work: ``images`` is a list of ``(H, W, C)``
    float32 rows (k >= 1 — a request is atomic w.r.t. batching).
    ``future`` resolves to the server's response; the queue never
    touches it (rejection futures resolve at the submit site)."""

    images: List[np.ndarray]
    future: object = None
    key: str = ""
    size: int = 0  # rows; derived from images at submit
    enqueue_t: float = 0.0
    deadline_t: float = 0.0
    seq: int = 0
    request_id: str = ""


class BatchingQueue:
    """See the module docstring for the flush/shed policy.
    ``hard_cap_images`` defaults to 4× the largest bucket."""

    def __init__(
        self,
        planner: BucketPlanner,
        slo_s: float = 0.05,
        hard_cap_images: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.planner = planner
        self.slo_s = float(slo_s)
        self.hard_cap_images = int(
            hard_cap_images if hard_cap_images is not None
            else 4 * planner.max_size
        )
        if self.hard_cap_images < planner.max_size:
            raise ValueError(
                f"hard_cap_images={self.hard_cap_images} cannot be smaller "
                f"than the largest bucket ({planner.max_size}) — the largest "
                f"bucket could never fill"
            )
        self.clock = clock
        self._pending: Deque[ServeRequest] = collections.deque()
        self._pending_images = 0
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._stopped = False
        self._seq = 0
        self.max_depth_seen = 0
        self.rejected = 0

    # -- admission -----------------------------------------------------------
    def submit(self, req: ServeRequest) -> Optional[str]:
        """Admit a request; returns None on success or a rejection reason
        (the caller resolves the future — a rejection is a response)."""
        req.size = len(req.images)
        if req.size < 1:
            raise ValueError("empty request")
        with self._cond:
            if self._stopped:
                return REJECT_SHUTDOWN
            reason = policy.admit_decision(
                self.planner, self._pending_images, req.size,
                self.hard_cap_images,
            )
            if reason == REJECT_TOO_LARGE:
                # a client error, not backpressure: no shed accounting
                return reason
            if reason is not None:
                self.rejected += 1
                return reason
            now = self.clock()
            req.enqueue_t = now
            req.deadline_t = now + self.slo_s
            req.seq = self._seq
            self._seq += 1
            self._pending.append(req)
            self._pending_images += req.size
            self.max_depth_seen = max(self.max_depth_seen, self._pending_images)
            self._cond.notify_all()
        return None

    # -- flush policy (pure — serve/policy.py) -------------------------------
    def _poll_locked(self, eager: bool = False):
        if not self._pending:
            return None
        decision = policy.decide_flush(
            self.planner,
            [req.size for req in self._pending],
            self._pending[0].deadline_t,
            self._pending_images,
            self.clock(),
            eager=eager,
        )
        if decision is None:
            return None
        take = [self._pending.popleft() for _ in range(decision.count)]
        self._pending_images -= decision.rows
        return decision.bucket, take

    def poll(self, eager: bool = False):
        """Non-blocking: ``(bucket_size, [requests])`` ready to dispatch,
        or None. ``eager=True`` = the caller has idle capacity in hand."""
        with self._lock:
            return self._poll_locked(eager=eager)

    def wait_for_work(self, timeout: float = 0.25, eager=False):
        """Blocking ``poll``: waits until a group is dispatchable, the
        queue stops, or ``timeout`` elapses — waking early for the oldest
        request's SLO deadline. ``eager`` may be a bool or a zero-arg
        callable re-evaluated on every wake."""
        eager_fn = eager if callable(eager) else (lambda: eager)
        limit = self.clock() + timeout
        with self._cond:
            while not self._stopped:
                got = self._poll_locked(eager=eager_fn())
                if got is not None:
                    return got
                now = self.clock()
                wait = limit - now
                if self._pending:
                    wait = min(wait, self._pending[0].deadline_t - now)
                if wait <= 0:
                    return None
                self._cond.wait(wait)
            return None

    def kick(self) -> None:
        """Wake ``wait_for_work`` waiters without submitting anything —
        called when serving capacity frees, so an eager flush happens now."""
        with self._cond:
            self._cond.notify_all()

    # -- lifecycle / observability ------------------------------------------
    def stop(self) -> List[ServeRequest]:
        """Stop admitting and wake waiters; returns the still-pending
        requests so the server can resolve their futures."""
        with self._cond:
            self._stopped = True
            drained = list(self._pending)
            self._pending.clear()
            self._pending_images = 0
            self._cond.notify_all()
        return drained

    @property
    def depth_images(self) -> int:
        with self._lock:
            return self._pending_images

    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)
