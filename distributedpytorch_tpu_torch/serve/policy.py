"""The batching queue's flush/admission policy as PURE functions.

Counterpart of ``distributedpytorch_tpu/serve/policy.py``, with the same
decisions. The policy lives here as pure functions of plain values
(sizes, deadlines, a clock reading), so it is testable without threads
or a clock, and ``serve/queue.py`` delegates to it:

* :func:`admit_decision` — should this request be admitted, or rejected
  (too large for any bucket / the hard cap is exhausted)?
* :func:`decide_flush`   — given the FIFO's row sizes, the head
  deadline, and the clock, which flush fires (full / deadline / eager /
  shed), into which bucket, taking how many head requests?

The semantics are documented in serve/queue.py's module docstring (the
four flush regimes + bounded admission); this module is the executable
version. Nothing here touches threads, clocks, or telemetry — the queue
owns locking and counters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

#: ``submit`` rejection reasons (stable strings — they surface in bench
#: reports and HTTP 503 bodies, so clients can switch on them).
#: ``overloaded`` means "this instance is shedding, back off and retry";
#: ``shutdown`` means "this instance is going away, retry elsewhere" —
#: conflating them would have clients hammering a stopping server.
REJECT_OVERLOAD = "overloaded"
REJECT_TOO_LARGE = "too-large"
REJECT_SHUTDOWN = "shutdown"


@dataclasses.dataclass(frozen=True)
class FlushDecision:
    """One flush: ``count`` head requests (``rows`` real rows total)
    leave the queue and ride a ``bucket``-row padded batch; ``kind`` is
    the regime that fired (full / deadline / eager / shed) — the same
    string the flush telemetry and the request trace ledgers record."""

    kind: str
    bucket: int
    count: int
    rows: int


def head_group(planner, sizes: Sequence[int]) -> Tuple[int, int]:
    """Longest FIFO prefix whose rows fit the largest bucket, as
    ``(count, rows)``. Strictly FIFO: a request that doesn't fit stops
    the scan (no reordering — within a bucket and across buckets,
    completion follows submission order for equal-capacity requests)."""
    count = 0
    total = 0
    for size in sizes:
        if total + size > planner.max_size:
            break
        count += 1
        total += size
    return count, total


def admit_decision(planner, pending_rows: int, size: int,
                   hard_cap_images: int) -> Optional[str]:
    """Admission for a ``size``-row request against ``pending_rows``
    already queued: None to admit, else the rejection reason. A request
    larger than the biggest bucket could never match a compiled
    executable (:data:`REJECT_TOO_LARGE`); beyond the hard cap, queue
    depth — and with it queueing latency — stays bounded by
    construction (:data:`REJECT_OVERLOAD`)."""
    if size > planner.max_size:
        return REJECT_TOO_LARGE
    if pending_rows + size > hard_cap_images:
        return REJECT_OVERLOAD
    return None


def decide_flush(planner, sizes: Sequence[int], head_deadline_t: float,
                 pending_rows: int, now: float,
                 eager: bool = False) -> Optional[FlushDecision]:
    """The flush policy: which group (if any) leaves the queue NOW.

    ``sizes`` are the pending requests' row counts in FIFO order,
    ``head_deadline_t`` the oldest request's SLO deadline,
    ``pending_rows`` the queued-row total (== ``sum(sizes)``), and
    ``eager`` means the caller has idle capacity in hand and will
    dispatch whatever it gets immediately. Returns None when nothing
    should flush yet."""
    if not sizes:
        return None
    count, total = head_group(planner, sizes)
    overloaded = pending_rows - total >= planner.max_size
    if total == planner.max_size or (count < len(sizes) and not overloaded):
        # head group fills (or next request overflows) the largest
        # bucket: the throughput path
        return FlushDecision("full", planner.bucket_for(total), count, total)
    if overloaded:
        # shed: more than a full bucket is backed up behind the head
        # group — drop to the largest bucket the head can FILL, so no
        # dispatched row is padding while real requests wait
        bucket = planner.largest_full_bucket(total)
        trimmed_count = 0
        trimmed_total = 0
        for size in sizes[:count]:
            if trimmed_total + size > bucket:
                break
            trimmed_count += 1
            trimmed_total += size
        if trimmed_count:
            count, total = trimmed_count, trimmed_total
        # an unsplittable head (single request bigger than the full
        # bucket) keeps its covering bucket, padding and all
        return FlushDecision("shed", planner.bucket_for(total), count, total)
    if head_deadline_t <= now or eager:
        # SLO flush / work-conserving flush: smallest covering bucket
        kind = "deadline" if head_deadline_t <= now else "eager"
        return FlushDecision(kind, planner.bucket_for(total), count, total)
    return None
