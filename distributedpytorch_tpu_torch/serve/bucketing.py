"""Padded-batch bucket planning for the serving tier.

The server dispatches only a small fixed set of batch shapes — the
*buckets*, each warmed per replica at startup. Requests coalesce FIFO
into a bucket, the batch pads up to the bucket size with zero rows, and
pad rows are sliced off before postprocessing. The planner is pure shape
arithmetic: which bucket a coalesced group rides and how much padding
that costs — the queue (serve/queue.py) owns *when* to flush, the
planner owns *what shape*. A fixed ladder keeps the set of shapes that
cuDNN and the caching allocator see small and known before traffic.

Counterpart of ``distributedpytorch_tpu/serve/bucketing.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


class BucketPlanner:
    """An ascending ladder of batch sizes, e.g. ``(1, 2, 4, 8)``.

    ``bucket_for(n)`` → the smallest bucket holding ``n`` rows (None when
    ``n`` exceeds the largest bucket — the caller rejects such requests
    at admission, so an oversized batch can never reach a compiled
    executable and die on a shape mismatch mid-dispatch).
    """

    def __init__(self, bucket_sizes: Sequence[int]):
        sizes = sorted({int(b) for b in bucket_sizes})
        if not sizes or sizes[0] < 1:
            raise ValueError(f"bucket_sizes must be positive: {bucket_sizes!r}")
        self.sizes: Tuple[int, ...] = tuple(sizes)

    @property
    def max_size(self) -> int:
        return self.sizes[-1]

    def bucket_for(self, n: int) -> Optional[int]:
        """Smallest bucket with capacity >= n rows; None if n is too big."""
        for b in self.sizes:
            if n <= b:
                return b
        return None

    def largest_full_bucket(self, n: int) -> int:
        """Largest bucket that ``n`` rows can FILL (>= the smallest bucket
        even when n can't fill it — something must be dispatchable). The
        overload path uses this: padding is wasted compute, and under
        overload wasted compute is the thing being shed."""
        best = self.sizes[0]
        for b in self.sizes:
            if b <= n:
                best = b
        return best

    def padding_cost(self, n: int) -> int:
        """Pad rows a group of n rides with (0 when n is exactly a bucket)."""
        b = self.bucket_for(n)
        return 0 if b is None else b - n


def pad_batch(rows: np.ndarray, bucket: int) -> np.ndarray:
    """``(n, H, W, C)`` stacked rows → ``(bucket, H, W, C)`` with zero pad
    rows appended. The model is per-sample in eval mode (convs + eval
    BatchNorm never mix rows), so pad rows cost compute but cannot
    perturb real rows' results."""
    n = rows.shape[0]
    if n == bucket:
        return rows
    if n > bucket:
        raise ValueError(f"{n} rows cannot ride a {bucket}-row bucket")
    out = np.zeros((bucket,) + rows.shape[1:], dtype=rows.dtype)
    out[:n] = rows
    return out


def stack_group(images: List[np.ndarray], bucket: int) -> np.ndarray:
    """Stack per-request image rows and pad to the bucket shape in one
    allocation (the placement worker calls this off the dispatch loop)."""
    if not images:
        raise ValueError("empty group")
    first = images[0]
    out = np.zeros((bucket,) + first.shape, dtype=first.dtype)
    for i, img in enumerate(images):
        out[i] = img
    return out
