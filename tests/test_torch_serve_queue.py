"""Deterministic unit tests for the PyTorch port's batching layer
(serve/bucketing.py + serve/queue.py): bucket selection for mixed
request sizes, SLO-deadline flush under a fake clock, overload shedding
to smaller FULL buckets, bounded admission with explicit rejection, and
FIFO fairness — the cases of tests/test_serve_queue.py, run against the
port — plus the flush/admission policy against the JAX package's on
random traffic. Pure host logic — no threads, no wall clock."""

import concurrent.futures

import numpy as np
import pytest

from distributedpytorch_tpu_torch.serve import (
    REJECT_OVERLOAD,
    REJECT_SHUTDOWN,
    REJECT_TOO_LARGE,
    BatchingQueue,
    BucketPlanner,
    ServeRequest,
)
from distributedpytorch_tpu_torch.serve.bucketing import pad_batch, stack_group
from distributedpytorch_tpu_torch.serve.metrics import ServeMetrics, percentile


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def req(k: int = 1) -> ServeRequest:
    return ServeRequest(
        images=[np.zeros((2, 3, 3), np.float32) for _ in range(k)],
        future=concurrent.futures.Future(),
    )


def make_queue(buckets=(1, 2, 4, 8), slo_s=0.05, cap=None):
    clock = FakeClock()
    q = BatchingQueue(
        BucketPlanner(buckets), slo_s=slo_s, hard_cap_images=cap, clock=clock
    )
    return q, clock


class TestBucketPlanner:
    def test_smallest_covering_bucket(self):
        p = BucketPlanner((1, 2, 4, 8))
        assert [p.bucket_for(n) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]

    def test_oversized_is_none(self):
        assert BucketPlanner((1, 2, 4)).bucket_for(5) is None

    def test_largest_full_bucket(self):
        p = BucketPlanner((1, 2, 4, 8))
        assert [p.largest_full_bucket(n) for n in (1, 3, 5, 9)] == [1, 2, 4, 8]

    def test_padding_cost(self):
        p = BucketPlanner((2, 8))
        assert p.padding_cost(2) == 0
        assert p.padding_cost(3) == 5

    def test_ladder_dedupes_and_sorts(self):
        assert BucketPlanner((8, 2, 2, 4)).sizes == (2, 4, 8)

    def test_invalid_ladder_raises(self):
        with pytest.raises(ValueError):
            BucketPlanner(())
        with pytest.raises(ValueError):
            BucketPlanner((0, 2))

    def test_pad_batch(self):
        rows = np.arange(2 * 3 * 3 * 1, dtype=np.float32).reshape(2, 3, 3, 1)
        out = pad_batch(rows, 4)
        assert out.shape == (4, 3, 3, 1)
        np.testing.assert_array_equal(out[:2], rows)
        assert not out[2:].any()
        with pytest.raises(ValueError):
            pad_batch(rows, 1)

    def test_stack_group(self):
        rows = [np.full((2, 2, 3), i, np.float32) for i in range(3)]
        out = stack_group(rows, 4)
        assert out.shape == (4, 2, 2, 3)
        for i in range(3):
            np.testing.assert_array_equal(out[i], rows[i])
        assert not out[3].any()


class TestFlushPolicy:
    def test_empty_queue_polls_none(self):
        q, _ = make_queue()
        assert q.poll() is None
        assert q.poll(eager=True) is None

    def test_full_bucket_flushes_immediately(self):
        q, _ = make_queue()
        reqs = [req() for _ in range(8)]
        for r in reqs:
            assert q.submit(r) is None
        bucket, got = q.poll()  # no eager, no deadline — full is enough
        assert bucket == 8
        assert got == reqs

    def test_deadline_flush_with_fake_clock(self):
        q, clock = make_queue(slo_s=0.05)
        r = req()
        q.submit(r)
        assert q.poll() is None  # SLO not reached, no idle capacity
        clock.advance(0.049)
        assert q.poll() is None
        clock.advance(0.002)  # past the deadline
        bucket, got = q.poll()
        assert (bucket, got) == (1, [r])

    def test_eager_flush_skips_the_wait(self):
        q, _ = make_queue(slo_s=10.0)  # the SLO alone would wait forever
        r = req()
        q.submit(r)
        assert q.poll() is None
        assert q.poll(eager=True) == (1, [r])

    def test_mixed_sizes_pick_smallest_covering_bucket(self):
        q, _ = make_queue()
        rs = [req(1), req(3), req(2)]  # 6 rows total
        for r in rs:
            q.submit(r)
        bucket, got = q.poll(eager=True)
        assert bucket == 8  # smallest bucket covering 6
        assert got == rs

    def test_mixed_sizes_deadline_pads_to_covering_bucket(self):
        q, clock = make_queue(slo_s=0.01)
        q.submit(req(3))
        clock.advance(0.02)
        bucket, got = q.poll()
        assert bucket == 4 and got[0].size == 3  # one pad row

    def test_request_never_splits_across_buckets(self):
        q, _ = make_queue(buckets=(1, 2, 4))
        a, b = req(3), req(3)  # 3 + 3 > 4: b must wait for the next flush
        q.submit(a)
        q.submit(b)
        bucket, got = q.poll(eager=True)
        assert (bucket, got) == (4, [a])
        bucket, got = q.poll(eager=True)
        assert (bucket, got) == (4, [b])

    def test_fifo_within_and_across_buckets(self):
        q, _ = make_queue()
        reqs = [req() for _ in range(11)]
        for r in reqs:
            q.submit(r)
        _, first = q.poll()  # 8 flush full
        _, rest = q.poll(eager=True)
        assert [r.seq for r in first + rest] == sorted(
            r.seq for r in reqs
        )
        assert first == reqs[:8] and rest == reqs[8:]


class TestOverload:
    def test_shed_flushes_largest_full_smaller_bucket(self):
        # head group [2,2,1] = 5 rows can't reach the 8-bucket (the next
        # request is size 8); a full bucket of backlog sits behind it →
        # the flush sheds DOWN to the largest fully-fillable bucket (4,
        # zero pad rows) instead of padding 5 rows up to 8
        q, _ = make_queue(cap=16)
        a, b, c, big = req(2), req(2), req(1), req(8)
        for r in (a, b, c, big):
            q.submit(r)
        bucket, got = q.poll()
        assert (bucket, got) == (4, [a, b])  # full 4, no padding
        bucket, got = q.poll()
        assert (bucket, got) == (1, [c])  # still shedding: full 1
        bucket, got = q.poll()
        assert (bucket, got) == (8, [big])

    def test_shed_keeps_padding_for_an_unsplittable_head(self):
        # a single 5-row request with backlog behind it cannot fill any
        # smaller bucket — it keeps its covering bucket (padding and all)
        # rather than deadlocking
        q, _ = make_queue(cap=16)
        head, big = req(5), req(8)
        q.submit(head)
        q.submit(big)
        bucket, got = q.poll()
        assert (bucket, got) == (8, [head])

    def test_hard_cap_rejects_with_reason(self):
        q, _ = make_queue(cap=8)
        for _ in range(8):
            assert q.submit(req()) is None
        assert q.submit(req()) == REJECT_OVERLOAD
        assert q.rejected == 1
        # draining restores admission
        assert q.poll() is not None
        assert q.submit(req()) is None

    def test_depth_never_exceeds_cap(self):
        q, _ = make_queue(cap=8)
        for _ in range(50):
            q.submit(req())
        assert q.depth_images == 8
        assert q.max_depth_seen == 8

    def test_too_large_rejected_regardless_of_load(self):
        q, _ = make_queue(buckets=(1, 2, 4))
        assert q.submit(req(5)) == REJECT_TOO_LARGE
        assert q.depth_images == 0

    def test_cap_below_largest_bucket_raises(self):
        with pytest.raises(ValueError):
            make_queue(buckets=(1, 8), cap=4)


class TestLifecycle:
    def test_stop_returns_pending_and_rejects_new(self):
        q, _ = make_queue()
        rs = [req(), req()]
        for r in rs:
            q.submit(r)
        assert q.stop() == rs
        assert q.depth_images == 0
        # a stopping queue answers "shutdown" (retry elsewhere), not
        # "overloaded" (back off and retry here)
        assert q.submit(req()) == REJECT_SHUTDOWN

    def test_wait_for_work_times_out_against_the_clock(self):
        # fake clock never advances inside cond.wait — bound the wait
        # via a zero timeout instead
        q, _ = make_queue()
        assert q.wait_for_work(timeout=0.0) is None

    def test_submit_stamps_seq_and_deadline(self):
        q, clock = make_queue(slo_s=0.2)
        clock.advance(1.0)
        r = req()
        q.submit(r)
        assert r.enqueue_t == 1.0
        assert r.deadline_t == pytest.approx(1.2)


class TestMetrics:
    def test_percentile_nearest_rank(self):
        values = [float(v) for v in range(1, 101)]
        assert percentile(values, 50) == pytest.approx(50.0, abs=1.0)
        assert percentile(values, 99) == pytest.approx(99.0, abs=1.0)
        assert np.isnan(percentile([], 50))
        assert percentile([7.0], 99) == 7.0

    def test_snapshot_aggregates(self):
        clock = FakeClock()
        m = ServeMetrics(clock=clock)
        m.record_request(2, enqueue_t=0.0, dispatch_t=0.01, done_t=0.03)
        m.record_request(1, enqueue_t=0.0, dispatch_t=0.02, done_t=0.05)
        m.record_rejection("overloaded")
        m.record_dispatch(4, real_rows=3)
        snap = m.snapshot(elapsed_s=1.0)
        assert snap["requests_ok"] == 2
        assert snap["images_ok"] == 3
        assert snap["imgs_per_s"] == pytest.approx(3.0)
        assert snap["rejected"] == {"overloaded": 1}
        assert snap["p50_ms"] in (30.0, 50.0)
        assert snap["p99_ms"] == 50.0
        assert snap["bucket_dispatches"] == {"4": 1}

    def test_latency_samples_are_windowed_but_counters_exact(self):
        # a long-running server must not grow memory per request: the
        # percentile samples keep the most recent `window` requests
        # while the totals stay exact for the server's lifetime
        m = ServeMetrics(clock=FakeClock(), window=4)
        for i in range(10):
            m.record_request(1, enqueue_t=0.0, dispatch_t=0.0,
                             done_t=float(i + 1))
        assert len(m._latencies_s) == 4
        snap = m.snapshot(elapsed_s=1.0)
        assert snap["requests_ok"] == 10  # counter: exact
        assert snap["images_ok"] == 10
        assert snap["p99_ms"] == 10_000.0  # percentiles: recent window


class TestPolicyParity:
    """The port's pure policy makes the JAX package's decisions."""

    @pytest.mark.parametrize("seed", range(4))
    def test_decisions_match_jax_policy(self, seed):
        from distributedpytorch_tpu.serve import policy as jax_policy
        from distributedpytorch_tpu.serve.bucketing import (
            BucketPlanner as JaxBucketPlanner,
        )
        from distributedpytorch_tpu_torch.serve import policy

        rng = np.random.default_rng(seed)
        planner = BucketPlanner((1, 2, 4, 8))
        jax_planner = JaxBucketPlanner((1, 2, 4, 8))
        for _ in range(200):
            sizes = [int(s) for s in rng.integers(1, 9, rng.integers(0, 7))]
            deadline = float(rng.random())
            now = float(rng.random())
            eager = bool(rng.integers(0, 2))
            got = policy.decide_flush(planner, sizes, deadline, sum(sizes),
                                      now, eager=eager)
            want = jax_policy.decide_flush(jax_planner, sizes, deadline,
                                           sum(sizes), now, eager=eager)
            assert (got is None) == (want is None)
            if got is not None:
                assert (got.kind, got.bucket, got.count, got.rows) == (
                    want.kind, want.bucket, want.count, want.rows)
            size, cap = int(rng.integers(1, 10)), int(rng.integers(8, 20))
            assert policy.admit_decision(planner, sum(sizes), size, cap) == (
                jax_policy.admit_decision(jax_planner, sum(sizes), size, cap))
