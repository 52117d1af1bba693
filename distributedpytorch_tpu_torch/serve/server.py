"""The serve loop: queue → placement worker → replica dispatch →
completion drain, wrapped in an in-process supervisor that relaunches a
dead dispatch core.

Counterpart of ``distributedpytorch_tpu/serve/server.py`` (without the
prediction cache, request tracing, fault injection, rollout, A/B and the
scaler). The threads and who may block on the card:

* **ingress** (caller threads / HTTP handlers): decode + preprocess,
  admit into the :class:`BatchingQueue`. A rejection resolves the future
  at once with a status — overload is an answer, not an exception.
* **placement worker** (``utils/prefetch.pipelined_placement``): claims
  a replica in-flight SLOT, stacks + pads the group into its bucket and
  starts its copy to the card, ``depth`` buckets ahead of dispatch. Slots
  return at completion, so claiming one is the backpressure.
* **dispatch loop** (``_dispatch_loop``): makes the replica's compute
  stream wait for the copy and enqueues the forward. It never blocks on
  the card — no ``.cpu()``, ``.item()`` or ``synchronize()``.
* **completion workers** (``pull``): wait for the forward's event, copy
  the result to the host, slice off pad rows, split per request,
  threshold (unless the card already did), resolve futures, stamp
  metrics.

**Self-healing** (``_supervise``): when the dispatch loop dies, its
in-flight futures resolve with ``error``, and the supervisor rebuilds
the core (a fresh queue + dispatch thread against the same engine) after
exponential backoff, up to ``restart_limit`` times. Meanwhile ``submit``
answers :data:`REJECT_RELAUNCHING` and ``/healthz`` reports not ready;
with the budget spent the server goes terminal (``shutdown``).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import queue as queue_mod
import threading
import time
import uuid
from typing import List, Optional

import numpy as np

from distributedpytorch_tpu_torch.serve.bucketing import stack_group
from distributedpytorch_tpu_torch.serve.engine import (
    DeviceResult,
    Replica,
    ServeEngine,
)
from distributedpytorch_tpu_torch.serve.metrics import ServeMetrics
from distributedpytorch_tpu_torch.serve.queue import (
    REJECT_SHUTDOWN,
    BatchingQueue,
    ServeRequest,
)
from distributedpytorch_tpu_torch.utils.prefetch import (
    SINGLE,
    pipelined_placement,
)

logger = logging.getLogger(__name__)

STATUS_OK = "ok"
STATUS_REJECTED = "rejected"
STATUS_ERROR = "error"
STATUS_SHUTDOWN = "shutdown"

#: Rejection reason while the dispatch core is between incarnations:
#: "back off and retry HERE" (vs ``shutdown``'s "retry elsewhere").
REJECT_RELAUNCHING = "relaunching"

#: Server lifecycle states (``/stats`` ``state`` field, readiness).
STATE_SERVING = "serving"
STATE_RELAUNCHING = "relaunching"
STATE_STOPPED = "stopped"

#: _place's "this group already failed and was resolved" marker: the
#: dispatch loop skips it and keeps serving (None means "stopping").
_PLACE_FAILED = object()


@dataclasses.dataclass
class ServeResponse:
    """What a request's future resolves to. ``masks`` is one
    ``(H, W) uint8 {0, 255}`` array per submitted image (None unless
    status == "ok")."""

    key: str
    status: str
    reason: str = ""
    masks: Optional[List[np.ndarray]] = None
    latency_ms: float = 0.0
    request_id: str = ""

    @property
    def ok(self) -> bool:
        return self.status == STATUS_OK


def pull(server: "Server", replica: Replica, out: DeviceResult, bucket: int,
         reqs: List[ServeRequest], dispatch_t: float) -> None:
    """Completion drain (the sanctioned sync point): wait for the forward,
    fan masks back out to request futures, record metrics — and only
    THEN return the replica's in-flight slot, which bounds the work in
    the system."""
    try:
        probs = out.numpy()  # waits for the forward's done event
        done_t = server.clock()
        row = 0
        for req in reqs:
            masks = [
                server.engine.postprocess(probs[row + i])
                for i in range(req.size)
            ]
            row += req.size
            server.metrics.record_request(
                req.size, req.enqueue_t, dispatch_t, done_t,
            )
            req.future.set_result(ServeResponse(
                key=req.key, status=STATUS_OK, masks=masks,
                latency_ms=(done_t - req.enqueue_t) * 1e3,
                request_id=req.request_id,
            ))
    except Exception as exc:  # noqa: BLE001 — a drain failure must fail
        logger.exception("completion drain failed for bucket %d", bucket)
        for req in reqs:  # the requests, never hang their futures
            if not req.future.done():
                server.metrics.record_failure()
                req.future.set_result(ServeResponse(
                    key=req.key, status=STATUS_ERROR, reason=str(exc),
                    request_id=req.request_id,
                ))
    finally:
        server._free.put(replica)
        # capacity just freed: wake the queue for an eager flush now
        server.queue.kick()


class Server:
    """In-process serving core; the HTTP layer (serve/cli.py) drives
    exactly this object."""

    def __init__(
        self,
        engine: ServeEngine,
        slo_ms: float = 50.0,
        hard_cap_images: Optional[int] = None,
        placement_depth: int = 2,
        completion_workers: Optional[int] = None,
        eager_when_idle: bool = True,
        inflight_per_replica: int = 2,
        restart_limit: int = 3,
        restart_backoff_s: float = 0.25,
    ):
        self.engine = engine
        self.clock = time.monotonic
        self.metrics = ServeMetrics(clock=self.clock)
        self.slo_ms = float(slo_ms)
        self.hard_cap_images = hard_cap_images
        self.queue = self._new_queue()
        self.placement_depth = int(placement_depth)
        self.eager_when_idle = bool(eager_when_idle)
        self.restart_limit = int(restart_limit)
        self.restart_backoff_s = float(restart_backoff_s)
        self.core_restarts = 0
        # The in-flight slot pool: each replica appears
        # ``inflight_per_replica`` times; a slot is claimed at placement
        # and returned at COMPLETION (see ``pull``).
        self._free: queue_mod.Queue = queue_mod.Queue()
        self.inflight_per_replica = max(1, int(inflight_per_replica))
        for _slot in range(self.inflight_per_replica):
            for replica in engine.replicas:
                self._free.put(replica)
        self._total_slots = self._free.qsize()
        if completion_workers is None:
            # every in-flight slot must be drainable concurrently
            completion_workers = self._total_slots
        self._completion = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, completion_workers),
            thread_name_prefix="dpt-serve-pull",
        )
        self._stop = threading.Event()
        self._gen_stop = threading.Event()  # current incarnation's stop
        self._state = STATE_SERVING
        self._thread: Optional[threading.Thread] = None
        self._dispatch_error: Optional[BaseException] = None
        self.config = None  # set by from_config; /healthz fingerprint

    def _new_queue(self) -> BatchingQueue:
        return BatchingQueue(
            self.engine.planner, slo_s=self.slo_ms / 1e3,
            hard_cap_images=self.hard_cap_images, clock=self.clock,
        )

    # -- lifecycle -----------------------------------------------------------
    @property
    def state(self) -> str:
        return self._state

    @property
    def ready(self) -> bool:
        """Readiness: accepting AND serving traffic now."""
        return self._state == STATE_SERVING

    def start(self) -> "Server":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._thread = threading.Thread(
            target=self._supervise, name="dpt-serve-supervise", daemon=True
        )
        self._thread.start()
        return self

    def _supervise(self) -> None:
        """Run dispatch-core incarnations until a clean stop or the
        restart budget is spent. Each incarnation gets its own queue and
        stop event; the engine is shared across all of them."""
        while True:
            gen_stop = self._gen_stop
            self._dispatch_error = None
            self._state = STATE_SERVING
            self._dispatch_loop(self.queue, gen_stop)
            if self._stop.is_set() or self._dispatch_error is None:
                return  # clean stop() — not a failure
            self.core_restarts += 1
            if self.core_restarts > self.restart_limit:
                self._state = STATE_STOPPED
                logger.error(
                    "serve dispatch core died %d times — restart budget "
                    "(%d) exhausted; going terminal",
                    self.core_restarts, self.restart_limit,
                )
                self._stop.set()
                return
            self._state = STATE_RELAUNCHING
            backoff = self.restart_backoff_s * (
                2.0 ** (self.core_restarts - 1)
            )
            logger.warning(
                "serve dispatch core died (%s) — relaunching in %.2fs "
                "(restart %d/%d)",
                type(self._dispatch_error).__name__, backoff,
                self.core_restarts, self.restart_limit,
            )
            if self._stop.wait(backoff):
                return
            # fresh incarnation; every error path of the dead one returned
            # its slot, so the pool is whole
            self.queue = self._new_queue()
            self._gen_stop = threading.Event()

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop serving. ``drain=True`` first waits (wall clock) for the
        queue to empty and every in-flight slot to return; requests still
        pending after that resolve with ``shutdown``."""
        if drain:
            limit = time.monotonic() + timeout
            while (time.monotonic() < limit
                   and self._dispatch_error is None
                   and not self._stop.is_set()
                   and (self.queue.depth_images > 0
                        or self._free.qsize() < self._total_slots)):
                time.sleep(0.01)
        self._stop.set()
        self._gen_stop.set()
        self._state = STATE_STOPPED
        for req in self.queue.stop():
            if not req.future.done():
                req.future.set_result(ServeResponse(
                    key=req.key, status=STATUS_SHUTDOWN, reason="shutdown",
                    request_id=req.request_id,
                ))
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        self._completion.shutdown(wait=True)

    # -- ingress -------------------------------------------------------------
    def submit(self, images, key: str = "",
               request_id: Optional[str] = None
               ) -> "concurrent.futures.Future":
        """Admit one request. ``images``: a single ``(H, W, C)`` row, a
        ``(k, H, W, C)`` stack, a list of rows, or a list of path strings
        / PIL images (decoded through the engine's cache). The future
        ALWAYS resolves to a :class:`ServeResponse`. ``request_id`` is the
        caller's id; None assigns one."""
        future: concurrent.futures.Future = concurrent.futures.Future()
        rid = request_id or uuid.uuid4().hex[:16]
        state = self._state
        if state != STATE_SERVING:
            reason = (REJECT_RELAUNCHING if state == STATE_RELAUNCHING
                      else REJECT_SHUTDOWN)
            status = (STATUS_REJECTED if state == STATE_RELAUNCHING
                      else STATUS_SHUTDOWN)
            self.metrics.record_rejection(reason)
            future.set_result(ServeResponse(
                key=key, status=status, reason=reason, request_id=rid,
            ))
            return future
        try:
            rows = self._as_rows(images)
        except Exception as exc:  # noqa: BLE001 — bad input is a response
            self.metrics.record_failure()
            future.set_result(ServeResponse(
                key=key, status=STATUS_ERROR, reason=str(exc),
                request_id=rid,
            ))
            return future
        req = ServeRequest(images=rows, future=future, key=key,
                           request_id=rid)
        reason = self.queue.submit(req)
        if reason is not None:
            if reason == REJECT_SHUTDOWN and self._state != STATE_STOPPED:
                # the core died between the state check and the admit:
                # this instance is relaunching, not going away
                reason = REJECT_RELAUNCHING
            self.metrics.record_rejection(reason)
            status = (STATUS_SHUTDOWN if reason == REJECT_SHUTDOWN
                      else STATUS_REJECTED)
            future.set_result(ServeResponse(
                key=key, status=status, reason=reason, request_id=rid,
            ))
        return future

    def retry_after_s(self, reason: str) -> int:
        """The HTTP ``Retry-After`` hint for a 503."""
        if reason == REJECT_RELAUNCHING:
            backoff = self.restart_backoff_s * (
                2.0 ** max(0, self.core_restarts - 1)
            )
            return max(1, int(backoff + 0.999))
        if reason == REJECT_SHUTDOWN:
            return 5
        return max(1, int(self.slo_ms / 1e3 + 0.999))

    def _as_rows(self, images) -> List[np.ndarray]:
        if isinstance(images, np.ndarray):
            if images.ndim == 3:
                return [self.engine.preprocess(images)]
            if images.ndim == 4:
                return [self.engine.preprocess(row) for row in images]
            raise ValueError(f"expected 3- or 4-d array, got {images.shape}")
        if isinstance(images, (list, tuple)):
            return [self.engine.preprocess(src) for src in images]
        return [self.engine.preprocess(images)]  # path / PIL image

    # -- the serve pipeline --------------------------------------------------
    def _bucket_stream(self, queue: BatchingQueue, gen_stop: threading.Event):
        """Flushed groups as prefetch work items. ``eager`` tracks free
        capacity: with an idle replica slot, batching never adds latency."""

        def eager() -> bool:
            return self.eager_when_idle and not self._free.empty()

        while not (gen_stop.is_set() or self._stop.is_set()):
            got = queue.wait_for_work(timeout=0.25, eager=eager)
            if got is not None:
                yield (SINGLE, got)

    def _place(self, kind: str, payload):
        """Placement worker: claim a replica slot (backpressure), stack +
        pad to the bucket shape, start the copy to the replica's card."""
        bucket, reqs = payload
        replica = self._claim_replica()
        if replica is None:  # stopping — already popped from the queue,
            # so queue.stop() will never see them: resolve here
            for req in reqs:
                if not req.future.done():
                    req.future.set_result(ServeResponse(
                        key=req.key, status=STATUS_SHUTDOWN,
                        reason="shutdown", request_id=req.request_id,
                    ))
            return None
        try:
            rows = [row for req in reqs for row in req.images]
            batch = stack_group(rows, bucket)
            return replica, self.engine.place(replica, batch), bucket, reqs
        except Exception as exc:  # noqa: BLE001 — contain to the group:
            # resolve ITS futures and return the claimed slot
            logger.exception("placement failed for bucket %d", bucket)
            self._free.put(replica)
            self.queue.kick()
            for req in reqs:
                if not req.future.done():
                    self.metrics.record_failure()
                    req.future.set_result(ServeResponse(
                        key=req.key, status=STATUS_ERROR, reason=str(exc),
                        request_id=req.request_id,
                    ))
            return _PLACE_FAILED

    def _claim_replica(self) -> Optional[Replica]:
        while not (self._gen_stop.is_set() or self._stop.is_set()):
            try:
                return self._free.get(timeout=0.1)
            except queue_mod.Empty:
                continue
        return None

    def _dispatch_loop(self, queue: BatchingQueue,
                       gen_stop: threading.Event) -> None:
        stream = pipelined_placement(
            self._bucket_stream(queue, gen_stop), self._place,
            depth=self.placement_depth, name="dpt-serve-place",
        )
        try:
            for _item, placed in stream:
                if placed is None:
                    break
                if placed is _PLACE_FAILED:  # group already resolved
                    continue
                replica, x_dev, bucket, reqs = placed
                try:
                    dispatch_t = self.clock()
                    out = self.engine.run(replica, x_dev)
                    self.metrics.record_dispatch(
                        bucket, sum(req.size for req in reqs)
                    )
                    self._completion.submit(
                        pull, self, replica, out, bucket, reqs, dispatch_t,
                    )
                except BaseException:
                    # the group in hand would otherwise die with the loop,
                    # its futures unresolved
                    self._free.put(replica)
                    for req in reqs:
                        if not req.future.done():
                            self.metrics.record_failure()
                            req.future.set_result(ServeResponse(
                                key=req.key, status=STATUS_ERROR,
                                reason="dispatch failed",
                                request_id=req.request_id,
                            ))
                    raise
        except BaseException as exc:  # noqa: BLE001 — fail pending futures
            self._dispatch_error = exc
            logger.exception("serve dispatch loop died")
            # end THIS incarnation only; _supervise decides what follows
            gen_stop.set()
            for req in queue.stop():
                if not req.future.done():
                    req.future.set_result(ServeResponse(
                        key=req.key, status=STATUS_ERROR, reason=str(exc),
                        request_id=req.request_id,
                    ))
        finally:
            # groups still buffered in the placement pipeline would vanish
            # with their futures unresolved: drain and resolve them (every
            # exit path has a stop event set, so the stream is finite)
            exc = self._dispatch_error
            status = STATUS_ERROR if exc is not None else STATUS_SHUTDOWN
            reason = str(exc) if exc is not None else "shutdown"
            for _item, placed in stream:
                if placed is None or placed is _PLACE_FAILED:
                    continue
                replica, _x_dev, _bucket, reqs = placed
                self._free.put(replica)
                for req in reqs:
                    if not req.future.done():
                        req.future.set_result(ServeResponse(
                            key=req.key, status=status, reason=reason,
                            request_id=req.request_id,
                        ))

    # -- factory -------------------------------------------------------------
    @classmethod
    def from_config(cls, cfg) -> "Server":
        """Build from a :class:`~distributedpytorch_tpu_torch.config.
        ServeConfig`: the checkpoint fields drive
        ``engine_from_checkpoint``, the rest the server."""
        from distributedpytorch_tpu_torch.ops.kernels import (
            config_priors,
            get_kernel_policy,
        )
        from distributedpytorch_tpu_torch.serve.engine import (
            engine_from_checkpoint,
        )
        from distributedpytorch_tpu_torch.utils.device import resolve_device

        kernels = cfg.kernels
        if cfg.kernel_priors:
            # --kernel-priors: the policy resolved with the file's verdicts
            kernels = get_kernel_policy(kernels, resolve_device(cfg.device),
                                        priors=config_priors(cfg) or {})
        engine = engine_from_checkpoint(
            cfg.checkpoint,
            checkpoint_dir=cfg.checkpoint_dir,
            image_size=cfg.image_size,
            model_arch=cfg.model_arch,
            model_widths=cfg.model_widths,
            s2d_levels=cfg.s2d_levels,
            quantize=cfg.quantize,
            bucket_sizes=cfg.bucket_sizes,
            replicas=cfg.replicas,
            threshold=cfg.threshold,
            host_cache_mb=cfg.host_cache_mb,
            kernels=kernels,
            device=cfg.device,
        )
        server = cls(
            engine,
            slo_ms=cfg.slo_ms,
            hard_cap_images=cfg.queue_cap_images,
            placement_depth=cfg.placement_depth,
            completion_workers=cfg.completion_workers,
            eager_when_idle=cfg.eager_when_idle,
            inflight_per_replica=cfg.inflight_per_replica,
            restart_limit=cfg.restart_limit,
            restart_backoff_s=cfg.restart_backoff_s,
        )
        server.config = cfg
        return server

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        """The ``/stats`` snapshot, with the JAX package's key set. Keys
        of features this port does not have yet read ``None``;
        ``weights_version`` is always 0 (the startup weights — there is
        no hot swap). ``aot_cache`` carries the JAX block, never enabled,
        with ``compiles`` the CUDA graphs the engine captured."""
        snap = self.metrics.snapshot()
        snap.update({
            "queue_depth_images": self.queue.depth_images,
            "queue_max_depth_images": self.queue.max_depth_seen,
            "queue_hard_cap_images": self.queue.hard_cap_images,
            "replicas": self.engine.num_replicas,
            "buckets": list(self.engine.planner.sizes),
            "weights_version": 0,
            "state": self._state,
            "core_restarts": self.core_restarts,
            "predict_cache": None,
            "attribution": None,
            "aot_cache": self.engine.aot_cache_stats,
            "ab": None,
            "scaler": None,
        })
        return snap
