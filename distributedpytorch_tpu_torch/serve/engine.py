"""The replica executor: one forward per bucket shape, replicated
data-parallel over the cards.

Counterpart of ``distributedpytorch_tpu/serve/engine.py`` (without the
AOT store and weight rollout). Where the JAX engine compiles one
executable per (replica, bucket), the port captures one CUDA graph per
(replica, bucket) on a card: ``Replica.compiled[b]`` is a
:class:`BucketForward`, which refuses any other batch shape. At build
each bucket's forward runs eagerly on a side stream (cuDNN's algorithm
choice, the kernels' first-use build and the caching allocator settle),
then one forward is captured into a graph whose memory comes from the
replica's own pool. A call copies the batch into the graph's static
input, replays the graph and copies the static output into a tensor of
its own, all on the current stream: a later replay of the same bucket
cannot overwrite a result that the completion drain has not read yet. A
capture that fails raises; there is no eager fallback on a card. On the
CPU the forward runs eagerly.

With ``quantized`` the replica holds the int8 twin of the model
(ops/quant.py), made on the host before the replica is built, so no
float copy of a quantized weight reaches the card.

**Streams.** Each replica on a card owns two CUDA streams. The placement
worker copies a bucket from pinned host memory on the *copy* stream and
records an event; the dispatch thread makes the *compute* stream wait on
that event, runs the bucket's forward there and records a *done* event.
The completion drain waits on the done event before it reads the result.
Both the current stream and ``inference_mode`` are per thread in
PyTorch, which is why each step sets them itself; the dispatch thread
never blocks on the card.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distributedpytorch_tpu_torch.data.dataset import SampleCache
from distributedpytorch_tpu_torch.serve.bucketing import BucketPlanner
from distributedpytorch_tpu_torch.serve.infer import (
    InferenceBundle,
    make_forward,
    postprocess_mask,
    preprocess_image,
)
from distributedpytorch_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


#: Eager forwards of a bucket on the side stream before its capture.
GRAPH_WARMUP = 2


class BucketForward:
    """One bucket's forward on one replica: eager on the CPU, a replay of
    the CUDA graph captured by :meth:`capture` on a card. Calls on one
    replica must come from one stream at a time (the replica's compute
    stream), as the graph's input, output and pool are shared."""

    def __init__(self, fwd: Callable[[torch.Tensor], torch.Tensor],
                 shape: Tuple[int, ...]):
        self.fwd = fwd
        self.shape = tuple(shape)
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.static_x: Optional[torch.Tensor] = None
        self.static_out: Optional[torch.Tensor] = None

    def _check(self, x: torch.Tensor) -> None:
        if tuple(x.shape) != self.shape:
            raise ValueError(
                f"bucket forward built for {self.shape}, got {tuple(x.shape)}"
            )

    def eager(self, x: torch.Tensor) -> torch.Tensor:
        """The forward without the graph (the graph's comparator)."""
        self._check(x)
        return self.fwd(x)

    def capture(self, device: torch.device, pool) -> None:
        """Warm up on a side stream, then capture one forward on it into
        a graph allocating from ``pool``. A failure raises."""
        b = self.shape[0]
        try:
            with torch.cuda.device(device):
                static_x = torch.zeros(self.shape, dtype=torch.float32,
                                       device=device)
                side = torch.cuda.Stream(device)
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side):
                    for _ in range(GRAPH_WARMUP):
                        self.fwd(static_x)
                torch.cuda.current_stream(device).wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=pool, stream=side):
                    static_out = self.fwd(static_x)
        except Exception as exc:
            raise RuntimeError(
                f"capturing the bucket-{b} forward on {device} as a CUDA "
                f"graph failed: {exc}") from exc
        self.graph = graph
        self.static_x, self.static_out = static_x, static_out

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        if self.graph is None:
            return self.fwd(x)
        with torch.inference_mode():
            self.static_x.copy_(x)
            self.graph.replay()
            return self.static_out.clone()


@dataclasses.dataclass
class Replica:
    """One device's serving state: the model's weights resident on
    ``device`` and one forward per bucket size. ``stream`` and
    ``copy_stream`` are None on the CPU."""

    index: int
    device: torch.device
    model: torch.nn.Module
    compiled: Dict[int, BucketForward]
    stream: Optional["torch.cuda.Stream"] = None
    copy_stream: Optional["torch.cuda.Stream"] = None


@dataclasses.dataclass
class Placed:
    """A bucket on its replica's device; ``ready`` marks the end of its
    host→device copy (None on the CPU)."""

    x: torch.Tensor
    ready: Optional["torch.cuda.Event"] = None


@dataclasses.dataclass
class DeviceResult:
    """A dispatched forward's output; ``done`` marks its end on the card
    (None on the CPU). ``numpy()`` is the sanctioned sync point."""

    out: torch.Tensor
    done: Optional["torch.cuda.Event"] = None

    def numpy(self) -> np.ndarray:
        if self.done is not None:
            self.done.synchronize()
        return self.out.cpu().numpy()


def _devices_for(device: torch.device) -> List[torch.device]:
    """``cuda`` without an index means every visible card; anything else
    is that one device."""
    if device.type == "cuda" and device.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


class ServeEngine:
    """Build with a float32 model (its weights are copied to each replica's
    device) or from an :class:`InferenceBundle`. With ``quantized`` a
    float model is quantized on the host first (an int8 twin is taken as
    it is)."""

    def __init__(
        self,
        model: torch.nn.Module,
        input_hw: Tuple[int, int],
        bucket_sizes: Sequence[int] = (1, 2, 4, 8),
        replicas: int = 1,
        threshold: float = 0.5,
        host_cache_mb: int = 0,
        kernels=None,
        device=None,
        quantized: bool = False,
    ):
        from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
        from distributedpytorch_tpu_torch.ops.quant import (
            is_quantized_model,
            quantize_model,
        )

        self.device = resolve_device(device)
        self.planner = BucketPlanner(bucket_sizes)
        self.input_hw = (int(input_hw[0]), int(input_hw[1]))
        self.threshold = float(threshold)
        self.channels = 3  # RGB rows, as the preprocess emits
        self.cache = (
            SampleCache(host_cache_mb * 2**20) if host_cache_mb > 0 else None
        )
        # kernel policy (ops/kernels.py): with serve_mask engaged every
        # bucket forward ends in the serve-mask kernel and returns uint8
        # masks, which postprocess() passes through untouched
        self.kernel_policy = get_kernel_policy(kernels, self.device)
        self.mask_on_device = self.kernel_policy.serve_mask
        if quantized and not is_quantized_model(model):
            model = quantize_model(model)
        self.quantized = is_quantized_model(model)
        # CUDA graphs captured over the engine's life: the /stats
        # aot_cache block's ``compiles``
        self.graph_captures = 0
        devices = _devices_for(self.device)
        n = max(1, min(int(replicas), len(devices)))
        if replicas > len(devices):
            logger.warning(
                "requested %d replicas but only %d devices — serving with %d",
                replicas, len(devices), n,
            )
        t0 = time.monotonic()
        self.replicas: List[Replica] = [
            self._build_replica(i, devices[i], model) for i in range(n)
        ]
        logger.info(
            "built %d replica(s) with buckets %s on %s in %.1f s "
            "(%d CUDA graphs captured%s)",
            n, list(self.planner.sizes), self.device, time.monotonic() - t0,
            self.graph_captures, ", int8 weights" if self.quantized else "",
        )

    @classmethod
    def from_bundle(cls, bundle: InferenceBundle, **kwargs) -> "ServeEngine":
        kwargs.setdefault("quantized", bundle.quantized)
        return cls(bundle.model, input_hw=bundle.input_hw, **kwargs)

    def _build_replica(self, index: int, device: torch.device,
                       model: torch.nn.Module) -> Replica:
        cuda = device.type == "cuda"
        model = copy.deepcopy(model).to(device).eval()
        if hasattr(model, "set_conv_epilogue"):
            # milesial: the bucket forward's BatchNorm + ReLU takes the
            # epilogue kernel exactly when the engine's policy says so
            model.set_conv_epilogue(self.kernel_policy.conv_epilogue)
        fwd = make_forward(
            model,
            mask_threshold=self.threshold if self.mask_on_device else None,
        )
        h, w = self.input_hw
        compiled = {b: BucketForward(fwd, (b, h, w, self.channels))
                    for b in self.planner.sizes}
        stream = copy_stream = None
        if cuda:
            stream = torch.cuda.Stream(device)
            copy_stream = torch.cuda.Stream(device)
            # one pool for the replica's graphs: their replays are
            # serialized on its compute stream
            pool = torch.cuda.graph_pool_handle()
            for forward in compiled.values():
                forward.capture(device, pool)
                self.graph_captures += 1
        return Replica(index=index, device=device, model=model,
                       compiled=compiled, stream=stream,
                       copy_stream=copy_stream)

    @property
    def aot_cache_stats(self) -> dict:
        """The ``/stats`` ``aot_cache`` block with the JAX engine's keys.
        Nothing persists across restarts (a CUDA graph cannot be
        stored), so the store is never enabled; ``compiles`` counts the
        graphs this engine captured."""
        return {"enabled": False, "dir": None, "hit": 0, "miss": 0,
                "skew": 0, "compiles": self.graph_captures}

    @property
    def num_replicas(self) -> int:
        return len(self.replicas)

    @staticmethod
    def _on(replica: Replica, stream):
        if stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(replica.device))
        stack.enter_context(torch.cuda.stream(stream))
        return stack

    # -- request path pieces (the server wires these together) ---------------
    def place(self, replica: Replica, batch: np.ndarray) -> Placed:
        """Host batch → the replica's device, asynchronously on its copy
        stream (pinned host memory). The server runs this on the
        placement worker, ahead of dispatch."""
        host = torch.from_numpy(np.ascontiguousarray(batch, np.float32))
        if replica.copy_stream is None:
            return Placed(host.to(replica.device))
        host = host.pin_memory()
        with self._on(replica, replica.copy_stream):
            x = host.to(replica.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(replica.copy_stream)
        return Placed(x, ready)

    def run(self, replica: Replica, placed: Placed) -> DeviceResult:
        """Dispatch the bucket's forward on the replica's compute stream
        without waiting for it. Raises KeyError for a batch size no
        bucket was built for."""
        fn = replica.compiled[placed.x.shape[0]]
        if replica.stream is None:
            return DeviceResult(fn(placed.x))
        with self._on(replica, replica.stream):
            replica.stream.wait_event(placed.ready)
            # the copy stream allocated x; keep its memory until the
            # compute stream is done with it
            placed.x.record_stream(replica.stream)
            out = fn(placed.x)
            done = torch.cuda.Event()
            done.record(replica.stream)
        return DeviceResult(out, done)

    def infer(self, batch: np.ndarray) -> np.ndarray:
        """Synchronous single-bucket inference (tests, warmup): pads to
        the smallest covering bucket, runs, returns the real rows'
        ``(n, H, W)`` float32 probabilities — or uint8 masks with the
        serve-mask kernel engaged."""
        from distributedpytorch_tpu_torch.serve.bucketing import pad_batch

        n = batch.shape[0]
        bucket = self.planner.bucket_for(n)
        if bucket is None:
            raise ValueError(
                f"batch of {n} exceeds the largest bucket "
                f"({self.planner.max_size})"
            )
        replica = self.replicas[0]
        placed = self.place(replica, pad_batch(np.asarray(batch, np.float32),
                                               bucket))
        return self.run(replica, placed).numpy()[:n]

    def warmup(self) -> None:
        """Run every (replica, bucket) once on zeros."""
        h, w = self.input_hw
        for replica in self.replicas:
            for b in self.planner.sizes:
                zeros = np.zeros((b, h, w, self.channels), np.float32)
                self.run(replica, self.place(replica, zeros)).numpy()

    # -- host-side decode (ingress; SampleCache-backed) ----------------------
    def preprocess(self, source, cache_key=None) -> np.ndarray:
        """One image source → a model input row ``(H, W, C) float32``:
        a ready array (validated), a path (decoded through the cache when
        one is configured), or a PIL image."""
        h, w = self.input_hw
        if isinstance(source, np.ndarray):
            if source.shape != (h, w, self.channels):
                raise ValueError(
                    f"expected ({h}, {w}, {self.channels}) input row, got "
                    f"{source.shape}"
                )
            return np.asarray(source, np.float32)
        if isinstance(source, str):
            key = cache_key if cache_key is not None else (source, (w, h))
            if self.cache is not None:
                hit = self.cache.get(key)
                if hit is not None:
                    return hit["image"]
            from distributedpytorch_tpu_torch.serve.infer import load_image

            row = load_image(source, (w, h))
            if self.cache is not None:
                self.cache.put(key, {"image": row})
            return row
        return preprocess_image(source, (w, h))

    def postprocess(self, probs: np.ndarray) -> np.ndarray:
        return postprocess_mask(probs, self.threshold)


def engine_from_checkpoint(
    checkpoint: str,
    checkpoint_dir: str = "./checkpoints",
    image_size: Sequence[int] = (960, 640),
    model_arch: str = "unet",
    model_widths: Optional[Sequence[int]] = None,
    s2d_levels: int = -1,
    dtype: str = "bf16",
    quantize: Optional[str] = None,
    **engine_kwargs,
) -> ServeEngine:
    """Checkpoint name/path → a ready engine (``engine_kwargs`` go to
    :class:`ServeEngine`; ``device="cpu"`` for a CPU run;
    ``quantize="int8"`` serves int8 weights)."""
    from distributedpytorch_tpu_torch.serve.infer import load_inference_bundle

    # fail on a missing card before reading any weights
    resolve_device(engine_kwargs.get("device"))
    bundle = load_inference_bundle(
        checkpoint, checkpoint_dir=checkpoint_dir, image_size=image_size,
        model_arch=model_arch, model_widths=model_widths,
        s2d_levels=s2d_levels, dtype=dtype, quantize=quantize,
    )
    return ServeEngine.from_bundle(bundle, **engine_kwargs)
