"""``python -m distributedpytorch_tpu_torch serve``: HTTP over the
in-process :class:`Server`.

Stdlib-only transport (``http.server.ThreadingHTTPServer``): each
connection's handler thread decodes, submits and waits on the request's
future, so the batching queue coalesces across handler threads.
Endpoints:

* ``POST /predict`` — body: one image (any PIL-decodable format) →
  ``image/png`` mask ({0, 255}); ``503`` + JSON with ``Retry-After``
  when shed or relaunching, ``400`` on an undecodable body. Every answer
  carries ``X-Request-Id``.
* ``GET /healthz`` — readiness: 200 + the bucket/replica inventory,
  ``uptime_s`` and a config fingerprint while serving; 503 +
  ``ready: false`` while the dispatch core relaunches.
* ``GET /livez`` — liveness: 200 while the process answers.
* ``GET /stats`` — the metrics snapshot (serve/server.py ``stats``).

Example:
    python -m distributedpytorch_tpu_torch serve -c singleGPU --port 8008
    curl -s --data-binary @car.jpg localhost:8008/predict > mask.png
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import hashlib
import io
import json
import logging
import sys
import threading
import time
from typing import Optional

logger = logging.getLogger(__name__)


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m distributedpytorch_tpu_torch serve",
        description="Serve mask predictions over HTTP with continuous "
                    "batching on the card",
    )
    parser.add_argument("--checkpoint", "-c", required=True,
                        help="Checkpoint name (e.g. singleGPU) or path: a "
                             "reference-format .pth, the port's .pt, or an "
                             "int8 weights file")
    parser.add_argument("--checkpoint-dir", default="./checkpoints")
    parser.add_argument("--image-size", type=int, nargs=2, default=(960, 640),
                        metavar=("W", "H"))
    parser.add_argument("--model", dest="model_arch", type=str,
                        default="unet", choices=["unet", "milesial"],
                        help="Model family the checkpoint was trained with")
    parser.add_argument("--model-widths", type=int, nargs="+", default=None)
    parser.add_argument("--s2d-levels", type=int, default=-1,
                        help="Accepted for parity; the port always runs the "
                             "(equivalent) pixel path")
    parser.add_argument("--threshold", "-t", type=float, default=0.5)
    parser.add_argument("--quantize", type=str, default=None,
                        choices=["int8"],
                        help="Serve weights-only int8 (per-out-channel "
                             "symmetric, dequantized inside the forward): "
                             "an int8 file from `python -m "
                             "distributedpytorch_tpu_torch quantize` loads "
                             "as it is, a float checkpoint is quantized on "
                             "load. An int8 file is detected without it")
    parser.add_argument("--kernels", type=str, default=None,
                        choices=["torch", "cuda"],
                        help="Kernel policy: cuda ends every bucket forward "
                             "in the serve-mask kernel (uint8 masks come "
                             "back from the card); torch thresholds on the "
                             "host. Default: cuda on a card, torch on CPU")
    parser.add_argument("--kernel-priors", type=str, default=None,
                        help="Per-card probe priors file (python -m "
                             "distributedpytorch_tpu_torch probe): kernels "
                             "the probe rejected disengage loudly "
                             "(default: $DPT_KERNEL_PRIORS)")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default; every visible card) or cpu")
    parser.add_argument("--buckets", type=int, nargs="+", default=(1, 2, 4, 8),
                        help="Padded batch bucket ladder")
    parser.add_argument("--slo-ms", type=float, default=50.0,
                        help="Batching latency SLO: a request waits at most "
                             "this long for its bucket to fill")
    parser.add_argument("--replicas", type=int, default=1,
                        help="Data-parallel replicas, one per card (clamps "
                             "to the cards present)")
    parser.add_argument("--queue-cap", type=int, default=None,
                        help="Pending-image hard cap (default 4x the "
                             "largest bucket); beyond it requests are shed "
                             "with HTTP 503")
    parser.add_argument("--placement-depth", type=int, default=2,
                        help="Buckets stacked+copied ahead of dispatch "
                             "(0 = inline)")
    parser.add_argument("--inflight-per-replica", type=int, default=2,
                        help="Dispatched-but-undrained buckets per replica")
    parser.add_argument("--completion-workers", type=int, default=None)
    parser.add_argument("--host-cache-mb", type=int, default=256,
                        help="SampleCache budget for path-keyed request "
                             "decode (0 = off)")
    parser.add_argument("--no-eager", action="store_true",
                        help="Wait for full buckets or the SLO even when "
                             "replicas are idle")
    parser.add_argument("--restart-limit", type=int, default=3,
                        help="In-process dispatch-core relaunches before "
                             "the worker goes terminal")
    parser.add_argument("--restart-backoff", type=float, default=0.25,
                        help="Base core-relaunch backoff seconds")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8008)
    return parser.parse_args(argv)


def to_config(args):
    """argparse namespace → :class:`ServeConfig`."""
    from distributedpytorch_tpu_torch.config import ServeConfig

    return ServeConfig(
        checkpoint=args.checkpoint,
        checkpoint_dir=args.checkpoint_dir,
        image_size=tuple(args.image_size),
        model_arch=args.model_arch,
        model_widths=tuple(args.model_widths) if args.model_widths else None,
        s2d_levels=args.s2d_levels,
        quantize=args.quantize,
        threshold=args.threshold,
        kernels=args.kernels,
        kernel_priors=args.kernel_priors,
        device=args.device,
        bucket_sizes=tuple(args.buckets),
        slo_ms=args.slo_ms,
        eager_when_idle=not args.no_eager,
        queue_cap_images=args.queue_cap,
        replicas=args.replicas,
        placement_depth=args.placement_depth,
        inflight_per_replica=args.inflight_per_replica,
        completion_workers=args.completion_workers,
        host_cache_mb=args.host_cache_mb,
        restart_limit=args.restart_limit,
        restart_backoff_s=args.restart_backoff,
        host=args.host,
        port=args.port,
    )


def build_server(args):
    """args → a start-able :class:`Server` (the engine builds and warms
    here)."""
    from distributedpytorch_tpu_torch.serve.server import Server

    server = Server.from_config(to_config(args))
    server.engine.warmup()
    return server


def fingerprint(config=None) -> dict:
    """What build + configuration produced this process's numbers."""
    import torch

    from distributedpytorch_tpu_torch import __version__

    fp = {
        "package": "distributedpytorch_tpu_torch",
        "version": __version__,
        "python": sys.version.split()[0],
        "torch": torch.__version__,
    }
    if config is not None:
        blob = json.dumps(dataclasses.asdict(config), sort_keys=True,
                          default=str)
        fp["config_sha"] = hashlib.sha256(blob.encode()).hexdigest()[:12]
    return fp


def make_http_server(server, host: str = "127.0.0.1", port: int = 0,
                     request_timeout_s: float = 30.0):
    """Wrap a started :class:`Server` in a ThreadingHTTPServer (port 0 =
    ephemeral; read the bound port off ``.server_address``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from distributedpytorch_tpu_torch.serve.server import (
        STATUS_REJECTED,
        STATUS_SHUTDOWN,
    )

    started_t = time.monotonic()
    fp = fingerprint(server.config)

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, obj: dict,
                  retry_after: Optional[int] = None,
                  request_id: Optional[str] = None) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if retry_after is not None:
                self.send_header("Retry-After", str(int(retry_after)))
            if request_id:
                self.send_header("X-Request-Id", request_id)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — http.server's contract
            if self.path == "/healthz":
                ready = server.ready
                self._json(200 if ready else 503, {
                    "status": "ok" if ready else "unready",
                    "ready": ready,
                    "uptime_s": round(time.monotonic() - started_t, 3),
                    "fingerprint": fp,
                    "state": server.state,
                    "weights_version": 0,
                    "buckets": list(server.engine.planner.sizes),
                    "replicas": server.engine.num_replicas,
                    "kernels": server.engine.kernel_policy.name,
                    "device": str(server.engine.device),
                }, retry_after=None if ready else 1)
            elif self.path == "/livez":
                self._json(200, {"status": "alive"})
            elif self.path == "/stats":
                self._json(200, server.stats())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            if self.path != "/predict":
                self._json(404, {"error": f"no route {self.path}"})
                return
            from PIL import Image, UnidentifiedImageError

            rid = self.headers.get("X-Request-Id") or None
            try:
                img = Image.open(io.BytesIO(body))
                img.load()
            except (UnidentifiedImageError, OSError, ValueError):
                self._json(400, {"error": "body is not a decodable image"},
                           request_id=rid)
                return
            try:
                response = server.submit(img, request_id=rid).result(
                    timeout=request_timeout_s
                )
            except concurrent.futures.TimeoutError:
                self._json(504, {
                    "status": "error",
                    "reason": f"no result within {request_timeout_s:.0f} s",
                }, request_id=rid)
                return
            rid = response.request_id
            if not response.ok:
                code = (503 if response.status
                        in (STATUS_REJECTED, STATUS_SHUTDOWN) else 500)
                self._json(code, {
                    "status": response.status, "reason": response.reason,
                    "request_id": rid,
                }, retry_after=(
                    server.retry_after_s(response.reason)
                    if code == 503 else None
                ), request_id=rid)
                return
            buf = io.BytesIO()
            Image.fromarray(response.masks[0]).save(buf, format="PNG")
            data = buf.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(data)))
            self.send_header("X-Serve-Latency-Ms",
                             f"{response.latency_ms:.2f}")
            self.send_header("X-Request-Id", rid)
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, fmt, *fmt_args):  # route through logging
            logger.debug("http: " + fmt, *fmt_args)

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> int:
    import signal

    args = get_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    server = build_server(args)
    server.start()
    httpd = make_http_server(server, host=args.host, port=args.port)
    host, port = httpd.server_address[:2]
    logger.info(
        "serving on http://%s:%d (buckets %s, slo %.0f ms, %d replica(s), "
        "kernels %s, %s) — POST /predict, GET /healthz, GET /stats",
        host, port, list(server.engine.planner.sizes), args.slo_ms,
        server.engine.num_replicas, server.engine.kernel_policy.name,
        server.engine.device,
    )
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    sigterm = threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda *_: sigterm.set())
    except ValueError:
        pass  # not the main thread (embedded in a test harness)
    rc = 0
    try:
        from distributedpytorch_tpu_torch.serve.server import STATE_STOPPED

        while server.state != STATE_STOPPED:
            if sigterm.wait(0.5):
                logger.info("SIGTERM: draining queue")
                break
        else:
            logger.error("serve worker terminal (dispatch-core restart "
                         "budget spent)")
            rc = 1
    except KeyboardInterrupt:
        logger.info("shutting down (draining queue)")
    finally:
        httpd.shutdown()
        server.stop(drain=True)
    return rc
