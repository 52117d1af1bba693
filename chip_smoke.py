#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serve path once on an NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card. It
builds the port's kernels from ``distributedpytorch_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, then serves
the full-width UNet (random weights from a seed, saved as a
reference-format ``.pth``) through the serve CLI's own build functions: 24
concurrent requests through ``Server.submit`` plus ``/healthz`` and
``/stats`` over loopback HTTP. It fails (non-zero exit, no result line)
without a card, outside a checkout, or when any phase disagrees.

Each phase prints one JSON line. Before the last line come the
``{"kernels": [...]}`` summary and the card's name and power limit as
``nvidia-smi`` reports them; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import http.client
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

SEED = 0
THRESHOLD = 0.5
BUCKETS = (1, 2, 4, 8)
IMAGE_WH = (960, 640)
N_REQUESTS = 24
UNET_PARAMS = 7_760_097
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor-core
# f32 operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# from_logits masks may differ only where the sigmoid lies this close to
# the threshold (__expf vs torch.sigmoid, a few ulp)
LOGIT_BAND = 1e-6
# served bf16 masks vs the host threshold of the torch policy: cuDNN may
# pick another algorithm per bucket shape, so pixels this close to the
# threshold may flip
SERVE_BAND = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, iters: int, warmup: int = 5, hold: bool = False) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by
    CUDA events. With ``hold`` a spin kernel holds the stream while the
    host enqueues every timed call, so the events time the card and not
    the Python that launches a microsecond kernel (the run fails if the
    hold ran out first); keep ``iters`` x kernels per call well inside
    CUDA's queue of pending launches (~1,000) then. Without it, ``fn`` must
    take longer on the card than on the host."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if not hold:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0  # enqueue cost of one call
    torch.cuda.synchronize()
    hold_s = 3 * iters * host_s + 0.01
    torch.cuda._sleep(int(hold_s * 2e9))  # cycles at <= 2 GHz: >= hold_s
    start.record()
    for _ in range(iters):
        fn()
    held = not start.query()  # the card was still spinning
    end.record()
    end.synchronize()
    check(held, "timing hold ran out before the host finished enqueueing")
    return start.elapsed_time(end) / iters


def phase_device() -> dict:
    import torch

    from distributedpytorch_tpu_torch.ops import _build

    # no f32 comparison below may run in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = _build.build()
    info = {
        "phase": "device",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "tf32": False,
        "build_s": round(time.perf_counter() - t0, 3),
        "libraries": sorted(p.name for p in libs.values()),
    }
    emit(info)
    return info


def phase_kernel() -> dict:
    """K4 against its plain version at the serve buckets and one ragged
    size, exact-threshold pixels included, both input kinds."""
    import torch

    from distributedpytorch_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    w, h = IMAGE_WH
    shapes = [(b, h, w) for b in BUCKETS] + [(3, 17, 29)]
    cases = []
    max_err = 0
    for shape in shapes:
        p = torch.rand(shape, generator=gen, device=dev)
        p.view(-1)[::97] = THRESHOLD  # exact-threshold pixels
        got = kernels.sigmoid_threshold_mask(p, THRESHOLD)
        want = kernels.sigmoid_threshold_mask_reference(p, THRESHOLD)
        err = int((got.int() - want.int()).abs().max())
        max_err = max(max_err, err)
        z = torch.randn(shape, generator=gen, device=dev) * 4
        zl = kernels.sigmoid_threshold_mask(z, THRESHOLD, from_logits=True)
        zr = kernels.sigmoid_threshold_mask_reference(z, THRESHOLD,
                                                      from_logits=True)
        flips = zl != zr
        outside = flips & ((torch.sigmoid(z) - THRESHOLD).abs() >= LOGIT_BAND)
        torch.cuda.synchronize()
        cases.append({"shape": list(shape), "prob_max_abs_err": err,
                      "logit_flips": int(flips.sum()),
                      "logit_flips_outside_band": int(outside.sum())})
        check(err == 0, f"serve mask differs from its plain version at "
                        f"{shape}")
        check(int(outside.sum()) == 0,
              f"from_logits mask differs outside the {LOGIT_BAND} band "
              f"at {shape}")
    # time at the largest bucket over 4 inputs (79 MB, more than the
    # 50 MB L2), as the forward's freshly written output is not all
    # L2-resident either
    shape = (max(BUCKETS), h, w)
    inputs = [torch.rand(shape, generator=gen, device=dev) for _ in range(4)]
    turn = {"i": 0}

    def nxt():
        turn["i"] = (turn["i"] + 1) % len(inputs)
        return inputs[turn["i"]]

    kernel_ms = cuda_ms(
        lambda: kernels.sigmoid_threshold_mask(nxt(), THRESHOLD), 100,
        hold=True)
    plain_ms = cuda_ms(
        lambda: kernels.sigmoid_threshold_mask_reference(nxt(), THRESHOLD),
        100, hold=True)
    n = inputs[0].numel()
    bytes_moved = n * 4 + n * 1  # read f32 once, write uint8 once
    bound_s = max(bytes_moved / HBM_BYTES_PER_S, n / F32_OPS_PER_S)
    result = {
        "phase": "kernel", "name": "serve_mask", "cases": cases,
        "max_abs_err": max_err, "timed_shape": list(shape),
        "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_us": bound_s * 1e6, "bound_ms": bound_s * 1e3,
        "bytes": bytes_moved,
    }
    emit(result)
    return result


def phase_serve(tmp: str) -> dict:
    """The port's main path: the serve CLI's build functions, a server
    answering concurrent requests, the kernel's launches counted over
    that run."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.checkpoint import save_pth
    from distributedpytorch_tpu_torch.models.unet import UNet, param_count
    from distributedpytorch_tpu_torch.ops import kernels
    from distributedpytorch_tpu_torch.serve import cli
    from distributedpytorch_tpu_torch.serve.engine import (
        engine_from_checkpoint,
    )
    from distributedpytorch_tpu_torch.serve.infer import postprocess_mask

    model = UNet(generator=torch.Generator().manual_seed(SEED))
    n_params = param_count(model)
    check(n_params == UNET_PARAMS, f"UNet has {n_params} parameters")
    save_pth(model.state_dict(), os.path.join(tmp, "smoke.pth"))
    w, h = IMAGE_WH
    rng = np.random.default_rng(SEED)
    requests = [
        rng.random((int(rng.integers(1, 4)), h, w, 3), dtype=np.float32)
        for _ in range(N_REQUESTS)
    ]
    n_images = sum(r.shape[0] for r in requests)
    argv = ["-c", "smoke", "--checkpoint-dir", tmp,
            "--image-size", str(w), str(h), "--kernels", "cuda",
            "--buckets", *map(str, BUCKETS),
            # admit the whole burst: this run checks answers, not shedding
            "--queue-cap", str(n_images), "--port", "0"]
    t0 = time.perf_counter()
    server = cli.build_server(cli.get_args(argv))  # builds + warms
    startup_s = time.perf_counter() - t0
    check(server.engine.kernel_policy.name == "cuda", "policy is not cuda")
    server.start()
    httpd = None
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            futures = list(pool.map(server.submit, requests))
            responses = [f.result(timeout=600) for f in futures]
        burst_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        stats = server.stats()
        for req, resp in zip(requests, responses):
            check(resp.ok, f"request answered {resp.status}: {resp.reason}")
            check(len(resp.masks) == req.shape[0], "wrong mask count")
            for m in resp.masks:
                check(m.shape == (h, w) and m.dtype == np.uint8,
                      f"mask {m.shape} {m.dtype}")
        check(launches["serve_mask"] > 0,
              "the serve path never launched the serve-mask kernel")
        httpd = cli.make_http_server(server, port=0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        conn = http.client.HTTPConnection("127.0.0.1",
                                          httpd.server_address[1], timeout=60)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        health = json.loads(resp.read())
        check(resp.status == 200 and health["ready"], f"healthz {health}")
        conn.request("GET", "/stats")
        resp = conn.getresponse()
        http_stats = json.loads(resp.read())
        check(resp.status == 200
              and http_stats["requests_ok"] == N_REQUESTS,
              f"stats {http_stats}")
        conn.close()
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        server.stop()

    # served masks vs the host threshold of the torch policy's
    # probabilities on the same rows
    ref = engine_from_checkpoint(
        "smoke", checkpoint_dir=tmp, image_size=IMAGE_WH, dtype="bf16",
        bucket_sizes=BUCKETS, kernels="torch", device="cuda",
    )
    flips = outside = near = pixels = 0
    for req, resp in zip(requests, responses):
        probs = ref.infer(req)
        want = postprocess_mask(probs, THRESHOLD)
        got = np.stack(resp.masks)
        band = np.abs(probs - THRESHOLD) < SERVE_BAND
        diff = got != want
        flips += int(diff.sum())
        outside += int((diff & ~band).sum())
        near += int(band.sum())
        pixels += diff.size
    check(outside == 0, f"{outside} served mask pixels differ outside the "
                        f"{SERVE_BAND} band")
    result = {
        "phase": "serve", "params": n_params, "requests": N_REQUESTS,
        "images": n_images, "all_ok": True,
        "startup_s": startup_s, "burst_s": burst_s,
        "imgs_per_s": n_images / burst_s,
        "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
        "bucket_dispatches": stats["bucket_dispatches"],
        "pad_ratio": stats["pad_ratio"], "launches": launches,
        "mask_flips": flips, "mask_flips_outside_band": outside,
        "pixels_in_band": near, "pixels": pixels,
        "device": torch.cuda.get_device_name(0),
    }
    emit(result)
    return {"result": result, "engine": ref}


def phase_profile(engine) -> dict:
    """Device time of each bucket's forward (torch policy: probabilities
    out), and the kernels that take the largest bucket's time by the
    profiler's device clock."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    replica = engine.replicas[0]
    h, w = engine.input_hw
    forward_ms = {}
    for b in BUCKETS:
        placed = engine.place(replica, np.zeros((b, h, w, 3), np.float32))
        placed.ready.synchronize()
        fn = replica.compiled[b]
        forward_ms[str(b)] = cuda_ms(lambda: fn(placed.x), 10, warmup=2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn(placed.x)
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        # kernels only: a CPU op's device time repeats its kernels'
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 3 / 1e3, evt.key))
    rows.sort(reverse=True)
    result = {
        "phase": "profile", "forward_ms": forward_ms,
        "profiled_bucket": max(BUCKETS),
        "device_ms_per_forward": sum(ms for ms, _ in rows),
        "top_kernels_ms": [[name[:80], ms] for ms, name in rows[:8]],
    }
    emit(result)
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this check runs on the card",
              file=sys.stderr)
        return 1
    device = phase_device()
    kernel = phase_kernel()
    with tempfile.TemporaryDirectory() as tmp:
        serve = phase_serve(tmp)
        phase_profile(serve["engine"])
    emit({"kernels": [{
        "name": "serve_mask",
        "route": "cuda",
        "source": "distributedpytorch_tpu_torch/csrc/serve_mask.cu",
        "replaces": "distributedpytorch_tpu/ops/kernels.py:519",
        "launches": serve["result"]["launches"]["serve_mask"],
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["kernel_ms"],
        "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"],
        "bound_us": kernel["bound_us"],
        "bound_by": "bytes",
        # no single PyTorch call computes the uint8 {0, 255} mask
        "library_ms": None,
    }]})
    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
