#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serve and train paths once on an NVIDIA
card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card. It
builds the port's kernels from ``distributedpytorch_tpu_torch/csrc``
(one ``nvcc`` per source, all started together) and holds each against
its plain PyTorch version on the card. Then it serves the full-width
UNet (random weights from a seed, saved as a reference-format ``.pth``)
through the serve CLI's own build functions: 24 concurrent requests
through ``Server.submit`` plus ``/healthz`` and ``/stats`` over loopback
HTTP. Then it trains the full-width UNet through the training CLI's own
functions (``--synthetic 40 -b 4 -e 2`` at 960 x 640, bf16, kernels
cuda), serves the weights it wrote, and holds one train step under
kernels cuda against kernels torch. Then it trains the full-width
milesial UNet (31M parameters, BatchNorm) through the same CLI with
``--model milesial --wgrad-taps --kernels cuda`` under
``DPT_WGRAD_BACKEND=pallas`` (``--synthetic 20 -b 4 -e 1``), which runs
the BatchNorm + ReLU epilogue kernels and the 9-tap weight-gradient
kernel, serves its weights, and holds one milesial step under kernels
cuda against kernels torch. Each path's kernel launches are counted from
zero over its run. It fails (non-zero exit, no result line)
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
import logging
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
BF16_OPS_PER_S = 989e12  # dense, tensor cores
# from_logits masks may differ only where the sigmoid lies this close to
# the threshold (__expf vs torch.sigmoid, a few ulp)
LOGIT_BAND = 1e-6
# served bf16 masks vs the host threshold of the torch policy: cuDNN may
# pick another algorithm per bucket shape, so pixels this close to the
# threshold may flip
SERVE_BAND = 1e-3
# the train/eval batch of the reference run (-b 4 at 960 x 640)
TRAIN_BATCH = 4
# float32 minimum normal: below it a log's argument counts as saturated
LOG_SAFE_MIN = 1.1754944e-38
# K1's float sums against torch.sum: both float32, summed in other orders
STATS_RTOL = 1e-5
# K1-bwd against its plain version, relative to the largest gradient
GRAD_RTOL = 1e-6
# the train phase: --synthetic 40 -v 20 -b 4 -e 2 → 32 train and 8 val
# samples, 16 steps and 4 eval batches
TRAIN_SAMPLES = 40
TRAIN_EPOCHS = 2
# a bf16 step's weight gradients, kernels cuda vs torch, relative to each
# tensor's largest: the two losses' output gradients differ by float32
# rounding, which flips a few bf16 roundings of the output gradient, and
# cuDNN's weight-gradient sums need not be run-to-run identical
STEP_GRAD_RTOL = 1e-3
# the milesial phases: --synthetic 20 -v 20 -b 4 -e 1 → 16 train and 4 val
# samples, 4 steps and 1 eval batch; 31,037,698 params less the 65 of a
# 2-class head
MILESIAL_SAMPLES = 20
MILESIAL_PARAMS = 31_037_633
# one full-width milesial step, kernels cuda vs torch. Every BatchNorm
# computes its affine in another association (x·a + b against
# (x − mean)·(inv·scale) + bias), so outputs differ in their last float32
# bits and a pixel with z within rounding of 0 may fall on the other side
# of the ReLU. A random-init milesial step amplifies such differences:
# bf16 roundings flip and the BatchNorms' backward cancels large terms,
# most of all in bf16 (the phase measures, beside the comparison, how far
# a bf16 ulp on ~1 % of the input values moves the plain path's own bf16
# gradients). So each gradient is held by its relative L2 error, loosely
# in bf16; the loss and the running statistics average over millions of
# pixels.
# the same kernels-cuda bf16 step with every kernel swapped for its plain
# version on the card: K2 equals its plain version bit for bit, so the
# forward and the running statistics are identical; K1's, K3's and K5's
# sums run in other orders, which moves the loss in its last bits and a
# few gradient elements across a bf16 rounding. A tensor whose gradient
# nearly cancels carries that as a larger relative error: the bias of an
# upconv in front of a conv and a BatchNorm, which the BatchNorm's shift
# invariance leaves with only its border terms (2.9 % relative L2 for
# up1.up.bias, against a 0.16 % median, in the first such run on an H100)
IN_PLACE_LOSS_RTOL = 1e-6
IN_PLACE_GRAD_GLOBAL_REL_L2 = 1e-2
IN_PLACE_GRAD_REL_L2 = 5e-2
MILESIAL_PARITY = {
    "bf16": {"loss": 1e-4, "grad_rel_l2": 0.5, "stats": 1e-2},
    "f32": {"loss": 1e-5, "grad_rel_l2": 2e-2, "stats": 1e-4},
}
# K3's channel sums against torch.sum, relative to each row's largest:
# float32 sums of up to 2.46 M terms in two orders
BN_SUMS_RTOL = 1e-5
# K5 against its plain version (float32 sums of exact bf16 products over
# up to 614,400 pixels, in two orders), relative to the largest element
WGRAD_RTOL = 1e-4
# K5 against cuDNN's weight gradient, which rounds its result to bf16
# (2^-9 relative) and sums in its own order
WGRAD_LIB_RTOL = 1e-2


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


def _loss_inputs(shape, gen, dev):
    """p with exact 0.0 / 1.0 pixels, pixels at 0.5 and just below it and
    subnormal ones; t in {0, 1, 255} (255 counts as 0)."""
    import torch

    p = torch.rand(shape, generator=gen, device=dev)
    flat = p.view(-1)
    below_half = float(torch.nextafter(torch.tensor(0.5), torch.tensor(0.0)))
    for start, value in ((0, 0.0), (1, 1.0), (2, 0.5), (3, below_half),
                         (4, 1e-40), (5, 1e-45), (6, 1.1754942e-38)):
        flat[start::11] = value
    t = torch.randint(0, 3, shape, generator=gen, device=dev).float()
    t[t == 2] = 255.0
    return p, t


def phase_loss_kernels() -> dict:
    """K1 and K1-bwd against their plain versions at the train/eval shape
    and one ragged size, then timed at the train/eval shape."""
    import torch

    from distributedpytorch_tpu_torch.ops import loss_kernels as lk

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    w, h = IMAGE_WH
    cases = []
    stats_err = grad_err = 0.0
    for shape in ((TRAIN_BATCH, h, w, 1), (3, 17, 29, 1)):
        p, t = _loss_inputs(shape, gen, dev)
        got = lk.eval_stats(p, t)
        again = lk.eval_stats(p, t)
        want = lk.eval_stats_reference(p, t)
        ct = torch.randn(4, generator=gen, device=dev)
        grad = lk.stats_bwd(p, t, ct)
        grad_want = lk.stats_bwd_reference(p, t, ct)
        # BCE part only: exactly zero wherever the log saturates
        bce_only = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
        grad_bce = lk.stats_bwd(p, t, bce_only)
        tb = t == 1
        saturated = (tb & (p < LOG_SAFE_MIN)) | (~tb & (1.0 - p < LOG_SAFE_MIN))
        torch.cuda.synchronize()
        soft = [0, 2, 3]
        rel = ((got[soft] - want[soft]).abs() / want[soft].abs()).max()
        # the kernel rounds the gradient's products and sums where the
        # plain version does (no fma contraction), so the bound is slack
        scale = float(grad_want.abs().max())
        g_err = float((grad - grad_want).abs().max())
        case = {
            "shape": list(shape), "stats": got.tolist(),
            "plain_stats": want.tolist(), "soft_max_rel_err": float(rel),
            "grad_max_abs_err": g_err, "grad_scale": scale,
            "saturated_pixels": int(saturated.sum()),
        }
        cases.append(case)
        stats_err = max(stats_err, float((got - want).abs().max()))
        grad_err = max(grad_err, g_err)
        check(float(rel) <= STATS_RTOL,
              f"loss stats: soft sums off by rel {float(rel)} at {shape}")
        check(torch.equal(got[[1, 4, 5]], want[[1, 4, 5]]),
              f"loss stats: count or hard sums differ at {shape}: "
              f"{got.tolist()} vs {want.tolist()}")
        check(torch.equal(got, again),
              f"loss stats: two calls differ at {shape}")
        check(g_err <= GRAD_RTOL * scale,
              f"loss stats backward: off by {g_err} (scale {scale}) at "
              f"{shape}")
        check(bool(torch.isfinite(grad).all()),
              f"loss stats backward: non-finite gradient at {shape}")
        check(int(saturated.sum()) > 0 and not grad_bce[saturated].any(),
              f"loss stats backward: BCE gradient not zero at saturated "
              f"pixels at {shape}")
    # time at the train/eval shape over 4 inputs (79 MB, more than the
    # 50 MB L2), as the forward's freshly written output is not all
    # L2-resident either
    shape = (TRAIN_BATCH, h, w, 1)
    inputs = [_loss_inputs(shape, gen, dev) for _ in range(4)]
    ct = torch.randn(4, generator=gen, device=dev)
    turn = {"i": 0}

    def nxt():
        turn["i"] = (turn["i"] + 1) % len(inputs)
        return inputs[turn["i"]]

    stats_ms = cuda_ms(lambda: lk.eval_stats(*nxt()), 100, hold=True)
    stats_plain_ms = cuda_ms(lambda: lk.eval_stats_reference(*nxt()), 30,
                             hold=True)
    bwd_ms = cuda_ms(lambda: lk.stats_bwd(*nxt(), ct), 100, hold=True)
    bwd_plain_ms = cuda_ms(lambda: lk.stats_bwd_reference(*nxt(), ct), 30,
                           hold=True)
    n = inputs[0][0].numel()
    # each input read once, each output written once
    stats_bytes = 8 * n + 6 * 4
    bwd_bytes = 8 * n + 4 * 4 + 4 * n
    # float32 operations per element, outside the tensor cores: K1 a log,
    # a max, two compares and three adds; K1-bwd two divides, two maxes,
    # two compares, two multiplies and two adds
    stats_bound_s = max(stats_bytes / HBM_BYTES_PER_S, 8 * n / F32_OPS_PER_S)
    bwd_bound_s = max(bwd_bytes / HBM_BYTES_PER_S, 10 * n / F32_OPS_PER_S)
    result = {
        "phase": "loss_kernels", "cases": cases,
        "stats_max_abs_err": stats_err, "grad_max_abs_err": grad_err,
        "timed_shape": list(shape),
        "stats_ms": stats_ms, "stats_plain_ms": stats_plain_ms,
        "stats_bytes": stats_bytes, "stats_bound_ms": stats_bound_s * 1e3,
        "bwd_ms": bwd_ms, "bwd_plain_ms": bwd_plain_ms,
        "bwd_bytes": bwd_bytes, "bwd_bound_ms": bwd_bound_s * 1e3,
    }
    emit(result)
    return result


def _rotating(inputs):
    """A function returning the next of ``inputs`` on each call, so timed
    calls do not find their input in the 50 MB L2."""
    turn = {"i": 0}

    def nxt():
        turn["i"] = (turn["i"] + 1) % len(inputs)
        return inputs[turn["i"]]

    return nxt


def _bn_inputs(shape, gen, dev, dtype):
    """NCHW x (``dtype``, channels_last) with two channels whose
    z = x·a + b is exactly 0 at some pixels (a = b = 0 on channel 0;
    b = 0 and x = 0 on channel 1), and the channel operands a, b, mean,
    float32."""
    import torch

    b, c, h, w = shape
    x = torch.randn((b, h, w, c), generator=gen, device=dev).to(
        dtype).permute(0, 3, 1, 2)
    x[:, 1].reshape(-1)[::3] = 0.0
    a = torch.rand(c, generator=gen, device=dev) + 0.5
    bias = 0.1 * torch.randn(c, generator=gen, device=dev)
    mean = 0.1 * torch.randn(c, generator=gen, device=dev)
    a[0] = 0.0
    bias[0] = 0.0
    bias[1] = 0.0
    return x, a, bias, mean


def phase_bn_act_kernels() -> dict:
    """K2 and K3 against their plain versions at milesial's largest
    epilogue (4 x 64 x 640 x 960) with a float32 x (what training feeds
    them: the widening its statistics read) and a bf16 x (eval and
    serve), and at a ragged 3 x 1024 x 17 x 29 (R = 1,479 rows, a
    multiple of no block), z = 0 pixels included; then both timed at the
    largest shape with either x."""
    import torch

    from distributedpytorch_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    w, h = IMAGE_WH
    big = (TRAIN_BATCH, 64, h, w)
    cases = []
    fwd_err = dx_err = 0.0
    sums_rel = 0.0
    for shape, dtype in ((big, torch.float32), (big, torch.bfloat16),
                         ((3, 1024, 17, 29), torch.bfloat16)):
        x, a, b, mean = _bn_inputs(shape, gen, dev, dtype)
        g = torch.randn(x.shape, generator=gen, device=dev).contiguous(
            memory_format=torch.channels_last)
        y = kernels.bn_act(x, a, b)
        y_want = kernels.bn_act_reference(x, a, b)
        dx, sums = kernels.bn_act_bwd(x, g, a, b, mean)
        dx2, sums2 = kernels.bn_act_bwd(x, g, a, b, mean)
        dx_want, sums_want = kernels.bn_act_bwd_reference(x, g, a, b, mean)
        zeros = int(((x.float() * a.view(1, -1, 1, 1)
                      + b.view(1, -1, 1, 1)) == 0).sum())
        torch.cuda.synchronize()
        f_err = float((y - y_want).abs().max())
        d_err = float((dx.float() - dx_want.float()).abs().max())
        scale = sums_want.abs().amax(dim=1, keepdim=True)
        s_rel = float(((sums - sums_want).abs() / scale).max())
        what = f"{list(shape)} {dtype}"
        cases.append({"shape": list(shape), "x_dtype": str(dtype),
                      "fwd_max_abs_err": f_err, "dx_max_abs_err": d_err,
                      "sums_max_err_rel_to_row_max": s_rel,
                      "z_zero_pixels": zeros})
        fwd_err = max(fwd_err, f_err)
        dx_err = max(dx_err, d_err)
        sums_rel = max(sums_rel, s_rel)
        check(zeros > 0, f"bn_act: no z = 0 pixel at {what}")
        check(torch.equal(y, y_want),
              f"bn_act differs from its plain version at {what}")
        check(dx.dtype == dtype and torch.equal(dx, dx_want),
              f"bn_act_bwd dx differs from its plain version at {what}")
        check(torch.equal(dx, dx2) and torch.equal(sums, sums2),
              f"bn_act_bwd: two calls differ at {what}")
        check(s_rel <= BN_SUMS_RTOL,
              f"bn_act_bwd sums off by {s_rel} of the row's largest at "
              f"{what}")
    result = {"phase": "bn_act_kernels", "cases": cases,
              "fwd_max_abs_err": fwd_err, "dx_max_abs_err": dx_err,
              "sums_max_err_rel_to_row_max": sums_rel,
              "timed_shape": list(big)}
    b_, c, hh, ww = big
    n = b_ * c * hh * ww
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        inputs = [_bn_inputs(big, gen, dev, dtype) for _ in range(2)]
        grads = [torch.randn(big, generator=gen, device=dev).contiguous(
            memory_format=torch.channels_last) for _ in range(2)]
        nxt = _rotating(inputs)
        nxt_g = _rotating(grads)
        a, b, mean = inputs[0][1:]
        fwd_ms = cuda_ms(lambda: kernels.bn_act(nxt()[0], a, b), 20,
                         hold=True)
        fwd_plain_ms = cuda_ms(
            lambda: kernels.bn_act_reference(nxt()[0], a, b), 10, hold=True)
        bwd_ms = cuda_ms(
            lambda: kernels.bn_act_bwd(nxt()[0], nxt_g(), a, b, mean), 20,
            hold=True)
        bwd_plain_ms = cuda_ms(
            lambda: kernels.bn_act_bwd_reference(nxt()[0], nxt_g(), a, b,
                                                 mean), 10, hold=True)
        xb = inputs[0][0].element_size()
        # each input read once, each output written once: K2 x, y f32 and
        # the [a, b] rows; K3 x, g f32, dx in x's dtype, [a, b, mean] and
        # the two sums
        fwd_bytes = n * (xb + 4) + 2 * c * 4
        bwd_bytes = n * (xb + 4 + xb) + 3 * c * 4 + 2 * c * 4
        # float32 operations per element: K2 a multiply, an add and a max;
        # K3 a multiply, an add, a compare, a select, a multiply, a
        # subtract, a multiply and two adds into the sums
        fwd_bound_s = max(fwd_bytes / HBM_BYTES_PER_S, 3 * n / F32_OPS_PER_S)
        bwd_bound_s = max(bwd_bytes / HBM_BYTES_PER_S, 9 * n / F32_OPS_PER_S)
        result[tag] = {
            "fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain_ms,
            "fwd_bytes": fwd_bytes, "fwd_bound_ms": fwd_bound_s * 1e3,
            "bwd_ms": bwd_ms, "bwd_plain_ms": bwd_plain_ms,
            "bwd_bytes": bwd_bytes, "bwd_bound_ms": bwd_bound_s * 1e3,
        }
        del inputs, grads
    emit(result)
    return result


def phase_wgrad() -> dict:
    """K5 against its plain version and cuDNN's weight gradient
    (``torch.nn.grad.conv2d_weight``) at milesial's two engaged extremes,
    128 -> 128 on 4 x 320 x 480 and 1024 -> 1024 on 4 x 40 x 60, at
    128 -> 128 on 4 x 160 x 240, and at a ragged 144 -> 128 on 2 x 9 x 37
    (bf16), plus a small float32 case; two calls bitwise equal; K5, the
    plain version and cuDNN timed at the first three."""
    import torch

    from distributedpytorch_tpu_torch.ops import wgrad_kernels as wk

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    timed = ((TRAIN_BATCH, 320, 480, 128, 128),
             (TRAIN_BATCH, 40, 60, 1024, 1024),
             (TRAIN_BATCH, 160, 240, 128, 128))
    checked = timed + ((2, 9, 37, 144, 128), (1, 6, 35, 24, 40))
    cases = []
    worst = worst_lib = 0.0

    def inputs(b, h, w, cin, cout, dtype):
        x = torch.randn((b, h, w, cin), generator=gen, device=dev)
        dy = torch.randn((b, h, w, cout), generator=gen, device=dev)
        return x.to(dtype), dy.to(dtype)

    for i, (b, h, w, cin, cout) in enumerate(checked):
        dtype = torch.float32 if i == len(checked) - 1 else torch.bfloat16
        x, dy = inputs(b, h, w, cin, cout, dtype)
        got = wk.wgrad_9tap(x, dy)
        again = wk.wgrad_9tap(x, dy)
        want = wk.wgrad_9tap_reference(x, dy)
        lib = torch.nn.grad.conv2d_weight(
            x.permute(0, 3, 1, 2), (cout, cin, 3, 3), dy.permute(0, 3, 1, 2),
            padding=1).float().permute(2, 3, 1, 0)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = float((got - want).abs().max()) / scale
        lib_err = float((got - lib).abs().max()) / scale
        cases.append({"shape": [b, h, w, cin, cout], "dtype": str(dtype),
                      "max_abs_err": float((got - want).abs().max()),
                      "err_rel_to_max": err,
                      "cudnn_err_rel_to_max": lib_err})
        worst = max(worst, err)
        worst_lib = max(worst_lib, lib_err)
        check(torch.equal(got, again),
              f"wgrad_9tap: two calls differ at {cases[-1]['shape']}")
        check(err <= WGRAD_RTOL,
              f"wgrad_9tap off its plain version by {err} of the largest "
              f"at {cases[-1]['shape']}")
        check(lib_err <= WGRAD_LIB_RTOL,
              f"wgrad_9tap off cuDNN by {lib_err} of the largest at "
              f"{cases[-1]['shape']}")
    timings = []
    for b, h, w, cin, cout in timed:
        sets = [inputs(b, h, w, cin, cout, torch.bfloat16) for _ in range(2)]
        nxt = _rotating(sets)
        nxt_lib = _rotating([(x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2))
                             for x, dy in sets])
        ms = cuda_ms(lambda: wk.wgrad_9tap(*nxt()), 10, hold=True)
        plain_ms = cuda_ms(lambda: wk.wgrad_9tap_reference(*nxt()), 5,
                           hold=True)
        def cudnn(pair, cin=cin, cout=cout):
            return torch.nn.grad.conv2d_weight(
                pair[0], (cout, cin, 3, 3), pair[1], padding=1)

        lib_ms = cuda_ms(lambda: cudnn(nxt_lib()), 10, hold=True)
        pixels = b * h * w
        flops = 2 * 9 * pixels * cin * cout
        nbytes = pixels * (cin + cout) * 2 + 9 * cin * cout * 4
        bound_s = max(nbytes / HBM_BYTES_PER_S, flops / BF16_OPS_PER_S)
        timings.append({
            "shape": [b, h, w, cin, cout], "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bytes": nbytes, "flops": flops,
            "bound_ms": bound_s * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         > flops / BF16_OPS_PER_S else "operations"),
            "tflops": flops / (ms * 1e-3) / 1e12,
        })
    # the einsum backend (the plain version) where the milesial path keeps
    # it: the five convs with a side under 128 channels
    einsum_ms = {}
    for b, h, w, cin, cout in ((TRAIN_BATCH, 640, 960, 3, 64),
                               (TRAIN_BATCH, 640, 960, 64, 64),
                               (TRAIN_BATCH, 320, 480, 64, 128),
                               (TRAIN_BATCH, 640, 960, 128, 64)):
        x, dy = inputs(b, h, w, cin, cout, torch.bfloat16)
        einsum_ms[f"{cin}x{cout}_{b}x{h}x{w}"] = cuda_ms(
            lambda: wk.wgrad_9tap_reference(x, dy), 3, warmup=1)
        del x, dy
    result = {"phase": "wgrad", "cases": cases, "max_err_rel_to_max": worst,
              "cudnn_max_err_rel_to_max": worst_lib, "timings": timings,
              "einsum_backend_ms": einsum_ms}
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

    replica = engine.replicas[0]
    h, w = engine.input_hw
    forward_ms = {}
    for b in BUCKETS:
        placed = engine.place(replica, np.zeros((b, h, w, 3), np.float32))
        placed.ready.synchronize()
        fn = replica.compiled[b]
        forward_ms[str(b)] = cuda_ms(lambda: fn(placed.x), 10, warmup=2)
    top = _top_kernels(lambda: fn(placed.x), 3)
    result = {
        "phase": "profile", "forward_ms": forward_ms,
        "profiled_bucket": max(BUCKETS),
        "device_ms_per_forward": sum(ms for _, ms in top),
        "top_kernels_ms": top[:8],
    }
    emit(result)
    return result


def _top_kernels(fn, runs: int, width: int = 80, by_op: bool = False
                 ) -> list:
    """``[[name, device ms per run], ...]`` of the kernels ``fn`` launches,
    largest first, by the profiler's device clock over ``runs`` calls;
    with ``by_op``, of the PyTorch operators that launched them (each
    operator's own kernels, its children's excluded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    want = (torch.autograd.DeviceType.CPU if by_op
            else torch.autograd.DeviceType.CUDA)
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != want:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / runs / 1e3, evt.key))
    rows.sort(reverse=True)
    return [[name[:width], ms] for ms, name in rows]


def phase_train(tmp: str) -> dict:
    """The port's training path through the CLI's own functions: the
    full-width UNet, bf16, kernels cuda, 32 train and 8 val samples at
    960 x 640, two epochs; the loss kernels' launches counted over that
    run, then the artifacts, the final weights served, and the steady
    step timed."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch import cli
    from distributedpytorch_tpu_torch.models.unet import param_count
    from distributedpytorch_tpu_torch.ops import kernels
    from distributedpytorch_tpu_torch.serve.engine import (
        engine_from_checkpoint,
    )

    run = os.path.join(tmp, "train")
    os.makedirs(run)
    w, h = IMAGE_WH
    ckpt_dir = os.path.join(run, "checkpoints")
    argv = ["-t", "singleGPU", "--synthetic", str(TRAIN_SAMPLES),
            "-v", "20", "-b", str(TRAIN_BATCH), "-e", str(TRAIN_EPOCHS),
            "--image-size", str(w), str(h), "--dtype", "bf16",
            "--kernels", "cuda", "--checkpoint-dir", ckpt_dir]
    args = cli.get_args(argv)
    cwd = os.getcwd()
    os.chdir(run)  # the reference's ./logs and ./loss land in the run dir
    handlers = cli.configure_logging(cli.to_config(args))
    try:
        trainer = cli.build_trainer(args)
        n_params = param_count(trainer.model)
        check(n_params == UNET_PARAMS, f"UNet has {n_params} parameters")
        check(trainer.kernels.name == "cuda", "policy is not cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        result = trainer.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        peak_bytes = torch.cuda.max_memory_allocated()
        artifacts = sorted(
            os.path.relpath(os.path.join(d, f), run)
            for d, _, files in os.walk(run) for f in files
        )
    finally:
        root = logging.getLogger()
        for handler in handlers:
            root.removeHandler(handler)
            handler.close()
        os.chdir(cwd)
    steps = result["steps"]
    eval_batches = TRAIN_EPOCHS * len(trainer.val_loader)
    losses = [float(x) for x in trainer.records.losses]
    check(steps == TRAIN_EPOCHS * len(trainer.train_loader) == 16,
          f"{steps} train steps")
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"non-finite train loss: {losses}")
    check(np.isfinite(result["val_loss"]) and np.isfinite(result["val_dice"]),
          f"val loss {result['val_loss']}, dice {result['val_dice']}")
    check(launches["loss_stats"] == steps + eval_batches,
          f"loss stats kernel launched {launches['loss_stats']} times for "
          f"{steps} steps and {eval_batches} eval batches")
    check(launches["loss_stats_bwd"] == steps,
          f"loss stats backward launched {launches['loss_stats_bwd']} times "
          f"for {steps} steps")
    tables = [a for a in artifacts if a.startswith("loss/singleGPU/")]
    for want in ("logs/singleGPU.log", "checkpoints/singleGPU.pt",
                 "checkpoints/singleGPU.pth"):
        check(want in artifacts, f"missing artifact {want}: {artifacts}")
    check(len(tables) == 3, f"loss tables {tables}")
    engine = engine_from_checkpoint(
        "singleGPU", checkpoint_dir=ckpt_dir, image_size=IMAGE_WH,
        dtype="bf16", bucket_sizes=(1,), kernels="cuda", device="cuda",
    )
    masks = engine.infer(np.zeros((1, h, w, 3), np.float32))
    check(masks.shape == (1, h, w) and masks.dtype == np.uint8,
          f"served mask {masks.shape} {masks.dtype}")

    # the steady step on a placed batch by CUDA events (the card takes
    # longer per step than the host takes to enqueue it), then its
    # kernels by the profiler's clock
    batch = trainer.place_batch(trainer.train_loader.load_slice(
        trainer.train_loader.batch_slices(0)[0]))
    step_ms = cuda_ms(lambda: trainer.train_step(batch), 10, warmup=3)
    top = _top_kernels(lambda: trainer.train_step(batch), 3)
    out = {
        "phase": "train", "params": n_params, "steps": steps,
        "eval_batches": eval_batches, "launches": launches,
        "train_s": train_s, "losses": losses,
        "val_loss": result["val_loss"], "val_dice": result["val_dice"],
        "run_imgs_per_s": result["images_per_second"],
        "step_ms": step_ms, "step_imgs_per_s": TRAIN_BATCH / step_ms * 1e3,
        "peak_mem_bytes": peak_bytes, "artifacts": artifacts,
        "device_ms_per_step": sum(ms for _, ms in top),
        "top_kernels_ms": top[:10],
        "loss_kernels_ms_per_step": sum(
            ms for name, ms in top if "stats" in name),
        "device": torch.cuda.get_device_name(0),
    }
    emit(out)
    return out


def phase_train_parity() -> dict:
    """One full-width bf16 train step from the same weights and batch
    under kernels cuda and torch: the loss within STATS_RTOL and every
    weight gradient within STEP_GRAD_RTOL of its tensor's largest."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.data.dataset import (
        SyntheticSegmentationDataset,
    )
    from distributedpytorch_tpu_torch.models.unet import UNet
    from distributedpytorch_tpu_torch.train.steps import make_train_step

    dev = torch.device("cuda", 0)
    data = SyntheticSegmentationDataset(TRAIN_BATCH, IMAGE_WH, seed=SEED)
    items = [data[i] for i in range(TRAIN_BATCH)]
    batch = {k: torch.from_numpy(np.stack([it[k] for it in items])).to(dev)
             for k in ("image", "mask")}
    init = UNet(generator=torch.Generator().manual_seed(SEED)).state_dict()
    losses, grads = {}, {}
    for fused in (True, False):
        model = UNet(dtype=torch.bfloat16)
        model.load_state_dict(init)
        model.to(dev)
        # lr 0: the step's update leaves the weights; the grads stay
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        step = make_train_step(model, opt, TRAIN_BATCH,
                               train_loss_fused=fused)
        losses[fused] = float(step(batch))
        grads[fused] = {n: p.grad.float().clone()
                        for n, p in model.named_parameters()}
    rel_loss = abs(losses[True] - losses[False]) / abs(losses[False])
    worst = max(
        float((grads[True][n] - g).abs().max() / g.abs().max())
        for n, g in grads[False].items()
    )
    out = {"phase": "train_parity", "loss_cuda": losses[True],
           "loss_torch": losses[False], "loss_rel_err": rel_loss,
           "grad_max_err_rel_to_tensor_max": worst}
    emit(out)
    check(rel_loss <= STATS_RTOL, f"train loss cuda vs torch: rel {rel_loss}")
    check(worst <= STEP_GRAD_RTOL,
          f"train grads cuda vs torch: {worst} of a tensor's largest")
    return out


def phase_train_milesial(tmp: str) -> dict:
    """The milesial path through the training CLI's own functions:
    ``--model milesial --wgrad-taps --kernels cuda --dtype bf16
    --synthetic 20 -v 20 -b 4 -e 1`` at 960 x 640 under
    DPT_WGRAD_BACKEND=pallas (16 train and 4 val samples: 4 steps, 1 eval
    batch). Counts K2, K3 and K5 over the run, checks the running
    statistics moved, serves the .pth it wrote, then times the steady
    step."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch import cli
    from distributedpytorch_tpu_torch.models.milesial import BatchNormAct
    from distributedpytorch_tpu_torch.models.unet import param_count
    from distributedpytorch_tpu_torch.ops import kernels
    from distributedpytorch_tpu_torch.serve.engine import (
        engine_from_checkpoint,
    )

    run = os.path.join(tmp, "train_milesial")
    os.makedirs(run)
    w, h = IMAGE_WH
    ckpt_dir = os.path.join(run, "checkpoints")
    argv = ["-t", "singleGPU", "--model", "milesial", "--wgrad-taps",
            "--kernels", "cuda", "--dtype", "bf16",
            "--synthetic", str(MILESIAL_SAMPLES), "-v", "20",
            "-b", str(TRAIN_BATCH), "-e", "1",
            "--image-size", str(w), str(h), "--checkpoint-dir", ckpt_dir]
    args = cli.get_args(argv)
    saved_backend = os.environ.get("DPT_WGRAD_BACKEND")
    os.environ["DPT_WGRAD_BACKEND"] = "pallas"
    cwd = os.getcwd()
    os.chdir(run)
    handlers = cli.configure_logging(cli.to_config(args))
    try:
        trainer = cli.build_trainer(args)
        model = trainer.model
        n_params = param_count(model)
        check(n_params == MILESIAL_PARAMS,
              f"milesial has {n_params} parameters")
        check(trainer.kernels.name == "cuda", "policy is not cuda")
        bns = [m for m in model.modules() if isinstance(m, BatchNormAct)]
        check(len(bns) == 18 and all(m.epilogue for m in bns),
              "the BatchNorm epilogue is not engaged on all 18 BatchNorms")
        before = {n: b.clone() for n, b in model.named_buffers()
                  if "running" in n}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        result = trainer.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        peak_bytes = torch.cuda.max_memory_allocated()
        moved = sum(not torch.equal(before[n], b)
                    for n, b in model.named_buffers() if n in before)
        artifacts = sorted(
            os.path.relpath(os.path.join(d, f), run)
            for d, _, files in os.walk(run) for f in files
        )
        kernels.reset_launches()
        engine = engine_from_checkpoint(
            "singleGPU", checkpoint_dir=ckpt_dir, image_size=IMAGE_WH,
            model_arch="milesial", dtype="bf16", bucket_sizes=(1,),
            kernels="cuda", device="cuda",
        )
        masks = engine.infer(np.zeros((1, h, w, 3), np.float32))
        serve_launches = dict(kernels.LAUNCHES)
        batch = trainer.place_batch(trainer.train_loader.load_slice(
            trainer.train_loader.batch_slices(0)[0]))
        step_ms = cuda_ms(lambda: trainer.train_step(batch), 5, warmup=2)
        top = _top_kernels(lambda: trainer.train_step(batch), 2, width=200)
        top_ops = _top_kernels(lambda: trainer.train_step(batch), 2,
                               by_op=True)
    finally:
        if saved_backend is None:
            os.environ.pop("DPT_WGRAD_BACKEND", None)
        else:
            os.environ["DPT_WGRAD_BACKEND"] = saved_backend
        root = logging.getLogger()
        for handler in handlers:
            root.removeHandler(handler)
            handler.close()
        os.chdir(cwd)
    steps = result["steps"]
    eval_batches = len(trainer.val_loader)
    losses = [float(x) for x in trainer.records.losses]
    check(steps == len(trainer.train_loader) == 4 and eval_batches == 1,
          f"{steps} train steps, {eval_batches} eval batches")
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"non-finite train loss: {losses}")
    check(np.isfinite(result["val_loss"]) and np.isfinite(result["val_dice"]),
          f"val loss {result['val_loss']}, dice {result['val_dice']}")
    want = {
        "bn_act": 18 * (steps + eval_batches),
        "bn_act_bwd": 18 * steps,
        "wgrad_9tap": 13 * steps,
        "loss_stats": steps + eval_batches,
        "loss_stats_bwd": steps,
    }
    for name, count in want.items():
        check(launches[name] == count,
              f"{name} launched {launches[name]} times, expected {count}")
    check(moved == 36, f"{moved} of 36 running statistics moved")
    for need in ("logs/singleGPU.log", "checkpoints/singleGPU.pt",
                 "checkpoints/singleGPU.pth"):
        check(need in artifacts, f"missing artifact {need}: {artifacts}")
    check(masks.shape == (1, h, w) and masks.dtype == np.uint8,
          f"served mask {masks.shape} {masks.dtype}")
    check(serve_launches["bn_act"] == 18 and serve_launches["serve_mask"] == 1,
          f"serving the milesial .pth launched {serve_launches}")

    def share(word):
        return sum(ms for name, ms in top if word in name)

    out = {
        "phase": "train_milesial", "params": n_params, "steps": steps,
        "eval_batches": eval_batches, "launches": launches,
        "serve_launches": serve_launches, "running_stats_moved": moved,
        "train_s": train_s, "losses": losses,
        "val_loss": result["val_loss"], "val_dice": result["val_dice"],
        "step_ms": step_ms, "step_imgs_per_s": TRAIN_BATCH / step_ms * 1e3,
        "peak_mem_bytes": peak_bytes, "artifacts": artifacts,
        "device_ms_per_step": sum(ms for _, ms in top),
        "bn_act_kernels_ms_per_step": share("bn_act"),
        "wgrad_kernel_ms_per_step": share("wgrad_bf16"),
        "top_kernels_ms": top[:12],
        "top_ops_ms": top_ops[:15],
        "device": torch.cuda.get_device_name(0),
    }
    emit(out)
    return out


class _PlainVersions:
    """Within the block, every kernel wrapper of the training path is its
    plain version, also on the card."""

    def __enter__(self):
        from distributedpytorch_tpu_torch.ops import (
            conv_backward,
            fused_loss,
            kernels,
        )
        from distributedpytorch_tpu_torch.ops import loss_kernels as lk
        from distributedpytorch_tpu_torch.ops import wgrad_kernels as wk

        swaps = [
            (kernels, "bn_act", kernels.bn_act_reference),
            (kernels, "bn_act_bwd", kernels.bn_act_bwd_reference),
            (conv_backward, "wgrad_9tap", wk.wgrad_9tap_reference),
            (fused_loss, "bce_dice_stats_kernel",
             lambda p, t: lk.eval_stats_reference(p, t)[:4]),
            (fused_loss, "stats_bwd", lk.stats_bwd_reference),
        ]
        self.saved = [(mod, name, getattr(mod, name))
                      for mod, name, _ in swaps]
        for mod, name, plain in swaps:
            setattr(mod, name, plain)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)
        return False


def phase_train_milesial_parity() -> dict:
    """One full-width milesial train step (``--wgrad-taps``,
    DPT_WGRAD_BACKEND=pallas) from the same weights and batch under
    kernels cuda (K2, K3, K5 and the loss kernels) and torch, in bf16 (the
    path's policy) and in float32: the loss, every weight gradient (by its
    relative L2 error) and the updated running statistics within the
    MILESIAL_* tolerances. The bf16 step also runs kernels torch on the
    batch with ~1% of its input values moved by a bf16 ulp or two, and
    reports how far that alone moves the gradients: the yardstick of the
    bf16 tolerance."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.data.dataset import (
        SyntheticSegmentationDataset,
    )
    from distributedpytorch_tpu_torch.models import create_model
    from distributedpytorch_tpu_torch.ops import kernels
    from distributedpytorch_tpu_torch.train.steps import make_train_step

    dev = torch.device("cuda", 0)
    data = SyntheticSegmentationDataset(TRAIN_BATCH, IMAGE_WH, seed=SEED)
    items = [data[i] for i in range(TRAIN_BATCH)]
    batch = {k: torch.from_numpy(np.stack([it[k] for it in items])).to(dev)
             for k in ("image", "mask")}
    nudged = dict(batch, image=batch["image"].clone())
    nudged["image"].view(-1)[::97] *= 1.0 + 2.0 ** -7
    init = create_model(
        TrainConfig(model_arch="milesial", device="cpu"),
        generator=torch.Generator().manual_seed(SEED)).state_dict()

    def step(policy, dtype, data):
        cfg = TrainConfig(model_arch="milesial", wgrad_taps=True,
                          kernels=policy, dtype=dtype, device="cuda")
        model = create_model(cfg)
        model.load_state_dict(init)
        model.to(dev)
        # lr 0: the step's update leaves the weights; the grads stay
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        kernels.reset_launches()
        loss = float(make_train_step(model, opt, TRAIN_BATCH,
                                     train_loss_fused=policy == "cuda")(data))
        return {"loss": loss, "launches": dict(kernels.LAUNCHES),
                "grads": {n: p.grad.float().clone()
                          for n, p in model.named_parameters()},
                "stats": {n: b.clone() for n, b in model.named_buffers()
                          if "running" in n}}

    def compare(a, b):
        rel_l2 = {n: float((a["grads"][n] - g).norm() / g.norm())
                  for n, g in b["grads"].items()}
        diff = torch.cat([(a["grads"][n] - g).flatten()
                          for n, g in b["grads"].items()])
        whole = torch.cat([g.flatten() for g in b["grads"].values()])
        worst = sorted(rel_l2, key=rel_l2.get, reverse=True)[:3]
        return {
            "loss_rel_err": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
            "grad_global_rel_l2": float(diff.norm() / whole.norm()),
            "grad_max_rel_l2": max(rel_l2.values()),
            "grad_median_rel_l2": float(np.median(list(rel_l2.values()))),
            "grad_worst_tensor": worst[0],
            "grad_worst_tensors": [[n, rel_l2[n]] for n in worst],
            "running_stats_max_err_rel_to_tensor_max": max(
                float((a["stats"][n] - t).abs().max() / t.abs().max())
                for n, t in b["stats"].items()),
        }

    saved_backend = os.environ.get("DPT_WGRAD_BACKEND")
    os.environ["DPT_WGRAD_BACKEND"] = "pallas"
    out = {"phase": "train_milesial_parity"}
    try:
        for dtype in ("bf16", "f32"):
            runs = {p: step(p, dtype, batch) for p in ("cuda", "torch")}
            launches = runs["cuda"]["launches"]
            check(launches["bn_act"] == 18 and launches["bn_act_bwd"] == 18
                  and launches["wgrad_9tap"] == 13,
                  f"kernels cuda {dtype} step launched {launches}")
            check(not any(runs["torch"]["launches"].values()),
                  f"kernels torch {dtype} step launched "
                  f"{runs['torch']['launches']}")
            out[dtype] = dict(compare(runs["cuda"], runs["torch"]),
                              loss_cuda=runs["cuda"]["loss"],
                              loss_torch=runs["torch"]["loss"])
            if dtype == "bf16":
                out["bf16_torch_vs_nudged_input"] = compare(
                    step("torch", dtype, nudged), runs["torch"])
                with _PlainVersions():
                    plain = step("cuda", dtype, batch)
                check(not any(plain["launches"].values()),
                      f"plain versions launched {plain['launches']}")
                out["bf16_kernels_vs_plain_versions"] = in_place = compare(
                    runs["cuda"], plain)
                same_stats = all(torch.equal(runs["cuda"]["stats"][n], t)
                                 for n, t in plain["stats"].items())
                in_place["running_stats_bitwise_equal"] = same_stats
                del plain
            del runs
    finally:
        if saved_backend is None:
            os.environ.pop("DPT_WGRAD_BACKEND", None)
        else:
            os.environ["DPT_WGRAD_BACKEND"] = saved_backend
    emit(out)
    in_place = out["bf16_kernels_vs_plain_versions"]
    check(in_place["running_stats_bitwise_equal"]
          and in_place["loss_rel_err"] <= IN_PLACE_LOSS_RTOL
          and in_place["grad_global_rel_l2"] <= IN_PLACE_GRAD_GLOBAL_REL_L2
          and in_place["grad_max_rel_l2"] <= IN_PLACE_GRAD_REL_L2,
          f"milesial bf16 step, kernels vs their plain versions: "
          f"{in_place}")
    for dtype, tol in MILESIAL_PARITY.items():
        got = out[dtype]
        check(got["loss_rel_err"] <= tol["loss"],
              f"milesial {dtype} loss cuda vs torch: rel "
              f"{got['loss_rel_err']}")
        check(got["grad_max_rel_l2"] <= tol["grad_rel_l2"],
              f"milesial {dtype} grads cuda vs torch: relative L2 "
              f"{got['grad_max_rel_l2']} at {got['grad_worst_tensor']}")
        check(got["running_stats_max_err_rel_to_tensor_max"] <= tol["stats"],
              f"milesial {dtype} running stats cuda vs torch: "
              f"{got['running_stats_max_err_rel_to_tensor_max']}")
    return out


def phase_bounds() -> dict:
    """Bounds computed from shapes, not measured: K2 and K3 at milesial's
    largest epilogue (batch 4 at 960 x 640, 64 channels) with a float32 x
    (the training path's, and the JAX kernels' input) and a bf16 x (eval
    and serve), dx in x's dtype; K5 at milesial's engaged extremes and at
    128 -> 128 on 4 x 160 x 240."""
    w, h = IMAGE_WH
    c = 64
    n = TRAIN_BATCH * h * w * c
    nbytes = {
        "K2_f32_x": n * (4 + 4) + 2 * c * 4,
        "K3_f32_x": n * (4 + 4 + 4) + 5 * c * 4,
        "K2_bf16_x": n * (2 + 4) + 2 * c * 4,
        "K3_bf16_x": n * (2 + 4 + 2) + 5 * c * 4,
    }
    bound_ms = {k: v / HBM_BYTES_PER_S * 1e3 for k, v in nbytes.items()}
    for b, hh, ww, cin, cout in ((TRAIN_BATCH, 320, 480, 128, 128),
                                 (TRAIN_BATCH, 40, 60, 1024, 1024),
                                 (TRAIN_BATCH, 160, 240, 128, 128)):
        key = f"K5_{cin}x{cout}_{b}x{hh}x{ww}"
        nbytes[key] = b * hh * ww * (cin + cout) * 2 + 9 * cin * cout * 4
        ops = 2 * 9 * b * hh * ww * cin * cout
        bound_ms[key] = max(nbytes[key] / HBM_BYTES_PER_S,
                            ops / BF16_OPS_PER_S) * 1e3
    out = {"phase": "bounds", "bytes": nbytes, "bound_ms": bound_ms}
    emit(out)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this check runs on the card",
              file=sys.stderr)
        return 1
    device = phase_device()
    kernel = phase_kernel()
    loss = phase_loss_kernels()
    bn = phase_bn_act_kernels()
    wgrad = phase_wgrad()
    with tempfile.TemporaryDirectory() as tmp:
        serve = phase_serve(tmp)
        phase_profile(serve["engine"])
        train = phase_train(tmp)
        milesial = phase_train_milesial(tmp)
    phase_train_parity()
    phase_train_milesial_parity()
    phase_bounds()
    k5 = wgrad["timings"][0]  # 128 -> 128 on 4 x 320 x 480
    source = "distributedpytorch_tpu_torch/csrc/"
    emit({"kernels": [
        {
            "name": "serve_mask",
            "route": "cuda",
            "source": source + "serve_mask.cu",
            "replaces": "distributedpytorch_tpu/ops/kernels.py:519",
            "launches": serve["result"]["launches"]["serve_mask"],
            "max_abs_err": kernel["max_abs_err"],
            "ms": kernel["kernel_ms"],
            "plain_ms": kernel["plain_ms"],
            "bound_ms": kernel["bound_ms"],
            "bound_by": "bytes",
            # no single PyTorch call computes the uint8 {0, 255} mask
            "library_ms": None,
        },
        {
            "name": "loss_stats",
            "route": "cuda",
            "source": source + "loss_stats.cu",
            "replaces": "distributedpytorch_tpu/ops/pallas_kernels.py:55",
            "launches": train["launches"]["loss_stats"],
            "max_abs_err": loss["stats_max_abs_err"],
            "ms": loss["stats_ms"],
            "plain_ms": loss["stats_plain_ms"],
            "bound_ms": loss["stats_bound_ms"],
            "bound_by": "bytes",
            # no single PyTorch call computes the six sums
            "library_ms": None,
        },
        {
            "name": "loss_stats_bwd",
            "route": "cuda",
            "source": source + "loss_stats.cu",
            "replaces": "distributedpytorch_tpu/ops/fused_loss.py:67",
            "launches": train["launches"]["loss_stats_bwd"],
            "max_abs_err": loss["grad_max_abs_err"],
            "ms": loss["bwd_ms"],
            "plain_ms": loss["bwd_plain_ms"],
            "bound_ms": loss["bwd_bound_ms"],
            "bound_by": "bytes",
            # no single PyTorch call computes this gradient
            "library_ms": None,
        },
        {
            "name": "bn_act",
            "route": "cuda",
            "source": source + "bn_act.cu",
            "replaces": "distributedpytorch_tpu/ops/kernels.py:324",
            "launches": milesial["launches"]["bn_act"],
            "max_abs_err": bn["fwd_max_abs_err"],
            # timed with the float32 x of the training path
            "ms": bn["f32"]["fwd_ms"],
            "plain_ms": bn["f32"]["fwd_plain_ms"],
            "bound_ms": bn["f32"]["fwd_bound_ms"],
            "bound_by": "bytes",
            # no single PyTorch call gives relu of the folded affine in
            # float32 from a bf16 x
            "library_ms": None,
        },
        {
            "name": "bn_act_bwd",
            "route": "cuda",
            "source": source + "bn_act.cu",
            "replaces": "distributedpytorch_tpu/ops/kernels.py:333",
            "launches": milesial["launches"]["bn_act_bwd"],
            "max_abs_err": bn["dx_max_abs_err"],
            "ms": bn["f32"]["bwd_ms"],
            "plain_ms": bn["f32"]["bwd_plain_ms"],
            "bound_ms": bn["f32"]["bwd_bound_ms"],
            "bound_by": "bytes",
            # no single PyTorch call gives dx with the two channel sums
            "library_ms": None,
        },
        {
            "name": "wgrad_9tap",
            "route": "cuda",
            "source": source + "wgrad_9tap.cu",
            "replaces": "distributedpytorch_tpu/ops/wgrad_pallas.py:72",
            "launches": milesial["launches"]["wgrad_9tap"],
            "max_abs_err": max(c["max_abs_err"] for c in wgrad["cases"]),
            "ms": k5["ms"],
            "plain_ms": k5["plain_ms"],
            "bound_ms": k5["bound_ms"],
            "bound_by": k5["bound_by"],
            # cuDNN's weight gradient, torch.nn.grad.conv2d_weight
            "library_ms": k5["library_ms"],
        },
    ]})
    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
