#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serve and train paths once on an NVIDIA
card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card. It
builds the port's kernels from ``distributedpytorch_tpu_torch/csrc``
(one ``nvcc`` per source, all started together) and holds each against
its plain PyTorch version on the card. Then it serves the full-width
UNet (random weights from a seed, saved as a reference-format ``.pth``)
through the serve CLI's own build functions, each bucket's forward one
CUDA graph with K4 inside it: 24 concurrent requests through
``Server.submit`` plus ``/healthz`` and ``/stats`` over loopback HTTP,
then the same burst under the profiler, K4 counted per replay
(``serve``); each bucket's graph against its eager forward, bitwise
under cuDNN's deterministic algorithms, with the card's and the host's
time per dispatch, the burst both ways, and one bucket dispatched twice
before either result is drained (``serve_graph``). Then it trains the
full-width UNet through the training CLI's own functions
(``--synthetic 40 -b 4 -e 2`` at 960 x 640, bf16, kernels cuda), serves the weights it wrote, and holds one train step under
kernels cuda against kernels torch. Then it trains the full-width
milesial UNet (31M parameters, BatchNorm) through the same CLI with
``--model milesial --wgrad-taps --kernels cuda`` under
``DPT_WGRAD_BACKEND=pallas`` (``--synthetic 20 -b 4 -e 1``), which runs
the BatchNorm + ReLU epilogue kernels and the 9-tap weight-gradient
kernel, serves its weights, and holds one milesial step under kernels
cuda against kernels torch. Both models' weights then go through the
``quantize`` converter and serve the burst as int8 (``--quantize int8``)
beside their float serving: latency, forward ms per bucket, the
replica's bytes on the card, the probabilities against the float ones,
quantize-on-load against the file, K4 and K2 per replay
(``serve_int8``); ``predict -b 4`` writes masks for ten PNGs from the
UNet's float and int8 weights, held against the server's answers to the
same files (``predict``). ``-t DDP`` runs three ways: the UNet run and
the milesial run again at world 1 under NCCL through the same CLI
functions with torchrun's env set (``train_ddp``, ``train_milesial_ddp``;
the UNet once more as a real ``torchrun --standalone --nproc_per_node 1``
subprocess), and two ranks of the full-width UNet on the one card, two
processes this script spawns (``--ddp-rank R 2 gloo DIR``) over a gloo
group (``train_ddp_gloo2``), held against one world-1 step on the
concatenated batch. ``-t MP`` runs the UNet with both pipeline stages on
the one card under gpipe and then 1f1b through the same CLI functions
(``train_mp``: K1 and K1-bwd per microbatch, peak memory at M = 2 and
M = 8, its ``.pth`` served), milesial likewise for two steps of each
schedule (``train_milesial_mp``: K2, K3 and K5 inside the stages at
launch counts derived from the schedule, and in float32 against their
plain versions in place), ``-t DP`` trains both models on the card
(``train_dp``), then runs on ``[cuda:0, cuda:0]``, two replica threads on
the one card: the bf16 UNet and milesial ``--wgrad-taps`` as one CUDA
graph of 4 steps against their eager steps, bitwise, a replay's kernels
counted by name, step and host ms (``dp_graph``), and milesial under
``--remat`` against the plain DP step, bitwise, with its launches and
peak memory (``dp_remat``); ``-t DDP_MP`` runs as two ranks on the one card, two
processes this script spawns (``--ddp-mp-rank R 2 gloo DIR``) over a gloo
group, each with both of its stages on cuda:0: the bf16 UNet under gpipe
and 1f1b and milesial with ``--wgrad-taps`` under both, held against one
``-t MP`` step on their joint batch and against kernels torch
(``train_ddp_mp_gloo2``). ``-t SP`` runs on ``[cuda:0, cuda:0]``, two
row-shard threads on the one card meeting at every 3x3 conv for their
halo rows: the bf16 UNet and milesial ``--wgrad-taps`` at ``-b 4``, step 1
against a singleGPU step from the same weights in bf16 and float32, K1,
K1-bwd, K2, K3 and K5 per shard counted by name in the trace, the float32
step against its plain versions in place, each kernel against its plain
version on a shard's shapes, the step's ms, host enqueue and idle share
beside one shard and singleGPU, and a short CLI run whose manifest says
``1x2x1@sp`` (``train_sp``); SP's run control there: both models as one
CUDA graph of 4 steps against their eager steps, bitwise, each kernel
counted per replay in the graph's nodes and in the trace, eager against
graph step, host and
idle share; both under ``--remat`` against the plain SP step, bitwise,
with their step memory; the float32 UNet's ``--grad-accum 2`` against
singleGPU's (``sp_run_control``); ``-t DDP_SP`` as two ranks on the one
card, two processes this script spawns (``--ddp-sp-rank R 2 gloo DIR``),
each row-sharding its ``-b 4`` over ``[cuda:0, cuda:0]``: weights bitwise
equal after every step, step 1 against one SP step of the joint batch,
each run again under ``--remat`` bitwise the plain run, and K = 2
refused over gloo (``train_ddp_sp_gloo2``). Then the trainer's run control
(``train_run_control``): the UNet with ``--steps-per-dispatch 4`` (one
CUDA graph of 4 whole steps, K1 and K1-bwd inside it) against the same 16
steps at K = 1, bitwise; milesial and the UNet with ``--remat`` against
the plain step (K2 twice per step); both models under ``--dtype
bf16_params`` against ``--dtype bf16``, K2, K3 and K5 against their plain
versions in place, and the checkpoint resumed under bf16; a NaN loss at a
chosen step under ``skip``, ``rollback`` and ``abort``; and 16 steps with
``--trace-timeline``, async saves, ``--keep-checkpoints 2`` and
``--save-best``, resumed past a corrupted newest checkpoint. Then the CUDA
graph of 4 steps outside singleGPU (``train_graph_strategies``): the UNet
under ``-t DDP`` at world 1 (NCCL) in bf16 and bf16_params, under ``-t
MP`` on ``[cuda:0, cuda:0]`` with gpipe (two epochs, an eval between the
replays, then resumed with ``-c``) and 1f1b, and milesial ``--wgrad-taps``
under MP gpipe, each against K = 1 with the same capturable Adam, bitwise,
a replay's kernels counted by name in the graph's nodes and in the
profiler's trace, step, host enqueue and idle share of both; the gloo DDP_MP ranks check that K = 4
over gloo on a card is refused. Then the slice of the probes, the
profiler window, the checkpoint interchange and the preemption stop:
``ops/probes.run_probes`` on the card, each kernel built, launched in a
child process and held against its plain version, and a priors file
that rejects the BatchNorm epilogue given to a full-width milesial step
through ``--kernel-priors`` (``probes``: K2 and K3 not launched, one
warning); the UNet with ``--profile-steps 2:4`` at K = 1 and K = 2, the
chrome trace holding K1 and K1-bwd by name, the losses bitwise those
without the window, the step timed with and without a profiler
(``profile_window``); a child trainer sent SIGTERM once step 3 has run,
exiting 0 with its checkpoint, resumed here to the end (``preempt``);
full-width milesial states, bf16 and bf16_params, through a JAX-format
``.ckpt`` and back, and resumed onto the card with ``-c``, bitwise
(``ckpt_roundtrip``). Each path's kernel launches are counted
from zero over its run (a CUDA graph's at each replay). It fails
(non-zero exit, no result line) without a card, outside a checkout, or
when any phase disagrees.

    python3 chip_smoke.py --cards 4

runs, after the build, ``-t DDP`` across four cards under NCCL, one
process per card (``ddp_cards``): the same checks as the two gloo ranks,
the bf16 step at world 1 and 4, and a ``torchrun --nproc_per_node 4``
launch of the training CLI; ``-t DDP_MP`` as two NCCL ranks of two cards
each, checked as the gloo ranks are, their step, busy cards and bubble
beside the one-card pipeline, and a ``torchrun --nproc_per_node 2``
launch of the training CLI (``ddp_mp_cards``); ``-t SP`` across the four
cards (the halo rows cross NVLink) against one card, and ``-t DDP_SP`` as
two NCCL ranks of two cards each plus a ``torchrun --nproc_per_node 2``
launch of the training CLI (``sp_cards``), both also as CUDA graphs of 4
steps against their eager steps; then ``-t MP`` across 2
and 4 cards, its step and measured bubble under both schedules at M = 2
and 8 (``mp_cards``), and ``-t DP`` across the four cards against a
one-card step (``dp_cards``). Every one of them also runs its path as
one CUDA graph of 4 steps against its eager steps (``dp_cards``: the
bf16 UNet at batch 16 and milesial at 8, ``dp_graph``): losses and
weights bitwise (the ranks' equal after every stack), a guard tensor on
every card between replays left alone, and both timed (step, host
enqueue, each card's busy time, bubble, ``cudaGraphLaunch``).

    python3 chip_smoke.py --dp-eager-ab OTHER

times the eager ``-t DP`` step of the checkout at ``OTHER`` (a parent
commit unpacked with ``git archive``) and of this one in turns, each in
a process of its own (``dp_eager_step``): the bf16 UNet at batch 16 and
milesial at batch 8 across every visible card, and the UNet at batch 8
on ``[cuda:0, cuda:0]``.

Each phase prints one JSON line. Before the last line come the
``{"kernels": [...]}`` summary (not with ``--cards``) and the card's
name and power limit as ``nvidia-smi`` reports them; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import dataclasses
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
# milesial's convs that engage K5 (both sides >= 128 channels), batch 4 at
# 960 x 640: (H, W, Cin, Cout) and how many of the 13 per step have it
MILESIAL_K5_SHAPES = (
    ((320, 480, 128, 128), 2), ((320, 480, 256, 128), 1),
    ((160, 240, 128, 256), 1), ((160, 240, 256, 256), 2),
    ((160, 240, 512, 256), 1),
    ((80, 120, 256, 512), 1), ((80, 120, 512, 512), 2),
    ((80, 120, 1024, 512), 1),
    ((40, 60, 512, 1024), 1), ((40, 60, 1024, 1024), 1),
)


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
    profiler_tries = _warm_profiler()
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
        "profiler_warm_up_sessions": profiler_tries,
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


#: profiler sessions tried before one that records no device activity
#: for work that surely ran on the card counts as a failure
PROFILER_TRIES = 3


def _profiled_kernels(fn) -> list:
    """Names of the kernels the card ran during one call of ``fn``, by the
    profiler's device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [evt.name for evt in prof.events()
            if evt.device_type == torch.autograd.DeviceType.CUDA]


def _warm_profiler() -> int:
    """Start the profiler's device tracing (CUPTI) once in this process,
    before any session whose trace is read: the first session of a
    process can come back without device activity. The port's own
    warm-up, which its profiler window runs too
    (``train/loop.warm_profiler``); the sessions it took."""
    import torch

    from distributedpytorch_tpu_torch.train.loop import warm_profiler

    return warm_profiler(torch.device("cuda", torch.cuda.current_device()))


def _device_kernels(fn) -> list:
    """Names of the kernels one call of ``fn`` runs on the card, by the
    profiler's device activity (after a warm call). ``fn`` has no side
    effects, so a session that saw nothing on the card at all is run
    again, up to PROFILER_TRIES times."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        kernels = _profiled_kernels(fn)
        if kernels:
            break
    return kernels


def phase_loss_kernels() -> dict:
    """K1 and K1-bwd against their plain versions at the train/eval shape
    and one ragged size, then timed at the train/eval shape (K1 also at
    the ragged size, beside the launch floor); one K1 call must run
    exactly one kernel on the card. Reports both kernels' registers and
    local memory by ``cuobjdump``."""
    import torch

    from distributedpytorch_tpu_torch.ops import _build
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
    # the launch floor: an empty kernel, timed the same way
    floor_ms = cuda_ms(lambda: torch.cuda._sleep(0), 100, hold=True)
    ragged = _loss_inputs((3, 17, 29, 1), gen, dev)
    ragged_ms = cuda_ms(lambda: lk.eval_stats(*ragged), 100, hold=True)
    sms, per_sm = lk.card_geometry(dev)
    plan = lk.loss_stats_plan(inputs[0][0].numel(), sms, per_sm)
    device_kernels = _device_kernels(lambda: lk.eval_stats(*nxt()))
    check(len(device_kernels) == 1 and "stats_kernel" in device_kernels[0],
          f"loss stats: one call ran {device_kernels} on the card, expected "
          f"one stats_kernel")
    # registers and local memory (spills) of K1 and K1-bwd
    usage = _sass_of(_build.library_path("loss_stats"), ())["resource_usage"]
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
        "stats_share_of_bound": stats_bound_s * 1e3 / stats_ms,
        "stats_plan": {"blocks": plan.blocks, "chunk": plan.chunk,
                       "sms": sms, "blocks_per_sm": per_sm},
        "stats_device_kernels_per_call": device_kernels,
        "stats_ragged_shape": [3, 17, 29, 1], "stats_ragged_ms": ragged_ms,
        "launch_floor_ms": floor_ms, "resource_usage": usage,
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


def _sass_of(lib_path, words) -> dict:
    """Which of ``words`` the SASS of a built library holds, and each
    kernel's registers, stack, shared and local memory, by ``cuobjdump``
    (next to ``nvcc``)."""
    import shutil

    from distributedpytorch_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.nvcc_path()), "cuobjdump")

    def dump(flag):
        return subprocess.run([tool, flag, str(lib_path)],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout

    sass = dump("--dump-sass")
    usage, name = {}, None
    for line in dump("--dump-resource-usage").splitlines():
        line = " ".join(line.split())
        if line.startswith("Function "):
            name = line[len("Function "):].rstrip(":")
        elif "REG:" in line and name is not None:
            usage[name] = line
            name = None
    return {"has": {word: word in sass for word in words},
            "resource_usage": usage}


def phase_wgrad() -> dict:
    """K5 against its plain version and cuDNN's weight gradient
    (``torch.nn.grad.conv2d_weight``) at each of milesial's ten engaged
    conv shapes (batch 4 at 960 x 640), at 128 -> 128 on 4 x 160 x 240, at
    a ragged 144 -> 128 on 2 x 9 x 37 (bf16) and a small float32 case; two
    calls bitwise equal. K5 and cuDNN timed at the eleven bf16 shapes and
    summed over one milesial step's 13 engaged convs beside their bound;
    the plain version timed at three. The built library's SASS must hold
    Hopper's wgmma (HGMMA) and TMA loads (UTMALDG)."""
    import torch

    from distributedpytorch_tpu_torch.ops import _build
    from distributedpytorch_tpu_torch.ops import wgrad_kernels as wk

    sass = _sass_of(_build.library_path("wgrad_9tap"), ("HGMMA", "UTMALDG"))
    check(all(sass["has"].values()),
          f"wgrad_9tap SASS lacks wgmma or TMA: {sass['has']}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # the first is the kernels line's shape; the plain version is timed at
    # the first three
    timed = tuple((TRAIN_BATCH,) + shape for shape in (
        (320, 480, 128, 128), (40, 60, 1024, 1024), (160, 240, 128, 128),
        *(s for s, _n in MILESIAL_K5_SHAPES
          if s not in ((320, 480, 128, 128), (40, 60, 1024, 1024)))))
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
        del x, dy, got, again, want, lib
    timings = []
    for i, (b, h, w, cin, cout) in enumerate(timed):
        sets = [inputs(b, h, w, cin, cout, torch.bfloat16) for _ in range(2)]
        nxt = _rotating(sets)
        nxt_lib = _rotating([(x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2))
                             for x, dy in sets])
        ms = cuda_ms(lambda: wk.wgrad_9tap(*nxt()), 10, hold=True)
        plain_ms = (cuda_ms(lambda: wk.wgrad_9tap_reference(*nxt()), 5,
                            hold=True) if i < 3 else None)

        def cudnn(pair, cin=cin, cout=cout):
            return torch.nn.grad.conv2d_weight(
                pair[0], (cout, cin, 3, 3), pair[1], padding=1)

        lib_ms = cuda_ms(lambda: cudnn(nxt_lib()), 10, hold=True)
        pixels = b * h * w
        flops = 2 * 9 * pixels * cin * cout
        nbytes = pixels * (cin + cout) * 2 + 9 * cin * cout * 4
        bound_s = max(nbytes / HBM_BYTES_PER_S, flops / BF16_OPS_PER_S)
        plan = wk.wgrad_plan(b, h, w, cin, cout, True, sms)
        timings.append({
            "shape": [b, h, w, cin, cout], "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bytes": nbytes, "flops": flops,
            "bound_ms": bound_s * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         > flops / BF16_OPS_PER_S else "operations"),
            "tflops": flops / (ms * 1e-3) / 1e12,
            "splits": plan.splits, "blocks": plan.blocks,
        })
        del sets, nxt, nxt_lib
    # one milesial step: each engaged shape as many times as its convs
    by_shape = {tuple(t["shape"][1:]): t for t in timings}
    step = {"k5_ms": 0.0, "cudnn_ms": 0.0, "bound_ms": 0.0, "convs": 0}
    for shape, n in MILESIAL_K5_SHAPES:
        t = by_shape[shape]
        step["k5_ms"] += n * t["ms"]
        step["cudnn_ms"] += n * t["library_ms"]
        step["bound_ms"] += n * t["bound_ms"]
        step["convs"] += n
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
    result = {"phase": "wgrad", "sass": sass, "cases": cases,
              "max_err_rel_to_max": worst,
              "cudnn_max_err_rel_to_max": worst_lib, "timings": timings,
              "milesial_step": step, "einsum_backend_ms": einsum_ms}
    emit(result)
    return result


def _burst_requests() -> list:
    """The 24 seeded requests of one to three 960 x 640 rows each."""
    import numpy as np

    w, h = IMAGE_WH
    rng = np.random.default_rng(SEED)
    return [rng.random((int(rng.integers(1, 4)), h, w, 3), dtype=np.float32)
            for _ in range(N_REQUESTS)]


def _serve_argv(checkpoint: str, ckpt_dir: str, *extra) -> list:
    """The serve CLI's flags for the full-width engine under kernels cuda
    at the four buckets, admitting the whole burst (these runs check
    answers, not shedding)."""
    w, h = IMAGE_WH
    return ["-c", checkpoint, "--checkpoint-dir", ckpt_dir,
            "--image-size", str(w), str(h), "--kernels", "cuda",
            "--buckets", *map(str, BUCKETS),
            "--queue-cap", str(3 * N_REQUESTS), "--port", "0", *extra]


def _burst(server, requests) -> list:
    """Submit every request from 8 threads at once; their responses."""
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        futures = list(pool.map(server.submit, requests))
        return [f.result(timeout=600) for f in futures]


def _check_masks(requests, responses) -> None:
    import numpy as np

    w, h = IMAGE_WH
    for req, resp in zip(requests, responses):
        check(resp.ok, f"request answered {resp.status}: {resp.reason}")
        check(len(resp.masks) == req.shape[0], "wrong mask count")
        for m in resp.masks:
            check(m.shape == (h, w) and m.dtype == np.uint8,
                  f"mask {m.shape} {m.dtype}")


def phase_serve(tmp: str) -> dict:
    """The port's main path: the serve CLI's build functions (one CUDA
    graph per bucket, K4 inside it), a server answering concurrent
    requests, and the same burst again under the profiler, where K4 is
    counted per replay by name."""
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
    requests = _burst_requests()
    n_images = sum(r.shape[0] for r in requests)
    t0 = time.perf_counter()
    server = cli.build_server(cli.get_args(_serve_argv("smoke", tmp)))
    startup_s = time.perf_counter() - t0  # build, graph capture, warm-up
    check(server.engine.kernel_policy.name == "cuda", "policy is not cuda")
    check(server.engine.graph_captures == len(BUCKETS),
          f"{server.engine.graph_captures} bucket graphs captured")
    server.start()
    httpd = None
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        responses = _burst(server, requests)
        burst_s = time.perf_counter() - t0
        # the wrappers count at capture only: a replay launches K4
        # without them (0 here)
        wrapper_launches = dict(kernels.LAUNCHES)
        stats = server.stats()
        _check_masks(requests, responses)
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
        check(http_stats["aot_cache"]["compiles"] == len(BUCKETS),
              f"aot_cache {http_stats['aot_cache']}")
        conn.close()
        # the same burst again under the profiler: K4 counted per replay
        # by name in the trace, one for each bucket dispatched
        before = sum(server.stats()["bucket_dispatches"].values())
        traced_responses, traced = _traced_call(
            lambda: _burst(server, requests), ("serve_mask",))
        _check_masks(requests, traced_responses)
        dispatches = sum(server.stats()["bucket_dispatches"].values()) \
            - before
        check(traced["serve_mask"] == dispatches > 0,
              f"{traced['serve_mask']} serve-mask kernels traced over "
              f"{dispatches} bucket dispatches")
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
        "pad_ratio": stats["pad_ratio"],
        "launches": {"serve_mask": traced["serve_mask"]},
        "traced_dispatches": dispatches,
        "wrapper_launches": wrapper_launches,
        "mask_flips": flips, "mask_flips_outside_band": outside,
        "pixels_in_band": near, "pixels": pixels,
        "device": torch.cuda.get_device_name(0),
    }
    emit(result)
    return {"result": result, "engine": ref}


#: the predict phase: ten files, ``-b 4`` (two full batches and a ragged
#: one), sent to the server as requests of the same sizes
PREDICT_FILES = 10
PREDICT_BATCH = 4
# the int8 A/B (the JAX package's tests/test_quantize.py): probabilities
# within this of the float engine's, so that at any threshold the int8
# masks equal the float ones wherever the float probability is at least
# this far from it. The masks' Dice agreement at the float probabilities'
# 80th percentile is reported beside the same agreement between bf16 and
# float32 compute of the float weights, not held to a bound: the models
# these phases train (16 and 4 steps) put that percentile in the dense
# middle of their probabilities, where bf16 rounding alone moved the
# UNet's masks to 0.941 and int8 to 0.975 on an H100 (PERF.md)
INT8_PROB_ATOL = 1e-2
# the int8 replica's weights against the float replica's, by the storage
# of every tensor each holds on the card (7,760,097 parameters: ~0.25).
# What placing them allocates (torch.cuda.memory_allocated around a copy
# of the replica's model on the card, as the engine places it) is
# reported beside it: the caching allocator hands out a cached block up
# to 1 MB larger than asked whole, which moved the UNet's ratio between
# 0.278 and 0.304 in two runs of the same code on an H100 (PERF.md). That
# figure is held below half of the float weights' storage, which any
# float copy of the weights on the replica exceeds
INT8_BYTES_RATIO = 0.3
RESIDENT_FLOAT_SHARE = 0.5


def _eager_run(engine, replica, placed):
    """``engine.run`` with the bucket's eager forward in place of its
    graph replay: the dispatch as it was before the graphs."""
    import torch

    from distributedpytorch_tpu_torch.serve.engine import DeviceResult

    with engine._on(replica, replica.stream):
        replica.stream.wait_event(placed.ready)
        placed.x.record_stream(replica.stream)
        out = replica.compiled[placed.x.shape[0]].eager(placed.x)
        done = torch.cuda.Event()
        done.record(replica.stream)
    return DeviceResult(out, done)


def _dispatch_timings(fn, runs: int = 20) -> dict:
    """One dispatch function timed three ways: the card's busy time per
    call (profiler), the host's time to return from it on an idle card,
    and the wall time per call back to back (the card drained after)."""
    host = sorted(_host_enqueue_ms(fn) for _ in range(5))
    return {"device_ms": _busy_ms_by_device(fn, 5, devices=[0])[0],
            "host_ms": host[len(host) // 2],
            "wall_ms": _wall_ms(fn, runs, 3, devices=[0])}


def _burst_row(engine, eager: bool) -> dict:
    """The 24-request burst through a fresh server on ``engine``, with its
    buckets dispatched eagerly (``_eager_run``) or as their graphs."""
    from distributedpytorch_tpu_torch.serve.server import Server

    requests = _burst_requests()
    if eager:
        engine.run = lambda replica, placed: _eager_run(engine, replica,
                                                        placed)
    server = Server(engine, hard_cap_images=3 * N_REQUESTS).start()
    try:
        t0 = time.perf_counter()
        responses = _burst(server, requests)
        burst_s = time.perf_counter() - t0
        stats = server.stats()
    finally:
        server.stop()
        engine.__dict__.pop("run", None)
    _check_masks(requests, responses)
    return {"p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
            "imgs_per_s": sum(r.shape[0] for r in requests) / burst_s}


def phase_serve_graph(tmp: str, serve: dict) -> dict:
    """Each bucket's forward as its CUDA graph against the eager forward
    it was captured from, under cuDNN's deterministic algorithms (set for
    this phase only): masks (kernels cuda, K4 in the graph) and
    probabilities (kernels torch) bitwise; the card's time, the host's
    time per dispatch and the wall time per dispatch of both; the burst
    through a server dispatching eagerly and as graphs, in turns; the
    same bucket dispatched twice before either result is drained; the
    engine's startup, graph capture included."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.serve.engine import (
        engine_from_checkpoint,
    )

    w, h = IMAGE_WH
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        engines = {}
        startup_s = {}
        for policy in ("cuda", "torch"):
            t0 = time.perf_counter()
            engines[policy] = engine_from_checkpoint(
                "smoke", checkpoint_dir=tmp, image_size=IMAGE_WH,
                dtype="bf16", bucket_sizes=BUCKETS, kernels=policy,
                device="cuda")
            engines[policy].warmup()
            startup_s[policy] = time.perf_counter() - t0
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        buckets = {}
        for b in BUCKETS:
            x = torch.rand((b, h, w, 3), generator=gen, device="cuda")
            row = {}
            for policy, engine in engines.items():
                forward = engine.replicas[0].compiled[b]
                check(forward.graph is not None,
                      f"bucket {b} has no graph under {policy}")
                eager, graph = forward.eager(x), forward(x)
                torch.cuda.synchronize()
                row[f"{policy}_bitwise"] = bool(torch.equal(eager, graph))
                check(row[f"{policy}_bitwise"],
                      f"bucket {b}: graph and eager forward differ "
                      f"(kernels {policy})")
            engine = engines["cuda"]
            replica = engine.replicas[0]
            placed = engine.place(replica, x.cpu().numpy())
            placed.ready.synchronize()
            row["eager"] = _dispatch_timings(
                lambda: _eager_run(engine, replica, placed))
            row["graph"] = _dispatch_timings(
                lambda: engine.run(replica, placed))
            buckets[str(b)] = row
        # the 24-request burst through a server on the cuda engine with
        # the eager dispatch and with the graphs, in turns
        bursts = {"eager": [], "graph": []}
        for mode in ("eager", "graph", "graph", "eager"):
            bursts[mode].append(_burst_row(engines["cuda"], mode == "eager"))
        # two dispatches of one bucket in flight before either is drained
        engine = engines["torch"]
        replica = engine.replicas[0]
        b = max(BUCKETS)
        rng = np.random.default_rng(SEED + 1)
        batches = [rng.random((b, h, w, 3), dtype=np.float32)
                   for _ in range(2)]
        placed = [engine.place(replica, batch) for batch in batches]
        results = [engine.run(replica, p) for p in placed]
        got = [r.numpy() for r in results]
        intact = []
        for batch, probs in zip(batches, got):
            x = torch.from_numpy(batch).cuda()
            want = replica.compiled[b].eager(x).cpu().numpy()
            intact.append(bool(np.array_equal(probs, want)))
        check(all(intact) and not np.array_equal(got[0], got[1]),
              f"two in-flight replays of bucket {b}: intact {intact}")
    finally:
        torch.backends.cudnn.deterministic = saved
    out = {
        "phase": "serve_graph", "cudnn_deterministic": True,
        "buckets": buckets, "bursts": bursts, "inflight_bucket": b,
        "inflight_results_intact": intact,
        "graphs_captured": engines["cuda"].graph_captures,
        "startup_s": startup_s["cuda"],
        "startup_s_torch_policy": startup_s["torch"],
        "serve_startup_s": serve["result"]["startup_s"],
    }
    del engines, engine, replica, placed, results
    torch.cuda.empty_cache()
    emit(out)
    return out


def _repo_module(*argv) -> dict:
    """``python -m distributedpytorch_tpu_torch ARGV`` from the checkout's
    root; its wall seconds and the last lines of its log."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "distributedpytorch_tpu_torch", *argv],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"{argv[0]} exited {proc.returncode}: {proc.stderr[-2000:]}")
    return {"wall_s": wall_s,
            "log": proc.stderr.strip().splitlines()[-1:]}


def _forward_ms(engine) -> dict:
    """Each bucket's forward (a graph replay, its copies included) by
    CUDA events, back to back on the current stream."""
    import numpy as np

    replica = engine.replicas[0]
    h, w = engine.input_hw
    out = {}
    for b in engine.planner.sizes:
        placed = engine.place(replica, np.zeros((b, h, w, 3), np.float32))
        placed.ready.synchronize()
        fn = replica.compiled[b]
        out[str(b)] = cuda_ms(lambda: fn(placed.x), 10, warmup=2)
    return out


def _serve_burst(argv) -> dict:
    """A server built by the serve CLI from ``argv`` answers the 24-request
    burst; its startup, latency, images / s, forward ms per bucket and
    the replica's weight bytes on the card. The engine is kept
    (``engine``) for the caller's comparisons; the server is stopped."""
    from distributedpytorch_tpu_torch.serve import cli

    requests = _burst_requests()
    t0 = time.perf_counter()
    server = cli.build_server(cli.get_args(argv))
    startup_s = time.perf_counter() - t0
    server.start()
    try:
        t0 = time.perf_counter()
        responses = _burst(server, requests)
        burst_s = time.perf_counter() - t0
        stats = server.stats()
    finally:
        server.stop()
    _check_masks(requests, responses)
    engine = server.engine
    n_images = sum(r.shape[0] for r in requests)
    return {
        "row": {"startup_s": startup_s, "burst_s": burst_s,
                "imgs_per_s": n_images / burst_s,
                "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
                "forward_ms": _forward_ms(engine),
                "resident_weight_bytes": _placed_bytes(
                    engine.replicas[0].model),
                "weight_storage_bytes": sum(
                    t.untyped_storage().nbytes() for t in
                    engine.replicas[0].model.state_dict().values()),
                "quantized": engine.quantized},
        "engine": engine,
    }


def _placed_bytes(model) -> int:
    """What placing ``model`` on its card allocates: torch.cuda's
    allocated bytes around a copy of it there, as the engine's replica
    build copies the model onto its device."""
    import copy

    import torch

    # free blocks cached by earlier phases would be handed out whole
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    placed = copy.deepcopy(model)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - before
    del placed
    torch.cuda.empty_cache()
    return allocated


def _synthetic_rows(n: int):
    """``n`` procedural 960 x 640 car images (the training data's kind)."""
    import numpy as np

    from distributedpytorch_tpu_torch.data.dataset import (
        SyntheticSegmentationDataset,
    )

    ds = SyntheticSegmentationDataset(length=n, newsize=IMAGE_WH,
                                      seed=SEED + 7)
    return np.stack([ds[i]["image"] for i in range(n)]).astype(np.float32)


def _agreement(reference, other, quantile: float = 0.8) -> float:
    """Dice of the two masks at ``reference``'s ``quantile``."""
    import numpy as np

    thr = float(np.quantile(reference, quantile))
    ma, mb = reference >= thr, other >= thr
    return 2.0 * float(np.sum(ma & mb)) / max(1.0, float(ma.sum() + mb.sum()))


def _int8_model(tmp: str, arch: str, pth: str) -> dict:
    """One model's int8 serving against its float serving: the converter
    (``python -m distributedpytorch_tpu_torch quantize``) on its ``.pth``;
    the burst through the serve CLI with the float ``.pth`` and with
    ``--quantize int8`` on the int8 file; the same file loaded without the
    flag; the bytes on the card; the probabilities of the kernels-torch
    engines on eight synthetic images (int8 against float in bf16, and
    float in bf16 against float32 for the rounding the served compute
    already adds); quantize-on-load against the file; the kernels per
    replay in the trace."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.serve.engine import (
        engine_from_checkpoint,
    )
    from distributedpytorch_tpu_torch.serve.infer import load_inference_bundle

    int8 = os.path.join(tmp, f"{arch}.int8.pt")
    model = ["--model", arch]
    converter = _repo_module("quantize", "-c", pth, "-o", int8,
                             "--image-size", *map(str, IMAGE_WH), *model)
    ckpt_dir = os.path.dirname(pth)
    fl = _serve_burst(_serve_argv(pth, ckpt_dir, *model))
    q8 = _serve_burst(_serve_argv(int8, ckpt_dir, *model,
                                  "--quantize", "int8"))
    check(q8["engine"].quantized and not fl["engine"].quantized,
          "the int8 server does not serve int8 weights")
    ratio = (q8["row"]["weight_storage_bytes"]
             / fl["row"]["weight_storage_bytes"])
    allocated_ratio = (q8["row"]["resident_weight_bytes"]
                       / fl["row"]["resident_weight_bytes"])
    check(ratio < INT8_BYTES_RATIO,
          f"{arch}: int8 replica holds {ratio:.4f} of the float bytes")
    check(q8["row"]["resident_weight_bytes"]
          < RESIDENT_FLOAT_SHARE * fl["row"]["weight_storage_bytes"],
          f"{arch}: placing the int8 replica allocated "
          f"{q8['row']['resident_weight_bytes']} bytes")
    check(all(name.endswith(".scale") for name, t in
              q8["engine"].replicas[0].model.state_dict().items()
              if t.is_floating_point() and t.ndim == 4),
          f"{arch}: a float conv weight is resident on the int8 replica")
    # the file without the flag: detected, the same int8 state
    detected = load_inference_bundle(int8, image_size=IMAGE_WH,
                                     model_arch=arch)
    state = q8["engine"].replicas[0].model.state_dict()
    same_state = detected.quantized and all(
        torch.equal(v, state[k].cpu())
        for k, v in detected.model.state_dict().items())
    check(same_state, f"{arch}: the int8 file loads otherwise without "
                      f"--quantize")
    kernels_replay = ("serve_mask", "bn_act") if arch == "milesial" \
        else ("serve_mask",)
    rows = _synthetic_rows(max(BUCKETS))
    _, per_replay = _traced_call(lambda: q8["engine"].infer(rows[:1]),
                                 kernels_replay)
    _, per_replay_float = _traced_call(
        lambda: fl["engine"].infer(rows[:1]), kernels_replay)
    want = {"serve_mask": 1, "bn_act": 18}
    check(all(per_replay[k] == per_replay_float[k] == want[k]
              for k in kernels_replay),
          f"{arch}: kernels per replay {per_replay} / {per_replay_float}")
    del fl["engine"], q8["engine"]
    # probabilities (kernels torch, host threshold), float against int8
    common = dict(image_size=IMAGE_WH, model_arch=arch, dtype="bf16",
                  bucket_sizes=(max(BUCKETS),), kernels="torch",
                  device="cuda")
    probs_f = engine_from_checkpoint(pth, **common).infer(rows)
    q_file = engine_from_checkpoint(int8, quantize="int8", **common)
    probs_q = q_file.infer(rows)
    on_load = engine_from_checkpoint(pth, quantize="int8", **common)
    file_state = q_file.replicas[0].model.state_dict()
    onload_state_equal = all(
        torch.equal(v, file_state[k])
        for k, v in on_load.replicas[0].model.state_dict().items())
    check(onload_state_equal, f"{arch}: quantize-on-load (host) and the "
                              f"converter (card) quantized differently")
    onload_equal = bool(np.array_equal(
        on_load.postprocess(on_load.infer(rows)),
        q_file.postprocess(probs_q)))
    check(onload_equal, f"{arch}: quantize-on-load masks differ from the "
                        f"int8 file's")
    probs_f32 = engine_from_checkpoint(
        pth, **dict(common, dtype="f32")).infer(rows)
    max_abs = float(np.max(np.abs(probs_f - probs_q)))
    thr = float(np.quantile(probs_f, 0.8))
    mf, mq = probs_f >= thr, probs_q >= thr
    outside = int(((mf != mq) & (np.abs(probs_f - thr) >= INT8_PROB_ATOL))
                  .sum())
    check(max_abs < INT8_PROB_ATOL and mf.sum() > 0,
          f"{arch}: int8 probabilities {max_abs} from the float ones")
    del q_file, on_load
    torch.cuda.empty_cache()
    return {
        "int8_file": os.path.basename(int8), "converter": converter,
        "float": fl["row"], "int8": q8["row"],
        "weight_storage_bytes_ratio": ratio,
        "resident_weight_bytes_ratio": allocated_ratio,
        "detected_without_flag": True,
        "launches_per_replay": per_replay,
        "launches_per_replay_float": per_replay_float,
        "prob_max_abs_diff": max_abs,
        "prob_mean_abs_diff": float(np.mean(np.abs(probs_f - probs_q))),
        "p80_threshold": thr, "p80_flips_outside_band": outside,
        "p80_mask_agreement": _agreement(probs_f, probs_q),
        "p80_mask_agreement_bf16_vs_f32": _agreement(probs_f32, probs_f),
        "quantize_on_load_masks_equal_file": onload_equal,
        "int8_path": int8,
    }


def phase_serve_int8(tmp: str) -> dict:
    """Weights-only int8 serving of the weights the ``train`` and
    ``train_milesial`` phases wrote (``_int8_model`` for each)."""
    out = {"phase": "serve_int8"}
    for arch, run in (("unet", "train"), ("milesial", "train_milesial")):
        pth = os.path.join(tmp, run, "checkpoints", "singleGPU.pth")
        out[arch] = _int8_model(tmp, arch, pth)
    emit(out)
    return out


def phase_predict(tmp: str, serve_int8: dict) -> dict:
    """``python -m distributedpytorch_tpu_torch predict -b 4`` on ten
    seeded 960 x 640 PNGs (two full batches and a ragged one) with the
    UNet's float ``.pth`` and its int8 file, held against the server's
    answers to the same files sent as requests of 4, 4 and 2 images:
    masks equal wherever the probability is at least ``SERVE_BAND`` from
    the threshold (cuDNN may pick other algorithms for the graph and for
    predict's eager forward), and the bit-equal share reported; then the
    images / s of predict's batch loop on the card."""
    import numpy as np
    import torch
    from PIL import Image

    from distributedpytorch_tpu_torch.predict import predict_batches
    from distributedpytorch_tpu_torch.serve import cli
    from distributedpytorch_tpu_torch.serve.infer import (
        load_image,
        load_inference_bundle,
    )

    w, h = IMAGE_WH
    images = os.path.join(tmp, "predict_in")
    os.makedirs(images)
    rows = _synthetic_rows(PREDICT_FILES)
    names = [f"car{i:02d}.png" for i in range(PREDICT_FILES)]
    for name, row in zip(names, rows):
        Image.fromarray((row * 255).astype(np.uint8)).save(
            os.path.join(images, name))
    paths = [os.path.join(images, n) for n in names]
    decoded = np.stack([load_image(p, IMAGE_WH) for p in paths])
    pth = os.path.join(tmp, "train", "checkpoints", "singleGPU.pth")
    out = {"phase": "predict", "files": PREDICT_FILES,
           "batch": PREDICT_BATCH}
    for label, ckpt, extra in (
            ("float", pth, ()),
            ("int8", serve_int8["unet"]["int8_path"], ("--quantize", "int8"))):
        dest = os.path.join(tmp, f"predict_{label}")
        run = _repo_module("predict", "-c", ckpt, "-i", images, "-o", dest,
                           "-b", str(PREDICT_BATCH))
        written = [os.path.join(dest, f"{os.path.splitext(n)[0]}_mask.png")
                   for n in names]
        predicted = [np.asarray(Image.open(p)) for p in written]
        server = cli.build_server(cli.get_args(
            _serve_argv(ckpt, os.path.dirname(ckpt), *extra)))
        server.start()
        try:
            served = []
            for i in range(0, PREDICT_FILES, PREDICT_BATCH):
                resp = server.submit(paths[i:i + PREDICT_BATCH]).result(600)
                check(resp.ok, f"predict phase request: {resp.reason}")
                served += resp.masks
        finally:
            server.stop()
        del server
        # predict's own probabilities, for the band
        bundle = load_inference_bundle(ckpt, image_size=IMAGE_WH)
        model = bundle.model.to("cuda")
        probs = np.concatenate([p for p, _ in predict_batches(
            model, decoded, PREDICT_BATCH, device="cuda")])
        t0 = time.perf_counter()
        for _ in predict_batches(model, decoded, PREDICT_BATCH,
                                 device="cuda"):
            pass
        loop_s = time.perf_counter() - t0
        got, want = np.stack(predicted), np.stack(served)
        check(got.shape == (PREDICT_FILES, h, w) and got.dtype == np.uint8,
              f"predicted masks {got.shape} {got.dtype}")
        diff = got != want
        outside = int((diff & (np.abs(probs - THRESHOLD) >= SERVE_BAND)).sum())
        check(outside == 0, f"predict ({label}): {outside} mask pixels "
                            f"differ from the served ones outside the band")
        check(bundle.quantized == (label == "int8"),
              f"predict ({label}) loaded quantized={bundle.quantized}")
        out[label] = {
            "cli": run, "masks_written": len(written),
            "pixels_bit_equal_share": float(1.0 - diff.mean()),
            "mask_flips": int(diff.sum()),
            "mask_flips_outside_band": outside,
            "loop_imgs_per_s": PREDICT_FILES / loop_s,
        }
        del model, bundle
        torch.cuda.empty_cache()
    emit(out)
    return out


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


def _host_enqueue_ms(fn) -> float:
    """Host milliseconds to return from one call of ``fn`` on an idle
    card (what the host spends enqueueing it), then the card drained."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return host_ms


def _top_host_ops(fn, runs: int, width: int = 60) -> list:
    """``[[name, host ms per run, calls per run], ...]`` of the PyTorch
    operators ``fn`` calls, by their own host time over ``runs`` calls,
    largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((evt.self_cpu_time_total / runs / 1e3, evt.key,
                    evt.count / runs) for evt in prof.key_averages()),
                  reverse=True)
    return [[name[:width], ms, calls] for ms, name, calls in rows]


def _top_kernels(fn, runs: int, width: int = 80, by_op: bool = False
                 ) -> list:
    """``[[name, device ms per run], ...]`` of the kernels ``fn`` launches,
    largest first, by the profiler's device clock over ``runs`` calls;
    with ``by_op``, of the PyTorch operators that launched them (each
    operator's own kernels, its children's excluded). A range that a
    ``record_function`` marks on the device (DDP's forward) is not a
    kernel and is left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    want = cpu if by_op else torch.autograd.DeviceType.CUDA
    averages = prof.key_averages()
    host_names = {evt.key for evt in averages if evt.device_type == cpu}
    rows = []
    for evt in averages:
        if evt.device_type != want or (not by_op
                                       and evt.key in host_names):
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
    host_ms = _host_enqueue_ms(lambda: trainer.train_step(batch))
    top = _top_kernels(lambda: trainer.train_step(batch), 3)
    out = {
        "phase": "train", "params": n_params, "steps": steps,
        "eval_batches": eval_batches, "launches": launches,
        "train_s": train_s, "losses": losses,
        "val_loss": result["val_loss"], "val_dice": result["val_dice"],
        "run_imgs_per_s": result["images_per_second"],
        "step_ms": step_ms, "step_imgs_per_s": TRAIN_BATCH / step_ms * 1e3,
        "host_enqueue_ms": host_ms,
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
        # the running statistics the run left, before timing moves them
        final_stats = {n: b.clone() for n, b in model.named_buffers()
                       if n in before}
        artifacts = sorted(
            os.path.relpath(os.path.join(d, f), run)
            for d, _, files in os.walk(run) for f in files
        )
        engine = engine_from_checkpoint(
            "singleGPU", checkpoint_dir=ckpt_dir, image_size=IMAGE_WH,
            model_arch="milesial", dtype="bf16", bucket_sizes=(1,),
            kernels="cuda", device="cuda",
        )
        # the bucket forward is a CUDA graph: its kernels are counted in
        # the trace of one replay
        masks, serve_launches = _traced_call(
            lambda: engine.infer(np.zeros((1, h, w, 3), np.float32)),
            ("bn_act", "serve_mask"))
        del engine
        batch = trainer.place_batch(trainer.train_loader.load_slice(
            trainer.train_loader.batch_slices(0)[0]))
        step_ms = cuda_ms(lambda: trainer.train_step(batch), 5, warmup=2)
        host_ms = _host_enqueue_ms(lambda: trainer.train_step(batch))
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
        "host_enqueue_ms": host_ms,
        "peak_mem_bytes": peak_bytes, "artifacts": artifacts,
        "device_ms_per_step": sum(ms for _, ms in top),
        "bn_act_kernels_ms_per_step": share("bn_act"),
        "wgrad_kernel_ms_per_step": share("wgrad_bf16"),
        "top_kernels_ms": top[:12],
        "top_ops_ms": top_ops[:15],
        "device": torch.cuda.get_device_name(0),
    }
    emit(out)
    return dict(out, running_stats=final_stats)


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


# -t DDP ---------------------------------------------------------------------

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")
# train_ddp against train: the first step's loss is bitwise equal (the
# same weights, batch and kernels; the world-1 all-reduces are copies);
# later steps within this, since cuDNN's weight-gradient sums need not be
# run-to-run identical and Adam carries a difference on
DDP_LOSS_RTOL = 1e-3
# train_ddp_gloo2 and --cards: per-rank batch and steps of the full-width
# float32 UNet on every rank
RANK_BATCH = 2
RANK_STEPS = 4
# their first step against one world-1 step on the concatenated batch:
# the loss (float32 sums in other orders) and each weight gradient
# relative to its tensor's largest (cuDNN sums a batch of 2 and the whole
# batch in other orders)
RANKS_LOSS_RTOL = 1e-5
RANKS_GRAD_RTOL = 1e-3
# train_milesial_ddp's running statistics against train_milesial's, the
# same batches at world 1, relative to each tensor's largest
DDP_STATS_RTOL = 1e-4


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _ddp_world_one(run: str, argv, measure):
    """Train ``argv`` (``-t DDP``) at world 1 through the training CLI's
    own functions, as ``torchrun --nproc_per_node 1`` launches it: with
    torchrun's env set, ``cli.start_runtime`` joins an NCCL group, the
    kernel launches are counted over ``trainer.train()``, then
    ``measure(trainer)`` runs while the group is up. Returns the trainer,
    its result, the launches, the running statistics the run left, the
    files it wrote and what ``measure`` returned."""
    import torch

    from distributedpytorch_tpu_torch import cli
    from distributedpytorch_tpu_torch.dist import runtime
    from distributedpytorch_tpu_torch.ops import kernels

    os.makedirs(run)
    saved_env = {k: os.environ.get(k) for k in TORCHRUN_ENV}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    args = cli.get_args(argv)
    cwd = os.getcwd()
    os.chdir(run)
    handlers = []
    try:
        info = cli.start_runtime(args)
        check(info.num_processes == 1
              and torch.distributed.get_backend() == "nccl",
              f"-t DDP joined {torch.distributed.get_backend()} at world "
              f"{info.num_processes}")
        handlers = cli.configure_logging(cli.to_config(args),
                                         to_stderr=info.is_main)
        trainer = cli.build_trainer(args, info)
        check(trainer.kernels.name == "cuda", "policy is not cuda")
        torch.cuda.synchronize()
        kernels.reset_launches()
        result = trainer.train()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        stats = {n: b.clone() for n, b in trainer.model.named_buffers()
                 if "running" in n}
        artifacts = sorted(
            os.path.relpath(os.path.join(d, f), run)
            for d, _, files in os.walk(run) for f in files
        )
        measured = measure(trainer)
    finally:
        runtime.shutdown()
        root = logging.getLogger()
        for handler in handlers:
            root.removeHandler(handler)
            handler.close()
        os.chdir(cwd)
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    for need in ("logs/DDP.log", "checkpoints/DDP.pt", "checkpoints/DDP.pth",
                 "loss/DDP/train_loss.pkl", "loss/DDP/val_loss.pkl",
                 "loss/DDP/val_dice.pkl"):
        check(need in artifacts, f"missing artifact {need}: {artifacts}")
    return trainer, result, launches, stats, artifacts, measured


def _step_ms(iters: int, warmup: int):
    """``measure`` for ``_ddp_world_one``: the steady step on a placed
    batch by CUDA events, the host's time to enqueue one step, and the
    step's device time and kernels by the profiler's clock."""

    def measure(trainer):
        batch = trainer.place_batch(trainer.train_loader.load_slice(
            trainer.train_loader.batch_slices(0)[0]))
        step_ms = cuda_ms(lambda: trainer.train_step(batch), iters,
                          warmup=warmup)
        host_ms = _host_enqueue_ms(lambda: trainer.train_step(batch))
        top = _top_kernels(lambda: trainer.train_step(batch), 2)
        host_top = _top_host_ops(lambda: trainer.train_step(batch), 2)
        return {"step_ms": step_ms, "host_enqueue_ms": host_ms,
                "device_ms_per_step": sum(ms for _, ms in top),
                "top_kernels_ms": top[:10], "top_host_ops_ms": host_top[:12]}

    return measure


def phase_train_ddp(tmp: str, train: dict) -> dict:
    """``-t DDP`` of the full-width UNet at world 1 under NCCL with the
    data and seed of ``train`` (bf16, kernels cuda, 16 steps, 4 eval
    batches): K1 per shard in every step and eval batch, K1-bwd per step,
    the first loss bitwise equal to ``train``'s, the step by CUDA events
    beside ``train``'s (what the all-reduces cost at world 1). Then a
    shorter run as a real ``torchrun --standalone --nproc_per_node 1``
    subprocess, which must exit 0 with the DDP artifacts."""
    import numpy as np
    import torch

    w, h = IMAGE_WH
    argv = ["-t", "DDP", "--synthetic", str(TRAIN_SAMPLES),
            "-v", "20", "-b", str(TRAIN_BATCH), "-e", str(TRAIN_EPOCHS),
            "--image-size", str(w), str(h), "--dtype", "bf16",
            "--kernels", "cuda"]
    trainer, result, launches, _, artifacts, timing = _ddp_world_one(
        os.path.join(tmp, "train_ddp"), argv, _step_ms(10, 3))
    steps = result["steps"]
    eval_batches = TRAIN_EPOCHS * len(trainer.val_loader)
    losses = [float(x) for x in trainer.records.losses]
    check(steps == train["steps"] and len(losses) == steps,
          f"{steps} DDP steps against {train['steps']}")
    check(all(np.isfinite(losses)), f"non-finite DDP loss: {losses}")
    check(launches["loss_stats"] == steps + eval_batches,
          f"DDP: loss stats kernel launched {launches['loss_stats']} times "
          f"for {steps} steps and {eval_batches} eval batches")
    check(launches["loss_stats_bwd"] == steps,
          f"DDP: loss stats backward launched {launches['loss_stats_bwd']} "
          f"times for {steps} steps")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, train["losses"])]

    # the same path as a user launches it
    sub = os.path.join(tmp, "train_ddp_torchrun")
    os.makedirs(sub)
    env = dict(os.environ,
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    for key in TORCHRUN_ENV:
        env.pop(key, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m", "distributedpytorch_tpu_torch",
           "-t", "DDP", "--synthetic", "8", "-v", "50",
           "-b", str(TRAIN_BATCH), "-e", "1", "--image-size", str(w), str(h),
           "--kernels", "cuda"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=sub, env=env, capture_output=True,
                          text=True, timeout=300)
    torchrun_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"torchrun -t DDP exited {proc.returncode}: {proc.stderr[-3000:]}")
    wrote = sorted(os.path.relpath(os.path.join(d, f), sub)
                   for d, _, files in os.walk(sub) for f in files)
    check(wrote == ["checkpoints/DDP.pt", "checkpoints/DDP.pth",
                    "logs/DDP.log", "loss/DDP/train_loss.pkl",
                    "loss/DDP/val_dice.pkl", "loss/DDP/val_loss.pkl"],
          f"torchrun -t DDP wrote {wrote}")
    out = {
        "phase": "train_ddp", "world": 1, "backend": "nccl",
        "steps": steps, "eval_batches": eval_batches, "launches": launches,
        "losses": losses, "first_loss_bitwise_equal":
            losses[0] == train["losses"][0],
        "loss_max_rel_err_vs_train": max(rel),
        "val_loss": result["val_loss"], "val_dice": result["val_dice"],
        **timing, "train_step_ms": train["step_ms"],
        "train_device_ms_per_step": train["device_ms_per_step"],
        "step_ms_over_train": timing["step_ms"] / train["step_ms"],
        "artifacts": artifacts, "torchrun_s": torchrun_s,
        "torchrun_wrote": wrote,
        "device": torch.cuda.get_device_name(0),
    }
    emit(out)
    check(out["first_loss_bitwise_equal"],
          f"DDP first loss {losses[0]} against train's {train['losses'][0]}")
    check(max(rel) <= DDP_LOSS_RTOL,
          f"DDP losses off train's by rel {max(rel)}")
    return out


class _FirstGrads:
    """An optimizer that keeps the gradients of its first step (as Adam
    receives them), then steps ``inner``."""

    def __init__(self, inner, named):
        self.inner = inner
        self.named = named
        self.grads = None

    def zero_grad(self, set_to_none=True):
        self.inner.zero_grad(set_to_none=set_to_none)

    def step(self):
        if self.grads is None:
            self.grads = {n: p.grad.detach().float().cpu()
                          for n, p in self.named}
        self.inner.step()


def _ddp_batches(world: int, per_rank: int, steps: int):
    """``steps`` global batches of ``world x per_rank`` synthetic items,
    on the host; rank r takes rows ``[r·per_rank, (r+1)·per_rank)``."""
    import numpy as np

    from distributedpytorch_tpu_torch.data.dataset import (
        SyntheticSegmentationDataset,
    )

    n = world * per_rank
    data = SyntheticSegmentationDataset(steps * n, IMAGE_WH, seed=SEED)
    items = [data[i] for i in range(steps * n)]
    return [{k: np.stack([it[k] for it in items[s * n:(s + 1) * n]])
             for k in ("image", "mask")} for s in range(steps)]


def _ddp_model_step(rank: int, world: int, device: str, dtype: str,
                    per_rank: int):
    """The full-width UNet through the DDP strategy on ``device`` (kernels
    cuda, seed SEED): ``(model, step, first_grads, batches)`` with the
    rank's rows of global batches."""
    import torch

    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.models import create_model
    from distributedpytorch_tpu_torch.ops.optim import make_optimizer
    from distributedpytorch_tpu_torch.parallel.strategy import build_strategy
    from distributedpytorch_tpu_torch.train.steps import make_train_step

    cfg = TrainConfig(train_method="DDP", device=device, dtype=dtype,
                      kernels="cuda", batch_size=per_rank)
    strategy = build_strategy(cfg)
    check(strategy.world == world and strategy.rank == rank
          and str(strategy.device) == device,
          f"rank {rank}: {strategy.info}")
    model = create_model(cfg, generator=torch.Generator().manual_seed(
        SEED)).to(strategy.device)
    opt = _FirstGrads(make_optimizer(
        model.parameters(), strategy.lr_for(cfg.learning_rate),
        cfg.weight_decay), list(model.named_parameters()))
    step = make_train_step(strategy.wrap_model(model), opt, per_rank,
                           loss_impl=strategy.train_loss(True))
    rows = slice(rank * per_rank, (rank + 1) * per_rank)

    def place(batch):
        return {k: torch.from_numpy(v[rows]).to(strategy.device)
                for k, v in batch.items()}

    return model, step, opt, place


def ddp_rank(rank: int, world: int, backend: str, job: str) -> int:
    """One rank of a multi-process DDP phase (``chip_smoke.py --ddp-rank R
    WORLD BACKEND DIR``): joins a ``backend`` group over a file store in
    ``DIR``, on cuda:0 under gloo (``train_ddp_gloo2``: every rank on the
    one card) and on cuda:R under nccl (``--cards``). Trains the
    full-width float32 UNet under kernels cuda through the DDP strategy
    for RANK_STEPS steps on its RANK_BATCH rows of each global batch and
    writes its losses, its first step's gradients, its final weights and
    its launches to ``DIR/result_R.pt``; under nccl it also times the
    bf16 step at TRAIN_BATCH per rank by CUDA events."""
    import torch

    from distributedpytorch_tpu_torch.ops import kernels

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = "cuda:0" if backend == "gloo" else f"cuda:{rank}"
    torch.cuda.set_device(torch.device(device))
    _warm_profiler()
    torch.distributed.init_process_group(
        backend, init_method=f"file://{os.path.join(job, 'store')}",
        rank=rank, world_size=world)
    try:
        model, step, opt, place = _ddp_model_step(rank, world, device, "f32",
                                                  RANK_BATCH)
        kernels.reset_launches()
        losses = [float(step(place(batch))) for batch in
                  _ddp_batches(world, RANK_BATCH, RANK_STEPS)]
        result = {"losses": losses, "grads": opt.grads,
                  "launches": dict(kernels.LAUNCHES),
                  "state": {k: v.cpu() for k, v in
                            model.state_dict().items()}}
        del model, step, opt
        if backend == "nccl":
            _, step, _, place = _ddp_model_step(rank, world, device, "bf16",
                                                TRAIN_BATCH)
            batch = place(_ddp_batches(world, TRAIN_BATCH, 1)[0])
            result["bf16_step_ms"] = cuda_ms(lambda: step(batch), 10,
                                             warmup=3)
            del step
            from distributedpytorch_tpu_torch.config import TrainConfig

            # DDP's 11 eager warm-up steps take three stacks: five stacks
            # put two through the graph
            result["graph"] = _rank_graph_run(TrainConfig(
                train_method="DDP", device=device, dtype="bf16",
                kernels="cuda", batch_size=TRAIN_BATCH,
                steps_per_dispatch=GS_K), rank, world,
                [torch.device(device)], 5)
        torch.save(result, os.path.join(job, f"result_{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()
    return 0


def _run_ddp_ranks(job: str, world: int, backend: str,
                   flag: str = "--ddp-rank"):
    """``world`` processes of ``ddp_rank`` (``ddp_mp_rank`` with
    ``--ddp-mp-rank``), started together; their results by rank and the
    wall seconds they took."""
    import torch

    os.makedirs(job)
    env = dict(os.environ,
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    for key in TORCHRUN_ENV:
        env.pop(key, None)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               flag, str(rank), str(world), backend,
                               job], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=300)[0])
    finally:
        for proc in procs:
            proc.kill()
    wall_s = time.perf_counter() - t0
    for rank, proc in enumerate(procs):
        check(proc.returncode == 0,
              f"{backend} rank {rank} of {world} exited {proc.returncode}: "
              f"{logs[rank][-3000:]}")
    return [torch.load(os.path.join(job, f"result_{rank}.pt"),
                       weights_only=True) for rank in range(world)], wall_s


def _check_ranks_against_one_step(ranks, world: int) -> dict:
    """The ranks' weights and losses bitwise equal, K1 and K1-bwd launched
    once per step on each, and step 1's loss and gradients against one
    world-1 step of the same weights on the concatenated batch (with the
    per-process faithful scale) on cuda:0."""
    import torch

    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.models import create_model
    from distributedpytorch_tpu_torch.train.steps import make_train_step

    same_weights = all(torch.equal(v, r["state"][k]) for r in ranks[1:]
                       for k, v in ranks[0]["state"].items())
    dev = torch.device("cuda", 0)
    cfg = TrainConfig(dtype="f32", kernels="cuda", device="cuda")
    model = create_model(cfg, generator=torch.Generator().manual_seed(
        SEED)).to(dev)
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in _ddp_batches(world, RANK_BATCH, 1)[0].items()}
    loss = float(make_train_step(model, opt, RANK_BATCH,
                                 train_loss_fused=True)(batch))
    rel_loss = abs(ranks[0]["losses"][0] - loss) / abs(loss)
    worst = max(
        float((ranks[0]["grads"][n] - p.grad.float().cpu()).abs().max()
              / p.grad.abs().max())
        for n, p in model.named_parameters())
    out = {
        "losses": [r["losses"] for r in ranks],
        "launches": [r["launches"] for r in ranks],
        "weights_bitwise_equal": same_weights,
        "step1_loss_world1": loss, "step1_loss_rel_err": rel_loss,
        "step1_grad_max_err_rel_to_tensor_max": worst,
    }
    return out


def _assert_ranks(out: dict, what: str) -> None:
    check(out["weights_bitwise_equal"], f"{what}: the ranks' weights differ")
    check(all(l == out["losses"][0] for l in out["losses"]),
          f"{what}: the ranks' losses differ")
    for counts in out["launches"]:
        check(counts["loss_stats"] == RANK_STEPS
              and counts["loss_stats_bwd"] == RANK_STEPS,
              f"{what}: a rank launched {counts}")
    check(out["step1_loss_rel_err"] <= RANKS_LOSS_RTOL,
          f"{what}: step 1 loss off the world-1 step by rel "
          f"{out['step1_loss_rel_err']}")
    check(out["step1_grad_max_err_rel_to_tensor_max"] <= RANKS_GRAD_RTOL,
          f"{what}: step 1 grads off the world-1 step by "
          f"{out['step1_grad_max_err_rel_to_tensor_max']} of a tensor's "
          f"largest")


def phase_train_ddp_gloo2(tmp: str) -> dict:
    """Two ranks of the DDP path on the one card (``ddp_rank``, two
    processes this script spawns, both on cuda:0, a gloo group): the only
    run of the default check where K1 and K1-bwd work across ranks. Their
    weights must be bitwise equal at the end, and the first step's loss
    and gradients equal one world-1 step on the concatenated batch within
    RANKS_LOSS_RTOL and RANKS_GRAD_RTOL. A correctness phase, not a speed
    reading."""
    import torch

    ranks, wall_s = _run_ddp_ranks(os.path.join(tmp, "train_ddp_gloo2"), 2,
                                   "gloo")
    out = {"phase": "train_ddp_gloo2", "world": 2, "backend": "gloo",
           "device": torch.cuda.get_device_name(0), "wall_s": wall_s,
           **_check_ranks_against_one_step(ranks, 2)}
    emit(out)
    _assert_ranks(out, "gloo ranks")
    return out


def phase_ddp_cards(tmp: str, world: int) -> dict:
    """``-t DDP`` across ``world`` cards under NCCL, one process per card
    (``chip_smoke.py --cards N``): ``ddp_rank`` on every card, checked as
    ``train_ddp_gloo2`` is; the bf16 step at TRAIN_BATCH per card by CUDA
    events at world 1 and at ``world`` (weak scaling: the same work per
    card, plus the all-reduces); then ``torchrun --standalone
    --nproc_per_node N`` of the training CLI, which must exit 0 with the
    DDP artifacts."""
    import torch

    one, _ = _run_ddp_ranks(os.path.join(tmp, "cards_world1"), 1, "nccl")
    ranks, wall_s = _run_ddp_ranks(os.path.join(tmp, f"cards_{world}"),
                                   world, "nccl")
    checked = _check_ranks_against_one_step(ranks, world)
    step_ms = [r["bf16_step_ms"] for r in ranks]

    sub = os.path.join(tmp, "cards_torchrun")
    os.makedirs(sub)
    env = dict(os.environ,
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    for key in TORCHRUN_ENV:
        env.pop(key, None)
    w, h = IMAGE_WH
    samples = 20 * world  # 20 % val: 4·world val samples, one batch each
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(world), "-m",
           "distributedpytorch_tpu_torch", "-t", "DDP",
           "--synthetic", str(samples), "-v", "20",
           "-b", str(TRAIN_BATCH), "-e", "1", "--image-size", str(w), str(h),
           "--kernels", "cuda"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=sub, env=env, capture_output=True,
                          text=True, timeout=600)
    torchrun_s = time.perf_counter() - t0
    wrote = sorted(os.path.relpath(os.path.join(d, f), sub)
                   for d, _, files in os.walk(sub) for f in files)
    log = ""
    if "logs/DDP.log" in wrote:
        with open(os.path.join(sub, "logs", "DDP.log")) as f:
            log = f.read()
    out = {
        "phase": "ddp_cards", "world": world, "backend": "nccl",
        "device": torch.cuda.get_device_name(0),
        "devices": [torch.cuda.get_device_name(i) for i in range(world)],
        "wall_s": wall_s, **checked,
        "bf16_step_ms_world1": one[0]["bf16_step_ms"],
        "bf16_step_ms_by_rank": step_ms,
        "weak_scaling_efficiency": one[0]["bf16_step_ms"] / max(step_ms),
        "graph": _ranks_graph_rows(ranks, world),
        "torchrun_rc": proc.returncode, "torchrun_s": torchrun_s,
        "torchrun_wrote": wrote,
        "torchrun_ranks_logged": sum(f"(rank {r} of {world})" in log
                                     for r in range(world)),
    }
    emit(out)
    _assert_ranks(out, f"{world} cards")
    _check_ranks_graph(out["graph"], f"DDP on {world} cards")
    check(proc.returncode == 0,
          f"torchrun -t DDP on {world} cards exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    check(wrote == ["checkpoints/DDP.pt", "checkpoints/DDP.pth",
                    "logs/DDP.log", "loss/DDP/train_loss.pkl",
                    "loss/DDP/val_dice.pkl", "loss/DDP/val_loss.pkl"],
          f"torchrun -t DDP on {world} cards wrote {wrote}")
    check(out["torchrun_ranks_logged"] == world,
          f"{out['torchrun_ranks_logged']} of {world} ranks logged")
    return out


def phase_train_milesial_ddp(tmp: str, milesial: dict) -> dict:
    """``-t DDP`` of the full-width milesial at world 1 under NCCL with
    ``train_milesial``'s flags and data (``--wgrad-taps --kernels cuda``,
    DPT_WGRAD_BACKEND=pallas, 4 steps and 1 eval batch, so the running
    statistics can be held against that run's): every BatchNorm on
    global statistics, K2, K3 and K5 launched exactly as on one device,
    the running statistics within DDP_STATS_RTOL of ``train_milesial``'s."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.models.milesial import BatchNormAct

    w, h = IMAGE_WH
    argv = ["-t", "DDP", "--model", "milesial", "--wgrad-taps",
            "--kernels", "cuda", "--dtype", "bf16",
            "--synthetic", str(MILESIAL_SAMPLES), "-v", "20",
            "-b", str(TRAIN_BATCH), "-e", "1",
            "--image-size", str(w), str(h)]
    saved_backend = os.environ.get("DPT_WGRAD_BACKEND")
    os.environ["DPT_WGRAD_BACKEND"] = "pallas"
    try:
        trainer, result, launches, stats, artifacts, timing = (
            _ddp_world_one(os.path.join(tmp, "train_milesial_ddp"), argv,
                           _step_ms(5, 2)))
    finally:
        if saved_backend is None:
            os.environ.pop("DPT_WGRAD_BACKEND", None)
        else:
            os.environ["DPT_WGRAD_BACKEND"] = saved_backend
    bns = [m for m in trainer.model.modules() if isinstance(m, BatchNormAct)]
    check(len(bns) == 18 and all(m.epilogue and m.global_stats
                                 for m in bns),
          "not every BatchNorm runs the epilogue on global statistics")
    steps = result["steps"]
    eval_batches = len(trainer.val_loader)
    check(steps == milesial["steps"] and eval_batches == 1,
          f"{steps} steps, {eval_batches} eval batches")
    losses = [float(x) for x in trainer.records.losses]
    check(all(np.isfinite(losses)), f"non-finite milesial DDP loss {losses}")
    want = {
        "bn_act": 18 * (steps + eval_batches),
        "bn_act_bwd": 18 * steps,
        "wgrad_9tap": 13 * steps,
        "loss_stats": steps + eval_batches,
        "loss_stats_bwd": steps,
    }
    for name, count in want.items():
        check(launches[name] == count,
              f"milesial DDP: {name} launched {launches[name]} times, "
              f"expected {count}")
    ref = milesial["running_stats"]
    stats_err = max(float((stats[n] - t).abs().max() / t.abs().max())
                    for n, t in ref.items())
    out = {
        "phase": "train_milesial_ddp", "world": 1, "backend": "nccl",
        "steps": steps, "eval_batches": eval_batches, "launches": launches,
        "losses": losses, "singleGPU_losses": milesial["losses"],
        "val_loss": result["val_loss"], "val_dice": result["val_dice"],
        "running_stats_max_err_rel_to_tensor_max": stats_err,
        **timing, "train_milesial_step_ms": milesial["step_ms"],
        "train_milesial_device_ms_per_step": milesial["device_ms_per_step"],
        "artifacts": artifacts, "device": torch.cuda.get_device_name(0),
    }
    emit(out)
    check(stats_err <= DDP_STATS_RTOL,
          f"milesial DDP running statistics off singleGPU's by {stats_err}")
    return out


# -t MP and -t DP -----------------------------------------------------------

# the pipeline of the reference's layout: 2 stages, 2 microbatches
MP_STAGES = 2
MP_MICROBATCHES = 2
# train_mp's first loss against train's singleGPU step on the same batch,
# relative: float32 sums of the same bf16 predictions, cuDNN at batch 2
# and at batch 4
MP_LOSS_RTOL = 1e-5
# its first step's weight gradients against the singleGPU step's, and
# 1f1b's against gpipe's, relative to each tensor's largest (as
# STEP_GRAD_RTOL), in float32: in bf16 each microbatch's weight gradient
# comes out of cuDNN rounded to bf16 before the float32 sum over
# microbatches, where the singleGPU step rounds the whole batch's once
# (6.6e-3 of a tensor's largest in the first run of this phase on an H100)
MP_GRAD_RTOL = 1e-3
# the peak-memory comparison: batch 8, so that M = 8 is a microbatch of 1
MP_MEMORY_BATCH = 8


def _with_wgrad_backend(fn):
    """``fn()`` under DPT_WGRAD_BACKEND=pallas, the variable restored."""
    saved = os.environ.get("DPT_WGRAD_BACKEND")
    os.environ["DPT_WGRAD_BACKEND"] = "pallas"
    try:
        return fn()
    finally:
        if saved is None:
            os.environ.pop("DPT_WGRAD_BACKEND", None)
        else:
            os.environ["DPT_WGRAD_BACKEND"] = saved


def _cli_trainer(run: str, argv, devices=None, info=None):
    """The trainer the training CLI builds from ``argv`` with its logging,
    in ``run`` (made here) as the working directory; ``devices`` and
    ``info`` as ``cli.build_trainer`` takes them. Returns ``(trainer,
    close)``: ``close()`` restores the directory and the logging."""
    from distributedpytorch_tpu_torch import cli

    os.makedirs(run)
    args = cli.get_args(argv)
    cwd = os.getcwd()
    os.chdir(run)
    handlers = cli.configure_logging(cli.to_config(args))

    def close():
        root = logging.getLogger()
        for handler in handlers:
            root.removeHandler(handler)
            handler.close()
        os.chdir(cwd)

    try:
        return cli.build_trainer(args, info, devices=devices), close
    except BaseException:
        close()
        raise


def _files(run: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), run)
                  for d, _, files in os.walk(run) for f in files)


def _first_batch(trainer):
    """The first train batch of epoch 0, placed on the trainer's device."""
    return trainer.place_batch(trainer.train_loader.load_slice(
        trainer.train_loader.batch_slices(0)[0]))


def _synthetic_batch(n: int, device) -> dict:
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.data.dataset import (
        SyntheticSegmentationDataset,
    )

    data = SyntheticSegmentationDataset(n, IMAGE_WH, seed=SEED)
    items = [data[i] for i in range(n)]
    return {k: torch.from_numpy(np.stack([it[k] for it in items])).to(device)
            for k in ("image", "mask")}


def _mp_model_step(arch: str, devices, schedule: str, microbatches: int,
                   dtype: str, init=None, lr: float = 0.0, plain=False,
                   batch_size: int = TRAIN_BATCH, **cfg_kw):
    """``(model, step, strategy)``: the MP strategy's train step over
    ``devices`` for the full-width ``arch`` under kernels cuda (SGD at
    ``lr``, 0 by default: the step leaves the weights and keeps the
    gradients), from ``init`` or the seed's weights."""
    import torch

    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.models import create_model
    from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
    from distributedpytorch_tpu_torch.parallel.strategy import build_strategy

    cfg = TrainConfig(train_method="MP", model_arch=arch, dtype=dtype,
                      kernels="cuda", device="cuda", batch_size=batch_size,
                      num_stages=len(devices),
                      num_microbatches=microbatches,
                      pipeline_schedule=schedule, **cfg_kw)
    strategy = build_strategy(cfg, devices=devices)
    model = create_model(cfg, generator=torch.Generator().manual_seed(SEED))
    if init is not None:
        model.load_state_dict(init)
    model = strategy.place_model(model)
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    step = strategy.build_train_step(model, opt, get_kernel_policy("cuda"))
    return model, step, strategy


def _grads(model) -> dict:
    return {n: p.grad.float().clone() for n, p in model.named_parameters()}


def _max_err_rel(a: dict, b: dict) -> float:
    """The largest error of ``a`` against ``b`` relative to each tensor's
    largest element."""
    return max(float((a[n].to(t.device) - t).abs().max() / t.abs().max())
               for n, t in b.items())


def _peak_step_bytes(step, batch) -> dict:
    """The step's peak device memory, after a first step made Adam's (or
    SGD's) state: the peak over the whole allocation and the part above
    what was allocated before the step."""
    import torch

    step(batch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {"peak_bytes": peak, "step_bytes": peak - base}


def phase_train_mp(tmp: str, train: dict) -> dict:
    """``-t MP`` of the full-width UNet through the training CLI's own
    functions, ``--stages 2 --microbatches 2 --synthetic 40 -v 20 -b 4 -e
    2 --dtype bf16 --kernels cuda`` with both stages on cuda:0, once under
    gpipe and once under 1f1b (train's data and seed: 16 steps, 4 eval
    batches). K1 launches M times per step under gpipe and 2M under 1f1b
    (phase A, then the last stage's recomputation), K1-bwd M times, K1
    once per eval batch; the first loss within MP_LOSS_RTOL of train's.
    Then the steady step by CUDA events, the host's time per step and the
    card's busy time per step; one step of each schedule from the seed's
    weights against the singleGPU step on the same batch, in bf16 and in
    float32 (the loss within MP_LOSS_RTOL in both, the float32 gradients
    within MP_GRAD_RTOL); the peak memory of both schedules at M = 2 and
    M = 8 on a batch of 8; and the MP .pth served (K4)."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.models.unet import UNet
    from distributedpytorch_tpu_torch.ops import kernels
    from distributedpytorch_tpu_torch.serve.engine import (
        engine_from_checkpoint,
    )
    from distributedpytorch_tpu_torch.train.steps import make_train_step

    dev = torch.device("cuda", 0)
    w, h = IMAGE_WH
    mb = MP_MICROBATCHES
    out = {"phase": "train_mp", "stages": MP_STAGES, "microbatches": mb,
           "devices": ["cuda:0"] * MP_STAGES,
           "device": torch.cuda.get_device_name(0)}
    for schedule, k1_per_mb in (("gpipe", 1), ("1f1b", 2)):
        run = os.path.join(tmp, f"train_mp_{schedule}")
        ckpt_dir = os.path.join(run, "checkpoints")
        argv = ["-t", "MP", "--stages", str(MP_STAGES), "--microbatches",
                str(mb), "--pipeline-schedule", schedule,
                "--synthetic", str(TRAIN_SAMPLES), "-v", "20",
                "-b", str(TRAIN_BATCH), "-e", str(TRAIN_EPOCHS),
                "--image-size", str(w), str(h), "--dtype", "bf16",
                "--kernels", "cuda", "--checkpoint-dir", ckpt_dir]
        trainer, close = _cli_trainer(run, argv, [dev] * MP_STAGES)
        try:
            check(trainer.kernels.name == "cuda", "policy is not cuda")
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            result = trainer.train()
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
        finally:
            close()
        steps = result["steps"]
        eval_batches = TRAIN_EPOCHS * len(trainer.val_loader)
        losses = [float(x) for x in trainer.records.losses]
        check(steps == train["steps"] and len(losses) == steps
              and all(np.isfinite(losses)),
              f"MP {schedule}: {steps} steps, losses {losses}")
        want = {"loss_stats": steps * mb * k1_per_mb + eval_batches,
                "loss_stats_bwd": steps * mb}
        for name, count in want.items():
            check(launches[name] == count,
                  f"MP {schedule}: {name} launched {launches[name]} times, "
                  f"expected {count}")
        for need in ("logs/MP.log", "checkpoints/MP.pt", "checkpoints/MP.pth",
                     "loss/MP/train_loss.pkl"):
            check(need in _files(run), f"MP {schedule}: missing {need}")
        first_rel = abs(losses[0] - train["losses"][0]) / train["losses"][0]
        check(first_rel <= MP_LOSS_RTOL,
              f"MP {schedule}: first loss {losses[0]} against train's "
              f"{train['losses'][0]}")
        batch = _first_batch(trainer)
        step_ms = cuda_ms(lambda: trainer.train_step(batch), 10, warmup=3)
        host_ms = _host_enqueue_ms(lambda: trainer.train_step(batch))
        top = _top_kernels(lambda: trainer.train_step(batch), 2)
        device_ms = sum(ms for _, ms in top)
        out[schedule] = {
            "steps": steps, "eval_batches": eval_batches,
            "launches": launches, "losses": losses,
            "first_loss_rel_err_vs_train": first_rel,
            "val_loss": result["val_loss"], "val_dice": result["val_dice"],
            "train_s": train_s, "step_ms": step_ms,
            "host_enqueue_ms": host_ms, "device_ms_per_step": device_ms,
            "idle_share": 1.0 - device_ms / step_ms,
            "top_kernels_ms": top[:8],
        }
        if schedule == "gpipe":
            engine = engine_from_checkpoint(
                "MP", checkpoint_dir=ckpt_dir, image_size=IMAGE_WH,
                dtype="bf16", bucket_sizes=(1,), kernels="cuda",
                device="cuda")
            masks, served = _traced_call(
                lambda: engine.infer(np.zeros((1, h, w, 3), np.float32)),
                ("serve_mask",))
            check(masks.shape == (1, h, w) and masks.dtype == np.uint8
                  and served["serve_mask"] == 1,
                  f"serving MP.pth: {masks.shape} {masks.dtype} {served}")
            del engine
            out["served_mp_pth"] = True
        del trainer
    out["train_step_ms"] = train["step_ms"]
    out["train_device_ms_per_step"] = train["device_ms_per_step"]

    # one step of each schedule against the singleGPU step, same weights
    # and batch: bf16 (reported) and float32 (held)
    batch = _synthetic_batch(TRAIN_BATCH, dev)
    init = UNet(generator=torch.Generator().manual_seed(SEED)).state_dict()
    parity = {}
    for dtype, torch_dtype in (("bf16", torch.bfloat16),
                               ("f32", torch.float32)):
        ref = UNet(dtype=torch_dtype)
        ref.load_state_dict(init)
        ref.to(dev)
        ref_loss = float(make_train_step(
            ref, torch.optim.SGD(ref.parameters(), lr=0.0), TRAIN_BATCH,
            train_loss_fused=True)(batch))
        ref_grads = _grads(ref)
        del ref
        row = {"loss_singleGPU": ref_loss}
        grads = {}
        for schedule in ("gpipe", "1f1b"):
            model, step, _ = _mp_model_step("unet", [dev] * MP_STAGES,
                                            schedule, mb, dtype, init=init)
            loss = float(step(batch))
            grads[schedule] = _grads(model)
            row[schedule] = {
                "loss": loss,
                "loss_rel_err": abs(loss - ref_loss) / ref_loss,
                "grad_max_err_rel_to_tensor_max": _max_err_rel(
                    grads[schedule], ref_grads)}
            del model, step
        row["1f1b_vs_gpipe_grad_max_err_rel_to_tensor_max"] = _max_err_rel(
            grads["1f1b"], grads["gpipe"])
        parity[dtype] = row
        del grads, ref_grads
    out["step_parity"] = parity

    # peak memory of each schedule at M = 2 and M = 8 (batch 8)
    big = _synthetic_batch(MP_MEMORY_BATCH, dev)
    memory = {}
    for schedule in ("gpipe", "1f1b"):
        for m in (2, 8):
            torch.cuda.synchronize()
            model, step, _ = _mp_model_step(
                "unet", [dev] * MP_STAGES, schedule, m, "bf16", init=init,
                batch_size=MP_MEMORY_BATCH)
            memory[f"{schedule}_M{m}"] = _peak_step_bytes(step, big)
            del model, step
            torch.cuda.empty_cache()
    out["memory_batch"] = MP_MEMORY_BATCH
    out["memory"] = memory
    emit(out)
    for dtype, row in parity.items():
        for schedule in ("gpipe", "1f1b"):
            check(row[schedule]["loss_rel_err"] <= MP_LOSS_RTOL,
                  f"MP {schedule} {dtype} step loss off singleGPU's: {row}")
    f32 = parity["f32"]
    for schedule in ("gpipe", "1f1b"):
        check(f32[schedule]["grad_max_err_rel_to_tensor_max"]
              <= MP_GRAD_RTOL,
              f"MP {schedule} f32 step grads off singleGPU's: {f32}")
    check(f32["1f1b_vs_gpipe_grad_max_err_rel_to_tensor_max"]
          <= MP_GRAD_RTOL, f"1f1b grads off gpipe's: {f32}")
    check(memory["1f1b_M8"]["peak_bytes"] < memory["gpipe_M8"]["peak_bytes"],
          f"1f1b's peak memory at M = 8 is not below gpipe's: {memory}")
    return out


def _stage_batchnorms(strategy) -> list:
    from distributedpytorch_tpu_torch.models.milesial import BatchNormAct

    return [sum(isinstance(m, BatchNormAct) for m in stage.modules())
            for stage in strategy.stages]


def phase_train_milesial_mp(tmp: str) -> dict:
    """``-t MP`` of the full-width milesial through the training CLI's own
    functions, ``--model milesial --wgrad-taps --kernels cuda --dtype bf16
    -b 4 --microbatches 2`` under DPT_WGRAD_BACKEND=pallas, both stages on
    cuda:0: two train steps and one eval batch under gpipe, then under
    1f1b, each from the seed's weights. Per step K3 launches 18·M times
    and K5 13·M; K2 18·M under gpipe, and under 1f1b 18·M in phase A, one
    per BatchNorm of the stages before the last per microbatch in phase
    B's forward ticks and 18·M in its recomputations; the eval batch,
    microbatched too, 18·M more. The running statistics after step 1 are bitwise equal between
    the schedules (the same forwards in the same order). Then one float32
    step of each schedule with the kernels against the same step with
    every kernel swapped for its plain version on the card, and the
    steady step of each schedule timed."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.models.milesial import BatchNormAct
    from distributedpytorch_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    w, h = IMAGE_WH
    mb = MP_MICROBATCHES
    steps = 2
    out = {"phase": "train_milesial_mp", "stages": MP_STAGES,
           "microbatches": mb, "steps": steps,
           "device": torch.cuda.get_device_name(0)}
    stats_after_1 = {}

    def drive(schedule):
        argv = ["-t", "MP", "--model", "milesial", "--wgrad-taps",
                "--kernels", "cuda", "--dtype", "bf16", "--synthetic", "8",
                "-v", "50", "-b", str(TRAIN_BATCH), "--microbatches",
                str(mb), "--pipeline-schedule", schedule,
                "--image-size", str(w), str(h)]
        trainer, close = _cli_trainer(
            os.path.join(tmp, f"train_milesial_mp_{schedule}"), argv,
            [dev] * MP_STAGES)
        try:
            bns = [m for m in trainer.model.modules()
                   if isinstance(m, BatchNormAct)]
            check(len(bns) == 18 and all(m.epilogue for m in bns),
                  "the BatchNorm epilogue is not engaged on all 18")
            batch = _first_batch(trainer)
            torch.cuda.synchronize()
            kernels.reset_launches()
            losses = []
            for i in range(steps):
                losses.append(float(trainer.train_step(batch)))
                if i == 0:
                    stats_after_1[schedule] = {
                        n: b.clone() for n, b in
                        trainer.model.named_buffers() if "running" in n}
            eval_metrics = trainer.eval_step(batch)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            step_ms = cuda_ms(lambda: trainer.train_step(batch), 3, warmup=1)
            host_ms = _host_enqueue_ms(lambda: trainer.train_step(batch))
            per_stage = _stage_batchnorms(trainer.strategy)
        finally:
            close()
        check(all(np.isfinite(losses))
              and np.isfinite(float(eval_metrics["loss"])),
              f"milesial MP {schedule}: losses {losses}")
        k2 = 18 * mb if schedule == "gpipe" else mb * (36 + sum(
            per_stage[:-1]))
        want = {"bn_act": steps * k2 + 18 * mb,
                "bn_act_bwd": steps * 18 * mb,
                "wgrad_9tap": steps * 13 * mb,
                "loss_stats": steps * mb * (1 if schedule == "gpipe" else 2)
                + 1,
                "loss_stats_bwd": steps * mb}
        for name, count in want.items():
            check(launches[name] == count,
                  f"milesial MP {schedule}: {name} launched "
                  f"{launches[name]} times, expected {count}")
        out[schedule] = {"launches": launches, "losses": losses,
                         "batchnorms_per_stage": per_stage,
                         "eval_loss": float(eval_metrics["loss"]),
                         "step_ms": step_ms, "host_enqueue_ms": host_ms}

    _with_wgrad_backend(lambda: [drive(s) for s in ("gpipe", "1f1b")])
    same = all(torch.equal(stats_after_1["gpipe"][n], t)
               for n, t in stats_after_1["1f1b"].items())
    out["running_stats_after_step1_bitwise_equal"] = same

    # float32: the kernels against their plain versions, in place
    batch = _synthetic_batch(TRAIN_BATCH, dev)

    def in_place():
        for schedule in ("gpipe", "1f1b"):
            runs = {}
            for plain in (False, True):
                model, step, _ = _mp_model_step(
                    "milesial", [dev] * MP_STAGES, schedule, mb, "f32",
                    wgrad_taps=True)
                kernels.reset_launches()
                if plain:
                    with _PlainVersions():
                        loss = float(step(batch))
                else:
                    loss = float(step(batch))
                runs[plain] = {
                    "loss": loss, "launches": dict(kernels.LAUNCHES),
                    "grads": _grads(model),
                    "stats": {n: b.clone() for n, b in model.named_buffers()
                              if "running" in n}}
                del model, step
            check(not any(runs[True]["launches"].values()),
                  f"plain versions launched {runs[True]['launches']}")
            a, b = runs[False], runs[True]
            rel_l2 = {n: float((a["grads"][n] - g).norm() / g.norm())
                      for n, g in b["grads"].items()}
            diff = torch.cat([(a["grads"][n] - g).flatten()
                              for n, g in b["grads"].items()])
            whole = torch.cat([g.flatten() for g in b["grads"].values()])
            out[f"f32_{schedule}_kernels_vs_plain_versions"] = {
                "launches": a["launches"],
                "loss_rel_err": abs(a["loss"] - b["loss"]) / b["loss"],
                "grad_global_rel_l2": float(diff.norm() / whole.norm()),
                "grad_max_rel_l2": max(rel_l2.values()),
                "grad_worst_tensor": max(rel_l2, key=rel_l2.get),
                "running_stats_bitwise_equal": all(
                    torch.equal(a["stats"][n], t)
                    for n, t in b["stats"].items()),
            }

    _with_wgrad_backend(in_place)
    emit(out)
    check(same, "milesial MP running statistics after step 1 differ "
                "between gpipe and 1f1b")
    for schedule in ("gpipe", "1f1b"):
        got = out[f"f32_{schedule}_kernels_vs_plain_versions"]
        check(got["running_stats_bitwise_equal"]
              and got["loss_rel_err"] <= IN_PLACE_LOSS_RTOL
              and got["grad_global_rel_l2"] <= IN_PLACE_GRAD_GLOBAL_REL_L2
              and got["grad_max_rel_l2"] <= IN_PLACE_GRAD_REL_L2,
              f"milesial MP {schedule} f32, kernels vs plain versions: "
              f"{got}")
    return out


def phase_train_dp(tmp: str, train: dict) -> dict:
    """``-t DP`` on the one card through the training CLI's own functions
    with train's flags, data and seed: the strategy takes every visible
    card, one here, and the replica is the model itself. Every loss is
    bitwise equal to train's (40 samples at -v 20 -b 4 leave no ragged
    batch for DP's drop_last), K1 launches once per step and eval batch,
    K1-bwd once per step. Then two steps of the full-width milesial under
    DP with ``--wgrad-taps`` (DPT_WGRAD_BACKEND=pallas): K2, K3 and K5
    launch 18, 18 and 13 times per step in the replica. Then, on
    ``[cuda:0, cuda:0]`` (two replica threads on the one card), the bf16
    UNet and milesial as one CUDA graph of GS_K steps against their eager
    steps (``_dp_graph_run``), and milesial under ``--remat`` against the
    plain DP step (``_dp_remat_run``)."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.ops import kernels

    w, h = IMAGE_WH
    argv = ["-t", "DP", "--synthetic", str(TRAIN_SAMPLES), "-v", "20",
            "-b", str(TRAIN_BATCH), "-e", str(TRAIN_EPOCHS),
            "--image-size", str(w), str(h), "--dtype", "bf16",
            "--kernels", "cuda"]
    run = os.path.join(tmp, "train_dp")
    trainer, close = _cli_trainer(run, argv)
    try:
        devices = [str(d) for d in trainer.strategy.devices]
        torch.cuda.synchronize()
        kernels.reset_launches()
        result = trainer.train()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        batch = _first_batch(trainer)
        step_ms = cuda_ms(lambda: trainer.train_step(batch), 10, warmup=3)
        host_ms = _host_enqueue_ms(lambda: trainer.train_step(batch))
    finally:
        close()
    steps = result["steps"]
    eval_batches = TRAIN_EPOCHS * len(trainer.val_loader)
    losses = [float(x) for x in trainer.records.losses]
    check(devices == [f"cuda:{i}" for i in range(torch.cuda.device_count())],
          f"DP devices {devices}")
    for name, count in (("loss_stats", steps + eval_batches),
                        ("loss_stats_bwd", steps)):
        check(launches[name] == count,
              f"DP: {name} launched {launches[name]} times, expected "
              f"{count}")
    check("checkpoints/DP.pth" in _files(run), f"DP wrote {_files(run)}")
    del trainer

    def milesial():
        argv = ["-t", "DP", "--model", "milesial", "--wgrad-taps",
                "--kernels", "cuda", "--dtype", "bf16", "--synthetic", "8",
                "-v", "50", "-b", str(TRAIN_BATCH),
                "--image-size", str(w), str(h)]
        trainer, close = _cli_trainer(os.path.join(tmp, "train_milesial_dp"),
                                      argv)
        try:
            batch = _first_batch(trainer)
            torch.cuda.synchronize()
            kernels.reset_launches()
            m_losses = [float(trainer.train_step(batch)) for _ in range(2)]
            torch.cuda.synchronize()
            return m_losses, dict(kernels.LAUNCHES)
        finally:
            close()

    m_losses, m_launches = _with_wgrad_backend(milesial)
    out = {
        "phase": "train_dp", "devices": devices, "steps": steps,
        "eval_batches": eval_batches, "launches": launches,
        "losses": losses,
        "losses_bitwise_equal_to_train": losses == train["losses"],
        "val_loss": result["val_loss"], "val_dice": result["val_dice"],
        "step_ms": step_ms, "host_enqueue_ms": host_ms,
        "train_step_ms": train["step_ms"],
        "milesial_losses": m_losses, "milesial_launches": m_launches,
        "device": torch.cuda.get_device_name(0),
    }
    emit(out)
    check(out["losses_bitwise_equal_to_train"],
          f"DP losses {losses} against train's {train['losses']}")
    check(all(np.isfinite(m_losses)), f"milesial DP losses {m_losses}")
    for name, count in (("bn_act", 18 * 2), ("bn_act_bwd", 18 * 2),
                        ("wgrad_9tap", 13 * 2)):
        check(m_launches[name] == count,
              f"milesial DP: {name} launched {m_launches[name]} times, "
              f"expected {count}")
    dev0 = torch.device("cuda", 0)
    out["graphs"] = {arch: _dp_graph_run(arch, b, [dev0, dev0])
                     for arch, b in DP_GRAPH_BATCH.items()}
    out["remat"] = _dp_remat_run([dev0, dev0])
    return out


# -t DP as one CUDA graph of GS_K steps and under --remat: the bf16 UNet
# and milesial with --wgrad-taps (DPT_WGRAD_BACKEND=pallas), full width,
# on [cuda:0, cuda:0] in train_dp (two replica threads on the one card,
# which the strategy's default of every visible card never runs there)
# and across every card in dp_cards (DP_CARDS_BATCH)
DP_GRAPH_BATCH = {"unet": 8, "milesial": 4}
# through the multi-step: its eager warm-up, the capture's, one replay
DP_GRAPH_STACKS = 3


def _strategy_config(method: str, arch: str, batch_size: int = TRAIN_BATCH,
                     dtype: str = "bf16", **kw):
    """``method``'s config of the full-width ``arch`` under kernels cuda on
    the card, milesial with ``--wgrad-taps``."""
    from distributedpytorch_tpu_torch.config import TrainConfig

    return TrainConfig(train_method=method, model_arch=arch, dtype=dtype,
                       kernels="cuda", device="cuda", batch_size=batch_size,
                       wgrad_taps=arch == "milesial", **kw)


def _dp_expected_per_replay(arch: str, replicas: int) -> dict:
    """The kernels one replay of GS_K DP steps runs: K1 and K1-bwd once
    per step on the first card; milesial's K2, K3 and K5 18, 18 and 13
    times per step in every replica."""
    want = {"loss_stats": GS_K, "loss_stats_bwd": GS_K}
    if arch == "milesial":
        want.update(bn_act=GS_K * 18 * replicas,
                    bn_act_bwd=GS_K * 18 * replicas,
                    wgrad_9tap=GS_K * 13 * replicas)
    return want


def _graph_run(cfg, devices, want: dict) -> dict:
    """``cfg``'s strategy (``-t DP`` or ``-t SP``) over ``devices`` at K =
    GS_K against its eager steps from the seed's weights, with the same
    capturable Adam (``_graph_and_eager``: cuDNN deterministic, the
    losses and a digest of the weights and buffers after every stack,
    guards on every card), a replay's kernels counted by name in the
    graph's nodes and in the profiler's trace (``_replay_launches``), then
    both timed (``_timed_sides``: step and host ms per step, each card's
    busy ms, the idle share as ``bubble``, ``cudaGraphLaunch``'s host
    ms). Emits the row and fails unless the graph is bitwise its eager
    steps, the guards are intact and a replay launches ``want``
    (``_check_replay``)."""
    import torch

    arch = cfg.model_arch

    def run():
        stacks = _rolled_stacks(_synthetic_batch(GS_K * cfg.batch_size,
                                                 devices[0]),
                                GS_K, DP_GRAPH_STACKS)
        with _keeping_graphs():
            sides = _graph_and_eager(_graph_build(cfg, devices), stacks,
                                     GS_K)
        multi = sides["graph"]["multi"]
        launches = _replay_launches(multi, lambda: multi(stacks[0]),
                                    tuple(want))
        row = {"phase": f"{cfg.train_method.lower()}_graph", "arch": arch,
               "batch": cfg.batch_size,
               "devices": [str(d) for d in devices], "k": GS_K,
               "cudnn_deterministic": True,
               "bitwise_equal_to_eager": sides["bitwise_equal"],
               "guards_intact": all(sides[m]["guards_intact"]
                                    for m in ("eager", "graph")),
               "graph_launches_per_replay": launches["nodes"],
               "traced_launches_per_replay": launches["traced"],
               "expected_per_replay": want,
               **_timed_sides(sides, stacks[0], GS_K, devices),
               "device": torch.cuda.get_device_name(0)}
        del sides, stacks, multi
        torch.cuda.empty_cache()
        return row

    row = _with_wgrad_backend(run) if arch == "milesial" else run()
    emit(row)
    what = f"{cfg.train_method} {arch} graph on {row['devices']}"
    check(row["bitwise_equal_to_eager"] and row["guards_intact"],
          f"{what}: off its eager steps, or wrote into eager memory")
    _check_replay(what, {"nodes": row["graph_launches_per_replay"],
                         "traced": row["traced_launches_per_replay"]}, want)
    return row


def _dp_graph_run(arch: str, batch_size: int, devices) -> dict:
    """``-t DP`` of ``arch`` over ``devices`` as one CUDA graph of GS_K
    steps against its eager steps (``_graph_run``)."""
    return _graph_run(_strategy_config("DP", arch, batch_size), devices,
                      _dp_expected_per_replay(arch, len(devices)))


def _remat_run(method: str, arch: str, devices, want: dict) -> dict:
    """``arch`` under ``-t {method} --remat`` over ``devices`` against the
    plain step of ``method``, bf16, full width, ``-b 4``, SGD at lr 0 (the
    weights stay, the gradients are kept), cuDNN deterministic: the loss,
    every gradient and the running statistics bitwise equal, the remat
    step's launches ``want`` (milesial's K2 twice per BatchNorm, the
    recompute's, K3 and K5 once), the peak memory above the step's start
    below the plain step's, and both steps' ms."""
    import torch

    from distributedpytorch_tpu_torch.models import create_model
    from distributedpytorch_tpu_torch.ops import kernels
    from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
    from distributedpytorch_tpu_torch.parallel.strategy import build_strategy

    def one(remat: bool) -> dict:
        cfg = _strategy_config(method, arch, remat=remat)
        strategy = build_strategy(cfg, devices=devices)
        model = strategy.place_model(create_model(
            cfg, generator=torch.Generator().manual_seed(SEED)))
        step = strategy.build_train_step(
            model, torch.optim.SGD(model.parameters(), lr=0.0),
            get_kernel_policy("cuda"))
        batch = _synthetic_batch(TRAIN_BATCH, devices[0])
        kernels.reset_launches()
        loss = float(step(batch))
        torch.cuda.synchronize()
        out = {"loss": loss, "launches": dict(kernels.LAUNCHES),
               "grads": _grads(model), "stats": _running_stats(model)}
        out.update(_peak_step_bytes(step, batch))
        out["step_ms"] = cuda_ms(lambda: step(batch), 3, warmup=1)
        del model, step
        torch.cuda.empty_cache()
        return out

    def both():
        with _deterministic_cudnn():
            return one(False), one(True)

    plain, remat = _with_wgrad_backend(both) if arch == "milesial" else both()
    row = {"phase": f"{method.lower()}_remat", "arch": arch,
           "batch": TRAIN_BATCH, "devices": [str(d) for d in devices],
           "cudnn_deterministic": True,
           "loss_bitwise_equal": remat["loss"] == plain["loss"],
           "grads_bitwise_equal": all(
               torch.equal(remat["grads"][k], g)
               for k, g in plain["grads"].items()),
           "running_stats_bitwise_equal": all(
               torch.equal(remat["stats"][k], t)
               for k, t in plain["stats"].items()),
           "launches_per_step": {"plain": plain["launches"],
                                 "remat": remat["launches"]},
           "expected_remat_per_step": want,
           **{key: {"plain": plain[key], "remat": remat[key]}
              for key in ("peak_bytes", "step_bytes", "step_ms")},
           "device": torch.cuda.get_device_name(0)}
    row["step_bytes_share"] = (row["step_bytes"]["remat"]
                               / row["step_bytes"]["plain"])
    emit(row)
    what = f"{method} {arch} remat"
    check(row["loss_bitwise_equal"] and row["grads_bitwise_equal"]
          and row["running_stats_bitwise_equal"],
          f"{what} against the plain {method} step: {row}")
    got = row["launches_per_step"]["remat"]
    check(all(got[k] == v for k, v in want.items()),
          f"{what} launched {got}, expected {want}")
    check(row["step_bytes"]["remat"] < row["step_bytes"]["plain"],
          f"{what} does not lower the step's memory: {row['step_bytes']}")
    return row


def _dp_remat_run(devices) -> dict:
    """milesial ``--wgrad-taps`` under ``-t DP --remat`` over ``devices``
    against the plain DP step (``_remat_run``): K2 twice per BatchNorm
    and replica, K3 and K5 once."""
    n = len(devices)
    return _remat_run("DP", "milesial", devices,
                      {"bn_act": 36 * n, "bn_act_bwd": 18 * n,
                       "wgrad_9tap": 13 * n})


def _sync_all(devices=None) -> None:
    """Wait for ``devices`` (default: every visible card)."""
    import torch

    if devices is None:
        devices = range(torch.cuda.device_count())
    for dev in devices:
        torch.cuda.synchronize(dev)


def _busy_ms_by_device(fn, runs: int, devices=None) -> dict:
    """``{device index: ms}``: the union of the kernel intervals each card
    ran during ``runs`` calls of ``fn``, per call, by the profiler's
    clock; ``devices`` are waited for as ``_sync_all`` does."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        _sync_all(devices)
    spans = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.setdefault(evt.device_index, []).append(
            (evt.time_range.start, evt.time_range.end))
    busy = {}
    for index, intervals in spans.items():
        intervals.sort()
        total, end = 0.0, float("-inf")
        for a, b in intervals:
            if b <= end:
                continue
            total += b - max(a, end)
            end = b
        busy[index] = total / runs / 1e3
    return busy


#: the kernels' function names in the profiler's trace, by launch counter
#: (K3's wrapper launches a partial and a final kernel, K5's its tile
#: kernel and, when split, a sum: the first of each is counted)
KERNEL_SYMBOLS = {"serve_mask": "serve_mask_kernel",
                  "loss_stats": "stats_kernel",
                  "loss_stats_bwd": "stats_bwd_kernel",
                  "bn_act": "bn_act_kernel",
                  "bn_act_bwd": "bn_act_bwd_partial_kernel",
                  "wgrad_9tap": "wgrad_(?:bf16|f32)_kernel"}
LOSS_KERNELS = ("loss_stats", "loss_stats_bwd")


#: traces ``_traced_launches`` takes of one call: the profiler can drop a
#: kernel's record from a busy trace (a replay of a graph of thousands of
#: kernels lost one or two of them on an H100, late in a long process,
#: while its results stayed bitwise its eager steps'), and never adds
#: one; so a replay's exact count is its graph's nodes (``_graph_kernels``)
TRACES_PER_COUNT = 3


def _traced_launches(fn, names=LOSS_KERNELS) -> dict:
    """``{counter name: n}``: the kernels of ``names`` that the card ran
    during one call of ``fn``, counted by function name in the profiler's
    trace, not by the wrappers' counters: each name's largest count over
    TRACES_PER_COUNT traces, one call of ``fn`` each."""
    counts = [_traced_call(fn, names)[1] for _ in range(TRACES_PER_COUNT)]
    return {name: max(c[name] for c in counts) for name in names}


@contextlib.contextmanager
def _keeping_graphs():
    """Within the block every ``torch.cuda.CUDAGraph()`` is made with
    ``keep_graph=True``: it keeps its cudaGraph_t, whose nodes
    ``_graph_kernels`` reads, and is instantiated at its first replay."""
    import torch

    made = torch.cuda.CUDAGraph

    def keeping(keep_graph: bool = False):
        return made(keep_graph=True)

    torch.cuda.CUDAGraph = keeping
    try:
        yield
    finally:
        torch.cuda.CUDAGraph = made


def _kernel_identifier(symbol: str) -> str:
    """The kernel's own name in a mangled symbol, without its namespaces,
    template arguments or parameters
    (``_ZN12_GLOBAL__N_113bn_act_kernelI13__nv_bfloat16EEv...`` →
    ``bn_act_kernel``); a symbol that is not mangled as it is."""
    if not symbol.startswith("_Z"):
        return symbol
    i = 3 if symbol[2:3] in ("N", "L") else 2
    ident = symbol
    while i < len(symbol) and symbol[i].isdigit():
        j = i
        while j < len(symbol) and symbol[j].isdigit():
            j += 1
        ident, i = symbol[j:j + int(symbol[i:j])], j + int(symbol[i:j])
    return ident


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of the CUDA driver API."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _graph_kernels(graph, names=LOSS_KERNELS) -> dict:
    """``{counter name: n}``: the kernel nodes of ``names`` in ``graph``
    (a ``torch.cuda.CUDAGraph`` made under ``_keeping_graphs``), by
    function name through the CUDA driver: what each replay launches,
    since a replay runs every node of its graph."""
    import re

    cu = ctypes.CDLL("libcuda.so.1")
    for fn, args in (
            ("cuGraphGetNodes", [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_size_t)]),
            ("cuGraphNodeGetType", [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_int)]),
            ("cuGraphKernelNodeGetParams_v2", [
                ctypes.c_void_p, ctypes.POINTER(_KernelNodeParams)]),
            ("cuFuncGetName", [ctypes.POINTER(ctypes.c_char_p),
                               ctypes.c_void_p]),
            ("cuKernelGetName", [ctypes.POINTER(ctypes.c_char_p),
                                 ctypes.c_void_p])):
        getattr(cu, fn).argtypes = args

    def call(fn, *args):
        err = getattr(cu, fn)(*args)
        check(err == 0, f"{fn}: CUDA driver error {err}")

    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    call("cuGraphGetNodes", handle, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    call("cuGraphGetNodes", handle, nodes, ctypes.byref(n))
    symbols = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        call("cuGraphNodeGetType", node, ctypes.byref(kind))
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = _KernelNodeParams()
        call("cuGraphKernelNodeGetParams_v2", node, ctypes.byref(params))
        name = ctypes.c_char_p()
        # a node holds a function, or else a library's kernel
        if params.func:
            call("cuFuncGetName", ctypes.byref(name), params.func)
        else:
            call("cuKernelGetName", ctypes.byref(name), params.kern)
        symbols.append(_kernel_identifier(name.value.decode()))
    return {name: sum(bool(re.fullmatch(KERNEL_SYMBOLS[name], s))
                      for s in symbols)
            for name in names}


def _replay_launches(multi, fn, names) -> dict:
    """A replay's kernels of ``names``, twice: ``nodes``, the kernel nodes
    of the graph ``multi`` (a ``MultiStep`` captured under
    ``_keeping_graphs``) replays, and ``traced``, what the card ran during
    one call of ``fn`` by the profiler's trace (``_traced_launches``)."""
    return {"nodes": _graph_kernels(multi._graph, names),
            "traced": _traced_launches(fn, names)}


def _check_replay(what: str, launches: dict, want: dict) -> None:
    """A replay launches exactly ``want``: its graph holds those kernel
    nodes, and the trace saw each of them run, never more than the graph
    holds (a trace of a large replay can lose a record, never add one)."""
    nodes, traced = launches["nodes"], launches["traced"]
    check(nodes == want,
          f"{what}: a replay's graph holds {nodes}, not {want}")
    check(all(0 < traced[name] <= nodes[name] for name in want),
          f"{what}: the trace of a replay saw {traced} of the graph's "
          f"{nodes}")


def _traced_call(fn, names) -> tuple:
    """``(fn(), _traced_launches' counts)`` of one call of ``fn``; the
    trace holds the kernels every thread of the process ran."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels = [evt.name for evt in prof.events()
               if evt.device_type == torch.autograd.DeviceType.CUDA]
    return out, {
        name: sum(bool(re.search(rf"\b{KERNEL_SYMBOLS[name]}\b", k))
                  for k in kernels)
        for name in names}


def _wall_ms(fn, iters: int, warmup: int, devices=None) -> float:
    """Host milliseconds per call of ``fn`` with every card (or each of
    ``devices``) drained before and after: the step's wall time across
    cards."""
    for _ in range(warmup):
        fn()
    _sync_all(devices)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync_all(devices)
    return (time.perf_counter() - t0) * 1e3 / iters


def phase_mp_cards(world: int) -> dict:
    """``-t MP`` of the full-width bf16 UNet across cards (``--cards``): at
    S = 2 on cuda:0/cuda:1, the reference's layout, and at S = 4 on four
    cards, under gpipe and 1f1b at M = 2 and M = 8 (batch 8). For each:
    the step's wall time, every stage card's busy time by the profiler
    and the bubble it leaves, 1 − mean busy / step, beside gpipe's
    (S − 1)/(M + S − 1); the same pipeline with every stage on cuda:0,
    whose first loss the cards' must equal within MP_LOSS_RTOL; and the
    pipeline across the cards as one CUDA graph of GS_K steps against
    the eager steps with the same capturable Adam (``_graph_and_eager``:
    three stacks, losses and weights bitwise, guards on every card
    intact), both timed (``_timed_sides``)."""
    import torch

    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.models.unet import UNet

    batch = _synthetic_batch(MP_MEMORY_BATCH, torch.device("cuda", 0))
    stacks = _rolled_stacks(_synthetic_batch(
        MP_MEMORY_BATCH * GS_K, torch.device("cuda", 0)), GS_K, 3)
    init = UNet(generator=torch.Generator().manual_seed(SEED)).state_dict()
    out = {"phase": "mp_cards", "batch": MP_MEMORY_BATCH,
           "devices": [torch.cuda.get_device_name(i) for i in range(world)]}
    for stages in (s for s in (2, 4) if s <= world):
        for schedule in ("gpipe", "1f1b"):
            for m in (2, 8):
                row = {}
                for layout, devices in (
                        ("cards", [torch.device("cuda", i)
                                   for i in range(stages)]),
                        ("one_card", [torch.device("cuda", 0)] * stages)):
                    model, step, _ = _mp_model_step(
                        "unet", devices, schedule, m, "bf16", init=init,
                        batch_size=MP_MEMORY_BATCH)
                    first = float(step(batch))
                    step_ms = _wall_ms(lambda: step(batch), 5, warmup=2)
                    busy = _busy_ms_by_device(lambda: step(batch), 2)
                    row[layout] = {"first_loss": first, "step_ms": step_ms,
                                   "busy_ms_by_card": busy}
                    if layout == "cards":
                        row["bubble_measured"] = 1.0 - sum(
                            busy.get(i, 0.0) for i in range(stages)
                        ) / stages / step_ms
                    del model, step
                    torch.cuda.empty_cache()
                devices = [torch.device("cuda", i) for i in range(stages)]
                sides = _graph_and_eager(_graph_build(TrainConfig(
                    train_method="MP", dtype="bf16", kernels="cuda",
                    device="cuda", batch_size=MP_MEMORY_BATCH,
                    num_stages=stages, num_microbatches=m,
                    pipeline_schedule=schedule, steps_per_dispatch=GS_K),
                    devices, init), stacks, GS_K)
                row["graph"] = {
                    "bitwise_equal_to_eager": sides["bitwise_equal"],
                    "guards_intact": all(sides[x]["guards_intact"]
                                         for x in ("eager", "graph")),
                    **_timed_sides(sides, stacks[0], GS_K, devices)}
                row["graph"]["bubble_eager_vs_graph"] = [
                    row["graph"][x]["bubble"] for x in ("eager", "graph")]
                del sides
                torch.cuda.empty_cache()
                row["bubble_gpipe_formula"] = (stages - 1) / (m + stages - 1)
                row["cards_speedup_over_one_card"] = (
                    row["one_card"]["step_ms"] / row["cards"]["step_ms"])
                row["first_loss_rel_err"] = abs(
                    row["cards"]["first_loss"] - row["one_card"]["first_loss"]
                ) / row["one_card"]["first_loss"]
                out[f"S{stages}_{schedule}_M{m}"] = row
    emit(out)
    for key, row in out.items():
        if key.startswith("S"):
            check(row["first_loss_rel_err"] <= MP_LOSS_RTOL,
                  f"MP {key}: cards' loss off the one-card pipeline's: "
                  f"{row['first_loss_rel_err']}")
            check(row["graph"]["bitwise_equal_to_eager"]
                  and row["graph"]["guards_intact"],
                  f"MP {key}: the graph across cards is off its eager "
                  f"steps, or wrote into eager memory")
    return out


# -t DP across cards: the one-card reference step holds the whole batch
# in float32, so milesial's batch is 8 (2 per card), the UNet's 16
DP_CARDS_BATCH = {"unet": 16, "milesial": 8}
DP_CARDS_LOSS_RTOL = 1e-5
# the UNet's gradients relative to each tensor's largest (cuDNN sums a
# batch of 4 per card and of 16 on one card in other orders)
DP_CARDS_GRAD_RTOL = 1e-3
# milesial's by each tensor's relative L2 error, MILESIAL_PARITY's float32
# bound: the bias of an upconv in front of a conv and a BatchNorm is left
# by the BatchNorm's shift invariance with its border terms only, and a
# gradient that nearly cancels carries the other summation order as a
# larger error of its largest element (1.24e-2 of it in the first run of
# this phase, on four H100s)
DP_CARDS_MILESIAL_GRAD_REL_L2 = MILESIAL_PARITY["f32"]["grad_rel_l2"]
DP_CARDS_STATS_RTOL = 1e-4


def phase_dp_cards(world: int) -> dict:
    """``-t DP`` over ``world`` cards in one process: the full-width UNet
    at batch 16 and milesial at batch 8, float32, kernels cuda, one step
    from the seed's weights against a one-card step on the same batch:
    the loss within DP_CARDS_LOSS_RTOL, the UNet's gradients within
    DP_CARDS_GRAD_RTOL of each tensor's largest, milesial's within
    DP_CARDS_MILESIAL_GRAD_REL_L2 relative L2 and its running statistics
    within DP_CARDS_STATS_RTOL. Then the bf16 UNet step at batch 16 over
    the cards and on one card, by wall time, with each card's busy time
    and the host's operators: the per-step cost of replicating the
    weights and gathering the predictions against the split compute.
    Then the bf16 UNet at batch 16 and milesial ``--wgrad-taps`` at batch
    8 over the cards as one CUDA graph of GS_K steps against their eager
    steps (``_dp_graph_run``: bitwise, guards on every card, step, host,
    each card's busy and ``cudaGraphLaunch``'s ms per step)."""
    import torch

    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.models import create_model
    from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
    from distributedpytorch_tpu_torch.parallel.strategy import build_strategy

    dev0 = torch.device("cuda", 0)
    cards = [torch.device("cuda", i) for i in range(world)]
    out = {"phase": "dp_cards", "world": world,
           "devices": [torch.cuda.get_device_name(i) for i in range(world)]}

    def dp_step(arch, devices, dtype, batch_size, lr=0.0):
        cfg = TrainConfig(train_method="DP", model_arch=arch, dtype=dtype,
                          kernels="cuda", device="cuda",
                          batch_size=batch_size)
        strategy = build_strategy(cfg, devices=devices)
        model = create_model(cfg, generator=torch.Generator().manual_seed(
            SEED))
        model = strategy.place_model(model)
        opt = torch.optim.SGD(model.parameters(), lr=lr)
        return model, strategy.build_train_step(model, opt,
                                                get_kernel_policy("cuda"))

    for arch, b in DP_CARDS_BATCH.items():
        batch = _synthetic_batch(b, dev0)
        runs = {}
        for layout, devices in (("cards", cards), ("one_card", [dev0])):
            model, step = dp_step(arch, devices, "f32", b)
            runs[layout] = {
                "loss": float(step(batch)), "grads": _grads(model),
                "stats": {n: t.clone() for n, t in model.named_buffers()
                          if "running" in n}}
            del model, step
            torch.cuda.empty_cache()
        a, ref = runs["cards"], runs["one_card"]
        rel_l2 = {n: float((a["grads"][n] - g).norm() / g.norm())
                  for n, g in ref["grads"].items()}
        worst = max(rel_l2, key=rel_l2.get)
        row = {"batch": b,
               "loss_cards": a["loss"], "loss_one_card": ref["loss"],
               "loss_rel_err": abs(a["loss"] - ref["loss"]) / ref["loss"],
               "grad_max_err_rel_to_tensor_max": _max_err_rel(a["grads"],
                                                              ref["grads"]),
               "grad_max_rel_l2": rel_l2[worst], "grad_worst_tensor": worst,
               "grad_median_rel_l2": sorted(rel_l2.values())[
                   len(rel_l2) // 2]}
        if ref["stats"]:
            row["running_stats_max_err_rel_to_tensor_max"] = _max_err_rel(
                a["stats"], ref["stats"])
        out[arch] = row
        del runs, a, ref
    batch = _synthetic_batch(DP_CARDS_BATCH["unet"], dev0)
    for layout, devices in (("cards", cards), ("one_card", [dev0])):
        _, step = dp_step("unet", devices, "bf16", DP_CARDS_BATCH["unet"],
                          lr=1e-4)
        out[f"bf16_unet_step_ms_{layout}"] = _wall_ms(lambda: step(batch), 5,
                                                      warmup=2)
        out[f"bf16_unet_busy_ms_by_card_{layout}"] = _busy_ms_by_device(
            lambda: step(batch), 2)
        if layout == "cards":
            out["bf16_unet_top_host_ops_cards"] = _top_host_ops(
                lambda: step(batch), 2)[:12]
        del step
    out["bf16_unet_speedup"] = (out["bf16_unet_step_ms_one_card"]
                                / out["bf16_unet_step_ms_cards"])
    emit(out)
    out["graphs"] = {arch: _dp_graph_run(arch, b, cards)
                     for arch, b in DP_CARDS_BATCH.items()}
    for arch in DP_CARDS_BATCH:
        row = out[arch]
        check(row["loss_rel_err"] <= DP_CARDS_LOSS_RTOL,
              f"DP {arch} across cards: loss {row}")
        if arch == "milesial":
            check(row["grad_max_rel_l2"] <= DP_CARDS_MILESIAL_GRAD_REL_L2,
                  f"DP {arch} across cards: grads {row}")
        else:
            check(row["grad_max_err_rel_to_tensor_max"]
                  <= DP_CARDS_GRAD_RTOL, f"DP {arch} across cards: {row}")
        check(row.get("running_stats_max_err_rel_to_tensor_max", 0.0)
              <= DP_CARDS_STATS_RTOL,
              f"DP {arch} across cards: running statistics {row}")
    return out


# -t DDP_MP -------------------------------------------------------------------

# the runs of each DDP_MP rank: model, schedule and steps, S = 2 stages and
# -b 4 per rank in M = 2 microbatches, bf16, milesial with --wgrad-taps
# under DPT_WGRAD_BACKEND=pallas
DDP_MP_RUNS = (("unet", "gpipe", 3), ("unet", "1f1b", 3),
               ("milesial", "gpipe", 2), ("milesial", "1f1b", 2))
# a rank's first step against the one-process MP step on the global batch
# at world·M microbatches: the same microbatches through the same stage
# forwards and the same kernels, so the loss's statistics and each
# microbatch's gradients are the same; the gradients of the microbatches
# are summed in another order (within the rank, then over the ranks). The
# loss relative, each weight gradient relative to its tensor's largest
DDP_MP_LOSS_RTOL = 1e-5
DDP_MP_GRAD_RTOL = 1e-3
# milesial's by each tensor's relative L2 error, IN_PLACE_GRAD_REL_L2's
# bound: the statistics summed in another order move the loss's output
# gradient in its last float32 bits, which flips bf16 roundings that a
# random-init milesial backward amplifies (4.7e-5 relative L2, 1.5e-3 of
# a tensor's largest, in a CPU rehearsal at 48 x 32)
DDP_MP_MILESIAL_GRAD_REL_L2 = IN_PLACE_GRAD_REL_L2
# the bf16 UNet step each rank times, after 2 of warm-up
DDP_MP_TIMED_STEPS = 5


def _digest(tensors) -> str:
    """SHA-256 of the bytes of ``tensors``, in order."""
    import hashlib

    digest = hashlib.sha256()
    for t in tensors:
        digest.update(t.detach().cpu().numpy().tobytes())
    return digest.hexdigest()


def _ddp_mp_step(arch: str, devices, schedule: str, kernels_name: str):
    """``(model, step, opt, strategy)``: the DDP_MP strategy's train step
    of this rank over ``devices`` (bf16, ``-b`` TRAIN_BATCH in
    MP_MICROBATCHES microbatches, milesial with ``--wgrad-taps``) from the
    seed's weights, Adam keeping its first gradients."""
    import torch

    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.models import create_model
    from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
    from distributedpytorch_tpu_torch.ops.optim import make_optimizer
    from distributedpytorch_tpu_torch.parallel.strategy import build_strategy

    cfg = TrainConfig(train_method="DDP_MP", model_arch=arch, dtype="bf16",
                      kernels=kernels_name, device="cuda",
                      batch_size=TRAIN_BATCH, num_stages=len(devices),
                      num_microbatches=MP_MICROBATCHES,
                      pipeline_schedule=schedule,
                      wgrad_taps=arch == "milesial")
    strategy = build_strategy(cfg, devices=devices)
    check(strategy.name == "DDP_MP" and strategy.devices == list(devices),
          f"DDP_MP strategy on {strategy.devices}")
    model = create_model(cfg, generator=torch.Generator().manual_seed(SEED))
    model = strategy.place_model(model)
    opt = _FirstGrads(make_optimizer(
        model.parameters(), strategy.lr_for(cfg.learning_rate),
        cfg.weight_decay), list(model.named_parameters()))
    step = strategy.build_train_step(model, opt,
                                     get_kernel_policy(kernels_name))
    return model, step, opt, strategy


def _ddp_mp_run(rank: int, world: int, devices, arch: str, schedule: str,
                steps: int) -> dict:
    """One run of a DDP_MP rank: ``steps`` steps under kernels cuda on its
    rows of the global batches, the launches counted from zero over them
    and the weights' digest after each; one step from the same weights
    under kernels torch on the first batch; under the UNet the steady
    step timed. Rank 0 keeps its first gradients."""
    import torch

    from distributedpytorch_tpu_torch.models.milesial import BatchNormAct
    from distributedpytorch_tpu_torch.ops import kernels

    rows = slice(rank * TRAIN_BATCH, (rank + 1) * TRAIN_BATCH)
    placed = [{k: torch.from_numpy(v[rows]).to(devices[0])
               for k, v in batch.items()}
              for batch in _ddp_batches(world, TRAIN_BATCH, steps)]
    model, step, opt, strategy = _ddp_mp_step(arch, devices, schedule,
                                              "cuda")
    bns = [m for m in model.modules() if isinstance(m, BatchNormAct)]
    check(all(m.epilogue and not m.global_stats for m in bns),
          "DDP_MP BatchNorm: not the epilogue on local moments")
    _sync_all(devices)
    kernels.reset_launches()
    losses, digests = [], []
    for batch in placed:
        losses.append(float(step(batch)))
        digests.append(_digest(model.state_dict().values()))
    _sync_all(devices)
    launches = dict(kernels.LAUNCHES)
    out = {"losses": losses, "weights_digests": digests,
           "launches": launches,
           "batchnorms_per_stage": _stage_batchnorms(strategy),
           "grads_digest": _digest(opt.grads.values())}
    if rank == 0:
        out["grads"] = opt.grads
    if arch == "unet":
        out["step_ms"] = _wall_ms(lambda: step(placed[0]),
                                  DDP_MP_TIMED_STEPS, warmup=2,
                                  devices=devices)
        out["busy_ms_by_card"] = _busy_ms_by_device(
            lambda: step(placed[0]), 2, devices=devices)
    first = opt.grads
    del model, step, opt, strategy
    torch.cuda.empty_cache()
    model, step, opt, _ = _ddp_mp_step(arch, devices, schedule, "torch")
    plain_loss = float(step(placed[0]))
    plain = opt.grads
    out["torch_policy"] = {
        "loss": plain_loss,
        "loss_rel_err": abs(losses[0] - plain_loss) / plain_loss,
        "grad_max_err_rel_to_tensor_max": max(
            float((first[n] - g).abs().max() / g.abs().max())
            for n, g in plain.items()),
        "grad_max_rel_l2": max(float((first[n] - g).norm() / g.norm())
                               for n, g in plain.items()),
    }
    del model, step, opt
    torch.cuda.empty_cache()
    return out


def ddp_mp_rank(rank: int, world: int, backend: str, job: str) -> int:
    """One rank of a multi-process DDP_MP phase (``chip_smoke.py
    --ddp-mp-rank R WORLD BACKEND DIR``): joins a ``backend`` group over a
    file store in ``DIR`` with its MP_STAGES stages on cuda:0 under gloo
    (``train_ddp_mp_gloo2``: every rank and stage on the one card) and on
    ``cuda:(R·S + s)`` under nccl (``--cards``: the layout
    ``runtime.stage_devices`` gives a torchrun rank), runs DDP_MP_RUNS
    (``_ddp_mp_run``) and writes its results to ``DIR/result_R.pt``."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if backend == "gloo":
        devices = [torch.device("cuda", 0)] * MP_STAGES
    else:
        devices = [torch.device("cuda", rank * MP_STAGES + s)
                   for s in range(MP_STAGES)]
    torch.cuda.set_device(devices[0])
    _warm_profiler()
    torch.distributed.init_process_group(
        backend, init_method=f"file://{os.path.join(job, 'store')}",
        rank=rank, world_size=world)
    try:
        runs = {}
        for arch, schedule, steps in DDP_MP_RUNS:
            def run(arch=arch, schedule=schedule, steps=steps):
                return _ddp_mp_run(rank, world, devices, arch, schedule,
                                   steps)
            runs[f"{arch}/{schedule}"] = (
                _with_wgrad_backend(run) if arch == "milesial" else run())
        result = {"runs": runs, "devices": [str(d) for d in devices]}
        from distributedpytorch_tpu_torch.config import TrainConfig

        cfg = TrainConfig(train_method="DDP_MP", dtype="bf16",
                          kernels="cuda", device="cuda",
                          batch_size=TRAIN_BATCH, num_stages=MP_STAGES,
                          num_microbatches=MP_MICROBATCHES,
                          steps_per_dispatch=GS_K)
        if backend == "gloo":
            result["k_refusal"] = _refusal(
                dataclasses.replace(cfg, steps_per_dispatch=2), devices)
        else:
            result["graph"] = {
                schedule: _rank_graph_run(
                    dataclasses.replace(cfg, pipeline_schedule=schedule),
                    rank, world, devices, 3)
                for schedule in ("gpipe", "1f1b")}
        torch.save(result, os.path.join(job, f"result_{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()
    return 0


def _ddp_mp_launches_expected(arch: str, schedule: str, steps: int,
                              per_stage: list) -> dict:
    """A rank's launches over ``steps`` steps at M microbatches: K1 M per
    step (2M under 1f1b: phase A and the recomputation), K1-bwd M; for
    milesial K3 18·M and K5 13·M, K2 18·M under gpipe and under 1f1b
    18·M in phase A, one per BatchNorm of the stages before the last in
    phase B's forward ticks and 18·M in its recomputations."""
    mb = MP_MICROBATCHES
    one_f = schedule == "1f1b"
    want = {"loss_stats": steps * mb * (2 if one_f else 1),
            "loss_stats_bwd": steps * mb}
    if arch == "milesial":
        k2 = mb * (36 + sum(per_stage[:-1])) if one_f else 18 * mb
        want.update(bn_act=steps * k2, bn_act_bwd=steps * 18 * mb,
                    wgrad_9tap=steps * 13 * mb)
    return want


def _check_ddp_mp_ranks(ranks, world: int, dev=None):
    """Per run: the ranks' losses, weights after every step and first
    gradients bitwise equal; the launches as ``_ddp_mp_launches_expected``
    says; kernels cuda against kernels torch on the same path (the UNet:
    loss within 1e-5 as train_parity, gradients within STEP_GRAD_RTOL;
    milesial in bf16: MILESIAL_PARITY's bounds); and rank 0's first step
    against one MP step of the same weights on the global batch at
    world·M microbatches on cuda:0 (the per-process faithful scale): the
    loss within DDP_MP_LOSS_RTOL, each UNet gradient within
    DDP_MP_GRAD_RTOL of its tensor's largest, each milesial gradient
    within DDP_MP_MILESIAL_GRAD_REL_L2 relative L2. Returns the rows and
    the disagreements, which the caller checks after it emitted the
    rows."""
    import torch

    dev = dev or torch.device("cuda", 0)
    out, problems = {}, []
    for arch, schedule, steps in DDP_MP_RUNS:
        key = f"{arch}/{schedule}"
        rs = [r["runs"][key] for r in ranks]
        r0 = rs[0]
        want = _ddp_mp_launches_expected(arch, schedule, steps,
                                         r0["batchnorms_per_stage"])

        def mp_step(arch=arch, schedule=schedule):
            model, step, _ = _mp_model_step(
                arch, [dev] * MP_STAGES, schedule, world * MP_MICROBATCHES,
                "bf16", batch_size=TRAIN_BATCH,
                wgrad_taps=arch == "milesial")
            batch = {k: torch.from_numpy(v).to(dev) for k, v in
                     _ddp_batches(world, TRAIN_BATCH, 1)[0].items()}
            loss = float(step(batch))
            grads = {n: p.grad.float().cpu()
                     for n, p in model.named_parameters()}
            del model, step
            torch.cuda.empty_cache()
            return loss, grads

        mp_loss, mp_grads = (_with_wgrad_backend(mp_step)
                             if arch == "milesial" else mp_step())
        row = {
            "steps": steps, "losses": [r["losses"] for r in rs],
            "launches": [r["launches"] for r in rs],
            "launches_expected": want,
            "weights_bitwise_equal_every_step": all(
                r["weights_digests"] == r0["weights_digests"] for r in rs),
            "first_grads_bitwise_equal": all(
                r["grads_digest"] == r0["grads_digest"] for r in rs),
            "torch_policy": r0["torch_policy"],
            "mp_step_loss": mp_loss,
            "mp_loss_rel_err": abs(r0["losses"][0] - mp_loss) / mp_loss,
            "mp_grad_max_err_rel_to_tensor_max": max(
                float((r0["grads"][n] - g).abs().max() / g.abs().max())
                for n, g in mp_grads.items()),
            "mp_grad_max_rel_l2": max(
                float((r0["grads"][n] - g).norm() / g.norm())
                for n, g in mp_grads.items()),
        }
        for name in ("step_ms", "busy_ms_by_card"):
            if name in r0:
                row[name] = [r[name] for r in rs]
        out[key] = row
        del mp_grads
        if not row["weights_bitwise_equal_every_step"]:
            problems.append(f"{key}: the ranks' weights differ")
        if not row["first_grads_bitwise_equal"]:
            problems.append(f"{key}: the ranks' gradients differ")
        if any(l != row["losses"][0] for l in row["losses"]):
            problems.append(f"{key}: the ranks' losses differ")
        for counts in row["launches"]:
            if any(counts[n] != c for n, c in want.items()):
                problems.append(f"{key}: launched {counts}, expected {want}")
        if row["mp_loss_rel_err"] > DDP_MP_LOSS_RTOL:
            problems.append(f"{key}: step 1 loss off the MP step by "
                            f"{row['mp_loss_rel_err']}")
        if (row["mp_grad_max_rel_l2"] > DDP_MP_MILESIAL_GRAD_REL_L2
                if arch == "milesial" else
                row["mp_grad_max_err_rel_to_tensor_max"] > DDP_MP_GRAD_RTOL):
            problems.append(f"{key}: step 1 grads off the MP step: {row}")
        tp = row["torch_policy"]
        if arch == "unet":
            ok = (tp["loss_rel_err"] <= 1e-5
                  and tp["grad_max_err_rel_to_tensor_max"] <= STEP_GRAD_RTOL)
        else:
            bound = MILESIAL_PARITY["bf16"]
            ok = (tp["loss_rel_err"] <= bound["loss"]
                  and tp["grad_max_rel_l2"] <= bound["grad_rel_l2"])
        if not ok:
            problems.append(f"{key}: kernels cuda off kernels torch: {tp}")
    return out, problems


def phase_train_ddp_mp_gloo2(tmp: str) -> dict:
    """``-t DDP_MP`` on the one card: two ranks (``ddp_mp_rank``, two
    processes this script spawns) in a gloo group, each with both of its
    stages on cuda:0, through DDP_MP_RUNS: the bf16 UNet under gpipe and
    1f1b, milesial with ``--wgrad-taps`` under DPT_WGRAD_BACKEND=pallas
    under both. Checked as ``_check_ddp_mp_ranks`` says, K1, K1-bwd, K2,
    K3 and K5 counted per rank from zero over each run; the UNet step
    timed by each rank (both ranks share the card and their gradients
    cross the host through gloo: a correctness phase, whose step time is
    read beside train_mp's)."""
    import torch

    torch.cuda.empty_cache()  # the ranks share the card with this process
    ranks, wall_s = _run_ddp_ranks(
        os.path.join(tmp, "train_ddp_mp_gloo2"), 2, "gloo", "--ddp-mp-rank")
    runs, problems = _check_ddp_mp_ranks(ranks, 2)
    refusals = [r["k_refusal"] for r in ranks]
    if not all(GLOO_REFUSAL in (msg or "") for msg in refusals):
        problems.append(f"--steps-per-dispatch 2 over gloo on a card: "
                        f"{refusals}")
    out = {"phase": "train_ddp_mp_gloo2", "world": 2, "backend": "gloo",
           "k_refusals": refusals,
           "stages": MP_STAGES, "microbatches": MP_MICROBATCHES,
           "devices": [r["devices"] for r in ranks],
           "device": torch.cuda.get_device_name(0), "wall_s": wall_s,
           "runs": runs, "problems": problems}
    emit(out)
    check(not problems, f"train_ddp_mp_gloo2: {problems}")
    return out


def phase_ddp_mp_cards(tmp: str) -> dict:
    """``-t DDP_MP`` across four cards (``--cards 4``): two NCCL ranks,
    rank r's stages on cuda:2r and cuda:2r+1, checked as
    ``train_ddp_mp_gloo2``; each rank's bf16 UNet step by wall time and
    each card's busy time, with the bubble 1 − mean busy / step, beside
    the same per-rank pipeline (``-b 4``, M = 2) with both stages on
    cuda:0 in one process; then ``torchrun --standalone --nproc_per_node
    2`` of the training CLI with ``-t DDP_MP --stages 2``, which must exit
    0 with the DDP_MP artifacts and both ranks in its log."""
    import torch

    world = 2
    ranks, wall_s = _run_ddp_ranks(os.path.join(tmp, "ddp_mp_cards"),
                                   world, "nccl", "--ddp-mp-rank")
    runs, problems = _check_ddp_mp_ranks(ranks, world)
    dev = torch.device("cuda", 0)
    one_card = {}
    batch = _synthetic_batch(TRAIN_BATCH, dev)
    for schedule in ("gpipe", "1f1b"):
        _, step, _ = _mp_model_step("unet", [dev] * MP_STAGES, schedule,
                                    MP_MICROBATCHES, "bf16", lr=1e-4)
        one_card[schedule] = {
            "step_ms": _wall_ms(lambda: step(batch), DDP_MP_TIMED_STEPS,
                                warmup=2, devices=[dev]),
            "busy_ms": _busy_ms_by_device(lambda: step(batch), 2,
                                          devices=[dev]).get(0)}
        del step
        torch.cuda.empty_cache()
    for schedule in ("gpipe", "1f1b"):
        row = runs[f"unet/{schedule}"]
        row["bubble_by_rank"] = [
            1.0 - sum(busy.values()) / len(busy) / ms
            for busy, ms in zip(row["busy_ms_by_card"], row["step_ms"])]
        row["one_card_mp"] = one_card[schedule]
        row["images_per_s"] = world * TRAIN_BATCH * 1e3 / max(row["step_ms"])
        row["one_card_mp_images_per_s"] = (
            TRAIN_BATCH * 1e3 / one_card[schedule]["step_ms"])

    sub = os.path.join(tmp, "ddp_mp_torchrun")
    os.makedirs(sub)
    env = dict(os.environ,
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    for key in TORCHRUN_ENV:
        env.pop(key, None)
    w, h = IMAGE_WH
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(world), "-m",
           "distributedpytorch_tpu_torch", "-t", "DDP_MP", "--stages",
           str(MP_STAGES), "--microbatches", str(MP_MICROBATCHES),
           "--pipeline-schedule", "1f1b", "--synthetic", "40", "-v", "20",
           "-b", str(TRAIN_BATCH), "-e", "1", "--image-size", str(w), str(h),
           "--kernels", "cuda"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=sub, env=env, capture_output=True,
                          text=True, timeout=600)
    torchrun_s = time.perf_counter() - t0
    wrote = _files(sub)
    log = ""
    if "logs/DDP_MP.log" in wrote:
        with open(os.path.join(sub, "logs", "DDP_MP.log")) as f:
            log = f.read()
    out = {"phase": "ddp_mp_cards", "world": world, "backend": "nccl",
           "stages": MP_STAGES, "microbatches": MP_MICROBATCHES,
           "devices": [r["devices"] for r in ranks],
           "cards": [torch.cuda.get_device_name(i)
                     for i in range(world * MP_STAGES)],
           "wall_s": wall_s, "runs": runs, "problems": problems,
           "graph": {schedule: _ranks_graph_rows(
               [{"graph": r["graph"][schedule]} for r in ranks], world)
               for schedule in ("gpipe", "1f1b")},
           "torchrun_rc": proc.returncode, "torchrun_s": torchrun_s,
           "torchrun_wrote": wrote,
           "torchrun_ranks_logged": sum(f"(rank {r} of {world})" in log
                                        for r in range(world))}
    emit(out)
    check(not problems, f"ddp_mp_cards: {problems}")
    for schedule, rows in out["graph"].items():
        _check_ranks_graph(rows, f"DDP_MP {schedule} on four cards")
    check(proc.returncode == 0,
          f"torchrun -t DDP_MP exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    check(wrote == ["checkpoints/DDP_MP.pt", "checkpoints/DDP_MP.pth",
                    "logs/DDP_MP.log", "loss/DDP_MP/train_loss.pkl",
                    "loss/DDP_MP/val_dice.pkl", "loss/DDP_MP/val_loss.pkl"],
          f"torchrun -t DDP_MP wrote {wrote}")
    check(out["torchrun_ranks_logged"] == world,
          f"{out['torchrun_ranks_logged']} of {world} ranks logged")
    return out


# -- run control ---------------------------------------------------------------

# train_run_control: 80 synthetic samples at -v 20 give 64 train samples,
# 16 steps of -b 4 in one epoch, and 4 eval batches
RC_SAMPLES = 80
RC_K = 4
# the bf16_params loss against the bf16 run from the same weights
RC_BF16_PARAMS_LOSS_RTOL = 1e-3
# a recomputed forward runs the same kernels on the same inputs: the
# gradients may differ only where autograd adds BatchNorm's statistics'
# gradients in another order
RC_REMAT_GRAD_RTOL = 1e-6


def _rc_argv(run: str, *extra, samples: int = RC_SAMPLES) -> list:
    """The training CLI's arguments of a run-control case: the full-width
    model at -b 4, kernels cuda, checkpoints under ``run``."""
    w, h = IMAGE_WH
    return ["-t", "singleGPU", "--synthetic", str(samples), "-v", "20",
            "-b", str(TRAIN_BATCH), "--image-size", str(w), str(h),
            "--kernels", "cuda", "--checkpoint-dir",
            os.path.join(run, "checkpoints"), *extra]


def _placed_batches(trainer, n: int, epoch: int = 0) -> list:
    loader = trainer.train_loader
    return [trainer.place_batch(loader.load_slice(idx))
            for idx in loader.batch_slices(epoch)[:n]]


def _capturable_(optimizer) -> None:
    """Adam's step counts and lr on each group's card: the arithmetic of
    the K-step graph's optimizer (``make_optimizer(capturable=True)``) in
    an eager run, from its first step or from a restored state."""
    import torch

    for group in optimizer.param_groups:
        device = group["params"][0].device
        group["capturable"] = True
        group["lr"] = torch.tensor(float(group["lr"]), dtype=torch.float32,
                                   device=device)
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if isinstance(st.get("step"), torch.Tensor):
                st["step"] = st["step"].to(device=device,
                                           dtype=torch.float32)


def _rc_graph(tmp: str) -> dict:
    """Run 1: the UNet, ``--steps-per-dispatch 4`` (one CUDA graph of 4
    steps), 16 steps, against the same 16 steps at K = 1 with the same
    capturable Adam (and with the CLI's plain Adam), from the same seeded
    weights on the same data."""
    import torch

    dev = torch.device("cuda", 0)
    runs = {}
    # bitwise equality needs cuDNN's deterministic algorithms: a default
    # one may add in a run-dependent order (two eager runs of the small
    # case in tests/test_torch_cuda.py differ in the last bit)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, k, capturable in (("k4", RC_K, True), ("k1", 1, True),
                                    ("k1_plain_adam", 1, False)):
            runs[name] = _rc_graph_run(tmp, name, k, capturable, dev)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return _rc_graph_report(runs)


def _rc_graph_run(tmp: str, name: str, k: int, capturable: bool, dev
                  ) -> dict:
    """One run of ``_rc_graph``: 16 steps at K = ``k``, the losses, the
    weights, the launches, and (but for the plain Adam) the step's
    timings; a replay's kernels from its kept graph and the trace
    (``_replay_launches``), an eager step's from the trace."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.ops import kernels

    run = os.path.join(tmp, f"rc_graph_{name}")
    trainer, close = _cli_trainer(run, _rc_argv(
        run, "-e", "1", "--dtype", "bf16",
        "--steps-per-dispatch", str(k)))
    try:
        if k == 1 and capturable:
            _capturable_(trainer.optimizer)
        kernels.reset_launches()
        with _keeping_graphs():
            result = trainer.train()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        out = {
            "steps": result["steps"], "launches": launches,
            "losses": [float(x) for x in trainer.records.losses],
            "weights": [p.detach().clone()
                        for p in trainer.model.parameters()],
        }
        if name == "k4":
            host = [trainer.train_loader.load_slice(idx) for idx in
                    trainer.train_loader.batch_slices(0)[:k]]
            stacked = trainer.place_batch(
                {key: np.stack([b[key] for b in host])
                 for key in host[0]})

            def fn():
                return trainer.multi_step(stacked)
        else:
            batch = _placed_batches(trainer, 1)[0]

            def fn():
                return trainer.train_step(batch)
        if name == "k4":
            out["replay_launches"] = _replay_launches(trainer.multi_step,
                                                      fn, LOSS_KERNELS)
        elif name == "k1":
            out["traced_launches_per_call"] = _traced_launches(fn)
        if name != "k1_plain_adam":
            out["step_ms"] = cuda_ms(fn, 4, warmup=2) / k
            out["host_enqueue_ms_per_step"] = _host_enqueue_ms(fn) / k
            wall = _wall_ms(fn, 4, 1) / k
            busy = _busy_ms_by_device(fn, 2).get(0, 0.0) / k
            out["wall_ms_per_step"] = wall
            # None where the profiler saw no kernel of the replay
            out["device_busy_ms_per_step"] = busy or None
            out["device_idle_share"] = (1.0 - busy / wall) if busy \
                else None
    finally:
        close()
    return out


def _rc_graph_report(runs: dict) -> dict:
    import torch

    ref, k4 = runs["k1"], runs["k4"]

    def weight_err(a, b):
        return max(float((x.float() - y.float()).abs().max()
                         / y.float().abs().max()) for x, y in zip(a, b))

    bitwise = (k4["losses"] == ref["losses"]
               and all(torch.equal(a, b)
                       for a, b in zip(k4["weights"], ref["weights"])))
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(k4["losses"], ref["losses"]))
    plain = runs["k1_plain_adam"]
    report = {
        "phase": "train_run_control", "run": "cuda_graph",
        "steps": k4["steps"], "k": RC_K,
        "bitwise_equal_to_k1": bitwise,
        "loss_max_rel_err_vs_k1": loss_err,
        "weights_max_err_rel_to_tensor_max_vs_k1": weight_err(
            k4["weights"], ref["weights"]),
        "loss_max_rel_err_vs_k1_plain_adam": max(
            abs(a - b) / abs(b)
            for a, b in zip(k4["losses"], plain["losses"])),
        "weights_max_err_rel_to_tensor_max_vs_k1_plain_adam": weight_err(
            k4["weights"], plain["weights"]),
        # a replay's: the graph's kernel nodes and the profiler's trace of
        # one call; an eager step's: the trace
        "graph_launches_per_replay": k4["replay_launches"]["nodes"],
        "traced_launches_per_replay": k4["replay_launches"]["traced"],
        "k1_step_launches_traced": ref["traced_launches_per_call"],
        "cudnn_deterministic": True,
        # the wrappers' counts over the run: K = 4 counts its warm-up's
        # and its capture's launches, and no replay
        "launches": {"k4": k4["launches"], "k1": ref["launches"]},
        **{f"{key}_{name}": runs[name][key]
           for name in ("k4", "k1")
           for key in ("step_ms", "host_enqueue_ms_per_step",
                       "wall_ms_per_step", "device_busy_ms_per_step",
                       "device_idle_share")},
        "device": torch.cuda.get_device_name(0),
    }
    emit(report)
    check(k4["steps"] == ref["steps"] == 16, f"{k4['steps']} steps")
    _check_replay("K = 4 graph", k4["replay_launches"],
                  {"loss_stats": RC_K, "loss_stats_bwd": RC_K})
    check(report["k1_step_launches_traced"] == {"loss_stats": 1,
                                                "loss_stats_bwd": 1},
          f"traced: an eager step ran {report['k1_step_launches_traced']}")
    # K = 1: 16 steps and 4 eval batches; K = 4: the first stack's eager
    # warm-up, the capture of the second, and the eval batches
    check(ref["launches"]["loss_stats"] == 16 + 4
          and ref["launches"]["loss_stats_bwd"] == 16
          and k4["launches"]["loss_stats"] == 2 * RC_K + 4
          and k4["launches"]["loss_stats_bwd"] == 2 * RC_K,
          f"launches over the run: {report['launches']}")
    check(bitwise, f"K = {RC_K} graph against K = 1: losses rel "
                   f"{loss_err}, weights {report['weights_max_err_rel_to_tensor_max_vs_k1']}")
    return report


def _rc_step_run(run: str, argv, n: int = 2) -> dict:
    """The CLI trainer of ``argv``; ``n`` train steps on the epoch's first
    batches, each step's loss, launches and gradients, the running
    statistics after them, then the steady step's time and peak memory."""
    import torch

    from distributedpytorch_tpu_torch.ops import kernels

    trainer, close = _cli_trainer(run, argv)
    try:
        batches = _placed_batches(trainer, n)
        out = {"losses": [], "launches": [], "grads": []}
        for b in batches:
            kernels.reset_launches()
            out["losses"].append(float(trainer.train_step(b)))
            out["launches"].append(dict(kernels.LAUNCHES))
            out["grads"].append({name: p.grad.float().clone()
                                 for name, p in
                                 trainer.model.named_parameters()})
        out["stats"] = {name: t.clone() for name, t in
                        trainer.model.named_buffers() if "running" in name}
        torch.cuda.synchronize()
        out.update(_peak_step_bytes(trainer.train_step, batches[0]))
        out["step_ms"] = cuda_ms(lambda: trainer.train_step(batches[0]), 3,
                                 warmup=1)
    finally:
        close()
    return out


def _rc_remat(tmp: str) -> dict:
    """Run 2: milesial ``--remat --wgrad-taps`` for 2 steps against the
    same steps without ``--remat``, and the UNet likewise."""
    import torch

    report = {"phase": "train_run_control", "run": "remat"}
    for arch, extra in (("milesial", ["--model", "milesial",
                                      "--wgrad-taps"]),
                        ("unet", [])):
        runs = {}
        for remat in (False, True):
            run = os.path.join(tmp, f"rc_remat_{arch}_{int(remat)}")
            argv = _rc_argv(run, "-e", "1", *extra,
                            *(["--remat"] if remat else []), samples=20)
            runs[remat] = _with_wgrad_backend(
                lambda run=run, argv=argv: _rc_step_run(run, argv))
        plain, remat = runs[False], runs[True]
        grad_err = max(
            float((g[n] - t).abs().max() / t.abs().max())
            for g, ref in zip(remat["grads"], plain["grads"])
            for n, t in ref.items() if float(t.abs().max()) > 0)
        report[arch] = {
            "losses_bitwise_equal": remat["losses"] == plain["losses"],
            "running_stats_bitwise_equal": all(
                torch.equal(remat["stats"][n], t)
                for n, t in plain["stats"].items()),
            "grad_max_err_rel_to_tensor_max": grad_err,
            "launches_per_step": {"plain": plain["launches"][0],
                                  "remat": remat["launches"][0]},
            "peak_bytes": {"plain": plain["peak_bytes"],
                           "remat": remat["peak_bytes"]},
            "step_bytes": {"plain": plain["step_bytes"],
                           "remat": remat["step_bytes"]},
            "step_ms": {"plain": plain["step_ms"],
                        "remat": remat["step_ms"]},
        }
    report["device"] = torch.cuda.get_device_name(0)
    emit(report)
    m = report["milesial"]
    want = {False: {"bn_act": 18, "bn_act_bwd": 18, "wgrad_9tap": 13},
            True: {"bn_act": 36, "bn_act_bwd": 18, "wgrad_9tap": 13}}
    for remat, counts in want.items():
        got = m["launches_per_step"]["remat" if remat else "plain"]
        check(all(got[k] == v for k, v in counts.items()),
              f"milesial remat={remat} launched {got}, expected {counts}")
    for arch in ("milesial", "unet"):
        r = report[arch]
        check(r["losses_bitwise_equal"] and r["running_stats_bitwise_equal"]
              and r["grad_max_err_rel_to_tensor_max"] <= RC_REMAT_GRAD_RTOL,
              f"{arch} remat against the plain step: {r}")
        check(r["step_bytes"]["remat"] < r["step_bytes"]["plain"],
              f"{arch} remat does not lower the step's memory: {r}")
    return report


def _rc_bf16_params(tmp: str) -> dict:
    """Run 3: the UNet and milesial, 2 steps each under ``--dtype
    bf16_params`` against ``--dtype bf16`` from the same weights; the
    kernels with bf16 parameters against their plain versions in place;
    a resume of the bf16_params checkpoint under ``--dtype bf16``."""
    import torch

    from distributedpytorch_tpu_torch.ops import kernels

    report = {"phase": "train_run_control", "run": "bf16_params"}
    for arch, extra in (("unet", []), ("milesial", ["--model", "milesial",
                                                    "--wgrad-taps"])):
        losses, out, step_ms = {}, {}, {}
        for dtype in ("bf16", "bf16_params"):
            run = os.path.join(tmp, f"rc_bf16p_{arch}_{dtype}")
            argv = _rc_argv(run, "-e", "1", "--dtype", dtype, *extra,
                            samples=20)

            def go(run=run, argv=argv, dtype=dtype):
                trainer, close = _cli_trainer(run, argv)
                try:
                    batches = _placed_batches(trainer, 2)
                    kernels.reset_launches()
                    got = [float(trainer.train_step(b)) for b in batches]
                    launches = dict(kernels.LAUNCHES)
                    step_ms[dtype] = cuda_ms(
                        lambda: trainer.train_step(batches[0]), 3, warmup=1)
                    if dtype == "bf16":
                        return got, None
                    opt = trainer.optimizer
                    params = list(trainer.model.parameters())
                    res = {
                        "launches_2_steps": launches,
                        "params_bf16": all(p.dtype == torch.bfloat16
                                           for p in params),
                        "master_f32": all(m.dtype == torch.float32
                                          for m in opt.master),
                        "params_equal_master_rounded": all(
                            torch.equal(p, m.to(torch.bfloat16))
                            for p, m in zip(params, opt.master)),
                    }
                    if arch == "milesial":
                        res["kernels_vs_plain_versions"] = \
                            _rc_in_place(trainer, batches[0])
                    trainer.save(1)
                    trainer._drain_checkpoint_futures(raise_errors=True)
                    master = [m.clone() for m in opt.master]
                    path = trainer.checkpoint_path
                finally:
                    close()
                rerun = run + "_resumed_bf16"
                again, close = _cli_trainer(rerun, _rc_argv(
                    rerun, "-e", "2", "--dtype", "bf16", *extra,
                    "-c", path, samples=20))
                try:
                    res["resume_bf16_params_equal_master"] = all(
                        p.dtype == torch.float32 and torch.equal(p, m)
                        for p, m in zip(again.model.parameters(), master))
                finally:
                    close()
                return got, res

            losses[dtype], res = _with_wgrad_backend(go)
            if res is not None:
                out.update(res)
        out["losses"] = losses
        out["step_ms"] = step_ms
        out["loss_rel_err"] = [abs(a - b) / abs(b) for a, b in
                               zip(losses["bf16_params"], losses["bf16"])]
        report[arch] = out
    report["device"] = torch.cuda.get_device_name(0)
    emit(report)
    for arch in ("unet", "milesial"):
        r = report[arch]
        check(r["params_bf16"] and r["master_f32"]
              and r["params_equal_master_rounded"]
              and r["resume_bf16_params_equal_master"]
              and max(r["loss_rel_err"]) <= RC_BF16_PARAMS_LOSS_RTOL,
              f"{arch} bf16_params: {r}")
    m = report["milesial"]
    check(m["launches_2_steps"]["bn_act"] == 36
          and m["launches_2_steps"]["wgrad_9tap"] == 26,
          f"milesial bf16_params launched {m['launches_2_steps']}")
    in_place = m["kernels_vs_plain_versions"]
    check(in_place["running_stats_bitwise_equal"]
          and in_place["loss_rel_err"] <= IN_PLACE_LOSS_RTOL
          and in_place["grad_global_rel_l2"] <= IN_PLACE_GRAD_GLOBAL_REL_L2
          and in_place["grad_max_rel_l2"] <= IN_PLACE_GRAD_REL_L2,
          f"milesial bf16_params, kernels vs their plain versions: "
          f"{in_place}")
    return report


def _rc_in_place(trainer, batch) -> dict:
    """One bf16_params milesial step with K2, K3, K5 (and K1) against the
    same step from the same state with every kernel swapped for its plain
    version (``_PlainVersions``): the f32 master gradients Adam read, the
    loss and the running statistics, by the in-place bounds."""
    import copy

    import torch

    from distributedpytorch_tpu_torch.ops import kernels

    model, opt = trainer.model, trainer.optimizer
    saved = (copy.deepcopy(model.state_dict()),
             copy.deepcopy(opt.state_dict()))

    def one():
        model.load_state_dict(saved[0])
        opt.load_state_dict(saved[1])
        kernels.reset_launches()
        loss = float(trainer.train_step(batch))
        return {"loss": loss, "launches": dict(kernels.LAUNCHES),
                "grads": [m.grad.clone() for m in opt.master],
                "stats": [t.clone() for n, t in model.named_buffers()
                          if "running" in n]}

    kern = one()
    with _PlainVersions():
        plain = one()
    check(kern["launches"]["bn_act"] == 18 and not any(
        plain["launches"].values()),
          f"in place: {kern['launches']} and {plain['launches']}")
    rel = [float((a - b).norm() / b.norm())
           for a, b in zip(kern["grads"], plain["grads"])
           if float(b.norm()) > 0]
    diff = torch.cat([(a - b).flatten()
                      for a, b in zip(kern["grads"], plain["grads"])])
    whole = torch.cat([b.flatten() for b in plain["grads"]])
    return {
        "loss_rel_err": abs(kern["loss"] - plain["loss"]) / abs(plain["loss"]),
        "grad_global_rel_l2": float(diff.norm() / whole.norm()),
        "grad_max_rel_l2": max(rel),
        "running_stats_bitwise_equal": all(
            torch.equal(a, b) for a, b in zip(kern["stats"], plain["stats"])),
    }


def _nan_at(trainer, at_step: int, state: dict) -> None:
    """Global step ``at_step``'s loss reads NaN, once (the counterpart of
    the JAX ``nan_loss`` fault site); ``state`` gets the model and
    optimizer state before that step, and at the next step call whether
    the state then equals it bit for bit."""
    import torch

    real = trainer.train_step

    def snapshot():
        inner = getattr(trainer.optimizer, "inner", trainer.optimizer)
        return ([t.detach().clone() for t in trainer.model.state_dict()
                 .values()],
                [v.clone() for s in inner.state.values() for v in s.values()
                 if isinstance(v, torch.Tensor)])

    def step(batch):
        if "before" in state and "equal_after" not in state:
            now = snapshot()
            state["equal_after"] = all(
                torch.equal(a, b) for a, b in zip(now[0] + now[1],
                                                  state["before"][0]
                                                  + state["before"][1]))
        if trainer.step + 1 == at_step and "before" not in state:
            state["before"] = snapshot()
            return real(batch) * float("nan")
        return real(batch)

    trainer.train_step = step


def _rc_nonfinite(tmp: str) -> dict:
    """Run 4: a NaN loss at a chosen step of the full-width UNet under
    ``skip``, ``rollback`` and ``abort``; and what a batch of NaN pixels
    gives."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.train.loop import NonFiniteLossError

    report = {"phase": "train_run_control", "run": "nonfinite"}
    # 20 samples: 16 train, 4 steps an epoch
    for policy, epochs, at in (("skip", 1, 2), ("rollback", 2, 6),
                               ("abort", 1, 2)):
        run = os.path.join(tmp, f"rc_nonfinite_{policy}")
        trainer, close = _cli_trainer(run, _rc_argv(
            run, "-e", str(epochs), "--nonfinite-policy", policy,
            samples=20))
        state: dict = {}
        try:
            _nan_at(trainer, at, state)
            try:
                result = trainer.train()
                out = {k: result[k] for k in ("steps", "skipped_steps",
                                              "rollbacks")}
            except NonFiniteLossError as exc:
                out = {"raised": str(exc)}
            if policy == "skip":
                out["state_after_equals_state_before"] = state.get(
                    "equal_after")
            if policy == "abort":
                nan = _placed_batches(trainer, 1)[0]
                nan["image"] = torch.full_like(nan["image"], float("nan"))
                loss = float(trainer.train_step(nan))
                out["nan_pixels_loss"] = loss
                out["nan_pixels_loss_finite"] = bool(np.isfinite(loss))
                out["nan_pixels_weights_nonfinite"] = not all(
                    bool(torch.isfinite(p).all())
                    for p in trainer.model.parameters())
        finally:
            close()
        report[policy] = out
    report["device"] = torch.cuda.get_device_name(0)
    emit(report)
    skip, rollback, abort = (report[p] for p in ("skip", "rollback",
                                                 "abort"))
    check(skip.get("skipped_steps") == 1 and skip.get("steps") == 3
          and skip["state_after_equals_state_before"] is True,
          f"skip: {skip}")
    check(rollback.get("rollbacks") == 1 and rollback.get("steps") == 8,
          f"rollback: {rollback}")
    check("raised" in abort and "policy=abort" in abort["raised"],
          f"abort: {abort}")
    return report


def _rc_timeline(tmp: str) -> dict:
    """Run 5: the UNet for 16 steps (2 epochs, ``--steps-per-dispatch
    4``) with ``--trace-timeline``, async saves, ``--keep-checkpoints 2``
    and ``--save-best``; then ``-c`` with the newest checkpoint
    corrupted, which resumes at K = 1 and trains the last epoch."""
    import torch

    import numpy as np

    from distributedpytorch_tpu_torch.utils.trace import summarize_timeline

    run = os.path.join(tmp, "rc_timeline")
    path = os.path.join(run, "timeline.jsonl")
    argv = _rc_argv(run, "-e", "2", "--steps-per-dispatch", str(RC_K),
                    "--trace-timeline", path, "--keep-checkpoints", "2",
                    "--save-best", samples=40)
    trainer, close = _cli_trainer(run, argv)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = trainer.train()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        ckpt = trainer.checkpoint_path
        files = _files(run)
    finally:
        close()
    summary = summarize_timeline(path)
    with open(ckpt, "r+b") as f:
        f.seek(os.path.getsize(ckpt) // 2)
        f.write(b"\0" * 4096)
    records: list = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    keep = Keep(logging.WARNING)
    logging.getLogger("distributedpytorch_tpu_torch").addHandler(keep)
    try:
        again, close = _cli_trainer(run + "_resumed", _rc_argv(
            run + "_resumed", "-e", "2", "-c", ckpt, samples=40))
        try:
            resumed = again.train()
            resumed_losses = [float(x) for x in again.records.losses]
        finally:
            close()
    finally:
        logging.getLogger("distributedpytorch_tpu_torch").removeHandler(keep)
    report = {
        "phase": "train_run_control", "run": "timeline_checkpoints",
        "steps": result["steps"], "wall_ms": wall_ms,
        "phases": summary,
        "phase_share_of_wall": {
            p: (s["total_ms"] / wall_ms if s else None)
            for p, s in summary.items()},
        "checkpoint_files": [f for f in files if f.startswith("checkpoints")],
        "corrupt_newest_resumed_at_epoch": again.start_epoch,
        "resumed_k1_steps": resumed["steps"],
        "resumed_k1_losses_finite": bool(np.isfinite(resumed_losses).all()),
        "fallback_warned": any("restored the newest intact" in m
                               for m in records),
        "device": torch.cuda.get_device_name(0),
    }
    emit(report)
    check(all(summary[p] for p in ("decode", "stack", "h2d", "dispatch",
                                   "readback")),
          f"timeline phases: {summary}")
    check(result["steps"] == 16, f"{result['steps']} steps")
    for need in ("checkpoints/singleGPU.pt", "checkpoints/singleGPU.pt.1",
                 "checkpoints/singleGPU_best.pt"):
        check(need in report["checkpoint_files"],
              f"missing {need}: {report['checkpoint_files']}")
    check(report["corrupt_newest_resumed_at_epoch"] == 1
          and report["fallback_warned"]
          and report["resumed_k1_steps"] == 16
          and report["resumed_k1_losses_finite"],
          f"corrupt newest checkpoint: {report}")
    return report


def phase_train_run_control(tmp: str) -> dict:
    """The trainer's run control on the card, full width, random weights
    from the seed, synthetic data: the CUDA graph of K steps (run 1),
    ``--remat`` (run 2), ``--dtype bf16_params`` (run 3), the non-finite
    policies (run 4), the step timeline and the checkpoint policy (run
    5), one JSON line each. Returns the launches the kernels line reads:
    K1 and K1-bwd per replay of run 1's graph, K2, K3 and K5 per milesial
    remat step."""
    graph = _rc_graph(tmp)
    remat = _rc_remat(tmp)
    _rc_bf16_params(tmp)
    _rc_nonfinite(tmp)
    _rc_timeline(tmp)
    return {"graph": graph, "remat": remat,
            "launches": {**graph["graph_launches_per_replay"],
                         **{k: v for k, v in remat["milesial"][
                             "launches_per_step"]["remat"].items()
                            if k in ("bn_act", "bn_act_bwd", "wgrad_9tap")}}}


# -- the K-step graph outside singleGPU ------------------------------------------

# train_graph_strategies: each run at K = GS_K against K = 1 with the same
# capturable Adam, full width, bf16 (bf16_params where named), -b 4. DDP
# captures after its 11 eager warm-up steps (three stacks), so its runs
# take 160 samples (32 steps, five stacks through the graph); milesial
# takes 40 (8 steps: one warm-up stack, one through the graph)
GS_K = RC_K
GS_RUNS = (
    # label, extra CLI arguments, samples, epochs, the wgrad backend
    ("ddp", ("-t", "DDP"), 160, 1, False),
    ("ddp_bf16_params", ("-t", "DDP", "--dtype", "bf16_params"), 160, 1,
     False),
    ("mp_gpipe", ("-t", "MP", "--stages", "2", "--microbatches", "2",
                  "--pipeline-schedule", "gpipe"), RC_SAMPLES, 2, False),
    ("mp_1f1b", ("-t", "MP", "--stages", "2", "--microbatches", "2",
                 "--pipeline-schedule", "1f1b"), RC_SAMPLES, 1, False),
    ("milesial_mp_gpipe", ("--model", "milesial", "--wgrad-taps", "-t",
                           "MP", "--stages", "2", "--microbatches", "2",
                           "--pipeline-schedule", "gpipe"), 40, 1, True),
)
# the run that puts an eval between replays (its two epochs) and then
# resumes (-c) for a third epoch, graph against eager again
GS_RESUMED = "mp_gpipe"


@contextlib.contextmanager
def _world_one_env():
    """torchrun's env of a one-process launch (a free port), restored
    after the block."""
    saved = {k: os.environ.get(k) for k in TORCHRUN_ENV}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    try:
        yield
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def _gs_trainer(run: str, argv, devices=None):
    """``_cli_trainer``'s trainer, for ``-t DDP`` at world 1 under NCCL
    with torchrun's env set (``cli.start_runtime``); ``close()`` also
    ends the group."""
    import torch

    from distributedpytorch_tpu_torch import cli
    from distributedpytorch_tpu_torch.dist import runtime

    if cli.get_args(argv).train_method != "DDP":
        return _cli_trainer(run, argv, devices)
    stack = contextlib.ExitStack()
    stack.enter_context(_world_one_env())
    stack.callback(runtime.shutdown)
    try:
        info = cli.start_runtime(cli.get_args(argv))
        check(info.num_processes == 1
              and torch.distributed.get_backend() == "nccl",
              "world-1 DDP is not NCCL")
        trainer, close = _cli_trainer(run, argv, info=info)
        stack.callback(close)
        return trainer, stack.close
    except BaseException:
        stack.close()
        raise


@contextlib.contextmanager
def _counting_ddp(counts: dict):
    """Within the block, ``counts["built"]`` counts the
    ``DistributedDataParallel`` wrappers this process builds."""
    from torch.nn.parallel import DistributedDataParallel as DDP

    init = DDP.__init__

    def counted(self, *args, **kwargs):
        counts["built"] += 1
        init(self, *args, **kwargs)

    DDP.__init__ = counted
    try:
        yield
    finally:
        DDP.__init__ = init


def _gs_measure(trainer, k: int, names) -> dict:
    """The steady step of ``trainer`` at K = ``k`` (one graph replay of
    ``k`` steps, or one eager step): step ms by CUDA events, host enqueue
    ms, wall and busy ms per step, the card's idle share, and the
    kernels of ``names`` one call ran: counted by name in the trace of
    an eager step, and in the graph's nodes and the trace of a replay
    (``_replay_launches``)."""
    import numpy as np

    if k > 1:
        host = [trainer.train_loader.load_slice(idx) for idx in
                trainer.train_loader.batch_slices(0)[:k]]
        stacked = trainer.place_batch({key: np.stack([b[key] for b in host])
                                       for key in host[0]})

        def fn():
            return trainer.multi_step(stacked)
    else:
        batch = _placed_batches(trainer, 1)[0]

        def fn():
            return trainer.train_step(batch)
    out = ({"replay_launches": _replay_launches(trainer.multi_step, fn,
                                                names)} if k > 1 else
           {"traced_launches_per_call": _traced_launches(fn, names)})
    out.update(step_ms=cuda_ms(fn, 4, warmup=2) / k,
               host_enqueue_ms_per_step=_host_enqueue_ms(fn) / k)
    wall = _wall_ms(fn, 4, 1) / k
    busy = _busy_ms_by_device(fn, 2).get(0, 0.0) / k
    out.update(wall_ms_per_step=wall, device_busy_ms_per_step=busy or None,
               device_idle_share=(1.0 - busy / wall) if busy else None)
    return out


def _gs_trainer_run(run: str, argv, k: int, names, measure: bool,
                    devices=None) -> dict:
    """One trainer of a graph-strategies run: built from ``argv`` at K =
    ``k`` (K = 1 with capturable Adam), trained, its losses, weights,
    buffers and launches kept; then measured (``_gs_measure``). Its graph
    is kept (``_keeping_graphs``) for ``_graph_kernels``."""
    import torch

    from distributedpytorch_tpu_torch.ops import kernels

    counts = {"built": 0}
    with _counting_ddp(counts):
        trainer, close = _gs_trainer(
            run, [*argv, "--steps-per-dispatch", str(k)], devices)
    try:
        if k == 1:
            _capturable_(trainer.optimizer)
        kernels.reset_launches()
        with _keeping_graphs():
            result = trainer.train()
        torch.cuda.synchronize()
        out = {"steps": result["steps"], "launches": dict(kernels.LAUNCHES),
               "losses": [float(x) for x in trainer.records.losses],
               "state": [t.detach().clone() for t in
                         trainer.model.state_dict().values()],
               "strategy": trainer.strategy.name,
               "ddp_wrappers": counts["built"]}
        if measure:
            out.update(_gs_measure(trainer, k, names))
    finally:
        close()
        del trainer
        torch.cuda.empty_cache()
    return out


def _gs_expected_per_replay(label: str) -> dict:
    """The kernels one replay of GS_K steps runs: K1 and K1-bwd once per
    step under DDP (one shard per rank); under MP M per step each (gpipe),
    K1 2M under 1f1b (phase A and the recomputation); milesial's K2, K3,
    K5 18, 18 and 13 per microbatch under gpipe."""
    m = MP_MICROBATCHES
    if label.startswith("ddp"):
        return {"loss_stats": GS_K, "loss_stats_bwd": GS_K}
    want = {"loss_stats": GS_K * m * (2 if label == "mp_1f1b" else 1),
            "loss_stats_bwd": GS_K * m}
    if label.startswith("milesial"):
        want.update(bn_act=GS_K * 18 * m, bn_act_bwd=GS_K * 18 * m,
                    wgrad_9tap=GS_K * 13 * m)
    return want


def _gs_run(tmp: str, label: str, extra, samples: int, epochs: int,
            wgrad: bool) -> dict:
    """One row of train_graph_strategies: the run at K = GS_K and at K = 1
    (capturable Adam), the losses and the state bitwise; for
    GS_RESUMED also a third epoch resumed from each run's checkpoint at
    its own K."""
    import torch

    dev = torch.device("cuda", 0)
    devices = [dev] * MP_STAGES if "-t" in extra and "MP" in extra else None
    names = tuple(_gs_expected_per_replay(label))
    runs = {}
    for k in (GS_K, 1):
        run = os.path.join(tmp, f"gs_{label}_k{k}")
        argv = _rc_argv(run, "-e", str(epochs), "--dtype", "bf16", *extra,
                        samples=samples)

        def one(run=run, argv=argv, k=k):
            out = _gs_trainer_run(run, argv, k, names, True, devices)
            if label == GS_RESUMED:
                again = os.path.join(run, "resumed")
                out["resumed"] = _gs_trainer_run(
                    again, [*argv, "-e", str(epochs + 1), "-c", "MP"], k,
                    names, False, devices)
            return out

        runs[k] = _with_wgrad_backend(one) if wgrad else one()
    graph, eager = runs[GS_K], runs[1]

    def same(a, b):
        return (a["losses"] == b["losses"]
                and all(torch.equal(x, y) for x, y in zip(a["state"],
                                                          b["state"])))

    row = {"phase": "train_graph_strategies", "run": label, "k": GS_K,
           "strategy": graph["strategy"], "steps": graph["steps"],
           "cudnn_deterministic": True,
           "bitwise_equal_to_k1": same(graph, eager),
           "loss_max_rel_err_vs_k1": max(
               abs(a - b) / abs(b)
               for a, b in zip(graph["losses"], eager["losses"])),
           "graph_launches_per_replay": graph["replay_launches"]["nodes"],
           "traced_launches_per_replay": graph["replay_launches"]["traced"],
           "k1_step_launches_traced": eager["traced_launches_per_call"],
           "expected_per_replay": _gs_expected_per_replay(label),
           "launches": {"k4": graph["launches"], "k1": eager["launches"]},
           "ddp_wrappers": [graph["ddp_wrappers"], eager["ddp_wrappers"]],
           **{f"{key}_{name}": run_[key]
              for name, run_ in (("k4", graph), ("k1", eager))
              for key in ("step_ms", "host_enqueue_ms_per_step",
                          "wall_ms_per_step", "device_busy_ms_per_step",
                          "device_idle_share")},
           "device": torch.cuda.get_device_name(0)}
    if label == GS_RESUMED:
        row["resumed_steps"] = graph["resumed"]["steps"]
        row["resumed_bitwise_equal_to_k1"] = same(graph["resumed"],
                                                  eager["resumed"])
    emit(row)
    return row


def phase_train_graph_strategies(tmp: str) -> dict:
    """The CUDA graph of K steps outside singleGPU on the one card, through
    the training CLI's own functions, full width, cuDNN's deterministic
    algorithms: the UNet under ``-t DDP`` at world 1 (NCCL), under bf16
    and bf16_params; under ``-t MP`` on ``[cuda:0, cuda:0]``, gpipe and
    1f1b at M = 2; milesial ``--wgrad-taps`` under MP gpipe. Each run at
    K = GS_K against K = 1 with the same capturable Adam: the losses and
    the weights bitwise equal, one replay's kernels counted by name
    against ``_gs_expected_per_replay``, under DDP one DDP wrapper for the
    graph and the tail, the step by CUDA events, the host's enqueue and
    the idle share of both. The MP gpipe run trains two epochs (an eval
    between the replays) and resumes for a third (``-c``), graph and
    eager bitwise again. Returns the rows by label."""
    import torch

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        rows = {label: _gs_run(tmp, label, extra, samples, epochs, wgrad)
                for label, extra, samples, epochs, wgrad in GS_RUNS}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for label, row in rows.items():
        check(row["bitwise_equal_to_k1"],
              f"graph {label}: losses or weights off K = 1 (loss rel "
              f"{row['loss_max_rel_err_vs_k1']})")
        _check_replay(f"graph {label}",
                      {"nodes": row["graph_launches_per_replay"],
                       "traced": row["traced_launches_per_replay"]},
                      row["expected_per_replay"])
        if label.startswith("ddp"):
            check(row["ddp_wrappers"] == [1, 1],
                  f"graph {label}: {row['ddp_wrappers']} DDP wrappers")
    resumed = rows[GS_RESUMED]
    check(resumed["resumed_bitwise_equal_to_k1"]
          and resumed["resumed_steps"] == 3 * resumed["steps"] // 2,
          f"graph {GS_RESUMED}: the resumed epoch is off K = 1 "
          f"({resumed['resumed_steps']} steps)")
    return rows


# -- the K-step graph across cards (--cards) ----------------------------------------

# the per-card guard the graph runs across cards hold between stacks: a
# tensor this large, filled with GUARD_VALUE, on every card of the step
GUARD_BYTES = 256 * 2**20
GUARD_VALUE = 7.0


def _guards(devices) -> list:
    """After ``torch.cuda.empty_cache()``: a GUARD_BYTES tensor of
    GUARD_VALUE on each of ``devices``, allocated on its current stream.
    If a graph's memory on a card had gone back to its cache, the release
    and these allocations could take it, and the next replay write into
    them."""
    import torch

    torch.cuda.empty_cache()
    return [torch.full((GUARD_BYTES // 4,), GUARD_VALUE, device=d)
            for d in dict.fromkeys(devices)]


def _graph_and_eager(build, stacks, k: int) -> dict:
    """The same ``stacks`` (``(k, B, ...)`` batches on the step's first
    card) through ``build()``'s step (``_graph_build``: a fresh model from
    the seed's weights, its strategy's train step, capturable Adam):
    eagerly, k steps per stack, and through ``MultiStep`` over the
    strategy's cards (its eager warm-up, then one graph of k steps).
    After every stack: the step's losses, a digest of the weights, and
    fresh guards (``_guards``) on every card, checked after the next
    stack. Returns both sides, each with its model, step and multi-step
    for timing. cuDNN keeps to its deterministic algorithms meanwhile
    (ROADMAP trap 5)."""
    import torch

    from distributedpytorch_tpu_torch.train.steps import MultiStep

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _graph_and_eager_sides(build, stacks, k, MultiStep)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _graph_and_eager_sides(build, stacks, k: int, multi_step) -> dict:
    import torch

    sides = {}
    for mode in ("eager", "graph"):
        model, step, strategy = build()
        devices = strategy.step_devices
        multi = multi_step(step, k, devices,
                           warmup_steps=strategy.capture_warmup_steps,
                           streams=strategy.capture_streams)
        losses, digests, held, guards_ok = [], [], [], True
        for stacked in stacks:
            if mode == "graph":
                got = multi(stacked)
            else:
                got = torch.stack([step({key: v[j] for key, v in
                                         stacked.items()})
                                   for j in range(k)])
            _sync_all(devices)
            losses.extend(float(x) for x in got.cpu())
            digests.append(_digest(model.state_dict().values()))
            guards_ok = guards_ok and all(
                bool((g == GUARD_VALUE).all()) for g in held)
            held = _guards(devices)
        sides[mode] = {"losses": losses, "digests": digests,
                       "guards_intact": guards_ok, "model": model,
                       "step": step, "multi": multi}
    sides["bitwise_equal"] = (
        sides["graph"]["losses"] == sides["eager"]["losses"]
        and sides["graph"]["digests"] == sides["eager"]["digests"])
    return sides


def _timed_sides(sides: dict, stacked, k: int, devices) -> dict:
    """Per step, eager (one step) and graph (one replay of k): the wall
    ms with every card drained, the host's enqueue ms, each card's busy
    ms and the bubble 1 − mean busy / step."""
    import torch

    row = {}
    first = {key: v[0] for key, v in stacked.items()}
    for mode, fn, n in (
            ("eager", lambda: sides["eager"]["step"](first), 1),
            ("graph", lambda: sides["graph"]["multi"](stacked), k)):
        wall = _wall_ms(fn, 3, 1, devices) / n
        _sync_all(devices)
        t0 = time.perf_counter()
        fn()
        host = (time.perf_counter() - t0) * 1e3 / n
        _sync_all(devices)
        busy = {i: ms / n for i, ms in
                _busy_ms_by_device(fn, 2, devices).items()}
        cards = sorted({torch.device(d).index for d in devices})
        row[mode] = {"step_ms": wall, "host_enqueue_ms_per_step": host,
                     "busy_ms_by_card": busy,
                     "bubble": 1.0 - sum(busy.get(i, 0.0) for i in cards)
                     / len(cards) / wall}
    _sync_all(devices)
    t0 = time.perf_counter()
    sides["graph"]["multi"]._graph.replay()
    # the host's time in cudaGraphLaunch alone, per step
    row["graph"]["launch_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / k
    _sync_all(devices)
    row["graph_speedup"] = row["eager"]["step_ms"] / row["graph"]["step_ms"]
    return row


def _rolled_stacks(batch: dict, k: int, n: int) -> list:
    """``n`` stacks of ``k`` batches from ``batch`` (``k·B`` rows), the
    rows rolled by one more for each stack."""
    import torch

    b = batch["image"].shape[0] // k
    return [{key: torch.roll(v, i, 0).reshape(k, b, *v.shape[1:])
             for key, v in batch.items()} for i in range(n)]

#: what the refusal of K > 1 over a gloo group on a card says
GLOO_REFUSAL = "gloo moves CUDA tensors through the host"


def _refusal(cfg, devices):
    """The message ``build_strategy`` raises for ``cfg`` on ``devices``,
    or None if it builds."""
    from distributedpytorch_tpu_torch.parallel.strategy import build_strategy

    try:
        build_strategy(cfg, devices=devices)
    except ValueError as exc:
        return str(exc)
    return None


def _ranks_graph_rows(ranks, world: int) -> dict:
    """The ranks' graph runs (``_rank_graph_run``) side by side: each
    rank's graph against its eager steps, the ranks' weights after every
    stack bitwise equal, the step by wall time and the images per second
    of the slowest rank, eager and graph."""
    rows = [r["graph"] for r in ranks]
    out = {"bitwise_equal_to_eager": [r["bitwise_equal"] for r in rows],
           "guards_intact": [r["guards_intact"] for r in rows],
           "ranks_weights_equal_every_stack": all(
               r["digests"] == rows[0]["digests"] for r in rows),
           "ranks_losses_equal": all(r["losses"] == rows[0]["losses"]
                                     for r in rows),
           "graph_speedup_by_rank": [r["graph_speedup"] for r in rows]}
    for mode in ("eager", "graph"):
        step = max(r[mode]["step_ms"] for r in rows)
        out[mode] = {
            "step_ms_by_rank": [r[mode]["step_ms"] for r in rows],
            "host_enqueue_ms_per_step_by_rank": [
                r[mode]["host_enqueue_ms_per_step"] for r in rows],
            "busy_ms_by_card": [r[mode]["busy_ms_by_card"] for r in rows],
            "bubble_by_rank": [r[mode]["bubble"] for r in rows],
            "images_per_s": world * TRAIN_BATCH * 1e3 / step}
    return out


def _check_ranks_graph(rows: dict, what: str) -> None:
    check(all(rows["bitwise_equal_to_eager"]) and all(rows["guards_intact"]),
          f"{what}: a rank's graph is off its eager steps, or wrote into "
          f"eager memory")
    check(rows["ranks_weights_equal_every_stack"]
          and rows["ranks_losses_equal"],
          f"{what}: the ranks' weights or losses differ")



def _graph_build(cfg, devices=None, init=None):
    """``build()`` for ``_graph_and_eager``: ``cfg``'s strategy (on
    ``devices``), the full-width model from the seed's weights (or
    ``init``) placed by it, capturable Adam at the strategy's lr, and its
    train step; returns ``(model, step, strategy)``."""
    import torch

    from distributedpytorch_tpu_torch.models import create_model
    from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
    from distributedpytorch_tpu_torch.ops.optim import make_optimizer
    from distributedpytorch_tpu_torch.parallel.strategy import build_strategy

    def build():
        strategy = build_strategy(cfg, devices=devices)
        model = create_model(cfg, generator=torch.Generator().manual_seed(
            SEED))
        if init is not None:
            model.load_state_dict(init)
        model = strategy.place_model(model)
        opt = make_optimizer(model.parameters(),
                             strategy.lr_for(cfg.learning_rate),
                             cfg.weight_decay, capturable=True)
        return model, strategy.build_train_step(
            model, opt, get_kernel_policy(cfg.kernels)), strategy

    return build


def _rank_stacks(rank: int, world: int, per_rank: int, n: int, device):
    """``n`` stacks of GS_K of this rank's rows of the global synthetic
    batches, on ``device``."""
    import numpy as np
    import torch

    rows = slice(rank * per_rank, (rank + 1) * per_rank)
    batches = _ddp_batches(world, per_rank, GS_K * n)
    return [{key: torch.from_numpy(np.stack(
        [b[key][rows] for b in batches[i * GS_K:(i + 1) * GS_K]])).to(device)
        for key in batches[0]} for i in range(n)]


def _rank_graph_run(cfg, rank: int, world: int, devices, stacks_n: int
                    ) -> dict:
    """One rank's graph against eager (``_graph_and_eager``) of ``cfg``'s
    strategy over ``stacks_n`` stacks of its rows, then both timed
    (``_timed_sides``); the losses and digests per stack for the ranks'
    comparison."""
    import torch

    stacks = _rank_stacks(rank, world, cfg.batch_size, stacks_n, devices[0])
    sides = _graph_and_eager(_graph_build(cfg, devices), stacks, GS_K)
    row = {"bitwise_equal": sides["bitwise_equal"],
           "guards_intact": all(sides[m]["guards_intact"]
                                for m in ("eager", "graph")),
           "losses": sides["graph"]["losses"],
           "digests": sides["graph"]["digests"],
           **_timed_sides(sides, stacks[0], GS_K, devices)}
    del sides, stacks
    torch.cuda.empty_cache()
    return row


# the kernel probes, the profiler window, the preemption stop and the
# .ckpt round trip (phase_probes .. phase_ckpt_roundtrip)
PROBE_NAMES = ("conv_epilogue", "eval_stats", "fused_loss", "serve_mask",
               "wgrad_9tap")
# the profiler window's runs: --synthetic 30 -v 20 -b 4 -e 1, 24 train
# samples (6 steps) and one eval batch, steps [2, 4) at K = 1 and K = 2
PW_SAMPLES = 30
PW_STEPS = (2, 4)
PW_TIMED = 10
# the preempted run: --synthetic 30 -v 20 -b 4 -e 2 (6 steps an epoch),
# SIGTERM from this process once step 3 has run
PREEMPT_SAMPLES = 30
PREEMPT_AT = 3
PREEMPT_TIMEOUT_S = 300


def _kernel_warnings():
    """``(messages, close)``: the warnings ``ops/kernels.py`` logs until
    ``close()``."""
    messages = []

    class Collect(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    handler = Collect(logging.WARNING)
    log = logging.getLogger("distributedpytorch_tpu_torch.ops.kernels")
    log.addHandler(handler)
    return messages, lambda: log.removeHandler(handler)


def phase_probes(tmp: str) -> dict:
    """``ops/probes.run_probes`` on the card: each kernel built, launched
    once in a child process of its own and held against its plain
    version, all five accepted; the priors file written and read back;
    then a file that rejects ``conv_epilogue`` given to the training CLI
    (``--kernel-priors``) for a full-width milesial step: K2 and K3 launch
    0 times, K1, K1-bwd and K5 as before, with the warning logged."""
    import torch

    from distributedpytorch_tpu_torch.ops import kernels, probes

    t0 = time.perf_counter()
    payload = probes.run_probes(device="cuda")
    probe_s = time.perf_counter() - t0
    rows = payload["kernels"]
    check(sorted(rows) == list(PROBE_NAMES), f"probed {sorted(rows)}")
    for name, row in rows.items():
        check(row["accepted"], f"probe {name} rejected on the card: "
              f"{row.get('reason')}")
    check(payload["platform"] == "gpu"
          and payload["device_kind"] == torch.cuda.get_device_name(0),
          f"priors platform {payload['platform']}, {payload['device_kind']}")
    path = os.path.join(tmp, "kernel_priors.json")
    kernels.save_priors(payload, path)
    check(kernels.load_priors(path) == payload, "the priors file round trip")

    rejecting = os.path.join(tmp, "kernel_priors_rejecting.json")
    kernels.save_priors({**payload, "kernels": {**rows, "conv_epilogue": {
        "accepted": False, "reason": "rejected by chip_smoke.py",
        "compile_s": 0.0}}}, rejecting)
    run = os.path.join(tmp, "probes_milesial")
    warnings, stop_collecting = _kernel_warnings()

    def step():
        trainer, close = _cli_trainer(run, _rc_argv(
            run, "-e", "1", "--model", "milesial", "--wgrad-taps",
            "--kernel-priors", rejecting, samples=10))
        try:
            batch = _first_batch(trainer)
            kernels.reset_launches()
            loss = float(trainer.train_step(batch))
            torch.cuda.synchronize()
            return loss, dict(kernels.LAUNCHES), trainer.kernels
        finally:
            close()

    try:
        loss, launches, policy = _with_wgrad_backend(step)
    finally:
        stop_collecting()
    out = {"phase": "probes", "kernels": rows, "probe_wall_s": probe_s,
           "rejecting_file": {"policy": dataclasses.asdict(policy),
                              "launches_one_step": launches, "loss": loss,
                              "warnings": warnings},
           "device": torch.cuda.get_device_name(0)}
    emit(out)
    check(not policy.conv_epilogue and policy.train_loss_fused
          and policy.wgrad_cuda, f"policy under the rejecting file {policy}")
    check(launches["bn_act"] == 0 and launches["bn_act_bwd"] == 0
          and launches["wgrad_9tap"] == 13 and launches["loss_stats"] == 1
          and launches["loss_stats_bwd"] == 1,
          f"one milesial step under the rejecting file launched {launches}")
    check(sum("conv_epilogue" in w and "rejected" in w
              for w in warnings) == 1, f"warnings {warnings}")
    return out


def _trace_launches(path: str) -> dict:
    """Kernel launches by counter name in a chrome trace the profiler
    window wrote."""
    import re

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {key: sum(bool(re.search(rf"\b{sym}\b", n)) for n in names)
            for key, sym in KERNEL_SYMBOLS.items()}


def _pw_run(tmp: str, k: int, window: bool) -> dict:
    """One ``--steps-per-dispatch k`` run of the full-width UNet, with or
    without ``--profile-steps 2:4``; its losses, what the window wrote,
    and the step (or K-step dispatch) timed with and without a profiler,
    in turns."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run = os.path.join(tmp, f"pw_k{k}_{'window' if window else 'plain'}")
    extra = ["-e", "1", "--steps-per-dispatch", str(k)]
    if window:
        extra += ["--profile-steps", f"{PW_STEPS[0]}:{PW_STEPS[1]}",
                  "--profile-dir", os.path.join(run, "profile")]
    trainer, close = _cli_trainer(run, _rc_argv(run, *extra,
                                                samples=PW_SAMPLES))
    try:
        trainer.train()
        out = {"losses": [float(x) for x in trainer.records.losses]}
        if not window:
            return out
        out["trace"] = os.path.relpath(trainer.profile_window.path, run)
        out["trace_bytes"] = os.path.getsize(trainer.profile_window.path)
        out["traced_launches"] = _trace_launches(trainer.profile_window.path)
        out["profiler_left_running"] = torch.autograd._profiler_enabled()
        batches = _placed_batches(trainer, k)
        if k == 1:
            def fn():
                return trainer.train_step(batches[0])
        else:
            stacked = {key: torch.stack([b[key] for b in batches])
                       for key in batches[0]}

            def fn():
                return trainer.multi_step(stacked)
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        timed = {"plain": [], "profiled": []}
        for turn in ("plain", "profiled", "profiled", "plain"):
            if turn == "plain":
                timed[turn].append(_wall_ms(fn, PW_TIMED, 2) / k)
            else:
                with profile(activities=acts):
                    timed[turn].append(_wall_ms(fn, PW_TIMED, 2) / k)
        out["step_wall_ms"] = {key: sum(v) / len(v)
                               for key, v in timed.items()}
        out["step_wall_ms_turns"] = timed
        return out
    finally:
        close()


def phase_profile_window(tmp: str) -> dict:
    """The profiler window on the card: the full-width bf16 UNet, -b 4,
    ``--profile-steps 2:4`` at K = 1 and K = 2 (one CUDA graph of 2 steps,
    the window rounded out to whole replays), each against the same run
    without the window under cuDNN's deterministic algorithms: the losses
    bitwise equal, the chrome trace written with K1 and K1-bwd by name
    (2 and 2: steps 3 and 4), no profiler left running, and the step's
    wall time with and without a profiler."""
    import torch

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {"phase": "profile_window", "steps": list(PW_STEPS)}
    try:
        for k in (1, 2):
            plain = _pw_run(tmp, k, window=False)
            windowed = _pw_run(tmp, k, window=True)
            windowed["losses_bitwise_equal"] = (windowed["losses"]
                                                == plain["losses"])
            out[f"k{k}"] = windowed
    finally:
        torch.backends.cudnn.deterministic = deterministic
    out["device"] = torch.cuda.get_device_name(0)
    emit(out)
    for k in (1, 2):
        row = out[f"k{k}"]
        check(row["losses_bitwise_equal"],
              f"K = {k}: the window changed the losses")
        check(row["trace"] == f"profile/singleGPU.rank0.steps"
              f"{PW_STEPS[0]}-{PW_STEPS[1]}.pt.trace.json",
              f"K = {k}: trace {row['trace']}")
        n = row["traced_launches"]
        check(n["loss_stats"] == 2 and n["loss_stats_bwd"] == 2,
              f"K = {k}: the window's trace holds K1 / K1-bwd {n}")
        check(not row["profiler_left_running"], "a profiler left running")
    return out


def preempt_child(run: str, argv_json: str) -> int:
    """``--preempt-child RUN ARGV``: the training CLI's trainer for
    ``ARGV`` in ``RUN``; once step PREEMPT_AT has run it writes
    ``RUN/step<N>`` and waits for the signal this script's parent sends.
    Exits 0 when the run stops and its checkpoint is on disk."""
    import torch

    trainer, close = _cli_trainer(run, json.loads(argv_json))
    real = trainer.train_step
    marker = os.path.join(run, f"step{PREEMPT_AT}")

    def step(batch):
        loss = real(batch)
        if trainer.step + 1 == PREEMPT_AT:
            torch.cuda.synchronize()
            open(marker, "w").close()
            deadline = time.monotonic() + PREEMPT_TIMEOUT_S
            while not trainer._stop_requested:
                check(time.monotonic() < deadline, "no signal came")
                time.sleep(0.01)
        return loss

    trainer.train_step = step
    try:
        result = trainer.train()
    finally:
        close()
    emit({"preempt_child": result})
    return 0


def phase_preempt(tmp: str) -> dict:
    """The preemption stop on the card: a child process trains the
    full-width UNet through the CLI's functions (``--synthetic 30 -v 20
    -b 4 -e 2``, 6 steps an epoch), gets SIGTERM from this process once
    step 3 has run, and exits 0 with ``singleGPU.pt`` at epoch index 0,
    step 3; then ``-c`` resumes it here, redoing the epoch, to the end
    (3 + 12 steps)."""
    import signal

    import torch

    from distributedpytorch_tpu_torch.checkpoint import load_native

    run = os.path.join(tmp, "preempt")
    argv = _rc_argv(run, "-e", "2", samples=PREEMPT_SAMPLES)
    marker = os.path.join(run, f"step{PREEMPT_AT}")
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--preempt-child", run,
         json.dumps(argv)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        while not os.path.exists(marker):
            check(child.poll() is None, f"the child exited {child.returncode}"
                  f" before step {PREEMPT_AT}")
            check(time.perf_counter() - t0 < PREEMPT_TIMEOUT_S,
                  "the child did not reach its step")
            time.sleep(0.05)
        signalled_s = time.perf_counter() - t0
        child.send_signal(signal.SIGTERM)
        log, _ = child.communicate(timeout=PREEMPT_TIMEOUT_S)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    stopped_s = time.perf_counter() - t0
    path = os.path.join(run, "checkpoints", "singleGPU.pt")
    check(child.returncode == 0, f"the signalled child exited "
          f"{child.returncode}:\n{log[-3000:]}")
    saved = load_native(path)
    resumed_run = run + "_resumed"
    trainer, close = _cli_trainer(resumed_run, _rc_argv(
        resumed_run, "-e", "2", "-c", path, samples=PREEMPT_SAMPLES))
    try:
        start = (trainer.start_epoch, trainer.step)
        result = trainer.train()
    finally:
        close()
    out = {"phase": "preempt", "saved": {"epoch": saved["epoch"],
                                         "step": saved["step"]},
           "child_exit": child.returncode, "signalled_after_s": signalled_s,
           "child_stopped_after_s": stopped_s, "resumed_at": list(start),
           "resumed_result": result,
           "stopped_by_signal": "Stopped by signal at epoch 1 step 3" in log,
           "device": torch.cuda.get_device_name(0)}
    emit(out)
    check((saved["epoch"], saved["step"]) == (0, PREEMPT_AT)
          and out["stopped_by_signal"], f"the stop saved {out['saved']}")
    check(start == (0, PREEMPT_AT) and result["steps"] == PREEMPT_AT + 12,
          f"the resume ran from {start} to {result['steps']} steps")
    return out


def _payloads_equal(a, b) -> bool:
    """Two checkpoint payloads hold the same values, tensors bit for bit
    and in the same dtypes."""
    import torch

    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a.cpu(), b.cpu()))
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(_payloads_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_payloads_equal(x, y) for x, y in zip(a, b)))
    return a == b or (a != a and b != b)


def _optimizer_states_equal(a: dict, b: dict) -> bool:
    """Two optimizer state dicts hold the same Adam state (the f32 master
    under bf16_params), tensors bit for bit, and the same lr; the other
    group settings are each run's own."""
    if "master" in a:
        if not ("master" in b and _payloads_equal(a["master"],
                                                  b["master"])):
            return False
        a, b = a["inner"], b["inner"]
    return (_payloads_equal(a["state"], b["state"])
            and float(a["param_groups"][0]["lr"])
            == float(b["param_groups"][0]["lr"]))


def phase_ckpt_roundtrip(tmp: str) -> dict:
    """Full-width milesial states (``train_milesial``'s bf16 checkpoint
    after 4 steps, ``train_run_control``'s bf16_params one after 2)
    through ``save_jax_ckpt`` and ``load_jax_ckpt``: the model, Adam's
    state (and the f32 master), scheduler, step, epoch, records and
    trainer state bitwise; then the training CLI's trainer resumes the
    ``.ckpt`` (``-c``) and holds the same model and optimizer state on
    the card, bit for bit. The card's machine has no JAX: the checks
    against the JAX package are the CPU tests'."""
    import torch

    from distributedpytorch_tpu_torch import checkpoint

    out = {"phase": "ckpt_roundtrip"}
    for label, src in (
            ("milesial_bf16", os.path.join(tmp, "train_milesial",
                                           "checkpoints", "singleGPU.pt")),
            ("milesial_bf16_params", os.path.join(
                tmp, "rc_bf16p_milesial_bf16_params", "checkpoints",
                "singleGPU.pt"))):
        saved = checkpoint.load_native(src)
        dst = os.path.join(tmp, f"roundtrip_{label}.ckpt")
        t0 = time.perf_counter()
        checkpoint.save_jax_ckpt(saved, dst)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = checkpoint.load_jax_ckpt(dst)
        load_s = time.perf_counter() - t0
        same = {key: _payloads_equal(saved[key], back[key])
                for key in ("model", "scheduler", "step", "epoch",
                            "records", "train_meta")}
        same["optimizer"] = _optimizer_states_equal(saved["optimizer"],
                                                    back["optimizer"])
        run = os.path.join(tmp, f"roundtrip_{label}_resumed")
        trainer, close = _cli_trainer(run, _rc_argv(
            run, "-e", "2", "--model", "milesial", "--dtype",
            saved["manifest"]["dtype"], "-c", dst, samples=10))
        try:
            on_card = next(trainer.model.parameters()).device.type
            same["model_on_the_card"] = _payloads_equal(
                saved["model"], trainer.model.state_dict())
            same["optimizer_on_the_card"] = _optimizer_states_equal(
                saved["optimizer"], trainer.optimizer.state_dict())
            same["step_resumed"] = trainer.step == saved["step"]
        finally:
            close()
        out[label] = {"bytes": os.path.getsize(dst), "save_s": save_s,
                      "load_s": load_s, "resumed_on": on_card, "equal": same}
    out["device"] = torch.cuda.get_device_name(0)
    emit(out)
    for label in ("milesial_bf16", "milesial_bf16_params"):
        row = out[label]
        check(row["resumed_on"] == "cuda" and all(row["equal"].values()),
              f"{label}: {row}")
    return out


# -- -t SP and -t DDP_SP --------------------------------------------------------

# the row shards of train_sp and of each train_ddp_sp_gloo2 rank: two shard
# threads on the one card ([cuda:0, cuda:0])
SP_SHARDS = 2
# SP step 1 against a singleGPU step from the same weights and batch: the
# loss's relative error, each UNet gradient's largest error relative to
# its tensor's largest and each milesial gradient's relative L2. float32
# at PERF.md §2's card bounds for a step laid out otherwise (MP against
# singleGPU: 1e-5, 1e-3; milesial 1e-5, 2e-2 as kernels cuda vs torch).
# bf16: each shard's weight gradient comes out of cuDNN (or the taps)
# rounded to bf16, and the shards' are added after it, where the whole
# image's is rounded once: an element moves by up to a bf16 step, 2^-8 of
# itself, more where it nearly cancels (measured on an H100: 5.2e-3 of a
# tensor's largest, the mid block's bias), so the UNet's is held within
# two bf16 steps, 2^-7; milesial's by its bf16 bound for two paths that
# round differently (MILESIAL_PARITY: a random-init bf16 milesial step
# moves its gradients by tens of percent for a bf16 ulp, ROADMAP trap 3)
SP_BOUNDS = {
    "bf16": {"unet_loss": 1e-5, "unet_grad": 2.0 ** -7,
             "milesial_loss": MILESIAL_PARITY["bf16"]["loss"],
             "milesial_grad_rel_l2": MILESIAL_PARITY["bf16"]["grad_rel_l2"]},
    "f32": {"unet_loss": 1e-5, "unet_grad": STEP_GRAD_RTOL,
            "milesial_loss": MILESIAL_PARITY["f32"]["loss"],
            "milesial_grad_rel_l2": MILESIAL_PARITY["f32"]["grad_rel_l2"]},
}
# milesial's BatchNorms and the 3x3 convs that engage K5 (both sides >= 128
# channels), each once per shard and step
MILESIAL_BATCHNORMS = 18
MILESIAL_K5_CONVS = 13
SP_KERNELS = ("loss_stats", "loss_stats_bwd", "bn_act", "bn_act_bwd",
              "wgrad_9tap")
SP_TIMED_STEPS = 5
# the DDP_SP ranks: model and steps, -b 4 per rank over two shards, bf16,
# milesial with --wgrad-taps under DPT_WGRAD_BACKEND=pallas
DDP_SP_RUNS = (("unet", 2), ("milesial", 2))


def _sp_expected_per_step(arch: str, shards: int) -> dict:
    """A step's launches under SP: K1 and K1-bwd once per shard; for
    milesial K2 and K3 once per BatchNorm and shard, K5 once per engaged
    conv and shard."""
    want = {"loss_stats": shards, "loss_stats_bwd": shards}
    if arch == "milesial":
        want.update(bn_act=MILESIAL_BATCHNORMS * shards,
                    bn_act_bwd=MILESIAL_BATCHNORMS * shards,
                    wgrad_9tap=MILESIAL_K5_CONVS * shards)
    return want


def _sp_model_step(method: str, arch: str, devices, dtype: str,
                   kernels_name: str = "cuda",
                   batch_size: int = TRAIN_BATCH, lr: float = 0.0):
    """``(model, step, strategy)``: ``method``'s (SP, DDP_SP or
    singleGPU) train step over ``devices`` for the full-width ``arch``
    (milesial with ``--wgrad-taps``) from the seed's weights; SGD at
    ``lr``, 0 by default, so the step keeps the gradients and leaves the
    weights."""
    import torch

    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.models import create_model
    from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
    from distributedpytorch_tpu_torch.parallel.strategy import build_strategy

    cfg = TrainConfig(train_method=method, model_arch=arch, dtype=dtype,
                      kernels=kernels_name, device="cuda",
                      batch_size=batch_size, wgrad_taps=arch == "milesial")
    strategy = build_strategy(cfg, devices=devices)
    model = create_model(cfg, generator=torch.Generator().manual_seed(SEED))
    model = strategy.place_model(model)
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    step = strategy.build_train_step(model, opt,
                                     get_kernel_policy(kernels_name))
    return model, step, strategy


def _running_stats(model) -> dict:
    return {n: b.clone() for n, b in model.named_buffers() if "running" in n}


def _step_against(a: dict, ref: dict) -> dict:
    """One step's loss, gradients and running statistics against another's
    (``{"loss", "grads", "stats"}``)."""
    rel_l2 = {n: float((a["grads"][n] - g).norm() / g.norm())
              for n, g in ref["grads"].items()}
    worst = max(rel_l2, key=rel_l2.get)
    row = {"loss": a["loss"], "ref_loss": ref["loss"],
           "loss_rel_err": abs(a["loss"] - ref["loss"]) / ref["loss"],
           "grad_max_err_rel_to_tensor_max": _max_err_rel(a["grads"],
                                                          ref["grads"]),
           "grad_max_rel_l2": rel_l2[worst], "grad_worst_tensor": worst,
           "grad_median_rel_l2": sorted(rel_l2.values())[len(rel_l2) // 2]}
    if ref["stats"]:
        row["running_stats_max_err_rel_to_tensor_max"] = _max_err_rel(
            a["stats"], ref["stats"])
    return row


def _within_sp_bounds(arch: str, dtype: str, row: dict) -> bool:
    """Whether a step's row (``_step_against``) holds SP_BOUNDS."""
    bound = SP_BOUNDS[dtype]
    if arch == "unet":
        return (row["loss_rel_err"] <= bound["unet_loss"]
                and row["grad_max_err_rel_to_tensor_max"]
                <= bound["unet_grad"])
    return (row["loss_rel_err"] <= bound["milesial_loss"]
            and row["grad_max_rel_l2"] <= bound["milesial_grad_rel_l2"])


def _sp_step_rows(arch: str, devices, batch) -> dict:
    """Per dtype: one SP step over ``devices`` against one singleGPU step
    on the first of them, from the seed's weights on ``batch``, with
    SP_BOUNDS' verdict."""
    import torch

    rows = {}
    for dtype in ("bf16", "f32"):
        runs = {}
        for method, devs in (("SP", devices), ("singleGPU", devices[:1])):
            model, step, _ = _sp_model_step(method, arch, devs, dtype)
            runs[method] = {"loss": float(step(batch)),
                            "grads": _grads(model),
                            "stats": _running_stats(model)}
            del model, step
            torch.cuda.empty_cache()
        row = _step_against(runs["SP"], runs["singleGPU"])
        row["ok"] = _within_sp_bounds(arch, dtype, row)
        rows[dtype] = row
        del runs
    return rows


def _sp_in_place(arch: str, devices, batch) -> dict:
    """One float32 SP step with the kernels against the same step with
    every kernel swapped for its plain version on the card
    (``_PlainVersions``): the kernels on the shards' shapes."""
    import torch

    from distributedpytorch_tpu_torch.ops import kernels

    runs = {}
    for plain in (False, True):
        model, step, _ = _sp_model_step("SP", arch, devices, "f32")
        kernels.reset_launches()
        with (_PlainVersions() if plain else contextlib.nullcontext()):
            loss = float(step(batch))
        runs[plain] = {"loss": loss, "launches": dict(kernels.LAUNCHES),
                       "grads": _grads(model), "stats": _running_stats(model)}
        del model, step
        torch.cuda.empty_cache()
    check(not any(runs[True]["launches"].values()),
          f"plain versions launched {runs[True]['launches']}")
    a, b = runs[False], runs[True]
    row = _step_against(a, b)
    diff = torch.cat([(a["grads"][n] - g).flatten()
                      for n, g in b["grads"].items()])
    whole = torch.cat([g.flatten() for g in b["grads"].values()])
    row.update(launches=a["launches"],
               grad_global_rel_l2=float(diff.norm() / whole.norm()),
               running_stats_bitwise_equal=all(
                   torch.equal(a["stats"][n], t)
                   for n, t in b["stats"].items()))
    row["ok"] = (row["running_stats_bitwise_equal"]
                 and row["loss_rel_err"] <= IN_PLACE_LOSS_RTOL
                 and row["grad_global_rel_l2"] <= IN_PLACE_GRAD_GLOBAL_REL_L2
                 and row["grad_max_rel_l2"] <= IN_PLACE_GRAD_REL_L2)
    return row


def _sp_shard_kernels(devices) -> dict:
    """Each kernel of the SP path against its plain version on the shapes
    one of two shards gives it at full width, batch 4: K1 and K1-bwd on a
    shard's (4, 320, 960, 1) predictions, K2 and K3 on milesial's widest
    BatchNorm input of a shard (4, 64, 320, 960) float32, K5 on its first
    engaged conv's halo'd input (4, 162, 480, 128) bf16 with the dy padded
    by a zero row each side. The largest error relative to the plain
    version's largest element, and the largest absolute error."""
    import torch

    from distributedpytorch_tpu_torch.ops import kernels as kn
    from distributedpytorch_tpu_torch.ops import loss_kernels as lk
    from distributedpytorch_tpu_torch.ops import wgrad_kernels as wk

    dev = devices[0]
    w, h = IMAGE_WH
    rows = h // len(devices)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}

    def err(got, want):
        scale = float(want.abs().max())
        diff = float((got.float() - want.float()).abs().max())
        return {"max_abs_err": diff,
                "max_err_rel_to_max": diff / scale if scale else diff}

    shape = (TRAIN_BATCH, rows, w, 1)
    p = torch.rand(shape, generator=gen, device=dev)
    t = (torch.rand(shape, generator=gen, device=dev) > 0.6).float()
    out["loss_stats"] = err(lk.eval_stats(p, t),
                            lk.eval_stats_reference(p, t))
    ct = torch.tensor([1e-6, 0.0, -0.3, 0.1], device=dev)
    out["loss_stats_bwd"] = err(lk.stats_bwd(p, t, ct),
                                lk.stats_bwd_reference(p, t, ct))
    x, a, b, mean = _bn_inputs((TRAIN_BATCH, 64, rows, w), gen, dev,
                               torch.float32)
    out["bn_act"] = err(kn.bn_act(x, a, b), kn.bn_act_reference(x, a, b))
    g = torch.randn(x.shape, generator=gen, device=dev).contiguous(
        memory_format=torch.channels_last)
    got = kn.bn_act_bwd(x, g, a, b, mean)
    want = kn.bn_act_bwd_reference(x, g, a, b, mean)
    out["bn_act_bwd"] = max((err(u, v) for u, v in zip(got, want)),
                            key=lambda e: e["max_err_rel_to_max"])
    del x, g, got, want
    xh = torch.randn((TRAIN_BATCH, rows // 2 + 2, w // 2, 128),
                     generator=gen, device=dev).to(torch.bfloat16)
    dy = torch.nn.functional.pad(
        torch.randn((TRAIN_BATCH, rows // 2, w // 2, 128), generator=gen,
                    device=dev).to(torch.bfloat16), (0, 0, 0, 0, 1, 1))
    out["wgrad_9tap"] = err(wk.wgrad_9tap(xh, dy),
                            wk.wgrad_9tap_reference(xh, dy))
    out["shapes"] = {"loss": list(shape), "bn": [TRAIN_BATCH, 64, rows, w],
                     "wgrad_x_halo": list(xh.shape)}
    return out


# each shard-shape kernel against its plain version, relative to the plain
# version's largest element: K1's float sums in two orders, K1-bwd and K2
# elementwise, K3's channel sums and K5's float32 sums in two orders
SP_SHARD_KERNEL_RTOL = {"loss_stats": STATS_RTOL, "loss_stats_bwd": GRAD_RTOL,
                        "bn_act": 1e-6, "bn_act_bwd": BN_SUMS_RTOL,
                        "wgrad_9tap": WGRAD_RTOL}


def _sp_timing(arch: str, devices, batch) -> dict:
    """The bf16 step of ``arch`` at the given row shards on the one card,
    beside the same step through SP at one shard (the row-sharded module
    without halos) and the singleGPU step: CUDA-event ms, host enqueue
    ms, the card's busy ms by the profiler and its idle share."""
    import torch

    dev = devices[0]
    out = {}
    for label, method, devs in (("sp", "SP", devices),
                                ("sp_one_shard", "SP", devices[:1]),
                                ("single_gpu", "singleGPU", devices[:1])):
        _, step, _ = _sp_model_step(method, arch, devs, "bf16", lr=1e-4)
        ms = cuda_ms(lambda: step(batch), SP_TIMED_STEPS, warmup=2)
        busy = _busy_ms_by_device(lambda: step(batch), 2, devices=[dev])
        out[label] = {"step_ms": ms,
                      "host_enqueue_ms": _host_enqueue_ms(lambda: step(batch)),
                      "busy_ms": busy.get(dev.index),
                      "idle_share": 1.0 - busy.get(dev.index, 0.0) / ms,
                      "images_per_s": TRAIN_BATCH * 1e3 / ms}
        if label == "sp":
            out[label]["top_host_ops"] = _top_host_ops(
                lambda: step(batch), 2)[:8]
        del step
        torch.cuda.empty_cache()
    return out


def phase_train_sp(tmp: str, train: dict) -> dict:
    """``-t SP`` on ``[cuda:0, cuda:0]``, two row-shard threads on the one
    card, under kernels cuda with cuDNN's deterministic algorithms: for
    the full-width bf16 UNet (``-b 4``) and milesial ``--wgrad-taps``
    (DPT_WGRAD_BACKEND=pallas), step 1 against a singleGPU step from the
    same weights, in bf16 and float32 (SP_BOUNDS); each kernel's launches
    per step counted by name in the profiler's trace and by the wrappers
    (``_sp_expected_per_step``: once per shard and site); the float32
    step with the kernels against the same step with their plain versions
    in place (``_sp_in_place``), and each kernel against its plain version
    on a shard's shapes (``_sp_shard_kernels``); the bf16 step's ms, host
    enqueue and idle share beside one shard and singleGPU
    (``_sp_timing``; train's step beside them). Then a short run of the
    training CLI's own functions with ``-t SP`` writes the ``.pth`` and a
    checkpoint whose manifest says ``1x2x1@sp``."""
    import numpy as np
    import torch

    from distributedpytorch_tpu_torch.checkpoint import load_native
    from distributedpytorch_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    devices = [dev] * SP_SHARDS
    w, h = IMAGE_WH
    out = {"phase": "train_sp", "shards": SP_SHARDS,
           "devices": [str(d) for d in devices], "batch": TRAIN_BATCH,
           "cudnn_deterministic": True,
           "device": torch.cuda.get_device_name(0)}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    problems = []
    try:
        batch = _synthetic_batch(TRAIN_BATCH, dev)
        out["shard_kernels"] = _sp_shard_kernels(devices)
        for name, rtol in SP_SHARD_KERNEL_RTOL.items():
            if out["shard_kernels"][name]["max_err_rel_to_max"] > rtol:
                problems.append(f"{name} on the shard shape: "
                                f"{out['shard_kernels'][name]}")
        for arch in ("unet", "milesial"):
            def run(arch=arch):
                row = {"against_single_gpu": _sp_step_rows(arch, devices,
                                                           batch)}
                _, step, _ = _sp_model_step("SP", arch, devices, "bf16",
                                            lr=1e-4)
                names = tuple(_sp_expected_per_step(arch, SP_SHARDS))
                step(batch)
                torch.cuda.synchronize()
                kernels.reset_launches()
                loss, traced = _traced_call(lambda: float(step(batch)),
                                            names)
                row["step_loss"] = loss
                row["counted"] = {n: kernels.LAUNCHES[n] for n in names}
                row["traced_per_step"] = traced
                row["expected_per_step"] = _sp_expected_per_step(arch,
                                                                 SP_SHARDS)
                del step
                torch.cuda.empty_cache()
                row["in_place_f32"] = _sp_in_place(arch, devices, batch)
                row["timing"] = _sp_timing(arch, devices, batch)
                return row

            row = _with_wgrad_backend(run) if arch == "milesial" else run()
            out[arch] = row
            for dtype, r in row["against_single_gpu"].items():
                if not r["ok"]:
                    problems.append(f"{arch} {dtype} SP vs singleGPU: {r}")
            if not row["in_place_f32"]["ok"]:
                problems.append(f"{arch} f32 kernels vs plain versions: "
                                f"{row['in_place_f32']}")
            if not np.isfinite(row["step_loss"]):
                problems.append(f"{arch} SP loss {row['step_loss']}")
            for what in ("counted", "traced_per_step"):
                if row[what] != row["expected_per_step"]:
                    problems.append(f"{arch} {what} {row[what]}, expected "
                                    f"{row['expected_per_step']}")
        out["train_step_ms"] = train["step_ms"]

        # the training CLI's own functions: one step and one eval batch
        run = os.path.join(tmp, "train_sp")
        argv = ["-t", "SP", "--synthetic", "8", "-v", "50",
                "-b", str(TRAIN_BATCH), "-e", "1", "--image-size", str(w),
                str(h), "--dtype", "bf16", "--kernels", "cuda"]
        trainer, close = _cli_trainer(run, argv, devices=devices)
        try:
            torch.cuda.synchronize()
            kernels.reset_launches()
            result = trainer.train()
            torch.cuda.synchronize()
            launches = {n: kernels.LAUNCHES[n] for n in LOSS_KERNELS}
        finally:
            close()
        topology = load_native(os.path.join(
            run, "checkpoints", "SP.pt"))["manifest"]["topology"]
        out["cli"] = {"result": result, "launches": launches,
                      "wrote": _files(run), "topology": topology}
        want = {"loss_stats": SP_SHARDS * 2, "loss_stats_bwd": SP_SHARDS}
        if launches != want:
            problems.append(f"SP CLI run launched {launches}, expected {want}")
        if topology["mesh_spec"] != f"1x{SP_SHARDS}x1@sp":
            problems.append(f"SP manifest {topology}")
        if "checkpoints/SP.pth" not in out["cli"]["wrote"]:
            problems.append(f"SP CLI run wrote {out['cli']['wrote']}")
        if not (np.isfinite(result["val_loss"])
                and np.isfinite(result["val_dice"])):
            problems.append(f"SP CLI eval {result}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    out["problems"] = problems
    emit(out)
    check(not problems, f"train_sp: {problems}")
    return out


# -t SP's run control on [cuda:0, cuda:0] (sp_run_control), full width:
# one CUDA graph of GS_K steps (bf16, DP_GRAPH_STACKS stacks), --remat
# (bf16, SGD at lr 0) and the UNet's --grad-accum SP_ACCUM (float32,
# against the singleGPU accumulation step at SP_BOUNDS' f32 bounds)
SP_ACCUM = 2


def _sp_graph_run(arch: str, devices) -> dict:
    """``-t SP`` of ``arch`` over ``devices`` as one CUDA graph of GS_K
    steps against its eager steps (``_graph_run``): each kernel of
    ``_sp_expected_per_step`` GS_K times per replay."""
    want = {name: GS_K * count for name, count in
            _sp_expected_per_step(arch, len(devices)).items()}
    return _graph_run(_strategy_config("SP", arch), devices, want)


def _sp_remat_run(arch: str, devices) -> dict:
    """``arch`` under ``-t SP --remat`` over ``devices`` against the plain
    SP step (``_remat_run``): ``_sp_expected_per_step``, milesial's K2
    twice (the recompute's)."""
    want = _sp_expected_per_step(arch, len(devices))
    if arch == "milesial":
        want["bn_act"] *= 2
    return _remat_run("SP", arch, devices, want)


def _sp_accum_run(devices) -> dict:
    """The float32 UNet's ``--grad-accum SP_ACCUM`` under ``-t SP`` over
    ``devices`` against the singleGPU accumulation step on the first,
    from the seed's weights over the same chunks of ``-b 4``, SGD at lr
    0, cuDNN deterministic: SP_BOUNDS' f32 bounds and the launches per
    step (K1 in both passes of every chunk on every shard, K1-bwd in the
    second)."""
    import torch

    from distributedpytorch_tpu_torch.models import create_model
    from distributedpytorch_tpu_torch.ops import kernels
    from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
    from distributedpytorch_tpu_torch.parallel.strategy import build_strategy

    batch = _synthetic_batch(SP_ACCUM * TRAIN_BATCH, devices[0])
    chunks = [{k: v[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]
               for k, v in batch.items()} for i in range(SP_ACCUM)]
    runs = {}
    with _deterministic_cudnn():
        for method, devs in (("SP", devices), ("singleGPU", devices[:1])):
            cfg = _strategy_config(method, "unet", dtype="f32",
                                   grad_accum=SP_ACCUM)
            strategy = build_strategy(cfg, devices=devs)
            model = strategy.place_model(create_model(
                cfg, generator=torch.Generator().manual_seed(SEED)))
            step = strategy.build_accum_train_step(
                model, torch.optim.SGD(model.parameters(), lr=0.0),
                get_kernel_policy("cuda"))
            kernels.reset_launches()
            loss = float(step(chunks))
            torch.cuda.synchronize()
            runs[method] = {"loss": loss, "grads": _grads(model),
                            "stats": {},
                            "launches": {n: kernels.LAUNCHES[n]
                                         for n in LOSS_KERNELS}}
            del model, step
            torch.cuda.empty_cache()
    n = len(devices)
    want = {"loss_stats": 2 * SP_ACCUM * n, "loss_stats_bwd": SP_ACCUM * n}
    row = {"phase": "sp_accum", "arch": "unet", "dtype": "f32",
           "chunks": SP_ACCUM, "batch": TRAIN_BATCH,
           "devices": [str(d) for d in devices],
           **_step_against(runs["SP"], runs["singleGPU"]),
           "launches_per_step": runs["SP"]["launches"],
           "expected_per_step": want,
           "device": torch.cuda.get_device_name(0)}
    row["ok"] = _within_sp_bounds("unet", "f32", row)
    emit(row)
    check(row["ok"], f"SP accumulation against singleGPU's: {row}")
    check(row["launches_per_step"] == want,
          f"SP accumulation launched {row['launches_per_step']}, expected "
          f"{want}")
    return row


def phase_sp_run_control() -> dict:
    """``-t SP``'s run control on ``[cuda:0, cuda:0]`` at full width: the
    bf16 UNet and milesial ``--wgrad-taps`` (DPT_WGRAD_BACKEND=pallas) as
    one CUDA graph of GS_K steps against their eager steps
    (``_sp_graph_run``), each under ``--remat`` against the plain SP step
    (``_sp_remat_run``), and the float32 UNet's ``--grad-accum`` against
    singleGPU's (``_sp_accum_run``)."""
    import torch

    dev = torch.device("cuda", 0)
    devices = [dev] * SP_SHARDS
    out = {"phase": "sp_run_control", "devices": [str(d) for d in devices],
           "graphs": {arch: _sp_graph_run(arch, devices)
                      for arch in ("unet", "milesial")},
           "remat": {arch: _sp_remat_run(arch, devices)
                     for arch in ("unet", "milesial")},
           "accum": _sp_accum_run(devices)}
    return out


def _ddp_sp_run(rank: int, world: int, devices, arch: str,
                steps: int, timed: bool, remat: bool = False) -> dict:
    """One run of a DDP_SP rank: ``steps`` bf16 steps under kernels cuda
    with Adam on its rows of the global batches (under ``--remat`` with
    ``remat``), the launches counted from zero over them and the weights'
    digest after each; rank 0 keeps its first gradients; with ``timed``
    the steady step by wall time and each card's busy time."""
    import torch

    from distributedpytorch_tpu_torch.models import create_model
    from distributedpytorch_tpu_torch.ops import kernels
    from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
    from distributedpytorch_tpu_torch.ops.optim import make_optimizer
    from distributedpytorch_tpu_torch.parallel.strategy import build_strategy

    cfg = _strategy_config("DDP_SP", arch, remat=remat)
    strategy = build_strategy(cfg, devices=devices)
    check(strategy.name == "DDP_SP" and strategy.devices == list(devices),
          f"DDP_SP strategy on {strategy.devices}")
    model = strategy.place_model(create_model(
        cfg, generator=torch.Generator().manual_seed(SEED)))
    opt = _FirstGrads(make_optimizer(
        model.parameters(), strategy.lr_for(cfg.learning_rate),
        cfg.weight_decay), list(model.named_parameters()))
    step = strategy.build_train_step(model, opt, get_kernel_policy("cuda"))
    rows = slice(rank * TRAIN_BATCH, (rank + 1) * TRAIN_BATCH)
    placed = [{k: torch.from_numpy(v[rows]).to(devices[0])
               for k, v in batch.items()}
              for batch in _ddp_batches(world, TRAIN_BATCH, steps)]
    _sync_all(devices)
    kernels.reset_launches()
    losses, digests = [], []
    for batch in placed:
        losses.append(float(step(batch)))
        digests.append(_digest(model.state_dict().values()))
    _sync_all(devices)
    out = {"losses": losses, "weights_digests": digests,
           "launches": dict(kernels.LAUNCHES),
           "mesh": strategy.mesh_shape(),
           "grads_digest": _digest(opt.grads.values())}
    if rank == 0:
        out["grads"] = opt.grads
    if timed:
        out["step_ms"] = _wall_ms(lambda: step(placed[0]), SP_TIMED_STEPS,
                                  warmup=2, devices=devices)
        out["busy_ms_by_card"] = _busy_ms_by_device(
            lambda: step(placed[0]), 2, devices=devices)
    del model, step, opt, strategy
    torch.cuda.empty_cache()
    return out


def ddp_sp_rank(rank: int, world: int, backend: str, job: str) -> int:
    """One rank of a multi-process DDP_SP phase (``chip_smoke.py
    --ddp-sp-rank R WORLD BACKEND DIR``): joins a ``backend`` group over a
    file store in ``DIR`` with its SP_SHARDS row shards on cuda:0 under
    gloo (``train_ddp_sp_gloo2``) and on ``cuda:(R·n + s)`` under nccl
    (``--cards``: the layout ``runtime.stage_devices`` gives a torchrun
    rank), runs DDP_SP_RUNS (``_ddp_sp_run``), under gloo each again with
    ``--remat`` and the refusal of K > 1, under nccl each model as one
    CUDA graph of GS_K steps against its eager steps
    (``_rank_graph_run``), and writes its results to
    ``DIR/result_R.pt``."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    if backend == "gloo":
        devices = [torch.device("cuda", 0)] * SP_SHARDS
    else:
        devices = [torch.device("cuda", rank * SP_SHARDS + s)
                   for s in range(SP_SHARDS)]
    torch.cuda.set_device(devices[0])
    _warm_profiler()
    torch.distributed.init_process_group(
        backend, init_method=f"file://{os.path.join(job, 'store')}",
        rank=rank, world_size=world)
    try:
        runs = {}
        for arch, steps in DDP_SP_RUNS:
            for remat in (False, True) if backend == "gloo" else (False,):
                def run(arch=arch, steps=steps, remat=remat):
                    return _ddp_sp_run(rank, world, devices, arch, steps,
                                       timed=backend == "nccl", remat=remat)
                runs[arch + ("_remat" if remat else "")] = (
                    _with_wgrad_backend(run) if arch == "milesial"
                    else run())
        result = {"runs": runs, "devices": [str(d) for d in devices]}
        if backend == "gloo":
            result["k_refusal"] = _refusal(
                _strategy_config("DDP_SP", "unet", steps_per_dispatch=2),
                devices)
        else:
            result["graph"] = {}
            for arch, _steps in DDP_SP_RUNS:
                def graph(arch=arch):
                    return _rank_graph_run(
                        _strategy_config("DDP_SP", arch,
                                         steps_per_dispatch=GS_K),
                        rank, world, devices, 3)
                result["graph"][arch] = (_with_wgrad_backend(graph)
                                         if arch == "milesial" else graph())
        torch.save(result, os.path.join(job, f"result_{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()
    return 0


def _check_ddp_sp_ranks(ranks, world: int) -> tuple:
    """Per run: the ranks' losses, weights after every step and first
    gradients bitwise equal; each rank's launches once per shard and site
    and step (milesial's K2 twice under ``--remat``); rank 0's first step
    of a plain run against one SP step of the same weights on the joint
    batch over ``[cuda:0] * SP_SHARDS`` (the per-process faithful scale),
    within SP_BOUNDS' bf16 bounds: each rank's shards round their weight
    gradients to bf16 over other rows than the joint batch's shards do;
    a ``--remat`` run's losses, gradients and weights after every step
    bitwise its plain run's. Returns the rows and the disagreements."""
    import torch

    dev = torch.device("cuda", 0)
    out, problems = {}, []
    for key in ranks[0]["runs"]:
        arch, _, remat = key.partition("_")
        rs = [r["runs"][key] for r in ranks]
        r0 = rs[0]
        steps = len(r0["losses"])
        want = {n: c * steps for n, c in
                _sp_expected_per_step(arch, SP_SHARDS).items()}
        if remat and arch == "milesial":
            want["bn_act"] *= 2
        row = {
            "steps": steps, "losses": [r["losses"] for r in rs],
            "launches": [r["launches"] for r in rs],
            "launches_expected": want, "mesh": r0["mesh"],
            "weights_bitwise_equal_every_step": all(
                r["weights_digests"] == r0["weights_digests"] for r in rs),
            "first_grads_bitwise_equal": all(
                r["grads_digest"] == r0["grads_digest"] for r in rs),
        }
        for name in ("step_ms", "busy_ms_by_card"):
            if name in r0:
                row[name] = [r[name] for r in rs]
        out[key] = row
        if not row["weights_bitwise_equal_every_step"]:
            problems.append(f"{key}: the ranks' weights differ")
        if not row["first_grads_bitwise_equal"]:
            problems.append(f"{key}: the ranks' gradients differ")
        if any(l != row["losses"][0] for l in row["losses"]):
            problems.append(f"{key}: the ranks' losses differ")
        for counts in row["launches"]:
            if any(counts[n] != c for n, c in want.items()):
                problems.append(f"{key}: launched {counts}, expected {want}")
        if row["mesh"] != {"data": world, "spatial": SP_SHARDS}:
            problems.append(f"{key}: mesh {row['mesh']}")
        if remat:
            plain = ranks[0]["runs"][arch]
            row["bitwise_the_plain_run"] = (
                r0["losses"] == plain["losses"]
                and r0["weights_digests"] == plain["weights_digests"]
                and r0["grads_digest"] == plain["grads_digest"])
            if not row["bitwise_the_plain_run"]:
                problems.append(f"{key}: off the plain DDP_SP run")
            continue

        def sp_step(arch=arch):
            model, step, _ = _sp_model_step("SP", arch, [dev] * SP_SHARDS,
                                            "bf16")
            batch = {k: torch.from_numpy(v).to(dev) for k, v in
                     _ddp_batches(world, TRAIN_BATCH, 1)[0].items()}
            loss = float(step(batch))
            grads = {n: p.grad.float().cpu()
                     for n, p in model.named_parameters()}
            del model, step
            torch.cuda.empty_cache()
            return loss, grads

        with _deterministic_cudnn():
            sp_loss, sp_grads = (_with_wgrad_backend(sp_step)
                                 if arch == "milesial" else sp_step())
        row.update({
            "sp_step_loss": sp_loss,
            "sp_loss_rel_err": abs(r0["losses"][0] - sp_loss) / sp_loss,
            "sp_grad_max_err_rel_to_tensor_max": max(
                float((r0["grads"][n] - g).abs().max() / g.abs().max())
                for n, g in sp_grads.items()),
            "sp_grad_max_rel_l2": max(
                float((r0["grads"][n] - g).norm() / g.norm())
                for n, g in sp_grads.items()),
        })
        if not _within_sp_bounds(arch, "bf16", {
                "loss_rel_err": row["sp_loss_rel_err"],
                "grad_max_err_rel_to_tensor_max":
                    row["sp_grad_max_err_rel_to_tensor_max"],
                "grad_max_rel_l2": row["sp_grad_max_rel_l2"]}):
            problems.append(f"{key}: step 1 off the SP step: {row}")
    return out, problems


@contextlib.contextmanager
def _deterministic_cudnn():
    import torch

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def phase_train_ddp_sp_gloo2(tmp: str) -> dict:
    """``-t DDP_SP`` on the one card: two ranks (``ddp_sp_rank``, two
    processes this script spawns) in a gloo group, each row-sharding its
    ``-b 4`` over ``[cuda:0, cuda:0]``, through DDP_SP_RUNS: the bf16
    UNet and milesial ``--wgrad-taps`` under DPT_WGRAD_BACKEND=pallas.
    Checked as ``_check_ddp_sp_ranks`` says, K1, K1-bwd, K2, K3 and K5
    counted per rank from zero over each run; each run again under
    ``--remat``, bitwise the plain run; ``--steps-per-dispatch 2``
    refused over gloo on the card. A correctness phase: the ranks share
    the card and their gradients cross the host."""
    import torch

    torch.cuda.empty_cache()  # the ranks share the card with this process
    ranks, wall_s = _run_ddp_ranks(
        os.path.join(tmp, "train_ddp_sp_gloo2"), 2, "gloo", "--ddp-sp-rank")
    runs, problems = _check_ddp_sp_ranks(ranks, 2)
    refusals = [r["k_refusal"] for r in ranks]
    if not all(GLOO_REFUSAL in (msg or "") for msg in refusals):
        problems.append(f"K = 2 over gloo on the card: {refusals}")
    out = {"phase": "train_ddp_sp_gloo2", "world": 2, "backend": "gloo",
           "shards": SP_SHARDS, "devices": [r["devices"] for r in ranks],
           "device": torch.cuda.get_device_name(0), "wall_s": wall_s,
           "runs": runs, "k_refusal": refusals[0], "problems": problems}
    emit(out)
    check(not problems, f"train_ddp_sp_gloo2: {problems}")
    return out


def phase_sp_cards(tmp: str, world: int) -> dict:
    """``-t SP`` and ``-t DDP_SP`` across four cards (``--cards 4``), where
    the halo rows cross NVLink. SP over the ``world`` cards: one float32
    step of the full-width UNet against a one-card singleGPU step
    (SP_BOUNDS' f32 bounds), then the bf16 UNet and milesial
    ``--wgrad-taps`` at ``-b 4`` by wall time with each card's busy time,
    beside the singleGPU step on one card, and images / s; both models as
    one CUDA graph of GS_K steps across the cards against their eager
    steps (``_sp_graph_run``). DDP_SP as two
    NCCL ranks of two cards each (``ddp_sp_rank``, cuda:2r and cuda:2r+1),
    checked as ``train_ddp_sp_gloo2`` and timed, and each model as one
    CUDA graph of GS_K steps per rank, bitwise its eager steps with the
    ranks' weights equal after every stack; then ``torchrun
    --standalone --nproc_per_node 2`` of the training CLI with ``-t
    DDP_SP``, which must exit 0 with the DDP_SP artifacts, both ranks in
    its log and a manifest that says ``2x2x1@sp``."""
    import torch

    from distributedpytorch_tpu_torch.checkpoint import load_native

    dev0 = torch.device("cuda", 0)
    cards = [torch.device("cuda", i) for i in range(world)]
    out = {"phase": "sp_cards", "world": world,
           "cards": [torch.cuda.get_device_name(i) for i in range(world)]}
    problems = []
    batch = _synthetic_batch(TRAIN_BATCH, dev0)
    with _deterministic_cudnn():
        runs = {}
        for method, devs in (("SP", cards), ("singleGPU", [dev0])):
            model, step, _ = _sp_model_step(method, "unet", devs, "f32")
            runs[method] = {"loss": float(step(batch)),
                            "grads": _grads(model), "stats": {}}
            del model, step
            torch.cuda.empty_cache()
    row = _step_against(runs["SP"], runs["singleGPU"])
    if not _within_sp_bounds("unet", "f32", row):
        problems.append(f"SP over {world} cards, f32 UNet: {row}")
    out["f32_unet_against_single_gpu"] = row
    del runs
    for arch in ("unet", "milesial"):
        def timed(arch=arch):
            rows = {}
            for label, method, devs in (("cards", "SP", cards),
                                        ("one_card", "singleGPU", [dev0])):
                _, step, strategy = _sp_model_step(method, arch, devs,
                                                   "bf16", lr=1e-4)
                ms = _wall_ms(lambda: step(batch), SP_TIMED_STEPS, warmup=2)
                rows[label] = {
                    "step_ms": ms, "images_per_s": TRAIN_BATCH * 1e3 / ms,
                    "busy_ms_by_card": _busy_ms_by_device(
                        lambda: step(batch), 2)}
                del step, strategy
                torch.cuda.empty_cache()
            rows["speedup"] = (rows["one_card"]["step_ms"]
                               / rows["cards"]["step_ms"])
            return rows

        out[f"bf16_{arch}"] = (_with_wgrad_backend(timed)
                               if arch == "milesial" else timed())
    out["graphs"] = {arch: _sp_graph_run(arch, cards)
                     for arch in ("unet", "milesial")}
    ranks, wall_s = _run_ddp_ranks(os.path.join(tmp, "sp_cards_ddp_sp"), 2,
                                   "nccl", "--ddp-sp-rank")
    out["ddp_sp"], rank_problems = _check_ddp_sp_ranks(ranks, 2)
    out["ddp_sp_devices"] = [r["devices"] for r in ranks]
    out["ddp_sp_wall_s"] = wall_s
    problems += rank_problems
    out["ddp_sp_graphs"] = {}
    for arch in ranks[0]["graph"]:
        rows = _ranks_graph_rows([{"graph": r["graph"][arch]}
                                  for r in ranks], 2)
        out["ddp_sp_graphs"][arch] = rows
        _check_ranks_graph(rows, f"DDP_SP {arch} graph, 2 ranks x 2 cards")
    for arch, r in out["ddp_sp"].items():
        r["images_per_s"] = 2 * TRAIN_BATCH * 1e3 / max(r["step_ms"])

    sub = os.path.join(tmp, "ddp_sp_torchrun")
    os.makedirs(sub)
    env = dict(os.environ,
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    for key in TORCHRUN_ENV:
        env.pop(key, None)
    w, h = IMAGE_WH
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "distributedpytorch_tpu_torch",
           "-t", "DDP_SP", "--synthetic", "24", "-v", "34",
           "-b", str(TRAIN_BATCH), "-e", "1", "--image-size", str(w), str(h),
           "--kernels", "cuda"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=sub, env=env, capture_output=True,
                          text=True, timeout=600)
    out["torchrun_s"] = time.perf_counter() - t0
    out["torchrun_rc"] = proc.returncode
    out["torchrun_wrote"] = wrote = _files(sub)
    log = ""
    if "logs/DDP_SP.log" in wrote:
        with open(os.path.join(sub, "logs", "DDP_SP.log")) as f:
            log = f.read()
    out["torchrun_ranks_logged"] = sum(f"(rank {r} of 2)" in log
                                       for r in range(2))
    if proc.returncode != 0:
        problems.append(f"torchrun -t DDP_SP exited {proc.returncode}: "
                        f"{proc.stderr[-3000:]}")
    elif "checkpoints/DDP_SP.pth" not in wrote:
        problems.append(f"torchrun -t DDP_SP wrote {wrote}")
    else:
        out["torchrun_topology"] = load_native(os.path.join(
            sub, "checkpoints", "DDP_SP.pt"))["manifest"]["topology"]
        if out["torchrun_topology"]["mesh_spec"] != "2x2x1@sp":
            problems.append(f"DDP_SP manifest {out['torchrun_topology']}")
    if out["torchrun_ranks_logged"] != 2:
        problems.append(f"{out['torchrun_ranks_logged']} of 2 ranks logged")
    out["problems"] = problems
    emit(out)
    check(not problems, f"sp_cards: {problems}")
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


def _finish(device: dict) -> None:
    """The card's name and power limit, then the result line."""
    import torch

    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})


def main_cards(world: int) -> int:
    """``python3 chip_smoke.py --cards N``: the build, then ``-t DDP``
    across N cards (``phase_ddp_cards``), ``-t DDP_MP`` as two ranks of
    two cards (``phase_ddp_mp_cards``), ``-t SP`` across N and ``-t
    DDP_SP`` as two ranks of two cards (``phase_sp_cards``), ``-t MP``
    across 2 and 4 of them (``phase_mp_cards``) and ``-t DP`` across all N
    (``phase_dp_cards``), and no other phase."""
    import torch

    check(world >= 2 * MP_STAGES and torch.cuda.device_count() >= world,
          f"--cards {world} on {torch.cuda.device_count()} cards")
    device = phase_device()
    with tempfile.TemporaryDirectory() as tmp:
        phase_ddp_cards(tmp, world)
        phase_ddp_mp_cards(tmp)
        phase_sp_cards(tmp, world)
    phase_mp_cards(world)
    phase_dp_cards(world)
    _finish(device)
    return 0


def dp_eager_step(root: str) -> int:
    """``--dp-eager-step ROOT``: the eager ``-t DP`` step of the package in
    the checkout at ``ROOT``, timed by this file's helpers: the bf16 UNet
    at batch 16 and milesial ``--wgrad-taps`` at batch 8 across every
    card, and the UNet at batch 8 on ``[cuda:0, cuda:0]``; wall ms per
    step with every card drained, three rounds of 10 steps after 2
    warm-up steps. One JSON line."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    os.environ["DPT_WGRAD_BACKEND"] = "pallas"
    import torch

    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.models import create_model
    from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
    from distributedpytorch_tpu_torch.parallel.strategy import build_strategy

    import distributedpytorch_tpu_torch as package

    check(os.path.dirname(os.path.dirname(package.__file__)) == root,
          f"the package of {root} imported")
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    dev0 = cards[0]
    out = {"phase": "dp_eager", "root": root, "cards": len(cards)}
    for label, arch, b, devices in (
            ("unet_cards", "unet", 16, cards),
            ("milesial_cards", "milesial", 8, cards),
            ("unet_one_card_x2", "unet", 8, [dev0, dev0])):
        cfg = TrainConfig(train_method="DP", model_arch=arch, dtype="bf16",
                          kernels="cuda", device="cuda", batch_size=b,
                          wgrad_taps=arch == "milesial")
        strategy = build_strategy(cfg, devices=devices)
        model = strategy.place_model(create_model(
            cfg, generator=torch.Generator().manual_seed(SEED)))
        step = strategy.build_train_step(
            model, torch.optim.SGD(model.parameters(), lr=1e-4),
            get_kernel_policy("cuda"))
        batch = _synthetic_batch(b, dev0)
        out[label] = [_wall_ms(lambda: step(batch), 10,
                               warmup=2 if r == 0 else 0, devices=devices)
                      for r in range(3)]
        del model, step, batch
        torch.cuda.empty_cache()
    emit(out)
    return 0


def main_dp_eager_ab(other: str) -> int:
    """``python3 chip_smoke.py --dp-eager-ab OTHER``: ``dp_eager_step`` of
    the checkout at ``OTHER`` (a parent commit, unpacked) and of this one
    in turns (other, this, this, other), each in a process of its own, so
    that one call compares two trees on the same cards."""
    device = phase_device()
    here = os.path.dirname(os.path.abspath(__file__))
    for root in (other, here, here, other):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--dp-eager-step", root], check=False)
        check(proc.returncode == 0, f"--dp-eager-step {root} exited "
              f"{proc.returncode}")
    _finish(device)
    return 0


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this check runs on the card",
              file=sys.stderr)
        return 1
    if argv[:1] == ["--ddp-rank"]:  # one rank of a multi-process phase
        return ddp_rank(int(argv[1]), int(argv[2]), argv[3], argv[4])
    if argv[:1] == ["--ddp-mp-rank"]:
        return ddp_mp_rank(int(argv[1]), int(argv[2]), argv[3], argv[4])
    if argv[:1] == ["--ddp-sp-rank"]:
        return ddp_sp_rank(int(argv[1]), int(argv[2]), argv[3], argv[4])
    if argv[:1] == ["--cards"]:
        return main_cards(int(argv[1]))
    if argv[:1] == ["--dp-eager-step"]:
        return dp_eager_step(argv[1])
    if argv[:1] == ["--dp-eager-ab"]:
        return main_dp_eager_ab(argv[1])
    if argv[:1] == ["--preempt-child"]:
        return preempt_child(argv[1], argv[2])
    device = phase_device()
    kernel = phase_kernel()
    loss = phase_loss_kernels()
    bn = phase_bn_act_kernels()
    wgrad = phase_wgrad()
    with tempfile.TemporaryDirectory() as tmp:
        serve = phase_serve(tmp)
        phase_profile(serve.pop("engine"))
        phase_serve_graph(tmp, serve)
        train = phase_train(tmp)
        train_ddp = phase_train_ddp(tmp, train)
        milesial = phase_train_milesial(tmp)
        milesial_ddp = phase_train_milesial_ddp(tmp, milesial)
        serve_int8 = phase_serve_int8(tmp)
        phase_predict(tmp, serve_int8)
        phase_train_ddp_gloo2(tmp)
        train_mp = phase_train_mp(tmp, train)
        milesial_mp = phase_train_milesial_mp(tmp)
        train_dp = phase_train_dp(tmp, train)
        ddp_mp = phase_train_ddp_mp_gloo2(tmp)
        train_sp = phase_train_sp(tmp, train)
        sp_rc = phase_sp_run_control()
        ddp_sp = phase_train_ddp_sp_gloo2(tmp)
        run_control = phase_train_run_control(tmp)["launches"]
        graphs = phase_train_graph_strategies(tmp)
        phase_probes(tmp)
        phase_profile_window(tmp)
        phase_preempt(tmp)
        phase_ckpt_roundtrip(tmp)
    phase_train_parity()
    phase_train_milesial_parity()
    phase_bounds()
    k5 = wgrad["timings"][0]  # 128 -> 128 on 4 x 320 x 480
    source = "distributedpytorch_tpu_torch/csrc/"

    def by_schedule(run, name):
        return {s: run[s]["launches"][name] for s in ("gpipe", "1f1b")}

    def replay_launches(name):
        """Per replay of a CUDA graph of 4 steps, counted by name in the
        graph's kernel nodes: singleGPU (train_run_control run 1), each run
        of train_graph_strategies and -t DP's on [cuda:0, cuda:0]
        (train_dp); K2, K3 and K5 per milesial --remat step
        (train_run_control run 2, and under DP) beside the MP and DP
        replays."""
        out = {"single_gpu": run_control[name]}
        if name in ("bn_act", "bn_act_bwd", "wgrad_9tap"):
            out = {"milesial_remat_step": run_control[name]}
        out.update({label: row["graph_launches_per_replay"][name]
                    for label, row in graphs.items()
                    if name in row["graph_launches_per_replay"]})
        # -t DP on [cuda:0, cuda:0], per replay, and milesial's --remat
        # step there (train_dp)
        out.update({f"dp_{arch}": row["graph_launches_per_replay"][name]
                    for arch, row in train_dp["graphs"].items()
                    if name in row["graph_launches_per_replay"]})
        if name in train_dp["remat"]["expected_remat_per_step"]:
            out["dp_milesial_remat_step"] = train_dp["remat"][
                "launches_per_step"]["remat"][name]
        return out

    def serve_replay_launches(name):
        """Per replay of a bucket graph, counted in the trace: the float
        and int8 engines of serve_int8, and milesial's .pth served after
        train_milesial."""
        out = {}
        for arch in ("unet", "milesial"):
            row = serve_int8[arch]
            if name in row["launches_per_replay"]:
                out[arch] = row["launches_per_replay_float"][name]
                out[f"{arch}_int8"] = row["launches_per_replay"][name]
        out["milesial_pth"] = milesial["serve_launches"][name]
        return out

    def ddp_mp_launches(name):
        """Rank 0's launches in each run of train_ddp_mp_gloo2 (K1 and
        K1-bwd in every run, K2, K3 and K5 in milesial's)."""
        return {key: row["launches"][0][name]
                for key, row in ddp_mp["runs"].items()
                if name in row["launches_expected"]}

    def sp_launches(name):
        """-t SP on [cuda:0, cuda:0] (train_sp): per step of each model,
        counted by name in the profiler's trace, and the wrappers' count
        over the short CLI run (one step and one eval batch); its run
        control (sp_run_control): per replay of a graph of 4 steps,
        counted in the graph's nodes, per --remat step and per --grad-accum 2
        step, counted by the wrappers."""
        out = {f"{arch}_step": train_sp[arch]["traced_per_step"][name]
               for arch in ("unet", "milesial")
               if name in train_sp[arch]["traced_per_step"]}
        if name in train_sp["cli"]["launches"]:
            out["cli_run"] = train_sp["cli"]["launches"][name]
        for arch in ("unet", "milesial"):
            replay = sp_rc["graphs"][arch]["graph_launches_per_replay"]
            if name in replay:
                out[f"{arch}_graph_per_replay"] = replay[name]
            remat = sp_rc["remat"][arch]["launches_per_step"]["remat"]
            if name in sp_rc["remat"][arch]["expected_remat_per_step"]:
                out[f"{arch}_remat_step"] = remat[name]
        if name in sp_rc["accum"]["launches_per_step"]:
            out["unet_accum_step"] = sp_rc["accum"]["launches_per_step"][
                name]
        return out

    def ddp_sp_launches(name):
        """Rank 0's launches over each run of train_ddp_sp_gloo2 (two
        steps of -b 4 over two row shards)."""
        return {arch: row["launches"][0][name]
                for arch, row in ddp_sp["runs"].items()
                if name in row["launches_expected"]}
    emit({"kernels": [
        {
            "name": "serve_mask",
            "route": "cuda",
            "source": source + "serve_mask.cu",
            "replaces": "distributedpytorch_tpu/ops/kernels.py:519",
            # per replay of the bucket graphs, counted in the trace
            "launches": serve["result"]["launches"]["serve_mask"],
            "serve_launches_per_replay": serve_replay_launches("serve_mask"),
            # not on the training paths
            "ddp_launches": None,
            "mp_launches": None,
            "dp_launches": None,
            "ddp_mp_launches": None,
            "sp_launches": None,
            "ddp_sp_launches": None,
            "run_control_launches": None,
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
            # per shard in the UNet -t DDP run (train_ddp)
            "ddp_launches": train_ddp["launches"]["loss_stats"],
            # per microbatch in the UNet -t MP runs (train_mp), on the
            # output card in its -t DP run (train_dp)
            "mp_launches": by_schedule(train_mp, "loss_stats"),
            "dp_launches": train_dp["launches"]["loss_stats"],
            # per rank and run of -t DDP_MP (train_ddp_mp_gloo2)
            "ddp_mp_launches": ddp_mp_launches("loss_stats"),
            # per shard under -t SP and DDP_SP (train_sp, train_ddp_sp_gloo2)
            "sp_launches": sp_launches("loss_stats"),
            "ddp_sp_launches": ddp_sp_launches("loss_stats"),
            "run_control_launches": replay_launches("loss_stats"),
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
            "ddp_launches": train_ddp["launches"]["loss_stats_bwd"],
            "mp_launches": by_schedule(train_mp, "loss_stats_bwd"),
            "dp_launches": train_dp["launches"]["loss_stats_bwd"],
            # per rank and run of -t DDP_MP (train_ddp_mp_gloo2)
            "ddp_mp_launches": ddp_mp_launches("loss_stats_bwd"),
            # per shard under -t SP and DDP_SP (train_sp, train_ddp_sp_gloo2)
            "sp_launches": sp_launches("loss_stats_bwd"),
            "ddp_sp_launches": ddp_sp_launches("loss_stats_bwd"),
            "run_control_launches": replay_launches("loss_stats_bwd"),
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
            # in the milesial -t DDP run (train_milesial_ddp)
            "ddp_launches": milesial_ddp["launches"]["bn_act"],
            # milesial -t MP (train_milesial_mp) and -t DP (train_dp)
            "mp_launches": by_schedule(milesial_mp, "bn_act"),
            "dp_launches": train_dp["milesial_launches"]["bn_act"],
            "ddp_mp_launches": ddp_mp_launches("bn_act"),
            # per shard under -t SP and DDP_SP (train_sp, train_ddp_sp_gloo2)
            "sp_launches": sp_launches("bn_act"),
            "ddp_sp_launches": ddp_sp_launches("bn_act"),
            "run_control_launches": replay_launches("bn_act"),
            # per replay of milesial's bucket graphs, float and int8
            "serve_launches_per_replay": serve_replay_launches("bn_act"),
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
            "ddp_launches": milesial_ddp["launches"]["bn_act_bwd"],
            # milesial -t MP (train_milesial_mp) and -t DP (train_dp)
            "mp_launches": by_schedule(milesial_mp, "bn_act_bwd"),
            "dp_launches": train_dp["milesial_launches"]["bn_act_bwd"],
            "ddp_mp_launches": ddp_mp_launches("bn_act_bwd"),
            # per shard under -t SP and DDP_SP (train_sp, train_ddp_sp_gloo2)
            "sp_launches": sp_launches("bn_act_bwd"),
            "ddp_sp_launches": ddp_sp_launches("bn_act_bwd"),
            "run_control_launches": replay_launches("bn_act_bwd"),
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
            "ddp_launches": milesial_ddp["launches"]["wgrad_9tap"],
            # milesial -t MP (train_milesial_mp) and -t DP (train_dp)
            "mp_launches": by_schedule(milesial_mp, "wgrad_9tap"),
            "dp_launches": train_dp["milesial_launches"]["wgrad_9tap"],
            "ddp_mp_launches": ddp_mp_launches("wgrad_9tap"),
            # per shard under -t SP and DDP_SP (train_sp, train_ddp_sp_gloo2)
            "sp_launches": sp_launches("wgrad_9tap"),
            "ddp_sp_launches": ddp_sp_launches("wgrad_9tap"),
            "run_control_launches": replay_launches("wgrad_9tap"),
            "max_abs_err": max(c["max_abs_err"] for c in wgrad["cases"]),
            "ms": k5["ms"],
            "plain_ms": k5["plain_ms"],
            "bound_ms": k5["bound_ms"],
            "bound_by": k5["bound_by"],
            # cuDNN's weight gradient, torch.nn.grad.conv2d_weight
            "library_ms": k5["library_ms"],
        },
    ]})
    _finish(device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
