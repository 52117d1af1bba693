"""The kernel probes: build, launch and check each hand-written kernel on
this card, and write the verdicts as the per-card priors file.

Counterpart of the JAX package's probe registry (``ops/kernels.py``
``PROBES``, ``run_probes``) and of ``tools/probe_kernels.py``. The JAX
probe only compiles a kernel; a port probe goes further, because a CUDA
kernel that builds may still fault or disagree at launch. Each one:

1. builds its source through ``ops/_build.py`` (a library built by an
   earlier process, keyed by the source's hash, is loaded as it is),
2. launches the kernel's wrapper once on small inputs on the card and
   synchronizes,
3. holds the result against the kernel's plain version on the same
   inputs, with the tolerance stated beside each probe.

Every probe runs in a child process of its own, the children all at
once: a launch that faults leaves a sticky CUDA error in its process,
which would fail every later probe and the caller. A child loads the
library the parent's ``_build/`` holds; where two build one source, each
writes its own temporary file and renames it into place. A failure is a verdict, recorded with its reason,
never a raise; an unknown name raises. Without a card ``run_probes``
raises unless the caller passes the CPU, where the wrappers take their
plain versions and the probes prove the machinery (as the JAX
interpreter path does).

The file keeps the JAX schema — ``kind``, ``version``, ``platform``,
``device_kind`` and ``kernels: {name: {accepted, reason?, compile_s}}``
— so each package's ``load_priors`` reads the other's; a port row also
carries ``build_s``, ``launch_s`` and ``max_rel_err``.

    python -m distributedpytorch_tpu_torch probe [--out kernel_priors.json]
        [--device cpu] [NAMES ...]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Sequence

import torch

from distributedpytorch_tpu_torch.ops.kernels import (
    PRIORS_KIND,
    PRIORS_VERSION,
    save_priors,
)

#: a child that has not answered in this long is a rejection
PROBE_TIMEOUT_S = 300.0
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _inputs(shape, device, seed: int, dtype=torch.float32) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=gen).to(device=device, dtype=dtype)


def _max_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / (scale if scale else 1.0)


def _check(err: float, bound: float, what: str) -> float:
    if not err <= bound:
        raise AssertionError(f"{what}: {err:.3e} of the plain version's "
                             f"largest, bound {bound:.0e}")
    return err


def _build(source: str) -> float:
    """Seconds to build (or find built) ``csrc/<source>.cu`` and load it."""
    from distributedpytorch_tpu_torch.ops import _build

    t0 = time.monotonic()
    _build.load(source)
    return time.monotonic() - t0


# Each probe: build seconds (0 on the CPU), then the launch and the check,
# returning the largest error relative to the plain version's largest
# element. The shapes are small, and the ones the kernels' checks ask for.

def _probe_eval_stats(device: torch.device) -> tuple:
    """K1: the six sums of p against t (2 × 32 × 64), float32 sums in
    another order than ``torch.sum``: within 1e-5."""
    from distributedpytorch_tpu_torch.ops import loss_kernels as lk

    build_s = _build("loss_stats") if device.type == "cuda" else 0.0
    p = _inputs((2, 32, 64, 1), device, 1)
    t = (_inputs((2, 32, 64, 1), device, 2) > 0.6).float()
    t0 = time.monotonic()
    got = lk.eval_stats(p, t)
    _sync(device)
    launch_s = time.monotonic() - t0
    err = _check(_max_rel_err(got, lk.eval_stats_reference(p, t)), 1e-5,
                 "eval_stats")
    return build_s, launch_s, err


def _probe_fused_loss(device: torch.device) -> tuple:
    """K1 and K1-bwd through the fused loss's value and gradient against
    the plain loss's: within 1e-5 (loss) and 1e-5 of the largest
    gradient."""
    from distributedpytorch_tpu_torch.ops import losses
    from distributedpytorch_tpu_torch.ops.fused_loss import (
        fused_bce_dice_loss,
    )

    build_s = _build("loss_stats") if device.type == "cuda" else 0.0
    t = (_inputs((2, 32, 64, 1), device, 2) > 0.6).float()
    # away from 0 and 1, where the two losses clamp their logs alike
    base = 0.05 + 0.9 * _inputs((2, 32, 64, 1), device, 1)
    p = base.clone().requires_grad_(True)
    t0 = time.monotonic()
    loss = fused_bce_dice_loss(p, t)
    loss.backward()
    _sync(device)
    launch_s = time.monotonic() - t0
    q = base.clone().requires_grad_(True)
    ref = losses.bce_dice_loss(q, t)
    ref.backward()
    err = max(_check(_max_rel_err(loss.detach(), ref.detach()), 1e-5,
                     "fused_loss value"),
              _check(_max_rel_err(p.grad, q.grad), 1e-5,
                     "fused_loss gradient"))
    return build_s, launch_s, err


def _probe_conv_epilogue(device: torch.device) -> tuple:
    """K2 and K3: BatchNorm-normalize + ReLU at 128 channels (2 × 128 ×
    16 × 24, float32, channels_last) and its backward against autograd
    through the plain version: within 1e-5 of the largest value and
    gradient (K3's channel sums add in another order)."""
    from distributedpytorch_tpu_torch.ops import kernels

    build_s = _build("bn_act") if device.type == "cuda" else 0.0
    c = 128
    x0 = (_inputs((2, c, 16, 24), device, 1) - 0.5).contiguous(
        memory_format=torch.channels_last)
    g = _inputs((2, c, 16, 24), device, 2) - 0.5
    vecs = [_inputs((c,), device, s) for s in (3, 4, 5, 6)]
    mean, var, scale, bias = vecs[0] - 0.5, vecs[1] + 0.5, vecs[2] + 0.5, \
        vecs[3] - 0.5

    def run(fn):
        leaves = [t.clone().requires_grad_(True)
                  for t in (x0, mean, var, scale, bias)]
        y = fn(*leaves)
        y.backward(g)
        return y.detach(), [t.grad for t in leaves]

    t0 = time.monotonic()
    y, grads = run(kernels.fused_bn_act)
    _sync(device)
    launch_s = time.monotonic() - t0
    y_ref, grads_ref = run(kernels.fused_bn_act_reference)
    err = _check(_max_rel_err(y, y_ref), 1e-5, "conv_epilogue forward")
    for got, want, name in zip(grads, grads_ref,
                               ("x", "mean", "var", "scale", "bias")):
        err = max(err, _check(_max_rel_err(got, want), 1e-5,
                              f"conv_epilogue d{name}"))
    return build_s, launch_s, err


def _probe_serve_mask(device: torch.device) -> tuple:
    """K4: the {0, 255} mask of probabilities (2 × 32 × 64) at 0.5,
    bit for bit."""
    from distributedpytorch_tpu_torch.ops import kernels

    build_s = _build("serve_mask") if device.type == "cuda" else 0.0
    x = _inputs((2, 32, 64), device, 1)
    t0 = time.monotonic()
    got = kernels.sigmoid_threshold_mask(x, 0.5)
    _sync(device)
    launch_s = time.monotonic() - t0
    want = kernels.sigmoid_threshold_mask_reference(x, 0.5)
    if not torch.equal(got.cpu(), want.cpu()):
        raise AssertionError("serve_mask: the mask differs from the plain "
                             "version's")
    return build_s, launch_s, 0.0


def _probe_wgrad_9tap(device: torch.device) -> tuple:
    """K5: the 3×3 weight gradient of bf16 x and dy (1 × 8 × 30 × 128,
    the JAX probe's shape) against the plain contraction: float32 sums
    of exact products in another order, within 1e-4 of the largest."""
    from distributedpytorch_tpu_torch.ops import wgrad_kernels

    build_s = _build("wgrad_9tap") if device.type == "cuda" else 0.0
    x = _inputs((1, 8, 30, 128), device, 1, torch.bfloat16)
    dy = _inputs((1, 8, 30, 128), device, 2, torch.bfloat16)
    t0 = time.monotonic()
    got = wgrad_kernels.wgrad_9tap(x, dy)
    _sync(device)
    launch_s = time.monotonic() - t0
    err = _check(_max_rel_err(got, wgrad_kernels.wgrad_9tap_reference(x, dy)),
                 1e-4, "wgrad_9tap")
    return build_s, launch_s, err


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


#: The probe registry, under the JAX registry's names: kernel name → a
#: probe ``(device) -> (build_s, launch_s, max_rel_err)`` that raises on a
#: failure.
PROBES: Dict[str, Callable[[torch.device], tuple]] = {
    "eval_stats": _probe_eval_stats,
    "fused_loss": _probe_fused_loss,
    "conv_epilogue": _probe_conv_epilogue,
    "serve_mask": _probe_serve_mask,
    "wgrad_9tap": _probe_wgrad_9tap,
}


def probe_here(name: str, device: torch.device) -> dict:
    """One probe in this process: its row (``accepted``, ``reason`` on a
    failure, ``compile_s``, ``build_s``, ``launch_s``, ``max_rel_err``)."""
    t0 = time.monotonic()
    row: Dict[str, object] = {}
    try:
        build_s, launch_s, err = PROBES[name](device)
        row.update(accepted=True, build_s=round(build_s, 3),
                   launch_s=round(launch_s, 6), max_rel_err=err)
    except Exception as exc:  # noqa: BLE001 — the verdict, not a bug
        row.update(accepted=False,
                   reason=f"{type(exc).__name__}: {exc}"[:500])
    row["compile_s"] = round(time.monotonic() - t0, 3)
    return row


def _child_command(name: str, device: torch.device) -> list:
    return [sys.executable, "-m", "distributedpytorch_tpu_torch.ops.probes",
            "--child", name, "--device", str(device)]


def _probe_in_child(name: str, device: torch.device) -> dict:
    """``probe_here`` in a child process; a child that dies, hangs or
    prints no row is a rejection with its exit and its last words."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_PACKAGE_ROOT] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    t0 = time.monotonic()
    try:
        out = subprocess.run(_child_command(name, device),
                             capture_output=True, text=True,
                             timeout=PROBE_TIMEOUT_S, env=env)
    except subprocess.TimeoutExpired:
        return {"accepted": False,
                "reason": f"probe child timed out after {PROBE_TIMEOUT_S} s",
                "compile_s": round(time.monotonic() - t0, 3)}
    lines = out.stdout.strip().splitlines()
    try:
        return json.loads(lines[-1])
    except (IndexError, ValueError):
        tail = (out.stderr or out.stdout).strip()[-400:]
        return {"accepted": False,
                "reason": f"probe child exited {out.returncode}: {tail}",
                "compile_s": round(time.monotonic() - t0, 3)}


def run_probes(names: Optional[Sequence[str]] = None,
               emit: Optional[Callable[[dict], None]] = None,
               device=None) -> dict:
    """Run the (selected) probes, each in a child process of its own, the
    children together, and return the priors payload ``save_priors``
    writes (rows in the order of ``names``). A probe's failure is its
    verdict; an unknown name raises ValueError, and so does a machine
    without a card unless ``device`` is the CPU."""
    selected = list(names) if names else sorted(PROBES)
    unknown = [n for n in selected if n not in PROBES]
    if unknown:
        raise ValueError(f"unknown probe kernel(s) {unknown}; registry has "
                         f"{sorted(PROBES)}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "run_probes: no CUDA device — the probes build and launch "
                "the kernels on a card; pass device='cpu' to probe the "
                "plain versions")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with ThreadPoolExecutor(max_workers=len(selected)) as pool:
        rows = list(pool.map(lambda name: _probe_in_child(name, device),
                             selected))
    kernels: Dict[str, dict] = {}
    for name, row in zip(selected, rows):
        kernels[name] = row
        if emit is not None:
            emit({"kernel": name, **row})
    return {
        "kind": PRIORS_KIND,
        "version": PRIORS_VERSION,
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "device_kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "kernels": kernels,
    }


def main(argv=None) -> int:
    """``python -m distributedpytorch_tpu_torch probe``: run the probes,
    print one JSON row per kernel and a summary, write the priors file;
    exit 0 whatever the verdicts (a rejection is a result)."""
    ap = argparse.ArgumentParser(
        prog="python -m distributedpytorch_tpu_torch probe",
        description="Build, launch and check every hand-written kernel on "
                    "this card; writes the per-card priors file")
    ap.add_argument("names", nargs="*", help="Probe only these kernels "
                    f"(default: all of {sorted(PROBES)})")
    ap.add_argument("--out", default="kernel_priors.json",
                    help="Priors file to write")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    t0 = time.monotonic()
    try:
        payload = run_probes(args.names or None,
                             emit=lambda row: print(json.dumps(row)),
                             device=args.device)
    except (RuntimeError, ValueError) as exc:
        raise SystemExit(str(exc)) from None
    save_priors(payload, args.out)
    kernels = payload["kernels"]
    print(json.dumps({
        "kind": "kernel_probe",
        "priors_path": os.path.abspath(args.out),
        "platform": payload["platform"],
        "probed": sorted(kernels),
        "rejected": sorted(k for k, v in kernels.items()
                           if not v.get("accepted")),
        "duration_s": round(time.monotonic() - t0, 2),
    }))
    return 0


def _child(argv) -> int:
    """``--child NAME --device DEV``: one probe, its row on stdout."""
    name, device = argv[1], argv[3]
    print(json.dumps(probe_here(name, torch.device(device))), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(_child(sys.argv[1:]))
    sys.exit(main())
