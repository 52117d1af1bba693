"""What ``torch.profiler`` drops of a session's device records on the card,
against the process's age, with and without a primer at the session's
head.

    python3 tools/torch_profiler_drops.py --start 20 --end 320 --gap 10

From ``--start`` to ``--end`` seconds of the process's age, every
``--gap`` seconds, one profiler session (CPU and CUDA activities) runs a
primer, cycling through ``--primers``, then one small probe kernel:

- ``none``: the probe alone;
- ``spaced``: spin kernels of 10,000 cycles, each waited for, 2 ms
  apart, for 0.2 s;
- ``burst``: 1,000 spin kernels of 1,000 cycles back to back;
- ``port``: the port's primer (``train/loop.prime_profiler``).

Each session prints one JSON line: its launches (the CPU's
``cudaLaunchKernel`` records, which the profiler keeps), the device
records it dropped (a launch without its kernel's record, matched by
correlation id), whether those were the session's first launches,
whether the probe's record was kept, and the largest amount by which a
kept kernel's record sits before its own launch (ms; a few tenths below
zero when the clocks agree). Needs one NVIDIA card; imports nothing of
JAX.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _primer(name, device):
    import torch

    from distributedpytorch_tpu_torch.train.loop import prime_profiler

    if name == "spaced":
        end = time.monotonic() + 0.2
        while time.monotonic() < end:
            torch.cuda._sleep(10_000)
            torch.cuda.synchronize(device)
            time.sleep(0.002)
    elif name == "burst":
        for _ in range(1000):
            torch.cuda._sleep(1_000)
        torch.cuda.synchronize(device)
    elif name == "port":
        prime_profiler(device)
    elif name != "none":
        raise ValueError(f"unknown primer {name!r}")


def session(primer, device, probe) -> dict:
    """One profiler session: ``primer``, then the probe kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributedpytorch_tpu_torch.train.loop import (
        PRIMER_KERNEL,
        process_age_s,
    )

    age = process_age_s()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _primer(primer, device)
        probe.mul_(1.0)
        torch.cuda.synchronize(device)
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    launches = sorted((e.correlation_id(), e.start_ns()) for e in events
                      if e.device_type() == cpu
                      and "LaunchKernel" in e.name())
    kernels = {e.correlation_id(): (e.name(), e.start_ns()) for e in events
               if e.device_type() == cuda}
    kept = [c for c, _ in launches if c in kernels]
    dropped = len(launches) - len(kept)
    early = [(t - kernels[c][1]) / 1e6 for c, t in launches if c in kernels]
    return {"age_s": age, "primer": primer, "launches": len(launches),
            "dropped": dropped,
            "dropped_are_first": all(c in kernels
                                     for c, _ in launches[dropped:]),
            "probe_kept": any(PRIMER_KERNEL not in name
                              for name, _ in kernels.values()),
            "most_early_ms": max(early) if early else None}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--start", type=float, default=20.0)
    parser.add_argument("--end", type=float, default=320.0)
    parser.add_argument("--gap", type=float, default=10.0)
    parser.add_argument("--primers", default="none,spaced,burst,port")
    parser.add_argument("--out", default=None,
                        help="also write the JSON lines to this file")
    args = parser.parse_args(argv)
    import torch

    from distributedpytorch_tpu_torch.train.loop import process_age_s

    if not torch.cuda.is_available():
        print("torch_profiler_drops: needs an NVIDIA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    probe = torch.ones(1024, device=device)
    probe.mul_(1.0)
    torch.cuda.synchronize(device)
    primers = args.primers.split(",")
    out = open(args.out, "w") if args.out else None
    at, i = args.start, 0
    while at <= args.end:
        time.sleep(max(0.0, at - process_age_s()))
        line = json.dumps(session(primers[i % len(primers)], device, probe))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        at += args.gap
        i += 1
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
