"""The PyTorch port stands alone: importing every module of it loads
neither jax nor the JAX package, a DDP rank it spawns loads neither, nor
does a ``-t MP`` or ``-t DP`` run of the training CLI, and
its entry points (the serve engine, the trainer and the training CLI)
refuse to fall back to the CPU on a machine without a card unless
asked."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import distributedpytorch_tpu_torch as pkg

modules = [pkg.__name__]
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
    modules.append(info.name)
leaked = sorted(
    name for name in sys.modules
    if name in ("jax", "flax", "distributedpytorch_tpu")
    or name.startswith(("jax.", "jaxlib", "flax.", "distributedpytorch_tpu."))
)
refusals = {}
import torch
if not torch.cuda.is_available():
    from distributedpytorch_tpu_torch.serve.engine import ServeEngine
    from distributedpytorch_tpu_torch.utils.device import resolve_device
    from distributedpytorch_tpu_torch.models.unet import UNet
    from distributedpytorch_tpu_torch.config import TrainConfig
    from distributedpytorch_tpu_torch.train.loop import Trainer
    from distributedpytorch_tpu_torch import cli
    for name, call in (
        ("resolve_device", lambda: resolve_device()),
        ("ServeEngine", lambda: ServeEngine(UNet(widths=(8,)), (16, 16))),
        ("Trainer", lambda: Trainer(TrainConfig(
            synthetic_samples=4, image_size=(16, 16), model_widths=(8,)))),
    ):
        try:
            call()
            refusals[name] = None
        except RuntimeError as exc:
            refusals[name] = str(exc)
    try:
        cli.main(["--synthetic", "4", "--image-size", "16", "16"])
        refusals["train_cli"] = None
    except SystemExit as exc:
        refusals["train_cli"] = str(exc.code)
    refusals["cpu_ok"] = str(resolve_device("cpu"))
print(json.dumps({"modules": modules, "leaked": leaked,
                  "pil": "PIL" in sys.modules, "refusals": refusals}))
"""


def test_port_imports_no_jax_and_refuses_a_silent_cpu_fallback():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["leaked"] == []
    assert not report["pil"]  # PIL loads only where an image decodes
    assert "distributedpytorch_tpu_torch.serve.server" in report["modules"]
    assert "distributedpytorch_tpu_torch.ops._build" in report["modules"]
    for trainer_module in ("cli", "train.loop", "train.steps",
                           "ops.loss_kernels", "ops.fused_loss", "evaluate",
                           "utils.metrics", "utils.trace", "data.loader",
                           "models.milesial",
                           "ops.conv_backward", "ops.wgrad_kernels",
                           "dist", "dist.runtime", "dist.collectives",
                           "parallel", "parallel.strategy",
                           "parallel.pipeline", "parallel.replicas"):
        assert (f"distributedpytorch_tpu_torch.{trainer_module}"
                in report["modules"])
    refusals = report["refusals"]
    if refusals:  # a machine without a card
        assert "device='cpu'" in refusals["resolve_device"]
        assert "device='cpu'" in refusals["ServeEngine"]
        assert "device='cpu'" in refusals["Trainer"]
        assert "--device cpu" in refusals["train_cli"]
        assert refusals["cpu_ok"] == "cpu"


def test_no_source_of_the_port_imports_jax():
    """The import graph above covers what runs; this covers every line,
    lazy imports inside functions included."""
    import re

    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|distributedpytorch_tpu)(\.|\s|$)"
    )
    roots = [os.path.join(REPO, "distributedpytorch_tpu_torch"),
             os.path.join(REPO, "chip_smoke.py")]
    offenders = []
    for root in roots:
        paths = [root] if root.endswith(".py") else [
            os.path.join(d, f) for d, _, files in os.walk(root)
            for f in files if f.endswith(".py")
        ]
        for path in paths:
            with open(path) as f:
                for lineno, line in enumerate(f, 1):
                    if pattern.match(line):
                        offenders.append(f"{path}:{lineno}: {line.strip()}")
    assert offenders == []


def test_a_ddp_worker_never_loads_jax(tmp_path):
    """Two gloo ranks of ``tests/torch_ddp_worker.py`` run a train step of
    the port's DDP path and list the jax-family modules they loaded."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_ddp_worker import launch

    rng = np.random.default_rng(0)
    batch = {"image": rng.random((4, 16, 16, 3), np.float32),
             "mask": (rng.random((4, 16, 16)) > 0.5).astype(np.int32)}
    config = dict(model_arch="milesial", model_widths=(4, 8), dtype="f32",
                  kernels="cuda", batch_size=2)
    from distributedpytorch_tpu_torch.models.milesial import MilesialUNet

    initial = MilesialUNet(widths=(4, 8), dtype=torch.float32,
                           generator=torch.Generator().manual_seed(0)
                           ).state_dict()
    jobs = {"step": {"kind": "steps", "fused": True, "config": config,
                     "initial": initial, "batches": [batch]}}
    for result in launch(tmp_path, jobs):
        assert result["leaked"] == []
        assert np.isfinite(float(result["step"]["losses"][0]))


def test_mp_and_dp_runs_never_load_jax(tmp_path):
    """``-t MP`` (1f1b) and ``-t DP`` through the training CLI with
    ``--device cpu``, in a process of their own: both train, write their
    weights, and load no module of the jax family."""
    common = ["--synthetic", "16", "--image-size", "24", "16",
              "--model-widths", "8", "16", "-b", "4", "-v", "25", "-e", "1",
              "--device", "cpu", "--num-workers", "0"]
    probe = (
        "import sys\n"
        "from distributedpytorch_tpu_torch import cli\n"
        f"cli.main({['-t', 'MP', '--pipeline-schedule', '1f1b', *common]!r})\n"
        f"cli.main({['-t', 'DP', '--model', 'milesial', *common]!r})\n"
        "leaked = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'distributedpytorch_tpu')]\n"
        "print('LEAKED', leaked)\n"
    )
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LEAKED []" in out.stdout
    for method in ("MP", "DP"):
        assert (tmp_path / "checkpoints" / f"{method}.pth").exists()
