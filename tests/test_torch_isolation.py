"""The PyTorch port stands alone: importing every module of it loads
neither jax, flax, msgpack nor the JAX package, a DDP rank it spawns
loads none of them, nor does a ``-t MP``, ``-t DP`` or ``-t SP`` run of
the training CLI, nor a ``quantize`` and ``predict`` run, and its entry points (the
serve engine, the trainer and the training CLI) refuse to fall back to
the CPU on a machine without a card unless asked."""

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
    if name in ("jax", "flax", "msgpack", "distributedpytorch_tpu")
    or name.startswith(("jax.", "jaxlib", "flax.", "msgpack.",
                        "distributedpytorch_tpu."))
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
                           "parallel.pipeline", "parallel.replicas",
                           "parallel.spatial",
                           "predict", "quantize", "ops.quant",
                           "utils.plotting", "ops.msgpack", "ops.probes"):
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
        r"^\s*(import|from)\s+(jax|flax|msgpack|distributedpytorch_tpu)"
        r"(\.|\s|$)"
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


def test_an_in_stage_zero_run_never_loads_jax(tmp_path):
    """Two gloo ranks of ``tests/torch_ddp_worker.py`` train one epoch of
    ``-t 2x2x2@fsdp`` (in-stage sharding with ZeRO over the ranks)
    through the training CLI with ``--device cpu``: both exit 0, rank 0
    writes the weights, and neither loads a module of the jax family."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_ddp_worker import launch

    argv = ["-t", "2x2x2@fsdp", "--synthetic", "16", "--image-size", "24",
            "16", "--model-widths", "8", "16", "-b", "2", "-v", "25", "-e",
            "1", "--device", "cpu", "--num-workers", "0"]
    jobs = {"cli": {"kind": "cli", "dir": str(tmp_path / "run"),
                    "argv": argv}}
    ranks = launch(tmp_path / "job", jobs)
    for result in ranks:
        assert result["leaked"] == []
        assert result["cli"]["code"] == 0
    assert "checkpoints/2x2x2@fsdp.pth" in ranks[0]["cli"]["wrote"]


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


def test_sp_runs_never_load_jax(tmp_path):
    """``-t SP`` (two row shards of the CPU) of the UNet and of milesial
    with ``--wgrad-taps`` through the training CLI with ``--device cpu``,
    in a process of their own: both train, write their weights, and load
    no module of the jax family."""
    common = ["-t", "SP", "--synthetic", "16", "--image-size", "24", "16",
              "--model-widths", "8", "16", "-b", "4", "-v", "25", "-e", "1",
              "--device", "cpu", "--num-workers", "0"]
    milesial = ["--model", "milesial", "--wgrad-taps", "--checkpoint-dir",
                "m", *common]
    probe = (
        "import sys\n"
        "from distributedpytorch_tpu_torch import cli\n"
        f"cli.main({common!r})\n"
        f"cli.main({milesial!r})\n"
        "leaked = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'distributedpytorch_tpu')]\n"
        "print('LEAKED', leaked)\n"
    )
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LEAKED []" in out.stdout
    assert (tmp_path / "checkpoints" / "SP.pth").exists()
    assert (tmp_path / "m" / "SP.pth").exists()


def test_quantize_and_predict_runs_never_load_jax(tmp_path):
    """``quantize`` and ``predict`` with ``--device cpu`` through
    ``python -m distributedpytorch_tpu_torch``'s own dispatch, in a process
    of their own: the int8 file is written, its masks are written, and no
    module of the jax family is loaded."""
    probe = (
        "import sys\n"
        "import numpy as np, torch\n"
        "from PIL import Image\n"
        "from distributedpytorch_tpu_torch.__main__ import main\n"
        "from distributedpytorch_tpu_torch.checkpoint import save_pth\n"
        "from distributedpytorch_tpu_torch.models.unet import UNet\n"
        "save_pth(UNet(widths=(8, 16)).state_dict(), 'ck/unet.pth')\n"
        "import os; os.makedirs('imgs')\n"
        "for i in range(3):\n"
        "    Image.fromarray(np.full((16, 24, 3), 40 * i, np.uint8))"
        ".save(f'imgs/c{i}.png')\n"
        "size = ['--image-size', '24', '16', '--model-widths', '8', '16',"
        " '--device', 'cpu']\n"
        "assert main(['quantize', '-c', 'unet', '--checkpoint-dir', 'ck',"
        " *size]) == 0\n"
        "assert main(['predict', '-c', 'ck/unet.pth.int8.pt', '-i', 'imgs',"
        " '-o', 'out', '-b', '2', *size]) == 0\n"
        "leaked = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'distributedpytorch_tpu')]\n"
        "print('LEAKED', leaked)\n"
    )
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LEAKED []" in out.stdout
    assert (tmp_path / "ck" / "unet.pth.int8.pt").exists()
    assert sorted(os.listdir(tmp_path / "out")) == [
        f"c{i}_mask.png" for i in range(3)]
