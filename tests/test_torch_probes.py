"""The port's kernel probes and priors (``ops/probes.py``,
``ops/kernels.py``) on the CPU, as the JAX package's own are held
(tests/test_kernels.py): a rejection disengages exactly its field; the
environment and the config resolve a file; a failure is recorded, not
raised; an unknown name is refused; the file round-trips, and a
missing, corrupt or stale one is ignored with a note; each package reads
the other's file. On the CPU the probes launch the plain versions, each
in a child process; the card's verdicts are ``tests/test_torch_cuda.py``'s
and ``chip_smoke.py``'s."""

import json
import logging
import sys

import pytest
import torch

from distributedpytorch_tpu.ops import kernels as jkm
from distributedpytorch_tpu_torch import cli, checkpoint
from distributedpytorch_tpu_torch.config import ServeConfig, TrainConfig
from distributedpytorch_tpu_torch.models import create_model
from distributedpytorch_tpu_torch.models.milesial import BatchNormAct
from distributedpytorch_tpu_torch.ops import kernels as km
from distributedpytorch_tpu_torch.ops import probes
from distributedpytorch_tpu_torch.serve import cli as serve_cli
from distributedpytorch_tpu_torch.train.loop import Trainer

NAMES = sorted(probes.PROBES)


def _priors(**verdicts):
    """A priors payload: ``name=(accepted, reason)``."""
    return {"kind": km.PRIORS_KIND, "version": km.PRIORS_VERSION,
            "platform": "gpu", "device_kind": "test",
            "kernels": {name: {"accepted": ok, "reason": why,
                               "compile_s": 0.1}
                        for name, (ok, why) in verdicts.items()}}


@pytest.fixture(autouse=True)
def _fresh_warnings():
    km._WARNED_REJECTIONS.clear()
    yield
    km._WARNED_REJECTIONS.clear()


def test_the_registry_is_the_jax_registry_and_gates_every_kernel():
    assert set(probes.PROBES) == set(km.KERNEL_GATES) == set(jkm.PROBES)
    fields = {f for gates in km.KERNEL_GATES.values() for f in gates}
    assert fields == {"train_loss_fused", "eval_stats_fused",
                      "conv_epilogue", "serve_mask", "wgrad_cuda"}


def test_a_rejection_disengages_exactly_that_kernel_once(caplog):
    with caplog.at_level(logging.WARNING, logger=km.__name__):
        for _ in range(2):
            policy = km.apply_priors(
                km.KERNEL_POLICIES["cuda"],
                _priors(conv_epilogue=(False, "CUDA error 700"),
                        fused_loss=(True, "")))
    assert not policy.conv_epilogue
    assert (policy.train_loss_fused and policy.eval_stats_fused
            and policy.serve_mask and policy.wgrad_cuda)
    warned = [r.getMessage() for r in caplog.records
              if r.name == km.__name__]
    assert len(warned) == 1 and "conv_epilogue" in warned[0]
    assert "CUDA error 700" in warned[0]
    wgrad = km.apply_priors(km.KERNEL_POLICIES["cuda"],
                            _priors(wgrad_9tap=(False, "no")))
    assert not wgrad.wgrad_cuda and wgrad.conv_epilogue


def test_priors_flow_through_the_config_and_the_environment(tmp_path,
                                                            monkeypatch):
    path = str(tmp_path / "priors.json")
    km.save_priors(_priors(fused_loss=(False, "nope")), path)
    policy = km.config_kernel_policy(TrainConfig(kernels="cuda",
                                                 kernel_priors=path,
                                                 device="cpu"))
    assert not policy.train_loss_fused and policy.eval_stats_fused
    # by name, the process's $DPT_KERNEL_PRIORS (the serve engine's way)
    env = str(tmp_path / "env.json")
    km.save_priors(_priors(serve_mask=(False, "refused")), env)
    monkeypatch.setenv("DPT_KERNEL_PRIORS", env)
    assert not km.get_kernel_policy("cuda").serve_mask
    assert km.config_kernel_policy(TrainConfig(kernels="cuda")).serve_mask \
        is False
    # the config's file wins over the environment's
    assert km.config_kernel_policy(TrainConfig(
        kernels="cuda", kernel_priors=path)).serve_mask


def test_the_trainer_disengages_before_the_run(tmp_path, caplog):
    """A file rejecting conv_epilogue and fused_loss: milesial is built
    with plain BatchNorm + ReLU and the loss is the plain one, with one
    warning per verdict."""
    path = str(tmp_path / "priors.json")
    km.save_priors(_priors(conv_epilogue=(False, "x"),
                           fused_loss=(False, "y")), path)
    args = cli.get_args(["--kernel-priors", path, "--kernels", "cuda",
                         "--model", "milesial", "--model-widths", "8", "16",
                         "--synthetic", "8", "--image-size", "48", "32",
                         "--device", "cpu", "--num-workers", "0",
                         "--checkpoint-dir", str(tmp_path / "c")])
    config = cli.to_config(args)
    assert config.kernel_priors == path
    with caplog.at_level(logging.WARNING, logger=km.__name__):
        trainer = Trainer(config)
    assert not trainer.kernels.conv_epilogue
    assert not trainer.kernels.train_loss_fused
    assert trainer.kernels.eval_stats_fused
    norms = [m for m in trainer.model.modules()
             if isinstance(m, BatchNormAct)]
    assert norms and not any(m.epilogue for m in norms)
    assert len([r for r in caplog.records if r.name == km.__name__]) == 2


def test_the_serve_cli_takes_the_priors(tmp_path):
    path = str(tmp_path / "priors.json")
    km.save_priors(_priors(serve_mask=(False, "no")), path)
    model = create_model(TrainConfig(model_widths=(8, 16), device="cpu"))
    checkpoint.save_pth(model.state_dict(), str(tmp_path / "w.pth"))
    args = serve_cli.get_args(["-c", str(tmp_path / "w.pth"),
                               "--model-widths", "8", "16", "--image-size",
                               "48", "32", "--kernels", "cuda", "--device",
                               "cpu", "--buckets", "1", "--kernel-priors",
                               path])
    assert serve_cli.to_config(args).kernel_priors == path
    server = serve_cli.build_server(args)
    try:
        assert not server.engine.mask_on_device
        assert server.engine.kernel_policy.train_loss_fused
    finally:
        server.stop()
    assert ServeConfig().kernel_priors is None


def test_every_probe_accepts_its_plain_version_on_the_cpu(tmp_path):
    rows = []
    payload = probes.run_probes(emit=rows.append, device="cpu")
    assert payload["kind"] == km.PRIORS_KIND
    assert payload["version"] == km.PRIORS_VERSION
    assert payload["platform"] == "cpu"
    assert set(payload["kernels"]) == set(NAMES)
    for name, row in payload["kernels"].items():
        assert row["accepted"] is True, (name, row)
        assert row["compile_s"] >= 0 and row["build_s"] == 0.0
        assert row["max_rel_err"] <= 1e-4
    assert [r["kernel"] for r in rows] == NAMES


def test_a_failure_is_recorded_not_raised(monkeypatch):
    """A child that dies is a rejection with its last words; a probe
    that raises in its process is one with its error."""
    monkeypatch.setattr(probes, "_child_command", lambda name, device: [
        sys.executable, "-c",
        "import sys; sys.exit('CUDA error 700: illegal address')"])
    row = probes.run_probes(["fused_loss"], device="cpu")["kernels"][
        "fused_loss"]
    assert row["accepted"] is False and "illegal address" in row["reason"]

    def boom(device):
        raise RuntimeError("nvcc failed: sm_90a")

    monkeypatch.setitem(probes.PROBES, "serve_mask", boom)
    row = probes.probe_here("serve_mask", torch.device("cpu"))
    assert row["accepted"] is False and "nvcc failed" in row["reason"]


def test_unknown_names_and_a_missing_card_are_refused():
    with pytest.raises(ValueError, match="unknown probe"):
        probes.run_probes(["warp_drive"], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            probes.run_probes(["serve_mask"])


def test_the_entry_point_writes_a_file_both_packages_load(tmp_path,
                                                          capsys):
    from distributedpytorch_tpu_torch.__main__ import main

    out = str(tmp_path / "kernel_priors.json")
    assert main(["probe", "--device", "cpu", "--out", out,
                 "serve_mask"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["probed"] == ["serve_mask"] and summary["rejected"] == []
    assert km.load_priors(out)["kernels"]["serve_mask"]["accepted"]
    assert jkm.load_priors(out)["kernels"]["serve_mask"]["accepted"]
    # and the other way round, with its effect on each policy
    theirs = str(tmp_path / "jax.json")
    jkm.save_priors(_priors(conv_epilogue=(False, "Mosaic")), theirs)
    assert not km.apply_priors(km.KERNEL_POLICIES["cuda"],
                               km.load_priors(theirs)).conv_epilogue
    ours = str(tmp_path / "port.json")
    km.save_priors(_priors(fused_loss=(False, "CUDA")), ours)
    assert not jkm.apply_priors(jkm.KERNEL_POLICIES["pallas"],
                                jkm.load_priors(ours)).train_loss_fused


def test_missing_corrupt_and_stale_files_are_ignored_with_a_note(tmp_path,
                                                                 caplog):
    path = str(tmp_path / "p.json")
    km.save_priors(_priors(fused_loss=(True, "")), path)
    assert km.load_priors(path)["kernels"]["fused_loss"]["accepted"]
    with caplog.at_level(logging.INFO, logger=km.__name__):
        assert km.load_priors(str(tmp_path / "absent.json")) is None
        garbage = tmp_path / "garbage.json"
        garbage.write_text("{not json")
        assert km.load_priors(str(garbage)) is None
        stale = tmp_path / "stale.json"
        payload = _priors(fused_loss=(False, ""))
        payload["version"] = km.PRIORS_VERSION + 1
        stale.write_text(json.dumps(payload))
        assert km.load_priors(str(stale)) is None
    notes = " ".join(r.getMessage() for r in caplog.records)
    assert "not found" in notes and "unreadable" in notes
    assert "stale or malformed" in notes
    # an ignored file leaves the policy as it is
    assert km.config_kernel_policy(TrainConfig(
        kernels="cuda", kernel_priors=str(stale))).train_loss_fused
