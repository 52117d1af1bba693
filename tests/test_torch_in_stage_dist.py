"""In-stage sharding over two gloo ranks (``-t 2x2x2``, ``2x1x2@fsdp``,
``2x2x2@fsdp``, ``parallel/in_stage.py``), each rank on ``[cpu] * 4`` at
``-b 2`` with two microbatches, on the CPU at the JAX test's size (16 ×
24 images, widths (8, 16), float32).

* Each point against its flat twin ``2x1x2``, both models, both
  schedules, one step from the same weights without the faithful scale:
  the loss, every gradient before Adam, every weight after Adam,
  milesial's running statistics and the eval metrics bitwise equal, on
  both ranks (the gather is a copy, its backward a slice, and each
  reduction over the ranks is a sum of two, in any order the same).
* The UNet's ``2x2x2@fsdp``/1f1b and milesial's ``2x2x2``/gpipe against
  the JAX package's in-stage pipeline
  (``make_pipeline_value_and_grad_fn(..., mesh_config=...)``) on its 8
  virtual CPU devices, fed the two ranks' batches joined: the loss within
  1e-5, every gradient within 1e-4 of its tensor's largest (a factor of
  2 fails it), the running statistics within 1e-5.
* The bytes each (rank, stage, slice) place holds under ``2x2x2@fsdp``;
  one epoch through the ``Trainer`` under ``2x2x2@fsdp``, rank 0's file
  resuming under singleGPU bitwise; a singleGPU file resuming under
  ``2x2x2@fsdp``; the CLI training one epoch under ``2x2x2``.

The ranks run every scenario in one launch of
``tests/torch_ddp_worker.py`` (the ``ranks`` fixture), started in the
background while the JAX references compute."""

import logging
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.config import TrainConfig as JaxTrainConfig
from distributedpytorch_tpu.models import create_model as jax_create_model
from distributedpytorch_tpu.parallel import strategy as jax_strategy
from distributedpytorch_tpu.parallel.pipeline import (
    make_pipeline_value_and_grad_fn,
)
from distributedpytorch_tpu_torch import checkpoint
from distributedpytorch_tpu_torch.checkpoint import params_to_jax
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.models import create_model
from distributedpytorch_tpu_torch.train.loop import Trainer
from torch_ddp_worker import launch
from torch_parallel_parity import max_err_rel_to_max, to_port

H, W = 16, 24
WIDTHS = (8, 16)
B = 2  # per rank: two microbatches of one
WORLD = 2
LR = 1e-4
ARCHS = ["unet", "milesial"]
SCHEDULES = ["gpipe", "1f1b"]
POINTS = ["2x2x2", "2x1x2@fsdp", "2x2x2@fsdp"]
TWIN = "2x1x2"
#: the points held against the JAX package's in-stage pipeline
AGAINST_JAX = [("unet", "2x2x2@fsdp", "1f1b"), ("milesial", "2x2x2", "gpipe")]
EPOCH = dict(epochs=1, batch_size=B, val_percent=25.0, seed=42,
             image_size=(W, H), model_widths=WIDTHS, synthetic_samples=24,
             metric_every_steps=1, num_workers=0, s2d_levels=0, dtype="f32",
             learning_rate=LR, kernels="cuda")
CLI = ["--synthetic", "16", "--image-size", str(W), str(H),
       "--model-widths", "8", "16", "-b", str(B), "-v", "25", "--device",
       "cpu", "--num-workers", "0", "--s2d-levels", "0", "--dtype", "f32",
       "-e", "1"]


def _batch(b, seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((b, H, W, 3), np.float32),
            "mask": (rng.random((b, H, W)) > 0.6).astype(np.int32)}


def _initial(arch):
    return create_model(TrainConfig(model_arch=arch, model_widths=WIDTHS,
                                    dtype="f32"),
                        generator=torch.Generator().manual_seed(3)
                        ).state_dict()


def _single_file(tmp, arch):
    """A singleGPU run of one epoch from the seeded weights; its file."""
    cfg = TrainConfig(**EPOCH, model_arch=arch, device="cpu",
                      checkpoint_dir=str(tmp / "checkpoints"),
                      log_dir=str(tmp / "logs"), loss_dir=str(tmp / "loss"))
    Trainer(cfg, initial_state=_initial(arch)).train()
    return str(tmp / "checkpoints" / "singleGPU.pt")


def _jobs(tmp):
    jobs = {}
    for arch in ARCHS:
        for schedule in SCHEDULES:
            for method in [TWIN, *POINTS]:
                jobs[f"step-{method}-{arch}-{schedule}"] = {
                    "kind": "pipeline_steps", "method": method,
                    "initial": _initial(arch), "eval": True,
                    "batches": [_batch(B * WORLD, 1)],
                    "config": dict(
                        model_arch=arch, model_widths=WIDTHS, dtype="f32",
                        kernels="cuda", batch_size=B, learning_rate=LR,
                        image_size=(W, H), num_microbatches=2,
                        pipeline_schedule=schedule,
                        faithful_loss_scaling=False)}
    jobs["trainer-2x2x2@fsdp"] = {
        "kind": "trainer", "method": "2x2x2@fsdp", "dir": str(tmp / "fsdp"),
        "initial": _initial("unet"), "config": dict(EPOCH,
                                                    model_arch="unet")}
    jobs["resume-2x2x2@fsdp"] = {
        "kind": "trainer", "method": "2x2x2@fsdp", "initial": None,
        "dir": str(tmp / "resume"),
        "config": dict(EPOCH, model_arch="milesial",
                       checkpoint_name=_single_file(tmp / "single",
                                                    "milesial"))}
    # last: the CLI's run leaves the group
    jobs["z-cli"] = {"kind": "cli", "dir": str(tmp / "cli"),
                     "argv": ["-t", "2x2x2", *CLI]}
    return jobs


def _jax_reference(arch, spec, schedule):
    """The JAX package's in-stage pipeline on 8 virtual devices from the
    same weights on the joined batch: ``(loss, {port name: gradient or
    running statistic})``."""
    cfg = JaxTrainConfig(train_method=spec, batch_size=B * WORLD,
                         dtype="f32", kernels="xla", model_arch=arch,
                         model_widths=WIDTHS, image_size=(W, H),
                         s2d_levels=0, pipeline_schedule=schedule)
    model, _init = jax_create_model(cfg)
    strat = jax_strategy.build_strategy(cfg, devices=jax.devices()[:8])
    assert dict(strat.mesh.shape) == {"data": 2, "model": 2, "stage": 2}
    fn = make_pipeline_value_and_grad_fn(
        model, strat.mesh, num_microbatches=2, schedule=schedule,
        mesh_config=strat.mesh_config)
    params, stats = params_to_jax(_initial(arch))
    params, stats = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                 (params, stats))
    data = _batch(B * WORLD, 1)
    batch = {"image": jnp.asarray(data["image"]),
             "mask": jnp.asarray(data["mask"].astype(np.float32))[..., None]}
    loss, grads, new_stats = jax.jit(fn)(params, stats, batch)
    return float(loss), to_port(grads, new_stats)


class _Background:
    """``launch`` of the jobs on a thread; ``result()`` waits for it."""

    def __init__(self, job_dir, jobs):
        self.out = {}
        self.thread = threading.Thread(target=self._run,
                                       args=(job_dir, jobs), daemon=True)
        self.thread.start()

    def _run(self, job_dir, jobs):
        try:
            self.out["ranks"] = launch(job_dir, jobs)
        except BaseException as exc:  # re-raised in the test's thread
            self.out["error"] = exc

    def result(self):
        self.thread.join()
        if "error" in self.out:
            raise self.out["error"]
        return self.out["ranks"]


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("in_stage")
    return _Background(tmp / "job", _jobs(tmp))


@pytest.fixture(scope="module")
def jax_refs(background):
    """The JAX references, computed while the ranks run."""
    return {combo: _jax_reference(*combo) for combo in AGAINST_JAX}


@pytest.fixture(scope="module")
def ranks(background, jax_refs):
    return background.result()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("spec", POINTS)
def test_in_stage_step_is_bitwise_its_flat_twin(ranks, spec, schedule,
                                                arch):
    """One step of ``spec`` and of ``2x1x2`` from the same weights on the
    same batches: the loss, every gradient before Adam (put together
    whole), the state after Adam (milesial's running statistics
    included) and the eval metrics bitwise equal, and the two ranks
    bitwise equal; the mesh is JAX's, in its axis order."""
    for r in ranks:
        twin = r[f"step-{TWIN}-{arch}-{schedule}"]
        new = r[f"step-{spec}-{arch}-{schedule}"]
        assert new["name"] == spec and new["lr"] == twin["lr"] == LR
        assert list(new["mesh"].items()) == [
            ("data", 2), *((("model", 2),) if spec.startswith("2x2")
                           else ()), ("stage", 2)]
        # the step's devices: the twin's stages, the point's every place
        assert twin["devices"] == ["cpu", "cpu"]
        assert new["devices"] == ["cpu"] * (4 if spec.startswith("2x2")
                                            else 2)
        assert torch.equal(new["losses"], twin["losses"])
        assert list(new["grads"]) == list(twin["grads"])
        for name, g in twin["grads"].items():
            assert torch.equal(new["grads"][name], g), name
        for key, value in twin["states"][0].items():
            assert torch.equal(new["states"][0][key], value), key
        for key in ("loss", "dice"):
            assert torch.equal(new["eval"][key], twin["eval"][key]), key
    r0, r1 = (r[f"step-{spec}-{arch}-{schedule}"] for r in ranks)
    for name, g in r0["grads"].items():
        assert torch.equal(g, r1["grads"][name]), name
    for key, value in r0["states"][0].items():
        assert torch.equal(value, r1["states"][0][key]), key


@pytest.mark.parametrize("arch,spec,schedule", AGAINST_JAX)
def test_the_port_matches_the_jax_in_stage_pipeline(ranks, jax_refs, arch,
                                                    spec, schedule):
    """The loss within 1e-5, every gradient before Adam within 1e-4 of its
    tensor's largest (twice it fails the bound), milesial's running
    statistics after the step within 1e-5 of their largest."""
    jloss, want = jax_refs[(arch, spec, schedule)]
    for r in ranks:
        got = r[f"step-{spec}-{arch}-{schedule}"]
        np.testing.assert_allclose(float(got["losses"][0]), jloss,
                                   rtol=1e-5)
        assert set(got["grads"]) == {k for k in want if not k.endswith(
            ("running_mean", "running_var", "num_batches_tracked"))}
        for name, g in got["grads"].items():
            err = max_err_rel_to_max(g.numpy(), want[name].numpy())
            assert err <= 1e-4, (name, err)
            assert max_err_rel_to_max(2 * g.numpy(),
                                      want[name].numpy()) > 1e-4, name
        running = [k for k in got["states"][0] if "running" in k]
        assert bool(running) == (arch == "milesial")
        for key in running:
            err = max_err_rel_to_max(got["states"][0][key].numpy(),
                                     want[key].numpy())
            assert err <= 1e-5, (key, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_place_holds_its_share(ranks, arch):
    """Under ``2x2x2@fsdp`` each (rank, stage, slice) place holds at most
    its stage's parameters and Adam's state / 4 × 1.6 (the JAX test's
    margin, tests/test_mesh.py:341) beside what it keeps whole (the head,
    on slice 0 of the last stage), no whole leaf is alive between steps,
    and the places add up to each stage's whole state plus the head kept
    on every rank; under ``2x2x2`` each rank holds each stage whole, half
    on each slice."""
    places = {}
    for rank, r in enumerate(ranks):
        got = r[f"step-2x2x2@fsdp-{arch}-gpipe"]["slice_bytes"]
        assert got["whole_leaves"] == 0
        stages = got["stage_bytes"]
        for (stage, i), held in got["held"].items():
            kept = got["kept_whole"].get((stage, i), 0)
            assert held - kept <= stages[stage] / 4 * 1.6, (stage, i)
            places[(rank, stage, i)] = (held, kept)
    assert len(places) == 8
    for stage, whole in stages.items():
        total = sum(h for (_r, s, _i), (h, _k) in places.items()
                    if s == stage)
        kept = sum(k for (_r, s, _i), (_h, k) in places.items()
                   if s == stage)
        assert total - kept / 2 == whole, stage
    flat = ranks[0][f"step-2x2x2-{arch}-gpipe"]["slice_bytes"]
    for (stage, i), held in flat["held"].items():
        kept = {s: sum(v for (t, _i), v in flat["kept_whole"].items()
                       if t == s) for s in flat["stage_bytes"]}
        assert held - flat["kept_whole"].get((stage, i), 0) == (
            flat["stage_bytes"][stage] - kept[stage]) / 2


def test_rank_zeros_file_resumes_under_singlegpu_bitwise(ranks, tmp_path,
                                                         caplog):
    """One epoch under ``2x2x2@fsdp`` through the ``Trainer`` (4 steps per
    rank, 3 val batches): the ranks agree bitwise, rank 0 alone wrote,
    its manifest records the spec and the mesh in (data, model, stage)
    order. ``-c`` of its ``.pt`` under singleGPU restores the weights and
    Adam's moments bitwise."""
    spec = "2x2x2@fsdp"
    r0, r1 = (r[f"trainer-{spec}"] for r in ranks)
    assert r0["result"]["steps"] == r1["result"]["steps"] == 4
    assert r0["losses"] == r1["losses"]
    for key in ("val_loss", "val_dice"):
        assert r0["result"][key] == r1["result"][key]
    for key, value in r0["state"].items():
        assert torch.equal(value, r1["state"][key]), key
    assert r0["wrote"] == [f"checkpoints/{spec}.pt", f"checkpoints/{spec}.pth",
                           f"loss/{spec}/train_loss.pkl",
                           f"loss/{spec}/val_dice.pkl",
                           f"loss/{spec}/val_loss.pkl"]
    assert r1["wrote"] == []
    topology = r0["manifest"]["topology"]
    assert topology["strategy"] == topology["mesh_spec"] == spec
    assert topology["process_count"] == WORLD
    assert list(topology["mesh"].items()) == [("data", 2), ("model", 2),
                                              ("stage", 2)]
    written = os.path.join(r0["out"], "checkpoints", f"{spec}.pt")
    saved = checkpoint.load_native(written)
    for key, value in r0["state"].items():
        assert torch.equal(saved["model"][key], value), key
    cfg = TrainConfig(**{**EPOCH, "epochs": 2, "kernels": "torch"},
                      model_arch="unet", device="cpu",
                      checkpoint_name=written,
                      checkpoint_dir=str(tmp_path / "checkpoints"),
                      log_dir=str(tmp_path / "logs"),
                      loss_dir=str(tmp_path / "loss"))
    with caplog.at_level(logging.WARNING):
        trainer = Trainer(cfg)
    assert "mesh-resharding restore" in caplog.text
    for key, value in trainer.model.state_dict().items():
        assert torch.equal(value, saved["model"][key]), key
    opt = trainer.optimizer.state_dict()["state"]
    assert len(opt) == len(saved["optimizer"]["state"]) > 0
    for i, st in saved["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt[i][key], st[key]), (i, key)


def test_a_singlegpu_file_resumes_under_in_stage_zero(ranks):
    """A singleGPU milesial file after one epoch, resumed under
    ``2x2x2@fsdp`` at its last epoch: both ranks hold its weights and
    running statistics bitwise, and the file rank 0 writes again holds
    its Adam moments bitwise, each rank having cut and then gathered its
    pieces."""
    r0, r1 = (r["resume-2x2x2@fsdp"] for r in ranks)
    tmp = os.path.dirname(os.path.dirname(r0["out"]))
    single = checkpoint.load_native(os.path.join(
        tmp, "single", "checkpoints", "singleGPU.pt"))
    assert r0["resumed_from"]["manifest"]["strategy"] == "singleGPU"
    assert r0["result"]["steps"] == r1["result"]["steps"] == single["step"]
    for key, value in single["model"].items():
        assert torch.equal(r0["state"][key], value), key
        assert torch.equal(r1["state"][key], value), key
    again = checkpoint.load_native(os.path.join(
        r0["out"], "checkpoints", "2x2x2@fsdp.pt"))
    assert again["manifest"]["topology"]["mesh_spec"] == "2x2x2@fsdp"
    for i, st in single["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(again["optimizer"]["state"][i][key],
                               st[key]), (i, key)


def test_the_cli_trains_an_epoch_under_2x2x2(ranks):
    """``python -m distributedpytorch_tpu_torch -t 2x2x2`` on both ranks:
    it exits 0, rank 0 alone writes the checkpoint, the weights and the
    loss tables, and the manifest's topology is JAX's for the spec."""
    r0, r1 = (r["z-cli"] for r in ranks)
    assert r0["code"] == r1["code"] == 0
    assert r0["wrote"] == ["checkpoints/2x2x2.pt", "checkpoints/2x2x2.pth",
                           "logs/2x2x2.log", "loss/2x2x2/train_loss.pkl",
                           "loss/2x2x2/val_dice.pkl",
                           "loss/2x2x2/val_loss.pkl"]
    assert r1["wrote"] == ["logs/2x2x2.log"]
    topology = r0["manifest"]["topology"]
    assert topology == {"process_count": 2, "device_count": 8,
                        "strategy": "2x2x2",
                        "mesh": {"data": 2, "model": 2, "stage": 2},
                        "mesh_spec": "2x2x2", "precision": "f32"}
    pth = checkpoint.load_pth(os.path.join(r0["out"], "checkpoints",
                                           "2x2x2.pth"))
    assert all(torch.isfinite(v).all() for v in pth.values()
               if v.is_floating_point())


def test_no_rank_loaded_jax(ranks):
    assert ranks[0]["leaked"] == ranks[1]["leaked"] == []
