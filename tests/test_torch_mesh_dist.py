"""The port's mesh specs over two gloo ranks, on the CPU at a small size
(widths (8, 16), 16 × 24 images, float32).

* Each legacy multi-process name against its spec twin at the JAX
  ``LEGACY_PATTERNS`` geometry, one step from the same weights, bitwise:
  ``DDP``/``2x1x1``, ``FSDP``/``2x1x1@fsdp``, ``DDP_SP``/``2x2x1@sp`` and
  ``DDP_MP``/``2x1x2`` under both schedules, both models, milesial's
  running statistics included, with ``ddp_lr_world_size_scaling=False``.
* The two new geometries, ``2x2x1`` (data × channel) and ``2x2x1@fsdp``
  (ZeRO × channel), each rank on ``[cpu, cpu]`` at ``-b 2``, against the
  JAX package's ``2x2x1`` / ``2x2x1@fsdp`` on 4 of its virtual CPU
  devices at ``batch_size`` 2, fed the two ranks' batches joined (as
  tests/test_torch_fsdp.py holds FSDP): the loss within 1e-5, every
  gradient before Adam within 1e-4 of its tensor's largest, the weights
  after Adam within the bounds of JAX's own
  ``test_data_x_tensor_matches_single_device`` (rtol 5e-4, atol 3e-4),
  milesial's running statistics within 1e-5; each rank's bytes under
  ``@fsdp``.
* One epoch through the ``Trainer`` under each, rank 0's file resuming
  under singleGPU bitwise, a singleGPU file resuming under
  ``2x2x1@fsdp``, and the CLI training one epoch under ``2x2x1``.

The ranks run every scenario in one launch of
``tests/torch_ddp_worker.py`` (the ``ranks`` fixture, started in the
background while the JAX references compute)."""

import functools
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
from distributedpytorch_tpu.ops.optim import adam_l2
from distributedpytorch_tpu.parallel import mesh as jax_mesh
from distributedpytorch_tpu.parallel import strategy as jax_strategy
from distributedpytorch_tpu.train.steps import TrainState
from distributedpytorch_tpu_torch import checkpoint
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.train.loop import Trainer
from torch_ddp_worker import launch
from torch_parallel_parity import capture_then, max_err_rel_to_max, to_port

H, W = 16, 24
WIDTHS = (8, 16)
B = 2  # per rank under the new geometries
BT = 4  # per rank under the twins: DDP_MP needs world × microbatches
WORLD = 2
LR = 1e-4
ARCHS = ["unet", "milesial"]
NEW = ["2x2x1", "2x2x1@fsdp"]
TWINS = [("DDP", "2x1x1", None), ("FSDP", "2x1x1@fsdp", None),
         ("DDP_SP", "2x2x1@sp", None), ("DDP_MP", "2x1x2", "gpipe"),
         ("DDP_MP", "2x1x2", "1f1b")]
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


def _jax_config(arch, method, **kw):
    return JaxTrainConfig(**{**dict(
        train_method=method, batch_size=B, dtype="f32", kernels="xla",
        model_arch=arch, model_widths=WIDTHS, image_size=(W, H),
        s2d_levels=0, learning_rate=LR, ddp_lr_world_size_scaling=False),
        **kw})


@functools.cache
def _jax_init(arch):
    """The JAX model and its seeded weights (the init under ``jit``)."""
    model, init_fn = jax_create_model(_jax_config(arch, "singleGPU"))
    params, model_state = jax.jit(lambda key: init_fn(key, (H, W)))(
        jax.random.key(0))
    return model, params, model_state


def _jax_mesh_steps(arch, spec):
    """The JAX ``spec`` strategy on 4 virtual devices from the seeded
    weights: two Adam steps on the joined batches, the gradients of the
    first as Adam received them, each step's loss and state (port
    names)."""
    strategy = jax_strategy.build_strategy(_jax_config(arch, spec),
                                           devices=jax.devices()[:4])
    assert dict(strategy.mesh.shape) == {"data": 2, "model": 2}
    model, params, model_state = _jax_init(arch)
    tx = capture_then(adam_l2(LR))
    state = strategy.place_state(TrainState(
        params=params, opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32), model_state=model_state))
    step = strategy.build_train_step(model, tx)
    losses, states, grads = [], [], None
    for seed in (1, 2):
        state, loss = step(state, strategy.place_batch(_batch(B * WORLD,
                                                              seed)))
        grads = grads or to_port(state.opt_state[0], model_state)
        losses.append(float(loss))
        states.append(to_port(state.params, state.model_state))
    return losses, grads, states


def _single_file(tmp, arch):
    """A singleGPU run of one epoch from the seeded weights; its file."""
    _m, params, model_state = _jax_init(arch)
    cfg = TrainConfig(**EPOCH, model_arch=arch, device="cpu",
                      checkpoint_dir=str(tmp / "checkpoints"),
                      log_dir=str(tmp / "logs"), loss_dir=str(tmp / "loss"))
    Trainer(cfg, initial_state=to_port(params, model_state)).train()
    return str(tmp / "checkpoints" / "singleGPU.pt")


def _jobs(tmp):
    jobs = {}
    for arch in ARCHS:
        _m, params, model_state = _jax_init(arch)
        initial = to_port(params, model_state)
        for legacy, spec, schedule in TWINS:
            for method in (legacy, spec):
                jobs[f"twin-{method}-{arch}-{schedule}"] = {
                    "kind": "pipeline_steps", "method": method,
                    "initial": initial, "batches": [_batch(BT * WORLD, 1)],
                    "config": dict(
                        model_arch=arch, model_widths=WIDTHS, dtype="f32",
                        kernels="cuda", batch_size=BT, learning_rate=LR,
                        image_size=(W, H), num_microbatches=2,
                        pipeline_schedule=schedule or "gpipe",
                        ddp_lr_world_size_scaling=False)}
        for spec in NEW:
            jobs[f"steps-{spec}-{arch}"] = {
                "kind": "pipeline_steps", "method": spec, "initial": initial,
                "batches": [_batch(B * WORLD, seed) for seed in (1, 2)],
                "config": dict(model_arch=arch, model_widths=WIDTHS,
                               dtype="f32", kernels="cuda", batch_size=B,
                               learning_rate=LR, image_size=(W, H))}
    for spec, arch in (("2x2x1", "milesial"), ("2x2x1@fsdp", "unet")):
        _m, params, model_state = _jax_init(arch)
        jobs[f"trainer-{spec}"] = {
            "kind": "trainer", "method": spec, "dir": str(tmp / spec),
            "initial": to_port(params, model_state),
            "config": dict(EPOCH, model_arch=arch)}
    jobs["resume-2x2x1@fsdp"] = {
        "kind": "trainer", "method": "2x2x1@fsdp", "initial": None,
        "dir": str(tmp / "resume"),
        "config": dict(EPOCH, model_arch="milesial",
                       checkpoint_name=_single_file(tmp / "single",
                                                    "milesial"))}
    # last: the CLI's run leaves the group
    jobs["z-cli"] = {"kind": "cli", "dir": str(tmp / "cli"),
                     "argv": ["-t", "2x2x1", *CLI]}
    return jobs


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
    tmp = tmp_path_factory.mktemp("mesh")
    return _Background(tmp / "job", _jobs(tmp))


@pytest.fixture(scope="module")
def jax_steps(background):
    """The JAX references, computed while the ranks run."""
    return {(spec, arch): _jax_mesh_steps(arch, spec)
            for spec in NEW for arch in ARCHS}


@pytest.fixture(scope="module")
def ranks(background, jax_steps):
    return background.result()


# -- the legacy names against their spec twins ------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("legacy,spec,schedule", TWINS)
def test_spec_twin_is_bitwise_the_legacy_strategy(ranks, legacy, spec,
                                                  schedule, arch):
    """One step of each multi-process name and of its spec twin (the
    JAX ``LEGACY_PATTERNS`` geometry of that name) from the same weights
    on the same batch: the loss, every gradient before Adam and the state
    after it (running statistics included) bitwise equal, on both ranks,
    with ``ddp_lr_world_size_scaling=False``; the twin's name is the
    canonical spec and its mesh the JAX axes of size > 1."""
    assert jax_mesh.canonical_spec(jax_mesh.LEGACY_PATTERNS[legacy]) == spec
    for r in ranks:
        old = r[f"twin-{legacy}-{arch}-{schedule}"]
        new = r[f"twin-{spec}-{arch}-{schedule}"]
        assert new["name"] == spec
        assert new["mesh"] == dict(jax_mesh.axis_layout(
            jax_mesh.parse_mesh_spec(spec)))
        assert new["lr"] == old["lr"] == LR
        assert new["devices"] == old["devices"]
        assert torch.equal(new["losses"], old["losses"])
        assert list(new["grads"]) == list(old["grads"])
        for name, g in old["grads"].items():
            assert torch.equal(new["grads"][name], g), name
        for key, value in old["states"][0].items():
            assert torch.equal(new["states"][0][key], value), key


# -- data × channel and ZeRO × channel against the JAX package ------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("spec", NEW)
def test_new_geometries_match_the_jax_package(ranks, jax_steps, spec, arch):
    """Two steps on the joined batches: the losses within 1e-5; every
    gradient before Adam, whole, within 1e-4 of its tensor's largest (the
    ranks' mean of their ``world ×`` gradients: a factor of 2 either way
    fails it); the weights after each step within JAX's own
    ``test_data_x_tensor_matches_single_device`` bounds (rtol 5e-4, atol
    3e-4) and milesial's running statistics within 1e-5 of their
    largest. The two ranks' gradients and whole states are bitwise
    equal; milesial's BatchNorm takes global moments; the mesh is JAX's
    and the lr the base lr."""
    jlosses, jgrads, jstates = jax_steps[(spec, arch)]
    r0, r1 = (r[f"steps-{spec}-{arch}"] for r in ranks)
    np.testing.assert_allclose(r0["losses"].numpy(), jlosses, rtol=1e-5)
    assert torch.equal(r0["losses"], r1["losses"])
    assert r0["name"] == spec and r0["lr"] == LR
    assert r0["mesh"] == {"data": 2, "model": 2}
    assert r0["devices"] == ["cpu", "cpu"]
    if arch == "milesial":
        assert r0["global_stats"] == [True]
    assert set(r0["grads"]) == {k for k in jgrads if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))}
    for name, g in r0["grads"].items():
        err = max_err_rel_to_max(g.numpy(), jgrads[name].numpy())
        assert err <= 1e-4, (name, err)
        assert torch.equal(g, r1["grads"][name]), name
    for i in range(2):
        for key, value in r0["states"][i].items():
            assert torch.equal(value, r1["states"][i][key]), key
            if key.endswith("num_batches_tracked"):
                assert int(value) == i + 1
            elif "running" in key:
                err = max_err_rel_to_max(value.numpy(),
                                         jstates[i][key].numpy())
                assert err <= 1e-5, (i, key, err)
            else:
                np.testing.assert_allclose(value.numpy(),
                                           jstates[i][key].numpy(),
                                           rtol=5e-4, atol=3e-4,
                                           err_msg=f"{i} {key}")


@pytest.mark.parametrize("arch", ARCHS)
def test_each_card_holds_its_share_under_zero(ranks, arch):
    """Under ``2x2x1@fsdp`` each of the four (rank, slice) places holds at
    most total/4 × 1.6 of the parameters' and Adam's bytes (the JAX
    test's margin, tests/test_mesh.py:341), the four add up to more than
    the total only by the head kept whole on every rank, and no whole
    slice of a cut parameter stays alive between steps; under ``2x2x1``
    each rank holds every slice."""
    places = []
    for r in ranks:
        got = r[f"steps-2x2x1@fsdp-{arch}"]["slice_bytes"]
        assert got["whole_leaves"] == 0
        places += list(got["held"].values())
        assert ranks[0][f"steps-2x2x1-{arch}"]["slice_bytes"] is None
    mine, whole = ranks[0][f"steps-2x2x1-{arch}"]["bytes"]
    assert mine == whole
    assert len(places) == 4
    assert max(places) <= whole / 4 * 1.6, (places, whole)
    assert whole <= sum(places) <= whole * 1.05, (places, whole)


# -- the trainer, its files and the CLI -----------------------------------------


@pytest.mark.parametrize("spec", NEW)
def test_rank_zeros_file_resumes_under_singlegpu_bitwise(ranks, spec,
                                                         tmp_path, caplog):
    """One epoch under the spec through the ``Trainer`` (4 steps per rank,
    3 val batches: one on each rank and the tail on both): the ranks
    agree bitwise, rank 0 alone wrote, its manifest records the spec.
    ``-c`` of its ``.pt`` under singleGPU restores the weights and Adam's
    moments bitwise, with the reshard log line."""
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
    assert topology["mesh"] == {"data": 2, "model": 2}
    written = os.path.join(r0["out"], "checkpoints")
    saved = checkpoint.load_native(os.path.join(written, f"{spec}.pt"))
    for key, value in r0["state"].items():
        assert torch.equal(saved["model"][key], value), key
    arch = saved["manifest"]["model_arch"]
    cfg = TrainConfig(**{**EPOCH, "epochs": 2, "kernels": "torch"},
                      model_arch=arch, device="cpu",
                      checkpoint_name=os.path.join(written, f"{spec}.pt"),
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


def test_a_singlegpu_file_resumes_under_zero_x_channel(ranks):
    """A singleGPU milesial file after one epoch, resumed under
    ``2x2x1@fsdp`` at its last epoch: both ranks hold its weights and
    running statistics bitwise, and the file rank 0 writes again holds
    its Adam moments bitwise, each rank having cut and then gathered its
    pieces."""
    r0, r1 = (r["resume-2x2x1@fsdp"] for r in ranks)
    tmp = os.path.dirname(os.path.dirname(r0["out"]))
    single = checkpoint.load_native(os.path.join(
        tmp, "single", "checkpoints", "singleGPU.pt"))
    assert r0["resumed_from"]["manifest"]["strategy"] == "singleGPU"
    # no step after the restore
    assert r0["result"]["steps"] == r1["result"]["steps"] == single["step"]
    for key, value in single["model"].items():
        assert torch.equal(r0["state"][key], value), key
        assert torch.equal(r1["state"][key], value), key
    again = checkpoint.load_native(os.path.join(
        r0["out"], "checkpoints", "2x2x1@fsdp.pt"))
    assert again["manifest"]["topology"]["mesh_spec"] == "2x2x1@fsdp"
    for i, st in single["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(again["optimizer"]["state"][i][key],
                               st[key]), (i, key)


def test_the_cli_trains_an_epoch_under_data_x_channel(ranks):
    """``python -m distributedpytorch_tpu_torch -t 2x2x1`` on both ranks
    (the group the worker joined stands for torchrun's): it exits 0,
    rank 0 alone writes ``2x2x1.pt``, ``2x2x1.pth``, the loss tables and
    its log, and the manifest's topology is JAX's for the spec."""
    r0, r1 = (r["z-cli"] for r in ranks)
    assert r0["code"] == r1["code"] == 0
    assert r0["wrote"] == ["checkpoints/2x2x1.pt", "checkpoints/2x2x1.pth",
                           "logs/2x2x1.log", "loss/2x2x1/train_loss.pkl",
                           "loss/2x2x1/val_dice.pkl",
                           "loss/2x2x1/val_loss.pkl"]
    assert r1["wrote"] == ["logs/2x2x1.log"]
    topology = r0["manifest"]["topology"]
    assert topology == {"process_count": 2, "device_count": 4,
                        "strategy": "2x2x1", "mesh": {"data": 2, "model": 2},
                        "mesh_spec": "2x2x1", "precision": "f32"}
    assert r0["manifest"]["world"] == 2
    pth = checkpoint.load_pth(os.path.join(r0["out"], "checkpoints",
                                           "2x2x1.pth"))
    assert all(torch.isfinite(v).all() for v in pth.values()
               if v.is_floating_point())


def test_no_rank_loaded_jax(ranks):
    assert ranks[0]["leaked"] == ranks[1]["leaked"] == []
