"""The port's ``-t FSDP`` against the JAX package's, on the CPU at a small
size (widths (8, 16), 32 × 16 images, float32, ``-b 2`` per rank: a
global batch of 4).

The port runs as two gloo ranks (``tests/torch_ddp_worker.py``, one
process each, torch only), each holding its dim-0 shard of every
parameter and of Adam's state (``torch.distributed.fsdp.fully_shard``);
the JAX reference is the JAX FSDP strategy on a 2-device CPU mesh with
``batch_size`` the per-rank ``b``, fed step by step the concatenation of
the two ranks' batches, as tests/test_torch_ddp.py holds DDP: one loss
over the global batch, its gradient scaled by the per-process ``b``,
BatchNorm on the global batch's moments, and no lr quirk. Weights cross
with ``checkpoint.params_from_jax``; inputs are numpy arrays made from
seeds. PERF.md §2's bounds: the loss within 1e-5, each gradient before
Adam within 1e-4 of its tensor's largest, the running statistics and the
weights after Adam within 1e-5 (1e-4 after two steps, as DDP's).

The scenarios run in one 2-rank launch (the ``ranks`` fixture), bounded
by ``LAUNCH_TIMEOUT_S``."""

import logging
import os

import jax
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.config import TrainConfig as JaxTrainConfig
from distributedpytorch_tpu.data import (
    SyntheticSegmentationDataset as JaxSynthetic,
)
from distributedpytorch_tpu.data.loader import DataLoader as JaxLoader
from distributedpytorch_tpu.data.loader import ShardSpec as JaxShard
from distributedpytorch_tpu.data.loader import seeded_split as jax_split
from distributedpytorch_tpu.evaluate import evaluate as jax_evaluate
from distributedpytorch_tpu.models import create_model as jax_create_model
from distributedpytorch_tpu.ops.schedule import (
    ReduceLROnPlateau as JaxPlateau,
)
from distributedpytorch_tpu.parallel import mesh as jax_mesh
from distributedpytorch_tpu.parallel.strategy import (
    build_strategy as jax_build_strategy,
)
from distributedpytorch_tpu.train.steps import TrainState, create_train_state
from distributedpytorch_tpu_torch import checkpoint
from distributedpytorch_tpu_torch.checkpoint import params_from_jax
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.data.loader import ShardSpec
from distributedpytorch_tpu_torch.dist import runtime
from distributedpytorch_tpu_torch.parallel import strategy as port_strategy
from distributedpytorch_tpu_torch.train.loop import Trainer
from torch_ddp_worker import launch
from torch_parallel_parity import run_cli

H, W = 32, 16
WIDTHS = (8, 16)
B = 2  # per rank
WORLD = 2
LR = 1e-4
ARCHS = ["unet", "milesial"]
# the trainer scenario: --synthetic 24 -v 25 -b 2 -e 1 → 6 val samples in
# 3 batches (an odd count: one pair split over the ranks, the tail on
# both), 18 train samples, 9 per rank, 4 steps with the ragged one dropped
EPOCH = dict(epochs=1, batch_size=B, val_percent=25.0, seed=42,
             image_size=(W, H), model_widths=WIDTHS, synthetic_samples=24,
             metric_every_steps=1, num_workers=0, s2d_levels=0, dtype="f32",
             learning_rate=LR)


def _batch(b, seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((b, H, W, 3), np.float32),
            "mask": (rng.random((b, H, W)) > 0.6).astype(np.int32)}


def _step_batches():
    return [_batch(B * WORLD, seed) for seed in (1, 2)]


def _jax_fsdp(arch, **kw):
    """The JAX FSDP strategy on 2 CPU devices, its model and the seeded
    initial weights."""
    cfg = JaxTrainConfig(**{**dict(
        train_method="FSDP", batch_size=B, dtype="f32", kernels="xla",
        model_arch=arch, model_widths=WIDTHS, image_size=(W, H),
        s2d_levels=0, learning_rate=LR), **kw})
    strategy = jax_build_strategy(cfg, devices=jax.devices()[:WORLD])
    assert dict(strategy.mesh.shape) == {"data": WORLD}
    model, init_fn = jax_create_model(cfg)
    params, model_state = init_fn(jax.random.key(0), (H, W))
    return cfg, strategy, model, params, model_state


def _to_port(params, model_state):
    return params_from_jax(
        jax.device_get(params),
        None if model_state is None else jax.device_get(model_state))


def _jobs(tmp):
    jobs = {}
    for arch in ARCHS:
        _cfg, _s, _m, params, model_state = _jax_fsdp(arch)
        initial = _to_port(params, model_state)
        for policy in ("torch", "cuda"):
            config = dict(model_arch=arch, model_widths=WIDTHS, dtype="f32",
                          kernels=policy, batch_size=B, learning_rate=LR,
                          image_size=(W, H), ddp_lr_world_size_scaling=True)
            jobs[f"steps-{arch}-{policy}"] = {
                "kind": "pipeline_steps", "method": "FSDP",
                "config": config, "initial": initial,
                "batches": _step_batches()}
        jobs[f"trainer-{arch}"] = {
            "kind": "trainer", "method": "FSDP", "initial": initial,
            "dir": str(tmp / f"trainer-{arch}"),
            "config": dict(EPOCH, model_arch=arch, kernels="cuda",
                           ddp_lr_world_size_scaling=True)}
    return jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every scenario's results on both ranks, from one 2-rank launch."""
    tmp = tmp_path_factory.mktemp("fsdp")
    return launch(tmp / "job", _jobs(tmp))


def _max_err_rel_to_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    return err / scale if scale else err


def _jax_capture_tx():
    """An optax transformation that leaves the params and keeps the
    (scaled) gradients as its state."""
    import optax

    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jax.numpy.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jax.numpy.zeros_like, g),
                                     g))


def _jax_steps(arch):
    """The JAX FSDP's first-step gradients (before Adam), its losses over
    the two global batches and the state after each."""
    cfg, strategy, model, params, model_state = _jax_fsdp(arch)
    batches = [strategy.place_batch(b) for b in _step_batches()]
    capture = strategy.build_train_step(model, _jax_capture_tx())
    cstate = strategy.place_state(TrainState(
        params=params, opt_state=_jax_capture_tx().init(params),
        step=jax.numpy.zeros((), jax.numpy.int32), model_state=model_state))
    cstate, _ = capture(cstate, batches[0])
    grads = cstate.opt_state
    state, tx = create_train_state(params, strategy.lr_for(cfg.learning_rate),
                                   cfg.weight_decay, model_state=model_state,
                                   policy=strategy.policy)
    state = strategy.place_state(state)
    step = strategy.build_train_step(model, tx)
    losses, states = [], []
    for batch in batches:
        state, loss = step(state, batch)
        losses.append(float(loss))
        states.append(_to_port(state.params, state.model_state))
    return losses, _to_port(grads, model_state), states


# -- the strategy ------------------------------------------------------------------


@pytest.mark.parametrize("scaling", [True, False])
def test_fsdp_strategy_matches_the_jax_fsdp(scaling):
    """Shards, global batch, drop_last and mesh against the JAX FSDP on a
    2-device mesh (the per-process values a 2-process run has), and the
    lr not scaled whatever ``ddp_lr_world_size_scaling`` says (the JAX
    docstring: FSDP is a memory layout, not the reference's DDP recipe);
    the manifest's ``2x1x1@fsdp``, JAX's ``canonical_spec``."""
    _c, jfsdp, _m, _p, _s = _jax_fsdp("unet",
                                      ddp_lr_world_size_scaling=scaling)
    cfg = TrainConfig(train_method="FSDP", batch_size=B, device="cpu",
                      ddp_lr_world_size_scaling=scaling)
    for rank in range(WORLD):
        fsdp = port_strategy.build_strategy(cfg, runtime.RuntimeInfo(
            rank, WORLD))
        assert fsdp.name == jfsdp.name == "FSDP"
        assert fsdp.lr_for(LR) == jfsdp.lr_for(LR) == LR
        assert fsdp.drop_last_train is jfsdp.drop_last_train is True
        assert fsdp.global_batch_size == B * WORLD
        assert fsdp.data_shard() == fsdp.eval_shard() == ShardSpec(rank,
                                                                    WORLD)
        assert fsdp.is_main == (rank == 0)
        assert fsdp.gathers_state
        assert fsdp.mesh_shape() == dict(jfsdp.mesh.shape)
        topology = checkpoint.jax_topology(fsdp.name, fsdp.mesh_shape(),
                                           "f32")
        assert topology["mesh_spec"] == jax_mesh.canonical_spec(
            jfsdp.mesh_config) == "2x1x1@fsdp"
        assert topology["process_count"] == WORLD


# -- two steps against the JAX FSDP ------------------------------------------------


@pytest.mark.parametrize("policy", ["torch", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_steps_match_the_jax_fsdp(ranks, arch, policy):
    """Two steps from the same weights, each on the concatenation of the
    ranks' batches: the losses within 1e-5 relative; every weight
    gradient of the first step, gathered whole, as Adam receives it,
    within 1e-4 of its tensor's largest (FSDP2's reduce-scatter averages
    the ranks' ``world ×`` gradients: a factor of 2 either way fails it);
    the weights and running statistics after the first step within 1e-5,
    after the second within 1e-4, as DDP's. Both ranks' gradients and
    gathered state are bitwise equal; the lr is the base lr under
    ``ddp_lr_world_size_scaling``; milesial's BatchNorm takes global
    moments."""
    jlosses, jgrads, jstates = _jax_steps(arch)
    r0, r1 = (r[f"steps-{arch}-{policy}"] for r in ranks)
    np.testing.assert_allclose(r0["losses"].numpy(), jlosses, rtol=1e-5)
    assert r0["lr"] == r1["lr"] == LR
    assert r0["mesh"] == {"data": WORLD}
    if arch == "milesial":
        assert r0["global_stats"] == [True]
    for name, g in r0["grads"].items():
        err = _max_err_rel_to_max(g.numpy(), jgrads[name].numpy())
        assert err <= 1e-4, (name, err)
        assert torch.equal(g, r1["grads"][name]), name
    for i, tol in enumerate((1e-5, 1e-4)):
        for key, value in r0["states"][i].items():
            assert torch.equal(value, r1["states"][i][key]), key
            if key.endswith("num_batches_tracked"):
                assert int(value) == i + 1
                continue
            err = _max_err_rel_to_max(value.numpy(), jstates[i][key].numpy())
            assert err <= tol, (i, key, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_share_of_the_state(ranks, arch):
    """Each rank's local bytes of parameters and Adam's state after the
    steps are at most the whole's / world × 1.5, as the JAX test asserts
    of its FSDP (tests/test_strategies.py:396-440), and the two ranks'
    shares add up to the whole."""
    mine0, whole = ranks[0][f"steps-{arch}-torch"]["bytes"]
    mine1, whole1 = ranks[1][f"steps-{arch}-torch"]["bytes"]
    assert whole == whole1
    assert max(mine0, mine1) <= whole / WORLD * 1.5, (mine0, mine1, whole)
    assert mine0 + mine1 == whole


# -- one epoch through the Trainer, its checkpoint, world 1 ----------------------


def _jax_epoch(arch):
    """The JAX FSDP step over the global batches of one epoch as two
    ``ShardSpec(r, 2)`` loaders form them, JAX ``evaluate`` on the
    weights it leaves (3 val batches), and the plateau scheduler."""
    cfg, strategy, model, params, model_state = _jax_fsdp(
        arch, **{k: v for k, v in EPOCH.items()
                 if k not in ("model_widths", "image_size", "s2d_levels",
                              "dtype", "batch_size", "learning_rate")})
    data = JaxSynthetic(length=EPOCH["synthetic_samples"], newsize=(W, H),
                        seed=EPOCH["seed"])
    train_idx, val_idx = jax_split(len(data), cfg.val_fraction, seed=0)
    loaders = [JaxLoader(data, indices=train_idx, batch_size=B, shuffle=True,
                         drop_last=True, seed=EPOCH["seed"],
                         shard=JaxShard(rank, WORLD))
               for rank in range(WORLD)]
    lr0 = strategy.lr_for(cfg.learning_rate)
    state, tx = create_train_state(params, lr0, cfg.weight_decay,
                                   model_state=model_state,
                                   policy=strategy.policy)
    state = strategy.place_state(state)
    step = strategy.build_train_step(model, tx)
    losses = []
    for parts in zip(*(loader.epoch_batches(0) for loader in loaders)):
        batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        state, loss = step(state, strategy.place_batch(batch))
        losses.append(float(loss))
    val_loader = JaxLoader(data, indices=val_idx, batch_size=B,
                           shuffle=False, drop_last=True)
    variables = (state.params if state.model_state is None else
                 {"params": state.params, "batch_stats": state.model_state})
    val = jax_evaluate(strategy.build_eval_step(model), variables,
                       val_loader, strategy.place_batch)
    plateau = JaxPlateau(lr=lr0, patience=cfg.plateau_patience,
                         factor=cfg.plateau_factor)
    return losses, val, plateau.step(val[0]), len(val_loader)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_epoch_with_an_odd_val_count_matches_the_jax_fsdp(ranks, arch):
    """``Trainer`` under ``-t FSDP`` on two ranks, one epoch under
    ``--kernels cuda`` (the plain versions on the CPU): 4 steps per rank
    and 3 val batches, one on each rank and the tail on both, so every
    rank runs two forwards and each block's all-gather meets; the epoch
    finishes, and its losses, val loss, val Dice and plateau lr equal the
    JAX FSDP's over the same global batches within 1e-4 relative, as
    DDP's. The ranks agree bitwise, the lr is the base lr, and rank 0
    alone wrote."""
    jlosses, (jval_loss, jval_dice), jlr, n_val = _jax_epoch(arch)
    assert n_val == 3
    r0, r1 = (r[f"trainer-{arch}"] for r in ranks)
    assert r0["result"]["steps"] == len(jlosses) == 4
    np.testing.assert_allclose(r0["losses"], jlosses, rtol=1e-4)
    np.testing.assert_allclose(r0["result"]["val_loss"], jval_loss,
                               rtol=1e-4)
    np.testing.assert_allclose(r0["result"]["val_dice"], jval_dice,
                               rtol=1e-4)
    np.testing.assert_allclose(r0["lr"], jlr, rtol=1e-6)
    assert r0["lr"] == LR
    for key in ("val_loss", "val_dice", "steps"):
        assert r0["result"][key] == r1["result"][key], key
    assert r0["losses"] == r1["losses"]
    for key, value in r0["state"].items():
        assert torch.equal(value, r1["state"][key]), key
    assert r0["wrote"] == ["checkpoints/FSDP.pt", "checkpoints/FSDP.pth",
                           "loss/FSDP/train_loss.pkl",
                           "loss/FSDP/val_dice.pkl", "loss/FSDP/val_loss.pkl"]
    assert r1["wrote"] == []
    assert r0["manifest"]["topology"]["mesh_spec"] == "2x1x1@fsdp"
    assert r0["manifest"]["topology"]["process_count"] == WORLD


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_zeros_file_resumes_under_singlegpu_bitwise(ranks, arch,
                                                         tmp_path, caplog):
    """Rank 0's ``FSDP.pt`` and ``.pth`` hold the whole tensors the ranks
    gathered, bitwise, under the reference names, with Adam's state in
    the singleGPU layout; ``-c`` of it under singleGPU restores those
    weights and moments bitwise, with the reshard log line."""
    r0 = ranks[0][f"trainer-{arch}"]
    written = os.path.join(r0["out"], "checkpoints")
    saved = checkpoint.load_native(os.path.join(written, "FSDP.pt"))
    assert list(saved["model"]) == list(r0["state"])
    for key, value in r0["state"].items():
        assert torch.equal(saved["model"][key], value), key
    pth = checkpoint.load_pth(os.path.join(written, "FSDP.pth"))
    for key, value in r0["state"].items():
        assert torch.equal(pth[key], value), key
    assert len(saved["optimizer"]["param_groups"]) == 1
    cfg = TrainConfig(**{**EPOCH, "epochs": 2}, model_arch=arch,
                      device="cpu", kernels="torch",
                      checkpoint_name=os.path.join(written, "FSDP.pt"),
                      checkpoint_dir=str(tmp_path / "checkpoints"),
                      log_dir=str(tmp_path / "logs"),
                      loss_dir=str(tmp_path / "loss"))
    with caplog.at_level(logging.WARNING):
        trainer = Trainer(cfg)
    assert "mesh-resharding restore" in caplog.text
    for key, value in trainer.model.state_dict().items():
        assert torch.equal(value, saved["model"][key]), key
    opt = trainer.optimizer.state_dict()["state"]
    for i, st in saved["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt[i][key], st[key]), (i, key)


def test_without_a_launcher_fsdp_runs_as_world_one(tmp_path, monkeypatch):
    """``-t FSDP`` through the CLI with no launcher env: one rank over an
    in-memory store, as ``-t DDP`` (PR 6, difference 1): it trains,
    evaluates and writes whole tensors with ``1x1x1@fsdp`` in the
    manifest, its losses those of the singleGPU run from the same seed
    within 1e-5 (every parameter sharded over one rank is whole), and the
    group is gone afterwards."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.chdir(tmp_path)
    common = ["--synthetic", "16", "--image-size", str(W), str(H),
              "--model-widths", "8", "16", "-b", "4", "-v", "25",
              "--device", "cpu", "--num-workers", "0", "--dtype", "f32",
              "-e", "1"]
    assert run_cli(["-t", "FSDP", *common]) == 0
    assert not torch.distributed.is_initialized()
    assert run_cli(["-t", "singleGPU", *common]) == 0
    fsdp = checkpoint.load_native(str(tmp_path / "checkpoints" / "FSDP.pt"))
    single = checkpoint.load_native(
        str(tmp_path / "checkpoints" / "singleGPU.pt"))
    assert fsdp["manifest"]["topology"] == {
        "process_count": 1, "device_count": 1, "strategy": "FSDP",
        "mesh": {"data": 1}, "mesh_spec": "1x1x1@fsdp", "precision": "f32"}
    assert fsdp["manifest"]["world"] == 1
    for key, value in single["model"].items():
        assert fsdp["model"][key].shape == value.shape, key
    np.testing.assert_allclose(
        [row[2] for row in fsdp["records"]["train_rows"]],
        [row[2] for row in single["records"]["train_rows"]], rtol=1e-5)
