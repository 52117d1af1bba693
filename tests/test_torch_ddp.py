"""The port's ``-t DDP`` against the JAX package's, on the CPU at a small
size (widths (8, 16), 32 × 48 images, float32, ``-b 2`` per rank).

The port runs as two gloo ranks (``tests/torch_ddp_worker.py``, one
process each, torch only); the JAX reference is the JAX DDP strategy on a
2-device CPU mesh with ``batch_size`` the per-rank ``b``, fed step by step
the concatenation of the two ranks' batches. That is the math of a
2-process JAX DDP run: one loss over the global batch, its gradient
scaled by the per-process ``b``, the lr times the world size, BatchNorm
on global statistics. Under ``--kernels pallas`` the JAX kernel runs in
interpret mode; the port's ``--kernels cuda`` runs its kernels' plain
versions on the CPU. Weights cross with ``checkpoint.params_from_jax``;
inputs are numpy arrays made from seeds. Each tolerance is stated where
it is used.

The two ranks' scenarios run in one launch per module (the ``ranks``
fixture); every multi-process run is bounded by ``LAUNCH_TIMEOUT_S``."""

import logging
import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from distributedpytorch_tpu.config import TrainConfig as JaxTrainConfig
from distributedpytorch_tpu.data import (
    SyntheticSegmentationDataset as JaxSynthetic,
)
from distributedpytorch_tpu.data.loader import DataLoader as JaxLoader
from distributedpytorch_tpu.data.loader import ShardSpec as JaxShard
from distributedpytorch_tpu.data.loader import seeded_split as jax_split
from distributedpytorch_tpu.evaluate import evaluate as jax_evaluate
from distributedpytorch_tpu.models import create_model as jax_create_model
from distributedpytorch_tpu.ops.fused_loss import make_sharded_fused_loss
from distributedpytorch_tpu.ops.losses import bce_dice_loss as jax_loss
from distributedpytorch_tpu.ops.schedule import (
    ReduceLROnPlateau as JaxPlateau,
)
from distributedpytorch_tpu.parallel.strategy import (
    build_strategy as jax_build_strategy,
)
from distributedpytorch_tpu.train.steps import TrainState, create_train_state
from distributedpytorch_tpu_torch import cli
from distributedpytorch_tpu_torch.checkpoint import params_from_jax
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.data.loader import DataLoader, ShardSpec
from distributedpytorch_tpu_torch.dist import runtime
from distributedpytorch_tpu_torch.parallel import strategy as port_strategy
from torch_ddp_worker import LAUNCH_TIMEOUT_S, launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 32, 48
WIDTHS = (8, 16)
B = 2  # per rank
WORLD = 2
LR = 1e-4
ACCUM = 2  # --grad-accum of the accumulation case
# port kernel policy → the JAX policy it stands for
POLICIES = [("torch", "xla"), ("cuda", "pallas")]
ARCHS = ["unet", "milesial"]
# the trainer scenario: --synthetic 24 -v 25 -b 2 -e 1 → 6 val samples in
# 3 batches (one pair split over the ranks, one tail batch on both), 18
# train samples, 9 per rank, 4 steps with the ragged one dropped
EPOCH = dict(epochs=1, batch_size=B, val_percent=25.0, seed=42,
             image_size=(W, H), model_widths=WIDTHS, synthetic_samples=24,
             metric_every_steps=1, num_workers=0, s2d_levels=0, dtype="f32",
             learning_rate=LR)


def _batch(b, seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((b, H, W, 3), np.float32),
            "mask": (rng.random((b, H, W)) > 0.6).astype(np.int32)}


def _loss_inputs():
    rng = np.random.default_rng(7)
    preds = (rng.random((B * WORLD, H, W, 1), np.float32) * 0.98 + 0.01)
    target = rng.integers(0, 3, (B * WORLD, H, W, 1)).astype(np.float32)
    target[target == 2] = 255.0  # counts as background
    return preds, target


def _jax_ddp(arch, jax_policy, **kw):
    """The JAX DDP strategy on 2 CPU devices, its model and the seeded
    initial weights."""
    cfg = JaxTrainConfig(train_method="DDP", batch_size=B, dtype="f32",
                         kernels=jax_policy, model_arch=arch,
                         model_widths=WIDTHS, image_size=(W, H),
                         s2d_levels=0, learning_rate=LR, **kw)
    strategy = jax_build_strategy(cfg, devices=jax.devices()[:WORLD])
    model, init_fn = jax_create_model(cfg)
    params, model_state = init_fn(jax.random.key(0), (H, W))
    return cfg, strategy, model, params, model_state


def _to_port(params, model_state):
    return params_from_jax(
        jax.device_get(params),
        None if model_state is None else jax.device_get(model_state))


def _step_batches():
    return [_batch(B * WORLD, seed) for seed in (1, 2)]


def _jobs(tmp):
    jobs = {}
    preds, target = _loss_inputs()
    for policy, _ in POLICIES:
        jobs[f"loss-{policy}"] = {"kind": "loss", "fused": policy == "cuda",
                                  "preds": preds, "target": target}
    for arch in ARCHS:
        _cfg, _s, _m, params, model_state = _jax_ddp(arch, "xla")
        initial = _to_port(params, model_state)
        for policy, _ in POLICIES:
            config = dict(model_arch=arch, model_widths=WIDTHS, dtype="f32",
                          kernels=policy, batch_size=B, learning_rate=LR)
            jobs[f"steps-{arch}-{policy}"] = {
                "kind": "steps", "fused": policy == "cuda",
                "config": config, "initial": initial,
                "batches": _step_batches()}
            if arch == "unet":  # grad-accum refuses BatchNorm
                jobs[f"accum-{policy}"] = {
                    "kind": "accum", "fused": policy == "cuda",
                    "config": dict(config, grad_accum=ACCUM),
                    "initial": initial, "chunks": _step_batches()}
            if arch == "unet" and policy == "torch":
                jobs["steps-unet-bf16_params"] = {
                    "kind": "steps", "fused": False,
                    "config": dict(config, dtype="bf16_params"),
                    "initial": initial, "batches": _step_batches()[:1]}
            jobs[f"trainer-{arch}-{policy}"] = {
                "kind": "trainer", "initial": initial,
                "dir": str(tmp / f"trainer-{arch}-{policy}"),
                "config": dict(EPOCH, model_arch=arch, kernels=policy)}
    return jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every scenario's results on both ranks, from one 2-rank launch."""
    tmp = tmp_path_factory.mktemp("ddp")
    return launch(tmp / "job", _jobs(tmp))


def _max_err_rel_to_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    return float(np.abs(got - want).max()) / scale if scale else float(
        np.abs(got - want).max())


# -- runtime ---------------------------------------------------------------------


def test_runtime_maps_the_torchrun_env(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert runtime.torchrun_env() is None
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.2")
    monkeypatch.setenv("MASTER_PORT", "29400")
    info = runtime.torchrun_env()
    assert (info.process_id, info.num_processes, info.local_rank,
            info.coordinator) == (3, 4, 1, "10.0.0.2:29400")
    assert not info.is_main
    card = runtime.RuntimeInfo(0, 1, device=torch.device("cuda", 1))
    assert card.backend == "nccl"
    assert runtime.RuntimeInfo(0, 1).backend == "gloo"


def test_init_timeout_reads_its_variable(monkeypatch):
    monkeypatch.delenv("DPT_DIST_INIT_TIMEOUT_S", raising=False)
    assert runtime.init_timeout() is None
    monkeypatch.setenv("DPT_DIST_INIT_TIMEOUT_S", "7.5")
    assert runtime.init_timeout().total_seconds() == 7.5
    monkeypatch.setenv("DPT_DIST_INIT_TIMEOUT_S", "soon")
    assert runtime.init_timeout() is None


def test_a_local_rank_beyond_the_visible_cards_raises():
    assert runtime.card_of(1, 2) == torch.device("cuda", 1)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 has no card"):
        runtime.card_of(1, 1)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 0 has no card"):
        runtime.card_of(0, 0)
    if not torch.cuda.is_available():
        # the card is the default: without one, no rank has a device
        with pytest.raises(RuntimeError, match="--device cpu"):
            runtime.rank_device(None, 0)
    assert runtime.rank_device("cpu", 5) == torch.device("cpu")


def test_without_a_launcher_ddp_runs_as_world_one(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("DPT_DIST_INIT_TIMEOUT_S", "30")
    assert not torch.distributed.is_initialized()
    try:
        info = runtime.initialize_from_env("cpu")
        assert (info.process_id, info.num_processes, info.coordinator,
                info.device) == (0, 1, None, torch.device("cpu"))
        assert torch.distributed.get_world_size() == 1
        assert torch.distributed.get_backend() == "gloo"
        again = runtime.initialize_from_env("cpu")  # idempotent
        assert again == info
        strategy = port_strategy.build_strategy(TrainConfig(
            train_method="DDP", device="cpu"))
        assert (strategy.rank, strategy.world, strategy.is_main) == (0, 1,
                                                                     True)
    finally:
        runtime.shutdown()
    assert not torch.distributed.is_initialized()


# -- strategy --------------------------------------------------------------------


@pytest.mark.parametrize("scaling", [True, False])
def test_strategy_matches_the_jax_ddp(scaling):
    """Shards, global batch, lr and drop_last against the JAX strategy on
    a 2-device mesh (the per-process values a 2-process run has), and the
    single-device point against the JAX SingleDevice."""
    jcfg = JaxTrainConfig(train_method="DDP", batch_size=B,
                          ddp_lr_world_size_scaling=scaling)
    jddp = jax_build_strategy(jcfg, devices=jax.devices()[:WORLD])
    cfg = TrainConfig(train_method="DDP", batch_size=B, device="cpu",
                      ddp_lr_world_size_scaling=scaling)
    data = JaxSynthetic(length=11, newsize=(W, H), seed=0)
    for rank in range(WORLD):
        ddp = port_strategy.build_strategy(cfg, runtime.RuntimeInfo(
            rank, WORLD))
        assert ddp.name == jddp.name == "DDP"
        assert ddp.lr_for(LR) == jddp.lr_for(LR)
        assert ddp.drop_last_train is jddp.drop_last_train is True
        assert ddp.global_batch_size == B * jddp.mesh.shape["data"]
        assert ddp.data_shard() == ShardSpec(rank, WORLD)
        assert ddp.eval_shard() == ShardSpec(rank, WORLD)
        assert ddp.is_main == (rank == 0)
        assert ddp.topology() == {"strategy": "DDP", "world": WORLD}
        got = DataLoader(data, batch_size=B, shuffle=True, seed=42,
                         drop_last=ddp.drop_last_train,
                         shard=ddp.data_shard()).batch_slices(1)
        want = JaxLoader(data, batch_size=B, shuffle=True, seed=42,
                         drop_last=True,
                         shard=JaxShard(rank, WORLD)).batch_slices(1)
        assert [list(s) for s in got] == [list(s) for s in want]
    single = port_strategy.build_strategy(TrainConfig(device="cpu"))
    jsingle = jax_build_strategy(JaxTrainConfig(batch_size=B))
    assert single.name == jsingle.name == "singleGPU"
    assert single.lr_for(LR) == jsingle.lr_for(LR) == LR
    assert single.drop_last_train is jsingle.drop_last_train is False
    assert single.data_shard() == ShardSpec(0, 1)
    assert single.wrap_model(torch.nn.Linear(1, 1)).__class__ is (
        torch.nn.Linear)
    with pytest.raises(ValueError, match="raise --microbatches instead"):
        port_strategy.build_strategy(
            TrainConfig(train_method="2x2x2@fsdp", grad_accum=2))


# -- the sharded loss ------------------------------------------------------------


@pytest.mark.parametrize("policy", [p for p, _ in POLICIES])
def test_sharded_loss_matches_make_sharded_fused_loss(ranks, policy):
    """Each rank's statistics, summed over the ranks, then the loss:
    against the JAX per-shard fused loss with its psum on the 2-device
    mesh (Pallas in interpret mode) and against the plain loss over the
    global batch, within 1e-6 relative (float32 sums in other orders).
    Each rank's gradient is ``world ×`` the global loss's gradient on
    its rows (the all-reduce's backward sums the cotangent over ranks;
    DDP's averaging takes the factor out, dist/collectives.py): over
    ``world`` it is within 1e-6 of the largest of JAX's."""
    preds, target = _loss_inputs()
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    sharding = NamedSharding(mesh, P("data"))
    sharded = make_sharded_fused_loss(mesh, P("data"), ("data",))
    jp, jt = jax.device_put(preds, sharding), jax.device_put(target, sharding)
    refs = {
        "sharded": jax.value_and_grad(sharded)(jp, jt),
        "plain": jax.value_and_grad(jax_loss)(preds, target),
    }
    name = f"loss-{policy}"
    losses = [float(r[name]["loss"]) for r in ranks]
    assert losses[0] == losses[1]  # one loss, bitwise, on every rank
    grad = np.concatenate([r[name]["grad"].numpy() for r in ranks]) / WORLD
    for ref, (jloss, jgrad) in refs.items():
        np.testing.assert_allclose(losses[0], float(jloss), rtol=1e-6,
                                   err_msg=ref)
        assert _max_err_rel_to_max(grad, jgrad) <= 1e-6, ref


# -- train steps -----------------------------------------------------------------


def _jax_capture_tx():
    """An optax transformation that leaves the params and keeps the
    (scaled) gradients as its state."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jax.numpy.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jax.numpy.zeros_like, g),
                                     g),
    )


def _jax_steps(arch, jax_policy):
    """The JAX DDP's first-step gradients (before Adam), its losses over
    the two global batches and the state they leave."""
    cfg, strategy, model, params, model_state = _jax_ddp(arch, jax_policy)
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
    losses = []
    for batch in batches:
        state, loss = step(state, batch)
        losses.append(float(loss))
    return losses, grads, state, model_state


@pytest.mark.parametrize("policy,jax_policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_steps_match_the_jax_ddp(ranks, arch, policy, jax_policy):
    """Two steps from the same weights, each on the concatenation of the
    ranks' batches: the losses within 1e-5 relative; every weight
    gradient of the first step, as Adam receives it (``b ×`` the global
    loss's), within 1e-4 of its tensor's largest (float32 backward passes
    summing in other orders; a constant factor would pass Adam unseen,
    so it is caught here); milesial's running statistics within 1e-5 of
    their largest, and the weights after the two Adam steps within 1e-4
    of each tensor's largest. Both ranks' gradients, weights and buffers
    are bitwise equal."""
    jlosses, jgrads, jstate, _ = _jax_steps(arch, jax_policy)
    name = f"steps-{arch}-{policy}"
    r0, r1 = (r[name] for r in ranks)
    np.testing.assert_allclose(r0["losses"].numpy(), jlosses, rtol=1e-5)
    want = _to_port(jgrads, jstate.model_state)
    for pname, g in r0["grads"].items():
        assert _max_err_rel_to_max(g.numpy(), want[pname].numpy()) <= 1e-4, \
            pname
        assert torch.equal(g, r1["grads"][pname]), pname
    final = _to_port(jstate.params, jstate.model_state)
    for key, value in r0["state"].items():
        assert torch.equal(value, r1["state"][key]), key
        if key.endswith("num_batches_tracked"):
            assert int(value) == 2
            continue
        err = _max_err_rel_to_max(value.numpy(), final[key].numpy())
        assert err <= (1e-5 if "running" in key else 1e-4), (key, err)


def test_bf16_params_step_matches_the_jax_ddp(ranks):
    """One ``--dtype bf16_params`` step under DDP from the same f32
    weights against the JAX DDP's on the 2-device mesh (both seed the f32
    master from them and round the parameters). The port averages the
    bf16 gradients over the ranks in float32 (the JAX DDP's compiled
    gradient all-reduce is float32). The loss within 1e-3 relative and the
    masters by tests/test_torch_precision.py's bounds: within 1e-2 of each
    tensor's largest, and for the zero-initialized biases (largest under
    10·lr, their whole value Adam's first ±lr update) within 2·lr with at
    least 3 of 4 elements on JAX's side of zero. Both ranks' parameters
    and masters bitwise equal, the parameters their master rounded."""
    from distributedpytorch_tpu.ops.precision import get_policy

    cfg = JaxTrainConfig(train_method="DDP", batch_size=B,
                         dtype="bf16_params", kernels="xla",
                         model_widths=WIDTHS, image_size=(W, H),
                         s2d_levels=0, learning_rate=LR)
    strategy = jax_build_strategy(cfg, devices=jax.devices()[:WORLD])
    model, init_fn = jax_create_model(cfg)
    params, _ = init_fn(jax.random.key(0), (H, W))
    lr = strategy.lr_for(cfg.learning_rate)
    state, tx = create_train_state(params, lr, cfg.weight_decay,
                                   policy=get_policy(cfg))
    state = strategy.place_state(state)
    state, jloss = strategy.build_train_step(model, tx)(
        state, strategy.place_batch(_step_batches()[0]))
    r0, r1 = (r["steps-unet-bf16_params"] for r in ranks)
    np.testing.assert_allclose(float(r0["losses"][0]), float(jloss),
                               rtol=1e-3)
    want = _to_port(state.opt_state.master, None)
    names = [k for k in r0["state"] if k in want]
    assert len(names) == len(r0["master"])
    for name, m, m1 in zip(names, r0["master"], r1["master"]):
        p = r0["state"][name]
        assert p.dtype == torch.bfloat16 and m.dtype == torch.float32
        assert torch.equal(m, m1) and torch.equal(p, r1["state"][name])
        assert torch.equal(p, m.to(torch.bfloat16)), name
        ref, got = want[name].numpy(), m.numpy()
        largest = np.abs(ref).max()
        if largest >= 10 * lr:
            assert np.abs(got - ref).max() <= 1e-2 * largest, name
            continue
        assert np.abs(got - ref).max() <= 2 * lr * (1 + 1e-3), name
        assert np.mean(np.sign(got) == np.sign(ref)) >= 0.75, name


@pytest.mark.parametrize("policy,jax_policy", POLICIES)
def test_accum_step_matches_the_jax_ddp(ranks, policy, jax_policy):
    """``--grad-accum 2`` under DDP: each rank's two chunks, the
    statistics and then the gradients summed over the ranks, against the
    JAX DDP's accumulation step over the two global chunks. The loss
    within 1e-5 relative and every gradient within 1e-4 of its tensor's
    largest, as for one step."""
    cfg, strategy, model, params, _ = _jax_ddp("unet", jax_policy,
                                               grad_accum=ACCUM)
    step = strategy.build_accum_train_step(model, _jax_capture_tx())
    state = strategy.place_state(TrainState(
        params=params, opt_state=_jax_capture_tx().init(params),
        step=jax.numpy.zeros((), jax.numpy.int32)))
    chunks = _step_batches()
    stacked = {k: np.stack([c[k] for c in chunks]) for k in chunks[0]}
    state, jloss = step(state, strategy.place_stacked_batch(stacked))
    r0, r1 = (r[f"accum-{policy}"] for r in ranks)
    assert float(r0["loss"]) == float(r1["loss"])
    np.testing.assert_allclose(float(r0["loss"]), float(jloss), rtol=1e-5)
    want = _to_port(state.opt_state, None)
    for name, g in r0["grads"].items():
        assert _max_err_rel_to_max(g.numpy(), want[name].numpy()) <= 1e-4, \
            name
        assert torch.equal(g, r1["grads"][name]), name


# -- one epoch through the Trainer -----------------------------------------------


def _jax_epoch(arch, jax_policy):
    """The JAX DDP step over the global batches of one epoch as two
    ``ShardSpec(r, 2)`` loaders form them, JAX ``evaluate`` on the
    weights it leaves, and the plateau scheduler."""
    cfg, strategy, model, params, model_state = _jax_ddp(
        arch, jax_policy, **{k: v for k, v in EPOCH.items()
                             if k not in ("model_widths", "image_size",
                                          "s2d_levels", "dtype",
                                          "batch_size", "learning_rate")})
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


@pytest.mark.parametrize("policy,jax_policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_one_epoch_through_the_trainer_matches_the_jax_ddp(
        ranks, arch, policy, jax_policy):
    """``Trainer`` under ``-t DDP`` on two ranks, one epoch: 4 steps per
    rank and 3 val batches (one on each rank, the tail on both). The
    per-step losses, the sharded val loss and Dice and the plateau's lr
    against the JAX DDP step over the same global batches and JAX
    ``evaluate`` on the weights it leaves, within 1e-4 relative, as the
    single-device epoch tests (tests/test_torch_train.py): float32
    forwards summed in other orders, and Adam's first steps, which move a
    weight by about lr whatever its gradient's size. The val metrics, the
    losses, the lr and the weights are the same on both ranks, bitwise,
    and rank 0 alone wrote."""
    jlosses, (jval_loss, jval_dice), jlr, n_val = _jax_epoch(arch,
                                                             jax_policy)
    assert n_val == 3
    r0, r1 = (r[f"trainer-{arch}-{policy}"] for r in ranks)
    assert r0["result"]["steps"] == len(jlosses) == 4
    np.testing.assert_allclose(r0["losses"], jlosses, rtol=1e-4)
    np.testing.assert_allclose(r0["result"]["val_loss"], jval_loss,
                               rtol=1e-4)
    np.testing.assert_allclose(r0["result"]["val_dice"], jval_dice,
                               rtol=1e-4)
    np.testing.assert_allclose(r0["lr"], jlr, rtol=1e-6)
    assert r0["lr"] == 2 * LR
    for key in ("val_loss", "val_dice", "steps"):
        assert r0["result"][key] == r1["result"][key], key
    assert r0["losses"] == r1["losses"] and r0["lr"] == r1["lr"]
    for key, value in r0["state"].items():
        assert torch.equal(value, r1["state"][key]), key
    assert r0["wrote"] == ["checkpoints/DDP.pt", "checkpoints/DDP.pth",
                           "loss/DDP/train_loss.pkl", "loss/DDP/val_dice.pkl",
                           "loss/DDP/val_loss.pkl"]
    assert r1["wrote"] == []


# -- the CLI ---------------------------------------------------------------------


def _run(argv, cwd, timeout=LAUNCH_TIMEOUT_S):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(key, None)
    return subprocess.run([sys.executable, *argv], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_cli_trains_under_torchrun_and_resumes_at_another_world(tmp_path):
    """``torchrun --standalone --nproc_per_node 2 -m
    distributedpytorch_tpu_torch -t DDP --device cpu``: exits 0, writes
    the DDP artifacts once, with the world size in the manifest; ``-c
    DDP`` then resumes at world 1 for a second epoch. Both ranks log to
    the one log file."""
    common = ["-m", "distributedpytorch_tpu_torch", "-t", "DDP",
              "--synthetic", "16", "--image-size", str(W), str(H),
              "--model-widths", *map(str, WIDTHS), "-b", str(B), "-v", "25",
              "--device", "cpu", "--num-workers", "0", "--dtype", "f32"]
    out = _run(["-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", str(WORLD), *common, "-e", "1"],
               tmp_path)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    wrote = sorted(os.path.relpath(os.path.join(d, f), tmp_path)
                   for d, _, files in os.walk(tmp_path) for f in files)
    assert wrote == ["checkpoints/DDP.pt", "checkpoints/DDP.pth",
                     "logs/DDP.log", "loss/DDP/train_loss.pkl",
                     "loss/DDP/val_dice.pkl", "loss/DDP/val_loss.pkl"]
    payload = torch.load(tmp_path / "checkpoints" / "DDP.pt",
                         weights_only=True)
    assert payload["manifest"]["world"] == WORLD
    assert payload["manifest"]["strategy"] == "DDP"
    # 12 train samples, 6 per rank: 3 steps of the global batch of 4
    assert (payload["epoch"], payload["step"]) == (1, 3)
    log = (tmp_path / "logs" / "DDP.log").read_text()
    assert "(rank 0 of 2)" in log and "(rank 1 of 2)" in log
    # the lr of world 2, restored with the scheduler
    assert payload["scheduler"]["lr"] == pytest.approx(2 * LR)

    again = _run([*common, "-e", "2", "-c", "DDP"], tmp_path)
    assert again.returncode == 0, again.stdout[-3000:] + again.stderr[-3000:]
    payload = torch.load(tmp_path / "checkpoints" / "DDP.pt",
                         weights_only=True)
    assert payload["manifest"]["world"] == 1
    # world 1: 12 samples in 6 steps of 2
    assert (payload["epoch"], payload["step"]) == (2, 9)
    log = (tmp_path / "logs" / "DDP.log").read_text()
    assert "Resumed from" in log and "(rank 0 of 1)" in log


def test_cli_still_refuses_dp_and_mp_and_a_missing_card(monkeypatch):
    """What a pipeline refuses, ``--grad-accum`` under in-stage sharding,
    exits in the JAX pipeline's words (``-t DP``, ``-t MP``, ``-t DDP_MP``,
    ``-t SP``, ``-t DDP_SP``, ``-t TP``, ``-t FSDP``, the flat specs,
    in-stage sharding and ZeRO over row shards train now:
    tests/test_torch_dp.py, tests/test_torch_pipeline.py,
    tests/test_torch_ddp_mp.py, tests/test_torch_spatial.py,
    tests/test_torch_ddp_sp.py, tests/test_torch_tp.py,
    tests/test_torch_fsdp.py, tests/test_torch_mesh.py,
    tests/test_torch_in_stage.py, tests/test_torch_zero_spatial.py, and
    their run control, tests/test_torch_in_stage_run_control.py among
    them); ``-t DDP`` without a card exits naming ``--device cpu``."""
    for method in ("2x2x2@fsdp", "4x2x2@fsdp"):
        with pytest.raises(SystemExit, match="raise --microbatches instead"):
            cli.main(["-t", method, "--device", "cpu", "--grad-accum", "2"])
    if not torch.cuda.is_available():
        root = logging.getLogger()
        before = list(root.handlers)
        try:
            with pytest.raises(SystemExit, match="--device cpu"):
                cli.main(["-t", "DDP", "--synthetic", "4"])
        finally:
            for handler in set(root.handlers) - set(before):
                root.removeHandler(handler)
        assert not torch.distributed.is_initialized()
