"""The port's ``-t DDP_MP`` against the JAX package's, on the CPU at a small
size (widths (8, 16), 32 × 48 images, float32, ``-b 4`` per rank, S = 2
stages, M = 2 microbatches).

The port runs as two gloo ranks (``tests/torch_ddp_worker.py``, one
process and one thread each, torch only), each rank's two stages on the
CPU; the JAX reference is the JAX DDP_MP strategy on a ``{data: 2, stage:
2}`` CPU mesh (``jax.devices()[:4]``, one process) with ``batch_size``
the per-rank ``b``, fed step by step the concatenation of the two ranks'
batches. That is the math of a 2-process JAX DDP_MP run: one loss over
the global batch, its gradient scaled by the per-process ``b`` and summed
over ('stage', 'data'), the lr times the data degree, and milesial's
BatchNorm on each data shard's microbatch moments, its running averages'
deltas averaged over 'data'. Under ``--kernels pallas`` the JAX kernels
run in interpret mode; the port's ``--kernels cuda`` runs its kernels'
plain versions on the CPU. Weights cross with
``checkpoint.params_from_jax``; inputs are numpy arrays made from seeds.
Each tolerance is stated where it is used.

Every scenario of the two ranks runs in one launch per module (the
``ranks`` fixture), bounded by ``LAUNCH_TIMEOUT_S``."""

import functools
import itertools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
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
from distributedpytorch_tpu.ops.optim import adam_l2
from distributedpytorch_tpu.ops.schedule import (
    ReduceLROnPlateau as JaxPlateau,
)
from distributedpytorch_tpu.parallel.strategy import (
    build_strategy as jax_build_strategy,
)
from distributedpytorch_tpu.train.steps import TrainState, create_train_state
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.data.loader import DataLoader, ShardSpec
from distributedpytorch_tpu_torch.dist import runtime
from distributedpytorch_tpu_torch.parallel import strategy as port_strategy
from torch_ddp_worker import LAUNCH_TIMEOUT_S, launch
from torch_parallel_parity import (
    capture_then,
    max_err_rel_to_max,
    run_cli,
    to_port,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 32, 48
WIDTHS = (8, 16)
B = 4  # per rank: M = 2 microbatches of 2
S = 2
M = 2
WORLD = 2
LR = 1e-4
POLICIES = ["torch", "cuda"]
ARCHS = ["unet", "milesial"]
SCHEDULES = ["gpipe", "1f1b"]
PIPELINE = dict(num_stages=S, num_microbatches=M)
# the trainer scenario: --synthetic 48 -v 25 -b 4 -e 1 → 12 val samples in
# 3 batches (one pair split over the ranks, one tail batch on both), 36
# train samples, 18 per rank, 4 steps with the ragged one dropped
EPOCH = dict(epochs=1, batch_size=B, val_percent=25.0, seed=42,
             image_size=(W, H), model_widths=WIDTHS, synthetic_samples=48,
             metric_every_steps=1, num_workers=0, s2d_levels=0, dtype="f32",
             learning_rate=LR, **PIPELINE)
# the epochs run: every model and schedule under --kernels torch, and one
# schedule of each model under --kernels cuda
EPOCHS = ([(arch, schedule, "torch") for arch in ARCHS
           for schedule in SCHEDULES]
          + [("unet", "gpipe", "cuda"), ("milesial", "1f1b", "cuda")])
SMALL = ["--image-size", str(W), str(H), "--model-widths",
         *map(str, WIDTHS), "-b", str(B), "--device", "cpu",
         "--num-workers", "0", "--dtype", "f32", "--stages", str(S),
         "--microbatches", str(M)]
CLI = ["--synthetic", "24", "-v", "25", *SMALL]


def _batch(b, seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((b, H, W, 3), np.float32),
            "mask": (rng.random((b, H, W)) > 0.6).astype(np.int32)}


def _step_batches():
    return [_batch(B * WORLD, seed) for seed in (1, 2)]


def _jax_config(arch, jax_policy="xla", schedule="gpipe", **kw):
    return JaxTrainConfig(
        **{**dict(train_method="DDP_MP", batch_size=B, dtype="f32",
                  kernels=jax_policy, model_arch=arch, model_widths=WIDTHS,
                  image_size=(W, H), s2d_levels=0, learning_rate=LR,
                  pipeline_schedule=schedule, **PIPELINE), **kw})


def _jax_policy(arch, policy):
    """The JAX kernel policy the port's stands for: ``xla`` for ``torch``;
    for ``cuda`` ``pallas`` (its kernels in interpret mode), but for
    milesial ``xla``: under DDP_MP the JAX BatchNorm epilogue leaves the
    function that its XLA path, and its own MP and singleGPU epilogue,
    compute (``test_the_jax_epilogue_under_ddp_mp_leaves_its_function``),
    and the port's epilogue computes that function."""
    if policy == "torch" or arch == "milesial":
        return "xla"
    return "pallas"


def _jax_strategy(cfg):
    return jax_build_strategy(cfg, devices=jax.devices()[:WORLD * S])


@functools.cache
def _jax_weights(arch):
    """The seeded initial weights (the init runs under ``jit``: op by op
    it compiles every op of the forward apart)."""
    _model, init_fn = jax_create_model(_jax_config(arch))
    return jax.jit(lambda key: init_fn(key, (H, W)))(jax.random.key(0))


def _jobs(tmp):
    jobs = {}
    for arch in ARCHS:
        initial = to_port(*_jax_weights(arch))
        for policy in POLICIES:
            for schedule in SCHEDULES:
                jobs[f"steps-{arch}-{schedule}-{policy}"] = {
                    "kind": "pipeline_steps", "initial": initial,
                    "batches": _step_batches(),
                    "config": dict(model_arch=arch, model_widths=WIDTHS,
                                   dtype="f32", kernels=policy,
                                   batch_size=B, learning_rate=LR,
                                   pipeline_schedule=schedule, **PIPELINE)}
    for arch, schedule, policy in EPOCHS:
        name = f"trainer-{arch}-{schedule}-{policy}"
        jobs[name] = {
            "kind": "trainer", "method": "DDP_MP",
            "initial": to_port(*_jax_weights(arch)), "dir": str(tmp / name),
            "config": dict(EPOCH, model_arch=arch, kernels=policy,
                           pipeline_schedule=schedule)}
    # an -t MP checkpoint (made by the fixture) resumed under DDP_MP for
    # a second epoch
    jobs["resume-mp"] = {
        "kind": "trainer", "method": "DDP_MP", "initial": None,
        "dir": str(tmp / "resume-mp"),
        "config": dict(EPOCH, epochs=2, model_arch="milesial",
                       pipeline_schedule="1f1b",
                       checkpoint_name=str(tmp / "mp" / "checkpoints"
                                           / "MP.pt"))}
    return jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every scenario's results on both ranks, from one 2-rank launch,
    after a one-epoch ``-t MP`` run of milesial in this process whose
    checkpoint the ranks resume."""
    tmp = tmp_path_factory.mktemp("ddp_mp")
    cwd = os.getcwd()
    os.makedirs(tmp / "mp")
    os.chdir(tmp / "mp")
    try:
        assert run_cli(["-t", "MP", "--model", "milesial", "-e", "1",
                        "--synthetic", str(EPOCH["synthetic_samples"]),
                        "-v", str(EPOCH["val_percent"]), *SMALL]) == 0
    finally:
        os.chdir(cwd)
    return launch(tmp / "job", _jobs(tmp))


# -- runtime and strategy -----------------------------------------------------


def test_a_rank_drives_its_own_s_cards(monkeypatch):
    """``cuda:(LOCAL_RANK·S + s)`` for each stage; a node with fewer than
    ``nproc_per_node × S`` cards raises naming the launch that fits, as a
    LOCAL_RANK beyond the cards does under DDP; ``--device cpu`` and a
    card named by its index put every stage there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = torch.device
    assert runtime.stage_devices(None, 0, 2) == [cuda("cuda", 0),
                                                 cuda("cuda", 1)]
    assert runtime.stage_devices("cuda", 1, 2) == [cuda("cuda", 2),
                                                   cuda("cuda", 3)]
    assert runtime.stage_devices("cuda", 3, 1) == [cuda("cuda", 3)]
    with pytest.raises(RuntimeError, match=r"LOCAL_RANK 2 has no cards "
                                           r"cuda:4\.\.5: 4 visible.*"
                                           r"--nproc_per_node 2"):
        runtime.stage_devices("cuda", 2, 2)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 has no cards"):
        runtime.stage_devices("cuda", 1, 3)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 4 has no card:"):
        runtime.stage_devices("cuda", 4, 1)
    assert runtime.stage_devices("cuda:1", 1, 2) == [cuda("cuda", 1)] * 2
    assert runtime.stage_devices("cpu", 1, 3) == [cuda("cpu")] * 3
    assert runtime.rank_device("cuda", 2) == cuda("cuda", 2)


@pytest.mark.parametrize("scaling", [True, False])
def test_strategy_matches_the_jax_ddp_mp(scaling):
    """Shards, global batch, lr, drop_last and the manifest's topology
    against the JAX DDP_MP on a ``{data: 2, stage: 2}`` mesh (the
    per-process values a 2-process run has); every stage on the CPU;
    ``--grad-accum`` refused as under MP."""
    jcfg = _jax_config("unet", ddp_lr_world_size_scaling=scaling)
    jstrategy = _jax_strategy(jcfg)
    assert dict(jstrategy.mesh.shape) == {"data": WORLD, "stage": S}
    cfg = TrainConfig(train_method="DDP_MP", batch_size=B, device="cpu",
                      ddp_lr_world_size_scaling=scaling, **PIPELINE)
    data = JaxSynthetic(length=19, newsize=(W, H), seed=0)
    for rank in range(WORLD):
        ddp_mp = port_strategy.build_strategy(cfg, runtime.RuntimeInfo(
            rank, WORLD))
        assert ddp_mp.name == jstrategy.name == "DDP_MP"
        assert ddp_mp.lr_for(LR) == jstrategy.lr_for(LR)
        assert ddp_mp.drop_last_train is True
        assert jstrategy.mesh_config.drop_last is True
        assert ddp_mp.global_batch_size == B * jstrategy.mesh.shape["data"]
        assert ddp_mp.data_shard() == ShardSpec(rank, WORLD)
        assert ddp_mp.eval_shard() == ShardSpec(rank, WORLD)
        assert ddp_mp.is_main == (rank == 0)
        assert ddp_mp.devices == [torch.device("cpu")] * S
        assert ddp_mp.topology() == {"strategy": "DDP_MP", "world": WORLD,
                                     "stages": S, "microbatches": M,
                                     "schedule": "gpipe"}
        got = DataLoader(data, batch_size=B, shuffle=True, seed=42,
                         drop_last=ddp_mp.drop_last_train,
                         shard=ddp_mp.data_shard()).batch_slices(1)
        want = JaxLoader(data, batch_size=B, shuffle=True, seed=42,
                         drop_last=True,
                         shard=JaxShard(rank, WORLD)).batch_slices(1)
        assert [list(s) for s in got] == [list(s) for s in want]
    with pytest.raises(ValueError, match="raise --microbatches instead of "
                                         "--grad-accum"):
        ddp_mp.build_accum_train_step(None, None, None)


@pytest.mark.parametrize("batch_size,microbatches,world,match", [
    (5, 2, 2, "must be a multiple of num_microbatches"),
    (2, 2, 2, "degenerates to plain MP"),
    (4, 4, 2, "degenerates to plain MP"),
])
def test_the_jax_errors_for_the_same_configurations(batch_size,
                                                    microbatches, world,
                                                    match):
    """``b % M`` and a data degree below 2 raise the JAX message, word for
    word, for the configuration the JAX strategy refuses over the same
    world × S devices."""
    jcfg = _jax_config("unet", batch_size=batch_size,
                       num_microbatches=microbatches)
    with pytest.raises(ValueError, match=match) as want:
        jax_build_strategy(jcfg, devices=jax.devices()[:world * S])
    cfg = TrainConfig(train_method="DDP_MP", batch_size=batch_size,
                      device="cpu", num_stages=S,
                      num_microbatches=microbatches)
    with pytest.raises(ValueError) as got:
        port_strategy.build_strategy(cfg, runtime.RuntimeInfo(0, world))
    assert str(got.value) == str(want.value)


def test_too_few_devices_and_a_shrunk_data_degree_raise(monkeypatch):
    """Fewer than 2S devices: the JAX strategy raises on 3 devices at S = 2;
    the port's rank 1 of 2 finds no cards 2..3 on a 3-card node (its
    runtime). A batch that leaves the
    JAX formula a data degree below the world size (b = 4, M = 2 over 4
    processes: dp = 2) raises in the port, where every process is one
    data row."""
    with pytest.raises(ValueError, match="needs at least 4 devices, got 3"):
        jax_build_strategy(_jax_config("unet"), devices=jax.devices()[:3])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 has no cards"):
        runtime.stage_devices("cuda", 1, S)
    monkeypatch.undo()
    jstrategy = jax_build_strategy(_jax_config("unet"),
                                   devices=jax.devices()[:8])
    assert jstrategy.mesh.shape["data"] == 2  # 4 processes' devices: dp 2
    with pytest.raises(ValueError, match="data degree of 2, not the 4"):
        port_strategy.build_strategy(
            TrainConfig(train_method="DDP_MP", batch_size=B, device="cpu",
                        **PIPELINE), runtime.RuntimeInfo(0, 4))


def test_without_a_launcher_ddp_mp_degenerates_to_plain_mp(monkeypatch):
    """No torchrun env: world 1, as the port's DDP (the JAX DDP_MP would
    take every local device instead), and so no data axis: the JAX
    "degenerates to plain MP" error, before any group is joined."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="degenerates to plain MP"):
        port_strategy.build_strategy(TrainConfig(
            train_method="DDP_MP", device="cpu", batch_size=8, **PIPELINE))
    assert not torch.distributed.is_initialized()


# -- train steps --------------------------------------------------------------


@functools.cache
def _jax_steps(arch, schedule, jax_policy):
    """The JAX DDP_MP's two Adam steps from the seeded weights over the two
    global batches: its losses, the first step's gradients as Adam
    received them and the state after each step, under port names."""
    cfg = _jax_config(arch, jax_policy, schedule)
    strategy = _jax_strategy(cfg)
    model, _init = jax_create_model(cfg)
    params, model_state = _jax_weights(arch)
    tx = capture_then(adam_l2(strategy.lr_for(LR), cfg.weight_decay))
    state = strategy.place_state(TrainState(
        params=params, opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32), model_state=model_state))
    step = strategy.build_train_step(model, tx)
    losses, grads, states = [], [], []
    for batch in _step_batches():
        state, loss = step(state, strategy.place_batch(batch))
        losses.append(float(loss))
        grads.append(to_port(state.opt_state[0], model_state))
        states.append(to_port(state.params, state.model_state))
    return losses, grads[0], states


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("arch", ARCHS)
def test_steps_match_the_jax_ddp_mp(ranks, arch, schedule, policy):
    """Two steps from the same weights, each on the concatenation of the
    ranks' batches: the losses within 1e-5 relative; every weight
    gradient of the first step, as Adam receives it (``b ×`` the global
    loss's, summed over the stages and the data ranks: a factor of the
    world size would pass Adam unseen, so it is caught here), within 1e-4
    of its tensor's largest (float32 backward passes summing in other
    orders); milesial's running statistics after each step within 1e-5 of
    their largest (each rank's microbatch moments, the deltas averaged
    over the ranks); the weights after the first Adam step within 1e-5
    relative, with an absolute floor of 1e-2 × the lr (Adam's first update
    is lr·g/(|g| + 1e-8): where g is within a few 1e-7 of zero a float32
    rounding of g is a visible part of lr; 3.9e-3 × lr at worst in the
    first runs of these cases, at a milesial conv weight whose gradient
    reads 2.74e-7 here and 3.09e-7 in JAX, both within 3e-6 of the
    tensor's largest), and after the
    second within 1e-4 of each tensor's largest, as tests/test_torch_ddp.py
    holds two DDP steps. Both ranks' gradients, weights and buffers are
    bitwise equal, and BatchNorm stays off DDP's global moments. The JAX
    policy is ``_jax_policy``'s."""
    jax_policy = _jax_policy(arch, policy)
    jlosses, jgrads, jstates = _jax_steps(arch, schedule, jax_policy)
    r0, r1 = (r[f"steps-{arch}-{schedule}-{policy}"] for r in ranks)
    np.testing.assert_allclose(r0["losses"].numpy(), jlosses, rtol=1e-5)
    assert torch.equal(r0["losses"], r1["losses"])
    assert r0["devices"] == ["cpu"] * S
    assert r0["global_stats"] == ([False] if arch == "milesial" else [])
    for name, g in r0["grads"].items():
        err = max_err_rel_to_max(g.numpy(), jgrads[name].numpy())
        assert err <= 1e-4, (name, err)
        assert torch.equal(g, r1["grads"][name]), name
    lr = WORLD * LR
    for i, (got, want) in enumerate(zip(r0["states"], jstates)):
        for key, value in got.items():
            assert torch.equal(value, r1["states"][i][key]), key
            if key.endswith("num_batches_tracked"):
                # the running averages move once per microbatch
                assert int(value) == (i + 1) * M, key
                continue
            ref = want[key].numpy()
            if "running" in key or i:
                err = max_err_rel_to_max(value.numpy(), ref)
                assert err <= (1e-5 if "running" in key else 1e-4), (
                    i, key, err)
            else:
                np.testing.assert_allclose(value.numpy(), ref, rtol=1e-5,
                                           atol=1e-2 * lr, err_msg=key)


def test_the_jax_epilogue_under_ddp_mp_leaves_its_function(ranks):
    """A difference of the reference, found by this port: the JAX DDP_MP
    under ``--kernels pallas`` (milesial's BatchNorm + ReLU through the
    epilogue kernel, in interpret mode on the CPU) gives one step's loss
    within 1e-5 of its XLA path's but weight gradients more than 1e-3 of
    a tensor's largest off them, where the port's epilogue (``--kernels
    cuda``, its plain versions here) stays within 1e-4 of the XLA path's
    under both schedules, as the port's plain BatchNorm does."""
    xla_loss, xla_grads, _ = _jax_steps("milesial", "gpipe", "xla")
    pallas_loss, pallas_grads, _ = _jax_steps("milesial", "gpipe", "pallas")
    np.testing.assert_allclose(pallas_loss[0], xla_loss[0], rtol=1e-5)
    params = ranks[0]["steps-milesial-gpipe-torch"]["grads"]

    def err(grads):
        return max(max_err_rel_to_max(grads[n].numpy(), xla_grads[n].numpy())
                   for n in params)

    assert err(pallas_grads) > 1e-3
    for schedule in SCHEDULES:
        for policy in POLICIES:
            got = ranks[0][f"steps-milesial-{schedule}-{policy}"]["grads"]
            assert err(got) <= 1e-4, (schedule, policy)


# -- one epoch through the Trainer --------------------------------------------


def _jax_epoch(arch, schedule, jax_policy):
    """The JAX DDP_MP step over the global batches of one epoch as two
    ``ShardSpec(r, 2)`` loaders form them, JAX ``evaluate`` through the
    pipelined eval on the weights it leaves, and the plateau scheduler."""
    cfg = _jax_config(arch, jax_policy, schedule, epochs=1,
                      val_percent=EPOCH["val_percent"], seed=EPOCH["seed"])
    strategy = _jax_strategy(cfg)
    model, _init = jax_create_model(cfg)
    params, model_state = _jax_weights(arch)
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


@pytest.mark.parametrize("arch,schedule,policy", EPOCHS)
def test_one_epoch_through_the_trainer_matches_the_jax_ddp_mp(
        ranks, arch, schedule, policy):
    """``Trainer`` under ``-t DDP_MP`` on two ranks of two CPU stages, one
    epoch: 4 steps per rank and 3 val batches through the sharded
    pipelined eval (one on each rank, the tail on both). The per-step
    losses, the val loss and Dice and the plateau's lr against the JAX
    DDP_MP step over the same global batches and JAX ``evaluate`` on the
    weights it leaves, within 1e-4 relative, as the single-device epoch
    tests (tests/test_torch_train.py), but for milesial's val Dice, within
    5e-3: its predictions after one epoch from random weights lie within
    0.11 of the 0.5 threshold, dozens of val pixels within 1e-4 of it, so
    the float32 differences the four steps leave in the weights flip a few
    pixels of the hard Dice (1.1e-3 in the first runs of these cases,
    where the val loss agrees within 1e-6). The val metrics, the losses,
    the lr and the weights are the same on both ranks, bitwise; rank 0
    alone wrote, and its manifest records the pipeline and the world."""
    jlosses, (jval_loss, jval_dice), jlr, n_val = _jax_epoch(
        arch, schedule, _jax_policy(arch, policy))
    assert n_val == 3
    r0, r1 = (r[f"trainer-{arch}-{schedule}-{policy}"] for r in ranks)
    assert r0["result"]["steps"] == len(jlosses) == 4
    np.testing.assert_allclose(r0["losses"], jlosses, rtol=1e-4)
    np.testing.assert_allclose(r0["result"]["val_loss"], jval_loss,
                               rtol=1e-4)
    np.testing.assert_allclose(r0["result"]["val_dice"], jval_dice,
                               rtol=5e-3 if arch == "milesial" else 1e-4)
    np.testing.assert_allclose(r0["lr"], jlr, rtol=1e-6)
    assert r0["lr"] == WORLD * LR
    for key in ("val_loss", "val_dice", "steps"):
        assert r0["result"][key] == r1["result"][key], key
    assert r0["losses"] == r1["losses"] and r0["lr"] == r1["lr"]
    for key, value in r0["state"].items():
        assert torch.equal(value, r1["state"][key]), key
    assert r0["wrote"] == [
        "checkpoints/DDP_MP.pt", "checkpoints/DDP_MP.pth",
        "loss/DDP_MP/train_loss.pkl", "loss/DDP_MP/val_dice.pkl",
        "loss/DDP_MP/val_loss.pkl"]
    assert r1["wrote"] == []
    assert r0["manifest"]["strategy"] == "DDP_MP"
    assert {k: r0["manifest"][k] for k in ("world", "stages", "microbatches",
                                           "schedule")} == {
        "world": WORLD, "stages": S, "microbatches": M, "schedule": schedule}


def test_an_mp_checkpoint_resumes_under_ddp_mp(ranks):
    """``-c`` naming milesial's ``-t MP`` checkpoint: both ranks restore it
    (the step count, and the scheduler's lr of the MP run, not scaled
    again) and train its second epoch under DDP_MP, their weights equal
    bitwise at the end."""
    r0, r1 = (r["resume-mp"] for r in ranks)
    mp = r0["resumed_from"]
    assert mp["manifest"]["strategy"] == "MP" and mp["epoch"] == 1
    assert r0["result"]["steps"] == mp["step"] + 4
    assert r0["lr"] == r1["lr"] == mp["scheduler"]["lr"] == LR
    for key, value in r0["state"].items():
        assert torch.equal(value, r1["state"][key]), key
    assert r0["manifest"]["strategy"] == "DDP_MP"


# -- the CLI ------------------------------------------------------------------


def test_cli_trains_under_torchrun_and_resumes_under_another_method(
        tmp_path):
    """``torchrun --standalone --nproc_per_node 2 -m
    distributedpytorch_tpu_torch -t DDP_MP --stages 2 --microbatches 2
    --device cpu`` (milesial, 1f1b): exits 0 and writes the DDP_MP
    artifacts once, the manifest recording the world and the pipeline;
    ``-c DDP_MP`` then resumes under ``-t MP`` for a second epoch in this
    process. Both ranks log to the one log file."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(key, None)
    model = ["--model", "milesial", "--pipeline-schedule", "1f1b"]
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(WORLD), "-m", "distributedpytorch_tpu_torch",
         "-t", "DDP_MP", "-e", "1", *model, *CLI],
        cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=LAUNCH_TIMEOUT_S)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    wrote = sorted(os.path.relpath(os.path.join(d, f), tmp_path)
                   for d, _, files in os.walk(tmp_path) for f in files)
    assert wrote == ["checkpoints/DDP_MP.pt", "checkpoints/DDP_MP.pth",
                     "logs/DDP_MP.log", "loss/DDP_MP/train_loss.pkl",
                     "loss/DDP_MP/val_dice.pkl", "loss/DDP_MP/val_loss.pkl"]
    payload = torch.load(tmp_path / "checkpoints" / "DDP_MP.pt",
                         weights_only=True)
    assert {k: payload["manifest"][k] for k in (
        "strategy", "world", "stages", "microbatches", "schedule")} == {
        "strategy": "DDP_MP", "world": WORLD, "stages": S,
        "microbatches": M, "schedule": "1f1b"}
    # 18 train samples, 9 per rank: 2 steps of the global batch of 8
    assert (payload["epoch"], payload["step"]) == (1, 2)
    assert payload["scheduler"]["lr"] == pytest.approx(WORLD * LR)
    log = (tmp_path / "logs" / "DDP_MP.log").read_text()
    assert "(rank 0 of 2)" in log and "(rank 1 of 2)" in log

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert run_cli(["-t", "MP", "-c", "DDP_MP", "-e", "2", *model,
                        *CLI]) == 0
    finally:
        os.chdir(cwd)
    again = torch.load(tmp_path / "checkpoints" / "MP.pt", weights_only=True)
    assert again["manifest"]["strategy"] == "MP"
    assert set(again["model"]) == set(payload["model"])
    # one process: 18 samples in 4 steps of 4, the ragged batch kept
    assert (again["epoch"], again["step"]) == (2, 2 + 5)
    assert "Resumed from" in (tmp_path / "logs" / "MP.log").read_text()


def test_cli_refuses_ddp_mp_without_a_data_axis(monkeypatch):
    """Without a launcher ``-t DDP_MP`` is world 1 and exits with the JAX
    "degenerates to plain MP" error, leaving no group behind. Nothing is
    left to port among the ``-t`` names: over D, M, S ∈ {1, 2} and every
    option set, ``check_train_method`` takes each spec the JAX package's
    ``parse_mesh_spec`` takes, except a spatial model axis inside a
    pipeline stage (``DxMxS@sp``, S > 1), which the JAX package's
    strategy refuses too; it refuses every spec JAX's grammar refuses."""
    from distributedpytorch_tpu.parallel import mesh as jax_mesh

    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="degenerates to plain MP"):
        run_cli(["-t", "DDP_MP", "-e", "1", *CLI])
    assert not torch.distributed.is_initialized()
    assert "DDP_MP" in port_strategy.STRATEGIES
    assert not hasattr(port_strategy, "unported_method_message")
    opts = ["", "@tp", "@sp", "@fsdp", "@fsdp+tp", "@sp+fsdp", "@sp+tp",
            "@fsdp+sp+tp"]
    trained = refused = 0
    for d, m, s, opt in itertools.product((1, 2), (1, 2), (1, 2), opts):
        spec = f"{d}x{m}x{s}{opt}"
        try:
            cfg = jax_mesh.parse_mesh_spec(spec)
        except ValueError:
            with pytest.raises(ValueError):
                port_strategy.check_train_method(spec)
            continue
        if s > 1 and cfg.model > 1 and cfg.model_role == "spatial":
            refused += 1
            with pytest.raises(ValueError, match="not executable"):
                port_strategy.check_train_method(spec)
            with pytest.raises(ValueError, match="not executable"):
                jax_build_strategy(JaxTrainConfig(train_method=spec),
                                   devices=jax.devices()[:d * m * s])
            continue
        trained += 1
        port_strategy.check_train_method(spec)
    assert (trained, refused) == (36, 4)
