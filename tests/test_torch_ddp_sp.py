"""The port's ``-t DDP_SP`` against the JAX package's, on the CPU at a small
size (widths (8, 16), 32 × 16 images, float32, ``-b 4`` per rank, two row
shards per rank).

The port runs as two gloo ranks (``tests/torch_ddp_worker.py``, torch
only), each row-sharding its batch over ``[cpu, cpu]``; the JAX reference
is the JAX DDP_SP strategy on a ``{data: 2, spatial: 2}`` CPU mesh
(``jax.devices()[:4]``, one process) with ``batch_size`` the per-rank
``b``, fed step by step the concatenation of the two ranks' batches, as
``tests/test_torch_ddp_mp.py`` holds DDP_MP: one loss over the global
batch, its gradient scaled by the per-process ``b`` and summed over
('data', 'spatial'), the lr times the data degree, and milesial's
BatchNorm on the global batch's moments. Weights cross with
``checkpoint.params_from_jax``; inputs are numpy arrays made from seeds.

Every scenario of the two ranks runs in one launch (the ``ranks``
fixture), bounded by ``LAUNCH_TIMEOUT_S``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.config import TrainConfig as JaxTrainConfig
from distributedpytorch_tpu.models import create_model as jax_create_model
from distributedpytorch_tpu.ops.optim import adam_l2
from distributedpytorch_tpu.parallel import mesh as jax_mesh
from distributedpytorch_tpu.parallel.strategy import (
    build_strategy as jax_build_strategy,
)
from distributedpytorch_tpu.train.steps import TrainState
from distributedpytorch_tpu_torch import checkpoint
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.data.loader import ShardSpec
from distributedpytorch_tpu_torch.dist import runtime
from distributedpytorch_tpu_torch.parallel import strategy as port_strategy
from test_torch_graph_strategies import (
    _assert_masters_match,
    _jax_bf16_config,
    _jax_bf16_params_step,
    _small_batch,
)
from torch_ddp_worker import launch
from torch_parallel_parity import (
    capture_then,
    max_err_rel_to_max,
    run_cli,
    to_port,
)

H, W = 32, 16
WIDTHS = (8, 16)
B = 4  # per rank
WORLD = 2
SHARDS = 2
LR = 1e-4
POLICIES = ["torch", "cuda"]
ARCHS = ["unet", "milesial"]
# the bf16_params steps: tests/test_torch_graph_strategies.py's 16 × 24
# images and its JAX step helpers
SH, SW = 16, 24
CLI = ["--synthetic", "24", "-v", "34", "--image-size", str(W), str(H),
       "--model-widths", *map(str, WIDTHS), "-b", str(B), "--device", "cpu",
       "--num-workers", "0", "--dtype", "f32"]
# the trainer scenario: --synthetic 24 -v 34 -b 4 → 8 val samples in 2
# batches (one per rank), 16 train samples, 8 per rank, 2 steps
EPOCH = dict(epochs=1, batch_size=B, val_percent=34.0, seed=42,
             image_size=(W, H), model_widths=WIDTHS, synthetic_samples=24,
             metric_every_steps=1, num_workers=0, s2d_levels=0, dtype="f32",
             learning_rate=LR)


def _batch(b, seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((b, h, w, 3), np.float32),
            "mask": (rng.random((b, h, w)) > 0.6).astype(np.int32)}


def _step_batches():
    return [_batch(B * WORLD, seed) for seed in (1, 2)]


def _jax_config(arch, **kw):
    return JaxTrainConfig(**{**dict(
        train_method="DDP_SP", batch_size=B, dtype="f32", kernels="xla",
        model_arch=arch, model_widths=WIDTHS, image_size=(W, H),
        s2d_levels=0, learning_rate=LR), **kw})


def _jax_strategy(cfg):
    return jax_build_strategy(cfg, devices=jax.devices()[:WORLD * SHARDS])


@functools.cache
def _jax_weights(arch):
    _model, init_fn = jax_create_model(_jax_config(arch))
    return jax.jit(lambda key: init_fn(key, (H, W)))(jax.random.key(0))


def _jobs(tmp):
    jobs = {}
    for arch in ARCHS:
        initial = to_port(*_jax_weights(arch))
        for policy in POLICIES:
            jobs[f"steps-{arch}-{policy}"] = {
                "kind": "pipeline_steps", "method": "DDP_SP",
                "initial": initial, "batches": _step_batches(),
                "config": dict(model_arch=arch, model_widths=WIDTHS,
                               dtype="f32", kernels=policy, batch_size=B,
                               image_size=(W, H), learning_rate=LR)}
    _losses, initial, _want = _jax_bf16_steps()
    jobs["steps-bf16_params"] = {
        "kind": "pipeline_steps", "method": "DDP_SP", "initial": initial,
        "batches": [_small_batch(B * WORLD, 1)],
        "config": dict(model_widths=WIDTHS, dtype="bf16_params",
                       kernels="torch", batch_size=B, image_size=(SW, SH),
                       learning_rate=LR)}
    jobs["trainer"] = {
        "kind": "trainer", "method": "DDP_SP",
        "initial": to_port(*_jax_weights("milesial")),
        "dir": str(tmp / "trainer"),
        "config": dict(EPOCH, model_arch="milesial", kernels="cuda")}
    return jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every scenario's results on both ranks, from one 2-rank launch."""
    tmp = tmp_path_factory.mktemp("ddp_sp")
    return launch(tmp / "job", _jobs(tmp))


# -- the strategy against the JAX DDP_SP -------------------------------------------


@pytest.mark.parametrize("scaling", [True, False])
def test_strategy_matches_the_jax_ddp_sp(scaling):
    """The mesh, the global batch, the lr, drop_last, the shards and the
    manifest's topology against the JAX DDP_SP on a ``{data: 2, spatial:
    2}`` mesh (the per-process values a 2-process run has); every row
    shard on the CPU; ``--grad-accum`` sums over the ranks as DDP's does,
    and milesial's is refused with the JAX words."""
    jstrategy = _jax_strategy(_jax_config(
        "unet", ddp_lr_world_size_scaling=scaling))
    assert dict(jstrategy.mesh.shape) == {"data": WORLD, "spatial": SHARDS}
    cfg = TrainConfig(train_method="DDP_SP", batch_size=B, device="cpu",
                      image_size=(W, H), model_widths=WIDTHS,
                      ddp_lr_world_size_scaling=scaling)
    for rank in range(WORLD):
        ddp_sp = port_strategy.build_strategy(cfg, runtime.RuntimeInfo(
            rank, WORLD))
        assert ddp_sp.name == jstrategy.name == "DDP_SP"
        assert ddp_sp.mesh_shape() == dict(jstrategy.mesh.shape)
        assert ddp_sp.lr_for(LR) == jstrategy.lr_for(LR)
        assert ddp_sp.drop_last_train is jstrategy.mesh_config.drop_last
        assert ddp_sp.global_batch_size == B * jstrategy.mesh.shape["data"]
        assert ddp_sp.data_shard() == ddp_sp.eval_shard() == ShardSpec(
            rank, WORLD)
        assert ddp_sp.is_main == (rank == 0)
        assert ddp_sp.devices == [torch.device("cpu")] * SHARDS
        topology = checkpoint.jax_topology(ddp_sp.name,
                                           ddp_sp.mesh_shape(), "f32")
        assert topology["mesh_spec"] == jax_mesh.canonical_spec(
            jstrategy.mesh_config) == "2x2x1@sp"
        assert topology["process_count"] == WORLD
        assert topology["device_count"] == WORLD * SHARDS
    assert ddp_sp.sum_over_ranks is port_strategy.sum_over_ranks_
    with pytest.raises(ValueError, match="stateless models only"):
        port_strategy.build_strategy(TrainConfig(
            train_method="DDP_SP", batch_size=B, device="cpu",
            image_size=(W, H), model_widths=WIDTHS, model_arch="milesial",
            grad_accum=2), runtime.RuntimeInfo(0, WORLD))


@pytest.mark.parametrize("batch_size,world,widths,want", [
    (1, 2, WIDTHS, None),  # b 1 over 4 devices: no data axis >= 2
    (4, 2, WIDTHS, 2),
    (4, 4, None, 2),  # 4 levels at H = 32: data 4 x spatial 2
])
def test_the_jax_rule_over_the_same_devices(batch_size, world, widths,
                                            want):
    """The spatial degree, and the JAX "degenerates to plain SP" error word
    for word, for the configuration the JAX DDP_SP meets over the same
    world × 2 devices. The third case is JAX's
    ``test_spatial_with_reference_depth_model`` geometry."""
    jcfg = _jax_config("unet", batch_size=batch_size, model_widths=widths)
    cfg = TrainConfig(train_method="DDP_SP", batch_size=batch_size,
                      device="cpu", image_size=(W, H), model_widths=widths)
    devices = jax.devices()[:world * SHARDS]
    if want is None:
        with pytest.raises(ValueError, match="degenerates to plain SP") as j:
            jax_build_strategy(jcfg, devices=devices)
        with pytest.raises(ValueError) as got:
            port_strategy.check_spatial_data_degree(cfg, world, SHARDS)
        assert str(got.value) == str(j.value)
        return
    jstrategy = jax_build_strategy(jcfg, devices=devices)
    assert port_strategy.check_spatial_data_degree(cfg, world, SHARDS) == want
    assert dict(jstrategy.mesh.shape) == {"data": world, "spatial": want}


def test_one_process_has_no_data_axis():
    """A deliberate difference: the JAX DDP_SP of one process over 2
    devices finds data 2 × spatial 1 (every local device), where a port
    process is one data row, so world 1 degenerates to plain SP."""
    jstrategy = jax_build_strategy(_jax_config("unet"),
                                   devices=jax.devices()[:SHARDS])
    assert dict(jstrategy.mesh.shape) == {"data": 2}
    cfg = TrainConfig(train_method="DDP_SP", batch_size=B, device="cpu",
                      image_size=(W, H), model_widths=WIDTHS)
    with pytest.raises(ValueError, match="degenerates to plain SP: batch_"
                                         "size 4 leaves no data axis ≥ 2 "
                                         "over 2 devices"):
        port_strategy.check_spatial_data_degree(cfg, 1, SHARDS)


def test_a_shrunk_data_degree_raises():
    """A batch that leaves the JAX formula a data degree below the world
    size (b = 4 over 4 processes of 2 devices at 8 deep rows: spatial 4,
    data 2) raises in the port, where every process is one data row."""
    jstrategy = jax_build_strategy(_jax_config("unet"),
                                   devices=jax.devices()[:8])
    assert dict(jstrategy.mesh.shape) == {"data": 2, "spatial": 4}
    with pytest.raises(ValueError, match="data degree of 2, not the 4"):
        port_strategy.build_strategy(
            TrainConfig(train_method="DDP_SP", batch_size=B, device="cpu",
                        image_size=(W, H), model_widths=WIDTHS),
            runtime.RuntimeInfo(0, 4))


def test_a_rank_shards_over_its_share_of_the_cards(monkeypatch):
    """``-t DDP_SP`` takes the node's cards over its processes
    (``LOCAL_WORLD_SIZE``), ``cuda:(LOCAL_RANK·n + s)``; the CPU or a card
    named by its index gives two shards of that device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert port_strategy.rank_shards("cuda") == 2
    assert runtime.stage_devices("cuda", 1, 2) == [torch.device("cuda", 2),
                                                   torch.device("cuda", 3)]
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert port_strategy.rank_shards(None) == 4
    assert port_strategy.rank_shards("cuda:1") == SHARDS
    assert port_strategy.rank_shards("cpu") == SHARDS


def test_without_a_launcher_ddp_sp_degenerates_to_plain_sp(monkeypatch):
    """No torchrun env: world 1, and so no data axis: the JAX "degenerates
    to plain SP" error, from the strategy and from the CLI, before any
    group is joined."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="degenerates to plain SP"):
        port_strategy.build_strategy(TrainConfig(
            train_method="DDP_SP", device="cpu", image_size=(W, H),
            model_widths=WIDTHS))
    with pytest.raises(ValueError, match="degenerates to plain SP"):
        run_cli(["-t", "DDP_SP", "-e", "1", *CLI])
    assert not torch.distributed.is_initialized()


# -- train steps ---------------------------------------------------------------


@functools.cache
def _jax_steps(arch):
    """The JAX DDP_SP's two Adam steps from the seeded weights over the two
    global batches: its losses, the first step's gradients as Adam
    received them and the state after each step, under port names."""
    cfg = _jax_config(arch)
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


@functools.cache
def _jax_bf16_steps():
    return _jax_bf16_params_step(
        _jax_bf16_config(train_method="DDP_SP", batch_size=B),
        jax.devices()[:WORLD * SHARDS], [_small_batch(B * WORLD, 1)])


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_steps_match_the_jax_ddp_sp(ranks, arch, policy):
    """Two steps from the same weights, each on the concatenation of the
    ranks' batches: the losses within 1e-5 relative; every weight gradient
    of the first step, as Adam receives it (``b ×`` the global loss's:
    each rank's is ``world ×`` its share, which the ranks' mean takes
    out; a factor of the world size either way fails here), within 1e-4
    of its tensor's largest; milesial's running statistics after each step
    within 1e-5 of their largest (the global batch's moments); the weights
    after the first Adam step within 1e-5 relative with an absolute floor
    of 1e-2 × lr, and after the second within 1e-4 of each tensor's
    largest, as tests/test_torch_ddp_mp.py holds DDP_MP. Both ranks'
    losses, gradients, weights and buffers are bitwise equal after every
    step."""
    jlosses, jgrads, jstates = _jax_steps(arch)
    r0, r1 = (r[f"steps-{arch}-{policy}"] for r in ranks)
    np.testing.assert_allclose(r0["losses"].numpy(), jlosses, rtol=1e-5)
    assert torch.equal(r0["losses"], r1["losses"])
    assert r0["devices"] == ["cpu"] * SHARDS
    assert r0["mesh"] == {"data": WORLD, "spatial": SHARDS}
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
                assert int(value) == i + 1, key
                continue
            ref = want[key].numpy()
            if "running" in key or i:
                err = max_err_rel_to_max(value.numpy(), ref)
                assert err <= (1e-5 if "running" in key else 1e-4), (
                    i, key, err)
            else:
                np.testing.assert_allclose(value.numpy(), ref, rtol=1e-5,
                                           atol=1e-2 * lr, err_msg=key)


def test_bf16_params_steps_match_the_jax_ddp_sp(ranks):
    """One UNet step under bf16_params (16 × 24 images): the ranks' loss
    within 1e-3 of the JAX DDP_SP's, the f32 masters as
    ``test_torch_graph_strategies._assert_masters_match`` holds them (the
    ranks' mean of the f32 master gradients, after the shards added in
    f32), bitwise equal on both ranks, every parameter its master
    rounded."""
    losses, _initial, want = _jax_bf16_steps()
    r0, r1 = (r["steps-bf16_params"] for r in ranks)
    np.testing.assert_allclose(float(r0["losses"][0]), losses[0], rtol=1e-3)
    names = list(r0["grads"])
    assert len(names) == len(r0["master"])
    for name, m0, m1 in zip(names, r0["master"], r1["master"]):
        assert torch.equal(m0, m1), name
        assert torch.equal(r0["states"][-1][name],
                           m0.to(torch.bfloat16)), name
        _assert_masters_match(m0, want[name], WORLD * LR)


def test_the_trainer_writes_the_ddp_sp_artifacts(ranks):
    """``Trainer`` under ``-t DDP_SP`` on two ranks, milesial with
    ``--kernels cuda`` (plain versions here), one epoch: the same losses
    and val metrics on both ranks, the weights bitwise equal, and rank 0
    alone writes the checkpoint, the ``.pth`` and the loss tables, with a
    manifest that names the strategy, the mesh and ``2x2x1@sp``."""
    r0, r1 = (r["trainer"] for r in ranks)
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 2
    for key in ("val_loss", "val_dice", "steps"):
        assert r0["result"][key] == r1["result"][key], key
    assert np.isfinite(r0["result"]["val_loss"])
    for key, value in r0["state"].items():
        assert torch.equal(value, r1["state"][key]), key
    assert "checkpoints/DDP_SP.pth" in r0["wrote"]
    assert not [f for f in r1["wrote"] if f.startswith("checkpoints")]
    topology = r0["manifest"]["topology"]
    assert topology == {"process_count": WORLD, "device_count": 4,
                        "strategy": "DDP_SP",
                        "mesh": {"data": WORLD, "spatial": SHARDS},
                        "mesh_spec": "2x2x1@sp", "precision": "f32"}
    assert r0["lr"] == WORLD * LR
    assert r0["ddp"]["built"] == 0
    # the ranks import torch and the port only
    assert ranks[0]["leaked"] == ranks[1]["leaked"] == []
