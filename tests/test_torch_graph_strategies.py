"""``--steps-per-dispatch K`` under ``-t DDP``, ``-t MP`` and ``-t DDP_MP``,
and the f32 sum of a parameter's uses under ``--dtype bf16_params``, on
the CPU at a small size (widths (8, 16), float32 unless marked).

* **The uses of a parameter under master weights.** gpipe runs one
  backward over every microbatch and DP's replicas share their
  parameters, so a bf16 parameter collects several uses' gradients in one
  backward. The JAX steps differentiate an f32 view of the parameters,
  so the uses add in f32 (parallel/pipeline.py:699-707); the port casts
  the f32 master once per use (``ops/precision.PerUseCasts``). The probe
  rebuilds each use's bf16 gradient and holds the master gradient to
  their f32 sum, bit for bit, on inputs where their bf16 sum differs.
  The steps are held against the JAX package's under ``bf16_params``.
* **K steps per dispatch.** On the CPU ``MultiStep`` runs K plain steps
  of the trainer's own train step, so an epoch at K = 2 whose tail is
  shorter than K equals the epoch at K = 1 bit for bit, and the JAX
  trainer (or the JAX strategy's multi-step) at K = 2 within the epoch
  bound. Under DDP the graph and the tail drive one
  ``DistributedDataParallel``.
* **Adam's param groups**, one per run of parameters on one device, each
  with its lr, and a checkpoint of other groups loading into them.

The DDP and DDP_MP scenarios run as two gloo ranks in one launch
(``tests/torch_ddp_worker.py``); the JAX references are the JAX
strategies on the CPU mesh, fed the concatenation of the ranks' batches.
Weights cross with ``checkpoint.params_from_jax``; inputs are numpy
arrays made from seeds. Each tolerance is stated where it is used."""

import copy

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
from distributedpytorch_tpu.ops.precision import get_policy as jax_policy
from distributedpytorch_tpu.ops.precision import with_master_weights
from distributedpytorch_tpu.parallel.strategy import (
    build_strategy as jax_build_strategy,
)
from distributedpytorch_tpu.train import Trainer as JaxTrainer
from distributedpytorch_tpu.train.steps import TrainState, create_train_state
from distributedpytorch_tpu_torch.checkpoint import params_from_jax
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.models import create_model
from distributedpytorch_tpu_torch.ops.fused_loss import stats_function
from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
from distributedpytorch_tpu_torch.ops.losses import (
    bce_dice_loss,
    loss_from_stats,
)
from distributedpytorch_tpu_torch.ops.optim import (
    device_runs,
    load_optimizer_state,
    make_optimizer,
    set_learning_rate,
)
from distributedpytorch_tpu_torch.ops.precision import POLICIES, cast_params_
from distributedpytorch_tpu_torch.parallel.strategy import build_strategy
from distributedpytorch_tpu_torch.train.loop import Trainer
from distributedpytorch_tpu_torch.train.steps import prep_mask
from torch_ddp_worker import launch
from torch_parallel_parity import (
    capture_then,
    make_batch,
    run_cli,
    to_port,
    torch_batch,
)

CPU = torch.device("cpu")
BF16P = POLICIES["bf16_params"]
WIDTHS = (8, 16)
LR = 1e-4
WORLD = 2
# the steps of the bf16_params cases: torch_parallel_parity's 16 × 24
# images, batch 8 (DP, MP) or 4 per rank (DDP_MP)
SH, SW = 16, 24
# the K = 2 epochs: 32 × 48 images, -v 25
H, W = 32, 48
K = 2
GPIPE = dict(train_method="MP", num_stages=2, num_microbatches=2,
             pipeline_schedule="gpipe")
# --synthetic 26 -b 4: 20 train samples, 5 steps, two stacks of 2 and a
# tail of one; 6 val samples, one val batch
MP_EPOCH = dict(epochs=1, batch_size=4, val_percent=25.0, seed=42,
                image_size=(W, H), model_widths=WIDTHS, synthetic_samples=26,
                metric_every_steps=1, num_workers=0, s2d_levels=0,
                dtype="f32", num_stages=2, num_microbatches=2,
                train_method="MP")
# DDP, --synthetic 26 -b 2 per rank: 20 train samples, 10 per rank, 5
# steps (two stacks and a tail of one); 6 val samples in 3 batches
DDP_EPOCH = dict(epochs=1, batch_size=2, val_percent=25.0, seed=42,
                 image_size=(W, H), model_widths=WIDTHS, synthetic_samples=26,
                 metric_every_steps=1, num_workers=0, s2d_levels=0,
                 dtype="f32", learning_rate=LR)
# DDP_MP, --synthetic 30 -b 4 per rank (M = 2): 23 train samples, 3 steps
# per rank (one stack and a tail of one); 7 val samples in one batch
DDP_MP_EPOCH = dict(DDP_EPOCH, batch_size=4, synthetic_samples=30,
                    num_stages=2, num_microbatches=2,
                    pipeline_schedule="gpipe")


def _port_bf16_params(method, initial, devices, **kw):
    """The port's step under bf16_params from the f32 ``initial`` (the
    master seeded from it, then the parameters rounded, as the trainer
    does), and the f32 master gradients its first Adam step reads."""
    cfg = TrainConfig(dtype="bf16_params", kernels="torch", device="cpu",
                      model_widths=WIDTHS, image_size=(SW, SH),
                      learning_rate=LR, batch_size=8, train_method=method,
                      **kw)
    strategy = build_strategy(cfg, devices=devices)
    model = create_model(cfg, cast_params=False)
    model.load_state_dict(initial)
    model = strategy.place_model(model)
    opt = make_optimizer(model.parameters(), LR, cfg.weight_decay,
                         policy=BF16P)
    cast_params_(model, BF16P)
    grads = []

    def keep(_opt, _args, _kwargs):
        if not grads:
            grads.extend(m.grad.clone() for m in opt.master)

    opt.register_step_pre_hook(keep)
    step = strategy.build_train_step(model, opt, get_kernel_policy("torch"))
    return model, opt, grads, step


def _seeded_f32():
    cfg = TrainConfig(model_widths=WIDTHS, dtype="f32", device="cpu")
    return create_model(cfg, generator=torch.Generator().manual_seed(0)
                        ).state_dict()


# -- the uses of a parameter under bf16_params ---------------------------------


def _per_use_addends(model, opt, batch, uses, method):
    """Each use's bf16 gradient of every parameter, rebuilt outside the
    port's step: the model run once per use (a row slice of the batch)
    with its own bf16 cast of an f32 copy of the masters, each cast's
    gradient recorded. The loss is the step's: under gpipe the
    microbatches' statistics summed, then ``loss_from_stats``; under DP
    the loss of the gathered predictions."""
    names = [n for n, _ in model.named_parameters()]
    leaves = [m.detach().clone().requires_grad_(True) for m in opt.master]
    addends = {n: [] for n in names}
    images = batch["image"]
    target = prep_mask(batch["mask"])
    outs = []
    for rows in uses:
        casts = {}
        for n, leaf in zip(names, leaves):
            c = leaf.to(torch.bfloat16)
            c.register_hook(lambda g, n=n: addends[n].append(g.clone()))
            casts[n] = c
        outs.append(torch.func.functional_call(model, casts,
                                               (images[rows],)))
    if method == "MP":
        stats_fn = stats_function(False)
        stats = stats_fn(outs[0], target[uses[0]])
        for y, rows in zip(outs[1:], uses[1:]):
            stats = stats + stats_fn(y, target[rows])
        loss = loss_from_stats(stats)
    else:
        loss = bce_dice_loss(torch.cat(outs), target)
    loss.backward()
    return names, addends


@pytest.mark.parametrize("method", ["MP", "DP"])
def test_uses_of_a_parameter_add_in_f32_under_bf16_params(method):
    """gpipe (S = 2, M = 2) and DP (two replicas) on ``[cpu, cpu]`` under
    bf16_params: the f32 master gradient Adam reads is the batch size
    times the f32 sum of the two uses' bf16 gradients, bit for bit (two
    addends add in either order alike; the factor is a power of two).
    Their bf16 sum differs from it in most tensors on these inputs, so a
    step that adds the uses in bf16 and widens the sum fails here."""
    kw = dict(GPIPE) if method == "MP" else {}
    kw.pop("train_method", None)
    model, opt, grads, step = _port_bf16_params(method, _seeded_f32(),
                                                [CPU, CPU], **kw)
    batch = torch_batch(make_batch())
    uses = [slice(0, 4), slice(4, 8)]
    names, addends = _per_use_addends(model, opt, batch, uses, method)
    step(batch)
    differs = 0
    for name, g in zip(names, grads):
        a, b = addends[name]
        want = (a.float() + b.float()) * 8
        assert torch.equal(g, want), name
        differs += not torch.equal((a + b).float() * 8, want)
    assert differs >= len(names) // 2, differs


def _assert_masters_match(got, want, lr):
    """tests/test_torch_precision.py's bounds for one bf16_params step
    against JAX: a random-init bf16 step moves its own gradients by far
    more than summation order does (ROADMAP trap 3; here up to half of a
    tensor's largest gradient, median 3e-3), so the masters after Adam
    are held within 1e-2 of each tensor's largest, and the
    zero-initialized biases (largest under 10·lr, their whole value
    Adam's first ±lr update) within 2·lr with at least 3 of 4 elements on
    JAX's side of zero."""
    ref = want.numpy()
    largest = np.abs(ref).max()
    if largest >= 10 * lr:
        assert np.abs(got.numpy() - ref).max() <= 1e-2 * largest
        return
    assert np.abs(got.numpy() - ref).max() <= 2 * lr * (1 + 1e-3)
    assert np.mean(np.sign(got.numpy()) == np.sign(ref)) >= 0.75


def _jax_bf16_params_step(jcfg, devices, batches):
    """The JAX strategy's steps under bf16_params from its seeded f32
    weights: the losses, the f32 initial weights and the masters after
    the last step, under port names."""
    strategy = jax_build_strategy(jcfg, devices=devices)
    model, init_fn = jax_create_model(jcfg)
    params, model_state = jax.jit(lambda k: init_fn(k, (SH, SW)))(
        jax.random.key(0))
    tx = with_master_weights(capture_then(adam_l2(
        strategy.lr_for(jcfg.learning_rate), jcfg.weight_decay)))
    state = strategy.place_state(TrainState(
        params=jax_policy(jcfg).cast_params(params),
        opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
        model_state=model_state))
    step = strategy.build_train_step(model, tx)
    losses = []
    for batch in batches:
        state, loss = step(state, strategy.place_batch(batch))
        losses.append(float(loss))
    return (losses, to_port(params, model_state),
            to_port(state.opt_state.master, None))


def _jax_bf16_config(**kw):
    return JaxTrainConfig(**{**dict(
        dtype="bf16_params", kernels="xla", model_widths=WIDTHS,
        image_size=(SW, SH), s2d_levels=0, learning_rate=LR, batch_size=8),
        **kw})


@pytest.mark.parametrize("method", ["MP", "DP"])
def test_bf16_params_step_matches_the_jax_step(method):
    """One bf16_params step of the UNet under ``-t MP`` gpipe (S = 2,
    M = 2) and ``-t DP`` on ``[cpu, cpu]`` against the JAX strategy's on
    two CPU devices: the loss within 1e-3 relative, the masters by
    ``_assert_masters_match``, and every parameter its master rounded."""
    kw = dict(GPIPE) if method == "MP" else dict(train_method="DP")
    losses, initial, want = _jax_bf16_params_step(
        _jax_bf16_config(**kw), jax.devices()[:2], [make_batch()])
    kw.pop("train_method")
    model, opt, _grads, step = _port_bf16_params(method, initial,
                                                 [CPU, CPU], **kw)
    loss = step(torch_batch(make_batch()))
    np.testing.assert_allclose(float(loss), losses[0], rtol=1e-3)
    for (name, p), m in zip(model.named_parameters(), opt.master):
        assert torch.equal(p.detach(), m.detach().to(torch.bfloat16)), name
        _assert_masters_match(m.detach(), want[name], LR)


# -- two gloo ranks: DDP_MP under bf16_params, K = 2 under DDP and DDP_MP ---------


def _small_batch(b, seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((b, SH, SW, 3), np.float32),
            "mask": (rng.random((b, SH, SW)) > 0.6).astype(np.int32)}


@pytest.fixture(scope="module")
def jax_initial():
    """The JAX trainer's seeded UNet weights at the epochs' size, under
    port names (JAX's UNet init is the same at any image size)."""
    cfg = JaxTrainConfig(model_widths=WIDTHS, image_size=(W, H),
                         s2d_levels=0, dtype="f32")
    _model, init_fn = jax_create_model(cfg)
    params, _state = jax.jit(lambda k: init_fn(k, (H, W)))(jax.random.key(0))
    return params, to_port(params, None)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_initial):
    """Every two-rank scenario's results, from one launch: one DDP_MP
    gpipe step under bf16_params, and each K = 2 epoch beside its K = 1
    twin."""
    tmp = tmp_path_factory.mktemp("graph_strategies")
    _params, initial = jax_initial
    jobs = {"ddp_mp-bf16_params": {
        "kind": "pipeline_steps", "initial": _bf16_ddp_mp_initial(),
        "batches": [_small_batch(4 * WORLD, 1)],
        "config": dict(model_widths=WIDTHS, dtype="bf16_params",
                       kernels="torch", batch_size=4, learning_rate=LR,
                       image_size=(SW, SH), pipeline_schedule="gpipe",
                       num_stages=2, num_microbatches=2)}}
    for method, epoch in (("DDP", DDP_EPOCH), ("DDP_MP", DDP_MP_EPOCH)):
        for k in (K, 1):
            name = f"{method}-k{k}"
            jobs[name] = {"kind": "trainer", "method": method,
                          "initial": initial, "dir": str(tmp / name),
                          "config": dict(epoch, steps_per_dispatch=k)}
    return launch(tmp / "job", jobs)


def _jax_ddp_mp_bf16_config():
    return _jax_bf16_config(train_method="DDP_MP", batch_size=4,
                            pipeline_schedule="gpipe", num_stages=2,
                            num_microbatches=2)


def _bf16_ddp_mp_initial():
    model, init_fn = jax_create_model(_jax_ddp_mp_bf16_config())
    params, _ = jax.jit(lambda k: init_fn(k, (SH, SW)))(jax.random.key(0))
    return to_port(params, None)


def test_ddp_mp_bf16_params_step_matches_the_jax_ddp_mp(ranks):
    """One bf16_params gpipe step of ``-t DDP_MP`` on two gloo ranks of two
    CPU stages against the JAX DDP_MP on a ``{data: 2, stage: 2}`` mesh:
    the loss within 1e-3 relative, the masters by
    ``_assert_masters_match`` at the lr times the world size, both ranks'
    masters and parameters bitwise equal, the parameters their master
    rounded."""
    losses, _initial, want = _jax_bf16_params_step(
        _jax_ddp_mp_bf16_config(), jax.devices()[:WORLD * 2],
        [_small_batch(4 * WORLD, 1)])
    r0, r1 = (r["ddp_mp-bf16_params"] for r in ranks)
    np.testing.assert_allclose(float(r0["losses"][0]), losses[0], rtol=1e-3)
    state = r0["states"][-1]
    names = [k for k in state if k in want]
    assert len(names) == len(r0["master"])
    for name, m, m1 in zip(names, r0["master"], r1["master"]):
        assert torch.equal(m, m1)
        assert torch.equal(state[name], r1["states"][-1][name])
        assert torch.equal(state[name], m.to(torch.bfloat16)), name
        _assert_masters_match(m, want[name], WORLD * LR)


def _stacked_epoch(strategy, model, tx, state, global_batches):
    """The JAX strategy's epoch at K = 2: the full batches in stacks of K
    through its multi-step, the rest one by one, as the trainers group
    them; the losses and the state."""
    single = strategy.build_train_step(model, tx)
    multi = strategy.build_multi_train_step(model, tx)
    losses = []
    full = len(global_batches) // K * K
    for i in range(0, full, K):
        stacked = {key: np.stack([b[key] for b in global_batches[i:i + K]])
                   for key in global_batches[0]}
        state, out = multi(state, strategy.place_stacked_batch(stacked))
        losses.extend(float(x) for x in np.asarray(out))
    for batch in global_batches[full:]:
        state, loss = single(state, strategy.place_batch(batch))
        losses.append(float(loss))
    return losses, state


def _jax_ranks_epoch(method, epoch, params):
    """The JAX ``method`` strategy at K = 2 over the global batches of one
    epoch as two ``ShardSpec(r, 2)`` loaders form them, JAX ``evaluate``
    on the weights it leaves."""
    extra = ({k: epoch[k] for k in ("num_stages", "num_microbatches",
                                    "pipeline_schedule")}
             if method == "DDP_MP" else {})
    cfg = JaxTrainConfig(train_method=method, batch_size=epoch["batch_size"],
                         dtype="f32", kernels="xla", model_widths=WIDTHS,
                         image_size=(W, H), s2d_levels=0, learning_rate=LR,
                         steps_per_dispatch=K, seed=epoch["seed"],
                         val_percent=epoch["val_percent"], **extra)
    devices = jax.devices()[:WORLD * (2 if method == "DDP_MP" else 1)]
    strategy = jax_build_strategy(cfg, devices=devices)
    model, _init = jax_create_model(cfg)
    data = JaxSynthetic(length=epoch["synthetic_samples"], newsize=(W, H),
                        seed=epoch["seed"])
    train_idx, val_idx = jax_split(len(data), cfg.val_fraction, seed=0)
    b = epoch["batch_size"]
    loaders = [JaxLoader(data, indices=train_idx, batch_size=b, shuffle=True,
                         drop_last=True, seed=epoch["seed"],
                         shard=JaxShard(rank, WORLD))
               for rank in range(WORLD)]
    state, tx = create_train_state(params, strategy.lr_for(LR),
                                   cfg.weight_decay, policy=strategy.policy)
    global_batches = [
        {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        for parts in zip(*(loader.epoch_batches(0) for loader in loaders))]
    losses, state = _stacked_epoch(strategy, model, tx,
                                   strategy.place_state(state),
                                   global_batches)
    val_loader = JaxLoader(data, indices=val_idx, batch_size=b,
                           shuffle=False, drop_last=True)
    val = jax_evaluate(strategy.build_eval_step(model), state.params,
                       val_loader, strategy.place_batch)
    return losses, val


@pytest.mark.parametrize("method", ["DDP", "DDP_MP"])
def test_k2_epoch_equals_k1_and_matches_the_jax_strategy(ranks, jax_initial,
                                                         method):
    """``Trainer`` at ``--steps-per-dispatch 2`` on two gloo ranks (DDP:
    5 steps per rank, DDP_MP gpipe: 3): the per-step losses and the final
    weights bitwise equal to the same epoch at K = 1 and across the
    ranks; the losses and the val metrics within 1e-4 relative of the JAX
    strategy's multi-step at K = 2 over the same global batches (the
    epoch bound of PERF.md §2: float32 forwards summed in other orders
    and Adam's first steps)."""
    epoch = DDP_EPOCH if method == "DDP" else DDP_MP_EPOCH
    r0, r1 = (r[f"{method}-k{K}"] for r in ranks)
    one = ranks[0][f"{method}-k1"]
    steps = 5 if method == "DDP" else 3
    assert r0["result"]["steps"] == one["result"]["steps"] == steps
    assert r0["losses"] == one["losses"] == r1["losses"]
    for key, value in r0["state"].items():
        assert torch.equal(value, one["state"][key]), key
        assert torch.equal(value, r1["state"][key]), key
    assert r0["same_step"] and not one["same_step"]
    params, _initial = jax_initial
    jlosses, (jval_loss, jval_dice) = _jax_ranks_epoch(method, epoch, params)
    np.testing.assert_allclose(r0["losses"], jlosses, rtol=1e-4)
    np.testing.assert_allclose(r0["result"]["val_loss"], jval_loss,
                               rtol=1e-4)
    np.testing.assert_allclose(r0["result"]["val_dice"], jval_dice,
                               rtol=1e-4)


def test_ddp_k_steps_and_the_tail_drive_one_ddp_wrapper(ranks):
    """Under ``-t DDP --steps-per-dispatch 2`` each rank built exactly one
    ``DistributedDataParallel`` around the model, and it ran all five
    steps' forwards: two stacks of two and the tail's single step (the
    eval runs the bare model). At K = 1 the same."""
    for r in ranks:
        assert r[f"DDP-k{K}"]["ddp"] == {"built": 1, "forwards": 5}
        assert r["DDP-k1"]["ddp"] == {"built": 1, "forwards": 5}
        assert r["DDP_MP-k2"]["ddp"] == {"built": 0, "forwards": 0}


# -- K = 2 under MP in one process ------------------------------------------------


def _mp_configs(tmp_path, schedule):
    common = dict(MP_EPOCH, pipeline_schedule=schedule)
    jcfg = JaxTrainConfig(
        async_checkpoint=False, kernels="xla", steps_per_dispatch=K,
        checkpoint_dir=str(tmp_path / "jax" / "checkpoints"),
        log_dir=str(tmp_path / "jax" / "logs"),
        loss_dir=str(tmp_path / "jax" / "loss"), **common)

    def port(k):
        return TrainConfig(
            device="cpu", kernels="torch", steps_per_dispatch=k,
            checkpoint_dir=str(tmp_path / f"k{k}" / "checkpoints"),
            log_dir=str(tmp_path / f"k{k}" / "logs"),
            loss_dir=str(tmp_path / f"k{k}" / "loss"), **common)

    return jcfg, port


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_mp_k2_epoch_equals_k1_and_matches_the_jax_trainer(tmp_path,
                                                           schedule):
    """``Trainer`` under ``-t MP`` (S = 2, M = 2, ``[cpu, cpu]``) at
    ``--steps-per-dispatch 2``, 5 steps (two stacks and a tail of one):
    the per-step losses and the final weights bitwise equal to K = 1 from
    the same weights, and the losses and the val metrics within 1e-4 of
    the JAX trainer's MP at ``steps_per_dispatch=2``."""
    jcfg, port = _mp_configs(tmp_path, schedule)
    jtrainer = JaxTrainer(jcfg)
    initial = params_from_jax(jax.device_get(jtrainer.state.params))
    jresult = jtrainer.train()
    runs = {}
    for k in (K, 1):
        trainer = Trainer(port(k), initial_state=initial,
                          devices=[CPU, CPU])
        runs[k] = (trainer, trainer.train())
    (t2, r2), (t1, r1) = runs[K], runs[1]
    assert r2["steps"] == r1["steps"] == jresult["steps"] == 5
    losses = [float(x) for x in t2.records.losses]
    assert losses == [float(x) for x in t1.records.losses]
    for (key, a), b in zip(t2.model.state_dict().items(),
                           t1.model.state_dict().values()):
        assert torch.equal(a, b), key
    np.testing.assert_allclose(losses,
                               [r[2] for r in jtrainer.records.train_rows],
                               rtol=1e-4)
    for key in ("val_loss", "val_dice"):
        np.testing.assert_allclose(r2[key], jresult[key], rtol=1e-4)


def test_dp_k2_epoch_equals_k1_and_matches_the_jax_dp(tmp_path):
    """``Trainer`` under ``-t DP`` on ``[cpu, cpu]`` for milesial, so the
    replicas meet at every BatchNorm, at ``--steps-per-dispatch 2``, 5
    steps (two stacks and a tail of one): the per-step losses and the
    final weights and running statistics bitwise equal to K = 1 from the
    same weights, and the losses and the val metrics within 1e-4 of the
    JAX trainer's DP at ``steps_per_dispatch=2`` (its multi-step over the
    data mesh, which the batch of 4 shrinks to 4 devices: the moments and
    the loss are the global batch's at any replica count)."""
    common = dict(MP_EPOCH, train_method="DP", model_arch="milesial")
    for key in ("num_stages", "num_microbatches"):
        common.pop(key)
    jtrainer = JaxTrainer(JaxTrainConfig(
        async_checkpoint=False, kernels="xla", steps_per_dispatch=K,
        checkpoint_dir=str(tmp_path / "jax" / "checkpoints"),
        log_dir=str(tmp_path / "jax" / "logs"),
        loss_dir=str(tmp_path / "jax" / "loss"), **common))
    initial = params_from_jax(jax.device_get(jtrainer.state.params),
                              jax.device_get(jtrainer.state.model_state))
    jresult = jtrainer.train()
    runs = {}
    for k in (K, 1):
        trainer = Trainer(TrainConfig(
            device="cpu", kernels="torch", steps_per_dispatch=k,
            checkpoint_dir=str(tmp_path / f"k{k}" / "checkpoints"),
            log_dir=str(tmp_path / f"k{k}" / "logs"),
            loss_dir=str(tmp_path / f"k{k}" / "loss"), **common),
            initial_state=initial, devices=[CPU, CPU])
        runs[k] = (trainer, trainer.train())
    (t2, r2), (t1, r1) = runs[K], runs[1]
    assert r2["steps"] == r1["steps"] == jresult["steps"] == 5
    assert t2.multi_step is not None and t1.multi_step is None
    losses = [float(x) for x in t2.records.losses]
    assert losses == [float(x) for x in t1.records.losses]
    for (key, a), b in zip(t2.model.state_dict().items(),
                           t1.model.state_dict().values()):
        assert torch.equal(a, b), key
    np.testing.assert_allclose(losses,
                               [r[2] for r in jtrainer.records.train_rows],
                               rtol=1e-4)
    for key in ("val_loss", "val_dice"):
        np.testing.assert_allclose(r2[key], jresult[key], rtol=1e-4)


@pytest.mark.parametrize("argv", [
    ["-t", "MP", "--stages", "2", "--microbatches", "2"],
    ["-t", "MP", "--stages", "2", "--microbatches", "2",
     "--pipeline-schedule", "1f1b"],
    ["-t", "DDP"],
    ["-t", "DP"],
])
def test_cli_trains_k_steps_outside_single_gpu(tmp_path, monkeypatch, argv):
    """The training CLI accepts ``--steps-per-dispatch 2`` under ``-t DP``,
    ``-t MP`` (both schedules) and ``-t DDP`` (world 1 without a
    launcher) on the CPU and trains its epoch."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.chdir(tmp_path)
    try:
        assert run_cli([*argv, "--steps-per-dispatch", "2", "--synthetic",
                        "26", "-v", "25", "--image-size", str(W), str(H),
                        "--model-widths", "8", "16", "-b", "4", "-e", "1",
                        "--device", "cpu", "--num-workers", "0",
                        "--dtype", "f32"]) == 0
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    method = argv[1]
    assert (tmp_path / "checkpoints" / f"{method}.pt").exists()


# -- Adam's param groups ----------------------------------------------------------


def test_adam_holds_one_group_per_device_run_with_its_lr():
    """``device_runs`` cuts the parameters where the device changes, in
    order; Adam holds one group per run, and ``set_learning_rate`` sets
    each group's lr. (The CPU has one device: the runs are shown over CPU
    and meta tensors, and Adam without ``capturable``, which the CPU
    does not support.)"""
    cpu = [torch.nn.Parameter(torch.zeros(2)) for _ in range(3)]
    meta = [torch.nn.Parameter(torch.zeros(2, device="meta"))
            for _ in range(2)]
    params = [cpu[0], cpu[1], meta[0], meta[1], cpu[2]]
    runs = device_runs(params)
    assert [[id(p) for p in run] for run in runs] == [
        [id(cpu[0]), id(cpu[1])], [id(meta[0]), id(meta[1])], [id(cpu[2])]]
    opt = make_optimizer(params, 1e-3)
    assert [len(g["params"]) for g in opt.param_groups] == [2, 2, 1]
    assert all(g["lr"] == 1e-3 for g in opt.param_groups)
    set_learning_rate(opt, 5e-4)
    assert [g["lr"] for g in opt.param_groups] == [5e-4] * 3


@pytest.mark.parametrize("saved_groups", [1, 3])
def test_a_checkpoint_of_other_groups_loads_and_steps_alike(saved_groups):
    """An Adam state saved with its parameters in ``saved_groups`` groups
    (another device list's runs) loads into this optimizer's groups
    (``load_optimizer_state``): the next step equals the step of the
    optimizer the state was saved from, bit for bit, and this optimizer
    keeps its groups."""
    def fresh():
        ps = [torch.nn.Parameter(torch.linspace(-1.0, 1.0, 6) * (i + 1))
              for i in range(3)]
        return ps, make_optimizer(ps, 1e-3)

    def grads(ps, seed):
        gen = torch.Generator().manual_seed(seed)
        for p in ps:
            p.grad = torch.randn(6, generator=gen)

    src = [torch.nn.Parameter(torch.linspace(-1.0, 1.0, 6) * (i + 1))
           for i in range(3)]
    groups = ([{"params": src}] if saved_groups == 1
              else [{"params": [p]} for p in src])
    saved_opt = torch.optim.Adam(groups, lr=1e-3, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=1e-8)
    grads(src, 1)
    saved_opt.step()
    state = copy.deepcopy(saved_opt.state_dict())
    ps, opt = fresh()
    with torch.no_grad():
        for p, q in zip(ps, src):
            p.copy_(q)
    if saved_groups == 3:
        # this optimizer, one group, against a state of three
        assert len(opt.param_groups) == 1
    load_optimizer_state(opt, state)
    assert len(opt.param_groups) == 1
    grads(src, 2)
    grads(ps, 2)
    saved_opt.step()
    opt.step()
    for p, q in zip(ps, src):
        assert torch.equal(p, q)


def test_a_master_weights_state_regroups_through_its_inner_state():
    """Under bf16_params the regrouping applies to the wrapped Adam's
    state: a state of three groups loads into a one-group master-weights
    optimizer, masters and moments bitwise."""
    ps = [torch.nn.Parameter(torch.linspace(-1.0, 1.0, 6) * (i + 1))
          for i in range(3)]
    opt = make_optimizer(ps, 1e-3, policy=BF16P)
    for p in ps:
        p.grad = torch.full((6,), 0.5)
    opt.step()
    state = copy.deepcopy(opt.state_dict())
    inner = state["inner"]
    inner["param_groups"] = [dict(inner["param_groups"][0], params=[i])
                             for i in range(3)]
    qs = [torch.nn.Parameter(torch.zeros(6)) for _ in range(3)]
    other = make_optimizer(qs, 1e-3, policy=BF16P)
    load_optimizer_state(other, state)
    assert len(other.param_groups) == 1
    for a, b in zip(other.master, opt.master):
        assert torch.equal(a, b)
    for a, b in zip(other.master, opt.master):
        assert torch.equal(other.state[a]["exp_avg"], opt.state[b]["exp_avg"])
