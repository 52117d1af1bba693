"""The port's run control under ``-t FSDP`` against the JAX package's, on
the CPU at tests/test_torch_fsdp.py's size (widths (8, 16), 32 × 16
images, ``-b 2`` per rank: a global batch of 4): K steps per dispatch,
``--remat``, ``--grad-accum`` and ``--dtype bf16_params``.

The port runs as two gloo ranks (``tests/torch_ddp_worker.py``'s
``pipeline_steps`` and ``trainer``, torch only), each holding its dim-0
shard of every parameter and of Adam's state; the JAX reference is its
FSDP strategy on a 2-device CPU mesh fed the concatenation of the ranks'
batches. On the CPU the K-step dispatch is K plain steps (a CUDA graph
needs NCCL on cards; tests/test_torch_cuda.py holds it at world 1).
Every scenario runs in one launch (the ``ranks`` fixture), bounded by
``LAUNCH_TIMEOUT_S``."""

import functools
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.ops.optim import adam_l2
from distributedpytorch_tpu.ops.precision import get_policy as jax_policy
from distributedpytorch_tpu.ops.precision import with_master_weights
from distributedpytorch_tpu.train.steps import TrainState
from distributedpytorch_tpu_torch import checkpoint
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.train.loop import Trainer
from test_torch_fsdp import (
    ARCHS,
    EPOCH,
    LR,
    WIDTHS,
    WORLD,
    B,
    H,
    W,
    _jax_fsdp,
    _step_batches,
    _to_port,
)
from test_torch_graph_strategies import _assert_masters_match
from torch_ddp_worker import launch
from torch_parallel_parity import capture_then, max_err_rel_to_max

K = 2
RUNS = {"plain": {}, "k2": dict(steps_per_dispatch=K),
        "remat": dict(remat=True)}
# the bf16_params gradients before Adam against the JAX FSDP's: each
# side's bf16 backward rounds apart (measured here: the UNet's weight
# gradients within 4e-3 relative L2, a bias summed over the batch up to
# 0.48; milesial's, through bf16 BatchNorm inputs, 0.1-0.3), so what is
# held is the scale: the median over the tensors of |g| / |g_JAX|
# (measured 1.000 and 0.99), which a gradient ``world ×`` too large or too
# small moves to 2 or 0.5
BF16_GRADS_NORM_RATIO = (0.8, 1.25)


def _config(arch, **kw):
    return {**dict(model_arch=arch, model_widths=WIDTHS, dtype="f32",
                   kernels="cuda", batch_size=B, learning_rate=LR,
                   image_size=(W, H)), **kw}


def _jobs(tmp):
    jobs = {}
    for arch in ARCHS:
        _cfg, _s, _m, params, model_state = _jax_fsdp(arch)
        initial = _to_port(params, model_state)
        for run, kw in RUNS.items():
            jobs[f"{run}-{arch}"] = {
                "kind": "pipeline_steps", "method": "FSDP",
                "initial": initial, "batches": _step_batches(),
                "config": _config(arch, **kw)}
        jobs[f"bf16p-{arch}"] = {
            "kind": "pipeline_steps", "method": "FSDP", "initial": initial,
            "batches": _step_batches()[:1],
            "config": _config(arch, kernels="torch", dtype="bf16_params")}
    jobs["accum-unet"] = dict(jobs["plain-unet"], config=_config(
        "unet", grad_accum=2))
    jobs["accum-remat-unet"] = dict(jobs["plain-unet"], config=_config(
        "unet", grad_accum=2, remat=True))
    # the trainer's own paths: an epoch of 4 steps per rank at K = 1, at
    # K = 3 (one stack and a tail of one step) and at --grad-accum 2
    for run, kw in (("plain", {}), ("k3", dict(steps_per_dispatch=3)),
                    ("accum", dict(grad_accum=2))):
        jobs[f"trainer-{run}"] = {
            "kind": "trainer", "method": "FSDP",
            "initial": jobs["plain-unet"]["initial"],
            "dir": str(tmp / f"trainer-{run}"),
            "config": dict(EPOCH, kernels="cuda", **kw)}
    jobs["trainer-bf16p"] = {
        "kind": "trainer", "method": "FSDP", "initial": jobs[
            "plain-milesial"]["initial"], "dir": str(tmp / "trainer-bf16p"),
        "config": dict(EPOCH, model_arch="milesial", kernels="cuda",
                       dtype="bf16_params", remat=True)}
    # rank 0's files resumed by both ranks under FSDP bf16_params: the
    # whole state (masters and Adam's moments cut into shards), and the
    # .pth's weights alone (the masters reseeded from them)
    written = tmp / "trainer-bf16p" / "rank0" / "checkpoints"
    for run, name in (("pt", "FSDP.pt"), ("pth", "FSDP.pth")):
        jobs[f"resume-bf16p-{run}"] = dict(
            jobs["trainer-bf16p"], dir=str(tmp / f"resume-bf16p-{run}"),
            config=dict(jobs["trainer-bf16p"]["config"], epochs=2,
                        checkpoint_name=str(written / name)))
    return jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every scenario's results on both ranks, from one 2-rank launch."""
    tmp = tmp_path_factory.mktemp("fsdp_run_control")
    return launch(tmp / "job", _jobs(tmp))


def _stacked():
    batches = _step_batches()
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _jax_run(arch, **kw):
    """The JAX FSDP strategy of ``arch`` with ``kw``, its model, Adam behind
    a gradient capture and the seeded state, placed."""
    cfg, strategy, model, params, model_state = _jax_fsdp(arch, **kw)
    tx = capture_then(adam_l2(strategy.lr_for(LR), cfg.weight_decay))
    state = strategy.place_state(TrainState(
        params=params, opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32), model_state=model_state))
    return strategy, model, tx, state


@functools.cache
def _jax_multi(arch):
    """The JAX FSDP multi-step of K steps over the two global batches: the
    losses and the state after both."""
    strategy, model, tx, state = _jax_run(arch, steps_per_dispatch=K)
    new, losses = strategy.build_multi_train_step(model, tx)(
        state, strategy.place_stacked_batch(_stacked()))
    return (np.asarray(losses).tolist(),
            _to_port(new.params, new.model_state))


@functools.cache
def _jax_remat(arch):
    """The JAX FSDP step with ``remat=True``, twice: the losses, the first
    step's gradients and the state after both."""
    strategy, model, tx, state = _jax_run(arch, remat=True)
    step = strategy.build_train_step(model, tx)
    losses, grads = [], None
    for batch in _step_batches():
        state, loss = step(state, strategy.place_batch(batch))
        losses.append(float(loss))
        if grads is None:
            grads = _to_port(state.opt_state[0], state.model_state)
    return losses, grads, _to_port(state.params, state.model_state)


@functools.cache
def _jax_accum():
    """The JAX FSDP accumulation step of the UNet over the two global
    batches as its two chunks: the loss and the gradients Adam read."""
    strategy, model, tx, state = _jax_run("unet", grad_accum=2)
    new, loss = strategy.build_accum_train_step(model, tx)(
        state, strategy.place_stacked_batch(_stacked()))
    return float(loss), _to_port(new.opt_state[0], None)


@functools.cache
def _jax_bf16_params(arch):
    """One JAX FSDP step under bf16_params from the seeded f32 weights, on
    the first global batch: the loss, the f32 gradients Adam read and
    the masters after the step."""
    cfg, strategy, model, params, model_state = _jax_fsdp(
        arch, dtype="bf16_params")
    tx = with_master_weights(capture_then(adam_l2(strategy.lr_for(LR),
                                                  cfg.weight_decay)))
    state = strategy.place_state(TrainState(
        params=jax_policy(cfg).cast_params(params),
        opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
        model_state=model_state))
    state, loss = strategy.build_train_step(model, tx)(
        state, strategy.place_batch(_step_batches()[0]))
    return (float(loss), _to_port(state.opt_state.inner[0], model_state),
            _to_port(state.opt_state.master, model_state))


def _assert_ranks_equal(r0, r1):
    assert torch.equal(r0["losses"], r1["losses"])
    for name, g in r0["grads"].items():
        assert torch.equal(g, r1["grads"][name]), name
    for got, other in zip(r0["states"], r1["states"]):
        for key, value in got.items():
            assert torch.equal(value, other[key]), key


def _assert_state_after_two_steps(state, want):
    """Every weight within 1e-4 of its tensor's largest after two Adam
    steps, the running statistics within 1e-5 of theirs, as
    tests/test_torch_fsdp.py holds its second step."""
    for key, value in state.items():
        if key.endswith("num_batches_tracked"):
            assert int(value) == K, key
            continue
        err = max_err_rel_to_max(value.numpy(), want[key].numpy())
        assert err <= (1e-5 if "running" in key else 1e-4), (key, err)


def _assert_grads_match(got, want):
    """Every gradient before Adam within 1e-4 of its tensor's largest: a
    gradient ``world ×`` too large or too small fails."""
    for name, g in got.items():
        err = max_err_rel_to_max(g.numpy(), want[name].numpy())
        assert err <= 1e-4, (name, err)


# -- K steps per dispatch and --remat -------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_k2_and_remat_are_bitwise_the_plain_steps(ranks, arch):
    """On both ranks ``--steps-per-dispatch 2`` (one stack of the two
    batches) and ``--remat`` (two steps, each block recomputed inside
    ``fully_shard``'s hooks, milesial's BatchNorm on the global moments
    it kept, so no all-reduce of a recompute meets the other rank's)
    give the plain FSDP steps' losses, first gradients and state after
    every step, bit for bit, and the ranks agree bit for bit."""
    plain = [r[f"plain-{arch}"] for r in ranks]
    for run in ("k2", "remat"):
        r0, r1 = (r[f"{run}-{arch}"] for r in ranks)
        _assert_ranks_equal(r0, r1)
        assert torch.equal(r0["losses"], plain[0]["losses"]), run
        for name, g in plain[0]["grads"].items():
            assert torch.equal(r0["grads"][name], g), (run, name)
        for key, value in plain[0]["states"][-1].items():
            assert torch.equal(r0["states"][-1][key], value), (run, key)


@pytest.mark.parametrize("arch", ARCHS)
def test_k2_matches_the_jax_fsdp_multi_step(ranks, arch):
    """The K = 2 stack against the JAX FSDP multi-step over the same
    global batches: both losses within 1e-5 relative, the state after
    both steps as ``_assert_state_after_two_steps`` holds it."""
    jlosses, jstate = _jax_multi(arch)
    r0 = ranks[0][f"k2-{arch}"]
    np.testing.assert_allclose(r0["losses"].numpy(), jlosses, rtol=1e-5)
    assert len(r0["states"]) == 1
    _assert_state_after_two_steps(r0["states"][-1], jstate)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_matches_the_jax_fsdp_remat_steps(ranks, arch):
    """Two ``--remat`` steps against the JAX FSDP's built with
    ``remat=True``: both losses within 1e-5 relative, the first step's
    gradients before Adam within 1e-4 of each tensor's largest, the
    state after both steps as ``_assert_state_after_two_steps`` holds
    it."""
    jlosses, jgrads, jstate = _jax_remat(arch)
    r0 = ranks[0][f"remat-{arch}"]
    np.testing.assert_allclose(r0["losses"].numpy(), jlosses, rtol=1e-5)
    _assert_grads_match(r0["grads"], jgrads)
    _assert_state_after_two_steps(r0["states"][-1], jstate)


# -- --grad-accum ---------------------------------------------------------------


@pytest.mark.parametrize("run", ["accum-unet", "accum-remat-unet"])
def test_accum_matches_the_jax_fsdp_accum_step(ranks, run):
    """``--grad-accum 2`` of the UNet on two ranks, with and without
    ``--remat``: each rank's chunks' statistics (K1 under ``--kernels
    cuda``, whose plain version runs here) summed over the ranks in pass
    1, each chunk's own statistics back-propagated in pass 2 with the
    cotangent times the world size, which FSDP's reduce-scatter after
    each chunk averages over the ranks, against the JAX FSDP
    accumulation step over the two global chunks. The loss within 1e-5
    relative and every gradient before Adam within 1e-4 of its tensor's
    largest, so a gradient ``world ×`` too large or too small fails;
    both ranks bitwise equal."""
    jloss, jgrads = _jax_accum()
    r0, r1 = (r[run] for r in ranks)
    _assert_ranks_equal(r0, r1)
    assert r0["losses"].shape == (1,)
    np.testing.assert_allclose(float(r0["losses"][0]), jloss, rtol=1e-5)
    _assert_grads_match(r0["grads"], jgrads)


# -- --dtype bf16_params ----------------------------------------------------------


def _median_norm_ratio(got, want):
    """The median over the tensors of ``got`` of |g| / |g_JAX|."""
    return float(np.median([float(g.double().norm()
                                  / want[n].double().norm())
                            for n, g in got.items()]))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_params_step_matches_the_jax_fsdp(ranks, arch):
    """One bf16_params step on two ranks against the JAX FSDP's
    ``with_master_weights`` step over the same global batch: the loss
    within 1e-3 relative (bf16 convolutions, as the other bf16_params
    cases); the f32 gradients Adam read, reduce-scattered in float32 and
    rounded to bf16 once before the masters' hook widens them, at the
    JAX gradients' scale (``BF16_GRADS_NORM_RATIO``: a ``world ×`` factor
    fails); the masters after Adam by ``_assert_masters_match``; every
    parameter bf16 and its master rounded, and both ranks bitwise
    equal."""
    jloss, jgrads, jmaster = _jax_bf16_params(arch)
    r0, r1 = (r[f"bf16p-{arch}"] for r in ranks)
    _assert_ranks_equal(r0, r1)
    np.testing.assert_allclose(float(r0["losses"][0]), jloss, rtol=1e-3)
    low, high = BF16_GRADS_NORM_RATIO
    assert low <= _median_norm_ratio(r0["grads"], jgrads) <= high
    state = r0["states"][-1]
    names = list(r0["grads"])  # the parameters, in the masters' order
    assert len(names) == len(r0["master"])
    for name, m, m1 in zip(names, r0["master"], r1["master"]):
        assert m.dtype == torch.float32 and torch.equal(m, m1), name
        assert state[name].dtype == torch.bfloat16, name
        assert torch.equal(state[name], m.to(torch.bfloat16)), name
        _assert_masters_match(m, jmaster[name], LR)


def test_bf16_params_masters_are_shards_of_each_rank(ranks):
    """Under bf16_params each rank holds its share of the bf16
    parameters, the f32 masters and Adam's moments over them: at most the
    whole's / world × 1.5, the two shares adding up to the whole, which
    counts 2 + 3 × 4 bytes a parameter."""
    mine0, whole = ranks[0]["bf16p-milesial"]["bytes"]
    mine1, whole1 = ranks[1]["bf16p-milesial"]["bytes"]
    assert whole == whole1
    assert max(mine0, mine1) <= whole / WORLD * 1.5, (mine0, mine1, whole)
    assert mine0 + mine1 == whole
    params = sum(t.numel() for k, t in ranks[0]["bf16p-milesial"][
        "states"][-1].items() if t.dtype == torch.bfloat16)
    assert whole == params * (2 + 3 * 4)


def test_the_trainer_runs_k3_stacks_with_a_tail_and_accumulation(ranks):
    """``Trainer`` under ``-t FSDP`` on two ranks, one epoch of 4 steps per
    rank: at ``steps_per_dispatch=3`` (one stack through the strategy's
    multi-step around the trainer's own train step, then a tail of one
    step through that step) its losses, val metrics and gathered weights
    are bitwise the K = 1 epoch's; at ``grad_accum=2`` it takes 2 steps
    of 2 chunks each to a finite val loss, the ranks bitwise equal."""
    plain = [r["trainer-plain"] for r in ranks]
    k3 = [r["trainer-k3"] for r in ranks]
    assert plain[0]["result"]["steps"] == k3[0]["result"]["steps"] == 4
    assert k3[0]["same_step"]
    for rank in range(WORLD):
        assert k3[rank]["losses"] == plain[rank]["losses"]
        for key in ("val_loss", "val_dice"):
            assert k3[rank]["result"][key] == plain[rank]["result"][key]
        for key, value in plain[rank]["state"].items():
            assert torch.equal(k3[rank]["state"][key], value), key
    a0, a1 = (r["trainer-accum"] for r in ranks)
    assert a0["result"]["steps"] == 2 and len(a0["losses"]) == 2
    assert np.isfinite(a0["result"]["val_loss"])
    assert a0["losses"] == a1["losses"]
    for key, value in a0["state"].items():
        assert torch.equal(value, a1["state"][key]), key


def test_rank_zeros_bf16_params_file_resumes_under_singlegpu_bitwise(
        ranks, tmp_path, caplog):
    """A milesial epoch under ``-t FSDP --dtype bf16_params --remat`` on two
    ranks trains to a finite val loss, the ranks agree bitwise, and rank
    0's ``FSDP.pt`` holds the whole bf16 parameters and f32 masters the
    ranks gathered, under the reference names, with Adam's state in the
    singleGPU layout; ``-c`` of it under singleGPU ``bf16_params``
    restores the parameters, the masters and Adam's moments bitwise."""
    r0, r1 = (r["trainer-bf16p"] for r in ranks)
    assert np.isfinite(r0["result"]["val_loss"])
    assert r0["losses"] == r1["losses"]
    for key, value in r0["state"].items():
        assert torch.equal(value, r1["state"][key]), key
    written = os.path.join(r0["out"], "checkpoints")
    saved = checkpoint.load_native(os.path.join(written, "FSDP.pt"))
    assert saved["manifest"]["dtype"] == "bf16_params"
    names = [n for n in saved["model"] if n in r0["state"]
             and saved["model"][n].dtype == torch.bfloat16]
    for key, value in r0["state"].items():
        assert torch.equal(saved["model"][key], value), key
    masters = saved["optimizer"]["master"]
    assert len(masters) == len(names)
    for name, m in zip(names, masters):
        assert m.dtype == torch.float32
        assert list(m.shape) == list(saved["model"][name].shape), name
        assert torch.equal(saved["model"][name], m.to(torch.bfloat16)), name
    cfg = TrainConfig(**{**EPOCH, "epochs": 2, "dtype": "bf16_params"},
                      model_arch="milesial", device="cpu", kernels="torch",
                      checkpoint_name=os.path.join(written, "FSDP.pt"),
                      checkpoint_dir=str(tmp_path / "checkpoints"),
                      log_dir=str(tmp_path / "logs"),
                      loss_dir=str(tmp_path / "loss"))
    with caplog.at_level(logging.WARNING):
        trainer = Trainer(cfg)
    assert "mesh-resharding restore" in caplog.text
    for key, value in trainer.model.state_dict().items():
        assert torch.equal(value, saved["model"][key]), key
    state = trainer.optimizer.state_dict()
    for a, b in zip(state["master"], masters):
        assert torch.equal(a, b)
    for i, st in saved["optimizer"]["inner"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(state["inner"]["state"][i][key], st[key]), (
                i, key)
    # the ranks import torch and the port only
    assert ranks[0]["leaked"] == ranks[1]["leaked"] == []


@pytest.mark.parametrize("run", ["pt", "pth"])
def test_fsdp_bf16_params_resumes_rank_zeros_files(ranks, run):
    """Both ranks resume rank 0's bf16_params ``FSDP.pt`` (each cutting its
    shards of the parameters, the f32 masters and Adam's moments from the
    whole tensors) and train its second epoch, or its ``.pth`` (the
    masters reseeded from the bf16 weights, ``param_values``) and train
    two epochs: 8 steps in all, a finite val loss, the ranks bitwise equal, and every gathered
    parameter its master rounded in rank 0's new file."""
    r0, r1 = (r[f"resume-bf16p-{run}"] for r in ranks)
    assert r0["result"]["steps"] == 8
    assert np.isfinite(r0["result"]["val_loss"])
    assert r0["losses"] == r1["losses"]
    for key, value in r0["state"].items():
        assert torch.equal(value, r1["state"][key]), key
    saved = checkpoint.load_native(os.path.join(r0["out"], "checkpoints",
                                                "FSDP.pt"))
    names = [n for n, t in saved["model"].items()
             if t.dtype == torch.bfloat16]
    for name, m in zip(names, saved["optimizer"]["master"]):
        assert torch.equal(saved["model"][name], m.to(torch.bfloat16)), name
