"""The port's run control under ``-t DDP_SP`` against the JAX package's, on
the CPU at tests/test_torch_ddp_sp.py's size (widths (8, 16), 32 × 16
images, float32, ``-b 4`` per rank, two row shards per rank): K steps
per dispatch, ``--remat`` and ``--grad-accum``.

The port runs as two gloo ranks (``tests/torch_ddp_worker.py``'s
``pipeline_steps``, torch only), each row-sharding its batch over ``[cpu,
cpu]``; the JAX reference is its DDP_SP strategy on a ``{data: 2,
spatial: 2}`` CPU mesh fed the concatenation of the ranks' batches. On
the CPU the K-step dispatch is K plain steps (a CUDA graph needs NCCL on
cards). Every scenario runs in one launch (the ``ranks`` fixture),
bounded by ``LAUNCH_TIMEOUT_S``."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.models import create_model as jax_create_model
from distributedpytorch_tpu.ops.optim import adam_l2
from distributedpytorch_tpu.train.steps import TrainState
from test_torch_ddp_sp import (
    ARCHS,
    B,
    LR,
    SHARDS,
    WIDTHS,
    WORLD,
    H,
    W,
    _jax_config,
    _jax_strategy,
    _jax_weights,
    _step_batches,
)
from torch_ddp_worker import launch
from torch_parallel_parity import capture_then, max_err_rel_to_max, to_port

K = 2
RUNS = {"plain": {}, "k2": dict(steps_per_dispatch=K),
        "remat": dict(remat=True)}


def _jobs():
    jobs = {}
    for arch in ARCHS:
        initial = to_port(*_jax_weights(arch))
        for run, kw in RUNS.items():
            jobs[f"{run}-{arch}"] = {
                "kind": "pipeline_steps", "method": "DDP_SP",
                "initial": initial, "batches": _step_batches(),
                "config": dict(model_arch=arch, model_widths=WIDTHS,
                               dtype="f32", kernels="cuda", batch_size=B,
                               image_size=(W, H), learning_rate=LR, **kw)}
    jobs["accum-unet"] = dict(jobs["plain-unet"], config=dict(
        jobs["plain-unet"]["config"], grad_accum=2))
    return jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every scenario's results on both ranks, from one 2-rank launch."""
    return launch(tmp_path_factory.mktemp("ddp_sp_run_control") / "job",
                  _jobs())


def _jax_run(arch, **kw):
    """The JAX DDP_SP strategy of ``arch`` with ``kw``, its model, Adam
    behind a gradient capture and the seeded state, placed."""
    cfg = _jax_config(arch, **kw)
    strategy = _jax_strategy(cfg)
    assert dict(strategy.mesh.shape) == {"data": WORLD, "spatial": SHARDS}
    model, _init = jax_create_model(cfg)
    params, model_state = _jax_weights(arch)
    tx = capture_then(adam_l2(strategy.lr_for(LR), cfg.weight_decay))
    state = strategy.place_state(TrainState(
        params=params, opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32), model_state=model_state))
    return strategy, model, tx, state


def _stacked():
    batches = _step_batches()
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


@functools.cache
def _jax_multi(arch):
    """The JAX DDP_SP multi-step of K steps over the two global batches:
    the losses and the state after both."""
    strategy, model, tx, state = _jax_run(arch, steps_per_dispatch=K)
    new, losses = strategy.build_multi_train_step(model, tx)(
        state, strategy.place_stacked_batch(_stacked()))
    return (np.asarray(losses).tolist(),
            to_port(new.params, new.model_state))


@functools.cache
def _jax_remat(arch):
    """The JAX DDP_SP step with ``remat=True``, twice: the losses and the
    state after both."""
    strategy, model, tx, state = _jax_run(arch, remat=True)
    step = strategy.build_train_step(model, tx)
    losses = []
    for batch in _step_batches():
        state, loss = step(state, strategy.place_batch(batch))
        losses.append(float(loss))
    return losses, to_port(state.params, state.model_state)


@functools.cache
def _jax_accum():
    """The JAX DDP_SP accumulation step of the UNet over the two global
    batches as its two chunks: the loss and the gradients Adam read."""
    strategy, model, tx, state = _jax_run("unet", grad_accum=2)
    new, loss = strategy.build_accum_train_step(model, tx)(
        state, strategy.place_stacked_batch(_stacked()))
    return float(loss), to_port(new.opt_state[0], None)


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
    tests/test_torch_ddp_sp.py holds its second step."""
    for key, value in state.items():
        if key.endswith("num_batches_tracked"):
            assert int(value) == K, key
            continue
        err = max_err_rel_to_max(value.numpy(), want[key].numpy())
        assert err <= (1e-5 if "running" in key else 1e-4), (key, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_k2_and_remat_are_bitwise_the_plain_steps(ranks, arch):
    """On both ranks ``--steps-per-dispatch 2`` (one stack of the two
    batches) and ``--remat`` (two steps, each shard recomputed with the
    halo rows and the moments it kept, so no all-reduce of the recompute
    meets the other rank's) give the plain DDP_SP steps' losses,
    first gradients and state after every step, bit for bit, and the
    ranks agree bit for bit."""
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
def test_k2_matches_the_jax_ddp_sp_multi_step(ranks, arch):
    """The K = 2 stack against the JAX DDP_SP multi-step over the same
    global batches: both losses within 1e-5 relative, the state after
    both steps as ``_assert_state_after_two_steps`` holds it."""
    jlosses, jstate = _jax_multi(arch)
    r0 = ranks[0][f"k2-{arch}"]
    np.testing.assert_allclose(r0["losses"].numpy(), jlosses, rtol=1e-5)
    assert len(r0["states"]) == 1
    _assert_state_after_two_steps(r0["states"][-1], jstate)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_matches_the_jax_ddp_sp_remat_steps(ranks, arch):
    """Two ``--remat`` steps against the JAX DDP_SP's built with
    ``remat=True``: both losses within 1e-5 relative, the state after
    both steps as ``_assert_state_after_two_steps`` holds it."""
    jlosses, jstate = _jax_remat(arch)
    r0 = ranks[0][f"remat-{arch}"]
    np.testing.assert_allclose(r0["losses"].numpy(), jlosses, rtol=1e-5)
    _assert_state_after_two_steps(r0["states"][-1], jstate)


def test_accum_matches_the_jax_ddp_sp_accum_step(ranks):
    """``--grad-accum 2`` of the UNet on two ranks: each rank's chunks'
    statistics (the shards' sums, K1 per shard under ``--kernels cuda``,
    whose plain version runs here) summed over the ranks in pass 1, each
    chunk's own statistics back-propagated in pass 2 and the gradients
    then summed over the ranks, against the JAX DDP_SP accumulation step
    over the two global chunks. The loss within 1e-5 relative and every
    gradient before Adam within 1e-4 of its tensor's largest, so a
    gradient ``world ×`` too large or too small fails; both ranks bitwise
    equal."""
    jloss, jgrads = _jax_accum()
    r0, r1 = (r["accum-unet"] for r in ranks)
    _assert_ranks_equal(r0, r1)
    assert r0["losses"].shape == (1,)
    np.testing.assert_allclose(float(r0["losses"][0]), jloss, rtol=1e-5)
    for name, g in r0["grads"].items():
        err = max_err_rel_to_max(g.numpy(), jgrads[name].numpy())
        assert err <= 1e-4, (name, err)
    # the ranks import torch and the port only
    assert ranks[0]["leaked"] == ranks[1]["leaked"] == []
