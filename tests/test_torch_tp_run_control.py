"""The port's run control under ``-t TP`` against the JAX package's, on the
CPU at tests/test_torch_tp.py's size (widths (8, 16), 32 × 16 images,
``-b 4``, float32): K steps per dispatch, ``--remat`` and
``--grad-accum``.

The port's channel slices run on ``[cpu] * n``; the JAX reference is its
TP strategy on ``jax.devices()[:n]`` (conftest's virtual CPU devices),
whose multi-step scans K steps, whose ``remat=True`` step checkpoints the
forward and whose accumulation step sums two chunks. Weights cross with
``checkpoint.params_from_jax``; inputs are numpy arrays made from seeds.
PERF.md §2's bounds hold: the loss within 1e-5, each gradient before
Adam within 1e-4 of its tensor's largest, the running statistics and the
weights after Adam within 1e-5 (``torch_parallel_parity.
assert_step_matches``). On the CPU the K-step dispatch is K plain steps;
tests/test_torch_cuda.py holds its CUDA graph bitwise against the eager
steps on the card."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.ops.optim import adam_l2
from distributedpytorch_tpu.parallel import strategy as jax_strategy
from distributedpytorch_tpu.train.steps import TrainState
from distributedpytorch_tpu_torch import checkpoint
from distributedpytorch_tpu_torch.models import create_model
from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
from distributedpytorch_tpu_torch.parallel.channels import ChannelSharded
from distributedpytorch_tpu_torch.train.loop import Trainer
from test_torch_tp import (
    ARCHS,
    CLI,
    CPU,
    LR,
    H,
    W,
    WIDTHS,
    B,
    _batch,
    _jax_config,
    _jax_init,
    _port_config,
    _port_tp_step,
    _Whole,
)
from torch_parallel_parity import (
    assert_step_matches,
    capture_then,
    max_err_rel_to_max,
    run_cli,
    to_port,
    torch_batch,
)

K = 2


def _stack(seeds=(1, 2)):
    """The batches of ``seeds`` stacked on a leading axis, as numpy."""
    batches = [_batch(seed) for seed in seeds]
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _jax_tp(arch, n, **kw):
    """The JAX TP strategy on ``n`` devices and the seeded weights' state
    under Adam behind a gradient capture (``capture_then``)."""
    strategy = jax_strategy.build_strategy(_jax_config(arch, **kw),
                                           devices=jax.devices()[:n])
    assert dict(strategy.mesh.shape) == {"model": n}
    model, params, model_state = _jax_init(arch)
    tx = capture_then(adam_l2(LR))
    state = strategy.place_state(TrainState(
        params=params, opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32), model_state=model_state))
    return strategy, model, tx, state, to_port(params, model_state)


def _after(new, initial_state, initial, **extra):
    return {"initial": initial, "grads": to_port(new.opt_state[0],
                                                 initial_state),
            "final": to_port(new.params, new.model_state), **extra}


@functools.cache
def _jax_multi(arch, n):
    """The JAX TP multi-step of K steps over ``_stack()``: its losses, the
    last step's gradients and the state after both steps."""
    strategy, model, tx, state, initial = _jax_tp(arch, n,
                                                  steps_per_dispatch=K)
    new, losses = strategy.build_multi_train_step(model, tx)(
        state, strategy.place_stacked_batch(_stack()))
    return _after(new, state.model_state, initial,
                  losses=np.asarray(losses).tolist())


@functools.cache
def _jax_remat_step(arch):
    """The JAX TP step built with ``remat=True`` on two devices."""
    strategy, model, tx, state, initial = _jax_tp(arch, 2, remat=True)
    new, loss = strategy.build_train_step(model, tx)(
        state, strategy.place_batch(_batch()))
    return _after(new, state.model_state, initial, loss=float(loss))


@functools.cache
def _jax_accum_step(n):
    """The JAX TP accumulation step of the UNet over the two chunks of
    ``_stack()`` on ``n`` devices."""
    strategy, model, tx, state, initial = _jax_tp("unet", n, grad_accum=2)
    new, loss = strategy.build_accum_train_step(model, tx)(
        state, strategy.place_stacked_batch(_stack()))
    return _after(new, None, initial, loss=float(loss))


def _keep_last_grads(opt):
    """``opt`` (``_WholeGrads``) keeps the whole gradients of its latest
    step, as the JAX capture's state does over a scan of K steps."""
    step = opt.step

    def last():
        opt.grads = None
        step()

    opt.step = last


def _assert_state_matches(model, want):
    """Every weight after Adam within 1e-5 relative with an absolute floor
    of 1e-3 × lr per step taken, the running statistics within 1e-5 of
    their largest, and milesial's statistics moved once per step."""
    for key, value in model.whole_state().items():
        if key.endswith("num_batches_tracked"):
            assert int(value) == K, key
            continue
        ref = want[key].numpy()
        if "running" in key:
            assert max_err_rel_to_max(value.numpy(), ref) <= 1e-5, key
        else:
            np.testing.assert_allclose(value.numpy(), ref, rtol=1e-5,
                                       atol=K * 1e-3 * LR, err_msg=key)


# -- K steps per dispatch -----------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_k_steps_match_the_jax_tp_multi_step(arch, n):
    """``--steps-per-dispatch 2`` under TP over ``[cpu] * n`` (the
    strategy's multi-step around its own train step: K plain steps here,
    on the slices' devices) against the JAX TP multi-step on n devices
    over the same stack: both losses within 1e-5, the second step's
    gradients before Adam within 1e-4 of each tensor's largest, the
    weights and milesial's running statistics after both steps as
    ``_assert_state_matches`` holds them."""
    want = _jax_multi(arch, n)
    cfg = _port_config(arch, kernels="cuda", steps_per_dispatch=K)
    strategy, model, opt, step = _port_tp_step(cfg, want["initial"], n)
    _keep_last_grads(opt)
    multi = strategy.build_multi_train_step(step)
    assert multi.steps == K and multi.devices == [CPU]
    assert strategy.step_devices == [CPU] * n
    losses = multi({k: torch.from_numpy(v) for k, v in _stack().items()})
    assert losses.shape == (K,)
    np.testing.assert_allclose(losses.numpy(), want["losses"], rtol=1e-5)
    for name, g in opt.grads.items():
        err = max_err_rel_to_max(g.numpy(), want["grads"][name].numpy())
        assert err <= 1e-4, (name, err)
    _assert_state_matches(model, want["final"])


def test_one_k2_epoch_is_bitwise_the_k1_epoch(tmp_path):
    """``Trainer`` under ``-t TP`` on ``[cpu, cpu]`` for milesial at
    ``steps_per_dispatch=2``: --synthetic 24 -v 25 -b 4, 5 steps (two
    stacks and a tail of one through the same train step), 1 val batch;
    the losses, the val metrics, the whole weights and the running
    statistics bitwise equal to the same epoch at K = 1."""
    common = dict(epochs=1, batch_size=B, val_percent=25.0, seed=42,
                  image_size=(W, H), model_widths=WIDTHS,
                  synthetic_samples=24, metric_every_steps=1, num_workers=0,
                  s2d_levels=0, train_method="TP", dtype="f32",
                  model_arch="milesial", kernels="cuda", device="cpu")
    runs = {}
    for k in (K, 1):
        trainer = Trainer(_port_config(
            "milesial", **{**common, "steps_per_dispatch": k,
                           "checkpoint_dir": str(tmp_path / f"k{k}" / "c"),
                           "log_dir": str(tmp_path / f"k{k}" / "l"),
                           "loss_dir": str(tmp_path / f"k{k}" / "s")}),
            devices=[CPU, CPU])
        runs[k] = (trainer, trainer.train())
    (t2, r2), (t1, r1) = runs[K], runs[1]
    assert r2["steps"] == r1["steps"] == 5
    assert t2.multi_step is not None and t2.multi_step.step is t2.train_step
    assert [float(x) for x in t2.records.losses] == [
        float(x) for x in t1.records.losses]
    assert (r2["val_loss"], r2["val_dice"]) == (r1["val_loss"],
                                                r1["val_dice"])
    one = t1.model.whole_state()
    for key, value in t2.model.whole_state().items():
        assert torch.equal(value, one[key]), key


# -- --remat ------------------------------------------------------------------


def _counting_segments(monkeypatch):
    """``counts``: the calls of ``ChannelSharded.apply_segment``, in the
    forward (``grad``) and in the backward's recompute."""
    counts = {"calls": 0}
    apply = ChannelSharded.apply_segment

    def counted(self, *args):
        counts["calls"] += 1
        return apply(self, *args)

    monkeypatch.setattr(ChannelSharded, "apply_segment", counted)
    return counts


@pytest.mark.parametrize("policy", ["torch", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_remat_step_is_bitwise_the_plain_tp_step(monkeypatch, arch,
                                                    policy):
    """One Adam step on ``[cpu, cpu]`` with and without ``--remat``: the
    loss, every whole gradient and the state after the step (running
    statistics moved once) bitwise equal. Under remat the sharded model
    runs each segment twice, once in the forward and once recomputed in
    the backward (``models.Rematerialized`` takes ``ChannelSharded``'s
    segments), so no region spans the whole forward."""
    initial = create_model(_port_config(arch), generator=torch.Generator(
        ).manual_seed(0)).state_dict()
    runs = {}
    for remat in (False, True):
        counts = _counting_segments(monkeypatch)
        cfg = _port_config(arch, kernels=policy, remat=remat)
        _s, model, opt, step = _port_tp_step(cfg, initial, 2)
        loss = step(torch_batch(_batch()))
        runs[remat] = (float(loss), opt.grads, model.whole_state(),
                       counts["calls"], model.num_segments)
        monkeypatch.undo()
    (l0, g0, s0, c0, segs), (l1, g1, s1, c1, _) = runs[False], runs[True]
    assert l1 == l0
    for name, g in g0.items():
        assert torch.equal(g1[name], g), name
    for key, value in s0.items():
        assert torch.equal(s1[key], value), key
        if key.endswith("num_batches_tracked"):
            assert int(value) == 1, key
    assert (c0, c1) == (segs, 2 * segs)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_remat_step_matches_the_jax_tp_remat_step(arch):
    """One ``--remat`` Adam step on ``[cpu, cpu]`` against the JAX TP step
    with ``remat=True`` on two devices, within PERF.md §2's bounds."""
    want = _jax_remat_step(arch)
    cfg = _port_config(arch, remat=True)
    _s, model, opt, step = _port_tp_step(cfg, want["initial"], 2)
    loss = step(torch_batch(_batch()))
    assert_step_matches(_Whole(model), opt, loss, want, weights_tol=1e-5)


# -- --grad-accum -------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_tp_accum_step_matches_the_jax_tp_accum_step(n, remat):
    """``--grad-accum 2`` of the UNet under TP over ``[cpu] * n``, with and
    without ``--remat``, against the JAX TP accumulation step on n
    devices over the same two chunks: each chunk runs through the sharded
    model, its statistics K1's on the whole predictions under
    ``--kernels cuda`` (whose plain version runs here; the JAX TP runs the
    plain loss under its mesh, the same function), pass 2 feeds the
    global cotangent. The loss, the gradients before Adam and the weights
    after it within PERF.md §2's bounds."""
    want = _jax_accum_step(n)
    cfg = _port_config("unet", kernels="cuda", grad_accum=2, remat=remat)
    strategy, model, opt, _step = _port_tp_step(cfg, want["initial"], n)
    step = strategy.build_accum_train_step(model, opt,
                                           get_kernel_policy("cuda"))
    chunks = [torch_batch(_batch(seed)) for seed in (1, 2)]
    loss = step(chunks)
    assert_step_matches(_Whole(model), opt, loss, want, weights_tol=1e-5)


# -- the CLI ------------------------------------------------------------------


@pytest.mark.parametrize("flag", [["--steps-per-dispatch", "2"],
                                  ["--remat"], ["--grad-accum", "2"],
                                  ["--remat", "--dtype", "bf16_params"]])
def test_cli_trains_tp_under_each_run_control_flag(tmp_path, monkeypatch,
                                                   flag):
    """``-t TP --device cpu`` (two channel slices of the CPU) with each flag
    of the run control trains its epoch, evaluates to a finite val loss
    and writes whole tensors under the reference names, with a manifest
    that says ``1x2x1``."""
    monkeypatch.chdir(tmp_path)
    argv = [a for a in CLI if a not in ("--dtype", "f32")]
    assert run_cli(["-t", "TP", "-e", "1", *flag, *argv]) == 0
    saved = checkpoint.load_native(str(tmp_path / "checkpoints" / "TP.pt"))
    assert saved["manifest"]["topology"]["mesh_spec"] == "1x2x1"
    assert list(saved["model"]["encoder.conv1.conv_block.0.weight"].shape
                ) == [8, 3, 3, 3]
    assert np.isfinite(saved["records"]["val_rows"][-1][1])
