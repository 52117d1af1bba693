"""The port's run control under ``-t SP`` against the JAX package's, on the
CPU at tests/test_torch_spatial.py's size (widths (8, 16), 32 × 16
images, ``-b 4``, float32): K steps per dispatch, ``--remat`` and
``--grad-accum``.

The port's row shards run on ``[cpu] * n``, each shard in a thread of its
own; the JAX reference is its SP strategy on ``jax.devices()[:n]``
(conftest's virtual CPU devices), whose multi-step scans K steps, whose
``remat=True`` step checkpoints the forward and whose accumulation step
sums two chunks. Weights cross with ``checkpoint.params_from_jax``;
inputs are numpy arrays made from seeds. PERF.md §2's bounds hold: the
loss within 1e-5, each gradient before Adam within 1e-4 of its tensor's
largest, the running statistics and the weights after Adam within 1e-5
(``torch_parallel_parity.assert_step_matches``). On the CPU the K-step
dispatch is K plain steps; tests/test_torch_cuda.py holds its CUDA graph
bitwise against the eager steps on the card."""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.config import TrainConfig as JaxTrainConfig
from distributedpytorch_tpu.ops.optim import adam_l2
from distributedpytorch_tpu.parallel import strategy as jax_strategy
from distributedpytorch_tpu.train import Trainer as JaxTrainer
from distributedpytorch_tpu.train.steps import TrainState
from distributedpytorch_tpu_torch import checkpoint
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.models.unet import Conv2d
from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
from distributedpytorch_tpu_torch.parallel import spatial
from distributedpytorch_tpu_torch.parallel.spatial import (
    RowSharded,
    ShardMeeting,
)
from distributedpytorch_tpu_torch.parallel.strategy import build_strategy
from distributedpytorch_tpu_torch.train.loop import Trainer
from test_torch_dp import _within
from test_torch_graph_strategies import _port_bf16_params, _seeded_f32
from test_torch_spatial import (
    ARCHS,
    CLI,
    CPU,
    LR,
    SHARDS,
    H,
    W,
    WIDTHS,
    B,
    _batch,
    _jax_config,
    _jax_init,
    _port_config,
    _port_sp_step,
)
from torch_parallel_parity import make_batch as parity_batch
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


def _jax_sp(arch, n, **kw):
    """The JAX SP strategy on ``n`` devices and the seeded weights' state
    under Adam behind a gradient capture (``capture_then``)."""
    strategy = jax_strategy.build_strategy(_jax_config(arch, **kw),
                                           devices=jax.devices()[:n])
    assert dict(strategy.mesh.shape) == {"spatial": n}
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
    """The JAX SP multi-step of K steps over ``_stack()``: its losses and
    the state after both steps."""
    strategy, model, tx, state, initial = _jax_sp(arch, n,
                                                  steps_per_dispatch=K)
    new, losses = strategy.build_multi_train_step(model, tx)(
        state, strategy.place_stacked_batch(_stack()))
    return _after(new, state.model_state, initial,
                  losses=np.asarray(losses).tolist())


@functools.cache
def _jax_remat_step(arch):
    """The JAX SP step built with ``remat=True`` on two devices."""
    strategy, model, tx, state, initial = _jax_sp(arch, 2, remat=True)
    new, loss = strategy.build_train_step(model, tx)(
        state, strategy.place_batch(_batch()))
    return _after(new, state.model_state, initial, loss=float(loss))


@functools.cache
def _jax_accum_step(n):
    """The JAX SP accumulation step of the UNet over the two chunks of
    ``_stack()`` on ``n`` devices."""
    strategy, model, tx, state, initial = _jax_sp("unet", n, grad_accum=2)
    new, loss = strategy.build_accum_train_step(model, tx)(
        state, strategy.place_stacked_batch(_stack()))
    return _after(new, None, initial, loss=float(loss))


def _keep_last_grads(opt):
    """``opt`` (``FirstGrads``) keeps the gradients of its latest step, as
    the JAX capture's state does over a scan of K steps."""
    step = opt.step

    def last():
        opt.grads = None
        step()

    opt.step = last


def _assert_state_matches(model, want):
    """Every weight after Adam within 1e-5 relative with an absolute floor
    of 1e-3 × lr per step taken (``assert_step_matches``' floor), the
    running statistics within 1e-5 of their largest."""
    for key, value in model.state_dict().items():
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


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sp_k_steps_match_the_jax_sp_multi_step(arch, n):
    """``--steps-per-dispatch 2`` under SP over ``[cpu] * n`` (the
    strategy's multi-step around its own train step: K plain steps here)
    against the JAX SP multi-step on n devices over the same stack: both
    losses within 1e-5, the second step's gradients before Adam within
    1e-4 of each tensor's largest, the weights and milesial's running
    statistics after both steps as ``_assert_state_matches`` holds
    them."""
    want = _jax_multi(arch, n)
    cfg = _port_config(arch, kernels="cuda", steps_per_dispatch=K)
    strategy, model, opt, step = _port_sp_step(cfg, want["initial"], n)
    _keep_last_grads(opt)
    multi = strategy.build_multi_train_step(step)
    assert multi.steps == K and multi.devices == [CPU]
    losses = multi({k: torch.from_numpy(v) for k, v in _stack().items()})
    assert losses.shape == (K,)
    np.testing.assert_allclose(losses.numpy(), want["losses"], rtol=1e-5)
    for name, g in opt.grads.items():
        err = max_err_rel_to_max(g.numpy(), want["grads"][name].numpy())
        assert err <= 1e-4, (name, err)
    _assert_state_matches(model, want["final"])


def test_one_k2_epoch_matches_k1_and_the_jax_sp_trainer(tmp_path):
    """``Trainer`` under ``-t SP`` on ``[cpu, cpu]`` for milesial, so the
    shards meet at every BatchNorm, at ``steps_per_dispatch=2``:
    --synthetic 24 -v 25 -b 4, 5 steps (two stacks and a tail of one), 1
    val batch. The losses, the weights and the running statistics
    bitwise equal to the same epoch at K = 1, and the losses and the val
    metrics within 1e-4 of the JAX trainer's SP at ``steps_per_dispatch
    =2`` (its 8 CPU devices), as tests/test_torch_graph_strategies.py
    holds DP."""
    common = dict(epochs=1, batch_size=B, val_percent=25.0, seed=42,
                  image_size=(W, H), model_widths=WIDTHS,
                  synthetic_samples=24, metric_every_steps=1, num_workers=0,
                  s2d_levels=0, train_method="SP", dtype="f32",
                  model_arch="milesial")
    jtrainer = JaxTrainer(JaxTrainConfig(
        async_checkpoint=False, kernels="xla", steps_per_dispatch=K,
        checkpoint_dir=str(tmp_path / "jax" / "checkpoints"),
        log_dir=str(tmp_path / "jax" / "logs"),
        loss_dir=str(tmp_path / "jax" / "loss"), **common))
    initial = checkpoint.params_from_jax(
        jax.device_get(jtrainer.state.params),
        jax.device_get(jtrainer.state.model_state))
    jresult = jtrainer.train()
    runs = {}
    for k in (K, 1):
        trainer = Trainer(TrainConfig(
            device="cpu", kernels="cuda", steps_per_dispatch=k,
            checkpoint_dir=str(tmp_path / f"k{k}" / "checkpoints"),
            log_dir=str(tmp_path / f"k{k}" / "logs"),
            loss_dir=str(tmp_path / f"k{k}" / "loss"), **common),
            initial_state=initial, devices=[CPU, CPU])
        runs[k] = (trainer, trainer.train())
    (t2, r2), (t1, r1) = runs[K], runs[1]
    assert r2["steps"] == r1["steps"] == jresult["steps"] == 5
    assert t2.multi_step is not None and t2.multi_step.step is t2.train_step
    assert t1.multi_step is None
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


# -- --remat ------------------------------------------------------------------


def _counting(monkeypatch):
    """``counts``: the meetings of the shards before and after each
    forward of ``RowSharded`` returned (``backward``: a recompute that
    met), and the recomputes that took their kept halo rows."""
    counts = {"forward": 0, "backward": 0, "kept_halos": 0}
    # set by the caller's thread while the shards' threads run the forward
    in_forward = threading.Event()
    meet, forward = ShardMeeting.meet, RowSharded.forward
    around = spatial.KeptHalo.around

    def counted_meet(self, *args):
        counts["forward" if in_forward.is_set() else "backward"] += 1
        return meet(self, *args)

    def counted_forward(self, images):
        in_forward.set()
        try:
            return forward(self, images)
        finally:
            in_forward.clear()

    def counted_around(self, x):
        counts["kept_halos"] += 1
        return around(self, x)

    monkeypatch.setattr(ShardMeeting, "meet", counted_meet)
    monkeypatch.setattr(RowSharded, "forward", counted_forward)
    monkeypatch.setattr(spatial.KeptHalo, "around", counted_around)
    return counts


def _halo_convs(model):
    return sum(isinstance(m, Conv2d) and m.kernel_size == (3, 3)
               for m in model.modules())


@pytest.mark.parametrize("policy", ["torch", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sp_remat_step_is_bitwise_the_plain_sp_step(monkeypatch, arch,
                                                    policy):
    """One Adam step on ``[cpu, cpu]`` with and without ``--remat``, each
    on a thread joined within 60 s: the loss, every gradient and the
    state after the step (running statistics moved once) bitwise equal.
    Under remat each shard recomputes every 3×3 conv around the halo rows
    it kept, and its BatchNorms on the moments they kept: the shards meet
    only in the first forward, as often as without remat, and never in
    the backward, where autograd recomputes both shards on one thread."""
    from distributedpytorch_tpu_torch.models import create_model

    initial = create_model(_port_config(arch), generator=torch.Generator(
        ).manual_seed(0)).state_dict()
    runs = {}
    for remat in (False, True):
        counts = _counting(monkeypatch)
        cfg = _port_config(arch, kernels=policy, remat=remat)
        _s, model, opt, step = _port_sp_step(cfg, initial, 2)
        loss = _within(60, lambda: step(torch_batch(_batch())))
        runs[remat] = (float(loss), opt.grads, model.state_dict(),
                       dict(counts), _halo_convs(model))
        monkeypatch.undo()
    (l0, g0, s0, c0, convs), (l1, g1, s1, c1, _) = runs[False], runs[True]
    assert l1 == l0
    for name, g in g0.items():
        assert torch.equal(g1[name], g), name
    for key, value in s0.items():
        assert torch.equal(s1[key], value), key
    bns = 6 if arch == "milesial" else 0  # at widths (8, 16)
    assert c0 == {"forward": 2 * (convs + bns), "backward": 0,
                  "kept_halos": 0}
    assert c1 == {"forward": c0["forward"], "backward": 0,
                  "kept_halos": 2 * convs}


@pytest.mark.parametrize("arch", ARCHS)
def test_sp_remat_step_matches_the_jax_sp_remat_step(arch):
    """One ``--remat`` Adam step on ``[cpu, cpu]`` against the JAX SP step
    with ``remat=True`` on two devices, within PERF.md §2's bounds."""
    want = _jax_remat_step(arch)
    cfg = _port_config(arch, remat=True)
    _s, model, opt, step = _port_sp_step(cfg, want["initial"], 2)
    loss = _within(60, lambda: step(torch_batch(_batch())))
    assert_step_matches(model, opt, loss, want, weights_tol=1e-5)


def test_a_meeting_after_the_forward_raises_and_never_waits(monkeypatch):
    """The forward closes its meeting: a closed meeting met directly
    raises, and so does a recompute that would meet again
    (``ShardMeeting.keep`` made to keep nothing), within the timeout
    instead of waiting for a shard that never comes. Under bf16_params
    every shard, the first too, is a copy of the model that still holds
    the meeting in its backward."""
    meeting = ShardMeeting([CPU, CPU])
    meeting.close()
    with pytest.raises(RuntimeError, match="after the forward"):
        meeting.with_halo(torch.zeros(1, 2, 4, 4))
    monkeypatch.setattr(ShardMeeting, "keep", lambda self, x: None)
    _model, _opt, _grads, step = _port_bf16_params(
        "SP", _seeded_f32(), [CPU, CPU], remat=True)
    with pytest.raises(RuntimeError, match="met the others after the "
                                           "forward"):
        _within(60, lambda: step(torch_batch(parity_batch())))


# -- --grad-accum -------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("n", SHARDS)
def test_sp_accum_step_matches_the_jax_sp_accum_step(n, remat):
    """``--grad-accum 2`` of the UNet under SP over ``[cpu] * n``, with
    and without ``--remat``, against the JAX SP accumulation step on n
    devices over the same two chunks: each chunk's statistics are the
    shards' sums (K1 per shard under ``--kernels cuda``, whose plain
    version runs here), pass 2 feeds each shard the global cotangent. The
    loss, the gradients before Adam and the weights after it within
    PERF.md §2's bounds."""
    want = _jax_accum_step(n)
    cfg = _port_config("unet", kernels="cuda", grad_accum=2, remat=remat)
    strategy, model, opt, _step = _port_sp_step(cfg, want["initial"], n)
    step = strategy.build_accum_train_step(model, opt,
                                           get_kernel_policy("cuda"))
    chunks = [torch_batch(_batch(seed)) for seed in (1, 2)]
    loss = _within(60, lambda: step(chunks))
    assert_step_matches(model, opt, loss, want, weights_tol=1e-5)


@pytest.mark.parametrize("method", ["SP", "DDP_SP"])
def test_milesial_accumulation_is_refused_with_the_jax_words(method):
    """milesial under ``--grad-accum 2`` raises the JAX accumulation
    step's stateless-models message, word for word, from the strategy's
    check and from its accumulation step."""
    from distributedpytorch_tpu_torch.models import create_model

    strategy, model, tx, _state, _i = _jax_sp("milesial", 2, grad_accum=2)
    with pytest.raises(ValueError) as jax_err:
        strategy.build_accum_train_step(model, tx)
    with pytest.raises(ValueError) as port_err:
        build_strategy(_port_config("milesial", train_method=method,
                                    grad_accum=2), devices=[CPU, CPU])
    assert str(port_err.value) == str(jax_err.value)
    cfg = _port_config("milesial")
    sp = build_strategy(cfg, devices=[CPU, CPU])
    model = sp.place_model(create_model(cfg))
    with pytest.raises(ValueError) as step_err:
        sp.build_accum_train_step(
            model, torch.optim.SGD(model.parameters(), lr=0.0),
            get_kernel_policy("torch"))
    assert str(step_err.value) == str(jax_err.value)


# -- the CLI ------------------------------------------------------------------


@pytest.mark.parametrize("flag", [["--steps-per-dispatch", "2"],
                                  ["--remat"], ["--grad-accum", "2"]])
def test_cli_trains_sp_under_each_run_control_flag(tmp_path, monkeypatch,
                                                   flag):
    """``-t SP --device cpu`` (two row shards of the CPU) with each flag
    of the run control trains its epoch, evaluates and writes the SP
    artifacts, with a manifest that says ``1x2x1@sp``."""
    monkeypatch.chdir(tmp_path)
    assert run_cli(["-t", "SP", "-e", "1", *flag, *CLI]) == 0
    for path in ("logs/SP.log", "checkpoints/SP.pt", "checkpoints/SP.pth",
                 "loss/SP/train_loss.pkl", "loss/SP/val_loss.pkl",
                 "loss/SP/val_dice.pkl"):
        assert (tmp_path / path).exists(), path
    manifest = checkpoint.load_native(
        str(tmp_path / "checkpoints" / "SP.pt"))["manifest"]
    assert manifest["topology"]["mesh_spec"] == "1x2x1@sp"
