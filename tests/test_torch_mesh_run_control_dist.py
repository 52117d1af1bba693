"""The run control of the flat new geometries over two gloo ranks, on the
CPU at a small size (widths (8, 16), 16 × 24 images, float32, ``-b 2`` a
rank, each rank on ``[cpu, cpu]``): ``--steps-per-dispatch K``,
``--remat``, the UNet's ``--grad-accum`` and ``--dtype bf16_params``
under ``2x2x1`` (data × channel), ``2x2x1@fsdp`` (ZeRO × channel) and
``2x2x1@sp+fsdp`` (ZeRO over row shards).

* Within the port, bitwise: K = 2 (on the CPU K plain steps) and
  ``--remat`` against two plain steps at each point, and each ZeRO point
  against its twin under the same flag (``2x2x1@fsdp`` against
  ``2x2x1``, ``2x2x1@sp+fsdp`` against ``2x2x1@sp``): the losses, every
  gradient before Adam, the state after each call (milesial's running
  statistics included) and under ``bf16_params`` the f32 masters.
* Against the JAX package's points on 4 of its virtual CPU devices, fed
  the two ranks' batches joined, five compiles: ``2x2x1``'s UNet
  accumulation and milesial's K = 2 and ``--remat`` (one reference for
  ``2x2x1`` and ``2x2x1@fsdp``, the same function), ``2x2x1@fsdp``'s UNet
  and ``2x2x1@sp+fsdp``'s milesial under ``bf16_params``. The UNet under
  ``@sp+fsdp`` is held to ``2x2x1``'s accumulation, never to JAX's
  ``2x2x1@sp+fsdp`` step, whose backward XLA miscompiles on the CPU
  (tests/test_torch_zero_spatial_dist.py).
* The three traps of ZeRO's run control: a ``--remat`` backward issues no
  collective and gathers nothing, the accumulation gathers once and
  reduces once with the ranks' sum, and every sum over the ranks under
  ``bf16_params`` runs in float32.
* Each rank's bytes under ``bf16_params``, rank 0's files resuming under
  singleGPU bitwise, the CLI under ``2x2x1@fsdp --steps-per-dispatch 2``
  and ``2x2x1@sp+fsdp --remat``.

The ranks run every scenario in one launch of
``tests/torch_ddp_worker.py``, started in the background while the JAX
references compute."""

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
from distributedpytorch_tpu.parallel import strategy as jax_strategy
from distributedpytorch_tpu.train.steps import TrainState
from distributedpytorch_tpu_torch import checkpoint
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.parallel.zero import is_cut
from distributedpytorch_tpu_torch.train.loop import Trainer
from test_torch_fsdp_run_control import (
    BF16_GRADS_NORM_RATIO,
    _median_norm_ratio,
)
from test_torch_graph_strategies import _assert_masters_match
from test_torch_mesh_dist import (
    CLI,
    EPOCH,
    LR,
    WIDTHS,
    WORLD,
    B,
    H,
    W,
    _Background,
    _batch,
    _jax_config,
    _jax_init,
)
from torch_parallel_parity import capture_then, max_err_rel_to_max, to_port

ARCHS = ["unet", "milesial"]
POINTS = ["2x2x1", "2x2x1@fsdp", "2x2x1@sp+fsdp"]
TWIN = {"2x2x1@fsdp": "2x2x1", "2x2x1@sp+fsdp": "2x2x1@sp"}
K = 2
RUNS = {"plain": {}, "k2": dict(steps_per_dispatch=K),
        "remat": dict(remat=True), "accum": dict(grad_accum=2),
        "bf16p": dict(dtype="bf16_params", kernels="torch")}
#: the runs whose ZeRO point is held bitwise against its twin
FLAGS = ["k2", "remat", "accum", "bf16p"]


def _batches(run):
    """Two global batches (of the two ranks' rows), one under
    bf16_params."""
    return [_batch(B * WORLD, seed) for seed in
            ((1,) if run == "bf16p" else (1, 2))]


def _runs(arch):
    return [r for r in RUNS if not (arch == "milesial" and r == "accum")]


def _jobs(tmp):
    jobs = {}
    for arch in ARCHS:
        _m, params, model_state = _jax_init(arch)
        initial = to_port(params, model_state)
        for spec in [*POINTS, "2x2x1@sp"]:
            for run in _runs(arch):
                if spec == "2x2x1@sp" and run == "plain":
                    continue
                jobs[f"{run}-{spec}-{arch}"] = {
                    "kind": "pipeline_steps", "method": spec,
                    "initial": initial, "batches": _batches(run),
                    "count": True,
                    "config": {**dict(model_arch=arch, model_widths=WIDTHS,
                                      dtype="f32", kernels="cuda",
                                      batch_size=B, learning_rate=LR,
                                      image_size=(W, H), s2d_levels=0),
                               **RUNS[run]}}
    for name, spec, arch, kw in (
            ("trainer-bf16p", "2x2x1@sp+fsdp", "milesial",
             dict(dtype="bf16_params", remat=True)),
            ("trainer-k2", "2x2x1@fsdp", "unet",
             dict(steps_per_dispatch=K))):
        _m, params, model_state = _jax_init(arch)
        jobs[name] = {"kind": "trainer", "method": spec,
                      "dir": str(tmp / name),
                      "initial": to_port(params, model_state),
                      "config": dict(EPOCH, model_arch=arch, **kw)}
    # last: a CLI run leaves the group (the second joins one of its own)
    for name, argv in (
            ("z-cli-fsdp-k2", ["-t", "2x2x1@fsdp", "--steps-per-dispatch",
                               "2"]),
            ("z-cli-sp-fsdp-remat", ["-t", "2x2x1@sp+fsdp", "--remat"])):
        jobs[name] = {"kind": "cli", "dir": str(tmp / name),
                      "argv": [*argv, *CLI]}
    return jobs


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_run_control")
    return _Background(tmp / "job", _jobs(tmp))


def _stacked():
    batches = _batches("plain")
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _jax_run(arch, spec, **kw):
    """The JAX ``spec`` strategy on 4 virtual devices with ``kw``, its
    model, Adam behind a gradient capture and the seeded state,
    placed."""
    strategy = jax_strategy.build_strategy(_jax_config(arch, spec, **kw),
                                           devices=jax.devices()[:4])
    model, params, model_state = _jax_init(arch)
    tx = capture_then(adam_l2(LR))
    state = strategy.place_state(TrainState(
        params=params, opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32), model_state=model_state))
    return strategy, model, tx, state


def _jax_accum():
    """JAX ``2x2x1``'s UNet accumulation over the two global batches as
    its two chunks: the loss and the gradients Adam read."""
    strategy, model, tx, state = _jax_run("unet", "2x2x1", grad_accum=2)
    new, loss = strategy.build_accum_train_step(model, tx)(
        state, strategy.place_stacked_batch(_stacked()))
    return float(loss), to_port(new.opt_state[0], None)


def _jax_multi():
    """JAX ``2x2x1``'s milesial multi-step of K steps over the two global
    batches: the losses and the state after both."""
    strategy, model, tx, state = _jax_run("milesial", "2x2x1",
                                          steps_per_dispatch=K)
    new, losses = strategy.build_multi_train_step(model, tx)(
        state, strategy.place_stacked_batch(_stacked()))
    return (np.asarray(losses).tolist(),
            to_port(new.params, new.model_state))


def _jax_remat():
    """JAX ``2x2x1``'s milesial step with ``remat=True``, twice: the
    losses, the first step's gradients and the state after both."""
    strategy, model, tx, state = _jax_run("milesial", "2x2x1", remat=True)
    step = strategy.build_train_step(model, tx)
    losses, grads = [], None
    for batch in _batches("remat"):
        state, loss = step(state, strategy.place_batch(batch))
        losses.append(float(loss))
        grads = grads or to_port(state.opt_state[0], state.model_state)
    return losses, grads, to_port(state.params, state.model_state)


def _jax_bf16_params(arch, spec):
    """One JAX ``spec`` step under bf16_params from the seeded f32
    weights on the first global batch: the loss, the f32 gradients Adam
    read and the masters after the step."""
    cfg = _jax_config(arch, spec, dtype="bf16_params")
    strategy = jax_strategy.build_strategy(cfg, devices=jax.devices()[:4])
    model, params, model_state = _jax_init(arch)
    tx = with_master_weights(capture_then(adam_l2(LR)))
    state = strategy.place_state(TrainState(
        params=jax_policy(cfg).cast_params(params),
        opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
        model_state=model_state))
    state, loss = strategy.build_train_step(model, tx)(
        state, strategy.place_batch(_batches("bf16p")[0]))
    return (float(loss), to_port(state.opt_state.inner[0], model_state),
            to_port(state.opt_state.master, model_state))


@pytest.fixture(scope="module")
def jax_refs(background):
    """The five JAX references, computed while the ranks run."""
    return {"accum": _jax_accum(), "k2": _jax_multi(),
            "remat": _jax_remat(),
            "bf16p-unet": _jax_bf16_params("unet", "2x2x1@fsdp"),
            "bf16p-milesial": _jax_bf16_params("milesial", "2x2x1@sp+fsdp")}


@pytest.fixture(scope="module")
def ranks(background, jax_refs):
    return background.result()


def _assert_ranks_equal(r0, r1):
    assert torch.equal(r0["losses"], r1["losses"])
    for name, g in r0["grads"].items():
        assert torch.equal(g, r1["grads"][name]), name
    for got, other in zip(r0["states"], r1["states"]):
        for key, value in got.items():
            assert torch.equal(value, other[key]), key


def _assert_bitwise(got, want, what):
    """The losses, the first gradients, the state after every call and
    the masters of two runs, bit for bit."""
    assert torch.equal(got["losses"], want["losses"]), what
    assert list(got["grads"]) == list(want["grads"]), what
    for name, g in want["grads"].items():
        assert torch.equal(got["grads"][name], g), (what, name)
    assert len(got["states"]) == len(want["states"]), what
    for mine, theirs in zip(got["states"], want["states"]):
        assert list(mine) == list(theirs), what
        for key, value in theirs.items():
            assert torch.equal(mine[key], value), (what, key)
    assert len(got["master"]) == len(want["master"]), what
    for a, b in zip(got["master"], want["master"]):
        assert torch.equal(a, b), what


def _assert_grads_match(got, want):
    """Every gradient before Adam within 1e-4 of its tensor's largest: a
    gradient ``world ×`` too large or too small fails."""
    assert set(got) == {k for k in want if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))}
    for name, g in got.items():
        err = max_err_rel_to_max(g.numpy(), want[name].numpy())
        assert err <= 1e-4, (name, err)


def _assert_state_after_two_steps(state, want):
    """Every weight within 1e-4 of its tensor's largest after two Adam
    steps, the running statistics within 1e-5 of theirs."""
    for key, value in state.items():
        if key.endswith("num_batches_tracked"):
            assert int(value) == K, key
            continue
        err = max_err_rel_to_max(value.numpy(), want[key].numpy())
        assert err <= (1e-5 if "running" in key else 1e-4), (key, err)


# -- within the port, bitwise -------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("spec", POINTS)
def test_k2_and_remat_are_bitwise_the_plain_steps(ranks, spec, arch):
    """At each point, on both ranks, ``--steps-per-dispatch 2`` (one stack
    of the two batches: two plain steps on the CPU) and ``--remat`` (two
    steps) give the plain steps' losses, first gradients and state after
    the two steps (milesial's running statistics included) bit for bit;
    the ranks agree bit for bit."""
    for rank in range(WORLD):
        plain = ranks[rank][f"plain-{spec}-{arch}"]
        for run in ("k2", "remat"):
            got = ranks[rank][f"{run}-{spec}-{arch}"]
            assert torch.equal(got["losses"], plain["losses"]), run
            for name, g in plain["grads"].items():
                assert torch.equal(got["grads"][name], g), (run, name)
            for key, value in plain["states"][-1].items():
                assert torch.equal(got["states"][-1][key], value), (run, key)
    for run in ("plain", "k2", "remat"):
        _assert_ranks_equal(*(r[f"{run}-{spec}-{arch}"] for r in ranks))


@pytest.mark.parametrize("spec,run,arch", [
    (spec, run, arch) for spec in TWIN for run in FLAGS for arch in ARCHS
    if not (arch == "milesial" and run == "accum")])
def test_each_zero_point_is_bitwise_its_twin(ranks, spec, run, arch):
    """Each ZeRO point under each flag against its twin under the same
    flag (``2x2x1@fsdp`` against ``2x2x1``, ``2x2x1@sp+fsdp`` against
    ``2x2x1@sp``), on both ranks: the losses, every gradient before Adam
    (whole, under the reference names), the state after every call and
    the f32 masters under ``bf16_params`` bit for bit. The gather is a
    copy and each sum over the ranks is a sum of two; under
    ``bf16_params`` the leaves are the widened pieces, each use computes
    with its own bf16 cast, and the f32 gradients are reduce-scattered as
    the twin all-reduces its f32 master gradients."""
    for r in ranks:
        _assert_bitwise(r[f"{run}-{spec}-{arch}"],
                        r[f"{run}-{TWIN[spec]}-{arch}"], (spec, run, arch))
    _assert_ranks_equal(*(r[f"{run}-{spec}-{arch}"] for r in ranks))


# -- against the JAX package --------------------------------------------------


@pytest.mark.parametrize("spec", POINTS)
def test_the_unet_accumulation_matches_the_jax_package(ranks, jax_refs,
                                                       spec):
    """``--grad-accum 2`` of the UNet over the two global batches as its
    chunks against JAX ``2x2x1``'s accumulation step: the loss within
    1e-5 relative and every gradient before Adam within 1e-4 of its
    tensor's largest, so the ranks' sum taken as their mean (or doubled)
    fails. ``2x2x1@sp+fsdp`` computes the same function as ``2x2x1``
    (JAX's own ``2x2x1@sp`` accumulation is 2e-7 off ``2x2x1``'s)."""
    jloss, jgrads = jax_refs["accum"]
    r0 = ranks[0][f"accum-{spec}-unet"]
    assert r0["losses"].shape == (1,)
    np.testing.assert_allclose(float(r0["losses"][0]), jloss, rtol=1e-5)
    _assert_grads_match(r0["grads"], jgrads)


@pytest.mark.parametrize("spec", ["2x2x1", "2x2x1@fsdp"])
def test_milesial_k2_matches_the_jax_multi_step(ranks, jax_refs, spec):
    """milesial's K = 2 stack against JAX ``2x2x1``'s multi-step over the
    same global batches: both losses within 1e-5 relative, the state
    after both steps as ``_assert_state_after_two_steps`` holds it (the
    running statistics within 1e-5)."""
    jlosses, jstate = jax_refs["k2"]
    r0 = ranks[0][f"k2-{spec}-milesial"]
    np.testing.assert_allclose(r0["losses"].numpy(), jlosses, rtol=1e-5)
    assert len(r0["states"]) == 1
    _assert_state_after_two_steps(r0["states"][-1], jstate)


def test_milesial_remat_under_zero_matches_the_jax_remat_steps(ranks,
                                                               jax_refs):
    """Two ``--remat`` steps of milesial under ``2x2x1@fsdp``, whose
    recompute normalizes with the global moments its forward kept,
    against JAX ``2x2x1``'s steps built with ``remat=True``: the losses
    within 1e-5 relative, the first gradients within 1e-4 of each
    tensor's largest, the state after both steps within 1e-4 (running
    statistics 1e-5)."""
    jlosses, jgrads, jstate = jax_refs["remat"]
    r0 = ranks[0]["remat-2x2x1@fsdp-milesial"]
    np.testing.assert_allclose(r0["losses"].numpy(), jlosses, rtol=1e-5)
    _assert_grads_match(r0["grads"], jgrads)
    _assert_state_after_two_steps(r0["states"][-1], jstate)


@pytest.mark.parametrize("spec,arch", [("2x2x1@fsdp", "unet"),
                                       ("2x2x1@sp+fsdp", "milesial")])
def test_bf16_params_matches_the_jax_package(ranks, jax_refs, spec, arch):
    """One ``bf16_params`` step against JAX's ``with_master_weights`` step
    at the same point on the same global batch: the loss within 1e-3
    relative (bf16 convolutions), the f32 gradients Adam read at the JAX
    gradients' scale (``BF16_GRADS_NORM_RATIO``: a ``world ×`` factor
    fails), the masters after Adam by ``_assert_masters_match``, every
    parameter bf16 and its master rounded; the ranks bitwise equal."""
    jloss, jgrads, jmaster = jax_refs[f"bf16p-{arch}"]
    r0, r1 = (r[f"bf16p-{spec}-{arch}"] for r in ranks)
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


# -- the three traps of ZeRO's run control ------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("spec", POINTS)
def test_a_remat_backward_issues_no_collective(ranks, spec, arch):
    """Two ``--remat`` steps issue the collectives of two plain steps,
    each kind as often (milesial's moments are all-reduced in the forward
    only: its recompute takes the global moments it kept), gather the
    whole parameters once a step (none under ``2x2x1``) and recompute
    segment by segment, at least once per segment a step (the UNet's 5
    and milesial's 3 at widths (8, 16)). A recompute
    around the ZeRO model's whole forward would gather again in the
    backward."""
    for r in ranks:
        plain = r[f"plain-{spec}-{arch}"]["counts"]
        remat = r[f"remat-{spec}-{arch}"]["counts"]
        for kind in ("all_reduce", "all_gather_into_tensor",
                     "reduce_scatter_tensor", "gathers", "reductions"):
            assert remat[kind] == plain[kind], kind
        assert remat["gathers"] == (0 if spec == "2x2x1" else 2)
        assert plain["recomputes"] == 0
        segments = {"unet": 5, "milesial": 3}[arch]
        assert remat["recomputes"] >= 2 * segments, remat["recomputes"]


@pytest.mark.parametrize("spec", ["2x2x1@fsdp", "2x2x1@sp+fsdp"])
def test_the_accumulation_gathers_once_and_sums_the_ranks(ranks, jax_refs,
                                                          spec):
    """One ``--grad-accum 2`` step gathers the whole parameters once and
    cuts the gradients back once, both passes running on one set of
    leaves, and its gradients are the ranks' sum: within 1e-4 of each
    tensor's largest of JAX ``2x2x1``'s accumulation, where their mean
    (half) or twice the sum fails."""
    _, jgrads = jax_refs["accum"]
    for r in ranks:
        got = r[f"accum-{spec}-unet"]
        assert got["counts"]["gathers"] == 1
        assert got["counts"]["reductions"] == 1
        _assert_grads_match(got["grads"], jgrads)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("spec", POINTS)
def test_bf16_params_sums_over_the_ranks_in_float32(ranks, spec, arch):
    """Under ``bf16_params`` every sum over the ranks (the all-reduces of
    the statistics, the moments and the gradients, the reduce-scatters)
    takes float32 tensors, and the f32 gradients land in the masters':
    the pieces' gradients Adam reads are bitwise the twin's (or, at
    ``2x2x1``, the f32 master gradients ``_mean_over_ranks`` averaged),
    and every master moved."""
    for r in ranks:
        got = r[f"bf16p-{spec}-{arch}"]
        assert got["counts"]["summed_dtypes"] == {"torch.float32"}
        assert got["counts"]["gathers"] == (0 if spec == "2x2x1" else 1)
        assert all(g.dtype == torch.float32 for g in got["grads"].values())
        assert any(g.abs().max() > 0 for g in got["grads"].values())


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_piece_under_bf16_params(ranks, arch):
    """Under ``2x2x1@sp+fsdp --dtype bf16_params`` each rank holds 14 B a
    value (a bf16 piece, its f32 master and Adam's two f32 moments) of
    half of every parameter whose dim 0 divides the world and of the
    whole head, the twin every value; under ``2x2x1@fsdp`` the four
    (rank, slice) places add up to the whole but for the head kept on
    every rank."""
    whole = ranks[0][f"bf16p-2x2x1@sp-{arch}"]["grads"]
    cut = sum(g.numel() for g in whole.values() if is_cut(g.shape, WORLD))
    kept = sum(g.numel() for g in whole.values()
               if not is_cut(g.shape, WORLD))
    places = []
    for r in ranks:
        mine, _ = r[f"bf16p-2x2x1@sp+fsdp-{arch}"]["bytes"]
        assert mine == cut // WORLD * 14 + kept * 14
        assert r[f"bf16p-2x2x1@sp-{arch}"]["bytes"][0] == (cut + kept) * 14
        held = r[f"bf16p-2x2x1@fsdp-{arch}"]["slice_bytes"]
        assert held["whole_leaves"] == 0
        places += list(held["held"].values())
    assert len(places) == 4
    assert sum(places) == (cut + kept) * 14 + kept * 14


# -- the files and the CLI ----------------------------------------------------


def test_rank_zeros_bf16_params_file_resumes_under_singlegpu_bitwise(
        ranks, tmp_path, caplog):
    """A milesial epoch under ``2x2x1@sp+fsdp --dtype bf16_params --remat``
    on two ranks trains to a finite val loss, the ranks agree bitwise,
    and rank 0's file holds the whole bf16 parameters and f32 masters
    under the reference names, each parameter its master rounded; ``-c``
    of it under singleGPU ``bf16_params`` restores the parameters, the
    masters and Adam's moments bitwise."""
    r0, r1 = (r["trainer-bf16p"] for r in ranks)
    assert r0["result"]["steps"] == 4
    assert np.isfinite(r0["result"]["val_loss"])
    assert r0["losses"] == r1["losses"]
    for key, value in r0["state"].items():
        assert torch.equal(value, r1["state"][key]), key
    written = os.path.join(r0["out"], "checkpoints", "2x2x1@sp+fsdp.pt")
    saved = checkpoint.load_native(written)
    assert saved["manifest"]["dtype"] == "bf16_params"
    assert saved["manifest"]["topology"]["mesh_spec"] == "2x2x1@sp+fsdp"
    names = [n for n, t in saved["model"].items()
             if t.dtype == torch.bfloat16]
    masters = saved["optimizer"]["master"]
    assert len(masters) == len(names) > 0
    for name, m in zip(names, masters):
        assert m.dtype == torch.float32
        assert torch.equal(saved["model"][name], m.to(torch.bfloat16)), name
    cfg = TrainConfig(**{**EPOCH, "epochs": 2, "dtype": "bf16_params",
                         "kernels": "torch"},
                      model_arch="milesial", device="cpu",
                      checkpoint_name=written,
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
        assert torch.equal(a.cpu(), b.cpu())
    for i, st in saved["optimizer"]["inner"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(state["inner"]["state"][i][key].cpu(),
                               st[key].cpu()), (i, key)


def test_rank_zeros_k2_file_resumes_under_singlegpu_bitwise(ranks,
                                                            tmp_path):
    """A UNet epoch under ``2x2x1@fsdp --steps-per-dispatch 2`` (two stacks
    of two steps) on two ranks: the ranks agree bitwise, rank 0 alone
    wrote; ``-c`` of its file under singleGPU restores the weights and
    Adam's moments bitwise."""
    r0, r1 = (r["trainer-k2"] for r in ranks)
    assert r0["result"]["steps"] == r1["result"]["steps"] == 4
    assert r0["same_step"]
    assert r0["losses"] == r1["losses"]
    for key, value in r0["state"].items():
        assert torch.equal(value, r1["state"][key]), key
    assert r1["wrote"] == []
    written = os.path.join(r0["out"], "checkpoints", "2x2x1@fsdp.pt")
    saved = checkpoint.load_native(written)
    for key, value in r0["state"].items():
        assert torch.equal(saved["model"][key], value), key
    cfg = TrainConfig(**{**EPOCH, "epochs": 2, "kernels": "torch"},
                      model_arch="unet", device="cpu",
                      checkpoint_name=written,
                      checkpoint_dir=str(tmp_path / "checkpoints"),
                      log_dir=str(tmp_path / "logs"),
                      loss_dir=str(tmp_path / "loss"))
    trainer = Trainer(cfg)
    for key, value in trainer.model.state_dict().items():
        assert torch.equal(value, saved["model"][key]), key
    opt = trainer.optimizer.state_dict()["state"]
    assert len(opt) == len(saved["optimizer"]["state"]) > 0
    for i, st in saved["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt[i][key], st[key]), (i, key)


@pytest.mark.parametrize("name,spec", [
    ("z-cli-fsdp-k2", "2x2x1@fsdp"), ("z-cli-sp-fsdp-remat", "2x2x1@sp+fsdp")])
def test_the_cli_trains_an_epoch(ranks, name, spec):
    """``python -m distributedpytorch_tpu_torch -t 2x2x1@fsdp
    --steps-per-dispatch 2`` and ``-t 2x2x1@sp+fsdp --remat`` on both
    ranks (the group the worker joined stands for torchrun's): each exits
    0, rank 0 alone writes the checkpoint, the ``.pth`` and the loss
    tables, the manifest's topology is JAX's for the spec, and the served
    weights are finite."""
    r0, r1 = (r[name] for r in ranks)
    assert r0["code"] == r1["code"] == 0
    assert r0["wrote"] == [f"checkpoints/{spec}.pt", f"checkpoints/{spec}.pth",
                           f"logs/{spec}.log", f"loss/{spec}/train_loss.pkl",
                           f"loss/{spec}/val_dice.pkl",
                           f"loss/{spec}/val_loss.pkl"]
    assert r1["wrote"] == [f"logs/{spec}.log"]
    topology = r0["manifest"]["topology"]
    assert topology["strategy"] == topology["mesh_spec"] == spec
    assert topology["process_count"] == WORLD
    pth = checkpoint.load_pth(os.path.join(r0["out"], "checkpoints",
                                           f"{spec}.pth"))
    assert all(torch.isfinite(v).all() for v in pth.values()
               if v.is_floating_point())


def test_no_rank_loaded_jax(ranks):
    assert ranks[0]["leaked"] == ranks[1]["leaked"] == []
