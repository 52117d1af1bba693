"""The run control of in-stage sharding over two gloo ranks (``-t 2x2x2``,
``2x1x2@fsdp``, ``2x2x2@fsdp``, ``parallel/in_stage.py``), each rank on
``[cpu] * 4`` at ``-b 2`` with two microbatches, on the CPU at the JAX
test's size (16 × 24 images, widths (8, 16), float32 unless
``bf16_params``), both models and both schedules, without the faithful
scale.

* Bitwise, each point under each flag against its flat twin ``2x1x2``
  under the same flag, on both ranks: ``--steps-per-dispatch 2`` (one
  stack of two batches: two plain steps on the CPU), ``--remat`` and
  ``--dtype bf16_params`` (one step): the losses, every gradient before
  Adam (whole, under the reference names), the state after every call
  (milesial's running statistics included) and the f32 masters; the
  ranks bitwise equal.
* A ``--remat`` step gathers once and issues the collectives of a plain
  step, none more; under ``bf16_params`` every sum over the ranks takes
  float32 tensors.
* Against the JAX package's in-stage pipeline on its 8 virtual CPU
  devices, fed the two ranks' batches joined, two compiles: the UNet's
  ``2x2x2@fsdp``/1f1b ``--remat`` step against
  ``make_pipeline_value_and_grad_fn(..., remat=True, mesh_config=...)``
  (loss 1e-5, gradients 1e-4 of each tensor's largest), and milesial's
  ``2x2x2``/gpipe ``bf16_params`` step against the JAX strategy's step
  under ``with_master_weights`` (loss 1e-3, the masters by
  ``_assert_masters_match``).
* The CLI under ``2x2x2@fsdp`` with all three flags at once.

The ranks run every scenario in one launch of
``tests/torch_ddp_worker.py``, started in the background while the JAX
references compute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.config import TrainConfig as JaxTrainConfig
from distributedpytorch_tpu.models import create_model as jax_create_model
from distributedpytorch_tpu.ops.optim import adam_l2
from distributedpytorch_tpu.ops.precision import get_policy as jax_policy
from distributedpytorch_tpu.ops.precision import with_master_weights
from distributedpytorch_tpu.parallel import strategy as jax_strategy
from distributedpytorch_tpu.parallel.pipeline import (
    make_pipeline_value_and_grad_fn,
)
from distributedpytorch_tpu.train.steps import TrainState
from distributedpytorch_tpu_torch.checkpoint import (
    load_native,
    params_to_jax,
)
from test_torch_graph_strategies import _assert_masters_match
from test_torch_in_stage_dist import (
    CLI,
    LR,
    WIDTHS,
    WORLD,
    B,
    H,
    W,
    _Background,
    _batch,
    _initial,
)
from test_torch_mesh_run_control_dist import (
    _assert_bitwise,
    _assert_grads_match,
    _assert_ranks_equal,
)
from torch_parallel_parity import capture_then, max_err_rel_to_max, to_port

ARCHS = ["unet", "milesial"]
SCHEDULES = ["gpipe", "1f1b"]
POINTS = ["2x2x2", "2x1x2@fsdp", "2x2x2@fsdp"]
TWIN = "2x1x2"
K = 2
RUNS = {"k2": dict(steps_per_dispatch=K), "remat": dict(remat=True),
        "bf16p": dict(dtype="bf16_params", kernels="torch")}
#: the JAX references: the UNet's remat and milesial's bf16_params step
JAX_REMAT = ("unet", "2x2x2@fsdp", "1f1b")
JAX_BF16P = ("milesial", "2x2x2", "gpipe")


def _batches(run):
    """The global batches (of the two ranks' rows): two for a stack of K,
    one otherwise."""
    return [_batch(B * WORLD, seed) for seed in
            ((1, 2) if run == "k2" else (1,))]


def _jobs(tmp):
    jobs = {}
    for arch in ARCHS:
        initial = _initial(arch)
        for schedule in SCHEDULES:
            for spec in [TWIN, *POINTS]:
                # a plain step of each point, for the remat step's counts
                for run, kw in ((r, RUNS.get(r, {})) for r in
                                [*RUNS, *(["plain"] if spec != TWIN
                                          else [])]):
                    jobs[f"{run}-{spec}-{arch}-{schedule}"] = {
                        "kind": "pipeline_steps", "method": spec,
                        "initial": initial, "batches": _batches(run),
                        "count": True,
                        "config": {**dict(
                            model_arch=arch, model_widths=WIDTHS,
                            dtype="f32", kernels="cuda", batch_size=B,
                            learning_rate=LR, image_size=(W, H),
                            num_microbatches=2, pipeline_schedule=schedule,
                            faithful_loss_scaling=False), **kw}}
    argv = [a for a in CLI if a not in ("--dtype", "f32")]
    jobs["z-cli"] = {"kind": "cli", "dir": str(tmp / "cli"),
                     "argv": ["-t", "2x2x2@fsdp", "--steps-per-dispatch",
                              "2", "--remat", "--dtype", "bf16_params",
                              *argv]}
    return jobs


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("in_stage_run_control")
    return _Background(tmp / "job", _jobs(tmp))


def _jax_config(arch, spec, schedule, **kw):
    return JaxTrainConfig(**{**dict(
        train_method=spec, batch_size=B * WORLD, dtype="f32",
        kernels="xla", model_arch=arch, model_widths=WIDTHS,
        image_size=(W, H), s2d_levels=0, learning_rate=LR,
        pipeline_schedule=schedule, num_microbatches=2,
        faithful_loss_scaling=False), **kw})


def _jax_batch(data):
    return {"image": jnp.asarray(data["image"]),
            "mask": jnp.asarray(data["mask"].astype(np.float32))[..., None]}


def _jax_remat():
    """The JAX in-stage pipeline with ``remat=True`` on 8 virtual devices
    from the seeded weights on the joined batch: the loss and the
    gradients (port names)."""
    arch, spec, schedule = JAX_REMAT
    cfg = _jax_config(arch, spec, schedule, remat=True)
    model, _init = jax_create_model(cfg)
    strat = jax_strategy.build_strategy(cfg, devices=jax.devices()[:8])
    assert dict(strat.mesh.shape) == {"data": 2, "model": 2, "stage": 2}
    fn = make_pipeline_value_and_grad_fn(
        model, strat.mesh, num_microbatches=2, schedule=schedule,
        remat=True, mesh_config=strat.mesh_config)
    params, stats = params_to_jax(_initial(arch))
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    loss, grads, _ = jax.jit(fn)(params, None,
                                 _jax_batch(_batches("remat")[0]))
    return float(loss), to_port(grads, None)


def _jax_bf16_params():
    """The JAX strategy's in-stage step under ``bf16_params``
    (``with_master_weights``) from the seeded f32 weights on the joined
    batch: the loss, the f32 gradients Adam read and the masters after
    the step (port names)."""
    arch, spec, schedule = JAX_BF16P
    cfg = _jax_config(arch, spec, schedule, dtype="bf16_params")
    strat = jax_strategy.build_strategy(cfg, devices=jax.devices()[:8])
    model, _init = jax_create_model(cfg)
    params, stats = params_to_jax(_initial(arch))
    params, stats = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                 (params, stats))
    tx = with_master_weights(capture_then(adam_l2(LR)))
    state = strat.place_state(TrainState(
        params=jax_policy(cfg).cast_params(params),
        opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
        model_state=stats))
    state, loss = strat.build_train_step(model, tx)(
        state, strat.place_batch(_batches("bf16p")[0]))
    return (float(loss), to_port(state.opt_state.inner[0], stats),
            to_port(state.opt_state.master, stats))


@pytest.fixture(scope="module")
def jax_refs(background):
    """The two JAX references, computed while the ranks run."""
    return {"remat": _jax_remat(), "bf16p": _jax_bf16_params()}


@pytest.fixture(scope="module")
def ranks(background, jax_refs):
    return background.result()


# -- within the port, bitwise -------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("spec", POINTS)
def test_each_flag_is_bitwise_its_twin(ranks, spec, run, schedule, arch):
    """Each point under each flag against ``2x1x2`` under the same flag,
    on both ranks: the losses, every gradient before Adam, the state
    after every call and the f32 masters under ``bf16_params`` bit for
    bit; the two ranks bitwise equal. The gather is a copy, its backward
    a slice, each sum over the ranks a sum of two; under ``bf16_params``
    the leaves are the widened pieces, each gpipe microbatch computes
    with its own casts of them, and their f32 gradients are reduced as
    the twin reduces its f32 master gradients."""
    name = f"{run}-{spec}-{arch}-{schedule}"
    for r in ranks:
        _assert_bitwise(r[name], r[f"{run}-{TWIN}-{arch}-{schedule}"],
                        name)
        assert r[name]["name"] == spec
        assert r[name]["losses"].shape == ((K,) if run == "k2" else (1,))
        if run == "k2":
            # every place, the stage devices first
            assert r[name]["devices"] == ["cpu"] * (
                4 if spec.startswith("2x2") else 2)
    _assert_ranks_equal(*(r[name] for r in ranks))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("spec", POINTS)
def test_a_remat_step_gathers_once_and_meets_no_one_in_its_backward(
        ranks, spec, arch):
    """A ``--remat`` step (gpipe and 1f1b) issues the collectives of the
    point's plain step, each kind as often: each stage's recompute runs
    on the leaves gathered at the step's top and meets no one. It gathers
    once, reduces once, and recomputes each stage once per microbatch at
    least."""
    for r in ranks:
        for schedule in SCHEDULES:
            plain = r[f"plain-{spec}-{arch}-{schedule}"]["counts"]
            remat = r[f"remat-{spec}-{arch}-{schedule}"]["counts"]
            for kind in ("all_reduce", "all_gather_into_tensor",
                         "reduce_scatter_tensor", "gathers", "reductions"):
                assert remat[kind] == plain[kind], (schedule, kind)
            assert remat["gathers"] == remat["reductions"] == 1
            assert plain["recomputes"] == 0
            assert remat["recomputes"] >= 2 * 2, (schedule,
                                                  remat["recomputes"])


@pytest.mark.parametrize("spec", POINTS)
def test_bf16_params_sums_over_the_ranks_in_float32(ranks, spec):
    """Under ``bf16_params`` every sum over the ranks (the statistics, the
    moments, the gradients' all-reduces and reduce-scatters) takes
    float32 tensors, one gather a step, and the gradients Adam reads are
    float32."""
    for r in ranks:
        for arch in ARCHS:
            for schedule in SCHEDULES:
                got = r[f"bf16p-{spec}-{arch}-{schedule}"]
                assert got["counts"]["summed_dtypes"] == {"torch.float32"}
                assert got["counts"]["gathers"] == 1
                assert all(g.dtype == torch.float32
                           for g in got["grads"].values())


# -- against the JAX package --------------------------------------------------


def test_remat_matches_the_jax_in_stage_pipeline(ranks, jax_refs):
    """The UNet's ``2x2x2@fsdp``/1f1b ``--remat`` step against the JAX
    in-stage pipeline built with ``remat=True``: the loss within 1e-5
    relative, every gradient before Adam within 1e-4 of its tensor's
    largest (twice it fails)."""
    jloss, want = jax_refs["remat"]
    arch, spec, schedule = JAX_REMAT
    for r in ranks:
        got = r[f"remat-{spec}-{arch}-{schedule}"]
        np.testing.assert_allclose(float(got["losses"][0]), jloss,
                                   rtol=1e-5)
        _assert_grads_match(got["grads"], want)
        for name, g in got["grads"].items():
            assert max_err_rel_to_max(2 * g.numpy(),
                                      want[name].numpy()) > 1e-4, name


def test_bf16_params_matches_the_jax_package(ranks, jax_refs):
    """milesial's ``2x2x2``/gpipe ``bf16_params`` step against the JAX
    strategy's in-stage step under ``with_master_weights`` on the joined
    batch: the loss within 1e-3 relative (bf16 convolutions), the masters
    after Adam by ``_assert_masters_match``, every parameter bf16 and its
    master rounded."""
    jloss, _jgrads, jmaster = jax_refs["bf16p"]
    arch, spec, schedule = JAX_BF16P
    for r in ranks:
        got = r[f"bf16p-{spec}-{arch}-{schedule}"]
        np.testing.assert_allclose(float(got["losses"][0]), jloss,
                                   rtol=1e-3)
        state = got["states"][-1]
        names = list(got["grads"])  # the parameters, in the masters' order
        assert len(names) == len(got["master"])
        for name, m in zip(names, got["master"]):
            assert m.dtype == torch.float32, name
            assert state[name].dtype == torch.bfloat16, name
            assert torch.equal(state[name], m.to(torch.bfloat16)), name
            _assert_masters_match(m, jmaster[name], LR)


# -- the CLI ------------------------------------------------------------------


def test_the_cli_trains_an_epoch_under_the_run_control(ranks):
    """``-t 2x2x2@fsdp --steps-per-dispatch 2 --remat --dtype bf16_params``
    on both ranks exits 0; rank 0 alone writes the checkpoint, whose
    manifest keeps the spec's topology (strategy, mesh in (data, model,
    stage) order, mesh spec) and records ``bf16_params``; its weights are
    finite."""
    spec = "2x2x2@fsdp"
    r0, r1 = (r["z-cli"] for r in ranks)
    assert r0["code"] == r1["code"] == 0
    assert f"checkpoints/{spec}.pt" in r0["wrote"]
    assert r1["wrote"] == [f"logs/{spec}.log"]
    topology = r0["manifest"]["topology"]
    assert topology["strategy"] == topology["mesh_spec"] == spec
    assert list(topology["mesh"].items()) == [("data", 2), ("model", 2),
                                              ("stage", 2)]
    assert r0["manifest"]["dtype"] == "bf16_params"
    saved = load_native(f"{r0['out']}/checkpoints/{spec}.pt")
    assert all(torch.isfinite(v).all() for v in saved["model"].values()
               if v.is_floating_point())


def test_no_rank_loaded_jax(ranks):
    assert ranks[0]["leaked"] == ranks[1]["leaked"] == []
