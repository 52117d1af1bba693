"""The run control of in-stage sharding in one process (``-t 1x2x2`` and
``1x2x2@fsdp``, ``parallel/in_stage.py``), on the CPU at the JAX test's
size (16 × 24 images, widths (8, 16), float32 unless ``bf16_params``),
both models and both schedules, each rank's four places ``[cpu] * 4``:

* ``--steps-per-dispatch 2`` (on the CPU K plain steps through the
  strategy's multi-step) bitwise two plain steps of its flat twin
  ``1x1x2`` (whose plain steps are the spec's, tests/test_torch_in_stage.py);
* ``--remat`` bitwise the plain step, with one gather a step, at its
  top, and a recompute in the backward;
* ``--dtype bf16_params`` bitwise the twin's step (loss, gradients, the
  state after Adam, the f32 masters): the step's leaves are float32, each
  gpipe microbatch computes with casts of its own (1f1b's units add at
  the leaves), and the gradients land in the masters of the pieces;
* the CLI trains an epoch under each flag, and the manifest's topology
  keeps the spec's values.

The data ranks (``2x2x2``, ``2x1x2@fsdp``, ``2x2x2@fsdp``) run in
tests/test_torch_in_stage_run_control_dist.py."""

import contextlib

import pytest
import torch

from distributedpytorch_tpu_torch import models
from distributedpytorch_tpu_torch.checkpoint import load_native
from distributedpytorch_tpu_torch.models import create_model
from distributedpytorch_tpu_torch.ops import precision
from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
from distributedpytorch_tpu_torch.ops.optim import make_optimizer
from distributedpytorch_tpu_torch.parallel import mesh
from distributedpytorch_tpu_torch.parallel import strategy as port_strategy
from distributedpytorch_tpu_torch.parallel.zero import ZeroSharded
from distributedpytorch_tpu_torch.parallel.strategy import build_strategy
from test_torch_in_stage import CLI
from torch_parallel_parity import (
    CPU,
    LR,
    make_batch,
    port_config,
    run_cli,
    torch_batch,
)

ARCHS = ["unet", "milesial"]
SCHEDULES = ["gpipe", "1f1b"]
SPECS = ["1x2x2", "1x2x2@fsdp"]
TWIN = "1x1x2"
B = 4  # 2 microbatches of 2
MICROBATCHES = 2


def _build(spec, arch, schedule, **kw):
    """``spec``'s strategy on ``[cpu] * M·S``, the model from the seed's
    float32 weights placed by it, Adam (over f32 masters under
    ``bf16_params``, seeded before the parameters are rounded, as the
    trainer does) and the train step; and ``grads``, the gradients Adam
    reads at its first step, whole under the reference names."""
    pattern = mesh.parse_mesh_spec(spec)
    cfg = port_config(arch, train_method=spec, batch_size=B,
                      pipeline_schedule=schedule,
                      num_microbatches=MICROBATCHES, **kw)
    strategy = build_strategy(cfg, devices=[CPU] * (pattern.model
                                                    * pattern.stage))
    policy = precision.get_policy(cfg)
    model = create_model(cfg, generator=torch.Generator().manual_seed(3),
                         cast_params=False)
    model = strategy.place_model(model)
    opt = make_optimizer(model.parameters(), LR, cfg.weight_decay,
                         policy=policy)
    precision.cast_params_(model, policy)
    step = strategy.build_train_step(model, opt, get_kernel_policy("torch"))
    grads = {}

    def first_grads(optimizer, _args, _kwargs):
        if grads:
            return
        values = [p.grad for g in optimizer.param_groups
                  for p in g["params"]]
        if isinstance(model, ZeroSharded):
            grads.update(zip(model.whole_param_names(),
                             model.whole_values(values)))
        else:
            grads.update((n, g.clone()) for (n, _), g in
                         zip(model.named_parameters(), values))

    opt.register_step_pre_hook(first_grads)
    return strategy, model, opt, step, grads


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one CPU thread: the steps are small, and the suite's
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(n):
    return [torch_batch(make_batch(B, seed=5 + i)) for i in range(n)]


def _masters(model, opt):
    """The f32 masters, whole under the reference order."""
    masters = list(getattr(opt, "master", ()))
    if masters and isinstance(model, ZeroSharded):
        return model.whole_values(masters)
    return masters


def _assert_same_run(a, b):
    """Two runs' losses, first gradients, states after the last step and
    masters bit for bit (``a``, ``b``: ``(losses, grads, state,
    masters)``)."""
    assert torch.equal(a[0], b[0])
    assert list(a[1]) == list(b[1])
    for name, g in b[1].items():
        assert torch.equal(a[1][name], g), name
    assert list(a[2]) == list(b[2])
    for key, value in b[2].items():
        assert torch.equal(a[2][key], value), key
    assert len(a[3]) == len(b[3])
    for x, y in zip(a[3], b[3]):
        assert torch.equal(x, y)


def _plain_run(spec, arch, schedule, n, **kw):
    strategy, model, opt, step, grads = _build(spec, arch, schedule, **kw)
    losses = torch.stack([step(b) for b in _batches(n)])
    return (losses, grads, strategy.model_state(model),
            _masters(model, opt))


@contextlib.contextmanager
def _counting(counts):
    """Within the block ``counts`` counts ``ZeroSharded.gather_`` calls
    (``gathers``, and those made with grad off or inside a backward,
    ``gathers_in_backward``), the recomputes (``models.recomputing``
    entered) and the casts ``precision.PerUseCasts`` hands out (``casts``),
    as tests/test_torch_mesh_run_control.py's ``_counting`` does."""
    gather, recomputing = ZeroSharded.gather_, models.recomputing
    of = precision.PerUseCasts.of
    inside = {"backward": False}

    def counted_gather(self, *args, **kwargs):
        counts["gathers"] += 1
        counts["gathers_in_backward"] += inside["backward"]
        return gather(self, *args, **kwargs)

    @contextlib.contextmanager
    def counted_recomputing(module):
        counts["recomputes"] += 1
        inside["backward"] = True
        try:
            with recomputing(module):
                yield
        finally:
            inside["backward"] = False

    def counted_of(self, p):
        counts["casts"] += 1
        return of(self, p)

    ZeroSharded.gather_ = counted_gather
    models.recomputing = counted_recomputing
    precision.PerUseCasts.of = counted_of
    try:
        yield
    finally:
        ZeroSharded.gather_ = gather
        models.recomputing = recomputing
        precision.PerUseCasts.of = of


def _counts():
    return {"gathers": 0, "gathers_in_backward": 0, "recomputes": 0,
            "casts": 0}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("spec", SPECS)
def test_k2_is_bitwise_two_plain_steps(spec, schedule, arch):
    """``--steps-per-dispatch 2``: the strategy's multi-step over every
    place (``step_devices``) of ``spec`` on a stack of two batches gives
    the losses, the first gradients and the state of two plain steps of
    ``1x1x2``, bit for bit."""
    strategy, model, opt, step, grads = _build(spec, arch, schedule,
                                               steps_per_dispatch=2)
    assert strategy.step_devices == [CPU] * 4
    multi = strategy.build_multi_train_step(step)
    batches = _batches(2)
    losses = multi({k: torch.stack([b[k] for b in batches])
                    for k in batches[0]})
    assert losses.shape == (2,)
    got = (losses, grads, strategy.model_state(model), _masters(model, opt))
    # bitwise the twin's, which is bitwise the spec's own
    # (tests/test_torch_in_stage.py)
    _assert_same_run(got, _plain_run(TWIN, arch, schedule, 2))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("spec", SPECS)
def test_remat_is_bitwise_the_plain_step(spec, schedule, arch):
    """``--remat``: one step bitwise the plain step of ``spec``; the step
    gathers once, at its top, and no
    recompute gathers (each stage is recomputed in the backward on the
    leaves gathered at the top, the recompute meeting no one)."""
    counts = _counts()
    strategy, model, opt, step, grads = _build(spec, arch, schedule,
                                               remat=True)
    with _counting(counts):
        loss = step(_batches(1)[0])
    got = (loss.reshape(1), grads, strategy.model_state(model),
           _masters(model, opt))
    assert counts["gathers"] == 1 and counts["gathers_in_backward"] == 0
    # every stage recomputed, once per microbatch (1f1b: its phase-B unit)
    assert counts["recomputes"] >= 2 * MICROBATCHES
    assert model._leaves == []
    _assert_same_run(got, _plain_run(spec, arch, schedule, 1))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("spec", SPECS)
def test_bf16_params_leaves_are_float32_into_the_masters(spec, schedule,
                                                         arch):
    """``--dtype bf16_params``: the pieces are bf16 and their f32 masters
    live in the optimizer; during the step every leaf the stages read
    from is float32 (the bf16 pieces widened); gpipe gives each
    microbatch's use of each tensor a cast of its own (1f1b none: each
    unit's backward adds at the leaf in float32); after the step no leaf
    is alive, and the loss, the gradients Adam reads, the state and the
    masters are bitwise the ``1x1x2`` twin's, whose uses of each
    parameter add in float32 (``precision.PerUseCasts``)."""
    counts = _counts()
    strategy, model, opt, step, grads = _build(spec, arch, schedule,
                                               dtype="bf16_params")
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert all(m.dtype == torch.float32 for m in opt.master)
    leaf_dtypes = set()

    def probe(_stage, _args):
        leaf_dtypes.update(t.dtype for t in model._leaves)

    hook = strategy.stages[0].register_forward_pre_hook(probe)
    with _counting(counts):
        loss = step(_batches(1)[0])
    hook.remove()
    assert leaf_dtypes == {torch.float32}
    read = len(model._owners)  # each tensor a stage reads, once a use
    assert counts["casts"] == (MICROBATCHES * read if schedule == "gpipe"
                               else 0)
    assert model._leaves == [] and model._sources is None
    got = (loss.reshape(1), grads, strategy.model_state(model),
           _masters(model, opt))
    assert all(g.dtype == torch.float32 for g in grads.values())
    _assert_same_run(got, _plain_run(TWIN, arch, schedule, 1,
                                     dtype="bf16_params"))


@pytest.mark.parametrize("flag", [["--steps-per-dispatch", "2"],
                                  ["--remat"],
                                  ["--dtype", "bf16_params"]])
def test_the_cli_trains_an_epoch_under_each_flag(flag, tmp_path,
                                                 monkeypatch):
    """``python -m distributedpytorch_tpu_torch -t 1x2x2@fsdp FLAG`` in one
    process exits 0 and writes the checkpoint, whose manifest keeps the
    spec's topology (strategy, mesh in (model, stage) order, mesh spec)
    and records the flag's policy."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.chdir(tmp_path)
    spec = "1x2x2@fsdp"
    argv = [a for a in CLI if a not in ("--dtype", "f32")]
    # 8 samples: one train batch of 2 a stack (K = 2) or a step, 2 val
    argv[argv.index("--synthetic") + 1] = "8"
    assert run_cli(["-t", spec, "-e", "1", *argv, *flag]) == 0
    manifest = load_native(str(tmp_path / "checkpoints" / f"{spec}.pt")
                           )["manifest"]
    topology = manifest["topology"]
    assert topology["strategy"] == topology["mesh_spec"] == spec
    assert list(topology["mesh"].items()) == [("model", 2), ("stage", 2)]
    assert manifest["dtype"] == ("bf16_params" if "bf16_params" in flag
                                 else "bf16")
    assert isinstance(build_strategy(
        port_config("unet", train_method=spec, batch_size=2),
        devices=[CPU] * 4), port_strategy.InStagePipeline)
    assert not torch.distributed.is_initialized()
