"""The run control of the flat new geometries in one process, on the CPU
at a small size (widths (8, 16), 16 × 24 images, float32): under
``2x2x1``, ``2x2x1@fsdp`` and ``2x2x1@sp+fsdp`` the four flags build and
what every method refuses stays refused, before any group is joined;
``parallel/zero.ZeroSharded``'s recompute on the leaves it gathered once
and its float32 leaves under master weights, at one rank; and each
rank's bytes at full width under ``bf16_params``. The two gloo ranks run
in tests/test_torch_mesh_run_control_dist.py."""

import contextlib

import pytest
import torch

from distributedpytorch_tpu_torch import cli, models
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.dist import runtime
from distributedpytorch_tpu_torch.models import create_model
from distributedpytorch_tpu_torch.ops.fused_loss import (
    fused_bce_dice_loss,
    make_row_sharded_loss,
)
from distributedpytorch_tpu_torch.ops.optim import make_optimizer
from distributedpytorch_tpu_torch.ops.precision import (
    cast_params_,
    get_policy,
    per_use_casts,
)
from distributedpytorch_tpu_torch.parallel import strategy as port_strategy
from distributedpytorch_tpu_torch.parallel.channels import ChannelSharded
from distributedpytorch_tpu_torch.parallel.spatial import RowSharded
from distributedpytorch_tpu_torch.parallel.zero import (
    Cut,
    PlainState,
    ZeroSharded,
    is_cut,
)
from distributedpytorch_tpu_torch.train.steps import (
    STACKS_CONFLICT,
    STATEFUL_ACCUM,
    prep_mask,
)
from torch_parallel_parity import CPU, make_batch, port_config, torch_batch

ARCHS = ["unet", "milesial"]
POINTS = {"2x2x1": port_strategy.DataTensorParallel,
          "2x2x1@fsdp": port_strategy.ZeroTensorParallel,
          "2x2x1@sp+fsdp": port_strategy.ZeroSpatial}
FLAGS = [(["--steps-per-dispatch", "2"], dict(steps_per_dispatch=2)),
         (["--remat"], dict(remat=True)),
         (["--grad-accum", "2"], dict(grad_accum=2)),
         (["--dtype", "bf16_params"], dict(dtype="bf16_params"))]
CLI = ["--synthetic", "16", "--image-size", "24", "16", "--model-widths",
       "8", "16", "-b", "2", "-v", "25", "--device", "cpu",
       "--num-workers", "0"]


@pytest.fixture
def no_launcher(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)


@pytest.mark.parametrize("flag,kw", FLAGS)
@pytest.mark.parametrize("spec", POINTS)
def test_the_run_control_builds_at_each_flat_point(spec, flag, kw,
                                                   no_launcher):
    """Under ``2x2x1``, ``2x2x1@fsdp`` and ``2x2x1@sp+fsdp`` each of the
    K-step graph, ``--remat``, the UNet's ``--grad-accum`` and ``--dtype
    bf16_params`` builds its point's class over a rank's ``[cpu, cpu]``,
    over gloo on the CPU too, without joining a group."""
    cfg = port_config("unet", train_method=spec, batch_size=2, **kw)
    strategy = port_strategy.build_strategy(cfg, runtime.RuntimeInfo(0, 2),
                                            [CPU, CPU])
    assert type(strategy) is POINTS[spec] and strategy.name == spec
    assert strategy.step_devices == [CPU, CPU]
    port_strategy.check_run_control(cfg, CPU, "gloo")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("spec", POINTS)
def test_what_every_method_refuses_stays_refused(spec, no_launcher):
    """At each flat point, in JAX's words and before any group is joined:
    ``--grad-accum`` with ``--steps-per-dispatch K > 1`` and milesial's
    ``--grad-accum``, by the strategy and by the CLI; and a K-step graph
    over a gloo group on a card."""
    info = runtime.RuntimeInfo(0, 2)
    for arch, kw, flag, said in (
            ("unet", dict(grad_accum=2, steps_per_dispatch=2),
             ["--grad-accum", "2", "--steps-per-dispatch", "2"],
             STACKS_CONFLICT),
            ("milesial", dict(grad_accum=2),
             ["--model", "milesial", "--grad-accum", "2"], STATEFUL_ACCUM)):
        with pytest.raises(ValueError, match=r"^" + said[:40]):
            port_strategy.build_strategy(
                port_config(arch, train_method=spec, batch_size=2, **kw),
                info, [CPU, CPU])
        with pytest.raises(SystemExit, match=said[:40]):
            cli.main(["-t", spec, *CLI, *flag])
    with pytest.raises(ValueError, match="over a gloo group on cuda:0"):
        port_strategy.check_run_control(
            port_config("unet", train_method=spec, steps_per_dispatch=2),
            torch.device("cuda", 0), "gloo")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("spec", POINTS)
def test_milesial_graph_across_card_ranks_is_refused(spec, no_launcher,
                                                     monkeypatch):
    """Milesial's K-step graph across ranks on cards is refused by the
    trainer's check and by the CLI before any group is joined (from fresh
    NCCL ranks it hung in the capture); on the CPU, at one rank and for
    the UNet it runs."""
    card = port_config("milesial", train_method=spec, steps_per_dispatch=2,
                       device="cuda")
    with pytest.raises(ValueError, match=r"hung in the capture .*Queue C"):
        port_strategy.check_card_graph(card, 2)
    for cfg, world in ((card, 1),
                       (port_config("milesial", train_method=spec,
                                    steps_per_dispatch=2), 2),
                       (port_config("unet", train_method=spec,
                                    steps_per_dispatch=2, device="cuda"), 2),
                       (port_config("milesial", train_method=spec,
                                    device="cuda"), 2)):
        port_strategy.check_card_graph(cfg, world)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    argv = [a for a in CLI if a not in ("--device", "cpu")]
    with pytest.raises(SystemExit, match="hung in the capture"):
        cli.main(["-t", spec, "--model", "milesial",
                  "--steps-per-dispatch", "2", *argv])
    assert not torch.distributed.is_initialized()


def _initial(arch):
    return create_model(port_config(arch), generator=torch.Generator()
                        .manual_seed(0)).state_dict()


def _one_rank(inner, model=None, remat=False):
    """``ZeroSharded`` over ``inner`` at one rank, each parameter one piece
    on the CPU (no collective); ``model`` the plain model a wrapper
    holds."""
    return ZeroSharded(inner, cuts=[Cut(CPU, (CPU,)) for _ in
                                    inner.parameters()],
                       state=None if model is None else PlainState(model),
                       remat=remat)


@contextlib.contextmanager
def _counting(counts):
    """``counts["gathers"]`` counts ``ZeroSharded.gather_`` and
    ``counts["recomputes"]`` the recomputes (``models.recomputing``
    entered) within the block."""
    gather, recomputing = ZeroSharded.gather_, models.recomputing

    def counted_gather(self, *args, **kwargs):
        counts["gathers"] += 1
        return gather(self, *args, **kwargs)

    @contextlib.contextmanager
    def counted_recomputing(module):
        counts["recomputes"] += 1
        with recomputing(module):
            yield

    ZeroSharded.gather_, models.recomputing = (counted_gather,
                                               counted_recomputing)
    try:
        yield
    finally:
        ZeroSharded.gather_, models.recomputing = gather, recomputing


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_remat_recomputes_on_the_leaves_it_gathered_once(arch):
    """``ZeroSharded(ChannelSharded, remat=True)`` at one rank on
    ``[cpu, cpu]``: a training forward gathers once, the backward
    recomputes the model segment by segment on those leaves and gathers
    nothing, and the loss and every piece's gradient after
    ``reduce_grads_`` are bitwise those without ``remat``; the running
    statistics move once."""
    cfg = port_config(arch)
    initial = _initial(arch)
    batch = torch_batch(make_batch(2, seed=3))
    target = prep_mask(batch["mask"])
    runs = {}
    for remat in (False, True):
        model = create_model(cfg)
        model.load_state_dict(initial)
        zero = _one_rank(ChannelSharded(model, [CPU, CPU]), remat=remat)
        zero.train()
        counts = {"gathers": 0, "recomputes": 0}
        with _counting(counts):
            loss = fused_bce_dice_loss(zero(batch["image"]), target)
            loss.backward()
        zero.reduce_grads_()
        runs[remat] = (loss, [p.grad for p in zero.pieces], counts,
                       zero.whole_state())
    loss, grads, counts, state = runs[True]
    assert counts["gathers"] == runs[False][2]["gathers"] == 1
    assert runs[False][2]["recomputes"] == 0
    assert counts["recomputes"] == zero.inner.num_segments
    assert torch.equal(loss, runs[False][0])
    for g, want in zip(grads, runs[False][1]):
        assert torch.equal(g, want)
    for key, value in runs[False][3].items():
        assert torch.equal(state[key], value), key


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_bf16_params_leaves_are_float32_into_the_masters(arch):
    """Under master weights ``ZeroSharded`` over ``RowSharded`` at one rank
    on ``[cpu, cpu]`` gathers float32 leaves (the bf16 pieces widened),
    each shard computing with its own bf16 cast of them; after
    ``reduce_grads_`` the pieces hold no gradient and the masters' f32
    gradients are bitwise those of ``RowSharded`` over the whole model
    with per-use casts of its masters (``2x2x1@sp``'s), so no sum ran in
    bf16."""
    cfg = port_config(arch, dtype="bf16_params")
    policy = get_policy(cfg)
    initial = _initial(arch)
    batch = torch_batch(make_batch(2, seed=3))
    target = prep_mask(batch["mask"])
    loss_of = make_row_sharded_loss(False)

    def built():
        model = create_model(cfg, cast_params=False)
        model.load_state_dict(initial)
        return model

    model = built()
    opt = make_optimizer(model.parameters(), 1e-4, policy=policy)
    cast_params_(model, policy)
    rows = RowSharded(model, [CPU, CPU], per_use_casts(opt, model))
    rows.train()
    want = loss_of(rows(batch["image"]), target)
    want.backward()
    want_grads = opt.grads()

    model = built()
    zero = _one_rank(RowSharded(model, [CPU, CPU]), model)
    zopt = make_optimizer(zero.parameters(), 1e-4, policy=policy)
    cast_params_(zero, policy)
    zero.train_with(zopt)
    zero.train()
    preds = zero(batch["image"])
    assert all(leaf.dtype == torch.float32 and leaf.requires_grad
               for leaf in zero._leaves)
    assert all(o.module.__dict__[o.attr].dtype == torch.bfloat16
               for o in zero._owners)
    loss = loss_of(preds, target)
    loss.backward()
    zero.reduce_grads_()
    assert torch.equal(loss, want)
    assert all(p.grad is None for p in zero.pieces)
    got = zopt.master_grads(zero.pieces)
    assert len(got) == len(want_grads)
    for g, w in zip(got, want_grads):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    assert zero._leaves == [] and zero._casts is None


@pytest.mark.parametrize("arch,rank_bytes,twin_bytes", [
    ("unet", 54_320_910, 108_641_358),
    ("milesial", 217_263_886, 434_526_862)])
def test_each_rank_holds_the_predicted_bytes_under_bf16_params(
        arch, rank_bytes, twin_bytes):
    """At full width and D = 2 under ``2x2x1@sp+fsdp --dtype bf16_params``:
    each rank's bf16 pieces, f32 masters and Adam's two f32 moments over
    them, 14 B a value of half of every parameter whose dim 0 divides the
    world and of the whole head; its ``2x2x1@sp`` twin holds every
    value."""
    with torch.device("meta"):  # the shapes alone
        model = create_model(TrainConfig(model_arch=arch, device="cpu"))
    shapes = [p.shape for p in model.parameters()]
    cut = sum(s.numel() for s in shapes if is_cut(s, 2))
    kept = sum(s.numel() for s in shapes if not is_cut(s, 2))
    assert cut // 2 * 14 + kept * 14 == rank_bytes
    assert (cut + kept) * 14 == twin_bytes
