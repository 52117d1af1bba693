"""ZeRO over row shards (``-t DxMx1@sp+fsdp`` with D > 1,
``parallel/strategy.ZeroSpatial``) in one process, on the CPU at a small
size (widths (8, 16), 16 × 24 images, float32): the class each spec runs
as, the shards past the first computing with their own copies of the
gathered leaves, each rank's bytes at full width, and the run control
refused before any group is joined. The two gloo ranks run in
tests/test_torch_zero_spatial_dist.py."""

import threading

import pytest
import torch

from distributedpytorch_tpu.parallel import mesh as jax_mesh
from distributedpytorch_tpu_torch import cli
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.dist import runtime
from distributedpytorch_tpu_torch.models import create_model
from distributedpytorch_tpu_torch.ops.fused_loss import make_row_sharded_loss
from distributedpytorch_tpu_torch.parallel import strategy as port_strategy
from distributedpytorch_tpu_torch.parallel.spatial import (
    RowSharded,
    halo_convs,
)
from distributedpytorch_tpu_torch.parallel.zero import (
    Cut,
    PlainState,
    ZeroSharded,
    is_cut,
)
from distributedpytorch_tpu_torch.train.steps import prep_mask
from torch_parallel_parity import (
    CPU,
    H,
    W,
    make_batch,
    port_config,
    torch_batch,
)

ARCHS = ["unet", "milesial"]
CLI = ["--synthetic", "16", "--image-size", str(W), str(H),
       "--model-widths", "8", "16", "-b", "2", "-v", "25", "--device",
       "cpu", "--num-workers", "0", "--s2d-levels", "0", "--dtype", "f32"]


@pytest.mark.parametrize("spec,world,cls,gathers", [
    ("2x2x1@sp+fsdp", 2, port_strategy.ZeroSpatial, True),
    ("4x2x1@sp+fsdp", 4, port_strategy.ZeroSpatial, True),
    ("2x2x1@sp", 2, port_strategy.HybridDataSpatial, False),
    ("1x2x1@sp+fsdp", 1, port_strategy.SpatialParallel, False)])
def test_the_class_each_spec_runs_as(spec, world, cls, gathers,
                                     monkeypatch):
    """``DxMx1@sp+fsdp`` with D > 1 runs as ``ZeroSpatial`` (DDP_SP's
    devices, its drop_last and over-ranks seams, the lr never scaled, a
    checkpoint every rank gathers); its ``@sp`` twin runs as DDP_SP and
    ``1x2x1@sp+fsdp`` stays SP (ZeRO over one rank is nothing). The
    mesh is JAX's ``axis_layout``, the name the canonical spec; no group
    is joined."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    strategy = port_strategy.build_strategy(
        port_config("unet", train_method=spec, batch_size=2),
        runtime.RuntimeInfo(0, world) if world > 1 else None, [CPU, CPU])
    assert isinstance(strategy, cls)
    assert (type(strategy) is port_strategy.ZeroSpatial) == (
        cls is port_strategy.ZeroSpatial)
    assert strategy.name == spec
    assert list(strategy.mesh_shape().items()) == list(
        jax_mesh.axis_layout(jax_mesh.parse_mesh_spec(spec)))
    assert strategy.gathers_state is gathers
    assert strategy.devices == [CPU, CPU]
    assert strategy.lr_for(1e-4) == 1e-4
    assert strategy.drop_last_train is (world > 1)
    assert strategy.over_ranks is (world > 1)
    assert not torch.distributed.is_initialized()


def _reads(model, shards):
    """A pre-hook on each of ``model``'s 3×3 convs, shared by the shards'
    replicas: ``shards[thread name]`` lists the weight tensors each
    thread's convs read."""
    def hook(module, _args):
        name = threading.current_thread().name
        shards.setdefault(name, []).append(module.weight)

    return [conv.register_forward_pre_hook(hook)
            for conv in halo_convs(model)]


@pytest.mark.parametrize("arch", ARCHS)
def test_the_shards_past_the_first_compute_with_their_own_copies(arch):
    """``ZeroSharded`` over ``RowSharded`` on ``[cpu, cpu]`` (every
    parameter cut into one piece, as one rank holds it): in a training
    forward the first shard reads the gathered leaves and the second a
    copy of each, never the leaf itself (a replica that reads the first
    device's leaf crosses cards on a GPU); the loss, and every piece's
    gradient after ``reduce_grads_``, bitwise those of ``RowSharded``
    over the whole model."""
    cfg = port_config(arch, kernels="cuda")
    initial = create_model(cfg, generator=torch.Generator().manual_seed(0)
                           ).state_dict()
    batch = torch_batch(make_batch(2, seed=3))
    loss_of = make_row_sharded_loss(True)
    target = prep_mask(batch["mask"])

    def whole_run():
        model = create_model(cfg)
        model.load_state_dict(initial)
        rows = RowSharded(model, [CPU, CPU])
        rows.train()
        loss = loss_of(rows(batch["image"]), target)
        loss.backward()
        return loss, {n: p.grad for n, p in model.named_parameters()}

    want_loss, want_grads = whole_run()
    model = create_model(cfg)
    model.load_state_dict(initial)
    zero = ZeroSharded(RowSharded(model, [CPU, CPU]),
                       cuts=[Cut(CPU, (CPU,)) for _ in model.parameters()],
                       state=PlainState(model))
    zero.train()
    shards = {}
    hooks = _reads(model, shards)
    try:
        preds = zero(batch["image"])
    finally:
        for h in hooks:
            h.remove()
    leaves = {id(leaf) for leaf in zero._leaves}
    first = shards.pop(threading.current_thread().name)
    (second,) = shards.values()
    assert len(first) == len(second) == len(halo_convs(model))
    assert all(id(w) in leaves for w in first)
    assert not any(id(w) in leaves for w in second)
    loss = loss_of(preds, target)
    loss.backward()
    zero.reduce_grads_()
    assert torch.equal(loss, want_loss)
    assert zero.whole_param_names() == list(want_grads)
    for path, piece in zip(zero.paths, zero.pieces):
        name = path.removeprefix("module.")
        assert torch.equal(piece.grad, want_grads[name]), name


@pytest.mark.parametrize("arch,cut,kept,rank_bytes", [
    ("unet", 7_760_064, 33, 46_560_780),
    ("milesial", 31_037_568, 65, 186_226_188)])
def test_each_rank_holds_the_predicted_bytes(arch, cut, kept, rank_bytes):
    """At full width and D = 2: the parameters whose dim 0 divides the
    world (``ZeroSharded``'s default cut), the head kept whole, and each
    rank's float32 parameter and Adam bytes (12 a value), half the
    whole's but for the head."""
    with torch.device("meta"):  # the shapes alone
        model = create_model(TrainConfig(model_arch=arch, device="cpu"))
    shapes = [p.shape for p in model.parameters()]
    assert sum(s.numel() for s in shapes if is_cut(s, 2)) == cut
    assert sum(s.numel() for s in shapes if not is_cut(s, 2)) == kept
    assert [s[0] for s in shapes if not is_cut(s, 2)] == [1, 1]
    assert cut // 2 * 12 + kept * 12 == rank_bytes
    # the two ranks hold the whole once, and the head twice
    assert 2 * rank_bytes - (cut + kept) * 12 == kept * 12


@pytest.mark.parametrize("flag,kw", [
    (["--steps-per-dispatch", "2"], dict(steps_per_dispatch=2)),
    (["--remat"], dict(remat=True)),
    (["--grad-accum", "2"], dict(grad_accum=2)),
    (["--dtype", "bf16_params"], dict(dtype="bf16_params"))])
def test_the_run_control_is_refused_naming_item_1c(flag, kw, monkeypatch):
    """Under ``4x2x1@sp+fsdp`` the K-step graph, ``--remat``,
    ``--grad-accum`` and ``--dtype bf16_params`` build ``ZeroSpatial``
    now (tests/test_torch_mesh_run_control_dist.py trains them); under its
    in-stage neighbour ``4x2x2@fsdp`` each is still refused naming the
    ROADMAP's item 1c″, in the strategy and at the CLI, before any group
    is joined."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    info = runtime.RuntimeInfo(0, 4)
    strategy = port_strategy.build_strategy(
        port_config("unet", train_method="4x2x1@sp+fsdp", **kw), info,
        [CPU, CPU])
    assert type(strategy) is port_strategy.ZeroSpatial
    spec = "4x2x2@fsdp"
    pattern = (r"\(in-stage sharding\) is not ported yet.*ROADMAP\.md, "
               r"Queue A, item 1c″")
    with pytest.raises(ValueError, match=pattern):
        port_strategy.build_strategy(
            port_config("unet", train_method=spec, **kw), info, [CPU] * 4)
    with pytest.raises(SystemExit, match=pattern):
        cli.main(["-t", spec, *CLI, *flag])
    assert not torch.distributed.is_initialized()
