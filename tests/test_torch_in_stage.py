"""In-stage sharding in one process (``-t 1xMxS``, ``parallel/in_stage.py``),
on the CPU at the JAX test's size (16 × 24 images, widths (8, 16),
float32): the step and eval bitwise the flat twin ``1x1x2``, both models
and both schedules; the cut and the device order; the UNet's
``1x2x2@fsdp``/gpipe against the JAX package's in-stage pipeline
(``make_pipeline_value_and_grad_fn(..., mesh_config=...)`` on 4 of its
virtual CPU devices); what the strategy and the CLI refuse before any
group is joined. The data ranks (``2x2x2``, ``2x1x2@fsdp``,
``2x2x2@fsdp``) run in tests/test_torch_in_stage_dist.py."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.config import TrainConfig as JaxTrainConfig
from distributedpytorch_tpu.models import create_model as jax_create_model
from distributedpytorch_tpu.parallel import mesh as jax_mesh
from distributedpytorch_tpu.parallel import strategy as jax_strategy
from distributedpytorch_tpu.parallel.pipeline import (
    make_pipeline_value_and_grad_fn,
)
from distributedpytorch_tpu_torch import cli
from distributedpytorch_tpu_torch.checkpoint import load_native, params_to_jax
from distributedpytorch_tpu_torch.dist import runtime
from distributedpytorch_tpu_torch.models import create_model
from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
from distributedpytorch_tpu_torch.parallel import in_stage, mesh
from distributedpytorch_tpu_torch.parallel import strategy as port_strategy
from distributedpytorch_tpu_torch.parallel.zero import ZeroSharded
from distributedpytorch_tpu_torch.train.steps import (
    STACKS_CONFLICT,
    STATEFUL_ACCUM,
)
from torch_parallel_parity import (
    CPU,
    H,
    W,
    make_batch,
    max_err_rel_to_max,
    port_config,
    port_step,
    run_cli,
    to_port,
    torch_batch,
)

ARCHS = ["unet", "milesial"]
SCHEDULES = ["gpipe", "1f1b"]
B = 4  # 2 microbatches of 2
CLI = ["--synthetic", "16", "--image-size", str(W), str(H),
       "--model-widths", "8", "16", "-b", "2", "-v", "25", "--device",
       "cpu", "--num-workers", "0", "--s2d-levels", "0", "--dtype", "f32"]


def _initial(arch):
    return create_model(port_config(arch),
                        generator=torch.Generator().manual_seed(3)
                        ).state_dict()


def _whole_grads(model, optimizer):
    """``{reference name: gradient}`` as Adam is about to read them, filled
    by a step pre-hook at the first step (pieces put together whole)."""
    grads = {}

    def hook(opt, _args, _kwargs):
        if grads:
            return
        params = [p for g in opt.param_groups for p in g["params"]]
        values = [p.grad for p in params]
        if isinstance(model, ZeroSharded):
            grads.update(zip(model.whole_param_names(),
                             model.whole_values(values)))
        else:
            grads.update((n, g.clone()) for (n, _), g in
                         zip(model.named_parameters(), values))

    optimizer.inner.register_step_pre_hook(hook)
    return grads


def _step(arch, spec, schedule, initial, batch, **kw):
    pattern = mesh.parse_mesh_spec(spec)
    cfg = port_config(arch, train_method=spec, batch_size=B,
                      pipeline_schedule=schedule, **kw)
    strategy, model, opt, step = port_step(
        cfg, initial, devices=[CPU] * (pattern.model * pattern.stage))
    grads = _whole_grads(model, opt)
    loss = step(batch)
    return strategy, model, loss, grads


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("spec", ["1x2x2", "1x2x2@fsdp"])
def test_in_stage_step_is_bitwise_its_flat_twin(spec, schedule, arch):
    """One step of ``spec`` and of ``1x1x2`` from the same weights on the
    same batch: the loss, every gradient before Adam (the leaves'
    gradients cut to their pieces and put together again), every weight
    after Adam and milesial's running statistics bitwise equal; then the
    eval step's metrics bitwise equal; between steps and after eval no
    whole leaf is alive, and each cut parameter is two pieces of half
    its out-channels."""
    initial = _initial(arch)
    batch = torch_batch(make_batch(B, seed=5))
    runs = {}
    for method in ("1x1x2", spec):
        strategy, model, loss, grads = _step(arch, method, schedule,
                                             initial, batch)
        metrics = strategy.build_eval_step(
            model, get_kernel_policy("torch"))(batch)
        runs[method] = (strategy, model, loss, grads,
                        strategy.model_state(model), metrics)
    twin, new = runs["1x1x2"], runs[spec]
    assert type(new[0]) is port_strategy.InStagePipeline
    assert new[0].name == spec
    assert new[0].mesh_shape() == {"model": 2, "stage": 2}
    assert torch.equal(new[2], twin[2])
    assert list(new[3]) == list(twin[3])
    for name, g in twin[3].items():
        assert torch.equal(new[3][name], g), name
    assert list(new[4]) == list(twin[4])
    for key, value in twin[4].items():
        assert torch.equal(new[4][key].cpu(), value.cpu()), key
    for key in ("loss", "dice"):
        assert torch.equal(new[5][key], twin[5][key]), key
    sharded = new[1]
    assert sharded._leaves == []
    assert all(getattr(o.module, o.attr) is None
               for o in sharded._owners if o.cut is not None)
    for owner in sharded._owners:
        pieces = [sharded.pieces[i] for i in owner.pieces]
        if owner.cut is None:
            assert len(pieces) == 1 and owner.shape[0] == 1  # the head
            continue
        assert len(pieces) == 2 and not owner.cut.over_ranks
        dim = owner.cut.out_dim
        assert pieces[0].shape[dim] * 2 == owner.shape[dim]


def test_the_cut_follows_state_leaf_spec_and_the_mesh_order(monkeypatch):
    """Each parameter's cut is the port's ``state_leaf_spec``: under
    ``2x2x2@fsdp`` the out-channels (dim 1 of a transposed conv's weight)
    over the model axis and dim 0 of the slice over 'data', under
    ``2x1x2@fsdp`` dim 0 over 'data' where it divides (the head stays
    whole), under ``1x2x2`` the channels alone. The places are the mesh's
    (data, model, stage) order, stage fastest: ``-t 2x2x2`` at LOCAL_RANK
    1 on 8 cards computes stage s on ``cuda:4+s`` and cuts it over
    ``cuda:4+s`` and ``cuda:6+s``."""
    model = create_model(port_config("unet"))
    transposed = {n for n, m in model.named_modules()
                  if isinstance(m, torch.nn.ConvTranspose2d)}
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert in_stage.place_devices(cuda, 2, 2, 0) == [cuda[0], cuda[2]]
    assert in_stage.place_devices(cuda, 2, 2, 1) == [cuda[1], cuda[3]]
    for spec in ("2x2x2@fsdp", "2x1x2@fsdp", "1x2x2"):
        cfg = mesh.parse_mesh_spec(spec)
        for name, p in model.named_parameters():
            layer, attr = name.rsplit(".", 1)
            out_dim = 1 if layer in transposed and attr == "weight" else 0
            cut = in_stage.leaf_cut(cfg, p.shape, out_dim, cuda[:2])
            if spec == "2x1x2@fsdp":
                want = dataclasses.replace(cfg, params="fsdp+channel")
            else:
                want = cfg
            spec_axes = mesh.state_leaf_spec(want, p.shape, out_dim)
            if not any(spec_axes):
                assert cut is None, (spec, name)
                continue
            channel = "model" in spec_axes[out_dim]
            assert cut.places == (tuple(cuda[:2]) if channel
                                  else (cuda[0],)), (spec, name)
            assert cut.home == cuda[0] and cut.out_dim == out_dim
            assert cut.over_ranks == ("data" in spec_axes[0]), (spec, name)
    head = [n for n, p in model.named_parameters() if p.shape[0] == 1]
    assert head == ["segmap.weight", "segmap.bias"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    cls, cfg, devices = port_strategy.plan_mesh(
        port_config("unet", train_method="2x2x2", device="cuda",
                    batch_size=2),
        2, runtime.RuntimeInfo(1, 2, local_rank=1))
    assert cls is port_strategy.InStageHybridPipeline
    assert devices == [torch.device("cuda", 4 + i) for i in range(4)]
    assert cfg.num_stages == 2


def test_the_in_stage_specs_and_what_stays_refused(monkeypatch):
    """The class each in-stage point runs as, its name, mesh (the JAX
    axes in (data, model, stage) order) and whether its checkpoint is a
    collective; ``1x1x2@fsdp`` stays the flat pipeline (ZeRO over one
    rank is nothing); ``2x1x2@fsdp`` builds under ``--remat``, and
    under ``--grad-accum`` is refused in the JAX pipeline's words, and
    ``2x2x2@sp`` in JAX's words, none joining a group."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    info = runtime.RuntimeInfo(0, 2)
    for spec, world, cls, gathers in (
            ("1x2x2", 1, port_strategy.InStagePipeline, False),
            ("1x2x2@fsdp", 1, port_strategy.InStagePipeline, False),
            ("2x2x2", 2, port_strategy.InStageHybridPipeline, False),
            ("2x1x2@fsdp", 2, port_strategy.InStageHybridPipeline, True),
            ("2x2x2@fsdp", 2, port_strategy.InStageHybridPipeline, True)):
        cfg = mesh.parse_mesh_spec(spec)
        strategy = port_strategy.build_strategy(
            port_config("unet", train_method=spec, batch_size=2),
            info if world == 2 else None,
            [CPU] * (cfg.model * cfg.stage))
        assert type(strategy) is cls and strategy.name == spec
        assert list(strategy.mesh_shape().items()) == list(
            jax_mesh.axis_layout(jax_mesh.parse_mesh_spec(spec)))
        assert strategy.gathers_state is gathers
        assert strategy.places == [CPU] * (cfg.model * cfg.stage)
        assert strategy.devices == [CPU, CPU]
    flat = port_strategy.build_strategy(
        port_config("unet", train_method="1x1x2@fsdp"), None, [CPU, CPU])
    assert type(flat).__mro__[2] is port_strategy.Pipeline
    remat = port_strategy.build_strategy(
        port_config("unet", train_method="2x1x2@fsdp", remat=True,
                    batch_size=2), info, [CPU] * 2)
    assert type(remat) is port_strategy.InStageHybridPipeline
    with pytest.raises(ValueError,
                       match="raise --microbatches instead of --grad-accum"):
        port_strategy.build_strategy(
            port_config("unet", train_method="2x1x2@fsdp", grad_accum=2),
            info)
    with pytest.raises(ValueError, match="spatial.*not executable"):
        port_strategy.build_strategy(
            port_config("unet", train_method="2x2x2@sp"), info)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("spec", ["1x2x2", "2x2x2", "2x1x2@fsdp",
                                  "2x2x2@fsdp"])
@pytest.mark.parametrize("flag,kw,beside,beside_kw,said", [
    (["--steps-per-dispatch", "2"], dict(steps_per_dispatch=2),
     ["--grad-accum", "2"], dict(grad_accum=2), STACKS_CONFLICT),
    (["--remat"], dict(remat=True),
     ["--model", "milesial", "--grad-accum", "2"],
     dict(model_arch="milesial", grad_accum=2), STATEFUL_ACCUM),
    (["--grad-accum", "2"], dict(grad_accum=2), [], {},
     port_strategy.PIPELINE_ACCUM),
    (["--dtype", "bf16_params"], dict(dtype="bf16_params"),
     ["--steps-per-dispatch", "2", "--grad-accum", "2"],
     dict(steps_per_dispatch=2, grad_accum=2), STACKS_CONFLICT)])
def test_the_run_control_of_in_stage_sharding_is_refused(
        spec, flag, kw, beside, beside_kw, said, monkeypatch):
    """Under in-stage sharding the K-step graph, ``--remat`` and ``--dtype
    bf16_params`` build their point's class
    (tests/test_torch_in_stage_run_control.py trains them); what stays
    refused is refused in the JAX package's words, in the strategy and at
    the CLI, before any group is joined: ``--grad-accum``, which every
    pipeline refuses ("raise --microbatches"), and beside each lifted
    flag what every method refuses (``--grad-accum`` with K > 1,
    milesial's ``--grad-accum``); and over a gloo group on a card the
    K-step graph."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    info = runtime.RuntimeInfo(0, 2) if spec.startswith("2") else None
    if "grad_accum" not in kw:
        strategy = port_strategy.build_strategy(
            port_config("unet", train_method=spec, batch_size=2, **kw),
            info, [CPU] * 4)
        pattern = mesh.parse_mesh_spec(spec)
        assert strategy.name == spec
        assert strategy.step_devices == [CPU] * (pattern.model
                                                 * pattern.stage)
    cfg = port_config("unet", train_method=spec, batch_size=2,
                      **{**kw, **beside_kw})
    with pytest.raises(ValueError, match="^" + re.escape(said[:40])):
        port_strategy.build_strategy(cfg, info, [CPU] * 4)
    with pytest.raises(SystemExit, match=re.escape(said[:40])):
        cli.main(["-t", spec, *CLI, *flag, *beside])
    with pytest.raises(ValueError, match="over a gloo group on cuda:0"):
        port_strategy.check_run_control(
            port_config("unet", train_method=spec, steps_per_dispatch=2,
                        **{k: v for k, v in kw.items()
                           if k not in ("grad_accum", "steps_per_dispatch")}),
            torch.device("cuda", 0), "gloo")
    assert not torch.distributed.is_initialized()


def test_unet_matches_the_jax_in_stage_pipeline():
    """``1x2x2@fsdp``/gpipe from the port's seeded weights (converted by
    ``checkpoint.params_to_jax``) against the JAX package's in-stage
    pipeline on its ``{model: 2, stage: 2}`` mesh on the same batch,
    without the faithful scale: the loss within 1e-5, every gradient
    within 1e-4 of its tensor's largest (a factor of 2 fails it)."""
    spec, schedule = "1x2x2@fsdp", "gpipe"
    initial = _initial("unet")
    data = make_batch(B, seed=7)
    _s, model, loss, grads = _step("unet", spec, schedule, initial,
                                   torch_batch(data),
                                   faithful_loss_scaling=False)
    jcfg = JaxTrainConfig(train_method=spec, batch_size=B, dtype="f32",
                          kernels="xla", model_arch="unet",
                          model_widths=(8, 16), image_size=(W, H),
                          s2d_levels=0, pipeline_schedule=schedule)
    jmodel, _init = jax_create_model(jcfg)
    strat = jax_strategy.build_strategy(jcfg, devices=jax.devices()[:4])
    assert dict(strat.mesh.shape) == {"model": 2, "stage": 2}
    fn = make_pipeline_value_and_grad_fn(
        jmodel, strat.mesh, num_microbatches=2, schedule=schedule,
        mesh_config=strat.mesh_config)
    params, _stats = params_to_jax(initial)
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    jbatch = {"image": jnp.asarray(data["image"]),
              "mask": jnp.asarray(data["mask"].astype(np.float32))[..., None]}
    jloss, jgrads, _ = jax.jit(fn)(params, None, jbatch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = to_port(jgrads, None)
    assert set(grads) == set(want)
    for name, g in grads.items():
        err = max_err_rel_to_max(g.numpy(), want[name].numpy())
        assert err <= 1e-4, (name, err)
        assert max_err_rel_to_max(2 * g.numpy(), want[name].numpy()) > 1e-4


def test_the_cli_trains_an_epoch_under_1x2x2(tmp_path, monkeypatch):
    """``python -m distributedpytorch_tpu_torch -t 1x2x2 --model milesial
    --pipeline-schedule 1f1b`` in one process: it exits 0, writes the
    checkpoint, the weights and the loss tables, and the manifest's
    topology is JAX's for the spec, the mesh in (model, stage) order."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.chdir(tmp_path)
    assert run_cli(["-t", "1x2x2", "--model", "milesial",
                    "--pipeline-schedule", "1f1b", "-e", "1", *CLI]) == 0
    for name in ("checkpoints/1x2x2.pt", "checkpoints/1x2x2.pth",
                 "loss/1x2x2/train_loss.pkl"):
        assert (tmp_path / name).exists(), name
    topology = load_native(str(tmp_path / "checkpoints" / "1x2x2.pt")
                           )["manifest"]["topology"]
    assert topology["strategy"] == topology["mesh_spec"] == "1x2x2"
    assert list(topology["mesh"].items()) == [("model", 2), ("stage", 2)]
    assert not torch.distributed.is_initialized()
