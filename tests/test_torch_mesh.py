"""The port's mesh specs in one process, on the CPU at a small size
(widths (8, 16), 16 × 24 images, float32): the grammar
(``parallel/mesh.py``) against the JAX package's ``parallel/mesh.py``,
the one-process spec twins bitwise their legacy strategies, the specs'
semantics, the loud failures of JAX ``test_infeasible_geometries_fail_
loudly`` in the port's terms, the manifest's topology against JAX
``Strategy.topology()``, and what stays refused. The multi-process specs
run over gloo ranks in tests/test_torch_mesh_dist.py."""

import dataclasses
import itertools
import re

import jax
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.config import TrainConfig as JaxTrainConfig
from distributedpytorch_tpu.parallel import mesh as jax_mesh
from distributedpytorch_tpu.parallel import strategy as jax_strategy
from distributedpytorch_tpu_torch import checkpoint, cli
from distributedpytorch_tpu_torch.dist import runtime
from distributedpytorch_tpu_torch.models import create_model
from distributedpytorch_tpu_torch.parallel import mesh
from distributedpytorch_tpu_torch.parallel import strategy as port_strategy
from distributedpytorch_tpu_torch.parallel.channels import ChannelSharded
from distributedpytorch_tpu_torch.parallel.zero import is_cut
from torch_parallel_parity import (
    B,
    CPU,
    H,
    W,
    WIDTHS,
    make_batch,
    port_config,
    port_step,
    torch_batch,
)

ARCHS = ["unet", "milesial"]
#: valid specs and malformed ones, over every grammar branch
SPECS = ["1x1x1", "8x1x1", "8x1x1@fsdp", "1x8x1", "1x8x1@sp", "2x4x1@sp",
         "2x2x1@fsdp", "4x1x2", "2x2x1@tp", "2x2x1@fsdp+tp", "1x2x1@sp+fsdp",
         "2x2x2", "1x1x2@fsdp", "0x1x1", "2x2", "2x2x2x2", "2x2x1@zp",
         "2x2x1@sp+tp", "1x1x1@sp", "x2x1", "2x2x1@", "FSDP", "", "12x1x1"]
CLI = ["--synthetic", "16", "--image-size", str(W), str(H),
       "--model-widths", "8", "16", "-b", "4", "-v", "25", "--device",
       "cpu", "--num-workers", "0", "--s2d-levels", "0", "--dtype", "f32"]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as exc:
        return ("error", str(exc))


# -- the grammar ------------------------------------------------------------------


@pytest.mark.parametrize("spec", SPECS)
def test_grammar_matches_the_jax_package(spec):
    """``is_mesh_spec``, ``parse_mesh_spec`` (every field, or its error word
    for word), ``canonical_spec``, ``axis_layout``, ``spec_is_pipeline``
    and ``spec_is_hybrid`` equal the JAX package's."""
    assert mesh.is_mesh_spec(spec) == jax_mesh.is_mesh_spec(spec)
    assert mesh.spec_is_pipeline(spec) == jax_mesh.spec_is_pipeline(spec)
    assert mesh.spec_is_hybrid(spec) == jax_mesh.spec_is_hybrid(spec)
    kind, got = _outcome(mesh.parse_mesh_spec, spec)
    jkind, want = _outcome(jax_mesh.parse_mesh_spec, spec)
    assert kind == jkind
    if kind == "error":
        assert got == want
        return
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert mesh.canonical_spec(got) == jax_mesh.canonical_spec(want)
    assert mesh.axis_layout(got) == jax_mesh.axis_layout(want)
    assert mesh.parse_mesh_spec(mesh.canonical_spec(got)) == got


def test_mesh_config_and_legacy_patterns_match_the_jax_package():
    """``MeshConfig``'s own checks word for word, its properties, and
    ``LEGACY_PATTERNS`` field for field."""
    for kw in (dict(data=0), dict(params="zero"), dict(model_role="rows")):
        with pytest.raises(ValueError) as got:
            mesh.MeshConfig(**kw)
        with pytest.raises(ValueError) as want:
            jax_mesh.MeshConfig(**kw)
        assert str(got.value) == str(want.value)
    assert (mesh.AXES, mesh.PARAMS_RULES, mesh.MODEL_ROLES) == (
        jax_mesh.AXES, jax_mesh.PARAMS_RULES, jax_mesh.MODEL_ROLES)
    assert set(mesh.LEGACY_PATTERNS) == set(jax_mesh.LEGACY_PATTERNS) == set(
        port_strategy.STRATEGIES)
    for name, cfg in mesh.LEGACY_PATTERNS.items():
        want = jax_mesh.LEGACY_PATTERNS[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want), name
        assert (cfg.size, cfg.model_axis_name, cfg.is_pipeline) == (
            want.size, want.model_axis_name, want.is_pipeline)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_leaf_spec_is_the_cut_the_port_makes(arch):
    """The port's ``state_leaf_spec`` under ``2x2x1@fsdp`` says of every
    parameter what ``ChannelSharded`` and ``zero.is_cut`` do with it: the
    out-channel dim over 'model' where the slices are sharded, dim 0 of
    the slice over 'data' where it is cut. The tensors kept whole on
    every rank are the 1-channel head's, which JAX's own rule keeps
    whole too (its bias) or cuts on an in-channel axis (its kernel);
    ``1x2x1`` cuts the same out-channels with no 'data'."""
    cfg = mesh.parse_mesh_spec("2x2x1@fsdp")
    model = create_model(port_config(arch))
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    transposed = {n for n, m in model.named_modules()
                  if isinstance(m, torch.nn.ConvTranspose2d)}
    sharded = ChannelSharded(model, [CPU, CPU])
    layers = dict(sharded.layers())
    whole_on_every_rank = []
    for name, shape in shapes.items():
        layer, attr = name.rsplit(".", 1)
        out_dim = 1 if layer in transposed and attr == "weight" else 0
        spec = mesh.state_leaf_spec(cfg, shape, out_dim)
        assert mesh.state_leaf_spec(mesh.parse_mesh_spec("1x2x1"), shape,
                                    out_dim) == tuple(
            tuple(a for a in axes if a != "data") for axes in spec)
        slices = layers[layer].whole_tensors()[attr][0]
        assert ("model" in spec[out_dim]) == (len(slices) == 2), name
        assert ("data" in spec[0]) == is_cut(slices[0].shape, 2), name
        if "data" not in spec[0]:
            whole_on_every_rank.append(name)
    head = "segmap" if arch == "unet" else "outc.conv"
    assert whole_on_every_rank == [f"{head}.weight", f"{head}.bias"]
    both = jax_mesh.parse_mesh_spec("2x2x1@fsdp")
    P = jax.sharding.PartitionSpec
    assert jax_mesh.state_leaf_spec(both, (1,)) == P(None)
    assert jax_mesh.state_leaf_spec(both, (1, 1, 8, 1)) == P(
        None, None, "data", None)


# -- the one-process spec twins ---------------------------------------------------

#: each one-process legacy name, its twin at the JAX LEGACY_PATTERNS
#: geometry and the schedules it runs
ONE_PROCESS = [("singleGPU", None), ("TP", None), ("SP", None),
               ("MP", "gpipe"), ("MP", "1f1b")]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("legacy,schedule", ONE_PROCESS)
def test_spec_twin_is_bitwise_the_legacy_strategy(legacy, schedule, arch):
    """One step of the legacy name and of its spec twin from the same
    weights on the same batch, on the same devices: the loss, every
    gradient before Adam and the state after it (milesial's running
    statistics included) bitwise equal; the twin's name is the canonical
    spec, its mesh and topology JAX's."""
    spec = jax_mesh.canonical_spec(jax_mesh.LEGACY_PATTERNS[legacy])
    pattern = mesh.parse_mesh_spec(spec)
    devices = [CPU] * (pattern.model * pattern.stage)
    kw = dict(pipeline_schedule=schedule) if schedule else {}
    initial = create_model(port_config(arch),
                           generator=torch.Generator().manual_seed(3)
                           ).state_dict()
    batch = torch_batch(make_batch(B, seed=5))
    runs = {}
    for method in (legacy, spec):
        strategy, model, opt, step = port_step(
            port_config(arch, train_method=method,
                        ddp_lr_world_size_scaling=False, **kw),
            initial, devices=devices)
        loss = step(batch)
        runs[method] = (strategy, loss, opt.grads,
                        strategy.model_state(model))
    old, new = runs[legacy], runs[spec]
    assert new[0].name == spec and type(new[0]).__mro__[2] is type(old[0])
    assert new[0].mesh_shape() == dict(mesh.axis_layout(pattern))
    assert new[0].lr_for(1e-4) == old[0].lr_for(1e-4) == 1e-4
    assert torch.equal(new[1], old[1])
    assert list(new[2]) == list(old[2])
    for name, g in old[2].items():
        assert torch.equal(new[2][name], g), name
    for key, value in old[3].items():
        assert torch.equal(new[3][key], value), key


def test_semantics_flags_match_the_jax_specs():
    """JAX ``test_semantics_flags_match_legacy`` in the port's terms: a
    spec's ``-b`` is per process and its lr is never scaled, whatever
    ``ddp_lr_world_size_scaling`` says, while DDP keeps the quirk; the
    data axis is the launched world, so a spec's global batch is b × D
    and it drops the ragged batch where D > 1, as JAX's flags say."""
    info = runtime.RuntimeInfo(0, 2)
    for spec in ("2x1x1", "2x2x1", "2x2x1@sp", "2x1x1@fsdp"):
        cfg = port_config("unet", train_method=spec, batch_size=4,
                          ddp_lr_world_size_scaling=True)
        strategy = port_strategy.build_strategy(cfg, info, [CPU] * (
            mesh.parse_mesh_spec(spec).model))
        jcfg = jax_mesh.parse_mesh_spec(spec)
        assert strategy.lr_for(1e-4) == 1e-4 and not jcfg.lr_scaling
        assert strategy.global_batch_size == 4 * 2
        assert strategy.drop_last_train is jcfg.drop_last is True
        assert jcfg.per_process_batch
    ddp = port_strategy.build_strategy(port_config(
        "unet", train_method="DDP", ddp_lr_world_size_scaling=True), info)
    assert ddp.lr_for(1e-4) == pytest.approx(2e-4)
    single = port_strategy.build_strategy(port_config(
        "unet", train_method="1x1x1"))
    assert single.global_batch_size == B and not single.drop_last_train
    assert not torch.distributed.is_initialized()


# -- the loud failures --------------------------------------------------------------


def test_infeasible_geometries_fail_loudly(monkeypatch):
    """JAX ``test_infeasible_geometries_fail_loudly`` in the port's terms,
    each before any group is joined: the spatial role inside a stage
    (JAX's own refusal), more data rows than processes ("devices"), fewer
    ("never shrink": the port's data axis is its processes, so a batch
    always divides it), deepest rows the spatial axis does not divide, a
    name that is neither, and a batch the stage axis' microbatches do
    not divide."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    cfg = port_config("unet", image_size=(48, 32))  # 8 deepest rows

    def build(method, info=None, **kw):
        return port_strategy.build_strategy(
            dataclasses.replace(cfg, train_method=method, **kw), info)

    with pytest.raises(ValueError, match="spatial.*not executable"):
        build("2x2x2@sp")
    with pytest.raises(ValueError, match="needs 9 devices, got 1"):
        build("9x1x1")
    with pytest.raises(ValueError, match="never shrink"):
        build("3x1x1", runtime.RuntimeInfo(0, 4))
    with pytest.raises(ValueError, match="rows"):
        build("1x3x1@sp")  # 8 deep rows % 3 != 0
    with pytest.raises(ValueError, match="Unknown train method") as got:
        build("2x2")  # not a spec, not a name
    with pytest.raises(ValueError) as want:
        jax_strategy.build_strategy(JaxTrainConfig(train_method="2x2"))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=re.escape(
            "must be a multiple of data x microbatches = 1 x 3")):
        build("1x1x2", num_microbatches=3)
    with pytest.raises(ValueError, match="pipeline_schedule"):
        build("1x1x2", pipeline_schedule="zb")
    assert not torch.distributed.is_initialized()


def test_the_pipeline_twin_takes_the_specs_batch_rule(monkeypatch):
    """``Dx1xS`` checks the JAX spec's ``global % (data × microbatches)``
    with the port's global batch b × D, so each rank's batch needs only
    divide its microbatches: ``2x1x2 -b 2 --microbatches 2`` builds on two
    ranks where ``-t DDP_MP`` (its own JAX rule, b a multiple of world ×
    M) refuses it; ``-b 3`` fails with the JAX words; the pipeline twin
    takes its stage count from the spec."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    info = runtime.RuntimeInfo(0, 2)
    cfg = port_config("unet", batch_size=2, num_microbatches=2,
                      num_stages=3)
    twin = port_strategy.build_strategy(
        dataclasses.replace(cfg, train_method="2x1x2"), info)
    assert twin.name == "2x1x2" and twin.config.num_stages == 2
    assert twin.global_batch_size == 4 and twin.lr_for(1e-4) == 1e-4
    assert twin.mesh_shape() == {"data": 2, "stage": 2}
    with pytest.raises(ValueError, match="degenerates to plain MP"):
        port_strategy.build_strategy(
            dataclasses.replace(cfg, train_method="DDP_MP"), info)
    with pytest.raises(ValueError, match=re.escape(
            "mesh 2x1x2: global batch 6 (batch_size 3 x 2 processes) must be "
            "a multiple of data x microbatches = 2 x 2")):
        port_strategy.build_strategy(
            dataclasses.replace(cfg, train_method="2x1x2", batch_size=3),
            info)
    assert not torch.distributed.is_initialized()


#: what stays refused: the run control under in-stage sharding (item
#: 1c″) and a spatial model axis inside a pipeline stage (JAX's refusal)
STILL_REFUSED = [
    ("2x2x2@fsdp", ["--steps-per-dispatch", "2"],
     dict(steps_per_dispatch=2), r"ROADMAP\.md, Queue A, item 1c″"),
    ("2x2x2@fsdp", ["--remat"], dict(remat=True),
     r"ROADMAP\.md, Queue A, item 1c″"),
    ("2x2x2@fsdp", ["--grad-accum", "2"], dict(grad_accum=2),
     r"ROADMAP\.md, Queue A, item 1c″"),
    ("2x2x2@fsdp", ["--dtype", "bf16_params"], dict(dtype="bf16_params"),
     r"ROADMAP\.md, Queue A, item 1c″"),
    ("2x2x2@sp", [], {}, r"'spatial' model role inside a pipeline stage "
     r"is not executable.*the JAX package refuses it too")]


@pytest.mark.parametrize("spec,flag,kw,pattern", STILL_REFUSED)
def test_in_stage_sharding_is_refused_naming_the_roadmap(spec, flag, kw,
                                                         pattern,
                                                         monkeypatch):
    """Every spec the JAX package trains trains here too, with its run
    control at every flat point (tests/test_torch_mesh_run_control.py);
    what stays refused is refused by the strategy and by the CLI before
    any group is joined: the K-step graph, ``--remat``, ``--grad-accum``
    and ``--dtype bf16_params`` under in-stage sharding (``2x2x2@fsdp``)
    naming the ROADMAP's item 1c″, and a spatial model axis inside a
    pipeline stage in the JAX package's words."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    cfg = port_config("unet", train_method=spec, **kw)
    with pytest.raises(ValueError, match=pattern):
        port_strategy.build_strategy(cfg, runtime.RuntimeInfo(0, 2),
                                     [CPU, CPU])
    with pytest.raises(SystemExit, match=pattern):
        cli.main(["-t", spec, *CLI, *flag])
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("spec", ["2x2x1", "2x2x1@fsdp"])
@pytest.mark.parametrize("arch,flag,kw,in_stage,pattern", [
    ("unet", ["--grad-accum", "2", "--steps-per-dispatch", "2"],
     dict(grad_accum=2, steps_per_dispatch=2), False,
     r"--steps-per-dispatch and --grad-accum both stack loader batches"),
    ("milesial", ["--model", "milesial", "--grad-accum", "2"],
     dict(grad_accum=2), False,
     r"gradient accumulation supports stateless models only"),
    ("unet", ["--remat"], dict(remat=True), True,
     r"\(in-stage sharding\) is not ported yet.*ROADMAP\.md, Queue A, "
     r"item 1c″"),
    ("unet", ["--steps-per-dispatch", "2"], dict(steps_per_dispatch=2),
     True, r"\(in-stage sharding\) is not ported yet.*ROADMAP\.md, Queue "
     r"A, item 1c″")])
def test_the_run_control_of_the_new_geometries_is_refused(
        spec, arch, flag, kw, in_stage, pattern, monkeypatch):
    """The run control of ``DxMx1`` and ``DxMx1@fsdp`` with D, M > 1 trains
    (tests/test_torch_mesh_run_control.py); what stays refused there is
    what every method refuses, in the JAX package's words (``--grad-accum``
    with ``--steps-per-dispatch K > 1``, milesial's ``--grad-accum``), and
    under their in-stage counterparts (``2x2x2``, ``2x2x2@fsdp``)
    ``--remat`` and the K-step graph naming the ROADMAP's item 1c″, in
    the strategy and at the CLI, before any group is joined; plain
    ``--dtype bf16`` builds."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    method = spec.replace("2x2x1", "2x2x2") if in_stage else spec
    cfg = port_config(arch, train_method=method, **kw)
    with pytest.raises(ValueError, match=pattern):
        port_strategy.build_strategy(cfg, runtime.RuntimeInfo(0, 2),
                                     [CPU] * (4 if in_stage else 2))
    with pytest.raises(SystemExit, match=pattern):
        cli.main(["-t", method, *CLI, *flag])
    assert not torch.distributed.is_initialized()
    port_strategy.build_strategy(
        port_config("unet", train_method=spec, dtype="bf16"),
        runtime.RuntimeInfo(0, 2), [CPU, CPU])


# -- the manifest -------------------------------------------------------------------

TOPOLOGIES = ["1x1x1", "2x1x1", "2x1x1@fsdp", "1x2x1", "1x2x1@fsdp",
              "1x2x1@sp", "2x2x1@sp", "2x2x1", "2x2x1@fsdp", "1x1x2", "2x1x2"]


@pytest.mark.parametrize("spec", TOPOLOGIES)
def test_the_manifest_topology_is_the_jax_one(spec):
    """The manifest's ``topology`` of a spec (``checkpoint.jax_topology``
    of the strategy's name and mesh) against JAX ``Strategy.topology()``
    of the same spec: ``strategy`` and ``mesh_spec`` the canonical spec
    (``2x2x1@fsdp`` for ``fsdp+channel``), ``mesh`` the axes of size > 1;
    ``process_count`` the data axis, ``device_count`` the mesh's."""
    cfg = mesh.parse_mesh_spec(spec)
    strategy = port_strategy.build_strategy(
        port_config("unet", train_method=spec, batch_size=4),
        runtime.RuntimeInfo(0, cfg.data),
        [CPU] * (cfg.model * cfg.stage))
    got = checkpoint.jax_topology(strategy.name, strategy.mesh_shape(),
                                  "f32")
    want = jax_strategy.build_strategy(JaxTrainConfig(
        train_method=spec, batch_size=4, dtype="f32", model_widths=WIDTHS,
        image_size=(W, H), s2d_levels=0)).topology()
    for key in ("strategy", "mesh", "mesh_spec"):
        assert got[key] == want[key], key
    assert got["process_count"] == cfg.data
    assert got["device_count"] == int(np.prod([s for _, s in
                                               mesh.axis_layout(cfg)] or 1))
    assert not torch.distributed.is_initialized()


def test_every_spec_point_resolves_to_its_class():
    """The class each flat spec and pipeline twin runs as, over a grid."""
    want = {(1, 1, 1, ""): "SingleDevice", (2, 1, 1, ""): "DistributedDataParallel",
            (2, 1, 1, "@fsdp"): "FullyShardedDataParallel",
            (1, 1, 1, "@fsdp"): "FullyShardedDataParallel",
            (1, 2, 1, ""): "TensorParallel", (1, 2, 1, "@fsdp"): "TensorParallel",
            (1, 2, 1, "@sp"): "SpatialParallel",
            (2, 2, 1, "@sp"): "HybridDataSpatial",
            (1, 1, 2, ""): "Pipeline", (2, 1, 2, ""): "HybridDataPipeline"}
    for (d, m, s, opt), legacy in want.items():
        cls = port_strategy._mesh_class(mesh.parse_mesh_spec(
            f"{d}x{m}x{s}{opt}"))
        assert cls.__mro__[1] is port_strategy.GenericMesh
        assert cls.__mro__[2].__name__ == legacy
    for d, m in itertools.product((2, 4), (2, 4)):
        assert port_strategy._mesh_class(mesh.parse_mesh_spec(
            f"{d}x{m}x1")) is port_strategy.DataTensorParallel
        assert port_strategy._mesh_class(mesh.parse_mesh_spec(
            f"{d}x{m}x1@fsdp")) is port_strategy.ZeroTensorParallel
