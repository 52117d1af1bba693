"""The port's ``-t SP`` against the JAX package's, on the CPU at a small
size (widths (8, 16): a 2-level UNet and a 1-level milesial, 32 × 16
images, batch 4, float32).

The port's row shards run on an explicit device list that repeats the
CPU (``[cpu] * n``), each shard in a thread of its own, meeting at every
3×3 conv for its halo rows and at every BatchNorm for the whole batch's
moments; the JAX reference is its SP strategy on an n-device CPU mesh
(``jax.devices()[:n]``), whose GSPMD step shards the image rows over a
``spatial`` axis. Weights cross with ``checkpoint.params_from_jax``;
inputs are numpy arrays made from seeds. PERF.md §2's bounds hold one
step: the loss within 1e-5, each gradient before Adam within 1e-4 of its
tensor's largest, the running statistics and the weights after Adam
within 1e-5 (``torch_parallel_parity.assert_step_matches``)."""

import functools
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distributedpytorch_tpu.checkpoint import read_payload as jax_read_payload
from distributedpytorch_tpu.config import TrainConfig as JaxTrainConfig
from distributedpytorch_tpu.models import create_model as jax_create_model
from distributedpytorch_tpu.ops.optim import adam_l2
from distributedpytorch_tpu.parallel import mesh as jax_mesh
from distributedpytorch_tpu.parallel import strategy as jax_strategy
from distributedpytorch_tpu.train import Trainer as JaxTrainer
from distributedpytorch_tpu.train.steps import TrainState
from distributedpytorch_tpu_torch import checkpoint, cli
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.models import create_model
from distributedpytorch_tpu_torch.models.unet import Conv2d, TapsConv2d
from distributedpytorch_tpu_torch.ops.conv_backward import Conv3x3SameTaps
from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
from distributedpytorch_tpu_torch.ops.wgrad_kernels import (
    wgrad_9tap_reference,
)
from distributedpytorch_tpu_torch.parallel import spatial
from distributedpytorch_tpu_torch.parallel.spatial import (
    RowSharded,
    gather_rows,
)
from distributedpytorch_tpu_torch.parallel.strategy import (
    build_strategy,
    check_run_control,
)
from distributedpytorch_tpu_torch.train.loop import Trainer
from distributedpytorch_tpu_torch.train.steps import (
    STACKS_CONFLICT,
    STATEFUL_ACCUM,
)
from test_torch_graph_strategies import (
    _assert_masters_match,
    _jax_bf16_config,
    _jax_bf16_params_step,
    _port_bf16_params,
    _seeded_f32,
)
from torch_parallel_parity import (
    FirstGrads,
    assert_step_matches,
    capture_then,
    max_err_rel_to_max,
    run_cli,
    to_port,
)
from torch_parallel_parity import make_batch as parity_batch
from torch_parallel_parity import torch_batch

H, W = 32, 16
WIDTHS = (8, 16)
B = 4
LR = 1e-4
CPU = torch.device("cpu")
ARCHS = ["unet", "milesial"]
SHARDS = [2, 4]
CLI = ["--synthetic", "16", "--image-size", str(W), str(H),
       "--model-widths", "8", "16", "-b", str(B), "-v", "25", "--device",
       "cpu", "--num-workers", "0", "--s2d-levels", "0", "--dtype", "f32"]


def _batch(seed=1, b=B):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((b, H, W, 3), np.float32),
            "mask": (rng.random((b, H, W)) > 0.6).astype(np.int32)}


def _jax_config(arch, **kw):
    return JaxTrainConfig(**{**dict(
        dtype="f32", kernels="xla", model_arch=arch, model_widths=WIDTHS,
        image_size=(W, H), s2d_levels=0, learning_rate=LR, batch_size=B,
        train_method="SP"), **kw})


def _port_config(arch, **kw):
    return TrainConfig(**{**dict(
        dtype="f32", kernels="torch", model_arch=arch, model_widths=WIDTHS,
        image_size=(W, H), device="cpu", learning_rate=LR, batch_size=B,
        train_method="SP"), **kw})


@functools.cache
def _jax_init(arch):
    """The JAX model and its seeded weights (the init under ``jit``)."""
    model, init_fn = jax_create_model(_jax_config(arch))
    params, model_state = jax.jit(lambda key: init_fn(key, (H, W)))(
        jax.random.key(0))
    return model, params, model_state


@functools.cache
def _jax_sp_step(arch, n):
    """The JAX SP strategy's Adam step on ``n`` devices from the seeded
    weights on ``_batch()``: the loss, the gradients as Adam received them
    and the state after the step, under port names."""
    strategy = jax_strategy.build_strategy(_jax_config(arch),
                                           devices=jax.devices()[:n])
    assert dict(strategy.mesh.shape) == {"spatial": n}
    model, params, model_state = _jax_init(arch)
    tx = capture_then(adam_l2(LR))
    state = strategy.place_state(TrainState(
        params=params, opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32), model_state=model_state))
    new, loss = strategy.build_train_step(model, tx)(
        state, strategy.place_batch(_batch()))
    return {"initial": to_port(params, model_state), "loss": float(loss),
            "grads": to_port(new.opt_state[0], model_state),
            "final": to_port(new.params, new.model_state)}


def _port_sp_step(cfg, initial, n):
    """The port's model from ``initial`` placed by SP over ``[cpu] * n``,
    its optimizer (``FirstGrads`` around Adam) and its train step."""
    from distributedpytorch_tpu_torch.ops.optim import make_optimizer

    strategy = build_strategy(cfg, devices=[CPU] * n)
    assert strategy.devices == [CPU] * n
    model = create_model(cfg)
    model.load_state_dict(initial)
    model = strategy.place_model(model)
    opt = FirstGrads(make_optimizer(model.parameters(), LR,
                                    cfg.weight_decay),
                     model.named_parameters())
    step = strategy.build_train_step(model, opt,
                                     get_kernel_policy(cfg.kernels))
    return strategy, model, opt, step


# -- the halo node and the convs -------------------------------------------------


class _OneConv(torch.nn.Module):
    """One 3×3 conv between NHWC boundaries, as a row-sharded model: no
    pools (``num_segments`` 1)."""

    num_segments = 1

    def __init__(self, conv):
        super().__init__()
        self.conv = conv

    def forward(self, x):
        y = self.conv(x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))
        return y.permute(0, 2, 3, 1)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("kind", ["conv", "taps"])
def test_a_sharded_conv_equals_the_whole_image_conv(kind, n):
    """A 3×3 conv over ``n`` row shards (each shard's rows with its
    neighbours' edge rows, zero rows at the image's top and bottom)
    against the same conv on the whole image in float32: the output, the
    input gradient and the weight and bias gradients, each within 1e-6 of
    its largest (the shards sum the weight gradient in another order),
    image edges included. ``TapsConv2d``'s weight gradient runs through
    the 9-tap backward with the padded-dy form."""
    torch.manual_seed(0)
    cls = Conv2d if kind == "conv" else TapsConv2d
    conv = cls(5, 6, 3, padding=1, bias=True)
    x = torch.randn(2, H, W, 5)
    g = torch.randn(2, H, W, 6)
    whole = _OneConv(conv)
    xw = x.clone().requires_grad_(True)
    (whole(xw) * g).sum().backward()
    want = {"y": whole(x).detach(), "dx": xw.grad,
            "dw": conv.weight.grad.clone(), "db": conv.bias.grad.clone()}
    conv.zero_grad()
    sharded = RowSharded(_OneConv(conv), [CPU] * n)
    assert sharded.convs == [conv]
    xs = x.clone().requires_grad_(True)
    shards = sharded(xs)
    assert [s.shape[1] for s in shards] == [H // n] * n
    y = gather_rows(shards, CPU)
    (y * g).sum().backward()
    got = {"y": y.detach(), "dx": xs.grad, "dw": conv.weight.grad,
           "db": conv.bias.grad}
    for key, value in want.items():
        assert max_err_rel_to_max(got[key].numpy(), value.numpy()) <= 1e-6, key
    assert conv.halo is None


@pytest.mark.parametrize("n", SHARDS)
def test_the_taps_weight_gradient_of_the_shards_sums_to_the_whole(n):
    """Each shard's 9-tap weight gradient from its halo'd rows
    (B, h + 2, W, C) and its dy padded by a zero row at the top and the
    bottom: their sum equals the whole image's ``wgrad_9tap_reference``
    within 1e-6 of its largest, and each shard's equals the
    autograd weight gradient of its VALID-in-H conv."""
    torch.manual_seed(1)
    x = torch.randn(2, H, W, 8)
    dy = torch.randn(2, H, W, 4)
    want = wgrad_9tap_reference(x, dy)
    h = H // n
    zero = torch.zeros(2, 1, W, 8)
    total = torch.zeros_like(want)
    for i in range(n):
        above = x[:, i * h - 1:i * h] if i else zero
        below = x[:, (i + 1) * h:(i + 1) * h + 1] if i < n - 1 else zero
        xh = torch.cat([above, x[:, i * h:(i + 1) * h], below], dim=1)
        dyp = F.pad(dy[:, i * h:(i + 1) * h], (0, 0, 0, 0, 1, 1))
        part = wgrad_9tap_reference(xh, dyp)
        w = torch.randn(4, 8, 3, 3, requires_grad=True)
        y = F.conv2d(xh.permute(0, 3, 1, 2), w, padding=(0, 1))
        (y * dy[:, i * h:(i + 1) * h].permute(0, 3, 1, 2)).sum().backward()
        assert max_err_rel_to_max(part.permute(3, 2, 0, 1).numpy(),
                                  w.grad.numpy()) <= 1e-6
        total += part
    assert max_err_rel_to_max(total.numpy(), want.numpy()) <= 1e-6


def test_the_taps_conv_on_a_halo_runs_valid_in_h():
    """``Conv3x3SameTaps`` with ``halo``: h + 2 rows in, h rows out, the
    input gradient over all h + 2 rows equal to autograd's through
    ``F.conv2d(padding=(0, 1))``."""
    torch.manual_seed(2)
    xh = torch.randn(2, 3, 10, 7, requires_grad=True)
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    y = Conv3x3SameTaps.apply(xh, w, False, True)
    assert y.shape == (2, 4, 8, 7)
    g = torch.randn(y.shape)
    dx, dw = torch.autograd.grad((y * g).sum(), (xh, w))
    xr = xh.detach().clone().requires_grad_(True)
    wr = w.detach().clone().requires_grad_(True)
    (F.conv2d(xr, wr, padding=(0, 1)) * g).sum().backward()
    assert torch.allclose(dx, xr.grad, rtol=1e-5, atol=1e-6)
    assert torch.allclose(dw, wr.grad, rtol=1e-5, atol=1e-5)


def test_rows_that_do_not_split_into_whole_pools_raise():
    """Rows that leave a shard a ragged 2×2 pool at some level raise before
    any thread starts, and an unequal skip would raise in the decoder
    (``crop_skip``) rather than crop each shard apart."""
    from distributedpytorch_tpu_torch.models.unet import crop_skip

    model = create_model(_port_config("unet"))
    with pytest.raises(ValueError, match="must be a multiple of 8"):
        RowSharded(model, [CPU, CPU])(torch.rand(1, 12, W, 3))
    with pytest.raises(ValueError, match="would be cropped per shard"):
        crop_skip(torch.rand(1, 2, 5, 4), torch.rand(1, 2, 4, 4), True)
    assert crop_skip(torch.rand(1, 2, 5, 4), torch.rand(1, 2, 4, 4),
                     False).shape == (1, 2, 4, 4)


class _FailsInShard(torch.nn.Module):
    """A halo'd conv that one shard's thread never reaches."""

    num_segments = 1

    def __init__(self):
        super().__init__()
        self.conv = Conv2d(3, 3, 3, padding=1)

    def forward(self, x):
        if threading.current_thread().name.endswith("-2"):
            raise RuntimeError("shard 2 failed")
        return self.conv(x.permute(0, 3, 1, 2))


def test_a_failing_shard_raises_and_leaves_no_shard_waiting():
    """A shard that fails before a halo breaks the meeting: the forward
    raises that shard's error, every thread ends and the halo is unset."""
    model = RowSharded(_FailsInShard(), [CPU] * 3)
    done = {}

    def run():
        try:
            model(torch.rand(1, 6, 4, 3))
        except RuntimeError as exc:
            done["error"] = str(exc)

    thread = threading.Thread(target=run)
    thread.start()
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert done == {"error": "shard 2 failed"}
    assert model.module.conv.halo is None
    assert not [t for t in threading.enumerate()
                if t.name.startswith("dpt-sp-shard")]


# -- the strategy against the JAX SP ---------------------------------------------


@pytest.mark.parametrize("devices,arch,widths,want", [
    (2, "unet", WIDTHS, 2), (4, "unet", WIDTHS, 4), (8, "unet", WIDTHS, 8),
    (3, "unet", WIDTHS, 2), (8, "milesial", WIDTHS, 8),
    # JAX's test_spatial_with_reference_depth_model: 4 levels at H = 32
    # leave 2 deep rows, and the mesh shrinks to 2
    (8, "unet", None, 2), (8, "milesial", None, 2)])
def test_sp_strategy_contract_matches_the_jax_sp(devices, arch, widths, want):
    """The mesh (n shrunk until it divides the deepest rows, H /
    2^model_levels), the global batch, the lr, the ragged batch kept, the
    eval shard and the manifest's topology, against the JAX SP on the
    same number of CPU devices."""
    kw = dict(model_widths=widths)
    sp = build_strategy(_port_config(arch, **kw), devices=[CPU] * devices)
    jsp = jax_strategy.build_strategy(_jax_config(arch, **kw),
                                      devices=jax.devices()[:devices])
    assert _port_config(arch, **kw).model_levels == _jax_config(
        arch, **kw).model_levels
    assert len(sp.devices) == want
    assert sp.mesh_shape() == dict(jsp.mesh.shape) == {"spatial": want}
    assert sp.name == jsp.name == "SP"
    assert sp.global_batch_size == jsp.global_batch_size == B
    assert sp.lr_for(LR) == jsp.lr_for(LR) == LR
    assert sp.drop_last_train is jsp.mesh_config.drop_last is False
    assert sp.eval_shard() == sp.data_shard()
    assert sp.eval_shard().world == jsp.eval_shard().world == 1
    topology = checkpoint.jax_topology(sp.name, sp.mesh_shape(), "f32")
    assert topology["mesh_spec"] == jax_mesh.canonical_spec(
        jsp.mesh_config) == f"1x{want}x1@sp"
    assert {k: topology[k] for k in ("strategy", "mesh", "precision")} == {
        k: v for k, v in jsp.topology().items() if k != "mesh_spec"}
    assert topology["process_count"] == 1
    assert topology["device_count"] == want


def test_sp_takes_two_shards_of_the_cpu_and_one_card_alone():
    """Without a device list SP shards over every visible card, or two
    shards of the CPU; a shard count of one has no mesh axis, as JAX
    drops an axis of size 1."""
    sp = build_strategy(_port_config("unet"))
    assert sp.devices == [CPU, CPU]
    one = build_strategy(_port_config("unet"), devices=[CPU])
    assert one.mesh_shape() == {}
    assert checkpoint.jax_topology("SP", {}, "f32")["mesh_spec"] == "1x1x1"


# -- one step against the JAX SP step --------------------------------------------


@pytest.mark.parametrize("policy", ["torch", "cuda"])
@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sp_step_matches_the_jax_sp_step(arch, n, policy):
    """One Adam step over ``[cpu] * n`` against the JAX SP step on n
    devices (its XLA kernel policy), within PERF.md §2's bounds. Under
    ``--kernels cuda`` the loss runs per shard through the fused
    statistics, whose plain versions run on the CPU; milesial's running
    statistics move once, with the whole batch's moments."""
    want = _jax_sp_step(arch, n)
    cfg = _port_config(arch, kernels=policy)
    _s, model, opt, step = _port_sp_step(cfg, want["initial"], n)
    loss = step(torch_batch(_batch()))
    assert_step_matches(model, opt, loss, want, weights_tol=1e-5)
    for key, value in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            assert int(value) == 1, key


@pytest.mark.parametrize("arch", ARCHS)
def test_sp_eval_matches_the_single_device_eval(arch):
    """The sharded eval over four shards (K1 per shard under ``--kernels
    cuda``, whose plain version runs here; the hard Dice counts summed
    over the shards) and the plain gathered metrics under ``torch``,
    against the single-device eval step of the same weights within 1e-6."""
    initial = _jax_sp_step(arch, 2)["initial"]
    batch = torch_batch(_batch(seed=4))
    metrics = {}
    for method, policy, devices in (("singleGPU", "torch", None),
                                    ("SP", "torch", [CPU] * 4),
                                    ("SP", "cuda", [CPU] * 4)):
        cfg = _port_config(arch, train_method=method, kernels=policy)
        strategy = build_strategy(cfg, devices=devices)
        model = create_model(cfg)
        model.load_state_dict(initial)
        step = strategy.build_eval_step(strategy.place_model(model),
                                        get_kernel_policy(policy))
        metrics[method, policy] = {k: float(v)
                                   for k, v in step(batch).items()}
    want = metrics["singleGPU", "torch"]
    for key in ("SP", "torch"), ("SP", "cuda"):
        for name in ("loss", "dice"):
            np.testing.assert_allclose(metrics[key][name], want[name],
                                       rtol=1e-6, err_msg=str(key))


def test_shards_add_their_gradients_in_f32_under_bf16_params(monkeypatch):
    """Two shards on ``[cpu, cpu]`` under bf16_params: each shard computes
    with its own cast of the f32 master, so the master gradient Adam
    reads is the batch size times the f32 sum of the two shards' bf16
    gradients, bit for bit (two addends add alike in either order; the
    factor is a power of two). Their bf16 sum differs from it in most
    tensors on these inputs, so a step that added the shards in bf16
    would fail here."""
    uses = []
    real = spatial.replicate

    def recording(module, devices, casts=None):
        replicas = real(module, devices, casts)
        for replica in replicas:
            # a replica's parameters are plain attributes of its modules
            grads = {}
            for name, _ in module.named_parameters():
                path, _, leaf = name.rpartition(".")
                use = getattr(replica.get_submodule(path), leaf)
                use.register_hook(lambda g, name=name, grads=grads:
                                  grads.__setitem__(name, g.clone()))
            uses.append(grads)
        return replicas

    monkeypatch.setattr(spatial, "replicate", recording)
    model, opt, grads, step = _port_bf16_params("SP", _seeded_f32(),
                                                [CPU, CPU])
    step(torch_batch(parity_batch()))
    assert len(uses) == 2
    differs = 0
    names = [n for n, _ in model.named_parameters()]
    for name, g in zip(names, grads):
        a, b = uses[0][name], uses[1][name]
        assert a.dtype == b.dtype == torch.bfloat16
        want = (a.float() + b.float()) * 8
        assert torch.equal(g, want), name
        differs += not torch.equal((a + b).float() * 8, want)
    assert differs >= len(names) // 2, differs


def test_bf16_params_sp_step_matches_the_jax_sp_step():
    """One bf16_params step of the UNet under SP on ``[cpu, cpu]`` against
    the JAX SP step on two CPU devices (16 × 24 images, batch 8): the loss
    within 1e-3 relative, the masters as
    ``test_torch_graph_strategies._assert_masters_match`` holds them, and
    every parameter its master rounded."""
    losses, initial, want = _jax_bf16_params_step(
        _jax_bf16_config(train_method="SP"), jax.devices()[:2],
        [parity_batch()])
    model, opt, _grads, step = _port_bf16_params("SP", initial, [CPU, CPU])
    loss = step(torch_batch(parity_batch()))
    np.testing.assert_allclose(float(loss), losses[0], rtol=1e-3)
    for (name, p), m in zip(model.named_parameters(), opt.master):
        assert torch.equal(p.detach(), m.detach().to(torch.bfloat16)), name
        _assert_masters_match(m.detach(), want[name], LR)


# -- the trainer and the CLI ---------------------------------------------------------


def test_one_epoch_through_the_trainer_matches_the_jax_sp_trainer(tmp_path):
    """``Trainer`` under ``-t SP`` on ``[cpu, cpu]`` against the JAX
    trainer's SP (its CPU devices, 8 shards of these rows) from the same
    weights: --synthetic 24 -v 25 -b 4, 5 steps (the ragged batch kept)
    and 1 val batch. The loss is the same function at any shard count;
    the losses and the val metrics within 1e-4, as
    tests/test_torch_train.py holds singleGPU."""
    common = dict(epochs=1, batch_size=B, val_percent=25.0, seed=42,
                  image_size=(W, H), model_widths=WIDTHS,
                  synthetic_samples=24, metric_every_steps=1, num_workers=0,
                  s2d_levels=0, train_method="SP", dtype="f32")
    jcfg = JaxTrainConfig(
        async_checkpoint=False, kernels="xla", **common,
        checkpoint_dir=str(tmp_path / "jax" / "checkpoints"),
        log_dir=str(tmp_path / "jax" / "logs"),
        loss_dir=str(tmp_path / "jax" / "loss"))
    jtrainer = JaxTrainer(jcfg)
    assert dict(jtrainer.strategy.mesh.shape) == {"spatial": 8}
    initial = checkpoint.params_from_jax(
        jax.device_get(jtrainer.state.params))
    jresult = jtrainer.train()
    pcfg = TrainConfig(
        device="cpu", kernels="cuda", **common,
        checkpoint_dir=str(tmp_path / "port" / "checkpoints"),
        log_dir=str(tmp_path / "port" / "logs"),
        loss_dir=str(tmp_path / "port" / "loss"))
    trainer = Trainer(pcfg, initial_state=initial, devices=[CPU, CPU])
    result = trainer.train()
    assert result["steps"] == jresult["steps"] == 5
    np.testing.assert_allclose([r[2] for r in trainer.records.train_rows],
                               [r[2] for r in jtrainer.records.train_rows],
                               rtol=1e-4)
    for key in ("val_loss", "val_dice"):
        np.testing.assert_allclose(result[key], jresult[key], rtol=1e-4)


def test_cli_trains_sp_and_resumes_across_methods(tmp_path, monkeypatch):
    """``-t SP --device cpu`` (two row shards of the CPU) trains,
    evaluates and writes the SP artifacts; its manifest names the strategy,
    the mesh and ``1x2x1@sp``; ``-c SP`` resumes under singleGPU and a
    singleGPU checkpoint under SP; the manifest's topology round-trips
    through a JAX-format ``.ckpt``, which the JAX reader peeks as the
    JAX SP writes it."""
    from distributedpytorch_tpu.checkpoint import peek_topology

    monkeypatch.chdir(tmp_path)
    assert run_cli(["-t", "SP", "-e", "1", *CLI]) == 0
    for path in ("logs/SP.log", "checkpoints/SP.pt", "checkpoints/SP.pth",
                 "loss/SP/train_loss.pkl", "loss/SP/val_loss.pkl",
                 "loss/SP/val_dice.pkl"):
        assert (tmp_path / path).exists(), path
    payload = checkpoint.load_native(str(tmp_path / "checkpoints" / "SP.pt"))
    manifest = payload["manifest"]
    assert manifest["strategy"] == "SP" and manifest["devices"] == 2
    assert manifest["topology"] == {
        "process_count": 1, "device_count": 2, "strategy": "SP",
        "mesh": {"spatial": 2}, "mesh_spec": "1x2x1@sp", "precision": "f32"}
    jsp = jax_strategy.build_strategy(_jax_config("unet"),
                                      devices=jax.devices()[:2])
    assert manifest["topology"]["mesh_spec"] == jax_mesh.canonical_spec(
        jsp.mesh_config)
    ckpt = str(tmp_path / "SP.ckpt")
    checkpoint.save_jax_ckpt(payload, ckpt)
    assert jax_read_payload(ckpt)["topology"] == manifest["topology"]
    assert peek_topology(ckpt)["mesh_spec"] == "1x2x1@sp"
    assert checkpoint.load_jax_ckpt(ckpt)["manifest"]["topology"][
        "mesh_spec"] == "1x2x1@sp"
    assert run_cli(["-t", "singleGPU", "-c", "SP", "-e", "2", *CLI]) == 0
    assert torch.load(tmp_path / "checkpoints" / "singleGPU.pt",
                      weights_only=True)["epoch"] == 2
    assert run_cli(["-t", "SP", "-c", "singleGPU", "-e", "3", *CLI]) == 0
    again = checkpoint.load_native(str(tmp_path / "checkpoints" / "SP.pt"))
    assert again["epoch"] == 3
    assert "Resumed from" in (tmp_path / "logs" / "SP.log").read_text()


# -- what SP still refuses ----------------------------------------------------


@pytest.mark.parametrize("method", ["SP", "DDP_SP"])
@pytest.mark.parametrize("flag,kw", [
    (["--model", "milesial", "--grad-accum", "2"],
     dict(model_arch="milesial", grad_accum=2)),
    (["--steps-per-dispatch", "2", "--grad-accum", "2"],
     dict(steps_per_dispatch=2, grad_accum=2)),
    (["--steps-per-dispatch", "2"], dict(steps_per_dispatch=2))])
def test_the_run_control_under_sp_is_refused(method, flag, kw):
    """What SP and DDP_SP still refuse of the run control, each before
    any group is joined: milesial's ``--grad-accum 2`` (its BatchNorm
    statistics do not add up over chunks) and ``--grad-accum`` together
    with ``--steps-per-dispatch 2``, with the JAX package's words, in the
    strategy and at the CLI; and ``--steps-per-dispatch 2`` over a gloo
    group on a card, as far as the CPU can show it: the check with a
    card's device and gloo refuses it, while on the CPU, under NCCL and
    at the CLI (which knows no group yet) it passes."""
    cfg = _port_config("unet", train_method=method, **kw)
    if "grad_accum" in kw:
        message = (STATEFUL_ACCUM if "model_arch" in kw
                   else STACKS_CONFLICT)
        with pytest.raises(ValueError, match=re.escape(message)):
            build_strategy(cfg, devices=[CPU, CPU])
        with pytest.raises(SystemExit, match=re.escape(message)):
            cli.main(["-t", method, *flag, *CLI])
    else:
        with pytest.raises(ValueError, match=f"under -t {method} over a "
                                             "gloo group on cuda:0"):
            check_run_control(cfg, torch.device("cuda", 0), "gloo")
        check_run_control(cfg, CPU, "gloo")
        check_run_control(cfg, torch.device("cuda", 0), "nccl")
        check_run_control(cfg)
    assert not torch.distributed.is_initialized()
