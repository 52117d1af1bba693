"""The port's milesial UNet (``models/milesial.py``) against the JAX
package's, on the CPU at small widths in float32: the parameter golden,
upstream milesial's state-dict names, the eval and train forwards with
the running statistics they leave, the gradients, a ``.pth`` round trip,
the grad-accumulation refusal, one whole ``--synthetic`` epoch of both
trainers from the same weights, and ``--wgrad-taps`` on the UNet.

Weights cross with ``checkpoint.params_from_jax``; inputs are numpy
arrays made from seeds. Each tolerance is stated where it is used."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.checkpoint import (
    export_milesial_state_dict,
    import_milesial_pth,
)
from distributedpytorch_tpu.config import TrainConfig as JaxTrainConfig
from distributedpytorch_tpu.models.milesial import MilesialUNet as JaxMilesial
from distributedpytorch_tpu.models.milesial import init_milesial
from distributedpytorch_tpu.ops.losses import bce_dice_loss as jax_loss
from distributedpytorch_tpu.train import Trainer as JaxTrainer
from distributedpytorch_tpu_torch.checkpoint import params_from_jax, save_pth
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.models import create_model
from distributedpytorch_tpu_torch.models.milesial import MilesialUNet
from distributedpytorch_tpu_torch.models.unet import param_count
from distributedpytorch_tpu_torch.ops.losses import bce_dice_loss
from distributedpytorch_tpu_torch.train import steps
from distributedpytorch_tpu_torch.train.loop import Trainer

REFERENCE_MILESIAL_PARAMS = 31_037_698  # n_classes=2, tests/test_milesial.py
H, W = 16, 24
# port kernel policy → the JAX policy it stands for
POLICIES = [("torch", "xla"), ("cuda", "pallas")]


def _jax_model(widths, policy="xla"):
    return JaxMilesial(widths=widths, dtype=jnp.float32, s2d_levels=0,
                       conv_epilogue=policy == "pallas")


def _port_model(widths, policy, params, batch_stats):
    model = MilesialUNet(widths=widths, dtype=torch.float32,
                         conv_epilogue=policy == "cuda")
    model.load_state_dict(params_from_jax(jax.device_get(params),
                                          jax.device_get(batch_stats)))
    return model


def _batch(b, seed=1):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((b, H, W, 3), np.float32),
            "mask": (rng.random((b, H, W)) > 0.6).astype(np.int32)}


def test_param_count_matches_the_reference_golden():
    """Built on the meta device: shapes only, no full-width init."""
    with torch.device("meta"):
        two = MilesialUNet(n_classes=2)
        one = MilesialUNet(n_classes=1)
    assert param_count(two) == REFERENCE_MILESIAL_PARAMS
    assert param_count(one) == REFERENCE_MILESIAL_PARAMS - 65
    bns = [n for n, _ in two.named_buffers() if n.endswith("running_mean")]
    assert len(bns) == 18


def test_state_dict_names_are_upstream_milesials():
    """The port's keys and shapes equal the JAX package's milesial export
    (upstream milesial/Pytorch-UNet names), so an upstream ``.pth`` loads
    strictly."""
    model = _jax_model((4, 8, 16))
    params, stats = init_milesial(model, jax.random.key(0), input_hw=(H, W))
    exported = export_milesial_state_dict(params, stats)
    port = MilesialUNet(widths=(4, 8, 16), dtype=torch.float32).state_dict()
    assert {k: tuple(v.shape) for k, v in port.items()} == {
        k: tuple(np.shape(v)) for k, v in exported.items()}
    for name in ("inc.double_conv.0.weight", "inc.double_conv.1.running_var",
                 "down2.maxpool_conv.1.double_conv.4.num_batches_tracked",
                 "up1.up.weight", "up2.conv.double_conv.3.weight",
                 "outc.conv.bias"):
        assert name in port
    torch.nn.Module.load_state_dict(
        MilesialUNet(widths=(4, 8, 16)),
        {k: torch.as_tensor(np.array(v)) for k, v in exported.items()},
        strict=True)


@pytest.mark.parametrize("widths", [(4, 8), (8, 16, 32)])
@pytest.mark.parametrize("policy,jax_policy", POLICIES)
def test_forward_stats_and_grads_match_jax(widths, policy, jax_policy):
    """From the same weights and batch: the eval forward (running
    averages) and the train forward within 1e-5 absolute (float32
    probabilities of convs summed in other orders), the running statistics
    one train step leaves within 1e-6 absolute, and the gradient of the
    training loss within 1e-4 of each tensor's largest, or 1e-6 absolute
    where a gradient cancels to near 0 (the head's bias: 5e-4 with
    2e-7 of rounding)."""
    jmodel = _jax_model(widths, jax_policy)
    params, stats = init_milesial(jmodel, jax.random.key(0), input_hw=(H, W))
    model = _port_model(widths, policy, params, stats)
    batch = _batch(4)
    x = torch.from_numpy(batch["image"])
    target = torch.from_numpy(batch["mask"]).unsqueeze(-1).float()

    want = jmodel.apply({"params": params, "batch_stats": stats},
                        batch["image"], train=False)
    model.eval()
    with torch.no_grad():
        got = model(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)

    def jloss(p):
        out, upd = jmodel.apply({"params": p, "batch_stats": stats},
                                batch["image"], train=True,
                                mutable=["batch_stats"])
        return jax_loss(out, batch["mask"][..., None].astype(np.float32)), (
            out, upd["batch_stats"])

    (jl, (jout, jstats)), jgrads = jax.value_and_grad(
        jloss, has_aux=True)(params)
    model.train()
    out = model(x)
    loss = bce_dice_loss(out, target)
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want_sd = params_from_jax(jax.device_get(params),
                              jax.device_get(jstats))
    got_sd = model.state_dict()
    for name, ref in want_sd.items():
        if "running" in name:
            torch.testing.assert_close(got_sd[name], ref, rtol=0, atol=1e-6)
        if name.endswith("num_batches_tracked"):
            assert int(got_sd[name]) == 1
    want_g = params_from_jax(jax.device_get(jgrads), jax.device_get(stats))
    for name, p in model.named_parameters():
        ref = want_g[name]
        torch.testing.assert_close(
            p.grad, ref, rtol=0,
            atol=max(1e-4 * float(ref.abs().max()), 1e-6), msg=name)


def test_pth_round_trip_with_the_jax_package(tmp_path):
    """The port's ``.pth`` loads into the port bit for bit and into the JAX
    package's milesial importer with the weights and running statistics
    it came from."""
    jmodel = _jax_model((4, 8))
    params, stats = init_milesial(jmodel, jax.random.key(1), input_hw=(H, W))
    model = _port_model((4, 8), "torch", params, stats)
    model.train()
    model(torch.from_numpy(_batch(2)["image"]))  # move the running stats
    path = str(tmp_path / "milesial.pth")
    save_pth(model.state_dict(), path)
    again = MilesialUNet(widths=(4, 8), dtype=torch.float32)
    again.load_state_dict(torch.load(path, weights_only=True))
    for (name, a), b in zip(model.state_dict().items(),
                            again.state_dict().values()):
        assert torch.equal(a, b), name
    jparams, jstats = import_milesial_pth(path, params, stats)
    back = params_from_jax(jax.device_get(jparams), jax.device_get(jstats))
    for name, ref in model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(back[name], ref), name


def test_grad_accumulation_refuses_a_stateful_model():
    model = MilesialUNet(widths=(4, 8), dtype=torch.float32)
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    with pytest.raises(ValueError, match="stateless models only"):
        steps.make_accum_train_step(model, opt, batch_size=2, chunks=2)


def test_steps_switch_the_mode():
    """The train step trains on batch statistics and moves the running
    averages; the eval step uses them and leaves them."""
    model = MilesialUNet(widths=(4, 8), dtype=torch.float32,
                         generator=torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    model.eval()
    steps.make_train_step(model, opt, 2)(batch)
    assert model.training
    moved = model.inc.double_conv[1].running_mean.clone()
    assert moved.abs().sum() > 0
    steps.make_eval_step(model)(batch)
    assert not model.training
    assert torch.equal(model.inc.double_conv[1].running_mean, moved)


def _configs(tmp_path, jax_policy, port_policy, **kw):
    common = dict(
        epochs=1, batch_size=2, val_percent=25.0, seed=42,
        image_size=(W, H), model_widths=(8, 16), synthetic_samples=16,
        metric_every_steps=1, num_workers=0, s2d_levels=0,
        model_arch="milesial",
    )
    common.update(kw)
    jcfg = JaxTrainConfig(
        dtype="f32", kernels=jax_policy, async_checkpoint=False,
        checkpoint_dir=str(tmp_path / "jax" / "checkpoints"),
        log_dir=str(tmp_path / "jax" / "logs"),
        loss_dir=str(tmp_path / "jax" / "loss"), **common,
    )
    pcfg = TrainConfig(
        dtype="f32", kernels=port_policy, device="cpu",
        checkpoint_dir=str(tmp_path / "port" / "checkpoints"),
        log_dir=str(tmp_path / "port" / "logs"),
        loss_dir=str(tmp_path / "port" / "loss"), **common,
    )
    return jcfg, pcfg


@pytest.mark.parametrize("policy,jax_policy", POLICIES)
def test_one_epoch_matches_the_jax_trainer(tmp_path, policy, jax_policy):
    """--model milesial --model-widths 8 16 --synthetic 16 -v 25 -b 2: 6
    train steps and 2 val batches from the JAX trainer's initial weights
    and running statistics. Per-step losses, val loss and val Dice within
    rel 1e-4, as for the UNet (tests/test_torch_train.py): float32 convs
    summed in other orders, and Adam's first steps, which move a weight by
    about lr whatever its gradient's size. The final running statistics
    within 1e-4 of each tensor's largest."""
    jcfg, pcfg = _configs(tmp_path, jax_policy, policy)
    jtrainer = JaxTrainer(jcfg)
    initial = params_from_jax(jax.device_get(jtrainer.state.params),
                              jax.device_get(jtrainer.state.model_state))
    jresult = jtrainer.train()
    trainer = Trainer(pcfg, initial_state=initial)
    assert trainer.kernels.conv_epilogue == (policy == "cuda")
    result = trainer.train()
    assert result["steps"] == jresult["steps"] == 6
    jlosses = [r[2] for r in jtrainer.records.train_rows]
    losses = [r[2] for r in trainer.records.train_rows]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    for key in ("val_loss", "val_dice"):
        assert np.isfinite(result[key])
        np.testing.assert_allclose(result[key], jresult[key], rtol=1e-4)
    final = params_from_jax(jax.device_get(jtrainer.state.params),
                            jax.device_get(jtrainer.state.model_state))
    got = trainer.model.state_dict()
    for name, ref in final.items():
        if "running" in name:
            torch.testing.assert_close(got[name], ref, rtol=0,
                                       atol=1e-4 * float(ref.abs().max()))


def test_resume_restores_the_running_statistics(tmp_path):
    """The native checkpoint carries the running statistics and the
    model's family; resuming under another --model refuses."""
    _jcfg, cfg = _configs(tmp_path, "xla", "torch")
    trainer = Trainer(cfg)
    trainer.train()
    resumed = Trainer(dataclasses.replace(cfg, epochs=2,
                                          checkpoint_name="singleGPU"))
    for (name, a), b in zip(trainer.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    with pytest.raises(ValueError, match="'milesial' model"):
        Trainer(dataclasses.replace(cfg, model_arch="unet",
                                    model_widths=None,
                                    checkpoint_name="singleGPU"))


def test_wgrad_taps_trains_the_unet_as_without_it(tmp_path):
    """The port's UNet trainer with and without --wgrad-taps, from the
    same seed: per-step losses and val loss within rel 1e-4 (the taps
    backward sums each weight gradient in another order than autograd's
    conv backward; Adam's first steps turn a rounding difference into a
    move of up to 2·lr)."""
    results, rows = {}, {}
    for taps in (False, True):
        cfg = TrainConfig(
            epochs=1, batch_size=2, val_percent=25.0, seed=42,
            image_size=(48, 32), model_widths=(8, 16), synthetic_samples=16,
            metric_every_steps=1, num_workers=0, dtype="f32",
            kernels="torch", device="cpu", wgrad_taps=taps,
            checkpoint_dir=str(tmp_path / str(taps) / "checkpoints"),
            log_dir=str(tmp_path / str(taps) / "logs"),
            loss_dir=str(tmp_path / str(taps) / "loss"),
        )
        trainer = Trainer(cfg)
        convs = [m for m in trainer.model.modules()
                 if type(m).__name__ == "TapsConv2d"]
        assert len(convs) == (10 if taps else 0)  # five blocks of two
        results[taps] = trainer.train()
        rows[taps] = [r[2] for r in trainer.records.train_rows]
    np.testing.assert_allclose(rows[True], rows[False], rtol=1e-4)
    np.testing.assert_allclose(results[True]["val_loss"],
                               results[False]["val_loss"], rtol=1e-4)


def test_factory_builds_milesial_with_the_policys_kernels():
    cfg = TrainConfig(model_arch="milesial", model_widths=(4, 8),
                      wgrad_taps=True, kernels="cuda", device="cpu")
    model = create_model(cfg)
    assert isinstance(model, MilesialUNet)
    bns = [m for m in model.modules() if type(m).__name__ == "BatchNormAct"]
    assert len(bns) == 6 and all(m.epilogue for m in bns)
    taps = [m for m in model.modules() if type(m).__name__ == "TapsConv2d"]
    assert len(taps) == 6 and all(m.wgrad_cuda for m in taps)
    plain = create_model(dataclasses.replace(cfg, kernels="torch"))
    assert not any(m.epilogue for m in plain.modules()
                   if type(m).__name__ == "BatchNormAct")


@pytest.mark.parametrize("kernels", ["torch", "cuda"])
def test_serves_a_milesial_pth_as_the_jax_engine_does(tmp_path, kernels):
    """A ``.pth`` written by the JAX package's milesial export serves
    through the port's engine (``--model milesial``): float32
    probabilities within 1e-5 of the JAX serve engine's on the same
    weights (kernels torch), and under kernels cuda, whose bucket forward
    runs the BatchNorm epilogue and the serve mask (their plain versions
    on the CPU), the same masks wherever the probability is at least 1e-4
    from the threshold."""
    from distributedpytorch_tpu.checkpoint import export_milesial_pth
    from distributedpytorch_tpu.serve.engine import ServeEngine as JaxEngine
    from distributedpytorch_tpu_torch.serve import cli as serve_cli
    from distributedpytorch_tpu_torch.serve.engine import (
        engine_from_checkpoint,
    )

    jmodel = _jax_model((4, 8))
    params, stats = init_milesial(jmodel, jax.random.key(2), input_hw=(H, W))
    export_milesial_pth(params, stats, str(tmp_path / "milesial.pth"))
    jax_engine = JaxEngine(jmodel, params, stats, input_hw=(H, W),
                           bucket_sizes=(1, 2, 4))
    args = serve_cli.get_args(["-c", "milesial", "--model", "milesial"])
    assert args.model_arch == "milesial"
    engine = engine_from_checkpoint(
        "milesial", checkpoint_dir=str(tmp_path), image_size=(W, H),
        model_arch="milesial", model_widths=(4, 8), dtype="f32",
        bucket_sizes=(1, 2, 4), device="cpu", kernels=kernels)
    replica_model = engine.replicas[0].model
    assert not replica_model.training
    assert all(m.epilogue == (kernels == "cuda")
               for m in replica_model.modules()
               if type(m).__name__ == "BatchNormAct")
    rows = np.random.default_rng(5).random((3, H, W, 3), np.float32)
    want = np.asarray(jax_engine.infer(rows))
    got = engine.infer(rows)
    if kernels == "torch":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert got.dtype == np.uint8
        diff = got != jax_engine.postprocess(want)
        assert not (diff & (np.abs(want - 0.5) >= 1e-4)).any()
