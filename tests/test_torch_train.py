"""The port's single-device trainer against the JAX package's, on the CPU
at a small size (widths (8, 16), 32 × 48 images, float32, pixel path):
the plateau scheduler, Adam, one train step, the two-pass gradient
accumulation, one whole epoch from the same weights and split, resume,
and the CLI's artifacts.

Weights cross with ``checkpoint.params_from_jax``; inputs are numpy
arrays made from seeds. Each tolerance is stated where it is used."""

import dataclasses
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributedpytorch_tpu.config import TrainConfig as JaxTrainConfig
from distributedpytorch_tpu.models.unet import UNet as JaxUNet
from distributedpytorch_tpu.models.unet import init_unet_params
from distributedpytorch_tpu.ops.fused_loss import fused_bce_dice_loss
from distributedpytorch_tpu.ops.optim import adam_l2
from distributedpytorch_tpu.ops.schedule import (
    ReduceLROnPlateau as JaxPlateau,
)
from distributedpytorch_tpu.train import Trainer as JaxTrainer
from distributedpytorch_tpu.train import steps as jsteps
from distributedpytorch_tpu_torch import cli
from distributedpytorch_tpu_torch.checkpoint import params_from_jax
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.models.unet import UNet
from distributedpytorch_tpu_torch.ops.optim import (
    get_learning_rate,
    make_optimizer,
    set_learning_rate,
)
from distributedpytorch_tpu_torch.ops.schedule import ReduceLROnPlateau
from distributedpytorch_tpu_torch.train import steps
from distributedpytorch_tpu_torch.train.loop import (
    NonFiniteLossError,
    Trainer,
)

H, W = 32, 48
WIDTHS = (8, 16)
# port kernel policy → the JAX policy it stands for
POLICIES = [("torch", "xla"), ("cuda", "pallas")]


def _jax_model_and_params(seed=0):
    model = JaxUNet(dtype=jnp.float32, widths=WIDTHS, s2d_levels=0)
    return model, init_unet_params(model, jax.random.key(seed),
                                   input_hw=(H, W))


def _port_model(params):
    model = UNet(dtype=torch.float32, widths=WIDTHS)
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    return model


def _batch(b, seed=1):
    rng = np.random.default_rng(seed)
    image = rng.random((b, H, W, 3), np.float32)
    mask = (rng.random((b, H, W)) > 0.6).astype(np.int32)
    return {"image": image, "mask": mask}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


class _Capture:
    """An optimizer that keeps the gradients it is stepped with."""

    def __init__(self, params):
        self.params = list(params)
        self.grads = None

    def zero_grad(self, set_to_none=True):
        for p in self.params:
            p.grad = None

    def step(self):
        self.grads = {id(p): p.grad.clone() for p in self.params}


def _jax_capture_tx():
    """An optax transformation that leaves the params and keeps the
    (scaled) gradients as its state."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
    )


def _compare_grads(model, captured, jax_grads, rtol):
    """Each parameter's gradient against JAX's (carried across the layout
    rules), with an absolute floor of ``rtol`` × that tensor's largest
    gradient for the elements that cancel to ~0."""
    want = params_from_jax(jax.device_get(jax_grads))
    for name, p in model.named_parameters():
        got = captured[id(p)].numpy()
        ref = want[name].numpy()
        np.testing.assert_allclose(got, ref, rtol=rtol,
                                   atol=rtol * float(np.abs(ref).max()),
                                   err_msg=name)


# -- scheduler and optimizer -----------------------------------------------------


@pytest.mark.parametrize("metrics", [
    [1.0, 0.9, 0.95, 0.96, 0.97, 0.98, 0.5, 0.6, 0.7, 0.8, 0.9],
    [float("nan"), 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
])
def test_plateau_sequences_equal_the_jax_scheduler(metrics):
    got, want = ReduceLROnPlateau(lr=1e-4), JaxPlateau(lr=1e-4)
    for m in metrics:
        assert got.step(m) == want.step(m)
        assert got.state_dict() == want.state_dict()
    fresh = ReduceLROnPlateau(lr=1.0)
    fresh.load_state_dict(got.state_dict())
    assert fresh.state_dict() == got.state_dict()
    with pytest.raises(ValueError, match="unknown keys"):
        fresh.load_state_dict({"bogus": 1})


def test_adam_steps_equal_adam_l2_from_identical_grads():
    """torch.optim.Adam(weight_decay) and the JAX package's adam_l2 are
    the same update (L2 folded into the gradient), but they round at other
    places (torch divides by sqrt(v)/sqrt(1 - b2^t) + eps, optax
    bias-corrects m and v first), so each step's update of about lr may
    differ in its last bits, and the weight it lands on by one rounding:
    after four steps the weights agree within lr × 1e-4."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,)]
    params0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * 10.0 ** -k
              for s in shapes] for k in range(4)]
    lr = 1e-3
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy()))
               for p in params0]
    opt = make_optimizer(tparams, lr)
    tx = adam_l2(lr)
    jparams = [jnp.asarray(p) for p in params0]
    state = tx.init(jparams)
    for step_grads in grads:
        for p, g in zip(tparams, step_grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        updates, state = tx.update([jnp.asarray(g) for g in step_grads],
                                   state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    for p, q in zip(tparams, jparams):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(q),
                                   rtol=0, atol=lr * 1e-4)
    set_learning_rate(opt, 5e-5)
    assert get_learning_rate(opt) == 5e-5


# -- steps -------------------------------------------------------------------------


@pytest.mark.parametrize("policy,jax_policy", POLICIES)
def test_train_step_loss_and_grads_match_make_train_step(policy, jax_policy):
    """One step from the same weights and batch: the loss within rel 1e-5
    and every (batch-size-scaled) gradient within rel 1e-4 — two float32
    UNet backward passes that sum convolutions in different orders."""
    jmodel, params = _jax_model_and_params()
    batch = _batch(2)
    jstep = jsteps.make_train_step(
        jmodel, _jax_capture_tx(), batch_size=2,
        loss_impl=fused_bce_dice_loss if jax_policy == "pallas" else None,
    )
    jstate = jsteps.TrainState(params=params,
                               opt_state=_jax_capture_tx().init(params),
                               step=jnp.zeros((), jnp.int32))
    jstate, jloss = jax.jit(jstep)(jstate, jax.device_put(batch))
    model = _port_model(params)
    capture = _Capture(model.parameters())
    step = steps.make_train_step(model, capture, batch_size=2,
                                 train_loss_fused=policy == "cuda")
    loss = step(_torch_batch(batch))
    assert loss.shape == () and not loss.requires_grad
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _compare_grads(model, capture.grads, jstate.opt_state, rtol=1e-4)


@pytest.mark.parametrize("policy,jax_policy", POLICIES)
def test_accum_step_matches_the_jax_two_pass_accumulation(policy,
                                                          jax_policy):
    """--grad-accum 2: the loss of the summed statistics and the gradient
    of the whole effective batch, against make_accum_train_step (same
    tolerances as one step), and against a single step over both chunks
    at once."""
    jmodel, params = _jax_model_and_params()
    chunks = [_batch(2, seed=1), _batch(2, seed=2)]
    jstep = jsteps.make_accum_train_step(
        jmodel, _jax_capture_tx(), batch_size=2, chunks=2,
        use_pallas=jax_policy == "pallas",
    )
    jstate = jsteps.TrainState(params=params,
                               opt_state=_jax_capture_tx().init(params),
                               step=jnp.zeros((), jnp.int32))
    stacked = {k: np.stack([c[k] for c in chunks]) for k in chunks[0]}
    jstate, jloss = jax.jit(jstep)(jstate, jax.device_put(stacked))
    model = _port_model(params)
    capture = _Capture(model.parameters())
    step = steps.make_accum_train_step(model, capture, batch_size=2,
                                       chunks=2,
                                       train_loss_fused=policy == "cuda")
    loss = step([_torch_batch(c) for c in chunks])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _compare_grads(model, capture.grads, jstate.opt_state, rtol=1e-4)
    # the same objective as one step over the concatenated batch
    whole = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    capture_whole = _Capture(model.parameters())
    single = steps.make_train_step(model, capture_whole, batch_size=4,
                                   train_loss_fused=policy == "cuda")
    np.testing.assert_allclose(float(single(_torch_batch(whole))),
                               float(loss), rtol=1e-5)
    for p in model.parameters():
        ref = capture_whole.grads[id(p)]
        torch.testing.assert_close(capture.grads[id(p)], ref, rtol=1e-4,
                                   atol=1e-4 * float(ref.abs().max()))
    with pytest.raises(ValueError, match="grad_accum=2"):
        step([_torch_batch(chunks[0])])


def test_eval_step_fused_equals_plain_on_the_cpu():
    _jmodel, params = _jax_model_and_params()
    model = _port_model(params)
    batch = _torch_batch(_batch(3))
    plain = steps.make_eval_step(model)(batch)
    fused = steps.make_eval_step(model, eval_stats_fused=True)(batch)
    for key in ("loss", "dice"):
        assert plain[key].shape == () == fused[key].shape
        np.testing.assert_allclose(float(fused[key]), float(plain[key]),
                                   rtol=1e-5)


# -- the trainer ---------------------------------------------------------------------


def _configs(tmp_path, jax_policy, port_policy, **kw):
    common = dict(
        epochs=1, batch_size=2, val_percent=25.0, seed=42,
        image_size=(W, H), model_widths=WIDTHS, synthetic_samples=16,
        metric_every_steps=1, num_workers=0, s2d_levels=0,
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
    """--synthetic 16, -v 25, -b 2: 6 train steps and 2 val batches, the
    port from the JAX trainer's initial weights. Losses agree within rel
    1e-4 per step: float32 forwards that sum convolutions in different
    orders (~1e-6) and Adam's first steps, which move each weight by
    about lr whatever the gradient's size, so a rounding difference in a
    near-zero gradient moves a weight by up to 2·lr. Val loss and Dice
    within rel 1e-4 likewise."""
    jcfg, pcfg = _configs(tmp_path, jax_policy, policy)
    jtrainer = JaxTrainer(jcfg)
    initial = params_from_jax(jax.device_get(jtrainer.state.params))
    jresult = jtrainer.train()
    trainer = Trainer(pcfg, initial_state=initial)
    assert trainer.kernels.train_loss_fused == (policy == "cuda")
    result = trainer.train()
    assert result["steps"] == jresult["steps"] == 6
    jlosses = [r[2] for r in jtrainer.records.train_rows]
    losses = [r[2] for r in trainer.records.train_rows]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    for key in ("val_loss", "val_dice"):
        assert np.isfinite(result[key])
        np.testing.assert_allclose(result[key], jresult[key], rtol=1e-4)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """Two epochs in one run, and one epoch then a resume from the native
    checkpoint for the second: the same weights, losses and rows, bit for
    bit (both on the CPU, the same operations in the same order)."""
    _jcfg, cfg = _configs(tmp_path / "full", "xla", "torch", epochs=2,
                          metric_every_steps=4)
    full = Trainer(cfg)
    full_result = full.train()

    _jcfg, half = _configs(tmp_path / "half", "xla", "torch", epochs=1,
                           metric_every_steps=4)
    Trainer(half).train()
    resumed = Trainer(dataclasses.replace(half, epochs=2,
                                          checkpoint_name="singleGPU"))
    assert (resumed.start_epoch, resumed.step) == (1, 6)
    result = resumed.train()
    assert result["steps"] == full_result["steps"] == 12
    assert result["val_loss"] == full_result["val_loss"]
    for (name, a), b in zip(full.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert ([r[::2] for r in resumed.records.train_rows]
            == [r[::2] for r in full.records.train_rows])
    assert len(resumed.records.val_rows) == 2
    # -c with a .pth loads the weights alone and starts at epoch 0
    weights_only = Trainer(dataclasses.replace(
        half, checkpoint_name="singleGPU.pth"))
    assert (weights_only.start_epoch, weights_only.step) == (0, 0)


def test_non_finite_loss_raises_when_its_row_is_read(tmp_path):
    _jcfg, cfg = _configs(tmp_path, "xla", "torch", metric_every_steps=2)
    trainer = Trainer(cfg)
    real_step = trainer.train_step
    trainer.train_step = lambda batch: real_step(batch) * float("nan")
    with pytest.raises(NonFiniteLossError, match="step 2"):
        trainer.train()


def test_cli_trains_on_the_cpu_and_writes_its_artifacts(tmp_path,
                                                        monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["-t", "singleGPU", "--synthetic", "16", "--image-size", "48",
            "32", "--model-widths", "8", "16", "-e", "1", "-b", "2",
            "-v", "25", "--device", "cpu", "--num-workers", "0",
            "--s2d-levels", "0"]
    args = cli.get_args(argv)
    cfg = cli.to_config(args)
    assert (cfg.device, cfg.kernels, cfg.image_size) == ("cpu", None,
                                                         (48, 32))
    root = logging.getLogger()
    before = list(root.handlers)
    try:
        assert cli.main(argv) == 0
    finally:
        for handler in set(root.handlers) - set(before):
            root.removeHandler(handler)
            handler.close()
    for path in ("logs/singleGPU.log", "checkpoints/singleGPU.pt",
                 "checkpoints/singleGPU.pth", "loss/singleGPU"):
        assert os.path.exists(path), path
    assert "Epoch 1/1" in open("logs/singleGPU.log").read()
    # the final weights serve as they are
    from distributedpytorch_tpu_torch.serve.engine import (
        engine_from_checkpoint,
    )

    engine = engine_from_checkpoint(
        "singleGPU", image_size=(48, 32), model_widths=(8, 16), dtype="bf16",
        bucket_sizes=(1,), device="cpu",
    )
    assert engine.infer(np.zeros((1, 32, 48, 3), np.float32)).shape == (
        1, 32, 48)


def test_cli_refuses_what_it_does_not_run(capsys):
    # a spatial model axis inside a pipeline stage, and --grad-accum under
    # in-stage sharding (the JAX words)
    for argv, said in ((["-t", "2x2x2@sp"], "not executable.*ROADMAP"),
                       (["-t", "4x2x2@fsdp", "--grad-accum", "2"],
                        "raise --microbatches instead of --grad-accum")):
        with pytest.raises(SystemExit, match=said):
            cli.main(argv)
    with pytest.raises(SystemExit):
        cli.get_args(["--step-timeout", "5"])  # not defined (the watchdog)
    with pytest.raises(SystemExit):
        cli.get_args(["--kernels", "pallas"])
