"""The port's ``bf16_params`` policy against the JAX package's, on the CPU
at a small size (widths (8, 16), 32 × 48 images): the master-weights
optimizer against ``with_master_weights(adam_l2)``, the checkpoint
conversion between policies, and one train step of each model.

Weights cross with ``checkpoint.params_from_jax``; inputs are numpy
arrays made from seeds. Each tolerance is stated where it is used."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributedpytorch_tpu.config import TrainConfig as JaxTrainConfig
from distributedpytorch_tpu.models import create_model as jax_create_model
from distributedpytorch_tpu.ops.optim import adam_l2
from distributedpytorch_tpu.ops.precision import with_master_weights
from distributedpytorch_tpu.ops.precision import get_policy as jax_policy
from distributedpytorch_tpu.train import steps as jsteps
from distributedpytorch_tpu_torch.checkpoint import (
    load_native,
    params_from_jax,
)
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.models import create_model
from distributedpytorch_tpu_torch.ops.optim import make_optimizer
from distributedpytorch_tpu_torch.ops.precision import (
    POLICIES,
    WGRAD_DTYPE,
    MasterWeights,
    cast_params_,
    convert_checkpoint_state,
)
from distributedpytorch_tpu_torch.train.loop import Trainer
from distributedpytorch_tpu_torch.train.steps import make_train_step

H, W = 32, 48
WIDTHS = (8, 16)
LR = 1e-4
BF16P = POLICIES["bf16_params"]


def _max_err_rel_to_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16_bits(x):
    """The bf16 bit patterns of a torch or JAX bf16 array, as int16."""
    if isinstance(x, torch.Tensor):
        return x.detach().view(torch.int16).numpy().astype(np.int32)
    return np.asarray(x).view(np.int16).astype(np.int32)


def test_master_weights_match_with_master_weights_over_three_updates():
    """The same f32 gradients into both optimizers over bf16 parameters
    for 3 updates at lr 1e-3: the masters within 1e-6 of each tensor's
    largest (torch's Adam and optax's round at other places, test_torch
    _train.py), each side's device parameters bitwise its own master
    rounded to bf16, and the port's within one bf16 ulp of JAX's (a master
    a rounding apart may round to the neighbouring bf16)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    tx = with_master_weights(adam_l2(1e-3, 1e-8))
    jparams = {k: jnp.asarray(v, jnp.bfloat16) for k, v in init.items()}
    state = tx.init(jparams)
    params = [torch.nn.Parameter(torch.from_numpy(init[k]).to(torch.bfloat16))
              for k in shapes]
    opt = make_optimizer(params, 1e-3, 1e-8, policy=BF16P)
    assert isinstance(opt, MasterWeights)
    assert all(m.dtype == WGRAD_DTYPE for m in opt.master)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.zero_grad()
        for m, k in zip(opt.master, shapes):
            m.grad = torch.from_numpy(g[k])
        opt.step()
    for i, k in enumerate(shapes):
        jmaster = np.asarray(state.master[k])
        assert _max_err_rel_to_max(opt.master[i].numpy(), jmaster) <= 1e-6
        assert jparams[k].dtype == jnp.bfloat16
        assert params[i].dtype == torch.bfloat16
        assert np.array_equal(
            _bf16_bits(jparams[k]),
            _bf16_bits(jnp.asarray(state.master[k]).astype(jnp.bfloat16)))
        assert torch.equal(params[i], opt.master[i].to(torch.bfloat16))
        assert np.abs(_bf16_bits(params[i])
                      - _bf16_bits(jparams[k])).max() <= 1


def _run(tmp_path, dtype, **kw):
    cfg = TrainConfig(
        epochs=1, batch_size=2, val_percent=25.0, seed=42,
        image_size=(W, H), model_widths=WIDTHS, synthetic_samples=8,
        num_workers=0, dtype=dtype, device="cpu",
        checkpoint_dir=str(tmp_path / "checkpoints"),
        log_dir=str(tmp_path / "logs"), loss_dir=str(tmp_path / "loss"),
        **kw)
    trainer = Trainer(cfg)
    trainer.train()
    return cfg, trainer


def test_a_bf16_params_checkpoint_resumes_exactly_under_bf16_and_back(
        tmp_path):
    """bf16_params → bf16: the master becomes the f32 parameters bit for
    bit and Adam's state is the wrapped one. bf16 → bf16_params: the
    saved f32 parameters seed the master bit for bit and the device
    parameters are them rounded."""
    cfg, trainer = _run(tmp_path / "a", "bf16_params")
    names = [n for n, _ in trainer.model.named_parameters()]
    assert all(p.dtype == torch.bfloat16 for p in trainer.model.parameters())
    saved = load_native(trainer.checkpoint_path)
    assert saved["manifest"]["dtype"] == "bf16_params"
    master = dict(zip(names, saved["optimizer"]["master"]))
    resumed = Trainer(dataclasses.replace(cfg, dtype="bf16", epochs=2,
                                          checkpoint_name="singleGPU"))
    for name, p in resumed.model.named_parameters():
        assert p.dtype == torch.float32
        assert torch.equal(p.detach(), master[name]), name
    inner = saved["optimizer"]["inner"]["state"]
    for i, p in enumerate(resumed.model.parameters()):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(resumed.optimizer.state[p][key],
                               inner[i][key])

    cfg32, plain = _run(tmp_path / "b", "bf16")
    wide = {n: p.detach().clone() for n, p in plain.model.named_parameters()}
    back = Trainer(dataclasses.replace(cfg32, dtype="bf16_params", epochs=2,
                                       checkpoint_name="singleGPU"))
    for (name, p), m in zip(back.model.named_parameters(),
                            back.optimizer.master):
        assert torch.equal(m, wide[name]), name
        assert torch.equal(p.detach(), wide[name].to(torch.bfloat16)), name


def test_convert_checkpoint_state_both_ways_is_exact():
    rng = np.random.default_rng(1)
    names = ["w", "b"]
    f32 = {n: torch.from_numpy(rng.standard_normal(4).astype(np.float32))
           for n in names}
    f32["running_mean"] = torch.zeros(4)
    opt = {"state": {0: {"exp_avg": torch.ones(4)}}, "param_groups": []}
    model, wrapped = convert_checkpoint_state(POLICIES["bf16"], BF16P, f32,
                                              opt, names)
    assert wrapped["inner"] is opt
    for i, n in enumerate(names):
        assert torch.equal(wrapped["master"][i], f32[n])
        assert torch.equal(model[n], f32[n].to(torch.bfloat16))
    assert model["running_mean"] is f32["running_mean"]
    again, unwrapped = convert_checkpoint_state(BF16P, POLICIES["f32"],
                                                model, wrapped, names)
    assert unwrapped is opt
    for n in names:
        assert torch.equal(again[n], f32[n])
    same, kept = convert_checkpoint_state(BF16P, BF16P, model, wrapped,
                                          names)
    assert kept is wrapped and torch.equal(same["w"], model["w"])


@pytest.mark.parametrize("arch", ["unet", "milesial"])
def test_one_bf16_params_step_matches_the_jax_step(arch):
    """One step under ``--dtype bf16_params`` from the same f32 init (both
    seed the f32 master from it, then round the parameters): the loss within 1e-3
    relative and every master within 1e-2 of its tensor's largest — a
    random-init bf16 step moves its own gradients by far more than f32
    summation order does (ROADMAP trap 3). The zero-initialized biases
    are the exception: their whole value is Adam's first update,
    lr·g/(|g| + eps) ≈ ±lr whatever |g|, so an element whose bf16
    gradient takes the other sign lands 2·lr away. Those tensors (largest
    value under 10·lr) are held within 2·lr element by element, with at
    least 3 of 4 elements on JAX's side of zero."""
    jcfg = JaxTrainConfig(model_arch=arch, model_widths=WIDTHS,
                          dtype="bf16_params", image_size=(W, H),
                          s2d_levels=0)
    jmodel, init_fn = jax_create_model(jcfg)
    params, model_state = init_fn(jax.random.key(0), (H, W))
    policy = jax_policy(jcfg)
    state, tx = jsteps.create_train_state(params, LR, 1e-8,
                                          model_state=model_state,
                                          policy=policy)
    rng = np.random.default_rng(1)
    batch = {"image": rng.random((2, H, W, 3), np.float32),
             "mask": (rng.random((2, H, W)) > 0.6).astype(np.int32)}
    step = jax.jit(jsteps.make_train_step(jmodel, tx, 2, policy=policy))
    new, jloss = step(state, batch)

    cfg = TrainConfig(model_arch=arch, model_widths=WIDTHS,
                      dtype="bf16_params", device="cpu", kernels="torch")
    model = create_model(cfg, cast_params=False)
    model.load_state_dict(params_from_jax(
        jax.device_get(params),
        None if model_state is None else jax.device_get(model_state)))
    opt = make_optimizer(model.parameters(), LR, 1e-8, policy=BF16P)
    cast_params_(model, BF16P)
    loss = make_train_step(model, opt, 2)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3)
    stats = None if model_state is None else jax.device_get(new.model_state)
    want = params_from_jax(jax.device_get(new.opt_state.master), stats)
    for (name, p), m in zip(model.named_parameters(), opt.master):
        assert p.dtype == torch.bfloat16 and m.dtype == torch.float32
        assert torch.equal(p.detach(), m.to(torch.bfloat16)), name
        ref, got = want[name].numpy(), m.numpy()
        largest = np.abs(ref).max()
        if largest >= 10 * LR:
            assert np.abs(got - ref).max() <= 1e-2 * largest, name
            continue
        assert np.abs(got - ref).max() <= 2 * LR * (1 + 1e-3), name
        assert np.mean(np.sign(got) == np.sign(ref)) >= 0.75, name
