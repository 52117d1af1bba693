"""Shared by tests/test_torch_pipeline.py and tests/test_torch_dp.py: the
small configuration (widths (8, 16), 16 × 24 images, batch 8, float32),
seeded inputs, the JAX side's weights and the port's step built by a
strategy, and the comparison of one Adam step."""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from distributedpytorch_tpu.config import TrainConfig as JaxTrainConfig
from distributedpytorch_tpu.models import create_model as jax_create_model
from distributedpytorch_tpu_torch import cli
from distributedpytorch_tpu_torch.checkpoint import params_from_jax
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.models import create_model
from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
from distributedpytorch_tpu_torch.ops.optim import make_optimizer
from distributedpytorch_tpu_torch.parallel.strategy import build_strategy

H, W = 16, 24
WIDTHS = (8, 16)
B = 8
LR = 1e-4
CPU = torch.device("cpu")


def make_batch(b=B, seed=1):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((b, H, W, 3), np.float32),
            "mask": (rng.random((b, H, W)) > 0.6).astype(np.int32)}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_port(params, model_state):
    return params_from_jax(
        jax.device_get(params),
        None if model_state is None else jax.device_get(model_state))


def capture_then(tx):
    """``tx`` after a transformation that keeps the gradients it receives
    (the faithful-scaled ones, as Adam gets them) as its state."""
    capture = optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (g, g))
    return optax.chain(capture, tx)


def max_err_rel_to_max(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    return err / scale if scale else err


def jax_config(arch, **kw):
    return JaxTrainConfig(dtype="f32", kernels="xla", model_arch=arch,
                          model_widths=WIDTHS, image_size=(W, H),
                          s2d_levels=0, learning_rate=LR, batch_size=B, **kw)


@functools.cache
def jax_init(arch):
    """The JAX model and its seeded weights. The init runs under ``jit``:
    op by op it compiles every op of the forward apart, some 20 s on a
    cold compilation cache."""
    model, init_fn = jax_create_model(jax_config(arch))
    params, model_state = jax.jit(lambda key: init_fn(key, (H, W)))(
        jax.random.key(0))
    return model, params, model_state


class FirstGrads:
    """An optimizer that keeps the gradients of its first step (as Adam
    receives them), then steps ``inner``."""

    def __init__(self, inner, named):
        self.inner = inner
        self.named = list(named)
        self.grads = None

    def zero_grad(self, set_to_none=True):
        self.inner.zero_grad(set_to_none=set_to_none)

    def step(self):
        if self.grads is None:
            self.grads = {n: p.grad.detach().clone() for n, p in self.named}
        self.inner.step()


def port_config(arch, **kw):
    return TrainConfig(**{**dict(dtype="f32", kernels="torch",
                                 model_arch=arch, model_widths=WIDTHS,
                                 image_size=(W, H), device="cpu",
                                 learning_rate=LR, batch_size=B), **kw})


def port_step(cfg, initial, devices=None):
    """The port's model from ``initial`` placed by ``cfg``'s strategy, its
    optimizer (``FirstGrads`` around Adam) and its train step."""
    strategy = build_strategy(cfg, devices=devices)
    model = create_model(cfg)
    model.load_state_dict(initial)
    model = strategy.place_model(model)
    opt = FirstGrads(make_optimizer(model.parameters(), LR,
                                     cfg.weight_decay),
                      model.named_parameters())
    step = strategy.build_train_step(model, opt,
                                     get_kernel_policy(cfg.kernels))
    return strategy, model, opt, step


def port_mp(arch, schedule, stages, microbatches, initial, **kw):
    cfg = port_config(arch, train_method="MP", num_stages=stages,
                       num_microbatches=microbatches,
                       pipeline_schedule=schedule, **kw)
    return port_step(cfg, initial, devices=[CPU] * stages)


def assert_step_matches(model, opt, loss, want, weights_tol):
    """Loss within 1e-5; every gradient before Adam within 1e-4 of its
    tensor's largest (float32 backward passes that sum convolutions in
    other orders); the running statistics within 1e-5 of their largest;
    every weight after Adam within ``weights_tol``, with an absolute floor
    of 1e-3 × lr: Adam's first update is lr·g/(|g| + 1e-8) per element,
    so for a gradient element within a few 1e-8 of zero a float32
    rounding of g is a visible part of lr (4.7e-4 × lr at worst in the
    first runs of these cases)."""
    np.testing.assert_allclose(float(loss), want["loss"], rtol=1e-5)
    for name, g in opt.grads.items():
        err = max_err_rel_to_max(g.numpy(), want["grads"][name].numpy())
        assert err <= 1e-4, (name, err)
    for key, value in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        ref = want["final"][key].numpy()
        if "running" in key:
            err = max_err_rel_to_max(value.numpy(), ref)
            assert err <= 1e-5, (key, err)
        else:
            np.testing.assert_allclose(value.numpy(), ref, rtol=weights_tol,
                                       atol=1e-3 * LR, err_msg=key)


def run_cli(argv):
    root = logging.getLogger()
    before = list(root.handlers)
    try:
        return cli.main(argv)
    finally:
        for handler in set(root.handlers) - set(before):
            root.removeHandler(handler)
            handler.close()


CLI = ["--synthetic", "16", "--image-size", str(W), str(H),
       "--model-widths", "8", "16", "-b", "4", "-v", "25", "--device",
       "cpu", "--num-workers", "0", "--s2d-levels", "0"]
