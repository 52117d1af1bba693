"""The single-device trainer: epoch loop, eval, scheduler, checkpoints.

Counterpart of the single-device, ``nonfinite_policy="abort"`` subset of
``distributedpytorch_tpu/train/loop.py`` (``Trainer``, ``fit``):

* per step: forward, backward and Adam with the batch-size loss-scaling
  quirk; the unscaled loss is recorded and stays on the card until its
  metrics row is read;
* per epoch: eval → val row → ``scheduler.step(val_loss)`` → the new lr
  on the optimizer; a native checkpoint every ``checkpoint_every_epochs``;
* at the end: the final checkpoint, the loss tables and
  ``<checkpoint_dir>/<method>.pth`` in reference format (upstream
  milesial names for ``--model milesial``), which the serve CLI loads as
  it is.

A stateful model's running statistics (milesial's BatchNorm) are buffers
of its state dict, so the native checkpoint saves and restores them; the
steps switch the model between train and eval mode.

Host and card overlap: batches decode on the loader's threads, and a
placement worker copies them from pinned memory to the card on a copy
stream ``prefetch_batches`` ahead of the step loop; the step loop makes
the compute stream wait for each copy's event. Nothing in the loop waits
for the card except a metrics row falling due (for the previous row) and
the per-epoch eval.

A non-finite train loss raises ``NonFiniteLossError`` when its row is
read. The split is the JAX package's (``seeded_split`` with seed 0, one
split for every strategy), and the train order per epoch comes from
``(seed, epoch)``, so a port run and a JAX run from the same weights see
the same batches.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

from distributedpytorch_tpu_torch.checkpoint import (
    NATIVE_EXT,
    TRAIN_EXTS,
    load_native,
    load_pth,
    resolve_checkpoint,
    save_native,
    save_pth,
)
from distributedpytorch_tpu_torch.config import TrainConfig
from distributedpytorch_tpu_torch.data.dataset import (
    SampleCache,
    SyntheticSegmentationDataset,
    build_dataset,
)
from distributedpytorch_tpu_torch.data.loader import DataLoader, seeded_split
from distributedpytorch_tpu_torch.evaluate import evaluate
from distributedpytorch_tpu_torch.models import create_model
from distributedpytorch_tpu_torch.ops.kernels import get_kernel_policy
from distributedpytorch_tpu_torch.ops.optim import (
    get_learning_rate,
    make_optimizer,
    set_learning_rate,
)
from distributedpytorch_tpu_torch.ops.schedule import ReduceLROnPlateau
from distributedpytorch_tpu_torch.train.steps import (
    make_accum_train_step,
    make_eval_step,
    make_train_step,
)
from distributedpytorch_tpu_torch.utils.device import resolve_device
from distributedpytorch_tpu_torch.utils.metrics import LossRecords
from distributedpytorch_tpu_torch.utils.prefetch import (
    SINGLE,
    pipelined_placement,
    stacked_work,
)

logger = logging.getLogger(__name__)

#: The training methods this port runs.
PORTED_METHODS = ("singleGPU",)


class NonFiniteLossError(RuntimeError):
    """A train loss read back NaN or infinite."""


def unported_method_message(method: str) -> str:
    return (
        f"-t {method} is not ported yet: the PyTorch port trains "
        f"single-device only (-t singleGPU); DP, DDP, MP and the mesh specs "
        f"are still to port (ROADMAP.md, Queue A)"
    )


@dataclasses.dataclass
class Placed:
    """A batch on the card; ``ready`` marks the end of its copy (None on
    the CPU)."""

    tensors: Dict[str, torch.Tensor]
    ready: Optional["torch.cuda.Event"] = None


class Trainer:
    """``Trainer(config).train()`` runs ``config.epochs`` epochs.

    ``initial_state`` is a model state dict to start from in place of the
    seeded init (tests start from JAX weights through
    ``checkpoint.params_from_jax``)."""

    def __init__(self, config: TrainConfig, dataset=None,
                 initial_state: Optional[Dict[str, torch.Tensor]] = None):
        if config.train_method not in PORTED_METHODS:
            raise ValueError(unported_method_message(config.train_method))
        self.config = config
        self.device = resolve_device(config.device)
        self.kernels = get_kernel_policy(config.kernels, self.device)
        self.dataset = dataset if dataset is not None else self._build_dataset()
        # one decoded-sample cache for the train and val loaders
        cache = (SampleCache(int(config.host_cache_mb) * 2**20)
                 if config.host_cache_mb > 0 else None)

        model = create_model(
            config, generator=torch.Generator().manual_seed(config.seed))
        if initial_state is not None:
            model.load_state_dict(initial_state)
        self.model = model.to(self.device)
        self.optimizer = make_optimizer(self.model.parameters(),
                                        config.learning_rate,
                                        config.weight_decay)
        self.scheduler = ReduceLROnPlateau(lr=config.learning_rate,
                                           patience=config.plateau_patience,
                                           factor=config.plateau_factor)
        self.records = LossRecords(config.train_method, config.loss_dir,
                                   every=config.metric_every_steps,
                                   nonfinite_hook=self._on_nonfinite_loss)
        self.step = 0
        self.start_epoch = 0
        self._last_saved_epoch: Optional[int] = None
        if config.checkpoint_name:
            self._restore(config.checkpoint_name)

        train_idx, val_idx = seeded_split(len(self.dataset),
                                          config.val_fraction, seed=0)
        if len(val_idx) < config.batch_size:
            logger.warning(
                "validation split has %d samples < batch size %d — every "
                "val batch is dropped and val loss/Dice will be NaN; raise "
                "-v/--validation or lower -b", len(val_idx),
                config.batch_size,
            )
        self.train_loader = DataLoader(
            self.dataset, indices=train_idx, batch_size=config.batch_size,
            shuffle=True, drop_last=False, seed=config.seed,
            num_workers=config.num_workers, cache=cache,
        )
        self.val_loader = DataLoader(
            self.dataset, indices=val_idx, batch_size=config.batch_size,
            shuffle=False, drop_last=True, num_workers=config.num_workers,
            cache=cache,
        )
        self.grad_accum = max(1, int(config.grad_accum))
        self.train_step = make_train_step(
            self.model, self.optimizer, config.batch_size,
            config.faithful_loss_scaling, self.kernels.train_loss_fused,
        )
        self.accum_step = (
            make_accum_train_step(
                self.model, self.optimizer, config.batch_size,
                self.grad_accum, config.faithful_loss_scaling,
                self.kernels.train_loss_fused,
            ) if self.grad_accum > 1 else None
        )
        self.eval_step = make_eval_step(self.model,
                                        self.kernels.eval_stats_fused)
        self.copy_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)

    # -- set-up ---------------------------------------------------------------
    def _build_dataset(self):
        cfg = self.config
        if cfg.synthetic_samples > 0:
            return SyntheticSegmentationDataset(
                length=cfg.synthetic_samples, newsize=cfg.image_size,
                seed=cfg.seed,
            )
        return build_dataset(os.path.join(cfg.data_dir, cfg.images_subdir),
                             os.path.join(cfg.data_dir, cfg.masks_subdir),
                             cfg.image_size)

    @property
    def checkpoint_path(self) -> str:
        return os.path.join(self.config.checkpoint_dir,
                            f"{self.config.train_method}{NATIVE_EXT}")

    @property
    def weights_path(self) -> str:
        return os.path.join(self.config.checkpoint_dir,
                            f"{self.config.train_method}.pth")

    def _manifest(self) -> dict:
        return {
            "dtype": self.config.dtype,
            "model_arch": self.config.model_arch,
            "kernels": self.kernels.name,
            "train_method": self.config.train_method,
            "device": (torch.cuda.get_device_name(self.device)
                       if self.device.type == "cuda" else "cpu"),
        }

    def _restore(self, name: str) -> None:
        """``-c``: resume the full state from a native checkpoint, or load
        the weights alone from a reference ``.pth``."""
        path = resolve_checkpoint(name, self.config.checkpoint_dir,
                                  exts=TRAIN_EXTS)
        if path.endswith(".pth"):
            self.model.load_state_dict(load_pth(path))
            logger.info("Loaded reference .pth weights from %s", path)
            return
        payload = load_native(path)
        saved = payload["manifest"]
        arch = saved.get("model_arch", "unet")
        if arch != self.config.model_arch:
            raise ValueError(
                f"{path} holds a {arch!r} model; this run builds "
                f"{self.config.model_arch!r} (--model)")
        if saved.get("dtype") != self.config.dtype:
            # parameters are float32 under both policies: nothing converts
            logger.warning("resuming a %s checkpoint under --dtype %s",
                           saved.get("dtype"), self.config.dtype)
        self.model.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        self.scheduler.load_state_dict(payload["scheduler"])
        set_learning_rate(self.optimizer, self.scheduler.lr)
        self.step = int(payload["step"])
        self.start_epoch = int(payload["epoch"])
        if payload.get("records"):
            self.records.load_state_dict(payload["records"])
        logger.info("Resumed from %s at epoch %d (step %d)", path,
                    self.start_epoch, self.step)

    # -- placement --------------------------------------------------------------
    def _place(self, batch) -> Placed:
        """A host batch → the card: pinned memory, copied on the copy
        stream, an event at its end. On the CPU the arrays are shared."""
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
        if self.copy_stream is None:
            return Placed(host)
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self.copy_stream):
            tensors = {k: v.pin_memory().to(self.device, non_blocking=True)
                       for k, v in host.items()}
            ready = torch.cuda.Event()
            ready.record(self.copy_stream)
        return Placed(tensors, ready)

    def _place_work(self, kind: str, payload):
        if kind == SINGLE:
            return self._place(payload)
        return [self._place(b) for b in payload]

    def _claim(self, placed: Placed) -> Dict[str, torch.Tensor]:
        """The placed tensors, usable on the current stream: it waits for
        the copy, and the copy stream's memory is kept until it is done."""
        if placed.ready is None:
            return placed.tensors
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(placed.ready)
        for t in placed.tensors.values():
            t.record_stream(stream)
        return placed.tensors

    def place_batch(self, batch) -> Dict[str, torch.Tensor]:
        """A host batch → tensors ready on the current stream."""
        return self._claim(self._place(batch))

    # -- failure policy -----------------------------------------------------------
    def _on_nonfinite_loss(self, step: int, value: float) -> None:
        raise NonFiniteLossError(
            f"non-finite train loss {value} at step {step} (policy=abort)")

    # -- checkpoints ---------------------------------------------------------------
    def save(self, epoch: int) -> None:
        """The native checkpoint at the end of ``epoch`` (once per epoch)."""
        if epoch == self._last_saved_epoch:
            return
        self._last_saved_epoch = epoch
        save_native(self.checkpoint_path, self.model, self.optimizer,
                    self.scheduler.state_dict(), self.step, epoch,
                    self.records.state_dict(), self._manifest())

    # -- the loop ------------------------------------------------------------------
    def _train_epoch(self, epoch: int) -> None:
        cfg = self.config
        source = pipelined_placement(
            stacked_work(self.train_loader.epoch_batches(epoch),
                         self.grad_accum, cfg.batch_size),
            self._place_work, depth=cfg.prefetch_batches,
            name="dpt-train-place",
        )
        with contextlib.closing(source):
            for (kind, payload), placed in source:
                if kind == SINGLE:
                    loss = self.train_step(self._claim(placed))
                    n_imgs = payload["image"].shape[0]
                else:
                    loss = self.accum_step([self._claim(p) for p in placed])
                    n_imgs = sum(b["image"].shape[0] for b in payload)
                self.step += 1
                self.records.record_train(self.step, loss, n_imgs)

    def train(self) -> dict:
        cfg = self.config
        logger.info(
            "Training %s on %s: %d epochs, batch %d, lr %.2e, %d train "
            "batches, kernels %s, dtype %s", cfg.train_method, self.device,
            cfg.epochs, cfg.batch_size, get_learning_rate(self.optimizer),
            len(self.train_loader), self.kernels.name, cfg.dtype,
        )
        val_loss = val_dice = float("nan")
        for epoch in range(self.start_epoch, cfg.epochs):
            self._train_epoch(epoch)
            val_loss, val_dice = evaluate(self.eval_step, self.val_loader,
                                          self.place_batch)
            self.records.record_val(self.step, val_loss, val_dice)
            new_lr = self.scheduler.step(val_loss)
            if not np.isclose(new_lr, get_learning_rate(self.optimizer),
                              rtol=1e-6):
                logger.info("Epoch %d: plateau → lr %.3e", epoch + 1, new_lr)
                set_learning_rate(self.optimizer, new_lr)
            logger.info(
                "Epoch %d/%d: val loss %.4f, val dice %.4f (%.1f imgs/s)",
                epoch + 1, cfg.epochs, val_loss, val_dice,
                self.records.images_per_second(),
            )
            if cfg.checkpoint_every_epochs and (
                    (epoch + 1) % cfg.checkpoint_every_epochs == 0):
                self.save(epoch + 1)
        self.save(cfg.epochs)
        self.records.save()
        save_pth(self.model.state_dict(), self.weights_path)
        return {
            "val_loss": val_loss,
            "val_dice": val_dice,
            "steps": self.step,
            "images_per_second": self.records.images_per_second(),
            "n_train": self.train_loader.num_samples(),
        }


def fit(config: TrainConfig, dataset=None) -> dict:
    """Build a Trainer and run it."""
    return Trainer(config, dataset=dataset).train()
