"""Loss and throughput records in the reference's artifact format.

Counterpart of ``LossRecords`` in ``distributedpytorch_tpu/utils/metrics.py``:
a train row every ``every`` steps holding the mean of the last ≤ ``every``
losses, a val row (and a val-Dice row) per epoch, written as pandas
pickles ``<loss_dir>/<method>/{train,val}_loss.pkl`` with columns
``Step, Time, Loss`` and ``val_dice.pkl`` with ``Step, Time, Dice``.

The step's losses stay 0-d tensors on the device. When a row falls due
its window is stacked and its copy to the host starts (pinned memory, no
wait); the row is read at the next row boundary or flush, when its steps
are long done; reading them is the timeline's ``readback`` span
(``utils/trace.py``). A loss may also be a view into a ``(K,)`` tensor of
K steps' losses: a row's window is then still one copy. pandas loads only
in ``save``; without it the same rows go to ``.json`` files beside the
pickle paths.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from distributedpytorch_tpu_torch.utils.trace import NULL_TIMELINE

logger = logging.getLogger(__name__)


def _start_copy(values: list):
    """Start the copy to the host of the 0-d tensors among ``values``
    (one stack, pinned memory, no wait): ``(positions, host, event)``;
    ``event`` is None when nothing waits on a card."""
    positions = [i for i, x in enumerate(values)
                 if isinstance(x, torch.Tensor)]
    if not positions:
        return positions, None, None
    stacked = torch.stack([values[i] for i in positions])
    if stacked.device.type != "cuda":
        return positions, stacked, None
    host = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=True)
    host.copy_(stacked, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return positions, host, done


def _finish_copy(values: list, copy) -> List[float]:
    """``values`` with the tensors of a started copy read as floats."""
    positions, host, done = copy
    if done is not None:
        done.synchronize()
    out = [float(x) if not isinstance(x, torch.Tensor) else x
           for x in values]
    if positions:
        for i, v in zip(positions, host.tolist()):
            out[i] = float(v)
    return out


class LossRecords:
    """Accumulates train/val rows and writes them at the end of a run.

    ``nonfinite_hook(step, value)`` is called for the first non-finite
    loss of each drained window; the trainer's hook raises. ``tracer``
    (a ``StepTimeline``) times each read as ``readback``."""

    def __init__(self, method_tag: str, loss_dir: str = "./loss",
                 every: int = 10,
                 nonfinite_hook: Optional[Callable[[int, float], None]] = None,
                 tracer=None):
        self.method_tag = method_tag
        self.tracer = tracer or NULL_TIMELINE
        self.loss_dir = loss_dir
        self.every = int(every)
        self.nonfinite_hook = nonfinite_hook
        self.start_time = time.time()
        self.losses: list = []  # 0-d device tensors until drained, then floats
        self.train_rows: List[list] = []  # [step, time_s, mean loss]
        # rows due but not read yet: [step, time_s, lo, hi, copy]
        self._pending_rows: List[list] = []
        self.val_rows: List[list] = []
        self.dice_rows: List[list] = []
        self.images_seen = 0
        # the throughput clock starts after the first step, so its
        # warm-up (allocator, cuDNN heuristics) is not in images/s
        self._steady_t0: Optional[float] = None
        self._steady_images0 = 0

    def record_train(self, step: int, loss, batch_images: int = 0) -> None:
        """Once per optimizer step, with the unscaled loss (a 0-d tensor
        or a float). Nothing waits here: a due row reads the previous
        pending row and parks its own window."""
        self.losses.append(loss)
        self.images_seen += batch_images
        if self._steady_t0 is None:
            self._steady_t0 = time.time()
            self._steady_images0 = self.images_seen
        if step % self.every == 0:
            self.drain()
            lo = max(0, len(self.losses) - self.every)
            hi = len(self.losses)
            self._pending_rows.append([
                step, time.time() - self.start_time, lo, hi,
                _start_copy(self.losses[lo:hi]),
            ])

    def drain(self) -> None:
        """Read the pending rows and append them; the Time column keeps
        when each row fell due."""
        if not self._pending_rows:
            return
        pending, self._pending_rows = self._pending_rows, []
        with self.tracer.span("readback", rows=len(pending)):
            windows = [_finish_copy(self.losses[lo:hi], copy)
                       for _step, _ts, lo, hi, copy in pending]
        for (step, ts, lo, hi, _copy), window in zip(pending, windows):
            self.losses[lo:hi] = window
            self.train_rows.append([step, ts, float(np.mean(window))])
            if self.nonfinite_hook is not None:
                for v in window:
                    if not np.isfinite(v):
                        self.nonfinite_hook(step, v)
                        break

    def _host_losses(self) -> List[float]:
        """Every recorded loss as a float (one copy for those still on
        the device)."""
        self.losses = _finish_copy(self.losses, _start_copy(self.losses))
        return self.losses

    def state_dict(self) -> dict:
        """The metric history for a checkpoint: plain lists and numbers.
        Pending rows and the losses since the last row are read first, and
        a non-finite one among the latter reaches the hook too."""
        self.drain()
        window = self._host_losses()[-self.every:] if self.losses else []
        if self.nonfinite_hook is not None:
            for v in window:
                if not np.isfinite(v):
                    self.nonfinite_hook(len(self.losses), v)
                    break
        return {
            "train_rows": [list(map(float, r)) for r in self.train_rows],
            "val_rows": [list(map(float, r)) for r in self.val_rows],
            "dice_rows": [list(map(float, r)) for r in self.dice_rows],
            # the losses since the last row: a resume fills the next row's
            # window with them
            "window": list(window),
            "images_seen": int(self.images_seen),
            "elapsed": float(self.elapsed),
        }

    def load_state_dict(self, state: dict) -> None:
        """Resume the history: new rows append after the restored ones and
        the Time column stays monotonic."""
        self.train_rows = [[int(r[0]), float(r[1]), float(r[2])]
                           for r in state["train_rows"]]
        self.val_rows = [[int(r[0]), float(r[1]), float(r[2])]
                         for r in state["val_rows"]]
        self.dice_rows = [[int(r[0]), float(r[1]), float(r[2])]
                          for r in state["dice_rows"]]
        self.images_seen = int(state["images_seen"])
        self.start_time = time.time() - float(state["elapsed"])
        self.losses = [float(x) for x in state.get("window") or []]
        self._pending_rows = []
        self._steady_t0 = None
        self._steady_images0 = 0

    def record_val(self, step: int, val_loss: float,
                   val_dice: Optional[float] = None) -> None:
        self.drain()  # the epoch's train rows land first
        now = time.time() - self.start_time
        self.val_rows.append([step, now, float(val_loss)])
        if val_dice is not None:
            self.dice_rows.append([step, now, float(val_dice)])

    @property
    def elapsed(self) -> float:
        return time.time() - self.start_time

    def images_per_second(self) -> float:
        """Images per wall-second since the end of the first recorded
        step; 0.0 until a second step is recorded."""
        if self._steady_t0 is None:
            return 0.0
        dt = time.time() - self._steady_t0
        images = self.images_seen - self._steady_images0
        return images / dt if dt > 0 and images > 0 else 0.0

    def save(self) -> List[str]:
        """Write the three tables; returns the paths written. Pickles with
        pandas, else JSON (``{"columns": [...], "rows": [...]}``) beside
        the pickle paths."""
        self.drain()
        out = os.path.join(self.loss_dir, self.method_tag)
        os.makedirs(out, exist_ok=True)
        tables = (
            ("train_loss", ["Step", "Time", "Loss"], self.train_rows),
            ("val_loss", ["Step", "Time", "Loss"], self.val_rows),
            ("val_dice", ["Step", "Time", "Dice"], self.dice_rows),
        )
        try:
            import pandas as pd
        except ImportError:
            pd = None
        paths = []
        for name, columns, rows in tables:
            if pd is not None:
                path = os.path.join(out, f"{name}.pkl")
                pd.DataFrame(rows, columns=columns).to_pickle(path)
            else:
                path = os.path.join(out, f"{name}.json")
                with open(path, "w") as f:
                    json.dump({"columns": columns, "rows": rows}, f)
            paths.append(path)
        if pd is None:
            logger.info("pandas is not installed: wrote the loss tables as "
                        "JSON (%s)", ", ".join(paths))
        return paths
