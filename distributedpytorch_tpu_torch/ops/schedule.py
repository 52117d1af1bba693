"""ReduceLROnPlateau, a host-side learning-rate state machine.

The port's own copy of ``distributedpytorch_tpu/ops/schedule.py`` (which
imports no JAX): ``torch.optim.lr_scheduler.ReduceLROnPlateau`` with the
defaults the reference relies on (``mode='min', patience=2`` → factor
0.1, threshold 1e-4 relative, no cooldown, min_lr 0). It steps on the
val loss between epochs and returns the learning rate, which the trainer
writes into the optimizer's param groups.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ReduceLROnPlateau:
    lr: float
    mode: str = "min"
    factor: float = 0.1
    patience: int = 2
    threshold: float = 1e-4
    threshold_mode: str = "rel"
    cooldown: int = 0
    min_lr: float = 0.0

    best: float = None  # type: ignore[assignment]
    num_bad_epochs: int = 0
    cooldown_counter: int = 0

    def __post_init__(self):
        if self.mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {self.mode!r}")
        if self.best is None:
            self.best = float("inf") if self.mode == "min" else float("-inf")

    def _is_better(self, current: float) -> bool:
        if self.threshold_mode == "rel":
            if self.mode == "min":
                return current < self.best * (1.0 - self.threshold)
            return current > self.best * (1.0 + self.threshold)
        if self.mode == "min":
            return current < self.best - self.threshold
        return current > self.best + self.threshold

    def step(self, metric: float) -> float:
        """Record an epoch's metric; returns the (possibly reduced) lr."""
        current = float(metric)
        if self._is_better(current):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1

        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0

        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    def load_state_dict(self, state: dict) -> None:
        """Restore from ``state_dict()``. Unknown keys raise; a bad value
        leaves this scheduler untouched (the candidate is validated by
        ``__post_init__`` first)."""
        known = {f.name for f in dataclasses.fields(self)}
        unknown = set(state) - known
        if unknown:
            raise ValueError(
                f"ReduceLROnPlateau.load_state_dict: unknown keys "
                f"{sorted(unknown)} (expected a subset of {sorted(known)})"
            )
        candidate = dataclasses.replace(self, **state)
        self.__dict__.update(candidate.__dict__)
