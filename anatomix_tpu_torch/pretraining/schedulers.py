"""Learning-rate schedules (the port of `anatomix_tpu/pretraining/
schedulers.py`, the reference's `get_scheduler`).

Every policy is a per-epoch multiplier turned into a function of the step
through `steps_per_epoch` (the reference steps its schedulers once per
epoch). 'plateau' is driven by the loss: `PlateauState`, stepped by the
train loop.
"""

from __future__ import annotations

import dataclasses
import math


def make_schedule(
    lr: float,
    policy: str,
    *,
    n_epochs: int,
    n_epochs_decay: int,
    steps_per_epoch: int,
    step_decay_iters: int = 50,
    step_gamma: float = 0.1,
    exp_gamma: float = 0.95,
):
    """A function `step (int) -> learning rate (float)` for `policy`."""
    spe = max(steps_per_epoch, 1)

    if policy == "const_linear":
        def schedule(step):
            epoch = int(step) // spe
            return lr * (1.0 - max(0, epoch - n_epochs)
                         / float(n_epochs_decay + 1))
        return schedule

    if policy == "linear":
        total = n_epochs + n_epochs_decay

        def schedule(step):
            epoch = min(int(step) // spe, total)
            return lr * (1.0 + (5e-2 - 1.0) * (epoch / max(total, 1)))
        return schedule

    if policy == "exponential":
        def schedule(step):
            return lr * exp_gamma ** (int(step) // spe)
        return schedule

    if policy == "step":
        def schedule(step):
            return lr * step_gamma ** ((int(step) // spe) // step_decay_iters)
        return schedule

    if policy == "cosine":
        total = max(n_epochs + n_epochs_decay, 1)

        def schedule(step):
            epoch = int(step) // spe
            return lr * (1 + math.cos(math.pi * epoch / total)) / 2.0
        return schedule

    if policy == "plateau":
        raise ValueError(
            "plateau is loss-driven; drive PlateauState from the train loop"
        )
    raise NotImplementedError(f"lr policy {policy} not implemented")


@dataclasses.dataclass
class PlateauState:
    """ReduceLROnPlateau state with the reference's settings (mode 'min',
    factor 0.5, relative threshold 1e-4, patience 5, min_lr 1e-7), stepped
    on the validation loss at the evaluation cadence."""

    lr: float
    factor: float = 0.5
    threshold: float = 1e-4
    patience: int = 5
    min_lr: float = 1e-7
    best: float = float("inf")
    num_bad: int = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr
