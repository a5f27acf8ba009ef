"""Train state: the model, Adam (eps 1e-15) and the learning-rate schedule
(counterpart of `i2sdf_tpu/train/state.py`, which uses optax).

Optimizer parity with the reference (`trainer/recon.py:201-207`): Adam,
betas (0.9, 0.999), eps 1e-15. The schedule is applied as optax applies
it: the update of step t (counted from 0) uses `schedule(t)`, set on the
optimizer just before its step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

Schedule = Callable[[int], float]


def make_lr_schedule(learning_rate: float, decay_rate: float,
                     decay_steps: int) -> Schedule:
    """lr(t) = lr0 * decay_rate ** (t / decay_steps) (optax's
    `exponential_decay`, not staircased)."""
    def schedule(step: int) -> float:
        return learning_rate * decay_rate ** (step / decay_steps)
    return schedule


def make_reference_lr_schedule(learning_rate: float, decay_rate: float,
                               n_images: int, total_pixels: int,
                               batch_size: int) -> Schedule:
    """The reference's actual decay, bugs included (`train.
    reference_lr_schedule: true`; see `i2sdf_tpu/train/state.py:32-61`):
    decay_steps = nepochs * n_images with nepochs from a hard-coded 200000,
    stepped once per epoch of ceil(n_images * total_pixels / batch_size)
    steps."""
    epoch_steps = max(int(math.ceil(n_images * total_pixels / batch_size)),
                      1)
    nepochs = max(int(math.ceil(200_000 / (n_images * total_pixels
                                           / batch_size))), 1)
    decay_steps = nepochs * n_images

    def schedule(step: int) -> float:
        return learning_rate * decay_rate ** ((step // epoch_steps)
                                              / decay_steps)
    return schedule


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule

    def apply_gradients(self) -> None:
        """One Adam update at this step's learning rate; step += 1."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def create_train_state(model: torch.nn.Module, learning_rate: float = 5e-4,
                       decay_rate: float = 0.1, decay_steps: int = 200_000,
                       schedule: Schedule | None = None) -> TrainState:
    if schedule is None:
        schedule = make_lr_schedule(learning_rate, decay_rate, decay_steps)
    opt = torch.optim.Adam(model.parameters(), lr=schedule(0),
                           betas=(0.9, 0.999), eps=1e-15)
    return TrainState(step=0, model=model, optimizer=opt, schedule=schedule)
