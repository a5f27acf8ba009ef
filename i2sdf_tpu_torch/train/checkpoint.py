"""Checkpoints (counterpart of `i2sdf_tpu/train/checkpoint.py`, which uses
orbax): one `torch.save` file a step under `<dir>/step_<n>.pt` with the
model (every net of it, the light net in the light-mask config), the
optimizer, the step and, inside the bubble window, the pdf and
sample counts (so a mid-window resume keeps its importance sampling, as
the JAX package does). A file is written to a temporary name and renamed
into place, so a crash never leaves a half-written checkpoint; the
newest `max_to_keep` are kept.
"""

from __future__ import annotations

import os
import re

import torch

from .state import TrainState

_NAME = re.compile(r"step_(\d+)\.pt")


class CheckpointManager:
    def __init__(self, ckpt_dir: str, max_to_keep: int = 3):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.ckpt_dir, exist_ok=True)

    @staticmethod
    def list_steps(ckpt_dir: str) -> list[int]:
        """The steps of the checkpoints in `ckpt_dir`, ascending."""
        return sorted(int(m.group(1)) for f in os.listdir(ckpt_dir)
                      if (m := _NAME.fullmatch(f)))

    def steps(self) -> list[int]:
        return self.list_steps(self.ckpt_dir)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"step_{step}.pt")

    def save(self, state: TrainState, bubble: dict | None = None) -> str:
        payload = {"step": state.step,
                   "model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict()}
        if bubble is not None:
            payload["bubble"] = {k: v.detach().cpu()
                                 for k, v in bubble.items()}
        path = self.path(state.step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return path

    def restore(self, state: TrainState, step: int | None = None):
        """Load into `state` (model and optimizer in place); returns the
        bubble dict (CPU tensors) or None."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.ckpt_dir}")
        payload = torch.load(self.path(step), map_location="cpu",
                             weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return payload.get("bubble")
