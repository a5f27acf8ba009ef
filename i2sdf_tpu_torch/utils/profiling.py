"""Trace capture for the training loop (counterpart of
`i2sdf_tpu/utils/profiling.py`), on `torch.profiler`.

`TraceProfiler` records a window of training steps, host (CPU) and, on
the card, CUDA activity, and writes one Chrome trace
(`<exp_dir>/profile/trace_<start>_<count>.json`, viewable in Perfetto or
`chrome://tracing`). Each step inside the window is a `train` range;
named host phases (`bubble_pdf_init`, `validation`) come from
`annotate()`, and the render core's launches (K3 and K4, in
`ops/kernels/render_core.py`) are ranges named after their launch
counters (`render_core_fwd`, `render_core_bwd_light_idr`, ...).

Usage (the CLI's `--profile START[:COUNT]`):

    prof = TraceProfiler.from_spec(exp_dir, "100:5")
    for step in range(max_steps):
        prof.maybe_start(step)
        with prof.step(step):
            metrics = train_step(...)
        prof.maybe_stop(step)
    prof.close()
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch import profiler as tprof


class TraceProfiler:
    """Captures `n_steps` training steps from `start_step`; inactive (every
    method a no-op) when `start_step` is None."""

    def __init__(self, exp_dir: str, start_step: int | None = None,
                 n_steps: int = 5):
        self.start_step = start_step
        self.n_steps = max(int(n_steps), 1) if start_step is not None else 0
        self.logdir = os.path.join(exp_dir, "profile")
        self.active = False
        self.done = start_step is None
        self.prof = None
        self.first = None
        self.path = None

    @classmethod
    def from_spec(cls, exp_dir: str, spec: str | None) -> "TraceProfiler":
        """The CLI's `--profile` spec: "START:COUNT" or "START" (COUNT 5);
        empty or None turns it off."""
        if not spec:
            return cls(exp_dir)
        parts = spec.split(":")
        count = int(parts[1]) if len(parts) > 1 and parts[1] else 5
        return cls(exp_dir, start_step=int(parts[0]), n_steps=count)

    def maybe_start(self, step: int) -> None:
        if self.done or self.active or step < self.start_step:
            return
        os.makedirs(self.logdir, exist_ok=True)
        acts = [tprof.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(tprof.ProfilerActivity.CUDA)
        self.prof = tprof.profile(activities=acts)
        self.prof.__enter__()
        self.active, self.first = True, step
        print(f"[INFO] profiler: tracing steps [{step}, "
              f"{step + self.n_steps}) -> {self.logdir}")

    def step(self, step: int):
        """A range around one training step inside the window."""
        if not self.active:
            return contextlib.nullcontext()
        return tprof.record_function(f"train/step_{step}")

    def maybe_stop(self, step: int) -> None:
        """Stop after the window's last step (the device's work of that
        step is waited for, so that the trace holds it)."""
        if self.active and step >= self.first + self.n_steps - 1:
            self._stop()

    def close(self) -> None:
        """Write an open trace (training ended inside the window)."""
        if self.active:
            self._stop()

    def _stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.path = os.path.join(
            self.logdir, f"trace_{self.first}_{self.n_steps}.json")
        self.prof.export_chrome_trace(self.path)
        self.active, self.done = False, True
        print(f"[INFO] profiler: trace written to {self.path}")


def annotate(name: str):
    """A named host phase in the trace: `with annotate("validation"): ...`
    (a range in the host's track, also outside a window, where it costs a
    few microseconds)."""
    return tprof.record_function(name)
