"""Shared helpers of the PyTorch-port parity tests (no tests of its own):
build the port's nets from the JAX package's configs and parameters.

Importing it also sizes torch's CPU thread pool under pytest-xdist
(`share_cores_between_workers`): every worker collects every test
module, so this import reaches each worker before its first test."""

from __future__ import annotations

import dataclasses
import os

import jax
import numpy as np
import torch

from i2sdf_tpu_torch.models import mlp as tmlp


def share_cores_between_workers() -> None:
    """Give each pytest-xdist worker its share of the cores for torch's
    CPU ops (at least one thread). By default every worker's thread pool
    is as wide as the machine: with 6 workers on 8 cores that is 48
    threads, and the pools' spinning waits then slow torch's ops by over
    an order of magnitude (six concurrent 2-step fits of the tiny scene's
    trainer on 8 cores: ~363 s each at 8 threads, ~11 s at one;
    `scripts/thread_share_probe.py`). Outside xdist the pool stays as
    torch sets it."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
    if os.environ.get("PYTEST_XDIST_WORKER") and workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


share_cores_between_workers()


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_cfg(cls, jcfg):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                  if k in names})


def implicit_from_jax(jparams, jcfg) -> tmlp.ImplicitNet:
    net = tmlp.ImplicitNet(_port_cfg(tmlp.ImplicitNetConfig, jcfg),
                           torch.Generator().manual_seed(0))
    net.load_state_dict({f"{lin}.{leaf}": torch.from_numpy(np.array(v))
                         for lin, leaves in to_numpy(jparams).items()
                         for leaf, v in leaves.items()})
    return net


def rendering_from_jax(jparams, jcfg) -> tmlp.RenderingNet:
    net = tmlp.RenderingNet(_port_cfg(tmlp.RenderingNetConfig, jcfg),
                            torch.Generator().manual_seed(0))
    net.load_state_dict({f"{lin}.{leaf}": torch.from_numpy(np.array(v))
                         for lin, leaves in to_numpy(jparams).items()
                         for leaf, v in leaves.items()})
    return net



def perturbed(jparams, seed):
    """The JAX parameters with every leaf moved by 0.01 N(0, 1), drawn with
    numpy (`chip_smoke.perturbed_net`'s perturbation): off the init's zero
    encoding rows of layer 0 and the skip, which hide layout faults."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.01 * rng.normal(size=np.shape(v)).astype(
            np.float32), to_numpy(jparams))


class JaxDraws:
    """`i2sdf_tpu_torch.utils.draws.Draws`' interface on a JAX key: each
    node's draws are JAX's own (`jax.random.uniform`, `normal`, `randint`,
    `categorical`), as f32 (int64) CPU tensors, so the port walks JAX's
    key tree to the same numbers."""

    def __init__(self, key):
        self.key = key

    device = torch.device("cpu")

    def split(self, n):
        return [JaxDraws(k) for k in jax.random.split(self.key, n)]

    def fold_in(self, i):
        return JaxDraws(jax.random.fold_in(self.key, i))

    def uniform(self, shape):
        return torch.from_numpy(np.array(jax.random.uniform(
            self.key, tuple(shape))))

    def normal(self, shape):
        return torch.from_numpy(np.array(jax.random.normal(
            self.key, tuple(shape))))

    def integers(self, shape, high):
        return torch.from_numpy(np.array(jax.random.randint(
            self.key, tuple(shape), 0, high)).astype(np.int64))

    def randint(self, high):
        return int(jax.random.randint(self.key, (), 0, high))

    def categorical(self, logits):
        return int(jax.random.categorical(
            self.key, jax.numpy.asarray(logits.cpu().numpy())))
