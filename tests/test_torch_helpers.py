"""Shared helpers of the PyTorch-port parity tests (no tests of its own):
build the port's nets from the JAX package's configs and parameters."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from i2sdf_tpu_torch.models import mlp as tmlp


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
