"""Parameter converter between the JAX package and the port.

The JAX parameter tree is `{"implicit": {"lin{i}": {"v", "g", "b"}},
"rendering": {...}, "beta": scalar}`, `"light": {...}` in the light-mask
config, and `"bg_implicit"`, `"bg_rendering"` with the NeRF++ background
(`{"w", "b"}` leaves where `weight_norm` is off), with weights stored
(in, out); the port stores them
the same way (`models/mlp.py`), so a leaf crosses as it is, under the key
`"{net}.lin{i}.{leaf}"`. The tree is taken as numpy arrays (the port
never imports JAX): convert with `np.asarray` first.

The material stage's tree, `{"material": {"lin{i}": {"v", "g", "b"}},
"emission": {"log_radiance", "log_ambient"}}`, crosses the same way into
`models/material.py::MaterialStage` (`material_from_jax`,
`material_to_jax`).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.renderer import I2SDFConfig, I2SDFModel

# "light" and the background's nets only where the config has them
NETS = ("implicit", "rendering", "light", "bg_implicit", "bg_rendering")


def from_jax_params(tree: dict, cfg: I2SDFConfig | None = None) -> dict:
    """JAX parameter tree (numpy leaves) -> the port's `state_dict`.
    With `cfg`, keys and shapes are checked against the model."""
    sd = {}
    for net in (n for n in NETS if n in tree):
        for lin, leaves in tree[net].items():
            for leaf, arr in leaves.items():
                sd[f"{net}.{lin}.{leaf}"] = torch.from_numpy(
                    np.array(arr, dtype=np.float32))
    sd["beta"] = torch.tensor(float(np.asarray(tree["beta"])),
                              dtype=torch.float32)
    if cfg is not None:
        ref = I2SDFModel(cfg).state_dict()
        if set(ref) != set(sd):
            raise KeyError(f"parameter names differ: "
                           f"{sorted(set(ref) ^ set(sd))}")
        for k, v in ref.items():
            if tuple(v.shape) != tuple(sd[k].shape):
                raise ValueError(f"{k}: shape {tuple(sd[k].shape)}, model "
                                 f"wants {tuple(v.shape)}")
    return sd


def to_jax_params(state_dict: dict) -> dict:
    """The port's `state_dict` -> JAX parameter tree with numpy leaves."""
    tree: dict = {}
    for key, v in state_dict.items():
        arr = v.detach().cpu().numpy().astype(np.float32)
        if key == "beta":
            tree["beta"] = arr
            continue
        net, lin, leaf = key.split(".")
        tree.setdefault(net, {}).setdefault(lin, {})[leaf] = arr
    return tree


def load_model(cfg: I2SDFConfig, ckpt: str, seed: int,
               device) -> I2SDFModel:
    """The model with weights from a `.pt` file: a state_dict, or a
    training checkpoint (its "model" entry). `seed` only builds the
    modules the weights are loaded into."""
    model = I2SDFModel(cfg, seed=seed)
    state = torch.load(ckpt, map_location="cpu", weights_only=True)
    model.load_state_dict(state.get("model", state.get("state_dict", state)))
    return model.to(device)


def material_from_jax(tree: dict, stage: torch.nn.Module | None = None
                      ) -> dict:
    """JAX material-stage tree (numpy leaves) -> the `state_dict` of a
    `MaterialStage`. With `stage`, keys and shapes are checked against
    it."""
    sd = {f"material.{lin}.{leaf}": torch.from_numpy(
              np.array(arr, dtype=np.float32))
          for lin, leaves in tree["material"].items()
          for leaf, arr in leaves.items()}
    sd.update({f"emission.{k}": torch.from_numpy(
        np.array(v, dtype=np.float32)) for k, v in tree["emission"].items()})
    if stage is not None:
        ref = stage.state_dict()
        if set(ref) != set(sd):
            raise KeyError(f"parameter names differ: "
                           f"{sorted(set(ref) ^ set(sd))}")
        for k, v in ref.items():
            if tuple(v.shape) != tuple(sd[k].shape):
                raise ValueError(f"{k}: shape {tuple(sd[k].shape)}, stage "
                                 f"wants {tuple(v.shape)}")
    return sd


def material_to_jax(state_dict: dict) -> dict:
    """A `MaterialStage`'s `state_dict` -> JAX material-stage tree with
    numpy leaves."""
    tree: dict = {"material": {}, "emission": {}}
    for key, v in state_dict.items():
        arr = v.detach().cpu().numpy().astype(np.float32)
        net, *rest = key.split(".")
        if net == "emission":
            tree["emission"][rest[0]] = arr
        else:
            tree["material"].setdefault(rest[0], {})[rest[1]] = arr
    return tree
