"""Random draws in the shape of the JAX package's key tree.

The JAX package's relight code splits its PRNG key per view, per chunk,
per emitter and per sample (`jax.random.split`, `fold_in`) and draws each
uniform from its own leaf. The port's functions take a `Draws` and walk
the same tree: `split(n)` and `fold_in(i)` name the children, `uniform`,
`normal`, `randint`, `integers` and `categorical` draw at a node. Here every node reads one
`torch.Generator` in call order, so a split costs nothing and the stream
stays on the generator's device. Threefry and Philox never agree bit for
bit, so the CPU tests hand the port a source with the same methods that
replays JAX's keys instead (`tests/test_torch_helpers.py::JaxDraws`).
"""

from __future__ import annotations

import torch


class Draws:
    """Uniform draws from one `torch.Generator`, with the key tree's
    interface (children share the stream)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    @classmethod
    def seeded(cls, seed: int, device="cpu") -> "Draws":
        return cls(torch.Generator(device=device).manual_seed(int(seed)))

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def split(self, n: int) -> list["Draws"]:
        return [self] * n

    def fold_in(self, i: int) -> "Draws":
        return self

    def uniform(self, shape) -> torch.Tensor:
        """f32 uniforms in [0, 1) of `shape`, on the generator's device."""
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device)

    def normal(self, shape) -> torch.Tensor:
        """f32 standard normals of `shape`, on the generator's device."""
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device)

    def integers(self, shape, high: int) -> torch.Tensor:
        """int64 integers in [0, high) of `shape` (`jax.random.randint(key,
        shape, 0, high)`), on the generator's device."""
        return torch.randint(high, tuple(shape), generator=self.generator,
                             device=self.device)

    def randint(self, high: int) -> int:
        """One integer in [0, high)."""
        return int(torch.randint(high, (), generator=self.generator,
                                 device=self.device))

    def categorical(self, logits: torch.Tensor) -> int:
        """One index drawn with probabilities softmax(logits) (Gumbel-max,
        as `jax.random.categorical` draws it)."""
        u = self.uniform(logits.shape).to(logits.device)
        u = u.clamp(min=torch.finfo(torch.float32).tiny)
        return int(torch.argmax(logits - torch.log(-torch.log(u))))
