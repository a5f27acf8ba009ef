"""Training losses (counterpart of `i2sdf_tpu/models/losses.py`).

L1 rgb, eikonal, normal smoothness (step-gated), mask BCE, masked depth
MSE, normal L1 / angular, bubble |sdf| and light-mask BCE, as the JAX
package computes them: boolean masks become masked means, and the
bubble window's weight toggling is a host-side schedule
(`dynamic_weights`). `angular_reference_bug` reproduces the reference's
dispatch of the L1 normal loss in the angular branch.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..utils.jmath import safe_norm

TERMS = ("rgb_loss", "eikonal_loss", "smooth_loss", "mask_loss",
         "depth_loss", "normal_loss", "angular_loss", "bubble_loss",
         "light_mask_loss")


@dataclasses.dataclass(frozen=True)
class LossConfig:
    eikonal_weight: float = 0.1
    smooth_weight: float = 0.0
    mask_weight: float = 0.0
    depth_weight: float = 0.1
    normal_weight: float = 0.05
    angular_weight: float = 0.0
    bubble_weight: float = 0.0
    light_mask_weight: float = 0.0
    min_bubble_iter: int = 0
    max_bubble_iter: int | None = None
    smooth_iter: int | None = None
    angular_reference_bug: bool = False

    def __post_init__(self):
        # bubbles conflict with smoothness: push smooth_iter past the
        # bubble window (parity network/__init__.py:304-305)
        if (self.bubble_weight > 0 and self.max_bubble_iter is not None
                and (self.smooth_iter or 0) < self.max_bubble_iter):
            object.__setattr__(self, "smooth_iter", self.max_bubble_iter)

    @classmethod
    def from_cfgnode(cls, conf) -> "LossConfig":
        return cls(
            eikonal_weight=conf.get("eikonal_weight", 0.1),
            smooth_weight=conf.get("smooth_weight", 0.0),
            mask_weight=conf.get("mask_weight", 0.0),
            depth_weight=conf.get("depth_weight", 0.1),
            normal_weight=conf.get("normal_weight", 0.05),
            angular_weight=conf.get("angular_weight", 0.0),
            bubble_weight=conf.get("bubble_weight", 0.0),
            light_mask_weight=conf.get("light_mask_weight", 0.0),
            min_bubble_iter=conf.get("min_bubble_iter", 0),
            max_bubble_iter=conf.get("max_bubble_iter", None),
            smooth_iter=conf.get("smooth_iter", None),
            angular_reference_bug=conf.get("angular_reference_bug", False),
        )

    def in_bubble(self, step: int) -> bool:
        return (self.bubble_weight > 0 and self.max_bubble_iter is not None
                and self.min_bubble_iter <= step < self.max_bubble_iter)

    def dynamic_weights(self, step: int) -> dict:
        """Per-step loss weights (bubble window semantics), host floats."""
        bubble = self.in_bubble(step)
        smooth_on = self.smooth_iter is None or step > self.smooth_iter
        return {
            "eikonal": self.eikonal_weight,
            "smooth": self.smooth_weight if smooth_on else 0.0,
            "mask": self.mask_weight,
            "depth": self.depth_weight,
            "normal": 0.0 if bubble else self.normal_weight,
            "angular": 0.0 if bubble else self.angular_weight,
            "bubble": self.bubble_weight if bubble else 0.0,
            "light_mask": self.light_mask_weight,
        }


def _masked_mean(values, mask):
    # where (not multiply): masked-out entries may be NaN
    mask = mask.bool()
    kept = torch.where(mask, values, torch.zeros_like(values))
    return kept.sum() / torch.clamp(mask.to(values.dtype).sum(), min=1.0)


def bce(pred, target, clip: float = 1e-3):
    pred = torch.clamp(pred, clip, 1.0 - clip)
    return -torch.mean(target * torch.log(pred)
                       + (1 - target) * torch.log(1 - pred))


def rgb_l1(pred, gt):
    return torch.mean(torch.abs(pred - gt.reshape(-1, 3)))


def eikonal(grad_theta):
    return torch.mean((safe_norm(grad_theta, dim=1) - 1.0) ** 2)


def depth_mse(depth, depth_gt, depth_mask):
    return _masked_mean((depth - depth_gt.reshape(-1)) ** 2,
                        depth_mask.reshape(-1))


def _sanitize_gt(normal_gt, normal_mask):
    """Masked-out GT normals -> (0, 0, 1): invalid entries may be NaN."""
    gt = normal_gt.reshape(-1, 3)
    fill = torch.zeros_like(gt)
    fill[:, 2] = 1.0
    return torch.where(normal_mask.reshape(-1, 1).bool(), gt, fill)


def normal_l1(normal, normal_gt, normal_mask):
    dot = (normal * _sanitize_gt(normal_gt, normal_mask)).sum(-1)
    return _masked_mean(torch.abs(1.0 - dot), normal_mask.reshape(-1))


def normal_angular(normal, normal_gt, normal_mask):
    dot = (normal * _sanitize_gt(normal_gt, normal_mask)).sum(-1)
    angle = torch.arccos(torch.clamp(dot, -1.0 + 1e-6, 1.0 - 1e-6)) / math.tau
    return _masked_mean(torch.clamp(angle, max=0.5), normal_mask.reshape(-1))


def compute_losses(outputs: dict, gt: dict, weights: dict,
                   angular_reference_bug: bool = False) -> dict:
    """Weighted loss (`loss`) and its nine terms, as 0-d tensors."""
    angular_fn = normal_l1 if angular_reference_bug else normal_angular
    zero = outputs["rgb_values"].new_zeros(())
    has_normal = "normal" in gt and "normal_values" in outputs
    terms = {
        "rgb_loss": rgb_l1(outputs["rgb_values"], gt["rgb"]),
        "eikonal_loss": (eikonal(outputs["grad_theta"])
                         if "grad_theta" in outputs else zero),
        "smooth_loss": (outputs["diff_norm"].mean()
                        if "diff_norm" in outputs else zero),
        "mask_loss": (bce(outputs["weight_sum"], gt["mask"])
                      if "mask" in gt else zero),
        "depth_loss": (depth_mse(outputs["depth_values"], gt["depth"],
                                 gt["depth_mask"])
                       if "depth" in gt else zero),
        "normal_loss": (normal_l1(outputs["normal_values"], gt["normal"],
                                  gt["normal_mask"])
                        if has_normal else zero),
        "angular_loss": (angular_fn(outputs["normal_values"], gt["normal"],
                                    gt["normal_mask"])
                         if has_normal else zero),
        "bubble_loss": (outputs["surface_sdf"].abs().mean()
                        if "surface_sdf" in outputs else zero),
        "light_mask_loss": (bce(outputs["light_mask"].reshape(-1, 1),
                                gt["light_mask"].reshape(-1, 1))
                            if "light_mask" in outputs
                            and "light_mask" in gt else zero),
    }
    terms["loss"] = (
        terms["rgb_loss"]
        + weights["eikonal"] * terms["eikonal_loss"]
        + weights["smooth"] * terms["smooth_loss"]
        + weights["mask"] * terms["mask_loss"]
        + weights["depth"] * terms["depth_loss"]
        + weights["normal"] * terms["normal_loss"]
        + weights["angular"] * terms["angular_loss"]
        + weights["bubble"] * terms["bubble_loss"]
        + weights["light_mask"] * terms["light_mask_loss"])
    return terms
