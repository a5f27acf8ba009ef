"""Point-cloud clustering for emitter groups (counterpart of
`i2sdf_tpu/ops/clustering.py`): K-Means++ seeding, fixed-count Lloyd
iterations and `init_emission_groups`.

K-Means++ takes its first pick and each later one from a
`utils.draws.Draws` (`randint`, then `categorical` on log d^2), walking
the JAX key tree (`split` into the first key and the rest, then one
`split` a round), so the tests can hand it JAX's picks. The distances
are the JAX package's broadcast form, so equal centroids give equal
labels. DBSCAN seeding (`use_dbscan`) needs scikit-learn, which the card
does not have and no entry point reaches (the relight path clusters
without it); it raises.
"""

from __future__ import annotations

import torch

from ..utils.draws import Draws


def _d2(points: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    return ((points[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)


def kmeans_pp_init(draws: Draws, points: torch.Tensor, k: int) -> torch.Tensor:
    """K-Means++ seeding: (k, 3) centroids picked among `points`."""
    n = points.shape[0]
    k0, draws = draws.split(2)
    centroids = points.new_zeros((k, 3))
    centroids[0] = points[k0.randint(n)]
    cols = torch.arange(k, device=points.device)[None, :]
    for i in range(1, k):
        d2 = torch.min(_d2(points, centroids)
                       + torch.where(cols < i, 0.0, float("inf")), dim=-1
                       ).values
        draws, kc = draws.split(2)
        idx = kc.categorical(torch.log(torch.clamp(d2, min=1e-12)))
        centroids[i] = points[idx]
    return centroids


def kmeans(points: torch.Tensor, centroids: torch.Tensor,
           iters: int = 50) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd iterations from `centroids`; an empty cluster keeps its
    centroid. Returns (labels (N,), centroids (k, 3))."""
    k = centroids.shape[0]
    for _ in range(iters):
        labels = torch.argmin(_d2(points, centroids), dim=-1)
        one_hot = torch.nn.functional.one_hot(labels, k).to(points.dtype)
        filled = one_hot.sum(0)
        new = (one_hot.T @ points) / torch.clamp(filled, min=1.0)[:, None]
        centroids = torch.where((filled > 0)[:, None], new, centroids)
    return torch.argmin(_d2(points, centroids), dim=-1), centroids


def init_emission_groups(draws: Draws, pointcloud: torch.Tensor,
                         n_emitters: int, init_emission: float = 1.0,
                         use_dbscan: bool = False):
    """Cluster emitter points; returns (labels, centroids, emissions
    (n_emitters, 3) filled with `init_emission`)."""
    if use_dbscan:
        raise NotImplementedError(
            "use_dbscan needs scikit-learn's DBSCAN, which the port does not "
            "take (the card's machine lacks it); no entry point uses it: "
            "the relight path seeds with K-Means++")
    centroids = kmeans_pp_init(draws, pointcloud, n_emitters)
    labels, centroids = kmeans(pointcloud, centroids)
    emissions = torch.full((n_emitters, 3), init_emission,
                           dtype=torch.float32, device=pointcloud.device)
    return labels, centroids, emissions
