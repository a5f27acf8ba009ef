"""The port's emitter clustering (`i2sdf_tpu_torch/ops/clustering.py`)
against the JAX package's (`i2sdf_tpu/ops/clustering.py`) on the CPU:
K-Means++ picks walking JAX's key tree (`JaxDraws`: JAX's own `randint`
and `categorical`), Lloyd's labels equal from the same centroids and the
centroids at atol 1e-5; `use_dbscan` raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2sdf_tpu.ops import clustering as jc
from i2sdf_tpu_torch.ops import clustering as tc
from i2sdf_tpu_torch.utils.draws import Draws
from test_torch_helpers import JaxDraws


def _blobs(k, n=600, seed=0):
    """k Gaussian blobs of 3-D points (unequal sizes, one far away)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2, 2, (k, 3))
    centers[-1] += 4.0
    sizes = rng.multinomial(n - k * 10, np.ones(k) / k) + 10
    return np.concatenate([c + 0.15 * rng.normal(size=(m, 3))
                           for c, m in zip(centers, sizes)]).astype(
        np.float32)


@pytest.mark.parametrize("k,seed", [(1, 0), (2, 1), (3, 2), (5, 3)])
def test_kmeans_pp_picks_equal_jax(k, seed):
    pts = _blobs(max(k, 2), seed=seed)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jc.kmeans_pp_init(key, jnp.asarray(pts), k))
    got = tc.kmeans_pp_init(JaxDraws(key), torch.from_numpy(pts), k)
    # every centroid is one of the points: equal picks, equal values
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,iters", [(2, 50), (4, 50), (4, 3)])
def test_kmeans_labels_and_centroids_match_jax(k, iters):
    pts = _blobs(k, seed=k)
    rng = np.random.default_rng(k + 10)
    init = pts[rng.choice(len(pts), k, replace=False)]
    if k == 4:  # one centroid far from every point: an empty cluster
        init[-1] = 40.0
    jl, jcent = jc.kmeans(jnp.asarray(pts), jnp.asarray(init), iters=iters)
    tl, tcent = tc.kmeans(torch.from_numpy(pts), torch.from_numpy(init),
                          iters=iters)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tcent.numpy(), np.asarray(jcent), atol=1e-5,
                               rtol=0)
    if k == 4:  # the empty cluster kept its place
        np.testing.assert_array_equal(tcent.numpy()[-1], init[-1])


def test_init_emission_groups_matches_jax_and_refuses_dbscan():
    pts = _blobs(3, seed=7)
    key = jax.random.PRNGKey(7)
    jl, jcent, jem = jc.init_emission_groups(key, jnp.asarray(pts), 3,
                                             init_emission=2.5)
    tl, tcent, tem = tc.init_emission_groups(JaxDraws(key),
                                             torch.from_numpy(pts), 3,
                                             init_emission=2.5)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tcent.numpy(), np.asarray(jcent), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    with pytest.raises(NotImplementedError, match="scikit-learn"):
        tc.init_emission_groups(JaxDraws(key), torch.from_numpy(pts), 3,
                                use_dbscan=True)


def test_generator_draws_cluster_the_blobs():
    """On the port's own generator: each blob gets one cluster, and the
    categorical never picks a zero-probability point."""
    pts = torch.from_numpy(_blobs(3, seed=11))
    labels, cent, _ = tc.init_emission_groups(Draws.seeded(3), pts, 3)
    assert len(set(labels.tolist())) == 3
    logits = torch.full((50,), float("-inf"))
    logits[17] = 0.0
    d = Draws.seeded(0)
    assert {d.categorical(logits) for _ in range(20)} == {17}
    assert all(0 <= d.randint(5) < 5 for _ in range(20))
