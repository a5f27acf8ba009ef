"""The emitter and light half of the port's relighting
(`i2sdf_tpu_torch/eval/relight.py`) and its edit data
(`i2sdf_tpu_torch/data/relight.py`, `utils/imaging.resize_area`) against
the JAX package's, on the CPU: the visibility march on an analytic SDF
and a narrow net (flags equal except where the closest approach is within
1e-5 of eps), the carved SDF, the incident radiance, emitter discovery
from GT masks and depth (the mask pixels, and the brightest-pixels
fallback) and from a model's light head, the clustering with its
subsample; emitters at atol 1e-4 with JAX's draws (`JaxDraws`). The area
resize is held to OpenCV's INTER_AREA (skipped without cv2), the edit
maps and `edited_materials` to the JAX `RelightData`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2sdf_tpu.data import ReconData as JReconData
from i2sdf_tpu.data import generate_synthetic_scene
from i2sdf_tpu.data.plot import PlotData as JPlotData
from i2sdf_tpu.data.relight import RelightData as JRelightData
from i2sdf_tpu.eval import relight as jrel
from i2sdf_tpu.models import mlp as jmlp
from i2sdf_tpu.train.step import make_eval_render_fn as jax_eval_render
from i2sdf_tpu_torch.data.plot import PlotData
from i2sdf_tpu_torch.data.recon import ReconData
from i2sdf_tpu_torch.data.relight import RelightData
from i2sdf_tpu_torch.eval import relight as trel
from i2sdf_tpu_torch.models import mlp as tmlp
from i2sdf_tpu_torch.train.step import make_eval_render_fn
from i2sdf_tpu_torch.utils import imaging
from test_torch_helpers import JaxDraws
from test_torch_indirect import CENTERS, RADII, _pair, _rays
from test_torch_relight_cli import light_pair

ATOL = 1e-4


def _trace_pair(sdf_j, sdf_t, o, d, t_max, n_steps, eps=2e-3):
    """Both marches, and the closest approach of the JAX one (replayed
    here) to mark its rays within 1e-5 of eps."""
    want = jrel.sphere_trace_visibility(sdf_j, jnp.asarray(o), jnp.asarray(d),
                                        jnp.asarray(t_max), n_steps=n_steps)
    got = trel.sphere_trace_visibility(sdf_t, torch.from_numpy(o),
                                       torch.from_numpy(d),
                                       torch.from_numpy(t_max),
                                       n_steps=n_steps)
    tm = np.maximum(t_max, 2e-2)
    t, min_s = np.full(len(o), 2e-2, np.float32), np.full(len(o), np.inf)
    for _ in range(n_steps):
        s = np.asarray(sdf_j(jnp.asarray(o + t[:, None] * d)))
        min_s = np.minimum(min_s, s)
        t = np.minimum(t + np.maximum(s, tm / n_steps), tm)
    edge = np.abs(min_s - eps) < 1e-5
    return got.numpy(), np.asarray(want), edge


def test_visibility_matches_jax_on_analytic_sdf():
    o, d = _rays(400, 3)
    o = o * 0.2 + np.array([0.0, 0.0, -3.0], np.float32)
    d = (d + np.array([0.0, 0.0, 2.0], np.float32))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_max = np.random.default_rng(0).uniform(0.5, 6.0, 400).astype(
        np.float32)

    def jsdf(p):
        return jnp.linalg.norm(p, axis=-1) - 1.0

    def tsdf(p):
        return torch.linalg.norm(p, dim=-1) - 1.0

    for n_steps in (8, 32):
        got, want, edge = _trace_pair(jsdf, tsdf, o, d, t_max, n_steps)
        np.testing.assert_array_equal(got[~edge], want[~edge])
        assert 0 < want.sum() < len(want)


def _outside(n, seed):
    """Origins between radius 1.1 and 1.6 (outside the net's surface, a
    sphere of radius ~0.8) and random unit directions."""
    o, d = _rays(n, seed)
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * np.linspace(
        1.1, 1.6, n)[:, None]
    return o.astype(np.float32), d


def test_visibility_matches_jax_on_a_net():
    jcfg, params, model = _pair()
    o, d = _outside(300, 4)
    t_max = np.random.default_rng(1).uniform(0.1, 3.0, 300).astype(
        np.float32)
    got, want, edge = _trace_pair(
        lambda p: jmlp.sdf_vals(params["implicit"], jcfg.implicit, p)[:, 0],
        lambda p: tmlp.sdf_vals(model.implicit, p)[:, 0], o, d, t_max, 16)
    np.testing.assert_array_equal(got[~edge], want[~edge])
    assert 0 < want.sum() < len(want) and edge.sum() <= 3


def test_carve_and_incident_radiance_match_jax():
    jcfg, params, model = _pair()

    def jsdf(p):
        return jmlp.sdf_vals(params["implicit"], jcfg.implicit, p)[:, 0]

    def tsdf(p):
        return tmlp.sdf_vals(model.implicit, p)[:, 0]

    rng = np.random.default_rng(9)
    p = rng.uniform(-1.5, 1.5, (200, 3)).astype(np.float32)
    jc = jrel.carve_emitters_sdf(jsdf, jnp.asarray(CENTERS),
                                 jnp.asarray(RADII))
    tc = trel.carve_emitters_sdf(tsdf, torch.from_numpy(CENTERS),
                                 torch.from_numpy(RADII))
    np.testing.assert_allclose(tc(torch.from_numpy(p)).numpy(),
                               np.asarray(jc(jnp.asarray(p))), atol=1e-5)
    radiance = np.array([[3.0, 2.0, 1.0], [0.5, 1.0, 2.0]], np.float32)
    o, d = _outside(200, 5)
    # aim half the rays at the emitters
    aim = CENTERS[np.arange(100) % 2] - o[:100]
    d[:100] = aim / np.linalg.norm(aim, axis=-1, keepdims=True)
    jem = jrel.Emitters(CENTERS, RADII, radiance)
    tem = trel.Emitters(CENTERS, RADII, radiance)
    want = jrel.make_incident_radiance_fn(jsdf, jem, n_steps=16)(
        jnp.asarray(o), jnp.asarray(d))
    got = trel.make_incident_radiance_fn(tsdf, tem, n_steps=16)(
        torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert float(np.asarray(want).max()) > 0.4


def _emitters_close(got, want):
    assert got.count == want.count
    for a in ("centers", "radii", "radiance"):
        np.testing.assert_allclose(getattr(got, a).numpy(),
                                   np.asarray(getattr(want, a)), atol=ATOL)


@pytest.mark.parametrize("views,res,n_emitters", [
    (3, (20, 24), 1),    # no view sees the fixture: the brightest pixels
    (4, (32, 40), 1),    # view 3 looks at the fixture: its mask pixels
    (4, (32, 40), 2)])
def test_find_emitters_matches_jax(tmp_path, capsys, views, res,
                                   n_emitters):
    generate_synthetic_scene(str(tmp_path / "demo"), n_images=views,
                             img_res=res)
    kw = dict(scan_id=0, data_root=str(tmp_path), use_depth=True,
              use_lightmask=True)
    key = jax.random.PRNGKey(3)
    want = jrel.find_emitters(JReconData("demo", **kw), n_emitters=n_emitters,
                              emitter_scale=1.5, key=key)
    jout = capsys.readouterr().out
    got = trel.find_emitters(ReconData("demo", **kw), n_emitters=n_emitters,
                             emitter_scale=1.5, draws=JaxDraws(key))
    assert capsys.readouterr().out == jout
    assert ("brightest pixels" in jout) == (views == 3)
    _emitters_close(got, want)
    assert float(got.radii.min()) > 0


def test_cluster_emitters_subsample_matches_jax():
    """More points than `max_points`: the same numpy subsample in both."""
    rng = np.random.default_rng(4)
    pts = np.concatenate([c + 0.1 * rng.normal(size=(700, 3))
                          for c in CENTERS]).astype(np.float32)
    rgbs = rng.uniform(size=(1400, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jrel._cluster_emitters(pts, rgbs, 3, 2.0, 500, key)
    got = trel._cluster_emitters(pts, rgbs, 3, 2.0, 500, JaxDraws(key),
                                 "cpu")
    _emitters_close(got, want)


def test_find_emitters_from_model_matches_jax(tmp_path):
    generate_synthetic_scene(str(tmp_path / "demo"), n_images=3,
                             img_res=(20, 24))
    jcfg, params, model, _ = light_pair(str(tmp_path))
    jrender, _ = jax_eval_render(jcfg, chunk_size=512, fused_sampler=False)
    trender = make_eval_render_fn(model, chunk_size=512, fused=False)
    jpd = JPlotData("demo", data_root=str(tmp_path), plot_nimgs=-1)
    tpd = PlotData("demo", data_root=str(tmp_path))
    key = jax.random.PRNGKey(6)
    for kw in (dict(mask_thresh=0.05), dict(n_emitters=2)):
        want = jrel.find_emitters_from_model(params, jrender, jpd, key=key,
                                             **kw)
        got = trel.find_emitters_from_model(trender, tpd,
                                            draws=JaxDraws(key), **kw)
        _emitters_close(got, want)


@pytest.mark.parametrize("src,dst", [((40, 56), (20, 28)),
                                     ((40, 56), (17, 23)),
                                     ((20, 24), (33, 41)),
                                     ((20, 24), (40, 48)),
                                     ((30, 20), (17, 33))])
def test_resize_area_matches_opencv(src, dst):
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(sum(src + dst)).uniform(
        size=src + (3,)).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    got = imaging.resize_area(img, dst)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6)
    grey = img[..., :1]
    np.testing.assert_allclose(
        imaging.resize_area(grey, dst)[..., 0],
        cv2.resize(grey, dst[::-1], interpolation=cv2.INTER_AREA),
        atol=1e-6)


def test_edit_maps_and_edited_materials_match_jax(tmp_path):
    """Edit maps at other sizes than the render (PNG kd shrunk, `.npy`
    normal grown, PNG mask and roughness), read and resized by both
    packages, then blended over seeded materials."""
    generate_synthetic_scene(str(tmp_path / "demo"), n_images=3,
                             img_res=(20, 24))
    rng = np.random.default_rng(8)
    paths = {k: str(tmp_path / f"{k}.png") for k in ("kd", "mask", "rough")}
    imaging.write_png(paths["kd"], rng.integers(0, 256, (37, 45, 3),
                                                dtype=np.uint8))
    imaging.write_png(paths["mask"], (rng.uniform(size=(10, 12)) > 0.5)
                      .astype(np.uint8) * 255)
    imaging.write_png(paths["rough"], rng.integers(0, 256, (20, 24),
                                                   dtype=np.uint8))
    paths["normal"] = str(tmp_path / "normal.npy")
    np.save(paths["normal"], rng.normal(size=(13, 17, 3)).astype(np.float32))
    paths["ks"] = str(tmp_path / "missing.png")  # skipped by both
    kw = dict(scan_id=0, data_root=str(tmp_path), indices=[1],
              edit_conf=paths)
    want = JRelightData("demo", plot_nimgs=-1, **kw)
    got = RelightData("demo", **kw)
    assert sorted(got.edits) == sorted(want.edits) == [
        "kd", "mask", "normal", "rough"]
    for k in got.edits:
        np.testing.assert_allclose(got.edits[k], want.edits[k], atol=1e-6)
    n = 20 * 24
    mats = (rng.uniform(size=(n, 3)).astype(np.float32),
            np.full((n, 3), 0.04, np.float32),
            np.full((n, 1), 0.5, np.float32),
            rng.normal(size=(n, 3)).astype(np.float32))
    g, w = got.edited_materials(*mats), want.edited_materials(*mats)
    for k in ("kd", "ks", "rough", "normal"):
        np.testing.assert_allclose(g[k], w[k], atol=1e-6)
