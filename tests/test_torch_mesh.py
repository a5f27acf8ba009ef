"""The port's mesh extraction and scoring (`i2sdf_tpu_torch/eval/mesh.py`)
against the JAX package's (`i2sdf_tpu/eval/mesh.py`, its `fused=False`
path), on the CPU, where K1's wrapper takes its plain f32 version.

The nets are made anisotropic (layer 0's x, y, z rows scaled by 0.6, 1,
1.6) and then perturbed (`perturbed`): the geometric init's sphere has
three near-equal covariance eigenvalues, so its PCA frame is ill-posed
and two f32 evaluations of one net could pick frames a large rotation
apart. Each test that needs the frame asserts its eigenvalue gaps.
Meshes are compared in world space, by nearest-neighbour distance both
ways, never vertex by vertex.

Tolerances, with their reasons:
* SDF grids: 1e-5 absolute and relative (both f32; the nets sum in
  other orders, and the port builds the fine grid's points on its device
  as `p @ vecs + mean` product by product where numpy calls a matmul);
* each stage fed the same input (marching, surface samples, frame,
  aligned axes, refuse, evaluate, voxel downsample): equal to the bit,
  the same numpy and the same C++ sources;
* whole extractions (`assert_same_surface`): nearest-neighbour
  distances both ways at most 0.05 of the fine grid's spacing on average
  and 0.5 at worst. The two coarse grids differ at f32 rounding; that
  sends a few of the 10,000 surface samples to other triangles (the
  area-weighted draw over the triangles), so the frames differ by ~3e-4
  and the two fine grids sample the surface at points a little apart
  (measured at the CLI's mesh: 0.008 and 0.39 of the spacing);
* `--score`: the GT's refuse to the bit (the same mesh, poses and K);
  the prediction's, whose input differs as above, with its vertices
  within 0.05 of refuse's 1 cm voxel both ways on average and two voxels
  at worst (a silhouette pixel that flips changes the observed voxels at
  the fused surface's rim; measured: 0.024 and 1.24 voxels); the five
  scores within 0.01.
"""

import os

import jax
import numpy as np
import pytest
import torch

from i2sdf_tpu import native as jnative
from i2sdf_tpu.config import load_cfg as jax_load_cfg
from i2sdf_tpu.eval import mesh as jmesh
from i2sdf_tpu.eval import mesh_io as jio
from i2sdf_tpu.models import renderer as jrenderer
from i2sdf_tpu.models.mlp import ImplicitNetConfig, implicit_net_init
from i2sdf_tpu_torch import main as tmain
from i2sdf_tpu_torch import native
from i2sdf_tpu_torch.config import load_cfg
from i2sdf_tpu_torch.eval import mesh as tmesh
from i2sdf_tpu_torch.eval import mesh_io as tio
from i2sdf_tpu_torch.models import renderer
from i2sdf_tpu_torch.ops.kernels import sdf_mlp
from i2sdf_tpu_torch.params import from_jax_params
from test_torch_helpers import implicit_from_jax, perturbed, to_numpy
from test_torch_train_step import write_tiny_scene

CFG = ImplicitNetConfig(
    feature_vector_size=8, sdf_bounding_sphere=0.0, dims=(32, 32, 32),
    skip_in=(1,), bias=0.6, embed_type="positional", multires=4)
BOUNDARY = (-1.5, 1.5)
WORLD_TOL = 1e-4
SCALES = (0.6, 1.0, 1.6)


def anisotropic(jparams, scales=SCALES):
    """The implicit net's parameters with layer 0's rows for the raw x, y
    and z (the encoding's first three) scaled: an ellipsoid, whose
    covariance eigenvalues are well apart."""
    jp = jax.tree_util.tree_map(np.array, to_numpy(jparams))
    jp["lin0"]["v"][:3] *= np.asarray(scales, np.float32)[:, None]
    return jp


def assert_well_posed(surf, gap=1.2):
    c = surf - surf.mean(0)
    ev = np.linalg.eigvalsh(c.T @ c)
    assert ev[1] > gap * ev[0] and ev[2] > gap * ev[1], ev


def world_distances(a, b):
    """Largest nearest-neighbour distance from a's vertices to b's and
    from b's to a's."""
    return max(float(native.nn_distances(b, a).max()),
               float(native.nn_distances(a, b).max()))


def assert_same_surface(a, b, spacing):
    """Two marchings of one surface in world space: nearest-neighbour
    distances both ways within 0.05 of the grid spacing on average and
    0.5 at worst."""
    d = np.concatenate([native.nn_distances(b, a), native.nn_distances(a, b)])
    assert d.mean() < 0.05 * spacing and d.max() < 0.5 * spacing, (
        d.mean() / spacing, d.max() / spacing)


@pytest.fixture(scope="module")
def nets():
    jp = perturbed(anisotropic(implicit_net_init(jax.random.PRNGKey(0),
                                                 CFG)), 3)
    return jp, implicit_from_jax(jp, CFG)


def test_extract_mesh_stages_match_jax(nets):
    """Each stage of the port's extraction against the JAX package's
    functions called stage by stage, on the same inputs: the coarse grid,
    its mesh, the surface samples, the PCA frame, the aligned grid's
    axes, the fine grid; then the whole extraction in world space."""
    jp, net = nets
    rec = {}
    verts, tris = tmesh.extract_mesh(net, resolution=40,
                                     grid_boundary=BOUNDARY,
                                     coarse_resolution=32, record=rec)
    # stage 1: the coarse grid
    pts, axes = jmesh._uniform_grid(32, BOUNDARY)
    for a, b in zip(tmesh._uniform_grid(32, BOUNDARY), axes):
        np.testing.assert_array_equal(a, b)
    jgrid = jmesh._eval_sdf_grid(jp, CFG, pts, fused=False).reshape(
        32, 32, 32)
    np.testing.assert_allclose(rec["coarse"]["grid"], jgrid, atol=1e-5,
                               rtol=1e-5)
    # its mesh: the port's marching on JAX's grid is JAX's
    jvc, jtc = jnative.marching_cubes(
        jgrid, 0.0, origin=tuple(a[0] for a in axes),
        spacing=tuple(a[1] - a[0] for a in axes))
    vc, tc = tmesh._march(jgrid, axes)
    np.testing.assert_array_equal(vc, jvc)
    np.testing.assert_array_equal(tc, jtc)
    assert world_distances(rec["coarse_mesh"][0], jvc) < WORLD_TOL
    # the surface samples and the frame
    jsurf = jio.sample_surface(jvc, jtc, 10_000)
    np.testing.assert_array_equal(tio.sample_surface(vc, tc, 10_000), jsurf)
    assert_well_posed(jsurf)
    mean = jsurf.mean(0)
    _, eigvecs = np.linalg.eigh((jsurf - mean).T @ (jsurf - mean))
    jvecs = eigvecs.T[::-1].copy()
    if np.linalg.det(jvecs) < 0:
        jvecs[[1, 2]] = jvecs[[2, 1]]
    vecs, tmean = tmesh._surface_frame(jsurf)
    np.testing.assert_array_equal(vecs, jvecs)
    np.testing.assert_array_equal(tmean, mean)
    np.testing.assert_allclose(rec["frame"][0], jvecs, atol=1e-4)
    # the aligned grid's axes
    aligned = (jsurf - mean) @ jvecs.T
    pts_a, jaxes = jmesh._aligned_grid(aligned, 40)
    for a, b in zip(tmesh._aligned_grid(aligned, 40), jaxes):
        np.testing.assert_array_equal(a, b)
    assert ([len(a) for a in rec["fine"]["axes"]]
            == [len(a) for a in jaxes])
    # the fine grid, its points built on the port's device
    g = tmesh._eval_sdf_grid(sdf_mlp.SdfMlpPack(net), jaxes, (jvecs, mean))
    jg = jmesh._eval_sdf_grid(jp, CFG, pts_a @ jvecs + mean, fused=False)
    np.testing.assert_allclose(g.numpy(), jg.reshape(g.shape), atol=1e-5,
                               rtol=1e-5)
    # the whole extraction, in world space
    jverts, jtris = jmesh.extract_mesh(jp, CFG, resolution=40,
                                       grid_boundary=BOUNDARY,
                                       coarse_resolution=32, fused=False)
    assert len(tris) > 1000 and verts.dtype == np.float32
    assert_same_surface(verts, jverts, jaxes[0][1] - jaxes[0][0])
    assert abs(len(tris) - len(jtris)) <= len(jtris) // 1000
    assert rec["points"] == 32 ** 3 + g.numel()
    assert rec["chunks"] == 2


def test_grid_points_are_the_meshgrid_in_the_frame():
    """Chunks of the device-built points at every start (across rows and
    planes) against numpy's meshgrid, raw and as `p @ vecs + mean`."""
    rng = np.random.default_rng(0)
    axes = [np.sort(rng.uniform(-1, 1, n)).astype(np.float32)
            for n in (5, 7, 3)]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1)
    vecs = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    mean = rng.normal(size=3).astype(np.float32)
    t = [torch.from_numpy(a) for a in axes]
    frame = (torch.from_numpy(vecs), torch.from_numpy(mean))
    for start, stop in ((0, 105), (0, 4), (3, 25), (20, 22), (101, 105)):
        np.testing.assert_array_equal(
            tmesh.grid_points(t, start, stop).numpy(), pts[start:stop])
        np.testing.assert_allclose(
            tmesh.grid_points(t, start, stop, frame).numpy(),
            pts[start:stop] @ vecs + mean, atol=1e-6)


def test_sdf_grid_runs_in_chunks(nets, monkeypatch):
    """ceil(n / batch) calls of K1's wrapper, the last one partial, whose
    values are the plain net's over the whole grid."""
    _, net = nets
    sizes = []
    wrapped = sdf_mlp.sdf_mlp_nograd

    def counting(pack, points):
        sizes.append(len(points))
        return wrapped(pack, points)

    monkeypatch.setattr(sdf_mlp, "sdf_mlp_nograd", counting)
    axes = tmesh._uniform_grid(9, BOUNDARY)
    g = tmesh._eval_sdf_grid(sdf_mlp.SdfMlpPack(net), axes, batch=100)
    assert sizes == [100] * 7 + [29]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    pts = torch.from_numpy(np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1))
    np.testing.assert_array_equal(
        g.numpy().ravel(), sdf_mlp.sdf_mlp_plain(net, pts).numpy())


def _analytic(radius, port: bool):
    """An analytic sphere SDF in place of each package's grid evaluator."""
    if port:
        def fake(pack, axes, frame=None, batch=tmesh.CHUNK):
            t = [torch.from_numpy(a) for a in axes]
            f = None if frame is None else tuple(
                torch.from_numpy(np.asarray(a, np.float32)) for a in frame)
            n = len(axes[0]) * len(axes[1]) * len(axes[2])
            p = tmesh.grid_points(t, 0, n, f)
            return (torch.linalg.norm(p, dim=-1) - radius).view(
                *(len(a) for a in axes))
        return fake

    def jfake(params, cfg, pts, batch=2_000_000, fused=None):
        return np.linalg.norm(pts, axis=-1) - radius
    return jfake


@pytest.mark.parametrize("case", ["sphere", "scale_mat"])
def test_extract_mesh_analytic(nets, monkeypatch, case):
    """The JAX package's analytic cases (tests/test_eval_systems.py): a
    sphere of radius 0.8 comes out at 0.8, and a scale_mat of 2 doubles a
    sphere of 0.5; both in world space as the JAX package's."""
    radius, scale, res, coarse, bound = (
        (0.8, None, 96, 48, (-1.5, 1.5)) if case == "sphere"
        else (0.5, np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32), 64, 32,
              (-1, 1)))
    monkeypatch.setattr(tmesh, "_eval_sdf_grid", _analytic(radius, True))
    monkeypatch.setattr(jmesh, "_eval_sdf_grid", _analytic(radius, False))
    verts, _ = tmesh.extract_mesh(nets[1], resolution=res,
                                  grid_boundary=bound, scale_mat=scale,
                                  coarse_resolution=coarse)
    jverts, _ = jmesh.extract_mesh(None, None, resolution=res,
                                   grid_boundary=bound, scale_mat=scale,
                                   coarse_resolution=coarse)
    radii = np.linalg.norm(verts, axis=1)
    want = radius * (1 if scale is None else 2)
    np.testing.assert_allclose(radii.mean(), want, atol=0.02)
    assert radii.std() < 0.02 * want / 0.8
    assert world_distances(verts, jverts) < 1e-2 * want


def _cameras(n=4):
    poses = []
    for ang in np.linspace(0.3, 2 * np.pi + 0.3, n, endpoint=False):
        c, s = np.cos(ang), np.sin(ang)
        eye = np.array([2.2 * c, 0.4, 2.2 * s])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 0], pose[:3, 1] = right, np.cross(fwd, right)
        pose[:3, 2], pose[:3, 3] = fwd, eye
        poses.append(pose)
    K = np.array([[40.0, 0, 24, 0], [0, 40.0, 18, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float32)
    return poses, K


def test_refuse_evaluate_and_downsample_equal_jax(nets):
    """`refuse`, `depth2mesh`, `voxel_downsample` and `evaluate` on the
    same meshes and poses: the JAX package's results to the bit."""
    verts, tris = tmesh.extract_mesh(nets[1], resolution=32,
                                     grid_boundary=BOUNDARY,
                                     coarse_resolution=24)
    poses, K = _cameras()
    pv, pt = tmesh.refuse(verts, tris, poses, K, 36, 48, far_clip=4.0,
                          voxel_length=0.03)
    jv, jt = jmesh.refuse(verts, tris, poses, K, 36, 48, far_clip=4.0,
                          voxel_length=0.03)
    assert len(pt) > 500
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pt, jt)
    depths = [native.rasterize_depth(verts, tris, K,
                                     np.linalg.inv(p).astype(np.float32),
                                     36, 48) for p in poses]
    dv, dt = tmesh.depth2mesh(depths, poses, K, 36, 48, voxel_length=0.06)
    jdv, jdt = jmesh.depth2mesh(depths, poses, K, 36, 48, voxel_length=0.06)
    assert len(dt) > 100
    np.testing.assert_array_equal(dv, jdv)
    np.testing.assert_array_equal(dt, jdt)
    np.testing.assert_array_equal(tmesh.voxel_downsample(verts, 0.05),
                                  jmesh.voxel_downsample(verts, 0.05))
    shifted = verts + np.array([0.02, 0.0, 0.01], np.float32)
    for a, b, kw in ((pv, verts, {}), (shifted, verts, {"threshold": 0.02}),
                     (verts[::3], verts, {"down_sample": 0.0})):
        m = tmesh.evaluate(a, b, **kw)
        assert m == jmesh.evaluate(a, b, **kw)
        assert all(np.isfinite(v) for v in m.values())


def _mesh_scene(tmp_path):
    """The tiny scene (two 24 x 32 views of scan1) with a narrower SDF net
    (3 x 32, skip at 1, 4 frequencies: the 100^3 coarse grid is the
    JAX package's, fixed), a GT `mesh.ply` (an analytic ellipsoid,
    marched) in its scan directory, and both
    packages' model at anisotropic, perturbed weights, the port's saved
    as a state_dict. Returns (config path, JAX config, JAX params, the
    state_dict's path)."""
    conf = write_tiny_scene(str(tmp_path))
    narrow = (open(conf).read()
              .replace("dims: [64, 64, 64, 64]", "dims: [32, 32, 32]")
              .replace("skip_in: [2]", "skip_in: [1]")
              .replace("multires: 6", "multires: 4"))
    with open(conf, "w") as f:
        f.write(narrow)
    xs = np.linspace(-1.2, 1.2, 48, dtype=np.float32)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    gv, gt = jnative.marching_cubes(
        np.sqrt((X / 1.2) ** 2 + Y ** 2 + (Z / 0.8) ** 2) - 0.7, 0.0,
        origin=(xs[0],) * 3, spacing=(xs[1] - xs[0],) * 3)
    jio.write_ply(str(tmp_path / "tiny" / "scan0" / "mesh.ply"), gv, gt)
    jcfg = jrenderer.I2SDFConfig.from_cfgnode(jax_load_cfg(conf).model)
    params = to_numpy(jrenderer.init(jax.random.PRNGKey(0), jcfg))
    params["implicit"] = perturbed(anisotropic(params["implicit"]), 5)
    tcfg = renderer.I2SDFConfig.from_cfgnode(load_cfg(conf).model)
    model = renderer.I2SDFModel(tcfg)
    model.load_state_dict(from_jax_params(params, tcfg))
    pt = str(tmp_path / "model.pt")
    torch.save(model.state_dict(), pt)
    return conf, jcfg, params, pt


def _read_metrics(path):
    with open(path) as f:
        return {k: float(v) for k, v in
                (line.split(": ") for line in f.read().splitlines())}


def test_run_mesh_eval_and_cli_match_jax(tmp_path):
    """`--test_mode mesh --score` through the port's CLI (weights from a
    state_dict converted from JAX parameters) against the JAX package's
    `run_mesh_eval(fused=False)` on the same scene: the PLY in world
    space, and the scores the refused meshes give; the CLI's files."""
    conf, jcfg, params, pt = _mesh_scene(tmp_path)
    args = ["--conf", conf, "--device", "cpu", "--data_root", str(tmp_path),
            "--exps_folder", str(tmp_path / "exps"), "--test",
            "--test_mode", "mesh", "--resolution", "40", "--score",
            "--ckpt", pt]
    assert tmain.main(args) == 0
    out = tmp_path / "exps" / "quality_0" / "version_0" / "eval" / "mesh"
    assert sorted(os.listdir(out)) == [
        "metrics.txt", "scan0.html", "scan0.ply", "scan0_gt.ply",
        "scan0_refined.ply"]
    jconf = jax_load_cfg(conf)
    jply = jmesh.run_mesh_eval(params, jcfg, jconf, str(tmp_path / "jax"),
                               data_root=str(tmp_path), resolution=40,
                               score=True, fused=False)
    verts, tris = tio.read_ply(str(out / "scan0.ply"))
    jverts, jtris = jio.read_ply(jply)
    assert len(tris) > 1000
    assert abs(len(tris) - len(jtris)) <= len(jtris) // 1000
    # the fine grid's spacing: the shortest of the surface's extents in
    # its frame, plus 0.1 each side, over 39 steps
    axes = np.linalg.svd(verts - verts.mean(0), full_matrices=False)[2]
    ext = np.ptp(verts @ axes.T, axis=0).min()
    assert_same_surface(verts, jverts, (ext + 0.2) / 39)
    # the GT's refuse takes the same mesh, poses and K: the same bits; the
    # prediction's differs at f32 rounding, which can flip a silhouette
    # pixel and so the observed voxels at the fused surface's rim
    jdir = os.path.dirname(jply)
    gv, gt = tio.read_ply(str(out / "scan0_gt.ply"))
    jgv, jgt = jio.read_ply(os.path.join(jdir, "scan0_gt.ply"))
    assert len(gt) > 100
    np.testing.assert_array_equal(gv, jgv)
    np.testing.assert_array_equal(gt, jgt)
    rv, _ = tio.read_ply(str(out / "scan0_refined.ply"))
    jrv, _ = jio.read_ply(os.path.join(jdir, "scan0_refined.ply"))
    d = np.concatenate([native.nn_distances(jrv, rv),
                        native.nn_distances(rv, jrv)])
    assert len(rv) > 100 and d.mean() < 0.05 * 0.01
    assert d.max() < 2 * 0.01  # two of refuse's 1 cm voxels
    m = _read_metrics(out / "metrics.txt")
    jm = _read_metrics(os.path.join(jdir, "metrics.txt"))
    assert list(m) == ["ACC", "COMP", "PREC", "RECAL", "F-SCORE"] == list(jm)
    for k, v in m.items():
        assert np.isfinite(v) and v == pytest.approx(jm[k], abs=0.01), k
    html = open(out / "scan0.html").read()
    assert "2 cameras" in html and "faces" in html


@pytest.mark.parametrize("extra", [
    ["--test", "--test_mode", "relight"],
    ["--test", "--test_mode", "relight_video"],
    ["--test", "--test_mode", "mesh", "--use_material"],
    ["--test", "--test_mode", "mesh", "--is_val"],
    ["--material"]])
def test_cli_refuses_what_is_not_ported(tmp_path, extra):
    """The CLI refuses the modes and flags the port lacks. `--is_val` was
    one of them until the held-out views were ported, the relight modes
    until relighting was, the material stage's flags until it was: the
    mesh mode now takes `--is_val` (as the JAX CLI does, which ignores it
    there) and `--use_material`, the relight modes and `--material` run,
    each going on to look for the experiment's checkpoint, of which this
    one has none."""
    conf = write_tiny_scene(str(tmp_path))
    with pytest.raises(SystemExit, match="no checkpoint under"):
        tmain.main(["--conf", conf, "--device", "cpu", "--data_root",
                    str(tmp_path), "--exps_folder", str(tmp_path / "exps"),
                    *extra])


def test_train_cli_val_mesh(tmp_path):
    """`--val_mesh`: the validation at the last step writes
    `plots/mesh/{step}.ply` and its viewer, the extraction of the step's
    weights at the config's `plot.resolution` with a coarse grid of at
    most 64."""
    conf = write_tiny_scene(str(tmp_path))
    text = open(conf).read()
    assert "    resolution: 100\n" in text and "bubble_weight: 0.5" in text
    with open(conf, "w") as f:  # no bubble window: no pdf render
        f.write(text.replace("    resolution: 100\n", "    resolution: 40\n")
                .replace("bubble_weight: 0.5", "bubble_weight: 0.0"))
    args = ["--conf", conf, "--device", "cpu", "--data_root", str(tmp_path),
            "--exps_folder", str(tmp_path / "exps"), "--log_every", "1"]
    assert tmain.main(args + ["--max_steps", "1", "--val_mesh"]) == 0
    exp = tmp_path / "exps" / "quality_0" / "version_0"
    assert sorted(os.listdir(exp / "plots" / "mesh")) == ["1.html", "1.ply"]
    verts, tris = tio.read_ply(str(exp / "plots" / "mesh" / "1.ply"))
    model = renderer.I2SDFModel(renderer.I2SDFConfig.from_cfgnode(
        load_cfg(conf).model))
    model.load_state_dict(torch.load(exp / "checkpoints" / "step_1.pt",
                                     weights_only=True)["model"])
    rec = {}
    want = tmesh.extract_mesh(model.implicit, resolution=40,
                              grid_boundary=(-2.1, 2.1),
                              coarse_resolution=40, record=rec)
    assert rec["coarse"]["grid"].shape == (40, 40, 40)
    np.testing.assert_array_equal(verts, want[0])
    np.testing.assert_array_equal(tris, want[1])
