"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and `nvcc`; elsewhere each skips, as
decided when it runs. The file imports neither JAX nor the JAX package, so
it runs on a machine that has only PyTorch (with `--noconftest`, since the
suite's conftest sets up JAX):

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu \
        tests/test_torch_gpu_kernels.py

Tolerances: the MLP kernels take bf16 operands with f32 accumulation, so
they are held to the JAX package's tolerances for its bf16 Pallas kernels
(tests/test_pallas_mlp.py, tests/test_pallas_train.py); the sampler round
is f32 in both versions, with the JAX package's own sampler-kernel
tolerance for the draws (tests/test_pallas_sampler.py). K4's, K5's and
K6's tests, those of K3 and K4 with the light head, and those of K7-K9
say theirs beside them.
"""

import copy
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from i2sdf_tpu_torch.eval import mesh as tmesh
from i2sdf_tpu_torch.models import mlp
from i2sdf_tpu_torch.models import sampler as tsampler
from i2sdf_tpu_torch.models.sampler import SamplerConfig
from i2sdf_tpu_torch.ops import kernels
from i2sdf_tpu_torch.ops.kernels import (bg_core, conv_check, render_core,
                                         rev, sampler_round, sdf_grad,
                                         sdf_mlp, sdf_outputs)

pytestmark = pytest.mark.gpu

ICFG = mlp.ImplicitNetConfig(
    feature_vector_size=256, sdf_bounding_sphere=0.0, dims=(256,) * 8,
    skip_in=(4,), bias=0.6, embed_type="positional", multires=6)
# the flagship with an odd number of hidden layers: a fault that exchanges
# two tangent streams at every layer cancels over an even depth
ICFG_ODD = dataclasses.replace(ICFG, dims=(256,) * 7)
RCFG = mlp.RenderingNetConfig(feature_vector_size=256, dims=(256,) * 4,
                              embed_type="positional", multires=4)
SCFG = SamplerConfig(eps=0.1, beta_iters=10, add_tiny=1e-6)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    return torch.device("cuda", 0)


def _nets(dev, seed=0, icfg=ICFG):
    gen = torch.Generator().manual_seed(seed)
    return (mlp.ImplicitNet(icfg, gen).to(dev),
            mlp.RenderingNet(RCFG, gen).to(dev))


def _points(n, dev, seed=1, scale=1.5):
    return torch.from_numpy((np.random.default_rng(seed).normal(
        size=(n, 3)) * scale).astype(np.float32)).to(dev)


# K1 and K3 (csrc/wgmma_layer.cuh) at the init's weights and at weights
# perturbed by 0.01 N(0, 1) (the init's zero encoding rows of layer 0 and
# the skip hide layout faults), at counts on both sides of their blocks'
# edges (K1: 128 points, two warpgroups of 64; K3: 32). K1 is held to
# the f32 plain op at both weights (the JAX package's K1 stays inside that
# bound at the smoke's perturbed weights: `scripts/witness_perturbed.py`);
# K3 perturbed to the plain op at its weights rounded to bf16, the
# kernels' operands: there the JAX package's own render-core kernel is
# past the f32 bound at a few points too (12 of the smoke's 1,164,000),
# none against the bf16 weights.

EDGE_COUNTS = [1, 31, 33, 127, 129, 4097]
WEIGHTS = pytest.mark.parametrize("perturbed", [False, True],
                                  ids=["init", "perturbed"])


def _perturb(*nets, seed=10):
    """Copies of the nets with every parameter moved by 0.01 N(0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for net in nets:
        net = copy.deepcopy(net)
        with torch.no_grad():
            for p in net.parameters():
                p.add_(0.01 * torch.randn(p.shape, generator=gen).to(p.device))
        out.append(net)
    return out


def _bf16(ts):
    return tuple(t.detach().to(torch.bfloat16).float() for t in ts)


def _bf16w_sdf(net, pts):
    """K1's plain version at the net's weights rounded to bf16."""
    ws = _bf16([lin.weight() for lin in net.layers()])
    bs = [lin.b.detach() for lin in net.layers()]
    with torch.no_grad():
        sdf = mlp.implicit_apply(net.cfg, ws, bs, pts)[:, :1]
        return mlp.clamp_sdf(net.cfg, sdf, pts)[:, 0]


def _bf16w_core(net, rnet, x, d, lnet=None):
    """K3's plain version (sphere-clamped) at the nets' weights rounded to
    bf16."""
    w = render_core.CoreWeights.of(net, rnet, lnet)
    w = dataclasses.replace(w, ws_sdf=_bf16(w.ws_sdf), ws_rad=_bf16(w.ws_rad),
                            ws_l=_bf16(w.ws_l))
    sdf, grad, *rest = render_core.render_core_train_plain(
        net.cfg, rnet.cfg, w, x, d, None if lnet is None else lnet.cfg)
    sdf, grad = render_core._sphere_clamp(net.cfg, x, sdf, grad)
    return tuple(t.detach() for t in (sdf, grad, *rest))


@WEIGHTS
@pytest.mark.parametrize("n", EDGE_COUNTS + [63, 64])
def test_sdf_mlp_kernel(dev, n, perturbed):
    net, _ = _nets(dev)
    if perturbed:
        (net,) = _perturb(net)
    pts = _points(n, dev, seed=n)
    kernels.reset_launch_counts()
    got = sdf_mlp.sdf_mlp_nograd(sdf_mlp.SdfMlpPack(net), pts)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sdf_mlp_nograd"] == 1
    ref = sdf_mlp.sdf_mlp_plain(net, pts)
    torch.testing.assert_close(got, ref, atol=0.02, rtol=0.02)


def _round_inputs(R, S, n_out, dev, seed=0):
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(0.0, 6.0, (R, S)).astype(np.float32), axis=-1)
    sdf = (3.0 - z + 0.1 * rng.normal(size=(R, S))).astype(np.float32)
    beta = rng.uniform(0.05, 0.8, (R,)).astype(np.float32)
    u = np.sort(rng.uniform(0.0, 1.0, (R, n_out)).astype(np.float32), -1)
    return [torch.from_numpy(a).to(dev) for a in (z, sdf, beta, u)]


# K2 spreads a ray over a block of 128 threads (E = ceil(S / 128) samples
# a thread, E <= 2, 4 or 8 by S): S at 2, both sides of 128 and 512 and at
# 1,024, the kernel's range; R at 1 and 2 rays (one and two blocks) and 333.
@pytest.mark.parametrize("S", [2, 97, 128, 480, 600, 1024])
@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("R", [1, 2, 333])
def test_sampler_round_kernel(dev, S, final, R):
    z, sdf, beta, u = _round_inputs(R, S, 64, dev, seed=S)
    beta0 = torch.tensor(0.1, device=dev)
    s, b = sampler_round.sampler_round(SCFG, z, sdf, beta, beta0, u, final)
    torch.cuda.synchronize()
    s_ref, b_ref = sampler_round.sampler_round_plain(SCFG, z, sdf, beta,
                                                     beta0, u, final)
    torch.testing.assert_close(b, b_ref, rtol=1e-4, atol=1e-6)
    diff = (s - s_ref).abs()
    assert float(torch.quantile(diff.flatten(), 0.99)) < 0.08
    assert float(diff.max()) < 0.5
    torch.testing.assert_close(s.mean(-1), s_ref.mean(-1), rtol=0, atol=0.02)


DEPTHS = pytest.mark.parametrize("depth", [8, 7], ids=["even", "odd"])


@WEIGHTS
@DEPTHS
@pytest.mark.parametrize("n", EDGE_COUNTS + [1000])
def test_render_core_kernel(dev, n, perturbed, depth):
    net, rnet = _nets(dev, icfg=ICFG if depth == 8 else ICFG_ODD)
    if perturbed:
        net, rnet = _perturb(net, rnet)
    x = _points(n, dev, seed=n, scale=0.8)
    d = torch.nn.functional.normalize(_points(n, dev, seed=n + 1), dim=-1)
    pack = render_core.RenderCorePack(net, rnet)
    kernels.reset_launch_counts()
    got = render_core.render_core_fwd(pack, x, d)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["render_core_fwd"] == 1
    ref = (_bf16w_core(net, rnet, x, d) if perturbed
           else render_core.render_core_plain(net, rnet, x, d))
    for name, g, r, (atol, rtol) in zip(
            ("sdf", "grad", "rgb"), got, ref,
            ((0.02, 0.02), (0.05, 0.08), (0.03, 0.05))):
        torch.testing.assert_close(g, r, atol=atol, rtol=rtol, msg=name)


# K1 on the mesh path (`eval/mesh.py`): a chunk of an aligned grid's
# points, built on the card as the extraction builds them (flat index ->
# (i, j, k), then `@ vecs + mean`), starting mid-row, at counts on both
# sides of a 128-point block's edge, on a narrow net at the init's and at
# perturbed weights, against the f32 plain net (K1's gate above); the
# points against numpy's meshgrid in the frame (f32 rounding of the
# products, 1e-5); and a grid past 2 M points in two K1 launches, the
# last one partial.
MESH_ICFG = dataclasses.replace(ICFG, feature_vector_size=16,
                                dims=(64,) * 4, skip_in=(2,))


def _mesh_grid(shape_points=500, resolution=60, seed=4):
    """An aligned grid's host axes and a frame (vecs, mean)."""
    rng = np.random.default_rng(seed)
    cloud = rng.normal(size=(shape_points, 3)) * [0.9, 0.6, 0.4]
    axes = tmesh._aligned_grid(cloud.astype(np.float32), resolution)
    vecs = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    if np.linalg.det(vecs) < 0:
        vecs[[1, 2]] = vecs[[2, 1]]
    mean = 0.1 * rng.normal(size=3)
    return axes, (vecs.astype(np.float32), mean.astype(np.float32))


def _host_points(axes, frame, start, stop):
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([X.ravel()[start:stop], Y.ravel()[start:stop],
                    Z.ravel()[start:stop]], -1)
    return pts @ frame[0] + frame[1]


@WEIGHTS
@pytest.mark.parametrize("n", [127, 128, 129, 4097])
def test_sdf_mlp_kernel_on_a_mesh_grid_chunk(dev, n, perturbed):
    net = mlp.ImplicitNet(MESH_ICFG, torch.Generator().manual_seed(0)).to(dev)
    if perturbed:
        (net,) = _perturb(net)
    axes, frame = _mesh_grid()
    start = 3 * len(axes[1]) * len(axes[2]) + 5
    pts = tmesh.grid_points([torch.from_numpy(a).to(dev) for a in axes],
                            start, start + n,
                            tuple(torch.from_numpy(a).to(dev) for a in frame))
    np.testing.assert_allclose(pts.cpu().numpy(),
                               _host_points(axes, frame, start, start + n),
                               atol=1e-5)
    kernels.reset_launch_counts()
    got = sdf_mlp.sdf_mlp_nograd(sdf_mlp.SdfMlpPack(net), pts)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sdf_mlp_nograd"] == 1
    torch.testing.assert_close(got, sdf_mlp.sdf_mlp_plain(net, pts),
                               atol=0.02, rtol=0.02)


def test_mesh_grid_runs_k1_in_2m_point_chunks(dev):
    net = mlp.ImplicitNet(MESH_ICFG, torch.Generator().manual_seed(0)).to(dev)
    (net,) = _perturb(net)
    axes, frame = _mesh_grid(resolution=96)
    n = len(axes[0]) * len(axes[1]) * len(axes[2])
    assert tmesh.CHUNK < n < 2 * tmesh.CHUNK, n  # one full chunk, one part
    kernels.reset_launch_counts()
    grid = tmesh._eval_sdf_grid(sdf_mlp.SdfMlpPack(net), axes, frame)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sdf_mlp_nograd"] == 2
    assert grid.shape == tuple(len(a) for a in axes) and grid.is_cuda
    pts = torch.from_numpy(_host_points(axes, frame, 0, n).astype(
        np.float32)).to(dev)
    torch.testing.assert_close(grid.reshape(-1),
                               sdf_mlp.sdf_mlp_plain(net, pts),
                               atol=0.02, rtol=0.02)


def test_kernels_refuse_cpu_weights(dev):
    net, rnet = _nets(torch.device("cpu"))
    with pytest.raises(ValueError):
        sdf_mlp.sdf_mlp_nograd(sdf_mlp.SdfMlpPack(net), _points(8, dev))
    with pytest.raises(ValueError):
        render_core.render_core_fwd(render_core.RenderCorePack(net, rnet),
                                    _points(8, dev), _points(8, dev))


# ---- K4 render_core_bwd ----------------------------------------------------
# Cotangents are those of the JAX package's kernel-test loss at the plain
# outputs (test_torch_bwd_replay.loss_cotangents), at the init's weights
# and at weights perturbed by 0.01 N(0, 1), on the flagship nets and on the
# same with seven hidden layers.
#
# Against its bf16 replay (the same rounding points) at every count:
# cosine > 0.999, and per leaf (< 0.1) on every entry from 4,800 points
# up. Below that, per leaf on every entry but those of at most one unit
# of each leaf (a bias entry, a weight column): the kernel's wgmma sums
# in another order than the replay's torch products, so now and then one
# activation rounds to the other bf16 neighbour and flips a ReLU mask,
# and at a few points that flip is the whole of one unit's entries of
# one layer's gradients. A missing, zeroed or garbled leaf is off in
# most of its units and fails. The test prints the units it lets pass
# (`-s`).
#
# Against the plain f32 backward: cosine > 0.999 at every count and per
# leaf (< 0.1) from 4,800 points up; below that a few bf16 flips weigh on
# a leaf as much as the signal does (the replay itself is 0.62 from f32
# per leaf at 1 point, 0.018 at 4,800). At perturbed weights the gate is
# the same f32 one: the JAX package's own kernel stays inside it there
# (`scripts/witness_perturbed.py`, test_torch_parity_witness.py).


def _k4_vs_replay(label, n, got, replay):
    """The replay check above."""
    from test_torch_bwd_replay import grad_check
    if n >= 4800:
        return grad_check(got, replay)
    off = {}
    for i, (g, r) in enumerate(zip(got, replay)):
        err = (g - r).abs() / max(float(r.abs().max()), 1e-3)
        units = (err > 0.1).reshape(-1, err.shape[-1]).any(0)
        if units.any():
            off[i] = dict(units=units.nonzero().flatten().tolist(),
                          err=float(err.max()))
    print(json.dumps({"k4_replay": label, "units_off": off}))
    assert all(len(v["units"]) <= 1 for v in off.values()), off
    return grad_check(got, replay, leaf_tol=float("inf"))


def _k4_case(dev, n, eik, perturbed, depth, seed=0):
    from test_torch_bwd_replay import (CASES, eik_only, loss_cotangents,
                                       nets, points)
    net, rnet = nets(*CASES["flagship"], device=dev, depth=depth)
    if perturbed:
        net, rnet = _perturb(net, rnet)
    x, d = points(n, n + seed, eik, device=dev)
    w = render_core.CoreWeights.of(net, rnet)
    cot = eik_only(loss_cotangents(*render_core.render_core_train_plain(
        net.cfg, rnet.cfg, w, x, d)), eik)
    return net, rnet, x, d, w, cot


@WEIGHTS
@DEPTHS
@pytest.mark.parametrize("n,eik", [(1, 0), (31, 0), (33, 16), (65, 0),
                                   (4800, 4800), (160_000, 4800)])
def test_render_core_bwd_kernel(dev, n, eik, perturbed, depth):
    from test_torch_bwd_replay import (emulate_bwd, grad_check, k4_pack,
                                       plain_vjp)
    net, rnet, x, d, w, cot = _k4_case(dev, n, eik, perturbed, depth)
    st, t = k4_pack(net.cfg, rnet.cfg, w)
    with torch.no_grad():
        kernels.reset_launch_counts()
        got = render_core.render_core_bwd(st, t, x, d, cot)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["render_core_bwd"] == 1
        got = [t for grp in got for t in grp]
        replay = [t for grp in emulate_bwd(net.cfg, rnet.cfg, w, x, d, cot)
                  for t in grp]
    _k4_vs_replay(f"flagship {depth} {perturbed} {n}", n, got, replay)
    del replay
    grad_check(got, plain_vjp(net.cfg, rnet.cfg, w, x, d, cot),
               leaf_tol=0.1 if n >= 4800 else float("inf"))


def test_render_core_bwd_padding_rows_add_nothing(dev):
    """33 points and the same 33 plus 31 rows with zero cotangents share
    one padded size (64): the results agree to the bit, and a second
    launch gives the same bits."""
    from test_torch_bwd_replay import CASES, k4_pack, nets, points
    net, rnet = nets(*CASES["flagship"], device=dev)
    x, d = points(64, 3, device=dev)
    cot = torch.randn((64, 8), generator=torch.Generator().manual_seed(0))
    cot = cot.to(dev)
    cot[33:] = 0.0
    st, t = k4_pack(net.cfg, rnet.cfg, render_core.CoreWeights.of(net, rnet))
    with torch.no_grad():
        a = render_core.render_core_bwd(st, t, x[:33].contiguous(),
                                        d[:33].contiguous(),
                                        cot[:33].contiguous())
        b = render_core.render_core_bwd(st, t, x, d, cot)
        c = render_core.render_core_bwd(st, t, x, d, cot)
    for ga, gb, gc in zip([t for g in a for t in g], [t for g in b for t in g],
                          [t for g in c for t in g]):
        assert torch.equal(ga, gb) and torch.equal(gb, gc)


@pytest.mark.parametrize("sphere", [0.0, 1.0])
@pytest.mark.parametrize("n,eik", [(1, 0), (31, 0), (33, 16), (4800, 4800),
                                   (160_000, 4800)])
def test_render_core_train_op(dev, n, eik, sphere):
    """The training op (K3 forward, K4 backward, the sphere clamp outside)
    against the plain op, through autograd to v, g and b."""
    from test_torch_bwd_replay import (CASES, eik_only, grad_check,
                                       loss_cotangents, nets, points)
    net, rnet = nets(*CASES["flagship"], device=dev)
    icfg = mlp.ImplicitNetConfig(**{**net.cfg.__dict__,
                                    "sdf_bounding_sphere": sphere})
    x, d = points(n, n + 1, eik, device=dev)
    leaves = list(net.parameters()) + list(rnet.parameters())
    outs = {}
    for plain in (True, False):
        kernels.reset_launch_counts()
        w = render_core.CoreWeights.of(net, rnet)
        outs[plain] = render_core.render_core_train(icfg, rnet.cfg, w, x, d,
                                                    plain=plain)
        if plain:
            cot = eik_only(loss_cotangents(*outs[True]), eik)
        g = torch.autograd.grad(outs[plain], leaves,
                                (cot[:, 3:4], cot[:, :3], cot[:, 4:7]))
        torch.cuda.synchronize()
        outs[plain] = (outs[plain], list(g))
        want = {"render_core_fwd": 0 if plain else 1,
                "render_core_bwd": 0 if plain else 1}
        counts = kernels.launch_counts()
        assert {k: counts[k] for k in want} == want
    # the clamp takes the sphere's gradient where the sphere is below the
    # net's sdf; next to the sphere the kernel's bf16 sdf may decide the
    # other way, so the gradients are compared where both decide alike
    (sk, gk, rk), (sp, gp, rp) = ((t.detach() for t in outs[p][0])
                                  for p in (False, True))
    agree = torch.ones_like(sk[:, 0], dtype=torch.bool)
    if sphere > 0:
        bound_sdf = sphere - torch.linalg.norm(x, dim=-1, keepdim=True)
        agree = ((sk == bound_sdf) == (sp == bound_sdf))[:, 0]
        assert float(agree.float().mean()) > 0.99
    for name, a, b, (atol, rtol) in zip(
            ("sdf", "grad", "rgb"), (sk, gk[agree], rk), (sp, gp[agree], rp),
            ((0.02, 0.02), (0.05, 0.08), (0.03, 0.05))):
        torch.testing.assert_close(a, b, atol=atol, rtol=rtol, msg=name)
    grad_check(outs[False][1], outs[True][1],
               leaf_tol=0.1 if n >= 4800 else float("inf"))


# ---- K3 and K4 with the idr-mode radiance net -------------------------------
# VolSDF's DTU radiance net at the flagship's widths
# (`test_torch_bwd_replay.nets(mode="idr")`): [pts | PE(view) | normals |
# features], 289 rows, the kernels' order [features | PE(view) | pts |
# grad]. K3 as above (at perturbed weights against the plain op at
# bf16-rounded weights: a swapped pts / grad pair passes at a sphere's
# init, where grad ~ x / |x|); K4, handed K3's gradient as the training op
# hands it, against its replay (handed the same gradient) and the plain f32
# backward as K4 above; the training op through autograd.


def _idr_nets(dev, depth=8, perturbed=False):
    from test_torch_bwd_replay import CASES, nets
    net, rnet = nets(*CASES["flagship"], device=dev, depth=depth, mode="idr")
    return _perturb(net, rnet) if perturbed else (net, rnet)


@WEIGHTS
@DEPTHS
@pytest.mark.parametrize("n", EDGE_COUNTS + [12_000])
def test_render_core_idr_kernel(dev, n, perturbed, depth):
    net, rnet = _idr_nets(dev, depth, perturbed)
    x = _points(n, dev, seed=n, scale=0.8)
    d = torch.nn.functional.normalize(_points(n, dev, seed=n + 1), dim=-1)
    pack = render_core.RenderCorePack(net, rnet)
    kernels.reset_launch_counts()
    got = render_core.render_core_fwd(pack, x, d)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["render_core_fwd_idr"], counts["render_core_fwd"]) == (1, 0)
    ref = (_bf16w_core(net, rnet, x, d) if perturbed
           else render_core.render_core_plain(net, rnet, x, d))
    for name, g, r, (atol, rtol) in zip(
            ("sdf", "grad", "rgb"), got, ref,
            ((0.02, 0.02), (0.05, 0.08), (0.03, 0.05))):
        torch.testing.assert_close(g, r, atol=atol, rtol=rtol, msg=name)


@WEIGHTS
@DEPTHS
@pytest.mark.parametrize("n,eik", [(1, 0), (33, 16), (65, 0), (4800, 4800),
                                   (160_000, 4800)])
def test_render_core_bwd_idr_kernel(dev, n, eik, perturbed, depth):
    from test_torch_bwd_replay import (eik_only, emulate_bwd, grad_check,
                                       k4_pack, loss_cotangents, plain_vjp,
                                       points)
    net, rnet = _idr_nets(dev, depth, perturbed)
    x, d = points(n, n, eik, device=dev)
    w = render_core.CoreWeights.of(net, rnet)
    cot = eik_only(loss_cotangents(*render_core.render_core_train_plain(
        net.cfg, rnet.cfg, w, x, d)), eik)
    st, t = k4_pack(net.cfg, rnet.cfg, w)
    with torch.no_grad():
        g3 = render_core._launch_fwd(st, x, d)[1]
        kernels.reset_launch_counts()
        got = render_core.render_core_bwd(st, t, x, d, cot, grad=g3)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert (counts["render_core_bwd_idr"],
                counts["render_core_bwd"]) == (1, 0)
        got = [t for grp in got for t in grp]
        replay = [t for grp in emulate_bwd(net.cfg, rnet.cfg, w, x, d, cot,
                                           grad=g3) for t in grp]
    _k4_vs_replay(f"idr {depth} {perturbed} {n}", n, got, replay)
    del replay
    grad_check(got, plain_vjp(net.cfg, rnet.cfg, w, x, d, cot),
               leaf_tol=0.1 if n >= 4800 else float("inf"))


@pytest.mark.parametrize("n,eik", [(33, 16), (4800, 4800), (160_000, 4800)])
def test_render_core_idr_train_op(dev, n, eik):
    """The idr training op (K3-idr forward, K4-idr backward on K3's
    gradient) against the plain op, through autograd to v, g and b: the
    outputs against the plain op at the nets' weights rounded to bf16
    (`nets` moves every weight 0.01 N(0, 1) off the init: the perturbed
    case of K3's test above, where the f32 bound is past at a few points
    for the JAX package's kernel too), the gradients against the plain
    f32 backward."""
    from test_torch_bwd_replay import (eik_only, grad_check,
                                       loss_cotangents, points)
    net, rnet = _idr_nets(dev)
    x, d = points(n, n + 1, eik, device=dev)
    leaves = list(net.parameters()) + list(rnet.parameters())
    outs = {}
    for plain in (True, False):
        kernels.reset_launch_counts()
        w = render_core.CoreWeights.of(net, rnet)
        o = render_core.render_core_train(net.cfg, rnet.cfg, w, x, d,
                                          plain=plain)
        if plain:
            cot = eik_only(loss_cotangents(*o), eik)
        g = torch.autograd.grad(o, leaves,
                                (cot[:, 3:4], cot[:, :3], cot[:, 4:7]))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert (counts["render_core_fwd_idr"], counts["render_core_bwd_idr"],
                counts["render_core_fwd"]) == ((0, 0, 0) if plain
                                               else (1, 1, 0))
        outs[plain] = ([t.detach() for t in o], list(g))
    for name, a, b, (atol, rtol) in zip(
            ("sdf", "grad", "rgb"), outs[False][0],
            _bf16w_core(net, rnet, x, d),
            ((0.02, 0.02), (0.05, 0.08), (0.03, 0.05))):
        torch.testing.assert_close(a, b, atol=atol, rtol=rtol, msg=name)
    grad_check(outs[False][1], outs[True][1],
               leaf_tol=0.1 if n >= 4800 else float("inf"))


# ---- K3 and K4 with the light head ------------------------------------------
# At the light-mask config's nets (test_torch_kernel_layout.LIGHT_CASES:
# SDF 6 x 256 with the skip at 3, radiance 3 x 256, light 256 -> 128 -> 1).
# The forward is held to the plain version with the JAX light test's
# tolerances (tests/test_pallas_train.py:171-176: the mask 0.02 / rtol
# 0.03); the backward, with the cotangents of that test's loss (its light
# term included), to its bf16 replay and to the plain f32 backward as K4
# is, for both `detach_light` values.

LIGHT_TOLS = {"sdf": (0.02, 0.02), "grad": (0.05, 0.08), "rgb": (0.03, 0.05),
              "lmask": (0.02, 0.03)}


@WEIGHTS
@pytest.mark.parametrize("case", ["light", "odd"])
@pytest.mark.parametrize("n", EDGE_COUNTS + [12_000])
def test_render_core_light_kernel(dev, n, perturbed, case):
    from test_torch_bwd_replay import light_layout, points
    net, rnet, lnet = light_layout(case, device=dev)
    if perturbed:
        net, rnet, lnet = _perturb(net, rnet, lnet)
    x, d = points(n, n, device=dev)
    pack = render_core.RenderCorePack(net, rnet, lnet)
    kernels.reset_launch_counts()
    got = render_core.render_core_fwd(pack, x, d)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["render_core_fwd_light"] == 1
    assert counts["render_core_fwd"] == 0
    ref = (_bf16w_core(net, rnet, x, d, lnet) if perturbed
           else render_core.render_core_plain(net, rnet, x, d, lnet))
    assert len(got) == len(ref) == 4
    for (name, (atol, rtol)), g, r in zip(LIGHT_TOLS.items(), got, ref):
        torch.testing.assert_close(g, r, atol=atol, rtol=rtol, msg=name)


def _light_case(dev, n, eik, detach, seed=0, case="light", perturbed=False):
    from test_torch_bwd_replay import (eik_only, light_layout,
                                       loss_cotangents, points)
    net, rnet, lnet = light_layout(case, device=dev)
    if perturbed:
        net, rnet, lnet = _perturb(net, rnet, lnet)
    x, d = points(n, n + seed, eik, device=dev)
    w = render_core.CoreWeights.of(net, rnet, lnet)
    outs = render_core.render_core_train_plain(net.cfg, rnet.cfg, w, x, d,
                                               lnet.cfg, detach)
    cot = eik_only(loss_cotangents(*outs[:3], lmask=outs[3]), eik)
    return net, rnet, lnet, x, d, w, cot


@WEIGHTS
@pytest.mark.parametrize("case", ["light", "odd"])
@pytest.mark.parametrize("detach", [True, False], ids=["detached",
                                                       "coupled"])
@pytest.mark.parametrize("n,eik", [(1, 0), (33, 16), (4800, 4800),
                                   (160_000, 4800)])
def test_render_core_bwd_light_kernel(dev, n, eik, detach, case, perturbed):
    from test_torch_bwd_replay import (emulate_bwd, grad_check, k4_pack,
                                       plain_vjp)
    net, rnet, lnet, x, d, w, cot = _light_case(dev, n, eik, detach,
                                                case=case,
                                                perturbed=perturbed)
    st, t = k4_pack(net.cfg, rnet.cfg, w, lnet.cfg)
    with torch.no_grad():
        kernels.reset_launch_counts()
        got = render_core.render_core_bwd(st, t, x, d, cot, detach)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts["render_core_bwd_light"] == 1
        assert counts["render_core_bwd"] == 0
        got = [t for grp in got for t in grp]
        replay = [t for grp in emulate_bwd(
            net.cfg, rnet.cfg, w, x, d, cot, detach_light=detach,
            lcfg=lnet.cfg) for t in grp]
    _k4_vs_replay(f"{case} {detach} {perturbed} {n}", n, got, replay)
    del replay
    grad_check(got, plain_vjp(net.cfg, rnet.cfg, w, x, d, cot, lnet.cfg,
                              detach),
               leaf_tol=0.1 if n >= 4800 else float("inf"))


@pytest.mark.parametrize("detach", [True, False], ids=["detached",
                                                       "coupled"])
def test_render_core_bwd_light_padding_and_determinism(dev, detach):
    """33 points and the same 33 plus 31 rows with zero cotangents share
    one padded size (64): the results agree to the bit, and a second run
    gives the same bits. Detached, the SDF and radiance gradients are
    those of the kernel without the light head, to the bit."""
    from test_torch_bwd_replay import k4_pack
    net, rnet, lnet, x, d, w, cot = _light_case(dev, 64, 0, detach, seed=3)
    cot[33:] = 0.0
    flat = lambda r: [t for g in r for t in g]  # noqa: E731
    st, t = k4_pack(net.cfg, rnet.cfg, w, lnet.cfg)
    st0, t0 = k4_pack(net.cfg, rnet.cfg,
                      render_core.CoreWeights.of(net, rnet))
    with torch.no_grad():
        a = flat(render_core.render_core_bwd(
            st, t, x[:33].contiguous(), d[:33].contiguous(),
            cot[:33].contiguous(), detach))
        b = flat(render_core.render_core_bwd(st, t, x, d, cot, detach))
        c = flat(render_core.render_core_bwd(st, t, x, d, cot, detach))
        base = flat(render_core.render_core_bwd(st0, t0, x, d, cot))
    for ga, gb, gc in zip(a, b, c):
        assert torch.equal(ga, gb) and torch.equal(gb, gc)
    n_light = 2 * t.n_light
    assert all(float(g.abs().max()) > 0 for g in b[-n_light:])
    same = [torch.equal(g, h) for g, h in zip(b[:-n_light], base)]
    if detach:
        assert all(same)
    else:  # the light cotangent reaches the SDF net
        assert not all(same[:2 * t.n_sdf])


@pytest.mark.parametrize("detach", [True, False], ids=["detached",
                                                       "coupled"])
@pytest.mark.parametrize("n,eik", [(33, 16), (4800, 4800)])
def test_render_core_light_train_op(dev, n, eik, detach):
    """The training op with the light head (K3 forward, K4 backward)
    against the plain op, through autograd to every v, g and b."""
    from test_torch_bwd_replay import (eik_only, grad_check, light_layout,
                                       loss_cotangents, points)
    net, rnet, lnet = light_layout("light", device=dev)
    x, d = points(n, n + 2, eik, device=dev)
    leaves = (list(net.parameters()) + list(rnet.parameters())
              + list(lnet.parameters()))
    res = {}
    for plain in (True, False):
        kernels.reset_launch_counts()
        w = render_core.CoreWeights.of(net, rnet, lnet)
        outs = render_core.render_core_train(net.cfg, rnet.cfg, w, x, d,
                                             plain=plain, lcfg=lnet.cfg,
                                             detach_light=detach)
        if plain:
            cot = eik_only(loss_cotangents(*outs[:3], lmask=outs[3]), eik)
        g = torch.autograd.grad(outs, leaves, (cot[:, 3:4], cot[:, :3],
                                               cot[:, 4:7], cot[:, 7:8]))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want = 0 if plain else 1
        assert (counts["render_core_fwd_light"]
                == counts["render_core_bwd_light"] == want), counts
        res[plain] = ([t.detach() for t in outs], list(g))
    for (name, (atol, rtol)), a, b in zip(LIGHT_TOLS.items(), res[False][0],
                                          res[True][0]):
        torch.testing.assert_close(a, b, atol=atol, rtol=rtol, msg=name)
    grad_check(res[False][1], res[True][1],
               leaf_tol=0.1 if n >= 4800 else float("inf"))


# ---- K3 and K4 with the light head beside the idr radiance net -------------
# The light-mask config's nets with VolSDF's DTU radiance net (289 rows):
# K3-light-idr held to the plain op as K3-light (LIGHT_TOLS; at perturbed
# weights to the plain op at bf16-rounded weights, as K3-idr); K4-light-idr,
# handed K3's gradient as the training op hands it, to its replay (handed
# the same gradient) and the plain f32 backward as K4-light, both
# `detach_light` values; the training op through autograd.


def _light_idr_case(dev, n, eik, detach, case="light", perturbed=False):
    from test_torch_bwd_replay import (eik_only, light_layout,
                                       loss_cotangents, points)
    net, rnet, lnet = light_layout(case, device=dev, mode="idr")
    if perturbed:
        net, rnet, lnet = _perturb(net, rnet, lnet)
    x, d = points(n, n + 4, eik, device=dev)
    w = render_core.CoreWeights.of(net, rnet, lnet)
    outs = render_core.render_core_train_plain(net.cfg, rnet.cfg, w, x, d,
                                               lnet.cfg, detach)
    cot = eik_only(loss_cotangents(*outs[:3], lmask=outs[3]), eik)
    return net, rnet, lnet, x, d, w, cot


@WEIGHTS
@pytest.mark.parametrize("case", ["light", "odd"])
@pytest.mark.parametrize("n", EDGE_COUNTS + [12_000])
def test_render_core_light_idr_kernel(dev, n, perturbed, case):
    net, rnet, lnet, x, d, _, _ = _light_idr_case(dev, n, 0, True, case,
                                                  perturbed)
    pack = render_core.RenderCorePack(net, rnet, lnet)
    kernels.reset_launch_counts()
    got = render_core.render_core_fwd(pack, x, d)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["render_core_fwd_light_idr"] == 1
    assert not any(counts[k] for k in ("render_core_fwd",
                                       "render_core_fwd_light",
                                       "render_core_fwd_idr"))
    ref = (_bf16w_core(net, rnet, x, d, lnet) if perturbed
           else render_core.render_core_plain(net, rnet, x, d, lnet))
    assert len(got) == len(ref) == 4
    for (name, (atol, rtol)), g, r in zip(LIGHT_TOLS.items(), got, ref):
        torch.testing.assert_close(g, r, atol=atol, rtol=rtol, msg=name)


@WEIGHTS
@pytest.mark.parametrize("detach", [True, False], ids=["detached",
                                                       "coupled"])
@pytest.mark.parametrize("n,eik", [(1, 0), (33, 16), (4800, 4800),
                                   (160_000, 4800)])
def test_render_core_bwd_light_idr_kernel(dev, n, eik, detach, perturbed):
    from test_torch_bwd_replay import (emulate_bwd, grad_check, k4_pack,
                                       plain_vjp)
    net, rnet, lnet, x, d, w, cot = _light_idr_case(dev, n, eik, detach,
                                                    perturbed=perturbed)
    st, t = k4_pack(net.cfg, rnet.cfg, w, lnet.cfg)
    with torch.no_grad():
        g3 = render_core._launch_fwd(st, x, d)[1]
        kernels.reset_launch_counts()
        got = render_core.render_core_bwd(st, t, x, d, cot, detach, g3)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts["render_core_bwd_light_idr"] == 1
        assert not any(counts[k] for k in ("render_core_bwd",
                                           "render_core_bwd_light",
                                           "render_core_bwd_idr"))
        got = [t for grp in got for t in grp]
        replay = [t for grp in emulate_bwd(
            net.cfg, rnet.cfg, w, x, d, cot, detach_light=detach,
            lcfg=lnet.cfg, grad=g3) for t in grp]
    _k4_vs_replay(f"light_idr {detach} {perturbed} {n}", n, got, replay)
    del replay
    grad_check(got, plain_vjp(net.cfg, rnet.cfg, w, x, d, cot, lnet.cfg,
                              detach),
               leaf_tol=0.1 if n >= 4800 else float("inf"))


@pytest.mark.parametrize("detach", [True, False], ids=["detached",
                                                       "coupled"])
@pytest.mark.parametrize("n,eik", [(33, 16), (4800, 4800)])
def test_render_core_light_idr_train_op(dev, n, eik, detach):
    """The training op with the light head beside idr (K3-light-idr
    forward, K4-light-idr backward on K3's gradient) against the plain op,
    through autograd to every v, g and b; the outputs against the plain
    op at bf16-rounded weights (`light_layout`'s nets are moved off the
    init, as K3-idr's train-op test)."""
    from test_torch_bwd_replay import (eik_only, grad_check, light_layout,
                                       loss_cotangents, points)
    net, rnet, lnet = light_layout("light", device=dev, mode="idr")
    x, d = points(n, n + 5, eik, device=dev)
    leaves = (list(net.parameters()) + list(rnet.parameters())
              + list(lnet.parameters()))
    res = {}
    for plain in (True, False):
        kernels.reset_launch_counts()
        w = render_core.CoreWeights.of(net, rnet, lnet)
        outs = render_core.render_core_train(net.cfg, rnet.cfg, w, x, d,
                                             plain=plain, lcfg=lnet.cfg,
                                             detach_light=detach)
        if plain:
            cot = eik_only(loss_cotangents(*outs[:3], lmask=outs[3]), eik)
        g = torch.autograd.grad(outs, leaves, (cot[:, 3:4], cot[:, :3],
                                               cot[:, 4:7], cot[:, 7:8]))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want = 0 if plain else 1
        assert (counts["render_core_fwd_light_idr"]
                == counts["render_core_bwd_light_idr"] == want), counts
        res[plain] = ([t.detach() for t in outs], list(g))
    for (name, (atol, rtol)), a, b in zip(
            LIGHT_TOLS.items(), res[False][0],
            _bf16w_core(net, rnet, x, d, lnet)):
        torch.testing.assert_close(a, b, atol=atol, rtol=rtol, msg=name)
    grad_check(res[False][1], res[True][1],
               leaf_tol=0.1 if n >= 4800 else float("inf"))


# ---- K5 rev_fwd and K6 rev_bwd ----------------------------------------------
# At the flagship SDF net. Up to 4,800 points (the normal-off step's
# eikonal batch) the points are drawn as the training step draws them
# (test_torch_rev_replay.eikonal_points: a third uniform in the scene's
# cube [-4, 4]^3, a third near a surface, its jittered neighbours); at
# 155,200 they are render points around the scene's centre
# (test_torch_bwd_replay.points), the batch the JAX renderer feeds the op
# on its other training route (`renderer.py:383-386`). K5 is held to
# `rev_plain` with the JAX package's tolerances for its rev kernel
# (tests/test_pallas_rev.py: sdf 0.02, features 0.05, grad 0.05 / rtol
# 0.08), and to its bf16 replay (`replay.K5Replay`) at the same bounds and
# at `chip_smoke.REPLAY_GATE` (the share of points past 0.003 and 0.01), at
# the nets K6 takes (below) and at K5_COUNTS (K6's 64-point blocks, both
# sides and the edge); at the perturbed and odd nets against the plain op
# at the weights rounded to bf16, as K3: there the JAX package's own rev
# forward is past the f32 bound at a few of the smoke's 155,200 points at
# both nets, none against bf16 weights (`scripts/witness_perturbed.py
# rev`). A rerun
# gives the same bits and padding rows change no real row's. K6 (K4's wgmma sweeps, 64-point blocks: REV_COUNTS has both
# sides of one, two and three blocks) takes the cotangents of that test's
# loss, which reads the sdf, the features and the gradient (so c_out and
# c_g are both non-zero), at the init's net, at weights perturbed by 0.01
# N(0, 1) and on a net of odd depth (seven hidden layers, perturbed), and
# is held to its bf16 replay (test_torch_rev_replay.RevReplay) with the
# JAX package's gradient tolerance at every count (per leaf < 0.1 and
# cosine > 0.999), and to the plain f32 backward by cosine > 0.999 at
# every count and per leaf (< 0.1) from 4,800 points up, as K4 is. The
# perturbed net is gated on f32, as K4's: the JAX package's own rev
# backward stays inside that bound at the smoke's perturbed net
# (`scripts/witness_perturbed.py rev`).

REV_COUNTS = [1, 31, 33, 63, 65, 127, 129, 4800, 155_200]
K5_COUNTS = [1, 63, 64, 65, 4800, 155_200]
REV_NETS = pytest.mark.parametrize("nets", ["init", "perturbed", "odd"])
REV_TOLS = {"sdf": (0.02, 0.02), "feat": (0.05, 0.05), "grad": (0.05, 0.08)}


def _rev_case(dev, n, sphere=0.0, nets="init"):
    from test_torch_bwd_replay import points
    from test_torch_rev_replay import FLAGSHIP, eikonal_points, sdf_net
    net = sdf_net(**{**FLAGSHIP, "depth": 7 if nets == "odd" else 8},
                  sphere=sphere, device=dev)
    if nets != "init":
        (net,) = _perturb(net)
    if n > 4800:
        return net, points(n, n, device=dev)[0].contiguous()
    return net, eikonal_points(n, n, device=dev)


def _rev_close(outs, refs):
    (out, grad), (out_r, grad_r) = outs, refs
    pairs = {"sdf": (out[:, :1], out_r[:, :1]),
             "feat": (out[:, 1:], out_r[:, 1:]), "grad": (grad, grad_r)}
    for name, (a, b) in pairs.items():
        torch.testing.assert_close(a, b.detach(), atol=REV_TOLS[name][0],
                                   rtol=REV_TOLS[name][1], msg=name)


@REV_NETS
@pytest.mark.parametrize("n", K5_COUNTS)
def test_rev_fwd_kernel(dev, n, nets):
    import chip_smoke as cs
    from i2sdf_tpu_torch.ops.kernels.replay import emulate_rev_fwd
    from test_torch_rev_replay import flat_weights
    net, x = _rev_case(dev, n, nets=nets)
    ws, bs = flat_weights(net)
    with torch.no_grad():
        k = rev.RevStages(net.cfg, ws, bs)
        kernels.reset_launch_counts()
        got = rev.rev_fwd(k, x)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["rev_fwd"] == 1
        rep = emulate_rev_fwd(k, x)
        _rev_close(got, rep)
        gaps = cs.replay_gaps(got, rep)
        assert cs.replay_ok(gaps, n), gaps
        del rep
    if nets != "init":
        ws = [w.detach().to(torch.bfloat16).float() for w in ws]
    _rev_close(got, rev.rev_plain(net.cfg, ws, bs, x))


def test_rev_fwd_reruns_and_padding_rows(dev):
    """A second K5 launch gives the same bits, and 33 points alone give
    the bits of the same 33 in a block with 31 more rows."""
    from test_torch_rev_replay import flat_weights
    net, x = _rev_case(dev, 64)
    with torch.no_grad():
        k = rev.RevStages(net.cfg, *flat_weights(net))
        a = rev.rev_fwd(k, x[:33].contiguous())
        b = rev.rev_fwd(k, x)
        c = rev.rev_fwd(k, x)
    for ta, tb, tc in zip(a, b, c):
        assert torch.equal(tb, tc) and torch.equal(ta, tb[:33])


@REV_NETS
@pytest.mark.parametrize("n", REV_COUNTS)
def test_rev_bwd_kernel(dev, n, nets):
    from test_torch_bwd_replay import grad_check
    from test_torch_rev_replay import (emulate_rev_bwd, flat_weights,
                                       loss_cotangents)
    net, x = _rev_case(dev, n, nets=nets)
    ws, bs = flat_weights(net)
    out, grad = rev.rev_plain(net.cfg, ws, bs, x)
    c_out, c_g = loss_cotangents(out, grad, seed=n)
    assert c_out.abs().max() > 0 and c_g.abs().max() > 0
    ref = list(torch.autograd.grad((out, grad), ws + bs, (c_out, c_g)))
    del out, grad
    with torch.no_grad():
        k = rev.RevStages(net.cfg, ws, bs)
        kernels.reset_launch_counts()
        got = rev.rev_bwd(k, x, c_out.contiguous(), c_g.contiguous())
        torch.cuda.synchronize()
        assert kernels.launch_counts()["rev_bwd"] == 1
        got = [t for grp in got for t in grp]
        replay = [t for grp in emulate_rev_bwd(k, x, c_out, c_g) for t in grp]
    grad_check(got, replay)
    del replay
    grad_check(got, ref, leaf_tol=0.1 if n >= 4800 else float("inf"))


def test_rev_bwd_padding_rows_add_nothing_and_runs_agree(dev):
    """33 points and the same 33 plus 31 rows with zero cotangents share
    one padded size (64): the results agree to the bit, and a second run
    gives the same bits."""
    from test_torch_rev_replay import flat_weights
    net, x = _rev_case(dev, 64)
    gen = torch.Generator().manual_seed(0)
    c_out = torch.randn((64, 257), generator=gen).to(dev)
    c_g = torch.randn((64, 3), generator=gen).to(dev)
    c_out[33:] = 0.0
    c_g[33:] = 0.0
    with torch.no_grad():
        k = rev.RevStages(net.cfg, *flat_weights(net))
        a = rev.rev_bwd(k, x[:33].contiguous(), c_out[:33].contiguous(),
                        c_g[:33].contiguous())
        b = rev.rev_bwd(k, x, c_out, c_g)
        c = rev.rev_bwd(k, x, c_out, c_g)
    flat = lambda r: [t for g in r for t in g]  # noqa: E731
    for ga, gb, gc in zip(flat(a), flat(b), flat(c)):
        assert torch.equal(ga, gb) and torch.equal(gb, gc)


@pytest.mark.parametrize("sphere", [0.0, 1.0])
@pytest.mark.parametrize("n", [33, 4800])
def test_rev_op(dev, n, sphere):
    """The op (K5 forward, K6 backward, the sphere clamp outside) against
    the plain op, through autograd to v, g and b."""
    from test_torch_bwd_replay import grad_check
    from test_torch_rev_replay import loss_cotangents
    net, x = _rev_case(dev, n, sphere)
    leaves = list(net.parameters())
    res = {}
    for plain in (True, False):
        kernels.reset_launch_counts()
        sdf, feat, grad = rev.sdf_outputs_rev(net, x, plain=plain)
        if plain:
            c_out, c_g = loss_cotangents(torch.cat([sdf, feat], 1), grad)
        g = torch.autograd.grad((sdf, feat, grad), leaves,
                                (c_out[:, :1], c_out[:, 1:], c_g))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want = 0 if plain else 1
        assert counts["rev_fwd"] == counts["rev_bwd"] == want, counts
        assert counts["render_core_fwd"] == counts["render_core_bwd"] == 0
        res[plain] = ((sdf.detach(), feat.detach(), grad.detach()), list(g))
    (sk, fk, gk), (sp, fp, gp) = res[False][0], res[True][0]
    agree = torch.ones_like(sk[:, 0], dtype=torch.bool)
    if sphere > 0:
        # next to the sphere the kernel's bf16 sdf may pick the other side
        bound_sdf = sphere - torch.linalg.norm(x, dim=-1, keepdim=True)
        agree = ((sk == bound_sdf) == (sp == bound_sdf))[:, 0]
        assert float(agree.float().mean()) > 0.99
    _rev_close((torch.cat([sk, fk], 1), gk[agree]),
               (torch.cat([sp, fp], 1), gp[agree]))
    grad_check(res[False][1], res[True][1],
               leaf_tol=0.1 if n >= 4800 else float("inf"))


# ---- K7 conv_check ----------------------------------------------------------
# Both versions compute the error bound in f32 with their sums in other
# orders, so a ray whose bound lies within rounding of eps may flip: flags
# must agree with the plain version's and with the f64 bound's wherever the
# f64 bound is more than 1e-4 relative from eps, and fewer than 1 % of the
# rays may lie in that band.

def _conv_inputs(R, S, seed):
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(0.0, 6.0, (R, S)), axis=-1)
    wall = rng.uniform(1.0, 8.0, (R, 1))
    slope = rng.uniform(0.3, 1.0, (R, 1))
    sdf = (wall - z) * slope + rng.uniform(0.0, 0.05, (R, 1)) * rng.normal(
        size=(R, S))
    return torch.from_numpy(z), torch.from_numpy(sdf)


@pytest.mark.parametrize("S", [97, 128, 416, 600])
def test_conv_check_kernel(dev, S):
    R = 1600
    z64, s64 = _conv_inputs(R, S, S)
    z, s = z64.float().to(dev), s64.float().to(dev)
    in_band, mixed = 0, False
    for beta0 in (0.02, 0.05, 0.2):
        b0 = torch.tensor(beta0, device=dev)
        kernels.reset_launch_counts()
        got = conv_check.conv_check(SCFG, z, s, b0)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["conv_check"] == 1
        assert got.dtype == torch.bool and got.shape == (R,)
        plain = tsampler.converged_rays(SCFG, z, s, b0)
        d_star, dists = tsampler._d_star(z64, s64)
        bound = tsampler._error_bound(torch.tensor(beta0, dtype=torch.float64),
                                      s64, dists, d_star)
        outside = ((bound - SCFG.eps).abs() > 1e-4 * SCFG.eps).to(dev)
        truth = (bound <= SCFG.eps).to(dev)
        mixed |= 0 < int(truth.sum()) < R
        assert bool(((got == truth) | ~outside).all())
        assert bool(((got == plain) | ~outside).all())
        in_band += int((~outside).sum())
    assert in_band < 0.01 * 3 * R
    assert mixed  # both flags at some beta0: a constant output fails


@pytest.mark.parametrize("S", [416, 480])
@pytest.mark.parametrize("R", [1600, 12_000])
def test_conv_check_is_k2s_beta0_decision(dev, R, S):
    """K7 is K2's beta0 evaluation: its flag equals, ray by ray and to the
    bit, K2's decision to keep beta0 (beta out == beta0 from one launch on
    the same rows with beta in above beta0)."""
    z64, s64 = _conv_inputs(R, S, S)
    z, s = z64.float().to(dev), s64.float().to(dev)
    u = torch.linspace(0, 1, 8, device=dev).expand(R, 8).contiguous()
    beta_in = torch.ones(R, device=dev)
    seen = set()
    for beta0 in (0.02, 0.05, 0.2):
        b0 = torch.tensor(beta0, device=dev)
        got = conv_check.conv_check(SCFG, z, s, b0)
        _, beta = sampler_round.sampler_round(SCFG, z, s, beta_in, b0, u,
                                              False)
        assert torch.equal(got, beta == b0)
        seen |= set(got.tolist())
    assert seen == {True, False}


# ---- K8 bg_core_fwd and K9 bg_core_bwd ------------------------------------
# The background config's nets (VolSDF's BlendedMVS widths) at the init's
# weights, at weights perturbed by 0.01 N(0, 1) (the init's zero encoding
# rows of layer 0 and the skip hide layout faults) and on a net of odd
# depth (seven hidden layers, the skip at 3, perturbed too), at counts on
# both sides of the blocks' edges (K8: 128 points, two warpgroups of 64;
# K9: 64). K8 against the plain pair at CORE_TOLS's sdf and rgb
# tolerances (bf16 operands, f32 accumulation) and by the spread rule:
# each output's max error at most BG_SPREAD_TOL of the plain output's
# spread (max - min) over 4096 seeded points. At init the outputs vary
# little from point to point, so the spread rule also runs on nets whose
# weights are scaled by sqrt(6) (the uniform init's std then is He's
# sqrt(2 / fan_in)), where each spread is at least BG_MIN_SPREAD. Every
# gate is against the f32 plain pair: the JAX package's own kernel stays
# inside it at the smoke's perturbed weights (`scripts/witness_perturbed.py
# bg`). K9 with a loss's cotangents against autograd of the plain pair
# (f32): cosine > 0.999 at every count and per leaf < 0.1 from 4,800
# points up (below that a few bf16 mask flips weigh on a leaf as much as
# the signal does, as for K4), and against its bf16 replay
# (test_torch_bg_replay.replay_bwd, on the CPU) by the same rule; two runs
# agree to the bit.

BG_SPREAD_TOL, BG_MIN_SPREAD = 0.05, 0.25
BG_ICFG = mlp.ImplicitNetConfig(
    feature_vector_size=256, sdf_bounding_sphere=0.0, d_in=4,
    dims=(256,) * 8, skip_in=(4,), geometric_init=False, weight_norm=False,
    embed_type="positional", multires=10)
BG_ICFG_ODD = dataclasses.replace(BG_ICFG, dims=(256,) * 7, skip_in=(3,))
BG_RCFG = mlp.RenderingNetConfig(
    feature_vector_size=256, dims=(128,), weight_norm=False,
    embed_type="positional", multires=4)
BG_EDGE = [1, 63, 64, 65, 127, 128, 129, 4800, 51_200]
BG_NETS = pytest.mark.parametrize("nets", ["init", "perturbed", "odd"])


def _bg_points(n, gen):
    p = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen),
                                      dim=-1)
    x4 = torch.cat([p, torch.rand((n, 1), generator=gen) * 0.25], 1)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen),
                                      dim=-1)
    return x4, d


def _bg_case(dev, n, seed=0, wn=False, signal=False, nets="init"):
    """The nets (`nets`: the init's, perturbed, or of odd depth and
    perturbed; with `signal` their weights scaled by sqrt(6)) and n seeded
    points."""
    gen = torch.Generator().manual_seed(seed)
    icfg = BG_ICFG_ODD if nets == "odd" else BG_ICFG
    net_i = mlp.ImplicitNet(dataclasses.replace(icfg, weight_norm=wn), gen)
    net_r = mlp.RenderingNet(dataclasses.replace(BG_RCFG, weight_norm=wn),
                             gen)
    if nets != "init":
        net_i, net_r = _perturb(net_i, net_r, seed=seed + 1)
    if signal:
        with torch.no_grad():
            for lin in net_i.layers() + net_r.layers():
                (lin.g if wn else lin.w).mul_(math.sqrt(6.0))
    x4, d = _bg_points(n, gen)
    return (net_i.to(dev), net_r.to(dev), x4.to(dev).contiguous(),
            d.to(dev).contiguous())


def _bg_spreads(net_i, net_r):
    """The spread rule's scale: the spread (max - min) of the plain pair's
    sigma and rgb over 4096 seeded points."""
    x4, d = _bg_points(4096, torch.Generator().manual_seed(4096))
    dev = next(net_i.parameters()).device
    with torch.no_grad():
        ref = bg_core.bg_core_plain(net_i.cfg, net_r.cfg,
                                    bg_core.BgWeights.of(net_i, net_r),
                                    x4.to(dev), d.to(dev))
    return [float(r.max() - r.min()) for r in ref]


def _assert_spread_rule(got, ref, spreads):
    for name, g, r, s in zip(("sigma", "rgb"), got, ref, spreads):
        err = float((g - r).abs().max())
        assert err <= BG_SPREAD_TOL * s, (name, err, s)


def _bg_cotangents(sigma, rgb, seed):
    """[c_sigma | c_rgb] of a loss: rgb L1 against seeded targets and 0.2
    sigma^2."""
    gen = torch.Generator().manual_seed(seed)
    gt = torch.rand(rgb.shape, generator=gen).to(rgb.device)
    s, r = sigma.detach().requires_grad_(True), rgb.detach().requires_grad_(
        True)
    with torch.enable_grad():
        loss = (r - gt).abs().mean() + 0.2 * (s ** 2).mean()
        cs, cr = torch.autograd.grad(loss, (s, r))
    return torch.cat([cs, cr], 1).contiguous()


def _bg_stages(net_i, net_r, w=None):
    with torch.no_grad():
        return bg_core.BgStages(net_i.cfg, net_r.cfg,
                                w or bg_core.BgWeights.of(net_i, net_r))


@BG_NETS
@pytest.mark.parametrize("n", BG_EDGE + [384_000])
def test_bg_core_fwd_kernel(dev, n, nets):
    """At the nets' weights (CORE_TOLS and the spread rule) and at the
    scaled ones (the spread rule, each spread at least BG_MIN_SPREAD)."""
    for signal in (False, True):
        net_i, net_r, x4, d = _bg_case(dev, n, seed=n, signal=signal,
                                       nets=nets)
        pack = bg_core.BgPack(net_i, net_r)
        kernels.reset_launch_counts()
        sigma, rgb = bg_core.bg_core_eval(pack, x4, d)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["bg_core_fwd"] == 1
        with torch.no_grad():
            s_ref, rgb_ref = bg_core.bg_core_plain(
                net_i.cfg, net_r.cfg, bg_core.BgWeights.of(net_i, net_r), x4,
                d)
        spreads = _bg_spreads(net_i, net_r)
        _assert_spread_rule((sigma, rgb), (s_ref, rgb_ref), spreads)
        if signal:
            assert min(spreads) >= BG_MIN_SPREAD, spreads
        else:
            torch.testing.assert_close(sigma, s_ref, atol=0.02, rtol=0.02)
            torch.testing.assert_close(rgb, rgb_ref, atol=0.03, rtol=0.05)


@BG_NETS
@pytest.mark.parametrize("n", BG_EDGE)
def test_bg_core_bwd_kernel(dev, n, nets):
    from test_torch_bg_replay import replay_bwd
    from test_torch_bwd_replay import grad_check
    net_i, net_r, x4, d = _bg_case(dev, n, seed=n, nets=nets)
    w = bg_core.BgWeights.of(net_i, net_r)
    sigma, rgb = bg_core.bg_core_plain(net_i.cfg, net_r.cfg, w, x4, d)
    cot = _bg_cotangents(sigma, rgb, seed=n)
    ref = list(torch.autograd.grad((sigma, rgb), w.flat(),
                                   (cot[:, :1], cot[:, 1:])))
    st = _bg_stages(net_i, net_r, w)
    with torch.no_grad():
        kernels.reset_launch_counts()
        got = bg_core.bg_core_bwd(st, x4, d, cot)
        again = bg_core.bg_core_bwd(st, x4, d, cot)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["bg_core_bwd"] == 2
    got = [t for g in got for t in g]
    for a, b in zip(got, [t for g in again for t in g]):
        assert torch.equal(a, b)
    grad_check(got, ref, leaf_tol=0.1 if n >= 4800 else float("inf"))
    if n <= 4800:
        cpu = lambda t: t.detach().cpu()  # noqa: E731
        with torch.no_grad():
            kc = bg_core.BgStages(net_i.cfg, net_r.cfg, bg_core.BgWeights(
                *(tuple(cpu(t) for t in g)
                  for g in (w.ws_i, w.bs_i, w.ws_r, w.bs_r))))
        replay = [t for g in replay_bwd(kc, cpu(x4), cpu(d), cpu(cot))
                  for t in g]
        grad_check([cpu(t) for t in got], replay)


def test_bg_core_bwd_padding_rows_add_nothing(dev):
    """33 points and the same 33 plus 31 rows with zero cotangents share
    one block (64 points): the results agree to the bit."""
    net_i, net_r, x4, d = _bg_case(dev, 64, seed=3)
    cot = torch.randn((64, 4), generator=torch.Generator().manual_seed(0))
    cot = cot.to(dev)
    cot[33:] = 0.0
    st = _bg_stages(net_i, net_r)
    with torch.no_grad():
        a = bg_core.bg_core_bwd(st, x4[:33].contiguous(), d[:33].contiguous(),
                                cot[:33].contiguous())
        b = bg_core.bg_core_bwd(st, x4, d, cot)
    flat = lambda r: [t for g in r for t in g]  # noqa: E731
    for ga, gb in zip(flat(a), flat(b)):
        assert torch.equal(ga, gb)


@pytest.mark.parametrize("wn", [False, True], ids=["no_wn", "wn"])
def test_bg_core_op(dev, wn):
    """The op (K8 forward, K9 backward) against the plain op, through
    autograd to the nets' leaves (v, g, b with weight norm)."""
    from test_torch_bwd_replay import grad_check
    net_i, net_r, x4, d = _bg_case(dev, 4800, seed=5, wn=wn)
    leaves = list(net_i.parameters()) + list(net_r.parameters())
    res = {}
    for plain in (True, False):
        kernels.reset_launch_counts()
        sigma, rgb = bg_core.bg_core(net_i.cfg, net_r.cfg,
                                     bg_core.BgWeights.of(net_i, net_r), x4,
                                     d, plain=plain)
        if plain:
            cot = _bg_cotangents(sigma, rgb, seed=7)
        g = torch.autograd.grad((sigma, rgb), leaves,
                                (cot[:, :1], cot[:, 1:]))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want = 0 if plain else 1
        assert counts["bg_core_fwd"] == counts["bg_core_bwd"] == want, counts
        res[plain] = ((sigma.detach(), rgb.detach()), list(g))
    torch.testing.assert_close(res[False][0][0], res[True][0][0], atol=0.02,
                               rtol=0.02)
    torch.testing.assert_close(res[False][0][1], res[True][0][1], atol=0.03,
                               rtol=0.05)
    _assert_spread_rule(res[False][0], res[True][0],
                        _bg_spreads(net_i, net_r))
    grad_check(res[False][1], res[True][1])


def test_bg_kernels_refuse_cpu_weights(dev):
    net_i, net_r, x4, d = _bg_case(torch.device("cpu"), 8)
    with pytest.raises(ValueError):
        bg_core.bg_core_eval(bg_core.BgPack(net_i, net_r), x4.to(dev),
                             d.to(dev))


# ---- K10-K12: the tangent-stream kernels -----------------------------------
# K10 and K11 are held to the JAX package's bounds for its tangent-stream
# kernels (tests/test_pallas_outputs.py:39-49: sdf 0.02, features 0.05,
# gradient atol 0.05 / rtol 0.08, cosine > 0.995 per point), K12 to its
# gradient bound with a loss's cotangents, per leaf from 4,800 points up as
# K6 is. The nets are the flagship SDF net at its init and at perturbed
# weights (the replay tests' nets: v + 0.01 N(0, 1)), where the encoding's
# rows of layer 0 and of the skip are no longer zero; and a net with no
# encoding (the kernels run it as frequency count 0). 33 points are not a
# multiple of the 16-point block. The per-point cosine is held where the
# plain gradient's norm is at least TAN_COS_MIN_NORM: below it bf16's
# error can turn a short gradient past the bound, and the JAX kernel's
# own gradient does so at this net and these points
# (tests/test_torch_parity_sdf_outputs.py::
# test_flagship_perturbed_matches_pallas_interpret). At perturbed weights
# K10 and K11 are held to the plain op at their weights rounded to bf16
# (`_bf16w_plain`), the kernels' operand: there the rounding of the weights
# alone moves the gradient by about the whole atol
# (tests/test_torch_tangent_replay.py), and a few points of thousands land
# past the bound against the f32 plain op, for the JAX package's own
# kernel too (tests/test_torch_parity_sdf_grad.py::
# test_pallas_op_is_past_the_f32_bound_at_perturbed_weights).

TAN_COUNTS = [1, 33, 4800, 155_200]
# K10: both sides of its 32-point blocks too
K10_COUNTS = [1, 31, 32, 33, 4800, 155_200]
TAN_COS_MIN_NORM = 0.5
NO_PE = mlp.ImplicitNetConfig(feature_vector_size=8, sdf_bounding_sphere=1.5,
                              dims=(32, 32), geometric_init=False)


def _tan_case(dev, n, perturbed=True, sphere=0.0, cfg=None, depth=8):
    from test_torch_bwd_replay import points
    from test_torch_rev_replay import FLAGSHIP, eikonal_points, sdf_net
    if cfg is not None:
        net = mlp.ImplicitNet(cfg, torch.Generator().manual_seed(0)).to(dev)
    elif perturbed:
        net = sdf_net(**{**FLAGSHIP, "depth": depth}, sphere=sphere,
                      device=dev)
    else:
        net = mlp.ImplicitNet(dataclasses.replace(
            ICFG, sdf_bounding_sphere=sphere, dims=ICFG.dims[:depth]),
            torch.Generator().manual_seed(0)).to(dev)
    if n > 4800:
        return net, points(n, n, device=dev)[0].contiguous()
    return net, eikonal_points(n, n, device=dev)


def _sphere_agree(out, out_r, x, icfg):
    """Points where K10 and its plain version (sdf, feat, grad) both took
    the bounding sphere or both the net (`chip_smoke.took_sphere`: the
    sphere's sdf and gradient): next to the sphere the kernel's bf16 sdf
    may pick the other branch (then the two gradients differ by
    construction). At least 99% must agree."""
    import chip_smoke as cs
    agree = torch.ones_like(out[0][:, 0], dtype=torch.bool)
    if icfg.sdf_bounding_sphere > 0:
        agree = (cs.took_sphere(icfg, x, out)
                 == cs.took_sphere(icfg, x, out_r))
        assert float(agree.float().mean()) > 0.99
    return agree


def _bf16w_plain(net, x, clamp):
    """(sdf, feat, grad) of the plain sweep at the net's weights rounded to
    bf16 (f32 biases and arithmetic), clamped to the bounding sphere if
    `clamp`."""
    from test_torch_rev_replay import flat_weights
    ws, bs = flat_weights(net)
    with torch.no_grad():
        out, grad = sdf_grad.sdf_tangents(
            net.cfg, [w.to(torch.bfloat16).float() for w in ws], bs, x)
        sdf = out[:, :1]
        if clamp:
            sdf, grad = render_core._sphere_clamp(net.cfg, x, sdf, grad)
    return sdf, out[:, 1:], grad


def _tan_close(outs, refs):
    """The JAX bounds for its tangent-stream kernels on (sdf, feat, grad)."""
    for name, a, b in zip(("sdf", "feat", "grad"), outs, refs):
        torch.testing.assert_close(
            a, b.detach(), atol=REV_TOLS[name][0], rtol=REV_TOLS[name][1],
            msg=lambda m, name=name: f"{name}: {m}")
    g, gr = outs[2], refs[2].detach()
    cos = (g * gr).sum(-1) / torch.clamp(g.norm(dim=-1) * gr.norm(dim=-1),
                                         min=1e-9)
    held = gr.norm(dim=-1) >= TAN_COS_MIN_NORM
    if held.any():
        assert float(cos[held].min()) > 0.995, float(cos[held].min())


@pytest.mark.parametrize("nets", ["init", "perturbed", "odd"])
@pytest.mark.parametrize("n", K10_COUNTS)
def test_sdf_outputs_kernel(dev, n, nets):
    """K10 (K3's tangent form, 32-point blocks) against the plain op (at
    the bf16-rounded weights off the init) and its bf16 replay
    (`replay.K10Replay`, at the same bounds and `chip_smoke.REPLAY_GATE`),
    a sphere of radius 4 cutting the points."""
    import chip_smoke as cs
    from i2sdf_tpu_torch.ops.kernels.replay import emulate_sdf_outputs
    from test_torch_rev_replay import flat_weights
    net, x = _tan_case(dev, n, nets != "init", sphere=4.0,
                       depth=7 if nets == "odd" else 8)
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = sdf_outputs.fused_sdf_outputs(net, x)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sdf_outputs"] == 1
    ref = (_bf16w_plain(net, x, True) if nets != "init"
           else sdf_outputs.sdf_outputs_plain(net, x))
    assert [t.shape for t in got] == [t.shape for t in ref]
    agree = _sphere_agree(got, ref, x, net.cfg)
    _tan_close([t[agree] for t in got], [t[agree] for t in ref])
    with torch.no_grad():
        k = sdf_outputs.OutputStages(net.cfg, *flat_weights(net))
        rep = emulate_sdf_outputs(k, net.cfg, x)
    agree = _sphere_agree(got, rep, x, net.cfg)
    _tan_close([t[agree] for t in got], [t[agree] for t in rep])
    gaps = cs.replay_gaps((torch.cat(got[:2], 1), got[2]),
                          (torch.cat(rep[:2], 1), rep[2]))
    assert cs.replay_ok(gaps, n), gaps


def test_sdf_outputs_block_edges_and_reruns(dev):
    """The first n points alone give the rows of the same points in the
    full run, to the bit, at counts on both sides of K10's 32-point
    blocks; a rerun gives the same bits."""
    from test_torch_rev_replay import flat_weights
    net, x = _tan_case(dev, 4800, sphere=4.0)
    with torch.no_grad():
        k = sdf_outputs.OutputStages(net.cfg, *flat_weights(net))
        full = sdf_outputs.sdf_outputs_fwd(k, net.cfg, x)
        again = sdf_outputs.sdf_outputs_fwd(k, net.cfg, x)
        for n in (1, 31, 32, 33, 63, 65, 4097):
            part = sdf_outputs.sdf_outputs_fwd(k, net.cfg,
                                               x[:n].contiguous())
            assert all(torch.equal(a, b[:n]) for a, b in zip(part, full))
    assert all(torch.equal(a, b) for a, b in zip(full, again))


@pytest.mark.parametrize("perturbed", [False, True], ids=["init", "perturbed"])
@pytest.mark.parametrize("n", TAN_COUNTS)
def test_sdf_grad_fwd_kernel(dev, n, perturbed):
    from test_torch_rev_replay import flat_weights
    net, x = _tan_case(dev, n, perturbed)
    ws, bs = flat_weights(net)
    with torch.no_grad():
        k = sdf_grad.bwd_stages(net.cfg, ws, bs)
        kernels.reset_launch_counts()
        out, grad = sdf_grad.sdf_grad_fwd(k, x)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts["sdf_grad_fwd"] == 1 and counts["sdf_outputs"] == 0
    if perturbed:
        ref = _bf16w_plain(net, x, False)
    else:
        out_r, grad_r = sdf_grad.sdf_grad_plain(net.cfg, ws, bs, x)
        ref = (out_r[:, :1], out_r[:, 1:], grad_r)
    _tan_close((out[:, :1], out[:, 1:], grad), ref)


@pytest.mark.parametrize("n", TAN_COUNTS)
def test_sdf_grad_fwd_is_k10_unclamped(dev, n):
    """K11 is K10's kernel at sphere radius 0 on the op's pack: its output
    is K10's (`sdf_outputs_fwd` on the same pack's chain) at a config with
    no bounding sphere, bit for bit, and at the net's own sphere (radius
    4) at every point where the sphere does not win; the first m points
    alone, at counts on both sides of the 32-point blocks, give the full
    run's rows to the bit."""
    import chip_smoke as cs
    from test_torch_rev_replay import flat_weights
    net, x = _tan_case(dev, n, sphere=4.0)
    cfg0 = dataclasses.replace(net.cfg, sdf_bounding_sphere=0.0)
    with torch.no_grad():
        k = sdf_grad.bwd_stages(net.cfg, *flat_weights(net))
        out, grad = sdf_grad.sdf_grad_fwd(k, x)
        o10 = sdf_outputs.sdf_outputs_fwd(k, cfg0, x)
        assert torch.equal(out, torch.cat(o10[:2], 1))
        assert torch.equal(grad, o10[2])
        o10 = sdf_outputs.sdf_outputs_fwd(k, net.cfg, x)
        net_wins = ~cs.took_sphere(net.cfg, x, o10)
        assert torch.equal(out[net_wins], torch.cat(o10[:2], 1)[net_wins])
        assert torch.equal(grad[net_wins], o10[2][net_wins])
        for m in (1, 31, 32, 33, 63, 65, 4097):
            if m < n:
                part = sdf_grad.sdf_grad_fwd(k, x[:m].contiguous())
                assert torch.equal(part[0], out[:m])
                assert torch.equal(part[1], grad[:m])


@pytest.mark.parametrize("perturbed", [False, True], ids=["init", "perturbed"])
@pytest.mark.parametrize("n", TAN_COUNTS)
def test_sdf_grad_bwd_kernel(dev, n, perturbed):
    """K12 (K6 on K6's pack, through its own entry) against the plain
    backward, with the loss's cotangents and with c_g alone, to its bf16
    replay (K6's, `replay.RevReplay`), and to K6 on K6's own pack, bit
    for bit."""
    from i2sdf_tpu_torch.ops.kernels.replay import emulate_rev_bwd
    from test_torch_bwd_replay import grad_check
    from test_torch_rev_replay import flat_weights, loss_cotangents
    net, x = _tan_case(dev, n, perturbed)
    ws, bs = flat_weights(net)
    out, grad = sdf_grad.sdf_grad_plain(net.cfg, ws, bs, x)
    c_out, c_g = loss_cotangents(out, grad, seed=n)
    ref = list(torch.autograd.grad((out, grad), ws + bs, (c_out, c_g),
                                   retain_graph=True))
    # c_g alone: the tangent path, which the loss's other terms can
    # outweigh in a leaf
    ref_g = [torch.zeros_like(p) if g is None else g for g, p in zip(
        torch.autograd.grad(grad, ws + bs, c_g, allow_unused=True), ws + bs)]
    del out, grad
    leaf_tol = 0.1 if n >= 4800 else float("inf")
    c_out, c_g = c_out.contiguous(), c_g.contiguous()
    with torch.no_grad():
        k = sdf_grad.bwd_stages(net.cfg, ws, bs)
        kernels.reset_launch_counts()
        dws, dbs = sdf_grad.sdf_grad_bwd(k, x, c_out, c_g)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts["sdf_grad_bwd"] == 1 and counts["rev_bwd"] == 0
        got_g = sdf_grad.sdf_grad_bwd(k, x, torch.zeros_like(c_out), c_g)
        k6 = rev.rev_bwd(rev.RevStages(net.cfg, ws, bs), x, c_out, c_g)
    assert all(torch.equal(a, b) for a, b in zip(dws + dbs, k6[0] + k6[1]))
    grad_check(dws + dbs, ref, leaf_tol=leaf_tol)
    grad_check(got_g[0] + got_g[1], ref_g, leaf_tol=leaf_tol)
    # and to its bf16 replay (K6's), at K6's bound for it
    with torch.no_grad():
        replay = emulate_rev_bwd(k, x, c_out, c_g)
    grad_check(dws + dbs, replay[0] + replay[1])


def test_sdf_grad_bwd_padding_rows_add_nothing_and_runs_agree(dev):
    """33 points and the same 33 plus 31 rows with zero cotangents share
    one padded size (64): the results agree to the bit, and a second run
    gives the same bits."""
    from test_torch_rev_replay import flat_weights
    net, x = _tan_case(dev, 64)
    gen = torch.Generator().manual_seed(0)
    c_out = torch.randn((64, 257), generator=gen).to(dev)
    c_g = torch.randn((64, 3), generator=gen).to(dev)
    c_out[33:] = 0.0
    c_g[33:] = 0.0
    with torch.no_grad():
        k = sdf_grad.bwd_stages(net.cfg, *flat_weights(net))
        a = sdf_grad.sdf_grad_bwd(k, x[:33].contiguous(),
                                  c_out[:33].contiguous(),
                                  c_g[:33].contiguous())
        b = sdf_grad.sdf_grad_bwd(k, x, c_out, c_g)
        c = sdf_grad.sdf_grad_bwd(k, x, c_out, c_g)
    flat = lambda r: [t for g in r for t in g]  # noqa: E731
    for ga, gb, gc in zip(flat(a), flat(b), flat(c)):
        assert torch.equal(ga, gb) and torch.equal(gb, gc)


@pytest.mark.parametrize("sphere", [0.0, 1.0])
@pytest.mark.parametrize("n", [33, 4800])
def test_sdf_grad_op(dev, n, sphere):
    """The op (K11 forward, K12 backward, the sphere clamp outside) inside a
    loss's backward against the plain op, through autograd to v, g and b
    (the values, at these perturbed weights, against the plain op at bf16
    weights)."""
    from test_torch_bwd_replay import grad_check
    from test_torch_rev_replay import loss_cotangents
    net, x = _tan_case(dev, n, sphere=sphere)
    leaves = list(net.parameters())
    res = {}
    for plain in (True, False):
        kernels.reset_launch_counts()
        sdf, feat, grad = sdf_grad.sdf_outputs_fused_grad(net, x, plain=plain)
        if plain:
            c_out, c_g = loss_cotangents(torch.cat([sdf, feat], 1), grad)
        g = torch.autograd.grad((sdf, feat, grad), leaves,
                                (c_out[:, :1], c_out[:, 1:], c_g))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want = 0 if plain else 1
        assert counts["sdf_grad_fwd"] == counts["sdf_grad_bwd"] == want, counts
        assert counts["rev_fwd"] == counts["rev_bwd"] == 0
        res[plain] = ((sdf.detach(), feat.detach(), grad.detach()), list(g))
    got, ref = res[False][0], _bf16w_plain(net, x, sphere > 0)
    agree = _sphere_agree(got, ref, x, net.cfg)
    _tan_close([t[agree] for t in got], [t[agree] for t in ref])
    grad_check(res[False][1], res[True][1],
               leaf_tol=0.1 if n >= 4800 else float("inf"))


@pytest.mark.parametrize("n", [33, 4800])
def test_tangent_kernels_without_encoding(dev, n):
    """A net with no encoding and a bounding sphere (the kernels run it as
    frequency count 0): K10 and K11 against their plain versions, K12 (K6
    on `bwd_stages`' pack, which K6's own refuses) against its bf16 replay
    (K6's) and against K6's entry on the same pack, bit for bit: this
    small net's gradient is short at some points, where the loss's normal
    term weighs bf16's error past the f32 bound (the replay lands on the
    kernel's numbers there)."""
    from i2sdf_tpu_torch.ops.kernels.replay import emulate_rev_bwd
    from test_torch_bwd_replay import grad_check
    from test_torch_rev_replay import flat_weights, loss_cotangents
    net, x = _tan_case(dev, n, cfg=NO_PE)
    with torch.no_grad():
        got = sdf_outputs.fused_sdf_outputs(net, x)
    ref = sdf_outputs.sdf_outputs_plain(net, x)
    agree = _sphere_agree(got, ref, x, net.cfg)
    _tan_close([t[agree] for t in got], [t[agree] for t in ref])
    ws, bs = flat_weights(net)
    out_r, grad_r = sdf_grad.sdf_grad_plain(net.cfg, ws, bs, x)
    c_out, c_g = loss_cotangents(out_r, grad_r, seed=n)
    c_out, c_g = c_out.contiguous(), c_g.contiguous()
    with torch.no_grad():
        kr = sdf_grad.bwd_stages(net.cfg, ws, bs)
        out, grad = sdf_grad.sdf_grad_fwd(kr, x)
        dws, dbs = sdf_grad.sdf_grad_bwd(kr, x, c_out, c_g)
        k6 = rev.rev_bwd(kr, x, c_out, c_g)
        replay = emulate_rev_bwd(kr, x, c_out, c_g)
    _tan_close((out[:, :1], out[:, 1:], grad),
               (out_r[:, :1], out_r[:, 1:], grad_r))
    assert all(torch.equal(a, b) for a, b in zip(dws + dbs, k6[0] + k6[1]))
    grad_check(dws + dbs, replay[0] + replay[1])


@pytest.mark.parametrize("n", [4800, 155_200])
def test_tangent_kernels_agree_with_rev_kernels(dev, n):
    """One function: K11 against K5 (two algorithms) to the same bounds,
    and K12 against K6 (one: K12 is K6 under its own name) on the same
    points, weights and cotangents, bit for bit."""
    from test_torch_rev_replay import flat_weights, loss_cotangents
    net, x = _tan_case(dev, n)
    ws, bs = flat_weights(net)
    with torch.no_grad():
        kt = sdf_grad.bwd_stages(net.cfg, ws, bs)
        kr = rev.RevStages(net.cfg, ws, bs)
        out_t, grad_t = sdf_grad.sdf_grad_fwd(kt, x)
        out_r, grad_r = rev.rev_fwd(kr, x)
        _tan_close((out_t[:, :1], out_t[:, 1:], grad_t),
                   (out_r[:, :1], out_r[:, 1:], grad_r))
        c_out, c_g = (c.contiguous() for c in loss_cotangents(out_r, grad_r))
        got_t = sdf_grad.sdf_grad_bwd(kt, x, c_out, c_g)
        got_r = rev.rev_bwd(kr, x, c_out, c_g)
    assert all(torch.equal(a, b) for a, b in zip(
        [t for g in got_t for t in g], [t for g in got_r for t in g]))


def test_tangent_kernels_refuse_cpu_weights(dev):
    from test_torch_rev_replay import flat_weights
    net, x = _tan_case(torch.device("cpu"), 8)
    with torch.no_grad():
        with pytest.raises(ValueError):
            sdf_outputs.fused_sdf_outputs(net, x.to(dev))
        k = sdf_grad.bwd_stages(net.cfg, *flat_weights(net))
        with pytest.raises(ValueError):
            sdf_grad.sdf_grad_fwd(k, x.to(dev))
        with pytest.raises(ValueError):
            sdf_grad.sdf_grad_bwd(k, x.to(dev),
                                  torch.zeros((8, 257), device=dev),
                                  torch.zeros((8, 3), device=dev))
    with pytest.raises(ValueError):
        sdf_grad.sdf_grad_fwd(k, x)
