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
K6's tests, and those of K3 and K4 with the light head, say theirs beside
them.
"""

import numpy as np
import pytest
import torch

from i2sdf_tpu_torch.models import mlp
from i2sdf_tpu_torch.models.sampler import SamplerConfig
from i2sdf_tpu_torch.ops import kernels
from i2sdf_tpu_torch.ops.kernels import (render_core, rev, sampler_round,
                                         sdf_mlp)

pytestmark = pytest.mark.gpu

ICFG = mlp.ImplicitNetConfig(
    feature_vector_size=256, sdf_bounding_sphere=0.0, dims=(256,) * 8,
    skip_in=(4,), bias=0.6, embed_type="positional", multires=6)
RCFG = mlp.RenderingNetConfig(feature_vector_size=256, dims=(256,) * 4,
                              embed_type="positional", multires=4)
SCFG = SamplerConfig(eps=0.1, beta_iters=10, add_tiny=1e-6)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    return torch.device("cuda", 0)


def _nets(dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (mlp.ImplicitNet(ICFG, gen).to(dev),
            mlp.RenderingNet(RCFG, gen).to(dev))


def _points(n, dev, seed=1, scale=1.5):
    return torch.from_numpy((np.random.default_rng(seed).normal(
        size=(n, 3)) * scale).astype(np.float32)).to(dev)


@pytest.mark.parametrize("n", [1, 63, 64, 4097])
def test_sdf_mlp_kernel(dev, n):
    net, _ = _nets(dev)
    pts = _points(n, dev, seed=n)
    kernels.reset_launch_counts()
    got = sdf_mlp.sdf_mlp_nograd(sdf_mlp.SdfMlpPack(net), pts)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sdf_mlp_nograd"] == 1
    torch.testing.assert_close(got, sdf_mlp.sdf_mlp_plain(net, pts),
                               atol=0.02, rtol=0.02)


def _round_inputs(R, S, n_out, dev, seed=0):
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(0.0, 6.0, (R, S)).astype(np.float32), axis=-1)
    sdf = (3.0 - z + 0.1 * rng.normal(size=(R, S))).astype(np.float32)
    beta = rng.uniform(0.05, 0.8, (R,)).astype(np.float32)
    u = np.sort(rng.uniform(0.0, 1.0, (R, n_out)).astype(np.float32), -1)
    return [torch.from_numpy(a).to(dev) for a in (z, sdf, beta, u)]


@pytest.mark.parametrize("S", [97, 128, 480, 600])
@pytest.mark.parametrize("final", [False, True])
def test_sampler_round_kernel(dev, S, final):
    z, sdf, beta, u = _round_inputs(333, S, 64, dev, seed=S)
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


@pytest.mark.parametrize("n", [33, 1000])
def test_render_core_kernel(dev, n):
    net, rnet = _nets(dev)
    x = _points(n, dev, seed=n, scale=0.8)
    d = torch.nn.functional.normalize(_points(n, dev, seed=n + 1), dim=-1)
    pack = render_core.RenderCorePack(net, rnet)
    got = render_core.render_core_fwd(pack, x, d)
    torch.cuda.synchronize()
    ref = render_core.render_core_plain(net, rnet, x, d)
    for name, g, r, (atol, rtol) in zip(
            ("sdf", "grad", "rgb"), got, ref,
            ((0.02, 0.02), (0.05, 0.08), (0.03, 0.05))):
        torch.testing.assert_close(g, r, atol=atol, rtol=rtol, msg=name)


def test_kernels_refuse_cpu_weights(dev):
    net, rnet = _nets(torch.device("cpu"))
    with pytest.raises(ValueError):
        sdf_mlp.sdf_mlp_nograd(sdf_mlp.SdfMlpPack(net), _points(8, dev))
    with pytest.raises(ValueError):
        render_core.render_core_fwd(render_core.RenderCorePack(net, rnet),
                                    _points(8, dev), _points(8, dev))


# ---- K4 render_core_bwd ----------------------------------------------------
# Cotangents are those of the JAX package's kernel-test loss at the plain
# outputs (test_torch_bwd_replay.loss_cotangents). The kernel is held to
# its bf16 replay (the same rounding points) with the JAX package's
# gradient tolerance at every count, and to the plain f32 backward by
# cosine > 0.999 at every count and per leaf (< 0.1) from 4,800 points
# up: below that a few bf16 mask flips weigh on a leaf as much as the
# signal does (replay: 0.62 per leaf at 1 point, 0.018 at 4,800).

@pytest.mark.parametrize("n,eik", [(1, 0), (31, 0), (33, 16), (4800, 4800),
                                   (160_000, 4800)])
def test_render_core_bwd_kernel(dev, n, eik):
    from test_torch_bwd_replay import (CASES, eik_only, emulate_bwd,
                                       grad_check, loss_cotangents, nets,
                                       plain_vjp, points)
    net, rnet = nets(*CASES["flagship"], device=dev)
    x, d = points(n, n, eik, device=dev)
    w = render_core.CoreWeights.of(net, rnet)
    cot = eik_only(loss_cotangents(*render_core.render_core_train_plain(
        net.cfg, rnet.cfg, w, x, d)), eik)
    with torch.no_grad():
        k = render_core._KernelLayout(net.cfg, rnet.cfg, w)
        kernels.reset_launch_counts()
        got = render_core.render_core_bwd(k, x, d, cot)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["render_core_bwd"] == 1
        got = [t for grp in got for t in grp]
        replay = [t for grp in emulate_bwd(k, x, d, cot) for t in grp]
    grad_check(got, replay)
    ref = plain_vjp(net.cfg, rnet.cfg, w, x, d, cot)
    grad_check(got, ref, leaf_tol=0.1 if n >= 4800 else float("inf"))


def test_render_core_bwd_padding_rows_add_nothing(dev):
    """33 points and the same 33 plus 31 rows with zero cotangents share
    one padded size (64): the results agree to the bit."""
    from test_torch_bwd_replay import CASES, nets, points
    net, rnet = nets(*CASES["flagship"], device=dev)
    x, d = points(64, 3, device=dev)
    cot = torch.randn((64, 8), generator=torch.Generator().manual_seed(0))
    cot = cot.to(dev)
    cot[33:] = 0.0
    with torch.no_grad():
        k = render_core._KernelLayout(
            net.cfg, rnet.cfg, render_core.CoreWeights.of(net, rnet))
        a = render_core.render_core_bwd(k, x[:33].contiguous(),
                                        d[:33].contiguous(),
                                        cot[:33].contiguous())
        b = render_core.render_core_bwd(k, x, d, cot)
    for ga, gb in zip([t for g in a for t in g], [t for g in b for t in g]):
        assert torch.equal(ga, gb)


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


@pytest.mark.parametrize("n", [1, 33, 12_000])
def test_render_core_light_kernel(dev, n):
    from test_torch_bwd_replay import light_layout, points
    net, rnet, lnet = light_layout("light", device=dev)
    x, d = points(n, n, device=dev)
    pack = render_core.RenderCorePack(net, rnet, lnet)
    kernels.reset_launch_counts()
    got = render_core.render_core_fwd(pack, x, d)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["render_core_fwd_light"] == 1
    assert counts["render_core_fwd"] == 0
    ref = render_core.render_core_plain(net, rnet, x, d, lnet)
    assert len(got) == len(ref) == 4
    for (name, (atol, rtol)), g, r in zip(LIGHT_TOLS.items(), got, ref):
        torch.testing.assert_close(g, r, atol=atol, rtol=rtol, msg=name)


def _light_case(dev, n, eik, detach, seed=0):
    from test_torch_bwd_replay import (eik_only, light_layout,
                                       loss_cotangents, points)
    net, rnet, lnet = light_layout("light", device=dev)
    x, d = points(n, n + seed, eik, device=dev)
    w = render_core.CoreWeights.of(net, rnet, lnet)
    outs = render_core.render_core_train_plain(net.cfg, rnet.cfg, w, x, d,
                                               lnet.cfg, detach)
    cot = eik_only(loss_cotangents(*outs[:3], lmask=outs[3]), eik)
    return net, rnet, lnet, x, d, w, cot


@pytest.mark.parametrize("detach", [True, False], ids=["detached",
                                                       "coupled"])
@pytest.mark.parametrize("n,eik", [(1, 0), (33, 16), (4800, 4800),
                                   (160_000, 4800)])
def test_render_core_bwd_light_kernel(dev, n, eik, detach):
    from test_torch_bwd_replay import emulate_bwd, grad_check, plain_vjp
    net, rnet, lnet, x, d, w, cot = _light_case(dev, n, eik, detach)
    with torch.no_grad():
        k = render_core._KernelLayout(net.cfg, rnet.cfg, w, lnet.cfg)
        kernels.reset_launch_counts()
        got = render_core.render_core_bwd(k, x, d, cot, detach)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts["render_core_bwd_light"] == 1
        assert counts["render_core_bwd"] == 0
        got = [t for grp in got for t in grp]
        replay = [t for grp in emulate_bwd(k, x, d, cot, detach_light=detach)
                  for t in grp]
    grad_check(got, replay)
    ref = plain_vjp(net.cfg, rnet.cfg, w, x, d, cot, lnet.cfg, detach)
    grad_check(got, ref, leaf_tol=0.1 if n >= 4800 else float("inf"))


@pytest.mark.parametrize("detach", [True, False], ids=["detached",
                                                       "coupled"])
def test_render_core_bwd_light_padding_and_determinism(dev, detach):
    """33 points and the same 33 plus 31 rows with zero cotangents share
    one padded size (64): the results agree to the bit, and a second run
    gives the same bits. Detached, the SDF and radiance gradients are
    those of the kernel without the light head, to the bit."""
    net, rnet, lnet, x, d, w, cot = _light_case(dev, 64, 0, detach, seed=3)
    cot[33:] = 0.0
    flat = lambda r: [t for g in r for t in g]  # noqa: E731
    with torch.no_grad():
        k = render_core._KernelLayout(net.cfg, rnet.cfg, w, lnet.cfg)
        a = flat(render_core.render_core_bwd(
            k, x[:33].contiguous(), d[:33].contiguous(),
            cot[:33].contiguous(), detach))
        b = flat(render_core.render_core_bwd(k, x, d, cot, detach))
        c = flat(render_core.render_core_bwd(k, x, d, cot, detach))
        k0 = render_core._KernelLayout(net.cfg, rnet.cfg,
                                       render_core.CoreWeights.of(net, rnet))
        base = flat(render_core.render_core_bwd(k0, x, d, cot))
    for ga, gb, gc in zip(a, b, c):
        assert torch.equal(ga, gb) and torch.equal(gb, gc)
    n_light = 2 * k.n_light
    assert all(float(g.abs().max()) > 0 for g in b[-n_light:])
    same = [torch.equal(g, h) for g, h in zip(b[:-n_light], base)]
    if detach:
        assert all(same)
    else:  # the light cotangent reaches the SDF net
        assert not all(same[:2 * k.n_sdf])


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
# 0.08). K6 takes the cotangents of that test's loss,
# which reads the sdf, the features and the gradient (so c_out and c_g are
# both non-zero), and is held to its bf16 replay with the JAX package's
# gradient tolerance at every count, and to the plain f32 backward by
# cosine > 0.999 at every count and per leaf (< 0.1) from 4,800 points up,
# as K4 is.

REV_COUNTS = [1, 31, 33, 4800, 155_200]
REV_TOLS = {"sdf": (0.02, 0.02), "feat": (0.05, 0.05), "grad": (0.05, 0.08)}


def _rev_case(dev, n, sphere=0.0):
    from test_torch_bwd_replay import points
    from test_torch_rev_replay import FLAGSHIP, eikonal_points, sdf_net
    net = sdf_net(**FLAGSHIP, sphere=sphere, device=dev)
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


@pytest.mark.parametrize("n", REV_COUNTS)
def test_rev_fwd_kernel(dev, n):
    from test_torch_rev_replay import flat_weights
    net, x = _rev_case(dev, n)
    ws, bs = flat_weights(net)
    with torch.no_grad():
        k = rev.RevLayout(net.cfg, ws, bs)
        kernels.reset_launch_counts()
        got = rev.rev_fwd(k, x)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["rev_fwd"] == 1
    _rev_close(got, rev.rev_plain(net.cfg, ws, bs, x))


@pytest.mark.parametrize("n", REV_COUNTS)
def test_rev_bwd_kernel(dev, n):
    from test_torch_bwd_replay import grad_check
    from test_torch_rev_replay import (emulate_rev_bwd, flat_weights,
                                       loss_cotangents)
    net, x = _rev_case(dev, n)
    ws, bs = flat_weights(net)
    out, grad = rev.rev_plain(net.cfg, ws, bs, x)
    c_out, c_g = loss_cotangents(out, grad, seed=n)
    assert c_out.abs().max() > 0 and c_g.abs().max() > 0
    ref = list(torch.autograd.grad((out, grad), ws + bs, (c_out, c_g)))
    del out, grad
    with torch.no_grad():
        k = rev.RevLayout(net.cfg, ws, bs)
        kernels.reset_launch_counts()
        got = rev.rev_bwd(k, x, c_out.contiguous(), c_g.contiguous())
        torch.cuda.synchronize()
        assert kernels.launch_counts()["rev_bwd"] == 1
        got = [t for grp in got for t in grp]
        replay = [t for grp in emulate_rev_bwd(k, x, c_out, c_g) for t in grp]
    grad_check(got, replay)
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
        k = rev.RevLayout(net.cfg, *flat_weights(net))
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
