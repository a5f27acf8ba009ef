"""K4 (`csrc/render_core_bwd.cu`) replayed in torch from exactly what its
wrapper hands the kernel, and held to the plain backward (autograd of
`render_core_train_plain`).

`emulate_bwd` runs `K4Replay` (`i2sdf_tpu_torch/ops/kernels/replay.py`),
which follows the kernel step by step: K3's stage images and `K4Stages`'
transposed ones read as wgmma reads them, the 64-point tile and the
ring's slots as shared memory written through the kernel's `act_off` and
`f32_at`, the ring table (`K4Plan.script`) consumed item by item (a
stash tile loaded before the wait for the sweep that stored it fails),
the scratch regions the bulk copies fill, the per-block bias rows, the
weight-gradient products reading the operand regions MN-major, the split
sums and the wrapper's un-permutation. Every shared-memory and scratch
element starts as NaN, so a region read but never written shows up.
`rnd` says where the kernel rounds to bf16:

* with no rounding the replay is the kernel's algorithm in f32 on its
  bf16 weights, and it must equal the plain backward on the same
  bf16-rounded weights to f32 rounding (1e-5 of each leaf's largest
  entry): a wrong offset, width, flag, sweep or permutation fails this;
* with the kernel's rounding it is held to the plain backward on the f32
  weights with the JAX package's gradient tolerance for its bf16 kernel
  (`tests/test_pallas_train.py:96-111`: per leaf max|d|/max|ref| < 0.1,
  cosine > 0.999), with the cotangents of a loss as that test takes them.
  Unstructured random cotangents are not used for this bound: where bf16
  activations flip a ReLU or softplus mask the flipped terms enter the
  sums with random signs, and the per-leaf spread then stays near 0.1 at
  any point count (0.097 at 2048 points in the replay); a loss's
  cotangents add coherently and the spread falls with the count.

The module imports no JAX, so the card tests (`test_torch_gpu_kernels.py`)
reuse the replay on CUDA tensors.
"""

import numpy as np
import pytest
import torch

from i2sdf_tpu_torch.models import mlp
from i2sdf_tpu_torch.ops.kernels import render_core
from i2sdf_tpu_torch.ops.kernels.render_core import REG_CLG, REG_LS
from i2sdf_tpu_torch.ops.kernels.replay import K4Replay, bf
from test_torch_kernel_layout import LIGHT_CASES, LIGHT_ODD, light_net



def grad_check(got, ref, leaf_tol=0.1, cos_tol=0.999) -> dict:
    """The JAX package's gradient check for its bf16 kernel over two
    matching lists of leaves; returns the worst leaf error and the
    cosine (f64)."""
    errs = [float((g - r).abs().max() / max(float(r.abs().max()), 1e-3))
            for g, r in zip(got, ref)]
    a = torch.cat([r.flatten().double() for r in ref])
    b = torch.cat([g.flatten().double() for g in got])
    cos = float(a @ b / (a.norm() * b.norm()))
    worst = int(np.argmax(errs))
    assert errs[worst] < leaf_tol, (worst, errs[worst])
    assert cos > cos_tol, cos
    return {"max_leaf_err": errs[worst], "cos": cos}


def loss_cotangents(sdf, grad, rgb, seed=0, lmask=None):
    """Cotangents (N, 8) [grad | sdf | rgb | lmask] of the loss the JAX
    package's kernel test takes (`tests/test_pallas_train.py:38-43`: rgb
    L1, sdf^2, normal L1 against seeded targets, eikonal; with a light
    mask, its light test's 0.3 * mean((lmask - target)^2), `:186-188`) at
    these outputs; the light column is zero without a light mask."""
    n = sdf.shape[0]
    gen = torch.Generator().manual_seed(seed)
    gt = torch.rand((n, 3), generator=gen).to(sdf.device)
    gn = torch.nn.functional.normalize(
        torch.randn((n, 3), generator=gen), dim=-1).to(sdf.device)
    gl = torch.rand((n, 1), generator=gen).to(sdf.device)
    lm = sdf.new_zeros((n, 1)) if lmask is None else lmask
    s, g, r, m = (t.detach().requires_grad_(True)
                  for t in (sdf, grad, rgb, lm))
    with torch.enable_grad():
        nrm = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True),
                              min=1e-9)
        loss = ((r - gt).abs().mean() + 0.2 * (s ** 2).mean()
                + 0.5 * (1 - (nrm * gn).sum(-1)).abs().mean()
                + 0.1 * ((torch.linalg.norm(g, dim=-1) - 1) ** 2).mean())
        if lmask is not None:
            loss = loss + 0.3 * ((m - gl) ** 2).mean()
        cs, cg, cr, cm = torch.autograd.grad(loss, (s, g, r, m),
                                             allow_unused=True)
    cm = torch.zeros_like(lm) if cm is None else cm
    return torch.cat([cg, cs, cr, cm], 1)


def plain_vjp(icfg, rcfg, w, x, dirs, cot, lcfg=None, detach_light=True):
    """The plain backward: gradients of <cot, [grad | sdf | rgb | lmask]>
    with respect to `w.flat()` (the light mask with a light head)."""
    outs = render_core.render_core_train_plain(icfg, rcfg, w, x, dirs,
                                               lcfg, detach_light)
    cots = (cot[:, 3:4], cot[:, :3], cot[:, 4:7], cot[:, 7:8])
    return list(torch.autograd.grad(outs, w.flat(), cots[:len(outs)],
                                    allow_unused=True))


def bf16_weights(w: render_core.CoreWeights) -> render_core.CoreWeights:
    """The weights rounded to bf16 as the kernels' packs hold them (biases
    stay f32), as fresh leaves."""
    def leaf(t, rnd):
        t = t.detach()
        return (t.to(torch.bfloat16).float() if rnd else t.clone()
                ).requires_grad_(True)
    return render_core.CoreWeights(
        tuple(leaf(t, True) for t in w.ws_sdf),
        tuple(leaf(t, False) for t in w.bs_sdf),
        tuple(leaf(t, True) for t in w.ws_rad),
        tuple(leaf(t, False) for t in w.bs_rad),
        tuple(leaf(t, True) for t in w.ws_l),
        tuple(leaf(t, False) for t in w.bs_l))


def k4_pack(icfg, rcfg, w, lcfg=None):
    """K3's pack and K4's transposed chains of the weights `w`."""
    with torch.no_grad():
        return (render_core.CoreStages(icfg, rcfg, w, lcfg),
                render_core.K4Stages(icfg, rcfg, w, lcfg))


def emulate_bwd(icfg, rcfg, w, x, dirs, cot, rnd=bf, detach_light=True,
                lcfg=None, grad=None):
    """K4 in torch from what its wrapper hands it (the packs of `w`, its
    `K4Plan`); returns what the wrapper returns. `rnd` is where the kernel
    rounds to bf16 (activations, cotangents, everything it stores as
    bf16); the identity replays the same algorithm in f32 on the kernel's
    bf16 weights. With a light head (`lcfg`), c_lm is the cotangents'
    column 7. An idr-mode radiance net takes `grad` (K3's gradient of the
    points; the plain f32 one at `w` if None)."""
    st, t = k4_pack(icfg, rcfg, w, lcfg)
    coupled = lcfg is not None and not detach_light
    if st.idr and grad is None:
        grad = render_core.render_core_train_plain(icfg, rcfg, w, x,
                                                   dirs)[1].detach()
    with torch.no_grad():
        plan = render_core.K4Plan(st, t, x.shape[0], coupled)
        out = K4Replay(st, t, plan, x, dirs, cot, rnd, detach_light,
                       grad).run()
        return render_core.unpack_grads(st, t, out, plan)


def nets(width, skip, feat, rad, mx, md, seed=0, device="cpu", depth=8,
         mode="nerf"):
    """The SDF net (`depth` hidden layers) and radiance net of a case
    (`mode` "idr": the radiance net on [pts | PE(view) | normals |
    features], `d_in` 9)."""
    gen = torch.Generator().manual_seed(seed)
    icfg = mlp.ImplicitNetConfig(
        feature_vector_size=feat, sdf_bounding_sphere=0.0,
        dims=(width,) * depth, skip_in=(skip,), bias=0.6,
        embed_type="positional", multires=mx)
    rcfg = mlp.RenderingNetConfig(feature_vector_size=feat, dims=(rad,) * 4,
                                  embed_type="positional", multires=md,
                                  mode=mode, d_in=9 if mode == "idr" else 3)
    net, rnet = mlp.ImplicitNet(icfg, gen), mlp.RenderingNet(rcfg, gen)
    with torch.no_grad():  # move off the init's zero PE weights
        for lin in net.layers() + rnet.layers():
            lin.v.add_(0.01 * torch.randn(lin.v.shape, generator=gen))
    return net.to(device), rnet.to(device)


def points(n, seed, eik=0, device="cpu"):
    """n points around the origin along unit directions; the last `eik`
    are eikonal rows (zero directions)."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * 0.8).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    if eik:
        dirs[n - eik:] = 0.0
    return (torch.from_numpy(pts).to(device),
            torch.from_numpy(dirs).to(device))


def eik_only(cot, eik):
    """Eikonal rows carry only the gradient's cotangent."""
    if eik:
        cot[cot.shape[0] - eik:, 3:] = 0.0
    return cot


CASES = {"flagship": (256, 4, 256, 256, 6, 4),
         "narrow": (64, 3, 32, 48, 4, 2)}


@pytest.mark.parametrize("case,n,eik", [("flagship", 96, 32),
                                        ("narrow", 33, 0),
                                        ("narrow", 160, 64)])
def test_k4_replay_in_f32_equals_plain_backward(case, n, eik):
    net, rnet = nets(*CASES[case])
    x, d = points(n, n, eik)
    c = eik_only(torch.from_numpy(np.random.default_rng(n).normal(
        size=(n, 7)).astype(np.float32)), eik)
    w = render_core.CoreWeights.of(net, rnet)
    got = [t for grp in emulate_bwd(net.cfg, rnet.cfg, w, x, d, c,
                                    rnd=lambda t: t) for t in grp]
    ref = plain_vjp(net.cfg, rnet.cfg, bf16_weights(w), x, d, c)
    assert [g.shape for g in got] == [r.shape for r in ref]
    for i, (g, r) in enumerate(zip(got, ref)):
        torch.testing.assert_close(g, r, rtol=0,
                                   atol=1e-5 * float(r.abs().max()),
                                   msg=str(i))


def test_k4_replay_with_its_rounding_meets_the_kernel_tolerance():
    net, rnet = nets(*CASES["flagship"])
    n, eik = 1024, 256
    x, d = points(n, 5, eik)
    w = render_core.CoreWeights.of(net, rnet)
    c = eik_only(loss_cotangents(*render_core.render_core_train_plain(
        net.cfg, rnet.cfg, w, x, d)), eik)
    got = [t for grp in emulate_bwd(net.cfg, rnet.cfg, w, x, d, c)
           for t in grp]
    grad_check(got, plain_vjp(net.cfg, rnet.cfg, w, x, d, c))


@pytest.mark.parametrize("case,n,eik", [("flagship", 96, 32),
                                        ("narrow", 160, 64)])
def test_k4_idr_replay_in_f32_equals_plain_backward(case, n, eik):
    """K4 with the idr-mode radiance net, its algorithm in f32 on its bf16
    weights and handed the plain gradient at those weights (K3's, without
    its rounding), against the plain backward on the same weights (1e-5 of
    each leaf's largest entry): the radiance input's xyz and gradient
    columns, the gradient rows' cotangent joined to c_grad before the
    second-order sweeps, and the row order of radiance layer 0 put back.
    The radiance layer 0's gradient rows and the SDF leaves differ from a
    replay that leaves the gradient's cotangent out."""
    net, rnet = nets(*CASES[case], mode="idr")
    x, d = points(n, n, eik)
    c = eik_only(torch.from_numpy(np.random.default_rng(n).normal(
        size=(n, 7)).astype(np.float32)), eik)
    w = render_core.CoreWeights.of(net, rnet)
    wb = bf16_weights(w)
    g = render_core.render_core_train_plain(net.cfg, rnet.cfg, wb, x,
                                            d)[1].detach()
    got = [t for grp in emulate_bwd(net.cfg, rnet.cfg, w, x, d, c,
                                    rnd=lambda t: t, grad=g) for t in grp]
    ref = plain_vjp(net.cfg, rnet.cfg, wb, x, d, c)
    assert [a.shape for a in got] == [r.shape for r in ref]
    assert ref[2 * len(w.ws_sdf)].shape[0] == rnet.cfg.layer_dims()[0]
    for i, (a, r) in enumerate(zip(got, ref)):
        torch.testing.assert_close(a, r, rtol=0,
                                   atol=1e-5 * float(r.abs().max()),
                                   msg=str(i))


def test_k4_idr_replay_with_its_rounding_meets_the_kernel_tolerance():
    """At the flagship's widths in idr mode, with the kernel's bf16
    rounding, handed the gradient of K3's replay, and a loss's
    cotangents: the JAX package's gradient tolerance for its bf16 kernel
    against the plain f32 backward."""
    from test_torch_kernel_layout import emulate_render_core
    net, rnet = nets(*CASES["flagship"], mode="idr")
    n, eik = 1024, 256
    x, d = points(n, 5, eik)
    w = render_core.CoreWeights.of(net, rnet)
    c = eik_only(loss_cotangents(*render_core.render_core_train_plain(
        net.cfg, rnet.cfg, w, x, d)), eik)
    st, _ = k4_pack(net.cfg, rnet.cfg, w)
    g3 = emulate_render_core(st, x, d)[1]
    got = [t for grp in emulate_bwd(net.cfg, rnet.cfg, w, x, d, c, grad=g3)
           for t in grp]
    grad_check(got, plain_vjp(net.cfg, rnet.cfg, w, x, d, c))


def _check_plan(plan, st, t):
    """Every region 1024-byte aligned and disjoint from the others; the
    ring table's items: each layer's stage images in the order the
    sweeps take them, stash loads of regions that exist, waits that only
    grow; each weight gradient's splits cover the blocks."""
    spans = sorted((off, plan.blocks * stride)
                   for kind in plan.regions for off, stride in kind
                   if stride)
    spans.append((plan.dbpart, plan.blocks * plan.tb * 4))
    spans.sort()
    for (o1, s1), (o2, _) in zip(spans, spans[1:]):
        assert o1 % 1024 == 0 and o1 + s1 <= o2
    assert spans[-1][0] + spans[-1][1] + render_core._SLOT <= plan.scratch_bytes
    waits = [int(it[1]) for it in plan.script if it[0] == render_core._WAIT]
    assert waits == sorted(waits) and len(set(waits)) == len(waits)
    offs = {off for kind in plan.regions for off, stride in kind if stride}
    for kind, off, stride, nbytes in plan.script:
        if kind == render_core._LOAD:   # a stash tile from the scratch
            base = max(o for o in offs if o <= off)
            assert off + nbytes <= base + stride and nbytes <= 32768
    for row in plan.jobs:
        per, splits, nblk = int(row[14]), int(row[15]), int(row[13])
        assert (splits - 1) * per < nblk <= splits * per <= 32 * per


def test_bwd_plan_table_and_cotangents():
    """K4's plan at the training batch: its regions, ring table and jobs;
    the cotangents' packing."""
    net, rnet = nets(*CASES["flagship"])
    w = render_core.CoreWeights.of(net, rnet)
    st, t = k4_pack(net.cfg, rnet.cfg, w)
    plan = render_core.K4Plan(st, t, 160_000, False)
    ns, nr = t.n_sdf, t.n_rad
    assert (ns, nr, plan.blocks) == (9, 5, 2500)
    _check_plan(plan, st, t)
    # the sweeps' weight stages: forward (8 hidden + the features), the
    # radiance net and its transpose, reverse, upward and downward
    chunks = lambda plan_rows: sum(-(-int(K) // 64) for K in plan_rows[:, 0])  # noqa
    fwd = st.sdf.plan
    want = (chunks(fwd[:ns - 1]) + chunks(fwd[ns:]) + chunks(st.rad.plan)
            + chunks(t.trad) + chunks(t.tsdf[1:]) + chunks(fwd[:ns - 1])
            + chunks(t.tsdf))
    assert sum(1 for it in plan.script
               if it[0] >> 8 and it[0] & 255 == 0) == want
    # stash: q back 3 times, ah twice a slot, dz_extra once; staging slots
    assert sum(1 for it in plan.script if it[0] == render_core._STAGE) == (
        (ns - 1) + 2 * (ns - 2) + (ns - 1))
    assert len(plan.jobs) == ns + nr and plan.dims[ns - 1] == (256, 257)
    assert plan.tb == sum(N for _, N in plan.dims)
    cot = render_core.pack_cotangents(
        2, torch.ones(2, 1), torch.full((2, 3), 2.0), None, "cpu")
    assert cot.tolist() == [[2, 2, 2, 1, 0, 0, 0, 0]] * 2
    cot = render_core.pack_cotangents(2, None, None, None, "cpu",
                                      torch.full((2, 1), 5.0))
    assert cot.tolist() == [[0, 0, 0, 0, 0, 0, 0, 5]] * 2


def test_bwd_plan_and_pack_in_idr_mode():
    """K4's plan at the training batch in idr mode: the radiance input's
    289 rows fit the tile's five chunks, so the regions, ring table and
    jobs are nerf mode's but for radiance layer 0's depth (304 against
    288); `K4Stages.wgr` is radiance layer 0's normals rows (the nets'
    rows 3 + vdim .. 6 + vdim) rounded to bf16, and nerf mode has none."""
    packs = {}
    for mode in ("nerf", "idr"):
        net, rnet = nets(*CASES["flagship"], mode=mode)
        w = render_core.CoreWeights.of(net, rnet)
        st, t = k4_pack(net.cfg, rnet.cfg, w)
        packs[mode] = (st, t, render_core.K4Plan(st, t, 160_000, False), w)
    (sn, tn, pn, _), (si, ti, pi, wi) = packs["nerf"], packs["idr"]
    _check_plan(pi, si, ti)
    assert tn.wgr is None and (int(sn.rad.plan[0, 0]),
                               int(si.rad.plan[0, 0])) == (288, 304)
    assert pi.scratch_bytes == pn.scratch_bytes
    assert np.array_equal(pi.script, pn.script)
    assert pi.dims == [d if p != 9 else (304, 256)
                                    for p, d in enumerate(pn.dims)]
    w0 = wi.ws_rad[0].detach()
    assert torch.equal(ti.wgr, bf(w0[30:33]))


def light_layout(case, device="cpu", seed=0, mode="nerf"):
    """The nets and kernel layout of a `LIGHT_CASES` case (`mode` "idr":
    the radiance net on [pts | PE(view) | normals | features])."""
    (width, skip, feat, rad, mx, md), depth, rdepth, ldims = {
        **LIGHT_CASES, **LIGHT_ODD}[case]
    gen = torch.Generator().manual_seed(seed)
    icfg = mlp.ImplicitNetConfig(
        feature_vector_size=feat, sdf_bounding_sphere=0.0,
        dims=(width,) * depth, skip_in=(skip,), bias=0.6,
        embed_type="positional", multires=mx)
    rcfg = mlp.RenderingNetConfig(feature_vector_size=feat,
                                  dims=(rad,) * rdepth,
                                  embed_type="positional", multires=md,
                                  mode=mode, d_in=9 if mode == "idr" else 3)
    net, rnet = mlp.ImplicitNet(icfg, gen), mlp.RenderingNet(rcfg, gen)
    with torch.no_grad():  # move off the init's zero PE weights
        for lin in net.layers() + rnet.layers():
            lin.v.add_(0.01 * torch.randn(lin.v.shape, generator=gen))
    lnet = light_net(feat, ldims, seed)
    return net.to(device), rnet.to(device), lnet.to(device)


def _light_grads(net, rnet, lnet, x, d, c, detach, rnd):
    w = render_core.CoreWeights.of(net, rnet, lnet)
    got = [t for grp in emulate_bwd(net.cfg, rnet.cfg, w, x, d, c, rnd=rnd,
                                    detach_light=detach, lcfg=lnet.cfg)
           for t in grp]
    return w, got


@pytest.mark.parametrize("detach", [True, False], ids=["detached",
                                                       "coupled"])
@pytest.mark.parametrize("case,n,eik", [("light", 96, 32),
                                        ("narrow", 33, 0),
                                        ("narrow", 160, 64)])
def test_k4_light_replay_in_f32_equals_plain_backward(case, n, eik, detach):
    """K4 with the light head, its algorithm in f32 on its bf16 weights,
    against the plain backward on the same weights (1e-5 of each leaf's
    largest entry), light leaves included and non-zero; detached, the
    SDF and radiance leaves are the replay's without the light head."""
    net, rnet, lnet = light_layout(case)
    x, d = points(n, n, eik)
    c = eik_only(torch.from_numpy(np.random.default_rng(n).normal(
        size=(n, 8)).astype(np.float32)), eik)
    w, got = _light_grads(net, rnet, lnet, x, d, c, detach, lambda t: t)
    ref = plain_vjp(net.cfg, rnet.cfg, bf16_weights(w), x, d, c, lnet.cfg,
                    detach)
    assert [g.shape for g in got] == [r.shape for r in ref]
    for i, (g, r) in enumerate(zip(got, ref)):
        torch.testing.assert_close(g, r, rtol=0,
                                   atol=1e-5 * float(r.abs().max()),
                                   msg=str(i))
    n_light = 2 * render_core.n_layers(lnet.cfg)
    assert all(float(g.abs().max()) > 0 for g in got[-n_light:])
    if detach:
        base = [t for grp in emulate_bwd(
            net.cfg, rnet.cfg, render_core.CoreWeights.of(net, rnet), x, d,
            c, rnd=lambda t: t) for t in grp]
        for g, b in zip(got[:-n_light], base):
            assert torch.equal(g, b)


@pytest.mark.parametrize("detach", [True, False], ids=["detached",
                                                       "coupled"])
def test_k4_light_replay_with_its_rounding_meets_the_kernel_tolerance(
        detach):
    """At the light-mask config's widths and depths, with the kernel's
    bf16 rounding and a loss's cotangents (the light term included),
    against the plain f32 backward: the JAX package's gradient tolerance
    for its bf16 kernel, every leaf the light net's too."""
    net, rnet, lnet = light_layout("light")
    n, eik = 1024, 256
    x, d = points(n, 5, eik)
    w = render_core.CoreWeights.of(net, rnet, lnet)
    outs = render_core.render_core_train_plain(net.cfg, rnet.cfg, w, x, d,
                                               lnet.cfg, detach)
    c = eik_only(loss_cotangents(*outs[:3], lmask=outs[3]), eik)
    assert float(c[:, 7].abs().max()) > 0
    _, got = _light_grads(net, rnet, lnet, x, d, c, detach, bf)
    grad_check(got, plain_vjp(net.cfg, rnet.cfg, w, x, d, c, lnet.cfg,
                              detach))


def test_bwd_plan_table_with_the_light_head():
    """The light layers' regions (lx, ldz, the hidden layers' s, the gated
    feature cotangent when coupled), their ring items and bias columns
    after the radiance layers'."""
    net, rnet, lnet = light_layout("light")
    w = render_core.CoreWeights.of(net, rnet, lnet)
    st, t = k4_pack(net.cfg, rnet.cfg, w, lnet.cfg)
    ns, nr, nl = t.n_sdf, t.n_rad, t.n_light
    assert (ns, nr, nl) == (7, 4, 2)
    for coupled in (False, True):
        plan = render_core.K4Plan(st, t, 160_000, coupled)
        _check_plan(plan, st, t)
        assert plan.dims[ns + nr:] == [(256, 128), (128, 1)]
        assert plan.db[ns + nr:] == [plan.tb - 1 - 128, plan.tb - 1]
        assert bool(plan.regions[REG_CLG][0][1]) == coupled
        assert plan.regions[REG_LS][0][1] and not plan.regions[REG_LS][1][1]
        stages = sum(1 for it in plan.script if it[0] == render_core._STAGE)
        assert stages == (ns - 1) + 2 * (ns - 2) + (ns - 1) + 1 + 2 * coupled


@pytest.mark.parametrize("detach", [True, False], ids=["detached",
                                                       "coupled"])
@pytest.mark.parametrize("case,n,eik", [("light", 96, 32),
                                        ("narrow", 160, 64)])
def test_k4_light_idr_replay_in_f32_equals_plain_backward(case, n, eik,
                                                          detach):
    """K4 with the light head beside the idr-mode radiance net, its
    algorithm in f32 on its bf16 weights and handed the plain gradient at
    those weights, against the plain backward on the same weights (1e-5
    of each leaf's largest entry): the light head before the idr columns
    (each would show the other's overwrite), and with `detach` off the
    light's feature cotangent and idr's gradient cotangent each joined
    where the kernel joins it. Detached, the SDF and radiance leaves are
    the idr replay's without the light head; coupled, the SDF leaves
    differ from them."""
    net, rnet, lnet = light_layout(case, mode="idr")
    x, d = points(n, n, eik)
    c = eik_only(torch.from_numpy(np.random.default_rng(n).normal(
        size=(n, 8)).astype(np.float32)), eik)
    w = render_core.CoreWeights.of(net, rnet, lnet)
    wb = bf16_weights(w)
    g = render_core.render_core_train_plain(net.cfg, rnet.cfg, wb, x,
                                            d)[1].detach()
    got = [t for grp in emulate_bwd(net.cfg, rnet.cfg, w, x, d, c,
                                    rnd=lambda t: t, detach_light=detach,
                                    lcfg=lnet.cfg, grad=g) for t in grp]
    ref = plain_vjp(net.cfg, rnet.cfg, wb, x, d, c, lnet.cfg, detach)
    assert [a.shape for a in got] == [r.shape for r in ref]
    for i, (a, r) in enumerate(zip(got, ref)):
        torch.testing.assert_close(a, r, rtol=0,
                                   atol=1e-5 * float(r.abs().max()),
                                   msg=str(i))
    n_light = 2 * render_core.n_layers(lnet.cfg)
    assert all(float(a.abs().max()) > 0 for a in got[-n_light:])
    base = [t for grp in emulate_bwd(
        net.cfg, rnet.cfg, render_core.CoreWeights.of(net, rnet), x, d,
        c[:, :7].contiguous(), rnd=lambda t: t, grad=g) for t in grp]
    same = all(torch.equal(a, b) for a, b in zip(got[:-n_light], base))
    assert same == detach


@pytest.mark.parametrize("detach", [True, False], ids=["detached",
                                                       "coupled"])
def test_k4_light_idr_replay_with_its_rounding_meets_the_kernel_tolerance(
        detach):
    """At the light config's widths and depths with the idr radiance net
    (289 inputs), the kernel's bf16 rounding, K3's replayed gradient and a
    loss's cotangents (the light term included): the JAX package's
    gradient tolerance for its bf16 kernel against the plain f32
    backward."""
    from test_torch_kernel_layout import emulate_render_core
    net, rnet, lnet = light_layout("light", mode="idr")
    n, eik = 1024, 256
    x, d = points(n, 6, eik)
    w = render_core.CoreWeights.of(net, rnet, lnet)
    outs = render_core.render_core_train_plain(net.cfg, rnet.cfg, w, x, d,
                                               lnet.cfg, detach)
    c = eik_only(loss_cotangents(*outs[:3], lmask=outs[3]), eik)
    st, _ = k4_pack(net.cfg, rnet.cfg, w, lnet.cfg)
    assert st.idr and st.n_light and int(st.rad.plan[0, 0]) == 304  # 289
    g3 = emulate_render_core(st, x, d)[1]
    got = [t for grp in emulate_bwd(net.cfg, rnet.cfg, w, x, d, c,
                                    detach_light=detach, lcfg=lnet.cfg,
                                    grad=g3) for t in grp]
    grad_check(got, plain_vjp(net.cfg, rnet.cfg, w, x, d, c, lnet.cfg,
                              detach))


def test_bwd_plan_with_the_light_head_and_idr():
    """K4's plan with the light head beside idr is the light head's plan
    (regions, ring table, jobs) but for radiance layer 0's depth (the 289
    rows in five chunks): idr adds no ring item, region or staging; its
    `wgr` is radiance layer 0's gradient rows in bf16."""
    plans = {}
    for mode in ("nerf", "idr"):
        net, rnet, lnet = light_layout("light", mode=mode)
        w = render_core.CoreWeights.of(net, rnet, lnet)
        st, t = k4_pack(net.cfg, rnet.cfg, w, lnet.cfg)
        plans[mode] = [(st, t, render_core.K4Plan(st, t, 160_000, coupled),
                        w) for coupled in (False, True)]
    for (sn, tn, pn, _), (si, ti, pi, wi) in zip(plans["nerf"],
                                                 plans["idr"]):
        _check_plan(pi, si, ti)
        assert (si.idr, si.n_light) == (True, 2) and ti.n_light == 2
        assert np.array_equal(pi.script, pn.script)
        assert pi.scratch_bytes == pn.scratch_bytes
        assert [r for r in pi.regions] == [r for r in pn.regions]
        ns = ti.n_sdf
        assert pi.dims == [d if p != ns else (int(si.rad.plan[0, 0]), 256)
                           for p, d in enumerate(pn.dims)]
        assert torch.equal(ti.wgr, bf(wi.ws_rad[0].detach()[30:33]))


def test_train_op_on_cpu_is_the_plain_version_clamped():
    net, rnet = nets(*CASES["narrow"])
    icfg = mlp.ImplicitNetConfig(**{**net.cfg.__dict__,
                                    "sdf_bounding_sphere": 1.0})
    x, d = points(50, 7)
    x[:10] *= 4.0  # outside the sphere
    w = render_core.CoreWeights.of(net, rnet)
    sdf, grad, rgb = render_core.render_core_train(icfg, rnet.cfg, w, x, d)
    s0, g0, r0 = render_core.render_core_train_plain(icfg, rnet.cfg, w, x, d)
    sphere = 1.0 - torch.linalg.norm(x, dim=-1, keepdim=True)
    torch.testing.assert_close(sdf, torch.minimum(s0, sphere))
    take = (sphere < s0)[:, 0]
    assert take[:10].all()
    torch.testing.assert_close(grad[take], -x[take] / torch.linalg.norm(
        x[take], dim=-1, keepdim=True))
    torch.testing.assert_close(grad[~take], g0[~take])
    torch.testing.assert_close(rgb, r0)
    with pytest.raises(ValueError):
        render_core.render_core_bwd(None, None, x, d, torch.zeros(50, 8))
