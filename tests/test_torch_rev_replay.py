"""K5 (`csrc/rev_fwd.cu`) and K6 (`csrc/rev_bwd.cu`) replayed in torch from
exactly what their wrappers hand the kernels (both: `RevStages`' stage
images; K5 the ring table and regions of its `K5Plan`, K6 the ring table,
regions and jobs of its `K4Plan`), and held to the plain version
`rev_plain`.

Both replays live in `i2sdf_tpu_torch/ops/kernels/replay.py` and are
K4's (`K4Replay`: the tile, the ring's slots, the table consumed item by
item, the scratch regions, the MN-major products) with what is each
kernel's own. K6 (`RevReplay`): the forward recompute stops at the
output layer's input, and the output layer's cotangent is `c_out`, read
in the net's column order [sdf | features] into the kernel's [features |
sdf], its bias row summed from it in f32. K5 (`K5Replay`): the same
forward without the operand stores, the output layer's two products
written in the net's order, and the reverse sweep down to layer 0 with
the encoding's share gathered in f32. `rnd` says where the kernels round
to bf16:

* with no rounding the replay is the kernels' algorithm in f32 on their
  bf16 weights, and it must equal `rev_plain` on the same bf16-rounded
  weights to f32 rounding (1e-5 of each output's or each leaf's largest
  entry): a wrong offset, width, flag, column order or sweep fails this;
* with the kernels' rounding it is held to `rev_plain` on the f32
  weights: the outputs with the JAX package's kernel tolerances
  (`tests/test_pallas_rev.py`: sdf 0.02, features 0.05, grad 0.05 / rtol
  0.08), the gradients with its bound for bf16 kernel gradients (per
  leaf max|d|/max|ref| < 0.1, cosine > 0.999), with the cotangents of a
  loss that reads the sdf, the features and the gradient, so `c_out`
  and `c_g` are both non-zero.

The eikonal points are drawn as the training step draws them: a third
uniform in the scene's cube [-4, 4]^3 (where the encoding's top
frequency turns the sin arguments past 100), a third near the surface
and its jittered neighbours. The module imports no JAX, so the card
tests (`test_torch_gpu_kernels.py`) reuse the replay on CUDA tensors.
"""

import numpy as np
import pytest
import torch

from i2sdf_tpu_torch.models import mlp
from i2sdf_tpu_torch.ops import kernels  # noqa: F401
from i2sdf_tpu_torch.ops.kernels import mma_pack, render_core, rev
from i2sdf_tpu_torch.ops.kernels.replay import (K5Replay, RevReplay,
                                                act_off, bf,
                                                emulate_rev_bwd,
                                                emulate_rev_fwd, f32_idx,
                                                pe_cols, stash_q)
from test_torch_bwd_replay import grad_check


FLAGSHIP = dict(width=256, depth=8, skip=4, feat=256, mx=6)
NARROW = dict(width=64, depth=4, skip=2, feat=16, mx=4)
SPHERE = 4.0  # configs/synthetic_quality.yml's scene_bounding_sphere


def sdf_net(width, depth, skip, feat, mx, seed=0, sphere=0.0, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    cfg = mlp.ImplicitNetConfig(
        feature_vector_size=feat, sdf_bounding_sphere=sphere,
        dims=(width,) * depth, skip_in=(skip,), bias=0.6,
        embed_type="positional", multires=mx)
    net = mlp.ImplicitNet(cfg, gen)
    with torch.no_grad():  # move off the init's zero PE weights
        for lin in net.layers():
            lin.v.add_(0.01 * torch.randn(lin.v.shape, generator=gen))
    return net.to(device)


def eikonal_points(n, seed, device="cpu"):
    """n points as the step's eikonal batch: uniform in the cube, near a
    surface (a sphere of radius 1 here), and jittered neighbours of the
    near points (within 0.005)."""
    rng = np.random.default_rng(seed)
    a = n // 3
    b = (n - a + 1) // 2
    uni = rng.uniform(-SPHERE, SPHERE, (a, 3))
    d = rng.normal(size=(b, 3))
    near = d / np.linalg.norm(d, axis=-1, keepdims=True) * rng.uniform(
        0.95, 1.05, (b, 1))
    jit = near[:n - a - b] + rng.uniform(-0.005, 0.005, (n - a - b, 3))
    pts = np.concatenate([uni, near, jit]).astype(np.float32)
    return torch.from_numpy(pts).to(device)


def flat_weights(net):
    lins = net.layers()
    return [l.weight() for l in lins], [l.b for l in lins]


def bf16_leaves(ws, bs):
    """The weights rounded to bf16 as the kernels' packs hold them (biases
    stay f32), as fresh leaves."""
    return ([w.detach().to(torch.bfloat16).float().requires_grad_(True)
             for w in ws],
            [b.detach().clone().requires_grad_(True) for b in bs])


def loss_cotangents(out, grad, seed=0):
    """(c_out, c_g) of the JAX package's rev-kernel test loss
    (`tests/test_pallas_rev.py::_loss_terms`: sdf^2, 0.1 features^2, the
    normal L1 against seeded targets and the eikonal term) at these
    outputs."""
    gen = torch.Generator().manual_seed(seed)
    gn = torch.nn.functional.normalize(
        torch.randn((out.shape[0], 3), generator=gen), dim=-1).to(out.device)
    o, g = (t.detach().requires_grad_(True) for t in (out, grad))
    with torch.enable_grad():
        nrm = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True),
                              min=1e-9)
        loss = ((o[:, :1] ** 2).mean() + 0.1 * (o[:, 1:] ** 2).mean()
                + 0.5 * (1 - (nrm * gn).sum(-1)).abs().mean()
                + 0.1 * ((torch.linalg.norm(g, dim=-1) - 1) ** 2).mean())
        return torch.autograd.grad(loss, (o, g))


def plain_vjp(cfg, ws, bs, x, c_out, c_g):
    out, grad = rev.rev_plain(cfg, ws, bs, x)
    return list(torch.autograd.grad((out, grad), ws + bs, (c_out, c_g)))


def stages(net):
    ws, bs = flat_weights(net)
    with torch.no_grad():
        return rev.RevStages(net.cfg, ws, bs)


@pytest.mark.parametrize("case,n", [("narrow", 1), ("narrow", 33),
                                    ("narrow", 129), ("flagship", 96)])
def test_rev_replay_in_f32_equals_plain(case, n):
    net = sdf_net(**(FLAGSHIP if case == "flagship" else NARROW))
    x = eikonal_points(n, n)
    k = stages(net)
    ws, bs = bf16_leaves(*flat_weights(net))
    out_ref, grad_ref = rev.rev_plain(net.cfg, ws, bs, x)
    c_out, c_g = loss_cotangents(out_ref, grad_ref, seed=n)
    out, grad = emulate_rev_fwd(k, x, rnd=lambda t: t)
    for name, g, r in (("out", out, out_ref), ("grad", grad, grad_ref)):
        torch.testing.assert_close(g, r.detach(), rtol=0,
                                   atol=1e-5 * float(r.detach().abs().max()),
                                   msg=name)
    got = [t for grp in emulate_rev_bwd(k, x, c_out, c_g,
                                        rnd=lambda t: t) for t in grp]
    ref = plain_vjp(net.cfg, ws, bs, x, c_out, c_g)
    assert [g.shape for g in got] == [r.shape for r in ref]
    for i, (g, r) in enumerate(zip(got, ref)):
        torch.testing.assert_close(g, r, rtol=0,
                                   atol=1e-5 * float(r.abs().max()),
                                   msg=str(i))


def test_rev_replay_with_its_rounding_meets_the_kernel_tolerance():
    net = sdf_net(**FLAGSHIP)
    x = eikonal_points(1024, 5)
    k = stages(net)
    ws, bs = flat_weights(net)
    out_ref, grad_ref = rev.rev_plain(net.cfg, ws, bs, x)
    out, grad = emulate_rev_fwd(k, x)
    torch.testing.assert_close(out[:, :1], out_ref[:, :1].detach(),
                               atol=0.02, rtol=0.02)
    torch.testing.assert_close(out[:, 1:], out_ref[:, 1:].detach(),
                               atol=0.05, rtol=0.05)
    torch.testing.assert_close(grad, grad_ref.detach(), atol=0.05, rtol=0.08)
    c_out, c_g = loss_cotangents(out_ref, grad_ref)
    assert c_out.abs().max() > 0 and c_g.abs().max() > 0
    got = [t for grp in emulate_rev_bwd(k, x, c_out, c_g) for t in grp]
    grad_check(got, plain_vjp(net.cfg, ws, bs, x, c_out, c_g))


def test_rev_layout_and_plan():
    """`RevStages`, K5's and K6's one pack: the same bits as packing its
    layers stage by stage (the transposed chain down to layer 0, K6's
    rows its first n-1). K6's plan is K4's without radiance or light
    items: the forward's weight stages stop at the last hidden layer, the
    stash comes back as K4's does, one weight gradient a layer. K5's plan
    (`K5Plan`) takes every stage of the forward chain (the hidden layers,
    layer 0's twice for the encoding's hi/lo pair, its K 64 more than the
    chain's, the sdf alone, the features) and of the transposed chain but
    its output layer's, stages and loads back one q tile a hidden layer
    after one wait, and stores nothing else; the sweeps' shared memory
    (`SweepCtx::kSmemBytes`, csrc/wgmma_sweep.cuh, with sdf_sweep.cuh's
    `kRest`) fits the card's 227 KB."""
    from test_torch_bwd_replay import _check_plan
    net = sdf_net(**FLAGSHIP)
    ws, bs = flat_weights(net)
    k6 = stages(net)
    with torch.no_grad():
        wd, bd = [w.detach() for w in ws], [b.detach() for b in bs]
        for got, want in (
                (k6.sdf, mma_pack.pack_stage_chain(
                    render_core.core_sdf_layers(net.cfg, wd, bd))),
                (k6.t, mma_pack.pack_stage_chain(
                    render_core.t_sdf_layers(net.cfg, wd, first=True)))):
            assert torch.equal(got.weights, want.weights)
            assert torch.equal(got.biases, want.biases)
            assert (got.plan == want.plan).all()
    W_last = net.layers()[-1].weight().detach()
    torch.testing.assert_close(k6.wsdf[:256],
                               W_last[:, 0].to(torch.bfloat16).float())
    assert not k6.wsdf[256:].any()
    ns = k6.n_sdf
    assert (ns, k6.sdf.n_layers, k6.t.n_layers) == (9, 10, 9)
    assert (k6.tsdf == k6.t.plan[:ns - 1]).all()
    assert list(k6.t.plan[ns - 1, [0, 1, 2, 5, 6]]) == [256, 64, 0, 0, 0]
    plan = rev.plan_for(k6, 4800)
    assert plan.blocks == 75 and plan is rev.plan_for(k6, 4800)
    _check_plan(plan, k6, k6)
    fwd = k6.sdf.plan
    chunks = lambda rows: sum(-(-int(K) // 64) for K in rows[:, 0])  # noqa
    assert sum(1 for it in plan.script if it[0] >> 8 and it[0] & 255 == 0) \
        == (chunks(fwd[:ns - 1]) + chunks(k6.tsdf[1:]) + chunks(fwd[:ns - 1])
            + chunks(k6.tsdf))
    assert {int(it[0]) >> 8 for it in plan.script} <= {
        render_core._B_SCRATCH, render_core._B_SDF, render_core._B_T}
    assert sum(1 for it in plan.script if it[0] == render_core._STAGE) == (
        (ns - 1) + 2 * (ns - 2) + (ns - 1))
    assert len(plan.jobs) == ns and plan.dims[ns - 1] == (256, 257)
    assert plan.tb == sum(N for _, N in plan.dims)
    # K5: the stash q in f32, two slots a hidden layer
    p5 = rev.k5_plan_for(k6, 4800)
    assert p5.blocks == 75 and p5 is rev.k5_plan_for(k6, 4800)
    kinds = [int(it[0]) & 255 for it in p5.script]
    bases = [int(it[0]) >> 8 for it in p5.script]
    loads = lambda base: sum(1 for k, b in zip(kinds, bases)  # noqa: E731
                             if k == render_core._LOAD and b == base)
    assert loads(render_core._B_SDF) == chunks(fwd) + chunks(fwd[:1])
    assert p5.fwd[0, 0] == fwd[0, 0] + 64 and (p5.fwd[0, 1:] == fwd[0, 1:]).all()
    assert (p5.fwd[1:] == fwd[1:]).all()
    sdf_items = [tuple(it) for it in p5.script
                 if it[0] == render_core._LOAD | render_core._B_SDF << 8]
    assert sdf_items[0] == sdf_items[1] == tuple(
        render_core.weight_items(render_core._B_SDF, fwd[0])[0])
    assert loads(render_core._B_T) == chunks(k6.t.plan[1:])
    assert loads(render_core._B_SCRATCH) == 2 * (ns - 1)
    assert kinds.count(render_core._STAGE) == 2 * (ns - 1)
    assert kinds.count(render_core._WAIT) == 1
    first_q = next(i for i, (k, b) in enumerate(zip(kinds, bases))
                   if k == render_core._LOAD and b == render_core._B_SCRATCH)
    assert kinds.index(render_core._WAIT) + 1 == first_q
    assert p5.scratch_bytes == 75 * (ns - 1) * 2 * 32768
    used = [(kind, l) for kind, rows in enumerate(p5.regions)
            for l, (_, stride) in enumerate(rows) if stride]
    assert used == [(render_core.REG_Q, l) for l in range(ns - 1)]
    # 1024 (alignment) + T (5 chunks) + the ring (5 slots, 10 barriers) +
    # 16 + (kRest = 64 x (3 + kPeStride) + 4 x 320 column sums) floats
    assert 1024 + 5 * 8192 + 5 * 32768 + 80 + 16 + 4 * (
        64 * (3 + 65) + 4 * 320) <= 232448


def test_k5_replay_runs_k6s_forward():
    """K5's forward is K6's but for layer 0, which K5 takes on the
    encoding's hi/lo pair: with the low half's product left out
    (`pe_lo`), K5's replayed hidden activations are bit-equal to those
    `RevReplay` recomputes for K6 from the same pack and its f32 stash q
    rounds to K6's bf16 one; with it, layer 0's stash is nearer the one
    of the f32 encoding on the same bf16 weights."""
    net = sdf_net(**NARROW)
    x = eikonal_points(70, 3)
    k = stages(net)
    c_out, c_g = torch.randn((70, 17)), torch.randn((70, 3))
    with torch.no_grad():
        r5 = K5Replay(k, rev.K5Plan(k, 70), x, bf)
        r5.pe_lo = False
        r5lo = K5Replay(k, rev.K5Plan(k, 70), x, bf)
        r6 = RevReplay(k, render_core.K4Plan(k, k, 70, False), x, c_out,
                       c_g, bf)
        for r in (r5, r5lo, r6):
            r.hidden = []
            r.run()
    assert len(r5.hidden) == len(r6.hidden) == k.n_sdf - 1
    for a, b in zip(r5.hidden, r6.hidden):
        assert torch.equal(a, b)
    assert not torch.equal(r5lo.hidden[0], r5.hidden[0])
    fwd = k.sdf.plan
    rows = torch.arange(64)[:, None]

    def q_of(r, l, f32=True):
        cols = torch.arange(int(fwd[l, 1]))[None, :]
        idx = f32_idx(rows, cols) if f32 else act_off(rows, cols) // 2
        return r.scr[r.plan.regions[render_core.REG_Q][l][0]][:, idx.flatten()]

    for l in range(k.n_sdf - 1):
        assert torch.equal(bf(q_of(r5, l)), q_of(r6, l, f32=False))
    w0, b0 = (t.detach() for t in (net.layers()[0].weight(),
                                    net.layers()[0].b))
    q0 = stash_q(pe_cols(x, k.mx, w0.shape[0]) @ bf(w0) + b0)
    err = [float((q_of(r, 0).view(-1, int(fwd[0, 1]))[:70] - q0).abs()
                 .mean()) for r in (r5, r5lo)]
    assert err[1] < 0.25 * err[0], err


def test_k5_replay_matches_pallas_interpret():
    """K5's bf16 replay against the JAX package's rev forward
    (`get_rev_op`'s `pallas_call` in interpret mode) on the same weights
    and points (the narrow net, `test_torch_parity_rev.SMALL`'s shapes),
    at `tests/test_torch_parity_rev.py`'s tolerances (sdf 0.02, features
    0.05, grad 0.05 / rtol 0.08)."""
    import jax.numpy as jnp
    from i2sdf_tpu.ops.pallas.fused_rev import get_rev_op
    from test_torch_parity_rev import SMALL
    net = sdf_net(**NARROW)
    x = eikonal_points(96, 11)
    ws, bs = (tuple(jnp.asarray(t.detach().numpy()) for t in ts)
              for ts in flat_weights(net))
    out_k, grad_k = get_rev_op(SMALL, 96, True)(ws, bs, jnp.asarray(
        x.numpy()))
    out, grad = emulate_rev_fwd(stages(net), x)
    for name, a, b, (atol, rtol) in (
            ("sdf", out[:, :1], np.asarray(out_k)[:, :1], (0.02, 0.02)),
            ("feat", out[:, 1:], np.asarray(out_k)[:, 1:], (0.05, 0.05)),
            ("grad", grad, np.asarray(grad_k), (0.05, 0.08))):
        np.testing.assert_allclose(a.numpy(), b, atol=atol, rtol=rtol,
                                   err_msg=name)


def test_rev_op_on_cpu_is_the_plain_version_clamped():
    net = sdf_net(**NARROW, sphere=1.0)
    x = eikonal_points(60, 9)
    x[20:] *= 0.2  # inside the sphere, where the net's sdf is below it
    sdf, feat, grad = rev.sdf_outputs_rev(net, x)
    out, g0 = rev.rev_plain(net.cfg, *flat_weights(net), x)
    sphere = 1.0 - torch.linalg.norm(x, dim=-1, keepdim=True)
    torch.testing.assert_close(sdf, torch.minimum(out[:, :1], sphere))
    torch.testing.assert_close(feat, out[:, 1:])
    take = (sphere < out[:, :1])[:, 0]
    assert take.any() and (~take).any()
    torch.testing.assert_close(grad[take], -x[take] / torch.linalg.norm(
        x[take], dim=-1, keepdim=True))
    torch.testing.assert_close(grad[~take], g0[~take])
    k = stages(net)
    for call in (lambda: rev.rev_fwd(k, x),
                 lambda: rev.rev_bwd(k, x, torch.zeros(60, 17),
                                     torch.zeros(60, 3))):
        with pytest.raises(ValueError):
            call()


NO_PE = mlp.ImplicitNetConfig(feature_vector_size=8, sdf_bounding_sphere=1.5,
                              dims=(32, 32), geometric_init=False)


@pytest.mark.parametrize("case", ["narrow", "no_pe"])
def test_k12_pack_and_plan_are_k6s(case):
    """K12 (`sdf_grad.sdf_grad_bwd`) launches K6 on K6's pack and plan:
    `sdf_grad.bwd_stages` is `RevStages`, the same bits as K6's own pack
    of the net (with no encoding, which K6's own pack refuses, the same
    bits as packing its layers stage by stage, at frequency count 0), and
    its plan is K6's (`rev.plan_for`). K6's replay on it with no rounding
    is the plain op's VJP on the pack's bf16 weights, to f32 rounding."""
    from i2sdf_tpu_torch.ops.kernels import sdf_grad
    if case == "no_pe":
        net = mlp.ImplicitNet(NO_PE, torch.Generator().manual_seed(0))
    else:
        net = sdf_net(**NARROW)
    ws, bs = flat_weights(net)
    with torch.no_grad():
        kr = sdf_grad.bwd_stages(net.cfg, ws, bs)
        if case == "no_pe":
            with pytest.raises(ValueError):
                rev.RevStages(net.cfg, ws, bs)
            w = [t.detach().float() for t in ws]
            b = [t.detach().float() for t in bs]
            want = [mma_pack.pack_stage_chain(layers) for layers in (
                render_core.core_sdf_layers(net.cfg, w, b, embed_none=True),
                render_core.t_sdf_layers(net.cfg, w, first=True))]
            assert kr.mx == 0
        else:
            k6 = rev.RevStages(net.cfg, ws, bs)
            want = [k6.sdf, k6.t]
            assert torch.equal(kr.wsdf, k6.wsdf) and kr.mx == k6.mx
            assert rev.plan_for(kr, 70) is rev.plan_for(k6, 70)
    for got, ref in zip((kr.sdf, kr.t), want):
        assert torch.equal(got.weights.view(torch.int16),
                           ref.weights.view(torch.int16))
        assert torch.equal(got.biases, ref.biases)
        assert np.array_equal(got.plan, ref.plan)
    x = eikonal_points(70, 70)
    wl, bl = bf16_leaves(ws, bs)
    out_ref, grad_ref = rev.rev_plain(net.cfg, wl, bl, x)
    c_out, c_g = loss_cotangents(out_ref, grad_ref, seed=70)
    got = [t for grp in emulate_rev_bwd(kr, x, c_out, c_g,
                                        rnd=lambda t: t) for t in grp]
    ref = plain_vjp(net.cfg, wl, bl, x, c_out, c_g)
    for i, (g, r) in enumerate(zip(got, ref)):
        torch.testing.assert_close(g, r, rtol=0,
                                   atol=1e-5 * float(r.abs().max()),
                                   msg=str(i))
