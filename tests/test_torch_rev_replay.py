"""K5 (`csrc/rev_fwd.cu`) and K6 (`csrc/rev_bwd.cu`) replayed in torch from
exactly what their wrappers hand the kernels (K5: the packed bf16 weights
and plan rows of `RevLayout`; K6: `RevStages`' stage images and the ring
table, regions and jobs of its `K4Plan`), and held to the plain version
`rev_plain`.

K5's replay reuses K3's (`test_torch_kernel_layout.py`), since K5 is K3's
mma.sync body without the radiance net; K6's (`RevReplay`, in
`i2sdf_tpu_torch/ops/kernels/replay.py`) is K4's (`K4Replay`: the tile,
the ring's slots, the table consumed item by item, the scratch regions,
the MN-major products) with what is K6's own: the forward recompute stops at the output layer's
input, and the output layer's cotangent is `c_out`, read in the net's
column order [sdf | features] into the kernel's [features | sdf], its
bias row summed from it in f32. `rnd` says where the kernels round to
bf16:

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
from i2sdf_tpu_torch.ops.kernels.replay import bf, emulate_rev_bwd
from test_torch_bwd_replay import grad_check
from test_torch_kernel_layout import replay_grad_sweep, run_sdf_chain


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


def layout(net):
    ws, bs = flat_weights(net)
    with torch.no_grad():
        return rev.RevLayout(net.cfg, ws, bs)


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


def emulate_rev_fwd(k: rev.RevLayout, x, rnd=bf):
    """`csrc/rev_fwd.cu` in torch: (out, grad) as the wrapper returns."""
    dact = []
    bufs, cur, z = run_sdf_chain(k.fwd, x, k.mx, k.lda, dact, rnd)
    grad = replay_grad_sweep(k, bufs, cur ^ 1, dact, x, rnd)
    return z[:, :k.out_cols], grad


def stages(net):
    ws, bs = flat_weights(net)
    return rev.RevStages(net.cfg, ws, bs)


@pytest.mark.parametrize("case,n", [("narrow", 1), ("narrow", 33),
                                    ("narrow", 129), ("flagship", 96)])
def test_rev_replay_in_f32_equals_plain(case, n):
    net = sdf_net(**(FLAGSHIP if case == "flagship" else NARROW))
    x = eikonal_points(n, n)
    k = layout(net)
    ws, bs = bf16_leaves(*flat_weights(net))
    out_ref, grad_ref = rev.rev_plain(net.cfg, ws, bs, x)
    c_out, c_g = loss_cotangents(out_ref, grad_ref, seed=n)
    out, grad = emulate_rev_fwd(k, x, rnd=lambda t: t)
    for name, g, r in (("out", out, out_ref), ("grad", grad, grad_ref)):
        torch.testing.assert_close(g, r.detach(), rtol=0,
                                   atol=1e-5 * float(r.detach().abs().max()),
                                   msg=name)
    got = [t for grp in emulate_rev_bwd(stages(net), x, c_out, c_g,
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
    k = layout(net)
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
    got = [t for grp in emulate_rev_bwd(stages(net), x, c_out, c_g)
           for t in grp]
    grad_check(got, plain_vjp(net.cfg, ws, bs, x, c_out, c_g))


def test_rev_layout_and_plan():
    """K5's pack in the net's own column order within the card's 227 KB;
    K6's pack (`RevStages`) the same bits as packing its layers stage by
    stage, and its plan K4's without radiance or light items: the
    forward's weight stages stop at the last hidden layer, the stash
    comes back as K4's does, one weight gradient a layer."""
    from test_torch_bwd_replay import _check_plan
    net = sdf_net(**FLAGSHIP)
    k = layout(net)
    assert k.out_cols == 257 and k.n_sdf == 9 and k.rev.n_layers == 8
    W_last = net.layers()[-1].weight().detach()
    torch.testing.assert_close(
        k.wsdf_col[:256], W_last[:, 0].to(torch.bfloat16).float())
    assert rev.fwd_smem(k) <= 232448
    ws, bs = flat_weights(net)
    k6 = stages(net)
    with torch.no_grad():
        wd, bd = [w.detach() for w in ws], [b.detach() for b in bs]
        for got, want in (
                (k6.sdf, mma_pack.pack_stage_chain(
                    render_core.core_sdf_layers(net.cfg, wd, bd))),
                (k6.t, mma_pack.pack_stage_chain(
                    render_core.t_sdf_layers(net.cfg, wd)))):
            assert torch.equal(got.weights, want.weights)
            assert torch.equal(got.biases, want.biases)
            assert (got.plan == want.plan).all()
    torch.testing.assert_close(k6.wsdf[:256],
                               W_last[:, 0].to(torch.bfloat16).float())
    assert not k6.wsdf[256:].any()
    ns = k6.n_sdf
    assert (ns, k6.sdf.n_layers, k6.tsdf.shape[0]) == (9, 10, 8)
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
    k, k6 = layout(net), stages(net)
    for call in (lambda: rev.rev_fwd(k, x),
                 lambda: rev.rev_bwd(k6, x, torch.zeros(60, 17),
                                     torch.zeros(60, 3))):
        with pytest.raises(ValueError):
            call()
