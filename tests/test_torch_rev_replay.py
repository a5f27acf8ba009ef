"""K5 (`csrc/rev_fwd.cu`) and K6 (`csrc/rev_bwd.cu`) replayed in torch from
exactly what their wrappers hand the kernels (the packed bf16 weights and
plan rows of `RevLayout`, K6's `_BwdPlan` scratch table; K6 has no radiance
layers), and held to the plain version `rev_plain`.

The replays reuse K3's and K4's (`test_torch_kernel_layout.py`,
`test_torch_bwd_replay.py`), since K5 and K6 are K3's and K4's kernel
bodies without the radiance net (csrc/common.cuh); what is K5's and K6's
own is replayed here: the
output layer in the net's column order [sdf | features], K5's output
rows, and K6's output-layer cotangent read from `c_out`. `rnd` says
where the kernels round to bf16:

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
from i2sdf_tpu_torch.ops.kernels import render_core, rev
from i2sdf_tpu_torch.models.embedder import positional_encoding
from i2sdf_tpu_torch.ops import kernels  # noqa: F401
from i2sdf_tpu_torch.ops.activations import softplus_beta
from i2sdf_tpu_torch.ops.kernels import mma_pack
from test_torch_bwd_replay import INV_SQRT2, grad_check, pad_rows, pe_cols
from test_torch_kernel_layout import (bf, replay_grad_sweep, run_sdf_chain,
                                      unpack)

# ---- the mma.sync backward's sweeps (K6's body in csrc/common.cuh) -------

def stash_q(z, rnd):
    """`stash_q` (csrc/common.cuh), rounded."""
    t = 100 * z
    q = 1 / (1 + torch.exp(t.abs()))
    v = torch.where(t > 0, -q, q)
    return rnd(torch.where(t > 20, torch.full_like(z, -0.0), v))


def stash_s(v):
    return torch.where(torch.signbit(v), 1 + v, v)


def stash_d2(v):
    return 100 * v.abs() * (1 - v.abs())


def _block_rows_sum(t, rows=32):
    return t.reshape(-1, rows, t.shape[1]).sum(1)


class ReplayScratch:
    """The backward's two scratch buffers at a `_BwdPlan` (bf16 values
    held as f32), every element NaN at first, so a region the
    weight-gradient products read but the sweep never wrote shows up."""

    def __init__(self, plan, dev):
        self.plan = plan
        self.ws16 = torch.full((plan.n16,), float("nan"), device=dev)
        self.ws32 = torch.full((plan.n32,), float("nan"), device=dev)
        self.dbp = self.v32(plan.dbpart, plan.blocks, plan.tb)

    def v16(self, off, rows, cols):
        return self.ws16[off:off + rows * cols].view(rows, cols)

    def v32(self, off, rows, cols):
        return self.ws32[off:off + rows * cols].view(rows, cols)

    def put_db(self, off, dz):
        self.dbp[:, off:off + dz.shape[1]] = _block_rows_sum(dz)


def _pad_cols(t, cols):
    out = t.new_zeros((t.shape[0], max(cols, t.shape[1])))
    out[:, :t.shape[1]] = t
    return out


def replay_sdf_forward(k, sc: ReplayScratch, xs, rnd, last=True):
    """Step 1 of K6's `bwd_sweep_kernel` (csrc/common.cuh), the forward
    recompute with the q stash: X_l to rows [np, 2 np) of ax[l]; returns
    the stashes q_l and, with `last`, the output layer's accumulator."""
    plan, P = sc.plan, sc.plan.np
    h = rnd(pe_cols(xs, k.mx, int(k.fwd.plan[0, 0])))
    qs, z = [], None
    for l in range(k.n_sdf):
        K, N, real, flags, col, W, b = unpack(k.fwd, l)
        if flags & mma_pack.SKIP_IN:
            h = torch.cat([h[:, :col], rnd(pe_cols(xs, k.mx, K - col)
                                            * INV_SQRT2)], 1)
        sc.v16(plan.ax[l], 2 * P, K)[P:] = h[:, :K]
        if l < k.n_sdf - 1:
            z = h[:, :K] @ W + b
            scale = INV_SQRT2 if flags & mma_pack.SCALE else 1.0
            h = rnd(softplus_beta(z) * scale)
            qs.append(stash_q(z, rnd))
        elif last:
            z = h[:, :K] @ W + b
    return qs, z


def replay_sdf_backward(k, sc: ReplayScratch, xs, cs, qs, sdf_col, rnd):
    """Steps 4-7 of K6's `bwd_sweep_kernel` (csrc/common.cuh: the reverse,
    upward and downward sweeps), once the output layer's dz is in rows
    [np, 2 np) of br[n-1] with its bias row, then the split-K products and
    the fixed-order sums (`launch_wgrad`).
    cs: (np, 8) cotangents, c_grad in columns 0..2. Returns the kernel's
    flat output."""
    plan, P, ns = sc.plan, sc.plan.np, k.n_sdf
    dev = xs.device
    Ks = [int(v) for v in k.fwd.plan[:, 0]]
    Ns = [int(v) for v in k.fwd.plan[:, 1]]
    v16, v32 = sc.v16, sc.v32
    # 4. reverse sweep
    r1 = xs.new_zeros((P, Ns[-1]))
    r1[:, sdf_col] = 1.0
    v16(plan.br[ns - 1], 2 * P, Ns[-1])[:P] = r1
    K = Ks[-1]
    ah = k.wsdf_col[:K].expand(P, K)
    v32(plan.ah[ns - 1], P, K)[:] = ah
    r = rnd(ah * stash_s(qs[ns - 2][:, :K]))
    v16(plan.br[ns - 2], 2 * P, Ns[ns - 2])[:P] = r
    for l in range(ns - 2, 0, -1):
        K, N, n_h, flags, _, W, _ = unpack(k.sdft, ns - 1 - l)
        scale = INV_SQRT2 if flags & mma_pack.SCALE else 1.0
        hid = torch.arange(N, device=dev) < n_h
        a = torch.where(hid, (r[:, :K] @ W) * scale, xs.new_zeros(()))
        v32(plan.ah[l], P, N)[:] = a
        s_prev = xs.new_zeros((P, N))
        s_prev[:, :n_h] = stash_s(qs[l - 1][:, :n_h])
        r = rnd(a * s_prev)
        v16(plan.br[l - 1], 2 * P, Ns[l - 1])[:P] = r[:, :Ns[l - 1]]
    # 5. dg_emb, closed form
    f = 2.0 ** torch.arange(k.mx, dtype=torch.float32, device=dev)
    xf = xs[:, :, None] * f
    cg = cs[:, :3, None]
    dge = torch.cat([cs[:, :3],
                     (cg * f * torch.cos(xf)).reshape(P, -1),
                     (-cg * f * torch.sin(xf)).reshape(P, -1)], 1)
    # 6. upward sweep
    da = rnd(_pad_cols(dge, Ks[0]))
    v16(plan.ax[0], 2 * P, Ks[0])[:P] = da
    for l in range(ns - 1):
        K, N, n_h, flags, _, W, _ = unpack(k.fwd, l)
        scale = INV_SQRT2 if flags & mma_pack.SCALE else 1.0
        dr = da[:, :K] @ W
        hid = torch.arange(N, device=dev) < n_h
        q = qs[l][:, :N]
        ahn = v32(plan.ah[l + 1], P, Ks[l + 1])[:, :N]
        dzx = torch.where(hid, dr * ahn * stash_d2(q), xs.new_zeros(()))
        v16(plan.dzx[l], P, N)[:] = rnd(dzx)
        nxt = xs.new_zeros((P, Ks[l + 1]))
        nxt[:, :N] = rnd(torch.where(hid, dr * stash_s(q) * scale,
                                    xs.new_zeros(())))
        _, _, _, flags1, col1, _, _ = unpack(k.fwd, l + 1)
        if flags1 & mma_pack.SKIP_IN:
            w1 = Ks[l + 1] - col1
            nxt[:, col1:] = rnd(_pad_cols(dge * INV_SQRT2, w1)[:, :w1])
        v16(plan.ax[l + 1], 2 * P, Ks[l + 1])[:P] = nxt
        da = nxt
    # 7. downward sweep
    a = v16(plan.br[ns - 1], 2 * P, Ns[-1])[P:].clone()
    for l in range(ns - 1, 0, -1):
        K, N, n_h, flags, _, W, _ = unpack(k.sdft, ns - 1 - l)
        scale = INV_SQRT2 if flags & mma_pack.SCALE else 1.0
        v = (a[:, :K] @ W)[:, :Ns[l - 1]] * scale
        hid = torch.arange(Ns[l - 1], device=dev) < n_h
        s_prev = stash_s(qs[l - 1][:, :Ns[l - 1]])
        dzx = v16(plan.dzx[l - 1], P, Ns[l - 1])
        dz = torch.where(hid, v * s_prev + dzx, xs.new_zeros(()))
        sc.put_db(plan.db[l - 1], dz)
        a = rnd(dz)
        v16(plan.br[l - 1], 2 * P, Ns[l - 1])[P:] = a
    # weight-gradient products, split over point ranges, then fixed-order sums
    out = torch.full((plan.n_out,), float("nan"), device=dev)
    for p, (K, N) in enumerate(plan.dims):
        M = 2 * P
        A, B = v16(plan.ax[p], M, K), v16(plan.br[p], M, N)
        assert not (torch.isnan(A).any() or torch.isnan(B).any()), p
        parts = v32(plan.part[p], plan.splits[p], K * N)
        for s in range(plan.splits[p]):
            rows = slice(s * plan.chunk[p], min(M, (s + 1) * plan.chunk[p]))
            parts[s] = (A[rows].T @ B[rows]).reshape(-1)
        out[plan.out[p]:plan.out[p] + K * N] = parts.sum(0)
    assert not torch.isnan(sc.dbp).any()
    out[plan.out_db:] = sc.dbp.sum(0)
    return out


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


def emulate_rev_bwd(k: rev.RevLayout, x, c_out, c_g, rnd=bf):
    """`csrc/rev_bwd.cu` in torch: (dws, dbs) as the wrapper returns."""
    plan = render_core._BwdPlan(k, x.shape[0])
    P, ns = plan.np, k.n_sdf
    sc = ReplayScratch(plan, x.device)
    xs, cs = pad_rows(x, P), pad_rows(c_g, P, 8)
    qs, _ = replay_sdf_forward(k, sc, xs, rnd, last=False)
    # the output layer's dz is c_out, in the net's column order
    n_last = int(k.fwd.plan[-1, 1])
    cy = pad_rows(c_out, P, n_last)
    sc.put_db(plan.db[ns - 1], cy)
    sc.v16(plan.br[ns - 1], 2 * P, n_last)[P:] = rnd(cy)
    out = replay_sdf_backward(k, sc, xs, cs, qs, 0, rnd)
    return rev.unpack_grads(k.shapes, out, plan)


@pytest.mark.parametrize("case,n", [("narrow", 1), ("narrow", 33),
                                    ("flagship", 96)])
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
    got = [t for grp in emulate_rev_bwd(k, x, c_out, c_g, rnd=lambda t: t)
           for t in grp]
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
    got = [t for grp in emulate_rev_bwd(k, x, c_out, c_g) for t in grp]
    grad_check(got, plain_vjp(net.cfg, ws, bs, x, c_out, c_g))


def test_rev_layout_and_plan():
    """The net's own column order, K6's table without radiance layers,
    every array 16-byte aligned and disjoint, and the shared memory both
    kernels ask for within the card's 227 KB."""
    net = sdf_net(**FLAGSHIP)
    k = layout(net)
    assert k.out_cols == 257 and k.n_sdf == 9 and k.rev.n_layers == 8
    W_last = net.layers()[-1].weight().detach()
    torch.testing.assert_close(
        k.wsdf_col[:256], W_last[:, 0].to(torch.bfloat16).float())
    assert max(rev.fwd_smem(k), render_core.bwd_smem(k)) <= 232448
    plan = render_core._BwdPlan(k, 4800)
    ns = k.n_sdf
    assert plan.np == 4800 and plan.dims == [
        (int(K), int(N)) for K, N in k.fwd.plan[:, :2]]
    assert len(plan.table) == 4 * ns + 2 + 5 * ns + 1
    assert plan.tb == sum(N for _, N in plan.dims)
    spans = []
    for l, (K, N) in enumerate(plan.dims):
        spans += [(plan.ax[l], 2 * plan.np * K), (plan.br[l], 2 * plan.np * N)]
        if l < ns - 1:
            spans.append((plan.dzx[l], plan.np * N))
    spans.sort()
    for (o1, s1), (o2, _) in zip(spans, spans[1:]):
        assert o1 % 8 == 0 and o1 + s1 <= o2
    for s, c in zip(plan.splits, plan.chunk):
        assert c % 32 == 0 and (s - 1) * c < 2 * plan.np <= s * c


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
    k = layout(net)
    for call in (lambda: rev.rev_fwd(k, x),
                 lambda: rev.rev_bwd(k, x, torch.zeros(60, 17),
                                     torch.zeros(60, 3))):
        with pytest.raises(ValueError):
            call()
