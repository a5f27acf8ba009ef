"""K4 (`csrc/render_core_bwd.cu`) replayed in torch from exactly what its
wrapper hands the kernel, and held to the plain backward (autograd of
`render_core_train_plain`).

`emulate_bwd` follows the kernel step by step: the packed bf16 weights and
plan rows, the `_BwdPlan` scratch table (offsets, splits, chunks), the
activation stash, the per-block bias rows, the split-K sums and the
wrapper's un-permutation. Every scratch element starts as NaN, so a
region the weight-gradient products read but the sweep never wrote shows
up. `rnd` says where the kernel rounds to bf16:

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

import math

import numpy as np
import pytest
import torch

from i2sdf_tpu_torch.models import mlp
from i2sdf_tpu_torch.ops.activations import softplus_beta
from i2sdf_tpu_torch.ops.kernels import mma_pack, render_core
from i2sdf_tpu_torch.models.embedder import positional_encoding
from test_torch_kernel_layout import LIGHT_CASES, bf, light_net, unpack

INV_SQRT2 = 1.0 / math.sqrt(2.0)


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


def pe_cols(x, F, width):
    """The encoding in the kernels' column layout, zero-padded to width."""
    pe = positional_encoding(x, F)
    out = x.new_zeros((x.shape[0], width))
    out[:, :min(width, pe.shape[1])] = pe[:, :width]
    return out


def stash_q(z, rnd):
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


def pad_rows(t, rows, cols=None):
    out = t.new_zeros((rows, cols or t.shape[1]))
    out[:t.shape[0], :t.shape[1]] = t
    return out


def _pad_cols(t, cols):
    out = t.new_zeros((t.shape[0], max(cols, t.shape[1])))
    out[:, :t.shape[1]] = t
    return out


def replay_sdf_forward(k, sc: ReplayScratch, xs, rnd, last=True):
    """Step 1 of `bwd_sweep_kernel` (csrc/common.cuh), the forward
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
    """Steps 4-7 of `bwd_sweep_kernel` (csrc/common.cuh: the reverse,
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
    nr = k.n_rad
    for p, (K, N) in enumerate(plan.dims):
        sdf_layer = p < ns
        M = 2 * P if sdf_layer else P
        if sdf_layer:
            A, B = v16(plan.ax[p], M, K), v16(plan.br[p], M, N)
        elif p < ns + nr:
            A, B = v16(plan.rx[p - ns], M, K), v16(plan.rdz[p - ns], M, N)
        else:
            A = v16(plan.lx[p - ns - nr], M, K)
            B = v16(plan.ldz[p - ns - nr], M, N)
        assert not (torch.isnan(A).any() or torch.isnan(B).any()), p
        parts = v32(plan.part[p], plan.splits[p], K * N)
        for s in range(plan.splits[p]):
            rows = slice(s * plan.chunk[p], min(M, (s + 1) * plan.chunk[p]))
            parts[s] = (A[rows].T @ B[rows]).reshape(-1)
        out[plan.out[p]:plan.out[p] + K * N] = parts.sum(0)
    assert not torch.isnan(sc.dbp).any()
    out[plan.out_db:] = sc.dbp.sum(0)
    return out


def replay_light(k, sc: ReplayScratch, feat, cs, rnd):
    """Step 1b of `bwd_sweep_kernel<true, true>`: the light net on
    relu(features) (X_l to lx[l], a hidden layer's s to ldz[l]), the
    output's dz = c_lm lm (1 - lm), and the backward through the hidden
    layers, dz replacing s in ldz[l], each layer's bias row to dbpart."""
    plan, P, nl = sc.plan, sc.plan.np, k.n_light
    o = k.n_sdf + k.n_rad  # the light layers' slots
    h = _pad_cols(torch.relu(feat), int(k.light.plan[0, 0]))
    for l in range(nl):
        K, N, _, _, _, W, b = unpack(k.light, l)
        sc.v16(plan.lx[l], P, K)[:] = h[:, :K]
        z = h[:, :K] @ W + b
        if l < nl - 1:
            s = torch.where(100 * z > 20, torch.ones_like(z),
                            torch.sigmoid(100 * z))
            sc.v16(plan.ldz[l], P, N)[:] = rnd(s)
            h = rnd(softplus_beta(z))
        else:
            lm = torch.sigmoid(z[:, :1])
            dz = feat.new_zeros((P, N))
            dz[:, :1] = cs[:, 7:8] * lm * (1 - lm)
            sc.put_db(plan.db[o + l], dz)
            a = rnd(dz)
            sc.v16(plan.ldz[l], P, N)[:] = a
    for l in range(nl - 1, 0, -1):
        K, N, _, _, _, W, _ = unpack(k.lightt, nl - 1 - l)
        dz = (a[:, :K] @ W) * sc.v16(plan.ldz[l - 1], P, N)
        sc.put_db(plan.db[o + l - 1], dz)
        a = rnd(dz)
        sc.v16(plan.ldz[l - 1], P, N)[:] = a


def emulate_bwd(k: render_core._KernelLayout, x, dirs, cot, rnd=bf,
                detach_light=True):
    """`csrc/render_core_bwd.cu` in torch; returns what the wrapper
    returns. `rnd` is where the kernel rounds to bf16 (activations,
    cotangents, everything it stores as bf16); the identity replays the
    same algorithm in f32 (on the kernel's bf16 weights). With a light
    head (`k.n_light`), c_lm is the cotangents' column 7."""
    plan = render_core._BwdPlan(k, x.shape[0])
    P, ns, nr, F = plan.np, k.n_sdf, k.n_rad, k.F
    sc = ReplayScratch(plan, x.device)
    v16 = sc.v16
    xs, ds, cs = pad_rows(x, P), pad_rows(dirs, P), pad_rows(cot, P, 8)
    Ns = [int(v) for v in k.fwd.plan[:, 1]]
    # 1. SDF forward
    qs, z = replay_sdf_forward(k, sc, xs, rnd)
    feat = rnd(z[:, :F])
    # 1b. the light head
    if k.n_light:
        replay_light(k, sc, feat, cs, rnd)
    # 2. radiance forward
    K0r = int(k.rad.plan[0, 0])
    h = torch.cat([feat, rnd(pe_cols(ds, k.md, K0r - F))], 1)
    for l in range(nr):
        K, N, real, _, _, W, b = unpack(k.rad, l)
        v16(plan.rx[l], P, K)[:] = h[:, :K]
        z = h[:, :K] @ W + b
        if l < nr - 1:
            h = rnd(torch.relu(z))
        else:
            rgb = torch.sigmoid(z[:, :real])
    # 3. radiance backward
    Nl = int(k.rad.plan[nr - 1, 1])
    dz = x.new_zeros((P, Nl))
    dz[:, :3] = cs[:, 4:7] * rgb * (1 - rgb)
    sc.put_db(plan.db[ns + nr - 1], dz)
    a = rnd(dz)
    v16(plan.rdz[nr - 1], P, Nl)[:] = a
    for l in range(nr - 1, -1, -1):
        K, N, real, _, _, W, _ = unpack(k.radt, nr - 1 - l)
        dh = a[:, :K] @ W
        if l > 0:
            mask = v16(plan.rx[l], P, N) > 0
            dz = torch.where(mask, dh, torch.zeros_like(dh))
            sc.put_db(plan.db[ns + l - 1], dz)
            a = rnd(dz)
            v16(plan.rdz[l - 1], P, N)[:] = a
        else:
            cy = x.new_zeros((P, Ns[-1]))
            cy[:, :F] = dh[:, :F]
            cy[:, F] = cs[:, 3]
            if k.n_light and not detach_light:
                # the light net's input cotangent through relu'(features)
                K0, N0, _, _, _, W0, _ = unpack(k.lightt, k.n_light - 1)
                cl = (v16(plan.ldz[0], P, K0) @ W0)[:, :F]
                on = v16(plan.rx[0], P, int(k.rad.plan[0, 0]))[:, :F] > 0
                cy[:, :F] += torch.where(on, cl, torch.zeros_like(cl))
            sc.put_db(plan.db[ns - 1], cy)
            v16(plan.br[ns - 1], 2 * P, Ns[-1])[P:] = rnd(cy)
    # 4-7 and the weight-gradient products
    out = replay_sdf_backward(k, sc, xs, cs, qs, F, rnd)
    return k.unpack_grads(out, plan)


def nets(width, skip, feat, rad, mx, md, seed=0, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    icfg = mlp.ImplicitNetConfig(
        feature_vector_size=feat, sdf_bounding_sphere=0.0,
        dims=(width,) * 8, skip_in=(skip,), bias=0.6,
        embed_type="positional", multires=mx)
    rcfg = mlp.RenderingNetConfig(feature_vector_size=feat, dims=(rad,) * 4,
                                  embed_type="positional", multires=md)
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
    with torch.no_grad():
        k = render_core._KernelLayout(net.cfg, rnet.cfg, w)
        got = [t for grp in emulate_bwd(k, x, d, c, rnd=lambda t: t)
               for t in grp]
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
    with torch.no_grad():
        k = render_core._KernelLayout(net.cfg, rnet.cfg, w)
        got = [t for grp in emulate_bwd(k, x, d, c) for t in grp]
    grad_check(got, plain_vjp(net.cfg, rnet.cfg, w, x, d, c))


def test_bwd_plan_table_and_cotangents():
    """The scratch table holds what the kernel reads, in its order, every
    array 16-byte aligned and disjoint; the split ranges cover the rows."""
    net, rnet = nets(*CASES["flagship"])
    with torch.no_grad():
        k = render_core._KernelLayout(net.cfg, rnet.cfg,
                                      render_core.CoreWeights.of(net, rnet))
    plan = render_core._BwdPlan(k, 160_000)
    ns, nr = k.n_sdf, k.n_rad
    assert (ns, nr) == (9, 5) and plan.np == 160_000
    assert len(plan.table) == 4 * ns + 2 * nr + 2 + 5 * (ns + nr) + 1
    spans = []
    for l, (K, N) in enumerate(plan.dims[:ns]):
        spans += [(plan.ax[l], 2 * plan.np * K), (plan.br[l], 2 * plan.np * N)]
        if l < ns - 1:
            spans.append((plan.dzx[l], plan.np * N))
    for l, (K, N) in enumerate(plan.dims[ns:]):
        spans += [(plan.rx[l], plan.np * K), (plan.rdz[l], plan.np * N)]
    spans.sort()
    for (o1, s1), (o2, _) in zip(spans, spans[1:]):
        assert o1 % 8 == 0 and o1 + s1 <= o2
    rows = [2 * plan.np] * ns + [plan.np] * nr
    for m, s, c in zip(rows, plan.splits, plan.chunk):
        assert c % 32 == 0 and (s - 1) * c < m <= s * c and s <= 32
    assert plan.tb == sum(N for _, N in plan.dims)
    cot = render_core.pack_cotangents(
        2, torch.ones(2, 1), torch.full((2, 3), 2.0), None, "cpu")
    assert cot.tolist() == [[2, 2, 2, 1, 0, 0, 0, 0]] * 2
    cot = render_core.pack_cotangents(2, None, None, None, "cpu",
                                      torch.full((2, 1), 5.0))
    assert cot.tolist() == [[0, 0, 0, 0, 0, 0, 0, 5]] * 2


def light_layout(case, device="cpu", seed=0):
    """The nets and kernel layout of a `LIGHT_CASES` case."""
    (width, skip, feat, rad, mx, md), depth, rdepth, ldims = LIGHT_CASES[case]
    gen = torch.Generator().manual_seed(seed)
    icfg = mlp.ImplicitNetConfig(
        feature_vector_size=feat, sdf_bounding_sphere=0.0,
        dims=(width,) * depth, skip_in=(skip,), bias=0.6,
        embed_type="positional", multires=mx)
    rcfg = mlp.RenderingNetConfig(feature_vector_size=feat,
                                  dims=(rad,) * rdepth,
                                  embed_type="positional", multires=md)
    net, rnet = mlp.ImplicitNet(icfg, gen), mlp.RenderingNet(rcfg, gen)
    with torch.no_grad():  # move off the init's zero PE weights
        for lin in net.layers() + rnet.layers():
            lin.v.add_(0.01 * torch.randn(lin.v.shape, generator=gen))
    lnet = light_net(feat, ldims, seed)
    return net.to(device), rnet.to(device), lnet.to(device)


def _light_grads(net, rnet, lnet, x, d, c, detach, rnd):
    w = render_core.CoreWeights.of(net, rnet, lnet)
    with torch.no_grad():
        k = render_core._KernelLayout(net.cfg, rnet.cfg, w, lnet.cfg)
        got = [t for grp in emulate_bwd(k, x, d, c, rnd=rnd,
                                        detach_light=detach) for t in grp]
    return w, k, got


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
    w, k, got = _light_grads(net, rnet, lnet, x, d, c, detach,
                             lambda t: t)
    ref = plain_vjp(net.cfg, rnet.cfg, bf16_weights(w), x, d, c, lnet.cfg,
                    detach)
    assert [g.shape for g in got] == [r.shape for r in ref]
    for i, (g, r) in enumerate(zip(got, ref)):
        torch.testing.assert_close(g, r, rtol=0,
                                   atol=1e-5 * float(r.abs().max()),
                                   msg=str(i))
    n_light = 2 * k.n_light
    assert all(float(g.abs().max()) > 0 for g in got[-n_light:])
    if detach:
        with torch.no_grad():
            k0 = render_core._KernelLayout(net.cfg, rnet.cfg,
                                           render_core.CoreWeights.of(
                                               net, rnet))
            base = [t for grp in emulate_bwd(k0, x, d, c, rnd=lambda t: t)
                    for t in grp]
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
    _, _, got = _light_grads(net, rnet, lnet, x, d, c, detach, bf)
    grad_check(got, plain_vjp(net.cfg, rnet.cfg, w, x, d, c, lnet.cfg,
                              detach))


def test_bwd_plan_table_with_the_light_head():
    """The light layers' staging (lx, ldz), slots and bias rows follow the
    radiance layers' in the table, disjoint from every other array."""
    net, rnet, lnet = light_layout("light")
    with torch.no_grad():
        k = render_core._KernelLayout(
            net.cfg, rnet.cfg, render_core.CoreWeights.of(net, rnet, lnet),
            lnet.cfg)
    plan = render_core._BwdPlan(k, 160_000)
    ns, nr, nl = k.n_sdf, k.n_rad, k.n_light
    assert (ns, nr, nl) == (7, 4, 2)
    assert len(plan.table) == (4 * ns + 2 * nr + 2 * nl + 2
                               + 5 * (ns + nr + nl) + 1)
    assert plan.dims[ns + nr:] == [(256, 128), (128, 16)]
    spans = []
    for l, (K, N) in enumerate(plan.dims[:ns]):
        spans += [(plan.ax[l], 2 * plan.np * K), (plan.br[l], 2 * plan.np * N)]
        if l < ns - 1:
            spans.append((plan.dzx[l], plan.np * N))
    for l, (K, N) in enumerate(plan.dims[ns:ns + nr]):
        spans += [(plan.rx[l], plan.np * K), (plan.rdz[l], plan.np * N)]
    for l, (K, N) in enumerate(plan.dims[ns + nr:]):
        spans += [(plan.lx[l], plan.np * K), (plan.ldz[l], plan.np * N)]
    spans.sort()
    for (o1, s1), (o2, _) in zip(spans, spans[1:]):
        assert o1 % 8 == 0 and o1 + s1 <= o2
    assert plan.tb == sum(N for _, N in plan.dims)
    assert plan.db[ns + nr:] == [plan.tb - 16 - 128, plan.tb - 16]


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
        render_core.render_core_bwd(None, x, d, torch.zeros(50, 7))
