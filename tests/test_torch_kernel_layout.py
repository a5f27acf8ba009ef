"""The host side of the CUDA kernels, checked on the CPU.

The kernels themselves run only on the card, but the weight packing and
the per-layer plans they read are built in Python. This file replays the
kernels' algorithm in torch from exactly what the wrappers hand them (the
fragment-ordered bf16 weights, padded biases, plan rows, row strides),
with bf16 rounding where the kernels round and NaN in every shared-memory
column no layer has written, and holds the result to the plain version
at the kernels' tolerances. A wrong offset, width, skip column, scale
flag or padding shows up here before any chip run. The sampler round's
lane-chunked f32 scans are replayed the same way.
"""

import math

import numpy as np
import pytest
import torch

from i2sdf_tpu_torch.models import mlp
from i2sdf_tpu_torch.models.embedder import positional_encoding
from i2sdf_tpu_torch.ops.activations import softplus_beta
from i2sdf_tpu_torch.ops.kernels import mma_pack, render_core, sdf_mlp

INV_SQRT2 = 1.0 / math.sqrt(2.0)


def bf(t):
    return t.to(torch.bfloat16).float()


def unpack(pm: mma_pack.PackedMlp, i: int):
    K, N, real, woff, boff, flags, col, _ = (int(v) for v in pm.plan[i])
    w = pm.weights[woff * 4: woff * 4 + K * N]
    W = (w.reshape(N // 8, K // 16, 8, 4, 2, 2).permute(1, 4, 3, 5, 0, 2)
         .reshape(K, N).float())
    return K, N, real, flags, col, W, pm.biases[boff: boff + N]


def pe_cols(x, F, width):
    pe = positional_encoding(x, F)
    out = torch.zeros((x.shape[0], width))
    out[:, :min(width, pe.shape[1])] = pe[:, :width]
    return out


def dsoftplus(z):
    return torch.where(100 * z > 20, torch.ones_like(z),
                       torch.sigmoid(100 * z))


def fresh(n, lda):
    return [torch.full((n, lda), float("nan")) for _ in range(2)]


def run_sdf_chain(pm, x, F, lda, dact=None, rnd=bf):
    """The SDF forward of the kernels; returns (buffers, cur, last acc).
    `rnd` is where the kernels round to bf16 (the identity replays the
    same algorithm in f32 on the packed bf16 weights)."""
    bufs, cur = fresh(x.shape[0], lda), 0
    K0 = int(pm.plan[0, 0])
    bufs[0][:, :K0] = rnd(pe_cols(x, F, K0))
    for i in range(pm.n_layers):
        K, N, real, flags, col, W, b = unpack(pm, i)
        assert K <= lda and N <= lda
        if flags & mma_pack.SKIP_IN:
            bufs[cur][:, col:K] = rnd(pe_cols(x, F, K - col) * INV_SQRT2)
        z = bufs[cur][:, :K] @ W + b
        if i == pm.n_layers - 1:
            return bufs, cur, z
        scale = INV_SQRT2 if flags & mma_pack.SCALE else 1.0
        bufs[cur ^ 1][:, :N] = rnd(softplus_beta(z) * scale)
        if dact is not None:
            dact.append(rnd(dsoftplus(z)))
        cur ^= 1


def replay_grad_sweep(k, bufs, cur, dact, x, rnd=bf):
    """The reverse sweep of `fwd_sweep_kernel` (csrc/common.cuh, K3 and
    K5): d sdf / d x from the stashed derivatives, through `k.rev` and
    `k.wsdf_col`."""
    K = int(k.rev.plan[0, 0])
    bufs[cur][:, :K] = rnd(k.wsdf_col[:K] * dact[-1][:, :K])
    d0 = 3 + 6 * k.mx
    gpe = torch.zeros((x.shape[0], d0))
    n_hidden = len(dact)
    for i in range(k.rev.n_layers):
        l = n_hidden - 1 - i
        K, N, n_h, flags, gcol, W, _ = unpack(k.rev, i)
        a = bufs[cur][:, :K] @ W
        if flags & mma_pack.SCALE:
            a = a * INV_SQRT2
        nxt = torch.zeros((x.shape[0], N))
        if n_h:
            nxt[:, :n_h] = a[:, :n_h] * dact[l - 1][:, :n_h]
        lo, hi = max(gcol, 0), min(gcol + d0, N)
        if lo < hi:
            gpe[:, lo - gcol:hi - gcol] += a[:, lo:hi]
        bufs[cur ^ 1][:, :N] = rnd(nxt)
        cur ^= 1
    f = 2.0 ** torch.arange(k.mx, dtype=torch.float32)
    xf = x[:, :, None] * f
    g_sin = gpe[:, 3:3 + 3 * k.mx].reshape(-1, 3, k.mx)
    g_cos = gpe[:, 3 + 3 * k.mx:].reshape(-1, 3, k.mx)
    return gpe[:, :3] + (f * (g_sin * torch.cos(xf)
                              - g_cos * torch.sin(xf))).sum(-1)


def emulate_sdf_mlp(p: sdf_mlp.SdfMlpPack, x):
    _, _, z = run_sdf_chain(p.kernel, x, p.net.cfg.multires, p.lda)
    return z[:, 0]


def emulate_light(k, feat, rnd=bf):
    """K3's light head (`kLight` in `fwd_sweep_kernel`): the light chain
    on relu(features), zero-padded to its first layer's depth, each hidden
    layer's activation rounded where the kernel rounds it; returns the
    sigmoid mask (N, 1)."""
    K0 = int(k.light.plan[0, 0])
    h = torch.zeros((feat.shape[0], K0))
    h[:, :feat.shape[1]] = torch.relu(feat)
    for i in range(k.light.n_layers):
        K, N, real, _, _, W, b = unpack(k.light, i)
        z = h[:, :K] @ W + b
        if i == k.light.n_layers - 1:
            return torch.sigmoid(z[:, :1])
        h = rnd(softplus_beta(z))


def emulate_render_core(k, x, dirs, F_feat):
    """K3 in torch; with a light head (`k.n_light`) the light mask is a
    fourth output."""
    dact = []
    bufs, cur, z = run_sdf_chain(k.fwd, x, k.mx, k.lda, dact)
    sdf = z[:, F_feat:F_feat + 1]
    out = bufs[cur ^ 1]
    out[:, :F_feat] = bf(z[:, :F_feat])
    cur ^= 1
    lmask = emulate_light(k, out[:, :F_feat].clone()) if k.n_light else None
    K0 = int(k.rad.plan[0, 0])
    out[:, F_feat:K0] = bf(pe_cols(dirs, k.md, K0 - F_feat))
    for i in range(k.rad.n_layers):
        K, N, real, _, _, W, b = unpack(k.rad, i)
        z = bufs[cur][:, :K] @ W + b
        if i < k.rad.n_layers - 1:
            bufs[cur ^ 1][:, :N] = bf(torch.relu(z))
            cur ^= 1
        else:
            rgb = torch.sigmoid(z[:, :real])
    outs = (sdf, replay_grad_sweep(k, bufs, cur, dact, x), rgb)
    return outs if lmask is None else outs + (lmask,)


def test_fragment_packing_round_trips():
    w = torch.randn(39, 217)
    K, N = mma_pack.round_up(39, 16), mma_pack.round_up(217, 16)
    pm = mma_pack.pack_chain([dict(w=w, b=torch.zeros(217))])
    K2, N2, real, _, _, W, b = unpack(pm, 0)
    assert (K2, N2, real) == (K, N, 217)
    assert torch.equal(W[:39, :217], bf(w))
    assert torch.all(W[39:] == 0) and torch.all(W[:, 217:] == 0)
    # lane l of tile t, k-step kk holds W[16kk + 2i + {0,1, 8, 9}, 8t + g]
    frag = pm.weights.reshape(N // 8, K // 16, 32, 4)
    t, kk, g, i = 3, 1, 5, 2
    assert torch.equal(frag[t, kk, 4 * g + i].float(),
                       W[[16 * kk + 2 * i, 16 * kk + 2 * i + 1,
                          16 * kk + 2 * i + 8, 16 * kk + 2 * i + 9],
                         8 * t + g])


def _nets(width, skip, feat, rad, mx, md, seed=0, depth=8, rdepth=4):
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
    return net, rnet


def light_net(feat, dims, seed=0):
    """A light head as the light-mask config builds it (renderer.py)."""
    lcfg = mlp.ImplicitNetConfig(
        feature_vector_size=0, sdf_bounding_sphere=0.0, d_in=feat, d_out=1,
        dims=dims, geometric_init=False, output_activation="sigmoid")
    return mlp.ImplicitNet(lcfg, torch.Generator().manual_seed(seed + 11))


CASES = {"flagship": (256, 4, 256, 256, 6, 4),
         "narrow": (64, 3, 32, 48, 4, 2)}
# the light-mask config's nets (SDF 6 x 256, skip at 3; radiance 3 x 256;
# light 256 -> 128 -> 1) and a narrow one with two light hidden layers
LIGHT_CASES = {"light": ((256, 3, 256, 256, 6, 4), 6, 3, (128,)),
               "narrow": ((64, 2, 32, 48, 4, 2), 4, 2, (24, 16))}


@pytest.mark.parametrize("case", list(CASES))
def test_sdf_mlp_plan_replays_to_plain(case):
    width, skip, feat, rad, mx, md = CASES[case]
    net, _ = _nets(width, skip, feat, rad, mx, md)
    p = sdf_mlp.SdfMlpPack.__new__(sdf_mlp.SdfMlpPack)
    p.net = net
    p.kernel = mma_pack.pack_chain(mma_pack.sdf_chain(net, last_cols=[0]))
    p.lda = mma_pack.row_stride(p.kernel.max_width)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(200, 3)).astype(np.float32))
    got = emulate_sdf_mlp(p, x)
    ref = sdf_mlp.sdf_mlp_plain(net, x)
    torch.testing.assert_close(got, ref, atol=0.02, rtol=0.02)


@pytest.mark.parametrize("case", list(CASES))
def test_render_core_plan_replays_to_plain(case):
    width, skip, feat, rad, mx, md = CASES[case]
    net, rnet = _nets(width, skip, feat, rad, mx, md)
    k = render_core._KernelLayout(net.cfg, rnet.cfg,
                                  render_core.CoreWeights.of(net, rnet))
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.normal(size=(200, 3)) * 0.8).astype(
        np.float32))
    d = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(200, 3)).astype(np.float32)), dim=-1)
    got = emulate_render_core(k, x, d, feat)
    ref = render_core.render_core_plain(net, rnet, x, d)
    for name, g, r, tol in zip(("sdf", "grad", "rgb"), got, ref,
                               ((0.02, 0.02), (0.05, 0.08), (0.03, 0.05))):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, r, atol=tol[0], rtol=tol[1], msg=name)


@pytest.mark.parametrize("case", list(LIGHT_CASES))
def test_render_core_light_plan_replays_to_plain(case):
    """K3 with the light head, at the SDF and radiance depths the case
    gives: the replay's light mask to the plain version at the JAX light
    test's tolerance (`tests/test_pallas_train.py:171-176`), and the other
    outputs as without the head."""
    (width, skip, feat, rad, mx, md), depth, rdepth, ldims = LIGHT_CASES[case]
    net, rnet = _nets(width, skip, feat, rad, mx, md, depth=depth,
                      rdepth=rdepth)
    lnet = light_net(feat, ldims)
    k = render_core._KernelLayout(
        net.cfg, rnet.cfg, render_core.CoreWeights.of(net, rnet, lnet),
        lnet.cfg)
    assert k.n_light == len(ldims) + 1 and k.n_sdf == depth + 1
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.normal(size=(200, 3)) * 0.8).astype(
        np.float32))
    d = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(200, 3)).astype(np.float32)), dim=-1)
    got = emulate_render_core(k, x, d, feat)
    ref = render_core.render_core_plain(net, rnet, x, d, lnet)
    assert len(got) == len(ref) == 4
    for name, g, r, tol in zip(("sdf", "grad", "rgb", "lmask"), got, ref,
                               ((0.02, 0.02), (0.05, 0.08), (0.03, 0.05),
                                (0.02, 0.03))):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, r, atol=tol[0], rtol=tol[1], msg=name)
    # the light layers fit the shared memory the kernels are given
    assert render_core.fwd_smem(k) <= render_core._MAX_SMEM
    assert render_core.bwd_smem(k) <= render_core._MAX_SMEM


# ---- the sampler round's warp arithmetic ----------------------------------

def _warp_excl_scan(tot):
    """csrc/sampler_round.cu warp_excl_scan in f32: Kogge-Stone inclusive
    scan of the 32 lane totals, shifted up one lane."""
    incl = tot.astype(np.float32).copy()
    o = 1
    while o < 32:
        shifted = np.concatenate([np.zeros(o, np.float32), incl[:-o]])
        incl = np.where(np.arange(32) >= o, incl + shifted, incl).astype(
            np.float32)
        o *= 2
    return np.concatenate([[np.float32(0)], incl[:-1]]).astype(np.float32)


def _lane_scan(x, S, exclusive):
    """A per-sample f32 prefix sum as the kernel forms it: lane l owns
    samples [l*E, l*E + E), sums them in order, and adds its lane offset."""
    E = (S + 31) // 32
    pad = np.zeros(32 * E, np.float32)
    pad[:S] = x
    lanes = pad.reshape(32, E)
    local = np.cumsum(lanes, axis=1, dtype=np.float32)
    off = _warp_excl_scan(local[:, -1])
    if exclusive:
        local = np.concatenate([np.zeros((32, 1), np.float32),
                                local[:, :-1]], axis=1)
    return (off[:, None] + local).reshape(-1)[:S]


@pytest.mark.parametrize("S", [97, 128, 480, 600])
def test_sampler_round_scans_survive_the_far_sample(S):
    """The last sample's free energy is 1e10 times its density (the
    infinite last section); behind a wall that is ~1e11. The transmittance
    of the sections before it must not depend on it, whichever lane holds
    it: the kernel's lane-chunked f32 scan against a plain cumsum."""
    rng = np.random.default_rng(S)
    z = np.sort(rng.uniform(0.0, 6.0, S)).astype(np.float32)
    dens = (10.0 * (z > 3.0) + 0.01).astype(np.float32)
    fe = np.concatenate([np.diff(z), [1e10]]).astype(np.float32) * dens
    got = np.exp(-_lane_scan(fe, S, exclusive=True))[:S - 1]
    ref = np.exp(-np.concatenate([[0.0], np.cumsum(fe[:-1])]))[:S - 1]
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-7)
