"""K8 and K9 (the NeRF++ background's pair, `csrc/bg_core.cu` and
`csrc/bg_core_bwd.cu`) replayed in torch on the CPU from exactly what
their wrappers hand them: the packed weights and plan rows of `BgLayout`
(the implicit chain with its output columns as [features | sigma], the
transposed chains cut to the rows that continue down the nets, the
radiance input rows as [features | PE(view)]), the row stride, and for
K9 the scratch table of `_BgBwdPlan`, read in the order the C entry point
reads it, with NaN in every scratch element and every shared-memory
column no step has written. A wrong offset, width, skip column, scale
flag, padding or table entry shows here before any chip run.

The replay in f32 on the packed bf16 weights (`rnd` the identity) is
held to the plain pair on the same bf16-rounded weights: outputs to 1e-5,
gradients to 1e-4 of each leaf's largest entry (the same algorithm in
another summation order). The replay rounding where the kernels round is
held to the JAX package's XLA pair in bf16 in `test_torch_parity_bg.py`,
and the kernels to it on the card in `test_torch_gpu_kernels.py`; this
file imports no JAX, so the card's tests can use it.
"""

import math

import dataclasses

import pytest
import torch

from i2sdf_tpu_torch.models import mlp
from i2sdf_tpu_torch.models.embedder import positional_encoding
from i2sdf_tpu_torch.ops.activations import softplus_beta
from i2sdf_tpu_torch.ops.kernels import bg_core, mma_pack
from test_torch_kernel_layout import bf, dsoftplus, fresh, unpack

INV_SQRT2 = 1.0 / math.sqrt(2.0)
ROWS = 32  # K9's block


def pe_cols_d(x, F, width):
    """The kernels' `write_pe_d`: PE(x) (raw x with F = 0) in `width`
    columns, zero beyond the encoding."""
    pe = positional_encoding(x, F)
    out = torch.zeros((x.shape[0], width))
    out[:, :min(width, pe.shape[1])] = pe[:, :width]
    return out


def replay_fwd(k: bg_core.BgLayout, x4, dirs, rnd=bf, scratch=None):
    """K8 (and K9's forward recompute, staging into `scratch`: a dict of
    row views x, dz, rx). Returns (sigma (n, 1), rgb (n, 3), the buffer
    pair and the current index)."""
    n, F = x4.shape[0], k.F
    bufs, cur = fresh(n, k.lda), 0
    K0 = int(k.imp.plan[0, 0])
    bufs[0][:, :K0] = rnd(pe_cols_d(x4, k.fx, K0))
    for l in range(k.imp.n_layers):
        K, N, real, flags, col, W, b = unpack(k.imp, l)
        if flags & mma_pack.SKIP_IN:
            bufs[cur][:, col:K] = rnd(pe_cols_d(x4, k.fx, K - col)
                                      * INV_SQRT2)
        if scratch is not None:
            scratch["x"][l][:] = bufs[cur][:, :K]
        z = bufs[cur][:, :K] @ W + b
        if l < k.imp.n_layers - 1:
            scale = INV_SQRT2 if flags & mma_pack.SCALE else 1.0
            bufs[cur ^ 1][:, :N] = rnd(softplus_beta(z) * scale)
            if scratch is not None:
                scratch["dz"][l][:] = rnd(dsoftplus(z))
        else:
            bufs[cur ^ 1][:, :F] = rnd(z[:, :F])
            sigma = z[:, F:F + 1]
        cur ^= 1
    Kr = int(k.rad.plan[0, 0])
    bufs[cur][:, F:Kr] = rnd(pe_cols_d(dirs, k.fv, Kr - F))
    for l in range(k.rad.n_layers):
        K, N, real, _, _, W, b = unpack(k.rad, l)
        if scratch is not None:
            scratch["rx"][l][:] = bufs[cur][:, :K]
        z = bufs[cur][:, :K] @ W + b
        if l < k.rad.n_layers - 1:
            bufs[cur ^ 1][:, :N] = rnd(torch.relu(z))
        else:
            rgb = torch.sigmoid(z[:, :real])
        cur ^= 1
    return sigma, rgb, bufs, cur


def read_table(t, ni, nr):
    """The table in the order `i2sdf_bg_core_bwd` reads it."""
    t = [int(v) for v in t]
    out, i = {}, 0
    for name, m in (("x", ni), ("dz", ni), ("rx", nr), ("rdz", nr)):
        out[name], i = t[i:i + m], i + m
    out["dbpart"], out["tb"], i = t[i], t[i + 1], i + 2
    jobs = ni + nr
    for name in ("db", "splits", "chunk", "part", "outp"):
        out[name], i = t[i:i + jobs], i + jobs
    out["out_db"] = t[i]
    assert i + 1 == len(t)
    return out


def replay_bwd(k: bg_core.BgLayout, x4, dirs, cot, rnd=bf):
    """K9: the sweep, the split-K products and the fixed-order sums, all
    through the scratch buffers at the table's offsets; returns the
    wrapper's unpacked gradients."""
    n = x4.shape[0]
    plan = bg_core._BgBwdPlan(k, n)
    np_, ni, nr, F = plan.np, k.n_imp, k.n_rad, k.F
    tab = read_table(plan.table, ni, nr)
    ws16 = torch.full((plan.n16,), float("nan"))
    ws32 = torch.full((plan.n32,), float("nan"))
    dims = plan.dims

    def v16(off, cols):
        return ws16[off:off + np_ * cols].view(np_, cols)

    sc = {"x": [v16(tab["x"][l], dims[l][0]) for l in range(ni)],
          "dz": [v16(tab["dz"][l], dims[l][1]) for l in range(ni)],
          "rx": [v16(tab["rx"][l], dims[ni + l][0]) for l in range(nr)],
          "rdz": [v16(tab["rdz"][l], dims[ni + l][1]) for l in range(nr)]}
    pad = lambda t, c: torch.cat(  # noqa: E731
        [t, torch.zeros((np_ - n, c))])
    xs, ds, cs = pad(x4, x4.shape[1]), pad(dirs, 3), pad(cot, 4)
    _, rgb, bufs, cur = replay_fwd(k, xs, ds, rnd, sc)
    blocks = np_ // ROWS
    dbpart = ws32[tab["dbpart"]:tab["dbpart"] + blocks * tab["tb"]].view(
        blocks, tab["tb"])

    def put_db(p, dzf):
        N = dzf.shape[1]
        o = tab["db"][p]
        dbpart[:, o:o + N] = dzf.reshape(blocks, ROWS, N).sum(1)

    # the radiance output's dz
    Nr = dims[-1][1]
    dzf = torch.zeros((np_, Nr))
    dzf[:, :3] = cs[:, 1:] * rgb * (1 - rgb)
    bufs[cur][:, :Nr] = rnd(dzf)
    sc["rdz"][nr - 1][:] = rnd(dzf)
    put_db(ni + nr - 1, dzf)
    # radiance backward
    n_last = dims[ni - 1][1]
    cy = sc["dz"][ni - 1]
    for l in range(nr - 1, -1, -1):
        K, N, real, _, _, W, _ = unpack(k.radt, nr - 1 - l)
        a = bufs[cur][:, :K] @ W
        if l > 0:
            d = torch.where(sc["rx"][l][:, :N] > 0, a, torch.zeros_like(a))
            bufs[cur ^ 1][:, :N] = rnd(d)
            sc["rdz"][l - 1][:] = rnd(d)
            put_db(ni + l - 1, d)
            cur ^= 1
        else:
            dzf = torch.zeros((np_, n_last))
            dzf[:, :F] = a[:, :F]
            dzf[:, F] = cs[:, 0]
            cy[:] = rnd(dzf)
            put_db(ni - 1, dzf)
    # implicit backward, dz in place of the stashed s
    bufs[cur][:, :n_last] = cy
    for l in range(ni - 1, 0, -1):
        K, N, n_h, flags, _, W, _ = unpack(k.impt, ni - 1 - l)
        assert N == dims[l - 1][1]
        a = bufs[cur][:, :K] @ W
        scale = INV_SQRT2 if flags & mma_pack.SCALE else 1.0
        d = torch.zeros((np_, N))
        d[:, :n_h] = a[:, :n_h] * scale * sc["dz"][l - 1][:, :n_h]
        bufs[cur ^ 1][:, :N] = rnd(d)
        sc["dz"][l - 1][:] = rnd(d)
        put_db(l - 1, d)
        cur ^= 1
    # the products over point ranges, then the fixed-order sums
    out = torch.full((plan.n_out,), float("nan"))
    for p, (K, N) in enumerate(dims):
        A = (sc["x"] + sc["rx"])[p].float()
        B = (sc["dz"] + sc["rdz"])[p].float()
        part = ws32[tab["part"][p]:tab["part"][p]
                    + tab["splits"][p] * K * N].view(-1, K, N)
        ch = tab["chunk"][p]
        for s in range(tab["splits"][p]):
            r = slice(s * ch, min(np_, (s + 1) * ch))
            part[s] = A[r].t() @ B[r]
        assert tab["splits"][p] * ch >= np_ > (tab["splits"][p] - 1) * ch
        out[tab["outp"][p]:tab["outp"][p] + K * N] = part.sum(0).flatten()
    out[tab["out_db"]:tab["out_db"] + tab["tb"]] = dbpart.sum(0)
    return k.unpack_grads(out, plan)


# narrow nets whose widths are no multiples of 16, so every padding path
# runs: the skip's hidden part (40 - 28 = 12) pads to 16 under the
# encoding, the features (18) and the radiance widths (20, 24) pad too
ICFG = mlp.ImplicitNetConfig(
    feature_vector_size=18, sdf_bounding_sphere=0.0, d_in=4,
    dims=(40, 40, 40), skip_in=(2,), geometric_init=False,
    weight_norm=False, embed_type="positional", multires=3)
ICFG_RAW = mlp.ImplicitNetConfig(
    feature_vector_size=18, sdf_bounding_sphere=0.0, d_in=4,
    dims=(40, 40), skip_in=(), geometric_init=False, weight_norm=False,
    embed_type=None)
RCFG = mlp.RenderingNetConfig(
    feature_vector_size=18, mode="nerf", d_in=3, dims=(20, 24),
    weight_norm=False, embed_type="positional", multires=2)


def bg_case(pe, n=70, seed=0, device="cpu"):
    """Seeded nets and n points (70: 3 blocks of K9, the last with padding
    rows): x4 with unit directions and inverse depths, unit view
    directions, and cotangents [c_sigma | c_rgb]."""
    gen = torch.Generator().manual_seed(seed)
    net_i = mlp.ImplicitNet(ICFG if pe else ICFG_RAW, gen)
    net_r = mlp.RenderingNet(RCFG, gen)
    p = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen),
                                      dim=-1)
    x4 = torch.cat([p, torch.rand((n, 1), generator=gen) * 0.25], 1)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen),
                                      dim=-1)
    cot = torch.randn((n, 4), generator=gen)
    return (net_i.to(device), net_r.to(device),
            *(t.to(device).contiguous() for t in (x4, d, cot)))


def rounded(w: bg_core.BgWeights) -> bg_core.BgWeights:
    """The weights rounded to bf16 (the packed kernels' weights), as leaves
    autograd can differentiate."""
    r = lambda ts: tuple(t.detach().to(torch.bfloat16).float()  # noqa
                         .requires_grad_(True) for t in ts)
    b = lambda ts: tuple(t.detach().requires_grad_(True)  # noqa: E731
                         for t in ts)
    return bg_core.BgWeights(r(w.ws_i), b(w.bs_i), r(w.ws_r), b(w.bs_r))


@pytest.mark.parametrize("pe", [True, False], ids=["pe", "raw"])
def test_bg_kernels_replay_to_plain(pe):
    """The f32 replay against the plain pair on the bf16-rounded weights."""
    net_i, net_r, x4, dirs, cot = bg_case(pe)
    with torch.no_grad():
        k = bg_core.BgLayout(net_i.cfg, net_r.cfg,
                             bg_core.BgWeights.of(net_i, net_r))
    ident = lambda t: t  # noqa: E731
    w = rounded(bg_core.BgWeights.of(net_i, net_r))
    s_ref, rgb_ref = bg_core.bg_core_plain(net_i.cfg, net_r.cfg, w, x4, dirs)
    s, rgb, _, _ = replay_fwd(k, x4, dirs, ident)
    torch.testing.assert_close(s, s_ref.detach(), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rgb, rgb_ref.detach(), atol=1e-5, rtol=1e-5)
    ref = torch.autograd.grad((s_ref, rgb_ref), w.flat(),
                              (cot[:, :1], cot[:, 1:]))
    got = [t for g in replay_bwd(k, x4, dirs, cot, ident) for t in g]
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, i
        scale = max(float(r.abs().max()), 1e-6)
        assert float((g - r).abs().max()) / scale < 1e-4, i


def test_bg_layout_refuses_what_the_kernels_cannot_run():
    net_i, net_r, x4, dirs, cot = bg_case(True, n=4)
    w = bg_core.BgWeights.of(net_i, net_r)
    with pytest.raises(ValueError):
        bg_core.BgLayout(dataclasses.replace(net_i.cfg, skip_in=(0,)),
                         net_r.cfg, w)
    with pytest.raises(ValueError):
        bg_core.BgLayout(net_i.cfg, dataclasses.replace(
            net_r.cfg, embed_type=None), w)
    with torch.no_grad():
        k = bg_core.BgLayout(net_i.cfg, net_r.cfg, w)
    with pytest.raises(ValueError):   # the kernel takes CUDA tensors only
        bg_core.bg_core_bwd(k, x4, dirs, cot)
