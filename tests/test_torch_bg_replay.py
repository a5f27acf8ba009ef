"""K8 and K9 (the NeRF++ background's pair, `csrc/bg_core.cu` and
`csrc/bg_core_bwd.cu`, on `csrc/wgmma_layer.cuh`) replayed in torch on the
CPU from exactly what their wrappers hand them: the stage images of
`BgStages` read as wgmma reads them (the implicit chain's output layer as
a sigma product and a features product, the radiance input rows as
[features | PE(view)], the transposed chains cut to the rows that continue
down the nets), the 64-row tiles written through the kernels' `act_off`,
and for K9 the ring table of `BgPlan` consumed item by item (a stash or
mask tile loaded before the wait for the sweep that stored it fails), the
scratch regions the bulk copies fill, the per-block bias rows and the
weight-gradient products reading the operand regions MN-major, all through
K4's replay (`test_torch_bwd_replay.K4Replay`). Every shared-memory and
scratch element starts as NaN, so a region read but never written shows.
A wrong offset, width, skip column, scale flag, padding or table entry
fails here before any chip run.

The replay in f32 on the packed bf16 weights (`rnd` the identity) is
held to the plain pair on the same bf16-rounded weights: outputs to 1e-5,
gradients to 1e-4 of each leaf's largest entry (the same algorithm in
another summation order). The replay rounding where the kernels round is
held to the JAX package's XLA pair in bf16 and to its Pallas kernel in
interpret mode in `test_torch_parity_bg.py`, and the kernels to it on the
card in `test_torch_gpu_kernels.py`; this file imports no JAX, so the
card's tests can use it.
"""

import math

import dataclasses

import numpy as np
import pytest
import torch

from i2sdf_tpu_torch.models import mlp
from i2sdf_tpu_torch.models.embedder import positional_encoding
from i2sdf_tpu_torch.ops.activations import softplus_beta
from i2sdf_tpu_torch.ops.kernels import bg_core, mma_pack, render_core
from i2sdf_tpu_torch.ops.kernels.render_core import (REG_DZ, REG_Q, REG_RDZ,
                                                     REG_RX, REG_X)
from i2sdf_tpu_torch.ops.kernels.replay import CHUNK, K4Replay, pad_rows
from test_torch_kernel_layout import bf, dsoftplus, stage_images

INV_SQRT2 = 1.0 / math.sqrt(2.0)
TILE = 5 * CHUNK      # a tile: 64 rows x 320 columns


def pe_cols_d(x, F, width):
    """The kernels' encoding fill: PE(x) (raw x with F = 0) in `width`
    columns, zero beyond the encoding."""
    pe = positional_encoding(x, F)
    out = x.new_zeros((x.shape[0], width))
    out[:, :min(width, pe.shape[1])] = pe[:, :width]
    return out


class _Tiles(K4Replay):
    """The 64-row tiles of every block (K8: each warpgroup's own; K9: the
    block's), as K4's replay holds its tile."""

    def __init__(self, st, n, x4, dirs, rnd):
        self.st, self.rnd = st, rnd
        self.B = B = -(-max(n, 1) // 64)
        self.xs = pad_rows(x4, B * 64).view(B, 64, -1)
        self.ds = pad_rows(dirs, B * 64).view(B, 64, 3)
        self.T = torch.full((B, TILE // 2), float("nan"), device=x4.device)

    def fill(self, what, col0, kend, scale=1.0):
        src, F = ((self.ds, self.st.fv) if what == "dirs"
                  else (self.xs, self.st.fx))
        w = kend - col0
        v = pe_cols_d(src.reshape(-1, src.shape[-1]), F, w)
        self.put(self.T, torch.arange(col0, kend),
                 (v * scale).view(self.B, 64, w))


class K8Replay(_Tiles):
    """`csrc/bg_core.cu`: each warpgroup's 64 rows through both nets in
    its own tile, a layer of N > 128 columns in passes of the stages'
    rows (`stage_images`), written in place once its passes are done."""

    def layer(self, pm, i):
        """Layer i's products over the tile, pass by pass: (B, 64, N)."""
        K = int(pm.plan[i, 0])
        accs = []
        for slots in stage_images(pm, i):
            R = slots[0].numel() // 64
            b = torch.cat(slots)[self.k_major(R, K, R * 128)]
            a = self.T[:, self.k_major(64, K, CHUNK).flatten()].view(
                self.B, 64, K)
            accs.append(a @ b.t())
        boff, N = int(pm.plan[i, 4]), int(pm.plan[i, 1])
        return torch.cat(accs, -1) + pm.biases[boff:boff + N]

    def run(self, n):
        st, imp, rad = self.st, self.st.imp.plan, self.st.rad.plan
        nh, F = st.n_imp - 1, st.F
        self.fill("x", 0, int(imp[0, 0]))
        for l in range(nh):
            z = self.layer(st.imp, l)
            scale = INV_SQRT2 if imp[l, 5] & mma_pack.SCALE else 1.0
            self.put(self.T, torch.arange(z.shape[-1]),
                     softplus_beta(z) * scale)
            nx = imp[l + 1]
            if nx[5] & mma_pack.SKIP_IN:
                self.fill("x", int(nx[6]), int(nx[0]), INV_SQRT2)
        sigma = self.layer(st.imp, nh)[..., :1]
        feat = self.layer(st.imp, nh + 1)
        self.put(self.T, torch.arange(feat.shape[-1]), feat)
        self.fill("dirs", F, int(rad[0, 0]))
        for l in range(st.n_rad):
            z = self.layer(st.rad, l)
            if l < st.n_rad - 1:
                self.put(self.T, torch.arange(z.shape[-1]), torch.relu(z))
        rgb = torch.sigmoid(z[..., :int(rad[-1, 2])])
        return sigma.reshape(-1, 1)[:n], rgb.reshape(-1, 3)[:n]


def replay_fwd(st: bg_core.BgStages, x4, dirs, rnd=bf):
    """K8 from its stage images: (sigma (n, 1), rgb (n, 3)). `rnd` is where
    the kernel rounds to bf16; the identity replays the algorithm in f32
    on the packed bf16 weights."""
    with torch.no_grad():
        return K8Replay(st, x4.shape[0], x4, dirs, rnd).run(x4.shape[0])


class K9Replay(_Tiles):
    """`csrc/bg_core_bwd.cu`: the sweep over 64-point blocks (the forward
    recompute with each hidden layer's s staged out, the radiance net and
    its backward, the implicit backward with s brought back), then K4's
    products and sums."""

    def __init__(self, st, plan, x4, dirs, cot, rnd):
        super().__init__(st, x4.shape[0], x4, dirs, rnd)
        self.plan = plan
        self.cot = pad_rows(cot, self.B * 64).view(self.B, 64, 4)
        self.scr, self.stored_in = {}, {}
        self.items = [tuple(int(v) for v in it) for it in plan.script]
        self.pos = self.done = self.waited = 0
        self.dbrow = torch.full((self.B, plan.tb), float("nan"),
                                device=x4.device)
        self.blobs = [None, st.imp.weights.float(), st.rad.weights.float(),
                      None, st.t.weights.float()]

    def take_weights(self, row):
        """A layer's stages, one item per 64-deep chunk: a layer in passes
        as two copies, its passes' stages of the chunk side by side."""
        K, N, woff, R = (int(row[i]) for i in (0, 1, 3, 7))
        C, slots = -(-K // 64), []
        for c in range(C):
            kind, off, stride, nbytes = self._next()
            blob = self.blobs[kind >> 8]
            assert kind >> 8 >= 1 and nbytes == N * 128
            if R:
                assert kind & 255 == bg_core._LOAD2
                assert (off, stride) == (2 * woff + c * R * 128, C * R * 128)
                h = nbytes // 4
                data = torch.cat([blob[off // 2:off // 2 + h],
                                  blob[(off + stride) // 2:
                                       (off + stride) // 2 + h]])
            else:
                assert kind & 255 == bg_core._LOAD and stride == 0
                assert off == 2 * woff + c * N * 128
                data = blob[off // 2:(off + nbytes) // 2]
            slots.append(data[None])
        return slots

    def run(self):
        st, plan = self.st, self.plan
        imp, rad = st.imp.plan, st.rad.plan
        ni, nr, nh, F = st.n_imp, st.n_rad, st.n_imp - 1, st.F
        ch = lambda c: -(-int(c) // 64)  # noqa: E731
        # 1. implicit forward: X_l stored, s_l staged out
        self.fill("x", 0, int(imp[0, 0]))
        for l in range(nh):
            K, N, _, _, boff, flags, _, _ = (int(v) for v in imp[l])
            self.store_T(REG_X, l, ch(K))
            z = self.product(imp[l]) + st.imp.biases[boff:boff + N]
            S = self.take_stage()
            scale = INV_SQRT2 if flags & mma_pack.SCALE else 1.0
            self.put(self.T, torch.arange(N), softplus_beta(z) * scale)
            self.put(S, torch.arange(N), dsoftplus(z))
            nx = imp[l + 1]
            if nx[5] & mma_pack.SKIP_IN:
                self.fill("x", int(nx[6]), int(nx[0]), INV_SQRT2)
            self.store(REG_Q, l, S, ch(N) * CHUNK)
        row = imp[ni]
        self.store_T(REG_X, nh, ch(row[0]))
        z = self.product(row) + st.imp.biases[int(row[4]):int(row[4])
                                              + int(row[1])]
        self.put(self.T, torch.arange(z.shape[-1]), z)
        self.sweep_done()
        # 2. radiance forward
        self.fill("dirs", F, int(rad[0, 0]))
        for l in range(nr):
            K, N, real, _, boff, *_ = (int(v) for v in rad[l])
            self.store_T(REG_RX, l, ch(K))
            z = self.product(rad[l]) + st.rad.biases[boff:boff + N]
            if l < nr - 1:
                self.put(self.T, torch.arange(N), torch.relu(z))
            else:
                rgb = torch.sigmoid(z[..., :real])
        self.sweep_done()
        # 3. radiance backward
        d_out = int(rad[nr - 1, 2])
        dz = self.T.new_zeros((self.B, 64, 64))
        dz[..., :d_out] = self.cot[..., 1:1 + d_out] * rgb * (1 - rgb)
        self.put(self.T, torch.arange(64), dz)
        self.bias(ni + nr - 1, dz, d_out)
        for l in range(nr - 1, 0, -1):
            self.store_T(REG_RDZ, l, ch(rad[l, 1]))
            dh = self.product(st.trad[nr - 1 - l])
            N = dh.shape[-1]
            M = self.get(self.take_stash(), torch.arange(N))
            dz = torch.where(M > 0, dh, torch.zeros_like(dh))
            self.put(self.T, torch.arange(N), dz)
            self.bias(ni + l - 1, dz, int(rad[l - 1, 2]))
        self.store_T(REG_RDZ, 0, ch(rad[0, 1]))
        cf = self.product(st.trad[nr - 1])
        cy = self.T.new_zeros((self.B, 64, 320))
        cy[..., :F] = cf[..., :F]
        cy[..., F] = self.cot[..., 0]
        self.put(self.T, torch.arange(320), cy)
        self.bias(ni - 1, cy, F + 1)
        self.store_T(REG_DZ, nh, ch(F + 1))
        # 4. implicit backward, s brought back
        for l in range(nh, 0, -1):
            row = st.timp[nh - l]
            v = self.product(row)
            N, n_h = v.shape[-1], int(row[2])
            scale = INV_SQRT2 if row[5] & mma_pack.SCALE else 1.0
            s = self.get(self.take_stash(), torch.arange(n_h))
            dz = torch.zeros_like(v)
            dz[..., :n_h] = v[..., :n_h] * scale * s
            self.put(self.T, torch.arange(N), dz)
            self.bias(l - 1, dz, int(imp[l - 1, 2]))
            self.store_T(REG_DZ, l - 1, ch(imp[l - 1, 1]))
        assert self.pos == len(self.items), "ring items left over"
        return self.products()


def replay_bwd(st: bg_core.BgStages, x4, dirs, cot, rnd=bf):
    """K9 from what its wrapper hands it (`st`, its `BgPlan`); returns
    what the wrapper returns."""
    with torch.no_grad():
        plan = bg_core.BgPlan(st, x4.shape[0])
        out = K9Replay(st, plan, x4, dirs, cot, rnd).run()
        return st.unpack_grads(out, plan)


def stages(net_i, net_r):
    with torch.no_grad():
        return bg_core.BgStages(net_i.cfg, net_r.cfg,
                                bg_core.BgWeights.of(net_i, net_r))


# narrow nets whose widths are no multiples of 16, so every padding path
# runs: the layer before the skip (160 - 28 = 132 wide) pads to 256 and
# comes in passes of 128 (K9 takes its stages as two copies), the
# encoding (28) pads under the skip, the features (18) and the radiance
# widths (20, 24) pad too
ICFG = mlp.ImplicitNetConfig(
    feature_vector_size=18, sdf_bounding_sphere=0.0, d_in=4,
    dims=(40, 160, 40), skip_in=(2,), geometric_init=False,
    weight_norm=False, embed_type="positional", multires=3)
ICFG_RAW = mlp.ImplicitNetConfig(
    feature_vector_size=18, sdf_bounding_sphere=0.0, d_in=4,
    dims=(40, 40), skip_in=(), geometric_init=False, weight_norm=False,
    embed_type=None)
RCFG = mlp.RenderingNetConfig(
    feature_vector_size=18, mode="nerf", d_in=3, dims=(20, 24),
    weight_norm=False, embed_type="positional", multires=2)


def bg_case(pe, n=70, seed=0, device="cpu"):
    """Seeded nets and n points (70: two blocks of K9, the last with
    padding rows): x4 with unit directions and inverse depths, unit view
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
    st = stages(net_i, net_r)
    ident = lambda t: t  # noqa: E731
    w = rounded(bg_core.BgWeights.of(net_i, net_r))
    s_ref, rgb_ref = bg_core.bg_core_plain(net_i.cfg, net_r.cfg, w, x4, dirs)
    s, rgb = replay_fwd(st, x4, dirs, ident)
    torch.testing.assert_close(s, s_ref.detach(), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rgb, rgb_ref.detach(), atol=1e-5, rtol=1e-5)
    ref = torch.autograd.grad((s_ref, rgb_ref), w.flat(),
                              (cot[:, :1], cot[:, 1:]))
    got = [t for g in replay_bwd(st, x4, dirs, cot, ident) for t in g]
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, i
        scale = max(float(r.abs().max()), 1e-6)
        assert float((g - r).abs().max()) / scale < 1e-4, i


def test_bg_kernels_replay_with_their_rounding_on_odd_depth():
    """Seven implicit layers (the skip at 3, a hidden width in passes),
    the kernels' bf16 rounding, against the plain pair: the forward at
    CORE_TOLS' sdf and rgb bounds, the gradients at the JAX package's
    bound for its bf16 kernel (K9 with a loss's cotangents)."""
    from test_torch_bwd_replay import grad_check
    icfg = dataclasses.replace(ICFG, dims=(40, 40, 160, 40, 40, 40),
                               skip_in=(3,))
    gen = torch.Generator().manual_seed(3)
    net_i, net_r = mlp.ImplicitNet(icfg, gen), mlp.RenderingNet(RCFG, gen)
    _, _, x4, dirs, _ = bg_case(True, n=600, seed=4)
    st = stages(net_i, net_r)
    assert st.n_imp == 7 and st.imp.plan[3, 5] & mma_pack.SKIP_IN
    w = bg_core.BgWeights.of(net_i, net_r)
    s_ref, rgb_ref = bg_core.bg_core_plain(icfg, RCFG, w, x4, dirs)
    s, rgb = replay_fwd(st, x4, dirs)
    torch.testing.assert_close(s, s_ref.detach(), atol=0.02, rtol=0.02)
    torch.testing.assert_close(rgb, rgb_ref.detach(), atol=0.03, rtol=0.05)
    gen = torch.Generator().manual_seed(5)
    gt = torch.rand(rgb.shape, generator=gen)
    sg, rg = (t.detach().requires_grad_(True) for t in (s_ref, rgb_ref))
    loss = (rg - gt).abs().mean() + 0.2 * (sg ** 2).mean()
    cot = torch.cat(torch.autograd.grad(loss, (sg, rg)), 1)
    ref = torch.autograd.grad((s_ref, rgb_ref), w.flat(),
                              (cot[:, :1], cot[:, 1:]))
    got = [t for g in replay_bwd(st, x4, dirs, cot) for t in g]
    grad_check(got, list(ref))


def test_bg_plan_at_the_bg_config():
    """K9's plan at the bg config's widths and training batch (51,200
    points): regions 1024-byte aligned and disjoint, the ring table's
    weight stages in the order the sweeps take them (a 256-wide forward
    layer's as two copies), stash and mask loads after their waits, the
    jobs' splits covering the blocks; K8's stages in passes of 128."""
    from test_torch_bwd_replay import _check_plan
    icfg = mlp.ImplicitNetConfig(
        feature_vector_size=256, sdf_bounding_sphere=0.0, d_in=4,
        dims=(256,) * 8, skip_in=(4,), geometric_init=False,
        weight_norm=False, embed_type="positional", multires=10)
    rcfg = mlp.RenderingNetConfig(
        feature_vector_size=256, mode="nerf", d_in=3, dims=(128,),
        weight_norm=False, embed_type="positional", multires=4)
    gen = torch.Generator().manual_seed(0)
    st = stages(mlp.ImplicitNet(icfg, gen), mlp.RenderingNet(rcfg, gen))
    imp = st.imp.plan
    assert (st.n_imp, st.n_rad, st.F) == (9, 2, 256)
    assert imp[:, 0].tolist() == [96] + [256] * 7 + [256, 256]
    assert imp[:, 1].tolist() == [256] * 8 + [8, 256]
    assert imp[:, 7].tolist() == [128] * 8 + [0, 128]
    assert imp[3, 2] == 172 and imp[4, 6] == 172
    assert st.rad.plan[:, :2].tolist() == [[288, 128], [128, 8]]
    assert st.timp[:, :3].tolist() == [[272, 256, 256]] + [
        [256, 256, 256]] * 3 + [[256, 256, 172], [176, 256, 256]] + [
        [256, 256, 256]] * 2
    assert st.trad[:, :3].tolist() == [[16, 128, 128], [128, 256, 256]]
    plan = bg_core.BgPlan(st, 51_200)
    assert plan.blocks == 800
    _check_plan(plan, None, None)
    kinds = [int(it[0]) & 255 for it in plan.script]
    # forward: 2 + 7 x 4 chunks in passes, the features' 4; then the
    # radiance net's 5 + 2, its transposes 1 + 2, the implicit ones
    # 5 + 6 x 4 + 3, the mask and eight stash tiles
    assert kinds.count(bg_core._LOAD2) == 2 + 7 * 4 + 4
    assert kinds.count(bg_core._STAGE) == 8
    assert kinds.count(render_core._WAIT) == 1
    assert kinds.count(bg_core._LOAD) == 7 + 3 + 5 + 6 * 4 + 3 + 1 + 8
    assert plan.dims[:9] == [(96, 256), (256, 256), (256, 256), (256, 172),
                             (256, 256), (256, 256), (256, 256), (256, 256),
                             (256, 257)]
    assert plan.dims[9:] == [(288, 128), (128, 3)]
    assert plan.tb == 256 * 7 + 172 + 257 + 128 + 3
    assert plan.regions[REG_DZ][8][1] == 5 * CHUNK
    assert plan.regions[REG_RX][0][1] == 5 * CHUNK
    assert all(plan.regions[REG_Q][l][1] == 4 * CHUNK for l in range(8))
    assert not plan.regions[REG_Q][8][1]


@pytest.mark.parametrize("which", ["pe", "raw", "odd"])
def test_bg_stages_gather_the_packers_bits(which):
    """`BgStages`' chains, gathered through the layout built once for the
    nets' shapes, hold `mma_pack.pack_stage_chain`'s bits of the same
    layers; the transposed chain is packed only when it is first read."""
    icfg = {"pe": ICFG, "raw": ICFG_RAW,
            "odd": dataclasses.replace(ICFG, dims=(40, 40, 160, 40, 40, 40),
                                       skip_in=(3,))}[which]
    gen = torch.Generator().manual_seed(7)
    net_i, net_r = mlp.ImplicitNet(icfg, gen), mlp.RenderingNet(RCFG, gen)
    w = bg_core.BgWeights.of(net_i, net_r)
    st = stages(net_i, net_r)
    assert st._t is None
    with torch.no_grad():
        chains = bg_core._bg_chains(icfg, RCFG, *(
            [t.detach().float() for t in g]
            for g in (w.ws_i, w.bs_i, w.ws_r, w.bs_r)))
    for got, layers, rows in zip((st.imp, st.rad, st.t), chains,
                                 (128, 128, 256)):
        want = mma_pack.pack_stage_chain(layers, rows=rows)
        assert got.weights.dtype == torch.bfloat16
        assert torch.equal(got.weights.view(torch.int16),
                           want.weights.view(torch.int16))
        assert torch.equal(got.biases, want.biases)
        assert np.array_equal(got.plan, want.plan)
    assert np.array_equal(st.t_plan, st.t.plan)


def test_bg_layout_refuses_what_the_kernels_cannot_run():
    net_i, net_r, x4, dirs, cot = bg_case(True, n=4)
    w = bg_core.BgWeights.of(net_i, net_r)
    with pytest.raises(ValueError):
        bg_core.BgStages(dataclasses.replace(net_i.cfg, skip_in=(0,)),
                         net_r.cfg, w)
    with pytest.raises(ValueError):
        bg_core.BgStages(net_i.cfg, dataclasses.replace(
            net_r.cfg, embed_type=None), w)
    st = stages(net_i, net_r)
    with pytest.raises(ValueError):   # the kernel takes CUDA tensors only
        bg_core.bg_core_bwd(st, x4, dirs, cot)
    with pytest.raises(ValueError):   # a layer wider than wgmma's 256
        wide = dataclasses.replace(net_i.cfg, dims=(300, 40))
        bg_core.BgStages(wide, net_r.cfg, bg_core.BgWeights.of(
            mlp.ImplicitNet(wide, torch.Generator().manual_seed(0)), net_r))
