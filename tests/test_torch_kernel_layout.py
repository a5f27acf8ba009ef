"""The host side of the CUDA kernels, checked on the CPU.

The kernels themselves run only on the card, but the weight packing and
the per-layer plans they read are built in Python. This file replays the
kernels' algorithm in torch from exactly what the wrappers hand them (the
packed bf16 weights, padded biases, plan rows, row strides), with bf16
rounding where the kernels round and NaN in every shared-memory column
no layer has written, and holds the result to the plain version at the
kernels' tolerances. A wrong offset, width, skip column, scale flag or
padding shows up here before any chip run. The sampler round's
lane-chunked f32 scans are replayed the same way.

K1 and K3 (`csrc/wgmma_layer.cuh`) are replayed byte by byte: their
activation tiles and ring slots are flat buffers of shared memory, the
epilogues write through the kernels' `act_off`, and every product reads
its operands as wgmma reads a 128-byte-swizzle K-major descriptor (8-row
groups 1024 bytes apart, the hardware's XOR of address bits [4, 7) with
[7, 10)), from stage images copied in whole as the bulk copies do. So the
host's swizzle, the descriptors' offsets and the four-stream row
arrangement are held against each other, not against a second copy of
one formula.
"""

import dataclasses
import math
import types

import numpy as np
import pytest
import torch

from i2sdf_tpu_torch.models import mlp
from i2sdf_tpu_torch.models.embedder import positional_encoding
from i2sdf_tpu_torch.ops.activations import softplus_beta
from i2sdf_tpu_torch.ops.kernels import (mma_pack, render_core, sdf_grad,
                                         sdf_mlp)

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


# ---- K1 and K3 on the wgmma layer (csrc/wgmma_layer.cuh) -------------------

CHUNK_BYTES = 64 * 128


def act_off(row, col):
    """The kernels' `act_off`: byte offset of (row, col) in a tile."""
    row, col = torch.as_tensor(row), torch.as_tensor(col)
    return ((col // 64) * CHUNK_BYTES + row * 128
            + (((col // 8) % 8) ^ (row % 8)) * 16 + (col % 8) * 2)


def smem(nbytes):
    """A stretch of shared memory as bf16 values (f32 tensor, NaN: never
    written)."""
    return torch.full((nbytes // 2,), float("nan"))


def put(mem, base, rows, cols, vals):
    """bf16 stores of vals[i, j] at (rows[i], cols[j]) of the tile at
    byte `base` (rows, cols 1-d)."""
    off = base + act_off(rows[:, None], cols[None, :])
    mem[off // 2] = bf(vals)


def wgmma_read(mem, start, rows):
    """The 16-deep operand a descriptor at byte `start` gives wgmma: rows
    x 16 bf16, K-major, 128-byte swizzle, 8-row groups 1024 bytes apart."""
    r = torch.arange(rows)[:, None]
    k = torch.arange(16)[None, :]
    addr = start + (r // 8) * 1024 + (r % 8) * 128 + k * 2
    return mem[(addr ^ (((addr >> 7) & 7) << 4)) // 2]


def stage_images(pm: mma_pack.PackedMlp, i: int):
    """Layer i's stage images, in the order the producer copies them: a
    list per pass of kStageRows rows (plan field 7; one pass of N rows if
    0), of one flat slot's worth per 64-deep chunk."""
    K, N, woff, R = (int(v) for v in pm.plan[i, [0, 1, 3, 7]])
    R = R or N
    size, C = R * 64, -(-K // 64)
    return [[pm.weights[woff + (q * C + c) * size:
                        woff + (q * C + c + 1) * size].float()
             for c in range(C)] for q in range(N // R)]


def products(pm, i, tiles, b_row0=0, nw=None, q=0):
    """`products` of csrc/wgmma_layer.cuh for pass q of layer i: each A
    tile (mem, byte base) @ the stage rows [b_row0, b_row0 + nw), chunk
    by chunk, 16 deep at a time; (64, nw) f32 per tile."""
    K = int(pm.plan[i, 0])
    slots = stage_images(pm, i)[q]
    nw = slots[0].numel() // 64 if nw is None else nw
    accs = [torch.zeros((64, nw)) for _ in tiles]
    for c, slot in enumerate(slots):
        for ks in range(min(4, (K - 64 * c) // 16)):
            B = wgmma_read(slot, b_row0 * 128 + 32 * ks, nw)
            for acc, (mem, base) in zip(accs, tiles):
                acc += wgmma_read(mem, base + c * CHUNK_BYTES + 32 * ks,
                                  64) @ B.t()
    return accs


def pe_block(x, F, width, scale=1.0):
    """scale * PE(x)'s first `width` columns, zero past 3 + 6F."""
    return pe_cols(x, F, width) * scale


def emulate_sdf_mlp(p: sdf_mlp.SdfMlpPack, x):
    """K1 (csrc/sdf_mlp.cu), a 64-row warpgroup tile at a time."""
    pm, F = p.kernel, p.net.cfg.multires
    out = []
    for xb in x.split(64):
        xb = torch.cat([xb, torch.zeros((64 - xb.shape[0], 3))])
        mem, rows = smem(4 * CHUNK_BYTES), torch.arange(64)
        K0 = int(pm.plan[0, 0])
        put(mem, 0, rows, torch.arange(K0), pe_block(xb, F, K0))
        for i in range(pm.n_layers):
            K, N, real, woff, boff, flags, col, _ = (int(v)
                                                     for v in pm.plan[i])
            acc = torch.cat([products(pm, i, [(mem, 0)], q=q)[0]
                             for q in range(len(stage_images(pm, i)))], 1)
            z = acc + pm.biases[boff:boff + N]
            if i == pm.n_layers - 1:
                out.append(z[:, 0])
                break
            nxt = pm.plan[i + 1]
            skip = bool(nxt[5] & mma_pack.SKIP_IN)
            limit = int(nxt[6]) if skip else N
            scale = INV_SQRT2 if flags & mma_pack.SCALE else 1.0
            put(mem, 0, rows, torch.arange(limit),
                (softplus_beta(z) * scale)[:, :limit])
            if skip:
                put(mem, 0, rows, torch.arange(limit, int(nxt[0])),
                    pe_block(xb, F, int(nxt[0]) - limit, INV_SQRT2))
    return torch.cat(out)[:x.shape[0]]


def stream_row(s, p):
    """K3's row of stream s (0 the activations, 1-3 d/dx_k) of point p,
    in tile 0 (s < 2) or tile 1 (csrc/render_core.cu)."""
    return 16 * (p // 8) + p % 8 + 8 * (s % 2)


K3_TILE0, K3_TILE1 = 5 * CHUNK_BYTES, 4 * CHUNK_BYTES


def emulate_render_core(k: render_core.CoreStages, x, dirs):
    """K3 (csrc/render_core.cu) on its stage images, 32 points a block:
    (sdf (N, 1), grad (N, 3), rgb (N, 3)) and with a light head the mask
    (N, 1). The two warpgroups' column halves together are the whole
    product, so it is taken whole."""
    n, F = x.shape[0], k.F
    pts = torch.arange(32)
    rows = [stream_row(s, pts) for s in range(4)]
    outs = []
    for xb, db in zip(x.split(32), dirs.split(32)):
        pad = torch.zeros((32 - xb.shape[0], 3))
        xb, db = torch.cat([xb, pad]), torch.cat([db, pad])
        mem = smem(K3_TILE0 + K3_TILE1)
        bases = (0, 0, K3_TILE0, K3_TILE0)   # the stream's tile

        def put_streams(cols, vals):
            for s in range(4):
                put(mem, bases[s], rows[s], cols, vals[s])

        def pe4(col0, kend, scale):
            width = kend - col0
            t = sdf_grad.embed_tangents(
                types.SimpleNamespace(embed_type="positional",
                                      multires=k.mx), xb)
            tan = torch.zeros((3, 32, width))
            d = min(width, t.shape[-1])
            tan[:, :, :d] = t[:, :, :d]
            put_streams(torch.arange(col0, kend),
                        [pe_block(xb, k.mx, width, scale)]
                        + [tan[j] * scale for j in range(3)])

        sdf = k.sdf
        nh = sdf.n_layers - 2
        pe4(0, int(sdf.plan[0, 0]), 1.0)
        for i in range(nh):
            K, N, real, woff, boff, flags, col, _ = (int(v)
                                                     for v in sdf.plan[i])
            a0, a1 = products(sdf, i, [(mem, 0), (mem, K3_TILE0)])
            st = [a0[rows[0]], a0[rows[1]], a1[rows[2]], a1[rows[3]]]
            z = st[0] + sdf.biases[boff:boff + N]
            scale = INV_SQRT2 if flags & mma_pack.SCALE else 1.0
            ds = sdf_grad.dsoftplus(z) * scale
            nxt = sdf.plan[i + 1]
            skip = bool(nxt[5] & mma_pack.SKIP_IN)
            limit = int(nxt[6]) if skip else N
            put_streams(torch.arange(limit),
                        [(softplus_beta(z) * scale)[:, :limit]]
                        + [(ds * t)[:, :limit] for t in st[1:]])
            if skip:
                pe4(limit, int(nxt[0]), INV_SQRT2)
        b8 = sdf.biases[int(sdf.plan[nh, 4])]
        s0, s1 = products(sdf, nh, [(mem, 0), (mem, K3_TILE0)])
        (af,) = products(sdf, nh + 1, [(mem, 0)])
        feat = (af + sdf.biases[int(sdf.plan[nh + 1, 4]):][:af.shape[1]])[
            rows[0], :F]
        o = [s0[rows[0], :1] + b8,
             torch.stack([s0[rows[1], 0], s1[rows[2], 0], s1[rows[3], 0]],
                         -1)]
        put(mem, 0, rows[0], torch.arange(F), feat)
        if k.light is not None:
            put(mem, K3_TILE0, rows[0], torch.arange(F), torch.relu(feat))
            kl = int(k.light.plan[0, 0])
            put(mem, K3_TILE0, rows[0], torch.arange(F, kl),
                torch.zeros((32, kl - F)))
        kr = int(k.rad.plan[0, 0])
        put(mem, 0, rows[0], torch.arange(F, kr), pe_block(db, k.md, kr - F))
        for name, pm, base in (("rad", k.rad, 0),
                               ("light", k.light, K3_TILE0)):
            if pm is None:
                continue
            for i in range(pm.n_layers):
                K, N, real, woff, boff, *_ = (int(v) for v in pm.plan[i])
                (acc,) = products(pm, i, [(mem, base)])
                z = (acc + pm.biases[boff:boff + N])[rows[0]]
                if i == pm.n_layers - 1:
                    o.append(torch.sigmoid(z[:, :real]))
                else:
                    put(mem, base, rows[0], torch.arange(N),
                        torch.relu(z) if name == "rad" else softplus_beta(z))
        outs.append(o)
    return tuple(torch.cat(t)[:n] for t in zip(*outs))


def unswizzle(pm: mma_pack.PackedMlp, i: int):
    """Layer i's W^T (N x K) read back from its stage images the way wgmma
    reads them, pass by pass."""
    K = int(pm.plan[i, 0])
    return torch.cat([
        torch.cat([wgmma_read(slot, 32 * ks, slot.numel() // 64)
                   for slot in slots for ks in range(4)], 1)[:, :K]
        for slots in stage_images(pm, i)])


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
# the light config with an odd number of SDF hidden layers (5: a fault
# that exchanges two tangent streams at every layer cancels over an even
# depth), for the card's tests
LIGHT_ODD = {"odd": ((256, 3, 256, 256, 6, 4), 5, 3, (128,))}


def _points(n, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(n, 3)) * 0.8).astype(np.float32))
    d = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)), dim=-1)
    return x, d


def _k1_pack(net):
    p = sdf_mlp.SdfMlpPack.__new__(sdf_mlp.SdfMlpPack)
    p.net, p.kernel = net, sdf_mlp.stage_chain(net)
    return p


@pytest.mark.parametrize("case", list(CASES))
def test_sdf_mlp_plan_replays_to_plain(case):
    """K1's replay (a ragged last tile: 200 = 3 x 64 + 8 rows)."""
    width, skip, feat, rad, mx, md = CASES[case]
    net, _ = _nets(width, skip, feat, rad, mx, md)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(200, 3)).astype(np.float32))
    got = emulate_sdf_mlp(_k1_pack(net), x)
    ref = sdf_mlp.sdf_mlp_plain(net, x)
    torch.testing.assert_close(got, ref, atol=0.02, rtol=0.02)


CORE_TOLS = {"sdf": (0.02, 0.02), "grad": (0.05, 0.08), "rgb": (0.03, 0.05),
             "lmask": (0.02, 0.03)}


def _core_close(got, ref):
    assert len(got) == len(ref)
    for (name, (atol, rtol)), g, r in zip(CORE_TOLS.items(), got, ref):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, r, atol=atol, rtol=rtol, msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_render_core_plan_replays_to_plain(case):
    """K3's four-stream replay against the plain op at CORE_TOLS (200
    points: six blocks of 32 and a ragged one)."""
    width, skip, feat, rad, mx, md = CASES[case]
    net, rnet = _nets(width, skip, feat, rad, mx, md)
    k = render_core.CoreStages(net.cfg, rnet.cfg,
                               render_core.CoreWeights.of(net, rnet))
    x, d = _points(200, 2)
    _core_close(emulate_render_core(k, x, d),
                render_core.render_core_plain(net, rnet, x, d))


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
    k = render_core.CoreStages(
        net.cfg, rnet.cfg, render_core.CoreWeights.of(net, rnet, lnet),
        lnet.cfg)
    assert k.n_light == len(ldims) + 1 and k.sdf.n_layers == depth + 2
    x, d = _points(200, 3)
    _core_close(emulate_render_core(k, x, d),
                render_core.render_core_plain(net, rnet, x, d, lnet))
    # K4's transposed chains of the same nets fit its kernel's widths
    k4 = render_core.K4Stages(
        net.cfg, rnet.cfg, render_core.CoreWeights.of(net, rnet, lnet),
        lnet.cfg)
    assert (k4.n_sdf, k4.n_light) == (depth + 1, len(ldims) + 1)
    assert int(k4.t.plan[:, 1].max()) <= render_core._K3_WIDTH


# ---- K10 on K3's tangent form (csrc/sdf_outputs.cu) ------------------------

# the nets K10's replay is held on: K3's narrow and flagship nets (sphere
# 0), the narrow net with a bounding sphere of 1.2 (the eikonal points'
# cube [-4, 4]^3 reaches past it: both sides of the clamp), and a net with
# no encoding (run as frequency count 0) and a sphere
K10_NETS = ("narrow", "narrow_sphere", "no_pe", "flagship")


def _k10_net(case):
    if case == "no_pe":
        cfg = mlp.ImplicitNetConfig(feature_vector_size=8,
                                    sdf_bounding_sphere=1.5, dims=(32, 32),
                                    geometric_init=False)
        return mlp.ImplicitNet(cfg, torch.Generator().manual_seed(0))
    name = "narrow" if case == "narrow_sphere" else case
    width, skip, feat, rad, mx, md = CASES[name]
    net, _ = _nets(width, skip, feat, rad, mx, md)
    if case == "narrow_sphere":
        net.cfg = dataclasses.replace(net.cfg, sdf_bounding_sphere=1.2)
    return net


def _k10_pack(net):
    from i2sdf_tpu_torch.ops.kernels import sdf_outputs
    lins = net.layers()
    with torch.no_grad():
        return sdf_outputs.OutputStages(net.cfg, [l.weight() for l in lins],
                                        [l.b for l in lins])


@pytest.mark.parametrize("case", list(CASES))
def test_k10_pack_is_k3_sdf_chain(case):
    """K10's pack (`OutputStages`, gathered through a layout built once)
    holds K3's SDF stage chain of the same net byte for byte."""
    width, skip, feat, rad, mx, md = CASES[case]
    net, rnet = _nets(width, skip, feat, rad, mx, md)
    k3 = render_core.CoreStages(net.cfg, rnet.cfg,
                                render_core.CoreWeights.of(net, rnet))
    k10 = _k10_pack(net)
    assert k10.sdf.weights.dtype == k3.sdf.weights.dtype == torch.bfloat16
    assert torch.equal(k10.sdf.weights.view(torch.int16),
                       k3.sdf.weights.view(torch.int16))
    assert torch.equal(k10.sdf.biases, k3.sdf.biases)
    assert np.array_equal(k10.sdf.plan, k3.sdf.plan)
    assert (k10.F, k10.mx) == (k3.F, k3.mx)


def test_k10_replay_is_k3_emulation():
    """K10's replay (`replay.K10Replay`, all blocks at once) gives K3's
    emulation's sdf and gradient (`emulate_render_core`, block by block)
    to the bit on the same SDF net: the same tangent form on the same
    stage images (sphere 0: no clamp)."""
    from i2sdf_tpu_torch.ops.kernels import replay
    net, rnet = _nets(*CASES["narrow"])
    k3 = render_core.CoreStages(net.cfg, rnet.cfg,
                                render_core.CoreWeights.of(net, rnet))
    x, d = _points(70, 4)
    sdf, grad, _ = emulate_render_core(k3, x, d)
    sdf10, feat10, grad10 = replay.emulate_sdf_outputs(_k10_pack(net),
                                                       net.cfg, x)
    assert torch.equal(sdf10, sdf) and torch.equal(grad10, grad)
    assert feat10.shape == (70, CASES["narrow"][2])


@pytest.mark.parametrize("case", K10_NETS)
def test_k10_replay_without_rounding_is_the_plain_op(case):
    """K10's replay with no rounding of its activations is the plain op
    (`sdf_outputs_plain`'s sweep and clamp) on the pack's bf16 weights, to
    f32 rounding (1e-5 of each output's largest entry): 70 eikonal points,
    two blocks and a ragged one."""
    from i2sdf_tpu_torch.ops.kernels import replay
    from test_torch_rev_replay import eikonal_points
    net = _k10_net(case)
    x = eikonal_points(70, 7)
    lins = net.layers()
    with torch.no_grad():
        ws = [bf(l.weight()) for l in lins]
        out, grad = sdf_grad.sdf_tangents(net.cfg, ws, [l.b for l in lins],
                                          x)
        sdf, grad = render_core._sphere_clamp(net.cfg, x, out[:, :1], grad)
    got = replay.emulate_sdf_outputs(_k10_pack(net), net.cfg, x,
                                     rnd=lambda t: t)
    for name, g, r in zip(("sdf", "feat", "grad"), got,
                          (sdf, out[:, 1:], grad)):
        assert g.shape == r.shape, name
        torch.testing.assert_close(g, r, rtol=0,
                                   atol=1e-5 * float(r.abs().max()),
                                   msg=name)
    if net.cfg.sdf_bounding_sphere > 0:  # both sides of the clamp
        share = float(((sdf[:, 0] - net.cfg.sphere_scale * (
            net.cfg.sdf_bounding_sphere - x.norm(dim=-1))).abs()
            < 1e-6).float().mean())
        assert 0.0 < share < 1.0


def _expect_wt(w, K, N):
    """W^T zero-padded to (N, K), bf16."""
    out = torch.zeros((N, K))
    out[:w.shape[1], :w.shape[0]] = bf(w.t())
    return out


ALL_CASES = {**{f"core_{c}": (v, 8, 4, ()) for c, v in CASES.items()},
             **{f"light_{c}": v for c, v in LIGHT_CASES.items()}}


@pytest.mark.parametrize("case", list(ALL_CASES))
def test_stage_images_unswizzle_to_wt(case):
    """Every stage image, read back as wgmma reads it, is W^T of its layer:
    K1's chain with the output cut to the sdf column, K3's hidden layers
    (the skip's rows where the encoding enters), its output layer as the
    sdf alone and the features of [features | sdf], the radiance input's
    rows as [features | PE(dirs)], and the light net."""
    (width, skip, feat, rad, mx, md), depth, rdepth, ldims = ALL_CASES[case]
    net, rnet = _nets(width, skip, feat, rad, mx, md, depth=depth,
                      rdepth=rdepth)
    lnet = light_net(feat, ldims) if ldims else None
    ws = [lin.weight().detach() for lin in net.layers()]
    wr = [lin.weight().detach() for lin in rnet.layers()]
    k1 = sdf_mlp.stage_chain(net)
    k3 = render_core.CoreStages(
        net.cfg, rnet.cfg, render_core.CoreWeights.of(net, rnet, lnet),
        None if lnet is None else lnet.cfg)
    vdim = rnet.cfg.layer_dims()[0] - feat
    perm = list(range(1, feat + 1)) + [0]
    want = {"k1": ws[:-1] + [ws[-1][:, :1]],
            "sdf": ws[:-1] + [ws[-1][:, :1], ws[-1][:, perm][:, :feat]],
            "rad": [wr[0][list(range(vdim, vdim + feat))
                          + list(range(vdim))]] + wr[1:],
            "light": ([lin.weight().detach() for lin in lnet.layers()]
                      if lnet is not None else [])}
    skips = [i for i in range(len(ws)) if i in net.cfg.skip_in]
    assert skips and all(k1.plan[i, 5] & mma_pack.SKIP_IN for i in skips)
    for name, pm in (("k1", k1), ("sdf", k3.sdf), ("rad", k3.rad),
                     ("light", k3.light)):
        if pm is None:
            continue
        assert pm.n_layers == len(want[name]), name
        for i, w in enumerate(want[name]):
            K, N = int(pm.plan[i, 0]), int(pm.plan[i, 1])
            assert K == mma_pack.round_up(w.shape[0], 16), (name, i)
            assert N in mma_pack.WG_WIDTHS and N >= w.shape[1], (name, i)
            torch.testing.assert_close(unswizzle(pm, i), _expect_wt(w, K, N),
                                       atol=0, rtol=0, msg=f"{name} {i}")


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
