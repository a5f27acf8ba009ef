"""K4 (`csrc/render_core_bwd.cu`) replayed in torch from exactly what its
wrapper hands the kernel, and held to the plain backward (autograd of
`render_core_train_plain`).

`emulate_bwd` (`K4Replay`) follows the kernel step by step: K3's stage
images and `K4Stages`' transposed ones read as wgmma reads them, the
64-point tile and the ring's slots as shared memory written through the
kernel's `act_off` and `f32_at`, the ring table (`K4Plan.script`)
consumed item by item (a stash tile loaded before the wait for the sweep
that stored it fails), the scratch regions the bulk copies fill, the
per-block bias rows, the weight-gradient products reading the operand
regions MN-major, the split sums and the wrapper's un-permutation. Every
shared-memory and scratch element starts as NaN, so a region read but
never written shows up. `rnd` says where the kernel rounds to bf16:

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

import functools
import math

import numpy as np
import pytest
import torch

from i2sdf_tpu_torch.models import mlp
from i2sdf_tpu_torch.ops.activations import softplus_beta
from i2sdf_tpu_torch.ops.kernels import mma_pack, render_core
from i2sdf_tpu_torch.models.embedder import positional_encoding
from i2sdf_tpu_torch.ops.kernels.render_core import (
    REG_AH, REG_CLG, REG_DA, REG_DZ, REG_DZX, REG_LDZ, REG_LS, REG_LX, REG_Q,
    REG_R, REG_RDZ, REG_RX, REG_X)
from test_torch_kernel_layout import LIGHT_CASES, LIGHT_ODD, bf, light_net

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


def dge_cols(x, cg, F, width):
    """dg_emb = (c_grad Sel^T) * d PE / dx in the encoding's columns (c_grad,
    then c_grad_i f cos(f x_i), -c_grad_i f sin(f x_i)), zero-padded."""
    f = 2.0 ** torch.arange(F, dtype=torch.float32, device=x.device)
    xf = x[:, :, None] * f
    g = torch.cat([cg, (cg[:, :, None] * f * torch.cos(xf)).reshape(len(x), -1),
                   (-cg[:, :, None] * f * torch.sin(xf)).reshape(len(x), -1)],
                  1)
    out = x.new_zeros((x.shape[0], width))
    out[:, :min(width, g.shape[1])] = g[:, :width]
    return out


def stash_q(z):
    t = 100 * z
    q = 1 / (1 + torch.exp(t.abs()))
    v = torch.where(t > 0, -q, q)
    return torch.where(t > 20, torch.full_like(z, -0.0), v)


def stash_s(v):
    return torch.where(torch.signbit(v), 1 + v, v)


def stash_d2(v):
    return 100 * v.abs() * (1 - v.abs())


CHUNK = 64 * 128     # bytes of a 64-row chunk of 64 bf16 columns
SLOT = 4 * CHUNK     # a ring slot


def act_off(row, col):
    """The kernels' `act_off` (csrc/wgmma_layer.cuh): byte offset of (row,
    col) in a tile of 64-column chunks."""
    return ((col // 64) * CHUNK + row * 128
            + (((col // 8) % 8) ^ (row % 8)) * 16 + (col % 8) * 2)


def swizzle(addr):
    """The hardware's 128-byte swizzle: address bits [4, 7) XOR [7, 10)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def f32_idx(row, col):
    """`f32_at` (csrc/render_core_bwd.cu): the float index of (row, col) in
    an f32 tile of two slots, in accumulator order."""
    j = col // 8
    return ((j >= 16) * (SLOT // 4)
            + ((((j % 16) * 4 + row // 16) * 2 + (row // 8) % 2) * 32
               + (row % 8) * 4 + (col // 2) % 4) * 2 + col % 2)


class K4Replay:
    """`csrc/render_core_bwd.cu` in torch, all blocks at once: the tile T and
    the ring's slots are shared memory (bf16 elements held as f32, NaN
    where nothing was written), the epilogues write through `act_off` and
    `f32_at`, every product reads its operands as wgmma reads its
    descriptors (K-major from T and the stage images; the weight-gradient
    products MN-major from the operand regions), the producer's ring table
    (`K4Plan.script`) is consumed item by item, and the scratch regions
    hold what the bulk copies move. `rnd` is where the kernel rounds to
    bf16 (the identity replays the algorithm in f32 on the bf16 weights).
    A load must come after a wait for the sweep that stored it."""

    def __init__(self, st, t, plan, x, dirs, cot, rnd, detach_light):
        self.st, self.t, self.plan, self.rnd = st, t, plan, rnd
        self.B = B = plan.blocks
        P = B * 64
        dev = x.device
        self.xs = pad_rows(x, P).view(B, 64, 3)
        self.ds = pad_rows(dirs, P).view(B, 64, 3)
        self.cot = pad_rows(cot, P, 8).view(B, 64, 8)
        self.T = torch.full((B, 5 * CHUNK // 2), float("nan"), device=dev)
        self.scr = {}          # region offset -> (B, bf16 or f32 values)
        self.stored_in = {}    # region offset -> the sweep that stored it
        self.items = [tuple(int(v) for v in it) for it in plan.script]
        self.pos = 0
        self.done = self.waited = 0
        self.dbrow = torch.full((B, plan.tb), float("nan"), device=dev)
        self.coupled = bool(st.n_light) and not detach_light
        self.blobs = [None, st.sdf.weights.float(), st.rad.weights.float(),
                      None if st.light is None else st.light.weights.float(),
                      t.t.weights.float()]

    # ---- shared memory ----------------------------------------------------

    def put(self, mem, cols, vals, rows=None):
        """bf16 stores of vals (B, 64, len(cols)) at `act_off`."""
        rows = torch.arange(64) if rows is None else rows
        off = act_off(rows[:, None], torch.as_tensor(cols)[None, :]) // 2
        mem[:, off.flatten()] = self.rnd(vals).reshape(self.B, -1)

    def get(self, mem, cols):
        off = act_off(torch.arange(64)[:, None],
                      torch.as_tensor(cols)[None, :]) // 2
        return mem[:, off.flatten()].view(self.B, 64, -1)

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def k_major(rows, K, chunk_bytes):
        """Element index of (row, k) for k < K of a K-major operand whose
        64-deep chunks sit `chunk_bytes` apart, as wgmma reads it 16 deep
        at a time (a descriptor at byte c * chunk_bytes + 32 ks: 128-byte
        swizzle, 8-row groups 1024 bytes apart): (rows, K) int64."""
        r = torch.arange(rows)[:, None]
        kk = torch.arange(K)[None, :]
        start = (kk // 64) * chunk_bytes + ((kk % 64) // 16) * 32
        addr = swizzle(start + (r // 8) * 1024 + (r % 8) * 128
                       + (kk % 16) * 2)
        return addr // 2

    # ---- the ring -----------------------------------------------------------

    def _next(self):
        while self.items[self.pos][0] == 2:   # a wait: those sweeps stored
            assert self.items[self.pos][1] <= self.done
            self.waited = self.items[self.pos][1]
            self.pos += 1
        it = self.items[self.pos]
        self.pos += 1
        return it

    def take_weights(self, row):
        """A layer's stage images (one item per 64-deep chunk), each (1, N *
        64) as its slot holds it."""
        K, N, woff = int(row[0]), int(row[1]), int(row[3])
        slots = []
        for c in range(-(-K // 64)):
            kind, off, stride, nbytes = self._next()
            base = kind >> 8
            assert kind & 255 == 0 and base >= 1 and stride == 0
            assert (off, nbytes) == (2 * woff + c * N * 128, N * 128)
            slots.append(self.blobs[base][off // 2:(off + nbytes) // 2][None])
        return slots

    def take_stash(self, f32=False):
        kind, off, stride, nbytes = self._next()
        assert kind == 0
        base = max(o for o in self.scr if o <= off)
        assert self.stored_in[base] < self.waited, "loaded before its wait"
        data = self.scr[base]
        u = 4 if f32 else 2
        return data[:, (off - base) // u:(off - base + nbytes) // u]

    def take_stage(self, f32=False):
        kind = self._next()[0]
        assert kind == 1
        return torch.full((self.B, SLOT // (4 if f32 else 2)), float("nan"),
                          device=self.T.device)

    def store(self, kind, l, mem, nbytes, f32=False, extra=0):
        off, stride = self.plan.regions[kind][l]
        assert nbytes + extra <= stride
        region = self.scr.setdefault(off, torch.full(
            (self.B, stride // (4 if f32 else 2)), float("nan"),
            device=self.T.device))
        u = 4 if f32 else 2
        region[:, extra // u:(extra + nbytes) // u] = mem[:, :nbytes // u]
        self.stored_in[off] = self.done

    def store_T(self, kind, l, chunks):
        self.store(kind, l, self.T, chunks * CHUNK)

    def sweep_done(self):
        self.done += 1

    # ---- products -------------------------------------------------------------

    def product(self, row):
        """T[:, :K] @ the layer's stage images (slot c holding chunk c,
        N * 128 bytes): (B, 64, N) f32."""
        K, N = int(row[0]), int(row[1])
        stages = torch.cat([s[0] for s in self.take_weights(row)])
        a = self.T[:, self.k_major(64, K, CHUNK).flatten()].view(
            self.B, 64, K)
        b = stages[self.k_major(N, K, N * 128)]
        return a @ b.t()

    def fill(self, what, col0, kend, scale=1.0):
        F = self.st.md if what == "dirs" else self.st.mx
        src = self.ds if what == "dirs" else self.xs
        w = kend - col0
        flat = src.reshape(-1, 3)
        v = (dge_cols(flat, self.cot.reshape(-1, 8)[:, :3], F, w)
             if what == "dge" else pe_cols(flat, F, w))
        self.put(self.T, torch.arange(col0, kend),
                 (v * scale).view(self.B, 64, w))

    def bias(self, p, dz, cols):
        o = self.plan.db[p]
        self.dbrow[:, o:o + cols] = dz[..., :cols].sum(1)

    # ---- the sweeps -----------------------------------------------------------

    def run(self):
        st, t, rnd = self.st, self.t, self.rnd
        fwd, rad = st.sdf.plan, st.rad.plan
        ns, nr, nl, F = t.n_sdf, t.n_rad, t.n_light, st.F
        out_k = int(t.tsdf[0, 0])
        ch = lambda c: -(-int(c) // 64)  # noqa: E731
        inv = 1.0 / math.sqrt(2.0)
        # 1. SDF forward
        self.fill("x", 0, int(fwd[0, 0]))
        qs = {}
        for l in range(ns - 1):
            K, N, real, woff, boff, flags, col, _ = (int(v) for v in fwd[l])
            self.store_T(REG_X, l, ch(K))
            z = self.product(fwd[l]) + st.sdf.biases[boff:boff + N]
            S = self.take_stage()
            scale = inv if flags & mma_pack.SCALE else 1.0
            self.put(self.T, torch.arange(N), softplus_beta(z) * scale)
            self.put(S, torch.arange(N), stash_q(z))
            nx = fwd[l + 1]
            if nx[5] & mma_pack.SKIP_IN:
                self.fill("x", int(nx[6]), int(nx[0]), inv)
            self.store(REG_Q, l, S, ch(N) * CHUNK)
        row = fwd[ns]
        self.store_T(REG_X, ns - 1, ch(row[0]))
        z = self.product(row) + st.sdf.biases[int(row[4]):int(row[4])
                                               + int(row[1])]
        self.put(self.T, torch.arange(F), z[..., :F])
        self.sweep_done()
        # 1b. the light head
        if nl:
            self.light_head()
        # 2. radiance forward
        self.fill("dirs", F, int(rad[0, 0]))
        for l in range(nr):
            K, N, real, woff, boff, *_ = (int(v) for v in rad[l])
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
        dz[..., :d_out] = self.cot[..., 4:4 + d_out] * rgb * (1 - rgb)
        self.put(self.T, torch.arange(64), dz)
        self.bias(ns + nr - 1, dz, d_out)
        for l in range(nr - 1, 0, -1):
            self.store_T(REG_RDZ, l, ch(rad[l, 1]))
            dh = self.product(t.trad[nr - 1 - l])
            N = dh.shape[-1]
            M = self.get(self.take_stash(), torch.arange(N))
            dz = torch.where(M > 0, dh, torch.zeros_like(dh))
            self.put(self.T, torch.arange(N), dz)
            self.bias(ns + l - 1, dz, int(rad[l - 1, 2]))
        self.store_T(REG_RDZ, 0, ch(rad[0, 1]))
        cf = self.product(t.trad[nr - 1])[..., :F]
        if self.coupled:
            g0, g1 = self.take_stash(True), self.take_stash(True)
            g = torch.cat([g0, g1], 1)
            r_, c_ = torch.arange(64)[:, None], torch.arange(F)[None, :]
            cf = cf + g[:, f32_idx(r_, c_).flatten()].view(self.B, 64, F)
        cy = self.T.new_zeros((self.B, 64, 320))
        cy[..., :F] = cf
        cy[..., F] = self.cot[..., 3]
        self.put(self.T, torch.arange(320), cy)
        self.bias(ns - 1, cy, F + 1)
        self.store_T(REG_DZ, ns - 1, ch(out_k))
        # 4. reverse sweep
        onehot = self.T.new_zeros((self.B, 64, 64 * ch(out_k)))
        onehot[..., F] = 1.0
        self.put(self.T, torch.arange(64 * ch(out_k)), onehot)
        self.store_T(REG_R, ns - 1, ch(out_k))
        Q = self.take_stash()
        n_h, N = int(fwd[ns - 2, 2]), 64 * ch(fwd[ns - 2, 1])
        r = self.T.new_zeros((self.B, 64, N))
        r[..., :n_h] = (t.wsdf[:n_h]
                        * stash_s(self.get(Q, torch.arange(n_h))))
        self.put(self.T, torch.arange(N), r)
        for l in range(ns - 2, 0, -1):
            self.store_T(REG_R, l, ch(fwd[l, 1]))
            row = t.tsdf[ns - 1 - l]
            acc = self.product(row)
            N, n_h = acc.shape[-1], int(row[2])
            scale = inv if row[5] & mma_pack.SCALE else 1.0
            Q = self.take_stash()
            Sa, Sb = self.take_stage(True), self.take_stage(True)
            hid = torch.arange(N, device=acc.device) < n_h
            a = torch.where(hid, acc * scale, torch.zeros_like(acc))
            S = torch.cat([Sa, Sb], 1)
            r_, c_ = torch.arange(64)[:, None], torch.arange(N)[None, :]
            S[:, f32_idx(r_, c_).flatten()] = a.reshape(self.B, -1)
            q = self.get(Q, torch.arange(min(N, n_h)))
            rr = torch.zeros_like(a)
            rr[..., :n_h] = a[..., :n_h] * stash_s(q)
            self.put(self.T, torch.arange(N), rr)
            self.store(REG_AH, l, S, 2 * SLOT, f32=True)
        self.store_T(REG_R, 0, ch(fwd[0, 1]))
        self.sweep_done()
        # 5-6. upward sweep
        self.fill("dge", 0, 64 * ch(fwd[0, 0]))
        for l in range(ns - 1):
            K, N, n_h, woff, boff, flags, col, _ = (int(v) for v in fwd[l])
            self.store_T(REG_DA, l, ch(K))
            dr = self.product(fwd[l])
            Q = self.take_stash()
            q = self.get(Q, torch.arange(n_h))
            if l < ns - 2:
                ah = torch.cat([self.take_stash(True),
                                self.take_stash(True)], 1)
                r_, c_ = torch.arange(64)[:, None], torch.arange(n_h)[None, :]
                ah = ah[:, f32_idx(r_, c_).flatten()].view(self.B, 64, n_h)
            else:
                ah = t.wsdf[:n_h]
            S = self.take_stage()
            scale = inv if flags & mma_pack.SCALE else 1.0
            da = torch.zeros_like(dr)
            dzx = torch.zeros_like(dr)
            da[..., :n_h] = dr[..., :n_h] * stash_s(q) * scale
            dzx[..., :n_h] = dr[..., :n_h] * ah * stash_d2(q)
            self.put(self.T, torch.arange(N), da)
            self.put(S, torch.arange(N), dzx)
            nx = fwd[l + 1 if l + 1 < ns - 1 else ns]
            if nx[5] & mma_pack.SKIP_IN:
                self.fill("dge", int(nx[6]), int(nx[0]), inv)
            self.store(REG_DZX, l, S, ch(N) * CHUNK)
        self.store_T(REG_DA, ns - 1, ch(fwd[ns, 0]))
        self.sweep_done()
        # 7. downward sweep
        off, _ = self.plan.regions[REG_DZ][ns - 1]
        self.T[:, :ch(out_k) * CHUNK // 2] = self.scr[off][
            :, :ch(out_k) * CHUNK // 2]
        for l in range(ns - 1, 0, -1):
            if l < ns - 1:
                self.store_T(REG_DZ, l, ch(fwd[l, 1]))
            row = t.tsdf[ns - 1 - l]
            v = self.product(row)
            N, n_h = v.shape[-1], int(row[2])
            scale = inv if row[5] & mma_pack.SCALE else 1.0
            q = self.get(self.take_stash(), torch.arange(n_h))
            x = self.get(self.take_stash(), torch.arange(n_h))
            dz = torch.zeros_like(v)
            dz[..., :n_h] = v[..., :n_h] * scale * stash_s(q) + x
            self.put(self.T, torch.arange(N), dz)
            self.bias(l - 1, dz, int(fwd[l - 1, 2]))
        self.store_T(REG_DZ, 0, ch(fwd[0, 1]))
        assert self.pos == len(self.items), "ring items left over"
        return self.products()

    def light_head(self):
        st, t = self.st, self.t
        light, ns, nr, nl, F = st.light.plan, t.n_sdf, t.n_rad, t.n_light, st.F
        ch = lambda c: -(-int(c) // 64)  # noqa: E731
        self.store_T(REG_RX, 0, ch(F))
        k0 = int(light[0, 0])
        feat = self.get(self.T, torch.arange(F))
        lin = self.T.new_zeros((self.B, 64, k0))
        lin[..., :F] = torch.relu(feat)
        self.put(self.T, torch.arange(k0), lin)
        for l in range(nl):
            K, N, real, woff, boff, *_ = (int(v) for v in light[l])
            self.store_T(REG_LX, l, ch(K))
            z = self.product(light[l]) + st.light.biases[boff:boff + N]
            if l < nl - 1:
                S = self.take_stage()
                self.put(self.T, torch.arange(N), softplus_beta(z))
                s = torch.where(100 * z > 20, torch.ones_like(z),
                                torch.sigmoid(100 * z))
                self.put(S, torch.arange(N), s)
                self.store(REG_LS, l, S, ch(N) * CHUNK)
            else:
                lm = torch.sigmoid(z[..., :1])
                dz = self.T.new_zeros((self.B, 64, 64))
                dz[..., :1] = self.cot[..., 7:8] * lm * (1 - lm)
                self.put(self.T, torch.arange(64), dz)
                self.bias(ns + nr + l, dz, real)
        self.sweep_done()
        for l in range(nl - 1, 0, -1):
            self.store_T(REG_LDZ, l, ch(light[l, 1]))
            dh = self.product(t.tlight[nl - 1 - l])
            N = dh.shape[-1]
            s = self.get(self.take_stash(), torch.arange(N))
            dz = dh * s
            self.put(self.T, torch.arange(N), dz)
            self.bias(ns + nr + l - 1, dz, int(light[l - 1, 2]))
        self.store_T(REG_LDZ, 0, ch(light[0, 1]))
        if self.coupled:
            cl = self.product(t.tlight[nl - 1])
            N = cl.shape[-1]
            X = self.get(self.take_stash(), torch.arange(N))
            S = torch.cat([self.take_stage(True), self.take_stage(True)], 1)
            r_, c_ = torch.arange(64)[:, None], torch.arange(N)[None, :]
            S[:, f32_idx(r_, c_).flatten()] = torch.where(
                X > 0, cl, torch.zeros_like(cl)).reshape(self.B, -1)
            self.store(REG_CLG, 0, S, 2 * SLOT, f32=True)
        self.sweep_done()
        off, _ = self.plan.regions[REG_RX][0]
        self.T[:, :ch(F) * CHUNK // 2] = self.scr[off][:, :ch(F) * CHUNK // 2]

    def operand(self, kind, l, cols):
        """An operand region as the products read it (MN-major: 64-column
        atoms one chunk apart): (B, 64 points, cols)."""
        off, stride = self.plan.regions[kind][l]
        k = torch.arange(64)[:, None]
        m = torch.arange(cols)[None, :]
        addr = swizzle((m // 64) * CHUNK + k * 128 + (m % 64) * 2)
        return self.scr[off][:, (addr // 2).flatten()].view(self.B, 64, cols)

    def products(self):
        """`k4_wgrad_kernel` and the fixed-order sums: every dW over its
        operand pairs and point ranges, then the blocks' bias rows."""
        plan = self.plan
        out = torch.full((plan.n_out,), float("nan"), device=self.T.device)
        kinds = {REG_X: REG_DZ, REG_DA: REG_R, REG_RX: REG_RDZ,
                 REG_LX: REG_LDZ}
        for p, row in enumerate(plan.jobs):
            (pairs, K, N, ka, nblk, per, splits, o) = (
                int(row[9]), int(row[10]), int(row[11]), int(row[12]),
                int(row[13]), int(row[14]), int(row[15]), int(row[16]))
            offs = {plan.regions[k][l][0]: (k, l)
                    for k in kinds for l in range(16)
                    if plan.regions[k][l][1]}
            part = 0
            for q in range(pairs):
                ka_, la = offs[int(row[q])]
                A = self.operand(ka_, la, K)
                Bm = self.operand(kinds[ka_], la, N)
                assert not (torch.isnan(A).any() or torch.isnan(Bm).any()), p
                parts = [(A[s * per:(s + 1) * per].transpose(-1, -2)
                          @ Bm[s * per:(s + 1) * per]).sum(0)
                         for s in range(splits)]
                part = part + torch.stack(parts)
            out[o:o + K * N] = part.sum(0).reshape(-1)
        assert not torch.isnan(self.dbrow).any()
        out[plan.out_db:] = self.dbrow.sum(0)
        return out


def pad_rows(t, rows, cols=None):
    out = t.new_zeros((rows, cols or t.shape[1]))
    out[:t.shape[0], :t.shape[1]] = t
    return out


def k4_pack(icfg, rcfg, w, lcfg=None):
    """K3's pack and K4's transposed chains of the weights `w`."""
    with torch.no_grad():
        return (render_core.CoreStages(icfg, rcfg, w, lcfg),
                render_core.K4Stages(icfg, rcfg, w, lcfg))


def emulate_bwd(icfg, rcfg, w, x, dirs, cot, rnd=bf, detach_light=True,
                lcfg=None):
    """K4 in torch from what its wrapper hands it (the packs of `w`, its
    `K4Plan`); returns what the wrapper returns. `rnd` is where the kernel
    rounds to bf16 (activations, cotangents, everything it stores as
    bf16); the identity replays the same algorithm in f32 on the kernel's
    bf16 weights. With a light head (`lcfg`), c_lm is the cotangents'
    column 7."""
    st, t = k4_pack(icfg, rcfg, w, lcfg)
    coupled = lcfg is not None and not detach_light
    with torch.no_grad():
        plan = render_core.K4Plan(st, t, x.shape[0], coupled)
        out = K4Replay(st, t, plan, x, dirs, cot, rnd, detach_light).run()
        return render_core.unpack_grads(st, t, out, plan)


def nets(width, skip, feat, rad, mx, md, seed=0, device="cpu", depth=8):
    """The SDF net (`depth` hidden layers) and radiance net of a case."""
    gen = torch.Generator().manual_seed(seed)
    icfg = mlp.ImplicitNetConfig(
        feature_vector_size=feat, sdf_bounding_sphere=0.0,
        dims=(width,) * depth, skip_in=(skip,), bias=0.6,
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


def light_layout(case, device="cpu", seed=0):
    """The nets and kernel layout of a `LIGHT_CASES` case."""
    (width, skip, feat, rad, mx, md), depth, rdepth, ldims = {
        **LIGHT_CASES, **LIGHT_ODD}[case]
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
