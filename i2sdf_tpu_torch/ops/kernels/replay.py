"""K4 (`csrc/render_core_bwd.cu`), K6 (`csrc/rev_bwd.cu`, which K12 runs),
K5 (`csrc/rev_fwd.cu`) and K10 (`csrc/sdf_outputs.cu`) replayed in torch
from exactly what their wrappers hand the kernels, for the checks that
hold the kernels to a replay of their own rounding (the CPU tests, and the
card's tests and smoke on CUDA tensors).

`K4Replay` follows K4 step by step: K3's stage images and `K4Stages`'
transposed ones read as wgmma reads them, the 64-point tile and the
ring's slots as shared memory written through the kernel's `act_off` and
`f32_at`, the ring table (`K4Plan.script`) consumed item by item (a
stash tile loaded before the wait for the sweep that stored it fails),
the scratch regions the bulk copies fill, the per-block bias rows, the
weight-gradient products reading the operand regions MN-major, and the
split sums. Every shared-memory and scratch element starts as NaN, so a
region read but never written shows up. `RevReplay` is K6: K4's replay
of the SDF sweeps, with the forward recompute stopping at the output
layer's input and `c_out` as the output layer's cotangent. `K5Replay` is
K5: the same forward (no operand stores), the output layer's two
products, and the reverse sweep down to layer 0 gathering d sdf / d PE
in f32, on `rev.K5Plan`'s table. `K10Replay` is K10: K3's tangent form
(`csrc/tangent_form.cuh`) on its two 64-row tiles of 32 points' four
streams, written through `act_off` and read as wgmma reads them, on the
SDF chain's stage images, the sdf and its gradient clamped as the
kernel's epilogue clamps. `rnd` says where a kernel rounds to bf16; the
identity replays the algorithm in f32 on the kernel's bf16 weights.
"""

import functools
import math

import torch

from i2sdf_tpu_torch.models.embedder import positional_encoding
from i2sdf_tpu_torch.ops.activations import softplus_beta
from i2sdf_tpu_torch.ops.kernels import (mma_pack, render_core, rev,
                                         sdf_grad, sdf_outputs)
from i2sdf_tpu_torch.ops.kernels.render_core import (
    REG_AH, REG_CLG, REG_DA, REG_DZ, REG_DZX, REG_LDZ, REG_LS, REG_LX, REG_Q,
    REG_R, REG_RDZ, REG_RX, REG_X)


def bf(t):
    """Rounded to bf16 and back to f32."""
    return t.to(torch.bfloat16).float()


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
        self.hidden = None     # a list to collect each hidden layer's h
        self.pe_lo = True      # K5: layer 0 adds the encoding's low half
        self.blobs = [None, st.sdf.weights.float(),
                      None if st.rad is None else st.rad.weights.float(),
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

    def product(self, row, col0=0):
        """T[:, col0:col0 + K] @ the layer's stage images (slot c holding
        chunk c, N * 128 bytes; col0 a multiple of 64): (B, 64, N) f32."""
        K, N = int(row[0]), int(row[1])
        stages = torch.cat([s[0] for s in self.take_weights(row)])
        a = self.T[:, (col0 // 64) * CHUNK // 2
                   + self.k_major(64, K, CHUNK).flatten()].view(
            self.B, 64, K)
        b = stages[self.k_major(N, K, N * 128)]
        return a @ b.t()

    def fill(self, what, col0, kend, scale=1.0):
        """`fill_T`: what is "x", "dirs", "dge" or "x_lo" (PE(x)'s low
        half, PE - bf16(PE): zero without rounding)."""
        F = self.st.md if what == "dirs" else self.st.mx
        src = self.ds if what == "dirs" else self.xs
        w = kend - col0
        flat = src.reshape(-1, 3)
        v = (dge_cols(flat, self.cot.reshape(-1, 8)[:, :3], F, w)
             if what == "dge" else pe_cols(flat, F, w))
        if what == "x_lo":
            v = v - self.rnd(v)
        self.put(self.T, torch.arange(col0, kend),
                 (v * scale).view(self.B, 64, w))

    def bias(self, p, dz, cols):
        o = self.plan.db[p]
        self.dbrow[:, o:o + cols] = dz[..., :cols].sum(1)

    # ---- the sweeps -----------------------------------------------------------

    def forward_hidden(self, grad=False):
        """`sdf_forward_hidden` (csrc/sdf_sweep.cuh): PE(x) into T, each
        hidden layer's input stored, h into T, q staged (`grad`, K5's: no
        input stored, q in f32 over two slots, and layer 0 on the
        encoding's hi/lo pair, K5's plan's K: the products of the two
        halves summed, the low half's left out with `pe_lo` off)."""
        st, t = self.st, self.t
        fwd, ns = (self.plan.fwd if grad else st.sdf.plan), t.n_sdf
        ch = lambda c: -(-int(c) // 64)  # noqa: E731
        inv = 1.0 / math.sqrt(2.0)
        k0 = int(fwd[0, 0]) - (64 if grad else 0)
        self.fill("x", 0, 64 if grad else k0)
        if grad:
            self.fill("x_lo", 64, 64 + k0)
        for l in range(ns - 1):
            K, N, real, woff, boff, flags, col, _ = (int(v) for v in fwd[l])
            if not grad:
                self.store_T(REG_X, l, ch(K))
            if grad and l == 0:
                row = fwd[0].copy()
                row[0] = k0
                z = self.product(row)
                lo = self.product(row, 64)
                if self.pe_lo:
                    z = z + lo
            else:
                z = self.product(fwd[l])
            z = z + st.sdf.biases[boff:boff + N]
            S = self.take_stage(grad)
            if grad:
                S = torch.cat([S, self.take_stage(True)], 1)
            scale = inv if flags & mma_pack.SCALE else 1.0
            self.put(self.T, torch.arange(N), softplus_beta(z) * scale)
            if self.hidden is not None:
                self.hidden.append(self.get(self.T, torch.arange(N)))
            if grad:
                r_, c_ = torch.arange(64)[:, None], torch.arange(N)[None, :]
                S[:, f32_idx(r_, c_).flatten()] = stash_q(z).reshape(
                    self.B, -1)
            else:
                self.put(S, torch.arange(N), stash_q(z))
            nx = fwd[l + 1]
            if nx[5] & mma_pack.SKIP_IN:
                self.fill("x", int(nx[6]), int(nx[0]), inv)
            if grad:
                self.store(REG_Q, l, S, 2 * SLOT, f32=True)
            else:
                self.store(REG_Q, l, S, ch(N) * CHUNK)

    def run(self):
        st, t = self.st, self.t
        fwd, rad = st.sdf.plan, st.rad.plan
        ns, nr, nl, F = t.n_sdf, t.n_rad, t.n_light, st.F
        out_k = int(t.tsdf[0, 0])
        ch = lambda c: -(-int(c) // 64)  # noqa: E731
        # 1. SDF forward
        self.forward_hidden()
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
        self.backward_sdf()
        return self.products()

    def take_q(self, cols, grad=False):
        """A hidden layer's stash q (B, 64, cols) from the ring: one bf16
        tile, or with `grad` (K5's) two f32 slots in accumulator order."""
        if not grad:
            return self.get(self.take_stash(), torch.arange(cols))
        S = torch.cat([self.take_stash(True), self.take_stash(True)], 1)
        r_, c_ = torch.arange(64)[:, None], torch.arange(cols)[None, :]
        return S[:, f32_idx(r_, c_).flatten()].view(self.B, 64, cols)

    def rev_first(self, grad=False):
        """`rev_first`: r of the last hidden layer, W_last[:, sdf] s, into
        T."""
        fwd, ns = self.st.sdf.plan, self.t.n_sdf
        n_h, N = int(fwd[ns - 2, 2]), 64 * -(-int(fwd[ns - 2, 1]) // 64)
        q = self.take_q(n_h, grad)
        r = self.T.new_zeros((self.B, 64, N))
        r[..., :n_h] = self.t.wsdf[:n_h] * stash_s(q)
        self.put(self.T, torch.arange(N), r)

    def backward_sdf(self):
        """`sdf_backward` (csrc/sdf_sweep.cuh): the reverse, upward and
        downward sweeps once the output layer's cotangent is stored."""
        st, t = self.st, self.t
        fwd, ns, F = st.sdf.plan, t.n_sdf, st.F
        out_k = int(t.tsdf[0, 0])
        ch = lambda c: -(-int(c) // 64)  # noqa: E731
        inv = 1.0 / math.sqrt(2.0)
        # 4. reverse sweep
        onehot = self.T.new_zeros((self.B, 64, 64 * ch(out_k)))
        onehot[..., F] = 1.0
        self.put(self.T, torch.arange(64 * ch(out_k)), onehot)
        self.store_T(REG_R, ns - 1, ch(out_k))
        self.rev_first()
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
        """`wgrad_kernel` and the fixed-order sums: every dW over its
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


class RevReplay(K4Replay):
    """`csrc/rev_bwd.cu` in torch, all blocks at once: K4's replay of the
    SDF sweeps with K6's own start. `c_out` (n, 1 + F) in the net's
    column order; c_g sits in the cotangents' first three columns, as the
    kernel holds it."""

    def __init__(self, k: rev.RevStages, plan, x, c_out, c_g, rnd):
        n = x.shape[0]
        cot = x.new_zeros((n, 8))
        cot[:, :3] = c_g
        super().__init__(k, k, plan, x, torch.zeros_like(x), cot, rnd, True)
        self.c_out = pad_rows(c_out, self.B * 64).view(self.B, 64, -1)

    def run(self):
        k, F = self.st, self.st.F
        ns = k.n_sdf
        ch = lambda c: -(-int(c) // 64)  # noqa: E731
        w = 64 * ch(k.tsdf[0, 0])
        self.forward_hidden()
        self.store_T(REG_X, ns - 1, ch(k.sdf.plan[ns, 0]))
        cy = self.T.new_zeros((self.B, 64, w))
        cy[..., :F] = self.c_out[..., 1:]
        cy[..., F] = self.c_out[..., 0]
        self.put(self.T, torch.arange(w), cy)
        self.bias(ns - 1, cy, F + 1)
        self.store_T(REG_DZ, ns - 1, ch(k.tsdf[0, 0]))
        self.sweep_done()
        self.backward_sdf()
        return self.products()


def emulate_rev_bwd(k: rev.RevStages, x, c_out, c_g, rnd=bf):
    """`csrc/rev_bwd.cu` in torch: (dws, dbs) as the wrapper returns."""
    with torch.no_grad():
        plan = render_core.K4Plan(k, k, x.shape[0], False)
        out = RevReplay(k, plan, x, c_out, c_g, rnd).run()
        return k.unpack_grads(out, plan)


class K5Replay(K4Replay):
    """`csrc/rev_fwd.cu` in torch, all blocks at once, on `RevStages` and
    its `rev.K5Plan`: K4's replay of the forward (no operand stores, the
    q stash in f32 through the ring, layer 0 on the encoding's hi/lo
    pair), the output layer's two products
    (the sdf alone, then the features) written in the net's order [sdf |
    features], and the reverse sweep through the transposed chain down
    to layer 0: on the hidden columns r = scale (r W^T) s into T, the
    encoding's columns (from a row's `col`: a skip's, all of layer 0's)
    of scale (r W^T) added into d sdf / d PE in f32; then the encoding's
    closed-form Jacobian."""

    def __init__(self, k: rev.RevStages, plan, x, rnd):
        super().__init__(k, k, plan, x, torch.zeros_like(x),
                         x.new_zeros((x.shape[0], 8)), rnd, True)
        self.n = x.shape[0]

    def run(self):
        k, F, mx = self.st, self.st.F, self.st.mx
        fwd, tp, ns = k.sdf.plan, k.t.plan, k.n_sdf
        inv = 1.0 / math.sqrt(2.0)
        d0 = 3 + 6 * mx
        self.forward_hidden(grad=True)
        self.sweep_done()
        outs = []
        for row in (fwd[ns - 1], fwd[ns]):
            boff, N = int(row[4]), int(row[1])
            outs.append(self.product(row) + k.sdf.biases[boff:boff + N])
        out = torch.cat([outs[0][..., :1], outs[1][..., :F]], -1)
        self.rev_first(grad=True)
        gpe = self.T.new_zeros((self.B, 64, d0))
        for l in range(ns - 2, -1, -1):
            row = tp[ns - 1 - l]
            acc = self.product(row)
            N, n_h, e0 = acc.shape[-1], int(row[2]), int(row[6])
            scale = inv if row[5] & mma_pack.SCALE else 1.0
            a = acc * scale
            lo, hi = max(e0, 0), min(e0 + d0, N)
            if lo < hi:
                gpe[..., lo - e0:hi - e0] = gpe[..., lo - e0:hi - e0] \
                    + a[..., lo:hi]
            if l > 0:
                q = self.take_q(n_h, grad=True)
                r = torch.zeros_like(a)
                r[..., :n_h] = a[..., :n_h] * stash_s(q)
                self.put(self.T, torch.arange(N), r)
        assert self.pos == len(self.items), "ring items left over"
        x = self.xs
        grad = gpe[..., :3].clone()
        for j in range(mx):
            f = 2.0 ** j
            gs = gpe[..., 3 + j:3 + 3 * mx:mx]
            gc = gpe[..., 3 + 3 * mx + j::mx]
            grad = grad + f * (gs * torch.cos(x * f) - gc * torch.sin(x * f))
        return (out.reshape(-1, F + 1)[:self.n],
                grad.reshape(-1, 3)[:self.n])


def emulate_rev_fwd(k: rev.RevStages, x, rnd=bf):
    """`csrc/rev_fwd.cu` in torch: (out, grad) as the wrapper returns."""
    with torch.no_grad():
        return K5Replay(k, rev.K5Plan(k, x.shape[0]), x, rnd).run()


def stream_row(s, p):
    """K3's and K10's row of stream s (0 the activations, 1-3 d/dx_k) of
    point p, in tile 0 (s < 2) or tile 1 (`csrc/tangent_form.cuh`)."""
    return 16 * (p // 8) + p % 8 + 8 * (s % 2)


class K10Replay:
    """`csrc/sdf_outputs.cu` in torch, all blocks of 32 points at once: the
    two tiles of 64 rows x 256 columns are shared memory (bf16 elements
    held as f32, NaN where nothing was written), the epilogues write
    through `act_off`, every product reads the tiles and the layer's stage
    images as wgmma reads its descriptors. The encoding and its tangents
    go in at layer 0 and, scaled by 1/sqrt(2), at the skip; each hidden
    layer writes h = softplus(z) and t_k = softplus'(z) (t_k W), scaled at
    a skip's input, over its own input; the sdf product over both tiles
    gives sdf and d sdf / d x, the features product over tile 0 the
    features, both f32. `rnd` is where the kernel rounds to bf16."""

    def __init__(self, k: sdf_outputs.OutputStages, icfg, x, rnd):
        self.k, self.icfg, self.rnd = k, icfg, rnd
        self.B = B = -(-max(x.shape[0], 1) // 32)
        self.xs = pad_rows(x, B * 32).view(B, 32, 3)
        self.T = torch.full((B, 2, 4 * CHUNK // 2), float("nan"),
                            device=x.device)
        self.w = k.sdf.weights.float()
        pts = torch.arange(32)
        self.rows = [stream_row(s, pts) for s in range(4)]

    def put_streams(self, cols, vals):
        """bf16 stores of the four streams' (B, 32, len(cols)) values."""
        cols = torch.as_tensor(cols)
        for s, v in enumerate(vals):
            off = act_off(self.rows[s][:, None], cols[None, :]) // 2
            self.T[:, s // 2, off.flatten()] = self.rnd(v).reshape(
                self.B, -1)

    def pe(self, col0, kend, scale):
        """`pe_streams`: scale * PE(x) and scale * d PE / d x_k in columns
        [col0, kend), zero past the encoding's."""
        flat, w, mx = self.xs.reshape(-1, 3), kend - col0, self.k.mx
        eye = torch.eye(3, device=flat.device)
        vals = [pe_cols(flat, mx, w)] + [
            dge_cols(flat, eye[j].expand_as(flat), mx, w) for j in range(3)]
        self.put_streams(torch.arange(col0, kend),
                         [(v * scale).view(self.B, 32, w) for v in vals])

    def product(self, i, tiles):
        """Layer i's product over each tile, summed 16 deep at a time as
        wgmma's steps take it: (B, 64, N) f32 each."""
        K, N, woff = (int(v) for v in self.k.sdf.plan[i, [0, 1, 3]])
        stages = self.w[woff:woff + -(-K // 64) * N * 64]
        b = stages[K4Replay.k_major(N, K, N * 128)]
        idx = K4Replay.k_major(64, K, CHUNK).flatten()
        outs = []
        for t in tiles:
            a = self.T[:, t, idx].view(self.B, 64, K)
            acc = a[..., :16] @ b[:, :16].t()
            for k0 in range(16, K, 16):
                acc = acc + a[..., k0:k0 + 16] @ b[:, k0:k0 + 16].t()
            outs.append(acc)
        return outs

    def run(self):
        k, icfg = self.k, self.icfg
        plan, bias = k.sdf.plan, k.sdf.biases
        r0, r1, r2, r3 = self.rows
        inv = 1.0 / math.sqrt(2.0)
        nh = k.sdf.n_layers - 2
        self.pe(0, int(plan[0, 0]), 1.0)
        for i in range(nh):
            K, N, real, woff, boff, flags, col, _ = (int(v)
                                                     for v in plan[i])
            a0, a1 = self.product(i, (0, 1))
            z = a0[:, r0] + bias[boff:boff + N]
            scale = inv if flags & mma_pack.SCALE else 1.0
            ds = sdf_grad.dsoftplus(z) * scale
            self.put_streams(torch.arange(N), [
                softplus_beta(z) * scale, ds * a0[:, r1], ds * a1[:, r2],
                ds * a1[:, r3]])
            nx = plan[i + 1]
            if nx[5] & mma_pack.SKIP_IN:
                self.pe(int(nx[6]), int(nx[0]), inv)
        s0, s1 = self.product(nh, (0, 1))
        sdf = s0[:, r0, 0] + bias[int(plan[nh, 4])]
        grad = torch.stack([s0[:, r1, 0], s1[:, r2, 0], s1[:, r3, 0]], -1)
        (af,) = self.product(nh + 1, (0,))
        boff = int(plan[nh + 1, 4])
        feat = (af[:, r0] + bias[boff:boff + af.shape[-1]])[..., :k.F]
        if icfg.sdf_bounding_sphere > 0:
            x, sc = self.xs, icfg.sphere_scale
            norm = torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
                              + x[..., 2] * x[..., 2])
            sphere = sc * (icfg.sdf_bounding_sphere - norm)
            take = sphere < sdf
            ginv = -sc / torch.clamp(norm, min=1e-12)
            grad = torch.where(take[..., None], x * ginv[..., None], grad)
            sdf = torch.where(take, sphere, sdf)
        return sdf[..., None], feat, grad


def emulate_sdf_outputs(k: sdf_outputs.OutputStages, icfg, x, rnd=bf,
                        chunk: int = 1 << 16):
    """`csrc/sdf_outputs.cu` in torch: (sdf (N, 1), feat (N, F), grad (N,
    3)) as the wrapper returns them, `chunk` points (whole blocks) at a
    time."""
    outs = []
    with torch.no_grad():
        for xc in x.split(chunk):
            o = K10Replay(k, icfg, xc, rnd).run()
            outs.append([t.reshape(-1, t.shape[-1])[:xc.shape[0]]
                         for t in o])
    return tuple(torch.cat(t) for t in zip(*outs))
