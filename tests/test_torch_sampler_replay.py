"""K2 (`csrc/sampler_round.cu`) replayed in f32 torch in the kernel's own
order, and held to the plain round (`models/sampler.round_update`) and to
the JAX package's Pallas kernel (`sampler_round_pallas`, interpret mode);
K7 (`csrc/conv_check.cu`) replayed as K2's beta0 evaluation alone
(`replay_conv`), and held to K2's decision and to `converged_rays`.

`replay_round` follows the kernel's group of 128 threads a ray: each
thread's E = ceil(S / 128) consecutive samples, its sequential f32 sums,
the warp scan of the thread totals as the shuffles add them (Hillis-Steele
steps 1, 2, 4, 8, 16, then shifted up one lane), the warps' totals added
in warp order, the warp sums as the xor butterfly adds them, the warps'
sums and maxima in warp order, the CDF's offsets by the same scan made
nondecreasing by the running max over the group, the binary search. Its
betas and draws are held to the plain round at the card's K2 tolerances
(`tests/test_torch_gpu_kernels.py::test_sampler_round_kernel`: beta rtol
1e-4 / atol 1e-6; draws p99 < 0.08, max < 0.5, ray mean < 0.02) and to the
Pallas kernel at the JAX package's (`test_torch_parity_sampler.py`), and
its CDF must be exactly nondecreasing. One case puts the surface before
the ray's last sample, whose free energy is 1e10 times a density: the
kernel leaves it out of every sum, as the plain round's transmittance
does.
"""

import jax  # noqa: F401  (the Pallas kernel runs on JAX's CPU backend)
import numpy as np
import pytest
import torch

from i2sdf_tpu.ops.pallas.sampler_round import sampler_round_pallas
from i2sdf_tpu_torch.models import sampler as tsampler

THREADS, LANES = 128, 32
WARPS = THREADS // LANES
CFG = tsampler.SamplerConfig(eps=0.1, beta_iters=10, add_tiny=1e-6)


def warp_excl_scan(v):
    """(..., 128) -> the exclusive scan over each warp's lanes, as the
    kernel's shuffles add it, and each warp's total (..., 4)."""
    w = v.reshape(*v.shape[:-1], WARPS, LANES)
    incl = w.clone()
    o = 1
    while o < LANES:
        incl[..., o:] = incl[..., o:] + incl[..., :-o].clone()
        o <<= 1
    excl = torch.zeros_like(incl)
    excl[..., 1:] = incl[..., :-1]
    return excl.reshape(v.shape), incl[..., -1]


def group_excl_scan(v):
    """The group's exclusive scan: the warp scan plus the earlier warps'
    totals, added in warp order."""
    excl, tot = warp_excl_scan(v)
    off = torch.zeros_like(tot)
    for w in range(1, WARPS):
        acc = torch.zeros_like(tot[..., 0])
        for u in range(w):
            acc = acc + tot[..., u]
        off[..., w] = acc
    return (off[..., :, None] + excl.reshape(*excl.shape[:-1], WARPS, LANES)
            ).reshape(v.shape)


def group_sum(v):
    """Each warp's xor-butterfly sum, then the warps' sums in order."""
    w = v.reshape(*v.shape[:-1], WARPS, LANES)
    lane = torch.arange(LANES)
    o = 16
    while o:
        w = w + w[..., lane ^ o]
        o >>= 1
    s = torch.zeros_like(w[..., 0, 0])
    for u in range(WARPS):
        s = s + w[..., u, 0]
    return s


def replay_sections(z, sdf):
    """K2's (and K7's) `Sections` of each ray: (sec, E, pad, prefixes,
    bound), thread t of the group holding samples [t E, t E + E) (`sec`
    (128, E): which are sections); `prefixes(bt)` each thread's free-energy
    and d*-term prefixes with the group's offsets, and `bound(bt)` the
    group's max over the sections of the error bound (`error_bound`), at
    (R,) betas."""
    R, S = z.shape
    E = -(-S // THREADS)
    pad = THREADS * E + 1
    zp = torch.zeros((R, pad))
    sp = torch.zeros((R, pad))
    zp[:, :S], sp[:, :S] = z, sdf
    j = torch.arange(THREADS * E).view(THREADS, E)
    sec = j < S - 1                                     # (128, E)
    zj, zn = zp[:, j], zp[:, j + 1]
    s0, s1 = sp[:, j], sp[:, j + 1]
    d = torch.where(sec, zn - zj, torch.zeros(()))
    d2 = d * d
    a, b, c = d, s0.abs(), s1.abs()
    first = a * a + b * b <= c * c
    second = a * a + c * c <= b * b
    h = (a + b + c) / 2
    area = h * (h - a) * (h - b) * (h - c)
    tri = ~first & ~second & (b + c - a > 0)
    heron = torch.nan_to_num(2 * torch.sqrt(torch.clamp(area, min=0))
                             / torch.clamp(a, min=1e-12),
                             posinf=torch.finfo(torch.float32).max)
    ds = (torch.where(first & ~second, b, 0) + torch.where(second, c, 0)
          + torch.where(tri, heron, 0))
    ds = torch.where(torch.sign(s1) * torch.sign(s0) != 1, 0, ds)
    ds = torch.where(sec, ds, torch.zeros(()))
    sg, ab = torch.sign(s0), s0.abs()

    def prefixes(bt):
        ib = 1 / bt[:, None, None]
        q = 0.25 * ib * ib
        dens = ib * (0.5 + 0.5 * sg * torch.expm1(-ab * ib))
        fe = torch.where(sec, d * dens, torch.zeros(()))
        rt_k = torch.where(sec, torch.exp(-ds * ib) * d2 * q, torch.zeros(()))
        e_ex = torch.zeros_like(fe)
        r_in = torch.zeros_like(fe)
        et = torch.zeros_like(fe[..., 0])
        rt = torch.zeros_like(fe[..., 0])
        for k in range(E):
            e_ex[..., k] = et
            et = et + fe[..., k]
            rt = rt + rt_k[..., k]
            r_in[..., k] = rt
        eo, ro = group_excl_scan(et), group_excl_scan(rt)
        return fe, e_ex, r_in, eo[..., None], ro[..., None]

    def bound(bt):
        _, e_ex, r_in, eo, ro = prefixes(bt)
        m = (torch.clamp(torch.exp(ro + r_in), max=1e6) - 1) * torch.exp(
            -(eo + e_ex))
        m = torch.where(sec, m, torch.full_like(m, -torch.inf))
        return m.amax((-1, -2))

    return sec, E, pad, prefixes, bound


def replay_conv(z, sdf, beta0, cfg=CFG):
    """K7's flags (R,) as the kernel computes them: K2's beta0 evaluation
    alone (`error_bound(q, beta0) <= eps`)."""
    *_, bound = replay_sections(z, sdf)
    return bound(beta0.expand(z.shape[0])) <= cfg.eps


def replay_round(z, sdf, beta, beta0, u, final, cfg=CFG):
    """(samples (R, n_out), beta (R,), cdf (R, S)) as K2 computes them."""
    R, S = z.shape
    sec, E, pad, prefixes, bound = replay_sections(z, sdf)
    beta = torch.where(bound(beta0.expand(R)) <= cfg.eps, beta0, beta)
    lo, hi = beta0.expand(R), beta
    for _ in range(cfg.beta_iters):
        mid = 0.5 * (lo + hi)
        ok = bound(mid) <= cfg.eps
        hi, lo = torch.where(ok, mid, hi), torch.where(ok, lo, mid)
    beta = hi
    fe, e_ex, r_in, fo, ro = prefixes(beta)
    trans = torch.exp(-(fo + e_ex))
    if final:
        p = (1 - torch.exp(-fe)) * trans + 1e-5
    else:
        p = (torch.clamp(torch.exp(ro + r_in), max=1e6) - 1) * trans \
            + cfg.add_tiny
    p = torch.where(sec, p, torch.zeros(()))
    tot = torch.zeros_like(p[..., 0])
    for k in range(E):
        tot = tot + p[..., k]
    total = group_sum(tot)[:, None, None]
    pdf = torch.where(total > 0, p / torch.clamp(total, min=1e-30),
                      torch.full_like(p, 1 / (S - 1)))
    pdf = torch.where(sec, pdf, torch.zeros(()))
    loc = torch.zeros_like(pdf)
    lt = torch.zeros_like(pdf[..., 0])
    for k in range(E):
        lt = lt + pdf[..., k]
        loc[..., k] = lt
    vals = group_excl_scan(lt)[..., None] + loc
    # a thread's sections come first, so its last value is its last
    # section's (the kernel's `last`)
    last = torch.where(sec.any(-1), vals[..., -1],
                       torch.full_like(lt, -torch.inf))
    carry = torch.cummax(last, -1).values          # max is exact: any order
    excl = torch.full_like(carry, -torch.inf)
    excl[:, 1:] = carry[:, :-1]
    vals = torch.maximum(vals, excl[..., None])
    cdf = torch.zeros((R, pad))
    flat = vals.reshape(R, -1)
    keep = sec.reshape(-1)
    cdf[:, 1:][:, keep] = flat[:, keep]
    cdf = cdf[:, :S]
    below_n = torch.searchsorted(cdf.contiguous(), u.contiguous(),
                                 right=True)
    below = torch.clamp(below_n - 1, min=0)
    above = torch.clamp(below_n, max=S - 1)
    c0, c1 = cdf.gather(-1, below), cdf.gather(-1, above)
    denom = torch.where(c1 - c0 < 1e-5, torch.ones_like(c0), c1 - c0)
    z0, z1 = z.gather(-1, below), z.gather(-1, above)
    return z0 + (u - c0) / denom * (z1 - z0), beta, cdf


def _inputs(R, S, n_out, seed, last_inside=False):
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(0.0, 6.0, (R, S)), axis=-1).astype(np.float32)
    wall = 3.0 if not last_inside else 2.0
    sdf = (wall - z + 0.1 * rng.normal(size=(R, S))).astype(np.float32)
    beta = rng.uniform(0.05, 0.8, (R,)).astype(np.float32)
    u = np.sort(rng.uniform(0.0, 1.0, (R, n_out)), -1).astype(np.float32)
    return z, sdf, beta, u


def _close_draws(s, ref, p99=0.08, mx=0.5, mean=0.02):
    diff = (s - ref).abs()
    assert float(torch.quantile(diff.flatten(), 0.99)) < p99
    assert float(diff.max()) < mx
    torch.testing.assert_close(s.mean(-1), ref.mean(-1), rtol=0, atol=mean)


@pytest.mark.parametrize("S,final,last_inside", [
    (2, False, False), (97, True, False), (128, False, False),
    (480, False, False), (480, True, True), (600, True, False),
    (1024, False, True)])
def test_k2_replay_matches_round_update(S, final, last_inside):
    z, sdf, beta, u = (torch.from_numpy(a) for a in _inputs(
        24, S, 64, S, last_inside))
    beta0 = torch.tensor(0.1)
    s, b, cdf = replay_round(z, sdf, beta, beta0, u, final)
    s_ref, b_ref = tsampler.round_update(CFG, z, sdf, beta, beta0, u, final)
    torch.testing.assert_close(b, b_ref, rtol=1e-4, atol=1e-6)
    _close_draws(s, s_ref)
    assert bool((cdf[:, 1:] >= cdf[:, :-1]).all())   # exactly nondecreasing
    assert cdf[:, 0].eq(0).all() and torch.isfinite(cdf).all()
    if last_inside:   # the last sample lies past the wall: 1e10 * density
        dens = (1 / b_ref) * (0.5 + 0.5 * torch.sign(sdf[:, -1]) * torch.expm1(
            -sdf[:, -1].abs() / b_ref))
        assert float((1e10 * dens).min()) > 1e9


@pytest.mark.parametrize("final", [False, True])
def test_k2_replay_matches_pallas_interpret(final):
    z, sdf, beta, u = _inputs(16, 128, 24, 7)
    s_ker, b_ker = sampler_round_pallas(
        z, sdf, beta, u, 0.1, beta_iters=CFG.beta_iters, eps=CFG.eps,
        add_tiny=CFG.add_tiny, final=final, block_rows=8, interpret=True)
    s, b, _ = replay_round(*(torch.from_numpy(a) for a in (z, sdf, beta)),
                           torch.tensor(0.1), torch.from_numpy(u), final)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ker), rtol=2e-2,
                               atol=1e-3)
    _close_draws(s, torch.from_numpy(np.array(s_ker)))


def test_group_scan_and_sums():
    """The replay's group scan and sums: exact on integers (the kernel's
    association changes no exact sum), and within f32 rounding of the
    sequential f64 sums on random values."""
    ints = torch.arange(THREADS, dtype=torch.float32)[None]
    assert group_sum(ints)[0] == float(ints.sum())
    assert torch.equal(group_excl_scan(ints)[0],
                       torch.cumsum(ints[0], 0) - ints[0])
    v = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (3, THREADS)).astype(np.float32))
    ref = torch.cumsum(v.double(), -1) - v.double()
    torch.testing.assert_close(group_excl_scan(v).double(), ref, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(group_sum(v).double(), v.double().sum(-1),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("S", [416, 480])
def test_k7_replay_is_k2s_beta0_decision(S):
    """K7 replayed as K2's beta0 evaluation (`replay_conv`): its flag is
    K2's replayed decision to keep beta0 (beta out == beta0 from a beta in
    above it) on every ray, and it agrees with the plain check
    (`converged_rays`) and with the f64 bound wherever the f64 bound is
    more than 1e-4 relative from eps, fewer than 1 % of the rays lying in
    that band; both flags appear."""
    R = 64
    rng = np.random.default_rng(S)
    z64 = torch.from_numpy(np.sort(rng.uniform(0.0, 6.0, (R, S)), -1))
    s64 = ((torch.from_numpy(rng.uniform(1.0, 8.0, (R, 1))) - z64)
           * torch.from_numpy(rng.uniform(0.3, 1.0, (R, 1)))
           + torch.from_numpy(rng.uniform(0.0, 0.05, (R, 1))
                              * rng.normal(size=(R, S))))
    z, sdf = z64.float(), s64.float()
    u = torch.linspace(0, 1, 8).expand(R, 8).contiguous()
    in_band, seen = 0, set()
    for b0 in (0.02, 0.05, 0.2):
        beta0 = torch.tensor(b0)
        flags = replay_conv(z, sdf, beta0)
        _, b, _ = replay_round(z, sdf, torch.full((R,), 1.0), beta0, u,
                               False)
        assert torch.equal(flags, b == beta0)
        d_star, dists = tsampler._d_star(z64, s64)
        bound = tsampler._error_bound(torch.tensor(b0, dtype=torch.float64),
                                      s64, dists, d_star)
        outside = (bound - CFG.eps).abs() > 1e-4 * CFG.eps
        plain = tsampler.converged_rays(CFG, z, sdf, beta0)
        assert bool(((flags == plain) | ~outside).all())
        assert bool(((flags == (bound <= CFG.eps)) | ~outside).all())
        in_band += int((~outside).sum())
        seen |= set(flags.tolist())
    assert in_band < 0.01 * 3 * R
    assert seen == {True, False}
