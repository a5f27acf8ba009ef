"""K10/K11's arithmetic replayed in torch: the tangent sweep with bf16
rounding where the kernels round (the encoding and its tangents, each
layer's weights, activations and tangents; f32 sums), JAX-free.

* with no rounding the replay is the plain sweep (`sdf_grad.sdf_tangents`);
* with bf16 rounding it shows what the kernels' operand type costs: at the
  flagship net at perturbed weights (v + 0.01 N(0, 1), the `gpu` tests'
  net) and 4,800 eikonal points, the gradient's error against the f32
  plain op reaches the JAX bound for its tangent kernels
  (`tests/test_pallas_outputs.py:39-49`: atol 0.05, rtol 0.08), and the
  bf16 rounding of the weights alone is most of it; against the plain op
  at the same bf16 weights the replay keeps inside the bound.

So at perturbed weights the `gpu` tests and `chip_smoke.py` hold K10 and
K11 to the plain op at the bf16 weights, the kernels' own operands (the
JAX package's own kernel lands past the f32 bound there too:
tests/test_torch_parity_sdf_grad.py). `replay_tangent_bwd` replays K12,
the `gpu` tests hold it to that replay.
"""

import math

import pytest
import torch

from i2sdf_tpu_torch.models import mlp
from i2sdf_tpu_torch.ops.kernels import sdf_grad
from test_torch_rev_replay import (FLAGSHIP, NARROW, eikonal_points,
                                   flat_weights, loss_cotangents, sdf_net)

ATOL, RTOL = 0.05, 0.08  # the JAX bound on the gradient


def bf(t):
    return t.to(torch.bfloat16).float()


def keep(t):
    return t


def bf16_weights(ws):
    """The weights as the kernels multiply them (biases stay f32)."""
    return [bf(w) for w in ws]


def replay_tangent_fwd(icfg, ws, bs, x, rnd=bf, rnd_w=None):
    """(out (N, 1 + F), grad (N, 3)) as K10/K11 compute them, unclamped:
    `rnd` rounds the encoding, its tangents and every layer's outputs,
    `rnd_w` the weights (default `rnd`); products and sums in f32."""
    rnd_w = rnd if rnd_w is None else rnd_w
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    emb, t_emb = icfg.embed(x), sdf_grad.embed_tangents(icfg, x)
    h, t = rnd(emb), rnd(t_emb)
    last = len(ws) - 1
    for l, (w, b) in enumerate(zip(ws, bs)):
        w = rnd_w(w)
        if l in icfg.skip_in:
            h = torch.cat([h, rnd(emb * inv_sqrt2)], -1)
            t = torch.cat([t, rnd(t_emb * inv_sqrt2)], -1)
        z, tz = h @ w + b, t @ w
        if l == last:
            return z, tz[..., 0].T
        scale = inv_sqrt2 if l + 1 in icfg.skip_in else 1.0
        h = rnd(mlp.softplus_beta(z, 100.0) * scale)
        t = rnd(sdf_grad.dsoftplus(z) * scale * tz)


def stash_q(z, rnd):
    """K12's stash of softplus'(z): sigmoid(-|100 z|) with z's sign
    (`stash_q` in csrc/common.cuh), rounded; returns (s, 1 - s)."""
    t = 100.0 * z
    q = rnd(torch.where(t > 20.0, torch.zeros_like(z),
                        torch.sigmoid(-t.abs())))
    pos = t > 0.0
    return torch.where(pos, 1.0 - q, q), torch.where(pos, q, 1.0 - q)


def replay_tangent_bwd(icfg, ws, bs, x, c_out, c_g, rnd=bf):
    """K12's (dws, dbs): the tangent sweep staging each layer's input [h ;
    t] (rounded) and its stash, then per layer in reverse dz = scale s dh +
    100 (1 - s) sum_k r_k T_k and rho_k = scale s r_k (T_k the next
    layer's staged tangent input), the products over the four streams'
    rounded operands in f32 (the output layer's rho_k, c_g[k] in the sdf
    column, unrounded), db from the f32 dz."""
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    dims = icfg.layer_dims()
    d0, n = dims[0], len(ws)
    wr = [rnd(w) for w in ws]
    emb, t_emb = icfg.embed(x), sdf_grad.embed_tangents(icfg, x)
    h, t = rnd(emb), rnd(t_emb)
    H, T, S = [], [], []
    for l in range(n):
        if l in icfg.skip_in:
            h = torch.cat([h, rnd(emb * inv_sqrt2)], -1)
            t = torch.cat([t, rnd(t_emb * inv_sqrt2)], -1)
        H.append(h)
        T.append(t)
        if l == n - 1:
            break
        z, tz = h @ wr[l] + bs[l], t @ wr[l]
        scale = inv_sqrt2 if l + 1 in icfg.skip_in else 1.0
        S.append(stash_q(z, rnd))
        h = rnd(mlp.softplus_beta(z, 100.0) * scale)
        t = rnd(sdf_grad.dsoftplus(z) * scale * tz)
    dz = c_out
    rho = c_out.new_zeros((3,) + c_out.shape)
    rho[:, :, 0] = c_g.T
    dws, dbs = [None] * n, [None] * n
    for l in range(n - 1, -1, -1):
        # the output layer's tangent cotangents (c_g[k] in the sdf column)
        # stay f32: K12 takes them as a rank-1 and a rank-3 term
        dzb, rhob = rnd(dz), rho if l == n - 1 else rnd(rho)
        dws[l] = H[l].T @ dzb + sum(T[l][k].T @ rhob[k] for k in range(3))
        dbs[l] = dz.sum(0)
        if l == 0:
            break
        g_h, g_t = dzb @ wr[l].T, rhob @ wr[l].T
        n_h = dims[l] - d0 if l in icfg.skip_in else dims[l]
        scale = inv_sqrt2 if l in icfg.skip_in else 1.0
        s, oms = S[l - 1]
        g_h, g_t = g_h[:, :n_h], g_t[..., :n_h]
        dz = scale * s * g_h + 100.0 * oms * (g_t * T[l][..., :n_h]).sum(0)
        rho = scale * s * g_t
    return dws, dbs


def excess(grad, ref):
    """max(|grad - ref| - (ATOL + RTOL |ref|)): positive past the bound."""
    return float(((grad - ref).abs() - (ATOL + RTOL * ref.abs())).max())


@pytest.mark.parametrize("case", ["narrow", "flagship"])
def test_replay_without_rounding_is_the_plain_sweep(case):
    net = sdf_net(**{"narrow": NARROW, "flagship": FLAGSHIP}[case])
    x = eikonal_points(200, 3)
    with torch.no_grad():
        ws, bs = flat_weights(net)
        out, grad = replay_tangent_fwd(net.cfg, ws, bs, x, keep)
        out_p, grad_p = sdf_grad.sdf_tangents(net.cfg, ws, bs, x)
    torch.testing.assert_close(out, out_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(grad, grad_p, atol=1e-4, rtol=1e-4)


def test_bf16_weights_take_the_perturbed_flagship_to_the_bound():
    """The replay's gradient against the f32 plain op passes the bound by
    less than its weights' rounding alone costs; against the plain op at
    bf16 weights it keeps a margin."""
    net = sdf_net(**FLAGSHIP)
    x = eikonal_points(4800, 4800)
    with torch.no_grad():
        ws, bs = flat_weights(net)
        _, grad_p = sdf_grad.sdf_tangents(net.cfg, ws, bs, x)
        _, grad = replay_tangent_fwd(net.cfg, ws, bs, x)
        _, grad_w = replay_tangent_fwd(net.cfg, ws, bs, x, keep, bf)
        _, grad_pw = sdf_grad.sdf_tangents(net.cfg, bf16_weights(ws), bs, x)
    weights_alone = float((grad_w - grad_p).abs().max())
    assert weights_alone > 0.5 * ATOL
    assert excess(grad, grad_p) > -0.25 * ATOL
    assert excess(grad, grad_pw) < -0.25 * ATOL


@pytest.mark.parametrize("case", ["narrow", "flagship"])
def test_bwd_replay_without_rounding_is_the_plain_vjp(case):
    net = sdf_net(**{"narrow": NARROW, "flagship": FLAGSHIP}[case])
    x = eikonal_points(100, 5)
    ws, bs = flat_weights(net)
    out, grad = sdf_grad.sdf_grad_plain(net.cfg, ws, bs, x)
    c_out, c_g = loss_cotangents(out, grad)
    ref = torch.autograd.grad((out, grad), ws + bs, (c_out, c_g))
    with torch.no_grad():
        dws, dbs = replay_tangent_bwd(net.cfg, [w.detach() for w in ws],
                                      [b.detach() for b in bs], x, c_out,
                                      c_g, keep)
    for got, want in zip(dws + dbs, ref):
        torch.testing.assert_close(got, want, atol=1e-4 * float(
            want.abs().max()), rtol=0)
