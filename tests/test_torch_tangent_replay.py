"""K11's arithmetic replayed in torch: the tangent sweep with bf16
rounding where the kernel rounds (the encoding and its tangents, each
layer's weights, activations and tangents; f32 sums), JAX-free. K10 runs
the same rounding on K3's wgmma tangent form, whose own replay is
`replay.K10Replay` (tests/test_torch_kernel_layout.py).

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
tests/test_torch_parity_sdf_grad.py). K12 is K6 (`replay.RevReplay`).
"""

import math

import pytest
import torch

from i2sdf_tpu_torch.models import mlp
from i2sdf_tpu_torch.ops.kernels import sdf_grad
from test_torch_rev_replay import (FLAGSHIP, NARROW, eikonal_points,
                                   flat_weights, sdf_net)

ATOL, RTOL = 0.05, 0.08  # the JAX bound on the gradient


def bf(t):
    return t.to(torch.bfloat16).float()


def keep(t):
    return t


def bf16_weights(ws):
    """The weights as the kernels multiply them (biases stay f32)."""
    return [bf(w) for w in ws]


def replay_tangent_fwd(icfg, ws, bs, x, rnd=bf, rnd_w=None):
    """(out (N, 1 + F), grad (N, 3)) as K11 computes them, unclamped:
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
