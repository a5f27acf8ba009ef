"""K11's arithmetic replayed in torch, JAX-free. K11 is K10's kernel
launched at sphere radius 0 on the `.sdf` chain of the tangent op's one
pack (`sdf_grad.bwd_stages`, K6's `rev.RevStages`), so its replay is
K10's (`replay.K10Replay`, `emulate_sdf_outputs`) on that pack at a
config with no bounding sphere: K3's wgmma tangent form on the SDF net,
with bf16 rounding where the kernel rounds (the encoding and its
tangents, each layer's weights, activations and tangents; f32 sums, 16
deep as wgmma's steps).

* with no rounding of its activations the replay is the plain sweep
  (`sdf_grad.sdf_tangents`) at the pack's bf16 weights;
* with bf16 rounding it shows what the kernel's operand type costs: at the
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

import dataclasses

import pytest
import torch

from i2sdf_tpu_torch.ops.kernels import replay, sdf_grad
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


def replay_k11(net, x, rnd=bf):
    """(out (N, 1 + F), grad (N, 3)) as K11 computes them, unclamped: K10's
    replay on the op's pack at sphere radius 0, `rnd` rounding the
    encoding, its tangents and every layer's outputs (the weights are the
    pack's bf16)."""
    with torch.no_grad():
        k = sdf_grad.bwd_stages(net.cfg, *flat_weights(net))
    cfg = dataclasses.replace(net.cfg, sdf_bounding_sphere=0.0)
    sdf, feat, grad = replay.emulate_sdf_outputs(k, cfg, x, rnd)
    return torch.cat([sdf, feat], 1), grad


def excess(grad, ref):
    """max(|grad - ref| - (ATOL + RTOL |ref|)): positive past the bound."""
    return float(((grad - ref).abs() - (ATOL + RTOL * ref.abs())).max())


@pytest.mark.parametrize("case", ["narrow", "flagship"])
def test_replay_without_rounding_is_the_plain_sweep(case):
    net = sdf_net(**{"narrow": NARROW, "flagship": FLAGSHIP}[case])
    x = eikonal_points(200, 3)
    with torch.no_grad():
        ws, bs = flat_weights(net)
        out, grad = replay_k11(net, x, keep)
        out_p, grad_p = sdf_grad.sdf_tangents(net.cfg, bf16_weights(ws), bs,
                                              x)
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
        _, grad = replay_k11(net, x)
        _, grad_w = replay_k11(net, x, keep)
        _, grad_pw = sdf_grad.sdf_tangents(net.cfg, bf16_weights(ws), bs, x)
    weights_alone = float((grad_w - grad_p).abs().max())
    assert weights_alone > 0.5 * ATOL
    assert excess(grad, grad_p) > -0.25 * ATOL
    assert excess(grad, grad_pw) < -0.25 * ATOL
