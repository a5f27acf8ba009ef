"""BRDF library (counterpart of `i2sdf_tpu/models/brdf.py`): GGX
microfacet specular with Disney or Lambert diffuse, importance samplers
and their pdfs, as plain functions on batched tensors.

Conventions are the JAX package's: normals unit, view and light
directions pointing away from the surface, leading batch dimensions
broadcast. Each sampler takes its uniforms as a tensor `u` (the JAX
functions draw them from a key inside), so the tests can feed JAX's own
draws; `draw_*` wrap a sampler with draws from a `utils.draws.Draws`
(a `torch.Generator`). The Hammersley set's radical inverse runs on int64
with 32-bit masks (torch has no unsigned 32-bit shifts) and gives the
JAX uint32 values to the bit.
"""

from __future__ import annotations

import math

import torch

from ..utils.draws import Draws
from ..utils.jmath import safe_normalize


# ---- frames -----------------------------------------------------------------

def build_onb(n: torch.Tensor):
    """Branchless orthonormal basis (t, b) about unit n (Duff et al. 2017);
    [t, b, n] is right-handed."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    bb = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + s * n[..., 0] ** 2 * a, s * bb, -s * n[..., 0]],
                    dim=-1)
    b = torch.stack([bb, s + n[..., 1] ** 2 * a, -n[..., 1]], dim=-1)
    return t, b


def to_local(v, n):
    t, b = build_onb(n)
    return torch.stack([(v * t).sum(-1), (v * b).sum(-1), (v * n).sum(-1)],
                       dim=-1)


def to_world(v_local, n):
    t, b = build_onb(n)
    return (v_local[..., 0:1] * t + v_local[..., 1:2] * b
            + v_local[..., 2:3] * n)


# ---- parameters -------------------------------------------------------------

def metallic_to_kd_ks(albedo, metallic, specular: float = 0.5):
    """Disney base colour / metallic -> diffuse and specular colours."""
    ks = (1.0 - metallic) * 0.08 * specular + metallic * albedo
    kd = (1.0 - metallic) * albedo
    return kd, ks


def luminance(rgb):
    w = torch.tensor([0.2126, 0.7152, 0.0722], dtype=rgb.dtype,
                     device=rgb.device)
    return (rgb * w).sum(-1)


# ---- Fresnel, shadowing, distribution ---------------------------------------

def fresnel_schlick(f0, cos_theta):
    """Schlick with the "shadowed F90" that dims grazing highlights of very
    dark f0."""
    f90 = torch.clamp(luminance(f0)[..., None] * 50.0, 0.0, 1.0)
    m = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    if cos_theta.ndim < f0.ndim:
        return f0 + (f90 - f0) * (m ** 5)[..., None]
    return f0 + (f90 - f0) * (m ** 5)


def ggx_ndf(cos_h, alpha):
    a2 = alpha * alpha
    d = cos_h * cos_h * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(math.pi * d * d, min=1e-9)


def smith_g1(cos_v, alpha):
    a2 = alpha * alpha
    return 2.0 * cos_v / torch.clamp(
        cos_v + torch.sqrt(a2 + (1 - a2) * cos_v * cos_v), min=1e-9)


def smith_g2(cos_v, cos_l, alpha):
    """Height-correlated Smith masking-shadowing."""
    a2 = alpha * alpha

    def lam(c):
        return torch.sqrt(a2 + (1 - a2) * c * c)

    return (2.0 * cos_v * cos_l
            / torch.clamp(cos_l * lam(cos_v) + cos_v * lam(cos_l), min=1e-9))


# ---- evaluation -------------------------------------------------------------

def eval_lambert(kd):
    return kd / math.pi


def eval_disney_diffuse(kd, roughness, cos_v, cos_l, cos_d):
    """Disney retro-reflective diffuse."""
    f90 = 0.5 + 2.0 * roughness * cos_d * cos_d
    fv = 1.0 + (f90 - 1.0) * (1.0 - cos_v) ** 5
    fl = 1.0 + (f90 - 1.0) * (1.0 - cos_l) ** 5
    return kd / math.pi * (fv * fl)[..., None]


def eval_ggx_specular(ks, roughness, n, v, l):
    """Microfacet specular D * G2 * F / (4 cos_v cos_l)."""
    alpha = torch.clamp(roughness * roughness, min=1e-3)
    h = safe_normalize(v + l)
    cos_v = torch.clamp((n * v).sum(-1), 1e-6, 1.0)
    cos_l = torch.clamp((n * l).sum(-1), 1e-6, 1.0)
    cos_h = torch.clamp((n * h).sum(-1), 0.0, 1.0)
    cos_d = torch.clamp((v * h).sum(-1), 0.0, 1.0)
    d = ggx_ndf(cos_h, alpha)
    g = smith_g2(cos_v, cos_l, alpha)
    f = fresnel_schlick(ks, cos_d[..., None])
    return f * (d * g / torch.clamp(4.0 * cos_v * cos_l, min=1e-9))[..., None]


def eval_diffuse(diffuse_model: str, kd, roughness, n, v, l, cos_l):
    """The diffuse lobe of `rendering_layer`: Disney's, or Lambert's
    broadcast to kd's shape."""
    if diffuse_model == "disney":
        return eval_disney_diffuse(
            kd, roughness, torch.clamp((n * v).sum(-1), 0, 1), cos_l,
            torch.clamp((v * safe_normalize(v + l)).sum(-1), 0, 1))
    return eval_lambert(kd).expand(kd.shape)


def eval_brdf(kd, ks, roughness, n, v, l, diffuse_model: str = "lambert"):
    """Diffuse + specular BRDF value (RGB), 0 below the horizon."""
    cos_l = (n * l).sum(-1)
    if diffuse_model == "disney":
        h = safe_normalize(v + l)
        diff = eval_disney_diffuse(
            kd, roughness, torch.clamp((n * v).sum(-1), 0, 1),
            torch.clamp(cos_l, 0, 1), torch.clamp((v * h).sum(-1), 0, 1))
    else:
        diff = eval_lambert(kd).expand(ks.shape)
    spec = eval_ggx_specular(ks, roughness, n, v, l)
    return torch.where((cos_l > 0)[..., None], diff + spec, 0.0)


# ---- sampling ---------------------------------------------------------------

def sample_uniform_cone(u, axis, cos_half):
    """Uniform solid-angle direction inside the cone about unit `axis` with
    aperture cos(half-angle) `cos_half` (N,), from uniforms u (..., 2).
    Returns (l, pdf), pdf = 1 / (2 pi (1 - cos_half)); cos_half = -1 is
    the whole sphere (a shading point inside a sphere emitter)."""
    cos_t = 1.0 - u[..., 0] * (1.0 - cos_half)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2 * math.pi * u[..., 1]
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                         cos_t], dim=-1)
    pdf = 1.0 / torch.clamp(2 * math.pi * (1.0 - cos_half), min=1e-9)
    return to_world(local, axis), pdf


def sample_cosine_hemisphere(u, n):
    """Cosine-weighted direction about n from u (..., 2); (l, pdf)."""
    r = torch.sqrt(u[..., 0])
    phi = 2 * math.pi * u[..., 1]
    local = torch.stack(
        [r * torch.cos(phi), r * torch.sin(phi),
         torch.sqrt(torch.clamp(1.0 - u[..., 0], min=0.0))], dim=-1)
    pdf = torch.clamp(local[..., 2], min=1e-9) / math.pi
    return to_world(local, n), pdf


_MASKS = ((16, 0xFFFF0000, 0x0000FFFF), (8, 0xFF00FF00, 0x00FF00FF),
          (4, 0xF0F0F0F0, 0x0F0F0F0F), (2, 0xCCCCCCCC, 0x33333333),
          (1, 0xAAAAAAAA, 0x55555555))


def _radical_inverse_base2(i) -> torch.Tensor:
    """van der Corput: the bits of uint32 i reversed, / 2^32, in [0, 1),
    on int64 with 32-bit masks."""
    i = torch.as_tensor(i, dtype=torch.int64) & 0xFFFFFFFF
    for shift, hi, lo in _MASKS:
        i = ((i & lo) << shift) | ((i & hi) >> shift)
    return i.to(torch.float32) * (1.0 / 4294967296.0)


def cosine_hemisphere_ld(shift, n, spp: int):
    """`spp` low-discrepancy cosine-weighted directions about each n (N,
    3): Hammersley points (i/spp, vdc(i)) under a per-point
    Cranley-Patterson rotation `shift` (2, N) of uniforms. Returns (dirs
    (spp, N, 3), pdf (spp, N))."""
    i = torch.arange(spp, device=n.device)
    u1 = (i.to(torch.float32) + 0.5) / spp
    u2 = _radical_inverse_base2(i)
    u1 = torch.remainder(u1[:, None] + shift[0][None, :], 1.0)
    u2 = torch.remainder(u2[:, None] + shift[1][None, :], 1.0)
    r = torch.sqrt(u1)
    phi = 2 * math.pi * u2
    local = torch.stack(
        [r * torch.cos(phi), r * torch.sin(phi),
         torch.sqrt(torch.clamp(1.0 - u1, min=0.0))], dim=-1)
    dirs = to_world(local, n[None])
    return dirs, torch.clamp(local[..., 2], min=1e-9) / math.pi


def sample_ggx_vndf(u, n, v, roughness):
    """Visible-normal GGX sampling (Heitz 2018) from u (..., 2); returns
    (l = reflect(v, h), h)."""
    alpha = torch.clamp(roughness * roughness, min=1e-3)[..., None]
    v_local = to_local(v, n)
    vh = safe_normalize(v_local * torch.cat(
        [alpha, alpha, torch.ones_like(alpha)], dim=-1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    t1 = torch.where(
        (lensq > 1e-7)[..., None],
        torch.stack([-vh[..., 1], vh[..., 0], torch.zeros_like(lensq)], -1)
        / torch.sqrt(torch.clamp(lensq, min=1e-12))[..., None],
        vh.new_tensor([1.0, 0.0, 0.0]).expand(vh.shape))
    t2 = torch.linalg.cross(vh, t1, dim=-1)
    r = torch.sqrt(u[..., 0])
    phi = 2 * math.pi * u[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 ** 2, min=0.0)) + s * p2
    ph = (p1[..., None] * t1 + p2[..., None] * t2
          + torch.sqrt(torch.clamp(1.0 - p1 ** 2 - p2 ** 2, min=0.0))[
              ..., None] * vh)
    h_local = safe_normalize(torch.stack(
        [alpha[..., 0] * ph[..., 0], alpha[..., 0] * ph[..., 1],
         torch.clamp(ph[..., 2], min=1e-6)], dim=-1))
    h = to_world(h_local, n)
    l = 2.0 * (v * h).sum(-1, keepdim=True) * h - v
    return safe_normalize(l), h


def draw_uniform_cone(draws: Draws, axis, cos_half):
    return sample_uniform_cone(
        draws.uniform(axis.shape[:-1] + (2,)).to(axis.device), axis,
        cos_half)


def draw_cosine_hemisphere(draws: Draws, n):
    return sample_cosine_hemisphere(
        draws.uniform(n.shape[:-1] + (2,)).to(n.device), n)


def draw_cosine_hemisphere_ld(draws: Draws, n, spp: int):
    return cosine_hemisphere_ld(
        draws.uniform((2, n.shape[0])).to(n.device), n, spp)


def draw_ggx_vndf(draws: Draws, n, v, roughness):
    return sample_ggx_vndf(draws.uniform(n.shape[:-1] + (2,)).to(n.device),
                           n, v, roughness)


# ---- pdfs -------------------------------------------------------------------

def pdf_cosine(n, l):
    return torch.clamp((n * l).sum(-1), min=0.0) / math.pi


def pdf_ggx_vndf(n, v, l, roughness):
    alpha = torch.clamp(roughness * roughness, min=1e-3)
    h = safe_normalize(v + l)
    cos_v = torch.clamp((n * v).sum(-1), 1e-6, 1.0)
    cos_h = torch.clamp((n * h).sum(-1), 0.0, 1.0)
    vdoth = torch.clamp((v * h).sum(-1), 1e-6, 1.0)
    d = ggx_ndf(cos_h, alpha)
    g1 = smith_g1(cos_v, alpha)
    return d * g1 * vdoth / torch.clamp(4.0 * cos_v * vdoth, min=1e-9)


def specular_event_probability(kd, ks):
    """Diffuse-or-specular event choice by luminance, in [0.05, 0.95]."""
    ld = luminance(kd)
    ls = luminance(ks)
    return torch.clamp(ls / torch.clamp(ld + ls, min=1e-9), 0.05, 0.95)


def combined_pdf(kd, ks, roughness, n, v, l):
    """Mixture pdf of the diffuse/specular sampling strategy."""
    p_spec = specular_event_probability(kd, ks)
    return ((1.0 - p_spec) * pdf_cosine(n, l)
            + p_spec * pdf_ggx_vndf(n, v, l, roughness))
