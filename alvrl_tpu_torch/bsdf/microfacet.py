"""Microfacet BSDFs: rough conductor, rough plastic, rough dielectric.

Counterpart of alvrl_tpu/bsdf/microfacet.py (src/bsdfs/{roughconductor,
roughplastic,roughdielectric}.cpp over microfacet.h), in the local frame
(z = shading normal, wi and wo pointing away from the surface),
broadcasting over leading dimensions. eval returns f * cos(theta_o).

Two families, as in the reference package:
  * the GGX-only isotropic lobes that the BSDF sampler draws from
    (ggx_d, smith_g1, sample_rough_conductor, eval_rough_plastic);
  * the distributions of the material's `dist` column, Beckmann, GGX and
    Phong with anisotropic roughness (mf_d, mf_g1, mf_sample, mf_pdf),
    which eval_smooth and pdf_smooth read, and the rough dielectric.
The rough-transmittance table of ROUGH_COATING is built from the same
np.random.default_rng(1234) uniforms as the reference's, through this
module's sample_rough_dielectric.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from alvrl_tpu_torch.bsdf.lobes import fresnel_dielectric_scalar
from alvrl_tpu_torch.core import math as m
from alvrl_tpu_torch.scene.scene import RT_ALPHA, RT_COS

MF_BECKMANN = 0
MF_GGX = 1
MF_PHONG = 2

_TWO_PI = 2.0 * math.pi


# ---------------------------------------------------------------------------
# GGX-only lobes (the sampler's rough conductor and rough plastic)
# ---------------------------------------------------------------------------

def ggx_d(mh, alpha):
    """GGX NDF D(m) for the local half-vector mh (z up)."""
    ct = torch.clamp(mh[..., 2], 1e-6, 1.0)
    ct2 = ct * ct
    a2 = alpha * alpha
    t = ct2 * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(math.pi * t * t, min=1e-12)


def smith_g1(v, alpha):
    """Smith masking for GGX (height-uncorrelated, per direction)."""
    ct = torch.clamp(v[..., 2].abs(), 1e-6, 1.0)
    tan2 = (1.0 - ct * ct) / (ct * ct)
    return 2.0 / (1.0 + torch.sqrt(1.0 + alpha * alpha * tan2))


def fresnel_conductor_schlick(cos_i, f0):
    """Schlick's approximation with a per-channel F0 (conductor tint)."""
    c = torch.clamp(1.0 - cos_i, 0.0, 1.0)
    return f0 + (1.0 - f0) * (c ** 5)[..., None]


def eval_rough_conductor(wi, wo, alpha, f0):
    """f(wi, wo) cos_o of a GGX conductor."""
    ci = wi[..., 2]
    co = wo[..., 2]
    valid = (ci > 0) & (co > 0)
    h = m.normalize(wi + wo)
    d = ggx_d(h, alpha)
    g = smith_g1(wi, alpha) * smith_g1(wo, alpha)
    f = fresnel_conductor_schlick(m.dot(wi, h), f0)
    spec = f * (d * g / torch.clamp(4.0 * ci, min=1e-9))[..., None]
    return torch.where(valid[..., None], spec, 0.0)


def sample_ggx_half(u2, alpha):
    """A GGX half-vector ~ D(m) |m.n| (local frame)."""
    u0, u1 = u2[..., 0], u2[..., 1]
    phi = 2.0 * math.pi * u1
    ct2 = (1.0 - u0) / torch.clamp(1.0 + (alpha * alpha - 1.0) * u0,
                                   min=1e-12)
    ct = torch.sqrt(torch.clamp(ct2, 0.0, 1.0))
    st = torch.sqrt(torch.clamp(1.0 - ct2, 0.0, 1.0))
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)


def pdf_rough_conductor(wi, wo, alpha):
    """The solid-angle pdf of sample_rough_conductor."""
    h = m.normalize(wi + wo)
    d = ggx_d(h, alpha)
    pdf_h = d * torch.clamp(h[..., 2], 0.0, 1.0)
    jac = 1.0 / torch.clamp(4.0 * m.dot(wo, h).abs(), min=1e-9)
    return torch.where((wi[..., 2] > 0) & (wo[..., 2] > 0), pdf_h * jac, 0.0)


def sample_rough_conductor(u2, wi, alpha, f0):
    """(wo, weight (..., 3) = f cos / pdf, pdf)."""
    h = sample_ggx_half(u2, alpha)
    wo = 2.0 * m.dot(wi, h)[..., None] * h - wi
    pdf = pdf_rough_conductor(wi, wo, alpha)
    f_cos = eval_rough_conductor(wi, wo, alpha, f0)
    w = torch.where((pdf > 0)[..., None],
                    f_cos / torch.clamp(pdf, min=1e-12)[..., None], 0.0)
    return wo, w, pdf


def eval_rough_plastic(wi, wo, alpha, diffuse_albedo, f0_scalar=0.04):
    """GGX specular coat over a Lambertian base (roughplastic.cpp without
    the internal-scattering refinement)."""
    f0 = torch.full((3,), f0_scalar, dtype=torch.float32, device=wi.device)
    spec = eval_rough_conductor(wi, wo, alpha, f0)
    co = torch.clamp(wo[..., 2], 0.0, 1.0)
    diff = diffuse_albedo * (co / math.pi)[..., None]
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return torch.where(valid[..., None], spec + diff, 0.0)


# ---------------------------------------------------------------------------
# The distribution column: Beckmann, GGX and Phong (Ashikhmin-Shirley when
# anisotropic), each case evaluated and selected (microfacet.h: D at
# :191-233, sampleAll at :286-389, smithG1 with projected roughness at
# :477-556, the Phong exponent e = 2 / alpha^2 - 2 at :701-704)
# ---------------------------------------------------------------------------

def phong_exponent(alpha):
    """The Phong exponent equivalent to a Beckmann roughness."""
    return torch.clamp(2.0 / torch.clamp(alpha * alpha, min=1e-8) - 2.0,
                       min=0.0)


def mf_d(dist, mh, au, av):
    """The NDF D(m) of each distribution; dist broadcasts against
    mh[..., 0]."""
    ct = mh[..., 2]
    ct2 = torch.clamp(ct * ct, min=1e-12)
    x2 = mh[..., 0] * mh[..., 0]
    y2 = mh[..., 1] * mh[..., 1]
    au2 = torch.clamp(au * au, min=1e-8)
    av2 = torch.clamp(av * av, min=1e-8)
    bexp = (x2 / au2 + y2 / av2) / ct2

    d_beck = torch.exp(-bexp) / (math.pi * au * av * ct2 * ct2)
    root = (1.0 + bexp) * ct2
    d_ggx = 1.0 / torch.clamp(math.pi * au * av * root * root, min=1e-20)

    e_u = phong_exponent(au)
    e_v = phong_exponent(av)
    st2 = torch.clamp(x2 + y2, min=1e-12)
    e = torch.where(x2 + y2 > 1e-12, (x2 * e_u + y2 * e_v) / st2, e_u)
    d_ph = (torch.sqrt((e_u + 2.0) * (e_v + 2.0)) / _TWO_PI
            * torch.pow(torch.clamp(ct, min=1e-9), e))

    d = torch.where(dist == MF_BECKMANN, d_beck,
                    torch.where(dist == MF_PHONG, d_ph, d_ggx))
    # the reference zeroes numerically negligible results (:228-230)
    return torch.where((ct > 0) & (d * ct >= 1e-20), d, 0.0)


def _project_roughness(v, au, av):
    """The roughness projected onto the direction v."""
    st2 = torch.clamp(1.0 - v[..., 2] * v[..., 2], min=1e-12)
    cos_phi2 = v[..., 0] * v[..., 0] / st2
    sin_phi2 = v[..., 1] * v[..., 1] / st2
    proj = torch.sqrt(cos_phi2 * au * au + sin_phi2 * av * av)
    return torch.where(1.0 - v[..., 2] * v[..., 2] > 1e-12, proj, au)


def mf_g1(dist, v, mh, au, av):
    """Smith masking for one direction; Phong reuses the Beckmann
    rational fit with its generating alpha."""
    ct = v[..., 2]
    sideness = (m.dot(v, mh) * ct) > 0
    tan_t = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0)) / torch.clamp(
        ct.abs(), min=1e-9)
    alpha = _project_roughness(v, au, av)
    a = 1.0 / torch.clamp(alpha * tan_t, min=1e-9)
    a2 = a * a
    g_beck = torch.where(
        a >= 1.6, 1.0,
        (3.535 * a + 2.181 * a2) / (1.0 + 2.276 * a + 2.577 * a2))
    root = alpha * tan_t
    g_ggx = 2.0 / (1.0 + torch.sqrt(1.0 + root * root))
    g = torch.where(dist == MF_GGX, g_ggx, g_beck)
    g = torch.where(tan_t < 1e-9, 1.0, g)
    return torch.where(sideness, g, 0.0)


def _aniso_phi(u1, au, av):
    """The anisotropic azimuth atan(av / au tan(...)) with the quadrant
    restoration of microfacet.h:300-305."""
    return torch.atan(av / au * torch.tan(math.pi + _TWO_PI * u1)) \
        + math.pi * torch.floor(2.0 * u1 + 0.5)


def mf_sample(dist, u2, au, av):
    """m ~ D(m) |cos| over all normals (sampleAll). Returns (m, pdf)."""
    u0 = torch.clamp(u2[..., 0], 1e-7, 1.0 - 1e-7)
    u1 = u2[..., 1]
    phi = _aniso_phi(u1, au, av)
    sin_phi = torch.sin(phi)
    cos_phi = torch.cos(phi)
    cos_sc = cos_phi / au
    sin_sc = sin_phi / av
    alpha_sqr = 1.0 / torch.clamp(cos_sc * cos_sc + sin_sc * sin_sc,
                                  min=1e-12)

    # beckmann
    tan2_b = alpha_sqr * -torch.log(1.0 - u0)
    ct_b = 1.0 / torch.sqrt(1.0 + tan2_b)
    pdf_b = (1.0 - u0) / (math.pi * au * av * ct_b * ct_b * ct_b)

    # ggx
    tan2_g = alpha_sqr * u0 / (1.0 - u0)
    ct_g = 1.0 / torch.sqrt(1.0 + tan2_g)
    tmp_g = 1.0 + tan2_g / alpha_sqr
    pdf_g = 1.0 / (math.pi * au * av * ct_g ** 3 * tmp_g * tmp_g)

    # phong: the azimuth of the (e + 2)-normalized NDF, sampled exactly
    # per quadrant (the reference package's choice over the
    # reference's (e + 1)-ratio scheme)
    e_u = phong_exponent(au)
    e_v = phong_exponent(av)
    q = torch.floor(u1 * 4.0)
    u1q = (u1 * 4.0 - 2.0 * torch.round(u1 * 2.0)).abs()
    phi_q = torch.atan(
        torch.sqrt((e_u + 2.0) / (e_v + 2.0))
        * torch.tan(0.5 * math.pi * torch.clamp(u1q, 1e-7, 1.0 - 1e-7)))
    phi_p = torch.where(q == 0, phi_q,
                        torch.where(q == 1, math.pi - phi_q,
                                    torch.where(q == 2, math.pi + phi_q,
                                                _TWO_PI - phi_q)))
    cos_pp = torch.cos(phi_p)
    sin_pp = torch.sin(phi_p)
    e_p = e_u * cos_pp * cos_pp + e_v * sin_pp * sin_pp
    ct_p = torch.pow(u0, 1.0 / (e_p + 2.0))
    pdf_p = (torch.sqrt((e_u + 2.0) * (e_v + 2.0)) / _TWO_PI
             * torch.pow(ct_p, e_p + 1.0))

    is_b = dist == MF_BECKMANN
    is_p = dist == MF_PHONG
    ct = torch.where(is_b, ct_b, torch.where(is_p, ct_p, ct_g))
    sin_phi = torch.where(is_p, sin_pp, sin_phi)
    cos_phi = torch.where(is_p, cos_pp, cos_phi)
    pdf = torch.where(is_b, pdf_b, torch.where(is_p, pdf_p, pdf_g))
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    mh = torch.stack([st * cos_phi, st * sin_phi, ct], dim=-1)
    return mh, torch.clamp(pdf, min=0.0)


def mf_pdf(dist, mh, au, av):
    """pdfAll: D(m) |cos theta_m|, without visible-normal weighting."""
    return mf_d(dist, mh, au, av) * torch.clamp(mh[..., 2], 0.0, 1.0)


def eval_rough_conductor_d(wi, wo, dist, au, av, f0):
    """eval_rough_conductor over the distribution column, anisotropic."""
    ci = wi[..., 2]
    co = wo[..., 2]
    valid = (ci > 0) & (co > 0)
    h = m.normalize(wi + wo)
    d = mf_d(dist, h, au, av)
    g = mf_g1(dist, wi, h, au, av) * mf_g1(dist, wo, h, au, av)
    f = fresnel_conductor_schlick(m.dot(wi, h), f0)
    spec = f * (d * g / torch.clamp(4.0 * ci, min=1e-9))[..., None]
    return torch.where(valid[..., None], spec, 0.0)


def pdf_rough_conductor_d(wi, wo, dist, au, av):
    h = m.normalize(wi + wo)
    pdf_h = mf_pdf(dist, h, au, av)
    jac = 1.0 / torch.clamp(4.0 * m.dot(wo, h).abs(), min=1e-9)
    return torch.where((wi[..., 2] > 0) & (wo[..., 2] > 0), pdf_h * jac, 0.0)


def eval_rough_plastic_d(wi, wo, dist, au, av, diffuse_albedo,
                         f0_scalar=0.04):
    f0 = torch.full((3,), f0_scalar, dtype=torch.float32, device=wi.device)
    spec = eval_rough_conductor_d(wi, wo, dist, au, av, f0)
    co = torch.clamp(wo[..., 2], 0.0, 1.0)
    diff = diffuse_albedo * (co / math.pi)[..., None]
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return torch.where(valid[..., None], spec + diff, 0.0)


# ---------------------------------------------------------------------------
# Rough dielectric (roughdielectric.cpp): microfacet reflection and
# refraction through a rough interface [Walter et al. 2007]
# ---------------------------------------------------------------------------

def _fresnel_signed(cos_im, eta):
    """Dielectric Fresnel for a signed cosine against the microfacet
    (eta = interior / exterior): entering uses eta, exiting 1 / eta."""
    f_in = fresnel_dielectric_scalar(cos_im.abs(), eta)
    f_out = fresnel_dielectric_scalar(cos_im.abs(), 1.0 / eta)
    return torch.where(cos_im >= 0, f_in, f_out)


def _half_vectors(wi, wo, eta):
    """(reflect, eta_i, eta_o, h): the reflection or transmission
    half-vector of each pair, oriented to z > 0."""
    ci = wi[..., 2]
    co = wo[..., 2]
    reflect = ci * co > 0
    h_r = m.normalize(wi + wo)
    h_r = h_r * torch.sign(h_r[..., 2])[..., None]
    eta_i = torch.where(ci > 0, 1.0, eta)
    eta_o = torch.where(ci > 0, eta, 1.0)
    h_t = m.normalize(wi * eta_i[..., None] + wo * eta_o[..., None])
    h_t = h_t * torch.sign(h_t[..., 2])[..., None]
    return reflect, eta_i, eta_o, torch.where(reflect[..., None], h_r, h_t)


def eval_rough_dielectric(wi, wo, eta, dist, au, av, mode="radiance"):
    """f |cos_o| of the rough dielectric, reflection (same hemisphere)
    and transmission; radiance mode carries the 1 / eta^2 compression."""
    ci = wi[..., 2]
    co = wo[..., 2]
    reflect, eta_i, eta_o, h = _half_vectors(wi, wo, eta)
    d = mf_d(dist, h, au, av)
    g = mf_g1(dist, wi, h, au, av) * mf_g1(dist, wo, h, au, av)
    wih = m.dot(wi, h)
    woh = m.dot(wo, h)
    f = _fresnel_signed(torch.where(ci > 0, wih, -wih), eta)

    val_r = f * d * g / torch.clamp(4.0 * ci.abs(), min=1e-9)

    denom = eta_i * wih + eta_o * woh
    val_t = ((wih * woh).abs() / torch.clamp((ci * co).abs(), min=1e-9)
             * eta_o * eta_o * (1.0 - f) * d * g
             / torch.clamp(denom * denom, min=1e-12)) * co.abs()
    if mode == "radiance":
        val_t = val_t * (eta_i / eta_o) ** 2
    ok_t = (~reflect) & (denom.abs() > 1e-9)
    return torch.where(reflect, val_r, torch.where(ok_t, val_t, 0.0))


def pdf_rough_dielectric(wi, wo, eta, dist, au, av):
    """The solid-angle pdf of sample_rough_dielectric: pdf_m times the
    lobe probability times the Jacobian."""
    ci = wi[..., 2]
    reflect, eta_i, eta_o, h = _half_vectors(wi, wo, eta)
    wih = m.dot(wi, h)
    woh = m.dot(wo, h)
    f = _fresnel_signed(torch.where(ci > 0, wih, -wih), eta)
    pdf_m = mf_pdf(dist, h, au, av)
    jac_r = 1.0 / torch.clamp(4.0 * woh.abs(), min=1e-9)
    denom = eta_i * wih + eta_o * woh
    jac_t = eta_o * eta_o * woh.abs() / torch.clamp(denom * denom,
                                                    min=1e-12)
    return torch.where(reflect, pdf_m * f * jac_r,
                       pdf_m * (1.0 - f) * jac_t)


def sample_rough_dielectric(u3, wi, eta, dist, au, av, mode="radiance"):
    """m ~ D(m) |cos|, then reflect with probability F(wi.m), else
    refract. Returns (wo, weight (..., 3), pdf, did_transmit), weight =
    f |cos| / pdf from the closed forms."""
    u_sel = u3[..., 0]
    mh, _ = mf_sample(dist, u3[..., 1:3], au, av)
    ci = wi[..., 2]
    wih = m.dot(wi, mh)
    f = _fresnel_signed(torch.where(ci > 0, wih, -wih), eta)
    take_r = u_sel < f

    wo_r = 2.0 * wih[..., None] * mh - wi

    # refraction about mh (Walter eq. 40)
    inv_eta_rel = torch.where(ci > 0, 1.0 / eta, eta)
    c = wih
    sign_c = torch.sign(c)
    cos_t2 = 1.0 - inv_eta_rel * inv_eta_rel * (1.0 - c * c)
    tir = cos_t2 <= 0.0
    wo_t = (inv_eta_rel * c - sign_c * torch.sqrt(torch.clamp(cos_t2,
                                                              min=0.0))
            )[..., None] * mh - inv_eta_rel[..., None] * wi

    wo = torch.where(take_r[..., None], wo_r, wo_t)
    # invalid refractions and wrong-side reflections die
    ok = torch.where(take_r, wo[..., 2] * ci > 0,
                     (~tir) & (wo[..., 2] * ci < 0))
    f_cos = eval_rough_dielectric(wi, wo, eta, dist, au, av, mode=mode)
    pdf = pdf_rough_dielectric(wi, wo, eta, dist, au, av)
    w = torch.where((ok & (pdf > 1e-20))[..., None],
                    (f_cos / torch.clamp(pdf, min=1e-20))[..., None]
                    * torch.ones(3, dtype=torch.float32, device=wi.device),
                    0.0)
    return wo, w, pdf, (~take_r) & ok


# ---------------------------------------------------------------------------
# Rough transmittance (the reference's precomputed RoughTransmittance data,
# src/utils/rdielprec.cpp): the fraction of radiance a rough dielectric
# interface transmits, over (cos theta, alpha), by host Monte Carlo over
# sample_rough_dielectric. ROUGH_COATING reads it.
# ---------------------------------------------------------------------------

_RT_SAMPLES = 2048
_rt_cache = {}


def rough_transmittance_table(eta: float, dist_kind: int = MF_BECKMANN,
                              alpha_max: float = 0.5):
    """(RT_COS, RT_ALPHA) float32 numpy table of the transmitted share
    int f_t(wi, wo) |cos_o| dwo, by importance sampling the full lobe in
    importance mode on the reference's uniforms (1 at eta 1); memoized
    per (eta, distribution, alpha span)."""
    key = (round(float(eta), 4), dist_kind, round(alpha_max, 4))
    if key in _rt_cache:
        return _rt_cache[key]
    if key[0] == 1.0:
        # no interface: everything is transmitted. The sampler's
        # transmission half-vector wi + wo vanishes for an unbent
        # refraction, which makes the reference package's table noise
        # there (ROADMAP C15)
        _rt_cache[key] = np.ones((RT_COS, RT_ALPHA), np.float32)
        return _rt_cache[key]
    rs = np.random.default_rng(1234)
    u = torch.as_tensor(rs.uniform(1e-6, 1.0 - 1e-6, (_RT_SAMPLES, 3))
                        .astype(np.float32))
    cos_grid = np.linspace(1.0 / RT_COS, 1.0, RT_COS, dtype=np.float32)
    alpha_grid = np.linspace(alpha_max / RT_ALPHA, alpha_max, RT_ALPHA,
                             dtype=np.float32)
    tbl = np.zeros((RT_COS, RT_ALPHA), np.float32)
    for i, cti in enumerate(cos_grid):
        sti = float(np.sqrt(max(0.0, 1.0 - cti * cti)))
        wi = torch.tensor([sti, 0.0, float(cti)]).expand(_RT_SAMPLES, 3)
        for j, a in enumerate(alpha_grid):
            _, w, _, is_t = sample_rough_dielectric(
                u, wi, torch.tensor(eta, dtype=torch.float32),
                torch.tensor(dist_kind), torch.tensor(a), torch.tensor(a),
                mode="importance")
            tbl[i, j] = float(torch.where(is_t, w[..., 0], 0.0).mean())
    out = np.clip(tbl, 0.0, 1.0)
    _rt_cache[key] = out
    return out


def rough_transmittance_b(tables, mat_id, cos_i, alpha, alpha_max):
    """Bilinear lookup of material mat_id's table of `tables` (M, RT_COS,
    RT_ALPHA) at (|cos_i|, alpha / alpha_max); mat_id, cos_i, alpha and
    alpha_max broadcast together."""
    gx = torch.clamp(cos_i.abs(), 0.0, 1.0) * RT_COS - 1.0
    gy = torch.clamp(alpha / alpha_max, 0.0, 1.0) * RT_ALPHA - 1.0
    x0 = torch.clamp(torch.floor(gx).to(torch.int64), 0, RT_COS - 2)
    y0 = torch.clamp(torch.floor(gy).to(torch.int64), 0, RT_ALPHA - 2)
    fx = torch.clamp(gx - x0, 0.0, 1.0)
    fy = torch.clamp(gy - y0, 0.0, 1.0)
    flat = tables.reshape(-1)
    base = mat_id * (RT_COS * RT_ALPHA)

    def at(xi, yi):
        return flat[base + xi * RT_ALPHA + yi]

    return ((at(x0, y0) * (1 - fx) + at(x0 + 1, y0) * fx) * (1 - fy)
            + (at(x0, y0 + 1) * (1 - fx) + at(x0 + 1, y0 + 1) * fx) * fy)
