"""Classic analytic BSDF lobes: Phong, Ward, diffuse transmission,
smooth plastic.

Counterpart of alvrl_tpu/bsdf/lobes.py (src/bsdfs/{phong,ward,difftrans,
plastic}.cpp). All functions work in the local frame (z = shading
normal, wi and wo pointing away from the surface), broadcast over
leading dimensions, and return f * cos(theta_o) for eval (mitsuba's
BSDF::eval convention), as bsdf.microfacet does. Sampling returns
(wo_local, weight (..., 3), pdf) with weight = f cos / pdf against the
full lobe-mixture pdf.
"""

from __future__ import annotations

import math

import torch

from alvrl_tpu_torch.core import math as m
from alvrl_tpu_torch.core import spectrum, warp

_INV_PI = 1.0 / math.pi


def _reflect_local(wi):
    return torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], dim=-1)


# ---------------------------------------------------------------------------
# Phong (phong.cpp): kd/pi + ks (n+2)/(2pi) cos^n(alpha_R)
# ---------------------------------------------------------------------------

def eval_phong(wi, wo, kd, ks, exponent):
    ci, co = wi[..., 2], wo[..., 2]
    valid = (ci > 0) & (co > 0)
    r = _reflect_local(wi)
    cos_a = torch.clamp(m.dot(r, wo), 0.0, 1.0)
    spec = ks * ((exponent + 2.0) / (2.0 * math.pi)
                 * cos_a ** exponent)[..., None]
    f = kd * _INV_PI + spec
    return torch.where(valid[..., None], f * co[..., None], 0.0)


def pdf_phong(wi, wo, kd, ks, exponent):
    """Mixture pdf of sample_phong (diffuse cosine + cos^n specular)."""
    p_spec = _phong_spec_prob(kd, ks)
    co = torch.clamp(wo[..., 2], 0.0, 1.0)
    r = _reflect_local(wi)
    cos_a = torch.clamp(m.dot(r, wo), 0.0, 1.0)
    pdf_d = co * _INV_PI
    pdf_s = (exponent + 1.0) / (2.0 * math.pi) * cos_a ** exponent
    return (1.0 - p_spec) * pdf_d + p_spec * pdf_s


def _phong_spec_prob(kd, ks):
    ld = spectrum.luminance(kd)
    ls = spectrum.luminance(ks)
    return ls / torch.clamp(ld + ls, min=1e-12)


def sample_phong(u3, wi, kd, ks, exponent):
    """u3 (..., 3): the lobe choice, then the 2D sample."""
    u_sel, u0, u1 = u3[..., 0], u3[..., 1], u3[..., 2]
    p_spec = _phong_spec_prob(kd, ks)
    wo_d = warp.square_to_cosine_hemisphere(torch.stack([u0, u1], dim=-1))
    # specular candidate: cos^n around the reflection direction
    cos_a = u0 ** (1.0 / (exponent + 1.0))
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, 0.0, 1.0))
    phi = 2.0 * math.pi * u1
    local = torch.stack([sin_a * torch.cos(phi), sin_a * torch.sin(phi),
                         cos_a], dim=-1)
    r = _reflect_local(wi)
    s, t = m.build_frame(r)
    wo_s = m.frame_to_world(s, t, r, local)
    take_spec = u_sel < p_spec
    wo = torch.where(take_spec[..., None], wo_s, wo_d)
    pdf = pdf_phong(wi, wo, kd, ks, exponent)
    f_cos = eval_phong(wi, wo, kd, ks, exponent)
    w = torch.where((pdf > 1e-12)[..., None],
                    f_cos / torch.clamp(pdf, min=1e-12)[..., None], 0.0)
    return wo, w, pdf


# ---------------------------------------------------------------------------
# Ward (ward.cpp, the 'balanced' variant): anisotropic gaussian lobe
# ---------------------------------------------------------------------------

def eval_ward(wi, wo, kd, ks, alpha_u, alpha_v):
    ci, co = wi[..., 2], wo[..., 2]
    valid = (ci > 1e-4) & (co > 1e-4)
    h = wi + wo
    hz2 = torch.clamp(h[..., 2] * h[..., 2], min=1e-12)
    expo = torch.exp(-((h[..., 0] / alpha_u) ** 2
                       + (h[..., 1] / alpha_v) ** 2) / hz2)
    spec = ks * (expo / (4.0 * math.pi * alpha_u * alpha_v * torch.sqrt(
        torch.clamp(ci * co, min=1e-12))))[..., None]
    f = kd * _INV_PI + spec
    return torch.where(valid[..., None], f * co[..., None], 0.0)


def pdf_ward(wi, wo, kd, ks, alpha_u, alpha_v):
    p_spec = _phong_spec_prob(kd, ks)
    co = torch.clamp(wo[..., 2], 0.0, 1.0)
    pdf_d = co * _INV_PI
    h = m.normalize(wi + wo)
    hz = torch.clamp(h[..., 2], 1e-4, 1.0)
    expo = torch.exp(-((h[..., 0] / alpha_u) ** 2
                       + (h[..., 1] / alpha_v) ** 2) / (hz * hz))
    # the half-vector density expo / (pi au av hz^3), times the jacobian
    # dwh / dwo = 1 / (4 h.wo)
    pdf_s = expo / (math.pi * alpha_u * alpha_v * hz ** 3) / torch.clamp(
        4.0 * m.dot(h, wo).abs(), min=1e-9)
    return (1.0 - p_spec) * pdf_d + p_spec * pdf_s


def sample_ward(u3, wi, kd, ks, alpha_u, alpha_v):
    u_sel, u0, u1 = u3[..., 0], u3[..., 1], u3[..., 2]
    p_spec = _phong_spec_prob(kd, ks)
    wo_d = warp.square_to_cosine_hemisphere(torch.stack([u0, u1], dim=-1))
    # anisotropic half-vector: phi_h with the alpha-ratio tangent warp,
    # quadrant-preserved
    phi_in = 2.0 * math.pi * u1
    phi_h = torch.atan2(alpha_v * torch.sin(phi_in),
                        alpha_u * torch.cos(phi_in))
    cos_ph = torch.cos(phi_h)
    sin_ph = torch.sin(phi_h)
    denom = (cos_ph / alpha_u) ** 2 + (sin_ph / alpha_v) ** 2
    tan2_th = -torch.log(torch.clamp(u0, min=1e-9)) / torch.clamp(denom,
                                                                  min=1e-12)
    cos_th = 1.0 / torch.sqrt(1.0 + tan2_th)
    sin_th = torch.sqrt(torch.clamp(1.0 - cos_th * cos_th, 0.0, 1.0))
    h = torch.stack([sin_th * cos_ph, sin_th * sin_ph, cos_th], dim=-1)
    wo_s = 2.0 * m.dot(wi, h)[..., None] * h - wi
    take_spec = u_sel < p_spec
    wo = torch.where(take_spec[..., None], wo_s, wo_d)
    pdf = pdf_ward(wi, wo, kd, ks, alpha_u, alpha_v)
    f_cos = eval_ward(wi, wo, kd, ks, alpha_u, alpha_v)
    ok = (pdf > 1e-12) & (wo[..., 2] > 0)
    w = torch.where(ok[..., None],
                    f_cos / torch.clamp(pdf, min=1e-12)[..., None], 0.0)
    return wo, w, pdf


# ---------------------------------------------------------------------------
# Diffuse transmission (difftrans.cpp): albedo/pi on the far hemisphere
# ---------------------------------------------------------------------------

def eval_difftrans(wi, wo, albedo):
    """Transmits: wo on the opposite side of wi."""
    opposite = (wi[..., 2] * wo[..., 2]) < 0
    aco = wo[..., 2].abs()
    return torch.where(opposite[..., None],
                       albedo * (aco * _INV_PI)[..., None], 0.0)


def sample_difftrans(u2, wi, albedo):
    local = warp.square_to_cosine_hemisphere(u2)
    # flip to the hemisphere opposite wi
    sign = torch.where(wi[..., 2] > 0, -1.0, 1.0)
    wo = torch.stack([local[..., 0], local[..., 1], sign * local[..., 2]],
                     dim=-1)
    pdf = wo[..., 2].abs() * _INV_PI
    return wo, albedo * torch.ones_like(wo), pdf


# ---------------------------------------------------------------------------
# Smooth plastic (plastic.cpp): delta dielectric coat over Lambert
# ---------------------------------------------------------------------------

def fresnel_dielectric_scalar(cos_i, eta):
    """Unpolarized Fresnel reflectance, cos_i >= 0, eta = int/ext."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin_t2 = (1.0 / (eta * eta)) * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin_t2 >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t2, min=0.0))
    rs = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t, min=1e-12)
    rp = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-12)
    return torch.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))


def eval_plastic_smooth(wi, wo, albedo, eta):
    """The smooth part only (the coat reflection is a delta lobe):
    (1 - F_i)(1 - F_o) albedo / pi cos_o, without the internal-scattering
    series, as the reference."""
    ci, co = wi[..., 2], wo[..., 2]
    valid = (ci > 0) & (co > 0)
    fi = fresnel_dielectric_scalar(ci, eta)
    fo = fresnel_dielectric_scalar(co, eta)
    f = albedo * ((1.0 - fi) * (1.0 - fo) * _INV_PI * co)[..., None]
    return torch.where(valid[..., None], f, 0.0)


def sample_plastic_smooth(u3, wi, albedo, eta):
    """With probability F(cos_i) the delta specular reflection (weight
    1), else the cosine diffuse lobe (weight albedo (1 - F_o)). Returns
    (wo, weight, is_delta)."""
    u_sel, u0, u1 = u3[..., 0], u3[..., 1], u3[..., 2]
    fi = fresnel_dielectric_scalar(wi[..., 2], eta)
    take_spec = u_sel < fi
    wo_s = _reflect_local(wi)
    wo_d = warp.square_to_cosine_hemisphere(torch.stack([u0, u1], dim=-1))
    wo = torch.where(take_spec[..., None], wo_s, wo_d)
    fo = fresnel_dielectric_scalar(wo_d[..., 2], eta)
    w_d = albedo * (1.0 - fo)[..., None]
    w = torch.where(take_spec[..., None], torch.ones_like(albedo), w_d)
    return wo, w, take_spec
