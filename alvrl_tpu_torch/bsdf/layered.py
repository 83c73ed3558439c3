"""Layered and slab building blocks: the smooth coating (coating.cpp:
refraction across the coat, the slab's absorption, the shared coating
factors), the Hanrahan-Krueger single-scattering slab (hk.cpp) and the
normal and bump maps (normalmap.cpp, bumpmap.cpp).

Counterpart of alvrl_tpu/bsdf/layered.py, in the local shading frame (z
= shading normal) but for perturbed_normal, which gives the world
shading normal, and bump_to_normal_map, the loader's host-side bake of a
height field.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from alvrl_tpu_torch.bsdf.lobes import fresnel_dielectric_scalar
from alvrl_tpu_torch.core import math as m
from alvrl_tpu_torch.media.phase import eval_hg
from alvrl_tpu_torch.textures.procedural import bitmap_lookup


def refract_z(w_l, inv_eta):
    """Refract a local direction across the z-plane interface, scaling its
    tangential part by inv_eta (coating.cpp:refractTo), keeping the
    hemisphere. Returns (refracted (unit), valid)."""
    x = w_l[..., 0] * inv_eta
    y = w_l[..., 1] * inv_eta
    z2 = 1.0 - x * x - y * y
    valid = z2 > 0.0
    z = torch.sign(w_l[..., 2]) * torch.sqrt(torch.clamp(z2, min=0.0))
    return torch.stack([x, y, z], dim=-1), valid


def coating_absorption(sigma_a, thickness, ci_p, co_p):
    """exp(-sigma_a thickness (1 / |cos_i'| + 1 / |cos_o'|)): the slab's
    absorption along the refracted in and out directions."""
    inv = 1.0 / torch.clamp(ci_p.abs(), min=1e-6) \
        + 1.0 / torch.clamp(co_p.abs(), min=1e-6)
    return torch.exp(-sigma_a * (thickness * inv)[..., None])


def coating_factors(wi_l, wo_l, eta):
    """The coating's shared geometry: the Fresnel terms, the refracted
    directions, and the solid-angle measure factor cos(wo) / cos(wo') /
    eta^2. Returns (fi, fo, wi_p, wo_p, both refract, jac)."""
    fi = fresnel_dielectric_scalar(wi_l[..., 2].abs(), eta)
    fo = fresnel_dielectric_scalar(wo_l[..., 2].abs(), eta)
    wi_p, ok_i = refract_z(wi_l, 1.0 / eta)
    wo_p, ok_o = refract_z(wo_l, 1.0 / eta)
    jac = wo_l[..., 2].abs() / torch.clamp(wo_p[..., 2].abs(), min=1e-6) \
        / (eta * eta)
    return fi, fo, wi_p, wo_p, ok_i & ok_o, jac


def hk_eval(wi_l, wo_l, sigma_s, sigma_a, thickness, g):
    """f |cos_o| of the slab's glossy reflection and transmission
    (hk.cpp:eval, the solid-angle branch, its formulas kept): sigma_s,
    sigma_a (..., 3), thickness and the HG phase's g (...)."""
    tau_d = (sigma_s + sigma_a) * thickness[..., None]
    sig_t = sigma_s + sigma_a
    albedo = torch.where(sig_t > 0.0,
                         sigma_s / torch.clamp(sig_t, min=1e-30), 0.0)
    ci = wi_l[..., 2]
    co = wo_l[..., 2]
    aci = torch.clamp(ci.abs(), min=1e-6)
    aco = torch.clamp(co.abs(), min=1e-6)
    phase = eval_hg(g, wi_l, wo_l)[..., None]
    # reflection (hk.cpp:233-234)
    refl = albedo * phase * (ci / (ci + co))[..., None] * (
        1.0 - torch.exp(-(1.0 / aci + 1.0 / aco)[..., None] * tau_d))
    # transmission (hk.cpp:248-256), split on |ci| ~ |co|
    close = (ci + co).abs() < 1e-4
    trans_eq = albedo * phase * (tau_d / aco[..., None]) * torch.exp(
        -tau_d / aco[..., None])
    denom = torch.where((aci - aco).abs() < 1e-6, 1e-6, aci - aco)
    trans_ne = albedo * phase * (aci / denom)[..., None] * (
        torch.exp(-tau_d / aci[..., None]) - torch.exp(-tau_d / aco[..., None]))
    trans = torch.where(close[..., None], trans_eq, trans_ne)
    dp = ci * co
    out = torch.where((dp > 0)[..., None], refl,
                      torch.where((dp < 0)[..., None], trans, 0.0))
    return torch.clamp(out, min=0.0)


def hk_delta_transmittance(wi_l, sigma_s, sigma_a, thickness):
    """The attenuation (..., 3) of the unscattered straight-through lobe
    (hk.cpp:206)."""
    tau_d = (sigma_s + sigma_a) * thickness[..., None]
    return torch.exp(-tau_d / torch.clamp(wi_l[..., 2].abs(),
                                          min=1e-6)[..., None])


def hk_pdf(wi_l, wo_l):
    """The pdf of the slab's two-sided cosine sampling: |cos_o| / (2 pi)
    on each hemisphere."""
    return 0.5 * wo_l[..., 2].abs() / math.pi


def perturbed_normal(textures, tex_id, ng, uv):
    """The world shading normal of a tangent-space normal texture
    (normalmap.cpp): the bitmap textures[tex_id] at uv, mapped from [0, 1]
    to [-1, 1] in the frame of ng (its z at least 0.1); ng itself where
    the result falls into the other hemisphere."""
    t = bitmap_lookup(textures, tex_id, uv)
    n_tan = 2.0 * t - 1.0
    s_f, t_f = m.build_frame(ng)
    n_w = (s_f * n_tan[..., 0:1] + t_f * n_tan[..., 1:2]
           + ng * torch.clamp(n_tan[..., 2:3], min=0.1))
    n_w = m.normalize(n_w)
    flip = m.dot(n_w, ng) < 0.0
    return torch.where(flip[..., None], ng, n_w)


def bump_to_normal_map(height, strength=1.0):
    """The tangent normal map (H, W, 3) in [0, 1] of a (H, W) height
    texture, numpy on the host: bumpmap.cpp's dh/du, dh/dv by central
    differences, baked once at load time."""
    h = np.asarray(height, np.float32)
    gy, gx = np.gradient(h)
    n = np.stack([-gx * strength, -gy * strength, np.ones_like(h)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return (n * 0.5 + 0.5).astype(np.float32)
