"""The smooth coating's building blocks (coating.cpp): refraction across
the coat, the slab's absorption and the shared coating factors.

Counterpart of the coating part of alvrl_tpu/bsdf/layered.py (:21-56),
in the local shading frame (z = shading normal); the normal and bump
maps and the Hanrahan-Krueger slab are not ported (ROADMAP A11).
"""

from __future__ import annotations

import torch

from alvrl_tpu_torch.bsdf.lobes import fresnel_dielectric_scalar


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
