"""Phase functions: Henyey-Greenstein (isotropic at g=0) and Rayleigh.

Counterpart of alvrl_tpu/media/phase.py for these two kinds. The
convention is the reference's: eval(g, wi, wo) with the lobe written in
dot(wi, wo), wi pointing away from the propagation direction. Both are
sampled exactly (weight 1).
"""

from __future__ import annotations

import math

import torch

from alvrl_tpu_torch.core import math as m

# phase kinds, numbered as in alvrl_tpu.media.phase
HG = 0
RAYLEIGH = 1

G_EPS = 1e-4  # |g| below which HG is sampled as isotropic


def eval_hg(g, wi, wo):
    """INV_FOURPI * (1 - g^2) / (1 + g^2 + 2 g cos)^(3/2)."""
    temp = torch.clamp(1.0 + g * g + 2.0 * g * m.dot(wi, wo), min=1e-12)
    return m.INV_FOURPI * (1.0 - g * g) / (temp * torch.sqrt(temp))


def eval_rayleigh(wi, wo):
    """3 / (16 pi) * (1 + cos^2), cos = dot(wi, wo)."""
    c = m.dot(wi, wo)
    return (3.0 / (16.0 * math.pi)) * (1.0 + c * c)


def eval_phase(kind: int, g, wi, wo):
    if kind == HG:
        return eval_hg(g, wi, wo)
    if kind == RAYLEIGH:
        return eval_rayleigh(wi, wo)
    raise ValueError(f"phase kind {kind} is not ported (HG=0, RAYLEIGH=1)")


def _around(wi, cos_theta, u1):
    """World direction at polar cos_theta and azimuth 2 pi u1 in the
    frame around -wi (pRec.wo = Frame(-wi).toWorld(...))."""
    local = m.spherical_direction(cos_theta, 2.0 * math.pi * u1)
    s, t = m.build_frame(-wi)
    return m.frame_to_world(s, t, -wi, local)


def sample_hg(g, wi, u2):
    """HG inverse-CDF sample of wo given wi, with the isotropic case at
    |g| < G_EPS; returns (wo, weight 1, pdf)."""
    u0 = u2[..., 0]
    iso = g.abs() < G_EPS
    g_safe = torch.where(iso, G_EPS, g)
    sqr = (1.0 - g_safe * g_safe) / (1.0 - g_safe + 2.0 * g_safe * u0)
    cos_hg = (1.0 + g_safe * g_safe - sqr * sqr) / (2.0 * g_safe)
    cos_theta = torch.where(iso, 1.0 - 2.0 * u0, cos_hg)
    wo = _around(wi, cos_theta, u2[..., 1])
    pdf = eval_hg(g, wi, wo)
    return wo, torch.ones_like(pdf), pdf


def sample_rayleigh(wi, u2):
    """Rayleigh inverse-CDF sample: cos theta solves mu^3 + 3 mu =
    8 u - 4 (Cardano); returns (wo, weight 1, pdf)."""
    q = 4.0 * u2[..., 0] - 2.0
    croot = torch.pow(q + torch.sqrt(q * q + 1.0), 1.0 / 3.0)  # base > 0
    cos_theta = torch.clamp(croot - 1.0 / croot, -1.0, 1.0)
    wo = _around(wi, cos_theta, u2[..., 1])
    pdf = eval_rayleigh(wi, wo)
    return wo, torch.ones_like(pdf), pdf


def sample_phase(kind: int, g, wi, u2):
    """Sample wo for the phase kind; returns (wo, weight, pdf)."""
    if kind == HG:
        return sample_hg(g, wi, u2)
    if kind == RAYLEIGH:
        return sample_rayleigh(wi, u2)
    raise ValueError(f"phase kind {kind} is not ported (HG=0, RAYLEIGH=1)")
