"""Phase functions: Henyey-Greenstein (isotropic at g=0), Rayleigh and
the mixture of the two.

Counterpart of alvrl_tpu/media/phase.py for these kinds (the oriented
Kajiya-Kay and microflake kinds keep their numbers, 2 and 3, and wait
for the oriented media: ROADMAP A10). The convention is the reference's:
eval(g, wi, wo) with the lobe written in dot(wi, wo), wi pointing away
from the propagation direction. HG and Rayleigh are sampled exactly
(weight 1); a mixture picks a component by its weight and samples it,
with weight s = sum(w), which is below 1 for an absorbing mixture.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from alvrl_tpu_torch.core import math as m

# phase kinds, numbered as in alvrl_tpu.media.phase
HG = 0
RAYLEIGH = 1
KKAY = 2        # not ported (ROADMAP A10, the oriented media)
MICROFLAKE = 3  # not ported (ROADMAP A10, the oriented media)
MIXTURE = 4     # weighted HG and Rayleigh components

G_EPS = 1e-4  # |g| below which HG is sampled as isotropic


def eval_hg(g, wi, wo):
    """INV_FOURPI * (1 - g^2) / (1 + g^2 + 2 g cos)^(3/2)."""
    temp = torch.clamp(1.0 + g * g + 2.0 * g * m.dot(wi, wo), min=1e-12)
    return m.INV_FOURPI * (1.0 - g * g) / (temp * torch.sqrt(temp))


def eval_rayleigh(wi, wo):
    """3 / (16 pi) * (1 + cos^2), cos = dot(wi, wo)."""
    c = m.dot(wi, wo)
    return (3.0 / (16.0 * math.pi)) * (1.0 + c * c)


class PhaseParams(NamedTuple):
    """A mixture's components, (K,) each: the raw weights (rescaled to sum
    to 1 only when their sum exceeds it), the kinds (HG or RAYLEIGH) and
    the HG g of each (0 = isotropic). `host` holds the same three as
    Python tuples, so that the kernels' medium pack is made without a
    read from the card."""

    mix_w: torch.Tensor
    mix_kind: torch.Tensor
    mix_g: torch.Tensor
    host: tuple = ()


def mixture_params(weights, kinds, gs, device="cuda") -> PhaseParams:
    """A mixture's parameters as alvrl_tpu's mixture_params builds them:
    weights non-negative with a positive sum, rescaled to sum to 1 only
    when the sum exceeds 1 (a sum below 1 is an energy-absorbing
    mixture); components HG or RAYLEIGH."""
    w = np.asarray(weights, np.float64).reshape(-1)
    if w.size == 0 or (w < 0).any() or w.sum() <= 0:
        raise ValueError("mixture weights must be non-negative and sum > 0")
    if w.sum() > 1.0:
        w = w / w.sum()
    k = np.asarray(kinds, np.int64).reshape(-1)
    g = np.asarray(gs, np.float64).reshape(-1)
    if not (w.size == k.size == g.size):
        raise ValueError("mixture component count mismatch")
    if not np.isin(k, [HG, RAYLEIGH]).all():
        raise ValueError("mixture components must be HG or Rayleigh kinds")
    w32, g32 = w.astype(np.float32), g.astype(np.float32)
    return PhaseParams(
        mix_w=torch.as_tensor(w32, device=device),
        mix_kind=torch.as_tensor(k, device=device),
        mix_g=torch.as_tensor(g32, device=device),
        host=(tuple(float(x) for x in w32), tuple(int(x) for x in k),
              tuple(float(x) for x in g32)))


def _mix_component_eval(pp: PhaseParams, wi, wo):
    """(..., K) each component's value at (wi, wo)."""
    c = m.dot(wi, wo)[..., None]
    g = pp.mix_g
    temp = torch.clamp(1.0 + g * g + 2.0 * g * c, min=1e-12)
    hg = m.INV_FOURPI * (1.0 - g * g) / (temp * torch.sqrt(temp))
    ray = (3.0 / (16.0 * math.pi)) * (1.0 + c * c)
    return torch.where(pp.mix_kind == RAYLEIGH, ray, hg)


def eval_mixture(pp: PhaseParams, wi, wo):
    """sum_i w_i eval_i (mixturephase.cpp eval)."""
    return (pp.mix_w * _mix_component_eval(pp, wi, wo)).sum(dim=-1)


def pdf_mixture(pp: PhaseParams, wi, wo):
    """The selection-weighted pdf, eval / s with s = sum(w): each
    component samples its own lobe exactly."""
    return eval_mixture(pp, wi, wo) / torch.clamp(pp.mix_w.sum(), min=1e-12)


def sample_mixture(pp: PhaseParams, wi, u2):
    """A component chosen by the CDF of the weights at u2[..., 0], that
    uniform rescaled into its cell and the component's lobe sampled;
    returns (wo, weight s = sum(w), pdf)."""
    u0, u1 = u2[..., 0], u2[..., 1]
    cdf = torch.cumsum(pp.mix_w, dim=0)
    j = torch.clamp(torch.searchsorted(cdf, (u0 * cdf[-1]).contiguous(),
                                       right=True), 0, cdf.shape[0] - 1)
    lo = torch.where(j > 0, cdf[(j - 1).clamp(min=0)], 0.0)
    u0r = torch.clamp((u0 * cdf[-1] - lo) / torch.clamp(cdf[j] - lo,
                                                        min=1e-12),
                      0.0, 1.0 - 1e-7)
    u2r = torch.stack([u0r, u1], dim=-1)
    wo_hg, _, _ = sample_hg(pp.mix_g[j], wi, u2r)
    wo_ray, _, _ = sample_rayleigh(wi, u2r)
    wo = torch.where((pp.mix_kind[j] == RAYLEIGH)[..., None], wo_ray, wo_hg)
    pdf = pdf_mixture(pp, wi, wo)
    return wo, torch.full_like(pdf, 1.0) * pp.mix_w.sum(), pdf


def _unported(kind):
    return ValueError(f"phase kind {kind} is not ported (HG=0, RAYLEIGH=1, "
                      f"MIXTURE=4; KKAY and MICROFLAKE: ROADMAP A10)")


def eval_phase(kind: int, g, wi, wo, pp=None):
    """The phase value of the kind; `pp`, the PhaseParams of a MIXTURE."""
    if kind == HG:
        return eval_hg(g, wi, wo)
    if kind == RAYLEIGH:
        return eval_rayleigh(wi, wo)
    if kind == MIXTURE:
        return eval_mixture(pp, wi, wo)
    raise _unported(kind)


def pdf_phase(kind: int, g, wi, wo, pp=None):
    """Solid-angle pdf of sample_phase generating wo. As the reference's
    pdf_phase, it is eval_phase for every ported kind, the mixture's
    included (equal to its pdf when the weights sum to 1)."""
    return eval_phase(kind, g, wi, wo, pp=pp)


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


def sample_phase(kind: int, g, wi, u2, pp=None):
    """Sample wo for the phase kind; returns (wo, weight, pdf)."""
    if kind == HG:
        return sample_hg(g, wi, u2)
    if kind == RAYLEIGH:
        return sample_rayleigh(wi, u2)
    if kind == MIXTURE:
        return sample_mixture(pp, wi, u2)
    raise _unported(kind)
