"""Phase functions: Henyey-Greenstein (isotropic at g=0), Rayleigh, the
mixture of the two, and the oriented Kajiya-Kay and Gaussian
micro-flake kinds.

Counterpart of alvrl_tpu/media/phase.py. The convention is the
reference's: eval(g, wi, wo) with the lobe written in dot(wi, wo), wi
pointing away from the propagation direction. HG and Rayleigh are
sampled exactly (weight 1); a mixture picks a component by its weight
and samples it, with weight s = sum(w), which is below 1 for an
absorbing mixture. The oriented kinds (kkay.cpp, microflake.cpp) read a
local fiber direction that the medium supplies (media.heterogeneous.
lookup_orientation): Kajiya-Kay samples the uniform sphere with weight
eval * 4 pi; the micro-flake kind picks one of K flake normals drawn
from its fiber distribution by sampling-importance-resampling on
|wi . h|, from (K, 3) uniforms u_sir, as the JAX package does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from alvrl_tpu_torch.core import math as m
from alvrl_tpu_torch.core import warp

# phase kinds, numbered as in alvrl_tpu.media.phase
HG = 0
RAYLEIGH = 1
KKAY = 2        # Kajiya-Kay fibers (an orientation volume)
MICROFLAKE = 3  # Gaussian fiber micro-flakes (an orientation volume)
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
    """The parameters of a MIXTURE or an oriented kind; the fields of the
    other kinds are None.

    A mixture's components, (K,) each: the raw weights (rescaled to sum
    to 1 only when their sum exceeds it), the kinds (HG or RAYLEIGH) and
    the HG g of each (0 = isotropic). `host` holds the same three as
    Python tuples, so that the kernels' medium pack is made without a
    read from the card. Kajiya-Kay: ks, kd, exponent and the lobe's
    normalisation, () each. Micro-flakes: the fibers' stddev () and
    sigma_t_lut (L,), sigma_t(|cos theta|) against the fiber on a
    uniform |cos| grid."""

    mix_w: torch.Tensor = None
    mix_kind: torch.Tensor = None
    mix_g: torch.Tensor = None
    host: tuple = ()
    ks: torch.Tensor = None
    kd: torch.Tensor = None
    exponent: torch.Tensor = None
    norm: torch.Tensor = None
    stddev: torch.Tensor = None
    sigma_t_lut: torch.Tensor = None


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


def _unknown(kind):
    return ValueError(f"unknown phase kind {kind} (HG=0, RAYLEIGH=1, "
                      f"KKAY=2, MICROFLAKE=3, MIXTURE=4)")


def _need_orientation(kind, orientation):
    if orientation is None:
        raise ValueError(f"phase kind {kind} (oriented) needs the medium's "
                         "fiber orientation at the point")


def eval_phase(kind: int, g, wi, wo, orientation=None, pp=None):
    """The phase value of the kind; `pp`, the PhaseParams of a MIXTURE or
    an oriented kind, whose `orientation` (..., 3) is the local fiber
    direction."""
    if kind == HG:
        return eval_hg(g, wi, wo)
    if kind == RAYLEIGH:
        return eval_rayleigh(wi, wo)
    if kind == MIXTURE:
        return eval_mixture(pp, wi, wo)
    if kind in (KKAY, MICROFLAKE):
        _need_orientation(kind, orientation)
        fn = eval_kkay if kind == KKAY else eval_microflake
        return fn(pp, orientation, wi, wo)
    raise _unknown(kind)


def pdf_phase(kind: int, g, wi, wo, orientation=None, pp=None):
    """Solid-angle pdf of sample_phase generating wo. As the reference's
    pdf_phase, it is eval_phase for every kind but Kajiya-Kay, which
    samples the uniform sphere (1 / (4 pi)); the mixture's included
    (equal to its pdf when the weights sum to 1)."""
    if kind == KKAY:
        return torch.full_like(m.dot(wi, wo), m.INV_FOURPI)
    return eval_phase(kind, g, wi, wo, orientation=orientation, pp=pp)


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


def sample_phase(kind: int, g, wi, u2, orientation=None, pp=None,
                 u_sir=None):
    """Sample wo for the phase kind; returns (wo, weight, pdf). The
    micro-flake kind reads u_sir (..., K, 3) in place of u2."""
    if kind == HG:
        return sample_hg(g, wi, u2)
    if kind == RAYLEIGH:
        return sample_rayleigh(wi, u2)
    if kind == MIXTURE:
        return sample_mixture(pp, wi, u2)
    if kind == KKAY:
        _need_orientation(kind, orientation)
        return sample_kkay(pp, orientation, wi, u2)
    if kind == MICROFLAKE:
        _need_orientation(kind, orientation)
        if u_sir is None:
            raise ValueError("the micro-flake sample needs its (..., K, 3) "
                             "uniforms u_sir")
        return sample_microflake(pp, orientation, wi, u_sir)
    raise _unknown(kind)


# ---------------------------------------------------------------------------
# Oriented kinds: Kajiya-Kay (kkay.cpp) and the Gaussian fiber micro-flake
# distribution (microflake.cpp, microflake_fiber.h)
# ---------------------------------------------------------------------------

SIR_CANDIDATES = 16  # K, the micro-flake sample's candidate normals


def kkay_params(ks=0.4, kd=0.2, exponent=4.0, device="cuda") -> PhaseParams:
    """Kajiya-Kay with the reference's normalisation of the cos^n lobe
    under perpendicular illumination, a Simpson quadrature of 1,000
    parts (kkay.cpp:58-75), in float64 on the host."""
    n_parts = 1000
    theta = np.linspace(0.0, np.pi, n_parts + 1)
    vals = np.cos(theta - np.pi / 2) ** exponent * np.sin(theta)
    w = np.ones(n_parts + 1)
    w[1:-1:2], w[2:-1:2] = 4.0, 2.0
    integral = (vals * w).sum() * (np.pi / n_parts) / 3.0
    norm = 1.0 / (integral * 2.0 * np.pi)

    def f32(x):
        return torch.tensor(np.float32(x), device=device)

    return PhaseParams(ks=f32(ks), kd=f32(kd), exponent=f32(exponent),
                       norm=f32(norm))


# LUT rows of microflake_params' quadrature taken at a time: 8 rows of
# its (n_quad, n_quad) float64 temporaries are 16 MB each at n_quad 512
_LUT_CHUNK = 8


def microflake_params(stddev=0.2, lut_size=128, n_quad=512,
                      device="cuda") -> PhaseParams:
    """The Gaussian fiber micro-flake distribution (Zhao et al. 2011, as in
    microflake_fiber.h): sigma_t(cos theta_i) = int |w_i . m| D(m) dm on
    a uniform |cos| grid of lut_size points, by a midpoint quadrature of
    n_quad x n_quad over the flake normals m (polar about the fiber axis,
    and azimuth), in float64 on the host, as the JAX package's
    microflake_params. Built lut_size rows at a time in chunks of
    _LUT_CHUNK, so that its temporaries stay small; each row's sum is the
    same as in one (L, Q, Q) array."""
    s = float(stddev)
    norm = _microflake_norm(s)
    mz = (np.arange(n_quad) + 0.5) / n_quad * 2.0 - 1.0
    phi = (np.arange(n_quad) + 0.5) / n_quad * 2.0 * np.pi
    sz = np.sqrt(np.maximum(0.0, 1.0 - mz * mz))
    d_flake = norm * np.exp(-mz * mz / (2 * s * s))
    cos_i = (np.arange(lut_size) / (lut_size - 1)).astype(np.float64)
    sin_i = np.sqrt(np.maximum(0.0, 1.0 - cos_i ** 2))
    lut = np.empty(lut_size)
    for r0 in range(0, lut_size, _LUT_CHUNK):
        r1 = min(lut_size, r0 + _LUT_CHUNK)
        dots = np.abs(
            sin_i[r0:r1, None, None] * (sz[None, :, None]
                                        * np.cos(phi)[None, None, :])
            + cos_i[r0:r1, None, None] * mz[None, :, None])
        lut[r0:r1] = (dots * d_flake[None, :, None]).sum(axis=(1, 2)) * (
            (2.0 / n_quad) * (2.0 * np.pi / n_quad))
    return PhaseParams(
        stddev=torch.tensor(np.float32(s), device=device),
        sigma_t_lut=torch.as_tensor(lut.astype(np.float32), device=device))


def _np_erf(x):
    """erf without scipy (Abramowitz-Stegun 7.1.26, |error| < 1.5e-7),
    as the JAX package's host normalisation takes it."""
    x = np.asarray(x, np.float64)
    sign = np.sign(x)
    x = np.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * x)
    y = 1.0 - (((((1.061405429 * t - 1.453152027) * t) + 1.421413741)
                * t - 0.284496736) * t + 0.254829592) * t * np.exp(-x * x)
    return sign * y


def _microflake_norm(s):
    return 1.0 / ((2.0 * np.pi) ** 1.5 * s * _np_erf(1.0 / (np.sqrt(2) * s)))


def _lut_interp(lut, x):
    """Linear interpolation of a (K,) lut over x in [0, 1]."""
    k = lut.shape[0]
    gx = torch.clamp(x, 0.0, 1.0) * (k - 1)
    i0 = torch.clamp(torch.floor(gx), 0.0, k - 2.0)
    f = gx - i0
    i0 = i0.to(torch.int64)
    return lut[i0] * (1.0 - f) + lut[i0 + 1] * f


def microflake_sigma_dir(pp: PhaseParams, cos_theta):
    """The directional extinction factor sigmaDir = 2 sigma_t(|cos|)
    (microflake.cpp sigmaDir: an isotropic flake distribution gives an
    isotropic medium)."""
    return 2.0 * _lut_interp(pp.sigma_t_lut, cos_theta.abs())


def _fiber_pdf_cos(pp: PhaseParams, c):
    s = pp.stddev
    norm = 1.0 / ((2.0 * math.pi) ** 1.5 * s
                  * torch.erf(1.0 / (math.sqrt(2.0) * s)))
    return torch.exp(-c * c / (2.0 * s * s)) * norm


def _unit(orientation):
    """(orientation normalised, its length)."""
    olen = m.length(orientation)
    return orientation / torch.clamp(olen, min=1e-12)[..., None], olen


def eval_microflake(pp: PhaseParams, orientation, wi, wo):
    """0.5 D(cos_h) / sigma_t(cos_i) in the fiber frame (microflake.cpp
    eval); 0 where the orientation is undefined (a zero vector)."""
    o, olen = _unit(orientation)
    h = wi + wo
    hlen = m.length(h)
    cos_h = m.dot(h, o) / torch.clamp(hlen, min=1e-12)
    sig = _lut_interp(pp.sigma_t_lut, m.dot(wi, o).abs())
    val = 0.5 * _fiber_pdf_cos(pp, cos_h) / torch.clamp(sig, min=1e-12)
    return torch.where((olen > 1e-8) & (hlen > 1e-12), val, 0.0)


def sample_microflake(pp: PhaseParams, orientation, wi, u_sir):
    """A flake normal h by sampling-importance-resampling, and wo = wi
    mirrored about it; returns (wo, weight, pdf). The reference
    rejection-samples H ~ D and accepts with |wi . H| (microflake.cpp
    sample); the JAX package, as here, draws K = u_sir.shape[-2]
    candidates from D (u_sir[..., k, 0:2]: the longitudinal cos by the
    closed-form inverse sqrt(2) s erfinv((1 - 2 xi) erf(1 / (sqrt(2)
    s))), and the azimuth) and picks one by the CDF of |wi . h| at
    u_sir[..., 0, 2]. Weight 0 and wo = -wi where the orientation is
    undefined or every candidate is perpendicular to wi."""
    o, olen = _unit(orientation)
    s_f, t_f = m.build_frame(o)
    s = pp.stddev
    c1 = torch.erf(1.0 / (math.sqrt(2.0) * s))
    xi = u_sir[..., 0]
    cos_t = math.sqrt(2.0) * s * torch.erfinv(
        torch.clamp((1.0 - 2.0 * xi) * c1, -0.999999, 0.999999))
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * u_sir[..., 1]
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                         cos_t], dim=-1)
    h = m.frame_to_world(s_f[..., None, :], t_f[..., None, :],
                         o[..., None, :], local)          # (..., K, 3)
    w = (h * wi[..., None, :]).sum(dim=-1).abs()         # (..., K)
    w_sum = w.sum(dim=-1)
    cdf = torch.cumsum(w, dim=-1)
    pick = torch.searchsorted(cdf, (u_sir[..., 0, 2] * w_sum)[..., None])
    pick = torch.clamp(pick, 0, w.shape[-1] - 1)
    h_sel = torch.take_along_dim(h, pick[..., None], dim=-2)[..., 0, :]
    wo = 2.0 * (wi * h_sel).sum(dim=-1, keepdim=True) * h_sel - wi
    ok = (olen > 1e-8) & (w_sum > 1e-12)
    weight = torch.where(ok, 1.0, 0.0)
    wo = torch.where(ok[..., None], wo, -wi)
    return wo, weight, eval_microflake(pp, orientation, wi, wo)


def eval_kkay(pp: PhaseParams, orientation, wi, wo):
    """Kajiya-Kay (kkay.cpp eval): the isotropic kd / (4 pi) term plus the
    ks cos^n lobe about the specular direction mirrored across the fiber;
    the isotropic term alone where the orientation is undefined."""
    o, olen = _unit(orientation)
    iso = pp.kd * m.INV_FOURPI
    s_f, t_f = m.build_frame(o)
    wo_l = m.frame_to_local(s_f, t_f, o, wo)
    z = -m.dot(wi, o)
    xy2 = wo_l[..., 0] ** 2 + wo_l[..., 1] ** 2
    a = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0)
                   / torch.clamp(xy2, min=1e-12))
    refl_l = torch.stack([wo_l[..., 0] * a, wo_l[..., 1] * a, z], dim=-1)
    r = m.frame_to_world(s_f, t_f, o, refl_l)
    spec = torch.clamp(m.dot(r, wo), min=0.0) ** pp.exponent * pp.norm \
        * pp.ks
    return torch.where(olen > 1e-8, spec + iso, iso)


def sample_kkay(pp: PhaseParams, orientation, wi, u2):
    """Uniform-sphere sampling with weight eval * 4 pi (kkay.cpp sample);
    returns (wo, weight, pdf 1 / (4 pi))."""
    wo = warp.square_to_uniform_sphere(u2)
    val = eval_kkay(pp, orientation, wi, wo)
    return wo, val * (4.0 * math.pi), torch.full_like(val, m.INV_FOURPI)
