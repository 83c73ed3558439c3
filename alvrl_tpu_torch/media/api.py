"""One interface over the homogeneous and the grid medium, as the tracer
and the render consume it.

Counterpart of alvrl_tpu/media/api.py (is_homogeneous, transmittance,
eval_ray_seg, sigma_s_at, sample_distance_seg[_u],
_homog_to_distance_sample). Grid
media read the grid of their quadratures that the caller computed once
per entry-point call (media.heterogeneous.quad_grid: the supersample, or
with fast_tau False the density), and their free-flight sampler reads
explicit uniforms: Woodcock tracking its tracking uniforms, the
quadrature inversion (sampling = 1) the first distance uniform.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from alvrl_tpu_torch.core import math as m
from alvrl_tpu_torch.media import heterogeneous as gmed
from alvrl_tpu_torch.media import homogeneous as hmed


class DistanceSample(NamedTuple):
    """w_scatter: throughput factor of a medium event (tau * sigma_s /
    pdfSuccess); w_pass: factor of passing on to the surface (tau /
    pdfFailure)."""

    success: torch.Tensor
    t: torch.Tensor
    p: torch.Tensor
    w_scatter: torch.Tensor
    w_pass: torch.Tensor


def is_homogeneous(med) -> bool:
    return isinstance(med, hmed.HomogeneousMedium)


def tracks(med) -> bool:
    """Whether med's free flights read Woodcock tracking uniforms: a grid
    medium of sampling 0 (sampling 1 reads one distance uniform)."""
    return not is_homogeneous(med) and med.sampling == 0


def transmittance(med, p0, p1, density_ss=None):
    """Spectral tau along the open segment p0 -> p1 (no occlusion test)."""
    if is_homogeneous(med):
        return hmed.eval_transmittance(med, m.distance(p0, p1))
    return gmed.eval_transmittance(med, density_ss, p0, p1)


def eval_ray_seg(med, p0, p1, density_ss=None):
    """(tau, pdf_success, pdf_failure) over the segment p0 -> p1
    (Medium::eval)."""
    if is_homogeneous(med):
        return hmed.eval_ray(med, m.distance(p0, p1))
    return gmed.eval_ray(med, density_ss, p0, p1)


def sigma_s_at(med, p, density_ss=None):
    """(..., 3) scattering coefficient at p (grid media: the density as
    the quadratures read it, nearest in the supersample density_ss, or
    trilinear with fast_tau False)."""
    if is_homogeneous(med):
        return med.sigma_s.expand(p.shape)
    if med.fast_tau:
        d = gmed.lookup_density_nn(med, density_ss, p)
    else:
        d = gmed.lookup_density(med, p)
    return d[..., None] * med.sigma_s_color


def sample_distance_seg_u(med, u2, ray_o, ray_d, dist_surf, *, u_track=None,
                          density_ss=None, active=None) -> DistanceSample:
    """Free-flight sample along ray_o + t ray_d, t in [0, dist_surf]:
    homogeneous media from the uniforms u2 (..., 2); grid media by
    Woodcock tracking from u_track (..., TRACKING_DRAWS, 2), with lanes
    where `active` is False frozen (media.heterogeneous.sample_distance),
    or with sampling = 1 by the quadrature inversion from u2[..., 0]
    (sample_distance_quadrature; u_track unused)."""
    if is_homogeneous(med):
        ms = hmed.sample_distance_u(med, u2, dist_surf)
        return _homog_to_distance_sample(ms, ray_o, ray_d)
    if med.sampling == 1:
        gs = gmed.sample_distance_quadrature(med, density_ss, u2[..., 0],
                                             ray_o, ray_d, dist_surf)
    else:
        gs = gmed.sample_distance(med, density_ss, u_track, ray_o, ray_d,
                                  dist_surf, active)
    ok = gs.success[..., None]
    return DistanceSample(success=gs.success, t=gs.t, p=gs.p,
                          w_scatter=torch.where(ok, gs.weight, 0.0),
                          w_pass=torch.where(ok, 0.0, gs.weight))


def _homog_to_distance_sample(ms: hmed.MediumSample, ray_o, ray_d):
    # Detached sampling: the location t is detached and so are the pdf
    # DENOMINATORS. For f tau / p with t ~ p, d/dtheta E[f tau / sg(p)]
    # is the integral of f d(tau)/dtheta: the score term of the moving
    # density cancels against the differentiated denominator, while
    # the numerator factors (tau, sigma_s) stay differentiable.
    p = ray_o + ms.t[..., None] * ray_d
    w_scatter = ms.transmittance * ms.sigma_s / torch.clamp(
        ms.pdf_success, min=1e-30).detach()[..., None]
    w_pass = ms.transmittance / torch.clamp(
        ms.pdf_failure, min=1e-30).detach()[..., None]
    return DistanceSample(success=ms.success, t=ms.t, p=p,
                          w_scatter=w_scatter, w_pass=w_pass)
