"""Free-flight sampling along a ray segment as the tracer consumes it.

Counterpart of the homogeneous part of alvrl_tpu/media/api.py
(sample_distance_seg_u, _homog_to_distance_sample).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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


def sample_distance_seg_u(med: hmed.HomogeneousMedium, u2, ray_o, ray_d,
                          dist_surf) -> DistanceSample:
    """Free-flight sample along ray_o + t ray_d, t in [0, dist_surf],
    from the uniforms u2 (..., 2)."""
    ms = hmed.sample_distance_u(med, u2, dist_surf)
    return _homog_to_distance_sample(ms, ray_o, ray_d)


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
