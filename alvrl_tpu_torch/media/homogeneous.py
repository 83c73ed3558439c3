"""Homogeneous participating medium.

Counterpart of alvrl_tpu/media/homogeneous.py, reduced to what the VRL
render and tracer read: the coefficients, the phase kind, the default
"balance" sampling weight and strategy, Beer-Lambert transmittance and
free-flight sampling.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from alvrl_tpu_torch.media.phase import HG


@dataclass(frozen=True)
class HomogeneousMedium:
    sigma_a: torch.Tensor          # (3,) absorption
    sigma_s: torch.Tensor          # (3,) scattering
    g: torch.Tensor                # () HG mean cosine; 0 => isotropic
    sampling_weight: torch.Tensor  # () mediumSamplingWeight
    phase_kind: int = HG           # media.phase kind

    @property
    def sigma_t(self):
        return self.sigma_a + self.sigma_s


def make_medium(sigma_a, sigma_s, g=0.0, device="cuda"):
    """HG medium with the reference's default sampling weight: the
    largest channel albedo, clamped to >= 0.5 when the medium scatters."""
    f32 = dict(dtype=torch.float32, device=device)
    sigma_a = torch.as_tensor(sigma_a, **f32)
    sigma_s = torch.as_tensor(sigma_s, **f32)
    sigma_t = sigma_a + sigma_s
    albedo = torch.where(
        sigma_t > 0, sigma_s / torch.clamp(sigma_t, min=1e-20),
        torch.zeros_like(sigma_t))
    w = albedo.max()
    w = torch.where(w > 0, torch.clamp(w, min=0.5), w)
    return HomogeneousMedium(
        sigma_a=sigma_a, sigma_s=sigma_s, g=torch.as_tensor(g, **f32),
        sampling_weight=w,
    )


def eval_transmittance(med: HomogeneousMedium, dist):
    """Beer-Lambert tau = exp(-sigma_t * dist), (..., 3)."""
    return torch.exp(-med.sigma_t * dist[..., None])


NO_INTERACTION = 3e30  # sampled distance of the "no medium interaction"
                       # branch: finite, and above every surface-miss
                       # distance (1e30), so it never reads as an event


class MediumSample(NamedTuple):
    """Counterpart of MediumSamplingRecord."""

    success: torch.Tensor        # bool: a medium interaction before the surface
    t: torch.Tensor              # its distance, else the surface distance
    transmittance: torch.Tensor  # (..., 3) tau over [0, t]
    pdf_success: torch.Tensor    # pdf of sampling this interaction
    pdf_failure: torch.Tensor    # probability of passing the surface
    sigma_s: torch.Tensor        # (..., 3)


def sample_distance_u(med: HomogeneousMedium, u2, dist_surf):
    """Free-flight distance along a segment of length dist_surf, from
    the uniforms u2 (..., 2), by the reference's default "balance"
    strategy: with probability sampling_weight an exponential flight in
    a channel picked by u2[..., 1], else no interaction; the pdfs are
    the channel average mixed with the no-interaction branch.

    The sampled distance is detached (the detached-sampling gradient
    contract); transmittance and pdfs stay differentiable."""
    u = u2[..., 0]
    w = med.sampling_weight
    take = u < w
    u_resc = torch.where(take, u / torch.clamp(w, min=1e-20), 0.0)
    channel = torch.clamp((u2[..., 1] * 3).to(torch.int64), max=2)
    density = torch.clamp(med.sigma_t[channel], min=1e-20)
    sampled = (-torch.log1p(-torch.clamp(u_resc, max=1.0 - 1e-7))
               / density).detach()
    sampled = torch.where(take, sampled, NO_INTERACTION)
    success = sampled < dist_surf
    t = torch.where(success, sampled, dist_surf)
    tau = torch.exp(-med.sigma_t * t[..., None])
    pdf_success = (med.sigma_t * tau).mean(dim=-1) * w
    pdf_failure = w * tau.mean(dim=-1) + (1.0 - w)
    # the reference zeroes tau whose largest channel is below 1e-20
    tau = torch.where(tau.amax(dim=-1, keepdim=True) < 1e-20, 0.0, tau)
    return MediumSample(success=success, t=t, transmittance=tau,
                        pdf_success=pdf_success, pdf_failure=pdf_failure,
                        sigma_s=med.sigma_s.expand(t.shape + (3,)))
