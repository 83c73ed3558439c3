"""Homogeneous participating medium.

Counterpart of alvrl_tpu/media/homogeneous.py: the coefficients, the
phase kind (with a mixture's parameters), the sampling weight, the four
distance-sampling strategies (homogeneous.cpp:149-226), Beer-Lambert
transmittance, free-flight sampling and the deterministic evaluation of
a segment (eval_ray). The medium's tensors may carry a leading lane axis
(sigma_a (..., 3), g and sampling_weight (...)): media.table.medium_at
gathers one medium a lane that way, with the balance strategy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from alvrl_tpu_torch.media.phase import HG

# distance-sampling strategies, numbered as in alvrl_tpu.media.homogeneous
BALANCE = 0   # a random channel's sigma_t, the channels' pdfs averaged
SINGLE = 1    # one fixed channel's sigma_t
MANUAL = 2    # a user-chosen rate
MAXIMUM = 3   # the largest channel's sigma_t


@dataclass(frozen=True)
class HomogeneousMedium:
    sigma_a: torch.Tensor          # (3,) absorption
    sigma_s: torch.Tensor          # (3,) scattering
    g: torch.Tensor                # () HG mean cosine; 0 => isotropic
    sampling_weight: torch.Tensor  # () mediumSamplingWeight
    phase_kind: int = HG           # media.phase kind
    strategy: int = BALANCE        # distance-sampling strategy
    channel: int = 0               # SINGLE: the channel
    density: float = 1.0           # MANUAL: the sampling rate (a float32)
    phase_params: object = None    # media.phase.PhaseParams of a MIXTURE

    @property
    def sigma_t(self):
        return self.sigma_a + self.sigma_s

    @property
    def sampling_density(self):
        """The one exponential rate of the single, manual and maximum
        strategies."""
        if self.strategy == SINGLE:
            return torch.clamp(self.sigma_t[..., self.channel], min=1e-20)
        if self.strategy == MANUAL:
            return torch.clamp(torch.as_tensor(
                self.density, dtype=torch.float32,
                device=self.sigma_a.device), min=1e-20)
        return torch.clamp(self.sigma_t.amax(dim=-1), min=1e-20)  # MAXIMUM


def make_medium(sigma_a, sigma_s, g=0.0, sampling_weight=None, phase_kind=HG,
                strategy=BALANCE, channel=0, density=1.0, phase_params=None,
                device="cuda"):
    """A medium with the reference's default sampling weight (the
    largest channel albedo, clamped to >= 0.5 when the medium scatters)
    unless `sampling_weight` is given."""
    f32 = dict(dtype=torch.float32, device=device)
    sigma_a = torch.as_tensor(sigma_a, **f32)
    sigma_s = torch.as_tensor(sigma_s, **f32)
    if sampling_weight is None:
        sigma_t = sigma_a + sigma_s
        albedo = torch.where(
            sigma_t > 0, sigma_s / torch.clamp(sigma_t, min=1e-20),
            torch.zeros_like(sigma_t))
        w = albedo.max()
        w = torch.where(w > 0, torch.clamp(w, min=0.5), w)
    else:
        w = torch.as_tensor(sampling_weight, **f32)
    return HomogeneousMedium(
        sigma_a=sigma_a, sigma_s=sigma_s, g=torch.as_tensor(g, **f32),
        sampling_weight=w, phase_kind=phase_kind, strategy=strategy,
        channel=channel, density=float(np.float32(density)),
        phase_params=phase_params)


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


def _pdfs(med: HomogeneousMedium, dist, tau):
    """(pdf_success, pdf_failure) of the strategy at distance dist,
    before the sampling weight's mix; tau = exp(-sigma_t dist)."""
    if med.strategy == BALANCE:
        return (med.sigma_t * tau).mean(dim=-1), tau.mean(dim=-1)
    rho = med.sampling_density
    e = torch.exp(-rho * dist)
    return rho * e, e


def _zero_below(tau):
    """The reference zeroes tau whose largest channel is below 1e-20."""
    return torch.where(tau.amax(dim=-1, keepdim=True) < 1e-20, 0.0, tau)


def sample_distance_u(med: HomogeneousMedium, u2, dist_surf):
    """Free-flight distance along a segment of length dist_surf, from
    the uniforms u2 (..., 2): with probability sampling_weight an
    exponential flight (balance: in a channel picked by u2[..., 1]; the
    other strategies: at their one rate), else no interaction; the pdfs
    are the strategy's, mixed with the no-interaction branch.

    The sampled distance is detached (the detached-sampling gradient
    contract); transmittance and pdfs stay differentiable."""
    u = u2[..., 0]
    w = med.sampling_weight
    take = u < w
    u_resc = torch.where(take, u / torch.clamp(w, min=1e-20), 0.0)
    if med.strategy == BALANCE:
        channel = torch.clamp((u2[..., 1] * 3).to(torch.int64), max=2)
        sig_t = med.sigma_t
        if sig_t.dim() == 1:
            density = sig_t[channel]
        else:
            density = torch.gather(sig_t.expand(channel.shape + (3,)), -1,
                                   channel[..., None])[..., 0]
        density = torch.clamp(density, min=1e-20)
    else:
        density = med.sampling_density
    sampled = (-torch.log1p(-torch.clamp(u_resc, max=1.0 - 1e-7))
               / density).detach()
    sampled = torch.where(take, sampled, NO_INTERACTION)
    success = sampled < dist_surf
    t = torch.where(success, sampled, dist_surf)
    tau = torch.exp(-med.sigma_t * t[..., None])
    pdf_success, pdf_failure = _pdfs(med, t, tau)
    pdf_success = pdf_success * w
    pdf_failure = w * pdf_failure + (1.0 - w)
    return MediumSample(success=success, t=t, transmittance=_zero_below(tau),
                        pdf_success=pdf_success, pdf_failure=pdf_failure,
                        sigma_s=med.sigma_s.expand(t.shape + (3,)))


def eval_ray(med: HomogeneousMedium, dist):
    """(transmittance, pdf_success, pdf_failure) over a segment of
    length dist (HomogeneousMedium::eval, homogeneous.cpp:354-396), with
    the sampling weight's mix: the VRL estimator's short-VRL pdfFailure."""
    tau = torch.exp(-med.sigma_t * dist[..., None])
    pdf_success, pdf_failure = _pdfs(med, dist, tau)
    w = med.sampling_weight
    return (_zero_below(tau), pdf_success * w, w * pdf_failure + (1.0 - w))
