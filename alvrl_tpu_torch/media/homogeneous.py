"""Homogeneous participating medium.

Counterpart of alvrl_tpu/media/homogeneous.py, reduced to what the VRL
render reads: the coefficients, the phase kind, the default "balance"
sampling weight, and Beer-Lambert transmittance.
"""

from __future__ import annotations

from dataclasses import dataclass

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


def make_medium(sigma_a, sigma_s, g=0.0, device="cpu"):
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
