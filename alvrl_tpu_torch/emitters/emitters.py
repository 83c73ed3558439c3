"""Emitter table and emission sampling.

Counterpart of alvrl_tpu/emitters/emitters.py for point emitters, the
kind of BASELINE config 1: a struct-of-arrays table with a kind column
and a stored selection pmf. A point light emits `intensity` uniformly
over the sphere, so a light path starts at its position with weight
intensity * 4 pi / pmf (point.cpp:82-89).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from alvrl_tpu_torch.core import spectrum, warp

# emitter kinds, numbered as in alvrl_tpu.emitters.emitters
POINT = 0


@dataclass(frozen=True)
class Emitters:
    kind: torch.Tensor       # (E,) int64
    position: torch.Tensor   # (E, 3) f32
    intensity: torch.Tensor  # (E, 3) f32 radiant intensity
    pmf: torch.Tensor        # (E,) f32 selection pmf, a stored constant


def make_point_emitters(position, intensity, device="cuda") -> Emitters:
    """Point lights with the reference's luminance-weighted selection
    pmf (Scene::m_emitterPDF)."""
    f32 = dict(dtype=torch.float32, device=device)
    position = torch.as_tensor(position, **f32).reshape(-1, 3)
    intensity = torch.as_tensor(intensity, **f32).reshape(-1, 3)
    lum = spectrum.luminance(intensity)
    return Emitters(
        kind=torch.full((len(position),), POINT, dtype=torch.int64,
                        device=device),
        position=position, intensity=intensity,
        pmf=lum / torch.clamp(lum.sum(), min=1e-30))


def sample_emission(em: Emitters, u):
    """Start of a light path from the uniforms u (..., 3): u[..., 0]
    picks the emitter by inverting the CDF of its pmf, u[..., 1:3] the
    uniform-sphere direction. Returns (position, direction, weight)."""
    if bool((em.kind != POINT).any()):
        raise ValueError("only point emitters are ported "
                         f"(kinds {em.kind.tolist()})")
    cdf = torch.cumsum(em.pmf, dim=0)
    idx = torch.searchsorted(cdf, (u[..., 0] * cdf[-1]).contiguous())
    idx = torch.clamp(idx, max=len(cdf) - 1)
    weight = em.intensity[idx] / em.pmf[idx][..., None] * (4.0 * math.pi)
    return em.position[idx], warp.square_to_uniform_sphere(u[..., 1:3]), \
        weight
