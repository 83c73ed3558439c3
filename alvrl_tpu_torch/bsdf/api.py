"""BSDF sampling at a surface hit.

Counterpart of alvrl_tpu/bsdf/api.py::sample_from_uniforms for the
smooth diffuse (Lambertian) kind, the only material kind of BASELINE
config 1. It consumes the reference's N_SAMPLE_DIMS uniforms per hit,
of which the diffuse lobe reads u[..., 1:3]. A diffuse sample is always
valid and leaves the relative IOR at 1, so neither is returned.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from alvrl_tpu_torch.core import math as m
from alvrl_tpu_torch.core import warp
from alvrl_tpu_torch.scene.scene import DIFFUSE, Scene

N_SAMPLE_DIMS = 5  # uniforms consumed per sample, as in the reference


class BSDFSample(NamedTuple):
    wo: torch.Tensor      # (..., 3) world outgoing direction
    weight: torch.Tensor  # (..., 3) f cos / pdf


def sample_from_uniforms(scene: Scene, u, mat_id, ng) -> BSDFSample:
    """Sample the BSDF of material mat_id at a hit with the oriented
    normal ng, from u (..., N_SAMPLE_DIMS); the importance- and
    radiance-transport modes agree for this kind. Raises if the
    material table holds a kind that is not ported."""
    kinds = scene.materials.kind
    if bool((kinds != DIFFUSE).any()):
        raise ValueError("only DIFFUSE materials are ported for sampling "
                         f"(kinds {kinds.tolist()})")
    s, t = m.build_frame(ng)
    wo = m.frame_to_world(s, t, ng, warp.square_to_cosine_hemisphere(
        u[..., 1:3]))
    return BSDFSample(wo=wo, weight=scene.materials.albedo[mat_id])
