"""BSDF sampling at a surface hit.

Counterpart of alvrl_tpu/bsdf/api.py::sample_from_uniforms in the
importance mode the tracer uses, for the smooth diffuse (Lambertian)
kind and the null boundary. It consumes the reference's N_SAMPLE_DIMS
uniforms per hit, of which the diffuse lobe reads u[..., 1:3]; a null
boundary passes the ray on unchanged with weight 1
(integrators/vrl/specular.py::specular_bounce there). Both samples are
always valid and leave the relative IOR at 1, so neither is returned.
The other kinds (mirror, dielectric, ...) are not ported (ROADMAP A3).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from alvrl_tpu_torch.core import math as m
from alvrl_tpu_torch.core import warp
from alvrl_tpu_torch.scene.scene import DIFFUSE, NULL, Scene

N_SAMPLE_DIMS = 5  # uniforms consumed per sample, as in the reference


class BSDFSample(NamedTuple):
    wo: torch.Tensor      # (..., 3) world outgoing direction
    weight: torch.Tensor  # (..., 3) f cos / pdf


def check_kinds(scene: Scene):
    """Raise if the material table holds a kind that is not ported (one
    read of the table, a sync on the card: the tracer checks once per
    trace, not per bounce)."""
    kinds = scene.materials.kind
    if bool(((kinds != DIFFUSE) & (kinds != NULL)).any()):
        raise ValueError("only DIFFUSE and NULL materials are ported for "
                         f"sampling (kinds {kinds.tolist()}; ROADMAP A3)")


def sample_from_uniforms(scene: Scene, u, mat_id, ng, d_in,
                         kinds_checked: bool = False) -> BSDFSample:
    """Sample the BSDF of material mat_id at a hit with the oriented
    normal ng, reached along the direction d_in (pointing at the
    surface), from u (..., N_SAMPLE_DIMS); the importance- and
    radiance-transport modes agree for these kinds. Raises if the
    material table holds a kind that is not ported (check_kinds),
    unless the caller has checked it (`kinds_checked`)."""
    if not kinds_checked:
        check_kinds(scene)
    s, t = m.build_frame(ng)
    wo = m.frame_to_world(s, t, ng, warp.square_to_cosine_hemisphere(
        u[..., 1:3]))
    null = (scene.materials.kind[mat_id] == NULL)[..., None]
    return BSDFSample(
        wo=torch.where(null, d_in, wo),
        weight=torch.where(null, 1.0, scene.materials.albedo[mat_id]))
