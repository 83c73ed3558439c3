"""BSDF sampling at a surface hit.

Counterpart of alvrl_tpu/bsdf/api.py::sample_from_uniforms for the
smooth diffuse (Lambertian) kind and the three delta kinds: the null
boundary, the mirror and the smooth dielectric
(integrators/vrl/specular.py::specular_bounce). It consumes the
reference's N_SAMPLE_DIMS uniforms per hit, of which the diffuse lobe
reads u[..., 1:3] and the delta kinds' lobe choice u[..., 4]. The two
transport modes differ only in the dielectric's refraction: radiance
carries its 1/eta^2 compression, importance (the tracer's) does not
(dielectric.cpp). The other kinds (conductor with roughness, plastic,
...) are not ported (ROADMAP A3).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from alvrl_tpu_torch.core import math as m
from alvrl_tpu_torch.core import warp
from alvrl_tpu_torch.integrators.vrl.specular import specular_bounce
from alvrl_tpu_torch.scene.scene import (
    DIELECTRIC,
    DIFFUSE,
    MIRROR,
    NULL,
    Scene,
)

N_SAMPLE_DIMS = 5  # uniforms consumed per sample, as in the reference
PORTED_KINDS = frozenset((DIFFUSE, NULL, MIRROR, DIELECTRIC))
DELTA_KINDS = frozenset((NULL, MIRROR, DIELECTRIC))
MODES = ("radiance", "importance")


class BSDFSample(NamedTuple):
    wo: torch.Tensor         # (..., 3) world outgoing direction
    weight: torch.Tensor     # (..., 3) f cos / pdf, or a delta lobe's tint
    eta_ratio: torch.Tensor  # relative-IOR change of the sampled lobe
    is_delta: torch.Tensor   # bool: the sampled lobe is a delta lobe
    valid: torch.Tensor      # bool: the sample is usable (always, for the
                             # ported kinds)


def check_kinds(scene: Scene) -> frozenset:
    """The set of material kinds in the table; raises if one is not
    ported (one read of the table, a sync on the card: the tracer
    checks once per trace, not per bounce)."""
    kinds = frozenset(scene.materials.kind.tolist())
    if not kinds <= PORTED_KINDS:
        raise ValueError(f"only the DIFFUSE, NULL, MIRROR and DIELECTRIC "
                         f"materials are ported for sampling (kinds "
                         f"{sorted(kinds)}; ROADMAP A3)")
    return kinds


def sample_from_uniforms(scene: Scene, u, mat_id, ng, ng_raw, d_in,
                         mode: str = "radiance", kinds=None) -> BSDFSample:
    """Sample the BSDF of material mat_id at a hit with the oriented
    normal ng and the winding normal ng_raw, reached along the direction
    d_in (pointing at the surface), from u (..., N_SAMPLE_DIMS), in the
    transport `mode` ("radiance" or "importance"). `kinds`, the set of
    kinds in the table as check_kinds returns it, saves the check (and
    its sync); without it the table is checked here."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if kinds is None:
        kinds = check_kinds(scene)
    s, t = m.build_frame(ng)
    wo = m.frame_to_world(s, t, ng, warp.square_to_cosine_hemisphere(
        u[..., 1:3]))
    weight = scene.materials.albedo[mat_id]
    eta_ratio = torch.ones_like(weight[..., 0])
    is_delta = torch.zeros_like(eta_ratio, dtype=torch.bool)
    if kinds & DELTA_KINDS:
        wo_s, w_s, eta_s, is_delta = specular_bounce(scene, u[..., 4], mat_id,
                                                     d_in, ng_raw)
        if mode == "importance":
            refracted = ((scene.materials.kind[mat_id] == DIELECTRIC)
                         & ((eta_s - 1.0).abs() > 1e-6))
            w_s = torch.where(refracted[..., None], 1.0, w_s)
        wo = torch.where(is_delta[..., None], wo_s, wo)
        weight = torch.where(is_delta[..., None], w_s, weight)
        eta_ratio = torch.where(is_delta, eta_s, 1.0)
    return BSDFSample(wo=wo, weight=weight, eta_ratio=eta_ratio,
                      is_delta=is_delta,
                      valid=torch.ones_like(is_delta))
