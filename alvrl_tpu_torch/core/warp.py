"""Sample warping: unit square -> directions.

Counterpart of alvrl_tpu/core/warp.py (the two warps the VRL tracer
reads), as functions of uniforms in [0, 1)^2.
"""

from __future__ import annotations

import math

import torch

from alvrl_tpu_torch.core import math as m


def square_to_uniform_sphere(u):
    """u (..., 2) -> uniform direction on the sphere, pdf 1 / (4 pi)."""
    z = 1.0 - 2.0 * u[..., 0]
    r = m.safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_cosine_hemisphere(u):
    """u (..., 2) -> cosine-weighted direction about +z, pdf cos / pi
    (the polar mapping of the reference)."""
    cos_theta = m.safe_sqrt(1.0 - u[..., 0])
    sin_theta = m.safe_sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([sin_theta * torch.cos(phi),
                        sin_theta * torch.sin(phi), cos_theta], dim=-1)
