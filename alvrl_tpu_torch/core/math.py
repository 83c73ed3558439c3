"""Vector math on trailing-dim-3 float tensors.

Counterpart of alvrl_tpu/core/math.py: every function broadcasts over
leading batch dimensions.
"""

from __future__ import annotations

import math

import torch

INV_FOURPI = 1.0 / (4.0 * math.pi)


def dot(a, b, keepdim=False):
    return (a * b).sum(dim=-1, keepdim=keepdim)


def length(v, keepdim=False):
    return torch.sqrt(torch.clamp(dot(v, v, keepdim=keepdim), min=0.0))


def normalize(v):
    return v / torch.clamp(length(v, keepdim=True), min=1e-20)


def cross(a, b):
    """a x b, broadcasting over leading dims of any rank."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def distance(a, b):
    return length(b - a)


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def safe_divide(num, den):
    """num / den, and 0 where den == 0."""
    den_ok = den != 0.0
    den_safe = torch.where(den_ok, den, torch.ones_like(den))
    return torch.where(den_ok, num / den_safe, torch.zeros_like(den))


def build_frame(n):
    """Orthonormal (s, t) around the unit normal n, with s x t = n:
    the branchless construction of Duff et al. 2017."""
    nx, ny, nz = n.unbind(-1)
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    t = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return s, t


def frame_to_world(s, t, n, v_local):
    """Local (x, y, z) in the frame (s, t, n) -> world."""
    return v_local[..., 0:1] * s + v_local[..., 1:2] * t \
        + v_local[..., 2:3] * n


def frame_to_local(s, t, n, v_world):
    return torch.stack([dot(v_world, s), dot(v_world, t), dot(v_world, n)],
                       dim=-1)


def spherical_direction(cos_theta, phi):
    """(cos_theta, phi) -> unit vector in the local frame (z the pole)."""
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    return torch.stack([sin_theta * torch.cos(phi),
                        sin_theta * torch.sin(phi), cos_theta], dim=-1)
