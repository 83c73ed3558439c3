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
