"""Phase functions: Henyey-Greenstein (isotropic at g=0) and Rayleigh.

Counterpart of the evaluation half of alvrl_tpu/media/phase.py. The
convention is the reference's: eval(g, wi, wo) with the lobe written in
dot(wi, wo), wi pointing away from the propagation direction.
"""

from __future__ import annotations

import math

import torch

from alvrl_tpu_torch.core import math as m

# phase kinds, numbered as in alvrl_tpu.media.phase
HG = 0
RAYLEIGH = 1


def eval_hg(g, wi, wo):
    """INV_FOURPI * (1 - g^2) / (1 + g^2 + 2 g cos)^(3/2)."""
    temp = torch.clamp(1.0 + g * g + 2.0 * g * m.dot(wi, wo), min=1e-12)
    return m.INV_FOURPI * (1.0 - g * g) / (temp * torch.sqrt(temp))


def eval_rayleigh(wi, wo):
    """3 / (16 pi) * (1 + cos^2), cos = dot(wi, wo)."""
    c = m.dot(wi, wo)
    return (3.0 / (16.0 * math.pi)) * (1.0 + c * c)


def eval_phase(kind: int, g, wi, wo):
    if kind == HG:
        return eval_hg(g, wi, wo)
    if kind == RAYLEIGH:
        return eval_rayleigh(wi, wo)
    raise ValueError(f"phase kind {kind} is not ported (HG=0, RAYLEIGH=1)")
