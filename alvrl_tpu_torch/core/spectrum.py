"""3-channel linear-RGB spectra as trailing-dim-3 tensors.

Counterpart of alvrl_tpu/core/spectrum.py.
"""

from __future__ import annotations

import torch

# ITU-R BT.709 luminance weights
LUM_WEIGHTS = (0.212671, 0.715160, 0.072169)


def luminance(s):
    w = torch.tensor(LUM_WEIGHTS, dtype=s.dtype, device=s.device)
    return (s * w).sum(dim=-1)


def is_zero(s):
    return (s == 0.0).all(dim=-1)
