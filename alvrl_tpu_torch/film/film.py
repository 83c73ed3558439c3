"""Film accumulation.

Counterpart of alvrl_tpu/film/film.py: a box filter as scatter-adds
into an (H, W, 3) image and an (H, W) weight.
"""

from __future__ import annotations

import torch


def splat_box(width, height, px, py, values):
    """Accumulate (N, 3) sample values, each of weight 1, at integer
    pixels (px, py).

    Returns (image (H, W, 3), weight (H, W)); develop with `develop`."""
    weights = torch.ones(px.shape, dtype=values.dtype, device=values.device)
    img = torch.zeros((height, width, 3), dtype=values.dtype,
                      device=values.device)
    wgt = torch.zeros((height, width), dtype=values.dtype,
                      device=values.device)
    img.index_put_((py, px), values * weights[..., None], accumulate=True)
    wgt.index_put_((py, px), weights, accumulate=True)
    return img, wgt


def develop(img, wgt):
    """Weight-normalise the accumulated film."""
    return img / torch.clamp(wgt[..., None], min=1e-20)
