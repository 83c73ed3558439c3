"""Sensors: ray generation.

Counterpart of alvrl_tpu/sensors/perspective.py for the pinhole
(PERSPECTIVE) camera; the other sensor kinds are not ported yet.
"""

from __future__ import annotations

import math

import torch

from alvrl_tpu_torch.core import math as m
from alvrl_tpu_torch.scene.scene import PERSPECTIVE, Camera


def sample_ray(cam: Camera, px, py, jitter=None):
    """Pixel coords (N,) -> world rays (origin (N, 3), direction (N, 3))
    through the film positions (px, py) + jitter, jitter (N, 2) in
    [0, 1)^2, or through the pixel centres without it. Film y grows
    downward; camera space looks down +z with y up."""
    if cam.kind != PERSPECTIVE:
        raise ValueError(f"sensor kind {cam.kind} is not ported "
                         "(only PERSPECTIVE)")
    if jitter is None:
        jx = jy = 0.5
    else:
        jx, jy = jitter[..., 0], jitter[..., 1]
    ndc_x = (px + jx) / cam.width * 2.0 - 1.0
    ndc_y = 1.0 - (py + jy) / cam.height * 2.0
    aspect = cam.height / cam.width
    rot = cam.to_world[:3, :3]
    cam_o = cam.to_world[:3, 3]
    th = torch.tan(cam.fov_x_deg * (math.pi / 180.0) * 0.5)
    d_cam = torch.stack(
        [ndc_x * th, ndc_y * th * aspect, torch.ones_like(ndc_x)], dim=-1)
    d = m.normalize(d_cam @ rot.T)
    o = cam_o.expand_as(d)
    return o, d
