"""Benchmark scenes.

Counterpart of alvrl_tpu/scene/presets.py (cornell_smoke, BASELINE
config 1): a closed Cornell box filled with a homogeneous medium, a box
blocker, one point light, and the camera inside the medium.
"""

from __future__ import annotations

import numpy as np
import torch

from alvrl_tpu_torch.emitters.emitters import make_point_emitters
from alvrl_tpu_torch.geometry import shapes
from alvrl_tpu_torch.media.homogeneous import make_medium
from alvrl_tpu_torch.scene.scene import (
    DIFFUSE,
    Camera,
    Materials,
    Scene,
    look_at,
)

# material ids used by the cornell scene
M_WHITE, M_RED, M_GREEN, M_BOX = 0, 1, 2, 3


def cornell_smoke(
    width=128,
    height=128,
    sigma_s=(0.8, 0.8, 0.8),
    sigma_a=(0.05, 0.05, 0.05),
    g=0.0,
    intensity=(8.0, 8.0, 8.0),
    with_blocker=True,
    device="cuda",
):
    """Cornell box [-1,1]^3 filled with a homogeneous medium: white
    floor, ceiling, back and front walls, red left (-x) and green right
    (+x) walls, a box blocker, a point light near the ceiling, and the
    camera just inside the front wall looking down +z."""
    parts = []
    # floor y=-1 (normal +y) and ceiling y=+1 (normal -y)
    v, f = shapes.rectangle()
    v = v @ np.array([[1, 0, 0], [0, 0, 1], [0, 1, 0]], np.float32).T
    parts.append((v + np.array([0, -1, 0], np.float32), f, M_WHITE))
    parts.append((v + np.array([0, 1, 0], np.float32), f[:, ::-1].copy(),
                  M_WHITE))
    # back wall z=+1 (normal -z) and front wall z=-1 (normal +z)
    v, f = shapes.rectangle()
    parts.append((v + np.array([0, 0, 1], np.float32), f[:, ::-1].copy(),
                  M_WHITE))
    parts.append((v + np.array([0, 0, -1], np.float32), f.copy(), M_WHITE))
    # left wall x=-1 (normal +x) and right wall x=+1 (normal -x)
    v, f = shapes.rectangle()
    v = v @ np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0]], np.float32).T
    parts.append((v + np.array([-1, 0, 0], np.float32), f, M_RED))
    parts.append((v + np.array([1, 0, 0], np.float32), f[:, ::-1].copy(),
                  M_GREEN))
    if with_blocker:
        bv, bf = shapes.cube()
        bv = bv * np.array([0.25, 0.5, 0.25], np.float32) + np.array(
            [-0.35, -0.5, 0.3], np.float32)
        parts.append((bv, bf, M_BOX))
    verts, faces, mat = shapes.merge(parts)

    f32 = dict(dtype=torch.float32, device=device)
    materials = Materials(
        kind=torch.full((4,), DIFFUSE, dtype=torch.int64, device=device),
        albedo=torch.tensor([
            [0.725, 0.71, 0.68],   # white
            [0.63, 0.065, 0.05],   # red
            [0.14, 0.45, 0.091],   # green
            [0.725, 0.71, 0.68],   # blocker
        ], **f32),
    )
    emitters = make_point_emitters([[0.0, 0.75, 0.2]], [list(intensity)],
                                   device=device)
    camera = Camera(
        to_world=torch.as_tensor(
            look_at([0, 0, -0.99], [0, 0, 1], [0, 1, 0]), **f32),
        fov_x_deg=torch.tensor(90.0, **f32),
        width=width,
        height=height,
    )
    return Scene(
        vertices=torch.as_tensor(verts, **f32),
        faces=torch.as_tensor(faces, dtype=torch.int64, device=device),
        material=torch.as_tensor(mat, dtype=torch.int64, device=device),
        materials=materials,
        emitters=emitters,
        medium=make_medium(sigma_a, sigma_s, g=g, device=device),
        camera=camera,
    )
