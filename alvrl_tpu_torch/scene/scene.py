"""Scene, camera and material table as dataclasses of tensors.

Counterpart of alvrl_tpu/scene/scene.py, reduced to the columns the VRL
render, the tracer and the specular chains read. Materials are a struct-of-arrays table indexed by the
per-face material id; the BSDF kind selects the arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from alvrl_tpu_torch.emitters.emitters import Emitters
from alvrl_tpu_torch.media.heterogeneous import GridMedium
from alvrl_tpu_torch.media.homogeneous import HomogeneousMedium

# material kinds, numbered as in alvrl_tpu.scene.scene
DIFFUSE = 0     # smooth Lambertian
NULL = 1        # transparent boundary: does not block shadow rays
MIRROR = 2      # ideal specular conductor (delta), tinted by the albedo
DIELECTRIC = 3  # smooth dielectric (delta), relative IOR in Materials.eta

# sensor kinds, numbered as in alvrl_tpu.scene.scene
PERSPECTIVE = 0


@dataclass(frozen=True)
class Materials:
    kind: torch.Tensor    # (M,) int64
    albedo: torch.Tensor  # (M, 3) f32 diffuse reflectance / specular tint
    eta: torch.Tensor     # (M,) f32 relative IOR int/ext (1 but for
                          # dielectrics)


@dataclass(frozen=True)
class Camera:
    """to_world: (4, 4) camera-to-world, camera looking down +z with y
    up; fov_x_deg: horizontal field of view in degrees."""

    to_world: torch.Tensor
    fov_x_deg: torch.Tensor
    width: int = 128
    height: int = 128
    kind: int = PERSPECTIVE


@dataclass(frozen=True)
class Scene:
    vertices: torch.Tensor  # (V, 3) f32
    faces: torch.Tensor     # (T, 3) int64
    material: torch.Tensor  # (T,) int64 per-face material id
    materials: Materials
    emitters: Emitters
    medium: HomogeneousMedium | GridMedium  # global medium filling the scene
    camera: Camera

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    def opaque_faces(self):
        """(T,) bool: triangles that block shadow rays (non-null BSDF;
        mirrors and dielectrics block them too)."""
        return self.materials.kind[self.material] != NULL

    def aabb(self):
        """(lo, hi) corners of the geometry's bounding box."""
        return self.vertices.amin(dim=0), self.vertices.amax(dim=0)


def look_at(origin, target, up):
    """Camera-to-world 4x4 (+z forward, y up), as a float32 numpy array."""
    origin = np.asarray(origin, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    fwd = target - origin
    fwd /= np.linalg.norm(fwd)
    left = np.cross(up / np.linalg.norm(up), fwd)
    left /= np.linalg.norm(left)
    new_up = np.cross(fwd, left)
    mat = np.eye(4, dtype=np.float32)
    mat[:3, 0] = left
    mat[:3, 1] = new_up
    mat[:3, 2] = fwd
    mat[:3, 3] = origin
    return mat
