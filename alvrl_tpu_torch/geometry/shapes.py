"""Procedural triangle-mesh shapes (host-side numpy).

Counterpart of alvrl_tpu/geometry/shapes.py (rectangle, cube, sphere,
merge), with the outward winding of every cube face and sphere
triangle. Shapes are triangulated up front, so the intersector sees one
triangle soup.
"""

from __future__ import annotations

import numpy as np


def rectangle():
    """Unit xy rectangle [-1,1]^2 at z=0, normal +z."""
    v = np.array(
        [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], dtype=np.float32
    )
    f = np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int32)
    return v, f


# (placement of the rectangle, offset along the face normal) per cube face
_CUBE_FACES = [
    (np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]]), np.array([0, 0, 1.0])),
    (np.array([[-1, 0, 0], [0, 1, 0], [0, 0, -1]]), np.array([0, 0, -1.0])),
    (np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0]]), np.array([1.0, 0, 0])),
    (np.array([[0, 0, -1], [0, 1, 0], [-1, 0, 0]]), np.array([-1.0, 0, 0])),
    (np.array([[1, 0, 0], [0, 0, 1], [0, 1, 0]]), np.array([0, 1.0, 0])),
    (np.array([[1, 0, 0], [0, 0, -1], [0, -1, 0]]), np.array([0, -1.0, 0])),
]


def cube():
    """[-1,1]^3 cube with outward normals on all six faces."""
    verts, faces = [], []
    for rot, off in _CUBE_FACES:
        v, f = rectangle()
        rot = rot.astype(np.float32)
        v = v @ rot.T + off.astype(np.float32)
        # a reflection (det < 0) reverses the winding: flip it back so
        # every face winds outward
        if np.linalg.det(rot) < 0:
            f = f[:, ::-1]
        faces.append(f + sum(len(x) for x in verts))
        verts.append(v)
    return np.concatenate(verts, axis=0), np.concatenate(faces, axis=0).copy()


def sphere(center=(0, 0, 0), radius=1.0, n_theta=16, n_phi=32):
    """UV-sphere of n_theta rings of n_phi quads, each two triangles
    wound outward. The rings at the poles collapse to a point, so one
    triangle of each of their quads is degenerate (zero area): the Wald
    and Moller-Trumbore tests never hit it."""
    center = np.asarray(center, dtype=np.float32)
    thetas = np.linspace(0, np.pi, n_theta + 1)
    phis = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    rings = [np.stack([np.sin(th) * np.cos(phis), np.sin(th) * np.sin(phis),
                       np.full_like(phis, np.cos(th))], axis=-1)
             for th in thetas]
    v = np.concatenate(rings, axis=0).astype(np.float32)
    i, j = np.meshgrid(np.arange(n_theta), np.arange(n_phi), indexing="ij")
    a = i * n_phi + j
    b = i * n_phi + (j + 1) % n_phi
    c = (i + 1) * n_phi + j
    d = (i + 1) * n_phi + (j + 1) % n_phi
    f = np.stack([np.stack([a, d, b], -1), np.stack([a, c, d], -1)],
                 axis=2).reshape(-1, 3).astype(np.int32)
    return v * np.float32(radius) + center, f


def merge(parts):
    """Merge [(verts, faces, material_id), ...] into one soup.

    Returns (verts (V, 3) f32, faces (T, 3) i32, material ids (T,) i32).
    """
    all_v, all_f, all_m = [], [], []
    off = 0
    for v, f, mat in parts:
        all_v.append(v)
        all_f.append(f + off)
        all_m.append(np.full((len(f),), mat, dtype=np.int32))
        off += len(v)
    return (
        np.concatenate(all_v, axis=0),
        np.concatenate(all_f, axis=0),
        np.concatenate(all_m, axis=0),
    )
