"""Procedural triangle-mesh shapes (host-side numpy).

Counterpart of alvrl_tpu/geometry/shapes.py (rectangle, cube, sphere,
disk, cylinder, apply_transform, auto_uvs, merge), with the outward
winding of every cube face and sphere triangle. Shapes are triangulated up front,
so the intersector sees one triangle soup. Not ported: heightfield,
hair, instance (ROADMAP A11).
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


def cube(flip_normals=False):
    """[-1,1]^3 cube with outward normals on all six faces (inward with
    flip_normals)."""
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
    f = np.concatenate(faces, axis=0)
    if flip_normals:
        f = f[:, ::-1]
    return np.concatenate(verts, axis=0), f.copy()


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


def disk(center=(0, 0, 0), radius=1.0, n_phi=48, to_world=None):
    """Unit disk at z=0, normal +z, as a fan of n_phi triangles."""
    center = np.asarray(center, np.float32)
    phis = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    rim = np.stack(
        [np.cos(phis), np.sin(phis), np.zeros_like(phis)], axis=-1
    ).astype(np.float32)
    v = np.concatenate([np.zeros((1, 3), np.float32), rim], axis=0)
    f = np.asarray(
        [[0, 1 + j, 1 + (j + 1) % n_phi] for j in range(n_phi)], np.int32
    )
    v = v * np.float32(radius) + center
    if to_world is not None:
        v = apply_transform(to_world, v)
    return v, f


def cylinder(p0=(0, 0, 0), p1=(0, 0, 1), radius=1.0, n_phi=32):
    """Open cylinder (no caps, as the reference's) from p0 to p1, n_phi
    quads of two triangles."""
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    axis = p1 - p0
    length = np.linalg.norm(axis)
    w = axis / max(length, 1e-12)
    # an orthonormal frame around w
    a = np.array([1.0, 0, 0], np.float32)
    if abs(w[0]) > 0.9:
        a = np.array([0, 1.0, 0], np.float32)
    u = np.cross(a, w)
    u /= np.linalg.norm(u)
    vv = np.cross(w, u)
    phis = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    rim = (np.outer(np.cos(phis), u) + np.outer(np.sin(phis), vv)) * radius
    bottom = (p0 + rim).astype(np.float32)
    top = (p1 + rim).astype(np.float32)
    v = np.concatenate([bottom, top], axis=0)
    faces = []
    for j in range(n_phi):
        jn = (j + 1) % n_phi
        faces.append([j, jn, n_phi + jn])
        faces.append([j, n_phi + jn, n_phi + j])
    return v.astype(np.float32), np.asarray(faces, np.int32)


def apply_transform(mat4, verts):
    """Apply a 4x4 homogeneous transform to (N, 3) vertices."""
    mat4 = np.asarray(mat4, dtype=np.float32)
    vh = np.concatenate([verts, np.ones((len(verts), 1), np.float32)], axis=1)
    out = vh @ mat4.T
    return (out[:, :3] / out[:, 3:4]).astype(np.float32)


def auto_uvs(kind: str, v, f, center=None):
    """Each face corner's texture coordinates (F, 3, 2) for an analytic
    shape, from its canonical (before to_world) vertices, as
    src/shapes/{rectangle,cube,sphere}.cpp parameterise them: the
    rectangle's (x, y) in [-1, 1]^2 onto [0, 1]^2, the cube's projection
    along each face's dominant axis, the sphere's (phi / 2 pi, theta / pi)
    about `center` (each triangle's u rebased to its corner 0's, so that
    none spans the seam). Other kinds get zeros."""
    v = np.asarray(v, np.float32)
    f = np.asarray(f, np.int32)
    corners = v[f]  # (F, 3, 3)
    if kind == "rectangle":
        return ((corners[..., :2] + 1.0) * 0.5).astype(np.float32)
    if kind == "cube":
        n = np.cross(corners[:, 1] - corners[:, 0],
                     corners[:, 2] - corners[:, 0])
        axis = np.argmax(np.abs(n), axis=-1)
        uv = np.zeros((len(f), 3, 2), np.float32)
        for a, (i0, i1) in enumerate([(1, 2), (0, 2), (0, 1)]):
            sel = axis == a
            uv[sel] = (corners[sel][..., [i0, i1]] + 1.0) * 0.5
        return uv
    if kind == "sphere":
        c = np.zeros(3, np.float32) if center is None else np.asarray(
            center, np.float32)
        d = corners - c
        d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
        theta = np.arccos(np.clip(d[..., 2], -1, 1))
        phi = np.arctan2(d[..., 1], d[..., 0])
        u = phi / (2 * np.pi) + 0.5
        u = u - np.round(u - u[:, :1])
        return np.stack([u, theta / np.pi], axis=-1).astype(np.float32)
    return np.zeros((len(f), 3, 2), np.float32)


def merge(parts):
    """Merge [(verts, faces, material_id[, face_uv]), ...] into one soup.

    Returns (verts (V, 3) f32, faces (T, 3) i32, material ids (T,) i32,
    face_uvs (T, 3, 2) f32: each part's, zeros where a part has none).
    """
    all_v, all_f, all_m, all_uv = [], [], [], []
    off = 0
    for part in parts:
        v, f, mat = part[:3]
        uv = part[3] if len(part) > 3 and part[3] is not None else \
            np.zeros((len(f), 3, 2), np.float32)
        all_v.append(v)
        all_f.append(f + off)
        all_m.append(np.full((len(f),), mat, dtype=np.int32))
        all_uv.append(np.asarray(uv, np.float32))
        off += len(v)
    return (
        np.concatenate(all_v, axis=0),
        np.concatenate(all_f, axis=0),
        np.concatenate(all_m, axis=0),
        np.concatenate(all_uv, axis=0),
    )
