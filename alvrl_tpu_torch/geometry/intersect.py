"""Ray-triangle and ray-scene intersection, brute force.

Counterpart of alvrl_tpu/geometry/intersect.py: every ray tests every
triangle (Moller-Trumbore) and a masked argmin picks the closest hit.
The render's scenes hold tens of triangles, where this is the path the
main render takes. All functions broadcast over leading batch dims.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from alvrl_tpu_torch.core import math as m

RAY_EPS = 1e-4  # minimum hit distance (mitsuba Epsilon)
SHADOW_EPS = 1e-3  # relative shrink of a shadow segment's ends


class Hit(NamedTuple):
    """Closest-hit record."""

    t: torch.Tensor      # hit distance, +inf if none
    prim: torch.Tensor   # triangle index, -1 if none
    valid: torch.Tensor  # bool
    p: torch.Tensor      # hit position (..., 3)
    ng: torch.Tensor     # geometric normal, oriented toward the ray origin
    ng_raw: torch.Tensor  # geometric normal as the winding defines it
    uv: torch.Tensor = None  # barycentric (u, v) (..., 2) on the triangle


def ray_triangle(o, d, p0, p1, p2):
    """Moller-Trumbore; returns (t, u, v, hit_mask). o, d: (..., 3);
    p0/p1/p2 broadcast against them."""
    return ray_triangle_edges(o, d, p0, p1 - p0, p2 - p0)


def ray_triangle_edges(o, d, p0, e1, e2):
    """ray_triangle on a triangle given as p0, e1 = p1 - p0, e2 = p2 -
    p0 (the BVH's leaf-ordered triangles)."""
    pvec = m.cross(d, e2)
    det = m.dot(e1, pvec)
    nonzero = det.abs() > 1e-12
    inv_det = torch.where(nonzero, 1.0 / det, torch.zeros_like(det))
    tvec = o - p0
    u = m.dot(tvec, pvec) * inv_det
    qvec = m.cross(tvec, e1)
    v = m.dot(d, qvec) * inv_det
    t = m.dot(e2, qvec) * inv_det
    hit = nonzero & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, hit


def _triangles(verts, faces):
    return verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]


def intersect_all(o, d, verts, faces, tmin=RAY_EPS, tmax=None):
    """Closest hit of rays (..., 3) against all triangles, at a distance
    in (tmin, tmax) (floats, or tensors (...) of one bound a ray)."""
    p0, p1, p2 = _triangles(verts, faces)
    t, u, v, hit = ray_triangle(o[..., None, :], d[..., None, :], p0, p1, p2)
    inf = torch.full_like(t, float("inf"))

    def col(x):
        return x[..., None] if isinstance(x, torch.Tensor) else x

    ok = hit & (t > col(tmin))
    if tmax is not None:
        ok = ok & (t < col(tmax))
    t = torch.where(ok, t, inf)
    prim = t.argmin(dim=-1)  # first of equal minima, as jnp.argmin
    t_best = t.gather(-1, prim[..., None])[..., 0]
    valid = torch.isfinite(t_best)
    uv = torch.stack([u.gather(-1, prim[..., None])[..., 0],
                      v.gather(-1, prim[..., None])[..., 0]], dim=-1)
    prim = torch.where(valid, prim, torch.full_like(prim, -1))
    return hit_record(o, d, t_best, prim, valid, verts, faces, uv)


def hit_record(o, d, t, prim, valid, verts, faces, uv=None):
    """The Hit of rays (o, d) at distance t on triangle prim (-1, and t
    inf, for a miss): the point, the face's winding normal, that normal
    oriented toward the incoming ray (two-sided shading), and the
    barycentric uv (the Moller-Trumbore u, v of the ray against face prim
    unless given). A miss carries face 0's normals, as the reference's."""
    f = faces[prim.clamp(min=0)]
    a, b, c = verts[f[..., 0]], verts[f[..., 1]], verts[f[..., 2]]
    ng_raw = m.normalize(m.cross(b - a, c - a))
    ng = torch.where(m.dot(ng_raw, d, keepdim=True) > 0, -ng_raw, ng_raw)
    if uv is None:
        _, u, v, _ = ray_triangle(o, d, a, b, c)
        uv = torch.stack([u, v], dim=-1)
    return Hit(t=t, prim=prim, valid=valid, p=o + t[..., None] * d, ng=ng,
               ng_raw=ng_raw, uv=uv)


def occluded(p_from, p_to, verts, faces):
    """Does any of the triangles block the open segment p_from -> p_to?
    The segment ends are shrunk by SHADOW_EPS * max(length, 1). Pass
    only the blocking faces (Scene.opaque_faces) to let shadow rays
    through null boundaries."""
    delta = p_to - p_from
    dist = m.length(delta)
    d = delta / torch.clamp(dist, min=1e-20)[..., None]
    p0, p1, p2 = _triangles(verts, faces)
    t, _, _, hit = ray_triangle(
        p_from[..., None, :], d[..., None, :], p0, p1, p2)
    lo = SHADOW_EPS * torch.clamp(dist, min=1.0)[..., None]
    hi = dist[..., None] - lo
    return (hit & (t > lo) & (t < hi)).any(dim=-1)
