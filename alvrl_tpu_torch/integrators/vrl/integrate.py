"""Sampling of the VRL x eye-ray double integral.

Counterpart of alvrl_tpu/integrators/vrl/integrate.py: the render
configuration, the two samplers of the estimator (Kulla-Fajardo
equi-angular sampling, and inverse-distance sampling of a point on the
VRL by the sinh/asinh warp), the eye hit's smooth BSDF factor
(bsdf_eval_smooth), the transmittance between two points
(eval_transmittance_between, which the volumetric path tracer's direct
sampling reads), and the grid-medium reads of
pair_contribution's table branch (integrate.py:248-335): the density at
a point and the optical depth of a U-V segment, from the kernels' grid
medium pack, and the eye and VRL cumulative-OD tables interpolated by
media.heterogeneous.interp_od. All branchless batched tensor code; the
plain versions of the kernels (ops.vrl_sum, ops.vrl_r,
ops.vrl_sum_clustered) are built from them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from alvrl_tpu_torch.core import math as m

_H_EPS = 1e-6


@dataclass(frozen=True)
class VRLConfig:
    vol_vol_samples: int = 2   # (U on the eye ray, V on the VRL) pairs
    vol_surf_samples: int = 2  # V on the VRL against the eye ray's hit
    short_vrls: bool = True    # divide by the VRL segment's pdfFailure
    uv_tau_steps: int = 4      # grid media: midpoint steps of the U-V
                               # segment's optical depth


def closest_points_segments(a0, a1, b0, b1):
    """Closest points between segments [a0, a1] and [b0, b1] (the
    clamped segment-segment algorithm). Returns (pa, pb, dist)."""
    u = a1 - a0
    v = b1 - b0
    w = a0 - b0
    a = m.dot(u, u)
    b = m.dot(u, v)
    c = m.dot(v, v)
    d = m.dot(u, w)
    e = m.dot(v, w)
    denom = a * c - b * b
    zero = torch.zeros_like(a)
    one = torch.ones_like(a)

    parallel = denom < 1e-9 * a * c + 1e-30
    s_n = torch.where(parallel, zero, b * e - c * d)
    s_d = torch.where(parallel, one, denom)
    t_n = torch.where(parallel, e, a * e - b * d)
    t_d = torch.where(parallel, c, denom)

    # clamp s to [0, 1]
    below = s_n < 0.0
    above = s_n > s_d
    t_n = torch.where(below, e, torch.where(above, e + b, t_n))
    t_d = torch.where(below | above, c, t_d)
    s_n = torch.where(below, zero, torch.where(above, s_d, s_n))

    # clamp t to [0, 1] and recompute s on the clamped edge
    t_below = t_n < 0.0
    t_above = t_n > t_d
    s_edge_lo = torch.minimum(torch.clamp(-d, min=0.0), a)
    s_edge_hi = torch.minimum(torch.clamp(-d + b, min=0.0), a)
    s_n = torch.where(t_below, s_edge_lo, torch.where(t_above, s_edge_hi, s_n))
    s_d = torch.where(t_below | t_above, torch.clamp(a, min=1e-30), s_d)
    t_n = torch.where(t_below, zero, torch.where(t_above, t_d, t_n))

    sc = s_n / torch.clamp(s_d, min=1e-30)
    tc = t_n / torch.clamp(t_d, min=1e-30)
    pa = a0 + sc[..., None] * (a1 - a0)
    pb = b0 + tc[..., None] * (b1 - b0)
    return pa, pb, m.distance(pa, pb)


def kulla_sampling(a, b, d_pt, u):
    """Equi-angular sampling of a point on segment [a, b] with respect
    to point d_pt (Kulla & Fajardo 2012). Returns (point, pdf), the pdf
    per unit length on [a, b]."""
    dirn = m.normalize(b - a)
    dot_pr = m.dot(dirn, d_pt - a)
    i_pt = a + dot_pr[..., None] * dirn
    dis = torch.clamp(m.distance(d_pt, i_pt), min=_H_EPS)
    dist_ai = m.distance(a, i_pt)
    dist_ib = m.distance(i_pt, b)
    angle_a = torch.atan(dist_ai / dis)
    angle_b = torch.atan(dist_ib / dis)
    pos = dot_pr > 0
    angle_a = torch.where(pos, -angle_a, angle_a)
    past_b = pos & (dist_ai > m.distance(a, b))
    angle_b = torch.where(past_b, -angle_b, angle_b)
    t = dis * torch.tan((1.0 - u) * angle_a + u * angle_b)
    span = angle_b - angle_a
    pdf = m.safe_divide(dis, span * (dis * dis + t * t))
    point = i_pt + t[..., None] * dirn
    return point, pdf


def sample_v_to_distance(eye_o, eye_d, eye_hit, vrl_s, vrl_e, u):
    """Sample V on the VRL proportionally to the inverse distance from
    the eye segment (sinh/asinh inversion); uniform along the VRL when
    the two are nearly parallel. Returns (V, pdf per unit length)."""
    vrl_len = torch.clamp(m.distance(vrl_s, vrl_e), min=1e-30)
    vrl_dir = (vrl_e - vrl_s) / vrl_len[..., None]
    cos_theta = m.dot(m.normalize(eye_d), vrl_dir)
    sin_theta = m.safe_sqrt(1.0 - cos_theta * cos_theta)
    near_parallel = sin_theta < 1e-4

    _, vh, h = closest_points_segments(eye_o, eye_hit, vrl_s, vrl_e)
    h = torch.clamp(h, min=_H_EPS)
    sin_safe = torch.clamp(sin_theta, min=1e-4)

    v0c = -m.distance(vh, vrl_s)
    v1c = m.distance(vh, vrl_e)
    a0 = torch.asinh(v0c / h * sin_safe)
    a1 = torch.asinh(v1c / h * sin_safe)
    new_v = h * torch.sinh(a0 + u * (a1 - a0)) / sin_safe
    inv_dist = 1.0 / torch.sqrt(h * h + new_v * new_v * sin_safe * sin_safe)
    denom = torch.clamp((a1 - a0) / sin_safe, min=1e-30)
    arc = new_v + m.distance(vh, vrl_s)
    v_kulla = vrl_s + arc[..., None] * vrl_dir
    pdf_kulla = inv_dist / denom

    v_uni = vrl_s + u[..., None] * (vrl_e - vrl_s)
    pdf_uni = 1.0 / vrl_len
    v = torch.where(near_parallel[..., None], v_uni, v_kulla)
    pdf = torch.where(near_parallel, pdf_uni, pdf_kulla)
    return v, pdf


def bsdf_eval_smooth(materials, mat_id, ng, wi_world, wo_world, kinds=None,
                     shade=None):
    """BSDF eval times cos(theta_o) of the smooth (ESmooth) components of
    the material table `materials`: the vol-surf factor at the eye hit
    (bsdf->eval(bRec), vrlIntegrator.cpp:758-761), wi_world pointing from
    the surface to the eye, wo_world toward V; the delta kinds evaluate
    to 0. Delegates to bsdf.api.eval_smooth, as the reference's
    integrate.py does; the material kernels' plain version
    (ops.vrl_sum._pair_terms) reads it. `shade`, the eye hit's
    bsdf.api.Shading at its point and UV (the textured forms' rows): the
    JAX package's pair_contribution evaluates at the point without the
    UV (ROADMAP C23), the port at both, as the reference's
    BSDFSamplingRecord(its, ...) does."""
    from alvrl_tpu_torch.bsdf import api as bsdf_api

    return bsdf_api.eval_smooth(materials, mat_id, ng, wi_world, wo_world,
                                kinds, shade)


def eval_transmittance_between(scene, p0, p1, density_ss=None,
                               blockers=None):
    """(..., 3) transmittance of the scene's global medium between p0 and
    p1, 0 where an opaque face blocks the open segment (null faces do
    not): Scene::evalTransmittance with one medium. A grid medium reads
    the supersampled density_ss; `blockers`, the opaque faces
    (scene.faces[scene.opaque_faces()]), may be passed in once per call
    to save the masking."""
    from alvrl_tpu_torch.geometry import intersect
    from alvrl_tpu_torch.media import api as mapi

    if blockers is None:
        blockers = scene.faces[scene.opaque_faces()]
    blocked = intersect.occluded(p0, p1, scene.vertices, blockers)
    tau = mapi.transmittance(scene.medium, p0, p1, density_ss)
    return torch.where(blocked[..., None], 0.0, tau)


# grid medium pack rows (ops.pack.GRID_MED_LEN)
_BOX0, _INV_EXTENT, _INDEX_SCALE, _SCALE = slice(8, 11), slice(11, 14), \
    slice(14, 17), 17


def grid_density(medium, density_ss, p):
    """Density at the points p (..., 3) of the grid medium packed in
    `medium` (ops.pack.pack_medium_hetero), times the density scale; 0
    outside the box; p must be finite. A (GRID_MED_LEN,) pack reads the
    nearest entry of the supersampled grid density_ss (2Z - 1, 2Y - 1,
    2X - 1), indices rounded half to even (as jnp.round in
    lookup_density_nn); the trilinear pack (ops.pack.is_trilinear,
    fast_tau False) reads density_ss = the density (Z, Y, X)
    trilinearly, as media.heterogeneous.lookup_density."""
    from alvrl_tpu_torch.ops import pack as pk

    q = (p - medium[_BOX0]) * medium[_INV_EXTENT]
    inside = ((q >= 0.0) & (q <= 1.0)).all(dim=-1)
    scales = medium[_INDEX_SCALE]
    if pk.is_trilinear(medium):
        return torch.where(inside, _trilinear(density_ss, q * scales, scales)
                           * medium[_SCALE], 0.0)
    idx = torch.minimum(torch.clamp(torch.round(q * scales), min=0.0),
                        scales).to(torch.int64)
    _, ny, nx = density_ss.shape
    flat = (idx[..., 2] * ny + idx[..., 1]) * nx + idx[..., 0]
    d = density_ss.reshape(-1)[flat]
    return torch.where(inside, d * medium[_SCALE], 0.0)


def _trilinear(density, g, scales):
    """density (Z, Y, X) at the grid coordinates g (..., 3) (x, y, z; each
    in [0, n - 1] inside the box), the lerps in x, then y, then z."""
    c0 = torch.minimum(torch.clamp(torch.floor(g), min=0.0), scales - 1.0)
    f = torch.clamp(g - c0, 0.0, 1.0)
    x0, y0, z0 = c0.to(torch.int64).unbind(-1)
    fx, fy, fz = f.unbind(-1)
    _, ny, nx = density.shape
    flat = density.reshape(-1)

    def lerp_x(z, y):
        row = (z * ny + y) * nx + x0
        return flat[row] * (1 - fx) + flat[row + 1] * fx

    c0 = lerp_x(z0, y0) * (1 - fy) + lerp_x(z0, y0 + 1) * fy
    c1 = lerp_x(z0 + 1, y0) * (1 - fy) + lerp_x(z0 + 1, y0 + 1) * fy
    return c0 * (1 - fz) + c1 * fz


def grid_segment_od(medium, density_ss, p0, p1, dist, n_steps):
    """Midpoint-rule optical depth of the segment p0 -> p1 of length
    dist: the densities at (i + 0.5) / n_steps of the way, summed in
    step order, times dist / n_steps (the per-sample U-V quadrature)."""
    delta = p1 - p0
    total = torch.zeros_like(dist)
    for i in range(n_steps):
        t = (i + 0.5) / n_steps
        total = total + grid_density(medium, density_ss, p0 + t * delta)
    return total * dist / n_steps
