"""Emitter table and emission sampling.

Counterpart of alvrl_tpu/emitters/emitters.py (make_emitters,
sample_emission, and the direct sampling nee_u, nee_u_pdf,
hit_emitter_nee_pdf, env_nee_pdf and env_radiance) for every kind: a
struct-of-arrays table with a kind column, a stored selection pmf,
power-weighted as the reference's (an area entry weighs by L pi A, an
environment map by its mean luminance), and the environment map
(emitters.envmap) that the ENVMAP entries share. A light path starts,
per kind:
  * point: at the light, uniform on the sphere, weight I 4 pi
    (point.cpp:82-89);
  * spot: uniform in the cone of cutoffAngle, weight I 2 pi (1 - cos
    cutoff) times the linear falloff between beamWidth and cutoffAngle
    (spot.cpp);
  * directional: along its direction from a disk of the scene's radius
    behind the scene, weight E pi R^2;
  * area (one triangle an entry): uniform on the triangle, cosine about
    its face normal, weight L pi A (area.cpp);
  * constant: from the bounding sphere (radius 1.05 R) inward, cosine
    about the inward normal, weight L pi 4 pi (1.05 R)^2 (constant.cpp);
  * collimated: at its position along its direction, weight its power
    (collimated.cpp:117-126);
  * environment map: its direction d sampled from the map, from a disk
    of the scene's radius R at 1.5 R along d, travelling along -d,
    weight L(d) / pdf(d) pi R^2 / pmf (envmap.cpp).

The uniforms of one emission, (..., N_EMIT_DIMS): U_SELECT picks the
emitter by inverting the CDF of the pmf, U_DIR the 2D direction sample
(the reference's k_dir draws), U_POS the 2D position sample (its k_pos
draws) and U_AREA_B1 the area light's second barycentric uniform. The
reference draws that one from the direction's key (emitters.py:154,
the same number as the direction's first uniform, so a diffuse area
light's emission point and angle are correlated: ROADMAP C14); here it
is a column of its own.

The kinds are checked when the table is built, from the host list they
are built from (`host_kinds`), so that sampling reads nothing back from
the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from alvrl_tpu_torch.core import math as m
from alvrl_tpu_torch.core import spectrum, warp
from alvrl_tpu_torch.emitters.envmap import (
    EnvMap,
    default_envmap,
    eval_env,
    pdf_env,
    sample_env,
)

# emitter kinds, numbered as in alvrl_tpu.emitters.emitters
POINT = 0
SPOT = 1
DIRECTIONAL = 2
AREA = 3
CONSTANT = 4
ENVMAP = 5
COLLIMATED = 6
PORTED_KINDS = frozenset((POINT, SPOT, DIRECTIONAL, AREA, CONSTANT, ENVMAP,
                          COLLIMATED))

U_SELECT, U_DIR, U_POS, U_AREA_B1 = 0, slice(1, 3), slice(3, 5), 5
N_EMIT_DIMS = 6
# the kinds that read U_POS or U_AREA_B1
POSITION_KINDS = frozenset((DIRECTIONAL, AREA, CONSTANT, ENVMAP))
# uniforms of one direct (NEE) sample, in the reference's order: the
# emitter choice, then the 2D sample
N_NEE_DIMS = 3


@dataclass(frozen=True)
class Emitters:
    kind: torch.Tensor        # (E,) int64
    position: torch.Tensor    # (E, 3) f32; AREA: the triangle's p0
    direction: torch.Tensor   # (E, 3) f32 unit (spot, directional,
                              # collimated)
    intensity: torch.Tensor   # (E, 3) f32 radiant intensity, irradiance,
                              # power, or AREA / CONSTANT radiance
    cos_cutoff: torch.Tensor  # (E,) f32 spot cutoff cosine
    cos_beam: torch.Tensor    # (E,) f32 spot full-strength beam cosine
    tri_e1: torch.Tensor      # (E, 3) f32 AREA: edge p1 - p0
    tri_e2: torch.Tensor      # (E, 3) f32 AREA: edge p2 - p0
    pmf: torch.Tensor         # (E,) f32 selection pmf, a stored constant
    host_kinds: tuple         # the kind column as host ints
    env: EnvMap = None        # the map of the ENVMAP entries (None: none)

    def __post_init__(self):
        if len(self.host_kinds) != self.kind.shape[0]:
            raise ValueError(f"{len(self.host_kinds)} host kinds for "
                             f"{self.kind.shape[0]} emitters")
        other = sorted(set(self.host_kinds) - PORTED_KINDS)
        if other:
            raise ValueError(f"emitter kinds {other} are not ported")
        if ENVMAP in self.host_kinds and self.env is None:
            raise ValueError("an ENVMAP entry needs the table's env map")


def make_emitters(kinds, positions, intensities, directions=None,
                  cutoff_deg=None, beam_deg=None, tri_e1=None, tri_e2=None,
                  env: EnvMap = None, device="cuda") -> Emitters:
    """The table of host lists (or arrays) as the reference's
    make_emitters builds it: directions normalised, the spot angles
    (degrees; defaults 20 and 15) as cosines, the AREA edges (zeros
    otherwise), the environment map `env` (the 1x1 zero map by default)
    and the power-weighted pmf. The columns are computed on the CPU,
    then moved to `device`, so that every device holds the same bits."""
    host_kinds = tuple(int(k) for k in np.asarray(kinds).reshape(-1))
    e = len(host_kinds)
    f32 = dict(dtype=torch.float32)

    def col(a, default):
        a = default if a is None else a
        return torch.as_tensor(np.asarray(a, np.float32), **f32).reshape(
            (e, 3) if np.ndim(default) == 2 else (e,))

    kind = torch.tensor(host_kinds, dtype=torch.int64)
    positions = col(positions, np.zeros((e, 3)))
    intensities = col(intensities, np.zeros((e, 3)))
    directions = (torch.tensor([[0.0, 0.0, 1.0]]).repeat(e, 1)
                  if directions is None
                  else m.normalize(col(directions, np.zeros((e, 3)))))
    cutoff = torch.cos(torch.deg2rad(col(cutoff_deg, [20.0] * e)))
    beam = torch.cos(torch.deg2rad(col(beam_deg, [15.0] * e)))
    e1 = col(tri_e1, np.zeros((e, 3)))
    e2 = col(tri_e2, np.zeros((e, 3)))
    area = 0.5 * m.length(m.cross(e1, e2))
    lum = spectrum.luminance(intensities)
    lum = torch.where(kind == AREA,
                      lum * math.pi * torch.clamp(area, min=1e-12), lum)
    if env is None:
        env = default_envmap(device)
    lum = torch.where(kind == ENVMAP, spectrum.luminance(
        torch.tensor(env.host_mean, **f32)), lum)
    # the total summed in order in float32, as the reference's XLA
    # reduction sums it (torch's CPU sum and cumsum round otherwise)
    total = torch.zeros((), **f32)
    for x in lum:
        total = total + x
    pmf = lum / torch.clamp(total, min=1e-30)
    cols = dict(kind=kind, position=positions, direction=directions,
                intensity=intensities, cos_cutoff=cutoff, cos_beam=beam,
                tri_e1=e1, tri_e2=e2, pmf=pmf)
    return Emitters(**{k: v.to(device) for k, v in cols.items()},
                    host_kinds=host_kinds, env=env)


def make_point_emitters(position, intensity, device="cuda") -> Emitters:
    """Point lights (make_emitters with every kind POINT)."""
    position = np.asarray(position, np.float32).reshape(-1, 3)
    return make_emitters([POINT] * len(position), position,
                         np.asarray(intensity, np.float32).reshape(-1, 3),
                         device=device)


def _spot_falloff(em: Emitters, idx, d):
    """Linear falloff between beamWidth and cutoffAngle (spot.cpp)."""
    cos_d = m.dot(d, em.direction[idx])
    cc, cb = em.cos_cutoff[idx], em.cos_beam[idx]
    t = torch.clamp((cos_d - cc) / torch.clamp(cb - cc, min=1e-6), 0.0, 1.0)
    return torch.where(cos_d < cc, 0.0, t)


def choose(em: Emitters, u):
    """The emitter indices that the uniforms u pick: the CDF of the pmf
    inverted at u."""
    cdf = torch.cumsum(em.pmf, dim=0)
    idx = torch.searchsorted(cdf, (u * cdf[-1]).contiguous())
    return torch.clamp(idx, max=len(cdf) - 1)


def sample_emission(em: Emitters, generator, n: int, center, radius):
    """n light-path starts with uniforms drawn from `generator` (a
    torch.Generator), (n, N_EMIT_DIMS) in one draw; see sample_emission_u."""
    u = torch.rand((n, N_EMIT_DIMS), generator=generator,
                   device=generator.device)
    return sample_emission_u(em, u.to(em.pmf.device), center, radius)


def sample_emission_u(em: Emitters, u, center, radius):
    """Start of a light path from the uniforms u (..., N_EMIT_DIMS) (see
    the module), in a scene of bounding-sphere centre `center` (3,) and
    radius `radius` (the reference's scene.aabb() midpoint and half
    diagonal): (position, direction, weight (..., 3)). Only the kinds in
    the table are evaluated."""
    idx = choose(em, u[..., U_SELECT])
    kind = em.kind[idx]
    inten = em.intensity[idx] / em.pmf[idx][..., None]
    u_dir, u_pos = u[..., U_DIR], u[..., U_POS]
    present = set(em.host_kinds)
    # per kind present: (position, direction, weight)
    starts = {}
    if POINT in present:
        starts[POINT] = (em.position[idx],
                         warp.square_to_uniform_sphere(u_dir),
                         inten * (4.0 * math.pi))
    if SPOT in present:
        cc = em.cos_cutoff[idx]
        local = m.spherical_direction(1.0 - u_dir[..., 0] * (1.0 - cc),
                                      2.0 * math.pi * u_dir[..., 1])
        axis = em.direction[idx]
        s, t = m.build_frame(axis)
        d = m.frame_to_world(s, t, axis, local)
        solid_angle = 2.0 * math.pi * (1.0 - cc)
        starts[SPOT] = (em.position[idx], d, inten * solid_angle[..., None]
                        * _spot_falloff(em, idx, d)[..., None])
    if DIRECTIONAL in present:
        r = radius * torch.sqrt(u_pos[..., 0])
        phi = 2.0 * math.pi * u_pos[..., 1]
        axis = em.direction[idx]
        s, t = m.build_frame(axis)
        disk = (center - axis * radius * 1.5
                + s * (r * torch.cos(phi))[..., None]
                + t * (r * torch.sin(phi))[..., None])
        starts[DIRECTIONAL] = (disk, axis, inten * (math.pi * radius * radius))
    if AREA in present:
        e1, e2 = em.tri_e1[idx], em.tri_e2[idx]
        su = torch.sqrt(torch.clamp(u_pos[..., 0], 1e-9, 1.0))
        b0 = 1.0 - su
        b1 = u[..., U_AREA_B1] * su
        p = em.position[idx] + b0[..., None] * e1 + b1[..., None] * e2
        normal = m.cross(e1, e2)
        n_face = m.normalize(normal)
        s, t = m.build_frame(n_face)
        d = m.frame_to_world(s, t, n_face,
                             warp.square_to_cosine_hemisphere(u_dir))
        area = 0.5 * m.length(normal)
        starts[AREA] = (p, d, inten * (math.pi * area)[..., None])
    if CONSTANT in present:
        n_out = warp.square_to_uniform_sphere(u_pos)
        p = center + radius * 1.05 * n_out
        s, t = m.build_frame(-n_out)
        d = m.frame_to_world(s, t, -n_out,
                             warp.square_to_cosine_hemisphere(u_dir))
        starts[CONSTANT] = (p, d, inten * (
            math.pi * 4.0 * math.pi * (1.05 * radius) ** 2))
    if ENVMAP in present:
        d_map, pdf_map, l_map = sample_env(em.env, u_dir)
        r = radius * torch.sqrt(u_pos[..., 0])
        phi = 2.0 * math.pi * u_pos[..., 1]
        s, t = m.build_frame(d_map)
        p = (center + d_map * radius * 1.5
             + s * (r * torch.cos(phi))[..., None]
             + t * (r * torch.sin(phi))[..., None])
        starts[ENVMAP] = (p, -d_map, l_map / torch.clamp(
            pdf_map, min=1e-30)[..., None] * (math.pi * radius * radius)
            / em.pmf[idx][..., None])
    if COLLIMATED in present:
        starts[COLLIMATED] = (em.position[idx], em.direction[idx], inten)
    return _select(kind, starts)


def _select(kind, per_kind):
    """The entry of per_kind ({kind: tuple of tensors}) that each lane's
    kind picks (the first one where a lane's kind is absent)."""
    out = None
    for k, vals in per_kind.items():
        if out is None:
            out = vals
            continue
        sel = kind == k
        out = tuple(torch.where(sel[..., None] if a.dim() > sel.dim() else sel,
                                a, b) for a, b in zip(vals, out))
    return out


def _area_geometry(em: Emitters, idx):
    """(face normal, area) of the AREA entries idx."""
    e1, e2 = em.tri_e1[idx], em.tri_e2[idx]
    normal = m.cross(e1, e2)
    return m.normalize(normal), 0.5 * m.length(normal)


def nee_u(em: Emitters, u3, p, radius, center=None):
    """Direct sampling toward the emitters from the points p (..., 3)
    with the uniforms u3 (..., N_NEE_DIMS) (the emitter choice, then the
    2D sample), in a scene of bounding radius `radius`: (direction,
    unattenuated value (..., 3), distance), as the reference's nee_u.
    Per kind: a point or spot light toward it, I / pmf / r^2 (a spot's
    falloff too); a directional light along -direction at 2 R, E / pmf;
    an area light toward a uniform point of its triangle, L / pmf
    cos A / r^2; a constant light a uniform direction, L / pmf 4 pi; the
    environment map a direction sampled from it, L / (pdf pmf); a
    collimated light 0. Only the kinds in the table are evaluated.

    The constant and environment lights' segments end at 2.5 R, as the
    reference's. With the scene's bounding-sphere `center`, an
    environment map's segment ends where sample_emission_u starts its
    photons instead, on the disk of radius R at 1.5 R along the direction
    from the centre, and points outside the cylinder those photons sweep
    get none of its light, so that in a medium that fills the scene the
    direct sampling sees the light the photons carry (ROADMAP C17)."""
    idx = choose(em, u3[..., U_SELECT])
    kind = em.kind[idx]
    inten = em.intensity[idx] / em.pmf[idx][..., None]
    uv = u3[..., 1:3]
    present = set(em.host_kinds)
    out = {}
    if present & {POINT, SPOT, COLLIMATED}:
        delta = em.position[idx] - p
        dist2 = torch.clamp(m.dot(delta, delta), min=1e-12)
        dist = torch.sqrt(dist2)
        dirn = delta / dist[..., None]
        v_point = inten / dist2[..., None]
        if POINT in present:
            out[POINT] = (dirn, v_point, dist)
        if SPOT in present:
            out[SPOT] = (dirn, v_point * _spot_falloff(em, idx, -dirn)[
                ..., None], dist)
        if COLLIMATED in present:  # a 0-dimensional response: never sampled
            out[COLLIMATED] = (dirn, torch.zeros_like(v_point), dist)
    if DIRECTIONAL in present:
        out[DIRECTIONAL] = (-em.direction[idx], inten,
                            torch.full_like(uv[..., 0], 2.0 * radius))
    if AREA in present:
        su = torch.sqrt(torch.clamp(uv[..., 0], 1e-9, 1.0))
        b0 = 1.0 - su
        b1 = uv[..., 1] * su
        tri_p = (em.position[idx] + b0[..., None] * em.tri_e1[idx]
                 + b1[..., None] * em.tri_e2[idx])
        n_face, area = _area_geometry(em, idx)
        d_a = tri_p - p
        r2 = torch.clamp(m.dot(d_a, d_a), min=1e-12)
        dist_a = torch.sqrt(r2)
        dir_a = d_a / dist_a[..., None]
        cos_face = torch.clamp(m.dot(n_face, -dir_a), min=0.0)
        out[AREA] = (dir_a, inten * (cos_face * area / r2)[..., None], dist_a)
    far = torch.full_like(uv[..., 0], 2.5 * radius)
    if CONSTANT in present:
        out[CONSTANT] = (warp.square_to_uniform_sphere(uv),
                         inten * (4.0 * math.pi), far)
    if ENVMAP in present:
        d_map, pdf_map, l_map = sample_env(em.env, uv)
        v_map = l_map / (torch.clamp(pdf_map, min=1e-30)
                         * em.pmf[idx])[..., None]
        dist_map = far
        if center is not None:  # to the emission disk (ROADMAP C17)
            q = p - center
            along = m.dot(q, d_map)
            dist_map = 1.5 * radius - along
            lit = (dist_map > 0.0) & (m.dot(q, q) - along * along
                                      <= radius * radius)
            v_map = torch.where(lit[..., None], v_map, 0.0)
            dist_map = torch.clamp(dist_map, min=0.0)
        out[ENVMAP] = (d_map, v_map, dist_map)
    return _select(kind, out)


def nee_u_pdf(em: Emitters, u3, p, radius, center=None):
    """nee_u (`center` as there) and the solid-angle pdf of its sample,
    and whether the chosen emitter is one that BSDF or phase sampling
    can also reach (area, constant, environment map; the others' pdf is
    0): (direction, value, distance, pdf, misable), the MIS pair's NEE
    side."""
    idx = choose(em, u3[..., U_SELECT])
    out_d, out_v, out_dist = nee_u(em, u3, p, radius, center)
    kind = em.kind[idx]
    pmf = em.pmf[idx]
    zero = torch.zeros_like(pmf)
    pdf = zero
    present = set(em.host_kinds)
    if AREA in present:
        r2 = torch.clamp(out_dist * out_dist, min=1e-12)
        n_face, area = _area_geometry(em, idx)
        cos_face = torch.clamp(m.dot(n_face, -out_d), min=1e-6)
        pdf = torch.where(kind == AREA, pmf * r2 / (
            cos_face * torch.clamp(area, min=1e-12)), pdf)
    if CONSTANT in present:
        pdf = torch.where(kind == CONSTANT, pmf / (4.0 * math.pi), pdf)
    if ENVMAP in present:
        pdf = torch.where(kind == ENVMAP, pmf * pdf_env(em.env, out_d), pdf)
    misable = (kind == AREA) | (kind == CONSTANT) | (kind == ENVMAP)
    return out_d, out_v, out_dist, pdf, misable


def hit_emitter_nee_pdf(em: Emitters, emit_id, dist, cos_face):
    """Solid-angle pdf with which NEE would have sampled the segment that
    hit AREA entry emit_id at distance dist with facing cosine cos_face
    (the MIS pair's other side)."""
    i = emit_id.clamp(min=0)
    _, area = _area_geometry(em, i)
    return em.pmf[i] * torch.clamp(dist * dist, min=1e-12) / (
        torch.clamp(cos_face, min=1e-6) * torch.clamp(area, min=1e-12))


def env_nee_pdf(em: Emitters, d):
    """Total solid-angle pdf with which NEE samples the escape direction
    d (..., 3) through the constant and environment-map entries."""
    p_const = torch.where(em.kind == CONSTANT, em.pmf, 0.0).sum() / (
        4.0 * math.pi)
    p_map = torch.where(em.kind == ENVMAP, em.pmf, 0.0).sum()
    if em.env is None:
        return p_const.expand(d.shape[:-1])
    return p_const + p_map * pdf_env(em.env, d)


def env_radiance(em: Emitters, d):
    """(..., 3) environment radiance a ray escaping along d sees: the
    constant entries' and the environment map's (Scene::evalEnvironment)."""
    const_l = torch.where((em.kind == CONSTANT)[:, None], em.intensity,
                          0.0).sum(dim=0)
    if em.env is None:
        return const_l.expand(d.shape)
    return const_l + eval_env(em.env, d)
