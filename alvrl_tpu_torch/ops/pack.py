"""Packing: scene, eye rays and VRLs -> the flat float32 arrays the
render kernel reads.

Counterpart of alvrl_tpu/ops/pack.py (pack_rays, pack_vrls, pack_tris,
pack_medium, and the grid-medium pack_rays_hetero, pack_vrls_hetero,
pack_medium_hetero), with layouts chosen for the CUDA kernels: structure
of arrays, one row per scalar, so that neighbouring threads (rays) read
neighbouring addresses. Nothing is padded; the kernels mask the ragged
edge of the last block themselves. The grid packs append the
cumulative optical-depth tables (media.heterogeneous.cumulative_od,
plain torch, as the JAX package builds them outside its kernel) to the
ray and VRL packs; the supersampled density goes to the kernels as its
own contiguous (2Z - 1, 2Y - 1, 2X - 1) tensor.
"""

from __future__ import annotations

import torch

from alvrl_tpu_torch.core import math as m
from alvrl_tpu_torch.media import heterogeneous as gmed
from alvrl_tpu_torch.media import homogeneous as hmed
from alvrl_tpu_torch.media import phase as ph
from alvrl_tpu_torch.scene.scene import DIFFUSE, Materials, Scene

# ray pack rows, (RAY_ROWS, B): origin, direction, hit point, normal at
# the hit (facing the ray), diffuse albedo at the hit, transmittance eye
# -> hit, hit valid (0/1); the material kernels' pack (MAT_RAY_ROWS, B)
# adds the hit's material id (MATID); the textured kernels' pack
# (TEX_RAY_ROWS, B), a textured table's, adds the hit's Shading
# (bsdf.api.shading, resolved once a ray: the eye hit is every VRL's):
# the shading normal (TEX_NS) and the albedos of the hit material's leaf
# and of its nested and nested2 leaves (TEX_ALB, 3 rows each)
RO, RD, HP, NG, ALB, TAU, VALID = 0, 3, 6, 9, 12, 15, 18
RAY_ROWS = 19
MATID = RAY_ROWS
MAT_RAY_ROWS = MATID + 1
TEX_NS = MAT_RAY_ROWS
TEX_ALB = TEX_NS + 3
TEX_RAY_ROWS = TEX_ALB + 9
# material pack, (M, MAT_COLS): kind, albedo (3), eta, alpha, alpha_v, the
# microfacet distribution, specular (3), exponent, opacity, nested,
# nested2, albedo2 (3), the rough-transmittance table's alpha span, the
# smooth flag (bsdf.api.smooth_flags, 0/1); ids and kinds as floats. The
# rough-transmittance tables go beside it as their own contiguous
# (M, RT_COS, RT_ALPHA) tensor.
(MT_KIND, MT_ALB, MT_ETA, MT_ALPHA, MT_ALPHA_V, MT_DIST, MT_SPEC, MT_EXP,
 MT_OPAC, MT_NESTED, MT_NESTED2, MT_ALB2, MT_RT_AMAX, MT_SMOOTH) = (
    0, 1, 4, 5, 6, 7, 8, 11, 12, 13, 14, 15, 18, 19)
MAT_COLS = 20
_MAT_COLUMNS = (("kind", MT_KIND), ("albedo", MT_ALB), ("eta", MT_ETA),
                ("alpha", MT_ALPHA), ("alpha_v", MT_ALPHA_V),
                ("dist", MT_DIST), ("specular", MT_SPEC),
                ("exponent", MT_EXP), ("opacity", MT_OPAC),
                ("nested", MT_NESTED), ("nested2", MT_NESTED2),
                ("albedo2", MT_ALB2), ("rt_alpha_max", MT_RT_AMAX))
# vrl pack rows, (VRL_ROWS, N): start, end, power, valid (0/1)
VS, VE, VP, VVALID = 0, 3, 6, 9
VRL_ROWS = 10
# triangle pack, (T, TRI_COLS): p0, e1 = p1 - p0, e2 = p2 - p0
TRI_COLS = 9
# medium pack, (MED_LEN,): sigma_t (3), sigma_s (3), g, sampling weight;
# for a mixture phase or a strategy other than balance, extended by the
# strategy's one sampling rate (MED_RHO; 0 for balance), the mixture's
# component count K (MED_K) and its K (weight, kind, g) triples
# (MED_MIX on): MED_LEN + 2 + 3 K floats, which kernels 1, 2 and 5 take
MED_LEN = 8
MED_RHO, MED_K, MED_MIX = 8, 9, 10
# grid packs: the ray pack's rows, then the eye segment's cumulative
# optical depth (NQ + 1 rows), its TAU rows exp(-sigma_t_color * eye
# OD); the VRL pack's rows, then the VRL's cumulative optical depth
NQ = gmed.N_TAU_STEPS
EOD = RAY_ROWS
GRID_RAY_ROWS = EOD + NQ + 1
# the grid material kernels' ray pack (GRID_MAT_RAY_ROWS, B) adds the hit's
# material id after the eye-OD rows (GRID_MATID); the grid textured
# kernels' pack (GRID_TEX_RAY_ROWS, B), a textured table's, then adds the
# textured pack's 12 rows of the hit's Shading (GRID_TEX_NS, GRID_TEX_ALB)
GRID_MATID = GRID_RAY_ROWS
GRID_MAT_RAY_ROWS = GRID_MATID + 1
GRID_TEX_NS = GRID_MAT_RAY_ROWS
GRID_TEX_ALB = GRID_TEX_NS + 3
GRID_TEX_RAY_ROWS = GRID_TEX_ALB + 9
VOD = VRL_ROWS
GRID_VRL_ROWS = VOD + NQ + 1
# grid medium pack, (GRID_MED_LEN,): sigma_t_color (3), sigma_s_color (3),
# g, chan = mean(sigma_t_color), box_min (3), 1 / extent (3), the
# half-cell index scales 2 (d - 1) of x, y, z (3), the density scale; a
# medium of fast_tau False gets the trilinear pack, (GRID_TRI_MED_LEN,):
# the index scales are d - 1, and a last float (1) makes the pack one
# longer, the tag is_trilinear reads; its readers (the kernels'
# trilinear forms, integrate.grid_density) read the density itself
# trilinearly
GRID_MED_LEN = 18
GRID_TRI_MED_LEN = GRID_MED_LEN + 1


def is_trilinear(medium):
    """Whether a grid medium pack is the trilinear one (GRID_TRI_MED_LEN,
    fast_tau False). Reads its length, no value, so no sync."""
    return medium.shape[0] == GRID_TRI_MED_LEN


def _ray_cols(scene: Scene, ray_o, ray_d, hit, mat, tau_eu):
    diffuse = (scene.materials.kind[mat] == DIFFUSE)[..., None]
    albedo = torch.where(diffuse, scene.materials.albedo[mat], 0.0)
    tau_eu = torch.where(hit.valid[..., None], tau_eu, 0.0)
    return [ray_o, ray_d, hit.p, hit.ng, albedo, tau_eu,
            hit.valid.to(torch.float32)[..., None]]


def pack_rays(scene: Scene, ray_o, ray_d, hit, mat, with_mat=False):
    """(RAY_ROWS, B) rows of the eye rays and their closest hits, as
    integrators.vrl.integrator.trace_eye_rays gives them (hit, mat); with
    with_mat, (MAT_RAY_ROWS, B), the material kernels' pack, which adds
    the hit material's id, or on a textured table (Scene.textured)
    (TEX_RAY_ROWS, B), the textured kernels' pack, which also adds the
    hit's Shading at its point and UV."""
    tau_eu = hmed.eval_transmittance(scene.medium, m.length(hit.p - ray_o))
    cols = _ray_cols(scene, ray_o, ray_d, hit, mat, tau_eu)
    if with_mat:
        cols.append(mat.to(torch.float32)[..., None])
        if scene.textured():
            cols += tex_cols(scene, hit, mat)
    return torch.cat(cols, dim=-1).T.contiguous()


def tex_cols(scene: Scene, hit, mat):
    """The textured pack's columns of the hits (hit, mat): the shading
    normal and the three albedos (bsdf.api.shading at hit.p and the
    hit's interpolated UV), (..., 3) each."""
    from alvrl_tpu_torch.bsdf.api import shading
    from alvrl_tpu_torch.textures.procedural import interp_uv

    return list(shading(scene, mat, hit.ng, hit.p,
                        interp_uv(scene.face_uv, hit.prim, hit.uv)))


def is_textured(rays):
    """Whether a ray pack is a textured one: the homogeneous
    (TEX_RAY_ROWS rows) or the grid one (GRID_TEX_RAY_ROWS), whose row
    counts no other pack has. Reads its shape, so no sync."""
    return rays.shape[0] in (TEX_RAY_ROWS, GRID_TEX_RAY_ROWS)


def tex_rows(rays):
    """The (shading normal, first albedo) rows of a textured ray pack:
    (TEX_NS, TEX_ALB), or in the grid one (GRID_TEX_NS, GRID_TEX_ALB)."""
    return ((TEX_NS, TEX_ALB) if rays.shape[0] == TEX_RAY_ROWS
            else (GRID_TEX_NS, GRID_TEX_ALB))


def pack_materials(mats: Materials):
    """The material kernels' table: ((M, MAT_COLS) float32 rows, the
    (M, RT_COS, RT_ALPHA) rough-transmittance tables), both contiguous."""
    from alvrl_tpu_torch.bsdf.api import smooth_flags

    cols = [getattr(mats, k).to(torch.float32).reshape(mats.kind.shape[0],
                                                       -1)
            for k, _ in _MAT_COLUMNS]
    cols.append(smooth_flags(mats).to(torch.float32)[:, None])
    return (torch.cat(cols, dim=1).contiguous(),
            mats.rt_table.to(torch.float32).contiguous())


def materials_from_pack(table, rt_tables):
    """The Materials that a material pack holds (pack_materials), its ids
    clamped into [0, M) as the kernels clamp them."""
    n = table.shape[0]
    out = {}
    for (k, c), (_, c1) in zip(_MAT_COLUMNS, _MAT_COLUMNS[1:] + (
            ("smooth", MT_SMOOTH),)):
        col = table[:, c:c1]
        out[k] = col if c1 - c == 3 else col[:, 0]
    for k in ("kind", "dist", "nested", "nested2"):
        out[k] = out[k].to(torch.int64)
    for k in ("nested", "nested2"):
        out[k] = out[k].clamp(0, n - 1)
    return Materials(**out, rt_table=rt_tables)


def pack_rays_hetero(scene: Scene, ray_o, ray_d, hit, mat, density_ss,
                     with_mat=False):
    """(GRID_RAY_ROWS, B): pack_rays' rows for a grid medium, then the
    eye segment's cumulative optical depth (the medium's own lookup:
    density_ss is media.heterogeneous.quad_grid's); TAU is
    exp(-sigma_t_color times the table's total). With with_mat,
    (GRID_MAT_RAY_ROWS, B), the grid material kernels' pack, which adds
    the hit material's id (GRID_MATID), or on a textured table
    (Scene.textured) (GRID_TEX_RAY_ROWS, B), the grid textured kernels'
    pack, which also adds the hit's Shading at its point and UV (the
    homogeneous textured pack's rows, tex_cols)."""
    med = scene.medium
    eye_od = gmed.cumulative_od(med, density_ss, ray_o, hit.p)
    tau_eu = torch.exp(-med.sigma_t_color * eye_od[..., -1:])
    cols = _ray_cols(scene, ray_o, ray_d, hit, mat, tau_eu) + [eye_od]
    if with_mat:
        cols.append(mat.to(torch.float32)[..., None])
        if scene.textured():
            cols += tex_cols(scene, hit, mat)
    return torch.cat(cols, dim=-1).T.contiguous()


def pack_vrls(vrls):
    """(VRL_ROWS, N) rows of the VRL buffer."""
    cols = [vrls.start, vrls.end, vrls.power,
            vrls.valid.to(torch.float32)[..., None]]
    return torch.cat(cols, dim=-1).T.contiguous()


def pack_vrls_hetero(vrls, med, density_ss):
    """(GRID_VRL_ROWS, N): pack_vrls' rows, then each VRL's cumulative
    optical depth in the grid medium `med` (density_ss as
    pack_rays_hetero's)."""
    vrl_od = gmed.cumulative_od(med, density_ss, vrls.start, vrls.end)
    cols = [vrls.start, vrls.end, vrls.power,
            vrls.valid.to(torch.float32)[..., None], vrl_od]
    return torch.cat(cols, dim=-1).T.contiguous()


def pack_tris(scene: Scene):
    """(T, TRI_COLS) triangles as p0, e1, e2. Triangles that do not
    block shadow rays are zeroed: a degenerate triangle never hits."""
    f = scene.faces
    p0 = scene.vertices[f[:, 0]]
    e1 = scene.vertices[f[:, 1]] - p0
    e2 = scene.vertices[f[:, 2]] - p0
    tri = torch.cat([p0, e1, e2], dim=1)
    opaque = scene.opaque_faces()[:, None]
    return torch.where(opaque, tri, 0.0).contiguous()


def pack_medium(scene: Scene):
    """The homogeneous medium's parameters: (MED_LEN,) for an HG or
    Rayleigh medium of the balance strategy, else the extended pack
    (MED_LEN + 2 + 3 K,) of the rate and the mixture (see MED_LEN)."""
    med = scene.medium
    base = torch.cat([med.sigma_t, med.sigma_s, med.g.reshape(1),
                      med.sampling_weight.reshape(1)]).to(torch.float32)
    mixture = med.phase_kind == ph.MIXTURE
    if med.strategy == hmed.BALANCE and not mixture:
        return base
    rho = (torch.zeros_like(base[:1]) if med.strategy == hmed.BALANCE
           else med.sampling_density.reshape(1).to(torch.float32))
    comps = torch.zeros((0,), dtype=torch.float32, device=base.device)
    if mixture:
        w, kinds, g = med.phase_params.host
        comps = torch.tensor([x for c in zip(w, kinds, g) for x in c],
                             dtype=torch.float32, device=base.device)
    k = torch.full((1,), float(comps.shape[0] // 3), dtype=torch.float32,
                   device=base.device)
    return torch.cat([base, rho, k, comps])


def extended_medium(medium):
    """The medium pack with its extension, as kernels 1, 2 and 5 read it:
    a (MED_LEN,) pack gets rate 0 (balance) and no mixture."""
    if medium.shape[0] > MED_LEN:
        return medium
    return torch.cat([medium, medium.new_zeros(2)])


def medium_extension(medium):
    """(rho, mixture (K, 3) of weight, kind, g) of a medium pack; rho 0
    and K 0 for a (MED_LEN,) pack. Reads no value, so no sync."""
    if medium.shape[0] <= MED_LEN:
        return medium.new_zeros(()), medium.new_zeros((0, 3))
    return medium[MED_RHO], medium[MED_MIX:].reshape(-1, 3)


def pack_medium_hetero(med):
    """The grid medium's parameters: (GRID_MED_LEN,), or with fast_tau
    False the trilinear pack (GRID_TRI_MED_LEN,) (see GRID_MED_LEN),
    whose grid must be at least 2 voxels along each axis."""
    dz, dy, dx = med.density.shape
    per = 2.0 if med.fast_tau else 1.0
    if not med.fast_tau and min(dz, dy, dx) < 2:
        raise ValueError("the trilinear read needs a grid of at least 2 "
                         f"voxels a side, got {tuple(med.density.shape)}")
    scales = torch.tensor([per * (dx - 1), per * (dy - 1), per * (dz - 1)],
                          dtype=torch.float32, device=med.density.device)
    mark = med.density.new_ones(0 if med.fast_tau else 1)
    return torch.cat([
        med.sigma_t_color, med.sigma_s_color, med.g.reshape(1),
        med.sigma_t_color.mean().reshape(1), med.box_min,
        1.0 / (med.box_max - med.box_min), scales,
        med.scale.reshape(1), mark]).to(torch.float32)
