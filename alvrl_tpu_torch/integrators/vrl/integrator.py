"""VRL integrator: per-pixel radiance as a sum of VRL x eye-ray integrals.

Counterpart of alvrl_tpu/integrators/vrl/integrator.py: the unclustered
render (every eye ray against every VRL; plain, or differentiable
through the seed-replay VJP; or, for large meshes, with BVH hits and
BVH shadow tests; or with specular chains through mirrors, dielectrics
and null boundaries, one launch of the sum per chain depth), and the
two device
stages of the clustered render (integrators.vrl.alvrl): the transfer
matrix R over representative rays, and the render of each pixel against
its slice's representatives (plain, or differentiable through the
clustered VJP). Each entry dispatches on the scene's
medium: a grid medium goes through the grid packs and the grid kernels
(vrl_sum_hetero, vrl_r_hetero, vrl_sum_hetero_clustered), with the
grid of its quadratures computed once per call (media.heterogeneous.
quad_grid: the supersample, or with fast_tau False the density itself,
whose trilinear medium pack takes the kernels' trilinear forms, the
backward kernels 9 and 11 too). Sums are normalised by the traced-particle count. Every route refuses an
oriented medium (Kajiya-Kay, micro-flake), which only volpath renders,
as in the JAX package (tracer.refuse_oriented).

And on the scene's material kinds (bsdf.api.check_kinds, the table's
host copy of them, so no sync): a table that holds a smooth kind other than DIFFUSE (a
glossy or layered surface, whose eye-side term the diffuse kernels do
not evaluate) takes the material instantiations of the forward kernels
(material_pack: kernels 1, 2 and 5 in a homogeneous medium, the grid
kernels 3, 4 and 6 in a grid one, either density read, and the BVH
kernel 7; the unclustered, specular-chain, large-mesh and clustered
renders and R), and so do the backward kernels 8-11 behind the
differentiable routes, as the JAX package's XLA route evaluates every
smooth kind at the eye hit and its train step differentiates it.
Likewise a homogeneous medium with a mixture phase or a sampling
strategy other than balance (ops.pack.pack_medium's extended pack)
takes the extended forms of kernels 1, 2, 5, 7, 8 and 10.

A textured table (Scene.textured: a procedural or bitmap texture, a
NORMALMAP or an HK slab) takes the textured forms of the forward
kernels: 1, 2 and 5 in a homogeneous medium, 3, 4 and 6 in a grid one
(either density read), 7 on a large mesh. They take the material pack
with the textured ray pack (ops.pack.TEX_RAY_ROWS, or in a grid medium
GRID_TEX_RAY_ROWS), whose rows carry each eye hit's shading normal and
textured albedos, resolved once a ray at its hit point and UV (the JAX
package's XLA route drops the UV there, ROADMAP C23, and its Pallas
packs the texture, C25; the port's term follows its tracer and
volpath). The unclustered, specular-chain, large-mesh and clustered
renders and R take it; the differentiable routes (kernels 8-11,
train_step) have no textured form yet and refuse such a table by name
(refuse_textured, ROADMAP A11a).
"""

from __future__ import annotations

import numpy as np
import torch

from alvrl_tpu_torch.bsdf import api as bsdf_api
from alvrl_tpu_torch.film import film as film_mod
from alvrl_tpu_torch.geometry import bvh as bvh_mod
from alvrl_tpu_torch.geometry import intersect
from alvrl_tpu_torch.integrators.vrl import specular
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.integrators.vrl.tracer import refuse_oriented
from alvrl_tpu_torch.integrators.vrl.vrl import VRLs
from alvrl_tpu_torch.media import api as mapi
from alvrl_tpu_torch.media import heterogeneous as gmed
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops.vrl_r import vrl_r, vrl_r_hetero
from alvrl_tpu_torch.ops.vrl_sum import (
    philox_draws,
    vrl_sum,
    vrl_sum_hetero,
    vrl_sum_hetero_reference,
    vrl_sum_reference,
)
from alvrl_tpu_torch.ops.vrl_sum_bvh import (
    pack_bvh_tris,
    sort_vrls_morton,
    vrl_sum_bvh,
)
from alvrl_tpu_torch.ops.vrl_sum_bwd import vrl_sum_diff, vrl_sum_hetero_diff
from alvrl_tpu_torch.ops.vrl_sum_clustered import (
    vrl_sum_clustered,
    vrl_sum_hetero_clustered,
)
from alvrl_tpu_torch.ops.vrl_sum_clustered_bwd import (
    vrl_sum_clustered_diff,
    vrl_sum_hetero_clustered_diff,
)
from alvrl_tpu_torch.scene.scene import Scene
from alvrl_tpu_torch.sensors import perspective


def trace_eye_rays(scene: Scene, ray_o, ray_d):
    """Closest hits with misses' points moved to the ray origin (so that
    masked arithmetic stays finite; the hit also carries the winding
    normal ng_raw, which a dielectric's entering test reads), and the hit
    material ids. Returns (hit, mat)."""
    return _eye_hits(scene, ray_o, intersect.intersect_all(
        ray_o, ray_d, scene.vertices, scene.faces))


def _eye_hits(scene: Scene, ray_o, hit):
    """(hit with misses' points at ray_o, the hit material ids)."""
    hit = hit._replace(p=torch.where(hit.valid[..., None], hit.p, ray_o))
    return hit, scene.material[hit.prim.clamp(min=0)]


def material_pack(scene: Scene):
    """The material pack (ops.pack.pack_materials) that the material
    instantiations of the kernels 1-11 take, when the scene's table
    holds a smooth kind other than DIFFUSE (bsdf.api.has_glossy) or is
    textured (Scene.textured: with a textured ray pack, the textured
    forms of kernels 1-7); None otherwise, for the diffuse
    instantiations."""
    kinds = bsdf_api.check_kinds(scene)
    return pk.pack_materials(scene.materials) if (
        bsdf_api.has_glossy(kinds) or scene.textured()) else None


def refuse_textured(scene: Scene, route: str):
    """Raise, naming `route`, on a textured table (Scene.textured), which
    only the forward routes (kernels 1-7) render."""
    if scene.textured():
        raise ValueError(f"{route} has no textured form: a texture, a "
                         "NORMALMAP or an HK slab is rendered by the "
                         "forward routes of kernels 1-7 only (ROADMAP A11a: "
                         "the textured forms of kernels 8-11)")


def _route_materials(scene: Scene, route: str, textured=True):
    """material_pack, in either medium (the kernels' material and
    textured forms), after refuse_oriented, and refuse_textured unless
    the route takes a textured table (`textured`)."""
    refuse_oriented(scene.medium, route)
    if not textured:
        refuse_textured(scene, route)
    return material_pack(scene)


def _mat_kw(materials):
    return {} if materials is None else {"materials": materials}


def pack_rays_vrls(scene: Scene, ray_o, ray_d, vrls: VRLs, materials=None):
    """The eye rays' closest hits and the packs of the scene's kernels:
    (hit, packs), packs = (rays, vrls, tris, medium) for a homogeneous
    medium (ops.vrl_sum.vrl_sum's; with a material pack, `materials`, the
    rays' pack holds the hits' material ids, as the material
    instantiations read them), and (rays, vrls, tris, medium, density_ss)
    for a grid medium (vrl_sum_hetero's: the grid packs, the grid ray
    pack with the ids likewise, and the supersampled density, computed
    here from the current density)."""
    hit, mat = trace_eye_rays(scene, ray_o, ray_d)
    med = scene.medium
    if mapi.is_homogeneous(med):
        return hit, (pk.pack_rays(scene, ray_o, ray_d, hit, mat,
                                  with_mat=materials is not None),
                     pk.pack_vrls(vrls), pk.pack_tris(scene),
                     pk.pack_medium(scene))
    density_ss = gmed.quad_grid(med)
    return hit, (pk.pack_rays_hetero(scene, ray_o, ray_d, hit, mat,
                                     density_ss,
                                     with_mat=materials is not None),
                 pk.pack_vrls_hetero(vrls, med, density_ss),
                 pk.pack_tris(scene), pk.pack_medium_hetero(med),
                 density_ss.contiguous())


def frame_rays(scene: Scene, jitter=None):
    """One eye ray per pixel (row-major), through the pixel centre or,
    with jitter (W * H, 2) in [0, 1)^2, through that sub-pixel position:
    (px, py, ray_o, ray_d)."""
    w, h = scene.camera.width, scene.camera.height
    px, py = torch.meshgrid(torch.arange(w, device=scene.device),
                            torch.arange(h, device=scene.device),
                            indexing="xy")
    px, py = px.reshape(-1), py.reshape(-1)
    return (px, py, *perspective.sample_ray(scene.camera, px, py, jitter))


def pack_frame(scene: Scene, vrls: VRLs, jitter=None, materials=None):
    """The eye rays of frame_rays, their closest hits, and the packs of
    the scene's kernels (pack_rays_vrls). Returns (px, py, hit, packs)."""
    px, py, ray_o, ray_d = frame_rays(scene, jitter)
    hit, packs = pack_rays_vrls(scene, ray_o, ray_d, vrls, materials)
    return px, py, hit, packs


def trace_eye_rays_bvh(scene: Scene, ray_o, ray_d, tree=None):
    """trace_eye_rays through a BVH over all faces (geometry.bvh; built
    here unless `tree` is given): the same (hit, mat)."""
    if tree is None:
        tree = bvh_mod.build(scene.vertices, scene.faces)
    t, prim, valid = bvh_mod.intersect(tree, ray_o, ray_d)
    return _eye_hits(scene, ray_o, intersect.hit_record(
        ray_o, ray_d, t, prim, valid, scene.vertices, scene.faces))


def pack_frame_bvh(scene: Scene, vrls: VRLs, jitter=None, materials=None):
    """pack_frame for the large-mesh render: hits through a BVH over all
    faces, the VRLs in Morton order (ops.vrl_sum_bvh.sort_vrls_morton)
    and, in place of the triangle pack, the BVH over the opaque faces
    (pack_bvh_tris); with a material pack, `materials`, the rays' pack
    holds the hits' material ids (on a textured table the textured ray
    pack, with each hit's Shading). Homogeneous media only (the medium
    pack of a mixture phase or a strategy other than balance extended,
    as ops.pack.pack_medium makes it). Returns (px, py, hit, (rays,
    vrls, bvh, medium))."""
    refuse_oriented(scene.medium, "the large-mesh render (kernel 7)")
    if not mapi.is_homogeneous(scene.medium):
        raise ValueError("the large-mesh render takes a homogeneous medium "
                         "only, as the JAX package's vrl_sum_pallas_bvh")
    px, py, ray_o, ray_d = frame_rays(scene, jitter)
    hit, mat = trace_eye_rays_bvh(scene, ray_o, ray_d)
    return px, py, hit, (pk.pack_rays(scene, ray_o, ray_d, hit, mat,
                                      with_mat=materials is not None),
                         pk.pack_vrls(sort_vrls_morton(vrls)),
                         pack_bvh_tris(scene.vertices, scene.faces,
                                       scene.opaque_faces()),
                         pk.pack_medium(scene))


def render_with_vrls_kernel(scene: Scene, vrls: VRLs, generator,
                            cfg: VRLConfig = VRLConfig(), *, uniforms=None,
                            jitter=None):
    """Full-frame unclustered render through ops.vrl_sum (vrl_sum_hetero
    in a grid medium); counterpart of
    alvrl_tpu.integrators.vrl.integrator.render_with_vrls_pallas and
    render_with_vrls_pallas_hetero.

    The kernel's seed is drawn from `generator` (a torch.Generator on
    the CPU). `uniforms`, (W * H, N, 2 * vol_vol + vol_surf) float32 on
    the scene's device, replaces the random stream (for exact checks);
    `jitter`, (W * H, 2) on the scene's device, moves each pixel's ray
    off its centre (frame_rays; the JAX package's antialias). A glossy
    or layered table takes kernel 1's material instantiation (module
    docstring), in a grid medium kernel 3's material form; a textured
    table their textured forms. Returns the (H, W, 3) image."""
    materials = _route_materials(scene, "the unclustered render")
    return _render(_kernel(scene, vrl_sum, vrl_sum_hetero), scene, vrls,
                   generator, cfg, uniforms, jitter, materials)


def render_with_vrls_kernel_bvh(scene: Scene, vrls: VRLs, generator,
                                cfg: VRLConfig = VRLConfig(), *,
                                uniforms=None, jitter=None):
    """The large-mesh unclustered render, through ops.vrl_sum_bvh (no cap
    on the triangle count): primary hits through a BVH, the VRLs in
    Morton order, shadow tests through a BVH over the opaque faces
    (pack_frame_bvh). Counterpart of alvrl_tpu's
    render_with_vrls_pallas_bvh; homogeneous media only. A glossy or
    layered table takes kernel 7's material forms, a textured one its
    textured form, a mixture phase or a strategy other than balance its
    extended forms (module docstring).

    The kernel's seed is drawn from `generator`; `uniforms`, (W * H, N,
    2 * vol_vol + vol_surf) float32 on the scene's device, indexed by
    the Morton-sorted VRLs, replaces the random stream; `jitter` is
    render_with_vrls_kernel's. Returns the (H, W, 3) image."""
    materials = material_pack(scene)
    px, py, hit, packs = pack_frame_bvh(scene, vrls, jitter, materials)
    sums = vrl_sum_bvh(*packs, seed=draw_seed(generator), uniforms=uniforms,
                       **_kernel_args(scene, cfg), **_mat_kw(materials))
    return develop_sums(scene, vrls, px, py, hit, sums)


def render_with_vrls_kernel_diff(scene: Scene, vrls: VRLs, generator,
                                 cfg: VRLConfig = VRLConfig(), *,
                                 uniforms=None):
    """render_with_vrls_kernel, differentiable through the seed-replay VJP;
    geometry is detached. Counterpart of render_with_vrls_pallas_diff
    and render_with_vrls_pallas_hetero_diff.

    In a homogeneous medium (ops.vrl_sum_bwd.vrl_sum_diff): in the
    medium's sigma_a, sigma_s and g, the VRL powers and the
    eye-to-surface transmittance (a strategy's rate chaining to sigma_t
    through the medium's sampling_density, kernel 8's extended forms). In
    a grid medium (vrl_sum_hetero_diff): in sigma_t_color, albedo, g,
    scale and the density voxels (through upsample2, or with fast_tau
    False the trilinear read itself, the eye and VRL cumulative-OD tables
    of the grid packs and the kernel's density scatter, all chained by
    autograd), the VRL powers and the eye transmittance. The grid
    signature has neither the CP factors nor their `dens_scale`
    multiplier (ROADMAP C9, C10): a density multiplier is the medium's
    `scale` or a product on its density, through which autograd chains.
    A glossy or layered table takes the backward kernels' material forms
    (the material's own parameters get no gradient, as in the JAX
    package's train step); an oriented medium is refused."""
    materials = _route_materials(scene, "the differentiable render "
                                 "(kernels 8 and 9)", textured=False)
    return _render(_kernel(scene, vrl_sum_diff, vrl_sum_hetero_diff), scene,
                   vrls, generator, cfg, uniforms, None, materials)


def li_unclustered_spec(scene: Scene, ray_o, ray_d, vrls: VRLs, generator,
                        cfg: VRLConfig = VRLConfig(),
                        spec_cfg: specular.SpecularConfig =
                        specular.SpecularConfig()):
    """Unclustered Li (B, 3) of the eye rays (ray_o, ray_d) with specular
    chains, through the plain sums (vrl_sum_reference, or
    vrl_sum_hetero_reference in a grid medium), normalised by the
    particle count; counterpart of alvrl_tpu's li_unclustered_spec. The
    chain's uniforms (B rays, then one seed a depth) are drawn from
    `generator`; a depth's sums take the Philox stream of its seed at the
    rays' indices among the B. See li_unclustered_spec_u."""
    u_chain, seeds = _chain_draws(generator, spec_cfg, ray_o.shape[0],
                                  scene.device)
    n_vrls = vrls.capacity
    draws = 2 * cfg.vol_vol_samples + cfg.vol_surf_samples
    vrl_idx = torch.arange(n_vrls, device=scene.device)[None, :]
    return _li_spec_plain(
        scene, ray_o, ray_d, vrls, u_chain,
        lambda depth, idx: philox_draws(seeds[depth], idx[:, None], vrl_idx,
                                        draws),
        cfg, spec_cfg)


def li_unclustered_spec_u(scene: Scene, ray_o, ray_d, vrls: VRLs, u_chain,
                          u_sums, cfg: VRLConfig = VRLConfig(),
                          spec_cfg: specular.SpecularConfig =
                          specular.SpecularConfig()):
    """li_unclustered_spec on explicit uniforms: u_chain (max_depth, B,
    specular.N_CHAIN_DIMS), each step's lobe and roulette uniforms, and
    u_sums (max_depth + 1, B, N, 2 * vol_vol + vol_surf), the sums'
    uniforms at each depth."""
    return _li_spec_plain(scene, ray_o, ray_d, vrls, u_chain,
                          lambda depth, idx: u_sums[depth, idx], cfg, spec_cfg)


def _li_spec_plain(scene, ray_o, ray_d, vrls, u_chain, sum_uniforms, cfg,
                   spec_cfg):
    med = scene.medium
    materials = _route_materials(scene, "the plain chain")
    density_ss = None if mapi.is_homogeneous(med) else gmed.quad_grid(med)
    if density_ss is None:
        side = (pk.pack_vrls(vrls), pk.pack_tris(scene), pk.pack_medium(scene))
    else:
        side = (pk.pack_vrls_hetero(vrls, med, density_ss),
                pk.pack_tris(scene), pk.pack_medium_hetero(med), density_ss)

    def li_at_hit(o, d, hit, mat, idx, depth, weight):
        kw = dict(vol_vol_samples=cfg.vol_vol_samples,
                  vol_surf_samples=cfg.vol_surf_samples,
                  short_vrls=cfg.short_vrls, phase_kind=med.phase_kind,
                  weight=weight)
        u = sum_uniforms(depth, idx)
        if density_ss is None:
            out = vrl_sum_reference(
                pk.pack_rays(scene, o, d, hit, mat,
                             with_mat=materials is not None),
                *side, u, materials=materials, **kw)
        else:
            out = vrl_sum_hetero_reference(
                pk.pack_rays_hetero(scene, o, d, hit, mat, density_ss,
                                    with_mat=materials is not None),
                *side, u, uv_steps=cfg.uv_tau_steps, materials=materials,
                **kw)
        return out.T

    li = specular.li_specular_chain(scene, ray_o, ray_d, li_at_hit,
                                    trace_eye_rays, u_chain, spec_cfg,
                                    density_ss=density_ss)
    return li / torch.clamp(vrls.particle_count, min=1.0)


def render_with_vrls_kernel_spec(scene: Scene, vrls: VRLs, generator,
                                 cfg: VRLConfig = VRLConfig(),
                                 spec_cfg: specular.SpecularConfig =
                                 specular.SpecularConfig(), *,
                                 uniforms=None):
    """Full-frame unclustered render with specular chains through
    mirrors, dielectrics and null boundaries (specular.li_specular_chain):
    each chain depth packs its rays (a delta surface packs albedo 0) and
    launches ops.vrl_sum (kernel 1) once, and the chain weight multiplies
    its per-ray output; a glossy or layered table takes kernel 1's
    material instantiation at every depth. Counterpart of alvrl_tpu's
    render_with_vrls_pallas_spec; homogeneous media only, as there.

    The chain's uniforms (max_depth, W * H, specular.N_CHAIN_DIMS), then
    one kernel seed a depth, are drawn from `generator` (a CPU
    torch.Generator). `uniforms`, (max_depth + 1, W * H, N, 2 * vol_vol +
    vol_surf) on the scene's device, replaces the kernel's random stream
    (depth k's launch reads uniforms[k] at its rays). Each depth launches
    on the rays still on a chain, gathered (a host sync a depth), and the
    chain stops at the first depth without one. On the Philox stream the
    kernel numbers a ray by its place in the launch, so the image equals
    the reference's (which launches every depth on every ray) and
    li_unclustered_spec's in expectation, and to rounding only on
    injected uniforms. Returns the (H, W, 3) image."""
    refuse_oriented(scene.medium, "the specular-chain render")
    if not mapi.is_homogeneous(scene.medium):
        raise ValueError("the specular-chain render takes a homogeneous "
                         "medium only, as the JAX package's "
                         "render_with_vrls_pallas_spec (ROADMAP A7)")
    materials = material_pack(scene)
    px, py, ray_o, ray_d = frame_rays(scene)
    u_chain, seeds = _chain_draws(generator, spec_cfg, ray_o.shape[0],
                                  scene.device)
    side = (pk.pack_vrls(vrls), pk.pack_tris(scene), pk.pack_medium(scene))
    kw = dict(_kernel_args(scene, cfg), **_mat_kw(materials))

    def li_at_hit(o, d, hit, mat, idx, depth, weight):
        out = vrl_sum(pk.pack_rays(scene, o, d, hit, mat,
                                   with_mat=materials is not None), *side,
                      seed=seeds[depth],
                      uniforms=None if uniforms is None else uniforms[depth,
                                                                      idx],
                      **kw)
        return out.T * weight

    li = specular.li_specular_chain(scene, ray_o, ray_d, li_at_hit,
                                    trace_eye_rays, u_chain, spec_cfg)
    li = li / torch.clamp(vrls.particle_count, min=1.0)
    img, wgt = film_mod.splat_box(scene.camera.width, scene.camera.height,
                                  px, py, li)
    return film_mod.develop(img, wgt)


def _chain_draws(generator, spec_cfg, n_rays, device):
    """The chain's uniforms (max_depth, n_rays, N_CHAIN_DIMS) on `device`,
    then max_depth + 1 kernel seeds, drawn from `generator`."""
    u = torch.rand((spec_cfg.max_depth, n_rays, specular.N_CHAIN_DIMS),
                   generator=generator, device=generator.device).to(device)
    return u, [draw_seed(generator) for _ in range(spec_cfg.max_depth + 1)]


def draw_seed(generator) -> int:
    """A kernel seed in [0, 2^31 - 1) from a torch.Generator."""
    return int(torch.randint(0, 2**31 - 1, (1,), generator=generator))


def _kernel(scene, homogeneous, grid):
    """The entry's kernel wrapper for the scene's medium."""
    return homogeneous if mapi.is_homogeneous(scene.medium) else grid


def _kernel_args(scene, cfg):
    kw = dict(vol_vol_samples=cfg.vol_vol_samples,
              vol_surf_samples=cfg.vol_surf_samples,
              short_vrls=cfg.short_vrls,
              phase_kind=scene.medium.phase_kind)
    if not mapi.is_homogeneous(scene.medium):
        kw["uv_steps"] = cfg.uv_tau_steps
    return kw


def _render(sum_fn, scene, vrls, generator, cfg, uniforms, jitter,
            materials=None):
    px, py, hit, packs = pack_frame(scene, vrls, jitter, materials)
    sums = sum_fn(*packs, seed=draw_seed(generator), uniforms=uniforms,
                  **_kernel_args(scene, cfg), **_mat_kw(materials))
    return develop_sums(scene, vrls, px, py, hit, sums)


def build_R_kernel(scene: Scene, ray_o, ray_d, vrls: VRLs, seed: int,
                   cfg: VRLConfig = VRLConfig(), *, uniforms=None):
    """The transfer matrix over the representative eye rays (ray_o,
    ray_d) (P, 3) through ops.vrl_r (vrl_r_hetero in a grid medium): per
    (ray, VRL) pair the luminance mean and variance of the mean, (P, N)
    each, normalised by the particle count and its square
    (getVRLContributions). Counterpart of alvrl_tpu's build_R_pallas;
    `uniforms` (P, N, 2 * vol_vol + vol_surf) replaces the Philox stream
    of `seed`. A glossy or layered table takes kernel 5's material
    instantiation, in a grid medium kernel 6's material form."""
    materials = _route_materials(scene, "the transfer matrix R")
    _, packs = pack_rays_vrls(scene, ray_o, ray_d, vrls, materials)
    out = _kernel(scene, vrl_r, vrl_r_hetero)(
        *packs, seed=seed, uniforms=uniforms, **_kernel_args(scene, cfg),
        **_mat_kw(materials))
    norm = 1.0 / torch.clamp(vrls.particle_count, min=1.0)
    return out[0] * norm, out[1] * (norm * norm)


def render_clustered_kernel(scene: Scene, vrls: VRLs, slice_of_pixel,
                            table_ids, table_weights, generator,
                            cfg: VRLConfig = VRLConfig(), *, fallback=None,
                            uniforms=None):
    """Full-frame clustered render through ops.vrl_sum_clustered
    (vrl_sum_hetero_clustered in a grid medium): pixel i (row-major)
    integrates against row slice_of_pixel[i] of the tables (S, C) (VRL
    ids int32, weights float32, on the scene's device); counterpart of
    alvrl_tpu's render_clustered_pallas[_hetero].

    slice_of_pixel (W * H,) integer rows, read on the host, where the
    kernel's wrapper groups the pixels by row. Pixels at row -1 render
    0, or, with fallback = (ids (Cf,) int32, weights (Cf,) float32) on
    the scene's device, through a second launch of the same kernel
    against that one-row table, with the same seed: each pixel's pairs
    are drawn in one launch only. The seed is drawn from `generator`;
    `uniforms` (W * H, C, 2 * vol_vol + vol_surf) replaces the main
    launch's random stream. A glossy or layered table takes kernel 2's
    material instantiation, in a grid medium kernel 4's material form.
    Returns the (H, W, 3) image."""
    materials = _route_materials(scene, "the clustered render")
    return _render_clustered(
        _kernel(scene, vrl_sum_clustered, vrl_sum_hetero_clustered), scene,
        vrls, slice_of_pixel, table_ids, table_weights, generator, cfg,
        fallback, uniforms, materials)


def render_clustered_kernel_diff(scene: Scene, vrls: VRLs, slice_of_pixel,
                                 table_ids, table_weights, generator,
                                 cfg: VRLConfig = VRLConfig(), *,
                                 fallback=None, uniforms=None):
    """render_clustered_kernel, differentiable through the clustered
    seed-replay VJP (ops.vrl_sum_clustered_bwd.vrl_sum_clustered_diff,
    vrl_sum_hetero_clustered_diff in a grid medium), the fall-back launch
    included: in what render_with_vrls_kernel_diff is differentiable in,
    and in the table weights (and the fall-back weights). The table ids
    and the pixels' rows are fixed (the host clustering's output), and
    geometry is detached. The composition of the reference's
    vrl_sum_clustered_diff with render_clustered_pallas's table build
    (tests/test_pallas_bwd.py:220-235, 277-293); as there, no CP factors
    and no density multiplier (ROADMAP C9, C10). Every scene of
    render_clustered_kernel but an oriented medium: a glossy or layered
    table, a mixture phase or another strategy than balance, a grid
    medium of fast_tau False (the forms of kernels 10 and 11)."""
    materials = _route_materials(scene, "the differentiable clustered "
                                 "render (kernels 10 and 11)",
                                 textured=False)
    return _render_clustered(
        _kernel(scene, vrl_sum_clustered_diff, vrl_sum_hetero_clustered_diff),
        scene, vrls, slice_of_pixel, table_ids, table_weights, generator, cfg,
        fallback, uniforms, materials)


def _render_clustered(clustered, scene, vrls, slice_of_pixel, table_ids,
                      table_weights, generator, cfg, fallback, uniforms,
                      materials=None):
    px, py, hit, packs = pack_frame(scene, vrls, materials=materials)
    kw = dict(seed=draw_seed(generator), **_kernel_args(scene, cfg),
              **_mat_kw(materials))
    sums = clustered(*packs, slice_of_pixel, table_ids, table_weights,
                     uniforms=uniforms, **kw)
    fb_pixels = np.asarray(torch.as_tensor(slice_of_pixel).cpu()) < 0
    if fallback is not None and fb_pixels.any():
        fb_ids, fb_weights = fallback
        sums = sums + clustered(
            *packs, np.where(fb_pixels, 0, -1), fb_ids[None].contiguous(),
            fb_weights[None].contiguous(), **kw)
    return develop_sums(scene, vrls, px, py, hit, sums)


def develop_sums(scene: Scene, vrls: VRLs, px, py, hit, sums):
    """(3, B) per-ray VRL sums -> the (H, W, 3) image: normalised by the
    particle count, zero for eye rays that hit nothing (the reference
    drops rays escaping to infinity), box-filtered onto the film."""
    li = sums.T / torch.clamp(vrls.particle_count, min=1.0)
    li = torch.where(hit.valid[..., None], li, 0.0)
    img, wgt = film_mod.splat_box(scene.camera.width, scene.camera.height,
                                  px, py, li)
    return film_mod.develop(img, wgt)
