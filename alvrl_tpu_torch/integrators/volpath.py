"""Volumetric path tracer and the VRL ground-truth oracle.

Counterpart of alvrl_tpu/integrators/volpath.py (the branch-modified
`volpath` plugin, volpath.cpp:76-460). With only_vrl_paths it is the
reference's check of the VRL estimator: a volumetric path tracer held to
exactly the path family the VRL integrator produces, so an
equal-transport A/B against the VRL render tests it. Without it, a
volumetric path tracer with next-event estimation and (mis) multiple
importance sampling between the emitters' direct sampling and BSDF or
phase sampling.

The gates are the reference's as coded, including the precedence quirk
`!rRec.depth==2` (volpath.cpp:144-190), which makes the "previous vertex
must be volume or diffuse" gate hold at every depth >= 2.

All lanes advance in lockstep, as tensors with a leading ray axis,
through a Python loop of max_depth steps (plus null_crossings in a scene
of per-shape media, whose null faces cross without a depth); a lane that
stops keeps its state. Each step reads N_STEP_DIMS uniforms a lane, in
the reference's key order: the free-flight distance (2), the direct
sample (3: the emitter, then 2D), the phase sample (2), the BSDF sample
(bsdf.api.N_SAMPLE_DIMS) and the roulette (1); a grid medium reads its
Woodcock tracking uniforms from u_track instead of the distance's two (of
sampling 1, the first distance uniform, and no u_track). An oriented
grid medium (Kajiya-Kay, micro-flake) looks up the fiber orientation at
each medium vertex for its phase function, and a micro-flake medium's
phase sample reads its (16, 3) candidates' uniforms from u_sir.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from alvrl_tpu_torch.bsdf import api as bsdf_api
from alvrl_tpu_torch.core import math as m
from alvrl_tpu_torch.emitters import emitters as em_mod
from alvrl_tpu_torch.film import film as film_mod
from alvrl_tpu_torch.geometry import intersect
from alvrl_tpu_torch.integrators.vrl import integrator
from alvrl_tpu_torch.integrators.vrl.integrate import (
    eval_transmittance_between,
)
from alvrl_tpu_torch.media import api as mapi
from alvrl_tpu_torch.media import heterogeneous as gmed
from alvrl_tpu_torch.media import phase as ph
from alvrl_tpu_torch.media import table as mtbl
from alvrl_tpu_torch.scene.scene import NULL, Scene
from alvrl_tpu_torch.textures.procedural import interp_uv

U_DIST, U_NEE, U_PHASE = slice(0, 2), slice(2, 5), slice(5, 7)
U_BSDF = slice(7, 7 + bsdf_api.N_SAMPLE_DIMS)
U_RR = 7 + bsdf_api.N_SAMPLE_DIMS
N_STEP_DIMS = U_RR + 1
SURFACE_MISS = 1e30  # free-flight length of a ray that hits nothing
# render_volpath's share of the device's free memory, and its budget on
# the CPU, for one tile of rays
CUDA_MEMORY_SHARE = 0.25
CPU_TILE_BYTES = 1 << 28


@dataclass(frozen=True)
class VolpathConfig:
    max_depth: int = 16
    rr_depth: int = 5
    only_vrl_paths: bool = True   # the VRL oracle's path family
    vrl_vol_to_vol: bool = True
    vrl_vol_to_surf: bool = True
    single_scatter: bool = False
    # extra steps for null-boundary crossings (which take no depth) in a
    # scene of per-shape media
    null_crossings: int = 8
    # MIS between direct sampling and BSDF / phase sampling; the plain
    # tracer's only (the oracle keeps its single-strategy gates)
    mis: bool = True
    # count directly visible (depth-1) emission
    first_emission: bool = True


def n_steps(scene: Scene, cfg: VolpathConfig) -> int:
    """The steps of a walk: max_depth, plus null_crossings with
    per-shape media."""
    return cfg.max_depth + (cfg.null_crossings if scene.media is not None
                            else 0)


def _nee(scene, u3, p, radius, env_center, blockers, density_ss, med_id):
    """Direct sampling from the points p: (direction, attenuated value,
    solid-angle pdf, misable), the transmittance through per-shape media
    (from media med_id) or the global medium, 0 where blocked;
    env_center as li_volpath_u's."""
    dirn, val, dist, pdf, misable = em_mod.nee_u_pdf(
        scene.emitters, u3, p, radius, env_center)
    end = p + dist[..., None] * dirn
    if scene.media is not None:
        tau = mtbl.eval_transmittance_nested(scene, p, end, med_id)
    else:
        tau = eval_transmittance_between(scene, p, end, density_ss, blockers)
    return dirn, val * tau, pdf, misable


def needs_sir(scene: Scene) -> bool:
    """Whether the walk reads micro-flake SIR uniforms: an oriented
    micro-flake grid medium."""
    return gmed.oriented(scene.medium) \
        and scene.medium.phase_kind == ph.MICROFLAKE


def li_volpath_u(scene: Scene, ray_o, ray_d, u, cfg: VolpathConfig =
                 VolpathConfig(), u_track=None, density_ss=None,
                 env_center=None, u_sir=None):
    """(B, 3) radiance of the rays (ray_o, ray_d) (B, 3) from the
    uniforms u (B, n_steps, N_STEP_DIMS) (the module's layout), in a
    grid medium of Woodcock tracking the uniforms u_track (B, n_steps,
    TRACKING_DRAWS, 2), and in an oriented micro-flake medium the SIR
    uniforms u_sir (B, n_steps, ph.SIR_CANDIDATES, 3); a grid medium's
    quadratures read density_ss (media.heterogeneous.quad_grid, made here
    when not given). Scenes with per-shape media track each lane's
    medium id; each surface event switches it to the side its new
    direction enters.

    The environment map's direct segments end at 2.5 R, as the
    reference's. Given the scene's bounding-sphere centre `env_center`
    (3,), they end on the VRL tracer's emission disk instead (1.5 R from
    it along the direction), and points outside the disk's cylinder get
    no map light: the equal-transport A/B's oracle, which must see the
    light the tracer emits in a medium that fills the scene (ROADMAP
    C17)."""
    steps = n_steps(scene, cfg)
    n = ray_o.shape[0]
    if tuple(u.shape) != (n, steps, N_STEP_DIMS):
        raise ValueError(f"u must be ({n}, {steps}, {N_STEP_DIMS}), got "
                         f"{tuple(u.shape)}")
    nested = scene.media is not None
    homog = mapi.is_homogeneous(scene.medium)
    if not homog:
        if nested:
            raise ValueError("per-shape media take a homogeneous global "
                             "medium")
        if mapi.tracks(scene.medium):
            _need(u_track, "u_track", (n, steps, gmed.TRACKING_DRAWS, 2),
                  "a grid medium of Woodcock tracking")
        if density_ss is None:
            density_ss = gmed.quad_grid(scene.medium)
    oriented = gmed.oriented(scene.medium)
    if scene.medium.phase_kind in (ph.KKAY, ph.MICROFLAKE) and not oriented:
        raise ValueError("an oriented phase kind (Kajiya-Kay, micro-flake) "
                         "needs a grid medium with an orientation volume")
    if needs_sir(scene):
        _need(u_sir, "u_sir", (n, steps, ph.SIR_CANDIDATES, 3),
              "an oriented micro-flake medium")
    use_mis = cfg.mis and not cfg.only_vrl_paths
    kinds = bsdf_api.check_kinds(scene)
    textured = scene.textured()
    mats, em = scene.materials, scene.emitters
    lo, hi = scene.aabb()
    radius = 0.5 * m.length(hi - lo)
    blockers = scene.faces[scene.opaque_faces()]
    face_emitter = scene.face_emitters()
    dev = ray_o.device
    false = torch.zeros((n,), dtype=torch.bool, device=dev)
    gate0 = torch.full((n,), not cfg.only_vrl_paths, device=dev)
    st = dict(ray_o=ray_o, ray_d=ray_d,
              tp=torch.ones((n, 3), device=dev),
              depth=torch.ones((n,), dtype=torch.int64, device=dev),
              eta=torch.ones((n,), device=dev),
              active=~false, first_ok=gate0, second_ok=gate0.clone(),
              prev_volume=false, prev_diffuse=false,
              med_id=torch.zeros((n,), dtype=torch.int64, device=dev),
              prev_pdf=torch.zeros((n,), device=dev),
              prev_delta=~false)
    li = torch.zeros((n, 3), device=dev)

    for k in range(steps):
        uk = u[:, k]
        depth, tp, rd = st["depth"], st["tp"], st["ray_d"]
        first_ok, second_ok = st["first_ok"], st["second_ok"]
        active = st["active"] & (depth <= cfg.max_depth)
        med = (mtbl.medium_at(scene.media, st["med_id"]) if nested
               else scene.medium)
        if cfg.only_vrl_paths:  # the early exit (volpath.cpp:148-149)
            active = active & ~((depth > 2) & ~(first_ok & second_ok))
        hit = intersect.intersect_all(st["ray_o"], rd, scene.vertices,
                                      scene.faces)
        hit_p = torch.where(hit.valid[..., None], hit.p, st["ray_o"])
        prim = hit.prim.clamp(min=0)
        dist_surf = torch.where(hit.valid, hit.t, SURFACE_MISS)
        ms = mapi.sample_distance_seg_u(
            med, uk[:, U_DIST], st["ray_o"], rd, dist_surf,
            u_track=None if u_track is None else u_track[:, k],
            density_ss=density_ss, active=active)
        medium_event = ms.success & active
        surface_event = ~ms.success & hit.valid & active
        escape = ~ms.success & ~hit.valid & active

        # the environment on escape (volpath.cpp:277-289)
        env_gate = escape & (depth == 1)
        w_env = 1.0
        if cfg.only_vrl_paths:
            env_gate = escape & first_ok & second_ok
        elif use_mis:
            env_gate = escape
            p_env = em_mod.env_nee_pdf(em, rd)
            w_env = torch.where(
                st["prev_delta"] | (depth == 1), 1.0,
                st["prev_pdf"] / torch.clamp(st["prev_pdf"] + p_env,
                                             min=1e-30))[..., None]
        if not cfg.first_emission:
            env_gate = env_gate & (depth != 1)
        li_env = torch.where(env_gate[..., None], tp * ms.w_pass
                             * em_mod.env_radiance(em, rd) * w_env, 0.0)

        # the medium vertex: direct sampling, then the phase sample
        p_med = torch.where(medium_event[..., None], ms.p, st["ray_o"])
        first_ok_med = first_ok | ((depth == 1) & cfg.vrl_vol_to_vol)
        second_ok_med = second_ok | (depth == 2)
        tp_med = tp * ms.w_scatter
        u_nee = uk[:, U_NEE]
        nee_dir, nee_val, p_nee_m, misable_m = _nee(
            scene, u_nee, p_med, radius, env_center, blockers, density_ss,
            st["med_id"])
        pp = getattr(med, "phase_params", None)
        orient = (gmed.lookup_orientation(med, p_med) if oriented
                  else None)
        phase_val = ph.eval_phase(med.phase_kind, med.g, -rd, nee_dir,
                                  orientation=orient, pp=pp)
        if use_mis:
            p_dir_m = ph.pdf_phase(med.phase_kind, med.g, -rd, nee_dir,
                                   orientation=orient, pp=pp)
            w_nee_m = torch.where(misable_m, p_nee_m / torch.clamp(
                p_nee_m + p_dir_m, min=1e-30), 1.0)
        else:
            w_nee_m = 1.0
        nee_contrib = tp_med * nee_val * (phase_val * w_nee_m)[..., None]
        if cfg.only_vrl_paths:
            pv, pd = st["prev_volume"], st["prev_diffuse"]
            prev_gate = ((pv | pd) & (~pd | cfg.vrl_vol_to_surf)
                         & (~pv | cfg.vrl_vol_to_vol))
            nee_ok_med = (depth != 1) & prev_gate
        else:
            nee_ok_med = ~false
        if cfg.single_scatter:
            nee_ok_med = nee_ok_med & (depth == 1)
        li_med = torch.where((medium_event & nee_ok_med)[..., None],
                             nee_contrib, 0.0)
        wo_phase, w_phase, pdf_phase_s = ph.sample_phase(
            med.phase_kind, med.g, -rd, uk[:, U_PHASE], orientation=orient,
            pp=pp, u_sir=None if u_sir is None else u_sir[:, k])
        tp_med_cont = tp_med * w_phase[..., None]
        med_continue = medium_event & (not cfg.single_scatter)

        # the surface vertex: emission, direct sampling, the BSDF sample
        tp_surf_pre = tp * ms.w_pass
        mat_id = scene.material[prim]
        emit_id = face_emitter[prim]
        front = m.dot(hit.ng_raw, -rd) > 0
        le_gate = surface_event & (emit_id >= 0) & front & (depth == 1)
        w_hit = 1.0
        if cfg.only_vrl_paths:
            le_gate = le_gate & first_ok & second_ok
        elif use_mis:
            le_gate = surface_event & (emit_id >= 0) & front
            cos_face = torch.clamp(m.dot(hit.ng_raw, -rd), min=1e-6)
            p_nee_hit = em_mod.hit_emitter_nee_pdf(em, emit_id, hit.t,
                                                   cos_face)
            w_hit = torch.where(
                st["prev_delta"] | (depth == 1), 1.0,
                st["prev_pdf"] / torch.clamp(st["prev_pdf"] + p_nee_hit,
                                             min=1e-30))[..., None]
        if not cfg.first_emission:
            le_gate = le_gate & (depth != 1)
        li_emit = torch.where(le_gate[..., None], tp_surf_pre * em.intensity[
            emit_id.clamp(min=0)] * w_hit, 0.0)

        med_surf = None
        if nested:  # the direct segment leaves on the light's side
            probe_dir, _, _ = em_mod.nee_u(em, u_nee, hit_p, radius)
            med_surf = mtbl.medium_after_surface(scene, prim, probe_dir)
        nee_dir_s, nee_val_s, p_nee_s, misable_s = _nee(
            scene, u_nee, hit_p, radius, env_center, blockers, density_ss,
            med_surf)
        # a textured table's surface at the hit's point and UV
        shade = bsdf_api.shading(scene, mat_id, hit.ng, hit_p, interp_uv(
            scene.face_uv, hit.prim, hit.uv)) if textured else None
        bsdf_val = bsdf_api.eval_smooth(mats, mat_id, hit.ng, -rd, nee_dir_s,
                                        kinds, shade)
        if use_mis:
            p_dir_s = bsdf_api.pdf_smooth(mats, mat_id, hit.ng, -rd,
                                          nee_dir_s, kinds, shade)
            w_nee_s = torch.where(misable_s, p_nee_s / torch.clamp(
                p_nee_s + p_dir_s, min=1e-30), 1.0)
            bsdf_val = bsdf_val * w_nee_s[..., None]
        smp = bsdf_api.sample_from_uniforms(scene, uk[:, U_BSDF], mat_id,
                                            hit.ng, hit.ng_raw, rd,
                                            mode="radiance", kinds=kinds,
                                            shade=shade)
        nee_ok_surf = smp.is_smooth
        if cfg.only_vrl_paths:
            nee_ok_surf = nee_ok_surf & first_ok & second_ok
        li_surf = torch.where((surface_event & nee_ok_surf)[..., None],
                              tp_surf_pre * nee_val_s * bsdf_val, 0.0)
        tp_surf_cont = tp_surf_pre * smp.weight
        surf_continue = (surface_event & smp.valid
                         & ~(smp.weight == 0.0).all(dim=-1))
        first_ok_surf = first_ok | (cfg.vrl_vol_to_surf & (depth == 1)
                                    & smp.is_smooth)

        # merge
        li = li + li_med + li_surf + li_emit + li_env
        sel = medium_event[..., None]
        new_o = torch.where(sel, p_med, hit_p)
        new_d = torch.where(sel, wo_phase, smp.wo)
        new_tp = torch.where(sel, tp_med_cont, tp_surf_cont)
        survive = (med_continue | surf_continue) & ~escape
        new_first = torch.where(medium_event, first_ok_med,
                                torch.where(surface_event, first_ok_surf,
                                            first_ok))
        new_eta = torch.where(surface_event & smp.is_delta,
                              st["eta"] * smp.eta_ratio, st["eta"])
        # an initial specular vertex does not take a depth
        # (volpath.cpp:377-380), nor does a null crossing
        is_null = mats.kind[mat_id] == NULL
        depth_inc = torch.where(
            surface_event & (is_null | (smp.is_delta & (depth == 1))), 0, 1)
        new_second = torch.where(medium_event, second_ok_med, second_ok)
        new_pv = torch.where(medium_event, True, torch.where(
            surface_event, False, st["prev_volume"]))
        new_pd = torch.where(surface_event, smp.is_smooth, torch.where(
            medium_event, False, st["prev_diffuse"]))

        # Russian roulette (volpath.cpp:443-452)
        q = torch.clamp(new_tp.amax(dim=-1) * new_eta * new_eta, max=0.95)
        do_rr = depth >= cfg.rr_depth
        rr_kill = do_rr & (uk[:, U_RR] >= q)
        rr_scale = torch.where(do_rr & ~rr_kill,
                               1.0 / torch.clamp(q, min=1e-30), 1.0)
        survive = survive & ~rr_kill

        new_med = st["med_id"]
        if nested:
            new_med = torch.where(surface_event, mtbl.medium_after_surface(
                scene, prim, new_d), st["med_id"])
        new_pdf, new_delta = st["prev_pdf"], st["prev_delta"]
        if use_mis:
            p_fwd_s = bsdf_api.pdf_smooth(mats, mat_id, hit.ng, -rd, smp.wo,
                                          kinds, shade)
            new_pdf = torch.where(medium_event, pdf_phase_s, torch.where(
                surface_event, p_fwd_s, st["prev_pdf"]))
            new_delta = torch.where(medium_event, False, torch.where(
                surface_event, smp.is_delta, st["prev_delta"]))
        new = dict(ray_o=new_o, ray_d=new_d, tp=new_tp * rr_scale[..., None],
                   depth=depth + depth_inc, eta=new_eta, active=survive,
                   first_ok=new_first, second_ok=new_second,
                   prev_volume=new_pv, prev_diffuse=new_pd, med_id=new_med,
                   prev_pdf=new_pdf, prev_delta=new_delta)
        # lanes that were not active keep their state
        st = {key: torch.where(active if v.dim() == 1 else active[..., None],
                               v, st[key]) for key, v in new.items()}

    if cfg.only_vrl_paths:
        li = torch.where((st["first_ok"] & st["second_ok"])[..., None], li,
                         0.0)
    return li


def _need(x, name, shape, what):
    if x is None or tuple(x.shape) != shape:
        got = None if x is None else tuple(x.shape)
        raise ValueError(f"{what} needs {name} {shape}, got {got}")


def tile_rays(scene: Scene, cfg: VolpathConfig) -> int:
    """The rays of one render_volpath tile: CUDA_MEMORY_SHARE of the
    device's free memory (CPU_TILE_BYTES on the CPU) over a ray's bytes,
    its uniforms and the largest temporaries of a step: the (ray, face)
    tables of the intersection and the shadow test (about 32 floats a
    face) and some 2,048 floats of per-ray state and temporaries."""
    steps = n_steps(scene, cfg)
    floats = (steps * N_STEP_DIMS + 32 * scene.faces.shape[0] + 2048)
    if mapi.tracks(scene.medium):
        floats += steps * gmed.TRACKING_DRAWS * 2
    if needs_sir(scene):
        floats += steps * ph.SIR_CANDIDATES * 3
    if scene.device.type == "cuda":
        budget = CUDA_MEMORY_SHARE * torch.cuda.mem_get_info(scene.device)[0]
    else:
        budget = CPU_TILE_BYTES
    return max(1, int(budget // (4 * floats)))


def render_volpath(scene: Scene, generator, spp: int = 16,
                   cfg: VolpathConfig = VolpathConfig(), uniforms=None,
                   env_center=None):
    """(H, W, 3) image: spp samples a pixel through its centre (so that
    images compare pixel by pixel with the VRL render). Each sample's
    uniforms for all W * H rays are drawn from `generator` (a
    torch.Generator on the scene's device) in turn: u (W * H, n_steps,
    N_STEP_DIMS), then in a grid medium of Woodcock tracking u_track,
    then in an oriented micro-flake medium u_sir (so that every other
    scene draws what it did before); or taken from `uniforms`, (u (spp,
    W * H, n_steps, N_STEP_DIMS), u_track (spp, W * H, n_steps,
    TRACKING_DRAWS, 2) or None[, u_sir (spp, W * H, n_steps,
    SIR_CANDIDATES, 3)]). The spp * W * H rays,
    sample-major, go through li_volpath_u (env_center as there) in tiles
    of tile_rays; a ray's radiance does not depend on its tile, so the
    image is the same bit for bit whatever the free memory."""
    px, py, ray_o, ray_d = integrator.frame_rays(scene)
    n = ray_o.shape[0]
    steps = n_steps(scene, cfg)
    grid = not mapi.is_homogeneous(scene.medium)
    track, sir = mapi.tracks(scene.medium), needs_sir(scene)
    density_ss = gmed.quad_grid(scene.medium) if grid else None
    tile = tile_rays(scene, cfg)

    def draws(s):
        """Sample s's uniforms (u, u_track, u_sir) for all n rays; None
        for those the scene does not read."""
        if uniforms is not None:
            return (uniforms[0][s], uniforms[1][s] if track else None,
                    uniforms[2][s] if sir else None)

        def rand(*shape):
            return torch.rand(shape, generator=generator,
                              device=generator.device).to(scene.device)
        u = rand(n, steps, N_STEP_DIMS)
        u_track = rand(n, steps, gmed.TRACKING_DRAWS, 2) if track else None
        return u, u_track, (rand(n, steps, ph.SIR_CANDIDATES, 3) if sir
                            else None)

    def cat(parts):
        return None if parts[0] is None else torch.cat(parts)

    # each ray's radiance, then the mean over the samples (a fixed-order
    # reduction: the same image bit for bit from the same uniforms)
    li = torch.empty((spp * n, 3), device=scene.device)
    # a tile of whole samples, or of a part of one
    per = max(1, tile // n)
    for s0 in range(0, spp, per):
        s1 = min(spp, s0 + per)
        u_all, t_all, sir_all = (cat(list(parts)) for parts in zip(
            *[draws(s) for s in range(s0, s1)]))
        rays = (s1 - s0) * n
        for r0 in range(0, rays, tile):
            r1 = min(rays, r0 + tile)
            pix = torch.arange(r0, r1, device=scene.device) % n
            li[s0 * n + r0:s0 * n + r1] = li_volpath_u(
                scene, ray_o[pix], ray_d[pix], u_all[r0:r1], cfg,
                None if t_all is None else t_all[r0:r1], density_ss,
                env_center, None if sir_all is None else sir_all[r0:r1])
    img, wgt = film_mod.splat_box(scene.camera.width, scene.camera.height,
                                  px, py, li.reshape(spp, n, 3).mean(dim=0))
    return film_mod.develop(img, wgt)
