"""VRL generation by volumetric photon tracing, differentiable.

Counterpart of alvrl_tpu/integrators/vrl/tracer.py (trace, _trace_one)
for the point, spot, directional, area, constant, environment-map and
collimated emitters, diffuse, null, mirror and dielectric surfaces and a
homogeneous or grid medium with an HG or Rayleigh phase (a homogeneous
medium also with a mixture of them and any sampling strategy). All particles
advance in lockstep, as tensors with a leading particle axis, through a
Python loop over bounce depth; each (particle, depth) slot holds at most
one VRL, so the buffer has num_particles * max_depth slots,
particle-major.

Per step, as traceOneParticle (vrlTracer.h:91-230): a free-flight
sample against the closest surface; a medium event multiplies the
throughput by tau sigma_s / pdfSuccess and a phase sample and starts a
new VRL at the scatter point; a surface event multiplies it by
tau / pdfFailure and a BSDF sample in importance mode (a dielectric's
refraction without the 1/eta^2 of radiance transport) and starts one at
the surface, and multiplies the particle's relative IOR eta by the
sampled lobe's ratio; past rr_depth, Russian roulette with
q = min(max(throughput) * eta^2, 0.95). In a grid medium the free
flight is Woodcock tracking (media.heterogeneous.sample_distance) or,
with sampling = 1, the inversion of the cumulative-OD table
(sample_distance_quadrature) from the first distance uniform, which in a
grid medium only such a medium reads; both over the grid of the
quadratures computed once per call (media.heterogeneous.quad_grid). An
oriented medium (Kajiya-Kay, micro-flake) is refused: as in the JAX
package, whose tracer samples the phase without an orientation, only
volpath renders it.

Gradients follow the reference's detached-sampling contract: sampled
positions and directions are detached, the free-flight pdf denominators
too (media/api.py), and with score_phase an HG phase sample carries the
factor phase / detach(phase), 1 in value, whose derivative is the score
term d/dg log phase. The throughput factors and the emitted power carry
all the dependence on sigma_a, sigma_s, g and the intensity.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from alvrl_tpu_torch.bsdf import api as bsdf_api
from alvrl_tpu_torch.core import math as m
from alvrl_tpu_torch.emitters import emitters as em_mod
from alvrl_tpu_torch.geometry import intersect
from alvrl_tpu_torch.integrators.vrl.vrl import VRLs
from alvrl_tpu_torch.media import api as mapi
from alvrl_tpu_torch.media import heterogeneous as gmed
from alvrl_tpu_torch.media import phase as ph
from alvrl_tpu_torch.scene.scene import Scene
from alvrl_tpu_torch.textures.procedural import interp_uv

N_EMIT_DIMS = em_mod.N_EMIT_DIMS  # one emission's uniforms (emitters)
# the emission columns drawn first, before the walk's uniforms; the
# others (the position and the area light's second barycentric) are
# drawn after them, and only where a kind of the table reads them, so
# that a scene of point, spot and collimated lights keeps its stream
N_EMIT_FIRST = 3
# uniforms of one step, in the reference's key order: distance (2),
# phase (2), BSDF (N_SAMPLE_DIMS), roulette (1)
U_DIST, U_PHASE, U_BSDF = slice(0, 2), slice(2, 4), slice(4, 9)
U_RR = 9
N_STEP_DIMS = 10
SURFACE_MISS = 1e30  # free-flight segment length of a ray that hits nothing


@dataclass(frozen=True)
class TracerConfig:
    max_depth: int = 16
    rr_depth: int = 5
    short_vrls: bool = True   # VRLs end at the scatter point, else at the
                              # next surface
    score_phase: bool = True  # the HG score surrogate (module docstring)


def trace(scene: Scene, generator, num_particles: int,
          cfg: TracerConfig = TracerConfig()) -> VRLs:
    """Trace num_particles light paths with uniforms drawn from
    `generator` (a torch.Generator), in this order: u_emit's first
    N_EMIT_FIRST columns (the emitter choice and the direction), u_walk,
    in a grid medium u_track, then u_emit's other columns where a kind
    of the emitter table reads them (emitters.POSITION_KINDS; zeros
    otherwise, and nothing more is drawn); see trace_u."""
    def rand(*shape):
        return torch.rand(shape, generator=generator, device=generator.device)

    u_emit = rand(num_particles, N_EMIT_FIRST)
    u_walk = rand(num_particles, cfg.max_depth, N_STEP_DIMS)
    u_track = None
    if mapi.tracks(scene.medium):
        u_track = rand(num_particles, cfg.max_depth, gmed.TRACKING_DRAWS,
                       2).to(scene.device)
    rest = (num_particles, N_EMIT_DIMS - N_EMIT_FIRST)
    u_emit = torch.cat([u_emit, rand(*rest) if em_mod.POSITION_KINDS
                        & set(scene.emitters.host_kinds)
                        else torch.zeros(rest, device=u_emit.device)], dim=1)
    return trace_u(scene, u_emit.to(scene.device), u_walk.to(scene.device),
                   cfg, u_track)


def trace_u(scene: Scene, u_emit, u_walk,
            cfg: TracerConfig = TracerConfig(), u_track=None) -> VRLs:
    """The walk of trace as a function of its uniforms: u_emit
    (P, N_EMIT_DIMS), u_walk (P, max_depth, N_STEP_DIMS) and, in a grid
    medium of Woodcock tracking, the tracking uniforms u_track (P,
    max_depth, TRACKING_DRAWS, 2), which replace u_walk's distance
    uniforms (a grid medium of sampling 1 reads u_walk's first).
    Returns a VRL buffer of P * max_depth slots, particle-major.

    u_emit's columns (emitters.N_EMIT_DIMS, as emitters.sample_emission_u
    reads them): 0 the emitter choice, 1-2 the direction (uniform
    sphere, spot cone, cosine lobe of an area or constant light), 3-4
    the position (a directional light's disk, a point on an area light's
    triangle, a constant light's sphere), 5 the area light's second
    barycentric. u_walk's, per step: 0-1 the free-flight distance, 2-3
    the phase sample, 4-8 the BSDF sample (bsdf.api.N_SAMPLE_DIMS), 9
    the roulette."""
    n_particles = u_emit.shape[0]
    if tuple(u_emit.shape) != (n_particles, N_EMIT_DIMS):
        raise ValueError(f"u_emit must be ({n_particles}, {N_EMIT_DIMS}), "
                         f"got {tuple(u_emit.shape)}")
    if tuple(u_walk.shape) != (n_particles, cfg.max_depth, N_STEP_DIMS):
        raise ValueError(f"u_walk must be ({n_particles}, {cfg.max_depth}, "
                         f"{N_STEP_DIMS}), got {tuple(u_walk.shape)}")
    kinds = bsdf_api.check_kinds(scene)  # once, not per bounce
    med = scene.medium
    refuse_oriented(med, "the VRL tracer")
    density_ss = None
    if not mapi.is_homogeneous(med):
        shape = (n_particles, cfg.max_depth, gmed.TRACKING_DRAWS, 2)
        if mapi.tracks(med) and (u_track is None
                               or tuple(u_track.shape) != shape):
            got = None if u_track is None else tuple(u_track.shape)
            raise ValueError(f"a grid medium of Woodcock tracking needs "
                             f"u_track {shape}, got {got}")
        density_ss = gmed.quad_grid(med)
    lo, hi = scene.aabb()
    pos, d, weight = em_mod.sample_emission_u(
        scene.emitters, u_emit, 0.5 * (lo + hi), 0.5 * m.length(hi - lo))
    state = dict(
        ray_o=pos, ray_d=d, cur_start=pos,
        cur_power=weight,             # beta of the VRL being built
        beta=weight,                  # throughput times emitted power
        tp=torch.ones_like(weight),   # unitless throughput, for roulette
        eta=torch.ones_like(weight[:, 0]),  # relative IOR, for roulette
        active=~(weight == 0.0).all(dim=-1),
    )
    slots = []
    for depth in range(1, cfg.max_depth + 1):
        track = None if u_track is None else u_track[:, depth - 1]
        state, out = _step(scene, med, state, u_walk[:, depth - 1], depth,
                           cfg, track, density_ss, kinds)
        slots.append(out)

    def flat(k):
        a = torch.stack([s[k] for s in slots], dim=1)
        return a.reshape((-1,) + a.shape[2:])

    return VRLs(start=flat("start"), end=flat("end"), power=flat("power"),
                valid=flat("valid"),
                particle_count=torch.tensor(float(n_particles),
                                            device=scene.device))


def refuse_oriented(med, route: str):
    """Raise, naming `route`, on an oriented phase kind (Kajiya-Kay,
    micro-flake): the JAX package's VRL tracer and pair contribution
    evaluate the phase without an orientation and cannot render such a
    medium; only volpath does."""
    if med.phase_kind in (ph.KKAY, ph.MICROFLAKE):
        raise ValueError(f"{route} cannot render an oriented medium "
                         "(Kajiya-Kay, micro-flake): only volpath renders it, "
                         "as in the JAX package")


def _step(scene, med, state, u, depth, cfg, u_track, density_ss, kinds):
    """One bounce of every particle; returns (next state, this slot)."""
    ray_o, ray_d, active = state["ray_o"], state["ray_d"], state["active"]
    hit = intersect.intersect_all(ray_o, ray_d, scene.vertices, scene.faces)
    # misses' points moved to the origin, so that masked lanes stay finite
    hit_p = torch.where(hit.valid[..., None], hit.p, ray_o)
    dist_surf = torch.where(hit.valid, hit.t, SURFACE_MISS)
    ms = mapi.sample_distance_seg_u(med, u[:, U_DIST], ray_o, ray_d,
                                    dist_surf, u_track=u_track,
                                    density_ss=density_ss, active=active)
    medium_event = ms.success & active
    surface_event = ~ms.success & hit.valid & active

    # medium scattering; the no-interaction sentinel point is replaced
    # by the origin (0 * inf poisons reverse mode through masked math)
    p_scatter = torch.where(medium_event[..., None], ms.p, ray_o)
    pp = getattr(med, "phase_params", None)
    wo_phase, w_phase, _ = ph.sample_phase(med.phase_kind, med.g, -ray_d,
                                           u[:, U_PHASE], pp=pp)
    wo_phase = wo_phase.detach()
    if cfg.score_phase and med.phase_kind == ph.HG:
        ph_val = ph.eval_phase(med.phase_kind, med.g, -ray_d, wo_phase)
        w_phase = w_phase * ph_val / torch.clamp(ph_val, min=1e-30).detach()
    beta_med = state["beta"] * ms.w_scatter * w_phase[..., None]
    tp_med = state["tp"] * ms.w_scatter * w_phase[..., None]
    if cfg.short_vrls:
        endpoint, med_store_ok = p_scatter, torch.ones_like(active)
    else:  # long VRLs run on to the next surface; none on a miss
        endpoint, med_store_ok = hit_p, hit.valid

    # surface scattering; a textured table's sample takes the hit's
    # Shading at its point and UV
    mat_id = scene.material[hit.prim.clamp(min=0)]
    tex = {}
    if scene.textured():
        tex["shade"] = bsdf_api.shading(scene, mat_id, hit.ng, hit_p,
                                        interp_uv(scene.face_uv, hit.prim,
                                                  hit.uv))
    bs = bsdf_api.sample_from_uniforms(scene, u[:, U_BSDF], mat_id, hit.ng,
                                       hit.ng_raw, ray_d, "importance", kinds,
                                       **tex)
    beta_surf = state["beta"] * ms.w_pass * bs.weight
    tp_surf = state["tp"] * ms.w_pass * bs.weight
    bsdf_dead = surface_event & (~bs.valid | (bs.weight == 0.0).all(dim=-1))

    # the VRL that ends at this event
    store_end = torch.where(medium_event[..., None], endpoint, hit_p)
    store = (((medium_event & med_store_ok) | surface_event)
             & (m.distance(state["cur_start"], store_end) > 0.0)
             & ~(state["cur_power"] == 0.0).all(dim=-1))
    out = dict(start=state["cur_start"], end=store_end,
               power=state["cur_power"], valid=store)

    new_o = torch.where(medium_event[..., None], p_scatter, hit_p).detach()
    new_d = torch.where(medium_event[..., None], wo_phase, bs.wo).detach()
    new_beta = torch.where(medium_event[..., None], beta_med, beta_surf)
    new_tp = torch.where(medium_event[..., None], tp_med, tp_surf)
    survive = (medium_event & med_store_ok) | (surface_event & ~bsdf_dead)

    new_eta = torch.where(surface_event, state["eta"] * bs.eta_ratio,
                          state["eta"])
    # Russian roulette (vrlTracer.h:218-228)
    q = torch.clamp(new_tp.amax(dim=-1) * new_eta ** 2, max=0.95).detach()
    if depth >= cfg.rr_depth:
        rr_kill = u[:, U_RR] >= q
        rr_scale = torch.where(rr_kill, 1.0, 1.0 / torch.clamp(q, min=1e-30))
        survive = survive & ~rr_kill
    else:
        rr_scale = torch.ones_like(q)
    rr_scale = rr_scale[..., None]
    new_state = dict(ray_o=new_o, ray_d=new_d, cur_start=new_o,
                     cur_power=new_beta * rr_scale,
                     beta=new_beta * rr_scale, tp=new_tp * rr_scale,
                     eta=new_eta, active=survive)
    # lanes that were inactive keep their state
    new_state = {k: torch.where(active if v.dim() == 1 else active[..., None],
                                v, state[k])
                 for k, v in new_state.items()}
    return new_state, out
