"""VRL integrator: per-pixel radiance as a sum of VRL x eye-ray integrals.

Counterpart of alvrl_tpu/integrators/vrl/integrator.py for the
unclustered render of the main path: every eye ray integrates against
every VRL, normalised by the traced-particle count; plain, or
differentiable through the seed-replay VJP.
"""

from __future__ import annotations

import torch

from alvrl_tpu_torch.film import film as film_mod
from alvrl_tpu_torch.geometry import intersect
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.integrators.vrl.vrl import VRLs
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops.vrl_sum import vrl_sum
from alvrl_tpu_torch.ops.vrl_sum_bwd import vrl_sum_diff
from alvrl_tpu_torch.scene.scene import Scene
from alvrl_tpu_torch.sensors import perspective


def trace_eye_rays(scene: Scene, ray_o, ray_d):
    """Closest hits with misses' points moved to the ray origin (so that
    masked arithmetic stays finite), and the hit material ids.
    Returns (hit, mat)."""
    hit = intersect.intersect_all(ray_o, ray_d, scene.vertices, scene.faces)
    hit = hit._replace(p=torch.where(hit.valid[..., None], hit.p, ray_o))
    return hit, scene.material[hit.prim.clamp(min=0)]


def pack_frame(scene: Scene, vrls: VRLs):
    """Eye rays through every pixel centre (row-major), their closest
    hits, and the packs of ops.vrl_sum.
    Returns (px, py, hit, (rays, vrls, tris, medium) packs)."""
    w, h = scene.camera.width, scene.camera.height
    px, py = torch.meshgrid(torch.arange(w, device=scene.device),
                            torch.arange(h, device=scene.device),
                            indexing="xy")
    px, py = px.reshape(-1), py.reshape(-1)
    ray_o, ray_d = perspective.sample_ray(scene.camera, px, py)
    hit, mat = trace_eye_rays(scene, ray_o, ray_d)
    packs = (pk.pack_rays(scene, ray_o, ray_d, hit, mat), pk.pack_vrls(vrls),
             pk.pack_tris(scene), pk.pack_medium(scene))
    return px, py, hit, packs


def render_with_vrls_kernel(scene: Scene, vrls: VRLs, generator,
                            cfg: VRLConfig = VRLConfig(), *, uniforms=None):
    """Full-frame unclustered render through ops.vrl_sum; counterpart of
    alvrl_tpu.integrators.vrl.integrator.render_with_vrls_pallas.

    The kernel's seed is drawn from `generator` (a torch.Generator on
    the CPU). `uniforms`, (W * H, N, 2 * vol_vol + vol_surf) float32 on
    the scene's device, replaces the random stream (for exact checks).
    Returns the (H, W, 3) image."""
    return _render(vrl_sum, scene, vrls, generator, cfg, uniforms)


def render_with_vrls_kernel_diff(scene: Scene, vrls: VRLs, generator,
                                 cfg: VRLConfig = VRLConfig(), *,
                                 uniforms=None):
    """render_with_vrls_kernel, differentiable through
    ops.vrl_sum_bwd.vrl_sum_diff (the seed-replay VJP) in the medium's
    sigma_a, sigma_s and g, the VRL powers, and the eye-to-surface
    transmittance; geometry is detached. Counterpart of
    render_with_vrls_pallas_diff."""
    return _render(vrl_sum_diff, scene, vrls, generator, cfg, uniforms)


def _render(sum_fn, scene, vrls, generator, cfg, uniforms):
    px, py, hit, packs = pack_frame(scene, vrls)
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
    sums = sum_fn(
        *packs, seed=seed, uniforms=uniforms,
        vol_vol_samples=cfg.vol_vol_samples,
        vol_surf_samples=cfg.vol_surf_samples,
        short_vrls=cfg.short_vrls,
        phase_kind=scene.medium.phase_kind,
    )
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
