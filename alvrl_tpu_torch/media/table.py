"""Per-shape media: a table of homogeneous media and the transmittance
across nested boundaries.

Counterpart of alvrl_tpu/media/table.py: the reference's per-shape
interior and exterior medium references and the null-interface
crossings of Scene::evalTransmittance (scene.cpp:619-679). Media live in
one struct-of-arrays table whose id 0 is the scene's default exterior;
a walker carries its medium id, and a switch is a gather. A
transmittance query crosses at most `max_crossings` null boundaries,
switching media at each; an opaque hit makes it 0. Only homogeneous
media are per-shape, with the balance strategy and an HG phase, as in
the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from alvrl_tpu_torch.core import math as m
from alvrl_tpu_torch.geometry import intersect
from alvrl_tpu_torch.media.homogeneous import HomogeneousMedium


@dataclass(frozen=True)
class MediaTable:
    sigma_a: torch.Tensor          # (M, 3)
    sigma_s: torch.Tensor          # (M, 3)
    g: torch.Tensor                # (M,)
    sampling_weight: torch.Tensor  # (M,)


def make_media_table(sigma_a, sigma_s, g=None, sampling_weight=None,
                     device="cuda") -> MediaTable:
    """The table, with the reference's default sampling weights (each
    medium's largest albedo, floored at 0.5 where it scatters)."""
    f32 = dict(dtype=torch.float32, device=device)
    sigma_a = torch.as_tensor(sigma_a, **f32).reshape(-1, 3)
    n = sigma_a.shape[0]
    sigma_s = torch.as_tensor(sigma_s, **f32).reshape(n, 3)
    g = torch.zeros((n,), **f32) if g is None else torch.as_tensor(g, **f32)
    if sampling_weight is None:
        sigma_t = sigma_a + sigma_s
        albedo = torch.where(
            sigma_t > 0.0, sigma_s / torch.clamp(sigma_t, min=1e-30), 0.0)
        w = albedo.amax(dim=-1)
        sampling_weight = torch.where(w > 0.0, torch.clamp(w, min=0.5), 0.0)
    return MediaTable(sigma_a=sigma_a, sigma_s=sigma_s, g=g.reshape(n),
                      sampling_weight=torch.as_tensor(
                          sampling_weight, **f32).reshape(n))


def medium_at(table: MediaTable, med_id) -> HomogeneousMedium:
    """The media of the ids med_id (...): a HomogeneousMedium whose
    tensors carry the lanes' axis (balance strategy, HG phase)."""
    return HomogeneousMedium(sigma_a=table.sigma_a[med_id],
                             sigma_s=table.sigma_s[med_id],
                             g=table.g[med_id],
                             sampling_weight=table.sampling_weight[med_id])


def medium_after_surface(scene, prim, new_d):
    """The medium id on new_d's side of triangle prim after a surface
    event: the interior one where new_d enters (against the winding
    normal), else the exterior one."""
    f = scene.faces[prim]
    p0, p1, p2 = (scene.vertices[f[..., i]] for i in range(3))
    ng_raw = m.normalize(m.cross(p1 - p0, p2 - p0))
    going_in = m.dot(new_d, ng_raw) < 0
    return torch.where(going_in, scene.face_med_int[prim],
                       scene.face_med_ext[prim])


def eval_transmittance_nested(scene, p0, p1, med0, max_crossings: int = 8):
    """(..., 3) transmittance from p0 to p1 starting in media med0 (...),
    switching media at null boundaries; 0 where an opaque surface
    blocks the segment."""
    tbl = scene.media
    delta = p1 - p0
    dist = m.length(delta)
    d = delta / torch.clamp(dist, min=1e-20)[..., None]
    eps = 1e-3 * torch.clamp(dist, min=1.0)
    kinds = scene.materials.kind[scene.material]
    from alvrl_tpu_torch.scene.scene import NULL

    t_cur = torch.zeros_like(dist)
    med = torch.as_tensor(med0, device=dist.device).expand(dist.shape)
    tau = torch.ones(dist.shape + (3,), dtype=dist.dtype, device=dist.device)
    done = torch.zeros_like(dist, dtype=torch.bool)
    blocked = torch.zeros_like(done)
    for _ in range(max_crossings):
        o = p0 + t_cur[..., None] * d
        remaining = dist - t_cur - eps
        hit = intersect.intersect_all(o, d, scene.vertices, scene.faces,
                                      tmin=eps,
                                      tmax=torch.clamp(remaining, min=0.0))
        seg_len = torch.where(hit.valid, hit.t, dist - t_cur)
        sigma_t = tbl.sigma_a[med] + tbl.sigma_s[med]
        tau_new = tau * torch.exp(-sigma_t * torch.clamp(seg_len, min=0.0)[
            ..., None])
        prim = hit.prim.clamp(min=0)
        opaque_hit = hit.valid & (kinds[prim] != NULL) & ~done
        med_new = medium_after_surface(scene, prim, d)
        t_cur = torch.where(done, t_cur, t_cur + seg_len)
        med = torch.where(done | ~hit.valid, med, med_new)
        tau = torch.where(done[..., None], tau, tau_new)
        done = done | ~hit.valid | opaque_hit
        blocked = blocked | opaque_hit
    return torch.where(blocked[..., None], 0.0, tau)
