"""Specular chains for the VRL eye path.

Counterpart of alvrl_tpu/integrators/vrl/specular.py: at a delta
surface (mirror, smooth dielectric, null boundary) the VRL gather
recurses along the specular continuation with weight *= transmittance
* bsdfWeight / rrProb, Russian roulette on throughputWithEtaSq (forced
stopping probability 0.98 beyond forced_rr_depth, initial throughput
initial_throughput), as vrlIntegrator::LiInternal
(vrlIntegrator.cpp:445-511). As there, the recursion is a bounded loop:
MIRROR and NULL have one delta lobe, followed deterministically, and
DIELECTRIC samples one of its two lobes by the Fresnel probability
(weight 1 by cancellation), which keeps the loop linear.

The loop runs over the rays still on a chain: it gathers those rays
after each bounce (one host sync a depth), so each depth's gather and
hits run on the live rays only, where the reference masks every ray at
every depth. On the same uniforms, indexed by the original ray, the two
agree to rounding, since the sum is linear. A kernel that numbers its
random stream by a ray's place in the launch draws other numbers for
the gathered rays, so there the two agree in expectation only.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from alvrl_tpu_torch.core import math as m
from alvrl_tpu_torch.media import api as mapi
from alvrl_tpu_torch.scene.scene import DIELECTRIC, MIRROR, NULL, Scene

# uniforms of one chain step: the lobe choice, then the roulette
U_LOBE, U_RR = 0, 1
N_CHAIN_DIMS = 2


@dataclass(frozen=True)
class SpecularConfig:
    max_depth: int = 6
    forced_rr_depth: int = 100
    initial_throughput: float = 20.0


def fresnel_dielectric(cos_i, eta):
    """Unpolarized Fresnel reflectance of a smooth dielectric of relative
    IOR eta (int/ext) at cos_i >= 0: (F, cos_t); F = 1 under total
    internal reflection."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin_t2 = (1.0 / (eta * eta)) * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin_t2 >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t2, min=0.0))
    rs = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t, min=1e-12)
    rp = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-12)
    f = 0.5 * (rs * rs + rp * rp)
    return torch.where(tir, 1.0, f), cos_t


def specular_bounce(scene: Scene, u, mat_id, d_in, ng_raw):
    """The delta continuation at a surface of material mat_id, reached
    along d_in, with the winding normal ng_raw (not flipped) and the
    lobe-choice uniform u: (wo, weight (..., 3), eta_ratio, is_delta).
    NULL passes the ray on, MIRROR reflects with the albedo as tint,
    DIELECTRIC reflects with probability F and else refracts, carrying
    the radiance compression 1/eta^2 (dielectric.cpp) and the ratio of
    the IORs it crosses. Other kinds give is_delta False."""
    mats = scene.materials
    kind = mats.kind[mat_id]
    eta_mat = mats.eta[mat_id]

    entering = m.dot(ng_raw, d_in) < 0
    n = torch.where(entering[..., None], ng_raw, -ng_raw)
    cos_i = -m.dot(n, d_in)
    eta = torch.where(entering, eta_mat,
                      1.0 / torch.clamp(eta_mat, min=1e-6))

    wo_mirror = d_in + 2.0 * cos_i[..., None] * n
    f, cos_t = fresnel_dielectric(cos_i, eta)
    reflect = u < f
    inv_eta = 1.0 / torch.clamp(eta, min=1e-6)
    wo_refract = (d_in * inv_eta[..., None]
                  + (cos_i * inv_eta - cos_t)[..., None] * n)
    wo_diel = torch.where(reflect[..., None], wo_mirror, wo_refract)
    w_diel = torch.where(reflect, 1.0, inv_eta * inv_eta)[..., None] \
        .expand(d_in.shape)
    eta_diel = torch.where(reflect, 1.0, inv_eta)

    is_mirror = kind == MIRROR
    is_null = kind == NULL
    is_diel = kind == DIELECTRIC
    wo = torch.where(is_null[..., None], d_in,
                     torch.where(is_mirror[..., None], wo_mirror, wo_diel))
    weight = torch.where(is_null[..., None], 1.0,
                         torch.where(is_mirror[..., None], mats.albedo[mat_id],
                                     w_diel))
    eta_ratio = torch.where(is_diel, eta_diel, 1.0)
    return wo, weight, eta_ratio, is_mirror | is_null | is_diel


def li_specular_chain(scene: Scene, ray_o, ray_d, li_at_hit, trace_eye_rays,
                      u, spec_cfg: SpecularConfig = SpecularConfig(), *,
                      density_ss=None):
    """The VRL gather summed along each ray's specular chain: (B, 3).

    u (max_depth, B, N_CHAIN_DIMS) holds each step's lobe-choice and
    roulette uniforms, indexed by the original ray. trace_eye_rays(scene,
    o, d) -> (hit, mat) gives the closest hits (misses' points at the
    origin) and li_at_hit(o, d, hit, mat, idx, depth, weight) -> (n, 3)
    the gather of the n rays idx (their indices among the B rays) at
    that depth, times the chain weight (n, 3). density_ss is a grid
    medium's supersampled density, for the transmittance. Only the rays
    still on a chain are carried to the next depth, and the loop ends at
    the first depth without one."""
    max_depth = spec_cfg.max_depth
    if tuple(u.shape) != (max_depth, ray_o.shape[0], N_CHAIN_DIMS):
        raise ValueError(f"u must be ({max_depth}, {ray_o.shape[0]}, "
                         f"{N_CHAIN_DIMS}), got {tuple(u.shape)}")
    b = ray_o.shape[0]
    li = torch.zeros((b, 3), dtype=torch.float32, device=ray_o.device)
    idx = torch.arange(b, device=ray_o.device)
    weight = torch.ones((b, 3), dtype=torch.float32, device=ray_o.device)
    twes = torch.full((b, 3), spec_cfg.initial_throughput,
                      dtype=torch.float32, device=ray_o.device)
    o, d = ray_o, ray_d
    for depth in range(max_depth + 1):
        hit, mat = trace_eye_rays(scene, o, d)
        contrib = li_at_hit(o, d, hit, mat, idx, depth, weight)
        li = li.index_add(0, idx, torch.where(hit.valid[..., None], contrib,
                                              0.0))
        if depth == max_depth:
            break
        u_step = u[depth, idx]
        wo, w_bsdf, eta_ratio, is_delta = specular_bounce(
            scene, u_step[:, U_LOBE], mat, d, hit.ng_raw)
        tau = mapi.transmittance(scene.medium, o, hit.p, density_ss)
        twes2 = twes * tau * w_bsdf * (eta_ratio * eta_ratio)[..., None]
        max_rr = 0.98 if depth + 1 >= spec_cfg.forced_rr_depth else 1.0
        rr_prob = torch.clamp(twes2.amax(dim=-1), max=max_rr)
        go = hit.valid & is_delta & (rr_prob > 0) & (
            (rr_prob >= 1.0) | (u_step[:, U_RR] < rr_prob))
        scale = (1.0 / torch.clamp(rr_prob, min=1e-30))[..., None]
        keep = go.nonzero()[:, 0]
        if keep.numel() == 0:
            break
        idx, o, d = idx[keep], hit.p[keep], wo[keep]
        weight = (weight * tau * w_bsdf * scale)[keep]
        twes = (twes2 * scale)[keep]
    return li
