"""Heterogeneous participating medium over a density grid.

Counterpart of alvrl_tpu/media/heterogeneous.py for the unoriented
grid medium with an HG or Rayleigh phase: a scalar density on a regular
grid over a box, spectral extinction density * scale * sigma_t_color,
constant albedo. What the VRL render and tracer read:

  * upsample2, the 2x trilinear supersample of the density that the
    quadratures read by nearest lookup (lookup_density_nn). The port
    keeps no cached copy on the medium: each entry point computes it
    once per call from the current density and passes it down
    explicitly (`density_ss` below), so a cache can never go stale;
  * lookup_density (trilinear) and lookup_density_nn;
  * the 16-step midpoint quadratures optical_depth and cumulative_od,
    interp_od and eval_transmittance;
  * sample_distance, Woodcock delta tracking in the mean-sigma_t
    channel, from explicit uniforms: the JAX package splits a key per
    tracking step, the port reads step k's two uniforms from
    u_track[..., k, :], and all lanes advance in lockstep;
  * with_density, the medium with a new density and its majorant.

Not ported: oriented and microflake media (dir_factor is 1), the
quadrature-inversion sampler (sampling=1) and the trilinear quadrature
(fast_tau=False); ROADMAP A6.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import torch

from alvrl_tpu_torch.core import math as m
from alvrl_tpu_torch.media.phase import HG

N_TAU_STEPS = 16          # quadrature steps of the transmittance
MAX_TRACKING_STEPS = 256  # Woodcock: done once this many steps are taken
TRACKING_DRAWS = MAX_TRACKING_STEPS + 1  # the most steps a lane can take
_TRACKING_CHECK = 8       # tracking steps between two checks for the end


@dataclass(frozen=True)
class GridMedium:
    density: torch.Tensor        # (Z, Y, X) float32 scalar density
    sigma_t_color: torch.Tensor  # (3,) extinction per unit density
    albedo: torch.Tensor         # (3,) single-scattering albedo
    g: torch.Tensor              # () HG mean cosine
    box_min: torch.Tensor        # (3,)
    box_max: torch.Tensor        # (3,)
    scale: torch.Tensor          # () density multiplier
    max_density: torch.Tensor    # () max(density) * scale: the majorant
    phase_kind: int = HG

    @property
    def sigma_s_color(self):
        return self.sigma_t_color * self.albedo


def make_grid_medium(density, sigma_t_color, albedo, g=0.0,
                     box_min=(-1, -1, -1), box_max=(1, 1, 1), scale=1.0,
                     phase_kind=HG, device="cuda"):
    def f32(x):
        if isinstance(x, torch.Tensor):
            return x.to(dtype=torch.float32, device=device)
        return torch.tensor(x, dtype=torch.float32, device=device)

    density, scale = f32(density), f32(scale)
    return GridMedium(
        density=density, sigma_t_color=f32(sigma_t_color),
        albedo=f32(albedo), g=f32(g), box_min=f32(box_min),
        box_max=f32(box_max), scale=scale,
        max_density=density.max() * scale, phase_kind=phase_kind)


def with_density(med: GridMedium, density) -> GridMedium:
    """med with its density replaced and the Woodcock majorant recomputed,
    max_density = max(density) * scale, detached. Every caller that swaps
    the density goes through here: dataclasses.replace(med,
    density=...) would keep the old majorant, and tracking would be
    biased wherever the new density exceeds it (ROADMAP C11)."""
    return replace(med, density=density,
                   max_density=(density.max() * med.scale).detach())


def _up1(a, dim):
    """Insert the midpoints along one axis: n -> 2n - 1 (exact trilinear)."""
    n = a.shape[dim]
    lo, hi = a.narrow(dim, 0, n - 1), a.narrow(dim, 1, n - 1)
    inter = torch.stack([lo, 0.5 * (lo + hi)], dim=dim + 1)
    shape = list(a.shape)
    shape[dim] = 2 * (n - 1)
    return torch.cat([inter.reshape(shape), a.narrow(dim, n - 1, 1)], dim=dim)


def upsample2(density):
    """(Z, Y, X) -> (2Z - 1, 2Y - 1, 2X - 1) trilinear supersample."""
    return _up1(_up1(_up1(density, 0), 1), 2)


def _box_coords(med: GridMedium, p):
    """p in box coordinates [0, 1]^3, and whether it lies in the box."""
    q = (p - med.box_min) / (med.box_max - med.box_min)
    return q, ((q >= 0.0) & (q <= 1.0)).all(dim=-1)


def lookup_density_nn(med: GridMedium, density_ss, p):
    """Density at p by nearest lookup in the supersampled grid (the
    trilinear value at the nearest half-cell point); 0 outside the box.
    Indices round half to even, as jnp.round does."""
    q, inside = _box_coords(med, p)
    idx = []
    for axis, n in zip((0, 1, 2), reversed(med.density.shape)):
        hi = float(2 * (n - 1))
        idx.append(torch.clamp(torch.round(q[..., axis] * hi), 0.0,
                               hi).to(torch.int64))
    d = density_ss[idx[2], idx[1], idx[0]]
    return torch.where(inside, d * med.scale, 0.0)


def lookup_density(med: GridMedium, p):
    """Trilinear density lookup, 0 outside the box (GridDataSource::
    lookupFloat)."""
    q, inside = _box_coords(med, p)
    corners, fracs = [], []
    for axis, n in zip((0, 1, 2), reversed(med.density.shape)):
        gc = q[..., axis] * (n - 1)
        c0 = torch.clamp(torch.floor(gc), 0.0, float(n - 2))
        fracs.append(torch.clamp(gc - c0, 0.0, 1.0))
        corners.append(c0.to(torch.int64))
    (x0, y0, z0), (fx, fy, fz) = corners, fracs
    d = med.density

    def lerp_x(z, y):
        return d[z, y, x0] * (1 - fx) + d[z, y, x0 + 1] * fx

    c0 = lerp_x(z0, y0) * (1 - fy) + lerp_x(z0, y0 + 1) * fy
    c1 = lerp_x(z0 + 1, y0) * (1 - fy) + lerp_x(z0 + 1, y0 + 1) * fy
    return torch.where(inside, (c0 * (1 - fz) + c1 * fz) * med.scale, 0.0)


def optical_depth(med: GridMedium, density_ss, p0, p1, n_steps=N_TAU_STEPS):
    """Midpoint-rule integral of the density along [p0, p1], the samples
    read by lookup_density_nn and summed in step order."""
    delta = p1 - p0
    total = torch.zeros(p0.shape[:-1], dtype=p0.dtype, device=p0.device)
    for i in range(n_steps):
        t = (i + 0.5) / n_steps
        total = total + lookup_density_nn(med, density_ss, p0 + t * delta)
    return total * m.length(delta) / n_steps


def cumulative_od(med: GridMedium, density_ss, p0, p1, n_steps=N_TAU_STEPS):
    """(..., n_steps + 1) cumulative optical depth along [p0, p1]: entry
    k integrates the density over the first k / n_steps of the segment
    (one midpoint sample per sub-interval)."""
    delta = p1 - p0
    steps = torch.stack([lookup_density_nn(
        med, density_ss, p0 + ((i + 0.5) / n_steps) * delta)
        for i in range(n_steps)], dim=-1)
    cum = torch.cat([torch.zeros_like(steps[..., :1]),
                     torch.cumsum(steps, dim=-1)], dim=-1)
    return cum * (m.length(delta) / n_steps)[..., None]


def interp_od(cum, frac, n_steps=N_TAU_STEPS):
    """Linear interpolation of a cumulative_od table at a fraction of
    its segment, clipped to [0, 1]."""
    x = torch.clamp(frac, 0.0, 1.0) * n_steps
    k0 = torch.clamp(torch.floor(x), 0.0, n_steps - 1.0)
    w = x - k0
    k0 = k0.to(torch.int64)[..., None]
    c0 = torch.take_along_dim(cum, k0, dim=-1)[..., 0]
    c1 = torch.take_along_dim(cum, k0 + 1, dim=-1)[..., 0]
    return c0 * (1.0 - w) + c1 * w


def eval_transmittance(med: GridMedium, density_ss, p0, p1,
                       n_steps=N_TAU_STEPS):
    """Spectral tau = exp(-sigma_t_color * optical depth), (..., 3)."""
    od = optical_depth(med, density_ss, p0, p1, n_steps)
    return torch.exp(-med.sigma_t_color * od[..., None])


class GridMediumSample(NamedTuple):
    success: torch.Tensor        # a medium event before the surface
    t: torch.Tensor              # its distance, else the surface distance
    p: torch.Tensor              # the point at t
    transmittance: torch.Tensor  # (..., 3) tau over [0, t]
    pdf_success: torch.Tensor
    pdf_failure: torch.Tensor
    sigma_s: torch.Tensor        # (..., 3) at p
    weight: torch.Tensor         # (..., 3) tau sigma_s / pdf_success on
                                 # success, else tau / pdf_failure


def sample_distance(med: GridMedium, density_ss, u_track, ray_o, ray_d,
                    dist_surf, active=None) -> GridMediumSample:
    """Woodcock delta tracking along ray_o + t ray_d, t in [0, dist_surf]
    (heterogeneous.cpp:633-658), batched over the leading dims.

    Step k of a lane reads the uniforms u_track[..., k, :] (u_track:
    (..., TRACKING_DRAWS, 2)): t += -log1p(-u0) / sigma_max, then the
    lane is done when t >= dist_surf, or when u1 sigma_max <= density(p)
    * chan (trilinear, chan the mean of sigma_t_color), or when k >=
    MAX_TRACKING_STEPS. Done lanes are frozen; so are lanes that
    `active` marks False, from the start (their result is unused). The
    loop checks for its end every few steps.

    The weights are the JAX package's: transmittance and pdfs from the
    16-step quadrature over [0, t], the density at the end point
    trilinear, the pdf denominators and the sampled distance detached."""
    chan = med.sigma_t_color.mean()
    sig_max = torch.clamp(med.max_density * chan, min=1e-12)
    inv_max = 1.0 / sig_max
    t = torch.zeros_like(dist_surf)
    done = torch.zeros_like(dist_surf, dtype=torch.bool)
    if active is not None:
        done = ~active
    with torch.no_grad():
        for k in range(TRACKING_DRAWS):
            if k and k % _TRACKING_CHECK == 0 and bool(done.all()):
                break
            t_new = t - torch.log1p(-u_track[..., k, 0]) * inv_max
            beyond = t_new >= dist_surf
            dens = lookup_density(med, ray_o + t_new[..., None] * ray_d)
            accept = u_track[..., k, 1] * sig_max <= dens * chan
            t = torch.where(done, t, t_new)
            done = done | beyond | accept | (k >= MAX_TRACKING_STEPS)
    success = t < dist_surf
    t_eff = torch.minimum(t, dist_surf)
    p = ray_o + t_eff[..., None] * ray_d
    od = optical_depth(med, density_ss, ray_o, p)
    tau = torch.exp(-med.sigma_t_color * od[..., None])
    tr_chan = torch.exp(-chan * od)
    dens_end = lookup_density(med, p)
    pdf_success = torch.clamp(chan * dens_end * tr_chan, min=1e-30)
    pdf_failure = torch.clamp(tr_chan, min=1e-30)
    sigma_s = dens_end[..., None] * med.sigma_s_color
    weight = torch.where(success[..., None],
                         tau * sigma_s / pdf_success.detach()[..., None],
                         tau / pdf_failure.detach()[..., None])
    return GridMediumSample(success=success, t=t_eff, p=p, transmittance=tau,
                            pdf_success=pdf_success, pdf_failure=pdf_failure,
                            sigma_s=sigma_s, weight=weight)
