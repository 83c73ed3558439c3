"""Heterogeneous participating medium over a density grid.

Counterpart of alvrl_tpu/media/heterogeneous.py: a scalar density on a
regular grid over a box, spectral extinction density * scale *
sigma_t_color, constant albedo, an HG, Rayleigh or oriented phase
(Kajiya-Kay, micro-flake; an orientation volume of fiber directions).
What the VRL render, the tracer and volpath read:

  * upsample2, the 2x trilinear supersample of the density that the
    quadratures read by nearest lookup (lookup_density_nn) when
    fast_tau is True (the default); with fast_tau False they read the
    density itself, trilinear (lookup_density). The port keeps no
    cached copy on the medium: each entry point computes the grid the
    quadratures read once per call from the current density
    (quad_grid) and passes it down explicitly (`density_ss` below), so
    a cache can never go stale;
  * lookup_density (trilinear) and lookup_density_nn;
  * lookup_orientation and dir_factor: a micro-flake medium's
    directional extinction, the density times sigmaDir(cos(d,
    orientation)), in every quadrature and in tracking (1 otherwise);
  * the 16-step midpoint quadratures optical_depth and cumulative_od,
    interp_od, eval_transmittance and eval_ray;
  * sample_distance, Woodcock delta tracking in the mean-sigma_t
    channel (its majorant times sigma_dir_max), from explicit uniforms:
    the JAX package splits a key per tracking step, the port reads step
    k's two uniforms from u_track[..., k, :], and all lanes advance in
    lockstep; with sampling = 1, sample_distance_quadrature, the
    inversion of a 64-step cumulative-OD table from one uniform;
  * with_density, the medium with a new density and its majorant.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import torch

from alvrl_tpu_torch.core import math as m
from alvrl_tpu_torch.media import phase as ph
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
    # the quadratures' density read: nearest in the 2x supersample (True)
    # or trilinear in the density (False, exact)
    fast_tau: bool = True
    orientation: torch.Tensor = None  # (Z, Y, X, 3) fiber directions
    phase_params: object = None       # media.phase.PhaseParams (oriented)
    sigma_dir_max: torch.Tensor = None  # () majorant factor (default 1)
    # free-flight sampling: 0 Woodcock tracking, 1 the inversion of the
    # cumulative-OD table (heterogeneous.cpp ESimpsonQuadrature)
    sampling: int = 0

    @property
    def sigma_s_color(self):
        return self.sigma_t_color * self.albedo


def make_grid_medium(density, sigma_t_color, albedo, g=0.0,
                     box_min=(-1, -1, -1), box_max=(1, 1, 1), scale=1.0,
                     phase_kind=HG, orientation=None, phase_params=None,
                     fast_tau=True, sampling=0, device="cuda"):
    """The grid medium with max_density = max(density) * scale. With an
    orientation volume (Z, Y, X, 3), the JAX package's defaults: a
    MICROFLAKE medium takes ph.microflake_params() unless given
    phase_params, and sigma_dir_max = 2 max(sigma_t_lut), the bound of
    its directional factor; any other kind ph.kkay_params(). Without
    one, sigma_dir_max is 1."""
    def f32(x):
        if isinstance(x, torch.Tensor):
            return x.to(dtype=torch.float32, device=device)
        return torch.tensor(x, dtype=torch.float32, device=device)

    if sampling not in (0, 1):
        raise ValueError(f"sampling must be 0 (Woodcock) or 1 (quadrature), "
                         f"got {sampling}")
    density, scale = f32(density), f32(scale)
    sdm = f32(1.0)
    if orientation is not None:
        orientation = f32(orientation)
        if tuple(orientation.shape) != tuple(density.shape) + (3,):
            raise ValueError(f"orientation must be {tuple(density.shape)} x "
                             f"3, got {tuple(orientation.shape)}")
        if phase_kind == ph.MICROFLAKE:
            if phase_params is None:
                phase_params = ph.microflake_params(device=device)
            sdm = 2.0 * phase_params.sigma_t_lut.max()
        elif phase_params is None:
            phase_params = ph.kkay_params(device=device)
    return GridMedium(
        density=density, sigma_t_color=f32(sigma_t_color),
        albedo=f32(albedo), g=f32(g), box_min=f32(box_min),
        box_max=f32(box_max), scale=scale,
        max_density=density.max() * scale, phase_kind=phase_kind,
        fast_tau=fast_tau, orientation=orientation,
        phase_params=phase_params, sigma_dir_max=sdm, sampling=sampling)


def oriented(med) -> bool:
    """Whether med is a grid medium of an oriented phase kind (Kajiya-Kay
    or micro-flake) with its orientation volume: volpath renders it,
    and neither package's VRL estimator does."""
    return isinstance(med, GridMedium) and med.orientation is not None \
        and med.phase_kind in (ph.KKAY, ph.MICROFLAKE)


def _directional(med: GridMedium) -> bool:
    """Directionally varying extinction: a micro-flake medium with its
    orientation volume (needsDirectionallyVaryingCoefficients)."""
    return med.orientation is not None and med.phase_kind == ph.MICROFLAKE


def quad_grid(med: GridMedium):
    """The grid that the quadratures read, as the entry points pass it
    down (`density_ss`): the supersample upsample2(density) when
    fast_tau, else the density itself."""
    return upsample2(med.density) if med.fast_tau else med.density


def with_density(med: GridMedium, density) -> GridMedium:
    """med with its density replaced and the Woodcock majorant recomputed,
    max_density = max(density) * scale, detached. Every caller that swaps
    the density goes through here: dataclasses.replace(med,
    density=...) would keep the old majorant, and tracking would be
    biased wherever the new density exceeds it (ROADMAP C11).
    Every other field (fast_tau, the orientation, the phase parameters,
    sigma_dir_max, sampling) is kept."""
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


def _trilinear(med: GridMedium, values, p):
    """values (Z, Y, X) or (Z, Y, X, C) interpolated trilinearly at p, and
    whether p lies in the box (GridDataSource::lookupFloat and
    lookupVector, gridvolume.cpp:337-364)."""
    q, inside = _box_coords(med, p)
    corners, fracs = [], []
    for axis, n in zip((0, 1, 2), reversed(med.density.shape)):
        gc = q[..., axis] * (n - 1)
        c0 = torch.clamp(torch.floor(gc), 0.0, float(n - 2))
        f = torch.clamp(gc - c0, 0.0, 1.0)
        fracs.append(f[..., None] if values.dim() == 4 else f)
        corners.append(c0.to(torch.int64))
    (x0, y0, z0), (fx, fy, fz) = corners, fracs
    d = values

    def lerp_x(z, y):
        return d[z, y, x0] * (1 - fx) + d[z, y, x0 + 1] * fx

    c0 = lerp_x(z0, y0) * (1 - fy) + lerp_x(z0, y0 + 1) * fy
    c1 = lerp_x(z0 + 1, y0) * (1 - fy) + lerp_x(z0 + 1, y0 + 1) * fy
    return c0 * (1 - fz) + c1 * fz, inside


def lookup_density(med: GridMedium, p):
    """Trilinear density lookup, 0 outside the box."""
    d, inside = _trilinear(med, med.density, p)
    return torch.where(inside, d * med.scale, 0.0)


def lookup_orientation(med: GridMedium, p):
    """Trilinear fiber-orientation lookup (..., 3) (the vector volume of
    lookupVector); 0 outside the box, and where the volume stores zero
    vectors (an undefined orientation)."""
    v, inside = _trilinear(med, med.orientation, p)
    return torch.where(inside[..., None], v, 0.0)


def dir_factor(med: GridMedium, p, d):
    """sigmaDir(cos(d, orientation(p))), the factor that makes the scalar
    density the extinction along the unit direction d (lookupSigmaT
    with an orientation volume): 1 for a medium that is not
    directional, 0 where the orientation is undefined."""
    if not _directional(med):
        return torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    o = lookup_orientation(med, p)
    olen = m.length(o)
    cos_t = (d * o).sum(dim=-1) / torch.clamp(olen, min=1e-12)
    f = ph.microflake_sigma_dir(med.phase_params, cos_t)
    return torch.where(olen > 1e-8, f, 0.0)


def _lookup_quad(med: GridMedium, density_ss, p):
    """The quadratures' density at p: nearest in the supersample
    density_ss when fast_tau, else trilinear."""
    if med.fast_tau:
        return lookup_density_nn(med, density_ss, p)
    return lookup_density(med, p)


def _step_density(med: GridMedium, density_ss, p, d_unit):
    """A quadrature sample: the density at p, times the directional
    factor along d_unit where the medium is directional."""
    dens = _lookup_quad(med, density_ss, p)
    if d_unit is not None:
        dens = dens * dir_factor(med, p, d_unit)
    return dens


def _unit_dir(med: GridMedium, delta):
    """delta's direction where the medium is directional, else None."""
    if not _directional(med):
        return None
    return delta / torch.clamp(m.length(delta), min=1e-20)[..., None]


def optical_depth(med: GridMedium, density_ss, p0, p1, n_steps=N_TAU_STEPS):
    """Midpoint-rule integral of the density along [p0, p1], the samples
    read by _lookup_quad (times the directional factor along the
    segment) and summed in step order."""
    delta = p1 - p0
    d_unit = _unit_dir(med, delta)
    total = torch.zeros(p0.shape[:-1], dtype=p0.dtype, device=p0.device)
    for i in range(n_steps):
        t = (i + 0.5) / n_steps
        total = total + _step_density(med, density_ss, p0 + t * delta, d_unit)
    return total * m.length(delta) / n_steps


# cumulative_od's step count up to which its running sums are a cumsum,
# as the JAX package's unrolled table; above it (the quadrature sampler's
# 64 steps) float32 additions in step order, as its loop (_UNROLL_MAX)
_SCAN_STEPS = 32


def cumulative_od(med: GridMedium, density_ss, p0, p1, n_steps=N_TAU_STEPS):
    """(..., n_steps + 1) cumulative optical depth along [p0, p1]: entry
    k integrates the density over the first k / n_steps of the segment
    (one midpoint sample per sub-interval, as optical_depth's)."""
    delta = p1 - p0
    d_unit = _unit_dir(med, delta)
    steps = [_step_density(med, density_ss,
                           p0 + ((i + 0.5) / n_steps) * delta, d_unit)
             for i in range(n_steps)]
    if n_steps <= _SCAN_STEPS:
        steps = torch.stack(steps, dim=-1)
        cum = torch.cat([torch.zeros_like(steps[..., :1]),
                         torch.cumsum(steps, dim=-1)], dim=-1)
    else:  # float32 sums in step order, as the JAX package's loop
        cum = [torch.zeros_like(steps[0])]
        for d in steps:
            cum.append(cum[-1] + d)
        cum = torch.stack(cum, dim=-1)
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


def eval_ray(med: GridMedium, density_ss, p0, p1):
    """(tau (..., 3), pdf_success, pdf_failure) over the segment p0 -> p1
    (HeterogeneousMedium::eval): the channel chan = mean(sigma_t_color),
    pdf_failure exp(-chan od), pdf_success chan times the extinction
    density at p1 times pdf_failure."""
    od = optical_depth(med, density_ss, p0, p1)
    tau = torch.exp(-med.sigma_t_color * od[..., None])
    chan = med.sigma_t_color.mean()
    tr = torch.exp(-chan * od)
    delta = p1 - p0
    d_seg = delta / torch.clamp(m.length(delta), min=1e-20)[..., None]
    dens_end = lookup_density(med, p1) * dir_factor(med, p1, d_seg)
    return tau, chan * dens_end * tr, tr


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
    * dir_factor * chan (trilinear, chan the mean of sigma_t_color;
    sigma_max = max_density * chan * sigma_dir_max), or when k >=
    MAX_TRACKING_STEPS. Done lanes are frozen; so are lanes that
    `active` marks False, from the start (their result is unused). The
    loop checks for its end every few steps.

    The weights are the JAX package's: transmittance and pdfs from the
    16-step quadrature over [0, t], the density at the end point
    trilinear, the pdf denominators and the sampled distance detached."""
    chan = med.sigma_t_color.mean()
    dir_max = 1.0 if med.sigma_dir_max is None else med.sigma_dir_max
    sig_max = torch.clamp(med.max_density * chan * dir_max, min=1e-12)
    inv_max = 1.0 / sig_max
    directional = _directional(med)
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
            p = ray_o + t_new[..., None] * ray_d
            dens = lookup_density(med, p)
            if directional:
                dens = dens * dir_factor(med, p, ray_d)
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
    if directional:
        dens_end = dens_end * dir_factor(med, p, ray_d)
    pdf_success = torch.clamp(chan * dens_end * tr_chan, min=1e-30)
    pdf_failure = torch.clamp(tr_chan, min=1e-30)
    sigma_s = dens_end[..., None] * med.sigma_s_color
    weight = torch.where(success[..., None],
                         tau * sigma_s / pdf_success.detach()[..., None],
                         tau / pdf_failure.detach()[..., None])
    return GridMediumSample(success=success, t=t_eff, p=p, transmittance=tau,
                            pdf_success=pdf_success, pdf_failure=pdf_failure,
                            sigma_s=sigma_s, weight=weight)


def _ray_box_exit(med: GridMedium, ray_o, ray_d):
    """Distance along the ray to the exit of the medium's box (the slab
    test), 0 where the ray never enters it."""
    inv = 1.0 / torch.where(ray_d.abs() < 1e-12,
                            torch.where(ray_d >= 0, 1e-12, -1e-12), ray_d)
    t0 = (med.box_min - ray_o) * inv
    t1 = (med.box_max - ray_o) * inv
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    return torch.where(t_far > torch.clamp(t_near, min=0.0),
                       torch.clamp(t_far, min=0.0), 0.0)


QUAD_SAMPLING_STEPS = N_TAU_STEPS * 4  # sample_distance_quadrature's table


def sample_distance_quadrature(med: GridMedium, density_ss, u, ray_o, ray_d,
                               dist_surf) -> GridMediumSample:
    """Free flight by inverting the transmittance (sampling = 1; the
    ESimpsonQuadrature strategy, integrateDensity and
    invertDensityIntegral, heterogeneous.cpp:301, :420), batched over the
    leading dims, from one uniform u a lane: a target optical depth
    -log1p(-u) / chan in the mean channel, found in the
    QUAD_SAMPLING_STEPS-step cumulative-OD table of the ray up to the
    closer of the surface and the box's exit (the first entry above it,
    then linear within the step). As the JAX package's: the success pdf
    takes the step's mean density (the table's piecewise-constant
    sampling density), the failure point is the surface (its optical
    depth the table's total, since nothing lies beyond the box), the
    weight's pdf denominators, the distance and the point are detached."""
    n_steps = QUAD_SAMPLING_STEPS
    chan = med.sigma_t_color.mean()
    t_exit = _ray_box_exit(med, ray_o, ray_d)
    seg_len = torch.minimum(dist_surf, torch.clamp(t_exit, min=1e-6))
    cum = cumulative_od(med, density_ss, ray_o,
                        ray_o + seg_len[..., None] * ray_d, n_steps)
    od_total = cum[..., -1]
    target = -torch.log1p(-u) / torch.clamp(chan, min=1e-30)
    success = target < od_total
    first = torch.searchsorted(cum.contiguous(),
                               target[..., None].contiguous())[..., 0]
    k0 = torch.clamp(first - 1, 0, n_steps - 1)[..., None]
    c0 = torch.take_along_dim(cum, k0, dim=-1)[..., 0]
    c1 = torch.take_along_dim(cum, k0 + 1, dim=-1)[..., 0]
    w = torch.where(c1 > c0, (target - c0) / torch.clamp(c1 - c0, min=1e-30),
                    0.0)
    frac = (k0[..., 0].to(w.dtype) + torch.clamp(w, 0.0, 1.0)) / n_steps
    t_eff = torch.where(success, frac * seg_len,
                        torch.clamp(dist_surf, max=3e30))
    p = ray_o + t_eff[..., None] * ray_d
    od_at = torch.where(success, target, od_total)
    tau = torch.exp(-med.sigma_t_color * od_at[..., None])
    tr_chan = torch.exp(-chan * od_at)
    dens_end = lookup_density(med, p) * dir_factor(med, p, ray_d)
    dens_step = (c1 - c0) * n_steps / torch.clamp(seg_len, min=1e-30)
    pdf_success = torch.clamp(chan * dens_step * tr_chan, min=1e-30)
    pdf_failure = torch.clamp(tr_chan, min=1e-30)
    sigma_s = dens_end[..., None] * med.sigma_s_color
    weight = torch.where(success[..., None],
                         tau * sigma_s / pdf_success.detach()[..., None],
                         tau / pdf_failure.detach()[..., None])
    return GridMediumSample(
        success=success, t=torch.where(success, t_eff.detach(), dist_surf),
        p=p.detach(), transmittance=tau, pdf_success=pdf_success,
        pdf_failure=pdf_failure, sigma_s=sigma_s, weight=weight)
