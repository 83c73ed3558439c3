"""The VRL x eye-ray sum: the hot loop of the render.

Replaces alvrl_tpu/ops/vrl_pallas.py:vrl_sum_pallas and, for grid
media, vrl_sum_pallas_hetero. For each eye ray, the sum over all valid
VRLs of the vol-vol and vol-surf estimators (Kulla equi-angular +
sinh/asinh inverse-distance sampling, short-VRL pdfFailure division,
shadow tests against the opaque triangles), (3, B) float32, not yet
normalised by the particle count. In a grid medium the transmittances
come from the eye and VRL cumulative-OD tables of the grid packs and a
uv_steps-point quadrature of the U-V segment, the scattering
coefficients from the supersampled density read directly (no CP
factors: ROADMAP C9), and the short-VRL division is by exp(-chan od).

What bounds it on the H100 is fp32 ALU and special-function throughput
(about 150 float32 and 20 special-function operations per pair-sample
and 59 per triangle of its shadow sweep, on under 1 MB of input; a grid
sample adds its density reads and OD interpolations); the CUDA kernel
(csrc/vrl_sum.cu, whose header gives the design) keeps everything on
chip and splits both the ray and the VRL axes over the grid so that the
card is full.

A homogeneous medium with a mixture phase (ph.MIXTURE) or a sampling
strategy other than balance comes in ops.pack.pack_medium's extended
pack: the plain versions and kernels 1, 2 and 5 (their PHASE = 2 forms
for the mixture) evaluate the mixture's components and divide by the
strategy's pdfFailure, msw exp(-rho x) + 1 - msw, as the JAX package's
XLA route does (ROADMAP C16), and so do kernel 7 (ops.vrl_sum_bvh) and
the backward kernels 8 and 10 in their extended forms, which also return
the cotangent of the strategy's rate (ops.vrl_sum_bwd).

A grid medium of fast_tau False comes in the trilinear medium pack
(ops.pack.GRID_TRI_MED_LEN) with the density itself in place of the
supersample: the grid wrappers launch the kernels' trilinear forms
(counted on their `tri_launches` too), whose plain versions are the same
grid routes with integrate.grid_density's trilinear read, as the JAX
package's XLA route reads a fast_tau=False medium (ROADMAP C20), and so
do the backward grid kernels 9 and 11 in their trilinear forms.

Glossy and layered surfaces at the eye hit take kernel 1's material
instantiation: the wrappers and plain versions take `materials`, the
material pack of ops.pack.pack_materials, with the ray pack that holds
the hit's material id (ops.pack.MAT_RAY_ROWS rows), and the vol-surf
term evaluates the hit's smooth BSDF (integrate.bsdf_eval_smooth in
the plain version, vrl_common.cuh eval_smooth in the kernel) in place of
albedo cos_o / pi. In a grid medium the same: the grid kernels' material
forms (kernels 3, 4 and 6, either density read, counted on their
`mat_launches` too) take the material pack with the grid ray pack that
holds the hit's material id (ops.pack.GRID_MAT_RAY_ROWS rows); the
clustered sum, R and the backward kernels 8-11 take it the same way.
The JAX package's Pallas
kernels evaluate no BSDF (their packs zero the albedo of a non-diffuse
hit, ROADMAP C21); the port follows its XLA route, pair_contribution.

A textured table (procedural or bitmap textures, normal and bump maps,
the HK slab) takes the textured forms of kernels 1, 2 and 5 (TEX): the
material pack with the textured ray pack (ops.pack.TEX_RAY_ROWS), whose
rows hold each eye hit's shading normal and the textured albedos of its
material's leaf and nested leaves; the vol-surf term evaluates
eval_smooth at that normal with those albedos, and the HK slab from its
table columns (csrc/vrl_tex.cuh and its sources; the plain version,
bsdf_eval_smooth with the rows' bsdf.api.Shading). In a grid medium the
grid kernels 3, 4 and 6 take it the same way, nearest or trilinear, with
the grid textured ray pack (ops.pack.GRID_TEX_RAY_ROWS: the same 12 rows
after GRID_MATID), and kernel 7 (ops.vrl_sum_bvh) with the homogeneous
one. The wrappers count those launches on their `tex_launches` too. The
backward kernels 8-11 refuse a textured pack (ROADMAP A11a).

Beside the kernel:
  * `vrl_sum_reference` and `vrl_sum_hetero_reference`, the plain
    PyTorch versions on the same packs, built from
    integrators.vrl.integrate's samplers and grid reads, with explicit
    uniforms;
  * `philox_uniforms`, the kernel's random stream (Philox4x32-10) in
    plain torch, so that a live-RNG kernel run is checked exactly;
  * `vrl_sum` and `vrl_sum_hetero`, the wrappers: the kernel for CUDA
    tensors (or an error; there is no fallback), the plain version for
    CPU tensors;
  * `homog_bar`, the agreement bar between two renders.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from alvrl_tpu_torch.core import math as m
from alvrl_tpu_torch.integrators.vrl import integrate
from alvrl_tpu_torch.media import heterogeneous as gmed
from alvrl_tpu_torch.media import phase as ph
from alvrl_tpu_torch.ops import _build
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.scene.scene import RT_ALPHA, RT_COS

# ---------------------------------------------------------------------------
# Philox4x32-10 (Salmon et al., Random123) on int64 tensors holding uint32
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_PHILOX_RAY_CHUNK = 2048  # rays per block of philox_uniforms
_PLAIN_RAY_CHUNK = 256    # rays per block of vrl_sum_reference
_OCCLUSION_TESTS = 2 ** 24  # (segment, triangle) tests per shadow block
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo32(a: int, b):
    """(hi, lo) 32-bit words of the 64-bit product of the constant a and
    the uint32 tensor b, with every partial product below 2^49."""
    x = a * (b >> 16)
    y = a * (b & 0xFFFF)
    lo = (((x & 0xFFFF) << 16) + y) & _MASK32
    hi = (x + (y >> 16)) >> 16
    return hi, lo


def philox4x32_10(counter, key):
    """Philox4x32-10 of `counter` ((..., 4) int64 tensor of uint32 words)
    under `key` (two ints); returns (..., 4) int64 of uint32 words."""
    c0, c1, c2, c3 = counter.unbind(-1)
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def philox_draws(seed: int, ray_idx, vrl_idx, n_draws: int):
    """(..., n_draws) float32 uniforms of the kernels' stream for the
    pairs (ray_idx, vrl_idx), two int64 tensors that broadcast together:
    key (seed, 0), counter (ray, vrl, j, 0); draw d is word d % 4 of
    call j = d // 4, mapped to (bits >> 8) * 2^-24."""
    n_calls = -(-n_draws // 4)
    j = torch.arange(n_calls, dtype=torch.int64, device=vrl_idx.device)
    b, n, j = torch.broadcast_tensors(ray_idx[..., None], vrl_idx[..., None],
                                      j)
    ctr = torch.stack([b, n, j, torch.zeros_like(b)], dim=-1)
    bits = philox4x32_10(ctr, (seed, 0)).reshape(b.shape[:-1]
                                                  + (4 * n_calls,))
    return (bits[..., :n_draws] >> 8).to(torch.float32) * 2.0 ** -24


def philox_uniforms(seed: int, n_rays: int, n_vrls: int, n_draws: int,
                    device="cpu"):
    """(n_rays, n_vrls, n_draws) float32 uniforms of the kernel's stream
    for every pair (ray b, VRL n) of a vrl_sum launch."""
    out = torch.empty((n_rays, n_vrls, n_draws), dtype=torch.float32,
                      device=device)
    i64 = dict(dtype=torch.int64, device=device)
    n = torch.arange(n_vrls, **i64)[None, :]
    for b0 in range(0, n_rays, _PHILOX_RAY_CHUNK):
        b = torch.arange(b0, min(n_rays, b0 + _PHILOX_RAY_CHUNK),
                         **i64)[:, None]
        out[b0:b0 + len(b)] = philox_draws(seed, b, n, n_draws)
    return out


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _occluded_packed(p, q, tris):
    """(...,) bool: does a packed triangle block the open segment p -> q
    (ends shrunk by 1e-3 * max(|q - p|, 1))? The division-free Wald test
    of the kernel, vectorised over the triangles, in blocks of at most
    _OCCLUSION_TESTS (segment, triangle) tests."""
    shape = torch.broadcast_shapes(p.shape, q.shape)[:-1]
    step = max(1, _OCCLUSION_TESTS // max(math.prod(shape), 1))
    if tris.shape[0] <= step:
        return _occluded_block(p, q, tris)
    blocked = torch.zeros(shape, dtype=torch.bool, device=p.device)
    for t0 in range(0, tris.shape[0], step):
        blocked |= _occluded_block(p, q, tris[t0:t0 + step])
    return blocked


def _occluded_block(p, q, tris):
    return _wald_hits(p, q, tris).any(dim=-1)


def _segment(p, q):
    """The shadow segment p -> q as the kernels test it: its unit
    direction u and the open interval (lo, hi) of arc length, each with
    a trailing axis of 1 (vrl_common.cuh make_segment)."""
    dd = q - p
    len2 = m.dot(dd, dd)
    idist = 1.0 / torch.sqrt(torch.clamp(len2, min=1e-30))
    dist = len2 * idist
    u = (dd * idist[..., None])[..., None, :]
    lo = (1e-3 * torch.clamp(dist, min=1.0))[..., None]
    return u, lo, dist[..., None] - lo


def _wald_hits(p, q, tris):
    """(..., T) bool: the Wald test of each triangle of tris ((T,
    TRI_COLS), or (..., T, TRI_COLS) per segment) against the open
    segment p -> q (vrl_common.cuh wald_hit)."""
    u, lo, hi = _segment(p, q)
    p0, e1, e2 = tris[..., 0:3], tris[..., 3:6], tris[..., 6:9]
    pv = m.cross(u, e2)
    det = m.dot(e1, pv)
    sgn = torch.where(det >= 0.0, 1.0, -1.0)
    adet = det * sgn
    tv = p[..., None, :] - p0
    uu = m.dot(tv, pv) * sgn
    qv = m.cross(tv, e1)
    vv = m.dot(u, qv) * sgn
    tt = m.dot(e2, qv) * sgn
    mn = torch.minimum(uu, vv)
    mn = torch.minimum(mn, adet - (uu + vv))
    mn = torch.minimum(mn, tt - lo * adet)
    mn = torch.minimum(mn, hi * adet - tt)
    mn = torch.minimum(mn, adet - 1e-12)
    return mn > 0.0


PLANE_MARGIN = 2.0 ** -14  # vrl_common.cuh PLANE_MARGIN


def plane_pack(tris):
    """(T, 16) float32: the plane pack of kernel 1's pre-reject
    (vrl_common.cuh PlaneTris; its kernel csrc/vrl_sum.cu
    plane_pack_kernel): n = e1 x e2 and off = n . p0 computed in float64
    and rounded to nearest, k = PLANE_MARGIN |e1|_inf |e2|_inf and k0 =
    k |p0|_inf rounded up, then p0, e1, e2; per triangle (n, off, k, k0,
    p0, e1, e2, 0)."""
    t = tris.double()
    p0, e1, e2 = t[:, 0:3], t[:, 3:6], t[:, 6:9]
    n = torch.linalg.cross(e1, e2).float()
    off = (n.double() * p0).sum(dim=-1).float()
    k = PLANE_MARGIN * e1.abs().amax(dim=-1) * e2.abs().amax(dim=-1)
    k0 = k * p0.abs().amax(dim=-1)

    def round_up(x):
        f = x.float()
        return torch.where(f.double() < x, torch.nextafter(
            f, torch.full_like(f, math.inf)), f)

    return torch.cat([n, off[:, None], round_up(k)[:, None],
                      round_up(k0)[:, None], tris.float(),
                      torch.zeros_like(off)[:, None]], dim=1)


def plane_skip(p, q, planes):
    """(..., T) bool: the triangles of a plane pack (plane_pack) whose
    Wald test kernel 1's pre-reject skips on the open segment p -> q:
    both tested ends on one side of the triangle's plane by more than the
    margin (vrl_common.cuh PlaneTris, whose comment proves that such a
    triangle does not block the segment). Plain float32 twin of the
    kernel's test."""
    u, lo, hi = _segment(p, q)
    pp = p[..., None, :]
    a, b = pp + u * lo[..., None], pp + u * hi[..., None]
    span = p.abs().amax(dim=-1, keepdim=True) + torch.maximum(lo.abs(),
                                                              hi.abs())
    n, off = planes[:, 0:3], planes[:, 3]
    sa = (a * n).sum(dim=-1) - off
    sb = (b * n).sum(dim=-1) - off
    mg = planes[:, 4] * span + planes[:, 5]
    return ((sa > mg) & (sb > mg)) | ((sa < -mg) & (sb < -mg))


VV, VS = "vol-vol", "vol-surf"  # the two sample families


def _vrl_side(vrls):
    """The VRL side of the pair grid: start, end, power (G, N, 3), valid
    (G, N) and the cumulative-OD table (G, N, NQ + 1) of a grid pack
    ((G, N, 0) otherwise), from a (rows, N) pack (G = 1, every ray
    against every VRL) or a (rows, R, C) gather (G = R, a table per
    ray)."""
    if vrls.dim() == 2:
        vrls = vrls[:, None]
    def rows(r):
        return vrls[r:r + 3].movedim(0, -1)
    return (rows(pk.VS), rows(pk.VE), rows(pk.VP), vrls[pk.VVALID] > 0.5,
            vrls[pk.VOD:].movedim(0, -1))


def _plain_materials(materials):
    """The plain version's view of a material pack (ops.pack.
    pack_materials' (table, rt_tables)): (Materials, the set of kinds, the
    (M,) smooth flags), or None for the diffuse sum."""
    if materials is None:
        return None
    table, rt_tables = materials
    return (pk.materials_from_pack(table, rt_tables),
            frozenset(table[:, pk.MT_KIND].long().tolist()),
            table[:, pk.MT_SMOOTH] > 0.5)


def _pair_terms(rays, vrls, tris, medium, u, svv, svs, short_vrls,
                phase_kind, grid=None, mats=None):
    """The estimator, once: yields (family, term) for each sample of the
    pairs of a block of R rays, in draw order, where term (R, N, 3) is
    the raw per-sample contribution (not divided by the family's sample
    count) and 0 where the sample is dropped; u: (R, N, 2 * svv + svs).
    vrls as _vrl_side takes it. The sum, the clustered sum and R mode
    reduce the same terms (_pair_sums, _pair_r).

    grid = (density_ss, uv_steps) for the grid packs (ops.pack's
    GRID_* layouts), None for the homogeneous ones. The grid terms read
    the eye and VRL cumulative-OD tables at the sample's fractions of
    its segments, integrate the U-V segment in uv_steps midpoint steps,
    and take sigma_s times the density at U and V (integrate.py's table
    branch of pair_contribution, in the Pallas kernel's order).

    Differentiable by autograd (ops.vrl_sum_bwd's plain versions) in
    the VP rows of `vrls`, the TAU rows of `rays` and medium[0:7] for
    homogeneous packs (and the rate, medium[MED_RHO], of the extended
    one); for grid packs also in the VOD and EOD rows, the density scale
    and density_ss (either read). The geometry of each sample is
    replaced by harmless values where the sample is masked out (on the
    grid branch also the points U and V, moved to the segments' starts,
    and |E - U|, |U - V|, set to 0, so that their voxel indices are
    finite and in range), since torch.where passes NaN or inf of the
    unselected branch into the gradient.

    mats (_plain_materials; with the MATID row, GRID_MATID in the grid
    packs): the vol-surf term evaluates the eye hit's smooth BSDF,
    integrate.bsdf_eval_smooth(-d, -vu), in place of albedo cos_o / pi, and is
    gated by the hit material's smooth flag; the material kernels' plain
    version, differentiable as above (the material's own parameters are
    constants, as in the JAX package's train step). On a textured ray
    pack (TEX_RAY_ROWS, or the grid one, GRID_TEX_RAY_ROWS) it evaluates
    at the rows' shading normal and albedos: the textured forms' plain
    version."""
    def rows(pack, r):
        return pack[r:r + 3].T

    o, d, hp = rows(rays, pk.RO)[:, None], rows(rays, pk.RD)[:, None], \
        rows(rays, pk.HP)[:, None]
    ng, alb, tau = rows(rays, pk.NG)[:, None], rows(rays, pk.ALB)[:, None], \
        rows(rays, pk.TAU)[:, None]
    s, e, pw, v_ok, vrl_od = _vrl_side(vrls)
    pair_ok = (rays[pk.VALID][:, None] > 0.5) & v_ok
    sig_t, sig_s, g = medium[0:3], medium[3:6], medium[6]
    uv = m.normalize(e - s)
    rho, mix = (pk.medium_extension(medium) if grid is None
                else (None, None))

    def phase(wi, wo):
        if phase_kind == ph.MIXTURE:  # the pack's components
            return ph.eval_mixture(ph.PhaseParams(mix[:, 0], mix[:, 1],
                                                  mix[:, 2]), wi, wo)
        return ph.eval_phase(phase_kind, g, wi, wo)

    if grid is None:
        msw = medium[7]

        def pdf_failure(x):
            pf = torch.exp(-sig_t * x[..., None]).sum(dim=-1) * (1.0 / 3.0)
            if mix is not None and medium.shape[0] > pk.MED_LEN:
                # single, manual, maximum: their one rate (0: balance)
                pf = torch.where(rho > 0, torch.exp(-rho * x), pf)
            return msw * pf + (1.0 - msw)
    else:
        density_ss, uv_steps = grid
        chan = medium[7]
        eye_od = rays[pk.EOD:].T[:, None]
        elen = torch.clamp(m.distance(o, hp), min=1e-20)
        vlen = torch.clamp(m.distance(s, e), min=1e-20)

        def density(p):
            return integrate.grid_density(medium, density_ss, p)

        def od_uv(p, q, dist):
            return integrate.grid_segment_od(medium, density_ss, p, q, dist,
                                             uv_steps)

        def grid_geo(geo, od_sv):
            if short_vrls:
                geo = geo / torch.clamp(torch.exp(-chan * od_sv), min=1e-30)
            return geo[..., None]

    def segment(p, q):
        duv = p - q
        d_uv2 = m.dot(duv, duv)
        d_uv = torch.sqrt(torch.clamp(d_uv2, min=1e-30))
        return d_uv2, d_uv, duv / d_uv[..., None]

    def masked(ok, *xs):
        """xs where ok, else 0 (or 1 for the last, a denominator)."""
        *xs, den = xs
        xs = [torch.where(ok[..., None] if x.dim() > ok.dim() else ok, x,
                          0.0) for x in xs]
        return xs + [torch.where(ok, den, 1.0)]

    for i in range(svv):
        v, pdf_v = integrate.sample_v_to_distance(o, d, hp, s, e,
                                                  u[..., 2 * i])
        up, pdf_u = integrate.kulla_sampling(o, hp, v, u[..., 2 * i + 1])
        pdf = pdf_v * pdf_u
        d_uv2, d_uv, vu = segment(up, v)
        ok = pair_ok & (d_uv2 > 0.0) & (pdf > 0.0)
        ok = ok & ~_occluded_packed(up, v, tris)
        d_sv = m.distance(s, v)
        d_eu = m.distance(o, up)
        path = d_eu + d_uv + d_sv
        vu, path, d_sv, pdf_d2 = masked(ok, vu, path, d_sv, pdf * d_uv2)
        geo = phase(-vu, -d) * phase(-uv, vu) / torch.clamp(pdf_d2,
                                                            min=1e-30)
        if grid is not None:
            up, v = (torch.where(ok[..., None], x, x0)
                     for x, x0 in ((up, o), (v, s)))
            d_eu, d_uv = (torch.where(ok, x, 0.0) for x in (d_eu, d_uv))
            od_sv = gmed.interp_od(vrl_od, d_sv / vlen)
            od = gmed.interp_od(eye_od, d_eu / elen) + od_uv(up, v, d_uv) \
                + od_sv
            term = pw * (sig_s * density(v)[..., None]) \
                * (sig_s * density(up)[..., None]) \
                * torch.exp(-sig_t * od[..., None]) * grid_geo(geo, od_sv)
            yield VV, torch.where(ok[..., None], term, 0.0)
            continue
        if short_vrls:
            geo = geo / torch.clamp(pdf_failure(d_sv), min=1e-30)
        term = pw * sig_s * sig_s * torch.exp(-sig_t * path[..., None]) \
            * geo[..., None]
        yield VV, torch.where(ok[..., None], term, 0.0)

    shade = None
    if mats is None:
        alb_any = alb.sum(dim=-1) > 0.0
    else:
        materials, kinds, smooth = mats
        row = pk.MATID if grid is None else pk.GRID_MATID
        mat_id = rays[row].long().clamp(0, smooth.shape[0] - 1)[:, None]
        alb_any = smooth[mat_id]
        if pk.is_textured(rays):  # the hit's Shading
            from alvrl_tpu_torch.bsdf.api import Shading

            ns, alb0 = pk.tex_rows(rays)
            shade = Shading(*(rows(rays, r)[:, None] for r in (
                ns, alb0, alb0 + 3, alb0 + 6)))
    for k in range(svs):
        v, pdf_v = integrate.kulla_sampling(s, e, hp, u[..., 2 * svv + k])
        d_uv2, d_uv, vu = segment(hp, v)
        ok = pair_ok & alb_any & (d_uv2 > 0.0) & (pdf_v > 0.0)
        ok = ok & ~_occluded_packed(hp, v, tris)
        vu, d_uv, d_sv, pdf_d2 = masked(ok, vu, d_uv, m.distance(s, v),
                                        pdf_v * d_uv2)
        if mats is None:  # albedo cos_o / pi
            cos_o = torch.clamp(m.dot(ng, -vu), min=0.0)
            f, geo = alb, phase(-uv, vu) * cos_o * (1.0 / math.pi)
        else:  # the hit's smooth BSDF
            # 0 where masked, so that a non-finite eval there cannot reach
            # the gradient
            f = torch.where(ok[..., None], integrate.bsdf_eval_smooth(
                materials, mat_id, ng, -d, -vu, kinds, shade), 0.0)
            geo = phase(-uv, vu)
        geo = geo / torch.clamp(pdf_d2, min=1e-30)
        if grid is not None:
            v = torch.where(ok[..., None], v, s)
            od_sv = gmed.interp_od(vrl_od, d_sv / vlen)
            od = od_uv(hp, v, d_uv) + od_sv
            term = pw * (sig_s * density(v)[..., None]) * f * tau \
                * torch.exp(-sig_t * od[..., None]) * grid_geo(geo, od_sv)
            yield VS, torch.where(ok[..., None], term, 0.0)
            continue
        if short_vrls:
            geo = geo / torch.clamp(pdf_failure(d_sv), min=1e-30)
        term = pw * sig_s * f * tau \
            * torch.exp(-sig_t * (d_uv + d_sv)[..., None]) * geo[..., None]
        yield VS, torch.where(ok[..., None], term, 0.0)


def _pair_sums(rays, vrls, tris, medium, u, svv, svs, short_vrls,
               phase_kind, grid=None, mats=None):
    """(R, 3) sums over the VRLs for a block of R rays: each family's
    samples averaged, the families added (see _pair_terms)."""
    total = torch.zeros((rays.shape[1], 1, 3), dtype=rays.dtype,
                        device=rays.device)
    for family, term in _pair_terms(rays, vrls, tris, medium, u, svv, svs,
                                    short_vrls, phase_kind, grid, mats):
        total = total + term * (1.0 / (svv if family == VV else svs))
    return total.sum(dim=1)


def _reference(rays, vrls, tris, medium, uniforms, svv, svs, short_vrls,
               phase_kind, grid, materials=None):
    n_rays = rays.shape[1]
    out = torch.zeros((3, n_rays), dtype=rays.dtype, device=rays.device)
    mats = _plain_materials(materials)
    for b0 in range(0, n_rays, _PLAIN_RAY_CHUNK):
        b1 = min(n_rays, b0 + _PLAIN_RAY_CHUNK)
        out[:, b0:b1] = _pair_sums(
            rays[:, b0:b1], vrls, tris, medium, uniforms[b0:b1], svv, svs,
            short_vrls, phase_kind, grid, mats).T
    return out


def vrl_sum_reference(rays, vrls, tris, medium, uniforms, *,
                      vol_vol_samples=2, vol_surf_samples=2,
                      short_vrls=True, phase_kind=ph.HG, weight=None,
                      materials=None):
    """Plain PyTorch version of the kernel on the same packs, with
    explicit (B, N, 2 * vol_vol_samples + vol_surf_samples) uniforms.
    Rays go in blocks of _PLAIN_RAY_CHUNK, so it fits at full size.
    `weight`, (B, 3), multiplies each ray's sums: a specular chain's path
    weight, which the reference's vrl_sum folds into every VRL power
    (the sum is linear in it). `materials`, the material pack (vrl_sum's),
    takes the material instantiation's sum on rays (MAT_RAY_ROWS, B)."""
    out = _reference(rays, vrls, tris, medium, uniforms, vol_vol_samples,
                     vol_surf_samples, short_vrls, phase_kind, None,
                     materials)
    return out if weight is None else out * weight.T


def vrl_sum_hetero_reference(rays, vrls, tris, medium, density, uniforms, *,
                             vol_vol_samples=2, vol_surf_samples=2,
                             short_vrls=True, phase_kind=ph.HG, uv_steps=4,
                             weight=None, materials=None):
    """vrl_sum_reference on grid packs (ops.pack's GRID_* layouts) and the
    supersampled density (2Z - 1, 2Y - 1, 2X - 1), or with the trilinear
    medium pack the density (Z, Y, X): the plain version of either form
    of kernel 3; with `materials` (rays (GRID_MAT_RAY_ROWS, B)), of its
    material forms."""
    out = _reference(rays, vrls, tris, medium, uniforms, vol_vol_samples,
                     vol_surf_samples, short_vrls, phase_kind,
                     (density, uv_steps), materials)
    return out if weight is None else out * weight.T


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

def grid_args(density, uv_steps):
    """The grid kernels' extra C arguments: the density pointer, its
    (Z, Y, X) extents and the U-V quadrature's step count."""
    return (density.data_ptr(), *density.shape, uv_steps)


# kernel 1's modes (alvrl_vrl_sum's `mode`): the sum, the checking
# instantiation, the sweep without the pre-reject (timing only)
MODE_SUM, MODE_CHECK, MODE_NO_REJECT = 0, 1, 2
# the checking launch's counts (vrl_sum_check), in the kernel's order
CHECK_COUNTS = ("segments", "considered", "skipped", "bad_tris",
                "bad_segments")


def mat_args(materials):
    """The C entries' material arguments (table, M, rt_tables): the
    material pack's pointers and row count, or none (the diffuse
    instantiation)."""
    if materials is None:
        return (None, 0, None)
    table, rt_tables = materials
    return (table.data_ptr(), table.shape[0], rt_tables.data_ptr())


def tex_arg(rays, materials):
    """The C entries' `tex` argument of kernels 1-7: 1 for the textured
    form (a material pack with a textured ray pack), else 0."""
    return int(materials is not None and pk.is_textured(rays))


def _launch(lib, rays, vrls, tris, medium, uniforms, seed, svv, svs,
            short_vrls, phase_kind, grid=None, mode=MODE_SUM, counts=None,
            materials=None):
    """The kernel on checked inputs. Homogeneous packs: kernel 1 in
    `mode` (MODE_CHECK adds its counts to `counts`, (len(CHECK_COUNTS),)
    int64); either medium's material instantiation with `materials`."""
    n_rays, n_vrls = rays.shape[1], vrls.shape[1]
    n_chunks = -(-n_vrls // lib.alvrl_vrl_chunk())
    partial = torch.empty((n_chunks, 3, n_rays), dtype=torch.float32,
                          device=rays.device)
    out = torch.empty((3, n_rays), dtype=torch.float32, device=rays.device)
    if grid is None:
        medium = pk.extended_medium(medium)
    head = (rays.data_ptr(), n_rays, vrls.data_ptr(), n_vrls,
            tris.data_ptr(), tris.shape[0], medium.data_ptr())
    uni = (None if uniforms is None else uniforms.data_ptr(), seed, svv,
           svs, int(short_vrls), phase_kind)
    tail = (partial.data_ptr(), n_chunks, out.data_ptr(),
            torch.cuda.current_stream(rays.device).cuda_stream)
    if grid is None:
        planes = torch.empty((tris.shape[0], 4 * lib.alvrl_plane_f4()),
                             dtype=torch.float32, device=rays.device)
        err = lib.alvrl_vrl_sum(
            *head, *mat_args(materials), tex_arg(rays, materials), *uni,
            planes.data_ptr() if tris.shape[0] else None, mode,
            None if counts is None else counts.data_ptr(), *tail)
    else:
        err = lib.alvrl_vrl_sum_hetero(*head, *mat_args(materials),
                                       tex_arg(rays, materials),
                                       *grid_args(*grid),
                                       int(pk.is_trilinear(medium)), *uni,
                                       *tail)
    if err != 0:
        raise RuntimeError("vrl_sum kernel launch failed: CUDA error "
                           f"{err} ({lib.alvrl_error_string(err).decode()})")
    return out


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load_library()
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    uni, tail = [p, u, i, i, i, i], [p, i, p, p]
    lib.alvrl_vrl_sum.argtypes = [p, i, p, i, p, i, p, p, i, p, i, *uni, p,
                                  i, p, *tail]
    lib.alvrl_vrl_sum_hetero.argtypes = [p, i, p, i, p, i, p, p, i, p, i, p,
                                         i, i, i, i, i, *uni, *tail]
    lib.alvrl_plane_pack.argtypes = [p, i, p, p]
    for fn in (lib.alvrl_vrl_sum, lib.alvrl_vrl_sum_hetero,
               lib.alvrl_vrl_chunk, lib.alvrl_max_tris, lib.alvrl_uv_steps,
               lib.alvrl_plane_f4, lib.alvrl_plane_pack, lib.alvrl_max_mats):
        fn.restype = i
    lib.alvrl_error_string.argtypes = [i]
    lib.alvrl_error_string.restype = ctypes.c_char_p
    return lib


def compiled_uv_steps():
    """The U-V step count for which the library compiles the grid sum and
    its VJP (UV_STEPS); a launch of any other count takes their generic
    instantiation. It should be VRLConfig().uv_tau_steps, every caller's
    count."""
    return _library().alvrl_uv_steps()


def occupancy(entry, grid, n_tris, uv_steps=4, phase_kind=ph.HG,
              short_vrls=True):
    """Blocks per SM, by cudaOccupancyMaxActiveBlocksPerMultiprocessor,
    of the instantiation that a launch of the kernel behind the C entry
    `entry` ("vrl_sum", "vrl_sum_bwd", "vrl_sum_clustered",
    "vrl_sum_clustered_bwd" or "vrl_r") takes with these arguments: grid
    or homogeneous medium, n_tris triangles, the U-V quadrature's step
    count (a grid launch of 4 steps takes the instantiation compiled for
    4), phase kind and short VRLs. A block is the library's
    alvrl_ray_block() threads."""
    fn = getattr(_library(), f"alvrl_{entry}_occupancy")
    i = ctypes.c_int
    fn.argtypes = [i, i, i, i, i, ctypes.POINTER(i)]
    fn.restype = i
    blocks = i(0)
    err = fn(int(grid), n_tris, uv_steps, phase_kind, int(short_vrls),
             ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {err}")
    return blocks.value


def _check(rays, vrls, tris, medium, uniforms, seed, svv, svs, phase_kind,
           n_cols=None, grid=None, materials=None, textured=False):
    """Raise on what the kernels do not take. The uniforms must be
    (B, n_cols, 2 * svv + svs), n_cols the VRL count by default. grid =
    (density, uv_steps) for the grid packs, whose rows ops.pack's GRID_*
    constants give, with the supersampled density (2Z - 1, 2Y - 1,
    2X - 1), or with the trilinear medium pack the density (Z, Y, X), at
    least 2 a side. materials = (table, rt_tables), ops.pack.
    pack_materials', for the material instantiations: rays (MAT_RAY_ROWS,
    B), or in a grid medium (GRID_MAT_RAY_ROWS, B). A homogeneous medium
    may come in the extended pack (the mixture phase, another strategy
    than balance); a grid medium has neither. textured: the kernel has a
    textured form (the forward kernels 1-7), which takes a material pack
    with the textured ray pack (TEX_RAY_ROWS, B), or in a grid medium
    the grid one (GRID_TEX_RAY_ROWS, B); the backward kernels refuse a
    textured pack by name (ROADMAP A11a)."""
    named = dict(rays=rays, vrls=vrls, tris=tris, medium=medium)
    if uniforms is not None:
        named["uniforms"] = uniforms
    if grid is not None:
        named["density"] = grid[0]
    if materials is not None:
        named["mat_table"], named["rt_tables"] = materials
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != rays.device:
            raise ValueError(f"{name} is on {t.device}, rays on {rays.device}")
    if rays.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rays.device}")
    ray_rows, vrl_rows, med_len = (
        (pk.RAY_ROWS, pk.VRL_ROWS, pk.MED_LEN) if grid is None
        else (pk.GRID_RAY_ROWS, pk.GRID_VRL_ROWS, pk.GRID_MED_LEN))
    if materials is not None:
        ray_rows = pk.MAT_RAY_ROWS if grid is None else pk.GRID_MAT_RAY_ROWS
        if pk.is_textured(rays):
            if not textured:
                raise ValueError("this kernel has no textured form: the "
                                 "textured ray packs go to the forward "
                                 "kernels 1-7 only (ROADMAP A11a, the "
                                 "textured forms of kernels 8-11)")
            ray_rows = (pk.TEX_RAY_ROWS if grid is None
                        else pk.GRID_TEX_RAY_ROWS)
        table, rt_tables = materials
        n_mats = table.shape[0]
        if table.dim() != 2 or table.shape[1] != pk.MAT_COLS or n_mats < 1:
            raise ValueError(f"mat_table must be (M >= 1, {pk.MAT_COLS}), "
                             f"got {tuple(table.shape)}")
        if tuple(rt_tables.shape) != (n_mats, RT_COS, RT_ALPHA):
            raise ValueError(f"rt_tables must be ({n_mats}, {RT_COS}, "
                             f"{RT_ALPHA}), got {tuple(rt_tables.shape)}")
    if rays.dim() != 2 or rays.shape[0] != ray_rows:
        raise ValueError(f"rays must be ({ray_rows}, B), got "
                         f"{tuple(rays.shape)}")
    if vrls.dim() != 2 or vrls.shape[0] != vrl_rows:
        raise ValueError(f"vrls must be ({vrl_rows}, N), got "
                         f"{tuple(vrls.shape)}")
    if tris.dim() != 2 or tris.shape[1] != pk.TRI_COLS:
        raise ValueError(f"tris must be (T, {pk.TRI_COLS}), got "
                         f"{tuple(tris.shape)}")
    extended = grid is None and medium.dim() == 1 \
        and medium.shape[0] > pk.MED_LEN
    if extended or phase_kind == ph.MIXTURE:
        if grid is not None:
            raise ValueError("a grid medium has no mixture phase")
        if not extended or medium.shape[0] < pk.MED_MIX \
                or (medium.shape[0] - pk.MED_MIX) % 3:
            raise ValueError(f"an extended medium pack is ({pk.MED_MIX} + "
                             f"3 K,), got {tuple(medium.shape)}")
        if phase_kind == ph.MIXTURE and medium.shape[0] == pk.MED_MIX:
            raise ValueError("a mixture phase needs its components in the "
                             "medium pack")
    elif tuple(medium.shape) != (med_len,) and not (
            grid is not None and medium.dim() == 1
            and pk.is_trilinear(medium)):
        raise ValueError(f"medium must be ({med_len},), got "
                         f"{tuple(medium.shape)}")
    if grid is not None:
        density, uv_steps = grid
        least = 2 if pk.is_trilinear(medium) else 1
        if density.dim() != 3 or min(density.shape) < least:
            raise ValueError(f"density must be a (Z, Y, X) grid of at least "
                             f"{least} a side, got {tuple(density.shape)}")
        if uv_steps < 1:
            raise ValueError(f"uv_steps must be >= 1, got {uv_steps}")
    if svv < 0 or svs < 0:
        raise ValueError("sample counts must be >= 0")
    n_cols = vrls.shape[1] if n_cols is None else n_cols
    shape = (rays.shape[1], n_cols, 2 * svv + svs)
    if uniforms is not None and tuple(uniforms.shape) != shape:
        raise ValueError(f"uniforms must be {shape}, got "
                         f"{tuple(uniforms.shape)}")
    if phase_kind not in (ph.HG, ph.RAYLEIGH, ph.MIXTURE):
        raise ValueError(f"phase kind {phase_kind} is not ported to the "
                         "kernels (the oriented kinds: volpath only)")
    if not 0 <= seed <= _MASK32:
        raise ValueError(f"seed {seed} is not a uint32")


def check_mats_cap(lib, materials):
    """Raise if a material table exceeds the kernels' shared-memory cap."""
    if materials is not None and materials[0].shape[0] > lib.alvrl_max_mats():
        raise ValueError(f"{materials[0].shape[0]} materials exceed the "
                         f"kernels' shared-memory cap of "
                         f"{lib.alvrl_max_mats()}")


def _sum(fn, rays, vrls, tris, medium, seed, uniforms, svv, svs, short_vrls,
         phase_kind, grid, materials=None):
    """The wrappers' body: checks, then the plain version on the CPU or
    the kernel on the card, counting its launch on `fn`."""
    _check(rays, vrls, tris, medium, uniforms, seed, svv, svs, phase_kind,
           grid=grid, materials=materials, textured=True)
    n_rays, n_vrls = rays.shape[1], vrls.shape[1]
    if rays.device.type == "cpu":
        if uniforms is None:
            uniforms = philox_uniforms(seed, n_rays, n_vrls, 2 * svv + svs)
        return _reference(rays, vrls, tris, medium, uniforms, svv, svs,
                          short_vrls, phase_kind, grid, materials)
    lib = _library()
    if tris.shape[0] > lib.alvrl_max_tris():
        raise ValueError(f"{tris.shape[0]} triangles exceed the kernel's "
                         f"shared-memory cap of {lib.alvrl_max_tris()}")
    check_mats_cap(lib, materials)
    if n_rays == 0 or n_vrls == 0:
        return torch.zeros((3, n_rays), dtype=torch.float32,
                           device=rays.device)
    with torch.cuda.device(rays.device):
        out = _launch(lib, rays, vrls, tris, medium, uniforms, seed, svv,
                      svs, short_vrls, phase_kind, grid, materials=materials)
    count_launch(fn, grid, medium, materials, rays)
    return out


def count_launch(fn, grid, medium, materials=None, rays=None):
    """One launch on the wrapper fn: fn.launches, and each form counter
    that fn has and the launch's form takes: tri_launches (a grid
    medium's trilinear pack), mat_launches (a material pack),
    mix_launches (the homogeneous pack's extension: the mixture, a
    strategy's rate) and tex_launches (the textured ray pack `rays`)."""
    fn.launches += 1
    forms = {"tri_launches": grid is not None and pk.is_trilinear(medium),
             "mat_launches": materials is not None,
             "mix_launches": grid is None and medium.shape[0] > pk.MED_LEN,
             "tex_launches": (materials is not None and rays is not None
                              and pk.is_textured(rays))}
    for name, taken in forms.items():
        if taken and hasattr(fn, name):
            setattr(fn, name, getattr(fn, name) + 1)


def vrl_sum(rays, vrls, tris, medium, *, seed=0, uniforms=None,
            vol_vol_samples=2, vol_surf_samples=2, short_vrls=True,
            phase_kind=ph.HG, materials=None):
    """(3, B) per-ray VRL sums (not normalised by the particle count).

    rays (RAY_ROWS, B), vrls (VRL_ROWS, N), tris (T, TRI_COLS) and
    medium (MED_LEN,) are the packs of ops.pack, float32 and contiguous,
    on one device. Random numbers come from the Philox stream of `seed`,
    or from `uniforms` (B, N, 2 * vol_vol_samples + vol_surf_samples)
    when given. `materials`, the material pack (ops.pack.pack_materials'
    (table, rt_tables)) with rays (MAT_RAY_ROWS, B), takes the material
    instantiation, which evaluates each eye hit's smooth BSDF, with the
    textured ray pack (TEX_RAY_ROWS, B) the textured form (counted on
    vrl_sum.tex_launches too); without it the diffuse one, which reads
    the ALB rows. CUDA tensors go through the CUDA kernel, CPU tensors
    through vrl_sum_reference."""
    return _sum(vrl_sum, rays, vrls, tris, medium, seed, uniforms,
                vol_vol_samples, vol_surf_samples, short_vrls, phase_kind,
                None, materials)


vrl_sum.launches = 0  # kernel launches, for showing that a run used the kernel
vrl_sum.tex_launches = 0  # of them, the textured form's


def vrl_sum_check(rays, vrls, tris, medium, *, seed=0, uniforms=None,
                  vol_vol_samples=2, vol_surf_samples=2, short_vrls=True,
                  phase_kind=ph.HG, materials=None):
    """vrl_sum's sums through kernel 1's checking instantiation (a launch
    counted here, not on vrl_sum), which decides every shadow segment by
    the Wald test alone and also runs the plane pre-reject beside it,
    and {name: total} of CHECK_COUNTS: shadow segments, triangles the
    sweep tests (up to its first blocker), those the pre-reject skips,
    skipped triangles that block (must be 0) and segments the two
    decide differently (must be 0). CUDA tensors only; `materials` as
    vrl_sum's."""
    svv, svs = vol_vol_samples, vol_surf_samples
    _check(rays, vrls, tris, medium, uniforms, seed, svv, svs, phase_kind,
           materials=materials, textured=True)
    if rays.device.type != "cuda":
        raise ValueError("the checking launch needs CUDA tensors")
    counts = torch.zeros(len(CHECK_COUNTS), dtype=torch.int64,
                         device=rays.device)
    with torch.cuda.device(rays.device):
        out = _launch(_library(), rays, vrls, tris, medium, uniforms, seed,
                      svv, svs, short_vrls, phase_kind, mode=MODE_CHECK,
                      counts=counts, materials=materials)
    vrl_sum_check.launches += 1
    return out, dict(zip(CHECK_COUNTS, counts.tolist()))


vrl_sum_check.launches = 0  # checking launches, as vrl_sum.launches


def plane_pack_kernel(tris):
    """(T, 16) float32: the plane pack that kernel 1 makes of tris on the
    card (plane_pack's kernel; T >= 1, CUDA tensors only)."""
    out = torch.empty((tris.shape[0], 16), dtype=torch.float32,
                      device=tris.device)
    with torch.cuda.device(tris.device):
        err = _library().alvrl_plane_pack(
            tris.data_ptr(), tris.shape[0], out.data_ptr(),
            torch.cuda.current_stream(tris.device).cuda_stream)
    if err != 0:
        raise RuntimeError("plane_pack kernel launch failed: CUDA error "
                           f"{err}")
    return out


def vrl_sum_hetero(rays, vrls, tris, medium, density, *, seed=0,
                   uniforms=None, vol_vol_samples=2, vol_surf_samples=2,
                   short_vrls=True, phase_kind=ph.HG, uv_steps=4,
                   materials=None):
    """vrl_sum in a grid medium: rays (GRID_RAY_ROWS, B), vrls
    (GRID_VRL_ROWS, N) and medium (GRID_MED_LEN,) are ops.pack's grid
    packs, density the supersampled grid (2Z - 1, 2Y - 1, 2X - 1)
    (media.heterogeneous.upsample2), uv_steps the U-V quadrature's steps
    (4, every caller's, runs the kernel's instantiation compiled for 4
    steps; any other count its generic one); the random stream is
    vrl_sum's. With the trilinear medium pack (GRID_TRI_MED_LEN,) of a
    medium of fast_tau False, density is the grid itself (Z, Y, X)
    (media.heterogeneous.quad_grid), and the kernel's trilinear form
    (the run-time step count) reads it. `materials`, the material pack
    (vrl_sum's) with rays (GRID_MAT_RAY_ROWS, B), takes the material
    form of either read (at the run-time step count), which evaluates
    each eye hit's smooth BSDF, with the grid textured ray pack
    (GRID_TEX_RAY_ROWS, B) the textured form of either read. CUDA tensors
    go through the CUDA kernel (a launch of its own, counted here, on
    vrl_sum_hetero.tri_launches for the trilinear forms, on
    vrl_sum_hetero.mat_launches for the material and textured forms and
    on vrl_sum_hetero.tex_launches for the textured ones), CPU tensors
    through vrl_sum_hetero_reference."""
    return _sum(vrl_sum_hetero, rays, vrls, tris, medium, seed, uniforms,
                vol_vol_samples, vol_surf_samples, short_vrls, phase_kind,
                (density, uv_steps), materials)


vrl_sum_hetero.launches = 0  # kernel launches, as vrl_sum.launches
vrl_sum_hetero.tri_launches = 0  # of them, the trilinear form's
vrl_sum_hetero.mat_launches = 0  # of them, the material forms'
vrl_sum_hetero.tex_launches = 0  # of them, the textured forms'


# ---------------------------------------------------------------------------
# Agreement bar
# ---------------------------------------------------------------------------

HOMOG_MEDIAN = 1e-5  # bar on the median relative error
HOMOG_SHARE = 0.02   # bar on the share of rays over 1e-2
HOMOG_FLOOR = 1e-3   # smallest |ref| a relative error divides by


def homog_bar(out, ref, channels=3):
    """(median, share over 1e-2) of the per-item relative error between
    two homogeneous results with channels last, (..., channels): the
    largest channel error |out - ref| / max(|ref|, HOMOG_FLOOR) of each
    ray (or, with channels=1, of each entry, as for the transfer
    matrix). The bar is median < HOMOG_MEDIAN and share < HOMOG_SHARE:
    the sums agree to f32 rounding, except for the few items where the
    two pipelines round one occlusion-edge test differently."""
    return _median_share(_homog_rel(out, ref, channels))


def homog_bar_by_kind(out, ref, kind, channels=3):
    """homog_bar of each group of items that share a value of `kind`, an
    integer per item (a ray's eye-hit material kind, say): {kind: (items,
    median, share)}. Each group is held to the bar alone, so that a group
    of a few hundred rays cannot hide among the frame's."""
    rel = _homog_rel(out, ref, channels)
    kind = kind.reshape(-1).to(rel.device)
    return {k: (int((kind == k).sum()), *_median_share(rel[kind == k]))
            for k in sorted(set(kind.tolist()))}


def _homog_rel(out, ref, channels):
    rel = (out - ref).abs() / torch.clamp(ref.abs(), min=HOMOG_FLOOR)
    return rel.reshape(-1, channels).amax(dim=-1).double()


def _median_share(rel):
    return float(rel.median()), float((rel > 1e-2).double().mean())
