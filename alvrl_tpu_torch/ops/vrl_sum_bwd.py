"""The VJP of the VRL x eye-ray sum, and the differentiable sum.

Replaces the unclustered part of alvrl_tpu/ops/vrl_pallas_bwd.py:
vrl_sum_pallas_bwd and vrl_sum_pallas_hetero_bwd (the body
`_bwd_kernel` with clustered=False, hetero False or True) and the
custom VJPs vrl_sum_diff and vrl_sum_hetero_diff. The backward replays
the forward's samples (the same Philox stream, or the same injected
uniforms) and returns the cotangents of what the sum is differentiable
in:

    d_power (3, N)  the VP rows of the VRL pack;
    d_par           the medium pack's entries: homogeneous (8,), sigma_t
                    0:3, sigma_s 3:6 and g 6 (7 is 0: the sampling
                    weight is a stored constant), and with the pack's
                    extension (a mixture phase, a strategy's rate;
                    ops.pack.pack_medium) (MED_RHO + 1,), the rate's
                    cotangent at MED_RHO, through which sigma_t chains
                    on the autograd side (media.homogeneous
                    sampling_density), g's 0 for the mixture, whose
                    components are constants; grid (GRID_MED_LEN,),
                    sigma_t_color 0:3, sigma_s_color 3:6, g 6, chan 7
                    and the density scale at GRID_MED_LEN - 1 (box and
                    index entries are 0);
    d_tau   (3, B)  the TAU rows (eye-to-surface transmittance) of the
                    ray pack, through which sigma_t chains on the
                    autograd side;
and in a grid medium also
    d_eod (NQ + 1, B), d_vod (NQ + 1, N)  the eye and VRL cumulative-OD
                    table rows of the grid packs, through which the
                    density voxels and the scale chain on the autograd
                    side (ops.pack.pack_rays_hetero, pack_vrls_hetero);
    d_density       the supersampled density grid the kernel reads: the
                    exact derivative of the port's direct-grid forward,
                    where the reference returns CP-factor cotangents
                    (ROADMAP C9, C10).

Geometry is detached, as in the reference. Every cotangent is computed
as a product, never as a quotient by the value it differentiates: the
reference's divisions (gt / max(pw, 1e-30) * (pw != 0) and the like)
give 0 wherever a power, sigma_s or tau channel is 0, which is wrong for
a term linear in it (ROADMAP C7).

Every scene the forward kernels take has its backward form, as the
forward's (ops.vrl_sum): `materials` (a glossy or layered table, the
material forms, counted on the wrappers' `mat_launches`), the extended
medium pack (kernel 8's extended forms, on `mix_launches`) and the
trilinear grid medium pack of fast_tau False (kernel 9's trilinear
forms, on `tri_launches`; d_density is then the density's own). The
JAX package's Pallas backward evaluates none of them (HG(g) under
balance, no glossy term, CP reads: ROADMAP C22); the port follows its
XLA route, which its train step differentiates.

Beside the kernel (csrc/vrl_sum_bwd.cu):
  * `vrl_sum_bwd_reference` and `vrl_sum_hetero_bwd_reference`, the
    plain versions: torch.autograd.grad through the plain forward
    (ops.vrl_sum._pair_sums), independent of the kernel's hand-derived
    algebra;
  * `vrl_sum_bwd` and `vrl_sum_hetero_bwd`, the wrappers: the kernel for
    CUDA tensors (or an error), the plain version for CPU tensors;
  * `vrl_sum_diff` and `vrl_sum_hetero_diff`, the differentiable sums:
    one torch.autograd.Function around the sum of either medium and its
    backward wrapper.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from alvrl_tpu_torch.media import phase as ph
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops import vrl_sum as vs
from alvrl_tpu_torch.ops import vrl_sum_clustered as vsc

N_PAR = 8  # d_par: sigma_t (3), sigma_s (3), g, sampling weight (0)
N_OD = pk.NQ + 1  # rows of a cumulative-OD table
# the grid medium pack's differentiable entries: sigma_t_color,
# sigma_s_color, g, chan; and the density scale
GRID_PAR = (slice(0, 8), slice(pk.GRID_MED_LEN - 1, pk.GRID_MED_LEN))


def _leaf_rows(pack, rows):
    """(the pack with its rows `rows` taken from a new leaf, the leaf)."""
    leaf = pack[rows].clone().requires_grad_()
    out = pack.clone()
    out[rows] = leaf
    return out, leaf


def _med_rows(medium, grid):
    """The medium pack's differentiable entries (slices): homogeneous
    sigma_t, sigma_s, g, and the rate of the extended pack; grid
    GRID_PAR."""
    if grid is not None:
        return list(GRID_PAR)
    if medium.shape[0] > pk.MED_LEN:
        return [slice(0, 7), slice(pk.MED_RHO, pk.MED_RHO + 1)]
    return [slice(0, 7)]


def _d_par(medium, grid, med_rows, d_med):
    """d_par from the medium entries' cotangents: (8,), (MED_RHO + 1,)
    for the extended pack, or (GRID_MED_LEN,)."""
    d_par = torch.zeros((_n_par(medium, grid),), dtype=medium.dtype,
                        device=medium.device)
    for r, d in zip(med_rows, d_med):
        d_par[r] = d
    return d_par


def _plain_vjp(rays, vrls, tris, medium, gbar, uniforms, ray_rows, vrl_rows,
               med_rows, svv, svs, short_vrls, phase_kind, grid=None,
               tables=None, materials=None):
    """torch.autograd.grad of sum(gbar * the plain sums) in blocks of
    ops.vrl_sum's _PLAIN_RAY_CHUNK rays, with leaves at the rows
    `ray_rows` of each block of the ray pack, `vrl_rows` of the VRL
    pack and `med_rows` of the medium pack (lists of slices), and, with
    grid = (density, uv_steps), the density. With tables = (ray rows
    (B,) int64, table ids (S, C), table weights (S, C)), the sums are
    the clustered ones (ops.vrl_sum_clustered's gather of each ray's
    table row), with a leaf at the table weights too; with `materials`,
    the material forms' sums. Returns the ray rows' cotangents (B
    columns each), the VRL rows', the medium entries', the density's
    and the table weights' (None without a grid or tables)."""
    rays, vrls, tris, medium, gbar = (
        t.detach() for t in (rays, vrls, tris, medium, gbar))
    mats = vs._plain_materials(materials)
    n_rays = rays.shape[1]
    d_ray = [torch.zeros_like(rays[r]) for r in ray_rows]
    d_vrl = [torch.zeros_like(vrls[r]) for r in vrl_rows]
    d_med = [torch.zeros_like(medium[r]) for r in med_rows]
    density = d_density = weights = d_weights = None
    if grid is not None:
        density = grid[0].detach().requires_grad_()
        d_density = torch.zeros_like(density)
    if tables is not None:
        weights = tables[2].detach().requires_grad_()
        d_weights = torch.zeros_like(weights)
    with torch.enable_grad():
        for b0 in range(0, n_rays, vs._PLAIN_RAY_CHUNK):
            b1 = min(n_rays, b0 + vs._PLAIN_RAY_CHUNK)
            ray_b, leaves = rays[:, b0:b1], []
            for r in ray_rows:
                ray_b, leaf = _leaf_rows(ray_b, r)
                leaves.append(leaf)
            vrl_b, med_b = vrls, medium
            for r in vrl_rows:
                vrl_b, leaf = _leaf_rows(vrl_b, r)
                leaves.append(leaf)
            for r in med_rows:
                med_b, leaf = _leaf_rows(med_b, r)
                leaves.append(leaf)
            if grid is not None:
                leaves.append(density)
            if tables is not None:
                leaves.append(weights)
                vrl_b = vsc._gather_tables(vrl_b, tables[0][b0:b1],
                                           tables[1], weights)
            out = vs._pair_sums(
                ray_b, vrl_b, tris, med_b, uniforms[b0:b1], svv, svs,
                short_vrls, phase_kind,
                None if grid is None else (density, grid[1]), mats)
            grads = list(torch.autograd.grad(
                (out * gbar[:, b0:b1].T).sum(), leaves, allow_unused=True,
                materialize_grads=True))
            for d in d_ray:
                d[:, b0:b1] = grads.pop(0)
            for d in d_vrl + d_med:
                d += grads.pop(0)
            if grid is not None:
                d_density += grads.pop(0)
            if tables is not None:
                d_weights += grads.pop(0)
    return d_ray, d_vrl, d_med, d_density, d_weights


def vrl_sum_bwd_reference(rays, vrls, tris, medium, gbar, uniforms, *,
                          vol_vol_samples=2, vol_surf_samples=2,
                          short_vrls=True, phase_kind=ph.HG, materials=None):
    """Plain version of the backward: the cotangents (d_power, d_par,
    d_tau) of vrl_sum_reference for the output cotangent gbar (3, B),
    with explicit uniforms (B, N, 2 * vol_vol_samples +
    vol_surf_samples). Rays go in blocks of ops.vrl_sum's
    _PLAIN_RAY_CHUNK; the leaves are the VP rows, medium[0:7] (and the
    extended pack's rate) and the TAU rows of each block. `materials` as
    vrl_sum_reference's (rays (MAT_RAY_ROWS, B))."""
    med_rows = _med_rows(medium, None)
    (d_tau,), (d_power,), d_med, _, _ = _plain_vjp(
        rays, vrls, tris, medium, gbar, uniforms,
        [slice(pk.TAU, pk.TAU + 3)], [slice(pk.VP, pk.VP + 3)], med_rows,
        vol_vol_samples, vol_surf_samples, short_vrls, phase_kind,
        materials=materials)
    return d_power, _d_par(medium, None, med_rows, d_med), d_tau


def vrl_sum_hetero_bwd_reference(rays, vrls, tris, medium, density, gbar,
                                 uniforms, *, vol_vol_samples=2,
                                 vol_surf_samples=2, short_vrls=True,
                                 phase_kind=ph.HG, uv_steps=4,
                                 materials=None):
    """Plain version of the grid backward: the cotangents (d_power, d_par
    (GRID_MED_LEN,), d_tau, d_eod, d_vod, d_density) of
    vrl_sum_hetero_reference for the output cotangent gbar (3, B), with
    explicit uniforms, in either read (the trilinear medium pack with
    the density itself). The leaves are the VP and VOD rows, the
    medium's GRID_PAR entries, the TAU and EOD rows of each block of
    rays, and the density. `materials` as vrl_sum_hetero_reference's."""
    grid = (density, uv_steps)
    med_rows = _med_rows(medium, grid)
    (d_tau, d_eod), (d_power, d_vod), d_med, d_density, _ = _plain_vjp(
        rays, vrls, tris, medium, gbar, uniforms,
        [slice(pk.TAU, pk.TAU + 3), slice(pk.EOD, pk.EOD + N_OD)],
        [slice(pk.VP, pk.VP + 3), slice(pk.VOD, pk.VOD + N_OD)], med_rows,
        vol_vol_samples, vol_surf_samples, short_vrls, phase_kind, grid,
        materials=materials)
    return (d_power, _d_par(medium, grid, med_rows, d_med), d_tau, d_eod,
            d_vod, d_density)


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    lib = vs._library()
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    head, mat, uni = [p, i, p, i, p, i, p], [p, i, p], [p, u, i, i, i, i, p]
    tail = [p, i, p, i, p, p, p, p]
    lib.alvrl_vrl_sum_bwd.argtypes = [*head, *mat, i, *uni, p, *tail, p]
    lib.alvrl_vrl_sum_hetero_bwd.argtypes = [*head, *mat, p, i, i, i, i, i,
                                             *uni, *tail, p, p]
    for fn in (lib.alvrl_vrl_sum_bwd, lib.alvrl_vrl_sum_hetero_bwd,
               lib.alvrl_ray_block):
        fn.restype = i
    return lib


def _n_par(medium, grid):
    """d_par's length: 8, MED_RHO + 1 for the extended pack, or
    GRID_MED_LEN."""
    if grid is not None:
        return pk.GRID_MED_LEN
    return pk.MED_RHO + 1 if medium.shape[0] > pk.MED_LEN else N_PAR


def _launch(lib, rays, vrls, tris, medium, gbar, uniforms, seed, svv, svs,
            short_vrls, phase_kind, grid=None, materials=None):
    """The backward kernel: (d_power, d_par, d_tau), and with grid =
    (density, uv_steps) also (d_eod, d_vod, d_density); the form the
    packs ask for (the extended pack, the trilinear grid pack) and, with
    `materials`, its material form."""
    n_rays, n_vrls = rays.shape[1], vrls.shape[1]
    n_chunks = -(-n_vrls // lib.alvrl_vrl_chunk())
    n_ray_blocks = -(-n_rays // lib.alvrl_ray_block())
    rows = 3 if grid is None else 3 + N_OD
    n_par = _n_par(medium, grid)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=rays.device)

    # per-VRL-chunk per-ray rows, per-ray-block per-VRL rows, per-block
    # d_par partials
    ray_part = empty(n_chunks, rows, n_rays)
    vrl_part = empty(n_ray_blocks, rows, n_vrls)
    par_part = empty(n_ray_blocks * n_chunks, n_par)
    d_vrl, d_par, d_ray = empty(rows, n_vrls), empty(n_par), empty(rows, n_rays)
    head = (rays.data_ptr(), n_rays, vrls.data_ptr(), n_vrls, tris.data_ptr(),
            tris.shape[0], medium.data_ptr(), *vs.mat_args(materials))
    uni = (None if uniforms is None else uniforms.data_ptr(), seed, svv, svs,
           int(short_vrls), phase_kind, gbar.data_ptr())
    tail = (ray_part.data_ptr(), n_chunks, vrl_part.data_ptr(), n_ray_blocks,
            par_part.data_ptr(), d_vrl.data_ptr(), d_par.data_ptr(),
            d_ray.data_ptr())
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    if grid is None:
        # the triangles' plane pack, which the kernel sweeps (kernel 1's)
        planes = empty(tris.shape[0], 4 * lib.alvrl_plane_f4())
        err = lib.alvrl_vrl_sum_bwd(
            *head, int(medium.shape[0] > pk.MED_LEN), *uni,
            planes.data_ptr() if tris.shape[0] else None, *tail, stream)
    else:
        d_density = torch.empty_like(grid[0])
        err = lib.alvrl_vrl_sum_hetero_bwd(
            *head, *vs.grid_args(*grid), int(pk.is_trilinear(medium)), *uni,
            *tail, d_density.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("vrl_sum_bwd kernel launch failed: CUDA error "
                           f"{err} ({lib.alvrl_error_string(err).decode()})")
    if grid is None:
        return d_vrl, d_par, d_ray
    return d_vrl[:3], d_par, d_ray[:3], d_ray[3:], d_vrl[3:], d_density


def _check_gbar(rays, gbar):
    if not isinstance(gbar, torch.Tensor) or gbar.dtype != torch.float32 \
            or not gbar.is_contiguous() or gbar.device != rays.device:
        raise TypeError("gbar must be a contiguous float32 tensor on the "
                        "rays' device")
    if tuple(gbar.shape) != (3, rays.shape[1]):
        raise ValueError(f"gbar must be (3, {rays.shape[1]}), got "
                         f"{tuple(gbar.shape)}")


def _bwd(fn, rays, vrls, tris, medium, gbar, seed, uniforms, svv, svs,
         short_vrls, phase_kind, grid, materials=None):
    """The wrappers' body: checks, then the plain version on the CPU or
    the kernel on the card, counting its launch (and form) on `fn`."""
    vs._check(rays, vrls, tris, medium, uniforms, seed, svv, svs, phase_kind,
              grid=grid, materials=materials)
    _check_gbar(rays, gbar)
    n_rays, n_vrls = rays.shape[1], vrls.shape[1]
    kw = dict(vol_vol_samples=svv, vol_surf_samples=svs,
              short_vrls=short_vrls, phase_kind=phase_kind,
              materials=materials)
    if rays.device.type == "cpu":
        if uniforms is None:
            uniforms = vs.philox_uniforms(seed, n_rays, n_vrls, 2 * svv + svs)
        if grid is None:
            return vrl_sum_bwd_reference(rays, vrls, tris, medium, gbar,
                                         uniforms, **kw)
        return vrl_sum_hetero_bwd_reference(rays, vrls, tris, medium,
                                            grid[0], gbar, uniforms,
                                            uv_steps=grid[1], **kw)
    lib = _library()
    if tris.shape[0] > lib.alvrl_max_tris():
        raise ValueError(f"{tris.shape[0]} triangles exceed the kernel's "
                         f"shared-memory cap of {lib.alvrl_max_tris()}")
    vs.check_mats_cap(lib, materials)
    if n_rays == 0 or n_vrls == 0:
        f32 = dict(dtype=torch.float32, device=rays.device)
        out = (torch.zeros((3, n_vrls), **f32),
               torch.zeros((_n_par(medium, grid),), **f32),
               torch.zeros((3, n_rays), **f32))
        if grid is None:
            return out
        return (*out, torch.zeros((N_OD, n_rays), **f32),
                torch.zeros((N_OD, n_vrls), **f32), torch.zeros_like(grid[0]))
    with torch.cuda.device(rays.device):
        out = _launch(lib, rays, vrls, tris, medium, gbar, uniforms, seed,
                      svv, svs, short_vrls, phase_kind, grid, materials)
    vs.count_launch(fn, grid, medium, materials)
    return out


def vrl_sum_bwd(rays, vrls, tris, medium, gbar, *, seed=0, uniforms=None,
                vol_vol_samples=2, vol_surf_samples=2, short_vrls=True,
                phase_kind=ph.HG, materials=None):
    """(d_power (3, N), d_par (8,, or MED_RHO + 1 for the extended
    pack), d_tau (3, B)): the VJP of ops.vrl_sum.vrl_sum at the output
    cotangent gbar (3, B), float32 and contiguous like the packs, on the
    same samples as the forward of the same seed (or uniforms), with
    vrl_sum's `materials`. CUDA tensors go through the CUDA kernel (its
    material forms counted on vrl_sum_bwd.mat_launches, its extended
    ones on vrl_sum_bwd.mix_launches), CPU tensors through
    vrl_sum_bwd_reference."""
    return _bwd(vrl_sum_bwd, rays, vrls, tris, medium, gbar, seed, uniforms,
                vol_vol_samples, vol_surf_samples, short_vrls, phase_kind,
                None, materials)


vrl_sum_bwd.launches = 0  # kernel launches, for showing that a run used it
vrl_sum_bwd.mat_launches = 0  # of them, the material forms'
vrl_sum_bwd.mix_launches = 0  # of them, the extended forms'


def vrl_sum_hetero_bwd(rays, vrls, tris, medium, density, gbar, *, seed=0,
                       uniforms=None, vol_vol_samples=2, vol_surf_samples=2,
                       short_vrls=True, phase_kind=ph.HG, uv_steps=4,
                       materials=None):
    """(d_power (3, N), d_par (GRID_MED_LEN,), d_tau (3, B), d_eod
    (NQ + 1, B), d_vod (NQ + 1, N), d_density (the density's shape)):
    the VJP of ops.vrl_sum.vrl_sum_hetero at the output cotangent gbar
    (3, B), on the same samples as the forward of the same seed (or
    uniforms), in either read and with vrl_sum_hetero's `materials`.
    CUDA tensors go through the grid instantiation of the CUDA kernel (a
    launch of its own, counted here; the nearest diffuse form at 4
    steps, every caller's, is the one compiled for 4, any other count
    and the trilinear and material forms the generic one; counted on
    vrl_sum_hetero_bwd.tri_launches and .mat_launches too), CPU tensors
    through vrl_sum_hetero_bwd_reference. d_power and d_vod are summed
    over the ray blocks in float64 (ROADMAP C12)."""
    return _bwd(vrl_sum_hetero_bwd, rays, vrls, tris, medium, gbar, seed,
                uniforms, vol_vol_samples, vol_surf_samples, short_vrls,
                phase_kind, (density, uv_steps), materials)


vrl_sum_hetero_bwd.launches = 0  # kernel launches, as vrl_sum_bwd.launches
vrl_sum_hetero_bwd.tri_launches = 0  # of them, the trilinear forms'
vrl_sum_hetero_bwd.mat_launches = 0  # of them, the material forms'


# ---------------------------------------------------------------------------
# Differentiable sums
# ---------------------------------------------------------------------------

def medium_cot(medium, d_par):
    """The medium pack's cotangent from d_par (the pack's leading
    entries; 0 beyond: the mixture's components, the trilinear tag)."""
    if d_par.shape[0] == medium.shape[0]:
        return d_par
    d_med = torch.zeros_like(medium)
    d_med[:d_par.shape[0]] = d_par
    return d_med


class _VRLSumDiff(torch.autograd.Function):
    """vrl_sum (density None) or vrl_sum_hetero (density the supersampled
    grid, or the density of the trilinear pack), with their backward
    wrappers as the VJP."""

    @staticmethod
    def forward(ctx, rays, vrls, tris, medium, density, uniforms, kw):
        ctx.save_for_backward(rays, vrls, tris, medium, density, uniforms)
        ctx.kw = kw
        if density is None:
            return vs.vrl_sum(rays, vrls, tris, medium, uniforms=uniforms,
                              **kw)
        return vs.vrl_sum_hetero(rays, vrls, tris, medium, density,
                                 uniforms=uniforms, **kw)

    @staticmethod
    def backward(ctx, gbar):
        rays, vrls, tris, medium, density, uniforms = ctx.saved_tensors
        d_rays, d_vrls = torch.zeros_like(rays), torch.zeros_like(vrls)
        if density is None:
            d_power, d_par, d_tau = vrl_sum_bwd(
                rays, vrls, tris, medium, gbar.contiguous(),
                uniforms=uniforms, **ctx.kw)
            d_density = None
        else:
            d_power, d_par, d_tau, d_eod, d_vod, d_density = \
                vrl_sum_hetero_bwd(rays, vrls, tris, medium, density,
                                   gbar.contiguous(), uniforms=uniforms,
                                   **ctx.kw)
            d_rays[pk.EOD:pk.EOD + N_OD] = d_eod
            d_vrls[pk.VOD:pk.VOD + N_OD] = d_vod
        d_rays[pk.TAU:pk.TAU + 3] = d_tau
        d_vrls[pk.VP:pk.VP + 3] = d_power
        # d_par is 0 at the entries the sums are not differentiated in
        # (the sampling weight; the box and index entries)
        return (d_rays, d_vrls, None, medium_cot(medium, d_par), d_density,
                None, None)


def vrl_sum_diff(rays, vrls, tris, medium, *, seed=0, uniforms=None,
                 vol_vol_samples=2, vol_surf_samples=2, short_vrls=True,
                 phase_kind=ph.HG, materials=None):
    """ops.vrl_sum.vrl_sum, differentiable in the VP rows of `vrls`, the
    TAU rows of `rays`, medium[0:7] and, in the extended pack, the rate
    medium[MED_RHO], through vrl_sum_bwd (the seed-replay VJP); the
    other rows and the triangles get no gradient (the detached-geometry
    contract of the reference's vrl_sum_diff), nor does the material
    pack, `materials` (vrl_sum's)."""
    kw = dict(seed=seed, vol_vol_samples=vol_vol_samples,
              vol_surf_samples=vol_surf_samples, short_vrls=short_vrls,
              phase_kind=phase_kind, materials=materials)
    return _VRLSumDiff.apply(rays, vrls, tris, medium, None, uniforms, kw)


def vrl_sum_hetero_diff(rays, vrls, tris, medium, density, *, seed=0,
                        uniforms=None, vol_vol_samples=2, vol_surf_samples=2,
                        short_vrls=True, phase_kind=ph.HG, uv_steps=4,
                        materials=None):
    """ops.vrl_sum.vrl_sum_hetero, differentiable through
    vrl_sum_hetero_bwd in the VP and VOD rows of `vrls`, the TAU and EOD
    rows of `rays`, the medium pack's GRID_PAR entries and the density
    (the supersample, or the trilinear pack's density itself); the
    geometry rows, the box and index entries, the triangles and the
    material pack, `materials`, get no gradient (the reference's
    detached-geometry contract)."""
    kw = dict(seed=seed, vol_vol_samples=vol_vol_samples,
              vol_surf_samples=vol_surf_samples, short_vrls=short_vrls,
              phase_kind=phase_kind, uv_steps=uv_steps, materials=materials)
    return _VRLSumDiff.apply(rays, vrls, tris, medium, density, uniforms, kw)
