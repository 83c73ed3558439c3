"""The VJP of the clustered VRL sum, and the differentiable clustered sum.

Replaces alvrl_tpu/ops/vrl_pallas_bwd.py:vrl_sum_pallas_clustered_bwd and
vrl_sum_pallas_hetero_clustered_bwd (the body `_bwd_kernel` with
clustered=True, hetero False or True) and the custom VJPs
vrl_sum_clustered_diff and vrl_sum_hetero_clustered_diff. The backward
replays the clustered forward's samples (ops.vrl_sum_clustered: the same
Philox stream, counter (ray, VRL id, call), or the same uniforms indexed
by ray and table column) and returns the cotangents of what the sum is
differentiable in: those of ops.vrl_sum_bwd (d_power (3, N), d_par, d_tau
(3, B); in a grid medium d_eod, d_vod and d_density), and

    d_weights (S, C)  the table weights.

The reference returns cotangents of its materialised per-slice tables
(weights folded into the power rows) and leaves the chain to the table
build (vrl_pallas_bwd.py:1368-1371). The port's tables are VRL ids and
weights over the full VRL pack, so the chain is done here:
d_weights[s, c] = sum_ch d_table_pw[s, ch, c] power[ch, id],
d_power[:, id] += w[s, c] d_table_pw[s, :, c] and, in a grid medium,
d_vod[:, id] += d_table_vod[s, :, c]; a column that is not valid (an id
outside [0, N), an invalid VRL, or a weight <= 0) gives nothing, as the
reference's valid = vrls.valid[idx] & (tw > 0) (integrator.py:412)
implies. The table ids and the rays' rows are detached (the clustering
is host numpy), and so is the geometry, as in the reference. Like the
reference's, the grid VJP takes no CP factors and no density multiplier
(ROADMAP C9, C10). Every form of ops.vrl_sum_bwd is here too: the
material forms (`materials`), kernel 10's extended forms (the mixture,
a strategy's rate, whose d_par ends at the rate's entry) and kernel
11's trilinear forms, counted on the wrappers' `mat_launches`,
`mix_launches` and `tri_launches`.

Beside the kernel (csrc/vrl_sum_clustered_bwd.cu, whose header gives
the design: the homogeneous one in tiles of 32 rays, whose host layout
`host_layout` builds at the library's `ray_block`, sweeping kernel 1's
plane pack with its pre-reject):
  * `vrl_sum_clustered_bwd_reference` and
    `vrl_sum_hetero_clustered_bwd_reference`, the plain versions:
    torch.autograd.grad through the plain clustered forward (its gather
    and ops.vrl_sum._pair_sums), independent of the kernel's algebra;
  * `vrl_sum_clustered_bwd` and `vrl_sum_hetero_clustered_bwd`, the
    wrappers: the kernel for CUDA tensors (or an error), the plain
    version for CPU tensors;
  * `vrl_sum_clustered_diff` and `vrl_sum_hetero_clustered_diff`, the
    differentiable clustered sums: one torch.autograd.Function around
    ops.vrl_sum_clustered's wrappers and these backward wrappers.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from alvrl_tpu_torch.media import phase as ph
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops import vrl_sum as vs
from alvrl_tpu_torch.ops import vrl_sum_bwd as bwd
from alvrl_tpu_torch.ops import vrl_sum_clustered as vsc


def _plain(rays, vrls, tris, medium, ray_slice, table_ids, table_weights,
           gbar, uniforms, svv, svs, short_vrls, phase_kind, grid,
           materials=None):
    rows = torch.as_tensor(ray_slice, device=rays.device).long()
    ray_rows = [slice(pk.TAU, pk.TAU + 3)]
    vrl_rows = [slice(pk.VP, pk.VP + 3)]
    med_rows = bwd._med_rows(medium, grid)
    if grid is not None:
        ray_rows.append(slice(pk.EOD, pk.EOD + bwd.N_OD))
        vrl_rows.append(slice(pk.VOD, pk.VOD + bwd.N_OD))
    d_ray, d_vrl, d_med, d_density, d_weights = bwd._plain_vjp(
        rays, vrls, tris, medium, gbar, uniforms, ray_rows, vrl_rows,
        med_rows, svv, svs, short_vrls, phase_kind, grid,
        (rows, table_ids, table_weights), materials)
    d_par = bwd._d_par(medium, grid, med_rows, d_med)
    if grid is None:
        return d_vrl[0], d_par, d_ray[0], d_weights
    return (d_vrl[0], d_par, d_ray[0], d_ray[1], d_vrl[1], d_density,
            d_weights)


def vrl_sum_clustered_bwd_reference(rays, vrls, tris, medium, ray_slice,
                                    table_ids, table_weights, gbar, uniforms,
                                    *, vol_vol_samples=2, vol_surf_samples=2,
                                    short_vrls=True, phase_kind=ph.HG,
                                    materials=None):
    """Plain version of the backward: the cotangents (d_power (3, N),
    d_par (8,, or MED_RHO + 1 for the extended pack), d_tau (3, B),
    d_weights (S, C)) of vrl_sum_clustered_reference for the output
    cotangent gbar (3, B), with explicit uniforms (B, C, 2 *
    vol_vol_samples + vol_surf_samples) indexed by ray and table column.
    The leaves are the VP rows, medium[0:7] (and the extended pack's
    rate), the table weights and the TAU rows of each block of rays.
    `materials` as vrl_sum_clustered_reference's."""
    return _plain(rays, vrls, tris, medium, ray_slice, table_ids,
                  table_weights, gbar, uniforms, vol_vol_samples,
                  vol_surf_samples, short_vrls, phase_kind, None, materials)


def vrl_sum_hetero_clustered_bwd_reference(
        rays, vrls, tris, medium, density, ray_slice, table_ids,
        table_weights, gbar, uniforms, *, vol_vol_samples=2,
        vol_surf_samples=2, short_vrls=True, phase_kind=ph.HG, uv_steps=4,
        materials=None):
    """Plain version of the grid backward: the cotangents (d_power, d_par
    (GRID_MED_LEN,), d_tau, d_eod (NQ + 1, B), d_vod (NQ + 1, N),
    d_density, d_weights (S, C)) of vrl_sum_hetero_clustered_reference,
    in either read; the leaves also take in the VOD and EOD rows, the
    medium's GRID_PAR entries and the density. `materials` as
    vrl_sum_hetero_clustered_reference's."""
    return _plain(rays, vrls, tris, medium, ray_slice, table_ids,
                  table_weights, gbar, uniforms, vol_vol_samples,
                  vol_surf_samples, short_vrls, phase_kind,
                  (density, uv_steps), materials)


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    lib = vs._library()
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    tables = [p, p, i, p, i, p, p, i, p, p, p, u, i, i, i, i, p]
    scratch, head = [p, p, p], [p, i, p, i, p, i, p, p, i, p]
    lib.alvrl_vrl_sum_clustered_bwd.argtypes = [
        *head, i, *tables, p, i, *scratch, p, p, p, p, p]
    lib.alvrl_vrl_sum_hetero_clustered_bwd.argtypes = [
        *head, p, i, i, i, i, i, *tables, *scratch, p, p, p, p, p, p]
    lib.alvrl_clustered_bwd_ray_block.argtypes = [i]
    for fn in (lib.alvrl_vrl_sum_clustered_bwd,
               lib.alvrl_vrl_sum_hetero_clustered_bwd,
               lib.alvrl_clustered_bwd_ray_block):
        fn.restype = i
    return lib


def ray_block(grid):
    """The rays of a tile of the backward kernel, homogeneous (grid
    False) or grid medium: host_layout's ray_block."""
    return _library().alvrl_clustered_bwd_ray_block(int(grid))


def host_layout(ray_slice, table_ids, n_vrls, ray_block, device):
    """The kernel's host-built layout, on `device`: group_by_slice's
    (tile_rays, tile_row), row_tiles (S + 1,) int32 each table row's
    first tile (a row's tiles are contiguous), and the table slots by
    VRL id: slots, the flat s * C + c of every slot whose id lies in [0,
    N), grouped by id in slot order, and slot_start (N + 1,) int32 each
    id's first. Tables are fixed per pass, so this is host work."""
    tile_rays, tile_row = vsc.group_by_slice(ray_slice, ray_block)
    n_rows = table_ids.shape[0]
    row_tiles = np.searchsorted(tile_row, np.arange(n_rows + 1))
    ids = np.asarray(table_ids.cpu()).reshape(-1).astype(np.int64)
    held = np.flatnonzero((ids >= 0) & (ids < n_vrls))
    slots = held[np.argsort(ids[held], kind="stable")]
    slot_start = np.searchsorted(ids[slots], np.arange(n_vrls + 1))
    return tuple(torch.as_tensor(np.asarray(a, np.int32)).to(device)
                 for a in (tile_rays, tile_row, row_tiles, slots, slot_start))


def _launch(lib, rays, vrls, tris, medium, layout, table_ids, table_weights,
            uniforms, seed, svv, svs, short_vrls, phase_kind, gbar,
            grid=None, mode=vs.MODE_SUM, materials=None):
    """The kernel on inputs the wrapper has checked, with host_layout's
    tensors (at ray_block(grid is not None)); on the current stream; grid
    = (density, uv_steps) for the grid kernel; homogeneous, mode
    vs.MODE_NO_REJECT sweeps without the plane pre-reject (the checking
    launch of the diffuse balance forms: the same outputs bit for bit);
    the form the packs ask for and, with `materials`, its material form.
    Returns (d_power, d_par,
    d_tau, d_weights), or for grid media (d_power, d_par, d_tau, d_eod,
    d_vod, d_density, d_weights). The wrapper's own step, apart so that
    chip_smoke.py can time the kernel without the wrapper's host work; it
    counts no launch."""
    tile_rays, tile_row, row_tiles, slots, slot_start = layout
    n_rays, n_vrls = rays.shape[1], vrls.shape[1]
    n_rows, n_cols = table_ids.shape
    rows = 3 if grid is None else 3 + bwd.N_OD
    n_par = bwd._n_par(medium, grid)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=rays.device)

    n_tiles = len(tile_row)
    tile_part, par_part = empty(n_tiles, rows, n_cols), empty(n_tiles, n_par)
    d_table = empty(n_rows, rows, n_cols)
    d_ray, d_vrl = empty(rows, n_rays), empty(rows, n_vrls)
    d_weights, d_par = empty(n_rows, n_cols), empty(n_par)
    head = (rays.data_ptr(), n_rays, vrls.data_ptr(), n_vrls, tris.data_ptr(),
            tris.shape[0], medium.data_ptr(), *vs.mat_args(materials))
    tables = (tile_rays.data_ptr(), tile_row.data_ptr(), n_tiles,
              row_tiles.data_ptr(), n_rows, table_ids.data_ptr(),
              table_weights.data_ptr(), n_cols, slots.data_ptr(),
              slot_start.data_ptr(),
              None if uniforms is None else uniforms.data_ptr(), seed, svv,
              svs, int(short_vrls), phase_kind, gbar.data_ptr())
    scratch = (tile_part.data_ptr(), par_part.data_ptr(), d_table.data_ptr())
    tail = (d_ray.data_ptr(), d_vrl.data_ptr(), d_weights.data_ptr(),
            d_par.data_ptr())
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    if grid is None:
        planes = empty(tris.shape[0], 4 * lib.alvrl_plane_f4())
        err = lib.alvrl_vrl_sum_clustered_bwd(
            *head, int(medium.shape[0] > pk.MED_LEN), *tables,
            planes.data_ptr() if tris.shape[0] else None, mode, *scratch,
            *tail, stream)
    else:
        d_density = torch.empty_like(grid[0])
        err = lib.alvrl_vrl_sum_hetero_clustered_bwd(
            *head, *vs.grid_args(*grid), int(pk.is_trilinear(medium)),
            *tables, *scratch, *tail, d_density.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("vrl_sum_clustered_bwd kernel launch failed: CUDA "
                           f"error {err} "
                           f"({lib.alvrl_error_string(err).decode()})")
    if grid is None:
        return d_vrl, d_par, d_ray, d_weights
    return (d_vrl[:3], d_par, d_ray[:3], d_ray[3:], d_vrl[3:], d_density,
            d_weights)


def _zeros(rays, vrls, medium, table_ids, grid):
    """The outputs of a launch with nothing to do."""
    f32 = dict(dtype=torch.float32, device=rays.device)
    n_rays, n_vrls = rays.shape[1], vrls.shape[1]
    d_weights = torch.zeros(tuple(table_ids.shape), **f32)
    if grid is None:
        return (torch.zeros((3, n_vrls), **f32),
                torch.zeros((bwd._n_par(medium, None),), **f32),
                torch.zeros((3, n_rays), **f32), d_weights)
    return (torch.zeros((3, n_vrls), **f32),
            torch.zeros((pk.GRID_MED_LEN,), **f32),
            torch.zeros((3, n_rays), **f32),
            torch.zeros((bwd.N_OD, n_rays), **f32),
            torch.zeros((bwd.N_OD, n_vrls), **f32),
            torch.zeros_like(grid[0]), d_weights)


def _clustered_bwd(fn, rays, vrls, tris, medium, ray_slice, table_ids,
                   table_weights, gbar, seed, uniforms, svv, svs, short_vrls,
                   phase_kind, grid, materials=None):
    """The wrappers' body: checks, then the plain version on the CPU or
    the kernel on the card, counting its launch (and form) on `fn`."""
    if not isinstance(table_ids, torch.Tensor) or table_ids.dim() != 2:
        raise TypeError("table_ids must be a 2-D int32 tensor")
    vs._check(rays, vrls, tris, medium, uniforms, seed, svv, svs, phase_kind,
              n_cols=table_ids.shape[1], grid=grid, materials=materials)
    sl = vsc._check_tables(rays, ray_slice, table_ids, table_weights)
    bwd._check_gbar(rays, gbar)
    if rays.device.type == "cpu":
        if uniforms is None:
            uniforms = vsc.philox_table_uniforms(seed, sl, table_ids,
                                                 2 * svv + svs)
        return _plain(rays, vrls, tris, medium, sl, table_ids, table_weights,
                      gbar, uniforms, svv, svs, short_vrls, phase_kind, grid,
                      materials)
    lib = _library()
    if tris.shape[0] > lib.alvrl_max_tris():
        raise ValueError(f"{tris.shape[0]} triangles exceed the kernel's "
                         f"shared-memory cap of {lib.alvrl_max_tris()}")
    vs.check_mats_cap(lib, materials)
    n_vrls = vrls.shape[1]
    if n_vrls == 0 or table_ids.numel() == 0 or not (sl >= 0).any():
        return _zeros(rays, vrls, medium, table_ids, grid)
    layout = host_layout(sl, table_ids, n_vrls, ray_block(grid is not None),
                         rays.device)
    with torch.cuda.device(rays.device):
        out = _launch(lib, rays, vrls, tris, medium, layout, table_ids,
                      table_weights, uniforms, seed, svv, svs, short_vrls,
                      phase_kind, gbar, grid, materials=materials)
    vs.count_launch(fn, grid, medium, materials)
    return out


def vrl_sum_clustered_bwd(rays, vrls, tris, medium, ray_slice, table_ids,
                          table_weights, gbar, *, seed=0, uniforms=None,
                          vol_vol_samples=2, vol_surf_samples=2,
                          short_vrls=True, phase_kind=ph.HG, materials=None):
    """(d_power (3, N), d_par (8,, or MED_RHO + 1 for the extended pack),
    d_tau (3, B), d_weights (S, C)): the VJP of
    ops.vrl_sum_clustered.vrl_sum_clustered at the output cotangent gbar
    (3, B) (float32, contiguous, on the rays' device), on the same
    samples as the forward of the same seed (or uniforms), with its
    `materials`. CUDA tensors go through the CUDA kernel (its material
    and extended forms counted on .mat_launches and .mix_launches too),
    CPU tensors through vrl_sum_clustered_bwd_reference."""
    return _clustered_bwd(vrl_sum_clustered_bwd, rays, vrls, tris, medium,
                          ray_slice, table_ids, table_weights, gbar, seed,
                          uniforms, vol_vol_samples, vol_surf_samples,
                          short_vrls, phase_kind, None, materials)


vrl_sum_clustered_bwd.launches = 0  # kernel launches, for showing that a
                                    # run used the kernel
vrl_sum_clustered_bwd.mat_launches = 0  # of them, the material forms'
vrl_sum_clustered_bwd.mix_launches = 0  # of them, the extended forms'


def vrl_sum_hetero_clustered_bwd(rays, vrls, tris, medium, density,
                                 ray_slice, table_ids, table_weights, gbar, *,
                                 seed=0, uniforms=None, vol_vol_samples=2,
                                 vol_surf_samples=2, short_vrls=True,
                                 phase_kind=ph.HG, uv_steps=4,
                                 materials=None):
    """(d_power (3, N), d_par (GRID_MED_LEN,), d_tau (3, B), d_eod
    (NQ + 1, B), d_vod (NQ + 1, N), d_density (the density's shape),
    d_weights (S, C)): the VJP of
    ops.vrl_sum_clustered.vrl_sum_hetero_clustered at gbar (3, B), in
    either read and with its `materials`. CUDA tensors go through the
    grid instantiation of the CUDA kernel (a launch of its own, counted
    here, and on .tri_launches and .mat_launches for the trilinear and
    material forms), CPU tensors through
    vrl_sum_hetero_clustered_bwd_reference."""
    return _clustered_bwd(vrl_sum_hetero_clustered_bwd, rays, vrls, tris,
                          medium, ray_slice, table_ids, table_weights, gbar,
                          seed, uniforms, vol_vol_samples, vol_surf_samples,
                          short_vrls, phase_kind, (density, uv_steps),
                          materials)


vrl_sum_hetero_clustered_bwd.launches = 0  # kernel launches, as
                                           # vrl_sum_clustered_bwd.launches
vrl_sum_hetero_clustered_bwd.tri_launches = 0  # of them, the trilinear forms'
vrl_sum_hetero_clustered_bwd.mat_launches = 0  # of them, the material forms'


# ---------------------------------------------------------------------------
# Differentiable clustered sums
# ---------------------------------------------------------------------------

class _ClusteredDiff(torch.autograd.Function):
    """vrl_sum_clustered (density None) or vrl_sum_hetero_clustered
    (density the grid the kernels read), with their backward wrappers as
    the VJP."""

    @staticmethod
    def forward(ctx, rays, vrls, tris, medium, density, table_weights,
                ray_slice, table_ids, uniforms, kw):
        ctx.save_for_backward(rays, vrls, tris, medium, density,
                              table_weights, table_ids, uniforms)
        ctx.ray_slice, ctx.kw = ray_slice, kw
        args = (ray_slice, table_ids, table_weights)
        if density is None:
            return vsc.vrl_sum_clustered(rays, vrls, tris, medium, *args,
                                         uniforms=uniforms, **kw)
        return vsc.vrl_sum_hetero_clustered(rays, vrls, tris, medium, density,
                                            *args, uniforms=uniforms, **kw)

    @staticmethod
    def backward(ctx, gbar):
        (rays, vrls, tris, medium, density, table_weights, table_ids,
         uniforms) = ctx.saved_tensors
        args = (ctx.ray_slice, table_ids, table_weights, gbar.contiguous())
        d_rays, d_vrls = torch.zeros_like(rays), torch.zeros_like(vrls)
        if density is None:
            d_power, d_par, d_tau, d_weights = vrl_sum_clustered_bwd(
                rays, vrls, tris, medium, *args, uniforms=uniforms, **ctx.kw)
            d_density = None
        else:
            d_power, d_par, d_tau, d_eod, d_vod, d_density, d_weights = \
                vrl_sum_hetero_clustered_bwd(rays, vrls, tris, medium,
                                             density, *args,
                                             uniforms=uniforms, **ctx.kw)
            d_rays[pk.EOD:pk.EOD + bwd.N_OD] = d_eod
            d_vrls[pk.VOD:pk.VOD + bwd.N_OD] = d_vod
        d_rays[pk.TAU:pk.TAU + 3] = d_tau
        d_vrls[pk.VP:pk.VP + 3] = d_power
        return (d_rays, d_vrls, None, bwd.medium_cot(medium, d_par),
                d_density, d_weights, None, None, None, None)


def vrl_sum_clustered_diff(rays, vrls, tris, medium, ray_slice, table_ids,
                           table_weights, *, seed=0, uniforms=None,
                           vol_vol_samples=2, vol_surf_samples=2,
                           short_vrls=True, phase_kind=ph.HG, materials=None):
    """ops.vrl_sum_clustered.vrl_sum_clustered, differentiable through
    vrl_sum_clustered_bwd in the VP rows of `vrls`, the TAU rows of
    `rays`, medium[0:7] (and the extended pack's rate) and the table
    weights; the ids, the rays' rows, the other pack rows, the triangles
    and the material pack, `materials`, get no gradient (the reference's
    contract)."""
    kw = dict(seed=seed, vol_vol_samples=vol_vol_samples,
              vol_surf_samples=vol_surf_samples, short_vrls=short_vrls,
              phase_kind=phase_kind, materials=materials)
    return _ClusteredDiff.apply(rays, vrls, tris, medium, None, table_weights,
                                ray_slice, table_ids, uniforms, kw)


def vrl_sum_hetero_clustered_diff(rays, vrls, tris, medium, density,
                                  ray_slice, table_ids, table_weights, *,
                                  seed=0, uniforms=None, vol_vol_samples=2,
                                  vol_surf_samples=2, short_vrls=True,
                                  phase_kind=ph.HG, uv_steps=4,
                                  materials=None):
    """ops.vrl_sum_clustered.vrl_sum_hetero_clustered, differentiable
    through vrl_sum_hetero_clustered_bwd in the VP and VOD rows of
    `vrls`, the TAU and EOD rows of `rays`, the medium pack's GRID_PAR
    entries, the table weights and the density (either read); the ids,
    the rays' rows, the geometry rows, the box and index entries, the
    triangles and `materials` get no gradient."""
    kw = dict(seed=seed, vol_vol_samples=vol_vol_samples,
              vol_surf_samples=vol_surf_samples, short_vrls=short_vrls,
              phase_kind=phase_kind, uv_steps=uv_steps, materials=materials)
    return _ClusteredDiff.apply(rays, vrls, tris, medium, density,
                                table_weights, ray_slice, table_ids, uniforms,
                                kw)
