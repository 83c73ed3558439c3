"""The clustered VRL x eye-ray sum: each eye ray against the
representatives of its slice (Adaptive LightSlice).

Replaces alvrl_tpu/ops/vrl_pallas.py:vrl_sum_pallas_clustered and, for
grid media, vrl_sum_pallas_hetero_clustered (the grid estimator of
ops.vrl_sum; each column's VRL-OD rows gathered by id from the full
grid VRL pack, as the other rows are). Each ray
b sums the estimator of ops.vrl_sum over row ray_slice[b] of a table of
VRL ids (S, C) int32 and weights (S, C) float32, a column's weight
multiplied into the VRL's power (weights enter linearly) and a column
valid where its VRL is valid and its weight is > 0 (integrator.py:412,
422); an id outside [0, N) counts as invalid. Rays with row -1 are left
out and sum to 0. Out (3, B) float32 in ray order, not normalised by
the particle count.

What bounds it on the H100 is fp32 ALU and special-function throughput,
as for ops.vrl_sum; the CUDA kernel (csrc/vrl_sum_clustered.cu, whose
header gives the design) takes rays grouped by row into tiles
(group_by_slice, on the host, as the JAX render groups pixels) of
ray_block(grid) rays: 32 in a homogeneous medium (a warp's lanes over
the rays, the block's warps over the row's columns), 128 in a grid
medium (a thread a ray). It gathers each tile's table from the full VRL
pack and sweeps the triangles' plane pack with kernel 1's plane
pre-reject.

Beside the kernel:
  * `vrl_sum_clustered_reference` and
    `vrl_sum_hetero_clustered_reference`, the plain PyTorch versions on
    the same inputs and explicit uniforms (B, C, D) indexed by ray and
    table column, summing ops.vrl_sum's per-sample terms over each ray's
    gathered table;
  * `vrl_sum_clustered` and `vrl_sum_hetero_clustered`, the wrappers:
    the kernel for CUDA tensors (or an error; there is no fallback), the
    plain version for CPU tensors.
    Its Philox stream is vrl_sum's with counter (ray, VRL id, call, 0),
    independent of the grouping and the table layout;
  * `vrl_sum_clustered_check` and `vrl_sum_hetero_clustered_check`, the
    kernels' checking launches (CUDA only): their shadow segments
    decided by the Wald test alone, with the counts of the plane
    pre-reject that their sum instantiations sweep with (as
    ops.vrl_sum.vrl_sum_check for kernel 1); `_launch(...,
    mode=vs.MODE_NO_REJECT)` is the homogeneous kernel's sweep without
    the pre-reject, whose output must be the kernel's bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from alvrl_tpu_torch.media import phase as ph
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops import vrl_sum as vs


def group_by_slice(ray_slice, ray_block):
    """Host grouping of the rays by table row into tiles of ray_block
    slots: (tile_rays (n_tiles * ray_block,) int32, the ray index of each
    slot or -1 for padding; tile_row (n_tiles,) int32, each tile's row).
    Rows ascend; within a row the rays keep their order. Rays with row
    -1 are in no tile."""
    sl = np.asarray(ray_slice, np.int64)
    kept = np.flatnonzero(sl >= 0)
    order = kept[np.argsort(sl[kept], kind="stable")]
    rows, first, counts = np.unique(sl[order], return_index=True,
                                    return_counts=True)
    tiles = -(-counts // ray_block)
    tile_start = (np.cumsum(tiles) - tiles) * ray_block
    rank = np.arange(len(order)) - np.repeat(first, counts)
    tile_rays = np.full(int(tiles.sum()) * ray_block, -1, np.int32)
    tile_rays[np.repeat(tile_start, counts) + rank] = order
    return tile_rays, np.repeat(rows, tiles).astype(np.int32)


def _gather_tables(vrls, rows, table_ids, table_weights):
    """(rows of vrls, R, C) pack of each ray's table row (row -1: all
    invalid), weights folded into the power rows; a grid pack's VRL-OD
    rows come along."""
    n_vrls = vrls.shape[1]
    kept = rows >= 0
    r = rows.clamp(min=0)
    ids = table_ids[r].long()
    w = torch.where(kept[:, None], table_weights[r], 0.0)
    id_ok = (ids >= 0) & (ids < n_vrls)
    g = vrls[:, ids.clamp(0, n_vrls - 1)]
    pw = g[pk.VP:pk.VP + 3] * w
    valid = ((g[pk.VVALID] > 0.5) & id_ok & (w > 0.0)).to(g.dtype)
    return torch.cat([g[:pk.VP], pw, valid[None], g[pk.VVALID + 1:]])


def _reference(rays, vrls, tris, medium, ray_slice, table_ids,
               table_weights, uniforms, svv, svs, short_vrls, phase_kind,
               grid, materials=None):
    n_rays = rays.shape[1]
    out = torch.zeros((3, n_rays), dtype=rays.dtype, device=rays.device)
    if table_ids.shape[0] == 0 or vrls.shape[1] == 0:
        return out
    rows = torch.as_tensor(ray_slice, device=rays.device).long()
    mats = vs._plain_materials(materials)
    for b0 in range(0, n_rays, vs._PLAIN_RAY_CHUNK):
        b1 = min(n_rays, b0 + vs._PLAIN_RAY_CHUNK)
        tables = _gather_tables(vrls, rows[b0:b1], table_ids, table_weights)
        out[:, b0:b1] = vs._pair_sums(
            rays[:, b0:b1], tables, tris, medium, uniforms[b0:b1], svv, svs,
            short_vrls, phase_kind, grid, mats).T
    return out


def vrl_sum_clustered_reference(rays, vrls, tris, medium, ray_slice,
                                table_ids, table_weights, uniforms, *,
                                vol_vol_samples=2, vol_surf_samples=2,
                                short_vrls=True, phase_kind=ph.HG,
                                materials=None):
    """Plain PyTorch version of the kernel on the same inputs, with
    explicit (B, C, 2 * vol_vol_samples + vol_surf_samples) uniforms
    indexed by ray and table column. Returns (3, B). `materials` as
    ops.vrl_sum.vrl_sum_reference's."""
    return _reference(rays, vrls, tris, medium, ray_slice, table_ids,
                      table_weights, uniforms, vol_vol_samples,
                      vol_surf_samples, short_vrls, phase_kind, None,
                      materials)


def vrl_sum_hetero_clustered_reference(rays, vrls, tris, medium, density,
                                       ray_slice, table_ids, table_weights,
                                       uniforms, *, vol_vol_samples=2,
                                       vol_surf_samples=2, short_vrls=True,
                                       phase_kind=ph.HG, uv_steps=4,
                                       materials=None):
    """vrl_sum_clustered_reference on ops.pack's grid packs and the
    supersampled density (as ops.vrl_sum.vrl_sum_hetero takes them, with
    its `materials`)."""
    return _reference(rays, vrls, tris, medium, ray_slice, table_ids,
                      table_weights, uniforms, vol_vol_samples,
                      vol_surf_samples, short_vrls, phase_kind,
                      (density, uv_steps), materials)


def philox_table_uniforms(seed, ray_slice, table_ids, n_draws):
    """(B, C, n_draws) uniforms of the kernel's Philox stream, indexed by
    ray and table column: pair (b, table_ids[ray_slice[b], c]); 0 for
    rays with row -1."""
    rows = torch.as_tensor(ray_slice, device=table_ids.device).long()
    n_rays, n_cols = rows.shape[0], table_ids.shape[1]
    out = torch.zeros((n_rays, n_cols, n_draws), dtype=torch.float32,
                      device=table_ids.device)
    if table_ids.shape[0] == 0:
        return out
    for b0 in range(0, n_rays, vs._PHILOX_RAY_CHUNK):
        b1 = min(n_rays, b0 + vs._PHILOX_RAY_CHUNK)
        r = rows[b0:b1]
        b = torch.arange(b0, b1, dtype=torch.int64,
                         device=table_ids.device)[:, None]
        u = vs.philox_draws(seed, b, table_ids[r.clamp(min=0)].long(),
                            n_draws)
        out[b0:b1] = torch.where((r >= 0)[:, None, None], u, 0.0)
    return out


@functools.lru_cache(maxsize=None)
def _library():
    lib = vs._library()
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    tail = [p, p, i, p, p, i, p, u, i, i, i, i, p, i, p, p, p]
    lib.alvrl_vrl_sum_clustered.argtypes = [p, i, p, i, p, i, p, p, i, p,
                                            i, *tail]
    lib.alvrl_vrl_sum_hetero_clustered.argtypes = [
        p, i, p, i, p, i, p, p, i, p, i, p, i, i, i, i, i, *tail]
    lib.alvrl_clustered_ray_block.argtypes = [i]
    for fn in (lib.alvrl_vrl_sum_clustered,
               lib.alvrl_vrl_sum_hetero_clustered,
               lib.alvrl_clustered_ray_block):
        fn.restype = i
    return lib


def ray_block(grid):
    """The rays of a tile of the kernel, homogeneous (grid False) or grid
    medium: group_by_slice's ray_block for its launch."""
    return _library().alvrl_clustered_ray_block(int(grid))


def _check_tables(rays, ray_slice, table_ids, table_weights):
    """Raise on tables the kernel does not take; returns ray_slice as a
    host numpy array."""
    if not isinstance(table_ids, torch.Tensor) \
            or table_ids.dtype != torch.int32 or table_ids.dim() != 2:
        raise TypeError("table_ids must be a 2-D int32 tensor")
    if not isinstance(table_weights, torch.Tensor) \
            or table_weights.dtype != torch.float32 \
            or tuple(table_weights.shape) != tuple(table_ids.shape):
        raise TypeError("table_weights must be a float32 tensor shaped as "
                        "table_ids")
    for name, t in (("table_ids", table_ids),
                    ("table_weights", table_weights)):
        if t.device != rays.device:
            raise ValueError(f"{name} is on {t.device}, rays on "
                             f"{rays.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    sl = np.asarray(torch.as_tensor(ray_slice).cpu())
    if sl.ndim != 1 or not np.issubdtype(sl.dtype, np.integer):
        raise TypeError("ray_slice must be a 1-D integer array")
    if len(sl) != rays.shape[1]:
        raise ValueError(f"ray_slice has {len(sl)} rows, rays "
                         f"{rays.shape[1]}")
    if len(sl) and (sl.min() < -1 or sl.max() >= table_ids.shape[0]):
        raise ValueError(f"ray_slice rows must lie in [-1, "
                         f"{table_ids.shape[0]})")
    return sl


def _clustered(fn, rays, vrls, tris, medium, ray_slice, table_ids,
               table_weights, seed, uniforms, svv, svs, short_vrls, phase_kind,
               grid, mode=vs.MODE_SUM, materials=None):
    """The wrappers' body (see vrl_sum_clustered), counting a launch on
    `fn`; mode MODE_CHECK (CUDA tensors only) returns (out, {name:
    total} of vs.CHECK_COUNTS)."""
    if not isinstance(table_ids, torch.Tensor) or table_ids.dim() != 2:
        raise TypeError("table_ids must be a 2-D int32 tensor")
    vs._check(rays, vrls, tris, medium, uniforms, seed, svv, svs, phase_kind,
              n_cols=table_ids.shape[1], grid=grid, materials=materials,
              textured=True)
    sl = _check_tables(rays, ray_slice, table_ids, table_weights)
    n_rays, n_vrls, n_cols = rays.shape[1], vrls.shape[1], table_ids.shape[1]
    checking = mode == vs.MODE_CHECK
    if checking and rays.device.type != "cuda":
        raise ValueError("the checking launch needs CUDA tensors")
    if rays.device.type == "cpu":
        if uniforms is None:
            uniforms = philox_table_uniforms(seed, sl, table_ids,
                                             2 * svv + svs)
        return _reference(rays, vrls, tris, medium, sl, table_ids,
                          table_weights, uniforms, svv, svs, short_vrls,
                          phase_kind, grid, materials)
    lib = _library()
    if tris.shape[0] > lib.alvrl_max_tris():
        raise ValueError(f"{tris.shape[0]} triangles exceed the kernel's "
                         f"shared-memory cap of {lib.alvrl_max_tris()}")
    vs.check_mats_cap(lib, materials)
    out = torch.zeros((3, n_rays), dtype=torch.float32, device=rays.device)
    counts = (torch.zeros(len(vs.CHECK_COUNTS), dtype=torch.int64,
                          device=rays.device) if checking else None)
    tile_rays, tile_row = group_by_slice(sl, ray_block(grid is not None))
    if len(tile_row) and n_vrls and n_cols:
        tile_rays = torch.as_tensor(tile_rays).to(rays.device)
        tile_row = torch.as_tensor(tile_row).to(rays.device)
        with torch.cuda.device(rays.device):
            _launch(lib, rays, vrls, tris, medium, tile_rays, tile_row,
                    table_ids, table_weights, uniforms, seed, svv, svs,
                    short_vrls, phase_kind, out, grid, mode=mode,
                    counts=counts, materials=materials)
        vs.count_launch(fn, grid, medium, materials, rays)
    if checking:
        return out, dict(zip(vs.CHECK_COUNTS, counts.tolist()))
    return out


def vrl_sum_clustered(rays, vrls, tris, medium, ray_slice, table_ids,
                      table_weights, *, seed=0, uniforms=None,
                      vol_vol_samples=2, vol_surf_samples=2, short_vrls=True,
                      phase_kind=ph.HG, materials=None):
    """(3, B) per-ray sums over each ray's table row (not normalised by
    the particle count; see module). rays (RAY_ROWS, B), vrls (VRL_ROWS,
    N), tris and medium are ops.vrl_sum's packs; ray_slice (B,) integer
    rows in [-1, S) (numpy or a tensor; read on the host); table_ids
    (S, C) int32 and table_weights (S, C) float32 on the rays' device.
    Random numbers come from the Philox stream of `seed`, counter (b,
    VRL id, call, 0), or from `uniforms` (B, C, 2 * vol_vol_samples +
    vol_surf_samples) when given. `materials`, as ops.vrl_sum.vrl_sum's,
    takes the material instantiation, with the textured ray pack the
    textured form (counted on vrl_sum_clustered.tex_launches too). CUDA
    tensors go through the CUDA kernel, CPU tensors through
    vrl_sum_clustered_reference."""
    return _clustered(vrl_sum_clustered, rays, vrls, tris, medium,
                      ray_slice, table_ids, table_weights, seed, uniforms,
                      vol_vol_samples, vol_surf_samples, short_vrls,
                      phase_kind, None, materials=materials)


vrl_sum_clustered.launches = 0  # kernel launches, for showing that a run
                                # used the kernel
vrl_sum_clustered.tex_launches = 0  # of them, the textured form's


def vrl_sum_clustered_check(rays, vrls, tris, medium, ray_slice, table_ids,
                            table_weights, *, seed=0, uniforms=None,
                            vol_vol_samples=2, vol_surf_samples=2,
                            short_vrls=True, phase_kind=ph.HG,
                            materials=None):
    """vrl_sum_clustered's sums through kernel 2's checking
    instantiation (a launch counted here, not on the wrapper), which
    decides every shadow segment by the Wald test alone and runs the
    plane pre-reject beside it, and {name: total} of vs.CHECK_COUNTS, as
    ops.vrl_sum.vrl_sum_check returns them. CUDA tensors only."""
    return _clustered(vrl_sum_clustered_check, rays, vrls, tris, medium,
                      ray_slice, table_ids, table_weights, seed, uniforms,
                      vol_vol_samples, vol_surf_samples, short_vrls,
                      phase_kind, None, mode=vs.MODE_CHECK,
                      materials=materials)


vrl_sum_clustered_check.launches = 0  # checking launches


def vrl_sum_hetero_clustered(rays, vrls, tris, medium, density, ray_slice,
                             table_ids, table_weights, *, seed=0,
                             uniforms=None, vol_vol_samples=2,
                             vol_surf_samples=2, short_vrls=True,
                             phase_kind=ph.HG, uv_steps=4, materials=None):
    """vrl_sum_clustered in a grid medium, on the packs and density that
    ops.vrl_sum.vrl_sum_hetero takes (the trilinear medium pack takes the
    kernel's trilinear form; `materials`, with the grid ray pack of
    GRID_MAT_RAY_ROWS rows, its material forms, with the grid textured
    ray pack of GRID_TEX_RAY_ROWS rows, its textured forms); the CUDA
    kernel's launches are counted here (the trilinear forms' on
    tri_launches too, the material and textured forms' on mat_launches,
    the textured forms' on tex_launches), the CPU goes through
    vrl_sum_hetero_clustered_reference."""
    return _clustered(vrl_sum_hetero_clustered, rays, vrls, tris, medium,
                      ray_slice, table_ids, table_weights, seed, uniforms,
                      vol_vol_samples, vol_surf_samples, short_vrls,
                      phase_kind, (density, uv_steps), materials=materials)


vrl_sum_hetero_clustered.launches = 0  # kernel launches, as
                                       # vrl_sum_clustered.launches
vrl_sum_hetero_clustered.tri_launches = 0  # of them, the trilinear form's
vrl_sum_hetero_clustered.mat_launches = 0  # of them, the material forms'
vrl_sum_hetero_clustered.tex_launches = 0  # of them, the textured forms'


def vrl_sum_hetero_clustered_check(rays, vrls, tris, medium, density,
                                   ray_slice, table_ids, table_weights, *,
                                   seed=0, uniforms=None, vol_vol_samples=2,
                                   vol_surf_samples=2, short_vrls=True,
                                   phase_kind=ph.HG, uv_steps=4,
                                   materials=None):
    """vrl_sum_hetero_clustered's sums through kernel 4's checking
    instantiation (a launch counted here, not on the wrapper), which
    decides every shadow segment by the Wald test alone and runs the
    plane pre-reject beside it, and {name: total} of vs.CHECK_COUNTS, as
    ops.vrl_sum.vrl_sum_check returns them. CUDA tensors only;
    `materials` as vrl_sum_hetero_clustered's."""
    return _clustered(vrl_sum_hetero_clustered_check, rays, vrls, tris,
                      medium, ray_slice, table_ids, table_weights, seed,
                      uniforms, vol_vol_samples, vol_surf_samples, short_vrls,
                      phase_kind, (density, uv_steps), mode=vs.MODE_CHECK,
                      materials=materials)


vrl_sum_hetero_clustered_check.launches = 0  # checking launches
vrl_sum_hetero_clustered_check.tri_launches = 0  # of them, the trilinear
vrl_sum_hetero_clustered_check.mat_launches = 0  # of them, the material
vrl_sum_hetero_clustered_check.tex_launches = 0  # of them, the textured


def _launch(lib, rays, vrls, tris, medium, tile_rays, tile_row, table_ids,
            table_weights, uniforms, seed, svv, svs, short_vrls, phase_kind,
            out, grid=None, mode=vs.MODE_SUM, counts=None, materials=None):
    """The kernel on inputs the wrapper has checked and grouped
    (tile_rays, tile_row: group_by_slice's arrays on the device, at
    ray_block(grid is not None)), into `out` (3, B), written at the rays
    of the tiles; on the current stream; grid = (density, uv_steps) for
    the grid kernel. It sweeps the triangles' plane pack (made here into
    scratch) in `mode`: MODE_CHECK adds its counts to `counts`,
    (len(CHECK_COUNTS),) int64; homogeneous MODE_NO_REJECT sweeps
    without the pre-reject; `materials` takes the material instantiation
    (either medium). The wrapper's own step, apart so that chip_smoke.py can
    time the kernel without the wrapper's host work; it counts no
    launch."""
    block = lib.alvrl_clustered_ray_block(int(grid is not None))
    if len(tile_rays) != block * len(tile_row):
        raise ValueError(f"{len(tile_rays)} tile slots for {len(tile_row)} "
                         f"tiles of {block} rays")
    if grid is None:
        medium = pk.extended_medium(medium)
    head = (rays.data_ptr(), rays.shape[1], vrls.data_ptr(), vrls.shape[1],
            tris.data_ptr(), tris.shape[0], medium.data_ptr())
    planes = torch.empty((tris.shape[0], 4 * lib.alvrl_plane_f4()),
                         dtype=torch.float32, device=rays.device)
    tail = (tile_rays.data_ptr(), tile_row.data_ptr(), len(tile_row),
            table_ids.data_ptr(), table_weights.data_ptr(),
            table_ids.shape[1],
            None if uniforms is None else uniforms.data_ptr(), seed, svv, svs,
            int(short_vrls), phase_kind,
            planes.data_ptr() if tris.shape[0] else None, mode,
            None if counts is None else counts.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(rays.device).cuda_stream)
    if grid is None:
        err = lib.alvrl_vrl_sum_clustered(*head, *vs.mat_args(materials),
                                          vs.tex_arg(rays, materials),
                                          *tail)
    else:
        err = lib.alvrl_vrl_sum_hetero_clustered(
            *head, *vs.mat_args(materials), vs.tex_arg(rays, materials),
            *vs.grid_args(*grid),
            int(pk.is_trilinear(medium)), *tail)
    if err != 0:
        raise RuntimeError("vrl_sum_clustered kernel launch failed: CUDA "
                           f"error {err} "
                           f"({lib.alvrl_error_string(err).decode()})")
