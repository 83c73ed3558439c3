"""The transfer matrix R of the clustered render: per (representative
eye ray, VRL) pair, the luminance mean and variance of the mean of the
VRL estimator.

Replaces alvrl_tpu/ops/vrl_pallas.py:vrl_r_pallas and, for grid media,
vrl_r_pallas_hetero (the grid estimator of ops.vrl_sum). Out (2, P, N)
float32, not normalised by the particle count: [0] the sum over the two
sample families (vol-vol, vol-surf) of the mean of the per-sample
luminances, [1] the sum of their variances of the mean,
max(sum x^2 - n mu^2, 0) / (n - 1) / n for a family of n > 1 samples
(getLiLuminanceVrlContributions, vrlIntegrator.cpp:527-539, through
vrl_pallas.py:502-517, 697-715). A dropped sample counts as 0.

What bounds it on the H100 is fp32 ALU and special-function throughput,
as for ops.vrl_sum: the CUDA kernel (csrc/vrl_r.cu, whose header gives
the design) runs the same estimator (csrc/vrl_common.cuh) in tiles of
rays x VRLs, sweeps the shadow segments with kernel 1's plane
pre-reject, and writes each pair's two numbers once.

Beside the kernel:
  * `vrl_r_reference` and `vrl_r_hetero_reference`, the plain PyTorch
    versions on the same packs and explicit uniforms, reducing
    ops.vrl_sum's per-sample terms;
  * `vrl_r` and `vrl_r_hetero`, the wrappers: the kernel for CUDA
    tensors (or an error; there is no fallback), the plain version for
    CPU tensors. Their Philox stream is vrl_sum's, with the
    representative row as the ray index;
  * `vrl_r_check` and `vrl_r_hetero_check`, the kernels' checking
    launches (CUDA only), as ops.vrl_sum.vrl_sum_check for kernel 1.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from alvrl_tpu_torch.core.spectrum import LUM_WEIGHTS
from alvrl_tpu_torch.media import phase as ph
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops import vrl_sum as vs


def _pair_r(rays, vrls, tris, medium, u, svv, svs, short_vrls, phase_kind,
            grid, mats=None):
    """(mean, var), each (R, N), for a block of R rays (see module)."""
    shape = (rays.shape[1], vrls.shape[1])
    sums = {f: torch.zeros(shape, dtype=rays.dtype, device=rays.device)
            for f in (vs.VV, vs.VS)}
    squares = {f: torch.zeros_like(sums[f]) for f in sums}
    w0, w1, w2 = LUM_WEIGHTS
    for family, term in vs._pair_terms(rays, vrls, tris, medium, u, svv, svs,
                                       short_vrls, phase_kind, grid, mats):
        lum = w0 * term[..., 0] + w1 * term[..., 1] + w2 * term[..., 2]
        sums[family] += lum
        squares[family] += lum * lum
    mean = torch.zeros(shape, dtype=rays.dtype, device=rays.device)
    var = torch.zeros_like(mean)
    for family, n in ((vs.VV, svv), (vs.VS, svs)):
        if n == 0:
            continue
        mu = sums[family] / n
        mean += mu
        if n > 1:
            var += torch.clamp(squares[family] - n * mu * mu, min=0.0) \
                / (n - 1) / n
    return mean, var


def _reference(rays, vrls, tris, medium, uniforms, svv, svs, short_vrls,
               phase_kind, grid, materials=None):
    n_rays = rays.shape[1]
    out = torch.zeros((2, n_rays, vrls.shape[1]), dtype=rays.dtype,
                      device=rays.device)
    mats = vs._plain_materials(materials)
    for b0 in range(0, n_rays, vs._PLAIN_RAY_CHUNK):
        b1 = min(n_rays, b0 + vs._PLAIN_RAY_CHUNK)
        mean, var = _pair_r(rays[:, b0:b1], vrls, tris, medium,
                            uniforms[b0:b1], svv, svs, short_vrls,
                            phase_kind, grid, mats)
        out[0, b0:b1], out[1, b0:b1] = mean, var
    return out


def vrl_r_reference(rays, vrls, tris, medium, uniforms, *,
                    vol_vol_samples=2, vol_surf_samples=2, short_vrls=True,
                    phase_kind=ph.HG, materials=None):
    """Plain PyTorch version of the kernel on the same packs, with
    explicit (P, N, 2 * vol_vol_samples + vol_surf_samples) uniforms.
    Returns (2, P, N). `materials` as ops.vrl_sum.vrl_sum_reference's."""
    return _reference(rays, vrls, tris, medium, uniforms, vol_vol_samples,
                      vol_surf_samples, short_vrls, phase_kind, None,
                      materials)


def vrl_r_hetero_reference(rays, vrls, tris, medium, density, uniforms, *,
                           vol_vol_samples=2, vol_surf_samples=2,
                           short_vrls=True, phase_kind=ph.HG, uv_steps=4,
                           materials=None):
    """vrl_r_reference on ops.pack's grid packs and the supersampled
    density (as ops.vrl_sum.vrl_sum_hetero takes them, with its
    `materials`)."""
    return _reference(rays, vrls, tris, medium, uniforms, vol_vol_samples,
                      vol_surf_samples, short_vrls, phase_kind,
                      (density, uv_steps), materials)


@functools.lru_cache(maxsize=None)
def _library():
    lib = vs._library()
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    tail = [p, u, i, i, i, i, p, i, p, p, p]
    lib.alvrl_vrl_r.argtypes = [p, i, p, i, p, i, p, p, i, p, i, *tail]
    lib.alvrl_vrl_r_hetero.argtypes = [p, i, p, i, p, i, p, p, i, p, i, p,
                                       i, i, i, i, i, *tail]
    lib.alvrl_vrl_r_tile_rays.argtypes = [i]
    for fn in (lib.alvrl_vrl_r, lib.alvrl_vrl_r_hetero,
               lib.alvrl_vrl_r_tile_rays):
        fn.restype = i
    return lib


def tile_rays(grid):
    """The rays of a tile of the R kernel, homogeneous (grid False) or
    grid medium; a tile's VRLs are the library's alvrl_vrl_chunk()."""
    return _library().alvrl_vrl_r_tile_rays(int(grid))


def _launch(lib, rays, vrls, tris, medium, uniforms, seed, svv, svs,
            short_vrls, phase_kind, grid=None, mode=vs.MODE_SUM, counts=None,
            materials=None):
    """The kernel on checked inputs, on the current stream: (2, P, N).
    grid = (density, uv_steps) for the grid kernel; `materials` for the
    material instantiation (either medium). Both sweep the triangles' plane
    pack (made here into scratch) in `mode` (MODE_CHECK adds its counts
    to `counts`, (len(vs.CHECK_COUNTS),) int64)."""
    n_rays, n_vrls = rays.shape[1], vrls.shape[1]
    out = torch.empty((2, n_rays, n_vrls), dtype=torch.float32,
                      device=rays.device)
    if grid is None:
        medium = pk.extended_medium(medium)
    head = (rays.data_ptr(), n_rays, vrls.data_ptr(), n_vrls, tris.data_ptr(),
            tris.shape[0], medium.data_ptr())
    planes = torch.empty((tris.shape[0], 4 * lib.alvrl_plane_f4()),
                         dtype=torch.float32, device=rays.device)
    tail = (None if uniforms is None else uniforms.data_ptr(), seed, svv, svs,
            int(short_vrls), phase_kind,
            planes.data_ptr() if tris.shape[0] else None, mode,
            None if counts is None else counts.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(rays.device).cuda_stream)
    if grid is None:
        err = lib.alvrl_vrl_r(*head, *vs.mat_args(materials),
                              vs.tex_arg(rays, materials), *tail)
    else:
        err = lib.alvrl_vrl_r_hetero(*head, *vs.mat_args(materials),
                                     vs.tex_arg(rays, materials),
                                     *vs.grid_args(*grid),
                                     int(pk.is_trilinear(medium)), *tail)
    if err != 0:
        raise RuntimeError("vrl_r kernel launch failed: CUDA error "
                           f"{err} ({lib.alvrl_error_string(err).decode()})")
    return out


def _r(fn, rays, vrls, tris, medium, seed, uniforms, svv, svs, short_vrls,
       phase_kind, grid, mode=vs.MODE_SUM, materials=None):
    """The wrappers' body (see vrl_r), counting a launch on `fn`; mode
    MODE_CHECK (CUDA tensors only) returns (out, {name: total} of
    vs.CHECK_COUNTS)."""
    vs._check(rays, vrls, tris, medium, uniforms, seed, svv, svs, phase_kind,
              grid=grid, materials=materials, textured=True)
    n_rays, n_vrls = rays.shape[1], vrls.shape[1]
    checking = mode == vs.MODE_CHECK
    if checking and rays.device.type != "cuda":
        raise ValueError("the checking launch needs CUDA tensors")
    if rays.device.type == "cpu":
        if uniforms is None:
            uniforms = vs.philox_uniforms(seed, n_rays, n_vrls, 2 * svv + svs)
        return _reference(rays, vrls, tris, medium, uniforms, svv, svs,
                          short_vrls, phase_kind, grid, materials)
    lib = _library()
    if tris.shape[0] > lib.alvrl_max_tris():
        raise ValueError(f"{tris.shape[0]} triangles exceed the kernel's "
                         f"shared-memory cap of {lib.alvrl_max_tris()}")
    vs.check_mats_cap(lib, materials)
    counts = (torch.zeros(len(vs.CHECK_COUNTS), dtype=torch.int64,
                          device=rays.device) if checking else None)
    if n_rays == 0 or n_vrls == 0:
        out = torch.empty((2, n_rays, n_vrls), dtype=torch.float32,
                          device=rays.device)
    else:
        with torch.cuda.device(rays.device):
            out = _launch(lib, rays, vrls, tris, medium, uniforms, seed, svv,
                          svs, short_vrls, phase_kind, grid, mode, counts,
                          materials)
        vs.count_launch(fn, grid, medium, materials, rays)
    if checking:
        return out, dict(zip(vs.CHECK_COUNTS, counts.tolist()))
    return out


def vrl_r(rays, vrls, tris, medium, *, seed=0, uniforms=None,
          vol_vol_samples=2, vol_surf_samples=2, short_vrls=True,
          phase_kind=ph.HG, materials=None):
    """(2, P, N) per-pair luminance [mean, variance of the mean] (not
    normalised by the particle count) of the P eye rays of `rays`
    (RAY_ROWS, P) against the VRLs of `vrls` (VRL_ROWS, N); packs as
    ops.vrl_sum.vrl_sum takes them. Random numbers come from the Philox
    stream of `seed`, counter (p, n, call, 0), or from `uniforms` (P, N,
    2 * vol_vol_samples + vol_surf_samples) when given. `materials`, as
    ops.vrl_sum.vrl_sum's, takes the material instantiation, with the
    textured ray pack the textured form (counted on vrl_r.tex_launches
    too). CUDA tensors go through the CUDA kernel, CPU tensors through
    vrl_r_reference."""
    return _r(vrl_r, rays, vrls, tris, medium, seed, uniforms,
              vol_vol_samples, vol_surf_samples, short_vrls, phase_kind, None,
              materials=materials)


vrl_r.launches = 0  # kernel launches, for showing that a run used the kernel
vrl_r.tex_launches = 0  # of them, the textured form's


def vrl_r_check(rays, vrls, tris, medium, *, seed=0, uniforms=None,
                vol_vol_samples=2, vol_surf_samples=2, short_vrls=True,
                phase_kind=ph.HG, materials=None):
    """vrl_r's (2, P, N) through kernel 5's checking instantiation (a
    launch counted here, not on vrl_r), which decides every shadow
    segment by the Wald test alone and runs the plane pre-reject beside
    it, and {name: total} of vs.CHECK_COUNTS, as
    ops.vrl_sum.vrl_sum_check returns them. CUDA tensors only."""
    return _r(vrl_r_check, rays, vrls, tris, medium, seed, uniforms,
              vol_vol_samples, vol_surf_samples, short_vrls, phase_kind, None,
              mode=vs.MODE_CHECK, materials=materials)


vrl_r_check.launches = 0  # checking launches


def vrl_r_hetero(rays, vrls, tris, medium, density, *, seed=0, uniforms=None,
                 vol_vol_samples=2, vol_surf_samples=2, short_vrls=True,
                 phase_kind=ph.HG, uv_steps=4, materials=None):
    """vrl_r in a grid medium, on the packs and density that
    ops.vrl_sum.vrl_sum_hetero takes (the trilinear medium pack takes the
    kernel's trilinear form; `materials`, with the grid ray pack of
    GRID_MAT_RAY_ROWS rows, its material forms, with the grid textured
    ray pack of GRID_TEX_RAY_ROWS rows, its textured forms); the CUDA
    kernel's launches are counted here (the trilinear forms' on
    tri_launches too, the material and textured forms' on mat_launches,
    the textured forms' on tex_launches), the CPU goes through
    vrl_r_hetero_reference."""
    return _r(vrl_r_hetero, rays, vrls, tris, medium, seed, uniforms,
              vol_vol_samples, vol_surf_samples, short_vrls, phase_kind,
              (density, uv_steps), materials=materials)


vrl_r_hetero.launches = 0  # kernel launches, as vrl_r.launches
vrl_r_hetero.tri_launches = 0  # of them, the trilinear form's
vrl_r_hetero.mat_launches = 0  # of them, the material forms'
vrl_r_hetero.tex_launches = 0  # of them, the textured forms'


def vrl_r_hetero_check(rays, vrls, tris, medium, density, *, seed=0,
                       uniforms=None, vol_vol_samples=2, vol_surf_samples=2,
                       short_vrls=True, phase_kind=ph.HG, uv_steps=4,
                       materials=None):
    """vrl_r_hetero's (2, P, N) through kernel 6's checking instantiation
    (a launch counted here, not on vrl_r_hetero), which decides every
    shadow segment by the Wald test alone and runs the plane pre-reject
    beside it, and {name: total} of vs.CHECK_COUNTS, as
    ops.vrl_sum.vrl_sum_check returns them. CUDA tensors only;
    `materials` as vrl_r_hetero's."""
    return _r(vrl_r_hetero_check, rays, vrls, tris, medium, seed, uniforms,
              vol_vol_samples, vol_surf_samples, short_vrls, phase_kind,
              (density, uv_steps), mode=vs.MODE_CHECK, materials=materials)


vrl_r_hetero_check.launches = 0  # checking launches, as vrl_r_check's
vrl_r_hetero_check.tri_launches = 0  # of them, the trilinear form's
vrl_r_hetero_check.mat_launches = 0  # of them, the material forms'
vrl_r_hetero_check.tex_launches = 0  # of them, the textured forms'
