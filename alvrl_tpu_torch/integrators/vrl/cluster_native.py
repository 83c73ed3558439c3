"""The Adaptive LightSlice cluster refinement, in C++.

The port's binding of native/cluster_refine.cpp, the ClusterRefiner
thread fan-out (src/integrators/vrl/Preprocessor.cpp:722-773): the
adaptive refinement is sequential per slice but independent across
slices, and the C++ module runs the variance cost model over all cores.
Counterpart of alvrl_tpu/integrators/vrl/cluster_native.py with the same
calls in the same order, so both give the same tables from the same
numpy Generator (whose one draw seeds the refiner's own xoshiro256++
streams).

The library is compiled by g++ at first use, with the flags of
native/Makefile, into alvrl_tpu_torch/_build/ (ops/_build.py's
gxx_library_path and build_gxx): never by make in native/, whose tracked
.so stays as it is. A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from alvrl_tpu_torch.integrators.vrl import cluster as cl
from alvrl_tpu_torch.ops import _build

SOURCE = _build.PKG_DIR.parent / "native" / "cluster_refine.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-pthread")  # native/Makefile's, for libalvrl_cluster.so


def _library_path():
    return _build.gxx_library_path(SOURCE, CXX_FLAGS, "libalvrl_cluster")


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if the source changed) and load the refiner library."""
    if not SOURCE.is_file():
        raise RuntimeError(f"{SOURCE} not found; the native clustering "
                           "backend cannot be built")
    lib_path = _library_path()
    _build.build_gxx(SOURCE, CXX_FLAGS, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    c_dp = ctypes.POINTER(ctypes.c_double)
    c_ip = ctypes.POINTER(ctypes.c_int64)
    lib.alvrl_cluster_refine.restype = ctypes.c_int64
    lib.alvrl_cluster_refine.argtypes = [
        c_dp, c_dp, c_dp,                      # mean, var, loc_w
        ctypes.c_int64, ctypes.c_int64,        # P, N
        c_ip, ctypes.c_int64, c_ip,            # init_offsets, n_init, init_cols
        ctypes.c_double, ctypes.c_double,      # pu, depth_correction
        ctypes.c_double, ctypes.c_int,         # undersampling, do_refine
        ctypes.c_uint64,                       # seed
        c_ip, c_dp,                            # out_ids, out_ws
        c_ip, c_ip, c_ip,                      # out_cl_offsets/cols/n (nullable)
    ]
    lib.alvrl_cluster_slices.restype = ctypes.c_int64
    lib.alvrl_cluster_slices.argtypes = [
        c_dp, c_dp, ctypes.c_int64, ctypes.c_int64,
        c_ip, c_ip, c_dp, c_dp, ctypes.c_int64,
        c_ip, ctypes.c_int64, c_ip,
        ctypes.c_double, ctypes.c_double, ctypes.c_int,
        c_ip, c_dp, ctypes.c_int64,
        ctypes.c_uint64, ctypes.c_int64,
        c_ip, c_dp, ctypes.c_int64, c_ip,
    ]
    return lib


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _as_offsets(clusters):
    offsets = np.zeros(len(clusters) + 1, np.int64)
    for i, c in enumerate(clusters):
        offsets[i + 1] = offsets[i] + len(c)
    cols = (np.concatenate([np.asarray(c, np.int64) for c in clusters])
            if clusters else np.zeros((0,), np.int64))
    return offsets, cols


def refine(mean, var, loc_w, init_clusters, pixel_undersampling,
           depth_correction, undersampling, do_refine, seed,
           want_clusters=False):
    """One Clustering: init -> (refine) -> sample representatives.
    Returns (ids, ws) or (ids, ws, clusters) — ids is None when
    refine() reports zero unclustered variance (caller falls back)."""
    lib = load_library()
    mean = np.ascontiguousarray(mean, np.float64)
    var = np.ascontiguousarray(var, np.float64)
    loc_w = np.ascontiguousarray(loc_w, np.float64)
    p, n = mean.shape
    offsets, cols = _as_offsets(init_clusters)
    total = len(cols)
    out_ids = np.zeros(max(total, 1), np.int64)
    out_ws = np.zeros(max(total, 1), np.float64)
    if want_clusters:
        cl_off = np.zeros(total + 2, np.int64)
        cl_cols = np.zeros(max(total, 1), np.int64)
        n_cl = np.zeros(1, np.int64)
        cl_args = (_ip(cl_off), _ip(cl_cols), _ip(n_cl))
    else:
        cl_args = (None, None, None)
    rc = lib.alvrl_cluster_refine(
        _dp(mean), _dp(var), _dp(loc_w), p, n,
        _ip(offsets), len(init_clusters), _ip(cols),
        float(pixel_undersampling), float(depth_correction),
        float(undersampling), int(do_refine), int(seed) & (2**64 - 1),
        _ip(out_ids), _dp(out_ws), *cl_args,
    )
    if rc < 0:
        return (None, None, None) if want_clusters else (None, None)
    ids, ws = out_ids[:rc].copy(), out_ws[:rc].copy()
    if not want_clusters:
        return ids, ws
    k = int(n_cl[0])
    clusters = [cl_cols[cl_off[i]:cl_off[i + 1]].copy() for i in range(k)]
    return ids, ws, clusters


def build_clusters(R_mean, R_var, rows_per_slice, slice_undersampling,
                   global_pixel_undersampling, localities, params, rng):
    """The whole refinement: global cluster -> fall-back -> threaded
    per-slice refinement. Returns (per-slice ids list, per-slice weights
    list, fall-back ids, fall-back weights, global ids, global
    weights)."""
    lib = load_library()
    R_mean = np.ascontiguousarray(R_mean, np.float64)
    R_var = np.ascontiguousarray(R_var, np.float64)
    p_total, n_vrls = R_mean.shape
    seed = int(rng.integers(0, 2**63 - 1))

    # 1) zero-contribution quarantine
    col_total = R_mean.sum(axis=0)
    nonzero = np.nonzero(col_total != 0)[0]
    zero = np.nonzero(col_total == 0)[0]
    uniform_loc = np.full((p_total,), 1.0 / max(p_total, 1))

    if len(nonzero) > 0 and params.global_cluster:
        _, _, vrls_per_cluster = refine(
            R_mean, R_var, uniform_loc, [nonzero],
            global_pixel_undersampling, 1.0,
            params.global_undersampling, 1, seed + 1, want_clusters=True,
        )
        if vrls_per_cluster is None:
            vrls_per_cluster = [nonzero]
    elif len(nonzero) > 0:
        vrls_per_cluster = [nonzero]
    else:
        vrls_per_cluster = []
    if len(zero) > 0:
        vrls_per_cluster = vrls_per_cluster + [zero]

    # 2) global representatives + fall-back refinement
    gc_ids, gc_w = refine(R_mean, R_var, uniform_loc, vrls_per_cluster,
                          global_pixel_undersampling, 1.0, -1.0, 0, seed + 2)
    fb = refine(R_mean, R_var, uniform_loc, vrls_per_cluster,
                global_pixel_undersampling, 1.0,
                params.fallback_undersampling, 1, seed + 3)
    fb_ids, fb_w = (gc_ids, gc_w) if fb[0] is None else fb

    # 3) per-slice refinement (threaded in C++)
    s = len(rows_per_slice)
    if s == 0:
        return [], [], fb_ids, fb_w, gc_ids, gc_w
    rows_cat, locs_cat = [], []
    row_offsets = np.zeros(s + 1, np.int64)
    for i in range(s):
        row_idx, loc_w = cl.slice_locality(rows_per_slice, localities, i,
                                           params.neighbour_weight)
        rows_cat.append(row_idx)
        locs_cat.append(loc_w)
        row_offsets[i + 1] = row_offsets[i] + len(row_idx)
    slice_rows = np.concatenate(rows_cat)
    slice_loc = np.ascontiguousarray(np.concatenate(locs_cat), np.float64)
    slice_u = np.ascontiguousarray(slice_undersampling, np.float64)

    offsets, cols = _as_offsets(vrls_per_cluster)
    cap = max(n_vrls, len(fb_ids), 1)
    out_ids = np.zeros((s, cap), np.int64)
    out_ws = np.zeros((s, cap), np.float64)
    out_counts = np.zeros(s, np.int64)
    fb_ids64 = np.ascontiguousarray(fb_ids, np.int64)
    fb_w64 = np.ascontiguousarray(fb_w, np.float64)
    rc = lib.alvrl_cluster_slices(
        _dp(R_mean), _dp(R_var), p_total, n_vrls,
        _ip(row_offsets), _ip(slice_rows), _dp(slice_loc), _dp(slice_u), s,
        _ip(offsets), len(vrls_per_cluster), _ip(cols),
        float(params.depth_correction), float(params.local_undersampling),
        int(params.local_refinement),
        _ip(fb_ids64), _dp(fb_w64), len(fb_ids64),
        seed + 5, 0,
        _ip(out_ids), _dp(out_ws), cap, _ip(out_counts),
    )
    if rc != 0:
        raise RuntimeError("alvrl_cluster_slices: output capacity exceeded")
    slice_ids = [out_ids[i, : out_counts[i]].copy() for i in range(s)]
    slice_ws = [out_ws[i, : out_counts[i]].copy() for i in range(s)]
    return slice_ids, slice_ws, fb_ids, fb_w, gc_ids, gc_w
