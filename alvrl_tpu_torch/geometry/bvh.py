"""BVH: the native binned-SAH build and a batched short-stack traversal.

Counterpart of alvrl_tpu/geometry/bvh.py. The build runs in C++
(native/bvh_builder.cpp, compiled as it is by g++ into
alvrl_tpu_torch/_build/ by ops/_build.py, never by make in native/) and
returns the same flat arrays as the JAX package's build, as torch
tensors. The traversal, which the JAX package leaves to XLA (a
while-loop per ray, vmapped), is plain torch here: one loop over all
rays at once, each step popping one node per ray, testing its leaf's
triangles or pushing its children, until every ray's stack is empty.
The loop runs as many steps as the worst ray visits nodes.

Two departures from the JAX traversal, both deliberate:
  * the slab test keeps the sign of a zero direction component: its
    reciprocal is an IEEE infinity, the near and far planes are picked
    by the sign, and the min/max drop the NaN of a ray lying in a box's
    face plane. The JAX package replaces a zero component with +1e-12,
    so a ray along a split plane culls a subtree and the closest hit
    comes back from a farther surface (ROADMAP C1);
  * every box is padded outward by BOX_PAD times the scene's scale and
    children are tested before they are pushed, nearer child popped
    first; hits are Moller-Trumbore on the triangles as intersect_all
    computes them, with intersect_all's choice among equal distances
    (the lower triangle index). So the closest hit is intersect_all's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from alvrl_tpu_torch.core import math as m
from alvrl_tpu_torch.geometry import intersect as isect
from alvrl_tpu_torch.ops import _build

SOURCE = _build.PKG_DIR.parent / "native" / "bvh_builder.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared",
             "-std=c++17")  # native/Makefile's, for libalvrl_native.so
STACK_DEPTH = 64  # traversal stack entries: trees up to STACK_DEPTH - 1 deep
BOX_PAD = 1e-5    # box padding, relative to the largest |coordinate|


def _library_path():
    return _build.gxx_library_path(SOURCE, CXX_FLAGS, "libalvrl_bvh")


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if the source changed) and load the builder library; it
    exports native/bvh_builder.cpp's C ABI, bvh_build."""
    lib_path = _library_path()
    _build.build_gxx(SOURCE, CXX_FLAGS, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    f_p = ctypes.POINTER(ctypes.c_float)
    i_p = ctypes.POINTER(ctypes.c_int32)
    lib.bvh_build.restype = ctypes.c_int
    lib.bvh_build.argtypes = [f_p, ctypes.c_int, i_p, ctypes.c_int,
                              ctypes.c_int, f_p, i_p, i_p]
    return lib


class BVH(NamedTuple):
    """alvrl_tpu's BVH arrays (node i: bounds, children left/right, or a
    leaf's prim_count > 0 triangles prim_order[prim_start:...]; the
    leaf-ordered triangles as p0, e1, e2), and the tree's depth (edges
    from the root to the deepest leaf)."""

    bounds_lo: torch.Tensor   # (n, 3) float32
    bounds_hi: torch.Tensor   # (n, 3)
    left: torch.Tensor        # (n,) int64
    right: torch.Tensor       # (n,)
    prim_start: torch.Tensor  # (n,)
    prim_count: torch.Tensor  # (n,)
    prim_order: torch.Tensor  # (T,) triangle indices, leaf-contiguous
    tri_p0: torch.Tensor      # (T, 3) float32, leaf order
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    depth: int


def build_arrays(verts, faces, leaf_size: int = 4):
    """The native build on the host: (bounds (n, 6) float32 lo, hi;
    meta (n, 4) int32 left, right, prim_start, prim_count; prim_order
    (T,) int32)."""
    lib = load_library()
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    t = len(faces)
    bounds = np.zeros((max(2 * t, 1), 6), np.float32)
    meta = np.zeros((max(2 * t, 1), 4), np.int32)
    order = np.zeros((t,), np.int32)
    n = lib.bvh_build(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(verts),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), t, leaf_size,
        bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return bounds[:n], meta[:n], order


def tree_depth(meta) -> int:
    """Edges from the root to the deepest leaf of build_arrays' meta."""
    depth, level = 0, np.zeros(1, np.int64)
    while True:
        inner = level[meta[level, 3] == 0]
        if len(inner) == 0:
            return depth
        level = np.concatenate([meta[inner, 0], meta[inner, 1]])
        depth += 1


def build(verts, faces, leaf_size: int = 4, device=None) -> BVH:
    """The native build over the triangles `faces` (T, 3) of `verts`
    (V, 3), numpy or torch; the arrays go to `device` (by default the
    vertices' device, or the card)."""
    if device is None:
        device = verts.device if isinstance(verts, torch.Tensor) else "cuda"
    verts = np.asarray(torch.as_tensor(verts).cpu(), np.float32)
    faces = np.asarray(torch.as_tensor(faces).cpu(), np.int32)
    bounds, meta, order = build_arrays(verts, faces, leaf_size)
    tri = verts[faces[order]]  # (T, 3 corners, 3)

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=device)

    def i64(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    return BVH(bounds_lo=f32(bounds[:, 0:3]), bounds_hi=f32(bounds[:, 3:6]),
               left=i64(meta[:, 0]), right=i64(meta[:, 1]),
               prim_start=i64(meta[:, 2]), prim_count=i64(meta[:, 3]),
               prim_order=i64(order), tri_p0=f32(tri[:, 0]),
               tri_e1=f32(tri[:, 1] - tri[:, 0]),
               tri_e2=f32(tri[:, 2] - tri[:, 0]),
               depth=tree_depth(meta))


def box_pad(root_lo, root_hi):
    """The outward padding of every box of a tree whose root box is
    (root_lo, root_hi): BOX_PAD times the largest |coordinate| in the
    tree, which exceeds the rounding of a hit point computed in float32
    anywhere in the scene."""
    return BOX_PAD * max(float(abs(x)) for x in (*root_lo, *root_hi, 1e-30))


def _traverse(bvh: BVH, o, d, t_min, t_max, any_hit):
    """(t, prim) of the closest hit (any hit: the first found) in (t_min,
    t_max) of each ray (o, d) (R, 3); t_min, t_max (R,)."""
    if bvh.depth > STACK_DEPTH - 1:
        raise ValueError(f"BVH depth {bvh.depth} exceeds the traversal "
                         f"stack's {STACK_DEPTH - 1}")
    n_rays, dev = o.shape[0], o.device
    best_t = t_max.clone()
    best_prim = torch.full((n_rays,), -1, dtype=torch.int64, device=dev)
    if bvh.prim_order.numel() == 0:
        return best_t, best_prim
    pad = box_pad(bvh.bounds_lo[0].tolist(), bvh.bounds_hi[0].tolist())
    lo_all, hi_all = bvh.bounds_lo - pad, bvh.bounds_hi + pad
    inv = 1.0 / d  # +-inf where a component is +-0
    neg = inv < 0.0

    def box(node):
        """(overlaps, entry distance) of each ray with its node's box."""
        lo, hi = lo_all[node], hi_all[node]
        near = (torch.where(neg, hi, lo) - o) * inv
        far = (torch.where(neg, lo, hi) - o) * inv
        t0 = torch.fmax(torch.fmax(torch.fmax(t_min, near[:, 0]),
                                   near[:, 1]), near[:, 2])
        t1 = torch.fmin(torch.fmin(torch.fmin(best_t, far[:, 0]),
                                   far[:, 1]), far[:, 2])
        return t0 <= t1, t0

    stack = torch.zeros((n_rays, STACK_DEPTH), dtype=torch.int64, device=dev)
    stack_t = torch.zeros((n_rays, STACK_DEPTH), device=dev)
    root = torch.zeros(n_rays, dtype=torch.int64, device=dev)
    hit_root, stack_t[:, 0] = box(root)
    sp = hit_root.long()
    max_leaf = int(bvh.prim_count.max())
    last = bvh.prim_order.shape[0] - 1
    while bool((sp > 0).any()):
        active = sp > 0
        sp = sp - active.long()
        top = sp[:, None]
        node = stack.gather(1, top)[:, 0]
        live = active & (stack_t.gather(1, top)[:, 0] <= best_t)
        count = bvh.prim_count[node]
        leaf = live & (count > 0)
        start = bvh.prim_start[node]
        for k in range(max_leaf):
            idx = (start + k).clamp(max=last)
            t, _, _, hit = isect.ray_triangle_edges(
                o, d, bvh.tri_p0[idx], bvh.tri_e1[idx], bvh.tri_e2[idx])
            prim = bvh.prim_order[idx]
            better = leaf & (k < count) & hit & (t > t_min) & (
                (t < best_t) | ((t == best_t) & (prim < best_prim)))
            best_t = torch.where(better, t, best_t)
            best_prim = torch.where(better, prim, best_prim)
        if any_hit:
            sp = torch.where(best_prim >= 0, 0, sp)
        inner = live & (count == 0)
        left, right = bvh.left[node].clamp(min=0), bvh.right[node].clamp(min=0)
        (hl, tl), (hr, tr) = box(left), box(right)
        hl, hr = hl & inner, hr & inner
        left_first = tl <= tr  # popped first, so pushed last
        first_node = torch.where(left_first, left, right)
        first_t = torch.where(left_first, tl, tr)
        one = hl ^ hr
        # the farther child (or the only one) at sp, the nearer at sp + 1
        far_node = torch.where(one, torch.where(hl, left, right),
                               torch.where(left_first, right, left))
        far_t = torch.where(one, torch.where(hl, tl, tr),
                            torch.where(left_first, tr, tl))
        up = (sp + 1).clamp(max=STACK_DEPTH - 1)[:, None]
        stack.scatter_(1, up, first_node[:, None])
        stack_t.scatter_(1, up, first_t[:, None])
        stack.scatter_(1, sp[:, None], far_node[:, None])
        stack_t.scatter_(1, sp[:, None], far_t[:, None])
        sp = sp + hl.long() + hr.long()
    return best_t, best_prim


def intersect(bvh: BVH, o, d, t_min=isect.RAY_EPS, t_max=float("inf")):
    """Closest hits of the rays (o, d) (R, 3) in (t_min, t_max): (t
    (R,), prim (R,) int64, valid (R,) bool), t = t_max and prim = -1
    where a ray hits nothing; intersect_all's hits."""
    full = torch.ones(o.shape[0], device=o.device)
    t, prim = _traverse(bvh, o, d, full * t_min, full * t_max, False)
    return t, prim, prim >= 0


def occluded(bvh: BVH, p_from, p_to):
    """Does a triangle of the tree block the open segment p_from -> p_to
    (R, 3), its ends shrunk by SHADOW_EPS * max(length, 1)? The tree
    holds only the blocking faces, as intersect.occluded takes them."""
    delta = p_to - p_from
    dist = m.length(delta)
    d = delta / torch.clamp(dist, min=1e-20)[:, None]
    lo = isect.SHADOW_EPS * torch.clamp(dist, min=1.0)
    return _traverse(bvh, p_from, d, lo, dist - lo, True)[1] >= 0
