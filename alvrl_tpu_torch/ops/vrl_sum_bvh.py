"""The VRL x eye-ray sum with BVH occlusion: the large-mesh render's
hot loop.

Replaces the BVH section of alvrl_tpu/ops/vrl_pallas.py (:1151-1487):
sort_vrls_morton, pack_tri_clusters and vrl_sum_pallas_bvh with its
occlusion _occl_bvh. The function is ops.vrl_sum.vrl_sum's (the same
estimator, samples and random stream) with no cap on the triangle
count: the shadow test walks a BVH over the opaque triangles instead of
sweeping all of them. Homogeneous media only, as the JAX kernel. Like
kernel 1 it takes the extended medium pack (a mixture phase, a sampling
strategy other than balance: its PHASE = 2 and extended forms, counted
on vrl_sum_bvh.mix_launches too) and a material pack (glossy and layered
surfaces: its material forms, on vrl_sum_bvh.mat_launches), which the
JAX package's XLA route evaluates and its Pallas kernel does not
(ROADMAP C16, C21), and with the textured ray pack (ops.pack.TEX_RAY_ROWS)
its textured form (csrc/vrl_sum_bvh_tex.cu: textures, normal and bump
maps, the HK slab at the eye hit; on vrl_sum_bvh.tex_launches too; the
JAX package's Pallas packs drop the texture, ROADMAP C25).

The CUDA kernel (csrc/vrl_sum_bvh.cu, whose header gives the design) is
bound on the H100 by fp32 ALU throughput in its operations, and held
back by the latency of each shadow traversal's chain of dependent node
reads; its counting instantiation (vrl_sum_bvh_counts) measures the
node fetches, box and triangle tests, which depend on the scene.

Here:
  * `sort_vrls_morton`: the VRL buffer in the Morton order of the
    segments' midpoints (numpy on the host, the JAX package's
    permutation);
  * `pack_bvh_tris`: the BVH over the opaque faces as the kernel reads
    it (a BvhPack: nodes that hold both children's boxes, leaf-ordered
    triangles in pack_tris' p0/e1/e2 layout, depth). Not the JAX
    package's 64-triangle clusters and super list: those fed a scalar
    core's DMA walk; here each segment walks the tree itself;
  * `vrl_sum_bvh_reference`: the plain version, ops.vrl_sum's on the
    pack's triangles, the shadow test brute force in blocks;
  * `vrl_sum_bvh`: the wrapper (the kernel for CUDA tensors, or an
    error; the plain version for CPU tensors), `vrl_sum_bvh_counts` the
    counting launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from alvrl_tpu_torch.geometry import bvh as bvh_mod
from alvrl_tpu_torch.integrators.vrl.vrl import VRLs
from alvrl_tpu_torch.media import phase as ph
from alvrl_tpu_torch.ops import _build
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops import vrl_sum as vs

LEAF_SIZE = 4  # triangles per leaf of the occlusion BVH, at most
# a node: both children's lo (3), reference, hi (3), 0 (int32 bits of
# the reference: an inner child's node, or a leaf's ~(first << 3 |
# count))
NODE_COLS = 16
BVH_STACK = 63  # the deepest tree the kernel serves, as geometry.bvh's
LEAF_BITS = 3   # a leaf reference's count bits
# the kernel's counts (vrl_sum_bvh_counts), in its order
COUNTS = ("node_fetches", "box_tests", "tri_tests", "segments", "open_vv",
          "open_vs", "needed_box_tests", "needed_tri_tests", "differ")


def sort_vrls_morton(vrls: VRLs) -> VRLs:
    """The VRLs reordered by the Morton code of their midpoints (10 bits
    per axis over the midpoints' bounding box), invalid slots last,
    stable: the JAX package's permutation, computed on the host."""
    mid = (0.5 * (vrls.start + vrls.end)).cpu().numpy()
    valid = vrls.valid.cpu().numpy()
    lo = mid.min(axis=0)
    ext = np.maximum(mid.max(axis=0) - lo, 1e-12)
    q = np.clip(((mid - lo) / ext * 1023).astype(np.uint32), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    code = np.where(valid, code, np.uint32(0xFFFFFFFF))
    order = torch.as_tensor(np.argsort(code, kind="stable"),
                            device=vrls.start.device)
    return VRLs(start=vrls.start[order], end=vrls.end[order],
                power=vrls.power[order], valid=vrls.valid[order],
                particle_count=vrls.particle_count)


class BvhPack(NamedTuple):
    """The kernel's occlusion BVH: nodes (n, NODE_COLS) float32, one for
    each inner node of the tree (node 0 the root), each holding its two
    children as (lo.xyz, ref, hi.xyz, 0): the child's box, padded
    outward (geometry.bvh.box_pad), and its reference, int32 bits: an
    inner child's node index (>= 0) or a leaf's ~(first << LEAF_BITS |
    count) (< 0; its triangles first .. first + count - 1); a tree that
    is one leaf has one node, its second child absent (an empty box, lo
    +inf and hi -inf); tris (T, TRI_COLS) float32 in leaf order,
    pack_tris' p0, e1, e2; depth, the edges from the root to the deepest
    leaf."""

    nodes: torch.Tensor
    tris: torch.Tensor
    depth: int


def pack_bvh_tris(verts, faces, opaque_mask, device=None) -> BvhPack:
    """The BvhPack of the opaque faces (opaque_mask (T,) bool) of a
    triangle soup, built on the host (native builder, LEAF_SIZE
    triangles per leaf at most). Raises if the tree is deeper than the
    kernel's stack allows (BVH_STACK). `device`: by default the
    vertices' device, or the card."""
    if device is None:
        device = verts.device if isinstance(verts, torch.Tensor) else "cuda"
    verts = np.asarray(torch.as_tensor(verts).cpu(), np.float32)
    faces = np.asarray(torch.as_tensor(faces).cpu(), np.int32)
    faces = faces[np.asarray(torch.as_tensor(opaque_mask).cpu(), bool)]
    f32 = dict(dtype=torch.float32, device=device)
    if len(faces) == 0:
        return BvhPack(torch.zeros((0, NODE_COLS), **f32),
                       torch.zeros((0, pk.TRI_COLS), **f32), 0)
    bounds, meta, order = bvh_mod.build_arrays(verts, faces, LEAF_SIZE)
    depth = bvh_mod.tree_depth(meta)
    if depth > BVH_STACK:
        raise ValueError(f"BVH depth {depth} exceeds the kernel's stack of "
                         f"{BVH_STACK}")
    leaf = meta[:, 3] > 0
    if meta[leaf, 3].max() >= 1 << LEAF_BITS \
            or len(order) >= 1 << (31 - LEAF_BITS):
        raise ValueError("a leaf's reference does not fit its int32 bits")
    pad = bvh_mod.box_pad(bounds[0, 0:3], bounds[0, 3:6])
    inner = np.flatnonzero(~leaf)
    index = np.zeros(len(meta), np.int64)  # an inner node's row
    index[inner] = np.arange(len(inner))
    ref = np.where(leaf, ~((meta[:, 2].astype(np.int64) << LEAF_BITS)
                           | meta[:, 3]), index).astype(np.int32)
    children = meta[inner, 0:2] if len(inner) else np.zeros((1, 2), np.int64)
    nodes = np.zeros((len(children), NODE_COLS), np.float32)
    for k in range(2):
        c = children[:, k]
        cols = slice(8 * k, 8 * k + 8)
        box = np.empty((len(c), 8), np.float32)
        box[:, 0:3] = bounds[c, 0:3] - pad
        box[:, 3] = ref[c].view(np.float32)
        box[:, 4:7] = bounds[c, 3:6] + pad
        box[:, 7] = 0.0
        nodes[:, cols] = box
    if not len(inner):  # the root is a leaf: one node, its second child absent
        nodes[0, 8:11], nodes[0, 11] = np.inf, np.int32(0).view(np.float32)
        nodes[0, 12:15] = -np.inf
    tri = verts[faces[order]]
    tris = np.concatenate([tri[:, 0], tri[:, 1] - tri[:, 0],
                           tri[:, 2] - tri[:, 0]], axis=1)
    return BvhPack(torch.as_tensor(nodes, **f32),
                   torch.as_tensor(tris, **f32), depth)


def vrl_sum_bvh_reference(rays, vrls, bvh: BvhPack, medium, uniforms, *,
                          vol_vol_samples=2, vol_surf_samples=2,
                          short_vrls=True, phase_kind=ph.HG, materials=None):
    """Plain PyTorch version of the kernel: ops.vrl_sum.vrl_sum_reference
    on the pack's triangles (every segment against every triangle, in
    blocks), with explicit (B, N, 2 * vol_vol_samples +
    vol_surf_samples) uniforms; the extended medium pack and `materials`
    as vrl_sum_bvh takes them."""
    return vs.vrl_sum_reference(rays, vrls, bvh.tris, medium, uniforms,
                                vol_vol_samples=vol_vol_samples,
                                vol_surf_samples=vol_surf_samples,
                                short_vrls=short_vrls, phase_kind=phase_kind,
                                materials=materials)


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load_library()
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.alvrl_vrl_sum_bvh.argtypes = [p, i, p, i, p, i, p, i, i, p, i, p,
                                      i, p, i, p, u, i, i, i, i, p, i, p, p,
                                      p]
    for fn in (lib.alvrl_vrl_sum_bvh, lib.alvrl_bvh_stack,
               lib.alvrl_max_mats):
        fn.restype = i
    lib.alvrl_error_string.argtypes = [i]
    lib.alvrl_error_string.restype = ctypes.c_char_p
    return lib


def _check(rays, vrls, bvh, medium, uniforms, seed, svv, svs, phase_kind,
           materials=None):
    """Raise on what the kernel does not take: vrl_sum's checks (so grid
    packs, whose rows differ, raise; the extended medium pack and a
    material pack pass), and a well-formed BvhPack."""
    if not isinstance(bvh, BvhPack):
        raise TypeError(f"bvh must be a BvhPack, got {type(bvh)}")
    vs._check(rays, vrls, bvh.tris, medium, uniforms, seed, svv, svs,
              phase_kind, materials=materials, textured=True)
    nodes = bvh.nodes
    if not isinstance(nodes, torch.Tensor) or nodes.dtype != torch.float32 \
            or not nodes.is_contiguous() or nodes.device != rays.device:
        raise ValueError("nodes must be a contiguous float32 tensor on the "
                         "rays' device")
    if nodes.dim() != 2 or nodes.shape[1] != NODE_COLS:
        raise ValueError(f"nodes must be (n, {NODE_COLS}), got "
                         f"{tuple(nodes.shape)}")
    if (nodes.shape[0] == 0) != (bvh.tris.shape[0] == 0):
        raise ValueError("a BVH has nodes exactly when it has triangles")
    if not 0 <= bvh.depth <= BVH_STACK:
        raise ValueError(f"BVH depth {bvh.depth} exceeds the kernel's stack "
                         f"of {BVH_STACK}")


def is_extended(medium, phase_kind, materials):
    """Whether a launch takes the kernel's extended forms (the extended
    medium pack, the mixture phase or a material pack) rather than its
    forms on the (MED_LEN,) pack."""
    return (materials is not None or medium.shape[0] > pk.MED_LEN
            or phase_kind == ph.MIXTURE)


def _launch(lib, rays, vrls, bvh, medium, uniforms, seed, svv, svs,
            short_vrls, phase_kind, counts=None, materials=None):
    """The kernel on checked inputs, on the current stream of the rays'
    card; the counting instantiation when `counts` (len(COUNTS),) int64
    is given; the extended forms (is_extended) on the medium pack with
    its extension, their material forms with `materials`, with the
    textured ray pack their textured form."""
    n_rays, n_vrls = rays.shape[1], vrls.shape[1]
    n_chunks = n_vrls  # one VRL a block
    partial = torch.empty((n_chunks, 3, n_rays), dtype=torch.float32,
                          device=rays.device)
    out = torch.empty((3, n_rays), dtype=torch.float32, device=rays.device)
    ext = is_extended(medium, phase_kind, materials)
    if ext:
        medium = pk.extended_medium(medium)
    with torch.cuda.device(rays.device):
        err = lib.alvrl_vrl_sum_bvh(
            rays.data_ptr(), n_rays, vrls.data_ptr(), n_vrls,
            bvh.nodes.data_ptr(), bvh.nodes.shape[0], bvh.tris.data_ptr(),
            bvh.tris.shape[0], bvh.depth, medium.data_ptr(), int(ext),
            *vs.mat_args(materials), vs.tex_arg(rays, materials),
            None if uniforms is None else uniforms.data_ptr(), seed, svv, svs,
            int(short_vrls), phase_kind, partial.data_ptr(), n_chunks,
            out.data_ptr(), None if counts is None else counts.data_ptr(),
            torch.cuda.current_stream(rays.device).cuda_stream)
    if err != 0:
        raise RuntimeError("vrl_sum_bvh kernel launch failed: CUDA error "
                           f"{err} ({lib.alvrl_error_string(err).decode()})")
    return out


def vrl_sum_bvh(rays, vrls, bvh: BvhPack, medium, *, seed=0, uniforms=None,
                vol_vol_samples=2, vol_surf_samples=2, short_vrls=True,
                phase_kind=ph.HG, materials=None):
    """(3, B) per-ray VRL sums (not normalised by the particle count),
    as ops.vrl_sum.vrl_sum computes them, with the shadow tests against
    the BvhPack's triangles (pack_bvh_tris; any count).

    rays (RAY_ROWS, B), vrls (VRL_ROWS, N) and medium (MED_LEN,), or its
    extended pack for a mixture phase or a strategy other than balance,
    are ops.pack's homogeneous packs (a grid medium's packs raise);
    `materials`, the material pack (ops.vrl_sum.vrl_sum's) with rays
    (MAT_RAY_ROWS, B), takes the material forms, which evaluate each eye
    hit's smooth BSDF, with the textured ray pack (TEX_RAY_ROWS, B) the
    textured form (csrc/vrl_sum_bvh_tex.cu). Random numbers come from
    vrl_sum's Philox stream of `seed`, or from `uniforms` (B, N, 2 *
    vol_vol_samples + vol_surf_samples). CUDA tensors go through the CUDA
    kernel (a launch counted here; the material and textured forms' on
    vrl_sum_bvh.mat_launches too, the textured form's on
    vrl_sum_bvh.tex_launches, the other extended forms' on
    vrl_sum_bvh.mix_launches), CPU tensors through
    vrl_sum_bvh_reference."""
    svv, svs = vol_vol_samples, vol_surf_samples
    _check(rays, vrls, bvh, medium, uniforms, seed, svv, svs, phase_kind,
           materials)
    n_rays, n_vrls = rays.shape[1], vrls.shape[1]
    if rays.device.type == "cpu":
        if uniforms is None:
            uniforms = vs.philox_uniforms(seed, n_rays, n_vrls, 2 * svv + svs)
        return vrl_sum_bvh_reference(
            rays, vrls, bvh, medium, uniforms, vol_vol_samples=svv,
            vol_surf_samples=svs, short_vrls=short_vrls,
            phase_kind=phase_kind, materials=materials)
    lib = _library()
    vs.check_mats_cap(lib, materials)
    if n_rays == 0 or n_vrls == 0:
        return torch.zeros((3, n_rays), dtype=torch.float32,
                           device=rays.device)
    out = _launch(lib, rays, vrls, bvh, medium, uniforms, seed, svv, svs,
                  short_vrls, phase_kind, materials=materials)
    vrl_sum_bvh.launches += 1
    if materials is not None:
        vrl_sum_bvh.mat_launches += 1
        vrl_sum_bvh.tex_launches += vs.tex_arg(rays, materials)
    elif is_extended(medium, phase_kind, materials):
        vrl_sum_bvh.mix_launches += 1
    return out


vrl_sum_bvh.launches = 0  # kernel launches, for showing that a run used the kernel
vrl_sum_bvh.mat_launches = 0  # of them, the material forms'
vrl_sum_bvh.tex_launches = 0  # of them, the textured form's
vrl_sum_bvh.mix_launches = 0  # of them, the other extended forms'


def vrl_sum_bvh_counts(rays, vrls, bvh: BvhPack, medium, *, seed=0,
                       uniforms=None, vol_vol_samples=2, vol_surf_samples=2,
                       short_vrls=True, phase_kind=ph.HG, materials=None):
    """vrl_sum_bvh's sums through the kernel's counting instantiation (a
    launch counted here, not on vrl_sum_bvh), and {name: total} of what
    it met (COUNTS): nodes fetched, boxes and triangles tested by the
    shadow traversals, the shadow segments tested, the open vol-vol and
    vol-surf samples; the box and triangle tests that the shadow
    function needs (a one-box-per-node traversal in child order to the
    first blocker, csrc/vrl_sum_bvh.cu needed_work), and the segments
    that traversal decides otherwise (0 unless the kernel is at
    fault). CUDA tensors only; the extended pack and `materials` as
    vrl_sum_bvh's."""
    svv, svs = vol_vol_samples, vol_surf_samples
    _check(rays, vrls, bvh, medium, uniforms, seed, svv, svs, phase_kind,
           materials)
    if rays.device.type != "cuda":
        raise ValueError("the counting launch needs CUDA tensors")
    lib = _library()
    vs.check_mats_cap(lib, materials)
    counts = torch.zeros(len(COUNTS), dtype=torch.int64, device=rays.device)
    out = _launch(lib, rays, vrls, bvh, medium, uniforms, seed, svv, svs,
                  short_vrls, phase_kind, counts, materials)
    vrl_sum_bvh_counts.launches += 1
    return out, dict(zip(COUNTS, counts.tolist()))


vrl_sum_bvh_counts.launches = 0  # counting launches, as vrl_sum_bvh.launches
