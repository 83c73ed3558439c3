"""Adaptive LightSlice slicing and cluster tables (host numpy).

The port's own copy of the slicing half of
alvrl_tpu/integrators/vrl/cluster.py: the same algorithms with the same
RNG calls in the same order, so that it gives the JAX module's slices,
representatives and localities bit for bit on the same inputs.

Counterpart of src/integrators/vrl/Preprocessor.cpp, re-structured:

  * slicing (6D median split of gather points), representative-pixel
    sampling and locality kNN are host-side numpy — inherently
    sequential, tiny data, run once per scene (SURVEY §7 step 9);
  * the transfer matrix R is built on device (integrator.build_R_kernel,
    the R-mode kernel);
  * the adaptive cluster refinement on R is the native refiner
    (cluster_native.build_clusters, built by g++ at first use, or it
    raises), which takes each slice's rows and locality weights from
    slice_locality;
  * the result is packed into per-slice representative/weight tables
    (pack_cluster_info) for the clustered render kernel.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

UINT32_MAX = np.uint32(0xFFFFFFFF)


# ---------------------------------------------------------------------------
# Slicing (Preprocessor.cpp:1130-1499)
# ---------------------------------------------------------------------------

@dataclass
class Slices:
    pixel_to_slice: np.ndarray       # (H*W,) uint32, UINT32_MAX = no gather pt
    members: list                    # per slice: np.ndarray of pixel indices
    pos_centroid: np.ndarray         # (S, 3)
    dir_centroid: np.ndarray         # (S, 3)


def build_slices(positions, directions, valid, target_num_slices):
    """6D top-down median split.

    positions: (P, 3) gather points; directions: (P, 3) scaled normals;
    valid: (P,) bool. Invalid pixels map to UINT32_MAX (fall-back
    cluster), the semantics of getSlices (Preprocessor.cpp:1200-1227).
    """
    n = len(positions)
    pixel_to_slice = np.full((n,), UINT32_MAX, dtype=np.uint32)
    good = np.nonzero(valid)[0]
    if len(good) == 0:
        return Slices(pixel_to_slice, [], np.zeros((0, 3)), np.zeros((0, 3)))

    six = np.concatenate([positions, directions], axis=1).astype(np.float64)
    six = np.where(valid[:, None], six, 0.0)  # nodes only index valid ids

    counter = 0

    def make_node(idx):
        nonlocal counter
        counter += 1
        if len(idx) == 1:
            return (-0.0, counter, idx, None, None, None, None)
        lo = six[idx].min(axis=0)
        hi = six[idx].max(axis=0)
        diff = hi - lo
        # distance = 6D bbox diagonal (sliceDistance of min/max corners)
        dist = float(np.sqrt(np.sum(diff * diff)))
        # split on max-extent dim, position dims vs direction dims chosen
        # by larger extent within each triplet (findSplit, :1432-1487)
        dim_pos = int(np.argmax(diff[:3]))
        dim_dir = int(np.argmax(diff[3:]))
        if diff[:3][dim_pos] > diff[3:][dim_dir]:
            dim = dim_pos
        else:
            dim = 3 + dim_dir
        split = lo[dim] + 0.5 * diff[dim]
        centroid = lo + 0.5 * diff
        return (-dist, counter, idx, dim, split, centroid[:3], centroid[3:])

    heap = [make_node(good)]
    while len(heap) < target_num_slices and -heap[0][0] > 0:
        _, _, idx, dim, split, _, _ = heapq.heappop(heap)
        larger = six[idx][:, dim] > split
        heapq.heappush(heap, make_node(idx[~larger]))
        heapq.heappush(heap, make_node(idx[larger]))

    members = []
    pos_c = []
    dir_c = []
    for s, (_, _, idx, _, _, pc, dc) in enumerate(heap):
        members.append(idx)
        pixel_to_slice[idx] = s
        if pc is None:  # singleton: centroid is the point itself
            pc, dc = six[idx[0]][:3], six[idx[0]][3:]
        pos_c.append(pc)
        dir_c.append(dc)
    return Slices(
        pixel_to_slice, members,
        np.asarray(pos_c), np.asarray(dir_c),
    )


def sample_representative_pixels(slices: Slices, target_undersampling, rng):
    """Per slice: pick ~numPixels/undersampling representative pixels,
    at least 2 (Slice::sampleRepresentativePixels, :66-121).
    Returns (list of index arrays, slice_undersampling (S,), global_pu)."""
    repr_idx = []
    slice_u = []
    total = 0
    total_repr = 0
    for idx in slices.members:
        n = len(idx)
        target = int(0.5 + n / target_undersampling)
        target = max(target, min(2, n))
        target = min(target, n)
        sel = rng.choice(idx, size=target, replace=False) if target < n else idx.copy()
        repr_idx.append(np.asarray(sel))
        slice_u.append(target / n)
        total += n
        total_repr += target
    return repr_idx, np.asarray(slice_u), (total_repr / max(total, 1))


def build_localities(slices: Slices, neighbour_count):
    """kNN among slice centroids in 6D (buildLocalities, :1241-1293).
    Returns per slice a list of (neighbour_idx, distance)."""
    s = len(slices.members)
    if neighbour_count <= 0 or s <= 1:
        return [[] for _ in range(s)]
    c = np.concatenate([slices.pos_centroid, slices.dir_centroid], axis=1)
    d2 = np.sum((c[:, None, :] - c[None, :, :]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    k = min(neighbour_count, s - 1)
    out = []
    for i in range(s):
        nn = np.argpartition(d2[i], k - 1)[:k]
        out.append([(int(j), float(np.sqrt(d2[i, j]))) for j in nn])
    return out


# ---------------------------------------------------------------------------
# Parameters, locality weights and tables (buildClusters,
# Preprocessor.cpp:133-283)
# ---------------------------------------------------------------------------

@dataclass
class ClusterParams:
    target_num_slices: int = 100
    target_pixel_undersampling: float = 64.0
    slice_curvature_factor: float = 0.5
    neighbour_count: int = 0
    neighbour_weight: float = 0.0
    global_cluster: bool = False
    global_undersampling: float = -1.0
    local_refinement: bool = True
    local_undersampling: float = -1.0
    fallback_undersampling: float = 5.0
    depth_correction: float = 1.0


@dataclass
class ClusterInfo:
    """Device-ready clustering result (counterpart of vrlClusterInfo,
    vrlIntegrator.cpp:17-115), padded to fixed shapes."""

    pixel_to_slice: np.ndarray    # (H*W,) int32; -1 => fall-back
    slice_vrls: np.ndarray        # (S, Cmax) int32 vrl ids (pad 0)
    slice_weights: np.ndarray     # (S, Cmax) f32 (pad 0)
    fallback_vrls: np.ndarray     # (Cf,) int32
    fallback_weights: np.ndarray  # (Cf,) f32
    gc_vrls: np.ndarray           # global-cluster representatives
    gc_weights: np.ndarray


def slice_locality(rows_per_slice, localities, i, neighbour_weight):
    """(row indices, locality weights) of slice i's clustering: its own
    rows, and with neighbour_weight > 0 its neighbours' rows weighted by
    inverse centroid distance (buildClusters)."""
    rows = [np.asarray(rows_per_slice[i], np.int64)]
    if neighbour_weight > 0 and localities[i]:
        nb_w = []
        for (j, dist) in localities[i]:
            rows.append(np.asarray(rows_per_slice[j], np.int64))
            nb_w.append(1.0 / max(dist, 1e-30))
        summed_nb = sum(nb_w)
        slice_w = summed_nb * (1 - neighbour_weight) / neighbour_weight
        norm = 1.0 / (slice_w + summed_nb)
        weights = [np.full(len(rows[0]), slice_w * norm / len(rows[0]))]
        for k in range(len(localities[i])):
            weights.append(
                np.full(len(rows[k + 1]), nb_w[k] * norm / len(rows[k + 1])))
        loc_w = np.concatenate(weights)
    else:
        loc_w = np.full(len(rows[0]), 1.0 / max(len(rows[0]), 1))
    return np.concatenate(rows), loc_w


def pack_cluster_info(
    pixel_to_slice, slice_ids, slice_ws, fb_ids, fb_w, gc_ids, gc_w
) -> ClusterInfo:
    """Pad per-slice representative lists to a fixed (S, Cmax) table."""
    s = len(slice_ids)
    cmax = max([len(a) for a in slice_ids] + [1])
    vrls = np.zeros((s, cmax), np.int32)
    ws = np.zeros((s, cmax), np.float32)
    for i in range(s):
        k = len(slice_ids[i])
        vrls[i, :k] = slice_ids[i]
        ws[i, :k] = slice_ws[i]
    p2s = pixel_to_slice.astype(np.int64)
    p2s = np.where(p2s == int(UINT32_MAX), -1, p2s).astype(np.int32)
    return ClusterInfo(
        pixel_to_slice=p2s,
        slice_vrls=vrls,
        slice_weights=ws,
        fallback_vrls=np.asarray(fb_ids, np.int32),
        fallback_weights=np.asarray(fb_w, np.float32),
        gc_vrls=np.asarray(gc_ids, np.int32),
        gc_weights=np.asarray(gc_w, np.float32),
    )
