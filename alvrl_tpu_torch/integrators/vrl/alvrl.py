"""The clustered render (Adaptive LightSlice): trace -> slice -> transfer
matrix -> cluster -> clustered render.

Counterpart of alvrl_tpu/integrators/vrl/alvrl.py (render_alvrl and its
stages; vrlIntegrator::{preprocess,prepass} and the clustered render,
vrlIntegrator.cpp:237-356, 542-599) for homogeneous and grid media. The
device stages are the tracer (Woodcock tracking in a grid medium), the
R kernel (ops.vrl_r or vrl_r_hetero, through integrator.build_R_kernel)
and the clustered kernel (ops.vrl_sum_clustered or
vrl_sum_hetero_clustered, through integrator.render_clustered_kernel),
chosen by the scene's medium, both taking the scene's material pack
where its table holds a glossy or layered kind (their material forms,
in either medium); slicing and clustering run
on the host in numpy (integrators.vrl.cluster) and the native refiner
(integrators.vrl.cluster_native).

Pixels are indexed row-major (y * W + x). The host RNGs are those of the
JAX package, numpy Generators seeded from params.seed (slicing: seed + 7,
clustering: seed + 13), so that both give the same slices and tables on
the same R. The device random numbers come from the caller's
torch.Generator: the tracer's uniforms (with the tracking uniforms in a
grid medium), then R's seed, then the render's seed (the JAX package
draws R's key from params.seed on every pass instead; ROADMAP C8).

alvrl_passes is the pipelined schedule of a multi-pass render: pass
k+1's trace, compaction and R build are enqueued before pass k's
render, and pass k+1's host clustering runs while the device renders
pass k. Pass k draws from its own generator, pass_generator(seed, k),
so each pass is render_alvrl's on that generator. The multi-pass
drivers, integrators.progressive.render_progressive (clustered=True)
and render_alvrl_progressive, both run it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from alvrl_tpu_torch.geometry import intersect
from alvrl_tpu_torch.integrators.vrl import cluster as cl
from alvrl_tpu_torch.integrators.vrl import cluster_native
from alvrl_tpu_torch.integrators.vrl import tracer as tracer_mod
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.integrators.vrl.integrator import (
    build_R_kernel,
    draw_seed,
    render_clustered_kernel,
)
from alvrl_tpu_torch.integrators.vrl.vrl import (
    VRLs,
    compact,
    compact_device,
    raise_if_too_small,
)
from alvrl_tpu_torch.scene.scene import Scene
from alvrl_tpu_torch.sensors import perspective


@dataclass
class ALVRLParams:
    vrl_target_num: int = 500
    num_particles: int = 128
    cluster: cl.ClusterParams = None
    seed: int = 0

    def __post_init__(self):
        if self.cluster is None:
            self.cluster = cl.ClusterParams()


def gather_points(scene: Scene):
    """One centre ray per pixel -> (hit positions (W * H, 3), normals,
    valid, the scene's bounding-box diagonal), on the scene's device
    (buildSlices' gather pass, Preprocessor.cpp:1140-1179)."""
    cam = scene.camera
    px, py = torch.meshgrid(torch.arange(cam.width, device=scene.device),
                            torch.arange(cam.height, device=scene.device),
                            indexing="xy")
    ray_o, ray_d = perspective.sample_ray(cam, px.reshape(-1),
                                          py.reshape(-1))
    hit = intersect.intersect_all(ray_o, ray_d, scene.vertices, scene.faces)
    lo, hi = scene.aabb()
    return hit.p, hit.ng, hit.valid, torch.linalg.norm(hi - lo)


@dataclass
class SliceInfo:
    """Per-scene slicing state, built once and reused by every pass
    (Integrator::preprocess, vrlIntegrator.cpp:237-267)."""
    slices: cl.Slices
    repr_rows: list         # per slice, its representative pixels
    slice_u: np.ndarray     # (S,) per-slice pixel undersampling
    global_pu: float
    localities: list


def build_slice_info(scene: Scene, params: ALVRLParams) -> SliceInfo:
    """Gather pass, 6D slicing, representative pixels and localities:
    independent of the VRLs, computed once per scene and camera."""
    p = params.cluster
    pos, ng, valid, diag = gather_points(scene)
    dir_scale = float(diag) / 8.0 * p.slice_curvature_factor
    slices = cl.build_slices(pos.cpu().numpy(), ng.cpu().numpy() * dir_scale,
                             valid.cpu().numpy(), p.target_num_slices)
    host_rng = np.random.default_rng(params.seed + 7)
    repr_rows, slice_u, global_pu = cl.sample_representative_pixels(
        slices, p.target_pixel_undersampling, host_rng)
    localities = cl.build_localities(slices, p.neighbour_count)
    return SliceInfo(slices, repr_rows, slice_u, global_pu, localities)


def build_R_device(scene: Scene, vrls: VRLs, cfg: VRLConfig,
                   slice_info: SliceInfo, seed: int):
    """Device stage of the clustered prepass: the transfer matrix (r_mean,
    r_var), (P, N) each, over the representative pixels' centre rays,
    through the R kernel with Philox seed `seed`, cast to bfloat16 on
    the device (half the bytes to the host; the clustering's cost model
    compares relative luminances and needs 2-3 significant digits; the
    JAX package's r_transfer_half, on by default there). Does not
    synchronise."""
    w = scene.camera.width
    rows = (np.concatenate(slice_info.repr_rows) if slice_info.repr_rows
            else np.zeros((0,), np.int64))
    rows = to_device(np.asarray(rows, np.int64), scene.device)
    ray_o, ray_d = perspective.sample_ray(scene.camera, rows % w, rows // w)
    r_mean, r_var = build_R_kernel(scene, ray_o, ray_d, vrls, seed, cfg)
    return r_mean.to(torch.bfloat16), r_var.to(torch.bfloat16)


def transfer_R(r_mean, r_var):
    """R to the host as float64 numpy arrays (bfloat16 goes through
    float32, as the JAX package upcasts it)."""
    return tuple(r.cpu().float().double().numpy() for r in (r_mean, r_var))


def slice_clusters(r_mean_host, r_var_host, params: ALVRLParams,
                   slice_info: SliceInfo, host_rng=None):
    """The adaptive refinement on the transferred R (the native
    refiner, with the Generator of seed params.seed + 13 unless
    `host_rng` is given): (per-slice ids, per-slice weights,
    fall-back ids, weights, global ids, weights)."""
    if host_rng is None:
        host_rng = np.random.default_rng(params.seed + 13)
    rows_per_slice, off = [], 0
    for rr in slice_info.repr_rows:
        rows_per_slice.append(np.arange(off, off + len(rr)))
        off += len(rr)
    return cluster_native.build_clusters(
        r_mean_host, r_var_host, rows_per_slice, slice_info.slice_u,
        slice_info.global_pu, slice_info.localities, params.cluster,
        host_rng)


def cluster_from_R(r_mean_host, r_var_host, params: ALVRLParams,
                   slice_info: SliceInfo, device, host_rng=None):
    """Host stage of the clustered prepass: slice_clusters, then the
    tables (pack_tables)."""
    return pack_tables(slice_info, *slice_clusters(
        r_mean_host, r_var_host, params, slice_info, host_rng), device)


def pack_tables(slice_info, slice_ids, slice_ws, fb_ids, fb_w, gc_ids,
                gc_w, device):
    """(slice_of_pixel (W * H,) int32 numpy rows, -1 for the fall-back
    pixels; table ids (S, C) int32 and weights (S, C) float32 on
    `device`; the ClusterInfo). C is the widest slice's count: the
    tables are not padded further (no compile to reuse)."""
    info = cl.pack_cluster_info(slice_info.slices.pixel_to_slice, slice_ids,
                                slice_ws, fb_ids, fb_w, gc_ids, gc_w)
    return (info.pixel_to_slice, to_device(info.slice_vrls, device),
            to_device(info.slice_weights, device), info)


def to_device(array, device):
    """A host numpy array on `device`, without waiting for the device: a
    CUDA copy goes from pinned memory, non-blocking."""
    t = torch.as_tensor(array)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def prepare_clustering(scene: Scene, vrls: VRLs, seed: int,
                       params: ALVRLParams, cfg: VRLConfig,
                       slice_info: SliceInfo = None):
    """Slices (unless `slice_info` is given), R with Philox seed `seed`,
    its transfer, the clusters: build_R_device -> transfer_R ->
    cluster_from_R. Returns cluster_from_R's (slice_of_pixel, table ids,
    table weights, info)."""
    if slice_info is None:
        slice_info = build_slice_info(scene, params)
    r_mean, r_var = transfer_R(*build_R_device(scene, vrls, cfg, slice_info,
                                               seed))
    return cluster_from_R(r_mean, r_var, params, slice_info, scene.device)


def fallback_table(info, device):
    """(ids, weights) of the fall-back set on `device`, for
    render_clustered_kernel's second launch, or None when no pixel falls
    back (the usual case in a closed scene) or the set is empty."""
    if not (info.pixel_to_slice < 0).any() or not len(info.fallback_vrls):
        return None
    return (to_device(info.fallback_vrls, device),
            to_device(info.fallback_weights, device))


def render_alvrl(scene: Scene, generator, params: ALVRLParams = None,
                 cfg: VRLConfig = VRLConfig(),
                 tracer_cfg: tracer_mod.TracerConfig = tracer_mod.TracerConfig(),
                 slice_info: SliceInfo = None):
    """One clustered pass: trace and compact the VRLs, R, the clusters,
    the clustered render (fall-back pixels through a second launch of
    the same kernel against the fall-back set). Draws from `generator`
    (a torch.Generator on the CPU) the tracer's uniforms, R's seed and
    the render's seed, in that order. Pass a cached `slice_info` to skip
    the slicing. Returns (image (H, W, 3), vrls, ClusterInfo)."""
    if params is None:
        params = ALVRLParams()
    raw = tracer_mod.trace(scene, generator, params.num_particles,
                           tracer_cfg)
    vrls = compact(raw, params.vrl_target_num,
                   slots_per_particle=tracer_cfg.max_depth)
    sop, tv, tw, info = prepare_clustering(
        scene, vrls, draw_seed(generator), params, cfg, slice_info)
    img = render_clustered_kernel(scene, vrls, sop, tv, tw, generator, cfg,
                                  fallback=fallback_table(info, scene.device))
    return img, vrls, info


def pass_generator(seed: int, k: int):
    """The torch.Generator (CPU) of pass k of a multi-pass render of
    `seed`, seeded from (seed, k)."""
    state = np.random.SeedSequence([seed, k]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def _start_transfer(r_mean, r_var, too_small):
    """Start R's copy to the host (pinned buffers, non-blocking, with
    compact_device's flag) and return (host tensors, an event that
    completes with the copy); on the CPU the tensors themselves."""
    if r_mean.device.type != "cuda":
        return (r_mean, r_var, too_small), None
    host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 for t in (r_mean, r_var, too_small))
    for h, t in zip(host, (r_mean, r_var, too_small)):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _finish_transfer(host, done):
    """Wait for _start_transfer's copy; R as float64 numpy (transfer_R's
    casts). Raises compact's error where compact_device flagged it."""
    if done is not None:
        done.synchronize()
    r_mean, r_var, too_small = host
    raise_if_too_small(too_small)
    return transfer_R(r_mean, r_var)


def alvrl_passes(scene: Scene, passes, seed: int, params: ALVRLParams,
                 cfg: VRLConfig, tracer_cfg: tracer_mod.TracerConfig,
                 slice_info: SliceInfo, timings: dict = None):
    """The clustered passes of a multi-pass render, with the host stage
    pipelined against the device: yields (k, image (H, W, 3) on the
    scene's device, vrls, ClusterInfo) for each pass k of `passes` (a
    range), in order. Pass k draws from pass_generator(seed, k) in
    render_alvrl's order (tracer uniforms, R's seed, the render's
    seed), so its image is render_alvrl's on that generator, bit for
    bit.

    A serial prologue traces, compacts and clusters the first pass;
    then, for each pass k: enqueue pass k+1's trace, compaction
    (compact_device, no sync) and R build, and start R's copy to the
    host; enqueue pass k's render (fall-back launch included, as
    render_alvrl); wait for the copy (the render is queued behind it)
    and cluster pass k+1 on the host while the device renders pass k;
    yield pass k. `timings`, if a dict, gets the stage sums in seconds
    added to: device_enqueue, transfer, cluster."""
    device = scene.device

    def add(stage, t0):
        if timings is not None:
            timings[stage] = (timings.get(stage, 0.0) + time.perf_counter()
                              - t0)

    def trace_pass(k):
        gen = pass_generator(seed, k)
        raw = tracer_mod.trace(scene, gen, params.num_particles, tracer_cfg)
        vrls, too_small = compact_device(raw, params.vrl_target_num,
                                         tracer_cfg.max_depth)
        r = build_R_device(scene, vrls, cfg, slice_info, draw_seed(gen))
        return gen, vrls, _start_transfer(*r, too_small)

    def cluster(copy):
        t0 = time.perf_counter()
        r_host = _finish_transfer(*copy)
        add("transfer", t0)
        t0 = time.perf_counter()
        tables = cluster_from_R(*r_host, params, slice_info, device)
        add("cluster", t0)
        return tables

    passes = list(passes)
    if not passes:
        return
    cur = trace_pass(passes[0])
    tables = cluster(cur[2])
    for i, k in enumerate(passes):
        t0 = time.perf_counter()
        nxt = trace_pass(passes[i + 1]) if i + 1 < len(passes) else None
        gen, vrls, _ = cur
        sop, tv, tw, info = tables
        img = render_clustered_kernel(scene, vrls, sop, tv, tw, gen, cfg,
                                      fallback=fallback_table(info, device))
        add("device_enqueue", t0)
        if nxt is not None:
            tables = cluster(nxt[2])
        yield k, img, vrls, info
        cur = nxt


def render_alvrl_progressive(
        scene: Scene, n_passes: int, seed: int = None,
        params: ALVRLParams = None, cfg: VRLConfig = VRLConfig(),
        tracer_cfg: tracer_mod.TracerConfig = tracer_mod.TracerConfig(),
        timings: dict = None):
    """n_passes clustered passes through alvrl_passes, the pipelined
    schedule (counterpart of alvrl_tpu's render_alvrl_progressive; the
    same passes as integrators.progressive.render_progressive with
    clustered=True, which adds the checkpoint and the pass dumps). The
    slices are built once. `seed` defaults to params.seed.

    Returns (the mean image (H, W, 3) on the scene's device, the last
    pass's vrls, its ClusterInfo). `timings`, if a dict, receives the
    stage sums in seconds: slice, device_enqueue, transfer, cluster,
    wall."""
    if params is None:
        params = ALVRLParams()
    if seed is None:
        seed = params.seed
    t = dict(slice=0.0, device_enqueue=0.0, transfer=0.0, cluster=0.0)
    t_all = time.perf_counter()
    slice_info = build_slice_info(scene, params)
    t["slice"] = time.perf_counter() - t_all
    acc = vrls = info = None
    for _, img, vrls, info in alvrl_passes(scene, range(n_passes), seed,
                                           params, cfg, tracer_cfg,
                                           slice_info, t):
        acc = img if acc is None else acc + img
    img = acc / n_passes
    if scene.device.type == "cuda":
        torch.cuda.synchronize(scene.device)
    t["wall"] = time.perf_counter() - t_all
    if timings is not None:
        timings.update(t)
    return img, vrls, info
