"""The large-mesh render on one card: kernel 7 (ops.vrl_sum_bvh) against
kernel 1 at Cornell scale, the render of a 16k-triangle scene, and the
kernel's scaling with the triangle count.

Counterpart of scripts/bench_bvh_large.py, at its configuration: 64x64
eye rays, 64 particles x depth 8 compacted to 256 VRL slots
(slots_per_particle 8), 2 + 2 samples per pair; a field of n^3 small
cubes (12 n^3 + 12 triangles) or a displaced blob (4 n^2 + 12
triangles) in the Cornell box without its blocker. The JAX script's
XLA-chunked arm has no counterpart: its place is taken by the plain
version (ops.vrl_sum_bvh.vrl_sum_bvh_reference) on a subset of the rays.

    python -m alvrl_tpu_torch.scripts.bench_bvh_large            # main
    python -m alvrl_tpu_torch.scripts.bench_bvh_large scale      # cubes
    python -m alvrl_tpu_torch.scripts.bench_bvh_large scale-blob

Each prints JSON lines on stdout (progress on stderr). The kernel runs
on the card only: with no CUDA device the script fails.
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import replace

import numpy as np
import torch

from alvrl_tpu_torch.geometry import shapes
from alvrl_tpu_torch.integrators.vrl import integrator, tracer, vrl
from alvrl_tpu_torch.ops import vrl_sum as vs
from alvrl_tpu_torch.ops import vrl_sum_bvh as vb
from alvrl_tpu_torch.scene import presets

WIDTH = 64
N_PARTICLES, MAX_DEPTH, N_SLOTS = 64, 8, 256
CUBE_AXES = (11, 16, 22)      # 15,984, 49,164, 127,788 triangles
BLOB_THETAS = (64, 112, 180)  # 16,396, 50,188, 129,612 triangles
SUBSET_RAYS = 256             # rays the plain version is held to


def _with_mesh(base, verts, faces, mats):
    dev = base.vertices.device
    return replace(base,
                   vertices=torch.as_tensor(verts, dtype=torch.float32,
                                            device=dev),
                   faces=torch.as_tensor(faces, dtype=torch.int64, device=dev),
                   material=torch.as_tensor(mats, dtype=torch.int64,
                                            device=dev))


def cube_field_scene(width=64, height=64, n_axis=11, device="cuda"):
    """An n x n x n grid of separated small cubes inside the Cornell box
    without its blocker: 12 n^3 + 12 triangles of volume-filling,
    cull-friendly geometry (the JAX script's, vertex for vertex)."""
    base = presets.cornell_smoke(width=width, height=height,
                                 with_blocker=False, device=device)
    verts = [base.vertices.cpu().numpy()]
    faces = [base.faces.cpu().numpy()]
    mats = [base.material.cpu().numpy()]
    nv = verts[0].shape[0]
    cube_v, cube_f = shapes.cube()
    cube_v = cube_v * 0.028  # small, well separated
    for iz in range(n_axis):
        for iy in range(n_axis):
            for ix in range(n_axis):
                c = np.array([ix, iy, iz]) / (n_axis - 1) * 1.4 - 0.7
                verts.append(cube_v + c)
                faces.append(cube_f + nv)
                mats.append(np.zeros(12, np.int64))
                nv += cube_v.shape[0]
    return _with_mesh(base, np.concatenate(verts).astype(np.float32),
                      np.concatenate(faces), np.concatenate(mats))


def blob_scene(width=64, height=64, n_theta=64, device="cuda"):
    """A displaced, finely tessellated sphere filling about 15 % of the
    box without its blocker: 4 n_theta^2 + 12 triangles of a dense
    object in a sub-volume (the JAX script's, vertex for vertex)."""
    base = presets.cornell_smoke(width=width, height=height,
                                 with_blocker=False, device=device)
    v, f = shapes.sphere(center=(0, 0, 0), radius=1.0, n_theta=n_theta,
                         n_phi=2 * n_theta)
    r = np.linalg.norm(v, axis=1, keepdims=True)
    disp = (0.18 * np.sin(9 * v[:, 0:1]) * np.cos(7 * v[:, 1:2])
            + 0.12 * np.sin(13 * v[:, 2:3]))
    v = v * (1.0 + disp) * 0.35 / np.maximum(r, 1e-9)
    v = v + np.array([0.25, -0.35, 0.3], np.float32)
    base_v = base.vertices.cpu().numpy()
    return _with_mesh(base, np.concatenate([base_v, v]),
                      np.concatenate([base.faces.cpu().numpy(),
                                      f + base_v.shape[0]]),
                      np.concatenate([base.material.cpu().numpy(),
                                      np.zeros(len(f), np.int64)]))


def scene_of(kind, n, width=WIDTH, device="cuda"):
    """The bench scene `kind` ("cubes" or "blob") at size n."""
    make = cube_field_scene if kind == "cubes" else blob_scene
    return make(width, width, n, device=device)


def bench_vrls(scene, seed=1):
    """The bench's VRLs: N_PARTICLES particles x depth MAX_DEPTH traced
    with a generator of `seed`, compacted to N_SLOTS slots."""
    return vrl.compact(
        tracer.trace(scene, torch.Generator().manual_seed(seed), N_PARTICLES,
                     tracer.TracerConfig(max_depth=MAX_DEPTH)),
        N_SLOTS, slots_per_particle=MAX_DEPTH)


def subset_rays(n_rays, n=SUBSET_RAYS):
    """The eye rays the plain version is held to: n rays evenly spread
    over the frame."""
    return torch.arange(0, n_rays, max(1, n_rays // n))[:n]


def plain_on_subset(packs, rows, seed, **kw):
    """vrl_sum_bvh_reference on the eye rays `rows` of the packs, on the
    kernel's Philox stream of `seed` for those rays: (3, len(rows))."""
    rays, vrls, bvh, medium = packs
    rows = rows.to(rays.device)
    u = vs.philox_draws(seed, rows[:, None],
                        torch.arange(vrls.shape[1], device=rays.device)[None],
                        6)
    return vb.vrl_sum_bvh_reference(rays[:, rows].contiguous(), vrls, bvh,
                                    medium, u, **kw)


def kernel_ms(fn, n_warm=2, n_timed=5):
    """Median device time (ms) of fn, by CUDA events, after warm-up."""
    for _ in range(n_warm):
        fn()
    times = []
    for _ in range(n_timed):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _card():
    if not torch.cuda.is_available():
        raise SystemExit("bench_bvh_large: no CUDA device; the kernel runs "
                         "on the card only")
    return torch.device("cuda", 0)


def main():
    """Kernel 7 against kernel 1 at Cornell scale (the same samples and
    shadow tests: the sums differ in their last bits at most, where the
    two kernels' fused multiply-adds differ), then the 16k-triangle cube
    field: the render, the kernel against the plain version on
    SUBSET_RAYS rays, and the kernel's time."""
    dev = _card()
    sc0 = presets.cornell_smoke(32, 32, device=dev)
    vr0 = vb.sort_vrls_morton(bench_vrls(sc0, seed=0))
    _, _, _, packs0 = integrator.pack_frame(sc0, vr0)
    bvh0 = vb.pack_bvh_tris(sc0.vertices, sc0.faces, sc0.opaque_faces())
    a = vs.vrl_sum(*packs0, seed=11)
    b = vb.vrl_sum_bvh(packs0[0], packs0[1], bvh0, packs0[3], seed=11)
    print(json.dumps({
        "check": "kernel 7 vs kernel 1", "triangles": int(sc0.faces.shape[0]),
        "rays_differing": int((a != b).any(dim=0).sum()),
        "largest_rel": float(((a - b).abs() / torch.clamp(
            a.abs(), min=vs.HOMOG_FLOOR)).max())}))

    scene = cube_field_scene(device=dev)
    vrls = bench_vrls(scene)
    t0 = time.perf_counter()
    img = integrator.render_with_vrls_kernel_bvh(
        scene, vrls, torch.Generator().manual_seed(5))
    torch.cuda.synchronize()
    render_ms = (time.perf_counter() - t0) * 1e3
    _, _, _, packs = integrator.pack_frame_bvh(scene, vrls)
    out = vb.vrl_sum_bvh(*packs, seed=11)
    rows = subset_rays(out.shape[1])
    median, share = vs.homog_bar(out[:, rows.to(dev)].T,
                                 plain_on_subset(packs, rows, 11).T)
    print(json.dumps({
        "scene": "cubes", "triangles": int(scene.faces.shape[0]),
        "depth": packs[2].depth, "image_mean": float(img.mean()),
        "render_ms": render_ms, "vs_plain_median": median,
        "vs_plain_share": share,
        "kernel_ms": kernel_ms(lambda: vb.vrl_sum_bvh(*packs, seed=11))}))


def scaling_sweep(kind="cubes"):
    """Kernel-only scaling with the triangle count over the JAX script's
    three sizes of one scene family: ms, pair-sample evals/s, the node
    fetches, box and triangle tests per shadow segment and those the
    shadow function needs (counting launch), the depth, and each step's time ratio against its triangle
    ratio."""
    dev = _card()
    rows = []
    for n in CUBE_AXES if kind == "cubes" else BLOB_THETAS:
        scene = scene_of(kind, n, device=dev)
        _, _, _, packs = integrator.pack_frame_bvh(scene, bench_vrls(scene))
        ms = kernel_ms(lambda: vb.vrl_sum_bvh(*packs, seed=11))
        _, counts = vb.vrl_sum_bvh_counts(*packs, seed=11)
        evals = packs[0].shape[1] * packs[1].shape[1] * 4
        rows.append(dict(scene=kind, n=n, triangles=int(scene.faces.shape[0]),
                         depth=packs[2].depth, ms=ms,
                         pair_evals_per_s=evals / (ms / 1e3),
                         **{f"{k}_per_segment": counts[k]
                            / max(counts["segments"], 1)
                            for k in ("node_fetches", "box_tests",
                                      "tri_tests", "needed_box_tests",
                                      "needed_tri_tests")}))
        print(json.dumps(rows[-1]), flush=True)
    for a, b in zip(rows, rows[1:]):
        tri_ratio = b["triangles"] / a["triangles"]
        print(f"triangles x{tri_ratio:.2f} -> time x{b['ms'] / a['ms']:.2f}",
              file=sys.stderr)
    return rows


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "scale":
        scaling_sweep("cubes")
    elif len(sys.argv) > 1 and sys.argv[1] == "scale-blob":
        scaling_sweep("blob")
    else:
        main()
