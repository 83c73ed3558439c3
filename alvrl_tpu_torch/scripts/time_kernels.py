"""Time kernels 1-6 and 8-11 (PERF.md's table) on one
card, with their registers and spills, for A/Bs of two trees.

The inputs are chip_smoke.py's: config 1 (cornell_smoke 128x128, the 512
bench VRLs; phases 3-9), config 2 (phases 11-14: its scene, tracer
seed, slicing, clustering and kernel seed) and config 4 (phases 15-24),
each kernel at its main-path shape: vrl_sum and vrl_sum_bwd at config 1;
vrl_r, vrl_sum_clustered and vrl_sum_clustered_bwd at config 2; their
grid instantiations at config 4 (vrl_sum_hetero and vrl_sum_hetero_bwd
over all 262,144 x 512 pairs). The script uses only functions that
every tree of the port since the clustered gradients has, so one copy
times two trees in turn on one card, each run in its own process with
that tree first on the path:

    cd <tree> && PYTHONPATH=. python3 <this file>

(`python3 -m alvrl_tpu_torch.scripts.time_kernels` from a tree's root
times that tree). Prints one JSON line: the card, the package timed, its
kernel library's "name<instantiation> R regs S B spill" lines, and per
kernel the median and spread of windows of launches in a row timed by
CUDA events (the clustered kernels as bare launches on pre-grouped
tiles, the rest through their wrappers).

With --grid-split it times only the grid sum (vrl_sum_hetero) and its
VJP (vrl_sum_hetero_bwd) at config 4, each on the full inputs and with
one part of its work taken away, to split their time into the shadow
sweep, the density gathers, the density atomics and the rest: no
triangles (no wall ever blocks a segment inside the box, so this drops
the whole sweep), a 1x1x1 density of the grid's mean under the same
medium pack (every gather then reads one address), a zero output
cotangent (every cotangent is then 0 and no density scatter is made)
and a one-step U-V quadrature. Those launches are for timing only;
their outputs are discarded. It also prints the blocks and warps
resident per SM of both grid instantiations, where the tree's library
answers that query.

With --config1-split it times kernel 1 (vrl_sum) at config 1 whole and
with each part of its shadow sweep taken away: no triangles (T = 0, no
sweep), no plane pre-reject (a Wald test for every triangle; trees from
the pre-reject on); with the checking launch's counts (triangle tests
and skips per segment), the registers and the blocks resident per SM.

With --bvh it times kernel 7 (vrl_sum_bvh) over chip_smoke.py phase
30's six large-mesh scenes (scripts/bench_bvh_large.py: cube fields and
blobs of 16k-130k triangles, 64x64 eye rays x 256 VRLs) with the
counting launch's counts per shadow segment (node fetches, box and
triangle tests, and on trees that count it the work the shadow function
needs), and kernel 1 against kernel 7 at config-1 inputs.

With --glossy it times the forms that take a material pack or the
extended medium pack beside the forms they extend, on the same inputs
(trees from those forms on): the material forms of kernels 3, 4 and 6
(nearest and trilinear) on config 4's packs with its table packed for
them, against the diffuse forms; kernel 7's material form on the
15,984-triangle cube field with its table packed for it, and its
extended form there in a medium of the maximum strategy, against its
form on the plain pack.

With --bwd-split it times kernel 8 (vrl_sum_bwd) on chip_smoke.py phase
9's inputs (config 1's train step at sigma_a x 2: 16,384 rays x 1,536
traced VRL slots, the timed seed and output cotangent) whole and with
no triangles (T = 0, no shadow sweep), beside kernel 1 (vrl_sum) on the
same inputs and seed, whole and with no triangles; with kernel 1's
checking counts on those samples (the segments kernel 8 replays) and
the blocks resident per SM of both homogeneous instantiations.

With --clustered-split it times kernel 11 (vrl_sum_hetero_clustered_bwd,
a bare launch on pre-grouped tiles) on config 4's clustered inputs
(chip_smoke.py phase 17) whole and with --grid-split's ablations: no
triangles, a 1x1x1 density of the grid's mean (with the scatters on,
every reduction then goes to one address: it measures contention; the
gathers are "gbar_0_one_voxel" against "gbar_0"), a zero output
cotangent (no density scatter), both, and a one-step U-V quadrature;
with the
blocks resident per SM of the grid backward instantiations, where the
tree's library answers.

Both splits use only functions that every tree of the port since kernel
1's checking launch has (a tree without the clustered backward's
occupancy query prints no blocks for it), so they time a parent and a
change in turn. Each takes about 25 s a tree.

With --grid-clustered-split [--outputs PATH] it times kernel 4
(vrl_sum_hetero_clustered, a bare launch on pre-grouped tiles) and
kernel 6 (vrl_r_hetero on the representative rays) on config 4's
clustered inputs, each whole, with no triangles, with a 1x1x1 density
of the grid's mean and with a one-step U-V quadrature (--grid-split's
ablations without the backward's); with both kernels' checking counts
(triangle tests and
skips per shadow segment) on trees that have the grid pre-reject, and
the blocks resident per SM of both grid instantiations where the
tree's library answers; --outputs saves or compares both kernels'
outputs, as --config2-split's. It takes about 25 s a tree.

With --config2-split [--outputs PATH] it times kernels 5 (vrl_r on
the representative rays), 10 (vrl_sum_clustered_bwd, a bare launch on
its host layout) and 2 (vrl_sum_clustered, a bare launch on tiles
grouped at its own tile where the tree's library has one) on config 2's
clustered inputs (chip_smoke.py phases 11-14 and 25-26), each whole,
with no triangles, and in its checking launch (kernels 5 and 2) and its
launch without the plane pre-reject (kernels 10 and 2) on trees that
have them; with kernels 5's and 2's checking counts, each kernel's tile
and block counts and the blocks resident per SM where the tree's
library answers. With --outputs, the outputs of kernels 5, 10 and 2 are
saved to PATH if it does not exist, else compared with what it holds
(the largest difference of each, and whether it is bit-identical), so
that runs of two trees in turn check that the change computes what the
parent does. It takes about 25 s a tree.

With --trainer it runs the density-recovery trainer
(scripts.recover_density at its defaults, as chip_smoke.py phase 21:
64x64, a 16^3 grid, four views, 256 VRLs): after two warm-up steps, the
grid sum and its VJP on one step's inputs (the four views' packs at the
current estimate, a seeded output cotangent; four launches of each per
window call, as a step makes them) by CUDA events; then eight steps by
the host clock (each part synchronised, as density_step times them),
then eight more under torch.profiler, for the device's busy time per
step (the union of its operations), the two kernels' share of it and
the idle share. Each set of eight steps holds one retrace.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
from dataclasses import replace

import numpy as np
import torch

from alvrl_tpu_torch.integrators.vrl import alvrl, integrator, tracer, vrl
from alvrl_tpu_torch.integrators.vrl import cluster as cl
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.media import heterogeneous as gmed
from alvrl_tpu_torch.ops import _build
from alvrl_tpu_torch.ops import vrl_r as vr
from alvrl_tpu_torch.ops import vrl_sum as vs
from alvrl_tpu_torch.ops import vrl_sum_bwd as bwd
from alvrl_tpu_torch.ops import vrl_sum_clustered as vsc
from alvrl_tpu_torch.ops import vrl_sum_clustered_bwd as cb
from alvrl_tpu_torch.scene import presets
from alvrl_tpu_torch.scripts import recover_density as rd
from alvrl_tpu_torch.sensors import perspective

BENCH_VRLS = "data/bench_vrls.txt"
# (scene, tracer depth, tracer seed, particles, slices, undersampling,
# kernel seed) of chip_smoke.py's config 2 and config 4
CONFIGS = {
    "config2": (lambda dev: presets.cornell_smoke(128, 128, device=dev), 16,
                11, 128, 100, 64.0, 20261017),
    "config4": (lambda dev: presets.cornell_grid_smoke(512, 512, grid_res=48,
                                                       device=dev),
                10, 41, 192, 128, 128.0, 20261018),
}


def windows(fn, n_windows, batch):
    """Per-call device times (ms) of fn: n_windows CUDA-event windows of
    `batch` calls in a row, after two warm-up calls; (median, spread)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(n_windows):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    med = statistics.median(times)
    return {"ms": med, "spread": (max(times) - min(times)) / med}


def registers():
    """'name<instantiation> R regs S B spill' for each kernel of the
    library's compiler report."""
    out, name, spill = [], None, "0"
    for line in _build.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m[1]
        elif name and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line)[1]
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)[1]
            out.append(f"{name} {regs} regs {spill} B spill")
            name = None
    return sorted(out)


def config1(dev, cfg):
    scene = presets.cornell_smoke(128, 128, device=dev)
    vrls = vrl.compact(vrl.load_ascii(BENCH_VRLS, particle_count=78.0,
                                      device=dev), 512)
    packs = integrator.pack_frame(scene, vrls)[3]
    gbar = torch.as_tensor(np.random.default_rng(2).uniform(
        0.5, 1.5, (3, packs[0].shape[1])).astype(np.float32), device=dev)
    return {"vrl_sum": windows(lambda: vs.vrl_sum(*packs, seed=20261016),
                               10, 10),
            "vrl_sum_bwd": windows(lambda: bwd.vrl_sum_bwd(
                *packs, gbar, seed=20261016), 10, 10)}


def cluster_inputs(dev, make_scene, depth, tracer_seed, particles, slices,
                   undersampling, seed, cfg):
    """The clustered kernels' inputs of one of CONFIGS (chip_smoke.py's):
    scene, VRLs, slice info, tables, packs, tiles and host layout, and a
    seeded output cotangent."""
    scene = make_scene(dev)
    params = alvrl.ALVRLParams(
        vrl_target_num=512, num_particles=particles, seed=0,
        cluster=cl.ClusterParams(target_num_slices=slices,
                                 target_pixel_undersampling=undersampling))
    vrls = vrl.compact(
        tracer.trace(scene, torch.Generator().manual_seed(tracer_seed),
                     particles, tracer.TracerConfig(max_depth=depth)),
        512, slots_per_particle=depth)
    info = alvrl.build_slice_info(scene, params)
    sop, tv, tw, _ = alvrl.prepare_clustering(scene, vrls, seed, params, cfg,
                                              info)
    packs = integrator.pack_frame(scene, vrls)[3]
    n_rays = packs[0].shape[1]
    grid = None if len(packs) == 4 else (packs[4], cfg.uv_tau_steps)
    ray_block = vsc._library().alvrl_ray_block()
    # the forward's tile, where the tree's library has its own
    fwd_block = (vsc.ray_block(grid is not None) if hasattr(vsc, "ray_block")
                 else ray_block)
    tiles = [torch.as_tensor(a, device=dev)
             for a in vsc.group_by_slice(sop, fwd_block)]
    # the backward's tile, where the tree's library has its own
    bwd_block = (cb.ray_block(grid is not None) if hasattr(cb, "ray_block")
                 else ray_block)
    layout = cb.host_layout(sop, tv, vrls.capacity, bwd_block, dev)
    gbar = torch.as_tensor(np.random.default_rng(3).uniform(
        0.5, 1.5, (3, n_rays)).astype(np.float32), device=dev)
    return dict(scene=scene, vrls=vrls, info=info, sop=sop, tv=tv, tw=tw,
                packs=packs, grid=grid, kind=scene.medium.phase_kind,
                tiles=tiles, layout=layout, gbar=gbar, seed=seed)


def rep_packs(c):
    """The R kernel's packs (the representative pixels' centre rays, as
    alvrl.build_R_device makes them) of cluster_inputs' result `c`."""
    scene, info = c["scene"], c["info"]
    rows = torch.as_tensor(np.concatenate(info.repr_rows),
                           device=c["packs"][0].device)
    w = scene.camera.width
    return integrator.pack_rays_vrls(scene, *perspective.sample_ray(
        scene.camera, rows % w, rows // w), c["vrls"])[1]


def clustered(dev, make_scene, depth, tracer_seed, particles, slices,
              undersampling, seed, cfg):
    c = cluster_inputs(dev, make_scene, depth, tracer_seed, particles, slices,
                       undersampling, seed, cfg)
    scene, vrls, info, tv, tw, packs, grid, kind, tiles, layout, gbar = (
        c[k] for k in ("scene", "vrls", "info", "tv", "tw", "packs", "grid",
                       "kind", "tiles", "layout", "gbar"))
    lib = vsc._library()
    n_rays = packs[0].shape[1]
    out = torch.zeros((3, n_rays), device=dev)
    packs_r = rep_packs(c)
    kw = dict(seed=seed) if grid is None else dict(seed=seed,
                                                   uv_steps=grid[1])
    if grid is None:
        return {
            "vrl_r": windows(lambda: vr.vrl_r(*packs_r, **kw), 10, 10),
            "vrl_sum_clustered": windows(lambda: vsc._launch(
                lib, *packs, *tiles, tv, tw, None, seed, 2, 2, True, kind,
                out), 10, 10),
            "vrl_sum_clustered_bwd": windows(lambda: cb._launch(
                cb._library(), *packs, layout, tv, tw, None, seed, 2, 2,
                True, kind, gbar), 10, 10)}
    return {
        "vrl_sum_hetero": windows(lambda: vs.vrl_sum_hetero(*packs, **kw),
                                  5, 3),
        "vrl_r_hetero": windows(lambda: vr.vrl_r_hetero(*packs_r, **kw), 10,
                                10),
        "vrl_sum_hetero_clustered": windows(lambda: vsc._launch(
            lib, *packs[:4], *tiles, tv, tw, None, seed, 2, 2, True, kind,
            out, grid), 10, 10),
        "vrl_sum_hetero_bwd": windows(lambda: bwd.vrl_sum_hetero_bwd(
            *packs, gbar, **kw), 5, 3),
        "vrl_sum_hetero_clustered_bwd": windows(lambda: cb._launch(
            cb._library(), *packs[:4], layout, tv, tw, None, seed, 2, 2,
            True, kind, gbar, grid), 10, 5)}


def grid_split(dev, cfg):
    """{kernel/variant: timing} of vrl_sum_hetero and vrl_sum_hetero_bwd
    at config 4 with parts of their work taken away (the module
    docstring), and {kernel: blocks per SM} where the library answers."""
    make_scene, depth, tracer_seed, particles, _, _, seed = CONFIGS["config4"]
    scene = make_scene(dev)
    vrls = vrl.compact(
        tracer.trace(scene, torch.Generator().manual_seed(tracer_seed),
                     particles, tracer.TracerConfig(max_depth=depth)),
        512, slots_per_particle=depth)
    rays, vpack, tris, med, dens = integrator.pack_frame(scene, vrls)[3]
    gbar = torch.as_tensor(np.random.default_rng(3).uniform(
        0.5, 1.5, (3, rays.shape[1])).astype(np.float32), device=dev)
    uv = cfg.uv_tau_steps
    one_voxel = dens.mean().reshape(1, 1, 1).contiguous()
    no_tris = tris[:0].contiguous()
    zero = torch.zeros_like(gbar)
    variants = {"full": (tris, dens, uv, gbar),
                "no_triangles": (no_tris, dens, uv, gbar),
                "one_voxel": (tris, one_voxel, uv, gbar),
                "uv_steps_1": (tris, dens, 1, gbar),
                "gbar_0": (tris, dens, uv, zero),
                "gbar_0_one_voxel": (tris, one_voxel, uv, zero)}
    times = {}
    for name, (t, d, u, g) in variants.items():
        if not name.startswith("gbar_0"):
            times[f"vrl_sum_hetero/{name}"] = windows(
                lambda: vs.vrl_sum_hetero(rays, vpack, t, med, d, seed=seed,
                                          uv_steps=u), 5, 3)
        times[f"vrl_sum_hetero_bwd/{name}"] = windows(
            lambda: bwd.vrl_sum_hetero_bwd(rays, vpack, t, med, d, g,
                                           seed=seed, uv_steps=u), 5, 3)
    occ = {}
    if hasattr(vs, "occupancy"):  # trees from the grid redesign on
        warps_per_block = bwd._library().alvrl_ray_block() // 32
        for entry in ("vrl_sum", "vrl_sum_bwd"):
            blocks = vs.occupancy(entry, True, tris.shape[0], uv,
                                  scene.medium.phase_kind, cfg.short_vrls)
            occ[f"{entry}<grid>"] = {"blocks": blocks,
                                     "warps": blocks * warps_per_block}
    return times, occ


def config1_packs(dev):
    scene = presets.cornell_smoke(128, 128, device=dev)
    vrls = vrl.compact(vrl.load_ascii(BENCH_VRLS, particle_count=78.0,
                                      device=dev), 512)
    return integrator.pack_frame(scene, vrls)[3]


def config1_split(dev):
    """{variant: timing} of kernel 1 at config 1 with parts of its sweep
    taken away, the checking launch's counts and the blocks per SM."""
    packs = config1_packs(dev)
    rays, vpack, tris, med = packs
    seed = 20261016
    times = {"whole": windows(lambda: vs.vrl_sum(*packs, seed=seed), 10, 10),
             "no_triangles": windows(lambda: vs.vrl_sum(
                 rays, vpack, tris[:0].contiguous(), med, seed=seed), 10, 10)}
    out = {"split": times}
    if hasattr(vs, "MODE_NO_REJECT"):  # trees from the plane pre-reject on
        lib = vs._library()
        times["no_pre_reject"] = windows(lambda: vs._launch(
            lib, *packs, None, seed, 2, 2, True, 0, mode=vs.MODE_NO_REJECT),
            10, 10)
        counts = vs.vrl_sum_check(*packs, seed=seed)[1]
        seg = max(counts["segments"], 1)
        out["check"] = {**counts, "considered_per_segment":
                        counts["considered"] / seg, "skipped_share":
                        counts["skipped"] / max(counts["considered"], 1)}
    if hasattr(vs, "occupancy"):
        blocks = vs.occupancy("vrl_sum", False, tris.shape[0])
        out["occupancy"] = {"blocks": blocks, "warps": blocks * 4}
    return out


# chip_smoke.py phases 8-9: config 1's tracer (particles, depth), the
# train step's generator seed and the render seed's generator seed
STEP_TRACER, STEP_SEED, RENDER_SEED = (128, 12), 7, 1


def step_inputs(dev):
    """chip_smoke.py phase 9's timed inputs: the packs of config 1's train
    step at sigma_a x 2 (its VRLs traced as the step traces them), the
    output cotangent and the kernel seed."""
    preset = presets.cornell_smoke(128, 128, device=dev)
    scene = replace(preset, medium=replace(
        preset.medium, sigma_a=preset.medium.sigma_a * 2))
    particles, depth = STEP_TRACER
    vrls = tracer.trace(scene, torch.Generator().manual_seed(STEP_SEED),
                        particles, tracer.TracerConfig(max_depth=depth))
    packs = integrator.pack_frame(scene, vrls)[3]
    gbar = torch.as_tensor(np.random.default_rng(2).uniform(
        0.5, 1.5, (3, packs[0].shape[1])).astype(np.float32), device=dev)
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=torch.Generator()
                             .manual_seed(RENDER_SEED)))
    return packs, gbar, seed


def bwd_split(dev):
    """{variant: timing} of kernels 8 and 1 on phase 9's inputs, whole
    and with no triangles; kernel 1's checking counts there; the blocks
    per SM of both."""
    packs, gbar, seed = step_inputs(dev)
    rays, vpack, tris, med = packs
    no_tris = tris[:0].contiguous()
    times = {
        "vrl_sum_bwd/whole": windows(
            lambda: bwd.vrl_sum_bwd(*packs, gbar, seed=seed), 10, 10),
        "vrl_sum_bwd/no_triangles": windows(
            lambda: bwd.vrl_sum_bwd(rays, vpack, no_tris, med, gbar,
                                    seed=seed), 10, 10),
        "vrl_sum/whole": windows(lambda: vs.vrl_sum(*packs, seed=seed),
                                 10, 10),
        "vrl_sum/no_triangles": windows(
            lambda: vs.vrl_sum(rays, vpack, no_tris, med, seed=seed), 10, 10)}
    counts = vs.vrl_sum_check(*packs, seed=seed)[1]
    seg = max(counts["segments"], 1)
    occ = {entry: vs.occupancy(entry, False, tris.shape[0])
           for entry in ("vrl_sum", "vrl_sum_bwd")}
    return {"shape": [rays.shape[1], vpack.shape[1], tris.shape[0]],
            "split": times,
            "check": {**counts, "considered_per_segment":
                      counts["considered"] / seg, "skipped_share":
                      counts["skipped"] / max(counts["considered"], 1)},
            "occupancy": {k: {"blocks": b, "warps": 4 * b}
                          for k, b in occ.items()}}


def clustered_split(dev, cfg):
    """{variant: timing} of kernel 11 on config 4's clustered inputs with
    parts of its work taken away (the module docstring), and {kernel:
    blocks per SM} of the grid backwards where the library answers."""
    c = cluster_inputs(dev, *CONFIGS["config4"], cfg)
    rays, vpack, tris, med, dens = c["packs"]
    tv, tw, layout, seed, kind = (c[k] for k in ("tv", "tw", "layout", "seed",
                                                 "kind"))
    uv = cfg.uv_tau_steps
    one_voxel = dens.mean().reshape(1, 1, 1).contiguous()
    zero = torch.zeros_like(c["gbar"])
    variants = {"full": (tris, dens, uv, c["gbar"]),
                "no_triangles": (tris[:0].contiguous(), dens, uv, c["gbar"]),
                "one_voxel": (tris, one_voxel, uv, c["gbar"]),
                "uv_steps_1": (tris, dens, 1, c["gbar"]),
                "gbar_0": (tris, dens, uv, zero),
                "gbar_0_one_voxel": (tris, one_voxel, uv, zero)}
    lib = cb._library()
    times = {name: windows(lambda: cb._launch(
        lib, rays, vpack, t, med, layout, tv, tw, None, seed, 2, 2, True,
        kind, g, (d, u)), 10, 5)
        for name, (t, d, u, g) in variants.items()}
    occ = {}
    for entry in ("vrl_sum_bwd", "vrl_sum_clustered_bwd"):
        for steps in (uv, 3):
            try:
                blocks = vs.occupancy(entry, True, tris.shape[0], steps, kind,
                                      cfg.short_vrls)
            except AttributeError:  # a tree whose library has no such query
                continue
            occ[f"{entry}<grid,uv{steps}>"] = {"blocks": blocks,
                                               "warps": 4 * blocks}
    return {"shape": {"rays": rays.shape[1], "tiles": len(layout[1]),
                      "table": list(tv.shape), "triangles": tris.shape[0]},
            "split": {f"vrl_sum_hetero_clustered_bwd/{k}": v
                      for k, v in times.items()},
            "occupancy": occ}


def grid_clustered_split(dev, cfg, outputs=None):
    """{variant: timing} of kernels 4 (vrl_sum_hetero_clustered, a bare
    launch on pre-grouped tiles) and 6 (vrl_r_hetero on the
    representative rays) on config 4's clustered inputs with parts of
    their work taken away (the module docstring); their checking
    launches' counts and {kernel: blocks per SM}, where the tree's
    library has them; with `outputs` the comparison of both kernels'
    outputs with a saved run's."""
    c = cluster_inputs(dev, *CONFIGS["config4"], cfg)
    rays, vpack, tris, med, dens = c["packs"]
    rays_r = rep_packs(c)[0]
    tv, tw, tiles, seed, kind = (c[k] for k in ("tv", "tw", "tiles", "seed",
                                                "kind"))
    uv = cfg.uv_tau_steps
    one_voxel = dens.mean().reshape(1, 1, 1).contiguous()
    variants = {"full": (tris, dens, uv),
                "no_triangles": (tris[:0].contiguous(), dens, uv),
                "one_voxel": (tris, one_voxel, uv),
                "uv_steps_1": (tris, dens, 1)}
    lib = vsc._library()
    out = torch.zeros((3, rays.shape[1]), device=dev)
    times = {}
    for name, (t, d, u) in variants.items():
        times[f"vrl_sum_hetero_clustered/{name}"] = windows(
            lambda: vsc._launch(lib, rays, vpack, t, med, *tiles, tv, tw,
                                None, seed, 2, 2, True, kind, out, (d, u)),
            10, 10)
        times[f"vrl_r_hetero/{name}"] = windows(
            lambda: vr.vrl_r_hetero(rays_r, vpack, t, med, d, seed=seed,
                                    uv_steps=u), 10, 10)
    check = {}
    if hasattr(vr, "vrl_r_hetero_check"):  # trees from the grid pre-reject on
        for name, counts in (
                ("vrl_sum_hetero_clustered", vsc.vrl_sum_hetero_clustered_check(
                    rays, vpack, tris, med, dens, c["sop"], tv, tw, seed=seed,
                    uv_steps=uv)[1]),
                ("vrl_r_hetero", vr.vrl_r_hetero_check(
                    rays_r, vpack, tris, med, dens, seed=seed,
                    uv_steps=uv)[1])):
            seg = max(counts["segments"], 1)
            check[name] = {**counts, "considered_per_segment":
                           counts["considered"] / seg, "skipped_per_segment":
                           counts["skipped"] / seg}
    occ = {}
    for entry in ("vrl_sum_clustered", "vrl_r"):
        for steps in (uv, 3):
            try:
                blocks = vs.occupancy(entry, True, tris.shape[0], steps, kind,
                                      cfg.short_vrls)
            except AttributeError:  # a tree whose library has no such query
                continue
            occ[f"{entry}<grid,uv{steps}>"] = {"blocks": blocks,
                                               "warps": 4 * blocks}
    result = {"shape": {"rays": rays.shape[1], "tiles": len(tiles[1]),
                        "table": list(tv.shape), "representatives":
                        rays_r.shape[1], "vrls": vpack.shape[1],
                        "triangles": tris.shape[0]},
              "split": times, "check": check, "occupancy": occ}
    if outputs is not None:
        out.zero_()
        vsc._launch(lib, rays, vpack, tris, med, *tiles, tv, tw, None, seed,
                    2, 2, True, kind, out, (dens, uv))
        result["outputs"] = saved_or_compared(outputs, {
            "vrl_sum_hetero_clustered": out,
            "vrl_r_hetero": vr.vrl_r_hetero(rays_r, vpack, tris, med, dens,
                                            seed=seed, uv_steps=uv)})
    return result


def config2_split(dev, cfg, outputs=None):
    """{variant: timing} of kernels 5, 10 and 2 on config 2's clustered
    inputs (the module docstring), kernels 5's and 2's checking counts,
    the tiles, blocks and blocks per SM, and with `outputs` the
    comparison of kernels 5's, 10's and 2's outputs with a saved run's."""
    c = cluster_inputs(dev, *CONFIGS["config2"], cfg)
    rays, vpack, tris, med = c["packs"]
    packs_r = rep_packs(c)
    tv, tw, tiles, layout, gbar, seed, kind = (
        c[k] for k in ("tv", "tw", "tiles", "layout", "gbar", "seed", "kind"))
    no_tris = tris[:0].contiguous()
    lib, blib = vsc._library(), cb._library()
    out = torch.zeros((3, rays.shape[1]), device=dev)
    modes = hasattr(cb, "ray_block")  # trees from kernel 10's redesign on
    k2_modes = hasattr(vsc, "vrl_sum_clustered_check")  # from kernel 2's

    def bwd_launch(t, **kw):
        return lambda: cb._launch(blib, rays, vpack, t, med, layout, tv, tw,
                                  None, seed, 2, 2, True, kind, gbar, **kw)

    def fwd_launch(t, o=out, **kw):
        def launch():
            vsc._launch(lib, rays, vpack, t, med, *tiles, tv, tw, None, seed,
                        2, 2, True, kind, o, **kw)
            return o
        return launch
    variants = {
        "vrl_r/whole": lambda: vr.vrl_r(*packs_r, seed=seed),
        "vrl_r/no_triangles": lambda: vr.vrl_r(
            packs_r[0], packs_r[1], no_tris, packs_r[3], seed=seed),
        "vrl_sum_clustered_bwd/whole": bwd_launch(tris),
        "vrl_sum_clustered_bwd/no_triangles": bwd_launch(no_tris),
        "vrl_sum_clustered/whole": fwd_launch(tris),
        "vrl_sum_clustered/no_triangles": fwd_launch(no_tris)}
    if hasattr(vr, "vrl_r_check"):
        variants["vrl_r/check"] = lambda: vr.vrl_r_check(*packs_r, seed=seed)
    if modes:
        variants["vrl_sum_clustered_bwd/no_pre_reject"] = bwd_launch(
            tris, mode=vs.MODE_NO_REJECT)
    counts2 = torch.zeros(len(vs.CHECK_COUNTS), dtype=torch.int64,
                          device=dev)
    if k2_modes:
        variants["vrl_sum_clustered/check"] = fwd_launch(
            tris, mode=vs.MODE_CHECK, counts=counts2)
        variants["vrl_sum_clustered/no_pre_reject"] = fwd_launch(
            tris, mode=vs.MODE_NO_REJECT)
    times = {k: windows(fn, 10, 10) for k, fn in variants.items()}
    n_rep, n_vrls = packs_r[0].shape[1], vpack.shape[1]
    r_rays = vr.tile_rays(False) if hasattr(vr, "tile_rays") else 128
    chunk = vs._library().alvrl_vrl_chunk()
    shape = {"rays": rays.shape[1], "representatives": n_rep,
             "vrls": n_vrls, "table": list(tv.shape),
             "triangles": tris.shape[0],
             "vrl_r": {"tile": [r_rays, chunk], "blocks":
                       -(-n_rep // r_rays) * -(-n_vrls // chunk)},
             "vrl_sum_clustered_bwd": {
                 "tile_rays": len(layout[0]) // len(layout[1]),
                 "blocks": len(layout[1]),
                 "padding": float((layout[0] < 0).double().mean())},
             "vrl_sum_clustered": {"tile_rays": len(tiles[0]) // len(tiles[1]),
                                   "blocks": len(tiles[1]),
                                   "padding": float((tiles[0] < 0)
                                                    .double().mean())}}
    check = {}
    if hasattr(vr, "vrl_r_check"):
        counts = vr.vrl_r_check(*packs_r, seed=seed)[1]
        seg = max(counts["segments"], 1)
        check["vrl_r"] = {**counts, "considered_per_segment":
                          counts["considered"] / seg, "skipped_share":
                          counts["skipped"] / max(counts["considered"], 1)}
    if k2_modes:
        counts = vsc.vrl_sum_clustered_check(rays, vpack, tris, med, c["sop"],
                                             tv, tw, seed=seed)[1]
        seg = max(counts["segments"], 1)
        check["vrl_sum_clustered"] = {
            **counts, "considered_per_segment": counts["considered"] / seg,
            "skipped_share": counts["skipped"] / max(counts["considered"], 1)}
    occ = {}
    for entry in ("vrl_r", "vrl_sum_clustered", "vrl_sum_clustered_bwd"):
        try:
            blocks = vs.occupancy(entry, False, tris.shape[0], 4, kind,
                                  cfg.short_vrls)
        except AttributeError:  # a tree whose library has no such query
            continue
        occ[entry] = {"blocks": blocks, "warps": 4 * blocks}
    result = {"shape": shape, "split": times, "check": check,
              "occupancy": occ}
    if modes:
        same = [torch.equal(a, b) for a, b in zip(
            bwd_launch(tris)(), bwd_launch(tris, mode=vs.MODE_NO_REJECT)())]
        result["vrl_sum_clustered_bwd_no_reject_bit_identical"] = all(same)
    fwd = fwd_launch(tris, torch.zeros_like(out))().clone()
    if k2_modes:
        result["vrl_sum_clustered_check_and_no_reject_bit_identical"] = all(
            torch.equal(fwd, fwd_launch(tris, torch.zeros_like(out), **kw)())
            for kw in (dict(mode=vs.MODE_CHECK, counts=torch.zeros_like(
                counts2)), dict(mode=vs.MODE_NO_REJECT)))
    if outputs is not None:
        d_names = ("d_power", "d_par", "d_tau", "d_weights")
        result["outputs"] = saved_or_compared(outputs, {
            "vrl_r": vr.vrl_r(*packs_r, seed=seed),
            "vrl_sum_clustered": fwd,
            **{f"vrl_sum_clustered_bwd/{n}": t
               for n, t in zip(d_names, bwd_launch(tris)())}})
    return result


def saved_or_compared(path, now):
    """Saves {name: tensor} `now` to `path` if it does not exist (then
    "saved to path"), else {name: the largest absolute and relative
    difference from the saved tensor of that name, the count of entries
    that differ, whether it is bit-identical}."""
    now = {k: v.cpu() for k, v in now.items()}
    if not os.path.exists(path):
        torch.save(now, path)
        return f"saved to {path}"
    then = torch.load(path)
    cmp = {}
    for name in sorted(now.keys() & then.keys()):
        a, b = now[name], then[name]
        diff = (a - b).abs()
        cmp[name] = {"bit_identical": torch.equal(a, b),
                     "max_abs": float(diff.max()),
                     "max_rel": float((diff / b.abs().clamp(
                         min=1e-30)).max()),
                     "differ": int((a != b).sum())}
    return cmp


BVH_SCENES = (("cubes", 11), ("cubes", 16), ("cubes", 22), ("blob", 64),
              ("blob", 112), ("blob", 180))  # chip_smoke.py phase 30
BVH_SEED = 20261019


def bvh(dev):
    """Kernel 7 over phase 30's scenes: {scene: timing and counts per
    segment}, and kernel 1 against kernel 7 at config-1 inputs."""
    from alvrl_tpu_torch.ops import vrl_sum_bvh as vb
    from alvrl_tpu_torch.scripts import bench_bvh_large as bbl
    rows = {}
    for kind, n in BVH_SCENES:
        scene = bbl.scene_of(kind, n, device=dev)
        packs = integrator.pack_frame_bvh(scene, bbl.bench_vrls(scene))[3]
        row = {"triangles": int(scene.faces.shape[0]),
               "depth": packs[2].depth,
               "ms": windows(lambda: vb.vrl_sum_bvh(*packs, seed=BVH_SEED),
                             5, 3)}
        counts = vb.vrl_sum_bvh_counts(*packs, seed=BVH_SEED)[1]
        seg = max(counts["segments"], 1)
        row["per_segment"] = {k: v / seg for k, v in counts.items()
                              if k not in ("segments", "open_vv", "open_vs",
                                           "differ")}
        row["differ"] = counts.get("differ")
        rows[f"{kind} {n}"] = row
    vrls_m = vb.sort_vrls_morton(vrl.compact(vrl.load_ascii(
        BENCH_VRLS, particle_count=78.0, device=dev), 512))
    scene = presets.cornell_smoke(128, 128, device=dev)
    packs = integrator.pack_frame(scene, vrls_m)[3]
    pack = vb.pack_bvh_tris(scene.vertices, scene.faces, scene.opaque_faces())
    rows["config 1"] = {
        "vrl_sum": windows(lambda: vs.vrl_sum(*packs, seed=BVH_SEED), 10, 10),
        "vrl_sum_bvh": windows(lambda: vb.vrl_sum_bvh(
            packs[0], packs[1], pack, packs[3], seed=BVH_SEED), 10, 10)}
    return rows


def glossy(dev):
    """--glossy: {form: {"ms": the form's windows, "extends": those of the
    form it extends on the same inputs}}."""
    from alvrl_tpu_torch.media import homogeneous as hmed
    from alvrl_tpu_torch.ops import pack as pk
    from alvrl_tpu_torch.ops import vrl_sum_bvh as vb
    from alvrl_tpu_torch.scripts import bench_bvh_large as bbl

    out = {}
    vrls = vrl.compact(vrl.load_ascii(BENCH_VRLS, particle_count=78.0,
                                      device=dev), 512)
    for fast_tau in (True, False):
        scene = presets.cornell_grid_smoke(512, 512, grid_res=48, device=dev)
        scene = replace(scene, medium=replace(scene.medium,
                                              fast_tau=fast_tau))
        mats = pk.pack_materials(scene.materials)
        mpacks = integrator.pack_frame(scene, vrls, materials=mats)[3]
        packs = integrator.pack_frame(scene, vrls)[3]
        n_rays = packs[0].shape[1]
        sl = (np.arange(n_rays) * 100 // n_rays).astype(np.int32)
        ids = torch.as_tensor(np.random.default_rng(3).integers(
            0, 512, (100, 64)), dtype=torch.int32, device=dev)
        w = torch.ones((100, 64), device=dev)
        reps = torch.arange(0, n_rays, n_rays // 2032, device=dev)[:2032]
        read = "nearest" if fast_tau else "trilinear"
        for name, fn, batch in (
                ("vrl_sum_hetero", lambda p, **k: vs.vrl_sum_hetero(
                    *p, seed=21, **k), 1),
                ("vrl_sum_hetero_clustered",
                 lambda p, **k: vsc.vrl_sum_hetero_clustered(
                     *p, sl, ids, w, seed=21, **k), 5),
                ("vrl_r_hetero", lambda p, **k: vr.vrl_r_hetero(
                    p[0][:, reps].contiguous(), *p[1:], seed=21, **k), 5)):
            out[f"{name} material {read}"] = {
                "ms": windows(lambda: fn(mpacks, materials=mats), 3, batch),
                "extends": windows(lambda: fn(packs), 3, batch)}
    scene = bbl.scene_of("cubes", 11, device=dev)
    vrls = bbl.bench_vrls(scene)
    mats = pk.pack_materials(scene.materials)
    packs = integrator.pack_frame_bvh(scene, vrls)[3]
    mpacks = integrator.pack_frame_bvh(scene, vrls, materials=mats)[3]
    xpacks = integrator.pack_frame_bvh(replace(scene, medium=replace(
        scene.medium, strategy=hmed.MAXIMUM)), vrls)[3]
    plain = windows(lambda: vb.vrl_sum_bvh(*packs, seed=BVH_SEED), 5, 3)
    out["vrl_sum_bvh material"] = {"ms": windows(lambda: vb.vrl_sum_bvh(
        *mpacks, seed=BVH_SEED, materials=mats), 5, 3), "extends": plain}
    out["vrl_sum_bvh maximum"] = {"ms": windows(lambda: vb.vrl_sum_bvh(
        *xpacks, seed=BVH_SEED), 5, 3), "extends": plain}
    return out


def device_ops(prof):
    """The device operations (kernels, copies, sets) of a torch.profiler
    run, in start order, as chrome-trace events."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return sorted((e for e in events if e.get("cat") in
                   ("kernel", "gpu_memcpy", "gpu_memset")),
                  key=lambda e: e["ts"])


def trainer(dev, n_warm=2, n_steps=8):
    """The trainer's kernel times, host times and device profile (the
    module docstring)."""
    from torch.profiler import ProfilerActivity, profile
    state = rd.setup(device=dev)
    for i in range(n_warm):
        rd.density_step(state, i)
    medium = gmed.with_density(state.medium, state.density)
    views = [integrator.pack_frame(replace(sc, medium=medium),
                                   state.vrls)[3] for sc in state.scenes]
    kw = integrator._kernel_args(state.scenes[0], state.cfg)
    rng = np.random.default_rng(21)
    gbars = [torch.as_tensor(rng.uniform(0.5, 1.5, (3, p[0].shape[1]))
                             .astype(np.float32), device=dev) for p in views]
    kernels = {
        "vrl_sum_hetero": windows(lambda: [
            vs.vrl_sum_hetero(*p, seed=21, **kw) for p in views], 10, 10),
        "vrl_sum_hetero_bwd": windows(lambda: [
            bwd.vrl_sum_hetero_bwd(*p, g, seed=21, **kw)
            for p, g in zip(views, gbars)], 10, 10)}
    step = n_warm
    host = []
    for _ in range(n_steps):
        host.append(rd.density_step(state, step)["ms"])
        step += 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            rd.density_step(state, step)
            step += 1
        torch.cuda.synchronize()
    ops = device_ops(prof)
    busy, end, by_kernel = 0.0, ops[0]["ts"], {}
    for e in ops:
        t0, t1 = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        for name in ("vrl_sum_kernel", "vrl_sum_bwd_kernel"):
            if name in e["name"]:
                by_kernel[name] = by_kernel.get(name, 0.0) + e["dur"]
    span = end - ops[0]["ts"]
    per = 1e3 * n_steps  # trace microseconds -> ms per step
    parts = {k: statistics.median(h[k] for h in host) for k in host[0]}
    return {"kernels_4_views": kernels,
            "host_ms_median": {**parts, "step": statistics.median(
                sum(h.values()) for h in host)},
            "device_per_step": {
                "span_ms": span / per, "busy_ms": busy / per,
                "idle_share": 1 - busy / span, "ops": len(ops) / n_steps,
                **{f"{k}_ms": v / per for k, v in by_kernel.items()}}}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cfg = VRLConfig(vol_vol_samples=2, vol_surf_samples=2)
    _build.load_library()
    if sys.argv[1:] == ["--trainer"]:
        print(json.dumps({"card": card, "package": vs.__file__,
                          "trainer": trainer(dev)}))
        return
    if sys.argv[1:] == ["--config1-split"]:
        print(json.dumps({"card": card, "package": vs.__file__,
                          "registers": registers(),
                          **config1_split(dev)}))
        return
    if sys.argv[1:] == ["--bvh"]:
        print(json.dumps({"card": card, "package": vs.__file__,
                          "registers": registers(), "bvh": bvh(dev)}))
        return
    if sys.argv[1:] == ["--glossy"]:
        print(json.dumps({"card": card, "package": vs.__file__,
                          "registers": registers(), "glossy": glossy(dev)}))
        return
    if sys.argv[1:] == ["--bwd-split"]:
        print(json.dumps({"card": card, "package": vs.__file__,
                          "registers": registers(), **bwd_split(dev)}))
        return
    if sys.argv[1:] == ["--clustered-split"]:
        print(json.dumps({"card": card, "package": vs.__file__,
                          "registers": registers(),
                          **clustered_split(dev, cfg)}))
        return
    outputs = sys.argv[3] if sys.argv[2:3] == ["--outputs"] else None
    if sys.argv[1:2] == ["--config2-split"]:
        print(json.dumps({"card": card, "package": vs.__file__,
                          "registers": registers(),
                          **config2_split(dev, cfg, outputs)}))
        return
    if sys.argv[1:2] == ["--grid-clustered-split"]:
        print(json.dumps({"card": card, "package": vs.__file__,
                          "registers": registers(),
                          **grid_clustered_split(dev, cfg, outputs)}))
        return
    if sys.argv[1:] == ["--grid-split"]:
        times, occ = grid_split(dev, cfg)
        print(json.dumps({"card": card, "package": vs.__file__,
                          "registers": registers(), "occupancy": occ,
                          "split": times}))
        return
    kernels = config1(dev, cfg)
    for args in CONFIGS.values():
        kernels.update(clustered(dev, *args, cfg))
    print(json.dumps({"card": card, "package": vs.__file__,
                      "registers": registers(), "kernels": kernels}))


if __name__ == "__main__":
    main()
