"""Time the kernels of kernels 1-6 and 8-11 (PERF.md's table) on one
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
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess

import numpy as np
import torch

from alvrl_tpu_torch.integrators.vrl import alvrl, integrator, tracer, vrl
from alvrl_tpu_torch.integrators.vrl import cluster as cl
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.ops import _build
from alvrl_tpu_torch.ops import vrl_r as vr
from alvrl_tpu_torch.ops import vrl_sum as vs
from alvrl_tpu_torch.ops import vrl_sum_bwd as bwd
from alvrl_tpu_torch.ops import vrl_sum_clustered as vsc
from alvrl_tpu_torch.ops import vrl_sum_clustered_bwd as cb
from alvrl_tpu_torch.scene import presets
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


def clustered(dev, make_scene, depth, tracer_seed, particles, slices,
              undersampling, seed, cfg):
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
    kind = scene.medium.phase_kind
    lib = vsc._library()
    ray_block = lib.alvrl_ray_block()
    tiles = [torch.as_tensor(a, device=dev)
             for a in vsc.group_by_slice(sop, ray_block)]
    layout = cb.host_layout(sop, tv, vrls.capacity, ray_block, dev)
    gbar = torch.as_tensor(np.random.default_rng(3).uniform(
        0.5, 1.5, (3, n_rays)).astype(np.float32), device=dev)
    out = torch.zeros((3, n_rays), device=dev)
    rows = torch.as_tensor(np.concatenate(info.repr_rows), device=dev)
    w = scene.camera.width
    packs_r = integrator.pack_rays_vrls(scene, *perspective.sample_ray(
        scene.camera, rows % w, rows // w), vrls)[1]
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
    kernels = config1(dev, cfg)
    for args in CONFIGS.values():
        kernels.update(clustered(dev, *args, cfg))
    print(json.dumps({"card": card, "package": vs.__file__,
                      "registers": registers(), "kernels": kernels}))


if __name__ == "__main__":
    main()
