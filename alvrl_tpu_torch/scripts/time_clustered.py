"""Time the clustered sum kernel at config 2 and config 4 on one card.

The inputs are chip_smoke.py's (phases 12-14 and 15-17: the same
scenes, tracer seeds, clustering seeds and kernel seed), so the times
are those phases' "vrl_sum_clustered" and "vrl_sum_hetero_clustered"
alone. The script uses only functions that every tree of the port since
the clustered render has, so one copy times two trees in turn on one
card, each run in its own process with that tree first on the path:

    PYTHONPATH=<tree> python3 alvrl_tpu_torch/scripts/time_clustered.py

(`python3 -m alvrl_tpu_torch.scripts.time_clustered` from a tree's root
times that tree). Prints one JSON line: the card, the package timed,
and per config the median and spread of 10 CUDA-event windows of 10
launches in a row.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch

from alvrl_tpu_torch.integrators.vrl import alvrl, integrator, tracer, vrl
from alvrl_tpu_torch.integrators.vrl import cluster as cl
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.ops import vrl_sum_clustered as vsc
from alvrl_tpu_torch.scene import presets

# (scene, tracer depth, tracer seed, particles, slices, undersampling,
# kernel seed) of chip_smoke.py's config 2 and config 4
CONFIGS = {
    "config2": (lambda dev: presets.cornell_smoke(128, 128, device=dev), 16,
                11, 128, 100, 64.0, 20261017),
    "config4": (lambda dev: presets.cornell_grid_smoke(512, 512, grid_res=48,
                                                       device=dev),
                10, 41, 192, 128, 128.0, 20261018),
}


def time_config(dev, make_scene, depth, tracer_seed, particles, slices,
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
    lib = vsc._library()
    tiles = [torch.as_tensor(a, device=dev)
             for a in vsc.group_by_slice(sop, lib.alvrl_ray_block())]
    out = torch.zeros((3, packs[0].shape[1]), device=dev)
    grid = None if len(packs) == 4 else (packs[4], cfg.uv_tau_steps)

    def launch():
        vsc._launch(lib, *packs[:4], *tiles, tv, tw, None, seed, 2, 2, True,
                    scene.medium.phase_kind, out, grid)

    for _ in range(3):
        launch()
    times = []
    for _ in range(10):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(10):
            launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 10)
    med = statistics.median(times)
    return {"ms": med, "spread": (max(times) - min(times)) / med,
            "tiles": len(tiles[1])}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("time_clustered: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cfg = VRLConfig(vol_vol_samples=2, vol_surf_samples=2)
    result = {"card": card, "package": vsc.__file__}
    for name, args in CONFIGS.items():
        result[name] = time_config(dev, *args, cfg)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
