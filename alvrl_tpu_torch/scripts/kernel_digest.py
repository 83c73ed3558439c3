"""SHA-256 digests of the outputs of kernels 1, 2 and 5 (vrl_sum,
vrl_sum_clustered, vrl_r) on config 1: cornell_smoke at 128x128 against
the 512 bench VRLs, on injected uniforms and on the Philox stream;
kernel 2 on a seeded table of 100 rows x 64 columns (each pixel's row its
index // 164), kernel 5 on 271 seeded rays (config 2's representative
count). The diffuse HG short-VRL instantiations (the keys without a
suffix), and with --all also the Rayleigh, the long-VRL and the material
ones (config 1's table packed for them; " rayleigh", " long",
" material"), on injected uniforms. With --grid instead, the grid
kernels 3, 4 and 6 (vrl_sum_hetero, vrl_sum_hetero_clustered,
vrl_r_hetero; their nearest forms, HG short VRLs, 4 U-V steps) on config
4's packs: cornell_grid_smoke at 512x512 with its 48^3 grid against the
512 bench VRLs, kernel 4 on the same seeded table with each pixel's row
its index * 100 // (512 * 512), kernel 6 on 271 seeded rays. With --bvh,
kernel 7 (vrl_sum_bvh; HG and Rayleigh, short and long VRLs) on the
15,984-triangle cube field of scripts/bench_bvh_large.py (64x64 eye rays
x its 256 traced VRL slots). With --bwd, the backward kernels 8-11
(vrl_sum_bwd, vrl_sum_hetero_bwd, vrl_sum_clustered_bwd,
vrl_sum_hetero_clustered_bwd; their diffuse forms) at a seeded output
cotangent: kernels 8 and 10 on config 1's packs (HG short VRLs on
injected uniforms and on the Philox stream, Rayleigh and long VRLs on
injected uniforms; kernel 10 on the seeded table), kernels 9 and 11 on
config 4's (the nearest read at 4 steps and at 3, the generic
instantiation, on the Philox stream); every output but d_density, whose
atomic adds vary in order between runs. The same outputs bit for bit
give the same digests, so that two trees of the package are compared on
one card:

    python alvrl_tpu_torch/scripts/kernel_digest.py [--root DIR] [--all | --grid | --bvh | --bwd]

imports alvrl_tpu_torch from DIR (another tree's root; this tree's by
default) and prints one JSON object of the digests, the card's name and
its power limit. Needs a CUDA card; uses only entry points that the
kernels have had since their material instantiations were ported.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

SEED = 20261016
N_SLICES, N_COLS, SLICE_PIXELS = 100, 64, 164
N_REPS = 271


def digest(t) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy()
                          .tobytes()).hexdigest()


def kernel_digests(device="cuda", every_form=False):
    """{output: sha256} of the kernels on config 1's packs (every_form:
    also the Rayleigh, long-VRL and material instantiations)."""
    import numpy as np
    import torch

    from alvrl_tpu_torch.integrators.vrl import integrator, vrl
    from alvrl_tpu_torch.ops.vrl_r import vrl_r
    from alvrl_tpu_torch.ops.vrl_sum import vrl_sum
    from alvrl_tpu_torch.ops.vrl_sum_clustered import vrl_sum_clustered
    from alvrl_tpu_torch.scene import presets

    root = os.path.dirname(os.path.dirname(os.path.abspath(
        sys.modules["alvrl_tpu_torch"].__file__)))
    scene = presets.cornell_smoke(128, 128, device=device)
    vrls = vrl.compact(vrl.load_ascii(
        os.path.join(root, "data", "bench_vrls.txt"), particle_count=78.0,
        device=device), 512)
    packs = integrator.pack_frame(scene, vrls)[3]
    n_rays = packs[0].shape[1]
    rng = np.random.default_rng(16)
    u = torch.as_tensor(rng.random((n_rays, 512, 6), dtype=np.float32),
                        device=device)
    ids = torch.as_tensor(rng.integers(0, 512, (N_SLICES, N_COLS)),
                          dtype=torch.int32, device=device)
    w = torch.as_tensor(rng.uniform(0.0, 2.0, (N_SLICES, N_COLS)),
                        dtype=torch.float32, device=device)
    ray_slice = np.arange(n_rays, dtype=np.int32) // SLICE_PIXELS
    reps = torch.as_tensor(rng.choice(n_rays, N_REPS, replace=False),
                           device=device)
    rep_rays = packs[0][:, reps].contiguous()
    out = {
        "vrl_sum injected": vrl_sum(*packs, uniforms=u),
        "vrl_sum philox": vrl_sum(*packs, seed=SEED),
        "vrl_sum_clustered injected": vrl_sum_clustered(
            *packs, ray_slice, ids, w, uniforms=u[:, :N_COLS].contiguous()),
        "vrl_sum_clustered philox": vrl_sum_clustered(
            *packs, ray_slice, ids, w, seed=SEED),
        "vrl_r injected": vrl_r(rep_rays, *packs[1:],
                                uniforms=u[reps].contiguous()),
        "vrl_r philox": vrl_r(rep_rays, *packs[1:], seed=SEED),
    }
    if every_form:
        from alvrl_tpu_torch.ops import pack as pk

        mats = pk.pack_materials(scene.materials)
        mat_packs = integrator.pack_frame(scene, vrls, materials=mats)[3]
        forms = {" rayleigh": (packs, dict(phase_kind=1)),
                 " long": (packs, dict(short_vrls=False)),
                 " material": (mat_packs, dict(materials=mats))}
        for suffix, (p, kw) in forms.items():
            reps_p = p[0][:, reps].contiguous()
            out["vrl_sum" + suffix] = vrl_sum(*p, uniforms=u, **kw)
            out["vrl_sum_clustered" + suffix] = vrl_sum_clustered(
                *p, ray_slice, ids, w, uniforms=u[:, :N_COLS].contiguous(),
                **kw)
            out["vrl_r" + suffix] = vrl_r(reps_p, *p[1:],
                                          uniforms=u[reps].contiguous(), **kw)
    return _digests(out)


GRID_SIZE, GRID_RES = 512, 48  # config 4's frame and grid


def grid_digests(device="cuda"):
    """{output: sha256} of the grid kernels' nearest forms on config 4's
    packs (module docstring), on injected uniforms and on the Philox
    stream."""
    import numpy as np
    import torch

    from alvrl_tpu_torch.integrators.vrl import integrator, vrl
    from alvrl_tpu_torch.ops.vrl_r import vrl_r_hetero
    from alvrl_tpu_torch.ops.vrl_sum import vrl_sum_hetero
    from alvrl_tpu_torch.ops.vrl_sum_clustered import vrl_sum_hetero_clustered
    from alvrl_tpu_torch.scene import presets

    root = os.path.dirname(os.path.dirname(os.path.abspath(
        sys.modules["alvrl_tpu_torch"].__file__)))
    scene = presets.cornell_grid_smoke(GRID_SIZE, GRID_SIZE,
                                       grid_res=GRID_RES, device=device)
    vrls = vrl.compact(vrl.load_ascii(
        os.path.join(root, "data", "bench_vrls.txt"), particle_count=78.0,
        device=device), 512)
    packs = integrator.pack_frame(scene, vrls)[3]
    n_rays = packs[0].shape[1]
    rng = np.random.default_rng(18)
    u = torch.as_tensor(rng.random((n_rays, 512, 6), dtype=np.float32),
                        device=device)
    ids = torch.as_tensor(rng.integers(0, 512, (N_SLICES, N_COLS)),
                          dtype=torch.int32, device=device)
    w = torch.as_tensor(rng.uniform(0.0, 2.0, (N_SLICES, N_COLS)),
                        dtype=torch.float32, device=device)
    ray_slice = (np.arange(n_rays, dtype=np.int64) * N_SLICES
                 // n_rays).astype(np.int32)
    reps = torch.as_tensor(rng.choice(n_rays, N_REPS, replace=False),
                           device=device)
    rep_rays = packs[0][:, reps].contiguous()
    kw = dict(uv_steps=4)
    out = {
        "vrl_sum_hetero injected": vrl_sum_hetero(*packs, uniforms=u, **kw),
        "vrl_sum_hetero philox": vrl_sum_hetero(*packs, seed=SEED, **kw),
        "vrl_sum_hetero_clustered injected": vrl_sum_hetero_clustered(
            *packs, ray_slice, ids, w, uniforms=u[:, :N_COLS].contiguous(),
            **kw),
        "vrl_sum_hetero_clustered philox": vrl_sum_hetero_clustered(
            *packs, ray_slice, ids, w, seed=SEED, **kw),
        "vrl_r_hetero injected": vrl_r_hetero(
            rep_rays, *packs[1:], uniforms=u[reps].contiguous(), **kw),
        "vrl_r_hetero philox": vrl_r_hetero(rep_rays, *packs[1:], seed=SEED,
                                            **kw),
    }
    del u
    return _digests(out)


def bvh_digests(device="cuda"):
    """{output: sha256} of kernel 7's forms on the cube field (module
    docstring), on injected uniforms and on the Philox stream."""
    import numpy as np
    import torch

    from alvrl_tpu_torch.integrators.vrl import integrator
    from alvrl_tpu_torch.ops.vrl_sum_bvh import vrl_sum_bvh
    from alvrl_tpu_torch.scripts import bench_bvh_large as bbl

    scene = bbl.scene_of("cubes", 11, device=device)
    packs = integrator.pack_frame_bvh(scene, bbl.bench_vrls(scene))[3]
    u = torch.as_tensor(np.random.default_rng(19).random(
        (packs[0].shape[1], packs[1].shape[1], 6), dtype=np.float32),
        device=device)
    return _digests({
        "vrl_sum_bvh injected": vrl_sum_bvh(*packs, uniforms=u),
        "vrl_sum_bvh philox": vrl_sum_bvh(*packs, seed=SEED),
        "vrl_sum_bvh rayleigh": vrl_sum_bvh(*packs, uniforms=u,
                                            phase_kind=1),
        "vrl_sum_bvh long": vrl_sum_bvh(*packs, uniforms=u,
                                        short_vrls=False)})


def bwd_digests(device="cuda"):
    """{output: sha256} of the backward kernels' diffuse forms (module
    docstring)."""
    import numpy as np
    import torch

    from alvrl_tpu_torch.integrators.vrl import integrator, vrl
    from alvrl_tpu_torch.ops import vrl_sum_bwd as bwd
    from alvrl_tpu_torch.ops import vrl_sum_clustered_bwd as cb
    from alvrl_tpu_torch.scene import presets

    root = os.path.dirname(os.path.dirname(os.path.abspath(
        sys.modules["alvrl_tpu_torch"].__file__)))
    vrls = vrl.compact(vrl.load_ascii(
        os.path.join(root, "data", "bench_vrls.txt"), particle_count=78.0,
        device=device), 512)
    rng = np.random.default_rng(20)
    out = {}

    def gbar(n):
        return torch.as_tensor(rng.uniform(0.5, 1.5, (3, n)).astype(
            np.float32), device=device)

    def table(n_rays):
        ids = torch.as_tensor(rng.integers(0, 512, (N_SLICES, N_COLS)),
                              dtype=torch.int32, device=device)
        w = torch.as_tensor(rng.uniform(0.0, 2.0, (N_SLICES, N_COLS)),
                            dtype=torch.float32, device=device)
        return (np.arange(n_rays, dtype=np.int64) * N_SLICES
                // n_rays).astype(np.int32), ids, w

    def put(name, outs, skip=()):
        for i, o in enumerate(outs):
            if i not in skip:
                out[f"{name} {i}"] = o

    packs = integrator.pack_frame(presets.cornell_smoke(
        128, 128, device=device), vrls)[3]
    n_rays = packs[0].shape[1]
    u = torch.as_tensor(rng.random((n_rays, 512, 6), dtype=np.float32),
                        device=device)
    g1 = gbar(n_rays)
    sl, ids, w = table(n_rays)
    forms = {"injected": dict(uniforms=u), "philox": dict(seed=SEED),
             "rayleigh": dict(uniforms=u, phase_kind=1),
             "long": dict(uniforms=u, short_vrls=False)}
    for name, kw in forms.items():
        put(f"vrl_sum_bwd {name}", bwd.vrl_sum_bwd(*packs, g1, **kw))
        if "uniforms" in kw:
            kw = dict(kw, uniforms=u[:, :N_COLS].contiguous())
        put(f"vrl_sum_clustered_bwd {name}",
            cb.vrl_sum_clustered_bwd(*packs, sl, ids, w, g1, **kw))
    del u
    packs = integrator.pack_frame(presets.cornell_grid_smoke(
        GRID_SIZE, GRID_SIZE, grid_res=GRID_RES, device=device), vrls)[3]
    n_rays = packs[0].shape[1]
    g4 = gbar(n_rays)
    sl, ids, w = table(n_rays)
    for steps in (4, 3):
        kw = dict(seed=SEED, uv_steps=steps)
        put(f"vrl_sum_hetero_bwd uv{steps}",
            bwd.vrl_sum_hetero_bwd(*packs, g4, **kw), skip=(5,))
        put(f"vrl_sum_hetero_clustered_bwd uv{steps}",
            cb.vrl_sum_hetero_clustered_bwd(*packs, sl, ids, w, g4, **kw),
            skip=(5,))
    return _digests(out)


def _digests(out):
    import torch

    torch.cuda.synchronize()
    for k, v in out.items():
        if not bool(torch.isfinite(v).all()) or float(v.abs().max()) == 0.0:
            raise RuntimeError(f"{k}: not finite and non-zero")
    return {k: digest(v) for k, v in out.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None,
                    help="the tree whose alvrl_tpu_torch is imported")
    forms = ap.add_mutually_exclusive_group()
    forms.add_argument("--all", action="store_true",
                       help="also the Rayleigh, long-VRL and material forms")
    forms.add_argument("--grid", action="store_true",
                       help="the grid kernels 3, 4 and 6 on config 4")
    forms.add_argument("--bvh", action="store_true",
                       help="kernel 7 on the cube field")
    forms.add_argument("--bwd", action="store_true",
                       help="the backward kernels 8-11")
    args = ap.parse_args()
    root = os.path.abspath(args.root) if args.root else os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_digest: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if args.grid:
        digests = grid_digests()
    elif args.bvh:
        digests = bvh_digests()
    elif args.bwd:
        digests = bwd_digests()
    else:
        digests = kernel_digests(every_form=args.all)
    print(json.dumps({"root": root, "card": card, "digests": digests}))


if __name__ == "__main__":
    main()
