"""Progressive multi-pass render driver.

Counterpart of alvrl_tpu/integrators/progressive.py, itself the
counterpart of ProgressiveMonteCarloIntegrator
(include/mitsuba/render/integrator.h:483-511,
src/librender/integrator.cpp:380-440): render N passes, re-tracing the
VRL set each pass (prepass) and accumulating the film; optionally dump
each pass image with wall timing and cumulative VRL-evaluation counts
embedded in the file name (dumpPass, integrator.cpp:361-378 +
passFileSuffix, vrlIntegrator.cpp:357-364), and keep an .npz
checkpoint of the accumulator to resume from.

Pass p draws from its own generator, alvrl.pass_generator(seed, p): an
unclustered pass the tracer's uniforms, the eye rays' sub-pixel jitter
(with antialias) and the kernel's seed; a clustered pass those of
alvrl.render_alvrl (tracer uniforms, R's seed, the render's seed; no
jitter, as the JAX package's render_alvrl). Clustered passes run in
alvrl.alvrl_passes' pipelined schedule (pass p+1's host clustering
while the device renders pass p); each equals render_alvrl's pass on
its generator. The JAX package's
`use_pallas` has no counterpart: the port always takes its kernels
(kernel 1, or kernel 3 in a grid medium, for an unclustered pass; on
the card, kernel 7 for an unclustered pass in a homogeneous medium
above the kernels' shared-memory cap of triangles), and their material
and extended forms where the scene's table or medium asks for them, as
the JAX package's XLA route (its default) evaluates them.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from alvrl_tpu_torch.core.logging import get_logger
from alvrl_tpu_torch.core.stats import STATS
from alvrl_tpu_torch.integrators.vrl import alvrl as alvrl_mod
from alvrl_tpu_torch.integrators.vrl import tracer as tracer_mod
from alvrl_tpu_torch.integrators.vrl import vrl as vrl_mod
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.integrators.vrl.integrator import (
    render_with_vrls_kernel,
    render_with_vrls_kernel_bvh,
)
from alvrl_tpu_torch.io import image as image_io
from alvrl_tpu_torch.media import api as mapi
from alvrl_tpu_torch.ops import _build

log = get_logger("progressive")


@dataclass
class ProgressiveConfig:
    max_passes: int = 8
    dump_passes: bool = False
    dump_dir: str = "passes"
    dump_prefix: str = "pass"
    clustered: bool = False
    antialias: bool = True  # fresh sub-pixel jitter each unclustered pass
    checkpoint_path: str | None = None  # .npz accumulator for resume


def unclustered_render(scene):
    """The unclustered render entry for the scene: render_with_vrls_kernel,
    or, on the card in a homogeneous medium above the kernels' cap of
    triangles, render_with_vrls_kernel_bvh. (Any other pass above the
    cap raises in its kernel's wrapper, with the cap in the message.)"""
    if (scene.device.type == "cuda" and mapi.is_homogeneous(scene.medium)
            and scene.faces.shape[0]
            > _build.load_library().alvrl_max_tris()):
        return render_with_vrls_kernel_bvh
    return render_with_vrls_kernel


def render_pass(scene, generator, prog: ProgressiveConfig,
                params: alvrl_mod.ALVRLParams, cfg: VRLConfig = VRLConfig(),
                tracer_cfg=tracer_mod.TracerConfig()):
    """One unclustered pass drawing from `generator`: (image (H, W, 3)
    on the scene's device, vrls). (A clustered pass is
    alvrl.render_alvrl.)"""
    raw = tracer_mod.trace(scene, generator, params.num_particles, tracer_cfg)
    vrls = vrl_mod.compact(raw, params.vrl_target_num,
                           slots_per_particle=tracer_cfg.max_depth)
    jitter = None
    if prog.antialias:
        cam = scene.camera
        jitter = torch.rand((cam.width * cam.height, 2),
                            generator=generator).to(scene.device)
    img = unclustered_render(scene)(scene, vrls, generator, cfg,
                                    jitter=jitter)
    return img, vrls


def render_progressive(
        scene, seed: int = None, prog: ProgressiveConfig = ProgressiveConfig(),
        params: alvrl_mod.ALVRLParams = None, cfg: VRLConfig = VRLConfig(),
        tracer_cfg: tracer_mod.TracerConfig = tracer_mod.TracerConfig()):
    """Accumulate `max_passes` independent VRL passes, pass p drawing
    from alvrl.pass_generator(seed, p) (`seed` defaults to
    params.seed): unclustered passes through render_pass, one after the
    other; clustered ones through alvrl.alvrl_passes, which clusters
    pass p+1 on the host while the device renders pass p. Returns the
    averaged image (H, W, 3) as float32 numpy."""
    if params is None:
        params = alvrl_mod.ALVRLParams()
    if seed is None:
        seed = params.seed

    accum = None
    start_pass = 0
    slice_info = None
    if prog.clustered:
        with STATS.timed("slicing"):
            slice_info = alvrl_mod.build_slice_info(scene, params)
    # resume from a checkpoint (the reference approximates this with
    # periodic partial-image flushes + the -x skip flag,
    # mitsuba.cpp:78-127; here the accumulator itself is durable)
    if prog.checkpoint_path and os.path.exists(prog.checkpoint_path):
        ck = np.load(prog.checkpoint_path)
        accum = ck["accum"]
        start_pass = int(ck["next_pass"])
        log.info("resuming at pass %d from %s", start_pass,
                 prog.checkpoint_path)
    c_vrls = STATS.counter("VRL integrator", "VRLs traced")
    c_evals = STATS.counter("VRL integrator", "VRL evaluations (render)")
    n_pix = scene.camera.width * scene.camera.height

    passes = range(start_pass, prog.max_passes)
    if prog.clustered:
        images = (out[:3] for out in alvrl_mod.alvrl_passes(
            scene, passes, seed, params, cfg, tracer_cfg, slice_info))
    else:
        images = ((p, *render_pass(scene, alvrl_mod.pass_generator(seed, p),
                                   prog, params, cfg, tracer_cfg))
                  for p in passes)
    for _ in passes:
        t0 = time.perf_counter()
        with STATS.timed("pass"):
            p, img, vrls = next(images)
            img = img.cpu().numpy()
        wall = time.perf_counter() - t0

        n_valid = int(vrls.valid.sum())
        c_vrls.add(n_valid)
        c_evals.add(n_pix * n_valid)
        accum = img if accum is None else accum + img
        log.info("pass %d/%d: %.2fs wall, %d VRLs, mean %.4g", p + 1,
                 prog.max_passes, wall, n_valid, float(img.mean()))

        if prog.checkpoint_path:
            np.savez(prog.checkpoint_path, accum=accum, next_pass=p + 1)

        if prog.dump_passes:
            os.makedirs(prog.dump_dir, exist_ok=True)
            suffix = f"_p{p:03d}_wall{wall:.3e}_renvrl{c_evals.value:.4e}"
            image_io.write_npy(
                os.path.join(prog.dump_dir, f"{prog.dump_prefix}{suffix}.npy"),
                accum / (p + 1))

    return accum / prog.max_passes
