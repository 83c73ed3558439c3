"""Command-line renderer, the counterpart of scripts/render_cli.py (and
so of the `mitsuba` CLI, src/mitsuba/mitsuba.cpp) for the VRL
integrators and the path tracers: parse a scene (JSON, or the Mitsuba
0.5 XML subset of scene.loader), render it, write the image.

Usage:
  python -m alvrl_tpu_torch.scripts.render_cli scene.json -o out.pfm \\
      [-i vrl|alvrl|volpath|path|direct] [-p passes] [-D key=value]
      [--seed N] [--particles N] [--vrls N] [--spp N] [--depth N]
      [--png preview.png] [--cpu] [-L level]

It renders on the CUDA card and fails without one; --cpu renders on the
CPU (the kernels' plain versions for -i vrl|alvrl). -i vrl|alvrl render
through integrators.progressive, the VRL tracer at its default depth
(16); -i volpath renders the VRL oracle (integrators.volpath's default
config), -i path the surface path tracer at --depth, -i direct the
direct illumination, each at --spp samples a pixel from the generator of
--seed: as the JAX CLI, --depth sets -i path only, and --spp the three
(-i vrl|alvrl refuse both, which the JAX CLI ignores there). -i vrl|alvrl
render every surface kind and medium that the loader builds (glossy and
layered surfaces in a grid medium and on a mesh above the kernels' cap
of triangles included). A scene the loader refuses exits with its
message.
The JAX CLI's other integrators exit here with the ROADMAP item that
ports them, and so do .exr and .jpg outputs (the writers of ROADMAP
A11); any other extension than .npy writes a PFM, as there.
"""

from __future__ import annotations

import argparse
import sys
import time

# the JAX CLI's integrators that the port does not have, with the
# ROADMAP item that ports each
LATER = {"bdpt": "A11", "ptracer": "A11", "photonmap": "A11", "pssmlt": "A11",
         "mlt": "A11", "erpt": "A11", "vpl": "A11", "adaptive": "A11",
         "irrcache": "A11", "field": "A11", "motion": "A11"}


PATH_TRACERS = ("volpath", "path", "direct")


def render_path_tracer(scene, integrator, seed, spp, depth):
    """The (H, W, 3) numpy image of -i volpath|path|direct: the render of
    a generator on the scene's device seeded with `seed`."""
    import torch

    from alvrl_tpu_torch.integrators import surface, volpath

    gen = torch.Generator(device=scene.device).manual_seed(seed)
    if integrator == "volpath":
        img = volpath.render_volpath(scene, gen, spp=spp)
    elif integrator == "path":
        img = surface.render_path(scene, gen, spp=spp, max_depth=depth)
    else:
        img = surface.render_direct(scene, gen, spp=spp)
    return img.cpu().numpy()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="render_cli")
    ap.add_argument("scene")
    ap.add_argument("-o", "--output", default="out.pfm")
    ap.add_argument("-i", "--integrator", default="vrl",
                    choices=["vrl", "alvrl", *PATH_TRACERS, *LATER])
    ap.add_argument("-p", "--passes", type=int, default=4)
    ap.add_argument("-D", "--define", action="append", default=[])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--particles", type=int, default=128)
    ap.add_argument("--vrls", type=int, default=512)
    ap.add_argument("--spp", type=int, default=None)    # default 16
    ap.add_argument("--depth", type=int, default=None)  # default 16
    ap.add_argument("--png", default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("-L", "--log-level", default="INFO")
    args = ap.parse_args(argv)
    if args.integrator not in PATH_TRACERS:
        for opt in ("spp", "depth"):
            if getattr(args, opt) is not None:
                ap.error(f"--{opt} sets -i volpath|path|direct only")
    args.spp = 16 if args.spp is None else args.spp
    args.depth = 16 if args.depth is None else args.depth
    return args


def main(argv=None):
    """Render a scene file; returns 0, or exits non-zero with a message
    on an integrator or output format that is not ported, or without a
    CUDA device unless --cpu is given."""
    args = parse_args(argv)
    if args.integrator in LATER:
        sys.exit(f"render_cli: -i {args.integrator} is not ported "
                 f"(ROADMAP {LATER[args.integrator]})")
    if args.output.lower().endswith((".exr", ".jpg", ".jpeg")):
        sys.exit(f"render_cli: {args.output}: the EXR and JPEG writers are "
                 "not ported (ROADMAP A11); write .pfm or .npy")

    import torch

    from alvrl_tpu_torch.core.logging import configure, get_logger
    from alvrl_tpu_torch.core.stats import STATS
    from alvrl_tpu_torch.integrators.progressive import (
        ProgressiveConfig,
        render_progressive,
    )
    from alvrl_tpu_torch.integrators.vrl.alvrl import ALVRLParams
    from alvrl_tpu_torch.io import image as image_io
    from alvrl_tpu_torch.scene import loader

    if not args.cpu and not torch.cuda.is_available():
        sys.exit("render_cli: no CUDA device; pass --cpu to render on the "
                 "CPU")
    device = "cpu" if args.cpu else "cuda"
    configure(args.log_level)
    log = get_logger("cli")

    defines = dict(kv.split("=", 1) for kv in args.define)
    try:
        if args.scene.endswith(".xml"):
            scene = loader.build_scene(
                loader.convert_mitsuba_xml(args.scene, defines), device=device)
        else:
            scene = loader.load_json(args.scene, defines, device=device)
    except ValueError as e:  # a kind the loader refuses, with its item
        sys.exit(f"render_cli: {args.scene}: {e}")
    log.info("scene: %d tris, %dx%d on %s", scene.faces.shape[0],
             scene.camera.width, scene.camera.height, device)

    t0 = time.time()
    if args.integrator in PATH_TRACERS:
        img = render_path_tracer(scene, args.integrator, args.seed,
                                 args.spp, args.depth)
    else:
        img = render_progressive(
            scene, args.seed,
            ProgressiveConfig(max_passes=args.passes,
                              clustered=args.integrator == "alvrl"),
            ALVRLParams(vrl_target_num=args.vrls,
                        num_particles=args.particles))
    log.info("rendered in %.1fs, mean %.4g", time.time() - t0, img.mean())

    if args.output.endswith(".npy"):
        image_io.write_npy(args.output, img)
    else:
        image_io.write_pfm(args.output, img)
    if args.png:
        image_io.write_png(args.png, img)
    log.info("wrote %s", args.output)
    print(STATS.format_table(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
