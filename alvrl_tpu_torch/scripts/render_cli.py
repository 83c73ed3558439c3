"""Command-line renderer, the counterpart of scripts/render_cli.py (and
so of the `mitsuba` CLI, src/mitsuba/mitsuba.cpp) for the VRL
integrators: parse a scene (JSON, or the Mitsuba 0.5 XML subset of
scene.loader), render it with integrators.progressive, write the image.

Usage:
  python -m alvrl_tpu_torch.scripts.render_cli scene.json -o out.pfm \\
      [-i vrl|alvrl] [-p passes] [-D key=value] [--seed N]
      [--particles N] [--vrls N] [--png preview.png] [--cpu] [-L level]

It renders on the CUDA card, through the kernels, and fails without
one; --cpu renders on the CPU through the kernels' plain versions.
The VRL tracer runs at its default depth (16), as the JAX CLI's -i
vrl|alvrl do; that CLI's --depth, --spp and --field belong to its other
integrators, which exit here with the ROADMAP item that ports them, and
so do .exr and .jpg outputs (the writers of ROADMAP A11); any other
extension than .npy writes a PFM, as there.
"""

from __future__ import annotations

import argparse
import sys
import time

# the JAX CLI's integrators that the port does not have, with the
# ROADMAP item that ports each
LATER = {"volpath": "A10", "path": "A10", "direct": "A10", "bdpt": "A11",
         "ptracer": "A11", "photonmap": "A11", "pssmlt": "A11",
         "mlt": "A11", "erpt": "A11", "vpl": "A11", "adaptive": "A11",
         "irrcache": "A11", "field": "A11", "motion": "A11"}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="render_cli")
    ap.add_argument("scene")
    ap.add_argument("-o", "--output", default="out.pfm")
    ap.add_argument("-i", "--integrator", default="vrl",
                    choices=["vrl", "alvrl", *LATER])
    ap.add_argument("-p", "--passes", type=int, default=4)
    ap.add_argument("-D", "--define", action="append", default=[])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--particles", type=int, default=128)
    ap.add_argument("--vrls", type=int, default=512)
    ap.add_argument("--png", default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("-L", "--log-level", default="INFO")
    return ap.parse_args(argv)


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
    if args.scene.endswith(".xml"):
        scene = loader.build_scene(
            loader.convert_mitsuba_xml(args.scene, defines), device=device)
    else:
        scene = loader.load_json(args.scene, defines, device=device)
    log.info("scene: %d tris, %dx%d on %s", scene.faces.shape[0],
             scene.camera.width, scene.camera.height, device)

    t0 = time.time()
    img = render_progressive(
        scene, args.seed,
        ProgressiveConfig(max_passes=args.passes,
                          clustered=args.integrator == "alvrl"),
        ALVRLParams(vrl_target_num=args.vrls, num_particles=args.particles))
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
