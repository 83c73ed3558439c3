"""Smoke run of alvrl_tpu_torch on one CUDA card (an H100): the config-1
VRL render, the config-1 train step, the config-2 clustered render
(Adaptive LightSlice), the config-4 clustered render in a grid medium,
the config-4 gradient path and density-recovery trainer, clustered
gradient steps at configs 2 and 4, the large-mesh render of up to
129,612 triangles, the gather probes, scene files of configs 1-5
rendered through the CLI and the multi-pass drivers, and glass, a
mirror and an area light through the specular-chain render and the
CLI, the grid medium's trilinear quadrature (fast_tau=False) through
the trilinear forms of the grid kernels, oriented media and the
quadrature sampler, end to end through the hand-written CUDA kernels
(the VRL sum, its seed-replay VJP, the transfer matrix R, the clustered
sum and its VJP, each also for the grid medium; the BVH-occlusion sum;
three gathers).

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds the kernels from alvrl_tpu_torch/csrc, with each
     kernel instantiation's registers and spills (ptxas);
  3. kernel vs plain at config-1 shapes (16384 eye rays of cornell_smoke
     128x128, 512 VRLs, 24 triangles), with injected uniforms and with
     the kernel's own Philox stream, for HG g=0, HG g=0.6 and Rayleigh,
     and with injected uniforms without the short-VRL division ("long"),
     and the checking instantiation, whose plane pre-reject must never
     skip a blocking triangle;
  4. the main path: render_with_vrls_kernel on cornell_smoke 128x128
     with the 512 bench VRLs; the kernel's launch count must move, and
     the image must be finite, non-zero and match the plain render; the
     render's segments through the checking instantiation (0
     disagreements);
  5. timing of the kernel, the plain version and the whole render, the
     kernel's split (no pre-reject, no triangles) and its bound on the
     pre-reject's counted skips;
  6. profile: device activity of traced renders (torch.profiler): device
     span and busy time per pass, idle share, device operations per
     pass, the kernel's share and the largest other operations;
  7. backward kernel vs plain backward at config-1 shapes (the packs of
     phase 3), for every medium and mode of phase 3 and a case with a
     zero power channel and a zero sigma_s channel; a repeat launch must
     be bit-identical;
  8. the train step: parallel.render.train_step at full width (128
     particles x depth 12, the raw 1536-slot VRL buffer, 128x128 eye
     rays, 2+2 samples) from sigma_a x 2 towards a target rendered at
     the preset's values with the same random stream. Both kernels'
     launch counts must move; the gradients must match the same step
     with the plain backward, and autograd must match same-seed central
     differences of the kernel forward; then five SGD steps on sigma_a;
  9. timing of the train step (ms per step, and the tracer, forward and
     backward kernels alone on its inputs, the forward's bound at that
     shape) and of the backward kernel against its plain version; the
     step's own segments through kernel 1's checking instantiation (0
     disagreements);
 10. profile: device activity of traced train steps, as phase 6;
 11. R kernel vs plain at config-2 shapes (the representative rays of
     the port's slicing of cornell_smoke 128x128 x the 512 VRLs of a
     config-2 trace), injected uniforms and Philox, the media and modes
     of phase 3: the mean at the homogeneous bar, the variance of the
     mean to a median relative error of 1e-4, and the row sums against
     vrl_sum's luminance;
 12. clustered kernel vs plain on the config-2 tables over all 16,384
     eye rays, the same cases, a fall-back launch, an identity table of
     all 512 VRLs against vrl_sum, and a bit-identical repeat;
 13. the main path: alvrl.render_alvrl at full config 2 (BASELINE,
     scripts/bench_suite.py:55-87); both new kernels' launch counts must
     move, the image must be finite and non-zero, and over 3 seeds the
     mean clustered image over the mean unclustered image of the same
     VRLs must lie in 0.85-1.15;
 14. timing of a warm clustered pass, per stage on the host clock, each
     new kernel alone and its plain version, and a profile as phase 6;
     the R kernel's and the clustered sum's checking launches
     (vrl_r_check, vrl_sum_clustered_check) on the timed launches'
     samples: no skipped triangle blocks, no segment decided otherwise,
     the share of Wald tests skipped, the output bit-identical to the
     kernel's, and the bound priced on those skips beside the one with a
     Wald test per swept triangle; the clustered sum's tiles, padding,
     blocks per SM and registers, and its launch without the plane
     pre-reject, bit-identical to it;
 15. the three grid kernels (vrl_sum_hetero, vrl_r_hetero,
     vrl_sum_hetero_clustered) vs their plain versions at config-4
     shapes (BASELINE, scripts/bench_suite.py:111-149: cornell_grid_smoke
     512x512 with its 48^3 grid, 512 VRLs of 192 particles x depth 10,
     128 slices, pixel undersampling 128; R over all ~2,000
     representative rays). Each kernel runs at its full main-path shape;
     the sums are compared on a subset (C4_SUBSET_RAYS: the eye rays of
     image rows 128-159 for vrl_sum_hetero, the rays of the first whole
     slices for the clustered sum), R on all of it. Cases: the preset's
     HG g=0.3 with injected and Philox uniforms, Rayleigh, and long VRLs;
     also an identity table against vrl_sum_hetero and R's row sums
     against its luminance (kernel against kernel, full shapes), and the
     checking launches of the clustered sum and R on their full inputs
     (the Wald test alone decides; the plane pre-reject runs beside it
     and must skip no blocking triangle and decide no segment
     differently, as phases 3-5 hold kernel 1);
 16. the main path: alvrl.render_alvrl at full config 4; the launch
     counts of vrl_r_hetero and vrl_sum_hetero_clustered must move, and
     vrl_sum_hetero's in the unclustered renders of the band check; the
     image finite and non-zero; over 3 seeds the mean clustered image
     over the mean unclustered image of the same VRLs in 0.85-1.15;
 17. timing of a warm config-4 pass, per stage (the tracer stage with
     Woodcock tracking), each grid kernel alone at its full shape and
     its plain version on the same inputs, and each one's bound (the
     clustered sum's and R's on their checking launches' counted skips,
     beside the bound with a Wald test per swept triangle), beside the
     clustered sum's and R's times before their redesign;
 18. profile of the config-4 pass, as phase 6;
 19. the grid backward kernel (vrl_sum_hetero_bwd) vs the plain grid
     backward on the eye rays of image rows 128-159 x the 512 VRLs of
     phase 15, for phase 15's cases and a zero power channel with a zero
     albedo channel: d_power, d_tau, d_eod, d_vod and the voxels of
     d_density (those above 1e-3 of the largest |grad|) at the
     homogeneous bar, d_par to 1e-3; a repeat bit-identical but for
     d_density (atomics), which agrees to DENSITY_REPEAT;
 20. the gradient path at full config 4: render_with_vrls_kernel_diff
     with an L2 loss against a render at the preset's values, from
     albedo x 0.8 and density x 1.25; both grid kernels' launch counts
     must move, every gradient must be finite, and same-seed central
     differences of the kernel forward must agree to 5e-3 (sigma_t_color,
     albedo, g, scale, the two voxels of largest |grad|);
 21. the trainer: scripts.recover_density at its defaults for 16 steps
     (across a retrace): the loss per step and each step's split, finite,
     the loss of step 15 below step 0's;
 22. timing of the full-width gradient step and its parts, the backward
     kernel alone against its forward and its plain version, its bound,
     and a profile of the step; the kernel's output at that full shape
     (262,144 rays x 512 VRLs) held against the timed plain backward's
     at phase 19's bars (d_par to 1e-3), a repeat bit-identical but for
     d_density, which agrees to DENSITY_REPEAT; and ROADMAP C12's
     measurement: the median errors of d_power and d_vod against the
     plain backward at 16,384, 65,536 and 262,144 rays, and at full
     shape the kernel's against float64 beside the two repairs'
     recorded figures (C12_REPAIRS);
 23. the clustered backward kernel (vrl_sum_clustered_bwd) vs the plain
     clustered backward on all 16,384 eye rays and phase 12's config-2
     tables, for phase 12's media and modes and a zero power channel
     with a zero sigma_s channel: d_power, d_tau and d_weights at the
     homogeneous bar, d_par as phase 7; a fall-back launch; a repeat
     bit-identical; an identity table of all 512 VRLs against
     vrl_sum_bwd, its d_weights against sum power * d_power;
 24. the grid clustered backward kernel (vrl_sum_hetero_clustered_bwd) at
     its full config-4 shape (262,144 rays, phase 15's tables) vs the
     plain grid clustered backward on phase 15's subset of whole slices
     (gbar 0 on the other rays), phase 19's cases and bars with
     d_weights at the homogeneous bar; an identity table against
     vrl_sum_hetero_bwd at full shape;
 25. the main path: render_clustered_kernel_diff at full config 2 (from
     sigma_a x 2) and config 4 (from albedo x 0.8, density x 1.25) on
     the fixed tables of phases 12 and 15, an L2 loss against a
     clustered render at the preset's values: all four clustered
     kernels' launch counts must move, every gradient be finite, and
     same-seed central differences of the kernel forward agree to 5e-3
     (config 2: sigma_a, sigma_s, g, the light's intensity, a table-
     weight scale; config 4: sigma_t_color, albedo, scale, the two
     voxels of largest |grad|);
 26. timing of both clustered gradient steps and the config-4 step's
     parts, each clustered backward kernel alone against its forward
     and its plain version on phases 14's and 17's inputs, their bounds,
     and a profile of the config-4 step; the homogeneous one's launch
     without the plane pre-reject, bit-identical to it, its tiles,
     blocks per SM and registers, and its bound priced on kernel 1's
     counted skips of config 2's segments;
 27. the BVH-occlusion sum (vrl_sum_bvh) against vrl_sum on the same
     Morton-sorted packs, for phase 3's media and modes: config-1 inputs
     (24 triangles) and a field of 4^3 cubes (780 triangles, 64x64, the
     large-mesh bench's VRLs); the sums must be equal, rays that differ
     are counted and held to the homogeneous bar;
 28. vrl_sum_bvh against its plain version at the homogeneous bar on the
     SUBSET_RAYS eye rays of bench_bvh_large.subset_rays, for the
     15,984-triangle cube field and the 129,612-triangle blob; the BVH's
     closest hits against intersect_all on all 4,096 eye rays of both
     16k scenes (valid and prim equal, t within 1e-4);
 29. the main path: render_with_vrls_kernel_bvh at the full large-mesh
     configuration (scripts/bench_bvh_large.py: 64x64, 64 particles x
     depth 8 in 256 slots, 2+2 samples) on the 16k cube field, the 16k
     blob and the 129,612-triangle blob; vrl_sum_bvh's launch count must
     move, each image be finite and non-zero and match the plain render
     on the subset's pixels;
 30. timing: vrl_sum_bvh over the JAX sweep's six scenes (ms, pair-sample
     evals/s, node fetches, box and triangle tests per shadow segment
     from the counting launch beside the counts and times before the
     redesign, tree depth, each step's time ratio against its triangle
     ratio), against vrl_sum at config-1 inputs, the render's stages
     (host BVH builds, primary hits, Morton sort, packs, kernel) and the
     kernel's bound (OPS's "node" and "triangle" rows times the box and
     triangle tests that the shadow function needs, as the counting
     launch counts them, which must decide every segment as the kernel
     does; and on the kernel's own tests);
 31. the gather probes (scripts/probe_gather.py, kernels 12-14): their
     entry point with its launch counts, each kernel against its plain
     version (equal), their device times (calls queued behind a spin
     kernel, so that their host cost is hidden), torch.gather's, and
     gathers/s;
 32. scene files: BASELINE configs 1-2 (cornell_smoke as trimesh shapes,
     its size by -D), 3 (cornell_smoke_hg 256x256), 4 (cornell_grid_smoke
     512x512, its 48^3 density as .npy) and 5 (config 1's file at
     1024x1024), a Mitsuba XML of the config-1 box (OBJ parts) and the
     15,984-triangle cube field (its cubes as a binary PLY) written to a
     temporary directory; each loads through scene.loader as its preset,
     bit for bit;
 33. the CLI on the card: scripts.render_cli.main on each file (config 1
     -i vrl -p 4, config 2 -i alvrl -p 4, config 3 -i vrl -p 2, config 4
     -i alvrl -p 2 at the CLI's clustering defaults, the XML box, config 5
     -p 1, the cube field -p 1; the tracer at its default depth): exit
     code 0, the PFM read back finite, non-zero and bit-identical to
     integrators.progressive.render_progressive in process with the same
     seed and options, the route's kernels launched (vrl_sum; vrl_r and
     vrl_sum_clustered; vrl_sum; vrl_r_hetero and
     vrl_sum_hetero_clustered; vrl_sum; vrl_sum; vrl_sum_bvh), no plain
     version called, ms a pass; kernel 1's launches of configs 3 (HG
     g=0.8, all 65,536 rays) and 5 (1,048,576 rays, a sample of 4,096)
     held against its plain version on the same packs and Philox stream
     at the homogeneous bar;
 34. the pipelined schedule of the clustered passes (alvrl.alvrl_passes,
     through integrators.progressive.render_progressive and
     alvrl.render_alvrl_progressive) against the serial one
     (alvrl.render_alvrl pass after pass) at full configs 2 and 4, 4
     passes: bit-identical images, ms a pass of each (median of 3 runs,
     the two in turns), the pipelined stage sums, a profile of each
     (device busy, idle share, the largest gaps between device
     operations), and the synchronising calls of one pipelined
     iteration by file and line (torch.cuda.set_sync_debug_mode);
 35. checkpoint and resume at config 2: 2 passes, then a resume to 4,
     bit-identical to 4 in one run; the pass dumps named as the JAX
     package names them;
 36. glass and an area light as scene files: cornell_glass (config 1's
     box, its blocker a dielectric of eta 1.5, its back wall a conductor,
     the point light and cornell_area_light's ceiling quad as an area
     emitter; JSON, its size by -D) and cornell_area_light (JSON and a
     Mitsuba XML with a rectangle and a nested area emitter), 128x128
     (cornell_glass also 512x512); each loads on the card as on the CPU,
     bit for bit, and cornell_area_light as the ported preset;
 37. the main path of the specular chains: render_with_vrls_kernel_spec
     on cornell_glass at 128x128 and 512x512 against VRLs traced on the
     card at the CLI's defaults (128 particles x depth 16 into 512
     slots): kernel 1's launch count must move by the depths launched;
     each depth's launch held against its plain version on the same
     packs and Philox stream (all rays at 128x128, 4,096 at 512x512) at
     the homogeneous bar; every depth's segments through the checking
     instantiation (0 disagreements); the image finite and non-zero; at
     128x128 the render on injected uniforms against the plain chain
     (li_unclustered_spec_u) on 4,096 of its pixels at the homogeneous
     bar; the active rays per depth, ms per render (no plain version),
     ms per depth's launch and the idle share of a profile;
 38. the CLI on cornell_glass and cornell_area_light (-i vrl -p 2 and
     -i alvrl -p 2) as phase 33: exit code 0, the PFM bit-identical to
     render_progressive, the route's kernels launched, no plain version
     called, ms a pass; and the tracer on cornell_glass on the card
     against the tracer on the CPU on the same uniforms (slots,
     validity, positions and powers);
 39. glossy and layered surfaces as scene files: cornell_glossy (config
     1's box, its walls, its blocker and a second block carrying the
     eleven smooth kinds: rough conductor, plastic, Phong, diffuse
     transmission, Ward, a mixture, rough plastic, a mask, a coating, a
     rough dielectric and a rough coating, each seen over 794 pixels or
     more; JSON and Mitsuba XML, 128x128); each loads on the card as on
     the CPU, bit for bit, the XML as the JSON;
 40. the material instantiations of kernels 1, 2 and 5 (vrl_sum,
     vrl_sum_clustered, vrl_r with a material pack: the eye hit's smooth
     BSDF in the vol-surf term) on cornell_glossy at config-1 shapes
     (16,384 rays x the 512 bench VRLs; the scene's own clustering; R on
     256 eye rays of each kind and on its representative rays) against
     their plain versions on injected uniforms and the Philox stream at
     the homogeneous bar, held over each eye-hit kind's rays alone (512
     rays a kind at least; R's representative rays as a whole), each
     checking launch with 0 disagreements; the diffuse instantiations'
     outputs on config 1 bit for bit the parent's (kernel_digest.py);
     the main path: render_with_vrls_kernel and render_alvrl on
     cornell_glossy, the three kernels' launch counts moving, no plain
     version called, the unclustered image against the plain render
     (kernel 1's Philox hold on the render's seed);
     ms of each material launch beside the diffuse one in turns, on
     cornell_glossy and on config 1's table packed for the material
     instantiation (the same samples), the plain versions' ms (one call
     of each, in its hold), the bounds (OPS's counts with a lower bound
     of each eval, the samples counted in the Philox holds), the new
     instantiations' registers and spill, and the idle share of a
     profiled render;
 41. the CLI on cornell_glossy.xml (-i vrl -p 2 and -i alvrl -p 2) as
     phase 33, and the tracer on cornell_glossy on the card against the
     tracer on the CPU on the same uniforms;
 42. specular chains onto glossy faces: render_with_vrls_kernel_spec on
     cornell_glossy with its second block glass, 128x128, VRLs traced
     on the card: every depth through kernel 1's material instantiation,
     each depth's launch against its plain version (2,048 of its rays),
     and the render on injected uniforms against the plain chain
     (li_unclustered_spec_u) on every pixel that sees the glass and
     1,024 others, at the homogeneous bar;
 43. the sky scene (config 1's box without its front wall, the Preetham
     sky, a coloured medium with an absorbing HG + Rayleigh mixture and
     the single strategy): the PHASE = 2 forms of kernels 1, 2 and 5
     against their plain versions and their checking launches, every
     earlier form's digest the parent's, the main path's launches and
     its clustered / unclustered band over three seeds, times against
     the HG form; and (43c) their material forms on cornell_glossy in
     the same medium, held over each eye-hit kind's rays alone;
 44. the equal-transport A/B (the VRL render through kernel 1 against
     the volpath oracle, z < 4) on cornell_smoke and the sky scene, the
     nested no-op crossing, the MIS path tracer's time, tile, peak
     memory and idle share;
 45. the CLI's -i volpath|path|direct and -i vrl|alvrl on a sky JSON, a
     nested JSON and two XMLs (sunsky, an .hdr map), each image the
     in-process render's.
 46. the trilinear forms of kernels 3, 4 and 6 (vrl_sum_hetero,
     vrl_r_hetero, vrl_sum_hetero_clustered on the trilinear packs of a
     fast_tau=False medium: the 48^3 density itself, 8 corner reads and 7
     lerps a lookup) at config 4's shape against their plain versions on
     samples (kernel 3 on every 64th ray, kernel 4 on its first whole
     slices, kernel 6 on all representatives; injected and Philox, HG and
     Rayleigh with long VRLs) at the homogeneous bar; the checking
     launches of kernels 4 and 6 (0 disagreements of the pre-reject); the
     main path (render_alvrl and the unclustered render of the
     fast_tau=False medium) with the three forms' launch counts, its
     image mean within TRI_MEAN_BAND of the nearest forms' on the same
     VRLs and its sums against the plain; each form's time against the
     nearest form's on the same inputs, in turns, its plain version's
     and its bound; the nearest forms' outputs on config 4's packs bit
     for bit the parent's (kernel_digest.py --grid, PARENT_DIGESTS_GRID);
 47. volpath on config 4's plume at 16^3 with a swirl of fibers, a
     micro-flake medium (Woodcock with its directional majorant) and a
     Kajiya-Kay one (the quadrature sampler), finite and non-zero; the
     VRL render of config 4's plume from VRLs traced with sampling=1
     against those of Woodcock tracking, image means over QUAD_SEEDS
     seeds within z < 4; the refusal of an oriented medium by
     render_with_vrls_kernel, and render_with_vrls_kernel_diff on the
     fast_tau=False medium (kernel 9's trilinear form, counted).
 48. the material forms of kernels 3, 4 and 6 on the glossy grid scene
     and kernel 7's material and extended forms on the cube field, kind
     by kind, their launches, times, bounds and the CLI.
 49. the new forms of the backward kernels 8-11 (material, extended:
     the mixture and the strategies' rate, trilinear, and their pairs)
     against their plain versions in float32 and float64 on samples of
     their main paths' rays, every eye-hit kind alone for the material
     forms, repeats bit-identical but d_density; the main paths (the
     train step on cornell_glossy and in the mixture + single medium at
     phase 8's shape, render_with_vrls_kernel_diff at full config 4 with
     fast_tau=False and on the glossy grid scene, render_clustered_
     kernel_diff on config-2 and config-4 tables) with each form's launch
     count, no plain call, against same-seed central differences; each
     form's time beside the form it extends, registers and bounds.
 50. cornell_textured (presets.cornell_textured_desc: bitmap, checker,
     grid and noise walls, an HK slab, a normal- and a bump-mapped block)
     at 128x128, its VRLs traced as the CLI traces them: the textured
     forms of kernels 1, 2 and 5 (csrc/vrl_tex.cuh) against their plain
     versions material by material (kernel 2 on the scene's own 100-slice
     clustering), their checking launches; every function of the parent's
     library found in this one's SASS (PARENT_SASS); the main path's
     textured launches, no plain call; times beside the material forms
     on the same packs, registers, bounds; the CLI with -i vrl and -i
     alvrl; the VRL render against the volpath oracle at 32x32 (z < 4).
 51. cornell_textured's surfaces in config 4's grid medium at 512x512
     and on the 15,984-triangle cube field (presets.textured_cube_field):
     the textured forms of kernels 3, 4 and 6, nearest and trilinear, and
     of kernel 7 (in an HG and a mixture + single medium) against their
     plain versions material by material (512 held rays of each in the
     grid scene, 500 on the HG field, 72 in the mixture), their checking
     and counting launches; the main paths'
     textured launches, no plain call; times beside the material forms
     on the same packs, registers, bounds; the CLI with -i vrl and -i
     alvrl on the grid scene file.
Then one JSON line of per-kernel results (with each kernel's bound,
as the comment above HBM_BYTES_PER_S defines it) and, last, the device line
{"ok": true, "device": {...}}. There is no CPU fallback: without a CUDA
device the script fails.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import torch

from alvrl_tpu_torch.bsdf import api as bsdf_api
from alvrl_tpu_torch.core.spectrum import LUM_WEIGHTS
from alvrl_tpu_torch.core.stats import STATS
from alvrl_tpu_torch.geometry import bvh as bvh_mod
from alvrl_tpu_torch.geometry import intersect
from alvrl_tpu_torch.integrators import volpath
from alvrl_tpu_torch.integrators.progressive import (
    ProgressiveConfig, render_progressive)
from alvrl_tpu_torch.integrators.vrl import (
    alvrl, integrator, specular, tracer, vrl)
from alvrl_tpu_torch.integrators.vrl import cluster as cl
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.io import image
from alvrl_tpu_torch.ops import _build
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops import vrl_sum as vs
from alvrl_tpu_torch.ops import vrl_sum_bwd as bwd
from alvrl_tpu_torch.ops import vrl_sum_clustered as vsc
from alvrl_tpu_torch.ops import vrl_sum_bvh as vb
from alvrl_tpu_torch.ops import vrl_sum_clustered_bwd as cb
from alvrl_tpu_torch.ops import vrl_r as vr
from alvrl_tpu_torch.ops.vrl_r import (
    vrl_r, vrl_r_check, vrl_r_hetero, vrl_r_hetero_check,
    vrl_r_hetero_reference, vrl_r_reference)
from alvrl_tpu_torch.ops.vrl_sum import (
    HOMOG_FLOOR, HOMOG_MEDIAN, HOMOG_SHARE, homog_bar, homog_bar_by_kind,
    philox_draws, philox_uniforms, vrl_sum, vrl_sum_hetero,
    vrl_sum_hetero_reference, vrl_sum_reference)
from alvrl_tpu_torch.media import heterogeneous as gmed
from alvrl_tpu_torch.media import phase as ph
from alvrl_tpu_torch.ops.vrl_sum_clustered import (
    group_by_slice, philox_table_uniforms, vrl_sum_clustered,
    vrl_sum_clustered_check, vrl_sum_clustered_reference,
    vrl_sum_hetero_clustered,
    vrl_sum_hetero_clustered_check, vrl_sum_hetero_clustered_reference)
from alvrl_tpu_torch.parallel.render import PARAMS, train_step, with_params
from alvrl_tpu_torch.scene import loader, presets
from alvrl_tpu_torch.scripts import bench_bvh_large as bbl
from alvrl_tpu_torch.scripts import kernel_digest
from alvrl_tpu_torch.scripts import probe_gather as probe
from alvrl_tpu_torch.scripts import recover_density as rd
from alvrl_tpu_torch.scripts import render_cli
from alvrl_tpu_torch.sensors import perspective

WIDTH = HEIGHT = 128
N_VRLS = 512
PARTICLE_COUNT = 78.0
MEDIA = {"hg_g0": (0.0, 0), "hg_g06": (0.6, 0), "rayleigh": (0.0, 1)}
N_PARTICLES, MAX_DEPTH = 128, 12  # config 1's tracer (bench.py)
TRAIN_SEED = 7
PAR_RTOL = 1e-3  # d_par, and the step's gradients: the BASELINE bar
BWD_HOLD_STRIDE = 8  # phase 7 holds every 8th ray of the frame
C4_STAGED = 6        # phase 17's staged config-4 passes (the first 2 warm)
K1_HOLD_STRIDE = 4   # phase 3 holds every 4th
K2_HOLD_STRIDE = 4   # phase 12 too
FD_TOL = 5e-3    # same-seed central differences (tests/test_pallas_bwd.py)
ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH_VRLS = os.path.join(ROOT, "data", "bench_vrls.txt")
# config 2 (scripts/bench_suite.py:55-87): cornell_smoke 128x128, 512
# VRLs of 128 particles x depth 16, 100 slices, pixel undersampling 64
C2_PARAMS = dict(vrl_target_num=512, num_particles=128, seed=0)
C2_CLUSTER = dict(target_num_slices=100, target_pixel_undersampling=64.0)
C2_BAND = (0.85, 1.15)  # clustered / unclustered image mean, 3 seeds
R_VAR_MEDIAN, R_VAR_FLOOR = 1e-4, 1e-12  # tests/test_hetero_pallas.py:227
# config 4 (scripts/bench_suite.py:111-149): cornell_grid_smoke 512x512
# with a 48^3 grid, 512 VRLs of 192 particles x depth 10, 128 slices,
# pixel undersampling 128, 2+2 samples, 4 U-V quadrature steps
C4_SIZE, C4_GRID, C4_DEPTH = 512, 48, 10
C4_PARAMS = dict(vrl_target_num=512, num_particles=192, seed=0)
C4_CLUSTER = dict(target_num_slices=128, target_pixel_undersampling=128.0)
C4_ROWS = (128, 160)     # image rows of the unclustered sum's subset
C4_SUBSET_RAYS = 16384   # rays of the clustered sum's subset, at most
C4_PLAIN_CHUNK = 2048    # rays per block of the plain versions on the card
C4_TRIS = 12             # the box's wall triangles
# the kernels' times on phases 14, 17 and 26's inputs before their
# redesign (NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's
EARLIER_MS = {"vrl_sum_hetero": 42.781, "vrl_sum_hetero_bwd": 68.130,
              "vrl_sum_hetero_clustered": 1.976, "vrl_r_hetero": 0.611,
              "vrl_r": 0.4692, "vrl_sum_clustered_bwd": 0.3395,
              "vrl_sum_clustered": 0.2455}
# ROADMAP C12's two repairs of the grid backward, measured on phase 17's
# full-shape inputs against the float64 plain backward by instantiations
# of the kernel that were removed after the measurement (NVIDIA H100
# 80GB HBM3, 700.00 W; ROADMAP C12): (d_power median, d_vod median, ms);
# printed beside this run's kernel
C12_REPAIRS = {"(a) in-block sums in float64": (6.622e-7, 9.4467e-6, 55.08),
               "(b) sample OD cotangents in float64": (6.620e-7, 9.547e-6,
                                                       59.91)}

# bounds: the least time the card could take for a kernel's work, the
# larger of its bytes over the memory rate and its operations over the
# peak rate of their type (NVIDIA H100 SXM, 700 W: 3.35 TB/s, 67
# TFLOP/s float32 outside the tensor cores, a fused multiply-add counting
# 2; special functions at 16 results per clock per SM against float32's
# 128, the CUDA programming guide's throughput table for compute
# capability 9.0). The operations are OPS's counts times this run's
# samples as the kernel meets them (SweepCount).
HBM_BYTES_PER_S = 3.35e12
FP32_PER_S = 67e12
SFU_PER_S = FP32_PER_S / 16.0  # 16 vs 128 results, an FMA counting 2

# (float32 operations, special-function operations) per call of the
# device code in alvrl_tpu_torch/csrc/vrl_common.cuh, counted from the
# source by rules that make every count a lower bound: an add, subtract,
# multiply, min, max or comparison is 1 (a fused multiply-add 2, as the
# peak counts it); a negation, absolute value or select is 0; a square
# root, division, reciprocal or exp is one special-function operation
# (its one MUFU instruction; the rest of its precise sequence counts 0);
# asinhf, sinhf, atanf and tanf count 0 (the arithmetic of their
# arguments counts); a product the compiler can hoist out of its loop
# (g * g, sigma_s^2, a pair's power times sigma_s, a ray's |ee|^2, a
# pair's a1 - a0) counts 0; integer work (Philox, indices), loads and
# loop control count 0. Near-parallel pairs (sin theta < 1e-4) are
# counted on the common path.
OPS = {
    # pair_setup: vd, |vd| and its reciprocal, uv (12, 2);
    # seg_seg_closest (63, 3: w; the dots b, d, e; the numerators and the
    # clamps; sc, tc; the closest points; h); cos and sin theta (8, 1);
    # near_par, sin_safe, h, arc_h (4); the arguments of a0, a1 (3, 2)
    "pair": (90, 8),
    # vol_vol_sample up to its shadow test: V by inverse distance (8, 4),
    # vp (6), kulla (39, 4: x - a and its dot; the foot point; dis; the
    # angles' arguments; the tangent's argument and t; span; pdf; arc),
    # up (6), pdf (1), duv and its square (8), the two tests (2)
    "vv": (70, 8),
    # past an open shadow test: d_uv, vu, c_u, c_v, den, path
    "vv_open": (18, 2),
    # vol_surf_sample up to its shadow test: kulla (39, 4), vp (6), duv
    # and its square (8), the two tests (2)
    "vs": (55, 4),
    # past an open shadow test: d_uv, vu, cos_o, c_v, den, path
    "vs_open": (18, 2),
    # occluded: the segment's set-up (16, 2), then each triangle the
    # sweep tests (two cross and three dot products, the sign, adet, tv,
    # the five-way min and its test: 59)
    "segment": (16, 2),
    "triangle": (59, 0),
    # PlaneTris (kernel 1's sweep), per shadow segment: the two tested
    # ends (6 FMA) and the span (3 max, 1 add); per triangle it meets:
    # the two plane distances (6 FMA), the margin (1 FMA) and four
    # comparisons; the Wald test ("triangle") only where it does not skip
    "plane_segment": (16, 0),
    "plane": (18, 0),
    # BvhTris (vrl_sum_bvh.cu), per shadow segment: the three reciprocals
    # of its direction; per node box tested (slab_overlaps): six
    # differences and products (12), the near and far maxima and minima
    # with the segment's ends (6) and their comparison (1)
    "bvh_segment": (0, 3),
    "node": (19, 0),
}
# the grid medium's device functions (GridMedium, interp_od), by OPS's
# rules; rintf and the integer index arithmetic count 0
GRID_OPS = {
    # GridMedium::density: the box coordinates (6), the inside test (6),
    # the scaled indices and their clamps (6), the scale (1)
    "density": (19, 0),
    # interp_od: the clamps (4), x (1), w and 1 - w (2), the lerp (3)
    "interp": (10, 0),
    # segment_od: delta, the final product and division
    "segment": (4, 1),
    # each of its steps: t's add and division, the point (3 FMA), the sum
    "segment_step": (8, 1),
    # GridMedium::trilinear (the trilinear forms' lookup, 8 corner reads
    # and 7 lerps): the box coordinates (6), the inside test (6), the
    # grid coordinates (3), their floors' clamps (6), the fractions and
    # their clamps (9), 1 - f (3), the lerps (a product and an FMA each:
    # 21), the scale (1)
    "trilinear": (55, 0),
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def cuda_ms(fn, n_warm, n_timed):
    """Per-call device times (ms) of fn, by CUDA events, after warm-up."""
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
    return times


def timed_call(fn):
    """(fn(), its device time in ms by CUDA events): one call, timed."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def summary(times):
    med = statistics.median(times)
    return med, (max(times) - min(times)) / med


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile_device(fn, n_warm, n_traced):
    """Device activity of n_traced calls of fn (each followed by a
    synchronize) under torch.profiler, from its trace: per call, the
    device span (first device op's start to last one's end, divided by
    n_traced), the busy time (union of device ops), the number of device
    ops, and {op name: busy ms}; None when the trace holds no device op."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(n_warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_traced):
            fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    ops = sorted((e for e in events if e.get("cat") in DEVICE_CATS),
                 key=lambda e: e["ts"])
    if not ops:
        return None
    busy, end, by_name = 0.0, ops[0]["ts"], {}
    for e in ops:
        t0, t1 = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    span = end - ops[0]["ts"]
    per = 1e3 * n_traced  # trace microseconds -> ms per call
    return (span / per, busy / per, len(ops) / n_traced,
            {k: v / n_traced for k, v in by_name.items()})


# the labels of kernel 1's modes, its template argument after <phase,short>
PLANE_MODE = ("sum", "check", "noreject")


def ptxas_summary(log):
    """'name<phase,short[,...]> R regs S B spill' for each kernel
    instantiation in the compiler's report: the medium (grid, homog) of
    the sums, VJPs and R kernels and, for the grid sum and its VJP, the
    U-V quadrature's compile-time step count (uv* for their run-time
    count); the sweep's mode (sum, check, noreject) of kernel 1, the R
    kernels and the homogeneous clustered VJP (its tiling,
    vrl_sum_clustered_bwd_warps_kernel) and sum
    (vrl_sum_clustered_warps_kernel), and "mat" for the material
    instantiations of kernels 1-7 (the grid ones, kernel 3's
    vrl_sum_mat_kernel among them, at the run-time step count, "tri" for
    the trilinear read), "tex" for the textured forms of kernels 1-7
    (vrl_tex.cuh; the grid ones "grid,uv*", their mode and "tri", kernel
    7's "ext" and "count"; kernels 4 and 6's in place of "mat"); kernel 7's
    counting instantiation, "ext" for its
    forms on the extended medium pack (vrl_sum_bvh_ext_kernel); and the
    VJPs' forms: "ext" (the extended medium pack), "tri" and "mat" of
    kernels 8-11."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"'.*?(vrl_(?:sum|sum_bwd|sum_clustered|"
                          r"sum_clustered_bwd|sum_clustered_bwd_warps|"
                          r"sum_clustered_warps|r|sum_bvh|sum_plane|"
                          r"sum_tri|sum_mat|sum_bvh_ext|sum_tex|"
                          r"sum_clustered_tex|r_tex|sum_grid_tex|sum_bvh_tex)"
                          r"_kernel)"
                          r"I((?:L[ib]\d+E)+)E",
                          line)
            name = None
            if m:
                kernel = m[1]
                args = [int(v) for _, v in re.findall(r"L([ib])(\d+)E", m[2])]
                label = [str(args[0]), str(args[1])]
                rest = args[2:]
                if kernel == "vrl_sum_tri_kernel":
                    label += ["grid", "uv*", "tri"]
                elif kernel == "vrl_sum_mat_kernel":  # <.., tri>
                    label += ["grid", "uv*", "mat"] + (["tri"] if rest[0]
                                                       else [])
                elif kernel == "vrl_sum_bvh_ext_kernel":  # <.., count, mat>
                    label += (["ext"] + (["count"] if rest[0] else [])
                              + (["mat"] if rest[1] else []))
                elif kernel == "vrl_sum_bvh_kernel":
                    label += ["count"] if rest and rest[0] else []
                elif kernel == "vrl_sum_clustered_bwd_warps_kernel":
                    # <.., mode, ext, material>
                    label.append(PLANE_MODE[rest[0]])
                    label += [t for t, on in zip(("ext", "mat"), rest[1:])
                              if on]
                elif kernel in ("vrl_sum_plane_kernel",
                                "vrl_sum_clustered_warps_kernel"):
                    label.append(PLANE_MODE[rest[0]])
                    if len(rest) > 1 and rest[1]:  # the material one
                        label.append("mat")
                elif kernel == "vrl_sum_grid_tex_kernel":  # <.., tri>
                    label += ["grid", "uv*", "tex"] + (["tri"] if rest[0]
                                                       else [])
                elif kernel == "vrl_sum_bvh_tex_kernel":  # <.., count>
                    label += ["ext"] + (["count"] if rest[0] else []) + [
                        "tex", "bvh"]
                elif kernel.endswith("_tex_kernel"):  # <phase, short, mode>
                    label += [PLANE_MODE[rest[0]], "tex"]
                elif rest:
                    label.append("grid" if rest[0] else "homog")
                    if rest[0] and len(rest) > 1:  # the step count
                        label.append(f"uv{rest[1]}" if rest[1] else "uv*")
                    # kernels 4 and 6: "tex" for the textured form
                    # (<.., TEX>), which is a material form
                    tex = len(rest) > 5 and rest[5]
                    if kernel == "vrl_r_kernel":  # <.., mode, material, tri>
                        label.append(PLANE_MODE[rest[2]])
                        if rest[3]:
                            label.append("tex" if tex else "mat")
                    if kernel == "vrl_sum_clustered_kernel":
                        # <.., mode, tri, material>
                        label.append(PLANE_MODE[rest[2]])
                        if len(rest) > 4 and rest[4]:
                            label.append("tex" if tex else "mat")
                    tri_at = 4 if kernel == "vrl_r_kernel" else 3
                    if kernel in ("vrl_r_kernel", "vrl_sum_clustered_kernel") \
                            and len(rest) > tri_at and rest[tri_at]:
                        label.append("tri")
                    # the VJPs' forms: <.., ext, tri, material> and
                    # <.., tri, material>
                    forms = {"vrl_sum_bwd_kernel": ("ext", "tri", "mat"),
                             "vrl_sum_clustered_bwd_kernel": ("tri", "mat")}
                    label += [t for t, on in zip(forms.get(kernel, ()),
                                                 rest[2:]) if on]
                name = f"{kernel}<{','.join(label)}>"
            spill = "0"
        elif name and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line)[1]
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)[1]
            out.append(f"{name} {regs} regs {spill} B spill")
            name = None
    return out


def bwd_check(out, ref, ref64, kind):
    """(d_power and d_tau homog_bar results, largest relative d_par error
    of the kernel and of the plain version in float32 against it in
    float64, largest absolute error) of the backward kernel's (d_power,
    d_par, d_tau) against the plain backward's; raises if a bar is
    missed.

    Each d_par entry must agree with the plain version to PAR_RTOL, or
    else to within the plain version's own float32 error (its distance
    from its float64 evaluation): the sums are dominated by a few
    near-singular samples (1 / (pdf d_uv^2) with U close to V), whose
    float32 value moves by 1e-3 with a change of rounding (the kernel's
    fused multiply-adds), which both float32 versions carry."""
    bars = [homog_bar(o.T, r.T) for o, r in ((out[0], ref[0]),
                                            (out[2], ref[2]))]
    for median, share in bars:
        check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
              f"d_power/d_tau median {median}, share {share}")
    check(float(out[1][7]) == 0.0, "d_par[7] (the sampling weight) is 0")
    par_rel = plain_rel = 0.0
    for i in range(7):
        d, r, r64 = float(out[1][i]), float(ref[1][i]), float(ref64[1][i])
        if r == 0.0:  # a zero factor in every term; Rayleigh's d g
            check(d == 0.0, f"d_par[{i}] {d}, plain 0")
            continue
        par_rel = max(par_rel, abs(d - r) / abs(r))
        plain_rel = max(plain_rel, abs(r - r64) / abs(r64))
        check(abs(d - r) <= max(PAR_RTOL * abs(r), abs(r - r64)),
              f"d_par[{i}] {d}, plain {r}, plain in float64 {r64}")
    if kind == 1:
        check(float(out[1][6]) == 0.0, "Rayleigh d g is 0")
    err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
    return bars, (par_rel, plain_rel), err


@contextlib.contextmanager
def plain_backward():
    """vrl_sum_diff's backward through the plain version, on the card,
    on the forward's samples: the step to compare the kernel's with."""
    kernel = bwd.vrl_sum_bwd

    def plain(rays, vrls, tris, medium, gbar, *, seed, uniforms,
              vol_vol_samples, vol_surf_samples, short_vrls, phase_kind,
              materials=None):
        if uniforms is None:
            uniforms = philox_uniforms(
                seed, rays.shape[1], vrls.shape[1],
                2 * vol_vol_samples + vol_surf_samples, device=rays.device)
        return bwd.vrl_sum_bwd_reference(
            rays, vrls, tris, medium, gbar, uniforms,
            vol_vol_samples=vol_vol_samples,
            vol_surf_samples=vol_surf_samples, short_vrls=short_vrls,
            phase_kind=phase_kind, materials=materials)

    bwd.vrl_sum_bwd = plain
    try:
        yield
    finally:
        bwd.vrl_sum_bwd = kernel


def host_ms(fn, n_warm, n_timed):
    """Per-call host-clock times (ms) of fn followed by a synchronize."""
    for _ in range(n_warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n_timed):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return times


def cuda_ms_batched(fn, n_warm, n_timed, batch):
    """Per-call device times (ms) of fn by CUDA events around `batch`
    calls in a row, after warm-up: the host work of one call overlaps
    the previous call's kernel, so a kernel shorter than a window's
    launch overhead is still timed."""
    for _ in range(n_warm):
        fn()
    times = []
    for _ in range(n_timed):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return times


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def grid_estimator_ops(kernel, vol_vol, hg, short_vrls, uv_steps,
                       tri=False):
    """(float32, special-function) operations, by OPS's rules, of one
    open sample's grid terms (vol_vol_term / vol_surf_term of
    GridMedium) and the forward kernel's emit; tri: the trilinear form,
    each lookup (at V, U and every U-V step) priced as
    GRID_OPS["trilinear"]."""
    n_phase = 2 if vol_vol else 1
    f, s = n_phase * (4 if hg else 3), n_phase * (2 if hg else 0)  # phase
    f, s = f + (1 if vol_vol else 2), s + 1                          # geo
    f += 1 + GRID_OPS["interp"][0]          # the VRL table's fraction, entry
    f += GRID_OPS["segment"][0] + uv_steps * GRID_OPS["segment_step"][0]
    s += GRID_OPS["segment"][1] + uv_steps * GRID_OPS["segment_step"][1]
    if tri:  # the density at V (and U) and at each step, trilinear
        f += (n_phase + uv_steps) * GRID_OPS["trilinear"][0]
    else:
        f += n_phase * GRID_OPS["density"][0]   # the density at V (and U)
    if vol_vol:  # the eye table's fraction (a division) and entry; od's sum
        f, s = f + GRID_OPS["interp"][0] + 2, s + 1
    else:
        f += 1
    if short_vrls:  # chan * od, exp, the clamp, the division
        f, s = f + 2, s + 2
    # exp(-sigma_t od) and six products per channel; the emit (6 or 8)
    return f + 3 * 7 + (8 if kernel == "vrl_r" else 6), s + 3


def estimator_ops(kernel, vol_vol, hg, short_vrls):
    """(float32, special-function) operations, by OPS's rules, of one
    open sample's estimator and its reduction: pair_terms and the
    kernel's emit (forward), or vrl_sum_bwd.cu's cotangents."""
    n_phase = 2 if vol_vol else 1
    f, s = n_phase * (4 if hg else 3), n_phase * (2 if hg else 0)  # phase
    f, s = f + (1 if vol_vol else 2), s + 1                          # geo
    if short_vrls:  # pdf_failure (8, 3), its clamp and the division
        f, s = f + 9, s + 4
    if kernel != "vrl_sum_bwd":
        # exp(-sigma_t path) and two products per channel; the emit:
        # acc += t * inv (vrl_sum, vrl_sum_clustered) or the luminance,
        # its sum and its square's (vrl_r)
        return f + 9 + (8 if kernel == "vrl_r" else 6), s + 3
    if hg:  # phase_dg beside each phase_eval (6, 2), then geo_g
        f, s = f + 6 * n_phase + (3 if vol_vol else 2), s + 2 * n_phase + 1
    if short_vrls:  # geo_g's division; d sigma_t through 1 / pdf_failure
        f, s = f + 10, s + 4
    # per channel: w (2, 1) and gbar * term, d_pw, d_ss, d_st, d_g and
    # gt_all (12), with d_tau for vol-surf (14)
    return f + 3 * (2 + (12 if vol_vol else 14)), s + 3


def grid_cot_ops(vol_vol, hg, short_vrls, uv_steps):
    """(float32, special-function) operations, by OPS's rules, of one
    open sample's grid cotangents (vol_vol_cot / vol_surf_cot of
    GridMedium), as few as the VJP needs: each U-V quadrature step's t,
    point and voxel count once (GRID_OPS's forward read, the voxel
    lookup GRID_OPS["density"] less its scale product), though the
    kernel computes them again for the scatter; the atomic add itself is
    counted in bytes, not operations. The per-VRL sums over rays count
    the adds the function needs: 3 per pair for d_power (kernel_ops), 2
    per open sample for the d_vod entries it touches (here)."""
    n_phase = 2 if vol_vol else 1
    f, s = 1, 0                                   # the VRL fraction
    f += GRID_OPS["interp"][0]                    # od_sv
    f += GRID_OPS["segment"][0] + uv_steps * (
        GRID_OPS["segment_step"][0] + GRID_OPS["density"][0] - 1)
    s += GRID_OPS["segment"][1] + uv_steps * GRID_OPS["segment_step"][1]
    f += n_phase * GRID_OPS["density"][0]         # the voxels of U (and V)
    if vol_vol:  # the eye fraction (a division), its entry, od's two adds
        f, s = f + GRID_OPS["interp"][0] + 2, s + 1
    else:
        f += 1
    if hg:  # phase_eval and phase_dg at each vertex (4, 2) + (6, 2)
        f, s = f + 10 * n_phase, s + 4 * n_phase
    else:
        f += 3 * n_phase
    f, s = f + (1 if vol_vol else 2), s + 1       # geo
    if hg:
        f, s = f + (3 if vol_vol else 2), s + 1   # geo_g
    if short_vrls:  # exp(-chan od_sv), the clamp, two divisions, the test;
        f, s = f + 3 + 4, s + 3                   # d chan, the VRL-OD cot
    # per channel: w (3, 1), a, the density factors, gt and the sums of
    # d_pw, d_ss, d_st, d_g, the density cotangents, c_od, gt_all
    f, s = f + 3 * (32 if vol_vol else 38), s + 3
    n_tables = 2 if vol_vol else 1                # interp_od_cot: 12 each
    f += 12 * n_tables + 2                        # d_vod's sum over rays
    # segment_od_cot: c_step (1, 1); per step the scatter and its d scale
    # share (4), on the read's voxel
    f, s = f + 1 + uv_steps * 4, s + 1
    return f + 5 * n_phase + 1, s                 # the U, V scatters


def kernel_ops(kernel, sweep, hg, short_vrls, uv_steps=None, tri=False):
    """(float32, special-function) operations of `kernel` on this run's
    samples (a SweepCount), by OPS's rules; uv_steps for the grid
    kernels (whose open samples skip the homogeneous path length: 2 and
    1 adds), tri for their trilinear forms."""
    # per pair beyond pair_setup: R's mean and variance of the mean (two
    # families: the division, the sum, k mu^2, the clamp, two divisions,
    # the sum), the backward's warp sums of d_power (3 x 5 adds), and in a
    # grid medium d_power's sum over rays (3; d_vod's: grid_cot_ops)
    extra = {"vrl_r": (12, 6), "vrl_sum_bwd": (15, 0),
             "vrl_sum_hetero_bwd": (3, 0)}.get(kernel, (0, 0))
    rows = [(sweep.pairs, (OPS["pair"][0] + extra[0],
                           OPS["pair"][1] + extra[1])),
            (sweep.drawn[0], OPS["vv"]), (sweep.drawn[1], OPS["vs"]),
            (sum(sweep.tested), OPS["segment"]),
            (sweep.tri_tests, OPS["triangle"])]
    for fam, name in enumerate(("vv_open", "vs_open")):
        if uv_steps is None:
            est = estimator_ops(kernel, fam == 0, hg, short_vrls)
        elif kernel == "vrl_sum_hetero_bwd":
            est = grid_cot_ops(fam == 0, hg, short_vrls, uv_steps)
            est = (est[0] - (2 if fam == 0 else 1), est[1])
        else:
            est = grid_estimator_ops(kernel, fam == 0, hg, short_vrls,
                                     uv_steps, tri)
            est = (est[0] - (2 if fam == 0 else 1), est[1])
        rows.append((sweep.open[fam], (OPS[name][0] + est[0],
                                       OPS[name][1] + est[1])))
    return (sum(n * f for n, (f, _) in rows),
            sum(n * s for n, (_, s) in rows))


class SweepCount:
    """This run's samples as a kernel meets them, counted while a plain
    version runs inside `with SweepCount(pair_ok, alb_ok) as sweep:`.

    pair_ok (B, G): the pairs the kernel evaluates (a valid ray, and a
    valid VRL or table column); alb_ok (B,): the rays whose vol-surf
    samples it draws. ops.vrl_sum._occluded_packed is wrapped so that
    each shadow segment's sweep length is the kernel's (occluded() stops
    at the first blocking triangle): the plain test's Wald test of each
    triangle (vs._wald_hits, in the plain test's blocks of
    _OCCLUSION_TESTS), which decides each segment as the plain test
    does. The plain versions call the test per block of
    rays, in ray order, svv vol-vol then svs vol-surf times a block.
    Counts per family [vol-vol, vol-surf]: drawn samples, tested
    segments (the kernel skips the test where d_uv^2 = 0, seen here, or
    the pdf is 0, not seen here), open segments; and tri_tests, the
    triangles of all sweeps. With reads = (grid medium pack, supersampled
    density, U-V steps), also merged_reads: the density reductions of
    the grid backward's open samples (U, each quadrature step and V, in
    path order) inside the box, consecutive reads of one voxel counted
    once, as the backward compiled for the step count merges them (reads
    whose cotangent is 0, which it skips, are counted)."""

    def __init__(self, pair_ok, alb_ok, svv=2, svs=2, reads=None):
        self.pair_ok, self.alb_ok, self.svv, self.svs = pair_ok, alb_ok, svv, svs
        self.pairs = int(pair_ok.sum())
        self.drawn = [svv * self.pairs,
                      svs * int((pair_ok & alb_ok[:, None]).sum())]
        self.tested, self.open, self.tri_tests = [0, 0], [0, 0], 0
        self.reads, self.merged_reads = reads, 0
        self._calls = self._b0 = 0

    def __enter__(self):
        self._test = vs._occluded_packed
        vs._occluded_packed = self._count
        return self

    def __exit__(self, *exc):
        vs._occluded_packed = self._test

    def _count(self, p, q, tris):
        n_tris = tris.shape[0]
        shape = torch.broadcast_shapes(p.shape, q.shape)[:-1]
        step = max(1, vs._OCCLUSION_TESTS // max(math.prod(shape), 1))
        hits = torch.cat([vs._wald_hits(p, q, tris[t:t + step])
                          for t in range(0, n_tris, step)], dim=-1)
        blocked = hits.any(dim=-1)
        sweep = torch.where(blocked, hits.int().argmax(dim=-1) + 1, n_tris)
        k = self._calls % (self.svv + self.svs)
        self._calls += 1
        fam, n = int(k >= self.svv), blocked.shape[0]
        ok = self.pair_ok[self._b0:self._b0 + n]
        if fam:
            ok = ok & self.alb_ok[self._b0:self._b0 + n, None]
        dd = q - p
        ok = ok & ((dd * dd).sum(dim=-1) > 0.0)
        self.tested[fam] += int(ok.sum())
        self.open[fam] += int((ok & ~blocked).sum())
        self.tri_tests += int(sweep[ok].sum())
        if self.reads is not None:
            self.merged_reads += self._merged(p, q, ok & ~blocked, fam)
        if k == self.svv + self.svs - 1:
            self._b0 += n
        return blocked

    def _merged(self, p, q, live, fam):
        med, density, uv = self.reads
        p, q = torch.broadcast_tensors(p, q)
        points = ([p] if fam == 0 else []) + [
            p + (q - p) * ((i + 0.5) / uv) for i in range(uv)] + [q]
        vox = torch.stack([grid_voxel(med, density, x) for x in points], -1)
        inside = vox >= 0
        repeat = inside[..., 1:] & (vox[..., 1:] == vox[..., :-1])
        return int((inside.sum(-1) - repeat.sum(-1))[live].sum())

    def __str__(self):
        tested = sum(self.tested)
        return (f"{self.pairs} pairs, {sum(self.drawn)} samples, "
                f"{sum(self.open) / tested:.3f} of {tested} shadow segments "
                f"open, {self.tri_tests / tested:.3f} triangles per sweep")


def grid_voxel(med, density, p):
    """The flat index into the supersampled density of the voxel that the
    density at p reads (integrate.grid_density's nearest entry;
    vrl_common.cuh GridMedium::voxel), -1 outside the box."""
    q = (p - med[8:11]) * med[11:14]
    inside = ((q >= 0.0) & (q <= 1.0)).all(dim=-1)
    scales = med[14:17]
    idx = torch.minimum(torch.clamp(torch.round(q * scales), min=0.0),
                        scales).long()
    _, ny, nx = density.shape
    flat = (idx[..., 2] * ny + idx[..., 1]) * nx + idx[..., 0]
    return torch.where(inside, flat, -1)


def skip_share_counts(counts, sweep):
    """plane_ops' counts for the segments of `sweep` (a SweepCount) at
    the share of Wald tests that a checking launch on other segments of
    the same scene skipped (`counts`)."""
    share = counts["skipped"] / max(counts["considered"], 1)
    return {"segments": sum(sweep.tested), "considered": sweep.tri_tests,
            "skipped": share * sweep.tri_tests}


def check_line(counts):
    """A line of kernel 1's checking launch (vrl_sum_check's counts)."""
    return (f"{counts['segments']} segments, {counts['skipped']} of "
            f"{counts['considered']} triangle tests skipped by the "
            "pre-reject "
            f"({counts['skipped'] / max(counts['considered'], 1):.1%}),"
            f" {counts['bad_tris']} skipped triangles blocking, "
            f"{counts['bad_segments']} segments decided differently")


def plane_ops(ops, sweep, counts):
    """kernel_ops' (float32, special-function) operations of kernel 1
    with its sweep counted as PlaneTris makes it: the plane test of every
    triangle met and the Wald test of those it does not skip, from the
    checking launch's counts on the same inputs, in place of a Wald test
    per triangle swept."""
    f = (ops[0] - sweep.tri_tests * OPS["triangle"][0]
         + counts["segments"] * OPS["plane_segment"][0]
         + counts["considered"] * OPS["plane"][0]
         + (counts["considered"] - counts["skipped"]) * OPS["triangle"][0])
    return f, ops[1]


def config1_split(packs, seed, kind=0):
    """{variant: ms} of kernel 1 on packs (CUDA events, median of 20
    after 3): whole, without the plane pre-reject (a Wald test per
    triangle), and with no triangles (no shadow sweep)."""
    lib = vs._library()
    rays, vrls, tris, med = packs

    def launch(t, **kw):
        return lambda: vs._launch(lib, rays, vrls, t, med, None, seed, 2, 2,
                                  True, kind, **kw)

    variants = {"whole": launch(tris),
                "no pre-reject": launch(tris, mode=vs.MODE_NO_REJECT),
                "no triangles": launch(tris[:0].contiguous())}
    return {k: summary(cuda_ms(fn, 3, 20))[0] for k, fn in variants.items()}


def pair_masks(rays, vrls):
    """SweepCount's (pair_ok, alb_ok) of an unclustered kernel."""
    return ((rays[pk.VALID] > 0.5)[:, None] & (vrls[pk.VVALID] > 0.5)[None],
            rays[pk.ALB:pk.ALB + 3].sum(dim=0) > 0.0)


def bound(ops, n_bytes):
    """(ms, "bytes" or "operations"): the least time of the work (see
    the constants' comment), the larger of its bytes over the memory
    rate and its (float32, special-function) operations over the peak
    rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(ops[0] / FP32_PER_S, ops[1] / SFU_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def table_pair_ok(rays, vrls, ray_slice, table_ids, table_weights):
    """(B, C) the table columns each ray evaluates: a valid ray, a valid
    VRL id, weight > 0; none for rays at row -1."""
    n = vrls.shape[1]
    ids = table_ids.long()
    ok = (ids >= 0) & (ids < n) & (table_weights > 0) \
        & (vrls[pk.VVALID][ids.clamp(0, n - 1)] > 0.5)
    rows = torch.as_tensor(ray_slice, device=rays.device).long()
    return ok[rows.clamp(min=0)] & ((rows >= 0)
                                    & (rays[pk.VALID] > 0.5))[:, None]


def rep_packs(scene, vrls, slice_info):
    """The packs of the representative pixels' centre rays (the R
    kernel's rays, as alvrl.build_R_device makes them), grid packs and
    the supersampled density in a grid medium."""
    rows = torch.as_tensor(np.concatenate(slice_info.repr_rows),
                           device=scene.device)
    w = scene.camera.width
    ray_o, ray_d = perspective.sample_ray(scene.camera, rows % w, rows // w)
    return integrator.pack_rays_vrls(scene, ray_o, ray_d, vrls)[1]


@contextlib.contextmanager
def plain_chunk(n_rays):
    """The plain versions in blocks of n_rays rays instead of
    ops.vrl_sum._PLAIN_RAY_CHUNK (their results do not depend on it):
    fewer, larger operations on the card."""
    old = vs._PLAIN_RAY_CHUNK
    vs._PLAIN_RAY_CHUNK = n_rays
    try:
        yield
    finally:
        vs._PLAIN_RAY_CHUNK = old


def media_scenes(dev):
    out = {}
    for name, (g, kind) in MEDIA.items():
        scene = presets.cornell_smoke(WIDTH, HEIGHT, g=g, device=dev)
        out[name] = replace(scene, medium=replace(scene.medium,
                                                  phase_kind=kind))
    return out


def config2(dev, card, cfg):
    """Phases 11-14, the config-2 clustered render; returns the kernels
    line's entries of vrl_r and vrl_sum_clustered, and what phases 23-26
    take from it (the scene, its VRLs, packs and tables, the seed, the
    clustered sum's samples on them and its time)."""
    tcfg = tracer.TracerConfig()  # max_depth 16, rr_depth 5, short VRLs
    params = alvrl.ALVRLParams(**C2_PARAMS,
                               cluster=cl.ClusterParams(**C2_CLUSTER))
    scene = presets.cornell_smoke(WIDTH, HEIGHT, device=dev)
    t0 = time.perf_counter()
    info = alvrl.build_slice_info(scene, params)
    slice_ms = (time.perf_counter() - t0) * 1e3
    vrls = vrl.compact(
        tracer.trace(scene, torch.Generator().manual_seed(11),
                     params.num_particles, tcfg),
        params.vrl_target_num, slots_per_particle=tcfg.max_depth)
    n_vrls, n_rays = vrls.capacity, WIDTH * HEIGHT
    n_rep = sum(len(r) for r in info.repr_rows)
    check(n_vrls == params.vrl_target_num
          and len(info.repr_rows) == C2_CLUSTER["target_num_slices"],
          f"config-2 shapes: {n_vrls} VRLs, {len(info.repr_rows)} slices")
    seed = 20261017
    rng = np.random.default_rng(12)
    scenes = media_scenes(dev)

    # 11. the R kernel against its plain version
    u_inj = torch.as_tensor(rng.random((n_rep, n_vrls, 6), dtype=np.float32),
                            device=dev)
    u_philox = philox_uniforms(seed, n_rep, n_vrls, 6, device=dev)
    r_err, results = 0.0, []
    for name, sc in scenes.items():
        kind = MEDIA[name][1]
        packs = rep_packs(sc, vrls, info)
        for mode in ("injected", "philox", "long"):
            short = mode != "long"
            u = u_philox if mode == "philox" else u_inj
            out = vrl_r(*packs, seed=seed,
                        uniforms=None if mode == "philox" else u,
                        short_vrls=short, phase_kind=kind)
            ref = vrl_r_reference(*packs, u, short_vrls=short,
                                  phase_kind=kind)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), f"R {name}/{mode} finite")
            median, share = homog_bar(out[0], ref[0], channels=1)
            check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
                  f"R mean {name}/{mode}: median {median}, share {share}")
            nz = ref[1] > R_VAR_FLOOR
            check(int(nz.sum()) > 1000, f"R {name}/{mode}: variances")
            v_med = float(((out[1] - ref[1]).abs()[nz] / ref[1][nz]).median())
            check(v_med < R_VAR_MEDIAN, f"R var {name}/{mode}: {v_med}")
            r_err = max(r_err, float((out - ref).abs().max()))
            line = (f"{name}/{mode} mean median {median:.2e} share "
                    f"{share:.4f}, var median {v_med:.2e}")
            if mode == "philox":  # the same stream as vrl_sum's
                sums = vrl_sum(*packs, seed=seed, phase_kind=kind)
                lum = sum(w * c for w, c in zip(LUM_WEIGHTS, sums))
                rs_med, rs_share = homog_bar(out[0].sum(dim=1), lum,
                                             channels=1)
                check(rs_med < HOMOG_MEDIAN and rs_share < HOMOG_SHARE,
                      f"R row sums {name}/{mode}: {rs_med}, {rs_share}")
                line += f", row sums vs vrl_sum median {rs_med:.2e}"
            results.append(line)
    print(f"[11 R kernel vs plain on {card}, P={n_rep} N={n_vrls} (slicing "
          f"{slice_ms:.1f} ms)] " + " | ".join(results), flush=True)
    del u_inj

    # 12. the clustered kernel against its plain version, real tables
    sop, tv, tw, cinfo = alvrl.prepare_clustering(scene, vrls, seed, params,
                                                  cfg, info)
    n_cols = tv.shape[1]
    u_inj = torch.as_tensor(rng.random((n_rays, n_cols, 6),
                                       dtype=np.float32), device=dev)
    u_philox = philox_table_uniforms(seed, sop, tv, 6)
    hold_np = np.arange(0, n_rays, K2_HOLD_STRIDE)
    hold_rays = torch.as_tensor(hold_np, device=dev)
    c_err, results = 0.0, []
    for name, sc in scenes.items():
        kind = MEDIA[name][1]
        packs = integrator.pack_frame(sc, vrls)[3]
        for mode in ("injected", "philox", "long"):
            short = mode != "long"
            u = u_philox if mode == "philox" else u_inj
            kw = dict(seed=seed, uniforms=None if mode == "philox" else u,
                      short_vrls=short, phase_kind=kind)
            out = vrl_sum_clustered(*packs, sop, tv, tw, **kw)
            again = vrl_sum_clustered(*packs, sop, tv, tw, **kw)
            # the plain version on every K2_HOLD_STRIDE-th ray
            ref = vrl_sum_clustered_reference(
                packs[0][:, hold_rays].contiguous(), *packs[1:],
                sop[hold_np], tv, tw, u[hold_rays].contiguous(),
                short_vrls=short, phase_kind=kind)
            torch.cuda.synchronize()
            check(torch.equal(out, again), f"clustered {name}/{mode}: a "
                  "repeat launch is not bit-identical")
            out = out[:, hold_rays]
            check(bool(torch.isfinite(out).all())
                  and float(out.abs().sum()) > 0.0,
                  f"clustered {name}/{mode} finite, non-zero")
            median, share = homog_bar(out.T, ref.T)
            check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
                  f"clustered {name}/{mode}: median {median}, share {share}")
            c_err = max(c_err, float((out - ref).abs().max()))
            results.append(f"{name}/{mode} median {median:.2e} share "
                           f"{share:.4f}")
    packs = integrator.pack_frame(scene, vrls)[3]
    ids = torch.arange(n_vrls, dtype=torch.int32, device=dev)[None]
    ident = vrl_sum_clustered(*packs, np.zeros(n_rays, np.int64), ids,
                              torch.ones((1, n_vrls), device=dev), seed=seed)
    median, share = homog_bar(ident.T, vrl_sum(*packs, seed=seed).T)
    check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
          f"identity table vs vrl_sum: median {median}, share {share}")
    results.append(f"identity table ({n_vrls} columns) vs vrl_sum median "
                   f"{median:.2e} share {share:.4f}")
    fb_rows = np.where(rng.random(n_rays) < 0.05, 0, -1)
    fb_ids, fb_ws = alvrl.fallback_table(
        replace(cinfo, pixel_to_slice=fb_rows.astype(np.int32)), dev)
    fb = vrl_sum_clustered(*packs, fb_rows, fb_ids[None], fb_ws[None],
                           seed=seed)
    fb_ref = vrl_sum_clustered_reference(
        *packs, fb_rows, fb_ids[None], fb_ws[None],
        philox_table_uniforms(seed, fb_rows, fb_ids[None], 6))
    median, share = homog_bar(fb.T, fb_ref.T)
    check(median < HOMOG_MEDIAN and share < HOMOG_SHARE
          and not fb[:, torch.as_tensor(fb_rows < 0, device=dev)].any(),
          f"fall-back launch vs plain: median {median}, share {share}")
    results.append(f"fall-back launch ({len(fb_ids)} columns, "
                   f"{int((fb_rows >= 0).sum())} rays) median {median:.2e}")
    print(f"[12 clustered kernel vs plain on {card}, B={n_rays} S={tv.shape[0]}"
          f" C={n_cols}, the media held on {len(hold_np)} rays (every "
          f"{K2_HOLD_STRIDE}th), repeats bit-identical] "
          + " | ".join(results), flush=True)
    del u_inj, u_philox

    # 13. the main path, through the entry point a user calls
    vrl_r.launches = vrl_sum_clustered.launches = 0
    img, vrls_m, info_m = alvrl.render_alvrl(
        scene, torch.Generator().manual_seed(100), params, cfg, tcfg,
        slice_info=info)
    torch.cuda.synchronize()
    launches = (vrl_r.launches, vrl_sum_clustered.launches)
    check(min(launches) >= 1, f"render_alvrl's kernel launches {launches}")
    check(tuple(img.shape) == (HEIGHT, WIDTH, 3), f"image shape {img.shape}")
    check(bool(torch.isfinite(img).all()), "clustered image finite")
    check(float(img.abs().max()) > 0.0, "clustered image non-zero")
    means = [(float(img.mean()), float(integrator.render_with_vrls_kernel(
        scene, vrls_m, torch.Generator().manual_seed(1000), cfg).mean()))]
    for k in (1, 2):
        img_k, vrls_k, _ = alvrl.render_alvrl(
            scene, torch.Generator().manual_seed(100 + k), params, cfg, tcfg,
            slice_info=info)
        means.append((float(img_k.mean()), float(
            integrator.render_with_vrls_kernel(
                scene, vrls_k, torch.Generator().manual_seed(1000 + k),
                cfg).mean())))
    ratio = np.mean([m[0] for m in means]) / np.mean([m[1] for m in means])
    check(C2_BAND[0] < ratio < C2_BAND[1],
          f"clustered / unclustered image mean {ratio} ({means})")
    reps = (info_m.slice_weights > 0).sum(axis=1)
    n_fb = int((info_m.pixel_to_slice < 0).sum())
    print(f"[13 main path on {card}] render_alvrl, config 2: launches vrl_r "
          f"{launches[0]} vrl_sum_clustered {launches[1]}; S "
          f"{len(info.repr_rows)}, P {n_rep}, representatives per slice "
          f"mean {reps.mean():.2f} max {reps.max()}, undersampling "
          f"{n_vrls / reps.mean():.1f}, fall-back pixels {n_fb} ("
          f"{len(info_m.fallback_vrls)} VRLs); image mean "
          f"{float(img.mean()):.6f}; clustered / unclustered mean over 3 "
          f"seeds {ratio:.4f} (" + ", ".join(f"{a:.5f}/{b:.5f}"
                                             for a, b in means) + ")",
          flush=True)

    # 14. a warm pass: per stage, each kernel alone, a profile
    c_block = vsc.ray_block(False)  # kernel 2's rays per tile

    def staged(gen):
        t, out = {}, {}

        def stage(name, fn):
            t0 = time.perf_counter()
            out[name] = fn()
            torch.cuda.synchronize()
            t[name] = (time.perf_counter() - t0) * 1e3
            return out[name]

        v = stage("trace+compact", lambda: vrl.compact(
            tracer.trace(scene, gen, params.num_particles, tcfg),
            params.vrl_target_num, slots_per_particle=tcfg.max_depth))
        r = stage("R kernel", lambda: alvrl.build_R_device(
            scene, v, cfg, info, integrator.draw_seed(gen)))
        r_host = stage("bf16 transfer", lambda: alvrl.transfer_R(*r))
        clusters = stage("host clustering", lambda: alvrl.slice_clusters(
            *r_host, params, info))
        tables = stage("table packing", lambda: alvrl.pack_tables(
            info, *clusters, dev))
        stage("grouping", lambda: group_by_slice(tables[0], c_block))
        img = stage("clustered render", lambda: (
            integrator.render_clustered_kernel(
                scene, v, *tables[:3], gen, cfg,
                fallback=alvrl.fallback_table(tables[3], dev))))
        return t, img

    t_staged, img_staged = staged(torch.Generator().manual_seed(100))
    check(torch.equal(img_staged, img), "the staged pass is render_alvrl's")
    stages = {k: [] for k in t_staged}
    gen = torch.Generator().manual_seed(7)
    for i in range(13):
        t_i, _ = staged(gen)
        if i >= 3:
            for k, v in t_i.items():
                stages[k].append(v)
    pass_ms = host_ms(lambda: alvrl.render_alvrl(
        scene, gen, params, cfg, tcfg, slice_info=info), 3, 10)
    packs_r = rep_packs(scene, vrls, info)
    r_ms = cuda_ms_batched(lambda: vrl_r(*packs_r, seed=seed), 3, 10, 10)
    u_r = philox_uniforms(seed, n_rep, n_vrls, 6, device=dev)
    r_plain_ms = cuda_ms(lambda: vrl_r_reference(*packs_r, u_r), 1, 5)
    # the kernel alone: the wrapper's host grouping (timed above) is
    # longer than the kernel, so the launches go on pre-grouped tiles
    tiles = [torch.as_tensor(a, device=dev) for a in group_by_slice(
        sop, c_block)]

    def c_launch(out, **kw):
        vsc._launch(vsc._library(), *packs, *tiles, tv, tw, None, seed, 2, 2,
                    True, scene.medium.phase_kind, out, **kw)

    c_out = torch.zeros((3, n_rays), device=dev)
    c_ms = cuda_ms_batched(lambda: c_launch(c_out), 3, 10, 10)
    # kernel 2 without the plane pre-reject: the same tiling, which must
    # give the same bits
    c_nr = torch.zeros_like(c_out)
    c_nr_ms = cuda_ms_batched(lambda: c_launch(
        c_nr, mode=vs.MODE_NO_REJECT), 3, 10, 10)
    check(torch.equal(c_nr, c_out), "kernel 2 with and without the plane "
          "pre-reject: not bit-identical")
    wrapper_ms = host_ms(lambda: vrl_sum_clustered(*packs, sop, tv, tw,
                                                   seed=seed), 3, 10)
    check(torch.equal(c_out, vrl_sum_clustered(*packs, sop, tv, tw,
                                               seed=seed)),
          "the bare launch is the wrapper's")
    u_c = philox_table_uniforms(seed, sop, tv, 6)
    c_plain_ms = cuda_ms(lambda: vrl_sum_clustered_reference(
        *packs, sop, tv, tw, u_c), 1, 5)
    (r_med, r_spread), (rp_med, _), (c_med, c_spread), (cp_med, _), \
        (p_med, p_spread) = map(summary, (r_ms, r_plain_ms, c_ms, c_plain_ms,
                                          pass_ms))
    hg = scene.medium.phase_kind == 0
    with SweepCount(*pair_masks(packs_r[0], packs_r[1])) as r_sweep:
        vrl_r_reference(*packs_r, u_r)
    with SweepCount(table_pair_ok(packs[0], packs[1], sop, tv, tw),
                    pair_masks(*packs[:2])[1]) as c_sweep:
        vrl_sum_clustered_reference(*packs, sop, tv, tw, u_c)
    tile_rays, tile_row = group_by_slice(sop, c_block)
    # kernel 5's checking launch on the timed launches' samples: its
    # pre-reject decides as the Wald test, and its counted skips price
    # the bound
    r_chk, r_counts = vrl_r_check(*packs_r, seed=seed)
    r_out = vrl_r(*packs_r, seed=seed)
    check(r_counts["bad_tris"] == 0 and r_counts["bad_segments"] == 0,
          f"R: the pre-reject disagrees with the Wald test: {r_counts}")
    check(r_counts["segments"] > 0 and r_counts["skipped"] > 0,
          f"R: checking counts {r_counts}")
    r_chk_bar = homog_bar(r_chk[0], r_out[0], channels=1)
    check(r_chk_bar[0] < HOMOG_MEDIAN and r_chk_bar[1] < HOMOG_SHARE,
          f"R: the checking launch against the kernel: {r_chk_bar}")
    r_ops = kernel_ops("vrl_r", r_sweep, hg, True)
    r_bytes = nbytes(*packs_r) + 2 * n_rep * n_vrls * 4
    r_bound = bound(plane_ops(r_ops, r_sweep, r_counts), r_bytes)
    r_tile = vr.tile_rays(False)
    r_blocks = -(-n_rep // r_tile) * -(-n_vrls // vs._library().alvrl_vrl_chunk())
    # kernel 2's checking launch on the timed launches' samples, as kernel
    # 5's
    c_chk, c_counts = vrl_sum_clustered_check(*packs, sop, tv, tw, seed=seed)
    check(c_counts["bad_tris"] == 0 and c_counts["bad_segments"] == 0,
          f"clustered: the pre-reject disagrees with the Wald test: "
          f"{c_counts}")
    check(c_counts["segments"] > 0 and c_counts["skipped"] > 0,
          f"clustered: checking counts {c_counts}")
    check(torch.equal(c_chk, c_out), "clustered: the checking launch is not "
          "bit-identical to the kernel")
    c_ops = kernel_ops("vrl_sum_clustered", c_sweep, hg, True)
    c_bytes = (nbytes(*packs, tv, tw) + 4 * (len(tile_rays) + len(tile_row))
               + 3 * n_rays * 4)
    c_bound = bound(plane_ops(c_ops, c_sweep, c_counts), c_bytes)
    c_regs = [r for r in ptxas_summary(_build.build_log())
              if r.startswith("vrl_sum_clustered_warps_kernel")]
    print(f"[14 timing on {card}] warm pass (render_alvrl, host clock) "
          f"{p_med:.3f} ms (spread {p_spread:.1%}); stages, median of 10 "
          "(spread): " + " | ".join(
              f"{k} {statistics.median(v):.3f} ms ({summary(v)[1]:.1%})"
              for k, v in stages.items())
          + f" | alone (CUDA events over 10 launches in a row): vrl_r "
          f"{r_med:.4f} ms (before its redesign {EARLIER_MS['vrl_r']} ms; "
          f"spread {r_spread:.1%}, tiles of {r_tile} rays x "
          f"{vs._library().alvrl_vrl_chunk()} VRLs, {r_blocks} blocks, "
          f"{vs.occupancy('vrl_r', False, packs_r[2].shape[0])} an SM; "
          f"{r_sweep}; checking launch: {check_line(r_counts)}, "
          f"{r_counts['skipped'] / max(r_counts['segments'], 1):.3f} of "
          f"{r_counts['considered'] / max(r_counts['segments'], 1):.3f} Wald"
          f" tests a segment skipped, its output "
          f"{'bit-identical to' if torch.equal(r_chk, r_out) else 'within the bar of'}"
          f" the kernel's; bound {r_bound[0]:.4f} ms by {r_bound[1]} on the "
          f"counted skips, {bound(r_ops, r_bytes)[0]:.4f} ms with a Wald "
          f"test per swept triangle), plain {rp_med:.3f} ms; "
          f"vrl_sum_clustered "
          f"{c_med:.4f} ms (before its redesign "
          f"{EARLIER_MS['vrl_sum_clustered']} ms; spread {c_spread:.1%}, "
          f"{len(tile_row)} tiles of {c_block} rays "
          f"({float((tile_rays < 0).mean()):.1%} padding), "
          f"{vs.occupancy('vrl_sum_clustered', False, packs[2].shape[0])} "
          f"blocks an SM; {' ; '.join(c_regs)}; {c_sweep}; checking launch: "
          f"{check_line(c_counts)}, "
          f"{c_counts['skipped'] / max(c_counts['segments'], 1):.3f} of "
          f"{c_counts['considered'] / max(c_counts['segments'], 1):.3f} Wald"
          f" tests a segment skipped, its output bit-identical to the "
          f"kernel's; without the pre-reject {summary(c_nr_ms)[0]:.4f} ms, "
          f"bit-identical; bound {c_bound[0]:.4f} ms by {c_bound[1]} on the "
          f"counted skips, {bound(c_ops, c_bytes)[0]:.4f} ms with a Wald "
          f"test per swept triangle; the wrapper with its host grouping "
          f"{statistics.median(wrapper_ms):.3f} ms), plain {cp_med:.3f} ms",
          flush=True)
    prof = profile_device(lambda: alvrl.render_alvrl(
        scene, gen, params, cfg, tcfg, slice_info=info), 2, 5)
    if prof is None:
        print("[14 profile] the profiler saw no device operation: not "
              "measured", flush=True)
    else:
        span, busy, n_ops, by_name = prof
        mine = {k: sum(v for n, v in by_name.items() if k + "<" in n)
                for k in ("vrl_r_kernel", "vrl_sum_clustered_warps_kernel")}
        top = sorted(((v, k) for k, v in by_name.items()
                      if not any(m + "<" in k for m in mine)),
                     reverse=True)[:4]
        print(f"[14 profile on {card}] per traced pass: device span "
              f"{span:.3f} ms, busy {busy:.3f} ms, idle share "
              f"{1 - busy / span:.1%}, {n_ops:g} device ops; "
              + ", ".join(f"{k} {v:.4f} ms ({v / busy:.1%} of busy)"
                          for k, v in mine.items()) + "; next: "
              + " | ".join(f"{v:.3f} ms {k[:60]}" for v, k in top),
              flush=True)
    return [{
        "name": "vrl_r", "route": "cuda",
        "source": "alvrl_tpu_torch/csrc/vrl_r.cu",
        "replaces": "alvrl_tpu/ops/vrl_pallas.py:1019",
        "launches": launches[0], "max_abs_err": r_err,
        "ms": r_med, "plain_ms": rp_med, "bound_ms": r_bound[0],
        "bound_by": r_bound[1], "library_ms": None,
    }, {
        "name": "vrl_sum_clustered", "route": "cuda",
        "source": "alvrl_tpu_torch/csrc/vrl_sum_clustered.cu",
        "replaces": "alvrl_tpu/ops/vrl_pallas.py:785",
        "launches": launches[1], "max_abs_err": c_err,
        "ms": c_med, "plain_ms": cp_med, "bound_ms": c_bound[0],
        "bound_by": c_bound[1], "library_ms": None,
    }], dict(scene=scene, vrls=vrls, packs=packs, seed=seed, sop=sop, tv=tv,
             tw=tw, cinfo=cinfo, sweep=c_sweep, fwd_ms=c_med)

# (name, uniforms, short VRLs, phase kind) of phase 15's comparisons
C4_CASES = [("hg_g03", "injected", True, 0), ("hg_g03", "philox", True, 0),
            ("rayleigh", "philox", True, 1), ("hg_g03", "long", False, 0)]


def config4(dev, card, cfg):
    """Phases 15-18, the config-4 clustered render in a grid medium;
    returns the kernels line's entries of the three grid kernels, and
    what phases 19-22 take from it (the scene, its VRLs and packs, the
    seed, and the samples of vrl_sum_hetero on them)."""
    tcfg = tracer.TracerConfig(max_depth=C4_DEPTH)
    params = alvrl.ALVRLParams(**C4_PARAMS,
                               cluster=cl.ClusterParams(**C4_CLUSTER))
    scene = presets.cornell_grid_smoke(C4_SIZE, C4_SIZE, grid_res=C4_GRID,
                                       device=dev)
    kw = dict(uv_steps=cfg.uv_tau_steps)
    t0 = time.perf_counter()
    info = alvrl.build_slice_info(scene, params)
    slice_ms = (time.perf_counter() - t0) * 1e3
    vrls = vrl.compact(
        tracer.trace(scene, torch.Generator().manual_seed(41),
                     params.num_particles, tcfg),
        params.vrl_target_num, slots_per_particle=C4_DEPTH)
    n_vrls, n_rays = vrls.capacity, C4_SIZE * C4_SIZE
    n_rep = sum(len(r) for r in info.repr_rows)
    px, py, hit, packs = integrator.pack_frame(scene, vrls)
    density = packs[4]
    check(n_vrls == params.vrl_target_num
          and len(info.repr_rows) == C4_CLUSTER["target_num_slices"]
          and packs[0].shape == (pk.GRID_RAY_ROWS, n_rays)
          and tuple(density.shape) == (2 * C4_GRID - 1,) * 3
          and packs[2].shape[0] == C4_TRIS,
          f"config-4 shapes: {n_vrls} VRLs, {len(info.repr_rows)} slices, "
          f"rays {tuple(packs[0].shape)}, density {tuple(density.shape)}")
    seed = 20261018
    gen = torch.Generator(device=dev).manual_seed(15)

    # 15. the grid kernels against their plain versions
    b0, b1 = C4_ROWS[0] * C4_SIZE, C4_ROWS[1] * C4_SIZE
    sub = (packs[0][:, b0:b1].contiguous(), *packs[1:])
    u_full = torch.rand((n_rays, n_vrls, 6), generator=gen, device=dev)
    u_sub = philox_draws(seed, torch.arange(b0, b1, device=dev)[:, None],
                         torch.arange(n_vrls, device=dev)[None], 6)
    packs_r = rep_packs(scene, vrls, info)
    u_r = torch.rand((n_rep, n_vrls, 6), generator=gen, device=dev)
    u_r_philox = philox_uniforms(seed, n_rep, n_vrls, 6, device=dev)
    sop, tv, tw, cinfo = alvrl.prepare_clustering(scene, vrls, seed, params,
                                                  cfg, info)
    n_cols = tv.shape[1]
    rows, counts = np.unique(sop[sop >= 0], return_counts=True)
    n_sl = max(1, int(np.searchsorted(np.cumsum(counts), C4_SUBSET_RAYS,
                                      side="right")))
    idx = np.flatnonzero(np.isin(sop, rows[:n_sl]))
    idx_t = torch.as_tensor(idx, device=dev)
    sub_c = (packs[0][:, idx_t].contiguous(), *packs[1:])
    u_c = torch.rand((n_rays, n_cols, 6), generator=gen, device=dev)
    u_c_sub = philox_draws(seed, idx_t[:, None], tv[torch.as_tensor(
        sop[idx], device=dev).long()].long(), 6)
    errs, results = {"sum": 0.0, "r": 0.0, "clustered": 0.0}, []
    with plain_chunk(C4_PLAIN_CHUNK):
        for name, mode, short, kind in C4_CASES:
            inj = mode != "philox"
            case = dict(short_vrls=short, phase_kind=kind, **kw)
            out = vrl_sum_hetero(*packs, seed=seed,
                                 uniforms=u_full if inj else None, **case)
            ref = vrl_sum_hetero_reference(
                *sub, u_full[b0:b1] if inj else u_sub, **case)
            r = vrl_r_hetero(*packs_r, seed=seed,
                             uniforms=u_r if inj else None, **case)
            r_ref = vrl_r_hetero_reference(
                *packs_r, u_r if inj else u_r_philox, **case)
            c = vrl_sum_hetero_clustered(*packs, sop, tv, tw, seed=seed,
                                         uniforms=u_c if inj else None, **case)
            c_again = vrl_sum_hetero_clustered(
                *packs, sop, tv, tw, seed=seed,
                uniforms=u_c if inj else None, **case)
            c_ref = vrl_sum_hetero_clustered_reference(
                *sub_c, sop[idx], tv, tw, u_c[idx_t] if inj else u_c_sub,
                **case)
            torch.cuda.synchronize()
            tag = f"{name}/{mode}"
            for t in (out, r, c):
                check(bool(torch.isfinite(t).all())
                      and float(t.abs().sum()) > 0.0,
                      f"grid kernels {tag}: finite, non-zero")
            check(torch.equal(c, c_again), f"grid clustered {tag}: a repeat "
                  "launch is not bit-identical")
            s_bar = homog_bar(out[:, b0:b1].T, ref.T)
            r_bar = homog_bar(r[0], r_ref[0], channels=1)
            c_bar = homog_bar(c[:, idx_t].T, c_ref.T)
            nz = r_ref[1] > R_VAR_FLOOR
            check(int(nz.sum()) > 1000, f"grid R {tag}: variances")
            v_med = float(((r[1] - r_ref[1]).abs()[nz] / r_ref[1][nz])
                          .median())
            for what, (median, share) in (("sum", s_bar), ("R mean", r_bar),
                                          ("clustered", c_bar)):
                check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
                      f"grid {what} {tag}: median {median}, share {share}")
            check(v_med < R_VAR_MEDIAN, f"grid R var {tag}: {v_med}")
            errs["sum"] = max(errs["sum"], float((out[:, b0:b1] - ref).abs()
                                                 .max()))
            errs["r"] = max(errs["r"], float((r - r_ref).abs().max()))
            errs["clustered"] = max(errs["clustered"], float(
                (c[:, idx_t] - c_ref).abs().max()))
            results.append(
                f"{tag}: sum median {s_bar[0]:.2e} share {s_bar[1]:.4f}, R "
                f"mean {r_bar[0]:.2e} share {r_bar[1]:.4f} var {v_med:.2e}, "
                f"clustered {c_bar[0]:.2e} share {c_bar[1]:.4f}")
    del u_full, u_c
    sums = vrl_sum_hetero(*packs, seed=seed, **kw)
    ident = vrl_sum_hetero_clustered(
        *packs, np.zeros(n_rays, np.int64),
        torch.arange(n_vrls, dtype=torch.int32, device=dev)[None],
        torch.ones((1, n_vrls), device=dev), seed=seed, **kw)
    id_bar = homog_bar(ident.T, sums.T)
    lum = sum(w * ch for w, ch in zip(LUM_WEIGHTS, vrl_sum_hetero(
        *packs_r, seed=seed, **kw)))
    rs_bar = homog_bar(vrl_r_hetero(*packs_r, seed=seed, **kw)[0].sum(dim=1),
                       lum, channels=1)
    for what, (median, share) in (("identity table", id_bar),
                                  ("R row sums", rs_bar)):
        check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
              f"grid {what}: median {median}, share {share}")
    # the checking launches of the clustered sum and R on their full
    # inputs (the Philox stream of phase 17's timed launches)
    c_chk, c_counts = vrl_sum_hetero_clustered_check(*packs, sop, tv, tw,
                                                     seed=seed, **kw)
    r_chk, r_counts = vrl_r_hetero_check(*packs_r, seed=seed, **kw)
    for what, counts, (median, share) in (
            ("clustered", c_counts, homog_bar(
                c_chk.T, vrl_sum_hetero_clustered(*packs, sop, tv, tw,
                                                  seed=seed, **kw).T)),
            ("R", r_counts, homog_bar(r_chk[0], vrl_r_hetero(
                *packs_r, seed=seed, **kw)[0], channels=1))):
        check(counts["bad_tris"] == 0 and counts["bad_segments"] == 0,
              f"grid {what}: the pre-reject disagrees with the Wald test: "
              f"{counts}")
        check(counts["segments"] > 0 and counts["skipped"] > 0,
              f"grid {what}: checking counts {counts}")
        check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
              f"grid {what}: the checking launch against the kernel: "
              f"median {median}, share {share}")
    print(f"[15 grid kernels vs plain on {card}, config 4: B={n_rays} "
          f"N={n_vrls} P={n_rep} S={tv.shape[0]} C={n_cols}, density "
          f"{tuple(density.shape)} (slicing {slice_ms:.1f} ms); sums "
          f"compared on rows {C4_ROWS[0]}-{C4_ROWS[1] - 1} ({b1 - b0} rays), "
          f"the clustered sum on slices {int(rows[0])}-{int(rows[n_sl - 1])} "
          f"({len(idx)} rays), R in full; repeats bit-identical] "
          + " | ".join(results) + f" | identity table vs vrl_sum_hetero "
          f"median {id_bar[0]:.2e} share {id_bar[1]:.4f}; R row sums vs "
          f"vrl_sum_hetero luminance median {rs_bar[0]:.2e} | checking "
          f"launches on the full inputs: clustered {check_line(c_counts)}; R "
          f"{check_line(r_counts)}", flush=True)

    # 16. the main path, through the entry point a user calls
    vrl_sum_hetero.launches = vrl_r_hetero.launches = 0
    vrl_sum_hetero_clustered.launches = 0
    img, vrls_m, info_m = alvrl.render_alvrl(
        scene, torch.Generator().manual_seed(100), params, cfg, tcfg,
        slice_info=info)
    torch.cuda.synchronize()
    check(min(vrl_r_hetero.launches, vrl_sum_hetero_clustered.launches) >= 1,
          f"render_alvrl's grid launches {vrl_r_hetero.launches}, "
          f"{vrl_sum_hetero_clustered.launches}")
    check(tuple(img.shape) == (C4_SIZE, C4_SIZE, 3), f"image {img.shape}")
    check(bool(torch.isfinite(img).all()), "config-4 image finite")
    check(float(img.abs().max()) > 0.0, "config-4 image non-zero")
    means = [(float(img.mean()), float(integrator.render_with_vrls_kernel(
        scene, vrls_m, torch.Generator().manual_seed(1000), cfg).mean()))]
    for k in (1, 2):
        img_k, vrls_k, _ = alvrl.render_alvrl(
            scene, torch.Generator().manual_seed(100 + k), params, cfg, tcfg,
            slice_info=info)
        means.append((float(img_k.mean()), float(
            integrator.render_with_vrls_kernel(
                scene, vrls_k, torch.Generator().manual_seed(1000 + k),
                cfg).mean())))
    torch.cuda.synchronize()
    launches = (vrl_sum_hetero.launches, vrl_r_hetero.launches,
                vrl_sum_hetero_clustered.launches)
    check(launches[0] >= 1, "the band check's vrl_sum_hetero launches")
    ratio = np.mean([m[0] for m in means]) / np.mean([m[1] for m in means])
    check(C2_BAND[0] < ratio < C2_BAND[1],
          f"config-4 clustered / unclustered image mean {ratio} ({means})")
    reps = (info_m.slice_weights > 0).sum(axis=1)
    print(f"[16 main path on {card}] render_alvrl, config 4: launches over 3 "
          f"passes and their unclustered renders vrl_sum_hetero {launches[0]}"
          f" vrl_r_hetero {launches[1]} vrl_sum_hetero_clustered "
          f"{launches[2]}; {int(vrls_m.valid.sum())} valid VRLs, particle "
          f"count {float(vrls_m.particle_count):g}; representatives per slice"
          f" mean {reps.mean():.2f} max {reps.max()}, fall-back pixels "
          f"{int((info_m.pixel_to_slice < 0).sum())}; image mean "
          f"{float(img.mean()):.6f}; clustered / unclustered mean over 3 "
          f"seeds {ratio:.4f} (" + ", ".join(f"{a:.5f}/{b:.5f}"
                                             for a, b in means) + ")",
          flush=True)

    # 17. a warm pass per stage, each kernel alone, the plain versions
    lib_block = vsc.ray_block(True)  # kernel 4's rays per tile

    def staged(g):
        t = {}

        def stage(name, fn):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            t[name] = (time.perf_counter() - t0) * 1e3
            return out

        v = stage("trace (Woodcock) + compact", lambda: vrl.compact(
            tracer.trace(scene, g, params.num_particles, tcfg),
            params.vrl_target_num, slots_per_particle=C4_DEPTH))
        r = stage("R stage", lambda: alvrl.build_R_device(
            scene, v, cfg, info, integrator.draw_seed(g)))
        r_host = stage("bf16 transfer", lambda: alvrl.transfer_R(*r))
        clusters = stage("host clustering", lambda: alvrl.slice_clusters(
            *r_host, params, info))
        tables = stage("table packing", lambda: alvrl.pack_tables(
            info, *clusters, dev))
        stage("grouping", lambda: group_by_slice(tables[0], lib_block))
        stage("clustered render", lambda: integrator.render_clustered_kernel(
            scene, v, *tables[:3], g, cfg,
            fallback=alvrl.fallback_table(tables[3], dev)))
        return t

    gen_t = torch.Generator().manual_seed(7)
    stages = {}
    for i in range(C4_STAGED):
        t_i = staged(gen_t)
        if i >= 2:
            for k, v in t_i.items():
                stages.setdefault(k, []).append(v)
    pass_ms = host_ms(lambda: alvrl.render_alvrl(
        scene, gen_t, params, cfg, tcfg, slice_info=info), 1, 4)
    grid_arg = (density, cfg.uv_tau_steps)
    tiles = [torch.as_tensor(a, device=dev) for a in group_by_slice(
        sop, lib_block)]
    c_out = torch.zeros((3, n_rays), device=dev)
    sum_ms = cuda_ms(lambda: vrl_sum_hetero(*packs, seed=seed, **kw), 1, 5)
    r_ms = cuda_ms_batched(lambda: vrl_r_hetero(*packs_r, seed=seed, **kw),
                           2, 5, 5)
    c_ms = cuda_ms_batched(lambda: vsc._launch(
        vsc._library(), *packs[:4], *tiles, tv, tw, None, seed, 2, 2, True,
        scene.medium.phase_kind, c_out, grid_arg), 2, 5, 5)
    check(torch.equal(c_out, vrl_sum_hetero_clustered(
        *packs, sop, tv, tw, seed=seed, **kw)), "the bare grid launch is the "
        "wrapper's")
    with plain_chunk(C4_PLAIN_CHUNK):
        u = philox_uniforms(seed, n_rays, n_vrls, 6, device=dev)
        sum_plain_ms = cuda_ms(lambda: vrl_sum_hetero_reference(
            *packs, u, **kw), 0, 1)
        with SweepCount(*pair_masks(packs[0], packs[1])) as s_sweep:
            vrl_sum_hetero_reference(*packs, u, **kw)
        del u
        r_plain_ms = cuda_ms(lambda: vrl_r_hetero_reference(
            *packs_r, u_r_philox, **kw), 1, 3)
        with SweepCount(*pair_masks(packs_r[0], packs_r[1])) as r_sweep:
            vrl_r_hetero_reference(*packs_r, u_r_philox, **kw)
        u = philox_table_uniforms(seed, sop, tv, 6)
        c_plain_ms = cuda_ms(lambda: vrl_sum_hetero_clustered_reference(
            *packs, sop, tv, tw, u, **kw), 0, 1)
        with SweepCount(table_pair_ok(packs[0], packs[1], sop, tv, tw),
                        pair_masks(*packs[:2])[1],
                        reads=(packs[3], packs[4], cfg.uv_tau_steps)) as c_sweep:
            vrl_sum_hetero_clustered_reference(*packs, sop, tv, tw, u, **kw)
        del u
    uv = cfg.uv_tau_steps
    r_ops = kernel_ops("vrl_r", r_sweep, True, True, uv)
    c_ops = kernel_ops("vrl_sum_clustered", c_sweep, True, True, uv)
    r_bytes = nbytes(*packs_r) + 2 * n_rep * n_vrls * 4
    c_bytes = nbytes(*packs, tv, tw, *tiles) + 3 * n_rays * 4
    bounds = {
        "sum": bound(kernel_ops("vrl_sum", s_sweep, True, True, uv),
                     nbytes(*packs) + 3 * n_rays * 4),
        "r": bound(plane_ops(r_ops, r_sweep, r_counts), r_bytes),
        "clustered": bound(plane_ops(c_ops, c_sweep, c_counts), c_bytes)}
    wald_bounds = {"r": bound(r_ops, r_bytes)[0],
                   "clustered": bound(c_ops, c_bytes)[0]}

    def skips(counts):
        seg = max(counts["segments"], 1)
        return (f"{counts['skipped'] / seg:.3f} of "
                f"{counts['considered'] / seg:.3f} Wald tests a segment "
                "skipped")
    (s_med, s_spread), (r_med, r_spread), (c_med, c_spread), \
        (sp_med, _), (rp_med, _), (cp_med, _), (p_med, p_spread) = map(
            summary, (sum_ms, r_ms, c_ms, sum_plain_ms, r_plain_ms,
                      c_plain_ms, pass_ms))
    print(f"[17 timing on {card}] warm config-4 pass (render_alvrl, host "
          f"clock) {p_med:.3f} ms (spread {p_spread:.1%}); stages, median of"
          " 6 (spread): " + " | ".join(
              f"{k} {statistics.median(v):.3f} ms ({summary(v)[1]:.1%})"
              for k, v in stages.items())
          + f" | alone (CUDA events), plain on the same inputs: "
          f"vrl_sum_hetero (B={n_rays}) {s_med:.3f} ms (before its "
          f"redesign {EARLIER_MS['vrl_sum_hetero']} ms; spread "
          f"{s_spread:.1%}, {s_sweep}, bound {bounds['sum'][0]:.4f} ms by "
          f"{bounds['sum'][1]}), plain {sp_med:.1f} ms; vrl_r_hetero "
          f"{r_med:.4f} ms (before its redesign "
          f"{EARLIER_MS['vrl_r_hetero']} ms; spread {r_spread:.1%}, "
          f"{r_sweep}, {skips(r_counts)}, bound {bounds['r'][0]:.4f} ms by "
          f"{bounds['r'][1]} on the counted skips, {wald_bounds['r']:.4f} "
          f"ms with a Wald test per swept triangle), plain {rp_med:.1f} "
          f"ms; vrl_sum_hetero_clustered {c_med:.4f} ms (before its "
          f"redesign {EARLIER_MS['vrl_sum_hetero_clustered']} ms; spread "
          f"{c_spread:.1%}, {len(tiles[1])} blocks, {c_sweep}, "
          f"{skips(c_counts)}, bound {bounds['clustered'][0]:.4f} ms by "
          f"{bounds['clustered'][1]} on the counted skips, "
          f"{wald_bounds['clustered']:.4f} ms with a Wald test per swept "
          f"triangle), plain {cp_med:.1f} ms", flush=True)

    # 18. where the config-4 pass's device time goes
    prof = profile_device(lambda: alvrl.render_alvrl(
        scene, gen_t, params, cfg, tcfg, slice_info=info), 1, 3)
    if prof is None:
        print("[18 profile] the profiler saw no device operation: not "
              "measured", flush=True)
    else:
        span, busy, n_ops, by_name = prof
        mine = {k: sum(v for n, v in by_name.items() if k + "<" in n)
                for k in ("vrl_r_kernel", "vrl_sum_clustered_kernel")}
        top = sorted(((v, k) for k, v in by_name.items()
                      if not any(m + "<" in k for m in mine)),
                     reverse=True)[:4]
        print(f"[18 profile on {card}] per traced config-4 pass: device span "
              f"{span:.3f} ms, busy {busy:.3f} ms, idle share "
              f"{1 - busy / span:.1%}, {n_ops:g} device ops; "
              + ", ".join(f"{k} {v:.4f} ms ({v / busy:.1%} of busy)"
                          for k, v in mine.items()) + "; next: "
              + " | ".join(f"{v:.3f} ms {k[:60]}" for v, k in top),
              flush=True)

    def entry(name, src, line, n, err, ms, plain_ms, b):
        return {"name": name, "route": "cuda",
                "source": f"alvrl_tpu_torch/csrc/{src}",
                "replaces": f"alvrl_tpu/ops/vrl_pallas.py:{line}",
                "launches": n, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
                "library_ms": None}

    return [entry("vrl_sum_hetero", "vrl_sum.cu", 863, launches[0],
                  errs["sum"], s_med, sp_med, bounds["sum"]),
            entry("vrl_r_hetero", "vrl_r.cu", 1082, launches[1], errs["r"],
                  r_med, rp_med, bounds["r"]),
            entry("vrl_sum_hetero_clustered", "vrl_sum_clustered.cu", 937,
                  launches[2], errs["clustered"], c_med, cp_med,
                  bounds["clustered"])], dict(
        scene=scene, vrls=vrls, packs=packs, seed=seed, sweep=s_sweep,
        sop=sop, tv=tv, tw=tw, cinfo=cinfo, idx=idx, c_sweep=c_sweep,
        c_fwd_ms=c_med, info=info, params=params, tcfg=tcfg)


# phase 19's cases: phase 15's, and a zero VRL power channel with a zero
# albedo (so sigma_s_color) channel (ROADMAP C7)
C4_BWD_CASES = C4_CASES + [("zero_channels", "philox", True, 0)]
# d_density is summed by atomics in an order that varies between runs: a
# repeat agrees per voxel to float32 rounding of its sum, bounded here by
# this share of the largest |d_density|. Each voxel's sum has up to ~1e5
# terms at phase 19's shapes, of both signs (the density factors'
# cotangents are positive, the optical depths' negative), so its rounding
# scales with the sum of their magnitudes, which can exceed the sum:
# sqrt(1e5) * 2^-24 ~ 2e-5 of that, times the cancellation
DENSITY_REPEAT = 1e-4
VOXEL_FLOOR = 1e-3  # voxels compared: |grad| above this share of the largest
GRID_LIVE = [0, 1, 2, 3, 4, 5, 6, 7, pk.GRID_MED_LEN - 1]  # d_par's entries
C4_START = dict(albedo=0.8, density=1.25)  # phase 20's start: the preset x


def grid_bwd_check(out, ref, ref64, kind, vrl_ref=None):
    """(bars of d_power, d_tau, d_eod, d_vod and d_density's voxels, the
    largest relative d_par error of the kernel and of the plain version
    in float32 against it in float64) of the grid backward kernel
    against the plain backward; raises if a bar is missed (d_par: as
    bwd_check, or with ref64 None to PAR_RTOL alone, the second error
    then 0). With vrl_ref (the plain backward in float64), the per-VRL
    sums d_power and d_vod are held against it instead (ROADMAP C12)."""
    refs = list(ref[:5])
    if vrl_ref is not None:
        refs[0], refs[4] = vrl_ref[0], vrl_ref[4]
    bars = [homog_bar(o.T, r.T, channels=o.shape[0])
            for o, r in zip(out[:5], refs) if o.dim() == 2]
    d, r = out[5].reshape(-1), ref[5].reshape(-1)
    nz = r.abs() > VOXEL_FLOOR * float(r.abs().max())
    check(int(nz.sum()) > 1000, f"d_density: {int(nz.sum())} voxels")
    bars.append(homog_bar(d[nz][:, None], r[nz][:, None], channels=1))
    for median, share in bars:
        check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
              f"grid backward median {median}, share {share}")
    check(float(out[1][8:-1].abs().sum()) == 0.0, "d_par's box entries 0")
    par_rel = plain_rel = 0.0
    for i in GRID_LIVE:
        d, r = float(out[1][i]), float(ref[1][i])
        if r == 0.0:  # a zero factor in every term; Rayleigh's d g
            check(d == 0.0, f"d_par[{i}] {d}, plain 0")
            continue
        par_rel = max(par_rel, abs(d - r) / abs(r))
        if ref64 is None:
            check(abs(d - r) <= PAR_RTOL * abs(r), f"d_par[{i}] {d}, plain {r}")
            continue
        r64 = float(ref64[1][i])
        plain_rel = max(plain_rel, abs(r - r64) / abs(r64))
        check(abs(d - r) <= max(PAR_RTOL * abs(r), abs(r - r64)),
              f"d_par[{i}] {d}, plain {r}, plain in float64 {r64}")
    if kind == 1:
        check(float(out[1][6]) == 0.0, "Rayleigh d g is 0")
    return bars, (par_rel, plain_rel)


def config4_grad(dev, card, cfg, c4):
    """Phases 19-22, the gradient path of config 4 (the grid VJP, a
    full-width gradient step, the density-recovery trainer); returns the
    kernels line's entry of vrl_sum_hetero_bwd."""
    scene, vrls, packs, seed = c4["scene"], c4["vrls"], c4["packs"], c4["seed"]
    kw = dict(uv_steps=cfg.uv_tau_steps)
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    b0, b1 = C4_ROWS[0] * C4_SIZE, C4_ROWS[1] * C4_SIZE
    sub = (packs[0][:, b0:b1].contiguous(), *packs[1:])
    n_sub = b1 - b0
    gen = torch.Generator(device=dev).manual_seed(19)

    # 19. the grid backward kernel against the plain backward
    u_inj = torch.rand((n_sub, n_vrls, 6), generator=gen, device=dev)
    u_philox = philox_uniforms(seed, n_sub, n_vrls, 6, device=dev)
    gbar = torch.as_tensor(np.random.default_rng(19).uniform(
        0.5, 1.5, (3, n_sub)).astype(np.float32), device=dev)
    zero = list(sub)
    zero[1] = zero[1].clone()
    zero[1][pk.VP + 1] = 0.0  # a VRL power channel at 0
    zero[3] = zero[3].clone()
    zero[3][5] = 0.0          # sigma_s_color[2]: an albedo channel at 0
    err, results, t0 = 0.0, [], time.perf_counter()
    with plain_chunk(C4_PLAIN_CHUNK):
        for name, mode, short, kind in C4_BWD_CASES:
            p = zero if name == "zero_channels" else sub
            case = dict(short_vrls=short, phase_kind=kind, **kw)
            u = u_philox if mode == "philox" else u_inj
            kern = dict(seed=seed, uniforms=None if mode == "philox" else u)
            out = bwd.vrl_sum_hetero_bwd(*p, gbar, **kern, **case)
            again = bwd.vrl_sum_hetero_bwd(*p, gbar, **kern, **case)
            ref, ref64 = (bwd.vrl_sum_hetero_bwd_reference(
                *(x.to(dt) for x in (*p, gbar, u)), **case)
                for dt in (torch.float32, torch.float64))
            torch.cuda.synchronize()
            tag = f"{name}/{mode}"
            check(all(torch.equal(a, b) for a, b in zip(out[:5], again[:5])),
                  f"grid backward {tag}: a repeat is not bit-identical")
            rep = float((out[5] - again[5]).abs().max())
            check(rep <= DENSITY_REPEAT * float(out[5].abs().max()),
                  f"grid backward {tag}: d_density repeat differs by {rep}")
            check(all(bool(torch.isfinite(o).all()) for o in out),
                  f"grid backward {tag} finite")
            bars, (par_rel, plain_rel) = grid_bwd_check(out, ref, ref64, kind)
            if name == "zero_channels":
                check(float(out[0][1].abs().max()) > 0.0
                      and float(out[1][5]) != 0.0,
                      "zero channels: d power[1] and d sigma_s[2] are not 0")
            err = max(err, *(float((o - r).abs().max())
                             for o, r in zip(out, ref)))
            results.append(f"{tag}: " + ", ".join(
                f"{k} {m:.2e}/{sh:.4f}" for k, (m, sh) in zip(
                    ("d_power", "d_tau", "d_eod", "d_vod", "d_density"), bars))
                + f", d_par rel {par_rel:.2e} (plain f32 vs f64 "
                f"{plain_rel:.2e}), d_density repeat {rep:.3g} of max "
                f"{float(out[5].abs().max()):.4g}")
    print(f"[19 grid backward kernel vs plain on {card}, config 4: rows "
          f"{C4_ROWS[0]}-{C4_ROWS[1] - 1} ({n_sub} rays) x {n_vrls} VRLs, "
          f"density {tuple(packs[4].shape)}; median/share per item; "
          f"{time.perf_counter() - t0:.1f} s] " + " | ".join(results),
          flush=True)
    del u_inj, zero

    # 20. the gradient path at full config 4, through the entry point
    t0 = time.perf_counter()
    target = integrator.render_with_vrls_kernel(
        scene, vrls, torch.Generator().manual_seed(2000), cfg)
    med0 = scene.medium
    start = dict(density=med0.density * C4_START["density"],
                 sigma_t_color=med0.sigma_t_color,
                 albedo=med0.albedo * C4_START["albedo"], g=med0.g,
                 scale=med0.scale)

    def grid_loss(p, render):
        med = replace(gmed.with_density(med0, p["density"]),
                      sigma_t_color=p["sigma_t_color"], albedo=p["albedo"],
                      g=p["g"], scale=p["scale"])
        img = render(replace(scene, medium=med), vrls,
                     torch.Generator().manual_seed(3), cfg)
        return ((img.double() - target.double()) ** 2).mean()

    def grad_step():
        p = {k: v.clone().requires_grad_() for k, v in start.items()}
        loss = grid_loss(p, integrator.render_with_vrls_kernel_diff)
        return loss, dict(zip(p, torch.autograd.grad(loss, list(p.values()))))

    vrl_sum_hetero.launches = bwd.vrl_sum_hetero_bwd.launches = 0
    loss, grads = grad_step()
    torch.cuda.synchronize()
    step_launches = (vrl_sum_hetero.launches, bwd.vrl_sum_hetero_bwd.launches)
    check(min(step_launches) >= 1,
          f"the grid gradient step's launches {step_launches}")
    loss = float(loss.detach())
    check(math.isfinite(loss) and loss > 0.0, f"loss {loss}")
    for k, g in grads.items():
        check(bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0.0,
              f"gradient {k}")
    n_vox = int((grads["density"] != 0.0).sum())
    top = [int(i) for i in grads["density"].reshape(-1).abs().argsort(
        descending=True)[:2]]

    def shifted(name, idx, eps):
        q = {k: v.clone() for k, v in start.items()}
        with torch.no_grad():
            q[name].reshape(-1)[0 if idx is None else idx] += eps
            return float(grid_loss(q, integrator.render_with_vrls_kernel))

    fd_results = []
    for name, idx, eps in [("sigma_t_color", 0, 2e-3), ("albedo", 1, 2e-3),
                           ("g", None, 2e-3), ("scale", None, 2e-3),
                           *(("density", i, 2e-2) for i in top)]:
        fd = (shifted(name, idx, eps) - shifted(name, idx, -eps)) / (2 * eps)
        a = float(grads[name].reshape(-1)[0 if idx is None else idx])
        check(fd != 0.0 and abs(a - fd) <= FD_TOL * abs(fd),
              f"FD {name}[{idx}]: {a} vs {fd}")
        fd_results.append(f"{name}{'' if idx is None else [idx]} ad {a:.6g} "
                          f"fd {fd:.6g}")
    print(f"[20 grid gradient path on {card}] render_with_vrls_kernel_diff, "
          f"config 4 ({C4_SIZE}x{C4_SIZE}, {C4_GRID}^3, {n_vrls} VRLs) from "
          f"albedo x {C4_START['albedo']}, density x {C4_START['density']}: "
          f"launches vrl_sum_hetero {step_launches[0]} vrl_sum_hetero_bwd "
          f"{step_launches[1]}, loss {loss:.6g}, {n_vox} of "
          f"{grads['density'].numel()} voxels with a non-zero gradient; "
          + ", ".join(f"d{k} {grads[k].flatten().tolist()}" for k in
                      ("sigma_t_color", "albedo", "g", "scale"))
          + " | same-seed FD: " + ", ".join(fd_results)
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    # 21. the trainer: the density recovery at its defaults, 16 steps
    t0 = time.perf_counter()
    vrl_sum_hetero.launches = bwd.vrl_sum_hetero_bwd.launches = 0
    state = rd.setup(device=dev)
    setup_s = time.perf_counter() - t0
    steps = [rd.density_step(state, i) for i in range(16)]
    torch.cuda.synchronize()
    losses = [o["loss"] for o in steps]
    check(all(math.isfinite(x) for x in losses)
          and bool(torch.isfinite(state.theta).all()), f"losses {losses}")
    check(losses[15] < losses[0], f"trainer losses {losses}")
    check(min(vrl_sum_hetero.launches, bwd.vrl_sum_hetero_bwd.launches)
          >= 16 * len(state.scenes), "the trainer's grid launches")
    truth = state.medium.density
    print(f"[21 trainer on {card}] recover_density (64x64, 16^3, 4 views, "
          f"{rd.N_VRLS} VRLs of {rd.N_PARTICLES} particles, retrace every "
          f"{rd.RETRACE_EVERY}; setup with targets {setup_s:.1f} s): launches "
          f"vrl_sum_hetero {vrl_sum_hetero.launches} vrl_sum_hetero_bwd "
          f"{bwd.vrl_sum_hetero_bwd.launches}; rel_err "
          f"{rd.rel_err(state.density, truth):.4f} corr "
          f"{rd.corr(state.density, truth):.3f} after 16; per step loss "
          "(ms trace/forward/backward/adam): " + " | ".join(
              f"{i} {o['loss']:.5g} ("
              + "/".join(f"{v:.1f}" for v in o["ms"].values()) + ")"
              for i, o in enumerate(steps)), flush=True)
    del state

    # 22. timing: the step and its parts, the kernel alone, a profile
    step_ms = host_ms(grad_step, 2, 5)
    scene_s = replace(scene, medium=replace(
        gmed.with_density(med0, start["density"]), albedo=start["albedo"]))
    packs_s = integrator.pack_frame(scene_s, vrls)[3]
    gbar_s = torch.as_tensor(np.random.default_rng(22).uniform(
        0.5, 1.5, (3, n_rays)).astype(np.float32), device=dev)
    pack_ms = host_ms(lambda: integrator.pack_frame(scene_s, vrls), 2, 5)
    fwd_s_ms = cuda_ms(lambda: vrl_sum_hetero(*packs_s, seed=seed, **kw), 1, 3)
    bwd_s_ms = cuda_ms(lambda: bwd.vrl_sum_hetero_bwd(
        *packs_s, gbar_s, seed=seed, **kw), 1, 3)
    # the kernel alone on phase 17's inputs (whose samples c4["sweep"]
    # counted), against the forward there; its output at this full shape
    # held against the timed plain backward's, and a repeat
    gbar_f = torch.as_tensor(np.random.default_rng(23).uniform(
        0.5, 1.5, (3, n_rays)).astype(np.float32), device=dev)
    fwd_ms = cuda_ms(lambda: vrl_sum_hetero(*packs, seed=seed, **kw), 1, 5)
    bwd_ms = cuda_ms(lambda: bwd.vrl_sum_hetero_bwd(
        *packs, gbar_f, seed=seed, **kw), 1, 5)
    full = [bwd.vrl_sum_hetero_bwd(*packs, gbar_f, seed=seed, **kw)
            for _ in range(2)]
    with plain_chunk(C4_PLAIN_CHUNK):
        sub_plain_ms = cuda_ms(lambda: bwd.vrl_sum_hetero_bwd_reference(
            *sub, gbar, u_philox, **kw), 0, 1)
        sub_ms = cuda_ms(lambda: bwd.vrl_sum_hetero_bwd(
            *sub, gbar, seed=seed, **kw), 1, 5)
        u = philox_uniforms(seed, n_rays, n_vrls, 6, device=dev)

        def plain_full():
            full.append(bwd.vrl_sum_hetero_bwd_reference(
                *packs, gbar_f, u, **kw))
        plain_ms = cuda_ms(plain_full, 0, 1)
        del u
    out, again, ref = full
    check(all(torch.equal(a, b) for a, b in zip(out[:5], again[:5])),
          "grid backward at full shape: a repeat is not bit-identical")
    full_rep = float((out[5] - again[5]).abs().max())
    check(full_rep <= DENSITY_REPEAT * float(out[5].abs().max()),
          f"grid backward at full shape: d_density repeat differs by "
          f"{full_rep}")
    check(all(bool(torch.isfinite(o).all()) for o in out),
          "grid backward at full shape finite")
    full_err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
    err = max(err, full_err)
    # ROADMAP C12: the kernel against the plain backward in float32 and
    # float64 on the eye rays of image rows 128-159, 128-255 and the full
    # frame (the Philox stream of each block's own ray indices, gbar_f's
    # columns): the median errors of the per-VRL sums (d_power, d_vod) as
    # the rays in each sum grow, and which side moves from the float64
    # value. At the full frame the float32 plain version's own error in
    # d_vod is above the bar, so the kernel's per-VRL sums are held
    # against the float64 plain version there (grid_bwd_check's vrl_ref)
    growth, full64 = {}, None
    with plain_chunk(C4_PLAIN_CHUNK):
        for row_end in (C4_ROWS[1], 2 * C4_ROWS[0], C4_SIZE):
            g0 = 0 if row_end == C4_SIZE else C4_ROWS[0] * C4_SIZE
            g1 = row_end * C4_SIZE
            p_g = tuple(x.contiguous() for x in (packs[0][:, g0:g1],
                                                 *packs[1:], gbar_f[:, g0:g1]))
            u = philox_uniforms(seed, g1 - g0, n_vrls, 6, device=dev)
            if g1 - g0 == n_rays:
                o, r = out, ref
            else:
                o = bwd.vrl_sum_hetero_bwd(*p_g, seed=seed, **kw)
                r = bwd.vrl_sum_hetero_bwd_reference(*p_g, u, **kw)
            r64 = bwd.vrl_sum_hetero_bwd_reference(
                *(x.double() for x in (*p_g, u)), **kw)
            del u
            growth[g1 - g0] = [[homog_bar(a[i].T, b[i].T,
                                          channels=a[i].shape[0])[0]
                                for a, b in ((o, r), (o, r64), (r, r64))]
                               for i in (0, 4)]
            if g1 - g0 == n_rays:
                full64 = r64
            del o, r, r64
    full_bars, (full_par_rel, _) = grid_bwd_check(out, ref, None, 0,
                                                  vrl_ref=full64)
    del full, out, again, ref, full64
    sweep, uv = c4["sweep"], cfg.uv_tau_steps
    n_scatter = sweep.open[0] * (2 + uv) + sweep.open[1] * (1 + uv)
    rows = 3 + pk.NQ + 1
    bwd_bound = bound(
        kernel_ops("vrl_sum_hetero_bwd", sweep, True, True, uv),
        nbytes(*packs, gbar_f) + 4 * (rows * (n_rays + n_vrls)
                                      + pk.GRID_MED_LEN + packs[4].numel()
                                      + n_scatter))
    (st_med, st_spread), (pk_med, _), (fs_med, _), (bs_med, _), \
        (f_med, _), (b_med, b_spread), (sb_med, _), (sp_med, _), \
        (p_med, _) = map(summary, (step_ms, pack_ms, fwd_s_ms, bwd_s_ms,
                                   fwd_ms, bwd_ms, sub_ms, sub_plain_ms,
                                   plain_ms))
    print(f"[22 grid gradient timing on {card}] step (host clock, median of 5"
          f" after 2) {st_med:.3f} ms (spread {st_spread:.1%}); alone on its "
          f"inputs: packs {pk_med:.3f} ms, forward kernel {fs_med:.3f} ms, "
          f"backward kernel {bs_med:.3f} ms, rest (autograd of the packs and "
          f"the upsample, film, loss) {st_med - pk_med - fs_med - bs_med:.3f}"
          f" ms | on phase 17's inputs (CUDA events): backward kernel "
          f"{b_med:.3f} ms (before its redesign "
          f"{EARLIER_MS['vrl_sum_hetero_bwd']} ms; spread {b_spread:.1%}) "
          f"against the forward {f_med:.3f} ms ({b_med / f_med:.2f}x; before "
          f"{EARLIER_MS['vrl_sum_hetero']} ms); bound {bwd_bound[0]:.4f} ms"
          f" by {bwd_bound[1]} ({sweep}, {n_scatter} density scatters); "
          f"plain backward {p_med:.1f} ms | on phase 19's subset: kernel "
          f"{sb_med:.3f} ms, plain {sp_med:.1f} ms | the kernel vs the plain "
          f"backward at full shape ({n_rays} rays x {n_vrls} VRLs; d_power "
          "and d_vod against it in float64, the rest in float32; median/"
          "share per item): " + ", ".join(
              f"{k} {m:.2e}/{sh:.4f}" for k, (m, sh) in zip(
                  ("d_power", "d_tau", "d_eod", "d_vod", "d_density"),
                  full_bars))
          + f", d_par rel {full_par_rel:.2e}, max abs err {full_err:.4g}, "
          f"d_density repeat {full_rep:.3g}", flush=True)
    print(f"[22 C12 on {card}] grid backward, median relative error per "
          f"VRL of d_power and d_vod by eye rays (x {n_vrls} VRLs), kernel vs "
          "plain float32 / kernel vs plain float64 / plain float32 vs "
          "float64: " + " | ".join(
              f"{b} rays: d_power " + "/".join(f"{m:.3e}" for m in pw)
              + ", d_vod " + "/".join(f"{m:.3e}" for m in vod)
              for b, (pw, vod) in growth.items()), flush=True)
    c12_now = growth[n_rays]  # (d_power, d_vod), each vs float32, float64
    print(f"[22 C12 variants on {card}] vs the plain backward in float64 at "
          f"full shape, median d_power / d_vod: this run's kernel (float32) "
          f"{c12_now[0][1]:.3e} / {c12_now[1][1]:.3e}, {b_med:.3f} ms | the "
          "two repairs as measured and left out (ROADMAP C12): " + " | ".join(
              f"{k} {pw:.3e} / {vod:.3e}, {ms:.2f} ms"
              for k, (pw, vod, ms) in C12_REPAIRS.items()), flush=True)
    prof = profile_device(grad_step, 1, 3)
    if prof is None:
        print("[22 profile] the profiler saw no device operation: not "
              "measured", flush=True)
    else:
        span, busy, n_ops, by_name = prof
        mine = {k: sum(v for n, v in by_name.items() if k + "<" in n)
                for k in ("vrl_sum_kernel", "vrl_sum_bwd_kernel")}
        top = sorted(((v, k) for k, v in by_name.items()
                      if not any(m + "<" in k for m in mine)),
                     reverse=True)[:4]
        print(f"[22 profile on {card}] per traced grid gradient step: device "
              f"span {span:.3f} ms, busy {busy:.3f} ms, idle share "
              f"{1 - busy / span:.1%}, {n_ops:g} device ops; "
              + ", ".join(f"{k} {v:.3f} ms ({v / busy:.1%} of busy)"
                          for k, v in mine.items()) + "; next: "
              + " | ".join(f"{v:.3f} ms {k[:60]}" for v, k in top),
              flush=True)
    return {"name": "vrl_sum_hetero_bwd", "route": "cuda",
            "source": "alvrl_tpu_torch/csrc/vrl_sum_bwd.cu",
            "replaces": "alvrl_tpu/ops/vrl_pallas_bwd.py:924",
            "launches": step_launches[1], "max_abs_err": err, "ms": b_med,
            "plain_ms": p_med, "bound_ms": bwd_bound[0],
            "bound_by": bwd_bound[1], "library_ms": None}


def live(out, ref, *more):
    """The columns of (rows, n) results where some row of ref is not 0:
    (out, ref[, more...]) cut to them, after checking that out is exactly
    0 on the others. The clustered VJP's per-VRL and per-column outputs
    are 0 in both versions for VRLs no compared ray reaches and for the
    tables' padding, and such items would pull a median to 0."""
    keep = (ref != 0).any(dim=0)
    for r in more:
        keep |= (r != 0).any(dim=0)
    check(not out[:, ~keep].any(), "an output outside the live items")
    check(int(keep.sum()) > 20, f"{int(keep.sum())} live items")
    return out[:, keep], ref[:, keep], *(r[:, keep] for r in more)


def weights_bar(d_w, ref):
    """The homogeneous bar of d_weights against ref, per entry, over the
    live entries; raises."""
    bar = homog_bar(*(t.reshape(-1, 1) for t in live(
        d_w.reshape(1, -1), ref.reshape(1, -1))), channels=1)
    check(bar[0] < HOMOG_MEDIAN and bar[1] < HOMOG_SHARE,
          f"d_weights median {bar[0]}, share {bar[1]}")
    return bar


def clustered_bwd_check(out, ref, ref64, kind):
    """bwd_check of the clustered backward's (d_power over the live VRLs,
    d_par, d_tau) and its d_weights at the homogeneous bar; returns
    bwd_check's results with the d_weights bar and the largest absolute
    error."""
    d_pw, r_pw = live(out[0], ref[0])
    bars, pars, err = bwd_check((d_pw, out[1], out[2]), (r_pw, *ref[1:3]),
                                ref64[:3], kind)
    w_bar = weights_bar(out[3], ref[3])
    return (*bars, w_bar), pars, max(err, float((out[3] - ref[3]).abs().max()))


def fmt_bars(names, bars):
    return ", ".join(f"{k} {m:.2e}/{sh:.4f}" for k, (m, sh) in zip(names, bars))


def clustered_grad(dev, card, cfg, c2, c4):
    """Phases 23-26, the clustered gradient path (the clustered VJP
    kernels against their plain versions, a clustered gradient step at
    full config 2 and config 4, timing); returns the kernels line's
    entries of vrl_sum_clustered_bwd and vrl_sum_hetero_clustered_bwd."""
    # 23. the clustered backward kernel against the plain backward at
    # config-2 shapes: all eye rays on phase 12's tables
    t0 = time.perf_counter()
    scene2, vrls2, seed2 = c2["scene"], c2["vrls"], c2["seed"]
    sop2, tv2, tw2 = c2["sop"], c2["tv"], c2["tw"]
    n_rays2, n_cols2, n_vrls2 = WIDTH * HEIGHT, tv2.shape[1], vrls2.capacity
    rng = np.random.default_rng(23)
    gbar2 = torch.as_tensor(rng.uniform(0.5, 1.5, (3, n_rays2)).astype(
        np.float32), device=dev)
    u_inj = torch.as_tensor(rng.random((n_rays2, n_cols2, 6),
                                       dtype=np.float32), device=dev)
    u_philox = philox_table_uniforms(seed2, sop2, tv2, 6)
    cases = [(name, mode, integrator.pack_frame(sc, vrls2)[3], MEDIA[name][1])
             for name, sc in media_scenes(dev).items()
             for mode in ("injected", "philox", "long")]
    zero = list(cases[3][2])       # hg_g06
    zero[1] = zero[1].clone()
    zero[1][pk.VP + 1] = 0.0       # a VRL power channel at 0
    zero[3] = zero[3].clone()
    zero[3][2] -= zero[3][5]       # sigma_t = sigma_a in channel 2,
    zero[3][5] = 0.0               # where sigma_s is 0
    cases.append(("zero_channels", "philox", zero, 0))
    names = ("d_power", "d_tau", "d_weights")
    err10, results = 0.0, []
    with plain_chunk(C4_PLAIN_CHUNK):
        for name, mode, packs, kind in cases:
            short = mode != "long"
            u = u_philox if mode == "philox" else u_inj
            kw = dict(seed=seed2, uniforms=None if mode == "philox" else u,
                      short_vrls=short, phase_kind=kind)
            out = cb.vrl_sum_clustered_bwd(*packs, sop2, tv2, tw2, gbar2, **kw)
            again = cb.vrl_sum_clustered_bwd(*packs, sop2, tv2, tw2, gbar2,
                                             **kw)
            ref, ref64 = (cb.vrl_sum_clustered_bwd_reference(
                *(x.to(dt) for x in packs), sop2, tv2, tw2.to(dt),
                gbar2.to(dt), u.to(dt), short_vrls=short, phase_kind=kind)
                for dt in (torch.float32, torch.float64))
            torch.cuda.synchronize()
            tag = f"{name}/{mode}"
            check(all(torch.equal(a, b) for a, b in zip(out, again)),
                  f"clustered backward {tag}: a repeat is not bit-identical")
            check(all(bool(torch.isfinite(o).all()) for o in out),
                  f"clustered backward {tag} finite")
            bars, (par_rel, plain_rel), e = clustered_bwd_check(
                out, ref, ref64, kind)
            if name == "zero_channels":
                check(float(out[0][1].abs().max()) > 0.0
                      and float(out[1][5]) != 0.0,
                      "zero channels: d power[1] and d sigma_s[2] are not 0")
            err10 = max(err10, e)
            results.append(f"{tag}: {fmt_bars(names, bars)}, d_par rel "
                           f"{par_rel:.2e} (plain f32 vs f64 {plain_rel:.2e})")
        packs2 = c2["packs"]
        fb_rows = np.where(rng.random(n_rays2) < 0.05, 0, -1)
        fb_ids, fb_ws = alvrl.fallback_table(
            replace(c2["cinfo"], pixel_to_slice=fb_rows.astype(np.int32)), dev)
        fb = (fb_rows, fb_ids[None].contiguous(), fb_ws[None].contiguous())
        out = cb.vrl_sum_clustered_bwd(*packs2, *fb, gbar2, seed=seed2)
        u = philox_table_uniforms(seed2, fb_rows, fb[1], 6)
        ref, ref64 = (cb.vrl_sum_clustered_bwd_reference(
            *(x.to(dt) for x in packs2), fb_rows, fb[1], fb[2].to(dt),
            gbar2.to(dt), u.to(dt)) for dt in (torch.float32, torch.float64))
        bars, (par_rel, _), e = clustered_bwd_check(out, ref, ref64, 0)
        check(not out[2][:, torch.as_tensor(fb_rows < 0, device=dev)].any(),
              "fall-back launch: rays at row -1 get no d_tau")
        err10 = max(err10, e)
        results.append(f"fall-back launch ({fb[1].shape[1]} columns, "
                       f"{int((fb_rows >= 0).sum())} rays): "
                       f"{fmt_bars(names, bars)}, d_par rel {par_rel:.2e}")
    ids = torch.arange(n_vrls2, dtype=torch.int32, device=dev)[None]
    ident = cb.vrl_sum_clustered_bwd(*packs2, np.zeros(n_rays2, np.int64),
                                     ids, torch.ones((1, n_vrls2), device=dev),
                                     gbar2, seed=seed2)
    unc = bwd.vrl_sum_bwd(*packs2, gbar2, seed=seed2)
    id_bars = [homog_bar(o.T, r.T) for o, r in ((ident[0], unc[0]),
                                               (ident[2], unc[2]))]
    for median, share in id_bars:
        check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
              f"identity table vs vrl_sum_bwd: median {median}, share {share}")
    id_par = max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
                 for a, b in zip(ident[1][:7], unc[1][:7]))
    check(id_par < PAR_RTOL, f"identity table d_par vs vrl_sum_bwd {id_par}")
    id_w = weights_bar(ident[3][0], (packs2[1][pk.VP:pk.VP + 3]
                                     * ident[0]).sum(dim=0))
    results.append(f"identity table ({n_vrls2} columns) vs vrl_sum_bwd: "
                   f"{fmt_bars(('d_power', 'd_tau'), id_bars)}, d_par rel "
                   f"{id_par:.2e}; d_weights vs sum power * d_power "
                   f"{id_w[0]:.2e}/{id_w[1]:.4f}")
    print(f"[23 clustered backward kernel vs plain on {card}, config 2: B="
          f"{n_rays2} S={tv2.shape[0]} C={n_cols2} N={n_vrls2}; median/share "
          f"per item; repeats bit-identical; {time.perf_counter() - t0:.1f} s] "
          + " | ".join(results), flush=True)
    del u_inj, u_philox, cases, zero

    # 24. the grid clustered backward kernel at its full main-path shape
    # against the plain grid backward on phase 15's subset of whole
    # slices (gbar 0 on the other rays, so every output is the subset's)
    t0 = time.perf_counter()
    scene4, vrls4, packs4, seed4 = (c4[k] for k in ("scene", "vrls", "packs",
                                                    "seed"))
    sop4, tv4, tw4, idx = c4["sop"], c4["tv"], c4["tw"], c4["idx"]
    kw4 = dict(uv_steps=cfg.uv_tau_steps)
    n_rays4, n_cols4, n_vrls4 = packs4[0].shape[1], tv4.shape[1], vrls4.capacity
    idx_t = torch.as_tensor(idx, device=dev)
    rows_sub = sop4[idx]
    rng = np.random.default_rng(24)
    gbar_sub = torch.as_tensor(rng.uniform(0.5, 1.5, (3, len(idx))).astype(
        np.float32), device=dev)
    gbar4 = torch.zeros((3, n_rays4), device=dev)
    gbar4[:, idx_t] = gbar_sub
    gen = torch.Generator(device=dev).manual_seed(24)
    u_c = torch.rand((n_rays4, n_cols4, 6), generator=gen, device=dev)
    u_c_sub = philox_draws(seed4, idx_t[:, None], tv4[torch.as_tensor(
        rows_sub, device=dev).long()].long(), 6)
    zero = list(packs4)
    zero[1] = zero[1].clone()
    zero[1][pk.VP + 1] = 0.0  # a VRL power channel at 0
    zero[3] = zero[3].clone()
    zero[3][5] = 0.0          # sigma_s_color[2]: an albedo channel at 0
    names = ("d_power", "d_tau", "d_eod", "d_vod", "d_density")
    err11, results = 0.0, []
    outside = torch.ones(n_rays4, dtype=torch.bool, device=dev)
    outside[idx_t] = False
    with plain_chunk(C4_PLAIN_CHUNK):
        for name, mode, short, kind in C4_BWD_CASES:
            p = zero if name == "zero_channels" else packs4
            p_sub = (p[0][:, idx_t].contiguous(), *p[1:])
            case = dict(short_vrls=short, phase_kind=kind, **kw4)
            inj = mode != "philox"
            kern = dict(seed=seed4, uniforms=u_c if inj else None)
            out = cb.vrl_sum_hetero_clustered_bwd(*p, sop4, tv4, tw4, gbar4,
                                                  **kern, **case)
            again = cb.vrl_sum_hetero_clustered_bwd(*p, sop4, tv4, tw4, gbar4,
                                                    **kern, **case)
            u = u_c[idx_t] if inj else u_c_sub
            ref, ref64 = (cb.vrl_sum_hetero_clustered_bwd_reference(
                *(x.to(dt) for x in p_sub), rows_sub, tv4, tw4.to(dt),
                gbar_sub.to(dt), u.to(dt), **case)
                for dt in (torch.float32, torch.float64))
            torch.cuda.synchronize()
            tag = f"{name}/{mode}"
            check(all(torch.equal(out[i], again[i]) for i in (0, 1, 2, 3, 4, 6)),
                  f"grid clustered backward {tag}: a repeat is not "
                  "bit-identical")
            rep = float((out[5] - again[5]).abs().max())
            check(rep <= DENSITY_REPEAT * float(out[5].abs().max()),
                  f"grid clustered backward {tag}: d_density repeat {rep}")
            check(all(bool(torch.isfinite(o).all()) for o in out),
                  f"grid clustered backward {tag} finite")
            check(not out[2][:, outside].any() and not out[3][:, outside].any(),
                  f"grid clustered backward {tag}: rays outside the subset")
            # the VRLs of the subset's tables (d_power, d_vod)
            n_pw = out[0].shape[0]
            vrl_rows, ref_rows = live(torch.cat([out[0], out[4]]),
                                      torch.cat([ref[0], ref[4]]))
            on_sub = (vrl_rows[:n_pw], out[1], out[2][:, idx_t],
                      out[3][:, idx_t], vrl_rows[n_pw:], out[5])
            bars, (par_rel, plain_rel) = grid_bwd_check(
                on_sub, (ref_rows[:n_pw], *ref[1:4], ref_rows[n_pw:], ref[5]),
                ref64[:6], kind)
            w_bar = weights_bar(out[6], ref[6])
            if name == "zero_channels":
                check(float(out[0][1].abs().max()) > 0.0
                      and float(out[1][5]) != 0.0,
                      "zero channels: d power[1] and d sigma_s[2] are not 0")
            err11 = max(err11, *(float((o - r).abs().max()) for o, r in zip(
                (*on_sub, out[6]), (ref_rows[:n_pw], *ref[1:4],
                                    ref_rows[n_pw:], *ref[5:]))))
            results.append(f"{tag} ({vrl_rows.shape[1]} VRLs live): "
                           f"{fmt_bars(names, bars)}, d_weights "
                           f"{w_bar[0]:.2e}/{w_bar[1]:.4f}, d_par rel "
                           f"{par_rel:.2e} (plain f32 vs f64 {plain_rel:.2e}), "
                           f"d_density repeat {rep:.3g} of max "
                           f"{float(out[5].abs().max()):.4g}")
    del u_c, zero
    gbar4 = torch.as_tensor(rng.uniform(0.5, 1.5, (3, n_rays4)).astype(
        np.float32), device=dev)
    ident = cb.vrl_sum_hetero_clustered_bwd(
        *packs4, np.zeros(n_rays4, np.int64),
        torch.arange(n_vrls4, dtype=torch.int32, device=dev)[None],
        torch.ones((1, n_vrls4), device=dev), gbar4, seed=seed4, **kw4)
    unc = bwd.vrl_sum_hetero_bwd(*packs4, gbar4, seed=seed4, **kw4)
    id_bars, (id_par, _) = grid_bwd_check(ident[:6], unc, None, 0)
    id_w = weights_bar(ident[6][0], (packs4[1][pk.VP:pk.VP + 3]
                                     * ident[0]).sum(dim=0))
    del ident, unc
    print(f"[24 grid clustered backward kernel vs plain on {card}, config 4: "
          f"B={n_rays4} S={tv4.shape[0]} C={n_cols4} N={n_vrls4}, "
          f"{len(group_by_slice(sop4, 128)[1])} tiles; compared on the "
          f"{len(idx)} rays of slices {int(rows_sub.min())}-"
          f"{int(rows_sub.max())} (gbar 0 elsewhere); median/share per item; "
          f"{time.perf_counter() - t0:.1f} s] " + " | ".join(results)
          + f" | identity table ({n_vrls4} columns, all {n_rays4} rays) vs "
          f"vrl_sum_hetero_bwd: {fmt_bars(names, id_bars)}, d_par rel "
          f"{id_par:.2e}; d_weights vs sum power * d_power "
          f"{id_w[0]:.2e}/{id_w[1]:.4f}", flush=True)

    # 25. the main path: render_clustered_kernel_diff at full config 2 and
    # config 4 on one prepare_clustering pass's tables (phases 12, 15),
    # held fixed; L2 loss against a clustered render at the preset's
    # values on the same tables
    t0 = time.perf_counter()
    fb2 = alvrl.fallback_table(c2["cinfo"], dev)
    fb4 = alvrl.fallback_table(c4["cinfo"], dev)
    target2 = integrator.render_clustered_kernel(
        scene2, vrls2, sop2, tv2, tw2, torch.Generator().manual_seed(2500),
        cfg, fallback=fb2)
    target4 = integrator.render_clustered_kernel(
        scene4, vrls4, sop4, tv4, tw4, torch.Generator().manual_seed(2500),
        cfg, fallback=fb4)
    med2, med4 = scene2.medium, scene4.medium
    intensity0 = scene2.emitters.intensity
    start2 = dict(sigma_a=med2.sigma_a * 2, sigma_s=med2.sigma_s, g=med2.g,
                  intensity=intensity0, wscale=torch.tensor(1.0, device=dev))
    start4 = dict(density=med4.density * C4_START["density"],
                  sigma_t_color=med4.sigma_t_color,
                  albedo=med4.albedo * C4_START["albedo"], g=med4.g,
                  scale=med4.scale)

    def loss2(p, render):
        sc = replace(scene2, medium=replace(
            med2, sigma_a=p["sigma_a"], sigma_s=p["sigma_s"], g=p["g"]))
        vr = replace(vrls2, power=vrls2.power * (p["intensity"] / intensity0))
        img = render(sc, vr, sop2, tv2, tw2 * p["wscale"],
                     torch.Generator().manual_seed(3), cfg, fallback=fb2)
        return ((img.double() - target2.double()) ** 2).mean()

    def loss4(p, render):
        med = replace(gmed.with_density(med4, p["density"]),
                      sigma_t_color=p["sigma_t_color"], albedo=p["albedo"],
                      g=p["g"], scale=p["scale"])
        img = render(replace(scene4, medium=med), vrls4, sop4, tv4, tw4,
                     torch.Generator().manual_seed(3), cfg, fallback=fb4)
        return ((img.double() - target4.double()) ** 2).mean()

    def grad_step(loss, start):
        p = {k: v.clone().requires_grad_() for k, v in start.items()}
        value = loss(p, integrator.render_clustered_kernel_diff)
        return value, dict(zip(p, torch.autograd.grad(value, list(p.values()))))

    counted = (vrl_sum_clustered, cb.vrl_sum_clustered_bwd,
               vrl_sum_hetero_clustered, cb.vrl_sum_hetero_clustered_bwd)
    for fn in counted:
        fn.launches = 0
    (l2, grads2), (l4, grads4) = grad_step(loss2, start2), grad_step(loss4,
                                                                     start4)
    torch.cuda.synchronize()
    path_launches = [fn.launches for fn in counted]
    check(min(path_launches) >= 1, f"the clustered steps' launches "
          f"{path_launches}")
    fd_results = []
    top4 = [int(i) for i in grads4["density"].reshape(-1).abs().argsort(
        descending=True)[:2]]
    # (name, flat index, step) of each central difference
    for label, loss, start, grads, params in (
            ("config 2", loss2, start2, grads2,
             [("sigma_a", 0, 2e-3), ("sigma_s", 1, 2e-3), ("g", 0, 2e-3),
              ("intensity", 0, 0.4), ("wscale", 0, 2e-3)]),
            ("config 4", loss4, start4, grads4,
             [("sigma_t_color", 0, 2e-3), ("albedo", 1, 2e-3),
              ("scale", 0, 2e-3)] + [("density", i, 2e-2) for i in top4])):
        value = float(loss(start, integrator.render_clustered_kernel))
        check(math.isfinite(value) and value > 0.0, f"{label} loss {value}")
        for k, g in grads.items():
            check(bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0.0,
                  f"{label} gradient {k}")
        res = []
        for name, i, eps in params:
            def shifted(s):
                q = {k: v.clone() for k, v in start.items()}
                with torch.no_grad():
                    q[name].reshape(-1)[i] += s
                    return float(loss(q, integrator.render_clustered_kernel))
            fd = (shifted(eps) - shifted(-eps)) / (2 * eps)
            a = float(grads[name].reshape(-1)[i])
            check(fd != 0.0 and abs(a - fd) <= FD_TOL * abs(fd),
                  f"{label} FD {name}[{i}]: {a} vs {fd}")
            res.append(f"{name}[{i}] ad {a:.6g} fd {fd:.6g}")
        fd_results.append(f"{label} (loss {value:.6g}): " + ", ".join(res))
    print(f"[25 clustered gradient path on {card}] render_clustered_kernel_diff"
          f" on fixed tables: config 2 ({WIDTH}x{HEIGHT}, {n_vrls2} VRLs, "
          f"S={tv2.shape[0]} C={n_cols2}) from sigma_a x 2, config 4 "
          f"({C4_SIZE}x{C4_SIZE}, {C4_GRID}^3, S={tv4.shape[0]} C={n_cols4}) "
          f"from albedo x {C4_START['albedo']}, density x "
          f"{C4_START['density']}: launches vrl_sum_clustered "
          f"{path_launches[0]} vrl_sum_clustered_bwd {path_launches[1]} "
          f"vrl_sum_hetero_clustered {path_launches[2]} "
          f"vrl_sum_hetero_clustered_bwd {path_launches[3]}; "
          f"{int((grads4['density'] != 0.0).sum())} of "
          f"{grads4['density'].numel()} voxels with a non-zero gradient | "
          "same-seed FD of the kernel forward: " + " | ".join(fd_results)
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    # 26. timing: the steps and their parts, each kernel alone against its
    # forward and its plain version on the forward's timed inputs
    # (phases 14, 17, whose samples c2["sweep"], c4["c_sweep"] counted),
    # the bounds, a profile of the config-4 step
    lib = cb._library()
    step2_ms = host_ms(lambda: grad_step(loss2, start2), 2, 5)
    step4_ms = host_ms(lambda: grad_step(loss4, start4), 2, 5)
    scene_s = replace(scene4, medium=replace(
        gmed.with_density(med4, start4["density"]), albedo=start4["albedo"]))
    packs_s = integrator.pack_frame(scene_s, vrls4)[3]
    pack_ms = host_ms(lambda: integrator.pack_frame(scene_s, vrls4), 2, 5)
    layout_ms = host_ms(lambda: cb.host_layout(sop4, tv4, n_vrls4,
                                               cb.ray_block(True), dev), 2, 5)
    grid_arg = (packs_s[4], cfg.uv_tau_steps)
    layout4 = cb.host_layout(sop4, tv4, n_vrls4, cb.ray_block(True), dev)
    tiles4 = [torch.as_tensor(a, device=dev)
              for a in group_by_slice(sop4, vsc.ray_block(True))]
    c_out = torch.zeros((3, n_rays4), device=dev)
    kind4 = scene4.medium.phase_kind
    fwd_s_ms = cuda_ms_batched(lambda: vsc._launch(
        vsc._library(), *packs_s[:4], *tiles4, tv4, tw4, None, seed4, 2,
        2, True, kind4, c_out, grid_arg), 2, 5, 5)
    bwd_s_ms = cuda_ms_batched(lambda: cb._launch(
        lib, *packs_s[:4], layout4, tv4, tw4, None, seed4, 2, 2, True, kind4,
        gbar4, grid_arg), 2, 5, 5)

    # each kernel alone on its forward's timed inputs, against the forward
    # there and the plain backward
    packs2 = c2["packs"]
    kind2 = scene2.medium.phase_kind
    layout2 = cb.host_layout(sop2, tv2, n_vrls2, cb.ray_block(False), dev)
    tiles2 = [torch.as_tensor(a, device=dev)
              for a in group_by_slice(sop2, vsc.ray_block(False))]
    c2_out = torch.zeros((3, n_rays2), device=dev)
    f2_ms = cuda_ms_batched(lambda: vsc._launch(
        vsc._library(), *packs2, *tiles2, tv2, tw2, None, seed2, 2, 2, True,
        kind2, c2_out), 3, 10, 10)
    b2_ms = cuda_ms_batched(lambda: cb._launch(
        lib, *packs2, layout2, tv2, tw2, None, seed2, 2, 2, True, kind2,
        gbar2), 3, 10, 10)
    b2_out = cb._launch(lib, *packs2, layout2, tv2, tw2, None, seed2, 2, 2,
                        True, kind2, gbar2)
    check(all(torch.equal(a, b) for a, b in zip(
        b2_out, cb.vrl_sum_clustered_bwd(*packs2, sop2, tv2, tw2, gbar2,
                                         seed=seed2))),
        "the bare clustered backward launch is the wrapper's")
    # kernel 10's checking launch: the same tiling without the plane
    # pre-reject, which decides as the Wald test, so bit for bit the same
    def b2_no_reject():
        return cb._launch(lib, *packs2, layout2, tv2, tw2, None, seed2, 2, 2,
                          True, kind2, gbar2, mode=vs.MODE_NO_REJECT)
    check(all(torch.equal(a, b) for a, b in zip(b2_out, b2_no_reject())),
          "kernel 10 with and without the plane pre-reject: not bit-identical")
    b2nr_ms = cuda_ms_batched(b2_no_reject, 3, 10, 10)
    # the pre-reject's skips on config 2's segments: kernel 1's checking
    # launch on its packs (all 512 VRLs, the clustered tables' scene)
    k1_counts = vs.vrl_sum_check(*packs2, seed=seed2)[1]
    check(k1_counts["bad_tris"] == 0 and k1_counts["bad_segments"] == 0,
          f"config 2's segments: the pre-reject disagrees: {k1_counts}")
    grid4 = (packs4[4], cfg.uv_tau_steps)
    c4_out = torch.zeros((3, n_rays4), device=dev)
    f4_ms = cuda_ms_batched(lambda: vsc._launch(
        vsc._library(), *packs4[:4], *layout4[:2], tv4, tw4, None, seed4, 2,
        2, True, kind4, c4_out, grid4), 2, 5, 5)
    b4_ms = cuda_ms_batched(lambda: cb._launch(
        lib, *packs4[:4], layout4, tv4, tw4, None, seed4, 2, 2, True, kind4,
        gbar4, grid4), 2, 5, 5)
    with plain_chunk(C4_PLAIN_CHUNK):
        u2 = philox_table_uniforms(seed2, sop2, tv2, 6)
        p2_ms = cuda_ms(lambda: cb.vrl_sum_clustered_bwd_reference(
            *packs2, sop2, tv2, tw2, gbar2, u2), 0, 2)
        u4 = philox_table_uniforms(seed4, sop4, tv4, 6)
        p4_ms = cuda_ms(lambda: cb.vrl_sum_hetero_clustered_bwd_reference(
            *packs4, sop4, tv4, tw4, gbar4, u4, **kw4), 0, 1)
        del u2, u4
    sweep2, sweep4, uv = c2["sweep"], c4["c_sweep"], cfg.uv_tau_steps
    n_scatter = sweep4.open[0] * (2 + uv) + sweep4.open[1] * (1 + uv)
    lay_bytes2 = nbytes(*layout2)
    b2_ops = kernel_ops("vrl_sum_bwd", sweep2, kind2 == 0, True)
    b2_bytes = (nbytes(*packs2, tv2, tw2, gbar2) + lay_bytes2
                + 4 * (3 * n_rays2 + 3 * n_vrls2 + tv2.numel() + 8))
    b2_bound = bound(plane_ops(b2_ops, sweep2, skip_share_counts(
        k1_counts, sweep2)), b2_bytes)
    b2_wald = bound(b2_ops, b2_bytes)[0]
    n_tris2 = packs2[2].shape[0]
    b2_regs = [r for r in ptxas_summary(_build.build_log())
               if r.startswith("vrl_sum_clustered_bwd_warps_kernel")]
    rows4 = 3 + pk.NQ + 1
    b4_bound = bound(
        kernel_ops("vrl_sum_hetero_bwd", sweep4, kind4 == 0, True, uv),
        nbytes(*packs4, tv4, tw4, gbar4, *layout4)
        + 4 * (rows4 * (n_rays4 + n_vrls4) + tv4.numel() + pk.GRID_MED_LEN
               + packs4[4].numel() + n_scatter))
    (s2_med, s2_spread), (s4_med, s4_spread), (pk_med, _), (ly_med, _), \
        (fs_med, _), (bs_med, _), (f2_med, _), (b2_med, b2_spread), \
        (f4_med, _), (b4_med, b4_spread), (p2_med, _), (p4_med, _) = map(
            summary, (step2_ms, step4_ms, pack_ms, layout_ms, fwd_s_ms,
                      bwd_s_ms, f2_ms, b2_ms, f4_ms, b4_ms, p2_ms, p4_ms))
    print(f"[26 clustered gradient timing on {card}] config-4 step (host "
          f"clock, median of 5 after 2) {s4_med:.3f} ms (spread "
          f"{s4_spread:.1%}); alone on its inputs: packs {pk_med:.3f} ms, "
          f"host layout (grouping, CSR) {ly_med:.3f} ms, forward kernel "
          f"{fs_med:.4f} ms, backward kernel {bs_med:.4f} ms, rest (the "
          f"wrappers' host work, autograd of the packs and the upsample, "
          f"film, loss) {s4_med - pk_med - ly_med - fs_med - bs_med:.3f} ms; "
          f"config-2 step {s2_med:.3f} ms (spread {s2_spread:.1%}) | alone "
          f"(CUDA events over launches in a row) on phase 14's inputs: "
          f"vrl_sum_clustered_bwd {b2_med:.4f} ms (before its redesign "
          f"{EARLIER_MS['vrl_sum_clustered_bwd']} ms; spread {b2_spread:.1%})"
          f" against the forward {f2_med:.4f} ms ({b2_med / f2_med:.2f}x; "
          f"phase 14 {c2['fwd_ms']:.4f}); {len(layout2[1])} tiles of "
          f"{cb.ray_block(False)} rays ({float((layout2[0] < 0).double().mean()):.1%}"
          f" padding), {vs.occupancy('vrl_sum_clustered_bwd', False, n_tris2)}"
          f" blocks an SM; {' ; '.join(b2_regs)}; without the pre-reject "
          f"{summary(b2nr_ms)[0]:.4f} ms, bit-identical; bound "
          f"{b2_bound[0]:.4f} ms by {b2_bound[1]} on kernel 1's counted skips"
          f" of config 2's segments ({check_line(k1_counts)}), "
          f"{b2_wald:.4f} ms with a Wald test per swept triangle ({sweep2}),"
          f" plain {p2_med:.1f} ms | on phase 17's "
          f"inputs: vrl_sum_hetero_clustered_bwd {b4_med:.4f} ms (spread "
          f"{b4_spread:.1%}) against the forward {f4_med:.4f} ms "
          f"({b4_med / f4_med:.2f}x; phase 17 {c4['c_fwd_ms']:.4f}), bound "
          f"{b4_bound[0]:.4f} ms by {b4_bound[1]} ({sweep4}, {n_scatter} "
          f"density scatters; {sweep4.merged_reads} inside the box with "
          f"consecutive reads of one voxel merged, as the kernel makes them"
          f"), plain {p4_med:.1f} ms", flush=True)
    prof = profile_device(lambda: grad_step(loss4, start4), 1, 3)
    if prof is None:
        print("[26 profile] the profiler saw no device operation: not "
              "measured", flush=True)
    else:
        span, busy, n_ops, by_name = prof
        mine = {k: sum(v for n, v in by_name.items() if k + "<" in n)
                for k in ("vrl_sum_clustered_kernel",
                          "vrl_sum_clustered_bwd_kernel")}
        top = sorted(((v, k) for k, v in by_name.items()
                      if not any(m + "<" in k for m in mine)),
                     reverse=True)[:4]
        print(f"[26 profile on {card}] per traced config-4 clustered "
              f"gradient step: device span {span:.3f} ms, busy {busy:.3f} ms, "
              f"idle share {1 - busy / span:.1%}, {n_ops:g} device ops; "
              + ", ".join(f"{k} {v:.4f} ms ({v / busy:.1%} of busy)"
                          for k, v in mine.items()) + "; next: "
              + " | ".join(f"{v:.3f} ms {k[:60]}" for v, k in top),
              flush=True)

    def entry(name, line, n, err, ms, plain_ms, b):
        return {"name": name, "route": "cuda",
                "source": "alvrl_tpu_torch/csrc/vrl_sum_clustered_bwd.cu",
                "replaces": f"alvrl_tpu/ops/vrl_pallas_bwd.py:{line}",
                "launches": n, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
                "library_ms": None}

    return [entry("vrl_sum_clustered_bwd", 1046, path_launches[1], err10,
                  b2_med, p2_med, b2_bound),
            entry("vrl_sum_hetero_clustered_bwd", 1130, path_launches[3],
                  err11, b4_med, p4_med, b4_bound)]


# the large-mesh configuration (scripts/bench_bvh_large.py): the scenes
# of phases 28-29 and of the timing sweep, as (family, size)
BVH_CHECKED = (("cubes", 11), ("blob", 180))
BVH_HITS = (("cubes", 11), ("blob", 64))  # the two 16k scenes
BVH_MAIN = (("cubes", 11), ("blob", 64), ("blob", 180))
BVH_SWEEP = tuple(("cubes", n) for n in bbl.CUBE_AXES) + tuple(
    ("blob", n) for n in bbl.BLOB_THETAS)
BVH_SEED = 20261019
HIT_T_TOL = 1e-4  # BVH closest hits against intersect_all
# kernel 7 before its redesign on phase 30's scenes: (node boxes and
# triangles tested per shadow segment, ms), one box per node fetch
# (chip_smoke.py phase 30 of the tree before it, NVIDIA H100 80GB HBM3,
# 700 W), printed beside this run's
EARLIER_BVH = {("cubes", 11): (39.56, 1.89, 3.101),
               ("cubes", 16): (37.39, 2.02, 2.643),
               ("cubes", 22): (37.88, 2.99, 2.346),
               ("blob", 64): (19.90, 5.01, 6.210),
               ("blob", 112): (20.69, 5.04, 7.904),
               ("blob", 180): (21.39, 5.03, 9.304)}


class BvhSweep:
    """kernel_ops' view (SweepCount's attributes) of a vrl_sum_bvh launch
    whose counting instantiation counted the samples it met: pairs and
    drawn samples from the packs' masks, tested shadow segments, open
    samples per family, node fetches, box and triangle tests from the
    counts, and the box and triangle tests that the shadow function
    needs (the counting launch's needed_work)."""

    def __init__(self, rays, vrls, counts):
        pair_ok, alb_ok = pair_masks(rays, vrls)
        self.pairs = int(pair_ok.sum())
        self.drawn = [2 * self.pairs, 2 * int((pair_ok & alb_ok[:, None]).sum())]
        self.tested = [counts["segments"], 0]
        self.open = [counts["open_vv"], counts["open_vs"]]
        self.tri_tests = counts["tri_tests"]
        self.box_tests = counts["box_tests"]
        self.fetches = counts["node_fetches"]
        self.needed_boxes = counts["needed_box_tests"]
        self.needed_tris = counts["needed_tri_tests"]

    def __str__(self):
        seg = max(self.tested[0], 1)
        return (f"{self.pairs} pairs, {sum(self.drawn)} samples, "
                f"{sum(self.open) / seg:.3f} of {self.tested[0]} shadow "
                f"segments open, per segment {self.fetches / seg:.2f} node "
                f"fetches, {self.box_tests / seg:.2f} boxes and "
                f"{self.tri_tests / seg:.2f} triangles tested (needed: "
                f"{self.needed_boxes / seg:.2f} boxes and "
                f"{self.needed_tris / seg:.2f} triangles)")


def bvh_bound(packs, sweep, hg, own=False):
    """vrl_sum_bvh's bound on these packs: vrl_sum's operations on the
    counted samples, the box and triangle tests that the shadow function
    needs (with own=True: those the kernel made) and each segment's
    reciprocals; the packs read and the sums written."""
    boxes, tris = ((sweep.box_tests, sweep.tri_tests) if own
                   else (sweep.needed_boxes, sweep.needed_tris))
    f, sfu = kernel_ops("vrl_sum", replace_counts(sweep, tri_tests=tris), hg,
                        True)
    f += boxes * OPS["node"][0]
    sfu += sweep.tested[0] * OPS["bvh_segment"][1]
    rays, vrls, bvh, medium = packs
    return bound((f, sfu), nbytes(rays, vrls, bvh.nodes, bvh.tris, medium)
                 + 3 * rays.shape[1] * 4)


def replace_counts(sweep, **counts):
    """A copy of a BvhSweep with some of its counts replaced."""
    out = BvhSweep.__new__(BvhSweep)
    out.__dict__.update(sweep.__dict__, **counts)
    return out


def bvh_setup(kind, n, dev):
    """A large-mesh bench scene on the card, its VRLs and the render's
    stages on the host clock (each ending in a synchronize): (scene,
    vrls, packs, hit, {stage: ms})."""
    t = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t[name] = (time.perf_counter() - t0) * 1e3
        return out

    scene = stage("scene", lambda: bbl.scene_of(kind, n, device=dev))
    vrls = stage("trace", lambda: bbl.bench_vrls(scene))
    px, py, ray_o, ray_d = integrator.frame_rays(scene)
    tree = stage("BVH build (hits)", lambda: bvh_mod.build(scene.vertices,
                                                          scene.faces))
    hit, mat = stage("primary hits", lambda: integrator.trace_eye_rays_bvh(
        scene, ray_o, ray_d, tree))
    vrls_m = stage("Morton sort", lambda: vb.sort_vrls_morton(vrls))
    pack = stage("BVH build + pack (shadows)", lambda: vb.pack_bvh_tris(
        scene.vertices, scene.faces, scene.opaque_faces()))
    packs = stage("ray/VRL/medium packs", lambda: (
        pk.pack_rays(scene, ray_o, ray_d, hit, mat), pk.pack_vrls(vrls_m),
        pack, pk.pack_medium(scene)))
    stage("kernel", lambda: vb.vrl_sum_bvh(*packs, seed=BVH_SEED))
    return scene, vrls, packs, hit, t


def large_mesh(dev, card, cfg, vrls):
    """Phases 27-30, the large-mesh render; returns the kernels line's
    entry of vrl_sum_bvh."""
    rng = np.random.default_rng(27)

    # 27. kernel 7 against kernel 1 on the same Morton-sorted packs
    n_draws = 2 * cfg.vol_vol_samples + cfg.vol_surf_samples
    cube4 = bbl.scene_of("cubes", 4, device=dev)
    media = media_scenes(dev)
    inputs = [("config 1", media, vb.sort_vrls_morton(vrls)),
              ("cubes 4", {name: replace(cube4, medium=sc.medium)
                           for name, sc in media.items()},
               vb.sort_vrls_morton(bbl.bench_vrls(cube4)))]
    results, differing, max_rel, k1_packs = [], 0, 0.0, None
    for label, scenes, vrls_m in inputs:
        for name, sc in scenes.items():
            kind = MEDIA[name][1]
            packs = integrator.pack_frame(sc, vrls_m)[3]
            bvh = vb.pack_bvh_tris(sc.vertices, sc.faces, sc.opaque_faces())
            if k1_packs is None:
                k1_packs = (packs, bvh)
            n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
            u = torch.as_tensor(rng.random((n_rays, n_vrls, n_draws),
                                           dtype=np.float32), device=dev)
            for mode in ("injected", "philox", "long"):
                kw = dict(seed=BVH_SEED,
                          uniforms=None if mode == "philox" else u,
                          short_vrls=mode != "long", phase_kind=kind)
                a = vrl_sum(*packs, **kw)
                b = vb.vrl_sum_bvh(packs[0], packs[1], bvh, packs[3], **kw)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(b).all())
                      and float(b.abs().sum()) > 0.0,
                      f"{label} {name}/{mode}: finite, non-zero")
                n_diff = int((a != b).any(dim=0).sum())
                median, share = homog_bar(b.T, a.T)
                check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
                      f"{label} {name}/{mode}: {n_diff} rays differ, "
                      f"median {median}, share {share}")
                rel = float(((b - a).abs() / torch.clamp(
                    a.abs(), min=HOMOG_FLOOR)).max())
                differing += n_diff
                max_rel = max(max_rel, rel)
                results.append(f"{label} {name}/{mode} " + (
                    "equal" if not n_diff else
                    f"{n_diff} rays differ, largest rel {rel:.1e}"))
            del u
    print(f"[27 vrl_sum_bvh vs vrl_sum on {card}, config 1 (16384 rays x 512 "
          f"VRLs, 24 triangles) and a 4^3 cube field (4096 x 256, "
          f"{int(cube4.faces.shape[0])} triangles), Morton-sorted packs, "
          f"the homogeneous bar held] {differing} rays differ in all, the "
          f"largest relative difference {max_rel:.2e} (rounding, not a shadow "
          "test: a sample that one kernel drops moves its ray's sum by far "
          "more); " + " | ".join(results), flush=True)

    # 28. kernel 7 against its plain version; the BVH's primary hits
    setups = {key: bvh_setup(*key, dev) for key in dict.fromkeys(
        BVH_CHECKED + BVH_HITS + BVH_MAIN + BVH_SWEEP)}
    results, k7_err = [], 0.0
    for kind, n in BVH_CHECKED:
        scene, _, packs, _, _ = setups[(kind, n)]
        out = vb.vrl_sum_bvh(*packs, seed=BVH_SEED)
        rows = bbl.subset_rays(out.shape[1])
        t0 = time.perf_counter()
        ref = bbl.plain_on_subset(packs, rows, BVH_SEED)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        got = out[:, rows.to(dev)]
        median, share = homog_bar(got.T, ref.T)
        check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
              f"vrl_sum_bvh vs plain, {kind} {n}: median {median}, share "
              f"{share}")
        k7_err = max(k7_err, float((got - ref).abs().max()))
        if (kind, n) == BVH_CHECKED[0]:
            k7_plain_ms = plain_s * 1e3
        results.append(f"{kind} {n} ({int(scene.faces.shape[0])} triangles, "
                       f"depth {packs[2].depth}) on {len(rows)} rays: median "
                       f"{median:.2e} share {share:.4f} (plain {plain_s:.1f} s)")
    for kind, n in BVH_HITS:
        scene, _, _, hit, _ = setups[(kind, n)]
        _, _, ray_o, ray_d = integrator.frame_rays(scene)
        ref = [intersect.intersect_all(ray_o[i:i + 256], ray_d[i:i + 256],
                                       scene.vertices, scene.faces)
               for i in range(0, ray_o.shape[0], 256)]
        valid = torch.cat([r.valid for r in ref])
        prim = torch.cat([r.prim for r in ref])
        t_err = float((torch.cat([r.t for r in ref])[valid]
                       - hit.t[valid]).abs().max())
        check(torch.equal(valid, hit.valid) and torch.equal(prim, hit.prim)
              and t_err <= HIT_T_TOL,
              f"BVH hits vs intersect_all, {kind} {n}: t error {t_err}")
        results.append(f"hits of {kind} {n}: {int(valid.sum())} of "
                       f"{len(valid)} valid, prim equal, t within {t_err:.1e}")
    print(f"[28 vrl_sum_bvh vs plain on {card}, Philox stream of seed "
          f"{BVH_SEED}] " + " | ".join(results), flush=True)

    # 29. the main path, through the entry point a user calls
    vb.vrl_sum_bvh.launches = 0
    images = {}
    for key in BVH_MAIN:
        scene, vrls_b, _, _, _ = setups[key]
        images[key] = integrator.render_with_vrls_kernel_bvh(
            scene, vrls_b, torch.Generator().manual_seed(29), cfg)
    torch.cuda.synchronize()
    launches = vb.vrl_sum_bvh.launches
    check(launches >= len(BVH_MAIN), f"vrl_sum_bvh launches {launches}")
    seed = integrator.draw_seed(torch.Generator().manual_seed(29))
    results = []
    for key, img in images.items():
        scene, vrls_b, packs, hit, _ = setups[key]
        check(tuple(img.shape) == (bbl.WIDTH, bbl.WIDTH, 3)
              and bool(torch.isfinite(img).all())
              and float(img.abs().max()) > 0.0, f"{key} image")
        rows = bbl.subset_rays(packs[0].shape[1])
        li = bbl.plain_on_subset(packs, rows, seed).T / torch.clamp(
            vrls_b.particle_count, min=1.0)
        li = torch.where(hit.valid[rows.to(dev), None], li, 0.0)
        median, share = homog_bar(img.reshape(-1, 3)[rows.to(dev)], li)
        check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
              f"{key} render vs plain: median {median}, share {share}")
        results.append(f"{key[0]} {key[1]} ({int(scene.faces.shape[0])} "
                       f"triangles): image mean {float(img.mean()):.6f}, vs "
                       f"plain on {len(rows)} pixels median {median:.2e} share "
                       f"{share:.4f}")
    print(f"[29 main path on {card}] render_with_vrls_kernel_bvh, "
          f"{bbl.WIDTH}x{bbl.WIDTH}, {bbl.N_PARTICLES} particles x depth "
          f"{bbl.MAX_DEPTH} in {bbl.N_SLOTS} slots: vrl_sum_bvh launches "
          f"{launches}; " + " | ".join(results), flush=True)

    # 30. timing: the sweep, kernel 7 against kernel 1, stages, bounds
    rows, lines = [], []
    for key in BVH_SWEEP:
        scene, _, packs, _, stages = setups[key]
        hg = scene.medium.phase_kind == 0
        ms = summary(cuda_ms(lambda: vb.vrl_sum_bvh(*packs, seed=BVH_SEED),
                             2, 5))
        counted, counts = vb.vrl_sum_bvh_counts(*packs, seed=BVH_SEED)
        check(torch.equal(counted, vb.vrl_sum_bvh(*packs, seed=BVH_SEED)),
              f"{key}: the counting launch's sums are the kernel's")
        check(counts["differ"] == 0, f"{key}: the counting launch's "
              f"one-box-per-node traversal decides {counts['differ']} "
              "segments otherwise")
        sweep = BvhSweep(packs[0], packs[1], counts)
        b = bvh_bound(packs, sweep, hg)
        evals = packs[0].shape[1] * packs[1].shape[1] * n_draws
        rows.append(dict(key=key, tris=int(scene.faces.shape[0]), ms=ms[0],
                         bound=b, sweep=sweep, packs=packs))
        old_boxes, old_tris, old_ms = EARLIER_BVH[key]
        own_bound = bvh_bound(packs, sweep, hg, own=True)
        lines.append(
            f"{key[0]} {key[1]}: {int(scene.faces.shape[0])} triangles, depth "
            f"{packs[2].depth}, {ms[0]:.3f} ms (spread {ms[1]:.1%}; before "
            f"the redesign {old_ms} ms), {evals / (ms[0] / 1e3):.4g} "
            f"pair-sample evals/s, {sweep} (before: {old_boxes} boxes, one a "
            f"fetch, and {old_tris} triangles), bound {b[0]:.4f} ms by {b[1]} "
            f"on the needed tests (on the kernel's own {own_bound[0]:.4f} "
            f"ms), 0 segments decided otherwise; stages (ms) "
            + ", ".join(f"{k} {v:.1f}" for k, v in stages.items()))
    ratios = [f"{a['key'][0]} x{b['tris'] / a['tris']:.2f} triangles -> "
              f"x{b['ms'] / a['ms']:.2f} time" for a, b in zip(rows, rows[1:])
              if a["key"][0] == b["key"][0]]
    packs1, bvh1 = k1_packs
    k1_ms = summary(cuda_ms(lambda: vrl_sum(*packs1, seed=BVH_SEED), 3, 10))
    k7_ms = summary(cuda_ms(lambda: vb.vrl_sum_bvh(
        packs1[0], packs1[1], bvh1, packs1[3], seed=BVH_SEED), 3, 10))
    print(f"[30 timing on {card}] vrl_sum_bvh (CUDA events, median of 5 "
          "after 2): " + " | ".join(lines) + " | scaling: " + "; ".join(ratios)
          + f" | at config-1 inputs (24 triangles, depth {bvh1.depth}): "
          f"vrl_sum {k1_ms[0]:.3f} ms, vrl_sum_bvh {k7_ms[0]:.3f} ms "
          f"({k7_ms[0] / k1_ms[0]:.2f}x)", flush=True)
    for key in (BVH_MAIN[0], BVH_MAIN[-1]):
        scene, vrls_b = setups[key][:2]
        pass_ms = summary(host_ms(lambda: integrator.render_with_vrls_kernel_bvh(
            scene, vrls_b, torch.Generator().manual_seed(30), cfg), 1, 3))
        prof = profile_device(lambda: integrator.render_with_vrls_kernel_bvh(
            scene, vrls_b, torch.Generator().manual_seed(30), cfg), 1, 2)
        head = (f"[30 profile on {card}] render_with_vrls_kernel_bvh, "
                f"{key[0]} {key[1]}: {pass_ms[0]:.1f} ms per pass (host "
                f"clock, median of 3 after 1, spread {pass_ms[1]:.1%})")
        if prof is None:
            print(head + "; the profiler saw no device operation: not "
                  "measured", flush=True)
            continue
        span, busy, n_ops, by_name = prof
        k_ms = sum(v for k, v in by_name.items() if "vrl_sum_bvh_kernel" in k)
        top = sorted(((v, k) for k, v in by_name.items()
                      if "vrl_sum_bvh_kernel" not in k), reverse=True)[:4]
        print(head + f"; per traced pass: device span {span:.3f} ms, busy "
              f"{busy:.3f} ms, idle share {1 - busy / span:.1%}, {n_ops:g} "
              f"device ops; vrl_sum_bvh_kernel {k_ms:.3f} ms ({k_ms / busy:.1%}"
              " of busy); next: " + " | ".join(f"{v:.3f} ms {k[:60]}"
                                               for v, k in top), flush=True)
    main_row = rows[0]  # the bench's 16k cube field, whose plain phase 28 timed
    # (on its SUBSET_RAYS rays: the plain time is of that subset)
    return {
        "name": "vrl_sum_bvh", "route": "cuda",
        "source": "alvrl_tpu_torch/csrc/vrl_sum_bvh.cu",
        "replaces": "alvrl_tpu/ops/vrl_pallas.py:1415",
        "launches": launches, "max_abs_err": k7_err, "ms": main_row["ms"],
        "plain_ms": k7_plain_ms, "bound_ms": main_row["bound"][0],
        "bound_by": main_row["bound"][1], "library_ms": None,
    }


def gather_probes(dev, card):
    """Phase 31, the gather probes; returns their kernels line entries."""
    for fn in (probe.lane_gather, probe.row_gather, probe.gather_many):
        fn.launches = 0
    result = probe.main(dev)
    launches = (probe.lane_gather.launches, probe.row_gather.launches,
                probe.gather_many.launches)
    check(min(launches) >= 1 and result["lane_gather_equal"]
          and result["row_gather_equal"], f"probe: {result}, {launches}")
    tbl, idx, tbl0, idx0 = probe.inputs(dev)
    idx_l, idx0_l = idx.long(), idx0.long()
    cases = [
        ("lane_gather", 42, (tbl, idx), probe.lane_gather_reference,
         lambda: torch.gather(tbl, 1, idx_l), ()),
        ("row_gather", 63, (tbl0, idx0), probe.row_gather_reference,
         lambda: torch.gather(tbl0, 0, idx0_l), ()),
        ("gather_many", 79, (tbl, idx), probe.gather_many_reference, None,
         (probe.REPS,)),
    ]
    def device_ms(fn, batch=20):
        """fn's device time per call: CUDA events around `batch` calls in
        a row, queued behind a spin kernel (torch.cuda._sleep) that
        outlasts their host cost, so the device runs them back to back
        (each of these calls takes microseconds, under a launch's host
        cost); (median of 5, spread)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        torch.cuda.synchronize()
        cycles = int(4e9 * (time.perf_counter() - t0)) + 1_000_000
        times = []
        for _ in range(5):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda._sleep(cycles)  # twice the host time at <= 2 GHz
            start.record()
            for _ in range(batch):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / batch)
        return summary(times)

    entries, lines = [], []
    for (name, line, args, plain, library, extra), n in zip(cases, launches):
        out = probe._launch(f"alvrl_{name}", *args, *extra)
        ref = plain(*args)
        check(torch.equal(out, ref), f"{name} vs plain")
        ms, spread = device_ms(lambda: probe._launch(f"alvrl_{name}", *args,
                                                     *extra))
        events_ms = summary(cuda_ms_batched(lambda: probe._launch(
            f"alvrl_{name}", *args, *extra), 3, 10, 20))[0]
        # the plain many-gather is 512 launches a call: one call a window
        # keeps the queue behind the spin kernel under CUDA's launch queue
        plain_ms = device_ms(lambda: plain(*args), 1 if extra else 20)[0]
        lib_ms = None if library is None else device_ms(library)[0]
        n_ops = (tbl.numel() * probe.REPS, 0) if extra else (0, 0)
        b = bound(n_ops, 3 * tbl.numel() * 4)
        entries.append({
            "name": name, "route": "cuda",
            "source": "alvrl_tpu_torch/csrc/probe_gather.cu",
            "replaces": f"scripts/probe_gather.py:{line}", "launches": n,
            "max_abs_err": float((out - ref).abs().max()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
            "library_ms": lib_ms})
        lines.append(f"{name} {ms * 1e3:.2f} us (spread {spread:.1%}; "
                     f"{events_ms * 1e3:.2f} us with the host's launch "
                     f"cost), plain {plain_ms * 1e3:.2f} us, "
                     "torch.gather " + ("none" if lib_ms is None
                                        else f"{lib_ms * 1e3:.2f} us")
                     + f", bound {b[0] * 1e3:.4f} us by {b[1]}, equal")
    many_ms = entries[2]["ms"]
    print(f"[31 gather probes on {card}] probe_gather.main: launches "
          f"{launches}, {result['gathers_per_s']:.4g} gathers/s over its "
          f"{probe.N_ITER} calls (host clock), "
          f"{tbl.numel() * probe.REPS / (many_ms / 1e3):.4g} gathers/s on the "
          "device | device time per call (CUDA events over 20 calls queued "
          "behind a spin kernel): " + " | ".join(lines), flush=True)
    return entries


# phases 32-35: scene files through the loader, the CLI, the pipelined
# driver and resume. The preset camera (presets.cornell_smoke's)
PRESET_CAMERA = dict(origin=[0.0, 0.0, -0.99], target=[0.0, 0.0, 1.0],
                     up=[0.0, 1.0, 0.0], fov=90.0)
CLI_SEED = 1
C3_SIZE, C5_SIZE = 256, 1024
# (label, scene file, integrator, passes, CLI options, the route's kernel
# wrappers): BASELINE configs 1-5 (scripts/bench_suite.py; the tracer at
# its default depth, 16, which both CLIs' VRL integrators take, and
# config 4's clustering at the CLI's defaults, 100 slices and
# undersampling 64, since neither CLI has options for them), the XML box
# and the large-mesh cube field (scripts/bench_bvh_large.py)
CLI_RUNS = [
    ("config1", "c1.json", "vrl", 4, ["-D", f"w={WIDTH}", "-D",
                                      f"h={HEIGHT}"], ("vrl_sum",)),
    ("config2", "c1.json", "alvrl", 4, ["-D", f"w={WIDTH}", "-D",
                                        f"h={HEIGHT}"],
     ("vrl_r", "vrl_sum_clustered")),
    ("config3", "c3.json", "vrl", 2, [], ("vrl_sum",)),
    ("config4", "c4.json", "alvrl", 2, ["--particles", "192"],
     ("vrl_r_hetero", "vrl_sum_hetero_clustered")),
    ("xml box", "c1.xml", "vrl", 2, [], ("vrl_sum",)),
    ("config5", "c1.json", "vrl", 1, ["-D", f"w={C5_SIZE}", "-D",
                                      f"h={C5_SIZE}"], ("vrl_sum",)),
    ("cube field", "field.json", "vrl", 1, ["--particles", "64", "--vrls",
                                            "256"], ("vrl_sum_bvh",)),
]
# the runs whose kernel-1 launches are held against the plain version on
# the same packs and Philox stream: label -> rays held per launch (a
# sample of config 3's 65,536 and of config 5's 1,048,576, the last ray
# included)
CLI_HOLDS = {"config3": 8192, "config5": 4096}
HOLD_CHUNK = 8192  # rays per block of the plain version in those holds
# the kernels' wrappers, and the plain versions a wrapper runs on CPU
# tensors (none may run on the card's main path)
ROUTE_KERNELS = {"vrl_sum": vs.vrl_sum, "vrl_sum_hetero": vs.vrl_sum_hetero,
                 "vrl_r": vr.vrl_r, "vrl_r_hetero": vr.vrl_r_hetero,
                 "vrl_sum_clustered": vsc.vrl_sum_clustered,
                 "vrl_sum_hetero_clustered": vsc.vrl_sum_hetero_clustered,
                 "vrl_sum_bvh": vb.vrl_sum_bvh}
PLAIN_VERSIONS = [(vs, "_reference"), (vr, "_reference"),
                  (vsc, "_reference"), (vb, "vrl_sum_bvh_reference")]
DRIVER_PASSES, DRIVER_REPEATS = 4, 2


@contextlib.contextmanager
def plain_calls(extra=()):
    """Count the calls of the kernels' plain versions (and of the `extra`
    (module, name) functions): yields a list whose one element is the
    count."""
    count, saved = [0], []
    for mod, name in [*PLAIN_VERSIONS, *extra]:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def counted(*a, _fn=fn, **k):
            count[0] += 1
            return _fn(*a, **k)
        setattr(mod, name, counted)
    try:
        yield count
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def kernel1_launches():
    """Record kernel 1's launches on the Philox stream (vs._launch with
    homogeneous packs, no uniforms, the summing mode): yields a list of
    (rays, vrls, tris, medium, seed, svv, svs, short_vrls, phase_kind,
    output, materials), materials the launch's material pack or None."""
    launch, records = vs._launch, []

    def recording(lib, rays, vrls, tris, medium, uniforms, seed, svv, svs,
                  short_vrls, phase_kind, grid=None, mode=vs.MODE_SUM,
                  counts=None, materials=None):
        out = launch(lib, rays, vrls, tris, medium, uniforms, seed, svv,
                     svs, short_vrls, phase_kind, grid, mode, counts,
                     materials=materials)
        if grid is None and uniforms is None and mode == vs.MODE_SUM:
            records.append((rays, vrls, tris, medium, seed, svv, svs,
                            short_vrls, phase_kind, out, materials))
        return out
    vs._launch = recording
    try:
        yield records
    finally:
        vs._launch = launch


def hold_kernel1(label, records, n_sample):
    """Each recorded kernel-1 launch against vrl_sum_reference on the same
    packs and the kernel's Philox stream (philox_draws at the rays'
    indices in the launch), on all its rays or on `n_sample` of them (a
    seeded sample, the last ray included), at the homogeneous bar.
    Returns a line of text."""
    parts = []
    for i, (rays, vrls, tris, medium, seed, svv, svs, short, kind, out,
            mats) in enumerate(records):
        n_rays, n_vrls = rays.shape[1], vrls.shape[1]
        if n_sample is None or n_sample >= n_rays:
            idx = torch.arange(n_rays, device=rays.device)
        else:
            pick = np.random.default_rng(i).choice(n_rays - 1, n_sample - 1,
                                                   replace=False)
            idx = torch.as_tensor(np.append(np.sort(pick), n_rays - 1),
                                  device=rays.device)
        vrl_idx = torch.arange(n_vrls, device=rays.device)[None, :]
        ref = torch.cat([vrl_sum_reference(
            rays[:, b], vrls, tris, medium,
            philox_draws(seed, b[:, None], vrl_idx, 2 * svv + svs),
            vol_vol_samples=svv, vol_surf_samples=svs, short_vrls=short,
            phase_kind=kind, materials=mats)
            for b in idx.split(HOLD_CHUNK)], dim=1)
        median, share = homog_bar(out[:, idx].T, ref.T)
        err = float((out[:, idx] - ref).abs().max())
        check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
              f"{label}: kernel 1's launch {i} ({n_rays} rays x {n_vrls} "
              f"VRLs) against its plain version: median {median}, share "
              f"{share}")
        parts.append(f"launch {i}: {len(idx)} of {n_rays} rays x {n_vrls} "
                     f"VRLs, median {median:.2e} share>1e-2 {share:.4f} "
                     f"max_abs {err:.3e}")
    check(bool(parts), f"{label}: no kernel-1 launch recorded")
    return f"kernel 1 vs plain ({'; '.join(parts)})"


def scene_json(scene, medium):
    """A JSON scene dict of a preset: its triangles as one trimesh per
    run of faces of one material, its materials, lights and camera, and
    `medium`."""
    v = scene.vertices.cpu().numpy()
    f = scene.faces.cpu().numpy()
    mat = scene.material.cpu().numpy()
    cuts = np.flatnonzero(np.diff(mat)) + 1
    shapes = [{"type": "trimesh", "material": f"m{int(mat[r[0]])}",
               "vertices": v[f[r]].reshape(-1).tolist(),
               "faces": list(range(3 * len(r)))}
              for r in np.split(np.arange(len(f)), cuts)]
    cam = scene.camera
    return {
        "camera": dict(PRESET_CAMERA, width=cam.width, height=cam.height),
        "materials": [{"name": f"m{i}", "type": "diffuse", "albedo": a}
                      for i, a in enumerate(
                          scene.materials.albedo.cpu().tolist())],
        "shapes": shapes,
        "emitters": [{"type": "point", "position": p, "intensity": i}
                     for p, i in zip(scene.emitters.position.cpu().tolist(),
                                     scene.emitters.intensity.cpu().tolist())],
        "medium": medium,
    }


def homog_medium(scene):
    med = scene.medium
    return {"type": "homogeneous", "sigma_s": med.sigma_s.cpu().tolist(),
            "sigma_a": med.sigma_a.cpu().tolist(), "g": float(med.g),
            "phase": "hg"}


def write_ply(path, verts, faces):
    """A binary little-endian PLY of float32 vertices and triangles."""
    face = np.zeros(len(faces), [("n", "u1"), ("i", "<i4", 3)])
    face["n"], face["i"] = 3, faces
    with open(path, "wb") as f:
        f.write((f"ply\nformat binary_little_endian 1.0\n"
                 f"element vertex {len(verts)}\nproperty float x\n"
                 "property float y\nproperty float z\n"
                 f"element face {len(faces)}\n"
                 "property list uchar int vertex_indices\nend_header\n"
                 ).encode())
        f.write(np.asarray(verts, "<f4").tobytes() + face.tobytes())


def write_obj(path, verts, faces):
    with open(path, "w") as f:
        for p in verts:
            f.write("v " + " ".join(repr(float(x)) for x in p) + "\n")
        for t in faces:
            f.write("f " + " ".join(str(int(i) + 1) for i in t) + "\n")


def box_xml(scene, tmp, lights=None):
    """The config-1 box as a Mitsuba XML scene: one OBJ per run of faces
    of one material, the preset's camera, light (or the XML `lights`)
    and medium."""
    v = scene.vertices.cpu().numpy()
    f = scene.faces.cpu().numpy()
    mat = scene.material.cpu().numpy()
    cuts = np.flatnonzero(np.diff(mat)) + 1
    bsdfs, shapes = [], []
    for i, a in enumerate(scene.materials.albedo.cpu().tolist()):
        bsdfs.append(f'<bsdf type="diffuse" id="m{i}"><rgb name="reflectance"'
                     f' value="{", ".join(map(repr, a))}"/></bsdf>')
    for k, r in enumerate(np.split(np.arange(len(f)), cuts)):
        write_obj(os.path.join(tmp, f"part{k}.obj"), v[f[r]].reshape(-1, 3),
                  np.arange(3 * len(r)).reshape(-1, 3))
        shapes.append(f'<shape type="obj"><string name="filename" '
                      f'value="part{k}.obj"/><ref id="m{int(mat[r[0]])}"/>'
                      "</shape>")
    med, em, cam = scene.medium, scene.emitters, scene.camera
    vec = lambda t: ", ".join(map(repr, t.cpu().tolist()))  # noqa: E731
    if lights is None:
        lights = (f'<emitter type="point"><point name="position" '
                  f'value="{vec(em.position[0])}"/>\n    <rgb name='
                  f'"intensity" value="{vec(em.intensity[0])}"/></emitter>')
    return f"""<scene version="0.5.0">
  <sensor type="perspective">
    <float name="fov" value="{PRESET_CAMERA['fov']}"/>
    <transform name="toWorld"><lookat origin="0, 0, -0.99" target="0, 0, 1"
      up="0, 1, 0"/></transform>
    <film type="hdrfilm"><integer name="width" value="{cam.width}"/>
      <integer name="height" value="{cam.height}"/></film>
  </sensor>
  {"".join(bsdfs)}
  {"".join(shapes)}
  {lights}
  <medium type="homogeneous" id="smoke">
    <rgb name="sigmaS" value="{vec(med.sigma_s)}"/>
    <rgb name="sigmaA" value="{vec(med.sigma_a)}"/>
    <phase type="hg"><float name="g" value="{float(med.g)!r}"/></phase>
  </medium>
</scene>"""


def same_scene(ours, preset):
    """The loaded scene holds the preset's triangles, materials, lights,
    medium and camera, bit for bit."""
    tri = lambda s: s.vertices[s.faces]  # noqa: E731
    ok = (torch.equal(tri(ours), tri(preset))
          and torch.equal(ours.material, preset.material))
    for part in ("materials", "emitters", "medium", "camera"):
        a, b = getattr(ours, part), getattr(preset, part)
        for k in a.__dataclass_fields__:
            x, y = getattr(a, k), getattr(b, k)
            ok = ok and (torch.equal(x, y) if isinstance(x, torch.Tensor)
                         else x == y)
    return ok


def scene_files(dev, card, tmp):
    """Phase 32: writes the scene files of phases 33-35 into `tmp` and
    checks that the port's loader loads each as its preset."""
    c1 = presets.cornell_smoke(WIDTH, HEIGHT, device=dev)
    c3 = presets.cornell_smoke_hg(C3_SIZE, C3_SIZE, device=dev)
    c4 = presets.cornell_grid_smoke(C4_SIZE, C4_SIZE, grid_res=C4_GRID,
                                    device=dev)
    field = bbl.cube_field_scene(64, 64, bbl.CUBE_AXES[0], device=dev)
    desc = scene_json(c1, homog_medium(c1))
    desc["camera"].update(width="$w", height="$h")
    with open(os.path.join(tmp, "c1.json"), "w") as f:
        f.write(json.dumps(desc).replace('"$w"', "$w").replace('"$h"', "$h"))
    with open(os.path.join(tmp, "c3.json"), "w") as f:
        json.dump(scene_json(c3, homog_medium(c3)), f)
    np.save(os.path.join(tmp, "density.npy"), c4.medium.density.cpu().numpy())
    med = c4.medium
    with open(os.path.join(tmp, "c4.json"), "w") as f:
        json.dump(scene_json(c4, {
            "type": "grid", "density_npy": os.path.join(tmp, "density.npy"),
            "sigma_t": med.sigma_t_color.cpu().tolist(),
            "albedo": med.albedo.cpu().tolist(), "g": float(med.g),
            "box_min": med.box_min.cpu().tolist(),
            "box_max": med.box_max.cpu().tolist(), "scale": float(med.scale),
            "phase": "hg"}), f)
    with open(os.path.join(tmp, "c1.xml"), "w") as f:
        f.write(box_xml(c1, tmp))
    n_walls = 12  # the box without its blocker; then the cubes
    fv, ff = field.vertices.cpu().numpy(), field.faces.cpu().numpy()
    walls_v = int(ff[:n_walls].max()) + 1
    write_ply(os.path.join(tmp, "cubes.ply"), fv[walls_v:],
              ff[n_walls:] - walls_v)
    walls = scene_json(replace(field, faces=field.faces[:n_walls],
                               material=field.material[:n_walls]),
                       homog_medium(field))
    walls["shapes"].append({"type": "ply", "material": "m0",
                            "filename": os.path.join(tmp, "cubes.ply")})
    with open(os.path.join(tmp, "field.json"), "w") as f:
        json.dump(walls, f)

    c5 = presets.cornell_smoke(C5_SIZE, C5_SIZE, device=dev)
    loaded = {
        "config 1/2": (loader.load_json(os.path.join(tmp, "c1.json"),
                                        {"w": WIDTH, "h": HEIGHT},
                                        device=dev), c1),
        "config 3": (loader.load_json(os.path.join(tmp, "c3.json"),
                                      device=dev), c3),
        "config 4": (loader.load_json(os.path.join(tmp, "c4.json"),
                                      device=dev), c4),
        "config 5": (loader.load_json(os.path.join(tmp, "c1.json"),
                                      {"w": C5_SIZE, "h": C5_SIZE},
                                      device=dev), c5),
        "xml box": (loader.build_scene(loader.convert_mitsuba_xml(
            os.path.join(tmp, "c1.xml")), device=dev), c1),
        "cube field (PLY)": (loader.load_json(os.path.join(tmp, "field.json"),
                                              device=dev), field),
    }
    for name, (ours, preset) in loaded.items():
        check(same_scene(ours, preset), f"{name}: the loaded scene is not "
              "the preset's")
    check(torch.equal(loaded["config 4"][0].medium.density, c4.medium.density),
          "config 4: the grid is not the preset's")
    print(f"[32 scene files on {card}] " + " | ".join(
        f"{name}: {ours.faces.shape[0]} triangles, "
        f"{ours.camera.width}x{ours.camera.height}, equal to the preset"
        for name, (ours, _) in loaded.items())
        + f" | config 4's {tuple(c4.medium.density.shape)} grid bit for bit",
        flush=True)
    return c1, c4


def cli_runs(dev, card, tmp, runs=CLI_RUNS, phase="33 the CLI",
             profile=None):
    """Phase 33 (and 38's runs): render_cli.main on each scene file of
    `runs`; returns {label: (median ms per pass, spread)}, and with
    `profile` a run's label also {"profile": profile_device's trace of
    that run's in-process render}."""
    out, lines = {}, []
    for label, name, integ, passes, opts, route in runs:
        path = os.path.join(tmp, name)
        out_pfm = os.path.join(tmp, f"{label.replace(' ', '_')}.pfm")
        args = [path, "-i", integ, "-p", str(passes), "--seed",
                str(CLI_SEED), "-o", out_pfm, "-L", "WARNING", *opts]
        for k in ROUTE_KERNELS.values():
            k.launches = 0
        n_before = len(STATS.timings.get("pass", []))
        with plain_calls() as plain, kernel1_launches() as records:
            t0 = time.perf_counter()
            rc = render_cli.main(args)
            wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in ROUTE_KERNELS.items()}
        pass_ms = [1e3 * s for s in STATS.timings["pass"][n_before:]]
        img = image.read_pfm(out_pfm)
        check(rc == 0, f"{label}: exit code {rc}")
        check(all(launches[k] >= 1 for k in route),
              f"{label}: the route's kernels {route} did not launch: "
              f"{launches}")
        check(plain[0] == 0, f"{label}: {plain[0]} plain-version calls")
        check(np.isfinite(img).all() and float(np.abs(img).max()) > 0,
              f"{label}: the image is not finite and non-zero")
        # the same render in process: the CLI's scene, seed and options
        cli = render_cli.parse_args(args)
        defines = dict(kv.split("=", 1) for kv in cli.define)
        scene = (loader.build_scene(loader.convert_mitsuba_xml(path, defines),
                                    device=dev) if path.endswith(".xml")
                 else loader.load_json(path, defines, device=dev))
        refs = []

        def render():
            refs.append(render_progressive(
                scene, CLI_SEED, ProgressiveConfig(
                    max_passes=passes, clustered=integ == "alvrl"),
                alvrl.ALVRLParams(vrl_target_num=cli.vrls,
                                  num_particles=cli.particles)))

        if label == profile:
            out["profile"] = profile_device(render, 0, 1)
        else:
            render()
        ref = refs[0]
        check(np.array_equal(img, ref), f"{label}: the CLI's image is not "
              "render_progressive's")
        hold = (", " + hold_kernel1(label, records, CLI_HOLDS[label])
                if label in CLI_HOLDS else "")
        del records[:]
        med, spread = summary(pass_ms)
        out[label] = (med, spread)
        lines.append(
            f"{label} ({' '.join([integ, '-p', str(passes), *opts])}, "
            f"{scene.camera.width}x{scene.camera.height}, "
            f"{scene.faces.shape[0]} triangles): rc 0, mean "
            f"{float(img.mean()):.6g}, equal to render_progressive, "
            "launches " + ", ".join(f"{k} {launches[k]}" for k in route)
            + f", plain calls {plain[0]}, {med:.1f} ms a pass (median of "
            f"{passes}, spread {spread:.1%}; each pass "
            + " ".join(f"{t:.1f}" for t in pass_ms)
            + f"; the first is the scene's first), CLI wall {wall:.2f} s"
            + hold)
    print(f"[{phase} on {card}] " + " | ".join(lines), flush=True)
    return out


def driver_profile(fn):
    """One traced call of fn (then a synchronize) under torch.profiler:
    (span ms, busy ms, the three largest gaps between device operations,
    as (ms, the operation before, the one after)), or None."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    ops = sorted((e for e in events if e.get("cat") in DEVICE_CATS),
                 key=lambda e: e["ts"])
    if not ops:
        return None
    busy, end, gaps, prev = 0.0, ops[0]["ts"], [], ops[0]["name"]
    for e in ops:
        t0, t1 = e["ts"], e["ts"] + e["dur"]
        if t0 > end:
            gaps.append(((t0 - end) / 1e3, prev[:40], e["name"][:40]))
        busy += max(0.0, t1 - max(t0, end))
        if t1 >= end:
            end, prev = t1, e["name"]
    return (end - ops[0]["ts"]) / 1e3, busy / 1e3, sorted(gaps)[-3:][::-1]


def sync_sites(fn):
    """The synchronising calls of fn, as torch.cuda's sync debug mode
    reports them: {file:line: count}."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return sites


def drivers(dev, card):
    """Phase 34: the pipelined schedule (render_progressive, clustered,
    and render_alvrl_progressive) against the serial one (render_alvrl
    pass after pass) at full configs 2 and 4; returns {config:
    numbers}, config 2's image (for phase 35) and config 2's case."""
    c2_params = alvrl.ALVRLParams(**C2_PARAMS,
                                  cluster=cl.ClusterParams(**C2_CLUSTER))
    c4_params = alvrl.ALVRLParams(**C4_PARAMS,
                                  cluster=cl.ClusterParams(**C4_CLUSTER))
    configs = [
        ("config2", presets.cornell_smoke(WIDTH, HEIGHT, device=dev),
         c2_params,
         tracer.TracerConfig()),
        ("config4", presets.cornell_grid_smoke(C4_SIZE, C4_SIZE,
                                               grid_res=C4_GRID, device=dev),
         c4_params, tracer.TracerConfig(max_depth=C4_DEPTH))]
    results, lines, c2_image = {}, [], None
    for name, scene, params, tcfg in configs:
        prog = ProgressiveConfig(max_passes=DRIVER_PASSES, clustered=True)

        def serial():
            # render_alvrl pass after pass, summed on the host in pass
            # order as render_progressive sums
            slice_info = alvrl.build_slice_info(scene, params)
            acc = None
            for k in range(DRIVER_PASSES):
                img = alvrl.render_alvrl(
                    scene, alvrl.pass_generator(CLI_SEED, k), params,
                    tracer_cfg=tcfg, slice_info=slice_info)[0].cpu().numpy()
                acc = img if acc is None else acc + img
            return acc / DRIVER_PASSES

        def driver():
            return render_progressive(scene, CLI_SEED, prog, params,
                                      tracer_cfg=tcfg)

        def piped(n=DRIVER_PASSES, timings=None):
            img = alvrl.render_alvrl_progressive(
                scene, n, CLI_SEED, params, tracer_cfg=tcfg,
                timings=timings)[0]
            torch.cuda.synchronize()
            return img

        s_img, d_img = serial(), driver()
        timings = {}
        p_img = piped(timings=timings).cpu().numpy()
        check(np.array_equal(s_img, d_img) and np.array_equal(s_img, p_img),
              f"{name}: the pipelined images are not the serial one")
        check(np.isfinite(p_img).all() and float(p_img.max()) > 0,
              f"{name}: image")
        if name == "config2":
            c2_image = d_img
        # runs in turns (serial, pipelined, pipelined, serial, ...), so
        # that a drift of the host's speed falls on both schedules alike
        s_ms, p_ms = [], []
        for i in range(DRIVER_REPEATS):
            turn = [(serial, s_ms), (driver, p_ms)]
            for fn, out in turn if i % 2 == 0 else turn[::-1]:
                out.append(host_ms(fn, 0, 1)[0] / DRIVER_PASSES)
        profiles = {"serial": driver_profile(serial),
                    "pipelined": driver_profile(driver)}
        # syncs of one steady iteration: 3 passes less 2
        three, two = sync_sites(lambda: piped(3)), sync_sites(lambda: piped(2))
        extra = {k: v - two.get(k, 0) for k, v in three.items()
                 if v != two.get(k, 0)}
        (s_med, s_spread), (p_med, p_spread) = summary(s_ms), summary(p_ms)
        results[name] = dict(serial=(s_med, s_spread),
                             pipelined=(p_med, p_spread), timings=timings,
                             profiles=profiles, syncs=extra)
        prof_txt = []
        for k, prof in profiles.items():
            if prof is None:
                prof_txt.append(f"{k}: the profiler saw no device operation")
                continue
            span, busy, gaps = prof
            prof_txt.append(
                f"{k} profile ({DRIVER_PASSES} passes): span {span:.1f} ms, "
                f"busy {busy:.1f} ms, idle {1 - busy / span:.1%}, largest "
                "gaps " + "; ".join(f"{g:.1f} ms {a} -> {b}"
                                     for g, a, b in gaps))
        lines.append(
            f"{name}: render_progressive and render_alvrl_progressive "
            f"bit-identical to render_alvrl pass after pass, serial "
            f"{s_med:.1f} ms a pass (spread "
            f"{s_spread:.1%}), pipelined {p_med:.1f} ms a pass (spread "
            f"{p_spread:.1%}; median of {DRIVER_REPEATS} runs of "
            f"{DRIVER_PASSES} passes each, in turns; serial "
            + " ".join(f"{t:.1f}" for t in s_ms) + ", pipelined "
            + " ".join(f"{t:.1f}" for t in p_ms)
            + "), pipelined stage sums (s): "
            + ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
            + " | " + " | ".join(prof_txt)
            + f" | syncs in one pipelined iteration: {sum(extra.values())} ("
            + ", ".join(f"{k} x{v}" for k, v in sorted(extra.items()))
            + "; the wait for R's copy is an event, not counted)")
    print(f"[34 pipelined vs serial schedule on {card}] " + " | ".join(lines),
          flush=True)
    return results, c2_image, configs[0]


def resume(dev, card, tmp, c2_image, c2):
    """Phase 35: 2 passes, then resume to DRIVER_PASSES, against
    DRIVER_PASSES in one run (phase 34's config-2 image of
    render_progressive), and the pass dumps' names."""
    _, scene, params, tcfg = c2
    ck, dumps = os.path.join(tmp, "ck.npz"), os.path.join(tmp, "passes")
    for n in (2, DRIVER_PASSES):
        img = render_progressive(scene, CLI_SEED, ProgressiveConfig(
            max_passes=n, clustered=True, checkpoint_path=ck,
            dump_passes=True, dump_dir=dumps), params, tracer_cfg=tcfg)
    check(np.array_equal(img, c2_image), "config 2: 2 passes and a resume "
          "are not the passes in one run")
    names = sorted(os.listdir(dumps))
    pattern = re.compile(r"^pass_p(\d{3})_wall\d\.\d{3}e[+-]\d{2}"
                         r"_renvrl\d\.\d{4}e[+-]\d{2}\.npy$")
    check(len(names) == DRIVER_PASSES and all(map(pattern.match, names))
          and [int(pattern.match(n).group(1)) for n in names]
          == list(range(DRIVER_PASSES)), f"pass dumps {names}")
    check(np.array_equal(np.load(os.path.join(dumps, names[-1])), c2_image),
          "the last dump is not the image")
    print(f"[35 checkpoint and resume on {card}] config 2: 2 passes + resume "
          f"to {DRIVER_PASSES} bit-identical to {DRIVER_PASSES} in one run; "
          f"dumps {names[0]} ... {names[-1]}", flush=True)


# phases 36-38: glass, a mirror and an area light. cornell_glass is
# config 1's box with its blocker a dielectric, its back wall a
# conductor, the point light, and cornell_area_light's ceiling quad as an
# area emitter
GLASS_ETA, BACK_ALBEDO = 1.5, [0.9, 0.9, 0.9]
BACK_FACES = (4, 6)      # the back wall's two triangles in cornell_smoke
AREA_HALF, AREA_RADIANCE, AREA_Y = 0.25, 6.0, 0.999
SPEC_SIZES = (WIDTH, 512)
SPEC_SEED = 3
# rays of each depth's kernel-1 launch held against the plain version:
# all of them at 128x128, a sample at 512x512
SPEC_HOLD = {WIDTH: None, 512: 4096}
SPEC_SAMPLE = 4096       # pixels of the plain chain's check
SPEC_REPEATS = 6         # timed renders
CLI_PARTICLES, CLI_VRLS = 128, 512  # render_cli's defaults, depth 16
GLASS_RUNS = [
    ("glass vrl", "cornell_glass.json", "vrl", 2,
     ["-D", f"w={WIDTH}", "-D", f"h={HEIGHT}"], ("vrl_sum",)),
    ("glass alvrl", "cornell_glass.json", "alvrl", 2,
     ["-D", f"w={WIDTH}", "-D", f"h={HEIGHT}"],
     ("vrl_r", "vrl_sum_clustered")),
    ("area light vrl", "cornell_area_light.xml", "vrl", 2, [],
     ("vrl_sum",)),
    ("area light alvrl", "cornell_area_light.xml", "alvrl", 2, [],
     ("vrl_r", "vrl_sum_clustered")),
]


def area_quad():
    """cornell_area_light's ceiling quad: (p0, e1, e2)."""
    p0 = [-AREA_HALF, AREA_Y, -AREA_HALF]
    return p0, [2 * AREA_HALF, 0.0, 0.0], [0.0, 0.0, 2 * AREA_HALF]


def glass_json(c1):
    """cornell_glass as a JSON scene dict, its size by -D w=... h=...:
    config 1's triangles as trimeshes by material, the blocker's of a
    dielectric, the back wall's of a conductor; the point light and the
    area quad."""
    desc = scene_json(c1, homog_medium(c1))
    v = c1.vertices.cpu().numpy()
    f = c1.faces.cpu().numpy()
    names = [f"m{int(m)}" for m in c1.material.cpu()]
    names[BACK_FACES[0]:BACK_FACES[1]] = ["back"] * 2
    names = ["glass" if n == f"m{presets.M_BOX}" else n for n in names]
    runs = np.split(np.arange(len(f)),
                    [i for i in range(1, len(f)) if names[i] != names[i - 1]])
    desc["shapes"] = [{"type": "trimesh", "material": names[r[0]],
                       "vertices": v[f[r]].reshape(-1).tolist(),
                       "faces": list(range(3 * len(r)))} for r in runs]
    desc["materials"] += [
        {"name": "back", "type": "conductor", "albedo": BACK_ALBEDO},
        {"name": "glass", "type": "dielectric", "eta": GLASS_ETA}]
    p0, e1, e2 = area_quad()
    desc["emitters"].append({"type": "area", "p0": p0, "e1": e1, "e2": e2,
                             "radiance": [AREA_RADIANCE] * 3})
    desc["camera"].update(width="$w", height="$h")
    return desc


def area_light_xml(c1, tmp):
    """cornell_area_light as a Mitsuba XML: config 1's box without its
    point light, and a rectangle with a nested area emitter whose toWorld
    maps the unit square onto the ceiling quad."""
    p0, e1, e2 = area_quad()
    h, y = AREA_HALF, AREA_Y
    quad = (f'<shape type="rectangle"><transform name="toWorld"><matrix '
            f'value="{h!r} 0 0 0  0 0 0 {y!r}  0 {h!r} 0 0  0 0 0 1"/>'
            f'</transform><emitter type="area"><rgb name="radiance" '
            f'value="{AREA_RADIANCE!r}"/></emitter></shape>')
    return box_xml(c1, tmp, lights=quad)


def scene_tensors(scene):
    """Every tensor of a scene, by name, on the CPU."""
    out = {k: getattr(scene, k).cpu() for k in ("vertices", "faces",
                                                 "material")}
    for part in ("materials", "emitters", "medium", "camera"):
        obj = getattr(scene, part)
        for k in obj.__dataclass_fields__:
            x = getattr(obj, k)
            out[f"{part}.{k}"] = x.cpu() if isinstance(x, torch.Tensor) else x
    return out


def glass_files(dev, card, tmp, c1):
    """Phase 36: writes cornell_glass (JSON) and cornell_area_light (JSON
    and XML) into `tmp`; each loads on the card as on the CPU, bit for
    bit, and cornell_area_light as the ported preset."""
    with open(os.path.join(tmp, "cornell_glass.json"), "w") as f:
        f.write(json.dumps(glass_json(c1)).replace('"$w"', "$w")
                .replace('"$h"', "$h"))
    area = scene_json(c1, homog_medium(c1))
    p0, e1, e2 = area_quad()
    area["emitters"] = [{"type": "area", "p0": p0, "e1": e1, "e2": e2,
                         "radiance": [AREA_RADIANCE] * 3}]
    with open(os.path.join(tmp, "cornell_area_light.json"), "w") as f:
        json.dump(area, f)
    with open(os.path.join(tmp, "cornell_area_light.xml"), "w") as f:
        f.write(area_light_xml(c1, tmp))

    def load(name, device, **defines):
        path = os.path.join(tmp, name)
        if name.endswith(".xml"):
            return loader.build_scene(loader.convert_mitsuba_xml(path),
                                      device=device)
        return loader.load_json(path, defines, device=device)

    preset = presets.cornell_area_light(WIDTH, HEIGHT, device=dev)
    lines = []
    for name, defines in (("cornell_glass.json", dict(w=WIDTH, h=HEIGHT)),
                          ("cornell_glass.json", dict(w=512, h=512)),
                          ("cornell_area_light.json", {}),
                          ("cornell_area_light.xml", {})):
        ours, cpu = load(name, dev, **defines), load(name, "cpu", **defines)
        a, b = scene_tensors(ours), scene_tensors(cpu)
        for k in a:
            check((torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
                   else a[k] == b[k]), f"{name}: {k} on the card is not the "
                  "CPU build's")
        if name.startswith("cornell_area_light"):
            check(same_scene(ours, preset), f"{name} is not the preset "
                  "cornell_area_light")
        kinds = sorted(set(ours.materials.kind.tolist()))
        lines.append(f"{name} {ours.camera.width}x{ours.camera.height}: "
                     f"{ours.faces.shape[0]} triangles, material kinds "
                     f"{kinds}, emitter kinds {ours.emitters.host_kinds}, "
                     "the card's tensors the CPU build's bit for bit"
                     + (", equal to the preset" if name.startswith(
                         "cornell_area_light") else ""))
    print(f"[36 glass and area-light scene files on {card}] "
          + " | ".join(lines), flush=True)


def spec_render(dev, card, tmp):
    """Phase 37: render_with_vrls_kernel_spec on cornell_glass at 128x128
    and 512x512 against VRLs traced on the card at the CLI's defaults."""
    cfg, spec_cfg = VRLConfig(), specular.SpecularConfig()
    tcfg = tracer.TracerConfig()
    lines = []
    for size in SPEC_SIZES:
        scene = loader.load_json(os.path.join(tmp, "cornell_glass.json"),
                                 {"w": size, "h": size}, device=dev)
        vrls = vrl.compact(tracer.trace(
            scene, torch.Generator().manual_seed(SPEC_SEED), CLI_PARTICLES,
            tcfg), CLI_VRLS, slots_per_particle=tcfg.max_depth)
        n_rays = size * size

        def render(**kw):
            return integrator.render_with_vrls_kernel_spec(
                scene, vrls, torch.Generator().manual_seed(SPEC_SEED), cfg,
                spec_cfg, **kw)

        # the main path: one render, kernel 1's launches counted
        vrl_sum.launches = 0
        with plain_calls() as plain, kernel1_launches() as records:
            img = render()
            torch.cuda.synchronize()
        launches = vrl_sum.launches
        check(launches == len(records) and launches >= 2,
              f"{size}: kernel 1 launched {launches} times for "
              f"{len(records)} depths")
        check(plain[0] == 0, f"{size}: {plain[0]} plain-version calls")
        check(tuple(img.shape) == (size, size, 3)
              and bool(torch.isfinite(img).all())
              and float(img.abs().max()) > 0.0,
              f"{size}: the image is not finite and non-zero")
        active = [r[0].shape[1] for r in records]
        check(active[0] == n_rays and all(
            a > b for a, b in zip(active, active[1:])),
            f"{size}: active rays per depth {active}")
        hold = hold_kernel1(f"spec {size}", records, SPEC_HOLD[size])
        totals = dict.fromkeys(vs.CHECK_COUNTS, 0)
        for (rays, vpk, tris, med, seed, svv, svs, short, kind, _,
             mats) in records:
            _, counts = vs.vrl_sum_check(
                rays, vpk, tris, med, seed=seed, vol_vol_samples=svv,
                vol_surf_samples=svs, short_vrls=short, phase_kind=kind,
                materials=mats)
            check(counts["bad_tris"] == 0 and counts["bad_segments"] == 0,
                  f"{size}: the pre-reject disagrees at a depth: {counts}")
            for k, v in counts.items():
                totals[k] += v
        depth_ms = [summary(cuda_ms(
            lambda r=r: vrl_sum(*r[:4], seed=r[4], **(
                {} if r[10] is None else {"materials": r[10]})), 2, 10))[0]
            for r in records]
        del records[:]
        chain_line = ""
        if size == WIDTH:
            # the plain chain on a sample of pixels, the same uniforms
            u_sums = torch.rand(
                (spec_cfg.max_depth + 1, n_rays, CLI_VRLS,
                 2 * cfg.vol_vol_samples + cfg.vol_surf_samples),
                generator=torch.Generator(dev).manual_seed(SPEC_SEED),
                device=dev)
            injected = render(uniforms=u_sums).reshape(-1, 3)
            u_chain = integrator._chain_draws(
                torch.Generator().manual_seed(SPEC_SEED), spec_cfg, n_rays,
                dev)[0]
            pick = torch.as_tensor(np.sort(np.random.default_rng(1).choice(
                n_rays, SPEC_SAMPLE, replace=False)), device=dev)
            _, _, ray_o, ray_d = integrator.frame_rays(scene)
            plain_li = integrator.li_unclustered_spec_u(
                scene, ray_o[pick], ray_d[pick], vrls, u_chain[:, pick],
                u_sums[:, pick], cfg, spec_cfg)
            median, share = homog_bar(injected[pick], plain_li)
            check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
                  f"the plain chain on {SPEC_SAMPLE} pixels: median "
                  f"{median}, share {share}")
            del u_sums
            chain_line = (f", plain chain (li_unclustered_spec_u) on "
                          f"{SPEC_SAMPLE} pixels with the render's injected "
                          f"uniforms: median {median:.2e} share>1e-2 "
                          f"{share:.4f}")
        # no plain version on the timed path
        with plain_calls() as plain:
            c_ms = host_ms(render, 1, SPEC_REPEATS)
        check(plain[0] == 0, f"{size}: plain-version calls while timed")
        prof = profile_device(render, 1, 4)
        c_med, c_spread = summary(c_ms)
        prof_line = ("the profiler saw no device operation: idle not "
                     "measured") if prof is None else (
            f"profile: device span {prof[0]:.2f} ms, busy {prof[1]:.2f} ms, "
            f"idle share {1 - prof[1] / prof[0]:.1%}, {prof[2]:g} device ops "
            "a render")
        lines.append(
            f"{size}x{size} ({n_rays} rays x {int(vrls.valid.sum())} of "
            f"{vrls.capacity} VRLs, {scene.faces.shape[0]} triangles): "
            f"vrl_sum launches {launches}, active rays per depth "
            + " ".join(map(str, active))
            + f", image mean {float(img.mean()):.6g}; {hold}; checking "
            f"launches on every depth: {check_line(totals)}{chain_line} | "
            f"ms per render {c_med:.2f} (spread {c_spread:.1%}; "
            + " ".join(f"{t:.2f}" for t in c_ms) + ") | kernel 1 ms per "
            "depth's launch (CUDA events) "
            + " ".join(f"{t:.3f}" for t in depth_ms) + f" | {prof_line}")
    print(f"[37 specular-chain render on {card}] " + " | ".join(lines),
          flush=True)


def glass_cli(dev, card, tmp):
    """Phase 38: the CLI on cornell_glass and cornell_area_light with both
    integrators, and the tracer on cornell_glass on the card against the
    tracer on the CPU, on the same uniforms."""
    out = cli_runs(dev, card, tmp, GLASS_RUNS, "38 the CLI on glass and an "
                   "area light")
    path = os.path.join(tmp, "cornell_glass.json")
    tcfg = tracer.TracerConfig()
    rng = np.random.default_rng(38)
    u_emit = torch.as_tensor(rng.random((CLI_PARTICLES, tracer.N_EMIT_DIMS),
                                        dtype=np.float32))
    u_walk = torch.as_tensor(rng.random(
        (CLI_PARTICLES, tcfg.max_depth, tracer.N_STEP_DIMS), dtype=np.float32))
    traced = [tracer.trace_u(
        loader.load_json(path, {"w": WIDTH, "h": HEIGHT}, device=d),
        u_emit.to(d), u_walk.to(d), tcfg) for d in (dev, "cpu")]
    ours, ref = traced[0], traced[1]
    ok = ref.valid
    check(torch.equal(ours.valid.cpu(), ok), "the card's tracer stores other "
          "slots than the CPU's")
    err = max(float((getattr(ours, k).cpu()[ok] - getattr(ref, k)[ok])
                    .abs().max()) for k in ("start", "end"))
    median, share = homog_bar(ours.power.cpu()[ok], ref.power[ok])
    check(err < 1e-4 and median < HOMOG_MEDIAN and share < HOMOG_SHARE,
          f"tracer on the card vs the CPU: positions {err}, powers median "
          f"{median} share {share}")
    print(f"[38 the tracer on cornell_glass on {card}] {CLI_PARTICLES} "
          f"particles x depth {tcfg.max_depth}: {int(ok.sum())} valid slots, "
          f"the same as the CPU tracer's on the same uniforms; positions "
          f"within {err:.2e}, powers median {median:.2e} share>1e-2 "
          f"{share:.4f}", flush=True)
    return out


# phases 39-42: glossy and layered surfaces. cornell_glossy is config 1's
# box, its walls, its blocker and a second block carrying the eleven
# smooth kinds, each kind on a face that the camera sees over at least
# 794 of the 16,384 pixels (4.8 %), so that phase 40 holds each kind
# alone: the walls' triangles one kind each (floor rough conductor and
# plastic, ceiling Phong and diffuse transmission, back wall Ward and the
# mixture, left wall rough plastic and the mask over it, right wall the
# coat over white diffuse and the rough dielectric; the unseen front wall
# Phong), the blocker a rough coat over diffuse transmission, the second
# block rough dielectric; the point light, 128x128, as a JSON (its size
# by -D) and a Mitsuba XML (OBJ parts)
GLOSSY_MATERIALS = [
    {"name": "white", "type": "diffuse", "albedo": [0.725, 0.71, 0.68]},
    {"name": "rc", "type": "roughconductor", "albedo": [0.9, 0.6, 0.3],
     "alpha": 0.3, "alpha_v": 0.15, "distribution": "beckmann"},
    {"name": "pl", "type": "plastic", "albedo": [0.5, 0.2, 0.2],
     "eta": 1.5},
    {"name": "ph", "type": "phong", "albedo": [0.4, 0.3, 0.2],
     "specular": [0.3, 0.3, 0.3], "exponent": 20.0},
    {"name": "dt", "type": "difftrans", "albedo": [0.6, 0.6, 0.5]},
    {"name": "wd", "type": "ward", "albedo": [0.2, 0.4, 0.3],
     "specular": [0.2, 0.2, 0.25], "alpha": 0.2, "alpha_v": 0.35},
    {"name": "mx", "type": "mixture", "weight": 0.3, "nested": "ph",
     "nested2": "wd"},
    {"name": "rp", "type": "roughplastic", "albedo": [0.3, 0.5, 0.6],
     "alpha": 0.2, "distribution": "ggx"},
    {"name": "mk", "type": "mask", "opacity": 0.6, "nested": "rp"},
    {"name": "co", "type": "coating", "eta": 1.4, "thickness": 0.5,
     "sigma_a": [0.1, 0.2, 0.3], "nested": "white"},
    {"name": "rd", "type": "roughdielectric", "eta": 1.5, "alpha": 0.25,
     "distribution": "phong"},
    {"name": "rco", "type": "roughcoating", "eta": 1.5, "alpha": 0.6,
     "thickness": 0.3, "sigma_a": [0.05, 0.1, 0.0], "nested": "dt",
     "distribution": "beckmann"},
]
# the material of each triangle: config 1's 12 wall triangles (floor,
# ceiling, back, front, left, right; two a wall), its blocker's 12, the
# second block's 12
GLOSSY_FACES = (["rc", "pl", "ph", "dt", "wd", "mx", "ph", "ph", "rp", "mk",
                 "co", "rd"] + ["rco"] * 12 + ["rd"] * 12)
GLOSSY_KINDS = bsdf_api.MATERIAL_FORM_KINDS - bsdf_api.DELTA_KINDS - {
    bsdf_api.DIFFUSE}
GLOSSY_KIND_RAYS = 512  # fewest eye rays of a kind that phase 40 holds
R_KIND_RAYS = 256       # rays of each kind in kernel 5's injected hold
# phase 42: the second block glass; each depth's launch held on this many
# of its rays, the plain chain on the glass pixels and this many others
GLASS_BLOCK = {"name": "glass", "type": "dielectric", "eta": 1.5}
SPEC_GLOSSY_HOLD, SPEC_GLOSSY_OTHERS = 2048, 1024
BLOCK2_SCALE, BLOCK2_AT = (0.2, 0.3, 0.2), (0.45, -0.7, 0.45)
GLOSSY_SEED = 20261018
GLOSSY_PARAMS = dict(vrl_target_num=512, num_particles=128, seed=0)
GLOSSY_RUNS = [
    ("glossy vrl", "cornell_glossy.xml", "vrl", 2, [], ("vrl_sum",)),
    ("glossy alvrl", "cornell_glossy.xml", "alvrl", 2, [],
     ("vrl_r", "vrl_sum_clustered")),
]
# a lower bound, by OPS's rules, of one eval_smooth (vrl_common.cuh) at
# an open vol-surf sample of the material kernels, whatever the kind:
# the frame (12, 1), the two local directions (30) and the cheapest
# leaf, the diffuse one (5, 1)
OPS["eval_smooth"] = (47, 2)
# the diffuse instantiations' outputs of kernels 1, 2 and 5 on config 1
# before the material instantiations were added: kernel_digest.py on the
# parent tree (alvrl_tpu_torch/scripts/kernel_digest.py --root), NVIDIA
# H100 80GB HBM3, 700.00 W; this run's must be equal
# the outputs of every earlier form of kernels 1, 2 and 5 (kernel_digest.py
# --all, on the parent tree): the diffuse HG short-VRL ones, the Rayleigh,
# long-VRL and material ones
PARENT_DIGESTS_ALL = {
    "vrl_sum rayleigh":
        "f94c6ffaa700e7a6762341d3e6921d6c67cb5a8f6f8b74cd6381511f2f2dc823",
    "vrl_sum_clustered rayleigh":
        "08eeb3fc3cf2bca331b6d775e69ec13696ccd913d80e4e26b4119250cbe432b2",
    "vrl_r rayleigh":
        "b1fe8b243cf6e2f3f0101afc3fa798c2b773a0f5a09744eed6739d85c650604e",
    "vrl_sum long":
        "ce3d5f70c54ce08d5b2411a8afd1dd278927adb9311bb84af3d9d6a473509b26",
    "vrl_sum_clustered long":
        "46ad7500dbdea00f5100d09a6ebccdf3f0fe309df1fc061e37ea020fe1499378",
    "vrl_r long":
        "59f849ae377ef896ea1189acddfa4e3018eb76f700423906a5d045acdbc9065b",
    "vrl_sum material":
        "c8aeb437f1fca85872cea659d8bbe3c3690e35e1a7a3b11ef93264131bbeda48",
    "vrl_sum_clustered material":
        "d413da2c3164993d58570da47aa155948b3424b0c9f4e92882f0f5c91ae4b098",
    "vrl_r material":
        "3080319c232198fe49781dbbd5845e6af5a7eeed74187d81885e40f9f1e7aec1",
}
PARENT_DIGESTS = {
    "vrl_sum injected":
        "a28bb9c116fe6eac14d9563b8ed0e1e861444d4548d82320e80cc3471af65229",
    "vrl_sum philox":
        "93fdbe4c1cc6631d4c43c10d700ec93599e3554bfbc9924f101c5a45217920ea",
    "vrl_sum_clustered injected":
        "b449e5a6ca071e1a37424b09198a9acc7ebb4ec15a91e13f7bdb60382ebd31ba",
    "vrl_sum_clustered philox":
        "3bd6f33cecb59227577e45331793792fc7f03268b5ca44b8fca4ad783323b987",
    "vrl_r injected":
        "841dd3f144df585b85081195c95dbf3c8a9b76497221187e1a865ab2834c9257",
    "vrl_r philox":
        "8f2b73b5f3403d7de1b2850fed23bc4a90fd5ce3aa1e43ff5ac18bb3258556cc",
}
PARENT_DIGESTS_ALL.update(PARENT_DIGESTS)


def glossy_json(c1):
    """cornell_glossy as a JSON scene dict (module comment), its size by
    -D w=... h=...: the triangles as trimeshes by runs of one material."""
    from alvrl_tpu_torch.geometry import shapes as shp

    bv, bf = shp.cube()
    bv = bv * np.asarray(BLOCK2_SCALE, np.float32) + np.asarray(
        BLOCK2_AT, np.float32)
    v = np.concatenate([c1.vertices.cpu().numpy()[c1.faces.cpu().numpy()]
                        .reshape(-1, 3), bv[bf].reshape(-1, 3)])
    tris = v.reshape(-1, 3, 3)
    check(len(tris) == len(GLOSSY_FACES), f"{len(tris)} triangles")
    runs = np.split(np.arange(len(tris)), [
        i for i in range(1, len(tris))
        if GLOSSY_FACES[i] != GLOSSY_FACES[i - 1]])
    desc = scene_json(c1, homog_medium(c1))
    desc["materials"] = GLOSSY_MATERIALS
    desc["shapes"] = [{"type": "trimesh", "material": GLOSSY_FACES[r[0]],
                       "vertices": tris[r].reshape(-1).tolist(),
                       "faces": list(range(3 * len(r)))} for r in runs]
    desc["camera"].update(width="$w", height="$h")
    return desc


def bsdf_xml(m):
    """One material of GLOSSY_MATERIALS as a Mitsuba <bsdf>, in the
    property names the XML converter reads."""
    rgb = lambda n, v: (f'<rgb name="{n}" value="'  # noqa: E731
                        + ", ".join(map(repr, v)) + '"/>')
    flt = lambda n, v: f'<float name="{n}" value="{v!r}"/>'  # noqa: E731
    parts = []
    for key, name, fmt in (
            ("albedo", "reflectance", rgb), ("eta", "intIOR", flt),
            ("alpha", "alphaU" if "alpha_v" in m else "alpha", flt),
            ("alpha_v", "alphaV", flt), ("exponent", "exponent", flt),
            ("specular", "specularReflectance", rgb),
            ("opacity", "opacity", flt), ("weight", "weight", flt),
            ("sigma_a", "sigmaA", rgb), ("thickness", "thickness", flt)):
        if key in m:
            parts.append(fmt(name, m[key]))
    if "distribution" in m:
        parts.append(f'<string name="distribution" '
                     f'value="{m["distribution"]}"/>')
    parts += [f'<ref id="{m[k]}"/>' for k in ("nested", "nested2") if k in m]
    return (f'<bsdf type="{m["type"]}" id="{m["name"]}">' + "".join(parts)
            + "</bsdf>")


def glossy_xml(desc, c1, tmp):
    """cornell_glossy as a Mitsuba XML at 128x128: an OBJ a trimesh of
    `desc`, its materials as <bsdf>s, config 1's camera, light and
    medium (box_xml's)."""
    shapes = []
    for k, sh in enumerate(desc["shapes"]):
        tri = np.asarray(sh["vertices"], np.float32).reshape(-1, 3)
        write_obj(os.path.join(tmp, f"glossy{k}.obj"), tri,
                  np.arange(len(tri)).reshape(-1, 3))
        shapes.append(f'<shape type="obj"><string name="filename" '
                      f'value="glossy{k}.obj"/><ref id="{sh["material"]}"/>'
                      "</shape>")
    med, em = c1.medium, c1.emitters
    vec = lambda t: ", ".join(map(repr, t.cpu().tolist()))  # noqa: E731
    return f"""<scene version="0.5.0">
  <sensor type="perspective">
    <float name="fov" value="{PRESET_CAMERA['fov']}"/>
    <transform name="toWorld"><lookat origin="0, 0, -0.99" target="0, 0, 1"
      up="0, 1, 0"/></transform>
    <film type="hdrfilm"><integer name="width" value="{WIDTH}"/>
      <integer name="height" value="{HEIGHT}"/></film>
  </sensor>
  {"".join(bsdf_xml(m) for m in GLOSSY_MATERIALS)}
  {"".join(shapes)}
  <emitter type="point"><point name="position" value="{vec(em.position[0])}"/>
    <rgb name="intensity" value="{vec(em.intensity[0])}"/></emitter>
  <medium type="homogeneous" id="smoke">
    <rgb name="sigmaS" value="{vec(med.sigma_s)}"/>
    <rgb name="sigmaA" value="{vec(med.sigma_a)}"/>
    <phase type="hg"><float name="g" value="{float(med.g)!r}"/></phase>
  </medium>
</scene>"""


def glossy_files(dev, card, tmp, c1):
    """Phase 39: writes cornell_glossy as JSON and Mitsuba XML into `tmp`;
    each loads on the card as on the CPU, bit for bit, and the XML as the
    JSON. Returns the JSON's scene on the card at 128x128."""
    desc = glossy_json(c1)
    with open(os.path.join(tmp, "cornell_glossy.json"), "w") as f:
        f.write(json.dumps(desc).replace('"$w"', "$w").replace('"$h"', "$h"))
    with open(os.path.join(tmp, "cornell_glossy.xml"), "w") as f:
        f.write(glossy_xml(desc, c1, tmp))

    def load(name, device):
        path = os.path.join(tmp, name)
        if name.endswith(".xml"):
            return loader.build_scene(loader.convert_mitsuba_xml(path),
                                      device=device)
        return loader.load_json(path, {"w": WIDTH, "h": HEIGHT},
                                device=device)

    scenes = {}
    for name in ("cornell_glossy.json", "cornell_glossy.xml"):
        ours, cpu = load(name, dev), load(name, "cpu")
        a, b = scene_tensors(ours), scene_tensors(cpu)
        for k in a:
            check((torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
                   else a[k] == b[k]), f"{name}: {k} on the card is not the "
                  "CPU build's")
        scenes[name] = ours
    a, b = (scene_tensors(s) for s in scenes.values())
    check(all(torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
              else a[k] == b[k] for k in a), "the XML's scene is not the "
          "JSON's")
    scene = scenes["cornell_glossy.json"]
    kinds = bsdf_api.check_kinds(scene)
    check(kinds == bsdf_api.MATERIAL_FORM_KINDS - bsdf_api.DELTA_KINDS,
          f"cornell_glossy's kinds {sorted(kinds)}")
    print(f"[39 glossy scene files on {card}] cornell_glossy "
          f"{WIDTH}x{HEIGHT}: {scene.faces.shape[0]} triangles, material "
          f"kinds {sorted(kinds)}, the card's tensors the CPU build's bit "
          "for bit (rough-transmittance tables included), the XML's scene "
          "the JSON's", flush=True)
    return scene


def hold_by_kind(label, out, ref, kind, channels=3,
                 min_items=GLOSSY_KIND_RAYS, kinds=GLOSSY_KINDS):
    """out against ref at the homogeneous bar over each eye-hit kind alone
    (every kind of `kinds`, min_items items at least); returns a line of
    text."""
    groups = homog_bar_by_kind(out, ref, kind, channels)
    check(set(groups) == set(kinds), f"{label}: the kinds held "
          f"{sorted(groups)}")
    for k, (n, median, share) in groups.items():
        check(n >= min_items and median < HOMOG_MEDIAN
              and share < HOMOG_SHARE, f"{label}: kind {k} ({n} items)"
              f" median {median}, share {share}")
    n, med, sh = (max(g[i] if i else -g[0] for g in groups.values())
                  for i in range(3))
    return (f"{label}: {len(groups)} kinds held alone, each of "
            f"{-n} items or more, worst median {med:.2e}, worst "
            f"share>1e-2 {sh:.4f}")


def glossy_kernels(dev, card, scene, vrls):
    """Phase 40: the material instantiations of kernels 1, 2 and 5 on
    cornell_glossy against their plain versions, the diffuse ones
    against the parent's, the main path's launches, times, registers,
    bounds and a profile. Returns the kernels line's three entries."""
    cfg = VRLConfig()
    n_rays, n_vrls = WIDTH * HEIGHT, vrls.capacity
    mats = integrator.material_pack(scene)
    check(mats is not None, "cornell_glossy takes no material pack")
    packs = integrator.pack_frame(scene, vrls, materials=mats)[3]
    dpacks = integrator.pack_frame(scene, vrls)[3]
    check(packs[0].shape == (pk.MAT_RAY_ROWS, n_rays)
          and torch.equal(packs[0][:pk.RAY_ROWS], dpacks[0]),
          "the material ray pack")
    # kernel 1's Philox hold on the seed of the main path's render below,
    # so that its plain sums give the plain render; kernels 2 and 5 on
    # their own
    r_seed = integrator.draw_seed(torch.Generator().manual_seed(1))
    seed = GLOSSY_SEED
    mkw = dict(materials=mats)
    rng = np.random.default_rng(40)
    u_inj = torch.as_tensor(rng.random((n_rays, n_vrls, 6),
                                       dtype=np.float32), device=dev)
    ray_kind = mats[0][packs[0][pk.MATID].long(), pk.MT_KIND].long()
    smooth = mats[0][:, pk.MT_SMOOTH] > 0.5
    surf = smooth[packs[0][pk.MATID].long()]
    errs, lines, plain_ms = {}, [], {}

    # kernel 1: injected (its plain version timed) and Philox (its samples
    # counted), and its checking launch
    u_philox = philox_uniforms(r_seed, n_rays, n_vrls, 6, device=dev)
    for mode, u in (("injected", u_inj), ("philox", u_philox)):
        out = vrl_sum(*packs, seed=r_seed,
                      uniforms=None if mode == "philox" else u, **mkw)
        if mode == "injected":
            ref, plain_ms["vrl_sum"] = timed_call(
                lambda: vrl_sum_reference(*packs, u, **mkw))
        else:
            with SweepCount((packs[0][pk.VALID] > 0.5)[:, None]
                            & (packs[1][pk.VVALID] > 0.5)[None], surf) as s1:
                ref = vrl_sum_reference(*packs, u, **mkw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()) and float(out.sum()) > 0.0,
              f"kernel 1 (material) {mode}: not finite and positive")
        lines.append(hold_by_kind(f"kernel 1 {mode}", out.T, ref.T,
                                  ray_kind))
        errs["vrl_sum"] = max(errs.get("vrl_sum", 0.0),
                              float((out - ref).abs().max()))
    k1_ref = ref
    out_c, k1_counts = vs.vrl_sum_check(*packs, seed=r_seed, **mkw)
    check(k1_counts["bad_tris"] == 0 and k1_counts["bad_segments"] == 0,
          f"kernel 1 (material): the pre-reject disagrees: {k1_counts}")
    check(torch.equal(out_c, out), "kernel 1 (material): the checking "
          "launch is not the sum's")
    lines.append(f"kernel 1's checking launch: {check_line(k1_counts)}")
    del u_philox

    # kernel 2 on the scene's own clustering (R through kernel 5's
    # material instantiation), and its checking launch
    params = alvrl.ALVRLParams(**GLOSSY_PARAMS,
                               cluster=cl.ClusterParams(**C2_CLUSTER))
    info = alvrl.build_slice_info(scene, params)
    sop, tv, tw, _ = alvrl.prepare_clustering(scene, vrls, seed, params, cfg,
                                              info)
    n_cols = tv.shape[1]
    u_cinj = torch.as_tensor(rng.random((n_rays, n_cols, 6),
                                        dtype=np.float32), device=dev)
    u_c = philox_table_uniforms(seed, sop, tv, 6)
    for mode, u in (("injected", u_cinj), ("philox", u_c)):
        kw = dict(seed=seed, uniforms=None if mode == "philox" else u, **mkw)
        out = vrl_sum_clustered(*packs, sop, tv, tw, **kw)
        again = vrl_sum_clustered(*packs, sop, tv, tw, **kw)
        if mode == "injected":
            ref, plain_ms["vrl_sum_clustered"] = timed_call(
                lambda: vrl_sum_clustered_reference(*packs, sop, tv, tw, u,
                                                    **mkw))
        else:
            with SweepCount(table_pair_ok(packs[0], packs[1], sop, tv, tw),
                            surf) as s2:
                ref = vrl_sum_clustered_reference(*packs, sop, tv, tw, u,
                                                  **mkw)
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"kernel 2 (material) {mode}: a "
              "repeat is not bit-identical")
        lines.append(hold_by_kind(f"kernel 2 {mode} ({n_cols} columns)", out.T,
                          ref.T, ray_kind))
        errs["vrl_sum_clustered"] = max(errs.get("vrl_sum_clustered", 0.0),
                                        float((out - ref).abs().max()))
    c_chk, c_counts = vrl_sum_clustered_check(*packs, sop, tv, tw, seed=seed,
                                              **mkw)
    check(c_counts["bad_tris"] == 0 and c_counts["bad_segments"] == 0
          and torch.equal(c_chk, out), f"kernel 2 (material): the checking "
          f"launch: {c_counts}")
    del u_cinj, u_c

    # kernel 5: injected on R_KIND_RAYS eye rays of each kind, each kind
    # held alone; Philox on the clustering's representative rays (the
    # main path's shape: its plain version timed and its samples counted)
    pick = np.concatenate([rng.choice(
        np.flatnonzero(ray_kind.cpu().numpy() == k), R_KIND_RAYS,
        replace=False) for k in sorted(GLOSSY_KINDS)])
    pick = torch.as_tensor(pick, device=dev)
    kpacks = (packs[0][:, pick].contiguous(), *packs[1:])
    u_k = u_inj[pick].contiguous()
    rows = torch.as_tensor(np.concatenate(info.repr_rows), device=dev)
    ray_o, ray_d = perspective.sample_ray(scene.camera, rows % WIDTH,
                                          rows // WIDTH)
    rpacks = integrator.pack_rays_vrls(scene, ray_o, ray_d, vrls, mats)[1]
    n_rep = rpacks[0].shape[1]
    u_r = philox_uniforms(seed, n_rep, n_vrls, 6, device=dev)
    for mode, p, u in (("injected", kpacks, u_k), ("philox", rpacks, u_r)):
        out = vrl_r(*p, seed=seed,
                    uniforms=None if mode == "philox" else u, **mkw)
        if mode == "injected":
            ref = vrl_r_reference(*p, u, **mkw)
        else:
            rsurf = smooth[p[0][pk.MATID].long()]
            with SweepCount((p[0][pk.VALID] > 0.5)[:, None]
                            & (p[1][pk.VVALID] > 0.5)[None], rsurf) as s5:
                ref = vrl_r_reference(*p, u, **mkw)
            _, plain_ms["vrl_r"] = timed_call(
                lambda: vrl_r_reference(*p, u, **mkw))
        torch.cuda.synchronize()
        if mode == "injected":
            kind = ray_kind[pick][:, None].expand(-1, n_vrls)
            text = hold_by_kind(f"kernel 5 injected ({len(pick)} rays, "
                        f"{R_KIND_RAYS} of each kind) mean", out[0], ref[0],
                        kind, 1, R_KIND_RAYS * n_vrls)
        else:
            median, share = homog_bar(out[0], ref[0], channels=1)
            check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
                  f"kernel 5 (material) {mode}: median {median}, share "
                  f"{share}")
            text = (f"kernel 5 philox ({n_rep} representative rays) mean "
                    f"median {median:.2e} share>1e-2 {share:.4f}")
        nz = ref[1] > R_VAR_FLOOR
        v_med = float(((out[1] - ref[1]).abs()[nz] / ref[1][nz]).median())
        check(v_med < R_VAR_MEDIAN, f"kernel 5 (material) {mode} var "
              f"{v_med}")
        errs["vrl_r"] = max(errs.get("vrl_r", 0.0),
                            float((out - ref).abs().max()))
        lines.append(f"{text}, var median {v_med:.2e}")
    r_chk, r_counts = vrl_r_check(*rpacks, seed=seed, **mkw)
    check(r_counts["bad_tris"] == 0 and r_counts["bad_segments"] == 0,
          f"kernel 5 (material): the checking launch: {r_counts}")

    # the diffuse instantiations, bit for bit the parent's on config 1
    digests = kernel_digest.kernel_digests(dev)
    check(digests == PARENT_DIGESTS, "the diffuse instantiations' outputs "
          f"are not the parent's: {digests}")
    lines.append("the diffuse instantiations of kernels 1, 2 and 5 on "
                 "config 1 (kernel_digest.py: injected and Philox) bit for "
                 "bit the parent's")
    print(f"[40a material kernels vs plain on {card}, B={n_rays} "
          f"N={n_vrls} T={scene.faces.shape[0]} M={mats[0].shape[0]}] "
          + " | ".join(lines), flush=True)
    del u_inj, u_k

    # the main path: the unclustered and the clustered render
    for fn in (vrl_sum, vrl_r, vrl_sum_clustered):
        fn.launches = 0
    with plain_calls() as plain:
        img = integrator.render_with_vrls_kernel(
            scene, vrls, torch.Generator().manual_seed(1), cfg)
        img_c, _, _ = alvrl.render_alvrl(
            scene, torch.Generator().manual_seed(2), params, cfg,
            slice_info=info)
        torch.cuda.synchronize()
    launches = {"vrl_sum": vrl_sum.launches, "vrl_r": vrl_r.launches,
                "vrl_sum_clustered": vrl_sum_clustered.launches}
    check(min(launches.values()) >= 1 and plain[0] == 0,
          f"the main path's launches {launches}, plain calls {plain[0]}")
    for name, im in (("unclustered", img), ("clustered", img_c)):
        check(tuple(im.shape) == (HEIGHT, WIDTH, 3)
              and bool(torch.isfinite(im).all())
              and float(im.abs().max()) > 0.0, f"the {name} image")
    # the plain render: kernel 1's Philox hold's plain sums (the render's
    # seed and packs)
    px, py, hit, _ = integrator.pack_frame(scene, vrls, materials=mats)
    plain_img = integrator.develop_sums(scene, vrls, px, py, hit, k1_ref)
    median, share = homog_bar(img, plain_img)
    check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
          f"render vs plain render: median {median}, share {share}")
    diffuse_img = integrator.develop_sums(scene, vrls, px, py, hit,
                                          vrl_sum(*dpacks, seed=r_seed))
    ratio = float(img.mean()) / float(diffuse_img.mean())
    print(f"[40b the main path on {card}] cornell_glossy {WIDTH}x{HEIGHT}: "
          "render_with_vrls_kernel (the bench VRLs) and render_alvrl ("
          f"{params.num_particles} particles, {params.vrl_target_num} VRLs)"
          f": launches {launches}, no plain version; image means "
          f"{float(img.mean()):.6g} and {float(img_c.mean()):.6g}; the "
          f"unclustered against the plain render median {median:.2e} "
          f"share>1e-2 {share:.4f}; against the diffuse instantiation on "
          f"the same packs (no eye-side term at the glossy hits) x"
          f"{ratio:.4f}", flush=True)

    # times: each material launch beside the diffuse one, in turns
    # (diffuse, material, material, diffuse), on cornell_glossy (the
    # diffuse packs there hold albedo 0 at every hit: no vol-surf sample)
    # and on config 1 (its diffuse table packed for the material
    # instantiation: the same samples, the eval in place of albedo
    # cos / pi), the plain versions, registers and bounds
    c1 = presets.cornell_smoke(WIDTH, HEIGHT, device=dev)
    c1_mats = pk.pack_materials(c1.materials)
    c1_mpacks = integrator.pack_frame(c1, vrls, materials=c1_mats)[3]
    c1_packs = integrator.pack_frame(c1, vrls)[3]
    c1_sop = np.arange(n_rays, dtype=np.int32) // kernel_digest.SLICE_PIXELS
    c1_tv = torch.as_tensor(rng.integers(0, n_vrls, (
        kernel_digest.N_SLICES, kernel_digest.N_COLS)), dtype=torch.int32,
        device=dev)
    c1_tw = torch.ones(c1_tv.shape, device=dev)
    c1_reps = torch.as_tensor(rng.choice(n_rays, n_rep, replace=False),
                              device=dev)
    c1_rays = (c1_packs[0][:, c1_reps].contiguous(),
               c1_mpacks[0][:, c1_reps].contiguous())
    r_diff = rpacks[0][:pk.RAY_ROWS].contiguous()
    c_block = vsc.ray_block(False)
    c_out = torch.zeros((3, n_rays), device=dev)

    def c_launch(p, sl, ids, w, **kw):
        tiles = [torch.as_tensor(a, device=dev)
                 for a in group_by_slice(sl, c_block)]
        return lambda: vsc._launch(
            vsc._library(), *p, *tiles, ids, w, None, seed, 2, 2, True,
            scene.medium.phase_kind, c_out, **kw)

    c1_same = vrl_sum(*c1_mpacks, seed=seed, materials=c1_mats)
    median, share = homog_bar(c1_same.T, vrl_sum(*c1_packs, seed=seed).T)
    check(median < HOMOG_MEDIAN and share < HOMOG_SHARE, "config 1: the "
          f"material instantiation against the diffuse one: {median}, "
          f"{share}")
    timed = {
        "vrl_sum": (lambda: vrl_sum(*packs, seed=seed, **mkw),
                    lambda: vrl_sum(*dpacks, seed=seed), cuda_ms),
        "vrl_sum_clustered": (c_launch(packs, sop, tv, tw, **mkw),
                              c_launch(dpacks, sop, tv, tw),
                              cuda_ms_batched),
        "vrl_r": (lambda: vrl_r(*rpacks, seed=seed, **mkw),
                  lambda: vrl_r(r_diff, *rpacks[1:], seed=seed),
                  cuda_ms_batched),
        "vrl_sum config 1": (
            lambda: vrl_sum(*c1_mpacks, seed=seed, materials=c1_mats),
            lambda: vrl_sum(*c1_packs, seed=seed), cuda_ms),
        "vrl_sum_clustered config 1": (
            c_launch(c1_mpacks, c1_sop, c1_tv, c1_tw, materials=c1_mats),
            c_launch(c1_packs, c1_sop, c1_tv, c1_tw), cuda_ms_batched),
        "vrl_r config 1": (
            lambda: vrl_r(c1_rays[1], *c1_packs[1:], seed=seed,
                          materials=c1_mats),
            lambda: vrl_r(c1_rays[0], *c1_packs[1:], seed=seed),
            cuda_ms_batched),
    }
    ms = {}
    for k, (mat_fn, diff_fn, timer) in timed.items():
        args = (3, 10) if timer is cuda_ms else (3, 10, 10)
        d0 = timer(diff_fn, *args)
        m0 = timer(mat_fn, *args)
        m1 = timer(mat_fn, *args)
        d1 = timer(diff_fn, *args)
        ms[k] = (summary(m0 + m1), summary(d0 + d1))
    hg = scene.medium.phase_kind == 0

    def mat_ops(kernel, sweep, counts):
        f, s = plane_ops(kernel_ops(kernel, sweep, hg, True), sweep, counts)
        return (f + sweep.open[1] * OPS["eval_smooth"][0],
                s + sweep.open[1] * OPS["eval_smooth"][1])

    mat_bytes = nbytes(*mats)
    bounds = {
        "vrl_sum": bound(mat_ops("vrl_sum", s1, k1_counts),
                         nbytes(*packs) + mat_bytes + 3 * n_rays * 4),
        "vrl_sum_clustered": bound(
            mat_ops("vrl_sum_clustered", s2, c_counts),
            nbytes(*packs, tv, tw) + mat_bytes + 4 * sum(
                len(a) for a in group_by_slice(sop, c_block))
            + 3 * n_rays * 4),
        "vrl_r": bound(mat_ops("vrl_r", s5, r_counts),
                       nbytes(*rpacks) + mat_bytes + 2 * n_rep * n_vrls * 4),
    }
    plain_ms.update({f"{k} config 1": None for k in plain_ms})
    regs = [r for r in ptxas_summary(_build.build_log()) if ",mat>" in r]
    prof = profile_device(lambda: integrator.render_with_vrls_kernel(
        scene, vrls, torch.Generator().manual_seed(3), cfg), 2, 5)
    prof_line = ("the profiler saw no device operation: idle not measured"
                 if prof is None else
                 f"profile of render_with_vrls_kernel: device span "
                 f"{prof[0]:.3f} ms, busy {prof[1]:.3f} ms, idle share "
                 f"{1 - prof[1] / prof[0]:.1%}, {prof[2]:g} device ops")
    print(f"[40c material kernels' timing on {card}] " + " | ".join(
        f"{k}: material {m[0]:.4f} ms (spread {m[1]:.1%}), diffuse "
        f"{d[0]:.4f} ms (spread {d[1]:.1%}), in turns"
        + ("" if plain_ms[k] is None else
           f"; plain {plain_ms[k]:.2f} ms; bound {bounds[k][0]:.4f} ms by "
           f"{bounds[k][1]}")
        for k, (m, d) in ms.items())
        + f" | config 1, material against diffuse instantiation on the "
        f"same samples: median {median:.2e} share>1e-2 {share:.4f}"
        + f" | samples: kernel 1 {s1}; kernel 2 {s2}; kernel 5 {s5}"
        + " | ptxas (material instantiations): " + " ; ".join(regs)
        + f" | {prof_line}", flush=True)
    sources = {"vrl_sum": ("vrl_sum.cu", "alvrl_tpu/ops/vrl_pallas.py:726"),
               "vrl_sum_clustered": ("vrl_sum_clustered.cu",
                                     "alvrl_tpu/ops/vrl_pallas.py:785"),
               "vrl_r": ("vrl_r.cu", "alvrl_tpu/ops/vrl_pallas.py:1019")}
    return [{
        "name": f"{k} (material)", "route": "cuda",
        "source": f"alvrl_tpu_torch/csrc/{sources[k][0]}",
        "replaces": sources[k][1], "launches": launches[k],
        "max_abs_err": errs[k], "ms": ms[k][0][0], "plain_ms": plain_ms[k],
        "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
        "library_ms": None} for k in ("vrl_sum", "vrl_sum_clustered",
                                      "vrl_r")]


def glossy_cli(dev, card, tmp):
    """Phase 41: the CLI on cornell_glossy.xml with both integrators, as
    phase 33, and the tracer on cornell_glossy on the card against the
    tracer on the CPU on the same uniforms."""
    out = cli_runs(dev, card, tmp, GLOSSY_RUNS, "41a the CLI on "
                   "cornell_glossy")
    path = os.path.join(tmp, "cornell_glossy.json")
    tcfg = tracer.TracerConfig()
    rng = np.random.default_rng(41)
    u_emit = torch.as_tensor(rng.random((CLI_PARTICLES, tracer.N_EMIT_DIMS),
                                        dtype=np.float32))
    u_walk = torch.as_tensor(rng.random(
        (CLI_PARTICLES, tcfg.max_depth, tracer.N_STEP_DIMS), dtype=np.float32))
    ours, ref = (tracer.trace_u(
        loader.load_json(path, {"w": WIDTH, "h": HEIGHT}, device=d),
        u_emit.to(d), u_walk.to(d), tcfg) for d in (dev, "cpu"))
    ok = ref.valid
    check(torch.equal(ours.valid.cpu(), ok), "the card's tracer stores other "
          "slots than the CPU's")
    err = max(float((getattr(ours, k).cpu()[ok] - getattr(ref, k)[ok])
                    .abs().max()) for k in ("start", "end"))
    median, share = homog_bar(ours.power.cpu()[ok], ref.power[ok])
    check(err < 1e-4 and median < HOMOG_MEDIAN and share < HOMOG_SHARE,
          f"tracer on the card vs the CPU: positions {err}, powers median "
          f"{median} share {share}")
    # the tracer's host time a pass: every kind of the table sampled on
    # every lane, in turns with config 1's diffuse box
    scenes = {"cornell_glossy": loader.load_json(
        path, {"w": WIDTH, "h": HEIGHT}, device=dev),
        "config 1": presets.cornell_smoke(WIDTH, HEIGHT, device=dev)}
    gen = torch.Generator().manual_seed(41)
    trace_ms = {k: [] for k in scenes}
    for _ in range(2):
        for k, sc in scenes.items():
            trace_ms[k] += host_ms(lambda sc=sc: tracer.trace(
                sc, gen, CLI_PARTICLES, tcfg), 1, 3)
    print(f"[41b the tracer on cornell_glossy on {card}] {CLI_PARTICLES} "
          f"particles x depth {tcfg.max_depth}: {int(ok.sum())} valid slots, "
          f"the same as the CPU tracer's on the same uniforms; positions "
          f"within {err:.2e}, powers median {median:.2e} share>1e-2 "
          f"{share:.4f} | ms a trace (host clock, 6 in turns): "
          + ", ".join(f"{k} {summary(v)[0]:.1f} (spread {summary(v)[1]:.1%})"
                      for k, v in trace_ms.items()), flush=True)
    return out


def glossy_spec(dev, card, c1):
    """Phase 42: render_with_vrls_kernel_spec on cornell_glossy with its
    second block glass (GLASS_BLOCK), 128x128, against VRLs traced on the
    card at the CLI's defaults: the chains through the glass onto the
    glossy faces take kernel 1's material instantiation at every depth,
    each depth's launch is held against its plain version, and the render
    on injected uniforms against the plain chain (li_unclustered_spec_u)
    on every pixel that sees the glass and SPEC_GLOSSY_OTHERS others."""
    desc = glossy_json(c1)
    desc["materials"] = GLOSSY_MATERIALS + [GLASS_BLOCK]
    desc["shapes"][-1]["material"] = GLASS_BLOCK["name"]
    desc["camera"].update(width=WIDTH, height=HEIGHT)
    scene = loader.build_scene(desc, device=dev)
    kinds = bsdf_api.check_kinds(scene)
    check(bsdf_api.DIELECTRIC in kinds and bsdf_api.has_glossy(kinds),
          f"the glass variant's kinds {sorted(kinds)}")
    cfg, spec_cfg = VRLConfig(), specular.SpecularConfig()
    tcfg = tracer.TracerConfig()
    vrls = vrl.compact(tracer.trace(
        scene, torch.Generator().manual_seed(SPEC_SEED), CLI_PARTICLES,
        tcfg), CLI_VRLS, slots_per_particle=tcfg.max_depth)
    n_rays = WIDTH * HEIGHT

    def render(**kw):
        return integrator.render_with_vrls_kernel_spec(
            scene, vrls, torch.Generator().manual_seed(SPEC_SEED), cfg,
            spec_cfg, **kw)

    # the main path: one render, kernel 1's launches counted
    vrl_sum.launches = 0
    with plain_calls() as plain, kernel1_launches() as records:
        img = render()
        torch.cuda.synchronize()
    launches = vrl_sum.launches
    check(launches == len(records) and launches >= 2 and plain[0] == 0,
          f"kernel 1 launched {launches} times for {len(records)} depths, "
          f"{plain[0]} plain-version calls")
    check(all(r[10] is not None and r[0].shape[0] == pk.MAT_RAY_ROWS
              for r in records), "a depth took the diffuse instantiation")
    check(tuple(img.shape) == (HEIGHT, WIDTH, 3)
          and bool(torch.isfinite(img).all())
          and float(img.abs().max()) > 0.0, "the image")
    active = [r[0].shape[1] for r in records]
    hold = hold_kernel1("glossy spec", records, SPEC_GLOSSY_HOLD)
    del records[:]

    # the plain chain on the same injected uniforms
    u_sums = torch.rand(
        (spec_cfg.max_depth + 1, n_rays, CLI_VRLS,
         2 * cfg.vol_vol_samples + cfg.vol_surf_samples),
        generator=torch.Generator(dev).manual_seed(SPEC_SEED), device=dev)
    injected = render(uniforms=u_sums).reshape(-1, 3)
    u_chain = integrator._chain_draws(
        torch.Generator().manual_seed(SPEC_SEED), spec_cfg, n_rays, dev)[0]
    _, _, ray_o, ray_d = integrator.frame_rays(scene)
    _, mat = integrator.trace_eye_rays(scene, ray_o, ray_d)
    glass = (scene.materials.kind[mat] == bsdf_api.DIELECTRIC).cpu().numpy()
    pick = np.sort(np.concatenate([np.flatnonzero(glass), np.random.
                                   default_rng(42).choice(np.flatnonzero(
                                       ~glass), SPEC_GLOSSY_OTHERS,
                                       replace=False)]))
    pick_t = torch.as_tensor(pick, device=dev)
    plain_li = integrator.li_unclustered_spec_u(
        scene, ray_o[pick_t], ray_d[pick_t], vrls, u_chain[:, pick_t],
        u_sums[:, pick_t], cfg, spec_cfg)
    del u_sums
    seen = torch.as_tensor(glass[pick], device=dev)
    bars = [homog_bar(injected[pick_t], plain_li),
            homog_bar(injected[pick_t][seen], plain_li[seen])]
    for (median, share), what in zip(bars, ("the picked", "the glass")):
        check(median < HOMOG_MEDIAN and share < HOMOG_SHARE, f"{what} "
              f"pixels against the plain chain: median {median}, share "
              f"{share}")
    print(f"[42 specular chains onto glossy faces on {card}] cornell_glossy "
          f"with a glass block, {WIDTH}x{HEIGHT} ({n_rays} rays x "
          f"{int(vrls.valid.sum())} of {vrls.capacity} VRLs, "
          f"{scene.faces.shape[0]} triangles, {int(glass.sum())} pixels see "
          f"the glass): vrl_sum launches {launches}, each with the material "
          "pack; active rays per depth " + " ".join(map(str, active))
          + f", image mean {float(img.mean()):.6g}; {hold}; plain chain "
          f"(li_unclustered_spec_u) with the render's injected uniforms on "
          f"{len(pick)} pixels: median {bars[0][0]:.2e} share>1e-2 "
          f"{bars[0][1]:.4f}, on the glass pixels alone median "
          f"{bars[1][0]:.2e} share>1e-2 {bars[1][1]:.4f}", flush=True)


def scene_path(dev, card, vrls):
    """Phases 32-42; returns phase 40's entries of the kernels line."""
    with tempfile.TemporaryDirectory() as tmp:
        c1, _ = scene_files(dev, card, tmp)
        cli_runs(dev, card, tmp)
        _, c2_image, c2 = drivers(dev, card)
        resume(dev, card, tmp, c2_image, c2)
        t0 = time.perf_counter()
        glass_files(dev, card, tmp, c1)
        spec_render(dev, card, tmp)
        glass_cli(dev, card, tmp)
        print(f"[36-38 wall] {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        glossy = glossy_files(dev, card, tmp, c1)
        entries = glossy_kernels(dev, card, glossy, vrls)
        glossy_cli(dev, card, tmp)
        glossy_spec(dev, card, c1)
        print(f"[39-42 wall] {time.perf_counter() - t0:.1f} s", flush=True)
    return entries


# phases 43-45: the environment lights, the mixture phase, the sampling
# strategies and the volumetric path tracer. The sky scene is config 1's
# box with its front wall taken away (so that the sky lights it; the wall
# is behind the camera, so that every eye ray still ends on a surface, as
# the VRL render's eye segments need: an eye ray that leaves the scene
# has no segment, while the oracle scatters along it in the medium that
# fills the scene), the point light off, lit by the Preetham sky
# (resolution 256), in a coloured scattering coefficient with an
# absorbing two-lobe mixture phase (HG 0.8 at weight 0.6, Rayleigh at
# 0.3: the medium's absorption, its sigma_a 0) and the single strategy
# on channel 0, whose rate (0.8) is not the other channels' sigma_t, so
# that a kernel that took the balance pdfFailure in its place would fail
# its hold. With sigma_a 0 the sampling weight is 1, so every free
# flight in the medium ends in it and no photon leaves the scene, whose
# last segment the tracer would not store (ROADMAP C19)
SKY_SIGMA_S = [0.8, 0.5, 0.3]
SKY_SUN = [0.3, 0.8, 0.2]
SKY_RES = 256
MIX_PHASE = {"type": "mixture", "components": [
    {"type": "hg", "g": 0.8, "weight": 0.6},
    {"type": "rayleigh", "weight": 0.3}]}
SKY_SEED = 20261017
SKY_PARAMS = dict(vrl_target_num=512, num_particles=128, seed=0)
SKY_REPS = 271  # kernel 5's rays, config 2's representative count
SKY_BAND_SEEDS = 3  # clustered / unclustered passes held to C2_BAND
FRONT_WALL = (6, 7)  # cornell_smoke's front wall's triangles (z = -1)
# the equal-transport A/B (tests/test_ab_oracle.py's statistics): the VRL
# render through kernel 1 averaged over AB_PASSES passes of AB_PARTICLES
# particles x depth 16, against three oracle runs of AB_SPP samples. The
# sky's photons mostly miss the box, so its VRL render takes
# AB_SKY_PARTICLES a pass: 262,144 in all, which puts the VRL mean's
# spread (about 1 % on an H100) near the oracle's, against which z is
# taken
AB_SIZE, AB_PASSES, AB_PARTICLES, AB_SPP = 32, 16, 256, 1024
AB_SKY_PARTICLES = 16384
AB_Z = 4.0
NESTED_SPP = 64
MIS_SPP = 16
PATH_CLI_SPP, PATH_CLI_DEPTH = 2, 8


def sky_medium(c1):
    """The sky scene's medium: SKY_SIGMA_S, sigma_a 0, the mixture and
    the single strategy on channel 0."""
    return dict(homog_medium(c1), sigma_s=SKY_SIGMA_S, sigma_a=[0.0] * 3,
                phase=MIX_PHASE, strategy="single", channel=0)


def sky_desc(c1, width=None, height=None):
    """Phase 43's scene file: config 1's box without its front wall, lit
    by the sky, in the mixture medium of the single strategy (WIDTH x
    HEIGHT by default)."""
    keep = torch.ones(c1.faces.shape[0], dtype=torch.bool,
                      device=c1.device)
    keep[list(FRONT_WALL)] = False
    box = replace(c1, faces=c1.faces[keep], material=c1.material[keep])
    desc = scene_json(box, sky_medium(c1))
    desc["camera"].update(width=width or WIDTH, height=height or HEIGHT)
    desc["emitters"] = [{"type": "sky", "sun_direction": SKY_SUN,
                         "resolution": SKY_RES}]
    return desc


def mixture_ops(kernel, sweep, counts, comps):
    """plane_ops of the kernel's HG form, with each open sample's phase
    evaluations of the mixture's components (a component's HG (4, 2) or
    Rayleigh (3, 0) and its weighted sum (2)) in place of HG's, and the
    single strategy's pdfFailure (one exp: (2, 1) in place of (8, 3))."""
    f, s = plane_ops(kernel_ops(kernel, sweep, True, True), sweep, counts)
    mf = sum((4 if k == 0 else 3) + 2 for k in comps)
    ms = sum(2 if k == 0 else 0 for k in comps)
    n_phase = 2 * sweep.open[0] + sweep.open[1]
    n_open = sweep.open[0] + sweep.open[1]
    return (f + n_phase * (mf - 4) - 6 * n_open,
            s + n_phase * (ms - 2) - 2 * n_open)


def sky_kernels(dev, card, c1):
    """Phase 43: kernels 1, 2 and 5 in their PHASE = 2 forms on the sky
    scene against their plain versions (injected and Philox) and their
    checking launches, every earlier form's outputs bit for bit the
    parent's, the main path's launches, times against the HG form on the
    same samples, bounds. Returns the kernels line's three entries."""
    t_phase = time.perf_counter()
    cfg = VRLConfig()
    scene = loader.build_scene(sky_desc(c1), device=dev)
    med = scene.medium
    check(med.phase_kind == 4 and med.strategy == 1
          and scene.emitters.host_kinds == (5,),
          "the sky scene's medium and emitter")
    comps = med.phase_params.host[1]
    tcfg = tracer.TracerConfig()
    vrls = vrl.compact(tracer.trace(scene, torch.Generator().manual_seed(
        SKY_SEED), SKY_PARAMS["num_particles"], tcfg),
        SKY_PARAMS["vrl_target_num"], slots_per_particle=tcfg.max_depth)
    n_rays, n_vrls = WIDTH * HEIGHT, vrls.capacity
    packs = integrator.pack_frame(scene, vrls)[3]
    check(packs[3].shape == (pk.MED_MIX + 3 * len(comps),),
          f"the extended medium pack {tuple(packs[3].shape)}")
    hg_scene = replace(scene, medium=replace(med, phase_kind=0, strategy=0,
                                             phase_params=None))
    hpacks = (*packs[:3], pk.pack_medium(hg_scene))
    kind = med.phase_kind
    kw = dict(phase_kind=kind)
    rng = np.random.default_rng(43)
    u_inj = torch.as_tensor(rng.random((n_rays, n_vrls, 6),
                                       dtype=np.float32), device=dev)
    seed = SKY_SEED
    u_philox = philox_uniforms(seed, n_rays, n_vrls, 6, device=dev)
    sop = np.arange(n_rays, dtype=np.int32) // kernel_digest.SLICE_PIXELS
    tv = torch.as_tensor(rng.integers(0, n_vrls, (
        kernel_digest.N_SLICES, kernel_digest.N_COLS)), dtype=torch.int32,
        device=dev)
    tw = torch.as_tensor(rng.uniform(0.0, 2.0, tv.shape), dtype=torch.float32,
                         device=dev)
    reps = torch.as_tensor(rng.choice(n_rays, min(SKY_REPS, n_rays),
                                      replace=False), device=dev)
    rpacks = (packs[0][:, reps].contiguous(), *packs[1:])
    errs, lines, plain_ms, sweeps, counts = {}, [], {}, {}, {}
    pair_ok = ((packs[0][pk.VALID] > 0.5)[:, None]
               & (packs[1][pk.VVALID] > 0.5)[None])
    alb_ok = packs[0][pk.ALB:pk.ALB + 3].sum(dim=0) > 0.0

    def hold(name, label, out, ref, channels=3):
        median, share = homog_bar(out, ref, channels=channels)
        check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
              f"{name} (mixture) {label}: median {median}, share {share}")
        errs[name] = max(errs.get(name, 0.0), float((out - ref).abs().max()))
        return f"{name} {label} median {median:.2e} share>1e-2 {share:.4f}"

    for mode, u in (("injected", u_inj), ("philox", u_philox)):
        ukw = dict(uniforms=None if mode == "philox" else u, seed=seed, **kw)
        out = vrl_sum(*packs, **ukw)
        if mode == "injected":
            ref, plain_ms["vrl_sum"] = timed_call(
                lambda: vrl_sum_reference(*packs, u, **kw))
        else:
            with SweepCount(pair_ok, alb_ok) as sweeps["vrl_sum"]:
                ref = vrl_sum_reference(*packs, u, **kw)
        lines.append(hold("vrl_sum", mode, out.T, ref.T))
        out_c, cnt = vs.vrl_sum_check(*packs, **ukw)
        check(cnt["bad_tris"] == 0 and cnt["bad_segments"] == 0
              and torch.equal(out_c, out), f"kernel 1 (mixture) {mode}: "
              f"the checking launch {cnt}")
        counts["vrl_sum"] = cnt
        uc = u[:, :kernel_digest.N_COLS].contiguous()
        out = vrl_sum_clustered(*packs, sop, tv, tw, **dict(
            ukw, uniforms=None if mode == "philox" else uc))
        uc = (philox_table_uniforms(seed, sop, tv, 6) if mode == "philox"
              else uc)
        if mode == "injected":
            ref, plain_ms["vrl_sum_clustered"] = timed_call(
                lambda: vrl_sum_clustered_reference(*packs, sop, tv, tw, uc,
                                                    **kw))
        else:
            ok_c = table_pair_ok(packs[0], packs[1], sop, tv, tw)
            with SweepCount(ok_c, alb_ok) as sweeps["vrl_sum_clustered"]:
                ref = vrl_sum_clustered_reference(*packs, sop, tv, tw, uc,
                                                  **kw)
        lines.append(hold("vrl_sum_clustered", mode, out.T, ref.T))
        out_c, cnt = vrl_sum_clustered_check(*packs, sop, tv, tw, **dict(
            ukw, uniforms=None if mode == "philox" else uc))
        check(cnt["bad_tris"] == 0 and cnt["bad_segments"] == 0,
              f"kernel 2 (mixture) {mode}: the checking launch {cnt}")
        counts["vrl_sum_clustered"] = cnt
        # kernel 5's stream counts its own rays (0 .. len(reps) - 1)
        ur = (philox_uniforms(seed, len(reps), n_vrls, 6, device=dev)
              if mode == "philox" else u[reps].contiguous())
        out = vrl_r(*rpacks, **dict(ukw, uniforms=None if mode == "philox"
                                    else ur))
        if mode == "injected":
            ref, plain_ms["vrl_r"] = timed_call(
                lambda: vrl_r_reference(*rpacks, ur, **kw))
        else:
            with SweepCount(*pair_masks(*rpacks[:2])) as sweeps["vrl_r"]:
                ref = vrl_r_reference(*rpacks, ur, **kw)
        lines.append(hold("vrl_r", mode, out[0], ref[0], channels=1))
        out_c, cnt = vrl_r_check(*rpacks, **dict(
            ukw, uniforms=None if mode == "philox" else ur))
        check(cnt["bad_tris"] == 0 and cnt["bad_segments"] == 0,
              f"kernel 5 (mixture) {mode}: the checking launch {cnt}")
        counts["vrl_r"] = cnt
    del u_inj, u_philox
    digests = kernel_digest.kernel_digests(dev, every_form=True)
    check(digests == PARENT_DIGESTS_ALL, "the earlier forms' outputs are "
          f"not the parent's: {digests}")
    lines.append(f"the {len(digests)} earlier forms of kernels 1, 2 and 5 "
                 "(kernel_digest.py --all) bit for bit the parent's")

    # the main path: SKY_BAND_SEEDS clustered passes, each beside the
    # unclustered render of its own VRLs (so that the band sees the
    # clustering, not two traces' photon noise), their ratio of means
    # held to C2_BAND as config 2's
    for fn in (vrl_sum, vrl_r, vrl_sum_clustered):
        fn.launches = 0
    means = []
    with plain_calls() as plain:
        for k in range(SKY_BAND_SEEDS):
            img_c, vrls_k, _ = alvrl.render_alvrl(
                scene, torch.Generator().manual_seed(2 + k),
                alvrl.ALVRLParams(**SKY_PARAMS), cfg)
            img = integrator.render_with_vrls_kernel(
                scene, vrls_k, torch.Generator().manual_seed(1000 + k), cfg)
            for im in (img, img_c):
                check(tuple(im.shape) == (HEIGHT, WIDTH, 3)
                      and bool(torch.isfinite(im).all())
                      and float(im.abs().max()) > 0.0,
                      "the sky scene's image")
            means.append((float(img_c.mean()), float(img.mean())))
        torch.cuda.synchronize()
    launches = {"vrl_sum": vrl_sum.launches, "vrl_r": vrl_r.launches,
                "vrl_sum_clustered": vrl_sum_clustered.launches}
    check(min(launches.values()) >= 1 and plain[0] == 0,
          f"the main path's launches {launches}, plain calls {plain[0]}")
    ratio = np.mean([a for a, _ in means]) / np.mean([b for _, b in means])
    check(C2_BAND[0] < ratio < C2_BAND[1], "the sky scene's clustered / "
          f"unclustered image mean {ratio} ({means})")
    print(f"[43a mixture kernels vs plain on {card}, B={n_rays} N={n_vrls} "
          f"T={scene.faces.shape[0]} K={len(comps)}] " + " | ".join(lines)
          + f" | main path: render_alvrl and render_with_vrls_kernel on its "
          f"VRLs, {SKY_BAND_SEEDS} seeds, launches {launches}, no plain "
          f"version; clustered / unclustered mean {ratio:.4f} (in "
          f"{C2_BAND}; " + ", ".join(f"{a:.5f}/{b:.5f}" for a, b in means)
          + ")", flush=True)

    # times against the HG form on the same samples, in turns (HG,
    # mixture, mixture, HG); bounds; registers
    c_block = vsc.ray_block(False)
    tiles = [torch.as_tensor(a, device=dev)
             for a in group_by_slice(sop, c_block)]
    c_out = torch.zeros((3, n_rays), device=dev)

    def c_launch(p, k):
        return lambda: vsc._launch(vsc._library(), *p, *tiles, tv, tw, None,
                                   seed, 2, 2, True, k, c_out)

    timed = {"vrl_sum": (lambda: vrl_sum(*packs, seed=seed, **kw),
                         lambda: vrl_sum(*hpacks, seed=seed), cuda_ms),
             "vrl_sum_clustered": (c_launch(packs, kind), c_launch(hpacks, 0),
                                   cuda_ms_batched),
             "vrl_r": (lambda: vrl_r(*rpacks, seed=seed, **kw),
                       lambda: vrl_r(rpacks[0], *hpacks[1:3], hpacks[3],
                                     seed=seed), cuda_ms_batched)}
    ms = {}
    for k, (mix_fn, hg_fn, timer) in timed.items():
        args = (3, 10) if timer is cuda_ms else (3, 10, 10)
        h0, m0, m1, h1 = (timer(f, *args) for f in (hg_fn, mix_fn, mix_fn,
                                                     hg_fn))
        ms[k] = (summary(m0 + m1), summary(h0 + h1))
    bounds = {
        "vrl_sum": bound(mixture_ops("vrl_sum", sweeps["vrl_sum"],
                                     counts["vrl_sum"], comps),
                         nbytes(*packs) + 3 * n_rays * 4),
        "vrl_sum_clustered": bound(
            mixture_ops("vrl_sum_clustered", sweeps["vrl_sum_clustered"],
                        counts["vrl_sum_clustered"], comps),
            nbytes(*packs, tv, tw, *tiles) + 3 * n_rays * 4),
        "vrl_r": bound(mixture_ops("vrl_r", sweeps["vrl_r"],
                                   counts["vrl_r"], comps),
                       nbytes(*rpacks) + 2 * len(reps) * n_vrls * 4)}
    regs = [r for r in ptxas_summary(_build.build_log()) if "<2," in r]
    print(f"[43b mixture kernels' timing on {card}] " + " | ".join(
        f"{k}: mixture {m[0]:.4f} ms (spread {m[1]:.1%}), HG form "
        f"{h[0]:.4f} ms (spread {h[1]:.1%}), in turns; plain "
        f"{plain_ms[k]:.2f} ms; bound {bounds[k][0]:.4f} ms by {bounds[k][1]}"
        for k, (m, h) in ms.items()) + " | ptxas (PHASE = 2 forms): "
        + " ; ".join(regs) + f" | phase 43 wall "
        f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    sources = {"vrl_sum": ("vrl_sum.cu", "alvrl_tpu/ops/vrl_pallas.py:726"),
               "vrl_sum_clustered": ("vrl_sum_clustered.cu",
                                     "alvrl_tpu/ops/vrl_pallas.py:785"),
               "vrl_r": ("vrl_r.cu", "alvrl_tpu/ops/vrl_pallas.py:1019")}
    return [{
        "name": f"{k} (mixture)", "route": "cuda",
        "source": f"alvrl_tpu_torch/csrc/{sources[k][0]}",
        "replaces": sources[k][1], "launches": launches[k],
        "max_abs_err": errs[k], "ms": ms[k][0][0], "plain_ms": plain_ms[k],
        "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
        "library_ms": None} for k in ("vrl_sum", "vrl_sum_clustered",
                                      "vrl_r")]


def sky_material_kernels(dev, card, c1):
    """Phase 43c: the PHASE = 2 material forms of kernels 1, 2 and 5 on
    cornell_glossy in the sky scene's medium (the mixture, the single
    strategy), each against its plain version over each eye-hit kind's
    rays alone (R_KIND_RAYS of every kind of the frame; kernel 2 on a
    seeded table with rows -1, ids -1 and weights 0), with injected and
    Philox uniforms, and their checking launches (0 disagreements)."""
    t_phase = time.perf_counter()
    desc = glossy_json(c1)
    desc["camera"].update(width=WIDTH, height=HEIGHT)
    desc["medium"] = sky_medium(c1)
    scene = loader.build_scene(desc, device=dev)
    kind = scene.medium.phase_kind
    check(kind == 4 and scene.medium.strategy == 1, "the glossy box's "
          "mixture medium")
    tcfg = tracer.TracerConfig()
    vrls = vrl.compact(tracer.trace(scene, torch.Generator().manual_seed(
        SKY_SEED), SKY_PARAMS["num_particles"], tcfg),
        SKY_PARAMS["vrl_target_num"], slots_per_particle=tcfg.max_depth)
    mats = integrator.material_pack(scene)
    packs = integrator.pack_frame(scene, vrls, materials=mats)[3]
    ray_kind = mats[0][packs[0][pk.MATID].long(), pk.MT_KIND].long()
    rng = np.random.default_rng(431)
    kinds, n_kind = np.unique(ray_kind.cpu().numpy(), return_counts=True)
    kinds = kinds[n_kind >= R_KIND_RAYS]
    check(GLOSSY_KINDS <= set(kinds.tolist()), f"the kinds seen {kinds}")
    pick = torch.as_tensor(np.concatenate([rng.choice(
        np.flatnonzero(ray_kind.cpu().numpy() == k), R_KIND_RAYS,
        replace=False) for k in kinds]), device=dev)
    packs = (packs[0][:, pick].contiguous(), *packs[1:])
    ray_kind = ray_kind[pick]
    n_rays, n_vrls, seed = len(pick), vrls.capacity, SKY_SEED
    sop = rng.integers(-1, kernel_digest.N_SLICES, n_rays).astype(np.int32)
    tv = torch.as_tensor(rng.integers(-1, n_vrls, (
        kernel_digest.N_SLICES, kernel_digest.N_COLS)), dtype=torch.int32,
        device=dev)
    tw = torch.as_tensor(rng.uniform(0.0, 2.0, tv.shape), dtype=torch.float32,
                         device=dev)
    kw = dict(phase_kind=kind, materials=mats)
    lines, errs = [], {}
    for mode in ("injected", "philox"):
        inj = mode == "injected"
        u = (torch.as_tensor(rng.random((n_rays, n_vrls, 6), dtype=np.float32),
                             device=dev) if inj else
             philox_uniforms(seed, n_rays, n_vrls, 6, device=dev))
        uc = (u[:, :tv.shape[1]].contiguous() if inj else
              philox_table_uniforms(seed, sop, tv, 6))
        runs = {
            "vrl_sum": (vrl_sum(*packs, seed=seed, uniforms=u if inj else
                                None, **kw).T,
                        vrl_sum_reference(*packs, u, **kw).T, 3),
            "vrl_sum_clustered": (
                vrl_sum_clustered(*packs, sop, tv, tw, seed=seed,
                                  uniforms=uc if inj else None, **kw).T,
                vrl_sum_clustered_reference(*packs, sop, tv, tw, uc,
                                            **kw).T, 3),
            "vrl_r": (vrl_r(*packs, seed=seed, uniforms=u if inj else None,
                            **kw)[0],
                      vrl_r_reference(*packs, u, **kw)[0], 1)}
        for name, (out, ref, channels) in runs.items():
            check(bool(torch.isfinite(out).all())
                  and float(out.abs().sum()) > 0.0,
                  f"{name} (mixture, material) {mode}: not finite and "
                  "non-zero")
            item_kind = (ray_kind if channels == 3
                         else ray_kind[:, None].expand(-1, n_vrls))
            groups = homog_bar_by_kind(out, ref, item_kind, channels)
            for k, (n, median, share) in groups.items():
                check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
                      f"{name} (mixture, material) {mode}: kind {k} ({n} "
                      f"items) median {median}, share {share}")
            worst = max(g[1] for g in groups.values())
            lines.append(f"{name} {mode}: {len(groups)} kinds held alone, "
                         f"worst median {worst:.2e}, worst share>1e-2 "
                         f"{max(g[2] for g in groups.values()):.4f}")
            errs[name] = max(errs.get(name, 0.0),
                             float((out - ref).abs().max()))
        del u, uc
    counts = {"vrl_sum": vs.vrl_sum_check(*packs, seed=seed, **kw)[1],
              "vrl_sum_clustered": vrl_sum_clustered_check(
                  *packs, sop, tv, tw, seed=seed, **kw)[1],
              "vrl_r": vrl_r_check(*packs, seed=seed, **kw)[1]}
    for name, cnt in counts.items():
        check(cnt["bad_tris"] == 0 and cnt["bad_segments"] == 0
              and cnt["segments"] > 0, f"{name} (mixture, material): the "
              f"checking launch {cnt}")
    print(f"[43c mixture material kernels vs plain on {card}, cornell_glossy"
          f" in the sky scene's medium, B={n_rays} ({R_KIND_RAYS} eye rays "
          f"of each of {len(kinds)} kinds) N={n_vrls} "
          f"T={scene.faces.shape[0]}] " + " | ".join(lines)
          + " | checking launches: " + "; ".join(
              f"{k} {c['segments']} segments, {c['bad_tris']} + "
              f"{c['bad_segments']} disagreements" for k, c in counts.items())
          + f" | largest |kernel - plain| " + ", ".join(
              f"{k} {v:.3g}" for k, v in errs.items())
          + f" | phase 43c wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def ab_oracle(dev, card, scene, label, particles=AB_PARTICLES,
              env_center=None):
    """The equal-transport A/B of tests/test_ab_oracle.py on the card: the
    VRL render through kernel 1 (AB_PASSES passes of `particles`
    particles x depth 16, every slot) against three runs of the volpath
    oracle (only_vrl_paths, AB_SPP samples a pixel; env_center as
    volpath.render_volpath's); z of the image means against the oracle's
    self-noise (the VRL passes' own spread printed beside it). Returns a
    line of text."""
    cfg = VRLConfig()
    gen = torch.Generator().manual_seed(44)
    vrl_sum.launches = 0
    imgs = []
    t0 = time.perf_counter()
    for _ in range(AB_PASSES):
        vrls = tracer.trace(scene, gen, particles,
                            tracer.TracerConfig(max_depth=16))
        imgs.append(integrator.render_with_vrls_kernel(scene, vrls, gen, cfg))
    vrl_img = torch.stack(imgs).mean(dim=0)
    torch.cuda.synchronize()
    t_vrl = time.perf_counter() - t0
    check(vrl_sum.launches == AB_PASSES, f"{label}: kernel 1 launches "
          f"{vrl_sum.launches}")
    t0 = time.perf_counter()
    runs = [volpath.render_volpath(
        scene, torch.Generator(device=dev).manual_seed(100 + i), spp=AB_SPP,
        cfg=volpath.VolpathConfig(max_depth=16), env_center=env_center)
        for i in range(3)]
    torch.cuda.synchronize()
    t_oracle = time.perf_counter() - t0
    o_img = torch.stack(runs).mean(dim=0)
    check(bool(torch.isfinite(vrl_img).all() and torch.isfinite(o_img).all())
          and float(o_img.mean()) > 0.0, f"{label}: the images")
    means = [float(r.mean()) for r in runs]
    sigma = max(statistics.stdev(means), 0.01 * float(o_img.mean()))
    z = abs(float(vrl_img.mean()) - float(o_img.mean())) / sigma
    vrl_sd = statistics.stdev(float(i.mean()) for i in imgs) / len(imgs) ** 0.5
    check(z < AB_Z, f"{label}: the VRL render's mean {float(vrl_img.mean())} "
          f"against the oracle's {float(o_img.mean())}: z {z}")
    return (f"{label} {scene.camera.width}x{scene.camera.height}: VRL mean "
            f"{float(vrl_img.mean()):.6g} (+- {vrl_sd:.3g}, {AB_PASSES} "
            f"passes of {particles} particles, {t_vrl:.1f} s), oracle "
            f"{float(o_img.mean()):.6g} (runs "
            + " ".join(f"{x:.6g}" for x in means) + f", {AB_SPP} spp, "
            f"{t_oracle:.1f} s), ratio {float(vrl_img.mean()) / float(o_img.mean()):.4f}, "
            f"z {z:.2f} (< {AB_Z})")


def oracle_phase(dev, card, c1):
    """Phase 44: the A/B on cornell_smoke and on the sky scene, the nested
    no-op crossing, and the MIS path tracer's time and idle share."""
    t_phase = time.perf_counter()
    sky = loader.build_scene(sky_desc(c1, AB_SIZE, AB_SIZE), device=dev)
    lo, hi = sky.aabb()
    # the sky's oracle ends the map's direct segments on the tracer's
    # emission disk (ROADMAP C17)
    lines = [ab_oracle(dev, card, presets.cornell_smoke(
        AB_SIZE, AB_SIZE, device=dev), "cornell_smoke"),
        ab_oracle(dev, card, sky, "the sky scene", AB_SKY_PARTICLES,
                  0.5 * (lo + hi))]
    sig_s, sig_a = (0.8, 0.8, 0.8), (0.05, 0.05, 0.05)
    nested = presets.cornell_nested_smoke(
        AB_SIZE, AB_SIZE, sigma_s=sig_s, sigma_a=sig_a,
        exterior=(sig_a, sig_s, 0.0), device=dev)
    glob = presets.cornell_smoke(AB_SIZE, AB_SIZE, with_blocker=False,
                                 sigma_s=sig_s, sigma_a=sig_a, device=dev)
    vcfg = volpath.VolpathConfig(max_depth=8, only_vrl_paths=False)

    def mean(sc, s0):
        return float(np.mean([float(volpath.render_volpath(
            sc, torch.Generator(device=dev).manual_seed(s0 + i),
            spp=NESTED_SPP, cfg=vcfg).mean())
            for i in range(3)]))

    ratio = mean(nested, 0) / mean(glob, 10)
    check(0.9 < ratio < 1.1, f"nested no-op crossing: ratio {ratio}")
    lines.append(f"nested no-op crossing (cornell_nested_smoke, the cube's "
                 f"medium the exterior's) against the global medium: ratio "
                 f"{ratio:.4f} (3 seeds x {NESTED_SPP} spp)")
    area = presets.cornell_area_light(WIDTH, HEIGHT, device=dev)
    pcfg = volpath.VolpathConfig(max_depth=16, only_vrl_paths=False)
    gen = torch.Generator(device=dev).manual_seed(45)

    def render():
        return volpath.render_volpath(area, gen, spp=MIS_SPP, cfg=pcfg)

    # the tile that the free memory allows, against the render's peak
    tile = volpath.tile_rays(area, pcfg)
    free = torch.cuda.mem_get_info(dev)[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    img = render()
    peak = torch.cuda.max_memory_allocated(dev) - base
    check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0,
          "the MIS render")
    check(peak < free, f"the MIS render's peak {peak} B over the free "
          f"{free} B")
    r_ms = host_ms(render, 1, 3)
    prof = profile_device(render, 1, 2)
    prof_line = ("the profiler saw no device operation: idle not measured"
                 if prof is None else
                 f"device span {prof[0]:.1f} ms, busy {prof[1]:.1f} ms, idle "
                 f"share {1 - prof[1] / prof[0]:.1%}")
    med, spread = summary(r_ms)
    lines.append(f"MIS path tracer (volpath, max_depth 16) on "
                 f"cornell_area_light {WIDTH}x{HEIGHT}, {MIS_SPP} spp: "
                 f"{med:.1f} ms a render (spread {spread:.1%}), mean "
                 f"{float(img.mean()):.6g}; tile {tile} rays of "
                 f"{MIS_SPP * WIDTH * HEIGHT} (a quarter of {free / 2**30:.1f}"
                 f" GiB free), peak {peak / 2**30:.2f} GiB; {prof_line}")
    print(f"[44 the volpath oracle on {card}] " + " | ".join(lines)
          + f" | phase 44 wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def sky_files(c1, tmp):
    """Phase 45's scene files in tmp: the sky scene (JSON, 64x64), the
    nested scene (JSON: the media table and the cube's interior id), and
    two Mitsuba XMLs of config 1's box at 64x64, one lit by sunsky and one
    by an .hdr map written here."""
    desc = sky_desc(c1, 64, 64)
    with open(os.path.join(tmp, "sky.json"), "w") as f:
        json.dump(desc, f)
    nested = scene_json(presets.cornell_smoke(64, 64, with_blocker=False,
                                              device=c1.device),
                        {"type": "homogeneous", "sigma_s": [0.0] * 3,
                         "sigma_a": [0.0] * 3})
    nested["materials"].append({"name": "null", "type": "null"})
    nested["shapes"].append({"type": "cube", "material": "null",
                             "to_world": [[0.5, 0, 0, 0], [0, 0.5, 0, 0],
                                          [0, 0, 0.5, 0], [0, 0, 0, 1]],
                             "interior_medium": 1})
    nested["media"] = [{"sigma_a": [0.0] * 3, "sigma_s": [0.0] * 3},
                       {"sigma_a": [0.05] * 3, "sigma_s": [0.8] * 3}]
    with open(os.path.join(tmp, "nested.json"), "w") as f:
        json.dump(nested, f)
    from alvrl_tpu_torch.emitters import sunsky
    from alvrl_tpu_torch.io import hdr
    hdr.write_hdr(os.path.join(tmp, "sky.hdr"),
                  sunsky.preetham_sky_image(SKY_SUN, 3.0, 128, 64) * 0.05)
    box = presets.cornell_smoke(64, 64, device=c1.device)
    keep = torch.ones(box.faces.shape[0], dtype=torch.bool, device=c1.device)
    keep[list(FRONT_WALL)] = False
    box = replace(box, faces=box.faces[keep], material=box.material[keep])
    for name, light in (
            ("sunsky.xml", '<emitter type="sunsky"><vector name='
             '"sunDirection" x="0.3" y="0.8" z="0.2"/><float name="scale" '
             'value="0.05"/></emitter>'),
            ("envmap.xml", '<emitter type="envmap"><string name="filename" '
             f'value="{os.path.join(tmp, "sky.hdr")}"/></emitter>')):
        with open(os.path.join(tmp, name), "w") as f:
            f.write(box_xml(box, tmp, lights=light))


def path_cli(dev, card, tmp):
    """Phase 45: the CLI's -i volpath|path|direct on the scene files, each
    image bit for bit render_cli.render_path_tracer's in process, and -i
    vrl|alvrl on them through cli_runs."""
    lines = []
    for name in ("sky.json", "nested.json", "sunsky.xml", "envmap.xml"):
        path = os.path.join(tmp, name)
        for integ in render_cli.PATH_TRACERS:
            out_npy = os.path.join(tmp, f"{name}.{integ}.npy")
            args = [path, "-i", integ, "--spp", str(PATH_CLI_SPP), "--seed",
                    str(CLI_SEED), "-o", out_npy, "-L", "WARNING"]
            if integ == "path":
                args += ["--depth", str(PATH_CLI_DEPTH)]
            t0 = time.perf_counter()
            rc = render_cli.main(args)
            wall = time.perf_counter() - t0
            img = np.load(out_npy)
            check(rc == 0 and np.isfinite(img).all(), f"{name} -i {integ}")
            scene = (loader.build_scene(loader.convert_mitsuba_xml(path),
                                        device=dev) if name.endswith(".xml")
                     else loader.load_json(path, device=dev))
            ref = render_cli.render_path_tracer(
                scene, integ, CLI_SEED, PATH_CLI_SPP, PATH_CLI_DEPTH)
            check(np.array_equal(img, ref), f"{name} -i {integ}: the CLI's "
                  "image is not the in-process render's")
            lines.append(f"{name} -i {integ}: mean {float(img.mean()):.6g}, "
                         f"equal to the in-process render, {1e3 * wall:.0f}"
                         " ms a run")
    print(f"[45a the CLI's path tracers on {card}] " + " | ".join(lines),
          flush=True)
    runs = [(f"{n} {i}", n, i, 2, [], route) for n in (
        "sky.json", "sunsky.xml", "envmap.xml") for i, route in (
        ("vrl", ("vrl_sum",)), ("alvrl", ("vrl_r", "vrl_sum_clustered")))]
    cli_runs(dev, card, tmp, runs, "45b the CLI's VRL integrators")


def sky_path(dev, card):
    """Phases 43-45; returns phase 43's entries of the kernels line."""
    t0 = time.perf_counter()
    c1 = presets.cornell_smoke(WIDTH, HEIGHT, device=dev)
    entries = sky_kernels(dev, card, c1)
    sky_material_kernels(dev, card, c1)
    oracle_phase(dev, card, c1)
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        sky_files(c1, tmp)
        path_cli(dev, card, tmp)
        print(f"[45 wall] {time.perf_counter() - t1:.1f} s", flush=True)
    print(f"[43-45 wall] {time.perf_counter() - t0:.1f} s", flush=True)
    return entries


# phases 46-47: the rest of the grid medium
TRI_HOLD_RAYS = 4096  # rays of kernel 3's and 4's trilinear holds, at most
# (name, uniforms, short VRLs, phase kind) of phase 46's holds
TRI_CASES = [("hg_g03", "injected", True, 0), ("hg_g03", "philox", True, 0),
             ("rayleigh", "injected", False, 1)]
TRI_MEAN_BAND = 0.05   # |trilinear / nearest image mean - 1|, same VRLs
ORIENT_RES = 16        # the swirl's orientation volume, voxels a side
ORIENT_SIZE = 64       # volpath's frame on the oriented scenes
ORIENT_SPP, ORIENT_DEPTH = 4, 6
QUAD_SIZE = 256        # phase 47's VRL renders of config 4's plume
QUAD_SEEDS = 4         # traces of each sampler
QUAD_Z = 4.0
# the nearest forms of kernels 3, 4 and 6 on config 4's packs before
# their trilinear forms were added (kernel_digest.py --grid --root on the
# parent tree, NVIDIA H100 80GB HBM3, 700.00 W)
PARENT_DIGESTS_GRID = {
    "vrl_sum_hetero injected":
        "d151ad152bd927bba2cce2308767fe190f6812a479fbbf7ccbe377a5677c4df9",
    "vrl_sum_hetero philox":
        "f5dfae78afbfea1b1b2f141ad9afede972dd22a49d5a90ddeecba71da8d59df4",
    "vrl_sum_hetero_clustered injected":
        "60850c53b079aa7fb1404da10cf5e27a8e003f24b0090f19f9644fcaf4472842",
    "vrl_sum_hetero_clustered philox":
        "2cd5aae31543c6c66fd1d9a182398de5b26504293db4ec6b5a484f27a34c459b",
    "vrl_r_hetero injected":
        "3e340e49d97103bead649c0987ba41fa93bc8383effc57563b6dda020d353620",
    "vrl_r_hetero philox":
        "8b94510c90a5d6baa2370c55bfb89c9ccdb195f3e9775487a8b53149ee78645e",
}


def swirl(n, dev):
    """(n, n, n, 3) fiber directions over the box [-1, 1]^3 of config 4:
    a swirl about the y axis (the tangent of the circle about it,
    tilted by y), zero on the axis, where the orientation is undefined."""
    c = torch.linspace(-1.0, 1.0, n, device=dev)
    z, y, x = torch.meshgrid(c, c, c, indexing="ij")
    tangent = torch.stack([-z, 0.5 * y, x], dim=-1)
    length = tangent.norm(dim=-1, keepdim=True)
    return torch.where(length > 1e-6, tangent / length.clamp(min=1e-6), 0.0)


def oriented_scene(c4_scene, kind, sampling, dev):
    """Config 4's box and plume (the density resampled to ORIENT_RES) with
    an oriented phase (ph.KKAY or ph.MICROFLAKE) over the swirl, at
    ORIENT_SIZE^2, and the given free-flight sampling."""
    med = c4_scene.medium
    dens = torch.nn.functional.interpolate(
        med.density[None, None], size=(ORIENT_RES,) * 3, mode="trilinear",
        align_corners=True)[0, 0]
    omed = gmed.make_grid_medium(
        dens, med.sigma_t_color, med.albedo, g=med.g, box_min=med.box_min,
        box_max=med.box_max, scale=med.scale, phase_kind=kind,
        orientation=swirl(ORIENT_RES, dev), sampling=sampling, device=dev)
    scene = presets.cornell_grid_smoke(ORIENT_SIZE, ORIENT_SIZE,
                                       grid_res=ORIENT_RES, device=dev)
    check(omed.phase_params is not None
          and (kind != ph.MICROFLAKE or float(omed.sigma_dir_max) > 1.0),
          f"oriented medium {kind}: its phase parameters and majorant")
    return replace(scene, medium=omed)


def grid_options(dev, card, cfg, c4):
    """Phases 46-47, the rest of the grid medium: the trilinear forms of
    kernels 3, 4 and 6 (fast_tau=False) and the nearest forms' digests;
    volpath on oriented media, the quadrature sampler against Woodcock,
    the refusals. Returns the kernels line's entries of the three
    trilinear forms."""
    t_phase = time.perf_counter()
    scene, vrls, seed = c4["scene"], c4["vrls"], c4["seed"]
    sop, tv, tw, info = c4["sop"], c4["tv"], c4["tw"], c4["info"]
    tri_scene = replace(scene, medium=replace(scene.medium, fast_tau=False))
    packs_n, packs_t = c4["packs"], integrator.pack_frame(tri_scene, vrls)[3]
    packs_rn, packs_rt = (rep_packs(s, vrls, info) for s in (scene, tri_scene))
    n_rays, n_vrls, n_cols = packs_t[0].shape[1], vrls.capacity, tv.shape[1]
    n_rep = packs_rt[0].shape[1]
    check(pk.is_trilinear(packs_t[3]) and not pk.is_trilinear(packs_n[3])
          and tuple(packs_t[4].shape) == (C4_GRID,) * 3
          and pk.is_trilinear(packs_rt[3]),
          f"trilinear packs: medium {tuple(packs_t[3].shape)}, density "
          f"{tuple(packs_t[4].shape)}")
    kw = dict(uv_steps=cfg.uv_tau_steps)
    gen = torch.Generator(device=dev).manual_seed(46)
    # the holds' samples: every stride-th ray for kernel 3, the rays of
    # the first whole slices for kernel 4, every representative for 6
    stride = max(1, n_rays // TRI_HOLD_RAYS)
    hold = torch.arange(0, n_rays, stride, device=dev)
    rows, counts = np.unique(sop[sop >= 0], return_counts=True)
    n_sl = max(1, int(np.searchsorted(np.cumsum(counts), TRI_HOLD_RAYS,
                                      side="right")))
    idx = np.flatnonzero(np.isin(sop, rows[:n_sl]))
    idx_t = torch.as_tensor(idx, device=dev)
    sub_t = (packs_t[0][:, hold].contiguous(), *packs_t[1:])
    sub_ct = (packs_t[0][:, idx_t].contiguous(), *packs_t[1:])
    u_full = torch.rand((n_rays, n_vrls, 6), generator=gen, device=dev)
    u_c = torch.rand((n_rays, n_cols, 6), generator=gen, device=dev)
    u_r = torch.rand((n_rep, n_vrls, 6), generator=gen, device=dev)
    u_sub = philox_draws(seed, hold[:, None],
                         torch.arange(n_vrls, device=dev)[None], 6)
    u_c_sub = philox_draws(seed, idx_t[:, None], tv[torch.as_tensor(
        sop[idx], device=dev).long()].long(), 6)
    u_r_philox = philox_uniforms(seed, n_rep, n_vrls, 6, device=dev)
    errs, results = {"sum": 0.0, "r": 0.0, "clustered": 0.0}, []
    plain_ms, sweeps = {}, {}
    with plain_chunk(C4_PLAIN_CHUNK):
        for name, mode, short, kind in TRI_CASES:
            inj = mode != "philox"
            case = dict(short_vrls=short, phase_kind=kind, **kw)
            out = vrl_sum_hetero(*packs_t, seed=seed,
                                 uniforms=u_full if inj else None, **case)
            r = vrl_r_hetero(*packs_rt, seed=seed,
                             uniforms=u_r if inj else None, **case)
            c = vrl_sum_hetero_clustered(*packs_t, sop, tv, tw, seed=seed,
                                         uniforms=u_c if inj else None, **case)
            timed = mode == "philox"  # the plain versions timed, counted
            ctx = [SweepCount(*pair_masks(*sub_t[:2])),
                   SweepCount(*pair_masks(*packs_rt[:2])),
                   SweepCount(table_pair_ok(sub_ct[0], sub_ct[1], sop[idx], tv,
                                            tw), pair_masks(*sub_ct[:2])[1])]
            refs = []
            for what, fn, sweep in (
                    ("sum", lambda: vrl_sum_hetero_reference(
                        *sub_t, u_full[hold] if inj else u_sub, **case),
                     ctx[0]),
                    ("r", lambda: vrl_r_hetero_reference(
                        *packs_rt, u_r if inj else u_r_philox, **case), ctx[1]),
                    ("clustered", lambda: vrl_sum_hetero_clustered_reference(
                        *sub_ct, sop[idx], tv, tw,
                        u_c[idx_t] if inj else u_c_sub, **case), ctx[2])):
                if timed:
                    with sweep:
                        ref, ms = timed_call(fn)
                    plain_ms[what], sweeps[what] = ms, sweep
                else:
                    ref = fn()
                refs.append(ref)
            ref, r_ref, c_ref = refs
            torch.cuda.synchronize()
            tag = f"{name}/{mode}"
            for t in (out, r, c):
                check(bool(torch.isfinite(t).all())
                      and float(t.abs().sum()) > 0.0,
                      f"trilinear kernels {tag}: finite, non-zero")
            s_bar = homog_bar(out[:, hold].T, ref.T)
            r_bar = homog_bar(r[0], r_ref[0], channels=1)
            c_bar = homog_bar(c[:, idx_t].T, c_ref.T)
            nz = r_ref[1] > R_VAR_FLOOR
            v_med = float(((r[1] - r_ref[1]).abs()[nz] / r_ref[1][nz])
                          .median())
            for what, (median, share) in (("sum", s_bar), ("R mean", r_bar),
                                          ("clustered", c_bar)):
                check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
                      f"trilinear {what} {tag}: median {median}, share "
                      f"{share}")
            check(v_med < R_VAR_MEDIAN, f"trilinear R var {tag}: {v_med}")
            errs["sum"] = max(errs["sum"], float((out[:, hold] - ref).abs()
                                                 .max()))
            errs["r"] = max(errs["r"], float((r - r_ref).abs().max()))
            errs["clustered"] = max(errs["clustered"], float(
                (c[:, idx_t] - c_ref).abs().max()))
            results.append(
                f"{tag}: sum median {s_bar[0]:.2e} share {s_bar[1]:.4f}, R "
                f"mean {r_bar[0]:.2e} share {r_bar[1]:.4f} var {v_med:.2e}, "
                f"clustered {c_bar[0]:.2e} share {c_bar[1]:.4f}")
    del u_full, u_c, u_r
    # the checking launches of the trilinear clustered sum and R
    c_chk, c_counts = vrl_sum_hetero_clustered_check(*packs_t, sop, tv, tw,
                                                     seed=seed, **kw)
    r_chk, r_counts = vrl_r_hetero_check(*packs_rt, seed=seed, **kw)
    sub_c_counts = vrl_sum_hetero_clustered_check(*sub_ct, sop[idx], tv, tw,
                                                  seed=seed, **kw)[1]
    for what, counts, (median, share) in (
            ("clustered", c_counts, homog_bar(c_chk.T, vrl_sum_hetero_clustered(
                *packs_t, sop, tv, tw, seed=seed, **kw).T)),
            ("R", r_counts, homog_bar(r_chk[0], vrl_r_hetero(
                *packs_rt, seed=seed, **kw)[0], channels=1)),
            ("clustered sample", sub_c_counts, (0.0, 0.0))):
        check(counts["bad_tris"] == 0 and counts["bad_segments"] == 0,
              f"trilinear {what}: the pre-reject disagrees with the Wald "
              f"test: {counts}")
        check(counts["segments"] > 0 and counts["skipped"] > 0,
              f"trilinear {what}: checking counts {counts}")
        check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
              f"trilinear {what}: the checking launch against the kernel: "
              f"median {median}, share {share}")

    # the main path: render_alvrl (kernels 6 and 4) and the unclustered
    # render (kernel 3) of the fast_tau=False medium, their trilinear
    # launches; the image means against the nearest forms' on the same
    # VRLs and seeds
    for fn in (vrl_sum_hetero, vrl_r_hetero, vrl_sum_hetero_clustered):
        fn.tri_launches = 0
    img, vrls_m, _ = alvrl.render_alvrl(
        tri_scene, torch.Generator().manual_seed(146), c4["params"], cfg,
        c4["tcfg"], slice_info=info)
    img_u = integrator.render_with_vrls_kernel(
        tri_scene, vrls_m, torch.Generator().manual_seed(1146), cfg)
    torch.cuda.synchronize()
    tri_launches = (vrl_sum_hetero.tri_launches, vrl_r_hetero.tri_launches,
                    vrl_sum_hetero_clustered.tri_launches)
    check(min(tri_launches) >= 1, f"the trilinear launches {tri_launches}")
    img_n = integrator.render_with_vrls_kernel(
        scene, vrls_m, torch.Generator().manual_seed(1146), cfg)
    for t in (img, img_u):
        check(tuple(t.shape) == (C4_SIZE, C4_SIZE, 3)
              and bool(torch.isfinite(t).all()) and float(t.abs().max()) > 0,
              "trilinear images: shape, finite, non-zero")
    mean_ratio = float(img_u.mean()) / float(img_n.mean())
    check(abs(mean_ratio - 1.0) < TRI_MEAN_BAND,
          f"trilinear / nearest image mean {mean_ratio}")
    # the plain render of the trilinear medium: kernel 3's Philox hold
    seed_u = int(torch.randint(0, 2**31 - 1, (1,), generator=torch.Generator(
    ).manual_seed(1146)))
    hp = integrator.pack_frame(tri_scene, vrls_m)[3]
    with plain_chunk(C4_PLAIN_CHUNK):
        ref_u = vrl_sum_hetero_reference(
            hp[0][:, hold].contiguous(), *hp[1:], philox_draws(
                seed_u, hold[:, None],
                torch.arange(vrls_m.capacity, device=dev)[None], 6), **kw)
    main_bar = homog_bar(vrl_sum_hetero(*hp, seed=seed_u, **kw)[:, hold].T,
                         ref_u.T)
    check(main_bar[0] < HOMOG_MEDIAN and main_bar[1] < HOMOG_SHARE,
          f"the trilinear render's sums against the plain: {main_bar}")

    # times: each form alone at the main path's shape, the nearest form on
    # the same inputs in turns (nearest, trilinear, trilinear, nearest),
    # and each trilinear form on its hold's inputs beside its plain version
    lib_block = vsc.ray_block(True)
    tiles = [torch.as_tensor(a, device=dev) for a in group_by_slice(
        sop, lib_block)]
    sub_tiles = [torch.as_tensor(a, device=dev) for a in group_by_slice(
        sop[idx], lib_block)]
    c_out = torch.zeros((3, n_rays), device=dev)
    c_sub_out = torch.zeros((3, len(idx)), device=dev)

    def launches(p, p_r, p_sub, p_csub):
        grid_arg = (p[4], cfg.uv_tau_steps)
        return {
            "sum": lambda: vrl_sum_hetero(*p, seed=seed, **kw),
            "r": lambda: vrl_r_hetero(*p_r, seed=seed, **kw),
            "clustered": lambda: vsc._launch(
                vsc._library(), *p[:4], *tiles, tv, tw, None, seed, 2, 2,
                True, 0, c_out, grid_arg),
            "sum sample": lambda: vrl_sum_hetero(*p_sub, seed=seed, **kw),
            "clustered sample": lambda: vsc._launch(
                vsc._library(), *p_csub[:4], *sub_tiles, tv, tw, None, seed,
                2, 2, True, 0, c_sub_out, grid_arg)}

    near = launches(packs_n, packs_rn, (packs_n[0][:, hold].contiguous(),
                                        *packs_n[1:]),
                    (packs_n[0][:, idx_t].contiguous(), *packs_n[1:]))
    tri = launches(packs_t, packs_rt, sub_t, sub_ct)
    times = {k: {"nearest": [], "trilinear": []} for k in near}
    for form in ("nearest", "trilinear", "trilinear", "nearest"):
        fns = near if form == "nearest" else tri
        for k, fn in fns.items():
            if k == "sum":
                times[k][form] += cuda_ms(fn, 1, 2)
            else:
                times[k][form] += cuda_ms_batched(fn, 2, 3, 5)
    med = {k: {f: summary(v)[0] for f, v in t.items()}
           for k, t in times.items()}
    # the trilinear forms' bounds on the holds' inputs, the plain
    # versions' Philox samples counted (SweepCount), the clustered sum's
    # and R's sweeps priced on their checking launches' skips
    uv = cfg.uv_tau_steps
    r_ops = kernel_ops("vrl_r", sweeps["r"], True, True, uv, tri=True)
    c_ops = kernel_ops("vrl_sum_clustered", sweeps["clustered"], True, True,
                       uv, tri=True)
    bounds = {
        "sum": bound(kernel_ops("vrl_sum", sweeps["sum"], True, True, uv,
                                tri=True), nbytes(*sub_t) + 3 * len(hold) * 4),
        "r": bound(plane_ops(r_ops, sweeps["r"], r_counts),
                   nbytes(*packs_rt) + 2 * n_rep * n_vrls * 4),
        "clustered": bound(plane_ops(c_ops, sweeps["clustered"],
                                     sub_c_counts),
                           nbytes(*sub_ct, tv, tw, *sub_tiles)
                           + 3 * len(idx) * 4)}
    ms_of = {"sum": med["sum sample"]["trilinear"], "r": med["r"]["trilinear"],
             "clustered": med["clustered sample"]["trilinear"]}

    # the nearest forms' outputs against the parent's (kernel_digest.py
    # --grid)
    digests = kernel_digest.grid_digests(dev)
    check(digests == PARENT_DIGESTS_GRID, "the nearest grid forms' outputs "
          f"differ from the parent's: {digests}")
    print(f"[46 trilinear grid kernels on {card}, config 4 with "
          f"fast_tau=False: B={n_rays} N={n_vrls} P={n_rep} S={tv.shape[0]} "
          f"C={n_cols}, density {tuple(packs_t[4].shape)} read trilinearly; "
          f"kernel 3 held on every {stride}th ray ({len(hold)}), kernel 4 on "
          f"slices {int(rows[0])}-{int(rows[n_sl - 1])} ({len(idx)} rays), "
          f"kernel 6 on all {n_rep} representatives] " + " | ".join(results)
          + f" | checking launches: clustered {check_line(c_counts)}; R "
          f"{check_line(r_counts)}; the clustered hold's "
          f"{check_line(sub_c_counts)} | main path: render_alvrl and the "
          f"unclustered render of the fast_tau=False medium, trilinear "
          f"launches vrl_sum_hetero {tri_launches[0]} vrl_r_hetero "
          f"{tri_launches[1]} vrl_sum_hetero_clustered {tri_launches[2]}, "
          f"unclustered image mean {float(img_u.mean()):.6f} vs the nearest "
          f"form's {float(img_n.mean()):.6f} on the same VRLs (ratio "
          f"{mean_ratio:.5f}), its sums vs plain on the hold median "
          f"{main_bar[0]:.2e} share {main_bar[1]:.4f} | ms (CUDA events, "
          "nearest / trilinear, in turns): " + "; ".join(
              f"{k} {m['nearest']:.4f} / {m['trilinear']:.4f} "
              f"(x{m['trilinear'] / m['nearest']:.2f})" for k, m in med.items())
          + " | on the holds' inputs: plain " + ", ".join(
              f"{k} {v:.1f} ms" for k, v in plain_ms.items()) + "; bounds "
          + ", ".join(f"{k} {b[0]:.4f} ms by {b[1]}" for k, b in bounds.items())
          + f" | nearest forms' digests (kernel_digest.py --grid) the "
          f"parent's: {len(digests)} equal | "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    # 47. oriented media through volpath; the quadrature sampler against
    # Woodcock in the VRL render; the refusals
    t47 = time.perf_counter()
    vcfg = volpath.VolpathConfig(max_depth=ORIENT_DEPTH, only_vrl_paths=False)
    orient = []
    for label, kind, sampling in (("microflake/Woodcock", ph.MICROFLAKE, 0),
                                  ("Kajiya-Kay/quadrature", ph.KKAY, 1)):
        o_scene = oriented_scene(scene, kind, sampling, dev)
        t0 = time.perf_counter()
        o_img = volpath.render_volpath(
            o_scene, torch.Generator(device=dev).manual_seed(47),
            spp=ORIENT_SPP, cfg=vcfg)
        torch.cuda.synchronize()
        o_ms = (time.perf_counter() - t0) * 1e3
        check(tuple(o_img.shape) == (ORIENT_SIZE, ORIENT_SIZE, 3)
              and bool(torch.isfinite(o_img).all())
              and float(o_img.mean()) > 0.0,
              f"volpath on the {label} medium: finite, non-zero")
        orient.append(f"{label} mean {float(o_img.mean()):.6f} "
                      f"{o_ms:.0f} ms")
    q_scene = presets.cornell_grid_smoke(QUAD_SIZE, QUAD_SIZE,
                                         grid_res=C4_GRID, device=dev)
    means = {}
    for sampling in (0, 1):
        sc = replace(q_scene, medium=replace(q_scene.medium,
                                             sampling=sampling))
        for k in range(QUAD_SEEDS):
            g = torch.Generator().manual_seed(470 + k)
            v = vrl.compact(tracer.trace(sc, g, C4_PARAMS["num_particles"],
                                         c4["tcfg"]),
                            C4_PARAMS["vrl_target_num"],
                            slots_per_particle=C4_DEPTH)
            means.setdefault(sampling, []).append(float(
                integrator.render_with_vrls_kernel(sc, v, g, cfg).mean()))
    mw, mq = (np.array(means[s]) for s in (0, 1))
    se = math.sqrt(mw.var(ddof=1) / len(mw) + mq.var(ddof=1) / len(mq))
    z = abs(mq.mean() - mw.mean()) / max(se, 1e-30)
    check(z < QUAD_Z, f"sampling=1 vs Woodcock image means: z {z} "
          f"({means})")
    refusals = []
    for what, fn, item in (
            ("an oriented medium in render_with_vrls_kernel", lambda: (
                integrator.render_with_vrls_kernel(
                    oriented_scene(scene, ph.MICROFLAKE, 0, dev), vrls,
                    torch.Generator(), cfg)), "only volpath"),):
        try:
            fn()
        except ValueError as e:
            check(item in str(e), f"{what}: {e}")
            refusals.append(f"{what}: ValueError ({item})")
        else:
            check(False, f"{what} was not refused")
    # the trilinear medium's differentiable render: kernel 9's trilinear
    # form (phase 49 holds it)
    bwd.vrl_sum_hetero_bwd.launches = bwd.vrl_sum_hetero_bwd.tri_launches = 0
    dens = tri_scene.medium.density.clone().requires_grad_()
    img = integrator.render_with_vrls_kernel_diff(
        replace(tri_scene, medium=gmed.with_density(tri_scene.medium, dens)),
        vrls, torch.Generator(), cfg)
    (g_dens,) = torch.autograd.grad(img.sum(), dens)
    check(bwd.vrl_sum_hetero_bwd.tri_launches == 1
          and bool(torch.isfinite(g_dens).all())
          and float(g_dens.abs().max()) > 0.0,
          "fast_tau=False in render_with_vrls_kernel_diff: kernel 9's "
          "trilinear form")
    refusals.append("fast_tau=False in render_with_vrls_kernel_diff: "
                    "kernel 9's trilinear form, 1 launch, d density finite")
    print(f"[47 oriented media and the quadrature sampler on {card}] volpath "
          f"on config 4's plume at {ORIENT_RES}^3 with a swirl of fibers, "
          f"{ORIENT_SIZE}x{ORIENT_SIZE}, {ORIENT_SPP} spp, depth "
          f"{ORIENT_DEPTH}: " + "; ".join(orient) + f" | the VRL render of "
          f"config 4's plume at {QUAD_SIZE}x{QUAD_SIZE} from VRLs of each "
          f"sampler, {QUAD_SEEDS} seeds: Woodcock mean {mw.mean():.6f}, "
          f"sampling=1 {mq.mean():.6f}, z {z:.2f} | refusals and routes: "
          + "; ".join(refusals) + f" | {time.perf_counter() - t47:.1f} s",
          flush=True)

    def entry(name, src, line, n, key):
        return {"name": name, "route": "cuda",
                "source": f"alvrl_tpu_torch/csrc/{src}",
                "replaces": f"alvrl_tpu/ops/vrl_pallas.py:{line}",
                "launches": n, "max_abs_err": errs[key], "ms": ms_of[key],
                "plain_ms": plain_ms[key], "bound_ms": bounds[key][0],
                "bound_by": bounds[key][1], "library_ms": None}

    return [entry("vrl_sum_hetero trilinear", "vrl_sum.cu", 863,
                  tri_launches[0], "sum"),
            entry("vrl_r_hetero trilinear", "vrl_r.cu", 1082,
                  tri_launches[1], "r"),
            entry("vrl_sum_hetero_clustered trilinear",
                  "vrl_sum_clustered.cu", 937, tri_launches[2], "clustered")]


# phase 48: glossy surfaces in a grid medium and on large meshes. The
# glossy grid scene: cornell_glossy's box and table (GLOSSY_MATERIALS,
# GLOSSY_FACES) in config 4's medium (its 48^3 density) at 512x512; the
# glossy cube field: phase 29/30's 15,984-triangle field with the table's
# eleven smooth kinds on its cubes in turn and cornell_glossy's on its
# walls, and that field (diffuse) in phase 43's mixture + single medium
# and in an HG medium of the single strategy
GG_SEED = 20261019
GG_R_RAYS = 256        # rays of each kind in kernel 6's hold
GG_SLICES, GG_COLS = 16, 64  # kernel 4's hold: a seeded table
FIELD_AXES, SMALL_AXES = bbl.CUBE_AXES[0], 4  # 15,984 and 780 triangles
# the forms of phase 48 in the kernels line: (name, source, the TPU
# kernel it replaces)
GG_FORMS = {
    "3m": ("vrl_sum_hetero material", "vrl_sum.cu", 863),
    "3tm": ("vrl_sum_hetero material trilinear", "vrl_sum.cu", 863),
    "4m": ("vrl_sum_hetero_clustered material", "vrl_sum_clustered.cu",
           937),
    "4tm": ("vrl_sum_hetero_clustered material trilinear",
            "vrl_sum_clustered.cu", 937),
    "6m": ("vrl_r_hetero material", "vrl_r.cu", 1082),
    "6tm": ("vrl_r_hetero material trilinear", "vrl_r.cu", 1082),
    "7m": ("vrl_sum_bvh material", "vrl_sum_bvh.cu", 1415),
    "7x": ("vrl_sum_bvh extended (mixture, strategy)", "vrl_sum_bvh.cu",
           1415),
}
GG_RUNS = [
    ("glossy grid vrl", "glossy_grid.json", "vrl", 2, [],
     ("vrl_sum_hetero",)),
    ("glossy grid alvrl", "glossy_grid.json", "alvrl", 2,
     ["--particles", "192"], ("vrl_r_hetero", "vrl_sum_hetero_clustered")),
    ("glossy field vrl", "glossy_field.json", "vrl", 1,
     ["--particles", "64", "--vrls", "256"], ("vrl_sum_bvh",)),
]
# the run whose in-process render phase 48 traces for the idle share: the
# cheapest to trace (tracing the grid scene's render took 35-40 s of the
# phase on an H100 machine)
GG_PROFILED = "glossy field vrl"


def glossy_grid_desc(c1, c4_scene, tmp):
    """The glossy grid scene as a JSON dict ($w x $h): cornell_glossy's
    (glossy_json) in config 4's grid medium, its density in tmp."""
    med = c4_scene.medium
    path = os.path.join(tmp, "glossy_density.npy")
    np.save(path, med.density.cpu().numpy())
    desc = glossy_json(c1)
    desc["medium"] = {
        "type": "grid", "density_npy": path,
        "sigma_t": med.sigma_t_color.cpu().tolist(),
        "albedo": med.albedo.cpu().tolist(), "g": float(med.g),
        "box_min": med.box_min.cpu().tolist(),
        "box_max": med.box_max.cpu().tolist(), "scale": float(med.scale),
        "phase": "hg"}
    return desc


def glossy_field(dev, table, n_axis=FIELD_AXES):
    """The cube field with the glossy table `table` (a scene's Materials,
    GLOSSY_MATERIALS in order): cornell_glossy's wall materials, the
    eleven smooth materials on the cubes in turn."""
    field = bbl.scene_of("cubes", n_axis, device=dev)
    names = [m["name"] for m in GLOSSY_MATERIALS]
    walls = [names.index(n) for n in GLOSSY_FACES[:12]]
    n_cubes = (field.faces.shape[0] - 12) // 12
    cubes = 1 + np.repeat(np.arange(n_cubes) % (len(names) - 1), 12)
    ids = torch.as_tensor(np.concatenate([walls, cubes]), device=dev)
    return replace(field, materials=table, material=ids)


def field_media(field):
    """The cube field's extended media: (name, scene): phase 43's
    mixture + single medium, an HG medium of the single strategy."""
    med = field.medium
    sig_s = torch.tensor(SKY_SIGMA_S, device=field.device)
    mix = ph.mixture_params([0.6, 0.3], [ph.HG, ph.RAYLEIGH], [0.8, 0.0],
                            device=field.device)
    return [("mixture", replace(field, medium=replace(
                med, sigma_s=sig_s, sigma_a=torch.zeros_like(sig_s),
                phase_kind=ph.MIXTURE, phase_params=mix, strategy=1,
                channel=0))),
            ("strategy", replace(field, medium=replace(
                med, sigma_s=sig_s, strategy=1, channel=1)))]


def glossy_grid(dev, card, cfg, c1, c4):
    """Phase 48: the material forms of kernels 3, 4 and 6 (nearest and
    trilinear) on the glossy grid scene and kernel 7's material and
    extended forms on the cube field, against their plain versions kind
    by kind, their checking and counting launches, the main path's
    launches, times against the forms they extend, bounds; the CLI on
    both scene files. Returns the kernels line's eight entries."""
    t48 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        desc = glossy_grid_desc(c1, c4["scene"], tmp)
        path = os.path.join(tmp, "glossy_grid.json")
        with open(path, "w") as f:
            f.write(json.dumps(desc).replace('"$w"', "$w").replace(
                '"$h"', "$h"))
        scene = loader.load_json(path, {"w": C4_SIZE, "h": C4_SIZE},
                                 device=dev)
        check(bsdf_api.check_kinds(scene) == bsdf_api.MATERIAL_FORM_KINDS
              - bsdf_api.DELTA_KINDS and hasattr(scene.medium, "density")
              and torch.equal(scene.medium.density,
                              c4["scene"].medium.density),
              "the glossy grid scene's kinds and medium")
        print(f"[48 setup] the glossy grid scene loaded in "
              f"{time.perf_counter() - t48:.1f} s", flush=True)
        grid_out = glossy_grid_forms(dev, card, cfg, scene, c4)
        field_out = glossy_field_forms(dev, card, scene.materials)
        fdesc = scene_json(field_out["field"], homog_medium(
            field_out["field"]))
        fdesc["materials"] = GLOSSY_MATERIALS
        names = [m["name"] for m in GLOSSY_MATERIALS]
        for sh in fdesc["shapes"]:
            sh["material"] = names[int(sh["material"][1:])]
        with open(os.path.join(tmp, "glossy_field.json"), "w") as f:
            json.dump(fdesc, f)
        runs = [(label, name, integ, passes,
                 ["-D", f"w={C4_SIZE}", "-D", f"h={C4_SIZE}", *opts]
                 if name == "glossy_grid.json" else opts, route)
                for label, name, integ, passes, opts, route in GG_RUNS]
        t48c = time.perf_counter()
        cli = cli_runs(dev, card, tmp, runs, "48c the CLI on the glossy "
                       "scene files", profile=GG_PROFILED)
        t_cli = time.perf_counter() - t48c
    prof = cli.pop("profile")
    idle = ("not measured" if prof is None
            else f"{1 - prof[1] / prof[0]:.1%} (span {prof[0]:.1f} ms)")
    print(f"[48 on {card}] {GG_PROFILED}'s in-process render: idle share "
          f"{idle}; ms a pass: " + ", ".join(
              f"{k} {v[0]:.1f} (spread {v[1]:.1%})" for k, v in cli.items())
          + f" | 48c {t_cli:.1f} s, phase 48 {time.perf_counter() - t48:.1f}"
          " s", flush=True)
    out = {**grid_out["entries"], **field_out["entries"]}
    return [out[k] for k in GG_FORMS]


def gg_entry(key, launches, err, ms, plain_ms, bnd):
    name, src, line = GG_FORMS[key]
    return {"name": name, "route": "cuda",
            "source": f"alvrl_tpu_torch/csrc/{src}",
            "replaces": f"alvrl_tpu/ops/vrl_pallas.py:{line}",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": None}


def glossy_grid_forms(dev, card, cfg, scene, c4):
    """48a: kernels 3, 4 and 6's material forms, nearest and trilinear."""
    t0 = time.perf_counter()
    params, tcfg = c4["params"], c4["tcfg"]
    gen = torch.Generator().manual_seed(GG_SEED)
    vrls = vrl.compact(tracer.trace(scene, gen, params.num_particles, tcfg),
                       params.vrl_target_num, slots_per_particle=C4_DEPTH)
    n_vrls, seed = vrls.capacity, GG_SEED
    info = alvrl.build_slice_info(scene, params)
    rng = np.random.default_rng(48)
    lines, entries = [], {}
    for fast_tau, tag in ((True, ""), (False, "t")):
        sc = replace(scene, medium=replace(scene.medium, fast_tau=fast_tau))
        read = "nearest" if fast_tau else "trilinear"
        mats = integrator.material_pack(sc)
        packs = integrator.pack_frame(sc, vrls, materials=mats)[3]
        dpacks = integrator.pack_frame(sc, vrls)[3]
        check(packs[0].shape[0] == pk.GRID_MAT_RAY_ROWS
              and torch.equal(packs[0][:pk.GRID_RAY_ROWS], dpacks[0])
              and pk.is_trilinear(packs[3]) != fast_tau,
              f"the glossy grid packs ({read})")
        kind = mats[0][packs[0][pk.GRID_MATID].long(), pk.MT_KIND].long()
        surf = mats[0][packs[0][pk.GRID_MATID].long(), pk.MT_SMOOTH] > 0.5
        kind_np = kind.cpu().numpy()
        pick = torch.as_tensor(np.concatenate([rng.choice(
            np.flatnonzero(kind_np == k), GLOSSY_KIND_RAYS, replace=False)
            for k in sorted(GLOSSY_KINDS)]), device=dev)
        r_pick = pick.reshape(len(GLOSSY_KINDS), -1)[:, :GG_R_RAYS].reshape(-1)
        sub, dsub = ((p[0][:, pick].contiguous(), *p[1:])
                     for p in (packs, dpacks))
        rsub, drsub = ((p[0][:, r_pick].contiguous(), *p[1:])
                       for p in (packs, dpacks))
        n_sub, n_r = len(pick), len(r_pick)
        sop = np.arange(n_sub, dtype=np.int32) % GG_SLICES
        tv = torch.as_tensor(rng.integers(0, n_vrls, (GG_SLICES, GG_COLS)),
                             dtype=torch.int32, device=dev)
        tw = torch.as_tensor(rng.uniform(0.0, 2.0, (GG_SLICES, GG_COLS)),
                             dtype=torch.float32, device=dev)
        mkw = dict(materials=mats, uv_steps=cfg.uv_tau_steps)
        u3 = philox_uniforms(seed, n_sub, n_vrls, 6, device=dev)
        u4 = philox_table_uniforms(seed, sop, tv, 6)
        u6 = philox_uniforms(seed, n_r, n_vrls, 6, device=dev)
        outs = {"3": vrl_sum_hetero(*sub, seed=seed, **mkw),
                "4": vrl_sum_hetero_clustered(*sub, sop, tv, tw, seed=seed,
                                              **mkw),
                "6": vrl_r_hetero(*rsub, seed=seed, **mkw)}
        alb = surf[pick]
        with plain_chunk(C4_PLAIN_CHUNK):
            with SweepCount(*pair_masks(*sub[:2])[:1], alb) as s3:
                ref3, p3 = timed_call(lambda: vrl_sum_hetero_reference(
                    *sub, u3, **mkw))
            with SweepCount(table_pair_ok(sub[0], sub[1], sop, tv, tw),
                            alb) as s4:
                ref4, p4 = timed_call(
                    lambda: vrl_sum_hetero_clustered_reference(
                        *sub, sop, tv, tw, u4, **mkw))
            with SweepCount(*pair_masks(*rsub[:2])[:1], surf[r_pick]) as s6:
                ref6, p6 = timed_call(lambda: vrl_r_hetero_reference(
                    *rsub, u6, **mkw))
        torch.cuda.synchronize()
        for k, o in outs.items():
            check(bool(torch.isfinite(o).all()) and float(o.abs().sum()) > 0,
                  f"kernel {k} ({read}, material): finite and non-zero")
        ksub, kr = kind[pick], kind[r_pick]
        held = [hold_by_kind(f"kernel 3 {read}", outs["3"].T, ref3.T, ksub),
                hold_by_kind(f"kernel 4 {read} ({GG_COLS} columns)",
                             outs["4"].T, ref4.T, ksub),
                hold_by_kind(f"kernel 6 {read} mean", outs["6"][0], ref6[0],
                             kr[:, None].expand(-1, n_vrls), 1,
                             GG_R_RAYS * n_vrls)]
        nz = ref6[1] > R_VAR_FLOOR
        v_med = float(((outs["6"][1] - ref6[1]).abs()[nz] / ref6[1][nz])
                      .median())
        check(v_med < R_VAR_MEDIAN, f"kernel 6 {read} var {v_med}")
        errs = {"3": float((outs["3"] - ref3).abs().max()),
                "4": float((outs["4"] - ref4).abs().max()),
                "6": float((outs["6"] - ref6).abs().max())}
        # the checking launches of kernels 4 and 6
        c_chk, c_counts = vrl_sum_hetero_clustered_check(
            *sub, sop, tv, tw, seed=seed, **mkw)
        r_chk, r_counts = vrl_r_hetero_check(*rsub, seed=seed, **mkw)
        for what, counts in (("kernel 4", c_counts), ("kernel 6", r_counts)):
            check(counts["bad_tris"] == 0 and counts["bad_segments"] == 0
                  and counts["segments"] > 0, f"{what} {read} (material): "
                  f"the checking launch: {counts}")
        check(torch.equal(c_chk, outs["4"]), f"kernel 4 {read}: the checking "
              "launch is not the sum's")
        # the main path: the unclustered render and render_alvrl
        fns = (vrl_sum_hetero, vrl_r_hetero, vrl_sum_hetero_clustered)
        for fn in fns:
            fn.launches = fn.mat_launches = fn.tri_launches = 0
        with plain_calls() as plain:
            img = integrator.render_with_vrls_kernel(
                sc, vrls, torch.Generator().manual_seed(148), cfg)
            img_c, _, _ = alvrl.render_alvrl(
                sc, torch.Generator().manual_seed(248), params, cfg, tcfg,
                slice_info=info)
            torch.cuda.synchronize()
        launches = {fn.__name__: (fn.launches, fn.mat_launches,
                                  fn.tri_launches) for fn in fns}
        check(plain[0] == 0 and all(
            n >= 1 and m == n and t == (0 if fast_tau else n)
            for n, m, t in launches.values()),
            f"the main path's launches ({read}): {launches}, plain calls "
            f"{plain[0]}")
        for name, im in (("unclustered", img), ("clustered", img_c)):
            check(tuple(im.shape) == (C4_SIZE, C4_SIZE, 3)
                  and bool(torch.isfinite(im).all())
                  and float(im.abs().max()) > 0, f"the {name} image")
        # its sums on a Philox hold against the plain version
        seed_u = integrator.draw_seed(torch.Generator().manual_seed(148))
        hold = torch.arange(0, packs[0].shape[1], 64, device=dev)
        with plain_chunk(C4_PLAIN_CHUNK):
            ref_u = vrl_sum_hetero_reference(
                packs[0][:, hold].contiguous(), *packs[1:], philox_draws(
                    seed_u, hold[:, None],
                    torch.arange(n_vrls, device=dev)[None], 6), **mkw)
        main_bar = homog_bar(vrl_sum_hetero(*packs, seed=seed_u, **mkw)[
            :, hold].T, ref_u.T)
        check(main_bar[0] < HOMOG_MEDIAN and main_bar[1] < HOMOG_SHARE,
              f"the glossy grid render's sums against the plain: {main_bar}")
        diffuse = integrator.develop_sums(
            sc, vrls, *integrator.pack_frame(sc, vrls)[:3],
            vrl_sum_hetero(*dpacks, seed=seed_u, uv_steps=cfg.uv_tau_steps))
        ratio = float(img.mean()) / float(diffuse.mean())
        check(ratio > 1.0, f"the material render against the diffuse form's "
              f"on the same seed: x{ratio}")
        # times: each material form beside its diffuse form on the same
        # inputs, in turns (diffuse, material, material, diffuse)
        block = vsc.ray_block(True)
        tiles = [torch.as_tensor(a, device=dev)
                 for a in group_by_slice(sop, block)]
        c_out = torch.zeros((3, n_sub), device=dev)
        grid_arg = (sub[4], cfg.uv_tau_steps)

        def c_launch(p, **kw):
            return lambda: vsc._launch(vsc._library(), *p[:4], *tiles, tv,
                                       tw, None, seed, 2, 2, True, 0, c_out,
                                       grid_arg, **kw)

        timed = {"3": (lambda: vrl_sum_hetero(*sub, seed=seed, **mkw),
                       lambda: vrl_sum_hetero(*dsub, seed=seed,
                                              uv_steps=cfg.uv_tau_steps)),
                 "4": (c_launch(sub, materials=mats), c_launch(dsub)),
                 "6": (lambda: vrl_r_hetero(*rsub, seed=seed, **mkw),
                       lambda: vrl_r_hetero(*drsub, seed=seed,
                                            uv_steps=cfg.uv_tau_steps))}
        ms = {}
        for k, (mat_fn, diff_fn) in timed.items():
            runs = [cuda_ms_batched(f, 2, 3, 5) for f in (diff_fn, mat_fn,
                                                          mat_fn, diff_fn)]
            ms[k] = (summary(runs[1] + runs[2]), summary(runs[0] + runs[3]))
        uv = cfg.uv_tau_steps

        def mat_ops(kernel, sweep, counts=None):
            f, s = kernel_ops(kernel, sweep, True, True, uv, tri=not fast_tau)
            if counts is not None:
                f, s = plane_ops((f, s), sweep, counts)
            return (f + sweep.open[1] * OPS["eval_smooth"][0],
                    s + sweep.open[1] * OPS["eval_smooth"][1])

        mat_bytes = nbytes(*mats)
        bounds = {
            "3": bound(mat_ops("vrl_sum", s3), nbytes(*sub) + mat_bytes
                       + 3 * n_sub * 4),
            "4": bound(mat_ops("vrl_sum_clustered", s4, c_counts),
                       nbytes(*sub, tv, tw, *tiles) + mat_bytes
                       + 3 * n_sub * 4),
            "6": bound(mat_ops("vrl_r", s6, r_counts), nbytes(*rsub)
                       + mat_bytes + 2 * n_r * n_vrls * 4)}
        plain_ms = {"3": p3, "4": p4, "6": p6}
        counts = {"3": launches["vrl_sum_hetero"][1],
                  "4": launches["vrl_sum_hetero_clustered"][1],
                  "6": launches["vrl_r_hetero"][1]}
        for k in ("3", "4", "6"):
            entries[f"{k}{tag}m"] = gg_entry(
                f"{k}{tag}m", counts[k], errs[k], ms[k][0][0], plain_ms[k],
                bounds[k])
        lines.append(
            f"{read}: " + "; ".join(held) + f"; kernel 6 var median "
            f"{v_med:.2e} | checking launches: kernel 4 "
            f"{check_line(c_counts)}; kernel 6 {check_line(r_counts)} | "
            f"main path launches (all, material, trilinear) {launches}, "
            f"no plain call; images' means {float(img.mean()):.6g} and "
            f"{float(img_c.mean()):.6g}, x{ratio:.4f} the diffuse form's on "
            f"the same seed; its sums vs plain on every 64th ray median "
            f"{main_bar[0]:.2e} share {main_bar[1]:.4f} | ms (CUDA events, "
            "material / diffuse, in turns): " + "; ".join(
                f"kernel {k} {m[0]:.4f} / {d[0]:.4f} (x{m[0] / d[0]:.2f})"
                for k, (m, d) in ms.items()) + " | plain " + ", ".join(
                f"kernel {k} {v:.1f} ms" for k, v in plain_ms.items())
            + "; bounds " + ", ".join(f"kernel {k} {b[0]:.4f} ms by {b[1]}"
                                      for k, b in bounds.items())
            + f"; samples: kernel 3 {s3}; kernel 4 {s4}; kernel 6 {s6}")
    regs = [r for r in ptxas_summary(_build.build_log())
            if ",grid," in r and ",mat" in r]
    print(f"[48a grid material forms on {card}, the glossy grid scene "
          f"{C4_SIZE}x{C4_SIZE} in config 4's {C4_GRID}^3 medium, {n_vrls} "
          f"traced VRLs; kernels 3 and 4 on {GLOSSY_KIND_RAYS} rays of each "
          f"kind, kernel 6 on {GG_R_RAYS}] " + " || ".join(lines)
          + " | ptxas: " + " ; ".join(regs)
          + f" | {time.perf_counter() - t0:.1f} s", flush=True)
    return {"entries": entries}


def glossy_field_forms(dev, card, table):
    """48b: kernel 7's material and extended forms on the cube field."""
    t0 = time.perf_counter()
    field = glossy_field(dev, table)
    vrls = bbl.bench_vrls(field)
    seed = GG_SEED
    cases = [("glossy", field)] + field_media(bbl.scene_of(
        "cubes", FIELD_AXES, device=dev))
    small = {"glossy": glossy_field(dev, table, SMALL_AXES)}
    small.update(field_media(bbl.scene_of("cubes", SMALL_AXES, device=dev)))
    lines, errs, ms, plain_ms, bounds, launches = [], {}, {}, {}, {}, {}
    for name, sc in cases:
        key = "7m" if name == "glossy" else "7x"
        mats = integrator.material_pack(sc)
        kw = dict(phase_kind=sc.medium.phase_kind, materials=mats)
        for f in ("launches", "mat_launches", "mix_launches"):
            setattr(vb.vrl_sum_bvh, f, 0)
        with plain_calls() as plain:
            img = integrator.render_with_vrls_kernel_bvh(
                sc, vrls, torch.Generator().manual_seed(348))
            torch.cuda.synchronize()
        moved = (vb.vrl_sum_bvh.launches, vb.vrl_sum_bvh.mat_launches,
                 vb.vrl_sum_bvh.mix_launches)
        check(plain[0] == 0 and moved == ((1, 1, 0) if key == "7m"
                                          else (1, 0, 1))
              and bool(torch.isfinite(img).all())
              and float(img.abs().max()) > 0,
              f"kernel 7 {name}: the render's launches {moved}")
        launches[key] = launches.get(key, 0) + moved[1 if key == "7m" else 2]
        packs = integrator.pack_frame_bvh(sc, vrls, materials=mats)[3]
        dpacks = (integrator.pack_frame_bvh(sc, vrls)[3] if mats is not None
                  else (*packs[:3], pk.pack_medium(replace(sc, medium=replace(
                      sc.medium, phase_kind=ph.HG, phase_params=None,
                      strategy=0)))))
        out = vb.vrl_sum_bvh(*packs, seed=seed, **kw)
        rows = bbl.subset_rays(packs[0].shape[1]).to(dev)
        u = philox_uniforms(seed, packs[0].shape[1], packs[1].shape[1], 6,
                            device=dev)[rows].contiguous()
        ref, p_ms = timed_call(lambda: vb.vrl_sum_bvh_reference(
            packs[0][:, rows].contiguous(), *packs[1:], u, **kw))
        torch.cuda.synchronize()
        median, share = homog_bar(out[:, rows].T, ref.T)
        check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
              f"kernel 7 {name} against its plain version: {median}, "
              f"{share}")
        errs[key] = max(errs.get(key, 0.0), float((out[:, rows] - ref)
                                                  .abs().max()))
        _, counts = vb.vrl_sum_bvh_counts(*packs, seed=seed, **kw)
        check(counts["differ"] == 0 and counts["segments"] > 0,
              f"kernel 7 {name}: the counting launch {counts}")
        # kernel 1's matching form on the 780-triangle field, the same
        # rays, VRLs and uniforms
        ss = small[name]
        spk = integrator.pack_frame_bvh(ss, vrls, materials=mats)[3]
        us = torch.rand((spk[0].shape[1], spk[1].shape[1], 6), device=dev,
                        generator=torch.Generator(dev).manual_seed(48))
        a = vb.vrl_sum_bvh(*spk, uniforms=us, **kw)
        b = vrl_sum(spk[0], spk[1], spk[2].tris, spk[3], uniforms=us, **kw)
        k1_bar = homog_bar(a.T, b.T)
        check(k1_bar[0] < HOMOG_MEDIAN and k1_bar[1] < HOMOG_SHARE,
              f"kernel 7 {name} against kernel 1 at 780 triangles: {k1_bar}")
        # times against kernel 7's present form on the same field
        new_fn = lambda: vb.vrl_sum_bvh(*packs, seed=seed, **kw)  # noqa: E731
        old_fn = lambda: vb.vrl_sum_bvh(*dpacks, seed=seed)  # noqa: E731
        runs = [cuda_ms_batched(f, 1, 3, 3) for f in (old_fn, new_fn,
                                                      new_fn, old_fn)]
        m, o = summary(runs[1] + runs[2]), summary(runs[0] + runs[3])
        # the bound: bvh_bound's count on this run's samples, the vol-surf
        # samples drawn at the smooth hits (material form), each open
        # vol-surf sample's eval_smooth, and the single strategy's
        # pdfFailure, one exp ((2, 1) in place of balance's (8, 3)); a
        # mixture's phase is counted as HG's (a lower bound)
        sweep = BvhSweep(packs[0], packs[1], counts)
        if mats is not None:
            smooth = mats[0][packs[0][pk.MATID].long(), pk.MT_SMOOTH] > 0.5
            pair_ok = pair_masks(packs[0], packs[1])[0]
            sweep.drawn[1] = 2 * int((pair_ok & smooth[:, None]).sum())
        f, s = kernel_ops("vrl_sum", replace_counts(
            sweep, tri_tests=sweep.needed_tris), sc.medium.phase_kind != 1,
            True)
        f += sweep.needed_boxes * OPS["node"][0]
        s += sweep.tested[0] * OPS["bvh_segment"][1]
        if mats is not None:
            f += sweep.open[1] * OPS["eval_smooth"][0]
            s += sweep.open[1] * OPS["eval_smooth"][1]
        if sc.medium.strategy != 0:
            f -= 6 * sum(sweep.open)
            s -= 2 * sum(sweep.open)
        b_ops = (f, s)
        bnd = bound(b_ops, nbytes(packs[0], packs[1], packs[2].nodes,
                                  packs[2].tris, packs[3])
                    + (nbytes(*mats) if mats is not None else 0)
                    + 3 * packs[0].shape[1] * 4)
        if key not in ms or name == "mixture":
            ms[key], plain_ms[key], bounds[key] = m[0], p_ms, bnd
        lines.append(
            f"{name} ({'material' if mats is not None else 'extended'} "
            f"form, {sc.faces.shape[0]} triangles): vs plain on "
            f"{len(rows)} rays median {median:.2e} share {share:.4f}; vs "
            f"kernel 1 at {ss.faces.shape[0]} triangles median "
            f"{k1_bar[0]:.2e} share {k1_bar[1]:.4f}; counting launch "
            f"differ 0, {sweep}; render launches {moved}, mean "
            f"{float(img.mean()):.6g}; ms {m[0]:.4f} (spread {m[1]:.1%}) "
            f"against the present form's {o[0]:.4f} (x{m[0] / o[0]:.2f}), "
            f"plain {p_ms:.1f} ms on its {len(rows)} rays; bound "
            f"{bnd[0]:.4f} ms by {bnd[1]}")
    regs = [r for r in ptxas_summary(_build.build_log())
            if "bvh_ext" in r]
    print(f"[48b kernel 7's new forms on {card}, the cube field "
          f"{bbl.WIDTH}x{bbl.WIDTH}, {vrls.capacity} traced VRL slots] "
          + " | ".join(lines) + " | ptxas: " + " ; ".join(regs)
          + f" | {time.perf_counter() - t0:.1f} s", flush=True)
    entries = {k: gg_entry(k, launches[k], errs[k], ms[k], plain_ms[k],
                           bounds[k]) for k in ("7m", "7x")}
    return {"entries": entries, "field": field}


# phase 49: the gradient of every scene the forward renders: the new
# forms of the backward kernels 8-11. 8m and 10m are the material forms
# (cornell_glossy's table), 8x and 10x the extended ones (config 1's box in
# phase 43's mixture + single medium, MIX_PHASE and SKY_SIGMA_S), 8mx and
# 10mx both; 9m and 11m the grid material forms (phase 48's glossy grid
# scene), 9t and 11t the trilinear ones (config 4's medium of fast_tau
# False), 9tm and 11tm both. Each form is launched on its main path's
# inputs (the whole frame, the VRLs, the main path's tables) and held
# against its plain version on a seeded sample of the frame's rays, as
# phase 7 holds kernel 8 (every kind's rays alone for the material
# forms); the main paths (the train step at phase 8's shape, the
# differentiable unclustered render at full config 4, the differentiable
# clustered render on config 2's and config 4's tables) are held against
# same-seed central differences
GF_SEED = 20261020
GF_HOLD_RAYS = 2048  # the rays of each hold: a seeded sample of the frame
GF_KIND_MIN = 48     # of them, at least this many at each glossy kind
# a grid form's per-VRL sums (d_power, d_vod) over the held rays are held
# against the float64 plain version at the homogeneous bar, or, where
# the float32 plain version misses it too (ROADMAP C12: float32 sums of
# terms of both signs), no further from float64 than that version, at
# the homogeneous bar's share and under this multiple of HOMOG_MEDIAN
C12_CEILING = 10
GF_START = 1.25      # the steps' sigma_s (homogeneous) or density, x preset
# the new forms: (name, source, the TPU kernel it replaces, the form whose
# time it is held beside)
GF_FORMS = {
    "8m": ("vrl_sum_bwd material", "vrl_sum_bwd.cu", 845, "8"),
    "8x": ("vrl_sum_bwd extended (mixture, strategy)", "vrl_sum_bwd.cu",
           845, "8"),
    "8mx": ("vrl_sum_bwd material extended", "vrl_sum_bwd.cu", 845, "8m"),
    "9m": ("vrl_sum_hetero_bwd material", "vrl_sum_bwd.cu", 924, "9"),
    "9t": ("vrl_sum_hetero_bwd trilinear", "vrl_sum_bwd.cu", 924, "9"),
    "9tm": ("vrl_sum_hetero_bwd material trilinear", "vrl_sum_bwd.cu", 924,
            "9t"),
    "10m": ("vrl_sum_clustered_bwd material", "vrl_sum_clustered_bwd.cu",
            1046, "10"),
    "10x": ("vrl_sum_clustered_bwd extended (mixture, strategy)",
            "vrl_sum_clustered_bwd.cu", 1046, "10"),
    "10mx": ("vrl_sum_clustered_bwd material extended",
             "vrl_sum_clustered_bwd.cu", 1046, "10m"),
    "11m": ("vrl_sum_hetero_clustered_bwd material",
            "vrl_sum_clustered_bwd.cu", 1130, "11"),
    "11t": ("vrl_sum_hetero_clustered_bwd trilinear",
            "vrl_sum_clustered_bwd.cu", 1130, "11"),
    "11tm": ("vrl_sum_hetero_clustered_bwd material trilinear",
             "vrl_sum_clustered_bwd.cu", 1130, "11t"),
}

# the outputs of the backward kernels' diffuse forms (kernel_digest.py
# --bwd, on the parent tree; NVIDIA H100 80GB HBM3, 700.00 W): d_density
# aside, this run's must be equal
PARENT_DIGESTS_BWD = {
    "vrl_sum_bwd injected 0":
        "1ff3a375a8a09e9a6b9178a9f7463c11576ac6887aca6d0bcd0cbc430c3c2fcf",
    "vrl_sum_bwd injected 1":
        "36e97d55e33dc597e35c2398699dde3e71d8b64fe49b95e0be4b42133fd5279f",
    "vrl_sum_bwd injected 2":
        "52fcc8cacea532b83b8c28107f33b024aa75d8f6e1751685eeca76469c6f7d58",
    "vrl_sum_clustered_bwd injected 0":
        "b9ffd55095cc3f873517c7ca329b592823deae630a7428b678ec54b599cdd3b2",
    "vrl_sum_clustered_bwd injected 1":
        "0128b3ed22c4d7a943666575490d609f642a8a076ba608457a8669be21f7eb03",
    "vrl_sum_clustered_bwd injected 2":
        "81167d01390ec1d600792766d46a31bc137f81385cecc773c632165c0dbe846f",
    "vrl_sum_clustered_bwd injected 3":
        "c7ea02727886f019049f40bdc50d6a69e77161279c4e60f653ff41ea0b278f59",
    "vrl_sum_bwd philox 0":
        "5939c44b95d4cde53f27a85d5590e35458b51ad997709014ca82633f215ac168",
    "vrl_sum_bwd philox 1":
        "1c10e16e7be4713e5ba9dec2d14c57a92ba0011ea611f01881b08d561984ff64",
    "vrl_sum_bwd philox 2":
        "03eacc4aba60f3c7159335ba3ddbaefbbc893a6dccd601853630f37527870c6f",
    "vrl_sum_clustered_bwd philox 0":
        "70ddc5ecd5ba9fdb3c212fc2fd355213192e0e020c231f9948f8a57ee228f083",
    "vrl_sum_clustered_bwd philox 1":
        "d2b161e296cc0b42de23ef69baedf8a5d986d82452bfbc41dd82ea4f2a1c4596",
    "vrl_sum_clustered_bwd philox 2":
        "eecc46aa041a5f435bacdcad135a968ad2df7d6c37ae522a9ee9fbe6a6f5e782",
    "vrl_sum_clustered_bwd philox 3":
        "32269c37e21efc247649a66bd08e97ba9d8b6a4876b40aad812552cf8d5cee29",
    "vrl_sum_bwd rayleigh 0":
        "e5090674ddc77c590af9ca820221acc8aafadd6aa0a1af7c6fe7dba2dd987fec",
    "vrl_sum_bwd rayleigh 1":
        "8c9a987df0da174312bbcb7a52cb58e42f3b345669ee5d53b67f7e6e8fab36e7",
    "vrl_sum_bwd rayleigh 2":
        "1bd3dd56f8a4f8805e2898158772398fe88fcbf2a3af610b16042519c84c7fa0",
    "vrl_sum_clustered_bwd rayleigh 0":
        "a61589a2ef4119eca2c937bcdd8fcb037346505d1bdccc40ad1476c7a0bc1fb8",
    "vrl_sum_clustered_bwd rayleigh 1":
        "8da9f06d3288fd28d34451c40e3179d0c9313d9cc02592e6f391b7a25c6000e6",
    "vrl_sum_clustered_bwd rayleigh 2":
        "fbb9f61620c09b25df03744691ddc940645a62b7fc6eb8a9de7ab3cfd66cf937",
    "vrl_sum_clustered_bwd rayleigh 3":
        "7a425feca8c4fed071b1ee7c08b5e94f1c93abda59cd339664dcc0d45c010e90",
    "vrl_sum_bwd long 0":
        "4efe4ef5f75a216f652305e47ffe6e8c263538528054216739b4c05f177025c0",
    "vrl_sum_bwd long 1":
        "371cecf2d6ff44da4be9e899460d5fa76b44fd64129d3e08889156a8aa8e9e63",
    "vrl_sum_bwd long 2":
        "15c2b5a229d742a57eb5605ea747c298252b85ff3b654e5a1ab06be451bcc09e",
    "vrl_sum_clustered_bwd long 0":
        "b57d2fb134952e82a453bc9d23d4095a4fe2c88312d788a4bac72f4eaee96e54",
    "vrl_sum_clustered_bwd long 1":
        "8a77a9b1ad0009ef02428efc191c8d2a2b9ab62330ceb214d8aa9ca0bfba9961",
    "vrl_sum_clustered_bwd long 2":
        "d1e72847e1c104ab4506a0ec8e1fc15d3dfe69c1cafee20244d964221b42d790",
    "vrl_sum_clustered_bwd long 3":
        "5f9a0612c74c4c53de7521f6f1571620017e3a3d4453afd00f7884997bfb9b05",
    "vrl_sum_hetero_bwd uv4 0":
        "336d7dac6aba714418cfb8fedf27920b78905d8740eed4034a5f540dbf1fd654",
    "vrl_sum_hetero_bwd uv4 1":
        "b73ff5fa1eb668024814c5d89bbf3df8bb89e064233be65669f5d1e65ecc44cf",
    "vrl_sum_hetero_bwd uv4 2":
        "5917ec1f2d17cef4ad22b9c8b77653f0ce18258d74e6b3f4490e7ab94bb4dcb4",
    "vrl_sum_hetero_bwd uv4 3":
        "a6279591bcbf12cc568c7a6d5488aefb26f4b1d4eb48dd1a9e5836e75b1ace74",
    "vrl_sum_hetero_bwd uv4 4":
        "cc727aa93f28d6f46cc04a29ccd0635ad6d296a7d6e0c0dbaacda74b5fd6a791",
    "vrl_sum_hetero_clustered_bwd uv4 0":
        "658ec1e475d171cb7d9c1aea4e745848487def3f436439a1bd4ad678ab989359",
    "vrl_sum_hetero_clustered_bwd uv4 1":
        "98212bb04d57488390815cb68cd382718a4b21a766131189d765e45d97b20bce",
    "vrl_sum_hetero_clustered_bwd uv4 2":
        "126af2a9962b67ed9166756845f311ce6f752e06b9246554e52f19c9fe36fa52",
    "vrl_sum_hetero_clustered_bwd uv4 3":
        "94a64a8a760fd39f884d3b2b5cb80fb9c57a4202eb8b5e5741a4b98c93c1b193",
    "vrl_sum_hetero_clustered_bwd uv4 4":
        "2a63c68f11bdea8f35b7de85508b302cbd7e748586db408baca4902346c8ccab",
    "vrl_sum_hetero_clustered_bwd uv4 6":
        "1423be0bbe06aff117912062b2eae52fcc1445de1f71d36e01b20a4a1bc3f8f0",
    "vrl_sum_hetero_bwd uv3 0":
        "f25d7940aab46f429a055c8ac6a027380653ecee91b4a74a8bbe53aa0924bb30",
    "vrl_sum_hetero_bwd uv3 1":
        "4af5613673b6dac736e393bb67b975b734a7ba90376b01df7f745b5d95a7b9d7",
    "vrl_sum_hetero_bwd uv3 2":
        "2acc5459e8412f1b71370e19edbd8feb54ded27a47538f72cafd790610ca0d91",
    "vrl_sum_hetero_bwd uv3 3":
        "8fe435ee473285c347c28fd8b9f51d864f8fee19931afb80562e2ba60e28fcf7",
    "vrl_sum_hetero_bwd uv3 4":
        "6e9f4b7c71318c35f4ec6d4b48a64b0f43f49eaed1912dec468e18bcb584c4bc",
    "vrl_sum_hetero_clustered_bwd uv3 0":
        "8a4f0cfbde85457dacd2eebade504af93521a88f8f00f992b644497e597120fa",
    "vrl_sum_hetero_clustered_bwd uv3 1":
        "6538baca50f905cf7896cf7783194406362df5f5b5de51a65508f67617dcd326",
    "vrl_sum_hetero_clustered_bwd uv3 2":
        "37c5360aed41a24da2fd8b82de62e6ca2b6d807e4e32fb8dca5ae0322b5c2795",
    "vrl_sum_hetero_clustered_bwd uv3 3":
        "d7851199094b2e6f06ca48649513fb6d1a7596cd485fcbdc83788ad4f652411f",
    "vrl_sum_hetero_clustered_bwd uv3 4":
        "280330acf7adf8a5f6366e423c0c3f753271ec3083d03450fae71d650955d661",
    "vrl_sum_hetero_clustered_bwd uv3 6":
        "55bc6b26d1b58cf52abee2ef3ccae34f3edf257cb6b7c6f20d321a98547fc276",
}


def mix_scene(scene):
    """`scene` in phase 43's mixture + single medium (channel 0)."""
    med = scene.medium
    sig_s = torch.tensor(SKY_SIGMA_S, device=scene.device)
    comps = MIX_PHASE["components"]
    mix = ph.mixture_params(
        [c["weight"] for c in comps],
        [ph.HG if c["type"] == "hg" else ph.RAYLEIGH for c in comps],
        [c.get("g", 0.0) for c in comps], device=scene.device)
    return replace(scene, medium=replace(
        med, sigma_s=sig_s, sigma_a=torch.zeros_like(sig_s),
        phase_kind=ph.MIXTURE, phase_params=mix, strategy=1, channel=0))


def base_pack(packs):
    """The packs with the medium pack cut to its base (MED_LEN,): the HG
    balance form that an extended form extends."""
    return (*packs[:3], packs[3][:pk.MED_LEN].contiguous(), *packs[4:])


def gf_par_rows(medium, grid):
    """d_par's live entries: sigma_t, sigma_s, g (and the rate of an
    extended pack), or the grid's GRID_LIVE."""
    if grid:
        return GRID_LIVE
    return list(range(7)) + ([pk.MED_RHO] if medium.shape[0] > pk.MED_LEN
                             else [])


def gf_check(label, out, ref, ref64, rows, grid, kind=None,
             clustered=False):
    """Hold one form's outputs on the held rays (out: the per-ray ones cut
    to them) against the plain version's in float32 (ref) and float64
    (ref64): d_par's live entries to PAR_RTOL or the plain version's own
    float32 error; every per-ray and per-VRL output at the homogeneous
    bar over its live items (in a grid medium the per-VRL sums d_power
    and d_vod against ref64, C12_CEILING's rule), d_tau over each
    eye-hit kind's rays alone with `kind`; the density's large voxels
    likewise. Returns (a line, the largest absolute error)."""
    names = (["d_power", "d_par", "d_tau"] + (["d_eod", "d_vod", "d_density"]
                                              if grid else [])
             + (["d_weights"] if clustered else []))
    bars = []
    for i, name in enumerate(names):
        o, r = out[i], ref[i]
        if name == "d_par":
            for t in rows:
                d, rf, r64 = float(o[t]), float(r[t]), float(ref64[i][t])
                if rf == 0.0:
                    check(d == 0.0, f"{label}: d_par[{t}] {d}, plain 0")
                    continue
                check(abs(d - rf) <= max(PAR_RTOL * abs(rf), abs(rf - r64)),
                      f"{label}: d_par[{t}] {d}, plain {rf} (float64 {r64})")
            check(all(float(o[t]) == 0.0 for t in range(o.shape[0])
                      if t not in rows), f"{label}: d_par's dead entries")
            continue
        if name == "d_density":
            d, rf = o.reshape(-1), r.reshape(-1)
            nz = rf.abs() > VOXEL_FLOOR * float(rf.abs().max())
            check(int(nz.sum()) > 100, f"{label}: {int(nz.sum())} voxels")
            bar = homog_bar(d[nz][:, None], rf[nz][:, None], channels=1)
        elif name == "d_weights":
            bar = weights_bar(o, r)
        elif grid and name in ("d_power", "d_vod"):
            r64 = ref64[i].to(o.dtype)
            oo, rr, pp = live(o, r64, r)
            bar = homog_bar(oo.T, rr.T, channels=oo.shape[0])
            if not (bar[0] < HOMOG_MEDIAN and bar[1] < HOMOG_SHARE):
                own = homog_bar(pp.T, rr.T, channels=oo.shape[0])
                check(bar[0] <= own[0] and bar[0] < C12_CEILING * HOMOG_MEDIAN
                      and bar[1] < HOMOG_SHARE,
                      f"{label}: {name} median {bar[0]}, share {bar[1]}; "
                      f"the float32 plain version's {own}")
                bars.append((f"{name} (float32 plain {own[0]:.2e}/"
                             f"{own[1]:.4f})", bar))
                continue
        else:
            oo, rr = live(o, r) if name == "d_power" else (o, r)
            bar = homog_bar(oo.T, rr.T, channels=oo.shape[0])
        check(bar[0] < HOMOG_MEDIAN and bar[1] < HOMOG_SHARE,
              f"{label}: {name} median {bar[0]}, share {bar[1]}")
        bars.append((name, bar))
    line = ", ".join(f"{n} {m:.2e}/{s:.4f}" for n, (m, s) in bars)
    if kind is not None:
        groups = {k: v for k, v in homog_bar_by_kind(
            out[2].T, ref[2].T, kind).items() if k in GLOSSY_KINDS}
        check(set(groups) == GLOSSY_KINDS, f"{label}: kinds {sorted(groups)}")
        for k, (n, median, share) in groups.items():
            check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
                  f"{label}: d_tau of kind {k} ({n} rays) median {median}, "
                  f"share {share}")
        line += "; d_tau by kind " + " ".join(
            f"{k}:{n}:{m:.1e}/{s:.3f}" for k, (n, m, s) in groups.items())
    err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
    return line, err


def gf_hold(key, packs, mats, dev, rng, grid=False, tables=None, uv=4):
    """Hold form `key` as its main path launches it: on the whole frame
    (`packs`, the main path's `tables`), with the output cotangent gbar 0
    off a seeded sample of GF_HOLD_RAYS rays, so that the sums over rays
    (d_power, d_par, d_vod, d_density, d_weights) are the sample's,
    which the plain versions (in float32, sweeps counted, and in float64)
    compute on the sample's rays alone with their frame indices'
    uniforms; the per-ray outputs are 0 off the sample, and a repeat is
    bit-identical but d_density (DENSITY_REPEAT). Returns a dict of its
    line, error, plain ms, the sample's sweep and its share of the frame,
    the checking launch's counts on the frame, and what the timing
    needs (a gbar of the whole frame)."""
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    pick = torch.as_tensor(np.sort(rng.choice(n_rays, GF_HOLD_RAYS,
                                              replace=False)), device=dev)
    gbar = torch.as_tensor(rng.uniform(0.5, 1.5, (3, n_rays)).astype(
        np.float32), device=dev)
    gbar_s = torch.zeros_like(gbar)
    gbar_s[:, pick] = gbar[:, pick]
    sub = (packs[0][:, pick].contiguous(), *packs[1:])
    phase = ph.MIXTURE if (not grid and packs[3].shape[0] > pk.MED_LEN
                           and int(packs[3][pk.MED_K]) > 0) else 0
    kw = dict(phase_kind=phase, **({} if mats is None else
                                   {"materials": mats}))
    if grid:
        kw["uv_steps"] = uv
    kind = None
    if mats is not None:
        mat = sub[0][pk.GRID_MATID if grid else pk.MATID].long()
        kind = mats[0][mat, pk.MT_KIND].long()
        smooth = mats[0][mat, pk.MT_SMOOTH] > 0.5
        per_kind = {k: int((kind == k).sum()) for k in GLOSSY_KINDS}
        check(min(per_kind.values()) >= GF_KIND_MIN,
              f"{key}: held rays by kind {per_kind}")
    else:
        smooth = sub[0][pk.ALB:pk.ALB + 3].sum(0) > 0
    if tables is not None:
        rows = torch.as_tensor(tables[0], device=dev).long()[pick]
        ids = tables[1][rows.clamp(min=0)].long()
        u = torch.where((rows >= 0)[:, None, None],
                        vs.philox_draws(GF_SEED, pick[:, None], ids, 6), 0.0)
        pair_ok = table_pair_ok(sub[0], sub[1], rows, *tables[1:])
        ref_tables = (rows, *tables[1:])
    else:
        u = vs.philox_draws(GF_SEED, pick[:, None], torch.arange(
            n_vrls, dtype=torch.int64, device=dev)[None], 6)
        pair_ok = pair_masks(*sub[:2])[0]
        tables = ref_tables = ()
    clustered = bool(tables)
    fn = {(False, False): bwd.vrl_sum_bwd,
          (True, False): bwd.vrl_sum_hetero_bwd,
          (False, True): cb.vrl_sum_clustered_bwd,
          (True, True): cb.vrl_sum_hetero_clustered_bwd}[(grid, clustered)]
    ref_fn = {(False, False): bwd.vrl_sum_bwd_reference,
              (True, False): bwd.vrl_sum_hetero_bwd_reference,
              (False, True): cb.vrl_sum_clustered_bwd_reference,
              (True, True): cb.vrl_sum_hetero_clustered_bwd_reference}[
                  (grid, clustered)]
    out = fn(*packs, *tables, gbar_s, seed=GF_SEED, **kw)
    again = fn(*packs, *tables, gbar_s, seed=GF_SEED, **kw)
    per_ray = (2, 3) if grid else (2,)
    off = torch.ones(n_rays, dtype=torch.bool, device=dev)
    off[pick] = False
    for i, (a, b) in enumerate(zip(out, again)):
        if grid and i == 5:
            rep = float((a - b).abs().max())
            check(rep <= DENSITY_REPEAT * float(a.abs().max()),
                  f"{key}: d_density repeat {rep}")
        else:
            check(torch.equal(a, b), f"{key}: output {i}'s repeat")
        check(bool(torch.isfinite(a).all()), f"{key}: output {i} finite")
        if i in per_ray:
            check(not bool(a[:, off].any()), f"{key}: output {i} off the "
                  "held rays")
    held = tuple(o[:, pick] if i in per_ray else o for i, o in enumerate(out))

    def plain(dt):
        def cast(t):
            return t.to(dt) if t.is_floating_point() else t
        m = {} if mats is None else {"materials": tuple(map(cast, mats))}
        return ref_fn(*map(cast, sub), *map(cast, ref_tables),
                      cast(gbar[:, pick].contiguous()), cast(u),
                      **dict(kw, **m))
    with plain_chunk(C4_PLAIN_CHUNK):
        with SweepCount(pair_ok, smooth) as sweep:
            ref, p_ms = timed_call(lambda: plain(torch.float32))
        ref64 = plain(torch.float64)
    torch.cuda.synchronize()
    line, err = gf_check(key, held, ref, ref64, gf_par_rows(packs[3], grid),
                         grid, kind, clustered)
    counts = None
    if not grid:  # the frame's checking counts (kernel 1's or 2's)
        chk = vrl_sum_clustered_check if clustered else vs.vrl_sum_check
        counts = chk(*packs, *tables, seed=GF_SEED, **kw)[1]
        check(counts["bad_tris"] == 0 and counts["bad_segments"] == 0,
              f"{key}: the checking launch {counts}")
    return dict(line=line, err=err, plain_ms=p_ms, sweep=sweep,
                scale=n_rays / GF_HOLD_RAYS, counts=counts, packs=packs,
                gbar=gbar, kw=kw, fn=fn, phase=phase, tables=tables)


def gf_ops(key, h, hg, uv):
    """A lower bound of form key's operations on the whole frame, by
    OPS's rules: the diffuse form's (kernel_ops) on the held rays'
    counted sweep, plus eval_smooth at each open vol-surf sample
    (material forms), the trilinear lookups' extra lerps beside the
    nearest ones (trilinear forms), the strategy's one-exp pdfFailure in
    place of balance's (extended forms), a mixture priced as Rayleigh;
    scaled by the frame's rays over the held ones (a uniform sample);
    kernels 8 and 10's sweep as PlaneTris makes it on the frame, from
    the checking launch's counts (plane_ops)."""
    grid = key.startswith(("9", "11"))
    sweep = h["sweep"]
    if grid:
        f, s = kernel_ops("vrl_sum_hetero_bwd", sweep, hg, True, uv)
    else:
        f, s = kernel_ops("vrl_sum_bwd", sweep, hg, True)
    if "m" in key:
        f += sweep.open[1] * OPS["eval_smooth"][0]
        s += sweep.open[1] * OPS["eval_smooth"][1]
    if "t" in key:
        lerp = GRID_OPS["trilinear"][0] - GRID_OPS["density"][0]
        f += lerp * ((2 + uv) * sweep.open[0] + (1 + uv) * sweep.open[1])
    if "x" in key:
        f -= 6 * sum(sweep.open)
        s -= 2 * sum(sweep.open)
    k = h["scale"]
    if grid:
        return k * f, k * s
    return plane_ops((k * f, k * s),
                     SimpleNamespace(tri_tests=k * sweep.tri_tests),
                     h["counts"])


def gf_launcher(h):
    """A call of form h's kernel alone on its inputs: the wrappers'
    launch step (`_launch`) without their checks, and for kernels 10 and
    11 with the host layout built once (the wrapper's host work, tens of
    ms at config 4, would hide the kernel)."""
    packs, kw, gbar = h["packs"], h["kw"], h["gbar"]
    grid = (packs[4], kw["uv_steps"]) if len(packs) > 4 else None
    args = (GF_SEED, 2, 2, True, kw["phase_kind"])
    mats = kw.get("materials")
    if not h["tables"]:
        lib = bwd._library()
        return lambda: bwd._launch(lib, *packs[:4], gbar, None, *args, grid,
                                   mats)
    sop, tv, tw = h["tables"]
    lib = cb._library()
    layout = cb.host_layout(sop, tv, packs[1].shape[1],
                            cb.ray_block(grid is not None), packs[0].device)
    return lambda: cb._launch(lib, *packs[:4], layout, tv, tw, None, *args,
                              gbar, grid, materials=mats)


def gf_time(h, old_h, key):
    """ms of form key's kernel on its main path's inputs and of the form
    it extends on the same frame, in turns (old, new, new, old), CUDA
    events around batches of calls (one call a batch for kernel 9, tens
    to hundreds of ms at config 4)."""
    new, old = gf_launcher(h), gf_launcher(old_h)
    batch = 1 if key.startswith("9") else 3
    runs = [cuda_ms_batched(f, 1, 3, batch) for f in (old, new, new, old)]
    return summary(runs[1] + runs[2]), summary(runs[0] + runs[3])


def gf_fd(label, loss, start, params, rel=FD_TOL):
    """Same-seed central differences of loss(p, forward route) against
    the autograd gradient of loss(p, differentiable route) at `start`:
    params (name, flat index or None, step); raises; returns a line."""
    p = {k: v.clone().requires_grad_() for k, v in start.items()}
    value = loss(p, "diff")
    grads = dict(zip(p, torch.autograd.grad(value, list(p.values()))))
    out = []
    for name, idx, eps in params:
        def shifted(s):
            q = {k: v.clone() for k, v in start.items()}
            if idx is None:
                q[name] = q[name] + s
            else:
                q[name].view(-1)[idx] += s
            with torch.no_grad():
                return float(loss(q, "forward"))
        fd = (shifted(eps) - shifted(-eps)) / (2 * eps)
        a = float(grads[name] if idx is None else grads[name].reshape(-1)[idx])
        check(fd != 0.0 and abs(a - fd) <= rel * abs(fd),
              f"{label}: FD {name}[{idx}] ad {a} fd {fd}")
        out.append(f"{name}{'' if idx is None else f'[{idx}]'} ad {a:.6g} "
                   f"fd {fd:.6g}")
    return "; ".join(out)


def gf_counters():
    return (bwd.vrl_sum_bwd, bwd.vrl_sum_hetero_bwd, cb.vrl_sum_clustered_bwd,
            cb.vrl_sum_hetero_clustered_bwd)


def gf_reset():
    for fn in gf_counters():
        for f in ("launches", "mat_launches", "mix_launches", "tri_launches"):
            if hasattr(fn, f):
                setattr(fn, f, 0)


def gf_launched(fn, key):
    """The launches of form key (and of no other form) counted on the
    backward wrapper fn."""
    n = fn.launches
    for attr, tag in (("mat_launches", "m"), ("mix_launches", "x"),
                      ("tri_launches", "t")):
        if hasattr(fn, attr):
            c = getattr(fn, attr)
            n = min(n, c if tag in key else fn.launches - c)
    return n


def gradient_forms(dev, card, cfg, c1, c2, c4):
    """Phase 49: the twelve new forms of the backward kernels 8-11 against
    their plain versions, the main paths that launch them against same-
    seed central differences, their times beside the forms they extend,
    registers, bounds. Returns the kernels line's twelve entries."""
    t49 = time.perf_counter()
    rng = np.random.default_rng(49)
    tcfg = tracer.TracerConfig(max_depth=MAX_DEPTH)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "glossy.json")
        with open(path, "w") as f:
            f.write(json.dumps(glossy_json(c1)).replace('"$w"', "$w")
                    .replace('"$h"', "$h"))
        glossy = loader.load_json(path, {"w": WIDTH, "h": HEIGHT},
                                  device=dev)
        gdesc = glossy_grid_desc(c1, c4["scene"], tmp)
        path = os.path.join(tmp, "glossy_grid.json")
        with open(path, "w") as f:
            f.write(json.dumps(gdesc).replace('"$w"', "$w")
                    .replace('"$h"', "$h"))
        gg = loader.load_json(path, {"w": C4_SIZE, "h": C4_SIZE}, device=dev)
    scenes = {"glossy": glossy, "mix": mix_scene(presets.cornell_smoke(
        WIDTH, HEIGHT, device=dev)), "glossy_mix": mix_scene(glossy)}
    c4t = replace(c4["scene"], medium=replace(c4["scene"].medium,
                                              fast_tau=False))
    grid_scenes = {"gg": gg, "gg_t": replace(gg, medium=replace(
        gg.medium, fast_tau=False)), "c4t": c4t}
    mats = integrator.material_pack(glossy)
    check(mats is not None and integrator.material_pack(gg) is not None,
          "the glossy scenes' material packs")

    def gen():
        return torch.Generator().manual_seed(TRAIN_SEED)

    # the homogeneous scenes' VRLs, as the train step traces them
    hvrls = {k: tracer.trace(sc, gen(), N_PARTICLES, tcfg)
             for k, sc in scenes.items()}
    params2 = alvrl.ALVRLParams(**C2_PARAMS,
                                cluster=cl.ClusterParams(**C2_CLUSTER))
    ginfo = alvrl.build_slice_info(glossy, params2)
    gv = vrl.compact(tracer.trace(glossy, torch.Generator().manual_seed(11),
                                  params2.num_particles, tracer.TracerConfig()),
                     params2.vrl_target_num,
                     slots_per_particle=tracer.TracerConfig().max_depth)
    gtab = alvrl.prepare_clustering(glossy, gv, GF_SEED, params2, cfg,
                                    ginfo)[:3]
    c2tab = (c2["sop"], c2["tv"], c2["tw"])
    c4tab = (c4["sop"], c4["tv"], c4["tw"])
    # each form's main path: the scene, its VRLs, its material pack and
    # its tables (the train step's for kernel 8, phase 49b's clustered
    # renders' for kernels 10 and 11, full config 4 for kernel 9)
    paths = {
        "8m": (glossy, hvrls["glossy"], mats, None),
        "8x": (scenes["mix"], hvrls["mix"], None, None),
        "8mx": (scenes["glossy_mix"], hvrls["glossy_mix"], mats, None),
        "10m": (glossy, gv, mats, gtab),
        "10x": (scenes["mix"], c2["vrls"], None, c2tab),
        "10mx": (scenes["glossy_mix"], gv, mats, gtab),
        "9m": (grid_scenes["gg"], c4["vrls"], mats, None),
        "9t": (c4t, c4["vrls"], None, None),
        "9tm": (grid_scenes["gg_t"], c4["vrls"], mats, None),
        "11m": (grid_scenes["gg"], c4["vrls"], mats, c4tab),
        "11t": (c4t, c4["vrls"], None, c4tab),
        "11tm": (grid_scenes["gg_t"], c4["vrls"], mats, c4tab)}
    lines, holds, entries = [], {}, {}
    uv = cfg.uv_tau_steps
    t0 = time.perf_counter()

    # 49a. each form on its main path's inputs against its plain version
    for key, (sc, vr, m, tab) in paths.items():
        grid = key.startswith(("9", "11"))
        packs = integrator.pack_frame(sc, vr, materials=m)[3]
        h = gf_hold(key, packs, m, dev, rng, grid=grid, tables=tab, uv=uv)
        # the form it extends, on the same frame (and tables)
        base = GF_FORMS[key][3]
        if base in ("8", "10"):  # the diffuse HG balance form
            bp = (integrator.pack_frame(sc, vr)[3] if m is not None
                  else base_pack(packs))
            old = dict(h, packs=bp, kw=dict(phase_kind=0))
        elif base in ("8m", "10m"):  # the material form, base medium
            old = dict(h, packs=base_pack(packs), kw=dict(h["kw"],
                                                          phase_kind=0))
        elif base in ("9", "11"):  # the nearest diffuse form
            bsc = replace(sc, medium=replace(sc.medium, fast_tau=True))
            old = dict(h, packs=integrator.pack_frame(bsc, vr)[3],
                       kw=dict(phase_kind=0, uv_steps=uv))
        else:  # 9t / 11t: the trilinear diffuse form
            old = dict(h, packs=integrator.pack_frame(sc, vr)[3],
                       kw=dict(phase_kind=0, uv_steps=uv))
        holds[key] = (h, old)
        lines.append(f"{key} ({packs[0].shape[1]} x {packs[1].shape[1]}, "
                     f"{GF_HOLD_RAYS} held): {h['line']}")
    t_hold = time.perf_counter() - t0
    print(f"[49a the backward kernels' new forms vs plain on {card}: each "
          f"launched on its main path's frame, VRLs and tables, gbar 0 off "
          f"a seeded sample of {GF_HOLD_RAYS} rays, held there against the "
          f"plain versions in float32 and float64 on the sample's rays (the "
          f"Philox stream of their frame indices), each glossy kind's rays "
          f"alone (kind:rays:median/share); repeats bit-identical but "
          f"d_density; {t_hold:.1f} s] " + " | ".join(lines), flush=True)

    # 49b. the main paths, counted, against same-seed central differences
    t0 = time.perf_counter()
    fd_lines, launched = [], {}
    for key, name in (("8m", "glossy"), ("8x", "mix"), ("8mx", "glossy_mix")):
        sc0 = scenes[name]
        target = integrator.render_with_vrls_kernel(
            sc0, hvrls[name], gen(), cfg)
        med0 = sc0.medium
        sc = replace(sc0, medium=replace(med0, sigma_s=med0.sigma_s
                                         * GF_START))
        gf_reset()
        vrl_sum.launches = 0
        with plain_calls(extra=[(bwd, "_plain_vjp")]) as plain:
            loss, grads = train_step(sc, gen(), target, cfg, N_PARTICLES,
                                     tcfg)
            torch.cuda.synchronize()
        launched[key] = gf_launched(bwd.vrl_sum_bwd, key)
        check(plain[0] == 0 and vrl_sum.launches >= 1
              and launched[key] >= 1 and launched[key]
              == bwd.vrl_sum_bwd.launches and math.isfinite(float(loss)),
              f"{key}: the train step's launches {vrl_sum.launches}, "
              f"{launched[key]} of {bwd.vrl_sum_bwd.launches}, plain "
              f"{plain[0]}")
        for k in PARAMS:
            check(bool(torch.isfinite(grads[k]).all()), f"{key}: d{k}")
        vrls_step = tracer.trace(sc, gen(), N_PARTICLES, tcfg)
        i0 = sc.emitters.intensity

        def loss_fn(p, route, sc=sc, vrls_step=vrls_step, i0=i0,
                    target=target):
            s = with_params(sc, p)
            vr = replace(vrls_step, power=vrls_step.power * (
                p["intensity"] / i0))
            fn = (integrator.render_with_vrls_kernel_diff if route == "diff"
                  else integrator.render_with_vrls_kernel)
            img = fn(s, vr, torch.Generator().manual_seed(3), cfg)
            return ((img.double() - target.double()) ** 2).mean()

        start = {"sigma_a": sc.medium.sigma_a, "sigma_s": sc.medium.sigma_s,
                 "g": sc.medium.g, "intensity": i0}
        params = [("sigma_s", 0, 2e-3), ("sigma_s", 1, 2e-3),
                  ("intensity", 0, 0.4)]
        if "x" not in key:
            params.append(("g", None, 2e-3))
        fd_lines.append(f"{key} train step (loss {float(loss):.6g}, "
                        f"launches {launched[key]}): "
                        + gf_fd(key, loss_fn, start, params))
        if key == "8m":  # the glossy step's device time and idle share
            step_ms = summary(host_ms(lambda: train_step(
                sc, gen(), target, cfg, N_PARTICLES, tcfg), 1, 5))
            prof = profile_device(lambda: train_step(
                sc, gen(), target, cfg, N_PARTICLES, tcfg), 1, 3)
            idle = ("not measured" if prof is None else
                    f"idle share {1 - prof[1] / prof[0]:.1%} (span "
                    f"{prof[0]:.3f} ms, busy {prof[1]:.3f} ms)")
            fd_lines.append(f"8m step {step_ms[0]:.3f} ms (spread "
                            f"{step_ms[1]:.1%}), {idle}")
    g_med0 = c4["scene"].medium
    for key in ("9m", "9t", "9tm"):
        sc, vr, _, _ = paths[key]
        target = integrator.render_with_vrls_kernel(
            sc, vr, torch.Generator().manual_seed(2000), cfg)
        start = {"density": sc.medium.density * GF_START,
                 "scale": sc.medium.scale}

        def gloss(p, route, sc=sc, vr=vr, target=target):
            med = replace(gmed.with_density(sc.medium, p["density"]),
                          scale=p["scale"])
            fn = (integrator.render_with_vrls_kernel_diff if route == "diff"
                  else integrator.render_with_vrls_kernel)
            img = fn(replace(sc, medium=med), vr,
                     torch.Generator().manual_seed(3), cfg)
            return ((img.double() - target.double()) ** 2).mean()

        gf_reset()
        vrl_sum_hetero.launches = 0
        with plain_calls(extra=[(bwd, "_plain_vjp")]) as plain:
            p = {k: v.clone().requires_grad_() for k, v in start.items()}
            g_d = torch.autograd.grad(gloss(p, "diff"), p["density"])[0]
            torch.cuda.synchronize()
        launched[key] = gf_launched(bwd.vrl_sum_hetero_bwd, key)
        check(plain[0] == 0 and launched[key] == 1
              and vrl_sum_hetero.launches == 1,
              f"{key}: the grid step's launches {launched[key]}")
        top = int(g_d.reshape(-1).abs().argmax())
        eps_v = 2e-2 * float(start["density"].reshape(-1)[top])
        fd_lines.append(f"{key} unclustered grid step: " + gf_fd(
            key, gloss, start, [("scale", None, 2e-3 * float(g_med0.scale)),
                                ("density", top, eps_v)]))
    for key in ("10m", "10x", "10mx", "11m", "11t", "11tm"):
        sc, vr, _, tab = paths[key]
        grid = key.startswith("11")
        target = integrator.render_clustered_kernel(
            sc, vr, *tab, torch.Generator().manual_seed(2500), cfg)
        if grid:
            start = {"scale": sc.medium.scale,
                     "density": sc.medium.density * GF_START}
        else:
            start = {"sigma_s": sc.medium.sigma_s * GF_START,
                     "wscale": torch.tensor(1.0, device=dev)}

        def closs(p, route, sc=sc, vr=vr, tab=tab, target=target,
                  grid=grid):
            med = (replace(gmed.with_density(sc.medium, p["density"]),
                           scale=p["scale"]) if grid
                   else replace(sc.medium, sigma_s=p["sigma_s"]))
            w = tab[2] if grid else tab[2] * p["wscale"]
            fn = (integrator.render_clustered_kernel_diff if route == "diff"
                  else integrator.render_clustered_kernel)
            img = fn(replace(sc, medium=med), vr, tab[0], tab[1], w,
                     torch.Generator().manual_seed(3), cfg)
            return ((img.double() - target.double()) ** 2).mean()

        gf_reset()
        fn = cb.vrl_sum_hetero_clustered_bwd if grid \
            else cb.vrl_sum_clustered_bwd
        with plain_calls(extra=[(bwd, "_plain_vjp")]) as plain:
            p = {k: v.clone().requires_grad_() for k, v in start.items()}
            torch.autograd.grad(closs(p, "diff"), list(p.values()))
            torch.cuda.synchronize()
        launched[key] = gf_launched(fn, key)
        check(plain[0] == 0 and launched[key] == 1,
              f"{key}: the clustered step's launches {launched[key]}")
        params = ([("scale", None, 2e-3 * float(g_med0.scale))] if grid else
                  [("sigma_s", 1, 2e-3), ("wscale", None, 2e-3)])
        fd_lines.append(f"{key} clustered step: " + gf_fd(key, closs, start,
                                                          params))
    t_main = time.perf_counter() - t0
    print(f"[49b the main paths on {card}: the train step on cornell_glossy "
          f"{WIDTH}x{HEIGHT}, {N_PARTICLES} particles x depth {MAX_DEPTH}, "
          f"sigma_s x{GF_START} (and in the mixture + single medium); "
          f"render_with_vrls_kernel_diff at {C4_SIZE}x{C4_SIZE} x "
          f"{c4['vrls'].capacity} VRLs, density x{GF_START}; "
          f"render_clustered_kernel_diff on cornell_glossy's config-2 "
          f"tables, config 2's and config 4's; the new forms' launches "
          f"{launched}, no plain call; same-seed central differences to "
          f"{FD_TOL}; {t_main:.1f} s] " + " | ".join(fd_lines), flush=True)

    # 49c. times beside the forms they extend, registers, bounds
    t0 = time.perf_counter()
    tlines = []
    for key, (h, old) in holds.items():
        (m_ms, m_sp), (o_ms, _) = gf_time(h, old, key)
        hg = h["phase"] == 0
        packs = h["packs"]
        n_bytes = nbytes(*packs, h["gbar"], *(t for t in h["tables"]
                                              if torch.is_tensor(t)))
        n_bytes += 4 * 3 * (packs[0].shape[1] + packs[1].shape[1])
        if "m" in key:
            n_bytes += nbytes(*mats)
        bnd = bound(gf_ops(key, h, hg, uv), n_bytes)
        name, src, line, base = GF_FORMS[key]
        entries[key] = {
            "name": name, "route": "cuda",
            "source": f"alvrl_tpu_torch/csrc/{src}",
            "replaces": f"alvrl_tpu/ops/vrl_pallas_bwd.py:{line}",
            "launches": launched[key], "max_abs_err": h["err"], "ms": m_ms,
            "plain_ms": h["plain_ms"], "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": None}
        tlines.append(f"{key} {m_ms:.4f} ms (spread {m_sp:.1%}) vs {base} "
                      f"{o_ms:.4f} (x{m_ms / o_ms:.2f}); plain "
                      f"{h['plain_ms']:.1f} ms on the {GF_HOLD_RAYS} held "
                      f"rays; bound {bnd[0]:.4f} ms by {bnd[1]} (the held "
                      f"rays' sweep x{h['scale']:g}: {h['sweep']})")
    regs = [r for r in ptxas_summary(_build.build_log())
            if "bwd" in r and any(t in r for t in (",ext", ",tri", ",mat"))]
    # 49d. the earlier forms' outputs, bit for bit the parent's
    digests = kernel_digest.bwd_digests(dev)
    same = [k for k in PARENT_DIGESTS_BWD if digests.get(k)
            == PARENT_DIGESTS_BWD[k]]
    check(len(same) == len(PARENT_DIGESTS_BWD) == len(digests),
          f"the backward digests: {len(same)} of {len(PARENT_DIGESTS_BWD)} "
          f"the parent's, differing "
          f"{sorted(set(PARENT_DIGESTS_BWD) - set(same))}")
    print(f"[49c the new forms' times on {card} (CUDA events, on their "
          f"main paths' inputs, each beside the form it extends on the same "
          f"frame, in turns), registers and "
          f"bounds; {time.perf_counter() - t0:.1f} s] " + " | ".join(tlines)
          + " | ptxas: " + " ; ".join(regs)
          + f" | the diffuse forms' outputs (kernel_digest.py --bwd): "
          f"{len(same)} of {len(PARENT_DIGESTS_BWD)} digests the parent's"
          + f" | phase 49 {time.perf_counter() - t49:.1f} s", flush=True)
    return [entries[k] for k in GF_FORMS]


# phase 50: cornell_textured (presets.cornell_textured_desc) at config 1's
# size, its VRLs traced as the CLI traces them (128 particles x depth 16,
# 512 slots), each textured form held on the whole frame by material
# (every material the camera sees, TEX_MIN_RAYS rays or more each), its
# injected holds on TEX_KIND_RAYS rays of each material; config 2's
# clustering (C2_CLUSTER, 100 slices) of the scene itself
TEX_SEED = 20261021
TEX_MIN_RAYS = 500
TEX_KIND_RAYS = 256
# the materials the camera sees: the bitmap, checker, grid and noise walls,
# the HK slab and the normal- and bump-mapped blocks
TEX_SEEN = ("bitmap", "checker", "grid", "noise", "hk", "normalmap",
            "bumpmap")
TEX_CLI_RUNS = [
    ("textured vrl", "cornell_textured.json", "vrl", 2, [], ("vrl_sum",)),
    ("textured alvrl", "cornell_textured.json", "alvrl", 2, [],
     ("vrl_r", "vrl_sum_clustered")),
]
# the parent's kernel library, each function's SASS body digest
# (scripts/sass_compare.py --root <parent> --record), NVIDIA H100 80GB
# HBM3's toolkit
PARENT_SASS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "alvrl_tpu_torch", "scripts", "parent_sass.json")


def start_sass_check():
    """scripts/sass_compare.py --against PARENT_SASS in a process of its
    own (its disassembly takes minutes of host time), which phase 50
    reads; killed at exit if it still runs."""
    proc = subprocess.Popen(
        [sys.executable, os.path.join(os.path.dirname(PARENT_SASS),
                                      "sass_compare.py"),
         "--against", PARENT_SASS], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def textured_path(dev, card, cfg, sass_check):
    """Phase 50: the textured forms of kernels 1, 2 and 5 on
    cornell_textured against their plain versions, material by material;
    the earlier forms' SASS the parent's (the result of `sass_check`,
    start_sass_check's process); the main path's textured launches; times
    beside the material forms on the same packs (the textures dropped),
    registers, bounds; the CLI; the VRL render against the volpath oracle
    on the textured box. Returns the kernels line's three entries."""
    t_phase = time.perf_counter()
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    desc = presets.cornell_textured_desc(tmp, WIDTH, HEIGHT, seed=TEX_SEED)
    path = os.path.join(tmp, "cornell_textured.json")
    with open(path, "w") as f:
        json.dump(desc, f)
    scene = loader.load_json(path, device=dev)
    names = [m["name"] for m in desc["materials"]]
    gen = torch.Generator().manual_seed(TEX_SEED)
    vrls = vrl.compact(tracer.trace(scene, gen, 128, tracer.TracerConfig(
        max_depth=16)), 512, slots_per_particle=16)
    n_rays, n_vrls = WIDTH * HEIGHT, vrls.capacity
    mats = integrator.material_pack(scene)
    packs = integrator.pack_frame(scene, vrls, materials=mats)[3]
    check(scene.textured() and packs[0].shape == (pk.TEX_RAY_ROWS, n_rays),
          "the textured ray pack")
    mpacks = (packs[0][:pk.MAT_RAY_ROWS].contiguous(), *packs[1:])
    valid = packs[0][pk.VALID] > 0.5
    ray_mat = torch.where(valid, packs[0][pk.MATID].long(), -1)
    seen = {k: int((ray_mat == k).sum()) for k in set(ray_mat.tolist())
            if k >= 0}
    check(min(seen.values()) >= TEX_MIN_RAYS and set(seen) == {
        names.index(n) for n in TEX_SEEN}, f"the materials seen: {seen}")
    mkw = dict(materials=mats)
    smooth = mats[0][:, pk.MT_SMOOTH] > 0.5
    surf = smooth[packs[0][pk.MATID].long()]
    rng = np.random.default_rng(50)
    pick = torch.as_tensor(np.concatenate([rng.choice(
        np.flatnonzero(ray_mat.cpu().numpy() == k), TEX_KIND_RAYS,
        replace=False) for k in sorted(seen)]), device=dev)
    kpacks = (packs[0][:, pick].contiguous(), *packs[1:])
    u_k = torch.as_tensor(rng.random((len(pick), n_vrls, 6),
                                     dtype=np.float32), device=dev)
    seed = TEX_SEED
    errs, lines, plain_ms = {}, [], {}

    def hold(label, out, ref, kind, channels=3, min_items=TEX_KIND_RAYS):
        return hold_by_kind(label, out, ref, kind, channels, min_items,
                            kinds=set(seen))

    # kernel 1: the frame on the Philox stream (its plain version timed,
    # its samples counted), injected on the picked rays; its checking
    # launch
    out = vrl_sum(*packs, seed=seed, **mkw)
    with SweepCount(valid[:, None] & (packs[1][pk.VVALID] > 0.5)[None],
                    surf) as s1:
        ref, plain_ms["vrl_sum"] = timed_call(lambda: vrl_sum_reference(
            *packs, philox_uniforms(seed, n_rays, n_vrls, 6, device=dev),
            **mkw))
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()) and float(out.sum()) > 0.0,
          "kernel 1 (textured): not finite and positive")
    lines.append(hold("kernel 1 philox", out.T[valid], ref.T[valid],
                      ray_mat[valid], min_items=TEX_MIN_RAYS))
    median, share = homog_bar(out.T[valid], ref.T[valid])
    check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
          f"kernel 1 (textured) frame: {median}, {share}")
    lines.append(f"kernel 1 frame median {median:.2e} share>1e-2 "
                 f"{share:.4f}")
    errs["vrl_sum"] = float((out - ref).abs().max())
    out_c, k1_counts = vs.vrl_sum_check(*packs, seed=seed, **mkw)
    check(k1_counts["bad_tris"] == 0 and k1_counts["bad_segments"] == 0
          and torch.equal(out_c, out), f"kernel 1 (textured): the checking "
          f"launch: {k1_counts}")
    out = vrl_sum(*kpacks, uniforms=u_k, **mkw)
    ref = vrl_sum_reference(*kpacks, u_k, **mkw)
    lines.append(hold(f"kernel 1 injected ({len(pick)} rays)", out.T, ref.T,
                      ray_mat[pick]))
    errs["vrl_sum"] = max(errs["vrl_sum"], float((out - ref).abs().max()))

    # kernel 2 on the scene's own clustering at config 2's slices (R
    # through kernel 5's textured form), Philox on the frame, and its
    # checking launch
    params = alvrl.ALVRLParams(**GLOSSY_PARAMS,
                               cluster=cl.ClusterParams(**C2_CLUSTER))
    info = alvrl.build_slice_info(scene, params)
    sop, tv, tw, _ = alvrl.prepare_clustering(scene, vrls, seed, params, cfg,
                                              info)
    n_cols = tv.shape[1]
    out = vrl_sum_clustered(*packs, sop, tv, tw, seed=seed, **mkw)
    again = vrl_sum_clustered(*packs, sop, tv, tw, seed=seed, **mkw)
    with SweepCount(table_pair_ok(packs[0], packs[1], sop, tv, tw),
                    surf) as s2:
        ref, plain_ms["vrl_sum_clustered"] = timed_call(
            lambda: vrl_sum_clustered_reference(
                *packs, sop, tv, tw, philox_table_uniforms(seed, sop, tv, 6),
                **mkw))
    torch.cuda.synchronize()
    check(torch.equal(out, again), "kernel 2 (textured): a repeat is not "
          "bit-identical")
    lines.append(hold(f"kernel 2 philox ({int(tv.shape[0])} slices, "
                      f"{n_cols} columns)", out.T[valid], ref.T[valid],
                      ray_mat[valid], min_items=TEX_MIN_RAYS))
    median, share = homog_bar(out.T[valid], ref.T[valid])
    check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
          f"kernel 2 (textured) frame: {median}, {share}")
    errs["vrl_sum_clustered"] = float((out - ref).abs().max())
    c_chk, c_counts = vrl_sum_clustered_check(*packs, sop, tv, tw, seed=seed,
                                              **mkw)
    check(c_counts["bad_tris"] == 0 and c_counts["bad_segments"] == 0
          and torch.equal(c_chk, out), f"kernel 2 (textured): the checking "
          f"launch: {c_counts}")

    # kernel 5: injected on the picked rays, each material alone; Philox on
    # the clustering's representative rays (the main path's shape)
    rows = torch.as_tensor(np.concatenate(info.repr_rows), device=dev)
    ray_o, ray_d = perspective.sample_ray(scene.camera, rows % WIDTH,
                                          rows // WIDTH)
    rpacks = integrator.pack_rays_vrls(scene, ray_o, ray_d, vrls, mats)[1]
    n_rep = rpacks[0].shape[1]
    out = vrl_r(*kpacks, uniforms=u_k, **mkw)
    ref = vrl_r_reference(*kpacks, u_k, **mkw)
    lines.append(hold(f"kernel 5 injected mean", out[0], ref[0], ray_mat[
        pick][:, None].expand(-1, n_vrls), 1, TEX_KIND_RAYS * n_vrls))
    errs["vrl_r"] = float((out - ref).abs().max())
    out = vrl_r(*rpacks, seed=seed, **mkw)
    rsurf = smooth[rpacks[0][pk.MATID].long()]
    u_r = philox_uniforms(seed, n_rep, n_vrls, 6, device=dev)
    with SweepCount((rpacks[0][pk.VALID] > 0.5)[:, None]
                    & (rpacks[1][pk.VVALID] > 0.5)[None], rsurf) as s5:
        ref, plain_ms["vrl_r"] = timed_call(
            lambda: vrl_r_reference(*rpacks, u_r, **mkw))
    median, share = homog_bar(out[0], ref[0], channels=1)
    check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
          f"kernel 5 (textured) philox: {median}, {share}")
    nz = ref[1] > R_VAR_FLOOR
    v_med = float(((out[1] - ref[1]).abs()[nz] / ref[1][nz]).median())
    check(v_med < R_VAR_MEDIAN, f"kernel 5 (textured) var {v_med}")
    lines.append(f"kernel 5 philox ({n_rep} representative rays) mean median "
                 f"{median:.2e} share>1e-2 {share:.4f}, var median "
                 f"{v_med:.2e}")
    errs["vrl_r"] = max(errs["vrl_r"], float((out - ref).abs().max()))
    _, r_counts = vrl_r_check(*rpacks, seed=seed, **mkw)
    check(r_counts["bad_tris"] == 0 and r_counts["bad_segments"] == 0,
          f"kernel 5 (textured): the checking launch: {r_counts}")
    del u_k, u_r

    # every earlier form's SASS is the parent's (the digests of their
    # outputs: phases 40, 43, 47 and 49)
    t_sass = time.perf_counter()
    out_s, err_s = sass_check.communicate(timeout=900)
    check(sass_check.returncode == 0, f"sass_compare.py: {err_s[-2000:]}")
    sass = json.loads(out_s.strip().splitlines()[-1])
    check(not sass["missing"], f"{len(sass['missing'])} of the parent's "
          f"{sass['functions']} kernel functions have another SASS: "
          f"{sass['missing'][:8]}")
    lines.append(f"SASS: each of the parent's {sass['functions']} functions "
                 "found in this library (sass_compare.py --against, waited "
                 f"{time.perf_counter() - t_sass:.1f} s)")
    print(f"[50a textured kernels vs plain on {card}, cornell_textured "
          f"B={n_rays} N={n_vrls} T={scene.faces.shape[0]} "
          f"M={mats[0].shape[0]}, materials seen {seen}] "
          + " | ".join(lines), flush=True)

    # the main path: the unclustered and the clustered render
    counters = (vrl_sum, vrl_r, vrl_sum_clustered)
    for fn in counters:
        fn.launches = fn.tex_launches = 0
    with plain_calls() as plain:
        img = integrator.render_with_vrls_kernel(
            scene, vrls, torch.Generator().manual_seed(1), cfg)
        img_c, _, _ = alvrl.render_alvrl(
            scene, torch.Generator().manual_seed(2), params, cfg,
            slice_info=info)
        torch.cuda.synchronize()
    launches = {fn.__name__: (fn.launches, fn.tex_launches)
                for fn in counters}
    check(all(t >= 1 and t == n for n, t in launches.values())
          and plain[0] == 0, f"the main path's (launches, textured "
          f"launches) {launches}, plain calls {plain[0]}")
    for name, im in (("unclustered", img), ("clustered", img_c)):
        check(tuple(im.shape) == (HEIGHT, WIDTH, 3)
              and bool(torch.isfinite(im).all())
              and float(im.abs().max()) > 0.0, f"the {name} image")
    ratio = float(img_c.mean()) / float(img.mean())
    check(0.85 < ratio < 1.15, f"clustered against unclustered: {ratio}")

    # times: each textured launch beside the material form on the same
    # packs (the textures dropped: its rows' MATID prefix), in turns
    c_block = vsc.ray_block(False)
    c_out = torch.zeros((3, n_rays), device=dev)
    tiles = [torch.as_tensor(a, device=dev)
             for a in group_by_slice(sop, c_block)]

    def c_launch(p):
        return lambda: vsc._launch(
            vsc._library(), *p, *tiles, tv, tw, None, seed, 2, 2, True,
            scene.medium.phase_kind, c_out, materials=mats)

    rm = (rpacks[0][:pk.MAT_RAY_ROWS].contiguous(), *rpacks[1:])
    timed = {"vrl_sum": (lambda: vrl_sum(*packs, seed=seed, **mkw),
                         lambda: vrl_sum(*mpacks, seed=seed, **mkw), cuda_ms),
             "vrl_sum_clustered": (c_launch(packs), c_launch(mpacks),
                                   cuda_ms_batched),
             "vrl_r": (lambda: vrl_r(*rpacks, seed=seed, **mkw),
                       lambda: vrl_r(*rm, seed=seed, **mkw),
                       cuda_ms_batched)}
    ms = {}
    for k, (tex_fn, mat_fn, timer) in timed.items():
        args = (3, 10) if timer is cuda_ms else (3, 10, 10)
        m0 = timer(mat_fn, *args)
        t0 = timer(tex_fn, *args)
        t1 = timer(tex_fn, *args)
        m1 = timer(mat_fn, *args)
        ms[k] = (summary(t0 + t1), summary(m0 + m1))
    hg = scene.medium.phase_kind == 0

    def tex_ops(kernel, sweep, counts):
        # the textured eval priced as the material one (its leaves read
        # the ray's albedos in place of the row's)
        f, s = plane_ops(kernel_ops(kernel, sweep, hg, True), sweep, counts)
        return (f + sweep.open[1] * OPS["eval_smooth"][0],
                s + sweep.open[1] * OPS["eval_smooth"][1])

    mat_bytes = nbytes(*mats)
    bounds = {
        "vrl_sum": bound(tex_ops("vrl_sum", s1, k1_counts),
                         nbytes(*packs) + mat_bytes + 3 * n_rays * 4),
        "vrl_sum_clustered": bound(
            tex_ops("vrl_sum_clustered", s2, c_counts),
            nbytes(*packs, tv, tw) + mat_bytes + 4 * sum(
                len(a) for a in group_by_slice(sop, c_block))
            + 3 * n_rays * 4),
        "vrl_r": bound(tex_ops("vrl_r", s5, r_counts),
                       nbytes(*rpacks) + mat_bytes + 2 * n_rep * n_vrls * 4),
    }
    regs = [r for r in ptxas_summary(_build.build_log())
            if ",tex>" in r and ",grid," not in r]
    print(f"[50b textured kernels' timing on {card}] " + " | ".join(
        f"{k}: textured {t[0]:.4f} ms (spread {t[1]:.1%}), material form on "
        f"the same packs {m[0]:.4f} ms (spread {m[1]:.1%}), in turns; plain "
        f"{plain_ms[k]:.2f} ms; bound {bounds[k][0]:.4f} ms by {bounds[k][1]}"
        for k, (t, m) in ms.items())
        + f" | samples: kernel 1 {s1}; kernel 2 {s2}; kernel 5 {s5}"
        + " | ptxas (textured forms): " + " ; ".join(regs)
        + f" | the main path: render_with_vrls_kernel and render_alvrl "
        f"(launches, textured launches) {launches}, no plain version, image "
        f"means {float(img.mean()):.6g} and {float(img_c.mean()):.6g} "
        f"(clustered x{ratio:.4f})", flush=True)

    # the CLI on the scene file, and the equal-transport A/B of the VRL
    # render against the volpath oracle on the closed textured box
    for fn in counters:
        fn.tex_launches = 0
    cli_runs(dev, card, tmp, TEX_CLI_RUNS, phase="50c the CLI")
    check(all(fn.tex_launches >= 1 for fn in counters),
          "the CLI runs took no textured launch of kernels 1, 5 and 2")
    small = loader.build_scene(presets.cornell_textured_desc(
        tmp, AB_SIZE, AB_SIZE, seed=TEX_SEED), device=dev)
    print(f"[50d the volpath oracle on {card}] "
          + ab_oracle(dev, card, small, "cornell_textured")
          + f" | phase 50 wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    tmp_dir.cleanup()
    sources = {"vrl_sum": ("vrl_sum_tex.cu",
                           "alvrl_tpu/ops/vrl_pallas.py:726"),
               "vrl_sum_clustered": ("vrl_sum_clustered_tex.cu",
                                     "alvrl_tpu/ops/vrl_pallas.py:785"),
               "vrl_r": ("vrl_r_tex.cu", "alvrl_tpu/ops/vrl_pallas.py:1019")}
    return [{
        "name": f"{k} (textured)", "route": "cuda",
        "source": f"alvrl_tpu_torch/csrc/{sources[k][0]}",
        "replaces": sources[k][1], "launches": launches[k][1],
        "max_abs_err": errs[k], "ms": ms[k][0][0], "plain_ms": plain_ms[k],
        "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
        "library_ms": None} for k in ("vrl_sum", "vrl_sum_clustered",
                                      "vrl_r")]


# phase 51: textured surfaces in a grid medium and on large meshes. The
# textured grid scene: cornell_textured's surfaces (presets.
# cornell_textured_desc) in config 4's medium (its 48^3 plume) at
# 512x512, its VRLs traced 192 x 10 into 512 slots, 128 slices; the
# textured cube field: phase 29/30's 15,984-triangle field with
# cornell_textured's walls and its seven materials seen from the camera
# on the cubes in turn (presets.textured_cube_field), in its HG balance
# medium and in phase 43's mixture + single medium
TG_SEED = 20261023
TG_KIND_RAYS = 512      # held rays of each material, grid scene
TG_FIELD_RAYS = 500     # held rays of each material, the field (both media)
# the forms of phase 51 in the kernels line: (name, source, the TPU
# kernel it replaces)
TG_FORMS = {
    "3tex": ("vrl_sum_hetero textured", "vrl_sum_grid_tex.cu", 863),
    "3ttex": ("vrl_sum_hetero textured trilinear", "vrl_sum_grid_tex.cu",
              863),
    "4tex": ("vrl_sum_hetero_clustered textured",
             "vrl_sum_clustered_grid_tex.cu", 937),
    "4ttex": ("vrl_sum_hetero_clustered textured trilinear",
              "vrl_sum_clustered_grid_tex.cu", 937),
    "6tex": ("vrl_r_hetero textured", "vrl_r_grid_tex.cu", 1082),
    "6ttex": ("vrl_r_hetero textured trilinear", "vrl_r_grid_tex.cu", 1082),
    "7tex": ("vrl_sum_bvh textured", "vrl_sum_bvh_tex.cu", 1415),
}
TG_RUNS = [
    ("textured grid vrl", "textured_grid.json", "vrl", 1,
     ["--particles", "192"], ("vrl_sum_hetero",)),
    ("textured grid alvrl", "textured_grid.json", "alvrl", 1,
     ["--particles", "192"], ("vrl_r_hetero", "vrl_sum_hetero_clustered")),
]


def textured_grid_desc(c4_scene, tmp, width, height):
    """cornell_textured's surfaces (its bitmaps written into tmp) in config
    4's grid medium, its density in tmp, as a JSON dict."""
    med = c4_scene.medium
    path = os.path.join(tmp, "textured_density.npy")
    np.save(path, med.density.cpu().numpy())
    desc = presets.cornell_textured_desc(tmp, width, height, seed=TEX_SEED)
    desc["medium"] = {
        "type": "grid", "density_npy": path,
        "sigma_t": med.sigma_t_color.cpu().tolist(),
        "albedo": med.albedo.cpu().tolist(), "g": float(med.g),
        "box_min": med.box_min.cpu().tolist(),
        "box_max": med.box_max.cpu().tolist(), "scale": float(med.scale),
        "phase": "hg"}
    return desc


def tg_entry(key, launches, err, ms, plain_ms, bnd):
    name, src, line = TG_FORMS[key]
    return {"name": name, "route": "cuda",
            "source": f"alvrl_tpu_torch/csrc/{src}",
            "replaces": f"alvrl_tpu/ops/vrl_pallas.py:{line}",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": None}


@contextlib.contextmanager
def grid_sum_calls():
    """Record the calls that the integrator's routes make of kernels 3
    and 4 (integrator.vrl_sum_hetero and vrl_sum_hetero_clustered, the
    wrappers whose launches they count): yields {name: [(args, kwargs,
    output)]}."""
    names = ("vrl_sum_hetero", "vrl_sum_hetero_clustered")
    saved = [(n, getattr(integrator, n)) for n in names]
    rec = {n: [] for n in names}
    for n, fn in saved:
        def recording(*a, _fn=fn, _n=n, **k):
            out = _fn(*a, **k)
            rec[_n].append((a, k, out))
            return out
        setattr(integrator, n, recording)
    try:
        yield rec
    finally:
        for n, fn in saved:
            setattr(integrator, n, fn)


def tg_frame_holds(rec, rng, ids, read, hold):
    """51a: the main path's own launches of kernels 3 and 4 on the whole
    frame (grid_sum_calls' records: the unclustered render's sum and
    render_alvrl's clustered launch on its slices' tables, and its
    fall-back launch), held on TG_KIND_RAYS seeded rays of each material
    (the fall-back launch on as many of its rays) against the plain
    versions on the launch's own packs and tables, with the Philox draws
    at the rays' frame indices and table columns (a fall-back launch
    whose pixels all miss: its sums all 0). Returns (a line, each
    kernel's largest |kernel - plain|)."""
    dev = rec["vrl_sum_hetero"][0][0][0].device
    parts, err = [], {"3": 0.0, "4": 0.0}

    def pick(ray_mat, what):
        seen = {i: int((ray_mat == i).sum()) for i in ids}
        check(min(seen.values()) >= TG_KIND_RAYS,
              f"{what}: the rays of each material {seen}")
        return tg_pick(rng, ray_mat, ids, TG_KIND_RAYS)

    def plain_kw(k):
        return ({n: v for n, v in k.items() if n not in ("seed", "uniforms")},
                2 * k["vol_vol_samples"] + k["vol_surf_samples"])

    (a, k, out), = rec["vrl_sum_hetero"]
    check(k.get("uniforms") is None,
          "kernel 3's render launch: the Philox stream")
    rays, kw, n_draws = a[0], *plain_kw(k)
    ray_mat = torch.where(rays[pk.VALID] > 0.5, rays[pk.GRID_MATID].long(), -1)
    rows = pick(ray_mat, f"kernel 3 {read}, the render's launch")
    u = philox_draws(k["seed"], rows[:, None], torch.arange(
        a[1].shape[1], device=dev)[None], n_draws)
    with plain_chunk(C4_PLAIN_CHUNK):
        ref = vrl_sum_hetero_reference(rays[:, rows].contiguous(), *a[1:], u,
                                       **kw)
    parts.append(hold(f"kernel 3 {read}, the render's launch ({rays.shape[1]} "
                      f"rays x {a[1].shape[1]})", out[:, rows].T, ref.T,
                      ray_mat[rows]))
    err["3"] = float((out[:, rows] - ref).abs().max())
    launches = rec["vrl_sum_hetero_clustered"]
    check(len(launches) == 2, f"render_alvrl's launches of kernel 4: "
          f"{len(launches)}, not the clustered one and the fall-back's")
    for i, (a, k, out) in enumerate(launches):
        check(k.get("uniforms") is None,
              "kernel 4's render launch: the Philox stream")
        rays, kw, n_draws = a[0], *plain_kw(k)
        sl = torch.as_tensor(np.asarray(torch.as_tensor(a[5]).cpu()),
                             device=dev).long()
        ray_mat = torch.where((rays[pk.VALID] > 0.5) & (sl >= 0),
                              rays[pk.GRID_MATID].long(), -1)
        if i == 0:
            rows = pick(ray_mat, f"kernel 4 {read}, the clustered launch")
        else:  # the fall-back pixels that hit: a seeded sample of them
            kept = torch.nonzero(ray_mat >= 0)[:, 0].cpu().numpy()
            if not len(kept):  # none hit: every sum of the launch is 0
                check(float(out.abs().max()) == 0.0, "kernel 4's fall-back "
                      "launch: sums where no fall-back pixel hits")
                parts.append(f"kernel 4 {read}, render_alvrl's fall-back "
                             f"launch: {int((sl >= 0).sum())} pixels, none "
                             "a hit, its sums all 0")
                continue
            rows = torch.as_tensor(np.sort(rng.choice(kept, min(
                len(kept), len(ids) * TG_KIND_RAYS), replace=False)),
                device=dev)
        r = sl[rows]
        tid, tw = a[6], a[7]
        u = torch.where((r >= 0)[:, None, None], philox_draws(
            k["seed"], rows[:, None], tid[r.clamp(min=0)].long(), n_draws),
            0.0)
        with plain_chunk(C4_PLAIN_CHUNK):
            ref = vrl_sum_hetero_clustered_reference(
                rays[:, rows].contiguous(), *a[1:5], r, tid, tw, u, **kw)
        label = (f"kernel 4 {read}, render_alvrl's "
                 f"{('clustered', 'fall-back')[i]} launch ({rays.shape[1]} "
                 f"rays, {tid.shape[0]} x {tid.shape[1]} table)")
        if i == 0:
            parts.append(hold(label, out[:, rows].T, ref.T, ray_mat[rows]))
        else:
            median, share = homog_bar(out[:, rows].T, ref.T)
            check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
                  f"{label}: {len(rows)} rays, {median}, {share}")
            parts.append(f"{label}: {len(rows)} rays {median:.2e}/"
                         f"{share:.4f}")
        err["4"] = max(err["4"], float((out[:, rows] - ref).abs().max()))
    return "; ".join(parts), err


def tg_pick(rng, ray_mat, ids, n):
    """n rays of each material id in `ids` (a seeded pick), on the card."""
    mat = ray_mat.cpu().numpy()
    return torch.as_tensor(np.concatenate([rng.choice(
        np.flatnonzero(mat == k), n, replace=False) for k in sorted(ids)]),
        device=ray_mat.device)


def textured_grid(dev, card, cfg, c4):
    """Phase 51: the textured forms of kernels 3, 4 and 6 (nearest and
    trilinear) on the textured grid scene and kernel 7's on the textured
    cube field, against their plain versions material by material and
    over the held rays, their checking and counting launches, the main
    paths' textured launches, times beside the material forms on the
    same packs (the textures dropped), registers, bounds; the CLI on the
    grid scene file. Returns the kernels line's seven entries."""
    t51 = time.perf_counter()
    entries = {}
    with tempfile.TemporaryDirectory() as tmp:
        desc = textured_grid_desc(c4["scene"], tmp, "$w", "$h")
        names = [m["name"] for m in desc["materials"]]
        path = os.path.join(tmp, "textured_grid.json")
        with open(path, "w") as f:
            f.write(json.dumps(desc).replace('"$w"', "$w").replace(
                '"$h"', "$h"))
        scene = loader.load_json(path, {"w": C4_SIZE, "h": C4_SIZE},
                                 device=dev)
        check(scene.textured() and hasattr(scene.medium, "density")
              and torch.equal(scene.medium.density,
                              c4["scene"].medium.density),
              "the textured grid scene's table and medium")
        entries.update(tg_grid_forms(dev, card, cfg, scene, c4, names))
        entries.update(tg_field_form(dev, card, scene, names))
        runs = [(label, name, integ, passes,
                 ["-D", f"w={C4_SIZE}", "-D", f"h={C4_SIZE}", *opts], route)
                for label, name, integ, passes, opts, route in TG_RUNS]
        fns = (vs.vrl_sum_hetero, vr.vrl_r_hetero,
               vsc.vrl_sum_hetero_clustered)
        for fn in fns:
            fn.tex_launches = 0
        t_cli = time.perf_counter()
        cli = cli_runs(dev, card, tmp, runs, "51c the CLI on the textured "
                       "grid scene file")
        check(all(fn.tex_launches >= 1 for fn in fns),
              "the CLI runs took no textured launch of kernels 3, 6 and 4")
        t_cli = time.perf_counter() - t_cli
    print(f"[51 on {card}] the CLI's ms a pass: " + ", ".join(
        f"{k} {v[0]:.1f}" for k, v in cli.items())
        + f" | 51c {t_cli:.1f} s, phase 51 {time.perf_counter() - t51:.1f} s",
        flush=True)
    return [entries[k] for k in TG_FORMS]


def tg_grid_forms(dev, card, cfg, scene, c4, names):
    """51a: kernels 3, 4 and 6's textured forms, nearest and trilinear."""
    t0 = time.perf_counter()
    params, tcfg = c4["params"], c4["tcfg"]
    vrls = vrl.compact(tracer.trace(scene, torch.Generator().manual_seed(
        TG_SEED), params.num_particles, tcfg), params.vrl_target_num,
        slots_per_particle=C4_DEPTH)
    n_vrls, seed, uv = vrls.capacity, TG_SEED, cfg.uv_tau_steps
    info = alvrl.build_slice_info(scene, params)
    seen_ids = {names.index(n) for n in TEX_SEEN}
    rng = np.random.default_rng(51)
    lines, entries = [], {}
    for fast_tau, tag in ((True, ""), (False, "t")):
        sc = replace(scene, medium=replace(scene.medium, fast_tau=fast_tau))
        read = "nearest" if fast_tau else "trilinear"
        mats = integrator.material_pack(sc)
        packs = integrator.pack_frame(sc, vrls, materials=mats)[3]
        check(packs[0].shape[0] == pk.GRID_TEX_RAY_ROWS
              and pk.is_trilinear(packs[3]) != fast_tau,
              f"the textured grid packs ({read})")
        valid = packs[0][pk.VALID] > 0.5
        ray_mat = torch.where(valid, packs[0][pk.GRID_MATID].long(), -1)
        seen = {k: int((ray_mat == k).sum()) for k in seen_ids}
        check(set(ray_mat[valid].tolist()) == seen_ids
              and min(seen.values()) >= TG_KIND_RAYS,
              f"the materials seen ({read}): {seen}")
        pick = tg_pick(rng, ray_mat, seen_ids, TG_KIND_RAYS)
        sub = (packs[0][:, pick].contiguous(), *packs[1:])
        msub = (sub[0][:pk.GRID_MAT_RAY_ROWS].contiguous(), *sub[1:])
        n_sub = len(pick)
        sop = np.arange(n_sub, dtype=np.int32) % GG_SLICES
        tv = torch.as_tensor(rng.integers(0, n_vrls, (GG_SLICES, GG_COLS)),
                             dtype=torch.int32, device=dev)
        tw = torch.as_tensor(rng.uniform(0.0, 2.0, (GG_SLICES, GG_COLS)),
                             dtype=torch.float32, device=dev)
        mkw = dict(materials=mats, uv_steps=uv)
        u3 = philox_uniforms(seed, n_sub, n_vrls, 6, device=dev)
        u4 = philox_table_uniforms(seed, sop, tv, 6)
        outs = {"3": vs.vrl_sum_hetero(*sub, seed=seed, **mkw),
                "4": vsc.vrl_sum_hetero_clustered(*sub, sop, tv, tw,
                                                  seed=seed, **mkw),
                "6": vr.vrl_r_hetero(*sub, seed=seed, **mkw)}
        surf = mats[0][sub[0][pk.GRID_MATID].long(), pk.MT_SMOOTH] > 0.5
        with plain_chunk(C4_PLAIN_CHUNK):
            with SweepCount(pair_masks(*sub[:2])[0], surf) as s3:
                ref3, p3 = timed_call(lambda: vrl_sum_hetero_reference(
                    *sub, u3, **mkw))
            with SweepCount(table_pair_ok(sub[0], sub[1], sop, tv, tw),
                            surf) as s4:
                ref4, p4 = timed_call(
                    lambda: vrl_sum_hetero_clustered_reference(
                        *sub, sop, tv, tw, u4, **mkw))
            ref6, p6 = timed_call(lambda: vrl_r_hetero_reference(
                *sub, u3, **mkw))
        torch.cuda.synchronize()
        s6 = s3  # kernel 6 meets kernel 3's samples on the same uniforms
        for k, o in outs.items():
            check(bool(torch.isfinite(o).all()) and float(o.abs().sum()) > 0,
                  f"kernel {k} ({read}, textured): finite and non-zero")
        ksub = ray_mat[pick]

        def hold(label, out, ref, kind, channels=3, min_items=TG_KIND_RAYS):
            line = hold_by_kind(label, out, ref, kind, channels, min_items,
                                kinds=seen_ids)
            median, share = homog_bar(out, ref, channels)
            check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
                  f"{label}: the held rays {median}, {share}")
            return line + f"; all {median:.2e}/{share:.4f}"

        held = [hold(f"kernel 3 {read}", outs["3"].T, ref3.T, ksub),
                hold(f"kernel 4 {read} ({GG_COLS} columns)", outs["4"].T,
                     ref4.T, ksub),
                hold(f"kernel 6 {read} mean", outs["6"][0], ref6[0],
                     ksub[:, None].expand(-1, n_vrls), 1,
                     TG_KIND_RAYS * n_vrls)]
        nz = ref6[1] > R_VAR_FLOOR
        v_med = float(((outs["6"][1] - ref6[1]).abs()[nz] / ref6[1][nz])
                      .median())
        check(v_med < R_VAR_MEDIAN, f"kernel 6 {read} (textured) var {v_med}")
        errs = {"3": float((outs["3"] - ref3).abs().max()),
                "4": float((outs["4"] - ref4).abs().max()),
                "6": float((outs["6"] - ref6).abs().max())}
        c_chk, c_counts = vsc.vrl_sum_hetero_clustered_check(
            *sub, sop, tv, tw, seed=seed, **mkw)
        _, r_counts = vr.vrl_r_hetero_check(*sub, seed=seed, **mkw)
        for what, counts in (("kernel 4", c_counts), ("kernel 6", r_counts)):
            check(counts["bad_tris"] == 0 and counts["bad_segments"] == 0
                  and counts["segments"] > 0, f"{what} {read} (textured): "
                  f"the checking launch: {counts}")
        check(torch.equal(c_chk, outs["4"]), f"kernel 4 {read} (textured): "
              "the checking launch is not the sum's")
        # the main path: the unclustered render and render_alvrl
        fns = (vs.vrl_sum_hetero, vr.vrl_r_hetero,
               vsc.vrl_sum_hetero_clustered)
        for fn in fns:
            fn.launches = fn.tex_launches = fn.tri_launches = 0
        with plain_calls() as plain, grid_sum_calls() as rec:
            img = integrator.render_with_vrls_kernel(
                sc, vrls, torch.Generator().manual_seed(151), cfg)
            img_c, _, _ = alvrl.render_alvrl(
                sc, torch.Generator().manual_seed(251), params, cfg, tcfg,
                slice_info=info)
            torch.cuda.synchronize()
        launches = {fn.__name__: (fn.launches, fn.tex_launches,
                                  fn.tri_launches) for fn in fns}
        check(plain[0] == 0 and all(
            n >= 1 and t == n and r == (0 if fast_tau else n)
            for n, t, r in launches.values()),
            f"the main path's launches ({read}): {launches}, plain calls "
            f"{plain[0]}")
        for name, im in (("unclustered", img), ("clustered", img_c)):
            check(tuple(im.shape) == (C4_SIZE, C4_SIZE, 3)
                  and bool(torch.isfinite(im).all())
                  and float(im.abs().max()) > 0, f"the {name} image")
        frame_line, frame_err = tg_frame_holds(rec, rng, seen_ids, read, hold)
        for key, e in frame_err.items():
            errs[key] = max(errs[key], e)
        # times: each textured form beside its material form on the same
        # packs (the textures dropped), in turns (material, textured,
        # textured, material)
        block = vsc.ray_block(True)
        tiles = [torch.as_tensor(a, device=dev)
                 for a in group_by_slice(sop, block)]
        c_out = torch.zeros((3, n_sub), device=dev)
        grid_arg = (sub[4], uv)

        def c_launch(p):
            return lambda: vsc._launch(vsc._library(), *p[:4], *tiles, tv,
                                       tw, None, seed, 2, 2, True, 0, c_out,
                                       grid_arg, materials=mats)

        timed = {"3": (lambda: vs.vrl_sum_hetero(*sub, seed=seed, **mkw),
                       lambda: vs.vrl_sum_hetero(*msub, seed=seed, **mkw)),
                 "4": (c_launch(sub), c_launch(msub)),
                 "6": (lambda: vr.vrl_r_hetero(*sub, seed=seed, **mkw),
                       lambda: vr.vrl_r_hetero(*msub, seed=seed, **mkw))}
        ms = {}
        for k, (tex_fn, mat_fn) in timed.items():
            runs = [cuda_ms_batched(f, 2, 3, 5) for f in (mat_fn, tex_fn,
                                                          tex_fn, mat_fn)]
            ms[k] = (summary(runs[1] + runs[2]), summary(runs[0] + runs[3]))

        def tex_ops(kernel, sweep, counts=None):
            # the textured eval priced as the material one (its leaves read
            # the ray's albedos in place of the row's)
            f, s = kernel_ops(kernel, sweep, True, True, uv, tri=not fast_tau)
            if counts is not None:
                f, s = plane_ops((f, s), sweep, counts)
            return (f + sweep.open[1] * OPS["eval_smooth"][0],
                    s + sweep.open[1] * OPS["eval_smooth"][1])

        mat_bytes = nbytes(*mats)
        bounds = {
            "3": bound(tex_ops("vrl_sum", s3), nbytes(*sub) + mat_bytes
                       + 3 * n_sub * 4),
            "4": bound(tex_ops("vrl_sum_clustered", s4, c_counts),
                       nbytes(*sub, tv, tw, *tiles) + mat_bytes
                       + 3 * n_sub * 4),
            "6": bound(tex_ops("vrl_r", s6, r_counts), nbytes(*sub)
                       + mat_bytes + 2 * n_sub * n_vrls * 4)}
        plain_ms = {"3": p3, "4": p4, "6": p6}
        counts = {"3": launches["vrl_sum_hetero"][1],
                  "4": launches["vrl_sum_hetero_clustered"][1],
                  "6": launches["vrl_r_hetero"][1]}
        for k in ("3", "4", "6"):
            entries[f"{k}{tag}tex"] = tg_entry(
                f"{k}{tag}tex", counts[k], errs[k], ms[k][0][0], plain_ms[k],
                bounds[k])
        lines.append(
            f"{read}: " + "; ".join(held) + f"; the main path's launches on "
            f"the whole frame: {frame_line}; kernel 6 var median "
            f"{v_med:.2e} | checking launches: kernel 4 "
            f"{check_line(c_counts)}; kernel 6 {check_line(r_counts)} | "
            f"main path launches (all, textured, trilinear) {launches}, "
            f"no plain call; images' means {float(img.mean()):.6g} and "
            f"{float(img_c.mean()):.6g} | ms (CUDA events, textured / "
            "material on the same packs, in turns): " + "; ".join(
                f"kernel {k} {t[0]:.4f} (spread {t[1]:.1%}) / {m[0]:.4f} "
                f"(x{t[0] / m[0]:.2f})" for k, (t, m) in ms.items())
            + " | plain " + ", ".join(f"kernel {k} {v:.1f} ms"
                                      for k, v in plain_ms.items())
            + "; bounds " + ", ".join(f"kernel {k} {b[0]:.4f} ms by {b[1]}"
                                      for k, b in bounds.items())
            + f"; samples: kernel 3 {s3}; kernel 4 {s4}")
    regs = [r for r in ptxas_summary(_build.build_log())
            if ",grid," in r and ",tex" in r]
    print(f"[51a grid textured forms on {card}, cornell_textured in config "
          f"4's {C4_GRID}^3 medium {C4_SIZE}x{C4_SIZE}, {n_vrls} traced VRL "
          f"slots; kernels 3, 4 and 6 on {TG_KIND_RAYS} rays of each "
          f"material] " + " || ".join(lines) + " | ptxas: " + " ; ".join(regs)
          + f" | {time.perf_counter() - t0:.1f} s", flush=True)
    return entries


def tg_field_form(dev, card, tex_scene, names):
    """51b: kernel 7's textured form on the textured cube field, in its HG
    balance medium and in phase 43's mixture + single medium."""
    t0 = time.perf_counter()
    ids = [names.index(n) for n in TEX_SEEN]
    field = presets.textured_cube_field(
        bbl.scene_of("cubes", FIELD_AXES, device=dev), tex_scene, ids)
    vrls = bbl.bench_vrls(field)
    seed = TG_SEED
    cases = [("hg", field, TG_FIELD_RAYS),
             (*field_media(field)[0], TG_FIELD_RAYS)]
    small = presets.textured_cube_field(
        bbl.scene_of("cubes", SMALL_AXES, device=dev), tex_scene, ids)
    rng = np.random.default_rng(52)
    lines, errs, plain_ms, launches = [], {}, {}, 0
    ms = bnd = None
    for name, sc, per_mat in cases:
        mats = integrator.material_pack(sc)
        kw = dict(phase_kind=sc.medium.phase_kind, materials=mats)
        f = vb.vrl_sum_bvh
        f.launches = f.mat_launches = f.tex_launches = f.mix_launches = 0
        with plain_calls() as plain:
            img = integrator.render_with_vrls_kernel_bvh(
                sc, vrls, torch.Generator().manual_seed(351))
            torch.cuda.synchronize()
        moved = (f.launches, f.mat_launches, f.tex_launches, f.mix_launches)
        check(plain[0] == 0 and moved == (1, 1, 1, 0)
              and bool(torch.isfinite(img).all())
              and float(img.abs().max()) > 0,
              f"kernel 7 {name} (textured): the render's launches {moved}")
        launches += moved[2]
        packs = integrator.pack_frame_bvh(sc, vrls, materials=mats)[3]
        check(pk.is_textured(packs[0]), f"kernel 7 {name}: the textured pack")
        valid = packs[0][pk.VALID] > 0.5
        ray_mat = torch.where(valid, packs[0][pk.MATID].long(), -1)
        seen = {k: int((ray_mat == k).sum()) for k in ids}
        check(set(ray_mat[valid].tolist()) == set(ids)
              and min(seen.values()) >= TG_FIELD_RAYS,
              f"the field's materials seen: {seen}")
        out = vb.vrl_sum_bvh(*packs, seed=seed, **kw)
        rows = tg_pick(rng, ray_mat, set(ids), per_mat)
        u = philox_draws(seed, rows[:, None], torch.arange(
            packs[1].shape[1], device=dev)[None], 6)
        ref, p_ms = timed_call(lambda: vb.vrl_sum_bvh_reference(
            packs[0][:, rows].contiguous(), *packs[1:], u, **kw))
        torch.cuda.synchronize()
        held = hold_by_kind(f"kernel 7 {name}", out[:, rows].T, ref.T,
                            ray_mat[rows], min_items=per_mat, kinds=set(ids))
        median, share = homog_bar(out[:, rows].T, ref.T)
        check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
              f"kernel 7 {name} (textured) against its plain version: "
              f"{median}, {share}")
        errs[name] = float((out[:, rows] - ref).abs().max())
        plain_ms[name] = p_ms
        _, counts = vb.vrl_sum_bvh_counts(*packs, seed=seed, **kw)
        check(counts["differ"] == 0 and counts["segments"] > 0,
              f"kernel 7 {name} (textured): the counting launch {counts}")
        # kernel 1's textured form on the 780-triangle field, the same
        # rays, VRLs and uniforms
        spk = integrator.pack_frame_bvh(replace(small, medium=sc.medium),
                                        vrls, materials=mats)[3]
        us = torch.rand((spk[0].shape[1], spk[1].shape[1], 6), device=dev,
                        generator=torch.Generator(dev).manual_seed(51))
        a = vb.vrl_sum_bvh(*spk, uniforms=us, **kw)
        b = vrl_sum(spk[0], spk[1], spk[2].tris, spk[3], uniforms=us, **kw)
        k1_bar = homog_bar(a.T, b.T)
        check(k1_bar[0] < HOMOG_MEDIAN and k1_bar[1] < HOMOG_SHARE,
              f"kernel 7 {name} (textured) against kernel 1 at 780 "
              f"triangles: {k1_bar}")
        line = (f"{name} ({sc.faces.shape[0]} triangles): vs plain on "
                f"{len(rows)} rays ({per_mat} a material) {held}; all "
                f"{median:.2e}/{share:.4f}; vs kernel 1 at "
                f"{small.faces.shape[0]} triangles {k1_bar[0]:.2e}/"
                f"{k1_bar[1]:.4f}; counting launch differ 0; render "
                f"launches {moved}, mean {float(img.mean()):.6g}; plain "
                f"{p_ms:.1f} ms")
        if name == "hg":
            # times beside the material form on the same packs (the
            # textures dropped), in turns; the bound as phase 48's on this
            # run's samples with each open vol-surf sample's eval
            mpacks = (packs[0][:pk.MAT_RAY_ROWS].contiguous(), *packs[1:])
            new_fn = lambda: vb.vrl_sum_bvh(*packs, seed=seed, **kw)  # noqa: E731
            old_fn = lambda: vb.vrl_sum_bvh(*mpacks, seed=seed, **kw)  # noqa: E731
            runs = [cuda_ms_batched(g, 1, 3, 3) for g in (old_fn, new_fn,
                                                          new_fn, old_fn)]
            ms = (summary(runs[1] + runs[2]), summary(runs[0] + runs[3]))
            sweep = BvhSweep(packs[0], packs[1], counts)
            smooth = mats[0][packs[0][pk.MATID].long(), pk.MT_SMOOTH] > 0.5
            sweep.drawn[1] = 2 * int((pair_masks(packs[0], packs[1])[0]
                                      & smooth[:, None]).sum())
            fo, so = kernel_ops("vrl_sum", replace_counts(
                sweep, tri_tests=sweep.needed_tris), True, True)
            fo += sweep.needed_boxes * OPS["node"][0]
            so += sweep.tested[0] * OPS["bvh_segment"][1]
            fo += sweep.open[1] * OPS["eval_smooth"][0]
            so += sweep.open[1] * OPS["eval_smooth"][1]
            bnd = bound((fo, so), nbytes(packs[0], packs[1], packs[2].nodes,
                                         packs[2].tris, packs[3])
                        + nbytes(*mats) + 3 * packs[0].shape[1] * 4)
            line += (f"; ms {ms[0][0]:.4f} (spread {ms[0][1]:.1%}) against "
                     f"the material form's {ms[1][0]:.4f} on the same packs "
                     f"(x{ms[0][0] / ms[1][0]:.2f}); bound {bnd[0]:.4f} ms by "
                     f"{bnd[1]}; {sweep}")
        lines.append(line)
    regs = [r for r in ptxas_summary(_build.build_log()) if ",bvh>" in r]
    print(f"[51b kernel 7's textured form on {card}, the textured cube field "
          f"{bbl.WIDTH}x{bbl.WIDTH}, {vrls.capacity} traced VRL slots] "
          + " | ".join(lines) + " | ptxas: " + " ; ".join(regs)
          + f" | {time.perf_counter() - t0:.1f} s", flush=True)
    return {"7tex": tg_entry("7tex", launches, max(errs.values()), ms[0][0],
                             plain_ms["hg"], bnd)}


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs on the card only")

    torch.backends.cuda.matmul.allow_tf32 = False  # the camera's matmul
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[1 device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | devices {torch.cuda.device_count()}",
          flush=True)

    t0 = time.time()
    _build.load_library()
    build_s = time.time() - t0
    sass_check = start_sass_check()
    check(vs.compiled_uv_steps() == VRLConfig().uv_tau_steps,
          f"the grid kernels are compiled for {vs.compiled_uv_steps()} U-V "
          f"steps, the callers pass {VRLConfig().uv_tau_steps}")
    occupancy, warps = [], bwd._library().alvrl_ray_block() // 32
    for entry in ("vrl_sum", "vrl_sum_bwd", "vrl_sum_clustered",
                  "vrl_sum_clustered_bwd", "vrl_r"):
        for uv in (4, 3):
            blocks = vs.occupancy(entry, True, C4_TRIS, uv)
            occupancy.append(f"{entry}<0,1,grid,uv{uv if uv == 4 else '*'}> "
                             f"{blocks} blocks {blocks * warps} "
                             "warps")
    for entry in ("vrl_sum_bwd", "vrl_r", "vrl_sum_clustered",
                  "vrl_sum_clustered_bwd"):
        blocks = vs.occupancy(entry, False, 24)
        occupancy.append(f"{entry}<0,1,homog> at 24 triangles {blocks} "
                         f"blocks {blocks * warps} warps")
    print(f"[2 build] {build_s:.1f} s | ptxas: "
          + " ; ".join(ptxas_summary(_build.build_log()))
          + f" | resident per SM at {C4_TRIS} triangles: "
          + " ; ".join(occupancy), flush=True)

    cfg = VRLConfig(vol_vol_samples=2, vol_surf_samples=2)
    n_draws = 2 * cfg.vol_vol_samples + cfg.vol_surf_samples
    vrls = vrl.compact(vrl.load_ascii(BENCH_VRLS, particle_count=PARTICLE_COUNT,
                                      device=dev), N_VRLS)
    check(int(vrls.valid.sum()) == 508 and vrls.capacity == N_VRLS,
          "bench VRL set")
    n_rays = WIDTH * HEIGHT
    u_inj = torch.as_tensor(np.random.default_rng(0).random(
        (n_rays, N_VRLS, n_draws), dtype=np.float32), device=dev)
    seed3 = 20261016
    u_philox = philox_uniforms(seed3, n_rays, N_VRLS, n_draws, device=dev)
    max_abs_err = 0.0
    hold_rays = torch.arange(0, n_rays, K1_HOLD_STRIDE, device=dev)
    results, check_totals = [], dict.fromkeys(vs.CHECK_COUNTS, 0)
    media_packs = {}
    for name, (g, kind) in MEDIA.items():
        scene = presets.cornell_smoke(WIDTH, HEIGHT, g=g, device=dev)
        scene = replace(scene, medium=replace(scene.medium, phase_kind=kind))
        packs = media_packs[name] = integrator.pack_frame(scene, vrls)[3]
        check(packs[0].shape == (19, n_rays) and packs[2].shape == (24, 9),
              "config-1 shapes")
        for mode, u in (("injected", u_inj), ("philox", u_philox),
                        ("long", u_inj)):
            short = mode != "long"
            out = vrl_sum(*packs, seed=seed3,
                          uniforms=None if mode == "philox" else u,
                          short_vrls=short, phase_kind=kind)
            # the plain version on every K1_HOLD_STRIDE-th ray
            ref = vrl_sum_reference(
                packs[0][:, hold_rays].contiguous(), *packs[1:],
                u[hold_rays].contiguous(), short_vrls=short, phase_kind=kind)
            out = out[:, hold_rays]
            # kernel 1's checking instantiation on the same inputs
            kw = dict(uniforms=None if mode == "philox" else u,
                      short_vrls=short, phase_kind=kind)
            out_c, counts = vs.vrl_sum_check(*packs, seed=seed3, **kw)
            out_c = out_c[:, hold_rays]
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), f"{name}/{mode} finite")
            median, share = homog_bar(out.T, ref.T)
            err = float((out - ref).abs().max())
            max_abs_err = max(max_abs_err, err)
            check(counts["bad_tris"] == 0 and counts["bad_segments"] == 0,
                  f"{name}/{mode}: the pre-reject disagrees with the Wald "
                  f"test: {counts}")
            for k, v in counts.items():
                check_totals[k] += v
            results.append(f"{name}/{mode} median {median:.2e} "
                           f"share>1e-2 {share:.4f} max_abs {err:.3e}, "
                           f"checking launch equal {torch.equal(out_c, out)}")
            check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
                  f"{name}/{mode}: median {median}, share {share}")
    print(f"[3 kernel vs plain on {card}, B={n_rays} N={N_VRLS} T=24 from "
          f"shared memory, held on {len(hold_rays)} rays (every "
          f"{K1_HOLD_STRIDE}th)] " + " | ".join(results)
          + f" | pre-reject against the Wald test, all cases: "
          f"{check_totals['segments']} segments, "
          f"{check_totals['skipped']} of {check_totals['considered']} "
          f"triangle tests skipped, {check_totals['bad_tris']} skipped "
          f"triangles blocking, {check_totals['bad_segments']} segments "
          "decided differently", flush=True)

    # 4. the main path, through the entry point a user calls
    scene = presets.cornell_smoke(WIDTH, HEIGHT, device=dev)
    gen_seed = 1
    vrl_sum.launches = 0
    img = integrator.render_with_vrls_kernel(
        scene, vrls, torch.Generator().manual_seed(gen_seed), cfg)
    torch.cuda.synchronize()
    launches = vrl_sum.launches
    check(launches >= 1, "the render did not launch the vrl_sum kernel")
    check(tuple(img.shape) == (HEIGHT, WIDTH, 3), f"image shape {img.shape}")
    check(bool(torch.isfinite(img).all()), "image finite")
    check(float(img.abs().max()) > 0.0, "image non-zero")
    seed = int(torch.randint(0, 2**31 - 1, (1,),
                             generator=torch.Generator().manual_seed(gen_seed)))
    px, py, hit, packs = integrator.pack_frame(scene, vrls)
    plain = integrator.develop_sums(
        scene, vrls, px, py, hit,
        vrl_sum_reference(*packs, philox_uniforms(seed, n_rays, N_VRLS,
                                                  n_draws, device=dev)))
    median, share = homog_bar(img, plain)
    check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
          f"render vs plain render: median {median}, share {share}")
    _, render_check = vs.vrl_sum_check(*packs, seed=seed)
    check(render_check["bad_tris"] == 0 and render_check["bad_segments"] == 0,
          f"the render's segments: the pre-reject disagrees: {render_check}")
    print(f"[4 main path on {card}] cornell_smoke {WIDTH}x{HEIGHT} x "
          f"{N_VRLS} VRLs: "
          f"vrl_sum launches {launches}, image mean {float(img.mean()):.6f} "
          f"max {float(img.max()):.6f}, vs plain render median {median:.2e} "
          f"share>1e-2 {share:.4f} | the render's segments in the checking "
          f"launch: {check_line(render_check)}", flush=True)

    # 5. timing (after everything above has synchronised)
    torch.cuda.synchronize()
    u_render = philox_uniforms(seed, n_rays, N_VRLS, n_draws, device=dev)
    kernel_ms = cuda_ms(lambda: vrl_sum(*packs, seed=seed), 3, 20)
    plain_ms = cuda_ms(lambda: vrl_sum_reference(*packs, u_render), 1, 5)
    gen = torch.Generator().manual_seed(2)
    render_s = []
    for i in range(13):
        t = time.perf_counter()
        integrator.render_with_vrls_kernel(scene, vrls, gen, cfg)
        torch.cuda.synchronize()
        if i >= 3:
            render_s.append((time.perf_counter() - t) * 1e3)
    pair_evals = n_rays * N_VRLS * n_draws
    with SweepCount(*pair_masks(packs[0], packs[1])) as sum_sweep:
        vrl_sum_reference(*packs, u_render)
    hg = scene.medium.phase_kind == 0
    sum_bytes = nbytes(*packs) + 3 * n_rays * 4
    sweep_bound = bound(kernel_ops("vrl_sum", sum_sweep, hg, cfg.short_vrls),
                        sum_bytes)
    sum_bound = bound(plane_ops(kernel_ops("vrl_sum", sum_sweep, hg,
                                           cfg.short_vrls),
                                sum_sweep, render_check), sum_bytes)
    split = config1_split(packs, seed)
    k_med, k_spread = summary(kernel_ms)
    p_med, p_spread = summary(plain_ms)
    r_med, r_spread = summary(render_s)
    print(f"[5 timing on {card}] kernel {k_med:.3f} ms/pass (spread "
          f"{k_spread:.1%}, {pair_evals / (k_med / 1e3):.4g} pair-sample "
          f"evals/s) | plain {p_med:.3f} ms/pass (spread {p_spread:.1%}, "
          f"uniforms precomputed) | bound {sum_bound[0]:.4f} ms by "
          f"{sum_bound[1]} (the pre-reject's operations on its counted "
          f"skips; {sweep_bound[0]:.4f} ms with a Wald test for every "
          f"triangle swept; {sum_sweep}; the kernel's sweep "
          f"{render_check['considered'] / render_check['segments']:.3f} "
          f"triangles per segment) | render {r_med:.3f} ms/pass (spread "
          f"{r_spread:.1%}, {pair_evals / (r_med / 1e3):.4g} evals/s) | "
          "split (ms, CUDA events, the same launch with a part taken away): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)

    # 6. where the render's device time goes
    prof = profile_device(
        lambda: integrator.render_with_vrls_kernel(scene, vrls, gen, cfg),
        5, 10)
    if prof is None:
        print("[6 profile] the profiler saw no device operation: not "
              "measured", flush=True)
    else:
        span, busy, n_ops, by_name = prof
        k_ms = sum(v for k, v in by_name.items()
                   if "vrl_sum_plane_kernel" in k)
        top = sorted(((v, k) for k, v in by_name.items()
                      if "vrl_sum_plane_kernel" not in k), reverse=True)[:4]
        print(f"[6 profile on {card}] per traced pass: device span "
              f"{span:.3f} ms, busy {busy:.3f} ms, idle share "
              f"{1 - busy / span:.1%}, {n_ops:g} device ops; "
              f"vrl_sum_plane_kernel {k_ms:.3f} ms ({k_ms / busy:.1%} of busy); next: "
              + " | ".join(f"{v:.3f} ms {k[:60]}" for v, k in top),
              flush=True)

    # 7. the backward kernel against the plain backward, config-1 shapes
    gbar = torch.as_tensor(np.random.default_rng(1).uniform(
        0.5, 1.5, (3, n_rays)).astype(np.float32), device=dev)
    zero = list(media_packs["hg_g06"])
    zero[1] = zero[1].clone()
    zero[1][pk.VP + 1] = 0.0           # a VRL power channel at 0
    zero[3] = zero[3].clone()
    zero[3][2] -= zero[3][5]           # sigma_t = sigma_a in channel 2,
    zero[3][5] = 0.0                   # where sigma_s is 0
    cases = [(name, mode, media_packs[name], MEDIA[name][1])
             for name in MEDIA for mode in ("injected", "philox", "long")]
    cases.append(("zero_channels", "philox", zero, 0))
    # the holds on a sample of the rays: the output cotangent gbar is 0
    # off it, so that the kernel's sums over rays (d_power, d_par) are the
    # sample's, which the plain backward computes on the sample's rays
    # alone; the kernel runs on the whole frame (its Philox counters are
    # the rays' frame indices)
    idx = torch.arange(0, n_rays, BWD_HOLD_STRIDE, device=dev)
    gbar_s = torch.zeros_like(gbar)
    gbar_s[:, idx] = gbar[:, idx]
    bwd_err, results = 0.0, []
    for name, mode, packs, kind in cases:
        kw = dict(seed=seed3, uniforms=None if mode == "philox" else u_inj,
                  short_vrls=mode != "long", phase_kind=kind)
        out = bwd.vrl_sum_bwd(*packs, gbar_s, **kw)
        again = bwd.vrl_sum_bwd(*packs, gbar_s, **kw)
        u = u_philox if mode == "philox" else u_inj
        sample = (packs[0][:, idx].contiguous(), *packs[1:],
                  gbar[:, idx].contiguous(), u[idx].contiguous())
        ref, ref64 = (bwd.vrl_sum_bwd_reference(
            *(x.to(dt) for x in sample),
            short_vrls=mode != "long", phase_kind=kind)
            for dt in (torch.float32, torch.float64))
        torch.cuda.synchronize()
        off = torch.ones(n_rays, dtype=torch.bool, device=dev)
        off[idx] = False
        check(not bool(out[2][:, off].any()),
              f"{name}/{mode}: d_tau off the sample")
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"{name}/{mode}: a repeat launch is not bit-identical")
        out = (out[0], out[1], out[2][:, idx])
        check(all(bool(torch.isfinite(o).all()) for o in out),
              f"{name}/{mode} finite")
        (pw_bar, tau_bar), (par_rel, plain_rel), err = bwd_check(
            out, ref, ref64, kind)
        if name == "zero_channels":
            check(float(out[0][1].abs().max()) > 0.0
                  and float(out[1][5]) != 0.0,
                  "zero channels: d power[1] and d sigma_s[2] are not 0")
        bwd_err = max(bwd_err, err)
        results.append(f"{name}/{mode} d_power median {pw_bar[0]:.2e} share "
                       f"{pw_bar[1]:.4f}, d_tau median {tau_bar[0]:.2e} share "
                       f"{tau_bar[1]:.4f}, d_par rel {par_rel:.2e} (plain "
                       f"f32 vs f64 {plain_rel:.2e}), d_g "
                       f"{float(out[1][6]):.4g}")
    print(f"[7 backward kernel vs plain on {card}, B={n_rays} N={N_VRLS} "
          f"T=24, held on {len(idx)} rays (every {BWD_HOLD_STRIDE}th; gbar 0 "
          "on the others), repeats bit-identical] " + " | ".join(results),
          flush=True)
    del u_inj, u_philox, media_packs, zero

    # 8. the train step at full width, through the entry point
    tcfg = tracer.TracerConfig(max_depth=MAX_DEPTH)
    preset = presets.cornell_smoke(WIDTH, HEIGHT, device=dev)
    scene2 = replace(preset, medium=replace(
        preset.medium, sigma_a=preset.medium.sigma_a * 2))

    def gen():
        return torch.Generator().manual_seed(TRAIN_SEED)

    g = gen()  # the same draws as train_step's: tracer, then render seed
    target = integrator.render_with_vrls_kernel(
        preset, tracer.trace(preset, g, N_PARTICLES, tcfg), g, cfg)

    def step(scene):
        return train_step(scene, gen(), target, cfg, N_PARTICLES, tcfg)

    vrl_sum.launches = bwd.vrl_sum_bwd.launches = 0
    loss, grads = step(scene2)
    torch.cuda.synchronize()
    step_launches = (vrl_sum.launches, bwd.vrl_sum_bwd.launches)
    check(min(step_launches) >= 1,
          f"the train step's kernel launches {step_launches}")
    check(math.isfinite(float(loss)) and float(loss) > 0.0, f"loss {loss}")
    for k in PARAMS:
        check(bool(torch.isfinite(grads[k]).all())
              and bool((grads[k] != 0.0).all()), f"gradient {k} {grads[k]}")
    with plain_backward():
        loss_p, grads_p = step(scene2)
    check(float(loss_p) == float(loss), "plain-backward step: same loss")
    grad_rel = max(float(((grads[k] - grads_p[k]).abs()
                          / grads_p[k].abs()).max()) for k in PARAMS)
    check(grad_rel < PAR_RTOL, f"gradients vs plain backward: {grad_rel}")

    # same-seed central differences of the kernel forward, VRLs fixed
    vrls_step = tracer.trace(scene2, gen(), N_PARTICLES, tcfg)
    n_slots, n_valid = vrls_step.capacity, int(vrls_step.valid.sum())
    intensity0 = scene2.emitters.intensity

    def fd_loss(p, render):
        sc = with_params(scene2, p)
        vr = replace(vrls_step, power=vrls_step.power * (
            p["intensity"] / intensity0))
        img = render(sc, vr, torch.Generator().manual_seed(3), cfg)
        return ((img.double() - target.double()) ** 2).mean()

    p0 = {"sigma_a": scene2.medium.sigma_a, "sigma_s": scene2.medium.sigma_s,
          "g": scene2.medium.g, "intensity": intensity0}
    p = {k: v.clone().requires_grad_() for k, v in p0.items()}
    ad = dict(zip(p, torch.autograd.grad(
        fd_loss(p, integrator.render_with_vrls_kernel_diff), list(p.values()))))
    fd_results = []
    for label, name, idx, eps in [
            ("sigma_a[0]", "sigma_a", 0, 2e-3),
            ("sigma_s[1]", "sigma_s", 1, 2e-3), ("g", "g", None, 2e-3),
            ("intensity[0]", "intensity", (0, 0), 0.4)]:
        def shifted(s):
            q = {k: v.clone() for k, v in p0.items()}
            if idx is None:
                q[name] = q[name] + s
            else:
                q[name][idx] += s
            with torch.no_grad():
                return float(fd_loss(q, integrator.render_with_vrls_kernel))
        fd = (shifted(eps) - shifted(-eps)) / (2 * eps)
        a = float(ad[name] if idx is None else ad[name][idx])
        check(abs(a - fd) <= FD_TOL * abs(fd), f"FD {name}: {a} vs {fd}")
        fd_results.append(f"{label} ad {a:.6g} fd {fd:.6g}")

    # five SGD steps on sigma_a, from twice the preset's towards it
    sigma_a, losses = scene2.medium.sigma_a.clone(), []
    for i in range(5):
        sc = replace(scene2, medium=replace(scene2.medium, sigma_a=sigma_a))
        l_i, g_i = step(sc)
        if i == 0:
            first = g_i["sigma_a"]
            check(bool((first > 0.0).all()), f"first dL/dsigma_a {first}")
            lr = 0.1 * sigma_a.norm() / first.norm()
        losses.append(float(l_i))
        sigma_a = sigma_a - lr * g_i["sigma_a"]
    check(losses[-1] < losses[0], f"SGD losses {losses}")
    print(f"[8 train step on {card}] cornell_smoke {WIDTH}x{HEIGHT}, "
          f"{N_PARTICLES} "
          f"particles x depth {MAX_DEPTH} ({n_slots} VRL slots, {n_valid} "
          f"valid), sigma_a x2: launches vrl_sum {step_launches[0]} "
          f"vrl_sum_bwd {step_launches[1]}, loss {float(loss):.6g}, "
          + ", ".join(f"d{k} {grads[k].flatten().tolist()}" for k in PARAMS)
          + f" | vs plain-backward step max rel {grad_rel:.2e} | same-seed "
          f"FD: " + ", ".join(fd_results) + " | SGD on sigma_a (lr "
          f"{float(lr):.4g}): losses " + " ".join(f"{x:.6g}" for x in losses)
          + f", then sigma_a {sigma_a.tolist()}", flush=True)

    # 9. timing of the train step and of the backward kernel
    packs = integrator.pack_frame(scene2, vrls_step)[3]
    gbar = torch.as_tensor(np.random.default_rng(2).uniform(
        0.5, 1.5, (3, n_rays)).astype(np.float32), device=dev)
    fwd_ms = cuda_ms(lambda: vrl_sum(*packs, seed=seed), 3, 20)
    bwd_ms = cuda_ms(lambda: bwd.vrl_sum_bwd(*packs, gbar, seed=seed), 3,
                     20)
    u_step = philox_uniforms(seed, n_rays, n_slots, n_draws, device=dev)
    plain_bwd_ms = cuda_ms(
        lambda: bwd.vrl_sum_bwd_reference(*packs, gbar, u_step), 0, 1)
    with SweepCount(*pair_masks(packs[0], packs[1])) as bwd_sweep:
        vrl_sum_reference(*packs, u_step)  # the samples the backward replays
    del u_step
    # the train step's own segments (its VRLs and render seed, drawn as
    # train_step draws them) through kernel 1's checking launch
    g = gen()
    step_vrls = tracer.trace(scene2, g, N_PARTICLES, tcfg)
    _, step_check = vs.vrl_sum_check(
        *integrator.pack_frame(scene2, step_vrls)[3],
        seed=integrator.draw_seed(g))
    check(step_check["bad_tris"] == 0 and step_check["bad_segments"] == 0,
          f"the train step's segments: the pre-reject disagrees: {step_check}")
    tracer_ms = host_ms(
        lambda: tracer.trace(scene2, gen(), N_PARTICLES, tcfg), 3, 10)
    step_ms = host_ms(lambda: step(scene2), 3, 10)
    valid_evals = n_rays * n_valid * n_draws
    # kernels 1 and 8 at the step's shape (16,384 x 1,536): their bounds
    # on the timed launches' samples, the sweep (kernel 1's pre-reject,
    # which kernel 8 replays) counted by kernel 1's checking launch
    fwd_counts = vs.vrl_sum_check(*packs, seed=seed)[1]
    check(fwd_counts["bad_tris"] == 0 and fwd_counts["bad_segments"] == 0,
          f"the timed segments: the pre-reject disagrees: {fwd_counts}")
    bwd_ops = kernel_ops("vrl_sum_bwd", bwd_sweep,
                         scene2.medium.phase_kind == 0, cfg.short_vrls)
    bwd_bytes = nbytes(*packs, gbar) + 4 * (6 * n_rays + 3 * n_slots + 8)
    bwd_bound = bound(plane_ops(bwd_ops, bwd_sweep, fwd_counts), bwd_bytes)
    bwd_wald_bound = bound(bwd_ops, bwd_bytes)
    fwd_bound = bound(plane_ops(kernel_ops("vrl_sum", bwd_sweep,
                                           scene2.medium.phase_kind == 0,
                                           cfg.short_vrls),
                                bwd_sweep, fwd_counts),
                      nbytes(*packs) + 3 * n_rays * 4)
    (s_med, s_spread), (t_med, _), (f_med, _), (b_med, b_spread), \
        (pb_med, pb_spread) = map(summary, (step_ms, tracer_ms, fwd_ms, bwd_ms,
                                            plain_bwd_ms))
    print(f"[9 train timing on {card}] step {s_med:.3f} ms (median of 10, "
          f"spread {s_spread:.1%}); alone on its inputs: tracer {t_med:.3f} "
          f"ms, forward kernel {f_med:.3f} ms (bound {fwd_bound[0]:.4f} ms by "
          f"{fwd_bound[1]}), backward kernel {b_med:.3f} "
          f"ms (spread {b_spread:.1%}, {valid_evals / (b_med / 1e3):.4g} "
          f"valid pair-sample evals/s), rest {s_med - t_med - f_med - b_med:.3f}"
          f" ms | plain backward {pb_med:.3f} ms (spread {pb_spread:.1%}, "
          f"uniforms precomputed, {valid_evals / (pb_med / 1e3):.4g} evals/s)"
          f" | backward bound {bwd_bound[0]:.4f} ms by {bwd_bound[1]} "
          f"(the pre-reject's operations on the checking launch's counted "
          f"skips of the timed samples; {bwd_wald_bound[0]:.4f} ms with a "
          f"Wald test for every triangle swept; {bwd_sweep}) | the timed "
          f"segments in kernel 1's checking launch: {check_line(fwd_counts)}"
          f" | the step's segments there: {check_line(step_check)}",
          flush=True)

    # 10. where the train step's device time goes
    prof = profile_device(lambda: step(scene2), 2, 5)
    if prof is None:
        print("[10 train profile] the profiler saw no device operation: not "
              "measured", flush=True)
    else:
        span, busy, n_ops, by_name = prof
        mine = {k: sum(v for n, v in by_name.items() if k + "<" in n)
                for k in ("vrl_sum_plane_kernel", "vrl_sum_bwd_kernel")}
        top = sorted(((v, k) for k, v in by_name.items()
                      if "vrl_sum_plane_kernel" not in k
                      and "vrl_sum_bwd_kernel" not in k), reverse=True)[:4]
        print(f"[10 train profile on {card}] per traced step: device span "
              f"{span:.3f} ms, busy {busy:.3f} ms, idle share "
              f"{1 - busy / span:.1%}, {n_ops:g} device ops; "
              + ", ".join(f"{k} {v:.3f} ms ({v / busy:.1%} of busy)"
                          for k, v in mine.items()) + "; next: "
              + " | ".join(f"{v:.3f} ms {k[:60]}" for v, k in top),
              flush=True)

    walls = [("build", build_s), ("1-10", time.time() - t0 - build_s)]

    def walled(fn, *args):
        """fn(*args), its wall time kept in `walls` by name."""
        t = time.time()
        out = fn(*args)
        walls.append((fn.__name__, time.time() - t))
        return out

    c2_kernels, c2 = walled(config2, dev, card, cfg)
    c4_kernels, c4 = walled(config4, dev, card, cfg)
    c4_grad_kernel = walled(config4_grad, dev, card, cfg, c4)
    clustered_grad_kernels = walled(clustered_grad, dev, card, cfg, c2, c4)
    bvh_kernel = walled(large_mesh, dev, card, cfg, vrls)
    probe_kernels = walled(gather_probes, dev, card)
    glossy_kernels_line = walled(scene_path, dev, card, vrls)
    sky_kernels_line = walled(sky_path, dev, card)
    tri_kernels = walled(grid_options, dev, card, cfg, c4)
    c1 = presets.cornell_smoke(WIDTH, HEIGHT, device=dev)
    glossy_grid_kernels = walled(glossy_grid, dev, card, cfg, c1, c4)
    gradient_kernels = walled(gradient_forms, dev, card, cfg, c1, c2, c4)
    textured_kernels = walled(textured_path, dev, card, cfg, sass_check)
    textured_grid_kernels = walled(textured_grid, dev, card, cfg, c4)
    print(f"[walls on {card}] " + ", ".join(f"{k} {v:.1f} s" for k, v in walls)
          + f" | total {time.time() - t0:.1f} s", flush=True)

    print(json.dumps({"kernels": [{
        "name": "vrl_sum", "route": "cuda",
        "source": "alvrl_tpu_torch/csrc/vrl_sum.cu",
        "replaces": "alvrl_tpu/ops/vrl_pallas.py:726",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": k_med, "plain_ms": p_med, "bound_ms": sum_bound[0],
        "bound_by": sum_bound[1], "library_ms": None,
    }, {
        "name": "vrl_sum_bwd", "route": "cuda",
        "source": "alvrl_tpu_torch/csrc/vrl_sum_bwd.cu",
        "replaces": "alvrl_tpu/ops/vrl_pallas_bwd.py:845",
        "launches": step_launches[1], "max_abs_err": bwd_err,
        "ms": b_med, "plain_ms": pb_med, "bound_ms": bwd_bound[0],
        "bound_by": bwd_bound[1], "library_ms": None,
    }, *c2_kernels, *c4_kernels, c4_grad_kernel, *clustered_grad_kernels,
        bvh_kernel, *probe_kernels, *glossy_kernels_line,
        *sky_kernels_line, *tri_kernels, *glossy_grid_kernels,
        *gradient_kernels, *textured_kernels, *textured_grid_kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
