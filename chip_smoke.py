"""Smoke run of alvrl_tpu_torch on one CUDA card (an H100): the config-1
VRL render and the config-1 train step end to end through the
hand-written CUDA kernels (the VRL sum and its seed-replay VJP).

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds the kernels from alvrl_tpu_torch/csrc, with each
     kernel instantiation's registers and spills (ptxas);
  3. kernel vs plain at config-1 shapes (16384 eye rays of cornell_smoke
     128x128, 512 VRLs, 24 triangles), with injected uniforms and with
     the kernel's own Philox stream, for HG g=0, HG g=0.6 and Rayleigh,
     and with injected uniforms without the short-VRL division ("long");
  4. the main path: render_with_vrls_kernel on cornell_smoke 128x128
     with the 512 bench VRLs; the kernel's launch count must move, and
     the image must be finite, non-zero and match the plain render;
  5. timing of the kernel, the plain version and the whole render;
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
     backward kernels alone on its inputs) and of the backward kernel
     against its plain version;
 10. profile: device activity of traced train steps, as phase 6.
Then one JSON line of per-kernel results and, last, the device line
{"ok": true, "device": {...}}. There is no CPU fallback: without a CUDA
device the script fails.
"""

from __future__ import annotations

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

import numpy as np
import torch

from alvrl_tpu_torch.integrators.vrl import integrator, tracer, vrl
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.ops import _build
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops import vrl_sum_bwd as bwd
from alvrl_tpu_torch.ops.vrl_sum import (
    HOMOG_MEDIAN, HOMOG_SHARE, homog_bar, philox_uniforms, vrl_sum,
    vrl_sum_reference)
from alvrl_tpu_torch.parallel.render import PARAMS, train_step, with_params
from alvrl_tpu_torch.scene import presets

WIDTH = HEIGHT = 128
N_VRLS = 512
PARTICLE_COUNT = 78.0
MEDIA = {"hg_g0": (0.0, 0), "hg_g06": (0.6, 0), "rayleigh": (0.0, 1)}
N_PARTICLES, MAX_DEPTH = 128, 12  # config 1's tracer (bench.py)
TRAIN_SEED = 7
PAR_RTOL = 1e-3  # d_par, and the step's gradients: the BASELINE bar
FD_TOL = 5e-3    # same-seed central differences (tests/test_pallas_bwd.py)
ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH_VRLS = os.path.join(ROOT, "data", "bench_vrls.txt")


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


def ptxas_summary(log):
    """'name<phase,short> R regs S B spill' for each kernel instantiation
    in the compiler's report."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?(vrl_sum(?:_bwd)?_kernel)"
                      r"ILi(\d)ELb(\d)E", line)
        if "Compiling entry function" in line:
            name = f"{m[1]}<{m[2]},{m[3]}>" if m else None
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
              vol_vol_samples, vol_surf_samples, short_vrls, phase_kind):
        if uniforms is None:
            uniforms = philox_uniforms(
                seed, rays.shape[1], vrls.shape[1],
                2 * vol_vol_samples + vol_surf_samples, device=rays.device)
        return bwd.vrl_sum_bwd_reference(
            rays, vrls, tris, medium, gbar, uniforms,
            vol_vol_samples=vol_vol_samples,
            vol_surf_samples=vol_surf_samples, short_vrls=short_vrls,
            phase_kind=phase_kind)

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
    print(f"[2 build] {time.time() - t0:.1f} s | ptxas: "
          + " ; ".join(ptxas_summary(_build.build_log())), flush=True)

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
    results = []
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
            ref = vrl_sum_reference(*packs, u, short_vrls=short,
                                    phase_kind=kind)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), f"{name}/{mode} finite")
            median, share = homog_bar(out.T, ref.T)
            err = float((out - ref).abs().max())
            max_abs_err = max(max_abs_err, err)
            results.append(f"{name}/{mode} median {median:.2e} "
                           f"share>1e-2 {share:.4f} max_abs {err:.3e}")
            check(median < HOMOG_MEDIAN and share < HOMOG_SHARE,
                  f"{name}/{mode}: median {median}, share {share}")
    print(f"[3 kernel vs plain on {card}, B={n_rays} N={N_VRLS} T=24] "
          + " | ".join(results), flush=True)

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
    print(f"[4 main path on {card}] cornell_smoke {WIDTH}x{HEIGHT} x "
          f"{N_VRLS} VRLs: "
          f"vrl_sum launches {launches}, image mean {float(img.mean()):.6f} "
          f"max {float(img.max()):.6f}, vs plain render median {median:.2e} "
          f"share>1e-2 {share:.4f}", flush=True)

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
    k_med, k_spread = summary(kernel_ms)
    p_med, p_spread = summary(plain_ms)
    r_med, r_spread = summary(render_s)
    print(f"[5 timing on {card}] kernel {k_med:.3f} ms/pass (spread "
          f"{k_spread:.1%}, {pair_evals / (k_med / 1e3):.4g} pair-sample "
          f"evals/s) | plain {p_med:.3f} ms/pass (spread {p_spread:.1%}, "
          f"uniforms precomputed) | render {r_med:.3f} ms/pass (spread "
          f"{r_spread:.1%}, {pair_evals / (r_med / 1e3):.4g} evals/s)",
          flush=True)

    # 6. where the render's device time goes
    prof = profile_device(
        lambda: integrator.render_with_vrls_kernel(scene, vrls, gen, cfg),
        5, 10)
    if prof is None:
        print("[6 profile] the profiler saw no device operation: not "
              "measured", flush=True)
    else:
        span, busy, n_ops, by_name = prof
        k_ms = sum(v for k, v in by_name.items() if "vrl_sum_kernel" in k)
        top = sorted(((v, k) for k, v in by_name.items()
                      if "vrl_sum_kernel" not in k), reverse=True)[:4]
        print(f"[6 profile on {card}] per traced pass: device span "
              f"{span:.3f} ms, busy {busy:.3f} ms, idle share "
              f"{1 - busy / span:.1%}, {n_ops:g} device ops; vrl_sum_kernel "
              f"{k_ms:.3f} ms ({k_ms / busy:.1%} of busy); next: "
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
    bwd_err, results = 0.0, []
    for name, mode, packs, kind in cases:
        kw = dict(seed=seed3, uniforms=None if mode == "philox" else u_inj,
                  short_vrls=mode != "long", phase_kind=kind)
        out = bwd.vrl_sum_bwd(*packs, gbar, **kw)
        again = bwd.vrl_sum_bwd(*packs, gbar, **kw)
        u = u_philox if mode == "philox" else u_inj
        ref, ref64 = (bwd.vrl_sum_bwd_reference(
            *(x.to(dt) for x in (*packs, gbar, u)),
            short_vrls=mode != "long", phase_kind=kind)
            for dt in (torch.float32, torch.float64))
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"{name}/{mode}: a repeat launch is not bit-identical")
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
          "T=24, "
          "repeats bit-identical] " + " | ".join(results), flush=True)
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
        lambda: bwd.vrl_sum_bwd_reference(*packs, gbar, u_step), 1, 3)
    del u_step
    tracer_ms = host_ms(
        lambda: tracer.trace(scene2, gen(), N_PARTICLES, tcfg), 3, 10)
    step_ms = host_ms(lambda: step(scene2), 3, 10)
    valid_evals = n_rays * n_valid * n_draws
    (s_med, s_spread), (t_med, _), (f_med, _), (b_med, b_spread), \
        (pb_med, pb_spread) = map(summary, (step_ms, tracer_ms, fwd_ms, bwd_ms,
                                            plain_bwd_ms))
    print(f"[9 train timing on {card}] step {s_med:.3f} ms (median of 10, "
          f"spread {s_spread:.1%}); alone on its inputs: tracer {t_med:.3f} "
          f"ms, forward kernel {f_med:.3f} ms, backward kernel {b_med:.3f} "
          f"ms (spread {b_spread:.1%}, {valid_evals / (b_med / 1e3):.4g} "
          f"valid pair-sample evals/s), rest {s_med - t_med - f_med - b_med:.3f}"
          f" ms | plain backward {pb_med:.3f} ms (spread {pb_spread:.1%}, "
          f"uniforms precomputed, {valid_evals / (pb_med / 1e3):.4g} evals/s)",
          flush=True)

    # 10. where the train step's device time goes
    prof = profile_device(lambda: step(scene2), 2, 5)
    if prof is None:
        print("[10 train profile] the profiler saw no device operation: not "
              "measured", flush=True)
    else:
        span, busy, n_ops, by_name = prof
        mine = {k: sum(v for n, v in by_name.items() if k + "<" in n)
                for k in ("vrl_sum_kernel", "vrl_sum_bwd_kernel")}
        top = sorted(((v, k) for k, v in by_name.items()
                      if "vrl_sum_kernel" not in k
                      and "vrl_sum_bwd_kernel" not in k), reverse=True)[:4]
        print(f"[10 train profile on {card}] per traced step: device span "
              f"{span:.3f} ms, busy {busy:.3f} ms, idle share "
              f"{1 - busy / span:.1%}, {n_ops:g} device ops; "
              + ", ".join(f"{k} {v:.3f} ms ({v / busy:.1%} of busy)"
                          for k, v in mine.items()) + "; next: "
              + " | ".join(f"{v:.3f} ms {k[:60]}" for v, k in top),
              flush=True)

    print(json.dumps({"kernels": [{
        "name": "vrl_sum", "route": "cuda",
        "source": "alvrl_tpu_torch/csrc/vrl_sum.cu",
        "replaces": "alvrl_tpu/ops/vrl_pallas.py:726",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": k_med, "plain_ms": p_med,
    }, {
        "name": "vrl_sum_bwd", "route": "cuda",
        "source": "alvrl_tpu_torch/csrc/vrl_sum_bwd.cu",
        "replaces": "alvrl_tpu/ops/vrl_pallas_bwd.py:845",
        "launches": step_launches[1], "max_abs_err": bwd_err,
        "ms": b_med, "plain_ms": pb_med,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
