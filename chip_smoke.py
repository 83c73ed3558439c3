"""Smoke run of alvrl_tpu_torch on one CUDA card (an H100): the config-1
VRL render end to end through the hand-written CUDA kernel.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds the kernels from alvrl_tpu_torch/csrc;
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
     pass, the kernel's share and the largest other operations.
Then one JSON line of per-kernel results and, last, the device line
{"ok": true, "device": {...}}. There is no CPU fallback: without a CUDA
device the script fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch

WIDTH = HEIGHT = 128
N_VRLS = 512
PARTICLE_COUNT = 78.0
MEDIA = {"hg_g0": (0.0, 0), "hg_g06": (0.6, 0), "rayleigh": (0.0, 1)}
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


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs on the card only")
    from alvrl_tpu_torch.integrators.vrl import integrator, vrl
    from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
    from alvrl_tpu_torch.ops import _build
    from alvrl_tpu_torch.ops.vrl_sum import (
        HOMOG_MEDIAN, HOMOG_SHARE, homog_bar, philox_uniforms, vrl_sum,
        vrl_sum_reference)
    from alvrl_tpu_torch.scene import presets

    torch.backends.cuda.matmul.allow_tf32 = False  # the camera's matmul
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[1 device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | devices {torch.cuda.device_count()}",
          flush=True)

    t0 = time.time()
    _build.load_library()
    regs = [ln.strip() for ln in _build.build_log().splitlines()
            if "registers" in ln]
    print(f"[2 build] {time.time() - t0:.1f} s | ptxas: {' ; '.join(regs)}",
          flush=True)

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
    for name, (g, kind) in MEDIA.items():
        scene = presets.cornell_smoke(WIDTH, HEIGHT, g=g, device=dev)
        scene = replace(scene, medium=replace(scene.medium, phase_kind=kind))
        packs = integrator.pack_frame(scene, vrls)[3]
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
    print(f"[3 kernel vs plain, B={n_rays} N={N_VRLS} T=24] "
          + " | ".join(results), flush=True)
    del u_inj, u_philox

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
    print(f"[4 main path] cornell_smoke {WIDTH}x{HEIGHT} x {N_VRLS} VRLs: "
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

    print(json.dumps({"kernels": [{
        "name": "vrl_sum", "route": "cuda",
        "source": "alvrl_tpu_torch/csrc/vrl_sum.cu",
        "replaces": "alvrl_tpu/ops/vrl_pallas.py:726",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": k_med, "plain_ms": p_med,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
