"""Density-field recovery through the grid render's VJP.

Counterpart of scripts/recover_density.py without its CP stages: the
port reads the density grid directly (ROADMAP C9), so the voxel gradient
comes straight from autograd (ROADMAP C10):

  log-density --exp--> density --upsample2, OD tables, grid packs-->
  render_with_vrls_kernel_diff (vrl_sum_hetero forward, vrl_sum_hetero_bwd
  backward) --autograd--> d density --> Adam step on the log-density.

Four fixed views (front, two sides, top), targets averaged over
N_TARGET_PASSES renders with the true density, a relative-MSE image
loss, a Dirichlet smoothness prior, Adam on log-density with a cosine
schedule and a clip, and the VRLs retraced every RETRACE_EVERY steps
from the current estimate (gradients through tracing are detached: the
detached-sampling contract). The retrace swaps the density through
media.heterogeneous.with_density, which recomputes the Woodcock
majorant; the reference keeps the true density's (ROADMAP C11). Every
random stream comes from an explicit torch.Generator seeded as the
reference seeds its keys. With --trilinear the medium is fast_tau
False: its quadratures read the density itself trilinearly (the grid
kernels' trilinear forms, kernel 9's in the backward), with no
upsample2 in the chain.

    python -m alvrl_tpu_torch.scripts.recover_density [--steps N]
        [--res R] [--size S] [--trilinear] [--out result.json]
        [--device cuda|cpu]

prints per-step progress on stderr and one JSON line of results.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from dataclasses import dataclass, replace

import torch

from alvrl_tpu_torch.integrators.vrl import integrator, tracer, vrl
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.media import heterogeneous as gmed
from alvrl_tpu_torch.scene import presets
from alvrl_tpu_torch.scene.scene import Camera, look_at

N_VRLS = 256
N_PARTICLES = 64
MAX_DEPTH = 10
SLOTS_PER_PARTICLE = 8  # vrl.compact's grouping, as the reference passes it
RETRACE_EVERY = 8
N_TARGET_PASSES = 6
LOG_MIN, LOG_MAX = math.log(1e-3), math.log(20.0)  # the clip of theta
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def make_views(w, h, device="cuda"):
    """The four cameras: front, left, right, top."""
    poses = [([0, 0, -0.99], [0, 0, 1], [0, 1, 0]),
             ([-0.99, 0, 0.0], [1, 0, 0.0], [0, 1, 0]),
             ([0.99, 0, 0.0], [-1, 0, 0.0], [0, 1, 0]),
             ([0, 0.95, 0.2], [0, -1, 0.2], [0, 0, 1])]
    f32 = dict(dtype=torch.float32, device=device)
    return [Camera(to_world=torch.as_tensor(look_at(*pose), **f32),
                   fov_x_deg=torch.tensor(90.0, **f32), width=w, height=h)
            for pose in poses]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def trace_vrls(scene, seed):
    """The VRLs of one trace of N_PARTICLES x MAX_DEPTH, compacted to
    N_VRLS slots as the reference compacts them."""
    return vrl.compact(tracer.trace(scene, _gen(seed), N_PARTICLES,
                                    tracer.TracerConfig(max_depth=MAX_DEPTH)),
                       N_VRLS, slots_per_particle=SLOTS_PER_PARTICLE)


def dirichlet_grad(d):
    """The gradient of the sum over the axes of (d[i + 1] - d[i])^2."""
    g = torch.zeros_like(d)
    for ax in range(3):
        n = d.shape[ax]
        diff = torch.diff(d, dim=ax)
        g.narrow(ax, 0, n - 1).sub_(2.0 * diff)
        g.narrow(ax, 1, n - 1).add_(2.0 * diff)
    return g


@dataclass
class Recovery:
    """The state of a recovery: the true medium, one scene per view, the
    targets, the hyper-parameters, Adam's state on theta = log density
    and the current VRLs."""
    medium: gmed.GridMedium
    scenes: list
    targets: list
    cfg: VRLConfig
    steps: int
    lr: float
    smooth: float
    theta: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    vrls: object = None

    @property
    def density(self):
        return torch.exp(self.theta)


def setup(res=16, size=64, steps=200, lr=0.1, smooth=2e-3, device="cuda",
          fast_tau=True):
    """The true scene (presets.cornell_grid_smoke at size x size with a
    res^3 grid; fast_tau False: its trilinear read), the four views and
    their targets (each the mean of
    N_TARGET_PASSES renders, pass p of view vi with VRLs traced from
    seed 1000 + p and the render seed drawn from seed 2000 + 10 vi + p),
    and theta at the log of the true density's mean everywhere."""
    cfg = VRLConfig(vol_vol_samples=2, vol_surf_samples=2)
    base = presets.cornell_grid_smoke(width=size, height=size, grid_res=res,
                                      device=device)
    base = replace(base, medium=replace(base.medium, fast_tau=fast_tau))
    scenes = [replace(base, camera=c) for c in make_views(size, size, device)]
    targets = []
    with torch.no_grad():
        for vi, sc in enumerate(scenes):
            acc = 0.0
            for p in range(N_TARGET_PASSES):
                acc = acc + integrator.render_with_vrls_kernel(
                    sc, trace_vrls(sc, 1000 + p), _gen(2000 + 10 * vi + p), cfg)
            targets.append(acc / N_TARGET_PASSES)
    dens = base.medium.density
    theta = torch.full_like(dens, math.log(max(float(dens.mean()), 1e-3)))
    return Recovery(medium=base.medium, scenes=scenes, targets=targets,
                    cfg=cfg, steps=steps, lr=lr, smooth=smooth, theta=theta,
                    m=torch.zeros_like(theta), v=torch.zeros_like(theta))


def density_step(state: Recovery, step: int):
    """One step: retrace if it is due, the four views' losses and their
    density gradient through the grid VJP, the prior, and Adam on theta.
    Returns {"loss": the sum of the views' losses, "ms": {"trace",
    "forward", "backward", "adam"}} (host clock, each part synchronised)."""
    device = state.theta.device
    ms = dict(trace=0.0, forward=0.0, backward=0.0, adam=0.0)

    def clock(part, t0):
        _sync(device)
        ms[part] += (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    if step % RETRACE_EVERY == 0 or state.vrls is None:
        medium = gmed.with_density(state.medium, state.density)
        state.vrls = trace_vrls(replace(state.scenes[0], medium=medium), step)
    clock("trace", t0)

    dens = state.density.requires_grad_()
    medium = gmed.with_density(state.medium, dens)
    loss_total, grad = 0.0, torch.zeros_like(dens)
    for vi, (sc, target) in enumerate(zip(state.scenes, state.targets)):
        t0 = time.perf_counter()
        img = integrator.render_with_vrls_kernel_diff(
            replace(sc, medium=medium), state.vrls,
            _gen(7000 + 31 * step + vi), state.cfg)
        # relative MSE: without the normalisation the near-emitter pixels
        # dominate and deep, dim voxels get no signal
        loss = torch.mean(((img - target) / (target + 0.1)) ** 2)
        clock("forward", t0)
        t0 = time.perf_counter()
        (g,) = torch.autograd.grad(loss, dens)
        grad += g
        loss_total += float(loss.detach())
        clock("backward", t0)

    t0 = time.perf_counter()
    with torch.no_grad():
        dens = dens.detach()
        g = (grad + state.smooth * dirichlet_grad(dens)) * dens  # to theta
        state.m = ADAM_B1 * state.m + (1 - ADAM_B1) * g
        state.v = ADAM_B2 * state.v + (1 - ADAM_B2) * g * g
        mh = state.m / (1 - ADAM_B1 ** (step + 1))
        vh = state.v / (1 - ADAM_B2 ** (step + 1))
        lr = state.lr * (0.2 + 0.8 * 0.5 * (1 + math.cos(
            math.pi * step / state.steps)))
        state.theta = torch.clamp(
            state.theta - lr * mh / (torch.sqrt(vh) + ADAM_EPS),
            LOG_MIN, LOG_MAX)
    clock("adam", t0)
    return dict(loss=loss_total, ms=ms)


def rel_err(d, truth):
    return float(torch.linalg.norm(d - truth)
                 / max(float(torch.linalg.norm(truth)), 1e-12))


def corr(d, truth):
    dc, tc = d - d.mean(), truth - truth.mean()
    return float((dc * tc).sum() / max(
        float(torch.sqrt((dc ** 2).sum() * (tc ** 2).sum())), 1e-12))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--res", type=int, default=16)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--smooth", type=float, default=2e-3,
                    help="Dirichlet (squared-difference) smoothness weight")
    ap.add_argument("--trilinear", action="store_true",
                    help="a medium of fast_tau False (the trilinear read)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    print("rendering targets...", file=sys.stderr)
    t0 = time.perf_counter()
    state = setup(args.res, args.size, args.steps, args.lr, args.smooth,
                  args.device, fast_tau=not args.trilinear)
    _sync(args.device)
    print(f"targets in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    truth = state.medium.density
    hist, split = [], dict(trace=0.0, forward=0.0, backward=0.0, adam=0.0)
    init_rel = rel_err(state.density, truth)
    t_start = time.perf_counter()
    for step in range(args.steps):
        out = density_step(state, step)
        for k, v in out["ms"].items():
            split[k] += v
        if step % 10 == 0 or step == args.steps - 1:
            hist.append(dict(step=step, loss=out["loss"],
                             rel_err=rel_err(state.density, truth),
                             corr=corr(state.density, truth)))
            print(f"step {step:4d} loss {out['loss']:.3e} rel_err "
                  f"{hist[-1]['rel_err']:.4f} corr {hist[-1]['corr']:.3f}",
                  file=sys.stderr)
    wall = time.perf_counter() - t_start
    result = dict(
        steps=args.steps, res=args.res, size=args.size, views=4,
        trilinear=args.trilinear,
        n_vrls=N_VRLS, device=str(args.device), init_rel_err=init_rel,
        final_rel_err=rel_err(state.density, truth),
        final_corr=corr(state.density, truth),
        final_loss=hist[-1]["loss"] if hist else None, wall_s=wall,
        per_step_ms=1e3 * wall / max(args.steps, 1),
        split_ms={k: v / max(args.steps, 1) for k, v in split.items()},
        history=hist)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps({k: v for k, v in result.items() if k != "history"}))
    return result


if __name__ == "__main__":
    main()
