"""The VJP of the VRL x eye-ray sum, and the differentiable sum.

Replaces the homogeneous unclustered part of
alvrl_tpu/ops/vrl_pallas_bwd.py: vrl_sum_pallas_bwd (its body
`_bwd_kernel` with hetero=False, clustered=False) and the custom VJP
vrl_sum_diff. The backward replays the forward's samples (the same
Philox stream, or the same injected uniforms) and returns the
cotangents of what the sum is differentiable in:

    d_power (3, N)  the VP rows of the VRL pack;
    d_par   (8,)    sigma_t 0:3, sigma_s 3:6 and g 6 of the medium pack
                    (7 is 0: the sampling weight is a stored constant);
    d_tau   (3, B)  the TAU rows (eye-to-surface transmittance) of the
                    ray pack, through which sigma_t chains on the
                    autograd side.

Geometry is detached, as in the reference. Every cotangent is computed
as a product, never as a quotient by the value it differentiates: the
reference's divisions (gt / max(pw, 1e-30) * (pw != 0) and the like)
give 0 wherever a power, sigma_s or tau channel is 0, which is wrong for
a term linear in it (ROADMAP C7).

Beside the kernel (csrc/vrl_sum_bwd.cu):
  * `vrl_sum_bwd_reference`, the plain version: torch.autograd.grad
    through the plain forward (ops.vrl_sum._pair_sums), independent of
    the kernel's hand-derived algebra;
  * `vrl_sum_bwd`, the wrapper: the kernel for CUDA tensors (or an
    error), the plain version for CPU tensors;
  * `vrl_sum_diff`, the torch.autograd.Function around vrl_sum and
    vrl_sum_bwd.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from alvrl_tpu_torch.media import phase as ph
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops import vrl_sum as vs

N_PAR = 8  # d_par: sigma_t (3), sigma_s (3), g, sampling weight (0)


def vrl_sum_bwd_reference(rays, vrls, tris, medium, gbar, uniforms, *,
                          vol_vol_samples=2, vol_surf_samples=2,
                          short_vrls=True, phase_kind=ph.HG):
    """Plain version of the backward: the cotangents (d_power, d_par,
    d_tau) of vrl_sum_reference for the output cotangent gbar (3, B),
    with explicit uniforms (B, N, 2 * vol_vol_samples +
    vol_surf_samples). Rays go in blocks of ops.vrl_sum's
    _PLAIN_RAY_CHUNK; the leaves are the VP rows, medium[0:7] and the
    TAU rows of each block."""
    rays, vrls, tris, medium, gbar = (
        t.detach() for t in (rays, vrls, tris, medium, gbar))
    n_rays, n_vrls = rays.shape[1], vrls.shape[1]
    like = dict(dtype=rays.dtype, device=rays.device)
    d_power = torch.zeros((3, n_vrls), **like)
    d_par = torch.zeros((N_PAR,), **like)
    d_tau = torch.zeros((3, n_rays), **like)
    with torch.enable_grad():
        for b0 in range(0, n_rays, vs._PLAIN_RAY_CHUNK):
            b1 = min(n_rays, b0 + vs._PLAIN_RAY_CHUNK)
            pw = vrls[pk.VP:pk.VP + 3].clone().requires_grad_()
            par = medium[0:7].clone().requires_grad_()
            tau = rays[pk.TAU:pk.TAU + 3, b0:b1].clone().requires_grad_()
            out = vs._pair_sums(
                torch.cat([rays[:pk.TAU, b0:b1], tau,
                           rays[pk.TAU + 3:, b0:b1]]),
                torch.cat([vrls[:pk.VP], pw, vrls[pk.VP + 3:]]), tris,
                torch.cat([par, medium[7:]]), uniforms[b0:b1],
                vol_vol_samples, vol_surf_samples, short_vrls, phase_kind)
            g_pw, g_par, g_tau = torch.autograd.grad(
                (out * gbar[:, b0:b1].T).sum(), [pw, par, tau],
                allow_unused=True, materialize_grads=True)
            d_power += g_pw
            d_par[0:7] += g_par
            d_tau[:, b0:b1] = g_tau
    return d_power, d_par, d_tau


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    lib = vs._library()
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.alvrl_vrl_sum_bwd.argtypes = [p, i, p, i, p, i, p, p, u, i, i, i, i,
                                      p, p, i, p, i, p, p, p, p, p]
    lib.alvrl_vrl_sum_bwd.restype = i
    lib.alvrl_ray_block.restype = i
    return lib


def _launch(lib, rays, vrls, tris, medium, gbar, uniforms, seed, svv, svs,
            short_vrls, phase_kind):
    n_rays, n_vrls = rays.shape[1], vrls.shape[1]
    n_chunks = -(-n_vrls // lib.alvrl_vrl_chunk())
    n_ray_blocks = -(-n_rays // lib.alvrl_ray_block())

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=rays.device)

    # per-VRL-chunk d_tau, per-ray-block d_power, per-block d_par partials
    tau_part = empty(n_chunks, 3, n_rays)
    pw_part = empty(n_ray_blocks, 3, n_vrls)
    par_part = empty(n_ray_blocks * n_chunks, N_PAR)
    d_power, d_par, d_tau = empty(3, n_vrls), empty(N_PAR), empty(3, n_rays)
    err = lib.alvrl_vrl_sum_bwd(
        rays.data_ptr(), n_rays, vrls.data_ptr(), n_vrls, tris.data_ptr(),
        tris.shape[0], medium.data_ptr(),
        None if uniforms is None else uniforms.data_ptr(), seed, svv, svs,
        int(short_vrls), phase_kind, gbar.data_ptr(), tau_part.data_ptr(),
        n_chunks, pw_part.data_ptr(), n_ray_blocks, par_part.data_ptr(),
        d_power.data_ptr(), d_par.data_ptr(), d_tau.data_ptr(),
        torch.cuda.current_stream(rays.device).cuda_stream)
    if err != 0:
        raise RuntimeError("vrl_sum_bwd kernel launch failed: CUDA error "
                           f"{err} ({lib.alvrl_error_string(err).decode()})")
    return d_power, d_par, d_tau


def vrl_sum_bwd(rays, vrls, tris, medium, gbar, *, seed=0, uniforms=None,
                vol_vol_samples=2, vol_surf_samples=2, short_vrls=True,
                phase_kind=ph.HG):
    """(d_power (3, N), d_par (8,), d_tau (3, B)): the VJP of
    ops.vrl_sum.vrl_sum at the output cotangent gbar (3, B), float32 and
    contiguous like the packs, on the same samples as the forward of the
    same seed (or uniforms). CUDA tensors go through the CUDA kernel,
    CPU tensors through vrl_sum_bwd_reference."""
    svv, svs = vol_vol_samples, vol_surf_samples
    vs._check(rays, vrls, tris, medium, uniforms, seed, svv, svs, phase_kind)
    if not isinstance(gbar, torch.Tensor) or gbar.dtype != torch.float32 \
            or not gbar.is_contiguous() or gbar.device != rays.device:
        raise TypeError("gbar must be a contiguous float32 tensor on the "
                        "rays' device")
    n_rays, n_vrls = rays.shape[1], vrls.shape[1]
    if tuple(gbar.shape) != (3, n_rays):
        raise ValueError(f"gbar must be (3, {n_rays}), got "
                         f"{tuple(gbar.shape)}")
    if rays.device.type == "cpu":
        if uniforms is None:
            uniforms = vs.philox_uniforms(seed, n_rays, n_vrls, 2 * svv + svs)
        return vrl_sum_bwd_reference(
            rays, vrls, tris, medium, gbar, uniforms, vol_vol_samples=svv,
            vol_surf_samples=svs, short_vrls=short_vrls,
            phase_kind=phase_kind)
    lib = _library()
    if tris.shape[0] > lib.alvrl_max_tris():
        raise ValueError(f"{tris.shape[0]} triangles exceed the kernel's "
                         f"shared-memory cap of {lib.alvrl_max_tris()}")
    if n_rays == 0 or n_vrls == 0:
        f32 = dict(dtype=torch.float32, device=rays.device)
        return (torch.zeros((3, n_vrls), **f32), torch.zeros((N_PAR,), **f32),
                torch.zeros((3, n_rays), **f32))
    with torch.cuda.device(rays.device):
        out = _launch(lib, rays, vrls, tris, medium, gbar, uniforms, seed,
                      svv, svs, short_vrls, phase_kind)
    vrl_sum_bwd.launches += 1
    return out


vrl_sum_bwd.launches = 0  # kernel launches, for showing that a run used it


# ---------------------------------------------------------------------------
# Differentiable sum
# ---------------------------------------------------------------------------

class _VRLSumDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rays, vrls, tris, medium, uniforms, kw):
        ctx.save_for_backward(rays, vrls, tris, medium, uniforms)
        ctx.kw = kw
        return vs.vrl_sum(rays, vrls, tris, medium, uniforms=uniforms, **kw)

    @staticmethod
    def backward(ctx, gbar):
        rays, vrls, tris, medium, uniforms = ctx.saved_tensors
        d_power, d_par, d_tau = vrl_sum_bwd(
            rays, vrls, tris, medium, gbar.contiguous(), uniforms=uniforms,
            **ctx.kw)
        d_rays = torch.zeros_like(rays)
        d_rays[pk.TAU:pk.TAU + 3] = d_tau
        d_vrls = torch.zeros_like(vrls)
        d_vrls[pk.VP:pk.VP + 3] = d_power
        d_medium = torch.zeros_like(medium)
        d_medium[0:7] = d_par[0:7]
        return d_rays, d_vrls, None, d_medium, None, None


def vrl_sum_diff(rays, vrls, tris, medium, *, seed=0, uniforms=None,
                 vol_vol_samples=2, vol_surf_samples=2, short_vrls=True,
                 phase_kind=ph.HG):
    """ops.vrl_sum.vrl_sum, differentiable in the VP rows of `vrls`, the
    TAU rows of `rays` and medium[0:7] through vrl_sum_bwd (the seed-
    replay VJP); the other rows and the triangles get no gradient (the
    detached-geometry contract of the reference's vrl_sum_diff)."""
    kw = dict(seed=seed, vol_vol_samples=vol_vol_samples,
              vol_surf_samples=vol_surf_samples, short_vrls=short_vrls,
              phase_kind=phase_kind)
    return _VRLSumDiff.apply(rays, vrls, tris, medium, uniforms, kw)
