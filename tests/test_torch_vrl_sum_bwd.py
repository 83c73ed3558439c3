"""alvrl_tpu_torch.ops.vrl_sum_bwd against alvrl_tpu.

The port's vrl_sum_diff, whose backward on CPU tensors is the plain
version (autograd through the plain forward), is held against the JAX
vrl_sum_diff through jax.vjp, its Pallas kernels run in interpret mode
with `_u01` patched in both kernel modules to the SEQ_UNIFORMS cycle:
the port is fed the same constants, so both replay the same samples.
Then same-seed finite differences of the port's plain forward, and the
reference's zero-channel fault (ROADMAP C7). The CUDA kernel itself
runs only on a card: tests/test_torch_cuda.py.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from alvrl_tpu.integrators.vrl import integrator as jintegrator
from alvrl_tpu.integrators.vrl import vrl as jvrl
from alvrl_tpu.ops import pack as jpk
from alvrl_tpu.ops import vrl_pallas as vp
from alvrl_tpu.ops import vrl_pallas_bwd as vpb
from alvrl_tpu.scene import presets as jpresets
from alvrl_tpu.sensors import perspective as jperspective
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.integrators.vrl import integrator, vrl
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops.vrl_sum import (
    HOMOG_MEDIAN,
    HOMOG_SHARE,
    homog_bar,
    philox_uniforms,
    vrl_sum_reference,
)
from alvrl_tpu_torch.ops.vrl_sum_bwd import (
    vrl_sum_bwd,
    vrl_sum_bwd_reference,
    vrl_sum_diff,
)
from alvrl_tpu_torch.scene import presets
from tests.torch_port_utils import (
    BENCH_VRLS,
    SEQ_UNIFORMS,
    hit_from_jax,
    in_child,
    jax_scene_leaves,
    jax_vrls_leaves,
)

torch.set_num_threads(1)

W, H = 8, 8        # 64 eye rays (the Pallas side pads them to 128)
N_VRLS = 96        # bench VRLs, 3 VRL chunks of the kernel's 32
PAR_RTOL = 1e-4    # d sigma_t, d sigma_s, d g: sums of the same terms
FD_TOL = 5e-3      # same-seed central differences (tests/test_pallas_bwd.py)
# (g, phase kind, short VRLs)
CASES = {"hg_short": (0.4, 0, True), "hg_long": (0.4, 0, False),
         "rayleigh_short": (0.0, 1, True), "rayleigh_long": (0.0, 1, False)}


def _jax_setup(g, kind, sigma_s=(0.8, 0.8, 0.8), power_scale=(1, 1, 1)):
    jscene = jpresets.cornell_smoke(width=W, height=H, sigma_s=sigma_s)
    jscene = jscene.replace(medium=jscene.medium.replace(
        g=jnp.float32(g), phase_kind=kind))
    px, py = np.meshgrid(np.arange(W), np.arange(H))
    ray_o, ray_d = jperspective.sample_ray(
        jscene.camera, jnp.asarray(px.reshape(-1)), jnp.asarray(py.reshape(-1)))
    jhit = jintegrator.trace_eye_rays(jscene, ray_o, ray_d)
    full = jvrl.load_ascii(BENCH_VRLS, particle_count=78.0)
    valid = np.ones(N_VRLS, bool)
    valid[5::13] = False
    jvrls = full.replace(
        start=full.start[:N_VRLS], end=full.end[:N_VRLS],
        power=full.power[:N_VRLS] * jnp.asarray(power_scale, jnp.float32),
        valid=jnp.asarray(valid))
    return jscene, ray_o, ray_d, jhit, jvrls


def _port_packs(jscene, ray_o, ray_d, jhit, jvrls):
    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device="cpu")
    mat = torch.as_tensor(np.asarray(jhit.mat), dtype=torch.int64)
    rays = pk.pack_rays(scene, torch.as_tensor(np.asarray(ray_o)),
                        torch.as_tensor(np.asarray(ray_d)), hit_from_jax(jhit),
                        mat)
    vrls = convert.vrls_from_numpy(jax_vrls_leaves(jvrls), device="cpu")
    return rays, pk.pack_vrls(vrls), pk.pack_tris(scene), pk.pack_medium(scene)


def _jax_vjp(jscene, ray_o, ray_d, jhit, jvrls, gbar, short, kind):
    """(out (3, B), d_tau (3, B), d_power (3, N), d_par (7,)) of the JAX
    vrl_sum_diff in interpret mode, cut to the unpadded rays and VRLs."""
    ray_pack = jpk.pack_rays(jscene, ray_o, ray_d, jhit)
    vrl_pack = jpk.pack_vrls(jvrls)
    tri_flat, med_pack = jpk.pack_tris(jscene), jpk.pack_medium(jscene)
    seed = jnp.asarray([7], jnp.int32)
    b = gbar.shape[1]
    gbar_pad = np.zeros((3, ray_pack.shape[0]), np.float32)
    gbar_pad[:, :b] = gbar

    def f(rp, vpk, mp):
        return vpb.vrl_sum_diff(rp, vpk, mp, tri_flat, seed, 2, 2, short,
                                kind)

    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(f, ray_pack, vrl_pack, med_pack)
        d_ray, d_vrl, d_med = vjp(jnp.asarray(gbar_pad))
    t = lambda a: torch.as_tensor(np.array(a))
    return (t(out)[:, :b], t(d_ray)[:b, vp._TAU:vp._TAU + 3].T,
            t(d_vrl)[vp._VP:vp._VP + 3, :N_VRLS], t(d_med)[0, 0:7])


def _interpret_vjp(setup_args, setup_kw, gbar, short, kind):
    """_jax_vjp on _jax_setup(*setup_args, **setup_kw), both Pallas kernel
    modules drawing the next SEQ_UNIFORMS constant at each _u01 call
    while traced (vrl_pallas_bwd imports _u01 by name; jit caches
    cleared around the patch), and the number of those calls. Run by
    in_child."""
    counter = {"i": 0}

    def mock(shape):
        v = SEQ_UNIFORMS[counter["i"] % len(SEQ_UNIFORMS)]
        counter["i"] += 1
        return jnp.full(shape, v, jnp.float32)

    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vp, "_u01", mock)
        mp.setattr(vpb, "_u01", mock)
        out = _jax_vjp(*_jax_setup(*setup_args, **setup_kw), gbar, short,
                       kind)
    jax.clear_caches()
    return out, counter["i"]


def _port_vjp(packs, gbar, short, kind):
    rays, vrls, tris, med = (p.clone().requires_grad_() if i != 2 else p
                             for i, p in enumerate(packs))
    u = torch.tensor(SEQ_UNIFORMS).expand(
        rays.shape[1], vrls.shape[1], 6).contiguous()
    out = vrl_sum_diff(rays, vrls, tris, med, uniforms=u, short_vrls=short,
                       phase_kind=kind)
    d_rays, d_vrls, d_med = torch.autograd.grad(
        (out * torch.as_tensor(gbar)).sum(), [rays, vrls, med])
    return out.detach(), d_rays, d_vrls, d_med


def _assert_bar(out, ref):
    median, share = homog_bar(out, ref)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


@pytest.mark.parametrize("case", sorted(CASES))
def test_vjp_matches_jax(case):
    """d_tau, d_power per entry at the homogeneous bar; d sigma_t,
    d sigma_s and d g to PAR_RTOL; the other rows of the packs get no
    gradient, and Rayleigh's d g is exactly 0. The JAX VJP runs in a
    child process (tests/torch_port_utils.py in_child)."""
    g, kind, short = CASES[case]
    setup = _jax_setup(g, kind)
    gbar = np.random.default_rng(1).uniform(
        -1.0, 1.0, (3, W * H)).astype(np.float32)
    (ref_out, ref_tau, ref_pw, ref_par), n_draws = in_child(
        _interpret_vjp, (g, kind), {}, gbar, short, kind)
    assert n_draws == 2 * len(SEQ_UNIFORMS)

    out, d_rays, d_vrls, d_med = _port_vjp(_port_packs(*setup), gbar, short,
                                           kind)
    _assert_bar(out.T, ref_out.T)
    _assert_bar(d_rays[pk.TAU:pk.TAU + 3].T, ref_tau.T)
    _assert_bar(d_vrls[pk.VP:pk.VP + 3].T, ref_pw.T)
    assert float(d_rays[pk.TAU:pk.TAU + 3].abs().sum()) > 0.0
    torch.testing.assert_close(d_med[0:7], ref_par, rtol=PAR_RTOL, atol=0.0)
    keep = torch.zeros_like(d_rays, dtype=torch.bool)
    keep[pk.TAU:pk.TAU + 3] = True
    assert float(d_rays[~keep].abs().sum()) == 0.0
    keep = torch.zeros_like(d_vrls, dtype=torch.bool)
    keep[pk.VP:pk.VP + 3] = True
    assert float(d_vrls[~keep].abs().sum()) == 0.0
    assert float(d_med[7]) == 0.0
    if kind == 1:
        assert float(d_med[6]) == 0.0


def _fd_loss(scene, vrls, gbar, params):
    """The packs at the given parameters (sigma_a, sigma_s, g, pscale: a
    factor on the VRL powers) and the loss sum(gbar * sums), float64."""
    sc = replace(scene, medium=replace(
        scene.medium, sigma_a=params["sigma_a"], sigma_s=params["sigma_s"],
        g=params["g"]))
    vr = replace(vrls, power=vrls.power * params["pscale"])
    packs = integrator.pack_frame(sc, vr)[3]
    return packs, (lambda out: (out.double() * gbar).sum())


@pytest.mark.parametrize("kind", [0, 1], ids=["hg", "rayleigh"])
def test_port_vjp_matches_same_seed_fd(kind):
    """Autograd through vrl_sum_diff (pack gradients chained to sigma_a,
    sigma_s, g and a power scale) against central differences of the
    plain forward on the same Philox stream."""
    scene = presets.cornell_smoke(width=W, height=H, g=0.4, device="cpu")
    scene = replace(scene, medium=replace(scene.medium, phase_kind=kind))
    vrls = vrl.compact(vrl.load_ascii(BENCH_VRLS, particle_count=78.0,
                                      device="cpu"))
    vrls = replace(vrls, start=vrls.start[:N_VRLS], end=vrls.end[:N_VRLS],
                   power=vrls.power[:N_VRLS], valid=vrls.valid[:N_VRLS])
    gbar = torch.as_tensor(np.random.default_rng(2).uniform(
        0.5, 1.5, (3, W * H)).astype(np.float32))
    seed = 31
    u = philox_uniforms(seed, W * H, N_VRLS, 6)
    p0 = {"sigma_a": scene.medium.sigma_a, "sigma_s": scene.medium.sigma_s,
          "g": scene.medium.g, "pscale": torch.tensor(1.0)}
    p = {k: v.clone().requires_grad_() for k, v in p0.items()}
    packs, loss = _fd_loss(scene, vrls, gbar, p)
    g_ad = torch.autograd.grad(
        loss(vrl_sum_diff(*packs, seed=seed, phase_kind=kind)),
        list(p.values()), allow_unused=True, materialize_grads=True)
    g_ad = dict(zip(p, g_ad))

    def at(name, idx, s):
        q = {k: v.clone() for k, v in p0.items()}
        if idx is None:
            q[name] = q[name] + s
        else:
            q[name][idx] += s
        packs, loss = _fd_loss(scene, vrls, gbar, q)
        return float(loss(vrl_sum_reference(*packs, u, phase_kind=kind)))

    eps = 2e-3
    for name, idx in [("sigma_a", 0), ("sigma_s", 1), ("g", None),
                      ("pscale", None)]:
        fd = (at(name, idx, eps) - at(name, idx, -eps)) / (2 * eps)
        ad = float(g_ad[name] if idx is None else g_ad[name][idx])
        if kind == 1 and name == "g":
            assert ad == 0.0 and abs(fd) < 1e-9
            continue
        assert abs(ad - fd) <= FD_TOL * abs(fd), (name, idx, ad, fd)


def test_zero_channels_have_gradients():
    """ROADMAP C7: with VRL power channel 1 and sigma_s channel 2 at 0
    (as a light of intensity (8, 0, 8) in a medium that does not scatter
    blue gives), the reference's quotient cotangents return 0 for d
    power[1] and d sigma_s[2]. Both terms are linear in these values, so
    the derivative is not 0: the port's matches central differences of
    its plain forward."""
    setup_kw = dict(sigma_s=(0.8, 0.8, 0.0), power_scale=(1.0, 0.0, 1.0))
    setup = _jax_setup(0.4, 0, **setup_kw)
    gbar = np.random.default_rng(3).uniform(
        0.5, 1.5, (3, W * H)).astype(np.float32)
    (_, _, ref_pw, ref_par), _ = in_child(_interpret_vjp, (0.4, 0), setup_kw,
                                          gbar, True, 0)
    assert float(ref_pw[1].abs().max()) == 0.0
    assert float(ref_par[5]) == 0.0

    packs = _port_packs(*setup)
    _, _, d_vrls, d_med = _port_vjp(packs, gbar, True, 0)
    u = torch.tensor(SEQ_UNIFORMS).expand(W * H, N_VRLS, 6).contiguous()
    gb = torch.as_tensor(gbar).double()

    def loss(rays, vrls, tris, med):
        return float((vrl_sum_reference(rays, vrls, tris, med, u).double()
                      * gb).sum())

    n = int(d_vrls[pk.VP + 1].abs().argmax())
    for row, col, pack_i, eps in [(pk.VP + 1, n, 1, 1e-2), (5, None, 3, 1e-3)]:
        def shifted(s):
            ps = [p.clone() for p in packs]
            if col is None:
                ps[pack_i][row] += s
            else:
                ps[pack_i][row, col] += s
            return loss(*ps)
        fd = (shifted(eps) - shifted(-eps)) / (2 * eps)
        ad = float(d_vrls[row, col] if pack_i == 1 else d_med[row])
        assert fd != 0.0
        assert abs(ad - fd) <= FD_TOL * abs(fd), (row, col, ad, fd)


def test_wrapper_cpu_takes_the_plain_version():
    """On CPU tensors vrl_sum_bwd runs the plain version on the Philox
    stream of its seed, and counts no kernel launch."""
    scene = presets.cornell_smoke(width=4, height=4, device="cpu")
    vrls = vrl.compact(vrl.load_ascii(BENCH_VRLS, particle_count=78.0,
                                      device="cpu"))
    packs = integrator.pack_frame(scene, vrls)[3]
    gbar = torch.ones((3, 16))
    before = vrl_sum_bwd.launches
    out = vrl_sum_bwd(*packs, gbar, seed=99)
    assert vrl_sum_bwd.launches == before
    ref = vrl_sum_bwd_reference(*packs, gbar,
                                philox_uniforms(99, 16, vrls.capacity, 6))
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    assert out[0].shape == (3, vrls.capacity) and out[1].shape == (8,)
    assert out[2].shape == (3, 16)


@pytest.mark.parametrize("gbar", [torch.ones((3, 15)), torch.ones((2, 16)),
                                  torch.ones((3, 16), dtype=torch.float64),
                                  torch.ones((16, 3)).T],
                         ids=["rays", "channels", "float64", "strided"])
def test_wrapper_rejects_bad_gbar(gbar):
    scene = presets.cornell_smoke(width=4, height=4, device="cpu")
    vrls = vrl.compact(vrl.load_ascii(BENCH_VRLS, particle_count=78.0,
                                      device="cpu"))
    packs = integrator.pack_frame(scene, vrls)[3]
    with pytest.raises((TypeError, ValueError)):
        vrl_sum_bwd(*packs, gbar)
