"""The gradient of glossy and layered surfaces in alvrl_tpu_torch against
alvrl_tpu, on the same numpy-made inputs: the box of
torch_port_utils.glossy_scene_desc (the eleven smooth kinds, each seen
from the camera), both packages built from one JSON description.

The plain material VJP behind kernel 8 (ops.vrl_sum_bwd with
`materials`) against jax.value_and_grad of JAX's XLA pair_contribution
(which evaluates bsdf_eval_smooth at the eye hit) in sigma_a, sigma_s, g,
the VRL powers and the eye transmittance (a leaf of its own on both
sides): the scalars to PAR_RTOL, the powers and the per-ray
transmittance cotangents at the homogeneous bar, the latter over each
eye-hit kind alone. Kernel 10's plain material VJP against kernel 8's on
a table of every VRL. The train step on the glossy table against the
loss JAX's train_step(use_pallas=False) computes (its tracer and
pair_contribution, composed here on the port's render uniforms) and
against same-seed finite differences; one sample of each family. About
90 s alone, most of it JAX's scene build and its two compiles.
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from alvrl_tpu.integrators.vrl import integrate as jintegrate
from alvrl_tpu.integrators.vrl import integrator as jintegrator
from alvrl_tpu.integrators.vrl import tracer as jtracer
from alvrl_tpu.integrators.vrl.integrate import VRLConfig as JVRLConfig
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.bsdf import api as bsdf
from alvrl_tpu_torch.integrators.vrl import integrator, tracer
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops import vrl_sum as vs
from alvrl_tpu_torch.ops import vrl_sum_bwd as bwd
from alvrl_tpu_torch.ops import vrl_sum_clustered_bwd as cb
from alvrl_tpu_torch.parallel.render import PARAMS, train_step
from tests.test_torch_glossy import _rays, _scenes, _vrls
from tests.torch_port_utils import jax_scene_leaves, jax_tracer_uniforms

torch.set_num_threads(1)

PAR_RTOL = 1e-4  # scalars against XLA AD (tests/test_torch_hetero_bwd_table.py)
GRAD_RTOL = 1e-3  # the train step's gradients (the BASELINE bar)
FD_TOL = 5e-3     # same-seed central differences
N_COLS = 128      # bench VRLs against the 64 eye rays
SVV = SVS = 1  # one sample of each family: half the JAX graph to compile
GLOSSY_KINDS = bsdf.MATERIAL_FORM_KINDS - bsdf.DELTA_KINDS - {bsdf.DIFFUSE}


def _t(a):
    return torch.as_tensor(np.array(a))


class _EyeTau:
    """media.api for pair_contribution with its eye-to-hit transmittance
    (the call on `hit_p`) replaced by the leaf `tau`; every other call
    goes to `api`."""

    def __init__(self, api, hit_p, tau):
        self.api, self.hit_p, self.tau = api, hit_p, tau

    def transmittance(self, med, p0, p1):
        if p1 is self.hit_p:
            return self.tau
        return self.api.transmittance(med, p0, p1)

    def __getattr__(self, name):
        return getattr(self.api, name)


@functools.lru_cache(maxsize=None)
def _jax_grad():
    """jax.value_and_grad of sum(gbar * the per-ray sums of
    pair_contribution) in ({sigma_a, sigma_s, g, power}, the eye
    transmittance (B, 1, 3)), the medium rebuilt from them in the
    trace."""
    jscene0, _ = _scenes()

    def f(params, tau, hit_f, ray_o, ray_d, u, gbar, start, end, valid):
        med = jscene0.medium.replace(sigma_a=params["sigma_a"],
                                     sigma_s=params["sigma_s"],
                                     g=params["g"])
        b, n = ray_o.shape[0], start.shape[0]
        ex = lambda a: a[:, None] if a.ndim == 1 else a[:, None, :]  # noqa
        hit = dict(zip(("p", "valid", "ng", "mat"), hit_f))
        hit_p = ex(hit['p'])
        saved = jintegrate.mapi
        jintegrate.mapi = _EyeTau(saved, hit_p, tau)
        try:
            total, _, _ = jintegrate.pair_contribution(
                jscene0.replace(medium=med), ex(ray_o), ex(ray_d), hit_p,
                ex(hit['valid']), ex(hit['ng']), ex(hit['mat']),
                start[None], end[None], params["power"][None], valid[None],
                u[..., :2 * SVV].reshape(b, n, SVV, 2), u[..., 2 * SVV:],
                JVRLConfig(vol_vol_samples=SVV, vol_surf_samples=SVS))
        finally:
            jintegrate.mapi = saved
        return jnp.sum(gbar * total.sum(axis=1).T)

    return jax.jit(jax.value_and_grad(f, argnums=(0, 1)))


@functools.lru_cache(maxsize=None)
def _material_case():
    """The port's plain material VJP and JAX's gradient on the same 64
    rays x N_COLS bench VRLs, uniforms and gbar."""
    jscene, scene = _scenes()
    jv, vrls = _vrls()
    ray_o, ray_d = _rays()
    rng = np.random.default_rng(20)
    u = rng.random((64, N_COLS, 2 * SVV + SVS), dtype=np.float32)
    gbar = rng.uniform(0.5, 1.5, (3, 64)).astype(np.float32)
    hit = jintegrator.trace_eye_rays(jscene, ray_o, ray_d)
    med = jscene.medium
    tau = jnp.exp(-(med.sigma_a + med.sigma_s) * jnp.linalg.norm(
        hit.p - ray_o, axis=-1)[:, None])[:, None, :]
    params = {"sigma_a": med.sigma_a, "sigma_s": med.sigma_s, "g": med.g,
              "power": jv.power[:N_COLS]}
    ref_loss, (ref, ref_tau) = _jax_grad()(
        params, tau, (hit.p, hit.valid, hit.ng, hit.mat), ray_o, ray_d,
        jnp.asarray(u), jnp.asarray(gbar),
        jv.start[:N_COLS], jv.end[:N_COLS], jv.valid[:N_COLS])
    sub = replace(vrls, start=vrls.start[:N_COLS], end=vrls.end[:N_COLS],
                  power=vrls.power[:N_COLS], valid=vrls.valid[:N_COLS])
    mats = integrator.material_pack(scene)
    _, packs = integrator.pack_rays_vrls(scene, _t(ray_o), _t(ray_d), sub,
                                         mats)
    rays = packs[0].clone()
    rays[pk.TAU:pk.TAU + 3] = _t(tau[:, 0]).T
    packs = (rays, *packs[1:])
    out = bwd.vrl_sum_bwd_reference(*packs, _t(gbar), _t(u),
                                    vol_vol_samples=SVV,
                                    vol_surf_samples=SVS, materials=mats)
    kind = integrator.trace_eye_rays(scene, _t(ray_o), _t(ray_d))[1]
    return dict(packs=packs, mats=mats, u=_t(u), gbar=_t(gbar), out=out,
                ref_loss=float(ref_loss), ref={k: _t(v) for k, v in
                                               ref.items()},
                ref_tau=_t(ref_tau[:, 0]), kind=scene.materials.kind[kind])


def test_plain_material_vjp_matches_xla_ad():
    """The plain material VJP (kernel 8m's plain version) against XLA AD
    of pair_contribution: d sigma_a, d sigma_s and d g to PAR_RTOL (the
    port's d_par chained to the medium's parameters); d power at the
    homogeneous bar over the VRLs; d tau at the homogeneous bar over
    each eye-hit kind's rays alone, every glossy kind among them; the
    loss to 1e-5."""
    c = _material_case()
    d_power, d_par, d_tau = c["out"]
    sums = vs.vrl_sum_reference(*c["packs"], c["u"], vol_vol_samples=SVV,
                                vol_surf_samples=SVS, materials=c["mats"])
    loss = float((sums.double() * c["gbar"].double()).sum())
    assert abs(loss - c["ref_loss"]) <= 1e-5 * abs(c["ref_loss"])
    got = {"sigma_a": d_par[0:3], "sigma_s": d_par[0:3] + d_par[3:6],
           "g": d_par[6:7]}
    for k, v in got.items():
        for o, r in zip(v.tolist(), c["ref"][k].reshape(-1).tolist()):
            assert abs(o - r) <= PAR_RTOL * abs(r), (k, o, r)
    median, share = vs.homog_bar(d_power.T, c["ref"]["power"])
    assert median < vs.HOMOG_MEDIAN and share < vs.HOMOG_SHARE, (median,
                                                                 share)
    groups = vs.homog_bar_by_kind(d_tau.T, c["ref_tau"], c["kind"])
    assert set(groups) >= GLOSSY_KINDS, sorted(groups)
    for k, (n, median, share) in groups.items():
        assert median < vs.HOMOG_MEDIAN and share < vs.HOMOG_SHARE, (
            k, n, median, share)
    assert float(c["ref_tau"].abs().sum()) > 0.0


def test_plain_clustered_material_vjp_matches_the_unclustered():
    """Kernel 10m's plain version on a table whose one row holds every
    VRL at weight 1 gives kernel 8m's cotangents (the same per-ray sums),
    and d_weights the VRLs' d_power dotted with their power."""
    c = _material_case()
    packs, n = c["packs"], c["packs"][1].shape[1]
    ids = torch.arange(n, dtype=torch.int32)[None]
    w = torch.ones((1, n))
    out = cb.vrl_sum_clustered_bwd(
        *packs, np.zeros(64, np.int32), ids, w, c["gbar"],
        uniforms=c["u"], vol_vol_samples=SVV, vol_surf_samples=SVS,
        materials=c["mats"])
    for o, r in zip(out[:3], c["out"]):
        torch.testing.assert_close(o, r, rtol=1e-5, atol=1e-6)
    d_w = (c["out"][0] * packs[1][pk.VP:pk.VP + 3]).sum(0)
    torch.testing.assert_close(out[3][0], d_w, rtol=1e-5, atol=1e-6)


W = H = 8
N_PARTICLES, DEPTH = 8, 4


def _target():
    return np.random.default_rng(0).uniform(0.0, 0.05, (H, W, 3)).astype(
        np.float32)


def _render_uniforms():
    return np.random.default_rng(21).random(
        (W * H, N_PARTICLES * DEPTH, 2 * SVV + SVS), dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _jax_step():
    """The loss of JAX's train_step(use_pallas=False) on the glossy box
    with its render on the port's render uniforms: the tracer on k_trace,
    pair_contribution over the traced VRLs, normalised by the particle
    count, zero where the eye ray misses; jax.value_and_grad in the four
    parameters."""
    jscene, _ = _scenes()
    k_trace, _ = jax.random.split(jax.random.key(11))
    ray_o, ray_d = _rays()
    target, u = jnp.asarray(_target()), jnp.asarray(_render_uniforms())

    def loss_fn(params):
        med = jscene.medium.replace(sigma_a=params["sigma_a"],
                                    sigma_s=params["sigma_s"],
                                    g=params["g"])
        em = jscene.emitters.replace(intensity=params["intensity"])
        sc = jscene.replace(medium=med, emitters=em)
        vrls = jtracer.trace(sc, k_trace, N_PARTICLES,
                             jtracer.TracerConfig(max_depth=DEPTH))
        hit = jintegrator.trace_eye_rays(sc, ray_o, ray_d)
        b, n = ray_o.shape[0], vrls.capacity
        ex = lambda a: a[:, None] if a.ndim == 1 else a[:, None, :]  # noqa
        total, _, _ = jintegrate.pair_contribution(
            sc, ex(ray_o), ex(ray_d), ex(hit.p), ex(hit.valid), ex(hit.ng),
            ex(hit.mat), vrls.start[None], vrls.end[None],
            vrls.power[None], vrls.valid[None],
            u[..., :2 * SVV].reshape(b, n, SVV, 2), u[..., 2 * SVV:],
            JVRLConfig(vol_vol_samples=SVV, vol_surf_samples=SVS))
        li = total.sum(axis=1) / jnp.maximum(vrls.particle_count, 1.0)
        li = jnp.where(hit.valid[:, None], li, 0.0)
        return jnp.mean((li.reshape(H, W, 3) - target) ** 2)

    med = jscene.medium
    params = {"sigma_a": med.sigma_a, "sigma_s": med.sigma_s, "g": med.g,
              "intensity": jscene.emitters.intensity}
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), {k: _t(v) for k, v in grads.items()}, k_trace


def _port_step(scene, u_trace, intensity=None):
    if intensity is not None:
        scene = replace(scene, emitters=replace(scene.emitters,
                                                intensity=intensity))
    return train_step(scene, torch.Generator().manual_seed(0),
                      _t(_target()), VRLConfig(vol_vol_samples=SVV,
                                               vol_surf_samples=SVS),
                      N_PARTICLES,
                      tracer.TracerConfig(max_depth=DEPTH),
                      tracer_uniforms=u_trace,
                      render_uniforms=_t(_render_uniforms()))


def test_glossy_train_step_matches_jax_xla_route():
    """train_step on the glossy table (kernels 1 and 8's material forms:
    their plain versions on the CPU) against the XLA route's loss and
    gradients on the same tracer and render uniforms: the loss to 1e-4,
    every gradient entry to GRAD_RTOL; the intensity gradient against
    same-seed central differences of the port's step to FD_TOL (the walk
    does not read the intensity, so its draws stay put)."""
    jscene, _ = _scenes()
    ref_loss, ref_grads, k_trace = _jax_step()
    u_emit, u_walk = jax_tracer_uniforms(k_trace, N_PARTICLES, DEPTH)
    u_trace = (_t(u_emit), _t(u_walk))
    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device="cpu")
    assert bsdf.has_glossy(bsdf.check_kinds(scene))
    loss, grads = _port_step(scene, u_trace)
    assert abs(float(loss) - ref_loss) <= 1e-4 * ref_loss
    for k in PARAMS:
        out, ref = grads[k].reshape(-1), ref_grads[k].reshape(-1)
        assert float(out.abs().min()) > 0.0, k
        for o, r in zip(out.tolist(), ref.tolist()):
            assert abs(o - r) <= GRAD_RTOL * abs(r), (k, o, r)
    eps = 0.1
    shift = torch.tensor([[eps, 0.0, 0.0]])
    i0 = scene.emitters.intensity
    fd = (float(_port_step(scene, u_trace, i0 + shift)[0])
          - float(_port_step(scene, u_trace, i0 - shift)[0])) / (2 * eps)
    ad = float(grads["intensity"][0, 0])
    assert fd != 0.0 and abs(ad - fd) <= FD_TOL * abs(fd), (ad, fd)
