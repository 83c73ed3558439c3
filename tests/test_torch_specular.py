"""The port's specular chains and delta BSDFs against alvrl_tpu, on the
same uniforms: fresnel_dielectric and specular_bounce, the BSDF sample
of the four ported kinds in both transport modes, the tracer on a
glass-and-mirror scene, li_unclustered_spec in a homogeneous and a grid
medium (JAX's XLA chain, its uniforms rebuilt from its key tree), and
render_with_vrls_kernel_spec (the plain sum on the CPU) against
render_with_vrls_pallas_spec in Pallas interpret mode, its kernel's
_u01 pinned (in a child process, tests/torch_port_utils.py in_child).
About 120 s alone, most of it the JAX side's compiles and the
interpret-mode reference.
"""

import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from alvrl_tpu.bsdf import api as jbsdf
from alvrl_tpu.core import rng as jrng
from alvrl_tpu.integrators.vrl import integrator as jintegrator
from alvrl_tpu.integrators.vrl import specular as jspecular
from alvrl_tpu.integrators.vrl import tracer as jtracer
from alvrl_tpu.integrators.vrl import vrl as jvrl
from alvrl_tpu.integrators.vrl.integrate import VRLConfig as JVRLConfig
from alvrl_tpu.media import api as jmapi
from alvrl_tpu.ops import vrl_pallas as vp
from alvrl_tpu.scene import loader as jloader
from alvrl_tpu.sensors import perspective as jperspective
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.bsdf import api as bsdf
from alvrl_tpu_torch.integrators.vrl import integrator, specular, tracer
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.ops.vrl_sum import HOMOG_MEDIAN, HOMOG_SHARE, homog_bar
from alvrl_tpu_torch.scene import loader
from alvrl_tpu_torch.scene.scene import DIELECTRIC, MIRROR
from tests.torch_port_utils import (
    BENCH_VRLS,
    CPU,
    SEQ_UNIFORMS,
    in_child,
    jax_scene_leaves,
    jax_tracer_uniforms,
    jax_vrls_leaves,
)

torch.set_num_threads(1)

# tests/test_loader.py's scene (its sphere the dielectric), with a
# mirror quad beside the sphere and a tinted conductor on the floor
SCENE = {
    "camera": {"type": "perspective", "origin": [0, 0, -0.99],
               "target": [0, 0, 1], "fov": 90, "width": 8, "height": 8},
    "medium": {"type": "homogeneous", "sigma_s": [0.6] * 3,
               "sigma_a": [0.05] * 3, "g": 0.3},
    "materials": [
        {"name": "white", "type": "diffuse", "albedo": [0.7, 0.7, 0.7]},
        {"name": "glass", "type": "dielectric", "eta": 1.5},
        {"name": "mirror", "type": "mirror"},
        {"name": "metal", "type": "conductor", "albedo": [0.9, 0.6, 0.3]},
        {"name": "veil", "type": "null"},
    ],
    "shapes": [
        {"type": "cube", "material": "white", "flip_normals": True},
        {"type": "sphere", "material": "glass", "center": [0, 0, 0.3],
         "radius": 0.4, "n_theta": 6, "n_phi": 10},
        {"type": "rectangle", "material": "mirror", "to_world": [
            [0.35, 0, 0, 0.55], [0, 0.35, 0, -0.2], [0, 0, 0.35, 0.95],
            [0, 0, 0, 1]]},
        {"type": "rectangle", "material": "metal", "to_world": [
            [0.4, 0, 0, -0.4], [0, 0, 0.4, -0.99], [0, 0.4, 0, 0.5],
            [0, 0, 0, 1]]},
        {"type": "rectangle", "material": "veil", "to_world": [
            [0.3, 0, 0, -0.5], [0, 0.3, 0, 0.4], [0, 0, 0.3, 0.2],
            [0, 0, 0, 1]]},
    ],
    "emitters": [
        {"type": "point", "position": [0, 0.8, 0], "intensity": [5, 5, 5]},
    ],
}
GRID_MEDIUM = {"type": "grid", "sigma_t": [1.0, 1.05, 1.1],
               "albedo": [0.9, 0.85, 0.8], "g": 0.3,
               "density": (np.random.default_rng(5).random((5, 4, 6))
                           * 1.5).astype(np.float32).tolist()}
N_VRLS = 64
SPEC = dict(max_depth=3, forced_rr_depth=2, initial_throughput=20.0)
TOL = dict(atol=1e-6, rtol=1e-6)


def _t(a):
    return torch.as_tensor(np.array(a))


def _scenes(desc=SCENE):
    return jloader.build_scene(desc), loader.build_scene(desc, device=CPU)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_fresnel_matches():
    """Entering (eta 1.5, 1.33), exiting (1 / 1.5, with total internal
    reflection past the critical angle) and eta 1."""
    rng = np.random.default_rng(1)
    cos_i = rng.random(512).astype(np.float32)
    cos_i[:4] = [0.0, 1.0, 0.2, 0.8]  # grazing, normal, TIR, not TIR
    eta = np.repeat(np.float32([1.5, 1.33, 1 / 1.5, 1.0]), 128)
    eta[2:4] = np.float32(1 / 1.5)
    ref = jspecular.fresnel_dielectric(jnp.asarray(cos_i), jnp.asarray(eta))
    out = specular.fresnel_dielectric(_t(cos_i), _t(eta))
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, _t(r), **TOL)
    assert float(out[0][2]) == 1.0 and float(out[0][3]) < 1.0
    assert bool((out[0][eta < 1] == 1.0).any())


def _bounce_inputs(n, seed):
    """Random directions, winding normals, materials of SCENE (diffuse,
    dielectric, mirror, tinted conductor, null) and lobe uniforms; half
    the rays enter their surface, half leave it."""
    rng = np.random.default_rng(seed)
    ng_raw = _unit(rng, n)
    d_in = _unit(rng, n)
    flip = np.sign(np.sum(ng_raw * d_in, axis=1))[:, None]
    d_in[: n // 2] *= -flip[: n // 2]    # entering: dot(ng_raw, d_in) < 0
    d_in[n // 2:] *= flip[n // 2:]       # exiting
    mat = rng.integers(0, len(SCENE["materials"]), n)
    return ng_raw, d_in, mat, rng


def test_specular_bounce_matches():
    """Null pass-through, mirror with its tint, the dielectric's Fresnel
    lobe choice, entering and exiting (total internal reflection
    included), and diffuse (not delta): wo, weight, eta_ratio,
    is_delta."""
    jscene, scene = _scenes()
    n = 1024
    ng_raw, d_in, mat, rng = _bounce_inputs(n, 2)
    u = rng.random(n).astype(np.float32)
    ref = jspecular.specular_bounce(jscene, jnp.asarray(u), jnp.asarray(mat),
                                    jnp.asarray(d_in), jnp.asarray(ng_raw))
    out = specular.specular_bounce(scene, _t(u), _t(mat), _t(d_in),
                                   _t(ng_raw))
    for o, r in zip(out[:3], ref[:3]):
        torch.testing.assert_close(o, _t(r), **TOL)
    assert torch.equal(out[3], _t(ref[3]))
    diel = mat == 1
    assert 0.0 < float((out[2].numpy()[diel] != 1.0).mean()) < 1.0
    assert bool((out[2].numpy()[diel] > 1.0).any())   # exiting refraction
    metal = mat == 3
    np.testing.assert_array_equal(out[1].numpy()[metal],
                                  np.tile([[0.9, 0.6, 0.3]], (metal.sum(), 1))
                                  .astype(np.float32))


@pytest.mark.parametrize("mode", ["radiance", "importance"])
def test_bsdf_sample_matches(mode):
    """sample_from_uniforms for DIFFUSE, NULL, MIRROR and DIELECTRIC: wo,
    weight (the refraction's 1/eta^2 in radiance mode only), eta_ratio,
    is_delta and valid, against JAX's at the same uniforms."""
    jscene, scene = _scenes()
    n = 1024
    ng_raw, d_in, mat, rng = _bounce_inputs(n, 3)
    ng = np.where(np.sum(ng_raw * d_in, axis=1, keepdims=True) > 0,
                  -ng_raw, ng_raw)
    u = rng.random((n, bsdf.N_SAMPLE_DIMS)).astype(np.float32)
    ref = jbsdf.sample_from_uniforms(
        jscene, jnp.asarray(u), jnp.asarray(mat), jnp.asarray(ng),
        jnp.asarray(ng_raw), jnp.asarray(d_in), jnp.zeros((n, 3)), mode=mode)
    out = bsdf.sample_from_uniforms(scene, _t(u), _t(mat), _t(ng),
                                    _t(ng_raw), _t(d_in), mode=mode)
    for k in ("wo", "weight", "eta_ratio"):
        torch.testing.assert_close(getattr(out, k), _t(getattr(ref, k)),
                                   **TOL, msg=k)
    for k in ("is_delta", "valid"):
        assert torch.equal(getattr(out, k), _t(getattr(ref, k))), k
    refracted = (mat == 1) & (out.eta_ratio.numpy() != 1.0)
    assert refracted.any()
    w = out.weight.numpy()[refracted]
    if mode == "importance":
        assert (w == 1.0).all()
    else:
        assert (w != 1.0).all()


def test_bsdf_sample_refuses_a_bad_mode():
    _, scene = _scenes()
    with pytest.raises(ValueError, match="mode"):
        bsdf.sample_from_uniforms(scene, torch.zeros(1, 5), torch.zeros(
            1, dtype=torch.int64), torch.tensor([[0.0, 1.0, 0.0]]),
            torch.tensor([[0.0, 1.0, 0.0]]), torch.tensor([[0.0, -1.0, 0.0]]),
            mode="adjoint")


@pytest.mark.parametrize("short_vrls", [True, False])
def test_trace_matches_jax_on_a_glass_scene(short_vrls):
    """The tracer through the dielectric sphere, the mirror, the tinted
    conductor and the null quad on JAX's own random numbers: the VRL
    buffer (64 particles x depth 6, roulette from depth 2, so the
    particles' relative IOR enters it) at the homogeneous bar, validity
    equal, and some particle refracted into the glass."""
    jscene, scene = _scenes()
    key = jax.random.key(11)
    n, depth = 64, 6
    jcfg = jtracer.TracerConfig(max_depth=depth, rr_depth=2,
                                short_vrls=short_vrls)
    cfg = tracer.TracerConfig(max_depth=depth, rr_depth=2,
                              short_vrls=short_vrls)
    ref = jtracer.trace(jscene, key, n, jcfg)
    u_emit, u_walk = jax_tracer_uniforms(key, n, depth)
    out = tracer.trace_u(scene, _t(u_emit), _t(u_walk), cfg)
    assert torch.equal(out.valid, _t(ref.valid))
    ok = out.valid
    assert int(ok.sum()) > 100
    for k in ("start", "end"):
        torch.testing.assert_close(getattr(out, k)[ok],
                                   _t(getattr(ref, k))[ok], atol=1e-5,
                                   rtol=1e-5, msg=k)
    median, share = homog_bar(out.power[ok], _t(ref.power)[ok])
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    # some VRL starts inside the glass sphere
    inside = (out.start[ok] - torch.tensor([0.0, 0.0, 0.3])).norm(dim=1) < 0.38
    assert bool(inside.any())


def _spec_uniforms(key, b, n_vrls, jcfg, spec_cfg):
    """The uniforms alvrl_tpu's li_unclustered_spec(scene, o, d, vrls, key,
    cfg, spec_cfg) draws, in the port's layout: u_chain (max_depth, B, 2)
    (step k's key fold(key, k, P_SPECULAR); the lobe from fold(., 1), the
    roulette from fold(., 2): specular.py:120-143) and u_sums (max_depth
    + 1, B, N, 6), depth k's vrl_sum on the key fold(step key, 0), chunk
    c's uniforms from integrator._chunk_uniforms (:36-40)."""
    c = jcfg.vrl_chunk
    n_chunks = -(-n_vrls // c)
    u_chain, u_sums = [], []
    for depth in range(spec_cfg.max_depth + 1):
        k_step = jrng.fold(key, depth, jrng.P_SPECULAR)
        k_sum = jrng.fold(k_step, 0)
        chunks = []
        for ci in range(n_chunks):
            u_vv, u_vs = jintegrator._chunk_uniforms(
                k_sum, ci, (b, c, jcfg.vol_vol_samples, 2),
                (b, c, jcfg.vol_surf_samples))
            chunks.append(np.concatenate(
                [np.asarray(u_vv).reshape(b, c, -1), np.asarray(u_vs)], -1))
        u_sums.append(np.concatenate(chunks, axis=1)[:, :n_vrls])
        if depth < spec_cfg.max_depth:
            u_chain.append(np.stack([
                np.asarray(jrng.uniform(jrng.fold(k_step, 1), (b,))),
                np.asarray(jrng.uniform(jrng.fold(k_step, 2), (b,)))], -1))
    return _t(np.stack(u_chain)), _t(np.stack(u_sums))


def _bench_jvrls(n=N_VRLS):
    full = jvrl.load_ascii(BENCH_VRLS, particle_count=78.0)
    return full.replace(start=full.start[:n], end=full.end[:n],
                        power=full.power[:n], valid=full.valid[:n])


def _jitted_vrl_sum():
    """alvrl_tpu's vrl_sum under one jit (the hit's arrays passed one by
    one: its HitInfo is not a pytree)."""
    plain = jintegrator.vrl_sum

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def core(scene, o, d, p, valid, ng, mat, vrls, key, weight, cfg):
        hit = types.SimpleNamespace(p=p, valid=valid, ng=ng, mat=mat)
        return plain(scene, o, d, hit, vrls, key, cfg, weight=weight)

    def vrl_sum(scene, o, d, hit, vrls, key, cfg, weight=None):
        return core(scene, o, d, hit.p, hit.valid, hit.ng, hit.mat, vrls, key,
                    weight, cfg=cfg)
    return vrl_sum


@pytest.mark.parametrize("medium", ["homogeneous", "grid"])
def test_li_unclustered_spec_matches_jax(medium):
    """The plain chain against JAX's li_unclustered_spec (its XLA vrl_sum
    at every depth; the table path in the grid medium) on JAX's own
    uniforms: all 64 eye rays of the glass scene, 64 bench VRLs, depth 3
    with the forced roulette from depth 2, at the homogeneous bar; the
    chain runs through the glass to depth 2 at least."""
    desc = SCENE if medium == "homogeneous" else dict(SCENE,
                                                      medium=GRID_MEDIUM)
    jscene, scene = _scenes(json.loads(json.dumps(desc)))
    jscene = jmapi.prepare_scene(jscene)
    jvrls = _bench_jvrls()
    vrls = convert.vrls_from_numpy(jax_vrls_leaves(jvrls), device=CPU)
    px, py = np.meshgrid(np.arange(8), np.arange(8))
    ray_o, ray_d = jperspective.sample_ray(
        jscene.camera, jnp.asarray(px.reshape(-1)),
        jnp.asarray(py.reshape(-1)))
    jcfg = JVRLConfig(vrl_chunk=32)
    jspec = jspecular.SpecularConfig(**SPEC)
    key = jax.random.key(4)
    # each eager vrl_sum call compiles its scan anew (15 s on one core):
    # one jitted vrl_sum serves every depth, whose shapes are equal
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jintegrator, "vrl_sum", _jitted_vrl_sum())
        ref = jintegrator.li_unclustered_spec(jscene, ray_o, ray_d, jvrls,
                                              key, jcfg, jspec)
    u_chain, u_sums = _spec_uniforms(key, 64, N_VRLS, jcfg, jspec)
    depths = []
    chain = specular.li_specular_chain

    def counting(*a, **k):
        def tracing(sc, o, d):
            depths.append(o.shape[0])
            return integrator.trace_eye_rays(sc, o, d)
        return chain(a[0], a[1], a[2], a[3], tracing, *a[5:], **k)

    specular.li_specular_chain = counting
    try:
        out = integrator.li_unclustered_spec_u(
            scene, _t(ray_o), _t(ray_d), vrls, u_chain, u_sums, VRLConfig(),
            specular.SpecularConfig(**SPEC))
    finally:
        specular.li_specular_chain = chain
    assert float(_t(ref).abs().sum()) > 0.0
    median, share = homog_bar(out, _t(ref))
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    # the chains end on the walls: each depth traces fewer rays, from 64
    assert len(depths) >= 3 and depths[0] == 64
    assert all(a > b > 0 for a, b in zip(depths, depths[1:]))


def _interpret_spec_render():
    """render_with_vrls_pallas_spec in interpret mode on the 8x8 glass
    scene with 64 bench VRLs, depth 3, the Pallas kernel's _u01 returning
    the next SEQ_UNIFORMS constant at each call while traced (jit caches
    cleared around the patch), and the chain's uniforms rebuilt from its
    key: (image, _u01 calls, u_chain). Run by in_child."""
    counter = {"i": 0}

    def mock(shape):
        v = SEQ_UNIFORMS[counter["i"] % len(SEQ_UNIFORMS)]
        counter["i"] += 1
        return jnp.full(shape, v, jnp.float32)

    jscene = jloader.build_scene(SCENE)
    jspec = jspecular.SpecularConfig(**SPEC)
    key = jax.random.key(6)
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp, \
            pltpu.force_tpu_interpret_mode():
        mp.setattr(vp, "_u01", mock)
        img = np.asarray(jintegrator.render_with_vrls_pallas_spec(
            jscene, _bench_jvrls(), key, JVRLConfig(), jspec))
    jax.clear_caches()
    u_chain, _ = _spec_uniforms(key, 64, 1, JVRLConfig(vrl_chunk=1), jspec)
    return img, counter["i"], u_chain.numpy()


def test_kernel_spec_render_matches_pallas_interpret():
    """render_with_vrls_kernel_spec on the CPU (the plain sum at each
    depth, on the rays still on a chain) against
    render_with_vrls_pallas_spec in interpret mode (every ray at every
    depth), both on the kernel's per-draw constants and the chain's
    uniforms of JAX's key: the homogeneous bar."""
    ref, n_draws, u_chain = in_child(_interpret_spec_render)
    assert n_draws == len(SEQ_UNIFORMS)
    _, scene = _scenes()
    vrls = convert.vrls_from_numpy(jax_vrls_leaves(_bench_jvrls()),
                                   device=CPU)
    u = torch.tensor(SEQ_UNIFORMS).expand(SPEC["max_depth"] + 1, 64, N_VRLS,
                                          6).contiguous()
    draws = []
    saved = integrator._chain_draws

    def pinned(generator, spec_cfg, n_rays, device):
        draws.append(saved(generator, spec_cfg, n_rays, device))
        return torch.as_tensor(u_chain), draws[-1][1]

    integrator._chain_draws = pinned
    try:
        img = integrator.render_with_vrls_kernel_spec(
            scene, vrls, torch.Generator().manual_seed(0), VRLConfig(),
            specular.SpecularConfig(**SPEC), uniforms=u)
    finally:
        integrator._chain_draws = saved
    assert img.shape == (8, 8, 3) and float(img.mean()) > 0.0
    median, share = homog_bar(img, torch.as_tensor(ref))
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


def test_kernel_spec_render_draws_from_the_generator():
    """The chain's uniforms, then one kernel seed a depth, come from the
    generator: the same seed renders the same image, another seed
    another; a grid medium is refused with its ROADMAP item."""
    _, scene = _scenes()
    vrls = convert.vrls_from_numpy(jax_vrls_leaves(_bench_jvrls()),
                                   device=CPU)
    spec_cfg = specular.SpecularConfig(**SPEC)

    def render(seed):
        return integrator.render_with_vrls_kernel_spec(
            scene, vrls, torch.Generator().manual_seed(seed), VRLConfig(),
            spec_cfg)

    a, b, c = render(3), render(3), render(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    gen = torch.Generator().manual_seed(3)
    u, seeds = integrator._chain_draws(gen, spec_cfg, 64, scene.device)
    assert tuple(u.shape) == (3, 64, specular.N_CHAIN_DIMS)
    assert len(seeds) == 4 and len(set(seeds)) == 4
    _, grid = _scenes(json.loads(json.dumps(dict(SCENE,
                                                 medium=GRID_MEDIUM))))
    with pytest.raises(ValueError, match="ROADMAP A7"):
        integrator.render_with_vrls_kernel_spec(
            grid, vrls, torch.Generator().manual_seed(0))


def test_li_unclustered_spec_draws_from_the_generator():
    """li_unclustered_spec on a generator is li_unclustered_spec_u on
    the chain's uniforms and then, at each depth, the Philox stream of
    that depth's seed at the rays' indices, all drawn in that order."""
    from alvrl_tpu_torch.ops.vrl_sum import philox_draws

    _, scene = _scenes()
    vrls = convert.vrls_from_numpy(jax_vrls_leaves(_bench_jvrls()),
                                   device=CPU)
    spec_cfg = specular.SpecularConfig(**SPEC)
    _, _, ray_o, ray_d = integrator.frame_rays(scene)
    out = integrator.li_unclustered_spec(
        scene, ray_o, ray_d, vrls, torch.Generator().manual_seed(8),
        spec_cfg=spec_cfg)
    u_chain, seeds = integrator._chain_draws(
        torch.Generator().manual_seed(8), spec_cfg, 64, scene.device)
    u_sums = torch.stack([philox_draws(s, torch.arange(64)[:, None],
                                       torch.arange(N_VRLS)[None], 6)
                          for s in seeds])
    ref = integrator.li_unclustered_spec_u(scene, ray_o, ray_d, vrls,
                                           u_chain, u_sums, spec_cfg=spec_cfg)
    assert torch.equal(out, ref) and float(out.abs().sum()) > 0.0


def test_chain_checks_its_uniforms():
    _, scene = _scenes()
    o = torch.zeros(4, 3)
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(4, 3)
    with pytest.raises(ValueError, match="u must be"):
        specular.li_specular_chain(scene, o, d, None,
                                   integrator.trace_eye_rays,
                                   torch.zeros(2, 4, 2))


def test_delta_kinds_are_numbered_as_the_reference():
    from alvrl_tpu.scene import scene as jscene_mod
    assert (MIRROR, DIELECTRIC) == (jscene_mod.MIRROR, jscene_mod.DIELECTRIC)
