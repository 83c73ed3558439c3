"""Glossy and layered surfaces through the port's render path against
alvrl_tpu, on the same uniforms: a box whose walls, blocks, spheres and
a mask quad carry the eleven smooth kinds (tests/test_torch_bsdf.py's
materials), both packages built from one JSON description by their
loaders. The tracer (trace_u on JAX's own draws); the plain versions of
kernels 1, 2 and 5 behind the port's entry points against JAX's XLA
route (its jitted vrl_sum on its own key for kernel 1,
integrate.pair_contribution summed over the VRLs or a table for R and
the clustered render), at the homogeneous bar over the frame and over
each eye-hit kind's pixels alone, 8x8 rays, the 508 bench VRLs; each
backward route taking such a table (against same-seed central
differences);
and a diffuse or glass scene taking the diffuse instantiation, traced
and rendered as before bit for bit. About 150 s alone, most of it the
JAX tracer's and vrl_sum's compiles and runs.
"""

import functools
import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvrl_tpu.integrators.vrl import integrate as jintegrate
from alvrl_tpu.integrators.vrl import integrator as jintegrator
from alvrl_tpu.integrators.vrl import specular as jspecular
from alvrl_tpu.integrators.vrl import tracer as jtracer
from alvrl_tpu.integrators.vrl import vrl as jvrl
from alvrl_tpu.integrators.vrl.integrate import VRLConfig as JVRLConfig
from alvrl_tpu.scene import loader as jloader
from alvrl_tpu.sensors import perspective as jperspective
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.bsdf import api as bsdf
from alvrl_tpu_torch.core import math as m
from alvrl_tpu_torch.core import warp
from alvrl_tpu_torch.integrators.vrl import integrator, specular, tracer
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops import vrl_sum as vs
from alvrl_tpu_torch.parallel.render import train_step
from alvrl_tpu_torch.scene import loader, presets
from tests.torch_port_utils import (
    BENCH_VRLS,
    CPU,
    SMOOTH_MATERIALS,
    glossy_scene_desc,
    jax_tracer_uniforms,
    jax_vrls_leaves,
)

torch.set_num_threads(1)


GLOSSY_SCENE = glossy_scene_desc()
# every bench VRL: with the first 64 only, the rough coat's two pixels take
# no coat term, and a wrong coat would pass
N_VRLS = 508
HOMOG = dict(median=vs.HOMOG_MEDIAN, share=vs.HOMOG_SHARE)


def _t(a):
    return torch.as_tensor(np.array(a))


@functools.lru_cache(maxsize=None)
def _scenes():
    desc = json.loads(json.dumps(GLOSSY_SCENE))
    return jloader.build_scene(desc), loader.build_scene(desc, device=CPU)


@functools.lru_cache(maxsize=None)
def _vrls():
    full = jvrl.load_ascii(BENCH_VRLS, particle_count=78.0)
    jv = full.replace(start=full.start[:N_VRLS], end=full.end[:N_VRLS],
                      power=full.power[:N_VRLS], valid=full.valid[:N_VRLS])
    return jv, convert.vrls_from_numpy(jax_vrls_leaves(jv), device=CPU)


def _rays():
    jscene, _ = _scenes()
    px, py = np.meshgrid(np.arange(8), np.arange(8))
    return jperspective.sample_ray(jscene.camera, jnp.asarray(px.reshape(-1)),
                                   jnp.asarray(py.reshape(-1)))


def _bar(out, ref, kind=None, channels=3):
    """The homogeneous bar over all items and, with `kind` (an eye-hit
    kind per item), over each kind's items alone: every smooth kind seen
    from the camera is held by itself, so that a wrong branch of one kind
    cannot pass among the other kinds' rays."""
    out, ref = out.reshape(-1, channels), ref.reshape(-1, channels)
    median, share = vs.homog_bar(out, ref, channels)
    assert median < HOMOG["median"] and share < HOMOG["share"], (median,
                                                                 share)
    if kind is not None:
        groups = vs.homog_bar_by_kind(out, ref, kind, channels)
        assert set(groups) >= bsdf.MATERIAL_FORM_KINDS - bsdf.DELTA_KINDS - {
            bsdf.DIFFUSE}, sorted(groups)
        for k, (n, median, share) in groups.items():
            assert (median < HOMOG["median"] and share < HOMOG["share"]), (
                k, n, median, share)


def _eye_kinds(scene, ray_o, ray_d):
    """The material kind at each eye ray's closest hit."""
    _, mat = integrator.trace_eye_rays(scene, ray_o, ray_d)
    return scene.materials.kind[mat]


def test_glossy_scene_holds_every_kind():
    jscene, scene = _scenes()
    kinds = bsdf.check_kinds(scene)
    assert kinds == bsdf.MATERIAL_FORM_KINDS - bsdf.DELTA_KINDS | {3}
    assert bsdf.has_glossy(kinds)
    # every surface kind is seen from the camera or the light
    seen = set(scene.materials.kind[scene.material].tolist())
    assert seen >= {4, 5, 6, 7, 8, 9, 10, 12, 16, 17}


@pytest.mark.parametrize("short_vrls", [True, False])
def test_trace_matches_jax_on_the_glossy_scene(short_vrls):
    """The tracer through all eleven kinds on JAX's own random numbers: 64
    particles x depth 6, roulette from depth 2; the VRL buffer at the
    homogeneous bar, validity equal."""
    jscene, scene = _scenes()
    key = jax.random.key(16)
    n, depth = 64, 6
    ref = jtracer.trace(jscene, key, n, jtracer.TracerConfig(
        max_depth=depth, rr_depth=2, short_vrls=short_vrls))
    u_emit, u_walk = jax_tracer_uniforms(key, n, depth)
    out = tracer.trace_u(scene, _t(u_emit), _t(u_walk), tracer.TracerConfig(
        max_depth=depth, rr_depth=2, short_vrls=short_vrls))
    assert torch.equal(out.valid, _t(ref.valid))
    ok = out.valid
    assert int(ok.sum()) > 100
    for k in ("start", "end"):
        torch.testing.assert_close(getattr(out, k)[ok],
                                   _t(getattr(ref, k))[ok], atol=1e-5,
                                   rtol=1e-5, msg=k)
    median, share = vs.homog_bar(out.power[ok], _t(ref.power)[ok])
    assert median < vs.HOMOG_MEDIAN and share < vs.HOMOG_SHARE, (median,
                                                                 share)


def _jax_uniforms(key, b, n, jcfg):
    """JAX vrl_sum's uniforms on `key` (integrator._chunk_uniforms, chunk
    by chunk) in the port's (B, N, 6) layout."""
    c = jcfg.vrl_chunk
    chunks = []
    for ci in range(-(-n // c)):
        u_vv, u_vs = jintegrator._chunk_uniforms(
            key, ci, (b, c, jcfg.vol_vol_samples, 2),
            (b, c, jcfg.vol_surf_samples))
        chunks.append(np.concatenate(
            [np.asarray(u_vv).reshape(b, c, -1), np.asarray(u_vs)], -1))
    return _t(np.concatenate(chunks, axis=1)[:, :n])


def test_kernel1_route_matches_jax_xla():
    """render_with_vrls_kernel (kernel 1's material instantiation: its
    plain version on the CPU) against JAX's jitted li_unclustered (the
    XLA vrl_sum, whose pair_contribution evaluates every smooth kind at
    the eye hit) on JAX's uniforms: the homogeneous bar over the frame
    and over each kind's pixels alone; the glossy surfaces' vol-surf
    term is there."""
    jscene, scene = _scenes()
    jv, vrls = _vrls()
    ray_o, ray_d = _rays()
    jcfg = JVRLConfig(vrl_chunk=32)
    key = jax.random.key(3)
    ref = jax.jit(jintegrator.li_unclustered, static_argnames=("cfg",))(
        jscene, ray_o, ray_d, jv, key, cfg=jcfg)
    u = _jax_uniforms(key, 64, N_VRLS, jcfg)
    launches = []
    saved = integrator.vrl_sum

    def recording(*a, **kw):
        launches.append((a[0].shape[0], "materials" in kw))
        return saved(*a, **kw)

    integrator.vrl_sum = recording
    try:
        img = integrator.render_with_vrls_kernel(
            scene, vrls, torch.Generator().manual_seed(0), VRLConfig(),
            uniforms=u)
    finally:
        integrator.vrl_sum = saved
    assert launches == [(pk.MAT_RAY_ROWS, True)]
    _bar(img, _t(ref), _eye_kinds(scene, _t(ray_o), _t(ray_d)))
    # without the eye-side BSDF term (the diffuse pack's albedo 0 at the
    # glossy hits) the image is darker
    px, py, hit, packs = integrator.pack_frame(scene, vrls)
    diffuse = integrator.develop_sums(scene, vrls, px, py, hit,
                                      vs.vrl_sum_reference(*packs, u))
    assert float(img.sum()) > 1.05 * float(diffuse.sum())


_jit_pair_contribution = jax.jit(jintegrate.pair_contribution,
                                 static_argnames=("cfg",))


def _pair_reference(uniforms_seed, table):
    """JAX's pair_contribution (jitted once) of the 64 eye rays against
    N_VRLS columns: (the uniforms (64, N_VRLS, 6), the VRL ids, the
    weights (64, N_VRLS), total (64, N_VRLS, 3), lum_mean, lum_var), the
    columns a seeded table (`table`) or every VRL."""
    n_cols = N_VRLS
    jscene, _ = _scenes()
    jv, _ = _vrls()
    ray_o, ray_d = _rays()
    rng = np.random.default_rng(uniforms_seed)
    u = rng.random((64, n_cols, 6)).astype(np.float32)
    if not table:
        ids = np.broadcast_to(np.arange(N_VRLS), (64, N_VRLS))
        w = np.ones((64, n_cols), np.float32)
    else:
        ids = rng.integers(-1, N_VRLS, (64, n_cols))
        w = rng.uniform(0.0, 2.0, (64, n_cols)).astype(np.float32)
        w[:, 0] = 0.0
    hit = jintegrator.trace_eye_rays(jscene, ray_o, ray_d)
    idc = np.clip(ids, 0, N_VRLS - 1)
    ex = lambda a: a[:, None] if a.ndim == 1 else a[:, None, :]  # noqa: E731
    total, lum_mean, lum_var = _jit_pair_contribution(
        jscene, ex(ray_o), ex(ray_d), ex(hit.p), ex(hit.valid), ex(hit.ng),
        ex(hit.mat), jv.start[idc], jv.end[idc],
        jv.power[idc] * jnp.asarray(w)[..., None],
        jv.valid[idc] & jnp.asarray((w > 0) & (ids >= 0)),
        jnp.asarray(u[..., :4].reshape(64, n_cols, 2, 2)),
        jnp.asarray(u[..., 4:]), cfg=JVRLConfig())
    return (_t(u), _t(ids.astype(np.int32)), _t(w), _t(total),
            _t(lum_mean), _t(lum_var))


def test_kernel5_route_matches_jax_pair_contribution():
    """build_R_kernel (kernel 5's material instantiation, plain on the
    CPU) against the luminance mean and variance of JAX's
    pair_contribution on the same uniforms, normalised by the particle
    count and its square: the homogeneous bar, entry by entry, over all
    entries and over each eye-hit kind's alone."""
    _, scene = _scenes()
    _, vrls = _vrls()
    u, _, _, _, lum_mean, lum_var = _pair_reference(5, table=False)
    ray_o, ray_d = (_t(a) for a in _rays())
    mean, var = integrator.build_R_kernel(scene, ray_o, ray_d, vrls, 0,
                                          uniforms=u)
    pc = float(vrls.particle_count)
    kind = _eye_kinds(scene, ray_o, ray_d)[:, None].expand(-1, N_VRLS)
    for out, ref in ((mean, lum_mean / pc), (var, lum_var / pc / pc)):
        _bar(out, ref, kind, channels=1)
    assert float(mean.sum()) > 0.0


def test_kernel2_route_matches_jax_pair_contribution():
    """render_clustered_kernel (kernel 2's material instantiation, plain
    on the CPU) with each pixel its own row of a seeded table (ids in
    [-1, N), weights in [0, 2), a column of weight 0) against JAX's
    pair_contribution summed over the row with the weights, on the same
    uniforms: the homogeneous bar over the frame and over each kind's
    pixels alone."""
    _, scene = _scenes()
    _, vrls = _vrls()
    u, ids, w, total, _, _ = _pair_reference(6, table=True)
    img = integrator.render_clustered_kernel(
        scene, vrls, np.arange(64, dtype=np.int32), ids.contiguous(),
        w.contiguous(), torch.Generator().manual_seed(0), uniforms=u)
    ref = total.sum(dim=1) / float(vrls.particle_count)
    _bar(img, ref, _eye_kinds(scene, *map(_t, _rays())))
    assert float(img.sum()) > 0.0


def _glass_glossy():
    """GLOSSY_SCENE with its rough-dielectric sphere made a larger sphere
    of SMOOTH_MATERIALS' glass: chains through the glass end on the
    glossy and layered faces. (JAX scene, the port's on the CPU)."""
    desc = json.loads(json.dumps(GLOSSY_SCENE))
    for sh in desc["shapes"]:
        if sh.get("material") == "rd":
            sh.update(material="glass", radius=0.35,
                      center=[-0.25, 0.25, -0.1])
    return jloader.build_scene(desc), loader.build_scene(desc, device=CPU)


def test_kernel_spec_render_on_glass_and_glossy_matches_jax():
    """render_with_vrls_kernel_spec on glass and glossy faces (kernel 1's
    material instantiation at every chain depth, its plain version on
    the CPU, on the rays still on a chain) against JAX's jitted XLA
    li_unclustered_spec (its vrl_sum evaluates every smooth kind at each
    depth's hit), both on JAX's uniforms: depth 3 with the forced
    roulette from depth 2, 64 rays, 508 VRLs, the homogeneous bar."""
    from tests.test_torch_specular import SPEC, _jitted_vrl_sum, _spec_uniforms

    jscene, scene = _glass_glossy()
    kinds = bsdf.check_kinds(scene)
    assert bsdf.DIELECTRIC in kinds and bsdf.has_glossy(kinds)
    jv, vrls = _vrls()
    ray_o, ray_d = _rays()
    jcfg = JVRLConfig(vrl_chunk=32)
    jspec = jspecular.SpecularConfig(**SPEC)
    key = jax.random.key(7)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jintegrator, "vrl_sum", _jitted_vrl_sum())
        ref = jintegrator.li_unclustered_spec(jscene, ray_o, ray_d, jv, key,
                                              jcfg, jspec)
    u_chain, u_sums = _spec_uniforms(key, 64, N_VRLS, jcfg, jspec)
    launches = []
    saved_sum, saved_draws = integrator.vrl_sum, integrator._chain_draws

    def recording(*a, **kw):
        launches.append((tuple(a[0].shape), "materials" in kw))
        return saved_sum(*a, **kw)

    def pinned(generator, spec_cfg, n_rays, device):
        return u_chain, saved_draws(generator, spec_cfg, n_rays, device)[1]

    integrator.vrl_sum, integrator._chain_draws = recording, pinned
    try:
        img = integrator.render_with_vrls_kernel_spec(
            scene, vrls, torch.Generator().manual_seed(0), VRLConfig(),
            specular.SpecularConfig(**SPEC), uniforms=u_sums)
    finally:
        integrator.vrl_sum, integrator._chain_draws = saved_sum, saved_draws
    # every depth through the material instantiation, the chains
    # continuing through the glass
    assert launches[0] == ((pk.MAT_RAY_ROWS, 64), True)
    assert len(launches) >= 3 and all(
        s[0] == pk.MAT_RAY_ROWS and m for s, m in launches)
    assert float(_t(ref).abs().sum()) > 0.0
    _bar(img, _t(ref))


# the backward routes on the glossy table, each with what its same-seed
# central differences vary: (the route's image on the scene and a table of
# the first N_ROUTE_VRLS VRLs, at the parameter `sigma_s`; the forward
# route's, for the differences)
N_ROUTE_VRLS = 64


def _route_table(n_rays):
    return (np.zeros(n_rays, np.int32),
            torch.arange(N_ROUTE_VRLS, dtype=torch.int32)[None],
            torch.ones((1, N_ROUTE_VRLS)))


ROUTES = {
    "kernels 8 and 9": (
        lambda sc, v, g: integrator.render_with_vrls_kernel_diff(sc, v, g),
        lambda sc, v, g: integrator.render_with_vrls_kernel(sc, v, g)),
    "kernels 10 and 11": (
        lambda sc, v, g: integrator.render_clustered_kernel_diff(
            sc, v, *_route_table(64), g),
        lambda sc, v, g: integrator.render_clustered_kernel(
            sc, v, *_route_table(64), g)),
}


@pytest.mark.parametrize("route", sorted(ROUTES) + ["train_step"])
def test_routes_without_a_material_instantiation_refuse(route):
    """The backward routes take a glossy table through the backward
    kernels' material forms (their plain versions on the CPU; the JAX
    holds: tests/test_torch_glossy_bwd.py): the differentiable renders'
    images are the forward routes' on the same seed, and the gradient of
    a weighted image sum in sigma_s[1] matches same-seed central
    differences of the forward route to 5e-3; the train step's
    intensity gradient matches central differences of its loss (the
    walk does not read the intensity)."""
    _, scene = _scenes()
    _, vrls = _vrls()
    vrls = replace(vrls, start=vrls.start[:N_ROUTE_VRLS],
                   end=vrls.end[:N_ROUTE_VRLS],
                   power=vrls.power[:N_ROUTE_VRLS],
                   valid=vrls.valid[:N_ROUTE_VRLS])
    weight = torch.rand((8, 8, 3), generator=torch.Generator().manual_seed(5))
    if route == "train_step":
        def step(shift):
            sc = replace(scene, emitters=replace(
                scene.emitters, intensity=scene.emitters.intensity + shift))
            return train_step(sc, torch.Generator().manual_seed(3), weight,
                              VRLConfig(), 4, tracer.TracerConfig(max_depth=2))
        loss, grads = step(0.0)
        assert float(loss) > 0.0
        eps, d = 0.1, torch.tensor([[0.0, 0.1, 0.0]])
        fd = (float(step(d)[0]) - float(step(-d)[0])) / (2 * eps)
        ad = float(grads["intensity"][0, 1])
        assert fd != 0.0 and abs(ad - fd) <= 5e-3 * abs(fd), (ad, fd)
        return
    diff, forward = ROUTES[route]
    sigma_s = scene.medium.sigma_s.clone().requires_grad_()

    def at(s, fn):
        sc = replace(scene, medium=replace(scene.medium, sigma_s=s))
        return fn(sc, vrls, torch.Generator().manual_seed(0))

    img = at(sigma_s, diff)
    assert torch.equal(img.detach(), at(sigma_s.detach(), forward))
    (g,) = torch.autograd.grad((img * weight).sum(), sigma_s)
    eps = 2e-3
    d = torch.tensor([0.0, eps, 0.0])
    with torch.no_grad():
        fd = (float((at(sigma_s + d, forward) * weight).double().sum())
              - float((at(sigma_s - d, forward) * weight).double().sum())) \
            / (2 * eps)
    assert abs(float(g[1]) - fd) <= 5e-3 * abs(fd), (float(g[1]), fd)


def _parent_sample_from_uniforms(scene, u, mat_id, ng, ng_raw, d_in, mode,
                                 kinds):
    """bsdf.api.sample_from_uniforms as it was before the smooth kinds
    (the diffuse lobe and the three delta kinds), kept to hold today's on
    the tables it took."""
    s, t = m.build_frame(ng)
    wo = m.frame_to_world(s, t, ng, warp.square_to_cosine_hemisphere(
        u[..., 1:3]))
    weight = scene.materials.albedo[mat_id]
    eta_ratio = torch.ones_like(weight[..., 0])
    is_delta = torch.zeros_like(eta_ratio, dtype=torch.bool)
    if kinds & bsdf.DELTA_KINDS:
        wo_s, w_s, eta_s, is_delta = specular.specular_bounce(
            scene, u[..., 4], mat_id, d_in, ng_raw)
        if mode == "importance":
            refracted = ((scene.materials.kind[mat_id] == 3)
                         & ((eta_s - 1.0).abs() > 1e-6))
            w_s = torch.where(refracted[..., None], 1.0, w_s)
        wo = torch.where(is_delta[..., None], wo_s, wo)
        weight = torch.where(is_delta[..., None], w_s, weight)
        eta_ratio = torch.where(is_delta, eta_s, 1.0)
    return bsdf.BSDFSample(wo=wo, weight=weight, eta_ratio=eta_ratio,
                           is_delta=is_delta, is_smooth=~is_delta,
                           valid=torch.ones_like(is_delta))


def _glass_scene():
    from tests.test_torch_specular import SCENE
    return loader.build_scene(json.loads(json.dumps(SCENE)), device=CPU)


@pytest.mark.parametrize("name", ["cornell_smoke", "glass"])
def test_diffuse_and_glass_scenes_keep_their_trace(name):
    """On a diffuse or a glass-and-mirror table the tracer draws and
    computes as before: its VRL buffer equals, bit for bit, the one it
    gives with the sampler of the four kinds before this one."""
    scene = (presets.cornell_smoke(8, 8, device=CPU) if name ==
             "cornell_smoke" else _glass_scene())
    cfg = tracer.TracerConfig(max_depth=8, rr_depth=3)
    gen = torch.Generator().manual_seed(12)
    u_emit = torch.rand((48, tracer.N_EMIT_DIMS), generator=gen)
    u_walk = torch.rand((48, 8, tracer.N_STEP_DIMS), generator=gen)
    now = tracer.trace_u(scene, u_emit, u_walk, cfg)
    saved = bsdf.sample_from_uniforms
    bsdf.sample_from_uniforms = lambda sc, u, mat, ng, ng_raw, d, mode, \
        kinds: _parent_sample_from_uniforms(sc, u, mat, ng, ng_raw, d,
                                            mode, kinds)
    try:
        before = tracer.trace_u(scene, u_emit, u_walk, cfg)
    finally:
        bsdf.sample_from_uniforms = saved
    for k in ("start", "end", "power", "valid"):
        assert torch.equal(getattr(now, k), getattr(before, k)), k
    assert int(now.valid.sum()) > 50


@pytest.mark.parametrize("name", ["cornell_smoke", "glass"])
def test_diffuse_and_glass_scenes_take_the_diffuse_instantiation(name):
    """A diffuse or glass table renders through kernel 1's diffuse
    instantiation: the ray pack of RAY_ROWS rows, no material pack, and
    the image of the plain diffuse sum on those packs bit for bit (the
    parent's computation: _pair_terms without a material table is
    unchanged); the specular chain's launches as well."""
    scene = (presets.cornell_smoke(8, 8, device=CPU) if name ==
             "cornell_smoke" else _glass_scene())
    assert integrator.material_pack(scene) is None
    _, vrls = _vrls()
    launches = []
    saved = integrator.vrl_sum

    def recording(*a, **kw):
        launches.append((a[0].shape[0], "materials" in kw))
        return saved(*a, **kw)

    integrator.vrl_sum = recording
    try:
        img = integrator.render_with_vrls_kernel(
            scene, vrls, torch.Generator().manual_seed(2))
        integrator.render_with_vrls_kernel_spec(
            scene, vrls, torch.Generator().manual_seed(2),
            spec_cfg=specular.SpecularConfig(max_depth=2))
    finally:
        integrator.vrl_sum = saved
    assert launches and all(x == (pk.RAY_ROWS, False) for x in launches)
    seed = integrator.draw_seed(torch.Generator().manual_seed(2))
    px, py, hit, packs = integrator.pack_frame(scene, vrls)
    plain = integrator.develop_sums(scene, vrls, px, py, hit,
                                    vs.vrl_sum_reference(
                                        *packs, vs.philox_uniforms(
                                            seed, 64, N_VRLS, 6)))
    assert torch.equal(img, plain) and float(img.sum()) > 0.0


def test_material_route_on_a_diffuse_table_is_the_diffuse_sum():
    """The material instantiation's plain version on config 1's diffuse
    table (eval_smooth's Lambertian albedo cos_o / pi in place of the
    ALB rows) agrees with the diffuse one at the homogeneous bar."""
    scene = presets.cornell_smoke(8, 8, device=CPU)
    _, vrls = _vrls()
    u = torch.as_tensor(np.random.default_rng(9).random(
        (64, N_VRLS, 6)).astype(np.float32))
    mats = pk.pack_materials(scene.materials)
    _, _, hit, packs = integrator.pack_frame(scene, vrls)
    _, _, _, mpacks = integrator.pack_frame(scene, vrls, materials=mats)
    assert mpacks[0].shape[0] == pk.MAT_RAY_ROWS
    assert torch.equal(mpacks[0][:pk.RAY_ROWS], packs[0])
    out = vs.vrl_sum(*mpacks, uniforms=u, materials=mats)
    ref = vs.vrl_sum(*packs, uniforms=u)
    median, share = vs.homog_bar(out.T, ref.T)
    assert median < vs.HOMOG_MEDIAN and share < vs.HOMOG_SHARE
    assert float(ref.sum()) > 0.0


def test_material_pack_checks():
    """The wrappers refuse a material pack with the diffuse ray pack, or a
    table of the wrong shape; the smooth flags leave out the dielectric."""
    _, scene = _scenes()
    _, vrls = _vrls()
    mats = integrator.material_pack(scene)
    assert mats is not None and mats[0].shape == (len(SMOOTH_MATERIALS),
                                                  pk.MAT_COLS)
    _, _, _, packs = integrator.pack_frame(scene, vrls)
    with pytest.raises(ValueError, match="rays must be"):
        vs.vrl_sum(*packs, materials=mats)
    _, _, _, mpacks = integrator.pack_frame(scene, vrls, materials=mats)
    with pytest.raises(ValueError, match="mat_table must be"):
        vs.vrl_sum(*mpacks, materials=(mats[0][:, :5].contiguous(),
                                       mats[1]))
    smooth = mats[0][:, pk.MT_SMOOTH].tolist()
    names = [mm["name"] for mm in SMOOTH_MATERIALS]
    assert smooth[names.index("glass")] == 0.0
    assert all(smooth[i] == 1.0 for i, n in enumerate(names) if n != "glass")
