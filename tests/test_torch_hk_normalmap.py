"""The port's NORMALMAP (from a normal texture, and a bump map after its
bake), the HK slab and the textured leaves against alvrl_tpu.bsdf.api:
eval_smooth and pdf_smooth at a hit's point and UV, sample_from_uniforms
in both transport modes, on cornell_textured's table
(presets.cornell_textured_desc) as the JAX loader builds it, with the
port's baked bump map put into the JAX scene's bitmap stack (the JAX
loader reads the height field itself, ROADMAP C24), so that both
evaluate the same normal map. The port evaluates at the hit's
bsdf.api.Shading (shading normal and albedos), JAX at (p_world, uv).
Then the tracer on that scene against JAX's on JAX's own random numbers.

Bars: the eval, the pdf and the sampled direction at rel 1e-5 and abs
1e-6 (TOL); the sampled weight at rel 1e-5 and abs 1e-5 (the HK slab's
weight divides its eval by a pdf near 0 at grazing wo). The slab's
transmission (exp(-tau / |ci|) - exp(-tau / |co|)) / (|ci| - |co|) is a
difference quotient: where ||ci| - |co|| < HK_NEAR it amplifies the last
bit of either library's exp (JAX's eager and jitted evals differ there
by 6e-4 relative, at 6 and 9 of 4,096 hits), and those hits are held at
HK_NEAR_RTOL. The tracer's VRLs as tests/test_torch_glossy.py holds
them. JAX's functions jitted once each. About 45 s alone.
"""

import functools
import json
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvrl_tpu.bsdf import api as jbsdf
from alvrl_tpu.integrators.vrl import tracer as jtracer
from alvrl_tpu.scene import loader as jloader
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.bsdf import api as bsdf
from alvrl_tpu_torch.integrators.vrl import tracer
from alvrl_tpu_torch.ops import vrl_sum as vs
from alvrl_tpu_torch.scene import loader, presets
from alvrl_tpu_torch.scene.scene import HK, NORMALMAP
from tests.torch_port_utils import CPU, jax_scene_leaves, jax_tracer_uniforms

torch.set_num_threads(1)

N = 4096
TOL = dict(rtol=1e-5, atol=1e-6)
WEIGHT_TOL = dict(rtol=1e-5, atol=1e-5)
HK_NEAR, HK_NEAR_RTOL = 1e-2, 2e-3
# the materials held, by name in cornell_textured_desc: the two normal
# maps, the slab, and the textured leaves under them and beside them
HELD = ("normalmap", "bumpmap", "hk", "noise", "bitmap", "checker", "grid")
MODES = ("radiance", "importance")


# the bitmaps' directory, removed when the process ends
_TMP = tempfile.TemporaryDirectory(prefix="alvrl_tex_")


@functools.lru_cache(maxsize=None)
def _scenes():
    """(desc, the JAX scene with the port's bitmap stack, that scene
    carried across, the port loader's scene)."""
    desc = presets.cornell_textured_desc(_TMP.name,
                                         8, 8)
    ours = loader.build_scene(desc, device=CPU)
    jscene = jloader.build_scene(json.loads(json.dumps(desc)))
    jscene = jscene.replace(textures=jnp.asarray(ours.textures.numpy()))
    return desc, jscene, convert.scene_from_numpy(jax_scene_leaves(jscene),
                                                  device=CPU), ours


def _mat(name):
    return [m["name"] for m in _scenes()[0]["materials"]].index(name)


def _t(a):
    return torch.as_tensor(np.array(a))


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _inputs(seed, name):
    """Seeded hits of material `name`: (mat ids, oriented normal, winding
    normal, wi, wo, d_in, p, uv, u)."""
    rng = np.random.default_rng(seed)
    ng, wi, wo, d_in = (_unit(rng, N) for _ in range(4))
    ng = np.where(np.sum(ng * d_in, axis=1, keepdims=True) > 0, -ng, ng)
    p = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    uv = rng.uniform(-0.2, 1.2, (N, 2)).astype(np.float32)
    u = rng.random((N, bsdf.N_SAMPLE_DIMS)).astype(np.float32)
    mid = np.full(N, _mat(name), np.int32)
    return mid, ng, ng, wi, wo, d_in, p, uv, u


_jit_eval = jax.jit(jbsdf.eval_smooth)
_jit_pdf = jax.jit(jbsdf.pdf_smooth)
_jit_sample = jax.jit(jbsdf.sample_from_uniforms, static_argnames=("mode",))


def _hk_near(name, n, wi, wo):
    """(N,) bool: the HK transmissions of ||ci| - |co|| < HK_NEAR (module
    docstring); none for the other materials."""
    ci, co = np.sum(wi * n, axis=1), np.sum(wo * n, axis=1)
    near = (ci * co < 0) & (np.abs(np.abs(ci) - np.abs(co)) < HK_NEAR)
    return _t(near & (name == "hk"))


def _shade(scene, mid, ng, p, uv):
    return bsdf.shading(scene, _t(mid).long(), _t(ng), _t(p), _t(uv))


@pytest.mark.parametrize("name", HELD)
def test_eval_and_pdf_match_jax(name):
    _, jscene, scene, _ = _scenes()
    mid, ng, _, wi, wo, _, p, uv, _ = _inputs(1, name)
    sh = _shade(scene, mid, ng, p, uv)
    out = bsdf.eval_smooth(scene.materials, _t(mid).long(), _t(ng), _t(wi),
                           _t(wo), shade=sh)
    ref = _t(_jit_eval(jscene, jnp.asarray(mid), jnp.asarray(ng),
                       jnp.asarray(wi), jnp.asarray(wo), jnp.asarray(p),
                       jnp.asarray(uv)))
    near = _hk_near(name, ng, wi, wo)
    assert int(near.sum()) < N // 50
    torch.testing.assert_close(out[~near], ref[~near], **TOL)
    torch.testing.assert_close(out[near], ref[near], rtol=HK_NEAR_RTOL,
                               atol=1e-6)
    assert float(out.abs().sum()) > 0.0
    out = bsdf.pdf_smooth(scene.materials, _t(mid).long(), _t(ng), _t(wi),
                          _t(wo), shade=sh)
    ref = _jit_pdf(jscene, jnp.asarray(mid), jnp.asarray(ng),
                   jnp.asarray(wi), jnp.asarray(wo), jnp.asarray(uv))
    torch.testing.assert_close(out, _t(ref), **TOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", HELD)
def test_sample_matches_jax(name, mode):
    """Every branch of the sampler that the kinds reach: the HK slab's
    delta transmission and its two-sided cosine lobe, the normal maps'
    perturbed frame over their nested leaves, the textured albedos."""
    _, jscene, scene, _ = _scenes()
    mid, ng, ng_raw, _, _, d_in, p, uv, u = _inputs(2, name)
    out = bsdf.sample_from_uniforms(
        scene, _t(u), _t(mid).long(), _t(ng), _t(ng_raw), _t(d_in),
        mode=mode, shade=_shade(scene, mid, ng, p, uv))
    ref = _jit_sample(jscene, jnp.asarray(u), jnp.asarray(mid),
                      jnp.asarray(ng), jnp.asarray(ng_raw),
                      jnp.asarray(d_in), jnp.asarray(p), mode=mode,
                      uv=jnp.asarray(uv))
    for k in ("valid", "is_delta", "is_smooth"):
        assert torch.equal(getattr(out, k), _t(getattr(ref, k))), k
    ok = out.valid
    assert int(ok.sum()) > N // 2
    torch.testing.assert_close(out.wo[ok], _t(ref.wo)[ok], **TOL)
    wo_l = out.wo.numpy()
    near = _hk_near(name, ng, -d_in, wo_l) & ~out.is_delta
    torch.testing.assert_close(out.weight[ok & ~near],
                               _t(ref.weight)[ok & ~near], **WEIGHT_TOL)
    torch.testing.assert_close(out.weight[ok & near],
                               _t(ref.weight)[ok & near],
                               rtol=HK_NEAR_RTOL, atol=1e-5)
    torch.testing.assert_close(out.eta_ratio, _t(ref.eta_ratio), **TOL)
    if name == "hk":  # both lobes drawn
        assert 0 < int(out.is_delta.sum()) < N


def test_the_maps_perturb_and_the_slab_has_a_smooth_flag():
    """The shading normals of the two normal maps differ from ng, the
    others' equal it; smooth_flags holds NORMALMAP over a smooth leaf,
    the slab and a procedural texture's albedo2 over a black albedo."""
    _, _, scene, _ = _scenes()
    for name in HELD:
        mid, ng, _, _, _, _, p, uv, _ = _inputs(3, name)
        sh = _shade(scene, mid, ng, p, uv)
        moved = float((sh.ns - _t(ng)).abs().amax(dim=-1).gt(1e-4)
                      .float().mean())
        assert (moved > 0.3) == (name in ("normalmap", "bumpmap")), name
    flags = bsdf.smooth_flags(scene.materials)
    kinds = scene.materials.kind
    assert bool(flags[(kinds == NORMALMAP) | (kinds == HK)].all())
    from dataclasses import replace

    black = replace(scene.materials, albedo=torch.zeros_like(
        scene.materials.albedo))
    procedural = (black.tex_kind >= 1) & (black.tex_kind <= 3) & (
        black.kind == 0)
    assert bool(bsdf.smooth_flags(black)[procedural].all())


@pytest.mark.parametrize("short_vrls", [True, False], ids=["short", "long"])
def test_trace_matches_jax_on_the_textured_scene(short_vrls):
    """The tracer through the textured table (the bounce off each surface
    sampled at its Shading) on JAX's own random numbers, on JAX's scene
    with the port's bitmap stack: 64 particles x depth 6, roulette from
    depth 2; validity equal, the VRLs at the homogeneous bar."""
    _, jscene, scene, _ = _scenes()
    key = jax.random.key(21)
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
