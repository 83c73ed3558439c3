"""The port's VRL tracer and its samplers against alvrl_tpu, on the same
uniforms.

trace_u is fed the uniforms the JAX tracer draws from its key tree
(torch_port_utils.jax_tracer_uniforms), so the two walks take the same
decisions and must give the same VRL buffer; the gradients of a
power-weighted sum through both tracers must agree as well.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvrl_tpu.bsdf import api as jbsdf
from alvrl_tpu.core import math as jm
from alvrl_tpu.core import warp as jwarp
from alvrl_tpu.emitters import emitters as jem
from alvrl_tpu.integrators.vrl import tracer as jtracer
from alvrl_tpu.media import api as jmapi
from alvrl_tpu.media import homogeneous as jhmed
from alvrl_tpu.media import phase as jph
from alvrl_tpu.scene import presets as jpresets
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.bsdf import api as bsdf
from alvrl_tpu_torch.core import math as m
from alvrl_tpu_torch.core import warp
from alvrl_tpu_torch.emitters import emitters as em
from alvrl_tpu_torch.integrators.vrl import tracer
from alvrl_tpu_torch.media import api as mapi
from alvrl_tpu_torch.media import homogeneous as hmed
from alvrl_tpu_torch.media import phase as ph
from alvrl_tpu_torch.scene import presets
from tests.torch_port_utils import (
    jax_emission_uniforms,
    jax_scene_leaves,
    jax_tracer_uniforms,
)

torch.set_num_threads(1)

N_PARTICLES, DEPTH = 8, 4
# (g, phase kind, short VRLs, roulette depth)
CASES = {"hg_g04": (0.4, jph.HG, True, 5), "rayleigh": (0.0, jph.RAYLEIGH,
                                                        True, 5),
         "hg_long_rr": (0.4, jph.HG, False, 2)}
# f32 rounding of the two packages' arithmetic, on values of order 1-10
ATOL, RTOL = 1e-5, 1e-5


def _t(a):
    return torch.as_tensor(np.array(a))


def _jax_scene(g, kind):
    scene = jpresets.cornell_smoke(width=8, height=8)
    return scene.replace(medium=scene.medium.replace(g=jnp.float32(g),
                                                     phase_kind=kind))


def _uniforms(n, d, seed):
    return np.random.default_rng(seed).random((n, d), dtype=np.float32)


def test_frame_and_warps_match():
    rng = np.random.default_rng(0)
    n = rng.normal(size=(256, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:2] = [[0, 0, 1], [0, 0, -1]]
    v = rng.normal(size=(256, 3)).astype(np.float32)
    u = _uniforms(256, 2, 1)
    js, jt = jm.build_frame(jnp.asarray(n))
    s, t = m.build_frame(_t(n))
    torch.testing.assert_close(s, _t(js), atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(t, _t(jt), atol=1e-6, rtol=1e-6)
    for ours, ref in [
            (m.frame_to_world(s, t, _t(n), _t(v)),
             jm.frame_to_world(js, jt, jnp.asarray(n), jnp.asarray(v))),
            (m.frame_to_local(s, t, _t(n), _t(v)),
             jm.frame_to_local(js, jt, jnp.asarray(n), jnp.asarray(v))),
            (m.spherical_direction(_t(u[:, 0] * 2 - 1), _t(u[:, 1] * 6)),
             jm.spherical_direction(jnp.asarray(u[:, 0] * 2 - 1),
                                    jnp.asarray(u[:, 1] * 6))),
            (warp.square_to_uniform_sphere(_t(u)),
             jwarp.square_to_uniform_sphere(jnp.asarray(u))),
            (warp.square_to_cosine_hemisphere(_t(u)),
             jwarp.square_to_cosine_hemisphere(jnp.asarray(u)))]:
        torch.testing.assert_close(ours, _t(ref), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("g, kind", [(0.0, jph.HG), (0.7, jph.HG),
                                     (-0.3, jph.HG), (0.0, jph.RAYLEIGH)])
def test_sample_phase_matches(g, kind):
    rng = np.random.default_rng(2)
    wi = rng.normal(size=(512, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    u = _uniforms(512, 2, 3)
    jwo, jw, jpdf = jph.sample_phase(kind, jnp.float32(g), jnp.asarray(wi),
                                     jnp.asarray(u))
    wo, w, pdf = ph.sample_phase(kind, torch.tensor(g), _t(wi), _t(u))
    torch.testing.assert_close(wo, _t(jwo), atol=2e-5, rtol=1e-5)
    torch.testing.assert_close(pdf, _t(jpdf), atol=1e-5, rtol=1e-4)
    assert torch.equal(w, _t(jw))


def test_sample_phase_rejects_other_kinds():
    with pytest.raises(ValueError):
        ph.sample_phase(jph.KKAY, torch.tensor(0.0), torch.ones(2, 3),
                        torch.zeros(2, 2))


@pytest.mark.parametrize("sigma_a, sigma_s", [((0.05, 0.1, 0.2),
                                               (0.8, 0.5, 0.3)),
                                              ((0.5, 0.5, 0.5),
                                               (0.0, 0.0, 0.0))])
def test_sample_distance_matches(sigma_a, sigma_s):
    """Free-flight samples over segments that end at a surface, miss
    (1e30), or are tiny; the tau < 1e-20 zeroing included."""
    rng = np.random.default_rng(4)
    u2 = _uniforms(1024, 2, 5)
    dist = rng.uniform(0.0, 60.0, 1024).astype(np.float32)
    dist[::7] = 1e30
    dist[1::7] = 1e-4
    o = rng.normal(size=(1024, 3)).astype(np.float32)
    d = rng.normal(size=(1024, 3)).astype(np.float32)
    jmed = jhmed.make_medium(sigma_a, sigma_s)
    med = hmed.make_medium(sigma_a, sigma_s, device="cpu")
    ref = jmapi.sample_distance_seg_u(jmed, jnp.asarray(u2), jnp.asarray(o),
                                      jnp.asarray(d), jnp.asarray(dist))
    out = mapi.sample_distance_seg_u(med, _t(u2), _t(o), _t(d), _t(dist))
    assert torch.equal(out.success, _t(ref.success))
    n_events = int(out.success.sum())
    # a medium that does not scatter has sampling weight 0: no events
    assert 0 < n_events < 1024 if max(sigma_s) > 0 else n_events == 0
    for k in ("t", "p", "w_scatter", "w_pass"):
        torch.testing.assert_close(getattr(out, k), _t(getattr(ref, k)),
                                   atol=1e-5, rtol=1e-5, msg=k)


def test_sample_emission_matches():
    """Point lights: the port's position, direction and weight against
    the JAX sampler, on the uniforms rebuilt from its key
    (jax_emission_uniforms)."""
    jscene = jpresets.cornell_smoke(width=4, height=4,
                                    intensity=(8.0, 0.0, 2.5))
    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device="cpu")
    keys = jax.random.split(jax.random.key(7), 64)
    ref = jax.vmap(lambda k: jem.sample_emission(
        jscene.emitters, k, jnp.zeros(3), 1.0))(keys)
    u = np.stack([np.asarray(jax_emission_uniforms(k)) for k in keys])
    out = em.sample_emission_u(scene.emitters, _t(u), torch.zeros(3),
                               torch.tensor(1.0))
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, _t(r), atol=1e-6, rtol=1e-6)


def test_sample_emission_picks_by_pmf():
    """Two lights: the emitter choice inverts the CDF of the stored pmf,
    and the weight divides by the chosen light's pmf."""
    ems = em.make_point_emitters([[0, 0, 0], [1, 1, 1]],
                                 [[1.0, 1.0, 1.0], [3.0, 3.0, 3.0]],
                                 device="cpu")
    torch.testing.assert_close(ems.pmf, torch.tensor([0.25, 0.75]))
    u = torch.full((3, em.N_EMIT_DIMS), 0.5)
    u[:, 0] = torch.tensor([0.1, 0.3, 0.999])
    pos, _, w = em.sample_emission_u(ems, u, torch.zeros(3),
                                     torch.tensor(1.0))
    assert pos.tolist() == [[0, 0, 0], [1, 1, 1], [1, 1, 1]]
    torch.testing.assert_close(w[:, 0], torch.tensor([4.0, 4.0, 4.0])
                               * 4.0 * np.pi)


def test_sample_emission_rejects_other_kinds():
    """A table holding a kind that is not one of the reference's is
    refused when it is built, and so is an ENVMAP entry without its map
    (every kind of the reference is ported since the environment map)."""
    with pytest.raises(ValueError, match="not ported"):
        em.make_emitters([em.POINT, 7], [[0, 0, 0]] * 2,
                         [[1.0, 1.0, 1.0]] * 2, device="cpu")
    table = em.make_emitters([em.POINT, jem.ENVMAP], [[0, 0, 0]] * 2,
                             [[1.0, 1.0, 1.0]] * 2, device="cpu")
    with pytest.raises(ValueError, match="env map"):
        replace(table, env=None)


def test_bsdf_sample_matches():
    """Diffuse sampling at random hits of the Cornell box."""
    jscene = jpresets.cornell_smoke(width=4, height=4)
    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device="cpu")
    rng = np.random.default_rng(8)
    n = 256
    ng = rng.normal(size=(n, 3)).astype(np.float32)
    ng /= np.linalg.norm(ng, axis=1, keepdims=True)
    d_in = -ng
    mat = rng.integers(0, 4, n)
    u = _uniforms(n, jbsdf.N_SAMPLE_DIMS, 9)
    ref = jbsdf.sample_from_uniforms(
        jscene, jnp.asarray(u), jnp.asarray(mat), jnp.asarray(ng),
        jnp.asarray(ng), jnp.asarray(d_in), jnp.zeros((n, 3)),
        mode="importance")
    out = bsdf.sample_from_uniforms(scene, _t(u), _t(mat), _t(ng), _t(ng),
                                    _t(d_in), mode="importance")
    torch.testing.assert_close(out.wo, _t(ref.wo), atol=1e-6, rtol=1e-6)
    assert torch.equal(out.weight, _t(ref.weight))
    assert bool(np.all(ref.valid)) and bool(np.all(ref.eta_ratio == 1.0))
    assert bool(out.valid.all()) and bool((out.eta_ratio == 1.0).all())
    assert not bool(out.is_delta.any())


def test_bsdf_sample_rejects_other_kinds():
    """A kind not ported (here IRAWAN, 15) raises."""
    scene = presets.cornell_smoke(width=4, height=4, device="cpu")
    scene = replace(scene, materials=replace(
        scene.materials, kind=torch.tensor([0, 0, 0, 15])))
    with pytest.raises(ValueError, match="IRAWAN.*ROADMAP A11a"):
        bsdf.sample_from_uniforms(scene, torch.zeros(1, 5), torch.zeros(
            1, dtype=torch.int64), torch.tensor([[0.0, 1.0, 0.0]]),
            torch.tensor([[0.0, 1.0, 0.0]]), torch.tensor([[0.0, -1.0, 0.0]]))


def test_trace_rejects_other_kinds_once():
    """The tracer checks the material table once, before its first
    bounce (bsdf.check_kinds), and then samples without the check."""
    scene = presets.cornell_smoke(width=4, height=4, device="cpu")
    scene = replace(scene, materials=replace(
        scene.materials, kind=torch.tensor([0, 0, 0, 15])))
    calls = []
    check = bsdf.check_kinds

    def counted(s):
        calls.append(1)
        return check(s)

    with pytest.raises(ValueError, match="ROADMAP A11"):
        tracer.trace(scene, torch.Generator().manual_seed(0), 4,
                     tracer.TracerConfig(max_depth=3))
    ok = presets.cornell_smoke(width=4, height=4, device="cpu")
    bsdf.check_kinds = counted
    try:
        tracer.trace(ok, torch.Generator().manual_seed(0), 4,
                     tracer.TracerConfig(max_depth=3))
    finally:
        bsdf.check_kinds = check
    assert len(calls) == 1


def test_scene_aabb_matches():
    jscene = jpresets.cornell_smoke(width=4, height=4)
    lo, hi = presets.cornell_smoke(width=4, height=4, device="cpu").aabb()
    jlo, jhi = jscene.aabb()
    assert torch.equal(lo, _t(jlo)) and torch.equal(hi, _t(jhi))


def _trace_both(case, key, score_phase=True):
    g, kind, short, rr_depth = CASES[case]
    jscene = _jax_scene(g, kind)
    jcfg = jtracer.TracerConfig(max_depth=DEPTH, rr_depth=rr_depth,
                                short_vrls=short, score_phase=score_phase)
    cfg = tracer.TracerConfig(max_depth=DEPTH, rr_depth=rr_depth,
                              short_vrls=short, score_phase=score_phase)
    u_emit, u_walk = jax_tracer_uniforms(key, N_PARTICLES, DEPTH)
    return jscene, jcfg, cfg, _t(u_emit), _t(u_walk)


@pytest.mark.parametrize("case", sorted(CASES))
def test_trace_u_matches_jax_trace(case):
    """Same uniforms, same walk: start, end, power and valid per slot
    (8 particles x depth 4)."""
    key = jax.random.key(3)
    jscene, jcfg, cfg, u_emit, u_walk = _trace_both(case, key)
    ref = jtracer.trace(jscene, key, N_PARTICLES, jcfg)
    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device="cpu")
    out = tracer.trace_u(scene, u_emit, u_walk, cfg)
    valid = _t(ref.valid)
    assert out.capacity == N_PARTICLES * DEPTH
    assert torch.equal(out.valid, valid)
    assert 0 < int(valid.sum())
    if CASES[case][3] < DEPTH:
        assert int(valid.sum()) < N_PARTICLES * DEPTH  # roulette ran
    for k in ("start", "end", "power"):
        torch.testing.assert_close(getattr(out, k)[valid],
                                   _t(getattr(ref, k))[valid], atol=ATOL,
                                   rtol=RTOL, msg=k)
    assert float(out.particle_count) == N_PARTICLES


@pytest.mark.parametrize("case, score_phase", [("hg_g04", True),
                                               ("rayleigh", True),
                                               ("hg_g04", False)],
                         ids=["hg_g04", "rayleigh", "hg_g04_no_score"])
def test_trace_gradients_match_jax(case, score_phase):
    """d/d(sigma_a, sigma_s, g, intensity) of a power-weighted sum of
    the VRL buffer: jax.grad through tracer.trace against torch autograd
    through trace_u. The detached sampling and the HG score term must
    be placed as in the reference for these to agree; without the score
    term nothing in the buffer depends on g."""
    key = jax.random.key(5)
    jscene, jcfg, cfg, u_emit, u_walk = _trace_both(case, key, score_phase)
    w = np.random.default_rng(6).uniform(
        0.5, 1.5, (N_PARTICLES * DEPTH, 3)).astype(np.float32)

    def jloss(p):
        med = jscene.medium.replace(sigma_a=p["sigma_a"],
                                    sigma_s=p["sigma_s"], g=p["g"])
        sc = jscene.replace(medium=med, emitters=jscene.emitters.replace(
            intensity=p["intensity"]))
        v = jtracer.trace(sc, key, N_PARTICLES, jcfg)
        return jnp.sum(jnp.where(v.valid[:, None], v.power * w, 0.0))

    names = ("sigma_a", "sigma_s", "g", "intensity")
    jp = {"sigma_a": jscene.medium.sigma_a, "sigma_s": jscene.medium.sigma_s,
          "g": jscene.medium.g, "intensity": jscene.emitters.intensity}
    jgrad = jax.grad(jloss)(jp)

    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device="cpu")
    p = {k: _t(jp[k]).requires_grad_() for k in names}
    sc = replace(scene, medium=replace(scene.medium, sigma_a=p["sigma_a"],
                                       sigma_s=p["sigma_s"], g=p["g"]),
                 emitters=replace(scene.emitters, intensity=p["intensity"]))
    v = tracer.trace_u(sc, u_emit, u_walk, cfg)
    loss = torch.where(v.valid[:, None], v.power * _t(w), 0.0).sum()
    grads = torch.autograd.grad(loss, [p[k] for k in names],
                                allow_unused=True, materialize_grads=True)
    for k, gr in zip(names, grads):
        assert torch.isfinite(gr).all(), k
        torch.testing.assert_close(gr, _t(jgrad[k]), atol=1e-4, rtol=1e-4,
                                   msg=k)
    if CASES[case][1] == jph.RAYLEIGH or not score_phase:
        assert float(grads[2]) == 0.0
    else:
        assert float(grads[2]) != 0.0  # the score term
