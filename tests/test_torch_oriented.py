"""Oriented media of alvrl_tpu_torch (the Kajiya-Kay and micro-flake phase
functions, the orientation volume, the micro-flake medium's directional
extinction) against alvrl_tpu, on the same numpy-made inputs.

The phase functions' eval, pdf and sample (Kajiya-Kay on the same u2,
micro-flake on the same (16, 3) SIR uniforms), kkay_params and the
micro-flake LUT, mirroring tests/test_phase_oriented.py; the orientation
lookup, dir_factor, the directional quadratures and Woodcock tracking
with the directional majorant, mirroring tests/test_oriented_media.py;
volpath on a micro-flake medium (Woodcock) and a Kajiya-Kay one (the
quadrature sampler) against li_volpath ray by ray on JAX's random
numbers (torch_port_utils.jax_volpath_uniforms with the SIR draw); the
VRL routes' refusal. The JAX side is jitted once per function, or
called eagerly where it takes batches. About 80 s alone, 45 s of it the
two li_volpath compiles.
"""

import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvrl_tpu.integrators import volpath as jvolpath
from alvrl_tpu.media import api as jmapi
from alvrl_tpu.media import heterogeneous as jgmed
from alvrl_tpu.media import phase as jph
from alvrl_tpu.scene import presets as jpresets
from alvrl_tpu.sensors import perspective as jperspective
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.integrators import volpath
from alvrl_tpu_torch.integrators.vrl import integrator, tracer
from alvrl_tpu_torch.media import heterogeneous as gmed
from alvrl_tpu_torch.media import phase as ph
from alvrl_tpu_torch.ops.vrl_sum import HOMOG_MEDIAN, HOMOG_SHARE, homog_bar
from tests.torch_port_utils import (
    CPU,
    jax_scene_leaves,
    jax_tracking_uniforms,
    jax_volpath_uniforms,
)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-7  # values: float32 rounding of the same formulas
# erfinv's argument farther than this from +-1: one float32 step of it
# moves the micro-flake sample's cos theta by at most 4.2e-6 at stddev
# 0.25, a fifth of the 2e-5 the sample is held to (the bar is reached at
# 1 - 2e-4)
ERFINV_MARGIN = 1e-3
N = 512


def _t(a):
    return torch.as_tensor(np.array(a))


def _dirs(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _orientations(rng, n):
    """Fiber directions of random lengths, every 16th undefined (zero)."""
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o[::16] = 0.0
    return o


def _close(out, ref, rtol=RTOL, atol=ATOL):
    torch.testing.assert_close(out, _t(ref), rtol=rtol, atol=atol)


def test_params_match():
    """kkay_params' Simpson normalisation and the micro-flake LUT (built
    in LUT-row chunks on the port's side) are JAX's."""
    for args in ((0.4, 0.2, 4.0), (0.7, 0.1, 12.0)):
        jp, p = jph.kkay_params(*args), ph.kkay_params(*args, device=CPU)
        for k in ("ks", "kd", "exponent", "norm"):
            assert float(getattr(p, k)) == float(getattr(jp, k)), k
    jp, p = jph.microflake_params(0.35), ph.microflake_params(0.35,
                                                              device=CPU)
    assert float(p.stddev) == float(jp.stddev)
    _close(p.sigma_t_lut, jp.sigma_t_lut, rtol=1e-7, atol=0.0)


@pytest.fixture(scope="module")
def phase_inputs():
    rng = np.random.default_rng(7)
    return dict(wi=_dirs(rng, N), wo=_dirs(rng, N), o=_orientations(rng, N),
                u2=rng.random((N, 2), dtype=np.float32),
                u_sir=rng.random((N, 16, 3), dtype=np.float32),
                cos=rng.uniform(-1.0, 1.0, N).astype(np.float32))


def _jax_lanes(fn, *args):
    return jax.jit(jax.vmap(fn))(*(jnp.asarray(a) for a in args))


def test_kkay_matches(phase_inputs):
    """Kajiya-Kay eval, pdf and sample on the same directions, fibers
    (some undefined) and u2."""
    x = phase_inputs
    jp, p = jph.kkay_params(), ph.kkay_params(device=CPU)
    wi, wo, o = _t(x["wi"]), _t(x["wo"]), _t(x["o"])
    ref = _jax_lanes(lambda a, b, c: jph.eval_kkay(jp, c, a, b), x["wi"],
                     x["wo"], x["o"])
    _close(ph.eval_phase(ph.KKAY, None, wi, wo, orientation=o, pp=p), ref)
    ref = _jax_lanes(lambda a, b, c: jph.pdf_phase(
        jph.KKAY, 0.0, a, b, orientation=c, pp=jp), x["wi"], x["wo"], x["o"])
    _close(ph.pdf_phase(ph.KKAY, None, wi, wo, orientation=o, pp=p), ref)
    jwo, jw, jpdf = _jax_lanes(lambda a, c, u: jph.sample_kkay(jp, c, a, u),
                               x["wi"], x["o"], x["u2"])
    wo_s, w, pdf = ph.sample_phase(ph.KKAY, None, wi, _t(x["u2"]),
                                   orientation=o, pp=p)
    _close(wo_s, jwo, atol=1e-6)
    _close(w, jw)
    _close(pdf, jpdf)


def test_microflake_matches(phase_inputs):
    """Micro-flake eval, pdf, sigmaDir and the SIR sample on the same
    (16, 3) uniforms. The longitudinal inverse takes erfinv in both
    packages (torch.erfinv, jax.scipy.special.erfinv), whose float32
    results may differ in the last bits, which erfinv's slope near +-1
    magnifies. The lanes with a candidate's erfinv argument within
    ERFINV_MARGIN of +-1 are exempt from the direction's and the pdf's
    match (their weight is still held, and their pdf must be finite);
    every other lane's sampled direction is held at 2e-5 absolute and
    its pdf at RTOL."""
    x = phase_inputs
    jp, p = jph.microflake_params(0.25), ph.microflake_params(0.25,
                                                              device=CPU)
    wi, wo, o = _t(x["wi"]), _t(x["wo"]), _t(x["o"])
    ref = _jax_lanes(lambda a, b, c: jph.eval_microflake(jp, c, a, b),
                     x["wi"], x["wo"], x["o"])
    _close(ph.eval_phase(ph.MICROFLAKE, None, wi, wo, orientation=o, pp=p),
           ref)
    _close(ph.pdf_phase(ph.MICROFLAKE, None, wi, wo, orientation=o, pp=p),
           ref)
    _close(ph.microflake_sigma_dir(p, _t(x["cos"])),
           _jax_lanes(lambda c: jph.microflake_sigma_dir(jp, c), x["cos"]))
    jwo, jw, jpdf = _jax_lanes(
        lambda a, c, u: jph.sample_microflake(jp, c, a, u), x["wi"], x["o"],
        x["u_sir"])
    wo_s, w, pdf = ph.sample_phase(ph.MICROFLAKE, None, wi, _t(x["u2"]),
                                   orientation=o, pp=p, u_sir=_t(x["u_sir"]))
    assert torch.equal(w, _t(jw))
    c1 = np.float32(math.erf(1.0 / (math.sqrt(2.0) * 0.25)))
    arg = np.abs((1.0 - 2.0 * x["u_sir"][..., 0]) * c1)
    held = torch.as_tensor((arg <= 1.0 - ERFINV_MARGIN).all(axis=-1))
    assert int(held.sum()) >= N - 16, int(held.sum())
    err = (wo_s - _t(jwo)).abs().amax(dim=-1)
    assert float(err[held].max()) < 2e-5, float(err[held].max())
    _close(pdf[held], np.asarray(jpdf)[held.numpy()])
    assert bool(torch.isfinite(pdf).all())


def test_oriented_kinds_are_normalised():
    """tests/test_phase_oriented.py's checks on the port: the micro-flake
    lobe integrates to 1 over the sphere; the Kajiya-Kay lobe to at most
    1, and its sampler's mean weight is that integral."""
    n = 128
    th = (np.arange(n) + 0.5) / n * np.pi
    phi = (np.arange(2 * n) + 0.5) / (2 * n) * 2 * np.pi
    t, q = np.meshgrid(th, phi, indexing="ij")
    wo = torch.as_tensor(np.stack([np.sin(t) * np.cos(q), np.sin(t)
                                   * np.sin(q), np.cos(t)], -1).reshape(-1, 3)
                         .astype(np.float32))
    wi = torch.tensor([[np.sin(1.1), 0.0, np.cos(1.1)]],
                      dtype=torch.float32).expand_as(wo)
    o = torch.tensor([[0.0, 0.0, 1.0]]).expand_as(wo)
    sin_t = torch.as_tensor(np.sin(t).reshape(-1))

    def integral(v):
        return float((v.double() * sin_t).sum()) * (np.pi / n) ** 2

    mf = ph.eval_microflake(ph.microflake_params(0.3, device=CPU), o, wi, wo)
    assert abs(integral(mf) - 1.0) < 5e-3
    pp = ph.kkay_params(device=CPU)
    kk = integral(ph.eval_kkay(pp, o, wi, wo))
    assert 0.2 < kk <= 1.0 + 1e-3
    u = torch.as_tensor(np.random.default_rng(0).random((40000, 2),
                                                        dtype=np.float32))
    _, w, _ = ph.sample_kkay(pp, o[:1].expand(40000, 3),
                             wi[:1].expand(40000, 3), u)
    assert abs(float(w.mean()) - kk) < 0.02


def _fiber_media(kind=jph.MICROFLAKE, fast_tau=True, res=8, sampling=0):
    """(JAX, port) grid media: a random density over a shifted box with a
    random orientation field (some voxels undefined), an oriented kind."""
    rng = np.random.default_rng(11)
    dens = rng.uniform(0.2, 1.5, (res, res + 1, res - 1)).astype(np.float32)
    orient = rng.normal(size=dens.shape + (3,)).astype(np.float32)
    orient[::3, ::2, 1] = 0.0
    orient[1, 2, 3] = 0.0
    pp = (jph.microflake_params(0.2) if kind == jph.MICROFLAKE
          else jph.kkay_params())
    jmed = jgmed.make_grid_medium(
        dens, [1.0, 0.9, 1.1], [0.9, 0.85, 0.8], box_min=(-1, -0.8, -1.1),
        box_max=(1.1, 1.0, 0.9), scale=1.2, phase_kind=kind,
        orientation=orient, phase_params=pp)
    jmed = jmed.replace(fast_tau=fast_tau, sampling=sampling)
    leaves = jax_scene_leaves(jpresets.cornell_grid_smoke(4, 4, grid_res=4)
                              .replace(medium=jmed))
    return jmed, convert.scene_from_numpy(leaves, device=CPU).medium


def _points(rng, n, lo=-1.3, hi=1.3):
    return rng.uniform(lo, hi, (n, 3)).astype(np.float32)


def test_converted_medium_carries_the_oriented_fields():
    jmed, med = _fiber_media()
    assert med.phase_kind == ph.MICROFLAKE and med.fast_tau
    assert torch.equal(med.orientation, _t(jmed.orientation))
    assert float(med.sigma_dir_max) == float(jmed.sigma_dir_max) > 1.0
    assert torch.equal(med.phase_params.sigma_t_lut,
                       _t(jmed.phase_params.sigma_t_lut))


def test_orientation_lookup_and_dir_factor_match():
    """lookup_orientation (trilinear, 0 outside the box) and dir_factor
    (sigmaDir along d, 0 where the orientation is undefined) at points
    inside and outside the box; the factor is 1 for a Kajiya-Kay medium,
    which is not directional."""
    rng = np.random.default_rng(12)
    jmed, med = _fiber_media()
    p, d = _points(rng, 1024), _dirs(rng, 1024)
    _close(gmed.lookup_orientation(med, _t(p)),
           jgmed.lookup_orientation(jmed, jnp.asarray(p)), atol=1e-6)
    ref = jgmed.dir_factor(jmed, jnp.asarray(p), jnp.asarray(d))
    assert float(np.asarray(ref).max()) > 1.0
    _close(gmed.dir_factor(med, _t(p), _t(d)), ref, atol=1e-6)
    _, kk = _fiber_media(jph.KKAY)
    assert torch.equal(gmed.dir_factor(kk, _t(p), _t(d)),
                       torch.ones(1024))


@pytest.mark.parametrize("fast_tau", [True, False], ids=["nearest",
                                                          "trilinear"])
def test_directional_quadratures_match(fast_tau):
    """optical_depth, cumulative_od and eval_transmittance of a micro-flake
    medium (each step's density times dir_factor along the segment) and
    its eval_ray, read nearest in the supersample or trilinear."""
    rng = np.random.default_rng(13)
    jmed, med = _fiber_media(fast_tau=fast_tau)
    jmed = jmapi.prepare(jmed)
    grid = gmed.quad_grid(med)
    p0, p1 = _points(rng, 512), _points(rng, 512)
    a, b, ja, jb = _t(p0), _t(p1), jnp.asarray(p0), jnp.asarray(p1)
    # the JAX functions batched over the leading axis, eagerly (as
    # many compiles as jit's would cost more than the calls)
    for out, ref in (
            (gmed.optical_depth(med, grid, a, b),
             jgmed.optical_depth(jmed, ja, jb)),
            (gmed.cumulative_od(med, grid, a, b),
             jgmed.cumulative_od(jmed, ja, jb)),
            (gmed.eval_transmittance(med, grid, a, b),
             jgmed.eval_transmittance(jmed, ja, jb)),
            *zip(gmed.eval_ray(med, grid, a, b),
                 jgmed.eval_ray(jmed, ja, jb))):
        _close(out, ref, atol=1e-6)


def test_woodcock_with_the_directional_majorant_matches():
    """Woodcock tracking in a micro-flake medium: the majorant times
    sigma_dir_max, each tentative collision accepted against the density
    times dir_factor along the ray, on the tracking uniforms of JAX's
    key chain; the same free flights and weights."""
    rng = np.random.default_rng(14)
    jmed, med = _fiber_media()
    n = 256
    o, d = _points(rng, n, -0.9, 0.9), _dirs(rng, n)
    dist = rng.uniform(0.1, 3.0, n).astype(np.float32)
    dist[::5] = 1e30
    keys = jax.random.split(jax.random.key(15), n)
    jms = jax.jit(jax.vmap(lambda k, a, b, c: jgmed.sample_distance(
        jmapi.prepare(jmed), k, a, b, c)))(keys, o, d, dist)
    u_track = _t(jax.jit(jax.vmap(lambda k: jax_tracking_uniforms(
        k, gmed.TRACKING_DRAWS)))(keys))
    ms = gmed.sample_distance(med, gmed.quad_grid(med), u_track, _t(o), _t(d),
                              _t(dist))
    assert torch.equal(ms.success, _t(jms.success))
    assert 0 < int(ms.success.sum()) < n
    _close(ms.t, jms.t, atol=1e-5)
    _close(ms.weight, jms.weight, rtol=1e-4, atol=1e-6)


def _hold_volpath(jscene, scene, cfg_kw, quadrature, sir):
    """li_volpath_u against JAX's li_volpath on every pixel-centre ray of
    jscene (each on its key fold_in(key(3), i)), on the uniforms rebuilt
    from the keys: the homogeneous bar."""
    cam = jscene.camera
    px, py = np.meshgrid(np.arange(cam.width), np.arange(cam.height))
    o, d = jperspective.sample_ray(cam, jnp.asarray(px.reshape(-1)),
                                   jnp.asarray(py.reshape(-1)))
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(3), i))(
        jnp.arange(o.shape[0]))
    prepared = jmapi.prepare_scene(jscene)
    jcfg = jvolpath.VolpathConfig(**cfg_kw)
    # one ray a call: li_volpath jitted for a ray compiles in a third of
    # the time of its vmap over the frame
    one = jax.jit(lambda a, b, k: jvolpath.li_volpath(prepared, a, b, k,
                                                      jcfg))
    ref = _t(np.stack([one(o[i], d[i], keys[i]) for i in range(len(o))]))
    cfg = volpath.VolpathConfig(**cfg_kw)
    steps = volpath.n_steps(scene, cfg)
    track = 0 if quadrature else gmed.TRACKING_DRAWS
    draws = jax_volpath_uniforms(keys, steps, track, quadrature, sir)
    if not isinstance(draws, tuple):
        draws = (draws,)
    u, rest = _t(draws[0]), [_t(a) for a in draws[1:]]
    u_track = None if quadrature else rest.pop(0)
    u_sir = rest.pop(0) if sir else None
    out = volpath.li_volpath_u(scene, _t(o), _t(d), u, cfg, u_track,
                               u_sir=u_sir)
    median, share = homog_bar(out, ref)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    assert float(ref.abs().max()) > 0.0


@pytest.mark.parametrize("kind, fast_tau, oracle", [
    (jph.MICROFLAKE, True, True), (jph.KKAY, False, False)],
    ids=["microflake_oracle", "kkay_trilinear_mis"])
def test_volpath_matches_jax_in_an_oriented_medium(kind, fast_tau, oracle):
    """cornell_grid_smoke at 6x6 with an oriented 8^3 medium of the
    quadrature sampler (sampling 1): the fiber orientation at each
    medium vertex into the phase's eval, pdf and sample (the micro-flake
    sample on its SIR uniforms), the free flights and the direct
    segments' transmittance through the directional extinction; the VRL
    oracle on the micro-flake medium, the MIS tracer on the Kajiya-Kay
    one with the trilinear quadratures (fast_tau False). (Woodcock in the
    directional medium: test_woodcock_with_the_directional_majorant_
    matches; one li_volpath compile a case, about 20 s.)"""
    jmed, med = _fiber_media(kind, fast_tau=fast_tau, sampling=1)
    jscene = jpresets.cornell_grid_smoke(6, 6, grid_res=8).replace(
        medium=jmed)
    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device=CPU)
    assert gmed.oriented(scene.medium) and scene.medium.sampling == 1
    assert scene.medium.fast_tau == fast_tau
    _hold_volpath(jscene, scene, dict(max_depth=4, only_vrl_paths=oracle),
                  quadrature=True, sir=kind == jph.MICROFLAKE)


def test_vrl_routes_refuse_an_oriented_medium():
    """The JAX package's VRL tracer and pair contribution evaluate the
    phase without an orientation (a TypeError there): the port's tracer
    and kernel routes raise a ValueError saying that only volpath renders
    such a medium; volpath also refuses an oriented kind without an
    orientation volume."""
    _, med = _fiber_media()
    base = convert.scene_from_numpy(jax_scene_leaves(
        jpresets.cornell_grid_smoke(4, 4, grid_res=4)), device=CPU)
    scene = replace(base, medium=med)
    with pytest.raises(ValueError, match="only volpath"):
        tracer.trace(scene, torch.Generator(), 4)
    vrls = tracer.trace(base, torch.Generator().manual_seed(0), 4,
                        tracer.TracerConfig(max_depth=3))
    for call in (lambda: integrator.render_with_vrls_kernel(
            scene, vrls, torch.Generator()),
            lambda: integrator.render_with_vrls_kernel_diff(
                scene, vrls, torch.Generator())):
        with pytest.raises(ValueError, match="only volpath"):
            call()
    with pytest.raises(ValueError, match="orientation volume"):
        volpath.render_volpath(
            replace(base, medium=replace(base.medium, phase_kind=ph.KKAY)),
            torch.Generator(), spp=1, cfg=volpath.VolpathConfig(max_depth=2))
    with pytest.raises(TypeError):
        jph.eval_phase(jph.KKAY, 0.0, jnp.ones(3), jnp.ones(3),
                       pp=jph.kkay_params())
