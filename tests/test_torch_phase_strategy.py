"""The mixture phase and the homogeneous medium's sampling strategies
against alvrl_tpu: the mixture's eval, pdf and sample (an absorbing
mixture too), sample_distance_u and eval_ray for the four strategies,
and the plain versions of kernels 1, 2 and 5 on a mixture medium of the
single strategy against JAX's XLA route (ROADMAP C16: JAX's Pallas
kernels evaluate a mixture as HG(g) and the balance pdfFailure; the port
follows the XLA route, which the JAX CLI renders). About 60 s alone, most
of it JAX's compiles and the Pallas reference in its child process.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvrl_tpu.integrators.vrl import integrator as jintegrator
from alvrl_tpu.integrators.vrl import vrl as jvrl
from alvrl_tpu.integrators.vrl.integrate import VRLConfig as JVRLConfig
from alvrl_tpu.media import homogeneous as jhmed
from alvrl_tpu.media import phase as jph
from alvrl_tpu.scene import loader as jloader
from alvrl_tpu.sensors import perspective as jperspective
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.integrators.vrl import integrator
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.media import homogeneous as hmed
from alvrl_tpu_torch.media import phase as ph
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops import vrl_sum as vs
from alvrl_tpu_torch.scene import loader
from tests.test_torch_glossy import _jax_uniforms
from tests.torch_port_utils import (
    BENCH_VRLS,
    CPU,
    SEQ_UNIFORMS,
    in_child,
    jax_vrls_leaves,
)

torch.set_num_threads(1)

N_VRLS = 128
# an absorbing two-lobe mixture (weights sum 0.9): HG 0.8 and Rayleigh
MIX = {"type": "mixture", "components": [
    {"type": "hg", "g": 0.8, "weight": 0.6},
    {"type": "rayleigh", "weight": 0.3}]}
SCENE = {
    "camera": {"type": "perspective", "origin": [0, 0, -0.99],
               "target": [0, 0, 1], "fov": 90, "width": 8, "height": 8},
    "medium": {"type": "homogeneous", "sigma_s": [0.8, 0.6, 0.7],
               "sigma_a": [0.05, 0.1, 0.02], "phase": MIX,
               "strategy": "single", "channel": 1},
    "materials": [{"name": "white", "type": "diffuse",
                   "albedo": [0.7, 0.7, 0.7]}],
    "shapes": [{"type": "cube", "material": "white", "flip_normals": True},
               {"type": "cube", "material": "white",
                "to_world": [[0.25, 0, 0, -0.3], [0, 0.5, 0, -0.5],
                             [0, 0, 0.25, 0.3], [0, 0, 0, 1]]}],
    "emitters": [{"type": "point", "position": [0, 0.75, 0.2],
                  "intensity": [8, 8, 8]}],
}


def _t(a):
    return torch.as_tensor(np.array(a))


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("weights", [(0.6, 0.3), (0.5, 0.5), (2.0, 1.0)])
def test_mixture_matches_jax(weights):
    """eval, pdf (the reference's pdf_phase, eval for the mixture) and
    sample, absorbing (sum 0.9), exact (sum 1) and rescaled (sum 3):
    within float32 rounding; the sample's weight is the weights' sum."""
    kinds, gs = [jph.HG, jph.RAYLEIGH], [0.7, 0.0]
    jpp = jph.mixture_params(weights, kinds, gs)
    pp = ph.mixture_params(weights, kinds, gs, device=CPU)
    np.testing.assert_array_equal(pp.mix_w.numpy(), np.asarray(jpp.mix_w))
    wi, wo = _dirs(256, 1), _dirs(256, 2)
    for jf, f in ((jph.eval_mixture, ph.eval_mixture),
                  (jph.pdf_mixture, ph.pdf_mixture)):
        torch.testing.assert_close(f(pp, _t(wi), _t(wo)),
                                   _t(jf(jpp, wi, wo)), rtol=2e-6, atol=0)
    torch.testing.assert_close(
        ph.pdf_phase(ph.MIXTURE, None, _t(wi), _t(wo), pp=pp),
        _t(jph.pdf_phase(jph.MIXTURE, None, wi, wo, pp=jpp)), rtol=2e-6,
        atol=0)
    u2 = np.random.default_rng(3).random((256, 2)).astype(np.float32)
    jwo, jw, jpdf = jax.vmap(lambda a, u: jph.sample_mixture(jpp, a, u))(
        wi, u2)
    wo_p, w_p, pdf_p = ph.sample_mixture(pp, _t(wi), _t(u2))
    torch.testing.assert_close(wo_p, _t(jwo), atol=2e-6, rtol=0)
    torch.testing.assert_close(w_p, _t(jw), rtol=1e-7, atol=0)
    torch.testing.assert_close(pdf_p, _t(jpdf), rtol=1e-5, atol=0)
    assert float(w_p[0]) == pytest.approx(min(sum(weights), 1.0), rel=1e-6)


@pytest.mark.parametrize("strategy", [jhmed.BALANCE, jhmed.SINGLE,
                                      jhmed.MANUAL, jhmed.MAXIMUM])
def test_strategies_match_jax(strategy):
    """sample_distance_u (its distance, success, transmittance and pdfs)
    and eval_ray for each strategy on the same uniforms and lengths."""
    args = dict(sigma_a=[0.05, 0.3, 0.1], sigma_s=[0.9, 0.4, 0.6], g=0.2,
                strategy=strategy, channel=2, density=0.45)
    jmed = jhmed.make_medium(**args)
    med = hmed.make_medium(**args, device=CPU)
    rng = np.random.default_rng(strategy)
    u2 = rng.random((512, 2)).astype(np.float32)
    dist = rng.uniform(0.01, 4.0, 512).astype(np.float32)
    dist[::7] = 1e30  # rays that leave the scene
    ref = jhmed.sample_distance_u(jmed, jnp.asarray(u2), jnp.asarray(dist))
    out = hmed.sample_distance_u(med, _t(u2), _t(dist))
    assert torch.equal(out.success, _t(ref.success))
    for k in ("t", "transmittance", "pdf_success", "pdf_failure"):
        torch.testing.assert_close(getattr(out, k), _t(getattr(ref, k)),
                                   rtol=2e-6, atol=1e-30, msg=k)
    d = rng.uniform(0.0, 3.0, 512).astype(np.float32)
    for a, b in zip(hmed.eval_ray(med, _t(d)),
                    jhmed.eval_ray(jmed, jnp.asarray(d))):
        torch.testing.assert_close(a, _t(b), rtol=2e-6, atol=1e-30)


@functools.lru_cache(maxsize=None)
def _scenes():
    desc = json.loads(json.dumps(SCENE))
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


@functools.lru_cache(maxsize=None)
def _xla_reference():
    """JAX's XLA li_unclustered (the route its CLI renders) on key 3, and
    its uniforms in the port's layout."""
    jscene, _ = _scenes()
    jv, _ = _vrls()
    ray_o, ray_d = _rays()
    jcfg = JVRLConfig(vrl_chunk=32)
    key = jax.random.key(3)
    ref = jax.jit(jintegrator.li_unclustered, static_argnames=("cfg",))(
        jscene, ray_o, ray_d, jv, key, cfg=jcfg)
    return _t(ref), _jax_uniforms(key, 64, N_VRLS, jcfg)


def test_the_scene_carries_the_mixture_and_the_strategy():
    jscene, scene = _scenes()
    med = scene.medium
    assert med.phase_kind == ph.MIXTURE and med.strategy == hmed.SINGLE
    np.testing.assert_array_equal(med.phase_params.mix_w.numpy(),
                                  np.asarray(jscene.medium.phase_params.mix_w))
    pack = pk.pack_medium(scene)
    # base, rate (sigma_t of channel 1), K = 2, two (w, kind, g) triples
    assert pack.shape == (pk.MED_MIX + 6,)
    assert float(pack[pk.MED_RHO]) == pytest.approx(0.7)
    assert pack[pk.MED_K] == 2 and pack[pk.MED_MIX + 4] == ph.RAYLEIGH


def test_kernel1_plain_matches_jax_xla():
    """render_with_vrls_kernel (kernel 1's PHASE = 2 form: its plain
    version on the CPU) against JAX's XLA li_unclustered on its uniforms:
    the homogeneous bar; the image differs from the HG(g) balance one."""
    _, scene = _scenes()
    _, vrls = _vrls()
    ref, u = _xla_reference()
    img = integrator.render_with_vrls_kernel(
        scene, vrls, torch.Generator().manual_seed(0), VRLConfig(),
        uniforms=u)
    median, share = vs.homog_bar(img.reshape(-1, 3), ref.reshape(-1, 3))
    assert median < vs.HOMOG_MEDIAN and share < vs.HOMOG_SHARE, (median,
                                                                 share)
    from dataclasses import replace
    hg = replace(scene, medium=replace(scene.medium, phase_kind=ph.HG,
                                       strategy=hmed.BALANCE,
                                       phase_params=None))
    img_hg = integrator.render_with_vrls_kernel(
        hg, vrls, torch.Generator().manual_seed(0), VRLConfig(), uniforms=u)
    assert float((img_hg - img).abs().max()) > 1e-2 * float(img.abs().max())


def test_kernel2_and_kernel5_plain_match_the_kernel1_route():
    """render_clustered_kernel with each pixel's row every VRL at weight
    1, and build_R_kernel's mean summed over the VRLs, equal kernel 1's
    plain route on the same uniforms (the three reduce one estimator),
    which the previous test holds against JAX's XLA route."""
    _, scene = _scenes()
    _, vrls = _vrls()
    ref, u = _xla_reference()
    ids = torch.arange(N_VRLS, dtype=torch.int32).expand(64, -1).contiguous()
    w = torch.ones((64, N_VRLS))
    img = integrator.render_clustered_kernel(
        scene, vrls, np.arange(64, dtype=np.int32), ids, w,
        torch.Generator().manual_seed(0), uniforms=u)
    median, share = vs.homog_bar(img.reshape(-1, 3), ref.reshape(-1, 3))
    assert median < vs.HOMOG_MEDIAN and share < vs.HOMOG_SHARE
    ray_o, ray_d = (_t(a) for a in _rays())
    mean, _ = integrator.build_R_kernel(scene, ray_o, ray_d, vrls, 0,
                                        uniforms=u)
    lum = (ref.reshape(-1, 3) * torch.tensor(
        [0.212671, 0.715160, 0.072169])).sum(-1)
    median, share = vs.homog_bar(mean.sum(1), lum, channels=1)
    assert median < vs.HOMOG_MEDIAN and share < vs.HOMOG_SHARE


def _pallas_pinned(desc_json, n_vrls):
    """JAX's Pallas route (render_with_vrls_pallas in interpret mode) on
    the scene of desc_json, the kernel's _u01 returning the next
    SEQ_UNIFORMS constant at each call while traced (jit caches cleared
    around the patch), as numpy. Run by in_child."""
    import alvrl_tpu.ops.vrl_pallas as vp
    from jax.experimental.pallas import tpu as pltpu

    counter = {"i": 0}

    def mock(shape):
        v = SEQ_UNIFORMS[counter["i"] % len(SEQ_UNIFORMS)]
        counter["i"] += 1
        return jnp.full(shape, v, jnp.float32)

    full = jvrl.load_ascii(BENCH_VRLS, particle_count=78.0)
    jv = full.replace(start=full.start[:n_vrls], end=full.end[:n_vrls],
                      power=full.power[:n_vrls], valid=full.valid[:n_vrls])
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp, \
            pltpu.force_tpu_interpret_mode():
        mp.setattr(vp, "_u01", mock)
        img = np.asarray(jintegrator.render_with_vrls_pallas(
            jloader.build_scene(json.loads(desc_json)), jv,
            jax.random.key(1), JVRLConfig()))
    jax.clear_caches()
    return img


def test_c16_jax_pallas_route_differs_from_its_xla_route():
    """ROADMAP C16: on the mixture medium of the single strategy, JAX's
    Pallas kernels compute HG(g) with the balance pdfFailure. On pinned
    uniforms (SEQ_UNIFORMS, every pair's draws) the Pallas image equals
    the port's plain kernel-1 route on that HG balance medium, and not
    the port's on the mixture, which the tests above hold to JAX's XLA
    route: the port follows the XLA route, which the JAX CLI renders."""
    jscene, scene = _scenes()
    _, vrls = _vrls()
    pallas = _t(in_child(_pallas_pinned, json.dumps(SCENE), N_VRLS))
    u = torch.tensor(SEQ_UNIFORMS).expand(64, N_VRLS, 6).contiguous()

    def port(sc):
        return integrator.render_with_vrls_kernel(
            sc, vrls, torch.Generator().manual_seed(0), VRLConfig(),
            uniforms=u)

    from dataclasses import replace
    hg = replace(scene, medium=replace(scene.medium, phase_kind=ph.HG,
                                       strategy=hmed.BALANCE,
                                       phase_params=None))
    median, share = vs.homog_bar(port(hg).reshape(-1, 3),
                                 pallas.reshape(-1, 3))
    assert median < vs.HOMOG_MEDIAN and share < vs.HOMOG_SHARE, (median,
                                                                 share)
    median, _ = vs.homog_bar(port(scene).reshape(-1, 3),
                             pallas.reshape(-1, 3))
    assert median > 1e-2, median
