"""The port's grid medium and its Woodcock tracer against alvrl_tpu.

The medium functions (upsample2, the nearest and trilinear lookups, the
optical-depth quadratures and tables, the transmittance) take the same
numpy-made densities and points in both packages; Woodcock tracking
takes the uniforms the JAX package draws from its key chain
(torch_port_utils.jax_tracking_uniforms), so the two take the same steps
and must give the same free flights. Also the config-4 preset and the
grid packs. The tracer: tests/test_torch_hetero_tracer.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvrl_tpu.integrators.vrl import integrator as jintegrator
from alvrl_tpu.integrators.vrl import vrl as jvrl
from alvrl_tpu.media import api as jmapi
from alvrl_tpu.media import heterogeneous as jgmed
from alvrl_tpu.ops import pack as jpk
from alvrl_tpu.ops import vrl_pallas as vp
from alvrl_tpu.scene import presets as jpresets
from alvrl_tpu.sensors import perspective as jperspective
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.media import api as mapi
from alvrl_tpu_torch.media import heterogeneous as gmed
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.scene import presets
from tests.torch_port_utils import (
    BENCH_VRLS,
    hit_from_jax,
    jax_scene_leaves,
    jax_tracking_uniforms,
    jax_vrls_leaves,
)

torch.set_num_threads(1)

RTOL = 1e-6  # the medium functions: float32 rounding of the same sums


def _t(a):
    return torch.as_tensor(np.array(a))


def _media(grid_res=8, scale=1.0, box=((-1, -1, -1), (1, 1, 1))):
    """(JAX, port) grid media on one numpy density: the config-4 plume
    at grid_res, or with box and scale changed, a random field."""
    if box == ((-1, -1, -1), (1, 1, 1)) and scale == 1.0:
        jmed = jpresets.cornell_grid_smoke(4, 4, grid_res=grid_res).medium
    else:
        dens = np.random.default_rng(1).uniform(
            0.0, 3.0, (grid_res, grid_res + 2, grid_res + 1))
        jmed = jgmed.make_grid_medium(dens.astype(np.float32),
                                      [0.9, 1.0, 1.2], [0.8, 0.9, 0.95],
                                      g=0.2, box_min=box[0], box_max=box[1],
                                      scale=scale)
    med = gmed.make_grid_medium(
        np.asarray(jmed.density), np.asarray(jmed.sigma_t_color),
        np.asarray(jmed.albedo), np.asarray(jmed.g), np.asarray(jmed.box_min),
        np.asarray(jmed.box_max), np.asarray(jmed.scale), device="cpu")
    return jmed, med


def _points(n, seed, lo=-1.3, hi=1.3):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(
        np.float32)


MEDIA = {"plume": {}, "random_box": dict(
    scale=1.7, box=((-1, -0.5, -1), (1, 1.5, 1)))}


def _close(out, ref, rtol=RTOL, atol=0.0):
    torch.testing.assert_close(out, _t(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("medium", sorted(MEDIA))
def test_upsample_and_lookups_match(medium):
    """upsample2 exactly; the nearest and trilinear lookups at points
    inside and outside the box to RTOL."""
    jmed, med = _media(**MEDIA[medium])
    dss = gmed.upsample2(med.density)
    assert torch.equal(dss, _t(jgmed._upsample2(jmed.density)))
    p = _points(4096, 2)
    nn = gmed.lookup_density_nn(med, dss, _t(p))
    tri = gmed.lookup_density(med, _t(p))
    _close(nn, jgmed.lookup_density_nn(jmed, jnp.asarray(p)))
    _close(tri, jgmed.lookup_density(jmed, jnp.asarray(p)), atol=1e-6)
    assert 0 < int((nn == 0).sum()) < 4096 and float(tri.max()) > 0.0
    assert float(med.max_density) == float(jmed.max_density)


@pytest.mark.parametrize("medium", sorted(MEDIA))
def test_optical_depth_tables_match(medium):
    """optical_depth, cumulative_od, interp_od and eval_transmittance on
    segments through, into and beside the box, some of length 0."""
    jmed, med = _media(**MEDIA[medium])
    dss = gmed.upsample2(med.density)
    p0, p1 = _points(512, 3), _points(512, 4)
    p1[::9] = p0[::9]
    frac = np.random.default_rng(5).uniform(-0.2, 1.2, 512).astype(np.float32)
    j0, j1 = jnp.asarray(p0), jnp.asarray(p1)
    cum = gmed.cumulative_od(med, dss, _t(p0), _t(p1))
    jcum = jgmed.cumulative_od(jmed, j0, j1)
    _close(cum, jcum, atol=1e-6)
    _close(gmed.optical_depth(med, dss, _t(p0), _t(p1)),
           jgmed.optical_depth(jmed, j0, j1), atol=1e-6)
    _close(gmed.optical_depth(med, dss, _t(p0), _t(p1), 4),
           jgmed.optical_depth(jmed, j0, j1, n_steps=4), atol=1e-6)
    _close(gmed.interp_od(cum, _t(frac)),
           jgmed.interp_od(jcum, jnp.asarray(frac)), atol=1e-6)
    # exp(-sigma od) carries od's rounding times sigma od (up to ~4 here)
    _close(mapi.transmittance(med, _t(p0), _t(p1), dss),
           jmapi.transmittance(jmed, j0, j1), atol=1e-8)
    _close(mapi.sigma_s_at(med, _t(p0), dss), jmapi.sigma_s_at(jmed, j0))
    assert float(cum[:, -1].max()) > 0.5


@pytest.mark.parametrize("medium", sorted(MEDIA))
def test_woodcock_matches_on_the_key_chain(medium):
    """sample_distance from the uniforms of the JAX key chain: the same
    success, distance, point and weights, for segments that end inside,
    beyond or outside the box, miss (1e30) or are tiny."""
    jmed, med = _media(**MEDIA[medium])
    n = 256
    rng = np.random.default_rng(6)
    o = _points(n, 7, -0.9, 0.9)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = rng.uniform(0.0, 3.0, n).astype(np.float32)
    dist[::11] = 1e30
    dist[1::11] = 1e-4
    keys = jax.random.split(jax.random.key(8), n)
    ref = jax.vmap(lambda k, a, b, c: jgmed.sample_distance(jmed, k, a, b, c))(
        keys, jnp.asarray(o), jnp.asarray(d), jnp.asarray(dist))
    u = jax.vmap(lambda k: jax_tracking_uniforms(k, gmed.TRACKING_DRAWS))(keys)
    out = gmed.sample_distance(med, gmed.upsample2(med.density), _t(u), _t(o),
                               _t(d), _t(dist))
    assert torch.equal(out.success, _t(ref.success))
    assert 0 < int(out.success.sum()) < n
    for k in ("t", "p", "transmittance", "pdf_success", "pdf_failure",
              "sigma_s", "weight"):
        _close(getattr(out, k), getattr(ref, k), rtol=1e-5, atol=1e-5)


def test_frozen_lanes_stay_put():
    """Lanes that `active` marks False take no tracking step."""
    _, med = _media()
    u = torch.full((4, gmed.TRACKING_DRAWS, 2), 0.5)
    out = gmed.sample_distance(med, gmed.upsample2(med.density), u,
                               torch.zeros(4, 3), torch.tensor([[1.0, 0, 0]]
                                                               * 4),
                               torch.full((4,), 2.0),
                               active=torch.tensor([True, False] * 2))
    assert (out.t[1::2] == 0).all() and (out.t[::2] > 0).all()


def test_cornell_grid_smoke_matches_jax_preset():
    jscene = jpresets.cornell_grid_smoke(width=12, height=8, grid_res=8)
    ours = presets.cornell_grid_smoke(12, 8, grid_res=8, device="cpu")
    ref = convert.scene_from_numpy(jax_scene_leaves(jscene), device="cpu")
    for k in ("vertices", "faces", "material"):
        assert torch.equal(getattr(ours, k), getattr(ref, k)), k
    for k in ("density", "sigma_t_color", "albedo", "g", "box_min",
              "box_max", "scale", "max_density"):
        assert torch.equal(getattr(ours.medium, k), getattr(ref.medium, k)), k
    assert ours.medium.phase_kind == ref.medium.phase_kind == 0
    assert ours.faces.shape[0] == 12  # no blocker


def test_grid_packs_match_jax():
    """pack_rays_hetero, pack_vrls_hetero and pack_medium_hetero against
    the JAX package's grid packs, row by row (the port's layout)."""
    jscene = jmapi.prepare_scene(
        jpresets.cornell_grid_smoke(width=8, height=8, grid_res=8))
    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device="cpu")
    dss = gmed.upsample2(scene.medium.density)
    px, py = jnp.meshgrid(jnp.arange(8), jnp.arange(8))
    ray_o, ray_d = jperspective.sample_ray(jscene.camera, px.reshape(-1),
                                           py.reshape(-1))
    jhit = jintegrator.trace_eye_rays(jscene, ray_o, ray_d)
    rays = pk.pack_rays_hetero(
        scene, _t(ray_o), _t(ray_d), hit_from_jax(jhit),
        torch.as_tensor(np.asarray(jhit.mat), dtype=torch.int64), dss)
    jrays = np.asarray(jpk.pack_rays_hetero(jscene, ray_o, ray_d, jhit))[:64]
    assert rays.shape == (pk.GRID_RAY_ROWS, 64)
    for ours, theirs, n in ((pk.RO, vp._RO, 15), (pk.VALID, vp._VALID, 1),
                            (pk.TAU, vp._TAU, 3),
                            (pk.EOD, vp._EOD, pk.NQ + 1)):
        _close(rays[ours:ours + n].T, jrays[:, theirs:theirs + n], atol=1e-6)
    full = jvrl.load_ascii(BENCH_VRLS, particle_count=78.0)
    jvrls = full.replace(start=full.start[:32], end=full.end[:32],
                         power=full.power[:32], valid=full.valid[:32])
    vrls = convert.vrls_from_numpy(jax_vrls_leaves(jvrls), device="cpu")
    jv = np.asarray(jpk.pack_vrls_hetero(jvrls, jscene.medium))[:, :32]
    v = pk.pack_vrls_hetero(vrls, scene.medium, dss)
    assert v.shape == (pk.GRID_VRL_ROWS, 32)
    _close(v[:pk.VOD], jv[:pk.VOD], atol=1e-6)
    _close(v[pk.VOD:], jv[vp._VOD:vp._VOD + pk.NQ + 1], atol=1e-6)
    jm = np.asarray(jpk.pack_medium_hetero(jscene.medium))[0]
    m = pk.pack_medium_hetero(scene.medium)
    assert m.shape == (pk.GRID_MED_LEN,)
    _close(m[:17], jm[:17])
    assert float(m[17]) == float(jscene.medium.scale)
