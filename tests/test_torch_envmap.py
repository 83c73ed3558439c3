"""The environment lights against alvrl_tpu: the map's eval, pdf and
sampling; the Preetham sky and sun images and their map (numpy copies:
equal); an .hdr read; the ENVMAP emission, the VRL tracer lit by a sky,
and the direct sampling with its pdfs (nee_u_pdf, hit_emitter_nee_pdf,
env_nee_pdf, env_radiance), on the same uniforms. About 30 s alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvrl_tpu.emitters import emitters as jem
from alvrl_tpu.emitters import envmap as jenv
from alvrl_tpu.emitters import sunsky as jsunsky
from alvrl_tpu.integrators.vrl import tracer as jtracer
from alvrl_tpu.io import hdr as jhdr
from alvrl_tpu.scene import presets as jpresets
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.emitters import emitters as em
from alvrl_tpu_torch.emitters import envmap as env
from alvrl_tpu_torch.emitters import sunsky
from alvrl_tpu_torch.integrators.vrl import tracer
from alvrl_tpu_torch.io import image
from alvrl_tpu_torch.ops.vrl_sum import HOMOG_MEDIAN, HOMOG_SHARE, homog_bar
from tests.torch_port_utils import (
    CPU,
    jax_emission_uniforms,
    jax_scene_leaves,
    jax_tracer_uniforms,
)

torch.set_num_threads(1)

SUN = [0.3, 0.8, 0.2]


def _t(a):
    return torch.as_tensor(np.array(a))


def _image(h=16, w=32, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.gamma(0.5, 1.0, (h, w, 3)).astype(np.float32)
    img[h // 3, w // 4] = 40.0  # a bright texel
    return img


def _maps(azimuth=30.0):
    img = _image()
    return (jenv.make_envmap(img, scale=1.5, azimuth_deg=azimuth),
            env.make_envmap(img, scale=1.5, azimuth_deg=azimuth, device=CPU))


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def test_tables_match_jax():
    jmap, tmap = _maps()
    for k in ("image", "row_cdf", "cond_cdf", "pdf_map", "mean", "azimuth"):
        torch.testing.assert_close(getattr(tmap, k), _t(getattr(jmap, k)),
                                   rtol=1e-6, atol=0, msg=k)


def test_eval_pdf_sample_match_jax():
    """eval and pdf at 1,024 directions (texels equal), and sample_env at
    1,024 uniforms: directions within float32 rounding, pdf and radiance
    of the same texels; a sampled direction's pdf_env is its pdf."""
    jmap, tmap = _maps()
    d = _dirs(1024, 1)
    torch.testing.assert_close(env.eval_env(tmap, _t(d)),
                               _t(jenv.eval_env(jmap, d)), rtol=0, atol=0)
    torch.testing.assert_close(env.pdf_env(tmap, _t(d)),
                               _t(jenv.pdf_env(jmap, d)), rtol=1e-6, atol=0)
    u = np.random.default_rng(2).random((1024, 2)).astype(np.float32)
    jd, jpdf, jl = jax.vmap(lambda x: jenv.sample_env(jmap, x))(u)
    d_p, pdf_p, l_p = env.sample_env(tmap, _t(u))
    torch.testing.assert_close(d_p, _t(jd), atol=5e-6, rtol=0)
    torch.testing.assert_close(pdf_p, _t(jpdf), rtol=1e-6, atol=0)
    torch.testing.assert_close(l_p, _t(jl), rtol=1e-6, atol=0)
    inner = (env.pdf_env(tmap, d_p) - pdf_p).abs() <= 1e-6 * pdf_p
    assert float(inner.double().mean()) > 0.99  # all but texel edges


def test_sky_and_sun_are_copies():
    """The numpy models give the same bits, and the baked sky map (with
    the sun) the same tables."""
    np.testing.assert_array_equal(
        sunsky.preetham_sky_image(SUN, 3.0, 64, 32),
        jsunsky.preetham_sky_image(SUN, 3.0, 64, 32))
    np.testing.assert_array_equal(sunsky.sun_rgb_radiance(SUN, 4.0, 2.0),
                                  jsunsky.sun_rgb_radiance(SUN, 4.0, 2.0))
    assert sunsky.SUN_SOLID_ANGLE == jsunsky.SUN_SOLID_ANGLE
    img = sunsky.preetham_sky_image(SUN, 3.0, 64, 32)
    rad = sunsky.sun_rgb_radiance(SUN)
    np.testing.assert_array_equal(sunsky.splat_sun(img, SUN, rad),
                                  jsunsky.splat_sun(img, SUN, rad))
    jmap = jsunsky.sky_envmap(SUN, width=64, height=32, with_sun=True)
    tmap = sunsky.sky_envmap(SUN, width=64, height=32, with_sun=True,
                             device=CPU)
    for k in ("image", "row_cdf", "cond_cdf", "pdf_map", "mean"):
        torch.testing.assert_close(getattr(tmap, k), _t(getattr(jmap, k)),
                                   rtol=1e-6, atol=0, msg=k)


def test_hdr_read_matches_jax(tmp_path):
    img = _image(8, 12)
    path = tmp_path / "sky.hdr"
    jhdr.write_hdr(str(path), img)
    ours = image.read_image(str(path))
    np.testing.assert_array_equal(ours, jhdr.read_hdr(str(path)))
    # RGBE keeps 8 mantissa bits a channel, truncated
    np.testing.assert_allclose(ours, img, rtol=2e-2, atol=3e-2)
    with pytest.raises(ValueError, match="A11"):
        image.read_image(str(tmp_path / "x.exr"))


def _tables():
    """A point light, an area triangle, a constant light and the
    environment map, in both packages."""
    jmap, _ = _maps(0.0)
    args = ([jem.POINT, jem.AREA, jem.CONSTANT, jem.ENVMAP],
            [[0, 0.7, 0.1], [-0.2, 0.9, -0.2], [0, 0, 0], [0, 0, 0]],
            [[5, 5, 5], [3, 3, 3], [0.2, 0.3, 0.4], [1, 1, 1]])
    kw = dict(tri_e1=[[0, 0, 0], [0.4, 0, 0], [0, 0, 0], [0, 0, 0]],
              tri_e2=[[0, 0, 0], [0, 0, 0.4], [0, 0, 0], [0, 0, 0]])
    jt = jem.make_emitters(*args, env=jmap, **kw)
    tt = em.make_emitters(*args, env=env.make_envmap(_image(), scale=1.5,
                                                     device=CPU),
                          device=CPU, **kw)
    return jt, tt


def test_table_pmf_matches_jax():
    jt, tt = _tables()
    torch.testing.assert_close(tt.pmf, _t(jt.pmf), rtol=1e-6, atol=0)


def test_nee_matches_jax():
    """nee_u_pdf at 1,024 points and uniforms: direction, value, distance,
    pdf and misable; then hit_emitter_nee_pdf, env_nee_pdf and
    env_radiance."""
    jt, tt = _tables()
    rng = np.random.default_rng(4)
    p = rng.uniform(-0.8, 0.8, (1024, 3)).astype(np.float32)
    u3 = rng.random((1024, 3)).astype(np.float32)
    ref = jax.vmap(lambda a, b: jem.nee_u_pdf(jt, a, b, 1.7))(u3, p)
    out = em.nee_u_pdf(tt, _t(u3), _t(p), 1.7)
    idx = em.choose(tt, _t(u3[:, 0]))
    assert set(idx.tolist()) == {0, 1, 2, 3}
    for a, b, name in zip(out, ref, ("d", "v", "dist", "pdf", "misable")):
        if name == "misable":
            assert torch.equal(a, _t(b))
        else:
            torch.testing.assert_close(a, _t(b), rtol=2e-5, atol=1e-6,
                                       msg=name)
    d = _dirs(512, 5)
    torch.testing.assert_close(em.env_nee_pdf(tt, _t(d)),
                               _t(jem.env_nee_pdf(jt, d)), rtol=1e-6, atol=0)
    torch.testing.assert_close(em.env_radiance(tt, _t(d)),
                               _t(jem.env_radiance(jt, d)), rtol=1e-6, atol=0)
    eid = rng.integers(-1, 4, 512)
    dist = rng.uniform(0.1, 2.0, 512).astype(np.float32)
    cos = rng.uniform(0.0, 1.0, 512).astype(np.float32)
    torch.testing.assert_close(
        em.hit_emitter_nee_pdf(tt, _t(eid), _t(dist), _t(cos)),
        _t(jem.hit_emitter_nee_pdf(jt, eid, dist, cos)), rtol=1e-6, atol=0)


def test_envmap_emission_matches_jax():
    """sample_emission_u against JAX's sample_emission on its own keys
    (jax_emission_uniforms, the choice through the pmf): the map's
    photons start on the disk at 1.5 R and travel along -d."""
    jt, tt = _tables()
    keys = jax.random.split(jax.random.key(9), 512)
    ref = jax.vmap(lambda k: jem.sample_emission(jt, k, jnp.zeros(3), 1.7))(
        keys)
    u = jax.vmap(lambda k: jax_emission_uniforms(k, jt.pmf))(keys)
    out = em.sample_emission_u(tt, _t(u), torch.zeros(3), 1.7)
    kind = tt.kind[em.choose(tt, _t(u)[:, 0])]
    assert int((kind == em.ENVMAP).sum()) > 50
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, _t(b), rtol=2e-5, atol=2e-5)


def test_trace_matches_jax_under_a_sky():
    """cornell_smoke lit by its point light and a sunsky map, on JAX's
    own random numbers: the VRL buffer at the homogeneous bar, validity
    equal, particles from both lights."""
    jbase = jpresets.cornell_smoke(8, 8)
    jmap = jsunsky.sky_envmap(SUN, width=32, height=16, with_sun=True)
    jtable = jem.make_emitters([jem.POINT, jem.ENVMAP],
                               [[0.0, 0.75, 0.2], [0, 0, 0]],
                               [[8, 8, 8], [1, 1, 1]], env=jmap)
    jscene = jbase.replace(emitters=jtable)
    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device=CPU)
    key = jax.random.key(22)
    n, depth = 64, 5
    ref = jtracer.trace(jscene, key, n, jtracer.TracerConfig(max_depth=depth))
    u_emit, u_walk = jax_tracer_uniforms(key, n, depth, pmf=jtable.pmf)
    out = tracer.trace_u(scene, _t(u_emit), _t(u_walk),
                         tracer.TracerConfig(max_depth=depth))
    assert torch.equal(out.valid, _t(ref.valid))
    ok = out.valid
    assert int(ok.sum()) > 100
    torch.testing.assert_close(out.start[ok], _t(ref.start)[ok], atol=2e-5,
                               rtol=2e-5)
    median, share = homog_bar(out.power[ok], _t(ref.power)[ok])
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    first = out.start.reshape(n, depth, 3)[:, 0]
    from_sky = first.abs().amax(dim=-1) > 1.01
    assert 0 < int(from_sky.sum()) < n


def test_c17_segments_end_where_the_photons_start():
    """nee_u with the bounding sphere's centre (ROADMAP C17): a map
    direction's segment ends on the emission disk's plane, 1.5 R along it
    from the centre, and a point outside the cylinder the disk's photons
    sweep gets none of the map's light; the other kinds' samples are
    JAX's; without the centre all are JAX's (the test above)."""
    _, tt = _tables()
    rng = np.random.default_rng(6)
    p = _t(rng.uniform(-0.8, 0.8, (1024, 3)).astype(np.float32))
    p[:64] *= 4.0  # far outside the bounding sphere
    u3 = _t(rng.random((1024, 3)).astype(np.float32))
    c, r = torch.tensor([0.1, -0.2, 0.05]), 1.7
    d0, v0, t0, pdf0, _ = em.nee_u_pdf(tt, u3, p, r)
    d1, v1, t1, pdf1, _ = em.nee_u_pdf(tt, u3, p, r, center=c)
    kind = tt.kind[em.choose(tt, u3[:, 0])]
    assert torch.equal(d0, d1) and torch.equal(pdf0, pdf1)
    env = kind == em.ENVMAP
    q = p - c
    along = (q * d1).sum(-1)
    lit = env & (1.5 * r - along > 0) & ((q * q).sum(-1) - along ** 2
                                         <= r * r)
    torch.testing.assert_close(t1[lit], 1.5 * r - along[lit])
    assert torch.equal(v1[lit], v0[lit])
    assert not v1[env & ~lit].any() and bool((env & ~lit).any())
    assert int(lit[64:].sum()) == int(env[64:].sum())  # inside: all lit
    assert torch.equal(t0[~env], t1[~env]) and torch.equal(v0[~env],
                                                           v1[~env])
