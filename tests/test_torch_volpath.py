"""The volumetric path tracer (integrators/volpath.py) against
alvrl_tpu's li_volpath, ray by ray, on JAX's own random numbers
(torch_port_utils.jax_volpath_uniforms rebuilds its key tree): the VRL
oracle (only_vrl_paths) on cornell_smoke, the MIS tracer on
cornell_area_light (with single_scatter and first_emission=False too),
and on a glossy and glass table; the homogeneous bar (median rel < 1e-5,
< 2 % of pixels over 1e-2). One JAX compile a case, 40-50 s each on a
loaded host: about 190 s alone. The grid and nested media and the path
and direct renders: tests/test_torch_volpath_media.py; the sky:
tests/test_torch_volpath_sky.py."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvrl_tpu.integrators import volpath as jvolpath
from alvrl_tpu.scene import loader as jloader
from alvrl_tpu.scene import presets as jpresets
from alvrl_tpu.sensors import perspective as jperspective
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.integrators import volpath
from alvrl_tpu_torch.ops.vrl_sum import HOMOG_MEDIAN, HOMOG_SHARE, homog_bar
from alvrl_tpu_torch.scene import loader
from tests.torch_port_utils import (
    CPU,
    SMOOTH_MATERIALS,
    glossy_scene_desc,
    jax_scene_leaves,
    jax_volpath_uniforms,
)

torch.set_num_threads(1)

W = 6


def _t(a):
    return torch.as_tensor(np.array(a))


def hold(jscene, scene, cfg_kw, seed=3, tracking_steps=0):
    """li_volpath_u against JAX's li_volpath on every pixel-centre ray of
    jscene, each ray on its key fold_in(key(seed), i): the homogeneous
    bar; returns the port's radiance (the map's direct segments end at
    2.5 R on both sides: li_volpath_u's default, ROADMAP C17)."""
    cam = jscene.camera
    px, py = np.meshgrid(np.arange(cam.width), np.arange(cam.height))
    o, d = jperspective.sample_ray(cam, jnp.asarray(px.reshape(-1)),
                                   jnp.asarray(py.reshape(-1)))
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(
        jnp.arange(o.shape[0]))
    from alvrl_tpu.media import api as jmapi

    prepared = jmapi.prepare_scene(jscene)
    jcfg = jvolpath.VolpathConfig(**cfg_kw)
    ref = jax.jit(jax.vmap(lambda a, b, k: jvolpath.li_volpath(
        prepared, a, b, k, jcfg)))(o, d, keys)
    cfg = volpath.VolpathConfig(**cfg_kw)
    steps = volpath.n_steps(scene, cfg)
    u_track = None
    if tracking_steps:
        u, u_track = jax_volpath_uniforms(keys, steps, tracking_steps)
        u_track = _t(u_track)
    else:
        u = jax_volpath_uniforms(keys, steps)
    out = volpath.li_volpath_u(scene, _t(o), _t(d), _t(u), cfg, u_track)
    ref = _t(ref)
    median, share = homog_bar(out, ref)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    assert float(ref.abs().max()) > 0.0
    return out


def _converted(jscene):
    return convert.scene_from_numpy(jax_scene_leaves(jscene), device=CPU)


def test_oracle_matches_jax_on_cornell_smoke():
    """The VRL oracle: its gates (the precedence quirk included) and the
    point light's direct sampling through the smoke."""
    jscene = jpresets.cornell_smoke(W, W)
    hold(jscene, _converted(jscene), dict(max_depth=5))


@pytest.mark.parametrize("cfg_kw", [
    dict(max_depth=5, only_vrl_paths=False),
    dict(max_depth=4, only_vrl_paths=False, single_scatter=True,
         first_emission=False)], ids=["mis", "single_scatter"])
def test_mis_tracer_matches_jax_on_the_area_light(cfg_kw):
    """The plain tracer's MIS between the area light's direct sampling
    and BSDF / phase sampling, the light's faces seen and hit."""
    jscene = jpresets.cornell_area_light(W, W)
    scene = _converted(jscene)
    assert int((scene.face_emitters() >= 0).sum()) == 2
    hold(jscene, scene, cfg_kw)


def test_mis_tracer_matches_jax_on_glossy_and_glass():
    """The glossy table of test_torch_glossy.py with a glass sphere, both
    packages built by their loaders: the smooth kinds' eval and pdf in
    the MIS weights, the dielectric's delta bounces (the initial one
    takes no depth)."""
    desc = glossy_scene_desc(W, W)
    desc["materials"] = SMOOTH_MATERIALS + [
        {"name": "glass", "type": "dielectric", "eta": 1.5}]
    for sh in desc["shapes"]:
        if sh.get("material") == "rd":
            sh.update(material="glass", radius=0.35,
                      center=[-0.25, 0.25, -0.1])
    jscene = jloader.build_scene(json.loads(json.dumps(desc)))
    scene = loader.build_scene(json.loads(json.dumps(desc)), device=CPU)
    hold(jscene, scene, dict(max_depth=4, only_vrl_paths=False))
