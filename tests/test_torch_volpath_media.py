"""The volumetric path tracer in a grid medium (Woodcock tracking on
JAX's own tracking uniforms) and in per-shape nested media, and the
surface integrators render_path and render_direct, against alvrl_tpu on
JAX's random numbers (tests/test_torch_volpath.py's hold); the nested
no-op crossing of tests/test_nested_media.py:45 on the port. About 100 s
alone, most of it JAX's compiles."""

import jax
import numpy as np
import torch

from alvrl_tpu.integrators import surface as jsurface
from alvrl_tpu.scene import presets as jpresets
from alvrl_tpu_torch.integrators import surface, volpath
from alvrl_tpu_torch.media import heterogeneous as gmed
from alvrl_tpu_torch.ops.vrl_sum import HOMOG_MEDIAN, HOMOG_SHARE, homog_bar
from alvrl_tpu_torch.scene import presets
from tests.test_torch_volpath import _converted, _t, hold
from tests.torch_port_utils import (
    CPU,
    jax_render_keys,
    jax_volpath_uniforms,
)

torch.set_num_threads(1)


def test_oracle_matches_jax_in_a_grid_medium():
    """cornell_grid_smoke at 6x6 with an 8^3 plume: Woodcock tracking
    from each step's distance key, the grid transmittance of the direct
    segments."""
    jscene = jpresets.cornell_grid_smoke(6, 6, grid_res=8)
    hold(jscene, _converted(jscene), dict(max_depth=4),
         tracking_steps=gmed.TRACKING_DRAWS)


def test_mis_tracer_matches_jax_in_nested_media():
    """cornell_nested_smoke at 9x8: each lane's medium id switched at the
    cube's null faces (which take no depth), the direct segments through
    the nested transmittance. In a square frame the diagonal pixels'
    rays (|x| = |y|) run exactly through the cube's edges, where the
    two packages' float32 triangle tests pick different faces (an 8x8
    frame has 8 such of its 64 rays, over the bar's 2 % for such
    straddles); a 9x8 frame has none."""
    jscene = jpresets.cornell_nested_smoke(9, 8)
    scene = _converted(jscene)
    assert scene.media is not None
    hold(jscene, scene, dict(max_depth=4, only_vrl_paths=False,
                             null_crossings=4))


def _render_uniforms(key, spp, scene, cfg):
    """JAX render_volpath's uniforms for the scene's pixels: (u, None)."""
    n = scene.camera.width * scene.camera.height
    keys = jax_render_keys(key, spp, n)
    steps = volpath.n_steps(scene, cfg)
    return _t(np.stack([jax_volpath_uniforms(keys[i], steps)
                        for i in range(spp)])), None


def test_render_path_and_direct_match_jax():
    """render_path (max_depth 4) and render_direct on cornell_area_light
    at 6x6, 2 samples a pixel, on the uniforms of JAX's own renders."""
    jscene = jpresets.cornell_area_light(6, 6)
    scene = _converted(jscene)
    key = jax.random.key(4)
    for jrender, render, cfg, kw in (
            (jsurface.render_path, surface.render_path,
             volpath.VolpathConfig(max_depth=4), dict(max_depth=4)),
            (jsurface.render_direct, surface.render_direct,
             volpath.VolpathConfig(max_depth=1), {})):
        ref = _t(jrender(jscene, key, spp=2, **kw))
        img = render(scene, None, spp=2,
                     uniforms=_render_uniforms(key, 2, scene, cfg), **kw)
        median, share = homog_bar(img.reshape(-1, 3), ref.reshape(-1, 3))
        assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median,
                                                               share)
        assert float(ref.abs().max()) > 0.0


def test_nested_noop_crossing_matches_the_global_medium():
    """A null cube whose interior medium equals the exterior renders as
    the one global medium (tests/test_nested_media.py:45): the image
    means of 3 seeds x 24 spp within 10 %."""
    sig_s, sig_a = (0.8, 0.8, 0.8), (0.05, 0.05, 0.05)
    nested = presets.cornell_nested_smoke(
        8, 8, sigma_s=sig_s, sigma_a=sig_a, exterior=(sig_a, sig_s, 0.0),
        device=CPU)
    ref = presets.cornell_smoke(8, 8, with_blocker=False, sigma_s=sig_s,
                                sigma_a=sig_a, device=CPU)
    cfg = volpath.VolpathConfig(max_depth=6, only_vrl_paths=False)

    def mean(scene, seed0):
        return float(np.mean([volpath.render_volpath(
            scene, torch.Generator().manual_seed(seed0 + i), spp=24,
            cfg=cfg).mean() for i in range(3)]))

    ratio = mean(nested, 0) / mean(ref, 10)
    assert 0.9 < ratio < 1.1, ratio


def test_render_volpath_does_not_depend_on_its_tile(monkeypatch):
    """render_volpath draws each sample's uniforms whole, so the image
    is the same bit for bit whatever tile the free memory allows: tiles
    of part of a sample, of one sample, of two samples and of all of
    them, on cornell_smoke (6x6, 3 spp) and in a grid medium."""
    cfg = volpath.VolpathConfig(max_depth=3, only_vrl_paths=False)
    for scene in (presets.cornell_smoke(6, 6, device=CPU),
                  presets.cornell_grid_smoke(6, 6, grid_res=8, device=CPU)):
        images = []
        for tile in (10, 36, 80, 10 ** 6):
            monkeypatch.setattr(volpath, "tile_rays", lambda *a, t=tile: t)
            images.append(volpath.render_volpath(
                scene, torch.Generator().manual_seed(5), spp=3, cfg=cfg))
        assert float(images[0].abs().max()) > 0.0
        for img in images[1:]:
            assert torch.equal(img, images[0])
