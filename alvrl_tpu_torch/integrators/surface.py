"""Surface-only integrators: `path` and `direct`.

Counterpart of alvrl_tpu/integrators/surface.py (path.cpp, direct.cpp):
in vacuum (sigma_t 0, sampling weight 0) the volumetric path tracer
never samples a medium event, so `path` is volpath's plain tracer on the
vacuumised scene and `direct` the same at max_depth 1 (the camera
vertex, one surface vertex and its direct sample).
"""

from __future__ import annotations

from alvrl_tpu_torch.integrators import volpath
from alvrl_tpu_torch.scene.presets import vacuumize
from alvrl_tpu_torch.scene.scene import Scene

__all__ = ["vacuumize", "render_path", "render_direct"]


def render_path(scene: Scene, generator, spp: int = 16, max_depth: int = 16,
                uniforms=None):
    """Surface path tracing with direct sampling and MIS (`path`);
    `uniforms` as render_volpath's."""
    cfg = volpath.VolpathConfig(max_depth=max_depth, only_vrl_paths=False)
    return volpath.render_volpath(vacuumize(scene), generator, spp=spp,
                                  cfg=cfg, uniforms=uniforms)


def render_direct(scene: Scene, generator, spp: int = 16, uniforms=None):
    """Direct illumination only (`direct`); `uniforms` as
    render_volpath's."""
    cfg = volpath.VolpathConfig(max_depth=1, only_vrl_paths=False)
    return volpath.render_volpath(vacuumize(scene), generator, spp=spp,
                                  cfg=cfg, uniforms=uniforms)
