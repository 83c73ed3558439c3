"""The volumetric path tracer under a sky (a box open to a sunsky map)
against alvrl_tpu's li_volpath, ray by ray on JAX's random numbers
(tests/test_torch_volpath.py's hold), the oracle and the MIS tracer; and
ROADMAP C17, the map's direct segments ending on the tracer's emission
disk. About 70 s alone."""

import json

import pytest
import torch

from alvrl_tpu.scene import loader as jloader
from alvrl_tpu_torch.integrators import volpath
from alvrl_tpu_torch.scene import loader
from tests.test_torch_volpath import W, hold
from tests.torch_port_utils import CPU

torch.set_num_threads(1)

SKY_BOX = {
    "camera": {"type": "perspective", "origin": [0, 0, -0.99],
               "target": [0, 0, 1], "fov": 90, "width": W, "height": W},
    "medium": {"type": "homogeneous", "sigma_s": [0.3, 0.3, 0.3],
               "sigma_a": [0.02, 0.02, 0.02]},
    "materials": [{"name": "white", "type": "diffuse",
                   "albedo": [0.7, 0.7, 0.7]}],
    # a box open towards +z and +y: the sky shows through both openings
    "shapes": [
        {"type": "rectangle", "material": "white",
         "to_world": [[1, 0, 0, 0], [0, 0, 1, -1], [0, -1, 0, 0],
                      [0, 0, 0, 1]]},
        {"type": "rectangle", "material": "white",
         "to_world": [[0, 0, 1, -1], [0, 1, 0, 0], [-1, 0, 0, 0],
                      [0, 0, 0, 1]]},
        {"type": "rectangle", "material": "white",
         "to_world": [[0, 0, -1, 1], [0, 1, 0, 0], [1, 0, 0, 0],
                      [0, 0, 0, 1]]}],
    "emitters": [{"type": "sunsky", "sun_direction": [0.3, 0.8, 0.5],
                  "resolution": 32},
                 {"type": "point", "position": [0, 0.5, 0.2],
                  "intensity": [2, 2, 2]}],
}


@pytest.mark.parametrize("only_vrl_paths", [False, True],
                         ids=["mis", "oracle"])
def test_volpath_matches_jax_under_a_sky(only_vrl_paths):
    """A box open to a sunsky map: the map's radiance on escape (MIS
    weighted against its direct sampling), its direct sampling and pdf
    from the medium and the surfaces."""
    jscene = jloader.build_scene(json.loads(json.dumps(SKY_BOX)))
    scene = loader.build_scene(json.loads(json.dumps(SKY_BOX)), device=CPU)
    out = hold(jscene, scene, dict(max_depth=4,
                                   only_vrl_paths=only_vrl_paths))
    assert float(out.abs().max()) > 0.0


def test_c17_env_segments_end_where_the_photons_start():
    """ROADMAP C17: given the scene's centre (`env_center`), the map's
    direct segments end on the tracer's emission disk (1.5 R along the
    direction from the bounding sphere's centre), not at the default
    2.5 R, and points outside the disk's cylinder get no map light; in
    vacuum (every direct sample from a surface inside the bounding
    sphere, at transmittance 1) that changes nothing, in the sky box's
    medium it changes the image."""
    scene = loader.build_scene(json.loads(json.dumps(SKY_BOX)), device=CPU)
    vac = dict(SKY_BOX, medium={"type": "homogeneous", "sigma_s": [0.0] * 3,
                                "sigma_a": [0.0] * 3})
    vacuum = loader.build_scene(json.loads(json.dumps(vac)), device=CPU)
    cfg = volpath.VolpathConfig(max_depth=3, only_vrl_paths=False)
    images = {}
    for name, sc in (("medium", scene), ("vacuum", vacuum)):
        lo, hi = sc.aabb()
        for flag in (True, False):
            images[name, flag] = volpath.render_volpath(
                sc, torch.Generator().manual_seed(1), spp=2, cfg=cfg,
                env_center=0.5 * (lo + hi) if flag else None)
    assert torch.equal(images["vacuum", True], images["vacuum", False])
    assert float(images["vacuum", True].mean()) > 0.0
    assert float((images["medium", True] - images["medium", False])
                 .abs().max()) > 1e-3 * float(images["medium", False].max())
