"""The glossy grid scene of tests/test_torch_grid_glossy.py through the
port's whole routes, in alvrl_tpu_torch against alvrl_tpu: the plain
chain (li_unclustered_spec_u, kernel 3's plain material form at every
depth) through a glass sphere onto the glossy faces against JAX's XLA
li_unclustered_spec, and render_cli -i vrl|alvrl on the CPU against the
in-process driver, bit for bit. About 80 s alone, most of it JAX's
scene build and its compile of vrl_sum.
"""

import json

import jax
import numpy as np
import pytest
import torch

from alvrl_tpu.integrators.vrl import integrator as jintegrator
from alvrl_tpu.integrators.vrl import specular as jspecular
from alvrl_tpu.integrators.vrl.integrate import VRLConfig as JVRLConfig
from alvrl_tpu.media import api as jmapi
from alvrl_tpu.scene import loader as jloader
from alvrl_tpu_torch.bsdf import api as bsdf
from alvrl_tpu_torch.integrators import progressive
from alvrl_tpu_torch.integrators.vrl import integrator, specular
from alvrl_tpu_torch.integrators.vrl.alvrl import ALVRLParams
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.io import image
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.scene import loader
from alvrl_tpu_torch.scripts import render_cli
from tests.test_torch_grid_glossy import (
    N_VRLS,
    _bar,
    _rays,
    _t,
    _vrls,
    grid_desc,
)
from tests.torch_port_utils import CPU

torch.set_num_threads(1)


def test_plain_grid_chain_matches_jax_li_unclustered_spec():
    """The plain chain (li_unclustered_spec_u: kernel 3's plain material
    form at every depth) through a glass sphere onto the glossy faces in
    the grid medium against JAX's jitted XLA li_unclustered_spec (the
    table path) on JAX's own uniforms: depth 3 with the forced roulette
    from depth 2, 64 rays, 64 VRLs, the homogeneous bar."""
    from tests.test_torch_specular import SPEC, _jitted_vrl_sum, _spec_uniforms

    desc = json.loads(json.dumps(grid_desc()))
    for sh in desc["shapes"]:
        if sh.get("material") == "rd":
            sh.update(material="glass", radius=0.35,
                      center=[-0.25, 0.25, -0.1])
    jscene = jmapi.prepare_scene(jloader.build_scene(desc))
    scene = loader.build_scene(desc, device=CPU)
    kinds = bsdf.check_kinds(scene)
    assert bsdf.DIELECTRIC in kinds and bsdf.has_glossy(kinds)
    jv, vrls = _vrls()
    ray_o, ray_d = _rays(jscene)
    jcfg = JVRLConfig(vrl_chunk=32)
    jspec = jspecular.SpecularConfig(**SPEC)
    key = jax.random.key(8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jintegrator, "vrl_sum", _jitted_vrl_sum())
        ref = jintegrator.li_unclustered_spec(jscene, ray_o, ray_d, jv, key,
                                              jcfg, jspec)
    u_chain, u_sums = _spec_uniforms(key, 64, N_VRLS, jcfg, jspec)
    rows = []
    saved = integrator.vrl_sum_hetero_reference

    def recording(*a, **kw):
        rows.append((a[0].shape[0], kw.get("materials") is not None))
        return saved(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(integrator, "vrl_sum_hetero_reference", recording)
        out = integrator.li_unclustered_spec_u(
            scene, _t(ray_o), _t(ray_d), vrls, u_chain, u_sums, VRLConfig(),
            specular.SpecularConfig(**SPEC))
    assert len(rows) >= 3 and set(rows) == {(pk.GRID_MAT_RAY_ROWS, True)}
    assert float(_t(ref).abs().sum()) > 0.0
    _bar(out, _t(ref))


CLI_OPTS = ["-p", "2", "--seed", "3", "--particles", "12", "--vrls", "40",
            "-L", "WARNING"]


@pytest.mark.parametrize("integrator_name", ["vrl", "alvrl"])
def test_cli_renders_the_glossy_grid_scene_as_the_driver(tmp_path,
                                                         integrator_name):
    """render_cli -i vrl|alvrl on the CPU writes render_progressive's image
    of the 8x8 glossy grid JSON bit for bit, finite and non-zero."""
    path, out = tmp_path / "glossy_grid.json", tmp_path / "o.pfm"
    path.write_text(json.dumps(grid_desc()))
    assert render_cli.main([str(path), "--cpu", "-i", integrator_name, "-o",
                            str(out), *CLI_OPTS]) == 0
    ref = progressive.render_progressive(
        loader.load_json(grid_desc(), device=CPU), 3,
        progressive.ProgressiveConfig(max_passes=2,
                                      clustered=integrator_name == "alvrl"),
        ALVRLParams(vrl_target_num=40, num_particles=12))
    got = image.read_pfm(out)
    assert got.shape == (8, 8, 3) and np.isfinite(got).all()
    assert got.mean() > 0 and np.array_equal(got, ref)
