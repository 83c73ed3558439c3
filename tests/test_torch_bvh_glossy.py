"""Glossy and layered surfaces, a mixture phase and a sampling strategy
other than balance on the large-mesh route (kernel 7), in
alvrl_tpu_torch against alvrl_tpu: the box of
torch_port_utils.glossy_scene_desc in homogeneous media, both packages
built from one JSON description by their loaders.

The plain version of kernel 7 (its material and extended forms) against
kernel 1's plain version on the same uniforms, the large-mesh route
against the flat route, and kernel 7 on the glossy table (its coats
swapped out) in a mixture medium of the maximum strategy against JAX's
XLA route
(pair_contribution); ROADMAP C21: what the JAX package's Pallas grid and
BVH kernels compute on a glossy table (its Pallas BVH kernel in interpret
mode, in a child process). About 80 s alone, most of it JAX's compile
of pair_contribution and the Pallas kernel in its child process.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvrl_tpu.integrators.vrl import integrator as jintegrator
from alvrl_tpu.integrators.vrl.integrate import VRLConfig as JVRLConfig
from alvrl_tpu.scene import loader as jloader
from alvrl_tpu_torch.bsdf import api as bsdf
from alvrl_tpu_torch.integrators.vrl import integrator
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops import vrl_sum as vs
from alvrl_tpu_torch.ops import vrl_sum_bvh as vb
from alvrl_tpu_torch.scene import loader
from alvrl_tpu_torch.scene.scene import COATING, ROUGH_COATING
from tests.test_torch_grid_glossy import (
    GLOSSY_KINDS,
    N_VRLS,
    _bar,
    _eye_kinds,
    _rays,
    _t,
    _vrls,
    _xla_pairs,
)
from tests.torch_port_utils import (
    CPU,
    SEQ_UNIFORMS,
    glossy_scene_desc,
    in_child,
)

torch.set_num_threads(1)

# an absorbing mixture (tests/test_torch_phase_strategy.py's)
MIX = {"type": "mixture", "components": [
    {"type": "hg", "g": 0.8, "weight": 0.6},
    {"type": "rayleigh", "weight": 0.3}]}
HOMOG = {"type": "homogeneous", "sigma_s": [0.6, 0.5, 0.55],
         "sigma_a": [0.05, 0.08, 0.03]}
# kernel 7's media: the glossy table's own, a mixture, a strategy, and
# both (the one held against pair_contribution)
BVH_MEDIA = {
    "glossy": dict(HOMOG, g=0.3),
    "mixture": dict(HOMOG, phase=MIX),
    "strategy": dict(HOMOG, g=0.3, strategy="maximum"),
    "mixture_strategy": dict(HOMOG, phase=MIX, strategy="maximum"),
}


def _bvh_desc(name):
    return json.loads(json.dumps(dict(glossy_scene_desc(),
                                      medium=BVH_MEDIA[name])))


def _bvh_case(scene, ray_o, ray_d):
    """The port's scene (the glossy table's, in a BVH_MEDIA medium) on the
    eye rays ray_o, ray_d: (seeded uniforms (64, N_VRLS, 6), the material
    pack, the packs with the MATID row, the BVH pack)."""
    u = torch.as_tensor(np.random.default_rng(7).random(
        (64, N_VRLS, 6), dtype=np.float32))
    mats = integrator.material_pack(scene)
    _, packs = integrator.pack_rays_vrls(scene, ray_o, ray_d, _vrls()[1],
                                         mats)
    assert mats is not None and packs[0].shape[0] == pk.MAT_RAY_ROWS
    bvh = vb.pack_bvh_tris(scene.vertices, scene.faces, scene.opaque_faces())
    return u, mats, packs, bvh


@pytest.mark.parametrize("name", ["glossy", "mixture", "strategy"])
def test_kernel7_plain_matches_kernel1_plain(name):
    """Kernel 7's plain version on the BVH pack of the glossy table's scene
    (its material forms; with the mixture phase or the maximum strategy,
    its extended forms on the extended medium pack) against kernel 1's
    plain version on the same uniforms (the flat pack's triangles), over
    the frame and over each eye-hit kind alone; and the large-mesh route
    on per-draw constants against the flat route on the Morton-sorted
    VRLs."""
    scene = loader.build_scene(_bvh_desc(name), device=CPU)
    ray_o, ray_d = integrator.frame_rays(scene)[2:]
    u, mats, packs, bvh = _bvh_case(scene, ray_o, ray_d)
    rays, vpack, tris, med = packs
    assert (med.shape[0] > pk.MED_LEN) == (name != "glossy")
    kw = dict(phase_kind=scene.medium.phase_kind, materials=mats)
    out = vb.vrl_sum_bvh(rays, vpack, bvh, med, uniforms=u, **kw)
    flat = vs.vrl_sum_reference(rays, vpack, tris, med, u, **kw)
    assert float(out.abs().sum()) > 0.0
    _bar(out.T, flat.T, _eye_kinds(scene, ray_o, ray_d))
    vrls = _vrls()[1]
    c = torch.tensor(SEQ_UNIFORMS).expand(64, N_VRLS, 6).contiguous()
    img = integrator.render_with_vrls_kernel_bvh(
        scene, vrls, torch.Generator().manual_seed(0), uniforms=c)
    img_flat = integrator.render_with_vrls_kernel(
        scene, vb.sort_vrls_morton(vrls), torch.Generator().manual_seed(0),
        uniforms=c)
    assert float(img.mean()) > 0.0
    _bar(img, img_flat)


def test_kernel7_plain_matches_pair_contribution():
    """Kernel 7's plain version on the glossy table's scene, its coats'
    faces plastic and rough plastic (C21_SWAP: the nine other smooth
    kinds; the coats' eval is kernel 1's, which
    tests/test_torch_glossy.py holds against JAX), in a mixture medium of
    the maximum strategy (its material form on the extended pack)
    against pair_contribution summed over the VRLs on the same uniforms:
    the homogeneous bar over the frame and over each eye-hit kind
    alone."""
    desc = _c21_desc("mixture_strategy")
    jscene, scene = jloader.build_scene(desc), loader.build_scene(desc,
                                                                  device=CPU)
    ray_o, ray_d = _rays(jscene)
    u, mats, packs, bvh = _bvh_case(scene, _t(ray_o), _t(ray_d))
    total, _ = _xla_pairs(jscene, ray_o, ray_d, _vrls()[0], jnp.asarray(u),
                          grid=False)
    ref = _t(total).sum(dim=1)
    rays, vpack, _, med = packs
    assert med.shape[0] > pk.MED_LEN
    out = vb.vrl_sum_bvh(rays, vpack, bvh, med, uniforms=u,
                         phase_kind=scene.medium.phase_kind, materials=mats)
    assert float(ref.abs().sum()) > 0.0
    _bar(out.T, ref, _eye_kinds(scene, _t(ray_o), _t(ray_d)),
         kinds=GLOSSY_KINDS - {COATING, ROUGH_COATING})


C21_VRLS = 32
# C21's scene: the glossy table's, its two coats' faces plastic and rough
# plastic (whose JAX loader builds no rough-transmittance table, a 15 s
# build in a fresh process)
C21_SWAP = {"co": "pl", "rco": "rp"}


def _c21_desc(medium="glossy"):
    """glossy_scene_desc in BVH_MEDIA[medium], its coats swapped out of
    its shapes and its table (C21_SWAP)."""
    desc = dict(glossy_scene_desc(), medium=BVH_MEDIA[medium])
    return json.loads(json.dumps(dict(
        desc, materials=[m for m in desc["materials"]
                         if m["name"] not in C21_SWAP],
        shapes=[dict(sh, material=C21_SWAP.get(sh["material"],
                                               sh["material"]))
                for sh in desc["shapes"]])))


def _pallas_bvh_pinned():
    """render_with_vrls_pallas_bvh in interpret mode on _c21_desc's 8x8
    scene with C21_VRLS bench VRLs, vp._u01
    returning the next SEQ_UNIFORMS constant at each call while traced,
    the JAX package's bvh module on the port's build of
    native/bvh_builder.cpp. Run by in_child."""
    from jax.experimental.pallas import tpu as pltpu

    from alvrl_tpu.geometry import bvh as jbvh
    from alvrl_tpu.ops import vrl_pallas as vp
    from alvrl_tpu_torch.geometry import bvh

    calls = {"i": 0}

    def mock(shape):
        v = SEQ_UNIFORMS[calls["i"] % len(SEQ_UNIFORMS)]
        calls["i"] += 1
        return jnp.full(shape, v, jnp.float32)

    jscene = jloader.build_scene(_c21_desc())
    jv, _ = _vrls(C21_VRLS)
    mp = pytest.MonkeyPatch()
    mp.setattr(jbvh, "_LIB_PATH", str(bvh._library_path()))
    mp.setattr(jbvh, "_lib", None)
    bvh.load_library()
    jax.clear_caches()
    mp.setattr(vp, "_u01", mock)
    try:
        with pltpu.force_tpu_interpret_mode():
            img = np.asarray(jintegrator.render_with_vrls_pallas_bvh(
                jscene, jv, jax.random.key(1), JVRLConfig()))
    finally:
        mp.undo()
        jax.clear_caches()
    return img


def test_c21_jax_pallas_kernels_drop_the_glossy_term():
    """ROADMAP C21: the JAX package's Pallas grid and BVH kernels evaluate
    no BSDF, and their ray packs zero the albedo of every non-diffuse hit,
    so on a glossy table they drop the glossy faces' vol-surf term. On
    pinned uniforms (SEQ_UNIFORMS) the Pallas BVH image equals the port's
    kernel-7 plain version on the diffuse pack (albedo 0 at the glossy
    hits), and not the port's large-mesh route, which takes the material
    forms as JAX's XLA route does. (The grid kernels' pack:
    tests/test_torch_grid_glossy.py::test_c21_jax_grid_pack_zeroes_the_
    glossy_albedo.)"""
    pallas = _t(in_child(_pallas_bvh_pinned))
    scene = loader.build_scene(_c21_desc(), device=CPU)
    assert bsdf.has_glossy(bsdf.check_kinds(scene))
    _, vrls = _vrls(C21_VRLS)
    c = torch.tensor(SEQ_UNIFORMS).expand(64, C21_VRLS, 6).contiguous()
    px, py, hit, packs = integrator.pack_frame_bvh(scene, vrls)
    diffuse = integrator.develop_sums(scene, vrls, px, py, hit,
                                      vb.vrl_sum_bvh(*packs, uniforms=c))
    _bar(diffuse, pallas)
    glossy = integrator.render_with_vrls_kernel_bvh(
        scene, vrls, torch.Generator().manual_seed(0), uniforms=c)
    assert float(glossy.sum()) > 1.05 * float(pallas.sum())
