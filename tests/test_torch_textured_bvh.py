"""Textured surfaces on a large mesh (kernel 7's textured form), and the
textured grid forms' procedural textures and HK slab against JAX's XLA
route as it is, in alvrl_tpu_torch against alvrl_tpu on the same
numpy-made inputs.

The mesh is a small cube field (scripts/bench_bvh_large.cube_field_scene
at n_axis 3, its cubes grown 4.4x about their centres and drawn towards
the middle of the box, so that a 16 x 16 frame sees each cube material,
and moved off the box's planes of symmetry (SHIFT): in the symmetric
layout pixel-centre rays run along cube edges and face diagonals, where
the two packages' triangle tests decide a shared edge differently)
with cornell_textured's surfaces (presets.textured_cube_field: its walls,
and its seven materials seen from the camera on the cubes in turn) in
cornell_textured's medium. Kernel 7's plain version equals kernel 1's
textured plain version on the same packs; the large-mesh route
(render_with_vrls_kernel_bvh) is held against JAX's pair_contribution on
the same scene (its arrays swapped into JAX's cornell_textured) with the
hits' UV put into its bsdf_eval_smooth (ROADMAP C23), at the homogeneous
bar over the frame and each material alone. ROADMAP C25: JAX's Pallas
packs give a textured hit its base albedo. The field against every 8th
bench VRL (64), the grid scene against every 4th (127); two jitted
pair_contribution traces.
"""

import functools
import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvrl_tpu.geometry import intersect as jisect
from alvrl_tpu.integrators.vrl import integrate as jintegrate
from alvrl_tpu.integrators.vrl import integrator as jintegrator
from alvrl_tpu.integrators.vrl.integrate import VRLConfig as JVRLConfig
from alvrl_tpu.ops import pack as jpack
from alvrl_tpu.ops import vrl_pallas as jvp
from alvrl_tpu.scene import loader as jloader
from alvrl_tpu.textures.procedural import albedo_at as jalbedo_at
from alvrl_tpu.textures.procedural import interp_uv as jinterp_uv
from alvrl_tpu_torch.integrators.vrl import integrator
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops import vrl_sum as vs
from alvrl_tpu_torch.ops import vrl_sum_bvh as vb
from alvrl_tpu_torch.scene import loader, presets
from alvrl_tpu_torch.scripts import bench_bvh_large as bbl
from tests.test_torch_textured_grid import (
    AS_THEY_ARE,
    N_RAYS as GRID_RAYS,
    _TMP,
    _bar,
    _case,
    _eye_mats,
    _expand,
    _route,
    _rays,
    _scenes,
    _vrls,
)
from alvrl_tpu_torch import convert
from tests.torch_port_utils import CPU, jax_vrls_leaves

torch.set_num_threads(1)

SIZE = 16
N_RAYS = SIZE * SIZE
# the materials the camera sees on the field, the cube materials in turn
SEEN = ("bitmap", "checker", "grid", "noise", "hk", "normalmap", "bumpmap")
GROW = 4.4  # the cubes' growth about their centres
SHIFT = (0.031, -0.017, 0.0)  # their centres' move off the symmetry planes


@functools.lru_cache(maxsize=None)
def _field():
    """(desc, the port's textured field in cornell_textured's medium, its
    JAX twin: JAX's cornell_textured with the field's arrays and the
    port's bitmap stack)."""
    desc = json.loads(json.dumps(presets.cornell_textured_desc(
        _TMP.name, SIZE, SIZE)))
    names = [m["name"] for m in desc["materials"]]
    tex = loader.build_scene(desc, device=CPU)
    field = bbl.cube_field_scene(SIZE, SIZE, 3, device=CPU)
    v = field.vertices.clone()
    cubes = v[24:].reshape(-1, 24, 3)  # after the box's 24 vertices
    centre = cubes.mean(dim=1, keepdim=True)
    moved = centre.clone()
    moved[..., 2] = 0.3 + 0.5 * centre[..., 2]
    moved = moved + torch.tensor(SHIFT)
    v[24:] = (moved + GROW * (cubes - centre)).reshape(-1, 3)
    field = presets.textured_cube_field(
        replace(field, vertices=v), tex, [names.index(n) for n in SEEN])
    field = replace(field, medium=tex.medium)
    jscene = jloader.build_scene(desc)
    jscene = jscene.replace(
        vertices=jnp.asarray(field.vertices.numpy()),
        faces=jnp.asarray(field.faces.numpy().astype(np.int32)),
        material=jnp.asarray(field.material.numpy().astype(np.int32)),
        face_uv=jnp.asarray(field.face_uv.numpy()),
        face_emitter=jnp.full((field.faces.shape[0],), -1, jnp.int32),
        face_shape=None, textures=jnp.asarray(tex.textures.numpy()))
    return desc, field, jscene


def _frame_rays(field):
    ray_o, ray_d = integrator.frame_rays(field)[2:]
    return ray_o, ray_d


@jax.jit
def _jax_pairs_uv(scene, ray_o, ray_d, start, end, power, valid, u):
    """pair_contribution of every (eye ray, VRL) pair in the homogeneous
    medium, with the hits' UV in bsdf_eval_smooth: total (B, N, 3)."""
    hit = jintegrator.trace_eye_rays(scene, ray_o, ray_d)
    jh = jisect.intersect_all(ray_o, ray_d, scene.vertices, scene.faces)
    uv = _expand(jinterp_uv(scene.face_uv, jh.prim, jh.uv))
    saved = jintegrate.bsdf_eval_smooth
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jintegrate, "bsdf_eval_smooth",
                   lambda *a, p_world=None: saved(*a, p_world=p_world, uv=uv))
        total, _, _ = jintegrate.pair_contribution(
            scene, _expand(ray_o), _expand(ray_d), _expand(hit.p),
            _expand(hit.valid), _expand(hit.ng), _expand(hit.mat),
            start[None], end[None], power[None], valid[None],
            u[..., :4].reshape(u.shape[0], u.shape[1], 2, 2), u[..., 4:],
            JVRLConfig())
    return total


@functools.lru_cache(maxsize=None)
def _field_vrls():
    """Every 8th bench VRL (the port's)."""
    jv, _ = _vrls()  # every 4th
    jv = jv.replace(start=jv.start[::2], end=jv.end[::2],
                    power=jv.power[::2], valid=jv.valid[::2])
    return convert.vrls_from_numpy(jax_vrls_leaves(jv), device=CPU)


def _field_case():
    """The field, its VRLs, material pack and packs (the VRLs
    Morton-sorted), and seeded uniforms."""
    _, field, _ = _field()
    vrls = _field_vrls()
    mats = integrator.material_pack(field)
    packs = integrator.pack_frame_bvh(field, vrls, materials=mats)[3]
    u = torch.as_tensor(np.random.default_rng(7).random(
        (N_RAYS, vrls.capacity, 6), dtype=np.float32))
    return field, vrls, mats, packs, u


def test_field_sees_every_material_and_takes_the_textured_pack():
    """The field's frame sees the seven materials (each on 8 rays or
    more) and packs the textured ray pack for kernel 7."""
    desc, field, _ = _field()
    names = [m["name"] for m in desc["materials"]]
    _, _, _, packs, _ = _field_case()
    assert field.textured() and pk.is_textured(packs[0])
    assert packs[0].shape == (pk.TEX_RAY_ROWS, N_RAYS)
    mid = packs[0][pk.MATID].long()[packs[0][pk.VALID] > 0.5]
    seen = {names[k]: int((mid == k).sum()) for k in set(mid.tolist())}
    assert set(seen) == set(SEEN) and min(seen.values()) >= 8, seen


def test_kernel7_plain_equals_kernel1_textured_plain():
    """Kernel 7's plain version on the field's textured packs is kernel
    1's textured plain version on the same packs and the BVH's triangles,
    bit for bit (the route below takes it through kernel 7's wrapper)."""
    _, _, mats, packs, u = _field_case()
    a = vb.vrl_sum_bvh_reference(*packs, u, materials=mats)
    b = vs.vrl_sum_reference(packs[0], packs[1], packs[2].tris, packs[3], u,
                             materials=mats)
    assert torch.equal(a, b) and float(a.abs().sum()) > 0.0


def test_large_mesh_route_matches_jax_pair_contribution_with_uv():
    """render_with_vrls_kernel_bvh (kernel 7's textured form, plain on the
    CPU) against pair_contribution with the hits' UV summed over the same
    Morton-sorted VRLs on the same uniforms: the homogeneous bar over the
    frame and over each material's rays alone."""
    desc, field, jscene = _field()
    names = [m["name"] for m in desc["materials"]]
    _, vrls, _, _, u = _field_case()
    sorted_vrls = vb.sort_vrls_morton(vrls)
    ray_o, ray_d = _frame_rays(field)
    total = torch.as_tensor(np.array(_jax_pairs_uv(
        jscene, jnp.asarray(ray_o.numpy()), jnp.asarray(ray_d.numpy()),
        *(jnp.asarray(getattr(sorted_vrls, k).numpy())
          for k in ("start", "end", "power", "valid")),
        jnp.asarray(u.numpy()))))
    img = integrator.render_with_vrls_kernel_bvh(
        field, vrls, torch.Generator().manual_seed(0), uniforms=u)
    mats = _eye_mats(field, ray_o, ray_d)
    ref = total.sum(dim=1) / float(vrls.particle_count)
    out, ref = img.reshape(N_RAYS, 3), ref
    keep = mats >= 0
    median, share = vs.homog_bar(out[keep], ref[keep])
    assert median < vs.HOMOG_MEDIAN and share < vs.HOMOG_SHARE, (median,
                                                                 share)
    groups = vs.homog_bar_by_kind(out[keep], ref[keep], mats[keep])
    assert {names[k] for k in groups} == set(SEEN)
    for k, (n, median, share) in groups.items():
        assert median < vs.HOMOG_MEDIAN and share < vs.HOMOG_SHARE, (
            names[k], n, median, share)


def test_grid_procedural_textures_and_the_slab_match_it_as_it_is():
    """Kernel 3's textured form (nearest, plain) in the grid medium of
    tests/test_torch_textured_grid.py against pair_contribution as it is
    (no UV) on the procedural textures' and the HK slab's hits, which do
    not read the UV."""
    desc, _, _ = _scenes(True)
    names = [m["name"] for m in desc["materials"]]
    scene, vrls, ray_o, ray_d, u, total, _ = _case(True, False)
    out, calls = _route("sum", scene, vrls, ray_o, ray_d, u)
    assert calls == [(pk.GRID_TEX_RAY_ROWS, True, False)]
    _bar(out, total.sum(dim=1) / float(vrls.particle_count),
         _eye_mats(scene, ray_o, ray_d), names, AS_THEY_ARE)


def test_c25_jax_pallas_packs_drop_the_texture():
    """ROADMAP C25: JAX's Pallas ray packs (ops.pack.pack_rays and
    pack_rays_hetero) put a textured DIFFUSE hit's base albedo
    (materials.albedo) into its ALB rows, where albedo_at gives the
    checker's value: on the checker floor the packs hold one colour,
    albedo_at two. Compares packs only."""
    desc, jscene, _ = _scenes(True)
    names = [m["name"] for m in desc["materials"]]
    ray_o, ray_d = _rays(jscene)
    jh = jisect.intersect_all(ray_o, ray_d, jscene.vertices, jscene.faces)
    mat = np.asarray(jscene.material)[np.maximum(np.asarray(jh.prim), 0)]
    on = np.asarray(jh.valid) & (mat == names.index("checker"))
    assert on.sum() >= 8
    textured = np.asarray(jalbedo_at(jscene, jnp.asarray(mat), jh.p,
                                     jinterp_uv(jscene.face_uv, jh.prim,
                                                jh.uv)))[on]
    base = np.asarray(jscene.materials.albedo)[names.index("checker")]
    assert len({tuple(np.round(a, 5)) for a in textured}) == 2
    homog = jscene.replace(medium=jloader.build_scene(json.loads(json.dumps(
        presets.cornell_textured_desc(_TMP.name, 12, 12)))).medium)
    for pack in (jpack.pack_rays(homog, ray_o, ray_d, jh),
                 jpack.pack_rays_hetero(jscene, ray_o, ray_d, jh)):
        alb = np.asarray(pack)[:GRID_RAYS, jvp._ALB:jvp._ALB + 3][on]
        assert np.array_equal(alb, np.broadcast_to(base, alb.shape))
        assert (np.abs(textured - alb).max(axis=-1) > 0.1).sum() >= 4
