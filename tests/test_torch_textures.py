"""The port's texture stack against alvrl_tpu's: textures.procedural
(interp_uv, bitmap_lookup, the int32 lattice hash, value noise, checker,
grid lines, albedo_at), geometry.shapes' auto_uvs and the UV-carrying
merge, the closest hit's barycentric uv (triangle soup and BVH),
bsdf.layered's perturbed_normal and bump_to_normal_map, and the loader on
cornell_textured (presets.cornell_textured_desc: a bitmap, checker, grid
and noise walls, a normal-mapped and a bump-mapped block, an HK slab),
with ROADMAP C24 (the JAX loader reads a bump map's height field as a
normal map) shown, IRAWAN still refused and the one-resolution rule of the
bitmap stack. The JAX functions run eagerly on small numpy inputs from a
seed; bars: bit for bit where the two compute the same float32 ops in the
same order, else 1e-6. About 15 s alone.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvrl_tpu.bsdf import layered as jlayered
from alvrl_tpu.geometry import intersect as jisect
from alvrl_tpu.geometry import shapes as jshapes
from alvrl_tpu.io import image as jimage
from alvrl_tpu.scene import loader as jloader
from alvrl_tpu.textures import procedural as jproc
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.bsdf import layered
from alvrl_tpu_torch.geometry import intersect, shapes
from alvrl_tpu_torch.integrators.vrl import integrator
from alvrl_tpu_torch.scene import loader, presets
from alvrl_tpu_torch.scene.scene import HK, NORMALMAP
from alvrl_tpu_torch.textures import procedural as proc
from tests.torch_port_utils import CPU, jax_scene_leaves

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def textured(tmp_path_factory):
    """cornell_textured at 16x16: (its dict, the port's scene, the JAX
    loader's scene of the same dict)."""
    desc = presets.cornell_textured_desc(
        str(tmp_path_factory.mktemp("tex")), 16, 16)
    return (desc, loader.build_scene(desc, device=CPU),
            jloader.build_scene(json.loads(json.dumps(desc))))


def test_interp_uv_matches_jax():
    rng = np.random.default_rng(0)
    face_uv = rng.uniform(-2, 3, (20, 3, 2)).astype(np.float32)
    prim = rng.integers(-1, 20, 300).astype(np.int32)
    bary = rng.uniform(0, 0.5, (300, 2)).astype(np.float32)
    out = proc.interp_uv(_t(face_uv), _t(prim).long(), _t(bary))
    ref = jproc.interp_uv(jnp.asarray(face_uv), jnp.asarray(prim),
                          jnp.asarray(bary))
    torch.testing.assert_close(out, _t(ref), rtol=0, atol=1e-6)


def test_bitmap_lookup_matches_jax():
    """Wrapped u, clamped v rows, the texture id clamped, at uvs outside
    [0, 1)^2 too."""
    rng = np.random.default_rng(1)
    tex = rng.random((3, 8, 12, 3)).astype(np.float32)
    uv = rng.uniform(-2, 3, (500, 2)).astype(np.float32)
    tid = rng.integers(-1, 5, 500).astype(np.int32)
    out = proc.bitmap_lookup(_t(tex), _t(tid).long(), _t(uv))
    ref = jproc.bitmap_lookup(jnp.asarray(tex), jnp.asarray(tid),
                              jnp.asarray(uv))
    torch.testing.assert_close(out, _t(ref), rtol=0, atol=1e-6)


def test_lattice_hash_wraps_as_int32():
    """_hash3 on lattice points far out, where every product and sum
    wraps: the same bits as JAX's int32 arithmetic."""
    rng = np.random.default_rng(2)
    ip = rng.integers(-2**30, 2**30, (1000, 3)).astype(np.int32)
    out = proc._hash3(_t(ip).long())
    ref = jproc._hash3(jnp.asarray(ip))
    assert torch.equal(out, _t(ref))


def test_procedural_kinds_match_jax():
    rng = np.random.default_rng(3)
    p = rng.uniform(-3, 3, (2000, 3)).astype(np.float32)
    scale = rng.uniform(0.5, 8, 2000).astype(np.float32)
    pt, st, pj, sj = _t(p), _t(scale), jnp.asarray(p), jnp.asarray(scale)
    assert torch.equal(proc.checker(pt, st), _t(jproc.checker(pj, sj)))
    assert torch.equal(proc.grid_lines(pt, st), _t(jproc.grid_lines(pj, sj)))
    ps = p * scale[:, None]
    torch.testing.assert_close(proc.value_noise(_t(ps)),
                               _t(jproc.value_noise(jnp.asarray(ps))),
                               rtol=0, atol=1e-6)


def test_albedo_at_matches_jax(textured):
    """Every material of cornell_textured at seeded points and uvs, with
    and without the uv, on the JAX scene's table carried across."""
    _, _, jscene = textured
    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device=CPU)
    rng = np.random.default_rng(4)
    n_mat = scene.materials.kind.shape[0]
    mid = rng.integers(0, n_mat, 4000).astype(np.int32)
    p = rng.uniform(-1, 1, (4000, 3)).astype(np.float32)
    uv = rng.uniform(-0.5, 1.5, (4000, 2)).astype(np.float32)
    for with_uv in (True, False):
        out = proc.albedo_at(scene, _t(mid).long(), _t(p),
                             _t(uv) if with_uv else None)
        ref = jproc.albedo_at(jscene, jnp.asarray(mid), jnp.asarray(p),
                              uv=jnp.asarray(uv) if with_uv else None)
        torch.testing.assert_close(out, _t(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["rectangle", "cube", "sphere"])
def test_auto_uvs_match_jax(kind):
    center = (0.2, -0.1, 0.3)
    if kind == "rectangle":
        v, f = shapes.rectangle()
    elif kind == "cube":
        v, f = shapes.cube(flip_normals=True)
    else:
        v, f = shapes.sphere(center, 0.7, n_theta=6, n_phi=10)
    out = shapes.auto_uvs(kind, v, f, center=center)
    ref = jshapes.auto_uvs(kind, v, f, center=center)
    assert out.dtype == np.float32 and np.array_equal(out, ref)
    assert np.array_equal(shapes.auto_uvs("disk", v, f), np.zeros_like(ref))


def test_merge_carries_face_uv():
    v, f = shapes.rectangle()
    uv = shapes.auto_uvs("rectangle", v, f)
    parts = [(v, f, 0, uv), (v + 1.0, f, 1, None), (v, f, 2)]
    out = shapes.merge(parts)
    ref = jshapes.merge(parts)
    for a, b in zip(out, ref):
        assert np.array_equal(a, b)
    assert out[3].shape == (6, 3, 2) and not out[3][2:].any()


def test_hit_uv_matches_jax(textured):
    """The closest hit's barycentric uv of the frame's rays against
    cornell_textured's triangles: the soup's JAX's, the BVH route's the
    soup's."""
    _, scene, _ = textured
    _, _, ro, rd = integrator.frame_rays(scene)
    hit = intersect.intersect_all(ro, rd, scene.vertices, scene.faces)
    ref = jisect.intersect_all(jnp.asarray(ro.numpy()),
                               jnp.asarray(rd.numpy()),
                               jnp.asarray(scene.vertices.numpy()),
                               jnp.asarray(scene.faces.numpy()))
    ok = hit.valid
    assert float(ok.float().mean()) > 0.95
    assert np.array_equal(hit.prim.numpy(), np.asarray(ref.prim))
    torch.testing.assert_close(hit.uv[ok], _t(ref.uv)[ok], rtol=0,
                               atol=1e-6)
    hit_b, _ = integrator.trace_eye_rays_bvh(scene, ro, rd)
    assert torch.equal(hit_b.prim, hit.prim)
    torch.testing.assert_close(hit_b.uv[ok], hit.uv[ok], rtol=0, atol=1e-6)


def test_bump_to_normal_map_matches_jax():
    rng = np.random.default_rng(5)
    h = rng.random((9, 13)).astype(np.float32)
    for strength in (1.0, 4.0):
        out = layered.bump_to_normal_map(h, strength)
        ref = jlayered.bump_to_normal_map(h, strength)
        assert out.dtype == np.float32 and np.array_equal(out, ref)


def test_perturbed_normal_matches_jax(textured):
    """The NORMALMAP's shading normal from its texture at seeded uvs
    around seeded oriented normals (its flip back to ng included)."""
    _, _, jscene = textured
    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device=CPU)
    nmap = int(np.flatnonzero(np.asarray(jscene.materials.kind)
                              == NORMALMAP)[0])
    rng = np.random.default_rng(6)
    ng = rng.normal(size=(3000, 3)).astype(np.float32)
    ng /= np.linalg.norm(ng, axis=1, keepdims=True)
    uv = rng.uniform(-1, 2, (3000, 2)).astype(np.float32)
    mid = np.full(3000, nmap, np.int32)
    out = layered.perturbed_normal(scene.textures, scene.materials.tex_id[
        _t(mid).long()], _t(ng), _t(uv))
    ref = jlayered.perturbed_normal(jscene, jnp.asarray(mid),
                                    jnp.asarray(ng), jnp.asarray(uv))
    torch.testing.assert_close(out, _t(ref), rtol=0, atol=1e-6)
    assert float((out - _t(ng)).abs().amax(dim=-1).gt(1e-3).float().mean()) \
        > 0.5  # the map perturbs most normals


def test_textured_scene_loads_as_the_jax_loader(textured):
    """cornell_textured through both loaders: every leaf the JAX scene's
    (geometry, materials with their texture columns, face UVs), the
    bitmap stack too but the bump map's, which the port bakes into a
    normal map (C24); HK faces block shadow rays."""
    _, scene, jscene = textured
    ref = convert.scene_from_numpy(jax_scene_leaves(jscene), device=CPU)
    for name in ("faces", "material", "face_uv"):
        assert torch.equal(getattr(scene, name), getattr(ref, name)), name
    torch.testing.assert_close(scene.vertices, ref.vertices, rtol=0,
                               atol=1e-6)
    for k in ("kind", "albedo", "albedo2", "eta", "alpha", "exponent",
              "nested", "nested2", "tex_kind", "tex_scale", "tex_id"):
        assert torch.equal(getattr(scene.materials, k),
                           getattr(ref.materials, k)), k
    assert scene.textured() and scene.materials.host_kinds >= {NORMALMAP, HK}
    bump = scene.materials.tex_id[int(np.flatnonzero(
        np.asarray([m["name"] for m in textured[0]["materials"]])
        == "bumpmap")[0])]
    keep = [k for k in range(scene.textures.shape[0]) if k != int(bump)]
    assert torch.equal(scene.textures[keep], ref.textures[keep])
    assert torch.equal(scene.textures[bump], _t(layered.bump_to_normal_map(
        ref.textures[bump].numpy().mean(axis=-1), 4.0)))
    assert torch.equal(scene.opaque_faces(), ref.opaque_faces())
    hk = scene.materials.kind[scene.material] == HK
    assert bool(hk.any()) and bool(scene.opaque_faces()[hk].all())


def test_c24_jax_loader_reads_a_height_field_as_a_normal_map(textured):
    """ROADMAP C24: the JAX loader maps "bumpmap" to NORMALMAP and stacks
    the height field's bitmap as it is, so that perturbed_normal reads
    heights as tangent normals; bump_to_normal_map, whose docstring says
    the loader bakes height fields, is never called. The port bakes it."""
    desc, scene, jscene = textured
    names = [m["name"] for m in desc["materials"]]
    jb = names.index("bumpmap")
    assert int(jscene.materials.kind[jb]) == NORMALMAP
    height = jimage.read_image(desc["materials"][jb]["texture"]["filename"])
    tid = int(jscene.materials.tex_id[jb])
    assert np.array_equal(np.asarray(jscene.textures[tid]), height)
    baked = layered.bump_to_normal_map(height.mean(axis=-1), 4.0)
    assert np.abs(baked - height).max() > 0.1
    assert np.array_equal(scene.textures[tid].numpy(), baked)


def test_irawan_is_still_refused_naming_a11a(textured):
    desc = dict(textured[0], materials=textured[0]["materials"] + [
        {"name": "cloth", "type": "irawan"}])
    with pytest.raises(ValueError, match="irawan.*ROADMAP A11a"):
        loader.build_scene(desc, device=CPU)


def test_bitmap_stack_takes_one_resolution(textured, tmp_path):
    from alvrl_tpu_torch.io.image import write_pfm

    small = tmp_path / "small.pfm"
    write_pfm(small, np.ones((4, 4, 3), np.float32))
    mats = [dict(m) for m in textured[0]["materials"]]
    mats[1] = dict(mats[1], texture={"type": "bitmap",
                                     "filename": str(small)})
    with pytest.raises(ValueError, match="share a resolution"):
        loader.build_scene(dict(textured[0], materials=mats), device=CPU)


def test_untextured_scenes_keep_their_defaults():
    """A scene without textures: zero texture columns, zero UVs on the
    preset, the (1, 1, 1, 3) zero stack, not textured."""
    scene = presets.cornell_smoke(4, 4, device=CPU)
    mats = scene.materials
    assert not scene.textured() and not mats.host_textured
    assert not bool(mats.tex_kind.any()) and bool((mats.tex_scale == 1).all())
    assert tuple(scene.textures.shape) == (1, 1, 1, 3)
    assert tuple(scene.face_uv.shape) == (scene.faces.shape[0], 3, 2)
    assert not bool(scene.face_uv.any())
