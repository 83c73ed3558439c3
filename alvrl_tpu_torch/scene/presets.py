"""Benchmark scenes.

Counterpart of alvrl_tpu/scene/presets.py: cornell_smoke (BASELINE
configs 1-2 and 5), a closed Cornell box filled with a homogeneous
medium, a box blocker, one point light, and the camera inside the
medium; cornell_smoke_hg (BASELINE config 3), the same box with an
anisotropic HG medium; cornell_grid_smoke (BASELINE config 4), the
same box without the blocker, filled with a plume-like grid medium;
cornell_area_light, the box lit by a quad area light in its ceiling;
cornell_nested_smoke, the box in vacuum around a smoke-filled cube of
null faces (per-shape media); and cornell_textured_desc, config 1's box
with textured, normal-mapped, bump-mapped and HK surfaces, as a scene
file (the port's own, with its bitmaps made from a seed).
"""

from __future__ import annotations

from dataclasses import fields, replace

import numpy as np
import torch

from alvrl_tpu_torch.emitters.emitters import (
    AREA,
    make_emitters,
    make_point_emitters,
)
from alvrl_tpu_torch.geometry import shapes
from alvrl_tpu_torch.media.heterogeneous import make_grid_medium
from alvrl_tpu_torch.media.homogeneous import HomogeneousMedium, make_medium
from alvrl_tpu_torch.scene.scene import (
    DIFFUSE,
    Camera,
    Materials,
    Scene,
    look_at,
    make_materials,
)

# material ids used by the cornell scene
M_WHITE, M_RED, M_GREEN, M_BOX = 0, 1, 2, 3


def cornell_smoke(
    width=128,
    height=128,
    sigma_s=(0.8, 0.8, 0.8),
    sigma_a=(0.05, 0.05, 0.05),
    g=0.0,
    intensity=(8.0, 8.0, 8.0),
    with_blocker=True,
    device="cuda",
):
    """Cornell box [-1,1]^3 filled with a homogeneous medium: white
    floor, ceiling, back and front walls, red left (-x) and green right
    (+x) walls, a box blocker, a point light near the ceiling, and the
    camera just inside the front wall looking down +z."""
    parts = []
    # floor y=-1 (normal +y) and ceiling y=+1 (normal -y)
    v, f = shapes.rectangle()
    v = v @ np.array([[1, 0, 0], [0, 0, 1], [0, 1, 0]], np.float32).T
    parts.append((v + np.array([0, -1, 0], np.float32), f, M_WHITE))
    parts.append((v + np.array([0, 1, 0], np.float32), f[:, ::-1].copy(),
                  M_WHITE))
    # back wall z=+1 (normal -z) and front wall z=-1 (normal +z)
    v, f = shapes.rectangle()
    parts.append((v + np.array([0, 0, 1], np.float32), f[:, ::-1].copy(),
                  M_WHITE))
    parts.append((v + np.array([0, 0, -1], np.float32), f.copy(), M_WHITE))
    # left wall x=-1 (normal +x) and right wall x=+1 (normal -x)
    v, f = shapes.rectangle()
    v = v @ np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0]], np.float32).T
    parts.append((v + np.array([-1, 0, 0], np.float32), f, M_RED))
    parts.append((v + np.array([1, 0, 0], np.float32), f[:, ::-1].copy(),
                  M_GREEN))
    if with_blocker:
        bv, bf = shapes.cube()
        bv = bv * np.array([0.25, 0.5, 0.25], np.float32) + np.array(
            [-0.35, -0.5, 0.3], np.float32)
        parts.append((bv, bf, M_BOX))
    verts, faces, mat, _ = shapes.merge(parts)

    f32 = dict(dtype=torch.float32, device=device)
    materials = make_materials([DIFFUSE] * 4, [
        [0.725, 0.71, 0.68],   # white
        [0.63, 0.065, 0.05],   # red
        [0.14, 0.45, 0.091],   # green
        [0.725, 0.71, 0.68],   # blocker
    ], device=device)
    emitters = make_point_emitters([[0.0, 0.75, 0.2]], [list(intensity)],
                                   device=device)
    camera = Camera(
        to_world=torch.as_tensor(
            look_at([0, 0, -0.99], [0, 0, 1], [0, 1, 0]), **f32),
        fov_x_deg=torch.tensor(90.0, **f32),
        width=width,
        height=height,
    )
    return Scene(
        vertices=torch.as_tensor(verts, **f32),
        faces=torch.as_tensor(faces, dtype=torch.int64, device=device),
        material=torch.as_tensor(mat, dtype=torch.int64, device=device),
        materials=materials,
        emitters=emitters,
        medium=make_medium(sigma_a, sigma_s, g=g, device=device),
        camera=camera,
    )


def cornell_smoke_hg(width=256, height=256, g=0.8, device="cuda"):
    """BASELINE config 3: anisotropic HG phase (g=0.8) exercising the
    volSurfSamples surface-coupling path."""
    return cornell_smoke(width=width, height=height, g=g,
                         sigma_s=(0.6, 0.6, 0.6), sigma_a=(0.04, 0.04, 0.04),
                         device=device)


def cornell_grid_smoke(width=512, height=512, grid_res=48, device="cuda"):
    """BASELINE config 4: cornell_smoke without the blocker, filled with
    a grid medium on [-1, 1]^3 of grid_res^3 voxels, a vertical gaussian
    plume with pseudo-turbulent harmonics (made in float64 numpy, then
    cast, as the JAX preset makes it), sigma_t_color (1, 1.05, 1.1),
    albedo 0.92, HG g = 0.3."""
    r = grid_res
    z, y, x = np.meshgrid(np.linspace(-1, 1, r), np.linspace(-1, 1, r),
                          np.linspace(-1, 1, r), indexing="ij")
    rad2 = x ** 2 + z ** 2
    plume = np.exp(-6.0 * rad2 / (0.35 + 0.65 * (y + 1) / 2))
    turb = (0.5 * np.sin(7 * x + 5 * y) * np.cos(6 * z - 4 * y)
            + 0.3 * np.sin(13 * z + 11 * x))
    dens = np.clip(plume * (1.0 + 0.5 * turb), 0.0, None) * 2.5
    medium = make_grid_medium(dens.astype(np.float32), [1.0, 1.05, 1.1],
                              [0.92, 0.92, 0.92], g=0.3, device=device)
    base = cornell_smoke(width=width, height=height, with_blocker=False,
                         device=device)
    return replace(base, medium=medium)


def cornell_area_light(width=64, height=64, radiance=(6.0, 6.0, 6.0),
                       half=0.25, device="cuda", **kwargs):
    """cornell_smoke (its other arguments in kwargs) lit by a quad area
    light of side 2 half just under the ceiling in place of the point
    light (area.cpp): the quad is real geometry, two triangles of a
    black diffuse material appended last, and two AREA entries, each
    wound so that its face normal cross(e1, e2) points down into the
    box."""
    base = cornell_smoke(width=width, height=height, device=device, **kwargs)
    y = 0.999
    p0 = np.array([-half, y, -half], np.float32)
    e1 = np.array([2 * half, 0, 0], np.float32)
    e2 = np.array([0, 0, 2 * half], np.float32)
    quad_v = np.stack([p0, p0 + e1, p0 + e2, p0 + e1 + e2])
    quad_f = np.array([[0, 1, 2], [3, 2, 1]]) + base.vertices.shape[0]
    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    mats = base.materials
    black = mats.kind.shape[0]
    # the columns the JAX preset extends; the others read their last row
    # for the new id (Materials)
    materials = replace(
        mats, kind=torch.cat([mats.kind, torch.tensor([DIFFUSE], **i64)]),
        albedo=torch.cat([mats.albedo, torch.zeros((1, 3), **f32)]),
        eta=torch.cat([mats.eta, torch.ones(1, **f32)]),
        alpha=torch.cat([mats.alpha, torch.tensor([0.1], **f32)]),
        albedo2=torch.cat([mats.albedo2, torch.zeros((1, 3), **f32)]))
    emitters = make_emitters([AREA, AREA], [p0, p0 + e1 + e2],
                             [list(radiance)] * 2, tri_e1=[e1, -e1],
                             tri_e2=[e2, -e2], device=device)
    return replace(
        base,
        vertices=torch.cat([base.vertices, torch.as_tensor(quad_v, **f32)]),
        faces=torch.cat([base.faces, torch.as_tensor(quad_f, **i64)]),
        material=torch.cat([base.material,
                            torch.full((2,), black, **i64)]),
        materials=materials, emitters=emitters,
        face_emitter=torch.cat([torch.full((base.faces.shape[0],), -1, **i64),
                                torch.tensor([0, 1], **i64)]))


def cornell_nested_smoke(width=64, height=64, cube_half=0.5,
                         sigma_s=(0.8, 0.8, 0.8), sigma_a=(0.05, 0.05, 0.05),
                         g=0.0, exterior=None, device="cuda", **kwargs):
    """cornell_smoke without the blocker, in vacuum (or the medium
    `exterior`, (sigma_a, sigma_s, g)), with a smoke-filled cube of
    null faces at the centre: the per-shape nested-media scene (media
    table ids 0 outside, 1 inside)."""
    from alvrl_tpu_torch.media.table import make_media_table
    from alvrl_tpu_torch.scene.scene import NULL

    base = cornell_smoke(width=width, height=height, with_blocker=False,
                         device=device, **kwargs)
    cv, cf = shapes.cube()
    cv = cv * np.float32(cube_half)
    n_v, n_f = base.vertices.shape[0], base.faces.shape[0]
    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    faces = torch.cat([base.faces, torch.as_tensor(cf, **i64) + n_v])
    mats = base.materials
    null_id = mats.kind.shape[0]
    # every column extended by its last row, the kind by NULL
    cols = {f.name: getattr(mats, f.name) for f in fields(mats) if f.init}
    cols = {k: torch.cat([v, v[-1:]]) for k, v in cols.items()}
    cols["kind"][-1] = NULL
    ext_a, ext_s, ext_g = ((0.0,) * 3, (0.0,) * 3, 0.0) if exterior is None \
        else exterior
    media = make_media_table([list(ext_a), list(sigma_a)],
                             [list(ext_s), list(sigma_s)], g=[ext_g, g],
                             device=device)
    return replace(
        vacuumize(base),
        vertices=torch.cat([base.vertices, torch.as_tensor(cv, **f32)]),
        faces=faces,
        material=torch.cat([base.material,
                            torch.full((cf.shape[0],), null_id, **i64)]),
        materials=Materials(**cols), media=media,
        face_med_int=torch.cat([torch.zeros((n_f,), **i64),
                                torch.ones((cf.shape[0],), **i64)]),
        face_med_ext=torch.zeros((faces.shape[0],), **i64),
        face_emitter=torch.full((faces.shape[0],), -1, **i64))


def vacuumize(scene: Scene) -> Scene:
    """The scene with vacuum for its medium (no absorption, no
    scattering, sampling weight 0)."""
    f32 = dict(dtype=torch.float32, device=scene.device)
    return replace(scene, medium=HomogeneousMedium(
        sigma_a=torch.zeros(3, **f32), sigma_s=torch.zeros(3, **f32),
        g=torch.tensor(0.0, **f32),
        sampling_weight=torch.tensor(0.0, **f32)))


TEXTURE_RES = 64  # the bitmaps' side, cornell_textured_desc


def _rect_at(material, rows):
    """A rectangle shape ([-1, 1]^2 at z = 0, shapes.auto_uvs' UVs) under
    the 3x4 to_world `rows`."""
    return {"type": "rectangle", "material": material,
            "to_world": [list(r) for r in rows] + [[0, 0, 0, 1]]}


def _block(material, at, half):
    return {"type": "cube", "material": material, "to_world": [
        [half[0], 0, 0, at[0]], [0, half[1], 0, at[1]],
        [0, 0, half[2], at[2]], [0, 0, 0, 1]]}


def texture_bitmaps(seed=0, res=TEXTURE_RES):
    """The three (res, res, 3) float32 bitmaps of cornell_textured_desc,
    made from `seed`: a colour pattern (the back wall's texture), a
    tangent-space normal map and a height field (three equal channels)."""
    rng = np.random.default_rng(seed)
    y, x = np.meshgrid(np.linspace(0, 1, res, endpoint=False),
                       np.linspace(0, 1, res, endpoint=False), indexing="ij")
    phase = rng.uniform(0, 2 * np.pi, size=(3, 2))
    colour = np.stack([0.5 + 0.45 * np.sin(2 * np.pi * (k + 2) * x + ph[0])
                       * np.cos(2 * np.pi * (k + 1) * y + ph[1])
                       for k, ph in enumerate(phase)], -1)
    colour = colour * rng.uniform(0.7, 1.0, size=(res, res, 1))
    n = np.stack([0.6 * np.sin(8 * np.pi * x + phase[0, 0]),
                  0.6 * np.cos(6 * np.pi * y + phase[1, 1]),
                  np.ones_like(x)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    height = (np.sin(10 * np.pi * x) * np.sin(8 * np.pi * y)
              + 0.3 * rng.standard_normal((res, res)))
    return [a.astype(np.float32) for a in (
        np.clip(colour, 0.0, 1.0), n * 0.5 + 0.5,
        np.repeat(height[..., None], 3, axis=-1))]


def textured_cube_field(field, textured, cube_materials, n_walls=12):
    """The cube field `field` (scripts/bench_bvh_large.cube_field_scene:
    its box's n_walls wall triangles, then 12 a cube) with the surfaces of
    cornell_textured (`textured`, its loaded Scene, whose first n_walls
    triangles are the box's walls): those wall triangles with their
    materials and UVs in place of the field's, and the materials
    `cube_materials` (ids into its table) on the cubes in turn, each
    cube's faces with shapes.auto_uvs("cube") of the canonical cube. The
    table and the bitmap stack are textured's; the camera, medium and
    light the field's."""
    dev = field.device
    n_cubes = (field.faces.shape[0] - n_walls) // 12
    cube_v, cube_f = shapes.cube()
    cube_uv = torch.as_tensor(shapes.auto_uvs("cube", cube_v, cube_f),
                              device=dev)
    ids = torch.as_tensor(np.asarray(cube_materials), device=dev)
    nv = textured.vertices.shape[0]
    return replace(
        field,
        vertices=torch.cat([textured.vertices.to(dev), field.vertices]),
        faces=torch.cat([textured.faces[:n_walls].to(dev),
                         field.faces[n_walls:] + nv]),
        material=torch.cat([textured.material[:n_walls].to(dev),
                            ids[torch.arange(n_cubes, device=dev)
                                % len(ids)].repeat_interleave(12)]),
        materials=textured.materials, textures=textured.textures,
        face_uv=torch.cat([textured.face_uv[:n_walls].to(dev),
                           cube_uv.repeat(n_cubes, 1, 1)]),
        face_emitter=None)


def cornell_textured_desc(dirname, width=128, height=128, seed=0):
    """cornell_textured: config 1's box (the camera, the homogeneous
    medium and the point light of cornell_smoke) whose surfaces carry
    the texture stack, as a JSON scene dict; its three bitmaps
    (texture_bitmaps(seed)) are written into `dirname` as .pfm files,
    which the dict names. The back wall takes a bitmap texture, the floor
    a checker, the ceiling grid lines, the left wall value noise over a
    rough plastic, the right wall an HK slab, one block a normal map over
    a rough plastic, the other a bump map over a checkered diffuse; the
    front wall, behind the camera, is white."""
    import os

    from alvrl_tpu_torch.io.image import write_pfm

    names = [os.path.join(dirname, f"{n}.pfm")
             for n in ("wall", "normal", "height")]
    for name, img in zip(names, texture_bitmaps(seed)):
        write_pfm(name, img)
    white = [0.725, 0.71, 0.68]
    materials = [
        {"name": "white", "type": "diffuse", "albedo": white},
        {"name": "bitmap", "type": "diffuse", "albedo": [0.9, 0.85, 0.8],
         "texture": {"type": "bitmap", "filename": names[0], "scale": 1.0}},
        {"name": "checker", "type": "diffuse", "albedo": white,
         "texture": {"type": "checker", "scale": 4.0,
                     "albedo2": [0.15, 0.15, 0.2]}},
        {"name": "grid", "type": "diffuse", "albedo": white,
         "texture": {"type": "grid", "scale": 3.0,
                     "albedo2": [0.1, 0.3, 0.6]}},
        {"name": "noise", "type": "roughplastic", "alpha": 0.3,
         "albedo": [0.63, 0.065, 0.05],
         "texture": {"type": "noise", "scale": 6.0,
                     "albedo2": [0.9, 0.6, 0.2]}},
        {"name": "hk", "type": "hk", "sigma_s": [0.8, 0.6, 0.4],
         "sigma_a": [0.05, 0.05, 0.1], "thickness": 0.5, "g": 0.3},
        {"name": "plastic", "type": "roughplastic", "alpha": 0.2,
         "albedo": [0.3, 0.5, 0.6]},
        {"name": "normalmap", "type": "normalmap", "nested": "plastic",
         "texture": {"type": "bitmap", "filename": names[1]}},
        {"name": "bump_base", "type": "diffuse", "albedo": [0.6, 0.6, 0.3],
         "texture": {"type": "checker", "scale": 8.0,
                     "albedo2": [0.2, 0.3, 0.6]}},
        {"name": "bumpmap", "type": "bumpmap", "nested": "bump_base",
         "strength": 4.0,
         "texture": {"type": "bitmap", "filename": names[2]}},
    ]
    shapes_ = [
        _rect_at("bitmap", [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 1]]),
        _rect_at("white", [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, -1]]),
        _rect_at("checker", [[1, 0, 0, 0], [0, 0, 0, -1], [0, 1, 0, 0]]),
        _rect_at("grid", [[1, 0, 0, 0], [0, 0, 0, 1], [0, 1, 0, 0]]),
        _rect_at("noise", [[0, 0, 0, -1], [0, 1, 0, 0], [1, 0, 0, 0]]),
        _rect_at("hk", [[0, 0, 0, 1], [0, 1, 0, 0], [1, 0, 0, 0]]),
        _block("normalmap", (-0.45, -0.55, 0.35), (0.3, 0.45, 0.25)),
        _block("bumpmap", (0.45, -0.65, 0.4), (0.3, 0.35, 0.25)),
    ]
    return {
        "camera": {"type": "perspective", "origin": [0, 0, -0.99],
                   "target": [0, 0, 1], "fov": 90, "width": width,
                   "height": height},
        "medium": {"type": "homogeneous", "sigma_s": [0.8] * 3,
                   "sigma_a": [0.05] * 3, "g": 0.0},
        "materials": materials,
        "shapes": shapes_,
        "emitters": [{"type": "point", "position": [0.0, 0.75, 0.2],
                      "intensity": [8.0, 8.0, 8.0]}],
    }
