"""Scene description loader.

Counterpart of alvrl_tpu/scene/loader.py: the declarative JSON (or
python-dict) scene format of the reference's XML scene system
(SceneHandler, src/librender/scenehandler.cpp), `$var` substitution as
the -D flag (mitsuba.cpp:52-86), and the converter of the Mitsuba 0.5
XML subset into that format, copied whole so that it gives the JAX
package's dict.

build_scene builds the subset the port renders, with the JAX package's
column order (materials in declaration order, then "default" if a
shape needs it; faces in shape order), so that the two scenes compare
leaf by leaf:
  * materials "diffuse", "twosided" (diffuse), "null", "mirror" and
    "conductor" (MIRROR), "dielectric" and "thindielectric" (DIELECTRIC),
    "roughconductor", "roughplastic", "plastic", "phong", "ward",
    "difftrans", "roughdielectric", the wrappers "mask" and "mixture"
    (also "mixturebsdf", "blendbsdf"), the layers "coating" and
    "roughcoating", "normalmap" and "bumpmap" (NORMALMAP over `nested`,
    the normal texture its bitmap; a bumpmap's bitmap is a height field,
    baked into a normal map with layered.bump_to_normal_map, its
    channels' mean the height, "strength" its scale) and the "hk" slab
    (sigma_s, sigma_a, thickness, g), with the JAX loader's fields and
    defaults (alpha or g, alpha_v, specular, exponent or thickness,
    opacity or weight, distribution (GGX by default; the XML converter
    writes Beckmann where the reference's XML leaves it out), sigma_a or
    albedo2, and nested and nested2 by name);
  * a material's "texture": "checker", "grid" or "noise" (albedo2 and
    scale) or "bitmap" (an image file: .pfm, .npy, .hdr, .png; scale),
    the bitmaps stacked into one (K, H, W, 3) array, so that all of a
    scene's must share a resolution, as in the JAX loader;
  * shapes "rectangle", "cube", "sphere", "disk", "cylinder", "obj",
    "ply", "serialized" and "trimesh", each with an optional to_world,
    with the JAX loader's UVs: the analytic ones of the rectangle, cube
    and sphere (shapes.auto_uvs), an OBJ's `vt` records, a PLY's or a
    serialized mesh's per-vertex UVs, zeros elsewhere;
  * "point", "spot", "directional", "collimated" and "constant"
    emitters; one environment emitter, "envmap" (an image file: .pfm,
    .npy, .hdr), "sky" or "sunsky" (the Preetham sky baked into the map,
    sunsky's sun disk too), and "sun" (a directional entry of the sun's
    attenuated irradiance); and "area" emitters as real geometry: two
    triangles of the black "_emitter_black" material (or the emitter's
    "material") per quad after the shapes, and two AREA entries per quad
    after the other emitters, which those faces emit as;
  * a "homogeneous" medium (phase "hg", "isotropic", "rayleigh" or a
    {"type": "mixture", "components": [...]} dict; strategy "balance",
    "single" (with "channel"), "manual" (with "density") or "maximum")
    or a "grid" medium (a scalar density from "density_npy" or an
    inline "density", as the converter writes a .vol grid; box_min /
    box_max);
  * per-shape nested media: a "media" list of homogeneous media (id 0
    the exterior), which shapes name by "interior_medium" and
    "exterior_medium";
  * the "perspective" camera (and "radiancemeter", a perspective camera
    in the JAX package too).
Anything else raises ValueError with the kind and the ROADMAP item that
ports it: nothing is dropped silently.
"""

from __future__ import annotations

import json
import re

import numpy as np
import torch

from alvrl_tpu_torch.bsdf.layered import bump_to_normal_map
from alvrl_tpu_torch.bsdf.microfacet import MF_BECKMANN, MF_GGX, MF_PHONG
from alvrl_tpu_torch.emitters import emitters as em_mod
from alvrl_tpu_torch.emitters import sunsky
from alvrl_tpu_torch.emitters.envmap import make_envmap
from alvrl_tpu_torch.geometry import shapes as shp
from alvrl_tpu_torch.io import image as img_io
from alvrl_tpu_torch.io import mesh as mesh_io
from alvrl_tpu_torch.io.vol import read_vol
from alvrl_tpu_torch.media import homogeneous as hmed
from alvrl_tpu_torch.media import phase as ph
from alvrl_tpu_torch.media.heterogeneous import make_grid_medium
from alvrl_tpu_torch.media.homogeneous import make_medium
from alvrl_tpu_torch.media.phase import HG, RAYLEIGH
from alvrl_tpu_torch.media.table import make_media_table
from alvrl_tpu_torch.scene.scene import (
    COATING,
    DIELECTRIC,
    DIFFTRANS,
    DIFFUSE,
    HK,
    MASK,
    MIRROR,
    MIXTURE,
    NORMALMAP,
    NULL,
    PERSPECTIVE,
    PHONG,
    PLASTIC,
    ROUGH_COATING,
    ROUGH_CONDUCTOR,
    ROUGH_DIELECTRIC,
    ROUGH_PLASTIC,
    WARD,
    Camera,
    Scene,
    look_at,
    make_materials,
)

_MAT_KINDS = {
    "diffuse": DIFFUSE, "twosided": DIFFUSE, "null": NULL, "mirror": MIRROR,
    "conductor": MIRROR, "dielectric": DIELECTRIC,
    "thindielectric": DIELECTRIC, "roughconductor": ROUGH_CONDUCTOR,
    "roughplastic": ROUGH_PLASTIC, "plastic": PLASTIC, "phong": PHONG,
    "ward": WARD, "difftrans": DIFFTRANS, "mask": MASK,
    "mixturebsdf": MIXTURE, "blendbsdf": MIXTURE, "mixture": MIXTURE,
    "coating": COATING, "roughdielectric": ROUGH_DIELECTRIC,
    "roughcoating": ROUGH_COATING, "normalmap": NORMALMAP,
    "bumpmap": NORMALMAP, "hk": HK,
}
# the JAX package's other material kind: the converter carries it,
# build_scene refuses it
_UNPORTED_MATERIALS = ("irawan",)
_TEX_KINDS = {"none": 0, "checker": 1, "grid": 2, "noise": 3, "bitmap": 4}
_DIST_KINDS = {"beckmann": MF_BECKMANN, "ggx": MF_GGX, "as": MF_PHONG,
               "phong": MF_PHONG}
_CAM_KINDS = {"perspective": PERSPECTIVE, "radiancemeter": PERSPECTIVE}
_PHASE_KINDS = {"hg": HG, "isotropic": HG, "rayleigh": RAYLEIGH}
_STRATEGIES = {"balance": hmed.BALANCE, "single": hmed.SINGLE,
               "manual": hmed.MANUAL, "maximum": hmed.MAXIMUM}
_EM_KINDS = {"point": em_mod.POINT, "spot": em_mod.SPOT,
             "directional": em_mod.DIRECTIONAL, "constant": em_mod.CONSTANT,
             "collimated": em_mod.COLLIMATED}
# kinds the JAX package builds and the port does not, with the ROADMAP
# item that ports them
_LATER = {
    "shape": {"heightfield": "A11", "hair": "A11"},
    "sensor": {"thinlens": "A11", "orthographic": "A11", "spherical": "A11",
               "telecentric": "A11", "perspective_rdist": "A11"},
}


def _refuse(what, kind, item):
    raise ValueError(f"{what} {kind!r} is not ported (ROADMAP {item})")


def _kind(what, kind, table):
    """table[kind], or ValueError naming the kind and its ROADMAP item."""
    if kind in table:
        return table[kind]
    if kind in _LATER.get(what, {}):
        _refuse(what, kind, _LATER[what][kind])
    raise ValueError(f"unknown {what} type {kind!r}")


def _substitute(text: str, defines: dict) -> str:
    """$key -> value substitution (the -D flag, mitsuba.cpp:80)."""
    for k, v in (defines or {}).items():
        text = text.replace(f"${k}", str(v))
    return text


def load_json(path_or_dict, defines=None, device="cuda") -> Scene:
    if isinstance(path_or_dict, dict):
        desc = path_or_dict
    else:
        with open(path_or_dict) as f:
            desc = json.loads(_substitute(f.read(), defines))
    return build_scene(desc, device=device)


def _materials(desc, device):
    """(Materials, name -> id) in the JAX package's order."""
    mats = list(desc.get("materials", [{"name": "default",
                                        "type": "diffuse",
                                        "albedo": [0.5, 0.5, 0.5]}]))
    # area emitters are real geometry (area.cpp): their faces take a
    # black diffuse material unless one is named
    if any(e["type"] == "area" for e in desc.get("emitters", [])) and not any(
            mdesc.get("name") == "_emitter_black" for mdesc in mats):
        mats.append({"name": "_emitter_black", "type": "diffuse",
                     "albedo": [0.0, 0.0, 0.0]})
    # shapes without an explicit material fall back to "default"
    names = {mdesc.get("name", f"mat{i}") for i, mdesc in enumerate(mats)}
    if "default" not in names and any(
            s.get("material", "default") == "default"
            for s in desc.get("shapes", [])):
        mats.append({"name": "default", "type": "diffuse",
                     "albedo": [0.5, 0.5, 0.5]})
    name_to_id = {mdesc.get("name", f"mat{i}"): i
                  for i, mdesc in enumerate(mats)}
    cols = {k: [] for k in ("kinds", "albedos", "etas", "alphas", "specular",
                            "exponent", "alpha_v", "opacity", "dist",
                            "nested", "nested2", "albedo2", "tex_kinds",
                            "tex_scales", "tex_id")}
    bitmaps = []
    for mdesc in mats:
        mt = mdesc["type"]
        if mt in _UNPORTED_MATERIALS:
            _refuse("material", mt, "A11a")
        cols["kinds"].append(_kind("material", mt, _MAT_KINDS))
        _texture(mdesc, cols, bitmaps)
        cols["albedos"].append(mdesc.get("albedo",
                                         mdesc.get("sigma_s", [1.0] * 3)))
        cols["etas"].append(mdesc.get("eta", 1.0))
        cols["alphas"].append(mdesc.get("alpha", mdesc.get("g", 0.1)))
        cols["specular"].append(mdesc.get("specular", [0.2] * 3))
        # a coat's thickness rides the exponent column
        cols["exponent"].append(mdesc.get("exponent",
                                          mdesc.get("thickness", 30.0)))
        cols["alpha_v"].append(mdesc.get("alpha_v", mdesc.get("alpha", 0.1)))
        # the mask's opacity, the mixture's first weight
        cols["opacity"].append(mdesc.get("opacity", mdesc.get("weight", 1.0)))
        cols["dist"].append(_DIST_KINDS[mdesc.get("distribution", "ggx")])
        for k in ("nested", "nested2"):
            cols[k].append(name_to_id[mdesc[k]] if k in mdesc else 0)
    materials = make_materials(device=device, **cols)
    return materials, name_to_id, _texture_stack(bitmaps, device)


def _texture(mdesc, cols, bitmaps):
    """A material's texture columns (kind, scale, albedo2, bitmap id), as
    the JAX loader reads them; a bitmap's image goes onto `bitmaps`, a
    bumpmap's height field baked into a normal map first."""
    tdesc = mdesc.get("texture")
    if tdesc is None:
        cols["tex_kinds"].append(0)
        cols["tex_scales"].append(1.0)
        # a coat's or slab's absorption sigma_a rides the albedo2 column
        cols["albedo2"].append(mdesc.get("sigma_a",
                                         mdesc.get("albedo2", [0.0] * 3)))
        cols["tex_id"].append(0)
        return
    cols["tex_kinds"].append(_kind("texture", tdesc["type"], _TEX_KINDS))
    cols["tex_scales"].append(tdesc.get("scale", 1.0))
    cols["albedo2"].append(tdesc.get("albedo2", [0.0] * 3))
    if tdesc["type"] != "bitmap":
        cols["tex_id"].append(0)
        return
    img = np.asarray(img_io.read_image(tdesc["filename"]), np.float32)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    if mdesc["type"] == "bumpmap":
        # the height field as a normal map (the JAX loader reads it as
        # one: ROADMAP C24)
        img = bump_to_normal_map(img[..., :3].mean(axis=-1),
                                 mdesc.get("strength", 1.0))
    cols["tex_id"].append(len(bitmaps))
    bitmaps.append(img)


def _texture_stack(bitmaps, device):
    """The (K, H, W, 3) stack of a scene's bitmaps (one resolution), or
    None (the zero stack) without one."""
    if not bitmaps:
        return None
    shapes = {im.shape[:2] for im in bitmaps}
    if len(shapes) > 1:
        raise ValueError("all bitmap textures in one scene must share a "
                         f"resolution (got {sorted(shapes)}): the texture "
                         "stack is a single (K, H, W, 3) array")
    return torch.as_tensor(np.stack([im[..., :3] for im in bitmaps]),
                           dtype=torch.float32, device=device)


def _shape(sdesc):
    """One shape description -> (vertices (V, 3) float32, faces (F, 3),
    face_uv (F, 3, 2) or None)."""
    st = sdesc["type"]
    if "to_world_t1" in sdesc:
        _refuse("shape option", "to_world_t1", "A11")
    tw = sdesc.get("to_world")
    tw = np.asarray(tw, np.float32) if tw is not None else None
    face_uv = None
    if st == "rectangle":
        v, f = shp.rectangle()
        face_uv = shp.auto_uvs("rectangle", v, f)
    elif st == "cube":
        v, f = shp.cube(flip_normals=sdesc.get("flip_normals", False))
        face_uv = shp.auto_uvs("cube", v, f)
    elif st == "sphere":
        center = sdesc.get("center", (0, 0, 0))
        v, f = shp.sphere(center, sdesc.get("radius", 1.0),
                          n_theta=sdesc.get("n_theta", 16),
                          n_phi=sdesc.get("n_phi", 32))
        face_uv = shp.auto_uvs("sphere", v, f, center=center)
    elif st == "obj":
        v, f, face_uv = mesh_io.load_obj_uv(sdesc["filename"])
    elif st == "ply":
        v, f, face_uv = mesh_io.load_ply_uv(sdesc["filename"])
    elif st == "serialized":
        v, f, _, vuv = mesh_io.load_serialized(sdesc["filename"],
                                               sdesc.get("shape_index", 0))
        if vuv is not None:
            face_uv = vuv[np.asarray(f)]
    elif st == "trimesh":
        # an inline triangle mesh (vertex and face lists in the dict)
        v = np.asarray(sdesc["vertices"], np.float32).reshape(-1, 3)
        f = np.asarray(sdesc["faces"], np.int32).reshape(-1, 3)
    elif st == "disk":
        return (*shp.disk(n_phi=sdesc.get("n_phi", 48), to_world=tw), None)
    elif st == "cylinder":
        v, f = shp.cylinder(sdesc.get("p0", (0, 0, 0)),
                            sdesc.get("p1", (0, 0, 1)),
                            sdesc.get("radius", 1.0),
                            n_phi=sdesc.get("n_phi", 32))
    else:
        _kind("shape", st, {})
    if tw is not None:
        v = shp.apply_transform(tw, v)
    return v, f, face_uv


def _medium(desc, device):
    mdesc = desc.get("medium", {"type": "homogeneous",
                                "sigma_s": [0.5] * 3, "sigma_a": [0.05] * 3})
    phase_desc = mdesc.get("phase", "hg")
    phase_params = None
    if isinstance(phase_desc, dict):
        # {"type": "mixture", "components": [{"type": "hg" | "rayleigh",
        # "g": .., "weight": ..}, ...]} (mixturephase.cpp)
        if phase_desc.get("type") != "mixture":
            raise ValueError(f"unsupported phase dict {phase_desc}")
        comps = phase_desc["components"]
        phase_kind = ph.MIXTURE
        phase_params = ph.mixture_params(
            [c.get("weight", 1.0 / len(comps)) for c in comps],
            [_kind("phase", c.get("type", "hg"), _PHASE_KINDS)
             for c in comps],
            [c.get("g", 0.0) for c in comps], device=device)
    else:
        phase_kind = _kind("phase", phase_desc, _PHASE_KINDS)
    if mdesc["type"] == "homogeneous":
        strategy = _kind("sampling strategy",
                         mdesc.get("strategy", "balance"), _STRATEGIES)
        if mdesc.get("channel", 0) not in (0, 1, 2):
            raise ValueError(f"sampling strategy {mdesc['strategy']!r}: "
                             f"channel {mdesc['channel']} is not 0, 1 or 2")
        return make_medium(mdesc.get("sigma_a", [0.0] * 3),
                           mdesc.get("sigma_s", [0.5] * 3),
                           g=mdesc.get("g", 0.0), phase_kind=phase_kind,
                           strategy=strategy,
                           channel=mdesc.get("channel", 0),
                           density=mdesc.get("density", 1.0),
                           phase_params=phase_params, device=device)
    if phase_params is not None:
        raise ValueError("a mixture phase takes a homogeneous medium")
    if mdesc["type"] == "grid":
        if "density_npy" in mdesc:
            density = np.load(mdesc["density_npy"])
        else:
            density = np.asarray(mdesc["density"], np.float32)
        if density.ndim != 3:
            _refuse("grid density of shape", density.shape, "A6")
        return make_grid_medium(
            density, mdesc.get("sigma_t", [1.0] * 3),
            mdesc.get("albedo", [0.9] * 3), g=mdesc.get("g", 0.0),
            box_min=mdesc.get("box_min", (-1, -1, -1)),
            box_max=mdesc.get("box_max", (1, 1, 1)),
            scale=mdesc.get("scale", 1.0), phase_kind=phase_kind,
            device=device)
    raise ValueError(f"unknown medium type {mdesc['type']!r}")


def _area_quads(desc, name_to_id, verts, faces, mat_ids):
    """The area emitters' quads appended to the geometry (two triangles
    each), their emitter entries (two each, the second triangle's from
    its far corner with the edges negated) and each face's entry among
    them (-1 for the other faces)."""
    entries = []
    face_emitter = np.full((len(faces),), -1, np.int64)
    for e in desc.get("emitters", []):
        if e["type"] != "area":
            continue
        p0, e1, e2 = (np.asarray(e[k], np.float32) for k in ("p0", "e1", "e2"))
        quad_f = np.asarray([[0, 1, 2], [3, 2, 1]], np.int32) + len(verts)
        verts = np.concatenate([verts, np.stack([p0, p0 + e1, p0 + e2,
                                                 p0 + e1 + e2])])
        faces = np.concatenate([faces, quad_f])
        m_id = name_to_id.get(e.get("material", "_emitter_black"),
                              name_to_id.get("_emitter_black", 0))
        mat_ids = np.concatenate([mat_ids, np.full((2,), m_id, np.int32)])
        face_emitter = np.concatenate([face_emitter, [len(entries),
                                                      len(entries) + 1]])
        rad = e.get("radiance", [1.0, 1.0, 1.0])
        entries.append({"type": "_area", "position": list(p0),
                        "intensity": rad, "e1": list(e1), "e2": list(e2)})
        entries.append({"type": "_area", "position": list(p0 + e1 + e2),
                        "intensity": rad, "e1": list(-e1), "e2": list(-e2)})
    return verts, faces, mat_ids, entries, face_emitter


def _environment(e, device):
    """The EnvMap of an "envmap", "sky" or "sunsky" emitter."""
    if e["type"] == "envmap":
        return make_envmap(img_io.read_image(e["filename"]),
                           scale=e.get("scale", 1.0),
                           azimuth_deg=e.get("azimuth", 0.0), device=device)
    res = e.get("resolution", 256)
    return sunsky.sky_envmap(
        e.get("sun_direction", [0.3, 0.8, 0.2]),
        turbidity=e.get("turbidity", 3.0), width=res, height=res // 2,
        scale=e.get("scale", 1.0), with_sun=e["type"] == "sunsky",
        sun_scale=e.get("sun_scale", 1.0), device=device)


def _emitters(desc, area_entries, device):
    """The emitter table: the scene's emitters in order (an environment
    emitter as an ENVMAP entry, a "sun" as a directional one), the area
    entries last, as the JAX package orders them; and the number of
    entries before the area ones."""
    envs = [e["type"] for e in desc.get("emitters", [])
            if e["type"] in ("envmap", "sky", "sunsky")]
    if len(envs) > 1:
        raise ValueError("only one environment emitter supported, got "
                         + " and ".join(envs))
    edescs = []
    env = None
    for e in desc.get("emitters", []):
        et = e["type"]
        if et in ("envmap", "sky", "sunsky"):
            env = _environment(e, device)
            edescs.append({"type": "_envmap"})
        elif et == "sun":  # sunsky's disk is baked into its map
            sd = e.get("sun_direction", [0.3, 0.8, 0.2])
            rad = sunsky.sun_rgb_radiance(sd, e.get("turbidity", 3.0),
                                          e.get("sun_scale", 1.0))
            sd = np.asarray(sd, np.float64)
            edescs.append({"type": "directional",
                           "direction": list(-sd / np.linalg.norm(sd)),
                           "intensity": list(rad * sunsky.SUN_SOLID_ANGLE)})
        elif et != "area":
            _kind("emitter", et, _EM_KINDS)
            edescs.append(e)
    n_base = len(edescs)
    edescs += area_entries
    kinds = dict(_EM_KINDS, _area=em_mod.AREA, _envmap=em_mod.ENVMAP)
    return em_mod.make_emitters(
        [kinds[e["type"]] for e in edescs],
        np.asarray([e.get("position", [0, 0, 0]) for e in edescs],
                   np.float32).reshape(-1, 3),
        np.asarray([e.get("intensity", e.get("irradiance", e.get(
            "power", [1, 1, 1]))) for e in edescs],
            np.float32).reshape(-1, 3),
        np.asarray([e.get("direction", [0, 0, 1]) for e in edescs],
                   np.float32).reshape(-1, 3),
        [e.get("cutoff", 20.0) for e in edescs],
        [e.get("beam", 15.0) for e in edescs],
        np.asarray([e.get("e1", [0, 0, 0]) for e in edescs],
                   np.float32).reshape(-1, 3),
        np.asarray([e.get("e2", [0, 0, 0]) for e in edescs],
                   np.float32).reshape(-1, 3),
        env=env, device=device), n_base


def build_scene(desc: dict, device="cuda") -> Scene:
    """The scene of a JSON scene dict (see the module), on `device`."""
    materials, name_to_id, textures = _materials(desc, device)
    parts = []
    for sdesc in desc.get("shapes", []):
        v, f, face_uv = _shape(sdesc)
        parts.append((v, f, name_to_id[sdesc.get("material", "default")],
                      face_uv))
    verts, faces, mat_ids, face_uvs = shp.merge(parts)
    n_shape_faces = len(faces)
    verts, faces, mat_ids, area_entries, face_emitter = _area_quads(
        desc, name_to_id, verts, faces, mat_ids)
    emitters, n_base = _emitters(desc, area_entries, device)
    face_emitter[face_emitter >= 0] += n_base

    cdesc = desc["camera"]
    f32 = dict(dtype=torch.float32, device=device)
    camera = Camera(
        to_world=torch.as_tensor(look_at(
            cdesc["origin"], cdesc["target"], cdesc.get("up", [0, 1, 0])),
            **f32),
        fov_x_deg=torch.tensor(np.float32(cdesc.get("fov", 60.0)), **f32),
        width=int(cdesc.get("width", 128)),
        height=int(cdesc.get("height", 128)),
        kind=_kind("sensor", cdesc.get("type", "perspective"), _CAM_KINDS),
    )
    i64 = dict(dtype=torch.int64, device=device)
    nested = {}
    n_media = len(desc.get("media", []))
    for sd in desc.get("shapes", []):
        for side in ("interior_medium", "exterior_medium"):
            if not 0 <= sd.get(side, 0) < max(n_media, 1):
                raise ValueError(f"{side} {sd[side]} names no medium of the "
                                 f"scene's {n_media} per-shape media")
    if "media" in desc:
        mlist = desc["media"]
        for mm in mlist:
            if mm.get("type", "homogeneous") != "homogeneous":
                raise ValueError("media: per-shape media are homogeneous, "
                                 f"got {mm['type']!r}")
        nested["media"] = make_media_table(
            [mm.get("sigma_a", [0.0] * 3) for mm in mlist],
            [mm.get("sigma_s", [0.0] * 3) for mm in mlist],
            g=[mm.get("g", 0.0) for mm in mlist], device=device)
        n_extra = len(faces) - n_shape_faces  # the area quads': id 0
        for key, side in (("face_med_int", "interior_medium"),
                          ("face_med_ext", "exterior_medium")):
            ids = [sd.get(side, 0) for sd, (_, f, _, _) in
                   zip(desc.get("shapes", []), parts) for _ in range(len(f))]
            nested[key] = torch.as_tensor(ids + [0] * n_extra, **i64)
    return Scene(
        vertices=torch.as_tensor(verts, **f32),
        faces=torch.as_tensor(faces, **i64),
        material=torch.as_tensor(mat_ids, **i64),
        materials=materials,
        emitters=emitters,
        medium=_medium(desc, device),
        camera=camera,
        face_emitter=torch.as_tensor(face_emitter, **i64),
        # the area quads' faces take zero UVs
        face_uv=torch.as_tensor(np.concatenate([face_uvs, np.zeros(
            (len(faces) - n_shape_faces, 3, 2), np.float32)]), **f32),
        textures=textures,
        **nested,
    )


# ---------------------------------------------------------------------------
# Mitsuba 0.5 XML subset converter
# ---------------------------------------------------------------------------

def convert_mitsuba_xml(path, defines=None) -> dict:
    """Convert Mitsuba 0.5 scene XML into the JSON scene dict.

    Covered subset (scenehandler.cpp vocabulary): perspective/thinlens/
    orthographic/spherical sensors with <transform name="toWorld">
    (lookat/translate/rotate/scale/matrix) or <lookat>; point/spot/
    directional/constant/envmap/sky/sun/sunsky emitters + area emitters
    nested in rectangle shapes; the full material-kind table incl.
    twosided unwrapping and nested refs (mask/coating/normalmap);
    rectangle/cube/sphere/disk/cylinder/obj/ply/serialized/hair shapes;
    homogeneous and heterogeneous (gridvolume .vol) media; integrator
    and sampler nodes are carried as metadata ("_integrator", "_spp").
    Raises on constructs outside this subset rather than silently
    dropping them. A copy of alvrl_tpu's converter, which gives the same
    dict; build_scene then refuses what the port does not render."""
    import os
    import xml.etree.ElementTree as ET

    base_dir = os.path.dirname(os.path.abspath(path))

    with open(path) as f:
        text = _substitute(f.read(), defines)
    root = ET.fromstring(text)
    if root.tag != "scene":
        raise ValueError("not a mitsuba scene file")

    desc = {"materials": [], "shapes": [], "emitters": []}

    def vec(s):
        return [float(x) for x in re.split(r"[ ,]+", s.strip())]

    def get_props(node):
        props = {}
        for child in node:
            n = child.get("name")
            if child.tag == "float":
                props[n] = float(child.get("value"))
            elif child.tag == "integer":
                props[n] = int(child.get("value"))
            elif child.tag in ("spectrum", "rgb", "srgb"):
                val = child.get("value")
                if "," in val or " " in val:
                    props[n] = vec(val)
                else:
                    props[n] = [float(val)] * 3
            elif child.tag in ("point", "vector"):
                if child.get("value") is not None:
                    props[n] = vec(child.get("value"))
                else:
                    props[n] = [float(child.get(a, 0)) for a in "xyz"]
            elif child.tag == "boolean":
                props[n] = child.get("value") == "true"
            elif child.tag == "string":
                props[n] = child.get("value")
        return props

    def parse_transform(node):
        """<transform> children -> 4x4 (applied in document order)."""
        mat = np.eye(4, dtype=np.float64)
        for t in node:
            if t.tag == "translate":
                m_ = np.eye(4)
                m_[:3, 3] = [float(t.get(a, 0)) for a in "xyz"]
            elif t.tag == "scale":
                m_ = np.eye(4)
                if t.get("value") is not None:
                    s = float(t.get("value"))
                    m_[0, 0] = m_[1, 1] = m_[2, 2] = s
                else:
                    for i, a in enumerate("xyz"):
                        m_[i, i] = float(t.get(a, 1))
            elif t.tag == "rotate":
                ax = np.asarray(
                    [float(t.get(a, 0)) for a in "xyz"], np.float64)
                ax /= max(np.linalg.norm(ax), 1e-12)
                th = np.deg2rad(float(t.get("angle", 0)))
                c, s = np.cos(th), np.sin(th)
                x, y, z = ax
                r = np.array([
                    [c + x * x * (1 - c), x * y * (1 - c) - z * s,
                     x * z * (1 - c) + y * s],
                    [y * x * (1 - c) + z * s, c + y * y * (1 - c),
                     y * z * (1 - c) - x * s],
                    [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
                     c + z * z * (1 - c)],
                ])
                m_ = np.eye(4)
                m_[:3, :3] = r
            elif t.tag == "matrix":
                vals = vec(t.get("value"))
                m_ = np.asarray(vals, np.float64).reshape(4, 4)
            elif t.tag == "lookat":
                # sensor-style lookat inside a toWorld transform
                o = np.asarray(vec(t.get("origin")))
                tg = np.asarray(vec(t.get("target")))
                up = np.asarray(vec(t.get("up", "0,1,0")))
                m_ = np.asarray(look_at(o, tg, up), np.float64)
            else:
                raise ValueError(f"unsupported transform op {t.tag}")
            mat = m_ @ mat
        return mat

    def resolve_path(fn):
        if not os.path.isabs(fn):
            return os.path.join(base_dir, fn)
        return fn

    def convert_bsdf(node, name_hint):
        """One <bsdf> -> one or more material dicts; returns the
        top-level name. twosided unwraps; mask/coating/normalmap/
        mixture recurse into nested children."""
        bt = node.get("type")
        name = node.get("id", name_hint)
        if bt == "twosided":
            inner = node.find("bsdf")
            return convert_bsdf(inner, name)
        if bt not in _MAT_KINDS and bt not in _UNPORTED_MATERIALS:
            raise ValueError(f"unsupported bsdf type {bt}")
        props = get_props(node)
        mdesc = {"name": name, "type": bt}
        alb = props.get("reflectance", props.get(
            "diffuseReflectance", props.get("sigmaS")))
        if alb is not None:
            mdesc["albedo"] = alb
        if "intIOR" in props:
            mdesc["eta"] = props["intIOR"]
        if "alpha" in props:
            mdesc["alpha"] = props["alpha"]
        if "alphaU" in props:
            mdesc["alpha"] = props["alphaU"]
        if "alphaV" in props:
            mdesc["alpha_v"] = props["alphaV"]
        if bt in ("roughconductor", "roughplastic", "roughdielectric",
                  "roughcoating"):
            # the reference's XML default distribution is Beckmann
            # (microfacet.h:99-107)
            mdesc["distribution"] = props.get("distribution", "beckmann")
        if "exponent" in props:
            mdesc["exponent"] = props["exponent"]
        if "specularReflectance" in props:
            mdesc["specular"] = props["specularReflectance"]
        if "opacity" in props:
            op = props["opacity"]
            mdesc["opacity"] = op[0] if isinstance(op, list) else op
        if "weight" in props:
            mdesc["opacity"] = props["weight"]
        if "sigmaA" in props:
            mdesc["sigma_a"] = props["sigmaA"]
        if "thickness" in props:
            mdesc["thickness"] = props["thickness"]
        inner_bsdfs = node.findall("bsdf")
        if inner_bsdfs:
            nested_names = [
                convert_bsdf(b, f"{name}_n{i}")
                for i, b in enumerate(inner_bsdfs)
            ]
            mdesc["nested"] = nested_names[0]
            if len(nested_names) > 1:
                mdesc["nested2"] = nested_names[1]
        refs = node.findall("ref")
        if refs and "nested" not in mdesc:
            mdesc["nested"] = refs[0].get("id")
            if len(refs) > 1:
                mdesc["nested2"] = refs[1].get("id")
        desc["materials"].append(mdesc)
        return name

    def convert_emitter(node):
        et = node.get("type")
        props = get_props(node)
        if et == "point":
            desc["emitters"].append({
                "type": "point",
                "position": props.get("position", [0, 0, 0]),
                "intensity": props.get("intensity", [1, 1, 1]),
            })
        elif et in ("spot", "directional", "collimated"):
            desc["emitters"].append({
                "type": et,
                "position": props.get("position", [0, 0, 0]),
                "intensity": props.get(
                    "intensity", props.get(
                        "irradiance", props.get("power", [1, 1, 1]))),
                "direction": props.get("direction", [0, 0, 1]),
            })
        elif et == "constant":
            desc["emitters"].append({
                "type": "constant",
                "intensity": props.get("radiance", [1, 1, 1]),
            })
        elif et == "envmap":
            desc["emitters"].append({
                "type": "envmap",
                "filename": resolve_path(props["filename"]),
                "scale": props.get("scale", 1.0),
            })
        elif et in ("sky", "sun", "sunsky"):
            e = {"type": et,
                 "turbidity": props.get("turbidity", 3.0),
                 "scale": props.get("scale", 1.0)}
            if "sunDirection" in props:
                e["sun_direction"] = props["sunDirection"]
            desc["emitters"].append(e)
        else:
            raise ValueError(f"unsupported emitter type {et}")

    def convert_medium(node):
        mt = node.get("type")
        props = get_props(node)
        if mt == "homogeneous":
            mdesc = {
                "type": "homogeneous",
                "sigma_s": props.get("sigmaS", [0.5] * 3),
                "sigma_a": props.get("sigmaA", [0.0] * 3),
            }
        elif mt == "heterogeneous":
            vol = None
            for v in node.findall("volume"):
                if v.get("name") == "density":
                    vol = v
            if vol is None or vol.get("type") != "gridvolume":
                raise ValueError(
                    "heterogeneous medium needs a gridvolume density")
            data, bmin, bmax = read_vol(
                resolve_path(get_props(vol)["filename"]))
            mdesc = {
                "type": "grid",
                "density": data.tolist(),
                "box_min": bmin.tolist(),
                "box_max": bmax.tolist(),
                "sigma_t": props.get("sigmaT", [1.0] * 3),
                "albedo": props.get("albedo", [0.9] * 3),
                "scale": props.get("scale", 1.0),
            }
        else:
            raise ValueError(f"unsupported medium type {mt}")
        phase = node.find("phase")
        if phase is not None:
            pt = phase.get("type")
            mdesc["phase"] = {"isotropic": "isotropic", "hg": "hg",
                              "rayleigh": "rayleigh"}.get(pt)
            if mdesc["phase"] is None:
                raise ValueError(f"unsupported phase type {pt}")
            if pt == "hg":
                mdesc["g"] = get_props(phase).get("g", 0.0)
        desc["medium"] = mdesc

    _SHAPE_KINDS = ("rectangle", "cube", "sphere", "disk", "cylinder",
                    "obj", "ply", "serialized", "hair")

    def convert_shape(node):
        st = node.get("type")
        if st not in _SHAPE_KINDS:
            raise ValueError(f"unsupported shape type {st}")
        props = get_props(node)
        sdesc = {"type": st}
        tr = node.find("transform")
        if tr is not None:
            sdesc["to_world"] = parse_transform(tr).tolist()
        if st in ("obj", "ply", "serialized", "hair"):
            sdesc["filename"] = resolve_path(props["filename"])
            if "shapeIndex" in props:
                sdesc["shape_index"] = props["shapeIndex"]
        if st == "sphere":
            sdesc["center"] = props.get("center", [0, 0, 0])
            sdesc["radius"] = props.get("radius", 1.0)
        if st == "cylinder":
            sdesc["p0"] = props.get("p0", [0, 0, 0])
            sdesc["p1"] = props.get("p1", [0, 0, 1])
            sdesc["radius"] = props.get("radius", 1.0)

        inner = node.find("bsdf")
        ref = node.find("ref")
        if inner is not None:
            sdesc["material"] = convert_bsdf(
                inner, f"shape{len(desc['shapes'])}_mat")
        elif ref is not None:
            sdesc["material"] = ref.get("id")
        else:
            sdesc["material"] = "default"

        # area emitter nested in a rectangle shape -> quad light
        em = node.find("emitter")
        if em is not None:
            if em.get("type") != "area" or st != "rectangle":
                raise ValueError(
                    "only area emitters on rectangle shapes convert")
            rad = get_props(em).get("radiance", [1, 1, 1])
            tw = np.asarray(sdesc.get("to_world", np.eye(4)), np.float64)
            corners = shp.apply_transform(
                tw, np.asarray([[-1, -1, 0], [1, -1, 0], [-1, 1, 0]],
                               np.float32))
            p0 = corners[0]
            desc["emitters"].append({
                "type": "area", "p0": p0.tolist(),
                "e1": (corners[1] - p0).tolist(),
                "e2": (corners[2] - p0).tolist(),
                "radiance": rad,
            })
            return  # the loader emits the quad geometry itself
        desc["shapes"].append(sdesc)

    for node in root:
        if node.tag == "sensor":
            props = get_props(node)
            cam = {"type": node.get("type", "perspective"),
                   "fov": props.get("fov", 60.0)}
            if "apertureRadius" in props:
                cam["aperture_radius"] = props["apertureRadius"]
            if "focusDistance" in props:
                cam["focus_distance"] = props["focusDistance"]
            lookat = node.find(".//lookat")
            if lookat is not None:
                cam["origin"] = vec(lookat.get("origin"))
                cam["target"] = vec(lookat.get("target"))
                cam["up"] = vec(lookat.get("up", "0, 1, 0"))
            film = node.find("film")
            if film is not None:
                fprops = get_props(film)
                cam["width"] = fprops.get("width", 128)
                cam["height"] = fprops.get("height", 128)
            sampler = node.find("sampler")
            if sampler is not None:
                desc["_spp"] = get_props(sampler).get("sampleCount", 16)
            desc["camera"] = cam
        elif node.tag == "integrator":
            desc["_integrator"] = node.get("type")
            desc["_integrator_props"] = get_props(node)
        elif node.tag == "emitter":
            convert_emitter(node)
        elif node.tag == "medium":
            convert_medium(node)
        elif node.tag == "bsdf":
            convert_bsdf(node, f"mat{len(desc['materials'])}")
        elif node.tag == "shape":
            convert_shape(node)
    return desc
