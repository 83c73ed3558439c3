"""Scene, camera and material table as dataclasses of tensors.

Counterpart of alvrl_tpu/scene/scene.py, reduced to the columns the VRL
render, the tracer, the specular chains and the volumetric path tracer
read, the texture columns (tex_kind, tex_scale, tex_id; the scene's
face_uv and bitmap stack `textures`) among them.
Materials are a struct-of-arrays table indexed by the per-face material
id; the BSDF kind selects the arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields

import numpy as np
import torch

from alvrl_tpu_torch.emitters.emitters import Emitters
from alvrl_tpu_torch.media.heterogeneous import GridMedium
from alvrl_tpu_torch.media.homogeneous import HomogeneousMedium

# material kinds, numbered as in alvrl_tpu.scene.scene
DIFFUSE = 0     # smooth Lambertian
NULL = 1        # transparent boundary: does not block shadow rays
MIRROR = 2      # ideal specular conductor (delta), tinted by the albedo
DIELECTRIC = 3  # smooth dielectric (delta), relative IOR in Materials.eta
ROUGH_CONDUCTOR = 4   # microfacet conductor, Schlick F0 = albedo
ROUGH_PLASTIC = 5     # GGX coat over Lambertian
PHONG = 6             # modified Phong: diffuse + cos^n lobe
WARD = 7              # anisotropic Ward gaussian ('balanced')
DIFFTRANS = 8         # diffuse transmission
PLASTIC = 9           # smooth dielectric coat over Lambert
MASK = 10             # opacity mask over the `nested` material
MIXTURE = 11          # convex mixture of `nested` and `nested2`
COATING = 12          # smooth dielectric layer over `nested`: eta = coat
                      # IOR, albedo2 = coat sigma_a, exponent = thickness
NORMALMAP = 13        # tangent-space normal texture (tex_id) shading the
                      # `nested` material; the loader bakes a bumpmap's
                      # height field into one (bsdf.layered)
HK = 14               # Hanrahan-Krueger slab: albedo = sigma_s, albedo2 =
                      # sigma_a, exponent = thickness, alpha = HG g
IRAWAN = 15           # not ported (ROADMAP A11a)
ROUGH_DIELECTRIC = 16  # microfacet reflection and refraction
ROUGH_COATING = 17     # rough dielectric layer over `nested`
# the kinds that only the textured forms of the forward kernels 1-7
# evaluate
TEXTURED_KINDS = frozenset((NORMALMAP, HK))

# rough-transmittance tables (bsdf.microfacet.rough_transmittance_table):
# RT_COS cosines x RT_ALPHA roughnesses
RT_COS, RT_ALPHA = 16, 8

# sensor kinds, numbered as in alvrl_tpu.scene.scene
PERSPECTIVE = 0


@dataclass(frozen=True)
class Materials:
    kind: torch.Tensor      # (M,) int64
    albedo: torch.Tensor    # (M, 3) f32 diffuse reflectance / specular
                            # tint / F0
    eta: torch.Tensor       # (M,) f32 relative IOR int/ext (1 but for
                            # dielectrics and coats)
    alpha: torch.Tensor     # (M,) f32 microfacet / Ward-u roughness
    alpha_v: torch.Tensor   # (M,) f32 second-axis roughness
    dist: torch.Tensor      # (M,) int64 microfacet distribution
                            # (bsdf.microfacet.MF_*)
    specular: torch.Tensor  # (M, 3) f32 Phong / Ward specular reflectance
    exponent: torch.Tensor  # (M,) f32 Phong exponent / coat thickness
    opacity: torch.Tensor   # (M,) f32 mask opacity / mixture first weight
    nested: torch.Tensor    # (M,) int64 nested material id (one level of
                            # nesting, leaf kinds only)
    nested2: torch.Tensor   # (M,) int64 the mixture's second nested id
    albedo2: torch.Tensor   # (M, 3) f32 coat sigma_a
    rt_table: torch.Tensor  # (M, RT_COS, RT_ALPHA) f32 rough-transmittance
                            # tables (ROUGH_COATING; zeros otherwise)
    rt_alpha_max: torch.Tensor  # (M,) f32 the alpha span of each table:
                                # max(0.5, alpha) for ROUGH_COATING
    # the textures (textures.procedural): kind (TEX_*), frequency in world
    # units, the bitmap's index in Scene.textures (TEX_BITMAP, and a
    # NORMALMAP's normal texture); None: untextured (0, 1, 0)
    tex_kind: torch.Tensor = None   # (M,) int64
    tex_scale: torch.Tensor = None  # (M,) f32
    tex_id: torch.Tensor = None     # (M,) int64
    # the set of kinds in the table, read from `kind` when the table is
    # built (one read, a sync if it lies on the card), so that the
    # renders and the tracer choose their route without one
    host_kinds: frozenset = field(init=False)
    # does a material carry a texture (tex_kind != 0)? Read likewise
    host_textured: bool = field(init=False)

    def __post_init__(self):
        # a column shorter than the table reads its last row for the
        # missing ids, as the JAX package's gathers clamp an index out of
        # range (its cornell_area_light extends only some columns)
        n = self.kind.shape[0]
        for name, value, dtype in (("tex_kind", 0, torch.int64),
                                   ("tex_scale", 1.0, torch.float32),
                                   ("tex_id", 0, torch.int64)):
            if getattr(self, name) is None:
                object.__setattr__(self, name, torch.full(
                    (n,), value, dtype=dtype, device=self.kind.device))
        for f in fields(self):
            if not f.init:
                continue
            x = getattr(self, f.name)
            if 0 < x.shape[0] < n:
                object.__setattr__(self, f.name, torch.cat(
                    [x, x[-1:].expand((n - x.shape[0],) + x.shape[1:])]))
        object.__setattr__(self, "host_kinds",
                           frozenset(self.kind.tolist()))
        object.__setattr__(self, "host_textured",
                           bool((self.tex_kind != 0).any()))


def make_materials(kinds, albedos, etas=None, alphas=None, albedo2=None,
                   specular=None, exponent=None, alpha_v=None, opacity=None,
                   nested=None, nested2=None, dist=None, tex_kinds=None,
                   tex_scales=None, tex_id=None,
                   device="cuda") -> Materials:
    """A material table with alvrl_tpu's make_materials' defaults: eta 1,
    alpha 0.1 (alpha_v = alpha), albedo2 0, specular 0.2, exponent 30,
    opacity 1, nested ids 0, the GGX distribution, no texture (kind 0,
    scale 1, bitmap 0), and the rough-transmittance tables of the
    ROUGH_COATING entries."""
    kinds = np.asarray(kinds, np.int64).reshape(-1)
    n = kinds.shape[0]

    def col(v, default, dtype=np.float32, shape=()):
        a = np.asarray(v if v is not None else [default] * n, dtype)
        return a.reshape((n,) + shape)

    alphas_a = col(alphas, 0.1)
    etas_a = col(etas, 1.0)
    dist_a = col(dist, 1, np.int64)  # MF_GGX
    rt_table, rt_alpha_max = _rt_tables(kinds, etas_a, alphas_a, dist_a)
    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    return Materials(
        kind=torch.as_tensor(kinds, **i64),
        albedo=torch.as_tensor(np.asarray(albedos, np.float32).reshape(n, 3),
                               **f32),
        eta=torch.as_tensor(etas_a, **f32),
        alpha=torch.as_tensor(alphas_a, **f32),
        alpha_v=torch.as_tensor(col(alpha_v, None) if alpha_v is not None
                                else alphas_a, **f32),
        dist=torch.as_tensor(dist_a, **i64),
        specular=torch.as_tensor(col(specular, [0.2] * 3, shape=(3,)),
                                 **f32),
        exponent=torch.as_tensor(col(exponent, 30.0), **f32),
        opacity=torch.as_tensor(col(opacity, 1.0), **f32),
        nested=torch.as_tensor(col(nested, 0, np.int64), **i64),
        nested2=torch.as_tensor(col(nested2, 0, np.int64), **i64),
        albedo2=torch.as_tensor(col(albedo2, [0.0] * 3, shape=(3,)), **f32),
        rt_table=torch.as_tensor(rt_table, **f32),
        rt_alpha_max=torch.as_tensor(rt_alpha_max, **f32),
        tex_kind=torch.as_tensor(col(tex_kinds, 0, np.int64), **i64),
        tex_scale=torch.as_tensor(col(tex_scales, 1.0), **f32),
        tex_id=torch.as_tensor(col(tex_id, 0, np.int64), **i64))


def _rt_tables(kinds, etas, alphas, dist):
    """The rough-transmittance tables of the ROUGH_COATING entries (zeros
    elsewhere), each over alpha in (0, max(0.5, alpha)], and those spans
    (0.5 elsewhere), as alvrl_tpu's _rt_tables builds them."""
    n = kinds.shape[0]
    out = np.zeros((n, RT_COS, RT_ALPHA), np.float32)
    amax = np.full((n,), 0.5, np.float32)
    for i in np.flatnonzero(kinds == ROUGH_COATING):
        from alvrl_tpu_torch.bsdf import microfacet as mf

        amax[i] = max(0.5, float(alphas[i]))
        out[i] = mf.rough_transmittance_table(float(etas[i]), int(dist[i]),
                                              alpha_max=float(amax[i]))
    return out, amax


@dataclass(frozen=True)
class Camera:
    """to_world: (4, 4) camera-to-world, camera looking down +z with y
    up; fov_x_deg: horizontal field of view in degrees."""

    to_world: torch.Tensor
    fov_x_deg: torch.Tensor
    width: int = 128
    height: int = 128
    kind: int = PERSPECTIVE


@dataclass(frozen=True)
class Scene:
    vertices: torch.Tensor  # (V, 3) f32
    faces: torch.Tensor     # (T, 3) int64
    material: torch.Tensor  # (T,) int64 per-face material id
    materials: Materials
    emitters: Emitters
    medium: HomogeneousMedium | GridMedium  # global medium filling the scene
    camera: Camera
    # (T,) int64 the AREA entry each face emits as, -1 for none; None:
    # no face emits (face_emitters)
    face_emitter: torch.Tensor = None
    # per-shape nested media (media.table.MediaTable), with each face's
    # interior and exterior medium ids (T,) int64; None: the one global
    # `medium` everywhere
    media: object = None
    face_med_int: torch.Tensor = None
    face_med_ext: torch.Tensor = None
    # (T, 3, 2) f32 each face corner's texture coordinates, and the (K, H,
    # W, 3) f32 bitmap stack that TEX_BITMAP and NORMALMAP read; None:
    # zeros, and the (1, 1, 1, 3) zero stack, as in the JAX package
    face_uv: torch.Tensor = None
    textures: torch.Tensor = None

    def __post_init__(self):
        f32 = dict(dtype=torch.float32, device=self.vertices.device)
        n = self.faces.shape[0]
        if self.face_uv is None:
            object.__setattr__(self, "face_uv", torch.zeros((n, 3, 2), **f32))
        elif 0 < self.face_uv.shape[0] < n:
            # faces appended without UVs read the last face's, as the JAX
            # package's gather clamps (its cornell_area_light)
            uv = self.face_uv
            object.__setattr__(self, "face_uv", torch.cat(
                [uv, uv[-1:].expand((n - uv.shape[0], 3, 2))]))
        if self.textures is None:
            object.__setattr__(self, "textures",
                               torch.zeros((1, 1, 1, 3), **f32))

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    def textured(self) -> bool:
        """Does the table hold a texture, a NORMALMAP or an HK slab, whose
        eye-side term only the textured forms of the forward kernels 1-7
        evaluate (the backward kernels 8-11 have none)? (The table's host
        copies, so no sync.)"""
        mats = self.materials
        return mats.host_textured or bool(mats.host_kinds & TEXTURED_KINDS)

    def face_emitters(self):
        """(T,) the AREA entry of each face, -1 where none."""
        if self.face_emitter is not None:
            return self.face_emitter
        return torch.full((self.faces.shape[0],), -1, dtype=torch.int64,
                          device=self.device)

    def opaque_faces(self):
        """(T,) bool: triangles that block shadow rays (non-null BSDF;
        mirrors and dielectrics block them too)."""
        return self.materials.kind[self.material] != NULL

    def aabb(self):
        """(lo, hi) corners of the geometry's bounding box."""
        return self.vertices.amin(dim=0), self.vertices.amax(dim=0)


def look_at(origin, target, up):
    """Camera-to-world 4x4 (+z forward, y up), as a float32 numpy array."""
    origin = np.asarray(origin, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    fwd = target - origin
    fwd /= np.linalg.norm(fwd)
    left = np.cross(up / np.linalg.norm(up), fwd)
    left /= np.linalg.norm(left)
    new_up = np.cross(fwd, left)
    mat = np.eye(4, dtype=np.float32)
    mat[:3, 0] = left
    mat[:3, 1] = new_up
    mat[:3, 2] = fwd
    mat[:3, 3] = origin
    return mat
