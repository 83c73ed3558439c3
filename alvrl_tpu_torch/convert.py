"""State carried across from alvrl_tpu, as numpy arrays.

`scene_from_numpy` and `vrls_from_numpy` take the leaves of an
alvrl_tpu scene or VRL buffer, converted to numpy by the caller (this
package does not import jax), and build the port's objects on a device.
Keys are the leaves' attribute paths, e.g. "materials.albedo"; a scene
holds the leaves of a homogeneous medium (HOMOG_MEDIUM_KEYS) or of a
grid medium (GRID_MEDIUM_KEYS, recognised by "medium.sigma_t_color"). The
optional leaves: a homogeneous medium's strategy, channel and manual
rate (MEDIUM_STRATEGY_KEYS) and a mixture's components
(MIXTURE_KEYS); the environment map (ENV_KEYS); the faces' emitter
ids ("face_emitter"); per-shape media (MEDIA_KEYS); the textures
(TEXTURE_KEYS: the materials' texture kind, scale and bitmap id, the
faces' corner UVs and the bitmap stack). Absent, they take the
defaults: balance, no mixture, the zero map, no emitting face, the one
global medium, no texture. A grid medium's optional leaves (GRID_OPTION_KEYS:
fast_tau, sampling, sigma_dir_max, the orientation volume, and an
oriented kind's phase parameters, ORIENTED_PP_KEYS) default to the
JAX package's defaults: fast_tau True, Woodcock sampling, factor 1,
unoriented. `cluster_tables_from_numpy` takes the clustered render's
tables.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from alvrl_tpu_torch.emitters.emitters import Emitters
from alvrl_tpu_torch.emitters.envmap import EnvMap
from alvrl_tpu_torch.integrators.vrl.vrl import VRLs
from alvrl_tpu_torch.media.heterogeneous import make_grid_medium
from alvrl_tpu_torch.media.homogeneous import HomogeneousMedium
from alvrl_tpu_torch.media.phase import PhaseParams
from alvrl_tpu_torch.media.table import MediaTable
from alvrl_tpu_torch.scene.scene import Camera, Materials, Scene

EMITTER_KEYS = ("kind", "position", "direction", "intensity", "cos_cutoff",
                "cos_beam", "tri_e1", "tri_e2", "pmf")
# the material columns, and which of them hold integers
MATERIAL_KEYS = ("kind", "albedo", "eta", "alpha", "alpha_v", "dist",
                 "specular", "exponent", "opacity", "nested", "nested2",
                 "albedo2", "rt_table", "rt_alpha_max")
MATERIAL_INT_KEYS = ("kind", "dist", "nested", "nested2")
SCENE_KEYS = (
    "vertices", "faces", "material",
    *(f"materials.{k}" for k in MATERIAL_KEYS),
    *(f"emitters.{k}" for k in EMITTER_KEYS),
    "camera.to_world", "camera.fov_x_deg", "camera.width", "camera.height",
    "camera.kind",
)
HOMOG_MEDIUM_KEYS = ("medium.sigma_a", "medium.sigma_s", "medium.g",
                     "medium.sampling_weight", "medium.phase_kind")
GRID_MEDIUM_KEYS = ("medium.density", "medium.sigma_t_color",
                    "medium.albedo", "medium.g", "medium.box_min",
                    "medium.box_max", "medium.scale", "medium.phase_kind")
MEDIUM_STRATEGY_KEYS = ("medium.strategy", "medium.channel",
                        "medium.density")
GRID_OPTION_KEYS = ("medium.fast_tau", "medium.sampling",
                    "medium.sigma_dir_max", "medium.orientation")
ORIENTED_PP_KEYS = tuple(f"medium.phase_params.{k}" for k in (
    "ks", "kd", "exponent", "norm", "stddev", "sigma_t_lut"))
MIXTURE_KEYS = ("medium.phase_params.mix_w", "medium.phase_params.mix_kind",
                "medium.phase_params.mix_g")
ENV_KEYS = tuple(f"emitters.env.{k}" for k in (
    "image", "row_cdf", "cond_cdf", "pdf_map", "mean", "azimuth"))
MEDIA_KEYS = ("media.sigma_a", "media.sigma_s", "media.g",
              "media.sampling_weight", "face_med_int", "face_med_ext")
TEXTURE_KEYS = ("materials.tex_kind", "materials.tex_scale",
                "materials.tex_id", "face_uv", "textures")
VRL_KEYS = ("start", "end", "power", "valid", "particle_count")


def _missing(d, keys):
    missing = [k for k in keys if k not in d]
    if missing:
        raise KeyError(f"missing leaves: {missing}")


def scene_from_numpy(d, device="cuda") -> Scene:
    grid = "medium.sigma_t_color" in d
    _missing(d, SCENE_KEYS + (GRID_MEDIUM_KEYS if grid
                              else HOMOG_MEDIUM_KEYS))

    def f32(k):
        return torch.tensor(d[k], dtype=torch.float32, device=device)

    def i64(k):
        return torch.tensor(d[k], dtype=torch.int64, device=device)

    if grid:
        pp = None
        if any(k in d for k in ORIENTED_PP_KEYS):
            pp = PhaseParams(**{k.rsplit(".", 1)[1]: f32(k)
                                for k in ORIENTED_PP_KEYS if k in d})
        medium = make_grid_medium(
            *(d[f"medium.{k}"] for k in ("density", "sigma_t_color",
                                         "albedo", "g", "box_min",
                                         "box_max", "scale")),
            phase_kind=int(d["medium.phase_kind"]),
            orientation=d.get("medium.orientation"), phase_params=pp,
            fast_tau=bool(d.get("medium.fast_tau", True)),
            sampling=int(d.get("medium.sampling", 0)), device=device)
        if "medium.sigma_dir_max" in d:
            medium = replace(medium, sigma_dir_max=f32("medium.sigma_dir_max"))
    else:
        strategy = {}
        if MEDIUM_STRATEGY_KEYS[0] in d:
            _missing(d, MEDIUM_STRATEGY_KEYS)
            strategy = dict(strategy=int(d["medium.strategy"]),
                            channel=int(d["medium.channel"]),
                            density=float(d["medium.density"]))
        if MIXTURE_KEYS[0] in d:
            _missing(d, MIXTURE_KEYS)
            w, k, g = (np.asarray(d[key]) for key in MIXTURE_KEYS)
            strategy["phase_params"] = PhaseParams(
                mix_w=f32(MIXTURE_KEYS[0]), mix_kind=i64(MIXTURE_KEYS[1]),
                mix_g=f32(MIXTURE_KEYS[2]),
                host=(tuple(float(x) for x in np.float32(w)),
                      tuple(int(x) for x in k),
                      tuple(float(x) for x in np.float32(g))))
        medium = HomogeneousMedium(
            sigma_a=f32("medium.sigma_a"), sigma_s=f32("medium.sigma_s"),
            g=f32("medium.g"), sampling_weight=f32("medium.sampling_weight"),
            phase_kind=int(d["medium.phase_kind"]), **strategy)
    env = None
    if ENV_KEYS[0] in d:
        _missing(d, ENV_KEYS)
        env = EnvMap(*(f32(k) for k in ENV_KEYS),
                     host_mean=tuple(float(x) for x in
                                     d["emitters.env.mean"]))
    extra = {}
    if "face_emitter" in d:
        extra["face_emitter"] = i64("face_emitter")
    if MEDIA_KEYS[0] in d:
        _missing(d, MEDIA_KEYS)
        extra["media"] = MediaTable(*(f32(k) for k in MEDIA_KEYS[:4]))
        extra["face_med_int"] = i64("face_med_int")
        extra["face_med_ext"] = i64("face_med_ext")
    textures = {}
    if TEXTURE_KEYS[0] in d:
        _missing(d, TEXTURE_KEYS)
        textures = dict(tex_kind=i64("materials.tex_kind"),
                        tex_scale=f32("materials.tex_scale"),
                        tex_id=i64("materials.tex_id"))
        extra["face_uv"] = f32("face_uv")
        extra["textures"] = f32("textures")
    return Scene(
        vertices=f32("vertices"),
        faces=i64("faces"),
        material=i64("material"),
        materials=Materials(**{
            k: (i64 if k in MATERIAL_INT_KEYS else f32)(f"materials.{k}")
            for k in MATERIAL_KEYS}, **textures),
        emitters=Emitters(
            kind=i64("emitters.kind"),
            **{k: f32(f"emitters.{k}") for k in EMITTER_KEYS[1:]},
            host_kinds=tuple(int(k) for k in d["emitters.kind"]), env=env),
        medium=medium,
        camera=Camera(to_world=f32("camera.to_world"),
                      fov_x_deg=f32("camera.fov_x_deg"),
                      width=int(d["camera.width"]),
                      height=int(d["camera.height"]),
                      kind=int(d["camera.kind"])),
        **extra,
    )


def vrls_from_numpy(d, device="cuda") -> VRLs:
    _missing(d, VRL_KEYS)

    def f32(k):
        return torch.tensor(d[k], dtype=torch.float32, device=device)

    return VRLs(start=f32("start"), end=f32("end"), power=f32("power"),
                valid=torch.tensor(d["valid"], dtype=torch.bool,
                                   device=device),
                particle_count=f32("particle_count"))


def cluster_tables_from_numpy(sop, tv, tw, device="cuda"):
    """The tables of alvrl_tpu's prepare_clustering (slice_of_pixel,
    table_vrls, table_weights), as numpy arrays, in the form
    integrators.vrl.integrator.render_clustered_kernel takes: (the rows
    (W * H,) int32 numpy, ids (S, C) int32 and weights (S, C) float32 on
    `device`). A row of zero weights (the JAX package's row for
    fall-back pixels) renders 0."""
    return (np.asarray(sop, np.int32),
            torch.tensor(np.asarray(tv), dtype=torch.int32, device=device),
            torch.tensor(np.asarray(tw), dtype=torch.float32, device=device))
