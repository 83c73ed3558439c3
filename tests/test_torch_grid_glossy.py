"""Glossy and layered surfaces in a grid medium, in alvrl_tpu_torch
against alvrl_tpu, on the same numpy-made inputs: the box of
torch_port_utils.glossy_scene_desc (the eleven smooth kinds, each seen
from the camera; its diffuse transmitter moved in front of the back
wall, so that the medium lies on both of its sides) in a seeded grid
medium, both packages built from one JSON description by their loaders.

The plain versions of the material forms of kernels 3, 4 and 6 behind
the port's routes (the unclustered render, the clustered render over an
identity table, R's means), nearest and trilinear, against JAX's XLA
route (pair_contribution with the eye and VRL optical-depth tables) on
injected uniforms, at the homogeneous bar over the frame and over each
eye-hit kind alone; every kind's vol-surf term; the backward routes
against same-seed central differences. Its helpers serve tests/test_torch_grid_glossy_routes.py and
tests/test_torch_bvh_glossy.py. About 100 s alone, most of it JAX's
scene build (the rough coat's transmittance table) and its two compiles
of pair_contribution.
"""

import functools
import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvrl_tpu.integrators.vrl import integrate as jintegrate
from alvrl_tpu.integrators.vrl import integrator as jintegrator
from alvrl_tpu.integrators.vrl import vrl as jvrl
from alvrl_tpu.integrators.vrl.integrate import VRLConfig as JVRLConfig
from alvrl_tpu.media import api as jmapi
from alvrl_tpu.media import heterogeneous as jgmed
from alvrl_tpu.ops import pack as jpack
from alvrl_tpu.ops import vrl_pallas as jvp
from alvrl_tpu.scene import loader as jloader
from alvrl_tpu.sensors import perspective as jperspective
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.bsdf import api as bsdf
from alvrl_tpu_torch.integrators.vrl import integrator
from alvrl_tpu_torch.media import heterogeneous as gmed
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops import vrl_sum as vs
from alvrl_tpu_torch.scene import loader
from tests.torch_port_utils import (
    BENCH_VRLS,
    CPU,
    glossy_scene_desc,
    jax_vrls_leaves,
)

torch.set_num_threads(1)

GLOSSY_KINDS = bsdf.MATERIAL_FORM_KINDS - bsdf.DELTA_KINDS - {bsdf.DIFFUSE}
# a seeded plume over the box [-1, 1]^3, at least 2 voxels a side (the
# trilinear read)
GRID_MEDIUM = {"type": "grid", "sigma_t": [0.8, 0.85, 0.9],
               "albedo": [0.9, 0.85, 0.8], "g": 0.3,
               "density": (np.random.default_rng(19).uniform(
                   0.2, 1.5, (5, 6, 7))).astype(np.float32).tolist()}
# every 8th bench VRL (64 of them, over the whole box): each eye-hit kind
# takes a vol-surf term from them (test_grid_material_forms_give_every_
# kind_its_vol_surf_term), which the first 64 do not give the rough coat
VRL_STRIDE = 8
N_VRLS = 64


def _t(a):
    return torch.as_tensor(np.array(a))


# the back wall's diffuse-transmission part moved in front of the wall,
# so that the medium lies on both of its sides (a diffuse transmitter
# has a vol-surf term only from behind it); the wall itself white
DT_BACK = [0.13, -1, 1], [1, -1, 1], [1, 1, 1], [0.13, 1, 1]
DT_FRONT = [0.13, -1, 0.8], [1, -1, 0.8], [1, 1, 0.8], [0.13, 1, 0.8]


def grid_desc(width=8, height=8):
    """glossy_scene_desc's box in GRID_MEDIUM, its back wall's diffuse
    transmitter moved to z = 0.8 (DT_FRONT), as a JSON scene dict."""
    desc = dict(glossy_scene_desc(width, height), medium=GRID_MEDIUM)
    back = [c for p in DT_BACK for c in p]
    shapes = []
    for sh in desc["shapes"]:
        if sh.get("vertices") == back and sh["material"] == "dt":
            shapes.append(dict(sh, vertices=[c for p in DT_FRONT for c in p]))
            sh = dict(sh, material="white")
        shapes.append(sh)
    assert len(shapes) == len(desc["shapes"]) + 1
    return dict(desc, shapes=shapes)


@functools.lru_cache(maxsize=None)
def _grid_scenes(fast_tau):
    """(JAX scene, its prepared medium's scene, the port's) of grid_desc
    with the medium's fast_tau set."""
    desc = json.loads(json.dumps(grid_desc()))
    jscene = jloader.build_scene(desc)
    jscene = jscene.replace(medium=jscene.medium.replace(fast_tau=fast_tau))
    scene = loader.build_scene(desc, device=CPU)
    scene = replace(scene, medium=replace(scene.medium, fast_tau=fast_tau))
    return jscene, jmapi.prepare_scene(jscene), scene


@functools.lru_cache(maxsize=None)
def _vrls(n=N_VRLS):
    """n bench VRLs, every VRL_STRIDE-th: (JAX's, the port's)."""
    full = jvrl.load_ascii(BENCH_VRLS, particle_count=78.0)
    sel = np.arange(n) * VRL_STRIDE
    jv = full.replace(start=full.start[sel], end=full.end[sel],
                      power=full.power[sel], valid=full.valid[sel])
    return jv, convert.vrls_from_numpy(jax_vrls_leaves(jv), device=CPU)


def _rays(jscene):
    px, py = np.meshgrid(np.arange(8), np.arange(8))
    return jperspective.sample_ray(jscene.camera, jnp.asarray(px.reshape(-1)),
                                   jnp.asarray(py.reshape(-1)))


def _expand(a):
    return a[:, None] if a.ndim == 1 else a[:, None, :]


@functools.partial(jax.jit, static_argnames=("grid",))
def _xla_pairs(scene, ray_o, ray_d, jv, u, grid):
    """JAX's XLA route of every (eye ray, VRL) pair: pair_contribution (with
    the eye and VRL optical-depth tables in a grid medium), total (B, N,
    3) and the luminance mean (B, N)."""
    hit = jintegrator.trace_eye_rays(scene, ray_o, ray_d)
    tables = {}
    if grid:
        tables = dict(
            eye_od=jgmed.cumulative_od(scene.medium, ray_o, hit.p)[:, None],
            vrl_od=jgmed.cumulative_od(scene.medium, jv.start, jv.end)[None])
    total, mean, _ = jintegrate.pair_contribution(
        scene, _expand(ray_o), _expand(ray_d), _expand(hit.p),
        _expand(hit.valid), _expand(hit.ng), _expand(hit.mat),
        jv.start[None], jv.end[None], jv.power[None], jv.valid[None],
        u[..., :4].reshape(u.shape[0], u.shape[1], 2, 2), u[..., 4:],
        JVRLConfig(), **tables)
    return total, mean


def _eye_kinds(scene, ray_o, ray_d):
    _, mat = integrator.trace_eye_rays(scene, ray_o, ray_d)
    return scene.materials.kind[mat]


def _bar(out, ref, kind=None, channels=3, kinds=GLOSSY_KINDS):
    """The homogeneous bar over all items and, with `kind`, over each
    eye-hit kind's items alone, every kind of `kinds` among them."""
    out, ref = out.reshape(-1, channels), ref.reshape(-1, channels)
    median, share = vs.homog_bar(out, ref, channels)
    assert median < vs.HOMOG_MEDIAN and share < vs.HOMOG_SHARE, (median,
                                                                 share)
    if kind is not None:
        groups = vs.homog_bar_by_kind(out, ref, kind, channels)
        assert set(groups) >= kinds, sorted(groups)
        for k, (n, median, share) in groups.items():
            assert median < vs.HOMOG_MEDIAN and share < vs.HOMOG_SHARE, (
                k, n, median, share)


@functools.lru_cache(maxsize=None)
def _grid_case(fast_tau):
    """The glossy grid scene's 64 eye rays against N_VRLS bench VRLs on
    seeded uniforms: (the port's scene, VRLs, ray_o, ray_d, uniforms, the
    XLA total and luminance mean)."""
    _, prepared, scene = _grid_scenes(fast_tau)
    jv, vrls = _vrls()
    ray_o, ray_d = _rays(prepared)
    u = np.random.default_rng(20 + fast_tau).random((64, N_VRLS, 6),
                                                   dtype=np.float32)
    total, mean = _xla_pairs(prepared, ray_o, ray_d, jv, jnp.asarray(u),
                             grid=True)
    return (scene, vrls, _t(ray_o), _t(ray_d), torch.as_tensor(u),
            _t(total), _t(mean))


ROUTES = ("sum", "clustered", "r")


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("fast_tau", [True, False],
                         ids=["nearest", "trilinear"])
def test_grid_material_forms_match_the_xla_route(fast_tau, route):
    """The plain versions of kernels 3, 4 and 6's material forms behind
    the port's routes (render_with_vrls_kernel, render_clustered_kernel
    over an identity table, build_R_kernel), nearest or trilinear,
    against pair_contribution with the tables on the same uniforms,
    normalised by the particle count: the homogeneous bar over the frame
    and over each eye-hit kind alone. The routes launch on the material
    pack (the grid ray pack with the GRID_MATID row)."""
    scene, vrls, ray_o, ray_d, u, total, mean = _grid_case(fast_tau)
    pc = float(vrls.particle_count)
    kind = _eye_kinds(scene, ray_o, ray_d)
    calls = []
    fn = {"sum": "vrl_sum_hetero", "clustered": "vrl_sum_hetero_clustered",
          "r": "vrl_r_hetero"}[route]
    saved = getattr(integrator, fn)

    def recording(*a, **kw):
        calls.append((a[0].shape[0], "materials" in kw,
                      pk.is_trilinear(a[3])))
        return saved(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(integrator, fn, recording)
        if route == "sum":
            out = integrator.render_with_vrls_kernel(
                scene, vrls, torch.Generator().manual_seed(0), uniforms=u)
        elif route == "clustered":
            out = integrator.render_clustered_kernel(
                scene, vrls, np.zeros(64, np.int32),
                torch.arange(N_VRLS, dtype=torch.int32)[None].contiguous(),
                torch.ones((1, N_VRLS)), torch.Generator().manual_seed(0),
                uniforms=u)
        else:
            out, _ = integrator.build_R_kernel(scene, ray_o, ray_d, vrls, 0,
                                               uniforms=u)
    assert calls == [(pk.GRID_MAT_RAY_ROWS, True, not fast_tau)]
    if route == "r":
        nz = mean > 1e-9
        assert int(nz.sum()) > 1000
        _bar(out[nz], mean[nz] / pc,
             kind[:, None].expand(-1, N_VRLS)[nz], channels=1)
    else:
        _bar(out, total.sum(dim=1) / pc, kind)


@pytest.mark.parametrize("fast_tau", [True, False],
                         ids=["nearest", "trilinear"])
def test_grid_material_forms_give_every_kind_its_vol_surf_term(fast_tau):
    """Kernel 3's plain material form against its diffuse form on the same
    uniforms (the diffuse pack's albedo is 0 at a glossy hit): they differ
    by the vol-surf term alone, which is positive on every kind's pixels;
    the vol-vol terms are equal."""
    scene, vrls, ray_o, ray_d, u, _, _ = _grid_case(fast_tau)
    mats = integrator.material_pack(scene)
    _, packs = integrator.pack_rays_vrls(scene, ray_o, ray_d, vrls, mats)
    _, dpacks = integrator.pack_rays_vrls(scene, ray_o, ray_d, vrls)
    assert torch.equal(packs[0][:pk.GRID_RAY_ROWS], dpacks[0])
    out = vs.vrl_sum_hetero_reference(*packs, u, materials=mats)
    diffuse = vs.vrl_sum_hetero_reference(*dpacks, u)
    kind = _eye_kinds(scene, ray_o, ray_d)
    vol_surf = (out - diffuse).T
    for k in GLOSSY_KINDS:
        assert float(vol_surf[kind == k].sum()) > 0.0, k
    vol_vol = vs.vrl_sum_hetero_reference(
        *dpacks, u[..., :4].contiguous(), vol_surf_samples=0)
    assert torch.equal(vol_vol, vs.vrl_sum_hetero_reference(
        *packs, u[..., :4].contiguous(), vol_surf_samples=0,
        materials=mats))



def _table(n_rays, n_vrls):
    return (np.zeros(n_rays, np.int32),
            torch.arange(n_vrls, dtype=torch.int32)[None],
            torch.ones((1, n_vrls)))


# the backward routes on the glossy grid table: (the differentiable
# render, the forward route)
BACKWARD = {
    "kernels 8 and 9": (
        lambda sc, v, g: integrator.render_with_vrls_kernel_diff(sc, v, g),
        lambda sc, v, g: integrator.render_with_vrls_kernel(sc, v, g)),
    "kernels 10 and 11": (
        lambda sc, v, g: integrator.render_clustered_kernel_diff(
            sc, v, *_table(64, N_VRLS), g),
        lambda sc, v, g: integrator.render_clustered_kernel(
            sc, v, *_table(64, N_VRLS), g)),
}


@pytest.mark.parametrize("route", sorted(BACKWARD) + ["train_step"])
def test_backward_routes_refuse_a_glossy_grid_table(route):
    """The backward routes take the glossy grid table through kernels 9
    and 11's material forms (their plain versions on the CPU): the images
    are the forward routes' on the same seed, and the gradient of a
    weighted image sum in the medium's scale matches same-seed central
    differences of the forward route to 5e-3. A grid medium's train step
    is scripts/recover_density's (train_step's parameters are the
    homogeneous medium's, as the JAX package's): its loss's gradient in
    one voxel of the density, through the unclustered route, against
    central differences."""
    _, _, scene = _grid_scenes(True)
    _, vrls = _vrls()
    weight = torch.rand((8, 8, 3), generator=torch.Generator().manual_seed(5))
    med = scene.medium
    diff, forward = BACKWARD.get(route, BACKWARD["kernels 8 and 9"])

    def at(m, fn):
        return fn(replace(scene, medium=m), vrls,
                  torch.Generator().manual_seed(0))

    if route == "train_step":
        dens = med.density.clone().requires_grad_()
        img = at(gmed.with_density(med, dens), diff)
        (g,) = torch.autograd.grad(((img - weight) ** 2).mean(), dens)
        v = tuple(int(i) for i in np.unravel_index(int(g.abs().argmax()),
                                                   g.shape))
        eps = 1e-2 * float(med.density[v])

        def loss(shift):
            d = med.density.clone()
            d[v] += shift
            with torch.no_grad():
                img = at(gmed.with_density(med, d), forward).double()
            return float(((img - weight.double()) ** 2).mean())
        a, fd = float(g[v]), (loss(eps) - loss(-eps)) / (2 * eps)
        assert abs(a - fd) <= 5e-3 * abs(fd), (a, fd)
        return
    scale = med.scale.clone().requires_grad_()
    img = at(replace(med, scale=scale), diff)
    assert torch.equal(img.detach(), at(med, forward))
    (g,) = torch.autograd.grad((img * weight).sum(), scale)
    eps = 1e-3 * float(med.scale)
    with torch.no_grad():
        fd = (float((at(replace(med, scale=med.scale + eps), forward)
                     * weight).double().sum())
              - float((at(replace(med, scale=med.scale - eps), forward)
                       * weight).double().sum())) / (2 * eps)
    assert abs(float(g) - fd) <= 5e-3 * abs(fd), (float(g), fd)


def test_c21_jax_grid_pack_zeroes_the_glossy_albedo():
    """ROADMAP C21: the JAX package's Pallas grid kernels read the eye hit's
    surface from its grid ray pack alone (vrl_pallas.py calls no BSDF),
    whose albedo rows are 0 at every hit of a non-diffuse kind: on the
    glossy grid scene they are 0 at every eye ray, all of which hit a
    glossy kind, and so are the port's diffuse grid pack's, which its
    material forms do not read (they take GRID_MATID)."""
    _, prepared, scene = _grid_scenes(True)
    ray_o, ray_d = _rays(prepared)
    hit = jintegrator.trace_eye_rays(prepared, ray_o, ray_d)
    jrays = np.asarray(jpack.pack_rays_hetero(prepared, ray_o, ray_d, hit))
    kind = _eye_kinds(scene, _t(ray_o), _t(ray_d)).numpy()
    assert np.isin(kind, sorted(GLOSSY_KINDS)).all()
    assert not jrays[:64, jvp._ALB:jvp._ALB + 3].any()
    mats = integrator.material_pack(scene)
    _, packs = integrator.pack_rays_vrls(scene, _t(ray_o), _t(ray_d),
                                         _vrls()[1], mats)
    assert not packs[0][pk.ALB:pk.ALB + 3].any()
    assert torch.equal(packs[0][pk.GRID_MATID].long(),
                       integrator.trace_eye_rays(scene, _t(ray_o),
                                                 _t(ray_d))[1])
