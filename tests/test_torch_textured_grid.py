"""Textured surfaces in a grid medium, in alvrl_tpu_torch against
alvrl_tpu, on the same numpy-made inputs: cornell_textured
(presets.cornell_textured_desc: config 1's box with a bitmap, checker,
grid and noise wall, an HK slab, a normal- and a bump-mapped block) in a
seeded 8^3 grid medium, both packages built from one JSON description by
their loaders, the JAX scene with the port's bitmap stack (its bump map
baked, ROADMAP C24).

The plain versions of the textured forms of kernels 3, 4 and 6 behind
the port's routes (the unclustered render, the clustered render over an
identity table, R's means), nearest and trilinear, against JAX's XLA
route (pair_contribution with the eye and VRL optical-depth tables) on
the same uniforms, at the homogeneous bar over the frame and over each
material's rays alone, every material with the hit's UV put into JAX's
bsdf_eval_smooth (its XLA route drops it, ROADMAP C23); the grid textured
ray pack; the backward routes' refusals. 12 x 12 rays against every 4th
bench VRL (127); two jitted pair_contribution traces (one a read),
shared through lru_cache. Its helpers serve
tests/test_torch_textured_bvh.py, which holds the procedural textures
and the HK slab against pair_contribution as it is (a third trace) and
ROADMAP C25, so that xdist's --dist loadfile spreads the traces over two
workers.
"""

import functools
import json
import tempfile
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvrl_tpu.geometry import intersect as jisect
from alvrl_tpu.integrators.vrl import integrate as jintegrate
from alvrl_tpu.integrators.vrl import integrator as jintegrator
from alvrl_tpu.integrators.vrl import vrl as jvrl
from alvrl_tpu.integrators.vrl.integrate import VRLConfig as JVRLConfig
from alvrl_tpu.media import api as jmapi
from alvrl_tpu.media import heterogeneous as jgmed
from alvrl_tpu.scene import loader as jloader
from alvrl_tpu.sensors import perspective as jperspective
from alvrl_tpu.textures.procedural import interp_uv as jinterp_uv
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.integrators.vrl import integrator
from alvrl_tpu_torch.media import heterogeneous as gmed
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops import vrl_sum as vs
from alvrl_tpu_torch.scene import loader, presets
from alvrl_tpu_torch.scene.scene import DIFFUSE, TEXTURED_KINDS
from tests.torch_port_utils import BENCH_VRLS, CPU, jax_vrls_leaves

torch.set_num_threads(1)

SIZE = 12
N_RAYS = SIZE * SIZE
# the materials whose hits pair_contribution evaluates as the port does
# (the procedural textures, the slab); the others read the hit's UV
AS_THEY_ARE = ("checker", "grid", "noise", "hk")
WITH_UV = ("bitmap", "normalmap", "bumpmap")
# a seeded plume over the box [-1, 1]^3 (8^3 voxels, at least 2 a side for
# the trilinear read)
GRID_MEDIUM = {"type": "grid", "sigma_t": [0.8, 0.85, 0.9],
               "albedo": [0.9, 0.85, 0.8], "g": 0.3,
               "density": np.random.default_rng(23).uniform(
                   0.2, 1.5, (8, 8, 8)).astype(np.float32).tolist()}


def _t(a):
    return torch.as_tensor(np.array(a))


# the bitmaps' directory, removed when the process ends
_TMP = tempfile.TemporaryDirectory(prefix="alvrl_texgrid_")


def grid_desc(size=SIZE):
    """cornell_textured's JSON dict in GRID_MEDIUM."""
    return dict(presets.cornell_textured_desc(_TMP.name, size, size),
                medium=GRID_MEDIUM)


@functools.lru_cache(maxsize=None)
def _scenes(fast_tau):
    """(desc, the JAX scene with the port's bitmap stack and its medium
    prepared, the port's) with the medium's fast_tau set."""
    desc = json.loads(json.dumps(grid_desc()))
    scene = loader.build_scene(desc, device=CPU)
    scene = replace(scene, medium=replace(scene.medium, fast_tau=fast_tau))
    jscene = jloader.build_scene(desc)
    jscene = jscene.replace(
        textures=jnp.asarray(scene.textures.numpy()),
        medium=jscene.medium.replace(fast_tau=fast_tau))
    return desc, jmapi.prepare_scene(jscene), scene


@functools.lru_cache(maxsize=None)
def _vrls():
    full = jvrl.load_ascii(BENCH_VRLS, particle_count=78.0)
    jv = full.replace(start=full.start[::4], end=full.end[::4],
                      power=full.power[::4], valid=full.valid[::4])
    return jv, convert.vrls_from_numpy(jax_vrls_leaves(jv), device=CPU)


def _rays(jscene):
    px, py = np.meshgrid(np.arange(SIZE), np.arange(SIZE))
    return jperspective.sample_ray(jscene.camera, jnp.asarray(px.reshape(-1)),
                                   jnp.asarray(py.reshape(-1)))


def _expand(a):
    return a[:, None] if a.ndim == 1 else a[:, None, :]


def _pairs(scene, ray_o, ray_d, jv, u):
    """pair_contribution of every (eye ray, VRL) pair with the eye and VRL
    optical-depth tables: total (B, N, 3), the luminance mean (B, N)."""
    hit = jintegrator.trace_eye_rays(scene, ray_o, ray_d)
    total, mean, _ = jintegrate.pair_contribution(
        scene, _expand(ray_o), _expand(ray_d), _expand(hit.p),
        _expand(hit.valid), _expand(hit.ng), _expand(hit.mat),
        jv.start[None], jv.end[None], jv.power[None], jv.valid[None],
        u[..., :4].reshape(u.shape[0], u.shape[1], 2, 2), u[..., 4:],
        JVRLConfig(),
        eye_od=jgmed.cumulative_od(scene.medium, ray_o, hit.p)[:, None],
        vrl_od=jgmed.cumulative_od(scene.medium, jv.start, jv.end)[None])
    return total, mean


_jit_pairs = jax.jit(_pairs)


def _pairs_uv(scene, ray_o, ray_d, jv, u):
    """_pairs with the hits' UV put into bsdf_eval_smooth (ROADMAP C23's
    repair), as JAX's tracer and volpath pass it."""
    jh = jisect.intersect_all(ray_o, ray_d, scene.vertices, scene.faces)
    uv = _expand(jinterp_uv(scene.face_uv, jh.prim, jh.uv))
    saved = jintegrate.bsdf_eval_smooth
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jintegrate, "bsdf_eval_smooth",
                   lambda *a, p_world=None: saved(*a, p_world=p_world, uv=uv))
        return _pairs(scene, ray_o, ray_d, jv, u)


_jit_pairs_uv = jax.jit(_pairs_uv)


@functools.lru_cache(maxsize=None)
def _case(fast_tau, with_uv):
    """The frame's 144 eye rays against the 127 VRLs on seeded uniforms:
    (the port's scene, VRLs, ray_o, ray_d, uniforms, the XLA total and
    luminance mean)."""
    _, jscene, scene = _scenes(fast_tau)
    jv, vrls = _vrls()
    ray_o, ray_d = _rays(jscene)
    u = np.random.default_rng(30 + fast_tau).random(
        (N_RAYS, jv.start.shape[0], 6), dtype=np.float32)
    fn = _jit_pairs_uv if with_uv else _jit_pairs
    total, mean = fn(jscene, ray_o, ray_d, jv, jnp.asarray(u))
    return (scene, vrls, _t(ray_o), _t(ray_d), torch.as_tensor(u),
            _t(total), _t(mean))


def _eye_mats(scene, ray_o, ray_d):
    """The material id at each eye ray's closest hit (-1 on a miss)."""
    hit, mat = integrator.trace_eye_rays(scene, ray_o, ray_d)
    return torch.where(hit.valid, mat, -1)


def _bar(out, ref, mats, names, held, channels=3):
    """The homogeneous bar over the rays of the materials `held` and over
    each material's rays alone (each at least 4)."""
    keep = torch.zeros_like(mats, dtype=torch.bool)
    for name in held:
        keep |= mats == names.index(name)
    out = out.reshape(N_RAYS, -1, channels)[keep].reshape(-1, channels)
    ref = ref.reshape(N_RAYS, -1, channels)[keep].reshape(-1, channels)
    median, share = vs.homog_bar(out, ref, channels)
    assert median < vs.HOMOG_MEDIAN and share < vs.HOMOG_SHARE, (median,
                                                                 share)
    per = out.shape[0] // int(keep.sum())
    groups = vs.homog_bar_by_kind(out, ref, mats[keep].repeat_interleave(
        per), channels)
    assert {names[k] for k in groups} == set(held)
    for k, (n, median, share) in groups.items():
        assert n >= 4 * per and median < vs.HOMOG_MEDIAN and \
            share < vs.HOMOG_SHARE, (names[k], n, median, share)


def _route(route, scene, vrls, ray_o, ray_d, u):
    """The route's output and the grid wrapper's launches it made
    ((rows, materials given, trilinear))."""
    calls = []
    fn = {"sum": "vrl_sum_hetero", "clustered": "vrl_sum_hetero_clustered",
          "r": "vrl_r_hetero"}[route]
    saved = getattr(integrator, fn)

    def recording(*a, **kw):
        calls.append((a[0].shape[0], "materials" in kw,
                      pk.is_trilinear(a[3])))
        return saved(*a, **kw)

    n = vrls.capacity
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(integrator, fn, recording)
        if route == "sum":
            out = integrator.render_with_vrls_kernel(
                scene, vrls, torch.Generator().manual_seed(0), uniforms=u)
        elif route == "clustered":
            out = integrator.render_clustered_kernel(
                scene, vrls, np.zeros(N_RAYS, np.int32),
                torch.arange(n, dtype=torch.int32)[None].contiguous(),
                torch.ones((1, n)), torch.Generator().manual_seed(0),
                uniforms=u)
        else:
            out, _ = integrator.build_R_kernel(scene, ray_o, ray_d, vrls, 0,
                                               uniforms=u)
    return out, calls


@pytest.mark.parametrize("route", ["sum", "clustered", "r"])
@pytest.mark.parametrize("fast_tau", [True, False],
                         ids=["nearest", "trilinear"])
def test_grid_textured_forms_match_the_xla_route(fast_tau, route):
    """The plain versions of kernels 3, 4 and 6's textured forms behind
    the port's routes (render_with_vrls_kernel, render_clustered_kernel
    over an identity table, build_R_kernel), nearest or trilinear,
    against pair_contribution with the tables and the hits' UV on the
    same uniforms, normalised by the particle count: the homogeneous bar
    over the frame's textured hits and over each material's alone. The
    routes launch on the grid textured ray pack."""
    desc, _, _ = _scenes(fast_tau)
    names = [m["name"] for m in desc["materials"]]
    scene, vrls, ray_o, ray_d, u, total, mean = _case(fast_tau, True)
    pc = float(vrls.particle_count)
    mats = _eye_mats(scene, ray_o, ray_d)
    out, calls = _route(route, scene, vrls, ray_o, ray_d, u)
    assert calls == [(pk.GRID_TEX_RAY_ROWS, True, not fast_tau)]
    if route == "r":
        _bar(out, mean / pc, mats, names, AS_THEY_ARE + WITH_UV, channels=1)
    else:
        _bar(out, total.sum(dim=1) / pc, mats, names, AS_THEY_ARE + WITH_UV)


@pytest.mark.parametrize("fast_tau", [True, False],
                         ids=["nearest", "trilinear"])
def test_grid_textured_pack(fast_tau):
    """The grid textured ray pack: its GRID_TEX_* rows equal the
    homogeneous textured pack's TEX_* rows on the same hits (each hit's
    Shading at its point and UV, tex_cols); its first GRID_MAT_RAY_ROWS
    rows are the grid material pack's rows as ops.pack builds them; and
    an untextured table's grid packs are, bit for bit, those rows alone
    (no textured rows, is_textured false)."""
    _, _, scene = _scenes(fast_tau)
    ray_o, ray_d = integrator.frame_rays(scene)[2:]
    hit, mat = integrator.trace_eye_rays(scene, ray_o, ray_d)
    dss = gmed.quad_grid(scene.medium)

    def rows(sc, with_mat):
        """The grid pack's rows before the textured ones, built here as
        ops.pack builds them."""
        eye_od = gmed.cumulative_od(sc.medium, dss, ray_o, hit.p)
        tau = torch.exp(-sc.medium.sigma_t_color * eye_od[..., -1:])
        cols = pk._ray_cols(sc, ray_o, ray_d, hit, mat, tau) + [eye_od]
        if with_mat:
            cols.append(mat.to(torch.float32)[..., None])
        return torch.cat(cols, dim=-1).T.contiguous()

    grid_pack = pk.pack_rays_hetero(scene, ray_o, ray_d, hit, mat, dss,
                                    with_mat=True)
    assert grid_pack.shape == (pk.GRID_TEX_RAY_ROWS, N_RAYS)
    assert pk.is_textured(grid_pack) and pk.tex_rows(grid_pack) == (
        pk.GRID_TEX_NS, pk.GRID_TEX_ALB)
    assert torch.equal(grid_pack[:pk.GRID_MAT_RAY_ROWS], rows(scene, True))
    homog = replace(scene, medium=presets.cornell_smoke(
        SIZE, SIZE, device=CPU).medium)
    h_pack = pk.pack_rays(homog, ray_o, ray_d, hit, mat, with_mat=True)
    assert pk.tex_rows(h_pack) == (pk.TEX_NS, pk.TEX_ALB)
    assert torch.equal(grid_pack[pk.GRID_TEX_NS:], h_pack[pk.TEX_NS:])
    assert torch.equal(grid_pack[pk.GRID_TEX_NS:],
                       torch.cat(pk.tex_cols(scene, hit, mat), dim=-1).T)
    # the table without its textures, its NORMALMAP and HK made DIFFUSE
    m = scene.materials
    plain = replace(scene, materials=replace(
        m, tex_kind=torch.zeros_like(m.tex_kind),
        kind=torch.where(torch.isin(m.kind, torch.tensor(
            sorted(TEXTURED_KINDS))), DIFFUSE, m.kind)))
    assert not plain.textured()
    for with_mat in (False, True):
        got = pk.pack_rays_hetero(plain, ray_o, ray_d, hit, mat, dss,
                                  with_mat=with_mat)
        assert got.shape[0] == (pk.GRID_MAT_RAY_ROWS if with_mat
                                else pk.GRID_RAY_ROWS)
        assert torch.equal(got, rows(plain, with_mat))
        assert not pk.is_textured(got)


def test_backward_routes_refuse_a_textured_table_by_name():
    """The differentiable routes (kernels 8-11), the train step and the
    backward wrappers on a grid textured pack refuse a textured table,
    naming ROADMAP A11a; the forward grid routes take it."""
    from alvrl_tpu_torch.ops import vrl_sum_bwd as bwd
    from alvrl_tpu_torch.ops import vrl_sum_clustered_bwd as cbwd
    from alvrl_tpu_torch.parallel.render import train_step

    _, _, grid = _scenes(True)
    _, vrls = _vrls()
    homog = replace(grid, medium=presets.cornell_smoke(
        SIZE, SIZE, device=CPU).medium)
    gen = torch.Generator().manual_seed(0)
    calls = [
        lambda sc: integrator.render_with_vrls_kernel_diff(sc, vrls, gen),
        lambda sc: integrator.render_clustered_kernel_diff(
            sc, vrls, np.zeros(N_RAYS, np.int32),
            torch.zeros((1, 4), dtype=torch.int32), torch.ones((1, 4)), gen),
        lambda sc: train_step(sc, gen, torch.zeros((SIZE, SIZE, 3)),
                              integrator.VRLConfig()),
    ]
    for sc in (grid, homog):
        for call in calls:
            with pytest.raises(ValueError, match="A11a"):
                call(sc)
    mats = integrator.material_pack(grid)
    packs = integrator.pack_frame(grid, vrls, materials=mats)[3]
    assert packs[0].shape[0] == pk.GRID_TEX_RAY_ROWS
    gbar = torch.zeros((3, N_RAYS))
    with pytest.raises(ValueError, match="no textured form.*A11a"):
        bwd.vrl_sum_hetero_bwd(*packs, gbar, seed=0, materials=mats)
    with pytest.raises(ValueError, match="no textured form.*A11a"):
        cbwd.vrl_sum_hetero_clustered_bwd(
            *packs, np.zeros(N_RAYS, np.int32),
            torch.zeros((1, 4), dtype=torch.int32), torch.ones((1, 4)), gbar,
            seed=0, materials=mats)
    img = integrator.render_with_vrls_kernel(grid, vrls, gen)
    assert torch.isfinite(img).all() and float(img.abs().max()) > 0.0
