"""The textured forms' plain versions (kernels 1, 2 and 5 on the textured
ray pack, behind render_with_vrls_kernel, render_clustered_kernel and
build_R_kernel) on cornell_textured (presets.cornell_textured_desc)
against JAX's XLA estimator, pair_contribution, on the same uniforms,
with the JAX scene's bitmap stack the port's (its bump map baked, ROADMAP
C24); ROADMAP C23; the routes that refuse a textured table; the CLI.

JAX's pair_contribution evaluates the eye hit's BSDF at its point but
drops its UV (ROADMAP C23): on procedural textures and the HK slab the
two agree as they are; on the bitmap and the normal and bump maps the
port is held against pair_contribution with the hit's UV put into its
bsdf_eval_smooth (interp_uv of the hit, as JAX's tracer and volpath
pass it), and test_c23_* shows the unpatched one rendering those hits
with the base albedo and the geometric normal. Bars: the homogeneous bar
over the frame's rays and over each material's rays alone. 12 x 12 rays
against every 4th bench VRL (127); pair_contribution jitted twice (with
and without the UV), each ~10 s; about 50 s alone.
"""

import functools
import json
import tempfile

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
from alvrl_tpu.scene import loader as jloader
from alvrl_tpu.sensors import perspective as jperspective
from alvrl_tpu.textures.procedural import interp_uv as jinterp_uv
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.integrators.vrl import integrator
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops import vrl_sum as vs
from alvrl_tpu_torch.scene import loader, presets
from alvrl_tpu_torch.textures.procedural import albedo_at
from tests.torch_port_utils import BENCH_VRLS, CPU, jax_vrls_leaves

torch.set_num_threads(1)

SIZE = 12
N_RAYS = SIZE * SIZE
# the materials whose hits pair_contribution evaluates as the port does
# (the procedural textures, the slab); the others read the hit's UV
AS_THEY_ARE = ("checker", "grid", "noise", "hk")
WITH_UV = ("bitmap", "normalmap", "bumpmap")


def _t(a):
    return torch.as_tensor(np.array(a))


# the bitmaps' directory, removed when the process ends
_TMP = tempfile.TemporaryDirectory(prefix="alvrl_tex_")


@functools.lru_cache(maxsize=None)
def _scenes():
    """(desc, the JAX scene with the port's bitmap stack, the port's)."""
    desc = presets.cornell_textured_desc(_TMP.name,
                                         SIZE, SIZE)
    scene = loader.build_scene(desc, device=CPU)
    jscene = jloader.build_scene(json.loads(json.dumps(desc)))
    return desc, jscene.replace(textures=jnp.asarray(
        scene.textures.numpy())), scene


@functools.lru_cache(maxsize=None)
def _vrls():
    full = jvrl.load_ascii(BENCH_VRLS, particle_count=78.0)
    jv = full.replace(start=full.start[::4], end=full.end[::4],
                      power=full.power[::4], valid=full.valid[::4])
    return jv, convert.vrls_from_numpy(jax_vrls_leaves(jv), device=CPU)


def _rays():
    _, jscene, _ = _scenes()
    px, py = np.meshgrid(np.arange(SIZE), np.arange(SIZE))
    return jperspective.sample_ray(jscene.camera, jnp.asarray(px.reshape(-1)),
                                   jnp.asarray(py.reshape(-1)))


def _eye_mats():
    """The material id at each eye ray's closest hit (-1 on a miss), and
    the names of the materials."""
    desc, _, scene = _scenes()
    ray_o, ray_d = (_t(a) for a in _rays())
    hit, mat = integrator.trace_eye_rays(scene, ray_o, ray_d)
    return (torch.where(hit.valid, mat, -1),
            [m["name"] for m in desc["materials"]])


_jit_pc = jax.jit(jintegrate.pair_contribution, static_argnames=("cfg",))


def _pc_with_uv(*a, cfg):
    return jintegrate.pair_contribution(*a, cfg=cfg)


_jit_pc_uv = jax.jit(_pc_with_uv, static_argnames=("cfg",))


@functools.lru_cache(maxsize=None)
def _pair_reference(seed, table, with_uv):
    """JAX's pair_contribution (jitted) of the eye rays against every VRL
    (table False) or a seeded table's columns: (uniforms (B, C, 6), ids,
    weights, total (B, C, 3), lum_mean, lum_var). with_uv: its
    bsdf_eval_smooth takes the hits' UV (C23's repair)."""
    _, jscene, _ = _scenes()
    jv, _ = _vrls()
    n = jv.start.shape[0]
    ray_o, ray_d = _rays()
    rng = np.random.default_rng(seed)
    u = rng.random((N_RAYS, n, 6)).astype(np.float32)
    if table:
        ids = rng.integers(-1, n, (N_RAYS, n))
        w = rng.uniform(0.0, 2.0, (N_RAYS, n)).astype(np.float32)
    else:
        ids = np.broadcast_to(np.arange(n), (N_RAYS, n))
        w = np.ones((N_RAYS, n), np.float32)
    hit = jintegrator.trace_eye_rays(jscene, ray_o, ray_d)
    idc = np.clip(ids, 0, n - 1)
    ex = lambda a: a[:, None] if a.ndim == 1 else a[:, None, :]  # noqa: E731
    args = (jscene, ex(ray_o), ex(ray_d), ex(hit.p), ex(hit.valid),
            ex(hit.ng), ex(hit.mat), jv.start[idc], jv.end[idc],
            jv.power[idc] * jnp.asarray(w)[..., None],
            jv.valid[idc] & jnp.asarray((w > 0) & (ids >= 0)),
            jnp.asarray(u[..., :4].reshape(N_RAYS, n, 2, 2)),
            jnp.asarray(u[..., 4:]))
    if with_uv:
        jh = jisect.intersect_all(ray_o, ray_d, jscene.vertices,
                                  jscene.faces)
        uv = ex(jinterp_uv(jscene.face_uv, jh.prim, jh.uv))
        saved = jintegrate.bsdf_eval_smooth
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jintegrate, "bsdf_eval_smooth",
                       lambda *a, p_world=None: saved(*a, p_world=p_world,
                                                      uv=uv))
            out = _jit_pc_uv(*args, cfg=JVRLConfig())
    else:
        out = _jit_pc(*args, cfg=JVRLConfig())
    return (_t(u), _t(ids.astype(np.int32)), _t(w), *(_t(x) for x in out))


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


def _kernel1_image(u):
    _, _, scene = _scenes()
    _, vrls = _vrls()
    launches = []
    saved = integrator.vrl_sum

    def recording(*a, **kw):
        launches.append((a[0].shape[0], "materials" in kw))
        return saved(*a, **kw)

    integrator.vrl_sum = recording
    try:
        img = integrator.render_with_vrls_kernel(
            scene, vrls, torch.Generator().manual_seed(0), uniforms=u)
    finally:
        integrator.vrl_sum = saved
    assert launches == [(pk.TEX_RAY_ROWS, True)]
    return img


@pytest.mark.parametrize("with_uv", [False, True], ids=["as_is", "uv"])
def test_kernel1_route_matches_jax_pair_contribution(with_uv):
    """render_with_vrls_kernel (kernel 1's textured form, plain on the
    CPU) against pair_contribution summed over the VRLs on the same
    uniforms: the procedural and HK hits against it as it is, every
    textured hit against it with the hit's UV."""
    mats, names = _eye_mats()
    u, _, _, total, _, _ = _pair_reference(3, False, with_uv)
    img = _kernel1_image(u)
    ref = total.sum(dim=1) / float(_vrls()[1].particle_count)
    _bar(img, ref, mats, names, AS_THEY_ARE + (WITH_UV if with_uv else ()))


def test_kernel5_route_matches_jax_pair_contribution():
    """build_R_kernel (kernel 5's textured form, plain on the CPU)
    against pair_contribution's luminance mean and variance with the
    hits' UV, entry by entry."""
    _, _, scene = _scenes()
    _, vrls = _vrls()
    mats, names = _eye_mats()
    u, _, _, _, lum_mean, lum_var = _pair_reference(3, False, True)
    ray_o, ray_d = (_t(a) for a in _rays())
    mean, var = integrator.build_R_kernel(scene, ray_o, ray_d, vrls, 0,
                                          uniforms=u)
    pc = float(vrls.particle_count)
    for out, ref in ((mean, lum_mean / pc), (var, lum_var / pc / pc)):
        _bar(out, ref, mats, names, AS_THEY_ARE + WITH_UV, channels=1)


def test_kernel2_route_matches_jax_pair_contribution():
    """render_clustered_kernel (kernel 2's textured form, plain on the
    CPU), each pixel its own row of a seeded table, against
    pair_contribution with the hits' UV summed over the row with the
    weights."""
    _, _, scene = _scenes()
    _, vrls = _vrls()
    mats, names = _eye_mats()
    u, ids, w, total, _, _ = _pair_reference(6, True, True)
    img = integrator.render_clustered_kernel(
        scene, vrls, np.arange(N_RAYS, dtype=np.int32), ids.contiguous(),
        w.contiguous(), torch.Generator().manual_seed(0), uniforms=u)
    ref = total.sum(dim=1) / float(vrls.particle_count)
    _bar(img, ref, mats, names, AS_THEY_ARE + WITH_UV)


def test_c23_jax_vrl_image_ignores_the_bitmap_and_the_normal_maps():
    """ROADMAP C23: JAX's pair_contribution passes no UV to
    bsdf_eval_smooth, so that its eye term on the bitmap, normal-mapped
    and bump-mapped hits is the one at the geometric normal with the
    albedo of the point alone (a bitmap's is its base albedo, a procedural
    texture keeps its pattern): the port's plain kernel 1 on the textured
    pack with those rows overwritten by albedo_at(p) and ng agrees with it
    there, and the textured term differs from it by more than 1e-2 on
    most rays of each of those materials."""
    desc, _, scene = _scenes()
    _, vrls = _vrls()
    mats, names = _eye_mats()
    u, _, _, total, _, _ = _pair_reference(3, False, False)
    px, py, hit, packs = integrator.pack_frame(
        scene, vrls, materials=integrator.material_pack(scene))
    rays = packs[0].clone()
    mid = rays[pk.MATID].long()
    m = scene.materials
    rays[pk.TEX_NS:pk.TEX_NS + 3] = rays[pk.NG:pk.NG + 3]
    for k, ids in enumerate((mid, m.nested[mid], m.nested2[mid])):
        rays[pk.TEX_ALB + 3 * k:pk.TEX_ALB + 3 * k + 3] = albedo_at(
            scene, ids, hit.p).T
    mpack = integrator.material_pack(scene)
    untextured = vs.vrl_sum_reference(rays, *packs[1:], u, materials=mpack)
    textured = vs.vrl_sum_reference(packs[0], *packs[1:], u,
                                    materials=mpack)
    ref = total.sum(dim=1)
    _bar(untextured.T, ref, mats, names, WITH_UV)
    for name in WITH_UV:
        sel = mats == names.index(name)
        _, share = vs.homog_bar(textured.T[sel], ref[sel])
        assert share > 0.5, (name, share)


def _grid_textured():
    from dataclasses import replace

    from alvrl_tpu_torch.media.heterogeneous import make_grid_medium

    _, _, scene = _scenes()
    med = make_grid_medium(np.ones((4, 4, 4), np.float32), [1.0] * 3,
                           [0.9] * 3, device=CPU)
    return replace(scene, medium=med)


def test_routes_without_a_textured_form_refuse_it_by_name():
    """The differentiable routes of kernels 8-11 (in either medium) and
    the train step refuse a textured table, naming ROADMAP A11a, and the
    backward wrappers refuse the textured ray pack itself; the forward
    routes of the grid kernels 3 and 6 and of the BVH kernel 7 take it
    (their textured forms)."""
    from alvrl_tpu_torch.ops import vrl_sum_bwd as bwd
    from alvrl_tpu_torch.parallel.render import train_step

    _, _, scene = _scenes()
    _, vrls = _vrls()
    gen = torch.Generator().manual_seed(0)
    grid = _grid_textured()
    ray_o, ray_d = (_t(a) for a in _rays())
    calls = [
        lambda: integrator.render_with_vrls_kernel_diff(scene, vrls, gen),
        lambda: integrator.render_clustered_kernel_diff(
            scene, vrls, np.zeros(N_RAYS, np.int32),
            torch.zeros((1, 4), dtype=torch.int32), torch.ones((1, 4)), gen),
        lambda: integrator.render_with_vrls_kernel_diff(grid, vrls, gen),
        lambda: train_step(scene, gen, torch.zeros((SIZE, SIZE, 3)),
                           integrator.VRLConfig()),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="A11a"):
            call()
    mats = integrator.material_pack(scene)
    packs = integrator.pack_frame(scene, vrls, materials=mats)[3]
    assert pk.is_textured(packs[0])
    gbar = torch.zeros((3, packs[0].shape[1]))
    with pytest.raises(ValueError, match="no textured form.*A11a"):
        bwd.vrl_sum_bwd(*packs, gbar, seed=0, materials=mats)
    gpacks = integrator.pack_frame(grid, vrls, materials=mats)[3]
    assert gpacks[0].shape[0] == pk.GRID_TEX_RAY_ROWS
    mean, _ = integrator.build_R_kernel(grid, ray_o[:8], ray_d[:8], vrls, 0)
    assert torch.isfinite(mean).all()


@pytest.mark.parametrize("integ", ["vrl", "alvrl", "volpath"])
def test_cli_renders_the_textured_scene(integ, tmp_path):
    """render_cli -i vrl | alvrl | volpath on cornell_textured's JSON at
    8x8 on the CPU: a finite, non-zero image; the VRL routes through the
    textured plain forms."""
    from alvrl_tpu_torch.io.image import read_pfm
    from alvrl_tpu_torch.scripts import render_cli

    desc = presets.cornell_textured_desc(str(tmp_path), 8, 8)
    path = tmp_path / "textured.json"
    path.write_text(json.dumps(desc))
    out = tmp_path / f"{integ}.pfm"
    before = (vs.vrl_sum.tex_launches, vs._reference)
    assert render_cli.main([str(path), "--cpu", "-i", integ, "-p", "1",
                            "--particles", "16", "--vrls", "64",
                            "-o", str(out)]) == 0
    img = read_pfm(out)
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert float(np.abs(img).max()) > 0.0
    assert before == (vs.vrl_sum.tex_launches, vs._reference)
