"""The grid medium's options in alvrl_tpu_torch against alvrl_tpu: the
exact trilinear quadrature (fast_tau=False) and the quadrature-inversion
free-flight sampler (sampling=1), on the same numpy-made inputs.

The fast_tau=False quadratures, eval_ray and sigma_s_at; the trilinear
medium pack and the plain grid VRL render (the plain versions of the
trilinear forms of kernels 3, 4 and 6) against JAX's XLA table path
(pair_contribution with the eye and VRL tables, which reads fast_tau) at
the homogeneous bar on injected uniforms; sample_distance_quadrature
with JAX's uniform passed in; the VRL tracer with sampling=1 on JAX's
key tree (torch_port_utils.jax_tracer_uniforms with the distance key's
own uniform); the random streams of the other scenes, which stay the
parent's; the backward wrappers and routes on the trilinear pack. About
30 s alone.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvrl_tpu.core import rng as jrng
from alvrl_tpu.integrators.vrl import integrator as jintegrator
from alvrl_tpu.integrators.vrl import tracer as jtracer
from alvrl_tpu.integrators.vrl import vrl as jvrl
from alvrl_tpu.integrators.vrl.integrate import VRLConfig as JVRLConfig
from alvrl_tpu.integrators.vrl.integrate import pair_contribution
from alvrl_tpu.media import api as jmapi
from alvrl_tpu.media import heterogeneous as jgmed
from alvrl_tpu.scene import presets as jpresets
from alvrl_tpu.sensors import perspective as jperspective
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.integrators import volpath
from alvrl_tpu_torch.integrators.vrl import integrator, tracer
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.media import api as mapi
from alvrl_tpu_torch.media import heterogeneous as gmed
from alvrl_tpu_torch.media import phase as ph
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops.vrl_r import vrl_r_hetero
from alvrl_tpu_torch.ops.vrl_sum import (
    HOMOG_MEDIAN,
    HOMOG_SHARE,
    homog_bar,
    vrl_sum_hetero,
)
from alvrl_tpu_torch.ops.vrl_sum_bwd import vrl_sum_hetero_bwd
from alvrl_tpu_torch.ops.vrl_sum_clustered import (
    philox_table_uniforms,
    vrl_sum_hetero_clustered,
    vrl_sum_hetero_clustered_reference,
)
from alvrl_tpu_torch.ops.vrl_sum_clustered_bwd import (
    vrl_sum_hetero_clustered_diff,
)
from alvrl_tpu_torch.scene import presets
from tests.torch_port_utils import (
    BENCH_VRLS,
    CPU,
    jax_scene_leaves,
    jax_tracer_uniforms,
    jax_vrls_leaves,
)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6  # the quadratures: float32 rounding of one sum


def _t(a):
    return torch.as_tensor(np.array(a))


def _media(fast_tau, sampling=0):
    """(JAX, port) grid media: a random 8 x 9 x 7 density over a shifted
    box, the given options."""
    rng = np.random.default_rng(21)
    dens = rng.uniform(0.1, 2.0, (8, 9, 7)).astype(np.float32)
    jmed = jgmed.make_grid_medium(dens, [0.9, 1.0, 1.2], [0.8, 0.9, 0.95],
                                  g=0.2, box_min=(-1.0, -0.9, -1.1),
                                  box_max=(1.1, 1.0, 0.9), scale=1.3)
    jmed = jmed.replace(fast_tau=fast_tau, sampling=sampling)
    scene = jpresets.cornell_grid_smoke(4, 4, grid_res=4).replace(medium=jmed)
    med = convert.scene_from_numpy(jax_scene_leaves(scene), device=CPU).medium
    assert med.fast_tau == fast_tau and med.sampling == sampling
    return jmapi.prepare(jmed), med


def _rays(rng, n):
    o = rng.uniform(-1.4, 1.4, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


def _close(out, ref, rtol=RTOL, atol=ATOL):
    torch.testing.assert_close(out, _t(ref), rtol=rtol, atol=atol)


def test_trilinear_quadratures_match():
    """fast_tau=False: optical_depth, cumulative_od (16 and 64 steps: the
    cumsum and the loop of the JAX package), eval_transmittance, eval_ray
    and sigma_s_at read the density trilinearly; the JAX functions batched
    over the leading axis, eagerly."""
    rng = np.random.default_rng(22)
    jmed, med = _media(False)
    grid = gmed.quad_grid(med)
    assert grid is med.density
    p0, p1 = _rays(rng, 512)[0], _rays(rng, 512)[0]
    a, b, ja, jb = _t(p0), _t(p1), jnp.asarray(p0), jnp.asarray(p1)
    for out, ref in (
            (gmed.optical_depth(med, grid, a, b),
             jgmed.optical_depth(jmed, ja, jb)),
            (gmed.cumulative_od(med, grid, a, b),
             jgmed.cumulative_od(jmed, ja, jb)),
            (gmed.cumulative_od(med, grid, a, b, 64),
             jgmed.cumulative_od(jmed, ja, jb, n_steps=64)),
            (gmed.eval_transmittance(med, grid, a, b),
             jgmed.eval_transmittance(jmed, ja, jb)),
            *zip(gmed.eval_ray(med, grid, a, b),
                 jgmed.eval_ray(jmed, ja, jb)),
            (mapi.sigma_s_at(med, a, grid), jmapi.sigma_s_at(jmed, ja))):
        _close(out, ref)


@pytest.mark.parametrize("fast_tau", [True, False],
                         ids=["nearest", "trilinear"])
def test_sample_distance_quadrature_matches(fast_tau):
    """The quadrature-inversion sampler on rays from inside and outside
    the box, to a surface or to none (1e30), with the uniform
    rng.uniform(key) taken from the JAX side: the same successes, and
    distances, points and weights to float32 rounding (a lane whose
    target lands within rounding of a table entry may take the next
    step: at most 1 %)."""
    rng = np.random.default_rng(23)
    jmed, med = _media(fast_tau, sampling=1)
    n = 512
    o, d = _rays(rng, n)
    dist = rng.uniform(0.05, 4.0, n).astype(np.float32)
    dist[::6] = 1e30
    keys = jax.random.split(jax.random.key(24), n)
    u = jax.vmap(jrng.uniform)(keys)
    ref = jax.jit(jax.vmap(lambda k, a, b, c: jgmed.sample_distance(
        jmed, k, a, b, c)))(keys, o, d, dist)
    out = mapi.sample_distance_seg_u(
        med, torch.stack([_t(u), torch.zeros(n)], dim=-1), _t(o), _t(d),
        _t(dist), density_ss=gmed.quad_grid(med))
    ok = out.success == _t(ref.success)
    assert float(ok.double().mean()) > 0.99
    assert 50 < int(out.success.sum()) < n - 50
    near = ok & ((out.t - _t(ref.t)).abs() <= 1e-4 * _t(ref.t).abs()
                 .clamp(min=1.0))
    assert float(near.double().mean()) > 0.99
    w_ref = np.where(np.asarray(ref.success)[:, None], ref.weight, 0.0)
    _close(out.w_scatter[near], w_ref[near.numpy()], rtol=1e-4)
    _close(out.p[near & out.success],
           np.asarray(ref.p)[(near & out.success).numpy()], rtol=1e-4,
           atol=1e-5)


def _render_case(fast_tau):
    """cornell_grid_smoke 8x8 with an 8^3 plume, 40 bench VRLs (every
    7th invalid), the frame's 64 eye rays; (JAX scene, rays, JAX hit,
    JAX VRLs) with the medium's fast_tau set."""
    jscene = jpresets.cornell_grid_smoke(width=8, height=8, grid_res=8)
    jscene = jscene.replace(medium=jscene.medium.replace(fast_tau=fast_tau))
    full = jvrl.load_ascii(BENCH_VRLS, particle_count=78.0)
    valid = np.ones(40, bool)
    valid[::7] = False
    jvrls = full.replace(start=full.start[:40], end=full.end[:40],
                         power=full.power[:40], valid=jnp.asarray(valid))
    cam = jscene.camera
    px, py = np.meshgrid(np.arange(8), np.arange(8))
    ray_o, ray_d = jperspective.sample_ray(cam, jnp.asarray(px.reshape(-1)),
                                           jnp.asarray(py.reshape(-1)))
    return jscene, ray_o, ray_d, jvrls


def test_plain_trilinear_render_matches_the_xla_route():
    """fast_tau=False: the plain versions of kernels 3, 4 and 6 on the
    trilinear packs (the eye and VRL tables and the U-V segments read
    trilinearly, the densities at U and V too) against pair_contribution
    with the tables, which JAX's XLA route (the CLI's -i vrl|alvrl)
    renders: the sums, R's means, and the clustered sum over an identity
    table, at the homogeneous bar, on injected uniforms."""
    jscene, ray_o, ray_d, jvrls = _render_case(False)
    u = np.random.default_rng(25).random((64, 40, 6), dtype=np.float32)
    prepared = jmapi.prepare_scene(jscene)

    @jax.jit
    def xla_route(u):
        jhit = jintegrator.trace_eye_rays(prepared, ray_o, ray_d)

        def expand(a):
            return a[:, None] if a.ndim == 1 else a[:, None, :]
        total, mean, _ = pair_contribution(
            prepared, expand(ray_o), expand(ray_d), expand(jhit.p),
            expand(jhit.valid), expand(jhit.ng), expand(jhit.mat),
            jvrls.start[None], jvrls.end[None], jvrls.power[None],
            jvrls.valid[None], u[..., :4].reshape(64, 40, 2, 2), u[..., 4:],
            JVRLConfig(), eye_od=jgmed.cumulative_od(
                prepared.medium, ray_o, jhit.p)[:, None],
            vrl_od=jgmed.cumulative_od(prepared.medium, jvrls.start,
                                       jvrls.end)[None])
        return total, mean

    total, mean = xla_route(jnp.asarray(u))
    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device=CPU)
    vrls = convert.vrls_from_numpy(jax_vrls_leaves(jvrls), device=CPU)
    hit, packs = integrator.pack_rays_vrls(scene, _t(ray_o), _t(ray_d), vrls)
    assert pk.is_trilinear(packs[3]) and packs[4] is not None
    assert torch.equal(packs[4], scene.medium.density)
    ui = torch.as_tensor(u)
    ref = _t(total).sum(dim=1)
    assert float(ref.abs().sum()) > 0.0
    for out in (vrl_sum_hetero(*packs, uniforms=ui),
                vrl_sum_hetero_clustered(
                    *packs, np.zeros(64, np.int64),
                    torch.arange(40, dtype=torch.int32)[None],
                    torch.ones((1, 40)), uniforms=ui)):
        median, share = homog_bar(out.T, ref)
        assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    r = vrl_r_hetero(*packs, uniforms=ui)
    nz = _t(mean) > 1e-9
    assert int(nz.sum()) > 100
    median, share = homog_bar(r[0][nz], _t(mean)[nz], channels=1)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


def test_trilinear_pack_and_its_refusals():
    """The trilinear medium pack: one float longer, marked 1, the index
    scales n - 1; the forward wrappers take it on the CPU through the
    plain versions (the clustered one too), and so do the backward
    wrappers (d_density of the density's own shape), the differentiable
    entries and routes (their images the forward routes', the gradient
    in the scale against same-seed central differences); a grid of one
    voxel along an axis has no trilinear form."""
    jscene, ray_o, ray_d, jvrls = _render_case(False)
    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device=CPU)
    vrls = convert.vrls_from_numpy(jax_vrls_leaves(jvrls), device=CPU)
    med = pk.pack_medium_hetero(scene.medium)
    assert med.shape == (pk.GRID_TRI_MED_LEN,) and float(med[-1]) == 1.0
    assert med[14:17].tolist() == [7.0, 7.0, 7.0]
    _, packs = integrator.pack_rays_vrls(scene, _t(ray_o), _t(ray_d), vrls)
    rows = np.arange(64) % 3 - 1
    ids = torch.randint(0, 40, (2, 9), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(0))
    ws = torch.rand((2, 9), generator=torch.Generator().manual_seed(1))
    before = vrl_sum_hetero_clustered.launches
    out = vrl_sum_hetero_clustered(*packs, rows, ids, ws, seed=3)
    assert vrl_sum_hetero_clustered.launches == before  # no kernel on CPU
    ref = vrl_sum_hetero_clustered_reference(
        *packs, rows, ids, ws, philox_table_uniforms(3, rows, ids, 6))
    assert torch.equal(out, ref)
    gbar = torch.ones((3, 64))
    d = vrl_sum_hetero_bwd(*packs, gbar)
    assert d[5].shape == packs[4].shape and float(d[5].abs().max()) > 0.0
    assert d[1].shape == (pk.GRID_MED_LEN,)
    dc = vrl_sum_hetero_clustered_diff(*packs[:4], packs[4].clone()
                                       .requires_grad_(), rows, ids, ws,
                                       seed=3)
    assert torch.equal(dc.detach(), out)
    g = torch.rand((8, 8, 3), generator=torch.Generator().manual_seed(2))
    m0 = scene.medium
    for diff, fwd, args in (
            (integrator.render_with_vrls_kernel_diff,
             integrator.render_with_vrls_kernel, ()),
            (integrator.render_clustered_kernel_diff,
             integrator.render_clustered_kernel, (rows, ids, ws))):
        scale = m0.scale.clone().requires_grad_()

        def at(s, fn):
            return fn(replace(scene, medium=replace(m0, scale=s)), vrls,
                      *args, torch.Generator().manual_seed(4))
        img = at(scale, diff)
        assert torch.equal(img.detach(), at(m0.scale, fwd))
        (ad,) = torch.autograd.grad((img * g).sum(), scale)
        eps = 1e-3 * float(m0.scale)
        with torch.no_grad():
            fd = (float((at(m0.scale + eps, fwd) * g).double().sum())
                  - float((at(m0.scale - eps, fwd) * g).double().sum())) \
                / (2 * eps)
        assert abs(float(ad) - fd) <= 5e-3 * abs(fd), (float(ad), fd)
    flat = replace(scene.medium, density=scene.medium.density[:1])
    with pytest.raises(ValueError, match="2 voxels"):
        pk.pack_medium_hetero(flat)


def test_tracer_with_the_quadrature_sampler_matches_jax():
    """sampling=1: trace_u on the uniforms of the JAX key tree, whose
    first distance column is the distance key's own uniform (no tracking
    uniforms), gives the JAX tracer's VRL buffer on cornell_grid_smoke,
    8 particles x depth 4."""
    jscene = jpresets.cornell_grid_smoke(width=8, height=8, grid_res=8)
    jscene = jscene.replace(medium=jscene.medium.replace(sampling=1))
    key = jax.random.key(26)
    ref = jtracer.trace(jscene, key, 8, jtracer.TracerConfig(max_depth=4))
    u_emit, u_walk = jax_tracer_uniforms(key, 8, 4, quadrature=True)
    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device=CPU)
    assert scene.medium.sampling == 1
    out = tracer.trace_u(scene, _t(u_emit), _t(u_walk),
                         tracer.TracerConfig(max_depth=4))
    valid = _t(ref.valid)
    assert torch.equal(out.valid, valid) and int(valid.sum()) > 4
    for k in ("start", "end", "power"):
        torch.testing.assert_close(getattr(out, k)[valid],
                                   _t(getattr(ref, k))[valid], atol=1e-5,
                                   rtol=1e-5, msg=k)


def test_streams_are_drawn_only_where_read():
    """render_volpath draws, per sample, u, then u_track in a grid medium
    of Woodcock tracking (as before the options were ported), then u_sir
    in an oriented micro-flake medium; a grid medium of sampling 1 draws
    u alone; trace draws no tracking uniforms for it."""
    cfg = volpath.VolpathConfig(max_depth=2, only_vrl_paths=False)
    base = presets.cornell_grid_smoke(4, 4, grid_res=6, device=CPU)
    orient = torch.zeros((6, 6, 6, 3))
    orient[..., 2] = 1.0
    med = base.medium
    micro = replace(base, medium=gmed.make_grid_medium(
        med.density, med.sigma_t_color, med.albedo, box_min=med.box_min,
        box_max=med.box_max, phase_kind=ph.MICROFLAKE, orientation=orient,
        device=CPU))
    quad = replace(base, medium=replace(med, sampling=1))
    n, steps = 16, volpath.n_steps(base, cfg)
    for scene, shapes in (
            (base, [(n, steps, volpath.N_STEP_DIMS),
                    (n, steps, gmed.TRACKING_DRAWS, 2)]),
            (micro, [(n, steps, volpath.N_STEP_DIMS),
                     (n, steps, gmed.TRACKING_DRAWS, 2),
                     (n, steps, ph.SIR_CANDIDATES, 3)]),
            (quad, [(n, steps, volpath.N_STEP_DIMS)])):
        img = volpath.render_volpath(scene, torch.Generator().manual_seed(2),
                                     spp=2, cfg=cfg)
        g = torch.Generator().manual_seed(2)
        draws = [[torch.rand(s, generator=g) for s in shapes]
                 for _ in range(2)]
        uniforms = tuple(torch.stack(parts) for parts in zip(*draws))
        if len(uniforms) == 1:
            uniforms = (uniforms[0], None)
        again = volpath.render_volpath(scene, None, spp=2, cfg=cfg,
                                       uniforms=uniforms)
        assert torch.equal(img, again) and float(img.abs().max()) > 0.0
    tcfg = tracer.TracerConfig(max_depth=3)
    gen = torch.Generator().manual_seed(9)
    vrls = tracer.trace(quad, gen, 4, tcfg)
    g2 = torch.Generator().manual_seed(9)
    u_emit = torch.rand((4, 3), generator=g2)
    u_walk = torch.rand((4, 3, tracer.N_STEP_DIMS), generator=g2)
    assert torch.equal(torch.rand(4, generator=gen),
                       torch.rand(4, generator=g2))
    u_emit = torch.cat([u_emit, torch.zeros(
        (4, tracer.N_EMIT_DIMS - tracer.N_EMIT_FIRST))], dim=1)
    assert torch.equal(tracer.trace_u(quad, u_emit, u_walk, tcfg).end,
                       vrls.end)


def test_the_entry_points_take_the_options():
    """render_with_vrls_kernel and render_alvrl's stages on a fast_tau=
    False, sampling=1 medium on the CPU: finite, non-zero images through
    the plain versions of the trilinear forms."""
    from alvrl_tpu_torch.integrators.vrl import alvrl
    from alvrl_tpu_torch.integrators.vrl import cluster as cl

    scene = presets.cornell_grid_smoke(8, 8, grid_res=6, device=CPU)
    scene = replace(scene, medium=replace(scene.medium, fast_tau=False,
                                          sampling=1))
    params = alvrl.ALVRLParams(
        vrl_target_num=64, num_particles=8,
        cluster=cl.ClusterParams(target_num_slices=4,
                                 target_pixel_undersampling=8.0))
    img, vrls, _ = alvrl.render_alvrl(scene, torch.Generator().manual_seed(0),
                                      params, VRLConfig(),
                                      tracer.TracerConfig(max_depth=4))
    img2 = integrator.render_with_vrls_kernel(scene, vrls,
                                              torch.Generator())
    for im in (img, img2):
        assert torch.isfinite(im).all() and float(im.mean()) > 0.0
