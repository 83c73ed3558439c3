"""The grid-medium estimator of alvrl_tpu_torch against alvrl_tpu.

The plain versions of the grid kernels (ops.vrl_sum.vrl_sum_hetero,
ops.vrl_r.vrl_r_hetero) are held against the JAX integrand with its
cumulative-OD tables (pair_contribution with eye_od / vrl_od, the XLA
table path) at the homogeneous bar, on the same uniforms: the port's
values are the table path's (ROADMAP C9). Also the wrappers on the CPU
and their input checks. Against the Pallas grid kernels:
tests/test_torch_hetero_pallas.py; the kernels themselves run only on a
CUDA card: see tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvrl_tpu.integrators.vrl import integrator as jintegrator
from alvrl_tpu.integrators.vrl import vrl as jvrl
from alvrl_tpu.integrators.vrl.integrate import VRLConfig as JVRLConfig
from alvrl_tpu.integrators.vrl.integrate import pair_contribution
from alvrl_tpu.media import api as jmapi
from alvrl_tpu.media import heterogeneous as jgmed
from alvrl_tpu.scene import presets as jpresets
from alvrl_tpu.sensors import perspective as jperspective
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.core.spectrum import LUM_WEIGHTS
from alvrl_tpu_torch.integrators.vrl import integrator
from alvrl_tpu_torch.media import heterogeneous as gmed
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops.vrl_r import vrl_r_hetero, vrl_r_hetero_reference
from alvrl_tpu_torch.ops.vrl_sum import (
    HOMOG_MEDIAN,
    HOMOG_SHARE,
    homog_bar,
    philox_uniforms,
    vrl_sum_hetero,
    vrl_sum_hetero_reference,
)
from tests.torch_port_utils import (
    BENCH_VRLS,
    SEQ_UNIFORMS,
    hit_from_jax,
    jax_scene_leaves,
    jax_vrls_leaves,
)

torch.set_num_threads(1)

N_VRLS = 128
# (phase kind, short VRLs) of the table-path cases: the preset's HG
# g = 0.3, Rayleigh, and HG without the short-VRL division
CASES = {"hg": (0, True), "rayleigh": (1, True), "hg_long": (0, False)}
R_MEAN_FLOOR, R_VAR_FLOOR, R_VAR_MEDIAN = 1e-9, 1e-12, 1e-4


def _jax_vrls(n=N_VRLS):
    full = jvrl.load_ascii(BENCH_VRLS, particle_count=78.0)
    valid = np.ones(n, bool)
    valid[::17] = False
    return full.replace(start=full.start[:n], end=full.end[:n],
                        power=full.power[:n], valid=jnp.asarray(valid))


def _jax_scene(width, height, grid_res, phase_kind=0):
    scene = jpresets.cornell_grid_smoke(width=width, height=height,
                                        grid_res=grid_res)
    return scene.replace(medium=scene.medium.replace(phase_kind=phase_kind))


def _table_path(jscene, ray_o, ray_d, jvrls, u, short_vrls):
    """pair_contribution with the eye and VRL cumulative-OD tables (the
    XLA table path, tests/test_hetero_pallas.py:31-60): per (ray, VRL)
    the sum (3,), the luminance mean and its variance of the mean."""
    jscene = jmapi.prepare_scene(jscene)
    jhit = jintegrator.trace_eye_rays(jscene, ray_o, ray_d)
    b, n = ray_o.shape[0], jvrls.capacity
    expand = lambda a: a[:, None] if a.ndim == 1 else a[:, None, :]
    total, mean, var = pair_contribution(
        jscene, expand(ray_o), expand(ray_d), expand(jhit.p),
        expand(jhit.valid), expand(jhit.ng), expand(jhit.mat),
        jvrls.start[None], jvrls.end[None], jvrls.power[None],
        jvrls.valid[None], jnp.asarray(u[..., :4].reshape(b, n, 2, 2)),
        jnp.asarray(u[..., 4:]), JVRLConfig(short_vrls=short_vrls),
        eye_od=jgmed.cumulative_od(jscene.medium, ray_o, jhit.p)[:, None],
        vrl_od=jgmed.cumulative_od(jscene.medium, jvrls.start,
                                   jvrls.end)[None])
    return jhit, [torch.as_tensor(np.asarray(a)) for a in (total, mean, var)]


def _grid_packs(jscene, ray_o, ray_d, jhit, jvrls):
    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device="cpu")
    dss = gmed.upsample2(scene.medium.density)
    mat = torch.as_tensor(np.asarray(jhit.mat), dtype=torch.int64)
    rays = pk.pack_rays_hetero(scene, torch.as_tensor(np.asarray(ray_o)),
                               torch.as_tensor(np.asarray(ray_d)),
                               hit_from_jax(jhit), mat, dss)
    vrls = convert.vrls_from_numpy(jax_vrls_leaves(jvrls), device="cpu")
    return (rays, pk.pack_vrls_hetero(vrls, scene.medium, dss),
            pk.pack_tris(scene), pk.pack_medium_hetero(scene.medium), dss)


def _rays(jscene, n, seed):
    rng = np.random.default_rng(seed)
    cam = jscene.camera
    return jperspective.sample_ray(
        cam, jnp.asarray(rng.integers(0, cam.width, n)),
        jnp.asarray(rng.integers(0, cam.height, n)))


@pytest.mark.parametrize("uniforms", ["random", "cycle"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_the_table_path(case, uniforms):
    """The plain grid sum and R vs pair_contribution with tables, 16 rays
    x 128 VRLs (some invalid) of cornell_grid_smoke (12^3 grid), with
    per-pair random uniforms or the 6-cycle: the sums and R's means at
    the homogeneous bar, R's variances of the mean to R_VAR_MEDIAN."""
    kind, short = CASES[case]
    jscene = _jax_scene(16, 16, 12, kind)
    ray_o, ray_d = _rays(jscene, 16, 3)
    jvrls = _jax_vrls()
    if uniforms == "random":
        u = np.random.default_rng(4).random((16, N_VRLS, 6), dtype=np.float32)
    else:
        u = np.broadcast_to(np.float32(SEQ_UNIFORMS), (16, N_VRLS, 6)).copy()
    jhit, (total, mean, var) = _table_path(jscene, ray_o, ray_d, jvrls, u,
                                           short)
    packs = _grid_packs(jscene, ray_o, ray_d, jhit, jvrls)
    kw = dict(short_vrls=short, phase_kind=kind)
    out = vrl_sum_hetero_reference(*packs, torch.as_tensor(u), **kw)
    ref = total.sum(dim=1)
    assert float(ref.abs().sum()) > 0.0
    median, share = homog_bar(out.T, ref)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    r = vrl_r_hetero_reference(*packs, torch.as_tensor(u), **kw)
    nz = mean > R_MEAN_FLOOR
    assert int(nz.sum()) > 100
    median, share = homog_bar(r[0][nz], mean[nz], channels=1)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    nzv = var > R_VAR_FLOOR
    if uniforms == "cycle":
        assert int(nzv.sum()) > 100
        rel = (r[1] - var).abs()[nzv] / var[nzv]
        assert float(rel.median()) < R_VAR_MEDIAN


def _small_grid_packs(width=6, height=6, n_vrls=40):
    scene = convert.scene_from_numpy(
        jax_scene_leaves(_jax_scene(width, height, 8)), device="cpu")
    vrls = convert.vrls_from_numpy(jax_vrls_leaves(_jax_vrls(n_vrls)),
                                   device="cpu")
    return integrator.pack_frame(scene, vrls)[3]


def test_grid_wrappers_cpu_take_the_plain_versions():
    """On CPU tensors the grid wrappers run their plain versions on the
    Philox stream of their seed and count no launch; R's row sums are
    the sum's luminance on the same stream."""
    packs = _small_grid_packs()
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    before = (vrl_sum_hetero.launches, vrl_r_hetero.launches)
    out = vrl_sum_hetero(*packs, seed=5)
    r = vrl_r_hetero(*packs, seed=5)
    assert (vrl_sum_hetero.launches, vrl_r_hetero.launches) == before
    u = philox_uniforms(5, n_rays, n_vrls, 6)
    assert torch.equal(out, vrl_sum_hetero_reference(*packs, u))
    assert float(out.abs().sum()) > 0.0
    lum = sum(w * c for w, c in zip(LUM_WEIGHTS, out))
    torch.testing.assert_close(r[0].sum(dim=1), lum, rtol=1e-5, atol=1e-9)
    u3 = philox_uniforms(5, n_rays, n_vrls, 9)
    steps8 = vrl_sum_hetero(*packs, uniforms=u3, vol_vol_samples=3,
                            vol_surf_samples=3, uv_steps=8)
    assert torch.isfinite(steps8).all() and not torch.equal(steps8, out)


@pytest.mark.parametrize("bad", ["homog_rays", "medium_len", "density_dims",
                                 "density_dtype", "uv_steps"])
def test_grid_wrapper_rejects_bad_input(bad):
    rays, vrls, tris, med, dss = _small_grid_packs(4, 4)
    kw = {}
    if bad == "homog_rays":
        rays = rays[:pk.RAY_ROWS].contiguous()
    elif bad == "medium_len":
        med = med[:8].contiguous()
    elif bad == "density_dims":
        dss = dss[0]
    elif bad == "density_dtype":
        dss = dss.double()
    else:
        kw["uv_steps"] = 0
    with pytest.raises((TypeError, ValueError)):
        vrl_sum_hetero(rays, vrls, tris, med, dss, **kw)


def test_differentiable_render_refuses_a_grid():
    """The differentiable render takes a grid medium (its gradients are
    held in tests/test_torch_hetero_bwd.py): its image is the plain
    render's on the same seed. It refuses the reference's `dens_scale`,
    a multiplier on CP factors the port does not have (ROADMAP C9,
    C10)."""
    scene = convert.scene_from_numpy(jax_scene_leaves(_jax_scene(4, 4, 6)),
                                     device="cpu")
    vrls = convert.vrls_from_numpy(jax_vrls_leaves(_jax_vrls(8)),
                                   device="cpu")
    img = integrator.render_with_vrls_kernel_diff(
        scene, vrls, torch.Generator().manual_seed(0))
    ref = integrator.render_with_vrls_kernel(
        scene, vrls, torch.Generator().manual_seed(0))
    assert img.shape == (4, 4, 3) and torch.isfinite(img).all()
    assert torch.equal(img, ref)
    with pytest.raises(TypeError):
        integrator.render_with_vrls_kernel_diff(
            scene, vrls, torch.Generator().manual_seed(0), dens_scale=1.0)
