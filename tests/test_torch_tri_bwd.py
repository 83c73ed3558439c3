"""The gradient of a grid medium of fast_tau=False (the trilinear read) in
alvrl_tpu_torch against alvrl_tpu, on the same numpy-made inputs, and the
density recovery on such a medium.

ops.vrl_sum_bwd.vrl_sum_hetero_diff on the trilinear medium pack (its
backward on CPU tensors the plain version behind kernel 9's trilinear
forms), fed the port's packs built from the medium's parameters, against
jax.value_and_grad of JAX's XLA table path (pair_contribution with the
eye and VRL cumulative-OD tables) with fast_tau=False, the medium rebuilt
from the same parameters inside the trace (the method of
tests/test_torch_hetero_bwd_table.py), on cornell_grid_smoke's diffuse
table (the glossy table's hold: tests/test_torch_tri_glossy_bwd.py);
scalars to PAR_RTOL, the voxels at the homogeneous bar. Kernel 11's
plain trilinear VJP against kernel 9's on a table of every VRL, diffuse
and glossy; two CPU steps of scripts.recover_density on a trilinear
medium. About 90 s alone, most of it JAX's trace and compile of the
table path (35-40 s).
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from alvrl_tpu.integrators.vrl import integrator as jintegrator
from alvrl_tpu.integrators.vrl.integrate import VRLConfig as JVRLConfig
from alvrl_tpu.integrators.vrl.integrate import pair_contribution
from alvrl_tpu.media import heterogeneous as jgmed
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.integrators.vrl import integrator
from alvrl_tpu_torch.media import heterogeneous as gmed
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops import vrl_sum_bwd as bwd
from alvrl_tpu_torch.ops import vrl_sum_clustered_bwd as cb
from alvrl_tpu_torch.scripts import recover_density as rd
from tests.test_torch_grid_glossy import _grid_scenes
from tests.test_torch_hetero_bwd import SVS, SVV, _gbar
from tests.test_torch_hetero_bwd_table import PARAM_KEYS, PAR_RTOL, _voxel_bar
from tests.test_torch_hetero_render import _jax_scene, _jax_vrls, _rays
from tests.torch_port_utils import hit_from_jax, jax_scene_leaves, \
    jax_vrls_leaves

torch.set_num_threads(1)

N_RAYS = 16


def _t(a):
    return torch.as_tensor(np.array(a))


@functools.lru_cache(maxsize=None)
def _jax_scenes(table):
    """The JAX scene of fast_tau False, its prepared scene and the port's:
    cornell_grid_smoke 16x16 with a 12^3 grid (diffuse), or the glossy
    grid box of tests/test_torch_grid_glossy.py."""
    if table == "glossy":
        return _grid_scenes(False)
    jscene = _jax_scene(16, 16, 12)
    jscene = jscene.replace(medium=jscene.medium.replace(fast_tau=False))
    from alvrl_tpu.media import api as jmapi
    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device="cpu")
    return jscene, jmapi.prepare_scene(jscene), scene


@functools.lru_cache(maxsize=None)
def _jax_tri_grad(table):
    """jax.value_and_grad of sum(gbar * the table path's per-ray sums) in
    (density, sigma_t_color, albedo, g, scale) with fast_tau False, the
    medium rebuilt from them inside the trace."""
    jscene0, _, _ = _jax_scenes(table)

    def f(params, ray_o, ray_d, u, gbar, vrls):
        med = jgmed.with_cache(jscene0.medium.replace(**params))
        jscene = jscene0.replace(medium=med)
        jhit = jintegrator.trace_eye_rays(jscene, ray_o, ray_d)
        b, n = ray_o.shape[0], vrls.capacity
        expand = lambda a: a[:, None] if a.ndim == 1 else a[:, None, :]  # noqa
        total, _, _ = pair_contribution(
            jscene, expand(ray_o), expand(ray_d), expand(jhit.p),
            expand(jhit.valid), expand(jhit.ng), expand(jhit.mat),
            vrls.start[None], vrls.end[None], vrls.power[None],
            vrls.valid[None], u[..., :2 * SVV].reshape(b, n, SVV, 2),
            u[..., 2 * SVV:], JVRLConfig(vol_vol_samples=SVV,
                                         vol_surf_samples=SVS),
            eye_od=jgmed.cumulative_od(med, ray_o, jhit.p)[:, None],
            vrl_od=jgmed.cumulative_od(med, vrls.start, vrls.end)[None])
        return jnp.sum(gbar * total.sum(axis=1).T)

    return jax.jit(jax.value_and_grad(f))


def _port_tri(scene, prepared, ray_o, ray_d, jvrls, params):
    """The port's trilinear packs built from the medium parameters
    `params` (torch tensors), with the material pack for a glossy table:
    (packs, materials)."""
    med = replace(gmed.with_density(scene.medium, params["density"]),
                  **{k: params[k] for k in PARAM_KEYS[1:]})
    sc = replace(scene, medium=med)
    grid = gmed.quad_grid(med)
    jhit = jintegrator.trace_eye_rays(prepared, ray_o, ray_d)
    mats = integrator.material_pack(sc)
    mat = torch.as_tensor(np.array(jhit.mat), dtype=torch.int64)
    rays = pk.pack_rays_hetero(sc, _t(ray_o), _t(ray_d), hit_from_jax(jhit),
                               mat, grid, with_mat=mats is not None)
    vrls = convert.vrls_from_numpy(jax_vrls_leaves(jvrls), device="cpu")
    return (rays, pk.pack_vrls_hetero(vrls, med, grid), pk.pack_tris(sc),
            pk.pack_medium_hetero(med), grid), mats


def _inputs(n_vrls):
    u = np.random.default_rng(4).random((N_RAYS, n_vrls, 2 * SVV + SVS),
                                        dtype=np.float32)
    return u, _gbar(5, N_RAYS)


def _hold_tri_table(table):
    jscene, prepared, scene = _jax_scenes(table)
    ray_o, ray_d = _rays(prepared, N_RAYS, 3)
    jvrls = _jax_vrls()
    u, gbar = _inputs(jvrls.capacity)
    jparams = {k: getattr(jscene.medium, k) for k in PARAM_KEYS}
    ref_loss, ref = _jax_tri_grad(table)(jparams, ray_o, ray_d,
                                         jnp.asarray(u), jnp.asarray(gbar),
                                         jvrls)
    params = {k: _t(v).clone().requires_grad_() for k, v in jparams.items()}
    packs, mats = _port_tri(scene, prepared, ray_o, ray_d, jvrls, params)
    assert pk.is_trilinear(packs[3]) and packs[4] is params["density"]
    assert (mats is not None) == (table == "glossy")
    out = bwd.vrl_sum_hetero_diff(*packs, uniforms=_t(u),
                                  vol_vol_samples=SVV, vol_surf_samples=SVS,
                                  **({} if mats is None else
                                     {"materials": mats}))
    loss = (out.double() * _t(gbar).double()).sum()
    grads = dict(zip(PARAM_KEYS, torch.autograd.grad(loss, list(
        params.values()))))
    assert abs(float(loss.detach()) - float(ref_loss)) \
        <= 1e-5 * abs(float(ref_loss))
    for k in PARAM_KEYS[1:]:
        for o_i, r_i in zip(grads[k].reshape(-1).tolist(),
                            _t(ref[k]).reshape(-1).tolist()):
            assert abs(o_i - r_i) <= PAR_RTOL * abs(r_i), (k, o_i, r_i)
    _voxel_bar(grads["density"], _t(ref["density"]))


def test_plain_trilinear_vjp_matches_xla_table_path():
    """Kernel 9t's plain version on cornell_grid_smoke's diffuse table
    (16 rays x 128 VRLs, 12^3 grid) against XLA AD of the fast_tau=False
    table path: the loss to 1e-5, sigma_t_color, albedo, g and scale to
    PAR_RTOL, the density voxels (no upsample2 in the chain) at the
    homogeneous bar."""
    _hold_tri_table("diffuse")


def test_plain_clustered_trilinear_vjp_matches_the_unclustered():
    """Kernel 11t's and 11tm's plain versions on a table whose one row
    holds every VRL at weight 1 give kernel 9t's and 9tm's cotangents
    (d_power, d_par, d_tau, d_eod, d_vod and the density's)."""
    for table in ("diffuse", "glossy"):
        jscene, prepared, scene = _jax_scenes(table)
        ray_o, ray_d = _rays(prepared, N_RAYS, 3)
        jvrls = _jax_vrls()
        n = jvrls.capacity
        u, gbar = (_t(a) for a in _inputs(n))
        params = {k: _t(getattr(jscene.medium, k)) for k in PARAM_KEYS}
        packs, mats = _port_tri(scene, prepared, ray_o, ray_d, jvrls, params)
        kw = dict(uniforms=u, vol_vol_samples=SVV, vol_surf_samples=SVS,
                  materials=mats)
        ref = bwd.vrl_sum_hetero_bwd(*packs, gbar, **kw)
        out = cb.vrl_sum_hetero_clustered_bwd(
            *packs, np.zeros(N_RAYS, np.int32),
            torch.arange(n, dtype=torch.int32)[None],
            torch.ones((1, n)), gbar, **kw)
        assert float(ref[5].abs().max()) > 0.0
        for o, r in zip(out[:6], ref):
            torch.testing.assert_close(o, r, rtol=1e-5, atol=1e-6)


def test_recover_density_two_cpu_steps_on_a_trilinear_medium():
    """Two steps of the density recovery on a fast_tau=False medium at 8x8
    with a 6^3 grid on the CPU: the render takes the trilinear packs, the
    loss and the step stay finite, theta moves inside the clip."""
    state = rd.setup(res=6, size=8, steps=2, device="cpu", fast_tau=False)
    assert not state.medium.fast_tau
    assert pk.is_trilinear(pk.pack_medium_hetero(state.medium))
    theta0 = state.theta.clone()
    for step in range(2):
        out = rd.density_step(state, step)
        assert np.isfinite(out["loss"]) and out["loss"] > 0.0
        assert torch.isfinite(state.theta).all()
    dens = state.density
    assert float(dens.min()) >= np.exp(rd.LOG_MIN) * (1 - 1e-6)
    assert float(dens.max()) <= np.exp(rd.LOG_MAX) * (1 + 1e-6)
    assert not torch.equal(state.theta, theta0)
