"""The plain grid-medium VJP of alvrl_tpu_torch against XLA AD of the
JAX table path, and the density-recovery trainer on the CPU.

ops.vrl_sum_bwd.vrl_sum_hetero_diff (whose backward on CPU tensors is
the plain version, autograd through the plain grid forward), fed the
port's packs built from the medium's parameters, is held against
jax.value_and_grad of pair_contribution with the eye and VRL
cumulative-OD tables (the XLA table path), the medium rebuilt from the
same parameters inside the trace so that the density's cotangent
reaches the voxels: scalars to PAR_RTOL, the voxel gradient at the
homogeneous bar (ROADMAP C10). Also two CPU steps of
scripts.recover_density. The checks against the Pallas kernels in
interpret mode and against finite differences:
tests/test_torch_hetero_bwd.py.
"""

from dataclasses import replace
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvrl_tpu.integrators.vrl import integrator as jintegrator
from alvrl_tpu.integrators.vrl.integrate import VRLConfig as JVRLConfig
from alvrl_tpu.integrators.vrl.integrate import pair_contribution
from alvrl_tpu.media import api as jmapi
from alvrl_tpu.media import heterogeneous as jgmed
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.media import heterogeneous as gmed
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops.vrl_sum import HOMOG_MEDIAN, HOMOG_SHARE, homog_bar
from alvrl_tpu_torch.ops.vrl_sum_bwd import vrl_sum_hetero_diff
from alvrl_tpu_torch.scripts import recover_density as rd
from tests.test_torch_hetero_bwd import SEQ, SVS, SVV, _gbar, _t
from tests.test_torch_hetero_render import CASES, _jax_scene, _jax_vrls, _rays
from tests.torch_port_utils import (
    hit_from_jax,
    jax_scene_leaves,
    jax_vrls_leaves,
)

torch.set_num_threads(1)

PAR_RTOL = 1e-4    # scalars against XLA AD of the table path
VOXEL_FLOOR = 1e-3  # voxels compared: |grad| above this share of the largest


def _voxel_bar(out, ref):
    """The homogeneous bar over the voxels whose |grad| exceeds
    VOXEL_FLOOR of the largest."""
    nz = ref.abs() > VOXEL_FLOOR * float(ref.abs().max())
    assert int(nz.sum()) > 20
    median, share = homog_bar(out[nz][:, None], ref[nz][:, None], channels=1)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


# ---------------------------------------------------------------------------
# (b): the plain backward against XLA AD of the table path
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _jax_table_grad(kind, short):
    """jax.value_and_grad of sum(gbar * the table path's per-ray sums) in
    (density, sigma_t_color, albedo, g, scale), the medium rebuilt from
    them (and its supersample with it) inside the trace."""
    jscene0 = _jax_scene(16, 16, 12, kind)

    def f(params, ray_o, ray_d, u, gbar, vrls):
        med = jgmed.with_cache(jscene0.medium.replace(**params))
        jscene = jscene0.replace(medium=med)
        jhit = jintegrator.trace_eye_rays(jscene, ray_o, ray_d)
        b, n = ray_o.shape[0], vrls.capacity
        expand = lambda a: a[:, None] if a.ndim == 1 else a[:, None, :]
        total, _, _ = pair_contribution(
            jscene, expand(ray_o), expand(ray_d), expand(jhit.p),
            expand(jhit.valid), expand(jhit.ng), expand(jhit.mat),
            vrls.start[None], vrls.end[None], vrls.power[None],
            vrls.valid[None], u[..., :2 * SVV].reshape(b, n, SVV, 2),
            u[..., 2 * SVV:], JVRLConfig(vol_vol_samples=SVV,
                                         vol_surf_samples=SVS,
                                         short_vrls=short),
            eye_od=jgmed.cumulative_od(med, ray_o, jhit.p)[:, None],
            vrl_od=jgmed.cumulative_od(med, vrls.start, vrls.end)[None])
        return jnp.sum(gbar * total.sum(axis=1).T)

    return jscene0, jax.jit(jax.value_and_grad(f))


PARAM_KEYS = ("density", "sigma_t_color", "albedo", "g", "scale")


def _port_grid_loss(jscene, ray_o, ray_d, jhit, jvrls, params, gbar, u, kind,
                    short):
    """sum(gbar * vrl_sum_hetero_diff) with the port's packs built from
    the medium parameters `params` (torch tensors)."""
    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device="cpu")
    med = replace(gmed.with_density(scene.medium, params["density"]),
                  **{k: params[k] for k in PARAM_KEYS[1:]})
    scene = replace(scene, medium=med)
    dss = gmed.upsample2(med.density)
    mat = torch.as_tensor(np.asarray(jhit.mat), dtype=torch.int64)
    rays = pk.pack_rays_hetero(scene, _t(ray_o), _t(ray_d), hit_from_jax(jhit),
                               mat, dss)
    vrls = convert.vrls_from_numpy(jax_vrls_leaves(jvrls), device="cpu")
    out = vrl_sum_hetero_diff(rays, pk.pack_vrls_hetero(vrls, med, dss),
                              pk.pack_tris(scene), pk.pack_medium_hetero(med),
                              dss.contiguous(), uniforms=u,
                              vol_vol_samples=SVV, vol_surf_samples=SVS,
                              short_vrls=short, phase_kind=kind)
    return (out.double() * torch.as_tensor(gbar).double()).sum()


@pytest.mark.parametrize("uniforms", ["random", "cycle"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_vjp_matches_xla_table_path(case, uniforms):
    """The gradient of sum(gbar * sums) in the voxels, sigma_t_color,
    albedo, g and scale, through the port's packs and its plain grid
    backward, against jax.value_and_grad of the XLA table path (16 rays
    x 128 VRLs of cornell_grid_smoke, 12^3 grid): scalars to PAR_RTOL,
    the voxel gradient at the homogeneous bar."""
    kind, short = CASES[case]
    jscene, grad_fn = _jax_table_grad(kind, short)
    ray_o, ray_d = _rays(jscene, 16, 3)
    jvrls = _jax_vrls()
    n = jvrls.capacity
    if uniforms == "random":
        u = np.random.default_rng(4).random((16, n, len(SEQ)),
                                            dtype=np.float32)
    else:
        u = np.broadcast_to(np.float32(SEQ), (16, n, len(SEQ))).copy()
    gbar = _gbar(5, 16)
    med = jscene.medium
    jparams = {k: getattr(med, k) for k in PARAM_KEYS}
    ref_loss, ref = grad_fn(jparams, ray_o, ray_d, jnp.asarray(u),
                            jnp.asarray(gbar), jvrls)
    jhit = jintegrator.trace_eye_rays(jmapi.prepare_scene(jscene), ray_o,
                                      ray_d)
    params = {k: _t(v).clone().requires_grad_() for k, v in jparams.items()}
    loss = _port_grid_loss(jscene, ray_o, ray_d, jhit, jvrls, params, gbar,
                           torch.as_tensor(u), kind, short)
    grads = dict(zip(PARAM_KEYS, torch.autograd.grad(loss, list(
        params.values()))))
    assert abs(float(loss.detach()) - float(ref_loss)) \
        <= 1e-5 * abs(float(ref_loss))
    for k in PARAM_KEYS[1:]:
        out, r = grads[k].reshape(-1), _t(ref[k]).reshape(-1)
        for o_i, r_i in zip(out.tolist(), r.tolist()):
            if kind == 1 and k == "g":
                assert o_i == 0.0 and r_i == 0.0
                continue
            assert abs(o_i - r_i) <= PAR_RTOL * abs(r_i), (k, o_i, r_i)
    _voxel_bar(grads["density"], _t(ref["density"]))


# ---------------------------------------------------------------------------
# (g): the trainer
# ---------------------------------------------------------------------------

def test_recover_density_two_cpu_steps():
    """Two steps of the density recovery at 8x8 with a 6^3 grid on the
    CPU: the loss and the step stay finite, theta moves, and the density
    stays inside the clip."""
    state = rd.setup(res=6, size=8, steps=2, device="cpu")
    theta0 = state.theta.clone()
    for step in range(2):
        out = rd.density_step(state, step)
        assert np.isfinite(out["loss"]) and out["loss"] > 0.0
        assert set(out["ms"]) == {"trace", "forward", "backward", "adam"}
        assert torch.isfinite(state.theta).all()
    dens = state.density
    assert float(dens.min()) >= np.exp(rd.LOG_MIN) * (1 - 1e-6)
    assert float(dens.max()) <= np.exp(rd.LOG_MAX) * (1 + 1e-6)
    assert not torch.equal(state.theta, theta0)
