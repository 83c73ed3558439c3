"""The grid-medium clustered VJP of alvrl_tpu_torch against alvrl_tpu.

ops.vrl_sum_clustered_bwd.vrl_sum_hetero_clustered_diff, whose backward
on CPU tensors is the plain version (autograd through the plain grid
clustered forward), is held

  * against the JAX vrl_sum_hetero_clustered_diff through jax.vjp, its
    Pallas kernels run in interpret mode with `_u01` patched in both
    kernel modules to the SEQ cycle and a CP rank that does not fall
    back (the port is fed the same constants), at the CP-fit bars of
    tests/test_torch_hetero_bwd.py, since those kernels read the density
    through CP factors where the port reads the grid (ROADMAP C9): 16x16
    rays of cornell_grid_smoke (8^3 grid) in 2 tiles mapped to 2 slices
    whose tables hold the same 128 VRLs at weights linspace(0.5, 1.5)
    and linspace(1.2, 0.3);
  * with a table of every VRL at weight 1, against the unclustered grid
    VJP;
  * against same-seed central differences of the plain forward through
    render_clustered_kernel_diff (a voxel and a table-weight scale
    among the parameters), and on the reference's zero-channel fault
    (ROADMAP C7);

and the grid wrapper's CPU path.

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from alvrl_tpu.integrators.vrl import integrator as jintegrator
from alvrl_tpu.media import api as jmapi
from alvrl_tpu.ops import pack as jpk
from alvrl_tpu.ops import vrl_pallas as vp
from alvrl_tpu.ops import vrl_pallas_bwd as vpb
from alvrl_tpu.sensors import perspective as jperspective
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.integrators.vrl import integrator
from alvrl_tpu_torch.media import heterogeneous as gmed
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops.vrl_sum import philox_uniforms
from alvrl_tpu_torch.ops.vrl_sum_bwd import (
    GRID_PAR,
    vrl_sum_hetero_bwd_reference,
)
from alvrl_tpu_torch.ops.vrl_sum_clustered import (
    philox_table_uniforms,
    vrl_sum_hetero_clustered_reference,
)
from alvrl_tpu_torch.ops.vrl_sum_clustered_bwd import (
    vrl_sum_hetero_clustered_bwd,
    vrl_sum_hetero_clustered_bwd_reference,
    vrl_sum_hetero_clustered_diff,
)
from tests.test_torch_hetero_bwd import CP_RANK, CP_SCALAR, _cp_bar
from tests.test_torch_hetero_render import _grid_packs, _jax_scene, _jax_vrls
from tests.torch_port_utils import (
    CPU,
    SEQ_UNIFORMS,
    in_child,
    jax_scene_leaves,
    jax_vrls_leaves,
)

torch.set_num_threads(1)

W = H = 16         # 256 eye rays: two 128-ray tiles
N_VRLS = 128       # table columns (the reference's VRL_TILE)
SVV = SVS = 1      # 1 + 1 samples, and their constants in draw order
SEQ = (SEQ_UNIFORMS[0], SEQ_UNIFORMS[1], SEQ_UNIFORMS[4])
FD_TOL = 5e-3      # same-seed central differences (tests/test_pallas_bwd.py)
WEIGHTS = (np.linspace(0.5, 1.5, N_VRLS, dtype=np.float32),
           np.linspace(1.2, 0.3, N_VRLS, dtype=np.float32))
N_OD = pk.NQ + 1


def _t(a):
    return torch.as_tensor(np.array(a))


def _seq(n_rays, n_cols):
    return torch.tensor(SEQ).expand(n_rays, n_cols, len(SEQ)).contiguous()


def _setup(albedo=None, power_scale=None):
    """cornell_grid_smoke 16x16 (8^3 grid, HG g = 0.3): the prepared JAX
    scene, every pixel's eye ray and hit, and N_VRLS bench VRLs (every
    17th invalid)."""
    jscene = _jax_scene(W, H, 8)
    if albedo is not None:
        jscene = jscene.replace(medium=jscene.medium.replace(
            albedo=jnp.asarray(albedo, jnp.float32)))
    px, py = np.meshgrid(np.arange(W), np.arange(H))
    ray_o, ray_d = jperspective.sample_ray(
        jscene.camera, jnp.asarray(px.reshape(-1)), jnp.asarray(py.reshape(-1)))
    jscene = jmapi.prepare_scene(jscene)
    jhit = jintegrator.trace_eye_rays(jscene, ray_o, ray_d)
    jvrls = _jax_vrls(N_VRLS)
    if power_scale is not None:
        jvrls = jvrls.replace(
            power=jvrls.power * jnp.asarray(power_scale, jnp.float32))
    return jscene, ray_o, ray_d, jhit, jvrls


def _jax_vjp(jscene, ray_o, ray_d, jhit, jvrls, gbar):
    """(d_tau (3, B), d_eod (NQ + 1, B), d_power (3, N), d_vod (NQ + 1,
    N), d_weights (2, N), d_med (8,)) of the JAX
    vrl_sum_hetero_clustered_diff in interpret mode, rays 0-127 on slice
    0 and 128-255 on slice 1, the per-slice table cotangents chained to
    the weights, the powers and the VRL-OD rows."""
    ray_pack = jpk.pack_rays_hetero(jscene, ray_o, ray_d, jhit)
    base = jpk.pack_vrls_hetero(jvrls, jscene.medium)
    tables = jnp.stack([base.at[vp._VP:vp._VP + 3].multiply(w[None])
                        for w in WEIGHTS])
    tri_flat = jpk.pack_tris(jscene)
    med_pack = jpk.pack_medium_hetero(jscene.medium)
    cp_pack, cp_err = jpk.pack_cp(jscene.medium, rank=CP_RANK)
    assert cp_err < jintegrator.CP_ERR_FALLBACK
    seed = jnp.asarray([13], jnp.int32)
    tile_slice = jnp.asarray([0, 1], jnp.int32)

    def f(rp, tb, mp):
        return vpb.vrl_sum_hetero_clustered_diff(
            rp, tb, tile_slice, mp, cp_pack, jnp.float32(1.0), tri_flat, seed,
            CP_RANK, SVV, SVS, True, 0, 4)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, ray_pack, tables, med_pack)
        d_ray, d_tables, d_med = vjp(jnp.asarray(gbar))
    d_ray, d_tables = _t(d_ray).T, _t(d_tables).double()
    d_pw_t = d_tables[:, vp._VP:vp._VP + 3]
    power = _t(base)[vp._VP:vp._VP + 3].double()
    w = torch.as_tensor(np.stack(WEIGHTS)).double()
    return (d_ray[vp._TAU:vp._TAU + 3], d_ray[vp._EOD:vp._EOD + N_OD],
            (w[:, None] * d_pw_t).sum(dim=0).float(),
            d_tables[:, vp._VOD:vp._VOD + N_OD].sum(dim=0).float(),
            (d_pw_t * power[None]).sum(dim=1).float(), _t(d_med)[0, 0:8])


def _gbars():
    rng = np.random.default_rng(7)
    return (rng.uniform(0.5, 1.5, (3, W * H)).astype(np.float32),
            rng.uniform(0.5, 1.5, (3, W * H)).astype(np.float32))


def _interpret_refs():
    """jax_refs' interpret-mode VJPs ("vjp", "zero"), both kernel modules'
    _u01 patched to the SEQ cycle while traced (jit caches cleared around
    the patch; the kernels compile once for the two VJPs). Run by
    in_child."""
    counter = {"i": 0}

    def cycle(shape):
        v = SEQ[counter["i"] % len(SEQ)]
        counter["i"] += 1
        return jnp.full(shape, v, jnp.float32)

    gbar, gbar_zero = _gbars()
    out = {}
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vp, "_u01", cycle)
        mp.setattr(vpb, "_u01", cycle)
        out["vjp"] = _jax_vjp(*_setup(), gbar)
        out["zero"] = _jax_vjp(*_setup(albedo=(0.92, 0.92, 0.0),
                                       power_scale=(1.0, 0.0, 1.0)), gbar_zero)
    jax.clear_caches()
    assert counter["i"] == 2 * len(SEQ)
    return out


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's grid clustered VJP (CP rank 16, interpret mode,
    computed in a child process: in_child) on the preset ("vjp") and with
    a zero VRL power channel and a zero albedo channel ("zero"), with
    their set-ups and output cotangents."""
    gbar, gbar_zero = _gbars()
    return {"gbar": gbar, "gbar_zero": gbar_zero, "setup": _setup(),
            "setup_zero": _setup(albedo=(0.92, 0.92, 0.0),
                                 power_scale=(1.0, 0.0, 1.0)),
            **in_child(_interpret_refs)}


def _tables():
    rows = np.repeat([0, 1], W * H // 2)
    ids = torch.arange(N_VRLS, dtype=torch.int32).expand(2, N_VRLS)
    return rows, ids.contiguous(), torch.as_tensor(np.stack(WEIGHTS))


def _port_vjp(packs, gbar):
    """(d_rays, d_vrls, d_medium, d_density, d_weights) of the port's
    vrl_sum_hetero_clustered_diff on the SEQ constants."""
    rows, ids, ws = _tables()
    rays, vrls, tris, med, dss = packs
    leaves = [x.clone().requires_grad_() for x in (rays, vrls, med, dss, ws)]
    out = vrl_sum_hetero_clustered_diff(
        leaves[0], leaves[1], tris, leaves[2], leaves[3], rows, ids,
        leaves[4], uniforms=_seq(rays.shape[1], N_VRLS), vol_vol_samples=SVV,
        vol_surf_samples=SVS)
    return torch.autograd.grad((out * torch.as_tensor(gbar)).sum(), leaves)


def test_vjp_matches_jax_interpret(jax_refs):
    """d_tau, d_eod, d_power, d_vod and d_weights per entry and
    sigma_t_color, sigma_s_color, g, chan of the port's grid clustered
    VJP against the JAX vrl_sum_hetero_clustered_diff at the CP bars; the
    other pack rows get no gradient, the density does."""
    ref_tau, ref_eod, ref_pw, ref_vod, ref_w, ref_med = jax_refs["vjp"]
    d_rays, d_vrls, d_med, d_dss, d_w = _port_vjp(
        _grid_packs(*jax_refs["setup"]), jax_refs["gbar"])
    for out, ref in ((d_rays[pk.TAU:pk.TAU + 3], ref_tau),
                     (d_rays[pk.EOD:], ref_eod),
                     (d_vrls[pk.VP:pk.VP + 3], ref_pw),
                     (d_vrls[pk.VOD:], ref_vod), (d_w, ref_w)):
        _cp_bar(out, ref)
    for i in range(8):
        rel = abs(float(d_med[i]) - float(ref_med[i])) / abs(float(ref_med[i]))
        assert rel < CP_SCALAR, (i, float(d_med[i]), float(ref_med[i]))
    keep = torch.zeros(d_rays.shape[0], dtype=torch.bool)
    keep[pk.TAU:pk.TAU + 3] = keep[pk.EOD:] = True
    assert float(d_rays[~keep].abs().sum()) == 0.0
    keep = torch.zeros(d_vrls.shape[0], dtype=torch.bool)
    keep[pk.VP:pk.VP + 3] = keep[pk.VOD:] = True
    assert float(d_vrls[~keep].abs().sum()) == 0.0
    assert float(d_med[8:-1].abs().sum()) == 0.0
    assert float(d_dss.abs().sum()) > 0.0


def test_zero_channels_have_gradients(jax_refs):
    """ROADMAP C7 on the grid clustered path: with VRL power channel 1 and
    albedo (so sigma_s_color) channel 2 at 0, the reference returns 0 for
    d power[1] and d sigma_s_color[2]; the port matches central
    differences of its plain forward."""
    _, _, ref_pw, _, _, ref_med = jax_refs["zero"]
    assert float(ref_pw[1].abs().max()) == 0.0 and float(ref_med[5]) == 0.0
    packs = _grid_packs(*jax_refs["setup_zero"])
    _, d_vrls, d_med, _, _ = _port_vjp(packs, jax_refs["gbar_zero"])
    rows, ids, ws = _tables()
    u = _seq(W * H, N_VRLS)
    gb = torch.as_tensor(jax_refs["gbar_zero"]).double()

    def loss(ps):
        return float((vrl_sum_hetero_clustered_reference(
            *ps, rows, ids, ws, u, vol_vol_samples=SVV,
            vol_surf_samples=SVS).double() * gb).sum())

    n = int(d_vrls[pk.VP + 1].abs().argmax())
    for row, col, pack_i, eps in [(pk.VP + 1, n, 1, 1e-2), (5, None, 3, 1e-3)]:
        def shifted(s):
            ps = [p.clone() for p in packs]
            if col is None:
                ps[pack_i][row] += s
            else:
                ps[pack_i][row, col] += s
            return loss(ps)
        fd = (shifted(eps) - shifted(-eps)) / (2 * eps)
        ad = float(d_vrls[row, col] if pack_i == 1 else d_med[row])
        assert fd != 0.0
        assert abs(ad - fd) <= FD_TOL * abs(fd), (row, col, ad, fd)


def _small(n_vrls=40):
    """cornell_grid_smoke 8x8 (8^3 grid) and n_vrls bench VRLs, on the
    port's side."""
    scene = convert.scene_from_numpy(jax_scene_leaves(_jax_scene(8, 8, 8)),
                                     device=CPU)
    return scene, convert.vrls_from_numpy(jax_vrls_leaves(_jax_vrls(n_vrls)),
                                          device=CPU)


def test_identity_table_matches_the_unclustered_grid_vjp():
    """One row of every VRL at weight 1 gives the unclustered grid VJP
    (vrl_sum_hetero_bwd_reference) on the same rays and Philox stream,
    every output to float32 summation order; d_weights is the sum over
    channels of the power times d_power."""
    scene, vrls = _small()
    packs = integrator.pack_frame(scene, vrls)[3]
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    gbar = torch.as_tensor(np.random.default_rng(8).uniform(
        0.5, 1.5, (3, n_rays)).astype(np.float32))
    out = vrl_sum_hetero_clustered_bwd(
        *packs, np.zeros(n_rays, np.int64),
        torch.arange(n_vrls, dtype=torch.int32)[None], torch.ones(1, n_vrls),
        gbar, seed=4)
    ref = vrl_sum_hetero_bwd_reference(*packs, gbar,
                                       philox_uniforms(4, n_rays, n_vrls, 6))
    for o, r in zip(out[:6], ref):
        assert float(r.abs().sum()) > 0.0
        torch.testing.assert_close(o, r, rtol=1e-5,
                                   atol=1e-6 * float(r.abs().max()))
    torch.testing.assert_close(
        out[6][0], (packs[1][pk.VP:pk.VP + 3] * ref[0]).sum(dim=0),
        rtol=1e-5, atol=1e-6 * float(out[6].abs().max()))


def test_render_vjp_matches_same_seed_fd():
    """Autograd through render_clustered_kernel_diff on a grid medium with
    fixed tables (repeated and out-of-range ids, a zero weight, rows -1),
    in sigma_t_color, albedo, g, scale, the voxel with the largest |grad|
    and a table-weight scale, against central differences of
    render_clustered_kernel on the same Philox stream."""
    scene, vrls = _small()
    rng = np.random.default_rng(9)
    rows = rng.integers(-1, 3, 64)
    ids = torch.as_tensor(rng.integers(-1, 42, (3, 14)), dtype=torch.int32)
    ws = torch.as_tensor(rng.uniform(0.3, 1.7, (3, 14)).astype(np.float32))
    ws[1, 2] = 0.0
    gbar = torch.as_tensor(rng.uniform(0.5, 1.5, (8, 8, 3))).double()
    med0 = scene.medium
    p0 = {"sigma_t_color": med0.sigma_t_color, "albedo": med0.albedo,
          "g": med0.g, "scale": med0.scale, "density": med0.density,
          "wscale": torch.tensor(1.0)}

    def loss(p, render):
        med = replace(gmed.with_density(med0, p["density"]),
                      sigma_t_color=p["sigma_t_color"], albedo=p["albedo"],
                      g=p["g"], scale=p["scale"])
        img = render(replace(scene, medium=med), vrls, rows, ids,
                     ws * p["wscale"], torch.Generator().manual_seed(5))
        return (img.double() * gbar).sum()

    p = {k: v.clone().requires_grad_() for k, v in p0.items()}
    ad = dict(zip(p, torch.autograd.grad(
        loss(p, integrator.render_clustered_kernel_diff), list(p.values()))))
    top = int(ad["density"].reshape(-1).abs().argmax())

    def at(name, idx, s):
        q = {k: v.clone() for k, v in p0.items()}
        if idx is None:
            q[name] = q[name] + s
        else:
            q[name].view(-1)[idx] += s
        return float(loss(q, integrator.render_clustered_kernel))

    for name, idx, eps in [("sigma_t_color", 0, 2e-3), ("albedo", 1, 2e-3),
                           ("g", None, 2e-3), ("scale", None, 2e-3),
                           ("density", top, 2e-2), ("wscale", None, 2e-3)]:
        fd = (at(name, idx, eps) - at(name, idx, -eps)) / (2 * eps)
        a = float(ad[name] if idx is None else ad[name].reshape(-1)[idx])
        assert fd != 0.0 and abs(a - fd) <= FD_TOL * abs(fd), (name, idx, a, fd)


def test_wrapper_cpu_takes_the_plain_version():
    """On CPU tensors vrl_sum_hetero_clustered_bwd runs the plain version
    on the Philox stream of its seed and counts no launch; the shapes,
    d_par 0 outside GRID_PAR, no d_tau or d_eod for rays at row -1."""
    scene, vrls = _small()
    packs = integrator.pack_frame(scene, vrls)[3]
    rng = np.random.default_rng(10)
    rows = rng.integers(-1, 2, 64)
    ids = torch.as_tensor(rng.integers(0, 40, (2, 9)), dtype=torch.int32)
    ws = torch.as_tensor(rng.uniform(0.5, 1.5, (2, 9)).astype(np.float32))
    gbar = torch.ones((3, 64))
    before = vrl_sum_hetero_clustered_bwd.launches
    out = vrl_sum_hetero_clustered_bwd(*packs, rows, ids, ws, gbar, seed=99)
    assert vrl_sum_hetero_clustered_bwd.launches == before
    ref = vrl_sum_hetero_clustered_bwd_reference(
        *packs, rows, ids, ws, gbar, philox_table_uniforms(99, rows, ids, 6))
    for o, r in zip(out, ref):
        assert torch.equal(o, r) and torch.isfinite(o).all()
    assert [tuple(o.shape) for o in out] == [
        (3, 40), (pk.GRID_MED_LEN,), (3, 64), (N_OD, 64), (N_OD, 40),
        tuple(packs[4].shape), (2, 9)]
    live = torch.zeros(pk.GRID_MED_LEN, dtype=torch.bool)
    for r in GRID_PAR:
        live[r] = True
    assert float(out[1][~live].abs().sum()) == 0.0
    out_rows = torch.as_tensor(rows < 0)
    assert not out[2][:, out_rows].any() and not out[3][:, out_rows].any()
    assert float(out[5].abs().sum()) > 0.0
