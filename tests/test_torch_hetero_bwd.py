"""The grid-medium VJP of alvrl_tpu_torch against alvrl_tpu.

ops.vrl_sum_bwd.vrl_sum_hetero_diff (whose backward on CPU tensors is
the plain version, autograd through the plain grid forward) and the
differentiable grid render are held

  * against the JAX vrl_sum_hetero_diff and
    render_with_vrls_pallas_hetero_diff through jax.vjp, their Pallas
    kernels run in interpret mode with `_u01` patched in both kernel
    modules to the SEQ_UNIFORMS cycle and a CP rank that does not fall
    back (the port is fed the same constants): at the CP-fit bars of
    tests/test_torch_hetero_pallas.py, since those kernels read the
    density through CP factors where the port reads the grid (ROADMAP
    C9);
  * against same-seed central differences of the port's plain forward,
    and on the reference's zero-channel fault (ROADMAP C7).

Also media.heterogeneous.with_density (ROADMAP C11). Against XLA AD of
the table path, and the trainer: tests/test_torch_hetero_bwd_table.py.
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
from alvrl_tpu.integrators.vrl.integrate import VRLConfig as JVRLConfig
from alvrl_tpu.media import api as jmapi
from alvrl_tpu.media import heterogeneous as jgmed
from alvrl_tpu.ops import pack as jpk
from alvrl_tpu.ops import vrl_pallas as vp
from alvrl_tpu.ops import vrl_pallas_bwd as vpb
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.integrators.vrl import integrator
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.media import heterogeneous as gmed
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops.vrl_sum import philox_uniforms, vrl_sum_hetero
from alvrl_tpu_torch.ops.vrl_sum_bwd import (
    GRID_PAR,
    vrl_sum_hetero_bwd,
    vrl_sum_hetero_bwd_reference,
    vrl_sum_hetero_diff,
)
from tests.test_torch_hetero_render import (
    _grid_packs,
    _jax_scene,
    _jax_vrls,
)
from tests.torch_port_utils import (
    SEQ_UNIFORMS,
    in_child,
    jax_scene_leaves,
    jax_vrls_leaves,
)

torch.set_num_threads(1)

CP_RANK = 16       # as tests/test_torch_hetero_pallas.py: no XLA fall-back
N_VRLS = 64        # VRLs of the interpret-mode checks
# 1 + 1 samples per pair in the checks against JAX (the kernels' program,
# and so its compile time, grows with the unrolled sample count), and
# their constants in draw order (vol-vol V, U; vol-surf): SEQ_UNIFORMS'
SVV = SVS = 1
SEQ = (SEQ_UNIFORMS[0], SEQ_UNIFORMS[1], SEQ_UNIFORMS[4])
FD_TOL = 5e-3      # same-seed central differences (tests/test_pallas_bwd.py)
# the CP-fit bars of tests/test_torch_hetero_pallas.py (R's means): over
# the entries above R_FLOOR of the largest, the median relative error and
# the relative L1 error under CP_MEDIAN, and under CP_SHARE of the larger
# half over CP_BIG; the scalars to the image bar's mean, CP_SCALAR
CP_MEDIAN, CP_SHARE, CP_BIG, CP_SCALAR, R_FLOOR = 2e-3, 0.02, 0.03, 5e-3, 1e-3


def _t(a):
    return torch.as_tensor(np.array(a))


def _seq(n_rays, n_vrls):
    return torch.tensor(SEQ).expand(n_rays, n_vrls, len(SEQ)).contiguous()


def _cp_bar(out, ref):
    """The CP-fit bars (see CP_MEDIAN) of a per-item gradient."""
    out, ref = out.reshape(-1).double(), ref.reshape(-1).double()
    nz = ref.abs() > R_FLOOR * float(ref.abs().max())
    rel = (out - ref).abs()[nz] / ref.abs()[nz]
    big = ref.abs()[nz] > ref.abs()[nz].median()
    assert int(nz.sum()) > 20
    assert float(rel.median()) < CP_MEDIAN, float(rel.median())
    l1 = float((out - ref).abs()[nz].sum() / ref.abs()[nz].sum())
    assert l1 < CP_MEDIAN, l1
    assert float((rel[big] > CP_BIG).double().mean()) < CP_SHARE


# ---------------------------------------------------------------------------
# (a), (d): the VJP against the JAX vrl_sum_hetero_diff, interpret mode
# ---------------------------------------------------------------------------

def _setup(albedo=None, power_scale=None, kind=0):
    """cornell_grid_smoke 8x8 (8^3 grid, HG g = 0.3 or Rayleigh) x
    N_VRLS bench VRLs (some invalid): the JAX scene, every pixel's eye
    ray and hit, and the VRLs."""
    jscene = _jax_scene(8, 8, 8, kind)
    if albedo is not None:
        jscene = jscene.replace(medium=jscene.medium.replace(
            albedo=jnp.asarray(albedo, jnp.float32)))
    px, py = np.meshgrid(np.arange(8), np.arange(8))
    from alvrl_tpu.sensors import perspective as jperspective
    ray_o, ray_d = jperspective.sample_ray(
        jscene.camera, jnp.asarray(px.reshape(-1)), jnp.asarray(py.reshape(-1)))
    jscene = jmapi.prepare_scene(jscene)
    jhit = jintegrator.trace_eye_rays(jscene, ray_o, ray_d)
    jvrls = _jax_vrls(N_VRLS)
    if power_scale is not None:
        jvrls = jvrls.replace(
            power=jvrls.power * jnp.asarray(power_scale, jnp.float32))
    return jscene, ray_o, ray_d, jhit, jvrls


def _jax_vjp(jscene, ray_o, ray_d, jhit, jvrls, gbar, short=True, kind=0):
    """(d_tau (3, B), d_eod (NQ + 1, B), d_power (3, N), d_vod (NQ + 1,
    N), d_med (8,)) of the JAX vrl_sum_hetero_diff in interpret mode, cut
    to the unpadded rays and VRLs."""
    ray_pack = jpk.pack_rays_hetero(jscene, ray_o, ray_d, jhit)
    vrl_pack = jpk.pack_vrls_hetero(jvrls, jscene.medium)
    tri_flat = jpk.pack_tris(jscene)
    med_pack = jpk.pack_medium_hetero(jscene.medium)
    cp_pack, cp_err = jpk.pack_cp(jscene.medium, rank=CP_RANK)
    assert cp_err < jintegrator.CP_ERR_FALLBACK
    seed = jnp.asarray([7], jnp.int32)
    b, n = gbar.shape[1], N_VRLS
    gbar_pad = np.zeros((3, ray_pack.shape[0]), np.float32)
    gbar_pad[:, :b] = gbar

    def f(rp, vpk, mp):
        return vpb.vrl_sum_hetero_diff(rp, vpk, mp, cp_pack, jnp.float32(1.0),
                                       tri_flat, seed, CP_RANK, SVV, SVS,
                                       short, kind, 4)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, ray_pack, vrl_pack, med_pack)
        d_ray, d_vrl, d_med = vjp(jnp.asarray(gbar_pad))
    d_ray, d_vrl = _t(d_ray)[:b].T, _t(d_vrl)[:, :n]
    return (d_ray[vp._TAU:vp._TAU + 3], d_ray[vp._EOD:vp._EOD + pk.NQ + 1],
            d_vrl[vp._VP:vp._VP + 3], d_vrl[vp._VOD:vp._VOD + pk.NQ + 1],
            _t(d_med)[0, 0:8])


def _port_vjp(packs, gbar, short=True, kind=0):
    """(d_rays, d_vrls, d_medium, d_density) of the port's
    vrl_sum_hetero_diff on the SEQ_UNIFORMS constants."""
    rays, vrls, tris, med, dss = packs
    leaves = [x.clone().requires_grad_() for x in (rays, vrls, med, dss)]
    out = vrl_sum_hetero_diff(leaves[0], leaves[1], tris, leaves[2],
                              leaves[3], uniforms=_seq(rays.shape[1],
                                                       vrls.shape[1]),
                              vol_vol_samples=SVV, vol_surf_samples=SVS,
                              short_vrls=short, phase_kind=kind)
    return torch.autograd.grad((out * torch.as_tensor(gbar)).sum(), leaves)


def _gbar(seed, n):
    return np.random.default_rng(seed).uniform(0.5, 1.5, (3, n)).astype(
        np.float32)


def _interpret_refs():
    """jax_refs' interpret-mode results ("vjp", "zero", "render"), both
    kernel modules' _u01 patched to the SEQ cycle while traced (jit
    caches cleared around the patch; the backward kernel compiles once
    for the two VJPs). Run by in_child."""
    counter = {"i": 0}

    def cycle(shape):
        v = SEQ[counter["i"] % len(SEQ)]
        counter["i"] += 1
        return jnp.full(shape, v, jnp.float32)

    out = {}
    setup = _setup()
    jscene, _, _, _, jvrls = setup
    cp_pack, _ = jpk.pack_cp(jscene.medium, rank=CP_RANK)
    cfg = JVRLConfig(vol_vol_samples=SVV, vol_surf_samples=SVS)

    # the entry's body without its outer jit: its kernels, on the shapes
    # and static arguments of the VJPs above, are then compiled once
    render = jintegrator.render_with_vrls_pallas_hetero_diff.__wrapped__

    def jloss(s_mult, g):
        med = jscene.medium.replace(albedo=jscene.medium.albedo * s_mult, g=g)
        img = render(
            jscene.replace(medium=med), jvrls, jax.random.key(1), cp_pack,
            jnp.float32(1.0), cfg, CP_RANK)
        return img.mean(), img

    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vp, "_u01", cycle)
        mp.setattr(vpb, "_u01", cycle)
        out["vjp"] = _jax_vjp(*setup, _gbar(1, 64))
        out["zero"] = _jax_vjp(*_setup(albedo=(0.92, 0.92, 0.0),
                                       power_scale=(1.0, 0.0, 1.0)),
                               _gbar(3, 64))
        with pltpu.force_tpu_interpret_mode():
            (_, img), grads = jax.value_and_grad(
                jloss, argnums=(0, 1), has_aux=True)(jnp.ones((3,)),
                                                     jnp.float32(0.3))
        out["render"] = (np.asarray(img), np.asarray(grads[0]),
                         float(grads[1]))
    jax.clear_caches()
    # each kernel, traced once (forward and backward), drew the cycle
    assert counter["i"] == 2 * len(SEQ)
    return out


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's results on 8x8 x N_VRLS of cornell_grid_smoke
    through its Pallas grid kernels in interpret mode, computed in a
    child process (in_child): vrl_sum_hetero_diff's pack cotangents on
    the preset ("vjp") and with zero channels ("zero"), and the mean
    image of render_with_vrls_pallas_hetero_diff and its gradient in an
    albedo multiplier and g ("render"); with their set-ups and output
    cotangents."""
    return {"gbar": _gbar(1, 64), "gbar_zero": _gbar(3, 64),
            "setup": _setup(),
            "setup_zero": _setup(albedo=(0.92, 0.92, 0.0),
                                 power_scale=(1.0, 0.0, 1.0)),
            **in_child(_interpret_refs)}


def test_vjp_matches_jax_interpret(jax_refs):
    """d_power, d_tau, d_eod, d_vod per entry and sigma_t_color,
    sigma_s_color, g, chan of the port's grid VJP against the JAX
    vrl_sum_hetero_diff (CP rank 16, interpret mode) at the CP bars; the
    other pack rows get no gradient."""
    ref_tau, ref_eod, ref_pw, ref_vod, ref_med = jax_refs["vjp"]
    d_rays, d_vrls, d_med, d_dss = _port_vjp(_grid_packs(*jax_refs["setup"]),
                                             jax_refs["gbar"])
    for out, ref in ((d_rays[pk.TAU:pk.TAU + 3], ref_tau),
                     (d_rays[pk.EOD:], ref_eod),
                     (d_vrls[pk.VP:pk.VP + 3], ref_pw),
                     (d_vrls[pk.VOD:], ref_vod)):
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
    """ROADMAP C7 in a grid medium: with VRL power channel 1 at 0 and
    albedo (so sigma_s_color) channel 2 at 0, the reference's quotient
    cotangents return 0 for d power[1] and d sigma_s_color[2]
    (vrl_pallas_bwd.py:674-675, 767-771); both terms are linear in these
    values, and the port matches central differences of its plain
    forward."""
    _, _, ref_pw, _, ref_med = jax_refs["zero"]
    assert float(ref_pw[1].abs().max()) == 0.0 and float(ref_med[5]) == 0.0
    packs = _grid_packs(*jax_refs["setup_zero"])
    _, d_vrls, d_med, _ = _port_vjp(packs, jax_refs["gbar_zero"])
    u = _seq(64, N_VRLS)
    gb = torch.as_tensor(jax_refs["gbar_zero"]).double()

    def loss(ps):
        return float((vrl_sum_hetero(*ps, uniforms=u, vol_vol_samples=SVV,
                                     vol_surf_samples=SVS).double()
                      * gb).sum())

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


def test_render_diff_matches_jax_interpret(jax_refs):
    """The gradient of the mean image in an albedo multiplier (3,) and g
    (as scripts/bench_grad_hetero.py:75-81 takes it) through
    render_with_vrls_kernel_diff against
    render_with_vrls_pallas_hetero_diff (CP rank 16, its dens_scale at
    1, interpret mode): the image at the CP image bar of
    tests/test_torch_hetero_pallas.py, the gradients at CP_SCALAR."""
    jscene, _, _, _, jvrls = jax_refs["setup"]
    ref_img, ref_mult, ref_g = jax_refs["render"]
    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device="cpu")
    vrls = convert.vrls_from_numpy(jax_vrls_leaves(jvrls), device="cpu")
    s_mult = torch.ones(3, requires_grad=True)
    g = torch.tensor(0.3, requires_grad=True)
    med = replace(scene.medium, albedo=scene.medium.albedo * s_mult, g=g)
    img = integrator.render_with_vrls_kernel_diff(
        replace(scene, medium=med), vrls, torch.Generator().manual_seed(0),
        VRLConfig(vol_vol_samples=SVV, vol_surf_samples=SVS),
        uniforms=_seq(64, N_VRLS))
    d_mult, d_g = torch.autograd.grad(img.mean(), [s_mult, g])
    rel = np.abs(img.detach().numpy() - ref_img) / np.maximum(ref_img, 1e-3)
    assert rel.mean() < 5e-3 and rel.max() < 0.03, (rel.mean(), rel.max())
    for out, r in zip([*d_mult.tolist(), float(d_g)],
                      [*ref_mult.tolist(), ref_g]):
        assert abs(out - r) <= CP_SCALAR * abs(r), (out, r)


# ---------------------------------------------------------------------------
# (c): same-seed central differences of the plain forward
# ---------------------------------------------------------------------------

def test_grid_render_vjp_matches_same_seed_fd():
    """Autograd through render_with_vrls_kernel_diff on a grid medium, in
    sigma_t_color, albedo, g, scale and the two voxels with the largest
    |grad|, against central differences of the plain render on the same
    Philox stream."""
    scene = convert.scene_from_numpy(jax_scene_leaves(_jax_scene(8, 8, 8)),
                                     device="cpu")
    vrls = convert.vrls_from_numpy(jax_vrls_leaves(_jax_vrls(N_VRLS)),
                                   device="cpu")
    gbar = torch.as_tensor(np.random.default_rng(6).uniform(
        0.5, 1.5, (8, 8, 3))).double()
    med0 = scene.medium
    p0 = {"sigma_t_color": med0.sigma_t_color, "albedo": med0.albedo,
          "g": med0.g, "scale": med0.scale, "density": med0.density}

    def loss(p, render):
        med = replace(gmed.with_density(med0, p["density"]),
                      sigma_t_color=p["sigma_t_color"], albedo=p["albedo"],
                      g=p["g"], scale=p["scale"])
        img = render(replace(scene, medium=med), vrls,
                     torch.Generator().manual_seed(3))
        return (img.double() * gbar).sum()

    p = {k: v.clone().requires_grad_() for k, v in p0.items()}
    ad = dict(zip(p, torch.autograd.grad(
        loss(p, integrator.render_with_vrls_kernel_diff), list(p.values()))))
    flat = ad["density"].reshape(-1).abs()
    top = [int(i) for i in flat.argsort(descending=True)[:2]]

    def at(name, idx, s):
        q = {k: v.clone() for k, v in p0.items()}
        if idx is None:
            q[name] = q[name] + s
        else:
            q[name].view(-1)[idx] += s
        return float(loss(q, integrator.render_with_vrls_kernel))

    cases = [("sigma_t_color", 0, 2e-3), ("albedo", 1, 2e-3), ("g", None, 2e-3),
             ("scale", None, 2e-3)]
    cases += [("density", i, 2e-2) for i in top]
    for name, idx, eps in cases:
        fd = (at(name, idx, eps) - at(name, idx, -eps)) / (2 * eps)
        a = float(ad[name] if idx is None else ad[name].reshape(-1)[idx])
        assert fd != 0.0 and abs(a - fd) <= FD_TOL * abs(fd), (name, idx, a, fd)


# ---------------------------------------------------------------------------
# (f), the wrapper
# ---------------------------------------------------------------------------

def test_with_density_recomputes_the_majorant():
    """ROADMAP C11: dataclasses.replace keeps the old majorant;
    with_density sets max(density) * scale, detached."""
    med = gmed.make_grid_medium(np.full((4, 4, 4), 0.5, np.float32),
                                [1.0, 1.0, 1.0], [0.9, 0.9, 0.9], scale=2.0,
                                device="cpu")
    dens = torch.full((4, 4, 4), 0.5)
    dens[1, 2, 3] = 7.0
    dens.requires_grad_()
    assert float(replace(med, density=dens).max_density) == 1.0
    new = gmed.with_density(med, dens)
    assert float(new.max_density) == 14.0 and not new.max_density.requires_grad
    assert new.density is dens and torch.equal(new.sigma_t_color,
                                               med.sigma_t_color)


def test_hetero_bwd_wrapper_cpu_takes_the_plain_version():
    """On CPU tensors vrl_sum_hetero_bwd runs the plain version on the
    Philox stream of its seed and counts no launch; the shapes, and d_par
    0 outside GRID_PAR."""
    jscene, ray_o, ray_d, jhit, jvrls = _setup()
    packs = _grid_packs(jscene, ray_o, ray_d, jhit, jvrls)
    gbar = torch.ones((3, 64))
    before = vrl_sum_hetero_bwd.launches
    out = vrl_sum_hetero_bwd(*packs, gbar, seed=99)
    assert vrl_sum_hetero_bwd.launches == before
    ref = vrl_sum_hetero_bwd_reference(*packs, gbar,
                                       philox_uniforms(99, 64, N_VRLS, 6))
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    shapes = [(3, N_VRLS), (pk.GRID_MED_LEN,), (3, 64), (pk.NQ + 1, 64),
              (pk.NQ + 1, N_VRLS), tuple(packs[4].shape)]
    assert [tuple(o.shape) for o in out] == shapes
    live = torch.zeros(pk.GRID_MED_LEN, dtype=torch.bool)
    for r in GRID_PAR:
        live[r] = True
    assert float(out[1][~live].abs().sum()) == 0.0
    assert bool((out[1][live] != 0.0).all())
    for o in out:
        assert torch.isfinite(o).all()


def test_convert_keeps_the_majorant():
    """A JAX GridMedium's numpy leaves give the port's medium with the
    same Woodcock majorant, max(density) * scale."""
    for scale in (1.0, 2.5):
        jscene = _jax_scene(4, 4, 6)
        jmed = jgmed.make_grid_medium(
            jscene.medium.density, jscene.medium.sigma_t_color,
            jscene.medium.albedo, g=0.3, scale=scale)
        med = convert.scene_from_numpy(jax_scene_leaves(
            jscene.replace(medium=jmed)), device="cpu").medium
        assert float(med.max_density) == float(jmed.max_density)
