"""The clustered VJP of alvrl_tpu_torch against alvrl_tpu (homogeneous).

ops.vrl_sum_clustered_bwd.vrl_sum_clustered_diff, whose backward on CPU
tensors is the plain version (autograd through the plain clustered
forward), is held

  * against the JAX vrl_sum_clustered_diff through jax.vjp, its Pallas
    kernels run in interpret mode with `_u01` patched in both kernel
    modules to the SEQ cycle (1 + 1 samples; the port is fed the same
    constants), on tests/test_pallas_bwd.py::_clustered_setup's shape:
    16x16 rays in 2 tiles mapped to 2 slices whose tables hold the same
    128 VRLs at weights linspace(0.5, 1.5) and linspace(1.2, 0.3). The
    reference's per-slice table cotangents map to the port's d_weights
    and d_power by the chain of the module's docstring;
  * against same-seed central differences of the port's plain forward,
    and on the reference's zero-channel fault (ROADMAP C7);
  * with a table of every VRL at weight 1, against the unclustered VJP;

and render_clustered_kernel_diff against render_clustered_kernel. The
grid medium: tests/test_torch_hetero_clustered_bwd.py. The CUDA kernel
itself runs only on a card: tests/test_torch_cuda.py.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from alvrl_tpu.integrators.vrl import integrator as jintegrator
from alvrl_tpu.integrators.vrl import vrl as jvrl
from alvrl_tpu.ops import pack as jpk
from alvrl_tpu.ops import vrl_pallas as vp
from alvrl_tpu.ops import vrl_pallas_bwd as vpb
from alvrl_tpu.scene import presets as jpresets
from alvrl_tpu.sensors import perspective as jperspective
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.integrators.vrl import alvrl, integrator, vrl
from alvrl_tpu_torch.integrators.vrl import cluster as cl
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops.vrl_sum import (
    HOMOG_MEDIAN,
    HOMOG_SHARE,
    homog_bar,
    philox_uniforms,
)
from alvrl_tpu_torch.ops.vrl_sum_bwd import vrl_sum_bwd_reference
from alvrl_tpu_torch.ops.vrl_sum_clustered import (
    group_by_slice,
    philox_table_uniforms,
    vrl_sum_clustered_reference,
)
from alvrl_tpu_torch.ops.vrl_sum_clustered_bwd import (
    host_layout,
    vrl_sum_clustered_bwd,
    vrl_sum_clustered_bwd_reference,
    vrl_sum_clustered_diff,
)
from alvrl_tpu_torch.scene import presets
from tests.torch_port_utils import (
    BENCH_VRLS,
    CPU,
    SEQ_UNIFORMS,
    hit_from_jax,
    in_child,
    jax_scene_leaves,
    jax_vrls_leaves,
)

torch.set_num_threads(1)

W = H = 16         # 256 eye rays: two 128-ray tiles
N_VRLS = 128       # table columns (the reference's VRL_TILE)
# 1 + 1 samples per pair in the checks against JAX (the kernels' program,
# and so its interpret-mode cost, grows with the unrolled sample count),
# and their constants in draw order (vol-vol V, U; vol-surf)
SVV = SVS = 1
SEQ = (SEQ_UNIFORMS[0], SEQ_UNIFORMS[1], SEQ_UNIFORMS[4])
PAR_RTOL = 1e-4    # d sigma_t, d sigma_s, d g (tests/test_torch_vrl_sum_bwd.py)
FD_TOL = 5e-3      # same-seed central differences (tests/test_pallas_bwd.py)
WEIGHTS = (np.linspace(0.5, 1.5, N_VRLS, dtype=np.float32),
           np.linspace(1.2, 0.3, N_VRLS, dtype=np.float32))


def _t(a):
    return torch.as_tensor(np.array(a))


def _seq(n_rays, n_cols):
    return torch.tensor(SEQ).expand(n_rays, n_cols, len(SEQ)).contiguous()


def _assert_bar(out, ref, channels=3):
    median, share = homog_bar(out, ref, channels)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


def _setup(sigma_s=(0.8, 0.8, 0.8), power_scale=(1.0, 1.0, 1.0)):
    """cornell_smoke 16x16 (HG g = 0.3), every pixel's eye ray and hit,
    and the first N_VRLS bench VRLs (every 17th invalid)."""
    jscene = jpresets.cornell_smoke(width=W, height=H, sigma_s=sigma_s)
    jscene = jscene.replace(medium=jscene.medium.replace(g=jnp.float32(0.3)))
    px, py = np.meshgrid(np.arange(W), np.arange(H))
    ray_o, ray_d = jperspective.sample_ray(
        jscene.camera, jnp.asarray(px.reshape(-1)), jnp.asarray(py.reshape(-1)))
    jhit = jintegrator.trace_eye_rays(jscene, ray_o, ray_d)
    full = jvrl.load_ascii(BENCH_VRLS, particle_count=78.0)
    valid = np.ones(N_VRLS, bool)
    valid[::17] = False
    jvrls = full.replace(
        start=full.start[:N_VRLS], end=full.end[:N_VRLS],
        power=full.power[:N_VRLS] * jnp.asarray(power_scale, jnp.float32),
        valid=jnp.asarray(valid))
    return jscene, ray_o, ray_d, jhit, jvrls


def _jax_vjp(jscene, ray_o, ray_d, jhit, jvrls, gbar):
    """(d_tau (3, B), d_power (3, N), d_weights (2, N), d_par (7,)) of
    the JAX vrl_sum_clustered_diff in interpret mode: rays 0-127 (tile 0)
    on slice 0, rays 128-255 (tile 1) on slice 1, each slice's table the
    packed VRLs with the power rows times its weights; the per-slice
    table cotangents d_tables chained to the weights (sum over channels
    of d_tables times the power) and the powers (sum over slices of the
    weight times d_tables)."""
    ray_pack = jpk.pack_rays(jscene, ray_o, ray_d, jhit)
    base = jpk.pack_vrls(jvrls)
    tables = jnp.stack([base.at[vp._VP:vp._VP + 3].multiply(w[None])
                        for w in WEIGHTS])
    tri_flat, med_pack = jpk.pack_tris(jscene), jpk.pack_medium(jscene)
    seed = jnp.asarray([9], jnp.int32)
    tile_slice = jnp.asarray([0, 1], jnp.int32)

    def f(rp, tb, mp):
        return vpb.vrl_sum_clustered_diff(rp, tb, tile_slice, mp, tri_flat,
                                          seed, SVV, SVS, True, 0)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, ray_pack, tables, med_pack)
        d_ray, d_tables, d_med = vjp(jnp.asarray(gbar))
    d_pw_t = _t(d_tables)[:, vp._VP:vp._VP + 3].double()  # (2, 3, N)
    power = _t(base)[vp._VP:vp._VP + 3].double()
    w = torch.as_tensor(np.stack(WEIGHTS)).double()
    return (_t(d_ray)[:, vp._TAU:vp._TAU + 3].T,
            (w[:, None] * d_pw_t).sum(dim=0).float(),
            (d_pw_t * power[None]).sum(dim=1).float(), _t(d_med)[0, 0:7])


def _gbars():
    rng = np.random.default_rng(1)
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
        out["zero"] = _jax_vjp(*_setup(sigma_s=(0.8, 0.8, 0.0),
                                       power_scale=(1.0, 0.0, 1.0)), gbar_zero)
    jax.clear_caches()
    # each kernel, traced once (forward and backward), drew the cycle
    assert counter["i"] == 2 * len(SEQ)
    return out


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's clustered VJP, computed in a child process
    (in_child), on the preset ("vjp") and with a zero VRL power channel
    and a zero sigma_s channel ("zero"), with their set-ups and output
    cotangents."""
    gbar, gbar_zero = _gbars()
    return {"gbar": gbar, "gbar_zero": gbar_zero, "setup": _setup(),
            "setup_zero": _setup(sigma_s=(0.8, 0.8, 0.0),
                                 power_scale=(1.0, 0.0, 1.0)),
            **in_child(_interpret_refs)}


def _port_packs(jscene, ray_o, ray_d, jhit, jvrls):
    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device=CPU)
    mat = torch.as_tensor(np.asarray(jhit.mat), dtype=torch.int64)
    rays = pk.pack_rays(scene, _t(ray_o), _t(ray_d), hit_from_jax(jhit), mat)
    vrls = convert.vrls_from_numpy(jax_vrls_leaves(jvrls), device=CPU)
    return rays, pk.pack_vrls(vrls), pk.pack_tris(scene), pk.pack_medium(scene)


def _tables():
    """The fixture's two slices: (ray rows, ids (2, N), weights (2, N))."""
    rows = np.repeat([0, 1], W * H // 2)
    ids = torch.arange(N_VRLS, dtype=torch.int32).expand(2, N_VRLS)
    return rows, ids.contiguous(), torch.as_tensor(np.stack(WEIGHTS))


def _port_vjp(packs, gbar):
    """(d_rays, d_vrls, d_medium, d_weights) of the port's
    vrl_sum_clustered_diff on the SEQ constants."""
    rows, ids, ws = _tables()
    rays, vrls, tris, med = packs
    leaves = [x.clone().requires_grad_() for x in (rays, vrls, med, ws)]
    out = vrl_sum_clustered_diff(
        leaves[0], leaves[1], tris, leaves[2], rows, ids, leaves[3],
        uniforms=_seq(rays.shape[1], N_VRLS), vol_vol_samples=SVV,
        vol_surf_samples=SVS)
    return torch.autograd.grad((out * torch.as_tensor(gbar)).sum(), leaves)


def test_vjp_matches_jax_interpret(jax_refs):
    """d_tau, d_power and d_weights at the homogeneous bar, d sigma_t,
    d sigma_s and d g to PAR_RTOL; the other pack rows get no gradient."""
    ref_tau, ref_pw, ref_w, ref_par = jax_refs["vjp"]
    d_rays, d_vrls, d_med, d_w = _port_vjp(_port_packs(*jax_refs["setup"]),
                                           jax_refs["gbar"])
    _assert_bar(d_rays[pk.TAU:pk.TAU + 3].T, ref_tau.T)
    _assert_bar(d_vrls[pk.VP:pk.VP + 3].T, ref_pw.T)
    _assert_bar(d_w, ref_w, channels=1)
    assert float(d_w.abs().min()) == 0.0 and float(d_w.abs().max()) > 0.0
    torch.testing.assert_close(d_med[0:7], ref_par, rtol=PAR_RTOL, atol=0.0)
    keep = torch.zeros(d_rays.shape[0], dtype=torch.bool)
    keep[pk.TAU:pk.TAU + 3] = True
    assert float(d_rays[~keep].abs().sum()) == 0.0
    keep = torch.zeros(d_vrls.shape[0], dtype=torch.bool)
    keep[pk.VP:pk.VP + 3] = True
    assert float(d_vrls[~keep].abs().sum()) == 0.0
    assert float(d_med[7]) == 0.0


def test_zero_channels_have_gradients(jax_refs):
    """ROADMAP C7 on the clustered path: with VRL power channel 1 and
    sigma_s channel 2 at 0, the reference's quotient cotangents return 0
    for d power[1] and d sigma_s[2] (the shared _bwd_kernel); both terms
    are linear in these values, and the port matches central differences
    of its plain forward."""
    _, ref_pw, _, ref_par = jax_refs["zero"]
    assert float(ref_pw[1].abs().max()) == 0.0 and float(ref_par[5]) == 0.0
    packs = _port_packs(*jax_refs["setup_zero"])
    _, d_vrls, d_med, _ = _port_vjp(packs, jax_refs["gbar_zero"])
    rows, ids, ws = _tables()
    u = _seq(W * H, N_VRLS)
    gb = torch.as_tensor(jax_refs["gbar_zero"]).double()

    def loss(ps):
        return float((vrl_sum_clustered_reference(
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


def _small(width=8, height=8, n_vrls=48, g=0.4, kind=0):
    """A small homogeneous frame and the first n_vrls bench VRLs (every
    11th invalid): (scene, vrls)."""
    scene = presets.cornell_smoke(width, height, g=g, device=CPU)
    scene = replace(scene, medium=replace(scene.medium, phase_kind=kind))
    full = vrl.load_ascii(BENCH_VRLS, particle_count=78.0, device=CPU)
    valid = full.valid[:n_vrls].clone()
    valid[3::11] = False
    return scene, replace(full, start=full.start[:n_vrls],
                          end=full.end[:n_vrls], power=full.power[:n_vrls],
                          valid=valid)


def _random_tables(n_rays, n_vrls, n_rows=3, n_cols=20, seed=2):
    """Tables of repeated and out-of-range ids, a zero weight, and rays at
    rows in [-1, n_rows)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, n_vrls + 2, (n_rows, n_cols))
    ws = rng.uniform(0.3, 1.7, (n_rows, n_cols)).astype(np.float32)
    ws[0, 3] = 0.0
    return (rng.integers(-1, n_rows, n_rays),
            torch.as_tensor(ids, dtype=torch.int32), torch.as_tensor(ws))


@pytest.mark.parametrize("kind", [0, 1], ids=["hg", "rayleigh"])
def test_port_vjp_matches_same_seed_fd(kind):
    """Autograd through vrl_sum_clustered_diff (pack gradients chained to
    sigma_a, sigma_s, g, a power scale and a table-weight scale) against
    central differences of the plain forward on the same Philox stream,
    2 + 2 samples."""
    scene, vrls = _small(kind=kind)
    n_rays = scene.camera.width * scene.camera.height
    rows, ids, ws = _random_tables(n_rays, vrls.capacity)
    gbar = torch.as_tensor(np.random.default_rng(4).uniform(
        0.5, 1.5, (3, n_rays))).double()
    seed = 23
    u = philox_table_uniforms(seed, rows, ids, 6)
    p0 = {"sigma_a": scene.medium.sigma_a, "sigma_s": scene.medium.sigma_s,
          "g": scene.medium.g, "pscale": torch.tensor(1.0),
          "wscale": torch.tensor(1.0)}

    def packs_at(p):
        sc = replace(scene, medium=replace(
            scene.medium, sigma_a=p["sigma_a"], sigma_s=p["sigma_s"],
            g=p["g"]))
        vr = replace(vrls, power=vrls.power * p["pscale"])
        return integrator.pack_frame(sc, vr)[3], ws * p["wscale"]

    p = {k: v.clone().requires_grad_() for k, v in p0.items()}
    packs, w = packs_at(p)
    loss = (vrl_sum_clustered_diff(*packs, rows, ids, w, seed=seed,
                                   phase_kind=kind).double() * gbar).sum()
    ad = dict(zip(p, torch.autograd.grad(loss, list(p.values()),
                                         allow_unused=True,
                                         materialize_grads=True)))

    def at(name, idx, s):
        q = {k: v.clone() for k, v in p0.items()}
        if idx is None:
            q[name] = q[name] + s
        else:
            q[name][idx] += s
        packs, w = packs_at(q)
        return float((vrl_sum_clustered_reference(
            *packs, rows, ids, w, u, phase_kind=kind).double() * gbar).sum())

    eps = 2e-3
    for name, idx in [("sigma_a", 0), ("sigma_s", 1), ("g", None),
                      ("pscale", None), ("wscale", None)]:
        fd = (at(name, idx, eps) - at(name, idx, -eps)) / (2 * eps)
        a = float(ad[name] if idx is None else ad[name][idx])
        if kind == 1 and name == "g":
            assert a == 0.0 and abs(fd) < 1e-9
            continue
        assert abs(a - fd) <= FD_TOL * abs(fd), (name, idx, a, fd)


def test_identity_table_matches_the_unclustered_vjp():
    """One row of every VRL at weight 1 gives the unclustered VJP
    (vrl_sum_bwd_reference) on the same rays and Philox stream: d_power,
    d_par and d_tau to float32 summation order; d_weights is the sum over
    channels of the power times d_power."""
    scene, vrls = _small()
    packs = integrator.pack_frame(scene, vrls)[3]
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    gbar = torch.as_tensor(np.random.default_rng(5).uniform(
        0.5, 1.5, (3, n_rays)).astype(np.float32))
    out = vrl_sum_clustered_bwd(
        *packs, np.zeros(n_rays, np.int64),
        torch.arange(n_vrls, dtype=torch.int32)[None], torch.ones(1, n_vrls),
        gbar, seed=8)
    ref = vrl_sum_bwd_reference(*packs, gbar,
                                philox_uniforms(8, n_rays, n_vrls, 6))
    for o, r in zip(out[:3], ref):
        assert float(r.abs().sum()) > 0.0
        torch.testing.assert_close(o, r, rtol=1e-5,
                                   atol=1e-6 * float(r.abs().max()))
    torch.testing.assert_close(
        out[3][0], (packs[1][pk.VP:pk.VP + 3] * ref[0]).sum(dim=0),
        rtol=1e-5, atol=1e-6 * float(out[3].abs().max()))


def test_render_clustered_diff_is_the_clustered_render():
    """render_clustered_kernel_diff on one prepare_clustering pass's
    tables gives render_clustered_kernel's image on the same seed, and
    its gradients reach sigma_a, sigma_s, g and the table weights."""
    scene, vrls = _small(12, 12, 64)
    params = alvrl.ALVRLParams(
        vrl_target_num=64, cluster=cl.ClusterParams(
            target_num_slices=6, target_pixel_undersampling=8.0))
    sop, tv, tw, _ = alvrl.prepare_clustering(scene, vrls, 3, params,
                                              VRLConfig())
    med = scene.medium
    p = {k: getattr(med, k).clone().requires_grad_()
         for k in ("sigma_a", "sigma_s", "g")}
    w = tw.clone().requires_grad_()
    img = integrator.render_clustered_kernel_diff(
        replace(scene, medium=replace(med, **p)), vrls, sop, tv, w,
        torch.Generator().manual_seed(6))
    ref = integrator.render_clustered_kernel(
        scene, vrls, sop, tv, tw, torch.Generator().manual_seed(6))
    assert torch.equal(img.detach(), ref) and float(ref.mean()) > 0.0
    grads = torch.autograd.grad(img.mean(), [*p.values(), w])
    for g in grads:
        assert torch.isfinite(g).all() and float(g.abs().sum()) > 0.0
    # columns that are padding (weight 0) get no gradient
    assert float(grads[-1][tw == 0.0].abs().sum()) == 0.0


def test_wrapper_cpu_takes_the_plain_version():
    """On CPU tensors vrl_sum_clustered_bwd runs the plain version on the
    Philox stream of its seed and counts no launch; rays at row -1 get no
    d_tau."""
    scene, vrls = _small(6, 6, 40)
    packs = integrator.pack_frame(scene, vrls)[3]
    rows, ids, ws = _random_tables(36, 40)
    gbar = torch.ones((3, 36))
    before = vrl_sum_clustered_bwd.launches
    out = vrl_sum_clustered_bwd(*packs, rows, ids, ws, gbar, seed=99)
    assert vrl_sum_clustered_bwd.launches == before
    ref = vrl_sum_clustered_bwd_reference(
        *packs, rows, ids, ws, gbar, philox_table_uniforms(99, rows, ids, 6))
    for o, r in zip(out, ref):
        assert torch.equal(o, r) and torch.isfinite(o).all()
    assert [tuple(o.shape) for o in out] == [(3, 40), (8,), (3, 36), (3, 20)]
    assert not out[2][:, rows < 0].any() and float(out[2].abs().sum()) > 0.0
    # an id outside [0, N) and a zero weight give no d_weights
    dead = (ids < 0) | (ids >= 40) | (ws <= 0.0)
    assert float(out[3][dead].abs().sum()) == 0.0


@pytest.mark.parametrize("bad", ["gbar_rays", "gbar_float64", "gbar_strided",
                                 "ids_int64", "rows_length"])
def test_wrapper_rejects_bad_input(bad):
    scene, vrls = _small(4, 4, 40)
    packs = integrator.pack_frame(scene, vrls)[3]
    rows = np.zeros(16, np.int64)
    ids, ws = torch.zeros((2, 6), dtype=torch.int32), torch.ones((2, 6))
    gbar = torch.ones((3, 16))
    if bad == "gbar_rays":
        gbar = torch.ones((3, 15))
    elif bad == "gbar_float64":
        gbar = gbar.double()
    elif bad == "gbar_strided":
        gbar = torch.ones((16, 3)).T
    elif bad == "ids_int64":
        ids = ids.long()
    else:
        rows = rows[:-1]
    with pytest.raises((TypeError, ValueError)):
        vrl_sum_clustered_bwd(*packs, rows, ids, ws, gbar)


@pytest.mark.parametrize("ray_block", [32, 128], ids=["homog", "grid"])
def test_host_layout_at_the_tile_sizes(ray_block):
    """host_layout (and group_by_slice, whose tiles it takes) at the
    backward's two tiles, 32 rays (homogeneous) and 128 (grid), on a
    seeded ray_slice with rows of 1, 31, 32, 33 and 200 rays and rays at
    row -1: every kept ray in exactly one tile, each row's tiles
    contiguous and row_tiles their first, padding only at a row's last
    tile; the CSR of the table slots by VRL id does not depend on the
    tile."""
    rng = np.random.default_rng(12)
    sizes = (1, 31, 32, 33, 200)
    rows = np.repeat(np.arange(-1, len(sizes)), (40, *sizes))
    rng.shuffle(rows)
    n_vrls = 50
    ids = torch.as_tensor(rng.integers(-2, n_vrls + 3, (len(sizes), 45)),
                          dtype=torch.int32)
    tile_rays, tile_row, row_tiles, slots, slot_start = (
        t.numpy() for t in host_layout(rows, ids, n_vrls, ray_block, "cpu"))
    ref_rays, ref_row = group_by_slice(rows, ray_block)
    assert np.array_equal(tile_rays, ref_rays)
    assert np.array_equal(tile_row, ref_row)
    assert sorted(tile_rays[tile_rays >= 0]) == list(np.flatnonzero(rows >= 0))
    tiles = tile_rays.reshape(-1, ray_block)
    assert row_tiles[0] == 0 and row_tiles[-1] == len(tile_row)
    for s, n in enumerate(sizes):
        mine = np.flatnonzero(tile_row == s)
        assert np.array_equal(mine, np.arange(row_tiles[s], row_tiles[s + 1]))
        assert len(mine) == -(-n // ray_block)
        got = tiles[mine].reshape(-1)
        assert np.array_equal(got[got >= 0], np.flatnonzero(rows == s))
        assert (got[:n] >= 0).all() and (got[n:] < 0).all()
    flat = ids.numpy().reshape(-1)
    held = (flat >= 0) & (flat < n_vrls)
    assert slot_start[0] == 0 and slot_start[-1] == len(slots) == held.sum()
    for n in range(n_vrls):
        assert np.array_equal(slots[slot_start[n]:slot_start[n + 1]],
                              np.flatnonzero(flat == n))
