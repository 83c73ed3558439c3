"""The clustered render of alvrl_tpu_torch against alvrl_tpu.

The R kernel's and the clustered kernel's plain versions (ops.vrl_r,
ops.vrl_sum_clustered), reached through integrator.build_R_kernel and
integrator.render_clustered_kernel, are held against the JAX package's
Pallas kernels (vrl_r_pallas, vrl_sum_pallas_clustered) run in
interpret mode, with the same per-draw constants fed to both; the whole
pass (alvrl.render_alvrl) against the port's unclustered render; the
fall-back launch, the identities that tie the three forward kernels
together, and the wrappers' host grouping and input checks. The kernels
themselves run only on a CUDA card: see tests/test_torch_cuda.py.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from alvrl_tpu.integrators.vrl import alvrl as jalvrl
from alvrl_tpu.integrators.vrl import cluster as jcl
from alvrl_tpu.integrators.vrl import integrator as jintegrator
from alvrl_tpu.integrators.vrl import vrl as jvrl
from alvrl_tpu.integrators.vrl.integrate import VRLConfig as JVRLConfig
from alvrl_tpu.ops import vrl_pallas as vp
from alvrl_tpu.scene import presets as jpresets
from alvrl_tpu.sensors import perspective as jperspective
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.core.spectrum import LUM_WEIGHTS
from alvrl_tpu_torch.integrators.vrl import alvrl, integrator, vrl
from alvrl_tpu_torch.integrators.vrl import cluster as cl
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.integrators.vrl.tracer import TracerConfig
from alvrl_tpu_torch.ops.vrl_r import vrl_r, vrl_r_reference
from alvrl_tpu_torch.ops.vrl_sum import (
    HOMOG_MEDIAN,
    HOMOG_SHARE,
    homog_bar,
    philox_uniforms,
    vrl_sum,
)
from alvrl_tpu_torch.ops.vrl_sum_clustered import (
    group_by_slice,
    philox_table_uniforms,
    vrl_sum_clustered,
    vrl_sum_clustered_reference,
)
from alvrl_tpu_torch.scene import presets
from tests.torch_port_utils import (
    BENCH_VRLS,
    CPU,
    SEQ_UNIFORMS,
    in_child,
    jax_scene_leaves,
    jax_vrls_leaves,
)

torch.set_num_threads(1)

W = H = 16
N_VRLS = 128
SLICING = dict(target_num_slices=8, target_pixel_undersampling=8.0)
# R bars (tests/test_hetero_pallas.py::test_r_mode_matches_build_r_homog):
# the means agree to float32 rounding except where the two pipelines
# round one occlusion-edge test differently; the variance of the mean is
# a difference of two sums of squares, so it carries more cancellation
R_MEAN_FLOOR, R_VAR_FLOOR = 1e-9, 1e-12  # raw values compared above these
R_VAR_MEDIAN = 1e-4
# the mean clustered over the mean unclustered image over 3 seeds: the
# band of tests/test_render.py's clustered-vs-unclustered check
BAND = (0.85, 1.15)


def _jax_vrls():
    """The first N_VRLS bench VRLs, every 17th invalid."""
    full = jvrl.load_ascii(BENCH_VRLS, particle_count=78.0)
    valid = np.ones(N_VRLS, bool)
    valid[::17] = False
    return full.replace(start=full.start[:N_VRLS], end=full.end[:N_VRLS],
                        power=full.power[:N_VRLS], valid=jnp.asarray(valid))


def _seq(*shape):
    return torch.tensor(SEQ_UNIFORMS).expand(*shape, 6).contiguous()


def _interpret_refs():
    """The body of the `jax_ref` fixture, run in a child process by
    in_child."""
    jscene = jpresets.cornell_smoke(width=W, height=H)
    jvrls = _jax_vrls()
    jparams = jalvrl.ALVRLParams(vrl_target_num=N_VRLS,
                                 cluster=jcl.ClusterParams(**SLICING))
    cfg = JVRLConfig()
    counter = {"i": 0}

    def mock(shape):
        v = SEQ_UNIFORMS[counter["i"] % len(SEQ_UNIFORMS)]
        counter["i"] += 1
        return jnp.full(shape, v, jnp.float32)

    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp, \
            pltpu.force_tpu_interpret_mode():
        mp.setattr(vp, "_u01", mock)
        sop, tv, tw, info = jalvrl.prepare_clustering(
            jscene, jvrls, None, jparams, cfg, use_pallas=True)
        rows = np.concatenate(jalvrl.build_slice_info(jscene,
                                                      jparams).repr_rows)
        ray_o, ray_d = jperspective.sample_ray(
            jscene.camera, jnp.asarray(rows % W, jnp.int32),
            jnp.asarray(rows // W, jnp.int32))
        r = jintegrator._build_r_pallas_jit(jscene, ray_o, ray_d, jvrls,
                                            jnp.asarray([1], jnp.int32), cfg)
        img = jintegrator.render_clustered_pallas(jscene, jvrls, sop, tv, tw,
                                                  jax.random.key(3), cfg)
        out = dict(sop=np.asarray(sop), tv=np.asarray(tv), tw=np.asarray(tw),
                   info=info, ray_o=np.asarray(ray_o), ray_d=np.asarray(ray_d),
                   r=np.asarray(r)[:, :len(rows), :N_VRLS],
                   img=np.asarray(img))
    jax.clear_caches()
    assert counter["i"] >= 2 * len(SEQ_UNIFORMS)
    assert counter["i"] % len(SEQ_UNIFORMS) == 0  # whole cycles per trace
    out["scene"] = convert.scene_from_numpy(jax_scene_leaves(jscene),
                                            device=CPU)
    out["vrls"] = convert.vrls_from_numpy(jax_vrls_leaves(jvrls), device=CPU)
    return out


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's clustered prepass and render through its Pallas
    kernels in interpret mode, with the kernels' _u01 returning the next
    SEQ_UNIFORMS constant at each call while traced (jit caches cleared
    around the patch): the tables of prepare_clustering(use_pallas=True),
    the raw R of _build_r_pallas_jit over the representative rays, and
    render_clustered_pallas's image on those tables. Computed in a child process
    (tests/torch_port_utils.py in_child)."""
    return in_child(_interpret_refs)


def test_build_R_kernel_matches_pallas_interpret(jax_ref):
    """integrator.build_R_kernel (eye hits, packs, vrl_r's plain version,
    normalisation) vs _build_r_pallas_jit over the same representative
    rays, normalised the same way: means at the R-mode bar, variances
    of the mean to a median relative error of R_VAR_MEDIAN."""
    ray_o, ray_d = (torch.as_tensor(jax_ref[k]) for k in ("ray_o", "ray_d"))
    n_rays = ray_o.shape[0]
    mean, var = integrator.build_R_kernel(
        jax_ref["scene"], ray_o, ray_d, jax_ref["vrls"], 0, VRLConfig(),
        uniforms=_seq(n_rays, N_VRLS))
    norm = 1.0 / 78.0
    raw_mean, raw_var = jax_ref["r"]
    assert mean.shape == var.shape == (n_rays, N_VRLS)
    nz = raw_mean > R_MEAN_FLOOR
    assert nz.sum() > 100
    rel = np.abs(mean.numpy() - raw_mean * norm)[nz] / (raw_mean[nz] * norm)
    assert np.median(rel) < HOMOG_MEDIAN, np.median(rel)
    assert (rel > 1e-2).mean() < HOMOG_SHARE
    nzv = raw_var > R_VAR_FLOOR
    assert nzv.sum() > 100
    ref_var = raw_var * norm * norm
    rel_v = np.abs(var.numpy() - ref_var)[nzv] / ref_var[nzv]
    assert np.median(rel_v) < R_VAR_MEDIAN, np.median(rel_v)


def test_render_clustered_kernel_matches_pallas_interpret(jax_ref):
    """render_clustered_kernel (grouping, the clustered sum's plain
    version, scatter, normalisation, film) on the JAX package's own
    tables vs render_clustered_pallas: the homogeneous bar."""
    sop, tv, tw = convert.cluster_tables_from_numpy(
        jax_ref["sop"], jax_ref["tv"], jax_ref["tw"], device=CPU)
    img = integrator.render_clustered_kernel(
        jax_ref["scene"], jax_ref["vrls"], sop, tv, tw,
        torch.Generator().manual_seed(0), VRLConfig(),
        uniforms=_seq(W * H, tv.shape[1]))
    ref = torch.as_tensor(jax_ref["img"])
    assert img.shape == (H, W, 3) and float(img.mean()) > 0.0
    median, share = homog_bar(img, ref)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


def _scene(width=W, height=H):
    return presets.cornell_smoke(width, height, device=CPU)


def _small_params():
    return (alvrl.ALVRLParams(vrl_target_num=N_VRLS, num_particles=16,
                              cluster=cl.ClusterParams(**SLICING)),
            TracerConfig(max_depth=8))


def test_render_alvrl_end_to_end():
    """One clustered pass per seed on the CPU: a finite, positive image,
    and over 3 seeds the mean clustered image lies within BAND of the
    mean unclustered image of the same VRLs (clustering is unbiased; the
    band allows its representative-sampling noise)."""
    scene = _scene()
    params, tcfg = _small_params()
    info = alvrl.build_slice_info(scene, params)
    launches = (vrl_r.launches, vrl_sum_clustered.launches)
    clustered, unclustered = [], []
    for seed in range(3):
        img, vrls, packed = alvrl.render_alvrl(
            scene, torch.Generator().manual_seed(seed), params, VRLConfig(),
            tcfg, slice_info=info)
        assert img.shape == (H, W, 3) and torch.isfinite(img).all()
        assert float(img.min()) >= 0.0 and float(img.mean()) > 0.0
        assert packed.slice_vrls.shape[0] == SLICING["target_num_slices"]
        clustered.append(float(img.mean()))
        unclustered.append(float(integrator.render_with_vrls_kernel(
            scene, vrls, torch.Generator().manual_seed(100 + seed)).mean()))
    ratio = np.mean(clustered) / np.mean(unclustered)
    assert BAND[0] < ratio < BAND[1], (ratio, clustered, unclustered)
    assert (vrl_r.launches, vrl_sum_clustered.launches) == launches


def test_render_alvrl_draws_from_the_generator():
    """The tracer's uniforms, R's seed and the render's seed all come
    from the generator: a seed repeats exactly, and R changes with the
    seed it is given (the JAX package fixes R's key; ROADMAP C8)."""
    scene = _scene(12, 12)
    params, tcfg = _small_params()
    info = alvrl.build_slice_info(scene, params)

    def run(seed):
        return alvrl.render_alvrl(scene, torch.Generator().manual_seed(seed),
                                  params, VRLConfig(), tcfg, slice_info=info)

    (a, vrls, _), (b, _, _), (c, _, _) = run(4), run(4), run(5)
    assert torch.equal(a, b) and not torch.equal(a, c)
    r1, r2 = (alvrl.build_R_device(scene, vrls, VRLConfig(), info, s)
              for s in (1, 2))
    assert r1[0].dtype == torch.bfloat16 and not torch.equal(r1[0], r2[0])


def _packs(width=12, height=12, n_vrls=64):
    """A small frame and the first n_vrls bench VRLs: (scene, vrls,
    pack_frame's (px, py, hit, packs))."""
    scene = _scene(width, height)
    full = vrl.load_ascii(BENCH_VRLS, particle_count=78.0, device=CPU)
    vrls = replace(full, start=full.start[:n_vrls], end=full.end[:n_vrls],
                   power=full.power[:n_vrls], valid=full.valid[:n_vrls])
    return scene, vrls, integrator.pack_frame(scene, vrls)


def test_fallback_pixels_take_a_second_launch():
    """Pixels at row -1 render through the one-row fall-back table with
    the render's seed, and equal a direct launch of that row; without a
    fall-back set they render 0."""
    scene, vrls, (px, py, hit, packs) = _packs()
    rng = np.random.default_rng(3)
    n_pix = px.shape[0]
    sop = rng.integers(0, 2, n_pix).astype(np.int32)
    sop[rng.random(n_pix) < 0.3] = -1
    tv = torch.as_tensor(rng.integers(0, 64, (2, 5)), dtype=torch.int32)
    tw = torch.as_tensor(rng.uniform(0.5, 2.0, (2, 5)), dtype=torch.float32)
    fb = (torch.as_tensor(rng.integers(0, 64, 9), dtype=torch.int32),
          torch.as_tensor(rng.uniform(0.5, 2.0, 9), dtype=torch.float32))
    img = integrator.render_clustered_kernel(
        scene, vrls, sop, tv, tw, torch.Generator().manual_seed(8),
        fallback=fb)
    seed = integrator.draw_seed(torch.Generator().manual_seed(8))
    main = vrl_sum_clustered(*packs, sop, tv, tw, seed=seed)
    direct = vrl_sum_clustered(*packs, np.where(sop < 0, 0, -1),
                               fb[0][None], fb[1][None], seed=seed)
    fb_pix = torch.as_tensor(sop < 0)
    assert float(direct[:, fb_pix].abs().sum()) > 0.0
    assert not direct[:, ~fb_pix].any() and not main[:, fb_pix].any()
    assert torch.equal(img, integrator.develop_sums(scene, vrls, px, py, hit,
                                                    main + direct))
    bare = integrator.render_clustered_kernel(
        scene, vrls, sop, tv, tw, torch.Generator().manual_seed(8))
    assert not bare.reshape(-1, 3)[fb_pix].any()
    assert torch.equal(bare.reshape(-1, 3)[~fb_pix],
                       img.reshape(-1, 3)[~fb_pix])


def test_fallback_table_only_when_needed():
    info = cl.pack_cluster_info(np.array([0, 1, 0], np.uint32),
                                [np.array([1]), np.array([2])],
                                [np.array([1.0]), np.array([1.0])],
                                np.array([3, 4]), np.array([0.5, 0.5]),
                                np.array([3]), np.array([1.0]))
    assert alvrl.fallback_table(info, CPU) is None
    info.pixel_to_slice[2] = -1
    ids, ws = alvrl.fallback_table(info, CPU)
    assert ids.tolist() == [3, 4] and ws.tolist() == [0.5, 0.5]


def test_identity_table_reproduces_vrl_sum():
    """A table whose one row holds every VRL at weight 1 gives vrl_sum's
    result on the same rays and seed: both key the stream by (pixel, VRL
    id). Equal up to float32 summation order."""
    _, _, (_, _, _, packs) = _packs()
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    ids = torch.arange(n_vrls, dtype=torch.int32)[None]
    out = vrl_sum_clustered(*packs, np.zeros(n_rays, np.int64), ids,
                            torch.ones((1, n_vrls)), seed=11)
    ref = vrl_sum(*packs, seed=11)
    assert float(ref.abs().sum()) > 0.0
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-9)


def test_r_row_sums_are_vrl_sum_luminance():
    """sum_n R_mean[p, n] is the luminance of vrl_sum's out[:, p] on the
    same rays and seed (the R counter is (p, VRL id) as vrl_sum's), up
    to float32 summation order."""
    _, _, (_, _, _, packs) = _packs(8, 8)
    out = vrl_r(*packs, seed=21)
    lum = sum(w * c for w, c in zip(LUM_WEIGHTS, vrl_sum(*packs, seed=21)))
    assert out.shape == (2, 64, packs[1].shape[1])
    assert float((out[1] > 0).double().mean()) > 0.1
    torch.testing.assert_close(out[0].sum(dim=1), lum, rtol=1e-5, atol=1e-9)


def test_clustered_weights_and_ids():
    """A column's weight multiplies its VRL's power; a weight of 0 or an
    id outside [0, N) drops the column."""
    _, _, (_, _, _, packs) = _packs(8, 8)
    n_rays = packs[0].shape[1]
    rows = np.zeros(n_rays, np.int64)
    ids = torch.tensor([[5, 9, 30]], dtype=torch.int32)
    one = vrl_sum_clustered(*packs, rows, ids, torch.ones((1, 3)), seed=2)
    two = vrl_sum_clustered(*packs, rows, ids, torch.full((1, 3), 2.0),
                            seed=2)
    torch.testing.assert_close(two, 2.0 * one, rtol=1e-6, atol=0.0)
    dropped = vrl_sum_clustered(
        *packs, rows, torch.tensor([[5, 9, 30, 64, -3, 7]], dtype=torch.int32),
        torch.tensor([[1.0, 1.0, 1.0, 1.0, 1.0, 0.0]]), seed=2)
    torch.testing.assert_close(dropped, one, rtol=1e-6, atol=0.0)


def test_group_by_slice():
    """Rays grouped by row into tiles of one row each, rows ascending,
    each row's rays in ray order, padding -1, rows -1 left out."""
    rng = np.random.default_rng(0)
    rows = rng.integers(-1, 5, 103)
    tile_rays, tile_row = group_by_slice(rows, 8)
    assert tile_rays.dtype == np.int32 and tile_row.dtype == np.int32
    assert len(tile_rays) == 8 * len(tile_row)
    tiles = tile_rays.reshape(-1, 8)
    assert np.all(np.diff(tile_row) >= 0)
    for r in np.unique(rows[rows >= 0]):
        got = tiles[tile_row == r].reshape(-1)
        assert np.array_equal(got[got >= 0], np.flatnonzero(rows == r))
        assert len(got) == 8 * -(-int((rows == r).sum()) // 8)
    assert sorted(tile_rays[tile_rays >= 0]) == list(np.flatnonzero(rows >= 0))


@pytest.mark.parametrize("case", ["row_sizes", "one_row", "no_row"])
def test_group_by_slice_in_warp_tiles(case):
    """Grouping at kernel 2's tile of 32 rays (ops.vrl_sum_clustered's
    ray_block(False)): each row's rays fill ceil(n / 32) tiles of that
    row in ray order, the padding (-1) only in a row's last tile, rows
    -1 in no tile; config 2's shape of rows: 1, 31, 32, 33 and 200
    rays, one row of all rays, and every ray at row -1."""
    rng = np.random.default_rng(5)
    sizes = {"row_sizes": (1, 31, 32, 33, 200), "one_row": (300,),
             "no_row": ()}[case]
    rows = np.repeat(np.arange(-1, len(sizes)), (40, *sizes))
    rng.shuffle(rows)
    tile_rays, tile_row = group_by_slice(rows, 32)
    assert len(tile_rays) == 32 * len(tile_row)
    assert len(tile_row) == sum(-(-n // 32) for n in sizes)
    tiles = tile_rays.reshape(-1, 32)
    assert np.all(np.diff(tile_row) >= 0)
    for r, n in enumerate(sizes):
        mine = tiles[tile_row == r]
        assert len(mine) == -(-n // 32)
        got = mine.reshape(-1)
        assert np.array_equal(got[:n], np.flatnonzero(rows == r))
        assert np.all(got[n:] == -1)
    assert int((tile_rays < 0).sum()) == sum(32 * -(-n // 32) - n
                                             for n in sizes)
    assert not np.isin(np.flatnonzero(rows < 0), tile_rays).any()


def test_wrappers_cpu_take_the_plain_versions():
    """On CPU tensors the wrappers run the plain versions on the Philox
    stream of their seed, and count no kernel launch."""
    _, _, (_, _, _, packs) = _packs(8, 8, 40)
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    rows = np.arange(n_rays) % 3 - 1
    tv = torch.as_tensor(np.random.default_rng(1).integers(0, n_vrls, (2, 7)),
                         dtype=torch.int32)
    tw = torch.ones((2, 7))
    before = (vrl_r.launches, vrl_sum_clustered.launches)
    r = vrl_r(*packs, seed=6)
    s = vrl_sum_clustered(*packs, rows, tv, tw, seed=6)
    assert (vrl_r.launches, vrl_sum_clustered.launches) == before
    assert torch.equal(r, vrl_r_reference(*packs, philox_uniforms(
        6, n_rays, n_vrls, 6)))
    u = philox_table_uniforms(6, rows, tv, 6)
    assert u.shape == (n_rays, 7, 6) and not u[rows < 0].any()
    assert torch.equal(s, vrl_sum_clustered_reference(*packs, rows, tv, tw, u))
    assert not s[:, rows < 0].any() and float(s.abs().sum()) > 0.0


@pytest.mark.parametrize("bad", ["ids_int64", "weights_shape", "rows_length",
                                 "row_range", "strided", "uniforms_shape"])
def test_clustered_wrapper_rejects_bad_input(bad):
    _, _, (_, _, _, packs) = _packs(4, 4, 40)
    n_rays = packs[0].shape[1]
    rows = np.zeros(n_rays, np.int64)
    tv = torch.zeros((2, 6), dtype=torch.int32)
    tw = torch.ones((2, 6))
    kw = {}
    if bad == "ids_int64":
        tv = tv.long()
    elif bad == "weights_shape":
        tw = torch.ones((2, 5))
    elif bad == "rows_length":
        rows = rows[:-1]
    elif bad == "row_range":
        rows[3] = 2
    elif bad == "strided":
        tw = torch.ones((6, 2)).T
    else:
        kw["uniforms"] = torch.zeros((n_rays, 40, 6))
    with pytest.raises((TypeError, ValueError)):
        vrl_sum_clustered(*packs, rows, tv, tw, **kw)


def test_r_wrapper_rejects_bad_uniforms():
    _, _, (_, _, _, packs) = _packs(4, 4, 40)
    with pytest.raises(ValueError):
        vrl_r(*packs, uniforms=torch.zeros((16, 39, 6)))
