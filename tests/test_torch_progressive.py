"""The multi-pass drivers of alvrl_tpu_torch (integrators.progressive and
alvrl.render_alvrl_progressive) and the pieces they brought: each pass
against the single-pass function on its generator, resume, the pass
dumps, the pipelined clustered passes against render_alvrl pass after
pass, compact_device
against compact, the NULL BSDF sample and the jittered eye rays against
alvrl_tpu, and the averaged image statistically against alvrl_tpu's
render_progressive (its XLA route). All on the CPU, at 16x16 or less."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvrl_tpu.bsdf import api as jbsdf
from alvrl_tpu.core import rng as jrng
from alvrl_tpu.integrators import progressive as jprogressive
from alvrl_tpu.integrators.vrl import alvrl as jalvrl
from alvrl_tpu.integrators.vrl import integrator as jintegrator
from alvrl_tpu.integrators.vrl import tracer as jtracer
from alvrl_tpu.integrators.vrl import vrl as jvrl
from alvrl_tpu.integrators.vrl.integrate import VRLConfig as JVRLConfig
from alvrl_tpu.scene import loader as jloader
from alvrl_tpu.sensors import perspective as jperspective
from alvrl_tpu_torch.bsdf import api as bsdf
from alvrl_tpu_torch.integrators import progressive
from alvrl_tpu_torch.integrators.vrl import alvrl, vrl
from alvrl_tpu_torch.integrators.vrl import cluster as cl
from alvrl_tpu_torch.integrators.vrl import tracer
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.integrators.vrl.integrator import render_with_vrls_kernel
from alvrl_tpu_torch.integrators.vrl.tracer import TracerConfig
from alvrl_tpu_torch.integrators.vrl.vrl import VRLs
from alvrl_tpu_torch.scene import loader, presets
from alvrl_tpu_torch.sensors import perspective
from alvrl_tpu_torch.ops.vrl_sum import homog_bar
from tests.torch_port_utils import CPU, jax_tracer_uniforms

torch.set_num_threads(1)

SEED = 5
TRACER = TracerConfig(max_depth=5)
PARAMS = alvrl.ALVRLParams(vrl_target_num=48, num_particles=12,
                           cluster=cl.ClusterParams(
                               target_num_slices=8,
                               target_pixel_undersampling=4.0))
# the pass-dump file name of the JAX package's render_progressive
DUMP_NAME = re.compile(
    r"^pass_p(\d{3})_wall\d\.\d{3}e[+-]\d{2}_renvrl(\d\.\d{4}e[+-]\d{2})"
    r"\.npy$")


def _scene(kind="homogeneous", size=12):
    if kind == "grid":
        return presets.cornell_grid_smoke(size, size, grid_res=6, device=CPU)
    return presets.cornell_smoke(size, size, device=CPU)


def _serial(scene, n, clustered, tracer_cfg=TRACER, prog=None):
    """The mean of n passes of the single-pass function on each pass's
    generator (render_pass, or alvrl.render_alvrl for a clustered
    pass), summed in pass order, and the per-pass means."""
    slice_info = alvrl.build_slice_info(scene, PARAMS) if clustered else None
    acc, means = None, []
    for k in range(n):
        gen = alvrl.pass_generator(SEED, k)
        if clustered:
            img = alvrl.render_alvrl(scene, gen, PARAMS, tracer_cfg=tracer_cfg,
                                     slice_info=slice_info)[0]
        else:
            img = progressive.render_pass(scene, gen, prog, PARAMS,
                                          tracer_cfg=tracer_cfg)[0]
        img = img.numpy()
        means.append(float(img.mean()))
        acc = img if acc is None else acc + img
    return acc / n, means


@pytest.mark.parametrize("clustered", [False, True])
def test_each_pass_is_the_single_pass_function(clustered):
    """render_progressive's mean is the mean of the single-pass function
    on each pass's generator, bit for bit (the passes' sum in pass
    order): the clustered passes' pipelined schedule changes nothing."""
    scene = _scene()
    prog = progressive.ProgressiveConfig(max_passes=3, clustered=clustered)
    out = progressive.render_progressive(scene, SEED, prog, PARAMS,
                                         tracer_cfg=TRACER)
    ref, means = _serial(scene, 3, clustered, prog=prog)
    assert out.dtype == np.float32 and out.shape == (12, 12, 3)
    assert np.array_equal(out, ref)
    assert len(set(means)) == 3 and min(means) > 0  # passes differ


def test_antialias_jitters_the_eye_rays():
    scene = _scene()
    a, b = (progressive.render_progressive(
        scene, SEED, progressive.ProgressiveConfig(max_passes=1,
                                                   antialias=aa),
        PARAMS, tracer_cfg=TRACER) for aa in (False, True))
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert not np.array_equal(a, b)


def test_resume_equals_one_run_and_dump_names(tmp_path):
    scene = _scene()

    def run(n, ck, dump_dir):
        return progressive.render_progressive(
            scene, SEED, progressive.ProgressiveConfig(
                max_passes=n, checkpoint_path=str(ck), dump_passes=True,
                dump_dir=str(dump_dir)), PARAMS, tracer_cfg=TRACER)

    one = run(4, tmp_path / "one.npz", tmp_path / "one")
    run(2, tmp_path / "two.npz", tmp_path / "two")
    resumed = run(4, tmp_path / "two.npz", tmp_path / "two")
    assert np.array_equal(one, resumed)
    names = sorted(os.listdir(tmp_path / "one"))
    assert len(names) == 4
    matches = [DUMP_NAME.match(n) for n in names]
    assert all(matches), names
    assert [int(m.group(1)) for m in matches] == [0, 1, 2, 3]
    # the cumulative VRL evaluations grow; the last dump is the image
    evals = [float(m.group(2)) for m in matches]
    assert evals == sorted(evals) and evals[0] > 0
    last = np.load(tmp_path / "one" / names[-1])
    assert np.array_equal(last, one)


@pytest.mark.parametrize("kind", ["homogeneous", "grid"])
def test_pipelined_driver_equals_serial(kind):
    """render_alvrl_progressive and render_progressive(clustered=True),
    both through the pipelined schedule, against render_alvrl pass after
    pass, bit for bit."""
    scene = _scene(kind, size=8 if kind == "grid" else 12)
    tracer_cfg = TracerConfig(max_depth=4) if kind == "grid" else TRACER
    serial, _ = _serial(scene, 3, True, tracer_cfg)
    driver = progressive.render_progressive(
        scene, SEED, progressive.ProgressiveConfig(max_passes=3,
                                                   clustered=True),
        PARAMS, tracer_cfg=tracer_cfg)
    timings = {}
    piped, vrls, info = alvrl.render_alvrl_progressive(
        scene, 3, SEED, PARAMS, tracer_cfg=tracer_cfg, timings=timings)
    assert np.array_equal(serial, driver)
    assert np.array_equal(serial, piped.numpy())
    assert vrls.capacity == PARAMS.vrl_target_num
    assert info.slice_vrls.shape[0] == len(info.slice_weights)
    assert set(timings) == {"slice", "device_enqueue", "transfer", "cluster",
                            "wall"}
    assert timings["wall"] >= timings["cluster"] > 0


def test_both_drivers_raise_below_one_particle():
    scene = _scene()
    params = alvrl.ALVRLParams(vrl_target_num=1, num_particles=12,
                               cluster=PARAMS.cluster)
    for run in (lambda: progressive.render_progressive(
            scene, SEED, progressive.ProgressiveConfig(
                max_passes=1, clustered=True), params, tracer_cfg=TRACER),
                lambda: alvrl.render_alvrl_progressive(
                    scene, 1, SEED, params, tracer_cfg=TRACER)):
        with pytest.raises(ValueError, match="smaller than one particle"):
            run()


def _vrls(valid, seed):
    rng = np.random.default_rng(seed)
    n = len(valid)

    def f32(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32))

    return VRLs(start=f32(n, 3), end=f32(n, 3), power=f32(n, 3),
                valid=torch.as_tensor(valid),
                particle_count=torch.tensor(float(n // 4)))


def _same(a, b):
    for k in ("start", "end", "power", "valid", "particle_count"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        if x.dtype == torch.float32:  # bit for bit, signed zeros included
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), k


@pytest.mark.parametrize("case", ["overfull", "underfull", "empty",
                                  "exact"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_device_equals_compact(case, seed):
    rng = np.random.default_rng(seed)
    spp, n_particles = 4, 24
    valid = rng.random(n_particles * spp) < 0.6
    if case == "empty":
        valid[:] = False
    capacity = {"overfull": int(valid.sum()) // 2 + 1,
                "underfull": int(valid.sum()) + 7, "empty": 16,
                "exact": int(valid.sum())}[case]
    v = _vrls(valid, seed)
    out, too_small = vrl.compact_device(v, capacity, spp)
    assert not bool(too_small)
    _same(out, vrl.compact(v, capacity, slots_per_particle=spp))
    if case == "overfull":
        assert float(out.particle_count) < n_particles


def test_compact_device_flags_a_capacity_below_one_particle():
    valid = np.ones(16, bool)
    v = _vrls(valid, 3)
    with pytest.raises(ValueError, match="smaller than one particle"):
        vrl.compact(v, 3, slots_per_particle=4)
    out, too_small = vrl.compact_device(v, 3, 4)
    assert bool(too_small) and not bool(out.valid.any())
    with pytest.raises(ValueError, match="smaller than one particle"):
        vrl.raise_if_too_small(too_small)


def test_null_sample_matches_jax():
    """NULL passes the ray on with weight 1, DIFFUSE samples the cosine
    lobe; both against alvrl_tpu's sample_from_uniforms (importance)."""
    desc = {"camera": {"origin": [0, 0, -1], "target": [0, 0, 0]},
            "materials": [{"name": "w", "type": "diffuse",
                           "albedo": [0.7, 0.5, 0.3]},
                          {"name": "n", "type": "null"}],
            "shapes": [{"type": "cube", "material": "n"}],
            "emitters": [{"type": "point", "position": [0, 0, 0]}]}
    rng = np.random.default_rng(7)
    n = 64
    u = rng.random((n, bsdf.N_SAMPLE_DIMS)).astype(np.float32)
    mat = rng.integers(0, 2, n).astype(np.int32)
    ng = rng.normal(size=(n, 3)).astype(np.float32)
    ng /= np.linalg.norm(ng, axis=1, keepdims=True)
    d_in = rng.normal(size=(n, 3)).astype(np.float32)
    d_in /= np.linalg.norm(d_in, axis=1, keepdims=True)
    ref = jbsdf.sample_from_uniforms(
        jloader.build_scene(desc), jnp.asarray(u), jnp.asarray(mat),
        jnp.asarray(ng), jnp.asarray(ng), jnp.asarray(d_in),
        jnp.zeros((n, 3)), mode="importance")
    out = bsdf.sample_from_uniforms(
        loader.build_scene(desc, device=CPU), torch.as_tensor(u),
        torch.as_tensor(mat).long(), torch.as_tensor(ng),
        torch.as_tensor(ng), torch.as_tensor(d_in), mode="importance")
    null = mat == 1
    assert np.asarray(ref.valid).all()
    assert np.array_equal(out.wo.numpy()[null], np.asarray(ref.wo)[null])
    assert np.array_equal(out.weight.numpy()[null],
                          np.asarray(ref.weight)[null])
    assert (out.weight.numpy()[null] == 1.0).all()
    np.testing.assert_allclose(out.wo.numpy(), np.asarray(ref.wo),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(out.weight.numpy(), np.asarray(ref.weight))


def test_sample_ray_jitter_matches_jax():
    scene = presets.cornell_smoke(16, 12, device=CPU)
    jscene = jloader.load_json({"camera": {
        "origin": [0, 0, -0.99], "target": [0, 0, 1], "fov": 90,
        "width": 16, "height": 12}, "shapes": [{"type": "cube"}],
        "emitters": [{"type": "point", "position": [0, 0, 0]}]})
    rng = np.random.default_rng(8)
    px = rng.integers(0, 16, 200)
    py = rng.integers(0, 12, 200)
    jitter = rng.random((200, 2)).astype(np.float32)
    o, d = perspective.sample_ray(scene.camera, torch.as_tensor(px),
                                  torch.as_tensor(py),
                                  torch.as_tensor(jitter))
    jo, jd = jperspective.sample_ray(jscene.camera, jnp.asarray(px),
                                     jnp.asarray(py), jitter=jnp.asarray(
                                         jitter))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-7, rtol=0)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6, rtol=0)


# the statistical hold: a JSON scene through both loaders and both
# drivers' unclustered route, STAT_PASSES passes each
STAT_SCENE = {
    "camera": {"type": "perspective", "origin": [0, 0, -0.99],
               "target": [0, 0, 1], "fov": 90, "width": 8, "height": 8},
    "medium": {"type": "homogeneous", "sigma_s": [0.6] * 3,
               "sigma_a": [0.05] * 3, "g": 0.3},
    "materials": [{"name": "white", "type": "diffuse",
                   "albedo": [0.7, 0.7, 0.7]}],
    "shapes": [{"type": "cube", "material": "white", "flip_normals": True}],
    "emitters": [{"type": "point", "position": [0, 0.8, 0],
                  "intensity": [5, 5, 5]}],
}
STAT_PASSES = 16
STAT_PARAMS = dict(vrl_target_num=64, num_particles=16)
STAT_DEPTH = 6


def _pass_means(dump_dir):
    """The per-pass image means, from the dumps of the running mean."""
    names = sorted(os.listdir(dump_dir))
    running = [float(np.load(os.path.join(dump_dir, n)).astype(
        np.float64).mean()) for n in names]
    return np.array([(p + 1) * m - p * (running[p - 1] if p else 0.0)
                     for p, m in enumerate(running)])


@pytest.mark.parametrize("antialias", [False, True])
def test_image_matches_jax_statistically(tmp_path, antialias):
    """The mean of the averaged image against alvrl_tpu's
    render_progressive (XLA route) on the same JSON scene: the ratio of
    the two means lies within 3 standard errors (from the per-pass
    spread of both sides) of 1, and within 0.9-1.1. Measured on this
    test's seeds: the per-pass means spread by 9-10 % (standard
    deviation over mean) in the port and 20 % in the JAX package, the
    ratio 0.945-0.951 with a standard error of 0.053; over 48 passes
    (antialias off) 16 % and 20 %, the ratio 0.957, about one standard
    error of 0.037 below 1. The next test holds the pass itself, on
    the same random numbers."""
    ours_dir, ref_dir = tmp_path / "ours", tmp_path / "ref"
    progressive.render_progressive(
        loader.load_json(STAT_SCENE, device=CPU), 11,
        progressive.ProgressiveConfig(max_passes=STAT_PASSES,
                                      antialias=antialias, dump_passes=True,
                                      dump_dir=str(ours_dir)),
        alvrl.ALVRLParams(**STAT_PARAMS), VRLConfig(),
        TracerConfig(max_depth=STAT_DEPTH))
    jprogressive.render_progressive(
        jloader.load_json(STAT_SCENE), jax.random.key(11),
        jprogressive.ProgressiveConfig(max_passes=STAT_PASSES,
                                       antialias=antialias, dump_passes=True,
                                       dump_dir=str(ref_dir)),
        jalvrl.ALVRLParams(**STAT_PARAMS),
        tracer_cfg=jtracer.TracerConfig(max_depth=STAT_DEPTH))
    ours, ref = _pass_means(ours_dir), _pass_means(ref_dir)
    assert len(ours) == len(ref) == STAT_PASSES
    ratio = ours.mean() / ref.mean()
    root_n = np.sqrt(STAT_PASSES)
    se = ratio * np.hypot(ours.std(ddof=1) / root_n / ours.mean(),
                          ref.std(ddof=1) / root_n / ref.mean())
    assert abs(ratio - 1.0) < 3.0 * se, (ratio, se)
    assert 0.9 < ratio < 1.1, ratio


@pytest.mark.parametrize("antialias", [False, True])
def test_pass_matches_jax_pass_on_its_random_numbers(antialias):
    """Pass 0 of the statistical hold's render on the JAX package's own
    random numbers, pixel by pixel: alvrl_tpu's render_progressive pass
    (fold(key, 0) split into the tracer's and the render's keys, trace,
    compact, render_with_vrls with or without antialias) against the
    port's pass on the same uniforms (tracer.trace_u on the rebuilt
    tracer uniforms, compact, render_with_vrls_kernel with the XLA
    route's per-pair uniforms and sub-pixel jitter). The VRLs agree to
    float32 rounding, the image within the homogeneous bar (measured:
    median relative error 1.9e-7 without antialias and 1.6e-7 with it,
    no pixel over 1e-2). So the two passes are one function of their
    random numbers, and the statistical hold's ratio can differ from 1
    only by the two random streams' noise."""
    jscene = jloader.load_json(STAT_SCENE)
    scene = loader.load_json(STAT_SCENE, device=CPU)
    n_particles = STAT_PARAMS["num_particles"]
    capacity = STAT_PARAMS["vrl_target_num"]
    k_t, k_r = jax.random.split(jrng.fold(jax.random.key(11), 0))
    jv = jvrl.compact(jtracer.trace(jscene, k_t, n_particles,
                                    jtracer.TracerConfig(
                                        max_depth=STAT_DEPTH)),
                      capacity, slots_per_particle=STAT_DEPTH)
    ref = np.asarray(jintegrator.render_with_vrls(
        jscene, jv, k_r, JVRLConfig(), antialias=antialias))

    u_emit, u_walk = jax_tracer_uniforms(k_t, n_particles, STAT_DEPTH)
    vrls = vrl.compact(tracer.trace_u(
        scene, torch.as_tensor(np.array(u_emit)),
        torch.as_tensor(np.array(u_walk)),
        TracerConfig(max_depth=STAT_DEPTH)), capacity,
        slots_per_particle=STAT_DEPTH)
    assert torch.equal(vrls.valid, torch.as_tensor(np.asarray(jv.valid)))
    assert float(vrls.particle_count) == float(jv.particle_count)
    for k in ("start", "end", "power"):
        np.testing.assert_allclose(getattr(vrls, k).numpy(),
                                   np.asarray(getattr(jv, k)), rtol=1e-5,
                                   atol=1e-5)
    # the XLA route's random numbers at this size: one tile of
    # ray_tile = 2048 rays (row offset 0) and one chunk of vrl_chunk =
    # 128 VRLs, each drawn whole and cut to the frame and the buffer
    n_rays = STAT_SCENE["camera"]["width"] * STAT_SCENE["camera"]["height"]
    cfg = JVRLConfig()
    key = jrng.fold(jrng.fold(k_r, 0, jrng.P_PIXEL), 0)
    u_vv, u_vs = jintegrator._chunk_uniforms(
        key, 0, (2048, cfg.vrl_chunk, cfg.vol_vol_samples, 2),
        (2048, cfg.vrl_chunk, cfg.vol_surf_samples))
    u = np.concatenate([
        np.asarray(u_vv)[:n_rays, :capacity].reshape(n_rays, capacity, -1),
        np.asarray(u_vs)[:n_rays, :capacity]], axis=-1)
    jitter = None
    if antialias:
        jitter = torch.as_tensor(np.asarray(jrng.uniform(
            jrng.fold(k_r, jrng.P_PIXEL, 1), (n_rays, 2))))
    img = render_with_vrls_kernel(scene, vrls, torch.Generator(), VRLConfig(),
                                  uniforms=torch.as_tensor(u), jitter=jitter)
    assert float(np.abs(ref).max()) > 0
    median, share = homog_bar(img, torch.as_tensor(ref))
    assert median < 1e-5 and share < 0.02, (median, share)
