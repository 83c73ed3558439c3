"""alvrl_tpu_torch.ops.vrl_sum against alvrl_tpu.

The plain version of the render kernel is held against the JAX
integrand (pair_contribution) and against the Pallas kernel, run in
interpret mode, with the same uniforms fed to both; the Philox stream
against the Random123 known answers; the wrapper's input checks. The
kernel itself runs only on a CUDA card: see tests/test_torch_cuda.py.
"""

import inspect
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from alvrl_tpu.integrators.vrl import integrator as jintegrator
from alvrl_tpu.integrators.vrl import vrl as jvrl
from alvrl_tpu.integrators.vrl.integrate import VRLConfig as JVRLConfig
from alvrl_tpu.integrators.vrl.integrate import pair_contribution
from alvrl_tpu.media import api as mapi
from alvrl_tpu.ops import vrl_pallas as vp
from alvrl_tpu.scene import presets as jpresets
from alvrl_tpu.sensors import perspective as jperspective
import alvrl_tpu_torch
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.integrators.vrl import integrator, vrl
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops.vrl_sum import (
    HOMOG_MEDIAN,
    HOMOG_SHARE,
    homog_bar,
    philox4x32_10,
    philox_uniforms,
    vrl_sum,
    vrl_sum_hetero,
    vrl_sum_reference,
)
from alvrl_tpu_torch.ops.vrl_sum_bwd import vrl_sum_hetero_bwd, vrl_sum_hetero_diff
from tests.torch_port_utils import (
    BENCH_VRLS,
    SEQ_UNIFORMS,
    hit_from_jax,
    in_child,
    jax_scene_leaves,
    jax_vrls_leaves,
)

torch.set_num_threads(1)

# (g, phase kind): isotropic, forward-scattering HG, Rayleigh
MEDIA = {"hg_g0": (0.0, 0), "hg_g06": (0.6, 0), "rayleigh": (0.0, 1)}
# medium and short_vrls of the pair_contribution cases: without the
# short-VRL pdfFailure division ("long") for both phase functions too
PAIR_CASES = {**{k: (k, True) for k in MEDIA},
              "hg_g0_long": ("hg_g0", False),
              "rayleigh_long": ("rayleigh", False)}


def _jax_scene(width, height, g, phase_kind):
    scene = jpresets.cornell_smoke(width=width, height=height)
    med = scene.medium.replace(g=jnp.float32(g), phase_kind=phase_kind)
    return scene.replace(medium=med)


def _assert_bar(out, ref):
    median, share = homog_bar(out, ref)
    assert median < HOMOG_MEDIAN, (median, share)
    assert share < HOMOG_SHARE, (median, share)


def _packs(jscene, ray_o, ray_d, jhit, jvrls):
    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device="cpu")
    mat = torch.as_tensor(np.asarray(jhit.mat), dtype=torch.int64)
    rays = pk.pack_rays(scene, torch.as_tensor(np.asarray(ray_o)),
                        torch.as_tensor(np.asarray(ray_d)), hit_from_jax(jhit),
                        mat)
    vrls = convert.vrls_from_numpy(jax_vrls_leaves(jvrls), device="cpu")
    return rays, pk.pack_vrls(vrls), pk.pack_tris(scene), pk.pack_medium(scene)


@pytest.mark.parametrize("medium", sorted(PAIR_CASES))
def test_reference_matches_pair_contribution(medium):
    """Plain version vs the JAX integrand, per-pair random uniforms,
    8 rays x 128 VRLs (a few invalid), summed over the VRLs."""
    medium, short_vrls = PAIR_CASES[medium]
    g, kind = MEDIA[medium]
    rng = np.random.default_rng(7)
    jscene = mapi.prepare_scene(_jax_scene(16, 16, g, kind))
    px = jnp.asarray(rng.integers(0, 16, 8))
    py = jnp.asarray(rng.integers(0, 16, 8))
    ray_o, ray_d = jperspective.sample_ray(jscene.camera, px, py)
    jhit = jintegrator.trace_eye_rays(jscene, ray_o, ray_d)
    full = jvrl.load_ascii(BENCH_VRLS, particle_count=78.0)
    valid = np.ones(128, bool)
    valid[::17] = False
    jvrls = full.replace(start=full.start[:128], end=full.end[:128],
                         power=full.power[:128], valid=jnp.asarray(valid))
    u = rng.random((8, 128, 6), dtype=np.float32)

    expand = lambda a: a[:, None] if a.ndim == 1 else a[:, None, :]
    total, _, _ = pair_contribution(
        jscene, expand(ray_o), expand(ray_d), expand(jhit.p),
        expand(jhit.valid), expand(jhit.ng), expand(jhit.mat),
        jvrls.start[None], jvrls.end[None], jvrls.power[None],
        jvrls.valid[None], jnp.asarray(u[..., :4].reshape(8, 128, 2, 2)),
        jnp.asarray(u[..., 4:]), JVRLConfig(short_vrls=short_vrls))
    ref = torch.as_tensor(np.asarray(jnp.sum(total, axis=1)))

    rays, vrls, tris, med = _packs(jscene, ray_o, ray_d, jhit, jvrls)
    out = vrl_sum_reference(rays, vrls, tris, med, torch.as_tensor(u),
                            short_vrls=short_vrls, phase_kind=kind)
    assert float(ref.abs().sum()) > 0.0
    _assert_bar(out.T, ref)


def _interpret_render():
    """render_with_vrls_pallas in interpret mode on cornell_smoke 16x16
    with all 508 bench VRLs, the Pallas kernel's _u01 returning the next
    SEQ_UNIFORMS constant at each call while traced (jit caches cleared
    around the patch): (image, _u01 calls). Run by in_child."""
    counter = {"i": 0}

    def mock(shape):
        v = SEQ_UNIFORMS[counter["i"] % len(SEQ_UNIFORMS)]
        counter["i"] += 1
        return jnp.full(shape, v, jnp.float32)

    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp, \
            pltpu.force_tpu_interpret_mode():
        mp.setattr(vp, "_u01", mock)
        img = np.asarray(jintegrator.render_with_vrls_pallas(
            jpresets.cornell_smoke(width=16, height=16), _bench_jvrls(),
            jax.random.key(1), JVRLConfig()))
    jax.clear_caches()
    return img, counter["i"]


def _bench_jvrls():
    return jvrl.compact(jvrl.load_ascii(BENCH_VRLS, particle_count=78.0),
                        512)


def test_plain_slice_matches_pallas_interpret():
    """The whole plain slice (cornell_smoke 16x16, all 508 bench VRLs)
    vs render_with_vrls_pallas in interpret mode (run in a child process:
    tests/torch_port_utils.py in_child), both drawing the same per-draw
    constants."""
    jscene = jpresets.cornell_smoke(width=16, height=16)
    jvrls = _bench_jvrls()
    ref, n_draws = in_child(_interpret_render)
    assert n_draws == len(SEQ_UNIFORMS)

    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device="cpu")
    vrls = convert.vrls_from_numpy(jax_vrls_leaves(jvrls), device="cpu")
    u = torch.tensor(SEQ_UNIFORMS).expand(256, 512, 6).contiguous()
    img = integrator.render_with_vrls_kernel(
        scene, vrls, torch.Generator().manual_seed(0), VRLConfig(),
        uniforms=u)
    assert img.shape == (16, 16, 3)
    assert float(img.mean()) > 0.0
    _assert_bar(img, torch.as_tensor(ref))


def _u32(words):
    return torch.tensor([int(w, 16) for w in words.split()],
                        dtype=torch.int64)


@pytest.mark.parametrize("ctr, key, expected", [
    ("0 0 0 0", "0 0", "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ("ffffffff ffffffff ffffffff ffffffff", "ffffffff ffffffff",
     "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ("243f6a88 85a308d3 13198a2e 03707344", "a4093822 299f31d0",
     "d16cfe09 94fdcceb 5001e420 24126ea1"),
])
def test_philox_known_answers(ctr, key, expected):
    """Random123's known-answer vectors for Philox4x32-10."""
    out = philox4x32_10(_u32(ctr), tuple(_u32(key).tolist()))
    assert out.tolist() == _u32(expected).tolist()


def test_philox_uniforms_layout():
    """Draw d of pair (b, n) is word d % 4 of the call with counter
    (b, n, d // 4, 0) under key (seed, 0), as (bits >> 8) * 2^-24."""
    seed, n_rays, n_vrls, n_draws = 12345, 5, 7, 6
    u = philox_uniforms(seed, n_rays, n_vrls, n_draws)
    assert u.shape == (n_rays, n_vrls, n_draws) and u.dtype == torch.float32
    for b, n, d in [(0, 0, 0), (4, 6, 5), (2, 3, 4), (1, 5, 3)]:
        bits = philox4x32_10(torch.tensor([b, n, d // 4, 0]), (seed, 0))
        assert float(u[b, n, d]) == (int(bits[d % 4]) >> 8) * 2.0 ** -24
    zero = philox_uniforms(0, 1, 1, 4)[0, 0]
    kat = _u32("6627e8d5 e169c58d bc57ac4c 9b00dbd8")
    assert zero.tolist() == ((kat >> 8).double() * 2.0 ** -24).tolist()
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0


def _small_packs(n_rays=4, n_vrls=3):
    scene = convert.scene_from_numpy(
        jax_scene_leaves(jpresets.cornell_smoke(width=2, height=2)),
        device="cpu")
    rng = np.random.default_rng(0)
    vrls = vrl.VRLs(
        start=torch.as_tensor(rng.uniform(-0.9, 0.9, (n_vrls, 3)),
                              dtype=torch.float32),
        end=torch.as_tensor(rng.uniform(-0.9, 0.9, (n_vrls, 3)),
                            dtype=torch.float32),
        power=torch.ones((n_vrls, 3)),
        valid=torch.ones((n_vrls,), dtype=torch.bool),
        particle_count=torch.tensor(1.0))
    rays = torch.zeros((pk.RAY_ROWS, n_rays))
    return rays, pk.pack_vrls(vrls), pk.pack_tris(scene), pk.pack_medium(scene)


def test_wrapper_cpu_takes_the_plain_version():
    """On CPU tensors the wrapper runs vrl_sum_reference on the Philox
    stream of its seed, and counts no kernel launch."""
    scene = convert.scene_from_numpy(
        jax_scene_leaves(jpresets.cornell_smoke(width=4, height=4)),
        device="cpu")
    vrls = vrl.compact(vrl.load_ascii(BENCH_VRLS, particle_count=78.0,
                                      device="cpu"))
    packs = integrator.pack_frame(scene, vrls)[3]
    before = vrl_sum.launches
    out = vrl_sum(*packs, seed=99)
    ref = vrl_sum_reference(*packs, philox_uniforms(99, 16, vrls.capacity, 6))
    assert torch.equal(out, ref)
    assert vrl_sum.launches == before
    assert torch.isfinite(out).all() and float(out.sum()) > 0.0


def test_grid_kernels_are_compiled_for_the_default_uv_steps():
    """The grid sum and its VJP have an instantiation compiled for
    UV_STEPS U-V steps (csrc/vrl_common.cuh) and a slower generic one for
    any other count. Every caller passes VRLConfig().uv_tau_steps and the
    grid wrappers default to it, so all three agree (on the card the
    library's alvrl_uv_steps() is held to it as well)."""
    src = (Path(alvrl_tpu_torch.__file__).parent / "csrc"
           / "vrl_common.cuh").read_text()
    (compiled,) = re.findall(r"constexpr int UV_STEPS = (\d+);", src)
    steps = VRLConfig().uv_tau_steps
    assert int(compiled) == steps
    for fn in (vrl_sum_hetero, vrl_sum_hetero_bwd, vrl_sum_hetero_diff):
        assert inspect.signature(fn).parameters["uv_steps"].default == steps


BAD_INPUTS = {
    "rays_float64": lambda r, v, t, m: dict(rays=r.double()),
    "rays_rows": lambda r, v, t, m: dict(rays=r[:-1].contiguous()),
    "rays_strided": lambda r, v, t, m: dict(rays=r.T.contiguous().T),
    "vrls_rows": lambda r, v, t, m: dict(vrls=torch.zeros((9, 3))),
    "tris_cols": lambda r, v, t, m: dict(tris=torch.zeros((4, 8))),
    "medium_len": lambda r, v, t, m: dict(medium=torch.zeros(7)),
    "uniforms_shape": lambda r, v, t, m: dict(uniforms=torch.zeros(4, 3, 5)),
    "uniforms_int": lambda r, v, t, m: dict(
        uniforms=torch.zeros((4, 3, 6), dtype=torch.int32)),
    "rays_numpy": lambda r, v, t, m: dict(rays=r.numpy()),
    "phase_kind": lambda r, v, t, m: dict(phase_kind=2),
    "samples": lambda r, v, t, m: dict(vol_vol_samples=-1),
    "seed": lambda r, v, t, m: dict(seed=2**32),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_wrapper_rejects_bad_inputs(case):
    rays, vrls, tris, med = _small_packs()
    args = dict(rays=rays, vrls=vrls, tris=tris, medium=med)
    args.update(BAD_INPUTS[case](rays, vrls, tris, med))
    kw = {k: args.pop(k) for k in list(args)
          if k not in ("rays", "vrls", "tris", "medium")}
    with pytest.raises((TypeError, ValueError)):
        vrl_sum(args["rays"], args["vrls"], args["tris"], args["medium"], **kw)
