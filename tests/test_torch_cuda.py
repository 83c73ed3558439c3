"""The CUDA kernels of alvrl_tpu_torch against their plain PyTorch
versions: the VRL sum (csrc/vrl_sum.cu), its VJP (csrc/vrl_sum_bwd.cu),
the transfer matrix R (csrc/vrl_r.cu), the clustered sum
(csrc/vrl_sum_clustered.cu) and its VJP (csrc/vrl_sum_clustered_bwd.cu),
in a homogeneous and in a grid medium; the BVH-occlusion sum
(csrc/vrl_sum_bvh.cu) and the gather probes (csrc/probe_gather.cu); the
VRL sum on the specular chains' rays, which start on surfaces; the
material instantiations of kernels 1, 2 and 5 on glossy and layered
surfaces; their mixture-phase (PHASE = 2) and sampling-strategy forms,
and the dispatch's refusal of a phase kind it has no form for; the
material forms of the grid kernels 3, 4 and 6 (nearest and trilinear)
and of kernel 7, and kernel 7's mixture and strategy forms; the textured
forms of kernels 1, 2 and 5 on cornell_textured's textured, normal-
mapped, bump-mapped and HK surfaces, and of kernels 3, 4 and 6 on that
box in a grid medium (nearest and trilinear) and of kernel 7 on the cube
field with its surfaces (presets.textured_cube_field).

These tests need a CUDA card (the kernels have no CPU mode) and skip
without one. They import no jax; tests/conftest.py does, so on a host
without jax run them without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from alvrl_tpu_torch.core.spectrum import LUM_WEIGHTS
from alvrl_tpu_torch.geometry import bvh, intersect
from alvrl_tpu_torch.integrators.vrl import alvrl, integrator, tracer, vrl
from alvrl_tpu_torch.integrators.vrl import cluster as cl
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops import vrl_sum as vs
from alvrl_tpu_torch.ops import vrl_sum_bvh as vb
from alvrl_tpu_torch.ops import vrl_sum_clustered as vsc
from alvrl_tpu_torch.ops import vrl_sum_clustered_bwd as cbwd
from alvrl_tpu_torch.ops.vrl_r import (
    vrl_r,
    vrl_r_check,
    vrl_r_hetero,
    vrl_r_hetero_check,
    vrl_r_hetero_reference,
    vrl_r_reference,
)
from alvrl_tpu_torch.ops.vrl_sum import (
    HOMOG_MEDIAN,
    HOMOG_SHARE,
    compiled_uv_steps,
    homog_bar,
    homog_bar_by_kind,
    occupancy,
    philox_uniforms,
    vrl_sum,
    vrl_sum_hetero,
    vrl_sum_hetero_reference,
    vrl_sum_reference,
)
from alvrl_tpu_torch.ops.vrl_sum_bwd import (
    vrl_sum_bwd,
    vrl_sum_bwd_reference,
    vrl_sum_hetero_bwd,
    vrl_sum_hetero_bwd_reference,
)
from alvrl_tpu_torch.ops.vrl_sum_clustered import (
    philox_table_uniforms,
    vrl_sum_clustered,
    vrl_sum_clustered_check,
    vrl_sum_clustered_reference,
    vrl_sum_hetero_clustered,
    vrl_sum_hetero_clustered_check,
    vrl_sum_hetero_clustered_reference,
)
from alvrl_tpu_torch.ops.vrl_sum_clustered_bwd import (
    vrl_sum_clustered_bwd,
    vrl_sum_clustered_bwd_reference,
    vrl_sum_hetero_clustered_bwd,
    vrl_sum_hetero_clustered_bwd_reference,
)
from alvrl_tpu_torch.parallel.render import PARAMS, train_step
from alvrl_tpu_torch.scene import presets
from alvrl_tpu_torch.scripts import bench_bvh_large as bbl
from alvrl_tpu_torch.sensors import perspective
from alvrl_tpu_torch.scripts import probe_gather as probe
from torch_port_utils import chain_bvh_pack  # tests/ is on the path

BENCH_VRLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "bench_vrls.txt")

# (g, phase kind): isotropic, forward-scattering HG, Rayleigh
MEDIA = {"hg_g0": (0.0, 0), "hg_g06": (0.6, 0), "rayleigh": (0.0, 1)}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _scene(device, width, height, g=0.0, phase_kind=0):
    scene = presets.cornell_smoke(width, height, g=g, device=device)
    return replace(scene, medium=replace(scene.medium, phase_kind=phase_kind))


def _bench_vrls(device):
    return vrl.compact(vrl.load_ascii(BENCH_VRLS, particle_count=78.0,
                                      device=device), 512)


@pytest.mark.parametrize("medium", sorted(MEDIA))
@pytest.mark.parametrize("injected", [True, False], ids=["injected", "philox"])
@pytest.mark.parametrize("short_vrls", [True, False], ids=["short", "long"])
def test_cuda_kernel_matches_plain(cuda, medium, injected, short_vrls):
    """Kernel vs plain version, 32x32 eye rays x 512 VRLs, with injected
    uniforms or the kernel's own Philox stream, with and without the
    short-VRL pdfFailure division."""
    g, kind = MEDIA[medium]
    packs = integrator.pack_frame(_scene(cuda, 32, 32, g, kind),
                                  _bench_vrls(cuda))[3]
    n_rays = packs[0].shape[1]
    if injected:
        u = torch.as_tensor(np.random.default_rng(3).random(
            (n_rays, 512, 6), dtype=np.float32), device=cuda)
    else:
        u = philox_uniforms(4321, n_rays, 512, 6, device=cuda)
    before = vrl_sum.launches
    out = vrl_sum(*packs, seed=4321, uniforms=u if injected else None,
                  short_vrls=short_vrls, phase_kind=kind)
    torch.cuda.synchronize()
    assert vrl_sum.launches == before + 1
    ref = vrl_sum_reference(*packs, u, short_vrls=short_vrls, phase_kind=kind)
    assert torch.isfinite(out).all() and float(out.abs().sum()) > 0.0
    median, share = homog_bar(out.T, ref.T)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


def test_cuda_kernel_is_deterministic(cuda):
    packs = integrator.pack_frame(_scene(cuda, 16, 16), _bench_vrls(cuda))[3]
    assert torch.equal(vrl_sum(*packs, seed=5), vrl_sum(*packs, seed=5))
    assert not torch.equal(vrl_sum(*packs, seed=5), vrl_sum(*packs, seed=6))


def test_cuda_render_counts_launches(cuda):
    scene = _scene(cuda, 16, 16)
    before = vrl_sum.launches
    img = integrator.render_with_vrls_kernel(
        scene, _bench_vrls(cuda), torch.Generator().manual_seed(0))
    assert vrl_sum.launches == before + 1
    assert img.shape == (16, 16, 3) and torch.isfinite(img).all()
    assert float(img.mean()) > 0.0


def test_cuda_rejects_too_many_triangles(cuda):
    packs = list(integrator.pack_frame(_scene(cuda, 4, 4),
                                       _bench_vrls(cuda))[3])
    packs[2] = torch.zeros((100000, 9), device=cuda)
    with pytest.raises(ValueError):
        vrl_sum(*packs)


# --- kernel 1's triangle paths and plane pre-reject -------------------------


def _close(out, ref, tol=1e-4):
    """Every ray within tol relative (separate compilations of one
    estimator, whose fused multiply-adds may differ), and the
    homogeneous bar."""
    rel = (out - ref).abs() / torch.clamp(ref.abs(), min=1e-3)
    assert float(rel.max()) < tol
    median, share = homog_bar(out.T, ref.T)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


@pytest.mark.parametrize("medium", sorted(MEDIA))
@pytest.mark.parametrize("mode", [vs.MODE_SUM, vs.MODE_NO_REJECT],
                         ids=["pre_reject", "no_pre_reject"])
def test_cuda_kernel_sweeps_match_plain(cuda, medium, mode):
    """Kernel 1's sweep with the plane pre-reject and without it (its
    timing mode), 32x32 eye rays x 512 VRLs (24 triangles), injected
    uniforms: both against the plain version."""
    g, kind = MEDIA[medium]
    packs = integrator.pack_frame(_scene(cuda, 32, 32, g, kind),
                                  _bench_vrls(cuda))[3]
    n_rays = packs[0].shape[1]
    u = torch.as_tensor(np.random.default_rng(6).random(
        (n_rays, 512, 6), dtype=np.float32), device=cuda)
    out = vs._launch(vs._library(), *packs, u, 0, 2, 2, True, kind,
                     mode=mode)
    ref = vrl_sum_reference(*packs, u, phase_kind=kind)
    assert torch.isfinite(out).all() and float(out.abs().sum()) > 0.0
    median, share = homog_bar(out.T, ref.T)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    _close(out, vrl_sum(*packs, uniforms=u, phase_kind=kind))


def _cube_packs(device, width=16):
    """A 4^3 cube field (780 triangles, 49 KB of plane pack: above the
    default cap of dynamic shared memory) with its bench VRLs."""
    scene = bbl.scene_of("cubes", 4, width=width, device=device)
    return integrator.pack_frame(scene, bbl.bench_vrls(scene))[3]


def test_cuda_kernel_with_780_triangles(cuda):
    """780 triangles, whose plane pack takes more shared memory than the
    default cap: the launch meets the plain version and repeats bit for
    bit."""
    packs = _cube_packs(cuda)
    assert packs[2].shape[0] * 64 > 48 * 1024
    out = vrl_sum(*packs, seed=9)
    ref = vrl_sum_reference(*packs, philox_uniforms(
        9, packs[0].shape[1], packs[1].shape[1], 6, device=cuda))
    median, share = homog_bar(out.T, ref.T)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    assert torch.equal(out, vrl_sum(*packs, seed=9))


def _check_packs(device, case):
    """(packs, seed) of kernel 1's checking launch: cornell_smoke 32x32
    with the bench VRLs, the 780-triangle cube field, or a train step's
    own VRLs and render seed (64x64, 32 particles x depth 6)."""
    if case == "cornell":
        return integrator.pack_frame(_scene(device, 32, 32),
                                     _bench_vrls(device))[3], 17
    if case == "cubes":
        return _cube_packs(device), 17
    scene = _scene(device, 64, 64)
    g = torch.Generator().manual_seed(3)
    vrls = tracer.trace(scene, g, 32, tracer.TracerConfig(max_depth=6))
    return integrator.pack_frame(scene, vrls)[3], integrator.draw_seed(g)


@pytest.mark.parametrize("case", ["cornell", "cubes", "train_step"])
def test_cuda_pre_reject_agrees_with_the_wald_test(cuda, case):
    """The checking instantiation on every segment of a launch: no
    triangle the pre-reject skips blocks, no segment is decided
    differently, most triangle tests are skipped, and the sums are the
    kernel's."""
    packs, seed = _check_packs(cuda, case)
    before = (vrl_sum.launches, vs.vrl_sum_check.launches)
    out, counts = vs.vrl_sum_check(*packs, seed=seed)
    assert (vrl_sum.launches, vs.vrl_sum_check.launches) == (
        before[0], before[1] + 1)
    assert counts["bad_tris"] == 0 and counts["bad_segments"] == 0, counts
    assert counts["considered"] >= counts["segments"] > 0
    assert counts["considered"] > counts["skipped"] > 0
    _close(out, vrl_sum(*packs, seed=seed))


def test_cuda_plane_pack_kernel_matches_plain(cuda):
    """The plane pack that kernel 1 makes on the card is plane_pack's:
    n, the margin's coefficients and the triangle equal, off to a
    float32 rounding (both sum three exact products in float64)."""
    tris = _cube_packs(cuda)[2]
    got = vs.plane_pack_kernel(tris).cpu()
    ref = vs.plane_pack(tris.cpu())
    keep = [i for i in range(16) if i != 3]
    assert torch.equal(got[:, keep], ref[:, keep])
    assert torch.allclose(got[:, 3], ref[:, 3], rtol=2 ** -23, atol=0.0)


# --- the backward kernel -----------------------------------------------------

PAR_RTOL = 1e-3  # d_par: sums of the same terms in another order


def _ragged_packs(device, g, kind):
    """20x13 = 260 eye rays (not a multiple of the kernel's 128-ray
    blocks) x 77 VRLs (not a multiple of its 32-VRL chunks), 7 invalid."""
    vrls = _bench_vrls(device)
    valid = vrls.valid[:77].clone()
    valid[3::11] = False
    vrls = replace(vrls, start=vrls.start[:77], end=vrls.end[:77],
                   power=vrls.power[:77], valid=valid)
    return integrator.pack_frame(_scene(device, 20, 13, g, kind), vrls)[3]


def _assert_bwd_close(out, ref, kind):
    d_power, d_par, d_tau = out
    r_power, r_par, r_tau = ref
    for o, r in ((d_power, r_power), (d_tau, r_tau)):
        assert torch.isfinite(o).all() and float(o.abs().sum()) > 0.0
        median, share = homog_bar(o.T, r.T)
        assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    assert float(d_par[7]) == 0.0
    if kind == 1:
        assert float(d_par[6]) == 0.0 and float(r_par[6]) == 0.0
    for i in range(7 if kind == 0 else 6):
        d, r = float(d_par[i]), float(r_par[i])
        # exactly 0 where every term carries a zero factor (a zero channel)
        assert d == 0.0 if r == 0.0 else abs(d - r) < PAR_RTOL * abs(r), \
            (i, d, r)


@pytest.mark.parametrize("medium", sorted(MEDIA))
@pytest.mark.parametrize("injected", [True, False], ids=["injected", "philox"])
@pytest.mark.parametrize("short_vrls", [True, False], ids=["short", "long"])
def test_cuda_bwd_kernel_matches_plain(cuda, medium, injected, short_vrls):
    """Backward kernel vs plain backward (autograd through the plain
    forward) on ragged shapes, for every template: d_power and d_tau at
    the homogeneous bar, d_par to PAR_RTOL, Rayleigh's d g exactly 0."""
    g, kind = MEDIA[medium]
    packs = _ragged_packs(cuda, g, kind)
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    gbar = torch.as_tensor(np.random.default_rng(5).uniform(
        0.5, 1.5, (3, n_rays)).astype(np.float32), device=cuda)
    if injected:
        u = torch.as_tensor(np.random.default_rng(6).random(
            (n_rays, n_vrls, 6), dtype=np.float32), device=cuda)
    else:
        u = philox_uniforms(97, n_rays, n_vrls, 6, device=cuda)
    before = vrl_sum_bwd.launches
    out = vrl_sum_bwd(*packs, gbar, seed=97, uniforms=u if injected else None,
                      short_vrls=short_vrls, phase_kind=kind)
    torch.cuda.synchronize()
    assert vrl_sum_bwd.launches == before + 1
    ref = vrl_sum_bwd_reference(*packs, gbar, u, short_vrls=short_vrls,
                                phase_kind=kind)
    _assert_bwd_close(out, ref, kind)


@pytest.mark.parametrize("n_tris", [0, 1, 24, 33, 780])
def test_cuda_bwd_kernel_triangle_counts(cuda, n_tris):
    """The backward kernel sweeps the triangles' plane pack with kernel
    1's pre-reject, 32 triangles a mask: against the plain backward with
    none, one, 24, 33 (a second, one-triangle mask) and all 780 of the
    cube field's triangles (a plane pack above the default cap of
    dynamic shared memory)."""
    rays, vrls, tris, med = _cube_packs(cuda)
    tris = tris[:n_tris].contiguous()
    n_rays, n_vrls = rays.shape[1], vrls.shape[1]
    gbar = torch.as_tensor(np.random.default_rng(4).uniform(
        0.5, 1.5, (3, n_rays)).astype(np.float32), device=cuda)
    out = vrl_sum_bwd(rays, vrls, tris, med, gbar, seed=19)
    ref = vrl_sum_bwd_reference(rays, vrls, tris, med, gbar, philox_uniforms(
        19, n_rays, n_vrls, 6, device=cuda))
    _assert_bwd_close(out, ref, 0)


def test_cuda_bwd_kernel_zero_channels(cuda):
    """ROADMAP C7: with VRL power channel 1 and sigma_s channel 2 at 0,
    the kernel's d power[1] and d sigma_s[2] are not 0 and match the
    plain backward."""
    rays, vrls, tris, med = _ragged_packs(cuda, 0.4, 0)
    vrls = vrls.clone()
    vrls[pk.VP + 1] = 0.0
    med = med.clone()
    med[2] -= med[5]  # sigma_t = sigma_a
    med[5] = 0.0
    gbar = torch.ones((3, rays.shape[1]), device=cuda)
    out = vrl_sum_bwd(rays, vrls, tris, med, gbar, seed=3)
    ref = vrl_sum_bwd_reference(
        rays, vrls, tris, med, gbar,
        philox_uniforms(3, rays.shape[1], vrls.shape[1], 6, device=cuda))
    _assert_bwd_close(out, ref, 0)
    assert float(out[0][1].abs().max()) > 0.0 and float(out[1][5]) != 0.0


def test_cuda_bwd_kernel_is_deterministic(cuda):
    packs = _ragged_packs(cuda, 0.6, 0)
    gbar = torch.ones((3, packs[0].shape[1]), device=cuda)
    a, b = vrl_sum_bwd(*packs, gbar, seed=5), vrl_sum_bwd(*packs, gbar, seed=5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_cuda_train_step_launches_both_kernels(cuda):
    scene = presets.cornell_smoke(16, 16, device=cuda)
    target = torch.zeros((16, 16, 3), device=cuda)
    fwd, bwd = vrl_sum.launches, vrl_sum_bwd.launches
    loss, grads = train_step(scene, torch.Generator().manual_seed(0), target,
                             VRLConfig(), 8, tracer.TracerConfig(max_depth=4))
    assert vrl_sum.launches == fwd + 1 and vrl_sum_bwd.launches == bwd + 1
    assert float(loss) > 0.0
    for k in PARAMS:
        assert grads[k].is_cuda and torch.isfinite(grads[k]).all(), k


# --- the R kernel and the clustered kernel -----------------------------------

# the variance of the mean is a difference of two sums of squares: its
# bar (tests/test_hetero_pallas.py:227), where the plain value is above
# the floor
R_VAR_MEDIAN, R_VAR_FLOOR = 1e-4, 1e-12


def _uniforms(device, injected, seed, shape):
    if injected:
        return torch.as_tensor(np.random.default_rng(seed).random(
            shape, dtype=np.float32), device=device)
    return None


@pytest.mark.parametrize("medium", sorted(MEDIA))
@pytest.mark.parametrize("injected", [True, False], ids=["injected", "philox"])
@pytest.mark.parametrize("short_vrls", [True, False], ids=["short", "long"])
def test_cuda_r_kernel_matches_plain(cuda, medium, injected, short_vrls):
    """R kernel vs plain version on the ragged 260 x 77 shapes, for every
    template: the mean at the homogeneous bar (per entry), the variance
    of the mean at R_VAR_MEDIAN."""
    g, kind = MEDIA[medium]
    packs = _ragged_packs(cuda, g, kind)
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    u = _uniforms(cuda, injected, 8, (n_rays, n_vrls, 6))
    before = vrl_r.launches
    out = vrl_r(*packs, seed=55, uniforms=u, short_vrls=short_vrls,
                phase_kind=kind)
    torch.cuda.synchronize()
    assert vrl_r.launches == before + 1
    if u is None:
        u = philox_uniforms(55, n_rays, n_vrls, 6, device=cuda)
    ref = vrl_r_reference(*packs, u, short_vrls=short_vrls, phase_kind=kind)
    assert out.shape == (2, n_rays, n_vrls) and torch.isfinite(out).all()
    median, share = homog_bar(out[0], ref[0], channels=1)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    nz = ref[1] > R_VAR_FLOOR
    assert int(nz.sum()) > 100
    rel = (out[1] - ref[1]).abs()[nz] / ref[1][nz]
    assert float(rel.median()) < R_VAR_MEDIAN


def test_cuda_r_row_sums_are_vrl_sum_luminance(cuda):
    """sum_n mean[p, n] of the R kernel is the luminance of the vrl_sum
    kernel's out[:, p] on the same rays and seed."""
    packs = _ragged_packs(cuda, 0.0, 0)
    out = vrl_r(*packs, seed=9)
    lum = sum(w * c for w, c in zip(LUM_WEIGHTS, vrl_sum(*packs, seed=9)))
    median, share = homog_bar(out[0].sum(dim=1), lum, channels=1)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


# --- kernel 5's tiles and plane pre-reject ----------------------------------


@pytest.mark.parametrize("n_vrls", [1, 33, 512])
@pytest.mark.parametrize("n_rays", [1, 3, 17, 271])
def test_cuda_r_kernel_on_ragged_shapes(cuda, n_rays, n_vrls):
    """Kernel 5 with fewer rays than a tile, ray counts that are not a
    multiple of it (271: config 2's representatives), fewer VRLs than a
    chunk, one past a chunk and config 2's 512: R's mean at the
    homogeneous bar, its variance at R_VAR_MEDIAN, the pairs of an
    invalid ray or VRL written as 0, a repeat bit-identical; its checking
    launch (counted on its own entry) finds no skipped blocker and no
    segment decided otherwise, and its mean is the kernel's to 1e-4."""
    packs = integrator.pack_frame(_scene(cuda, 32, 32), _bench_vrls(cuda))[3]
    packs = (packs[0][:, 101:101 + n_rays].contiguous(),
             packs[1][:, :n_vrls].contiguous(), *packs[2:])
    out = vrl_r(*packs, seed=61)
    ref = vrl_r_reference(*packs, philox_uniforms(61, n_rays, n_vrls, 6,
                                                  device=cuda))
    assert out.shape == (2, n_rays, n_vrls) and torch.isfinite(out).all()
    median, share = homog_bar(out[0], ref[0], channels=1)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    nz = ref[1] > R_VAR_FLOOR
    if int(nz.sum()) > 0:
        assert float(((out[1] - ref[1]).abs()[nz] / ref[1][nz]).median()) \
            < R_VAR_MEDIAN
    idle = ~((packs[0][pk.VALID] > 0.5)[:, None]
             & (packs[1][pk.VVALID] > 0.5)[None])
    assert not out[:, idle].any()
    assert torch.equal(out, vrl_r(*packs, seed=61))
    before = (vrl_r.launches, vrl_r_check.launches)
    chk, counts = vrl_r_check(*packs, seed=61)
    assert (vrl_r.launches, vrl_r_check.launches) == (before[0],
                                                      before[1] + 1)
    assert counts["bad_tris"] == 0 and counts["bad_segments"] == 0, counts
    assert counts["considered"] >= counts["skipped"]
    rel = (chk[0] - out[0]).abs() / torch.clamp(out[0].abs(), min=1e-3)
    assert float(rel.max()) < 1e-4


def test_cuda_r_pre_reject_with_780_triangles(cuda):
    """Kernel 5's checking launch on the cube field (a plane pack above
    the default cap of dynamic shared memory): no skipped blocker, no
    segment decided otherwise, some tests skipped; the kernel meets its
    plain version there."""
    packs = _cube_packs(cuda)
    packs = (packs[0][:, :90].contiguous(), *packs[1:])
    out = vrl_r(*packs, seed=23)
    _, counts = vrl_r_check(*packs, seed=23)
    assert counts["bad_tris"] == 0 and counts["bad_segments"] == 0, counts
    assert counts["considered"] >= counts["segments"] > 0
    assert counts["considered"] > counts["skipped"] > 0
    ref = vrl_r_reference(*packs, philox_uniforms(
        23, packs[0].shape[1], packs[1].shape[1], 6, device=cuda))
    median, share = homog_bar(out[0], ref[0], channels=1)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


def _tables(device, n_rays, n_vrls, n_rows=5, n_cols=45):
    """Random tables of n_cols columns (not a multiple of the kernel's
    32-VRL pieces), ids partly out of range, some weights 0, and ray rows
    in [-1, n_rows)."""
    rng = np.random.default_rng(4)
    ids = torch.as_tensor(rng.integers(-2, n_vrls + 3, (n_rows, n_cols)),
                          dtype=torch.int32, device=device)
    ws = rng.uniform(0.2, 2.0, (n_rows, n_cols)).astype(np.float32)
    ws[rng.random((n_rows, n_cols)) < 0.1] = 0.0
    return (rng.integers(-1, n_rows, n_rays), ids,
            torch.as_tensor(ws, device=device))


@pytest.mark.parametrize("medium", sorted(MEDIA))
@pytest.mark.parametrize("injected", [True, False], ids=["injected", "philox"])
@pytest.mark.parametrize("short_vrls", [True, False], ids=["short", "long"])
def test_cuda_clustered_kernel_matches_plain(cuda, medium, injected,
                                             short_vrls):
    """Clustered kernel vs plain version on the ragged 260 x 77 shapes
    with 45-column tables, for every template: the homogeneous bar;
    rays at row -1 sum to 0."""
    g, kind = MEDIA[medium]
    packs = _ragged_packs(cuda, g, kind)
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    rows, ids, ws = _tables(cuda, n_rays, n_vrls)
    u = _uniforms(cuda, injected, 9, (n_rays, ids.shape[1], 6))
    before = vrl_sum_clustered.launches
    out = vrl_sum_clustered(*packs, rows, ids, ws, seed=31, uniforms=u,
                            short_vrls=short_vrls, phase_kind=kind)
    torch.cuda.synchronize()
    assert vrl_sum_clustered.launches == before + 1
    if u is None:
        u = philox_table_uniforms(31, rows, ids, 6)
    ref = vrl_sum_clustered_reference(*packs, rows, ids, ws, u,
                                      short_vrls=short_vrls, phase_kind=kind)
    assert torch.isfinite(out).all() and float(out.abs().sum()) > 0.0
    assert not out[:, torch.as_tensor(rows < 0, device=cuda)].any()
    median, share = homog_bar(out.T, ref.T)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


def test_cuda_clustered_identity_table_is_vrl_sum(cuda):
    """One row of all 77 VRLs at weight 1 (three 32-VRL pieces) gives the
    vrl_sum kernel's result on the same rays and seed."""
    packs = _ragged_packs(cuda, 0.6, 0)
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    ids = torch.arange(n_vrls, dtype=torch.int32, device=cuda)[None]
    out = vrl_sum_clustered(*packs, np.zeros(n_rays, np.int64), ids,
                            torch.ones((1, n_vrls), device=cuda), seed=13)
    median, share = homog_bar(out.T, vrl_sum(*packs, seed=13).T)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


def test_cuda_clustered_kernel_is_deterministic(cuda):
    packs = _ragged_packs(cuda, 0.0, 1)
    rows, ids, ws = _tables(cuda, packs[0].shape[1], packs[1].shape[1])
    a = vrl_sum_clustered(*packs, rows, ids, ws, seed=5)
    assert torch.equal(a, vrl_sum_clustered(*packs, rows, ids, ws, seed=5))
    assert not torch.equal(a, vrl_sum_clustered(*packs, rows, ids, ws,
                                                 seed=6))


def test_cuda_render_alvrl_launches_both_kernels(cuda):
    scene = presets.cornell_smoke(16, 16, device=cuda)
    params = alvrl.ALVRLParams(
        vrl_target_num=128, num_particles=16,
        cluster=cl.ClusterParams(target_num_slices=8,
                                 target_pixel_undersampling=8.0))
    r, c = vrl_r.launches, vrl_sum_clustered.launches
    img, vrls, info = alvrl.render_alvrl(
        scene, torch.Generator().manual_seed(0), params, VRLConfig(),
        tracer.TracerConfig(max_depth=8))
    # a second clustered launch where pixels fall back (a centre ray
    # through a crack between two triangles hits nothing)
    fallback = alvrl.fallback_table(info, cuda) is not None
    assert vrl_r.launches == r + 1
    assert vrl_sum_clustered.launches == c + 1 + fallback
    assert img.is_cuda and img.shape == (16, 16, 3)
    assert torch.isfinite(img).all() and float(img.mean()) > 0.0


# --- kernel 2's tiles and plane pre-reject ----------------------------------


def _clustered_launch(packs, rows, ids, ws, seed, grid=None, **kw):
    """A bare launch of the clustered kernel on tiles grouped at its own
    ray count (grid = (density, uv_steps) for kernel 4), Philox stream."""
    dev = packs[0].device
    tiles = [torch.as_tensor(a, device=dev) for a in
             vsc.group_by_slice(rows, vsc.ray_block(grid is not None))]
    out = torch.zeros((3, packs[0].shape[1]), device=dev)
    vsc._launch(vsc._library(), *packs[:4], *tiles, ids, ws, None, seed, 2,
                2, True, 0, out, grid, **kw)
    return out


@pytest.mark.parametrize("n_tris", [24, 780])
def test_cuda_clustered_kernel_over_row_sizes(cuda, n_tris):
    """Kernel 2 on rows of 1, 31, 32, 33 and 200 rays (one ray short of,
    at and one past its 32-ray tile, and a row over seven tiles) and rays
    at row -1, with config 1's 24 triangles or the cube field's 780 (a
    plane pack above the default cap of dynamic shared memory): against
    its plain version at the homogeneous bar, rays at row -1 zero; its
    checking launch (counted on its own entry) finds no skipped blocker
    and no segment decided otherwise, and it, the launch without the
    plane pre-reject and a repeat are bit-identical to the kernel."""
    packs = integrator.pack_frame(_scene(cuda, 20, 20, 0.6, 0),
                                  _bench_vrls(cuda))[3]
    if n_tris == 780:
        packs = (*packs[:2], _cube_packs(cuda)[2], packs[3])
    n_rays, n_vrls = packs[0].shape[1], 77
    packs = (packs[0], packs[1][:, :n_vrls].contiguous(), *packs[2:])
    rng = np.random.default_rng(9)
    sizes = (1, 31, 32, 33, 200)
    rows = np.repeat(np.arange(-1, len(sizes)),
                     (n_rays - sum(sizes), *sizes))
    rng.shuffle(rows)
    _, ids, ws = _tables(cuda, n_rays, n_vrls, n_rows=len(sizes))
    assert vsc.ray_block(False) == 32
    assert len(vsc.group_by_slice(rows, 32)[1]) == sum(-(-n // 32)
                                                       for n in sizes)
    out = vrl_sum_clustered(*packs, rows, ids, ws, seed=29)
    ref = vrl_sum_clustered_reference(
        *packs, rows, ids, ws, philox_table_uniforms(29, rows, ids, 6))
    assert torch.isfinite(out).all() and float(out.abs().sum()) > 0.0
    assert not out[:, torch.as_tensor(rows < 0, device=cuda)].any()
    median, share = homog_bar(out.T, ref.T)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    before = (vrl_sum_clustered.launches, vrl_sum_clustered_check.launches)
    chk, counts = vrl_sum_clustered_check(*packs, rows, ids, ws, seed=29)
    assert (vrl_sum_clustered.launches, vrl_sum_clustered_check.launches) \
        == (before[0], before[1] + 1)
    assert counts["bad_tris"] == 0 and counts["bad_segments"] == 0, counts
    assert counts["considered"] >= counts["segments"] > 0
    assert counts["considered"] >= counts["skipped"] > 0
    for other in (chk, _clustered_launch(packs, rows, ids, ws, 29,
                                         mode=vs.MODE_NO_REJECT),
                  vrl_sum_clustered(*packs, rows, ids, ws, seed=29)):
        assert torch.equal(out, other)


@pytest.mark.parametrize("n_cols", [1, 3, 33, 70])
def test_cuda_clustered_kernel_table_widths(cuda, n_cols):
    """Kernel 2 with tables of one column, fewer columns than the block's
    warps, one more than a staged piece of VRL_CHUNK and over three
    pieces, with injected uniforms indexed by ray and table column (a
    column that a warp took from the wrong piece or slot would read
    another column's) and with the Philox stream: its plain version's
    homogeneous bar, rays at row -1 zero, a repeat bit-identical."""
    packs = _ragged_packs(cuda, 0.6, 0)
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    rows, ids, ws = _tables(cuda, n_rays, n_vrls, n_cols=n_cols)
    for u in (_uniforms(cuda, True, 17, (n_rays, n_cols, 6)), None):
        out = vrl_sum_clustered(*packs, rows, ids, ws, seed=43, uniforms=u)
        ref = vrl_sum_clustered_reference(
            *packs, rows, ids, ws,
            philox_table_uniforms(43, rows, ids, 6) if u is None else u)
        assert torch.isfinite(out).all() and float(out.abs().sum()) > 0.0
        assert not out[:, torch.as_tensor(rows < 0, device=cuda)].any()
        median, share = homog_bar(out.T, ref.T)
        assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
        assert torch.equal(out, vrl_sum_clustered(*packs, rows, ids, ws,
                                                  seed=43, uniforms=u))


def test_cuda_clustered_kernel_fallback_and_identity_tables(cuda):
    """Kernel 2 on the one-row tables of a clustered pass against vrl_sum
    on the same samples: the identity table (the 512 bench VRLs at weight
    1, sixteen staged pieces) on 32x32 rays with the Philox stream, and a
    table of the fall-back set's shape (300 distinct VRL ids at weight 1,
    ten pieces) on the 10 % of the rays that fall back, the others at row
    -1 and zero, with injected uniforms taken by VRL id for vrl_sum on
    those 300 VRLs."""
    packs = integrator.pack_frame(_scene(cuda, 32, 32), _bench_vrls(cuda))[3]
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    ids = torch.arange(n_vrls, dtype=torch.int32, device=cuda)[None]
    out = vrl_sum_clustered(*packs, np.zeros(n_rays, np.int64), ids,
                            torch.ones((1, n_vrls), device=cuda), seed=13)
    median, share = homog_bar(out.T, vrl_sum(*packs, seed=13).T)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    rng = np.random.default_rng(21)
    keep = torch.as_tensor(np.sort(rng.permutation(n_vrls)[:300]),
                           device=cuda)
    rows = np.where(rng.random(n_rays) < 0.1, 0, -1)
    u = torch.as_tensor(rng.random((n_rays, 300, 6), dtype=np.float32),
                        device=cuda)
    fb = vrl_sum_clustered(*packs, rows, keep.to(torch.int32)[None],
                           torch.ones((1, 300), device=cuda), uniforms=u)
    ref = vrl_sum(packs[0], packs[1][:, keep].contiguous(), *packs[2:],
                  uniforms=u)
    fell = torch.as_tensor(rows >= 0, device=cuda)
    assert int(fell.sum()) > 50 and not fb[:, ~fell].any()
    assert float(fb.abs().sum()) > 0.0
    median, share = homog_bar(fb[:, fell].T, ref[:, fell].T)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


def test_cuda_clustered_kernel_without_triangles(cuda):
    """Kernel 2 with no triangles (no plane pack, no sweep): its plain
    version's homogeneous bar; its checking launch counts segments but
    no triangle test, and is bit-identical to it."""
    packs = _ragged_packs(cuda, 0.0, 1)
    packs = (packs[0], packs[1], packs[2][:0].contiguous(), packs[3])
    rows, ids, ws = _tables(cuda, packs[0].shape[1], packs[1].shape[1])
    out = vrl_sum_clustered(*packs, rows, ids, ws, seed=47, phase_kind=1)
    ref = vrl_sum_clustered_reference(
        *packs, rows, ids, ws, philox_table_uniforms(47, rows, ids, 6),
        phase_kind=1)
    assert torch.isfinite(out).all() and float(out.abs().sum()) > 0.0
    median, share = homog_bar(out.T, ref.T)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    chk, counts = vrl_sum_clustered_check(*packs, rows, ids, ws, seed=47,
                                          phase_kind=1)
    assert counts["segments"] > 0 and counts["considered"] == 0, counts
    assert torch.equal(chk, out)


def test_cuda_clustered_kernels_keep_their_tiles(cuda):
    """Kernel 2 groups its rays in tiles of 32 and kernel 4 in tiles of
    128 (RAY_BLOCK, as before kernel 2's redesign): each wrapper's output
    is a bare launch's on its tiles, a launch on the other kernel's tiles
    is refused, and the occupancy query answers for both."""
    assert (vsc.ray_block(False), vsc.ray_block(True)) == (32, 128)
    for grid in (False, True):
        packs = _grid_packs(cuda) if grid else _ragged_packs(cuda, 0.6, 0)
        rows, ids, ws = _tables(cuda, packs[0].shape[1], packs[1].shape[1])
        arg = (packs[4], 4) if grid else None
        fn = vrl_sum_hetero_clustered if grid else vrl_sum_clustered
        assert torch.equal(fn(*packs, rows, ids, ws, seed=53),
                           _clustered_launch(packs, rows, ids, ws, 53, arg))
        other = [torch.as_tensor(a, device=cuda) for a in vsc.group_by_slice(
            rows, vsc.ray_block(not grid))]
        with pytest.raises(ValueError):
            vsc._launch(vsc._library(), *packs[:4], *other, ids, ws, None, 53,
                        2, 2, True, 0, torch.zeros((3, packs[0].shape[1]),
                                                   device=cuda), arg)
        assert occupancy("vrl_sum_clustered", grid, 24) >= 1


# --- the grid-medium kernels -------------------------------------------------


def _grid_packs(device, phase_kind=0, grid_res=8, fast_tau=True):
    """The ragged 20x13 eye rays x 77 VRLs (7 invalid) of _ragged_packs
    in cornell_grid_smoke (grid_res^3 grid): the grid packs and the
    supersampled density (with fast_tau False, the trilinear packs and
    the density itself)."""
    vrls = _bench_vrls(device)
    valid = vrls.valid[:77].clone()
    valid[3::11] = False
    vrls = replace(vrls, start=vrls.start[:77], end=vrls.end[:77],
                   power=vrls.power[:77], valid=valid)
    scene = presets.cornell_grid_smoke(20, 13, grid_res=grid_res,
                                       device=device)
    scene = replace(scene, medium=replace(scene.medium,
                                          phase_kind=phase_kind,
                                          fast_tau=fast_tau))
    return integrator.pack_frame(scene, vrls)[3]


def _grid_case(device, kernel, packs, injected, seed, short_vrls, kind):
    """(kernel output, plain output) of one grid kernel on `packs`, with
    injected uniforms or the Philox stream of `seed`."""
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    kw = dict(short_vrls=short_vrls, phase_kind=kind)
    if kernel == "clustered":
        rows, ids, ws = _tables(device, n_rays, n_vrls)
        u = _uniforms(device, injected, 10, (n_rays, ids.shape[1], 6))
        out = vrl_sum_hetero_clustered(*packs, rows, ids, ws, seed=seed,
                                       uniforms=u, **kw)
        if u is None:
            u = philox_table_uniforms(seed, rows, ids, 6)
        return out, vrl_sum_hetero_clustered_reference(*packs, rows, ids, ws,
                                                       u, **kw), rows
    u = _uniforms(device, injected, 11, (n_rays, n_vrls, 6))
    fn, ref = ((vrl_r_hetero, vrl_r_hetero_reference) if kernel == "r"
               else (vrl_sum_hetero, vrl_sum_hetero_reference))
    out = fn(*packs, seed=seed, uniforms=u, **kw)
    if u is None:
        u = philox_uniforms(seed, n_rays, n_vrls, 6, device=device)
    return out, ref(*packs, u, **kw), None


GRID_LAUNCHES = {"sum": vrl_sum_hetero, "r": vrl_r_hetero,
                 "clustered": vrl_sum_hetero_clustered}


@pytest.mark.parametrize("kernel", sorted(GRID_LAUNCHES))
@pytest.mark.parametrize("kind", [0, 1], ids=["hg", "rayleigh"])
@pytest.mark.parametrize("injected", [True, False], ids=["injected", "philox"])
@pytest.mark.parametrize("short_vrls", [True, False], ids=["short", "long"])
def test_cuda_grid_kernels_match_plain(cuda, kernel, kind, injected,
                                       short_vrls):
    """Each grid kernel vs its plain version on the ragged shapes, every
    template: the homogeneous bar (R's mean per entry, its variance of
    the mean to R_VAR_MEDIAN); the clustered sum's rows -1 sum to 0."""
    packs = _grid_packs(cuda, kind)
    before = GRID_LAUNCHES[kernel].launches
    out, ref, rows = _grid_case(cuda, kernel, packs, injected, 77,
                                short_vrls, kind)
    torch.cuda.synchronize()
    assert GRID_LAUNCHES[kernel].launches == before + 1
    assert torch.isfinite(out).all() and float(out.abs().sum()) > 0.0
    if kernel == "r":
        median, share = homog_bar(out[0], ref[0], channels=1)
        nz = ref[1] > R_VAR_FLOOR
        assert int(nz.sum()) > 100
        assert float(((out[1] - ref[1]).abs()[nz] / ref[1][nz]).median()) \
            < R_VAR_MEDIAN
    else:
        median, share = homog_bar(out.T, ref.T)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    if rows is not None:
        assert not out[:, torch.as_tensor(rows < 0, device=cuda)].any()


@pytest.mark.parametrize("kernel", sorted(GRID_LAUNCHES))
def test_cuda_grid_kernels_are_deterministic(cuda, kernel):
    packs = _grid_packs(cuda)
    a = _grid_case(cuda, kernel, packs, False, 5, True, 0)[0]
    b = _grid_case(cuda, kernel, packs, False, 5, True, 0)[0]
    c = _grid_case(cuda, kernel, packs, False, 6, True, 0)[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_cuda_grid_identity_table_is_vrl_sum_hetero(cuda):
    """One row of all 77 VRLs at weight 1 (their VRL-OD rows gathered by
    id) gives the grid sum kernel's result on the same rays and seed."""
    packs = _grid_packs(cuda)
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    ids = torch.arange(n_vrls, dtype=torch.int32, device=cuda)[None]
    out = vrl_sum_hetero_clustered(*packs, np.zeros(n_rays, np.int64), ids,
                                   torch.ones((1, n_vrls), device=cuda),
                                   seed=13)
    median, share = homog_bar(out.T, vrl_sum_hetero(*packs, seed=13).T)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


def test_cuda_grid_r_row_sums_are_vrl_sum_hetero_luminance(cuda):
    packs = _grid_packs(cuda)
    out = vrl_r_hetero(*packs, seed=9)
    lum = sum(w * c for w, c in zip(LUM_WEIGHTS, vrl_sum_hetero(*packs,
                                                                seed=9)))
    median, share = homog_bar(out[0].sum(dim=1), lum, channels=1)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


def test_cuda_render_alvrl_in_a_grid_launches_the_grid_kernels(cuda):
    scene = presets.cornell_grid_smoke(16, 16, grid_res=8, device=cuda)
    params = alvrl.ALVRLParams(
        vrl_target_num=128, num_particles=16,
        cluster=cl.ClusterParams(target_num_slices=8,
                                 target_pixel_undersampling=8.0))
    r, c = vrl_r_hetero.launches, vrl_sum_hetero_clustered.launches
    img, vrls, info = alvrl.render_alvrl(
        scene, torch.Generator().manual_seed(0), params, VRLConfig(),
        tracer.TracerConfig(max_depth=8))
    fallback = alvrl.fallback_table(info, cuda) is not None
    assert vrl_r_hetero.launches == r + 1
    assert vrl_sum_hetero_clustered.launches == c + 1 + fallback
    assert img.is_cuda and img.shape == (16, 16, 3)
    assert torch.isfinite(img).all() and float(img.mean()) > 0.0


# --- the trilinear forms of kernels 3, 4 and 6 (fast_tau=False) -----------


@pytest.mark.parametrize("kernel", sorted(GRID_LAUNCHES))
@pytest.mark.parametrize("kind", [0, 1], ids=["hg", "rayleigh"])
@pytest.mark.parametrize("injected", [True, False], ids=["injected", "philox"])
@pytest.mark.parametrize("short_vrls", [True, False], ids=["short", "long"])
def test_cuda_trilinear_grid_kernels_match_plain(cuda, kernel, kind,
                                                 injected, short_vrls):
    """Each grid kernel's trilinear form (the trilinear medium pack and the
    8^3 density itself) vs its plain version on the ragged shapes, every
    template, at the homogeneous bar; its launch counted on the wrapper
    and on its tri_launches."""
    packs = _grid_packs(cuda, kind, fast_tau=False)
    assert pk.is_trilinear(packs[3]) and tuple(packs[4].shape) == (8, 8, 8)
    fn = GRID_LAUNCHES[kernel]
    before = (fn.launches, fn.tri_launches)
    out, ref, rows = _grid_case(cuda, kernel, packs, injected, 78,
                                short_vrls, kind)
    torch.cuda.synchronize()
    assert (fn.launches, fn.tri_launches) == (before[0] + 1, before[1] + 1)
    assert torch.isfinite(out).all() and float(out.abs().sum()) > 0.0
    if kernel == "r":
        median, share = homog_bar(out[0], ref[0], channels=1)
        nz = ref[1] > R_VAR_FLOOR
        assert float(((out[1] - ref[1]).abs()[nz] / ref[1][nz]).median()) \
            < R_VAR_MEDIAN
    else:
        median, share = homog_bar(out.T, ref.T)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    if rows is not None:
        assert not out[:, torch.as_tensor(rows < 0, device=cuda)].any()


@pytest.mark.parametrize("kernel", sorted(GRID_LAUNCHES))
def test_cuda_trilinear_form_is_not_the_nearest(cuda, kernel):
    """The same rays, VRLs and seed through the nearest and the trilinear
    form give different sums (each form reads its own grid), and the
    trilinear form repeats bit for bit."""
    near = _grid_case(cuda, kernel, _grid_packs(cuda), False, 5, True, 0)[0]
    packs = _grid_packs(cuda, fast_tau=False)
    a = _grid_case(cuda, kernel, packs, False, 5, True, 0)[0]
    b = _grid_case(cuda, kernel, packs, False, 5, True, 0)[0]
    assert torch.equal(a, b) and not torch.equal(a, near)


TRI_CHECKS = {"clustered": (vrl_sum_hetero_clustered,
                             vrl_sum_hetero_clustered_check),
              "r": (vrl_r_hetero, vrl_r_hetero_check)}


@pytest.mark.parametrize("kernel", sorted(TRI_CHECKS))
def test_cuda_trilinear_pre_reject_agrees_with_the_wald_test(cuda, kernel):
    """The trilinear forms' checking instantiations (kernels 4 and 6): no
    skipped triangle blocks, no segment is decided differently (the
    pre-reject does not read the density), and the output is the
    trilinear kernel's."""
    packs = _grid_packs(cuda, fast_tau=False)
    fn, check_fn = TRI_CHECKS[kernel]
    args = packs
    if kernel == "clustered":
        args = (*packs, *_tables(cuda, packs[0].shape[1], packs[1].shape[1]))
    out, counts = check_fn(*args, seed=21)
    assert counts["bad_tris"] == 0 and counts["bad_segments"] == 0, counts
    assert counts["considered"] > counts["skipped"] > 0
    ref = fn(*args, seed=21)
    if kernel == "r":
        out, ref = out[0], ref[0]
    median, share = (homog_bar(out, ref, channels=1) if kernel == "r"
                     else homog_bar(out.T, ref.T))
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


def _rel_close(out, ref, tol):
    """Every output within tol of its plain twin, relative to the largest
    |plain| entry of that output."""
    for i, (o, r) in enumerate(zip(out, ref)):
        assert torch.isfinite(o).all(), i
        scale = float(r.abs().max())
        assert float((o - r).abs().max()) <= tol * max(scale, 1e-30), (
            i, float((o - r).abs().max()), scale)


def test_cuda_backward_grid_kernels_refuse_the_trilinear_pack(cuda):
    """Kernels 9 and 11 take a fast_tau=False medium in their trilinear
    forms: on the trilinear packs each matches its plain version (every
    output within 1e-3 of the largest entry of its plain twin), counts
    its launch on tri_launches, and the differentiable route takes it."""
    packs = _grid_packs(cuda, fast_tau=False)
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    gbar = torch.ones((3, n_rays), device=cuda)
    tables = _tables(cuda, n_rays, n_vrls)
    u = torch.rand((n_rays, n_vrls, 6), device=cuda,
                   generator=torch.Generator(cuda).manual_seed(9))
    uc = u[:, :tables[1].shape[1]].contiguous()
    before = (vrl_sum_hetero_bwd.tri_launches,
              cbwd.vrl_sum_hetero_clustered_bwd.tri_launches)
    out = vrl_sum_hetero_bwd(*packs, gbar, uniforms=u)
    ref = vrl_sum_hetero_bwd_reference(*packs, gbar, u)
    assert out[5].shape == packs[4].shape
    _rel_close(out, ref, 1e-3)
    out = cbwd.vrl_sum_hetero_clustered_bwd(*packs, *tables, gbar,
                                            uniforms=uc)
    ref = cbwd.vrl_sum_hetero_clustered_bwd_reference(*packs, *tables, gbar,
                                                      uc)
    _rel_close(out, ref, 1e-3)
    assert (vrl_sum_hetero_bwd.tri_launches,
            cbwd.vrl_sum_hetero_clustered_bwd.tri_launches) == (
                before[0] + 1, before[1] + 1)
    scene = presets.cornell_grid_smoke(8, 8, grid_res=8, device=cuda)
    scene = replace(scene, medium=replace(scene.medium, fast_tau=False))
    dens = scene.medium.density.clone().requires_grad_()
    from alvrl_tpu_torch.media import heterogeneous as gmed
    img = integrator.render_with_vrls_kernel_diff(
        replace(scene, medium=gmed.with_density(scene.medium, dens)),
        _bench_vrls(cuda), torch.Generator())
    (g,) = torch.autograd.grad(img.sum(), dens)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0.0
    assert vrl_sum_hetero_bwd.tri_launches == before[0] + 2


def _oriented_scene(device, kind, sampling=0):
    """cornell_grid_smoke 8x8 with an oriented medium over a uniform fiber
    field along y."""
    from alvrl_tpu_torch.media import heterogeneous as gmed

    scene = presets.cornell_grid_smoke(8, 8, grid_res=6, device=device)
    med = scene.medium
    orient = torch.zeros((6, 6, 6, 3), device=device)
    orient[..., 1] = 1.0
    return replace(scene, medium=gmed.make_grid_medium(
        med.density, med.sigma_t_color, med.albedo, box_min=med.box_min,
        box_max=med.box_max, phase_kind=kind, orientation=orient,
        sampling=sampling, device=device))


@pytest.mark.parametrize("kind", [2, 3], ids=["kkay", "microflake"])
def test_cuda_volpath_renders_oriented_media(cuda, kind):
    """volpath on the card in a Kajiya-Kay or micro-flake medium (the
    micro-flake one with Woodcock tracking of its directional
    extinction, the Kajiya-Kay one with the quadrature sampler): a
    finite, non-zero image."""
    from alvrl_tpu_torch.integrators import volpath

    img = volpath.render_volpath(
        _oriented_scene(cuda, kind, sampling=int(kind == 2)),
        torch.Generator(device=cuda).manual_seed(0), spp=2,
        cfg=volpath.VolpathConfig(max_depth=4, only_vrl_paths=False))
    assert img.is_cuda and torch.isfinite(img).all()
    assert float(img.mean()) > 0.0


def test_cuda_vrl_routes_refuse_oriented_media(cuda):
    """Only volpath renders an oriented medium, as in the JAX package: the
    VRL tracer and the kernel routes raise."""
    scene = _oriented_scene(cuda, 3)
    vrls = _bench_vrls(cuda)
    for call in (lambda: tracer.trace(scene, torch.Generator(), 4),
                 lambda: integrator.render_with_vrls_kernel(
                     scene, vrls, torch.Generator()),
                 lambda: integrator.build_R_kernel(
                     scene, *perspective.sample_ray(
                         scene.camera, torch.arange(4, device=cuda),
                         torch.zeros(4, dtype=torch.int64, device=cuda)),
                     vrls, 0)):
        with pytest.raises(ValueError, match="only volpath"):
            call()


# --- kernels 4 and 6: the plane pre-reject in a grid medium, R's tiles -------

GRID_CHECKS = {"clustered": (vrl_sum_hetero_clustered,
                             vrl_sum_hetero_clustered_check),
               "r": (vrl_r_hetero, vrl_r_hetero_check)}


def _grid_close(kernel, out, ref, tol=1e-4):
    """Two launches of one grid estimator (separate instantiations, whose
    fused multiply-adds may differ): every sum, or R's mean, within tol
    relative, and the homogeneous bar."""
    if kernel == "r":
        out, ref = out[0], ref[0]
    rel = (out - ref).abs() / torch.clamp(ref.abs(), min=1e-3)
    assert float(rel.max()) < tol
    median, share = (homog_bar(out, ref, channels=1) if kernel == "r"
                     else homog_bar(out.T, ref.T))
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


@pytest.mark.parametrize("kernel", sorted(GRID_CHECKS))
@pytest.mark.parametrize("case", ["walls", "cubes"])
def test_cuda_grid_pre_reject_agrees_with_the_wald_test(cuda, kernel, case):
    """Kernel 4's and kernel 6's checking instantiations on every shadow
    segment of a launch on the ragged grid shapes, with the box's 12
    walls or the 780 triangles of a cube field (a plane pack above the
    default cap of dynamic shared memory): no triangle the pre-reject
    skips blocks, no segment is decided differently, it skips some
    tests, and the output is the kernel's; the checking launch is counted
    on its own entry."""
    packs = _grid_packs(cuda)
    if case == "cubes":
        packs = (*packs[:2], _cube_packs(cuda)[2], *packs[3:])
    fn, check_fn = GRID_CHECKS[kernel]
    args = packs
    if kernel == "clustered":
        args = (*packs, *_tables(cuda, packs[0].shape[1], packs[1].shape[1]))
    before = (fn.launches, check_fn.launches)
    out, counts = check_fn(*args, seed=19)
    assert (fn.launches, check_fn.launches) == (before[0], before[1] + 1)
    assert counts["bad_tris"] == 0 and counts["bad_segments"] == 0, counts
    assert counts["considered"] >= counts["segments"] > 0
    assert counts["considered"] > counts["skipped"] > 0
    _grid_close(kernel, out, fn(*args, seed=19))


@pytest.mark.parametrize("shape", [(5, 77), (37, 33), (16, 32), (129, 8),
                                   (260, 65)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_cuda_grid_r_kernel_on_ragged_tiles(cuda, shape):
    """Kernel 6 against its plain version with fewer rays than a block
    takes, ray and VRL counts that are not multiples of its tile, whole
    tiles, and fewer VRLs than a chunk: R's mean at the homogeneous bar,
    its variance at R_VAR_MEDIAN, the pairs of an invalid ray or VRL
    written as 0; a repeat launch is bit-identical."""
    n_rays, n_vrls = shape
    packs = _grid_packs(cuda)
    packs = (packs[0][:, :n_rays].contiguous(),
             packs[1][:, :n_vrls].contiguous(), *packs[2:])
    out = vrl_r_hetero(*packs, seed=37)
    ref = vrl_r_hetero_reference(*packs, philox_uniforms(
        37, n_rays, n_vrls, 6, device=cuda))
    assert out.shape == (2, n_rays, n_vrls) and torch.isfinite(out).all()
    median, share = homog_bar(out[0], ref[0], channels=1)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    nz = ref[1] > R_VAR_FLOOR
    if int(nz.sum()) > 0:
        assert float(((out[1] - ref[1]).abs()[nz] / ref[1][nz]).median()) \
            < R_VAR_MEDIAN
    idle = ~((packs[0][pk.VALID] > 0.5)[:, None]
             & (packs[1][pk.VVALID] > 0.5)[None])
    assert int(idle.sum()) > 0 and not out[:, idle].any()
    assert torch.equal(out, vrl_r_hetero(*packs, seed=37))


@pytest.mark.parametrize("n_cols", [1, 33])
def test_cuda_grid_clustered_kernel_table_widths(cuda, n_cols):
    """Kernel 4 against its plain version with a table of one column and
    with one column more than a staged piece of VRL_CHUNK: the
    homogeneous bar, rays at row -1 sum to 0; a repeat launch is
    bit-identical."""
    packs = _grid_packs(cuda)
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    rows, ids, ws = _tables(cuda, n_rays, n_vrls, n_cols=n_cols)
    out = vrl_sum_hetero_clustered(*packs, rows, ids, ws, seed=41)
    ref = vrl_sum_hetero_clustered_reference(
        *packs, rows, ids, ws, philox_table_uniforms(41, rows, ids, 6))
    assert torch.isfinite(out).all() and float(out.abs().sum()) > 0.0
    assert not out[:, torch.as_tensor(rows < 0, device=cuda)].any()
    median, share = homog_bar(out.T, ref.T)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    assert torch.equal(out, vrl_sum_hetero_clustered(*packs, rows, ids, ws,
                                                     seed=41))


# --- the grid-medium backward kernel -----------------------------------------

# d_density is summed by atomics in an order that varies between runs: a
# repeat agrees per voxel to float32 rounding of its sum (terms of both
# signs), bounded here by this share of the largest |d_density|, as
# chip_smoke.py bounds it
DENSITY_REPEAT = 1e-4
VOXEL_FLOOR = 1e-3  # voxels compared: |grad| above this share of the largest


def _assert_grid_bwd_close(out, ref, kind, min_voxels=20):
    d_power, d_par, d_tau, d_eod, d_vod, d_dens = out
    r_power, r_par, r_tau, r_eod, r_vod, r_dens = ref
    for o, r in ((d_power, r_power), (d_tau, r_tau), (d_eod, r_eod),
                 (d_vod, r_vod)):
        assert torch.isfinite(o).all() and float(o.abs().sum()) > 0.0
        median, share = homog_bar(o.T, r.T, channels=o.shape[0])
        assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    nz = r_dens.abs() > VOXEL_FLOOR * float(r_dens.abs().max())
    assert torch.isfinite(d_dens).all() and int(nz.sum()) > min_voxels
    median, share = homog_bar(d_dens[nz][:, None], r_dens[nz][:, None],
                              channels=1)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    live = [0, 1, 2, 3, 4, 5, 6, 7, pk.GRID_MED_LEN - 1]
    assert float(d_par[8:-1].abs().sum()) == 0.0
    for i in live:
        d, r = float(d_par[i]), float(r_par[i])
        if kind == 1 and i == 6:
            assert d == 0.0 and r == 0.0
            continue
        assert d == 0.0 if r == 0.0 else abs(d - r) < PAR_RTOL * abs(r), \
            (i, d, r)


@pytest.mark.parametrize("kind", [0, 1], ids=["hg", "rayleigh"])
@pytest.mark.parametrize("injected", [True, False], ids=["injected", "philox"])
@pytest.mark.parametrize("short_vrls", [True, False], ids=["short", "long"])
def test_cuda_grid_bwd_kernel_matches_plain(cuda, kind, injected, short_vrls):
    """The grid backward kernel vs the plain grid backward on the ragged
    grid packs, every template: d_power, d_tau, d_eod, d_vod and the
    voxels of d_density at the homogeneous bar, d_par to PAR_RTOL."""
    packs = _grid_packs(cuda, kind)
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    gbar = torch.as_tensor(np.random.default_rng(5).uniform(
        0.5, 1.5, (3, n_rays)).astype(np.float32), device=cuda)
    u = _uniforms(cuda, injected, 12, (n_rays, n_vrls, 6))
    before = vrl_sum_hetero_bwd.launches
    out = vrl_sum_hetero_bwd(*packs, gbar, seed=31, uniforms=u,
                             short_vrls=short_vrls, phase_kind=kind)
    torch.cuda.synchronize()
    assert vrl_sum_hetero_bwd.launches == before + 1
    if u is None:
        u = philox_uniforms(31, n_rays, n_vrls, 6, device=cuda)
    ref = vrl_sum_hetero_bwd_reference(*packs, gbar, u, short_vrls=short_vrls,
                                       phase_kind=kind)
    _assert_grid_bwd_close(out, ref, kind)


def test_cuda_grid_bwd_kernel_zero_channels(cuda):
    """ROADMAP C7 in a grid medium: VRL power channel 1 and sigma_s_color
    channel 2 at 0; the kernel's d power[1] and d sigma_s_color[2] are
    not 0 and match the plain backward."""
    rays, vrls, tris, med, dss = _grid_packs(cuda)
    vrls = vrls.clone()
    vrls[pk.VP + 1] = 0.0
    med = med.clone()
    med[5] = 0.0
    gbar = torch.ones((3, rays.shape[1]), device=cuda)
    out = vrl_sum_hetero_bwd(rays, vrls, tris, med, dss, gbar, seed=3)
    ref = vrl_sum_hetero_bwd_reference(
        rays, vrls, tris, med, dss, gbar,
        philox_uniforms(3, rays.shape[1], vrls.shape[1], 6, device=cuda))
    _assert_grid_bwd_close(out, ref, 0)
    assert float(out[0][1].abs().max()) > 0.0 and float(out[1][5]) != 0.0


def test_cuda_grid_bwd_kernel_repeats(cuda):
    """A repeat is bit-identical but for d_density (atomics), which
    agrees to DENSITY_REPEAT of its largest entry."""
    packs = _grid_packs(cuda)
    gbar = torch.ones((3, packs[0].shape[1]), device=cuda)
    a = vrl_sum_hetero_bwd(*packs, gbar, seed=5)
    b = vrl_sum_hetero_bwd(*packs, gbar, seed=5)
    assert all(torch.equal(x, y) for x, y in zip(a[:5], b[:5]))
    assert float((a[5] - b[5]).abs().max()) \
        <= DENSITY_REPEAT * float(a[5].abs().max())


def test_cuda_grid_bwd_kernel_on_a_2x2x2_grid(cuda):
    """A 2x2x2 density grid (3^3 supersampled voxels): nearly every
    warp's density reductions collide, and most consecutive reads of a
    sample share a voxel, so the kernel merges them before its
    reductions; d_density (on the voxels above VOXEL_FLOOR, at least 10
    of the 27) still meets the homogeneous bar against the plain
    backward, as do the other cotangents."""
    packs = _grid_packs(cuda, grid_res=2)
    assert tuple(packs[4].shape) == (3, 3, 3)
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    gbar = torch.as_tensor(np.random.default_rng(8).uniform(
        0.5, 1.5, (3, n_rays)).astype(np.float32), device=cuda)
    out = vrl_sum_hetero_bwd(*packs, gbar, seed=17)
    ref = vrl_sum_hetero_bwd_reference(
        *packs, gbar, philox_uniforms(17, n_rays, n_vrls, 6, device=cuda))
    _assert_grid_bwd_close(out, ref, 0, min_voxels=10)


@pytest.mark.parametrize("kernel", ["sum", "bwd", "clustered_bwd",
                                    "clustered", "r"])
def test_cuda_grid_kernels_with_3_uv_steps(cuda, kernel):
    """uv_steps = 3 takes the generic instantiation of the grid sum, of
    its VJP, of the clustered sum and VJP and of R (the run-time step
    count; 4 steps, every caller's, take the one compiled for 4): each
    against its plain version at 3 steps, and different from the 4-step
    result."""
    packs = _grid_packs(cuda)
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    if kernel == "clustered":
        rows, ids, ws = _tables(cuda, n_rays, n_vrls)
        out = vrl_sum_hetero_clustered(*packs, rows, ids, ws, seed=23,
                                       uv_steps=3)
        ref = vrl_sum_hetero_clustered_reference(
            *packs, rows, ids, ws, philox_table_uniforms(23, rows, ids, 6),
            uv_steps=3)
        median, share = homog_bar(out.T, ref.T)
        assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
        assert not torch.equal(out, vrl_sum_hetero_clustered(
            *packs, rows, ids, ws, seed=23))
        return
    if kernel == "r":
        out = vrl_r_hetero(*packs, seed=23, uv_steps=3)
        ref = vrl_r_hetero_reference(*packs, philox_uniforms(
            23, n_rays, n_vrls, 6, device=cuda), uv_steps=3)
        median, share = homog_bar(out[0], ref[0], channels=1)
        assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
        assert not torch.equal(out, vrl_r_hetero(*packs, seed=23))
        return
    if kernel == "clustered_bwd":
        rows, ids, ws = _tables(cuda, n_rays, n_vrls)
        gbar = torch.as_tensor(np.random.default_rng(9).uniform(
            0.5, 1.5, (3, n_rays)).astype(np.float32), device=cuda)
        out = vrl_sum_hetero_clustered_bwd(*packs, rows, ids, ws, gbar,
                                           seed=23, uv_steps=3)
        ref = vrl_sum_hetero_clustered_bwd_reference(
            *packs, rows, ids, ws, gbar,
            philox_table_uniforms(23, rows, ids, 6), uv_steps=3)
        _assert_grid_bwd_close(out[:6], ref[:6], 0)
        _assert_weights_close(out[6], ref[6])
        assert not torch.equal(out[5], vrl_sum_hetero_clustered_bwd(
            *packs, rows, ids, ws, gbar, seed=23)[5])
        return
    u = philox_uniforms(23, n_rays, n_vrls, 6, device=cuda)
    if kernel == "sum":
        out = vrl_sum_hetero(*packs, seed=23, uv_steps=3)
        median, share = homog_bar(
            out.T, vrl_sum_hetero_reference(*packs, u, uv_steps=3).T)
        assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
        assert not torch.equal(out, vrl_sum_hetero(*packs, seed=23))
        return
    gbar = torch.as_tensor(np.random.default_rng(9).uniform(
        0.5, 1.5, (3, n_rays)).astype(np.float32), device=cuda)
    out = vrl_sum_hetero_bwd(*packs, gbar, seed=23, uv_steps=3)
    _assert_grid_bwd_close(out, vrl_sum_hetero_bwd_reference(
        *packs, gbar, u, uv_steps=3), 0)
    assert not torch.equal(out[5], vrl_sum_hetero_bwd(*packs, gbar,
                                                      seed=23)[5])


def test_cuda_grid_bwd_per_vrl_sums_against_float64(cuda):
    """ROADMAP C12 at a cut-down shape (64x64 eye rays of cornell_grid_
    smoke, 16^3 grid, the 512 bench VRLs: 32 ray blocks per VRL sum):
    the kernel's d_power and d_vod, whose ray-block partials it adds in
    float64, meet the homogeneous bar against the plain backward
    evaluated in float64, as chip_smoke.py holds them at the full
    config-4 shape."""
    scene = presets.cornell_grid_smoke(64, 64, grid_res=16, device=cuda)
    packs = integrator.pack_frame(scene, _bench_vrls(cuda))[3]
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    gbar = torch.as_tensor(np.random.default_rng(12).uniform(
        0.5, 1.5, (3, n_rays)).astype(np.float32), device=cuda)
    out = vrl_sum_hetero_bwd(*packs, gbar, seed=29)
    u = philox_uniforms(29, n_rays, n_vrls, 6, device=cuda)
    ref64 = vrl_sum_hetero_bwd_reference(
        *(x.double() for x in (*packs, gbar, u)))
    for i in (0, 4):  # d_power, d_vod
        assert torch.isfinite(out[i]).all() and float(out[i].abs().sum()) > 0
        median, share = homog_bar(out[i].T, ref64[i].T,
                                  channels=out[i].shape[0])
        assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (i, median,
                                                               share)


def test_cuda_grid_occupancy_query(cuda):
    """The occupancy entries answer for both grid instantiations of the
    sum, its VJP, the clustered sum, its VJP and R: at least one block of
    each fits on an SM."""
    for entry in ("vrl_sum", "vrl_sum_bwd", "vrl_sum_clustered_bwd",
                  "vrl_sum_clustered", "vrl_r"):
        for uv in (4, 3):
            assert occupancy(entry, True, 12, uv) >= 1


def test_cuda_grid_kernels_compiled_for_the_default_uv_steps(cuda):
    """The library's grid sum and VJP are compiled for the U-V step count
    every caller passes (VRLConfig().uv_tau_steps), so the callers take
    that instantiation and not the generic one."""
    assert compiled_uv_steps() == VRLConfig().uv_tau_steps


def test_cuda_grid_render_diff_launches_both_grid_kernels(cuda):
    """render_with_vrls_kernel_diff on a grid medium goes through
    vrl_sum_hetero and vrl_sum_hetero_bwd, and its gradients reach the
    density voxels, sigma_t_color, albedo, g and scale."""
    scene = presets.cornell_grid_smoke(16, 16, grid_res=8, device=cuda)
    med = scene.medium
    params = {k: getattr(med, k).clone().requires_grad_()
              for k in ("density", "sigma_t_color", "albedo", "g", "scale")}
    scene = replace(scene, medium=replace(med, **params))
    fwd, bwd = vrl_sum_hetero.launches, vrl_sum_hetero_bwd.launches
    img = integrator.render_with_vrls_kernel_diff(
        scene, _bench_vrls(cuda), torch.Generator().manual_seed(0))
    grads = torch.autograd.grad(img.mean(), list(params.values()))
    assert vrl_sum_hetero.launches == fwd + 1
    assert vrl_sum_hetero_bwd.launches == bwd + 1
    for g in grads:
        assert g.is_cuda and torch.isfinite(g).all() and float(
            g.abs().sum()) > 0.0


# --- the clustered backward kernel -------------------------------------------


def _assert_weights_close(d_w, r_w):
    assert torch.isfinite(d_w).all() and float(d_w.abs().sum()) > 0.0
    median, share = homog_bar(d_w.reshape(-1, 1), r_w.reshape(-1, 1),
                              channels=1)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


def _clustered_bwd_case(device, packs, rows, ids, ws, injected, seed,
                        short_vrls, kind):
    """(kernel output, plain output) of the clustered backward of either
    medium (grid packs have the density as a fifth entry)."""
    n_rays = packs[0].shape[1]
    gbar = torch.as_tensor(np.random.default_rng(7).uniform(
        0.5, 1.5, (3, n_rays)).astype(np.float32), device=device)
    u = _uniforms(device, injected, 14, (n_rays, ids.shape[1], 6))
    kw = dict(short_vrls=short_vrls, phase_kind=kind)
    kernel, plain = ((vrl_sum_clustered_bwd, vrl_sum_clustered_bwd_reference)
                     if len(packs) == 4 else
                     (vrl_sum_hetero_clustered_bwd,
                      vrl_sum_hetero_clustered_bwd_reference))
    before = kernel.launches
    out = kernel(*packs, rows, ids, ws, gbar, seed=seed, uniforms=u, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    if u is None:
        u = philox_table_uniforms(seed, rows, ids, 6)
    return out, plain(*packs, rows, ids, ws, gbar, u, **kw)


@pytest.mark.parametrize("medium", sorted(MEDIA))
@pytest.mark.parametrize("injected", [True, False], ids=["injected", "philox"])
@pytest.mark.parametrize("short_vrls", [True, False], ids=["short", "long"])
def test_cuda_clustered_bwd_kernel_matches_plain(cuda, medium, injected,
                                                 short_vrls):
    """The clustered backward kernel vs the plain clustered backward on
    the ragged 260 x 77 shapes with the 45-column tables of
    test_cuda_clustered_kernel_matches_plain, every template: d_power,
    d_tau and d_weights at the homogeneous bar, d_par to PAR_RTOL; rays
    at row -1 get no d_tau."""
    g, kind = MEDIA[medium]
    packs = _ragged_packs(cuda, g, kind)
    rows, ids, ws = _tables(cuda, packs[0].shape[1], packs[1].shape[1])
    out, ref = _clustered_bwd_case(cuda, packs, rows, ids, ws, injected, 41,
                                   short_vrls, kind)
    _assert_bwd_close(out[:3], ref[:3], kind)
    _assert_weights_close(out[3], ref[3])
    assert not out[2][:, torch.as_tensor(rows < 0, device=cuda)].any()


@pytest.mark.parametrize("kind", [0, 1], ids=["hg", "rayleigh"])
@pytest.mark.parametrize("injected", [True, False], ids=["injected", "philox"])
@pytest.mark.parametrize("short_vrls", [True, False], ids=["short", "long"])
def test_cuda_grid_clustered_bwd_kernel_matches_plain(cuda, kind, injected,
                                                      short_vrls):
    """The grid clustered backward kernel vs its plain version on the
    ragged grid packs and 45-column tables, every template: the grid
    backward's bars and d_weights at the homogeneous bar."""
    packs = _grid_packs(cuda, kind)
    rows, ids, ws = _tables(cuda, packs[0].shape[1], packs[1].shape[1])
    out, ref = _clustered_bwd_case(cuda, packs, rows, ids, ws, injected, 43,
                                   short_vrls, kind)
    _assert_grid_bwd_close(out[:6], ref[:6], kind)
    _assert_weights_close(out[6], ref[6])


@pytest.mark.parametrize("grid", [False, True], ids=["homog", "grid"])
def test_cuda_clustered_bwd_rows_over_several_tiles(cuda, grid):
    """Rows of 130-260 rays, so each spans several tiles (two or three of
    the grid's 128 rays, five to nine of the homogeneous 32) whose column
    sums add in tile order: one row of every ray, and two rows at
    random."""
    packs = _grid_packs(cuda) if grid else _ragged_packs(cuda, 0.6, 0)
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    _, ids, ws = _tables(cuda, n_rays, n_vrls, n_rows=2)
    for rows in (np.zeros(n_rays, np.int64),
                 np.random.default_rng(2).integers(0, 2, n_rays)):
        out, ref = _clustered_bwd_case(cuda, packs, rows, ids, ws, False, 47,
                                       True, 0)
        if grid:
            _assert_grid_bwd_close(out[:6], ref[:6], 0)
        else:
            _assert_bwd_close(out[:3], ref[:3], 0)
        _assert_weights_close(out[-1], ref[-1])


@pytest.mark.parametrize("n_tris", [24, 780])
def test_cuda_clustered_bwd_kernel_over_row_sizes(cuda, n_tris):
    """Kernel 10 on rows of 1, 31, 32, 33 and 200 rays (one ray short of,
    at and one past its 32-ray tile, and a row over seven tiles) and rays
    at row -1, with config 1's 24 triangles or the cube field's 780 (a
    plane pack above the default cap of dynamic shared memory): against
    the plain clustered backward at the homogeneous bars, bit-identical
    to its launch without the plane pre-reject and to a repeat."""
    packs = integrator.pack_frame(_scene(cuda, 20, 20, 0.6, 0),
                                  _bench_vrls(cuda))[3]
    if n_tris == 780:
        packs = (*packs[:2], _cube_packs(cuda)[2], packs[3])
    n_rays, n_vrls = packs[0].shape[1], 77
    packs = (packs[0], packs[1][:, :n_vrls].contiguous(), *packs[2:])
    rng = np.random.default_rng(9)
    sizes = (1, 31, 32, 33, 200)
    rows = np.repeat(np.arange(-1, len(sizes)),
                     (n_rays - sum(sizes), *sizes))
    rng.shuffle(rows)
    _, ids, ws = _tables(cuda, n_rays, n_vrls, n_rows=len(sizes))
    out, ref = _clustered_bwd_case(cuda, packs, rows, ids, ws, False, 29,
                                   True, 0)
    _assert_bwd_close(out[:3], ref[:3], 0)
    _assert_weights_close(out[3], ref[3])
    assert not out[2][:, torch.as_tensor(rows < 0, device=cuda)].any()
    gbar = torch.as_tensor(np.random.default_rng(7).uniform(
        0.5, 1.5, (3, n_rays)).astype(np.float32), device=cuda)
    layout = cbwd.host_layout(rows, ids, n_vrls, cbwd.ray_block(False), cuda)
    assert len(layout[1]) == sum(-(-n // cbwd.ray_block(False))
                                 for n in sizes)

    def launch(mode):
        return cbwd._launch(cbwd._library(), *packs, layout, ids, ws, None,
                            29, 2, 2, True, 0, gbar, mode=mode)
    again = vrl_sum_clustered_bwd(*packs, rows, ids, ws, gbar, seed=29)
    for other in (launch(vs.MODE_NO_REJECT), launch(vs.MODE_SUM), again):
        assert all(torch.equal(a, b) for a, b in zip(out, other))


@pytest.mark.parametrize("grid", [False, True], ids=["homog", "grid"])
def test_cuda_clustered_bwd_kernel_zero_channels(cuda, grid):
    """ROADMAP C7 on the clustered path: VRL power channel 1 and sigma_s
    (grid: sigma_s_color) channel 2 at 0; the kernel's d power[1] and d
    sigma_s[2] are not 0 and match the plain version."""
    packs = list(_grid_packs(cuda) if grid else _ragged_packs(cuda, 0.4, 0))
    packs[1] = packs[1].clone()
    packs[1][pk.VP + 1] = 0.0
    packs[3] = packs[3].clone()
    if not grid:
        packs[3][2] -= packs[3][5]  # sigma_t = sigma_a
    packs[3][5] = 0.0
    rows, ids, ws = _tables(cuda, packs[0].shape[1], packs[1].shape[1])
    out, ref = _clustered_bwd_case(cuda, packs, rows, ids, ws, False, 3, True,
                                   0)
    if grid:
        _assert_grid_bwd_close(out[:6], ref[:6], 0)
    else:
        _assert_bwd_close(out[:3], ref[:3], 0)
    assert float(out[0][1].abs().max()) > 0.0 and float(out[1][5]) != 0.0


@pytest.mark.parametrize("grid", [False, True], ids=["homog", "grid"])
def test_cuda_clustered_bwd_kernel_repeats(cuda, grid):
    """A repeat is bit-identical but for d_density (atomics), which
    agrees to DENSITY_REPEAT of its largest entry; another seed differs."""
    packs = _grid_packs(cuda) if grid else _ragged_packs(cuda, 0.0, 1)
    rows, ids, ws = _tables(cuda, packs[0].shape[1], packs[1].shape[1])
    gbar = torch.ones((3, packs[0].shape[1]), device=cuda)
    fn = vrl_sum_hetero_clustered_bwd if grid else vrl_sum_clustered_bwd
    a, b, c = (fn(*packs, rows, ids, ws, gbar, seed=s) for s in (5, 5, 6))
    exact = [0, 1, 2, 3, 4, 6] if grid else [0, 1, 2, 3]
    assert all(torch.equal(a[i], b[i]) for i in exact)
    assert not torch.equal(a[0], c[0])
    if grid:
        assert float((a[5] - b[5]).abs().max()) \
            <= DENSITY_REPEAT * float(a[5].abs().max())


@pytest.mark.parametrize("grid", [False, True], ids=["homog", "grid"])
def test_cuda_clustered_bwd_identity_table_is_the_unclustered_vjp(cuda,
                                                                  grid):
    """One row of all 77 VRLs at weight 1 gives the unclustered backward
    kernel's result on the same rays and seed, and d_weights is the sum
    over channels of the power times d_power."""
    packs = _grid_packs(cuda) if grid else _ragged_packs(cuda, 0.6, 0)
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    gbar = torch.as_tensor(np.random.default_rng(8).uniform(
        0.5, 1.5, (3, n_rays)).astype(np.float32), device=cuda)
    ids = torch.arange(n_vrls, dtype=torch.int32, device=cuda)[None]
    fn, ref_fn = ((vrl_sum_hetero_clustered_bwd, vrl_sum_hetero_bwd) if grid
                  else (vrl_sum_clustered_bwd, vrl_sum_bwd))
    out = fn(*packs, np.zeros(n_rays, np.int64), ids,
             torch.ones((1, n_vrls), device=cuda), gbar, seed=13)
    ref = ref_fn(*packs, gbar, seed=13)
    if grid:
        _assert_grid_bwd_close(out[:6], ref, 0)
    else:
        _assert_bwd_close(out[:3], ref, 0)
    _assert_weights_close(out[-1][0], (packs[1][pk.VP:pk.VP + 3]
                                       * ref[0]).sum(dim=0))


@pytest.mark.parametrize("grid", [False, True], ids=["homog", "grid"])
def test_cuda_clustered_render_diff_launches_both_kernels(cuda, grid):
    """render_clustered_kernel_diff goes through the clustered sum and its
    backward kernel, and its gradients reach the medium and the table
    weights."""
    scene = (presets.cornell_grid_smoke(16, 16, grid_res=8, device=cuda)
             if grid else presets.cornell_smoke(16, 16, device=cuda))
    med = scene.medium
    names = (("density", "sigma_t_color", "albedo", "g", "scale") if grid
             else ("sigma_a", "sigma_s", "g"))
    params = {k: getattr(med, k).clone().requires_grad_() for k in names}
    scene = replace(scene, medium=replace(med, **params))
    rows, ids, ws = _tables(cuda, 256, 512)
    ws.requires_grad_()
    fwd, bwd = ((vrl_sum_hetero_clustered, vrl_sum_hetero_clustered_bwd)
                if grid else (vrl_sum_clustered, vrl_sum_clustered_bwd))
    before = (fwd.launches, bwd.launches)
    img = integrator.render_clustered_kernel_diff(
        scene, _bench_vrls(cuda), rows, ids, ws,
        torch.Generator().manual_seed(0))
    grads = torch.autograd.grad(img.mean(), [*params.values(), ws])
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    for g in grads:
        assert g.is_cuda and torch.isfinite(g).all() and float(
            g.abs().sum()) > 0.0


# --- the BVH-occlusion sum and the gather probes ----------------------------


def _bvh_inputs(device, kind, g, phase_kind):
    """(flat packs, BvhPack) on Morton-sorted VRLs: cornell_smoke 32x32
    with the 512 bench VRLs (24 triangles), or a 4^3 cube field 32x32
    with its bench VRLs (780 triangles)."""
    if kind == "cornell":
        scene, vrls = _scene(device, 32, 32, g, phase_kind), _bench_vrls(device)
    else:
        scene = bbl.scene_of("cubes", 4, width=32, device=device)
        scene = replace(scene, medium=replace(scene.medium, g=torch.tensor(
            g, device=device), phase_kind=phase_kind))
        vrls = bbl.bench_vrls(scene)
    packs = integrator.pack_frame(scene, vb.sort_vrls_morton(vrls))[3]
    return packs, vb.pack_bvh_tris(scene.vertices, scene.faces,
                                   scene.opaque_faces())


@pytest.mark.parametrize("medium", sorted(MEDIA))
@pytest.mark.parametrize("kind", ["cornell", "cubes"])
@pytest.mark.parametrize("injected", [True, False], ids=["injected", "philox"])
def test_cuda_bvh_kernel_matches_flat_kernel(cuda, medium, kind, injected):
    """Kernel 7 against kernel 1 on the same packs, at 24 and 780
    triangles: the same samples and shadow tests. The two kernels are
    separate compilations of the estimator, whose fused multiply-adds
    differ in places, so sums may differ in their last bits: every ray
    within 1e-4 relative (a sample dropped by one kernel only would move
    its ray's sum by far more), and the homogeneous bar."""
    g, phase_kind = MEDIA[medium]
    packs, pack = _bvh_inputs(cuda, kind, g, phase_kind)
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    u = (torch.as_tensor(np.random.default_rng(8).random(
        (n_rays, n_vrls, 6), dtype=np.float32), device=cuda)
        if injected else None)
    kw = dict(seed=31, uniforms=u, phase_kind=phase_kind)
    before = vb.vrl_sum_bvh.launches
    out = vb.vrl_sum_bvh(packs[0], packs[1], pack, packs[3], **kw)
    ref = vrl_sum(*packs, **kw)
    torch.cuda.synchronize()
    assert vb.vrl_sum_bvh.launches == before + 1
    assert torch.isfinite(out).all() and float(out.abs().sum()) > 0.0
    rel = (out - ref).abs() / torch.clamp(ref.abs(), min=1e-3)
    assert float(rel.max()) < 1e-4
    median, share = homog_bar(out.T, ref.T)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


@pytest.mark.parametrize("short_vrls", [True, False], ids=["short", "long"])
def test_cuda_bvh_kernel_matches_plain(cuda, short_vrls):
    """Kernel 7 against its plain version at 2,604 triangles (a 6^3 cube
    field), 16x16 eye rays x 256 VRLs, on the Philox stream."""
    scene = bbl.scene_of("cubes", 6, width=16, device=cuda)
    packs = integrator.pack_frame_bvh(scene, bbl.bench_vrls(scene))[3]
    out = vb.vrl_sum_bvh(*packs, seed=5, short_vrls=short_vrls)
    ref = vb.vrl_sum_bvh_reference(*packs, philox_uniforms(
        5, 256, packs[1].shape[1], 6, device=cuda), short_vrls=short_vrls)
    assert float(out.abs().sum()) > 0.0
    median, share = homog_bar(out.T, ref.T)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


def test_cuda_bvh_kernel_counts(cuda):
    """The counting launch gives the kernel's sums (counted on its own
    launch count) and totals that add up: every tested segment walks at
    least the root, opens do not exceed the tested segments."""
    scene = bbl.scene_of("blob", 16, width=16, device=cuda)
    packs = integrator.pack_frame_bvh(scene, bbl.bench_vrls(scene))[3]
    before = (vb.vrl_sum_bvh.launches, vb.vrl_sum_bvh_counts.launches)
    out, counts = vb.vrl_sum_bvh_counts(*packs, seed=3)
    assert torch.equal(out, vb.vrl_sum_bvh(*packs, seed=3))
    assert (vb.vrl_sum_bvh.launches, vb.vrl_sum_bvh_counts.launches) == (
        before[0] + 1, before[1] + 1)
    assert counts["node_fetches"] >= counts["segments"] > 0
    assert counts["box_tests"] == 2 * counts["node_fetches"]
    assert 0 < counts["open_vv"] + counts["open_vs"] <= counts["segments"]
    assert counts["tri_tests"] > 0
    assert counts["needed_box_tests"] >= counts["segments"]
    assert counts["needed_tri_tests"] > 0 and counts["differ"] == 0


def test_cuda_bvh_kernel_on_a_tree_as_deep_as_the_stack(cuda):
    """Kernel 7 on a chain tree as deep as it serves (BVH_STACK), whose
    traversal fills the stack: kernel 1's sums on the same triangles to
    rounding, the plain version's at the homogeneous bar, and the
    counting launch's needed-work traversal deciding as it does."""
    packs = integrator.pack_frame(_scene(cuda, 16, 16), _bench_vrls(cuda))[3]
    chain = chain_bvh_pack(packs[2], vb.BVH_STACK)
    u = torch.as_tensor(np.random.default_rng(8).random(
        (packs[0].shape[1], packs[1].shape[1], 6), dtype=np.float32),
        device=cuda)
    out = vb.vrl_sum_bvh(packs[0], packs[1], chain, packs[3], uniforms=u)
    _close(out, vrl_sum(*packs, uniforms=u))
    median, share = homog_bar(out.T, vrl_sum_reference(*packs, u).T)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    counted, counts = vb.vrl_sum_bvh_counts(packs[0], packs[1], chain,
                                            packs[3], uniforms=u)
    assert torch.equal(counted, out)
    assert counts["differ"] == 0 and counts["needed_box_tests"] > 0, counts


def test_cuda_bvh_refuses_a_deep_tree(cuda):
    """A pack deeper than the kernel's stack is refused by the wrapper
    and, past it, by the kernel's entry point."""
    assert vb._library().alvrl_bvh_stack() == vb.BVH_STACK
    packs = integrator.pack_frame_bvh(_scene(cuda, 8, 8), _bench_vrls(cuda))[3]
    deep = packs[2]._replace(depth=vb.BVH_STACK + 1)
    with pytest.raises(ValueError):
        vb.vrl_sum_bvh(packs[0], packs[1], deep, packs[3])
    with pytest.raises(RuntimeError):
        vb._launch(vb._library(), packs[0], packs[1], deep, packs[3], None,
                   0, 2, 2, True, 0)


def test_cuda_bvh_render_counts_launches(cuda):
    """render_with_vrls_kernel_bvh launches kernel 7 once; its image is
    the flat render's on the same Morton-sorted VRLs, to rounding."""
    scene = bbl.scene_of("cubes", 4, width=16, device=cuda)
    vrls = bbl.bench_vrls(scene)
    before = vb.vrl_sum_bvh.launches
    img = integrator.render_with_vrls_kernel_bvh(
        scene, vrls, torch.Generator().manual_seed(0))
    assert vb.vrl_sum_bvh.launches == before + 1
    assert img.shape == (16, 16, 3) and torch.isfinite(img).all()
    flat = integrator.render_with_vrls_kernel(
        scene, vb.sort_vrls_morton(vrls), torch.Generator().manual_seed(0))
    median, share = homog_bar(img, flat)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


def test_cuda_bvh_hits_match_intersect_all(cuda):
    """The BVH's closest hits on the card: intersect_all's, on a 16k
    cube field's eye rays."""
    scene = bbl.scene_of("cubes", 11, width=32, device=cuda)
    _, _, ray_o, ray_d = integrator.frame_rays(scene)
    t, prim, valid = bvh.intersect(bvh.build(scene.vertices, scene.faces),
                                   ray_o, ray_d)
    ref = intersect.intersect_all(ray_o, ray_d, scene.vertices, scene.faces)
    assert torch.equal(valid, ref.valid) and torch.equal(prim, ref.prim)
    assert float((t[valid] - ref.t[valid]).abs().max()) <= 1e-4


@pytest.mark.parametrize("name", ["lane_gather", "row_gather", "gather_many"])
def test_cuda_probe_kernels(cuda, name):
    """Each gather probe on the JAX script's inputs equals its plain
    version and counts its launch."""
    tbl, idx, tbl0, idx0 = probe.inputs(cuda)
    args = (tbl0, idx0) if name == "row_gather" else (tbl, idx)
    fn = getattr(probe, name)
    before = fn.launches
    out = fn(*args)
    assert fn.launches == before + 1
    assert torch.equal(out, getattr(probe, f"{name}_reference")(*args))


# --- kernel 1 on the specular chains' rays ---------------------------------


def _glass_scene(device, size):
    """cornell_smoke with its green wall a mirror (tinted by its albedo)
    and its blocker a dielectric of eta 1.5."""
    scene = presets.cornell_smoke(size, size, device=device)
    return replace(scene, materials=replace(
        scene.materials, kind=torch.tensor([0, 0, 2, 3], device=device),
        eta=torch.tensor([1.0, 1.0, 1.0, 1.5], device=device)))


def _chain_sums(device, size, monkeypatch, uniforms=None):
    """render_with_vrls_kernel_spec on _glass_scene with the bench VRLs,
    each depth's vrl_sum call recorded: (image, [(packs, kwargs)])."""
    calls, real = [], integrator.vrl_sum

    def recording(*packs, **kw):
        calls.append((packs, kw))
        return real(*packs, **kw)

    monkeypatch.setattr(integrator, "vrl_sum", recording)
    img = integrator.render_with_vrls_kernel_spec(
        _glass_scene(device, size), _bench_vrls(device),
        torch.Generator().manual_seed(1), uniforms=uniforms)
    monkeypatch.setattr(integrator, "vrl_sum", real)
    return img, calls


@pytest.mark.parametrize("injected", [True, False], ids=["injected", "philox"])
def test_cuda_kernel_on_surface_origin_rays(cuda, injected, monkeypatch):
    """Each chain depth past the first launches kernel 1 on rays whose
    origins lie on the mirror or the glass: against the plain version on
    the same packs and uniforms, and the checking launch with 0
    disagreements of the plane pre-reject."""
    u = None
    if injected:
        u = torch.rand((7, 32 * 32, 512, 6), device=cuda,
                       generator=torch.Generator(cuda).manual_seed(2))
    _, calls = _chain_sums(cuda, 32, monkeypatch, uniforms=u)
    assert len(calls) >= 3
    for packs, kw in calls[1:]:
        out = vrl_sum(*packs, **kw)
        n_rays = packs[0].shape[1]
        uu = kw["uniforms"] if injected else philox_uniforms(
            kw["seed"], n_rays, 512, 6, device=cuda)
        plain_kw = {k: v for k, v in kw.items() if k not in ("seed",
                                                             "uniforms")}
        ref = vrl_sum_reference(*packs, uu, **plain_kw)
        assert torch.isfinite(out).all()
        median, share = homog_bar(out.T, ref.T)
        assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
        _, counts = vs.vrl_sum_check(*packs, **kw)
        assert counts["bad_tris"] == 0 and counts["bad_segments"] == 0, counts
        assert counts["segments"] > 0


def test_cuda_spec_render_matches_plain_chain(cuda, monkeypatch):
    """render_with_vrls_kernel_spec at 32x32 against the plain chain
    (li_unclustered_spec_u) on the same uniforms, at the homogeneous bar;
    kernel 1 launched once a depth reached, at most max_depth + 1 times,
    each on fewer rays than the depth before."""
    from alvrl_tpu_torch.integrators.vrl import specular

    spec_cfg = specular.SpecularConfig()
    u = torch.rand((7, 32 * 32, 512, 6), device=cuda,
                   generator=torch.Generator(cuda).manual_seed(3))
    before = vrl_sum.launches
    img, calls = _chain_sums(cuda, 32, monkeypatch, uniforms=u)
    assert vrl_sum.launches == before + len(calls)
    assert 3 <= len(calls) <= spec_cfg.max_depth + 1
    active = [packs[0].shape[1] for packs, _ in calls]
    assert active[0] == 32 * 32 and all(
        a > b for a, b in zip(active, active[1:])), active
    scene = _glass_scene(cuda, 32)
    _, _, ray_o, ray_d = integrator.frame_rays(scene)
    u_chain = integrator._chain_draws(torch.Generator().manual_seed(1),
                                      spec_cfg, 32 * 32, cuda)[0]
    li = integrator.li_unclustered_spec_u(scene, ray_o, ray_d,
                                          _bench_vrls(cuda), u_chain, u)
    assert torch.isfinite(img).all() and float(img.mean()) > 0.0
    median, share = homog_bar(img.reshape(-1, 3), li)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


# --- the material instantiations of kernels 1, 2 and 5 (glossy and
# layered surfaces at the eye hit)

def _glossy(device, size=32):
    """torch_port_utils.glossy_scene_desc's box of the eleven smooth
    kinds, its material pack, the bench VRLs and the material packs of
    its frame."""
    from alvrl_tpu_torch.scene import loader
    from torch_port_utils import glossy_scene_desc

    scene = loader.build_scene(glossy_scene_desc(size, size), device=device)
    vrls = _bench_vrls(device)
    mats = integrator.material_pack(scene)
    packs = integrator.pack_frame(scene, vrls, materials=mats)[3]
    return scene, vrls, mats, packs


def _glossy_table(packs, device, n_slices=8, n_cols=48):
    rng = np.random.default_rng(5)
    n_rays = packs[0].shape[1]
    sop = rng.integers(-1, n_slices, n_rays).astype(np.int32)
    ids = torch.as_tensor(rng.integers(-1, 512, (n_slices, n_cols)),
                          dtype=torch.int32, device=device)
    w = torch.as_tensor(rng.uniform(0.0, 2.0, (n_slices, n_cols)),
                        dtype=torch.float32, device=device)
    return sop, ids, w


KIND_RAYS = 256  # eye rays of each kind in the material kernels' holds


def _glossy_by_kind(device):
    """_glossy at 128x128, its ray pack cut to KIND_RAYS eye rays of each
    of the eleven smooth kinds (a seeded pick): (material pack, packs,
    the rays' kinds, the kinds)."""
    _, _, mats, packs = _glossy(device, 128)
    return (mats, *_by_kind(mats, packs, pk.MATID, device, 16))


def _by_kind(mats, packs, row, device, seed):
    """KIND_RAYS eye rays of each smooth kind that the packs' rays hit (a
    pick of `seed`), the packs' material-id row being `row`: (their
    packs, their kinds, the kinds)."""
    from alvrl_tpu_torch.bsdf import api as bsdf_api

    kind = mats[0][packs[0][row].long(), pk.MT_KIND].long()
    kinds = (bsdf_api.MATERIAL_FORM_KINDS - bsdf_api.DELTA_KINDS
             - {bsdf_api.DIFFUSE}) & set(kind.tolist())
    rng = np.random.default_rng(seed)
    pick = torch.as_tensor(np.concatenate([rng.choice(
        np.flatnonzero(kind.cpu().numpy() == k), KIND_RAYS, replace=False)
        for k in sorted(kinds)]), device=device)
    return (packs[0][:, pick].contiguous(), *packs[1:]), kind[pick], kinds


@pytest.mark.parametrize("kernel", ["vrl_sum", "vrl_sum_clustered", "vrl_r"])
@pytest.mark.parametrize("injected", [True, False], ids=["injected", "philox"])
def test_cuda_material_kernels_match_plain(cuda, kernel, injected):
    """Each material instantiation on the glossy box (KIND_RAYS eye rays
    of each of the eleven kinds x 512 VRLs; kernel 2 on a seeded table
    with rows -1, ids -1 and weights 0) against its plain version on the
    same uniforms, at the homogeneous bar over all rays and over each
    kind's rays alone (a wrong branch of one kind fails its group); its
    launch counted."""
    mats, packs, ray_kind, kinds = _glossy_by_kind(cuda)
    n_rays, seed = packs[0].shape[1], 97
    kw = dict(seed=seed, materials=mats)
    if kernel == "vrl_sum_clustered":
        sop, ids, w = _glossy_table(packs, cuda)
        u = (torch.rand((n_rays, ids.shape[1], 6), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(1))
             if injected else philox_table_uniforms(seed, sop, ids, 6))
        before = vrl_sum_clustered.launches
        out = vrl_sum_clustered(*packs, sop, ids, w,
                                uniforms=u if injected else None, **kw)
        ref = vrl_sum_clustered_reference(*packs, sop, ids, w, u,
                                          materials=mats)
        launches = vrl_sum_clustered.launches - before
    else:
        fn, plain = ((vrl_sum, vrl_sum_reference) if kernel == "vrl_sum"
                     else (vrl_r, vrl_r_reference))
        u = (torch.rand((n_rays, 512, 6), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(1))
             if injected else philox_uniforms(seed, n_rays, 512, 6,
                                              device=cuda))
        before = fn.launches
        out = fn(*packs, uniforms=u if injected else None, **kw)
        ref = plain(*packs, u, materials=mats)
        launches = fn.launches - before
        if kernel == "vrl_r":
            out, ref = out[0], ref[0]
    torch.cuda.synchronize()
    assert launches == 1
    assert torch.isfinite(out).all() and float(out.abs().sum()) > 0.0
    if kernel == "vrl_r":
        out_i, ref_i, channels = out, ref, 1
        item_kind = ray_kind[:, None].expand(-1, 512)
    else:
        out_i, ref_i, channels, item_kind = out.T, ref.T, 3, ray_kind
    median, share = homog_bar(out_i, ref_i, channels)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    groups = homog_bar_by_kind(out_i, ref_i, item_kind, channels)
    assert set(groups) == kinds
    for k, (n, median, share) in groups.items():
        assert (n == KIND_RAYS * out_i.numel() // channels // n_rays
                and median < HOMOG_MEDIAN and share < HOMOG_SHARE), (
            k, n, median, share)


def test_cuda_material_checking_launches(cuda):
    """The checking instantiations of kernels 1, 2 and 5 with a material
    pack: 0 disagreements of the plane pre-reject, and their outputs
    the sums' (kernel 2's bit for bit)."""
    _, _, mats, packs = _glossy(cuda)
    out, counts = vs.vrl_sum_check(*packs, seed=3, materials=mats)
    assert counts["bad_tris"] == 0 and counts["bad_segments"] == 0
    assert counts["segments"] > 0
    median, share = homog_bar(out.T, vrl_sum(*packs, seed=3,
                                             materials=mats).T)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE
    sop, ids, w = _glossy_table(packs, cuda)
    out, counts = vrl_sum_clustered_check(*packs, sop, ids, w, seed=3,
                                          materials=mats)
    assert counts["bad_tris"] == 0 and counts["bad_segments"] == 0
    assert torch.equal(out, vrl_sum_clustered(*packs, sop, ids, w, seed=3,
                                              materials=mats))
    _, counts = vrl_r_check(*packs, seed=3, materials=mats)
    assert counts["bad_tris"] == 0 and counts["bad_segments"] == 0


def test_cuda_material_kernel_on_a_diffuse_table(cuda):
    """Config 1's diffuse table packed for the material instantiation of
    kernel 1: the same samples as the diffuse one, the eval's albedo
    cos_o / pi in place of the ALB rows, at the homogeneous bar."""
    scene = _scene(cuda, 32, 32)
    vrls = _bench_vrls(cuda)
    mats = pk.pack_materials(scene.materials)
    mpacks = integrator.pack_frame(scene, vrls, materials=mats)[3]
    packs = integrator.pack_frame(scene, vrls)[3]
    out = vrl_sum(*mpacks, seed=8, materials=mats)
    ref = vrl_sum(*packs, seed=8)
    median, share = homog_bar(out.T, ref.T)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


def test_cuda_glossy_renders_take_the_material_kernels(cuda):
    """render_with_vrls_kernel and render_alvrl on the glossy box launch
    kernels 1, 5 and 2 with its material pack; the images are finite
    and non-zero."""
    scene, vrls, _, _ = _glossy(cuda, 16)
    calls = []
    saved = vs._launch

    def recording(*a, materials=None, **k):
        calls.append(materials is not None)
        return saved(*a, materials=materials, **k)

    vs._launch = recording
    try:
        img = integrator.render_with_vrls_kernel(
            scene, vrls, torch.Generator().manual_seed(0))
    finally:
        vs._launch = saved
    assert calls == [True]
    before = (vrl_r.launches, vrl_sum_clustered.launches)
    img_c, _, _ = alvrl.render_alvrl(
        scene, torch.Generator().manual_seed(1), alvrl.ALVRLParams(
            vrl_target_num=128, num_particles=32))
    assert vrl_r.launches > before[0] and vrl_sum_clustered.launches > \
        before[1]
    for im in (img, img_c):
        assert torch.isfinite(im).all() and float(im.abs().max()) > 0.0


# the mixture phase (PHASE = 2) and the sampling strategies in kernels 1,
# 2 and 5: an absorbing two-lobe mixture (HG 0.8 at 0.6, Rayleigh at 0.3),
# in a coloured medium (MIX_SIGMA_S), so that no strategy's one rate is
# every channel's sigma_t and a kernel that took the balance pdfFailure
# in its place fails its hold
MIX_SIGMA_S = (0.8, 0.5, 0.3)
MIX_MEDIA = {
    "mixture_single": dict(phase_kind=4, strategy=1, channel=1),
    "mixture_balance": dict(phase_kind=4),
    "hg_single": dict(strategy=1, channel=0),
    "hg_maximum": dict(strategy=3),
    "rayleigh_manual": dict(phase_kind=1, strategy=2, density=0.7),
}


def _mixture(device, name, size=64):
    """Config 1's box in the coloured medium of MIX_MEDIA[name], the
    bench VRLs: (scene, packs)."""
    from alvrl_tpu_torch.media import phase as ph

    scene = _scene(device, size, size)
    kw = dict(MIX_MEDIA[name], sigma_s=torch.tensor(MIX_SIGMA_S,
                                                    device=device))
    if kw.get("phase_kind") == 4:
        kw["phase_params"] = ph.mixture_params(
            [0.6, 0.3], [ph.HG, ph.RAYLEIGH], [0.8, 0.0], device=device)
    scene = replace(scene, medium=replace(scene.medium, **kw))
    return scene, integrator.pack_frame(scene, _bench_vrls(device))[3]


@pytest.mark.parametrize("name", sorted(MIX_MEDIA))
@pytest.mark.parametrize("kernel", ["vrl_sum", "vrl_sum_clustered", "vrl_r"])
@pytest.mark.parametrize("injected", [True, False], ids=["injected", "philox"])
def test_cuda_mixture_and_strategy_kernels_match_plain(cuda, name, kernel,
                                                       injected):
    """Kernels 1, 2 and 5 on the extended medium pack (the mixture's
    PHASE = 2 form, or a strategy's rate) against their plain versions on
    the same uniforms, at the homogeneous bar; the checking launches'
    pre-reject at 0 disagreements."""
    scene, packs = _mixture(cuda, name)
    kind = scene.medium.phase_kind
    assert packs[3].shape[0] > pk.MED_LEN
    n_rays, seed = packs[0].shape[1], 43
    kw = dict(seed=seed, phase_kind=kind)
    if kernel == "vrl_sum_clustered":
        sop, ids, w = _glossy_table(packs, cuda)
        u = (torch.rand((n_rays, ids.shape[1], 6), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(1))
             if injected else philox_table_uniforms(seed, sop, ids, 6))
        out = vrl_sum_clustered(*packs, sop, ids, w,
                                uniforms=u if injected else None, **kw)
        ref = vrl_sum_clustered_reference(*packs, sop, ids, w, u,
                                          phase_kind=kind)
        _, counts = vrl_sum_clustered_check(*packs, sop, ids, w, **kw)
        out, ref, channels = out.T, ref.T, 3
    else:
        fn, plain, chk = ((vrl_sum, vrl_sum_reference, vs.vrl_sum_check)
                          if kernel == "vrl_sum"
                          else (vrl_r, vrl_r_reference, vrl_r_check))
        if kernel == "vrl_r":
            packs = (packs[0][:, ::16].contiguous(), *packs[1:])
            n_rays = packs[0].shape[1]
        u = (torch.rand((n_rays, 512, 6), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(1))
             if injected else philox_uniforms(seed, n_rays, 512, 6,
                                              device=cuda))
        out = fn(*packs, uniforms=u if injected else None, **kw)
        ref = plain(*packs, u, phase_kind=kind)
        _, counts = chk(*packs, **kw)
        out, ref, channels = ((out[0], ref[0], 1) if kernel == "vrl_r"
                              else (out.T, ref.T, 3))
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and float(out.abs().sum()) > 0.0
    median, share = homog_bar(out, ref, channels)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    assert counts["bad_tris"] == 0 and counts["bad_segments"] == 0


def test_cuda_mixture_differs_from_its_hg_form(cuda):
    """The mixture's sums (balance strategy) are not the HG form's on the
    same samples and the same medium: the pack's components are read."""
    scene, packs = _mixture(cuda, "mixture_balance")
    hg = (*packs[:3], pk.pack_medium(replace(scene, medium=replace(
        scene.medium, phase_kind=0, phase_params=None))))
    a = vrl_sum(*packs, seed=5, phase_kind=4)
    b = vrl_sum(*hg, seed=5)
    assert float((a - b).abs().max()) > 1e-2 * float(b.abs().max())


@pytest.mark.parametrize("kernel", ["vrl_sum", "vrl_sum_clustered", "vrl_r"])
def test_cuda_strategy_differs_from_balance(cuda, kernel):
    """HG with the single strategy (channel 0's rate, 0.8 + sigma_a,
    against the other channels' sigma_t) is not HG with the balance
    strategy on the same samples: each kernel reads the pack's rate."""
    scene, packs = _mixture(cuda, "hg_single")
    bal = (*packs[:3], pk.pack_medium(replace(scene, medium=replace(
        scene.medium, strategy=0))))
    if kernel == "vrl_sum_clustered":
        sop, ids, w = _glossy_table(packs, cuda)
        a, b = (vrl_sum_clustered(*p, sop, ids, w, seed=5)
                for p in (packs, bal))
    else:
        fn = vrl_sum if kernel == "vrl_sum" else vrl_r
        a, b = (fn(*p, seed=5) for p in (packs, bal))
    assert float((a - b).abs().max()) > 1e-3 * float(b.abs().max())


@pytest.mark.parametrize("kernel", ["vrl_sum", "vrl_sum_clustered", "vrl_r"])
@pytest.mark.parametrize("injected", [True, False], ids=["injected", "philox"])
def test_cuda_mixture_material_kernels_match_plain(cuda, kernel, injected):
    """The PHASE = 2 material forms: the glossy box's material packs
    (KIND_RAYS eye rays of each of the eleven kinds) in the coloured
    mixture + single medium, against the plain versions at the
    homogeneous bar over each kind's rays alone, and their checking
    launches at 0 disagreements."""
    mats, packs, ray_kind, kinds = _glossy_by_kind(cuda)
    packs = (*packs[:3], _mixture(cuda, "mixture_single", 16)[1][3])
    n_rays, seed = packs[0].shape[1], 41
    kw = dict(seed=seed, phase_kind=4, materials=mats)
    pkw = dict(phase_kind=4, materials=mats)
    if kernel == "vrl_sum_clustered":
        sop, ids, w = _glossy_table(packs, cuda)
        u = (torch.rand((n_rays, ids.shape[1], 6), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(1))
             if injected else philox_table_uniforms(seed, sop, ids, 6))
        out = vrl_sum_clustered(*packs, sop, ids, w,
                                uniforms=u if injected else None, **kw)
        ref = vrl_sum_clustered_reference(*packs, sop, ids, w, u, **pkw)
        _, counts = vrl_sum_clustered_check(*packs, sop, ids, w, **kw)
    else:
        fn, plain, chk = ((vrl_sum, vrl_sum_reference, vs.vrl_sum_check)
                          if kernel == "vrl_sum"
                          else (vrl_r, vrl_r_reference, vrl_r_check))
        u = (torch.rand((n_rays, 512, 6), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(1))
             if injected else philox_uniforms(seed, n_rays, 512, 6,
                                              device=cuda))
        out = fn(*packs, uniforms=u if injected else None, **kw)
        ref = plain(*packs, u, **pkw)
        _, counts = chk(*packs, **kw)
    torch.cuda.synchronize()
    if kernel == "vrl_r":
        out, ref, channels = out[0], ref[0], 1
        item_kind = ray_kind[:, None].expand(-1, 512)
    else:
        out, ref, channels, item_kind = out.T, ref.T, 3, ray_kind
    assert torch.isfinite(out).all() and float(out.abs().sum()) > 0.0
    groups = homog_bar_by_kind(out, ref, item_kind, channels)
    assert set(groups) == kinds
    for k, (n, median, share) in groups.items():
        assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (k, n, median,
                                                               share)
    assert counts["bad_tris"] == 0 and counts["bad_segments"] == 0


@pytest.mark.parametrize("kind", [2, 3, 5])
def test_cuda_dispatch_refuses_an_unknown_phase_kind(cuda, kind):
    """A phase kind without an instantiation (the oriented kinds 2 and 3,
    and 5) launches nothing: the C entry returns an error, which the
    launch raises; the wrappers refuse it first by name."""
    scene, packs = _mixture(cuda, "mixture_single", 16)
    with pytest.raises(RuntimeError, match="invalid argument"):
        vs._launch(vs._library(), *packs, None, 0, 2, 2, True, kind)
    with pytest.raises(ValueError, match="not ported"):
        vrl_sum(*packs, phase_kind=kind)


def test_cuda_other_kernels_refuse_the_extended_pack(cuda):
    """The backward kernels 8 and 10 take the mixture or strategy pack in
    their extended forms: each matches its plain version (every output
    within 1e-3 of the largest entry of its plain twin; d_par's rate
    entry among them), counts its launch on mix_launches, and the
    differentiable render takes it."""
    scene, packs = _mixture(cuda, "mixture_single", 16)
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    gbar = torch.ones((3, n_rays), device=cuda)
    u = torch.rand((n_rays, n_vrls, 6), device=cuda,
                   generator=torch.Generator(cuda).manual_seed(9))
    before = (vrl_sum_bwd.mix_launches, cbwd.vrl_sum_clustered_bwd.mix_launches)
    out = vrl_sum_bwd(*packs, gbar, uniforms=u, phase_kind=4)
    ref = vrl_sum_bwd_reference(*packs, gbar, u, phase_kind=4)
    assert out[1].shape == (pk.MED_RHO + 1,) and float(ref[1][pk.MED_RHO]) != 0
    _rel_close(out, ref, 1e-3)
    tables = _tables(cuda, n_rays, n_vrls)
    uc = u[:, :tables[1].shape[1]].contiguous()
    out = cbwd.vrl_sum_clustered_bwd(*packs, *tables, gbar, uniforms=uc,
                                     phase_kind=4)
    ref = cbwd.vrl_sum_clustered_bwd_reference(*packs, *tables, gbar, uc,
                                               phase_kind=4)
    _rel_close(out, ref, 1e-3)
    assert (vrl_sum_bwd.mix_launches,
            cbwd.vrl_sum_clustered_bwd.mix_launches) == (before[0] + 1,
                                                         before[1] + 1)
    sigma_s = scene.medium.sigma_s.clone().requires_grad_()
    img = integrator.render_with_vrls_kernel_diff(
        replace(scene, medium=replace(scene.medium, sigma_s=sigma_s)),
        _bench_vrls(cuda), torch.Generator().manual_seed(0))
    (g,) = torch.autograd.grad(img.sum(), sigma_s)
    assert torch.isfinite(g).all() and bool((g != 0).all())
    assert vrl_sum_bwd.mix_launches == before[0] + 2


# glossy and layered surfaces in a grid medium (the material forms of
# kernels 3, 4 and 6) and on the large-mesh route (kernel 7's material
# and extended forms)

GLOSSY_GRID_SIZE = 128


def _glossy_grid(device, fast_tau):
    """torch_port_utils.glossy_scene_desc's box at GLOSSY_GRID_SIZE^2 in a
    seeded grid medium (8 x 9 x 10 voxels) read nearest or trilinearly,
    the bench VRLs: (scene, vrls, material pack, material packs, the
    diffuse packs)."""
    from alvrl_tpu_torch.scene import loader
    from torch_port_utils import glossy_scene_desc

    desc = glossy_scene_desc(GLOSSY_GRID_SIZE, GLOSSY_GRID_SIZE)
    desc["medium"] = {
        "type": "grid", "sigma_t": [0.8, 0.85, 0.9],
        "albedo": [0.9, 0.85, 0.8], "g": 0.3,
        "density": np.random.default_rng(19).uniform(
            0.2, 1.5, (8, 9, 10)).astype(np.float32).tolist()}
    scene = loader.build_scene(desc, device=device)
    scene = replace(scene, medium=replace(scene.medium, fast_tau=fast_tau))
    vrls = _bench_vrls(device)
    mats = integrator.material_pack(scene)
    packs = integrator.pack_frame(scene, vrls, materials=mats)[3]
    return scene, vrls, mats, packs, integrator.pack_frame(scene, vrls)[3]


@pytest.mark.parametrize("fast_tau", [True, False],
                         ids=["nearest", "trilinear"])
@pytest.mark.parametrize("kernel", ["vrl_sum_hetero",
                                    "vrl_sum_hetero_clustered",
                                    "vrl_r_hetero"])
def test_cuda_grid_material_forms_match_plain(cuda, kernel, fast_tau):
    """The material forms of kernels 3, 4 and 6 on the glossy box in a
    grid medium (KIND_RAYS eye rays of each kind x 512 VRLs; kernel 4 on
    a seeded table) against their plain versions on the same uniforms,
    at the homogeneous bar over all rays and over each kind's rays alone;
    each launch counted on the wrapper's mat_launches (and tri_launches
    for the trilinear read)."""
    _, _, mats, packs, _ = _glossy_grid(cuda, fast_tau)
    packs, ray_kind, kinds = _by_kind(mats, packs, pk.GRID_MATID, cuda, 19)
    assert len(kinds) >= 9 and pk.is_trilinear(packs[3]) != fast_tau
    n_rays, seed = packs[0].shape[1], 53
    kw = dict(materials=mats)
    fn = {"vrl_sum_hetero": vrl_sum_hetero,
          "vrl_sum_hetero_clustered": vrl_sum_hetero_clustered,
          "vrl_r_hetero": vrl_r_hetero}[kernel]
    before = (fn.mat_launches, fn.tri_launches)
    if kernel == "vrl_sum_hetero_clustered":
        sop, ids, w = _glossy_table(packs, cuda)
        u = torch.rand((n_rays, ids.shape[1], 6), device=cuda,
                       generator=torch.Generator(cuda).manual_seed(1))
        out = fn(*packs, sop, ids, w, seed=seed, uniforms=u, **kw)
        ref = vrl_sum_hetero_clustered_reference(*packs, sop, ids, w, u, **kw)
    else:
        u = torch.rand((n_rays, 512, 6), device=cuda,
                       generator=torch.Generator(cuda).manual_seed(1))
        out = fn(*packs, seed=seed, uniforms=u, **kw)
        plain = (vrl_sum_hetero_reference if kernel == "vrl_sum_hetero"
                 else vrl_r_hetero_reference)
        ref = plain(*packs, u, **kw)
    torch.cuda.synchronize()
    assert (fn.mat_launches - before[0], fn.tri_launches - before[1]) == (
        1, int(not fast_tau))
    if kernel == "vrl_r_hetero":
        out, ref, channels = out[0], ref[0], 1
        item_kind = ray_kind[:, None].expand(-1, 512)
    else:
        out, ref, channels, item_kind = out.T, ref.T, 3, ray_kind
    assert torch.isfinite(out).all() and float(out.abs().sum()) > 0.0
    median, share = homog_bar(out, ref, channels)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    for k, (n, median, share) in homog_bar_by_kind(out, ref, item_kind,
                                                   channels).items():
        assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (k, n, median,
                                                               share)


@pytest.mark.parametrize("fast_tau", [True, False],
                         ids=["nearest", "trilinear"])
def test_cuda_grid_material_checking_launches(cuda, fast_tau):
    """The checking forms of kernels 4 and 6's material forms on the
    glossy grid box: 0 disagreements of the plane pre-reject; their
    outputs the sums' (kernel 4's bit for bit)."""
    _, _, mats, packs, _ = _glossy_grid(cuda, fast_tau)
    sop, ids, w = _glossy_table(packs, cuda)
    out, counts = vrl_sum_hetero_clustered_check(*packs, sop, ids, w, seed=3,
                                                 materials=mats)
    assert counts["bad_tris"] == 0 and counts["bad_segments"] == 0
    assert counts["segments"] > 0 and counts["skipped"] > 0
    assert torch.equal(out, vrl_sum_hetero_clustered(
        *packs, sop, ids, w, seed=3, materials=mats))
    reps = (packs[0][:, ::64].contiguous(), *packs[1:])
    out, counts = vrl_r_hetero_check(*reps, seed=3, materials=mats)
    assert counts["bad_tris"] == 0 and counts["bad_segments"] == 0
    median, share = homog_bar(out[0], vrl_r_hetero(
        *reps, seed=3, materials=mats)[0], channels=1)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


def test_cuda_glossy_grid_table_never_takes_a_diffuse_form(cuda):
    """render_with_vrls_kernel and render_alvrl on the glossy grid box
    launch only the material forms of kernels 3, 6 and 4 (mat_launches
    as many as launches), with images brighter than the diffuse form's on
    the same packs (albedo 0 at every glossy hit); a material pack with
    the diffuse grid ray pack (no GRID_MATID row) raises."""
    scene, vrls, mats, packs, dpacks = _glossy_grid(cuda, True)
    fns = (vrl_sum_hetero, vrl_r_hetero, vrl_sum_hetero_clustered)
    before = [(f.launches, f.mat_launches) for f in fns]
    img = integrator.render_with_vrls_kernel(
        scene, vrls, torch.Generator().manual_seed(0))
    img_c, _, _ = alvrl.render_alvrl(
        scene, torch.Generator().manual_seed(1), alvrl.ALVRLParams(
            vrl_target_num=128, num_particles=32))
    torch.cuda.synchronize()
    for f, (n, m) in zip(fns, before):
        assert f.launches - n >= 1 and f.launches - n == f.mat_launches - m
    for im in (img, img_c):
        assert torch.isfinite(im).all() and float(im.abs().max()) > 0.0
    seed = integrator.draw_seed(torch.Generator().manual_seed(0))
    ours = vrl_sum_hetero(*packs, seed=seed, materials=mats)
    diffuse = vrl_sum_hetero(*dpacks, seed=seed)
    assert float(ours.sum()) > 1.05 * float(diffuse.sum())
    with pytest.raises(ValueError, match="rays must be"):
        vrl_sum_hetero(*dpacks, materials=mats)


@pytest.mark.parametrize("name", ["glossy", "mixture", "strategy"])
def test_cuda_bvh_material_and_extended_forms_match_plain(cuda, name):
    """Kernel 7 on the cube field (15,984 triangles) with the glossy
    box's table on its faces (the material form), or in the coloured
    mixture + single or HG + maximum medium (the extended forms), against
    its plain version on 256 rays and against kernel 1's matching form
    on a 24-triangle box through the same Wald test; the counting form's
    decisions equal to the needed traversal's."""
    from alvrl_tpu_torch.media import phase as ph

    scene = bbl.scene_of("cubes", 11, device=cuda)
    vrls = bbl.bench_vrls(scene)
    mats, kind = None, 0
    if name == "glossy":
        gscene = _glossy(cuda, 16)[0]
        n_mats = gscene.materials.kind.shape[0]
        ids = torch.arange(scene.faces.shape[0], device=cuda) % n_mats
        scene = replace(scene, materials=gscene.materials, material=ids)
        mats = integrator.material_pack(scene)
    else:
        kw = (dict(phase_kind=ph.MIXTURE, strategy=1, channel=1,
                   phase_params=ph.mixture_params(
                       [0.6, 0.3], [ph.HG, ph.RAYLEIGH], [0.8, 0.0],
                       device=cuda)) if name == "mixture"
              else dict(strategy=3))
        scene = replace(scene, medium=replace(
            scene.medium, sigma_s=torch.tensor(MIX_SIGMA_S, device=cuda),
            **kw))
        kind = scene.medium.phase_kind
    packs = integrator.pack_frame_bvh(scene, vrls, materials=mats)[3]
    assert packs[3].shape[0] > pk.MED_LEN or mats is not None
    mkw = dict(phase_kind=kind, materials=mats)
    counter = "mat_launches" if mats is not None else "mix_launches"
    before = getattr(vb.vrl_sum_bvh, counter)
    out = vb.vrl_sum_bvh(*packs, seed=61, **mkw)
    assert getattr(vb.vrl_sum_bvh, counter) - before == 1
    rows = bbl.subset_rays(packs[0].shape[1]).to(cuda)
    u = philox_uniforms(61, packs[0].shape[1], packs[1].shape[1], 6,
                        device=cuda)[rows].contiguous()
    ref = vb.vrl_sum_bvh_reference(packs[0][:, rows].contiguous(),
                                   *packs[1:], u, **mkw)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and float(out.abs().sum()) > 0.0
    median, share = homog_bar(out[:, rows].T, ref.T)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    _, counts = vb.vrl_sum_bvh_counts(*packs, seed=61, **mkw)
    assert counts["differ"] == 0 and counts["segments"] > 0
    # kernel 1's form on the box alone (24 triangles, the same Wald test)
    box = replace(scene, vertices=scene.vertices, faces=scene.faces[:24],
                  material=scene.material[:24])
    bpacks = integrator.pack_frame_bvh(box, vrls, materials=mats)[3]
    fpacks = (bpacks[0], bpacks[1], bpacks[2].tris, bpacks[3])
    a = vb.vrl_sum_bvh(*bpacks, seed=62, **mkw)
    b = vrl_sum(*fpacks, seed=62, **mkw)
    median, share = homog_bar(a.T, b.T)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


def test_cuda_bvh_render_takes_the_material_and_extended_forms(cuda):
    """render_with_vrls_kernel_bvh on the cube field with a glossy table
    launches kernel 7's material form, in a strategy medium its extended
    form; the images are finite and non-zero; the diffuse balance field
    still launches the plain-pack form (neither counter moves)."""
    scene = bbl.scene_of("cubes", 11, device=cuda)
    vrls = bbl.bench_vrls(scene)
    gscene = _glossy(cuda, 16)[0]
    ids = torch.arange(scene.faces.shape[0], device=cuda) % \
        gscene.materials.kind.shape[0]
    glossy = replace(scene, materials=gscene.materials, material=ids)
    strat = replace(scene, medium=replace(scene.medium, strategy=3))
    f = vb.vrl_sum_bvh
    for sc, moved in ((glossy, (1, 0)), (strat, (0, 1)), (scene, (0, 0))):
        before = (f.launches, f.mat_launches, f.mix_launches)
        img = integrator.render_with_vrls_kernel_bvh(
            sc, vrls, torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        assert (f.launches - before[0], f.mat_launches - before[1],
                f.mix_launches - before[2]) == (1, *moved)
        assert torch.isfinite(img).all() and float(img.abs().max()) > 0.0



# kernel 7's earlier forms on the cube field (scripts/kernel_digest.py
# --bvh on the tree before its material and extended forms, NVIDIA H100
# 80GB HBM3, 700.00 W)
PARENT_DIGESTS_BVH = {
    "vrl_sum_bvh injected":
        "6b6123ccb0b7320c301ea719616a409750fab615cae144d2aeba0410d5efa568",
    "vrl_sum_bvh philox":
        "6a4f5bbfd1bd875e3d6152edc901fa5433d54d297b837b3e95254fc581b6a50a",
    "vrl_sum_bvh rayleigh":
        "7f8f68d90e2fc7d9c5d26367f5fd4aacb89e153381cbce39d54e27d39f9ede3e",
    "vrl_sum_bvh long":
        "38583b4b462f264ad5535e857405ea001260a5cb650ecd8714327528f40212a2",
}


def test_cuda_earlier_forms_keep_their_outputs(cuda):
    """Every earlier form of the kernels that gained material or extended
    forms gives its recorded outputs bit for bit: kernels 1, 2 and 5
    (kernel_digest.py --all, chip_smoke.py's PARENT_DIGESTS_ALL), the
    nearest forms of kernels 3, 4 and 6 (--grid, PARENT_DIGESTS_GRID) and
    kernel 7 (--bvh, PARENT_DIGESTS_BVH)."""
    import importlib.util

    from alvrl_tpu_torch.scripts import kernel_digest

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert kernel_digest.kernel_digests(cuda, every_form=True) == \
        smoke.PARENT_DIGESTS_ALL
    assert kernel_digest.grid_digests(cuda) == smoke.PARENT_DIGESTS_GRID
    assert kernel_digest.bvh_digests(cuda) == PARENT_DIGESTS_BVH


# --- the textured forms of kernels 1, 2 and 5 (procedural and bitmap
# textures, normal and bump maps, the HK slab at the eye hit)

TEX_RAYS = 256  # eye rays of each material in the textured forms' holds


def _textured(device, size, tmp):
    """presets.cornell_textured_desc's box at size^2 (its bitmaps written
    into tmp), its material pack, the bench VRLs and its frame's textured
    packs."""
    from alvrl_tpu_torch.scene import loader

    scene = loader.build_scene(presets.cornell_textured_desc(
        str(tmp), size, size), device=device)
    vrls = _bench_vrls(device)
    mats = integrator.material_pack(scene)
    packs = integrator.pack_frame(scene, vrls, materials=mats)[3]
    return scene, vrls, mats, packs


def _textured_by_material(device, tmp):
    """_textured at 128x128, its ray pack cut to TEX_RAYS eye rays of each
    material the frame's rays hit (a seeded pick): (material pack, packs,
    the rays' material ids, the ids)."""
    _, _, mats, packs = _textured(device, 128, tmp)
    valid = packs[0][pk.VALID] > 0.5
    mid = packs[0][pk.MATID].long()
    ids = sorted(set(mid[valid].tolist()))
    rng = np.random.default_rng(21)
    pick = torch.as_tensor(np.concatenate([rng.choice(np.flatnonzero(
        ((mid == i) & valid).cpu().numpy()), TEX_RAYS, replace=False)
        for i in ids]), device=device)
    return (mats, (packs[0][:, pick].contiguous(), *packs[1:]), mid[pick],
            set(ids))


@pytest.mark.parametrize("kernel", ["vrl_sum", "vrl_sum_clustered", "vrl_r"])
@pytest.mark.parametrize("injected", [True, False], ids=["injected", "philox"])
def test_cuda_textured_kernels_match_plain(cuda, tmp_path, kernel, injected):
    """Each textured form on cornell_textured (TEX_RAYS eye rays of each
    material x 512 VRLs; kernel 2 on a seeded table) against its plain
    version on the same uniforms, at the homogeneous bar over all rays and
    over each material's rays alone (a bitmap, a procedural texture, the
    normal and bump maps and the HK slab each held by itself); its launch
    counted as a textured one."""
    mats, packs, ray_mat, ids = _textured_by_material(cuda, tmp_path)
    assert pk.is_textured(packs[0])
    n_rays, seed = packs[0].shape[1], 41
    kw = dict(seed=seed, materials=mats)
    fn = {"vrl_sum": vrl_sum, "vrl_sum_clustered": vrl_sum_clustered,
          "vrl_r": vrl_r}[kernel]
    before = (fn.launches, fn.tex_launches)
    if kernel == "vrl_sum_clustered":
        sop, t_ids, w = _glossy_table(packs, cuda)
        u = (torch.rand((n_rays, t_ids.shape[1], 6), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(2))
             if injected else philox_table_uniforms(seed, sop, t_ids, 6))
        out = vrl_sum_clustered(*packs, sop, t_ids, w,
                                uniforms=u if injected else None, **kw)
        ref = vrl_sum_clustered_reference(*packs, sop, t_ids, w, u,
                                          materials=mats)
    else:
        plain = vrl_sum_reference if kernel == "vrl_sum" else vrl_r_reference
        u = (torch.rand((n_rays, 512, 6), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(2))
             if injected else philox_uniforms(seed, n_rays, 512, 6,
                                              device=cuda))
        out = fn(*packs, uniforms=u if injected else None, **kw)
        ref = plain(*packs, u, materials=mats)
        if kernel == "vrl_r":
            out, ref = out[0], ref[0]
    torch.cuda.synchronize()
    assert (fn.launches - before[0], fn.tex_launches - before[1]) == (1, 1)
    assert torch.isfinite(out).all() and float(out.abs().sum()) > 0.0
    if kernel == "vrl_r":
        out_i, ref_i, channels = out, ref, 1
        item_mat = ray_mat[:, None].expand(-1, 512)
    else:
        out_i, ref_i, channels, item_mat = out.T, ref.T, 3, ray_mat
    median, share = homog_bar(out_i, ref_i, channels)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    groups = homog_bar_by_kind(out_i, ref_i, item_mat, channels)
    assert set(groups) == ids
    for k, (n, median, share) in groups.items():
        assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (
            k, n, median, share)


def test_cuda_textured_checking_launches(cuda, tmp_path):
    """The checking instantiations of the textured forms: 0 disagreements
    of the plane pre-reject, and their outputs the sums' (kernel 2's bit
    for bit)."""
    _, _, mats, packs = _textured(cuda, 32, tmp_path)
    out, counts = vs.vrl_sum_check(*packs, seed=3, materials=mats)
    assert counts["bad_tris"] == 0 and counts["bad_segments"] == 0
    assert counts["segments"] > 0
    assert torch.equal(out, vrl_sum(*packs, seed=3, materials=mats))
    sop, ids, w = _glossy_table(packs, cuda)
    out, counts = vrl_sum_clustered_check(*packs, sop, ids, w, seed=3,
                                          materials=mats)
    assert counts["bad_tris"] == 0 and counts["bad_segments"] == 0
    assert torch.equal(out, vrl_sum_clustered(*packs, sop, ids, w, seed=3,
                                              materials=mats))
    out, counts = vrl_r_check(*packs, seed=3, materials=mats)
    assert counts["bad_tris"] == 0 and counts["bad_segments"] == 0
    assert torch.equal(out, vrl_r(*packs, seed=3, materials=mats))


def test_cuda_textured_renders_take_the_textured_kernels(cuda, tmp_path):
    """render_with_vrls_kernel, the specular-chain render and render_alvrl
    on cornell_textured launch the textured forms of kernels 1, 5 and 2
    only; the images are finite and non-zero; the routes without a
    textured form (the differentiable ones) refuse the scene."""
    scene, vrls, _, _ = _textured(cuda, 16, tmp_path)
    fns = (vrl_sum, vrl_r, vrl_sum_clustered)
    before = [(f.launches, f.tex_launches) for f in fns]
    img = integrator.render_with_vrls_kernel(
        scene, vrls, torch.Generator().manual_seed(0))
    img_s = integrator.render_with_vrls_kernel_spec(
        scene, vrls, torch.Generator().manual_seed(0))
    img_c, _, _ = alvrl.render_alvrl(
        scene, torch.Generator().manual_seed(1), alvrl.ALVRLParams(
            vrl_target_num=128, num_particles=32))
    for f, (n, t) in zip(fns, before):
        assert f.launches > n and f.launches - n == f.tex_launches - t
    for im in (img, img_s, img_c):
        assert torch.isfinite(im).all() and float(im.abs().max()) > 0.0
    with pytest.raises(ValueError, match="A11a"):
        integrator.render_with_vrls_kernel_diff(
            scene, vrls, torch.Generator().manual_seed(0))


# --- the textured forms of kernels 3, 4 and 6 (cornell_textured's
# surfaces in a grid medium) and of kernel 7 (the cube field with them)

TEX_SEEN = ("bitmap", "checker", "grid", "noise", "hk", "normalmap",
            "bumpmap")


def _textured_grid(device, fast_tau, tmp, size=128):
    """cornell_textured's box at size^2 in a seeded grid medium (8 x 9 x 10
    voxels) read nearest or trilinearly, the bench VRLs: (scene, vrls,
    material pack, the grid textured packs)."""
    from alvrl_tpu_torch.scene import loader

    desc = presets.cornell_textured_desc(str(tmp), size, size)
    desc["medium"] = {
        "type": "grid", "sigma_t": [0.8, 0.85, 0.9],
        "albedo": [0.9, 0.85, 0.8], "g": 0.3,
        "density": np.random.default_rng(23).uniform(
            0.2, 1.5, (8, 9, 10)).astype(np.float32).tolist()}
    scene = loader.build_scene(desc, device=device)
    scene = replace(scene, medium=replace(scene.medium, fast_tau=fast_tau))
    vrls = _bench_vrls(device)
    mats = integrator.material_pack(scene)
    packs = integrator.pack_frame(scene, vrls, materials=mats)[3]
    return scene, vrls, mats, packs


def _pick_by_material(packs, row, device, seed):
    """TEX_RAYS eye rays of each material the packs' valid rays hit (a
    seeded pick; the material id in row `row`): (their packs, their
    material ids, the ids, the picked rays' indices)."""
    valid = packs[0][pk.VALID] > 0.5
    mid = packs[0][row].long()
    ids = sorted(set(mid[valid].tolist()))
    rng = np.random.default_rng(seed)
    pick = torch.as_tensor(np.concatenate([rng.choice(np.flatnonzero(
        ((mid == i) & valid).cpu().numpy()), TEX_RAYS, replace=False)
        for i in ids]), device=device)
    return ((packs[0][:, pick].contiguous(), *packs[1:]), mid[pick],
            set(ids), pick)


@pytest.mark.parametrize("fast_tau", [True, False],
                         ids=["nearest", "trilinear"])
@pytest.mark.parametrize("kernel", ["vrl_sum_hetero",
                                    "vrl_sum_hetero_clustered",
                                    "vrl_r_hetero"])
def test_cuda_grid_textured_forms_match_plain(cuda, tmp_path, kernel,
                                              fast_tau):
    """The textured forms of kernels 3, 4 and 6 on cornell_textured in a
    grid medium (TEX_RAYS eye rays of each material x 512 VRLs; kernel 4
    on a seeded table) against their plain versions on the same uniforms,
    at the homogeneous bar over all rays and over each material's rays
    alone; each launch counted on the wrapper's tex_launches (and
    tri_launches for the trilinear read)."""
    _, _, mats, packs = _textured_grid(cuda, fast_tau, tmp_path)
    assert packs[0].shape[0] == pk.GRID_TEX_RAY_ROWS
    packs, ray_mat, ids, _ = _pick_by_material(packs, pk.GRID_MATID, cuda,
                                               23)
    assert len(ids) == 7  # the seven materials the camera sees
    n_rays = packs[0].shape[1]
    kw = dict(materials=mats)
    fn = {"vrl_sum_hetero": vrl_sum_hetero,
          "vrl_sum_hetero_clustered": vrl_sum_hetero_clustered,
          "vrl_r_hetero": vrl_r_hetero}[kernel]
    before = (fn.tex_launches, fn.tri_launches)
    u_gen = torch.Generator(cuda).manual_seed(3)
    if kernel == "vrl_sum_hetero_clustered":
        sop, t_ids, w = _glossy_table(packs, cuda)
        u = torch.rand((n_rays, t_ids.shape[1], 6), device=cuda,
                       generator=u_gen)
        out = fn(*packs, sop, t_ids, w, uniforms=u, **kw)
        ref = vrl_sum_hetero_clustered_reference(*packs, sop, t_ids, w, u,
                                                 **kw)
    else:
        u = torch.rand((n_rays, 512, 6), device=cuda, generator=u_gen)
        out = fn(*packs, uniforms=u, **kw)
        plain = (vrl_sum_hetero_reference if kernel == "vrl_sum_hetero"
                 else vrl_r_hetero_reference)
        ref = plain(*packs, u, **kw)
    torch.cuda.synchronize()
    assert (fn.tex_launches - before[0], fn.tri_launches - before[1]) == (
        1, int(not fast_tau))
    if kernel == "vrl_r_hetero":
        out, ref, channels = out[0], ref[0], 1
        item_mat = ray_mat[:, None].expand(-1, 512)
    else:
        out, ref, channels, item_mat = out.T, ref.T, 3, ray_mat
    assert torch.isfinite(out).all() and float(out.abs().sum()) > 0.0
    median, share = homog_bar(out, ref, channels)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    groups = homog_bar_by_kind(out, ref, item_mat, channels)
    assert set(groups) == ids
    for k, (n, median, share) in groups.items():
        assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (k, n, median,
                                                               share)


@pytest.mark.parametrize("fast_tau", [True, False],
                         ids=["nearest", "trilinear"])
def test_cuda_grid_textured_checking_launches(cuda, tmp_path, fast_tau):
    """The checking forms of kernels 4 and 6's textured forms: 0
    disagreements of the plane pre-reject; their outputs the sums'
    (kernel 4's bit for bit, kernel 6's within the bar)."""
    _, _, mats, packs = _textured_grid(cuda, fast_tau, tmp_path, 32)
    sop, ids, w = _glossy_table(packs, cuda)
    out, counts = vrl_sum_hetero_clustered_check(*packs, sop, ids, w, seed=3,
                                                 materials=mats)
    assert counts["bad_tris"] == 0 and counts["bad_segments"] == 0
    assert counts["segments"] > 0 and counts["skipped"] > 0
    assert torch.equal(out, vrl_sum_hetero_clustered(
        *packs, sop, ids, w, seed=3, materials=mats))
    out, counts = vrl_r_hetero_check(*packs, seed=3, materials=mats)
    assert counts["bad_tris"] == 0 and counts["bad_segments"] == 0
    median, share = homog_bar(out[0], vrl_r_hetero(
        *packs, seed=3, materials=mats)[0], channels=1)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


def _textured_field(device, tmp, n_axis=11):
    """The cube field of n_axis^3 cubes with cornell_textured's surfaces
    (presets.textured_cube_field, TEX_SEEN on the cubes in turn) and its
    bench VRLs."""
    from alvrl_tpu_torch.scene import loader

    desc = presets.cornell_textured_desc(str(tmp), 16, 16)
    names = [m["name"] for m in desc["materials"]]
    field = presets.textured_cube_field(
        bbl.scene_of("cubes", n_axis, device=device),
        loader.build_scene(desc, device=device),
        [names.index(n) for n in TEX_SEEN])
    return field, bbl.bench_vrls(field)


def test_cuda_bvh_textured_form_matches_plain(cuda, tmp_path):
    """Kernel 7's textured form on the textured cube field (15,984
    triangles) against its plain version on TEX_RAYS rays of each
    material (Philox), over all of them and each material alone; its
    counting form's decisions the needed traversal's; against kernel 1's
    textured form on the field's box alone (the same Wald test)."""
    field, vrls = _textured_field(cuda, tmp_path)
    mats = integrator.material_pack(field)
    packs = integrator.pack_frame_bvh(field, vrls, materials=mats)[3]
    assert pk.is_textured(packs[0])
    before = (vb.vrl_sum_bvh.tex_launches, vb.vrl_sum_bvh.mat_launches)
    out = vb.vrl_sum_bvh(*packs, seed=71, materials=mats)
    assert (vb.vrl_sum_bvh.tex_launches - before[0],
            vb.vrl_sum_bvh.mat_launches - before[1]) == (1, 1)
    sub, ray_mat, ids, pick = _pick_by_material(packs, pk.MATID, cuda, 71)
    assert len(ids) == 7
    # the picked rays' Philox uniforms, at their frame indices
    u = vs.philox_draws(71, pick[:, None], torch.arange(
        packs[1].shape[1], device=cuda)[None], 6)
    ref = vb.vrl_sum_bvh_reference(*sub, u, materials=mats)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and float(out.abs().sum()) > 0.0
    o, r = out[:, pick].T, ref.T
    median, share = homog_bar(o, r)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    for k, (n, median, share) in homog_bar_by_kind(o, r, ray_mat).items():
        assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (k, n, median,
                                                               share)
    _, counts = vb.vrl_sum_bvh_counts(*packs, seed=71, materials=mats)
    assert counts["differ"] == 0 and counts["segments"] > 0
    box = replace(field, faces=field.faces[:12], material=field.material[:12],
                  face_uv=field.face_uv[:12])
    bpacks = integrator.pack_frame_bvh(box, vrls, materials=mats)[3]
    a = vb.vrl_sum_bvh(*bpacks, seed=72, materials=mats)
    b = vrl_sum(bpacks[0], bpacks[1], bpacks[2].tris, bpacks[3], seed=72,
                materials=mats)
    median, share = homog_bar(a.T, b.T)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


def test_cuda_grid_and_field_renders_take_the_textured_forms(cuda,
                                                             tmp_path):
    """render_with_vrls_kernel and render_alvrl on cornell_textured in a
    grid medium (either read) launch only the textured forms of kernels
    3, 6 and 4, render_with_vrls_kernel_bvh on the textured cube field
    only kernel 7's; the images are finite and non-zero; the
    differentiable grid routes refuse the scene by name."""
    fns = (vrl_sum_hetero, vrl_r_hetero, vrl_sum_hetero_clustered)
    for fast_tau in (True, False):
        scene, vrls, _, _ = _textured_grid(cuda, fast_tau, tmp_path, 16)
        before = [(f.launches, f.tex_launches) for f in fns]
        img = integrator.render_with_vrls_kernel(
            scene, vrls, torch.Generator().manual_seed(0))
        img_c, _, _ = alvrl.render_alvrl(
            scene, torch.Generator().manual_seed(1), alvrl.ALVRLParams(
                vrl_target_num=128, num_particles=32))
        torch.cuda.synchronize()
        for f, (n, t) in zip(fns, before):
            assert f.launches > n and f.launches - n == f.tex_launches - t
        for im in (img, img_c):
            assert torch.isfinite(im).all() and float(im.abs().max()) > 0.0
        with pytest.raises(ValueError, match="A11a"):
            integrator.render_with_vrls_kernel_diff(
                scene, vrls, torch.Generator().manual_seed(0))
    field, vrls = _textured_field(cuda, tmp_path, 3)
    f = vb.vrl_sum_bvh
    before = (f.launches, f.tex_launches)
    img = integrator.render_with_vrls_kernel_bvh(
        field, vrls, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    assert (f.launches - before[0], f.tex_launches - before[1]) == (1, 1)
    assert torch.isfinite(img).all() and float(img.abs().max()) > 0.0
