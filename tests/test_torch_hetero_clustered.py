"""The clustered render of alvrl_tpu_torch in a grid medium against
alvrl_tpu.

The plain version of the grid clustered kernel
(ops.vrl_sum_clustered.vrl_sum_hetero_clustered), reached through
integrator.render_clustered_kernel, on the JAX package's own tables
(prepare_clustering(use_pallas=True), whose R goes through its Pallas
grid R kernel) against vrl_sum_pallas_hetero_clustered in interpret mode
on the same uniforms, at the CP-fit bar of tests/test_hetero_pallas.py
(ROADMAP C9); the whole pass (alvrl.render_alvrl) against the port's
unclustered grid render; the identity that ties the grid clustered sum
to the grid sum. The kernels themselves run only on a CUDA card: see
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from alvrl_tpu.integrators.vrl import alvrl as jalvrl
from alvrl_tpu.integrators.vrl import cluster as jcl
from alvrl_tpu.integrators.vrl import integrator as jintegrator
from alvrl_tpu.integrators.vrl.integrate import VRLConfig as JVRLConfig
from alvrl_tpu.ops import vrl_pallas as vp
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.integrators.vrl import alvrl, integrator
from alvrl_tpu_torch.integrators.vrl import cluster as cl
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.integrators.vrl.tracer import TracerConfig
from alvrl_tpu_torch.ops.vrl_r import vrl_r_hetero
from alvrl_tpu_torch.ops.vrl_sum import (
    HOMOG_MEDIAN,
    HOMOG_SHARE,
    homog_bar,
    vrl_sum_hetero,
)
from alvrl_tpu_torch.ops.vrl_sum_clustered import (
    philox_table_uniforms,
    vrl_sum_hetero_clustered,
    vrl_sum_hetero_clustered_reference,
)
from alvrl_tpu_torch.scene import presets
from tests.test_torch_hetero_pallas import CP_RANK
from tests.test_torch_hetero_render import N_VRLS, _jax_scene, _jax_vrls
from tests.torch_port_utils import (
    SEQ_UNIFORMS,
    in_child,
    jax_scene_leaves,
    jax_vrls_leaves,
)

torch.set_num_threads(1)

W = H = 16
SLICING = dict(target_num_slices=8, target_pixel_undersampling=8.0)
BAND = (0.85, 1.15)  # clustered / unclustered image mean over 3 seeds


def _interpret_refs():
    """The body of the `jax_ref` fixture, run in a child process by
    in_child."""
    jscene = _jax_scene(W, H, 8)
    jvrls = _jax_vrls()
    jparams = jalvrl.ALVRLParams(vrl_target_num=N_VRLS,
                                 cluster=jcl.ClusterParams(**SLICING))
    counter = {"i": 0}

    def cycle(shape):
        v = SEQ_UNIFORMS[counter["i"] % len(SEQ_UNIFORMS)]
        counter["i"] += 1
        return jnp.full(shape, v, jnp.float32)

    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp, \
            pltpu.force_tpu_interpret_mode():
        mp.setattr(vp, "_u01", cycle)
        mp.setattr(jintegrator, "CP_RANK", CP_RANK)
        sop, tv, tw, _ = jalvrl.prepare_clustering(
            jscene, jvrls, None, jparams, JVRLConfig(), use_pallas=True)
        img = jintegrator.render_clustered_pallas_hetero(
            jscene, jvrls, sop, tv, tw, jax.random.key(3), JVRLConfig(),
            cp_rank=CP_RANK)
    jax.clear_caches()
    assert counter["i"] == 2 * len(SEQ_UNIFORMS)  # one trace of each kernel
    return dict(sop=np.asarray(sop), tv=np.asarray(tv), tw=np.asarray(tw),
                img=np.asarray(img),
                scene=convert.scene_from_numpy(jax_scene_leaves(jscene),
                                               device="cpu"),
                vrls=convert.vrls_from_numpy(jax_vrls_leaves(jvrls),
                                             device="cpu"))


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's clustered prepass with its Pallas grid R kernel
    (rank-CP_RANK CP fit) and its grid clustered render on those tables,
    both in interpret mode, with the kernels' _u01 returning the next
    SEQ_UNIFORMS constant at each call while traced (jit caches cleared
    around the patch). Computed in a child process
    (tests/torch_port_utils.py in_child)."""
    return in_child(_interpret_refs)


def test_render_clustered_matches_pallas_hetero_interpret(jax_ref):
    """render_clustered_kernel on a grid medium and the JAX package's own
    tables vs render_clustered_pallas_hetero: the CP-fit bar of
    tests/test_hetero_pallas.py:73-75."""
    sop, tv, tw = convert.cluster_tables_from_numpy(
        jax_ref["sop"], jax_ref["tv"], jax_ref["tw"], device="cpu")
    img = integrator.render_clustered_kernel(
        jax_ref["scene"], jax_ref["vrls"], sop, tv, tw,
        torch.Generator().manual_seed(0), VRLConfig(),
        uniforms=torch.tensor(SEQ_UNIFORMS).expand(W * H, tv.shape[1], 6)
        .contiguous()).numpy()
    ref = jax_ref["img"]
    assert img.shape == (H, W, 3) and ref.mean() > 0.0
    rel = np.abs(img - ref) / np.maximum(ref, 1e-3)
    assert rel.mean() < 5e-3, rel.mean()
    assert rel.max() < 0.03, rel.max()


def test_render_alvrl_in_a_grid_end_to_end():
    """One clustered pass per seed on the CPU in cornell_grid_smoke: a
    finite, positive image, and over 3 seeds the mean clustered image
    lies within BAND of the mean unclustered image of the same VRLs."""
    scene = presets.cornell_grid_smoke(W, H, grid_res=8, device="cpu")
    params = alvrl.ALVRLParams(vrl_target_num=N_VRLS, num_particles=16,
                               cluster=cl.ClusterParams(**SLICING))
    tcfg = TracerConfig(max_depth=8)
    info = alvrl.build_slice_info(scene, params)
    launches = (vrl_r_hetero.launches, vrl_sum_hetero_clustered.launches)
    clustered, unclustered = [], []
    for seed in range(3):
        img, vrls, packed = alvrl.render_alvrl(
            scene, torch.Generator().manual_seed(seed), params, VRLConfig(),
            tcfg, slice_info=info)
        assert img.shape == (H, W, 3) and torch.isfinite(img).all()
        assert float(img.min()) >= 0.0 and float(img.mean()) > 0.0
        clustered.append(float(img.mean()))
        unclustered.append(float(integrator.render_with_vrls_kernel(
            scene, vrls, torch.Generator().manual_seed(100 + seed)).mean()))
    ratio = np.mean(clustered) / np.mean(unclustered)
    assert BAND[0] < ratio < BAND[1], (ratio, clustered, unclustered)
    assert (vrl_r_hetero.launches,
            vrl_sum_hetero_clustered.launches) == launches


def _grid_packs(width=8, height=8, n_vrls=48):
    scene = presets.cornell_grid_smoke(width, height, grid_res=8, device="cpu")
    vrls = convert.vrls_from_numpy(jax_vrls_leaves(_jax_vrls(n_vrls)),
                                   device="cpu")
    return integrator.pack_frame(scene, vrls)[3]


def test_identity_table_reproduces_vrl_sum_hetero():
    """A table whose one row holds every VRL at weight 1 gives
    vrl_sum_hetero's result on the same rays and seed (both key the
    stream by (pixel, VRL id)), its VRL-OD rows gathered by id."""
    packs = _grid_packs()
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    ids = torch.arange(n_vrls, dtype=torch.int32)[None]
    out = vrl_sum_hetero_clustered(*packs, np.zeros(n_rays, np.int64), ids,
                                   torch.ones((1, n_vrls)), seed=11)
    ref = vrl_sum_hetero(*packs, seed=11)
    assert float(ref.abs().sum()) > 0.0
    median, share = homog_bar(out.T, ref.T)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


def test_grid_clustered_weights_and_fallback_rows():
    """Weights multiply the power; rows -1 sum to 0; the wrapper on the
    CPU is the plain version on the table-indexed Philox stream."""
    packs = _grid_packs(6, 6)
    n_rays = packs[0].shape[1]
    rows = np.arange(n_rays) % 3 - 1
    ids = torch.tensor([[5, 9, 30], [1, 2, 3]], dtype=torch.int32)
    one = vrl_sum_hetero_clustered(*packs, rows, ids, torch.ones((2, 3)),
                                   seed=2)
    two = vrl_sum_hetero_clustered(*packs, rows, ids, torch.full((2, 3), 2.0),
                                   seed=2)
    torch.testing.assert_close(two, 2.0 * one, rtol=1e-6, atol=0.0)
    assert not one[:, rows < 0].any() and float(one.abs().sum()) > 0.0
    u = philox_table_uniforms(2, rows, ids, 6)
    assert torch.equal(one, vrl_sum_hetero_clustered_reference(
        *packs, rows, ids, torch.ones((2, 3)), u))
