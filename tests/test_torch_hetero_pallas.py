"""The grid-medium render and R of alvrl_tpu_torch against the JAX
package's Pallas grid kernels, run in interpret mode.

render_with_vrls_kernel and build_R_kernel on a grid medium (the grid
packs, the plain versions of vrl_sum_hetero and vrl_r_hetero) against
render_with_vrls_pallas_hetero and vrl_r_pallas_hetero on the same
uniforms. Those kernels read the density through a rank-K CP fit where
the port reads the grid (ROADMAP C9), so the bars are the CP-fit bars of
tests/test_hetero_pallas.py; the port is held to the XLA table path at
the homogeneous bar in tests/test_torch_hetero_render.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from alvrl_tpu.integrators.vrl import integrator as jintegrator
from alvrl_tpu.integrators.vrl.integrate import VRLConfig as JVRLConfig
from alvrl_tpu.ops import pack as jpk
from alvrl_tpu.ops import vrl_pallas as vp
from alvrl_tpu.sensors import perspective as jperspective
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.integrators.vrl import integrator
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from tests.test_torch_hetero_render import N_VRLS, _jax_scene, _jax_vrls
from tests.torch_port_utils import (
    SEQ_UNIFORMS,
    in_child,
    jax_scene_leaves,
    jax_vrls_leaves,
)

torch.set_num_threads(1)

CP_RANK = 16  # CP fit of the 8^3 plume: 7.4e-4 relative, under the JAX
              # package's fall-back threshold (CP_ERR_FALLBACK, 7e-3)
R_MEAN_FLOOR = 1e-9


def _interpret_refs():
    """The body of the `pallas_ref` fixture, run in a child process by
    in_child."""
    jscene = _jax_scene(8, 8, 8)
    jvrls = _jax_vrls()
    cp_pack, cp_err = jpk.pack_cp(jscene.medium, rank=CP_RANK)
    assert cp_err < jintegrator.CP_ERR_FALLBACK  # the kernel, not XLA
    px, py = jnp.meshgrid(jnp.arange(8), jnp.arange(8))
    ray_o, ray_d = jperspective.sample_ray(jscene.camera, px.reshape(-1),
                                           py.reshape(-1))
    counter = {"i": 0}

    def cycle(shape):
        v = SEQ_UNIFORMS[counter["i"] % len(SEQ_UNIFORMS)]
        counter["i"] += 1
        return jnp.full(shape, v, jnp.float32)

    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp, \
            pltpu.force_tpu_interpret_mode():
        mp.setattr(vp, "_u01", lambda shape: jnp.full(shape, 0.5,
                                                      jnp.float32))
        img = jintegrator.render_with_vrls_pallas_hetero(
            jscene, jvrls, jax.random.key(1),
            JVRLConfig(vol_vol_samples=1, vol_surf_samples=1),
            cp_rank=CP_RANK)
        mp.setattr(vp, "_u01", cycle)
        r = jintegrator._build_r_pallas_hetero_jit(
            jscene, ray_o, ray_d, jvrls, cp_pack,
            jnp.asarray([1], jnp.int32), JVRLConfig(), CP_RANK)
    jax.clear_caches()
    assert counter["i"] == len(SEQ_UNIFORMS)
    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device="cpu")
    vrls = convert.vrls_from_numpy(jax_vrls_leaves(jvrls), device="cpu")
    return dict(scene=scene, vrls=vrls, img=np.asarray(img),
                r=np.asarray(r)[:, :64, :N_VRLS],
                ray_o=torch.as_tensor(np.asarray(ray_o)),
                ray_d=torch.as_tensor(np.asarray(ray_d)))


@pytest.fixture(scope="module")
def pallas_ref():
    """The JAX package's unclustered grid render (fixed uniforms 0.5, 1 +
    1 samples) and its R over every pixel's centre ray (the 6-cycle, 2 +
    2 samples) through its Pallas grid kernels in interpret mode, with
    a rank-CP_RANK CP fit; the kernels' _u01 patched while they are
    traced, jit caches cleared around the patch. Computed in a child process
    (tests/torch_port_utils.py in_child)."""
    return in_child(_interpret_refs)


def test_render_matches_pallas_hetero_interpret(pallas_ref):
    """render_with_vrls_kernel on a grid medium (the grid packs, the
    plain grid sum, film) vs render_with_vrls_pallas_hetero at fixed
    uniforms: the CP-fit bar of tests/test_hetero_pallas.py:73-75."""
    cfg = VRLConfig(vol_vol_samples=1, vol_surf_samples=1)
    img = integrator.render_with_vrls_kernel(
        pallas_ref["scene"], pallas_ref["vrls"],
        torch.Generator().manual_seed(0), cfg,
        uniforms=torch.full((64, N_VRLS, 3), 0.5)).numpy()
    ref = pallas_ref["img"]
    assert img.shape == (8, 8, 3) and ref.mean() > 0.0
    rel = np.abs(img - ref) / np.maximum(ref, 1e-3)
    assert rel.mean() < 5e-3, rel.mean()
    assert rel.max() < 0.03, rel.max()


def test_build_R_matches_pallas_hetero_interpret(pallas_ref):
    """build_R_kernel on a grid medium vs _build_r_pallas_hetero_jit, the
    6-cycle, normalised alike: the CP-fit bars of
    tests/test_hetero_pallas.py:259-264 on the means."""
    mean, var = integrator.build_R_kernel(
        pallas_ref["scene"], pallas_ref["ray_o"], pallas_ref["ray_d"],
        pallas_ref["vrls"], 0, VRLConfig(),
        uniforms=torch.tensor(SEQ_UNIFORMS).expand(64, N_VRLS, 6)
        .contiguous())
    norm = 1.0 / 78.0
    ref = pallas_ref["r"][0] * norm
    mean = mean.numpy()
    nz = ref > R_MEAN_FLOOR * norm
    assert nz.sum() > 100 and float(var.max()) > 0.0
    rel = np.abs(mean - ref)[nz] / ref[nz]
    assert np.median(rel) < 2e-3, np.median(rel)
    assert np.abs(mean - ref)[nz].sum() / ref[nz].sum() < 2e-3
    big = nz & (ref > np.quantile(ref[nz], 0.5))
    assert (np.abs(mean - ref)[big] / ref[big] > 0.03).mean() < 0.02
