"""The port's train step (alvrl_tpu_torch.parallel.render.train_step)
against alvrl_tpu's train_step(make_mesh(1), ..., use_pallas=True).

Both trace 8 particles to depth 4 on the same uniforms (the JAX key
tree rebuilt by torch_port_utils.jax_tracer_uniforms) and render
cornell_smoke 8x8 with the SEQ_UNIFORMS constants (the Pallas kernels
run in interpret mode with `_u01` patched in both kernel modules); the
loss and the four gradients must agree. On CPU tensors the port's
render backward is the plain version.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from alvrl_tpu.integrators.vrl import tracer as jtracer
from alvrl_tpu.integrators.vrl.integrate import VRLConfig as JVRLConfig
from alvrl_tpu.ops import vrl_pallas as vp
from alvrl_tpu.ops import vrl_pallas_bwd as vpb
from alvrl_tpu.parallel import render as jrender
from alvrl_tpu.parallel.mesh import make_mesh
from alvrl_tpu.scene import presets as jpresets
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.integrators.vrl import tracer
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.parallel.render import PARAMS, train_step
from alvrl_tpu_torch.scene import presets
from tests.torch_port_utils import (
    SEQ_UNIFORMS,
    in_child,
    jax_scene_leaves,
    jax_tracer_uniforms,
)

torch.set_num_threads(1)

W = H = 8
N_PARTICLES, DEPTH = 8, 4
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3  # the BASELINE bar


def _t(a):
    return torch.as_tensor(np.array(a))


def _target():
    return np.random.default_rng(0).uniform(0.0, 0.05, (H, W, 3)).astype(
        np.float32)


def _render_uniforms():
    return torch.tensor(SEQ_UNIFORMS).expand(
        W * H, N_PARTICLES * DEPTH, len(SEQ_UNIFORMS)).contiguous()


def _jax_scene():
    """cornell_smoke W x H with σ_a at twice the preset's and HG g = 0.4."""
    jscene = jpresets.cornell_smoke(width=W, height=H)
    return jscene.replace(medium=jscene.medium.replace(
        g=jnp.float32(0.4), sigma_a=jscene.medium.sigma_a * 2))


def _jax_step():
    """The JAX train_step on _jax_scene() in interpret mode, both kernel
    modules' _u01 returning the next SEQ_UNIFORMS constant at each call
    while traced (jit caches cleared around the patch): (loss, {param:
    gradient}, _u01 calls). Run by in_child."""
    counter = {"i": 0}

    def mock(shape):
        v = SEQ_UNIFORMS[counter["i"] % len(SEQ_UNIFORMS)]
        counter["i"] += 1
        return jnp.full(shape, v, jnp.float32)

    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp, \
            pltpu.force_tpu_interpret_mode():
        mp.setattr(vp, "_u01", mock)
        mp.setattr(vpb, "_u01", mock)
        loss, grads = jrender.train_step(
            make_mesh(1), _jax_scene(), jax.random.key(11),
            jnp.asarray(_target()), JVRLConfig(), num_particles=N_PARTICLES,
            tracer_cfg=jtracer.TracerConfig(max_depth=DEPTH),
            use_pallas=True)
        loss = np.asarray(loss)
        grads = {k: np.asarray(v) for k, v in grads.items()}
    jax.clear_caches()
    return loss, grads, counter["i"]


def test_train_step_matches_jax():
    """σ_a at twice the preset's, HG g = 0.4: loss to LOSS_RTOL and every
    gradient entry to GRAD_RTOL. The JAX step runs in a child process
    (tests/torch_port_utils.py in_child)."""
    jscene = _jax_scene()
    key = jax.random.key(11)
    ref_loss, ref_grads, n_draws = in_child(_jax_step)
    assert n_draws == 2 * len(SEQ_UNIFORMS)

    k_trace, _ = jax.random.split(key)
    u_emit, u_walk = jax_tracer_uniforms(k_trace, N_PARTICLES, DEPTH)
    loss, grads = train_step(
        convert.scene_from_numpy(jax_scene_leaves(jscene), device="cpu"),
        torch.Generator().manual_seed(0), _t(_target()), VRLConfig(),
        N_PARTICLES, tracer.TracerConfig(max_depth=DEPTH),
        tracer_uniforms=(_t(u_emit), _t(u_walk)),
        render_uniforms=_render_uniforms())
    assert float(loss) > 0.0
    torch.testing.assert_close(loss, _t(ref_loss), rtol=LOSS_RTOL, atol=0.0)
    for k in PARAMS:
        ref = _t(ref_grads[k])
        assert grads[k].shape == ref.shape, k
        assert float(grads[k].abs().min()) > 0.0, k
        torch.testing.assert_close(grads[k], ref, rtol=GRAD_RTOL, atol=0.0,
                                   msg=k)


def test_zero_intensity_channel_has_gradient():
    """ROADMAP C7 at the step: a light of intensity (8, 0, 8) gives VRL
    powers whose channel 1 is 0, where the reference's quotient
    cotangent of the power is 0. The loss is quadratic in intensity[1]
    and the walk does not depend on it (roulette reads the unitless
    throughput), so central differences through the whole step, on the
    same uniforms, give its derivative; the port's must match."""
    scene = presets.cornell_smoke(width=W, height=H, g=0.4,
                                  intensity=(8.0, 0.0, 8.0), device="cpu")
    rng = np.random.default_rng(4)
    u = (_t(rng.random((N_PARTICLES, tracer.N_EMIT_DIMS), np.float32)),
         _t(rng.random((N_PARTICLES, DEPTH, tracer.N_STEP_DIMS),
                       np.float32)))
    target = _t(_target())

    def step(intensity):
        sc = replace(scene, emitters=replace(scene.emitters,
                                             intensity=intensity))
        return train_step(sc, torch.Generator().manual_seed(0), target,
                          VRLConfig(), N_PARTICLES,
                          tracer.TracerConfig(max_depth=DEPTH),
                          tracer_uniforms=u,
                          render_uniforms=_render_uniforms())

    _, grads = step(scene.emitters.intensity)
    eps = 0.1
    shift = torch.tensor([[0.0, eps, 0.0]])
    fd = (float(step(scene.emitters.intensity + shift)[0])
          - float(step(scene.emitters.intensity - shift)[0])) / (2 * eps)
    ad = float(grads["intensity"][0, 1])
    assert fd != 0.0
    assert abs(ad - fd) <= 5e-3 * abs(fd), (ad, fd)


def test_train_step_draws_from_the_generator():
    """Without injected uniforms the step draws the tracer's uniforms and
    the render's seed from the generator: a seed repeats exactly, and
    the loss and gradients are finite."""
    scene = presets.cornell_smoke(width=4, height=4, device="cpu")
    target = torch.zeros((4, 4, 3))

    def step(seed):
        return train_step(scene, torch.Generator().manual_seed(seed), target,
                          VRLConfig(), 4, tracer.TracerConfig(max_depth=3))

    (l1, g1), (l2, g2), (l3, _) = step(1), step(1), step(2)
    assert float(l1) == float(l2) and float(l1) != float(l3)
    for k in PARAMS:
        assert torch.equal(g1[k], g2[k]) and torch.isfinite(g1[k]).all(), k
