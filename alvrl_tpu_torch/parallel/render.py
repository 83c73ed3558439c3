"""The differentiable train step, on one device.

Counterpart of alvrl_tpu/parallel/render.py::train_step with
use_pallas=True on a one-device mesh (the mesh, and NCCL across cards,
come with the multi-GPU slice): trace VRLs, render through the kernel
pair (ops.vrl_sum forward, ops.vrl_sum_bwd seed-replay backward), take
an L2 image loss, and return its gradients in the medium coefficients
and the emitter intensities, the parameters BASELINE asks gradients
for. Differentiation goes through the tracer's throughput factors;
sampled positions are detached (the detached-sampling estimator). Every
homogeneous scene the forward renders is differentiated: a glossy or
layered table (the backward kernels' material forms; the material's own
parameters are constants, as in the JAX package's XLA route,
alvrl_tpu/parallel/render.py:217-222), a mixture phase (whose components
are constants, so g's gradient is 0) and a strategy other than balance
(its rate chaining to sigma_t).
"""

from __future__ import annotations

from dataclasses import replace

import torch

from alvrl_tpu_torch.integrators.vrl import tracer as tracer_mod
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.integrators.vrl.integrator import (
    refuse_textured,
    render_with_vrls_kernel_diff,
)
from alvrl_tpu_torch.scene.scene import Scene

PARAMS = ("sigma_a", "sigma_s", "g", "intensity")


def with_params(scene: Scene, params) -> Scene:
    """The scene with sigma_a, sigma_s, g and the emitter intensities
    replaced. The medium's sampling weight and the emitters' pmf stay
    the stored constants they are in the reference."""
    med = replace(scene.medium, sigma_a=params["sigma_a"],
                  sigma_s=params["sigma_s"], g=params["g"])
    em = replace(scene.emitters, intensity=params["intensity"])
    return replace(scene, medium=med, emitters=em)


def train_step(scene: Scene, generator, target, cfg: VRLConfig,
               num_particles: int = 8, tracer_cfg=None, *,
               tracer_uniforms=None, render_uniforms=None):
    """One step: (loss, {"sigma_a", "sigma_s", "g", "intensity"}
    gradients) of mean((img - target)^2) at the scene's parameters.

    The tracer's uniforms, then the render's seed, are drawn from
    `generator`. tracer_uniforms, a (u_emit, u_walk) pair for
    tracer.trace_u, and render_uniforms, as render_with_vrls_kernel's
    `uniforms`, replace them (for exact checks)."""
    refuse_textured(scene, "the train step (kernel 8)")
    if tracer_cfg is None:
        tracer_cfg = tracer_mod.TracerConfig(max_depth=4)
    params = {
        "sigma_a": scene.medium.sigma_a, "sigma_s": scene.medium.sigma_s,
        "g": scene.medium.g, "intensity": scene.emitters.intensity,
    }
    params = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
    sc = with_params(scene, params)
    if tracer_uniforms is None:
        vrls = tracer_mod.trace(sc, generator, num_particles, tracer_cfg)
    else:
        vrls = tracer_mod.trace_u(sc, *tracer_uniforms, tracer_cfg)
    img = render_with_vrls_kernel_diff(sc, vrls, generator, cfg,
                                       uniforms=render_uniforms)
    loss = torch.mean((img - target) ** 2)
    grads = torch.autograd.grad(loss, [params[k] for k in PARAMS])
    return loss.detach(), dict(zip(PARAMS, grads))
