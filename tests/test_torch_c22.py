"""ROADMAP C22: the JAX package's Pallas differentiable routes
(render_with_vrls_pallas_diff over ops/vrl_pallas_bwd.py) differentiate
an image without the glossy term (their ray packs zero the albedo of
every non-diffuse hit, C21; and they take HG(g) under balance, C16, and
CP reads in a grid medium, C9), while the port's backward follows the
XLA route, which evaluates the eye hit's smooth BSDF. On pinned uniforms
the Pallas gradient in the VRL powers equals the port's plain backward
on the diffuse pack (albedo 0 at the glossy hits) and not the port's
differentiable route, which takes the material forms. The JAX side runs
in interpret mode in a child process (torch_port_utils.in_child); about
45 s alone.
"""

import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvrl_tpu_torch import convert
from alvrl_tpu_torch.bsdf import api as bsdf
from alvrl_tpu_torch.integrators.vrl import integrator
from alvrl_tpu_torch.ops import vrl_sum as vs
from alvrl_tpu_torch.ops.vrl_sum_bwd import vrl_sum_diff
from alvrl_tpu_torch.scene import loader
from tests.torch_port_utils import (
    BENCH_VRLS,
    CPU,
    SEQ_UNIFORMS,
    glossy_scene_desc,
    in_child,
    jax_vrls_leaves,
)

torch.set_num_threads(1)

N_VRLS = 64
# the glossy table's two coats swapped for plastic and rough plastic, as
# tests/test_torch_bvh_glossy.py's C21_SWAP (no rough-transmittance table
# to build in the child)
C21_SWAP = {"co": "pl", "rco": "rp"}


def _desc():
    """glossy_scene_desc with its coats swapped out (C21_SWAP): a table
    whose JAX build needs no rough-transmittance table."""
    desc = glossy_scene_desc()
    return json.loads(json.dumps(dict(
        desc, materials=[m for m in desc["materials"]
                         if m["name"] not in C21_SWAP],
        shapes=[dict(sh, material=C21_SWAP.get(sh["material"],
                                               sh["material"]))
                for sh in desc["shapes"]])))


def _weight():
    return np.random.default_rng(7).uniform(0.5, 1.5, (8, 8, 3)).astype(
        np.float32)


def _jax_vrls():
    from alvrl_tpu.integrators.vrl import vrl as jvrl
    full = jvrl.load_ascii(BENCH_VRLS, particle_count=78.0)
    return full.replace(start=full.start[:N_VRLS], end=full.end[:N_VRLS],
                        power=full.power[:N_VRLS], valid=full.valid[:N_VRLS])


def _pallas_power_grad():
    """jax.grad of sum(weight * render_with_vrls_pallas_diff) in the VRL
    powers, in interpret mode, both kernel modules' _u01 returning the
    next SEQ_UNIFORMS constant at each call while traced; (grad, the
    VRLs' leaves). Run by in_child."""
    from jax.experimental.pallas import tpu as pltpu

    from alvrl_tpu.integrators.vrl import integrator as jintegrator
    from alvrl_tpu.integrators.vrl.integrate import VRLConfig as JVRLConfig
    from alvrl_tpu.ops import vrl_pallas as vp
    from alvrl_tpu.ops import vrl_pallas_bwd as vpb
    from alvrl_tpu.scene import loader as jloader

    calls = {"i": 0}

    def mock(shape):
        v = SEQ_UNIFORMS[calls["i"] % len(SEQ_UNIFORMS)]
        calls["i"] += 1
        return jnp.full(shape, v, jnp.float32)

    jscene = jloader.build_scene(_desc())
    jv = _jax_vrls()
    weight = jnp.asarray(_weight())

    def loss(power):
        img = jintegrator.render_with_vrls_pallas_diff(
            jscene, jv.replace(power=power), jax.random.key(1),
            JVRLConfig())
        return jnp.sum(weight * img)

    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp, \
            pltpu.force_tpu_interpret_mode():
        mp.setattr(vp, "_u01", mock)
        mp.setattr(vpb, "_u01", mock)
        grad = np.asarray(jax.grad(loss)(jv.power))
    jax.clear_caches()
    return grad, jax_vrls_leaves(jv), calls["i"]


def test_c22_jax_pallas_gradient_drops_the_glossy_term():
    """On the coat-free glossy box, 8x8 rays against 64 bench VRLs, with
    every pair's draws pinned to SEQ_UNIFORMS: the JAX Pallas route's
    d sum(weight * image) / d power equals the port's plain backward on
    the diffuse pack at the homogeneous bar, and the port's
    differentiable route (the material forms) gives a gradient more than
    5 % larger."""
    ref, leaves, n_draws = in_child(_pallas_power_grad)
    # each trace of the two kernels draws the six constants in order
    assert n_draws >= 2 * len(SEQ_UNIFORMS)
    assert n_draws % len(SEQ_UNIFORMS) == 0
    ref = torch.as_tensor(ref)
    scene = loader.build_scene(_desc(), device=CPU)
    assert bsdf.has_glossy(bsdf.check_kinds(scene))
    vrls = convert.vrls_from_numpy(leaves, device=CPU)
    u = torch.tensor(SEQ_UNIFORMS).expand(64, N_VRLS, 6).contiguous()
    weight = torch.as_tensor(_weight())

    def grad(route):
        power = vrls.power.clone().requires_grad_()
        v = replace(vrls, power=power)
        if route == "diffuse pack":
            px, py, hit, packs = integrator.pack_frame(scene, v)
            img = integrator.develop_sums(scene, v, px, py, hit,
                                          vrl_sum_diff(*packs, uniforms=u))
        else:
            img = integrator.render_with_vrls_kernel_diff(
                scene, v, torch.Generator().manual_seed(0), uniforms=u)
        return torch.autograd.grad((img * weight).sum(), power)[0]

    diffuse = grad("diffuse pack")
    median, share = vs.homog_bar(diffuse, ref)
    assert median < vs.HOMOG_MEDIAN and share < vs.HOMOG_SHARE, (median,
                                                                 share)
    glossy = grad("route")
    assert float(glossy.sum()) > 1.05 * float(ref.sum())
