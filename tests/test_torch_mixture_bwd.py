"""The gradient of the mixture phase and of the sampling strategies in
alvrl_tpu_torch against alvrl_tpu, on the same numpy-made inputs:
tests/test_torch_phase_strategy.py's box (8x8 rays, 128 bench VRLs) in a
mixture + single medium and in an HG medium under each of the four
strategies.

ops.vrl_sum_bwd.vrl_sum_diff (its backward on CPU tensors the plain
version behind kernel 8's extended forms), on the port's packs built from
the medium's parameters (ops.pack.pack_medium's extended pack, whose rate
is media.homogeneous sampling_density of them), against jax.value_and_grad
of JAX's XLA pair_contribution with the medium rebuilt from the same
parameters inside the trace, so that its sampling_density is
differentiated too: d sigma_a, d sigma_s and d g to PAR_RTOL (d sigma_t
reaches the single and maximum strategies' rate through the pack's rate
entry; d g is 0 for the mixture, whose components are constants), d
power at the homogeneous bar. Kernel 10's plain extended VJP against
kernel 8's on a table of every VRL. About 80 s alone, most of it JAX's
five compiles.
"""

import functools
import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvrl_tpu.integrators.vrl import integrate as jintegrate
from alvrl_tpu.integrators.vrl import integrator as jintegrator
from alvrl_tpu.integrators.vrl.integrate import VRLConfig as JVRLConfig
from alvrl_tpu.scene import loader as jloader
from alvrl_tpu_torch.integrators.vrl import integrator
from alvrl_tpu_torch.media import homogeneous as hmed
from alvrl_tpu_torch.media import phase as ph
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops import vrl_sum as vs
from alvrl_tpu_torch.ops import vrl_sum_bwd as bwd
from alvrl_tpu_torch.ops import vrl_sum_clustered_bwd as cb
from alvrl_tpu_torch.scene import loader
from tests.test_torch_phase_strategy import N_VRLS, SCENE, _rays, _vrls
from tests.torch_port_utils import CPU

torch.set_num_threads(1)

PAR_RTOL = 1e-4  # scalars against XLA AD (tests/test_torch_hetero_bwd_table.py)
SVV = SVS = 1  # one sample of each family: half the JAX graph to compile
# the medium's phase, strategy and the options of both, for each case
CASES = {
    "mixture_single": (SCENE["medium"]["phase"], "single", {"channel": 1}),
    "balance": ("hg", "balance", {"g": 0.3}),
    "single": ("hg", "single", {"g": 0.3, "channel": 2}),
    "manual": ("hg", "manual", {"g": 0.3, "density": 0.9}),
    "maximum": ("hg", "maximum", {"g": 0.3}),
}
PARAM_KEYS = ("sigma_a", "sigma_s", "g")


def _t(a):
    return torch.as_tensor(np.array(a))


@functools.lru_cache(maxsize=None)
def _scenes(case):
    phase, strategy, opts = CASES[case]
    desc = json.loads(json.dumps(SCENE))
    med = {k: v for k, v in desc["medium"].items() if k != "channel"}
    desc["medium"] = dict(med, phase=phase, strategy=strategy, **opts)
    return jloader.build_scene(desc), loader.build_scene(desc, device=CPU)


@functools.lru_cache(maxsize=None)
def _jax_grad(case):
    """jax.value_and_grad of sum(gbar * the per-ray sums of
    pair_contribution) in {sigma_a, sigma_s, g, power}, the medium (and
    its sampling_density) rebuilt from them in the trace."""
    jscene0, _ = _scenes(case)

    def f(params, hit_f, ray_o, ray_d, u, gbar, start, end, valid):
        med = jscene0.medium.replace(**{k: params[k] for k in PARAM_KEYS})
        b, n = ray_o.shape[0], start.shape[0]
        ex = lambda a: a[:, None] if a.ndim == 1 else a[:, None, :]  # noqa
        hit = dict(zip(("p", "valid", "ng", "mat"), hit_f))
        total, _, _ = jintegrate.pair_contribution(
            jscene0.replace(medium=med), ex(ray_o), ex(ray_d), ex(hit['p']),
            ex(hit['valid']), ex(hit['ng']), ex(hit['mat']), start[None], end[None],
            params["power"][None], valid[None],
            u[..., :2 * SVV].reshape(b, n, SVV, 2), u[..., 2 * SVV:],
            JVRLConfig(vol_vol_samples=SVV, vol_surf_samples=SVS))
        return jnp.sum(gbar * total.sum(axis=1).T)

    return jax.jit(jax.value_and_grad(f))


def _inputs():
    rng = np.random.default_rng(22)
    return (rng.random((64, N_VRLS, 2 * SVV + SVS), dtype=np.float32),
            rng.uniform(0.5, 1.5, (3, 64)).astype(np.float32))


def _port_loss(scene, vrls, ray_o, ray_d, params, u, gbar):
    """sum(gbar * vrl_sum_diff) on the port's packs built from the medium
    parameters `params` (the extended pack's rate among them); the
    packs."""
    med = replace(scene.medium, **{k: params[k] for k in PARAM_KEYS})
    sc = replace(scene, medium=med)
    vrls = replace(vrls, power=params["power"])
    _, packs = integrator.pack_rays_vrls(sc, ray_o, ray_d, vrls)
    out = bwd.vrl_sum_diff(*packs, uniforms=u, vol_vol_samples=SVV,
                           vol_surf_samples=SVS, phase_kind=med.phase_kind)
    return (out.double() * gbar.double()).sum(), packs


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_extended_vjp_matches_xla_ad(case):
    """The gradient of sum(gbar * sums) in sigma_a, sigma_s, g and the
    VRL powers through the port's extended pack and its plain backward
    (kernel 8x's plain version, the balance one for `balance`) against
    XLA AD of pair_contribution: the loss to 1e-5, the scalars to
    PAR_RTOL, d g exactly 0 for the mixture, d power at the homogeneous
    bar."""
    jscene, scene = _scenes(case)
    jv, vrls = _vrls()
    ray_o, ray_d = _rays()
    u, gbar = _inputs()
    med = jscene.medium
    jparams = {k: getattr(med, k) for k in PARAM_KEYS}
    jparams["power"] = jv.power
    hit = jintegrator.trace_eye_rays(jscene, ray_o, ray_d)
    ref_loss, ref = _jax_grad(case)(jparams, (hit.p, hit.valid, hit.ng, hit.mat),
                                    ray_o, ray_d,
                                    jnp.asarray(u), jnp.asarray(gbar),
                                    jv.start, jv.end, jv.valid)
    params = {k: _t(v).clone().requires_grad_() for k, v in jparams.items()}
    loss, packs = _port_loss(scene, vrls, _t(ray_o), _t(ray_d), params,
                             _t(u), _t(gbar))
    extended = case != "balance"
    assert (packs[3].shape[0] > pk.MED_LEN) == extended
    if extended:
        assert packs[3].requires_grad and packs[3].grad_fn is not None
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    assert abs(float(loss.detach()) - float(ref_loss)) \
        <= 1e-5 * abs(float(ref_loss))
    for k in PARAM_KEYS:
        out, r = grads[k].reshape(-1), _t(ref[k]).reshape(-1)
        for o_i, r_i in zip(out.tolist(), r.tolist()):
            if case == "mixture_single" and k == "g":
                assert o_i == 0.0 and r_i == 0.0
                continue
            assert abs(o_i - r_i) <= PAR_RTOL * abs(r_i), (k, o_i, r_i)
    median, share = vs.homog_bar(grads["power"], _t(ref["power"]))
    assert median < vs.HOMOG_MEDIAN and share < vs.HOMOG_SHARE, (median,
                                                                 share)


def test_rate_cotangent_reaches_sigma_t():
    """Under the single strategy on channel 2 the pack's rate is sigma_t
    of channel 2: d_par's rate entry (MED_RHO) is non-zero and autograd
    adds it to d sigma_a[2] and d sigma_s[2] only; under manual it
    reaches no channel."""
    _, scene = _scenes("single")
    _, vrls = _vrls()
    ray_o, ray_d = (_t(a) for a in _rays())
    u, gbar = (_t(a) for a in _inputs())
    _, packs = integrator.pack_rays_vrls(scene, ray_o, ray_d, vrls)
    d_power, d_par, d_tau = bwd.vrl_sum_bwd(
        *packs, gbar, uniforms=u, vol_vol_samples=SVV, vol_surf_samples=SVS,
        phase_kind=ph.HG)
    assert d_par.shape == (pk.MED_RHO + 1,) and float(d_par[7]) == 0.0
    assert float(d_par[pk.MED_RHO]) != 0.0
    sigma_t = scene.medium.sigma_t.clone().requires_grad_()
    rate = replace(scene.medium, sigma_a=sigma_t - scene.medium.sigma_s)
    (g,) = torch.autograd.grad(rate.sampling_density, sigma_t)
    assert g.tolist() == [0.0, 0.0, 1.0]
    manual = replace(scene.medium, strategy=hmed.MANUAL, density=0.9)
    assert not manual.sampling_density.requires_grad


def test_plain_clustered_extended_vjp_matches_the_unclustered():
    """Kernel 10x's plain version (the mixture + single medium) on a table
    whose one row holds every VRL at weight 1 gives kernel 8x's
    cotangents, d_par's rate entry included."""
    _, scene = _scenes("mixture_single")
    _, vrls = _vrls()
    ray_o, ray_d = (_t(a) for a in _rays())
    u, gbar = (_t(a) for a in _inputs())
    _, packs = integrator.pack_rays_vrls(scene, ray_o, ray_d, vrls)
    kw = dict(uniforms=u, vol_vol_samples=SVV, vol_surf_samples=SVS,
              phase_kind=ph.MIXTURE)
    ref = bwd.vrl_sum_bwd(*packs, gbar, **kw)
    ids = torch.arange(N_VRLS, dtype=torch.int32)[None]
    out = cb.vrl_sum_clustered_bwd(*packs, np.zeros(64, np.int32), ids,
                                   torch.ones((1, N_VRLS)), gbar, **kw)
    assert out[1].shape == (pk.MED_RHO + 1,)
    for o, r in zip(out[:3], ref):
        torch.testing.assert_close(o, r, rtol=1e-5, atol=1e-6)
