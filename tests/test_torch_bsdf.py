"""The port's BSDFs against alvrl_tpu.bsdf.api on the same inputs, for
the eleven smooth kinds the port adds to the delta ones (ROUGH_CONDUCTOR,
ROUGH_PLASTIC, PHONG, WARD, DIFFTRANS, PLASTIC, MASK, MIXTURE, COATING,
ROUGH_DIELECTRIC, ROUGH_COATING): sample_from_uniforms in both transport
modes, eval_smooth and pdf_smooth on seeded numpy directions, on the
JAX loader's table of one JSON description carried across (the port's
loader is held to it in test_torch_loader.py); the rough-transmittance
tables; and the reference tests' own cheap checks
(tests/test_bsdf_family.py, test_rough_bsdf.py, test_layered_bsdf.py):
the sampled weight against the eval integral and a pdf that integrates
to at most 1.

Bars: rel 1e-5 and abs 1e-6 (TOL), except where a transcendental of the
two libraries differs in its last bits and a later step amplifies it, on
a few of the 4,096 samples (LOOSE, with the reason by kind): Ward's
half-vector (atan2, log, sin and cos of the sampled azimuth), the rough
dielectric's weight f cos / pdf near a grazing microfacet, the coats'
absorption exp(-sigma_a d (1/|cos_i'| + 1/|cos_o'|)) near grazing, and
the microfacet pdfs' exp and pow of large arguments. The
rough-transmittance table, a mean of 2,048 such weights summed in
another order, at abs 1e-6. The JAX functions run jitted, one compile
per function and mode. About 40 s alone.
"""

import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvrl_tpu.bsdf import api as jbsdf
from alvrl_tpu.bsdf import microfacet as jmf
from alvrl_tpu.scene import loader as jloader
from alvrl_tpu.scene import scene as jscene_mod
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.bsdf import api as bsdf
from alvrl_tpu_torch.bsdf import microfacet as mf
from alvrl_tpu_torch.scene import scene as scene_mod
from tests.torch_port_utils import (
    CPU,
    SMOOTH_KINDS,
    SMOOTH_MATERIALS,
    jax_scene_leaves,
)

torch.set_num_threads(1)

KINDS, MATERIALS = SMOOTH_KINDS, SMOOTH_MATERIALS
SCENE = {
    "camera": {"type": "perspective", "origin": [0, 0, -0.99],
               "target": [0, 0, 1], "fov": 90, "width": 4, "height": 4},
    "medium": {"type": "homogeneous", "sigma_s": [0.6] * 3,
               "sigma_a": [0.05] * 3, "g": 0.3},
    "materials": MATERIALS,
    "shapes": [{"type": "cube", "material": "white", "flip_normals": True}],
    "emitters": [{"type": "point", "position": [0, 0.8, 0],
                  "intensity": [5, 5, 5]}],
}
N = 4096
TOL = dict(rtol=1e-5, atol=1e-6)
# (function, kind) -> the bar where a transcendental needs more (module
# docstring): Ward's sampled half-vector (also under the mixture), the
# coats' absorption near grazing, the rough dielectric's f cos / pdf,
# and the microfacet pdfs' exp and pow (measured: at most 16 of 4,096
# samples over TOL; wo within 7e-6, weights within 3.3e-4 relative, pdfs
# within 2.2e-5 relative)
LOOSE = {
    **{("sample", k): dict(rtol=1e-3, atol=1e-5)
       for k in ("ward", "mixture", "coating", "roughcoating",
                 "roughdielectric")},
    **{("pdf", k): dict(rtol=5e-5, atol=1e-6)
       for k in ("roughcoating", "roughdielectric")},
}
MODES = ("radiance", "importance")


@functools.lru_cache(maxsize=None)
def _scenes():
    """The JAX scene of SCENE and its leaves carried across (the port's
    own loader and tables are held to JAX's in test_torch_loader.py and
    test_rough_transmittance_table_matches)."""
    jscene = jloader.build_scene(json.loads(json.dumps(SCENE)))
    return jscene, convert.scene_from_numpy(jax_scene_leaves(jscene),
                                            device=CPU)


def _mat_id(kind):
    return [m["name"] for m in MATERIALS].index(KINDS[kind])


def _t(a):
    return torch.as_tensor(np.array(a))


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _directions(seed, n=N):
    """(ng, wi, wo, d_in, ng_raw, u): shading normals, wi and wo on both
    sides of them, incoming directions with the normals oriented against
    them, and uniforms."""
    rng = np.random.default_rng(seed)
    ng, wi, wo, d_in = (_unit(rng, n) for _ in range(4))
    ng_raw = ng
    ng_facing = np.where(np.sum(ng * d_in, axis=1, keepdims=True) > 0,
                         -ng, ng)
    u = rng.random((n, bsdf.N_SAMPLE_DIMS)).astype(np.float32)
    return ng, wi, wo, d_in, ng_raw, ng_facing, u


_jit_sample = jax.jit(jbsdf.sample_from_uniforms,
                      static_argnames=("mode", "uv"))
_jit_eval = jax.jit(jbsdf.eval_smooth)
_jit_pdf = jax.jit(jbsdf.pdf_smooth)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sample_from_uniforms_matches(kind, mode):
    """wo, weight, eta_ratio, is_delta, is_smooth and valid of each kind,
    entering and leaving its surface, against JAX's at the same
    uniforms."""
    jscene, scene = _scenes()
    _, _, _, d_in, ng_raw, ng, u = _directions(1)
    mat = np.full(N, _mat_id(kind))
    ref = _jit_sample(jscene, jnp.asarray(u), jnp.asarray(mat),
                      jnp.asarray(ng), jnp.asarray(ng_raw),
                      jnp.asarray(d_in), jnp.zeros((N, 3)), mode=mode)
    out = bsdf.sample_from_uniforms(scene, _t(u), _t(mat), _t(ng),
                                    _t(ng_raw), _t(d_in), mode=mode)
    for k in ("is_delta", "is_smooth", "valid"):
        assert torch.equal(getattr(out, k), _t(getattr(ref, k))), k
    ok = out.valid
    tol = LOOSE.get(("sample", kind), TOL)
    for k in ("wo", "weight", "eta_ratio"):
        torch.testing.assert_close(getattr(out, k)[ok],
                                   _t(getattr(ref, k))[ok], **tol, msg=k)
    assert float(out.weight[ok].abs().sum()) > 0.0


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_eval_smooth_matches(kind):
    """f cos_o of each kind, wi and wo on both sides of the normal."""
    jscene, scene = _scenes()
    ng, wi, wo, *_ = _directions(2)
    mat = np.full(N, _mat_id(kind))
    ref = _jit_eval(jscene, jnp.asarray(mat), jnp.asarray(ng),
                    jnp.asarray(wi), jnp.asarray(wo))
    out = bsdf.eval_smooth(scene.materials, _t(mat), _t(ng), _t(wi), _t(wo))
    torch.testing.assert_close(out, _t(ref), **TOL)
    assert float(out.abs().sum()) > 0.0


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_pdf_smooth_matches(kind):
    """The solid-angle pdf of each kind's smooth lobes."""
    jscene, scene = _scenes()
    ng, wi, wo, *_ = _directions(3)
    mat = np.full(N, _mat_id(kind))
    ref = _jit_pdf(jscene, jnp.asarray(mat), jnp.asarray(ng),
                   jnp.asarray(wi), jnp.asarray(wo))
    out = bsdf.pdf_smooth(scene.materials, _t(mat), _t(ng), _t(wi), _t(wo))
    torch.testing.assert_close(out, _t(ref), **LOOSE.get(("pdf", kind), TOL))
    assert float(out.abs().sum()) > 0.0


@pytest.mark.parametrize("dist", ["beckmann", "ggx", "phong"])
def test_rough_transmittance_table_matches(dist):
    """The (16, 8) table of a rough interface over (cos, alpha) for each
    distribution, from the reference's uniforms through the port's
    sampler, against JAX's; within [0, 1], and near 1 - F at normal
    incidence and the smallest roughness."""
    d = {"beckmann": mf.MF_BECKMANN, "ggx": mf.MF_GGX,
         "phong": mf.MF_PHONG}[dist]
    out = mf.rough_transmittance_table(1.5, d, alpha_max=0.6)
    ref = np.asarray(jmf.rough_transmittance_table(1.5, d, alpha_max=0.6))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    assert out.min() >= 0.0 and out.max() <= 1.0
    assert abs(out[-1, 0] - 0.96) < 0.02  # 1 - F(1) = 0.96 at eta 1.5


def _sphere(seed, n):
    d = _unit(np.random.default_rng(seed), n)
    return torch.as_tensor(d)


# the reference tests' sample-against-eval checks, by kind
# (tests/test_bsdf_family.py, test_rough_bsdf.py, test_layered_bsdf.py)
CONSISTENT = ("phong", "ward", "difftrans", "plastic", "mask", "mixture",
              "coating", "roughdielectric", "roughcoating")


@pytest.mark.parametrize("kind", CONSISTENT)
def test_sampled_weight_integrates_eval(kind):
    """E[weight] over the samples of the smooth lobes (the delta ones
    left out) tracks the sphere integral of eval_smooth, within 8 % (the
    reference tests' bar at 30,000 samples)."""
    _, scene = _scenes()
    n = 30000
    wi = torch.tensor([0.3, 0.1, 0.95])
    wi = (wi / wi.norm()).expand(n, 3)
    ng = torch.tensor([0.0, 0.0, 1.0]).expand(n, 3)
    mat = torch.full((n,), _mat_id(kind))
    u = torch.as_tensor(np.random.default_rng(4).random(
        (n, bsdf.N_SAMPLE_DIMS)).astype(np.float32))
    s = bsdf.sample_from_uniforms(scene, u, mat, ng, ng, -wi)
    est = float(torch.where((s.valid & ~s.is_delta)[:, None], s.weight,
                            0.0)[:, 0].mean())
    vals = bsdf.eval_smooth(scene.materials, mat, ng, wi, _sphere(5, n))
    ref = float(vals[:, 0].mean()) * 4 * math.pi
    assert abs(est - ref) < 0.08 * max(ref, 0.1), (est, ref)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_pdf_integrates_to_at_most_one(kind):
    """The sphere integral of pdf_smooth is at most 1 (within the Monte
    Carlo error of 30,000 uniform directions), and positive."""
    _, scene = _scenes()
    n = 30000
    wi = torch.tensor([0.2, -0.3, 0.9])
    wi = (wi / wi.norm()).expand(n, 3)
    ng = torch.tensor([0.0, 0.0, 1.0]).expand(n, 3)
    mat = torch.full((n,), _mat_id(kind))
    p = bsdf.pdf_smooth(scene.materials, mat, ng, wi, _sphere(6, n))
    total = float(p.mean()) * 4 * math.pi
    assert 0.0 < total < 1.05, total


@pytest.mark.parametrize("kind", ["IRAWAN"])
def test_check_kinds_refuses_the_rest_by_name(kind):
    _, scene = _scenes()
    mats = scene.materials
    bad = dataclasses.replace(mats, kind=torch.cat([mats.kind, torch.tensor(
        [getattr(scene_mod, kind)])]))
    with pytest.raises(ValueError, match=f"{kind}.*ROADMAP A11a"):
        bsdf.check_kinds(bad)


def test_kinds_are_numbered_as_the_reference():
    for name in ("ROUGH_CONDUCTOR", "ROUGH_PLASTIC", "PHONG", "WARD",
                 "DIFFTRANS", "PLASTIC", "MASK", "MIXTURE", "COATING",
                 "NORMALMAP", "HK", "IRAWAN", "ROUGH_DIELECTRIC",
                 "ROUGH_COATING"):
        assert getattr(scene_mod, name) == getattr(jscene_mod, name), name
    assert (mf.MF_BECKMANN, mf.MF_GGX, mf.MF_PHONG) == (
        jmf.MF_BECKMANN, jmf.MF_GGX, jmf.MF_PHONG)
    assert bsdf.PORTED_KINDS == frozenset(range(15)) | {16, 17}
