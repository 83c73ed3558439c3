"""The BSDF dispatch over the material table: sample, eval and pdf.

Counterpart of alvrl_tpu/bsdf/api.py (sample_from_uniforms, eval_smooth,
pdf_smooth) for the smooth diffuse kind, the three delta kinds (the null
boundary, the mirror and the smooth dielectric,
integrators/vrl/specular.py::specular_bounce), the smooth leaf kinds
ROUGH_CONDUCTOR, ROUGH_PLASTIC, PHONG, WARD, DIFFTRANS, PLASTIC and
ROUGH_DIELECTRIC (bsdf.microfacet, bsdf.lobes), the wrappers MASK,
MIXTURE and NORMALMAP (one nesting level onto a leaf kind), the layers
COATING and ROUGH_COATING over a nested leaf and the Hanrahan-Krueger
slab HK (bsdf.layered). IRAWAN is not ported (ROADMAP A11a): check_kinds
refuses it by name.

Textures (textures.procedural) enter through a Shading, the textured
surface at a hit (shading(scene, mat_id, ng, p, uv)): the shading normal
(a NORMALMAP's perturbed one, else ng) and the albedos at the hit of the
material's leaf and of its nested and nested2 leaves, which every leaf
reads in place of its table albedo, as the reference's leaves read
albedo_at(p, uv). Without one the table albedos and ng are used, which
is the same for an untextured table. The HK slab reads its table columns
(albedo = sigma_s, albedo2 = sigma_a, exponent = thickness, alpha = g)
untextured, as in the reference.

The sampler consumes the reference's N_SAMPLE_DIMS uniforms per hit: 0
the wrapper's or coat's lobe choice, 1-2 the 2D lobe sample, 3 a leaf's
own lobe choice (Phong, Ward, plastic, rough dielectric), 4 the delta
kinds' lobe choice. The two transport modes differ in refraction only:
radiance carries the 1/eta^2 compression, importance (the tracer's) does
not. The kind dispatch is masked arithmetic, as the reference's; each
function takes the set of kinds in the table (check_kinds) and computes
only those kinds' candidates, which selects the same values.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from alvrl_tpu_torch.bsdf import layered, lobes
from alvrl_tpu_torch.bsdf import microfacet as mf
from alvrl_tpu_torch.core import math as m
from alvrl_tpu_torch.core import warp
from alvrl_tpu_torch.integrators.vrl.specular import specular_bounce
from alvrl_tpu_torch.scene.scene import (
    COATING,
    DIELECTRIC,
    DIFFTRANS,
    DIFFUSE,
    HK,
    IRAWAN,
    MASK,
    MIRROR,
    MIXTURE,
    NORMALMAP,
    NULL,
    PHONG,
    PLASTIC,
    ROUGH_COATING,
    ROUGH_CONDUCTOR,
    ROUGH_DIELECTRIC,
    ROUGH_PLASTIC,
    TEXTURED_KINDS,
    WARD,
    Materials,
    Scene,
)
from alvrl_tpu_torch.textures.procedural import PROCEDURAL, albedo_at

N_SAMPLE_DIMS = 5  # uniforms consumed per sample, as in the reference
DELTA_KINDS = frozenset((NULL, MIRROR, DIELECTRIC))
# leaf kinds with a smooth (non-delta) component
SMOOTH_LEAF_KINDS = frozenset((DIFFUSE, ROUGH_CONDUCTOR, ROUGH_PLASTIC,
                               PHONG, WARD, DIFFTRANS, PLASTIC,
                               ROUGH_DIELECTRIC))
WRAPPER_KINDS = frozenset((MASK, MIXTURE))
COAT_KINDS = frozenset((COATING, ROUGH_COATING))
# the kinds the kernels' material forms evaluate at the eye hit (the
# textured forms also TEXTURED_KINDS)
MATERIAL_FORM_KINDS = (DELTA_KINDS | SMOOTH_LEAF_KINDS | WRAPPER_KINDS
                       | COAT_KINDS)
PORTED_KINDS = MATERIAL_FORM_KINDS | TEXTURED_KINDS
UNPORTED_KINDS = {IRAWAN: "IRAWAN"}
MODES = ("radiance", "importance")


class Shading(NamedTuple):
    """The textured surface at a hit (shading): the shading normal and
    the albedos (..., 3) of the hit material's leaf, its nested and its
    nested2 material at the hit point."""

    ns: torch.Tensor
    albedo: torch.Tensor
    albedo_n1: torch.Tensor
    albedo_n2: torch.Tensor


def shading(scene: Scene, mat_id, ng, p, uv) -> Shading:
    """The Shading of material mat_id at hit points p with the oriented
    normal ng and the texture coordinates uv (textures.procedural.
    interp_uv): a NORMALMAP's normal perturbed by its normal texture at
    uv (layered.perturbed_normal), ng elsewhere; each leaf's
    albedo_at(p, uv)."""
    mats = scene.materials
    ns = ng
    if NORMALMAP in mats.host_kinds:
        ns = torch.where((mats.kind[mat_id] == NORMALMAP)[..., None],
                         layered.perturbed_normal(
                             scene.textures, mats.tex_id[mat_id], ng, uv), ng)
    return Shading(ns, *(albedo_at(scene, mid, p, uv) for mid in (
        mat_id, mats.nested[mat_id], mats.nested2[mat_id])))


class BSDFSample(NamedTuple):
    wo: torch.Tensor         # (..., 3) world outgoing direction
    weight: torch.Tensor     # (..., 3) f cos / pdf, or a delta lobe's tint
    eta_ratio: torch.Tensor  # relative-IOR change of the sampled lobe
    is_delta: torch.Tensor   # bool: the sampled lobe is a delta lobe
    is_smooth: torch.Tensor  # bool: the material has a smooth component
    valid: torch.Tensor      # bool: the sample is usable


def check_kinds(scene_or_materials) -> frozenset:
    """The set of material kinds in the table (of a Scene or a
    Materials; its host copy, Materials.host_kinds, so no sync); raises,
    naming the kind, if one is not ported."""
    mats = getattr(scene_or_materials, "materials", scene_or_materials)
    kinds = mats.host_kinds
    other = sorted(kinds - PORTED_KINDS)
    if other:
        names = [UNPORTED_KINDS.get(k, str(k)) for k in other]
        raise ValueError(f"material kinds {names} are not ported (ROADMAP "
                         f"A11a; kinds {sorted(kinds)})")
    return kinds


def has_glossy(kinds) -> bool:
    """Does a kind set hold a smooth kind other than DIFFUSE, whose
    eye-side term the kernels' diffuse instantiations do not evaluate?"""
    return bool(kinds - DELTA_KINDS - {DIFFUSE})


def smooth_flags(mats: Materials):
    """(M,) bool: has material i a smooth component, so that its eval
    can be non-zero? A smooth leaf kind (DIFFUSE only with a non-zero
    albedo, the diffuse kernels' gate, or a procedural texture's non-zero
    albedo2), ROUGH_COATING (its glossy coat), HK, and MASK, COATING,
    NORMALMAP or MIXTURE over such a leaf."""
    kind = mats.kind
    leaf = torch.zeros_like(kind, dtype=torch.bool)
    for k in SMOOTH_LEAF_KINDS:
        leaf |= kind == k
    procedural = torch.zeros_like(leaf)
    for k in PROCEDURAL:
        procedural |= mats.tex_kind == k
    leaf &= ((kind != DIFFUSE) | (mats.albedo.sum(dim=-1) > 0.0)
             | (procedural & (mats.albedo2.sum(dim=-1) > 0.0)))
    n1, n2 = leaf[mats.nested], leaf[mats.nested2]
    return (leaf | (kind == ROUGH_COATING) | (kind == HK)
            | (((kind == MASK) | (kind == COATING) | (kind == NORMALMAP))
               & n1)
            | ((kind == MIXTURE) & (n1 | n2)))


def _select(out, kind, cases):
    """out where no case applies, else the value of the case (k, fn) whose
    kind k is `kind`; fn is called only for the cases listed."""
    for k, fn in cases:
        val = fn()
        cond = kind == k
        out = torch.where(cond[..., None] if val.dim() > cond.dim() else cond,
                          val, out)
    return out


def _leaf_eval_local(mats: Materials, mid, wi_l, wo_l, kinds, albedo=None):
    """f cos_o of the smooth component of a leaf kind in the local frame
    (z = shading normal), with the table's albedo or `albedo`; 0 for the
    delta and wrapper kinds."""
    kind = mats.kind[mid]
    alpha = mats.alpha[mid]
    alpha_v = mats.alpha_v[mid]
    dist = mats.dist[mid]
    if albedo is None:
        albedo = mats.albedo[mid]
    cos_o = torch.clamp(wo_l[..., 2], min=0.0)
    shape = torch.broadcast_shapes(albedo.shape, wo_l.shape)
    cases = {
        DIFFUSE: lambda: albedo * (cos_o / math.pi)[..., None],
        ROUGH_CONDUCTOR: lambda: mf.eval_rough_conductor_d(
            wi_l, wo_l, dist, alpha, alpha_v, albedo),
        ROUGH_PLASTIC: lambda: mf.eval_rough_plastic_d(
            wi_l, wo_l, dist, alpha, alpha_v, albedo),
        PHONG: lambda: lobes.eval_phong(wi_l, wo_l, albedo,
                                        mats.specular[mid],
                                        mats.exponent[mid]),
        WARD: lambda: lobes.eval_ward(wi_l, wo_l, albedo, mats.specular[mid],
                                      alpha, alpha_v),
        DIFFTRANS: lambda: lobes.eval_difftrans(wi_l, wo_l, albedo),
        PLASTIC: lambda: lobes.eval_plastic_smooth(wi_l, wo_l, albedo,
                                                   mats.eta[mid]),
        ROUGH_DIELECTRIC: lambda: albedo * mf.eval_rough_dielectric(
            wi_l, wo_l, mats.eta[mid], dist, alpha, alpha_v)[..., None],
    }
    out = torch.zeros(shape, dtype=torch.float32, device=wo_l.device)
    return _select(out, kind, [(k, fn) for k, fn in cases.items()
                               if k in kinds])


def _local(ng, *dirs):
    s_f, t_f = m.build_frame(ng)
    return (s_f, t_f) + tuple(m.frame_to_local(s_f, t_f, ng, d) for d in dirs)


def _rough_coat_spec(mats, mat_id, wi_l, wo_l):
    """The rough coat's glossy reflection f cos_o at the interface
    (roughcoating.cpp:257-320)."""
    a_rc = mats.alpha[mat_id]
    dist_rc = mats.dist[mat_id]
    same_side = wi_l[..., 2] * wo_l[..., 2] > 0
    h_rc = m.normalize(wi_l + wo_l)
    h_rc = h_rc * torch.sign(h_rc[..., 2] + 1e-20)[..., None]
    d_rc = mf.mf_d(dist_rc, h_rc, a_rc, a_rc)
    g_rc = (mf.mf_g1(dist_rc, wi_l, h_rc, a_rc, a_rc)
            * mf.mf_g1(dist_rc, wo_l, h_rc, a_rc, a_rc))
    fr_rc = lobes.fresnel_dielectric_scalar(m.dot(wi_l, h_rc).abs(),
                                            mats.eta[mat_id])
    spec_rc = fr_rc * d_rc * g_rc / torch.clamp(4.0 * wi_l[..., 2].abs(),
                                                min=1e-9)
    return torch.where(same_side, spec_rc, 0.0)


def _rough_t(mats, mat_id, cos_i):
    """The rough coat's transmittance T(cos_i, alpha) from its table."""
    return mf.rough_transmittance_b(mats.rt_table, mat_id, cos_i,
                                    mats.alpha[mat_id],
                                    mats.rt_alpha_max[mat_id])


def eval_smooth(mats: Materials, mat_id, ng, wi_world, wo_world,
                kinds=None, shade: Shading = None):
    """BSDF eval times cos(theta_o) of the smooth (ESmooth) components at
    the shading normal ng: the reference's bsdf->eval(bRec) with the
    ESmooth measure (vrlIntegrator.cpp:758-761), the vol-surf factor of
    the VRL estimator. wi_world points away from the surface toward the
    eye, wo_world toward the light. Resolves MASK, MIXTURE, NORMALMAP,
    COATING and ROUGH_COATING, and evaluates the HK slab; the delta kinds
    give 0. mat_id, ng and the directions broadcast together. `kinds`:
    check_kinds' set (checked here if None). `shade`, the hit's Shading,
    replaces ng by its shading normal and the leaves' albedos by its
    own."""
    if kinds is None:
        kinds = check_kinds(mats)
    kind = mats.kind[mat_id]
    _, _, wi_l, wo_l = _local(ng if shade is None else shade.ns, wi_world,
                              wo_world)

    def leaf(mid, slot, wi=wi_l, wo=wo_l):
        return _leaf_eval_local(mats, mid, wi, wo, kinds,
                                None if shade is None else shade[1 + slot])

    out = leaf(mat_id, 0)
    if kinds & (WRAPPER_KINDS | {NORMALMAP}):
        f_n1 = leaf(mats.nested[mat_id], 1)
        w = mats.opacity[mat_id][..., None]
        out = _select(out, kind, [
            (k, fn) for k, fn in (
                (MASK, lambda: w * f_n1),
                (MIXTURE, lambda: w * f_n1 + (1.0 - w) * leaf(
                    mats.nested2[mat_id], 2)),
                (NORMALMAP, lambda: f_n1))
            if k in kinds])
    if HK in kinds:
        out = _select(out, kind, [(HK, lambda: layered.hk_eval(
            wi_l, wo_l, mats.albedo[mat_id], mats.albedo2[mat_id],
            mats.exponent[mat_id], mats.alpha[mat_id]))])
    if kinds & COAT_KINDS:
        # coating.cpp: the nested eval at the refracted directions,
        # Fresnel-attenuated (smooth coat) or attenuated by the rough
        # transmittance both ways (rough coat), the slab's absorption and
        # the solid-angle measure factor
        fi, fo, wi_p, wo_p, ok_c, jac = layered.coating_factors(
            wi_l, wo_l, mats.eta[mat_id])
        absorb = layered.coating_absorption(
            mats.albedo2[mat_id], mats.exponent[mat_id], wi_p[..., 2],
            wo_p[..., 2])
        f_nest = leaf(mats.nested[mat_id], 1, wi_p, wo_p)

        def coat():
            f = f_nest * ((1.0 - fi) * (1.0 - fo) * jac)[..., None] * absorb
            return torch.where(ok_c[..., None], f, 0.0)

        def rough_coat():
            spec_rc = _rough_coat_spec(mats, mat_id, wi_l, wo_l)
            t_i = _rough_t(mats, mat_id, wi_l[..., 2])
            t_o = _rough_t(mats, mat_id, wo_l[..., 2])
            f = f_nest * (t_i * t_o * jac)[..., None] * absorb
            return torch.where(ok_c[..., None], f, 0.0) + spec_rc[..., None]

        out = _select(out, kind, [(k, fn) for k, fn in (
            (COATING, coat), (ROUGH_COATING, rough_coat)) if k in kinds])
    return out


def _leaf_pdf_local(mats: Materials, mid, wi_l, wo_l, kinds):
    """The solid-angle pdf of the sampler's smooth lobe for a leaf kind
    (0 for the delta kinds)."""
    kind = mats.kind[mid]
    alpha = mats.alpha[mid]
    alpha_v = mats.alpha_v[mid]
    albedo = mats.albedo[mid]
    dist = mats.dist[mid]
    cos_o = torch.clamp(wo_l[..., 2], min=0.0)
    pdf_cos = cos_o / math.pi  # diffuse, rough plastic, plastic's base

    def plastic():
        fi = lobes.fresnel_dielectric_scalar(wi_l[..., 2], mats.eta[mid])
        return (1.0 - fi) * pdf_cos

    cases = {
        DIFFUSE: lambda: pdf_cos,
        ROUGH_CONDUCTOR: lambda: mf.pdf_rough_conductor_d(
            wi_l, wo_l, dist, alpha, alpha_v),
        ROUGH_PLASTIC: lambda: pdf_cos,
        PHONG: lambda: lobes.pdf_phong(wi_l, wo_l, albedo,
                                       mats.specular[mid],
                                       mats.exponent[mid]),
        WARD: lambda: lobes.pdf_ward(wi_l, wo_l, albedo, mats.specular[mid],
                                     alpha, alpha_v),
        DIFFTRANS: lambda: torch.where(
            (wi_l[..., 2] * wo_l[..., 2]) < 0, wo_l[..., 2].abs() / math.pi,
            0.0),
        PLASTIC: plastic,
        ROUGH_DIELECTRIC: lambda: mf.pdf_rough_dielectric(
            wi_l, wo_l, mats.eta[mid], dist, alpha, alpha_v),
    }
    shape = torch.broadcast_shapes(kind.shape, wo_l.shape[:-1])
    out = torch.zeros(shape, dtype=torch.float32, device=wo_l.device)
    return _select(out, kind, [(k, fn) for k, fn in cases.items()
                               if k in kinds])


def pdf_smooth(mats: Materials, mat_id, ng, wi_world, wo_world, kinds=None,
               shade: Shading = None):
    """The solid-angle pdf with which sample_from_uniforms draws wo_world
    given wi_world over the smooth lobes (BSDF::pdf with the ESmooth
    measure), what bidirectional MIS weights need; the wrappers and
    layers mix their nested pdfs by their selection probabilities, HK
    takes its two-sided cosine pdf. `shade` as eval_smooth's (its
    shading normal)."""
    if kinds is None:
        kinds = check_kinds(mats)
    kind = mats.kind[mat_id]
    _, _, wi_l, wo_l = _local(ng if shade is None else shade.ns, wi_world,
                              wo_world)

    def leaf(mid, wi=wi_l, wo=wo_l):
        return _leaf_pdf_local(mats, mid, wi, wo, kinds)

    out = leaf(mat_id)
    if kinds & (WRAPPER_KINDS | {NORMALMAP}):
        p_n1 = leaf(mats.nested[mat_id])
        w = mats.opacity[mat_id]
        out = _select(out, kind, [
            (k, fn) for k, fn in (
                (MASK, lambda: w * p_n1),
                (MIXTURE, lambda: w * p_n1 + (1.0 - w) * leaf(
                    mats.nested2[mat_id])),
                (NORMALMAP, lambda: p_n1))
            if k in kinds])
    if HK in kinds:
        out = _select(out, kind, [(HK, lambda: layered.hk_pdf(wi_l, wo_l))])
    if kinds & COAT_KINDS:
        fi, _, wi_p, wo_p, ok_c, jac = layered.coating_factors(
            wi_l, wo_l, mats.eta[mat_id])
        p_nest = leaf(mats.nested[mat_id], wi_p, wo_p)

        def coat():
            return torch.where(ok_c, (1.0 - fi) * p_nest * jac, 0.0)

        def rough_coat():
            # the glossy lobe's pdf times its selection probability 1 -
            # T(cos_i), plus the nested pdf at the refracted directions
            # times the rest (roughcoating.cpp:322-366)
            a_rc = mats.alpha[mat_id]
            dist_rc = mats.dist[mat_id]
            prob_spec = torch.clamp(1.0 - _rough_t(mats, mat_id,
                                                   wi_l[..., 2]), 0.05, 0.95)
            h_rc = m.normalize(wi_l + wo_l)
            h_rc = h_rc * torch.sign(h_rc[..., 2] + 1e-20)[..., None]
            p_spec = mf.mf_pdf(dist_rc, h_rc, a_rc, a_rc) / torch.clamp(
                4.0 * m.dot(wo_l, h_rc).abs(), min=1e-9)
            p_spec = torch.where(wi_l[..., 2] * wo_l[..., 2] > 0, p_spec, 0.0)
            return prob_spec * p_spec + (1.0 - prob_spec) * torch.where(
                ok_c, p_nest * jac, 0.0)

        out = _select(out, kind, [(k, fn) for k, fn in (
            (COATING, coat), (ROUGH_COATING, rough_coat)) if k in kinds])
    return out


def sample_from_uniforms(scene: Scene, u, mat_id, ng, ng_raw, d_in,
                         mode: str = "radiance", kinds=None,
                         shade: Shading = None) -> BSDFSample:
    """Sample the BSDF of material mat_id at a hit with the oriented
    normal ng and the winding normal ng_raw, reached along the direction
    d_in (pointing at the surface), from u (..., N_SAMPLE_DIMS), in the
    transport `mode` ("radiance" or "importance"). `kinds`, the set of
    kinds in the table as check_kinds returns it, saves the check;
    without it the table is checked here. `shade`, the hit's Shading:
    its shading normal replaces ng (the delta kinds keep ng_raw), the
    sampled leaf takes its albedo."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if kinds is None:
        kinds = check_kinds(scene)
    mats = scene.materials
    kind0 = mats.kind[mat_id]
    u_sel = u[..., 0]
    false = torch.zeros_like(kind0, dtype=torch.bool)

    # wrapper resolution (one nesting level): the mask passes the ray on
    # with probability 1 - opacity, the mixture picks a component, the
    # normal map shades its nested leaf; slot: which of the Shading's
    # albedos the leaf eff reads
    eff = mat_id
    slot = torch.zeros_like(mat_id)
    mask_pass = is_coat = is_rcoat = false
    if kinds & (WRAPPER_KINDS | {NORMALMAP}):
        opac = mats.opacity[mat_id]
        is_mask = kind0 == MASK
        is_mix = kind0 == MIXTURE
        mask_pass = is_mask & (u_sel >= opac)
        first = is_mask | (kind0 == NORMALMAP) | (is_mix & (u_sel < opac))
        eff = torch.where(first, mats.nested[mat_id],
                          torch.where(is_mix, mats.nested2[mat_id], mat_id))
        slot = torch.where(first, 1, torch.where(is_mix, 2, 0))
    if shade is not None:
        ng = shade.ns

    s_f, t_f = m.build_frame(ng)
    glossy = has_glossy(kinds)
    wi_l = m.frame_to_local(s_f, t_f, ng, -d_in) if glossy else None

    # coating.cpp: the delta coat lobe with probability F(wi), else the
    # nested BSDF at the refracted directions; roughcoating.cpp: the
    # glossy coat lobe with probability 1 - T(cos_i, alpha)
    coat_refl = coat_trans = rcoat_refl = rcoat_trans = false
    if kinds & COAT_KINDS:
        eta_c = mats.eta[mat_id]
        if COATING in kinds:
            is_coat = kind0 == COATING
            fi_c = lobes.fresnel_dielectric_scalar(wi_l[..., 2].abs(), eta_c)
            coat_refl = is_coat & (u_sel < fi_c)
            coat_trans = is_coat & ~coat_refl
        if ROUGH_COATING in kinds:
            is_rcoat = kind0 == ROUGH_COATING
            t_i_rc = _rough_t(mats, mat_id, wi_l[..., 2])
            prob_spec_rc = torch.clamp(1.0 - t_i_rc, 0.05, 0.95)
            rcoat_refl = is_rcoat & (u_sel < prob_spec_rc)
            rcoat_trans = is_rcoat & ~rcoat_refl
        wi_orig_l = wi_l
        wi_refr, _ = layered.refract_z(wi_l, 1.0 / eta_c)
        into = coat_trans | rcoat_trans
        wi_l = torch.where(into[..., None], wi_refr, wi_l)
        eff = torch.where(into, mats.nested[mat_id], eff)
        slot = torch.where(into, 1, slot)

    kind = mats.kind[eff]
    if shade is None:
        albedo = mats.albedo[eff]
    else:
        albedo = torch.where((slot == 0)[..., None], shade.albedo,
                             torch.where((slot == 1)[..., None],
                                         shade.albedo_n1, shade.albedo_n2))
    alpha = mats.alpha[eff]
    u2 = u[..., 1:3]
    u3 = torch.cat([u[..., 3:4], u2], dim=-1)

    # the leaf candidates, each where its kind is sampled
    wo_diffuse_l = warp.square_to_cosine_hemisphere(u2)
    wo_l, weight = wo_diffuse_l, albedo   # DIFFUSE, and ROUGH_PLASTIC's wo
    pl_delta = rd_trans = false
    wo_pl_l = None

    def take(k, wo_k, w_k):
        nonlocal wo_l, weight
        sel = kind == k
        if wo_k is not None:
            wo_l = torch.where(sel[..., None], wo_k, wo_l)
        weight = torch.where(sel[..., None], w_k, weight)

    if ROUGH_CONDUCTOR in kinds:
        wo_rc_l, w_rc, _ = mf.sample_rough_conductor(u2, wi_l, alpha, albedo)
        take(ROUGH_CONDUCTOR, wo_rc_l, w_rc)
    if ROUGH_PLASTIC in kinds:
        # the cosine lobe, weighted by the full eval: f cos / pdf
        cos_d = torch.clamp(wo_diffuse_l[..., 2], min=1e-6)
        take(ROUGH_PLASTIC, None, mf.eval_rough_plastic(
            wi_l, wo_diffuse_l, alpha, albedo) * (math.pi / cos_d)[..., None])
    if PHONG in kinds:
        wo_ph_l, w_ph, _ = lobes.sample_phong(
            u3, wi_l, albedo, mats.specular[eff], mats.exponent[eff])
        take(PHONG, wo_ph_l, w_ph)
    if WARD in kinds:
        wo_wd_l, w_wd, _ = lobes.sample_ward(
            u3, wi_l, albedo, mats.specular[eff], alpha, mats.alpha_v[eff])
        take(WARD, wo_wd_l, w_wd)
    if DIFFTRANS in kinds:
        wo_dt_l, w_dt, _ = lobes.sample_difftrans(u2, wi_l, albedo)
        take(DIFFTRANS, wo_dt_l, w_dt)
    if PLASTIC in kinds:
        wo_pl_l, w_pl, pl_delta = lobes.sample_plastic_smooth(
            u3, wi_l, albedo, mats.eta[eff])
        take(PLASTIC, wo_pl_l, w_pl)
    if ROUGH_DIELECTRIC in kinds:
        wo_rd_l, w_rd, _, rd_trans = mf.sample_rough_dielectric(
            u3, wi_l, mats.eta[eff], mats.dist[eff], alpha,
            mats.alpha_v[eff], mode=mode)
        take(ROUGH_DIELECTRIC, wo_rd_l, w_rd * albedo)

    # the coats' exits: the nested sample refracted back out; total
    # internal reflection on the way out kills the sample
    coat_dead = rcoat_dead = false
    if kinds & COAT_KINDS:
        wo_exit, ok_exit = layered.refract_z(wo_l, eta_c)
        absorb_c = layered.coating_absorption(
            mats.albedo2[mat_id], mats.exponent[mat_id], wi_l[..., 2],
            wo_l[..., 2])
        if COATING in kinds:
            fo_c = lobes.fresnel_dielectric_scalar(wo_exit[..., 2].abs(),
                                                   eta_c)
            w_coat_t = weight * (1.0 - fo_c)[..., None] * absorb_c
            wo_coat_r_l = torch.stack(
                [-wi_l[..., 0], -wi_l[..., 1], wi_l[..., 2]], dim=-1)
            coat_dead = coat_trans & ~ok_exit
            wo_l = torch.where(coat_trans[..., None], wo_exit, wo_l)
            wo_l = torch.where((coat_refl | coat_dead)[..., None],
                               wo_coat_r_l, wo_l)
            weight = torch.where(coat_trans[..., None], w_coat_t, weight)
            weight = torch.where(coat_refl[..., None],
                                 torch.ones_like(weight), weight)
        if ROUGH_COATING in kinds:
            # reflection: the microfacet lobe at the original wi, weight
            # F D G / (4 |ci|) / (pdf_m jac prob_spec); transmission: the
            # nested weight times T_i / p_t, T_o at the exit and the
            # absorption (roughcoating.cpp:368-470)
            a_rc0 = mats.alpha[mat_id]
            dist_rc0 = mats.dist[mat_id]
            mh_rc, _ = mf.mf_sample(dist_rc0, u2, a_rc0, a_rc0)
            cos_wih_rc = m.dot(wi_orig_l, mh_rc)
            wo_rc_spec = 2.0 * cos_wih_rc[..., None] * mh_rc - wi_orig_l
            fr_rc = lobes.fresnel_dielectric_scalar(cos_wih_rc.abs(), eta_c)
            d_rc = mf.mf_d(dist_rc0, mh_rc, a_rc0, a_rc0)
            g_rc = (mf.mf_g1(dist_rc0, wi_orig_l, mh_rc, a_rc0, a_rc0)
                    * mf.mf_g1(dist_rc0, wo_rc_spec, mh_rc, a_rc0, a_rc0))
            fcos_rc = fr_rc * d_rc * g_rc / torch.clamp(
                4.0 * wi_orig_l[..., 2].abs(), min=1e-9)
            pdf_rc_spec = (mf.mf_pdf(dist_rc0, mh_rc, a_rc0, a_rc0)
                           / torch.clamp(4.0 * m.dot(wo_rc_spec, mh_rc).abs(),
                                         min=1e-9))
            ok_rc_r = (wo_rc_spec[..., 2] * wi_orig_l[..., 2] > 0) \
                & (pdf_rc_spec > 1e-20)
            w_rcoat_r = (fcos_rc / torch.clamp(pdf_rc_spec * prob_spec_rc,
                                               min=1e-20))[..., None] \
                * torch.ones(3, dtype=torch.float32, device=u.device)
            t_o_rc = _rough_t(mats, mat_id, wo_exit[..., 2])
            w_rcoat_t = weight * (
                t_i_rc / torch.clamp(1.0 - prob_spec_rc, min=1e-6) * t_o_rc
            )[..., None] * absorb_c
            rcoat_dead = (rcoat_trans & ~ok_exit) | (rcoat_refl & ~ok_rc_r)
            wo_l = torch.where(rcoat_trans[..., None], wo_exit, wo_l)
            wo_l = torch.where(rcoat_refl[..., None], wo_rc_spec, wo_l)
            weight = torch.where(rcoat_trans[..., None], w_rcoat_t, weight)
            weight = torch.where(rcoat_refl[..., None], w_rcoat_r, weight)

    # hk.cpp: the unscattered delta transmission with probability
    # clamp(mean T_delta, 1e-3, 0.9), else the two-sided cosine lobe
    hk_delta = is_hk = false
    if HK in kinds:
        is_hk = kind0 == HK
        sig_s_hk, sig_a_hk = mats.albedo[mat_id], mats.albedo2[mat_id]
        th_hk = mats.exponent[mat_id]
        t_delta = layered.hk_delta_transmittance(wi_l, sig_s_hk, sig_a_hk,
                                                 th_hk)
        p_delta = torch.clamp(t_delta.mean(dim=-1), 1e-3, 0.9)
        hk_delta = is_hk & (u_sel < p_delta)
        hk_scat = is_hk & ~hk_delta
        flip = torch.tensor([1.0, 1.0, -1.0], device=u.device)
        wo_hk_l = torch.where((u[..., 3] < 0.5)[..., None],
                              wo_diffuse_l * flip, wo_diffuse_l)
        f_hk = layered.hk_eval(wi_l, wo_hk_l, sig_s_hk, sig_a_hk, th_hk,
                               mats.alpha[mat_id])
        pdf_hk = layered.hk_pdf(wi_l, wo_hk_l)
        w_hk = f_hk / torch.clamp(pdf_hk * (1.0 - p_delta),
                                  min=1e-12)[..., None]
        w_hk_delta = t_delta / p_delta[..., None]
        wo_l = torch.where(hk_scat[..., None], wo_hk_l, wo_l)
        weight = torch.where(hk_scat[..., None], w_hk, weight)

    wo = m.frame_to_world(s_f, t_f, ng, wo_l)
    eta_ratio = torch.ones_like(weight[..., 0])
    is_delta_kind = false
    if kinds & DELTA_KINDS:
        wo_spec, w_spec, eta_ratio_d, is_delta_kind = specular_bounce(
            scene, u[..., 4], eff, d_in, ng_raw)
        if mode == "importance":
            # strip the radiance-only 1/eta^2 of refraction
            refracted = (kind == DIELECTRIC) & ((eta_ratio_d - 1.0).abs()
                                                > 1e-6)
            w_spec = torch.where(refracted[..., None], 1.0, w_spec)
        wo = torch.where(is_delta_kind[..., None], wo_spec, wo)
        weight = torch.where(is_delta_kind[..., None], w_spec, weight)
        eta_ratio = torch.where(is_delta_kind, eta_ratio_d, 1.0)
    if ROUGH_DIELECTRIC in kinds:
        # a rough refraction changes the relative IOR as the smooth one
        eta_eff = mats.eta[eff]
        rd_eta = torch.where(wi_l[..., 2] > 0,
                             1.0 / torch.clamp(eta_eff, min=1e-6), eta_eff)
        eta_ratio = torch.where((kind == ROUGH_DIELECTRIC) & rd_trans,
                                rd_eta, eta_ratio)
    if PLASTIC in kinds:
        # plastic's delta lobe: the mirror reflection about ng
        wo = torch.where(((kind == PLASTIC) & pl_delta)[..., None],
                         m.frame_to_world(s_f, t_f, ng, wo_pl_l), wo)
        pl_delta = (kind == PLASTIC) & pl_delta
    if HK in kinds:
        # the delta transmission continues straight through (hk.cpp:206)
        wo = torch.where(hk_delta[..., None], d_in, wo)
        weight = torch.where(hk_delta[..., None], w_hk_delta, weight)
    if MASK in kinds:
        # the mask's pass-through (its null component)
        wo = torch.where(mask_pass[..., None], d_in, wo)
        weight = torch.where(mask_pass[..., None], torch.ones_like(weight),
                             weight)
        eta_ratio = torch.where(mask_pass, 1.0, eta_ratio)

    smooth = false
    for k in SMOOTH_LEAF_KINDS & kinds:
        smooth = smooth | (kind == k)
    dead = coat_dead | rcoat_dead
    if kinds & COAT_KINDS:
        weight = torch.where(dead[..., None], 0.0, weight)
    # the smooth flag reports the material: PLASTIC keeps its smooth base
    # when its delta coat was sampled
    return BSDFSample(
        wo=wo, weight=weight, eta_ratio=eta_ratio,
        is_delta=is_delta_kind | pl_delta | coat_refl | hk_delta | mask_pass,
        is_smooth=(smooth | is_coat | is_rcoat | is_hk) & ~mask_pass,
        valid=(smooth | is_delta_kind | mask_pass | is_coat | is_rcoat
               | is_hk) & ~dead)
