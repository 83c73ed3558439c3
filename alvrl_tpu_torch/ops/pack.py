"""Packing: scene, eye rays and VRLs -> the flat float32 arrays the
render kernel reads.

Counterpart of alvrl_tpu/ops/pack.py (pack_rays, pack_vrls, pack_tris,
pack_medium), with layouts chosen for the CUDA kernel: structure of
arrays, one row per scalar, so that neighbouring threads (rays) read
neighbouring addresses. Nothing is padded; the kernel masks the ragged
edge of the last block itself.
"""

from __future__ import annotations

import torch

from alvrl_tpu_torch.core import math as m
from alvrl_tpu_torch.media import homogeneous as hmed
from alvrl_tpu_torch.scene.scene import DIFFUSE, Scene

# ray pack rows, (RAY_ROWS, B): origin, direction, hit point, normal at
# the hit (facing the ray), diffuse albedo at the hit, transmittance eye
# -> hit, hit valid (0/1)
RO, RD, HP, NG, ALB, TAU, VALID = 0, 3, 6, 9, 12, 15, 18
RAY_ROWS = 19
# vrl pack rows, (VRL_ROWS, N): start, end, power, valid (0/1)
VS, VE, VP, VVALID = 0, 3, 6, 9
VRL_ROWS = 10
# triangle pack, (T, TRI_COLS): p0, e1 = p1 - p0, e2 = p2 - p0
TRI_COLS = 9
# medium pack, (MED_LEN,): sigma_t (3), sigma_s (3), g, sampling weight
MED_LEN = 8


def pack_rays(scene: Scene, ray_o, ray_d, hit, mat):
    """(RAY_ROWS, B) rows of the eye rays and their closest hits, as
    integrators.vrl.integrator.trace_eye_rays gives them (hit, mat)."""
    diffuse = (scene.materials.kind[mat] == DIFFUSE)[..., None]
    albedo = torch.where(diffuse, scene.materials.albedo[mat], 0.0)
    tau_eu = hmed.eval_transmittance(scene.medium, m.length(hit.p - ray_o))
    tau_eu = torch.where(hit.valid[..., None], tau_eu, 0.0)
    cols = [ray_o, ray_d, hit.p, hit.ng, albedo, tau_eu,
            hit.valid.to(torch.float32)[..., None]]
    return torch.cat(cols, dim=-1).T.contiguous()


def pack_vrls(vrls):
    """(VRL_ROWS, N) rows of the VRL buffer."""
    cols = [vrls.start, vrls.end, vrls.power,
            vrls.valid.to(torch.float32)[..., None]]
    return torch.cat(cols, dim=-1).T.contiguous()


def pack_tris(scene: Scene):
    """(T, TRI_COLS) triangles as p0, e1, e2. Triangles that do not
    block shadow rays are zeroed: a degenerate triangle never hits."""
    f = scene.faces
    p0 = scene.vertices[f[:, 0]]
    e1 = scene.vertices[f[:, 1]] - p0
    e2 = scene.vertices[f[:, 2]] - p0
    tri = torch.cat([p0, e1, e2], dim=1)
    opaque = scene.opaque_faces()[:, None]
    return torch.where(opaque, tri, 0.0).contiguous()


def pack_medium(scene: Scene):
    """(MED_LEN,) homogeneous medium parameters."""
    med = scene.medium
    return torch.cat([med.sigma_t, med.sigma_s, med.g.reshape(1),
                      med.sampling_weight.reshape(1)]).to(torch.float32)
