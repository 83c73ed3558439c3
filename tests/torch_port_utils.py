"""Helpers shared by the tests that hold alvrl_tpu_torch against alvrl_tpu:
leaves of the JAX package's objects as numpy arrays, for
alvrl_tpu_torch.convert."""

import os

import numpy as np
import torch

from alvrl_tpu_torch.geometry.intersect import Hit

BENCH_VRLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "bench_vrls.txt")

# per-draw constants of a vol_vol=2 / vol_surf=2 pair, in the kernel's
# draw order (vv0.V, vv0.U, vv1.V, vv1.U, vs0, vs1); the same 6-cycle as
# the seq_uniforms fixture of tests/test_hetero_pallas.py
SEQ_UNIFORMS = (0.3, 0.7, 0.62, 0.41, 0.23, 0.77)


def jax_scene_leaves(scene):
    """The leaves of an alvrl_tpu Scene that convert.scene_from_numpy reads."""
    med, cam = scene.medium, scene.camera
    return {
        "vertices": np.asarray(scene.vertices),
        "faces": np.asarray(scene.faces),
        "material": np.asarray(scene.material),
        "materials.kind": np.asarray(scene.materials.kind),
        "materials.albedo": np.asarray(scene.materials.albedo),
        "emitters.position": np.asarray(scene.emitters.position),
        "emitters.intensity": np.asarray(scene.emitters.intensity),
        "medium.sigma_a": np.asarray(med.sigma_a),
        "medium.sigma_s": np.asarray(med.sigma_s),
        "medium.g": np.asarray(med.g),
        "medium.sampling_weight": np.asarray(med.sampling_weight),
        "medium.phase_kind": med.phase_kind,
        "camera.to_world": np.asarray(cam.to_world),
        "camera.fov_x_deg": np.asarray(cam.fov_x_deg),
        "camera.width": cam.width,
        "camera.height": cam.height,
        "camera.kind": cam.kind,
    }


def jax_vrls_leaves(vrls):
    return {k: np.asarray(getattr(vrls, k))
            for k in ("start", "end", "power", "valid", "particle_count")}


def hit_from_jax(hit):
    """alvrl_tpu Hit (or HitInfo) -> the port's Hit on the CPU."""
    return Hit(t=torch.as_tensor(np.asarray(hit.t)),
               prim=torch.as_tensor(np.asarray(hit.prim), dtype=torch.int64),
               valid=torch.as_tensor(np.asarray(hit.valid)),
               p=torch.as_tensor(np.asarray(hit.p)),
               ng=torch.as_tensor(np.asarray(hit.ng)))
