"""The modules of the alvrl_tpu_torch render slice against their
alvrl_tpu counterparts, on the same numpy-made inputs."""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvrl_tpu.core import spectrum as jspectrum
from alvrl_tpu.film import film as jfilm
from alvrl_tpu.geometry import intersect as jintersect
from alvrl_tpu.integrators.vrl import integrate as jintegrate
from alvrl_tpu.integrators.vrl import integrator as jintegrator
from alvrl_tpu.integrators.vrl import vrl as jvrl
from alvrl_tpu.media import homogeneous as jhmed
from alvrl_tpu.scene import presets as jpresets
from alvrl_tpu.sensors import perspective as jperspective
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.core import spectrum
from alvrl_tpu_torch.film import film
from alvrl_tpu_torch.geometry import intersect
from alvrl_tpu_torch.integrators.vrl import integrate, integrator, vrl
from alvrl_tpu_torch.media import homogeneous as hmed
from alvrl_tpu_torch.scene import presets
from alvrl_tpu_torch.sensors import perspective
from tests.torch_port_utils import BENCH_VRLS, jax_scene_leaves, \
    jax_vrls_leaves

torch.set_num_threads(1)

PKG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "alvrl_tpu_torch")


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(out, ref, atol=1e-5, rtol=1e-5):
    torch.testing.assert_close(out, _t(ref), atol=atol, rtol=rtol)


def _pixels(w, h):
    px, py = np.meshgrid(np.arange(w), np.arange(h))
    return px.reshape(-1), py.reshape(-1)


def _fields(obj):
    return {k: getattr(obj, k) for k in obj.__dataclass_fields__}


@pytest.mark.parametrize("g", [0.0, 0.6])
def test_cornell_smoke_matches_jax_preset(g):
    """The port's preset equals the JAX preset carried across by
    convert.scene_from_numpy, leaf by leaf, exactly."""
    ours = presets.cornell_smoke(width=24, height=16, g=g, device="cpu")
    ref = convert.scene_from_numpy(
        jax_scene_leaves(jpresets.cornell_smoke(width=24, height=16, g=g)),
        device="cpu")
    for name in ("vertices", "faces", "material"):
        assert torch.equal(getattr(ours, name), getattr(ref, name)), name
    for part in ("materials", "emitters", "medium", "camera"):
        a, b = _fields(getattr(ours, part)), _fields(getattr(ref, part))
        for k in a:
            if isinstance(a[k], torch.Tensor):
                assert torch.equal(a[k], b[k]), f"{part}.{k}"
            else:
                assert a[k] == b[k], f"{part}.{k}"
    assert torch.equal(ours.opaque_faces(), ref.opaque_faces())


def test_sample_ray_matches():
    jscene = jpresets.cornell_smoke(width=20, height=12)
    scene = presets.cornell_smoke(width=20, height=12, device="cpu")
    px, py = _pixels(20, 12)
    jo, jd = jperspective.sample_ray(jscene.camera, jnp.asarray(px),
                                     jnp.asarray(py))
    o, d = perspective.sample_ray(scene.camera, torch.as_tensor(px),
                                  torch.as_tensor(py))
    _close(o, jo, atol=1e-7)
    _close(d, jd, atol=1e-6)


def test_intersect_all_matches():
    """Closest hits of rays from random points in the box in random
    directions: t, prim, valid, p, ng."""
    scene = presets.cornell_smoke(device="cpu")
    rng = np.random.default_rng(1)
    o = rng.uniform(-0.95, 0.95, (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:4] = [[1, 0, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]]  # axis-aligned
    ref = jintersect.intersect_all(jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(scene.vertices.numpy()),
                                   jnp.asarray(scene.faces.numpy()))
    hit = intersect.intersect_all(torch.as_tensor(o), torch.as_tensor(d),
                                  scene.vertices, scene.faces)
    assert torch.equal(hit.valid, _t(ref.valid))
    assert torch.equal(hit.prim, _t(ref.prim).long())
    assert bool(hit.valid.all())  # the box is closed
    _close(hit.t, ref.t)
    _close(hit.p, ref.p)
    _close(hit.ng, ref.ng, atol=1e-6)


def test_intersect_all_misses():
    """Rays leaving a single triangle's plane miss: t inf, prim -1."""
    verts = torch.tensor([[0.0, 0, 0], [1, 0, 0], [0, 1, 0]])
    faces = torch.tensor([[0, 1, 2]])
    o = torch.tensor([[0.2, 0.2, 1.0], [0.2, 0.2, 1.0], [2.0, 2.0, 1.0]])
    d = torch.tensor([[0.0, 0, -1], [0.0, 0, 1], [0.0, 0, -1]])
    hit = intersect.intersect_all(o, d, verts, faces)
    assert hit.valid.tolist() == [True, False, False]
    assert hit.prim.tolist() == [0, -1, -1]
    assert float(hit.t[0]) == pytest.approx(1.0)
    assert torch.isinf(hit.t[1:]).all()
    assert hit.ng[0].tolist() == [0.0, 0.0, 1.0]  # faces the ray origin


def test_occluded_matches():
    """Random segments inside the box, the blocker counted as opaque."""
    scene = presets.cornell_smoke(device="cpu")
    rng = np.random.default_rng(2)
    p = rng.uniform(-0.98, 0.98, (1024, 3)).astype(np.float32)
    q = rng.uniform(-0.98, 0.98, (1024, 3)).astype(np.float32)
    mask = scene.opaque_faces()
    ref = jintersect.occluded(jnp.asarray(p), jnp.asarray(q),
                              jnp.asarray(scene.vertices.numpy()),
                              jnp.asarray(scene.faces.numpy()),
                              jnp.asarray(mask.numpy()))
    out = intersect.occluded(torch.as_tensor(p), torch.as_tensor(q),
                             scene.vertices, scene.faces[mask])
    assert torch.equal(out, _t(ref))
    assert 0 < int(out.sum()) < len(out)


def test_trace_eye_rays_matches():
    jscene = jpresets.cornell_smoke(width=16, height=16)
    scene = presets.cornell_smoke(width=16, height=16, device="cpu")
    px, py = _pixels(16, 16)
    jo, jd = jperspective.sample_ray(jscene.camera, jnp.asarray(px),
                                     jnp.asarray(py))
    ref = jintegrator.trace_eye_rays(jscene, jo, jd)
    hit, mat = integrator.trace_eye_rays(scene, _t(jo), _t(jd))
    assert torch.equal(hit.valid, _t(ref.valid))
    assert torch.equal(mat, _t(ref.mat).long())
    _close(hit.p, ref.p)


def test_spectrum_matches():
    s = np.random.default_rng(11).random((64, 3), dtype=np.float32)
    s[::5] = 0.0
    s[1::5, 1] = 0.0
    _close(spectrum.luminance(torch.as_tensor(s)),
           jspectrum.luminance(jnp.asarray(s)), atol=1e-7)
    assert torch.equal(spectrum.is_zero(torch.as_tensor(s)),
                       _t(jspectrum.is_zero(jnp.asarray(s))))


def test_eval_transmittance_matches():
    dist = np.random.default_rng(3).uniform(0.0, 4.0, 257).astype(np.float32)
    jmed = jhmed.make_medium((0.05, 0.1, 0.2), (0.8, 0.5, 0.3))
    med = hmed.make_medium((0.05, 0.1, 0.2), (0.8, 0.5, 0.3), device="cpu")
    assert float(med.sampling_weight) == float(jmed.sampling_weight)
    _close(hmed.eval_transmittance(med, torch.as_tensor(dist)),
           jhmed.eval_transmittance(jmed, jnp.asarray(dist)), atol=1e-7)


def test_splat_box_develop_matches():
    """Repeated pixels accumulate; unsplatted pixels develop to zero."""
    rng = np.random.default_rng(4)
    px = rng.integers(0, 7, 300)
    py = rng.integers(0, 5, 300)
    vals = rng.random((300, 3), dtype=np.float32)
    img, wgt = film.splat_box(7, 5, torch.as_tensor(px), torch.as_tensor(py),
                              torch.as_tensor(vals))
    jimg, jwgt = jfilm.splat_box(7, 5, jnp.asarray(px), jnp.asarray(py),
                                 jnp.asarray(vals))
    _close(img, jimg)
    _close(wgt, jwgt)
    _close(film.develop(img, wgt), jfilm.develop(jimg, jwgt))
    empty, ew = film.splat_box(3, 2, torch.tensor([0]), torch.tensor([0]),
                               torch.ones((1, 3)))
    assert film.develop(empty, ew)[1, 2].tolist() == [0.0, 0.0, 0.0]


def _segments(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (n, 3)).astype(np.float32) for _ in range(4)]


def test_closest_points_segments_matches():
    a0, a1, b0, b1 = _segments(400, 5)
    a1[:8] = a0[:8] + (b1[:8] - b0[:8])  # parallel pairs
    ref = jintegrate.closest_points_segments(*map(jnp.asarray,
                                                  (a0, a1, b0, b1)))
    out = integrate.closest_points_segments(*map(torch.as_tensor,
                                                 (a0, a1, b0, b1)))
    for o, r in zip(out, ref):
        _close(o, r, atol=1e-5)


def test_kulla_sampling_matches():
    a, b, x, _ = _segments(400, 6)
    u = np.random.default_rng(7).random(400, dtype=np.float32)
    ref = jintegrate.kulla_sampling(*map(jnp.asarray, (a, b, x, u)))
    out = integrate.kulla_sampling(*map(torch.as_tensor, (a, b, x, u)))
    _close(out[0], ref[0], atol=1e-5)
    _close(out[1], ref[1], atol=1e-5, rtol=1e-4)


def test_sample_v_to_distance_matches():
    eo, eh, vs, ve = _segments(400, 8)
    rng = np.random.default_rng(9)
    ed = eh - eo
    ed /= np.linalg.norm(ed, axis=1, keepdims=True)
    ve[:8] = vs[:8] + ed[:8]  # parallel to the eye ray: uniform sampling
    u = rng.random(400, dtype=np.float32)
    args = (eo, ed, eh, vs, ve, u)
    ref = jintegrate.sample_v_to_distance(*map(jnp.asarray, args))
    out = integrate.sample_v_to_distance(*map(torch.as_tensor, args))
    _close(out[0], ref[0], atol=1e-5)
    _close(out[1], ref[1], atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("capacity", [0, 16])
def test_empty_or_invalid_vrls_render_zeros(capacity):
    """An empty buffer, or one whose VRLs are all invalid, renders
    finite zeros."""
    scene = presets.cornell_smoke(width=8, height=8, device="cpu")
    z = torch.zeros((capacity, 3))
    vrls = vrl.VRLs(start=z, end=z + 0.5, power=z + 1.0,
                    valid=torch.zeros((capacity,), dtype=torch.bool),
                    particle_count=torch.tensor(0.0))
    img = integrator.render_with_vrls_kernel(
        scene, vrls, torch.Generator().manual_seed(0))
    assert img.shape == (8, 8, 3)
    assert torch.isfinite(img).all() and float(img.abs().max()) == 0.0


def test_ascii_roundtrip(tmp_path):
    """load_ascii matches the JAX loader; save_ascii writes the valid
    VRLs only, and they load back."""
    ref = jvrl.load_ascii(BENCH_VRLS, particle_count=78.0)
    vrls = vrl.load_ascii(BENCH_VRLS, particle_count=78.0, device="cpu")
    for k, a in jax_vrls_leaves(ref).items():
        assert torch.equal(getattr(vrls, k), _t(a)), k
    valid = torch.ones(vrls.capacity, dtype=torch.bool)
    valid[::3] = False
    vrls = vrl.VRLs(vrls.start, vrls.end, vrls.power, valid,
                    vrls.particle_count)
    path = tmp_path / "vrls.txt"
    vrl.save_ascii(vrls, str(path))
    back = vrl.load_ascii(str(path), device="cpu")
    assert back.capacity == int(valid.sum())
    assert float(back.particle_count) == back.capacity
    for k in ("start", "end", "power"):
        assert torch.equal(getattr(back, k), getattr(vrls, k)[valid]), k


@pytest.mark.parametrize("capacity, slots", [(20, 6), (64, None),
                                             (23, 6), (200, None)])
def test_compact_matches_jax(capacity, slots):
    """Whole-particle truncation (and padding) as the JAX compact."""
    rng = np.random.default_rng(10)
    n = 60  # 10 particles x 6 slots
    leaves = {
        "start": rng.random((n, 3), dtype=np.float32),
        "end": rng.random((n, 3), dtype=np.float32),
        "power": rng.random((n, 3), dtype=np.float32),
        "valid": rng.random(n) < 0.6,
        "particle_count": np.float32(10.0),
    }
    ref = jvrl.compact(jvrl.VRLs(**{k: jnp.asarray(v)
                                    for k, v in leaves.items()}),
                       capacity, slots_per_particle=slots)
    out = vrl.compact(convert.vrls_from_numpy(leaves, device="cpu"), capacity,
                      slots_per_particle=slots)
    for k, a in jax_vrls_leaves(ref).items():
        assert torch.equal(getattr(out, k), torch.as_tensor(a)), k


def test_compact_refuses_partial_particles():
    leaves = {"start": np.zeros((12, 3), np.float32),
              "end": np.ones((12, 3), np.float32),
              "power": np.ones((12, 3), np.float32),
              "valid": np.ones(12, bool),
              "particle_count": np.float32(2.0)}
    vrls = convert.vrls_from_numpy(leaves, device="cpu")
    with pytest.raises(ValueError):
        vrl.compact(vrls, 8)  # would split a particle
    with pytest.raises(ValueError):
        vrl.compact(vrls, 4, slots_per_particle=6)  # below one particle


def test_package_imports_no_jax():
    """No module of alvrl_tpu_torch, and not chip_smoke.py, imports jax,
    flax or alvrl_tpu."""
    banned = ("jax", "flax", "alvrl_tpu")
    paths = [os.path.join(root, name) for root, _, files in os.walk(PKG_DIR)
             for name in files if name.endswith(".py")]
    paths.append(os.path.join(os.path.dirname(PKG_DIR), "chip_smoke.py"))
    found = []
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            found += [(path, mod) for mod in mods
                      if mod.split(".")[0] in banned]
    assert found == []
    walked = {os.path.relpath(path, PKG_DIR) for path in paths}
    assert {"integrators/vrl/alvrl.py", "integrators/vrl/cluster.py",
            "integrators/vrl/cluster_native.py", "ops/vrl_r.py",
            "ops/vrl_sum_clustered.py", "media/heterogeneous.py",
            "geometry/bvh.py", "ops/vrl_sum_bvh.py",
            "scripts/bench_bvh_large.py", "scripts/probe_gather.py",
            "core/logging.py", "core/stats.py", "io/image.py", "io/mesh.py",
            "io/vol.py", "scene/loader.py", "integrators/progressive.py",
            "scripts/render_cli.py", "../chip_smoke.py",
            "integrators/volpath.py", "integrators/surface.py",
            "media/table.py", "emitters/envmap.py", "emitters/sunsky.py",
            "io/hdr.py"} <= walked


@pytest.mark.parametrize("name", ["emitters/sunsky.py", "io/hdr.py"])
def test_numpy_modules_are_copies(name):
    """sunsky.py and hdr.py are copies of the JAX package's numpy
    modules, not imports of them: every function of the original is
    defined in the port's file with the same body (sky_envmap also takes
    the map's device), and the port's imports stay within numpy and
    alvrl_tpu_torch."""
    ref_path = os.path.join(os.path.dirname(PKG_DIR), "alvrl_tpu", name)
    with open(os.path.join(PKG_DIR, name)) as f:
        ours = ast.parse(f.read())
    with open(ref_path) as f:
        ref = ast.parse(f.read())

    def functions(tree):
        return {n.name: ast.dump(n) for n in tree.body
                if isinstance(n, ast.FunctionDef)}

    a, b = functions(ours), functions(ref)
    assert set(a) == set(b)
    assert [k for k in a if a[k] != b[k]] == (
        ["sky_envmap"] if name.endswith("sunsky.py") else [])
    imports = {alias.name.split(".")[0] for n in ast.walk(ours)
               if isinstance(n, ast.Import) for alias in n.names}
    imports |= {n.module.split(".")[0] for n in ast.walk(ours)
                if isinstance(n, ast.ImportFrom) and n.module}
    assert imports <= {"numpy", "alvrl_tpu_torch", "__future__"}, imports
