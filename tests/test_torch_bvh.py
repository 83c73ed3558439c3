"""alvrl_tpu_torch's BVH (geometry/bvh.py), sphere, large-mesh bench
scenes and gather probes against alvrl_tpu, on the same numpy inputs.

The JAX package's bvh.build loads native/libalvrl_native.so and runs
`make -C native` when it is missing; here it loads the port's own g++
build of the same native/bvh_builder.cpp (the jax_native_bvh fixture),
so no test writes into native/. The kernels run only on a card
(tests/test_torch_cuda.py).
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvrl_tpu.geometry import bvh as jbvh
from alvrl_tpu.geometry import intersect as jintersect
from alvrl_tpu.geometry import shapes as jshapes
from alvrl_tpu_torch.geometry import bvh, intersect, shapes
from alvrl_tpu_torch.scene import presets
from alvrl_tpu_torch.scripts import bench_bvh_large as bench
from alvrl_tpu_torch.scripts import probe_gather as probe

torch.set_num_threads(1)

BVH_FIELDS = ("bounds_lo", "bounds_hi", "left", "right", "prim_start",
              "prim_count", "prim_order", "tri_p0", "tri_e1", "tri_e2")


@pytest.fixture()
def jax_native_bvh(monkeypatch):
    """The JAX package's bvh module, loading the port's build of
    native/bvh_builder.cpp (same source, same bvh_build C ABI)."""
    monkeypatch.setattr(jbvh, "_LIB_PATH", str(bvh._library_path()))
    monkeypatch.setattr(jbvh, "_lib", None)
    bvh.load_library()
    return jbvh


@pytest.fixture()
def jax_bench_script(monkeypatch):
    """scripts/bench_bvh_large.py as a module, with its import of the
    JAX compilation cache (which writes under HOME) made a no-op."""
    import importlib.util
    import os

    monkeypatch.setitem(sys.modules, "scripts._cache",
                        types.ModuleType("scripts._cache"))
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "bench_bvh_large.py")
    spec = importlib.util.spec_from_file_location("jax_bench_bvh_large", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _soup(n, seed):
    """tests/test_bvh.py's soup of n small random triangles in [-1, 1]^3."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, (n, 1, 3))
    offsets = rng.normal(0, 0.08, (n, 3, 3))
    verts = (centers + offsets).reshape(-1, 3).astype(np.float32)
    return verts, np.arange(3 * n, dtype=np.int32).reshape(n, 3)


def _rays(n, seed):
    """tests/test_bvh.py's rays: origins in [-2, 2]^3, unit directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("mesh", ["soup", "cube", "sphere"])
def test_build_matches_jax(jax_native_bvh, mesh):
    """The port's build gives the JAX package's arrays, bit for bit."""
    v, f = {"soup": lambda: _soup(300, 1), "cube": shapes.cube,
            "sphere": lambda: shapes.sphere(n_theta=12, n_phi=20)}[mesh]()
    ref = jax_native_bvh.build(v, f)
    ours = bvh.build(v, f, device="cpu")
    for name in BVH_FIELDS:
        a, b = np.asarray(getattr(ref, name)), getattr(ours, name).numpy()
        assert np.array_equal(a, b) and a.dtype.kind == b.dtype.kind, name
        if a.dtype.kind == "f":
            assert a.tobytes() == b.tobytes(), name
    assert ours.depth == bvh.tree_depth(np.stack(
        [np.asarray(ref.left), np.asarray(ref.right),
         np.asarray(ref.prim_start), np.asarray(ref.prim_count)], axis=1))
    assert np.array_equal(np.sort(ours.prim_order.numpy()),
                          np.arange(len(f)))


def test_intersect_matches_intersect_all(jax_native_bvh):
    """tests/test_bvh.py's traversal check: the closest hits through the
    BVH equal the port's and the JAX package's brute force (valid, prim,
    t), and the JAX package's BVH traversal on the same tree."""
    v, f = _soup(300, 1)
    o, d = _rays(128, 2)
    tree = bvh.build(v, f, device="cpu")
    t, prim, valid = bvh.intersect(tree, torch.as_tensor(o),
                                   torch.as_tensor(d))
    ours = intersect.intersect_all(torch.as_tensor(o), torch.as_tensor(d),
                                   torch.as_tensor(v),
                                   torch.as_tensor(f).long())
    ref = jintersect.intersect_all(jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(v), jnp.asarray(f))
    assert torch.equal(valid, ours.valid) and torch.equal(prim, ours.prim)
    assert torch.equal(t[valid], ours.t[valid])
    assert np.array_equal(valid.numpy(), np.asarray(ref.valid))
    assert np.array_equal(prim.numpy(), np.asarray(ref.prim))
    np.testing.assert_allclose(t[valid].numpy(), np.asarray(ref.t)[valid],
                               rtol=1e-6)
    jtree = jax_native_bvh.build(v, f)
    jt, jp, jv = jax.vmap(lambda oo, dd: jax_native_bvh.intersect(
        jtree, oo, dd))(jnp.asarray(o), jnp.asarray(d))
    assert np.array_equal(np.asarray(jv), valid.numpy())
    assert np.array_equal(np.asarray(jp)[valid], prim[valid].numpy())
    assert 0 < int(valid.sum())


def test_intersect_axis_aligned_rays_in_a_box():
    """Rays along the axes and in the walls' planes of cornell_smoke (its
    boxes are flat): the BVH's hits are intersect_all's."""
    scene = presets.cornell_smoke(device="cpu")
    rng = np.random.default_rng(3)
    o = rng.uniform(-0.9, 0.9, (600, 3)).astype(np.float32)
    d = np.zeros((600, 3), np.float32)
    d[np.arange(600), rng.integers(0, 3, 600)] = rng.choice([-1.0, 1.0], 600)
    o[:100, 1] = -1.0  # in the floor's plane
    o[100:200, 2] = 1.0  # in the back wall's plane
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    tree = bvh.build(scene.vertices, scene.faces)
    t, prim, valid = bvh.intersect(tree, o, d)
    ref = intersect.intersect_all(o, d, scene.vertices, scene.faces)
    assert torch.equal(valid, ref.valid) and torch.equal(prim, ref.prim)
    assert torch.equal(t[valid], ref.t[valid])


def test_occluded_matches_bruteforce():
    """Any-hit through the BVH against the port's and the JAX package's
    brute-force occlusion: random segments among the soup, and
    tests/test_bvh.py's three segments against a cube."""
    v, f = _soup(300, 1)
    rng = np.random.default_rng(4)
    p = rng.uniform(-1.5, 1.5, (512, 3)).astype(np.float32)
    q = rng.uniform(-1.5, 1.5, (512, 3)).astype(np.float32)
    tree = bvh.build(v, f, device="cpu")
    out = bvh.occluded(tree, torch.as_tensor(p), torch.as_tensor(q))
    ours = intersect.occluded(torch.as_tensor(p), torch.as_tensor(q),
                              torch.as_tensor(v), torch.as_tensor(f).long())
    ref = jintersect.occluded(jnp.asarray(p), jnp.asarray(q), jnp.asarray(v),
                              jnp.asarray(f))
    assert torch.equal(out, ours)
    assert np.array_equal(out.numpy(), np.asarray(ref))
    assert 0 < int(out.sum()) < len(out)
    cv, cf = shapes.cube()
    p0 = torch.tensor([[0.0, 0.0, -2.0], [0.0, 0.0, 0.5], [2.0, 2.0, 2.0]])
    p1 = torch.tensor([[0.0, 0.0, 2.0], [0.0, 0.0, -0.5], [3.0, 3.0, 3.0]])
    blocked = bvh.occluded(bvh.build(cv, cf, device="cpu"), p0, p1)
    assert blocked.tolist() == intersect.occluded(
        p0, p1, torch.as_tensor(cv), torch.as_tensor(cf).long()).tolist()


def test_c1_axis_ray_finds_the_near_surface(jax_native_bvh):
    """ROADMAP C1, a deliberate divergence: on tests/test_bvh.py::
    test_bunny_scale_build's sphere and ray, the port's traversal returns
    the near surface (t = 2.0, intersect_all's hit), where the JAX
    package's, which replaces the zero direction components with 1e-12,
    culls a subtree and returns the far one (t = 4.0)."""
    v, f = shapes.sphere(radius=1.0, n_theta=32, n_phi=64)
    o, d = torch.tensor([[0.0, 0.0, -3.0]]), torch.tensor([[0.0, 0.0, 1.0]])
    t, prim, valid = bvh.intersect(bvh.build(v, f, device="cpu"), o, d)
    ref = intersect.intersect_all(o, d, torch.as_tensor(v),
                                  torch.as_tensor(f).long())
    assert bool(valid[0]) and abs(float(t[0]) - 2.0) < 1e-2
    assert int(prim[0]) == int(ref.prim[0]) and float(t[0]) == float(ref.t[0])
    jt, _, jvalid = jax_native_bvh.intersect(
        jax_native_bvh.build(v, f), jnp.asarray([0.0, 0.0, -3.0]),
        jnp.asarray([0.0, 0.0, 1.0]))
    assert bool(jvalid) and abs(float(jt) - 4.0) < 1e-2


def test_traversal_refuses_a_deep_tree(monkeypatch):
    v, f = _soup(64, 5)
    tree = bvh.build(v, f, device="cpu")
    monkeypatch.setattr(bvh, "STACK_DEPTH", tree.depth)
    with pytest.raises(ValueError):
        bvh.intersect(tree, torch.zeros((1, 3)), torch.ones((1, 3)))


@pytest.mark.parametrize("args", [
    {}, dict(center=(0.25, -0.35, 0.3), radius=0.35, n_theta=16, n_phi=32),
    dict(radius=1.0, n_theta=64, n_phi=128)])
def test_sphere_matches_jax(args):
    a, b = jshapes.sphere(**args), shapes.sphere(**args)
    assert a[0].dtype == b[0].dtype and a[0].tobytes() == b[0].tobytes()
    assert np.array_equal(a[1], b[1]) and a[1].dtype == b[1].dtype


@pytest.mark.parametrize("kind, n", [("cubes", 4), ("blob", 16)])
def test_bench_scenes_match_jax(jax_bench_script, kind, n):
    """cube_field_scene and blob_scene, vertex for vertex."""
    make = {"cubes": jax_bench_script.cube_field_scene,
            "blob": jax_bench_script.blob_scene}[kind]
    ref = make(16, 8, n)
    ours = bench.scene_of(kind, n, width=16, device="cpu")
    v = np.asarray(ref.vertices)
    assert v.dtype == np.float32 and v.tobytes() == ours.vertices.numpy(
    ).tobytes()
    assert np.array_equal(np.asarray(ref.faces), ours.faces.numpy())
    assert np.array_equal(np.asarray(ref.material), ours.material.numpy())
    expect = 12 * n ** 3 + 12 if kind == "cubes" else 4 * n * n + 12
    assert ours.faces.shape[0] == expect


def _jax_many(tbl, idx, reps):
    acc = jnp.zeros(idx.shape, jnp.float32)
    for k in range(reps):
        acc = acc + jnp.take_along_axis(tbl, (idx + k) % tbl.shape[1], axis=1)
    return acc


def test_probe_references_match_jax():
    """The probes' plain versions against jnp.take_along_axis on the JAX
    script's inputs: both gathers exactly, the many-gather sum (added in
    the same k order) exactly."""
    tbl, idx, tbl0, idx0 = probe.inputs("cpu")
    j = [jnp.asarray(x.numpy()) for x in (tbl, idx, tbl0, idx0)]
    assert np.array_equal(probe.lane_gather_reference(tbl, idx).numpy(),
                          np.asarray(jnp.take_along_axis(j[0], j[1], axis=1)))
    assert np.array_equal(probe.row_gather_reference(tbl0, idx0).numpy(),
                          np.asarray(jnp.take_along_axis(j[2], j[3], axis=0)))
    assert np.array_equal(probe.gather_many_reference(tbl, idx, 32).numpy(),
                          np.asarray(_jax_many(j[0], j[1], 32)))
    assert np.array_equal(np.asarray(j[0])[0], np.asarray(j[0])[77])


def test_probe_wrappers_on_the_cpu():
    """On CPU tensors the wrappers take the plain versions and count no
    launch; bad inputs raise."""
    tbl, idx, tbl0, idx0 = probe.inputs("cpu")
    before = (probe.lane_gather.launches, probe.row_gather.launches,
              probe.gather_many.launches)
    assert torch.equal(probe.lane_gather(tbl, idx),
                       probe.lane_gather_reference(tbl, idx))
    assert torch.equal(probe.row_gather(tbl0, idx0),
                       probe.row_gather_reference(tbl0, idx0))
    assert torch.equal(probe.gather_many(tbl, idx, 8),
                       probe.gather_many_reference(tbl, idx, 8))
    assert (probe.lane_gather.launches, probe.row_gather.launches,
            probe.gather_many.launches) == before
    for bad in (idx.long(), idx + 128, idx[:, :64].contiguous(), idx.T):
        with pytest.raises((TypeError, ValueError)):
            probe.lane_gather(tbl, bad)
    with pytest.raises(TypeError):
        probe.row_gather(tbl0.double(), idx0)
