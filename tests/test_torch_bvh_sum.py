"""alvrl_tpu_torch.ops.vrl_sum_bvh and the large-mesh render against
alvrl_tpu, on the same numpy inputs.

The plain version of kernel 7 is held against the JAX integrand
(pair_contribution) on a scene of a few thousand triangles, the whole
slice (render_with_vrls_kernel_bvh) against render_with_vrls_pallas_bvh
run in Pallas interpret mode with the same per-draw uniforms, the
Morton order against the JAX package's, the BVH pack against its
definition; the wrapper's input checks. The JAX package's native BVH
builder is the port's g++ build of the same source (so no test writes
into native/). The kernel itself runs only on a CUDA card: see
tests/test_torch_cuda.py.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from alvrl_tpu.geometry import bvh as jbvh
from alvrl_tpu.integrators.vrl import integrator as jintegrator
from alvrl_tpu.integrators.vrl import vrl as jvrl
from alvrl_tpu.integrators.vrl.integrate import VRLConfig as JVRLConfig
from alvrl_tpu.integrators.vrl.integrate import pair_contribution
from alvrl_tpu.media import api as mapi
from alvrl_tpu.ops import vrl_pallas as vp
from alvrl_tpu.scene import presets as jpresets
from alvrl_tpu.sensors import perspective as jperspective
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.geometry import bvh
from alvrl_tpu_torch.integrators.vrl import integrator, vrl
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops import vrl_sum_bvh as vb
from alvrl_tpu_torch.ops.vrl_sum import (
    HOMOG_MEDIAN,
    HOMOG_SHARE,
    homog_bar,
    philox_uniforms,
    vrl_sum,
)
from alvrl_tpu_torch.scene import presets
from tests.torch_port_utils import (
    BENCH_VRLS,
    SEQ_UNIFORMS,
    hit_from_jax,
    in_child,
    jax_scene_leaves,
    jax_vrls_leaves,
)

torch.set_num_threads(1)


def _assert_bar(out, ref):
    median, share = homog_bar(out, ref)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


def _jax_vrls(n=128):
    """The first n bench VRLs, a few of them invalid."""
    full = jvrl.load_ascii(BENCH_VRLS, particle_count=78.0)
    valid = np.asarray(full.valid[:n]).copy()
    valid[::17] = False
    return full.replace(start=full.start[:n], end=full.end[:n],
                        power=full.power[:n], valid=jnp.asarray(valid))


@pytest.fixture(scope="module")
def jax_bench_script():
    """scripts/bench_bvh_large.py as a module, its import of the JAX
    compilation cache (which writes under HOME) made a no-op."""
    import importlib.util
    import os

    saved = sys.modules.get("scripts._cache")
    sys.modules["scripts._cache"] = types.ModuleType("scripts._cache")
    try:
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "scripts", "bench_bvh_large.py")
        spec = importlib.util.spec_from_file_location("jax_bench_bvh_large",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        if saved is None:
            del sys.modules["scripts._cache"]
        else:
            sys.modules["scripts._cache"] = saved
    return mod


@pytest.fixture(scope="module")
def jax_native_bvh():
    """The JAX package's bvh module on the port's build of
    native/bvh_builder.cpp, for the module's tests."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jbvh, "_LIB_PATH", str(bvh._library_path()))
    mp.setattr(jbvh, "_lib", None)
    bvh.load_library()
    yield jbvh
    mp.undo()


def test_sort_vrls_morton_matches_jax():
    """The port's Morton order is the JAX package's permutation: the
    bench VRLs (some invalid) and a random buffer with repeated
    midpoints (the stable sort's ties)."""
    rng = np.random.default_rng(0)
    start = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    start[100:120] = start[:20]
    leaves = {"start": start, "end": start + rng.normal(
        0, 0.2, (200, 3)).astype(np.float32),
        "power": rng.random((200, 3), dtype=np.float32),
        "valid": rng.random(200) < 0.8, "particle_count": np.float32(7.0)}
    leaves["end"][100:120] = leaves["end"][:20]
    for jv in (_jax_vrls(), jvrl.VRLs(**{k: jnp.asarray(v)
                                        for k, v in leaves.items()})):
        ref = vp.sort_vrls_morton(jv)
        ours = vb.sort_vrls_morton(convert.vrls_from_numpy(
            jax_vrls_leaves(jv), device="cpu"))
        for k, a in jax_vrls_leaves(ref).items():
            assert torch.equal(getattr(ours, k), torch.as_tensor(a)), k


def test_pack_bvh_tris_covers_and_bounds():
    """Every opaque triangle is in the pack once, as pack_tris packs it;
    each node holds two children, each leaf child's padded box holds its
    triangles, each inner child's box the boxes of its own children; the
    depth is the tree's."""
    scene = presets.cornell_smoke(16, 16, device="cpu")
    rng = np.random.default_rng(1)
    opaque = torch.as_tensor(rng.random(scene.faces.shape[0]) < 0.7)
    pack = vb.pack_bvh_tris(scene.vertices, scene.faces, opaque)
    flat = pk.pack_tris(scene)[opaque]
    assert pack.tris.shape == flat.shape
    key = lambda t: sorted(map(tuple, t.tolist()))
    assert key(pack.tris) == key(flat)
    nodes = pack.nodes.numpy()
    assert nodes.shape[1] == vb.NODE_COLS == 16
    ref = nodes.view(np.int32)[:, [3, 11]]
    lo = nodes[:, [[0, 1, 2], [8, 9, 10]]]
    hi = nodes[:, [[4, 5, 6], [12, 13, 14]]]
    tris = pack.tris.numpy()
    corners = np.stack([tris[:, 0:3], tris[:, 0:3] + tris[:, 3:6],
                        tris[:, 0:3] + tris[:, 6:9]], axis=1)
    depth, level, seen, leaves = 0, [(0, 1)], [], 0
    while level:
        nxt = []
        for node, d in level:
            for k in range(2):
                r = int(ref[node, k])
                depth = max(depth, d)
                if r < 0:
                    first, count = ~r >> vb.LEAF_BITS, ~r & 7
                    assert 1 <= count <= vb.LEAF_SIZE
                    leaves += 1
                    seen += range(first, first + count)
                    c = corners[first:first + count].reshape(-1, 3)
                    assert (c >= lo[node, k]).all()
                    assert (c <= hi[node, k]).all()
                else:
                    assert (lo[r] >= lo[node, k]).all()
                    assert (hi[r] <= hi[node, k]).all()
                    nxt.append((r, d + 1))
        level = nxt
    assert sorted(seen) == list(range(len(tris)))
    assert depth == pack.depth
    assert len(nodes) == leaves - 1  # one node per inner node of the tree


def test_pack_bvh_tris_refuses_a_deep_tree(monkeypatch):
    """A tree deeper than the kernel's stack allows is refused on the
    host, as the wrapper refuses such a pack."""
    scene = presets.cornell_smoke(8, 8, device="cpu")
    opaque = scene.opaque_faces()
    pack = vb.pack_bvh_tris(scene.vertices, scene.faces, opaque)
    monkeypatch.setattr(vb, "BVH_STACK", pack.depth - 1)
    with pytest.raises(ValueError):
        vb.pack_bvh_tris(scene.vertices, scene.faces, opaque)
    packs = integrator.pack_frame(scene, vrl.compact(
        vrl.load_ascii(BENCH_VRLS, particle_count=78.0, device="cpu")))[3]
    with pytest.raises(ValueError):
        vb.vrl_sum_bvh(packs[0], packs[1], pack, packs[3])


def test_reference_matches_pair_contribution(jax_bench_script,
                                             jax_native_bvh):
    """The plain version vs the JAX integrand (whose shadow test is brute
    force over the scene's faces) with per-pair random uniforms: 8 eye
    rays x 128 VRLs (a few invalid) in a field of 6^3 cubes (2,604
    triangles), summed over the VRLs; the CPU wrapper gives the same."""
    rng = np.random.default_rng(7)
    jscene = mapi.prepare_scene(jax_bench_script.cube_field_scene(16, 16, 6))
    px = jnp.asarray(rng.integers(0, 16, 8))
    py = jnp.asarray(rng.integers(0, 16, 8))
    ray_o, ray_d = jperspective.sample_ray(jscene.camera, px, py)
    jhit = jintegrator.trace_eye_rays(jscene, ray_o, ray_d)
    jvrls = _jax_vrls()
    u = rng.random((8, 128, 6), dtype=np.float32)
    expand = lambda a: a[:, None] if a.ndim == 1 else a[:, None, :]
    total, _, _ = pair_contribution(
        jscene, expand(ray_o), expand(ray_d), expand(jhit.p),
        expand(jhit.valid), expand(jhit.ng), expand(jhit.mat),
        jvrls.start[None], jvrls.end[None], jvrls.power[None],
        jvrls.valid[None], jnp.asarray(u[..., :4].reshape(8, 128, 2, 2)),
        jnp.asarray(u[..., 4:]), JVRLConfig())
    ref = torch.as_tensor(np.asarray(jnp.sum(total, axis=1)))

    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device="cpu")
    assert scene.faces.shape[0] == 2604
    mat = torch.as_tensor(np.asarray(jhit.mat), dtype=torch.int64)
    rays = pk.pack_rays(scene, torch.as_tensor(np.asarray(ray_o)),
                        torch.as_tensor(np.asarray(ray_d)), hit_from_jax(jhit),
                        mat)
    vrls = pk.pack_vrls(convert.vrls_from_numpy(jax_vrls_leaves(jvrls),
                                                device="cpu"))
    pack = vb.pack_bvh_tris(scene.vertices, scene.faces, scene.opaque_faces())
    med = pk.pack_medium(scene)
    out = vb.vrl_sum_bvh_reference(rays, vrls, pack, med, torch.as_tensor(u))
    assert float(ref.abs().sum()) > 0.0
    _assert_bar(out.T, ref)
    assert torch.equal(vb.vrl_sum_bvh(rays, vrls, pack, med,
                                      uniforms=torch.as_tensor(u)), out)


def _interpret_render():
    """jax_bvh_render's image and _u01 calls, with the JAX package's bvh
    module on the port's build of native/bvh_builder.cpp (as
    jax_native_bvh patches it). Run by in_child."""
    calls = {"i": 0}

    def mock(shape):
        v = SEQ_UNIFORMS[calls["i"] % len(SEQ_UNIFORMS)]
        calls["i"] += 1
        return jnp.full(shape, v, jnp.float32)

    mp = pytest.MonkeyPatch()
    mp.setattr(jbvh, "_LIB_PATH", str(bvh._library_path()))
    mp.setattr(jbvh, "_lib", None)
    bvh.load_library()
    jax.clear_caches()
    mp.setattr(vp, "_u01", mock)
    try:
        with pltpu.force_tpu_interpret_mode():
            img = np.asarray(jintegrator.render_with_vrls_pallas_bvh(
                jpresets.cornell_smoke(width=16, height=8), _jax_vrls(),
                jax.random.key(1), JVRLConfig()))
    finally:
        mp.undo()
        jax.clear_caches()
    return img, calls["i"]


@pytest.fixture(scope="module")
def jax_bvh_render(jax_native_bvh):
    """render_with_vrls_pallas_bvh in interpret mode on cornell_smoke
    16x8 with 128 bench VRLs, vp._u01 returning the next SEQ_UNIFORMS
    constant at each call while the kernel is traced (jit caches cleared
    around it), computed in a child process (in_child): (the JAX scene,
    VRLs, image, _u01 calls)."""
    img, n_calls = in_child(_interpret_render)
    return (jpresets.cornell_smoke(width=16, height=8), _jax_vrls(), img,
            n_calls)


def test_slice_matches_pallas_bvh_interpret(jax_bvh_render):
    """The whole slice, render_with_vrls_kernel_bvh on the CPU (BVH hits,
    Morton order, the BVH pack, the plain version), against
    render_with_vrls_pallas_bvh, both on the same per-draw constants."""
    jscene, jvrls, ref, n_calls = jax_bvh_render
    assert n_calls == len(SEQ_UNIFORMS)
    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device="cpu")
    vrls = convert.vrls_from_numpy(jax_vrls_leaves(jvrls), device="cpu")
    u = torch.tensor(SEQ_UNIFORMS).expand(128, 128, 6).contiguous()
    img = integrator.render_with_vrls_kernel_bvh(
        scene, vrls, torch.Generator().manual_seed(0), uniforms=u)
    assert img.shape == (8, 16, 3) and float(img.mean()) > 0.0
    _assert_bar(img, torch.as_tensor(ref))
    flat = integrator.render_with_vrls_kernel(  # brute-force hits, flat sweep
        scene, vb.sort_vrls_morton(vrls), torch.Generator().manual_seed(0),
        uniforms=u)
    assert torch.equal(img, flat)


def _bench_packs(n_vrls=64):
    scene = presets.cornell_smoke(8, 4, device="cpu")
    full = vrl.load_ascii(BENCH_VRLS, particle_count=78.0, device="cpu")
    vrls = vrl.VRLs(full.start[:n_vrls], full.end[:n_vrls],
                    full.power[:n_vrls], full.valid[:n_vrls],
                    full.particle_count)
    return scene, integrator.pack_frame_bvh(scene, vrls)[3]


def test_wrapper_cpu_takes_the_plain_version():
    """On CPU tensors vrl_sum_bvh runs the plain version on the Philox
    stream of its seed and counts no launch; its sums are vrl_sum's on
    the flat triangle pack (the same function)."""
    scene, packs = _bench_packs()
    before = vb.vrl_sum_bvh.launches
    out = vb.vrl_sum_bvh(*packs, seed=99)
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    ref = vb.vrl_sum_bvh_reference(*packs, philox_uniforms(99, n_rays,
                                                           n_vrls, 6))
    assert torch.equal(out, ref) and vb.vrl_sum_bvh.launches == before
    assert float(out.sum()) > 0.0
    flat = vrl_sum(packs[0], packs[1], pk.pack_tris(scene), packs[3],
                   seed=99)
    assert torch.equal(out, flat)
    with pytest.raises(ValueError):
        vb.vrl_sum_bvh_counts(*packs, seed=99)


def test_grid_medium_raises():
    """Kernel 7 is homogeneous only, as the JAX kernel: the entry point
    refuses a grid medium, and the wrapper the grid packs."""
    scene = presets.cornell_grid_smoke(8, 8, grid_res=8, device="cpu")
    vrls = vrl.compact(vrl.load_ascii(BENCH_VRLS, particle_count=78.0,
                                      device="cpu"))
    with pytest.raises(ValueError):
        integrator.render_with_vrls_kernel_bvh(scene, vrls,
                                               torch.Generator())
    packs = integrator.pack_frame(scene, vrls)[3]
    pack = vb.pack_bvh_tris(scene.vertices, scene.faces, scene.opaque_faces())
    with pytest.raises(ValueError):
        vb.vrl_sum_bvh(packs[0], packs[1], pack, packs[3])


BAD_INPUTS = {
    "not_a_pack": lambda p: dict(bvh=(p.nodes, p.tris, p.depth)),
    "node_cols": lambda p: dict(bvh=p._replace(nodes=p.nodes[:, :15]
                                               .contiguous())),
    "node_dtype": lambda p: dict(bvh=p._replace(nodes=p.nodes.double())),
    "node_strided": lambda p: dict(bvh=p._replace(
        nodes=p.nodes.T.contiguous().T)),
    "nodes_without_tris": lambda p: dict(bvh=p._replace(
        tris=p.tris[:0].contiguous())),
    "depth": lambda p: dict(bvh=p._replace(depth=vb.BVH_STACK + 1)),
    "tri_cols": lambda p: dict(bvh=p._replace(tris=p.tris[:, :8]
                                              .contiguous())),
    "medium_len": lambda p: dict(medium=torch.zeros(18)),
    "uniforms_shape": lambda p: dict(uniforms=torch.zeros(32, 64, 5)),
    "phase_kind": lambda p: dict(phase_kind=2),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_wrapper_rejects_bad_inputs(case):
    _, (rays, vrls, pack, med) = _bench_packs()
    args = dict(rays=rays, vrls=vrls, bvh=pack, medium=med)
    args.update(BAD_INPUTS[case](pack))
    with pytest.raises((TypeError, ValueError)):
        vb.vrl_sum_bvh(args.pop("rays"), args.pop("vrls"), args.pop("bvh"),
                       args.pop("medium"), **args)
