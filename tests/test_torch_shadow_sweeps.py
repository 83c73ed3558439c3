"""The shadow sweeps of kernels 1 and 7 in plain torch, on the CPU.

Kernel 7 (csrc/vrl_sum_bvh.cu) walks a BVH whose nodes hold both
children's boxes, pushing only far children; a plain torch emulation of
that traversal (one lane per segment) must make the flat sweep's any-hit
decisions (ops.vrl_sum._occluded_packed, every triangle's Wald test) on
segments of small cube-field and blob scenes, with a stack that never
holds more entries than the tree is deep. Kernel 1 (csrc/vrl_sum.cu)
skips a triangle's Wald test when both tested ends of a segment lie on
one side of its plane by a margin (vrl_common.cuh PlaneTris); the plain
float32 twin of that pre-reject (ops.vrl_sum.plane_skip) must never skip
a triangle whose Wald test blocks the segment, on adversarial segments,
on every shadow segment of a 16x16 cornell_smoke render, on every one
that the plain backward of a 16x16 train step tests, which kernel 8
(csrc/vrl_sum_bwd.cu) sweeps with the same pre-reject, and on every one
that the plain grid R and grid clustered sum test in a 16x16
cornell_grid_smoke pass, which kernels 6 (csrc/vrl_r.cu) and 4
(csrc/vrl_sum_clustered.cu) sweep with it, and on every one that the
plain homogeneous R, clustered sum and clustered backward test in a
16x16 cornell_smoke clustered pass, which kernels 5 (csrc/vrl_r.cu), 2
(csrc/vrl_sum_clustered.cu) and 10 (csrc/vrl_sum_clustered_bwd.cu)
sweep with it. The kernels themselves run only on a CUDA card: see
tests/test_torch_cuda.py.
"""

import math

import numpy as np
import pytest
import torch

from alvrl_tpu_torch.integrators.vrl import alvrl, integrator, tracer, vrl
from alvrl_tpu_torch.integrators.vrl import cluster as cl
from alvrl_tpu_torch.integrators.vrl.integrate import VRLConfig
from alvrl_tpu_torch.ops import pack as pk
from alvrl_tpu_torch.ops import vrl_r as vr
from alvrl_tpu_torch.ops import vrl_sum as vs
from alvrl_tpu_torch.ops import vrl_sum_clustered as vsc
from alvrl_tpu_torch.ops import vrl_sum_bvh as vb
from alvrl_tpu_torch.ops import vrl_sum_bwd as bwd
from alvrl_tpu_torch.ops import vrl_sum_clustered_bwd as cbwd
from alvrl_tpu_torch.parallel.render import train_step
from alvrl_tpu_torch.scene import presets
from alvrl_tpu_torch.scripts import bench_bvh_large as bbl
from tests.torch_port_utils import BENCH_VRLS, chain_bvh_pack

torch.set_num_threads(1)

NONE = 0x7FFFFFFF  # csrc/vrl_sum_bvh.cu: no node


def _slab(p, inv, lo, hi, s_lo, s_hi):
    """The kernel's slab test of each segment against one box each
    (slab_overlaps): (overlaps, entry distance); fmax / fmin drop the NaN
    of a segment lying in a box's face."""
    neg = inv < 0.0
    near = (torch.where(neg, hi, lo) - p) * inv
    far = (torch.where(neg, lo, hi) - p) * inv
    t0 = torch.fmax(torch.fmax(torch.fmax(s_lo, near[:, 0]), near[:, 1]),
                    near[:, 2])
    t1 = torch.fmin(torch.fmin(torch.fmin(s_hi, far[:, 0]), far[:, 1]),
                    far[:, 2])
    return t0 <= t1, t0


def emulate_any_hit(p, q, pack):
    """The kernel's any-hit traversal of a BvhPack, one segment a lane:
    (blocked (S,) bool, node fetches (S,), the most stack entries any
    segment held). Each node's two child boxes are tested, the nearer
    overlapping child visited next and the other pushed when both
    overlap, leaves postponed one at a time and their triangles tested
    by the Wald test until the first blocker."""
    n_seg = p.shape[0]
    u, lo, hi = vs._segment(p, q)
    u, lo, hi = u[:, 0], lo[:, 0], hi[:, 0]
    inv = 1.0 / u
    nodes = pack.nodes
    refs = nodes.view(torch.int32)
    stack = torch.full((n_seg, max(pack.depth, 1) + 1), -1, dtype=torch.int64)
    sp = torch.zeros(n_seg, dtype=torch.int64)
    node = torch.zeros(n_seg, dtype=torch.int64)
    leaf = torch.full((n_seg,), NONE, dtype=torch.int64)
    blocked = torch.zeros(n_seg, dtype=torch.bool)
    done = torch.zeros(n_seg, dtype=torch.bool)
    fetches = torch.zeros(n_seg, dtype=torch.int64)
    most = 0
    rows = torch.arange(n_seg)

    def pop(mask):
        has = mask & (sp > 0)
        sp[has] -= 1
        out = torch.full((n_seg,), NONE, dtype=torch.int64)
        out[has] = stack[rows[has], sp[has]]
        return out

    while not bool(done.all()):
        # a postponed leaf: its triangles, then the node if it is a leaf
        at_leaf = ~done & (leaf != NONE)
        if bool(at_leaf.any()):
            ref = ~leaf[at_leaf]
            first, count = ref >> vb.LEAF_BITS, ref & ((1 << vb.LEAF_BITS) - 1)
            k = torch.arange(vb.LEAF_SIZE)
            idx = first[:, None] + k
            live = k < count[:, None]
            tri = pack.tris[idx.clamp(max=pack.tris.shape[0] - 1)]
            hit = (vs._wald_hits(p[at_leaf], q[at_leaf], tri) & live).any(-1)
            sel = rows[at_leaf]
            blocked[sel[hit]] = True
            done[sel[hit]] = True
            leaf[at_leaf] = NONE
            nxt = at_leaf & ~done & (node < 0)
            leaf[nxt] = node[nxt]
            node = torch.where(nxt, pop(nxt), node)
            continue
        # an inner node: both children tested, one fetch
        inner = ~done & (node != NONE) & (node >= 0)
        finished = ~done & ~inner
        done |= finished
        if not bool(inner.any()):
            continue
        sel = rows[inner]
        nd = nodes[node[inner]]
        ref = refs[node[inner]]
        fetches[sel] += 1
        args = (p[inner], inv[inner])
        h0, t0 = _slab(*args, nd[:, 0:3], nd[:, 4:7], lo[inner], hi[inner])
        h1, t1 = _slab(*args, nd[:, 8:11], nd[:, 12:15], lo[inner], hi[inner])
        c0, c1 = ref[:, 3].long(), ref[:, 11].long()
        near0 = t0 <= t1
        both = h0 & h1
        push = torch.where(near0, c1, c0)
        stack[sel[both], sp[sel[both]]] = push[both]
        sp[sel[both]] += 1
        most = max(most, int(sp.max()))
        node[sel] = torch.where(both, torch.where(near0, c0, c1),
                                torch.where(h0, c0, c1))
        empty = torch.zeros(n_seg, dtype=torch.bool)
        empty[sel[~h0 & ~h1]] = True
        node = torch.where(empty, pop(empty), node)
        post = inner & (node < 0) & (leaf == NONE)
        leaf[post] = node[post]
        node = torch.where(post, pop(post), node)
    return blocked, fetches, most


def _segments(scene, n, seed):
    """Shadow segments in the scene's box: random ends, ends on its
    triangles and axis-aligned segments (zero direction components)."""
    rng = np.random.default_rng(seed)
    v = scene.vertices.numpy()
    lo, hi = v.min(0), v.max(0)
    p = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    q = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    faces = scene.faces.numpy()
    k = rng.integers(0, len(faces), n // 4)
    w = rng.dirichlet([1.0, 1.0, 1.0], n // 4).astype(np.float32)
    p[:n // 4] = (v[faces[k]] * w[:, :, None]).sum(1)
    q[n // 4:n // 2, 1:] = p[n // 4:n // 2, 1:]
    return torch.as_tensor(p), torch.as_tensor(q)


@pytest.mark.parametrize("kind,n", [("cubes", 4), ("blob", 16)])
def test_traversal_emulation_decides_as_the_flat_sweep(kind, n):
    """Two-box nodes and a far-child stack: the flat sweep's decisions on
    4,000 segments of a small bench scene, the stack at most the tree's
    depth, fewer node fetches than the tree has nodes."""
    scene = bbl.scene_of(kind, n, width=8, device="cpu")
    pack = vb.pack_bvh_tris(scene.vertices, scene.faces, scene.opaque_faces())
    p, q = _segments(scene, 4000, seed=n)
    blocked, fetches, most = emulate_any_hit(p, q, pack)
    ref = vs._occluded_packed(p, q, pack.tris)
    assert 0.05 < float(ref.float().mean()) < 0.95
    assert torch.equal(blocked, ref)
    assert 1 <= most <= pack.depth <= vb.BVH_STACK
    assert int(fetches.min()) >= 1
    assert float(fetches.double().mean()) < pack.nodes.shape[0]


def test_traversal_emulation_on_a_tree_as_deep_as_the_stack():
    """A chain tree as deep as the kernel serves (BVH_STACK), over
    cornell_smoke's 24 triangles: the flat sweep's decisions, the stack
    filled to exactly the depth."""
    scene = presets.cornell_smoke(8, 8, device="cpu")
    flat = vb.pack_bvh_tris(scene.vertices, scene.faces, scene.opaque_faces())
    pack = chain_bvh_pack(flat.tris, vb.BVH_STACK)
    p, q = _segments(scene, 2000, seed=63)
    blocked, fetches, most = emulate_any_hit(p, q, pack)
    ref = vs._occluded_packed(p, q, pack.tris)
    assert 0.05 < float(ref.float().mean()) < 0.95
    assert torch.equal(blocked, ref)
    assert most == pack.depth == vb.BVH_STACK
    assert int(fetches.max()) == pack.depth


def _planes_and_hits(p, q, tris):
    return vs.plane_skip(p, q, vs.plane_pack(tris)), vs._wald_hits(p, q, tris)


def _tri(p0, e1, e2):
    return torch.tensor([[*p0, *e1, *e2]], dtype=torch.float32)


def _adversarial(case, rng):
    """(p, q, tris) of one family of hard segments."""
    n = 4000
    tri = _tri((-0.7, -0.6, 0.3), (1.5, 0.1, -0.2), (0.2, 1.3, 0.1))
    p0, e1, e2 = tri[0, 0:3], tri[0, 3:6], tri[0, 6:9]
    nrm = torch.linalg.cross(e1, e2)
    nrm = nrm / nrm.norm()
    a, b = rng.random((n, 1)), rng.random((n, 1))
    inside = p0 + torch.as_tensor(a * (1 - b), dtype=torch.float32) * e1 \
        + torch.as_tensor(a * b, dtype=torch.float32) * e2
    d = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    if case == "ends_on_the_plane":
        # a quarter from a point of the triangle, a quarter through one
        # (a blocker), the rest with the tested end (lo along the
        # direction from p) on the triangle's plane
        dn = d / d.norm(dim=1, keepdim=True)
        length = 2.0 * d.norm(dim=1, keepdim=True)
        lo = 1e-3 * torch.clamp(length, min=1.0)
        p = inside - lo * dn
        q = p + length * dn
        p[:n // 4], q[:n // 4] = inside[:n // 4], inside[:n // 4] + d[:n // 4]
        h = slice(n // 4, n // 2)
        p[h], q[h] = inside[h] - d[h], inside[h] + d[h]
        return p, q, tri
    if case == "ends_within_an_ulp":
        # the tested end on the plane, then p moved by one ulp per axis
        dn = d / d.norm(dim=1, keepdim=True)
        length = 2.0 * d.norm(dim=1, keepdim=True)
        p = inside - 1e-3 * torch.clamp(length, min=1.0) * dn
        q = p + length * dn
        away = torch.as_tensor(rng.choice([-1.0, 1.0], (n, 3)),
                               dtype=torch.float32) * math.inf
        return torch.nextafter(p, away), q, tri
    if case == "grazing_edges":
        t = torch.as_tensor(rng.random((n, 1)), dtype=torch.float32)
        edge = p0 + t * e1  # points of an edge, segments near the plane
        tangent = e1 * torch.as_tensor(rng.normal(size=(n, 1)),
                                       dtype=torch.float32) + 1e-4 * d
        return edge - tangent, edge + tangent, tri
    if case == "parallel_to_the_plane":
        off = torch.as_tensor(rng.normal(scale=1e-3, size=(n, 1)),
                              dtype=torch.float32)
        along = torch.linalg.cross(nrm.expand(n, 3), d)
        p = inside + off * nrm - along
        return p, inside + off * nrm + along, tri
    if case == "degenerate_triangles":
        tris = torch.cat([
            _tri((0.1, 0.2, 0.3), (0.0, 0.0, 0.0), (0.5, 0.1, 0.2)),
            _tri((0.1, 0.2, 0.3), (0.5, 0.1, 0.2), (1.0, 0.2, 0.4)),
            _tri((0.1, 0.2, 0.3), (1e-20, 0.0, 0.0), (0.0, 1e-20, 0.0)),
            _tri((0.1, 0.2, 0.3), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0))])
        p = torch.as_tensor(rng.uniform(-1, 1, (n, 3)), dtype=torch.float32)
        return p, torch.full_like(p, 0.2) + 0.1 * d, tris
    raise ValueError(case)


@pytest.mark.parametrize("case", [
    "ends_on_the_plane", "ends_within_an_ulp", "grazing_edges",
    "parallel_to_the_plane", "degenerate_triangles"])
def test_plane_pre_reject_never_skips_a_blocker(case):
    """The float32 twin of kernel 1's pre-reject skips no triangle whose
    Wald test blocks the segment, on segments built to sit at its edge."""
    p, q, tris = _adversarial(case, np.random.default_rng(11))
    skip, hits = _planes_and_hits(p, q, tris)
    assert not bool((skip & hits).any())
    if case == "ends_on_the_plane":
        assert bool(hits.any())  # the family does reach blocking tests


def test_plane_pre_reject_on_a_renders_segments():
    """Every shadow segment of a 16x16 cornell_smoke render (the plain
    kernel's own shadow tests, intercepted): no skipped triangle blocks,
    and the pre-reject skips most triangle tests."""
    scene = presets.cornell_smoke(16, 16, device="cpu")
    vrls = vrl.compact(vrl.load_ascii(BENCH_VRLS, particle_count=78.0,
                                      device="cpu"), 512)
    packs = integrator.pack_frame(scene, vrls)[3]
    seen = {"tests": 0, "skips": 0, "bad": 0, "segments": 0}
    test = vs._occluded_packed

    def spy(p, q, tris):
        skip, hits = _planes_and_hits(p, q, tris)
        seen["tests"] += skip.numel()
        seen["skips"] += int(skip.sum())
        seen["bad"] += int((skip & hits).sum())
        seen["segments"] += skip.numel() // tris.shape[0]
        return test(p, q, tris)

    vs._occluded_packed = spy
    try:
        vs.vrl_sum_reference(*packs, vs.philox_uniforms(7, 256, 512, 6))
    finally:
        vs._occluded_packed = test
    assert seen["segments"] >= 256 * 508 * 4 // 2
    assert seen["bad"] == 0
    assert seen["skips"] > 0.5 * seen["tests"]


def test_pre_reject_on_a_train_steps_backward_segments(monkeypatch):
    """Every shadow segment of the plain backward of a 16x16 cornell_smoke
    train step (8 particles traced to depth 4, seeded): no triangle that
    the pre-reject skips blocks the segment, and it skips most tests."""
    scene = presets.cornell_smoke(16, 16, device="cpu")
    seen = {"segments": 0, "tests": 0, "skips": 0, "bad": 0}
    in_backward = [False]
    test, plain_bwd = vs._occluded_packed, bwd.vrl_sum_bwd_reference

    def spy(p, q, tris):
        if in_backward[0]:
            skip = vs.plane_skip(p, q, vs.plane_pack(tris))
            hits = vs._wald_hits(p, q, tris)
            seen["segments"] += skip.numel() // tris.shape[0]
            seen["tests"] += skip.numel()
            seen["skips"] += int(skip.sum())
            seen["bad"] += int((skip & hits).sum())
        return test(p, q, tris)

    def backward(*args, **kw):
        in_backward[0] = True
        try:
            return plain_bwd(*args, **kw)
        finally:
            in_backward[0] = False

    monkeypatch.setattr(vs, "_occluded_packed", spy)
    monkeypatch.setattr(bwd, "vrl_sum_bwd_reference", backward)
    target = torch.zeros((16, 16, 3))
    loss, grads = train_step(scene, torch.Generator().manual_seed(5), target,
                             VRLConfig(), 8, tracer.TracerConfig(max_depth=4))
    assert float(loss) > 0.0 and all(bool(torch.isfinite(g).all())
                                     for g in grads.values())
    assert seen["segments"] >= 256 * 4  # every ray's pairs, four samples
    assert seen["bad"] == 0
    assert seen["skips"] > 0.5 * seen["tests"]


def test_pre_reject_on_a_grid_clustered_pass_segments(monkeypatch):
    """Every shadow segment that the plain grid R (kernel 6's) and the
    plain grid clustered sum (kernel 4's) test in a 16x16
    cornell_grid_smoke pass (an 8^3 grid, 32 particles traced to depth 6
    into 128 slots, 6 slices): no triangle that the pre-reject skips
    blocks the segment. The vol-surf segments that start on a wall hit
    (their tested end 1e-3 of the segment's length off the wall's plane)
    are among them, and there the pre-reject skips fewer of the walls'
    tests than elsewhere."""
    scene = presets.cornell_grid_smoke(16, 16, grid_res=8, device="cpu")
    planes = vs.plane_pack(pk.pack_tris(scene))
    n = planes[:, 0:3]
    seen = {k: {"segments": 0, "tests": 0, "skips": 0, "bad": 0,
                "on_wall": 0, "wall_tests": 0, "wall_skips": 0}
            for k in ("r", "clustered")}
    stage = ["r"]
    test = vs._occluded_packed

    def spy(p, q, tris):
        p, q = torch.broadcast_tensors(p, q)
        skip = vs.plane_skip(p, q, planes)
        hits = vs._wald_hits(p, q, tris)
        # a start on some wall's plane (within 1e-5 of its scale)
        dist = ((p[..., None, :] * n).sum(-1) - planes[:, 3]).abs()
        on_wall = (dist <= 1e-5 * n.norm(dim=-1)).any(dim=-1)
        c = seen[stage[0]]
        c["segments"] += on_wall.numel()
        c["tests"] += skip.numel()
        c["skips"] += int(skip.sum())
        c["bad"] += int((skip & hits).sum())
        c["on_wall"] += int(on_wall.sum())
        c["wall_tests"] += int(on_wall.sum()) * tris.shape[0]
        c["wall_skips"] += int(skip[on_wall].sum())
        return test(p, q, tris)

    monkeypatch.setattr(vs, "_occluded_packed", spy)
    params = alvrl.ALVRLParams(
        vrl_target_num=128, num_particles=32, seed=0,
        cluster=cl.ClusterParams(target_num_slices=6,
                                 target_pixel_undersampling=8.0))
    cfg = VRLConfig()
    vrls = vrl.compact(tracer.trace(scene, torch.Generator().manual_seed(3),
                                    32, tracer.TracerConfig(max_depth=6)),
                       128, slots_per_particle=6)
    r_launches = vr.vrl_r_hetero.launches
    sop, tv, tw, _ = alvrl.prepare_clustering(scene, vrls, 5, params, cfg)
    assert vr.vrl_r_hetero.launches == r_launches  # the plain version ran
    stage[0] = "clustered"
    packs = integrator.pack_frame(scene, vrls)[3]
    out = vsc.vrl_sum_hetero_clustered(*packs, sop, tv, tw, seed=5,
                                       uv_steps=cfg.uv_tau_steps)
    assert bool(torch.isfinite(out).all()) and float(out.abs().sum()) > 0.0
    for c in seen.values():
        assert c["bad"] == 0, seen
        assert c["segments"] > 1000 and c["on_wall"] > 100, seen
        assert c["skips"] > 0.5 * c["tests"], seen
        assert c["wall_skips"] / c["wall_tests"] \
            < c["skips"] / c["tests"], seen


@pytest.mark.parametrize("stage", ["r", "clustered", "clustered_bwd"])
def test_pre_reject_on_a_clustered_pass_segments(monkeypatch, stage):
    """Every shadow segment that the plain homogeneous R (kernel 5's),
    the plain homogeneous clustered forward (kernel 2's) or the plain
    homogeneous clustered backward (kernel 10's, autograd through the
    plain clustered forward) tests in a 16x16 cornell_smoke clustered
    pass (32 particles traced to depth 6 into 128 slots, 6 slices, the
    R's tables): no triangle that the pre-reject skips blocks the
    segment, and it skips most tests."""
    scene = presets.cornell_smoke(16, 16, device="cpu")
    planes = vs.plane_pack(pk.pack_tris(scene))
    seen = {"segments": 0, "tests": 0, "skips": 0, "bad": 0}
    watching = [stage == "r"]
    test = vs._occluded_packed

    def spy(p, q, tris):
        if watching[0]:
            p, q = torch.broadcast_tensors(p, q)
            skip = vs.plane_skip(p, q, planes)
            hits = vs._wald_hits(p, q, tris)
            seen["segments"] += skip.numel() // tris.shape[0]
            seen["tests"] += skip.numel()
            seen["skips"] += int(skip.sum())
            seen["bad"] += int((skip & hits).sum())
        return test(p, q, tris)

    monkeypatch.setattr(vs, "_occluded_packed", spy)
    params = alvrl.ALVRLParams(
        vrl_target_num=128, num_particles=32, seed=0,
        cluster=cl.ClusterParams(target_num_slices=6,
                                 target_pixel_undersampling=8.0))
    vrls = vrl.compact(tracer.trace(scene, torch.Generator().manual_seed(3),
                                    32, tracer.TracerConfig(max_depth=6)),
                       128, slots_per_particle=6)
    r_launches = vr.vrl_r.launches
    sop, tv, tw, _ = alvrl.prepare_clustering(scene, vrls, 5, params,
                                              VRLConfig())
    assert vr.vrl_r.launches == r_launches  # the plain version ran
    if stage == "clustered":
        watching[0] = True
        packs = integrator.pack_frame(scene, vrls)[3]
        before = vsc.vrl_sum_clustered.launches
        out = vsc.vrl_sum_clustered(*packs, sop, tv, tw, seed=5)
        assert vsc.vrl_sum_clustered.launches == before
        assert bool(torch.isfinite(out).all()) and float(out.abs().sum()) > 0
    if stage == "clustered_bwd":
        watching[0] = True
        packs = integrator.pack_frame(scene, vrls)[3]
        gbar = torch.as_tensor(np.random.default_rng(2).uniform(
            0.5, 1.5, (3, 256)).astype(np.float32))
        before = cbwd.vrl_sum_clustered_bwd.launches
        out = cbwd.vrl_sum_clustered_bwd(*packs, sop, tv, tw, gbar, seed=5)
        assert cbwd.vrl_sum_clustered_bwd.launches == before
        assert all(bool(torch.isfinite(o).all()) for o in out)
        assert float(out[2].abs().sum()) > 0.0
    assert seen["bad"] == 0, seen
    assert seen["segments"] > 1000, seen
    assert seen["skips"] > 0.5 * seen["tests"], seen


def test_grid_checking_launches_need_the_card():
    """Kernels 2's, 4's, 5's and 6's checking launches take CUDA tensors
    only."""
    scene = presets.cornell_grid_smoke(4, 4, grid_res=4, device="cpu")
    vrls = vrl.compact(vrl.load_ascii(BENCH_VRLS, particle_count=78.0,
                                      device="cpu"), 512)
    packs = integrator.pack_frame(scene, vrls)[3]
    with pytest.raises(ValueError):
        vr.vrl_r_hetero_check(*packs)
    homog = integrator.pack_frame(presets.cornell_smoke(4, 4, device="cpu"),
                                  vrls)[3]
    with pytest.raises(ValueError):
        vr.vrl_r_check(*homog)
    ids = torch.arange(32, dtype=torch.int32)[None]
    with pytest.raises(ValueError):
        vsc.vrl_sum_clustered_check(*homog, np.zeros(16, np.int64), ids,
                                    torch.ones((1, 32)))
    with pytest.raises(ValueError):
        vsc.vrl_sum_hetero_clustered_check(*packs, np.zeros(16, np.int64), ids,
                                           torch.ones((1, 32)))


def test_plane_pack_bounds_its_margin():
    """The plane pack of the config-1 triangles: n and off the float64
    values rounded to nearest, k and k0 at or above the exact margin
    coefficients and at most one rounding above, p0, e1, e2 as
    packed."""
    tris = pk.pack_tris(presets.cornell_smoke(8, 8, device="cpu"))
    planes = vs.plane_pack(tris)
    t = tris.double()
    n = torch.linalg.cross(t[:, 3:6], t[:, 6:9])
    assert torch.equal(planes[:, 0:3], n.float())
    k = vs.PLANE_MARGIN * t[:, 3:6].abs().amax(1) * t[:, 6:9].abs().amax(1)
    assert bool((planes[:, 4].double() >= k).all())
    assert bool((planes[:, 4].double() <= k * (1 + 2.0 ** -23)).all())
    assert bool((planes[:, 5].double() >= k * t[:, 0:3].abs().amax(1)).all())
    assert torch.equal(planes[:, 6:15], tris)
    assert float(planes[:, 15].abs().max()) == 0.0
    assert math.isclose(vs.PLANE_MARGIN, 2.0 ** -14)
