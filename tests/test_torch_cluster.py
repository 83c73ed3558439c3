"""The host clustering of alvrl_tpu_torch against alvrl_tpu.

The port keeps its own copy of the JAX package's numpy slicing
(integrators.vrl.cluster) and its own build of the native refiner
(integrators.vrl.cluster_native). Both are deterministic given a numpy
Generator, so on the same inputs they must give the JAX package's
slices, representatives, localities, clusters and tables bit for bit
(the refiner against the JAX package's native backend); only the gather
pass (the eye rays' hits, plain float32 torch against XLA) is compared
to a tolerance.
"""

import numpy as np
import pytest
import torch

from alvrl_tpu.integrators.vrl import alvrl as jalvrl
from alvrl_tpu.integrators.vrl import cluster as jcl
from alvrl_tpu.scene import presets as jpresets
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.integrators.vrl import alvrl, cluster_native
from alvrl_tpu_torch.integrators.vrl import cluster as cl
from alvrl_tpu_torch.ops import _build
from tests.torch_port_utils import CPU, jax_scene_leaves

W = H = 16
# ClusterParams fields shared by both packages' ClusterParams, per case:
# the config-2 defaults, the global cluster with neighbour-weighted
# localities, and no local refinement
CASES = {
    "default": dict(target_num_slices=8, target_pixel_undersampling=8.0),
    "global_neighbours": dict(target_num_slices=8,
                              target_pixel_undersampling=8.0,
                              neighbour_count=2, neighbour_weight=0.3,
                              global_cluster=True, global_undersampling=4.0),
    "no_refinement": dict(target_num_slices=6, target_pixel_undersampling=6.0,
                          local_refinement=False),
}


def _scenes():
    jscene = jpresets.cornell_smoke(width=W, height=H)
    return jscene, convert.scene_from_numpy(jax_scene_leaves(jscene),
                                            device=CPU)


def _jax_gather(jscene, curvature=0.5):
    pos, ng, valid, diag = (np.asarray(a) for a in
                            jalvrl.gather_points(jscene))
    return pos, ng * (float(diag) / 8.0 * curvature), valid


def _slice_infos(case):
    """(JAX SliceInfo, port SliceInfo), each package's functions on the
    JAX package's gather points, with the same Generator seeds."""
    jscene, _ = _scenes()
    kw = CASES[case]
    pos, dirs, valid = _jax_gather(jscene)
    infos = []
    for mod, info_cls in ((jcl, jalvrl.SliceInfo), (cl, alvrl.SliceInfo)):
        p = mod.ClusterParams(**kw)
        slices = mod.build_slices(pos, dirs, valid, p.target_num_slices)
        rows, slice_u, global_pu = mod.sample_representative_pixels(
            slices, p.target_pixel_undersampling, np.random.default_rng(7))
        infos.append(info_cls(slices, rows, slice_u, global_pu,
                              mod.build_localities(slices,
                                                   p.neighbour_count)))
    return infos


def _synthetic_R(n_rows, n_vrls=64, seed=0):
    """A transfer matrix with the structure the clustering sees: sparse
    positive means, some all-zero columns (the zero-contribution
    quarantine), variances of the order of the squared means."""
    rng = np.random.default_rng(seed)
    mean = rng.gamma(0.5, 1.0, (n_rows, n_vrls)) \
        * (rng.random((n_rows, n_vrls)) > 0.2)
    mean[:, ::13] = 0.0
    return mean, mean ** 2 * rng.uniform(0.0, 2.0, (n_rows, n_vrls))


def _rows_per_slice(repr_rows):
    bounds = np.cumsum([0] + [len(r) for r in repr_rows])
    return [np.arange(a, b) for a, b in zip(bounds[:-1], bounds[1:])]


def test_gather_points_match_jax():
    """The gather pass: hit points, normals and validity of one centre
    ray per pixel, and the scene diagonal, within 1e-6 (float32 hits of
    the same rays in two frameworks; here they agree exactly)."""
    jscene, scene = _scenes()
    for name, a, b in zip(("pos", "ng", "valid", "diag"),
                          jalvrl.gather_points(jscene),
                          alvrl.gather_points(scene)):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b.astype(np.float64), a, rtol=0, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_slicing_matches_jax_exactly(case):
    """build_slices, sample_representative_pixels and build_localities on
    the JAX package's gather points: equal, bit for bit."""
    jinfo, info = _slice_infos(case)
    assert np.array_equal(info.slices.pixel_to_slice,
                          jinfo.slices.pixel_to_slice)
    assert len(info.slices.members) == CASES[case]["target_num_slices"]
    for a, b in zip(jinfo.slices.members, info.slices.members):
        assert np.array_equal(a, b)
    assert np.array_equal(info.slices.pos_centroid, jinfo.slices.pos_centroid)
    assert np.array_equal(info.slices.dir_centroid, jinfo.slices.dir_centroid)
    assert len(info.repr_rows) == len(jinfo.repr_rows)
    for a, b in zip(jinfo.repr_rows, info.repr_rows):
        assert np.array_equal(a, b)
    assert np.array_equal(info.slice_u, jinfo.slice_u)
    assert info.global_pu == jinfo.global_pu
    assert info.localities == jinfo.localities


def test_build_slice_info_matches_jax():
    """The port's whole slicing stage on its own gather pass equals the
    JAX package's on its own (the gather points agree exactly here)."""
    jscene, scene = _scenes()
    jparams = jalvrl.ALVRLParams(cluster=jcl.ClusterParams(
        **CASES["default"]))
    params = alvrl.ALVRLParams(cluster=cl.ClusterParams(**CASES["default"]))
    jinfo = jalvrl.build_slice_info(jscene, jparams)
    info = alvrl.build_slice_info(scene, params)
    assert np.array_equal(info.slices.pixel_to_slice,
                          jinfo.slices.pixel_to_slice)
    for a, b in zip(jinfo.repr_rows, info.repr_rows):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("rng_seed", [5, 11])
@pytest.mark.parametrize("case", sorted(CASES))
def test_build_clusters_matches_jax_exactly(case, rng_seed):
    """The native refiner on the same R with the same Generator seed: the
    same per-slice ids and weights, fall-back and global sets as the JAX
    package's native backend, bit for bit."""
    jinfo, info = _slice_infos(case)
    rows = _rows_per_slice(info.repr_rows)
    mean, var = _synthetic_R(sum(len(r) for r in rows))
    ref = jcl.build_clusters(mean, var, rows, jinfo.slice_u, jinfo.global_pu,
                             jinfo.localities, jcl.ClusterParams(**CASES[case]),
                             np.random.default_rng(rng_seed), backend="native")
    out = cluster_native.build_clusters(
        mean, var, rows, info.slice_u, info.global_pu, info.localities,
        cl.ClusterParams(**CASES[case]), np.random.default_rng(rng_seed))
    for per_slice_ref, per_slice in zip(ref[:2], out[:2]):
        assert len(per_slice) == len(rows)
        for a, b in zip(per_slice_ref, per_slice):
            assert len(b) > 0 and np.array_equal(a, b)
    for a, b in zip(ref[2:], out[2:]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_tables_match_jax_exactly(case):
    """cluster_from_R (native refinement, then pack_tables) on the same
    float64 R: the port's tables equal the JAX package's on [:S, :cmax],
    and its pixel rows equal JAX's with -1 for JAX's fall-back row S."""
    jinfo, info = _slice_infos(case)
    mean, var = _synthetic_R(sum(len(r) for r in info.repr_rows), seed=1)
    jparams = jalvrl.ALVRLParams(cluster=jcl.ClusterParams(**CASES[case]))
    params = alvrl.ALVRLParams(cluster=cl.ClusterParams(**CASES[case]))
    jsop, jtv, jtw, jpacked = jalvrl.cluster_from_R(mean, var, jparams, jinfo,
                                                    use_pallas=True)
    sop, tv, tw, packed = alvrl.cluster_from_R(mean, var, params, info, CPU)
    n_slices, cmax = tv.shape
    assert n_slices == CASES[case]["target_num_slices"]
    assert tv.dtype == torch.int32 and tw.dtype == torch.float32
    assert np.array_equal(tv.numpy(), np.asarray(jtv)[:n_slices, :cmax])
    assert np.array_equal(tw.numpy(), np.asarray(jtw)[:n_slices, :cmax])
    assert not np.asarray(jtw)[:, cmax:].any()  # JAX's padding is empty
    jsop = np.asarray(jsop)
    assert np.array_equal(sop, np.where(jsop == n_slices, -1, jsop))
    for k in ("fallback_vrls", "fallback_weights", "gc_vrls", "gc_weights"):
        assert np.array_equal(getattr(packed, k), getattr(jpacked, k)), k


def test_cluster_tables_from_numpy():
    sop = np.array([0, 2, 1], np.int64)
    tv = np.array([[1, 2], [3, 0], [0, 0]], np.int64)
    tw = np.array([[0.5, 1.0], [2.0, 0.0], [0.0, 0.0]], np.float64)
    s, ids, ws = convert.cluster_tables_from_numpy(sop, tv, tw, device=CPU)
    assert s.dtype == np.int32 and np.array_equal(s, sop)
    assert ids.dtype == torch.int32 and ws.dtype == torch.float32
    assert ids.tolist() == tv.tolist() and ws.tolist() == tw.tolist()


@pytest.mark.parametrize("fault", ["compiler_fails", "source_missing"])
def test_failed_native_build_raises(fault, monkeypatch, tmp_path):
    """A refiner that cannot be built raises; there is no other
    refiner to fall back to."""
    _, info = _slice_infos("default")
    rows = _rows_per_slice(info.repr_rows)
    mean, var = _synthetic_R(sum(len(r) for r in rows))
    monkeypatch.setattr(cluster_native, "_library_path",
                        lambda: tmp_path / "libalvrl_cluster-x.so")
    if fault == "compiler_fails":
        monkeypatch.setenv("CXX", "false")
    else:
        monkeypatch.setattr(cluster_native, "SOURCE", tmp_path / "none.cpp")
    cluster_native.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError):
            cluster_native.build_clusters(
                mean, var, rows, info.slice_u, info.global_pu,
                info.localities, cl.ClusterParams(),
                np.random.default_rng(0))
    finally:
        cluster_native.load_library.cache_clear()


def test_native_build_stays_in_the_package(tmp_path):
    """The refiner is built by g++ into alvrl_tpu_torch/_build/, under a
    name that hashes its source and flags; native/, and its tracked
    libalvrl_cluster.so, are left untouched."""
    tracked = cluster_native.SOURCE.parent / "libalvrl_cluster.so"
    before = tracked.read_bytes() if tracked.exists() else None
    listing = sorted(p.name for p in cluster_native.SOURCE.parent.iterdir())
    lib = cluster_native.load_library()
    path = cluster_native._library_path()
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert path.name.startswith("libalvrl_cluster-")
    assert lib._name == str(path)
    assert sorted(p.name for p in cluster_native.SOURCE.parent.iterdir()) \
        == listing
    assert (tracked.read_bytes() if tracked.exists() else None) == before
