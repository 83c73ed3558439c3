"""Helpers shared by the tests that hold alvrl_tpu_torch against alvrl_tpu:
leaves of the JAX package's objects as numpy arrays, for
alvrl_tpu_torch.convert, and the JAX package's Pallas interpret-mode
references computed in a child process of their own (in_child)."""

import importlib
import multiprocessing
import os
import pickle
import traceback

import numpy as np
import torch

from alvrl_tpu_torch import convert
from alvrl_tpu_torch.geometry.intersect import Hit

CPU = "cpu"  # the device the CPU tests ask the port's entry points for

BENCH_VRLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "bench_vrls.txt")

# the eleven smooth kinds, each with the name of its material in
# SMOOTH_MATERIALS (tests/test_torch_bsdf.py, test_torch_glossy.py,
# test_torch_loader.py, test_torch_cuda.py)
SMOOTH_KINDS = {
    "roughconductor": "rc", "roughplastic": "rp", "phong": "ph",
    "ward": "wd", "difftrans": "dt", "plastic": "pl", "mask": "mk",
    "mixture": "mx", "coating": "co", "roughdielectric": "rd",
    "roughcoating": "rco",
}
# every kind with the parameters that reach its branches: anisotropic
# roughness, each microfacet distribution, a mask over a rough plastic, a
# mixture of Phong and Ward, an absorbing coat over diffuse and a rough
# coat (alpha above 0.5, so its table spans (0, alpha]) over difftrans
SMOOTH_MATERIALS = [
    {"name": "white", "type": "diffuse", "albedo": [0.7, 0.7, 0.7]},
    {"name": "rc", "type": "roughconductor", "albedo": [0.9, 0.6, 0.3],
     "alpha": 0.3, "alpha_v": 0.15, "distribution": "beckmann"},
    {"name": "rp", "type": "roughplastic", "albedo": [0.3, 0.5, 0.6],
     "alpha": 0.2},
    {"name": "ph", "type": "phong", "albedo": [0.4, 0.3, 0.2],
     "specular": [0.3, 0.3, 0.3], "exponent": 20},
    {"name": "wd", "type": "ward", "albedo": [0.2, 0.4, 0.3],
     "specular": [0.2, 0.2, 0.25], "alpha": 0.2, "alpha_v": 0.35},
    {"name": "dt", "type": "difftrans", "albedo": [0.6, 0.6, 0.5]},
    {"name": "pl", "type": "plastic", "albedo": [0.5, 0.2, 0.2],
     "eta": 1.5},
    {"name": "mk", "type": "mask", "opacity": 0.6, "nested": "rp"},
    {"name": "mx", "type": "mixture", "weight": 0.3, "nested": "ph",
     "nested2": "wd"},
    {"name": "co", "type": "coating", "eta": 1.4, "thickness": 0.5,
     "sigma_a": [0.1, 0.2, 0.3], "nested": "white"},
    {"name": "rd", "type": "roughdielectric", "eta": 1.5, "alpha": 0.25,
     "distribution": "phong"},
    {"name": "rco", "type": "roughcoating", "eta": 1.5, "alpha": 0.6,
     "thickness": 0.3, "sigma_a": [0.05, 0.1, 0.0], "nested": "dt",
     "distribution": "beckmann"},
    {"name": "glass", "type": "dielectric", "eta": 1.5},
]


def _quad(material, *corners):
    """A trimesh of the quad p0 p1 p2 p3 (two triangles)."""
    return {"type": "trimesh", "material": material,
            "vertices": [c for p in corners for c in p],
            "faces": [0, 1, 2, 0, 2, 3]}


def _box(x, y, z, sx, sy, sz):
    return [[sx, 0, 0, x], [0, sy, 0, y], [0, 0, sz, z], [0, 0, 0, 1]]


def glossy_scene_desc(width=8, height=8):
    """The Cornell box [-1, 1]^3 in a homogeneous medium, the camera
    inside its front wall, whose walls, two blocks, two spheres and a
    mask quad carry the eleven smooth kinds of SMOOTH_MATERIALS, as a
    JSON scene dict; every kind is seen from the camera (the back wall
    Phong and diffuse transmission, the unseen front wall diffuse
    transmission too)."""
    return {
        "camera": {"type": "perspective", "origin": [0, 0, -0.99],
                   "target": [0, 0, 1], "fov": 90, "width": width,
                   "height": height},
        "medium": {"type": "homogeneous", "sigma_s": [0.6] * 3,
                   "sigma_a": [0.05] * 3, "g": 0.3},
        "materials": SMOOTH_MATERIALS,
        "shapes": [
            _quad("rc", [-1, -1, -1], [1, -1, -1], [1, -1, 1], [-1, -1, 1]),
            _quad("pl", [-1, 1, -1], [-1, 1, 1], [1, 1, 1], [1, 1, -1]),
            _quad("ph", [-1, -1, 1], [0.13, -1, 1], [0.13, 1, 1],
                  [-1, 1, 1]),
            _quad("dt", [0.13, -1, 1], [1, -1, 1], [1, 1, 1], [0.13, 1, 1]),
            _quad("dt", [-1, -1, -1], [-1, 1, -1], [1, 1, -1], [1, -1, -1]),
            _quad("wd", [-1, -1, -1], [-1, -1, 1], [-1, 1, 1], [-1, 1, -1]),
            _quad("mx", [1, -1, -1], [1, 1, -1], [1, 1, 1], [1, -1, 1]),
            {"type": "cube", "material": "rp",
             "to_world": _box(-0.45, -0.6, 0.35, 0.25, 0.4, 0.25)},
            {"type": "cube", "material": "rco",
             "to_world": _box(0.45, -0.75, 0.5, 0.2, 0.25, 0.2)},
            {"type": "sphere", "material": "co", "center": [0.1, 0.35, 0.55],
             "radius": 0.3, "n_theta": 6, "n_phi": 10},
            {"type": "sphere", "material": "rd", "center": [-0.3, 0.2, 0.0],
             "radius": 0.2, "n_theta": 6, "n_phi": 10},
            _quad("mk", [0.3, -0.2, 0.0], [0.7, -0.2, 0.0], [0.7, 0.3, 0.1],
                  [0.3, 0.3, 0.1]),
        ],
        "emitters": [{"type": "point", "position": [0, 0.8, 0.2],
                      "intensity": [8, 8, 8]}],
    }


# per-draw constants of a vol_vol=2 / vol_surf=2 pair, in the kernel's
# draw order (vv0.V, vv0.U, vv1.V, vv1.U, vs0, vs1); the same 6-cycle as
# the seq_uniforms fixture of tests/test_hetero_pallas.py
SEQ_UNIFORMS = (0.3, 0.7, 0.62, 0.41, 0.23, 0.77)


def jax_medium_leaves(med):
    """The leaves of an alvrl_tpu medium that convert.scene_from_numpy
    reads: a homogeneous medium's, or a grid medium's with its options
    (fast_tau, sampling, sigma_dir_max) and, where it has them, its
    orientation volume and oriented phase parameters."""
    if hasattr(med, "sigma_t_color"):
        keys = ("density", "sigma_t_color", "albedo", "g", "box_min",
                "box_max", "scale")
    else:
        keys = ("sigma_a", "sigma_s", "g", "sampling_weight")
    out = {f"medium.{k}": np.asarray(getattr(med, k)) for k in keys}
    out["medium.phase_kind"] = med.phase_kind
    if hasattr(med, "sigma_t_color"):
        out["medium.fast_tau"] = bool(med.fast_tau)
        out["medium.sampling"] = int(med.sampling)
        if med.sigma_dir_max is not None:
            out["medium.sigma_dir_max"] = np.asarray(med.sigma_dir_max)
        if med.orientation is not None:
            out["medium.orientation"] = np.asarray(med.orientation)
        pp = med.phase_params
        for k in ("ks", "kd", "exponent", "norm", "stddev", "sigma_t_lut"):
            if pp is not None and getattr(pp, k) is not None:
                out[f"medium.phase_params.{k}"] = np.asarray(getattr(pp, k))
    if not hasattr(med, "sigma_t_color"):
        out["medium.strategy"] = med.strategy
        out["medium.channel"] = med.channel
        out["medium.density"] = np.asarray(med.density)
        pp = med.phase_params
        if pp is not None and pp.mix_w is not None:
            for k in ("mix_w", "mix_kind", "mix_g"):
                out[f"medium.phase_params.{k}"] = np.asarray(getattr(pp, k))
    return out


def jax_scene_leaves(scene):
    """The leaves of an alvrl_tpu Scene that convert.scene_from_numpy reads."""
    cam = scene.camera
    return {
        "vertices": np.asarray(scene.vertices),
        "faces": np.asarray(scene.faces),
        "material": np.asarray(scene.material),
        **{f"materials.{k}": np.asarray(getattr(scene.materials, k))
           for k in convert.MATERIAL_KEYS},
        **{f"emitters.{k}": np.asarray(getattr(scene.emitters, k))
           for k in ("kind", "position", "direction", "intensity",
                     "cos_cutoff", "cos_beam", "tri_e1", "tri_e2", "pmf")},
        **jax_medium_leaves(scene.medium),
        "camera.to_world": np.asarray(cam.to_world),
        "camera.fov_x_deg": np.asarray(cam.fov_x_deg),
        "camera.width": cam.width,
        "camera.height": cam.height,
        "camera.kind": cam.kind,
        "face_emitter": np.asarray(scene.face_emitter),
        **{f"emitters.env.{k}": np.asarray(getattr(scene.emitters.env, k))
           for k in ("image", "row_cdf", "cond_cdf", "pdf_map", "mean",
                     "azimuth")},
        **({} if scene.media is None else {
            **{f"media.{k}": np.asarray(getattr(scene.media, k))
               for k in ("sigma_a", "sigma_s", "g", "sampling_weight")},
            "face_med_int": np.asarray(scene.face_med_int),
            "face_med_ext": np.asarray(scene.face_med_ext)}),
        **({} if scene.materials.tex_id is None else {
            **{f"materials.{k}": np.asarray(getattr(scene.materials, k))
               for k in ("tex_kind", "tex_scale", "tex_id")},
            "face_uv": np.asarray(scene.face_uv),
            "textures": np.asarray(scene.textures)}),
    }


def jax_vrls_leaves(vrls):
    return {k: np.asarray(getattr(vrls, k))
            for k in ("start", "end", "power", "valid", "particle_count")}


def jax_tracking_uniforms(k_dist, n_steps):
    """The (n_steps, 2) uniforms alvrl_tpu's Woodcock tracking
    (media/heterogeneous.py:sample_distance) draws from the key k_dist,
    one row per step: step k splits its key into (k1, k2, next)
    (:437) and draws uniform(k1), uniform(k2)."""
    import jax
    import jax.numpy as jnp

    def body(k, _):
        k1, k2, k_next = jax.random.split(k, 3)
        return k_next, jnp.stack([jax.random.uniform(k1),
                                  jax.random.uniform(k2)])

    return jax.lax.scan(body, k_dist, None, length=n_steps)[1]


def jax_emission_uniforms(k_emit, pmf=None):
    """The (N_EMIT_DIMS,) uniforms, in the port's column order
    (emitters.py: select, direction (2), position (2), the area light's
    second barycentric), that alvrl_tpu's sample_emission draws from the
    key k_emit: it splits it into (select, direction, position)
    (emitters.py:116), draws the direction from uniform2 and the position
    from uniform2 of their keys, and the area light's b1 uniform from the
    direction's key, the same number as the direction's first uniform
    (emitters.py:154, ROADMAP C14). The emitter choice is
    jax.random.choice, which no uniform reproduces: without `pmf` the
    select column is the select key's uniform (the choice agrees when
    the scene has one emitter); with the table's pmf it is the midpoint
    of the chosen emitter's CDF interval, so the port picks the same
    emitter."""
    import jax
    import jax.numpy as jnp

    k_sel, k_dir, k_pos = jax.random.split(k_emit, 3)
    u_dir = jax.random.uniform(k_dir, (2,))
    if pmf is None:
        u_sel = jax.random.uniform(k_sel, (1,))
    else:
        pmf = jnp.asarray(pmf, jnp.float32)
        cdf = jnp.cumsum(pmf)
        idx = jax.random.choice(k_sel, pmf.shape[0], p=pmf)
        lo = jnp.where(idx > 0, cdf[jnp.maximum(idx - 1, 0)], 0.0)
        u_sel = ((lo + cdf[idx]) / (2.0 * cdf[-1]))[None]
    return jnp.concatenate([u_sel, u_dir, jax.random.uniform(k_pos, (2,)),
                            u_dir[:1]])


def jax_tracer_uniforms(key, num_particles, max_depth, tracking_steps=0,
                        pmf=None, quadrature=False):
    """The uniforms alvrl_tpu's tracer.trace(scene, key, num_particles,
    TracerConfig(max_depth=...)) draws, rebuilt from its key tree, in
    the layout of the port's trace_u: u_emit (P, N_EMIT_DIMS) and u_walk
    (P, D, 10), as numpy arrays; with tracking_steps > 0 also the grid
    medium's Woodcock uniforms u_track (P, D, tracking_steps, 2), rebuilt
    from each step's distance key (jax_tracking_uniforms), which a grid
    medium reads instead of u_walk's two distance uniforms.

    The key tree: key -> one key per particle (tracer.py:91) -> (emit,
    walk) (:109); emit -> jax_emission_uniforms (with `pmf`, the scene's
    emitter pmf, for a scene of several emitters); walk -> one key per
    depth (:240) -> (distance, phase, bsdf, roulette) (:127); distance ->
    two scalar uniforms (homogeneous.py:144-146), phase -> uniform2,
    bsdf -> N_SAMPLE_DIMS uniforms (bsdf/api.py:337), roulette -> one.
    With quadrature (a grid medium of sampling 1), the first distance
    column is the distance key's own uniform, which
    sample_distance_quadrature draws (heterogeneous.py:515)."""
    import jax
    import jax.numpy as jnp

    def step(k):
        k_dist, k_phase, k_bsdf, k_rr = jax.random.split(k, 4)
        k1, k2 = jax.random.split(k_dist)
        u = jnp.concatenate([
            jax.random.uniform(k_dist if quadrature else k1, (1,)),
            jax.random.uniform(k2, (1,)),
            jax.random.uniform(k_phase, (2,)),
            jax.random.uniform(k_bsdf, (5,)), jax.random.uniform(k_rr, (1,))])
        if not tracking_steps:
            return u, jnp.zeros((0, 2))
        return u, jax_tracking_uniforms(k_dist, tracking_steps)

    def particle(k):
        k_emit, k_walk = jax.random.split(k)
        return (jax_emission_uniforms(k_emit, pmf),
                jax.vmap(step)(jax.random.split(k_walk, max_depth)))

    u_emit, (u_walk, u_track) = jax.vmap(particle)(
        jax.random.split(key, num_particles))
    if tracking_steps:
        return np.asarray(u_emit), np.asarray(u_walk), np.asarray(u_track)
    return np.asarray(u_emit), np.asarray(u_walk)


def jax_volpath_step_uniforms(k, tracking_steps=0, quadrature=False,
                              sir=False):
    """One step's uniforms of alvrl_tpu's li_volpath from its key k, in
    the port's volpath layout: k splits into (distance, direct, phase,
    bsdf, roulette, unused) (volpath.py:129); distance -> two scalar
    uniforms (homogeneous.py:144-146), direct -> uniform (3,), phase ->
    uniform2, bsdf -> N_SAMPLE_DIMS, roulette -> one; with
    tracking_steps, also the Woodcock rows of the distance key; with
    quadrature (sampling 1), the distance key's own uniform in the first
    column (heterogeneous.py:515); with sir, also the micro-flake
    sample's (16, 3) uniforms of the phase key (volpath.py:206). Returns
    (u, u_track, u_sir), the last two empty where not asked for."""
    import jax
    import jax.numpy as jnp

    k_dist, k_nee, k_phase, k_bsdf, k_rr, _ = jax.random.split(k, 6)
    k1, k2 = jax.random.split(k_dist)
    u = jnp.concatenate([
        jax.random.uniform(k_dist if quadrature else k1, (1,)),
        jax.random.uniform(k2, (1,)),
        jax.random.uniform(k_nee, (3,)), jax.random.uniform(k_phase, (2,)),
        jax.random.uniform(k_bsdf, (5,)), jax.random.uniform(k_rr, (1,))])
    u_track = (jax_tracking_uniforms(k_dist, tracking_steps)
               if tracking_steps else jnp.zeros((0, 2)))
    u_sir = (jax.random.uniform(k_phase, (16, 3)) if sir
             else jnp.zeros((0, 3)))
    return u, u_track, u_sir


def jax_volpath_uniforms(keys, n_steps, tracking_steps=0, quadrature=False,
                         sir=False):
    """The uniforms alvrl_tpu's li_volpath draws from each ray's key
    (keys: (B,) keys), rebuilt in the layout of the port's li_volpath_u:
    u (B, n_steps, N_STEP_DIMS) and, with tracking_steps, u_track (B,
    n_steps, tracking_steps, 2), and with sir, u_sir (B, n_steps, 16,
    3), as numpy arrays: u alone, or a tuple of u and those asked for.
    A ray's key splits into one key a step (volpath.py:449), each
    step's as jax_volpath_step_uniforms."""
    import jax

    def ray(k):
        return jax.vmap(lambda kk: jax_volpath_step_uniforms(
            kk, tracking_steps, quadrature, sir))(
                jax.random.split(k, n_steps))

    u, u_track, u_sir = (np.asarray(a) for a in jax.vmap(ray)(keys))
    extra = (u_track,) * bool(tracking_steps) + (u_sir,) * sir
    return (u, *extra) if extra else u


def jax_render_keys(key, spp, n_rays, ray_tile=4096):
    """(spp, n_rays) keys: alvrl_tpu's render_volpath folds sample i,
    tile t and ray j of the tile into the key (volpath.py:483)."""
    import jax
    import jax.numpy as jnp

    from alvrl_tpu.core import rng

    idx = jnp.arange(n_rays)
    return jax.vmap(lambda i: jax.vmap(lambda r: rng.fold(
        key, i, r // ray_tile, r % ray_tile))(idx))(jnp.arange(spp))


def hit_from_jax(hit):
    """alvrl_tpu Hit (or HitInfo) -> the port's Hit on the CPU."""
    return Hit(t=torch.as_tensor(np.asarray(hit.t)),
               prim=torch.as_tensor(np.asarray(hit.prim), dtype=torch.int64),
               valid=torch.as_tensor(np.asarray(hit.valid)),
               p=torch.as_tensor(np.asarray(hit.p)),
               ng=torch.as_tensor(np.asarray(hit.ng)),
               ng_raw=torch.as_tensor(np.asarray(hit.ng_raw)))


def chain_bvh_pack(tris, depth):
    """An ops.vrl_sum_bvh.BvhPack of tris ((T, TRI_COLS), T <= 7 (depth +
    1)) whose tree is a chain `depth` deep: inner node i holds inner node
    i + 1 as its child 0 and leaf i as its child 1 (the last inner node
    leaves depth - 1 and depth), every box the triangles' padded bounding
    box, the triangles dealt to the leaves in order. Equal boxes make
    kernel 7's traversal descend child 0 and push child 1 at every level,
    so its far-child stack fills to the depth."""
    from alvrl_tpu_torch.geometry import bvh as bvh_mod
    from alvrl_tpu_torch.ops import vrl_sum_bvh as vb

    n_leaves = depth + 1
    n_tris = tris.shape[0]
    assert depth >= 1 and n_tris <= 7 * n_leaves
    pts = tris[:, 0:3].cpu().double()
    corners = torch.cat([pts, pts + tris[:, 3:6].cpu(),
                         pts + tris[:, 6:9].cpu()])
    lo, hi = corners.min(0).values.float(), corners.max(0).values.float()
    pad = bvh_mod.box_pad(lo.numpy(), hi.numpy())
    box_lo, box_hi = lo.numpy() - pad, hi.numpy() + pad
    bounds = [k * n_tris // n_leaves for k in range(n_leaves + 1)]

    def leaf(k):
        first, count = bounds[k], bounds[k + 1] - bounds[k]
        return ~((first << vb.LEAF_BITS) | count)

    nodes = np.zeros((depth, vb.NODE_COLS), np.float32)
    for i in range(depth):
        refs = (i + 1, leaf(i)) if i < depth - 1 else (leaf(i), leaf(i + 1))
        for c, ref in enumerate(refs):
            nodes[i, 8 * c:8 * c + 3] = box_lo
            nodes[i, 8 * c + 3] = np.int32(ref).view(np.float32)
            nodes[i, 8 * c + 4:8 * c + 7] = box_hi
    return vb.BvhPack(torch.as_tensor(nodes, device=tris.device),
                      tris.contiguous(), depth)


# JAX's TPU interpret mode can deadlock: a pallas_call's io_callback
# (the interpreter's barrier, shared_memory.update_clocks_for_device_
# barrier) dispatches JAX operations of its own, which with the CPU
# client's asynchronous dispatch can queue behind an operation that the
# main thread dispatched after the pallas_call and that waits for its
# result. The children run computations inline instead
# (jax_cpu_enable_async_dispatch off; the same results bit for bit), and
# a child still running after INTERPRET_LIMIT_S seconds, over twice the
# slowest reference's time in a whole tier-1 run, is stopped and the
# reference computed once more.
INTERPRET_LIMIT_S = 360.0


def _child_main(conn, module, name, args):
    """A child's body: JAX on the CPU as tests/conftest.py sets it, with
    inline dispatch (see INTERPRET_LIMIT_S), before anything imports the
    test module, then module.name(*args); sends ("ok", result) or
    ("error", traceback) by plain pickle (torch's reducers would share
    tensors through descriptors that end with the child)."""
    try:
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
        jax.config.update("jax_enable_x64", False)
        jax.config.update("jax_cpu_enable_async_dispatch", False)
        assert jax.default_backend() == "cpu", jax.default_backend()
        fn = getattr(importlib.import_module(module), name)
        reply = ("ok", fn(*args))
    except BaseException:  # noqa: BLE001 - the parent re-raises it
        reply = ("error", traceback.format_exc())
    conn.send_bytes(pickle.dumps(reply))
    conn.close()


def in_child(fn, *args):
    """fn(*args) (a module-level function whose result pickles) computed
    in a spawned child process with JAX on the CPU. A child still running
    after INTERPRET_LIMIT_S seconds is killed and fn run once more in a
    new child: the references are deterministic, so a second run gives
    what the first would have. Raises what fn raised, or TimeoutError after two
    children ran past the limit."""
    ctx = multiprocessing.get_context("spawn")
    for _ in range(2):
        recv, send = ctx.Pipe(duplex=False)
        child = ctx.Process(target=_child_main,
                            args=(send, fn.__module__, fn.__name__, args),
                            daemon=True)
        child.start()
        send.close()
        if recv.poll(INTERPRET_LIMIT_S):
            try:
                status, value = pickle.loads(recv.recv_bytes())
            except EOFError:  # it died before sending
                child.join()
                raise RuntimeError(f"{fn.__name__}'s child process exited "
                                   f"with code {child.exitcode}") from None
            child.join()
            if status == "ok":
                return value
            raise RuntimeError(f"{fn.__name__} failed in its child "
                               f"process:\n{value}")
        child.kill()
        child.join()
    raise TimeoutError(f"{fn.__name__} ran past {INTERPRET_LIMIT_S} s in two "
                       "child processes")
