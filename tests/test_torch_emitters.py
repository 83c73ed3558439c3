"""The port's emitters against alvrl_tpu: each kind's emission sample on
the uniforms rebuilt from JAX's keys (torch_port_utils.
jax_emission_uniforms), the emitter choice against jax.random.choice,
the power-weighted table, the area-light preset, the tracer with an area
light, the stream of a point-light trace, and ROADMAP C14: the JAX
package draws the area light's second barycentric from the direction's
key, so its emission point and angle are correlated, and the port's are
not. About 35 s alone.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alvrl_tpu.emitters import emitters as jem
from alvrl_tpu.integrators.vrl import tracer as jtracer
from alvrl_tpu.scene import presets as jpresets
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.emitters import emitters as em
from alvrl_tpu_torch.integrators.vrl import tracer
from alvrl_tpu_torch.ops.vrl_sum import HOMOG_MEDIAN, HOMOG_SHARE, homog_bar
from alvrl_tpu_torch.scene import presets
from tests.torch_port_utils import (
    CPU,
    jax_emission_uniforms,
    jax_scene_leaves,
    jax_tracer_uniforms,
)

torch.set_num_threads(1)

# one table entry of each kind: (kind, position, intensity, direction,
# cutoff and beam in degrees, e1, e2)
ENTRIES = {
    "point": (jem.POINT, [0.1, 0.7, 0.2], [8, 6, 4], [0, 0, 1], 20, 15,
              [0, 0, 0], [0, 0, 0]),
    "spot": (jem.SPOT, [0.2, 0.8, -0.1], [5, 4, 3], [0.2, -1, 0.1], 35, 12,
             [0, 0, 0], [0, 0, 0]),
    "directional": (jem.DIRECTIONAL, [0, 0, 0], [1, 2, 3], [0.3, -1, 0.2],
                    20, 15, [0, 0, 0], [0, 0, 0]),
    "area": (jem.AREA, [-0.25, 0.999, -0.25], [6, 5, 4], [0, 0, 1], 20, 15,
             [0.5, 0, 0], [0, 0, 0.5]),
    "constant": (jem.CONSTANT, [0, 0, 0], [0.2, 0.3, 0.4], [0, 0, 1], 20,
                 15, [0, 0, 0], [0, 0, 0]),
    "collimated": (jem.COLLIMATED, [0, 0.5, 0], [2, 2, 2], [0, -1, 0.1], 20,
                   15, [0, 0, 0], [0, 0, 0]),
}
CENTER, RADIUS = [0.1, -0.2, 0.3], 1.7
N_KEYS = 256


def _t(a):
    return torch.as_tensor(np.array(a))


def _tables(names):
    cols = list(zip(*(ENTRIES[n] for n in names)))
    args = (cols[0], cols[1], cols[2], cols[3], cols[4], cols[5])
    kw = dict(tri_e1=cols[6], tri_e2=cols[7])
    return (jem.make_emitters(*args, **kw),
            em.make_emitters(*args, **kw, device=CPU))


def _jax_samples(jtable, keys):
    return jax.vmap(lambda k: jem.sample_emission(
        jtable, k, jnp.asarray(CENTER, jnp.float32),
        jnp.float32(RADIUS)))(keys)


def _port_samples(table, u):
    return em.sample_emission_u(table, _t(u), torch.tensor(CENTER),
                                torch.tensor(RADIUS))


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_sample_emission_matches_jax(name):
    """Each kind alone: position, direction and weight against JAX's
    sample_emission on its own uniforms (for the area light, its
    correlated b1 column, which reproduces it)."""
    jtable, table = _tables([name])
    keys = jax.random.split(jax.random.key(3), N_KEYS)
    ref = _jax_samples(jtable, keys)
    u = np.stack([np.asarray(jax_emission_uniforms(k)) for k in keys])
    out = _port_samples(table, u)
    for what, o, r in zip(("position", "direction", "weight"), out, ref):
        torch.testing.assert_close(o, _t(r), atol=2e-6, rtol=2e-6, msg=what)
    if name == "spot":  # full inside the beam, falling off outside it
        w = out[2][:, 0]
        assert int((w == w.max()).sum()) > 1
        assert bool((w < 0.5 * w.max()).any())


def test_mixed_table_matches_jax():
    """All six kinds in one power-weighted table: the columns bit for
    bit, and each sample against JAX's, the choice reproduced by the
    midpoint of jax.random.choice's emitter in the port's CDF."""
    names = sorted(ENTRIES)
    jtable, table = _tables(names)
    ref_cols = convert.scene_from_numpy(
        jax_scene_leaves(jpresets.cornell_smoke(4, 4).replace(
            emitters=jtable)), device=CPU).emitters
    for k in convert.EMITTER_KEYS:
        assert torch.equal(getattr(table, k), getattr(ref_cols, k)), k
    assert table.host_kinds == ref_cols.host_kinds
    keys = jax.random.split(jax.random.key(4), N_KEYS)
    ref = _jax_samples(jtable, keys)
    u = np.stack([np.asarray(jax_emission_uniforms(k, jtable.pmf))
                  for k in keys])
    out = _port_samples(table, u)
    for what, o, r in zip(("position", "direction", "weight"), out, ref):
        torch.testing.assert_close(o, _t(r), atol=2e-6, rtol=2e-6, msg=what)


def test_emitter_choice_matches_jax_choice():
    """The port's choice (the CDF of the pmf inverted at a uniform) and
    jax.random.choice over 2^16 draws each: each emitter's frequency
    within 3 standard errors of the pmf, in both, and of each other."""
    names = sorted(ENTRIES)
    jtable, table = _tables(names)
    n = 2 ** 16
    pmf = np.asarray(jtable.pmf, np.float64)
    ref = np.asarray(jax.random.choice(jax.random.key(9), len(names), (n,),
                                       p=jtable.pmf))
    u = torch.rand((n, em.N_EMIT_DIMS), generator=torch.Generator()
                   .manual_seed(9))
    ours = em.choose(table, u[:, 0]).numpy()
    pos, _, w = _port_samples(table, u)
    f_ref = np.bincount(ref, minlength=len(names)) / n
    f_ours = np.bincount(ours, minlength=len(names)) / n
    se = np.sqrt(pmf * (1 - pmf) / n)
    assert (np.abs(f_ref - pmf) < 3 * se).all(), (f_ref, pmf)
    assert (np.abs(f_ours - pmf) < 3 * se).all(), (f_ours, pmf)
    assert (np.abs(f_ours - f_ref) < 3 * np.sqrt(2) * se).all()
    assert bool(torch.isfinite(w).all()) and bool(torch.isfinite(pos).all())


def _area_b1_cos(pos, d, p0, e2, normal):
    """(b1, cos theta) of area-light samples of one triangle whose edges
    are orthogonal: b1 from the point, cos theta about the face normal."""
    b1 = ((pos - p0) * e2).sum(-1) / (e2 * e2).sum()
    return b1, (d * normal).sum(-1)


def test_c14_area_light_draws_are_independent_in_the_port():
    """ROADMAP C14. The JAX package's area light draws its second
    barycentric ub = uniform(k_dir), the first of the direction's
    uniform2(k_dir) (alvrl_tpu/emitters/emitters.py:154, :162): equal bit
    for bit, so b1 = ub sqrt(ua) and cos theta = sqrt(1 - ub) are
    correlated (over 2^16 samples, far past 3 standard errors). The
    port's own draw (sample_emission, a column of its own) shows no
    correlation within 3 standard errors."""
    keys = jax.random.split(jax.random.key(14), 64)
    for k in keys:
        _, k_dir, _ = jax.random.split(k, 3)
        assert jax.random.uniform(k_dir) == jax.random.uniform(k_dir, (2,))[0]
    jtable, table = _tables(["area"])
    p0, e2 = torch.tensor([-0.25, 0.999, -0.25]), torch.tensor([0.0, 0, 0.5])
    normal = torch.tensor([0.0, -1.0, 0.0])  # cross(e1, e2) / |.|
    n = 2 ** 16
    ref = _jax_samples(jtable, jax.random.split(jax.random.key(15), n))
    r_jax = np.corrcoef(*(x.numpy() for x in _area_b1_cos(
        _t(ref[0]), _t(ref[1]), p0, e2, normal)))[0, 1]
    pos, d, _ = em.sample_emission(table, torch.Generator().manual_seed(15),
                                   n, torch.tensor(CENTER),
                                   torch.tensor(RADIUS))
    b1, cos = _area_b1_cos(pos, d, p0, e2, normal)
    r_port = np.corrcoef(b1.numpy(), cos.numpy())[0, 1]
    se = 1.0 / math.sqrt(n)
    assert abs(r_jax) > 30 * se, r_jax
    assert abs(r_port) < 3 * se, r_port
    assert float(cos.min()) >= 0.0 and 0.0 <= float(b1.min())


def test_cornell_area_light_matches_jax_preset():
    ours = presets.cornell_area_light(12, 8, device=CPU)
    ref = convert.scene_from_numpy(jax_scene_leaves(
        jpresets.cornell_area_light(12, 8)), device=CPU)
    for name in ("vertices", "faces", "material"):
        assert torch.equal(getattr(ours, name), getattr(ref, name)), name
    for part in ("materials", "emitters", "medium", "camera"):
        a, b = getattr(ours, part), getattr(ref, part)
        for k in a.__dataclass_fields__:
            x, y = getattr(a, k), getattr(b, k)
            assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                    else x == y), f"{part}.{k}"


def test_trace_matches_jax_with_an_area_light():
    """cornell_area_light with a spot light added, on JAX's own random
    numbers (the choice reproduced through the pmf): the VRL buffer at
    the homogeneous bar, validity equal, particles from both lights."""
    jbase = jpresets.cornell_area_light(8, 8)
    jtable = jem.make_emitters(
        [jem.AREA, jem.AREA, jem.SPOT],
        [jbase.emitters.position[0], jbase.emitters.position[1],
         [0.3, 0.6, 0.1]],
        [[6, 6, 6], [6, 6, 6], [9, 8, 7]], [[0, 0, 1], [0, 0, 1],
                                            [0, -1, 0.3]],
        [20, 20, 40], [15, 15, 25], tri_e1=jbase.emitters.tri_e1.tolist()
        + [[0, 0, 0]], tri_e2=jbase.emitters.tri_e2.tolist() + [[0, 0, 0]])
    jscene = jbase.replace(emitters=jtable)
    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device=CPU)
    key = jax.random.key(21)
    n, depth = 64, 5
    ref = jtracer.trace(jscene, key, n, jtracer.TracerConfig(max_depth=depth))
    u_emit, u_walk = jax_tracer_uniforms(key, n, depth, pmf=jtable.pmf)
    out = tracer.trace_u(scene, _t(u_emit), _t(u_walk),
                         tracer.TracerConfig(max_depth=depth))
    assert torch.equal(out.valid, _t(ref.valid))
    ok = out.valid
    assert int(ok.sum()) > 100
    torch.testing.assert_close(out.start[ok], _t(ref.start)[ok], atol=1e-5,
                               rtol=1e-5)
    median, share = homog_bar(out.power[ok], _t(ref.power)[ok])
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    first = out.start.reshape(n, depth, 3)[:, 0]
    from_area = (first[:, 1] - 0.999).abs() < 1e-4
    assert 0 < int(from_area.sum()) < n


def test_point_light_trace_keeps_its_stream():
    """cornell_smoke's point light reads only the emission columns drawn
    first: trace on a seed equals trace_u on the draws in today's order
    (u_emit's first 3 columns, u_walk, the other columns last), and other
    values in the later columns change nothing."""
    scene = presets.cornell_smoke(8, 8, device=CPU)
    cfg = tracer.TracerConfig(max_depth=6)
    vrls = tracer.trace(scene, torch.Generator().manual_seed(5), 32, cfg)
    gen = torch.Generator().manual_seed(5)
    u3 = torch.rand((32, tracer.N_EMIT_FIRST), generator=gen)
    u_walk = torch.rand((32, 6, tracer.N_STEP_DIMS), generator=gen)
    for rest in (torch.rand((32, tracer.N_EMIT_DIMS - tracer.N_EMIT_FIRST),
                            generator=gen),
                 torch.rand((32, tracer.N_EMIT_DIMS - tracer.N_EMIT_FIRST),
                            generator=torch.Generator().manual_seed(6))):
        again = tracer.trace_u(scene, torch.cat([u3, rest], dim=1), u_walk,
                               cfg)
        for k in ("start", "end", "power", "valid"):
            assert torch.equal(getattr(vrls, k), getattr(again, k)), k
    assert int(vrls.valid.sum()) > 0


@pytest.mark.parametrize("preset,extra", [("cornell_smoke", False),
                                          ("cornell_area_light", True)])
def test_trace_leaves_the_generator_where_its_draws_end(preset, extra):
    """trace draws u_emit's first 3 columns, u_walk and, only where a kind
    of the table reads them (an area light here, not cornell_smoke's
    point light), the other emission columns: the generator's next draw
    after trace is the next draw after that order, so a point-light
    pass's later draws (the antialias jitter, the kernel and R seeds)
    stay as they were."""
    scene = getattr(presets, preset)(8, 8, device=CPU)
    cfg = tracer.TracerConfig(max_depth=6)
    after = torch.Generator().manual_seed(5)
    tracer.trace(scene, after, 32, cfg)
    gen = torch.Generator().manual_seed(5)
    torch.rand((32, tracer.N_EMIT_FIRST), generator=gen)
    torch.rand((32, 6, tracer.N_STEP_DIMS), generator=gen)
    if extra:
        torch.rand((32, tracer.N_EMIT_DIMS - tracer.N_EMIT_FIRST),
                   generator=gen)
    assert torch.equal(torch.rand(8, generator=after),
                       torch.rand(8, generator=gen))


def test_point_emitters_keep_their_table():
    """make_point_emitters gives JAX's point table (the preset's light)."""
    ref = convert.scene_from_numpy(jax_scene_leaves(
        jpresets.cornell_smoke(4, 4)), device=CPU).emitters
    ours = em.make_point_emitters([[0.0, 0.75, 0.2]], [[8.0, 8.0, 8.0]],
                                  device=CPU)
    for k in convert.EMITTER_KEYS:
        assert torch.equal(getattr(ours, k), getattr(ref, k)), k


def test_table_checks_its_host_kinds():
    jtable, table = _tables(["point"])
    with pytest.raises(ValueError, match="host kinds"):
        em.Emitters(**{k: getattr(table, k) for k in convert.EMITTER_KEYS},
                    host_kinds=(0, 0))
