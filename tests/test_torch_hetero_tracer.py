"""The port's VRL tracer in a grid medium (Woodcock tracking) against
alvrl_tpu's, on the same uniforms.

trace_u is fed the uniforms the JAX tracer draws from its key tree,
with each step's Woodcock chain of TRACKING_DRAWS steps rebuilt from its
distance key (torch_port_utils.jax_tracer_uniforms), so the two walks
take the same decisions and must give the same VRL buffer.
"""

import jax
import numpy as np
import pytest
import torch

from alvrl_tpu.integrators.vrl import tracer as jtracer
from alvrl_tpu.scene import presets as jpresets
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.integrators.vrl import tracer
from alvrl_tpu_torch.media import heterogeneous as gmed
from alvrl_tpu_torch.scene import presets
from tests.torch_port_utils import jax_scene_leaves, jax_tracer_uniforms

torch.set_num_threads(1)

N_PARTICLES, DEPTH = 8, 4


def _t(a):
    return torch.as_tensor(np.array(a))


CASES = {"hg_short": (True, 5), "hg_long_rr": (False, 2)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_trace_u_matches_jax_trace_in_a_grid(case):
    """Woodcock tracer: trace_u on the uniforms of the JAX key tree
    (tracking chains of TRACKING_DRAWS steps) gives the JAX tracer's VRL
    buffer on cornell_grid_smoke, 8 particles x depth 4."""
    short, rr_depth = CASES[case]
    jscene = jpresets.cornell_grid_smoke(width=8, height=8, grid_res=8)
    key = jax.random.key(4)
    jcfg = jtracer.TracerConfig(max_depth=DEPTH, rr_depth=rr_depth,
                                short_vrls=short)
    ref = jtracer.trace(jscene, key, N_PARTICLES, jcfg)
    u_emit, u_walk, u_track = jax_tracer_uniforms(
        key, N_PARTICLES, DEPTH, gmed.TRACKING_DRAWS)
    scene = convert.scene_from_numpy(jax_scene_leaves(jscene), device="cpu")
    out = tracer.trace_u(scene, _t(u_emit), _t(u_walk),
                         tracer.TracerConfig(max_depth=DEPTH,
                                             rr_depth=rr_depth,
                                             short_vrls=short),
                         _t(u_track))
    valid = _t(ref.valid)
    assert torch.equal(out.valid, valid) and int(valid.sum()) > 4
    for k in ("start", "end", "power"):
        torch.testing.assert_close(getattr(out, k)[valid],
                                   _t(getattr(ref, k))[valid], atol=1e-5,
                                   rtol=1e-5, msg=k)


def test_trace_draws_tracking_uniforms_in_a_grid():
    """trace draws u_track after u_emit's first columns and u_walk in a
    grid medium, and no more for this point light, which reads none of
    u_emit's other columns; trace_u refuses a grid medium without
    u_track."""
    scene = presets.cornell_grid_smoke(6, 6, grid_res=6, device="cpu")
    cfg = tracer.TracerConfig(max_depth=3)
    gen = torch.Generator().manual_seed(9)
    vrls = tracer.trace(scene, gen, 4, cfg)
    g2 = torch.Generator().manual_seed(9)
    u_emit, u_walk = torch.rand((4, 3), generator=g2), torch.rand(
        (4, 3, tracer.N_STEP_DIMS), generator=g2)
    u_track = torch.rand((4, 3, gmed.TRACKING_DRAWS, 2), generator=g2)
    assert torch.equal(torch.rand(4, generator=gen),
                       torch.rand(4, generator=g2))
    u_emit = torch.cat([u_emit, torch.zeros(
        (4, tracer.N_EMIT_DIMS - tracer.N_EMIT_FIRST))], dim=1)
    again = tracer.trace_u(scene, u_emit, u_walk, cfg, u_track)
    assert torch.equal(vrls.end, again.end) and int(vrls.valid.sum()) > 0
    with pytest.raises(ValueError):
        tracer.trace_u(scene, u_emit, u_walk, cfg)
