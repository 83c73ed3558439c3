"""ROADMAP C12 on the CPU: the plain grid backward in float32 against
itself in float64.

At the full config-4 shape (262,144 rays x 512 VRLs) the float32 plain
backward's per-VRL sums sit 1.2e-5 (d_vod's median) from their float64
values, above the homogeneous bar, so chip_smoke.py holds the grid
backward kernel's d_power and d_vod against the plain backward evaluated
in float64 there. This checks, at a small shape where float32 rounding
is far below the bar, that the two evaluations of
ops.vrl_sum_bwd.vrl_sum_hetero_bwd_reference agree to the homogeneous
bar (median per-item relative error < 1e-5, < 2 % of items over 1e-2) in
every output, d_par to 1e-5 relative: the float64 evaluation computes
the same function, on the same numpy-seeded inputs.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from alvrl_tpu_torch.integrators.vrl import integrator, vrl
from alvrl_tpu_torch.ops.vrl_sum import HOMOG_MEDIAN, HOMOG_SHARE, homog_bar
from alvrl_tpu_torch.ops.vrl_sum_bwd import vrl_sum_hetero_bwd_reference
from alvrl_tpu_torch.scene import presets
from tests.torch_port_utils import BENCH_VRLS, CPU

torch.set_num_threads(1)

N_VRLS = 48
PAR_RTOL64 = 1e-5  # d_par's float32 sums of 120 x 48 pairs against float64


@pytest.fixture(scope="module")
def packs():
    scene = presets.cornell_grid_smoke(12, 10, grid_res=6, device=CPU)
    full = vrl.load_ascii(BENCH_VRLS, particle_count=78.0, device=CPU)
    vrls = replace(full, start=full.start[:N_VRLS], end=full.end[:N_VRLS],
                   power=full.power[:N_VRLS], valid=full.valid[:N_VRLS])
    return integrator.pack_frame(scene, vrls)[3]


@pytest.mark.parametrize("kind", [0, 1], ids=["hg", "rayleigh"])
@pytest.mark.parametrize("short_vrls", [True, False], ids=["short", "long"])
def test_plain_grid_backward_float32_matches_float64(packs, kind,
                                                     short_vrls):
    rng = np.random.default_rng(20 + 2 * kind + short_vrls)
    n_rays, n_vrls = packs[0].shape[1], packs[1].shape[1]
    u = torch.as_tensor(rng.random((n_rays, n_vrls, 6), dtype=np.float32))
    gbar = torch.as_tensor(rng.uniform(0.5, 1.5, (3, n_rays))
                           .astype(np.float32))
    kw = dict(short_vrls=short_vrls, phase_kind=kind)
    out32 = vrl_sum_hetero_bwd_reference(*packs, gbar, u, **kw)
    out64 = vrl_sum_hetero_bwd_reference(
        *(x.double() for x in (*packs, gbar, u)), **kw)
    assert all(o.dtype == torch.float32 for o in out32)
    assert all(o.dtype == torch.float64 for o in out64)
    for i in (0, 2, 3, 4):  # d_power, d_tau, d_eod, d_vod
        assert float(out32[i].abs().sum()) > 0.0
        median, share = homog_bar(out32[i].T.double(), out64[i].T,
                                  channels=out32[i].shape[0])
        assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (i, median,
                                                               share)
    d32, d64 = out32[5].reshape(-1).double(), out64[5].reshape(-1)
    nz = d64.abs() > 1e-3 * float(d64.abs().max())
    assert int(nz.sum()) > 20
    median, share = homog_bar(d32[nz][:, None], d64[nz][:, None], channels=1)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)
    live = out64[1] != 0.0
    assert torch.equal(out32[1] != 0.0, live)
    rel = ((out32[1].double() - out64[1]).abs()[live]
           / out64[1].abs()[live])
    assert float(rel.max()) < PAR_RTOL64, rel
