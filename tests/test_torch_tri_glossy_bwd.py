"""The gradient of glossy surfaces in a grid medium of fast_tau=False in
alvrl_tpu_torch against alvrl_tpu: kernel 9's trilinear material form's
plain version (ops.vrl_sum_bwd.vrl_sum_hetero_diff with `materials` on
the trilinear medium pack) on tests/test_torch_grid_glossy.py's glossy
grid box against jax.value_and_grad of JAX's XLA table path with
fast_tau=False, whose pair_contribution evaluates every smooth kind at
the eye hit, by tests/test_torch_tri_bwd.py's method. Apart from that
file so that xdist's --dist loadfile runs the two JAX compiles on two
workers. About 80 s alone, most of it JAX's glossy scene build (the
rough coat's transmittance table) and its compile.
"""

import torch

from tests.test_torch_tri_bwd import _hold_tri_table

torch.set_num_threads(1)


def test_plain_trilinear_material_vjp_matches_xla_table_path():
    """Kernel 9tm's plain version on the glossy grid box (the eleven
    smooth kinds; 16 rays x 128 VRLs) against XLA AD of the fast_tau=False
    table path, whose pair_contribution evaluates every smooth kind at
    the eye hit: as the diffuse table's hold."""
    _hold_tri_table("glossy")
