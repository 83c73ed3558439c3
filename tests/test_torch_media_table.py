"""Per-shape nested media (media/table.py) against alvrl_tpu: the
transmittance across null boundaries and the medium after a surface
event on the same segments of cornell_nested_smoke, and the analytic
chord of tests/test_nested_media.py:16. A few seconds alone."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from alvrl_tpu.media import table as jtbl
from alvrl_tpu.scene import presets as jpresets
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.media import table as mtbl
from alvrl_tpu_torch.scene import presets
from tests.torch_port_utils import CPU, jax_scene_leaves

torch.set_num_threads(1)

SIG = (0.7, 0.5, 0.3)


def _scenes(**kw):
    jscene = jpresets.cornell_nested_smoke(width=8, height=8, **kw)
    return jscene, convert.scene_from_numpy(jax_scene_leaves(jscene),
                                            device=CPU)


def _segments(n=512, seed=0):
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-0.95, 0.95, (n, 3)).astype(np.float32)
    p1 = rng.uniform(-0.95, 0.95, (n, 3)).astype(np.float32)
    med0 = (np.abs(p0).max(axis=1) < 0.5).astype(np.int32)  # inside the cube
    return p0, p1, med0


def test_the_preset_matches_jax():
    jscene, ref = _scenes()
    ours = presets.cornell_nested_smoke(8, 8, device=CPU)
    for k in ("vertices", "faces", "material", "face_med_int",
              "face_med_ext", "face_emitter"):
        assert torch.equal(getattr(ours, k), getattr(ref, k)), k
    assert torch.equal(ours.materials.kind, ref.materials.kind)
    for k in ("sigma_a", "sigma_s", "g", "sampling_weight"):
        assert torch.equal(getattr(ours.media, k), getattr(ref.media, k)), k
    assert float(ours.medium.sampling_weight) == 0.0  # vacuum outside


def test_nested_transmittance_matches_jax():
    """eval_transmittance_nested on 512 random segments of the box (some
    starting in the cube, some blocked by the walls' back faces) within
    float32 rounding of JAX's, zeros where JAX's are."""
    jscene, scene = _scenes(sigma_a=SIG, sigma_s=(0.2, 0.3, 0.4))
    p0, p1, med0 = _segments()
    ref = jax.vmap(lambda a, b, c: jtbl.eval_transmittance_nested(
        jscene, a, b, c))(jnp.asarray(p0), jnp.asarray(p1),
                          jnp.asarray(med0))
    out = mtbl.eval_transmittance_nested(
        scene, torch.as_tensor(p0), torch.as_tensor(p1),
        torch.as_tensor(med0, dtype=torch.int64))
    ref = torch.as_tensor(np.asarray(ref))
    assert torch.equal(out == 0, ref == 0)
    assert 0.2 < float((ref[:, 0] < 1.0).double().mean()) < 1.0
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-7)


def test_medium_after_surface_matches_jax():
    jscene, scene = _scenes()
    rng = np.random.default_rng(1)
    prim = rng.integers(0, scene.faces.shape[0], 256)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    ref = np.asarray(jtbl.medium_after_surface(jscene, jnp.asarray(prim),
                                               jnp.asarray(d)))
    out = mtbl.medium_after_surface(scene, torch.as_tensor(prim),
                                    torch.as_tensor(d))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert 0 < int(out.sum()) < 256


def test_nested_transmittance_analytic():
    """tests/test_nested_media.py:16 on the port: through the absorbing
    cube the chord's exp(-sigma_t * 1); from its centre half of it; 0
    past an opaque wall."""
    scene = presets.cornell_nested_smoke(8, 8, sigma_a=SIG,
                                         sigma_s=(0.0, 0.0, 0.0), device=CPU)
    p0 = torch.tensor([[0.0, 0.0, -0.9]])
    p1 = torch.tensor([[0.0, 0.0, 0.9]])
    tau = mtbl.eval_transmittance_nested(scene, p0, p1, torch.tensor([0]))
    np.testing.assert_allclose(tau[0].numpy(), np.exp(-np.asarray(SIG)),
                               rtol=2e-3)
    tau = mtbl.eval_transmittance_nested(
        scene, torch.zeros((1, 3)), p1, torch.tensor([1]))
    np.testing.assert_allclose(tau[0].numpy(), np.exp(-np.asarray(SIG) * 0.5),
                               rtol=2e-3)
    tau = mtbl.eval_transmittance_nested(
        scene, p0, torch.tensor([[0.0, 0.0, 2.5]]), torch.tensor([0]))
    assert float(tau.abs().max()) == 0.0
