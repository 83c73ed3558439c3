"""The CUDA kernel of alvrl_tpu_torch against its plain PyTorch version.

These tests need a CUDA card (the kernel has no CPU mode) and skip
without one. They import no jax; tests/conftest.py does, so on a host
without jax run them without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from alvrl_tpu_torch.integrators.vrl import integrator, vrl
from alvrl_tpu_torch.ops.vrl_sum import (
    HOMOG_MEDIAN,
    HOMOG_SHARE,
    homog_bar,
    philox_uniforms,
    vrl_sum,
    vrl_sum_reference,
)
from alvrl_tpu_torch.scene import presets

BENCH_VRLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "bench_vrls.txt")

# (g, phase kind): isotropic, forward-scattering HG, Rayleigh
MEDIA = {"hg_g0": (0.0, 0), "hg_g06": (0.6, 0), "rayleigh": (0.0, 1)}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _scene(device, width, height, g=0.0, phase_kind=0):
    scene = presets.cornell_smoke(width, height, g=g, device=device)
    return replace(scene, medium=replace(scene.medium, phase_kind=phase_kind))


def _bench_vrls(device):
    return vrl.compact(vrl.load_ascii(BENCH_VRLS, particle_count=78.0,
                                      device=device), 512)


@pytest.mark.parametrize("medium", sorted(MEDIA))
@pytest.mark.parametrize("injected", [True, False], ids=["injected", "philox"])
@pytest.mark.parametrize("short_vrls", [True, False], ids=["short", "long"])
def test_cuda_kernel_matches_plain(cuda, medium, injected, short_vrls):
    """Kernel vs plain version, 32x32 eye rays x 512 VRLs, with injected
    uniforms or the kernel's own Philox stream, with and without the
    short-VRL pdfFailure division."""
    g, kind = MEDIA[medium]
    packs = integrator.pack_frame(_scene(cuda, 32, 32, g, kind),
                                  _bench_vrls(cuda))[3]
    n_rays = packs[0].shape[1]
    if injected:
        u = torch.as_tensor(np.random.default_rng(3).random(
            (n_rays, 512, 6), dtype=np.float32), device=cuda)
    else:
        u = philox_uniforms(4321, n_rays, 512, 6, device=cuda)
    before = vrl_sum.launches
    out = vrl_sum(*packs, seed=4321, uniforms=u if injected else None,
                  short_vrls=short_vrls, phase_kind=kind)
    torch.cuda.synchronize()
    assert vrl_sum.launches == before + 1
    ref = vrl_sum_reference(*packs, u, short_vrls=short_vrls, phase_kind=kind)
    assert torch.isfinite(out).all() and float(out.abs().sum()) > 0.0
    median, share = homog_bar(out.T, ref.T)
    assert median < HOMOG_MEDIAN and share < HOMOG_SHARE, (median, share)


def test_cuda_kernel_is_deterministic(cuda):
    packs = integrator.pack_frame(_scene(cuda, 16, 16), _bench_vrls(cuda))[3]
    assert torch.equal(vrl_sum(*packs, seed=5), vrl_sum(*packs, seed=5))
    assert not torch.equal(vrl_sum(*packs, seed=5), vrl_sum(*packs, seed=6))


def test_cuda_render_counts_launches(cuda):
    scene = _scene(cuda, 16, 16)
    before = vrl_sum.launches
    img = integrator.render_with_vrls_kernel(
        scene, _bench_vrls(cuda), torch.Generator().manual_seed(0))
    assert vrl_sum.launches == before + 1
    assert img.shape == (16, 16, 3) and torch.isfinite(img).all()
    assert float(img.mean()) > 0.0


def test_cuda_rejects_too_many_triangles(cuda):
    packs = list(integrator.pack_frame(_scene(cuda, 4, 4),
                                       _bench_vrls(cuda))[3])
    packs[2] = torch.zeros((100000, 9), device=cuda)
    with pytest.raises(ValueError):
        vrl_sum(*packs)
