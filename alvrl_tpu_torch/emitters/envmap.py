"""Environment map emitter: a lat-long radiance texture with exact
luminance-proportional importance sampling.

Counterpart of alvrl_tpu/emitters/envmap.py. The map and its sampling
tables are built on the host in numpy, as the reference builds them,
then moved to a device; the lookup and the sampling are torch ops on
that device, batched over a leading axis. Sampling inverts the row CDF,
then the chosen row's column CDF, and draws uniformly in solid angle
inside the texel, so the pdf is piecewise constant and equals pdf_env
exactly (eval is a nearest-texel lookup).

Direction convention (y up): theta = acos(d.y) gives the row
v = theta / pi (row 0 is the +y pole); phi = atan2(-d.z, d.x) minus the
azimuth gives the column u = phi / 2 pi + 0.5.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from alvrl_tpu_torch.core.spectrum import LUM_WEIGHTS

_TWO_PI = 2.0 * math.pi


@dataclass(frozen=True)
class EnvMap:
    image: torch.Tensor     # (H, W, 3) radiance (scale premultiplied)
    row_cdf: torch.Tensor   # (H,) CDF over rows of sin-weighted luminance
    cond_cdf: torch.Tensor  # (H, W) each row's CDF over its columns
    pdf_map: torch.Tensor   # (H, W) solid-angle pdf of sampling each texel
    mean: torch.Tensor      # (3,) mean radiance over the sphere
    azimuth: torch.Tensor   # () rotation about +y (radians)
    host_mean: tuple = (0.0, 0.0, 0.0)  # `mean` as host floats

    def __eq__(self, other):
        """Equal maps: every table equal, element by element (on the
        host, so that maps on two devices compare)."""
        return isinstance(other, EnvMap) and all(
            torch.equal(getattr(self, k).cpu(), getattr(other, k).cpu())
            for k in ("image", "row_cdf", "cond_cdf", "pdf_map", "mean",
                      "azimuth"))

    __hash__ = None


def make_envmap(image, scale=1.0, azimuth_deg=0.0, device="cuda") -> EnvMap:
    """The map and its sampling tables (make_envmap of the reference),
    from an (H, W, 3) (or (H, W)) float radiance image."""
    img = np.asarray(image, np.float32) * np.float32(scale)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    h, w = img.shape[:2]
    theta_c = (np.arange(h) + 0.5) / h * np.pi
    sin_w = np.sin(theta_c).astype(np.float32)
    lum = (img * np.asarray(LUM_WEIGHTS, np.float32)).sum(axis=-1)
    lum = np.maximum(lum, 0.0)
    # strictly positive: every texel keeps a non-zero probability
    weighted = lum * sin_w[:, None] + 1e-12
    row_cdf = np.cumsum(weighted.sum(axis=1))
    total = row_cdf[-1]
    row_cdf = row_cdf / total
    cond_cdf = np.cumsum(weighted, axis=1)
    cond_cdf = cond_cdf / cond_cdf[:, -1:]
    # texel solid angle: (cos t0 - cos t1) 2 pi / W
    t0 = np.arange(h) / h * np.pi
    t1 = (np.arange(h) + 1) / h * np.pi
    omega = ((np.cos(t0) - np.cos(t1)) * (_TWO_PI / w)).astype(np.float32)
    pdf_map = (weighted / total) / np.maximum(omega[:, None], 1e-12)
    mean = ((img * omega[:, None, None]).sum(axis=(0, 1))
            / (4.0 * np.pi)).astype(np.float32)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return EnvMap(image=dev(img), row_cdf=dev(row_cdf),
                  cond_cdf=dev(cond_cdf), pdf_map=dev(pdf_map),
                  mean=dev(mean),
                  azimuth=dev(np.float32(np.deg2rad(azimuth_deg))),
                  host_mean=tuple(float(x) for x in mean))


def default_envmap(device="cuda") -> EnvMap:
    """The 1x1 zero map: the table's map when it has no ENVMAP entry."""
    return make_envmap(np.zeros((1, 1, 3), np.float32), device=device)


def _dir_to_uv(env: EnvMap, d):
    """Unit directions (..., 3) -> continuous (v, u) in [0, 1)^2."""
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.atan2(-d[..., 2], d[..., 0]) - env.azimuth
    u = phi / _TWO_PI + 0.5
    return theta / math.pi, u - torch.floor(u)


def _texel(env: EnvMap, d):
    h, w = env.image.shape[:2]
    v, u = _dir_to_uv(env, d)
    return (torch.clamp((v * h).to(torch.int64), 0, h - 1),
            torch.clamp((u * w).to(torch.int64), 0, w - 1))


def eval_env(env: EnvMap, d):
    """(..., 3) radiance arriving from the directions d (pointing at the
    environment), the nearest texel's."""
    row, col = _texel(env, d)
    return env.image[row, col]


def pdf_env(env: EnvMap, d):
    """(...) solid-angle pdf of sample_env producing d."""
    row, col = _texel(env, d)
    return env.pdf_map[row, col]


def _cell(cdf, idx, u):
    """u re-standardised inside CDF cell idx (the texel jitter)."""
    lo = torch.where(idx > 0, torch.gather(cdf, -1, (idx - 1).clamp(min=0)),
                     0.0)
    hi = torch.gather(cdf, -1, idx)
    return torch.clamp((u - lo) / torch.clamp(hi - lo, min=1e-12), 0.0,
                       1.0 - 1e-6)


def sample_env(env: EnvMap, u2):
    """Directions ~ luminance x sin(theta) from the uniforms u2 (..., 2):
    (d (..., 3) pointing at the environment, pdf (...), radiance
    (..., 3))."""
    h, w = env.image.shape[:2]
    u_row, u_col = u2[..., 0].contiguous(), u2[..., 1].contiguous()
    row = torch.clamp(torch.searchsorted(env.row_cdf, u_row), 0, h - 1)
    fr = _cell(env.row_cdf.expand(row.shape + (h,)), row[..., None],
               u_row[..., None])[..., 0]
    cdf_row = env.cond_cdf[row]
    col = torch.clamp(torch.searchsorted(cdf_row, u_col[..., None])[..., 0],
                      0, w - 1)
    fc = _cell(cdf_row, col[..., None], u_col[..., None])[..., 0]
    # uniform in solid angle within the texel: cos theta uniform on the
    # texel's [cos t1, cos t0], phi uniform
    rowf = row.to(torch.float32)
    ct0 = torch.cos(rowf / h * math.pi)
    ct1 = torch.cos((rowf + 1) / h * math.pi)
    theta = torch.arccos(torch.clamp(ct0 + fr * (ct1 - ct0), -1.0, 1.0))
    phi = ((col.to(torch.float32) + fc) / w - 0.5) * _TWO_PI + env.azimuth
    st = torch.sin(theta)
    d = torch.stack([st * torch.cos(phi), torch.cos(theta),
                     -st * torch.sin(phi)], dim=-1)
    return d, env.pdf_map[row, col], env.image[row, col]
