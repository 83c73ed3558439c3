"""Preetham sky + sun models, baked to the lat-long environment map.

A copy of alvrl_tpu/emitters/sunsky.py (numpy only); sky_envmap also
takes the device of the map it builds.

Counterpart of src/emitters/{sky,sun,sunsky}.cpp. The reference
evaluates the Preetham analytic sky per query and a tabulated solar
spectrum attenuated by the Preetham atmosphere; here both are baked
once (host-side numpy) into the EnvMap sampling structure — the
TPU-native shape: the render path sees only the importance-sampled
texture, identical to any other envmap. RGB (3-channel) instead of the
reference's full spectral pipeline, consistent with the framework-wide
SPECTRUM_SAMPLES=3 default (spectrum.h:25).

Radiance units: the Y channel of the Perez model is in kcd/m^2 as
published; `scale` rescales (sky.cpp exposes the same knob).

Convention: y-up; `sun_dir` points FROM the scene TOWARD the sun.
"""

from __future__ import annotations

import numpy as np

from alvrl_tpu_torch.emitters.envmap import EnvMap, make_envmap

# CIE xyY -> linear sRGB (D65)
_XYZ_TO_RGB = np.array(
    [[3.2404542, -1.5371385, -0.4985314],
     [-0.9692660, 1.8760108, 0.0415560],
     [0.0556434, -0.2040259, 1.0572252]], np.float64
)


def _perez(theta, gamma, a, b, c, d, e):
    """Perez all-weather luminance distribution F(theta, gamma)."""
    cos_t = np.maximum(np.cos(theta), 1e-3)
    cg = np.cos(gamma)
    return (1.0 + a * np.exp(b / cos_t)) * (
        1.0 + c * np.exp(d * gamma) + e * cg * cg
    )


def _zenith_chromaticity(t, theta_s):
    """Preetham zenith x, y as cubic polynomials in the sun zenith
    angle with turbidity-quadratic coefficients."""
    th = theta_s
    t2 = t * t
    v = np.array([th ** 3, th ** 2, th, 1.0])
    xz = (
        t2 * np.dot([0.00166, -0.00375, 0.00209, 0.0], v)
        + t * np.dot([-0.02903, 0.06377, -0.03202, 0.00394], v)
        + np.dot([0.11693, -0.21196, 0.06052, 0.25886], v)
    )
    yz = (
        t2 * np.dot([0.00275, -0.00610, 0.00317, 0.0], v)
        + t * np.dot([-0.04214, 0.08970, -0.04153, 0.00516], v)
        + np.dot([0.15346, -0.26756, 0.06670, 0.26688], v)
    )
    return xz, yz


def preetham_sky_image(sun_dir, turbidity=3.0, width=256, height=128,
                       scale=1.0):
    """Bake the Preetham sky into a (height, width, 3) lat-long RGB
    radiance image (y-up; rows run theta in [0, pi]). The lower
    hemisphere is set to the horizon value (the reference clamps query
    directions to the horizon; sky.cpp extend semantics)."""
    sun_dir = np.asarray(sun_dir, np.float64)
    sun_dir = sun_dir / np.linalg.norm(sun_dir)
    theta_s = np.arccos(np.clip(sun_dir[1], -1.0, 1.0))
    theta_s = min(theta_s, np.pi / 2 - 1e-3)  # keep the model valid
    t = float(turbidity)

    # Perez coefficients for Y, x, y (Preetham tables)
    coefY = (0.1787 * t - 1.4630, -0.3554 * t + 0.4275,
             -0.0227 * t + 5.3251, 0.1206 * t - 2.5771,
             -0.0670 * t + 0.3703)
    coefx = (-0.0193 * t - 0.2592, -0.0665 * t + 0.0008,
             -0.0004 * t + 0.2125, -0.0641 * t - 0.8989,
             -0.0033 * t + 0.0452)
    coefy = (-0.0167 * t - 0.2608, -0.0950 * t + 0.0092,
             -0.0079 * t + 0.2102, -0.0441 * t - 1.6537,
             -0.0109 * t + 0.0529)

    chi = (4.0 / 9.0 - t / 120.0) * (np.pi - 2.0 * theta_s)
    zenith_Y = (4.0453 * t - 4.9710) * np.tan(chi) - 0.2155 * t + 2.4192
    zenith_Y = max(zenith_Y, 1e-3)  # kcd/m^2
    zenith_x, zenith_y = _zenith_chromaticity(t, theta_s)

    # direction grid at texel centers
    vv = (np.arange(height) + 0.5) / height
    uu = (np.arange(width) + 0.5) / width
    theta = vv * np.pi
    phi = (uu - 0.5) * 2.0 * np.pi
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    d = np.stack(
        [np.sin(th) * np.cos(ph), np.cos(th), -np.sin(th) * np.sin(ph)],
        axis=-1,
    )
    # clamp below-horizon queries to the horizon
    th_q = np.minimum(th, np.pi / 2 - 1e-3)
    d_q = d.copy()
    d_q[..., 1] = np.maximum(d_q[..., 1], np.sin(1e-3))
    d_q /= np.linalg.norm(d_q, axis=-1, keepdims=True)
    cos_gamma = np.clip(np.tensordot(d_q, sun_dir, axes=([-1], [0])),
                        -1.0, 1.0)
    gamma = np.arccos(cos_gamma)

    def channel(zen, coef):
        f = _perez(th_q, gamma, *coef)
        f0 = _perez(0.0, theta_s, *coef)
        return zen * f / f0

    Y = channel(zenith_Y, coefY)
    x = channel(zenith_x, coefx)
    y = channel(zenith_y, coefy)

    y_safe = np.maximum(y, 1e-5)
    X = x / y_safe * Y
    Z = (1.0 - x - y) / y_safe * Y
    xyz = np.stack([X, Y, Z], axis=-1)
    rgb = np.einsum("ij,hwj->hwi", _XYZ_TO_RGB, xyz)
    rgb = np.maximum(rgb, 0.0) * float(scale)
    return rgb.astype(np.float32)


# RGB-representative wavelengths (um) and per-wavelength constants for
# the Preetham atmospheric attenuation (sun.cpp computeSunRadiance,
# collapsed from the spectral tables to 3 channels)
_LAMBDA_UM = np.array([0.610, 0.550, 0.465])
_K_OZONE = np.array([0.120, 0.085, 0.009])  # ozone absorption (1/cm)
# top-of-atmosphere solar spectral radiance ratio per channel
# (normalized so an overhead sun with T=2 gives ~1.0 relative white)
_S0 = np.array([1.0, 0.992, 0.911])
_SUN_HALF_ANGLE = np.deg2rad(0.2550)  # solar angular radius (sun.cpp)
SUN_SOLID_ANGLE = 2.0 * np.pi * (1.0 - np.cos(_SUN_HALF_ANGLE))


def sun_rgb_radiance(sun_dir, turbidity=3.0, intensity_scale=1.0):
    """Sun disk RGB radiance after Preetham atmospheric attenuation
    (Rayleigh + aerosol + ozone terms of sun.cpp, 3-channel). Returns
    (3,) radiance; multiply by SUN_SOLID_ANGLE for irradiance.

    intensity_scale sets the unattenuated overhead luminance-channel
    radiance (defaults to a unit-scale sun; physical suns need ~1e4
    in the kcd/m^2 convention of the sky model)."""
    sun_dir = np.asarray(sun_dir, np.float64)
    sun_dir = sun_dir / np.linalg.norm(sun_dir)
    cos_t = np.clip(sun_dir[1], 1e-3, 1.0)
    theta_deg = np.rad2deg(np.arccos(cos_t))
    # relative optical mass (Kasten-Young as used by Preetham A.3)
    m_air = 1.0 / (cos_t + 0.15 * (93.885 - theta_deg) ** (-1.253))
    # Rayleigh scattering
    tau_r = np.exp(-m_air * 0.008735 * _LAMBDA_UM ** (-4.08))
    # aerosol (angstrom turbidity)
    beta = 0.04608 * turbidity - 0.04586
    tau_a = np.exp(-m_air * beta * _LAMBDA_UM ** (-1.3))
    # ozone (l = 0.35 cm)
    tau_o = np.exp(-m_air * _K_OZONE * 0.35)
    rad = _S0 * tau_r * tau_a * tau_o * float(intensity_scale)
    return rad.astype(np.float32)


def sky_envmap(sun_dir, turbidity=3.0, width=256, height=128, scale=1.0,
               with_sun=False, sun_scale=1.0, azimuth_deg=0.0,
               device="cuda") -> EnvMap:
    """Build the importance-sampled EnvMap for sky / sunsky."""
    img = preetham_sky_image(sun_dir, turbidity, width, height, scale)
    if with_sun:
        img = splat_sun(img, sun_dir,
                        sun_rgb_radiance(sun_dir, turbidity, sun_scale))
    return make_envmap(img, scale=1.0, azimuth_deg=azimuth_deg,
                       device=device)


def splat_sun(image, sun_dir, radiance, half_angle=_SUN_HALF_ANGLE):
    """Bake a sun disk into a lat-long image, conserving power: texels
    within the angular radius get the disk radiance added; if the disk
    falls between texel centers, the nearest texel receives the full
    power ratio (sun.cpp renders the disk analytically; baking keeps
    the map self-contained for importance sampling)."""
    img = np.array(image, np.float32, copy=True)
    h, w = img.shape[:2]
    sun_dir = np.asarray(sun_dir, np.float64)
    sun_dir = sun_dir / np.linalg.norm(sun_dir)
    vv = (np.arange(h) + 0.5) / h * np.pi
    uu = ((np.arange(w) + 0.5) / w - 0.5) * 2.0 * np.pi
    th, ph = np.meshgrid(vv, uu, indexing="ij")
    d = np.stack(
        [np.sin(th) * np.cos(ph), np.cos(th), -np.sin(th) * np.sin(ph)],
        axis=-1,
    )
    cosg = np.tensordot(d, sun_dir, axes=([-1], [0]))
    mask = cosg >= np.cos(half_angle)
    if not mask.any():
        # sub-texel sun: deposit the whole power in the nearest texel
        i = int(np.clip(np.arccos(np.clip(sun_dir[1], -1, 1)) / np.pi * h,
                        0, h - 1))
        j = int(np.clip((np.arctan2(-sun_dir[2], sun_dir[0])
                         / (2 * np.pi) + 0.5) * w, 0, w - 1))
        t0, t1 = i / h * np.pi, (i + 1) / h * np.pi
        omega_texel = (np.cos(t0) - np.cos(t1)) * (2 * np.pi / w)
        disk_omega = 2.0 * np.pi * (1.0 - np.cos(half_angle))
        img[i, j] += np.asarray(radiance) * (disk_omega / omega_texel)
    else:
        img[mask] += np.asarray(radiance)
    return img
