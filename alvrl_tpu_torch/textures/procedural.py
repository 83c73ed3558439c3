"""Textures that modulate a surface's albedo: world-space procedural
fields (checkerboard, grid lines, value noise) and UV-mapped bitmaps.

Counterpart of alvrl_tpu/textures/procedural.py (src/textures/
checkerboard.cpp, gridtexture.cpp, bitmap.cpp), op for op, so that a
texture is the JAX package's bit for bit: the procedural kinds are
functions of the world position, TEX_BITMAP samples the scene's bitmap
stack bilinearly at the hit's interpolated UV (each face corner carries
its UV: the analytic shapes' parameterisations, geometry.shapes.auto_uvs,
or an OBJ's `vt` records). The lattice hash wraps and shifts as int32
arithmetic does, computed in int64 and wrapped explicitly.
"""

from __future__ import annotations

import torch

TEX_NONE = 0
TEX_CHECKER = 1
TEX_GRID = 2
TEX_NOISE = 3
TEX_BITMAP = 4
PROCEDURAL = (TEX_CHECKER, TEX_GRID, TEX_NOISE)
GRID_LINE_WIDTH = 0.08


def interp_uv(face_uv, prim, bary):
    """The texture coordinates at a hit, (..., 2): face prim's corner UVs
    (face_uv (T, 3, 2)) weighted by (1 - u - v, u, v) of the barycentric
    bary (..., 2); a miss (prim -1) reads face 0."""
    fuv = face_uv[prim.clamp(min=0)]
    u, v = bary[..., 0], bary[..., 1]
    w0 = (1.0 - u - v)[..., None]
    return fuv[..., 0, :] * w0 + fuv[..., 1, :] * u[..., None] \
        + fuv[..., 2, :] * v[..., None]


def bitmap_lookup(textures, tex_id, uv):
    """The bilinear sample (..., 3) of textures[tex_id] ((K, H, W, 3); the
    id clamped into [0, K)) at uv (..., 2), wrapped into [0, 1)^2; v runs
    down the image's rows, u wraps around its columns and the rows clamp
    at the edges."""
    k, h, w = textures.shape[0], textures.shape[1], textures.shape[2]
    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0w = torch.remainder(x0, w)
    x1w = torch.remainder(x0 + 1, w)
    y0c = y0.clamp(0, h - 1)
    y1c = (y0 + 1).clamp(0, h - 1)
    tid = torch.broadcast_to(torch.as_tensor(tex_id, device=uv.device)
                             .clamp(0, k - 1), y0c.shape)
    c00 = textures[tid, y0c, x0w]
    c01 = textures[tid, y0c, x1w]
    c10 = textures[tid, y1c, x0w]
    c11 = textures[tid, y1c, x1w]
    return ((c00 * (1 - fx) + c01 * fx) * (1 - fy)
            + (c10 * (1 - fx) + c11 * fx) * fy)


def _wrap32(x):
    """int64 x taken modulo 2^32 into int32's range, as int32 arithmetic
    wraps."""
    return torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31


def _hash3(ip):
    """The integer lattice hash of ip (..., 3) (int32 values in int64)
    -> [0, 1), float32."""
    h = _wrap32(_wrap32(ip[..., 0] * 374761393) + _wrap32(ip[..., 1]
                                                          * 668265263)
                + _wrap32(ip[..., 2] * 1440662683))
    h = _wrap32((h ^ (h >> 13)) * 1274126177)
    h = h ^ (h >> 16)
    return (h & 0x7FFFFF).to(torch.float32) / float(0x800000)


def value_noise(p):
    """Trilinear value noise over the unit lattice, smoothstep-weighted."""
    ip = torch.floor(p).to(torch.int64)
    fp = p - torch.floor(p)
    w = fp * fp * (3.0 - 2.0 * fp)

    def corner(dx, dy, dz):
        return _hash3(ip + torch.tensor([dx, dy, dz], dtype=torch.int64,
                                        device=p.device))

    c000, c100 = corner(0, 0, 0), corner(1, 0, 0)
    c010, c110 = corner(0, 1, 0), corner(1, 1, 0)
    c001, c101 = corner(0, 0, 1), corner(1, 0, 1)
    c011, c111 = corner(0, 1, 1), corner(1, 1, 1)
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    x00 = c000 * (1 - wx) + c100 * wx
    x10 = c010 * (1 - wx) + c110 * wx
    x01 = c001 * (1 - wx) + c101 * wx
    x11 = c011 * (1 - wx) + c111 * wx
    y0 = x00 * (1 - wy) + x10 * wy
    y1 = x01 * (1 - wy) + x11 * wy
    return y0 * (1 - wz) + y1 * wz


def checker(p, scale):
    """1 on the odd cells of the lattice of spacing 1 / scale, else 0."""
    ip = torch.floor(p * scale[..., None]).to(torch.int64)
    return ((ip[..., 0] + ip[..., 1] + ip[..., 2]) & 1).to(torch.float32)


def grid_lines(p, scale, line_width=GRID_LINE_WIDTH):
    """1 within line_width (in cells) of a cell face of the lattice of
    spacing 1 / scale, else 0."""
    ps = p * scale[..., None]
    fp = ps - torch.floor(ps)
    near = torch.minimum(fp, 1.0 - fp)
    return (near.amin(dim=-1) < line_width).to(torch.float32)


def albedo_at(scene, mat_id, p, uv=None):
    """The albedo (..., 3) of material mat_id at the world point p: a
    procedural kind mixes albedo and albedo2 by its texture's value; with
    `uv` (interp_uv at the hit) TEX_BITMAP multiplies the albedo by the
    bitmap's sample at uv * scale; TEX_NONE, and TEX_BITMAP without a
    uv, give the table's albedo."""
    mats = scene.materials
    base = mats.albedo[mat_id]
    kind = mats.tex_kind[mat_id]
    scale = mats.tex_scale[mat_id]
    alb2 = mats.albedo2[mat_id]
    t = torch.where(
        kind == TEX_CHECKER, checker(p, scale),
        torch.where(kind == TEX_GRID, grid_lines(p, scale),
                    torch.where(kind == TEX_NOISE,
                                value_noise(p * scale[..., None]), 0.0)))
    out = base * (1.0 - t[..., None]) + alb2 * t[..., None]
    if uv is not None:
        tex = bitmap_lookup(scene.textures, mats.tex_id[mat_id],
                            uv * scale[..., None])
        out = torch.where((kind == TEX_BITMAP)[..., None], base * tex, out)
    return out
