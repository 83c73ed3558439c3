"""Radiance RGBE (.hdr) bitmap I/O.

A copy of alvrl_tpu/io/hdr.py (numpy only).

Counterpart of Bitmap::readRGBE / writeRGBE
(src/libcore/bitmap.cpp:315,347,367 + rgbe helpers at :3900-4030):
shared-exponent 8:8:8:8 HDR encoding with new-style RLE scanlines.
Pure numpy, no image-library dependency (matching this repo's EXR/PFM
codecs). Decoding follows the reference's convention of NOT adding the
half-ulp bias: value = mantissa * 2^(e-136).
"""

from __future__ import annotations

import numpy as np

_HEADER = b"#?RADIANCE\n"


def _encode_rgbe(img):
    """(H, W, 3) float -> (H, W, 4) uint8 shared-exponent pixels."""
    img = np.maximum(np.asarray(img, np.float64), 0.0)
    v = img.max(axis=-1)
    m, e = np.frexp(v)  # v = m * 2^e, m in [0.5, 1)
    scale = np.where(v >= 1e-32, m * 256.0 / np.maximum(v, 1e-300), 0.0)
    rgbe = np.empty(img.shape[:2] + (4,), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(v >= 1e-32, e + 128, 0).astype(np.uint8)
    return rgbe


def _decode_rgbe(rgbe):
    """(..., 4) uint8 -> (..., 3) float32 (bitmap.cpp rgbe decode: no
    +0.5 mantissa bias)."""
    e = rgbe[..., 3].astype(np.int32)
    f = np.where(e > 0, np.ldexp(1.0, e - (128 + 8)), 0.0)
    return (rgbe[..., :3].astype(np.float32) * f[..., None]).astype(
        np.float32)


def _rle_row(comp):
    """New-style RLE of one (W,) uint8 component row -> bytes."""
    out = bytearray()
    w = comp.shape[0]
    i = 0
    while i < w:
        # find a run of >= 4 equal bytes starting at or after i
        run_start = i
        while run_start < w:
            run_len = 1
            while (run_start + run_len < w
                   and run_len < 127
                   and comp[run_start + run_len] == comp[run_start]):
                run_len += 1
            if run_len >= 4:
                break
            run_start += run_len
        else:
            run_start = w
        # literal chunk [i, run_start) in <=128-byte pieces
        j = i
        while j < run_start:
            n = min(128, run_start - j)
            out.append(n)
            out.extend(comp[j:j + n].tobytes())
            j += n
        if run_start < w:
            out.append(128 + run_len)
            out.append(int(comp[run_start]))
            i = run_start + run_len
        else:
            i = w
    return bytes(out)


def write_hdr(path, img):
    """Write (H, W, 3) linear float RGB as a Radiance .hdr file
    (new-style RLE scanlines when 8 <= W < 32768, flat otherwise)."""
    img = np.asarray(img, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) image, got {img.shape}")
    h, w = img.shape[:2]
    rgbe = _encode_rgbe(img)
    with open(path, "wb") as f:
        f.write(_HEADER)
        f.write(b"FORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        if 8 <= w < 32768:
            for y in range(h):
                f.write(bytes([2, 2, (w >> 8) & 0xFF, w & 0xFF]))
                for c in range(4):
                    f.write(_rle_row(rgbe[y, :, c]))
        else:
            f.write(rgbe.tobytes())


def read_hdr(path):
    """Read a Radiance .hdr file -> (H, W, 3) float32 linear RGB.
    Supports new-style RLE, old-style RLE, and flat scanlines."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"#?"):
        raise ValueError("not a Radiance file (missing #? magic)")
    # header: lines until the blank line, then the resolution line
    pos = data.index(b"\n") + 1
    fmt = None
    while True:
        end = data.index(b"\n", pos)
        line = data[pos:end]
        pos = end + 1
        if line.startswith(b"FORMAT="):
            fmt = line.split(b"=", 1)[1].strip()
        if line == b"":
            break
    if fmt not in (None, b"32-bit_rle_rgbe"):
        raise ValueError(f"unsupported .hdr format {fmt!r}")
    end = data.index(b"\n", pos)
    res = data[pos:end].decode().split()
    pos = end + 1
    if len(res) != 4 or res[0] != "-Y" or res[2] != "+X":
        raise ValueError(f"unsupported resolution spec {res}")
    h, w = int(res[1]), int(res[3])

    rgbe = np.zeros((h, w, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    for y in range(h):
        if (pos + 4 <= len(data) and data[pos] == 2 and data[pos + 1] == 2
                and ((data[pos + 2] << 8) | data[pos + 3]) == w):
            # new-style RLE scanline: 4 components in sequence
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    # bounds-check the stream: a corrupt file must not
                    # loop forever (count byte 0) or read/write past
                    # the scanline / buffer (ADVICE r03 item 4)
                    if pos >= len(data):
                        raise ValueError("truncated RLE scanline")
                    n = data[pos]
                    pos += 1
                    if n == 0:
                        raise ValueError("corrupt RLE scanline: zero count")
                    if n > 128:  # run
                        count = n - 128
                        if x + count > w or pos >= len(data):
                            raise ValueError("corrupt RLE run")
                        rgbe[y, x:x + count, c] = data[pos]
                        pos += 1
                        x += count
                    else:        # literal
                        if x + n > w or pos + n > len(data):
                            raise ValueError("corrupt RLE literal")
                        rgbe[y, x:x + n, c] = buf[pos:pos + n]
                        pos += n
                        x += n
        else:
            # flat / old-style RLE pixels
            x = 0
            shift = 0
            while x < w:
                px = buf[pos:pos + 4]
                pos += 4
                if px[0] == 1 and px[1] == 1 and px[2] == 1:
                    count = int(px[3]) << shift
                    rgbe[y, x:x + count] = rgbe[y, x - 1]
                    x += count
                    shift += 8
                else:
                    rgbe[y, x] = px
                    x += 1
                    shift = 0
    return _decode_rgbe(rgbe)
