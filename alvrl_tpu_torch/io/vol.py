"""Mitsuba `.vol` binary grid reader (gridvolume.cpp:60-96 layout); a
copy of alvrl_tpu/io/vol.py's read_vol.

Layout: b'VOL' + version byte (3) + int32 encoding (1 = float32,
2 = float16, 3 = uint8) + int32 xres/yres/zres + int32 channels (1|3)
+ 6 float32 bbox (xmin ymin zmin xmax ymax zmax) + raw data ordered
data[((z*yres + y)*xres + x)*channels + c]. uint8 data is quantized
linearly over [0, 1] like the reference reader.
"""

from __future__ import annotations

import struct

import numpy as np

_ENC = {1: np.float32, 2: np.float16, 3: np.uint8}


def read_vol(path):
    """Read a .vol file -> (data (Z, Y, X[, 3]) float32, box_min,
    box_max)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:3] != b"VOL" or buf[3] != 3:
        raise ValueError("not a v3 .vol file")
    enc, xr, yr, zr, ch = struct.unpack_from("<iiiii", buf, 4)
    if enc not in _ENC:
        raise ValueError(f"unsupported .vol encoding {enc}")
    if ch not in (1, 3):
        raise ValueError(f"unsupported channel count {ch}")
    bbox = struct.unpack_from("<6f", buf, 24)
    raw = np.frombuffer(buf, _ENC[enc], count=xr * yr * zr * ch,
                        offset=48)
    data = raw.astype(np.float32)
    if enc == 3:
        data = data / 255.0
    data = data.reshape(zr, yr, xr, ch)
    if ch == 1:
        data = data[..., 0]
    return (data, np.asarray(bbox[:3], np.float32),
            np.asarray(bbox[3:], np.float32))
