"""Triangle-mesh loaders: OBJ, PLY, and mitsuba `.serialized`; a copy of
alvrl_tpu/io/mesh.py.

Counterpart of src/shapes/{obj,ply,serialized}.cpp. Pure numpy,
triangulates polygon faces by fanning. The `.serialized` reader follows
TriMesh::loadCompressed (src/librender/trimesh.cpp:175-260): little-
endian header 0x041C + version, zlib-deflated per-mesh streams with a
flags word, and a uint64 offset dictionary + uint32 mesh count at EOF.
"""

from __future__ import annotations

import struct as _struct

import numpy as np


def load_obj(path):
    """Returns (vertices (V,3) f32, faces (F,3) i32)."""
    v, f, _ = load_obj_uv(path)
    return v, f


def load_obj_uv(path):
    """OBJ loader carrying texture coordinates: returns (vertices (V,3),
    faces (F,3) i32, face_uv (F,3,2) f32). `vt` records and f v/vt[/vn]
    corner indices (obj.cpp texcoord support); faces without vt get
    zero UVs."""
    verts = []
    uvs = []
    faces = []
    face_uv = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("vt "):
                parts = line.split()
                uvs.append([float(parts[1]), float(parts[2])])
            elif line.startswith("f "):
                idx = []
                tidx = []
                for tok in line.split()[1:]:
                    comps = tok.split("/")
                    i = int(comps[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                    if len(comps) > 1 and comps[1]:
                        ti = int(comps[1])
                        tidx.append(ti - 1 if ti > 0 else len(uvs) + ti)
                    else:
                        tidx.append(-1)
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
                    corner_t = [tidx[0], tidx[k], tidx[k + 1]]
                    face_uv.append([
                        uvs[t] if 0 <= t < len(uvs) else [0.0, 0.0]
                        for t in corner_t
                    ])
    return (
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int32).reshape(-1, 3),
        np.asarray(face_uv, np.float32).reshape(-1, 3, 2),
    )


_PLY_TYPES = {
    "char": ("b", 1), "uchar": ("B", 1), "int8": ("b", 1), "uint8": ("B", 1),
    "short": ("h", 2), "ushort": ("H", 2), "int16": ("h", 2), "uint16": ("H", 2),
    "int": ("i", 4), "uint": ("I", 4), "int32": ("i", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def load_ply(path):
    """ASCII and binary-little/big-endian PLY. Returns (verts, faces)."""
    v, f, _ = load_ply_uv(path)
    return v, f


_PLY_UV_NAMES = [("s", "t"), ("u", "v"), ("texture_u", "texture_v")]


def load_ply_uv(path):
    """PLY with per-vertex texture coordinates (s/t, u/v or
    texture_u/texture_v properties — ply.cpp texcoord support).
    Returns (verts, faces, face_uv (F, 3, 2); zeros when absent)."""
    vert_uv = None
    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply"
        fmt = None
        elements = []  # (name, count, [(prop_type, prop_name) | list prop])
        cur = None
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("comment"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                cur = (name, int(cnt), [])
                elements.append(cur)
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    cur[2].append(("list", parts[2], parts[3], parts[4]))
                else:
                    cur[2].append(("scalar", parts[1], parts[2]))
            elif line == "end_header":
                break

        verts = None
        faces = []
        if fmt == "ascii":
            for name, count, props in elements:
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    names = [p[2] for p in props]
                    ix, iy, iz = names.index("x"), names.index("y"), names.index("z")
                    verts = np.asarray(
                        [[float(r[ix]), float(r[iy]), float(r[iz])] for r in rows],
                        np.float32,
                    )
                    for un, vn in _PLY_UV_NAMES:
                        if un in names and vn in names:
                            iu, iv = names.index(un), names.index(vn)
                            vert_uv = np.asarray(
                                [[float(r[iu]), float(r[iv])]
                                 for r in rows], np.float32)
                            break
                elif name == "face":
                    for r in rows:
                        n = int(r[0])
                        idx = [int(x) for x in r[1:1 + n]]
                        for k in range(1, n - 1):
                            faces.append([idx[0], idx[k], idx[k + 1]])
        else:
            endian = "<" if "little" in fmt else ">"
            for name, count, props in elements:
                if name == "vertex":
                    fmt_str = endian + "".join(
                        _PLY_TYPES[p[1]][0] for p in props
                    )
                    size = _struct.calcsize(fmt_str)
                    names = [p[2] for p in props]
                    ix, iy, iz = names.index("x"), names.index("y"), names.index("z")
                    data = [
                        _struct.unpack(fmt_str, f.read(size))
                        for _ in range(count)
                    ]
                    verts = np.asarray(
                        [[d[ix], d[iy], d[iz]] for d in data], np.float32
                    )
                    for un, vn in _PLY_UV_NAMES:
                        if un in names and vn in names:
                            iu, iv = names.index(un), names.index(vn)
                            vert_uv = np.asarray(
                                [[d[iu], d[iv]] for d in data],
                                np.float32)
                            break
                elif name == "face":
                    p = props[0]
                    cnt_fmt, cnt_sz = _PLY_TYPES[p[1]]
                    idx_fmt, idx_sz = _PLY_TYPES[p[2]]
                    for _ in range(count):
                        (n,) = _struct.unpack(
                            endian + cnt_fmt, f.read(cnt_sz)
                        )
                        idx = _struct.unpack(
                            endian + idx_fmt * n, f.read(idx_sz * n)
                        )
                        for k in range(1, n - 1):
                            faces.append([idx[0], idx[k], idx[k + 1]])
                else:
                    # skip unknown fixed-size elements
                    fmt_str = endian + "".join(
                        _PLY_TYPES[p[1]][0] for p in props if p[0] == "scalar"
                    )
                    f.read(_struct.calcsize(fmt_str) * count)
    faces = np.asarray(faces, np.int32).reshape(-1, 3)
    if vert_uv is not None:
        face_uv = vert_uv[faces]
    else:
        face_uv = np.zeros((len(faces), 3, 2), np.float32)
    return verts, faces, face_uv


# ---------------------------------------------------------------------------
# mitsuba .serialized (TriMesh::loadCompressed, trimesh.cpp:175-260)
# ---------------------------------------------------------------------------

_SER_MAGIC = 0x041C
_E_HAS_NORMALS = 0x0001
_E_HAS_TEXCOORDS = 0x0002
_E_HAS_COLORS = 0x0008
_E_FACE_NORMALS = 0x0010
_E_SINGLE = 0x1000
_E_DOUBLE = 0x2000


def serialized_mesh_count(path) -> int:
    """Number of meshes in a .serialized file (uint32 at EOF)."""
    with open(path, "rb") as f:
        f.seek(-4, 2)
        (n,) = _struct.unpack("<I", f.read(4))
    return n


def load_serialized(path, index: int = 0):
    """Load one mesh from a .serialized file.

    Returns (verts (V, 3) f32, faces (T, 3) i32, normals (V, 3) | None,
    uvs (V, 2) | None). Mesh `index` is located through the uint64
    offset dictionary at the end of the file.
    """
    import zlib

    with open(path, "rb") as f:
        buf = f.read()
    magic, version = _struct.unpack_from("<HH", buf, 0)
    if magic != _SER_MAGIC:
        raise ValueError("not a mitsuba .serialized file")
    if version not in (3, 4):
        raise ValueError(f"unsupported .serialized version {version}")

    (count,) = _struct.unpack_from("<I", buf, len(buf) - 4)
    if not 0 <= index < count:
        raise IndexError(f"mesh index {index} out of range ({count})")
    dict_start = len(buf) - 4 - 8 * count
    (offset,) = _struct.unpack_from("<Q", buf, dict_start + 8 * index)
    start = offset + 4  # skip the per-mesh magic+version header

    data = zlib.decompressobj().decompress(buf[start:])
    pos = 0
    (flags,) = _struct.unpack_from("<I", data, pos)
    pos += 4
    if version == 4:  # null-terminated mesh name
        end = data.index(b"\0", pos)
        pos = end + 1
    v_count, t_count = _struct.unpack_from("<QQ", data, pos)
    pos += 16

    dtype = np.float64 if flags & _E_DOUBLE else np.float32
    fsize = 8 if flags & _E_DOUBLE else 4

    def read_arr(n_elem):
        nonlocal pos
        a = np.frombuffer(data, dtype, count=n_elem, offset=pos)
        pos += n_elem * fsize
        return a.astype(np.float32)

    verts = read_arr(v_count * 3).reshape(-1, 3)
    normals = None
    if flags & _E_HAS_NORMALS:
        normals = read_arr(v_count * 3).reshape(-1, 3)
    uvs = None
    if flags & _E_HAS_TEXCOORDS:
        uvs = read_arr(v_count * 2).reshape(-1, 2)
    if flags & _E_HAS_COLORS:
        read_arr(v_count * 3)
    idx_t = np.uint64 if v_count > 0xFFFFFFFF else np.uint32
    faces = np.frombuffer(
        data, idx_t, count=t_count * 3, offset=pos
    ).astype(np.int32).reshape(-1, 3)
    return verts, faces, normals, uvs
