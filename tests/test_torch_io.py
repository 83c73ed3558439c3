"""alvrl_tpu_torch.io against alvrl_tpu.io: the image writers give the
same bytes and the readers the same arrays; the mesh and .vol readers
read the JAX package's files alike."""

import struct

import numpy as np
import pytest

from alvrl_tpu.io import image as jimage
from alvrl_tpu.io import mesh as jmesh
from alvrl_tpu.io import vol as jvol
from alvrl_tpu_torch.io import image, mesh, vol


def _img(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) * 1.5).astype(np.float32)


@pytest.mark.parametrize("shape", [(5, 7, 3), (4, 6)])
@pytest.mark.parametrize("fmt", ["pfm", "png", "npy"])
def test_writers_give_the_same_bytes(tmp_path, fmt, shape):
    img = _img(shape)
    ours, ref = tmp_path / f"a.{fmt}", tmp_path / f"b.{fmt}"
    getattr(image, f"write_{fmt}")(ours, img)
    getattr(jimage, f"write_{fmt}")(ref, img)
    assert ours.read_bytes() == ref.read_bytes()
    a = getattr(image, f"read_{fmt}")(ours)
    b = getattr(jimage, f"read_{fmt}")(ref)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(image.read_image(ours), jimage.read_image(ref))
    if fmt != "png":
        assert np.array_equal(a, img)


def test_png_reader_filters(tmp_path):
    """A PNG whose rows use the sub, up, average and paeth filters (the
    reader's scalar path), read alike by both packages."""
    import zlib

    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 256, (4, 3, 3), dtype=np.uint8)
    raw = b"".join(bytes([f]) + u8[y].tobytes()
                   for y, f in enumerate((1, 2, 3, 4)))
    p = tmp_path / "f.png"
    with open(p, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(jimage._png_chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 3, 4, 8, 2, 0, 0, 0)))
        f.write(jimage._png_chunk(b"IDAT", zlib.compress(raw)))
        f.write(jimage._png_chunk(b"IEND", b""))
    assert np.array_equal(image.read_png(p), jimage.read_png(p))


def test_image_utilities_match():
    a, b = _img((6, 5, 3), 2), _img((6, 5, 3), 3)
    assert np.array_equal(image.tonemap(a), jimage.tonemap(a))
    assert np.array_equal(image.tonemap(a, burn=0.5),
                          jimage.tonemap(a, burn=0.5))
    assert image.rms(a, b) == jimage.rms(a, b)
    assert image.relative_error(a, b) == jimage.relative_error(a, b)


@pytest.mark.parametrize("ext", ["exr", "hdr", "jpg"])
def test_unported_formats_raise(tmp_path, ext):
    """EXR and JPEG raise with their ROADMAP item; HDR is ported (io/hdr.py)
    and reads what the JAX package writes."""
    if ext == "hdr":
        from alvrl_tpu.io import hdr as jhdr

        img = np.random.default_rng(1).gamma(0.5, 1.0, (4, 6, 3)).astype(
            np.float32)
        jhdr.write_hdr(str(tmp_path / "x.hdr"), img)
        assert np.array_equal(image.read_image(tmp_path / "x.hdr"),
                              jhdr.read_hdr(str(tmp_path / "x.hdr")))
        return
    with pytest.raises(ValueError, match="A11"):
        image.read_image(tmp_path / f"x.{ext}")


def test_obj_matches(tmp_path):
    p = tmp_path / "m.obj"
    p.write_text("# a quad and a triangle\nv 0 0 0\nv 1 0 0\nv 1 1 0\n"
                 "v 0 1 0.5\nvt 0 0\nvt 1 0\nvt 1 1\nvn 0 0 1\n"
                 "f 1/1/1 2/2/1 3/3/1 4/1/1\nf -1 -2 -3\n")
    for ours, ref in ((mesh.load_obj_uv(p), jmesh.load_obj_uv(p)),
                      (mesh.load_obj(p), jmesh.load_obj(p))):
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian",
                                 "binary_big_endian"])
def test_ply_matches(tmp_path, fmt):
    verts = [(0, 0, 0), (1, 0, 0), (1, 1, 0.3), (0, 1, 0)]
    uvs = [(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)]
    header = (f"ply\nformat {fmt} 1.0\nelement vertex 4\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property float s\nproperty float t\n"
              "element face 2\nproperty list uchar int vertex_indices\n"
              "end_header\n").encode()
    p = tmp_path / "m.ply"
    if fmt == "ascii":
        body = "".join(f"{v[0]} {v[1]} {v[2]} {u[0]} {u[1]}\n"
                       for v, u in zip(verts, uvs)) + "4 0 1 2 3\n3 0 2 3\n"
        p.write_bytes(header + body.encode())
    else:
        e = "<" if "little" in fmt else ">"
        body = b"".join(struct.pack(e + "fffff", *v, *u)
                        for v, u in zip(verts, uvs))
        body += struct.pack(e + "Biiii", 4, 0, 1, 2, 3)
        body += struct.pack(e + "Biii", 3, 0, 2, 3)
        p.write_bytes(header + body)
    for ours, ref in ((mesh.load_ply_uv(p), jmesh.load_ply_uv(p)),
                      (mesh.load_ply(p), jmesh.load_ply(p))):
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_serialized_matches(tmp_path):
    rng = np.random.default_rng(5)
    meshes = [(rng.normal(size=(4, 3)).astype(np.float32),
               np.array([[0, 1, 2], [0, 2, 3]], np.int32),
               rng.normal(size=(4, 3)).astype(np.float32),
               rng.random((4, 2)).astype(np.float32)),
              (rng.normal(size=(3, 3)).astype(np.float32),
               np.array([[0, 1, 2]], np.int32))]
    ref = tmp_path / "b.serialized"
    jmesh.save_serialized(ref, meshes)
    assert mesh.serialized_mesh_count(ref) == jmesh.serialized_mesh_count(
        ref) == 2
    for i in range(2):
        for a, b in zip(mesh.load_serialized(ref, i),
                        jmesh.load_serialized(ref, i)):
            assert (a is None and b is None) or np.array_equal(a, b)
    with pytest.raises(IndexError):
        mesh.load_serialized(ref, 2)


@pytest.mark.parametrize("encoding", ["float32", "float16", "uint8"])
@pytest.mark.parametrize("channels", [1, 3])
def test_vol_matches(tmp_path, encoding, channels):
    shape = (3, 4, 5) if channels == 1 else (3, 4, 5, 3)
    data = _img(shape, 6) / 1.5
    ref = tmp_path / "b.vol"
    jvol.write_vol(ref, data, (-1, -2, -3), (1, 2, 3), encoding=encoding)
    for a, b in zip(vol.read_vol(ref), jvol.read_vol(ref)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if encoding == "float32":
        assert np.array_equal(vol.read_vol(ref)[0], data)
