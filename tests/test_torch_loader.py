"""alvrl_tpu_torch.scene.loader against alvrl_tpu.scene.loader: the same
scene files through both loaders, the JAX scene carried across by
convert.scene_from_numpy and compared leaf by leaf; the XML converter's
dict; and the kinds the port refuses."""

import json
import struct

import numpy as np
import pytest
import torch

from alvrl_tpu.io import mesh as jmesh
from alvrl_tpu.io import vol as jvol
from alvrl_tpu.scene import loader as jloader
from alvrl_tpu.scene import presets as jpresets
from alvrl_tpu_torch import convert
from alvrl_tpu_torch.scene import loader
from tests.torch_port_utils import (
    CPU,
    SMOOTH_KINDS,
    SMOOTH_MATERIALS,
    jax_scene_leaves,
)

torch.set_num_threads(1)

# tests/test_loader.py's dict scene, its dielectric sphere a null one
SCENE = {
    "camera": {"type": "perspective", "origin": [0, 0, -0.99],
               "target": [0, 0, 1], "fov": 90, "width": 8, "height": 8},
    "medium": {"type": "homogeneous", "sigma_s": [0.6] * 3,
               "sigma_a": [0.05] * 3, "g": 0.3},
    "materials": [
        {"name": "white", "type": "diffuse", "albedo": [0.7, 0.7, 0.7]},
        {"name": "glass", "type": "null"},
    ],
    "shapes": [
        {"type": "cube", "material": "white", "flip_normals": True},
        {"type": "sphere", "material": "glass", "center": [0, 0, 0.3],
         "radius": 0.2, "n_theta": 4, "n_phi": 8},
    ],
    "emitters": [
        {"type": "point", "position": [0, 0.8, 0], "intensity": [5, 5, 5]},
    ],
}

TW = [[0.5, 0.1, 0.0, 0.2], [0.0, 0.4, 0.1, -0.3], [0.2, 0.0, 0.6, 0.1],
      [0.0, 0.0, 0.0, 1.0]]

# tests/test_loader.py::test_mitsuba_xml_convert's scene
XML = """<scene version="0.5.0">
    <sensor type="perspective">
        <float name="fov" value="60"/>
        <transform name="toWorld">
            <lookat origin="0, 0, -1" target="0, 0, 1" up="0, 1, 0"/>
        </transform>
        <film type="hdrfilm">
            <integer name="width" value="16"/>
            <integer name="height" value="16"/>
        </film>
    </sensor>
    <bsdf type="diffuse" id="walls">
        <rgb name="reflectance" value="0.7, 0.6, 0.5"/>
    </bsdf>
    <shape type="cube">
        <ref id="walls"/>
    </shape>
    <emitter type="point">
        <point name="position" x="0" y="0.5" z="0"/>
        <rgb name="intensity" value="4, 4, 4"/>
    </emitter>
    <medium type="homogeneous" id="med">
        <rgb name="sigmaS" value="0.5, 0.5, 0.5"/>
        <rgb name="sigmaA" value="0.02, 0.02, 0.02"/>
        <phase type="hg"><float name="g" value="0.4"/></phase>
    </medium>
    </scene>"""


def _fields(obj):
    return {k: getattr(obj, k) for k in obj.__dataclass_fields__}


def assert_same_scene(ours, jax_scene):
    """Integer leaves and copies exactly; vertices and the camera matrix
    (products of transforms) within 1e-6; the rough-transmittance tables
    (means of 2,048 sampled weights, summed in another order by each
    package) within 1e-6."""
    ref = convert.scene_from_numpy(jax_scene_leaves(jax_scene), device=CPU)
    for name in ("faces", "material"):
        assert torch.equal(getattr(ours, name), getattr(ref, name)), name
    torch.testing.assert_close(ours.vertices, ref.vertices, atol=1e-6,
                               rtol=0)
    for part in ("materials", "emitters", "medium", "camera"):
        a, b = _fields(getattr(ours, part)), _fields(getattr(ref, part))
        for k in a:
            if (part, k) in (("camera", "to_world"),
                             ("materials", "rt_table")):
                torch.testing.assert_close(a[k], b[k], atol=1e-6, rtol=0)
            elif (part, k) == ("emitters", "env"):
                # the map's tables (sums of float32 luminances, in another
                # order by each package) within 1e-6, its image exactly
                assert torch.equal(a[k].image, b[k].image)
                for t in ("row_cdf", "cond_cdf", "pdf_map", "mean"):
                    torch.testing.assert_close(getattr(a[k], t),
                                               getattr(b[k], t), rtol=1e-6,
                                               atol=1e-7, msg=t)
            elif (part, k) == ("medium", "phase_params"):
                assert (a[k] is None) == (b[k] is None)
                for x, y in zip(a[k] or (), b[k] or ()):
                    assert (x == y if not isinstance(x, torch.Tensor)
                            else torch.equal(x, y.to(x.dtype))), k
            elif isinstance(a[k], torch.Tensor):
                assert a[k].dtype == b[k].dtype, f"{part}.{k}"
                assert torch.equal(a[k], b[k]), f"{part}.{k}"
            else:
                assert a[k] == b[k], f"{part}.{k}"
    assert torch.equal(ours.opaque_faces(), ref.opaque_faces())
    assert torch.equal(ours.face_emitters(), ref.face_emitters())
    assert (ours.media is None) == (ref.media is None)
    if ours.media is not None:
        for k in ("sigma_a", "sigma_s", "g", "sampling_weight"):
            assert torch.equal(getattr(ours.media, k),
                               getattr(ref.media, k)), k
        assert torch.equal(ours.face_med_int, ref.face_med_int)
        assert torch.equal(ours.face_med_ext, ref.face_med_ext)


def test_dict_scene_matches():
    ours = loader.load_json(SCENE, device=CPU)
    assert_same_scene(ours, jloader.load_json(SCENE))
    assert int((~ours.opaque_faces()).sum()) == 4 * 8 * 2  # the null sphere


def test_defines_substitution(tmp_path):
    p = tmp_path / "s.json"
    p.write_text(json.dumps(SCENE).replace('"fov": 90', '"fov": $fov'))
    ours = loader.load_json(str(p), defines={"fov": 45}, device=CPU)
    assert float(ours.camera.fov_x_deg) == 45.0
    assert_same_scene(ours, jloader.load_json(str(p), defines={"fov": 45}))


def _mesh_scene(shape):
    return dict(SCENE, shapes=[SCENE["shapes"][0], dict(
        shape, material="white", to_world=TW)])


def test_obj_matches(tmp_path):
    p = tmp_path / "m.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nv 0.5 1.5 0.2\n"
                 "vt 0 0\nvt 1 0\nvt 0 1\n"
                 "f 1 2 3\nf 2/1 4/2 5/3 3/1\n")
    desc = _mesh_scene({"type": "obj", "filename": str(p)})
    ours = loader.build_scene(desc, device=CPU)
    assert ours.faces.shape[0] == 12 + 3
    assert_same_scene(ours, jloader.build_scene(desc))


def _ply_body_binary():
    header = (
        b"ply\nformat binary_little_endian 1.0\n"
        b"element vertex 4\n"
        b"property float x\nproperty float y\nproperty float z\n"
        b"property float u\nproperty float v\n"
        b"element face 1\nproperty list uchar int vertex_indices\n"
        b"end_header\n")
    body = b"".join(struct.pack("<fffff", *v, 0.1, 0.2) for v in
                    [(0, 0, 0), (1, 0, 0), (1, 1, 0.3), (0, 1, 0)])
    return header + body + struct.pack("<Biiii", 4, 0, 1, 2, 3)


@pytest.mark.parametrize("fmt", ["ascii", "binary"])
def test_ply_matches(tmp_path, fmt):
    p = tmp_path / "m.ply"
    if fmt == "ascii":
        p.write_text(
            "ply\nformat ascii 1.0\ncomment a quad\nelement vertex 4\n"
            "property float x\nproperty float y\nproperty float z\n"
            "element face 1\nproperty list uchar int vertex_indices\n"
            "end_header\n0 0 0\n1 0 0\n1 1 0.3\n0 1 0\n4 0 1 2 3\n")
    else:
        p.write_bytes(_ply_body_binary())
    desc = _mesh_scene({"type": "ply", "filename": str(p)})
    ours = loader.build_scene(desc, device=CPU)
    assert ours.faces.shape[0] == 12 + 2
    assert_same_scene(ours, jloader.build_scene(desc))


def test_serialized_matches(tmp_path):
    rng = np.random.default_rng(3)
    p = tmp_path / "m.serialized"
    meshes = [(rng.normal(size=(5, 3)).astype(np.float32),
               np.array([[0, 1, 2], [2, 3, 4]], np.int32)),
              (rng.normal(size=(4, 3)).astype(np.float32),
               np.array([[0, 1, 2], [0, 2, 3], [1, 2, 3]], np.int32))]
    jmesh.save_serialized(p, meshes)
    desc = _mesh_scene({"type": "serialized", "filename": str(p),
                        "shape_index": 1})
    ours = loader.build_scene(desc, device=CPU)
    assert ours.faces.shape[0] == 12 + 3
    assert_same_scene(ours, jloader.build_scene(desc))


def test_shapes_and_null_boundary_match():
    """Every shape kind the port builds, a null boundary around them."""
    desc = dict(SCENE, shapes=[
        {"type": "cube", "material": "glass"},
        {"type": "rectangle", "material": "white", "to_world": TW},
        {"type": "cube", "material": "white", "to_world": TW},
        {"type": "sphere", "center": [0.1, 0, 0], "radius": 0.3,
         "n_theta": 3, "n_phi": 5, "to_world": TW},
        {"type": "disk", "material": "white", "n_phi": 7, "to_world": TW},
        {"type": "cylinder", "material": "white", "p0": [0, -0.5, 0],
         "p1": [0.2, 0.5, 0.1], "radius": 0.2, "n_phi": 6},
        {"type": "trimesh", "material": "white",
         "vertices": [0, 0, 0, 1, 0, 0, 0, 1, 0], "faces": [0, 1, 2],
         "to_world": TW},
    ])
    ours = loader.build_scene(desc, device=CPU)
    assert_same_scene(ours, jloader.build_scene(desc))
    # the sphere takes the "default" material, appended after the named
    assert ours.materials.kind.tolist() == [0, 1, 0]
    assert not bool(ours.opaque_faces()[:12].any())


@pytest.mark.parametrize("phase", ["hg", "isotropic", "rayleigh"])
def test_grid_medium_from_npy_matches(tmp_path, phase):
    rng = np.random.default_rng(4)
    dens = rng.random((5, 6, 7)).astype(np.float32)
    np.save(tmp_path / "d.npy", dens)
    desc = dict(SCENE, medium={
        "type": "grid", "density_npy": str(tmp_path / "d.npy"),
        "sigma_t": [1.0, 1.05, 1.1], "albedo": [0.9, 0.8, 0.7], "g": 0.3,
        "box_min": [-1, -0.9, -0.8], "box_max": [1, 0.9, 1.1], "scale": 2.0,
        "phase": phase})
    ours = loader.build_scene(desc, device=CPU)
    assert torch.equal(ours.medium.density, torch.as_tensor(dens))
    assert_same_scene(ours, jloader.build_scene(desc))


def test_config4_preset_as_grid_scene(tmp_path):
    """cornell_grid_smoke written out as a trimesh + .npy scene loads
    as the JAX preset, its grid bit for bit."""
    ref = jpresets.cornell_grid_smoke(width=16, height=12, grid_res=6)
    leaves = jax_scene_leaves(ref)
    np.save(tmp_path / "d.npy", leaves["medium.density"])
    desc = {
        "camera": {"origin": [0, 0, -0.99], "target": [0, 0, 1], "fov": 90,
                   "width": 16, "height": 12},
        "materials": [{"name": f"m{i}", "type": "diffuse",
                       "albedo": a.tolist()}
                      for i, a in enumerate(leaves["materials.albedo"])],
        "shapes": [{"type": "trimesh", "material": f"m{m}",
                    "vertices": leaves["vertices"][f].ravel().tolist(),
                    "faces": [0, 1, 2]}
                   for f, m in zip(leaves["faces"], leaves["material"])],
        "emitters": [{"type": "point", "position": p.tolist(),
                      "intensity": i.tolist()}
                     for p, i in zip(leaves["emitters.position"],
                                     leaves["emitters.intensity"])],
        "medium": {"type": "grid", "density_npy": str(tmp_path / "d.npy"),
                   "sigma_t": leaves["medium.sigma_t_color"].tolist(),
                   "albedo": leaves["medium.albedo"].tolist(),
                   "g": float(leaves["medium.g"])},
    }
    ours = loader.build_scene(json.loads(json.dumps(desc)), device=CPU)
    want = convert.scene_from_numpy(leaves, device=CPU)
    assert torch.equal(ours.medium.density, want.medium.density)
    for k in ("sigma_t_color", "albedo", "g", "box_min", "box_max", "scale",
              "max_density"):
        assert torch.equal(getattr(ours.medium, k), getattr(want.medium, k))
    # the faces come apart into one trimesh each: the same triangles
    assert torch.equal(ours.vertices[ours.faces], want.vertices[want.faces])
    assert torch.equal(ours.material, want.material)
    torch.testing.assert_close(ours.camera.to_world, want.camera.to_world,
                               atol=1e-6, rtol=0)


def test_xml_matches(tmp_path):
    p = tmp_path / "scene.xml"
    p.write_text(XML)
    desc = loader.convert_mitsuba_xml(str(p))
    assert desc == jloader.convert_mitsuba_xml(str(p))
    ours = loader.build_scene(desc, device=CPU)
    assert ours.camera.width == 16 and ours.faces.shape[0] == 12
    assert float(ours.medium.g) == np.float32(0.4)
    assert_same_scene(ours, jloader.build_scene(desc))


def test_xml_transform_order(tmp_path):
    """tests/test_loader_extended.py's scale-then-translate rectangle."""
    xml = """<scene version="0.5.0">
      <shape type="rectangle">
        <transform name="toWorld">
          <scale value="2"/><translate x="5"/>
        </transform>
      </shape>
      <sensor type="perspective">
        <lookat origin="0,0,-3" target="0,0,0" up="0,1,0"/>
      </sensor>
      <emitter type="point">
        <point name="position" x="0" y="1" z="0"/>
        <rgb name="intensity" value="1, 2, 3"/>
      </emitter>
    </scene>"""
    p = tmp_path / "t.xml"
    p.write_text(xml)
    desc = loader.convert_mitsuba_xml(p)
    assert desc == jloader.convert_mitsuba_xml(p)
    ours = loader.build_scene(desc, device=CPU)
    v = ours.vertices.numpy()
    assert abs(v[:, 0].min() - 3.0) < 1e-5 and abs(v[:, 0].max() - 7.0) < 1e-5
    assert_same_scene(ours, jloader.build_scene(desc))


def test_xml_gridvolume_matches(tmp_path):
    """A .vol grid (Z, Y, X) through the converter: the density keeps its
    axis order and its box."""
    dens = np.arange(3 * 4 * 5, dtype=np.float32).reshape(3, 4, 5) / 60.0
    jvol.write_vol(tmp_path / "d.vol", dens, box_min=(-1, -1, -2),
                   box_max=(1, 2, 1))
    xml = XML.replace('<medium type="homogeneous" id="med">', """
    <medium type="heterogeneous" id="med">
        <volume name="density" type="gridvolume">
            <string name="filename" value="d.vol"/>
        </volume>
        <rgb name="sigmaT" value="0.4, 0.5, 0.6"/>
        <rgb name="albedo" value="0.9, 0.9, 0.8"/>""").replace(
        """        <rgb name="sigmaS" value="0.5, 0.5, 0.5"/>
        <rgb name="sigmaA" value="0.02, 0.02, 0.02"/>
""", "")
    p = tmp_path / "g.xml"
    p.write_text(xml)
    desc = loader.convert_mitsuba_xml(p)
    assert desc == jloader.convert_mitsuba_xml(p)
    ours = loader.build_scene(desc, device=CPU)
    assert torch.equal(ours.medium.density, torch.as_tensor(dens))
    assert ours.medium.box_max.tolist() == [1.0, 2.0, 1.0]
    assert_same_scene(ours, jloader.build_scene(desc))


def test_xml_converter_dict_matches_on_the_extended_scene(tmp_path):
    """tests/test_loader_extended.py's XML (coating, area light, .vol):
    the same dict, which build_scene builds as the JAX loader does."""
    from tests.test_loader_extended import XML as XML_EXT

    jvol.write_vol(tmp_path / "dens.vol", np.ones((8, 8, 8), np.float32))
    p = tmp_path / "s.xml"
    p.write_text(XML_EXT)
    desc = loader.convert_mitsuba_xml(p)
    assert desc == jloader.convert_mitsuba_xml(p)
    ours = loader.build_scene(desc, device=CPU)
    assert_same_scene(ours, jloader.build_scene(desc))
    assert 12 in ours.materials.kind.tolist()  # COATING


@pytest.mark.parametrize("change, name", [
    # hk, the normal and bump maps and the textures are ported: irawan and
    # an unknown texture kind are refused
    ({"materials": [{"name": "white", "type": "irawan"},
                    {"name": "glass", "type": "null"}]}, "irawan"),
    ({"materials": [{"name": "white", "type": "diffuse",
                     "texture": {"type": "marble"}},
                    {"name": "glass", "type": "null"}]}, "marble"),
    ({"materials": [{"name": "white", "type": "velvet"},
                    {"name": "glass", "type": "null"}]}, "velvet"),
    # the environment emitters are ported: two of them are refused
    ({"emitters": [{"type": "sky", "turbidity": 3.0},
                   {"type": "sunsky"}]}, "sky"),
    ({"emitters": [{"type": "sunsky", "turbidity": 3.0},
                   {"type": "sky"}]}, "sunsky"),
    ({"emitters": [{"type": "envmap", "filename": "x.pfm"},
                   {"type": "sky"}]}, "envmap"),
    ({"camera": dict(SCENE["camera"], type="thinlens")}, "thinlens"),
    ({"shapes": [{"type": "heightfield", "heights": [[0, 1], [1, 0]]}]},
     "heightfield"),
    # per-shape media are ported: a medium id outside the table is refused
    ({"shapes": [{"type": "cube", "interior_medium": 1}]},
     "interior_medium"),
    ({"shapes": [{"type": "cube", "to_world_t1": np.eye(4).tolist()}]},
     "to_world_t1"),
    ({"media": [{"type": "grid", "sigma_a": [0, 0, 0],
                 "sigma_s": [0, 0, 0]}]}, "media"),
    # the mixture phase and the strategies are ported: a mixture in a grid
    # medium and a channel out of range are refused
    ({"medium": {"type": "grid", "density": [[[1.0]]], "phase": {
        "type": "mixture", "components": [{"type": "hg", "g": 0.5}]}}},
     "mixture"),
    ({"medium": {"type": "homogeneous", "strategy": "single",
                 "channel": 3}}, "single"),
])
def test_unsupported_kinds_raise(change, name):
    with pytest.raises(ValueError, match=name):
        loader.build_scene(dict(SCENE, **change), device=CPU)


# the kinds ported with the specular chains (ROADMAP A3, A7): delta
# materials, and every emitter kind but the environment's
NEW_MATERIALS = {
    "mirror": {"type": "mirror", "albedo": [0.9, 0.8, 0.7]},
    "conductor": {"type": "conductor"},
    "dielectric": {"type": "dielectric", "eta": 1.33},
    "thindielectric": {"type": "thindielectric", "eta": 1.5},
}
NEW_EMITTERS = {
    "spot": {"type": "spot", "position": [0.1, 0.8, 0], "intensity": [4, 3,
                                                                     2],
             "direction": [0.1, -1, 0.2], "cutoff": 30.0, "beam": 10.0},
    "directional": {"type": "directional", "direction": [0.2, -1, 0.1],
                    "irradiance": [1, 2, 3]},
    "collimated": {"type": "collimated", "position": [0, 0.5, 0],
                   "direction": [0, -1, 0], "power": [2, 2, 2]},
    "constant": {"type": "constant", "intensity": [0.2, 0.3, 0.4]},
    "area": {"type": "area", "p0": [-0.25, 0.999, -0.25],
             "e1": [0.5, 0, 0], "e2": [0, 0, 0.5], "radiance": [6, 5, 4]},
}


@pytest.mark.parametrize("kind", sorted(NEW_MATERIALS))
def test_delta_material_matches(kind):
    """Each delta material kind on the sphere, with its eta column."""
    desc = dict(SCENE, materials=[SCENE["materials"][0],
                                  dict(NEW_MATERIALS[kind], name="glass")])
    ours = loader.build_scene(desc, device=CPU)
    assert_same_scene(ours, jloader.build_scene(desc))
    assert bool(ours.opaque_faces().all())  # delta surfaces block shadows


@pytest.mark.parametrize("kind", sorted(NEW_EMITTERS))
def test_emitter_kind_matches(kind):
    """Each emitter kind beside the point light: the table's columns
    (directions, cone cosines, triangle edges, the power-weighted pmf)
    bit for bit; an area light also adds its quad and black material."""
    desc = dict(SCENE, emitters=SCENE["emitters"] + [NEW_EMITTERS[kind]])
    ours = loader.build_scene(desc, device=CPU)
    assert_same_scene(ours, jloader.build_scene(desc))
    n_area = 2 if kind == "area" else 0
    assert ours.emitters.kind.shape[0] == 2 + n_area - (kind == "area")
    assert ours.faces.shape[0] == 12 + 64 + n_area


def test_several_area_lights_and_kinds_match():
    """Two area lights (one of a named material) among the other kinds:
    the area entries go last, in quad order."""
    second = dict(NEW_EMITTERS["area"], p0=[0.3, -0.2, 0.999],
                  e1=[0, 0.3, 0], e2=[0.2, 0, 0], material="white")
    desc = dict(SCENE, emitters=[NEW_EMITTERS["area"], *SCENE["emitters"],
                                 NEW_EMITTERS["spot"], second])
    ours = loader.build_scene(desc, device=CPU)
    assert_same_scene(ours, jloader.build_scene(desc))
    assert ours.emitters.host_kinds == (0, 1, 3, 3, 3, 3)
    assert ours.material[-4:].tolist() == [2, 2, 0, 0]


XML_NEW_KINDS = """<scene version="0.5.0">
    <sensor type="perspective">
        <float name="fov" value="70"/>
        <transform name="toWorld">
            <lookat origin="0, 0, -0.99" target="0, 0, 1" up="0, 1, 0"/>
        </transform>
        <film type="hdrfilm">
            <integer name="width" value="8"/>
            <integer name="height" value="8"/>
        </film>
    </sensor>
    <bsdf type="twosided" id="walls"><bsdf type="diffuse">
        <rgb name="reflectance" value="0.7, 0.6, 0.5"/></bsdf></bsdf>
    <bsdf type="dielectric" id="glass">
        <float name="intIOR" value="1.5"/></bsdf>
    <bsdf type="conductor" id="metal">
        <rgb name="specularReflectance" value="0.9, 0.9, 0.9"/></bsdf>
    <shape type="cube"><boolean name="flipNormals" value="true"/>
        <ref id="walls"/></shape>
    <shape type="sphere"><point name="center" x="0" y="0" z="0.3"/>
        <float name="radius" value="0.2"/><ref id="glass"/></shape>
    <shape type="rectangle">
        <transform name="toWorld"><scale value="0.3"/>
            <translate x="0.4" z="0.9"/></transform>
        <ref id="metal"/></shape>
    <shape type="rectangle">
        <transform name="toWorld">
            <matrix value="0.25 0 0 0  0 0 0 0.999  0 0.25 0 0  0 0 0 1"/>
        </transform>
        <emitter type="area"><rgb name="radiance" value="6, 6, 6"/></emitter>
    </shape>
    <emitter type="spot">
        <point name="position" x="0" y="0.8" z="0"/>
        <rgb name="intensity" value="3, 3, 3"/>
        <vector name="direction" x="0" y="-1" z="0.1"/>
    </emitter>
    <emitter type="directional">
        <rgb name="irradiance" value="1, 1, 1"/>
        <vector name="direction" x="0.1" y="-1" z="0"/>
    </emitter>
    <emitter type="collimated">
        <point name="position" x="0" y="0" z="0"/>
        <rgb name="power" value="2, 2, 2"/>
    </emitter>
    <emitter type="constant"><rgb name="radiance" value="0.1, 0.1, 0.1"/>
    </emitter>
    <medium type="homogeneous" id="med">
        <rgb name="sigmaS" value="0.5, 0.5, 0.5"/>
        <rgb name="sigmaA" value="0.02, 0.02, 0.02"/>
    </medium>
    </scene>"""


def test_xml_new_kinds_match(tmp_path):
    """A Mitsuba XML of a dielectric, a conductor, a rectangle area light
    and the spot, directional, collimated and constant emitters: the
    converter's dict is the JAX package's and builds as its scene."""
    p = tmp_path / "n.xml"
    p.write_text(XML_NEW_KINDS)
    desc = loader.convert_mitsuba_xml(p)
    assert desc == jloader.convert_mitsuba_xml(p)
    ours = loader.build_scene(desc, device=CPU)
    assert_same_scene(ours, jloader.build_scene(desc))
    assert ours.emitters.host_kinds == (1, 2, 6, 4, 3, 3)
    assert sorted(set(ours.materials.kind.tolist())) == [0, 2, 3]




@pytest.mark.parametrize("kind", sorted(SMOOTH_KINDS))
def test_smooth_material_matches(kind):
    """Each smooth kind through both JSON loaders, with its fields and
    the defaults of the fields it leaves out: every material column, the
    rough coat's transmittance table included."""
    name = SMOOTH_KINDS[kind]
    desc = dict(SCENE, materials=SMOOTH_MATERIALS, shapes=[
        dict(SCENE["shapes"][0], material=name), SCENE["shapes"][1]])
    ours = loader.build_scene(json.loads(json.dumps(desc)), device=CPU)
    assert_same_scene(ours, jloader.build_scene(json.loads(json.dumps(
        desc))))
    assert ours.materials.kind[ours.material[0]].item() == {
        "roughconductor": 4, "roughplastic": 5, "phong": 6, "ward": 7,
        "difftrans": 8, "plastic": 9, "mask": 10, "mixture": 11,
        "coating": 12, "roughdielectric": 16, "roughcoating": 17}[kind]
    if kind == "roughcoating":
        i = [m["name"] for m in SMOOTH_MATERIALS].index(name)
        assert float(ours.materials.rt_alpha_max[i]) == np.float32(0.6)
        assert float(ours.materials.rt_table[i].max()) > 0.5


def test_smooth_material_defaults_match():
    """The eleven kinds with no field but their nested names (and the
    coats' eta: at the default eta 1 the JAX package's rough-coat table is
    noise and the port's 1, ROADMAP C15): the JAX loader's defaults
    (alpha 0.1, specular 0.2, exponent 30, opacity 1, GGX)."""
    mats = [{"name": "white", "type": "diffuse"}] + [
        {"name": f"k{i}", "type": t, "nested": "white", "nested2": "white",
         **({"eta": 1.5} if "coating" in t else {})}
        for i, t in enumerate(sorted(SMOOTH_KINDS))]
    desc = dict(SCENE, materials=mats + [{"name": "glass", "type": "null"}])
    ours = loader.build_scene(json.loads(json.dumps(desc)), device=CPU)
    assert_same_scene(ours, jloader.build_scene(json.loads(json.dumps(
        desc))))


XML_SMOOTH = """<scene version="0.5.0">
    <sensor type="perspective">
        <float name="fov" value="70"/>
        <transform name="toWorld">
            <lookat origin="0, 0, -0.99" target="0, 0, 1" up="0, 1, 0"/>
        </transform>
        <film type="hdrfilm">
            <integer name="width" value="8"/>
            <integer name="height" value="8"/>
        </film>
    </sensor>
    <bsdf type="twosided" id="walls"><bsdf type="roughconductor">
        <string name="distribution" value="ggx"/>
        <float name="alphaU" value="0.2"/><float name="alphaV" value="0.4"/>
        <rgb name="specularReflectance" value="0.9, 0.8, 0.7"/></bsdf></bsdf>
    <bsdf type="roughplastic" id="rp"><float name="alpha" value="0.3"/>
        <rgb name="diffuseReflectance" value="0.5, 0.4, 0.3"/></bsdf>
    <bsdf type="phong" id="ph"><float name="exponent" value="40"/>
        <rgb name="specularReflectance" value="0.3, 0.3, 0.3"/></bsdf>
    <bsdf type="ward" id="wd"><float name="alphaU" value="0.1"/>
        <float name="alphaV" value="0.3"/></bsdf>
    <bsdf type="difftrans" id="dt">
        <rgb name="reflectance" value="0.6, 0.6, 0.6"/></bsdf>
    <bsdf type="plastic" id="pl"><float name="intIOR" value="1.5"/></bsdf>
    <bsdf type="mask" id="mk"><float name="opacity" value="0.4"/>
        <ref id="rp"/></bsdf>
    <bsdf type="blendbsdf" id="mx"><float name="weight" value="0.7"/>
        <ref id="ph"/><ref id="wd"/></bsdf>
    <bsdf type="coating" id="co"><float name="intIOR" value="1.4"/>
        <float name="thickness" value="2"/>
        <rgb name="sigmaA" value="0.1, 0.1, 0.2"/>
        <bsdf type="diffuse"><rgb name="reflectance" value="0.7, 0.2, 0.2"/>
        </bsdf></bsdf>
    <bsdf type="roughdielectric" id="rd"><float name="intIOR" value="1.33"/>
        <float name="alpha" value="0.15"/></bsdf>
    <bsdf type="roughcoating" id="rco"><float name="intIOR" value="1.5"/>
        <float name="alpha" value="0.3"/><ref id="dt"/></bsdf>
    <shape type="cube"><boolean name="flipNormals" value="true"/>
        <ref id="walls"/></shape>
    <shape type="sphere"><point name="center" x="0" y="0" z="0.3"/>
        <float name="radius" value="0.2"/><ref id="rco"/></shape>
    <emitter type="point">
        <point name="position" x="0" y="0.8" z="0"/>
        <rgb name="intensity" value="3, 3, 3"/>
    </emitter>
    <medium type="homogeneous" id="med">
        <rgb name="sigmaS" value="0.5, 0.5, 0.5"/>
        <rgb name="sigmaA" value="0.02, 0.02, 0.02"/>
    </medium>
    </scene>"""


def test_xml_smooth_kinds_match(tmp_path):
    """A Mitsuba XML of the eleven kinds (Beckmann where it names no
    distribution, nested BSDFs inline and by reference): the converter's
    dict is the JAX package's and builds as its scene."""
    p = tmp_path / "s.xml"
    p.write_text(XML_SMOOTH)
    desc = loader.convert_mitsuba_xml(p)
    assert desc == jloader.convert_mitsuba_xml(p)
    ours = loader.build_scene(desc, device=CPU)
    assert_same_scene(ours, jloader.build_scene(desc))
    assert sorted(set(ours.materials.kind.tolist())) == [
        0, 4, 5, 6, 7, 8, 9, 10, 11, 12, 16, 17]


@pytest.mark.parametrize("kind", ["irawan"])
def test_unported_materials_are_refused_by_name(kind):
    desc = dict(SCENE, materials=[
        {"name": "white", "type": kind, "nested": "glass"},
        {"name": "glass", "type": "diffuse"}])
    with pytest.raises(ValueError, match=f"{kind}.*ROADMAP A11a"):
        loader.build_scene(desc, device=CPU)


@pytest.mark.parametrize("phase", ["kkay", "microflake"])
def test_oriented_phase_types_are_unknown_to_both_loaders(phase):
    """Neither loader builds an oriented phase function (the JAX package's
    maps hg, isotropic and rayleigh only): both refuse kkay and
    microflake as an unknown type, the port naming it."""
    desc = dict(SCENE, medium=dict(SCENE["medium"], phase=phase))
    with pytest.raises(KeyError):
        jloader.build_scene(json.loads(json.dumps(desc)))
    with pytest.raises(ValueError, match=f"unknown phase type '{phase}'"):
        loader.build_scene(json.loads(json.dumps(desc)), device=CPU)


def test_rough_coat_at_eta_one_transmits_everything():
    """C15: with no interface (eta 1) the rough coat's table is 1, where
    the JAX package's sampler divides by a vanishing half-vector."""
    desc = dict(SCENE, materials=[
        {"name": "white", "type": "diffuse"},
        {"name": "glass", "type": "roughcoating", "nested": "white"}])
    ours = loader.build_scene(json.loads(json.dumps(desc)), device=CPU)
    assert bool((ours.materials.rt_table[1] == 1.0).all())
    assert float(ours.materials.eta[1]) == 1.0


# the environment lights, per-shape media, the mixture phase and the
# strategies (ROADMAP A3, A10)
SKY_EMITTERS = {
    "sky": [{"type": "sky", "sun_direction": [0.3, 0.8, 0.2],
             "turbidity": 4.0, "resolution": 32}],
    "sun": [{"type": "sun", "sun_direction": [0.3, 0.8, 0.2],
             "sun_scale": 0.5}, SCENE["emitters"][0]],
    "sunsky": [{"type": "sunsky", "sun_direction": [-0.2, 0.7, 0.4],
                "resolution": 32, "scale": 0.5}],
}


@pytest.mark.parametrize("name", sorted(SKY_EMITTERS))
def test_sky_emitters_match(name):
    """sky and sunsky bake the Preetham map (sunsky's sun disk in it),
    sun becomes a directional entry: the same table and map as JAX's."""
    desc = dict(SCENE, emitters=SKY_EMITTERS[name])
    ours = loader.build_scene(desc, device=CPU)
    assert_same_scene(ours, jloader.build_scene(desc))
    kinds = set(ours.emitters.host_kinds)
    assert kinds == ({2, 0} if name == "sun" else {5})


@pytest.mark.parametrize("ext", ["pfm", "hdr"])
def test_envmap_file_matches(tmp_path, ext):
    """An envmap from a .pfm and from an .hdr (scale and azimuth), in
    JSON and through the XML converter."""
    from alvrl_tpu.io import hdr as jhdr
    from alvrl_tpu.io import image as jimage

    img = np.random.default_rng(0).gamma(0.5, 1.0, (8, 16, 3)).astype(
        np.float32)
    path = tmp_path / f"sky.{ext}"
    (jimage.write_pfm if ext == "pfm" else jhdr.write_hdr)(str(path), img)
    desc = dict(SCENE, emitters=[{"type": "envmap", "filename": str(path),
                                  "scale": 2.0, "azimuth": 30.0}])
    ours = loader.build_scene(desc, device=CPU)
    assert_same_scene(ours, jloader.build_scene(desc))
    xml = XML.replace('<emitter type="point">', (
        f'<emitter type="envmap"><string name="filename" value="{path}"/>'
        '<float name="scale" value="2"/></emitter>\n    <emitter '
        'type="point">'))
    xp = tmp_path / "s.xml"
    xp.write_text(xml)
    d = loader.convert_mitsuba_xml(xp)
    assert d == jloader.convert_mitsuba_xml(xp)
    assert_same_scene(loader.build_scene(d, device=CPU),
                      jloader.build_scene(d))


def test_sunsky_xml_matches(tmp_path):
    xml = XML.replace('<emitter type="point">', (
        '<emitter type="sunsky"><vector name="sunDirection" x="0.2" y="0.9"'
        ' z="0.1"/><float name="turbidity" value="5"/></emitter>\n    '
        '<emitter type="sun"><vector name="sunDirection" x="0.2" y="0.9"'
        ' z="0.1"/></emitter>\n    <emitter type="point">'))
    xp = tmp_path / "s.xml"
    xp.write_text(xml)
    d = loader.convert_mitsuba_xml(xp)
    assert d == jloader.convert_mitsuba_xml(xp)
    ours = loader.build_scene(d, device=CPU)
    assert_same_scene(ours, jloader.build_scene(d))
    assert set(ours.emitters.host_kinds) == {0, 2, 5}


@pytest.mark.parametrize("medium", [
    {"type": "homogeneous", "sigma_s": [0.6, 0.5, 0.4],
     "sigma_a": [0.05, 0.1, 0.02], "phase": {
         "type": "mixture", "components": [
             {"type": "hg", "g": 0.8, "weight": 0.6},
             {"type": "rayleigh", "weight": 0.3}]}},
    {"type": "homogeneous", "sigma_s": [0.6] * 3, "sigma_a": [0.05] * 3,
     "phase": {"type": "mixture", "components": [
         {"type": "isotropic", "weight": 2.0}, {"type": "hg", "g": -0.3}]},
     "strategy": "maximum"},
    {"type": "homogeneous", "sigma_s": [0.6, 0.2, 0.4],
     "sigma_a": [0.05] * 3, "strategy": "single", "channel": 2},
    {"type": "homogeneous", "sigma_s": [0.6] * 3, "sigma_a": [0.05] * 3,
     "phase": "rayleigh", "strategy": "manual", "density": 0.3},
], ids=["mixture", "mixture_maximum", "single", "manual"])
def test_mixture_and_strategies_match(medium):
    desc = dict(SCENE, medium=medium)
    ours = loader.build_scene(desc, device=CPU)
    assert_same_scene(ours, jloader.build_scene(desc))


def test_nested_media_match():
    """The media table, each shape's interior and exterior ids (the area
    quads' 0), and the area light's faces' emitter ids."""
    desc = dict(SCENE, medium={"type": "homogeneous", "sigma_s": [0.0] * 3,
                               "sigma_a": [0.0] * 3},
                media=[{"sigma_a": [0.0] * 3, "sigma_s": [0.0] * 3},
                       {"sigma_a": [0.1] * 3, "sigma_s": [0.7] * 3,
                        "g": 0.4}])
    desc["shapes"] = [SCENE["shapes"][0], dict(SCENE["shapes"][1],
                                               interior_medium=1)]
    desc["emitters"] = SCENE["emitters"] + [
        {"type": "area", "p0": [-0.2, 0.99, -0.2], "e1": [0.4, 0, 0],
         "e2": [0, 0, 0.4], "radiance": [3, 3, 3]}]
    ours = loader.build_scene(desc, device=CPU)
    assert_same_scene(ours, jloader.build_scene(desc))
    assert int((ours.face_med_int == 1).sum()) == 4 * 8 * 2
    assert ours.face_emitters().tolist()[-2:] == [1, 2]
