"""alvrl_tpu_torch.scripts.render_cli on the CPU: the image it writes is
render_progressive's on the same scene, seed and options; -D, the XML
converter, the PNG preview; what it refuses, with the ROADMAP item."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from alvrl_tpu_torch.integrators import progressive
from alvrl_tpu_torch.integrators.vrl.alvrl import ALVRLParams
from alvrl_tpu_torch.io import image
from alvrl_tpu_torch.scene import loader
from alvrl_tpu_torch.scripts import render_cli
from tests.torch_port_utils import CPU

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENE = {
    "camera": {"type": "perspective", "origin": [0, 0, -0.99],
               "target": [0, 0, 1], "fov": "$fov", "width": 10, "height": 8},
    "medium": {"type": "homogeneous", "sigma_s": [0.6] * 3,
               "sigma_a": [0.05] * 3, "g": 0.3},
    "materials": [{"name": "white", "type": "diffuse",
                   "albedo": [0.7, 0.7, 0.7]},
                  {"name": "glass", "type": "null"}],
    "shapes": [{"type": "cube", "material": "white", "flip_normals": True},
               {"type": "sphere", "material": "glass", "center": [0, 0, 0.3],
                "radius": 0.2, "n_theta": 4, "n_phi": 8}],
    "emitters": [{"type": "point", "position": [0, 0.8, 0],
                  "intensity": [5, 5, 5]}],
}
XML = """<scene version="0.5.0">
    <sensor type="perspective">
        <float name="fov" value="80"/>
        <transform name="toWorld">
            <lookat origin="0, 0, -0.9" target="0, 0, 1" up="0, 1, 0"/>
        </transform>
        <film type="hdrfilm">
            <integer name="width" value="8"/>
            <integer name="height" value="8"/>
        </film>
    </sensor>
    <bsdf type="diffuse" id="walls">
        <rgb name="reflectance" value="0.7, 0.6, 0.5"/>
    </bsdf>
    <shape type="cube">
        <transform name="toWorld"><scale value="1"/></transform>
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
OPTS = ["-p", "2", "--seed", "3", "--particles", "12", "--vrls", "40",
        "-L", "WARNING"]


def _reference(scene, integrator="vrl"):
    return progressive.render_progressive(
        scene, 3, progressive.ProgressiveConfig(
            max_passes=2, clustered=integrator == "alvrl"),
        ALVRLParams(vrl_target_num=40, num_particles=12))


@pytest.fixture
def scene_json(tmp_path):
    p = tmp_path / "s.json"
    p.write_text(json.dumps(SCENE).replace('"$fov"', "$fov"))
    return p


@pytest.mark.parametrize("integrator", ["vrl", "alvrl"])
def test_json_scene_writes_render_progressive(tmp_path, scene_json,
                                              integrator):
    out, png = tmp_path / "o.pfm", tmp_path / "o.png"
    assert render_cli.main([str(scene_json), "--cpu", "-i", integrator,
                            "-D", "fov=70", "-o", str(out), "--png",
                            str(png), *OPTS]) == 0
    desc = json.loads(json.dumps(SCENE).replace('"$fov"', "70"))
    ref = _reference(loader.load_json(desc, device=CPU), integrator)
    got = image.read_pfm(out)
    assert got.shape == (8, 10, 3) and np.isfinite(got).all()
    assert got.mean() > 0 and np.array_equal(got, ref)
    image.write_png(tmp_path / "ref.png", ref)
    assert png.read_bytes() == (tmp_path / "ref.png").read_bytes()


def test_defines_change_the_scene(tmp_path, scene_json):
    imgs = []
    for fov in ("50", "90"):
        out = tmp_path / f"o{fov}.npy"
        render_cli.main([str(scene_json), "--cpu", "-D", f"fov={fov}", "-o",
                         str(out), *OPTS])
        imgs.append(image.read_npy(out))
    assert imgs[0].shape == imgs[1].shape == (8, 10, 3)
    assert not np.array_equal(imgs[0], imgs[1])


def test_xml_scene_writes_render_progressive(tmp_path):
    p = tmp_path / "s.xml"
    p.write_text(XML)
    out = tmp_path / "o.pfm"
    assert render_cli.main([str(p), "--cpu", "-o", str(out), *OPTS]) == 0
    ref = _reference(loader.build_scene(loader.convert_mitsuba_xml(str(p)),
                                        device=CPU))
    assert np.array_equal(image.read_pfm(out), ref)


@pytest.mark.parametrize("args, item", [
    (["-i", "bdpt"], "A11"), (["-i", "pssmlt"], "A11"),
    (["-o", "x.exr"], "A11"), (["-o", "x.jpg"], "A11")])
def test_refusals_name_the_roadmap_item(scene_json, args, item):
    """An integrator or an output format that the port does not take
    exits naming its ROADMAP item."""
    with pytest.raises(SystemExit) as e:
        render_cli.main([str(scene_json), "--cpu", "-D", "fov=70", *args])
    assert f"ROADMAP {item}" in str(e.value.code)


@pytest.mark.parametrize("option", ["--depth", "--spp", "--field"])
def test_no_option_of_the_other_integrators(scene_json, option):
    """The JAX CLI's --depth, --spp and --field set its path tracers and
    its field integrator, never -i vrl|alvrl: the port's -i vrl (the
    default) refuses --depth and --spp, which set -i volpath|path|direct
    only, and it has no --field (no field integrator)."""
    with pytest.raises(SystemExit) as e:
        render_cli.main([str(scene_json), "--cpu", option, "5"])
    assert e.value.code == 2  # argparse's usage error


def test_without_cpu_and_without_cuda_it_fails(scene_json, monkeypatch,
                                               tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        render_cli.main([str(scene_json), "-D", "fov=70", "-o",
                         str(tmp_path / "o.pfm")])
    assert "no CUDA device" in str(e.value.code)
    assert not (tmp_path / "o.pfm").exists()


def test_runs_as_a_module(tmp_path, scene_json):
    out = tmp_path / "o.pfm"
    run = subprocess.run(
        [sys.executable, "-m", "alvrl_tpu_torch.scripts.render_cli",
         str(scene_json), "--cpu", "-D", "fov=70", "-o", str(out), *OPTS],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "VRL evaluations (render)" in run.stderr
    assert np.isfinite(image.read_pfm(out)).all()


@pytest.mark.parametrize("integrator", ["vrl", "alvrl"])
def test_glass_mirror_and_area_light_scene_renders(tmp_path, integrator):
    """A scene of a dielectric sphere, a conductor wall and an area light
    beside the point light renders through both integrators as
    render_progressive does."""
    desc = json.loads(json.dumps(SCENE).replace('"$fov"', "70"))
    desc["materials"] = [desc["materials"][0],
                         {"name": "glass", "type": "dielectric", "eta": 1.5},
                         {"name": "metal", "type": "conductor"}]
    desc["shapes"].append({"type": "rectangle", "material": "metal",
                           "to_world": [[0.3, 0, 0, 0.5], [0, 0.3, 0, 0],
                                        [0, 0, 0.3, 0.95], [0, 0, 0, 1]]})
    desc["emitters"].append({"type": "area", "p0": [-0.25, 0.999, -0.25],
                             "e1": [0.5, 0, 0], "e2": [0, 0, 0.5],
                             "radiance": [6, 6, 6]})
    p, out = tmp_path / "g.json", tmp_path / "g.pfm"
    p.write_text(json.dumps(desc))
    assert render_cli.main([str(p), "--cpu", "-i", integrator, "-o",
                            str(out), *OPTS]) == 0
    got = image.read_pfm(out)
    assert np.isfinite(got).all() and got.mean() > 0
    ref = _reference(loader.load_json(desc, device=CPU), integrator)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("integ", ["volpath", "path", "direct"])
def test_path_tracers_write_the_in_process_render(scene_json, tmp_path,
                                                  integ):
    """-i volpath|path|direct with --spp (and --depth for path): the image
    bit for bit render_path_tracer's on the same scene and seed."""
    out = tmp_path / "o.npy"
    args = [str(scene_json), "--cpu", "-D", "fov=70", "-i", integ, "--spp",
            "2", "--seed", "3", "-o", str(out)]
    if integ == "path":
        args += ["--depth", "4"]
    assert render_cli.main(args) == 0
    scene = loader.load_json(str(scene_json), {"fov": "70"}, device=CPU)
    ref = render_cli.render_path_tracer(scene, integ, 3, 2, 4)
    img = np.load(out)
    assert np.array_equal(img, ref)
    assert np.isfinite(img).all() and float(np.abs(img).max()) > 0.0
