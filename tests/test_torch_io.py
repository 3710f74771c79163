"""Parity of the port's scene files (``differt_tpu_torch.io``, ``Mesh.load_*``, ``Scene.load_xml``) with the JAX package.

Each case writes its files (the cases of ``tests/test_io.py``: a cube,
MTL materials, ascii and binary PLY, the Sionna fixture and the XML corpus
of the reference) and loads them with both packages: the arrays must be
equal bit for bit. The native and Python OBJ parsers must agree, and a
folder written by either package's ``export_scene_xml`` must load in the
other.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt_tpu import io as jax_io
from differt_tpu import scenes as jax_scenes
from differt_tpu.geometry import Scene as JaxScene
from differt_tpu_torch import io, native, scenes
from differt_tpu_torch.geometry import Mesh, Scene
from differt_tpu_torch.io import _obj

from .torch_parity import EPSILON, HIT_TOL, to_torch_scene

torch.set_num_threads(1)

FIELDS = ("vertices", "triangles", "face_colors", "face_materials", "object_bounds")


def assert_same_mesh(port: Mesh, ref) -> None:
    """Every array field equal bit for bit (int32 in JAX, int64 here), and the material names."""
    assert port.material_names == tuple(ref.material_names)
    for name in FIELDS:
        got, want = getattr(port, name), getattr(ref, name)
        assert (got is None) == (want is None), name
        if got is not None:
            want = np.asarray(want)
            assert got.shape == want.shape, name
            np.testing.assert_array_equal(got.numpy(), want.astype(got.numpy().dtype), err_msg=name)
            assert got.dtype == (torch.float32 if want.dtype.kind == "f" else torch.int64), name


def load_obj_both_ways(path) -> tuple[Mesh, Mesh]:
    """The port's native and Python parses of one file, each checked to have run."""
    native_calls, python_calls = native.OBJ_CALLS, native.OBJ_FALLBACK_CALLS
    by_native = io.load_obj(path, device="cpu")
    assert native.OBJ_CALLS == native_calls + 1
    by_python = _obj._load_obj_python(path, "cpu")
    assert native.OBJ_FALLBACK_CALLS == python_calls + 1
    return by_native, by_python


CUBE = (
    "\n".join(f"v {x} {y} {z}" for x in (0, 1) for y in (0, 1) for z in (0, 1))
    + "\nf 1 2 4 3\nf 5 7 8 6\nf 1 5 6 2\nf 3 4 8 7\nf 1 3 7 5\nf 2 6 8 4\n"
)
# Materials used out of order and again, v/vt/vn corners, negative
# indices, a pentagon, comments, tabs and an MTL colour left unset.
MATERIALS_OBJ = (
    "# test\nmtllib m.mtl\n"
    "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nv 0.5 1.5 0.25\n"
    "vt 0 0\nvn 0 0 1\n"
    "f 1 2 3\n"
    "usemtl blue\nf 2/1/1 4/1/1 3/1/1\n"
    "usemtl red\nf -1 -2 -3\n"
    "usemtl blue\nf\t1 2 4 5 3\n"
    "usemtl green\nf 1 2 5\n"
)
MTL = "newmtl red\nKd 1 0 0\nnewmtl blue\nKd 0 0 1\nnewmtl green\n"


@pytest.mark.parametrize(
    ("name", "text", "mtl"), [("cube", CUBE, None), ("materials", MATERIALS_OBJ, MTL)], ids=["cube", "materials"]
)
def test_load_obj_matches_jax(tmp_path, name: str, text: str, mtl: str | None) -> None:
    if mtl is not None:
        (tmp_path / "m.mtl").write_text(mtl)
    path = tmp_path / f"{name}.obj"
    path.write_text(text)
    want = jax_io.load_obj(path)
    for got in load_obj_both_ways(path):
        assert_same_mesh(got, want)
    assert_same_mesh(Mesh.load_obj(path, device="cpu"), want)


def test_native_and_python_obj_parsers_agree_on_a_city(tmp_path) -> None:
    """A 146-triangle city written with float32 coordinates, fan polygons and materials."""
    mesh = scenes.urban_scene(2, 2, device="cpu").mesh
    v = mesh.vertices.numpy()
    lines = [f"v {x!r} {y!r} {z!r}" for x, y, z in v.tolist()]
    for i, (a, b, c) in enumerate(mesh.triangles.tolist()):
        if i % 40 == 0:
            lines.append(f"usemtl mat{i // 80}")
        lines.append(f"f {a + 1} {b + 1} {c + 1}")
    lines.append("f -1 -2 -3 -4")  # A quad of the last vertices.
    path = tmp_path / "city.obj"
    path.write_text("\n".join(lines) + "\n")
    by_native, by_python = load_obj_both_ways(path)
    assert_same_mesh(by_native, jax_io.load_obj(path))
    assert_same_mesh(by_python, jax_io.load_obj(path))
    np.testing.assert_array_equal(by_native.vertices.numpy(), v)
    assert by_native.num_triangles == mesh.num_triangles + 2


def test_load_obj_takes_the_python_parser_without_the_native_library(tmp_path, monkeypatch) -> None:
    path = tmp_path / "cube.obj"
    path.write_text(CUBE)
    monkeypatch.setattr(native, "is_available", lambda: False)
    calls, fallback = native.OBJ_CALLS, native.OBJ_FALLBACK_CALLS
    mesh = io.load_obj(path, device="cpu")
    assert (native.OBJ_CALLS, native.OBJ_FALLBACK_CALLS) == (calls, fallback + 1)
    assert_same_mesh(mesh, jax_io.load_obj(path))


PLY_HEADER = (
    "ply\nformat {fmt} 1.0\ncomment made by hand\n"
    "element vertex 5\n"
    "property float x\nproperty float y\nproperty float z\n"
    "property float nx\nproperty uchar red\n"
    "element face 3\n"
    "property list uchar int vertex_indices\n"
    "element edge 1\nproperty int vertex1\nproperty int vertex2\n"
    "end_header\n"
)
PLY_VERTICES = [(0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (1.0, 1.0, 0.5), (0.0, 1.0, 0.25), (0.3, 0.7, 2.0)]
PLY_FACES = [[0, 1, 2], [0, 1, 2, 3], [4, 3, 2, 1, 0]]


def write_ply(path, fmt: str) -> None:
    if fmt == "ascii":
        body = "".join(f"{x} {y} {z} 0.5 7\n" for x, y, z in PLY_VERTICES)
        body += "".join(f"{len(f)} {' '.join(map(str, f))}\n" for f in PLY_FACES) + "0 1\n"
        path.write_text(PLY_HEADER.format(fmt=fmt) + body)
        return
    e = "<" if fmt == "binary_little_endian" else ">"
    body = b"".join(struct.pack(f"{e}4fB", *v, 0.5, 7) for v in PLY_VERTICES)
    body += b"".join(struct.pack(f"{e}B{len(f)}i", len(f), *f) for f in PLY_FACES)
    body += struct.pack(f"{e}2i", 0, 1)
    path.write_bytes(PLY_HEADER.format(fmt=fmt).encode() + body)


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian", "binary_big_endian"])
def test_load_ply_matches_jax(tmp_path, fmt: str) -> None:
    path = tmp_path / "mesh.ply"
    write_ply(path, fmt)
    got = io.load_ply(path, device="cpu")
    assert_same_mesh(got, jax_io.load_ply(path))
    assert got.num_triangles == 1 + 2 + 3
    assert_same_mesh(Mesh.load_ply(path, device="cpu"), jax_io.load_ply(path))


def test_load_ply_refuses_other_files(tmp_path) -> None:
    path = tmp_path / "x.ply"
    path.write_text("solid x\n")
    with pytest.raises(ValueError, match="Not a PLY"):
        io.load_ply(path, device="cpu")


SCENE_XML = """<?xml version="1.0"?>
<scene version="2.1.0">
  <bsdf type="itu-radio-material" id="mat-itu_concrete">
    <string name="type" value="concrete"/>
    <float name="thickness" value="0.1"/>
  </bsdf>
  <bsdf type="twosided" id="mat-custom">
    <bsdf type="diffuse">
      <rgb value="0.2 0.4 0.6" name="reflectance"/>
    </bsdf>
  </bsdf>
  <shape type="obj" id="building">
    <string name="filename" value="meshes/building.obj"/>
    <ref id="mat-itu_concrete" name="bsdf"/>
  </shape>
  <shape type="ply" id="ground">
    <string name="filename" value="meshes/ground.ply"/>
    <ref id="mat-custom" name="bsdf"/>
  </shape>
  <shape type="obj" id="bare">
    <string name="filename" value="meshes/building.obj"/>
  </shape>
  <shape type="stl" id="skipped">
    <string name="filename" value="meshes/none.stl"/>
  </shape>
</scene>
"""


@pytest.fixture
def sionna_dir(tmp_path):
    (tmp_path / "meshes").mkdir()
    (tmp_path / "meshes" / "building.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    write_ply(tmp_path / "meshes" / "ground.ply", "binary_little_endian")
    (tmp_path / "scene.xml").write_text(SCENE_XML)
    return tmp_path


def test_sionna_scene_matches_jax(sionna_dir) -> None:
    with pytest.warns(UserWarning, match="stl"):
        want = jax_io.load_scene_xml(sionna_dir / "scene.xml")
    with pytest.warns(UserWarning, match="stl"):
        got = io.load_scene_xml(sionna_dir / "scene.xml", device="cpu")
    assert_same_mesh(got, want)
    assert got.num_objects == 3 and got.material_names == ("itu_concrete", "custom")
    assert np.asarray(want.face_materials).tolist() == got.face_materials.tolist()
    with pytest.warns(UserWarning, match="stl"):
        scene = Scene.load_xml(sionna_dir / "scene.xml", device="cpu")
    assert_same_mesh(scene.mesh, want)
    assert scene.transmitters.shape == (0, 3) and scene.num_receivers == 0
    parsed, ref = io.SionnaScene.load_xml(sionna_dir / "scene.xml"), jax_io.SionnaScene.load_xml(sionna_dir / "scene.xml")
    assert _as_dicts(parsed) == _as_dicts(ref)


def _as_dicts(scene) -> tuple[dict, dict]:
    fields = lambda x: {k: v for k, v in vars(x).items()}  # noqa: E731
    return (
        {k: fields(v) for k, v in scene.materials.items()},
        {k: fields(v) for k, v in scene.shapes.items()},
    )


def test_empty_scene_loads_an_empty_mesh(tmp_path) -> None:
    (tmp_path / "scene.xml").write_text('<scene version="2.1.0"></scene>')
    mesh = io.load_scene_xml(tmp_path / "scene.xml", device="cpu")
    assert mesh.is_empty and mesh.vertices.shape == (0, 3)


# The reference's XML corpus (tests/test_io.py::TestSionnaXmlReferenceCorpus):
# one bsdf snippet per case, each parsed by both packages.
ITU_TYPES = (
    "marble", "concrete", "wood", "metal", "brick", "glass", "floorboard", "ceiling_board",
    "chipboard", "plasterboard", "plywood", "very_dry_ground", "medium_dry_ground", "wet_ground",
    "vacuum", "clear_acrylic", "vinyl_tile", "carpet_tile", "asphalt_concrete",
)
SNIPPETS = [
    *(
        f'<bsdf type="itu-radio-material" id="id-{t}"><string name="type" value="{t}"/></bsdf>'
        for t in ITU_TYPES
    ),
    '<bsdf type="twosided" id="mat-wall"><bsdf type="diffuse"/></bsdf>',
    '<bsdf type="diffuse" id="default-bsdf"/>',
    '<bsdf type="diffuse" id="mat-concrete"><rgb value="0.539 0.539 0.539"/></bsdf>',
    '<bsdf type="twosided" id="mat-glass"><bsdf type="diffuse"><rgb value="0.168 0.139 0.509"/></bsdf></bsdf>',
    '<bsdf type="itu-radio-material" id="window"><string name="type" value="glass"/>'
    '<float name="thickness" value="0.01"/></bsdf>',
    '<bsdf type="diffuse" id="simple_name"/><bsdf type="diffuse" id="custom-prefix-test"/>'
    '<bsdf type="twosided" id="mat-mat-double"><bsdf type="diffuse"><rgb value="0.5 0.5 0.5"/></bsdf></bsdf>',
    '<bsdf type="twosided" id="mat-itu_glass"><bsdf type="diffuse"><rgb value="0.212230 0.564711 0.799103"/>'
    '</bsdf></bsdf><bsdf type="twosided" id="mat-itu_wood"><bsdf type="diffuse">'
    '<rgb value="0.508881 0.168269 0.059511"/></bsdf></bsdf>',
    '<bsdf type="itu-radio-material" id="no-type"/><bsdf type="diffuse"/><shape type="obj" id="no-file"/>',
]


@pytest.mark.parametrize("snippet", SNIPPETS, ids=[f"case{i}" for i in range(len(SNIPPETS))])
def test_sionna_xml_corpus_matches_jax(tmp_path, snippet: str) -> None:
    path = tmp_path / "scene.xml"
    path.write_text(f'<scene version="2.1.0">{snippet}</scene>')
    got, want = io.SionnaScene.load_xml(path), jax_io.SionnaScene.load_xml(path)
    assert _as_dicts(got) == _as_dicts(want)
    assert got.materials or snippet.startswith('<bsdf type="itu-radio-material" id="no-type"')


def test_unknown_itu_type_warns_and_is_black(tmp_path) -> None:
    path = tmp_path / "scene.xml"
    path.write_text(
        '<scene version="2.1.0"><bsdf type="itu-radio-material" id="unknown">'
        '<string name="type" value="unknown_material_type"/></bsdf></scene>'
    )
    with pytest.warns(UserWarning, match="unknown material type"):
        mat = io.SionnaScene.load_xml(path).materials["unknown"]
    assert (mat.name, mat.color) == ("itu_unknown_material_type", (0.0, 0.0, 0.0))


def test_save_ply_round_trip(tmp_path) -> None:
    mesh = Mesh.box(2.0, 3.0, 4.0, with_top=True, device="cpu")
    io.save_ply(mesh, tmp_path / "box.ply")
    back = io.load_ply(tmp_path / "box.ply", device="cpu")
    assert torch.equal(back.vertices, mesh.vertices) and torch.equal(back.triangles, mesh.triangles)
    assert_same_mesh(back, jax_io.load_ply(tmp_path / "box.ply"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_exported_folders_load_in_both_packages(tmp_path, writer: str) -> None:
    """A city of boxes with two materials (one not an ITU name), written by one package and read by both."""
    ref = jax_scenes.urban_scene(2, 2).mesh
    names = np.where(np.arange(ref.num_triangles) < 72, 0, 1).astype(np.int32)
    jax_mesh = ref.set_materials("itu_brick", "Wood").set_face_materials(jnp.asarray(names))
    port_mesh = to_torch_scene(JaxScene(mesh=jax_mesh)).mesh
    if writer == "jax":
        path = jax_io.export_scene_xml(jax_mesh, tmp_path / "scene")
    else:
        path = io.export_scene_xml(port_mesh, tmp_path / "scene")
    want = jax_io.load_scene_xml(path)
    got = io.load_scene_xml(path, device="cpu")
    assert_same_mesh(got, want)
    assert got.material_names == ("itu_brick", "itu_wood")
    assert got.num_objects == port_mesh.num_objects
    assert torch.equal(got.triangle_vertices, port_mesh.triangle_vertices)
    # Both writers write the same bytes.
    other = tmp_path / "other"
    (io.export_scene_xml(port_mesh, other) if writer == "jax" else jax_io.export_scene_xml(jax_mesh, other))
    assert (other / "scene.xml").read_text() == path.read_text()
    for ply in sorted((tmp_path / "scene" / "meshes").iterdir()):
        assert (other / "meshes" / ply.name).read_bytes() == ply.read_bytes()


def test_street_canyon_round_trip_traces_the_same_paths(tmp_path) -> None:
    """tests/test_io.py's round trip: the loaded canyon traces the same order-1 paths as the generated one."""
    base = jax_scenes.street_canyon_scene(with_ground=True)
    tx, rx = jnp.array([[-30.0, 0.0, 5.0]]), jnp.array([[20.0, 3.0, 1.5], [0.0, -5.0, 1.5]])
    ref = JaxScene(transmitters=tx, receivers=rx, mesh=base.mesh.set_materials("itu_concrete"))
    port = to_torch_scene(ref)
    path = io.export_scene_xml(port.mesh, tmp_path / "canyon")
    loaded = Scene.load_xml(path, device="cpu")
    loaded = Scene(transmitters=port.transmitters, receivers=port.receivers, mesh=loaded.mesh)
    assert loaded.mesh.material_names == ("itu_concrete",) and bool((loaded.mesh.face_materials == 0).all())
    kw = {"epsilon": EPSILON, "hit_tol": HIT_TOL}
    got = loaded.trace_paths(order=1, **kw)
    want = port.trace_paths(order=1, **kw)
    jax_paths = ref.trace_paths(order=1)
    assert got.num_valid_paths == want.num_valid_paths == int(jax_paths.num_valid_paths) > 0
    assert torch.equal(got.mask, want.mask)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(jax_paths.mask))
    torch.testing.assert_close(got.masked_vertices, want.masked_vertices, rtol=0, atol=0)
    np.testing.assert_allclose(got.masked_vertices.numpy(), np.asarray(jax_paths.masked_vertices), atol=1e-5)


@pytest.mark.parametrize(
    "name",
    [
        "differt_tpu_torch.io._obj",
        "differt_tpu_torch.io._ply",
        "differt_tpu_torch.io._xml",
        "differt_tpu_torch.io._export",
        "differt_tpu_torch.io._sionna",
        "differt_tpu_torch.plugins.deepmimo",
        "differt_tpu_torch.geometry._paths",
    ],
)
def test_doctests(name: str) -> None:
    import doctest
    import importlib

    result = doctest.testmod(importlib.import_module(name), optionflags=doctest.ELLIPSIS)
    assert result.attempted > 0
    assert result.failed == 0
