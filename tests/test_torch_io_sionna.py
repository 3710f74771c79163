"""The port's Sionna scene cache and CLI (``differt_tpu_torch.io._sionna``, ``io.__main__``) against the JAX package's.

Every test builds its cache under ``tmp_path`` and points
``DIFFERT_TPU_CACHE_DIR`` there; the download reads a ``.tar.gz`` built in
the test through a stand-in for ``urllib.request.urlopen``, and any socket
connection raises, so no test reaches the network.
"""

import io as _io
import socket
import tarfile
import urllib.request
from pathlib import Path

import pytest

from differt_tpu.geometry import Scene as JaxScene
from differt_tpu.io import _sionna as jax_sionna
from differt_tpu.io.__main__ import main as jax_main
from differt_tpu_torch import io
from differt_tpu_torch.geometry import Scene
from differt_tpu_torch.io import _sionna
from differt_tpu_torch.io.__main__ import main

from .test_io import SCENE_XML
from .test_torch_io import assert_same_mesh

# The layout of NVlabs/sionna-rt's tarball: the scenes' root, then one folder a scene.
TARBALL_ROOT = "sionna-rt-main/src/sionna/rt/scenes"
BUILDING_OBJ = "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n"
GROUND_OBJ = "v 0 0 0\nv 2 0 0\nv 0 2 0\nv 2 2 0\nf 1 2 4 3\n"


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    def refuse(*args, **kwargs):
        msg = "a test of the Sionna cache tried to open a connection"
        raise AssertionError(msg)

    monkeypatch.setattr(socket.socket, "connect", refuse)
    monkeypatch.setattr(socket, "create_connection", refuse)


def scene_files() -> dict[str, str]:
    """A cache's files, relative to the scenes' root: ``<name>/<name>.xml`` (the
    fixture XML of ``tests/test_io.py`` and its meshes), ``<name>/scene.xml``,
    and a scene found only by the glob (its XML under another name, one level down)."""
    return {
        "city/city.xml": SCENE_XML,
        "city/meshes/building.obj": BUILDING_OBJ,
        "city/meshes/ground.obj": GROUND_OBJ,
        "box/scene.xml": "<scene version='2.1.0'></scene>",
        "extra/hidden/other.xml": "<scene version='2.1.0'></scene>",
        "notes/readme.txt": "not a scene",
    }


def fill(folder: Path, files: dict[str, str]) -> Path:
    for name, text in files.items():
        path = folder / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return folder


def tarball(files: dict[str, str]) -> bytes:
    buffer = _io.BytesIO()
    with tarfile.open(fileobj=buffer, mode="w:gz") as tar:
        for name, text in files.items():
            data = text.encode()
            info = tarfile.TarInfo(f"{TARBALL_ROOT}/{name}")
            info.size = len(data)
            tar.addfile(info, _io.BytesIO(data))
    return buffer.getvalue()


class Server:
    """A stand-in for ``urllib.request.urlopen`` that serves one payload and records each URL."""

    def __init__(self, payload: bytes) -> None:
        self.payload = payload
        self.urls: list[str] = []

    def __call__(self, url, *args, **kwargs):
        self.urls.append(url)
        return _io.BytesIO(self.payload)  # a context manager with read()


@pytest.fixture
def cache(tmp_path, monkeypatch) -> Path:
    """A filled cache in the tarball's layout under ``DIFFERT_TPU_CACHE_DIR``."""
    monkeypatch.setenv("DIFFERT_TPU_CACHE_DIR", str(tmp_path / "cache"))
    return fill(tmp_path / "cache" / "sionna" / TARBALL_ROOT, scene_files())


def test_cache_dir_matches_jax(tmp_path, monkeypatch) -> None:
    monkeypatch.setenv("DIFFERT_TPU_CACHE_DIR", str(tmp_path))
    assert _sionna.sionna_cache_dir() == jax_sionna.sionna_cache_dir() == tmp_path / "sionna"
    monkeypatch.delenv("DIFFERT_TPU_CACHE_DIR")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    want = tmp_path / "home" / ".cache" / "differt_tpu" / "sionna"
    assert _sionna.sionna_cache_dir() == jax_sionna.sionna_cache_dir() == want


def test_list_and_get_match_jax(cache) -> None:
    assert _sionna.list_sionna_scenes() == jax_sionna.list_sionna_scenes() == ["box", "city"]
    assert io.list_sionna_scenes(cache) == jax_sionna.list_sionna_scenes(cache) == ["box", "city"]
    for name, file in (("city", "city/city.xml"), ("box", "box/scene.xml"), ("hidden", "extra/hidden/other.xml")):
        got = _sionna.get_sionna_scene(name)
        assert got == jax_sionna.get_sionna_scene(name) == str(cache / file)
        assert io.get_sionna_scene(name, folder=cache.parent) == jax_sionna.get_sionna_scene(name, folder=cache.parent)


def test_a_folder_without_the_tarball_layout_is_its_own_root(tmp_path) -> None:
    fill(tmp_path, {"demo/demo.xml": "<scene/>"})
    assert _sionna.list_sionna_scenes(tmp_path) == jax_sionna.list_sionna_scenes(tmp_path) == ["demo"]
    assert _sionna.get_sionna_scene("demo", folder=tmp_path) == str(tmp_path / "demo" / "demo.xml")


def test_missing_scene_raises_the_same_error(cache) -> None:
    with pytest.raises(ValueError, match="Cannot find scene 'munich'") as got:
        _sionna.get_sionna_scene("munich")
    with pytest.raises(ValueError) as want:
        jax_sionna.get_sionna_scene("munich")
    assert str(got.value) == str(want.value)
    assert str(cache) in str(got.value)


def test_download_extracts_skips_and_fetches_again(tmp_path, monkeypatch) -> None:
    files = scene_files()
    server = Server(tarball(files))
    monkeypatch.setattr(urllib.request, "urlopen", server)
    monkeypatch.setenv("DIFFERT_TPU_CACHE_DIR", str(tmp_path / "cache"))

    folder = _sionna.download_sionna_scenes("v1.0")
    want_folder = jax_sionna.download_sionna_scenes("v1.0", folder=tmp_path / "jax")
    assert folder == tmp_path / "cache" / "sionna"
    assert server.urls == [jax_sionna.SIONNA_SCENES_URL.replace("main", "v1.0")] * 2
    assert _sionna.SIONNA_SCENES_URL == jax_sionna.SIONNA_SCENES_URL
    extracted = sorted(p.relative_to(folder) for p in folder.rglob("*") if p.is_file())
    assert extracted == sorted(p.relative_to(want_folder) for p in want_folder.rglob("*") if p.is_file())
    assert extracted == sorted(Path(TARBALL_ROOT) / name for name in files)
    assert _sionna.list_sionna_scenes() == ["box", "city"]

    # A filled cache: no request, in both packages.
    assert _sionna.download_sionna_scenes() == folder
    assert jax_sionna.download_sionna_scenes(folder=want_folder) == want_folder
    assert len(server.urls) == 2

    # cached=False fetches again, over the files already there.
    (folder / TARBALL_ROOT / "box" / "scene.xml").write_text("edited")
    assert _sionna.download_sionna_scenes(cached=False) == folder
    assert server.urls[-1] == jax_sionna.SIONNA_SCENES_URL and len(server.urls) == 3
    assert (folder / TARBALL_ROOT / "box" / "scene.xml").read_text() == files["box/scene.xml"]


def run_cli(entry, argv, capsys) -> str:
    assert entry(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize(
    "argv",
    [["list"], ["path", "city"], ["path", "hidden"], ["download"], ["download", "--no-cache", "--branch", "v1.0"]],
    ids=["list", "path", "path-glob", "download-cached", "download-no-cache"],
)
@pytest.mark.parametrize("where", ["env", "folder"])
def test_cli_prints_what_the_jax_cli_prints(cache, monkeypatch, capsys, argv, where) -> None:
    server = Server(tarball(scene_files()))
    monkeypatch.setattr(urllib.request, "urlopen", server)
    if where == "folder":  # the same cache, named on the command line alone
        argv = [*argv, "--folder", str(_sionna.sionna_cache_dir())]
        monkeypatch.delenv("DIFFERT_TPU_CACHE_DIR")
        monkeypatch.setenv("HOME", str(cache.parents[6] / "home"))
    got = run_cli(main, argv, capsys)
    want = run_cli(jax_main, argv, capsys)
    assert got == want and got.strip()
    if argv[0] == "list":
        assert got.splitlines() == ["box", "city"]
    assert len(server.urls) == (2 if "--no-cache" in argv else 0)


def test_cli_refuses_an_unknown_command(capsys) -> None:
    with pytest.raises(SystemExit):
        main(["fetch"])
    assert "invalid choice" in capsys.readouterr().err


def test_scene_loads_by_name_as_in_jax(cache) -> None:
    got = Scene.load_xml(io.get_sionna_scene("city"), device="cpu")
    want = JaxScene.load_xml(jax_sionna.get_sionna_scene("city"))
    assert_same_mesh(got.mesh, want.mesh)
    assert got.mesh.num_triangles == 3 and got.mesh.num_objects == 2
