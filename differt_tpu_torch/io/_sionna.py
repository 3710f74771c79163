"""Sionna example scenes: the cache, the download and the name lookup (a port of ``differt_tpu.io._sionna``).

The same cache serves both packages: ``DIFFERT_TPU_CACHE_DIR`` (or
``~/.cache/differt_tpu``) holds ``sionna/``, into which
:func:`download_sionna_scenes` extracts the NVlabs/sionna-rt tarball. Only
that download touches the network, and it returns at once on a filled
cache, so a cache filled by any other means works offline. A scene then
loads with ``Scene.load_xml(get_sionna_scene(name))``.
"""

import os
import tarfile
from pathlib import Path

SIONNA_SCENES_URL = "https://codeload.github.com/NVlabs/sionna-rt/tar.gz/refs/heads/main"


def sionna_cache_dir() -> Path:
    """Directory where Sionna scenes are cached.

    Honors ``DIFFERT_TPU_CACHE_DIR`` when set:

    >>> import os
    >>> old = os.environ.get("DIFFERT_TPU_CACHE_DIR")
    >>> try:
    ...     os.environ["DIFFERT_TPU_CACHE_DIR"] = "/tmp/dtpu-doctest"
    ...     out = sionna_cache_dir().as_posix()
    ... finally:  # never leak the override into later tests
    ...     _ = os.environ.pop("DIFFERT_TPU_CACHE_DIR", None)
    ...     if old is not None:
    ...         os.environ["DIFFERT_TPU_CACHE_DIR"] = old
    >>> out
    '/tmp/dtpu-doctest/sionna'
    >>> sionna_cache_dir().name
    'sionna'
    """
    root = os.environ.get(
        "DIFFERT_TPU_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "differt_tpu"),
    )
    return Path(root) / "sionna"


def download_sionna_scenes(
    branch_or_tag: str = "main",
    *,
    folder: str | os.PathLike[str] | None = None,
    cached: bool = True,
    chunk_size: int = 1024 * 1024,
    progress: bool = True,
    leave: bool = False,
) -> Path:
    """Download and extract the Sionna scenes (requires network access).

    If the target folder exists and holds anything and ``cached`` is true,
    the download is skipped entirely, so a pre-filled cache works offline.
    ``chunk_size``, ``progress`` and ``leave`` are accepted for the
    reference's signature and unused: the tarball is read in one piece.
    """
    folder = Path(folder) if folder is not None else sionna_cache_dir()
    if cached and folder.exists() and any(folder.iterdir()):
        return folder

    import io
    import urllib.request

    folder.mkdir(parents=True, exist_ok=True)
    url = SIONNA_SCENES_URL.replace("main", branch_or_tag)
    with urllib.request.urlopen(url) as resp:  # noqa: S310
        payload = resp.read()
    del chunk_size, progress, leave
    with tarfile.open(fileobj=io.BytesIO(payload), mode="r:gz") as tar:
        tar.extractall(folder, filter="data")  # noqa: S202
    return folder


def _scenes_root(folder: str | os.PathLike[str] | None = None) -> Path:
    folder = Path(folder) if folder is not None else sionna_cache_dir()
    # The tarball extracts to sionna-rt-<ref>/src/sionna/rt/scenes/.
    for candidate in [*folder.glob("**/rt/scenes"), folder]:
        if candidate.is_dir():
            return candidate
    return folder


def list_sionna_scenes(folder: str | os.PathLike[str] | None = None) -> list[str]:
    """The names of the scenes in the cache: each folder that holds ``<name>.xml`` or ``scene.xml``, sorted."""
    root = _scenes_root(folder)
    return sorted(p.parent.name for p in root.glob("*/*.xml") if p.stem in (p.parent.name, "scene"))


def get_sionna_scene(scene_name: str, *, folder: str | os.PathLike[str] | None = None) -> str:
    """The path of a cached scene's XML file.

    ``<name>/<name>.xml`` first, then ``<name>/scene.xml``, then any XML
    file in a folder of that name below the scenes' root.

    Raises:
        ValueError: If the scene cannot be found in the cache.
    """
    root = _scenes_root(folder)
    for candidate in (root / scene_name / f"{scene_name}.xml", root / scene_name / "scene.xml"):
        if candidate.is_file():
            return str(candidate)
    matches = list(root.glob(f"**/{scene_name}/*.xml"))
    if matches:
        return str(matches[0])
    msg = (
        f"Cannot find scene {scene_name!r} in {root}. "
        "Run 'download_sionna_scenes()' first (requires network access) or "
        "point 'DIFFERT_TPU_CACHE_DIR' at a pre-populated cache."
    )
    raise ValueError(msg)
