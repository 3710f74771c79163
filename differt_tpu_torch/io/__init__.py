"""Scene and mesh files (PyTorch port of ``differt_tpu.io``): OBJ, PLY and Sionna XML in, PLY and Sionna XML out.

The loaders parse on the host and hand the mesh to ``device`` (the card
when None) once. OBJ geometry goes through the native parser of
:mod:`differt_tpu_torch.native` when ``g++`` can build it, else through
the Python parser that is also its oracle. Sionna's example scenes come
from the cache that both packages share (``_sionna.py``; the CLI is
``python -m differt_tpu_torch.io``): ``Scene.load_xml(get_sionna_scene(name))``.
"""

from ._export import export_scene_xml, save_ply
from ._obj import load_obj
from ._ply import load_ply
from ._sionna import download_sionna_scenes, get_sionna_scene, list_sionna_scenes, sionna_cache_dir
from ._xml import SionnaMaterial, SionnaScene, SionnaShape, load_scene_xml

__all__ = (
    "SionnaMaterial",
    "SionnaScene",
    "SionnaShape",
    "download_sionna_scenes",
    "export_scene_xml",
    "get_sionna_scene",
    "list_sionna_scenes",
    "load_obj",
    "load_ply",
    "load_scene_xml",
    "save_ply",
    "sionna_cache_dir",
)
