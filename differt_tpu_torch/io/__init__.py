"""Scene and mesh files (PyTorch port of ``differt_tpu.io``): OBJ, PLY and Sionna XML in, PLY and Sionna XML out.

The loaders parse on the host and hand the mesh to ``device`` (the card
when None) once. OBJ geometry goes through the native parser of
:mod:`differt_tpu_torch.native` when ``g++`` can build it, else through
the Python parser that is also its oracle. The reference's
``_sionna.py`` and ``__main__`` download scenes and are not ported.
"""

from ._export import export_scene_xml, save_ply
from ._obj import load_obj
from ._ply import load_ply
from ._xml import SionnaMaterial, SionnaScene, SionnaShape, load_scene_xml

__all__ = (
    "SionnaMaterial",
    "SionnaScene",
    "SionnaShape",
    "export_scene_xml",
    "load_obj",
    "load_ply",
    "load_scene_xml",
    "save_ply",
)
