"""Carry meshes and scenes across as dicts of numpy arrays.

This repository has no weights: the mesh and its material table are the
state. A dict of numpy arrays (made, for instance, with ``np.asarray`` on
the fields of a JAX ``Scene``) becomes the port's objects on a device, so
both packages can trace the same geometry.

Mesh keys: ``vertices``, ``triangles``, ``face_colors``, ``face_materials``,
``material_names``, ``mask``, ``object_bounds``, ``assume_quads``,
``assume_unique_vertices``; the optional ones may be missing or None. Scene keys: ``transmitters``,
``receivers`` and ``mesh`` (a mesh dict). A placement problem (the inputs
of ``parallel.streamed_placement_step`` beside the scene) has the keys
``tx``, ``eta_r``, ``conductivity``, and optionally ``thickness``,
``target_power`` and ``path_candidates`` (one ``[C, order]`` array, or a
list with one array per order). An antenna or radiation pattern has the
keys ``kind`` (its class name in :mod:`differt_tpu_torch.em`),
``frequency``, ``center`` and ``direction`` (a pattern's axis), or
``moment`` and ``length`` (a dipole's).
"""

import numpy as np
import torch

from . import em
from .geometry import Mesh, Scene


def _tensor(value, dtype: torch.dtype, device) -> torch.Tensor | None:
    if value is None:
        return None
    return torch.as_tensor(np.array(value), device=device).to(dtype)


def mesh_from_numpy(fields: dict, *, device: torch.device | str | None = None) -> Mesh:
    """Build a :class:`Mesh` on ``device`` (the card when None) from a dict of numpy arrays."""
    if device is None:
        device = torch.device("cuda")
    return Mesh(
        vertices=_tensor(fields["vertices"], torch.float32, device),
        triangles=_tensor(fields["triangles"], torch.int64, device),
        face_colors=_tensor(fields.get("face_colors"), torch.float32, device),
        face_materials=_tensor(fields.get("face_materials"), torch.int64, device),
        material_names=tuple(str(n) for n in fields.get("material_names") or ()),
        object_bounds=_tensor(fields.get("object_bounds"), torch.int64, device),
        assume_quads=bool(fields.get("assume_quads", False)),
        assume_unique_vertices=bool(fields.get("assume_unique_vertices", False)),
        mask=_tensor(fields.get("mask"), torch.bool, device),
    )


def scene_from_numpy(fields: dict, *, device: torch.device | str | None = None) -> Scene:
    """Build a :class:`Scene` on ``device`` (the card when None) from a dict of numpy arrays."""
    if device is None:
        device = torch.device("cuda")
    empty = np.empty((0, 3), dtype=np.float32)
    transmitters = fields.get("transmitters")
    receivers = fields.get("receivers")
    return Scene(
        transmitters=_tensor(empty if transmitters is None else transmitters, torch.float32, device),
        receivers=_tensor(empty if receivers is None else receivers, torch.float32, device),
        mesh=mesh_from_numpy(fields["mesh"], device=device),
    )


def mesh_to_numpy(mesh: Mesh) -> dict:
    """The inverse of :func:`mesh_from_numpy`."""
    as_np = lambda x: None if x is None else x.detach().cpu().numpy()  # noqa: E731
    return {
        "vertices": as_np(mesh.vertices),
        "triangles": as_np(mesh.triangles),
        "face_colors": as_np(mesh.face_colors),
        "face_materials": as_np(mesh.face_materials),
        "material_names": mesh.material_names,
        "mask": as_np(mesh.mask),
        "object_bounds": as_np(mesh.object_bounds),
        "assume_quads": mesh.assume_quads,
        "assume_unique_vertices": mesh.assume_unique_vertices,
    }


def scene_to_numpy(scene: Scene) -> dict:
    """The inverse of :func:`scene_from_numpy`."""
    return {
        "transmitters": scene.transmitters.detach().cpu().numpy(),
        "receivers": scene.receivers.detach().cpu().numpy(),
        "mesh": mesh_to_numpy(scene.mesh),
    }


def placement_from_numpy(fields: dict, *, device: torch.device | str | None = None) -> dict:
    """The keyword arguments of a placement step on ``device`` (the card when None).

    Transmitters ``tx [num_tx, 3]``, the per-material tables ``eta_r``,
    ``conductivity`` and ``thickness``, a ``target_power`` map in dB and the
    ``path_candidates`` (an array, or a list with one array per order)
    become float32 (the candidates int64) tensors; keys that are missing
    or None stay out, so the result can be passed on with ``**``.
    """
    if device is None:
        device = torch.device("cuda")
    out = {}
    for key in ("tx", "eta_r", "conductivity", "thickness", "target_power"):
        if fields.get(key) is not None:
            out[key] = _tensor(fields[key], torch.float32, device)
    candidates = fields.get("path_candidates")
    if isinstance(candidates, (list, tuple)):
        out["path_candidates"] = [_tensor(c, torch.int64, device) for c in candidates]
    elif candidates is not None:
        out["path_candidates"] = _tensor(candidates, torch.int64, device)
    return out


_PATTERNS = ("HWDipolePattern", "ShortDipolePattern")
_DIPOLES = ("Dipole", "ShortDipole")


def antenna_from_numpy(fields: dict, *, device: torch.device | str | None = None):
    """Build an antenna or radiation pattern on ``device`` (the card when None) from a dict of numpy arrays.

    ``kind`` names the class: ``HWDipolePattern`` and
    ``ShortDipolePattern`` take ``direction``; ``Dipole`` and
    ``ShortDipole`` take ``moment`` and ``length``, the moment as it is (no
    current or charge rescales it).

    >>> import numpy as np
    >>> pattern = antenna_from_numpy(
    ...     {"kind": "HWDipolePattern", "frequency": 2.4e9, "center": np.zeros(3),
    ...      "direction": np.array([0.0, 0.0, 1.0])}, device="cpu")
    >>> type(pattern).__name__, pattern.direction.tolist()
    ('HWDipolePattern', [0.0, 0.0, 1.0])
    """
    if device is None:
        device = torch.device("cuda")
    kind = fields["kind"]
    frequency = _tensor(fields["frequency"], torch.float32, device)
    center = _tensor(fields.get("center", np.zeros(3)), torch.float32, device)
    if kind in _PATTERNS:
        direction = _tensor(fields["direction"], torch.float32, device)
        return getattr(em, kind)(frequency, direction, center=center)
    if kind in _DIPOLES:
        return getattr(em, kind)(
            frequency,
            length=_tensor(fields["length"], torch.float32, device),
            moment=_tensor(fields["moment"], torch.float32, device),
            current=None,
            center=center,
        )
    msg = f"Unknown antenna kind {kind!r}; expected one of {_PATTERNS + _DIPOLES}."
    raise ValueError(msg)
