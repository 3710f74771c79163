"""The filtered candidate DFS and the OBJ parser on the host, built with ``g++`` at first use and loaded via ctypes.

``_native.cpp`` (a copy of the JAX package's native library) is compiled with ``g++ -O2`` into ``build/native/`` at the repository root,
the file name keyed on a hash of the source, the first time it is needed;
nothing is built when the package is imported. :func:`filtered_path_candidates`
enumerates the loop-free candidates whose first primitive the TX sees, whose
last the RX sees and whose every primitive is active, never visiting a
pruned branch. Without a compiler, :func:`is_available` is False and
:func:`filtered_path_candidates_chunked`, the plain fallback that decodes
and filters the whole space a chunk at a time, gives the same rows (counted
in :data:`FALLBACK_CALLS`). :func:`parse_obj_geometry` reads the geometry
of a Wavefront OBJ file (counted in :data:`OBJ_CALLS`); without a compiler
:func:`differt_tpu_torch.io.load_obj` takes its Python parser instead
(counted in :data:`OBJ_FALLBACK_CALLS`).
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from ..profiling import annotate

_SOURCE = Path(__file__).resolve().parent / "_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LOAD_FAILED = False

CALLS = 0
"""Calls of :func:`filtered_path_candidates` (the DFS) in this process."""
FALLBACK_CALLS = 0
"""Calls of :func:`filtered_path_candidates_chunked` (the plain fallback) in this process."""
OBJ_CALLS = 0
"""Calls of :func:`parse_obj_geometry` (the native OBJ parser) in this process."""
OBJ_FALLBACK_CALLS = 0
"""OBJ files read by the Python parser of :mod:`differt_tpu_torch.io` in this process."""


def library_path() -> Path:
    """Where the library for the current source lives."""
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libdiffert_native_{digest}.so"


def _build() -> Path | None:
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(_SOURCE), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        tmp.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL | None:
    """The library (built if needed), or None when it cannot be built or loaded."""
    global _LIB, _LOAD_FAILED
    with _LOCK:
        if _LIB is not None or _LOAD_FAILED:
            return _LIB
        path = _build()
        try:
            lib = None if path is None else ctypes.CDLL(str(path))
        except OSError:
            lib = None
        if lib is None:
            _LOAD_FAILED = True
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.count_filtered_paths.restype = ctypes.c_int64
        lib.count_filtered_paths.argtypes = [ctypes.c_int, ctypes.c_int, u8p, u8p, u8p]
        lib.fill_filtered_paths.restype = ctypes.c_int64
        lib.fill_filtered_paths.argtypes = [
            ctypes.c_int, ctypes.c_int, u8p, u8p, u8p, i32p, ctypes.c_int64,
        ]
        lib.obj_counts.restype = ctypes.c_int
        lib.obj_counts.argtypes = [ctypes.c_char_p, i64p, i64p]
        lib.obj_parse.restype = ctypes.c_int
        lib.obj_parse.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), i32p, i32p, ctypes.c_int64, ctypes.c_int64,
        ]
        _LIB = lib
    return _LIB


def is_available() -> bool:
    """Whether the native library could be built and loaded."""
    return load() is not None


def _u8(mask) -> tuple[np.ndarray, object] | None:
    """A contiguous uint8 copy of a bool mask (tensor or array) on the host, and its pointer."""
    if mask is None:
        return None
    if isinstance(mask, torch.Tensor):
        mask = mask.detach().cpu().numpy()
    arr = np.ascontiguousarray(mask, dtype=np.uint8)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _device(device):
    return torch.device("cuda") if device is None else device


def filtered_path_candidates(
    num_nodes: int,
    order: int,
    from_adjacency=None,
    to_adjacency=None,
    node_mask=None,
    *,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """``[C, order]`` int64 loop-free candidates kept by the masks, by the host DFS, on ``device`` (the card when None).

    ``from_adjacency`` ``[num_nodes]`` keeps the candidates whose first
    primitive it marks, ``to_adjacency`` those whose last it marks, and
    ``node_mask`` those whose every primitive it marks (bool tensors or
    arrays; None: no filter). The rows come in the order of the exhaustive
    decode. The result crosses to ``device`` once.

    >>> import torch
    >>> filtered_path_candidates(3, 2, torch.tensor([True, False, True]), device="cpu").tolist()
    [[0, 1], [0, 2], [2, 0], [2, 1]]
    """
    global CALLS
    lib = load()
    if lib is None:
        msg = "The native library is unavailable (no g++?)."
        raise RuntimeError(msg)
    CALLS += 1
    keep = [_u8(m) for m in (from_adjacency, to_adjacency, node_mask)]
    with annotate("dfs"):
        ptrs = [None if k is None else k[1] for k in keep]
        count = lib.count_filtered_paths(num_nodes, order, *ptrs)
        out = np.empty((count, max(order, 0)), dtype=np.int32)
        if count and order > 0:
            written = lib.fill_filtered_paths(
                num_nodes, order, *ptrs, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), count
            )
            if written != count:
                msg = f"The DFS wrote {written} of {count} candidates."
                raise RuntimeError(msg)
        return torch.from_numpy(out).to(device=_device(device), dtype=torch.int64)


def filtered_path_candidates_chunked(
    num_nodes: int,
    order: int,
    from_adjacency=None,
    to_adjacency=None,
    node_mask=None,
    *,
    device: torch.device | str | None = None,
    chunk_size: int = 1 << 20,
) -> torch.Tensor:
    """The rows of :func:`filtered_path_candidates`, decoded and filtered a chunk at a time on ``device``.

    The plain fallback when the DFS cannot be built (the reference's):
    it visits the whole ``N (N - 1)^(order - 1)`` space. Counted in
    :data:`FALLBACK_CALLS`.

    >>> import torch
    >>> filtered_path_candidates_chunked(3, 2, torch.tensor([True, False, True]), device="cpu").tolist()
    [[0, 1], [0, 2], [2, 0], [2, 1]]
    """
    from ..geometry._candidates import generate_filtered_path_candidates

    global FALLBACK_CALLS
    FALLBACK_CALLS += 1
    device = _device(device)
    as_mask = lambda m: None if m is None else torch.as_tensor(m, dtype=torch.bool, device=device)  # noqa: E731
    from_adjacency, to_adjacency, node_mask = map(as_mask, (from_adjacency, to_adjacency, node_mask))

    def keep(chunk: torch.Tensor) -> torch.Tensor:
        out = torch.ones(chunk.shape[0], dtype=torch.bool, device=device)
        if from_adjacency is not None:
            out &= from_adjacency[chunk[:, 0]]
        if to_adjacency is not None:
            out &= to_adjacency[chunk[:, -1]]
        if node_mask is not None:
            out &= node_mask[chunk].all(dim=-1)
        return out

    return generate_filtered_path_candidates(
        num_nodes, order, keep, chunk_size=chunk_size, device=device
    )


def parse_obj_geometry(path: str | os.PathLike) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The geometry of a Wavefront OBJ file: ``(vertices, triangles, face_sections)`` numpy arrays.

    ``vertices`` ``[V, 3]`` float32 and ``triangles`` ``[T, 3]`` int32 (faces
    fan-triangulated, negative indices resolved); ``face_sections[i]`` is the
    0-based index of the ``usemtl`` statement active for triangle ``i`` (-1
    before the first). Counted in :data:`OBJ_CALLS`.
    """
    global OBJ_CALLS
    lib = load()
    if lib is None:
        msg = "The native library is unavailable (no g++?)."
        raise RuntimeError(msg)
    OBJ_CALLS += 1
    encoded = os.fspath(path).encode()
    num_vertices, num_triangles = ctypes.c_int64(), ctypes.c_int64()
    if lib.obj_counts(encoded, ctypes.byref(num_vertices), ctypes.byref(num_triangles)):
        msg = f"Failed to read OBJ file: {path!r}"
        raise OSError(msg)
    vertices = np.empty((num_vertices.value, 3), dtype=np.float32)
    triangles = np.empty((num_triangles.value, 3), dtype=np.int32)
    sections = np.empty((num_triangles.value,), dtype=np.int32)
    status = lib.obj_parse(
        encoded,
        vertices.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        triangles.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        sections.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        num_vertices.value,
        num_triangles.value,
    )
    if status:
        msg = f"Failed to parse OBJ file: {path!r} (status {status})"
        raise OSError(msg)
    return vertices, triangles, sections
