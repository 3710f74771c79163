"""Shared helpers for the parity tests of the PyTorch port against the JAX package.

Both packages get the same inputs: a JAX scene crosses over as a dict of
numpy arrays (``differt_tpu_torch.interop``), and random inputs come from
``numpy.random.default_rng``.
"""

import itertools

import numpy as np
import pytest
import torch

from differt_tpu_torch.interop import antenna_from_numpy, placement_from_numpy, scene_from_numpy

F32_EPS = float(np.finfo(np.float32).eps)


def _warm_cpu_math() -> None:
    """Run each float32 transcendental the port uses once, over many threads.

    PyTorch's CPU builds can compute one intra-op thread's share of the
    first multi-threaded call of ``sin``, ``cos``, ``tan``, ``exp``,
    ``sqrt`` or ``arccos`` in a process less accurately (seen: ``sin`` 1.5e-4
    off on 25,000 of 200,001 elements, in 2 to 4 of 10 fresh processes;
    never with one thread, never on a second call). Tests compare at 1e-6,
    so each function takes its first call here, when a test module imports
    this one.
    """
    x = torch.linspace(0.01, 0.99, 1 << 20)
    for fn in (torch.sin, torch.cos, torch.tan, torch.exp, torch.log, torch.sqrt, torch.arccos):
        fn(x)
    torch.atan2(x, x)


_warm_cpu_math()
EPSILON = 10.0 * F32_EPS
HIT_TOL = 100.0 * F32_EPS


def _np(x):
    return None if x is None else np.asarray(x)


def jax_scene_fields(scene) -> dict:
    """The fields of a JAX ``Scene`` as the dict that ``interop`` takes."""
    mesh = scene.mesh
    return {
        "transmitters": _np(scene.transmitters),
        "receivers": _np(scene.receivers),
        "mesh": {
            "vertices": _np(mesh.vertices),
            "triangles": _np(mesh.triangles),
            "face_colors": _np(mesh.face_colors),
            "face_materials": _np(mesh.face_materials),
            "material_names": mesh.material_names,
            "mask": _np(mesh.mask),
            "object_bounds": _np(mesh.object_bounds),
            "assume_quads": mesh.assume_quads,
            "assume_unique_vertices": mesh.assume_unique_vertices,
        },
    }


def to_torch_scene(scene, device: str = "cpu"):
    """Carry a JAX scene across to the port."""
    return scene_from_numpy(jax_scene_fields(scene), device=device)


def jax_antenna_fields(antenna) -> dict:
    """The fields of a JAX antenna or radiation pattern as the dict that ``interop`` takes."""
    fields = {
        "kind": type(antenna).__name__,
        "frequency": _np(antenna.frequency),
        "center": _np(antenna.center),
    }
    if hasattr(antenna, "direction"):
        fields["direction"] = _np(antenna.direction)
    else:
        fields["moment"] = _np(antenna.moment)
        fields["length"] = _np(antenna.length)
    return fields


def to_torch_antenna(antenna, device: str = "cpu"):
    """Carry a JAX antenna or radiation pattern across to the port."""
    return antenna_from_numpy(jax_antenna_fields(antenna), device=device)


def placement_for(module, fields: dict, device: str = "cpu") -> dict:
    """A placement problem's numpy arrays as keyword arguments for one package.

    ``module`` is ``torch`` (through ``interop.placement_from_numpy``) or
    ``jax.numpy``; both get the same arrays, so both compute the same loss.
    """
    if module is torch:
        return placement_from_numpy(fields, device=device)
    out = {}
    for key, value in fields.items():
        if value is None:
            continue
        if isinstance(value, (list, tuple)):
            out[key] = [module.asarray(v) for v in value]
        else:
            out[key] = module.asarray(value)
    return out


def assert_maps_close(port, ref, *, window_db: float = 40.0, tol_db: float = 0.1) -> None:
    """Power maps agree to ``tol_db`` on every pixel within ``window_db`` of the maximum."""
    port = np.asarray(port, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert port.shape == ref.shape
    assert np.isfinite(port).all()
    peak = ref.max()
    assert peak > 0.0
    lit = ref >= peak * 10.0 ** (-window_db / 10.0)
    assert lit.any()
    with np.errstate(divide="ignore"):
        err = np.abs(10.0 * np.log10(port[lit]) - 10.0 * np.log10(ref[lit]))
    assert err.max() <= tol_db, f"max error {err.max():.4f} dB over {lit.sum()} pixels"


def random_segments(bbox: np.ndarray, num: int, seed: int):
    """Segments between uniform points of the (slightly grown) bounding box.

    Returns float32 ``(start, direction)`` and an ``active`` mask holding
    about 80% of the segments.
    """
    rng = np.random.default_rng(seed)
    lo, hi = bbox[0] - 5.0, bbox[1] + 5.0
    lo[2], hi[2] = 0.5, bbox[1][2] + 10.0
    start = rng.uniform(lo, hi, (num, 3)).astype(np.float32)
    end = rng.uniform(lo, hi, (num, 3)).astype(np.float32)
    active = rng.random(num) >= 0.2
    return start, (end - start).astype(np.float32), active


def triangle_mask(num: int, seed: int) -> np.ndarray:
    """A random active-triangle mask holding about 70% of the triangles."""
    return np.random.default_rng(seed).random(num) >= 0.3


def street_chains(order: int, quads: bool = False) -> np.ndarray:
    """The street canyon's chains that alternate between its two street-facing walls.

    Primitive indices: triangles 0, 1 (y = -10) and 16, 17 (y = +10), or
    quads 0 and 8. They reach every receiver in the street at every order.
    """
    walls = ((0,), (8,)) if quads else ((0, 1), (16, 17))
    return np.array(
        [
            row
            for first in (0, 1)
            for row in itertools.product(*(walls[(first + b) % 2] for b in range(order)))
        ],
        dtype=np.int64,
    ).reshape(-1, order)


def canyon_candidates(order: int, quads: bool = False, shard: int = 32) -> np.ndarray:
    """The canyon's street chains, then ``shard`` candidates in groups of 8 strided over the whole range."""
    from differt_tpu_torch.geometry import generate_path_candidates

    num = 13 if quads else 26
    step = num * (num - 1) ** (order - 1) // (shard // 8)
    parts = [street_chains(order, quads)]
    parts += [
        generate_path_candidates(num, order, start=g * step, size=8, device="cpu").numpy()
        for g in range(shard // 8)
    ]
    return np.concatenate(parts)


def cuda_or_skip() -> torch.device:
    """The CUDA device, or skip (decided when the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU host")
    return torch.device("cuda")



def fermat_hessian_eigenvalues(full_paths, object_vectors) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per path: the least and largest eigenvalues of the path length's Hessian over the objects' coordinates in metres, and the length.

    ``full_paths`` ``[*batch, n + 2, 3]`` (TX, the points, RX) and
    ``object_vectors`` ``[*batch, n, d, 3]``; zero vectors (an edge's pad)
    are left out. In float64.
    """
    p = np.asarray(full_paths, np.float64)
    batch = p.shape[:-2]
    n, d = np.shape(object_vectors)[-3:-1]
    v = np.broadcast_to(np.asarray(object_vectors, np.float64), (*batch, n, d, 3))
    # Unit vectors: coordinates in metres along each object (an edge's
    # vector is the whole edge).
    norm = np.linalg.norm(v, axis=-1, keepdims=True)
    v = v / np.where(norm > 0.0, norm, 1.0)
    seg = np.diff(p, axis=-2)
    length = np.sqrt((seg**2).sum(-1) + 1e-12)
    u = seg / length[..., None]
    # The Hessian of each segment's length over its end: (I - u u^T) / l.
    m = (np.eye(3) - u[..., :, None] * u[..., None, :]) / length[..., None, None]
    blocks = np.zeros((*batch, n, n, 3, 3))
    for j in range(n):
        blocks[..., j, j, :, :] = m[..., j, :, :] + m[..., j + 1, :, :]
        if j + 1 < n:
            blocks[..., j, j + 1, :, :] = blocks[..., j + 1, j, :, :] = -m[..., j + 1, :, :]
    hessian = np.einsum("...jkx,...jlxy,...lmy->...jklm", v, blocks, v).reshape(*batch, n * d, n * d)
    live = (np.abs(v).sum(-1) > 0).reshape(*batch, n * d)
    least, largest = np.full(batch, np.inf), np.full(batch, np.inf)
    for idx in np.ndindex(*batch):
        if live[idx].any():
            eig = np.linalg.eigvalsh(hessian[idx][np.ix_(live[idx], live[idx])])
            least[idx], largest[idx] = eig[0], eig[-1]
    return least, largest, length.sum(-1)


def fermat_resolution(full_paths, object_vectors, num_ulps: int) -> np.ndarray:
    """Per path: how far apart two float32 Fermat solvers may stop, in metres.

    The Fermat solver's line search takes a step only if the path's float32
    length falls, so it stops wherever the length is within rounding of its
    minimum: within ``sqrt(2 k ulp(L) / lambda)`` of the optimum, ``lambda``
    the least eigenvalue of :func:`fermat_hessian_eigenvalues` and ``k``
    the ulps of rounding in the computed length. Two solvers that round
    differently stop anywhere within twice that.
    """
    least, _, length = fermat_hessian_eigenvalues(full_paths, object_vectors)
    ulp = np.spacing(length.astype(np.float32)).astype(np.float64)
    return 2.0 * np.sqrt(2.0 * num_ulps * ulp / np.maximum(least, 1e-30))
