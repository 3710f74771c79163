"""Parity of the port's mixed reflection/diffraction amplitudes (``rt/_mixed.py::mixed_amplitudes``) with the JAX package.

The scenes and reference paths are those of ``tests/test_torch_mixed.py``;
both packages get the same paths, so the amplitudes alone are compared:
within ``1e-4`` of the largest, the JAX side op by op (XLA's fusion of the
jitted UTD transition function is 5e-4 off, ``tests/test_torch_utd.py``).
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt_tpu.rt import mixed_amplitudes as jax_mixed_amplitudes
from differt_tpu_torch.geometry import TracedPaths
from differt_tpu_torch.rt import mixed_amplitudes

from .test_torch_mixed import SCENES, SIGNATURES, _edges_info, _np, _reference, _scene
from .torch_parity import to_torch_scene

FREQUENCY = 2.4e9
AMPLITUDE_RTOL = 1e-4
SUBSET = 320  # candidates whose amplitudes are compared


@contextlib.contextmanager
def _op_by_op():
    with jax.disable_jit(), jax.debug_nans(False):
        yield


def _edges_info(mesh):
    mesh = mesh if mesh.assume_unique_vertices else mesh.dedup_vertices()
    return dict(zip(("edges", "adjacent_triangles", "wedge_n"), mesh._diffraction_edges_info()))


@functools.cache
def _jax_edges_info(name: str) -> dict:
    """The reference's edges of a scene (its extraction is eager and slow: once a scene)."""
    return _edges_info(_scene(name).mesh)


def _subset(paths, keep: np.ndarray):
    """The paths of the kept candidates (the last batch axis), in either package."""
    fields = {"vertices": 2, "objects": 1, "mask": 0, "interaction_types": 1}
    sliced = {}
    for name, trailing in fields.items():
        value = getattr(paths, name)
        index = (Ellipsis, keep) + (slice(None),) * trailing
        sliced[name] = value[index] if isinstance(value, torch.Tensor) else jnp.asarray(np.asarray(value)[index])
    return dataclasses.replace(paths, **sliced)


@pytest.mark.parametrize(
    ("name", "signature"), [(name, s) for name in SCENES for s in ("RD", "DR", "DD")] + [("corridor", "R")]
)
def test_mixed_amplitudes_match(name: str, signature: str) -> None:
    """The same paths in both packages: the amplitudes alone are compared,
    on the candidates valid for some receiver and others."""
    ref_scene = _scene(name)
    scene = to_torch_scene(ref_scene)
    ref_paths, ref_mask = _reference(name, signature)
    ref_paths = dataclasses.replace(ref_paths, mask=jnp.asarray(ref_mask))
    # The valid candidates, then others evenly spread, repeated to SUBSET:
    # one shape for every case, so that the reference's operations compile once.
    valid = np.flatnonzero(ref_mask.any(axis=(0, 1)))
    others = np.flatnonzero(~ref_mask.any(axis=(0, 1)))
    assert valid.size <= SUBSET
    keep = np.resize(np.concatenate((valid, others[:: max(others.size // SUBSET, 1)])), SUBSET)
    ref_paths = _subset(ref_paths, keep)
    paths = TracedPaths(
        *(torch.from_numpy(np.array(x)) for x in (ref_paths.vertices, ref_paths.objects)),
        mask=torch.from_numpy(np.array(ref_paths.mask)),
        interaction_types=torch.from_numpy(np.array(ref_paths.interaction_types)),
    )
    num_materials = max(len(ref_scene.mesh.material_names), 1)
    materials = {
        "eta_r": np.linspace(3.0, 6.0, num_materials, dtype=np.float32),
        "conductivity": np.linspace(0.01, 0.2, num_materials, dtype=np.float32),
        "thickness": np.full(num_materials, 0.2, np.float32),
    }
    a = mixed_amplitudes(paths, scene, FREQUENCY, **_edges_info(scene.mesh), **{k: torch.from_numpy(v) for k, v in materials.items()})
    with _op_by_op():
        ref = _np(
            jax_mixed_amplitudes(
                ref_paths, ref_scene, FREQUENCY, **_jax_edges_info(name), **{k: jnp.asarray(v) for k, v in materials.items()}
            )
        )
    assert a.dtype == torch.complex64 and a.shape == paths.shape
    mask = _np(paths.mask)
    assert (_np(a)[~mask] == 0).all()
    if mask.any():
        assert np.abs(_np(a) - ref).max() <= AMPLITUDE_RTOL * np.abs(ref).max()
        assert (_np(a)[mask] != 0).all()
    # The signature read from the paths, or given.
    given = mixed_amplitudes(
        paths, scene, FREQUENCY, **_edges_info(scene.mesh), types=SIGNATURES[signature],
        **{k: torch.from_numpy(v) for k, v in materials.items()},
    )
    assert torch.equal(given, a)
