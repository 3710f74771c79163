"""Parity of the port's diffuse scattering (``rt/_scattering.py``, ``power_map(with_scattering=True)``) with the JAX package.

Scenes cross over through ``interop``: the ground plane of
``tests/test_scattering.py``, the knife edge and ``urban_scene(2, 2)`` with
two receivers. Tolerances: sample points and weights, amplitudes
(Lambertian and directive) and ``directive_pattern_normalization`` within
``rtol=1e-5``; masks, objects and interaction types equal; maps with
scattering (``S`` per material) within ``rtol=1e-4``, coherent and
incoherent, and their TX gradients within ``rtol=1e-3`` of ``jax.grad``.
"""

import dataclasses
import doctest
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt_tpu import coverage as jax_coverage
from differt_tpu.geometry import Mesh as JaxMesh
from differt_tpu.geometry import Scene as JaxScene
from differt_tpu.rt import directive_pattern_normalization as jax_normalization
from differt_tpu.rt import scattering_amplitudes as jax_scattering_amplitudes
from differt_tpu.rt import triangle_sample_points as jax_sample_points
from differt_tpu_torch import coverage
from differt_tpu_torch.em import InteractionType
from differt_tpu_torch.rt import (
    ScatteringPathTracer,
    directive_pattern_normalization,
    scattering_amplitudes,
    triangle_sample_points,
)

from .test_torch_mixed import _scene as _mixed_scene
from .torch_parity import to_torch_scene

FREQUENCY = 2.4e9
RTOL = 1e-5
MAP_RTOL = 1e-4
GRAD_RTOL = 1e-3


def _ground() -> JaxScene:
    mesh = JaxMesh.plane(jnp.array([0.0, 0.0, 0.0]), normal=jnp.array([0.0, 0.0, 1.0]), side_length=20.0)
    return JaxScene(
        transmitters=jnp.array([[-3.0, 0.0, 2.0]]),
        receivers=jnp.array([[3.0, 0.0, 2.0], [1.0, 4.0, 0.5]]),
        mesh=mesh.set_materials("Concrete"),
    )


SCENES = ("ground", "knife", "urban")


@functools.cache
def _scene(name: str) -> JaxScene:
    return _ground() if name == "ground" else _mixed_scene(name)


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _materials(ref_scene) -> dict:
    """Dielectric materials and a scattering coefficient, one entry per material."""
    num_materials = max(len(ref_scene.mesh.material_names), 1)
    return {
        "eta_r": np.linspace(4.0, 6.0, num_materials, dtype=np.float32),
        "conductivity": np.linspace(0.05, 0.2, num_materials, dtype=np.float32),
        "scattering_coefficient": np.linspace(0.2, 0.5, num_materials, dtype=np.float32),
    }


@pytest.mark.parametrize("num_samples", [1, 4, 7])
def test_sample_points_match(num_samples: int) -> None:
    tv = np.random.default_rng(0).uniform(-10.0, 10.0, (50, 3, 3)).astype(np.float32)
    points, weights = triangle_sample_points(torch.from_numpy(tv), num_samples)
    ref_points, ref_weights = jax_sample_points(jnp.asarray(tv), num_samples)
    assert tuple(points.shape) == ref_points.shape == (50, num_samples, 3)
    np.testing.assert_allclose(_np(points), _np(ref_points), rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(_np(weights), _np(ref_weights), rtol=RTOL)
    np.testing.assert_allclose(_np(weights).sum(-1), _np(ref_weights).sum(-1), rtol=RTOL)


@pytest.mark.parametrize("num_samples", [1, 4])
@pytest.mark.parametrize("name", SCENES)
def test_trace_scattering_paths_match(name: str, num_samples: int) -> None:
    ref_scene = _scene(name)
    scene = to_torch_scene(ref_scene)
    ref = ref_scene.trace_scattering_paths(num_samples=num_samples)
    paths = scene.trace_scattering_paths(num_samples=num_samples)
    assert paths.shape == ref.mask.shape
    np.testing.assert_array_equal(_np(paths.mask), _np(ref.mask))
    np.testing.assert_array_equal(_np(paths.objects), _np(ref.objects))
    np.testing.assert_array_equal(_np(paths.interaction_types), _np(ref.interaction_types))
    assert (_np(paths.interaction_types) == int(InteractionType.SCATTERING)).all()
    np.testing.assert_allclose(_np(paths.vertices), _np(ref.vertices), rtol=RTOL, atol=1e-5)
    assert paths.mask.any() and (name == "ground" or not paths.mask.all())


def test_tracer_masks_inactive_triangles_and_rejects_quads() -> None:
    ref_scene = _scene("knife")
    scene = to_torch_scene(ref_scene)
    mask = np.arange(scene.mesh.num_triangles) % 3 != 0
    masked = dataclasses.replace(scene, mesh=scene.mesh.set_mask(torch.from_numpy(mask)))
    ref = dataclasses.replace(ref_scene, mesh=ref_scene.mesh.set_mask(jnp.asarray(mask))).trace_scattering_paths()
    np.testing.assert_array_equal(_np(masked.trace_scattering_paths().mask), _np(ref.mask))
    with pytest.raises(ValueError, match="triangle mesh"):
        ScatteringPathTracer().trace_paths(dataclasses.replace(scene, mesh=scene.mesh.set_assume_quads()))


@pytest.mark.parametrize("alpha_r", [1, 2, 5, 10])
def test_directive_pattern_normalization_matches(alpha_r: int) -> None:
    cos_theta_i = np.linspace(0.0, 1.0, 101, dtype=np.float32)
    got = directive_pattern_normalization(alpha_r, torch.from_numpy(cos_theta_i))
    ref = jax_normalization(alpha_r, jnp.asarray(cos_theta_i))
    np.testing.assert_allclose(_np(got), _np(ref), rtol=RTOL)


@pytest.mark.parametrize(("alpha_r", "num_samples"), [(None, 1), (4, 4), (1, 1)], ids=["lambertian", "directive-4", "directive-1"])
@pytest.mark.parametrize("name", SCENES)
def test_scattering_amplitudes_match(name: str, alpha_r, num_samples: int) -> None:
    ref_scene = _scene(name)
    scene = to_torch_scene(ref_scene)
    ref_paths = ref_scene.trace_scattering_paths(num_samples=num_samples)
    # The same paths in both packages (an ulp of a city-scale vertex is
    # 4e-4 rad of phase at 2.4 GHz): the amplitudes alone are compared.
    paths = dataclasses.replace(
        scene.trace_scattering_paths(num_samples=num_samples), vertices=torch.from_numpy(np.array(ref_paths.vertices))
    )
    materials = _materials(ref_scene)
    a = scattering_amplitudes(
        paths, scene, FREQUENCY, alpha_r=alpha_r, num_samples=num_samples, **{k: torch.from_numpy(v) for k, v in materials.items()}
    )
    with jax.disable_jit():
        ref = _np(
            jax_scattering_amplitudes(
                ref_paths, ref_scene, FREQUENCY, alpha_r=alpha_r, num_samples=num_samples,
                **{k: jnp.asarray(v) for k, v in materials.items()},
            )
        )
    assert a.dtype == torch.complex64 and a.shape == paths.shape
    assert np.abs(_np(a) - ref).max() <= RTOL * np.abs(ref).max()
    mask = _np(paths.mask)
    assert (_np(a)[~mask] == 0).all() and (_np(a)[mask] != 0).all()


@pytest.mark.parametrize("coherent", [True, False], ids=["coherent", "incoherent"])
@pytest.mark.parametrize("name", SCENES)
def test_power_map_with_scattering_matches(name: str, coherent: bool) -> None:
    ref_scene = _scene(name)
    scene = to_torch_scene(ref_scene)
    materials = _materials(ref_scene)
    power = coverage.power_map(
        scene, FREQUENCY, order=1, with_scattering=True, coherent=coherent, **{k: torch.from_numpy(v) for k, v in materials.items()}
    )
    ref = jax_coverage.power_map(
        ref_scene, FREQUENCY, order=1, with_scattering=True, coherent=coherent, **{k: jnp.asarray(v) for k, v in materials.items()}
    )
    assert power.shape == ref.shape
    np.testing.assert_allclose(_np(power), _np(ref), rtol=MAP_RTOL)


@pytest.mark.parametrize("scalar", [True, False], ids=["scalar-S", "per-material-S"])
def test_power_map_tx_gradient_matches(scalar: bool) -> None:
    ref_scene = _scene("urban")
    scene = to_torch_scene(ref_scene)
    materials = _materials(ref_scene)
    if scalar:
        materials["scattering_coefficient"] = np.float32(0.4)
    tx = scene.transmitters.clone().requires_grad_()
    power = coverage.power_map(
        dataclasses.replace(scene, transmitters=tx), FREQUENCY, order=1, with_scattering=True,
        **{k: torch.as_tensor(v) for k, v in materials.items()},
    )
    scale = float(power.detach().sum())
    (power.sum() / scale).backward()

    def loss(tx):
        scene = JaxScene(transmitters=tx, receivers=ref_scene.receivers, mesh=ref_scene.mesh)
        power = jax_coverage.power_map(
            scene, FREQUENCY, order=1, with_scattering=True, **{k: jnp.asarray(v) for k, v in materials.items()}
        )
        return jnp.sum(power) / scale

    with jax.debug_nans(False):
        ref = _np(jax.grad(loss)(ref_scene.transmitters))
    grad = _np(tx.grad)
    assert np.isfinite(grad).all() and np.abs(grad).max() > 0
    assert np.linalg.norm(grad - ref) <= GRAD_RTOL * np.linalg.norm(ref)


def test_zero_coefficient_is_the_plain_map() -> None:
    scene = to_torch_scene(_scene("knife"))
    materials = {k: torch.from_numpy(v) for k, v in _materials(_scene("knife")).items() if k != "scattering_coefficient"}
    plain = coverage.power_map(scene, FREQUENCY, order=1, **materials)
    zero = coverage.power_map(scene, FREQUENCY, order=1, with_scattering=True, scattering_coefficient=0.0, **materials)
    torch.testing.assert_close(zero, plain, rtol=1e-6, atol=0.0)


def test_doctests() -> None:
    result = doctest.testmod(importlib.import_module("differt_tpu_torch.rt._scattering"), optionflags=doctest.ELLIPSIS)
    assert result.attempted > 0 and result.failed == 0
