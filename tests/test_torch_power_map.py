"""Parity of the port's whole ``power_map`` signature (``mixed_signatures``, with diffraction and scattering) with the JAX package.

The knife edge and the corridor of ``tests/test_torch_mixed.py``, two
receivers each, dielectric walls. Tolerances:

- maps with mixed signatures within 0.01 dB, as the diffraction maps of
  ``tests/test_torch_diffraction.py``: each package's Fermat points lie
  within the float32 resolution of the optimum (millimetres), and the UTD
  coefficients turn a millimetre into 1e-4 to 1e-3 of a path's power (on
  the same points the amplitudes agree to 1e-8,
  ``tests/test_torch_mixed_amplitudes.py``);
- TX gradients of the total power within ``rtol=1e-3`` of ``jax.grad``,
  on dielectric walls (ROADMAP C: the ITU metal's slab branch sends NaN to
  the TX in both packages).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt_tpu import coverage as jax_coverage
from differt_tpu.geometry import Scene as JaxScene
from differt_tpu_torch import coverage

from .test_torch_mixed import D, R, _np, _scene
from .torch_parity import assert_maps_close, to_torch_scene

FREQUENCY = 2.4e9
MAP_TOL_DB = 0.01
GRAD_RTOL = 1e-3
MIXED = [(R, D), (D, R)]


def _materials(ref_scene) -> dict:
    """Dielectric walls, one entry per material; ``S`` per material too."""
    num_materials = max(len(ref_scene.mesh.material_names), 1)
    return {
        "eta_r": np.linspace(4.0, 6.0, num_materials, dtype=np.float32),
        "conductivity": np.linspace(0.05, 0.2, num_materials, dtype=np.float32),
    }


@pytest.mark.parametrize("coherent", [True, False], ids=["coherent", "incoherent"])
@pytest.mark.parametrize("name", ["knife", "corridor"])
def test_power_map_with_mixed_signatures_matches(name: str, coherent: bool) -> None:
    ref_scene = _scene(name)
    scene = to_torch_scene(ref_scene)
    materials = _materials(ref_scene)
    power = coverage.power_map(
        scene, FREQUENCY, order=1, mixed_signatures=MIXED, coherent=coherent,
        **{k: torch.from_numpy(v) for k, v in materials.items()},
    )
    ref = jax_coverage.power_map(
        ref_scene, FREQUENCY, order=1, mixed_signatures=MIXED, coherent=coherent,
        **{k: jnp.asarray(v) for k, v in materials.items()},
    )
    assert power.shape == ref.shape
    assert_maps_close(_np(power), _np(ref), tol_db=MAP_TOL_DB)
    specular = coverage.power_map(scene, FREQUENCY, order=1, coherent=coherent, **{k: torch.from_numpy(v) for k, v in materials.items()})
    assert not torch.equal(power, specular)


def test_power_map_tx_gradient_matches() -> None:
    """The TX gradient of the knife edge's whole map: specular, diffraction, both mixed chains and scattering."""
    ref_scene = _scene("knife")
    scene = to_torch_scene(ref_scene)
    materials = _materials(ref_scene)
    options = {"with_diffraction": True, "mixed_signatures": MIXED, "with_scattering": True}
    s_coeff = np.full(len(materials["eta_r"]), 0.3, np.float32)
    tx = scene.transmitters.clone().requires_grad_()
    power = coverage.power_map(
        dataclasses.replace(scene, transmitters=tx), FREQUENCY, order=1, scattering_coefficient=torch.from_numpy(s_coeff),
        **options, **{k: torch.from_numpy(v) for k, v in materials.items()},
    )
    scale = float(power.detach().sum())
    (power.sum() / scale).backward()

    def loss(tx):
        scene = JaxScene(transmitters=tx, receivers=ref_scene.receivers, mesh=ref_scene.mesh)
        power = jax_coverage.power_map(
            scene, FREQUENCY, order=1, scattering_coefficient=jnp.asarray(s_coeff),
            **options, **{k: jnp.asarray(v) for k, v in materials.items()},
        )
        return jnp.sum(power) / scale

    with jax.debug_nans(False):  # NaN in the reference's discarded branches
        ref = _np(jax.grad(loss)(ref_scene.transmitters))
    grad = _np(tx.grad)
    assert np.isfinite(grad).all() and np.abs(grad).max() > 0
    assert np.linalg.norm(grad - ref) <= GRAD_RTOL * np.linalg.norm(ref)
