"""The JAX-free examples (``examples/torch_*.py``) at a small size on the CPU."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch
import torch.distributed as dist

from differt_tpu_torch.coverage import power_map
from differt_tpu_torch.geometry import Scene
from differt_tpu_torch.scenes import street_canyon_scene

from . import torch_parity  # noqa: F401  (its first calls of the CPU math functions)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_two_ray_model_matches_its_jax_twin() -> None:
    distances = (30.0, 300.0)
    got = load("torch_two_ray_model").main(device="cpu", distances=distances)
    jax_example = load("two_ray_model")
    want = [float(jax_example.power_at(jnp.array([x, 0.0, 1.5]))) for x in distances]
    # Within 0.01 dB, the maps' tolerance: the phase k r reaches 1.5e4 rad at
    # 300 m, where an ulp of a path length is 1e-3 rad, and the two rays
    # nearly cancel there (a relative power error of about 1e-3, 0.006 dB).
    np.testing.assert_allclose(10.0 * np.log10(got["powers"]), 10.0 * np.log10(want), rtol=0, atol=0.01)
    assert got["grad_rx"] < 0.0 and got["grad_eta"] < 0.0


def test_coverage_map_recovers_the_permittivity() -> None:
    got = load("torch_coverage_map").main(device="cpu", grid=6, steps=4)
    assert got["coverage"].shape == (6, 6) and bool(torch.isfinite(got["coverage"]).all())
    assert float(got["coverage"].max()) > 0.0 and float(got["with_diffraction"].mean()) > 0.0
    assert got["losses"] == sorted(got["losses"], reverse=True)  # the loss falls at every step
    assert 2.0 < got["eta_r"] < 5.24


def test_propagation_mechanisms_reach_the_shadowed_receiver() -> None:
    got = load("torch_propagation_mechanisms").main(device="cpu")
    assert got["reflection"] == 0.0  # the box hides every order-1 path
    for mechanism in ("double_diffraction", "scattering", "diffraction", "reflect_diffract"):
        assert np.isfinite(got[mechanism]) and got[mechanism] > 0.0, mechanism
    assert got["diffraction"] > got["double_diffraction"]
    assert 1.0 < got["dipole_gain"] < 1.65  # below the half-wave dipole's peak gain, 1.64


def test_multichip_sharding_on_one_gloo_rank() -> None:
    got = load("torch_multichip_sharding").main(device="cpu", grid=6, steps=2)
    assert not dist.is_initialized()  # the example destroys the group it made
    scene = Scene(
        transmitters=torch.tensor([-30.0, 0.0, 20.0]), mesh=street_canyon_scene(device="cpu").mesh
    ).with_receivers_grid(6, 6, height=1.5)
    assert torch.equal(got["coverage"], power_map(scene, 2.4e9, order=2))  # a mesh of one: mesh=None's bits
    assert got["losses"][1] < got["losses"][0] and got["eta_r"] > 2.0
