"""Parity of the port's coverage maps (orders 0-2) with the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt_tpu import coverage as jax_coverage
from differt_tpu import scenes as jax_scenes
from differt_tpu.geometry import Scene as JaxScene
from differt_tpu_torch import coverage
from differt_tpu_torch.geometry import TracedPaths

from .torch_parity import assert_maps_close, to_torch_scene

torch.set_num_threads(1)

FREQUENCY = 2.4e9


@pytest.fixture(scope="module")
def canyon() -> JaxScene:
    ref = jax_scenes.street_canyon_scene()
    return JaxScene(
        transmitters=jnp.array([[-30.0, 0.0, 20.0]]), mesh=ref.mesh
    ).with_receivers_grid(16, 16)


@pytest.fixture(scope="module")
def city() -> JaxScene:
    ref = jax_scenes.urban_scene(2, 2)
    return JaxScene(
        transmitters=jnp.array([[0.0, 0.0, 40.0]]), mesh=ref.mesh
    ).with_receivers_grid(8, 6, height=1.5)


@pytest.mark.parametrize("order", [1, 2])
def test_complex_amplitudes_match(canyon, order: int) -> None:
    ours = to_torch_scene(canyon)
    paths = canyon.trace_paths(order=order, megakernel=False)
    as_t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    port_paths = TracedPaths(
        as_t(paths.vertices),
        as_t(paths.objects).to(torch.int64),
        mask=as_t(paths.mask),
        interaction_types=as_t(paths.interaction_types),
    )
    kw = {"eta_r": [5.24, 3.0], "conductivity": [0.05, 0.01]}
    want = np.asarray(
        jax_coverage.complex_amplitudes(
            paths, canyon, FREQUENCY, **{k: jnp.asarray(v) for k, v in kw.items()}
        )
    )
    got = coverage.complex_amplitudes(port_paths, ours, FREQUENCY, **kw).numpy()
    assert got.shape == want.shape and got.dtype == np.complex64
    lit = np.abs(want) > 0
    assert lit.sum() > 10
    np.testing.assert_array_equal(np.abs(got) > 0, lit)
    np.testing.assert_allclose(np.abs(got[lit]), np.abs(want[lit]), rtol=1e-3)
    # Float32 phase near 5,000 rad carries ~5e-4 rad of rounding.
    phase_err = np.angle(got[lit] * np.conj(want[lit]))
    assert np.abs(phase_err).max() <= 2e-3


@pytest.mark.parametrize("order", [0, 1, 2])
def test_power_map_chunked_canyon(canyon, order: int) -> None:
    ours = to_torch_scene(canyon)
    # Small chunks: padded candidate chunks and several Morton-ordered RX tiles.
    kw = {"order": order, "candidate_chunk": 64, "rx_chunk": 100}
    want = jax_coverage.power_map_chunked(canyon, FREQUENCY, **kw)
    got = coverage.power_map_chunked(ours, FREQUENCY, **kw)
    assert tuple(got.shape) == want.shape == (1, 16, 16)
    assert_maps_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("megakernel", [False, True])
def test_power_map_canyon_order1(canyon, megakernel: bool) -> None:
    ours = to_torch_scene(canyon)
    want = jax_coverage.power_map(canyon, FREQUENCY, order=1)
    got = coverage.power_map(ours, FREQUENCY, order=1, megakernel=megakernel)
    assert_maps_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("order", [0, 1, 2])
def test_power_map_chunked_city(city, order: int) -> None:
    ours = to_torch_scene(city)
    kw = {
        "eta_r": [5.24],
        "conductivity": [0.1],
        "candidate_chunk": 2048,
        "rx_chunk": 20,
    }
    candidates = None
    if order == 2:  # The first 6,000 of the 21,170 candidates.
        from differt_tpu.geometry import generate_path_candidates

        candidates = np.asarray(generate_path_candidates(city.mesh.num_primitives, 2, size=6000))
    want = jax_coverage.power_map_chunked(
        city,
        FREQUENCY,
        order=order,
        path_candidates=None if candidates is None else jnp.asarray(candidates),
        **{k: jnp.asarray(v) if isinstance(v, list) else v for k, v in kw.items()},
    )
    got = coverage.power_map_chunked(
        ours,
        FREQUENCY,
        order=order,
        path_candidates=None if candidates is None else torch.from_numpy(np.array(candidates)),
        **kw,
    )
    assert_maps_close(got.numpy(), np.asarray(want))
