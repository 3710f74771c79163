"""Parity of the port's spherical conversions, Fibonacci lattice and viewing frustum with the JAX package.

Tolerance: ``atol=1e-6`` on unit vectors and angles in float32 (the two
packages' ``sin``, ``cos`` and ``arccos`` may differ by an ulp).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt_tpu.geometry import _lattice as jax_lattice
from differt_tpu.geometry import _vectors as jax_vectors
from differt_tpu_torch.geometry import (
    cartesian_to_spherical,
    fibonacci_lattice,
    spherical_to_cartesian,
    viewing_frustum,
)

ATOL = 1e-6


def _close(ours: torch.Tensor, ref, atol: float = ATOL) -> None:
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=atol, rtol=0)


def test_spherical_round_trip_matches() -> None:
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(1000, 3)).astype(np.float32) * 10.0
    xyz[:3] = 0.0  # r == 0 takes the guard
    ours = cartesian_to_spherical(torch.from_numpy(xyz))
    _close(ours, jax_vectors.cartesian_to_spherical(jnp.asarray(xyz)), atol=1e-5)
    rpa = ours.numpy()
    _close(spherical_to_cartesian(ours), jax_vectors.spherical_to_cartesian(jnp.asarray(rpa)), 1e-5)
    # The 2-column (polar, azimuth) form has r = 1.
    pa = np.ascontiguousarray(rpa[:, 1:])
    _close(spherical_to_cartesian(torch.from_numpy(pa)), jax_vectors.spherical_to_cartesian(pa))


FRUSTUM = np.array([[0.0, 0.3, -2.5], [0.0, 2.0, 1.0]], dtype=np.float32)


@pytest.mark.parametrize("n", [1, 100, 100_000])
@pytest.mark.parametrize("frustum", [None, FRUSTUM, FRUSTUM[:, 1:]], ids=["sphere", "2x3", "2x2"])
def test_fibonacci_lattice_matches(n: int, frustum) -> None:
    ref = jax_lattice.fibonacci_lattice(
        n, frustum=None if frustum is None else jnp.asarray(frustum)
    )
    ours = fibonacci_lattice(
        n, frustum=None if frustum is None else torch.from_numpy(frustum), device="cpu"
    )
    assert ours.shape == (n, 3) and ours.dtype == torch.float32
    _close(ours, ref)


def test_fibonacci_lattice_rejects_bad_input() -> None:
    with pytest.raises(ValueError, match="positive"):
        fibonacci_lattice(0)
    with pytest.raises(ValueError, match="floating"):
        fibonacci_lattice(4, dtype=torch.int32)


def _frustum_case(case: str):
    """(viewer [3], world vertices [V, 3], active mask [V] or None)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    viewer = np.array([1.0, -2.0, 3.0], dtype=np.float32)
    if case == "random":
        world = rng.uniform(-50.0, 50.0, (300, 3))
        return viewer, world.astype(np.float32), None
    if case == "masked":
        world = rng.uniform(-50.0, 50.0, (300, 3))
        return viewer, world.astype(np.float32), rng.random(300) > 0.5
    if case == "wraparound":
        # Everything behind the viewer along -x: azimuths straddle +-pi.
        angle = rng.uniform(math.pi - 0.4, math.pi + 0.4, 200)
        dist = rng.uniform(5.0, 30.0, 200)
        world = np.stack(
            (dist * np.cos(angle), dist * np.sin(angle), rng.uniform(-5.0, 5.0, 200)), -1
        )
        return viewer, (world + viewer).astype(np.float32), None
    if case == "degenerate_polar":
        # All in the viewer's horizontal plane: one polar angle, pi / 2.
        world = rng.uniform(-50.0, 50.0, (100, 3))
        world[:, 2] = viewer[2]
        return viewer, world.astype(np.float32), None
    if case == "surrounding":
        # Geometry all around the viewer: the full circle.
        world = viewer + rng.normal(size=(500, 3)) * 20.0
        return viewer, world.astype(np.float32), None
    raise ValueError(case)


@pytest.mark.parametrize(
    "case", ["random", "masked", "wraparound", "degenerate_polar", "surrounding"]
)
def test_viewing_frustum_matches(case: str) -> None:
    viewer, world, active = _frustum_case(case)
    ref = jax_lattice.viewing_frustum(
        jnp.asarray(viewer),
        jnp.asarray(world),
        active_vertices=None if active is None else jnp.asarray(active),
    )
    ours = viewing_frustum(
        torch.from_numpy(viewer),
        torch.from_numpy(world),
        active_vertices=None if active is None else torch.from_numpy(active),
    )
    assert ours.shape == (2, 3)
    _close(ours, ref, atol=1e-5)  # r reaches ~100 m: 1e-5 is a few ulps there
    if case == "surrounding":
        np.testing.assert_allclose(ours[:, 2].numpy(), [-math.pi, math.pi], atol=1e-6)
    if case == "degenerate_polar":
        assert float(ours[0, 1]) != float(ours[1, 1])


@pytest.mark.parametrize("reduce", [False, True])
def test_viewing_frustum_batched_matches(reduce: bool) -> None:
    rng = np.random.default_rng(7)
    viewers = rng.uniform(-10.0, 10.0, (4, 3)).astype(np.float32)
    world = rng.uniform(-40.0, 40.0, (4, 64, 3)).astype(np.float32)
    active = rng.random((4, 64)) > 0.3
    ref = jax_lattice.viewing_frustum(
        jnp.asarray(viewers), jnp.asarray(world), active_vertices=jnp.asarray(active), reduce=reduce
    )
    ours = viewing_frustum(
        torch.from_numpy(viewers),
        torch.from_numpy(world),
        active_vertices=torch.from_numpy(active),
        reduce=reduce,
    )
    assert tuple(ours.shape) == tuple(ref.shape)
    _close(ours, ref, atol=1e-5)
