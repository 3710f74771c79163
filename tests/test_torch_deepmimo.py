"""Parity of the port's DeepMIMO export (``plugins/deepmimo.py``) with the JAX package.

Both exports take the same paths (traced by the JAX package, carried
across as numpy arrays) on the canyon of ``tests/test_coverage.py``. The
JAX export runs op by op (``jax.disable_jit()``): under ``jit`` XLA fuses
the propagation phase's products into fused multiply-adds, which move a
phase of 2,000 rad by a float32 ulp (2.4e-4 rad), 0.01 degrees, where the
port's phases agree within 1e-4 degrees op by op.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt_tpu.em import Material as JaxMaterial
from differt_tpu.em import MaterialsDict as JaxMaterialsDict
from differt_tpu.geometry import Mesh as JaxMesh
from differt_tpu.geometry import Scene as JaxScene
from differt_tpu.plugins import deepmimo as jax_deepmimo
from differt_tpu_torch import coverage
from differt_tpu_torch.em import Material, MaterialsDict, c, z_0
from differt_tpu_torch.geometry import Mesh, Scene, TracedPaths
from differt_tpu_torch.plugins import deepmimo

from .torch_parity import to_torch_scene

torch.set_num_threads(1)

FREQUENCY = 2.4e9
ANGLES = ("aoa_az", "aoa_el", "aod_az", "aod_el")


@pytest.fixture(scope="module")
def canyon() -> JaxScene:
    mesh = JaxMesh.box(length=60.0, width=20.0, height=15.0, with_top=False)
    scene = JaxScene(transmitters=jnp.array([-20.0, 0.0, 5.0]), mesh=mesh.set_materials("Concrete"))
    return scene.with_receivers_grid(5, 4, height=1.5)


@pytest.fixture(scope="module")
def traced(canyon):
    """Orders 0-2 traced by the JAX package, and the same paths in the port's container."""
    jax_paths = [canyon.trace_paths(order=order) for order in (0, 1, 2)]
    as_t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    port_paths = [
        TracedPaths(
            as_t(p.vertices), as_t(p.objects).to(torch.int64),
            mask=as_t(p.mask), interaction_types=as_t(p.interaction_types),
        )
        for p in jax_paths
    ]
    return jax_paths, port_paths


def jax_export(**kw):
    with jax.disable_jit():
        return jax_deepmimo.export(frequency=jnp.float32(FREQUENCY), **kw)


def assert_matches(got: deepmimo.DeepMIMO, want, *, primitives: bool) -> None:
    """Masks, types and points exactly; power 1e-3 dB, phase 1e-3 degrees on phasors, delay rtol 1e-6, angles 1e-3 degrees."""
    mask = np.asarray(want.mask)
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    np.testing.assert_array_equal(got.inter.numpy(), np.asarray(want.inter))
    np.testing.assert_array_equal(got.inter_pos.numpy(), np.asarray(want.inter_pos))
    np.testing.assert_array_equal(got.tx_pos.numpy(), np.asarray(want.tx_pos))
    np.testing.assert_array_equal(got.rx_pos.numpy(), np.asarray(want.rx_pos))
    if primitives:
        np.testing.assert_array_equal(got.primitives.numpy(), np.asarray(want.primitives))
    else:
        assert got.primitives is None and want.primitives is None
    assert mask.sum() > 100
    np.testing.assert_allclose(got.power.numpy()[mask], np.asarray(want.power)[mask], rtol=0, atol=1e-3)
    turn = np.deg2rad(got.phase.numpy()[mask].astype(np.float64) - np.asarray(want.phase)[mask])
    assert np.rad2deg(np.abs(np.exp(1j * turn) - 1.0)).max() <= 1e-3
    np.testing.assert_allclose(got.delay.numpy()[mask], np.asarray(want.delay)[mask], rtol=1e-6)
    for name in ANGLES:
        np.testing.assert_allclose(
            getattr(got, name).numpy()[mask], np.asarray(getattr(want, name))[mask], rtol=0, atol=1e-3, err_msg=name
        )


def _polarization(value, asarray):
    """A polarization parameter (a name, a vector, or a TX/RX pair of those) as one package takes it."""
    if isinstance(value, str):
        return value
    if isinstance(value[0], (str, tuple)):
        return tuple(_polarization(v, asarray) for v in value)
    return asarray(value)


@pytest.mark.parametrize(
    ("polarization", "include_primitives"),
    [
        ("V", True),
        ("H", False),
        ((0.6, 0.0, 0.8), False),
        (("V", (0.0, 0.6, 0.8)), True),
    ],
)
def test_export_matches_jax(canyon, traced, polarization, include_primitives: bool) -> None:
    jax_paths, port_paths = traced
    pol_jax, pol_port = _polarization(polarization, jnp.asarray), _polarization(polarization, torch.tensor)
    want = jax_export(
        paths=jax_paths, scene=canyon, include_primitives=include_primitives, polarization=pol_jax
    )
    got = deepmimo.export(
        paths=port_paths, scene=to_torch_scene(canyon), frequency=FREQUENCY,
        include_primitives=include_primitives, polarization=pol_port,
    )
    assert (got.num_tx, got.num_rx, got.num_paths) == (want.num_tx, want.num_rx, want.num_paths)
    assert_matches(got, want, primitives=include_primitives)


def test_single_batch_and_slab_materials_match_jax(canyon, traced) -> None:
    """One order as a bare TracedPaths, with a finite slab (the thickness of a custom material)."""
    jax_paths, port_paths = traced
    jax_mats = JaxMaterialsDict([
        JaxMaterial(name="Concrete", properties=lambda f: (jnp.float32(5.24), jnp.float32(0.1)), thickness=0.2)
    ])
    port_mats = MaterialsDict([Material("Concrete", ((5.24, 0.0, 0.1, 0.0, None),), thickness=0.2)])
    want = jax_export(paths=jax_paths[2], scene=canyon, radio_materials=jax_mats)
    got = deepmimo.export(paths=port_paths[2], scene=to_torch_scene(canyon), radio_materials=port_mats, frequency=FREQUENCY)
    assert_matches(got, want, primitives=False)


def test_two_ray() -> None:
    """tests/test_e2e.py's two-ray export: LOS and one ground reflection, the LOS delay and a plausible power."""
    tx = torch.tensor([0.0, 0.0, 10.0])
    rx = torch.tensor([50.0, 0.0, 1.5])
    ground = Mesh.plane(torch.zeros(3), normal=torch.tensor([0.0, 0.0, 1.0]), side_length=2000.0, device="cpu")
    scene = Scene(transmitters=tx, receivers=rx, mesh=ground.set_materials("Concrete"))
    out = deepmimo.export(paths=[scene.trace_paths(order=0), scene.trace_paths(order=1)], scene=scene, frequency=FREQUENCY)
    assert (out.num_tx, out.num_rx, out.num_paths) == (1, 1, 3)  # LOS + 2 triangle candidates.
    valid = out.mask[0, 0].numpy()
    assert valid.sum() == 2
    assert float(out.delay[0, 0, 0]) == pytest.approx(float(torch.linalg.vector_norm(rx - tx)) / c, rel=1e-5)
    assert -120 < float(out.power[0, 0, 0]) < -30


def test_order_1_power_matches_complex_amplitudes(canyon) -> None:
    """tests/test_coverage.py's consistency test: the export and the coverage chain give each path the same power."""
    port = to_torch_scene(canyon)
    paths = port.trace_paths(order=1)
    a = coverage.complex_amplitudes(paths, port, FREQUENCY, eta_r=[5.24], conductivity=[0.1])
    power_cov = (torch.abs(a) ** 2 / z_0).reshape(1, -1, a.shape[-1]).numpy()
    mats = MaterialsDict([Material("Concrete", ((5.24, 0.0, 0.1, 0.0, None),))])
    dm = deepmimo.export(paths=paths.reshape(1, -1, a.shape[-1]), scene=port, radio_materials=mats, frequency=FREQUENCY)
    mask = dm.mask.numpy()
    assert mask.sum() > 20
    np.testing.assert_allclose(power_cov[mask], 10 ** (dm.power.numpy()[mask] / 10.0), rtol=1e-4)
    assert np.isfinite(dm.power.numpy()[mask]).all()


def test_tx_gradient_of_linear_power_matches_jax(canyon) -> None:
    """d(sum of the valid paths' linear power)/d(TX), each package tracing its own paths on concrete walls.

    Orders 0-1, receivers off the walls: the order-2 candidates that bounce
    twice on one plane have a zero amplitude, hence a power of -inf dB,
    whose backward is NaN in both packages.
    """
    x, y = np.meshgrid(np.linspace(-25.0, 25.0, 5), np.linspace(-7.0, 7.0, 4))
    rx = np.stack((x, y, np.full_like(x, 1.5)), axis=-1).astype(np.float32)
    tx0 = np.array([-20.0, 0.5, 5.0], np.float32)

    def jax_power(tx):
        scene = JaxScene(transmitters=tx, receivers=jnp.asarray(rx), mesh=canyon.mesh)
        out = jax_deepmimo.export(
            paths=[scene.trace_paths(order=o) for o in (0, 1)], scene=scene, frequency=jnp.float32(FREQUENCY)
        )
        return jnp.where(out.mask, 10.0 ** (out.power / 10.0), 0.0).sum()

    # The reference's discarded `where` branches compute NaN: no NaN check.
    with jax.debug_nans(False):
        want_value, want = jax.value_and_grad(jax_power)(jnp.asarray(tx0))
    port = to_torch_scene(canyon)
    tx = torch.from_numpy(tx0).requires_grad_()
    scene = dataclasses.replace(port, transmitters=tx, receivers=torch.from_numpy(rx))
    out = deepmimo.export(paths=[scene.trace_paths(order=o) for o in (0, 1)], scene=scene, frequency=FREQUENCY)
    value = torch.where(out.mask, 10.0 ** (out.power / 10.0), 0.0).sum()
    (grad,) = torch.autograd.grad(value, tx)
    np.testing.assert_allclose(value.item(), float(want_value), rtol=1e-5)
    want = np.asarray(want)
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(grad.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_empty_input_gives_zero_paths(canyon) -> None:
    out = deepmimo.export(paths=[], scene=to_torch_scene(canyon), frequency=FREQUENCY, include_primitives=True)
    want = jax_deepmimo.export(paths=[], scene=canyon, frequency=FREQUENCY, include_primitives=True)
    for name, value in want.asdict().items():
        assert tuple(getattr(out, name).shape) == tuple(np.shape(value)), name
    assert out.num_paths == 0 and out.inter.shape[-1] == 0


def test_mesh_without_materials_raises() -> None:
    scene = Scene(transmitters=torch.zeros(3), receivers=torch.ones(3), mesh=Mesh.box(device="cpu"))
    with pytest.raises(ValueError, match="material"):
        deepmimo.export(paths=[], scene=scene, frequency=FREQUENCY)


def test_iter_paths_and_conversions_match_jax(canyon, traced) -> None:
    jax_paths, port_paths = traced
    want = jax_export(paths=jax_paths, scene=canyon)
    got = deepmimo.export(paths=port_paths, scene=to_torch_scene(canyon), frequency=FREQUENCY)
    for a, b in zip(got.iter_paths(), want.iter_paths(), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    as_np = got.numpy()
    assert isinstance(as_np.power, np.ndarray) and as_np.primitives is None
    back = as_np.torch(device="cpu")
    assert torch.equal(back.power, got.power) and torch.equal(back.mask, got.mask)
    assert set(got.asdict()) == set(want.asdict())
    # plot_paths draws what the JAX package draws: one line a valid path, the same points.
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    drawn = [
        [np.asarray(line.get_data_3d()) for line in fig.axes[0].lines]
        for fig in (got.plot_paths(backend="matplotlib"), want.plot_paths(backend="matplotlib"))
    ]
    plt.close("all")
    assert len(drawn[0]) == len(drawn[1]) == int(got.mask.sum()) > 0
    for a, b in zip(*drawn, strict=True):
        np.testing.assert_array_equal(a, b)


def test_sort_by_vertices_matches_by_points_among_equal_types(canyon, traced) -> None:
    """Each path takes the nearest external path of the same interaction types.

    Held against a numpy transcription of the rule, not against the JAX
    package: its ``sum(initial=<array>, where=...)`` drops the array
    ``initial`` that carries the type mismatch (``jax.Array.sum`` ignores a
    non-scalar initial there), so its sort matches points across types.
    """
    _, port_paths = traced
    got = deepmimo.export(paths=port_paths, scene=to_torch_scene(canyon), frequency=FREQUENCY)
    pos, inter = got.inter_pos.numpy(), got.inter.numpy()
    ext_pos, ext_inter = np.flip(pos, 2).copy(), np.flip(inter, 2).copy()
    n = inter.shape[-1]
    dist = np.linalg.norm(pos.reshape(-1, 1, n, 3) - ext_pos.reshape(1, -1, n, 3), axis=3)
    mismatch = ~(inter.reshape(-1, 1, n) == ext_inter.reshape(1, -1, n)).all(-1)
    cost = np.where(inter.reshape(-1, 1, n) != -1, dist, 0.0).sum(2) + np.where(mismatch, np.inf, 0.0)
    want_index = cost.argmin(1)
    assert np.isfinite(cost.min(1)).all()
    sorted_got = got.sort_by_vertices(torch.from_numpy(ext_pos), torch.from_numpy(ext_inter))
    for name in ("power", "mask", "inter", "inter_pos", "delay"):
        value = getattr(got, name).numpy()
        np.testing.assert_array_equal(
            getattr(sorted_got, name).numpy(), value.reshape(-1, *value.shape[3:])[want_index].reshape(value.shape)
        )
    np.testing.assert_array_equal(sorted_got.rx_pos.numpy(), got.rx_pos.numpy())
    # Every path keeps its own interaction types.
    np.testing.assert_array_equal(ext_inter.reshape(-1, n)[want_index], inter.reshape(-1, n))
    with pytest.raises(ValueError, match="shape"):
        got.sort_by_vertices(torch.zeros(3), torch.zeros(1))


def test_multi_order_trace_exports(canyon) -> None:
    """tests/test_solvers.py's multi-order export: one path per candidate of every order."""
    port = to_torch_scene(canyon)
    scene = dataclasses.replace(port, receivers=port.receivers.reshape(-1, 3)[:1])
    out = deepmimo.export(paths=scene.trace_paths(order=[0, 1]), scene=scene, frequency=FREQUENCY)
    assert tuple(out.power.shape) == (1, 1, 1 + scene.mesh.num_primitives)
