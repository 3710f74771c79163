"""Parity of the port's EM utilities, Fresnel coefficients, materials and antennas with the JAX package.

Inputs come from ``numpy.random.default_rng``; scenes and antennas cross
over through ``interop``. Tolerances: float32 values ``rtol=1e-5``,
``atol=1e-6`` (directions at normal incidence and at the poles included);
power maps within 0.1 dB (``assert_maps_close``); gradients to the TX and
the permittivity with a pattern ``rtol=1e-4`` of ``jax.grad``.
"""

import dataclasses
import doctest
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differt_tpu.em as jax_em
import differt_tpu.treekit as tk
from differt_tpu import coverage as jax_coverage
from differt_tpu import scenes as jax_scenes
from differt_tpu.geometry import Mesh as JaxMesh
from differt_tpu.geometry import Scene as JaxScene
from differt_tpu_torch import coverage, em
from differt_tpu_torch.geometry import TracedPaths

from .torch_parity import assert_maps_close, to_torch_antenna, to_torch_scene

torch.set_num_threads(1)

FREQUENCY = 2.4e9
RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol: float = RTOL, atol: float = ATOL) -> None:
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _units(rng, num: int) -> np.ndarray:
    """Random unit vectors, then the poles and the axes."""
    v = rng.normal(size=(num, 3))
    v = np.concatenate((v, np.eye(3), -np.eye(3)))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# -- em/_utils ------------------------------------------------------------------


def test_spherical_basis_matches() -> None:
    k = _units(np.random.default_rng(0), 200)
    got = em.spherical_basis(_t(k))
    want = jax_em.spherical_basis(jnp.asarray(k))
    for g, w in zip(got, want):
        _close(g, w)
    # The poles: phi = 0 pinned.
    np.testing.assert_array_equal(got[1][-1].numpy(), [0.0, 1.0, 0.0])


def test_sp_directions_match() -> None:
    rng = np.random.default_rng(1)
    normals = _units(rng, 200)
    k_i = _units(rng, 200)
    k_i[:50] = -normals[:50]  # normal incidence: the plane of incidence is undefined
    k_r = k_i - 2.0 * (k_i * normals).sum(-1, keepdims=True) * normals
    got = em.sp_directions(_t(k_i), _t(k_r), _t(normals))
    # Unjitted: XLA fuses the cross product into multiply-adds whose residue
    # at exact normal incidence is a noise vector, not the zero that selects
    # the fallback.
    with jax.disable_jit():
        want = jax_em.sp_directions(jnp.asarray(k_i), jnp.asarray(k_r), jnp.asarray(normals))
    for got_frame, want_frame in zip(got, want):
        for g, w in zip(got_frame, want_frame):
            assert torch.isfinite(g).all()
            _close(g, w)


def test_sp_rotation_matrix_matches() -> None:
    rng = np.random.default_rng(2)
    vectors = [_units(rng, 64) for _ in range(4)]
    got = em.sp_rotation_matrix(*map(_t, vectors))
    want = jax_em.sp_rotation_matrix(*map(jnp.asarray, vectors))
    assert tuple(got.shape) == (70, 2, 2)
    _close(got, want)


def _random_paths(rng, num: int, order: int):
    """Specular-looking paths: each normal is the bisector of its segments, so that every cosine is positive."""
    vertices = rng.uniform(-50.0, 50.0, (num, order + 2, 3)).astype(np.float32)
    seg = np.diff(vertices, axis=-2)
    k = seg / np.linalg.norm(seg, axis=-1, keepdims=True)
    normals = k[:, 1:] - k[:, :-1]
    normals = (normals / np.linalg.norm(normals, axis=-1, keepdims=True)).astype(np.float32)
    n_r = (rng.uniform(1.5, 3.0, (num, order)) - 1j * rng.uniform(0.0, 0.5, (num, order))).astype(np.complex64)
    thickness = np.where(rng.random((num, order)) < 0.5, -1.0, rng.uniform(0.05, 0.3, (num, order))).astype(np.float32)
    itypes = np.where(rng.random((num, order)) < 0.2, 1, 0).astype(np.int32)
    return vertices, normals, n_r, thickness, itypes


@pytest.mark.parametrize("with_types", [False, True])
@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_transition_matrix_and_apply_match(order: int, with_types: bool) -> None:
    rng = np.random.default_rng(3 + order)
    vertices, normals, n_r, thickness, itypes = _random_paths(rng, 128, order)
    types = itypes if with_types else None
    wavelength = 0.125
    args = (vertices, normals, n_r, thickness)
    got = em.transition_matrix(*map(_t, args), wavelength, None if types is None else _t(types))
    want = jax_em.transition_matrix(*map(jnp.asarray, args), wavelength, types)
    assert got.dtype == torch.complex64 and tuple(got.shape) == (128, 2, 2)
    _close(got, want)
    e_theta = (rng.normal(size=128) + 1j * rng.normal(size=128)).astype(np.complex64)
    e_phi = (rng.normal(size=128) + 1j * rng.normal(size=128)).astype(np.complex64)
    got = em.transition_apply(*map(_t, args), wavelength, _t(e_theta), _t(e_phi),
                              None if types is None else _t(types))
    want = jax_em.transition_apply(*map(jnp.asarray, args), wavelength, e_theta, e_phi, types)
    for g, w in zip(got, want):
        _close(g, w, atol=1e-5)


def test_delays_and_path_loss_match() -> None:
    rng = np.random.default_rng(4)
    paths = rng.uniform(-100.0, 100.0, (64, 4, 3)).astype(np.float32)
    _close(em.path_delay(_t(paths)), jax_em.path_delay(jnp.asarray(paths)), atol=0)
    lengths = rng.uniform(1.0, 1e4, 64).astype(np.float32)
    _close(em.length_to_delay(_t(lengths)), jax_em.length_to_delay(jnp.asarray(lengths)), atol=0)
    freqs = rng.uniform(1e8, 1e11, 64).astype(np.float32)
    for db in (False, True):
        _close(em.fspl(_t(lengths), _t(freqs), dB=db), jax_em.fspl(lengths, freqs, dB=db), atol=0)


@pytest.mark.parametrize("medium", ["lossy", "dense", "total_internal_reflection"])
def test_fresnel_coefficients_match(medium: str) -> None:
    rng = np.random.default_rng(5)
    cos = np.concatenate((rng.uniform(-1.0, 1.0, 200), [0.0, 1.0, -1.0])).astype(np.float32)
    n_r = {
        "lossy": (rng.uniform(1.2, 4.0, 203) - 1j * rng.uniform(0.0, 2.0, 203)).astype(np.complex64),
        "dense": rng.uniform(1.2, 4.0, 203).astype(np.float32),
        "total_internal_reflection": rng.uniform(0.3, 0.9, 203).astype(np.float32),
    }[medium]
    (r, t) = em.fresnel_coefficients(_t(n_r), _t(cos))
    (r_want, t_want) = jax_em.fresnel_coefficients(jnp.asarray(n_r), jnp.asarray(cos))
    for g, w in zip((*r, *t), (*r_want, *t_want)):
        assert g.is_complex()
        _close(g, w)
    for port_fn, jax_fn in (
        (em.reflection_coefficients, jax_em.reflection_coefficients),
        (em.refraction_coefficients, jax_em.refraction_coefficients),
    ):
        for g, w in zip(port_fn(_t(n_r), _t(cos)), jax_fn(jnp.asarray(n_r), jnp.asarray(cos))):
            _close(g, w)
    thickness = np.where(rng.random(203) < 0.5, -1.0, rng.uniform(0.05, 0.3, 203)).astype(np.float32)
    cos_abs = np.abs(cos)
    # The JAX slab takes the root of a real n_r's radicand as it is (NaN
    # below the critical angle); the coverage path hands both a complex one.
    n_c = n_r.astype(np.complex64)
    got = em.slab_reflection_coefficients(_t(n_c), _t(cos_abs), _t(thickness), 0.125)
    want = jax_em.slab_reflection_coefficients(jnp.asarray(n_c), cos_abs, thickness, 0.125)
    for g, w in zip(got, want):
        _close(g, w, atol=1e-5)
    eps = np.abs(n_r) ** 2
    _close(em.refractive_index(_t(eps)), jax_em.refractive_index(jnp.asarray(eps)))
    _close(em.refractive_index(_t(eps), _t(eps)), jax_em.refractive_index(jnp.asarray(eps), jnp.asarray(eps)))


def test_itu_materials_match() -> None:
    assert set(em.materials) == set(jax_em.materials)
    freqs = np.array([1e8, 1e9, 2.4e9, 28e9, 60e9, 150e9, 300e9, 420e9], np.float32)
    for name, want in jax_em.materials.items():
        got = em.materials[name]
        assert got.aliases == want.aliases
        assert em.materials[want.aliases[0]] is got
        _close(got.relative_permittivity(_t(freqs)), want.relative_permittivity(jnp.asarray(freqs)))
        _close(got.conductivity(_t(freqs)), want.conductivity(jnp.asarray(freqs)))
    table = em.MaterialsDict(em.materials)
    assert "itu_wet_ground" in table and table.get("itu_glass").name == "Glass"
    assert table.pop("itu_brick").name == "Brick" and "Brick" not in table
    with pytest.raises(KeyError):
        table["itu_brick"]
    with pytest.raises(ValueError, match="catch-all"):
        em.Material.from_itu_properties("x", (1.0, 0.0, 0.0, 0.0, None), (1.0, 0.0, 0.0, 0.0, (1.0, 2.0)))


# -- Antennas -------------------------------------------------------------------


def _points_around(center: np.ndarray, rng, num: int = 300) -> np.ndarray:
    """Random points 1-20 m from the centre (a phase ``k r`` of at most 1,000 rad at 2.4 GHz)."""
    dist = rng.uniform(1.0, 20.0, (num + 6, 1))
    return (center + dist * _units(rng, num)).astype(np.float32)


@pytest.mark.parametrize("kind", ["HWDipolePattern", "ShortDipolePattern"])
def test_pattern_polarization_vectors_match(kind: str) -> None:
    rng = np.random.default_rng(6)
    center = np.array([3.0, -2.0, 10.0], np.float32)
    direction = _units(rng, 1)[0]
    ref = getattr(jax_em, kind)(
        frequency=jnp.asarray(FREQUENCY), center=jnp.asarray(center), direction=jnp.asarray(direction)
    )
    ours = to_torch_antenna(ref)
    assert isinstance(ours, getattr(em, kind)) and ours.center.device.type == "cpu"
    r = _points_around(center, rng)
    # Off the axis: within a degree of it, cos(pi/2 cos theta) / sin theta
    # is a ratio of two roundings.
    off_axis = np.abs(((r - center) / np.linalg.norm(r - center, axis=-1, keepdims=True)) @ direction) < 0.9998
    r = r[off_axis]
    got = ours.polarization_vectors(_t(r))
    with jax.disable_jit():
        want = ref.polarization_vectors(jnp.asarray(r))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g, w)
    # On the axis (sin theta = 0 exactly): no field in either package.
    axial = getattr(jax_em, kind)(frequency=jnp.asarray(FREQUENCY), direction=jnp.array([0.0, 0.0, 1.0]))
    on_axis = np.array([[0.0, 0.0, 5.0], [0.0, 0.0, -40.0]], np.float32)
    for s_p in (to_torch_antenna(axial).polarization_vectors(_t(on_axis)), axial.polarization_vectors(on_axis)):
        assert float(np.abs(np.asarray(s_p[1])).max()) == 0.0
    for attr in ("period", "angular_frequency", "wavelength", "wavenumber", "aperture"):
        _close(getattr(ours, attr), getattr(ref, attr))


@pytest.mark.parametrize("with_time", [False, True])
@pytest.mark.parametrize("kind", ["Dipole", "ShortDipole"])
def test_dipole_fields_match(kind: str, with_time: bool) -> None:
    rng = np.random.default_rng(7)
    ref = jax_em.Dipole(
        frequency=jnp.asarray(FREQUENCY), moment=jnp.array([0.3, -0.2, 1.0]), center=jnp.array([1.0, 2.0, 3.0])
    )
    if kind == "ShortDipole":
        # The JAX package's ShortDipole takes its fields as they are.
        ref = jax_em.ShortDipole(ref.frequency, ref.length, ref.moment, center=ref.center)
    ours = to_torch_antenna(ref)
    _close(ours.moment, ref.moment)
    _close(ours.length, ref.length)
    r = _points_around(np.array([1.0, 2.0, 3.0], np.float32), rng)
    t = rng.uniform(0.0, 1e-9, r.shape[0]).astype(np.float32) if with_time else None
    got = ours.fields(_t(r), None if t is None else _t(t))
    # Unjitted: the phase k r reaches 1e4 rad, where a fused multiply-add's
    # ulp moves it by 1e-3.
    with jax.disable_jit():
        want = ref.fields(jnp.asarray(r), None if t is None else jnp.asarray(t))
    for g, w in zip(got, want):
        assert g.is_complex()
        scale = float(np.abs(np.asarray(w)).max())
        _close(g, w, atol=1e-5 * scale)
    s = ours.poynting_vector(_t(r))
    with jax.disable_jit():
        s_want = np.asarray(ref.poynting_vector(jnp.asarray(r)))
    _close(s, s_want, atol=1e-5 * np.abs(s_want).max())
    _close(ours.reference_power, ref.reference_power)


def test_dipole_constructors_match() -> None:
    center = jnp.array([0.5, -1.0, 2.0])
    for kw in (
        {},
        {"num_wavelengths": 0.25, "current": 2.0},
        {"length": 0.1, "charge": 1e-9},
        {"moment": jnp.array([1.0, 1.0, 0.0]), "current": None},
        {"look_at": jnp.array([10.0, 5.0, 2.0])},
    ):
        ref = jax_em.Dipole(FREQUENCY, center=center, **kw)
        port_kw = {k: np.asarray(v) if isinstance(v, jax.Array) else v for k, v in kw.items()}
        ours = em.Dipole(FREQUENCY, center=torch.tensor([0.5, -1.0, 2.0]), **port_kw)
        _close(ours.moment, ref.moment, atol=1e-12)
        _close(ours.length, ref.length)


def test_directive_gains_match() -> None:
    dipole = em.Dipole(FREQUENCY, device="cpu")
    assert float(dipole.directive_gain()) == 1.5
    _close(dipole.directivity(20)[-1], jax_em.Dipole(FREQUENCY).directivity(20)[-1])
    dipole_ref = jax_em.Dipole(FREQUENCY)
    short = jax_em.ShortDipole(dipole_ref.frequency, dipole_ref.length, dipole_ref.moment)
    _close(to_torch_antenna(short).directive_gain(50), short.directive_gain(50), rtol=1e-4)
    for kind in ("HWDipolePattern", "ShortDipolePattern"):
        ref = getattr(jax_em, kind)(frequency=FREQUENCY, direction=jnp.array([0.0, 0.0, 1.0]))
        ours = to_torch_antenna(ref)
        _close(ours.directivity(40)[-1], ref.directivity(40)[-1])
        _close(ours.directive_gain(), ref.directive_gain())


def _free_space() -> JaxScene:
    """The scene of ``tests/test_coverage.py::TestTxPattern``: receivers at 0, 90 and 45 degrees from the axis."""
    far = JaxMesh.plane(jnp.array([0.0, 0.0, -500.0]), normal=jnp.array([0.0, 0.0, 1.0]), side_length=1.0)
    r, s = 100.0, 100.0 / np.sqrt(2.0)
    return JaxScene(
        transmitters=jnp.array([[0.0, 0.0, 0.0]]),
        receivers=jnp.array([[r, 0.0, 0.0], [0.0, 0.0, r], [s, 0.0, s]]),
        mesh=far,
    )


@pytest.mark.parametrize(
    ("kind", "want", "tol"),
    [("ShortDipolePattern", [1.5, 0.0, 0.75], {"atol": 1e-3}), ("HWDipolePattern", [1.640922], {"rtol": 1e-4})],
)
def test_pattern_gain_in_received_power(kind: str, want, tol) -> None:
    scene = to_torch_scene(_free_space())
    paths = scene.trace_paths(order=0)
    kw = {"eta_r": torch.tensor([1.0]), "conductivity": torch.tensor([0.0])}
    pattern = getattr(em, kind)(FREQUENCY, direction=(0.0, 0.0, 1.0), center=torch.zeros(3))
    iso = coverage.received_power(paths, scene, FREQUENCY, **kw)
    dip = coverage.received_power(paths, scene, FREQUENCY, tx_pattern=pattern, **kw)
    np.testing.assert_allclose((dip / iso).numpy().ravel()[: len(want)], want, **tol)


# -- The pattern on the coverage path ----------------------------------------------------


@pytest.fixture(scope="module")
def canyon() -> JaxScene:
    ref = jax_scenes.street_canyon_scene()
    return JaxScene(transmitters=jnp.array([[-30.0, 0.0, 20.0]]), mesh=ref.mesh).with_receivers_grid(8, 8)


def _patterns(scene):
    """The same half-wave dipole at the TX, tilted off the vertical, in both packages."""
    center = np.asarray(scene.transmitters)[0]
    axis = np.array([0.2, 0.1, 1.0], np.float32) / np.linalg.norm([0.2, 0.1, 1.0])
    ref = jax_em.HWDipolePattern(
        frequency=jnp.asarray(FREQUENCY), center=jnp.asarray(center), direction=jnp.asarray(axis)
    )
    return ref, to_torch_antenna(ref)


@pytest.mark.parametrize("order", [0, 1, 2])
def test_complex_amplitudes_with_pattern_match(canyon, order: int) -> None:
    ref_pattern, pattern = _patterns(canyon)
    paths = canyon.trace_paths(order=order, megakernel=False)
    port_paths = TracedPaths(
        _t(paths.vertices), _t(paths.objects).to(torch.int64), mask=_t(paths.mask),
        interaction_types=_t(paths.interaction_types),
    )
    kw = {"eta_r": [5.24], "conductivity": [0.1]}
    want = np.asarray(jax_coverage.complex_amplitudes(
        paths, canyon, FREQUENCY, tx_pattern=ref_pattern, **{k: jnp.asarray(v) for k, v in kw.items()}
    ))
    got = coverage.complex_amplitudes(port_paths, to_torch_scene(canyon), FREQUENCY, tx_pattern=pattern, **kw).numpy()
    lit = np.abs(want) > 0
    assert lit.sum() > 5
    np.testing.assert_array_equal(np.abs(got) > 0, lit)
    np.testing.assert_allclose(np.abs(got[lit]), np.abs(want[lit]), rtol=1e-3)
    assert np.abs(np.angle(got[lit] * np.conj(want[lit]))).max() <= 2e-3


@pytest.mark.parametrize("entry", ["received_power", "power_map", "power_map_chunked"])
@pytest.mark.parametrize("order", [0, 1, 2])
def test_maps_with_pattern_match(canyon, order: int, entry: str) -> None:
    ref_pattern, pattern = _patterns(canyon)
    ours = to_torch_scene(canyon)
    kw = {"order": order, "tx_pattern": ref_pattern}
    port_kw = {"order": order, "tx_pattern": pattern}
    if entry == "received_power":
        paths = canyon.trace_paths(order=order)
        materials = {"eta_r": jnp.array([5.24]), "conductivity": jnp.array([0.1])}
        want = jax_coverage.received_power(paths, canyon, FREQUENCY, tx_pattern=ref_pattern, **materials)
        got = coverage.received_power(
            ours.trace_paths(order=order), ours, FREQUENCY, tx_pattern=pattern,
            eta_r=torch.tensor([5.24]), conductivity=torch.tensor([0.1]),
        )
    elif entry == "power_map":
        want = jax_coverage.power_map(canyon, FREQUENCY, **kw)
        got = coverage.power_map(ours, FREQUENCY, **port_kw)
    else:
        chunks = {"candidate_chunk": 64, "rx_chunk": 24}
        want = jax_coverage.power_map_chunked(canyon, FREQUENCY, **kw, **chunks)
        got = coverage.power_map_chunked(ours, FREQUENCY, **port_kw, **chunks)
    assert tuple(got.shape) == tuple(np.shape(want))
    assert_maps_close(got.numpy(), np.asarray(want))
    if entry == "power_map":  # the pattern changes the map
        iso = coverage.power_map(ours, FREQUENCY, order=order)
        assert not torch.allclose(iso, got, rtol=1e-2, atol=0.0)


@pytest.mark.parametrize("kind", ["HWDipolePattern", "ShortDipolePattern"])
def test_pattern_gradients_match_jax(kind: str) -> None:
    # An incoherent map, whose loss carries no phase: the gradients to the
    # TX (which the pattern's centre follows) and to the permittivity.
    scene = JaxScene(
        transmitters=jnp.array([[-19.3, 1.7, 5.4]]),
        mesh=JaxMesh.box(length=80.0, width=30.0, height=20.0, with_top=False).set_materials("Concrete"),
    ).with_receivers_grid(6, 4, height=1.5)
    port = to_torch_scene(scene)
    axis = np.array([0.1, 0.3, 1.0], np.float32) / np.linalg.norm([0.1, 0.3, 1.0])
    sigma = np.array([0.1], np.float32)

    def jax_loss(tx, eta):
        s = tk.tree_at(lambda sc: sc.transmitters, scene, tx)
        pattern = getattr(jax_em, kind)(frequency=jnp.asarray(FREQUENCY), center=tx[0], direction=jnp.asarray(axis))
        power = jax_coverage.power_map(
            s, FREQUENCY, order=1, eta_r=eta, conductivity=jnp.asarray(sigma), coherent=False, tx_pattern=pattern
        )
        return jnp.sum(power) / 1e-9

    eta0 = np.array([5.24], np.float32)
    want_loss, want = jax.value_and_grad(jax_loss, argnums=(0, 1))(scene.transmitters, jnp.asarray(eta0))

    tx = port.transmitters.clone().requires_grad_()
    eta = torch.from_numpy(eta0).requires_grad_()
    pattern = getattr(em, kind)(FREQUENCY, direction=torch.from_numpy(axis), center=tx[0])
    power = coverage.power_map(
        dataclasses.replace(port, transmitters=tx), FREQUENCY, order=1, eta_r=eta,
        conductivity=torch.from_numpy(sigma), coherent=False, tx_pattern=pattern,
    )
    loss = power.sum() / 1e-9
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    grads = torch.autograd.grad(loss, (tx, eta))
    for name, g, w in zip(("tx", "eta_r"), grads, want):
        w = np.asarray(w)
        assert torch.isfinite(g).all() and g.abs().max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_pattern_backward_is_finite_along_the_axis() -> None:
    # sin theta = 0: a departure straight down the dipole's axis.
    scene = to_torch_scene(_free_space())
    tx = torch.zeros((1, 3), requires_grad=True)
    scene = dataclasses.replace(scene, transmitters=tx, receivers=torch.tensor([[0.0, 0.0, 100.0], [100.0, 0.0, 0.0]]))
    pattern = em.HWDipolePattern(FREQUENCY, direction=(0.0, 0.0, 1.0), center=tx[0])
    power = coverage.received_power(
        scene.trace_paths(order=0), scene, FREQUENCY, tx_pattern=pattern,
        eta_r=torch.tensor([1.0]), conductivity=torch.tensor([0.0]),
    )
    assert float(power[0, 0]) == 0.0 and float(power[0, 1]) > 0.0
    (grad,) = torch.autograd.grad(power.sum(), tx)
    assert torch.isfinite(grad).all()


@pytest.mark.parametrize(
    "name",
    [
        "differt_tpu_torch.em._antenna",
        "differt_tpu_torch.em._fresnel",
        "differt_tpu_torch.em._interaction_type",
        "differt_tpu_torch.em._material",
        "differt_tpu_torch.em._utils",
        "differt_tpu_torch.interop",
    ],
)
def test_doctests(name: str) -> None:
    result = doctest.testmod(importlib.import_module(name), optionflags=doctest.ELLIPSIS)
    assert result.attempted > 0 and result.failed == 0


def test_interaction_type_matches() -> None:
    assert {t.name: int(t) for t in em.InteractionType} == {t.name: int(t) for t in jax_em.InteractionType}


def test_antenna_from_numpy_rejects_unknown_kinds() -> None:
    from differt_tpu_torch.interop import antenna_from_numpy

    with pytest.raises(ValueError, match="Unknown antenna kind"):
        antenna_from_numpy({"kind": "Horn", "frequency": 1e9}, device="cpu")
