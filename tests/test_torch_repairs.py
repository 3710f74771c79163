"""Two repairs of the port, held against the JAX package and against central differences.

- ``smoothing_factor`` and ``confidence_threshold`` take 0-d tensors, so a
  gradient flows to the smoothing factor: the smoothed canyon map's
  derivative with respect to it equals the JAX package's.
- ``em.slab_reflection_coefficients`` computes its discarded slab branch at
  a safe thickness: on an ITU ``Metal`` face the TX gradient of a map is
  finite (the JAX package's is NaN there), the forward values are the same
  bits as before, and on dielectric faces the gradient equals the JAX
  package's.
- ``rt.ray_intersect_triangle`` gives a ray parallel to a face a constant,
  detached confidence: the derivative of a map with respect to a tensor
  smoothing factor is finite where a segment lies in a face's plane (a
  receiver on a wall, two bounces on one plane), within 1% of central
  differences, and the map keeps its bits.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt_tpu import coverage as jax_coverage
from differt_tpu.geometry import Mesh as JaxMesh
from differt_tpu.geometry import Scene as JaxScene
from differt_tpu_torch import coverage
from differt_tpu_torch.em import slab_reflection_coefficients
from differt_tpu_torch.geometry import Mesh, Scene
from differt_tpu_torch.geometry._vectors import _cross, _dot
from differt_tpu_torch.parallel import streamed_placement_loss, streamed_placement_step
from differt_tpu_torch.rt import _scan, _solvers
from differt_tpu_torch.utils import min_with_initial, safe_divide, smoothing_function

from .torch_parity import to_torch_scene

torch.set_num_threads(1)

FREQUENCY = 2.4e9
ALPHA = 50.0


def canyon(materials=("Concrete",), face_materials=None) -> JaxScene:
    """tests/test_coverage.py's canyon, with receivers off the walls (a receiver on a wall makes segments parallel to it, whose sigmoid of +inf has a NaN derivative in the JAX package)."""
    mesh = JaxMesh.box(length=60.0, width=20.0, height=15.0, with_top=False).set_materials(*materials)
    if face_materials is not None:
        mesh = mesh.set_face_materials(jnp.asarray(face_materials))
    x, y = np.meshgrid(np.linspace(-25.0, 25.0, 5), np.linspace(-7.0, 7.0, 4))
    rx = np.stack((x, y, np.full_like(x, 1.5)), axis=-1).astype(np.float32)
    return JaxScene(transmitters=jnp.array([-20.0, 0.5, 5.0]), receivers=jnp.asarray(rx), mesh=mesh)


@pytest.fixture(scope="module")
def jax_smoothing_gradient() -> tuple[float, float]:
    """The JAX package's smoothed order-1 canyon map total and its derivative with respect to the smoothing factor."""
    ref = canyon()

    def total(alpha):
        return jax_coverage.power_map(ref, FREQUENCY, order=1, smoothing_factor=alpha).sum()

    # Smoothed confidences op by op: XLA's fused multiply-adds move them by ulps.
    with jax.disable_jit(), jax.debug_nans(False):
        value, grad = jax.value_and_grad(total)(jnp.float32(ALPHA))
    return float(value), float(grad)


@pytest.mark.parametrize("entry", ["power_map", "power_map_chunked"])
def test_smoothing_factor_gradient_matches_jax(jax_smoothing_gradient, entry: str) -> None:
    """The port's map, whole or streamed in tiles, against the JAX package's whole map (the same sum)."""
    want_value, want = jax_smoothing_gradient
    port = to_torch_scene(canyon())
    kw = {"candidate_chunk": 4, "rx_chunk": 8} if entry == "power_map_chunked" else {}
    alpha = torch.tensor(ALPHA, requires_grad=True)
    value = getattr(coverage, entry)(port, FREQUENCY, order=1, smoothing_factor=alpha, **kw).sum()
    (grad,) = torch.autograd.grad(value, alpha)
    assert math.isfinite(want) and want != 0.0
    np.testing.assert_allclose(value.item(), want_value, rtol=1e-5)
    np.testing.assert_allclose(float(grad), want, rtol=1e-4)
    # A tensor and a float smoothing factor give the same map.
    as_float = getattr(coverage, entry)(port, FREQUENCY, order=1, smoothing_factor=ALPHA, **kw)
    assert float(as_float.sum()) == value.item()


def test_tensor_smoothing_and_threshold_in_the_tracer_and_the_streamed_steps() -> None:
    port = to_torch_scene(canyon())
    threshold = torch.tensor(0.25)
    paths = port.trace_paths(order=1, smoothing_factor=torch.tensor(ALPHA), confidence_threshold=threshold)
    floats = port.trace_paths(order=1, smoothing_factor=ALPHA, confidence_threshold=0.25)
    assert torch.equal(paths.mask, floats.mask) and torch.equal(paths.valid_mask, floats.valid_mask)
    assert paths.mask.dtype == torch.float32 and 0 < int(paths.valid_mask.sum()) < paths.mask.numel()

    candidates = torch.arange(port.mesh.num_primitives)[:, None]
    kw = {
        "tx": port.transmitters.reshape(1, 3), "eta_r": torch.tensor([5.24]), "conductivity": torch.tensor([0.1]),
        "path_candidates": candidates, "candidate_chunk": 4, "rx_chunk": 8,
    }
    steps = [
        streamed_placement_step(port, FREQUENCY, None, smoothing_factor=alpha, **kw)
        for alpha in (torch.tensor(ALPHA), ALPHA)
    ]
    for a, b in zip(*steps, strict=True):
        assert torch.equal(a, b)
    loss = streamed_placement_loss(port, FREQUENCY, None, smoothing_factor=torch.tensor(ALPHA), **kw)
    assert float(loss) == float(steps[0][2])


def _old_slab(n_r, cos_theta_i, thickness, wavelength):
    """The coefficients as computed before the repair (the slab branch at the given, possibly negative, thickness)."""
    r_s_inf, r_p_inf = slab_reflection_coefficients(n_r, cos_theta_i, torch.full_like(thickness, -1.0), wavelength)
    a = torch.sqrt(n_r * n_r - (1.0 - cos_theta_i * cos_theta_i))
    phase = torch.exp(-2j * ((2.0 * math.pi * thickness / wavelength) * a))
    r_s = safe_divide(r_s_inf * (1.0 - phase), 1.0 - r_s_inf * r_s_inf * phase)
    r_p = safe_divide(r_p_inf * (1.0 - phase), 1.0 - r_p_inf * r_p_inf * phase)
    use = thickness >= 0.0
    return torch.where(use, r_s, r_s_inf), torch.where(use, r_p, r_p_inf)


def test_slab_coefficients_keep_their_values_and_get_finite_gradients_on_metal() -> None:
    rng = np.random.default_rng(5)
    num = 64
    # Concrete, glass and metal at 2.4 GHz (eta - j sigma / (omega eps0)).
    eps = np.array([5.24 - 0.69j, 6.27 - 0.22j, 1.0 - 7.49e7j], np.complex64)
    n_r = torch.from_numpy(np.sqrt(eps[rng.integers(0, 3, num)]).astype(np.complex64))
    cos_theta = torch.from_numpy(rng.uniform(0.05, 1.0, num).astype(np.float32)).requires_grad_()
    thickness = torch.from_numpy(rng.choice([-1.0, 0.0, 0.05, 0.2], num).astype(np.float32))
    wavelength = torch.tensor(0.125)
    r_s, r_p = slab_reflection_coefficients(n_r, cos_theta, thickness, wavelength)
    old_s, old_p = _old_slab(n_r, cos_theta, thickness, wavelength)
    assert torch.equal(torch.view_as_real(r_s), torch.view_as_real(old_s))
    assert torch.equal(torch.view_as_real(r_p), torch.view_as_real(old_p))
    loss = (r_s.abs() ** 2 + r_p.abs() ** 2).sum()
    (grad,) = torch.autograd.grad(loss, cos_theta)
    assert bool(torch.isfinite(grad).all())
    (old_grad,) = torch.autograd.grad((old_s.abs() ** 2 + old_p.abs() ** 2).sum(), cos_theta)
    assert not bool(torch.isfinite(old_grad).all())  # the defect repaired: NaN on metal


def test_tx_gradient_on_a_metal_wall_matches_central_differences() -> None:
    """The canyon with one metal side wall (triangles 0-1), the rest concrete: incoherent order-1 power."""
    faces = np.zeros(10, np.int32)
    faces[:2] = 1
    ref = canyon(("Concrete", "Metal"), faces)
    port = to_torch_scene(ref)

    def total(tx: torch.Tensor) -> torch.Tensor:
        scene = dataclasses.replace(port, transmitters=tx)
        return coverage.power_map(scene, FREQUENCY, order=1, coherent=False).double().sum()

    tx0 = port.transmitters.clone()
    tx = tx0.clone().requires_grad_()
    (grad,) = torch.autograd.grad(total(tx), tx)
    assert bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0
    # The metal wall carries part of the power.
    concrete = dataclasses.replace(port, mesh=port.mesh.set_face_materials(0))
    assert float(coverage.power_map(concrete, FREQUENCY, order=1, coherent=False).sum()) < float(total(tx0))
    h = 1e-2
    for axis in range(3):
        step = torch.zeros(3)
        step[axis] = h
        fd = float(total(tx0 + step) - total(tx0 - step)) / (2.0 * h)
        np.testing.assert_allclose(float(grad[axis]), fd, rtol=1e-2, atol=1e-3 * float(grad.abs().max()))


def test_tx_gradient_on_dielectric_walls_matches_jax() -> None:
    ref = canyon()
    port = to_torch_scene(ref)

    def jax_total(tx):
        scene = JaxScene(transmitters=tx, receivers=ref.receivers, mesh=ref.mesh)
        return jax_coverage.power_map(scene, FREQUENCY, order=1).sum()

    with jax.debug_nans(False):
        want = np.asarray(jax.grad(jax_total)(ref.transmitters))
    tx = port.transmitters.clone().requires_grad_()
    total = coverage.power_map(dataclasses.replace(port, transmitters=tx), FREQUENCY, order=1).sum()
    (grad,) = torch.autograd.grad(total, tx)
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(grad.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def _old_ray_intersect_triangle(ray_origins, ray_directions, triangle_vertices, *, epsilon=None, smoothing_factor=None):
    """``rt.ray_intersect_triangle`` as written before the repair: a parallel ray's sigmoid sees ``inf``."""
    if epsilon is None:
        epsilon = 10.0 * float(torch.finfo(torch.float32).eps)
    v0 = triangle_vertices[..., 0, :]
    edge_1 = triangle_vertices[..., 1, :] - v0
    edge_2 = triangle_vertices[..., 2, :] - v0
    h = _cross(ray_directions, edge_2)
    det = _dot(h, edge_1)
    det_safe = torch.where(det == 0.0, torch.full_like(det, torch.inf), det)
    inv_det = 1.0 / det_safe
    s = ray_origins - v0
    u = inv_det * _dot(s, h)
    q = _cross(s, edge_1)
    v = inv_det * _dot(q, ray_directions)
    t = inv_det * _dot(q, edge_2)
    if smoothing_factor is not None:
        conds = torch.stack(
            (
                smoothing_function(torch.abs(det_safe) - epsilon, smoothing_factor),
                smoothing_function(u, smoothing_factor),
                smoothing_function(1.0 - u, smoothing_factor),
                smoothing_function(v, smoothing_factor),
                smoothing_function(1.0 - (u + v), smoothing_factor),
                smoothing_function(t - epsilon, smoothing_factor),
            ),
            dim=-1,
        )
        return t, min_with_initial(conds, -1, 1.0)
    hit = (torch.abs(det) > epsilon) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > epsilon)
    return t, hit


def on_the_walls() -> Scene:
    """The canyon with two receivers on its side walls and one on its end wall (the triangles' planes)."""
    mesh = Mesh.box(60.0, 20.0, 15.0, with_top=False, device="cpu").set_materials("Concrete")
    rx = torch.tensor([[0.0, 10.0, 1.5], [5.0, -10.0, 2.0], [30.0, 3.0, 2.0], [0.0, 0.0, 1.5], [10.0, 2.0, 1.5]])
    return Scene(transmitters=torch.tensor([[-20.0, 0.5, 5.0]]), receivers=rx, mesh=mesh)


@pytest.mark.parametrize("order", [1, 2])
def test_smoothing_factor_gradient_is_finite_on_a_wall(monkeypatch, order: int) -> None:
    scene = on_the_walls()
    # Order 2 holds candidates that bounce twice on one plane (triangles 0 and 1 of a wall).
    assert bool(torch.equal(scene.mesh.normals[0], scene.mesh.normals[1]))

    def total(alpha):
        return coverage.power_map(scene, FREQUENCY, order=order, smoothing_factor=alpha).double().sum()

    alpha = torch.tensor(ALPHA, requires_grad=True)
    value = total(alpha)
    (grad,) = torch.autograd.grad(value, alpha)
    assert math.isfinite(float(grad)) and float(grad) != 0.0
    h = 0.5
    with torch.no_grad():
        fd = float(total(torch.tensor(ALPHA + h)) - total(torch.tensor(ALPHA - h))) / (2.0 * h)
    np.testing.assert_allclose(float(grad), fd, rtol=1e-2)

    # The unrepaired formula: the same map, bit for bit, and a NaN derivative.
    with monkeypatch.context() as m:
        for module in (_solvers, _scan):
            m.setattr(module, "ray_intersect_triangle", _old_ray_intersect_triangle)
        alpha_old = torch.tensor(ALPHA, requires_grad=True)
        old = coverage.power_map(scene, FREQUENCY, order=order, smoothing_factor=alpha_old)
        (old_grad,) = torch.autograd.grad(old.double().sum(), alpha_old)
    new = coverage.power_map(scene, FREQUENCY, order=order, smoothing_factor=alpha)
    assert torch.equal(new, old)
    assert math.isnan(float(old_grad))
