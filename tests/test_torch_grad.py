"""Gradients through the port's trace and coverage maps, against the JAX package.

The fused trace's ``torch.autograd.Function`` runs on the CPU with the
kernel's plain version as its forward and the same recompute as its
backward, so these tests drive the backward the card runs. The JAX side
reaches its Pallas kernel in interpret mode (``megakernel=True``) or its
plain pipeline (``megakernel=False``), as ``tests/test_pallas_trace.py`` does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differt_tpu.treekit as tk
from differt_tpu.coverage import power_map as jax_power_map
from differt_tpu.coverage import power_map_chunked as jax_power_map_chunked
from differt_tpu.geometry import Mesh as JaxMesh
from differt_tpu.geometry import Scene as JaxScene
from differt_tpu.geometry import generate_all_path_candidates
from differt_tpu.rt import trace_path_candidates as jax_trace_path_candidates
from differt_tpu.scenes import street_canyon_scene as jax_street_canyon_scene
from differt_tpu_torch import coverage
from differt_tpu_torch.ops import _trace
from differt_tpu_torch.rt import trace_path_candidates
from differt_tpu_torch.rt._solvers import candidate_geometry

from .torch_parity import EPSILON, HIT_TOL, to_torch_scene

torch.set_num_threads(1)

FREQUENCY = 2.4e9


def box_scene(*, quads: bool = False) -> JaxScene:
    """The box of ``tests/test_pallas_trace.py``, TX and RX off its symmetry planes."""
    mesh = JaxMesh.box(length=10.0, width=3.0, height=2.0, with_top=True)
    if quads:
        mesh = mesh.set_assume_quads()
    return JaxScene(
        transmitters=jnp.array([[-4.0, 0.1, 0.2], [0.3, 1.0, 0.5]]),
        receivers=jnp.array([[4.0, 0.0, 0.0], [3.0, 0.5, 0.3], [-1.0, -0.7, 0.4]]),
        mesh=mesh.set_materials("Concrete"),
    )


def _candidates(scene: JaxScene, order: int) -> np.ndarray:
    candidates = np.asarray(generate_all_path_candidates(scene.mesh.num_primitives, order))
    return (2 * candidates if scene.mesh.assume_quads else candidates).copy()


def _jax_total_length(scene: JaxScene, candidates, megakernel):
    """Sum of the valid paths' lengths as a function of (tx, rx, mesh vertices)."""

    def total_length(tx, rx, vertices):
        mesh = tk.tree_at(lambda m: m.vertices, scene.mesh, vertices)
        paths = jax_trace_path_candidates(
            mesh, tx, rx, jnp.asarray(candidates), megakernel=megakernel
        )
        seg = jnp.diff(paths.vertices, axis=-2)
        lengths = jnp.sqrt(jnp.sum(seg * seg, axis=-1) + 1e-12).sum(axis=-1)
        return jnp.sum(jnp.where(paths.mask, lengths, 0.0))

    return total_length


def _port_length_gradients(port, candidates, megakernel):
    """The same sum's gradients in the port, and the sum itself."""
    tx = port.transmitters.reshape(-1, 3).clone().requires_grad_()
    rx = port.receivers.reshape(-1, 3).clone().requires_grad_()
    vertices = port.mesh.vertices.clone().requires_grad_()
    mesh = dataclasses.replace(port.mesh, vertices=vertices)
    paths = trace_path_candidates(
        mesh, tx, rx, torch.from_numpy(candidates), megakernel=megakernel
    )
    seg = paths.vertices[..., 1:, :] - paths.vertices[..., :-1, :]
    lengths = torch.sqrt((seg * seg).sum(dim=-1) + 1e-12).sum(dim=-1)
    total = torch.where(paths.mask, lengths, 0.0).sum()
    return total, torch.autograd.grad(total, (tx, rx, vertices)), paths


@pytest.mark.parametrize(("order", "quads"), [(1, False), (2, False), (1, True), (2, True)])
def test_trace_function_gradients(order: int, quads: bool) -> None:
    scene = box_scene(quads=quads)
    port = to_torch_scene(scene)
    candidates = _candidates(scene, order)

    calls = _trace.REFERENCE_CALLS
    total, fused, paths = _port_length_gradients(port, candidates, True)
    assert _trace.REFERENCE_CALLS == calls + 1  # the Function's forward, once; none in the backward
    assert paths.num_valid_paths > 0 and not paths.mask.requires_grad
    _, unfused, _ = _port_length_gradients(port, candidates, False)

    args = (
        jnp.asarray(np.asarray(scene.transmitters)),
        jnp.asarray(np.asarray(scene.receivers)),
        scene.mesh.vertices,
    )
    want_total = _jax_total_length(scene, candidates, False)(*args)
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-5)
    jax_unfused = jax.grad(_jax_total_length(scene, candidates, False), argnums=(0, 1, 2))(*args)
    jax_fused = jax.grad(_jax_total_length(scene, candidates, True), argnums=(0, 1, 2))(*args)
    for name, got, direct, want_fused, want_unfused in zip(
        ("tx", "rx", "vertices"), fused, unfused, jax_fused, jax_unfused
    ):
        got = got.numpy()
        assert np.isfinite(got).all() and np.abs(got).max() > 0.0, name
        # The Function against direct autograd through the unfused pipeline,
        np.testing.assert_allclose(got, direct.numpy(), rtol=1e-4, atol=1e-4, err_msg=name)
        # against jax.grad through the Pallas kernel's custom VJP,
        np.testing.assert_allclose(got, np.asarray(want_fused), rtol=1e-4, atol=1e-4, err_msg=name)
        # and against jax.grad through the plain pipeline.
        np.testing.assert_allclose(got, np.asarray(want_unfused), rtol=1e-4, atol=1e-4, err_msg=name)


def test_trace_function_saves_only_the_geometry_inputs() -> None:
    scene = box_scene()
    port = to_torch_scene(scene)
    tx = port.transmitters.clone().requires_grad_()
    _, tris, mirror_vertices, mirror_normals = candidate_geometry(
        port.mesh, torch.from_numpy(_candidates(scene, 2))
    )
    vertices, mask = _trace.trace_specular_cuda(
        tx, port.receivers, mirror_vertices, mirror_normals, tris,
        port.mesh.triangle_vertices.contiguous(), None,
        order=2, epsilon=EPSILON, hit_tol=HIT_TOL, min_len=EPSILON,
    )
    assert vertices.requires_grad and not mask.requires_grad and mask.dtype == torch.bool
    saved = vertices.grad_fn.saved_tensors
    assert [tuple(x.shape) for x in saved] == [(2, 3), (3, 3), (132, 2, 3), (132, 2, 3)]
    # Without a gradient to give, nothing is recorded.
    vertices, _ = _trace.trace_specular_cuda(
        tx.detach(), port.receivers, mirror_vertices, mirror_normals, tris,
        port.mesh.triangle_vertices.contiguous(), None,
        order=2, epsilon=EPSILON, hit_tol=HIT_TOL, min_len=EPSILON,
    )
    assert vertices.grad_fn is None


def test_recompute_equals_the_plain_version_and_passes_gradcheck() -> None:
    scene = box_scene()
    port = to_torch_scene(scene)
    _, tris, mirror_vertices, mirror_normals = candidate_geometry(
        port.mesh, torch.from_numpy(_candidates(scene, 2))
    )
    tx, rx = port.transmitters, port.receivers
    want, _ = _trace.trace_specular_reference(
        tx, rx, mirror_vertices, mirror_normals, tris,
        port.mesh.triangle_vertices.contiguous(), None,
        order=2, epsilon=EPSILON, hit_tol=HIT_TOL, min_len=EPSILON,
    )
    got = _trace.trace_vertices(tx, rx, mirror_vertices, mirror_normals)
    assert torch.equal(got, want)  # one function computes both

    # In float64 at a tiny size: the analytic backward against finite differences.
    pick = torch.tensor([3, 17, 40, 101])
    inputs = [
        x.double().requires_grad_()
        for x in (tx[:1], rx[:2], mirror_vertices[pick], mirror_normals[pick])
    ]
    assert torch.autograd.gradcheck(_trace.trace_vertices, inputs, eps=1e-6, atol=1e-5, rtol=1e-4)


def test_trace_function_zeroes_non_finite_incoming_gradients() -> None:
    scene = box_scene()
    port = to_torch_scene(scene)
    candidates = torch.from_numpy(_candidates(scene, 1))
    tx = port.transmitters.clone().requires_grad_()
    paths = trace_path_candidates(port.mesh, tx, port.receivers, candidates, megakernel=True)
    weights = torch.ones_like(paths.vertices)
    weights[~paths.mask] = torch.nan  # what a caller may derive from an invalid path
    weights[0, 0, 0] = torch.inf
    (grad,) = torch.autograd.grad(paths.vertices, tx, weights)
    assert torch.isfinite(grad).all() and grad.abs().max() > 0


def canyon_scene() -> JaxScene:
    """The street canyon: two parallel walls, TX and receivers at one height over the ground.

    At order 2 the candidates that bounce on the two triangles of one wall
    (or of the ground) are parallel mirrors, whose image-method paths are
    impossible: the case whose non-finite vertices must not reach a gradient.
    """
    scene = jax_street_canyon_scene()
    scene = tk.tree_at(lambda s: s.transmitters, scene, jnp.array([[-30.0, 0.5, 1.5]]))
    return scene.with_receivers_grid(4, 3, height=1.5)


@pytest.mark.parametrize("megakernel", [True, False], ids=["function", "unfused"])
def test_canyon_with_parallel_mirrors_has_finite_gradients(megakernel: bool) -> None:
    scene = canyon_scene()
    port = to_torch_scene(scene)
    candidates = torch.from_numpy(_candidates(scene, 2))
    tx = port.transmitters.reshape(-1, 3).clone().requires_grad_()
    eta = torch.tensor([5.24], requires_grad=True)
    sigma = torch.tensor([0.1], requires_grad=True)
    vertices = port.mesh.vertices.clone().requires_grad_()
    mesh = dataclasses.replace(port.mesh, vertices=vertices)
    paths = trace_path_candidates(
        mesh, tx, port.receivers.reshape(-1, 3), candidates, megakernel=megakernel
    )
    if megakernel:
        # The fused contract keeps raw vertices: some are not usable.
        assert not torch.isfinite(paths.vertices).all() or paths.num_valid_paths < paths.mask.numel()
    power = coverage.received_power(
        paths, dataclasses.replace(port, mesh=mesh), FREQUENCY, eta_r=eta, conductivity=sigma
    )
    assert paths.num_valid_paths > 0 and float(power.max()) > 0.0
    loss = -torch.mean(10.0 * torch.log10(torch.clamp(power, min=1e-30)))
    grads = torch.autograd.grad(loss, (tx, eta, sigma, vertices))
    for name, g in zip(("tx", "eta_r", "conductivity", "vertices"), grads):
        assert torch.isfinite(g).all(), name
        assert g.abs().max() > 0.0, name


def _map_loss_jax(power):
    return -jnp.mean(10.0 * jnp.log10(jnp.maximum(power, 1e-30)))


def _map_loss_torch(power):
    return -torch.mean(10.0 * torch.log10(torch.clamp(power, min=1e-30)))


def coverage_scene() -> JaxScene:
    """The box of ``tests/test_parallel.py``, TX off its symmetry planes."""
    mesh = JaxMesh.box(length=80.0, width=30.0, height=20.0, with_top=False)
    scene = JaxScene(
        transmitters=jnp.array([[-19.3, 1.7, 5.4]]), mesh=mesh.set_materials("Concrete")
    )
    return scene.with_receivers_grid(6, 4, height=1.5)


@pytest.mark.parametrize("megakernel", [True, False], ids=["function", "unfused"])
@pytest.mark.parametrize("entry", ["power_map", "power_map_chunked"])
def test_power_map_gradients_match_jax(entry: str, megakernel: bool) -> None:
    scene = coverage_scene()
    port = to_torch_scene(scene)
    eta0, sigma0 = np.array([5.24], np.float32), np.array([0.1], np.float32)
    chunked = {"candidate_chunk": 4, "rx_chunk": 8} if entry == "power_map_chunked" else {}

    def jax_loss(tx, eta, sigma):
        s = tk.tree_at(lambda sc: sc.transmitters, scene, tx)
        fn = jax_power_map_chunked if chunked else jax_power_map
        return _map_loss_jax(fn(s, FREQUENCY, order=1, eta_r=eta, conductivity=sigma, **chunked))

    args = (scene.transmitters, jnp.asarray(eta0), jnp.asarray(sigma0))
    want_loss, want = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(*args)

    tx = port.transmitters.clone().requires_grad_()
    eta = torch.from_numpy(eta0).requires_grad_()
    sigma = torch.from_numpy(sigma0).requires_grad_()
    vertices = port.mesh.vertices.clone().requires_grad_()
    s = dataclasses.replace(
        port, transmitters=tx, mesh=dataclasses.replace(port.mesh, vertices=vertices)
    )
    fn = coverage.power_map_chunked if chunked else coverage.power_map
    loss = _map_loss_torch(
        fn(s, FREQUENCY, order=1, eta_r=eta, conductivity=sigma, megakernel=megakernel, **chunked)
    )
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    grads = torch.autograd.grad(loss, (tx, eta, sigma, vertices))
    for name, g, w in zip(("tx", "eta_r", "conductivity"), grads, want):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=2e-3, atol=2e-3 * np.abs(w).max(), err_msg=name
        )
    assert torch.isfinite(grads[3]).all() and grads[3].abs().max() > 0.0


def test_power_map_gradient_reaches_the_mesh_vertices() -> None:
    # The JAX package's own gradient with respect to Mesh.vertices is NaN here
    # (a dummy path along a wall's normal: sqrt'(0) in its normalize), so the
    # port's is held against a central difference of the same loss instead,
    # its mean taken in float64, and the Function against direct autograd.
    # Receivers inside the box: those of a grid over the bounding box lie on
    # the walls, where moving a vertex flips their paths' hard masks.
    port = to_torch_scene(coverage_scene())
    y, x = torch.meshgrid(
        torch.linspace(-11.0, 12.0, 4), torch.linspace(-33.0, 31.0, 6), indexing="ij"
    )
    port = dataclasses.replace(port, receivers=torch.stack((x, y, torch.full_like(x, 1.5)), dim=-1))
    kw = {"eta_r": torch.tensor([5.24]), "conductivity": torch.tensor([0.1])}

    def loss_at(vertices, megakernel, dtype=torch.float32):
        s = dataclasses.replace(port, mesh=dataclasses.replace(port.mesh, vertices=vertices))
        power = coverage.power_map(s, FREQUENCY, order=1, megakernel=megakernel, **kw)
        return _map_loss_torch(power.to(dtype))

    grads = []
    for megakernel in (True, False):
        vertices = port.mesh.vertices.clone().requires_grad_()
        (grad,) = torch.autograd.grad(loss_at(vertices, megakernel), vertices)
        assert torch.isfinite(grad).all()
        grads.append(grad)
    scale = float(grads[1].abs().max())
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=1e-4, atol=1e-4 * scale)

    norm = float(grads[1].norm())
    direction = grads[1] / norm
    h = 5e-4
    with torch.no_grad():
        plus = loss_at(port.mesh.vertices + h * direction, False, torch.float64)
        minus = loss_at(port.mesh.vertices - h * direction, False, torch.float64)
    np.testing.assert_allclose(float(plus - minus) / (2.0 * h), norm, rtol=0.05)
