"""The port's gradient steps (``differt_tpu_torch.parallel``) against the JAX package's.

The ports of ``tests/test_parallel.py``'s streamed and smoothed tests, each
also held against the JAX function's own numbers on the same numpy inputs
(carried across by ``interop.placement_from_numpy``): loss ``rtol 1e-5``,
gradients ``rtol 2e-3`` (float32 sums in another order). Unit learning
rates make each update equal to its gradient.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt_tpu.coverage import power_map_chunked as jax_power_map_chunked
from differt_tpu.geometry import Mesh as JaxMesh
from differt_tpu.geometry import Scene as JaxScene
from differt_tpu.geometry import generate_all_path_candidates
from differt_tpu.parallel import make_device_mesh
from differt_tpu.parallel import placement_training_step as jax_placement_training_step
from differt_tpu.parallel import streamed_placement_loss as jax_streamed_placement_loss
from differt_tpu.parallel import streamed_placement_step as jax_streamed_placement_step
from differt_tpu.parallel import training_step as jax_training_step
from differt_tpu_torch import coverage
from differt_tpu_torch.ops import _bvh, _trace
from differt_tpu_torch.parallel import (
    placement_training_step,
    streamed_placement_loss,
    streamed_placement_step,
    training_step,
)

from .torch_parity import placement_for, to_torch_scene

torch.set_num_threads(1)

FREQUENCY = 2.4e9
UNIT_RATES = {"tx_learning_rate": 1.0, "eta_learning_rate": 1.0}


def box_scene(grid=(6, 4), height: float = 1.5, tx=(-19.3, 1.7, 5.4)) -> JaxScene:
    """The box of ``tests/test_parallel.py``; the TX off every symmetry plane (its ``asym_scene``)."""
    mesh = JaxMesh.box(length=80.0, width=30.0, height=20.0, with_top=False)
    scene = JaxScene(transmitters=jnp.array([tx]), mesh=mesh.set_materials("Concrete"))
    return scene.with_receivers_grid(*grid, height=height)


def placement_fields(scene: JaxScene, orders, **extra) -> dict:
    """A placement problem on ``scene`` as numpy arrays: every candidate of each order."""
    candidates = [
        np.asarray(generate_all_path_candidates(scene.mesh.num_primitives, order)).copy()
        for order in orders
    ]
    return {
        "tx": np.asarray(scene.transmitters).reshape(-1, 3),
        "eta_r": np.array([5.24], np.float32),
        "conductivity": np.array([0.1], np.float32),
        "path_candidates": candidates if len(candidates) > 1 else candidates[0],
        **extra,
    }


def assert_step_matches(got, want, fields: dict) -> None:
    """Loss to 1e-5; the gradients (start minus update, at unit rates) to 2e-3."""
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)
    for name, new, ref in zip(("tx", "eta_r"), got, want):
        g = fields[name] - new.numpy()
        w = fields[name] - np.asarray(ref)
        assert np.abs(w).max() > 0.0, name
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-3 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("orders", [(1,), (1, 2)], ids=["order1", "orders1and2"])
@pytest.mark.parametrize("megakernel", [None, True], ids=["unfused", "function"])
def test_streamed_gradient_matches_unstreamed(megakernel, orders) -> None:
    scene = box_scene()
    port = to_torch_scene(scene)
    fields = placement_fields(scene, orders)
    chunks = {"candidate_chunk": 4, "rx_chunk": 8}  # several chunks along both axes, both padded

    got = streamed_placement_step(
        port, FREQUENCY, None, megakernel=megakernel, **placement_for(torch, fields),
        **chunks, **UNIT_RATES,
    )
    assert torch.isfinite(got[2])
    want = jax_streamed_placement_step(
        scene, FREQUENCY, None, **placement_for(jnp, fields), **chunks, **UNIT_RATES
    )
    assert_step_matches(got, want, fields)

    # The unstreamed oracle: direct autograd of the same loss on maps held whole.
    kw = placement_for(torch, fields)
    tx = kw["tx"].clone().requires_grad_()
    eta = kw["eta_r"].clone().requires_grad_()
    s = dataclasses.replace(port, transmitters=tx)
    total = sum(
        coverage._coverage_tile(
            s, tx, port.receivers.reshape(-1, 3), coverage._CandidateSet(cand, None, len(cand), len(cand)),
            0, len(cand), None, torch.tensor(FREQUENCY), eta, kw["conductivity"], None, True, False,
        )
        for cand in (kw["path_candidates"] if len(orders) > 1 else [kw["path_candidates"]])
    )
    power = (total.real**2 + total.imag**2) / coverage.z_0
    loss = -torch.mean(10.0 * torch.log10(torch.clamp(power, min=1e-30)))
    g_tx, g_eta = torch.autograd.grad(loss, (tx, eta))
    np.testing.assert_allclose(float(got[2]), float(loss), rtol=1e-5)
    for g, new, start in ((g_tx, got[0], kw["tx"]), (g_eta, got[1], kw["eta_r"])):
        scale = float(g.abs().max())
        np.testing.assert_allclose(
            (start - new).numpy(), g.numpy(), rtol=2e-3, atol=2e-3 * scale
        )


def test_streamed_step_matches_power_map_gradient() -> None:
    # Order 1 streamed against autograd through the public power_map.
    scene = box_scene()
    port = to_torch_scene(scene)
    kw = placement_for(torch, placement_fields(scene, (1,)))
    new_tx, new_eta, loss = streamed_placement_step(
        port, FREQUENCY, None, **kw, candidate_chunk=3, rx_chunk=5, **UNIT_RATES
    )
    tx = kw["tx"].clone().requires_grad_()
    eta = kw["eta_r"].clone().requires_grad_()
    power = coverage.power_map(
        dataclasses.replace(port, transmitters=tx), FREQUENCY, order=1,
        eta_r=eta, conductivity=kw["conductivity"],
    )
    want = -torch.mean(10.0 * torch.log10(torch.clamp(power, min=1e-30)))
    g_tx, g_eta = torch.autograd.grad(want, (tx, eta))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    np.testing.assert_allclose((kw["tx"] - new_tx).numpy(), g_tx.numpy(), rtol=2e-3, atol=1e-2)
    np.testing.assert_allclose((kw["eta_r"] - new_eta).numpy(), g_eta.numpy(), rtol=2e-3, atol=1e-6)


def test_streamed_step_without_device_mesh() -> None:
    scene = box_scene()
    port = to_torch_scene(scene)
    fields = placement_fields(scene, (1,))
    chunks = {"candidate_chunk": 3, "rx_chunk": 16}
    builds, calls = _bvh.BUILDS, _trace.REFERENCE_CALLS
    got = streamed_placement_step(port, FREQUENCY, None, **placement_for(torch, fields), **chunks)
    # On the CPU the trace is unfused (no Function, no BVH); 2 RX tiles x 4 chunks.
    assert (_bvh.BUILDS, _trace.REFERENCE_CALLS) == (builds, calls)
    assert torch.isfinite(got[2]) and bool((got[0] != torch.from_numpy(fields["tx"])).any())
    want = jax_streamed_placement_step(
        scene, FREQUENCY, None, **placement_for(jnp, fields), **chunks
    )
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)
    # Default rates (0.1, 0.01): compare the moves, not the positions.
    for name, new, ref in zip(("tx", "eta_r"), got, want):
        move, ref_move = new.numpy() - fields[name], np.asarray(ref) - fields[name]
        np.testing.assert_allclose(
            move, ref_move, rtol=2e-3, atol=2e-3 * np.abs(ref_move).max(), err_msg=name
        )
    # With the fused trace's Function: 8 tiles, each traced in passes 1 and 3.
    calls = _trace.REFERENCE_CALLS
    fused = streamed_placement_step(
        port, FREQUENCY, None, megakernel=True, **placement_for(torch, fields), **chunks
    )
    assert _trace.REFERENCE_CALLS == calls + 2 * 8
    np.testing.assert_allclose(fused[0].numpy(), got[0].numpy(), rtol=1e-4, atol=1e-4)


def test_streamed_loss_target_and_db_map() -> None:
    scene = box_scene()
    port = to_torch_scene(scene)
    rng = np.random.default_rng(5)
    target = rng.uniform(-120.0, -80.0, (1, 24)).astype(np.float32)
    fields = placement_fields(scene, (1, 2), target_power=target)
    chunks = {"candidate_chunk": 16, "rx_chunk": 7}
    got = streamed_placement_loss(port, FREQUENCY, None, **placement_for(torch, fields), **chunks)
    want = jax_streamed_placement_loss(
        scene, FREQUENCY, None, **placement_for(jnp, fields), **chunks
    )
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    db = streamed_placement_loss(
        port, FREQUENCY, None, return_db_map=True, **placement_for(torch, fields), **chunks
    )
    want_db = jax_streamed_placement_loss(
        scene, FREQUENCY, None, return_db_map=True, **placement_for(jnp, fields), **chunks
    )
    assert db.shape == (1, 24)
    np.testing.assert_allclose(db.numpy(), np.asarray(want_db), rtol=0, atol=1e-2)  # dB
    np.testing.assert_allclose(
        float(got), np.mean((db.numpy().astype(np.float64) - target) ** 2), rtol=1e-5
    )
    # The step with a target: the dB mean-squared error and its gradients.
    step = streamed_placement_step(
        port, FREQUENCY, None, **placement_for(torch, fields), **chunks, **UNIT_RATES
    )
    want_step = jax_streamed_placement_step(
        scene, FREQUENCY, None, **placement_for(jnp, fields), **chunks, **UNIT_RATES
    )
    assert_step_matches(step, want_step, fields)


def smoothed_problem():
    scene = box_scene(grid=(5, 3), height=1.45)
    return scene, to_torch_scene(scene), placement_fields(scene, (1,))


def test_smoothed_fd_matches_streamed_gradient() -> None:
    scene, port, fields = smoothed_problem()
    kw = {"candidate_chunk": 16, "rx_chunk": 8, "smoothing_factor": 50.0}
    new_tx, new_eta, loss = streamed_placement_step(
        port, FREQUENCY, None, **placement_for(torch, fields), **kw, **UNIT_RATES
    )
    g = fields["tx"] - new_tx.numpy()
    g_norm = float(np.linalg.norm(g))
    assert np.isfinite(float(loss)) and g_norm > 0.0

    # Small step: the sigmoids put a curvature of about alpha^2 into the loss.
    u = torch.from_numpy(g / g_norm)
    h = 5e-4
    probe = {k: v for k, v in placement_for(torch, fields).items() if k != "tx"}
    tx0 = torch.from_numpy(fields["tx"])
    plus = streamed_placement_loss(port, FREQUENCY, None, tx=tx0 + h * u, **probe, **kw)
    minus = streamed_placement_loss(port, FREQUENCY, None, tx=tx0 - h * u, **probe, **kw)
    np.testing.assert_allclose(float(plus - minus) / (2.0 * h), g_norm, rtol=0.05)

    want = jax_streamed_placement_step(
        scene, FREQUENCY, None, **placement_for(jnp, fields), **kw, **UNIT_RATES
    )
    assert_step_matches((new_tx, new_eta, loss), want, fields)


def test_smoothed_mask_reaches_amplitudes() -> None:
    """Soft confidences weight the amplitudes: they are not thresholded away."""
    scene, port, fields = smoothed_problem()
    kw = placement_for(torch, fields)
    maps = {
        alpha: coverage.power_map_chunked(
            port, FREQUENCY, path_candidates=kw["path_candidates"], eta_r=kw["eta_r"],
            conductivity=kw["conductivity"], candidate_chunk=16, rx_chunk=8,
            smoothing_factor=alpha,
        )
        for alpha in (None, 2000.0, 50.0)
    }
    assert all(torch.isfinite(m).all() for m in maps.values())
    # A sharp sigmoid gives the hard masks' map on the interior pixels (a
    # receiver near a wall rightly reads as partly blocked: the blockage
    # window lives in the absolute ray parameter t).
    soft = maps[2000.0].reshape(3, 5)[1:-1, 1:-1].numpy()
    hard = maps[None].reshape(3, 5)[1:-1, 1:-1].numpy()
    np.testing.assert_allclose(soft, hard, rtol=0.25, atol=1e-14)
    assert not np.allclose(maps[50.0].numpy(), maps[None].numpy(), rtol=0.01, atol=0.0)
    for alpha in (2000.0, 50.0):
        jkw = placement_for(jnp, fields)
        want = jax_power_map_chunked(
            scene, FREQUENCY, path_candidates=jkw["path_candidates"], eta_r=jkw["eta_r"],
            conductivity=jkw["conductivity"], candidate_chunk=16, rx_chunk=8,
            smoothing_factor=alpha,
        )
        np.testing.assert_allclose(
            maps[alpha].numpy(), np.asarray(want), rtol=2e-3, atol=1e-3 * float(np.max(want))
        )


def test_smoothed_power_map_chunked_gradient_is_finite() -> None:
    _, port, fields = smoothed_problem()
    kw = placement_for(torch, fields)
    tx = kw["tx"].clone().requires_grad_()
    eta = kw["eta_r"].clone().requires_grad_()
    sigma = kw["conductivity"].clone().requires_grad_()
    vertices = port.mesh.vertices.clone().requires_grad_()
    s = dataclasses.replace(
        port, transmitters=tx, mesh=dataclasses.replace(port.mesh, vertices=vertices)
    )
    power = coverage.power_map_chunked(
        s, FREQUENCY, order=1, eta_r=eta, conductivity=sigma, candidate_chunk=4, rx_chunk=8,
        smoothing_factor=50.0, batch_size=3,
    )
    loss = -torch.mean(10.0 * torch.log10(torch.clamp(power, min=1e-30)))
    for name, g in zip(
        ("tx", "eta_r", "conductivity", "vertices"),
        torch.autograd.grad(loss, (tx, eta, sigma, vertices)),
    ):
        assert torch.isfinite(g).all() and g.abs().max() > 0.0, name


def test_training_step_matches_jax_on_the_device_mesh() -> None:
    scene = box_scene()
    port = to_torch_scene(scene)
    target = np.random.default_rng(9).uniform(-110.0, -70.0, (1, 4, 6)).astype(np.float32)
    eta0, sigma = np.array([7.24], np.float32), np.array([0.1], np.float32)
    want_eta, want_loss = jax_training_step(
        scene, FREQUENCY, make_device_mesh(), order=1, eta_r=jnp.asarray(eta0),
        conductivity=jnp.asarray(sigma), target_power=jnp.asarray(target), learning_rate=1.0,
    )
    new_eta, loss = training_step(
        port, FREQUENCY, None, order=1, eta_r=torch.from_numpy(eta0),
        conductivity=torch.from_numpy(sigma), target_power=torch.from_numpy(target),
        learning_rate=1.0,
    )
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(
        (eta0 - new_eta.numpy()), (eta0 - np.asarray(want_eta)), rtol=2e-3
    )
    # One step descends.
    _, loss1 = training_step(
        port, FREQUENCY, None, order=1, eta_r=eta0 - 1e-4 * (eta0 - new_eta.numpy()),
        conductivity=torch.from_numpy(sigma), target_power=torch.from_numpy(target),
    )
    assert float(loss1) <= float(loss)


@pytest.mark.parametrize("with_target", [False, True], ids=["coverage", "target"])
def test_placement_training_step_matches_jax_on_the_device_mesh(with_target: bool) -> None:
    scene = box_scene()
    port = to_torch_scene(scene)
    target = None
    if with_target:
        target = np.random.default_rng(9).uniform(-110.0, -70.0, (1, 4, 6)).astype(np.float32)
    fields = placement_fields(scene, (1,), target_power=target)
    del fields["path_candidates"]
    want = jax_placement_training_step(
        scene, FREQUENCY, make_device_mesh(), order=1, **placement_for(jnp, fields), **UNIT_RATES
    )
    got = placement_training_step(
        port, FREQUENCY, None, order=1, **placement_for(torch, fields), **UNIT_RATES
    )
    assert_step_matches(got, want, fields)
