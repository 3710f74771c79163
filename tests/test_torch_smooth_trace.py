"""Parity of the port's sigmoid-smoothed trace with the JAX package.

``trace_path_candidates`` with a ``smoothing_factor``, orders 0 to 2, with
and without quads and a mesh mask: confidences and their gradients against
the JAX package on the same numpy inputs, on the CPU. The JAX side runs
without jit where an ulp matters (see the tests).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt_tpu.geometry import Mesh as JaxMesh
from differt_tpu.geometry import Scene as JaxScene
from differt_tpu.geometry import generate_all_path_candidates
from differt_tpu.rt import trace_path_candidates as jax_trace_path_candidates
from differt_tpu_torch.rt import trace_path_candidates
from differt_tpu_torch.rt._solvers import _segment_endpoint_ids, own_mirror_tile

from .torch_parity import to_torch_scene

torch.set_num_threads(1)

ALPHA = 50.0


def _t(x, grad: bool = False) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


def _close(got, want, *, rtol=1e-5, atol=1e-5) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def asym_scene(*, quads: bool = False, masked: bool = False) -> JaxScene:
    """A box with the TX and the receivers off every symmetry plane.

    On a symmetric box the reflection points fall on the quads' diagonals
    and the faces' edges, where a sigmoid rightly reads 0.5 and the checks
    tie: the scene of ``tests/test_parallel.py::asym_scene``.
    """
    mesh = JaxMesh.box(length=80.0, width=30.0, height=20.0, with_top=False)
    mesh = mesh.set_materials("Concrete")
    if quads:
        mesh = mesh.set_assume_quads()
    if masked:
        mesh = mesh.set_mask(jnp.ones(mesh.num_triangles, dtype=bool).at[2:4].set(False))
    scene = JaxScene(transmitters=jnp.array([[-19.3, 1.7, 5.4], [11.0, -4.2, 3.1]]), mesh=mesh)
    return scene.with_receivers_grid(5, 3, height=1.45)


@pytest.mark.parametrize("order", [0, 1, 2])
@pytest.mark.parametrize(("quads", "masked"), [(False, False), (True, False), (False, True), (True, True)])
def test_smoothed_trace_matches_jax(quads: bool, masked: bool, order: int) -> None:
    scene = asym_scene(quads=quads, masked=masked)
    port = to_torch_scene(scene)
    candidates = np.asarray(generate_all_path_candidates(scene.mesh.num_primitives, order))
    if quads:
        candidates = 2 * candidates
    kw = {"smoothing_factor": ALPHA, "batch_size": 5}
    # Without jit: XLA's fused multiply-adds move a coordinate of 40 m by an
    # ulp (4e-6), which a slope of 50 turns into 5e-5 of confidence.
    with jax.disable_jit():
        want = jax_trace_path_candidates(
            scene.mesh,
            scene.transmitters.reshape(-1, 3),
            scene.receivers.reshape(-1, 3),
            jnp.asarray(candidates),
            **kw,
        )
    got = trace_path_candidates(
        port.mesh,
        port.transmitters.reshape(-1, 3),
        port.receivers.reshape(-1, 3),
        torch.from_numpy(candidates.copy()),
        **kw,
    )
    assert got.mask.dtype == torch.float32
    np.testing.assert_allclose(got.mask.numpy(), np.asarray(want.mask), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.valid_mask.numpy(), np.asarray(want.valid_mask))
    assert got.num_valid_paths == int(want.num_valid_paths) > 0
    valid = got.valid_mask.numpy()
    np.testing.assert_allclose(
        got.vertices.numpy()[valid], np.asarray(want.vertices)[valid], rtol=0, atol=1e-4
    )
    np.testing.assert_array_equal(got.objects.numpy(), np.asarray(want.objects))
    if order:
        # The own-mirror exclusion: bounce paths keep a confidence above the
        # threshold (counting their own mirrors as half-blockers would
        # clip every bounce path's blockage to 1).
        assert float(got.mask.max()) > 0.9
    hard = trace_path_candidates(
        port.mesh,
        port.transmitters.reshape(-1, 3),
        port.receivers.reshape(-1, 3),
        torch.from_numpy(candidates.copy()),
    )
    assert hard.mask.dtype == torch.bool and hard.confidence_threshold == 0.5
    assert torch.equal(hard.valid_mask, hard.mask)


@pytest.mark.parametrize("order", [1, 2])
def test_smoothed_trace_gradients_match_jax(order: int) -> None:
    scene = asym_scene()
    port = to_torch_scene(scene)
    candidates = np.asarray(generate_all_path_candidates(scene.mesh.num_primitives, order))
    tx = np.asarray(scene.transmitters).reshape(-1, 3)
    rx = np.asarray(scene.receivers).reshape(-1, 3)

    def jax_loss(tx_, rx_):
        paths = jax_trace_path_candidates(
            scene.mesh, tx_, rx_, jnp.asarray(candidates), smoothing_factor=ALPHA
        )
        return paths.mask.sum()

    # Without jit, as above: at order 2 an ulp decides which of two nearly
    # equal confidences is the minimum at one receiver, and with it 2 of
    # the gradient's 45 entries.
    with jax.disable_jit():
        want = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(tx), jnp.asarray(rx))
    tx_t, rx_t = _t(tx, grad=True), _t(rx, grad=True)
    paths = trace_path_candidates(
        port.mesh, tx_t, rx_t, torch.from_numpy(candidates.copy()), smoothing_factor=ALPHA
    )
    grads = torch.autograd.grad(paths.mask.sum(), (tx_t, rx_t))
    for g, w in zip(grads, want):
        assert np.isfinite(g.numpy()).all() and np.abs(np.asarray(w)).max() > 0
        _close(g, w, rtol=1e-3, atol=1e-4 * float(np.abs(np.asarray(w)).max()))


@pytest.mark.parametrize("quads", [False, True])
@pytest.mark.parametrize("tile", [1, 3, 4, 10])
def test_own_mirror_mask_by_tiles_equals_the_dense_one(tile: int, quads: bool) -> None:
    # The dense [C, order + 1, T] mask as the JAX package builds it.
    k = 2 if quads else 1
    num_triangles, order = 10, 2
    candidates = np.asarray(generate_all_path_candidates(num_triangles // k, order))
    if quads:
        candidates = np.repeat(2 * candidates, 2, axis=-1)
        candidates[..., 1::2] += 1
    pc = candidates.reshape(-1, order, k)
    none = np.full((pc.shape[0], 1, k), -1, dtype=pc.dtype)
    endpoint_ids = np.concatenate(
        (np.concatenate((none, pc), axis=1), np.concatenate((pc, none), axis=1)), axis=-1
    )
    dense = (endpoint_ids[..., None] == np.arange(num_triangles)).any(axis=-2)
    ids = _segment_endpoint_ids(torch.from_numpy(candidates.copy()), order, k)
    np.testing.assert_array_equal(ids.numpy(), endpoint_ids)
    tiles = [
        own_mirror_tile(ids, lo, min(lo + tile, num_triangles))
        for lo in range(0, num_triangles, tile)
    ]
    np.testing.assert_array_equal(torch.cat(tiles, dim=-1).numpy(), dense)
    # First segment: its end mirror only; last: its start mirror only.
    assert dense[:, 0].sum(axis=-1).tolist() == [k] * len(candidates)
    assert dense[:, 1].sum(axis=-1).tolist() == [2 * k] * len(candidates)


def test_fused_kernel_refuses_smoothing() -> None:
    port = to_torch_scene(asym_scene())
    with pytest.raises(ValueError, match="hard masks only"):
        port.trace_paths(order=1, smoothing_factor=ALPHA, megakernel=True)
    paths = port.trace_paths(order=1, smoothing_factor=ALPHA)  # megakernel=None: unfused
    assert paths.mask.dtype == torch.float32 and paths.shape == (2, 3, 5, 10)
