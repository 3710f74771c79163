"""The fused trace above order 2 against the JAX package, and the auto rule's bound on the order.

The street canyon's walls face each other across the street (triangles 0,
1 at y = -10 and 16, 17 at y = +10): the chains that alternate between
them reach every receiver in the street at every order, so each order's
candidates are those chains plus a strided shard of the rest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt_tpu import scenes as jax_scenes
from differt_tpu.geometry import Mesh as JaxMesh
from differt_tpu.geometry import Scene as JaxScene
from differt_tpu.ops._pallas_trace import _xla_trace_vertices, pallas_trace_specular
from differt_tpu.rt import trace_path_candidates as jax_trace_path_candidates
from differt_tpu_torch import ops
from differt_tpu_torch.ops import _trace
from differt_tpu_torch.rt import trace_path_candidates

from .test_torch_trace import assert_paths_match
from .torch_parity import EPSILON, HIT_TOL, canyon_candidates, street_chains, to_torch_scene

torch.set_num_threads(1)

KW = {"epsilon": EPSILON, "hit_tol": HIT_TOL, "min_len": EPSILON}
RX = [[-10.0, -3.0, 1.5], [10.0, 4.0, 1.5], [35.0, 0.5, 1.5]]


def canyon(quads: bool = False) -> JaxScene:
    mesh = jax_scenes.street_canyon_scene().mesh
    if quads:
        mesh = mesh.set_assume_quads()
    return JaxScene(
        transmitters=jnp.array([[-30.0, 0.0, 20.0]]), receivers=jnp.array(RX), mesh=mesh
    )


def kernel_inputs(scene: JaxScene, cands: np.ndarray) -> dict:
    """The fused kernel's inputs as numpy arrays, prepared as the trace prepares them."""
    mesh = scene.mesh
    k = 2 if mesh.assume_quads else 1
    if mesh.assume_quads:
        cands = np.repeat(2 * cands, 2, axis=-1)
        cands[..., 1::2] += 1
    cand_tv = np.asarray(mesh.vertices)[np.asarray(mesh.triangles)[cands]]
    return {
        "tx": np.asarray(scene.transmitters).reshape(-1, 3),
        "rx": np.asarray(scene.receivers).reshape(-1, 3),
        "mv": np.ascontiguousarray(cand_tv[:, ::k, 0, :]),
        "mn": np.asarray(mesh.normals)[cands[:, ::k]],
        "ct": cand_tv,
        "tv": np.asarray(mesh.triangle_vertices),
        "active": None,
    }


CASES = {
    "order3": (3, False),
    "order4": (4, False),
    "order5": (5, False),
    "order6": (6, False),
    "quads5": (5, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_trace_reference_matches_pallas(case: str) -> None:
    order, quads = CASES[case]
    scene = canyon(quads)
    inputs = kernel_inputs(scene, canyon_candidates(order, quads))
    verts, mask = _trace.trace_specular_reference(
        *[None if a is None else torch.from_numpy(np.array(a)) for a in inputs.values()],
        order=order,
        **KW,
    )
    want_verts, want_mask = pallas_trace_specular(
        *[None if a is None else jnp.asarray(a) for a in inputs.values()], order=order, **KW
    )
    assert tuple(verts.shape) == want_verts.shape
    assert_paths_match(mask, verts.numpy(), want_mask, want_verts)


@pytest.mark.parametrize("megakernel", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_trace_path_candidates_matches_jax_pipeline(case: str, megakernel: bool) -> None:
    """The port's fused contract (its plain version here) and unfused pipeline against the
    JAX package's unfused pipeline."""
    order, quads = CASES[case]
    scene = canyon(quads)
    cands = canyon_candidates(order, quads) * (2 if quads else 1)
    ours = to_torch_scene(scene)
    want = jax_trace_path_candidates(
        scene.mesh,
        scene.transmitters,
        scene.receivers,
        jnp.asarray(cands),
        jnp.zeros(cands.shape, dtype=jnp.int32),
        megakernel=False,
    )
    calls = _trace.REFERENCE_CALLS
    got = trace_path_candidates(
        ours.mesh,
        ours.transmitters,
        ours.receivers,
        torch.from_numpy(cands),
        torch.zeros(cands.shape, dtype=torch.int32),
        megakernel=megakernel,
    )
    assert _trace.REFERENCE_CALLS == calls + megakernel
    assert got.shape == want.shape
    assert_paths_match(got.mask, got.vertices.numpy(), want.mask, want.vertices)
    np.testing.assert_array_equal(got.objects.numpy(), np.asarray(want.objects))


def two_walls() -> JaxScene:
    """Two facing walls and the ground (6 triangles): every order-5 candidate, 3,750 of them."""
    mesh = (
        JaxMesh.plane(jnp.array([0.0, -8.0, 10.0]), normal=jnp.array([0.0, 1.0, 0.0]), side_length=60.0)
        + JaxMesh.plane(jnp.array([0.0, 8.0, 10.0]), normal=jnp.array([0.0, -1.0, 0.0]), side_length=60.0)
        + JaxMesh.plane(jnp.array([0.0, 0.0, 0.0]), normal=jnp.array([0.0, 0.0, 1.0]), side_length=60.0)
    )
    return JaxScene(
        transmitters=jnp.array([[-20.0, 1.0, 12.0]]),
        receivers=jnp.array([[15.0, -2.0, 1.5], [5.0, 3.0, 2.0]]),
        mesh=mesh,
    )


def test_scene_trace_paths_order_5_matches_jax() -> None:
    ref = two_walls()
    ours = to_torch_scene(ref)
    want = ref.trace_paths(order=5)
    got = ours.trace_paths(order=5, megakernel=True)  # the fused contract, plain on the CPU
    assert got.shape == want.shape == (1, 2, 3750)
    assert_paths_match(got.mask, got.vertices.numpy(), want.mask, want.vertices)
    np.testing.assert_array_equal(got.objects.numpy(), np.asarray(want.objects))
    unfused = ours.trace_paths(order=5, megakernel=False)
    assert torch.equal(unfused.mask, got.mask)


def test_trace_vertices_gradient_at_order_5_matches_jax() -> None:
    """The fused trace's backward recompute, pulled back at order 5, against JAX's ``_xla_trace_vertices`` VJP."""
    scene = canyon()
    inputs = kernel_inputs(scene, canyon_candidates(5))
    args = [inputs[k] for k in ("tx", "rx", "mv", "mn")]
    rng = np.random.default_rng(5)
    cot = rng.standard_normal((1, len(inputs["mv"]), len(RX), 7, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: _xla_trace_vertices(*a, 5), *map(jnp.asarray, args))
    want = vjp(jnp.asarray(cot))
    leaves = [torch.from_numpy(np.array(a)).requires_grad_() for a in args]
    verts = _trace.trace_vertices(*leaves)
    got = torch.autograd.grad(verts, leaves, torch.from_numpy(cot))
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


def _length_gradients(scene, cands: torch.Tensor, megakernel: bool):
    tx = scene.transmitters.clone().requires_grad_()
    rx = scene.receivers.clone().requires_grad_()
    paths = trace_path_candidates(scene.mesh, tx, rx, cands, megakernel=megakernel)
    seg = paths.vertices[..., 1:, :] - paths.vertices[..., :-1, :]
    # The unfused pipeline zeroes impossible paths: a segment of length 0 needs the 1e-12.
    lengths = torch.sqrt((seg * seg).sum(dim=-1) + 1e-12).sum(dim=-1)
    total = torch.where(paths.mask, lengths, 0.0).sum()
    return paths.mask, torch.autograd.grad(total, (tx, rx))


def test_fused_function_gradient_at_order_5() -> None:
    """``_TraceSpecular``'s backward at order 5 equals the unfused pipeline's direct autograd."""
    ours = to_torch_scene(canyon())
    cands = torch.from_numpy(canyon_candidates(5))
    mask, fused = _length_gradients(ours, cands, True)
    want_mask, unfused = _length_gradients(ours, cands, False)
    assert torch.equal(mask, want_mask) and int(mask.sum()) > 0
    for got, want in zip(fused, unfused, strict=True):
        assert torch.isfinite(got).all() and float(want.abs().max()) > 0.0
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("order", [1, 2, 3])
def test_auto_rule_takes_the_kernel_only_up_to_its_cap(order: int, monkeypatch) -> None:
    """On the "cuda" backend the auto rule hands orders above ``MAX_ORDER`` to the unfused pipeline."""
    ours = to_torch_scene(canyon())
    cands = torch.from_numpy(canyon_candidates(order))
    monkeypatch.setattr(ops, "get_backend", lambda device=None: "cuda")
    monkeypatch.setattr(_trace, "MAX_ORDER", 2)
    calls = _trace.REFERENCE_CALLS
    got = trace_path_candidates(ours.mesh, ours.transmitters, ours.receivers, cands)
    assert _trace.REFERENCE_CALLS == calls + (order <= 2)  # the fused contract: its plain version here
    want = trace_path_candidates(ours.mesh, ours.transmitters, ours.receivers, cands, megakernel=False)
    assert torch.equal(got.mask, want.mask) and int(got.mask.sum()) > 0


def test_megakernel_above_the_cap_raises(monkeypatch) -> None:
    ours = to_torch_scene(canyon())
    monkeypatch.setattr(_trace, "MAX_ORDER", 2)
    cands = torch.from_numpy(street_chains(3))
    with pytest.raises(ValueError, match="orders 1 to 2, not 3"):
        trace_path_candidates(ours.mesh, ours.transmitters, ours.receivers, cands, megakernel=True)
