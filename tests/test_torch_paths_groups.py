"""Parity of the port's path grouping and reductions (``geometry/_paths.py``) with the JAX package.

Group ids must equal the JAX package's exactly (each group numbered by its
first row); masks exactly; reductions allclose in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt_tpu.geometry import TracedPaths as JaxTracedPaths
from differt_tpu.geometry import merge_cell_ids as jax_merge_cell_ids
from differt_tpu.geometry._paths import _group_index as jax_group_index
from differt_tpu_torch.geometry import TracedPaths, merge_cell_ids
from differt_tpu_torch.geometry._paths import _group_index

from . import torch_parity  # noqa: F401 (warms the CPU math)

torch.set_num_threads(1)


def both_paths(mask: np.ndarray, seed: int = 0, shape=(2, 3, 40), order: int = 2):
    """Random paths with many repeated object sequences, in both containers."""
    rng = np.random.default_rng(seed)
    objects = rng.integers(0, 3, (*shape, order + 2)).astype(np.int32)
    vertices = rng.normal(size=(*shape, order + 2, 3)).astype(np.float32)
    types = np.zeros((*shape, order), np.int32)
    ref = JaxTracedPaths(
        vertices=jnp.asarray(vertices), objects=jnp.asarray(objects), mask=jnp.asarray(mask),
        interaction_types=jnp.asarray(types),
    )
    port = TracedPaths(
        torch.from_numpy(vertices), torch.from_numpy(objects).to(torch.int64),
        mask=torch.from_numpy(mask), interaction_types=torch.from_numpy(types),
    )
    return ref, port


def masks(shape=(2, 3, 40)):
    rng = np.random.default_rng(11)
    return {"bool": rng.random(shape) < 0.6, "float": rng.random(shape).astype(np.float32)}


@pytest.mark.parametrize(("num_rows", "width", "values"), [(0, 3, 2), (5, 1, 2), (300, 4, 3), (257, 6, 2)])
@pytest.mark.parametrize("dtype", ["int", "bool"])
def test_group_index_matches_jax(num_rows: int, width: int, values: int, dtype: str) -> None:
    rows = np.random.default_rng(num_rows).integers(0, values, (num_rows, width))
    rows = rows.astype(bool) if dtype == "bool" else rows.astype(np.int32)
    got = _group_index(torch.from_numpy(rows))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_group_index(jnp.asarray(rows))))


@pytest.mark.parametrize(("shape_a", "shape_b"), [((50,), (50,)), ((4, 30), (30,)), ((6, 1), (1, 7))])
def test_merge_cell_ids_matches_jax(shape_a, shape_b) -> None:
    rng = np.random.default_rng(len(shape_a) + shape_b[-1])
    a = rng.integers(0, 3, shape_a).astype(np.int32)
    b = rng.integers(0, 4, shape_b).astype(np.int32)
    got = merge_cell_ids(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_merge_cell_ids(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("kind", ["bool", "float"])
def test_group_by_objects_and_multipath_cells_match_jax(kind: str) -> None:
    ref, port = both_paths(masks()[kind])
    np.testing.assert_array_equal(port.group_by_objects().numpy(), np.asarray(ref.group_by_objects()))
    for axis in (-1, 0, 1):
        got = port.multipath_cells(axis)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref.multipath_cells(axis)))
    # Some receivers share a pattern once the mask is coarse.
    coarse = TracedPaths(port.vertices, port.objects, mask=port.valid_mask[..., :2], interaction_types=port.interaction_types)
    assert len(set(coarse.multipath_cells().reshape(-1).tolist())) < 6


@pytest.mark.parametrize("kind", ["bool", "float"])
@pytest.mark.parametrize("axis", [-1, 0, 2])
def test_mask_duplicate_objects_matches_jax(kind: str, axis: int) -> None:
    ref, port = both_paths(masks()[kind])
    got = port.mask_duplicate_objects(axis)
    want = ref.mask_duplicate_objects(axis)
    assert got.mask.dtype == port.mask.dtype
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert torch.equal(got.objects, port.objects)
    with pytest.raises(ValueError, match="out-of-bounds"):
        port.mask_duplicate_objects(3)


@pytest.mark.parametrize("kind", ["bool", "float"])
@pytest.mark.parametrize("axis", [None, -1, (0, 2)])
def test_reduce_matches_jax(kind: str, axis) -> None:
    mask = masks()[kind]
    ref, port = both_paths(mask)
    if kind == "bool":
        # Invalid paths may hold NaN: a bool mask drops them with `where`.
        vertices = port.vertices.clone()
        vertices[~port.mask] = torch.nan
        port = TracedPaths(vertices, port.objects, mask=port.mask, interaction_types=port.interaction_types)
        ref = JaxTracedPaths(
            vertices=jnp.asarray(vertices.numpy()), objects=ref.objects, mask=ref.mask,
            interaction_types=ref.interaction_types,
        )
    got = port.reduce(lambda v: (v**2).sum(dim=(-2, -1)), axis=axis)
    with jax.debug_nans(False):
        want = ref.reduce(lambda v: (v**2).sum(axis=(-2, -1)), axis=axis)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    if kind == "float":
        weights = torch.from_numpy(mask).requires_grad_()
        paths = TracedPaths(port.vertices, port.objects, mask=weights, interaction_types=port.interaction_types)
        (grad,) = torch.autograd.grad(paths.reduce(lambda v: v[..., 0, 0]), weights)
        assert torch.equal(grad, port.vertices[..., 0, 0])
