"""The PyTorch tutorial (``docs/tutorials/torch_cityscale_optimization.md``) as a doctest, and its
sections 3 and 4 held against the JAX package on the JAX package's ``urban_scene(6, 6)``.

The JAX city crosses over through ``interop``; both packages get the same
receivers and candidates (the tutorial's rules, applied once with numpy).
Tolerances: the map within 0.1 dB on the pixels within 40 dB of the JAX
map's peak (``chip_smoke.db_error``'s rule); the streamed step's loss
``rtol 1e-5`` and gradients ``rtol 2e-3``, as ``tests/test_torch_parallel.py``
holds the streamed step.
"""

import doctest
import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from differt_tpu import treekit as tk
from differt_tpu.coverage import power_map_chunked as jax_power_map_chunked
from differt_tpu.parallel import streamed_placement_step as jax_streamed_placement_step
from differt_tpu.scenes import urban_scene as jax_urban_scene
from differt_tpu_torch.coverage import power_map_chunked
from differt_tpu_torch.geometry import generate_path_candidates
from differt_tpu_torch.parallel import streamed_placement_step

from .test_torch_parallel import assert_step_matches
from .torch_parity import assert_maps_close, placement_for, to_torch_scene

torch.set_num_threads(1)

TUTORIAL = Path(__file__).resolve().parents[1] / "docs" / "tutorials" / "torch_cityscale_optimization.md"
FREQUENCY = 2.4e9
MATERIALS = {"eta_r": np.array([5.24], np.float32), "conductivity": np.array([0.12], np.float32)}


def test_tutorial_runs_as_a_doctest() -> None:
    result = doctest.testfile(
        str(TUTORIAL), module_relative=False, optionflags=doctest.ELLIPSIS | doctest.NORMALIZE_WHITESPACE
    )
    assert result.attempted > 0 and result.failed == 0


def street_grid(n: int) -> np.ndarray:
    """The tutorial's receivers: an ``n`` x ``n`` grid at 1.5 m over the four blocks around the TX."""
    xs = np.linspace(-60.0, 60.0, n, dtype=np.float32)
    x, y = np.meshgrid(xs, xs, indexing="xy")
    return np.stack((x, y, np.full_like(x, 1.5)), axis=-1)


@functools.cache
def jax_city(grid: int):
    """The JAX package's toy city of the tutorial, the TX at (0, 0, 40 m), ``grid`` x ``grid`` receivers."""
    scene = jax_urban_scene(6, 6)
    scene = tk.tree_at(lambda s: s.transmitters, scene, jnp.array([[0.0, 0.0, 40.0]]))
    return tk.tree_at(lambda s: s.receivers, scene, jnp.asarray(street_grid(grid)))


def near_pairs(scene) -> np.ndarray:
    """Section 3's candidates: the ordered pairs of the 14 triangles nearest the TX and the ground's two."""
    num = int(scene.mesh.num_triangles)
    centres = np.asarray(scene.mesh.triangle_vertices).mean(axis=1)
    near = np.argsort(np.linalg.norm(centres[:, :2], axis=-1), kind="stable")[:14]
    picked = np.concatenate((near, [num - 2, num - 1]))
    pairs = np.stack(np.meshgrid(picked, picked, indexing="ij"), axis=-1).reshape(-1, 2)
    return pairs[pairs[:, 0] != pairs[:, 1]]


def test_section_3_map_matches_jax() -> None:
    scene = jax_city(16)
    pairs = near_pairs(scene)
    assert pairs.shape == (240, 2)
    chunks = {"candidate_chunk": 128, "rx_chunk": 128}
    want = jax_power_map_chunked(
        scene, FREQUENCY, path_candidates=jnp.asarray(pairs), **placement_for(jnp, MATERIALS), **chunks
    )
    got = power_map_chunked(
        to_torch_scene(scene), FREQUENCY, path_candidates=torch.from_numpy(pairs),
        **placement_for(torch, MATERIALS), **chunks,
    )
    assert got.shape == (1, 16, 16)
    assert int((np.asarray(want) > 0).sum()) > 0  # the order-2 pairs light some pixels
    assert_maps_close(got.numpy(), np.asarray(want), window_db=40.0, tol_db=0.1)


def test_section_4_step_matches_jax() -> None:
    """Section 4's step on an 8 x 8 grid. Its 256 order-2 candidates (the
    decode's first rows) light no receiver there: the port's step is the
    same bit for bit without them, so the JAX step runs on the order-1
    candidates alone and compiles one order's tile programs, not two
    (``tests/test_torch_parallel.py`` holds both orders together)."""
    scene = jax_city(8)
    port = to_torch_scene(scene)
    num = int(scene.mesh.num_triangles)
    order1 = generate_path_candidates(num, 1, device="cpu").numpy()
    order2 = generate_path_candidates(num, 2, size=256, device="cpu").numpy()
    fields = {"tx": np.asarray(scene.transmitters).reshape(-1, 3), **MATERIALS, "path_candidates": [order1]}
    kw = {"candidate_chunk": 512, "rx_chunk": 256, "tx_learning_rate": 1.0, "eta_learning_rate": 1.0}
    got = streamed_placement_step(
        port, FREQUENCY, None, **placement_for(torch, {**fields, "path_candidates": [order1, order2]}), **kw
    )
    alone = streamed_placement_step(port, FREQUENCY, None, **placement_for(torch, fields), **kw)
    for name, a, b in zip(("tx", "eta_r", "loss"), got, alone):
        assert torch.equal(a, b), name
    want = jax_streamed_placement_step(scene, FREQUENCY, None, **placement_for(jnp, fields), **kw)
    assert torch.isfinite(got[2])
    assert_step_matches(got, want, fields)
