"""The port's device-mesh forms (``differt_tpu_torch.parallel``) against the JAX package's.

Three gloo ranks on the CPU run every ``parallel`` export in one spawn: an
inline program with JAX made unimportable, one process a rank, which saves
its results for the parent. The parent runs the JAX functions on the
conftest's 8-device mesh, and the port's ``mesh=None`` forms. The box
scene of ``tests/test_torch_parallel.py`` with a 5 x 5 receiver grid: its
25 receivers and 10 order-1 candidates pad on three ranks (to 27 and 12;
the JAX side pads to 32 and 16). Masks equal; maps ``rtol 1e-6`` against
the port's single-device map and ``rtol 1e-3`` against JAX's (whose
sharded map is within its own ``rtol 1e-4`` of its single-device one; the
packages' single-device maps differ by 7.4e-4 at a dip; dB maps ``atol
1e-2`` as in ``tests/test_torch_parallel.py``); vertices ``atol 1e-5``;
losses ``rtol 1e-5`` (``1e-4`` against JAX for a dB target, see
``TARGET_LOSS_RTOL``); gradients ``rtol 2e-3`` against JAX (float32
sums in another order) and ``rtol 1e-5`` against the port's ``mesh=None``;
every rank's results identical. A world of one, in this process, gives
the ``mesh=None`` results bit for bit.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from differt_tpu import coverage as jax_coverage
from differt_tpu import parallel as jax_parallel
from differt_tpu.geometry import Mesh as JaxMesh
from differt_tpu.geometry import Scene as JaxScene
from differt_tpu.geometry import generate_path_candidates as jax_candidates
from differt_tpu_torch import coverage, parallel
from differt_tpu_torch.geometry import generate_path_candidates

from .torch_parity import placement_for, to_torch_scene

torch.set_num_threads(1)

FREQUENCY = 2.4e9
WORLD = 3
CHUNKS = {"candidate_chunk": 4, "rx_chunk": 8}
UNIT_RATES = {"tx_learning_rate": 1.0, "eta_learning_rate": 1.0}
TARGET = np.random.default_rng(9).uniform(-110.0, -70.0, (1, 5, 5)).astype(np.float32)
# The packages' float32 dB maps differ by up to 5e-3 dB a pixel here (orders
# 1 and 2); against a target up to 40 dB away that moves the mean squared
# error by up to 4e-5 of itself. A loss without a target keeps 1e-5.
TARGET_LOSS_RTOL = 1e-4

# One rank: loads the inputs, runs every export on a mesh of all ranks and
# saves what it got. Each rank gets a different tensor to replicate and
# shard, so that rank 0's broadcast and the blocks show.
_WORKER = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import dataclasses
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from differt_tpu_torch import parallel
from differt_tpu_torch.geometry import generate_path_candidates

folder, port, rank, world = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
mesh = parallel.make_device_mesh(device="cpu")
inputs = torch.load(f"{folder}/inputs.pt", weights_only=False)
scene, kw, chunks, rates = inputs["scene"], inputs["placement"], inputs["chunks"], inputs["rates"]
out = {"mesh": (mesh.size, mesh.rank, mesh.axis_names)}

x = torch.arange(24.0).reshape(4, 6) + 100.0 * rank
out["shard_along"] = parallel.shard_along(x, mesh, axis=1)
leaf = torch.tensor([1.0, 2.0, 3.0]) * (rank + 1)
leaf.requires_grad_()
copy, same_scene = parallel.replicate((leaf, scene), mesh)
(grad,) = torch.autograd.grad((copy * (rank + 1)).sum(), leaf)
out["replicate"] = (copy.detach(), grad, torch.equal(same_scene.mesh.vertices, scene.mesh.vertices))

paths = parallel.sharded_trace_paths(scene, 1, mesh)
out["trace"] = (paths.vertices, paths.mask, paths.objects)
out["trace_unsharded"] = parallel.sharded_trace_paths(scene, 1, mesh, shard_candidates=False).mask
out["power_map"] = parallel.sharded_power_map(scene, 2.4e9, mesh, order=1)
tx = kw["tx"].clone().requires_grad_()
power = parallel.sharded_power_map(dataclasses.replace(scene, transmitters=tx), 2.4e9, mesh, order=1)
out["power_map_grad"] = torch.autograd.grad(power.sum(), tx)[0]
out["training_step"] = parallel.training_step(
    scene, 2.4e9, mesh, order=1, eta_r=kw["eta_r"] + 2.0, conductivity=kw["conductivity"],
    target_power=inputs["target"], learning_rate=1.0,
)
whole = {k: v for k, v in kw.items() if k != "path_candidates"}
for name, target in (("placement_coverage", None), ("placement_target", inputs["target"])):
    out[name] = parallel.placement_training_step(
        scene, 2.4e9, mesh, order=1, target_power=target, **whole, **rates
    )
out["streamed_loss"] = parallel.streamed_placement_loss(scene, 2.4e9, mesh, **kw, **chunks)
out["streamed_db_map"] = parallel.streamed_placement_loss(
    scene, 2.4e9, mesh, return_db_map=True, **kw, **chunks
)
out["streamed_step"] = parallel.streamed_placement_step(scene, 2.4e9, mesh, **kw, **chunks, **rates)
out["streamed_target"] = parallel.streamed_placement_step(
    scene, 2.4e9, mesh, target_power=inputs["target"].reshape(1, -1), **kw, **chunks, **rates
)
# A mesh of the first two ranks: a group of its own; the third rank is outside it.
pair = parallel.make_device_mesh(2, device="cpu")
if rank < 2:
    out["pair_power_map"] = parallel.sharded_power_map(scene, 2.4e9, pair, order=1)
else:
    try:
        parallel.sharded_power_map(scene, 2.4e9, pair, order=1)
    except ValueError as error:
        out["pair_power_map"] = str(error)
assert not any(name == "jax" or name.startswith(("jax.", "differt_tpu.")) for name in sys.modules if sys.modules[name] is not None)
torch.save(out, f"{folder}/rank{rank}.pt")
dist.destroy_process_group()
print("ok")
"""


def box_scene() -> JaxScene:
    """``tests/test_torch_parallel.py``'s box with its asymmetric TX and a 5 x 5 grid off the walls.

    (``with_receivers_grid`` would put the outer receivers on the walls,
    where the packages' float32 maps part by more at the dips.)
    """
    mesh = JaxMesh.box(length=80.0, width=30.0, height=20.0, with_top=False)
    x, y = np.meshgrid(np.linspace(-36.0, 36.0, 5), np.linspace(-12.0, 12.0, 5))
    rx = np.stack((x, y, np.full_like(x, 1.5)), axis=-1).astype(np.float32)
    return JaxScene(
        transmitters=jnp.array([[-19.3, 1.7, 5.4]]),
        receivers=jnp.asarray(rx),
        mesh=mesh.set_materials("Concrete"),
    )


def placement_fields(scene: JaxScene) -> dict:
    """Every order-1 candidate and the first 16 of order 2: a coherent sum over two orders."""
    candidates = [
        np.asarray(jax_candidates(scene.mesh.num_primitives, order)).copy()[:16] for order in (1, 2)
    ]
    return {
        "tx": np.asarray(scene.transmitters).reshape(-1, 3),
        "eta_r": np.array([5.24], np.float32),
        "conductivity": np.array([0.1], np.float32),
        "path_candidates": candidates,
    }


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def problem():
    scene = box_scene()
    return scene, to_torch_scene(scene), placement_fields(scene)


@pytest.fixture(scope="module")
def ranks(problem, tmp_path_factory) -> list[dict]:
    """Every rank's results from one spawn of three gloo ranks."""
    _, port_scene, fields = problem
    folder = tmp_path_factory.mktemp("ranks")
    torch.save(
        {
            "scene": port_scene,
            "placement": placement_for(torch, fields),
            "chunks": CHUNKS,
            "rates": UNIT_RATES,
            "target": torch.from_numpy(TARGET),
        },
        folder / "inputs.pt",
    )
    root = Path(__file__).resolve().parents[1]
    port = str(_free_port())
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(folder), port, str(rank), str(WORLD)],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for rank in range(WORLD)
    ]
    outputs = [proc.communicate(timeout=120) for proc in procs]
    for proc, (stdout, stderr) in zip(procs, outputs, strict=True):
        assert proc.returncode == 0 and stdout.strip().endswith("ok"), stderr
    return [torch.load(folder / f"rank{rank}.pt", weights_only=False) for rank in range(WORLD)]


@pytest.fixture
def world_of_one():
    """A mesh of one gloo rank in this process; its group is destroyed at teardown."""
    mesh = parallel.make_device_mesh(1, device="cpu")
    yield mesh
    dist.destroy_process_group()


def _flat(value) -> list[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (tuple, list)):
        return [t for item in value for t in _flat(item)]
    return []


def test_every_rank_returns_the_same_results(ranks) -> None:
    names = set(ranks[0]) - {"mesh", "shard_along", "replicate", "pair_power_map"}
    assert len(names) == 11
    for name in sorted(names):
        for other in ranks[1:]:
            for a, b in zip(_flat(ranks[0][name]), _flat(other[name]), strict=True):
                assert torch.equal(a, b), name
    assert [r["mesh"] for r in ranks] == [(WORLD, rank, ("rx",)) for rank in range(WORLD)]


def test_shard_along_gives_each_rank_its_block_as_jax_places_it(ranks) -> None:
    blocks = [r["shard_along"] for r in ranks]
    assert all(b.shape == (4, 2) for b in blocks)
    jax_mesh = jax_parallel.make_device_mesh(3)
    for rank, block in enumerate(blocks):
        x = np.arange(24.0, dtype=np.float32).reshape(4, 6) + 100.0 * rank
        np.testing.assert_array_equal(block.numpy(), x[:, 2 * rank : 2 * rank + 2])
        shards = jax_parallel.shard_along(jnp.asarray(x), jax_mesh, axis=1).addressable_shards
        np.testing.assert_array_equal(block.numpy(), np.asarray(shards[rank].data))


def test_shard_along_refuses_an_axis_that_does_not_split(world_of_one) -> None:
    wide = parallel.make_device_mesh(1, device="cpu")
    assert parallel.shard_along(torch.arange(5), wide).tolist() == list(range(5))
    # The JAX package refuses too: the callers pad first.
    with pytest.raises(ValueError, match="divisible"):
        jax_parallel.shard_along(jnp.arange(25.0), jax_parallel.make_device_mesh())
    three = dataclasses.replace(world_of_one, size=3)
    with pytest.raises(ValueError, match="pad"):
        parallel.shard_along(torch.arange(25), three)


def test_replicate_broadcasts_rank_0_and_sums_gradients(ranks) -> None:
    for r in ranks:
        copy, grad, scene_equal = r["replicate"]
        assert copy.tolist() == [1.0, 2.0, 3.0] and scene_equal
        # d/dx of sum(copy * (rank + 1)) summed over the ranks: 1 + 2 + 3.
        assert grad.tolist() == [6.0, 6.0, 6.0]


def test_sharded_trace_paths_match_jax(problem, ranks) -> None:
    scene, port_scene, _ = problem
    vertices, mask, objects = ranks[0]["trace"]
    want = jax_parallel.sharded_trace_paths(scene, 1, jax_parallel.make_device_mesh())
    assert mask.shape == (1, 25, 12) and want.mask.shape == (1, 25, 16)
    np.testing.assert_array_equal(mask[..., :10].numpy(), np.asarray(want.mask)[..., :10])
    np.testing.assert_allclose(
        vertices[:, :, :10].numpy(), np.asarray(want.vertices)[:, :, :10], atol=1e-5
    )
    np.testing.assert_array_equal(objects[:, :, :10].numpy(), np.asarray(want.objects)[:, :, :10])
    assert not mask[..., 10:].any() and not np.asarray(want.mask)[..., 10:].any()
    assert mask.any()
    single = port_scene.trace_paths(order=1).reshape(1, 25, 10)
    assert torch.equal(mask[..., :10], single.mask)
    assert torch.equal(ranks[0]["trace_unsharded"], single.mask)


def test_sharded_power_map_matches_jax(problem, ranks) -> None:
    scene, port_scene, _ = problem
    got = ranks[0]["power_map"]
    want = jax_parallel.sharded_power_map(scene, FREQUENCY, jax_parallel.make_device_mesh(), order=1)
    assert got.shape == (1, 5, 5)
    # The JAX package's sharded map equals its single-device one; the two
    # packages' single-device maps differ by up to 7.4e-4 at a pixel of
    # destructive interference here (0.003 dB; their parity tests allow 0.1).
    want_single = jax_coverage.power_map(scene, FREQUENCY, order=1)
    np.testing.assert_allclose(np.asarray(want), np.asarray(want_single), rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3)
    np.testing.assert_allclose(
        got.numpy(), coverage.power_map(port_scene, FREQUENCY, order=1).numpy(), rtol=1e-6
    )


def test_sharded_power_map_gradient_is_whole_on_every_rank(problem, ranks) -> None:
    _, port_scene, fields = problem
    tx = torch.tensor(fields["tx"]).requires_grad_()
    power = coverage.power_map(dataclasses.replace(port_scene, transmitters=tx), FREQUENCY, order=1)
    (want,) = torch.autograd.grad(power.sum(), tx)
    got = ranks[0]["power_map_grad"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def assert_update(got, want, start, rtol) -> None:
    """The gradients (start minus update, at unit rates) within ``rtol``."""
    g, w = start - np.asarray(got), start - np.asarray(want)
    assert np.abs(w).max() > 0.0
    np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * np.abs(w).max())


def test_training_step_matches_jax_and_mesh_none(problem, ranks) -> None:
    scene, port_scene, fields = problem
    new_eta, loss = ranks[0]["training_step"]
    eta0 = fields["eta_r"] + 2.0
    want_eta, want_loss = jax_parallel.training_step(
        scene, FREQUENCY, jax_parallel.make_device_mesh(), order=1, eta_r=jnp.asarray(eta0),
        conductivity=jnp.asarray(fields["conductivity"]), target_power=jnp.asarray(TARGET),
        learning_rate=1.0,
    )
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=TARGET_LOSS_RTOL)
    assert_update(new_eta, want_eta, eta0, 2e-3)
    one_eta, one_loss = parallel.training_step(
        port_scene, FREQUENCY, None, order=1, eta_r=torch.from_numpy(eta0),
        conductivity=torch.from_numpy(fields["conductivity"]), target_power=torch.from_numpy(TARGET),
        learning_rate=1.0,
    )
    np.testing.assert_allclose(float(loss), float(one_loss), rtol=1e-5)
    assert_update(new_eta, one_eta, eta0, 1e-5)


@pytest.mark.parametrize("with_target", [False, True], ids=["coverage", "target"])
def test_placement_training_step_matches_jax_and_mesh_none(problem, ranks, with_target) -> None:
    scene, port_scene, fields = problem
    got = ranks[0]["placement_target" if with_target else "placement_coverage"]
    target = TARGET if with_target else None
    whole = {k: v for k, v in fields.items() if k != "path_candidates"}
    want = jax_parallel.placement_training_step(
        scene, FREQUENCY, jax_parallel.make_device_mesh(), order=1, target_power=target,
        **placement_for(jnp, whole), **UNIT_RATES,
    )
    one = parallel.placement_training_step(
        port_scene, FREQUENCY, None, order=1,
        target_power=None if target is None else torch.from_numpy(target),
        **placement_for(torch, whole), **UNIT_RATES,
    )
    loss_rtol = TARGET_LOSS_RTOL if with_target else 1e-5
    for ref, rtol, loss_rtol in ((want, 2e-3, loss_rtol), (one, 1e-5, 1e-5)):
        np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=loss_rtol)
        assert_update(got[0], ref[0], fields["tx"], rtol)
        assert_update(got[1], ref[1], fields["eta_r"], rtol)


def test_streamed_placement_loss_matches_jax_and_mesh_none(problem, ranks) -> None:
    scene, port_scene, fields = problem
    jax_mesh = jax_parallel.make_device_mesh()
    want = jax_parallel.streamed_placement_loss(
        scene, FREQUENCY, jax_mesh, **placement_for(jnp, fields), **CHUNKS
    )
    want_db = jax_parallel.streamed_placement_loss(
        scene, FREQUENCY, jax_mesh, return_db_map=True, **placement_for(jnp, fields), **CHUNKS
    )
    one_db = parallel.streamed_placement_loss(
        port_scene, FREQUENCY, None, return_db_map=True, **placement_for(torch, fields), **CHUNKS
    )
    np.testing.assert_allclose(float(ranks[0]["streamed_loss"]), float(want), rtol=1e-5)
    db = ranks[0]["streamed_db_map"]
    assert db.shape == (1, 25)
    np.testing.assert_allclose(db.numpy(), np.asarray(want_db), rtol=0, atol=1e-2)  # dB
    np.testing.assert_allclose(db.numpy(), one_db.numpy(), rtol=1e-6)


@pytest.mark.parametrize("with_target", [False, True], ids=["coverage", "target"])
def test_streamed_placement_step_matches_jax_and_mesh_none(problem, ranks, with_target) -> None:
    scene, port_scene, fields = problem
    got = ranks[0]["streamed_target" if with_target else "streamed_step"]
    target = {"target_power": TARGET.reshape(1, -1)} if with_target else {}
    want = jax_parallel.streamed_placement_step(
        scene, FREQUENCY, jax_parallel.make_device_mesh(), **placement_for(jnp, fields),
        **{k: jnp.asarray(v) for k, v in target.items()}, **CHUNKS, **UNIT_RATES,
    )
    one = parallel.streamed_placement_step(
        port_scene, FREQUENCY, None, **placement_for(torch, fields),
        **{k: torch.from_numpy(v) for k, v in target.items()}, **CHUNKS, **UNIT_RATES,
    )
    loss_rtol = TARGET_LOSS_RTOL if with_target else 1e-5
    for ref, rtol, loss_rtol in ((want, 2e-3, loss_rtol), (one, 1e-5, 1e-5)):
        np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=loss_rtol)
        assert_update(got[0], ref[0], fields["tx"], rtol)
        assert_update(got[1], ref[1], fields["eta_r"], rtol)


def test_a_world_of_one_gives_the_single_device_bits(problem, world_of_one) -> None:
    _, port_scene, fields = problem
    mesh = world_of_one
    assert (mesh.size, mesh.rank, mesh.axis_names) == (1, 0, ("rx",))
    assert torch.equal(
        parallel.sharded_power_map(port_scene, FREQUENCY, mesh, order=1),
        coverage.power_map(port_scene, FREQUENCY, order=1),
    )
    paths = parallel.sharded_trace_paths(port_scene, 1, mesh)
    single = port_scene.trace_paths(order=1).reshape(1, 25, 10)
    assert torch.equal(paths.mask, single.mask) and torch.equal(paths.vertices, single.vertices)
    kw = placement_for(torch, fields)
    whole = {k: v for k, v in kw.items() if k != "path_candidates"}
    pairs = [
        [parallel.placement_training_step(port_scene, FREQUENCY, m, order=1, **whole) for m in (mesh, None)],
        [parallel.streamed_placement_step(port_scene, FREQUENCY, m, **kw, **CHUNKS) for m in (mesh, None)],
        [parallel.streamed_placement_loss(port_scene, FREQUENCY, m, **kw, **CHUNKS) for m in (mesh, None)],
        [
            parallel.training_step(
                port_scene, FREQUENCY, m, order=1, eta_r=kw["eta_r"], conductivity=kw["conductivity"],
                target_power=torch.from_numpy(TARGET),
            )
            for m in (mesh, None)
        ],
    ]
    for got, want in pairs:
        for a, b in zip(_flat(got), _flat(want), strict=True):
            assert torch.equal(a, b)


def test_replicate_keeps_the_source_ranks_objects(problem, world_of_one) -> None:
    """On the source rank the scene is the caller's own: its mesh keeps its cached BVH."""
    _, port_scene, _ = problem
    same = parallel.replicate(port_scene, world_of_one)
    assert same is port_scene
    candidates = generate_path_candidates(port_scene.mesh.num_primitives, 1, device="cpu")
    copy = parallel.replicate({"c": candidates, "m": [port_scene.mesh]}, world_of_one)
    assert copy["m"][0] is port_scene.mesh and torch.equal(copy["c"], candidates)


def test_a_mesh_of_the_first_ranks_runs_on_its_own_group(ranks) -> None:
    whole = ranks[0]["power_map"]
    for r in ranks[:2]:
        assert torch.equal(r["pair_power_map"], whole)
    assert "not in the mesh" in ranks[2]["pair_power_map"]
