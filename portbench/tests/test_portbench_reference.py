"""The frozen inputs and the plain reference against the port, on the CPU at small sizes."""

import numpy as np
import pytest
import torch

from portbench.reference import candidates as rc
from portbench.reference import coverage as ref_coverage
from portbench.reference import scene as rs
from portbench.reference import trace as ref_trace


@pytest.mark.parametrize("blocks", [(1, 1), (2, 3), (5, 4), (24, 24)])
def test_city_equals_urban_scene(blocks):
    from differt_tpu_torch import scenes

    ours = rs.urban_city(*blocks)
    mesh = scenes.urban_scene(*blocks, device="cpu").mesh
    assert np.array_equal(ours["vertices"], mesh.vertices.numpy())
    assert np.array_equal(ours["triangles"], mesh.triangles.numpy())
    assert np.array_equal(ours["object_bounds"], mesh.object_bounds.numpy())


@pytest.mark.parametrize(
    ("num", "order", "start", "size"),
    [(7, 1, 0, 7), (7, 2, 3, 30), (50, 3, 1234, 500), (112_898, 2, 12_745_000_000, 64)],
)
def test_decode_equals_port(num, order, start, size):
    from differt_tpu_torch.geometry import generate_path_candidates

    want = generate_path_candidates(num, order, start=start, size=size, device="cpu")
    assert torch.equal(rc.decode_range(start, size, num, order, "cpu"), want)
    rows = torch.arange(start, start + size, dtype=torch.int64)
    assert torch.equal(rc.decode_rows(rows, num, order), want)


def test_strided_rows_are_decoded_groups():
    num, size, offset = 1000, 64, 987_654_321
    got = rc.strided(num, 2, size, offset, "cpu")
    step = rc.count(num, 2) // (size // 8)
    first = offset % (step - 7)
    assert torch.equal(got[:8], rc.decode_range(first, 8, num, 2, "cpu"))
    assert torch.equal(got[-8:], rc.decode_range(7 * step + first, 8, num, 2, "cpu"))


def test_near_pairs_are_ordered_pairs_of_the_nearest_and_the_ground():
    arrays = rs.urban_city(4, 4)
    tv = torch.from_numpy(arrays["vertices"][arrays["triangles"]])
    pairs = rc.near_pairs(tv, 2, [0.0, 0.0, 40.0], 10)
    assert pairs.shape == (12 * 11, 2)
    assert bool((pairs[:, 0] != pairs[:, 1]).all())
    num = tv.shape[0]
    assert {num - 2, num - 1} <= set(pairs.flatten().tolist())


def _scene(device="cpu"):
    from differt_tpu_torch import interop
    from differt_tpu_torch.geometry import Scene

    arrays = rs.urban_city(4, 4)
    mesh = interop.mesh_from_numpy(arrays, device=device)
    tx = torch.tensor([[1.0, -0.5, 40.0]])
    ys, xs = torch.meshgrid(torch.linspace(-90, 90, 12), torch.linspace(-90, 90, 12), indexing="ij")
    rx = torch.stack((xs, ys, torch.full_like(xs, 1.5)), -1).reshape(-1, 3)
    city = ref_trace.City(torch.from_numpy(arrays["vertices"]), torch.from_numpy(arrays["triangles"]))
    return Scene(transmitters=tx, receivers=rx, mesh=mesh), city, tx, rx


@pytest.mark.parametrize("order", [0, 1, 2])
def test_reference_map_equals_port(order):
    from differt_tpu_torch.coverage import power_map_chunked

    scene, city, tx, rx = _scene()
    n = city.num_triangles
    eta, sigma = torch.tensor([5.24]), torch.tensor([0.1])
    if order == 0:
        cands = torch.zeros((1, 0), dtype=torch.int64)
    elif order == 1:
        cands = rc.decode_range(0, n, n, 1, "cpu")
    else:
        cands = torch.cat((rc.near_pairs(city.triangle_vertices, 2, tx[0], 20), rc.strided(n, 2, 2000, 5, "cpu")))
    ref = ref_coverage.power_map(city, tx, rx, [cands], eta, sigma, 2.4e9)
    port = power_map_chunked(
        scene, 2.4e9, order=order, path_candidates=None if order == 0 else cands,
        candidate_chunk=512, rx_chunk=64, eta_r=eta, conductivity=sigma,
    ).reshape(-1)
    assert int((ref > 0).sum()) > 0
    assert torch.equal(port > 0, ref > 0)
    lit = ref > 0
    assert float((10 * torch.log10(port.double()[lit] / ref[lit])).abs().max()) < 1e-4


def test_reference_step_equals_port():
    from differt_tpu_torch.parallel import streamed_placement_step

    scene, city, tx, rx = _scene()
    n = city.num_triangles
    eta, sigma = torch.tensor([5.24]), torch.tensor([0.1])
    sets = [rc.decode_range(0, n, n, 1, "cpu"), rc.strided(n, 2, 256, 11, "cpu")]
    steps = ref_coverage.placement_steps(city, tx, eta, sigma, rx, sets, 2.4e9, 0.1, 0.01, 2)
    tx_p, eta_p = tx, eta
    for tx_r, eta_r, loss_r in steps:
        loss_ref, g_tx, g_eta = ref_coverage.placement_gradient(city, tx_p, eta_p, sigma, rx, sets, 2.4e9)
        assert loss_ref == pytest.approx(loss_r, rel=1e-5)
        new_tx, new_eta, loss = streamed_placement_step(
            scene, 2.4e9, tx=tx_p, eta_r=eta_p, conductivity=sigma, path_candidates=sets,
            candidate_chunk=128, rx_chunk=64, tx_learning_rate=0.1, eta_learning_rate=0.01,
        )
        assert float(loss) == pytest.approx(loss_ref, rel=1e-6)
        torch.testing.assert_close((tx_p - new_tx) / 0.1, g_tx, rtol=1e-3, atol=1e-4)
        torch.testing.assert_close((eta_p - new_eta) / 0.01, g_eta, rtol=1e-3, atol=1e-4)
        assert float(g_tx.norm()) > 0.0
        tx_p, eta_p = new_tx, new_eta
