"""The EM tile kernel's plain twin against ``complex_amplitudes``, and the coverage tile's routing and plan, on the CPU.

``ops._em.em_tile_sum_reference`` is the contract of ``csrc/em.cu`` (held
against the twin on the card in ``tests/test_torch_gpu.py``): a traced
tile's per-pixel amplitude sum from its vertices, mask and per-candidate
rows. Here the twin is held against ``complex_amplitudes`` on a
``TracedPaths`` built by hand, over the cases the kernel branches on.
"""

import dataclasses

import numpy as np
import pytest
import torch

from differt_tpu_torch import coverage, ops
from differt_tpu_torch.em import HWDipolePattern
from differt_tpu_torch.geometry import Mesh, Scene, TracedPaths, generate_path_candidates
from differt_tpu_torch.ops import _em

from . import torch_parity  # noqa: F401  (warms the CPU transcendentals)

FREQUENCY = 2.4e9
NUM_TX, NUM_RX, NUM_CAND = 2, 5, 7


def _mesh(face_materials: str) -> Mesh:
    """A walled box (10 triangles) with no, in-range or out-of-range face materials (3 materials)."""
    mesh = Mesh.box(20.0, 10.0, 6.0, with_top=False, device="cpu")
    rng = np.random.default_rng(3)
    if face_materials == "set":
        mats = rng.integers(0, 3, mesh.num_triangles)
    elif face_materials == "out_of_range":  # clamped to the table: below 0 and beyond its end
        mats = rng.choice([-2, 0, 1, 2, 3, 7], mesh.num_triangles)
    else:
        return mesh
    return dataclasses.replace(mesh, face_materials=torch.from_numpy(mats))


def _tile(order: int, seed: int = 0) -> dict:
    """A tile as the trace writes it: vertices and mask in [T, C, R] memory, seen [T, R, C]; rows per candidate."""
    rng = np.random.default_rng(seed + order)
    verts = rng.uniform(-40.0, 40.0, (NUM_TX, NUM_CAND, NUM_RX, order + 2, 3)).astype(np.float32)
    mask = rng.random((NUM_TX, NUM_CAND, NUM_RX)) < 0.6
    return {
        "vertices": torch.from_numpy(verts).transpose(1, 2),
        "mask": torch.from_numpy(mask).transpose(1, 2),
        "objects": torch.from_numpy(rng.integers(0, 10, (NUM_CAND, order))),
        "types": torch.zeros((NUM_CAND, order), dtype=torch.int32),
    }


def _materials(thickness: str) -> dict:
    kw = {"eta_r": torch.tensor([5.24, 1.0, 3.0]), "conductivity": torch.tensor([0.1, 1e7, 0.02])}
    if thickness == "slab":  # a slab, a half-space (negative) and a thin slab
        kw["thickness"] = torch.tensor([0.2, -1.0, 0.01])
    return kw


def _plain(tile: dict, mesh: Mesh, coherent: bool, **materials) -> torch.Tensor:
    """``complex_amplitudes`` on a TracedPaths built by hand, summed per pixel."""
    order = tile["objects"].shape[1]
    shape = (NUM_TX, NUM_RX, NUM_CAND)
    objects = torch.cat(
        (
            torch.full((*shape, 1), 7),
            tile["objects"].expand(*shape, order),
            torch.full((*shape, 1), 9),
        ),
        dim=-1,
    )
    paths = TracedPaths(
        tile["vertices"],
        objects,
        mask=tile["mask"],
        interaction_types=tile["types"].expand(*shape, order).clone(),
    )
    a = coverage.complex_amplitudes(paths, Scene(mesh=mesh), FREQUENCY, **materials)
    return a.sum(dim=-1) if coherent else (torch.abs(a) ** 2).sum(dim=-1)


def _twin(tile: dict, mesh: Mesh, coherent: bool, **materials) -> torch.Tensor:
    return _em.em_tile_sum_reference(
        tile["vertices"], tile["mask"], tile["objects"], tile["types"], mesh, FREQUENCY,
        coherent=coherent, **materials,
    )


@pytest.mark.parametrize("thickness", ["none", "slab"])
@pytest.mark.parametrize("face_materials", ["none", "set", "out_of_range"])
@pytest.mark.parametrize("coherent", [True, False], ids=["coherent", "power"])
@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_twin_is_complex_amplitudes_summed(order, coherent, face_materials, thickness) -> None:
    tile, mesh, materials = _tile(order), _mesh(face_materials), _materials(thickness)
    got = _twin(tile, mesh, coherent, **materials)
    want = _plain(tile, mesh, coherent, **materials)
    assert got.shape == (NUM_TX, NUM_RX)
    assert got.dtype == (torch.complex64 if coherent else torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.isfinite(torch.view_as_real(got) if coherent else got).all()
    assert bool((got != 0).any())


def test_out_of_range_materials_read_the_table_clamped() -> None:
    tile, materials = _tile(2), _materials("slab")
    mesh = _mesh("out_of_range")
    clamped = dataclasses.replace(mesh, face_materials=mesh.face_materials.clamp(0, 2))
    torch.testing.assert_close(
        _twin(tile, mesh, True, **materials), _twin(tile, clamped, True, **materials), rtol=0, atol=0
    )


@pytest.mark.parametrize("coherent", [True, False], ids=["coherent", "power"])
def test_a_padded_bounce_is_passed_over(coherent) -> None:
    # Candidates 1 and 4 are order-1 chains padded to order 2 (object -1, type -1 at bounce 1);
    # candidate 2's first bounce has a type the chain passes over (not a reflection).
    tile, mesh, materials = _tile(2), _mesh("set"), _materials("slab")
    tile["objects"][[1, 4], 1] = -1
    tile["types"][[1, 4], 1] = -1
    tile["types"][2, 0] = 2
    got = _twin(tile, mesh, coherent, **materials)
    torch.testing.assert_close(got, _plain(tile, mesh, coherent, **materials), rtol=0, atol=0)
    # A passed-over bounce reads no face: another object there changes nothing ...
    other = {**tile, "objects": tile["objects"].clone()}
    other["objects"][[1, 4], 1] = 5
    other["objects"][2, 0] = 6
    torch.testing.assert_close(_twin(other, mesh, coherent, **materials), got, rtol=0, atol=0)
    # ... and the same bounces taken as reflections change the sum.
    reflected = {**other, "types": torch.zeros_like(tile["types"])}
    assert not torch.equal(_twin(reflected, mesh, coherent, **materials), got)


@pytest.mark.parametrize("fault", ["inf", "nan", "zero_segment", "short_segment"])
def test_dummy_paths_weigh_nothing(fault) -> None:
    # Valid paths whose geometry is not usable contribute 0, whatever their mask says.
    tile, mesh, materials = _tile(2), _mesh("set"), _materials("none")
    verts = tile["vertices"].transpose(1, 2).clone()  # [T, C, R, ...] memory
    picks = (torch.tensor([0, 1, 1]), torch.tensor([2, 0, 5]), torch.tensor([1, 3, 4]))
    if fault == "inf":
        verts[picks + (2, 0)] = float("inf")
    elif fault == "nan":
        verts[picks + (1,)] = float("nan")
    elif fault == "zero_segment":  # a bounce on the RX
        verts[picks + (2,)] = verts[picks + (3,)]
    else:  # a first segment of squared length 2.5e-13 m^2, below the chain's 1e-12
        verts[picks + (0,)] = 0.5
        verts[picks + (1,)] = torch.tensor([0.5 + 5e-7, 0.5, 0.5])
    tile["vertices"] = verts.transpose(1, 2)
    mask = tile["mask"].transpose(1, 2).clone()
    mask[picks] = True
    tile["mask"] = mask.transpose(1, 2)
    got = _twin(tile, mesh, True, **materials)
    torch.testing.assert_close(got, _plain(tile, mesh, True, **materials), rtol=0, atol=0)
    masked = dict(tile)
    mask = mask.clone()
    mask[picks] = False
    masked["mask"] = mask.transpose(1, 2)
    torch.testing.assert_close(got, _twin(masked, mesh, True, **materials), rtol=0, atol=0)


@pytest.mark.parametrize("coherent", [True, False], ids=["coherent", "power"])
def test_an_all_invalid_tile_sums_to_zero(coherent) -> None:
    tile = _tile(1)
    tile["mask"] = torch.zeros_like(tile["mask"])
    got = _twin(tile, _mesh("none"), coherent, **_materials("slab"))
    assert got.shape == (NUM_TX, NUM_RX) and not got.any()


def test_the_kernel_wrapper_takes_cuda_tensors_only() -> None:
    tile = _tile(1)
    launches = _em.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        _em.em_tile_sum(
            tile["vertices"], tile["mask"], tile["objects"], tile["types"], _mesh("none"),
            FREQUENCY, **_materials("none"),
        )
    assert _em.LAUNCHES == launches


def _box_tile(case: str) -> dict:
    """_coverage_tile's arguments on a walled box, order 1, one chunk whose last candidate is padding."""
    mesh = Mesh.box(20.0, 10.0, 6.0, with_top=False, device="cpu").set_materials("Concrete")
    tx = torch.tensor([[-5.0, 0.5, 1.0]])
    if case == "grad":
        tx = tx.clone().requires_grad_()
    scene = Scene(transmitters=tx, mesh=mesh).with_receivers_grid(4, 2, height=1.0)
    cand = generate_path_candidates(mesh.num_triangles, 1, device="cpu")
    return {
        "scene": scene,
        "tx": tx,
        "rx_tile": scene.receivers.reshape(-1, 3),
        "candidate_set": coverage._CandidateSet(cand, None, cand.shape[0] - 1, cand.shape[0]),
        "lo": 0,
        "hi": cand.shape[0],
        "plan": None,
        "frequency": torch.tensor(FREQUENCY),
        "eta_r": torch.tensor([5.24]),
        "conductivity": torch.tensor([0.1]),
        "thickness": None,
        "coherent": True,
        "megakernel": None,
        "smoothing_factor": 20.0 if case == "float_mask" else None,
        "tx_pattern": (
            HWDipolePattern(FREQUENCY, direction=(0.0, 0.0, 1.0), center=tx[0], device="cpu")
            if case == "pattern"
            else None
        ),
    }


def _tile_plan_of(kw: dict):
    """The plan ``power_map_chunked`` makes for a tile's set and call."""
    return coverage._tile_plan(
        kw["scene"].mesh, kw["tx"], kw["rx_tile"], kw["candidate_set"], kw["frequency"], kw["eta_r"],
        kw["conductivity"], kw["thickness"],
        megakernel=kw["megakernel"], smoothing_factor=kw["smoothing_factor"], tx_pattern=kw["tx_pattern"],
    )


def _twin_launches(monkeypatch, kw: dict) -> list:
    """Replace both kernels' launch halves by spies that run their twins on ``kw``'s mesh and materials.

    The trace spy rebuilds each candidate triangle from its laid-out v0, e1
    and e2 (exact on the box's whole-metre corners). Returns the launches,
    by kernel name.
    """
    from differt_tpu_torch.ops import _trace

    mesh, calls = kw["scene"].mesh, []

    def trace_spy(tx, rx, mirrors, cand_tris, triangle_vertices, active_triangles, *, bvh, **tolerances):
        calls.append("trace")
        assert triangle_vertices is None and active_triangles is None and bvh is mesh.bvh
        v0, e1, e2 = cand_tris.reshape(*cand_tris.shape[:2], 3, 3).unbind(-2)
        triangles = torch.stack((v0, v0 + e1, v0 + e2), dim=-2)
        return _trace.trace_specular_reference(
            tx, rx, mirrors[..., :3], mirrors[..., 3:], triangles, mesh.triangle_vertices, mesh.mask, **tolerances
        )

    def em_spy(vertices, mask, objects, types, *mesh_inputs, coherent):
        calls.append("em")
        return _em.em_tile_sum_reference(
            vertices, mask, objects, types, mesh, kw["frequency"], eta_r=kw["eta_r"],
            conductivity=kw["conductivity"], thickness=kw["thickness"], coherent=coherent,
        )

    monkeypatch.setattr(_trace, "trace_laid_out", trace_spy)
    monkeypatch.setattr(_em, "em_laid_out", em_spy)
    return calls


@pytest.mark.parametrize("case", ["no_gradient", "grad", "pattern", "float_mask", "cpu"])
def test_coverage_tile_routing(case, monkeypatch) -> None:
    """The tile takes the kernels only where no gradient, pattern or confidence needs the plain chain.

    On the CPU no plan is made. For the other cases the CPU tensors pass for
    the card's (the backend reads "cuda") and the kernels' launch halves are
    spies that run the twins: only the no-gradient call gets a plan, with
    both halves, its tile launches each kernel once, and its sums are the
    plain chain's.
    """
    kw = _box_tile(case)
    want = coverage._coverage_tile(**kw)  # the plain chain: nothing patched
    if case != "cpu":
        monkeypatch.setattr(ops, "get_backend", lambda device=None: "cuda")
    calls = _twin_launches(monkeypatch, kw)
    kw["plan"] = _tile_plan_of(kw)
    assert (kw["plan"] is not None) == (case == "no_gradient")
    launches = _em.LAUNCHES
    got = coverage._coverage_tile(**kw)
    assert _em.LAUNCHES == launches
    assert calls == (["trace", "em"] if case == "no_gradient" else [])
    assert got.requires_grad == (case == "grad")
    torch.testing.assert_close(got.detach(), want.detach(), rtol=0, atol=0)
    assert bool((got != 0).any())


def test_coverage_tile_takes_the_plain_chain_when_a_material_or_the_mesh_needs_a_gradient(monkeypatch) -> None:
    monkeypatch.setattr(ops, "get_backend", lambda device=None: "cuda")
    kw = _box_tile("no_gradient")
    kw["eta_r"] = kw["eta_r"].clone().requires_grad_()
    assert _tile_plan_of(kw) is None
    assert coverage._coverage_tile(**kw).requires_grad
    kw = _box_tile("no_gradient")
    mesh = kw["scene"].mesh
    kw["scene"] = dataclasses.replace(
        kw["scene"], mesh=dataclasses.replace(mesh, vertices=mesh.vertices.clone().requires_grad_())
    )
    _twin_launches(monkeypatch, kw)
    monkeypatch.setattr(_em, "em_laid_out", lambda *a, **k: pytest.fail("the kernel was taken"))
    assert _tile_plan_of(kw) is None
    assert coverage._coverage_tile(**kw).requires_grad
    with torch.no_grad():  # no gradient can be asked for: a plan, and the kernel, here its spy's failure
        kw["plan"] = _tile_plan_of(kw)
        assert kw["plan"] is not None
        with pytest.raises(pytest.fail.Exception):
            coverage._coverage_tile(**kw)


def _plan_set(case: str) -> tuple[Mesh, coverage._CandidateSet]:
    """A walled box and a candidate set padded as ``power_map_chunked`` pads it."""
    mesh = Mesh.box(20.0, 10.0, 6.0, with_top=False, device="cpu").set_materials("Concrete")
    if case == "quads":
        mesh = mesh.set_assume_quads()
    if case == "masked":
        mesh = mesh.set_mask(torch.arange(mesh.num_triangles) % 3 != 0)
    order = 1 if case == "order_1" else 2
    cand = generate_path_candidates(mesh.num_primitives, order, device="cpu")
    if mesh.assume_quads:
        cand = 2 * cand
    # 10 (order 1), 90 (order 2), 20 (quads, order 2) candidates
    chunk = {"order_1": 5, "quads": 10, "padded": 32}.get(case, 30)
    itypes = torch.zeros_like(cand, dtype=torch.int32)
    itypes[1::4, -1] = 2  # a bounce the chain passes over: its type must reach the kernel
    (candidate_set,) = coverage._TileWalk(torch.zeros(1, 3), 1, [(cand, itypes)], chunk).sets
    return mesh, candidate_set


def _plan(mesh, candidate_set, **kw):
    return coverage._tile_plan(
        mesh, torch.zeros(1, 3), torch.zeros(2, 3), candidate_set, torch.tensor(FREQUENCY), torch.tensor([5.24]),
        torch.tensor([0.1]), None, **{"megakernel": None, "smoothing_factor": None, "tx_pattern": None, **kw},
    )


@pytest.mark.parametrize("case", ["order_1", "order_2", "quads", "masked", "padded"])
def test_tile_plan_slices_are_each_chunks_own_layout(case, monkeypatch) -> None:
    """The plan's slices equal, bit for bit, what each chunk's own layout hands the kernels.

    Per chunk, the trace kernel takes the chunk's ``candidate_geometry``
    laid out (mirror vertex and normal side by side; each triangle's v0,
    v1 - v0, v2 - v0), and the EM kernel its ``candidate_rows`` (int64,
    int32), the mesh's normals and the material table. The planned tile
    (its kernels' launch halves replaced by spies) hands those slices on;
    its mask keeps the trace's own where nothing masks a candidate (no
    ``&``), and drops the padding and the masked triangles.
    """
    from differt_tpu_torch.ops import _trace
    from differt_tpu_torch.rt._solvers import candidate_geometry, candidate_rows, kernel_tolerances

    monkeypatch.setattr(ops, "get_backend", lambda device=None: "cuda")
    mesh, cs = _plan_set(case)
    cand, itypes, n, chunk = cs.candidates, cs.interaction_types, cs.num_candidates, cs.chunk
    plan = _plan(mesh, cs)
    assert plan is not None and plan.mirrors is not None

    launched = {}

    def trace_spy(tx, rx, mirrors, cand_tris, triangle_vertices, active_triangles, **kw):
        launched["trace"] = (mirrors, cand_tris, triangle_vertices, active_triangles, kw)
        num_c = mirrors.shape[0]
        vertices = torch.zeros((tx.shape[0], num_c, rx.shape[0], kw["order"] + 2, 3))
        mask = torch.ones((tx.shape[0], num_c, rx.shape[0]), dtype=torch.bool)  # every path valid
        launched["mask"] = mask
        return vertices, mask

    def em_spy(vertices, mask, *inputs, coherent):
        launched["em"] = (mask, inputs)
        return torch.zeros((vertices.shape[0], vertices.shape[1]), dtype=torch.complex64)

    monkeypatch.setattr(_trace, "trace_laid_out", trace_spy)
    monkeypatch.setattr(_em, "em_laid_out", em_spy)
    scene = Scene(mesh=mesh)
    tx, rx = torch.tensor([[-5.0, 0.5, 1.0]]), torch.tensor([[3.0, -2.0, 1.5], [6.0, 1.0, 1.5]])
    k = 2 if mesh.assume_quads else 1
    for lo in range(0, cand.shape[0], chunk):
        hi = lo + chunk
        pc, tv, mv, mn = candidate_geometry(mesh, cand[lo:hi])
        v0 = tv[..., 0, :]
        want_mirrors = torch.cat((mv, mn), dim=-1)
        want_tris = torch.cat((v0, tv[..., 1, :] - v0, tv[..., 2, :] - v0), dim=-1)
        rows, types = candidate_rows(pc, itypes[lo:hi], k)
        coverage._coverage_tile(
            scene, tx, rx, cs, lo, hi, plan, torch.tensor(FREQUENCY), torch.tensor([5.24]), torch.tensor([0.1]),
            None, True, None,
        )

        mirrors, cand_tris, triangle_vertices, active_triangles, kw = launched["trace"]
        assert torch.equal(mirrors, want_mirrors) and mirrors.is_contiguous()
        assert torch.equal(cand_tris, want_tris) and cand_tris.is_contiguous()
        assert triangle_vertices is None and kw["bvh"] is mesh.bvh and kw["order"] == cand.shape[1]
        assert (kw["epsilon"], kw["hit_tol"], kw["min_len"]) == kernel_tolerances()

        mask, (objects, got_types, normals, face_materials, table, frequency) = launched["em"]
        assert torch.equal(objects, rows.to(torch.int64)) and objects.dtype == torch.int64
        assert torch.equal(got_types, types) and got_types.dtype == torch.int32
        assert objects.is_contiguous() and got_types.is_contiguous()
        assert torch.equal(normals, mesh.normals) and torch.equal(face_materials, mesh.face_materials)
        assert torch.equal(table, _em._material_table(torch.tensor(FREQUENCY), torch.tensor([5.24]), torch.tensor([0.1]), None, "cpu"))
        assert frequency.dtype == torch.float32 and float(frequency) == np.float32(FREQUENCY)

        keep = torch.arange(lo, hi) < n
        if mesh.mask is not None:
            keep = keep & mesh.mask[pc].all(dim=-1)
        assert torch.equal(mask, keep.expand_as(mask))
        trace_mask = launched["mask"].transpose(1, 2)
        untouched = mask.data_ptr() == trace_mask.data_ptr() and mask.stride() == trace_mask.stride()
        assert untouched == (mesh.mask is None and hi <= n), (lo, hi)
    if case == "padded":
        assert cand.shape[0] > n and not bool(mask[..., n - lo :].any())
    if case == "masked":
        assert not bool(keep.all())


@pytest.mark.parametrize(
    "case", ["cpu", "unfused", "smoothed", "pattern", "order_0", "grad", "grad_off", "grad_rx"]
)
def test_tile_plan_only_where_every_tile_is_fused(case, monkeypatch) -> None:
    """A plan is made where ``_fused_em`` holds of the call; its trace half where the trace is fused too.

    Order 0 and ``megakernel=False`` trace unfused: their plan has the EM half alone.
    """
    mesh, cs = _plan_set("order_1")
    if case != "cpu":
        monkeypatch.setattr(ops, "get_backend", lambda device=None: "cuda")
    kw = {
        "unfused": {"megakernel": False},
        "smoothed": {"smoothing_factor": 20.0},
        "pattern": {"tx_pattern": HWDipolePattern(FREQUENCY, direction=(0.0, 0.0, 1.0), device="cpu")},
    }.get(case, {})
    if case == "order_0":
        cs = dataclasses.replace(cs, candidates=cs.candidates[:, :0], interaction_types=cs.interaction_types[:, :0])
    args = [mesh, torch.zeros(1, 3), torch.zeros(2, 3), cs, torch.tensor(FREQUENCY), torch.tensor([5.24]), torch.tensor([0.1]), None]
    if case.startswith("grad"):  # the TX, or the receivers, can be asked for a gradient
        args[2 if case == "grad_rx" else 1] = torch.zeros(2 if case == "grad_rx" else 1, 3, requires_grad=True)
    options = {"megakernel": None, "smoothing_factor": None, "tx_pattern": None, **kw}
    with torch.set_grad_enabled(case != "grad_off"):
        plan = coverage._tile_plan(*args, **options)
    assert (plan is not None) == (case in ("grad_off", "unfused", "order_0"))
    if plan is not None:
        assert (plan.mirrors is None) == (case != "grad_off")
        assert torch.equal(plan.objects, cs.candidates) and torch.equal(plan.types, cs.interaction_types)


@pytest.mark.parametrize("case", ["order_0", "unfused"])
def test_em_only_plan_map_is_the_plain_chains(case, monkeypatch) -> None:
    """An order-0 or ``megakernel=False`` map with no gradient takes an EM-only plan: the unfused
    trace per tile, then the EM kernel (its spy runs the twin) on the plan's rows; the map is the
    plain chain's, bit for bit, once a tile each."""
    kw = _box_tile("no_gradient")
    scene = kw["scene"].with_receivers_grid(6, 5, height=1.0)
    order, megakernel = (0, None) if case == "order_0" else (1, False)
    options = {
        "order": order, "megakernel": megakernel, "candidate_chunk": 4, "rx_chunk": 8,
        "eta_r": kw["eta_r"], "conductivity": kw["conductivity"],  # what the EM spy reads
    }
    want = coverage.power_map_chunked(scene, FREQUENCY, **options)  # the plain chain: nothing patched
    monkeypatch.setattr(ops, "get_backend", lambda device=None: "cuda")
    calls = _twin_launches(monkeypatch, kw)
    plans = []

    def plan_spy(*args, **kwargs):
        plans.append(real_plan(*args, **kwargs))
        return plans[-1]

    real_plan = coverage._tile_plan
    monkeypatch.setattr(coverage, "_tile_plan", plan_spy)
    got = coverage.power_map_chunked(scene, FREQUENCY, **options)
    assert len(plans) == 1 and plans[0] is not None and plans[0].mirrors is None
    num_cand = 1 if order == 0 else 3  # chunks: 1 candidate (order 0), 10 in chunks of 4
    assert calls == ["em"] * (num_cand * 4)  # 30 receivers: 4 tiles of 8
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert float(want.max()) > 0.0
