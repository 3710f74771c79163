"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports no JAX, so that it runs on a GPU host without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Here (no CUDA device) every test skips.
"""

import dataclasses

import numpy as np
import pytest
import torch

from differt_tpu_torch import ops, scenes
from differt_tpu_torch.geometry import Mesh, Scene, fibonacci_lattice, generate_path_candidates
from differt_tpu_torch.ops import _build, _bvh, _closest, _rt, _trace
from differt_tpu_torch.rt import first_triangle_hit_by_ray, ray_intersect_triangle, trace_path_candidates
from differt_tpu_torch.rt._solvers import candidate_geometry

from .torch_parity import (
    EPSILON,
    HIT_TOL,
    canyon_candidates,
    cuda_or_skip,
    random_segments,
    street_chains,
    triangle_mask,
)

pytestmark = pytest.mark.gpu


def _anyhit_segments(device, num_rays: int, seed: int, *, masked: bool = False):
    """Random segments over urban_scene(4, 4) (578 triangles): rays, thresholds (a fifth of
    the rays inactive, every seventh of those NaN), the triangles and their mask."""
    scene = scenes.urban_scene(4, 4, device=device)
    tv = scene.mesh.triangle_vertices.contiguous()
    start, direction, active_rays = random_segments(
        scene.mesh.bounding_box.cpu().numpy(), num_rays, seed
    )
    thresh = np.where(active_rays, 1.0 - 2.0 * HIT_TOL, -1.0).astype(np.float32)
    thresh[np.flatnonzero(~active_rays)[::7]] = np.nan
    active = torch.from_numpy(triangle_mask(tv.shape[0], 29)).to(device) if masked else None
    o, d = torch.from_numpy(start).to(device), torch.from_numpy(direction).to(device)
    return o, d, torch.from_numpy(thresh).to(device), tv, active


@pytest.mark.parametrize("num_rays", [1, 31, 128, 4_096, 262_144])
@pytest.mark.parametrize("leaf_size", [5, 8, 16])
@pytest.mark.parametrize("masked", [False, True])
def test_anyhit_kernel_matches_reference(masked: bool, leaf_size: int, num_rays: int) -> None:
    device = cuda_or_skip()
    o, d, thresh, tv, active = _anyhit_segments(device, num_rays, 23, masked=masked)
    # 578 triangles: leaves of 5 and 16 do not divide the tree's 576.
    bvh = _bvh.build_bvh(tv, active, leaf_size=leaf_size)
    launches = _rt.LAUNCHES
    got = _rt.ray_intersect_any_triangle_cuda(o, d, tv, active, hit_threshold=thresh, bvh=bvh)
    torch.cuda.synchronize()
    assert _rt.LAUNCHES == launches + 1
    want = _rt.ray_intersect_any_triangle_reference(o, d, tv, active, hit_threshold=thresh)
    assert torch.equal(got, want)
    if num_rays >= 4_096:
        assert 0 < int(got.sum()) < int((thresh >= 0).sum())
    # Every split level, forced, gives the same result.
    out = torch.empty_like(got)
    for split in range(bvh.depth + 1):
        _rt.launch_anyhit(o, d, thresh, bvh, EPSILON, out, split=split)
        assert torch.equal(out, want), f"split level {split}"


@pytest.mark.parametrize("fill", [-1.0, float("nan")], ids=["negative", "nan"])
def test_anyhit_kernel_all_rays_inactive(fill: float) -> None:
    device = cuda_or_skip()
    o, d, thresh, tv, _ = _anyhit_segments(device, 4_096, 37)
    bvh = _bvh.build_bvh(tv, None)
    thresh = torch.full_like(thresh, fill)
    out = torch.ones(4_096, dtype=torch.bool, device=device)  # the launch zeroes it
    for split in range(bvh.depth + 1):
        _rt.launch_anyhit(o, d, thresh, bvh, EPSILON, out, split=split)
        assert not out.any()


def test_anyhit_launches_back_to_back_reset_the_queue() -> None:
    # More items than the card's lanes, so that the queue's counter decides
    # which run: a counter left over by the launch before, on the same
    # stream, or left high on purpose, must not skip any.
    device = cuda_or_skip()
    o, d, thresh, tv, _ = _anyhit_segments(device, 262_144, 43)
    bvh = _bvh.build_bvh(tv, None)
    want = _rt.ray_intersect_any_triangle_reference(o, d, tv, hit_threshold=thresh)
    other = torch.where(thresh >= 0, thresh * 0.5, thresh)  # half as long
    want_other = _rt.ray_intersect_any_triangle_reference(o, d, tv, hit_threshold=other)
    first, second = torch.empty_like(want), torch.empty_like(want)
    _rt.launch_anyhit(o, d, thresh, bvh, EPSILON, first, split=2)
    _rt.launch_anyhit(o, d, other, bvh, EPSILON, second, split=2)
    torch.cuda.synchronize()
    assert torch.equal(first, want) and torch.equal(second, want_other)
    assert not torch.equal(want, want_other)

    # The C launch with its scratch's two counters (live rays, queue) left high.
    scratch = torch.full((2 + o.shape[0],), 1 << 29, dtype=torch.int32, device=device)
    out = torch.empty_like(want)
    status = _build.load_kernels().differt_anyhit(
        o.data_ptr(), d.data_ptr(), thresh.data_ptr(), bvh.nodes.data_ptr(),
        bvh.triangles.data_ptr(), bvh.num_nodes, bvh.large_begin, bvh.num_large,
        o.shape[0], 2, _rt.SPLIT_ITEMS, EPSILON, scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream,
    )
    torch.cuda.synchronize()
    assert status == 0 and torch.equal(out, want)
    assert int(scratch[0]) == int((thresh >= 0).sum())  # reset, then counted from 0
    assert 0 < int(scratch[1]) < 1 << 29


def test_anyhit_split_is_checked() -> None:
    device = cuda_or_skip()
    o, d, thresh, tv, _ = _anyhit_segments(device, 8, 47)
    bvh = _bvh.build_bvh(tv, None)
    out = torch.empty(8, dtype=torch.bool, device=device)
    for split in (-1, bvh.depth + 1):
        with pytest.raises(ValueError, match="level of the tree"):
            _rt.launch_anyhit(o, d, thresh, bvh, EPSILON, out, split=split)


# Orders 1-4 run their templates, 5 and 6 the runtime-order instantiation.
TRACE_ORDERS = [(1, False), (2, False), (2, True), (3, False), (4, False), (5, False), (5, True), (6, False)]


def _candidates(mesh, order: int, quads: bool, device) -> torch.Tensor:
    """Every candidate up to order 2; above it the street chains and a strided shard.
    Triangle indices (a quad's first triangle), as ``Scene.trace_paths`` takes them."""
    if order <= 2:
        candidates = generate_path_candidates(mesh.num_primitives, order, device=device)
    else:
        candidates = torch.from_numpy(canyon_candidates(order, quads, shard=64)).to(device)
    return candidates * (2 if quads else 1)


@pytest.mark.parametrize(("order", "quads"), TRACE_ORDERS)
def test_trace_kernel_matches_reference(order: int, quads: bool) -> None:
    device = cuda_or_skip()
    mesh = scenes.street_canyon_scene(device=device).mesh.set_assume_quads(quads)
    scene = Scene(
        transmitters=torch.tensor([[-30.0, 0.0, 20.0], [10.0, 3.0, 5.0]], device=device),
        mesh=mesh,
    ).with_receivers_grid(16, 16)
    candidates = _candidates(mesh, order, quads, device)
    launches = _trace.LAUNCHES
    got = scene.trace_paths(path_candidates=candidates)  # megakernel=None picks the kernel on CUDA
    torch.cuda.synchronize()
    assert _trace.LAUNCHES == launches + 1

    _, tris, mirror_vertices, mirror_normals = candidate_geometry(mesh, candidates)
    args = (
        scene.transmitters.reshape(-1, 3),
        scene.receivers.reshape(-1, 3),
        mirror_vertices,
        mirror_normals,
        tris,
        mesh.triangle_vertices.contiguous(),
        None,
    )
    kw = {"order": order, "epsilon": EPSILON, "hit_tol": HIT_TOL, "min_len": EPSILON}
    verts, mask = _trace.trace_specular_cuda(*args, **kw)
    want_verts, want_mask = _trace.trace_specular_reference(*args, **kw)
    assert torch.equal(mask, want_mask)
    assert int(mask.sum()) > 0
    torch.testing.assert_close(verts[mask], want_verts[mask], atol=1e-4, rtol=0)
    # The public entry's [tx, rx..., cand] mask is the kernel's [tx, cand, rx].
    num_tx, num_cand, num_rx = mask.shape
    assert torch.equal(got.mask.reshape(num_tx, num_rx, num_cand).transpose(1, 2), mask)
    # The same on a BVH with leaves of 5 (the canyon's 24 tree triangles).
    odd = _bvh.build_bvh(args[5], None, leaf_size=5)
    verts5, mask5 = _trace.trace_specular_cuda(*args, **kw, bvh=odd)
    assert torch.equal(mask5, mask)
    torch.testing.assert_close(verts5, verts, rtol=0, atol=0, equal_nan=True)

    # The recompute of the backward gives the kernel's own vertices (the
    # kernel is built without fused multiply-adds for this).
    recomputed = _trace.trace_vertices(*args[:4])
    torch.testing.assert_close(recomputed[mask], verts[mask], atol=1e-4, rtol=0)


def _length_gradients(scene: Scene, order: int, megakernel):
    """Gradients of the valid paths' total length to the TX, the RX and the mesh's vertices."""
    tx = scene.transmitters.reshape(-1, 3).clone().requires_grad_()
    rx = scene.receivers.reshape(-1, 3).clone().requires_grad_()
    vertices = scene.mesh.vertices.clone().requires_grad_()
    mesh = dataclasses.replace(scene.mesh, vertices=vertices)
    candidates = _candidates(mesh, order, mesh.assume_quads, tx.device)
    paths = trace_path_candidates(mesh, tx, rx, candidates, megakernel=megakernel)
    seg = paths.vertices[..., 1:, :] - paths.vertices[..., :-1, :]
    lengths = torch.sqrt((seg * seg).sum(dim=-1) + 1e-12).sum(dim=-1)
    total = torch.where(paths.mask, lengths, 0.0).sum()
    return total, torch.autograd.grad(total, (tx, rx, vertices)), paths


@pytest.mark.parametrize(("order", "quads"), TRACE_ORDERS)
def test_trace_function_gradients_on_the_card(order: int, quads: bool, torch_backend) -> None:
    # The canyon's walls are parallel mirrors: at order 2 some candidates'
    # paths are impossible, and none of that may reach a gradient.
    device = cuda_or_skip()
    mesh = scenes.street_canyon_scene(device=device).mesh.set_assume_quads(quads)
    scene = Scene(
        transmitters=torch.tensor([[-30.0, 0.5, 20.0], [10.0, 3.0, 5.0]], device=device),
        mesh=mesh,
    ).with_receivers_grid(16, 16)
    launches, calls = _trace.LAUNCHES, _trace.REFERENCE_CALLS
    total, fused, paths = _length_gradients(scene, order, None)
    torch.cuda.synchronize()
    assert (_trace.LAUNCHES, _trace.REFERENCE_CALLS) == (launches + 1, calls)
    assert paths.num_valid_paths > 0 and not paths.mask.requires_grad
    torch_backend()  # the plain, unfused pipeline with direct autograd
    want_total, unfused, want_paths = _length_gradients(scene, order, None)
    assert _trace.LAUNCHES == launches + 1
    assert torch.equal(paths.mask, want_paths.mask)
    torch.testing.assert_close(total, want_total, rtol=1e-5, atol=0)
    for got, want in zip(fused, unfused):
        assert torch.isfinite(got).all() and got.abs().max() > 0
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


def test_trace_kernel_takes_every_order_to_its_cap() -> None:
    # The library's cap is the wrapper's; at the cap, on quads (the layout that
    # binds), the chains between the canyon's street walls reach the street.
    device = cuda_or_skip()
    assert _build.load_kernels().differt_trace_max_order() == _trace.MAX_ORDER
    mesh = scenes.street_canyon_scene(device=device).mesh.set_assume_quads()
    tx = torch.tensor([[-30.0, 0.0, 20.0]], device=device)
    rx = torch.tensor([[x, y, 1.5] for x in (-20.0, 0.0, 25.0) for y in (-4.0, 5.0)], device=device)
    kw = {"epsilon": EPSILON, "hit_tol": HIT_TOL, "min_len": EPSILON}
    for order in (_trace.MAX_ORDER, _trace.MAX_ORDER + 1):
        candidates = 2 * torch.from_numpy(street_chains(order, quads=True)).to(device)
        _, tris, mirror_vertices, mirror_normals = candidate_geometry(mesh, candidates)
        args = (tx, rx, mirror_vertices, mirror_normals, tris, mesh.triangle_vertices.contiguous(), None)
        if order > _trace.MAX_ORDER:
            with pytest.raises(ValueError, match=f"not {order}"):
                trace_path_candidates(mesh, tx, rx, candidates, megakernel=True)
            continue
        launches = _trace.LAUNCHES
        verts, mask = _trace.trace_specular_cuda(*args, order=order, **kw)
        torch.cuda.synchronize()
        assert _trace.LAUNCHES == launches + 1
        want_verts, want_mask = _trace.trace_specular_reference(*args, order=order, **kw)
        assert torch.equal(mask, want_mask) and int(mask.sum()) > 0
        torch.testing.assert_close(verts[mask], want_verts[mask], atol=1e-4, rtol=0)


def test_auto_rule_above_the_cap_takes_the_unfused_pipeline(monkeypatch) -> None:
    # Order 5 on the canyon with megakernel=None: the kernel while its cap
    # allows, the unfused pipeline (anyhit.cu) above it; both equal megakernel=False.
    device = cuda_or_skip()
    scene = Scene(
        transmitters=torch.tensor([[-30.0, 0.0, 20.0]], device=device),
        receivers=torch.tensor([[x, 3.0, 1.5] for x in (-35.0, -10.0, 15.0, 40.0)], device=device),
        mesh=scenes.street_canyon_scene(device=device).mesh,
    )
    want = scene.trace_paths(order=5, megakernel=False)
    assert want.num_valid_paths > 0
    for cap, kernel in ((_trace.MAX_ORDER, _trace), (4, _rt)):
        monkeypatch.setattr(_trace, "MAX_ORDER", cap)
        launches = kernel.LAUNCHES
        got = scene.trace_paths(order=5)
        torch.cuda.synchronize()
        assert kernel.LAUNCHES == launches + 1
        assert torch.equal(got.mask, want.mask)
        torch.testing.assert_close(got.vertices[got.mask], want.vertices[want.mask], atol=1e-4, rtol=0)


def test_unfused_pipeline_takes_a_tx_that_requires_a_gradient() -> None:
    device = cuda_or_skip()
    scene = Scene(
        transmitters=torch.tensor([[-30.0, 0.5, 20.0]], device=device),
        mesh=scenes.street_canyon_scene(device=device).mesh,
    ).with_receivers_grid(8, 8)
    launches, calls = _rt.LAUNCHES, _rt.REFERENCE_CALLS
    _, grads, paths = _length_gradients(scene, 1, False)
    torch.cuda.synchronize()
    assert (_rt.LAUNCHES, _rt.REFERENCE_CALLS) == (launches + 1, calls)
    assert paths.mask.dtype == torch.bool and paths.num_valid_paths > 0
    assert all(torch.isfinite(g).all() for g in grads)


def test_streamed_placement_step_on_the_card(torch_backend) -> None:
    from differt_tpu_torch.parallel import streamed_placement_step

    device = cuda_or_skip()
    scene = Scene(
        transmitters=torch.tensor([[-30.0, 0.5, 20.0], [12.0, -2.0, 6.0]], device=device),
        mesh=scenes.street_canyon_scene(device=device).mesh.set_materials("Concrete"),
    ).with_receivers_grid(12, 10)
    num = scene.mesh.num_primitives
    kw = {
        "tx": scene.transmitters,
        "eta_r": torch.tensor([5.24], device=device),
        "conductivity": torch.tensor([0.1], device=device),
        "path_candidates": [
            generate_path_candidates(num, order, device=device) for order in (1, 2)
        ],
        "candidate_chunk": 64,
        "rx_chunk": 50,
        "tx_learning_rate": 1.0,
        "eta_learning_rate": 1.0,
    }
    tiles = 3 * (-(-num // 64) + -(-(num * (num - 1)) // 64))
    launches, calls, builds = _trace.LAUNCHES, _trace.REFERENCE_CALLS, _bvh.BUILDS
    got = streamed_placement_step(scene, 2.4e9, **kw)
    torch.cuda.synchronize()
    # Each tile is traced in pass 1 and again in pass 3; the mesh's BVH is built once.
    assert _trace.LAUNCHES == launches + 2 * tiles
    assert (_trace.REFERENCE_CALLS, _bvh.BUILDS) == (calls, builds + 1)
    torch_backend()
    want = streamed_placement_step(scene, 2.4e9, **kw)
    assert _trace.LAUNCHES == launches + 2 * tiles
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    for new, ref, start in zip(got, want, (kw["tx"], kw["eta_r"])):
        g, w = start - new, start - ref
        assert torch.isfinite(g).all() and g.abs().max() > 0
        torch.testing.assert_close(g, w, rtol=2e-3, atol=2e-3 * float(w.abs().max()))


def test_smoothed_trace_on_the_card_is_plain_pytorch() -> None:
    device = cuda_or_skip()
    scene = Scene(
        transmitters=torch.tensor([[-30.0, 0.5, 20.0]], device=device),
        mesh=scenes.street_canyon_scene(device=device).mesh,
    ).with_receivers_grid(8, 8)
    counts = (_trace.LAUNCHES, _rt.LAUNCHES)
    tx = scene.transmitters.clone().requires_grad_()
    candidates = generate_path_candidates(scene.mesh.num_primitives, 1, device=device)
    paths = trace_path_candidates(
        scene.mesh, tx, scene.receivers.reshape(-1, 3), candidates, smoothing_factor=50.0
    )
    assert (_trace.LAUNCHES, _rt.LAUNCHES) == counts  # megakernel=None: unfused, no kernel
    assert paths.mask.dtype == torch.float32 and float(paths.mask.detach().max()) > 0.9
    (grad,) = torch.autograd.grad(paths.mask.sum(), tx)
    assert torch.isfinite(grad).all() and grad.abs().max() > 0
    cpu = trace_path_candidates(
        _mesh_on_cpu(scene.mesh), tx.detach().cpu(),
        scene.receivers.reshape(-1, 3).cpu(), candidates.cpu(), smoothing_factor=50.0,
    )
    torch.testing.assert_close(paths.mask.detach().cpu(), cpu.mask, rtol=0, atol=1e-4)


def _mesh_on_cpu(mesh):
    """A copy of ``mesh`` on the CPU."""
    return dataclasses.replace(
        mesh,
        **{
            f.name: getattr(mesh, f.name).cpu()
            for f in dataclasses.fields(mesh)
            if f.init and isinstance(getattr(mesh, f.name), torch.Tensor)
        },
    )


@pytest.mark.parametrize(("num_tx", "grid"), [(70_000, 0), (1, 1_500)])
def test_trace_kernel_takes_many_transmitters_or_receivers(num_tx: int, grid: int) -> None:
    # More TXs than 65,535, or more receiver tiles than 65,535: sizes past the
    # limits of a launch grid's y and z dimensions. Ground reflections in the
    # street of the canyon (its last two triangles are the ground).
    device = cuda_or_skip()
    mesh = scenes.street_canyon_scene(device=device).mesh
    gen = torch.Generator().manual_seed(31)
    tx = torch.rand((num_tx, 3), generator=gen) * torch.tensor([60.0, 10.0, 20.0])
    tx = (tx + torch.tensor([-30.0, -5.0, 1.0])).to(device)
    scene = Scene(transmitters=tx, mesh=mesh)
    rx = (scene.with_receivers_grid(grid, grid).receivers.reshape(-1, 3) if grid
          else torch.tensor([[20.0, 0.0, 1.5]], device=device))
    candidates = torch.tensor([[24], [25]], device=device)
    _, tris, mirror_vertices, mirror_normals = candidate_geometry(mesh, candidates)
    args = (tx, rx.contiguous(), mirror_vertices, mirror_normals, tris,
            mesh.triangle_vertices.contiguous(), None)
    kw = {"order": 1, "epsilon": EPSILON, "hit_tol": HIT_TOL, "min_len": EPSILON}
    verts, mask = _trace.trace_specular_cuda(*args, **kw)
    want_verts, want_mask = _trace.trace_specular_reference(*args, **kw)
    assert torch.equal(mask, want_mask)
    assert int(mask.sum()) > 0
    torch.testing.assert_close(verts[mask], want_verts[mask], atol=1e-4, rtol=0)


def test_unfused_pipeline_uses_the_anyhit_kernel() -> None:
    device = cuda_or_skip()
    scene = Scene(
        transmitters=torch.tensor([[-30.0, 0.0, 20.0]], device=device),
        mesh=scenes.street_canyon_scene(device=device).mesh,
    ).with_receivers_grid(16, 16)
    launches, calls = _rt.LAUNCHES, _rt.REFERENCE_CALLS
    fused = scene.trace_paths(order=2)
    unfused = scene.trace_paths(order=2, megakernel=False)
    torch.cuda.synchronize()
    assert _rt.LAUNCHES == launches + 1 and _rt.REFERENCE_CALLS == calls
    assert torch.equal(fused.mask, unfused.mask)


def _closest_rays(tv: torch.Tensor, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Lattice rays from above the city (hits and misses), rays that miss
    everything, and rays starting on the faces they hit first."""
    n = 40_000
    down = fibonacci_lattice(n, device=device) * 500.0
    o_down = torch.tensor([10.0, -20.0, 30.0], device=device).expand(n, 3)
    up = fibonacci_lattice(2_000, device=device).abs() * 10.0
    o_up = torch.tensor([0.0, 0.0, 500.0], device=device).expand(2_000, 3)
    idx, t = _closest.first_triangle_hit_by_ray_reference(o_down, down, tv)
    on_face = (o_down + t[:, None] * down)[idx >= 0][:20_000]
    rng = np.random.default_rng(5)
    d_face = torch.from_numpy(rng.normal(size=on_face.shape).astype(np.float32)).to(device)
    origins = torch.cat((o_down, o_up, on_face)).contiguous()
    directions = torch.cat((down, up, d_face)).contiguous()
    return origins, directions


@pytest.mark.parametrize("leaf_size", [5, 8, 16])
@pytest.mark.parametrize("masked", [False, True])
def test_closest_kernel_matches_reference(masked: bool, leaf_size: int) -> None:
    device = cuda_or_skip()
    mesh = scenes.urban_scene(12, 12, device=device).mesh  # 5,186 triangles
    tv = mesh.triangle_vertices.contiguous()
    active = torch.from_numpy(triangle_mask(tv.shape[0], 31)).to(device) if masked else None
    o, d = _closest_rays(tv, device)
    bvh = _bvh.build_bvh(tv, active, leaf_size=leaf_size)
    launches = _closest.LAUNCHES
    idx, t = _closest.first_triangle_hit_by_ray_cuda(o, d, tv, active, bvh=bvh)
    torch.cuda.synchronize()
    assert _closest.LAUNCHES == launches + 1
    want_idx, want_t = _closest.first_triangle_hit_by_ray_reference(o, d, tv, active)
    # t is bit-equal: the kernel's Möller–Trumbore runs op for op as the
    # plain version's (--fmad=false).
    assert torch.equal(t, want_t)
    assert bool((idx[40_000:42_000] == -1).all())  # the upward rays miss
    assert 0 < int((idx >= 0).sum()) < idx.numel()
    # Every index is the tie key's winner among the triangles hit at that t.
    winner = _closest.tie_key_winner(o, d, tv, active, want_t, bvh.positions)
    assert torch.equal(idx, winner)


def test_closest_tie_key_on_stacked_faces() -> None:
    # The phase-5 (b) inputs of chip_smoke.py, fewer rays: rays through the
    # mask's holes meet the coincident faces of the stacked boxes.
    device = cuda_or_skip()
    tv = scenes.urban_scene(8, 8, device=device).mesh.triangle_vertices.contiguous()
    active = torch.arange(tv.shape[0], device=device) % 3 != 0
    n = 200_000
    o = torch.tensor([0.0, 0.0, 30.0], device=device).expand(n, 3).contiguous()
    d = (fibonacci_lattice(n, device=device) * 500.0).contiguous()
    idx, t = _closest.first_triangle_hit_by_ray_cuda(o, d, tv, active)
    want_idx, want_t = _closest.first_triangle_hit_by_ray_reference(o, d, tv, active)
    assert torch.equal(t, want_t)
    positions = _bvh.build_bvh(tv, active).positions
    winner = _closest.tie_key_winner(o, d, tv, active, want_t, positions)
    assert torch.equal(idx, winner)
    assert int((winner != want_idx).sum()) > 0  # ties the two rules break differently


def test_paths_build_the_bvh_once_per_mesh() -> None:
    device = cuda_or_skip()
    scene = Scene(
        transmitters=torch.tensor([[-30.0, 0.0, 20.0]], device=device),
        mesh=scenes.street_canyon_scene(device=device).mesh,
    ).with_receivers_grid(8, 8)
    builds = _bvh.BUILDS
    scene.trace_paths(order=1)
    scene.trace_paths(order=0)
    scene.launch_paths(order=1, num_rays=1000, max_dist=1.0)
    assert _bvh.BUILDS == builds + 1


def _street_scene(device) -> Scene:
    mesh = scenes.urban_scene(4, 4, device=device).mesh
    y, x = torch.meshgrid(
        50.0 * torch.arange(-1, 2, device=device),
        50.0 * torch.arange(-1, 2, device=device),
        indexing="ij",
    )
    rx = torch.stack((x, y, torch.full_like(x, 1.5)), dim=-1)
    return Scene(
        transmitters=torch.tensor([[0.0, 0.0, 40.0]], device=device), receivers=rx, mesh=mesh
    )


@pytest.fixture
def torch_backend():
    yield lambda: ops.set_backend("torch")
    ops.set_backend("auto")


def test_launch_paths_through_the_kernel(torch_backend) -> None:
    device = cuda_or_skip()
    scene = _street_scene(device)
    launches, calls = _closest.LAUNCHES, _closest.REFERENCE_CALLS
    paths = scene.launch_paths(order=3, num_rays=50_000, max_dist=1.0)
    torch.cuda.synchronize()
    assert (_closest.LAUNCHES, _closest.REFERENCE_CALLS) == (launches + 4, calls)
    assert bool(paths.masks[..., 0].any()) and bool(paths.masks[..., 1:].any())
    torch_backend()
    plain = scene.launch_paths(order=3, num_rays=50_000, max_dist=1.0)
    assert _closest.REFERENCE_CALLS == calls + 4
    # Rays whose hits differ met an exact tie (coincident faces: each
    # building level's top and the next level's bottom), which the kernel
    # breaks in Morton order: at the first differing bounce both runs reach
    # the same point. Every other ray, and so every other mask, is equal.
    hits, want = paths.objects[0, 0, 0, :, 1:-1], plain.objects[0, 0, 0, :, 1:-1]
    tie_rays = (hits != want).any(dim=-1)
    first = (hits != want).int().argmax(dim=-1)[tie_rays]
    rows = torch.arange(first.numel(), device=device)
    assert torch.equal(
        paths.vertices[0, 0, 0, tie_rays, 1:-1][rows, first],
        plain.vertices[0, 0, 0, tie_rays, 1:-1][rows, first],
    )
    same = ~tie_rays
    assert torch.equal(paths.masks[..., same, :], plain.masks[..., same, :])


def test_compute_tx_mlm_through_the_kernel(torch_backend) -> None:
    device = cuda_or_skip()
    scene = _street_scene(device)
    kw = {"num_rays": 100_000, "order": 2, "grid_size": (64, 64), "receiver_plane_z": 1.5}
    launches, calls = _closest.LAUNCHES, _closest.REFERENCE_CALLS
    mlm = scene.compute_tx_mlm(**kw)
    torch.cuda.synchronize()
    assert (_closest.LAUNCHES, _closest.REFERENCE_CALLS) == (launches + 3, calls)
    torch_backend()
    plain = scene.compute_tx_mlm(**kw)
    assert _closest.REFERENCE_CALLS == calls + 3
    lit = int((plain != 0).sum())
    assert lit > 0
    # Cells that a tie ray reaches may differ: at most 0.1% of the lit cells.
    assert int((mlm != plain).sum()) <= max(1, lit // 1000)


@pytest.mark.parametrize("masked", [False, True])
def test_visibility_through_the_closest_kernel(masked: bool, torch_backend, monkeypatch) -> None:
    from differt_tpu_torch.ops import _dispatch
    from differt_tpu_torch.rt._scan import mark_visible

    device = cuda_or_skip()
    scene = _street_scene(device)
    mesh = scene.mesh
    if masked:
        mesh = mesh.set_mask(torch.from_numpy(triangle_mask(mesh.num_triangles, 41)).to(device))
    tv, mask = mesh.triangle_vertices.contiguous(), mesh.mask
    vertices = torch.cat((scene.transmitters, scene.receivers.reshape(-1, 3)))  # 10 vertices
    num_rays = 20_000
    launches, calls, builds = _closest.LAUNCHES, _closest.REFERENCE_CALLS, _bvh.BUILDS
    got = mesh.triangles_visible_from_vertex(vertices, num_rays=num_rays)
    torch.cuda.synchronize()
    # 200,000 rays: one launch, on the mesh's BVH, built once.
    assert (_closest.LAUNCHES, _closest.REFERENCE_CALLS, _bvh.BUILDS) == (launches + 1, calls, builds + 1)
    # The same rays through the kernel and its plain version: t bit-equal,
    # and every index that differs is the tie key's winner.
    d = _dispatch.visibility_rays(mesh, vertices, num_rays).reshape(-1, 3).contiguous()
    o = vertices[:, None, :].expand(-1, num_rays, 3).reshape(-1, 3).contiguous()
    idx, t = _closest.first_triangle_hit_by_ray_cuda(o, d, None, bvh=mesh.bvh)
    want_idx, want_t = _closest.first_triangle_hit_by_ray_reference(o, d, tv, mask)
    assert torch.equal(t, want_t)
    differ = idx != want_idx
    winner = _closest.tie_key_winner(o[differ], d[differ], tv, mask, want_t[differ], mesh.bvh.positions)
    assert torch.equal(idx[differ], winner)
    marked = torch.zeros((10, mesh.num_triangles + 1), dtype=torch.bool, device=device)
    mark_visible(marked, idx.reshape(10, num_rays))
    assert torch.equal(marked[:, :-1], got)
    assert bool(got.any(dim=-1).all()) and not bool(got.all())
    # Groups of two vertices: five launches, the same marks.
    monkeypatch.setattr(_dispatch, "VISIBILITY_RAYS", 2 * num_rays)
    launches = _closest.LAUNCHES
    assert torch.equal(mesh.triangles_visible_from_vertex(vertices, num_rays=num_rays), got)
    assert _closest.LAUNCHES == launches + 5
    # The plain version on the card (counted) scans all triangles at once,
    # the lowest index winning a tie: the marks differ only on triangles
    # that tie rays alone reach.
    torch_backend()
    calls = _closest.REFERENCE_CALLS
    plain = mesh.triangles_visible_from_vertex(vertices, num_rays=num_rays)
    assert _closest.REFERENCE_CALLS == calls + 1
    scans = [
        first_triangle_hit_by_ray(o[lo : lo + num_rays], d[lo : lo + num_rays], tv, mask, batch_size=None)
        for lo in range(0, o.shape[0], num_rays)
    ]
    scan_idx = torch.cat([idx_ for idx_, _ in scans])
    assert torch.equal(torch.cat([t_ for _, t_ in scans]), t)
    plain_marks = torch.zeros_like(marked)
    mark_visible(plain_marks, scan_idx.reshape(10, num_rays))
    assert torch.equal(plain_marks[:, :-1], plain)
    tie = idx != scan_idx
    tie_only = torch.zeros_like(marked)
    for hits in (idx, scan_idx):  # both winners of each tie ray
        mark_visible(tie_only, torch.where(tie, hits, -1).reshape(10, num_rays))
    assert not bool(((plain != got) & ~tie_only[:, :-1]).any())


def _composed_visibility(mesh, vertices: torch.Tensor, num_rays: int) -> torch.Tensor:
    """Visibility as separate steps on the card: the lattice rays of
    ``fibonacci_lattice`` (``visibility_rays``), ``closest.cu``'s ray
    launch on ``mesh.bvh``, then the marks of ``mark_visible``."""
    from differt_tpu_torch.ops._dispatch import visibility_rays
    from differt_tpu_torch.rt._scan import mark_visible

    d = visibility_rays(mesh, vertices, num_rays)
    o = vertices[:, None, :].expand_as(d)
    idx, _ = _closest.first_triangle_hit_by_ray_cuda(
        o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous(), None, bvh=mesh.bvh
    )
    marks = torch.zeros((vertices.shape[0], mesh.num_triangles + 1), dtype=torch.bool, device=vertices.device)
    return mark_visible(marks, idx.reshape(vertices.shape[0], num_rays))[:, :-1]


def _visibility_case(name: str, device):
    """A mesh and the vertices that look at it."""
    if name == "box_inside":
        box = Mesh.box(10.0, 10.0, 10.0, with_top=True, device=device)
        return box, torch.tensor([[0.0, 0.0, 0.0], [1.0, -2.0, 3.0], [-4.0, 4.0, -4.5]], device=device)
    scene = _street_scene(device)
    mesh = scene.mesh
    if name == "street_masked":
        mesh = mesh.set_mask(torch.from_numpy(triangle_mask(mesh.num_triangles, 41)).to(device))
    return mesh, torch.cat((scene.transmitters, scene.receivers.reshape(-1, 3)))


@pytest.mark.parametrize("num_rays", [1, 2, 1_000, 50_000])
@pytest.mark.parametrize("case", ["street", "street_masked", "box_inside"])
def test_lattice_visibility_is_the_composition(case: str, num_rays: int) -> None:
    from differt_tpu_torch.ops._dispatch import visibility_groups

    device = cuda_or_skip()
    mesh, vertices = _visibility_case(case, device)
    groups = len(visibility_groups(vertices.shape[0], num_rays))
    launches = (_closest.LAUNCHES, _closest.LATTICE_LAUNCHES, _closest.REFERENCE_CALLS)
    got = mesh.triangles_visible_from_vertex(vertices, num_rays=num_rays)
    torch.cuda.synchronize()
    now = (_closest.LAUNCHES, _closest.LATTICE_LAUNCHES, _closest.REFERENCE_CALLS)
    assert tuple(b - a for a, b in zip(launches, now)) == (groups, groups, 0)
    assert torch.equal(got, _composed_visibility(mesh, vertices, num_rays))
    if num_rays >= 1_000:
        assert bool(got.any(dim=-1).all())
    if case == "box_inside" and num_rays >= 1_000:
        assert bool(got.all())  # from inside a closed box, every face


def test_lattice_visibility_over_two_groups(monkeypatch) -> None:
    from differt_tpu_torch.ops import _dispatch

    device = cuda_or_skip()
    mesh, vertices = _visibility_case("street", device)
    num_rays = 20_000
    monkeypatch.setattr(_dispatch, "VISIBILITY_RAYS", 6 * num_rays)  # vertices 0-5, then 6-9
    assert _dispatch.visibility_groups(vertices.shape[0], num_rays) == [(0, 6), (6, 10)]
    launches = (_closest.LAUNCHES, _closest.LATTICE_LAUNCHES)
    got = mesh.triangles_visible_from_vertex(vertices, num_rays=num_rays)
    assert (_closest.LAUNCHES, _closest.LATTICE_LAUNCHES) == (launches[0] + 2, launches[1] + 2)
    assert torch.equal(got, _composed_visibility(mesh, vertices, num_rays))


def test_lattice_visibility_on_the_city() -> None:
    # urban_scene(24, 24), the hybrid cell's city: its TX and 8 receivers on
    # the street centrelines, 1,000,000 rays each (9 M rays, one launch).
    device = cuda_or_skip()
    mesh = scenes.urban_scene(24, 24, device=device).mesh
    rx = [[50.0 * x, 50.0 * y, 1.5] for x, y in ((-4, -2), (-2, 1), (0, 0), (1, -3), (2, 2), (3, -1), (4, 3), (-3, 4))]
    vertices = torch.tensor([[0.0, 0.0, 40.0], *rx], device=device)
    launches = (_closest.LAUNCHES, _closest.LATTICE_LAUNCHES)
    got = mesh.triangles_visible_from_vertex(vertices, num_rays=1_000_000)
    assert (_closest.LAUNCHES, _closest.LATTICE_LAUNCHES) == (launches[0] + 1, launches[1] + 1)
    assert torch.equal(got, _composed_visibility(mesh, vertices, 1_000_000))
    assert bool(got.any(dim=-1).all()) and not bool(got.all(dim=-1).any())


def test_native_dfs_builds_and_fills_card_tensors() -> None:
    from differt_tpu_torch import native

    device = cuda_or_skip()
    assert native.is_available() and native.library_path().is_file()
    rng = np.random.default_rng(5)
    masks = [torch.from_numpy(rng.random(300) >= 0.5).to(device) for _ in range(3)]
    got = native.filtered_path_candidates(300, 2, *masks, device=device)
    assert got.device.type == "cuda" and got.dtype == torch.int64
    assert torch.equal(got, native.filtered_path_candidates_chunked(300, 2, *masks, device=device))


def test_hybrid_order_1_uses_the_kernels_only() -> None:
    from differt_tpu_torch import coverage, native
    from differt_tpu_torch.rt import HybridPathTracer

    device = cuda_or_skip()
    scene = _street_scene(device)
    tracer = HybridPathTracer(num_rays=20_000)
    candidates, _ = tracer.generate_path_candidates(scene, 1)
    chunks = -(-candidates.shape[0] // 4096)
    run = dataclasses.replace(scene, mesh=dataclasses.replace(scene.mesh))
    counts = (_closest.LAUNCHES, _closest.REFERENCE_CALLS, _trace.LAUNCHES, _trace.REFERENCE_CALLS,
              _rt.LAUNCHES, _rt.REFERENCE_CALLS, _bvh.BUILDS, native.CALLS, native.FALLBACK_CALLS)
    power = coverage.power_map_chunked(run, 2.4e9, order=1, solver=tracer, coherent=False)
    torch.cuda.synchronize()
    now = (_closest.LAUNCHES, _closest.REFERENCE_CALLS, _trace.LAUNCHES, _trace.REFERENCE_CALLS,
           _rt.LAUNCHES, _rt.REFERENCE_CALLS, _bvh.BUILDS, native.CALLS, native.FALLBACK_CALLS)
    # Visibility: one launch for the TX, one for the 9 receivers; the trace a chunk.
    assert tuple(b - a for a, b in zip(counts, now)) == (2, 0, chunks, 0, 0, 0, 1, 1, 0)
    exhaustive = coverage.power_map_chunked(scene, 2.4e9, order=1, coherent=False)
    assert bool((power > 0).any()) and bool((power <= exhaustive * (1 + 1e-5)).all())


def _canyon_diffraction_scene(device) -> Scene:
    rx = torch.tensor(
        [[x, y, 1.5] for x in (-20.0, 0.0, 20.0, 35.0) for y in (-3.0, 3.0)], device=device
    )
    return Scene(
        transmitters=torch.tensor([[-30.0, 0.0, 20.0]], device=device),
        receivers=rx,
        mesh=scenes.street_canyon_scene(device=device).mesh,
    )


def test_anyhit_kernel_on_diffraction_segments() -> None:
    from differt_tpu_torch.ops._dispatch import anyhit_segments
    from differt_tpu_torch.rt._diffraction import keller_paths

    device = cuda_or_skip()
    scene = _canyon_diffraction_scene(device)
    mesh = scene.mesh.dedup_vertices()
    edges, _, _ = mesh._diffraction_edges_info()
    paths, _ = keller_paths(scene.transmitters, scene.receivers, edges)
    o, d, th = anyhit_segments(paths[..., :-1, :], paths[..., 1:, :] - paths[..., :-1, :])
    tv = mesh.triangle_vertices.contiguous()
    want = _rt.ray_intersect_any_triangle_reference(o, d, tv, None, hit_threshold=th)
    got = _rt.ray_intersect_any_triangle_cuda(o, d, None, hit_threshold=th, bvh=mesh.bvh)
    assert o.shape[0] == 2 * 8 * edges.shape[0]
    assert torch.equal(got, want) and bool(got.any()) and not bool(got.all())


def test_fresnel_integrals_on_the_card() -> None:
    from scipy import special

    from differt_tpu_torch.em import fresnel

    device = cuda_or_skip()
    x = torch.linspace(-10.0, 10.0, 1_000_001, device=device, requires_grad=True)
    s, c = fresnel(x)
    s_ref, c_ref = special.fresnel(x.detach().double().cpu().numpy())
    assert np.abs(s.detach().cpu().numpy() - s_ref).max() <= 1e-6
    assert np.abs(c.detach().cpu().numpy() - c_ref).max() <= 1e-6
    g_s, = torch.autograd.grad(s.sum(), x, retain_graph=True)
    g_c, = torch.autograd.grad(c.sum(), x)
    arg = 0.5 * np.pi * x.detach().double().cpu().numpy() ** 2
    assert np.abs(g_s.cpu().numpy() - np.sin(arg)).max() <= 1e-5
    assert np.abs(g_c.cpu().numpy() - np.cos(arg)).max() <= 1e-5


def test_diffraction_map_kernel_against_plain(torch_backend) -> None:
    from differt_tpu_torch import coverage

    device = cuda_or_skip()
    scene = _canyon_diffraction_scene(device)
    run = dataclasses.replace(scene, mesh=dataclasses.replace(scene.mesh))
    counts = (_rt.LAUNCHES, _rt.REFERENCE_CALLS, _trace.LAUNCHES, _trace.REFERENCE_CALLS, _bvh.BUILDS)
    power = coverage.power_map(run, 2.4e9, order=1, with_diffraction=True)
    torch.cuda.synchronize()
    now = (_rt.LAUNCHES, _rt.REFERENCE_CALLS, _trace.LAUNCHES, _trace.REFERENCE_CALLS, _bvh.BUILDS)
    # One any-hit launch (the blockage), one trace launch (order 1), one BVH.
    assert tuple(b - a for a, b in zip(counts, now)) == (1, 0, 1, 0, 1)
    torch_backend()
    plain = coverage.power_map(scene, 2.4e9, order=1, with_diffraction=True)
    assert bool(torch.isfinite(power).all()) and bool((power > 0).all())
    lit = plain >= plain.max() * 1e-4
    err = (10.0 * torch.log10(power[lit].double() / plain[lit].double())).abs().max()
    assert float(err) <= 0.01


def _urban_mixed_scene(device) -> Scene:
    """urban_scene(2, 2) (146 triangles, 144 edges), the TX above the central crossing, 4 street receivers."""
    rx = torch.tensor([[50.0, 0.0, 1.5], [0.0, -50.0, 1.5], [-50.0, 0.0, 1.5], [25.0, 50.0, 1.5]], device=device)
    return Scene(
        transmitters=torch.tensor([[0.0, 0.0, 40.0]], device=device),
        receivers=rx,
        mesh=scenes.urban_scene(2, 2, device=device).mesh,
    )


@pytest.mark.parametrize("kind", ["mixed", "scattering"])
def test_anyhit_kernel_on_mixed_and_scattering_segments(kind: str) -> None:
    from differt_tpu_torch.ops._dispatch import anyhit_segments

    device = cuda_or_skip()
    scene = _urban_mixed_scene(device)
    mesh = scene.mesh.dedup_vertices()
    launches = _rt.LAUNCHES
    paths = scene.trace_mixed_paths((0, 1)) if kind == "mixed" else scene.trace_scattering_paths()
    torch.cuda.synchronize()
    assert _rt.LAUNCHES == launches + 1
    v = paths.vertices
    o, d, th = anyhit_segments(v[..., :-1, :], v[..., 1:, :] - v[..., :-1, :])
    tv = mesh.triangle_vertices.contiguous()
    want = _rt.ray_intersect_any_triangle_reference(o, d, tv, None, hit_threshold=th)
    got = _rt.ray_intersect_any_triangle_cuda(o, d, None, hit_threshold=th, bvh=mesh.bvh)
    assert torch.equal(got, want) and bool(got.any()) and not bool(got.all())
    assert bool(paths.mask.any())


def test_mixed_map_on_the_card_against_the_cpu(torch_backend) -> None:
    """The whole map on the card: the kernels' run equals the plain run
    there; against the CPU, the Fermat points of the two devices stop apart
    within float32's resolution of the path length (centimetres along long
    edges at city scale), so the maps agree within 0.1 dB."""
    from differt_tpu_torch import coverage
    from differt_tpu_torch.rt._mixed import MixedPathTracer

    device = cuda_or_skip()
    scene = _urban_mixed_scene(device)
    run = dataclasses.replace(scene, mesh=dataclasses.replace(scene.mesh))
    options = {"order": 1, "with_diffraction": True, "mixed_signatures": [(0, 1), (1, 0)], "with_scattering": True}
    materials = {"eta_r": torch.tensor([5.24]), "conductivity": torch.tensor([0.1])}
    counts = (_rt.LAUNCHES, _rt.REFERENCE_CALLS, _trace.LAUNCHES, _trace.REFERENCE_CALLS, _bvh.BUILDS)
    power = coverage.power_map(run, 2.4e9, **options, **materials)
    torch.cuda.synchronize()
    now = (_rt.LAUNCHES, _rt.REFERENCE_CALLS, _trace.LAUNCHES, _trace.REFERENCE_CALLS, _bvh.BUILDS)
    # Any-hit: the diffraction half, two signatures, the scattering; one trace; one BVH.
    assert tuple(b - a for a, b in zip(counts, now)) == (4, 0, 1, 0, 1)
    cpu = dataclasses.replace(
        scene, transmitters=scene.transmitters.cpu(), receivers=scene.receivers.cpu(), mesh=_mesh_on_cpu(scene.mesh)
    )
    on_cpu = coverage.power_map(cpu, 2.4e9, **options, **materials)
    paths = MixedPathTracer().trace_paths(scene, (1, 0))
    cpu_paths = MixedPathTracer().trace_paths(cpu, (1, 0))
    torch_backend()
    plain = coverage.power_map(scene, 2.4e9, **options, **materials)
    assert bool(torch.isfinite(power).all()) and bool((power > 0).all())

    def db_err(got, want):
        lit = want >= want.max() * 1e-4
        return float((10.0 * torch.log10(got[lit].double() / want[lit].double())).abs().max())

    assert db_err(power, plain) <= 0.01
    assert db_err(power.cpu(), on_cpu) <= 0.1
    # The paths: the same masks where the points agree, the same lengths where both are valid.
    v, cpu_v = paths.vertices.cpu(), cpu_paths.vertices
    apart = (v - cpu_v).abs().amax(dim=(-1, -2)) > 1e-4
    mask = paths.mask.cpu()
    assert bool(mask.any()) and torch.equal(mask[~apart], cpu_paths.mask[~apart])
    both = mask & cpu_paths.mask
    lengths = [(x[..., 1:, :] - x[..., :-1, :]).double().norm(dim=-1).sum(-1)[both] for x in (v, cpu_v)]
    assert float((lengths[0] - lengths[1]).abs().max() / lengths[1].max()) <= 1e-6


def _loaded_city(device, tmp_path) -> Scene:
    """urban_scene(4, 4) written as a Sionna scene and loaded back on the card, with the TX at 40 m and 8 street receivers."""
    from differt_tpu_torch import io

    path = io.export_scene_xml(scenes.urban_scene(4, 4, device=device).mesh, tmp_path / "city")
    loaded = Scene.load_xml(path, device=device)
    rx = torch.tensor([[x, y, 1.5] for x in (-50.0, 0.0, 50.0, 100.0) for y in (-50.0, 0.0)], device=device)
    return dataclasses.replace(loaded, transmitters=torch.tensor([[0.0, 0.0, 40.0]], device=device), receivers=rx)


def test_loaded_city_builds_its_bvh_once(tmp_path) -> None:
    device = cuda_or_skip()
    scene = _loaded_city(device, tmp_path)
    assert scene.mesh.device.type == "cuda" and scene.mesh.num_triangles == 578
    counts = (_bvh.BUILDS, _rt.LAUNCHES, _rt.REFERENCE_CALLS, _trace.LAUNCHES, _trace.REFERENCE_CALLS)
    paths = [scene.trace_paths(order=order) for order in (0, 1, 2)]
    torch.cuda.synchronize()
    now = (_bvh.BUILDS, _rt.LAUNCHES, _rt.REFERENCE_CALLS, _trace.LAUNCHES, _trace.REFERENCE_CALLS)
    assert tuple(b - a for a, b in zip(counts, now)) == (1, 1, 0, 2, 0)
    assert all(bool(p.mask.any()) for p in paths)


def test_deepmimo_export_on_the_card_equals_the_plain_run(tmp_path, torch_backend) -> None:
    from differt_tpu_torch.plugins import deepmimo

    device = cuda_or_skip()
    scene = _loaded_city(device, tmp_path)

    def export():
        fresh = dataclasses.replace(scene, mesh=dataclasses.replace(scene.mesh))
        paths = [fresh.trace_paths(order=order) for order in (0, 1, 2)]
        return deepmimo.export(paths=paths, scene=fresh, frequency=2.4e9, include_primitives=True)

    got = export()
    torch_backend()
    want = export()
    mask = want.mask
    assert torch.equal(got.mask, mask) and int(mask.sum()) > 8
    assert torch.equal(got.inter, want.inter) and torch.equal(got.primitives, want.primitives)
    assert float((got.power[mask] - want.power[mask]).abs().max()) <= 0.01
    turn = torch.deg2rad(got.phase[mask].double() - want.phase[mask].double())
    assert float(torch.rad2deg(torch.abs(torch.polar(torch.ones_like(turn), turn) - 1.0)).max()) <= 0.01
    torch.testing.assert_close(got.delay[mask], want.delay[mask], rtol=1e-6, atol=0.0)
    assert bool(torch.isfinite(got.power[mask]).all())


def test_sharded_power_map_on_a_world_of_one_equals_power_map() -> None:
    """``make_device_mesh(1)`` makes a one-rank NCCL group on the card; its map is the single device's, bit for bit."""
    import torch.distributed as dist

    from differt_tpu_torch import coverage, parallel

    device = cuda_or_skip()
    scene = scenes.street_canyon_scene(device=device)
    scene = Scene(transmitters=torch.tensor([[-30.0, 0.0, 20.0]], device=device), mesh=scene.mesh)
    scene = scene.with_receivers_grid(9, 7)
    mesh = parallel.make_device_mesh(1)
    try:
        assert dist.get_backend() == "nccl" and mesh.device == torch.device("cuda", torch.cuda.current_device())
        launches = _trace.LAUNCHES
        got = parallel.sharded_power_map(scene, 2.4e9, mesh, order=1)
        assert _trace.LAUNCHES == launches + 1
    finally:
        dist.destroy_process_group()
    want = coverage.power_map(scene, 2.4e9, order=1)
    assert torch.equal(got, want) and float(want.max()) > 0.0


def _em_tile(device, order: int, num_cand: int, seed: int, num_rx: int = 4_096) -> dict:
    """A synthetic tile of the XL map's shape ([1, num_rx, num_cand], the trace's memory layout).

    Random paths over +-200 m and 0-60 m (phases of 10^4 rad, as on the
    city), a third of them valid, with bounces of other types and padded
    ones (object -1), face materials in and out of the three-material
    table, and a slab, a half-space and a metal.
    """
    gen = torch.Generator(device=device).manual_seed(seed)
    mesh = scenes.urban_scene(4, 4, device=device).mesh
    num_tri = mesh.num_triangles
    lo = torch.tensor([-200.0, -200.0, 0.0], device=device)
    span = torch.tensor([400.0, 400.0, 60.0], device=device)
    verts = lo + span * torch.rand((1, num_cand, num_rx, order + 2, 3), generator=gen, device=device)
    mask = torch.rand((1, num_cand, num_rx), generator=gen, device=device) < 1.0 / 3.0
    objects = torch.randint(0, num_tri, (num_cand, order), generator=gen, device=device)
    types = torch.zeros((num_cand, order), dtype=torch.int32, device=device)
    if order > 1:
        objects[::7, -1] = -1
        types[::7, -1] = -1
        types[3::11, 0] = 2
    materials = torch.randint(-1, 5, (num_tri,), generator=gen, device=device)
    return {
        "vertices": verts.transpose(1, 2),
        "mask": mask.transpose(1, 2),
        "objects": objects,
        "interaction_types": types,
        "mesh": dataclasses.replace(mesh, face_materials=materials),
        "frequency": torch.tensor(2.4e9, device=device),
        "eta_r": torch.tensor([5.24, 3.0, 1.0], device=device),
        "conductivity": torch.tensor([0.12, 0.02, 1e7], device=device),
        "thickness": torch.tensor([0.2, -1.0, 0.05], device=device),
    }


def _em_sums(fn, tile: dict, coherent: bool) -> torch.Tensor:
    args = [tile[k] for k in ("vertices", "mask", "objects", "interaction_types", "mesh", "frequency")]
    return fn(
        *args, eta_r=tile["eta_r"], conductivity=tile["conductivity"], thickness=tile["thickness"],
        coherent=coherent,
    )


@pytest.mark.parametrize(
    ("order", "num_cand", "coherent"),
    [(1, 4_096, True), (2, 4_096, True), (2, 4_096, False), (4, 1_024, True)],
)
def test_em_kernel_matches_its_twin(order: int, num_cand: int, coherent: bool) -> None:
    """``csrc/em.cu`` against ``complex_amplitudes`` summed, on the card, at the XL map's tile width.

    The kernel rounds every real operation as the plain chain does (the
    phase, of 10^4 rad, to the bit); complex products, quotients and roots
    may round apart by an ulp (PyTorch's build contracts them into fused
    multiply-adds), and the sums over 1,365 valid paths a pixel run in
    another order: float32 closeness, 1e-4 of the largest sum. The sum
    order is fixed, so two launches give the same bits.
    """
    from differt_tpu_torch.ops import _em

    device = cuda_or_skip()
    tile = _em_tile(device, order, num_cand, seed=100 + order)
    launches = _em.LAUNCHES
    got = _em_sums(_em.em_tile_sum, tile, coherent)
    again = _em_sums(_em.em_tile_sum, tile, coherent)
    torch.cuda.synchronize()
    assert _em.LAUNCHES == launches + 2
    want = _em_sums(_em.em_tile_sum_reference, tile, coherent)
    assert torch.equal(got, again)
    scale = float(want.abs().max())
    assert scale > 0.0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


def test_em_kernel_takes_a_tile_with_no_valid_path_and_many_transmitters() -> None:
    from differt_tpu_torch.ops import _em

    device = cuda_or_skip()
    tile = _em_tile(device, 2, 64, seed=7, num_rx=100)
    tile["vertices"] = tile["vertices"].expand(3, -1, -1, -1, -1)  # three TX, stride 0
    tile["mask"] = tile["mask"].expand(3, -1, -1).clone()
    tile["mask"][1] = False
    got = _em_sums(_em.em_tile_sum, tile, True)
    want = _em_sums(_em.em_tile_sum_reference, tile, True)
    assert not got[1].any() and bool(got[0].abs().max() > 0)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


def _near_city(device, grid: int) -> tuple[Scene, torch.Tensor]:
    """urban_scene(8, 8) with its TX at 40 m, a grid around it, and the order-2 candidates of the 40 triangles nearest it."""
    mesh = scenes.urban_scene(8, 8, device=device).mesh.set_materials("Concrete")
    tx = torch.tensor([[10.0, 5.0, 40.0]], device=device)
    centres = mesh.triangle_vertices.mean(dim=1)
    near = torch.argsort(((centres - tx) ** 2).sum(-1))[:40]
    pairs = torch.cartesian_prod(near, near)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    scene = Scene(transmitters=tx, mesh=mesh).with_receivers_grid(grid, grid, height=1.5)
    return scene, pairs


def _lit_db_gap(got: torch.Tensor, want: torch.Tensor, window_db: float = 40.0) -> float:
    """Largest |dB| difference over the pixels that either map lights within ``window_db`` of the plain map's brightest."""
    got, want = got.double().cpu(), want.double().cpu()
    floor = float(want.max()) * 10.0 ** (-window_db / 10.0)
    lit = (want >= floor) | (got >= floor)
    ratio = got[lit].clamp(min=1e-300) / want[lit].clamp(min=1e-300)
    return float((10.0 * torch.log10(ratio)).abs().max())


@pytest.mark.parametrize("coherent", [True, False], ids=["coherent", "power"])
def test_power_map_chunked_fused_against_plain(coherent: bool, monkeypatch) -> None:
    """The map with the fused EM tile against the plain chain (the fused path forced off).

    The two sum the same paths in another order, with complex operations
    that may round an ulp apart: within 0.05 dB on every lit pixel.
    """
    from differt_tpu_torch import coverage
    from differt_tpu_torch.ops import _em

    device = cuda_or_skip()
    scene, pairs = _near_city(device, 64)
    kw = {"path_candidates": pairs, "candidate_chunk": 512, "rx_chunk": 1_024, "coherent": coherent}
    tiles = -(-pairs.shape[0] // 512) * 4
    launches = _em.LAUNCHES
    got = coverage.power_map_chunked(scene, 2.4e9, order=2, **kw)
    assert _em.LAUNCHES == launches + tiles
    monkeypatch.setattr(coverage, "_fused_em", lambda *args: False)
    want = coverage.power_map_chunked(scene, 2.4e9, order=2, **kw)
    assert _em.LAUNCHES == launches + tiles
    assert float(want.max()) > 0.0
    assert _lit_db_gap(got, want) <= 0.05


def test_streamed_step_pass1_fused_against_plain(monkeypatch) -> None:
    """The step's loss and update with pass 1 on the fused EM tile against the plain chain.

    Pass 1's pixel sums feed the loss and pass 3's cotangents; they differ
    from the plain chain's by float32 rounding alone: the loss within 1e-5
    of its value, each update within 3e-3 of its norm.
    """
    from differt_tpu_torch import coverage
    from differt_tpu_torch.ops import _em
    from differt_tpu_torch.parallel import streamed_placement_step

    device = cuda_or_skip()
    scene, pairs = _near_city(device, 32)
    kw = {
        "tx": scene.transmitters,
        "eta_r": torch.tensor([5.24], device=device),
        "conductivity": torch.tensor([0.12], device=device),
        "path_candidates": [generate_path_candidates(scene.mesh.num_primitives, 1, device=device), pairs],
        "candidate_chunk": 512,
        "rx_chunk": 512,
    }
    launches = _em.LAUNCHES
    got = streamed_placement_step(scene, 2.4e9, **kw)
    fused = _em.LAUNCHES - launches
    assert fused > 0  # pass 1's tiles; pass 3's run the plain chain
    monkeypatch.setattr(coverage, "_fused_em", lambda *args: False)
    want = streamed_placement_step(scene, 2.4e9, **kw)
    assert _em.LAUNCHES - launches == fused
    assert abs(float(got[2]) - float(want[2])) <= 1e-5 * abs(float(want[2]))
    for name, new, plain in (("tx", got[0], want[0]), ("eta_r", got[1], want[1])):
        change, change_plain = kw[name] - new, kw[name] - plain
        norm = float(torch.linalg.vector_norm(change_plain.double()))
        assert norm > 0.0, name
        assert float(torch.linalg.vector_norm((change - change_plain).double())) <= 3e-3 * norm, name


def _count_plans(monkeypatch) -> list:
    """Spy on ``coverage._tile_plan``: the plans it made (None where the tiles took the plain chain)."""
    from differt_tpu_torch import coverage

    plans, real = [], coverage._tile_plan

    def spy(*args, **kwargs):
        plans.append(real(*args, **kwargs))
        return plans[-1]

    monkeypatch.setattr(coverage, "_tile_plan", spy)
    return plans


def _composed_rows(mesh, tx, rx, sets, chunk: int, rx_chunk: int, materials: dict, coherent: bool) -> list:
    """Each RX tile's sum over every set's chunks, composed chunk by chunk with no plan: each chunk's
    own geometry through ``trace_specular_cuda`` (order 0: the unfused trace, whose blockage test is
    the any-hit kernel), its padding masked out, then ``em_tile_sum`` on its own rows. ``rx`` and each
    set are padded here as the walk pads them."""
    from differt_tpu_torch.ops import _em
    from differt_tpu_torch.rt._solvers import candidate_rows, kernel_tolerances, trace_geometry

    epsilon, hit_tol, min_len = kernel_tolerances()
    k = 2 if mesh.assume_quads else 1
    rx = torch.cat((rx, rx[:1].expand(-rx.shape[0] % rx_chunk, 3)))
    rows = []
    for r0 in range(0, rx.shape[0], rx_chunk):
        rx_tile, acc = rx[r0 : r0 + rx_chunk], None
        for cands in sets:
            n, step = cands.shape[0], min(chunk, cands.shape[0])
            cands = torch.cat((cands, cands[:1].expand(-n % step, -1)))
            for lo in range(0, cands.shape[0], step):
                if cands.shape[1] == 0:
                    vertices, mask, triangles, _ = trace_geometry(mesh, tx, rx_tile, cands[lo : lo + step], megakernel=False)
                else:
                    triangles, tv, mv, mn = candidate_geometry(mesh, cands[lo : lo + step])
                    vertices, mask = _trace.trace_specular_cuda(
                        tx.contiguous(), rx_tile.contiguous(), mv, mn, tv, None, mesh.mask, order=cands.shape[1],
                        epsilon=epsilon, hit_tol=hit_tol, min_len=min_len, bvh=mesh.bvh,
                    )
                    vertices, mask = vertices.transpose(1, 2), mask.transpose(1, 2)
                    if mesh.mask is not None:
                        mask = mask & mesh.mask[triangles].all(dim=-1)
                mask = mask & (torch.arange(lo, lo + step, device=rx.device) < n)
                objects, types = candidate_rows(triangles, None, k)
                part = _em.em_tile_sum(vertices, mask, objects, types, mesh, coherent=coherent, **materials)
                acc = part if acc is None else acc + part
        rows.append(acc)
    return rows


def _composed_map(scene: Scene, cands, chunk: int, rx_chunk: int, coherent: bool = True) -> torch.Tensor:
    """``power_map_chunked``'s map at 2.4 GHz and the ITU materials, from :func:`_composed_rows`."""
    from differt_tpu_torch import coverage

    frequency = torch.tensor(2.4e9, device=scene.mesh.device)
    eta_r, conductivity, thickness = coverage.resolve_materials(scene, frequency, None, None, None)
    materials = {"frequency": frequency, "eta_r": eta_r, "conductivity": conductivity, "thickness": thickness}
    rx = scene.receivers.reshape(-1, 3)
    perm = _rt.morton_perm_points(rx)  # more receivers than a tile: the map orders them
    rows = _composed_rows(scene.mesh, scene.transmitters.reshape(-1, 3), rx[perm], [cands], chunk, rx_chunk, materials, coherent)
    total = torch.cat(rows, dim=-1)[..., : rx.shape[0]][..., torch.argsort(perm)]
    power = torch.abs(total) ** 2 / coverage.z_0 if coherent else total / coverage.z_0
    return power.reshape(*scene.transmitters.shape[:-1], *scene.receivers.shape[:-1])


@pytest.mark.parametrize(
    ("order", "chunk", "masked"),
    [(1, 512, False), (2, 520, False), (2, 512, False), (2, 520, True), (0, 512, False)],
    ids=["order_1", "order_2", "order_2_padded", "order_2_masked", "order_0"],
)
def test_power_map_chunked_plan_is_bit_equal_to_each_tile_laying_out_its_own(order, chunk, masked, monkeypatch) -> None:
    """The map through one plan of the candidate set against each chunk composed on its own in the
    test (``trace_specular_cuda``, or at order 0 the any-hit test, then ``em_tile_sum``): the kernels
    read the same bytes, so the maps are equal bit for bit; one trace (none at order 0) and one EM
    call a tile either way. Order 0 traces unfused: its plan holds the EM half alone."""
    from differt_tpu_torch import coverage
    from differt_tpu_torch.ops import _em

    device = cuda_or_skip()
    scene, pairs = _near_city(device, 64)  # 4,096 receivers: 4 tiles of 1,024
    if masked:
        mask = torch.ones(scene.mesh.num_triangles, dtype=torch.bool, device=device)
        mask[pairs[7, 1]] = False  # the 78 pairs that meet one of the 40 triangles
        scene = dataclasses.replace(scene, mesh=scene.mesh.set_mask(mask))
    cands = generate_path_candidates(scene.mesh.num_primitives, order, device=device) if order < 2 else pairs
    kw = {"order": order, "path_candidates": cands, "candidate_chunk": chunk, "rx_chunk": 1_024}
    tiles = -(-cands.shape[0] // chunk) * 4
    assert (cands.shape[0] % chunk != 0) == (order == 1 or chunk == 512)
    plans = _count_plans(monkeypatch)
    counts = (_trace.LAUNCHES, _em.LAUNCHES)
    got = coverage.power_map_chunked(scene, 2.4e9, **kw)
    torch.cuda.synchronize()
    assert len(plans) == 1 and plans[0] is not None
    assert (plans[0].mirrors is None) == (order == 0)
    assert (plans[0].active_rays is not None) == masked
    if masked:
        assert int((~plans[0].active_rays).sum()) == 78
    traces = 0 if order == 0 else tiles
    assert (_trace.LAUNCHES - counts[0], _em.LAUNCHES - counts[1]) == (traces, tiles)
    counts = (_trace.LAUNCHES, _em.LAUNCHES)
    want = _composed_map(scene, cands, chunk, 1_024)
    assert (_trace.LAUNCHES - counts[0], _em.LAUNCHES - counts[1]) == (traces, tiles)
    assert float(want.max()) > 0.0
    assert torch.equal(got, want)


def test_streamed_placement_loss_plan_is_bit_equal_to_each_tile_laying_out_its_own(monkeypatch) -> None:
    """Pass 1 through a plan per order's candidate set (the order-1 set padded) against each chunk
    composed on its own in the test: the same dB map and loss, bit for bit; one trace and one EM call
    a tile."""
    from differt_tpu_torch.coverage import z_0
    from differt_tpu_torch.ops import _em
    from differt_tpu_torch.parallel import streamed_placement_loss
    from differt_tpu_torch.parallel._sharding import _placement_loss, _power_db

    device = cuda_or_skip()
    scene, pairs = _near_city(device, 32)
    cands = [generate_path_candidates(scene.mesh.num_primitives, 1, device=device), pairs]
    kw = {
        "tx": scene.transmitters,
        "eta_r": torch.tensor([5.24], device=device),
        "conductivity": torch.tensor([0.12], device=device),
        "path_candidates": cands,
        "candidate_chunk": 512,
        "rx_chunk": 512,
    }
    tiles = sum(-(-c.shape[0] // 512) for c in cands) * 2  # 1,024 receivers: 2 tiles
    assert cands[0].shape[0] % 512 != 0
    plans = _count_plans(monkeypatch)
    counts = (_trace.LAUNCHES, _em.LAUNCHES)
    got = [streamed_placement_loss(scene, 2.4e9, **kw, return_db_map=db) for db in (True, False)]
    torch.cuda.synchronize()
    assert len(plans) == 4 and all(p is not None and p.mirrors is not None for p in plans)  # two sets a call
    assert (_trace.LAUNCHES - counts[0], _em.LAUNCHES - counts[1]) == (2 * tiles, 2 * tiles)
    counts = (_trace.LAUNCHES, _em.LAUNCHES)
    materials = {"frequency": torch.tensor(2.4e9, device=device), "eta_r": kw["eta_r"], "conductivity": kw["conductivity"]}
    rows = _composed_rows(scene.mesh, kw["tx"], scene.receivers.reshape(-1, 3), cands, 512, 512, materials, True)
    assert (_trace.LAUNCHES - counts[0], _em.LAUNCHES - counts[1]) == (tiles, tiles)
    total = torch.stack(rows).transpose(0, 1).reshape(len(kw["tx"]), -1)[..., : scene.receivers[..., 0].numel()]
    re, im = total.real.clone(), total.imag.clone()
    want = [_power_db((re**2 + im**2) / z_0), _placement_loss(re, im, None)]
    assert bool((want[0] > -300.0).any())
    for g, w in zip(got, want):
        assert torch.equal(g, w)
