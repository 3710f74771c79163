#!/usr/bin/env python3
"""Drive the PyTorch port's coverage and ray-launching paths once on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root, on a host with one H100:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``differt_tpu_torch/csrc/``,
checks each against its plain PyTorch version on the card, times each
alone (on a prepared BVH), inside its wrapper and beside its plain
version, and drives two paths, each counted from zero:

- coverage: ``power_map_chunked`` on the 20,738-triangle
  ``urban_scene(24, 24)``, orders 0, 1 and 2, through the any-hit and
  fused trace kernels;
- ray launching, at the width of the JAX bench's ``bench_config3``:
  ``Scene.launch_paths`` (SBR, order 3, 250,000 rays) and
  ``Scene.compute_tx_mlm`` (order 2, 500,000 rays, 128 x 128 cells) on the
  9,218-triangle ``urban_scene(16, 16)``, through the closest-hit kernel;

and checks that each path call went through its kernels, never through
their plain versions, and built its mesh's BVH once. Then it profiles
each path once. One line per phase; then the card, a JSON line with each
kernel's launches, error, times and bound; then, last,
``{"ok": true, "device": {...}}``. Any failure
raises (exit code != 0). There is no CPU path: without a CUDA device the
script fails at once.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

FREQUENCY = 2.4e9
HIT_TOL = 100.0 * float(np.finfo(np.float32).eps)
TRACE_KW = {
    "epsilon": 10.0 * float(np.finfo(np.float32).eps),
    "hit_tol": HIT_TOL,
    "min_len": 10.0 * float(np.finfo(np.float32).eps),
}
NUM_RAYS = 262_144
MAIN_CANDIDATES = 1_048_576  # The bench_cityscale (a) shape: 1,048,576 x 128 RX.
RAYCAST_RAYS = 1_000_000  # The bench_raycast shape, on urban_scene(8, 8).
SBR_ORDER, SBR_RAYS = 3, 250_000  # bench_config3
# Capture radius 1 m (max_dist is a squared distance): the launcher's
# default of 1e-3 m^2 (3 cm) catches almost no ray of 250,000 over a city.
SBR_MAX_DIST = 1.0
MLM_ORDER, MLM_RAYS, MLM_GRID = 2, 500_000, (128, 128)  # bench_config3
TX = (0.0, 0.0, 40.0)
# The card's peaks for the bounds (NVIDIA's H100 SXM data sheet, at 700 W):
# device memory 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
MT_FLOPS = 51  # One Möller–Trumbore test: two crosses, four dots, a reciprocal, the checks.


def cuda_ms(fn, repeats: int) -> float:
    """Mean device time of ``fn()`` in ms over ``repeats`` runs, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def bound(num_bytes: float, flops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of bytes and operations at peak."""
    t_bytes = num_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def mesh_bytes(triangle_vertices: torch.Tensor, active) -> int:
    """Bytes of a kernel function's mesh input: float32 [T, 3, 3], plus a bool [T] mask if given."""
    num = triangle_vertices.shape[0]
    return num * 36 + (0 if active is None else num)


def trace_flops(paths: int, order: int, tpm: int) -> float:
    """Geometry operations of the fused trace: per mirror the backward step (23),
    ``tpm`` Möller–Trumbore tests and the same-side check (16), per segment the
    length check (8). Blockage, which depends on the data, is not counted."""
    return paths * (order * (23 + MT_FLOPS * tpm + 16) + 8 * (order + 1))


def db_error(port: torch.Tensor, ref: torch.Tensor, window_db: float = 40.0) -> float:
    """Largest |dB| difference over the pixels within ``window_db`` of the maximum."""
    port, ref = port.double().cpu(), ref.double().cpu()
    lit = ref >= ref.max() * 10.0 ** (-window_db / 10.0)
    return float((10.0 * torch.log10(port[lit] / ref[lit])).abs().max())


def street_receivers(device, nx: int = 16, ny: int = 8) -> torch.Tensor:
    """``nx`` x ``ny`` receivers at 1.5 m on the street centrelines around the TX.

    The streets of ``urban_scene`` run along multiples of 50 m. A grid over
    the mesh's bounding box (the bench's layout) puts every receiver inside
    a building or behind the city's edge: its coverage maps are all zero at
    orders 0-2, and SBR captures no ray there, which would leave nothing to
    check.
    """
    y, x = torch.meshgrid(
        50.0 * torch.arange(-ny // 2, ny // 2, device=device),
        50.0 * torch.arange(-nx // 2, nx // 2, device=device),
        indexing="ij",
    )
    return torch.stack((x, y, torch.full_like(x, 1.5)), dim=-1)


def lattice_rays(n: int, origin, scale: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``n`` Fibonacci-lattice rays of length ``scale`` from one point."""
    from differt_tpu_torch.geometry import fibonacci_lattice

    directions = (fibonacci_lattice(n, device=device) * scale).contiguous()
    origins = torch.tensor(origin, device=device).expand(n, 3).contiguous()
    return origins, directions


def fresh(scene):
    """The scene with a copy of its mesh that holds no BVH yet."""
    return dataclasses.replace(scene, mesh=dataclasses.replace(scene.mesh))


def ptxas_lines(report: str) -> list[str]:
    """One line per kernel instance: its registers, spills and shared memory."""
    lines, name = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("spill" in line or "Used" in line):
            lines.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return lines


def unfused_segments(city, candidates: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The any-hit kernel's inputs (origins, directions, thresholds) of the
    unfused pipeline's blockage call on ``candidates`` over the city's
    receivers, made by the path's own helpers."""
    from differt_tpu_torch.ops._dispatch import anyhit_segments
    from differt_tpu_torch.rt._solvers import candidate_geometry, unfused_blockage_inputs

    _, tris, mirror_vertices, mirror_normals = candidate_geometry(city.mesh, candidates)
    _, origins, directions, alive = unfused_blockage_inputs(
        city.transmitters.reshape(-1, 3),
        city.receivers.reshape(-1, 3),
        tris,
        mirror_vertices,
        mirror_normals,
        2 if city.mesh.assume_quads else 1,
        epsilon=None,
        min_len=TRACE_KW["min_len"],
    )
    return anyhit_segments(origins, directions, active_rays=alive[..., None])


def anyhit_shapes(city) -> dict:
    """Phase 2's any-hit inputs, ``label -> (origins, directions, thresholds)``:
    (a) the test shape, 262,144 random segments over the city, 1/8 inactive;
    (b) the main path's one call at order 0, the TX to each of the 128
    street receivers; (c) the blockage call of the unfused pipeline's first
    order-1 chunk (``megakernel=False``): 4,096 candidates x 128 receivers
    x 2 segments, the rays of paths that failed a cheap check inactive."""
    from differt_tpu_torch.geometry import generate_path_candidates

    mesh = city.mesh
    device = mesh.device
    rng = np.random.default_rng(0)
    lo, hi = mesh.bounding_box.cpu().numpy()
    lo[2], hi[2] = 0.5, hi[2] + 10.0
    start_pts = rng.uniform(lo, hi, (NUM_RAYS, 3)).astype(np.float32)
    end_pts = rng.uniform(lo, hi, (NUM_RAYS, 3)).astype(np.float32)
    active = np.arange(NUM_RAYS) % 8 != 0
    thresh = np.where(active, 1.0 - 2.0 * HIT_TOL, -1.0).astype(np.float32)
    first_chunk = generate_path_candidates(mesh.num_primitives, 1, device=device)[:4096]
    return {
        "(a) 262,144 segments": (
            torch.from_numpy(start_pts).to(device),
            torch.from_numpy(end_pts - start_pts).to(device),
            torch.from_numpy(thresh).to(device),
        ),
        "(b) main path, order 0": unfused_segments(
            city, generate_path_candidates(mesh.num_primitives, 0, device=device)
        ),
        "(c) unfused order-1 chunk": unfused_segments(city, first_chunk),
    }


def check_anyhit(device, mesh, city, kernels: dict) -> None:
    """Phase 2: the any-hit kernel against its plain version at the shapes
    of :func:`anyhit_shapes`, at the split level its wrapper picks and at
    level 0 (one walk per ray); then timed at both levels alone, in its
    wrapper (given the BVH, and building it), plain, and on an empty launch
    (every ray inactive) at the main path's shape."""
    from differt_tpu_torch.ops import _bvh, _rt

    tv = mesh.triangle_vertices.contiguous()
    bvh = mesh.bvh
    eps = TRACE_KW["epsilon"]
    for label, (o, d, th) in anyhit_shapes(city).items():
        num = o.shape[0]
        live = int((th >= 0).sum())
        picked = _rt.anyhit_split(live, bvh.depth)  # the level the kernel picks on the card
        want = _rt.ray_intersect_any_triangle_reference(o, d, tv, None, hit_threshold=th)
        got = _rt.ray_intersect_any_triangle_cuda(o, d, tv, None, hit_threshold=th, bvh=bvh)
        out = torch.empty_like(got)
        _rt.launch_anyhit(o, d, th, bvh, eps, out, split=0)
        for split, result in ((picked, got), (0, out)):
            if mismatches := int((result != want).sum()):
                msg = (
                    f"any-hit kernel disagrees with its plain version on {mismatches} rays"
                    f" ({label}, split level {split})"
                )
                raise AssertionError(msg)
        level0_ms = cuda_ms(lambda: _rt.launch_anyhit(o, d, th, bvh, eps, out, split=0), 20)
        kernel_ms = cuda_ms(lambda: _rt.launch_anyhit(o, d, th, bvh, eps, out), 20)
        ms = cuda_ms(lambda: _rt.ray_intersect_any_triangle_cuda(o, d, None, hit_threshold=th, bvh=bvh), 20)
        build_ms = cuda_ms(lambda: _rt.ray_intersect_any_triangle_cuda(o, d, tv, None, hit_threshold=th), 3)
        plain_ms = cuda_ms(lambda: _rt.ray_intersect_any_triangle_reference(o, d, tv, None, hit_threshold=th), 2)
        # Bytes: each ray's origin, direction and threshold read once, its
        # flag written once, and the mesh; operations: one Möller–Trumbore
        # test for each live ray, the least a ray that is tested needs.
        bound_ms, bound_by = bound(num * 29 + mesh_bytes(tv, None), live * MT_FLOPS)
        print(
            f"phase 2 anyhit {label}: rays={num} live={live} triangles={tv.shape[0]}"
            f" blocked={int(got.sum())} split={picked} (depth {bvh.depth},"
            f" {_rt.anyhit_items(live, picked)} items) mismatches=0 (split {picked} and 0)"
            f" kernel_only_ms={kernel_ms:.4f} kernel_only_split0_ms={level0_ms:.4f}"
            f" wrapper_ms={ms:.4f} wrapper_with_build_ms={build_ms:.3f} plain_ms={plain_ms:.3f}"
            f" bound_ms={bound_ms:.5f} ({bound_by})",
            flush=True,
        )
        if label.startswith("(b)"):
            inactive = torch.full_like(th, -1.0)
            empty_ms = cuda_ms(lambda: _rt.launch_anyhit(o, d, inactive, bvh, eps, out), 20)
            print(
                f"phase 2 anyhit (b) empty launch, every ray inactive: split={picked}"
                f" kernel_only_ms={empty_ms:.4f}",
                flush=True,
            )
            kernels["anyhit"] = {
                "name": "anyhit",
                "route": "cuda",
                "source": "differt_tpu_torch/csrc/anyhit.cu",
                "replaces": "differt_tpu/ops/_pallas_rt.py:228",
                "shape": "main path order 0: 128 segments x 20,738 triangles",
                "max_abs_err": 0.0,
                "kernel_only_ms": kernel_ms,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,  # No single PyTorch call computes an any-hit test.
            }
    build_ms = cuda_ms(lambda: _bvh.build_bvh(tv, None), 5)
    print(
        f"phase 2 BVH build, 20,738 triangles: {build_ms:.3f} ms; nodes={bvh.num_nodes}"
        f" depth={bvh.depth} leaf_size={bvh.leaf_size} large={bvh.num_large}"
        f" bytes={bvh.nbytes}",
        flush=True,
    )


def check_closest(device, kernels: dict) -> None:
    """Phase 5: the closest-hit kernel against its plain version; every index
    must be the tie key's winner."""
    from differt_tpu_torch import scenes
    from differt_tpu_torch.ops import _bvh, _closest

    eps = TRACE_KW["epsilon"]

    def check(label, origins, directions, tv, active):
        bvh = _bvh.build_bvh(tv, active)
        idx, t = _closest.first_triangle_hit_by_ray_cuda(origins, directions, tv, active, bvh=bvh)
        want_idx, want_t = _closest.first_triangle_hit_by_ray_reference(
            origins, directions, tv, active
        )
        # t must be bit-equal (the kernel's MT runs op for op, --fmad=false).
        if not torch.equal(t, want_t):
            msg = f"closest-hit t differs from its plain version ({label})"
            raise AssertionError(msg)
        winner = _closest.tie_key_winner(origins, directions, tv, active, want_t, bvh.positions)
        if not torch.equal(idx, winner):
            msg = f"closest-hit index is not the tie key's winner on {int((idx != winner).sum())} rays ({label})"
            raise AssertionError(msg)
        pos = torch.empty(origins.shape[0], dtype=torch.int32, device=device)
        t_out = torch.empty(origins.shape[0], device=device)
        kernel_ms = cuda_ms(
            lambda: _closest.launch_closest(origins, directions, bvh, eps, pos, t_out), 10
        )
        ms = cuda_ms(
            lambda: _closest.first_triangle_hit_by_ray_cuda(origins, directions, None, bvh=bvh), 10
        )
        build_ms = cuda_ms(
            lambda: _closest.first_triangle_hit_by_ray_cuda(origins, directions, tv, active), 3
        )
        plain_ms = cuda_ms(
            lambda: _closest.first_triangle_hit_by_ray_reference(origins, directions, tv, active), 2
        )
        num = idx.numel()
        bound_ms, bound_by = bound(num * (24 + 8) + mesh_bytes(tv, active), num * MT_FLOPS)
        print(
            f"phase 5 closest {label}: rays={num} triangles={tv.shape[0]}"
            f" hits={int((idx >= 0).sum())} ties_broken_otherwise_than_the_scan="
            f"{int((idx != want_idx).sum())} max_abs_err=0.0 kernel_only_ms={kernel_ms:.3f}"
            f" wrapper_ms={ms:.3f} wrapper_with_build_ms={build_ms:.3f} plain_ms={plain_ms:.3f}"
            f" bound_ms={bound_ms:.5f} ({bound_by})",
            flush=True,
        )

    small = scenes.urban_scene(8, 8, device=device).mesh.triangle_vertices.contiguous()
    if small.shape[0] != 2_306:
        msg = f"urban_scene(8, 8) has {small.shape[0]} triangles, expected 2,306"
        raise AssertionError(msg)
    rays = lattice_rays(RAYCAST_RAYS, [0.0, 0.0, 30.0], 500.0, device)
    check("(a) raycast shape", *rays, small, None)
    third = torch.arange(small.shape[0], device=device) % 3 != 0
    check("(b) raycast shape, % 3 mask", *rays, small, third)
    big = scenes.urban_scene(24, 24, device=device).mesh.triangle_vertices.contiguous()
    check("(c) city 24x24", *lattice_rays(NUM_RAYS, [0.0, 0.0, 40.0], 500.0, device), big, None)
    kernels["closest"] = {
        "name": "closest",
        "route": "cuda",
        "source": "differt_tpu_torch/csrc/closest.cu",
        "replaces": "differt_tpu/ops/_pallas_rt.py:277",
        "max_abs_err": 0.0,
        "library_ms": None,  # No single PyTorch call computes a closest hit.
    }


def time_closest_at_path_shapes(scene, kernels: dict) -> dict:
    """Phase 5 (d): the closest-hit kernel on the first bounce of SBR and of
    the MLM (lattice rays from the TX over the frustum), checked against its
    plain version as in (a)-(c), then timed alone, in its wrapper, and
    plain. The SBR row goes into the JSON."""
    from differt_tpu_torch.ops import _closest
    from differt_tpu_torch.rt import SBRPathLauncher

    mesh = scene.mesh
    bvh = mesh.bvh
    tv = mesh.triangle_vertices.contiguous()
    eps = TRACE_KW["epsilon"]
    rows = {}
    for label, num in (("SBR", SBR_RAYS), ("MLM", MLM_RAYS)):
        o, d = SBRPathLauncher(num_rays=num).launch_rays(scene)
        o, d = o[0].contiguous(), d[0].contiguous()
        idx, t = _closest.first_triangle_hit_by_ray_cuda(o, d, None, bvh=bvh)
        want_idx, want_t = _closest.first_triangle_hit_by_ray_reference(o, d, tv, None)
        if not torch.equal(t, want_t):
            msg = f"closest-hit t differs from its plain version ({label} first bounce)"
            raise AssertionError(msg)
        winner = _closest.tie_key_winner(o, d, tv, None, want_t, bvh.positions)
        if not torch.equal(idx, winner):
            msg = (
                f"closest-hit index is not the tie key's winner on"
                f" {int((idx != winner).sum())} rays ({label} first bounce)"
            )
            raise AssertionError(msg)
        pos = torch.empty(num, dtype=torch.int32, device=o.device)
        t_out = torch.empty(num, device=o.device)
        kernel_ms = cuda_ms(lambda: _closest.launch_closest(o, d, bvh, eps, pos, t_out), 10)
        ms = cuda_ms(lambda: _closest.first_triangle_hit_by_ray_cuda(o, d, None, bvh=bvh), 10)
        build_ms = cuda_ms(lambda: _closest.first_triangle_hit_by_ray_cuda(o, d, tv, None), 3)
        plain_ms = cuda_ms(lambda: _closest.first_triangle_hit_by_ray_reference(o, d, tv, None), 2)
        bound_ms, bound_by = bound(num * (24 + 8) + mesh_bytes(tv, None), num * MT_FLOPS)
        rows[label] = {
            "kernel_only_ms": kernel_ms,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
        print(
            f"phase 5 (d) closest, {label} first bounce: rays={num} triangles={tv.shape[0]}"
            f" hits={int((idx >= 0).sum())} ties_broken_otherwise_than_the_scan="
            f"{int((idx != want_idx).sum())} max_abs_err=0.0 kernel_only_ms={kernel_ms:.3f}"
            f" wrapper_ms={ms:.3f} wrapper_with_build_ms={build_ms:.3f}"
            f" plain_ms={plain_ms:.3f} bound_ms={bound_ms:.5f} ({bound_by})",
            flush=True,
        )
    kernels["closest"].update(
        shape="SBR first bounce: 250,000 lattice rays x 9,218 triangles", **rows["SBR"]
    )
    return rows


def run_ray_launching(device, kernels: dict) -> dict:
    """Phases 6-7: SBR and the MLM at bench_config3 width, counted; then
    the same runs on the plain version (``set_backend("torch")``) to compare."""
    from differt_tpu_torch import ops, scenes
    from differt_tpu_torch.geometry import Scene
    from differt_tpu_torch.ops import _bvh, _closest

    mesh = scenes.urban_scene(16, 16, device=device).mesh
    if mesh.num_triangles != 9_218:
        msg = f"urban_scene(16, 16) has {mesh.num_triangles} triangles, expected 9,218"
        raise AssertionError(msg)
    # The bench's 8 x 8 receivers, on the street crossings (street_receivers).
    scene = Scene(
        transmitters=torch.tensor([TX], device=device),
        receivers=street_receivers(device, 8, 8),
        mesh=mesh,
    )
    time_closest_at_path_shapes(scene, kernels)
    walls = {}

    def counted(label, fn, queries):
        """Warm up, then run ``fn`` on a fresh mesh with the counts at 0; check
        they show only kernel launches and one BVH build."""
        if ops.get_backend() != "auto":
            msg = f"the {label} run needs the 'auto' backend, not {ops.get_backend()!r}"
            raise AssertionError(msg)
        fn(scene)
        run_scene = fresh(scene)
        torch.cuda.synchronize()
        _closest.LAUNCHES = _closest.REFERENCE_CALLS = _bvh.BUILDS = 0
        start = time.perf_counter()
        out = fn(run_scene)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        counts = {
            "closest": _closest.LAUNCHES,
            "closest_plain": _closest.REFERENCE_CALLS,
            "bvh_builds": _bvh.BUILDS,
        }
        if counts != {"closest": queries, "closest_plain": 0, "bvh_builds": 1}:
            msg = f"the {label} run did not go through the kernel only, with one BVH build: {counts}"
            raise AssertionError(msg)
        kernels["closest"]["launches"] = kernels["closest"].get("launches", 0) + counts["closest"]
        walls[label] = wall
        return out, wall, counts

    def plain(fn):
        ops.set_backend("torch")
        try:
            return fn(scene)
        finally:
            ops.set_backend("auto")

    # Phase 6: SBR.
    def sbr(s):
        return s.launch_paths(
            order=SBR_ORDER, solver="sbr", num_rays=SBR_RAYS, max_dist=SBR_MAX_DIST
        )

    paths, wall, counts = counted("SBR", sbr, SBR_ORDER + 1)
    if not (paths.masks[..., 0].any() and paths.masks[..., 1:].any()):
        msg = "SBR captured no order-0 or no higher-order path"
        raise AssertionError(msg)
    want = plain(sbr)
    # Rays whose hits differ met an exact tie (the kernel's tie key breaks it
    # another way than the plain scan). At each such ray's first differing
    # bounce, both runs must reach the same point (the same t from the same
    # ray); every other ray, and so every other mask, must be equal.
    hits, want_hits = paths.objects[0, 0, 0, :, 1:-1], want.objects[0, 0, 0, :, 1:-1]
    tie_rays = (hits != want_hits).any(dim=-1)
    if tie_rays.any():
        first = (hits != want_hits).int().argmax(dim=-1)[tie_rays]
        points = paths.vertices[0, 0, 0, tie_rays, 1:-1][torch.arange(first.numel()), first]
        want_points = want.vertices[0, 0, 0, tie_rays, 1:-1][torch.arange(first.numel()), first]
        if not torch.equal(points, want_points):
            msg = "SBR runs diverge at a bounce that is no tie"
            raise AssertionError(msg)
    same = ~tie_rays
    if not torch.equal(paths.masks[..., same, :], want.masks[..., same, :]):
        msg = "SBR masks differ from the plain-version run off the tie rays"
        raise AssertionError(msg)
    print(
        f"phase 6 SBR: order={SBR_ORDER} rays={SBR_RAYS} triangles={mesh.num_triangles}"
        f" rx={scene.receivers.shape[0] * scene.receivers.shape[1]}"
        f" wall_s={wall:.4f}"
        f" sbr_order3_bounce_rays_per_s={SBR_RAYS * (SBR_ORDER + 1) / wall:.4g}"
        f" captured_per_order={paths.masks.sum(dim=(0, 1, 2, 3)).tolist()}"
        f" counts={json.dumps(counts)} tie_rays={int(tie_rays.sum())}"
        f" masks_differ={int((paths.masks != want.masks).sum())}",
        flush=True,
    )
    del paths, want

    # Phase 7: the MLM.
    def mlm(s):
        return s.compute_tx_mlm(
            num_rays=MLM_RAYS, order=MLM_ORDER, grid_size=MLM_GRID, receiver_plane_z=1.5
        )

    cells, wall, counts = counted("MLM", mlm, MLM_ORDER + 1)
    want = plain(mlm)
    lit = int((want != 0).sum())
    differ = int((cells != want).sum())
    if not lit or not (cells != 0).any():
        msg = "the MLM map has no non-zero cell"
        raise AssertionError(msg)
    # Cells reached by tie rays may differ: at most 0.1% of the lit cells.
    if differ > lit // 1000:
        msg = f"the MLM map differs from the plain-version run on {differ} of {lit} lit cells"
        raise AssertionError(msg)
    print(
        f"phase 7 MLM: order={MLM_ORDER} rays={MLM_RAYS} grid={MLM_GRID[0]}x{MLM_GRID[1]}"
        f" wall_s={wall:.4f}"
        f" mlm_order2_bounce_rays_per_s={MLM_RAYS * (MLM_ORDER + 1) / wall:.4g}"
        f" lit_cells={lit} distinct_hashes={len(torch.unique(cells))}"
        f" counts={json.dumps(counts)} cells_differ={differ}",
        flush=True,
    )
    return {"scene": scene, "sbr": sbr, "mlm": mlm}


def profile(label: str, fn, kernel_names: tuple[str, ...]) -> None:
    """Phase 8: one warm call of a path under torch.profiler: device busy
    share, each port kernel's launches and mean device time, the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        print(f"phase 8 profile {label}: the profiler saw no device time", flush=True)
        return
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    by_name: dict[str, list[float]] = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    ours = {
        k: f"{len(v)} launches, {sum(v) / len(v) / 1e3:.4f} ms each"
        for k in kernel_names
        for name, v in by_name.items()
        if k in name
    }
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:6]
    top_text = "; ".join(
        f"{name[:70]} {sum(v) / 1e3:.2f} ms ({100 * sum(v) / busy_us:.0f}%, {len(v)})"
        for name, v in top
    )
    print(
        f"phase 8 profile {label}: wall_ms={wall * 1e3:.1f} device_ms={busy_us / 1e3:.2f}"
        f" busy={100 * busy_us / 1e3 / (wall * 1e3):.0f}% device_launches={len(events)}"
        f" ours={json.dumps(ours)} top: {top_text}",
        flush=True,
    )


def main() -> None:
    if not torch.cuda.is_available():
        msg = "chip_smoke.py needs a CUDA device, and none is visible."
        raise SystemExit(msg)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from differt_tpu_torch import coverage, scenes
    from differt_tpu_torch.geometry import Scene, generate_path_candidates
    from differt_tpu_torch.ops import _build, _bvh, _rt, _trace
    from differt_tpu_torch.rt._solvers import candidate_geometry

    device = torch.device("cuda", 0)
    kernels = {}

    # Phase 1: the device and the kernel build.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout.strip().splitlines()[0]
    capability = torch.cuda.get_device_capability(device)
    if capability != (9, 0):
        msg = f"Expected a Hopper card (capability 9.0), got {capability}."
        raise RuntimeError(msg)
    start = time.perf_counter()
    _build.load_kernels()
    build_s = time.perf_counter() - start
    print(f"card: {smi}")
    print(
        f"phase 1 device: {torch.cuda.get_device_name(device)} capability={capability}"
        f" torch={torch.__version__} cuda={torch.version.cuda}"
        f" kernel_build_s={build_s:.2f}",
        flush=True,
    )
    for line in ptxas_lines(_build.ptxas_report()):
        print(f"phase 1 ptxas {line}", flush=True)

    mesh = scenes.urban_scene(24, 24, device=device).mesh
    if mesh.num_triangles != 20_738:
        msg = f"urban_scene(24, 24) has {mesh.num_triangles} triangles, expected 20,738"
        raise AssertionError(msg)
    tx = torch.tensor([TX], device=device)
    city = Scene(transmitters=tx, receivers=street_receivers(device), mesh=mesh)

    # Phase 2: any-hit kernel against its plain version.
    check_anyhit(device, mesh, city, kernels)

    # Phase 3: fused trace kernel against its plain version.
    def trace_inputs(scene, candidates):
        _, tris, mirror_vertices, mirror_normals = candidate_geometry(scene.mesh, candidates)
        return (
            scene.transmitters.reshape(-1, 3).contiguous(),
            scene.receivers.reshape(-1, 3).contiguous(),
            mirror_vertices,
            mirror_normals,
            tris,
            scene.mesh.triangle_vertices.contiguous(),
            scene.mesh.mask,
        )

    def check_trace(label, scene, candidates, order, *, want_valid=False):
        args = trace_inputs(scene, candidates)
        kw = {"order": order, **TRACE_KW}
        bvh = scene.mesh.bvh
        verts, mask = _trace.trace_specular_cuda(*args, **kw, bvh=bvh)
        want_verts, want_mask = _trace.trace_specular_reference(*args, **kw)
        mismatches = int((mask != want_mask).sum())
        if mismatches:
            msg = f"trace kernel disagrees with its plain version on {mismatches} paths ({label})"
            raise AssertionError(msg)
        if want_valid and not mask.any():
            msg = f"no valid path to compare vertices on ({label})"
            raise AssertionError(msg)
        err = float((verts[mask] - want_verts[mask]).abs().max()) if mask.any() else 0.0
        if not err <= 1e-4:
            msg = f"trace kernel vertices differ by {err} ({label})"
            raise AssertionError(msg)
        # Invalid paths keep their raw vertices, as in the plain version.
        raw = ~mask[..., None, None] & torch.isfinite(want_verts)
        raw_err = float((verts[raw] - want_verts[raw]).abs().max()) if raw.any() else 0.0
        tx_v, rx_v, mv, mn, tris = args[:5]
        mirrors = torch.cat((mv, mn), dim=-1).contiguous()
        v0 = tris[..., 0, :]
        cand = torch.cat((v0, tris[..., 1, :] - v0, tris[..., 2, :] - v0), dim=-1).contiguous()
        tpm = tris.shape[1] // order
        verts_out, mask_out = torch.empty_like(verts), torch.empty_like(mask)
        kernel_ms = cuda_ms(
            lambda: _trace.launch_trace(
                tx_v, rx_v, mirrors, cand, bvh, order, tpm, *TRACE_KW.values(), verts_out, mask_out
            ),
            20,
        )
        ms = cuda_ms(lambda: _trace.trace_specular_cuda(*args[:5], None, None, **kw, bvh=bvh), 20)
        build_ms = cuda_ms(lambda: _trace.trace_specular_cuda(*args, **kw), 3)
        plain_ms = cuda_ms(lambda: _trace.trace_specular_reference(*args, **kw), 2)
        paths = mask.numel()
        num_bytes = (
            sum(x.numel() * 4 for x in (tx_v, rx_v, mirrors, cand))
            + mesh_bytes(args[5], args[6])
            + verts.numel() * 4
            + paths
        )
        bound_ms, bound_by = bound(num_bytes, trace_flops(paths, order, tpm))
        print(
            f"phase 3 trace {label}: paths={paths} valid={int(mask.sum())}"
            f" mismatches=0 max_abs_err={err:.3g} raw_vertex_err={raw_err:.3g}"
            f" kernel_only_ms={kernel_ms:.4f} wrapper_ms={ms:.4f}"
            f" wrapper_with_build_ms={build_ms:.3f} plain_ms={plain_ms:.3f}"
            f" bound_ms={bound_ms:.5f} ({bound_by}, {num_bytes} bytes)",
            flush=True,
        )
        row = {
            "max_abs_err": err,
            "kernel_only_ms": kernel_ms,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,  # No single PyTorch call computes the fused trace.
        }
        return row

    canyon = Scene(
        transmitters=torch.tensor([[-30.0, 0.0, 20.0]], device=device),
        mesh=scenes.street_canyon_scene(device=device).mesh,
    ).with_receivers_grid(64, 64)
    trace_errors = []
    for order in (1, 2):
        candidates = generate_path_candidates(canyon.mesh.num_primitives, order, device=device)
        row = check_trace(f"(a) canyon order {order}", canyon, candidates, order, want_valid=True)
        trace_errors.append(row["max_abs_err"])

    # (b) The bench's shape: the first 4,096 order-2 candidates x a 16 x 8
    # grid over the bounding box. Every one of those paths is invalid (the
    # candidates bounce first on the far corner block, and the receivers
    # sit inside buildings or beyond the city), so (c) adds candidates and
    # receivers with valid paths, for the vertices to be compared.
    bench_grid = Scene(transmitters=tx, mesh=mesh).with_receivers_grid(16, 8)
    candidates = generate_path_candidates(mesh.num_primitives, 2, size=4096, device=device)
    row = check_trace("(b) city order 2, bench shape", bench_grid, candidates, 2)
    trace_errors.append(row["max_abs_err"])
    # All ordered pairs of the 91 triangles nearest the TX: 8,190 candidates.
    centroids = mesh.triangle_vertices.mean(dim=1)[:, :2]
    near = torch.argsort(centroids.norm(dim=-1))[:91]
    pairs = torch.cartesian_prod(near, near)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    row = check_trace("(c) city order 2, near pairs", city, pairs, 2, want_valid=True)
    trace_errors.append(row["max_abs_err"])
    # (d) A main-path call: the first of the order-2 chunks of phase 4.
    # Order-2 candidates whose first bounce is on the block south-west of
    # the TX (block (11, 11), 36 triangles a block): the first 1,048,576
    # candidates, as the bench decodes them, all bounce first on the far
    # corner block, and every one of those paths is blocked.
    first = 36 * (11 * 24 + 11) * (mesh.num_primitives - 1)
    main_candidates = generate_path_candidates(
        mesh.num_primitives, 2, start=first, size=MAIN_CANDIDATES, device=device
    )
    row = check_trace("(d) main path chunk", city, main_candidates[:4096], 2)
    trace_errors.append(row["max_abs_err"])
    kernels["trace"] = {
        "name": "trace",
        "route": "cuda",
        "source": "differt_tpu_torch/csrc/trace.cu",
        "replaces": "differt_tpu/ops/_pallas_trace.py:120",
        "shape": "main path order 2 chunk: 4,096 candidates x 128 RX x 20,738 triangles",
        **row,
        "max_abs_err": max(trace_errors),
    }

    # Phase 4: the main path, counted: each order's call on a fresh mesh.
    materials = {"eta_r": [5.24], "conductivity": [0.1]}
    runs = (
        (0, None, 1),
        (1, None, mesh.num_primitives),
        (2, main_candidates, MAIN_CANDIDATES),
    )

    def coverage_run(scene, order, candidates):
        return coverage.power_map_chunked(
            scene,
            FREQUENCY,
            order=order,
            path_candidates=candidates,
            candidate_chunk=4096,
            rx_chunk=128,
            **materials,
        )

    # Warm-up: the first CUDA call of each complex-valued PyTorch op compiles
    # it at run time (about a second in all), which is set-up, not the path.
    for order, candidates, _ in runs:
        coverage_run(city, order, None if candidates is None else candidates[:4096])
    torch.cuda.synchronize()
    _rt.LAUNCHES = _trace.LAUNCHES = 0
    _rt.REFERENCE_CALLS = _trace.REFERENCE_CALLS = 0
    maps, builds = {}, {}
    for order, candidates, num_candidates in runs:
        run_city = fresh(city)
        _bvh.BUILDS = 0
        start = time.perf_counter()
        power = coverage_run(run_city, order, candidates)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        builds[order] = _bvh.BUILDS
        maps[order] = power
        rate = num_candidates * city.num_receivers / wall
        print(
            f"phase 4 main path order {order}: candidates={num_candidates}"
            f" rx={city.num_receivers} wall_s={wall:.4f} paths_per_s={rate:.4g}"
            f" bvh_builds={builds[order]}",
            flush=True,
        )
    counts = {
        "anyhit": _rt.LAUNCHES,
        "trace": _trace.LAUNCHES,
        "anyhit_plain": _rt.REFERENCE_CALLS,
        "trace_plain": _trace.REFERENCE_CALLS,
    }
    for order, power in maps.items():
        if not torch.isfinite(power).all():
            msg = f"order-{order} map is not finite"
            raise AssertionError(msg)
    lit = {order: int((power > 0).sum()) for order, power in maps.items()}
    if not sum(lit.values()):
        msg = "the coverage map (orders 0-2) is all zero"
        raise AssertionError(msg)
    want_counts = {"anyhit": 1, "trace": 6 + 256, "anyhit_plain": 0, "trace_plain": 0}
    if counts != want_counts:
        msg = f"the main path's launches are {counts}, expected {want_counts}"
        raise AssertionError(msg)
    if any(n != 1 for n in builds.values()):
        msg = f"the main path built the BVH {builds} times per order, expected once"
        raise AssertionError(msg)
    kernels["anyhit"]["launches"] = counts["anyhit"]
    kernels["trace"]["launches"] = counts["trace"]

    # The fused path against the unfused pipeline (any-hit kernel) on the
    # card: order 1 over all candidates, and order 2 over the near pairs of
    # phase 3 (c), where the map is not all zero.
    checks = {1: None, 2: pairs}
    errors = {}
    for order, candidates in checks.items():
        fused, unfused = (
            coverage.power_map_chunked(
                city,
                FREQUENCY,
                order=order,
                path_candidates=candidates,
                candidate_chunk=4096,
                rx_chunk=128,
                megakernel=megakernel,
                **materials,
            )
            for megakernel in (None, False)
        )
        errors[order] = db_error(fused, unfused)
        if not errors[order] <= 0.1:
            msg = f"order-{order} map differs from the unfused pipeline by {errors[order]} dB"
            raise AssertionError(msg)
    print(
        f"phase 4 counts: {json.dumps(counts)}; bvh builds per order: {json.dumps(builds)};"
        f" lit pixels per order: {json.dumps(lit)};"
        f" fused vs unfused max_err_db: {json.dumps(errors)}",
        flush=True,
    )

    check_closest(device, kernels)
    launching = run_ray_launching(device, kernels)

    order2 = main_candidates[: 32 * 4096]
    profile("coverage order 2, 32 chunks", lambda: coverage_run(city, 2, order2), ("trace_kernel",))
    profile(
        "coverage order 0", lambda: coverage_run(city, 0, None), ("compact_kernel", "anyhit_kernel")
    )
    profile("SBR", lambda: launching["sbr"](launching["scene"]), ("closest_kernel",))
    profile("MLM", lambda: launching["mlm"](launching["scene"]), ("closest_kernel",))

    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "kernel_only_ms"}
    for name, entry in kernels.items():
        if missing := keys - entry.keys():
            msg = f"the {name} entry of the kernels line lacks {sorted(missing)}"
            raise AssertionError(msg)
    print(f"card: {smi}")
    print(json.dumps({"kernels": [kernels[k] for k in ("anyhit", "trace", "closest")]}))
    print(
        json.dumps({
            "ok": True,
            "device": {
                "platform": "gpu",
                "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count(),
            },
        })
    )


if __name__ == "__main__":
    sys.exit(main())
