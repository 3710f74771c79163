#!/usr/bin/env python3
"""Drive the PyTorch port's coverage and ray-launching paths once on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root, on a host with one H100:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``differt_tpu_torch/csrc/``,
checks each against its plain PyTorch version on the card, and drives two
paths, each counted from zero:

- coverage: ``power_map_chunked`` on the 20,738-triangle
  ``urban_scene(24, 24)``, orders 0, 1 and 2, through the any-hit and
  fused trace kernels;
- ray launching, at the width of the JAX bench's ``bench_config3``:
  ``Scene.launch_paths`` (SBR, order 3, 250,000 rays) and
  ``Scene.compute_tx_mlm`` (order 2, 500,000 rays, 128 x 128 cells) on the
  9,218-triangle ``urban_scene(16, 16)``, through the closest-hit kernel;

and checks that each path went through its kernels and never through their
plain versions. One line per phase; then a JSON line with each kernel's
launches, error and times; then, last, ``{"ok": true, "device": {...}}``.
Any failure raises (exit code != 0). There is no CPU path: without a CUDA
device the script fails at once.
"""

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


def check_closest_kernel(device) -> dict:
    """Phase 5: the closest-hit kernel against its plain version."""
    from differt_tpu_torch import scenes
    from differt_tpu_torch.ops import _closest
    from differt_tpu_torch.rt import ray_intersect_triangle

    def check(label, origins, directions, tv, active):
        args = (origins, directions, tv, active)
        idx, t = _closest.first_triangle_hit_by_ray_cuda(*args)
        want_idx, want_t = _closest.first_triangle_hit_by_ray_reference(*args)
        # t must be bit-equal (the kernel's MT runs op for op, --fmad=false).
        if not torch.equal(t, want_t):
            msg = f"closest-hit t differs from its plain version ({label})"
            raise AssertionError(msg)
        # Indices may differ only on true ties: the plain version's t for the
        # kernel's (active) triangle is the best t.
        rays = torch.nonzero(idx != want_idx).squeeze(-1)
        if rays.numel():
            t_of, hit = ray_intersect_triangle(
                origins[rays], directions[rays], tv[idx[rays]]
            )
            ok = bool(hit.all()) and torch.equal(t_of, want_t[rays])
            if active is not None:
                ok = ok and bool(active[idx[rays]].all())
            if not ok:
                msg = f"closest-hit indices differ off a tie ({label})"
                raise AssertionError(msg)
        finite = torch.isfinite(want_t)
        err = float((t[finite] - want_t[finite]).abs().max()) if finite.any() else 0.0
        ms = cuda_ms(lambda: _closest.first_triangle_hit_by_ray_cuda(*args), 5)
        plain_ms = cuda_ms(lambda: _closest.first_triangle_hit_by_ray_reference(*args), 2)
        print(
            f"phase 5 closest {label}: rays={idx.numel()} triangles={tv.shape[0]}"
            f" hits={int((idx >= 0).sum())} ties={rays.numel()} max_abs_err={err}"
            f" kernel_ms={ms:.3f} plain_ms={plain_ms:.3f}",
            flush=True,
        )
        return err, ms, plain_ms

    small = scenes.urban_scene(8, 8, device=device).mesh.triangle_vertices.contiguous()
    if small.shape[0] != 2_306:
        msg = f"urban_scene(8, 8) has {small.shape[0]} triangles, expected 2,306"
        raise AssertionError(msg)
    rays = lattice_rays(RAYCAST_RAYS, [0.0, 0.0, 30.0], 500.0, device)
    err_a, ms, plain_ms = check("(a) raycast shape", *rays, small, None)
    third = torch.arange(small.shape[0], device=device) % 3 != 0
    err_b, *_ = check("(b) raycast shape, % 3 mask", *rays, small, third)
    big = scenes.urban_scene(24, 24, device=device).mesh.triangle_vertices.contiguous()
    err_c, *_ = check(
        "(c) city 24x24", *lattice_rays(NUM_RAYS, [0.0, 0.0, 40.0], 500.0, device), big, None
    )
    return {
        "name": "closest",
        "route": "cuda",
        "source": "differt_tpu_torch/csrc/closest.cu",
        "replaces": "differt_tpu/ops/_pallas_rt.py:277",
        "max_abs_err": max(err_a, err_b, err_c),
        "ms": ms,
        "plain_ms": plain_ms,
    }


def run_ray_launching(device, closest: dict) -> None:
    """Phases 6-7: SBR and the MLM at bench_config3 width, counted; then
    the same runs on the plain version (``set_backend("torch")``) to compare."""
    from differt_tpu_torch import ops, scenes
    from differt_tpu_torch.geometry import Scene
    from differt_tpu_torch.ops import _closest

    mesh = scenes.urban_scene(16, 16, device=device).mesh
    if mesh.num_triangles != 9_218:
        msg = f"urban_scene(16, 16) has {mesh.num_triangles} triangles, expected 9,218"
        raise AssertionError(msg)
    # The bench's 8 x 8 receivers, on the street crossings (street_receivers).
    scene = Scene(
        transmitters=torch.tensor([[0.0, 0.0, 40.0]], device=device),
        receivers=street_receivers(device, 8, 8),
        mesh=mesh,
    )

    def counted(label, fn, queries):
        """Warm up, then run ``fn`` with the counts at 0; check they show only kernel launches."""
        if ops.get_backend() != "auto":
            msg = f"the {label} run needs the 'auto' backend, not {ops.get_backend()!r}"
            raise AssertionError(msg)
        fn()
        torch.cuda.synchronize()
        _closest.LAUNCHES = _closest.REFERENCE_CALLS = 0
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        counts = {"closest": _closest.LAUNCHES, "closest_plain": _closest.REFERENCE_CALLS}
        if counts != {"closest": queries, "closest_plain": 0}:
            msg = f"the {label} run did not go through the kernel only: {counts}"
            raise AssertionError(msg)
        closest["launches"] = closest.get("launches", 0) + counts["closest"]
        return out, wall, counts

    def plain(fn):
        ops.set_backend("torch")
        try:
            return fn()
        finally:
            ops.set_backend("auto")

    # Phase 6: SBR.
    def sbr():
        return scene.launch_paths(
            order=SBR_ORDER, solver="sbr", num_rays=SBR_RAYS, max_dist=SBR_MAX_DIST
        )

    paths, wall, counts = counted("SBR", sbr, SBR_ORDER + 1)
    if not (paths.masks[..., 0].any() and paths.masks[..., 1:].any()):
        msg = "SBR captured no order-0 or no higher-order path"
        raise AssertionError(msg)
    want = plain(sbr)
    # Rays whose hits differ met an exact tie (Morton order breaks it another
    # way). At each such ray's first differing bounce, both runs must reach
    # the same point (the same t from the same ray); every other ray, and so
    # every other mask, must be equal.
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
    def mlm():
        return scene.compute_tx_mlm(
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


def main() -> None:
    if not torch.cuda.is_available():
        msg = "chip_smoke.py needs a CUDA device, and none is visible."
        raise SystemExit(msg)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from differt_tpu_torch import coverage, scenes
    from differt_tpu_torch.geometry import Scene, generate_path_candidates
    from differt_tpu_torch.ops import _build, _rt, _trace
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

    city = scenes.urban_scene(24, 24, device=device)
    mesh = city.mesh
    if mesh.num_triangles != 20_738:
        msg = f"urban_scene(24, 24) has {mesh.num_triangles} triangles, expected 20,738"
        raise AssertionError(msg)
    tv = mesh.triangle_vertices.contiguous()

    # Phase 2: any-hit kernel against its plain version.
    rng = np.random.default_rng(0)
    lo, hi = mesh.bounding_box.cpu().numpy()
    lo[2], hi[2] = 0.5, hi[2] + 10.0
    start_pts = rng.uniform(lo, hi, (NUM_RAYS, 3)).astype(np.float32)
    end_pts = rng.uniform(lo, hi, (NUM_RAYS, 3)).astype(np.float32)
    active = np.arange(NUM_RAYS) % 8 != 0  # 1/8 inactive
    thresh = np.where(active, 1.0 - 2.0 * HIT_TOL, -1.0).astype(np.float32)
    ray_args = (
        torch.from_numpy(start_pts).to(device),
        torch.from_numpy(end_pts - start_pts).to(device),
        tv,
        None,
    )
    thresh_t = torch.from_numpy(thresh).to(device)
    got = _rt.ray_intersect_any_triangle_cuda(*ray_args, hit_threshold=thresh_t)
    want = _rt.ray_intersect_any_triangle_reference(*ray_args, hit_threshold=thresh_t)
    mismatches = int((got != want).sum())
    if mismatches:
        msg = f"any-hit kernel disagrees with its plain version on {mismatches} rays"
        raise AssertionError(msg)
    ms = cuda_ms(lambda: _rt.ray_intersect_any_triangle_cuda(*ray_args, hit_threshold=thresh_t), 5)
    plain_ms = cuda_ms(
        lambda: _rt.ray_intersect_any_triangle_reference(*ray_args, hit_threshold=thresh_t), 2
    )
    kernels["anyhit"] = {
        "name": "anyhit",
        "route": "cuda",
        "source": "differt_tpu_torch/csrc/anyhit.cu",
        "replaces": "differt_tpu/ops/_pallas_rt.py:228",
        "max_abs_err": float((got.int() - want.int()).abs().max()),
        "ms": ms,
        "plain_ms": plain_ms,
    }
    print(
        f"phase 2 anyhit: rays={NUM_RAYS} triangles={mesh.num_triangles}"
        f" blocked={int(got.sum())} mismatches=0 kernel_ms={ms:.3f} plain_ms={plain_ms:.3f}",
        flush=True,
    )

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
        verts, mask = _trace.trace_specular_cuda(*args, **kw)
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
        ms = cuda_ms(lambda: _trace.trace_specular_cuda(*args, **kw), 5)
        plain_ms = cuda_ms(lambda: _trace.trace_specular_reference(*args, **kw), 2)
        print(
            f"phase 3 trace {label}: paths={mask.numel()} valid={int(mask.sum())}"
            f" mismatches=0 max_abs_err={err:.3g} kernel_ms={ms:.3f} plain_ms={plain_ms:.3f}",
            flush=True,
        )
        return err, ms, plain_ms

    canyon = Scene(
        transmitters=torch.tensor([[-30.0, 0.0, 20.0]], device=device),
        mesh=scenes.street_canyon_scene(device=device).mesh,
    ).with_receivers_grid(64, 64)
    trace_errors = []
    for order in (1, 2):
        candidates = generate_path_candidates(canyon.mesh.num_primitives, order, device=device)
        trace_errors.append(
            check_trace(f"(a) canyon order {order}", canyon, candidates, order, want_valid=True)[0]
        )

    # (b) The bench's shape: the first 4,096 order-2 candidates x a 16 x 8
    # grid over the bounding box. Every one of those paths is invalid (the
    # candidates bounce first on the far corner block, and the receivers
    # sit inside buildings or beyond the city), so (c) adds candidates and
    # receivers with valid paths, for the vertices to be compared.
    tx = torch.tensor([[0.0, 0.0, 40.0]], device=device)
    bench_grid = Scene(transmitters=tx, mesh=mesh).with_receivers_grid(16, 8)
    candidates = generate_path_candidates(mesh.num_primitives, 2, size=4096, device=device)
    err, ms, plain_ms = check_trace("(b) city order 2, bench shape", bench_grid, candidates, 2)
    trace_errors.append(err)
    city = Scene(transmitters=tx, receivers=street_receivers(device), mesh=mesh)
    # All ordered pairs of the 91 triangles nearest the TX: 8,190 candidates.
    centroids = mesh.triangle_vertices.mean(dim=1)[:, :2]
    near = torch.argsort(centroids.norm(dim=-1))[:91]
    pairs = torch.cartesian_prod(near, near)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    trace_errors.append(
        check_trace("(c) city order 2, near pairs", city, pairs, 2, want_valid=True)[0]
    )
    prep_ms = cuda_ms(lambda: _rt.prepare_mesh(tv, None), 5)
    print(f"phase 3 mesh preparation (Morton sort and boxes, in each call above): {prep_ms:.3f} ms")
    kernels["trace"] = {
        "name": "trace",
        "route": "cuda",
        "source": "differt_tpu_torch/csrc/trace.cu",
        "replaces": "differt_tpu/ops/_pallas_trace.py:120",
        "max_abs_err": max(trace_errors),
        "ms": ms,
        "plain_ms": plain_ms,
    }

    # Phase 4: the main path, counted.
    materials = {"eta_r": [5.24], "conductivity": [0.1]}
    # Order-2 candidates whose first bounce is on the block south-west of
    # the TX (block (11, 11), 36 triangles a block): the first 1,048,576
    # candidates, as the bench decodes them, all bounce first on the far
    # corner block, and every one of those paths is blocked.
    first = 36 * (11 * 24 + 11) * (mesh.num_primitives - 1)
    main_candidates = generate_path_candidates(
        mesh.num_primitives, 2, start=first, size=MAIN_CANDIDATES, device=device
    )
    runs = (
        (0, None, 1),
        (1, None, mesh.num_primitives),
        (2, main_candidates, MAIN_CANDIDATES),
    )
    # Warm-up: the first CUDA call of each complex-valued PyTorch op compiles
    # it at run time (about a second in all), which is set-up, not the path.
    for order, candidates, _ in runs:
        coverage.power_map_chunked(
            city,
            FREQUENCY,
            order=order,
            path_candidates=None if candidates is None else candidates[:4096],
            candidate_chunk=4096,
            rx_chunk=128,
            **materials,
        )
    torch.cuda.synchronize()
    _rt.LAUNCHES = _trace.LAUNCHES = 0
    _rt.REFERENCE_CALLS = _trace.REFERENCE_CALLS = 0
    maps = {}
    for order, candidates, num_candidates in runs:
        start = time.perf_counter()
        power = coverage.power_map_chunked(
            city,
            FREQUENCY,
            order=order,
            path_candidates=candidates,
            candidate_chunk=4096,
            rx_chunk=128,
            **materials,
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        maps[order] = power
        rate = num_candidates * city.num_receivers / wall
        print(
            f"phase 4 main path order {order}: candidates={num_candidates}"
            f" rx={city.num_receivers} wall_s={wall:.4f} paths_per_s={rate:.4g}",
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
    if counts["anyhit"] == 0 or counts["trace"] == 0:
        msg = f"the main path skipped a kernel: {counts}"
        raise AssertionError(msg)
    if counts["anyhit_plain"] or counts["trace_plain"]:
        msg = f"the main path used a plain version on the card: {counts}"
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
        f"phase 4 counts: {json.dumps(counts)}; lit pixels per order: {json.dumps(lit)};"
        f" fused vs unfused max_err_db: {json.dumps(errors)}",
        flush=True,
    )

    kernels["closest"] = check_closest_kernel(device)
    run_ray_launching(device, kernels["closest"])

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
