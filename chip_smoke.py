#!/usr/bin/env python3
"""Drive the PyTorch port's coverage path once on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root, on a host with one H100:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``differt_tpu_torch/csrc/``,
checks each against its plain PyTorch version on the card, runs the main
path (``power_map_chunked`` on the 20,738-triangle ``urban_scene(24, 24)``,
orders 0, 1 and 2) and checks that the path went through both kernels and
never through their plain versions. One line per phase; then a JSON line
with each kernel's launches, error and times; then, last,
``{"ok": true, "device": {...}}``. Any failure raises (exit code != 0).
There is no CPU path: without a CUDA device the script fails at once.
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


def street_receivers(device) -> torch.Tensor:
    """16 x 8 receivers at 1.5 m on the street centrelines around the TX.

    The streets of ``urban_scene`` run along multiples of 50 m. A 16 x 8
    grid over the mesh's bounding box (the bench's layout) puts every
    receiver inside a building or behind the city's edge, and its maps are
    all zero at orders 0-2, which would leave nothing to check.
    """
    y, x = torch.meshgrid(
        50.0 * torch.arange(-4, 4, device=device),
        50.0 * torch.arange(-8, 8, device=device),
        indexing="ij",
    )
    return torch.stack((x, y, torch.full_like(x, 1.5)), dim=-1)


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

    print(f"card: {smi}")
    print(json.dumps({"kernels": [kernels["anyhit"], kernels["trace"]]}))
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
