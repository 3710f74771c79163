#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root, on a host with one H100:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``differt_tpu_torch/csrc/``,
checks each against its plain PyTorch version on the card, times each
alone (on a prepared BVH), inside its wrapper and beside its plain
version, and drives three paths, each counted from zero:

- coverage: ``power_map_chunked`` on the 20,738-triangle
  ``urban_scene(24, 24)``, orders 0, 1 and 2, through the any-hit and
  fused trace kernels and the EM tile kernel (``csrc/em.cu``, one launch
  a tile), the last held against its plain twin on tiles of each order;
- ray launching, at the width of the JAX bench's ``bench_config3``:
  ``Scene.launch_paths`` (SBR, order 3, 250,000 rays) and
  ``Scene.compute_tx_mlm`` (order 2, 500,000 rays, 128 x 128 cells) on the
  9,218-triangle ``urban_scene(16, 16)``, through the closest-hit kernel;
- the gradient step, at the width of the JAX package's
  ``scaling.py::run_config5``: ``parallel.streamed_placement_step`` with 16
  TX on ``urban_scene(24, 24)``, orders 1 and 2 in one list with 256
  candidates each, tiles of 256 candidates x 2,048 receivers, through the
  fused trace kernel's autograd Function (the kernel in passes 1 and 3,
  its plain recompute in the backward); the receiver grid is the depth, as
  deep as one warm step stays under a minute; anchored as ``scaling.py``
  anchors it (streamed against direct autograd, a finite difference on the
  permittivity), and at canyon size with smoothed masks;
- visibility (phase 14): ``Mesh.triangles_visible_from_vertex`` from the
  coverage path's TX and its 128 receivers, 1,000,000 lattice rays each,
  through the closest-hit kernel, the hits of the TX's and 8 receivers'
  rays held against the plain closest hit;
- the hybrid tracer (phase 15): ``HybridPathTracer(num_rays=1_000_000)``
  candidates at orders 1 and 2 (visibility, then the host DFS of
  ``differt_tpu_torch.native``, built with g++), and
  ``power_map_chunked(solver=...)`` through the fused trace kernel, held
  against the exhaustive order-1 map;
- antenna patterns (phase 16): the coverage path's call with a half-wave
  dipole at the TX, against the plain versions and the pattern's gain;
- first-order diffraction (phase 17): ``power_map(order=1,
  with_diffraction=True)`` on the coverage path's scene (20,736 edges x 128
  receivers), the specular half through the fused trace kernel and every
  diffraction segment's blockage through one any-hit launch, its TX
  gradient, the canyon's central difference, the kernel against its plain
  version on 8 receivers' segments and maps, and the Fresnel integrals
  against SciPy;
- mixed chains (phase 18): ``power_map(order=1, with_diffraction=True,
  mixed_signatures=[(R, D), (D, R)])`` on ``urban_scene(4, 4)`` (578
  triangles, 576 edges) with the 64 street crossings: 21 M Fermat paths a
  signature, each signature's segments in one any-hit launch, held against
  the port's CPU run and the plain versions on 8 receivers; the TX gradient
  on 16 receivers and the knife edge's central difference;
- diffuse scattering (phase 19): ``power_map(order=1, with_scattering=True)``
  on the coverage path's scene, both segments of its 2.65 M paths in one
  any-hit launch, the TX gradient, the plain versions on 8 receivers, and
  ``S = 0`` against the plain map;
- ingest and DeepMIMO (phase 20): the coverage city written as a Sionna
  scene (``io.export_scene_xml``, one PLY per object) and as an OBJ file,
  loaded back on the card (``Scene.load_xml``, ``Mesh.load_obj`` through
  the native parser), traced at orders 0-2 on the loaded mesh (128, 2.65 M
  and 16.8 M paths: one any-hit and two fused-trace launches) and exported
  with ``deepmimo.export``; held against the plain versions on 8
  receivers and against ``coverage.complex_amplitudes`` at order 1;
- the device mesh (phase 21): ``parallel.sharded_trace_paths``,
  ``sharded_power_map``, ``training_step`` and ``placement_training_step``
  on the coverage city with 127 street receivers, and
  ``streamed_placement_step`` at phase 10's width on a 256 x 256 grid, on a
  one-rank NCCL mesh (bit for bit the single device's results) and on two
  gloo ranks spawned on the one card (within float32 reorderings);
- config-5's order-3 forward (phase 22): ``power_map_chunked`` at the width
  of ``scaling.py::run_config5``'s first half, 16 TX over 1,024 x 1,024
  receivers and 128 order-3 candidates in tiles of 128 x 8,192: 128
  ``trace.cu`` launches at K = 3, the kernel held against its plain version
  on a whole tile and the map against the plain call on 8 receivers;
- the street canyon at orders 3-6 (phase 23): the exhaustive maps of
  orders 3, 4 and 5 (10,156,250 candidates at order 5) against
  ``megakernel=False``, and ``Scene.trace_paths`` on 1,048,704 order-6
  candidates, through ``trace.cu``'s templates (orders 3-4) and its
  runtime-order instantiation (5-6); the kernel against its plain version
  on 8 receivers at each order, and the order-5 TX gradient;
- checkpoint and resume (phase 24): ``treekit`` saves the scene and the
  materials after one step of ``placement_training_step`` and of
  ``streamed_placement_step``, loads them into fresh templates, and the
  next step equals two uninterrupted steps bit for bit;
- the tutorial at the XL city (phase 25): ``docs/tutorials/
  torch_cityscale_optimization.md``'s workflow on the 112,898-triangle
  ``urban_scene(56, 56)`` (``bench.py::bench_cityscale_xl``'s city, one BVH
  build): the decode beyond int32, both path kernels against their plain
  versions at its shapes, the EM tile kernel against its twin on a map
  tile, ``power_map_chunked`` on 65,536 order-2
  candidates over 128 x 128 receivers (1.07e9 paths) against
  ``megakernel=False`` on 128 of them, and three ``streamed_placement_step``
  on every order-1 candidate and 256 order-2 over 64 x 64 receivers,
  anchored as phase 11;
- the Sionna cache (phase 26): phase 20's scene laid out as the sionna-rt
  tarball in a temporary ``DIFFERT_TPU_CACHE_DIR``, listed, "downloaded"
  with no request, and ``Scene.load_xml(get_sionna_scene("city"))`` bit for
  bit phase 20's load;

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
import os
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
# The gradient step (scaling.py::run_config5's): 16 TX, 256 candidates an
# order, tiles of 256 x 2,048; two materials (walls, ground) at 2.4 GHz.
GRAD_TX, GRAD_SHARD, GRAD_RX_CHUNK = 16, 256, 2048
GRAD_ETA, GRAD_SIGMA = (3.91, 5.24), (0.024, 0.123)
GRAD_GRIDS = (256, 512, 1024)  # the depth: the largest whose warm step stays under STEP_LIMIT_S
STEP_LIMIT_S = 60.0
SMOOTHING = 50.0
VIS_RAYS = 1_000_000  # the reference's default num_rays, for visibility and the hybrid tracer
VIS_CHECKED_RX = 8  # receivers whose rays phase 14 holds against the plain closest hit, beside the TX
HW_DIPOLE_GAIN = 1.640922376984585  # 4 / Cin(2 pi), the half-wave dipole pattern's peak
DIFF_CHECKED_RX = 8  # receivers whose diffraction segments and map phase 17 holds against the plain versions
# m: the canyon's central difference along the TX gradient (phase 17). The
# coherent map's phases turn by k = 50 rad/m as the TX moves: a step of 1 cm
# costs the central difference 1-2% (its h^2 term), 3 mm about 0.2%, and
# float32's noise stays below 0.5% there (a CPU run of the same check).
FD_STEP = 0.003
MIXED_SIGNATURES = ((0, 1), (1, 0))  # (R, D) and (D, R) (phase 18)
MIXED_CHECKED_RX = 8  # receivers whose mixed paths phase 18 holds against the CPU and the plain versions
MIXED_GRAD_RX = 16  # receivers of phase 18's gradient


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


def anyhit_bound(thresholds: torch.Tensor, triangle_vertices: torch.Tensor) -> tuple[float, str]:
    """The any-hit function's bound on one call's segments. Bytes: every
    threshold read and every flag written, the origin and direction of each
    live segment (a segment whose threshold is below 0 is false from the
    threshold alone) and the mesh; operations: one Möller–Trumbore test for
    each live segment, the least a segment that is tested needs."""
    live = int((thresholds >= 0).sum())
    num_bytes = thresholds.numel() * (4 + 1) + live * 24 + mesh_bytes(triangle_vertices, None)
    return bound(num_bytes, live * MT_FLOPS)


def trace_flops(paths: int, order: int, tpm: int) -> float:
    """Geometry operations of the fused trace: per mirror the backward step (23),
    ``tpm`` Möller–Trumbore tests and the same-side check (16), per segment the
    length check (8). Blockage, which depends on the data, is not counted."""
    return paths * (order * (23 + MT_FLOPS * tpm + 16) + 8 * (order + 1))


def trace_inputs(scene, candidates):
    """The fused trace's arguments for ``candidates`` on ``scene``."""
    from differt_tpu_torch.rt._solvers import candidate_geometry

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


def check_trace(label, scene, candidates, order, *, want_valid=False, phase=3):
    """The fused trace kernel against its plain version on one call's inputs
    (masks equal, vertices within 1e-4), then timed alone, in its wrapper
    (given the BVH, and building it) and plain; returns the row of the
    kernels line."""
    from differt_tpu_torch.ops import _trace

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
        f"phase {phase} trace {label}: paths={paths} valid={int(mask.sum())}"
        f" mismatches=0 max_abs_err={err:.3g} raw_vertex_err={raw_err:.3g}"
        f" kernel_only_ms={kernel_ms:.4f} wrapper_ms={ms:.4f}"
        f" wrapper_with_build_ms={build_ms:.3f} plain_ms={plain_ms:.3f}"
        f" bound_ms={bound_ms:.5f} ({bound_by}, {num_bytes} bytes)",
        flush=True,
    )
    return {
        "valid": int(mask.sum()),
        "max_abs_err": err,
        "kernel_only_ms": kernel_ms,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # No single PyTorch call computes the fused trace.
    }


def check_em(label, scene, candidates, materials: dict, *, want_valid=False, phase=4):
    """The EM tile kernel against its plain twin on one traced tile of a path
    (the tile ``_coverage_tile`` hands it: the fused trace's vertices and
    mask, each candidate's rows), and two launches bit for bit; then timed
    alone (its device records), in its wrapper and plain. Returns the row
    of the kernels line.

    The bound: each path's mask byte, a valid path's vertices, the rows and
    the sums; the operations of the paths that survive are not counted.
    """
    from differt_tpu_torch.ops import _em
    from differt_tpu_torch.rt._solvers import candidate_rows, trace_geometry

    tx = scene.transmitters.reshape(-1, 3)
    rx = scene.receivers.reshape(-1, 3)
    vertices, mask, triangles, k = trace_geometry(scene.mesh, tx, rx, candidates)
    objects, types = candidate_rows(triangles, None, k)
    mats = {name: torch.as_tensor(v, dtype=torch.float32, device=tx.device) for name, v in materials.items()}
    args = (vertices, mask, objects, types, scene.mesh, FREQUENCY)
    launches = _em.LAUNCHES
    got = _em.em_tile_sum(*args, **mats)
    again = _em.em_tile_sum(*args, **mats)
    want = _em.em_tile_sum_reference(*args, **mats)
    torch.cuda.synchronize()
    if _em.LAUNCHES != launches + 2:
        msg = f"the EM tile kernel launched {_em.LAUNCHES - launches} times for 2 calls ({label})"
        raise AssertionError(msg)
    valid = int(mask.sum())
    if want_valid and not valid:
        msg = f"no valid path to compare sums on ({label})"
        raise AssertionError(msg)
    if not torch.equal(got, again):
        msg = f"two launches of the EM tile kernel differ ({label})"
        raise AssertionError(msg)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not err <= 1e-4 * scale:
        msg = f"the EM tile kernel's sums differ from its twin's by {err} (largest sum {scale}) ({label})"
        raise AssertionError(msg)
    records = profile(f"em {label}", lambda: [_em.em_tile_sum(*args, **mats) for _ in range(10)], ("em_kernel",))
    kernel_ms = records["em_kernel"][1]
    ms = cuda_ms(lambda: _em.em_tile_sum(*args, **mats), 20)
    plain_ms = cuda_ms(lambda: _em.em_tile_sum_reference(*args, **mats), 2)
    order = vertices.shape[-2] - 2
    num_bytes = mask.numel() + valid * (order + 2) * 12 + objects.numel() * 12 + got.numel() * got.element_size()
    bound_ms, bound_by = bound(num_bytes, 0.0)
    print(
        f"phase {phase} em {label}: paths={mask.numel()} valid={valid} largest_sum={scale:.4g}"
        f" max_abs_err={err:.3g} rel_err={err / scale if scale else 0.0:.3g} repeat_bitwise=True"
        f" kernel_only_ms={kernel_ms:.4f} wrapper_ms={ms:.4f} plain_ms={plain_ms:.3f}"
        f" bound_ms={bound_ms:.5f} ({bound_by}, {num_bytes} bytes)",
        flush=True,
    )
    return {
        "valid": valid,
        "max_abs_err": err,
        "rel_err": err / scale if scale else 0.0,
        "kernel_only_ms": kernel_ms,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # No single PyTorch call computes the chain and its sum.
    }


def note_em(kernels: dict, path: str, launches: int) -> None:
    """Add a path's launches of the EM tile kernel to its row of the kernels line."""
    kernels["em"]["launches"] += launches
    kernels["em"]["launches_by_path"][path] = kernels["em"]["launches_by_path"].get(path, 0) + launches


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


def random_segments(mesh, num: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``num`` segments between uniform points of the mesh's bounding box
    (from 0.5 m to 10 m over its top), one in 8 inactive, from seed 0:
    origins, directions and thresholds."""
    rng = np.random.default_rng(0)
    lo, hi = mesh.bounding_box.cpu().numpy()
    lo[2], hi[2] = 0.5, hi[2] + 10.0
    start_pts = rng.uniform(lo, hi, (num, 3)).astype(np.float32)
    end_pts = rng.uniform(lo, hi, (num, 3)).astype(np.float32)
    thresh = np.where(np.arange(num) % 8 != 0, 1.0 - 2.0 * HIT_TOL, -1.0).astype(np.float32)
    return tuple(torch.from_numpy(x).to(mesh.device) for x in (start_pts, end_pts - start_pts, thresh))


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
    first_chunk = generate_path_candidates(mesh.num_primitives, 1, device=device)[:4096]
    return {
        "(a) 262,144 segments": random_segments(mesh, NUM_RAYS),
        "(b) main path, order 0": unfused_segments(
            city, generate_path_candidates(mesh.num_primitives, 0, device=device)
        ),
        "(c) unfused order-1 chunk": unfused_segments(city, first_chunk),
    }


def check_anyhit_at(label: str, o, d, th, mesh, *, phase: int) -> dict:
    """The any-hit kernel against its plain version on one call's segments, bit
    for bit, at the split level its wrapper picks and at level 0 (one walk per
    ray); then timed at both levels alone, in its wrapper (given the BVH, and
    building it) and plain. Returns the row of the kernels line."""
    from differt_tpu_torch.ops import _rt

    tv = mesh.triangle_vertices.contiguous()
    bvh = mesh.bvh
    eps = TRACE_KW["epsilon"]
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
    bound_ms, bound_by = anyhit_bound(th, tv)
    print(
        f"phase {phase} anyhit {label}: rays={num} live={live} triangles={tv.shape[0]}"
        f" blocked={int(got.sum())} split={picked} (depth {bvh.depth},"
        f" {_rt.anyhit_items(live, picked)} items) mismatches=0 (split {picked} and 0)"
        f" kernel_only_ms={kernel_ms:.4f} kernel_only_split0_ms={level0_ms:.4f}"
        f" wrapper_ms={ms:.4f} wrapper_with_build_ms={build_ms:.3f} plain_ms={plain_ms:.3f}"
        f" bound_ms={bound_ms:.5f} ({bound_by})",
        flush=True,
    )
    return {
        "max_abs_err": 0.0,
        "kernel_only_ms": kernel_ms,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # No single PyTorch call computes an any-hit test.
    }


def check_anyhit(device, mesh, city, kernels: dict) -> None:
    """Phase 2: the any-hit kernel against its plain version at the shapes
    of :func:`anyhit_shapes` (:func:`check_anyhit_at`), and on an empty
    launch (every ray inactive) at the main path's shape."""
    from differt_tpu_torch.ops import _bvh, _rt

    tv = mesh.triangle_vertices.contiguous()
    bvh = mesh.bvh
    for label, (o, d, th) in anyhit_shapes(city).items():
        row = check_anyhit_at(label, o, d, th, mesh, phase=2)
        if label.startswith("(b)"):
            inactive = torch.full_like(th, -1.0)
            out = torch.empty(o.shape[0], dtype=torch.bool, device=device)
            empty_ms = cuda_ms(lambda: _rt.launch_anyhit(o, d, inactive, bvh, TRACE_KW["epsilon"], out), 20)
            print(
                f"phase 2 anyhit (b) empty launch, every ray inactive:"
                f" split={_rt.anyhit_split(int((th >= 0).sum()), bvh.depth)}"
                f" kernel_only_ms={empty_ms:.4f}",
                flush=True,
            )
            kernels["anyhit"] = {
                "name": "anyhit",
                "route": "cuda",
                "source": "differt_tpu_torch/csrc/anyhit.cu",
                "replaces": "differt_tpu/ops/_pallas_rt.py:228",
                "shape": "main path order 0: 128 segments x 20,738 triangles",
                **row,
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
        kernels["closest"].setdefault("launches_by_path", {})[label] = counts["closest"]
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


# The count of :func:`counters` that each port kernel's wrapper raises once a launch.
PROFILED_COUNTS = {
    "trace_kernel": "trace", "compact_kernel": "anyhit", "anyhit_kernel": "anyhit", "closest_kernel": "closest",
    "em_kernel": "em",
}
PROFILE_ATTEMPTS = 4
# torch.profiler on the card loses device records: in a process some minutes
# old, a session that opens soon after the last often drops a kernel, or
# places its record far from its launch and so outside the window. So each
# attempt first waits PROFILE_PAUSE_S, and the call sits PROFILE_MARGIN_S
# inside each edge of the window.
PROFILE_PAUSE_S, PROFILE_MARGIN_S = 2.0, 0.25


def profile(label: str, fn, kernel_names: tuple[str, ...]) -> dict:
    """Phase 8: one warm call of a path under torch.profiler, the device's
    activity alone: its busy share, each port kernel's launches and mean
    device time, the top kernels. Each kernel's launches are counted twice:
    by its wrapper's count over the profiled call (exact) and by the records
    the profiler kept. A profile that lost a record is taken again,
    ``PROFILE_ATTEMPTS`` times at most; the one that kept the most records
    is read, and it must hold at least one of each kernel. Returns
    ``{kernel name: (records kept, mean ms of those, launches made)}`` of
    ``kernel_names``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    named = counters()
    fn()  # warm
    torch.cuda.synchronize()
    best = None
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        time.sleep(PROFILE_PAUSE_S)
        before = {k: getattr(*named[PROFILED_COUNTS[k]]) for k in kernel_names}
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            time.sleep(PROFILE_MARGIN_S)
        made = {k: getattr(*named[PROFILED_COUNTS[k]]) - before[k] for k in kernel_names}
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        by_name: dict[str, list[float]] = {}
        for e in events:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
        seen = {}
        for k in kernel_names:  # every instantiation of a template kernel together
            seen[k] = [t for name, v in by_name.items() if k in name for t in v]
        kept = sum(map(len, seen.values()))
        if best is None or kept > best[0]:
            best = (kept, attempt, wall, events, by_name, seen, made)
        if all(len(seen[k]) == made[k] for k in kernel_names):
            break
        print(
            f"phase 8 profile {label}: attempt {attempt} kept"
            f" {json.dumps({k: f'{len(seen[k])} of {made[k]}' for k in kernel_names})} launch records",
            flush=True,
        )
    _, attempt, wall, events, by_name, seen, made = best
    if lost := [k for k in kernel_names if made[k] and not seen[k]]:
        msg = f"phase 8 profile {label}: {PROFILE_ATTEMPTS} profiles kept no record of {lost}, made {made}"
        raise AssertionError(msg)
    per_kernel = {k: (len(v), sum(v) / len(v) / 1e3, made[k]) for k, v in seen.items() if v}
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    ours = {k: f"{n} of {m} launches, {ms:.4f} ms each" for k, (n, ms, m) in per_kernel.items()}
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:6]
    top_text = "; ".join(
        f"{name[:70]} {sum(v) / 1e3:.2f} ms ({100 * sum(v) / busy_us:.0f}%, {len(v)})"
        for name, v in top
    )
    print(
        f"phase 8 profile {label}: attempt {attempt} wall_ms={wall * 1e3:.1f} device_ms={busy_us / 1e3:.2f}"
        f" busy={100 * busy_us / 1e3 / (wall * 1e3):.0f}% device_records={len(events)}"
        f" ours={json.dumps(ours)} top: {top_text}",
        flush=True,
    )
    return per_kernel


# -- The gradient path ----------------------------------------------------------


def first_unique(rows: torch.Tensor, size: int) -> torch.Tensor:
    """The first ``size`` distinct rows of ``rows``, in order."""
    seen, keep = set(), []
    for i, row in enumerate(map(tuple, rows.tolist())):
        if row not in seen:
            seen.add(row)
            keep.append(i)
    if len(keep) < size:
        msg = f"only {len(keep)} distinct candidates, {size} wanted"
        raise AssertionError(msg)
    return rows[torch.tensor(keep[:size], device=rows.device)]


def strided_candidates(num_primitives: int, order: int, size: int, device, group: int = 8) -> torch.Tensor:
    """``size`` candidates in groups of ``group`` spread evenly over the whole decode range."""
    from differt_tpu_torch.geometry import count_path_candidates, generate_path_candidates

    total = count_path_candidates(num_primitives, order)
    groups = max(size // group, 1)
    step = max(total // groups, 1)
    parts = [
        generate_path_candidates(
            num_primitives, order, start=min(g * step, total - group), size=group, device=device
        )
        for g in range(groups)
    ]
    return torch.cat(parts)[:size]


def placement_scene(device, grid: int, num_tx: int = GRAD_TX):
    """The gradient step's scene: ``urban_scene(24, 24)`` with brick buildings
    and a concrete ground, ``num_tx`` transmitters at 60 m on a square grid
    inside 15% margins, ``grid`` x ``grid`` receivers at 1.5 m over the
    mesh's bounding box (the layout of ``scaling.py::_city_scene``)."""
    from differt_tpu_torch import scenes
    from differt_tpu_torch.geometry import Scene

    mesh = scenes.urban_scene(24, 24, device=device).mesh
    materials = torch.zeros(mesh.num_triangles, dtype=torch.int64, device=device)
    materials[-2:] = 1  # the ground's two triangles come last
    mesh = dataclasses.replace(
        mesh, material_names=("Brick", "Concrete"), face_materials=materials
    )
    (min_x, min_y, _), (max_x, max_y, _) = mesh.bounding_box.tolist()
    side = int(round(num_tx**0.5))
    gx, gy = torch.meshgrid(
        torch.linspace(min_x + 0.15 * (max_x - min_x), max_x - 0.15 * (max_x - min_x), side),
        torch.linspace(min_y + 0.15 * (max_y - min_y), max_y - 0.15 * (max_y - min_y), side),
        indexing="xy",
    )
    tx = torch.stack((gx, gy, torch.full_like(gx, 60.0)), dim=-1).reshape(-1, 3).to(device)
    return Scene(transmitters=tx, mesh=mesh).with_receivers_grid(grid, grid, height=1.5)


def placement_candidates(scene) -> list[torch.Tensor]:
    """The gradient step's candidates, ``GRAD_SHARD`` of each order, no duplicates.

    Order 1: the eight largest triangles by area (the ground above all:
    without it nearly every pixel sits at the floor of -300 dB) and a
    stride over the rest. Order 2: every ordered pair of the ground's two
    triangles and the 14 nearest wall triangles that face the sixth
    transmitter, so that some double-bounce paths are valid (wall then
    ground, wall then wall), then a stride.
    """
    mesh = scene.mesh
    device = mesh.device
    num = mesh.num_primitives
    tv = mesh.triangle_vertices
    areas = torch.linalg.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]).norm(dim=-1)
    top = torch.argsort(areas)[-8:]
    order1 = first_unique(
        torch.cat((top[:, None], strided_candidates(num, 1, GRAD_SHARD, device))), GRAD_SHARD
    )
    # Walls that face the sixth transmitter, the nearest first, without those
    # of the building it stands over (within 20 m).
    to_tx = scene.transmitters.reshape(-1, 3)[5] - tv.mean(dim=1)
    dist = to_tx[:, :2].norm(dim=-1)
    normals = mesh.normals
    facing = (normals[:, 2].abs() < 0.1) & ((normals * to_tx).sum(dim=-1) > 0) & (dist > 20.0)
    walls = torch.nonzero(facing).flatten()
    near = walls[torch.argsort(dist[walls])[:14]]
    picked = torch.cat((torch.tensor([num - 2, num - 1], device=device), near)).unique()
    pairs = torch.cartesian_prod(picked, picked)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    order2 = first_unique(
        torch.cat((pairs, strided_candidates(num, 2, GRAD_SHARD, device))), GRAD_SHARD
    )
    return [order1, order2]


def tile_start(scene, size: int, index: int = 5) -> int:
    """The first receiver of the tile of ``size`` receivers (in input order) that
    holds the receiver nearest transmitter ``index``."""
    rx = scene.receivers.reshape(-1, 3)
    tx = scene.transmitters.reshape(-1, 3)[index]
    nearest = int((rx[:, :2] - tx[:2]).norm(dim=-1).argmin())
    return nearest // size * size


def tile_near_tx(scene, index: int = 5) -> torch.Tensor:
    """The ``GRAD_RX_CHUNK`` receivers of the streamed step's tile that holds the
    receiver nearest transmitter ``index`` (where the order-2 candidates have valid paths)."""
    start = tile_start(scene, GRAD_RX_CHUNK, index)
    return scene.receivers.reshape(-1, 3)[start : start + GRAD_RX_CHUNK].contiguous()


def placement_kwargs(scene, candidates) -> dict:
    device = scene.mesh.device
    return {
        "tx": scene.transmitters.reshape(-1, 3),
        "eta_r": torch.tensor(GRAD_ETA, device=device),
        "conductivity": torch.tensor(GRAD_SIGMA, device=device),
        "path_candidates": candidates,
        "candidate_chunk": GRAD_SHARD,
        "rx_chunk": GRAD_RX_CHUNK,
    }


def length_gradients(scene, candidates: torch.Tensor):
    """The valid paths' total length and its gradients to the TX, the RX and
    the mesh's vertices, through ``trace_path_candidates`` as the backend
    resolves it (the Function on the card; unfused and plain under
    ``set_backend("torch")``)."""
    from differt_tpu_torch.rt import trace_path_candidates

    tx = scene.transmitters.reshape(-1, 3).clone().requires_grad_()
    rx = scene.receivers.reshape(-1, 3).clone().requires_grad_()
    vertices = scene.mesh.vertices.clone().requires_grad_()
    mesh = dataclasses.replace(scene.mesh, vertices=vertices)
    paths = trace_path_candidates(mesh, tx, rx, candidates)
    seg = paths.vertices[..., 1:, :] - paths.vertices[..., :-1, :]
    lengths = torch.sqrt((seg * seg).sum(dim=-1) + 1e-12).sum(dim=-1)
    total = torch.where(paths.mask, lengths, 0.0).sum()
    return total.detach(), torch.autograd.grad(total, (tx, rx, vertices)), paths.mask


def check_function(label: str, scene, candidates: torch.Tensor, *, want_valid: bool, phase: int = 9) -> None:
    """Phase 9: the fused trace's autograd Function on the card. Its
    backward's recompute gives the kernel's vertices on every valid path
    (gate 1e-4), and the gradients through it equal those of the plain,
    unfused pipeline with direct autograd (rtol 1e-4); all finite."""
    from differt_tpu_torch import ops
    from differt_tpu_torch.ops import _trace
    from differt_tpu_torch.rt._solvers import candidate_geometry

    order = candidates.shape[1]
    _, tris, mirror_vertices, mirror_normals = candidate_geometry(scene.mesh, candidates)
    tx = scene.transmitters.reshape(-1, 3).contiguous()
    rx = scene.receivers.reshape(-1, 3).contiguous()
    verts, mask = _trace.trace_specular_cuda(
        tx, rx, mirror_vertices, mirror_normals, tris, None, None,
        order=order, **TRACE_KW, bvh=scene.mesh.bvh,
    )
    recomputed = _trace.trace_vertices(tx, rx, mirror_vertices, mirror_normals)
    valid = int(mask.sum())
    if want_valid and not valid:
        msg = f"no valid path to compare the recompute on ({label})"
        raise AssertionError(msg)
    differ = int((recomputed[mask] != verts[mask]).sum())
    err = float((recomputed[mask] - verts[mask]).abs().max()) if valid else 0.0
    if not err <= 1e-4:
        msg = f"the recompute's vertices differ from the kernel's by {err} ({label})"
        raise AssertionError(msg)
    del verts, recomputed

    launches, calls = _trace.LAUNCHES, _trace.REFERENCE_CALLS
    total, fused, fused_mask = length_gradients(scene, candidates)
    if (_trace.LAUNCHES, _trace.REFERENCE_CALLS) != (launches + 1, calls):
        msg = f"the Function did not launch the kernel once ({label})"
        raise AssertionError(msg)
    ops.set_backend("torch")
    try:
        want_total, plain, plain_mask = length_gradients(scene, candidates)
    finally:
        ops.set_backend("auto")
    if not torch.equal(fused_mask, plain_mask):
        msg = f"the Function's mask differs from the plain pipeline's ({label})"
        raise AssertionError(msg)
    worst = 0.0
    for name, got, want in zip(("tx", "rx", "vertices"), fused, plain):
        if not torch.isfinite(got).all():
            msg = f"the Function's gradient to {name} is not finite ({label})"
            raise AssertionError(msg)
        scale = float(want.abs().max())
        if want_valid and not scale > 0.0:
            msg = f"the gradient to {name} is zero ({label})"
            raise AssertionError(msg)
        if scale:
            rel = float(((got - want).abs() / (want.abs() + scale)).max())
            worst = max(worst, rel)
            if not torch.allclose(got, want, rtol=1e-4, atol=1e-4 * scale):
                msg = f"the Function's gradient to {name} differs from the plain one's ({label}): {rel}"
                raise AssertionError(msg)
    print(
        f"phase {phase} function {label}: paths={mask.numel()} valid={valid}"
        f" recompute_vs_kernel: entries_that_differ={differ} max_abs_err={err:.3g}"
        f" total_length={total.item():.6g} (plain {want_total.item():.6g})"
        f" gradient_max_rel_err={worst:.3g} (tx, rx, vertices; gate rtol 1e-4) finite=True",
        flush=True,
    )


def anchor_streamed_step(label: str, scene_direct, scene_sub, kwargs: dict) -> str:
    """The anchors of a streamed placement step at ``kwargs``' TX and
    materials (phases 11 and 25); each gate raises, and the numbers come
    back as text.

    (1) The streamed TX gradient against direct autograd of the identical
    loss (``_coverage_tile`` on each order's candidates whole) on
    ``scene_direct``'s receivers: cosine >= 0.999, norm ratio within 1%.
    (2) The central difference of the loss on ``scene_sub``'s receivers
    along the permittivity's gradient, h = 1e-2 (no geometry moves, no mask
    flips): within 1%. (3) The raw TX central difference, h = 5e-4 m, beside
    the autograd slope: their gap is the drift of hard masks that flip as
    the TX moves (not gated). ``kwargs`` are ``streamed_placement_step``'s
    arguments other than the scene, the frequency and the rates.
    """
    from differt_tpu_torch.coverage import _CandidateSet, _coverage_tile
    from differt_tpu_torch.parallel import streamed_placement_loss, streamed_placement_step
    from differt_tpu_torch.parallel._sharding import _placement_loss

    tx0, eta0, sigma = kwargs["tx"], kwargs["eta_r"], kwargs["conductivity"]
    device = tx0.device

    def step(scene):
        return streamed_placement_step(
            scene, FREQUENCY, None, **kwargs, tx_learning_rate=1.0, eta_learning_rate=1.0
        )

    def sub_loss(tx, eta) -> float:
        db = streamed_placement_loss(
            scene_sub, FREQUENCY, None, return_db_map=True, **{**kwargs, "tx": tx, "eta_r": eta}
        )
        return -float(db.double().cpu().mean())  # the mean in float64, on the host

    # (1) The streamed TX gradient against direct autograd of the identical loss.
    d_tx, _, d_loss = step(scene_direct)
    g_streamed = tx0 - d_tx
    tx_leaf = tx0.clone().requires_grad_()
    rx_direct = scene_direct.receivers.reshape(-1, 3)
    torch.cuda.reset_peak_memory_stats()
    total = None
    for cand in kwargs["path_candidates"]:
        part = _coverage_tile(
            scene_direct, tx_leaf, rx_direct, _CandidateSet(cand, None, len(cand), len(cand)), 0, len(cand),
            None, torch.tensor(FREQUENCY, device=device), eta0, sigma, None, True, None,
        )
        total = part if total is None else total + part
    (g_direct,) = torch.autograd.grad(_placement_loss(total.real, total.imag, None), tx_leaf)
    direct_peak = torch.cuda.max_memory_allocated() / 2**30
    del total
    cos = float((g_streamed * g_direct).sum() / (g_streamed.norm() * g_direct.norm() + 1e-30))
    ratio = float(g_streamed.norm() / (g_direct.norm() + 1e-30))
    if not (cos >= 0.999 and abs(ratio - 1.0) <= 0.01):
        msg = f"{label}: the streamed TX gradient is off the direct one: cosine {cos}, norm ratio {ratio}"
        raise AssertionError(msg)

    # (2) The permittivity's central difference.
    sub_tx, sub_eta, _ = step(scene_sub)
    g_tx_sub, g_eta_sub = tx0 - sub_tx, eta0 - sub_eta
    eta_norm = float(g_eta_sub.norm())
    u_eta = g_eta_sub / max(eta_norm, 1e-30)
    h_eta = 1e-2
    fd_eta = (sub_loss(tx0, eta0 + h_eta * u_eta) - sub_loss(tx0, eta0 - h_eta * u_eta)) / (2 * h_eta)
    eta_rel = abs(fd_eta - eta_norm) / max(eta_norm, 1e-30)
    if not (eta_norm > 0.0 and eta_rel <= 0.01):
        msg = f"{label}: the permittivity finite difference {fd_eta} is off the streamed gradient {eta_norm}"
        raise AssertionError(msg)
    # (3) The raw TX central difference.
    sub_norm = float(g_tx_sub.norm())
    u_tx = g_tx_sub / max(sub_norm, 1e-30)
    h_tx = 5e-4
    fd_tx = (sub_loss(tx0 + h_tx * u_tx, eta0) - sub_loss(tx0 - h_tx * u_tx, eta0)) / (2 * h_tx)
    return (
        f"(1) streamed vs direct autograd on {rx_direct.shape[0]} rx:"
        f" cosine={cos:.6f} norm_ratio={ratio:.5f} loss={float(d_loss):.6g}"
        f" direct_peak_GiB={direct_peak:.2f} (gates: cosine >= 0.999, ratio within 1%);"
        f" (2) eta central difference on {scene_sub.num_receivers} rx, h={h_eta}:"
        f" fd={fd_eta:.6g} streamed={eta_norm:.6g} rel_err={eta_rel:.2e} (gate 1%);"
        f" (3) raw tx central difference, h={h_tx} m: fd={fd_tx:.6g} autograd_slope={sub_norm:.6g}"
        f" (not gated: the gap is the hard masks' drift)"
    )


def run_placement(device, kernels: dict) -> None:
    """Phases 10-12: the gradient step at full width, counted; its anchors on
    a strided subsample of the same grid; a profile and a tile's breakdown."""
    from differt_tpu_torch import ops
    from differt_tpu_torch.coverage import _CandidateSet, _coverage_tile, complex_amplitudes, z_0
    from differt_tpu_torch.ops import _bvh, _em, _rt, _trace
    from differt_tpu_torch.parallel import streamed_placement_loss, streamed_placement_step
    from differt_tpu_torch.parallel._sharding import _placement_loss
    from differt_tpu_torch.rt import trace_path_candidates

    unit = {"tx_learning_rate": 1.0, "eta_learning_rate": 1.0}

    def step(scene, candidates, **kw):
        return streamed_placement_step(
            scene, FREQUENCY, None, **{**placement_kwargs(scene, candidates), **unit, **kw}
        )

    card_s = {}  # label -> seconds between two CUDA events around the call: the card's own clock

    def timed(fn, label=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start = time.perf_counter()
        begin.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        if label is not None:
            card_s[label] = begin.elapsed_time(end) / 1e3
        return out, wall, torch.cuda.max_memory_allocated() / 2**30

    # Phase 10: the depth. A warm step at the smallest grid, then the largest
    # grid whose step, at that rate per tile, stays under the limit.
    scene = placement_scene(device, GRAD_GRIDS[0])
    if scene.mesh.num_triangles != 20_738:
        msg = f"urban_scene(24, 24) has {scene.mesh.num_triangles} triangles, expected 20,738"
        raise AssertionError(msg)
    candidates = placement_candidates(scene)
    if ops.get_backend() != "auto":
        msg = f"the gradient step needs the 'auto' backend, not {ops.get_backend()!r}"
        raise AssertionError(msg)
    step(scene, candidates)  # warm-up: run-time compilation of the complex ops' backward
    _, small_wall, _ = timed(lambda: step(scene, candidates))
    grid = max(
        (g for g in GRAD_GRIDS if small_wall * (g / GRAD_GRIDS[0]) ** 2 <= STEP_LIMIT_S),
        default=GRAD_GRIDS[0],
    )
    print(
        f"phase 10 depth: a warm step at {GRAD_GRIDS[0]}x{GRAD_GRIDS[0]} took {small_wall:.2f} s,"
        f" so {grid}x{grid} is predicted at {small_wall * (grid / GRAD_GRIDS[0]) ** 2:.1f} s"
        f" (limit {STEP_LIMIT_S:.0f} s; grids {GRAD_GRIDS})",
        flush=True,
    )
    scene = placement_scene(device, grid)
    num_rx = scene.num_receivers
    tiles = -(-num_rx // GRAD_RX_CHUNK) * len(candidates)

    # Pass 1 alone (the loss entry point), for its wall, its peak and the map.
    db_map, pass1_wall, pass1_peak = timed(
        lambda: streamed_placement_loss(
            fresh(scene), FREQUENCY, None, return_db_map=True,
            **placement_kwargs(scene, candidates),
        ),
        "pass1",
    )
    lit_share = float((db_map > -299.0).float().mean())
    mean_db = float(db_map.double().mean())
    # Pass 2 alone, on sums of the same shape: the loss and its gradient.
    re = torch.full_like(db_map, 1e-6).requires_grad_()
    im = torch.full_like(db_map, 1e-6).requires_grad_()
    _, pass2_wall, _ = timed(
        lambda: torch.autograd.grad(_placement_loss(re, im, None), (re, im)), "pass2"
    )
    del db_map, re, im

    run_scene = fresh(scene)
    _rt.LAUNCHES = _trace.LAUNCHES = _rt.REFERENCE_CALLS = _trace.REFERENCE_CALLS = 0
    _bvh.BUILDS = _em.LAUNCHES = 0
    (new_tx, new_eta, loss), wall, peak = timed(lambda: step(run_scene, candidates), "step")
    counts = {
        "em": _em.LAUNCHES,
        "trace": _trace.LAUNCHES,
        "anyhit": _rt.LAUNCHES,
        "trace_plain": _trace.REFERENCE_CALLS,
        "anyhit_plain": _rt.REFERENCE_CALLS,
        "bvh_builds": _bvh.BUILDS,
    }
    want_counts = {  # the EM tile kernel in pass 1's tiles; pass 3's run the plain chain
        "em": tiles, "trace": 2 * tiles, "anyhit": 0, "trace_plain": 0, "anyhit_plain": 0, "bvh_builds": 1,
    }
    if counts != want_counts:
        msg = f"the gradient step's counts are {counts}, expected {want_counts}"
        raise AssertionError(msg)
    tx0 = scene.transmitters.reshape(-1, 3)
    g_tx = tx0 - new_tx
    g_eta = torch.tensor(GRAD_ETA, device=device) - new_eta
    tx_grad_norm = float(g_tx.norm())
    if not (torch.isfinite(loss) and torch.isfinite(g_tx).all() and torch.isfinite(g_eta).all()):
        msg = "the gradient step's loss or gradients are not finite"
        raise AssertionError(msg)
    if not tx_grad_norm > 0.0:
        msg = "the gradient step's TX gradient is zero"
        raise AssertionError(msg)
    paths = GRAD_TX * num_rx * len(candidates) * GRAD_SHARD
    kernels["trace"]["launches_by_path"] = {
        "coverage": kernels["trace"]["launches"], "placement_step": counts["trace"],
    }
    kernels["trace"]["launches"] += counts["trace"]
    note_em(kernels, "placement_step", counts["em"])
    print(
        f"phase 10 gradient step: tx={GRAD_TX} grid={grid}x{grid} rx={num_rx}"
        f" triangles={scene.mesh.num_triangles} orders=[1, 2] candidates={GRAD_SHARD} an order"
        f" tile={GRAD_TX}x{GRAD_RX_CHUNK}x{GRAD_SHARD} tiles={tiles}"
        f" wall_s={wall:.3f} pass1_wall_s={pass1_wall:.3f} pass2_wall_s={pass2_wall:.4f}"
        f" pass3_wall_s={wall - pass1_wall - pass2_wall:.3f} (the step less passes 1 and 2)"
        f" card_s={card_s['step']:.3f} pass1_card_s={card_s['pass1']:.3f}"
        f" pass2_card_s={card_s['pass2']:.4f}"
        f" pass3_card_s={card_s['step'] - card_s['pass1'] - card_s['pass2']:.3f}"
        f" (CUDA events; the card's busy share is phase 8's)"
        f" placement_step_paths_per_s={paths / wall:.4g}"
        f" peak_GiB={peak:.2f} pass1_peak_GiB={pass1_peak:.2f}"
        f" loss={float(loss):.6g} mean_dB={mean_db:.4f} tx_grad_norm={tx_grad_norm:.6g}"
        f" eta_grad={g_eta.tolist()} pixels_above_floor={lit_share:.4f}"
        f" counts={json.dumps(counts)}",
        flush=True,
    )

    # Phase 11: anchors on strided subsamples of the same grid.
    rx_flat = scene.receivers.reshape(-1, 3)
    scene_sub = dataclasses.replace(scene, receivers=rx_flat[:: max(1, num_rx // 4096)])
    scene_direct = dataclasses.replace(scene, receivers=rx_flat[:: max(1, num_rx // 1024)])
    eta0 = torch.tensor(GRAD_ETA, device=device)
    sigma = torch.tensor(GRAD_SIGMA, device=device)

    anchors = anchor_streamed_step("phase 11", scene_direct, scene_sub, placement_kwargs(scene, candidates))
    print(f"phase 11 anchors: {anchors}", flush=True)

    # Phase 12: where a tile's time goes (CUDA events, warm), and a profile
    # of a step of 16 tiles (a 128 x 128 grid).
    cand = candidates[1]
    rx_tile = tile_near_tx(scene)
    cand_set = _CandidateSet(cand, None, len(cand), len(cand))
    freq = torch.tensor(FREQUENCY, device=device)
    scene_tile = dataclasses.replace(scene, receivers=rx_flat[:0])

    def tile_forward(tx, eta):
        a = _coverage_tile(
            scene_tile, tx, rx_tile, cand_set, 0, len(cand), None, freq, eta, sigma, None, True, None
        )
        return a.real, a.imag

    def tile_backward():
        tx, eta = tx0.clone().requires_grad_(), eta0.clone().requires_grad_()
        parts = tile_forward(tx, eta)
        return torch.autograd.grad(parts, (tx, eta), (torch.ones_like(parts[0]),) * 2)

    def recompute_backward():
        from differt_tpu_torch.rt._solvers import candidate_geometry

        _, _, mirror_vertices, mirror_normals = candidate_geometry(scene.mesh, cand)
        tx = tx0.clone().requires_grad_()
        verts = _trace.trace_vertices(tx, rx_tile, mirror_vertices, mirror_normals)
        return torch.autograd.grad(verts, tx, torch.ones_like(verts))

    with torch.no_grad():
        paths_tile = trace_path_candidates(scene.mesh, tx0, rx_tile, cand)
        trace_ms = cuda_ms(lambda: trace_path_candidates(scene.mesh, tx0, rx_tile, cand), 5)
        em_ms = cuda_ms(
            lambda: complex_amplitudes(
                paths_tile, scene_tile, freq, eta_r=eta0, conductivity=sigma
            ),
            5,
        )
        forward_ms = cuda_ms(lambda: tile_forward(tx0, eta0), 5)
    both_ms = cuda_ms(tile_backward, 3)
    recompute_ms = cuda_ms(recompute_backward, 3)
    # The EM chain's per-bounce gather of the triangles' table, forward and
    # backward, as `utils.gather_columns` writes it (an embedding lookup)
    # and as plain indexing: the tile repeats each of its 256 rows 32,768 times.
    from differt_tpu_torch.utils import gather_columns

    idx = paths_tile.objects[..., 1]
    table = torch.cat((scene.mesh.normals, scene.mesh.normals), dim=-1).requires_grad_()
    cot = torch.ones((6, *idx.shape), device=device)
    gather_ms = cuda_ms(lambda: torch.autograd.grad(gather_columns(table, idx), table, cot), 3)
    index_ms = cuda_ms(
        lambda: torch.autograd.grad(torch.movedim(table[idx], -1, 0), table, cot), 3
    )
    print(
        f"phase 12 tile, order 2, {GRAD_TX}x{GRAD_RX_CHUNK}x{GRAD_SHARD} paths"
        f" ({int(paths_tile.mask.sum())} valid), elapsed on the card's clock (CUDA events):"
        f" trace_ms={trace_ms:.2f} em_forward_ms={em_ms:.2f} tile_forward_ms={forward_ms:.2f}"
        f" tile_forward_and_backward_ms={both_ms:.2f}"
        f" recompute_forward_and_backward_ms={recompute_ms:.2f}"
        f" gather_forward_and_backward_ms={gather_ms:.2f} (as plain indexing: {index_ms:.2f})",
        flush=True,
    )
    del paths_tile, idx, table, cot
    small = placement_scene(device, 128)
    profile(
        "gradient step, 16 tiles (128 x 128 rx)",
        lambda: step(small, candidates),
        ("trace_kernel",),
    )


def run_smoothed(device) -> None:
    """Phase 13: the smoothed step at canyon size: the streamed TX gradient
    against a central difference of the streamed loss (rtol 0.05)."""
    from differt_tpu_torch import scenes
    from differt_tpu_torch.geometry import Scene, generate_path_candidates
    from differt_tpu_torch.ops import _rt, _trace
    from differt_tpu_torch.parallel import streamed_placement_loss, streamed_placement_step

    # Receivers in the street: over the bounding box two thirds of them sit
    # inside the buildings, at the floor of -300 dB, and a pixel that crosses
    # the floor as the TX moves is a jump no gradient sees.
    y, x = torch.meshgrid(
        torch.linspace(-8.0, 8.5, 8, device=device),
        torch.linspace(-45.0, 44.0, 24, device=device),
        indexing="ij",
    )
    scene = Scene(
        transmitters=torch.tensor([[-30.0, 1.7, 20.0]], device=device),
        receivers=torch.stack((x, y, torch.full_like(x, 1.45)), dim=-1),
        mesh=scenes.street_canyon_scene(device=device).mesh,
    )
    tx0 = scene.transmitters
    kw = {
        "eta_r": torch.tensor([5.24], device=device),
        "conductivity": torch.tensor([0.1], device=device),
        "path_candidates": generate_path_candidates(scene.mesh.num_triangles, 1, device=device),
        "candidate_chunk": 16,
        "rx_chunk": 64,
        "smoothing_factor": SMOOTHING,
    }
    launches = (_trace.LAUNCHES, _rt.LAUNCHES)
    new_tx, _, loss = streamed_placement_step(
        scene, FREQUENCY, None, tx=tx0, tx_learning_rate=1.0, eta_learning_rate=1.0, **kw
    )
    if (_trace.LAUNCHES, _rt.LAUNCHES) != launches:
        msg = "the smoothed step launched a hard-mask kernel"
        raise AssertionError(msg)
    g = tx0 - new_tx
    g_norm = float(g.norm())
    if not (torch.isfinite(loss) and torch.isfinite(g).all() and g_norm > 0.0):
        msg = f"the smoothed step's loss {float(loss)} or gradient {g.tolist()} is unusable"
        raise AssertionError(msg)
    u = g / g_norm
    h = 5e-4

    def loss_at(tx) -> float:
        db = streamed_placement_loss(scene, FREQUENCY, None, tx=tx, return_db_map=True, **kw)
        return -float(db.double().cpu().mean())

    fd = (loss_at(tx0 + h * u) - loss_at(tx0 - h * u)) / (2.0 * h)
    rel = abs(fd - g_norm) / g_norm
    if not rel <= 0.05:
        msg = f"the smoothed finite difference {fd} is off the streamed gradient {g_norm}"
        raise AssertionError(msg)
    print(
        f"phase 13 smoothed step, canyon, order 1, smoothing_factor={SMOOTHING:.0f},"
        f" {scene.num_receivers} rx: loss={float(loss):.6g} streamed_gradient_norm={g_norm:.6g}"
        f" central_difference={fd:.6g} (h={h} m) rel_err={rel:.3e} (gate 5%)",
        flush=True,
    )


# -- The hybrid tracer and antenna patterns -----------------------------------


def counters() -> dict:
    """Each count's ``(module, attribute)``: every kernel's launches and plain calls, BVH builds, DFS calls."""
    from differt_tpu_torch import native
    from differt_tpu_torch.ops import _bvh, _closest, _em, _rt, _trace

    return {
        "em": (_em, "LAUNCHES"),
        "closest": (_closest, "LAUNCHES"),
        "closest_plain": (_closest, "REFERENCE_CALLS"),
        "trace": (_trace, "LAUNCHES"),
        "trace_plain": (_trace, "REFERENCE_CALLS"),
        "anyhit": (_rt, "LAUNCHES"),
        "anyhit_plain": (_rt, "REFERENCE_CALLS"),
        "bvh_builds": (_bvh, "BUILDS"),
        "dfs": (native, "CALLS"),
        "dfs_fallback": (native, "FALLBACK_CALLS"),
    }


def counted_call(label: str, fn, want: dict):
    """Run ``fn()`` once, timed (wall and CUDA events), with every count of
    :func:`counters` set to 0 just before; the counts after must equal ``want``.

    Returns ``(out, wall_s, card_ms, counts)``; ``want`` lists every count
    that the call may raise (the others must stay 0).
    """
    torch.cuda.synchronize()
    named = counters()
    for module, attr in named.values():
        setattr(module, attr, 0)
    begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start = time.perf_counter()
    begin.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = {k: getattr(module, attr) for k, (module, attr) in named.items()}
    expected = {k: want.get(k, 0) for k in counts}
    if counts != expected:
        msg = f"the {label} run's counts are {counts}, expected {expected}"
        raise AssertionError(msg)
    return out, wall, begin.elapsed_time(end), counts


def once_ms(fn) -> float:
    """Device time of one call of ``fn()`` in ms (CUDA events), with no warm-up: for the slow plain versions."""
    torch.cuda.synchronize()
    begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    begin.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return begin.elapsed_time(end)


def visibility_launches(num_vertices: int) -> int:
    from differt_tpu_torch.ops._dispatch import visibility_groups

    return len(visibility_groups(num_vertices, VIS_RAYS))


def run_visibility(city, kernels: dict) -> dict:
    """Phase 14: ``Mesh.triangles_visible_from_vertex`` from the TX and the
    128 receivers, 1,000,000 lattice rays each, through ``closest.cu``'s
    launch that makes its rays and marks their hits (counted); for the TX and
    8 receivers, the same rays in index order (``_dispatch.visibility_rays``)
    through the ray launch: every ray's hit against the plain closest hit
    (``t`` bit-equal, a differing index the tie key's winner), and their
    marks equal to the path's."""
    from differt_tpu_torch.ops import _closest, _dispatch
    from differt_tpu_torch.rt._scan import mark_visible, visibility_frustums

    mesh = city.mesh
    tx = city.transmitters.reshape(-1, 3)
    rx = city.receivers.reshape(-1, 3)
    num_tris = mesh.num_triangles
    launches = visibility_launches(1) + visibility_launches(rx.shape[0])
    fresh(city).mesh.triangles_visible_from_vertex(tx, num_rays=VIS_RAYS)  # warm-up
    run_mesh = fresh(city).mesh

    def both():
        return (
            run_mesh.triangles_visible_from_vertex(tx, num_rays=VIS_RAYS)[0],
            run_mesh.triangles_visible_from_vertex(rx, num_rays=VIS_RAYS),
        )

    lattice = _closest.LATTICE_LAUNCHES
    (vis_tx, vis_rx), wall, card_ms, counts = counted_call(
        "visibility", both, {"closest": launches, "bvh_builds": 1}
    )
    if _closest.LATTICE_LAUNCHES - lattice != launches:
        msg = f"visibility: {_closest.LATTICE_LAUNCHES - lattice} of {launches} launches made their own rays"
        raise AssertionError(msg)
    kernels["closest"]["launches"] += counts["closest"]
    kernels["closest"]["launches_by_path"]["visibility"] = counts["closest"]

    # The TX and 8 receivers: the same rays through the kernel and its plain version.
    tv = mesh.triangle_vertices.contiguous()
    bvh = run_mesh.bvh
    picks = list(range(0, rx.shape[0], rx.shape[0] // VIS_CHECKED_RX))[:VIS_CHECKED_RX]
    checked = [("TX", tx[0], vis_tx)] + [(f"RX {j}", rx[j], vis_rx[j]) for j in picks]
    compared = tie_rays = marks_differ = 0
    timing = {}
    for label, vertex, row in checked:
        o = vertex.expand(VIS_RAYS, 3).contiguous()
        d = _dispatch.visibility_rays(mesh, vertex[None], VIS_RAYS)[0].contiguous()
        idx, t = _closest.first_triangle_hit_by_ray_cuda(o, d, None, bvh=bvh)
        plain = {}
        plain_ms = once_ms(
            lambda: plain.update(
                zip(("idx", "t"), _closest.first_triangle_hit_by_ray_reference(o, d, tv, mesh.mask))
            )
        )
        if not torch.equal(t, plain["t"]):
            msg = f"visibility: closest-hit t differs from its plain version ({label})"
            raise AssertionError(msg)
        differ = idx != plain["idx"]
        winner = _closest.tie_key_winner(
            o[differ], d[differ], tv, mesh.mask, plain["t"][differ], bvh.positions
        )
        if not torch.equal(idx[differ], winner):
            msg = f"visibility: {int((idx[differ] != winner).sum())} indices are not the tie key's winners ({label})"
            raise AssertionError(msg)
        marks = torch.zeros(num_tris + 1, dtype=torch.bool, device=o.device)
        mark_visible(marks, idx)
        if not torch.equal(marks[:-1], row):
            msg = f"visibility: the path's marks are not its kernel's hits ({label})"
            raise AssertionError(msg)
        plain_marks = torch.zeros_like(marks)
        mark_visible(plain_marks, plain["idx"])
        compared += VIS_RAYS
        tie_rays += int(differ.sum())
        marks_differ += int((marks != plain_marks).sum())
        if label == "TX":
            pos = torch.empty(VIS_RAYS, dtype=torch.int32, device=o.device)
            t_out = torch.empty(VIS_RAYS, device=o.device)
            eps = TRACE_KW["epsilon"]
            bound_ms, bound_by = bound(VIS_RAYS * (24 + 8) + mesh_bytes(tv, None), VIS_RAYS * MT_FLOPS)
            timing = {
                "shape": "visibility from the TX: 1,000,000 lattice rays x 20,738 triangles",
                "kernel_only_ms": cuda_ms(lambda: _closest.launch_closest(o, d, bvh, eps, pos, t_out), 10),
                "ms": cuda_ms(lambda: _closest.first_triangle_hit_by_ray_cuda(o, d, None, bvh=bvh), 10),
                "lattice_ms": cuda_ms(lambda: run_mesh.triangles_visible_from_vertex(tx, num_rays=VIS_RAYS), 10),
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
            }
        del o, d, idx, t, plain
    kernels["closest"]["visibility"] = timing

    frustums = visibility_frustums(rx, mesh.triangle_vertices, mesh.mask)
    spans = torch.rad2deg(frustums[:, 1, 1:] - frustums[:, 0, 1:])  # [128, (polar, azimuth)]
    per_rx = [
        [round(float(az), 1), round(float(pol), 1), int(n)]
        for (pol, az), n in zip(spans.tolist(), vis_rx.sum(dim=-1).tolist())
    ]
    rx_counts = vis_rx.sum(dim=-1).float()
    print(
        f"phase 14 visibility: vertices=1 TX + {rx.shape[0]} RX, rays={VIS_RAYS} each"
        f" ({(1 + rx.shape[0]) * VIS_RAYS} in all), triangles={num_tris}"
        f" visible_tx={int(vis_tx.sum())} visible_rx_union={int(vis_rx.any(dim=0).sum())}"
        f" visible_per_rx min/median/max={int(rx_counts.min())}/{int(rx_counts.median())}/{int(rx_counts.max())}"
        f" wall_s={wall:.4f} card_ms={card_ms:.2f} counts={json.dumps(counts)};"
        f" TX + {len(picks)} RX checked: rays={compared} tie_rays={tie_rays}"
        f" ({100.0 * tie_rays / compared:.4f}%) t_bit_equal=True indices_tie_key_winners=True"
        f" marks_that_differ_from_the_plain_scan's={marks_differ};"
        f" closest at 1,000,000 rays: kernel_only_ms={timing['kernel_only_ms']:.3f}"
        f" wrapper_ms={timing['ms']:.3f} plain_ms={timing['plain_ms']:.1f}"
        f" visibility_from_the_TX_ms={timing['lattice_ms']:.3f} (rays made and marked in the launch)"
        f" bound_ms={timing['bound_ms']:.5f} ({timing['bound_by']})",
        flush=True,
    )
    print(
        f"phase 14 receivers' frustums [azimuth span deg, polar span deg, visible]: {json.dumps(per_rx)}",
        flush=True,
    )
    return {"tx": vis_tx, "rx": vis_rx}


def exhaustive_index(candidates: torch.Tensor, num_primitives: int) -> torch.Tensor:
    """Each loop-free candidate's row in the exhaustive decode (``generate_path_candidates``)."""
    index = candidates[:, 0].clone()
    for b in range(1, candidates.shape[1]):
        c, prev = candidates[:, b], candidates[:, b - 1]
        index = index * (num_primitives - 1) + c - (c > prev).long()
    return index


def run_hybrid(
    city, kernels: dict, exhaustive_order1: torch.Tensor, materials: dict, pairs: torch.Tensor
) -> dict:
    """Phase 15: ``HybridPathTracer(num_rays=1,000,000)`` candidates at orders 1
    and 2 (the native DFS, counted), then ``power_map_chunked(solver=...)``
    at each order, on the whole set, counted; at order 2, which of the
    valid paths among ``pairs`` (phase 3 (c)'s near pairs) the set holds."""
    from differt_tpu_torch import coverage, native
    from differt_tpu_torch.rt import HybridPathTracer, trace_path_candidates

    mesh = city.mesh
    num = mesh.num_primitives
    tx = city.transmitters.reshape(-1, 3)
    rx = city.receivers.reshape(-1, 3)
    tracer = HybridPathTracer(num_rays=VIS_RAYS)
    if not native.is_available():
        msg = "the native DFS did not build (no g++?)"
        raise AssertionError(msg)

    (vis_tx, vis_rx, mask), vis_s, _, _ = counted_call(
        "hybrid visibility", lambda: tracer._visibility(city),
        {"closest": visibility_launches(1) + visibility_launches(rx.shape[0])},
    )
    sets, dfs_s = {}, {}
    for order in (1, 2):
        cands, dfs_s[order], _, _ = counted_call(
            f"order-{order} DFS",
            lambda: native.filtered_path_candidates(num, order, vis_tx, vis_rx, mask, device=mesh.device),
            {"dfs": 1},
        )
        launches = visibility_launches(1) + visibility_launches(rx.shape[0])
        (gen, _), gen_s, _, _ = counted_call(
            f"order-{order} hybrid candidates",
            lambda: tracer.generate_path_candidates(city, order),
            {"closest": launches, "dfs": 1},
        )
        if not torch.equal(gen, cands):
            msg = f"the tracer's order-{order} candidates are not the DFS's"
            raise AssertionError(msg)
        # A subset of the exhaustive candidates: loop-free, in range, each
        # once and in the exhaustive order, first seen by the TX, last by an RX.
        index = exhaustive_index(cands, num)
        ok = (
            bool((cands >= 0).all() and (cands < num).all())
            and bool((cands[:, 1:] != cands[:, :-1]).all())
            and bool((index[1:] > index[:-1]).all())
            and bool(vis_tx[cands[:, 0]].all() and vis_rx[cands[:, -1]].all())
        )
        if not ok:
            msg = f"the order-{order} hybrid candidates are not a subset of the exhaustive ones"
            raise AssertionError(msg)
        total = num * (num - 1) ** (order - 1)
        sets[order] = cands
        print(
            f"phase 15 hybrid order {order}: candidates={cands.shape[0]} of {total} exhaustive"
            f" ({100.0 * cands.shape[0] / total:.4f}%) dfs_host_ms={dfs_s[order] * 1e3:.2f}"
            f" generate_path_candidates_s={gen_s:.4f} (visibility and DFS) subset_of_exhaustive=True",
            flush=True,
        )

    def hybrid_map(scene, order, **kw):
        return coverage.power_map_chunked(
            scene, FREQUENCY, order=order, solver=tracer, candidate_chunk=4096, rx_chunk=128,
            **materials, **kw,
        )

    hybrid_map(city, 1)  # warm-up
    c1 = sets[1]
    vis_launches = visibility_launches(1) + visibility_launches(rx.shape[0])
    chunks1 = -(-c1.shape[0] // 4096)
    power1, wall1, card1, counts1 = counted_call(
        "hybrid order-1 map", lambda: hybrid_map(fresh(city), 1),
        {"closest": vis_launches, "trace": chunks1, "em": chunks1, "bvh_builds": 1, "dfs": 1},
    )
    # Recall and the subset rule on traced paths: every valid hybrid path is
    # a valid exhaustive path (order 1: the candidate is the triangle).
    every = trace_path_candidates(mesh, tx, rx, torch.arange(num, device=mesh.device)[:, None]).mask
    hybrid = trace_path_candidates(mesh, tx, rx, c1).mask
    if (hybrid & ~every[..., c1[:, 0]]).any():
        msg = "a valid hybrid order-1 path is not a valid exhaustive path"
        raise AssertionError(msg)
    recall = int(hybrid.sum()) / max(int(every.sum()), 1)
    # The map within 0.1 dB of the exhaustive one where every valid path survived.
    kept = torch.zeros(num, dtype=torch.bool, device=mesh.device)
    kept[c1[:, 0]] = True
    whole = ~(every & ~kept).any(dim=-1).reshape(exhaustive_order1.shape)
    lit = whole & (exhaustive_order1 > 0)
    if not lit.any():
        msg = "no lit pixel kept all its order-1 paths"
        raise AssertionError(msg)
    err_db = float((10.0 * torch.log10(power1[lit].double() / exhaustive_order1[lit].double())).abs().max())
    if not err_db <= 0.1:
        msg = f"the hybrid order-1 map is {err_db} dB off the exhaustive one where all paths survived"
        raise AssertionError(msg)

    # Order 2, the whole hybrid set.
    c2 = sets[2]
    full2 = c2.shape[0]
    power2, wall2, card2, counts2 = counted_call(
        "hybrid order-2 map", lambda: hybrid_map(fresh(city), 2),
        {"closest": vis_launches, "trace": -(-full2 // 4096), "em": -(-full2 // 4096), "bvh_builds": 1, "dfs": 1},
    )
    lit2 = int((power2 > 0).sum())
    if not (torch.isfinite(power2).all() and lit2 > 0):
        msg = f"the hybrid order-2 map is not finite or all zero (lit {lit2})"
        raise AssertionError(msg)
    # The valid order-2 paths among phase 3 (c)'s near pairs: those the
    # hybrid set holds (its rows are in the exhaustive order), and the
    # 4,096-row chunk of the set that holds the first of them, for (g).
    near_valid = pairs[trace_path_candidates(mesh, tx, rx, pairs).mask.reshape(-1, pairs.shape[0]).any(dim=0)]
    index2 = exhaustive_index(c2, num)
    near_index = exhaustive_index(near_valid, num)
    rows = torch.searchsorted(index2, near_index).clamp(max=full2 - 1)
    held = index2[rows] == near_index
    if not held.any():
        msg = f"the hybrid order-2 set holds none of the {near_valid.shape[0]} valid near-pair paths"
        raise AssertionError(msg)
    lo = int(rows[held].min()) // 4096 * 4096
    chunk2 = c2[lo : lo + 4096]
    trace_launches = counts1["trace"] + counts2["trace"]
    kernels["trace"]["launches"] += trace_launches
    kernels["trace"]["launches_by_path"]["hybrid"] = trace_launches
    kernels["closest"]["launches"] += counts1["closest"] + counts2["closest"]
    kernels["closest"]["launches_by_path"]["hybrid"] = counts1["closest"] + counts2["closest"]
    note_em(kernels, "hybrid", counts1["em"] + counts2["em"])
    print(
        f"phase 15 hybrid order-1 map: candidates={c1.shape[0]} rx={rx.shape[0]}"
        f" wall_s={wall1:.4f} card_ms={card1:.2f} paths_per_s={c1.shape[0] * rx.shape[0] / wall1:.4g}"
        f" wall split: visibility_s={vis_s:.4f} dfs_s={dfs_s[1]:.4f}"
        f" trace_and_em_s={wall1 - vis_s - dfs_s[1]:.4f} (the call less the visibility and the DFS timed apart)"
        f" counts={json.dumps(counts1)} valid_hybrid={int(hybrid.sum())} valid_exhaustive={int(every.sum())}"
        f" recall={recall:.4f} pixels_with_all_paths_kept={int(lit.sum())} of {int((exhaustive_order1 > 0).sum())} lit"
        f" max_err_db={err_db:.4g} (gate 0.1)",
        flush=True,
    )
    print(
        f"phase 15 hybrid order-2 map: candidates={full2} rx={rx.shape[0]}"
        f" wall_s={wall2:.4f} card_ms={card2:.2f} paths_per_s={full2 * rx.shape[0] / wall2:.4g}"
        f" lit={lit2} counts={json.dumps(counts2)}; valid near-pair paths held by the hybrid set:"
        f" {int(held.sum())} of {near_valid.shape[0]}; chunk (g) = rows {lo}-{lo + chunk2.shape[0] - 1}",
        flush=True,
    )
    return {"tracer": tracer, "map": hybrid_map, "chunk2": chunk2}


def run_patterns(city, kernels: dict, runs, coverage_run, iso: dict) -> dict:
    """Phase 16: phase 4's call (orders 0-2) with a half-wave dipole at the
    TX, counted, against the same call on the plain versions; the order-0
    ratio to the isotropic map against the pattern's gain; a short dipole at
    order 0."""
    from differt_tpu_torch import ops
    from differt_tpu_torch.em import HWDipolePattern, ShortDipolePattern

    tx = city.transmitters.reshape(-1, 3)[0]
    hw = HWDipolePattern(FREQUENCY, direction=(0.0, 0.0, 1.0), center=tx)
    short = ShortDipolePattern(FREQUENCY, direction=(0.0, 0.0, 1.0), center=tx)
    for order, candidates, _ in runs:  # warm-up
        coverage_run(city, order, None if candidates is None else candidates[:4096], tx_pattern=hw)
    maps, walls, launches = {}, {}, {"anyhit": 0, "trace": 0}
    for order, candidates, num_candidates in runs:
        want = {"anyhit": 1} if order == 0 else {"trace": -(-num_candidates // 4096)}
        maps[order], walls[order], _, counts = counted_call(
            f"order-{order} dipole map",
            lambda: coverage_run(fresh(city), order, candidates, tx_pattern=hw),
            {**want, "bvh_builds": 1},
        )
        for k in launches:
            launches[k] += counts[k]
    ops.set_backend("torch")
    try:
        errors = {}
        plain_s = {}
        for order, candidates, _ in runs:
            start = time.perf_counter()
            plain = coverage_run(city, order, candidates, tx_pattern=hw)
            torch.cuda.synchronize()
            plain_s[order] = time.perf_counter() - start
            both_zero = not (maps[order].any() or plain.any())
            errors[order] = 0.0 if both_zero else db_error(maps[order], plain)
    finally:
        ops.set_backend("auto")
    if not all(err <= 0.1 for err in errors.values()):
        msg = f"the dipole maps differ from the plain run by {errors} dB"
        raise AssertionError(msg)
    # Order 0: the ratio to the isotropic map is the pattern's gain toward each receiver.
    k = (city.receivers.reshape(-1, 3) - tx).double()
    cos_t = (k[:, 2] / k.norm(dim=-1)).reshape(iso[0].shape)
    sin_sq = 1.0 - cos_t * cos_t
    short_map, _, _, short_counts = counted_call(
        "order-0 short-dipole map", lambda: coverage_run(fresh(city), 0, None, tx_pattern=short),
        {"anyhit": 1, "bvh_builds": 1},
    )
    launches["anyhit"] += short_counts["anyhit"]
    # Straight below the TX (sin theta = 0) a dipole along z sends nothing.
    axial = sin_sq < 1e-12
    if maps[0][axial].any() or short_map[axial].any():
        msg = "a dipole along z lights the receiver on its axis"
        raise AssertionError(msg)
    lit = (iso[0] > 0) & ~axial
    ratio_err = {}
    for label, power, gain in (
        ("hw", maps[0], HW_DIPOLE_GAIN * torch.cos(0.5 * np.pi * cos_t) ** 2 / sin_sq),
        ("short", short_map, 1.5 * sin_sq),
    ):
        ratio = power[lit].double() / iso[0][lit].double()
        ratio_err[label] = float(((ratio - gain[lit]) / gain[lit]).abs().max())
    if not lit.any() or not all(err <= 1e-3 for err in ratio_err.values()):
        msg = f"the order-0 dipole maps are off the patterns' gains: {ratio_err} (lit {int(lit.sum())})"
        raise AssertionError(msg)
    for k_name in launches:
        kernels[k_name]["launches"] += launches[k_name]
    kernels["trace"]["launches_by_path"]["coverage_hw_dipole"] = launches["trace"]
    rates = {
        order: num_candidates * city.num_receivers / walls[order] for order, _, num_candidates in runs
    }
    print(
        f"phase 16 antenna patterns, HW dipole along z at the TX, orders 0-2 (phase 4's call):"
        f" wall_s={json.dumps({o: round(w, 4) for o, w in walls.items()})}"
        f" paths_per_s={json.dumps({o: float(f'{r:.4g}') for o, r in rates.items()})}"
        f" lit={json.dumps({o: int((m > 0).sum()) for o, m in maps.items()})}"
        f" launches={json.dumps(launches)} (plain 0, one BVH build a call)"
        f" max_err_db_vs_plain_run={json.dumps(errors)} (gate 0.1) plain_run_s={json.dumps({o: round(s, 2) for o, s in plain_s.items()})}"
        f" order-0 gain ratio max_rel_err: hw={ratio_err['hw']:.3g} short={ratio_err['short']:.3g}"
        f" (gate 1e-3) over {int(lit.sum())} lit receivers off the axis ({int(axial.sum())} on it, dark)",
        flush=True,
    )
    return {"hw": hw}


# -- First-order diffraction --------------------------------------------------


def non_manifold_edges(mesh) -> int:
    """Vertex pairs that more than two of the mesh's faces share, counted apart from the port's warning."""
    tri = mesh.triangles
    pairs = torch.stack((tri[:, [0, 1]], tri[:, [1, 2]], tri[:, [2, 0]]), dim=1).reshape(-1, 2)
    _, counts = torch.unique(torch.sort(pairs, dim=-1).values, dim=0, return_counts=True)
    return int((counts > 2).sum())


def diffraction_segments(tx: torch.Tensor, rx: torch.Tensor, edges: torch.Tensor):
    """The any-hit kernel's inputs of the diffraction blockage call, made by the path's own helpers."""
    from differt_tpu_torch.ops._dispatch import anyhit_segments
    from differt_tpu_torch.rt._diffraction import keller_paths

    paths, _ = keller_paths(tx, rx, edges)
    return anyhit_segments(paths[..., :-1, :], paths[..., 1:, :] - paths[..., :-1, :])


def canyon_fd_check(device, materials: dict) -> tuple[float, float, float]:
    """The diffraction map's TX gradient on the street canyon against a central
    difference along it: ``(directional derivative, difference, relative gap)``."""
    from differt_tpu_torch import coverage, scenes
    from differt_tpu_torch.geometry import Scene

    rx = torch.tensor([[x, y, 1.5] for x in (-20.0, 0.0, 20.0, 35.0) for y in (-3.0, 3.0)], device=device)
    canyon = Scene(
        transmitters=torch.tensor([[-30.0, 0.0, 20.0]], device=device),
        receivers=rx,
        mesh=scenes.street_canyon_scene(device=device).mesh,
    )

    def total(tx):
        scene = dataclasses.replace(canyon, transmitters=tx)
        return coverage.power_map(scene, FREQUENCY, order=1, with_diffraction=True, **materials).double().sum()

    tx = canyon.transmitters.clone().requires_grad_()
    (grad,) = torch.autograd.grad(total(tx), tx)
    direction = grad / grad.norm()
    with torch.no_grad():
        fd = float((total(tx + FD_STEP * direction) - total(tx - FD_STEP * direction)) / (2.0 * FD_STEP))
    slope = float((grad * direction).sum())
    return slope, fd, abs(slope - fd) / abs(fd)


def run_diffraction(city, kernels: dict, materials: dict) -> None:
    """Phase 17: ``power_map(order=1, with_diffraction=True)`` on a fresh
    copy of the coverage scene (20,738 triangles, 128 street receivers),
    counted: ``trace.cu`` for the specular half, one ``anyhit.cu`` launch
    for the blockage of every diffraction segment, one BVH build (the
    deduplicated mesh takes the scene mesh's). Then its parts timed apart,
    its TX gradient, the canyon's central difference, the edges against a
    CPU extraction, the kernel against its plain version on 8 receivers'
    segments and maps, the Fresnel integrals against SciPy, and
    ``anyhit.cu`` timed at the path's shape."""
    import warnings

    from scipy import special

    from differt_tpu_torch import coverage, ops
    from differt_tpu_torch.em import fresnel, z_0
    from differt_tpu_torch.ops import _rt
    from differt_tpu_torch.rt._diffraction import _trace_diffraction, diffraction_amplitudes

    device = city.mesh.device
    num_rx = city.num_receivers
    tx = city.transmitters.reshape(-1, 3)
    rx = city.receivers.reshape(-1, 3)

    def diffraction_map(scene):
        return coverage.power_map(scene, FREQUENCY, order=1, with_diffraction=True, **materials)

    diffraction_map(fresh(city))  # warm-up: the first CUDA call of each complex op compiles it
    want = {"anyhit": 1, "trace": 1, "bvh_builds": 1}
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        power, wall, card_ms, counts = counted_call("diffraction map", lambda: diffraction_map(fresh(city)), want)
    peak = torch.cuda.max_memory_allocated() - base
    if not torch.isfinite(power).all():
        msg = "the diffraction map is not finite"
        raise AssertionError(msg)

    # The same map in its parts, timed apart (CUDA events), and recomposed.
    scene = fresh(city)
    frequency = torch.tensor(FREQUENCY, device=device)
    eta_r, conductivity, thickness = coverage.resolve_materials(
        scene, frequency, materials["eta_r"], materials["conductivity"], None
    )
    events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    events[0].record()
    paths = scene.trace_paths(order=1)
    a_spec = coverage.complex_amplitudes(
        paths.reshape(1, num_rx, -1), scene, frequency, eta_r=eta_r, conductivity=conductivity, thickness=thickness
    )
    events[1].record()
    mesh = scene.mesh.dedup_vertices()
    edges, adjacent, wedge_n = mesh._diffraction_edges_info()
    events[2].record()
    diff_paths = _trace_diffraction(mesh, tx, rx, edges, hit_tol=None, min_len=None)
    events[3].record()
    a_diff = diffraction_amplitudes(
        diff_paths.reshape(1, num_rx, -1), scene, frequency, edges=edges, adjacent_triangles=adjacent, wedge_n=wedge_n
    )
    events[4].record()
    torch.cuda.synchronize()
    split = {
        name: events[i].elapsed_time(events[i + 1])
        for i, name in enumerate(("specular_half", "edge_extraction", "keller_points_and_blockage", "utd_amplitudes"))
    }
    recomposed = (torch.abs(a_spec.sum(-1) + a_diff.sum(-1)) ** 2 / z_0).reshape(power.shape)
    recomposed_err = db_error(recomposed, power)
    num_edges = edges.shape[0]
    valid = int(diff_paths.mask.sum())
    non_manifold = non_manifold_edges(mesh)
    warned = [str(w.message) for w in caught if "non-manifold" in str(w.message)]
    spec_power = float((torch.abs(a_spec) ** 2).sum())
    diff_power = float((torch.abs(a_diff) ** 2).sum())
    specular_map = (torch.abs(a_spec.sum(-1)) ** 2 / z_0).reshape(power.shape)
    lit, lit_specular = int((power > 0).sum()), int((specular_map > 0).sum())
    if not valid or not recomposed_err <= 1e-4:
        msg = f"the diffraction map has {valid} valid diffraction paths; its parts recompose it within {recomposed_err} dB"
        raise AssertionError(msg)
    if bool(non_manifold) != bool(warned):
        msg = f"{non_manifold} non-manifold edges, but the port warned {warned}"
        raise AssertionError(msg)

    # The edges on the card against the same extraction on the CPU.
    cpu_mesh = dataclasses.replace(city.mesh, vertices=city.mesh.vertices.cpu(), triangles=city.mesh.triangles.cpu())
    cpu_edges, cpu_adjacent, cpu_wedge = cpu_mesh.dedup_vertices()._diffraction_edges_info()
    if not (
        torch.equal(cpu_edges, edges.cpu())
        and torch.equal(cpu_adjacent, adjacent.cpu())
        and float((cpu_wedge - wedge_n.cpu()).abs().max()) <= 1e-6
    ):
        msg = "the edges extracted on the card differ from those extracted on the CPU"
        raise AssertionError(msg)

    # The TX gradient at full width, then the canyon's central difference.
    tx_grad = city.transmitters.clone().requires_grad_()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()

    def gradient():
        scene = dataclasses.replace(fresh(city), transmitters=tx_grad)
        return torch.autograd.grad(diffraction_map(scene).sum(), tx_grad)[0]

    grad, grad_wall, _, _ = counted_call("diffraction map gradient", gradient, want)
    grad_peak = torch.cuda.max_memory_allocated() - base
    if not (torch.isfinite(grad).all() and grad.abs().max() > 0):
        msg = f"the diffraction map's TX gradient is {grad.tolist()}"
        raise AssertionError(msg)
    slope, fd, fd_gap = canyon_fd_check(device, materials)
    if not fd_gap <= 0.02:
        msg = f"the canyon's TX gradient along itself is {slope}, its central difference {fd} ({fd_gap:.3%} apart)"
        raise AssertionError(msg)

    # The kernel against its plain version on 8 receivers' diffraction
    # segments, bit for bit, and their maps within 0.01 dB.
    rx8 = rx[:: num_rx // DIFF_CHECKED_RX]
    bvh = mesh.bvh
    tv = mesh.triangle_vertices.contiguous()
    o8, d8, th8 = diffraction_segments(tx, rx8, edges)
    got = _rt.ray_intersect_any_triangle_cuda(o8, d8, None, hit_threshold=th8, bvh=bvh)
    want8 = _rt.ray_intersect_any_triangle_reference(o8, d8, tv, None, hit_threshold=th8)
    if mismatches := int((got != want8).sum()):
        msg = f"the any-hit kernel disagrees with its plain version on {mismatches} diffraction segments"
        raise AssertionError(msg)
    plain_ms = once_ms(lambda: _rt.ray_intersect_any_triangle_reference(o8, d8, tv, None, hit_threshold=th8))
    scene8 = dataclasses.replace(city, receivers=rx8)
    kernel_map = diffraction_map(fresh(scene8))
    ops.set_backend("torch")
    try:
        plain_map = diffraction_map(fresh(scene8))
    finally:
        ops.set_backend("auto")
    map_err = db_error(kernel_map, plain_map)
    if not map_err <= 0.01:
        msg = f"the 8 receivers' diffraction map differs from the plain run by {map_err} dB"
        raise AssertionError(msg)

    # The Fresnel integrals on the card against SciPy's, and their gradient.
    x = torch.linspace(-10.0, 10.0, 1_000_000, device=device, requires_grad=True)
    s, c = fresnel(x)
    s_ref, c_ref = special.fresnel(x.detach().double().cpu().numpy())
    fresnel_err = max(
        float(np.abs(s.detach().cpu().numpy() - s_ref).max()), float(np.abs(c.detach().cpu().numpy() - c_ref).max())
    )
    (g_s,) = torch.autograd.grad(s.sum(), x, retain_graph=True)
    (g_c,) = torch.autograd.grad(c.sum(), x)
    arg = 0.5 * np.pi * x.detach().double().cpu().numpy() ** 2
    fresnel_grad_err = max(
        float(np.abs(g_s.cpu().numpy() - np.sin(arg)).max()), float(np.abs(g_c.cpu().numpy() - np.cos(arg)).max())
    )
    if not (fresnel_err <= 1e-6 and fresnel_grad_err <= 1e-5):
        msg = f"the Fresnel integrals are {fresnel_err} off SciPy's, their gradient {fresnel_grad_err} off the integrands"
        raise AssertionError(msg)

    # anyhit.cu at the path's shape: all 128 receivers' segments.
    o, d, th = diffraction_segments(tx, rx, edges)
    num = o.shape[0]
    out = torch.empty(num, dtype=torch.bool, device=device)
    eps = TRACE_KW["epsilon"]
    kernel_ms = cuda_ms(lambda: _rt.launch_anyhit(o, d, th, bvh, eps, out), 5)
    ms = cuda_ms(lambda: _rt.ray_intersect_any_triangle_cuda(o, d, None, hit_threshold=th, bvh=bvh), 5)
    blocked = int(out.sum())
    live = int((th >= 0).sum())
    bound_ms, bound_by = anyhit_bound(th, tv)
    on_path = profile(
        "diffraction map (order 1 + diffraction)",
        lambda: diffraction_map(city),
        ("compact_kernel", "anyhit_kernel", "trace_kernel"),
    )
    on_path_ms = on_path.get("anyhit_kernel", (0, float("nan")))[1]

    kernels["anyhit"]["launches_by_path"] = {
        "coverage_and_patterns": kernels["anyhit"]["launches"],
        "diffraction_map": counts["anyhit"],
    }
    kernels["anyhit"]["launches"] += counts["anyhit"]
    kernels["trace"]["launches"] += counts["trace"]
    kernels["trace"]["launches_by_path"]["diffraction_map"] = counts["trace"]
    kernels["anyhit"]["diffraction"] = {
        "shape": f"diffraction blockage: {num} segments x {tv.shape[0]} triangles",
        "launches": counts["anyhit"],
        "max_abs_err": 0.0,
        "kernel_only_ms": kernel_ms,
        "ms": ms,
        "on_path_ms": on_path_ms,
        "plain_ms": plain_ms,
        "plain_shape": f"{o8.shape[0]} segments (8 receivers)",
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # No single PyTorch call computes an any-hit test.
    }
    print(
        f"phase 17 diffraction map: order 1 + diffraction, tx=1 rx={num_rx} triangles={city.mesh.num_triangles}"
        f" edges={num_edges} non_manifold_edges={non_manifold} (warned: {bool(warned)})"
        f" diffraction_paths={diff_paths.mask.numel()} valid={valid} segments={num}"
        f" wall_s={wall:.4f} card_ms={card_ms:.2f} diffraction_paths_per_s={diff_paths.mask.numel() / wall:.4g}"
        f" peak_gib={peak / 2**30:.3f} split_ms={json.dumps({k: round(v, 3) for k, v in split.items()})}"
        f" recomposed_err_db={recomposed_err:.3g} counts={json.dumps(counts)}"
        f" lit={lit} (order 1 alone: {lit_specular}) diffraction_power_share={diff_power / (spec_power + diff_power):.4g}"
        f" coherent_total_over_specular={float(power.double().sum() / specular_map.double().sum()):.4g}",
        flush=True,
    )
    print(
        f"phase 17 gradient: d(total power)/d(TX) at full width wall_s={grad_wall:.4f}"
        f" peak_gib={grad_peak / 2**30:.3f} grad={grad.tolist()};"
        f" canyon along the gradient: autograd {slope:.6g} central difference (h={FD_STEP} m) {fd:.6g}"
        f" gap {fd_gap:.3%} (gate 2%)",
        flush=True,
    )
    print(
        f"phase 17 checks: edges on the card = on the CPU; anyhit.cu vs plain on {o8.shape[0]} segments"
        f" (8 receivers): mismatches=0 blocked={int(got.sum())}; 8-receiver map vs plain run"
        f" max_err_db={map_err:.3g} (gate 0.01); fresnel on 1,000,000 points of [-10, 10]:"
        f" max_abs_err={fresnel_err:.3g} (gate 1e-6) grad_err={fresnel_grad_err:.3g} (gate 1e-5)",
        flush=True,
    )
    print(
        f"phase 17 anyhit at the path's shape: rays={num} live={live} blocked={blocked}"
        f" triangles={tv.shape[0]} kernel_only_ms={kernel_ms:.4f} wrapper_ms={ms:.4f}"
        f" on_path_ms={on_path_ms:.4f} plain_ms={plain_ms:.3f} (on {o8.shape[0]} segments)"
        f" bound_ms={bound_ms:.5f} ({bound_by})",
        flush=True,
    )


# -- Mixed chains and diffuse scattering -----------------------------------------


def knife_edge_scene(device):
    """``examples/propagation_mechanisms.py``'s knife edge: a ground plane and a 2 x 6 x 3 m box, concrete, the RX above the roof's level."""
    from differt_tpu_torch.geometry import Mesh, Scene

    ground = Mesh.plane(torch.tensor([0.0, 0.0, 0.0]), normal=torch.tensor([0.0, 0.0, 1.0]), side_length=40.0, device=device)
    box = Mesh.box(2.0, 6.0, 3.0, with_top=True, device=device).translate(torch.tensor([0.0, 0.0, 1.5], device=device))
    mesh = (ground + box).dedup_vertices().set_materials("Concrete")
    return Scene(
        transmitters=torch.tensor([[-8.0, 0.0, 1.6]], device=device), receivers=torch.tensor([[8.0, 0.0, 5.0]], device=device), mesh=mesh
    )


def knife_fd_check(device, materials: dict) -> tuple[float, float, float]:
    """The knife edge's (R, D) map (dielectric faces) and its TX gradient against a
    central difference along it: ``(directional derivative, difference, relative gap)``."""
    from differt_tpu_torch.em import z_0
    from differt_tpu_torch.rt import MixedPathTracer, mixed_amplitudes

    knife = knife_edge_scene(device)
    info = dict(zip(("edges", "adjacent_triangles", "wedge_n"), knife.mesh._diffraction_edges_info()))

    def total(tx):
        scene = dataclasses.replace(knife, transmitters=tx)
        paths = MixedPathTracer().trace_paths(scene, (0, 1))
        a = mixed_amplitudes(paths, scene, FREQUENCY, **info, **materials)
        return (torch.abs(a.sum(-1)) ** 2 / z_0).double().sum()

    tx = knife.transmitters.clone().requires_grad_()
    (grad,) = torch.autograd.grad(total(tx), tx)
    direction = grad / grad.norm()
    with torch.no_grad():
        fd = float((total(tx + FD_STEP * direction) - total(tx - FD_STEP * direction)) / (2.0 * FD_STEP))
    slope = float((grad * direction).sum())
    return slope, fd, abs(slope - fd) / abs(fd)


def moved(tree, device):
    """``tree`` (tensors, dataclasses, lists, tuples, dicts) with every tensor on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(
            tree, **{f.name: moved(getattr(tree, f.name), device) for f in dataclasses.fields(tree) if f.init}
        )
    if isinstance(tree, (list, tuple)):
        return type(tree)(moved(x, device) for x in tree)
    if isinstance(tree, dict):
        return {k: moved(v, device) for k, v in tree.items()}
    return tree


def anyhit_row(label: str, o, d, th, mesh, counts: dict, plain: dict, on_path_ms: float) -> dict:
    """``anyhit.cu`` at a path's shape: alone, in its wrapper, against its bound; one row of the kernels line."""
    from differt_tpu_torch.ops import _rt

    bvh = mesh.bvh
    tv = mesh.triangle_vertices.contiguous()
    num = o.shape[0]
    out = torch.empty(num, dtype=torch.bool, device=o.device)
    kernel_ms = cuda_ms(lambda: _rt.launch_anyhit(o, d, th, bvh, TRACE_KW["epsilon"], out), 3)
    ms = cuda_ms(lambda: _rt.ray_intersect_any_triangle_cuda(o, d, None, hit_threshold=th, bvh=bvh), 3)
    live = int((th >= 0).sum())
    bound_ms, bound_by = anyhit_bound(th, tv)
    print(
        f"{label} anyhit at the path's shape: rays={num} live={live} blocked={int(out.sum())}"
        f" triangles={tv.shape[0]} kernel_only_ms={kernel_ms:.4f} wrapper_ms={ms:.4f}"
        f" on_path_ms={on_path_ms:.4f} plain_ms={plain['ms']:.3f} (on {plain['segments']} segments)"
        f" bound_ms={bound_ms:.5f} ({bound_by}) ns_per_segment={kernel_ms * 1e6 / num:.3f}",
        flush=True,
    )
    return {
        "shape": f"{num} segments x {tv.shape[0]} triangles",
        "launches": counts["anyhit"],
        "max_abs_err": 0.0,
        "kernel_only_ms": kernel_ms,
        "ms": ms,
        "on_path_ms": on_path_ms,
        "plain_ms": plain["ms"],
        "plain_shape": f"{plain['segments']} segments (8 receivers)",
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # No single PyTorch call computes an any-hit test.
    }


def check_anyhit_bits(label: str, paths, mesh) -> dict:
    """``anyhit.cu`` against its plain version, bit for bit, on ``paths``' segments (made by the dispatch's own helper)."""
    from differt_tpu_torch.ops import _rt
    from differt_tpu_torch.ops._dispatch import anyhit_segments

    v = paths.vertices
    o, d, th = anyhit_segments(v[..., :-1, :], v[..., 1:, :] - v[..., :-1, :])
    tv = mesh.triangle_vertices.contiguous()
    got = _rt.ray_intersect_any_triangle_cuda(o, d, None, hit_threshold=th, bvh=mesh.bvh)
    start = time.perf_counter()
    want = _rt.ray_intersect_any_triangle_reference(o, d, tv, None, hit_threshold=th)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - start) * 1e3
    if mismatches := int((got != want).sum()):
        msg = f"{label}: the any-hit kernel disagrees with its plain version on {mismatches} segments"
        raise AssertionError(msg)
    return {"ms": plain_ms, "segments": o.shape[0], "blocked": int(got.sum())}


def run_mixed(device, kernels: dict, materials: dict) -> None:
    """Phase 18: ``power_map(order=1, with_diffraction=True, mixed_signatures=[(R, D), (D, R)])``
    on ``urban_scene(4, 4)`` (578 triangles, 576 edges), the coverage TX and
    the 64 street crossings, counted: ``trace.cu`` for the specular half,
    ``anyhit.cu`` once for the diffraction half and once per signature (every
    segment of its 21 M Fermat paths in one launch), one BVH build. Then its
    parts timed apart, the 8 receivers' mixed paths on the card against the
    port's CPU run, the kernel against its plain version on their segments,
    their map against the plain run, the TX gradient on 16 receivers, and the
    knife edge's central difference."""
    from differt_tpu_torch import coverage, ops, scenes
    from differt_tpu_torch.em import z_0
    from differt_tpu_torch.geometry import Scene
    from differt_tpu_torch.ops._dispatch import anyhit_segments
    from differt_tpu_torch.rt._diffraction import _trace_diffraction, diffraction_amplitudes
    from differt_tpu_torch.rt._mixed import (
        _blocked_paths,
        _fermat_paths,
        _mixed_checks,
        _trace_mixed,
        generate_mixed_path_candidates,
        mixed_amplitudes,
    )

    mesh = scenes.urban_scene(4, 4, device=device).mesh
    if mesh.num_triangles != 578:
        msg = f"urban_scene(4, 4) has {mesh.num_triangles} triangles, expected 578"
        raise AssertionError(msg)
    rx = street_receivers(device, nx=8, ny=8).reshape(-1, 3)
    city = Scene(transmitters=torch.tensor([TX], device=device), receivers=rx, mesh=mesh)
    num_rx = rx.shape[0]
    tx = city.transmitters

    def mixed_map(scene):
        return coverage.power_map(
            scene, FREQUENCY, order=1, with_diffraction=True, mixed_signatures=MIXED_SIGNATURES, **materials
        )

    mixed_map(fresh(city))  # warm-up
    want = {"anyhit": 1 + len(MIXED_SIGNATURES), "trace": 1, "bvh_builds": 1}
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    power, wall, card_ms, counts = counted_call("mixed map", lambda: mixed_map(fresh(city)), want)
    peak = torch.cuda.max_memory_allocated() - base
    if not torch.isfinite(power).all():
        msg = "the mixed map is not finite"
        raise AssertionError(msg)

    # The same map in its parts, timed apart (CUDA events), and recomposed.
    scene = fresh(city)
    frequency = torch.tensor(FREQUENCY, device=device)
    eta_r, conductivity, thickness = coverage.resolve_materials(
        scene, frequency, materials["eta_r"], materials["conductivity"], None
    )
    marks = []

    def mark(name):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event))

    mark("start")
    paths = scene.trace_paths(order=1)
    a_spec = coverage.complex_amplitudes(
        paths.reshape(1, num_rx, -1), scene, frequency, eta_r=eta_r, conductivity=conductivity, thickness=thickness
    )
    mark("specular_half")
    dedup = scene.mesh.dedup_vertices()
    edges, adjacent, wedge_n = dedup._diffraction_edges_info()
    mark("edges")
    diff_paths = _trace_diffraction(dedup, tx, rx, edges, hit_tol=None, min_len=None)
    a_diff = diffraction_amplitudes(
        diff_paths.reshape(1, num_rx, -1), scene, frequency, edges=edges, adjacent_triangles=adjacent, wedge_n=wedge_n
    )
    mark("diffraction")
    total = a_spec.sum(-1) + a_diff.sum(-1)
    per_signature = {}
    for signature in MIXED_SIGNATURES:
        tag = "".join("RD"[t] for t in signature)
        slots = tuple(dedup.num_triangles if t == 0 else edges.shape[0] for t in signature)
        candidates = generate_mixed_path_candidates(slots, device=device)
        mark(f"{tag}_decode")
        full_paths = _fermat_paths(dedup, tx, rx, edges, candidates, signature, steps=20)
        mark(f"{tag}_fermat")
        mask = _mixed_checks(dedup, full_paths, edges, candidates, signature, epsilon=None, angle_tol=1e-2)
        mark(f"{tag}_checks")
        mixed_paths = _blocked_paths(dedup, full_paths, mask, candidates, signature, hit_tol=None, min_len=None)
        mark(f"{tag}_blockage")
        a_mixed = mixed_amplitudes(
            mixed_paths, scene, frequency, edges=edges, adjacent_triangles=adjacent, wedge_n=wedge_n,
            eta_r=eta_r, conductivity=conductivity, thickness=thickness, types=signature,
        )
        mark(f"{tag}_amplitudes")
        total = total + a_mixed.sum(-1)
        per_signature[tag] = {
            "candidates": candidates.shape[0],
            "fermat_solves": mixed_paths.mask.numel(),
            "valid": int(mixed_paths.mask.sum()),
            "power": float((torch.abs(a_mixed) ** 2).sum()),
        }
    torch.cuda.synchronize()
    split = {name: marks[i - 1][1].elapsed_time(event) for i, (name, event) in enumerate(marks) if i}
    recomposed_err = db_error((torch.abs(total) ** 2 / z_0).reshape(power.shape), power)
    fermat_ms = sum(v for k, v in split.items() if k.endswith("_fermat"))
    solves = sum(v["fermat_solves"] for v in per_signature.values())
    specular_map = (torch.abs(a_spec.sum(-1)) ** 2 / z_0).reshape(power.shape)
    lit, lit_specular = int((power > 0).sum()), int((specular_map > 0).sum())
    if not (recomposed_err <= 1e-4 and all(v["valid"] for v in per_signature.values())):
        msg = f"the mixed map's parts recompose it within {recomposed_err} dB; valid paths {per_signature}"
        raise AssertionError(msg)

    # 8 receivers: the card's mixed paths against the port's CPU run, on the
    # candidates valid for one of them and every 64th other one.
    rx8 = rx[:: num_rx // MIXED_CHECKED_RX]
    cpu_dedup = moved(city, "cpu").mesh.dedup_vertices()
    cpu_edges = cpu_dedup._diffraction_edges_info()[0]
    vs_cpu, plain_rows = {}, {}
    trace_kw = {"epsilon": None, "hit_tol": None, "min_len": None, "angle_tol": 1e-2, "steps": 20}
    for signature in MIXED_SIGNATURES:
        tag = "".join("RD"[t] for t in signature)
        slots = tuple(dedup.num_triangles if t == 0 else edges.shape[0] for t in signature)
        candidates = generate_mixed_path_candidates(slots, device=device)
        card8 = _trace_mixed(dedup, tx, rx8, edges, candidates, signature, **trace_kw)
        plain_rows[tag] = check_anyhit_bits(f"phase 18 {tag}", card8, dedup)
        pick = card8.mask.any(dim=1)[0] | (torch.arange(candidates.shape[0], device=device) % 64 == 0)
        subset = torch.nonzero(pick).squeeze(-1)
        cpu8 = _trace_mixed(cpu_dedup, tx.cpu(), rx8.cpu(), cpu_edges, candidates[subset].cpu(), signature, **trace_kw)
        card_mask, card_v = card8.mask[..., subset].cpu(), card8.vertices[..., subset, :, :].cpu()
        apart = (card_v - cpu8.vertices).abs().amax(dim=(-1, -2)) > 1e-4
        mismatch = card_mask != cpu8.mask
        both = card_mask & cpu8.mask
        lengths = [(v[..., 1:, :] - v[..., :-1, :]).double().norm(dim=-1).sum(-1)[both] for v in (card_v, cpu8.vertices)]
        length_gap = float((lengths[0] - lengths[1]).abs().max() / lengths[1].max()) if both.any() else 0.0
        vs_cpu[tag] = {
            "paths": cpu8.mask.numel(),
            "valid_card": int(card_mask.sum()),
            "valid_cpu": int(cpu8.mask.sum()),
            "mismatches": int(mismatch.sum()),
            "mismatches_where_points_agree": int((mismatch & ~apart).sum()),
            "points_apart": int(apart.sum()),
            "max_vertex_err_valid": float((card_v - cpu8.vertices).abs().amax(dim=(-1, -2))[both].max()) if both.any() else 0.0,
            "max_rel_length_gap_valid": length_gap,
        }
        if vs_cpu[tag]["mismatches_where_points_agree"] or not length_gap <= 1e-6:
            msg = f"phase 18 {tag}: the card's mixed paths differ from the CPU's: {vs_cpu[tag]}"
            raise AssertionError(msg)
    scene8 = dataclasses.replace(city, receivers=rx8)
    kernel_map = mixed_map(fresh(scene8))
    ops.set_backend("torch")
    try:
        plain_map = mixed_map(fresh(scene8))
    finally:
        ops.set_backend("auto")
    map_err = db_error(kernel_map, plain_map)
    if not map_err <= 0.01:
        msg = f"the 8 receivers' mixed map differs from the plain run by {map_err} dB"
        raise AssertionError(msg)

    # The TX gradient on 16 receivers, then the knife edge's central difference.
    scene16 = dataclasses.replace(city, receivers=rx[:: num_rx // MIXED_GRAD_RX])
    tx_grad = tx.clone().requires_grad_()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()

    def gradient():
        return torch.autograd.grad(mixed_map(dataclasses.replace(fresh(scene16), transmitters=tx_grad)).sum(), tx_grad)[0]

    grad, grad_wall, _, _ = counted_call("mixed map gradient", gradient, want)
    grad_peak = torch.cuda.max_memory_allocated() - base
    if not (torch.isfinite(grad).all() and grad.abs().max() > 0):
        msg = f"the mixed map's TX gradient is {grad.tolist()}"
        raise AssertionError(msg)
    slope, fd, fd_gap = knife_fd_check(device, materials)
    if not fd_gap <= 0.02:
        msg = f"the knife edge's (R, D) TX gradient along itself is {slope}, its central difference {fd} ({fd_gap:.3%} apart)"
        raise AssertionError(msg)

    # anyhit.cu at the path's shape: the (R, D) signature's segments, all 64 receivers.
    signature = MIXED_SIGNATURES[0]
    slots = tuple(dedup.num_triangles if t == 0 else edges.shape[0] for t in signature)
    candidates = generate_mixed_path_candidates(slots, device=device)
    full_paths = _fermat_paths(dedup, tx, rx, edges, candidates, signature, steps=20)
    o, d, th = anyhit_segments(full_paths[..., :-1, :], full_paths[..., 1:, :] - full_paths[..., :-1, :])
    on_path = profile(
        "mixed map (order 1 + diffraction + (R, D), (D, R))",
        lambda: mixed_map(city),
        ("compact_kernel", "anyhit_kernel", "trace_kernel"),
    )
    row = anyhit_row("phase 18", o, d, th, dedup, counts, plain_rows["RD"], on_path.get("anyhit_kernel", (0, float("nan")))[1])
    kernels["anyhit"]["launches_by_path"]["mixed_map"] = counts["anyhit"]
    kernels["anyhit"]["launches"] += counts["anyhit"]
    kernels["trace"]["launches"] += counts["trace"]
    kernels["trace"]["launches_by_path"]["mixed_map"] = counts["trace"]
    kernels["anyhit"]["mixed"] = row

    print(
        f"phase 18 mixed map: order 1 + diffraction + {len(MIXED_SIGNATURES)} signatures, tx=1 rx={num_rx}"
        f" triangles={mesh.num_triangles} edges={edges.shape[0]} per_signature={json.dumps(per_signature)}"
        f" wall_s={wall:.4f} card_ms={card_ms:.2f} fermat_solves={solves}"
        f" fermat_solves_per_s={solves / (fermat_ms / 1e3):.4g} (fermat {fermat_ms:.1f} ms of the split's"
        f" {sum(split.values()):.1f} ms) peak_gib={peak / 2**30:.3f}"
        f" split_ms={json.dumps({k: round(v, 3) for k, v in split.items()})} recomposed_err_db={recomposed_err:.3g}"
        f" counts={json.dumps(counts)} lit={lit} (order 1 alone: {lit_specular})",
        flush=True,
    )
    print(
        f"phase 18 gradient: d(total power)/d(TX) on {scene16.num_receivers} receivers wall_s={grad_wall:.4f}"
        f" peak_gib={grad_peak / 2**30:.3f} grad={grad.tolist()}; knife edge (R, D) along the gradient:"
        f" autograd {slope:.6g} central difference (h={FD_STEP} m) {fd:.6g} gap {fd_gap:.3%} (gate 2%)",
        flush=True,
    )
    print(
        f"phase 18 checks: 8 receivers, card vs CPU {json.dumps(vs_cpu)}; anyhit.cu vs plain"
        f" {json.dumps({k: {'segments': v['segments'], 'mismatches': 0, 'blocked': v['blocked']} for k, v in plain_rows.items()})};"
        f" 8-receiver map vs plain run max_err_db={map_err:.3g} (gate 0.01)",
        flush=True,
    )


def run_scattering(city, kernels: dict, materials: dict) -> None:
    """Phase 19: ``power_map(order=1, with_scattering=True)`` on a fresh copy of
    the coverage scene (20,738 triangles, 128 street receivers), counted:
    ``trace.cu`` for the specular half, one ``anyhit.cu`` launch for both
    segments of every scattering path, one BVH build. Then its parts timed
    apart, a directive ``scattering_amplitudes`` call, its TX gradient, the
    kernel against its plain version on 8 receivers' segments, their map
    against the plain run, and ``S = 0`` against the plain map."""
    from differt_tpu_torch import coverage, ops
    from differt_tpu_torch.em import z_0
    from differt_tpu_torch.ops._dispatch import anyhit_segments
    from differt_tpu_torch.rt import scattering_amplitudes, triangle_sample_points
    from differt_tpu_torch.rt._scattering import _trace_scattering

    device = city.mesh.device
    num_rx = city.num_receivers
    tx = city.transmitters.reshape(-1, 3)
    rx = city.receivers.reshape(-1, 3)

    def scattering_map(scene, **kw):
        return coverage.power_map(scene, FREQUENCY, order=1, with_scattering=True, **materials, **kw)

    scattering_map(fresh(city))  # warm-up
    want = {"anyhit": 1, "trace": 1, "bvh_builds": 1}
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    power, wall, card_ms, counts = counted_call("scattering map", lambda: scattering_map(fresh(city)), want)
    peak = torch.cuda.max_memory_allocated() - base
    if not torch.isfinite(power).all():
        msg = "the scattering map is not finite"
        raise AssertionError(msg)

    scene = fresh(city)
    frequency = torch.tensor(FREQUENCY, device=device)
    eta_r, conductivity, thickness = coverage.resolve_materials(
        scene, frequency, materials["eta_r"], materials["conductivity"], None
    )
    events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    events[0].record()
    paths = scene.trace_paths(order=1).reshape(1, num_rx, -1)
    a_spec = coverage.complex_amplitudes(paths, scene, frequency, eta_r=eta_r, conductivity=conductivity, thickness=thickness)
    events[1].record()
    triangle_sample_points(scene.mesh.triangle_vertices)
    events[2].record()
    scattered = _trace_scattering(scene.mesh, tx, rx, num_samples=1, hit_tol=None, min_len=None)
    events[3].record()
    a_scatter = scattering_amplitudes(scattered, scene, frequency, eta_r=eta_r, conductivity=conductivity)
    events[4].record()
    torch.cuda.synchronize()
    split = {
        name: events[i].elapsed_time(events[i + 1])
        for i, name in enumerate(("specular_half", "sample_points", "trace_with_blockage", "amplitudes"))
    }
    s = 0.3
    recomposed = (torch.abs(a_spec.sum(-1)) ** 2 * (1.0 - s * s) + (torch.abs(a_scatter) ** 2).sum(-1)) / z_0
    recomposed_err = db_error(recomposed.reshape(power.shape), power)
    valid = int(scattered.mask.sum())
    spec_power, scatter_power = float((torch.abs(a_spec.sum(-1)) ** 2).sum()), float((torch.abs(a_scatter) ** 2).sum())
    if not (valid and recomposed_err <= 1e-4):
        msg = f"the scattering map has {valid} valid paths; its parts recompose it within {recomposed_err} dB"
        raise AssertionError(msg)
    directive = scattering_amplitudes(
        _trace_scattering(scene.mesh, tx, rx, num_samples=4, hit_tol=None, min_len=None),
        scene, frequency, eta_r=eta_r, conductivity=conductivity, alpha_r=4, num_samples=4,
    )
    directive_power = float((torch.abs(directive) ** 2).sum())
    if not (torch.isfinite(torch.view_as_real(directive)).all() and directive_power > 0):
        msg = f"the directive scattering amplitudes' power is {directive_power}"
        raise AssertionError(msg)

    tx_grad = city.transmitters.clone().requires_grad_()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()

    def gradient():
        return torch.autograd.grad(scattering_map(dataclasses.replace(fresh(city), transmitters=tx_grad)).sum(), tx_grad)[0]

    grad, grad_wall, _, _ = counted_call("scattering map gradient", gradient, want)
    grad_peak = torch.cuda.max_memory_allocated() - base
    if not (torch.isfinite(grad).all() and grad.abs().max() > 0):
        msg = f"the scattering map's TX gradient is {grad.tolist()}"
        raise AssertionError(msg)

    rx8 = rx[:: num_rx // DIFF_CHECKED_RX]
    scene8 = dataclasses.replace(city, receivers=rx8)
    plain = check_anyhit_bits(
        "phase 19", _trace_scattering(scene.mesh, tx, rx8, num_samples=1, hit_tol=None, min_len=None), scene.mesh
    )
    kernel_map = scattering_map(fresh(scene8))
    ops.set_backend("torch")
    try:
        plain_map = scattering_map(fresh(scene8))
    finally:
        ops.set_backend("auto")
    map_err = db_error(kernel_map, plain_map)
    zero = scattering_map(fresh(city), scattering_coefficient=0.0)
    order1 = coverage.power_map(fresh(city), FREQUENCY, order=1, **materials)
    zero_err = float(((zero - order1).abs() / order1.abs().clamp_min(1e-30)).max())
    if not (map_err <= 0.01 and zero_err <= 1e-6):
        msg = f"the 8 receivers' scattering map is {map_err} dB off the plain run; S = 0 is {zero_err} off order 1"
        raise AssertionError(msg)

    v = scattered.vertices
    o, d, th = anyhit_segments(v[..., :-1, :], v[..., 1:, :] - v[..., :-1, :])
    on_path = profile(
        "scattering map (order 1 + scattering)",
        lambda: scattering_map(city),
        ("compact_kernel", "anyhit_kernel", "trace_kernel"),
    )
    row = anyhit_row("phase 19", o, d, th, scene.mesh, counts, plain, on_path.get("anyhit_kernel", (0, float("nan")))[1])
    kernels["anyhit"]["launches_by_path"]["scattering_map"] = counts["anyhit"]
    kernels["anyhit"]["launches"] += counts["anyhit"]
    kernels["trace"]["launches"] += counts["trace"]
    kernels["trace"]["launches_by_path"]["scattering_map"] = counts["trace"]
    kernels["anyhit"]["scattering"] = row
    print(
        f"phase 19 scattering map: order 1 + scattering, tx=1 rx={num_rx} triangles={city.mesh.num_triangles}"
        f" scattering_paths={scattered.mask.numel()} valid={valid} segments={o.shape[0]}"
        f" wall_s={wall:.4f} card_ms={card_ms:.2f} scattered_paths_per_s={scattered.mask.numel() / wall:.4g}"
        f" peak_gib={peak / 2**30:.3f} split_ms={json.dumps({k: round(v, 3) for k, v in split.items()})}"
        f" recomposed_err_db={recomposed_err:.3g} counts={json.dumps(counts)}"
        f" scattered_power_share={scatter_power / (spec_power + scatter_power):.4g}"
        f" directive(alpha_r=4, num_samples=4) paths={directive.numel()} power={directive_power:.4g}",
        flush=True,
    )
    print(
        f"phase 19 gradient: d(total power)/d(TX) at full width wall_s={grad_wall:.4f} peak_gib={grad_peak / 2**30:.3f}"
        f" grad={grad.tolist()}; checks: anyhit.cu vs plain on {plain['segments']} segments (8 receivers) mismatches=0"
        f" blocked={plain['blocked']}; 8-receiver map vs plain run max_err_db={map_err:.3g} (gate 0.01);"
        f" S = 0 vs power_map(order=1) max_rel_err={zero_err:.3g} (gate 1e-6)",
        flush=True,
    )


# -- Ingest and DeepMIMO (phase 20) ----------------------------------------------


def write_obj(mesh, path) -> None:
    """The mesh as a Wavefront OBJ file of ``v`` and ``f`` lines; each float32 coordinate exactly (its shortest repr)."""
    vertices = mesh.vertices.cpu().numpy().astype(np.float64).tolist()
    lines = [f"v {x!r} {y!r} {z!r}" for x, y, z in vertices]
    lines += [f"f {a} {b} {c}" for a, b, c in (mesh.triangles.cpu() + 1).tolist()]
    path.write_text("\n".join(lines) + "\n")


def dm_errors(got, want, mask: torch.Tensor) -> dict:
    """Per-path differences of two DeepMIMO exports on ``mask``: power (dB), phase on unit phasors
    (degrees), delay (relative), and the angles (degrees) of directions off the z axis."""
    turn = torch.deg2rad(got.phase[mask].double() - want.phase[mask].double())
    phasor = torch.rad2deg(torch.abs(torch.polar(torch.ones_like(turn), turn) - 1.0))
    off_pole = lambda el: (el[mask] > 0.01) & (el[mask] < 179.99)  # noqa: E731
    angles = 0.0
    for az, el in (("aoa_az", "aoa_el"), ("aod_az", "aod_el")):
        keep = off_pole(getattr(want, el)) & off_pole(getattr(got, el))
        for name in (az, el):
            diff = (getattr(got, name)[mask] - getattr(want, name)[mask])[keep].abs()
            angles = max(angles, float(diff.max()) if diff.numel() else 0.0)
    return {
        "power_db": float((got.power[mask] - want.power[mask]).abs().max()),
        "phase_deg": float(phasor.max()),
        "delay_rel": float(((got.delay[mask] - want.delay[mask]).abs() / want.delay[mask]).max()),
        "angle_deg": angles,
    }


def run_ingest(city, kernels: dict, order2_candidates: torch.Tensor) -> tuple:
    """Phase 20: the coverage city written as a Sionna scene (one PLY per object)
    and as an OBJ file, loaded back on the card (``Scene.load_xml``,
    ``Mesh.load_obj`` through the native parser), traced at orders 0-2 on the
    loaded mesh (order 0 through one ``anyhit.cu`` launch, orders 1 and 2 one
    ``trace.cu`` launch each, one BVH build) and exported with
    ``deepmimo.export``. Held against the plain versions on 8 receivers, and
    the order-1 powers against ``coverage.complex_amplitudes``. Returns the
    XML's path and the scene loaded from it (phase 26)."""
    from pathlib import Path

    from differt_tpu_torch import coverage, io, native, ops
    from differt_tpu_torch.em import materials, z_0
    from differt_tpu_torch.geometry import Mesh, Scene
    from differt_tpu_torch.io import _obj
    from differt_tpu_torch.plugins import deepmimo

    device = city.mesh.device
    folder = Path(__file__).resolve().parent / "build" / "smoke_scene"
    mesh = city.mesh
    start = time.perf_counter()
    xml_path = io.export_scene_xml(mesh, folder)
    export_ms = (time.perf_counter() - start) * 1e3
    obj_path = folder / "city.obj"
    write_obj(mesh, obj_path)

    start = time.perf_counter()
    if native.load() is None:
        msg = "the native library (the OBJ parser) did not build"
        raise AssertionError(msg)
    native_build_ms = (time.perf_counter() - start) * 1e3
    native.OBJ_CALLS = native.OBJ_FALLBACK_CALLS = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    loaded = Scene.load_xml(xml_path, device=device)
    torch.cuda.synchronize()
    load_xml_ms = (time.perf_counter() - start) * 1e3
    start = time.perf_counter()
    from_obj = Mesh.load_obj(obj_path, device=device)
    torch.cuda.synchronize()
    load_obj_ms = (time.perf_counter() - start) * 1e3
    parsers = {"native": native.OBJ_CALLS, "python": native.OBJ_FALLBACK_CALLS}
    if parsers != {"native": 1, "python": 0}:
        msg = f"the OBJ went through the parsers {parsers}, expected the native one once"
        raise AssertionError(msg)
    start = time.perf_counter()
    native.parse_obj_geometry(obj_path)
    native_parse_ms = (time.perf_counter() - start) * 1e3
    start = time.perf_counter()
    _obj._load_obj_python(obj_path, "cpu")
    python_parse_ms = (time.perf_counter() - start) * 1e3

    num = mesh.num_triangles
    names = {materials[n].name for n in loaded.mesh.material_names}
    checks = {
        "xml_triangles": loaded.mesh.num_triangles,
        "obj_triangles": from_obj.num_triangles,
        "xml_vertices_equal": torch.equal(loaded.mesh.triangle_vertices, mesh.triangle_vertices),
        "obj_vertices_equal": torch.equal(from_obj.triangle_vertices, mesh.triangle_vertices),
        "materials_equal": names == {materials[n].name for n in mesh.material_names}
        and bool((loaded.mesh.face_materials == 0).all()),
        "objects": loaded.mesh.num_objects == mesh.num_objects,
    }
    if checks != {
        "xml_triangles": num, "obj_triangles": num, "xml_vertices_equal": True,
        "obj_vertices_equal": True, "materials_equal": True, "objects": True,
    } or num != 20_738:
        msg = f"the loaded city differs from the generated one: {checks}"
        raise AssertionError(msg)
    print(
        f"phase 20 ingest: {mesh.num_objects} objects, {num} triangles; native_library_ms={native_build_ms:.1f}"
        f" export_scene_xml_ms={export_ms:.1f}"
        f" load_xml_ms={load_xml_ms:.1f} load_obj_ms={load_obj_ms:.1f} (native parser {parsers['native']} call,"
        f" Python parser {parsers['python']}); parse alone: native_ms={native_parse_ms:.1f}"
        f" python_ms={python_parse_ms:.1f}; materials {loaded.mesh.material_names} = {sorted(names)}",
        flush=True,
    )

    scene = Scene(transmitters=city.transmitters, receivers=city.receivers, mesh=loaded.mesh)
    num_rx = scene.num_receivers

    def pipeline(run_scene, candidates):
        walls = {}
        paths = []
        for order in (0, 1, 2):
            start = time.perf_counter()
            if order < 2:
                paths.append(run_scene.trace_paths(order=order))
            else:
                paths.append(run_scene.trace_paths(path_candidates=candidates))
            torch.cuda.synchronize()
            walls[f"trace_order_{order}"] = time.perf_counter() - start
        start = time.perf_counter()
        out = deepmimo.export(paths=paths, scene=run_scene, frequency=FREQUENCY, include_primitives=True)
        torch.cuda.synchronize()
        walls["export"] = time.perf_counter() - start
        return out, walls, paths

    pipeline(fresh(scene), order2_candidates[:4096])  # warm-up: the first CUDA call of each op
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    want = {"anyhit": 1, "trace": 2, "bvh_builds": 1}
    (out, walls, paths), wall, card_ms, counts = counted_call(
        "ingest and DeepMIMO", lambda: pipeline(fresh(scene), order2_candidates), want
    )
    peak = torch.cuda.max_memory_allocated() - base
    mask = out.mask
    num_paths = out.mask.numel()
    valid = int(mask.sum())
    finite = bool(torch.isfinite(out.power[mask]).all())
    if not (valid and finite and num_paths == num_rx * (1 + num + order2_candidates.shape[0])):
        msg = f"the export has {valid} valid paths of {num_paths}, finite powers {finite}"
        raise AssertionError(msg)

    # Order 1 against the coverage chain's |a|^2 / z_0 (tests/test_coverage.py's consistency check).
    frequency = torch.tensor(FREQUENCY, device=device)
    eta_r, conductivity, thickness = coverage.resolve_materials(scene, frequency, None, None, None)
    a = coverage.complex_amplitudes(
        paths[1], scene, frequency, eta_r=eta_r, conductivity=conductivity, thickness=thickness
    ).reshape(1, num_rx, -1)
    order1 = slice(1, 1 + num)
    lit = mask[..., order1]
    cov_db = 10.0 * torch.log10(torch.abs(a[lit]) ** 2 / z_0)
    consistency_db = float((cov_db - out.power[..., order1][lit]).abs().max())

    # The plain versions on the 8 receivers with the most valid paths: order 2
    # on the first candidates, as many as keep the plain run under 30 s (from
    # a first plain run on 4,096).
    busiest = torch.argsort(mask[0].sum(dim=-1), descending=True, stable=True)[:8]
    scene8 = dataclasses.replace(scene, receivers=city.receivers.reshape(-1, 3)[busiest])
    size = 4096
    ops.set_backend("torch")
    try:
        start = time.perf_counter()
        plain, _, _ = pipeline(fresh(scene8), order2_candidates[:size])
        plain_s = time.perf_counter() - start
        scale = min(order2_candidates.shape[0] // size, int(20.0 / plain_s))
        if scale > 1:
            size *= scale
            start = time.perf_counter()
            plain, _, _ = pipeline(fresh(scene8), order2_candidates[:size])
            plain_s = time.perf_counter() - start
    finally:
        ops.set_backend("auto")
    card, _, _ = pipeline(fresh(scene8), order2_candidates[:size])
    masks_equal = torch.equal(card.mask, plain.mask) and torch.equal(card.inter, plain.inter)
    errors = dm_errors(card, plain, plain.mask)
    if not (
        masks_equal and int(plain.mask.sum()) > 0 and errors["power_db"] <= 0.01 and errors["phase_deg"] <= 0.01
        and errors["delay_rel"] <= 1e-6 and errors["angle_deg"] <= 1e-3 and consistency_db <= 0.01
    ):
        msg = (
            f"phase 20 checks failed: masks equal {masks_equal}, errors {errors},"
            f" order-1 power vs complex_amplitudes {consistency_db} dB"
        )
        raise AssertionError(msg)

    kernels["anyhit"]["launches"] += counts["anyhit"]
    kernels["trace"]["launches"] += counts["trace"]
    kernels["anyhit"]["launches_by_path"]["ingest_deepmimo"] = counts["anyhit"]
    kernels["trace"]["launches_by_path"]["ingest_deepmimo"] = counts["trace"]
    orders = {o: num_rx * n for o, n in ((0, 1), (1, num), (2, order2_candidates.shape[0]))}
    print(
        f"phase 20 DeepMIMO on the loaded city: paths per order {json.dumps(orders)} total={num_paths}"
        f" valid={valid} wall_s={wall:.4f} card_ms={card_ms:.2f}"
        f" split_s={json.dumps({k: round(v, 4) for k, v in walls.items()})}"
        f" exported_paths_per_s={num_paths / walls['export']:.4g} peak_gib={peak / 2**30:.3f}"
        f" counts={json.dumps(counts)}",
        flush=True,
    )
    print(
        f"phase 20 checks: plain run on the 8 receivers with the most valid paths (order 2: the first {size}"
        f" candidates) {plain_s:.2f} s,"
        f" masks equal, valid={int(plain.mask.sum())}, errors {json.dumps({k: float(f'{v:.3g}') for k, v in errors.items()})}"
        f" (gates 0.01 dB, 0.01 deg, 1e-6, 1e-3 deg); order-1 power vs complex_amplitudes"
        f" max_err_db={consistency_db:.3g} on {int(lit.sum())} paths (gate 0.01); every valid power finite",
        flush=True,
    )
    return xml_path, loaded


# -- The device mesh (phase 21) ---------------------------------------------------

MESH_RX = 127  # street_receivers less the last: two ranks pad one
MESH_GRID = 256  # phase 10's width at a quarter of its 512 x 512 grid
MESH_RANKS = 2


def mesh_inputs(city, device) -> dict:
    """Phase 21's inputs: the coverage city with 127 street receivers, and phase 10's step at 256 x 256."""
    scene = dataclasses.replace(city, receivers=city.receivers.reshape(-1, 3)[:MESH_RX].contiguous())
    placement = placement_scene(device, MESH_GRID)
    return {
        "scene": scene,
        "materials": {"eta_r": torch.tensor([5.24], device=device), "conductivity": torch.tensor([0.1], device=device)},
        "target": torch.full((1, MESH_RX), -100.0, device=device),
        "placement": placement,
        "candidates": placement_candidates(placement),
    }


def mesh_calls(inputs: dict, mesh) -> dict:
    """Every ``parallel`` entry point of phase 21 on ``mesh`` (None: one device), each timed by
    ``profiling.timeit`` (one run) with every count set to 0 just before; results on the CPU."""
    from differt_tpu_torch import coverage, parallel, profiling
    from differt_tpu_torch.geometry import generate_path_candidates
    from differt_tpu_torch.rt import trace_path_candidates

    scene, materials, target = inputs["scene"], inputs["materials"], inputs["target"]
    placement = inputs["placement"]
    kw = {**placement_kwargs(placement, inputs["candidates"]), "tx_learning_rate": 1.0, "eta_learning_rate": 1.0}
    tx = scene.transmitters.reshape(-1, 3)

    def trace():
        if mesh is not None:
            return parallel.sharded_trace_paths(scene, 1, mesh)
        cand = generate_path_candidates(scene.mesh.num_primitives, 1, device=tx.device)
        return trace_path_candidates(scene.mesh, tx, scene.receivers.reshape(-1, 3), cand)

    def power_map():
        if mesh is not None:
            return parallel.sharded_power_map(scene, FREQUENCY, mesh, order=1)
        return coverage.power_map(scene, FREQUENCY, order=1)

    calls = {
        "trace": lambda: (lambda p: (p.vertices, p.mask))(trace()),
        "power_map": power_map,
        "training_step": lambda: parallel.training_step(
            scene, FREQUENCY, mesh, order=1, target_power=target, learning_rate=1.0, **materials
        ),
        "placement_training_step": lambda: parallel.placement_training_step(
            scene, FREQUENCY, mesh, order=1, tx=tx, tx_learning_rate=1.0, eta_learning_rate=1.0, **materials
        ),
        "streamed_placement_step": lambda: parallel.streamed_placement_step(placement, FREQUENCY, mesh, **kw),
    }
    named = counters()
    out, walls, counts = {}, {}, {}
    for name, fn in calls.items():
        torch.cuda.synchronize()
        for module, attr in named.values():
            setattr(module, attr, 0)
        result = []
        walls[name] = profiling.timeit(lambda fn=fn: result.append(fn()) or result[-1], repeats=1, warmup=0)["min"]
        counts[name] = {k: getattr(module, attr) for k, (module, attr) in named.items()}
        out[name] = moved(result[-1], "cpu")
    return {"out": out, "walls": walls, "counts": counts}


def mesh_rank(rank: int, port: int, folder: str) -> None:
    """Phase 21b: one gloo rank of two on the one card; saves its results to ``folder``."""
    import torch.distributed as dist

    from differt_tpu_torch import parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=MESH_RANKS, rank=rank)
    mesh = parallel.make_device_mesh(device=device)
    inputs = moved(torch.load(f"{folder}/inputs.pt", weights_only=False), device)
    mesh_calls(inputs, mesh)  # warm: the complex ops' backward compile at first use
    torch.save(mesh_calls(inputs, mesh), f"{folder}/rank{rank}.pt")
    dist.destroy_process_group()


def bits_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a != b).sum()) if a.dtype == torch.bool else int((a.view(torch.int32) != b.view(torch.int32)).sum())


def run_mesh(city, device, smi: str) -> None:
    """Phase 21: the device-mesh forms of ``parallel`` on the coverage city and phase 10's step.

    21a: ``make_device_mesh(1)`` with no group, a one-rank NCCL group on the
    card; every call equals its ``mesh=None`` counterpart bit for bit. 21b:
    two gloo ranks spawned on the one card; masks equal to 21a's, maps and
    vertices within ``rtol 1e-6``, losses ``1e-5``, gradients ``1e-4``, both
    ranks' results identical. ``trace.cu`` launches on every call, and no
    plain version runs.
    """
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from differt_tpu_torch import parallel, profiling

    phase_start = time.perf_counter()
    inputs = mesh_inputs(city, device)
    single = mesh_calls(inputs, None)  # warm
    single = mesh_calls(inputs, None)

    # 21a: NCCL, a world of one.
    if dist.is_initialized():
        msg = "phase 21a needs no process group before it"
        raise AssertionError(msg)
    mesh = parallel.make_device_mesh(1)
    if (dist.get_backend(), mesh.size, mesh.device) != ("nccl", 1, device):
        msg = f"make_device_mesh(1) gave {dist.get_backend()}, {mesh}"
        raise AssertionError(msg)
    one = mesh_calls(inputs, mesh)
    with tempfile.TemporaryDirectory() as folder:
        with profiling.trace(folder), profiling.annotate("sharded_power_map"):
            parallel.sharded_power_map(inputs["scene"], FREQUENCY, mesh, order=1)
        traces = [f for f in os.listdir(folder) if f.endswith(".json")]
        trace_bytes = sum(os.path.getsize(os.path.join(folder, f)) for f in traces)
    dist.destroy_process_group()
    if len(traces) != 1 or trace_bytes == 0:
        msg = f"profiling.trace wrote {traces} ({trace_bytes} bytes)"
        raise AssertionError(msg)
    for name in single["out"]:
        pairs = list(zip(flat(one["out"][name]), flat(single["out"][name]), strict=True))
        if not all(torch.equal(a, b) for a, b in pairs):
            differ = [bits_differ(a, b) for a, b in pairs]
            msg = f"phase 21a {name}: the world of one differs from mesh=None in {differ} elements"
            raise AssertionError(msg)
        if one["counts"][name] != single["counts"][name]:
            msg = f"phase 21a {name}: counts {one['counts'][name]} against mesh=None's {single['counts'][name]}"
            raise AssertionError(msg)
    for name, c in one["counts"].items():
        if c["trace"] == 0 or any(c[k] for k in ("trace_plain", "anyhit_plain", "closest_plain")):
            msg = f"phase 21 {name}: counts {c}"
            raise AssertionError(msg)
    print(
        f"phase 21a NCCL world of one: every call equal to mesh=None bit for bit;"
        f" walls_s {json.dumps({k: round(v, 4) for k, v in one['walls'].items()})},"
        f" mesh=None {json.dumps({k: round(v, 4) for k, v in single['walls'].items()})};"
        f" trace.cu launches {json.dumps({k: c['trace'] for k, c in one['counts'].items()})};"
        f" profiling.trace {trace_bytes} bytes; card: {smi}",
        flush=True,
    )

    # 21b: gloo, two ranks on the one card (NCCL refuses two ranks on one GPU).
    with tempfile.TemporaryDirectory() as folder:
        torch.save(moved(inputs, "cpu"), f"{folder}/inputs.pt")
        start = time.perf_counter()
        mp.spawn(mesh_rank, args=(free_port(), folder), nprocs=MESH_RANKS, join=True)
        spawn_s = time.perf_counter() - start
        ranks = [torch.load(f"{folder}/rank{r}.pt", weights_only=False) for r in range(MESH_RANKS)]
    for name in single["out"]:
        for a, b in zip(flat(ranks[0]["out"][name]), flat(ranks[1]["out"][name]), strict=True):
            if not torch.equal(a, b):
                msg = f"phase 21b {name}: the two ranks' results differ"
                raise AssertionError(msg)
    for rank in ranks:
        for name, c in rank["counts"].items():
            if c["trace"] == 0 or any(c[k] for k in ("trace_plain", "anyhit_plain", "closest_plain")):
                msg = f"phase 21b {name}: counts {c}"
                raise AssertionError(msg)
    got, want = ranks[0]["out"], single["out"]
    if not torch.equal(got["trace"][1], want["trace"][1]):
        msg = "phase 21b: the sharded trace's mask differs from the single device's"
        raise AssertionError(msg)
    checks = {
        "vertices": (got["trace"][0], want["trace"][0], 1e-6),
        "power_map": (got["power_map"], want["power_map"], 1e-6),
        "training_step_loss": (got["training_step"][1], want["training_step"][1], 1e-5),
        "training_step_eta": (got["training_step"][0], want["training_step"][0], 1e-4),
        "placement_loss": (got["placement_training_step"][2], want["placement_training_step"][2], 1e-5),
        "placement_tx": (got["placement_training_step"][0], want["placement_training_step"][0], 1e-4),
        "placement_eta": (got["placement_training_step"][1], want["placement_training_step"][1], 1e-4),
        "streamed_loss": (got["streamed_placement_step"][2], want["streamed_placement_step"][2], 1e-5),
        "streamed_tx": (got["streamed_placement_step"][0], want["streamed_placement_step"][0], 1e-4),
        "streamed_eta": (got["streamed_placement_step"][1], want["streamed_placement_step"][1], 1e-4),
    }
    report = {}
    for label, (a, b, rtol) in checks.items():
        finite = torch.isfinite(b)
        err = float(((a - b).abs() / b.abs().clamp_min(1e-30))[finite].max()) if finite.any() else 0.0
        report[label] = {"max_rel": err, "bits_differ": bits_differ(a, b)}
        if not torch.allclose(a, b, rtol=rtol, atol=0.0, equal_nan=True):
            msg = f"phase 21b {label}: max relative error {err} over {rtol}"
            raise AssertionError(msg)
    print(
        f"phase 21b gloo, {MESH_RANKS} ranks on one card: spawn_s={spawn_s:.2f}; both ranks equal;"
        f" against mesh=None {json.dumps(report)}",
        flush=True,
    )
    for r, rank in enumerate(ranks):
        print(
            f"phase 21b rank {r}: walls_s {json.dumps({k: round(v, 4) for k, v in rank['walls'].items()})};"
            f" trace.cu launches {json.dumps({k: c['trace'] for k, c in rank['counts'].items()})};"
            f" card: {smi}",
            flush=True,
        )
    print(f"phase 21 wall_s={time.perf_counter() - phase_start:.1f}", flush=True)


# -- Every order on the card (phases 22-23) and checkpoints (phase 24) ---------

# scaling.py::run_config5's forward: order 3, a strided shard of 128
# candidates, 16 TX over 1,024 x 1,024 receivers, tiles of 128 x 8,192.
CONFIG5_ORDER, CONFIG5_SHARD, CONFIG5_GRID, CONFIG5_RX_CHUNK = 3, 128, 1024, 8192
CONFIG5_POOL = 30  # the wall triangles nearest TX 5 from which phase 22 draws order-3 chains
CHECKED_RX = 8  # receivers on which phases 22-23 hold the map against the plain version
CANYON_TX = (-30.0, 0.0, 20.0)
CANYON_CHUNK = 1 << 17  # candidates a chunk of phase 23's exhaustive maps (78 chunks at order 5)
CANYON_SHARD = 1 << 20  # phase 23's strided shard at orders 5 (the check) and 6 (the call)


def order3_chains(scene, size: int) -> tuple[torch.Tensor, int]:
    """Up to ``size`` order-3 candidates with valid paths near transmitter 5, the most valid first.

    The pool is the ground's two triangles and the ``CONFIG5_POOL`` wall
    triangles nearest the TX (beyond 20 m, so not the building under it),
    as :func:`placement_candidates` picks order-2 pairs; every chain of
    three of them with no repeat in a row is traced from TX 5 to its tile
    of receivers, in chunks. Returns the chains and how many were traced.
    """
    from differt_tpu_torch.rt import trace_path_candidates

    mesh = scene.mesh
    device = mesh.device
    num = mesh.num_primitives
    tv = mesh.triangle_vertices
    tx5 = scene.transmitters.reshape(-1, 3)[5]
    dist = (tx5 - tv.mean(dim=1))[:, :2].norm(dim=-1)
    walls = torch.nonzero((mesh.normals[:, 2].abs() < 0.1) & (dist > 20.0)).flatten()
    near = walls[torch.argsort(dist[walls])[:CONFIG5_POOL]]
    pool = torch.cat((torch.tensor([num - 2, num - 1], device=device), near))
    triples = torch.cartesian_prod(pool, pool, pool)
    triples = triples[(triples[:, 0] != triples[:, 1]) & (triples[:, 1] != triples[:, 2])]
    start = tile_start(scene, CONFIG5_RX_CHUNK)
    rx = scene.receivers.reshape(-1, 3)[start : start + CONFIG5_RX_CHUNK].contiguous()
    counts = []
    with torch.no_grad():
        for lo in range(0, triples.shape[0], 4096):
            paths = trace_path_candidates(mesh, tx5[None], rx, triples[lo : lo + 4096])
            counts.append(paths.mask.sum(dim=(0, 1)))
    counts = torch.cat(counts)
    order = torch.argsort(counts, descending=True, stable=True)
    order = order[counts[order] > 0][:size]
    return triples[order], triples.shape[0]


def run_config5_forward(device, kernels: dict, smi: str):
    """Phase 22: ``scaling.py::run_config5``'s order-3 forward at its width.

    ``power_map_chunked`` with 16 TX over 1,024 x 1,024 receivers and 128
    order-3 candidates, tiles of 128 candidates x 8,192 receivers: 128
    ``trace.cu`` launches at K = 3 over 2^31 paths, counted, then every
    tile traced again for the valid-path count. The kernel is held against
    its plain version on a whole tile (16.8 M paths), and the map against
    the plain call on the 8 receivers of that tile with the most valid paths.
    Returns the same call on 8 tiles, for phase 8's profile.
    """
    from differt_tpu_torch import ops
    from differt_tpu_torch.coverage import power_map_chunked
    from differt_tpu_torch.rt import trace_path_candidates

    phase_start = time.perf_counter()
    scene = placement_scene(device, CONFIG5_GRID)
    mesh = scene.mesh
    tx = scene.transmitters.reshape(-1, 3)
    rx = scene.receivers.reshape(-1, 3)
    start = tile_start(scene, CONFIG5_RX_CHUNK)
    tile_rx = rx[start : start + CONFIG5_RX_CHUNK].contiguous()
    shard = strided_candidates(mesh.num_primitives, CONFIG5_ORDER, CONFIG5_SHARD, device)
    with torch.no_grad():
        shard_valid = int(trace_path_candidates(mesh, tx, tile_rx, shard).mask.sum())
    candidates, chains, traced = shard, 0, 0
    if not shard_valid:
        # As placement_candidates does at order 2: chains with valid paths first.
        found, traced = order3_chains(scene, CONFIG5_SHARD // 2)
        chains = found.shape[0]
        candidates = first_unique(torch.cat((found, shard)), CONFIG5_SHARD)
    print(
        f"phase 22 candidates: the strided shard of {CONFIG5_SHARD} order-3 candidates has"
        f" {shard_valid} valid paths on the tile of {CONFIG5_RX_CHUNK} receivers nearest TX 5"
        + (
            f"; so {chains} chains with valid paths there (of {traced} traced from the ground and"
            f" the {CONFIG5_POOL} nearest walls) come first, then the shard, {CONFIG5_SHARD} in all"
            if chains else ""
        ),
        flush=True,
    )

    eta = torch.tensor(GRAD_ETA, device=device)
    sigma = torch.tensor(GRAD_SIGMA, device=device)

    def run(run_scene):
        return power_map_chunked(
            run_scene, FREQUENCY, path_candidates=candidates, eta_r=eta, conductivity=sigma,
            candidate_chunk=CONFIG5_SHARD, rx_chunk=CONFIG5_RX_CHUNK,
        )

    tiles = -(-scene.num_receivers // CONFIG5_RX_CHUNK)
    run(scene)  # warm, as scaling.py warms its call
    torch.cuda.reset_peak_memory_stats()
    power, wall, card_ms, counts = counted_call(
        "phase 22 config-5 forward", lambda: run(fresh(scene)), {"trace": tiles, "em": tiles, "bvh_builds": 1}
    )
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not (power.shape == (GRAD_TX, CONFIG5_GRID, CONFIG5_GRID) and torch.isfinite(power).all()):
        msg = f"phase 22: the map is {tuple(power.shape)}, finite: {bool(torch.isfinite(power).all())}"
        raise AssertionError(msg)
    paths = GRAD_TX * scene.num_receivers * CONFIG5_SHARD
    with torch.no_grad():
        valid = sum(
            int(trace_path_candidates(mesh, tx, rx[lo : lo + CONFIG5_RX_CHUNK], candidates).mask.sum())
            for lo in range(0, rx.shape[0], CONFIG5_RX_CHUNK)
        )
        per_rx = trace_path_candidates(mesh, tx, tile_rx, candidates).mask.sum(dim=(0, 2))
    if not valid:
        msg = "phase 22: no valid path in the whole run"
        raise AssertionError(msg)
    picked = start + torch.argsort(per_rx, descending=True, stable=True)[:CHECKED_RX]
    scene8 = dataclasses.replace(scene, receivers=rx[picked].contiguous())
    ops.set_backend("torch")
    try:
        plain = run(scene8)
    finally:
        ops.set_backend("auto")
    checked_valid = int(per_rx[picked - start].sum())
    err = db_error(power.reshape(GRAD_TX, -1)[:, picked], plain.reshape(GRAD_TX, -1))
    if not (checked_valid > 0 and err <= 0.01):
        msg = f"phase 22: {checked_valid} valid paths on the checked receivers, map {err} dB off the plain call"
        raise AssertionError(msg)
    tile_scene = dataclasses.replace(scene, receivers=tile_rx)
    row = check_trace(
        f"(i) config-5 chunk: {GRAD_TX} TX x {CONFIG5_SHARD} cand x {CONFIG5_RX_CHUNK} RX, order 3",
        tile_scene, candidates, CONFIG5_ORDER, want_valid=True, phase=22,
    )
    print(
        f"phase 22 config-5 order-3 forward: tx={GRAD_TX} rx={scene.num_receivers}"
        f" candidates={CONFIG5_SHARD} paths={paths} tiles={tiles} wall_s={wall:.3f}"
        f" card_ms={card_ms:.1f} paths_per_s={paths / wall:.4g} peak_GiB={peak:.2f}"
        f" valid_paths={valid} counts={json.dumps({k: v for k, v in counts.items() if v})};"
        f" plain call on {CHECKED_RX} receivers ({checked_valid} valid paths): max_err_db={err:.3g}"
        f" (gate 0.01); phase_s={time.perf_counter() - phase_start:.1f}; card: {smi}",
        flush=True,
    )
    kernels["trace"]["launches"] += counts["trace"]
    kernels["trace"]["launches_by_path"]["config5_order3"] = counts["trace"]
    note_em(kernels, "config5_order3", counts["em"])
    kernels["trace_config5"] = {
        "name": "trace (order 3, config-5 chunk)",
        "route": "cuda",
        "source": "differt_tpu_torch/csrc/trace.cu",
        "replaces": "differt_tpu/ops/_pallas_trace.py:120",
        "shape": f"{GRAD_TX} TX x {CONFIG5_SHARD} candidates x {CONFIG5_RX_CHUNK} RX x 20,738 triangles, order 3",
        **row,
        "launches": counts["trace"],
    }
    eight_tiles = dataclasses.replace(scene, receivers=rx[: 8 * CONFIG5_RX_CHUNK])
    return lambda: run(eight_tiles)


def canyon_chains(order: int, device) -> torch.Tensor:
    """The canyon's chains that alternate between its street-facing walls
    (triangles 0, 1 at y = -10 and 16, 17 at y = +10): 2^(order + 1) of them."""
    import itertools

    walls = ((0, 1), (16, 17))
    rows = [
        row
        for first in (0, 1)
        for row in itertools.product(*(walls[(first + b) % 2] for b in range(order)))
    ]
    return torch.tensor(rows, device=device)


def run_canyon_orders(device, kernels: dict, materials: dict, smi: str):
    """Phase 23: the street canyon at orders 3-6, where the bounces between
    its parallel walls carry power.

    TX at (-30, 0, 20), 16 x 8 receivers at 1.5 m in the street (x in [-45,
    45], y in [-8, 8]). Orders 3-5: the exhaustive ``power_map_chunked``
    (16,250, 406,250 and 10,156,250 candidates, ``CANYON_CHUNK`` a chunk),
    counted, against ``megakernel=False`` within 0.01 dB. Order 6:
    ``Scene.trace_paths`` on the 128 street chains and a strided shard of
    2^20 of the 253,906,250 candidates. At each order the kernel is held
    against its plain version on 8 receivers, and at order 5 the TX gradient
    through ``_TraceSpecular`` against the plain pipeline's. Returns 8
    chunks of the order-5 map, for phase 8's profile.
    """
    from differt_tpu_torch import scenes
    from differt_tpu_torch.coverage import power_map_chunked
    from differt_tpu_torch.geometry import Scene, count_path_candidates, generate_path_candidates

    phase_start = time.perf_counter()
    y, x = torch.meshgrid(
        torch.linspace(-8.0, 8.0, 8, device=device),
        torch.linspace(-45.0, 45.0, 16, device=device),
        indexing="ij",
    )
    canyon = Scene(
        transmitters=torch.tensor([CANYON_TX], device=device),
        receivers=torch.stack((x, y, torch.full_like(x, 1.5)), dim=-1),
        mesh=scenes.street_canyon_scene(device=device).mesh,
    )
    num = canyon.mesh.num_primitives
    rx = canyon.receivers.reshape(-1, 3)
    scene8 = dataclasses.replace(canyon, receivers=rx[:: rx.shape[0] // CHECKED_RX].contiguous())
    valid, rows, lines = {}, {}, []
    for order in (3, 4, 5):
        total = count_path_candidates(num, order)
        chunks = -(-total // CANYON_CHUNK)

        def run(run_scene, megakernel=None, order=order):
            return power_map_chunked(
                run_scene, FREQUENCY, order=order, candidate_chunk=CANYON_CHUNK,
                rx_chunk=rx.shape[0], megakernel=megakernel, **materials,
            )

        power, wall, card_ms, counts = counted_call(
            f"phase 23 order {order}", lambda: run(fresh(canyon)), {"trace": chunks, "em": chunks, "bvh_builds": 1}
        )
        note_em(kernels, "canyon_orders_3_to_5", counts["em"])
        start = time.perf_counter()
        unfused = run(canyon, False)
        torch.cuda.synchronize()
        unfused_wall = time.perf_counter() - start
        err = db_error(power, unfused)
        if not (torch.isfinite(power).all() and err <= 0.01):
            msg = f"phase 23 order {order}: the map is {err} dB off megakernel=False"
            raise AssertionError(msg)
        first = generate_path_candidates(num, order, size=min(total, CANYON_CHUNK), device=device)
        rows[order] = check_trace(
            f"(j) canyon order {order}, the map's first chunk", canyon, first, order, phase=23
        )
        rows[order]["launches"] = counts["trace"]
        if total <= 4 * CANYON_CHUNK:
            checked = generate_path_candidates(num, order, device=device)
        else:
            checked = torch.cat((
                canyon_chains(order, device),
                strided_candidates(num, order, CANYON_SHARD, device, group=1024),
            ))
        valid[order] = check_trace(
            f"(k) canyon order {order}, {checked.shape[0]} candidates x {CHECKED_RX} RX",
            scene8, checked, order, want_valid=True, phase=23,
        )["valid"]
        lines.append(
            f"order {order}: candidates={total} chunks={chunks} wall_s={wall:.3f} card_ms={card_ms:.1f}"
            f" paths_per_s={total * rx.shape[0] / wall:.4g} unfused_wall_s={unfused_wall:.3f}"
            f" vs_unfused_max_err_db={err:.3g} lit_pixels={int((power > 0).sum())}"
        )

    cands6 = torch.cat((
        canyon_chains(6, device), strided_candidates(num, 6, CANYON_SHARD, device, group=1024)
    ))
    torch.cuda.reset_peak_memory_stats()
    paths6, wall6, card6, counts6 = counted_call(
        "phase 23 order 6", lambda: fresh(canyon).trace_paths(path_candidates=cands6),
        {"trace": 1, "bvh_builds": 1},
    )
    peak6 = torch.cuda.max_memory_allocated() / 2**30
    valid[6] = int(paths6.mask.sum())
    del paths6
    rows[6] = check_trace(
        f"(k) canyon order 6, {cands6.shape[0]} candidates x {CHECKED_RX} RX",
        scene8, cands6, 6, want_valid=True, phase=23,
    )
    rows[6]["launches"] = counts6["trace"]
    lines.append(
        f"order 6: candidates={cands6.shape[0]} of {count_path_candidates(num, 6)} (128 street chains +"
        f" a strided shard) wall_s={wall6:.3f} card_ms={card6:.1f}"
        f" paths_per_s={cands6.shape[0] * rx.shape[0] / wall6:.4g} peak_GiB={peak6:.2f}"
    )
    if not all(valid.values()):
        msg = f"phase 23: valid paths per order {valid}"
        raise AssertionError(msg)
    grad_cands = torch.cat((canyon_chains(5, device), strided_candidates(num, 5, 4096, device)))
    check_function("(l) canyon order 5, 8 receivers", scene8, grad_cands, want_valid=True, phase=23)
    print(
        f"phase 23 canyon orders 3-6: candidate_chunk={CANYON_CHUNK}; " + "; ".join(lines)
        + f"; valid paths per order (orders 3-5 on the {CHECKED_RX} checked receivers, order 6 on all"
        f" {rx.shape[0]}): {json.dumps(valid)}; phase_s={time.perf_counter() - phase_start:.1f}; card: {smi}",
        flush=True,
    )
    launches = sum(row["launches"] for row in rows.values())
    kernels["trace"]["launches"] += launches
    kernels["trace"]["launches_by_path"]["canyon_orders_3_to_6"] = launches
    for order, shape in (
        (3, "16,250 candidates (the whole order-3 map) x 128 RX x 26 triangles"),
        (4, f"{CANYON_CHUNK:,} candidates (a chunk of the order-4 map) x 128 RX x 26 triangles"),
        (5, f"{CANYON_CHUNK:,} candidates (a chunk of the order-5 map) x 128 RX x 26 triangles"),
        (6, f"{cands6.shape[0]:,} candidates x {CHECKED_RX} RX x 26 triangles (the order-6 call has 128 RX)"),
    ):
        kernels[f"trace_canyon{order}"] = {
            "name": f"trace (order {order}, canyon)",
            "route": "cuda",
            "source": "differt_tpu_torch/csrc/trace.cu",
            "replaces": "differt_tpu/ops/_pallas_trace.py:120",
            "shape": shape,
            **rows[order],
        }
    eight_chunks = generate_path_candidates(num, 5, size=8 * CANYON_CHUNK, device=device)
    return lambda: power_map_chunked(
        canyon, FREQUENCY, path_candidates=eight_chunks, candidate_chunk=CANYON_CHUNK,
        rx_chunk=rx.shape[0], **materials,
    )


def run_resume(city, device, smi: str) -> None:
    """Phase 24: checkpoint and resume with ``treekit``.

    Two gradient steps uninterrupted, against one step, a checkpoint of the
    scene and the materials, a load into fresh templates (the mesh without
    its BVH) and one more step: bit for bit the same TX, permittivity and
    loss. ``placement_training_step`` on phase 21's coverage city (127
    receivers), ``streamed_placement_step`` on its 256 x 256 layout.
    """
    import tempfile

    from differt_tpu_torch import parallel, treekit

    phase_start = time.perf_counter()
    inputs = mesh_inputs(city, device)
    candidates = inputs["candidates"]
    unit = {"tx_learning_rate": 1.0, "eta_learning_rate": 1.0}

    def whole(state):
        return parallel.placement_training_step(
            state["scene"], FREQUENCY, order=1, tx=state["scene"].transmitters,
            eta_r=state["eta_r"], conductivity=state["conductivity"], **unit,
        )

    def streamed(state):
        kw = {**placement_kwargs(state["scene"], candidates), **unit}
        kw.update(eta_r=state["eta_r"], conductivity=state["conductivity"])
        return parallel.streamed_placement_step(state["scene"], FREQUENCY, None, **kw)

    def state_of(scene, eta_r, conductivity):
        return {"scene": scene, "eta_r": eta_r, "conductivity": conductivity}

    cases = {
        "placement_training_step": (whole, inputs["scene"], inputs["materials"]),
        "streamed_placement_step": (
            streamed,
            inputs["placement"],
            {"eta_r": torch.tensor(GRAD_ETA, device=device), "conductivity": torch.tensor(GRAD_SIGMA, device=device)},
        ),
    }
    notes = []
    for name, (step, scene, materials) in cases.items():
        def advance(state, step=step):
            tx, eta, loss = step(state)
            return {**state, "scene": dataclasses.replace(state["scene"], transmitters=tx), "eta_r": eta}, loss

        start = time.perf_counter()
        once, _ = advance(state_of(scene, **materials))
        twice, loss = advance(once)
        torch.cuda.synchronize()
        two_steps_s = time.perf_counter() - start
        with tempfile.TemporaryDirectory() as folder:
            path = os.path.join(folder, "step1")
            start = time.perf_counter()
            treekit.tree_serialise_leaves(path, once)
            save_s = time.perf_counter() - start
            size = os.path.getsize(path + ".npz")
            template = state_of(
                dataclasses.replace(fresh(scene), transmitters=torch.zeros_like(scene.transmitters)),
                *(torch.zeros_like(v) for v in materials.values()),
            )
            start = time.perf_counter()
            loaded = treekit.tree_deserialise_leaves(path, template)
            load_s = time.perf_counter() - start
        if loaded["scene"].mesh._bvh is not None or loaded["scene"].transmitters.device != device:
            msg = f"phase 24 {name}: the loaded mesh holds a BVH, or the TX is not on {device}"
            raise AssertionError(msg)
        resumed, resumed_loss = advance(loaded)
        pairs = {
            "tx": (resumed["scene"].transmitters, twice["scene"].transmitters),
            "eta_r": (resumed["eta_r"], twice["eta_r"]),
            "loss": (resumed_loss, loss),
        }
        differ = {k: bits_differ(a, b) for k, (a, b) in pairs.items()}
        if any(differ.values()) or torch.equal(once["scene"].transmitters, twice["scene"].transmitters):
            msg = f"phase 24 {name}: the resumed step differs from the uninterrupted one in {differ} elements"
            raise AssertionError(msg)
        notes.append(
            f"{name}: resumed = uninterrupted bit for bit (tx, eta_r, loss); two steps {two_steps_s:.3f} s,"
            f" checkpoint {len(treekit.tree_leaves(once))} leaves {size} bytes, save {save_s * 1e3:.1f} ms,"
            f" load {load_s * 1e3:.1f} ms"
        )
    print(
        "phase 24 checkpoint and resume: " + "; ".join(notes)
        + f"; phase_s={time.perf_counter() - phase_start:.1f}; card: {smi}",
        flush=True,
    )


# -- The tutorial at the XL city (phase 25) and the Sionna cache (phase 26) ------

# bench.py::bench_cityscale_xl's city and TX; the tutorial's materials.
XL_BLOCKS, XL_TRIANGLES, XL_TX = 56, 112_898, (0.0, 0.0, 60.0)
XL_MATERIALS = {"eta_r": (5.24,), "conductivity": (0.12,)}
XL_HALF = 200.0  # m: half the side of the receiver grids, centred on the TX (the blocks around it)
XL_POOL, XL_WALLS = 62, 1024  # triangles nearest the TX searched for order-2 pairs with valid paths (pairs_with_paths)
# (c): the tutorial's section 3 with bench_cityscale_xl's candidates and
# chunks, its 1,024 x 1,024 grid cut to 128 x 128.
XL_MAP_GRID, XL_MAP_CANDIDATES, XL_MAP_CHUNK, XL_RX_CHUNK = 128, 65_536, 4096, 4096
XL_CHECK_RX = 64  # receivers of (c) held against the unfused pipeline: the brightest, and as many spread
# (d): the tutorial's sections 4-5: every order-1 candidate and 256 order-2
# over 64 x 64 receivers, tiles of 2,048 x 4,096 (phase 10's size), its rates.
XL_STEP_GRID, XL_STEP_CHUNK, XL_STEP_SHARD, XL_STEPS = 64, 2048, 256, 3
XL_RATES = {"tx_learning_rate": 0.1, "eta_learning_rate": 0.01}
XL_DIRECT_RX = 32  # receivers of the direct-autograd anchor
XL_RANDOM = 32_768  # random segments over the XL city in (b): the plain version takes about 1 s on them
TARBALL_SCENES = "sionna-rt-main/src/sionna/rt/scenes"  # the scenes' root in the sionna-rt tarball


def host_candidate(index: int, num_primitives: int, order: int) -> list[int]:
    """Row ``index`` of the candidate decode, in Python ints (the mixed radix of ``_decode_range``)."""
    digits = []
    for t in range(order):
        digit, index = divmod(index, (num_primitives - 1) ** (order - 1 - t))
        digits.append(digit)
    row = digits[:1]
    for digit in digits[1:]:
        row.append(digit + (digit >= row[-1]))
    return row


def grid_around(center, half: float, n: int, device) -> torch.Tensor:
    """``n`` x ``n`` receivers at 1.5 m on a square of side ``2 half`` centred on ``center``'s x and y."""
    xs = torch.linspace(-half, half, n, device=device)
    y, x = torch.meshgrid(xs + center[1], xs + center[0], indexing="ij")
    return torch.stack((x, y, torch.full_like(x, 1.5)), dim=-1)


def pairs_with_paths(scene, rx: torch.Tensor) -> torch.Tensor:
    """Order-2 candidates near the TX that have a valid path from it to one of
    ``rx``, the most valid first: as :func:`placement_candidates` puts such
    pairs before a strided shard. Searched: the ordered pairs of the ground's
    two triangles (the last two) and the ``XL_POOL`` triangles nearest the TX,
    and each of the ``XL_WALLS`` nearest with the ground, both ways."""
    from differt_tpu_torch.rt import trace_path_candidates

    mesh = scene.mesh
    num = mesh.num_primitives
    tx = scene.transmitters.reshape(-1, 3)
    dist = (mesh.triangle_vertices.mean(dim=1)[:-2, :2] - tx[0, :2]).norm(dim=-1)
    nearest = torch.argsort(dist)
    ground = torch.tensor([num - 2, num - 1], device=mesh.device)
    pool = torch.cat((nearest[:XL_POOL], ground))
    pairs = torch.cartesian_prod(pool, pool)
    walls = torch.cartesian_prod(nearest[:XL_WALLS], ground)
    pairs = torch.cat((pairs[pairs[:, 0] != pairs[:, 1]], walls, walls.flip(-1)))
    with torch.no_grad():
        counts = torch.cat([
            trace_path_candidates(mesh, tx, rx, pairs[lo : lo + 4096]).mask.sum(dim=(0, 1))
            for lo in range(0, pairs.shape[0], 4096)
        ])
    order = torch.argsort(counts, descending=True, stable=True)
    return pairs[order[counts[order] > 0]]


def run_xl(device, kernels: dict, smi: str) -> dict:
    """Phase 25: the tutorial's workflow at its own city size, ``urban_scene(56, 56)``.

    (a) The 112,898-triangle city and its BVH, built once for the whole
    phase. The order-2 decode range, 1.27e10 rows, beyond int32: strided rows
    against a host decode. (b) Both path kernels against their plain
    versions on the first chunk of (c)'s call, 4,096 candidates (valid pairs
    near the TX first, then the strided shard) x 128 street receivers, and
    the any-hit kernel on ``XL_RANDOM`` random segments over the city, 7 in
    8 of them live (the timings that build a BVH of their own build it off
    the mesh, and are counted apart). (c)
    ``power_map_chunked`` on 65,536 candidates over 128 x 128 receivers
    around the TX, counted, and ``megakernel=False`` on 128 of its
    receivers. (d) Three ``streamed_placement_step`` on every order-1
    candidate and 256 strided order-2 over 64 x 64 receivers, counted; the
    first anchored as phase 11 anchors its step. Returns (c) on two tiles,
    a step of (d) and the unfused map, for phase 8's profiles.
    """
    from differt_tpu_torch import scenes
    from differt_tpu_torch.coverage import power_map_chunked
    from differt_tpu_torch.geometry import Scene, count_path_candidates, generate_path_candidates
    from differt_tpu_torch.ops import _bvh
    from differt_tpu_torch.parallel import streamed_placement_step

    phase_start = time.perf_counter()
    builds = 0  # BVH builds of the phase: counted_call zeroes the count, so it is folded in here

    def settle() -> None:
        nonlocal builds
        builds += _bvh.BUILDS
        _bvh.BUILDS = 0

    def counted(label, fn, want):
        settle()
        out = counted_call(f"phase 25 {label}", fn, want)
        settle()
        return out

    # (a) The city and its one BVH.
    torch.cuda.synchronize()
    start = time.perf_counter()
    mesh = scenes.urban_scene(XL_BLOCKS, XL_BLOCKS, device=device).mesh
    torch.cuda.synchronize()
    scene_s = time.perf_counter() - start
    if mesh.num_triangles != XL_TRIANGLES:
        msg = f"urban_scene({XL_BLOCKS}, {XL_BLOCKS}) has {mesh.num_triangles} triangles, expected {XL_TRIANGLES:,}"
        raise AssertionError(msg)
    _bvh.BUILDS = 0
    start = time.perf_counter()
    bvh = mesh.bvh
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - start) * 1e3
    num = mesh.num_primitives
    (lo_x, lo_y, _), (hi_x, hi_y, hi_z) = mesh.bounding_box.tolist()
    print(
        f"phase 25 (a) city: urban_scene({XL_BLOCKS}, {XL_BLOCKS}) triangles={num}"
        f" footprint={hi_x - lo_x:.0f}x{hi_y - lo_y:.0f} m (ground plane) top={hi_z:.1f} m scene_s={scene_s:.2f};"
        f" BVH build_ms={build_ms:.2f} depth={bvh.depth} (max {_bvh.MAX_DEPTH}) nodes={bvh.num_nodes}"
        f" large={bvh.num_large} (max {_bvh.MAX_LARGE}) leaf_size={bvh.leaf_size} bytes={bvh.nbytes}",
        flush=True,
    )

    # The order-2 decode beyond int32, against a host decode in Python ints.
    total = count_path_candidates(num, 2)
    strided = strided_candidates(num, 2, XL_MAP_CANDIDATES, device)
    groups = XL_MAP_CANDIDATES // 8
    last = min((groups - 1) * (total // groups), total - 8) + 7
    tail = generate_path_candidates(num, 2, start=total - 2, size=2, device=device)
    decoded = {
        "first": (strided[0].tolist(), host_candidate(0, num, 2)),
        "last": (strided[-1].tolist(), host_candidate(last, num, 2)),
        "range_end": (tail.tolist(), [host_candidate(total - 2, num, 2), host_candidate(total - 1, num, 2)]),
    }
    if strided.dtype != torch.int64 or any(a != b for a, b in decoded.values()):
        msg = f"phase 25: the decode of {total} rows ({strided.dtype}) differs from the host's: {decoded}"
        raise AssertionError(msg)
    print(
        f"phase 25 (a) decode: {total} order-2 rows (beyond int32: {total > 2**31}), int64;"
        f" rows 0, {last} (the shard's last)"
        f" and the range's last two equal the host decode: {json.dumps({k: v[0] for k, v in decoded.items()})}",
        flush=True,
    )

    # (b) Both path kernels on the first chunk of (c)'s call.
    tx = torch.tensor([XL_TX], device=device)
    street = Scene(transmitters=tx, receivers=street_receivers(device), mesh=mesh)
    grid = Scene(transmitters=tx, receivers=grid_around(XL_TX, XL_HALF, XL_MAP_GRID, device), mesh=mesh)
    rx = grid.receivers.reshape(-1, 3)
    num_rx = rx.shape[0]
    found = pairs_with_paths(street, torch.cat((street.receivers.reshape(-1, 3), rx[:: XL_MAP_GRID + 1])))
    candidates = first_unique(torch.cat((found, strided)), XL_MAP_CANDIDATES)
    chunk = candidates[:XL_MAP_CHUNK]
    settle()
    trace_row = check_trace(
        f"(l) XL chunk: {XL_MAP_CHUNK} order-2 candidates ({found.shape[0]} pairs near the TX with valid paths,"
        f" then the strided shard) x {street.num_receivers} street RX x {num} triangles",
        street, chunk, 2, want_valid=True, phase=25,
    )
    o, d, th = unfused_segments(street, chunk)
    anyhit_row = check_anyhit_at("(d) XL unfused chunk, the same candidates and receivers", o, d, th, mesh, phase=25)
    random_row = check_anyhit_at(
        f"(e) XL {XL_RANDOM} random segments", *random_segments(mesh, XL_RANDOM), mesh, phase=25
    )
    timing_builds = _bvh.BUILDS  # each check's timing with its own BVH: a warm-up and 3 runs, off the mesh
    _bvh.BUILDS = 0
    if timing_builds != 3 * 4:
        msg = f"phase 25 (b): the kernel checks built {timing_builds} BVHs, expected 12 (their timings')"
        raise AssertionError(msg)

    # (c) The map, counted, and against the unfused pipeline on 128 of its receivers.
    materials = {k: torch.tensor(v, device=device) for k, v in XL_MATERIALS.items()}

    def xl_map(run_scene, cands, **kw):
        return power_map_chunked(
            run_scene, FREQUENCY, path_candidates=cands, candidate_chunk=XL_MAP_CHUNK,
            rx_chunk=XL_RX_CHUNK, **materials, **kw,
        )

    two_tiles = dataclasses.replace(grid, receivers=rx[:XL_RX_CHUNK])
    xl_map(two_tiles, chunk)  # warm: one tile
    map_tiles = (XL_MAP_CANDIDATES // XL_MAP_CHUNK) * (num_rx // XL_RX_CHUNK)
    torch.cuda.reset_peak_memory_stats()
    power, wall, card_ms, counts = counted(
        "(c) XL map", lambda: xl_map(grid, candidates), {"trace": map_tiles, "em": map_tiles}
    )
    peak = torch.cuda.max_memory_allocated() / 2**30
    lit = int((power > 0).sum())
    if not (power.shape == (1, XL_MAP_GRID, XL_MAP_GRID) and torch.isfinite(power).all() and lit):
        msg = f"phase 25 (c): the map is {tuple(power.shape)}, finite {bool(torch.isfinite(power).all())}, lit {lit}"
        raise AssertionError(msg)
    flat_power = power.reshape(-1)
    picked = torch.cat((
        torch.argsort(flat_power, descending=True, stable=True)[:XL_CHECK_RX],
        torch.arange(0, num_rx, num_rx // XL_CHECK_RX, device=device)[:XL_CHECK_RX],
    ))
    check = dataclasses.replace(grid, receivers=rx[picked].contiguous())
    unfused, unfused_wall, _, unfused_counts = counted(
        "(c) XL unfused map", lambda: xl_map(check, candidates, megakernel=False),
        {"anyhit": XL_MAP_CANDIDATES // XL_MAP_CHUNK, "em": XL_MAP_CANDIDATES // XL_MAP_CHUNK},
    )
    err = db_error(flat_power[picked], unfused.reshape(-1))
    if not err <= 0.1:
        msg = f"phase 25 (c): the fused map differs from the unfused pipeline by {err} dB on {picked.shape[0]} receivers"
        raise AssertionError(msg)
    # The EM tile kernel against its twin on a tile of the map's shape: the
    # first chunk x 4,096 receivers, those whose paths found the chunk's
    # first pairs among them.
    em_rx = torch.cat((street.receivers.reshape(-1, 3), rx[:: XL_MAP_GRID + 1]))
    em_rx = torch.cat((em_rx, rx[: XL_RX_CHUNK - em_rx.shape[0]]))
    em_row = check_em(
        f"(m) XL map tile: {XL_MAP_CHUNK} order-2 candidates x {em_rx.shape[0]} RX",
        dataclasses.replace(grid, receivers=em_rx.contiguous()), chunk, materials, want_valid=True, phase=25,
    )
    paths = XL_MAP_CANDIDATES * num_rx
    print(
        f"phase 25 (c) XL map: candidates={XL_MAP_CANDIDATES} rx={XL_MAP_GRID}x{XL_MAP_GRID} paths={paths}"
        f" tiles={map_tiles} wall_s={wall:.3f} card_ms={card_ms:.1f} paths_per_s={paths / wall:.4g}"
        f" peak_GiB={peak:.2f} lit_pixels={lit} counts={json.dumps({k: v for k, v in counts.items() if v})}"
        f" (plain calls 0); megakernel=False on {picked.shape[0]} receivers ({XL_CHECK_RX} brightest,"
        f" {XL_CHECK_RX} spread): wall_s={unfused_wall:.3f}"
        f" counts={json.dumps({k: v for k, v in unfused_counts.items() if v})} max_err_db={err:.3g} (gate 0.1)",
        flush=True,
    )

    # (d) Three streamed steps, the first anchored.
    step_scene = Scene(transmitters=tx, receivers=grid_around(XL_TX, XL_HALF, XL_STEP_GRID, device), mesh=mesh)
    step_candidates = [
        generate_path_candidates(num, 1, device=device),
        strided_candidates(num, 2, XL_STEP_SHARD, device),
    ]
    step_rx = step_scene.num_receivers
    step_tiles = -(-step_rx // XL_RX_CHUNK) * sum(
        -(-c.shape[0] // min(XL_STEP_CHUNK, c.shape[0])) for c in step_candidates
    )
    step_kw = {
        "tx": tx, **materials, "path_candidates": step_candidates,
        "candidate_chunk": XL_STEP_CHUNK, "rx_chunk": XL_RX_CHUNK,
    }

    def step(run_scene, tx_now, eta_now):
        return streamed_placement_step(
            run_scene, FREQUENCY, None, **{**step_kw, "tx": tx_now, "eta_r": eta_now}, **XL_RATES
        )

    tx0, eta0 = tx, materials["eta_r"]
    tx_now, eta_now, steps = tx0, eta0, []
    for i in range(XL_STEPS):
        torch.cuda.reset_peak_memory_stats()
        (new_tx, new_eta, loss), step_wall, step_card_ms, _ = counted(
            f"(d) step {i + 1}", lambda t=tx_now, e=eta_now: step(step_scene, t, e),
            {"trace": 2 * step_tiles, "em": step_tiles},  # the EM kernel in pass 1 alone
        )
        if not (torch.isfinite(loss) and torch.isfinite(new_tx).all() and bool((new_tx != tx_now).any())):
            msg = f"phase 25 (d) step {i + 1}: loss {float(loss)}, tx {new_tx.tolist()}"
            raise AssertionError(msg)
        steps.append({
            "wall_s": round(step_wall, 3), "card_s": round(step_card_ms / 1e3, 3), "loss": float(loss),
            "peak_GiB": round(torch.cuda.max_memory_allocated() / 2**30, 2), "tx": new_tx[0].tolist(),
            "eta_r": float(new_eta[0]),
        })
        tx_now, eta_now = new_tx, new_eta
    step_paths = step_rx * sum(c.shape[0] for c in step_candidates)
    print(
        f"phase 25 (d) XL steps: rx={XL_STEP_GRID}x{XL_STEP_GRID} candidates={num} order 1 + {XL_STEP_SHARD} order 2"
        f" tiles={step_tiles} a pass, paths a pass={step_paths} rates={json.dumps(XL_RATES)}"
        f" trace launches a step={2 * step_tiles} (plain calls 0); steps {json.dumps(steps)}",
        flush=True,
    )

    # Anchors at the first step's inputs, on strided subsamples of its grid, as phase 11.
    step_flat = step_scene.receivers.reshape(-1, 3)
    scene_direct = dataclasses.replace(step_scene, receivers=step_flat[:: step_rx // XL_DIRECT_RX + 1].contiguous())
    scene_sub = dataclasses.replace(step_scene, receivers=step_flat[::4].contiguous())
    anchors = anchor_streamed_step("phase 25", scene_direct, scene_sub, step_kw)
    settle()
    if builds != 1:
        msg = f"phase 25 built the city's BVH {builds} times, expected once"
        raise AssertionError(msg)
    print(
        f"phase 25 anchors: {anchors}; bvh_builds={builds} (the whole phase, the mesh's),"
        f" {timing_builds} more off the mesh in (b)'s timings;"
        f" phase_s={time.perf_counter() - phase_start:.1f}; card: {smi}",
        flush=True,
    )

    trace_launches = counts["trace"] + XL_STEPS * 2 * step_tiles
    kernels["trace"]["launches"] += trace_launches
    kernels["trace"]["launches_by_path"]["xl_map"] = counts["trace"]
    kernels["trace"]["launches_by_path"]["xl_steps"] = XL_STEPS * 2 * step_tiles
    kernels["anyhit"]["launches"] += unfused_counts["anyhit"]
    kernels["anyhit"]["launches_by_path"]["xl_unfused_map"] = unfused_counts["anyhit"]
    note_em(kernels, "xl_map", counts["em"])
    note_em(kernels, "xl_unfused_map", unfused_counts["em"])
    note_em(kernels, "xl_steps", XL_STEPS * step_tiles)
    kernels["em_xl"] = {
        "name": "em (m) XL map tile",
        "route": "cuda",
        "source": "differt_tpu_torch/csrc/em.cu",
        "replaces": "differt_tpu/coverage.py::complex_amplitudes (XLA's fusion; no TPU kernel)",
        "shape": f"{XL_MAP_CHUNK} order-2 candidates x {em_rx.shape[0]} RX",
        **{k: v for k, v in em_row.items() if k != "valid"},
        "launches": counts["em"] + unfused_counts["em"] + XL_STEPS * step_tiles,
        "launches_by_path": {
            "xl_map": counts["em"], "xl_unfused_map": unfused_counts["em"], "xl_steps": XL_STEPS * step_tiles,
        },
    }
    kernels["trace_xl"] = {
        "name": "trace (l) XL chunk",
        "route": "cuda",
        "source": "differt_tpu_torch/csrc/trace.cu",
        "replaces": "differt_tpu/ops/_pallas_trace.py:120",
        "shape": f"{XL_MAP_CHUNK} order-2 candidates x {street.num_receivers} RX x {num} triangles",
        **{k: v for k, v in trace_row.items() if k != "valid"},
        "launches": trace_launches,
        "launches_by_path": {"xl_map": counts["trace"], "xl_steps": XL_STEPS * 2 * step_tiles},
    }
    kernels["anyhit_xl"] = {
        "name": "anyhit (d) XL unfused chunk",
        "route": "cuda",
        "source": "differt_tpu_torch/csrc/anyhit.cu",
        "replaces": "differt_tpu/ops/_pallas_rt.py:228",
        "shape": f"{o.shape[0]} segments x {num} triangles",
        **anyhit_row,
        "launches": unfused_counts["anyhit"],
        "random_segments": {"shape": f"{XL_RANDOM} random segments, 1 in 8 inactive", **random_row},
    }
    two_tile_candidates = candidates[: 2 * XL_MAP_CHUNK]
    return {
        "map": lambda: xl_map(two_tiles, two_tile_candidates),
        "step": lambda: step(step_scene, tx0, eta0),
        "unfused": lambda: xl_map(check, candidates, megakernel=False),
    }


def run_sionna_cache(device, xml_path, ingested, smi: str) -> None:
    """Phase 26: phase 20's scene as a Sionna cache on the card.

    Its XML and mesh files laid out as the sionna-rt tarball extracts them,
    in a temporary folder that ``DIFFERT_TPU_CACHE_DIR`` names for this phase
    only; ``list_sionna_scenes``, ``download_sionna_scenes`` (with any request
    refused: a filled cache makes none) and
    ``Scene.load_xml(get_sionna_scene("city"))``, bit for bit phase 20's load.
    """
    import shutil
    import tempfile
    import urllib.request
    from pathlib import Path

    from differt_tpu_torch import io
    from differt_tpu_torch.geometry import Scene

    phase_start = time.perf_counter()

    def refuse(*args, **kwargs):
        msg = "phase 26 tried to download the Sionna scenes"
        raise AssertionError(msg)

    saved = os.environ.get("DIFFERT_TPU_CACHE_DIR")
    urlopen = urllib.request.urlopen
    with tempfile.TemporaryDirectory() as root:
        folder = Path(root) / "sionna"
        city = folder / TARBALL_SCENES / "city"
        shutil.copytree(xml_path.parent, city, ignore=shutil.ignore_patterns("*.obj", "*.xml"))
        shutil.copyfile(xml_path, city / "city.xml")
        os.environ["DIFFERT_TPU_CACHE_DIR"] = root
        urllib.request.urlopen = refuse
        try:
            names = io.list_sionna_scenes()
            downloaded = io.download_sionna_scenes()
            path = io.get_sionna_scene("city")
            torch.cuda.synchronize()
            start = time.perf_counter()
            cached = Scene.load_xml(path, device=device).mesh
            torch.cuda.synchronize()
            load_ms = (time.perf_counter() - start) * 1e3
        finally:
            urllib.request.urlopen = urlopen
            if saved is None:
                os.environ.pop("DIFFERT_TPU_CACHE_DIR")
            else:
                os.environ["DIFFERT_TPU_CACHE_DIR"] = saved
        num_files = sum(1 for p in city.rglob("*") if p.is_file())
    mesh = ingested.mesh
    fields = ("vertices", "triangles", "face_colors", "face_materials", "object_bounds")
    equal = {
        name: (a is None and b is None) or (a is not None and b is not None and torch.equal(a, b))
        for name, a, b in ((name, getattr(cached, name), getattr(mesh, name)) for name in fields)
    }
    equal["material_names"] = cached.material_names == mesh.material_names
    checks = {
        "names": names == ["city"],
        "download_returned_the_cache": downloaded == folder,
        "path": path == str(city / "city.xml"),
        "on_device": cached.vertices.device == device,
        **equal,
    }
    if not all(checks.values()):
        msg = f"phase 26: the Sionna cache's checks failed: {checks}"
        raise AssertionError(msg)
    print(
        f"phase 26 Sionna cache: {num_files} files under {TARBALL_SCENES}/city; list={names};"
        f" download_sionna_scenes() returned the cache with no request; load_xml(get_sionna_scene('city'))"
        f" {cached.num_triangles} triangles in {load_ms:.1f} ms, bit for bit phase 20's load ({', '.join(equal)});"
        f" phase_s={time.perf_counter() - phase_start:.1f}; card: {smi}",
        flush=True,
    )


def flat(value) -> list[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        return [value]
    return [t for item in value for t in flat(item)]


def free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def main() -> None:
    if not torch.cuda.is_available():
        msg = "chip_smoke.py needs a CUDA device, and none is visible."
        raise SystemExit(msg)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from differt_tpu_torch import coverage, scenes
    from differt_tpu_torch.geometry import Scene, generate_path_candidates
    from differt_tpu_torch.ops import _build, _bvh, _em, _rt, _trace

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
    # (e), (f) The gradient step's launches: one tile of 16 TX x 256
    # candidates x 2,048 receivers, of each order.
    grad_scene = placement_scene(device, GRAD_GRIDS[0])
    tile_scene = dataclasses.replace(grad_scene, receivers=tile_near_tx(grad_scene))
    tile_rows = {}
    for label, candidates in zip(("(e)", "(f)"), placement_candidates(grad_scene)):
        order = candidates.shape[1]
        tile_rows[f"order {order}"] = check_trace(
            f"{label} gradient-step tile, order {order}", tile_scene, candidates, order,
            want_valid=True,
        )
        trace_errors.append(tile_rows[f"order {order}"]["max_abs_err"])
    kernels["trace"] = {
        "name": "trace",
        "route": "cuda",
        "source": "differt_tpu_torch/csrc/trace.cu",
        "replaces": "differt_tpu/ops/_pallas_trace.py:120",
        "shape": "main path order 2 chunk: 4,096 candidates x 128 RX x 20,738 triangles",
        **row,
        "max_abs_err": max(trace_errors),
        "placement_tile": {
            "shape": "gradient-step tile: 16 TX x 256 candidates x 2,048 RX x 20,738 triangles",
            **tile_rows,
        },
    }

    # Phase 4: the main path, counted: each order's call on a fresh mesh.
    materials = {"eta_r": [5.24], "conductivity": [0.1]}
    runs = (
        (0, None, 1),
        (1, None, mesh.num_primitives),
        (2, main_candidates, MAIN_CANDIDATES),
    )

    def coverage_run(scene, order, candidates, **kw):
        return coverage.power_map_chunked(
            scene,
            FREQUENCY,
            order=order,
            path_candidates=candidates,
            candidate_chunk=4096,
            rx_chunk=128,
            **materials,
            **kw,
        )

    # Warm-up: the first CUDA call of each complex-valued PyTorch op compiles
    # it at run time (about a second in all), which is set-up, not the path.
    for order, candidates, _ in runs:
        coverage_run(city, order, None if candidates is None else candidates[:4096])
    torch.cuda.synchronize()
    _rt.LAUNCHES = _trace.LAUNCHES = 0
    _rt.REFERENCE_CALLS = _trace.REFERENCE_CALLS = 0
    maps, builds, em_launches = {}, {}, {}
    for order, candidates, num_candidates in runs:
        run_city = fresh(city)
        _bvh.BUILDS = _em.LAUNCHES = 0
        start = time.perf_counter()
        power = coverage_run(run_city, order, candidates)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        builds[order] = _bvh.BUILDS
        em_launches[order] = _em.LAUNCHES
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
    # One EM tile launch a tile (128 receivers, one RX tile), at every order.
    want_em = {order: -(-num_candidates // 4096) for order, _, num_candidates in runs}
    if em_launches != want_em:
        msg = f"the main path's EM tile launches per order are {em_launches}, expected {want_em}"
        raise AssertionError(msg)
    kernels["anyhit"]["launches"] = counts["anyhit"]
    kernels["trace"]["launches"] = counts["trace"]

    # The EM tile kernel against its twin on the main path's tiles: order 0,
    # the first order-1 chunk, and an order-2 chunk with valid paths (the
    # near pairs of phase 3 (c); the main chunk's paths are all blocked).
    em_rows = {
        "order 0": check_em(
            "(a) main path order-0 tile", city,
            generate_path_candidates(mesh.num_primitives, 0, device=device), materials,
        ),
        "order 1": check_em(
            "(b) main path order-1 chunk", city,
            generate_path_candidates(mesh.num_primitives, 1, size=4096, device=device), materials,
        ),
    }
    em_row = check_em("(c) order-2 near pairs", city, pairs[:4096], materials, want_valid=True)
    kernels["em"] = {
        "name": "em",
        "route": "cuda",
        "source": "differt_tpu_torch/csrc/em.cu",
        "replaces": "differt_tpu/coverage.py::complex_amplitudes (XLA's fusion; no TPU kernel)",
        "shape": "order-2 tile: 4,096 near pairs x 128 RX",
        **em_row,
        "max_abs_err": max(row["max_abs_err"] for row in (em_row, *em_rows.values())),
        "rel_err": max(row["rel_err"] for row in (em_row, *em_rows.values())),
        "tiles": em_rows,
        "launches": 0,
        "launches_by_path": {},
    }
    note_em(kernels, "coverage", sum(em_launches.values()))

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
        f" fused vs unfused max_err_db: {json.dumps(errors)}; em launches per order: {json.dumps(em_launches)}",
        flush=True,
    )

    check_closest(device, kernels)
    launching = run_ray_launching(device, kernels)

    # Phase 9: the fused trace's Function, at the main path's first chunk, on
    # the near pairs of phase 3 (c) (valid paths in the city) and on the
    # canyon, whose walls are parallel mirrors.
    check_function("(a) main path chunk", city, main_candidates[:4096], want_valid=False)
    check_function("(b) city near pairs", city, pairs, want_valid=True)
    canyon_pairs = generate_path_candidates(canyon.mesh.num_primitives, 2, device=device)
    check_function("(c) canyon order 2", canyon, canyon_pairs, want_valid=True)
    run_placement(device, kernels)
    run_smoothed(device)

    # Phases 14-16: visibility, the hybrid tracer, antenna patterns.
    run_visibility(city, kernels)
    hybrid = run_hybrid(city, kernels, maps[1], materials, pairs)
    kernels["trace"]["hybrid_chunk"] = {
        "shape": "hybrid order-2 chunk: 4,096 candidates x 128 RX x 20,738 triangles",
        **check_trace("(g) hybrid order-2 chunk", city, hybrid["chunk2"], 2, want_valid=True),
    }
    patterns = run_patterns(city, kernels, runs, coverage_run, maps)
    run_diffraction(city, kernels, materials)
    run_mixed(device, kernels, materials)
    run_scattering(city, kernels, materials)
    ingested = run_ingest(city, kernels, main_candidates[: 32 * 4096])
    run_mesh(city, device, smi)
    config5 = run_config5_forward(device, kernels, smi)
    canyon5 = run_canyon_orders(device, kernels, materials, smi)
    run_resume(city, device, smi)
    xl = run_xl(device, kernels, smi)
    run_sionna_cache(device, *ingested, smi)

    order2 = main_candidates[: 32 * 4096]
    on_path = profile("coverage order 2, 32 chunks", lambda: coverage_run(city, 2, order2), ("trace_kernel", "em_kernel"))
    kept, ms, made = on_path["em_kernel"]
    kernels["em"]["on_path_ms"], kernels["em"]["on_path_records"] = ms, f"{kept} of {made}"
    profile(
        "coverage order 2 with HW dipole, 32 chunks",
        lambda: coverage_run(city, 2, order2, tx_pattern=patterns["hw"]),
        ("trace_kernel",),
    )
    profile("hybrid order 1", lambda: hybrid["map"](city, 1), ("closest_kernel", "trace_kernel", "em_kernel"))
    profile(
        "coverage order 0", lambda: coverage_run(city, 0, None), ("compact_kernel", "anyhit_kernel", "em_kernel")
    )
    profile("SBR", lambda: launching["sbr"](launching["scene"]), ("closest_kernel",))
    profile("config-5 order 3, 8 of its 128 tiles", config5, ("trace_kernel", "em_kernel"))
    profile("canyon order 5, 8 of its 78 chunks", canyon5, ("trace_kernel", "em_kernel"))
    profile("MLM", lambda: launching["mlm"](launching["scene"]), ("closest_kernel",))
    xl_on_path = {
        "map": profile("XL map, 2 of its 64 tiles", xl["map"], ("trace_kernel", "em_kernel")),
        "step": profile("XL gradient step, 1 of its 3", xl["step"], ("trace_kernel", "em_kernel")),
        "unfused": profile("XL unfused map, 128 rx", xl["unfused"], ("compact_kernel", "anyhit_kernel")),
    }
    for key, path, name in (
        ("trace_xl", "map", "trace_kernel"), ("trace_xl", "step", "trace_kernel"), ("anyhit_xl", "unfused", "anyhit_kernel"),
        ("em_xl", "map", "em_kernel"), ("em_xl", "step", "em_kernel"),
    ):
        kept, ms, made = xl_on_path[path][name]
        kernels[key][f"on_path_{path}_ms"] = ms
        kernels[key][f"on_path_{path}_records"] = f"{kept} of {made}"

    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "kernel_only_ms"}
    for name, entry in kernels.items():
        if missing := keys - entry.keys():
            msg = f"the {name} entry of the kernels line lacks {sorted(missing)}"
            raise AssertionError(msg)
    print(f"card: {smi}")
    print(json.dumps({"kernels": list(kernels.values())}))
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
