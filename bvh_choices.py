#!/usr/bin/env python3
"""Measure the two choices behind the port's BVH on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root, on a host with one H100:

    python3 bvh_choices.py

- Leaf size: each kernel alone (on a prepared BVH, CUDA events) on BVHs of
  4, 8 and 16 triangles a leaf: closest hit on the SBR first bounce
  (250,000 lattice rays on ``urban_scene(16, 16)``), any-hit on 262,144
  random segments over ``urban_scene(24, 24)``, and the fused trace on the
  8,190 near pairs of ``chip_smoke.py`` phase 3 (c). ``ops._bvh.LEAF_SIZE``
  keeps the fastest.
- Ray sorting: the closest-hit kernel on the SBR and MLM first bounces, on
  the rays as launched and on the rays sorted by a Morton code of their
  origin, then of their direction; alone, and with the sort and the
  scatter back. The port does not sort.

One line per measurement; any failure raises. ``chip_smoke.py`` checks the
kernels; this script only times them.
"""

import numpy as np
import torch

from chip_smoke import (
    HIT_TOL,
    MLM_RAYS,
    NUM_RAYS,
    SBR_RAYS,
    TRACE_KW,
    TX,
    cuda_ms,
    street_receivers,
)


def ray_order(origins: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
    """Permutation sorting rays by a Morton code of their origin, then of
    their unit direction (10 bits an axis each)."""
    from differt_tpu_torch.ops._rt import _part1by2

    def code(x, lo, hi):
        extent = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
        q = ((x - lo) / extent * 1023.0).to(torch.int64).clamp(0, 1023)
        return _part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1) | (_part1by2(q[:, 2]) << 2)

    d = torch.nn.functional.normalize(directions, dim=-1)
    one = torch.ones(3, device=d.device)
    return torch.argsort((code(origins, origins.amin(0), origins.amax(0)) << 30) | code(d, -one, one))


def main() -> None:
    if not torch.cuda.is_available():
        msg = "bvh_choices.py needs a CUDA device, and none is visible."
        raise SystemExit(msg)
    from differt_tpu_torch import scenes
    from differt_tpu_torch.geometry import Scene
    from differt_tpu_torch.ops import _bvh, _closest, _rt, _trace
    from differt_tpu_torch.rt import SBRPathLauncher
    from differt_tpu_torch.rt._solvers import candidate_geometry

    device = torch.device("cuda", 0)
    eps = TRACE_KW["epsilon"]
    tx = torch.tensor([TX], device=device)
    city = scenes.urban_scene(24, 24, device=device).mesh
    city_tv = city.triangle_vertices.contiguous()
    scene16 = Scene(transmitters=tx, receivers=street_receivers(device, 8, 8),
                    mesh=scenes.urban_scene(16, 16, device=device).mesh)
    tv16 = scene16.mesh.triangle_vertices.contiguous()

    # Closest hit: the first bounces of SBR and of the MLM.
    bounces = {}
    for label, num in (("SBR", SBR_RAYS), ("MLM", MLM_RAYS)):
        o, d = SBRPathLauncher(num_rays=num).launch_rays(scene16)
        bounces[label] = (o[0].contiguous(), d[0].contiguous())
    pos = torch.empty(MLM_RAYS, dtype=torch.int32, device=device)
    t_out = torch.empty(MLM_RAYS, device=device)

    # Any-hit: random segments over the city.
    rng = np.random.default_rng(1)
    lo, hi = city.bounding_box.cpu().numpy()
    a = torch.from_numpy(rng.uniform(lo, hi, (NUM_RAYS, 3)).astype(np.float32)).to(device)
    b = torch.from_numpy(rng.uniform(lo, hi, (NUM_RAYS, 3)).astype(np.float32)).to(device)
    th = torch.full((NUM_RAYS,), 1.0 - 2.0 * HIT_TOL, device=device)
    blocked = torch.empty(NUM_RAYS, dtype=torch.bool, device=device)

    # Trace: all ordered pairs of the 91 triangles nearest the TX, to the
    # street receivers.
    near = torch.argsort(city_tv.mean(dim=1)[:, :2].norm(dim=-1))[:91]
    pairs = torch.cartesian_prod(near, near)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    _, tris, mv, mn = candidate_geometry(city, pairs)
    v0 = tris[..., 0, :]
    cand = torch.cat((v0, tris[..., 1, :] - v0, tris[..., 2, :] - v0), dim=-1).contiguous()
    mirrors = torch.cat((mv, mn), dim=-1).contiguous()
    rx = street_receivers(device).reshape(-1, 3).contiguous()
    order, tpm = 2, tris.shape[1] // 2
    verts = torch.empty((1, pairs.shape[0], rx.shape[0], order + 2, 3), device=device)
    mask = torch.empty((1, pairs.shape[0], rx.shape[0]), dtype=torch.bool, device=device)

    o, d = bounces["SBR"]
    for leaf in (4, 8, 16):
        city_bvh = _bvh.build_bvh(city_tv, None, leaf_size=leaf)
        bvh16 = _bvh.build_bvh(tv16, None, leaf_size=leaf)
        closest_ms = cuda_ms(lambda: _closest.launch_closest(o, d, bvh16, eps, pos, t_out), 10)
        anyhit_ms = cuda_ms(lambda: _rt.launch_anyhit(a, b - a, th, city_bvh, eps, blocked), 10)
        trace_ms = cuda_ms(
            lambda: _trace.launch_trace(
                tx, rx, mirrors, cand, city_bvh, order, tpm, *TRACE_KW.values(), verts, mask
            ),
            20,
        )
        print(
            f"leaf_size={leaf}: closest SBR first bounce {closest_ms:.3f} ms;"
            f" anyhit 262,144 segments {anyhit_ms:.3f} ms; trace near pairs {trace_ms:.4f} ms"
            f" (kernel alone; depth {city_bvh.depth}, {city_bvh.num_nodes} nodes on the city)",
            flush=True,
        )

    bvh16 = scene16.mesh.bvh
    for label, (o, d) in bounces.items():
        num = o.shape[0]
        by_code = ray_order(o, d)
        so, sd = o[by_code].contiguous(), d[by_code].contiguous()

        def sorted_call(o=o, d=d, num=num):
            perm = ray_order(o, d)
            hit, dist = _closest.first_triangle_hit_by_ray_cuda(
                o[perm].contiguous(), d[perm].contiguous(), None, bvh=bvh16
            )
            return (hit.new_empty(num).index_copy_(0, perm, hit),
                    dist.new_empty(num).index_copy_(0, perm, dist))

        idx, t = _closest.first_triangle_hit_by_ray_cuda(o, d, None, bvh=bvh16)
        sorted_idx, sorted_t = sorted_call()
        if not (torch.equal(idx, sorted_idx) and torch.equal(t, sorted_t)):
            msg = f"sorted rays change the closest hits ({label})"
            raise AssertionError(msg)
        p, tt = pos[:num], t_out[:num]
        kernel_ms = cuda_ms(lambda: _closest.launch_closest(o, d, bvh16, eps, p, tt), 10)
        sorted_kernel_ms = cuda_ms(lambda: _closest.launch_closest(so, sd, bvh16, eps, p, tt), 10)
        ms = cuda_ms(lambda: _closest.first_triangle_hit_by_ray_cuda(o, d, None, bvh=bvh16), 10)
        sorted_ms = cuda_ms(sorted_call, 10)
        print(
            f"closest {label} first bounce, {num} rays: kernel_only_ms={kernel_ms:.3f}"
            f" kernel_only_sorted_rays_ms={sorted_kernel_ms:.3f} wrapper_ms={ms:.3f}"
            f" sort_launch_scatter_ms={sorted_ms:.3f}",
            flush=True,
        )


if __name__ == "__main__":
    main()
